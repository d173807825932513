"""Checkpoint / resume of simulation state.

PyTorch counterpart of ``pystella_tpu/utils/checkpoint.py``, with its
contract and its events; the on-disk format is the port's own. The JAX
package writes through orbax, which imports jax, so the port can neither
write nor read its checkpoints (and the JAX package cannot read the
port's).

A checkpoint is any state of nested dicts, lists and tuples whose leaves
are tensors, :class:`~pystella_tpu_torch.parallel.ShardedArray` s, numpy
arrays or JSON scalars, plus a JSON ``metadata`` dict (time, scale
factor, ...). On disk, ``<directory>/<step>/`` holds one raw file per
tensor leaf, one per block of a sharded leaf (written block by block,
never gathered) and a ``manifest.json`` naming each file with its dtype,
shape and size.

Durability is tracked explicitly, as in the JAX package:

- :meth:`Checkpointer.save` *schedules* a write and returns. It snapshots
  each device tensor into pinned host memory with an asynchronous copy on
  the current stream and records a CUDA event after it; a worker thread
  waits for the event, writes every file into a temporary directory,
  ``fsync`` s it and renames it into place (``checkpoint_save`` event). A
  tensor the caller changes after ``save`` returns is saved as it was.
- :meth:`Checkpointer.finalize` (or :meth:`~Checkpointer.wait`) is the
  durability barrier: it joins the writer, ``fsync`` s the directory and
  marks the written steps durable (``checkpoint_durable`` events), and
  only then may :attr:`Checkpointer.last_good` name them.
- :meth:`Checkpointer.restore` walks back past a torn or corrupt newest
  checkpoint (a file of the wrong size, an unreadable manifest) with a
  ``checkpoint_fallback`` event.
"""

from __future__ import annotations

import json
import os
import shutil
import time
import uuid
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from pystella_tpu_torch._device import resolve_device
from pystella_tpu_torch.obs import events as _events
from pystella_tpu_torch.parallel.decomp import (DomainDecomposition,
                                                 ShardedArray)

__all__ = ["Checkpointer"]

_FORMAT = "pystella_tpu_torch-checkpoint"
_MANIFEST = "manifest.json"

_DTYPES = {str(d).split(".")[1]: d for d in (
    torch.float16, torch.bfloat16, torch.float32, torch.float64,
    torch.complex64, torch.complex128, torch.int8, torch.int16, torch.int32,
    torch.int64, torch.uint8, torch.bool)}


def _jsonify(obj):
    """Make numpy scalars and 0-d tensors JSON-safe."""
    if isinstance(obj, dict):
        return {str(k): _jsonify(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonify(v) for v in obj]
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.floating):
        return float(obj)
    if hasattr(obj, "item") and getattr(obj, "ndim", None) == 0:
        return obj.item()
    return obj


def _snapshot(t):
    """A host copy of tensor ``t``: on the card an asynchronous copy into
    pinned memory on the current stream, with the event recorded after
    it; on the CPU a clone. Returns ``(host tensor, event or None)``."""
    t = t.detach()
    if t.device.type != "cuda":
        return t.clone().contiguous(), None
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    with torch.cuda.device(t.device):
        host.copy_(t, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(t.device))
    return host, ev


class Checkpointer:
    """Simulation checkpoint manager.

    :arg directory: checkpoint root; created if absent.
    :arg max_to_keep: retain only the newest N checkpoints (default 3);
        older ones are removed at the durability barrier, once the newer
        ones are on disk.
    :arg save_interval_steps: :meth:`maybe_save` saves only every N steps.
    :arg device: where :meth:`restore` places tensor leaves (the GPU by
        default; ``"cpu"`` for the plain runs).

    Usage::

        ckpt = Checkpointer("ckpts", max_to_keep=2)
        ckpt.save(step, state, metadata={"t": t, "a": float(a)})
        ...
        ckpt.finalize()
        step, state, meta = ckpt.restore()
    """

    def __init__(self, directory, max_to_keep=3, save_interval_steps=1,
                 device=None):
        self.directory = os.path.abspath(str(directory))
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = None if max_to_keep is None else int(max_to_keep)
        self.save_interval_steps = int(save_interval_steps)
        self._device = device
        self._writer = ThreadPoolExecutor(max_workers=1)
        #: (step, future) of writes scheduled but not yet confirmed on
        #: disk (oldest first)
        self._scheduled = []
        #: bytes of each step's files, by step (written in this process)
        self.bytes_written = {}
        # checkpoints already on disk survived their writer process, so
        # their commit is complete: a resuming run may trust them
        self._durable = set(self._on_disk())

    # -- the layout on disk ------------------------------------------------

    def _step_dir(self, step):
        return os.path.join(self.directory, str(int(step)))

    def _on_disk(self):
        """Steps whose directory was renamed into place (newest last)."""
        steps = []
        for name in os.listdir(self.directory):
            if name.isdigit() and os.path.isdir(
                    os.path.join(self.directory, name)):
                steps.append(int(name))
        return sorted(steps)

    @property
    def device(self):
        return resolve_device(self._device)

    # -- writing -----------------------------------------------------------

    def _encode(self, node, leaves, files):
        """The manifest's tree of ``node``, snapshotting each tensor (each
        block) into ``files`` as ``(name, host tensor, event)``."""
        if node is None:
            return {"none": True}
        if isinstance(node, dict):
            return {"dict": {str(k): self._encode(v, leaves, files)
                             for k, v in node.items()}}
        if isinstance(node, (list, tuple)):
            kind = "list" if isinstance(node, list) else "tuple"
            return {kind: [self._encode(v, leaves, files) for v in node]}
        i = len(leaves)
        if isinstance(node, ShardedArray):
            blocks = []
            for r, b in enumerate(node.blocks):
                name = f"{i}.{r}.bin"
                host, ev = _snapshot(b)
                files.append((name, host, ev))
                blocks.append({"file": name, "shape": list(b.shape),
                               "bytes": host.numel() * host.element_size()})
            leaves.append({"kind": "sharded", "dtype": str(
                node.dtype).split(".")[1], "shape": list(node.shape),
                "proc_shape": list(node.decomp.proc_shape),
                "blocks": blocks})
        elif isinstance(node, (torch.Tensor, np.ndarray)):
            kind = "numpy" if isinstance(node, np.ndarray) else "tensor"
            t = torch.from_numpy(np.ascontiguousarray(node)) \
                if kind == "numpy" else node
            name = f"{i}.bin"
            host, ev = _snapshot(t)
            files.append((name, host, ev))
            leaves.append({"kind": kind, "dtype": str(t.dtype).split(".")[1],
                           "shape": list(t.shape), "file": name,
                           "bytes": host.numel() * host.element_size()})
        else:
            leaves.append({"kind": "value", "value": _jsonify(node)})
        return {"leaf": i}

    def _write(self, step, manifest, files):
        """The worker: wait for each snapshot, write the files and the
        manifest into a temporary directory, fsync them, rename it into
        place. Returns the bytes written."""
        tmp = os.path.join(self.directory,
                           f".tmp-{step}-{uuid.uuid4().hex[:8]}")
        os.makedirs(tmp)
        nbytes = 0
        for name, host, ev in files:
            if ev is not None:
                ev.synchronize()
            data = host.reshape(-1).view(torch.uint8).numpy()
            with open(os.path.join(tmp, name), "wb") as f:
                data.tofile(f)
                f.flush()
                os.fsync(f.fileno())
            nbytes += data.nbytes
        with open(os.path.join(tmp, _MANIFEST), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        final = self._step_dir(step)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        return nbytes

    def save(self, step, state, metadata=None, force=True):
        """SCHEDULE a write of ``state`` at ``step``: the device tensors
        are snapshot to host memory (asynchronously, on the current
        stream) and a worker thread writes them; this returns at once.
        ``metadata`` is a JSON-serializable dict. An explicit ``save``
        always writes (``force=True``), ignoring ``save_interval_steps``;
        use :meth:`maybe_save` for the throttled in-loop call. Returns True
        if a save was scheduled.

        The ``checkpoint_save`` event means *scheduled*, not durable: call
        :meth:`finalize` (or :meth:`wait`) for the durability barrier that
        emits ``checkpoint_durable`` and lets :attr:`last_good` advance."""
        step = int(step)
        if not force and not self._should_save(step):
            return False
        if step in self.all_steps():
            # a replayed boundary re-saves a step that already exists (the
            # torn checkpoint a walk-back skipped, say): replace it
            self._join()
            shutil.rmtree(self._step_dir(step), ignore_errors=True)
            self._durable.discard(step)
        leaves, files = [], []
        tree = self._encode(state, leaves, files)
        manifest = {"format": _FORMAT, "version": 1, "step": step,
                    "tree": tree, "leaves": leaves,
                    "meta": None if metadata is None
                    else _jsonify(metadata)}
        fut = self._writer.submit(self._write, step, manifest, files)
        self._scheduled.append((step, fut))
        _events.emit("checkpoint_save", step=step,
                     directory=self.directory, durable=False)
        return True

    def _should_save(self, step):
        latest = self.latest_step
        return (step % self.save_interval_steps == 0
                and (latest is None or step > latest))

    def maybe_save(self, step, state, metadata=None):
        """Save only when ``step`` matches ``save_interval_steps`` (and is
        newer than the newest checkpoint)."""
        return self.save(step, state, metadata, force=False)

    def _join(self):
        """Wait for every scheduled write; returns ``[(step, bytes)]`` and
        clears the schedule. A failed write raises here."""
        done, self._scheduled = self._scheduled, []
        out = []
        for step, fut in done:
            nbytes = fut.result()
            self.bytes_written[step] = nbytes
            out.append(step)
        return out

    def finalize(self):
        """The durability barrier: join the writer, fsync the directory,
        then mark the written steps durable (one ``checkpoint_durable``
        event each) so :attr:`last_good` may name them, and remove the
        oldest beyond ``max_to_keep``. A driver runs it one checkpoint
        interval after each save, so the write had that interval to land
        in the background. Returns the newly durable steps."""
        if not self._scheduled:
            return []
        t0 = time.perf_counter()
        newly = self._join()
        fd = os.open(self.directory, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)
        wait_s = time.perf_counter() - t0
        # one barrier confirmed all of them: its wall time is shared out
        share = wait_s / len(newly)
        for s in newly:
            self._durable.add(s)
            _events.emit("checkpoint_durable", step=s,
                         directory=self.directory,
                         wait_s=round(share, 4))
        self._prune()
        return newly

    def wait(self):
        """Block until scheduled writes are durable (alias of
        :meth:`finalize`, the original API)."""
        self.finalize()

    def _prune(self):
        if self.max_to_keep is None:
            return
        steps = self._on_disk()
        for s in steps[:max(0, len(steps) - self.max_to_keep)]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)
            self._durable.discard(s)

    # -- reading -----------------------------------------------------------

    def all_steps(self):
        """Steps on disk and scheduled, oldest first."""
        return sorted(set(self._on_disk())
                      | {s for s, _ in self._scheduled})

    @property
    def latest_step(self):
        steps = self.all_steps()
        return steps[-1] if steps else None

    @property
    def last_good(self):
        """Pointer to the newest **durable** checkpoint, as a JSON-safe
        ``{"directory", "step"}`` dict (``None`` while nothing durable
        exists): the resume-from-here record a forensic bundle embeds.
        Only steps past the :meth:`finalize` barrier qualify, so a crash
        mid-write can never name a torn checkpoint as good."""
        alive = set(self._on_disk())
        good = [s for s in self._durable if s in alive]
        if not good:
            return None
        return {"directory": self.directory, "step": int(max(good))}

    def restore(self, step=None, sharding_fn=None, decomp=None):
        """Restore ``(step, state, metadata)``.

        :arg step: which checkpoint (default: newest). An EXPLICIT step
            restores exactly that checkpoint or raises.
        :arg sharding_fn: a callable applied to each restored leaf, as a
            CPU tensor (a sharded leaf assembled on the host from its
            blocks), e.g. ``decomp.shard``.
        :arg decomp: the decomposition a sharded leaf is restored onto,
            block by block (its ``proc_shape`` must be the one written);
            default a new one of that shape on :attr:`device`.

        Without ``sharding_fn`` tensor leaves land on :attr:`device`. Any
        write still scheduled is waited for first. With ``step=None`` the
        restore **walks back**: a torn or corrupt newest checkpoint falls
        back to the next-older step with a ``checkpoint_fallback`` event;
        only when every candidate fails does the last error propagate."""
        self._join()
        if step is not None:
            return self._restore_one(int(step), sharding_fn, decomp)
        candidates = sorted(self._on_disk(), reverse=True)
        if not candidates:
            raise FileNotFoundError(
                f"no checkpoints under {self.directory}")
        last_err = None
        for cand in candidates:
            try:
                return self._restore_one(cand, sharding_fn, decomp)
            except Exception as e:  # noqa: BLE001 -- walk back, then re-raise
                last_err = e
                _events.emit("checkpoint_fallback", step=cand,
                             directory=self.directory,
                             error=f"{type(e).__name__}: {e}")
        raise last_err

    def _read(self, path, dtype, shape, nbytes):
        """One file as a CPU tensor; a file of another size is torn."""
        size = os.path.getsize(path)
        if size != nbytes:
            raise ValueError(f"{path}: {size} bytes on disk, {nbytes} "
                             "written (a torn checkpoint)")
        data = np.fromfile(path, dtype=np.uint8)
        return torch.from_numpy(data).view(_DTYPES[dtype]).reshape(shape)

    def _restore_one(self, step, sharding_fn=None, decomp=None):
        root = self._step_dir(step)
        with open(os.path.join(root, _MANIFEST)) as f:
            manifest = json.load(f)
        if manifest.get("format") != _FORMAT:
            raise ValueError(f"{root}: not a {_FORMAT}")
        dev = None if sharding_fn is not None else self.device
        decomps = {}

        def leaf(rec):
            kind = rec["kind"]
            if kind == "value":
                return rec["value"]
            if kind in ("tensor", "numpy"):
                t = self._read(os.path.join(root, rec["file"]),
                               rec["dtype"], rec["shape"], rec["bytes"])
                if sharding_fn is not None:
                    return sharding_fn(t)
                return t.numpy() if kind == "numpy" else t.to(dev)
            blocks = [self._read(os.path.join(root, b["file"]),
                                 rec["dtype"], b["shape"], b["bytes"])
                      for b in rec["blocks"]]
            proc = tuple(rec["proc_shape"])
            if sharding_fn is not None:
                d = DomainDecomposition(proc, devices=["cpu"] * len(blocks))
                return sharding_fn(_assemble(blocks, d))
            d = decomp or decomps.get(proc)
            if d is None:
                d = decomps[proc] = DomainDecomposition(
                    proc, devices=[dev] * len(blocks))
            if tuple(d.proc_shape) != proc:
                raise ValueError(f"checkpoint written on proc_shape {proc}; "
                                 f"restore asked for {d.proc_shape}")
            return ShardedArray([b.to(d.devices[r])
                                 for r, b in enumerate(blocks)], d)

        leaves = [leaf(rec) for rec in manifest["leaves"]]

        def build(node):
            if "none" in node:
                return None
            if "dict" in node:
                return {k: build(v) for k, v in node["dict"].items()}
            if "list" in node:
                return [build(v) for v in node["list"]]
            if "tuple" in node:
                return tuple(build(v) for v in node["tuple"])
            return leaves[node["leaf"]]
        state = build(manifest["tree"])
        _events.emit("checkpoint_restore", step=step,
                     directory=self.directory)
        return int(step), state, manifest.get("meta")

    def close(self):
        self._join()
        self._writer.shutdown(wait=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _assemble(blocks, decomp):
    """The whole lattice of ``blocks`` (in rank order on ``decomp``) as one
    CPU tensor, in their own dtype."""
    b = blocks[0].shape
    lat = b[-3:]
    out = torch.empty(tuple(b[:-3]) + tuple(
        p * n for p, n in zip(decomp.proc_shape, lat)), dtype=blocks[0].dtype)
    for r, blk in enumerate(blocks):
        cx, cy, cz = decomp.coords(r)
        out[..., cx * lat[0]:(cx + 1) * lat[0], cy * lat[1]:(cy + 1) * lat[1],
            cz * lat[2]:(cz + 1) * lat[2]] = blk
    return out
