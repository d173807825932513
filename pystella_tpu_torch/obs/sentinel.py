"""Numerics health sentinels with asynchronous host polling.

PyTorch counterpart of ``pystella_tpu/obs/sentinel.py``. A
:class:`Sentinel` computes a compact per-step **health vector** (schema v1:
per field ``finite`` / ``max_abs`` / ``rms``, plus model-level invariant
scalars such as energy components or the Friedmann constraint residual)
with no host sync: on the card the field statistics are one read of the
state by the hand-written kernel K15 (:mod:`~pystella_tpu_torch.ops.health`)
and one finish launch that writes the vector's field slots, enqueued on the
current stream after the step that produced the state
(``Stepper.step_with_health``, ``FusedScalarStepper.multi_step(...,
sentinel=...)``) or by itself (:meth:`SentinelMonitor.observe`). The
invariants (``{name: fn(state, aux)}``) run as torch functions.

:class:`SentinelMonitor` is the asynchronous consumer: the driver pushes
each step's (device-resident) health vector and polls. A poll only converts
vectors **at least** ``every`` steps behind the newest push, so the driver
loop runs ``>= every`` steps ahead of any device->host transfer; ``flush()``
drains everything (end of run, pre-checkpoint).

On a tripped sentinel (non-finite field, magnitude bound, or an invariant
leaving its declared bounds) the monitor emits a ``diverged`` run event
carrying the actual offending step, hands its ring-buffer history to the
configured :class:`~pystella_tpu_torch.obs.forensics.ForensicSink`, and
raises :class:`SimulationDiverged`. Host-side cost is accounted in the
``sentinel`` metrics timer and the ``health_checks`` counter, the JAX
package's names.
"""

from __future__ import annotations

import collections

import numpy as np
import torch

from pystella_tpu_torch._device import torch_dtype
from pystella_tpu_torch.obs import events as _events
from pystella_tpu_torch.obs import metrics as _metrics
from pystella_tpu_torch.obs.scope import trace_scope
from pystella_tpu_torch.ops import health as _health
from pystella_tpu_torch.parallel.decomp import ShardedArray

__all__ = ["HEALTH_SCHEMA_VERSION", "FIELD_STATS", "Sentinel",
           "SentinelMonitor", "SimulationDiverged", "named_leaves"]

#: health-vector layout version (the JAX package's)
HEALTH_SCHEMA_VERSION = 1

#: per-field statistics, in slot order
FIELD_STATS = _health.FIELD_STATS


class SimulationDiverged(RuntimeError):
    """Raised when the numerics health check fails: non-finite values,
    a magnitude bound exceeded, or an invariant outside its declared
    bounds. ``step`` is the step the offending state was produced at
    (not the step the check ran at); ``bad_fields`` names the offending
    fields and/or invariants."""

    def __init__(self, step, bad_fields, problems=None):
        self.step = step
        self.bad_fields = tuple(bad_fields)
        self.problems = tuple(problems or ())
        detail = ("; ".join(self.problems) if self.problems
                  else ", ".join(self.bad_fields))
        super().__init__(
            f"numerics health check failed at step {step}: {detail}")


def named_leaves(state):
    """``{dotted-path-name: leaf}`` for a state of nested dicts, lists and
    tuples (the JAX package's naming of a pytree's leaves: dict keys in
    sorted order, sequence indices; ``None`` is an empty subtree). A
    tensor, a :class:`~pystella_tpu_torch.parallel.ShardedArray` or any
    other object is a leaf."""
    out = {}

    def walk(node, path):
        if node is None:
            return
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], path + (str(k),))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, path + (str(i),))
        else:
            out[".".join(path)] = node
    walk(state, ())
    return out


def _device_of(leaf):
    if isinstance(leaf, ShardedArray):
        return leaf.blocks[0].device
    return leaf.device


class Sentinel:
    """Compact per-step health vector of a state (schema v1).

    :arg fields: iterable of state leaf names (dotted paths, see
        :func:`named_leaves`); stored sorted.
    :arg invariants: optional ``{name: fn}`` of model-level invariant
        scalars; each ``fn(state, aux)`` returns a scalar (a 0-d tensor on
        the state's device keeps the computation free of host syncs; a
        Python number is placed there with a fill). ``aux`` is the
        driver-supplied dict of background scalars (``{"a": ...,
        "adot": ...}`` on the coupled path; may be empty). Typical
        producers: :meth:`~pystella_tpu_torch.ScalarSector.energy_means`
        and :meth:`~pystella_tpu_torch.Expansion.constraint_residual`.
    :arg dtype: output vector dtype (default float32: the vector is
        telemetry, not arithmetic).

    Layout: for each field name in sorted order, three slots ``finite``
    (1.0 iff no element is NaN or infinite, an overflowing square aside),
    ``max_abs``, ``rms``; then one slot per invariant in sorted name order.
    """

    def __init__(self, fields, invariants=None, dtype=torch.float32):
        self.fields = tuple(sorted(str(f) for f in fields))
        if not self.fields:
            raise ValueError("Sentinel needs at least one field name")
        self.invariants = dict(sorted((invariants or {}).items()))
        self.dtype = torch_dtype(dtype)

    @classmethod
    def for_state(cls, state, invariants=None, **kwargs):
        """Build from a concrete state's leaf names."""
        return cls(named_leaves(state), invariants, **kwargs)

    @property
    def size(self):
        return len(FIELD_STATS) * len(self.fields) + len(self.invariants)

    @property
    def slot_names(self):
        """Flat slot names, e.g. ``["dfdt.finite", "dfdt.max_abs",
        "dfdt.rms", "f.finite", ..., "constraint"]``."""
        out = [f"{f}.{s}" for f in self.fields for s in FIELD_STATS]
        return out + list(self.invariants)

    def _leaves(self, state):
        leaves = named_leaves(state)
        missing = [f for f in self.fields if f not in leaves]
        if missing:
            raise KeyError(f"state has no leaves {missing}; sentinel "
                           f"was built for fields {list(self.fields)}")
        return [leaves[name] for name in self.fields]

    def compute(self, state, aux=None):
        """The health vector of ``state``, a tensor of :attr:`size` values
        on the state's device: the field slots from K15 (on the card; its
        plain version on the CPU), then the invariants. Enqueued on the
        current stream, with no host sync. ``aux`` is forwarded to the
        invariant functions."""
        fields = _health.field_stats(self._leaves(state), self.dtype)
        if not self.invariants:
            return fields
        aux = aux or {}
        dev = fields.device
        parts = [fields]
        for fn in self.invariants.values():
            v = fn(state, aux)
            if isinstance(v, torch.Tensor):
                v = v.to(device=dev, dtype=self.dtype).reshape(1)
            else:
                v = torch.full((1,), float(v), dtype=self.dtype, device=dev)
            parts.append(v)
        return torch.cat(parts)

    def compute_jit(self, state, aux=None):
        """:meth:`compute` as one dispatch under the ``sentinel`` trace
        scope: the K15 launches and the finish that writes the vector,
        returning a device tensor (NO host sync). The name is the JAX
        package's, whose version jits :meth:`compute`."""
        with trace_scope("sentinel"):
            return self.compute(state, aux)

    def compute_members(self, states, aux=None):
        """The member-axis generalization of :meth:`compute`: ``states``
        is a batched state whose leaves carry a leading member axis, and
        the result is a ``(members, size)`` health MATRIX, row i exactly
        the vector :meth:`compute` gives for member i. ``aux`` leaves, if
        any, carry the member axis too."""
        leaves = named_leaves(states)
        members = int(next(iter(leaves.values())).shape[0])

        def member(node, i):
            if isinstance(node, dict):
                return {k: member(v, i) for k, v in node.items()}
            if isinstance(node, (list, tuple)):
                return type(node)(member(v, i) for v in node)
            if node is None:
                return None
            if isinstance(node, ShardedArray):
                return node.map(lambda b: b[i])
            return node[i]
        rows = [self.compute(member(states, i),
                             member(aux, i) if aux else {})
                for i in range(members)]
        return torch.stack(rows)

    def decode_members(self, matrix):
        """Host decode of a ``(members, size)`` health matrix: one
        :meth:`decode` dict per row, from one device->host transfer."""
        m = _host(matrix)
        if m.ndim != 2 or m.shape[1] != self.size:
            raise ValueError(
                f"ensemble health matrix has shape {m.shape}; schema "
                f"v{HEALTH_SCHEMA_VERSION} for this sentinel needs "
                f"(members, {self.size})")
        return [self.decode(row) for row in m]

    def decode(self, vector):
        """Device vector (or numpy array) -> ``{"fields": {name:
        {"finite": bool, "max_abs": float, "rms": float}}, "invariants":
        {name: float}}``. This is the one device->host transfer; on a
        matured vector the computation retired long ago, so it does not
        stall the pipeline."""
        v = _host(vector)
        if v.shape != (self.size,):
            raise ValueError(f"health vector has shape {v.shape}; "
                             f"schema v{HEALTH_SCHEMA_VERSION} for this "
                             f"sentinel needs ({self.size},)")
        ns = len(FIELD_STATS)
        fields = {}
        for i, name in enumerate(self.fields):
            fin, mx, rms = (float(v[ns * i + j]) for j in range(ns))
            fields[name] = {"finite": bool(fin == 1.0), "max_abs": mx,
                            "rms": rms}
        base = ns * len(self.fields)
        invariants = {name: float(v[base + i])
                      for i, name in enumerate(self.invariants)}
        return {"fields": fields, "invariants": invariants}

    def problems(self, decoded, max_abs=None, invariant_bounds=None):
        """Health-check a decoded vector: returns ``(bad_names,
        descriptions)`` — non-finite fields, fields over the ``max_abs``
        magnitude bound, and invariants outside their declared
        ``invariant_bounds`` ``{name: (lo, hi)}`` (either bound may be
        ``None``). Empty lists mean healthy."""
        bad, why = [], []
        for name, st in decoded["fields"].items():
            if not st["finite"]:
                bad.append(name)
                why.append(f"{name}: non-finite values "
                           f"(max_abs={st['max_abs']})")
            elif max_abs is not None and st["max_abs"] > max_abs:
                bad.append(name)
                why.append(f"{name}: |max| {st['max_abs']:.6g} exceeds "
                           f"bound {max_abs:.6g}")
        for name, val in decoded["invariants"].items():
            if not np.isfinite(val):
                bad.append(name)
                why.append(f"invariant {name}: non-finite ({val})")
                continue
            lo, hi = (invariant_bounds or {}).get(name, (None, None))
            if (lo is not None and val < lo) or \
                    (hi is not None and val > hi):
                bad.append(name)
                why.append(f"invariant {name}: {val:.6g} outside "
                           f"bounds ({lo}, {hi})")
        return bad, why


def _host(vector):
    """A health vector or matrix as a float64 numpy array (a bfloat16
    vector widened on the way: numpy has no bfloat16)."""
    if isinstance(vector, torch.Tensor):
        return vector.detach().to("cpu", torch.float64).numpy()
    return np.asarray(vector, dtype=np.float64)


class SentinelMonitor:
    """Asynchronous consumer of per-step health vectors.

    The driver calls :meth:`observe` (compute + enqueue, no sync) or
    :meth:`push` (enqueue a vector an in-step computation already produced:
    ``Stepper.step_with_health`` / ``multi_step(..., sentinel=...)``) once
    per step or chunk, then :meth:`poll`. A poll converts only vectors at
    least ``every`` steps behind the newest push; :meth:`flush` drains
    everything.

    :arg sentinel: the :class:`Sentinel` that produced the vectors.
    :arg every: minimum step lag before a vector is host-converted.
    :arg history: ring-buffer capacity of decoded vectors (the forensic
        bundle's last-K history).
    :arg max_abs: optional per-field magnitude bound.
    :arg invariant_bounds: optional ``{name: (lo, hi)}`` invariant bounds;
        leaving them triggers the same trip path as a NaN.
    :arg emit_steps: emit one ``health`` run event per checked vector.
    :arg forensics: optional
        :class:`~pystella_tpu_torch.obs.forensics.ForensicSink`; on a trip
        it receives the ring-buffer history before
        :class:`SimulationDiverged` is raised.
    :arg metrics_prefix: prefix for this monitor's metric names (the
        ``sentinel`` timer and ``health_checks`` counter by default;
        ``"supervised"`` gives ``supervised_sentinel`` /
        ``supervised_health_checks``), so an auxiliary monitor beside the
        main one keeps its own account.
    """

    def __init__(self, sentinel, every=50, history=64, max_abs=None,
                 invariant_bounds=None, emit_steps=False, label="",
                 forensics=None, metrics_prefix=""):
        self.sentinel = sentinel
        self.every = int(every)
        self.max_abs = max_abs
        self.invariant_bounds = dict(invariant_bounds or {})
        self.emit_steps = bool(emit_steps)
        self.label = label
        self.forensics = forensics
        prefix = f"{metrics_prefix}_" if metrics_prefix else ""
        self._timer_name = prefix + "sentinel"
        self._counter_name = prefix + "health_checks"
        self._pending = collections.deque()   # (step, device vector)
        self.history = collections.deque(maxlen=int(history))
        #: newest step pushed (None before the first push)
        self.newest_step = None
        #: highest step actually health-checked (None before the first)
        self.checked_through = None

    @property
    def pending_steps(self):
        """Steps enqueued but not yet host-checked (newest last)."""
        return [s for s, _ in self._pending]

    def observe(self, step, state, aux=None):
        """Compute the health vector of ``state`` (K15 and its finish, NO
        host sync) and enqueue it for ``step``."""
        with _metrics.timer(self._timer_name):
            self.push(step, self.sentinel.compute_jit(state, aux))

    def push(self, step, vector):
        """Enqueue a health vector an in-step computation already
        produced."""
        step = int(step)
        self._pending.append((step, vector))
        self.newest_step = step

    def poll(self):
        """Check every pending vector at least ``every`` steps behind
        the newest push; younger vectors are never touched. Returns the
        number of vectors checked; raises :class:`SimulationDiverged` on
        the first unhealthy one."""
        n = 0
        while (self._pending and self.newest_step is not None
                and self._pending[0][0] <= self.newest_step
                - self.every):
            self._check_one(*self._pending.popleft())
            n += 1
        return n

    def flush(self):
        """Drain the queue unconditionally (end of run, or immediately
        before trusting the current state, e.g. a checkpoint save).
        Returns the number of vectors checked."""
        n = 0
        while self._pending:
            self._check_one(*self._pending.popleft())
            n += 1
        return n

    def discard(self):
        """Drop every pending (unchecked) vector WITHOUT checking it (the
        recovery path: after a rollback the queue describes the corrupted
        trajectory about to be replayed). Returns the number dropped."""
        n = len(self._pending)
        self._pending.clear()
        return n

    def check_sync(self, step, state, aux=None):
        """Synchronous one-off check of ``state`` at ``step`` (does not
        disturb the async queue). Raises on failure, returns the decoded
        vector otherwise."""
        with _metrics.timer(self._timer_name):
            vector = self.sentinel.compute_jit(state, aux)
        return self._check_one(int(step), vector)

    def _check_one(self, step, vector):
        # the "sentinel" timer covers the decode (the one host transfer)
        # and the checks; the event-log writes stay outside it
        with _metrics.timer(self._timer_name):
            decoded = self.sentinel.decode(vector)
            bad, why = self.sentinel.problems(
                decoded, max_abs=self.max_abs,
                invariant_bounds=self.invariant_bounds)
        self.checked_through = (step if self.checked_through is None
                                else max(self.checked_through, step))
        _metrics.counter(self._counter_name).inc()
        self.history.append({"step": step, **decoded})
        if self.emit_steps:
            _events.emit("health", step=step, label=self.label, **decoded)
        if bad:
            # written before the raise, so it survives an unhandled crash
            offending = next((n for n in bad
                              if n in self.sentinel.invariants), None)
            _events.emit("diverged", step=step, fields=bad,
                         max_abs=self.max_abs, problems=why,
                         offending_invariant=offending, label=self.label)
            if self.forensics is not None:
                self.forensics.write(
                    step=step, reason="; ".join(why), bad_fields=bad,
                    offending_invariant=offending,
                    history=list(self.history))
            raise SimulationDiverged(step, bad, why)
        return decoded
