"""Stencil taps and the build of the hand-written CUDA stencil kernels.

PyTorch counterpart of ``pystella_tpu/ops/pallas_stencil.py``. Two parts:

- The plain side: :func:`lap_from_taps` and :func:`grad_from_taps` in the
  JAX package's accumulation order, and :class:`RollTaps`, the
  periodic-roll tap accessor the plain PyTorch kernel bodies read from
  (``taps(sx, sy, sz)[..., i] == f[..., i + s]``, the JAX convention);
  :class:`PaddedTaps`, the same on a block padded with its neighbours'
  rows along the sharded axes (slices there, rolls elsewhere), and
  :func:`sharded_halo`, the padding a sharded mesh gives the window
  inputs.
- The kernel side: :func:`build_kernels` compiles CUDA sources from
  ``ops/csrc`` against a header generated from the model
  (:mod:`~pystella_tpu_torch.ops.codegen`), with ``nvcc`` for ``sm_90a``,
  into shared libraries with a plain C interface that are loaded with
  :mod:`ctypes`. A built library is keyed by a hash of everything that
  went into it, so a second run reuses it.

The TPU's blocking machinery (VMEM rings, y slabs, lane rolls, block
choice) has no counterpart: a CUDA kernel computes its own periodic
offsets for any lattice shape.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

__all__ = ["lap_from_taps", "grad_from_taps", "RollTaps", "PaddedTaps",
           "sharded_halo", "launch_kinds", "build_kernels",
           "build_log", "build_seconds", "ptxas_usage", "CSRC_DIR",
           "BUILD_DIR", "NVCC_FLAGS"]

CSRC_DIR = Path(__file__).resolve().with_name("csrc")
#: where built libraries go (listed in .gitignore)
BUILD_DIR = Path(__file__).resolve().with_name("_build")
#: -fmad=false keeps every multiply and add separately rounded, as in the
#: plain PyTorch bodies, so kernel and plain version differ only where
#: PyTorch itself reorders (see ops/fused.py for the stated tolerances)
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler",
              "-fPIC")
#: wall seconds of each nvcc this process ran, by library path
_BUILD_SECONDS = {}


def lap_from_taps(taps, coefs, inv_dx2):
    """Laplacian from centered-difference taps: ``coefs`` maps offset ->
    coefficient (offset 0 included), ``inv_dx2`` is ``1/dx**2`` per axis.
    The centre term first, then per offset the x, y and z pairs."""
    acc = coefs[0] * sum(inv_dx2) * taps()
    for s, c in coefs.items():
        if s == 0:
            continue
        acc = acc + c * inv_dx2[0] * (taps(s) + taps(-s))
        acc = acc + c * inv_dx2[1] * (taps(0, s) + taps(0, -s))
        acc = acc + c * inv_dx2[2] * (taps(0, 0, s) + taps(0, 0, -s))
    return acc


def grad_from_taps(taps, coefs, inv_dx):
    """Per-axis first derivatives from antisymmetric centered taps; returns
    a list of three arrays."""
    grads = []
    for d in range(3):
        acc = 0
        for s, c in coefs.items():
            plus = [0, 0, 0]
            plus[d] = s
            minus = [0, 0, 0]
            minus[d] = -s
            acc = acc + c * inv_dx[d] * (taps(*plus) - taps(*minus))
        grads.append(acc)
    return grads


class RollTaps:
    """Taps of a ``(C, X, Y, Z)`` tensor under periodic wrap:
    ``taps(sx, sy, sz)[:, i, j, k] == w[:, i + sx, j + sy, k + sz]``, i.e.
    ``torch.roll`` by ``-s``. Unlike the JAX accessor it does not memoize:
    at 512^3 the memoized whole-lattice copies of a stage pair would hold
    tens of GiB, and a roll is cheap to redo."""

    def __init__(self, w):
        self._w = w

    @staticmethod
    def _roll1(arr, s, axis):
        return arr if s == 0 else torch.roll(arr, -s, axis)

    def __call__(self, sx=0, sy=0, sz=0):
        return self._roll1(self._roll1(self._roll1(
            self._w, sx, 1), sy, 2), sz, 3)

    def roll(self, arr, sz):
        """Periodic z-shift of a computed block (same convention)."""
        return self._roll1(arr, sz, 3)

    def component(self, c):
        """The taps of component ``c`` alone, ``(1, X, Y, Z)``."""
        return RollTaps(self._w[c:c + 1])


class PaddedTaps(RollTaps):
    """Taps of a ``(C, X + 2 hx, Y + 2 hy, Z + 2 hz)`` window padded by
    ``pad = (hx, hy[, hz])`` rows along x, y (and z) (the neighbours' rows
    on a sharded mesh): ``taps(sx, sy, sz)`` is the ``(C, X, Y, Z)`` block
    shifted by ``s``, a slice along a padded axis and a periodic roll along
    an unpadded one. The values are those :class:`RollTaps` gives on the
    whole lattice: only the data movement differs, so a plain body on these
    taps equals the same body on the unsharded lattice bit for bit. The
    window of an interior or shell launch is such a window too (the raw
    block, or a shell input, with ``hx = h``)."""

    def __init__(self, w, pad):
        super().__init__(w)
        self._pad = tuple(int(p) for p in pad) + (0,) * (3 - len(pad))

    def _shift(self, arr, s, axis, h):
        if h == 0:
            return self._roll1(arr, s, axis)
        n = arr.shape[axis] - 2 * h
        return arr.narrow(axis, h + s, n)

    def __call__(self, sx=0, sy=0, sz=0):
        hx, hy, hz = self._pad
        return self._shift(self._shift(self._shift(
            self._w, sx, 1, hx), sy, 2, hy), sz, 3, hz)

    def component(self, c):
        return PaddedTaps(self._w[c:c + 1], self._pad)


def sharded_halo(h, px, py):
    """Halo widths ``(x, y, z)`` of the window inputs of a stencil on an
    ``(px, py, 1)`` mesh: the radius ``h`` along each sharded axis, none
    along the others, which the kernels wrap periodically. (The TPU pads y
    by the 8-row ``HY`` for its sublane alignment; a CUDA kernel needs
    no alignment rows.)"""
    return (h if px > 1 else 0, h if py > 1 else 0, 0)


def launch_kinds(decomp, h, block, overlap):
    """The launches one sharded stencil update makes per block of
    ``decomp`` (radius ``h``, blocks of lattice shape ``block``), by kind:
    ``{None: 1}`` on a mesh that shards nothing (the unsharded kernel);
    ``{"interior": 1, "shell": 2}`` where ``overlap`` is asked for and the
    JAX package's split exists along x alone; else the padded launch of
    the sharded axes' kind (``xpad``, ``ypad`` or ``xypad``)."""
    halo = sharded_halo(h, *decomp.proc_shape[:2])
    if halo == (0, 0, 0):
        return {None: 1}
    if overlap and decomp.split_axes(halo, block) == (0,):
        return {"interior": 1, "shell": 2}
    return {("xpad", "ypad", "xypad")[(halo[0] > 0) + 2 * (halo[1] > 0)
                                      - 1]: 1}


# ---------------------------------------------------------------------------
# building CUDA kernels
# ---------------------------------------------------------------------------

def _nvcc():
    from torch.utils.cpp_extension import CUDA_HOME
    home = CUDA_HOME or os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built at "
                           "first use and need the CUDA toolkit")
    return found


def _library_path(source, header):
    common = (CSRC_DIR / "pk_common.cuh").read_text()
    text = (CSRC_DIR / source).read_text()
    key = hashlib.sha256("\0".join(
        (text, common, header, " ".join(NVCC_FLAGS))).encode()).hexdigest()
    stem = Path(source).stem
    return BUILD_DIR / f"{stem}-{key[:16]}" / f"lib{stem}.so"


def build_kernels(sources, header):
    """Build each CUDA source of ``ops/csrc`` against the generated
    ``header`` (included as ``pk_model.cuh``) and load it.

    Every source that is not built yet gets its own ``nvcc``; all of them
    start together and run in parallel (each one's wall time is kept:
    :func:`build_seconds`). A library lands under
    :data:`BUILD_DIR` at a path keyed by the hash of the source, the shared
    header, the generated header and the flags, and is moved there only
    once complete, so concurrent builds never load a partial file.

    :returns: ``{source: ctypes.CDLL}``.
    :raises RuntimeError: if ``nvcc`` is missing or a compilation fails.
    """
    paths = {src: _library_path(src, header) for src in sources}
    jobs = []
    for src, lib in paths.items():
        if lib.exists():
            continue
        lib.parent.mkdir(parents=True, exist_ok=True)
        (lib.parent / "pk_model.cuh").write_text(header)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=lib.parent)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, f"-I{lib.parent}", f"-I{CSRC_DIR}",
               "-o", tmp, str(CSRC_DIR / src)]
        # the compiler's output goes to a file, so every job runs to its
        # end unread and its wall time is taken when it ends
        log = tempfile.TemporaryFile("w+", dir=lib.parent)
        proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT,
                                text=True)
        jobs.append((src, lib, tmp, proc, log, time.perf_counter()))
    pending = list(jobs)
    while pending:
        for job in [j for j in pending if j[3].poll() is not None]:
            _BUILD_SECONDS[str(job[1])] = time.perf_counter() - job[5]
            pending.remove(job)
        if pending:
            time.sleep(0.05)
    failures = []
    for src, lib, tmp, proc, log, _ in jobs:
        log.seek(0)
        out = log.read()
        log.close()
        if proc.returncode != 0:
            failures.append(f"{src}:\n{out}")
            Path(tmp).unlink(missing_ok=True)
        else:
            (lib.parent / "build.log").write_text(out)
            os.replace(tmp, lib)
    if failures:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
    return {src: ctypes.CDLL(str(lib)) for src, lib in paths.items()}


def build_log(source, header):
    """The compiler output kept from building ``source`` against
    ``header`` (empty if the library was built before logs were kept)."""
    log = _library_path(source, header).parent / "build.log"
    return log.read_text() if log.exists() else ""


def build_seconds(source, header):
    """Wall seconds of the ``nvcc`` that built ``source`` against
    ``header`` in this process (``None`` if this process loaded it
    built)."""
    return _BUILD_SECONDS.get(str(_library_path(source, header)))


def ptxas_usage(log):
    """Registers and spill bytes per kernel from ``-Xptxas -v`` output:
    ``{mangled kernel name: {"registers", "spill_stores", "spill_loads"}}``
    (device functions that are not kernels are left out)."""
    usage, entry, target = {}, None, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry = target = m.group(1)
            usage[entry] = {}
            continue
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            target = entry if m.group(1) == entry else None
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and target is not None:
            usage[target]["spill_stores"] = int(m.group(1))
            usage[target]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and entry is not None:
            usage[entry]["registers"] = int(m.group(1))
    return usage
