"""Weighted histograms over the lattice, and the binning of power spectra.

PyTorch counterpart of ``pystella_tpu/ops/histogram.py``. The JAX package
bins with ``jnp.bincount`` in chunks of at most 2**22 sites and sums the
chunk partials on the host in int64/float64, so its histograms are
deterministic and its counts exact at any size. PyTorch's CUDA
``bincount`` with weights scatters with float atomics, whose sums change
from run to run; so on a CUDA tensor the port bins with hand-written
kernels (``ops/csrc/histogram.cu``):

- **K13** ``bincount``: counts (int32 per unit, an int64 finish) or float64
  sums of float32/float64 weights over given int32 bins;
- **K14** ``spectra_bin``: a power spectrum's ``counts * |k|**p * |f_k|**2``
  weighting fused with its binning into ``rint(|k| / bin_width)``, |k|,
  the r2c count weight and the bin derived from each site's index;
- ``bin_finish``: the one launch that sums the units' partials.

Units. A unit is one x-plane times a run of :func:`unit_rows` y-rows, z
whole; its global index is ``x * (Y / ry) + y / ry``. Each launch writes
one row of partials (every bin) per unit it covers; a block of a
:class:`~pystella_tpu_torch.parallel.ShardedArray` writes only its own
units, at their global rows, and the finish sums every unit in one fixed
order. So a sharded lattice gives the single-device result bit for bit; a
mesh whose blocks' y-extent is not a multiple of the run, or that shards
z, raises. (``bincount_core``'s ``shard_map`` composition has no
counterpart: the units' partials play its role.)

Beside each kernel is its plain version over the same units:
``index_add_`` into a (units, bins) int64/float64 tensor, then a sum over
the units. A CPU tensor takes it; a CUDA tensor launches the kernel or
raises. Counts are exact in both; weighted sums accumulate in float64 per
unit and in the finish (the JAX package's in float32 per chunk with x64
off), and kernel and plain version differ only in the order of those
float64 additions.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from pystella_tpu_torch import field as _field
from pystella_tpu_torch._device import torch_dtype
from pystella_tpu_torch.ops import stencil as _stencil
from pystella_tpu_torch.ops.reduction import Reduction
from pystella_tpu_torch.parallel.decomp import ShardedArray, blockwise

__all__ = ["Histogrammer", "FieldHistogrammer", "weighted_bincount",
           "fetch_partials", "bincount", "bincount_plain", "SpectraBins",
           "unit_rows", "max_bins", "KERNELS", "LAUNCHES",
           "reset_launch_counts", "build_kernels", "bind_kernels"]

_SOURCE = "histogram.cu"
#: kernel name -> (CUDA source in ops/csrc, the JAX site it serves; the JAX
#: package has no Pallas kernel there)
KERNELS = {
    "bincount": (_SOURCE, "pystella_tpu/ops/histogram.py:64 (bincount_core "
                          "and weighted_bincount :162; jnp.bincount, no "
                          "Pallas kernel)"),
    "spectra_bin": (_SOURCE, "pystella_tpu/fourier/spectra.py:159 "
                             "(PowerSpectra.bin_power: weights_impl :91 + "
                             "weighted_bincount; no Pallas kernel)"),
    "bin_finish": (_SOURCE, "pystella_tpu/ops/histogram.py:149 "
                            "(fetch_partials and the host's sum over chunk "
                            "partials :175-181; no Pallas kernel)"),
}
#: kernel name -> number of launches since the last reset; the wrapper adds
#: one where it launches the kernel, and nowhere else
LAUNCHES = {name: 0 for name in KERNELS}

#: threads and warps of a binning block (histogram.cu: HIST_THREADS)
HIST_THREADS, HIST_WARPS = 256, 8
#: interleaved copies of K13's count histogram (histogram.cu:
#: PK_COUNT_COPIES)
HIST_COPIES = 4
#: the dynamic shared memory one block may take on an H100 (227 KB)
SMEM_LIMIT = 232448
#: the longest y-run of a unit
MAX_UNIT_ROWS = 32


def reset_launch_counts():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def unit_rows(Y):
    """The y-run of a unit on a lattice ``Y`` rows wide: the largest power of
    two that divides ``Y`` and is at most ``min(32, Y // 4)`` (so meshes of
    up to 4 blocks along y keep whole units where their blocks' y-extent
    is a multiple of it)."""
    cap = max(1, min(MAX_UNIT_ROWS, int(Y) // 4))
    ry = 1
    while ry * 2 <= cap and Y % (ry * 2) == 0:
        ry *= 2
    return ry


def hist_smem(weighted, nbins):
    """Dynamic shared bytes of a binning block (histogram.cu:
    pk_hist_smem): for float64 sums (K13's weighted entry points and K14)
    a histogram a warp and a float64 staging row a warp; for counts
    HIST_COPIES interleaved int32 copies of one histogram."""
    if weighted:
        return ((HIST_WARPS * nbins * 8 + 15) // 16 * 16
                + HIST_WARPS * 32 * 8)
    return (HIST_COPIES * nbins * 4 + 15) // 16 * 16


def max_bins(weighted):
    """The most bins the kernels take (float64 sums or int32 counts)."""
    if weighted:
        return (SMEM_LIMIT - HIST_WARPS * 32 * 8) // (HIST_WARPS * 8)
    return SMEM_LIMIT // (HIST_COPIES * 4)


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------

#: the generated header histogram.cu includes: no model, so only the
#: defines of a build (``PK_HIST_MATCH 1``, the grouping yardstick, say)
_HEADER = "// histogram.cu: the defines of a build follow\n#pragma once\n"
_LIB = {}


def bind_kernels(lib):
    """The entry points of a loaded histogram library, typed: ``{name: C
    function}``, with ``pk_hist_smem`` among them."""
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    units = [vp] + [i32] * 9 + [i64, vp]
    spectra = [vp] * 4 + [ctypes.c_double, i32, ctypes.c_double] \
        + [i32] * 4 + units
    fns = {}
    for name, args, res in (
            ("pk_bincount_count", [vp] + units, ctypes.c_int),
            ("pk_bincount_f32", [vp, vp] + units, ctypes.c_int),
            ("pk_bincount_f64", [vp, vp] + units, ctypes.c_int),
            ("pk_spectra_bin_f32", spectra, ctypes.c_int),
            ("pk_spectra_bin_f64", spectra, ctypes.c_int),
            ("pk_bin_finish_count", [vp, vp, i32, i32, i64, vp],
             ctypes.c_int),
            ("pk_bin_finish_sum", [vp, vp, i32, i32, i64, vp],
             ctypes.c_int),
            ("pk_hist_smem", [i32, i32], ctypes.c_size_t)):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = args, res
        fns[name] = fn
    return fns


def build_kernels():
    """Compile (or load from the build cache) ``histogram.cu`` and bind its
    entry points; raises if ``nvcc`` fails or the library's shared memory
    a block is not :func:`hist_smem`'s."""
    if not _LIB:
        fns = bind_kernels(_stencil.build_kernels([_SOURCE], _HEADER)[_SOURCE])
        for weighted in (0, 1):
            got = fns["pk_hist_smem"](weighted, 1000)
            want = hist_smem(weighted, 1000)
            if got != want:
                raise RuntimeError(f"histogram.cu takes {got} shared bytes "
                                   f"a block; ops/histogram.py:hist_smem "
                                   f"predicts {want}")
        _LIB.update(fns)
    return _LIB


def _check(rc, name):
    if rc:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


class _Units:
    """The unit layout of a lattice of global shape ``(X, Y, Z)`` cut into
    ``blocks`` (``(nouter, bx, by, Z)`` tensors) at global offsets
    ``origins`` (``(x0, y0)`` each)."""

    def __init__(self, gshape, blocks, origins, nbins):
        X, Y, _ = gshape
        self.ry = unit_rows(Y)
        for b in blocks:
            if b.shape[-2] % self.ry:
                raise ValueError(
                    f"a block of y-extent {b.shape[-2]} does not hold whole "
                    f"units of {self.ry} rows (lattice Y = {Y}); the "
                    "binning kernels need each block's y-extent to be a "
                    "multiple of unit_rows(Y)")
        self.nyr = Y // self.ry
        self.nunits = X * self.nyr
        self.nouter = blocks[0].shape[0]
        self.nbins = int(nbins)
        self.blocks, self.origins = blocks, origins

    def row_index(self, b, x0, y0):
        """The global partials row of each site of block ``b``: ``(nouter,
        bx, by, 1)`` int64."""
        dev = b.device
        bx, by = b.shape[1], b.shape[2]
        lx = torch.arange(bx, device=dev) + x0
        ly = (torch.arange(by, device=dev) + y0) // self.ry
        unit = lx[:, None] * self.nyr + ly[None, :]
        o = torch.arange(self.nouter, device=dev) * self.nunits
        return (o[:, None, None] + unit[None])[..., None]

    def plain(self, values, weights):
        """The plain version: ``values`` (int bins per block) and
        ``weights`` (per block, or ``None`` for counts) added into a
        (units, bins) tensor with ``index_add_``, then summed over the
        units; ``(nouter, nbins)`` int64 or float64 on the first block's
        device."""
        dev = self.blocks[0].device
        dt = torch.int64 if weights is None else torch.float64
        partials = torch.zeros(self.nouter * self.nunits * self.nbins,
                               dtype=dt, device=dev)
        for r, (b, (x0, y0)) in enumerate(zip(values, self.origins)):
            idx = self.row_index(b, x0, y0) * self.nbins + b
            valid = (b >= 0) & (b < self.nbins)
            src = (torch.ones_like(b, dtype=torch.int64) if weights is None
                   else weights[r].to(torch.float64))
            partials.index_add_(0, idx[valid].to(dev), src[valid].to(dev))
        return partials.view(self.nouter, self.nunits, self.nbins).sum(dim=1)

    def kernel(self, name, launch, weighted):
        """The kernel: ``launch(block_index, partials, ux0, uyr0, nyr,
        nunits, stream)`` once per block, each writing its units' rows of
        the global partials, then one finish launch. Every block must lie
        on one card (binning across cards waits for the port's
        multi-process decomposition, ROADMAP queue 1 item 5)."""
        fns = build_kernels()
        dev = self.blocks[0].device
        if any(b.device != dev for b in self.blocks):
            raise NotImplementedError(
                "the binning kernels take blocks on one card; these lie on "
                f"{sorted({str(b.device) for b in self.blocks})}")
        pdt = torch.float64 if weighted else torch.int32
        partials = torch.empty((self.nouter, self.nunits, self.nbins),
                               dtype=pdt, device=dev)
        with torch.cuda.device(dev):
            stream = _stream(dev)
            for r, (x0, y0) in enumerate(self.origins):
                _check(launch(r, partials, x0, y0 // self.ry, self.nyr,
                              self.nunits, stream), name)
                LAUNCHES[name] += 1
            out = torch.empty((self.nouter, self.nbins), device=dev,
                              dtype=torch.float64 if weighted
                              else torch.int64)
            finish = fns["pk_bin_finish_sum" if weighted
                         else "pk_bin_finish_count"]
            _check(finish(partials.data_ptr(), out.data_ptr(), self.nouter,
                          self.nbins, self.nunits, stream), "bin_finish")
        LAUNCHES["bin_finish"] += 1
        return out


def _blocks_of(x):
    """``(global lattice shape, outer shape, blocks as (nouter, bx, by, Z)
    views, their (x0, y0) origins)`` of a tensor or :class:`ShardedArray`."""
    if isinstance(x, ShardedArray):
        d = x.decomp
        if d.proc_shape[2] > 1:
            raise ValueError("the binning kernels take meshes that shard x "
                             "and y only: a unit keeps z whole")
        blocks = x.blocks
        lat = tuple(blocks[0].shape[-3:])
        origins = [(d.coords(r)[0] * lat[0], d.coords(r)[1] * lat[1])
                   for r in range(d.nshards)]
        gshape = tuple(x.shape[-3:])
    else:
        blocks, origins, gshape = [x], [(0, 0)], tuple(x.shape[-3:])
    outer = tuple(blocks[0].shape[:-3])
    flat = [b.reshape((-1,) + tuple(b.shape[-3:])) for b in blocks]
    return gshape, outer, flat, origins


def _on_card(blocks):
    types = {b.device.type for b in blocks}
    if len(types) != 1:
        raise ValueError("the blocks lie on CPU and CUDA devices at once")
    return types.pop() == "cuda"


def _bincount_blocks(bins, weights):
    gshape, outer, bb, origins = _blocks_of(bins)
    wb = None if weights is None else _blocks_of(weights)[2]
    for b in bb:
        if b.dtype != torch.int32:
            raise TypeError(f"bincount takes int32 bins; got {b.dtype}")
    if wb is not None:
        for b, w in zip(bb, wb):
            if w.shape != b.shape or w.dtype not in (torch.float32,
                                                     torch.float64):
                raise TypeError(
                    "bincount takes float32 or float64 weights of the bins' "
                    f"shape; got {w.dtype} {tuple(w.shape)}")
    return gshape, outer, bb, wb, origins


def bincount_plain(bins, weights, num_bins):
    """K13's plain version on any device: ``(outer..., num_bins)`` int64
    counts (``weights`` None) or float64 sums, as a tensor on the first
    block's device. Bins outside ``[0, num_bins)`` are dropped."""
    gshape, outer, bb, wb, origins = _bincount_blocks(bins, weights)
    units = _Units(gshape, bb, origins, num_bins)
    return units.plain(bb, wb).reshape(outer + (int(num_bins),))


def bincount(bins, weights, num_bins):
    """K13: counts (``weights`` None; int64) or float64 sums of float32 /
    float64 ``weights`` over the int32 ``bins`` (a tensor or a
    :class:`ShardedArray` of shape ``outer + lattice``), per outer slice:
    ``(outer..., num_bins)`` as a tensor on the (first block's) device.
    The kernel on a CUDA tensor (a bin count above :func:`max_bins`
    raises), the plain version on a CPU tensor. Bins outside ``[0,
    num_bins)`` are dropped."""
    gshape, outer, bb, wb, origins = _bincount_blocks(bins, weights)
    num_bins = int(num_bins)
    if not _on_card(bb):
        return _Units(gshape, bb, origins, num_bins).plain(bb, wb).reshape(
            outer + (num_bins,))
    weighted = wb is not None
    if num_bins > max_bins(weighted):
        raise ValueError(f"{num_bins} bins: the binning kernel's shared-"
                         f"memory histograms hold at most "
                         f"{max_bins(weighted)}")
    units = _Units(gshape, [b.contiguous() for b in bb], origins, num_bins)
    wb = None if wb is None else [w.contiguous() for w in wb]
    fns = build_kernels()
    entry = fns["pk_bincount_count" if not weighted else
                "pk_bincount_f32" if wb[0].dtype == torch.float32
                else "pk_bincount_f64"]

    def launch(r, partials, ux0, uyr0, nyr, nunits, stream):
        b = units.blocks[r]
        ptrs = [b.data_ptr()] + ([wb[r].data_ptr()] if weighted else [])
        return entry(*ptrs, partials.data_ptr(), units.nouter, b.shape[1],
                     b.shape[2], b.shape[3], num_bins, units.ry, ux0, uyr0,
                     nyr, nunits, stream)
    return units.kernel("bincount", launch, weighted).reshape(
        outer + (num_bins,))


def fetch_partials(partials):
    """A host array of binning results (one controller: a plain copy; the
    JAX package's multi-controller allgather waits for the port's
    ``torch.distributed`` tier)."""
    if isinstance(partials, torch.Tensor):
        return partials.detach().cpu().numpy()
    return np.asarray(partials)


def weighted_bincount(decomp, bins, weights, num_bins, lattice_names=None):
    """Histogram of ``bins`` (int32, ``outer + lattice``, a tensor or a
    :class:`ShardedArray`) weighted by ``weights`` of the same shape, or
    exact integer counts with ``weights=None``: a host ``np.ndarray`` of
    shape ``outer + (num_bins,)``, float64 or int64 (K13, see
    :func:`bincount`). ``decomp`` and ``lattice_names`` are the JAX
    signature's; the layout is read off the arguments."""
    return fetch_partials(bincount(bins, weights, num_bins))


class SpectraBins:
    """K14: the binning of a power spectrum, ``counts * |k|**p * |f_k|**2``
    summed over the shells ``rint(|k| / bin_width)``.

    :arg sq_axes: per axis, ``(dk_mu k_mu)**2`` over the k-space axis (numpy
        arrays of the real type; the half-spectrum z axis for r2c),
        from which |k| of a site is ``sqrt((x + y) + z)``, the order in
        which PowerSpectra's host ``kmags`` are made.
    :arg bin_width: the shell width.
    :arg grid_shape: the position-space shape (its z extent sets the r2c
        count weight: 1 on the ``kz = 0`` and ``kz = Nz // 2`` planes,
        else 2).
    :arg is_real: r2c (counts 1 or 2) or c2c (counts 1).
    :arg num_bins: the number of shells.
    """

    def __init__(self, sq_axes, bin_width, grid_shape, is_real, num_bins):
        self.sq_axes = [np.ascontiguousarray(a) for a in sq_axes]
        self.rdtype = self.sq_axes[0].dtype
        self.bin_width = float(bin_width)
        self.grid_shape = tuple(grid_shape)
        self.is_real = bool(is_real)
        self.num_bins = int(num_bins)
        if self.num_bins > max_bins(True):
            raise ValueError(f"{self.num_bins} shells: the binning kernel's "
                             f"shared-memory histograms hold at most "
                             f"{max_bins(True)}")
        self._tables = {}

    def tables(self, device):
        """The three axis tables as tensors on ``device`` (kept)."""
        t = self._tables.get(device)
        if t is None:
            t = [torch.from_numpy(a).to(device) for a in self.sq_axes]
            self._tables[device] = t
        return t

    def site_arrays(self, device, x0, y0, bx, by):
        """``(kmag, bin, counts)`` of the region ``[x0, x0 + bx) x [y0, y0 +
        by)`` of k-space, as the kernel derives them: |k| in the real type
        in numpy's order, the bin as ``rint(|k| / bin_width)`` (a true
        division), and the count weight."""
        sx, sy, sz = self.tables(device)
        ksq = (sx[x0:x0 + bx, None, None]
               + sy[None, y0:y0 + by, None]) + sz[None, None, :]
        # correctly rounded, as numpy's and the card's sqrt are (PyTorch's
        # vectorized sqrt on the CPU is not): numpy's on the CPU, on the
        # card through float64 (exact for float32)
        if ksq.device.type == "cpu":
            kmag = torch.from_numpy(np.sqrt(ksq.numpy()))
        else:
            kmag = torch.sqrt(ksq.double()).to(ksq.dtype)
        bw = torch.tensor(self.bin_width, dtype=kmag.dtype, device=device)
        bins = torch.round(kmag / bw).to(torch.int32)
        nz = self.grid_shape[-1]
        iz = torch.arange(sz.shape[0], device=device)
        two = (iz != 0) & (iz != nz // 2) & self.is_real
        counts = torch.where(two, 2.0, 1.0).to(kmag.dtype)
        return kmag, bins, counts.expand(kmag.shape)

    def _split(self, fk):
        gshape, outer, blocks, origins = _blocks_of(fk)
        for b in blocks:
            if b.dtype not in (torch.complex64, torch.complex128):
                raise TypeError(f"spectra_bin takes a complex spectrum; got "
                                f"{b.dtype}")
        return gshape, outer, blocks, origins

    def plain(self, fk, k_power=3):
        """K14's plain version on any device: the weights ``counts *
        kmag**k_power * torch.abs(fk)**2`` in the real type, then K13's
        plain binning; ``(outer..., num_bins)`` float64."""
        gshape, outer, blocks, origins = self._split(fk)
        bins, weights = [], []
        for b, (x0, y0) in zip(blocks, origins):
            kmag, bi, counts = self.site_arrays(b.device, x0, y0,
                                                b.shape[1], b.shape[2])
            weights.append(counts * kmag**k_power * torch.abs(b)**2)
            bins.append(bi.expand(b.shape))
        units = _Units(gshape, blocks, origins, self.num_bins)
        return units.plain(bins, weights).reshape(outer + (self.num_bins,))

    def __call__(self, fk, k_power=3):
        """The binned ``counts * |k|**k_power * |f_k|**2`` of ``fk`` (an
        ``outer + k-lattice`` complex tensor, or a :class:`ShardedArray` of
        k-space blocks): ``(outer..., num_bins)`` float64 on the (first
        block's) device. The kernel on a CUDA tensor, the plain version on
        a CPU tensor."""
        gshape, outer, blocks, origins = self._split(fk)
        if not _on_card(blocks):
            return self.plain(fk, k_power)
        blocks = [b.contiguous() for b in blocks]
        units = _Units(gshape, blocks, origins, self.num_bins)
        fns = build_kernels()
        rdt = {torch.complex64: torch.float32,
               torch.complex128: torch.float64}[blocks[0].dtype]
        if torch_dtype(self.rdtype) != rdt:
            raise TypeError(f"a {blocks[0].dtype} spectrum against "
                            f"{self.rdtype} shells")
        entry = fns["pk_spectra_bin_f32" if rdt == torch.float32
                    else "pk_spectra_bin_f64"]
        p = float(k_power)
        ipow = int(p) if p.is_integer() and 0 <= p <= 3 else -1

        def launch(r, partials, ux0, uyr0, nyr, nunits, stream):
            b = units.blocks[r]
            x0, y0 = units.origins[r]
            sx, sy, sz = self.tables(b.device)
            return entry(b.data_ptr(), sx.data_ptr(), sy.data_ptr(),
                         sz.data_ptr(), self.bin_width, ipow, p,
                         self.grid_shape[-1], int(self.is_real), x0, y0,
                         partials.data_ptr(), units.nouter, b.shape[1],
                         b.shape[2], b.shape[3], self.num_bins, units.ry,
                         ux0, uyr0, nyr, nunits, stream)
        return units.kernel("spectra_bin", launch, True).reshape(
            outer + (self.num_bins,))


class Histogrammer:
    """Computes weighted histograms of expressions.

    :arg decomp: a :class:`~pystella_tpu_torch.DomainDecomposition` (or
        ``None``); the layout is read off the arguments.
    :arg histograms: dict mapping names to ``(bin_expr, weight_expr)``; the
        bin index is ``floor(bin_expr)`` clipped to ``[0, num_bins)`` (a NaN
        to bin 0).
    :arg num_bins: number of bins.
    :arg dtype: dtype of the output histogram (and of the weights).

    A histogram whose weight is the constant 1 takes the exact integer
    count path.
    """

    def __init__(self, decomp, histograms, num_bins, dtype=np.float64,
                 **kwargs):
        self.decomp = decomp
        self.histograms = dict(histograms)
        self.num_bins = int(num_bins)
        self.dtype = dtype

        def is_unit(expr):
            if isinstance(expr, _field.Constant):
                expr = expr.value
            return isinstance(expr, (int, float)) and expr == 1

        self._count_names = {name for name, (_, w)
                             in self.histograms.items() if is_unit(w)}

    def _prepare(self, env):
        """Per histogram: ``(int32 bins, weights in dtype or None)`` of one
        block (or the whole lattice)."""
        dev = next(v.device for v in env.values()
                   if isinstance(v, torch.Tensor) and v.ndim >= 3)
        env = {k: v.to(dev) if isinstance(v, torch.Tensor) else v
               for k, v in env.items()}
        acc = torch_dtype(self.dtype)
        out = {}
        for name, (bin_expr, weight_expr) in self.histograms.items():
            b = torch.floor(_field.evaluate(bin_expr, env))
            # a NaN site goes to bin 0, as the JAX package's int32 cast of
            # a NaN gives 0 (torch.clamp keeps the NaN, whose cast is
            # undefined); +-inf clamp to the last and the first bin
            b = torch.nan_to_num(b, nan=0.0, posinf=float("inf"),
                                 neginf=float("-inf"))
            b = torch.clamp(b, 0, self.num_bins - 1).to(torch.int32)
            if name in self._count_names:
                out[name] = (b, None)
                continue
            w = torch.as_tensor(_field.evaluate(weight_expr, env),
                                device=dev)
            out[name] = (b, torch.broadcast_to(w, b.shape).to(acc))
        return out

    def __call__(self, allocator=None, **env):
        prepared = blockwise(self._prepare, env)
        return {name: weighted_bincount(
                    self.decomp, b, w, self.num_bins).astype(self.dtype)
                for name, (b, w) in prepared.items()}


class FieldHistogrammer(Histogrammer):
    """Linear- and log-binned histograms of a field, with automatic bin
    bounds.

    Returns ``{"linear", "linear_bins", "log", "log_bins"}``, each with
    shape ``f.shape[:-3] + (num_bins[+1],)``.
    """

    def __init__(self, decomp, num_bins, dtype=np.float64, **kwargs):
        f = _field.Field("f")
        max_f, min_f = _field.Var("max_f"), _field.Var("min_f")
        max_log_f = _field.Var("max_log_f")
        min_log_f = _field.Var("min_log_f")

        linear_bin = (f - min_f) / (max_f - min_f)
        log_bin = ((_field.log(_field.fabs(f)) - min_log_f)
                   / (max_log_f - min_log_f))
        histograms = {
            "linear": (linear_bin * num_bins, 1),
            "log": (log_bin * num_bins, 1),
        }
        super().__init__(decomp, histograms, num_bins, dtype, **kwargs)

        self.get_min_max = Reduction({
            "max_f": [(f, "max")],
            "min_f": [(f, "min")],
            "max_log_f": [(_field.log(_field.fabs(f)), "max")],
            "min_log_f": [(_field.log(_field.fabs(f)), "min")],
        })

    def _auto_bounds(self, f):
        """Per-outer-slice min/max of ``f`` and ``log|f|`` (a
        :class:`ShardedArray`'s block by block, combined: extrema do not
        depend on the order), as numpy arrays in ``f``'s dtype."""
        blocks = f.blocks if isinstance(f, ShardedArray) else [f]
        lat = (-3, -2, -1)
        parts = []
        for b in blocks:
            log_absf = torch.log(torch.abs(b))
            parts.append((torch.amax(b, dim=lat), torch.amin(b, dim=lat),
                          torch.amax(log_absf, dim=lat),
                          torch.amin(log_absf, dim=lat)))
        dev = blocks[0].device
        mx, mn, mxl, mnl = (
            [p[i].to(dev) for p in parts] for i in range(4))
        out = [torch.stack(v).amax(0) for v in (mx, mxl)]
        low = [torch.stack(v).amin(0) for v in (mn, mnl)]
        return {"max_f": out[0].cpu().numpy(), "min_f": low[0].cpu().numpy(),
                "max_log_f": out[1].cpu().numpy(),
                "min_log_f": low[1].cpu().numpy()}

    @staticmethod
    def _widen(lo, hi):
        """``hi`` strictly above ``lo`` by at least a representable step at
        ``lo``'s scale (a +1.0 widening rounds away for |lo| above the
        dtype's integer range)."""
        bump = np.maximum(np.asarray(1.0, lo.dtype),
                          4 * np.spacing(np.abs(lo)))
        return np.where(lo == hi, lo + bump, hi)

    def _sanitize_bounds(self, bounds, dtype=None):
        """Keep bin bounds finite and non-degenerate (elementwise over any
        outer shape), in the dtype the bin expressions run in: a field with
        zeros gives ``log|f| = -inf`` and an identically-zero field
        degenerate bounds, which would turn the bin expressions into nan."""
        dt = np.dtype(dtype if dtype is not None else self.dtype)
        out = {k: np.asarray(v, dt) for k, v in bounds.items()}
        tiny_log = dt.type(np.log(np.finfo(dt).tiny))
        lo, hi = out["min_log_f"], out["max_log_f"]
        hi = np.where(np.isfinite(hi), hi, tiny_log)
        lo = np.where(np.isfinite(lo), lo, np.minimum(tiny_log, hi))
        out["min_log_f"], out["max_log_f"] = lo, self._widen(lo, hi)
        out["max_f"] = self._widen(out["min_f"], out["max_f"])
        return out

    def __call__(self, f, allocator=None, **kwargs):
        """Histogram every outer slice of ``f`` (a tensor or a
        :class:`ShardedArray`) in one pass: per-slice bounds broadcast
        into the bin expressions, and one binning launch per histogram
        covers every slice."""
        min_max_keys = set(self.get_min_max.reducers.keys())
        if min_max_keys.issubset(set(kwargs.keys())):
            bounds = {key: np.asarray(kwargs[key]) for key in min_max_keys}
        else:
            bounds = self._auto_bounds(f)
        dtype = torch.empty((), dtype=f.dtype).numpy().dtype
        bounds = self._sanitize_bounds(bounds, dtype)
        first = f.blocks[0] if isinstance(f, ShardedArray) else f
        env_bounds = {k: torch.as_tensor(np.reshape(v, v.shape + (1, 1, 1)),
                                         device=first.device)
                      for k, v in bounds.items()}

        out = dict(super().__call__(f=f, **env_bounds))
        out["linear_bins"] = np.linspace(
            bounds["min_f"], bounds["max_f"], self.num_bins + 1,
            axis=-1).astype(self.dtype)
        out["log_bins"] = np.exp(np.linspace(
            bounds["min_log_f"].astype(np.float64),
            bounds["max_log_f"].astype(np.float64), self.num_bins + 1,
            axis=-1)).astype(self.dtype)
        return out
