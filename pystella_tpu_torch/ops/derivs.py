"""Finite-difference operators on one device.

PyTorch counterpart of the single-device subset of
``pystella_tpu/ops/derivs.py``: the centered-difference coefficient tables,
the stencils' eigenvalues, and a :class:`FiniteDifferencer` with ``lap``,
``grad``, ``grad_lap``, ``pdx``/``pdy``/``pdz`` and ``divergence``.

On a CUDA tensor every operator is one launch of a hand-written kernel
(``ops/csrc/fd_ops.cu``, K12: the JAX package's
``FiniteDifferencer._pallas_bodies``): ``lap``, ``grad``, ``grad_lap``,
``pdx`` and ``divergence`` an x-march of a y-z tile (:func:`lap_tile`,
:func:`grad_tile`, :func:`grad_lap_tile`, :func:`pd_tile`,
:func:`div_tile`), ``pdy`` / ``pdz`` one thread per site (a march of
theirs lost to it), with periodic wrap by index arithmetic. Beside it sits its plain PyTorch
version: the same sums in the same order (``lap_from_taps`` /
``grad_from_taps`` and the ``pd`` / ``div`` bodies) on
:class:`~pystella_tpu_torch.ops.stencil.RollTaps`, which a CPU tensor
takes. ``mode="roll"`` asks for the JAX package's
``mode="roll"`` bodies instead (per-axis ``torch.roll`` sums) on any
device. Kernel and plain version agree to rounding: both round every
multiply and add separately (``-fmad=false``), in the same order.

With ``decomp=`` (a :class:`~pystella_tpu_torch.parallel.DomainDecomposition`)
the operators take :class:`~pystella_tpu_torch.parallel.ShardedArray` s and
run once per block, as the JAX package's ``_pallas_op`` runs them under
``shard_map``. On an ``(px, py, 1)`` mesh the kernel reads a window padded
by the neighbours' rows along the sharded axes (``fd_<op>:xpad``, ``:ypad``,
``:xypad``: the halo-input kernel ``StreamingStencil._build_xhalo``); on an
x-only mesh with the overlap on (:mod:`~pystella_tpu_torch.parallel.overlap`)
an interior launch on the raw block and two x-shell launches once the halos
have landed (``:interior``, ``:shell``: ``OverlapStreamingStencil``), each
writing its rows of the full output block in place. On a mesh that shards z
the ``mode="roll"`` bodies run on the padded blocks, as the JAX package's
halo tier there, and no kernel. Every sharded result equals the unsharded
operator's bit for bit (the same taps, the same sums).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from torch.profiler import record_function

from pystella_tpu_torch._device import resolve_device
from pystella_tpu_torch.ops import stencil as _stencil
from pystella_tpu_torch.parallel import overlap as _overlap
from pystella_tpu_torch.parallel.decomp import ShardedArray

__all__ = [
    "FirstCenteredDifference", "SecondCenteredDifference",
    "FiniteDifferencer", "LAUNCHES", "reset_launch_counts", "KERNELS",
    "OPS", "expand_stencil", "centered_diff",
]

#: operator -> index of its kernel in fd_ops.cu (the order of its entry
#: points)
OPS = ("lap", "grad", "grad_lap", "pdx", "pdy", "pdz", "div")

_SOURCE = "fd_ops.cu"
_JAX_SITE = "pystella_tpu/ops/derivs.py:354 (FiniteDifferencer._pallas_bodies"
#: kernel name -> (CUDA source in ops/csrc, the Pallas body it replaces)
KERNELS = {f"fd_{op}": (_SOURCE, f"{_JAX_SITE}, {op})") for op in OPS}

#: the sharded tier's launches, counted apart as ``<kernel>:<kind>``: on a
#: window padded along x, y or both, and the overlapped path's interior and
#: x-shell launches (x-padded windows on a region of the block) -> the bits
#: of the padded axes (1: x, 2: y)
PAD_KINDS = {"xpad": 1, "ypad": 2, "xypad": 3, "interior": 1, "shell": 1}
_XHALO_SITE = "pystella_tpu/ops/pallas_stencil.py:789 (StreamingStencil." \
    "_build_xhalo, call :840"
_OVERLAP_SITE = "pystella_tpu/ops/pallas_stencil.py:993 (" \
    "OverlapStreamingStencil.__call__, class :931"
#: sharded kernel name -> (CUDA source, the TPU kernel it replaces)
SHARDED_KERNELS = {
    f"fd_{op}:{kind}": (_SOURCE, (_OVERLAP_SITE if kind in (
        "interior", "shell") else _XHALO_SITE) + f"; body fd_{op})")
    for op in OPS for kind in PAD_KINDS}

#: kernel name -> number of launches since the last reset; the wrapper adds
#: one where it launches the kernel, and nowhere else
LAUNCHES = {name: 0 for name in list(KERNELS) + list(SHARDED_KERNELS)}

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
#: the entry point of each padding (interior and shell: the x-padded one)
_PAD_SUFFIX = {1: "_xpad", 2: "_ypad", 3: "_xypad"}


def reset_launch_counts():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def kernel_header(h):
    """The generated header ``fd_ops.cu`` is compiled against: the stencil
    radius alone (one library per ``h``, so the tap loops unroll)."""
    return ("// Generated by pystella_tpu_torch.ops.derivs; do not edit.\n"
            f"#pragma once\n#define PK_H {int(h)}\n")


#: the x planes a block of the Laplacian's x-march covers (fd_ops.cu:
#: PkFdLapTile, PK_FD_LAP_LX)
LAP_LX = 32


def lap_tile(h, itemsize, lx=None):
    """The Laplacian's x-march tile at stencil radius ``h`` for a working
    type of ``itemsize`` bytes: ``(lx, bytes)`` -- the x planes a block
    marches and the static shared memory a block, the 32 x 8 tile's
    centre plane with its y-z halo, ``(8 + 2h) (32 + 2h)`` elements (the
    +-x taps live in registers). ``lx`` defaults to the source's
    constant."""
    lx = LAP_LX if lx is None else lx
    return lx, (8 + 2 * h) * (32 + 2 * h) * itemsize


def lap_kernel_tile(h, dtype):
    """The built Laplacian's march tile at stencil radius ``h`` for
    working type ``dtype``, as the library reports it (``pk_fd_lap_tile``;
    :func:`lap_tile`)."""
    return reported_lap_tile(build_kernels(h)["tile"], dtype)


def reported_lap_tile(query, dtype):
    """What a library's ``pk_fd_lap_tile`` entry point ``query`` reports
    for working type ``dtype``, in :func:`lap_tile`'s form."""
    query.argtypes = [ctypes.c_int, ctypes.c_void_p]
    query.restype = ctypes.c_int
    out = (ctypes.c_int * 2)()
    query(int(dtype == torch.float64), out)
    return out[0], out[1]


#: the x planes a block of ``grad_lap``'s march covers, and whether its
#: next plane's loads go a step ahead (fd_ops.cu: PkFdGradLapTile,
#: PK_FD_GRAD_LAP_LX, PK_FD_GRAD_LAP_AHEAD); ``grad``'s, ``pdx``'s and
#: ``div``'s (PkFdGradTile, PK_FD_GRAD_LX, PK_FD_GRAD_AHEAD; PkFdPdTile,
#: PK_FD_PD_LX, PK_FD_PD_AHEAD; PkFdDivTile, PK_FD_DIV_LX, PK_FD_DIV_AHEAD)
GRAD_LAP_LX = 32
GRAD_LAP_AHEAD = 1
GRAD_LX = 16
GRAD_AHEAD = 1
PD_LX = 32
PD_AHEAD = 1
DIV_LX = 32
DIV_AHEAD = 1


def grad_lap_tile(h, itemsize, lx=None, ahead=None):
    """``grad_lap``'s x-march tile at stencil radius ``h`` for a working
    type of ``itemsize`` bytes: ``(lx, bytes, ahead)`` -- the Laplacian's
    tile (:func:`lap_tile`; one tapped array) at its own run length, and
    1 where the next plane's loads go a step ahead. ``lx`` and ``ahead``
    default to the source's constants."""
    lx = GRAD_LAP_LX if lx is None else lx
    ahead = GRAD_LAP_AHEAD if ahead is None else ahead
    return lap_tile(h, itemsize, lx) + (ahead,)


def grad_tile(h, itemsize, lx=None, ahead=None):
    """``grad``'s x-march tile, in :func:`grad_lap_tile`'s form: one tapped
    array at ``grad``'s own run length and look-ahead."""
    return grad_lap_tile(h, itemsize, GRAD_LX if lx is None else lx,
                         GRAD_AHEAD if ahead is None else ahead)


def pd_tile(h, itemsize, lx=None, ahead=None):
    """``pdx``'s x-march tile, in :func:`grad_lap_tile`'s form: one tapped
    array at its own run length and look-ahead, whose taps all come from a
    thread's register queue, so no shared memory."""
    return (PD_LX if lx is None else lx, 0,
            PD_AHEAD if ahead is None else ahead)


def div_tile(h, itemsize, lx=None, ahead=None):
    """``div``'s x-march tile, in :func:`grad_lap_tile`'s form: the three
    arrays of a vector tapped together, so three centre planes a block
    (15,360 bytes at f64 and h = 4)."""
    lx, nbytes, ahead = grad_lap_tile(h, itemsize,
                                      DIV_LX if lx is None else lx,
                                      DIV_AHEAD if ahead is None else ahead)
    return lx, 3 * nbytes, ahead


#: the queue marches' tiles: operator -> (the library's report, the mirror)
QUEUE_TILES = {"grad": ("pk_fd_grad_tile", grad_tile),
               "grad_lap": ("pk_fd_grad_lap_tile", grad_lap_tile),
               "pd": ("pk_fd_pd_tile", pd_tile),
               "div": ("pk_fd_div_tile", div_tile)}


def reported_queue_tile(query, dtype):
    """What a library's ``pk_fd_grad_tile``, ``pk_fd_grad_lap_tile``,
    ``pk_fd_pd_tile`` or ``pk_fd_div_tile`` entry point ``query`` reports
    for working type ``dtype``, in :func:`grad_lap_tile`'s form (x planes
    0: a build whose operators run per site)."""
    query.argtypes = [ctypes.c_int, ctypes.c_void_p]
    query.restype = ctypes.c_int
    out = (ctypes.c_int * 3)()
    query(int(dtype == torch.float64), out)
    return tuple(out)


#: stencil radius -> {(operator, dtype): C entry point}, built at first use
_LIBS = {}


def build_kernels(h):
    """Compile (or load from the build cache) the operator kernels of
    stencil radius ``h`` for float32 and float64; raises if ``nvcc``
    fails."""
    fns = _LIBS.get(h)
    if fns is None:
        lib = _stencil.build_kernels([_SOURCE], kernel_header(h))[_SOURCE]
        fns = bind_kernels(lib)
        fns["tile"] = lib.pk_fd_lap_tile
        for op, (query, _) in QUEUE_TILES.items():
            fns[op + "_tile"] = getattr(lib, query)
        for dtype in _SUFFIX:
            # the kernels' compile-time march tiles must be the ones
            # lap_tile, grad_tile, grad_lap_tile, pd_tile and div_tile
            # predict
            checks = [("lap", reported_lap_tile(fns["tile"], dtype),
                       lap_tile(h, dtype.itemsize))] + [
                (op, reported_queue_tile(fns[op + "_tile"], dtype),
                 mirror(h, dtype.itemsize))
                for op, (_, mirror) in QUEUE_TILES.items()]
            for op, got, want in checks:
                if got != want:
                    raise RuntimeError(
                        f"fd_ops.cu instantiates {op}'s tile {got} for "
                        f"{dtype}; ops/derivs.py:{op}_tile predicts {want}")
        _LIBS[h] = fns
    return fns


def bind_kernels(lib):
    """The operator entry points of a loaded fd_ops library, typed:
    ``{(operator, dtype, padding bits): C function}``."""
    fns = {}
    # in, out0, out1, C, X, Y, Z, weights, [Nb, Nw, Ys], stream
    base = ([ctypes.c_void_p] * 3 + [ctypes.c_int64]
            + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    for op in OPS:
        for dtype, suffix in _SUFFIX.items():
            for pad, psuffix in [(0, "")] + list(_PAD_SUFFIX.items()):
                fn = getattr(lib, f"pk_fd_{op}_{suffix}{psuffix}")
                fn.argtypes = base + (
                    [ctypes.c_int64] * 2 + [ctypes.c_int] if pad
                    else []) + [ctypes.c_void_p]
                fn.restype = ctypes.c_int
                fns[op, dtype, pad] = fn
    return fns


def expand_stencil(f, coefs):
    """Expand a symbolic stencil over a field: ``sum_s coefs[s] * f@s``
    where ``s`` ranges over 3-tuple site offsets. The result evaluates to
    periodic rolls under :func:`~pystella_tpu_torch.field.evaluate`: a
    custom operator without a kernel of its own."""
    from pystella_tpu_torch.field import shift_fields
    return sum(c * shift_fields(f, offset) for offset, c in coefs.items())


def centered_diff(f, coefs, direction, order):
    """Centered-difference stencil from its non-redundant coefficients:
    ``direction`` in (1, 2, 3) picks the axis, ``order``'s parity sets the
    sign of the mirrored coefficients."""
    all_coefs = {}
    for s, c in coefs.items():
        offset = [0, 0, 0]
        if s != 0 or order % 2 == 0:
            offset[direction - 1] = s
            all_coefs[tuple(offset)] = c
        if s != 0:
            offset = [0, 0, 0]
            offset[direction - 1] = -s
            all_coefs[tuple(offset)] = (-1) ** order * c
    return expand_stencil(f, all_coefs)


class FiniteDifferenceStencil:
    """Base class bundling centered-difference coefficients and analytic
    eigenvalues."""

    #: dict: offset (>0) -> coefficient; offset 0 included for even order
    coefs = NotImplemented
    truncation_order = NotImplemented
    order = NotImplemented

    def get_eigenvalues(self, k, dx):
        raise NotImplementedError


# first-derivative coefficients, truncation order 2h
_grad_coefs = {
    1: {1: 1 / 2},
    2: {1: 8 / 12, 2: -1 / 12},
    3: {1: 45 / 60, 2: -9 / 60, 3: 1 / 60},
    4: {1: 672 / 840, 2: -168 / 840, 3: 32 / 840, 4: -3 / 840},
}

# second-derivative coefficients
_lap_coefs = {
    1: {0: -2.0, 1: 1.0},
    2: {0: -30 / 12, 1: 16 / 12, 2: -1 / 12},
    3: {0: -490 / 180, 1: 270 / 180, 2: -27 / 180, 3: 2 / 180},
    4: {0: -14350 / 5040, 1: 8064 / 5040, 2: -1008 / 5040,
        3: 128 / 5040, 4: -9 / 5040},
}


class FirstCenteredDifference(FiniteDifferenceStencil):
    """Antisymmetric centered first difference of order ``2h``."""

    order = 1

    def __init__(self, h):
        self.h = h
        self.coefs = _grad_coefs[h]
        self.truncation_order = 2 * h

    def get_eigenvalues(self, k, dx):
        """Effective wavenumber of the stencil applied to a plane wave:
        the stencil maps ``exp(i k x)`` to ``i * eff_k * exp(i k x)``."""
        th = np.asarray(k) * dx
        return sum(2 * c * np.sin(s * th) for s, c in self.coefs.items()) / dx


class SecondCenteredDifference(FiniteDifferenceStencil):
    """Symmetric centered second difference of order ``2h``."""

    order = 2

    def __init__(self, h):
        self.h = h
        self.coefs = _lap_coefs[h]
        self.truncation_order = 2 * h

    def get_eigenvalues(self, k, dx):
        """Effective ``-k**2``: the stencil maps ``exp(i k x)`` to
        ``eig * exp(i k x)`` (negative semidefinite)."""
        th = np.asarray(k) * dx
        eig = self.coefs[0] * np.ones_like(th)
        eig = eig + sum(2 * c * np.cos(s * th)
                        for s, c in self.coefs.items() if s != 0)
        return eig / dx**2


class FiniteDifferencer:
    """Gradient, Laplacian and divergence on a periodic lattice, held whole
    on one device or sharded over a
    :class:`~pystella_tpu_torch.parallel.DomainDecomposition`. Operators
    return new tensors (or :class:`ShardedArray` s); lattice axes trail,
    and every leading axis is a component axis.

    :arg halo_shape: the stencil radius ``h`` (1..4 -> order 2..8).
    :arg dx: lattice spacing per axis (scalar or 3-tuple).
    :arg mode: ``"kernel"`` (default): on the card each operator is the
        hand-written kernel (built at first use; a kernel that does not
        build or launch raises), on the CPU the kernel's plain version.
        ``"roll"``: the per-axis ``torch.roll`` sums of the JAX package's
        ``mode="roll"`` (on a sharded array: the same sums on the padded
        blocks).
    :arg device: ``None`` (the GPU), ``"cuda"`` or ``"cpu"``, as every
        entry point of the port takes it. The operators take tensors on
        that device only and raise ``ValueError`` on another. With a
        ``decomp``, its devices (``device`` may name their type).
    :arg decomp: a :class:`~pystella_tpu_torch.parallel.DomainDecomposition`
        whose :class:`ShardedArray` s the operators take (they take plain
        tensors too).
    :arg overlap: the interior/shell split on x-sharded meshes
        (:func:`~pystella_tpu_torch.parallel.overlap.enabled`: ``None``
        reads ``PYSTELLA_HALO_OVERLAP``, auto: on for sharded meshes).
        Where no split exists (a y- or z-sharded mesh, a block thinner than
        ``3h`` along x) the padded launch runs, as in the JAX package.
    """

    def __init__(self, halo_shape, dx, *,
                 first_stencil_factory=FirstCenteredDifference,
                 stencil_factory=SecondCenteredDifference, mode="kernel",
                 device=None, decomp=None, overlap=None):
        if mode not in ("kernel", "roll"):
            raise ValueError(f"unknown mode {mode}")
        self.decomp = decomp
        if decomp is not None:
            types = {d.type for d in decomp.devices}
            if len(types) != 1 or (device is not None and torch.device(
                    device).type not in types):
                raise ValueError(
                    f"the decomposition's devices {decomp.devices} are not "
                    f"all of one type{'' if device is None else ' ' + str(device)}")
            device = decomp.devices[0]
        self.device = resolve_device(device)
        self.overlap = _overlap.enabled(decomp, override=overlap)
        self.h = int(halo_shape)
        if np.isscalar(dx):
            dx = (dx,) * 3
        self.dx = tuple(float(d) for d in dx)
        self.first = first_stencil_factory(self.h)
        self.second = stencil_factory(self.h)
        self.mode = mode
        self._inv_dx = [1.0 / d for d in self.dx]
        self._inv_dx2 = [1.0 / d**2 for d in self.dx]
        lap, grd = self.second.coefs, self.first.coefs
        offsets = range(1, self.h + 1)
        # the weights exactly as lap_from_taps and grad_from_taps form
        # them (Python doubles; the kernel casts them to its type)
        self._weights = (
            [lap[0] * sum(self._inv_dx2)]
            + [lap[s] * self._inv_dx2[ax] for ax in range(3)
               for s in offsets]
            + [grd[s] * self._inv_dx[ax] for ax in range(3)
               for s in offsets])

    def get_eigenvalues(self, k, dx, order=1):
        stencil = self.first if order == 1 else self.second
        return stencil.get_eigenvalues(k, dx)

    # -- the kernel and its plain version -----------------------------------

    def _out_shapes(self, name, C, lat):
        if name == "grad":
            return [(C, 3) + lat]
        if name == "grad_lap":
            return [(C, 3) + lat, (C,) + lat]
        if name == "div":
            return [(C // 3,) + lat]
        return [(C,) + lat]

    @staticmethod
    def _check_operand(name, xf):
        if name not in OPS:
            raise ValueError(f"unknown operator {name}")
        if xf.ndim != 4 or not xf.is_contiguous() \
                or xf.dtype not in _SUFFIX:
            raise ValueError(
                "the finite-difference kernels take a contiguous float32 "
                f"or float64 (C, X, Y, Z) tensor; got {xf.dtype} "
                f"{tuple(xf.shape)}"
                f"{'' if xf.is_contiguous() else ' (non-contiguous)'}")
        if name == "div" and xf.shape[0] % 3:
            raise ValueError("divergence takes 3 n components")

    def launch(self, name, xf):
        """Operator ``name`` of ``xf``, a contiguous ``(C, X, Y, Z)``
        tensor (``C = 3 n`` for ``div``): the kernel on a CUDA tensor
        (counting the launch), the plain version on a CPU tensor. Returns
        the list of outputs (``grad_lap``: gradient, then Laplacian)."""
        self._check_operand(name, xf)
        C, lat = xf.shape[0], tuple(xf.shape[1:])
        outs = [torch.empty(s, dtype=xf.dtype, device=xf.device)
                for s in self._out_shapes(name, C, lat)]
        return self.launch_block(name, None, xf, outs)

    def launch_block(self, name, kind, win, outs, x0=0):
        """One launch of the sharded tier (``kind`` in :data:`PAD_KINDS`;
        ``None``: the unsharded kernel on the whole of ``win``). ``win`` is
        the window, ``(C, X + 2 hx, Y + 2 hy, Z)`` with ``hx`` (``hy``) the
        radius ``h`` where ``kind`` pads x (y), else 0: the padded block, or
        for the overlapped path the raw block (interior) or a ``(C, 3h, Y,
        Z)`` shell input. The launch computes the ``(X, Y, Z)`` region and
        writes it into ``outs`` (the full output blocks) from x row ``x0``
        on. On a CPU tensor the plain version does the same. Counts the
        launch under ``fd_<name>[:<kind>]``; returns ``outs``."""
        self._check_operand(name, win)
        bits = PAD_KINDS[kind] if kind is not None else 0
        hx, hy = (self.h if bits & 1 else 0), (self.h if bits & 2 else 0)
        C, Xw, Yw, Z = win.shape
        X, Y = Xw - 2 * hx, Yw - 2 * hy
        want = self._out_shapes(name, C, (outs[0].shape[-3], Y, Z))
        if X < 1 or x0 < 0 or x0 + X > outs[0].shape[-3] or \
                [tuple(o.shape) for o in outs] != want or any(
                    o.dtype != win.dtype or o.device != win.device
                    or not o.is_contiguous() for o in outs):
            raise ValueError(
                f"outputs {[tuple(o.shape) for o in outs]} do not hold the "
                f"region of {X} x rows from row {x0} of {name} on a window "
                f"{tuple(win.shape)} ({kind or 'unpadded'})")
        label = f"fd_{name}" + (f":{kind}" if kind else "")
        if win.device.type == "cuda":
            if X > 65535 or (Y + 7) // 8 > 65535:
                raise ValueError(f"lattice {(X, Y, Z)} exceeds the kernels' "
                                 "launch grid")
            fn = build_kernels(self.h)[name, win.dtype, bits]
            item = win.element_size()
            Xb = outs[0].shape[-3]
            optr = [o.data_ptr() + x0 * Y * Z * item for o in outs]
            weights = (ctypes.c_double * len(self._weights))(*self._weights)
            geom = ((Xb * Y * Z, Xw * Yw * Z, Yw) if bits else ())
            with torch.cuda.device(win.device):
                stream = torch.cuda.current_stream(win.device).cuda_stream
                rc = fn(win.data_ptr() + (hx * Yw + hy) * Z * item, optr[0],
                        optr[1] if len(optr) > 1 else None, C, X, Y, Z,
                        weights, *geom, stream)
            if rc != 0:
                raise RuntimeError(f"{label} kernel launch failed with CUDA "
                                   f"error {rc}")
            LAUNCHES[label] += 1
            return outs
        if win.device.type == "cpu":
            res = self.plain(name, win, pad=(hx, hy))
            for o, r in zip(outs, res):
                o.narrow(o.ndim - 3, x0, X).copy_(r)
            return outs
        raise ValueError(f"no finite-difference kernel for device "
                         f"{win.device}")

    def _pd_plain(self, taps, d):
        """``pd_body`` of the JAX package: offsets accumulated from 0."""
        acc = 0
        for s, c in self.first.coefs.items():
            plus, minus = [0, 0, 0], [0, 0, 0]
            plus[d], minus[d] = s, -s
            acc = acc + c * self._inv_dx[d] * (taps(*plus) - taps(*minus))
        return acc

    def plain(self, name, xf, pad=None):
        """The kernel's plain version on ``xf`` (any device): the JAX
        bodies' sums, term by term, on periodic rolls -- or, with ``pad =
        (hx, hy)``, on a window padded by that many rows along x and y
        (:class:`~pystella_tpu_torch.ops.stencil.PaddedTaps`)."""
        if pad is None or pad == (0, 0):
            Taps = _stencil.RollTaps
        else:
            def Taps(w):
                return _stencil.PaddedTaps(w, pad)
        taps = Taps(xf)
        lap = lambda: _stencil.lap_from_taps(  # noqa: E731
            taps, self.second.coefs, self._inv_dx2)
        grad = lambda: torch.stack(_stencil.grad_from_taps(  # noqa: E731
            taps, self.first.coefs, self._inv_dx), dim=1)
        if name == "lap":
            return [lap()]
        if name == "grad":
            return [grad()]
        if name == "grad_lap":
            return [grad(), lap()]
        if name in ("pdx", "pdy", "pdz"):
            return [self._pd_plain(taps, OPS.index(name) - 3)]
        # div_body: over the axes, then over the offsets, of component d
        # (selected before the roll: the same values as selecting after)
        comps = xf.reshape((xf.shape[0] // 3, 3) + tuple(xf.shape[1:]))
        acc = 0
        for d in range(3):
            td = Taps(comps[:, d])
            for s, c in self.first.coefs.items():
                plus, minus = [0, 0, 0], [0, 0, 0]
                plus[d], minus[d] = s, -s
                acc = acc + c * self._inv_dx[d] * (td(*plus) - td(*minus))
        return [acc]

    def _fold(self, name, x):
        """Every leading axis (for ``div`` the vector axis too) folded into
        one component axis: the contiguous ``(C, X, Y, Z)`` operand and the
        outer shape the outputs unfold to."""
        if x.ndim < 3 + (name == "div"):
            raise ValueError(f"{name} takes at least "
                             f"{3 + (name == 'div')} axes")
        lat = tuple(x.shape[-3:])
        outer = tuple(x.shape[:-3])
        if name == "div":
            if outer[-1] != 3:
                raise ValueError("divergence takes a vector axis of length "
                                 "3 just before the lattice axes")
            outer = outer[:-1]
        return x.reshape((-1,) + lat).contiguous(), outer

    def _dispatch(self, name, x):
        """Fold, run the operator, and unfold."""
        if isinstance(x, ShardedArray):
            return self._sharded_dispatch(name, x)
        if x.device != self.device:
            raise ValueError(f"the operand is on {x.device}, but this "
                             f"FiniteDifferencer runs on {self.device}")
        if self.mode == "roll":
            return self._roll_dispatch(name, x)
        xf, outer = self._fold(name, x)
        outs = [o.reshape(outer + tuple(o.shape[1:]))
                for o in self.launch(name, xf)]
        return tuple(outs) if name == "grad_lap" else outs[0]

    # -- the sharded tier -----------------------------------------------------

    def _sharded_dispatch(self, name, x):
        """The operator on every block of ``x``, its windows padded by the
        neighbours' rows (or split into an interior and two x shells), the
        outputs assembled into :class:`ShardedArray` s."""
        d = self.decomp
        if d is None or x.decomp is not d:
            raise ValueError("a ShardedArray operand needs the "
                             "FiniteDifferencer of its decomposition "
                             "(decomp=)")
        if self.mode == "roll" or d.proc_shape[2] > 1:
            return self._sharded_roll(name, x)
        blocks, outer = [], None
        for b in x.blocks:
            xf, outer = self._fold(name, b)
            blocks.append(xf)
        C, lat = blocks[0].shape[0], tuple(blocks[0].shape[1:])
        outs = [[torch.empty(s, dtype=b.dtype, device=b.device)
                 for s in self._out_shapes(name, C, lat)] for b in blocks]
        kinds = _stencil.launch_kinds(d, self.h, lat, self.overlap)
        if None in kinds:
            for b, o in zip(blocks, outs):
                self.launch_block(name, None, b, o)
        elif "interior" in kinds:
            h, X = self.h, lat[0]
            lows = [b.new_empty((C, 3 * h) + lat[1:]) for b in blocks]
            highs = [b.new_empty((C, 3 * h) + lat[1:]) for b in blocks]
            with record_function("halo_overlap"):
                with d.side_exchange(blocks, lows + highs) as ex:
                    d.x_shells_into(blocks, lows, highs, h)
                with record_function("halo_overlap_interior"):
                    for b, o in zip(blocks, outs):
                        self.launch_block(name, "interior", b, o, x0=h)
                ex.wait()
                with record_function("halo_overlap_shells"):
                    for lo, hi, o in zip(lows, highs, outs):
                        self.launch_block(name, "shell", lo, o, x0=0)
                        self.launch_block(name, "shell", hi, o, x0=X - h)
        else:
            (kind,) = kinds
            padded = d._pad_blocks(
                blocks, _stencil.sharded_halo(self.h, *d.proc_shape[:2]),
                None)
            for p, o in zip(padded, outs):
                self.launch_block(name, kind, p, o)
        res = tuple(ShardedArray(
            [o[j].reshape(outer + tuple(o[j].shape[1:])) for o in outs], d)
            for j in range(len(outs[0])))
        return res if name == "grad_lap" else res[0]

    def _sharded_roll(self, name, x):
        """The ``mode="roll"`` sums on blocks padded by ``h`` along every
        axis (local wrap along the unsharded ones): a tap is a slice of
        the padded block, the values those of the unsharded rolls, so the
        result equals the unsharded roll-mode operator bit for bit."""
        h = self.h
        padded = self.decomp.pad_with_halos(x, (h, h, h))

        def shift(p, axis, s):
            idx = [slice(None)] * p.ndim
            for a in range(p.ndim - 3, p.ndim):
                n = p.shape[a] - 2 * h
                idx[a] = slice(h + s, h + s + n) if a == axis \
                    else slice(h, h + n)
            return p[tuple(idx)]
        res = [self._roll_dispatch(name, p, shift) for p in padded.blocks]
        if name == "grad_lap":
            return tuple(ShardedArray([r[j] for r in res], self.decomp)
                         for j in range(2))
        return ShardedArray(res, self.decomp)

    # -- roll-mode bodies ---------------------------------------------------

    @staticmethod
    def _roll(x, axis, s):
        """``x`` shifted by ``s`` along ``axis``: ``result[i] = x[i + s]``,
        periodically."""
        return torch.roll(x, -s, axis) if s else x

    @staticmethod
    def _roll_apply(x, axis, coefs, order, inv_dx, shift):
        sgn = (-1) ** order
        acc = None
        for s, c in sorted(coefs.items()):
            if s == 0:
                term = c * shift(x, axis, 0)
            else:
                term = c * (shift(x, axis, s) + sgn * shift(x, axis, -s))
            acc = term if acc is None else acc + term
        return acc * inv_dx

    def _roll_dispatch(self, name, x, shift=None):
        shift = shift or self._roll
        la = x.ndim - 3
        if name == "lap":
            return sum(self._roll_apply(x, la + d, self.second.coefs, 2,
                                        1 / self.dx[d]**2, shift)
                       for d in range(3))
        if name == "grad":
            return torch.stack([
                self._roll_apply(x, la + d, self.first.coefs, 1,
                                 1 / self.dx[d], shift)
                for d in range(3)], dim=la)
        if name == "grad_lap":
            return (self._roll_dispatch("grad", x, shift),
                    self._roll_dispatch("lap", x, shift))
        if name in ("pdx", "pdy", "pdz"):
            d = OPS.index(name) - 3
            return self._roll_apply(x, la + d, self.first.coefs, 1,
                                    1 / self.dx[d], shift)
        if name == "div":
            return sum(self._roll_apply(
                x.select(la - 1, d), la - 1 + d, self.first.coefs, 1,
                1 / self.dx[d], shift) for d in range(3))
        raise ValueError(name)

    # -- public operators ---------------------------------------------------

    def lap(self, f):
        """Laplacian of ``f`` (lattice axes trailing)."""
        return self._dispatch("lap", f)

    def grad(self, f):
        """Gradient; inserts a length-3 component axis before the lattice
        axes."""
        return self._dispatch("grad", f)

    def grad_lap(self, f):
        """Gradient and Laplacian from one read of ``f``."""
        return self._dispatch("grad_lap", f)

    def pdx(self, f):
        return self._dispatch("pdx", f)

    def pdy(self, f):
        return self._dispatch("pdy", f)

    def pdz(self, f):
        return self._dispatch("pdz", f)

    def divergence(self, vec):
        """Divergence of a vector field whose component axis (length 3)
        sits just before the lattice axes."""
        return self._dispatch("div", vec)

    def __call__(self, fx, *, lap=False, grd=False, div=False):
        """Batch interface: a dict of the requested outputs (``"lap"``,
        ``"grd"``, ``"div"``)."""
        out = {}
        if lap and grd:
            out["grd"], out["lap"] = self.grad_lap(fx)
        elif lap:
            out["lap"] = self.lap(fx)
        elif grd:
            out["grd"] = self.grad(fx)
        if div:
            out["div"] = self.divergence(fx)
        return out
