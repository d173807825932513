"""Finite-difference operators on one device.

PyTorch counterpart of the single-device subset of
``pystella_tpu/ops/derivs.py``: the centered-difference coefficient tables,
the stencils' eigenvalues, and a :class:`FiniteDifferencer` with ``lap``,
``grad``, ``grad_lap``, ``pdx``/``pdy``/``pdz`` and ``divergence``.

On a CUDA tensor every operator is one launch of a hand-written kernel
(``ops/csrc/fd_ops.cu``, K12: the JAX package's
``FiniteDifferencer._pallas_bodies``), one thread per site with periodic
wrap by index arithmetic. Beside it sits its plain PyTorch version: the
same sums in the same order (``lap_from_taps`` / ``grad_from_taps`` and the
``pd`` / ``div`` bodies) on :class:`~pystella_tpu_torch.ops.stencil.RollTaps`,
which a CPU tensor takes. ``mode="roll"`` asks for the JAX package's
``mode="roll"`` bodies instead (per-axis ``torch.roll`` sums) on any
device. Kernel and plain version agree to rounding: both round every
multiply and add separately (``-fmad=false``), in the same order.

The multi-device variants of the JAX operators (x-padded inputs, the
interior + shell launches of the halo overlap) wait for the port of the
domain decomposition.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from pystella_tpu_torch._device import resolve_device
from pystella_tpu_torch.ops import stencil as _stencil

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

#: kernel name -> number of launches since the last reset; the wrapper adds
#: one where it launches the kernel, and nowhere else
LAUNCHES = {name: 0 for name in KERNELS}

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def reset_launch_counts():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def kernel_header(h):
    """The generated header ``fd_ops.cu`` is compiled against: the stencil
    radius alone (one library per ``h``, so the tap loops unroll)."""
    return ("// Generated by pystella_tpu_torch.ops.derivs; do not edit.\n"
            f"#pragma once\n#define PK_H {int(h)}\n")


#: stencil radius -> {(operator, dtype): C entry point}, built at first use
_LIBS = {}


def build_kernels(h):
    """Compile (or load from the build cache) the operator kernels of
    stencil radius ``h`` for float32 and float64; raises if ``nvcc``
    fails."""
    fns = _LIBS.get(h)
    if fns is None:
        lib = _stencil.build_kernels([_SOURCE], kernel_header(h))[_SOURCE]
        fns = {}
        for op in OPS:
            for dtype, suffix in _SUFFIX.items():
                fn = getattr(lib, f"pk_fd_{op}_{suffix}")
                # in, out0, out1, C, X, Y, Z, weights, stream
                fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int64]
                               + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2)
                fn.restype = ctypes.c_int
                fns[op, dtype] = fn
        _LIBS[h] = fns
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
    """Gradient, Laplacian and divergence on a periodic lattice held whole
    on one device. Operators return new tensors; lattice axes trail, and
    every leading axis is a component axis.

    :arg halo_shape: the stencil radius ``h`` (1..4 -> order 2..8).
    :arg dx: lattice spacing per axis (scalar or 3-tuple).
    :arg mode: ``"kernel"`` (default): on the card each operator is the
        hand-written kernel (built at first use; a kernel that does not
        build or launch raises), on the CPU the kernel's plain version.
        ``"roll"``: the per-axis ``torch.roll`` sums of the JAX package's
        ``mode="roll"``.
    :arg device: ``None`` (the GPU), ``"cuda"`` or ``"cpu"``, as every
        entry point of the port takes it. The operators take tensors on
        that device only and raise ``ValueError`` on another.
    """

    def __init__(self, halo_shape, dx, *,
                 first_stencil_factory=FirstCenteredDifference,
                 stencil_factory=SecondCenteredDifference, mode="kernel",
                 device=None):
        if mode not in ("kernel", "roll"):
            raise ValueError(f"unknown mode {mode}")
        self.device = resolve_device(device)
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

    def launch(self, name, xf):
        """Operator ``name`` of ``xf``, a contiguous ``(C, X, Y, Z)``
        tensor (``C = 3 n`` for ``div``): the kernel on a CUDA tensor
        (counting the launch), the plain version on a CPU tensor. Returns
        the list of outputs (``grad_lap``: gradient, then Laplacian)."""
        if name not in OPS:
            raise ValueError(f"unknown operator {name}")
        if xf.ndim != 4 or not xf.is_contiguous() \
                or xf.dtype not in _SUFFIX:
            raise ValueError(
                "the finite-difference kernels take a contiguous float32 "
                f"or float64 (C, X, Y, Z) tensor; got {xf.dtype} "
                f"{tuple(xf.shape)}"
                f"{'' if xf.is_contiguous() else ' (non-contiguous)'}")
        C, lat = xf.shape[0], tuple(xf.shape[1:])
        if name == "div" and C % 3:
            raise ValueError("divergence takes 3 n components")
        if xf.device.type == "cuda":
            X, Y, Z = lat
            if X > 65535 or (Y + 7) // 8 > 65535:
                raise ValueError(f"lattice {lat} exceeds the kernels' "
                                 "launch grid")
            fn = build_kernels(self.h)[name, xf.dtype]
            outs = [torch.empty(s, dtype=xf.dtype, device=xf.device)
                    for s in self._out_shapes(name, C, lat)]
            weights = (ctypes.c_double * len(self._weights))(*self._weights)
            with torch.cuda.device(xf.device):
                stream = torch.cuda.current_stream(xf.device).cuda_stream
                rc = fn(xf.data_ptr(), outs[0].data_ptr(),
                        outs[1].data_ptr() if len(outs) > 1 else None,
                        C, X, Y, Z, weights, stream)
            if rc != 0:
                raise RuntimeError(f"fd_{name} kernel launch failed with "
                                   f"CUDA error {rc}")
            LAUNCHES[f"fd_{name}"] += 1
            return outs
        if xf.device.type == "cpu":
            return self.plain(name, xf)
        raise ValueError(f"no finite-difference kernel for device "
                         f"{xf.device}")

    def _pd_plain(self, taps, d):
        """``pd_body`` of the JAX package: offsets accumulated from 0."""
        acc = 0
        for s, c in self.first.coefs.items():
            plus, minus = [0, 0, 0], [0, 0, 0]
            plus[d], minus[d] = s, -s
            acc = acc + c * self._inv_dx[d] * (taps(*plus) - taps(*minus))
        return acc

    def plain(self, name, xf):
        """The kernel's plain version on ``xf`` (any device): the JAX
        bodies' sums, term by term, on periodic rolls."""
        taps = _stencil.RollTaps(xf)
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
            td = _stencil.RollTaps(comps[:, d])
            for s, c in self.first.coefs.items():
                plus, minus = [0, 0, 0], [0, 0, 0]
                plus[d], minus[d] = s, -s
                acc = acc + c * self._inv_dx[d] * (td(*plus) - td(*minus))
        return [acc]

    def _dispatch(self, name, x):
        """Fold every leading axis (for ``div`` the vector axis too) into
        one component axis, run the operator, and unfold."""
        if x.device != self.device:
            raise ValueError(f"the operand is on {x.device}, but this "
                             f"FiniteDifferencer runs on {self.device}")
        if self.mode == "roll":
            return self._roll_dispatch(name, x)
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
        xf = x.reshape((-1,) + lat).contiguous()
        outs = [o.reshape(outer + tuple(o.shape[1:]))
                for o in self.launch(name, xf)]
        return tuple(outs) if name == "grad_lap" else outs[0]

    # -- roll-mode bodies ---------------------------------------------------

    @staticmethod
    def _roll_apply(x, axis, coefs, order, inv_dx):
        sgn = (-1) ** order
        acc = None
        for s, c in sorted(coefs.items()):
            if s == 0:
                term = c * x
            else:
                term = c * (torch.roll(x, -s, axis)
                            + sgn * torch.roll(x, s, axis))
            acc = term if acc is None else acc + term
        return acc * inv_dx

    def _roll_dispatch(self, name, x):
        la = x.ndim - 3
        if name == "lap":
            return sum(self._roll_apply(x, la + d, self.second.coefs, 2,
                                        1 / self.dx[d]**2) for d in range(3))
        if name == "grad":
            return torch.stack([
                self._roll_apply(x, la + d, self.first.coefs, 1,
                                 1 / self.dx[d]) for d in range(3)], dim=la)
        if name == "grad_lap":
            return (self._roll_dispatch("grad", x),
                    self._roll_dispatch("lap", x))
        if name in ("pdx", "pdy", "pdz"):
            d = OPS.index(name) - 3
            return self._roll_apply(x, la + d, self.first.coefs, 1,
                                    1 / self.dx[d])
        if name == "div":
            return sum(self._roll_apply(
                x.select(la - 1, d), la - 1 + d, self.first.coefs, 1,
                1 / self.dx[d]) for d in range(3))
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
