"""Grid-transfer operators (restriction and interpolation) for multigrid.

PyTorch counterpart of ``pystella_tpu/multigrid/transfer.py``. Both are
tensor-product per-axis operations on whole arrays held on one device:
restriction is a strided slice of a periodically padded array,
interpolation an interleave (``stack`` + ``reshape``) of even and odd
parts. The sums run in the JAX package's order (``sorted(coefs)``, axis by
axis), so the two agree to rounding.

These are plain tensor operations in the JAX package too (outside any
Pallas kernel), so plain PyTorch is their port.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["RestrictionBase", "FullWeighting", "Injection",
           "InterpolationBase", "LinearInterpolation", "CubicInterpolation",
           "periodic_pad"]


def periodic_pad(x, halo, lattice_axes=None):
    """Pad the lattice axes of ``x`` with periodic wraps of width
    ``halo[d]``."""
    if np.isscalar(halo):
        halo = (halo,) * 3
    if lattice_axes is None:
        lattice_axes = tuple(range(x.ndim - 3, x.ndim))
    for d, ax in enumerate(lattice_axes):
        h = halo[d]
        if h == 0:
            continue
        n = x.shape[ax]
        x = torch.cat([x.narrow(ax, n - h, h), x, x.narrow(ax, 0, h)],
                      dim=ax)
    return x


def _strided(x, ax, start, count, stride=1):
    """``count`` entries of axis ``ax`` from ``start``, every ``stride``."""
    index = [slice(None)] * x.ndim
    index[ax] = slice(start, start + stride * (count - 1) + 1, stride)
    return x[tuple(index)]


class RestrictionBase:
    """Tensor-product restriction: coarse point ``i`` receives
    ``sum_o c_o * fine[2 i + o]`` along each axis.

    :arg coefs: dict mapping fine-grid offset ``o`` (relative to the
        coinciding fine point ``2 i``) to its weight.
    :arg halo_shape: accepted for API parity (padding is handled here, not
        baked into array shapes).
    :arg correct: if True, :meth:`__call__` computes ``f2 - R(f1)``.
    """

    coefs = {0: 1}

    def __init__(self, halo_shape=0, correct=False, **kwargs):
        self.halo_shape = halo_shape
        self.correct = correct
        self.pad = max(abs(int(o)) for o in self.coefs)

    def apply_local(self, x, pad_fn=periodic_pad):
        """Restrict the trailing 3 (lattice) axes of ``x`` (even extents)
        to half resolution."""
        hp = self.pad
        la = x.ndim - 3
        if hp:
            x = pad_fn(x, (hp,) * 3)
        for d in range(3):
            ax = la + d
            m = (x.shape[ax] - 2 * hp) // 2
            acc = None
            for o, c in sorted(self.coefs.items()):
                sl = _strided(x, ax, hp + o, m, 2)
                acc = c * sl if acc is None else acc + c * sl
            # the strided slice consumed this axis's pad; later axes keep
            # theirs until their own pass
            x = acc
        return x

    def __call__(self, f1, f2=None):
        """Restrict ``f1``; with ``correct=True`` returns ``f2 - R(f1)``."""
        out = self.apply_local(f1)
        if self.correct:
            if f2 is None:
                raise ValueError("correct=True requires f2")
            return f2 - out
        return out


class FullWeighting(RestrictionBase):
    """1/4, 1/2, 1/4 full-weighting restriction per axis."""

    coefs = {-1: 1 / 4, 0: 1 / 2, 1: 1 / 4}


class Injection(RestrictionBase):
    """Direct injection ``f2[i] = f1[2i]``."""

    coefs = {0: 1}


class InterpolationBase:
    """Tensor-product interpolation, coarse to fine. Per axis:
    ``fine[2i] = sum_e e_c * coarse[i+e]`` and
    ``fine[2i+1] = sum_o o_c * coarse[i+o]``, with coefficients given in
    coarse-grid offsets; the two parts interleave via stack + reshape.

    :arg correct: if True, :meth:`__call__` computes ``f1 + I(f2)``.
    """

    even_coefs = {0: 1}
    odd_coefs = {0: 1 / 2, 1: 1 / 2}

    def __init__(self, halo_shape=0, correct=False, **kwargs):
        self.halo_shape = halo_shape
        self.correct = correct
        offs = list(self.even_coefs) + list(self.odd_coefs)
        self.pad = max(abs(int(o)) for o in offs)

    def apply_local(self, x, pad_fn=periodic_pad):
        """Interpolate the trailing 3 (lattice) axes of a coarse array to
        double resolution."""
        hp = self.pad
        la = x.ndim - 3
        if hp:
            x = pad_fn(x, (hp,) * 3)

        for d in range(3):
            ax = la + d
            m = x.shape[ax] - 2 * hp

            def part(coefs):
                acc = None
                for o, c in sorted(coefs.items()):
                    sl = _strided(x, ax, hp + o, m)
                    acc = c * sl if acc is None else acc + c * sl
                return acc

            even, odd = part(self.even_coefs), part(self.odd_coefs)
            shape = list(even.shape)
            shape[ax] *= 2
            x = torch.stack([even, odd], dim=ax + 1).reshape(shape)
        return x

    def __call__(self, f2, f1=None):
        """Interpolate the coarse array ``f2``; with ``correct=True``
        returns ``f1 + I(f2)``."""
        out = self.apply_local(f2)
        if self.correct:
            if f1 is None:
                raise ValueError("correct=True requires f1")
            return f1 + out
        return out


class LinearInterpolation(InterpolationBase):
    """Linear interpolation."""

    even_coefs = {0: 1}
    odd_coefs = {0: 1 / 2, 1: 1 / 2}


class CubicInterpolation(InterpolationBase):
    """Cubic interpolation; odd fine points take a 4-point coarse
    stencil."""

    even_coefs = {0: 1}
    odd_coefs = {-1: -1 / 16, 0: 9 / 16, 1: 9 / 16, 2: -1 / 16}
