"""Grid-transfer operators (restriction and interpolation) for multigrid.

PyTorch counterpart of ``pystella_tpu/multigrid/transfer.py``. Both are
tensor-product per-axis operations on local blocks: restriction is a
strided slice of a padded array, interpolation an interleave (``stack`` +
``reshape``) of even and odd parts. A whole array is padded by periodic
wraps (:func:`periodic_pad`); a
:class:`~pystella_tpu_torch.parallel.ShardedArray` block by block, each
block padded by its neighbours' rows (``decomp.pad_with_halos``, the
operator's ``pad`` along all three axes), as the JAX package runs the
operators under ``shard_map``. The sums run in the JAX package's order
(``sorted(coefs)``, axis by axis), so the two agree to rounding; a sharded
result equals the whole array's bit for bit.

These are plain tensor operations in the JAX package too (outside any
Pallas kernel), so plain PyTorch is their port.
"""

from __future__ import annotations

import numpy as np
import torch

from pystella_tpu_torch.parallel.decomp import ShardedArray

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


def _padded(x, halo):
    """A block that arrives padded already (by :func:`_run_local`)."""
    return x


def _run_local(op, x, decomp):
    """``op.apply_local`` of a whole tensor, or, for a
    :class:`ShardedArray`, of every block padded by the neighbours' rows
    (the operator's ``pad`` along each axis; ``decomp`` defaults to the
    array's). The padded blocks of each device are the slices of one
    stacked tensor, and the operator runs once per device on its stack
    (its passes are elementwise along the stacked axis, so each block's
    result is the one it gives alone): one pass's launches serve all of a
    device's blocks."""
    if not isinstance(x, ShardedArray):
        return op.apply_local(x)
    decomp = x.decomp if decomp is None else decomp
    if x.decomp is not decomp:
        raise ValueError("the array is sharded over another decomposition")
    ranks = {}
    for r, b in enumerate(x.blocks):
        ranks.setdefault(b.device, []).append(r)
    blk = x.blocks[0]
    shape = blk.shape[:-3] + tuple(n + 2 * op.pad for n in blk.shape[-3:])
    stacks = {dev: blk.new_empty((len(rs),) + shape, device=dev)
              for dev, rs in ranks.items()}
    padded, out = [None] * len(x.blocks), [None] * len(x.blocks)
    for dev, rs in ranks.items():
        for r, p in zip(rs, stacks[dev].unbind(0)):
            padded[r] = p
    decomp.pad_into(x.blocks, padded, (op.pad,) * 3)
    for dev, rs in ranks.items():
        for r, o in zip(rs, op.apply_local(stacks[dev],
                                           pad_fn=_padded).unbind(0)):
            out[r] = o
    return ShardedArray(out, decomp)


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

    def __call__(self, f1, f2=None, decomp=None):
        """Restrict ``f1`` (a tensor, or a :class:`ShardedArray` block by
        block, its halos from ``decomp``, default the array's); with
        ``correct=True`` returns ``f2 - R(f1)``."""
        out = _run_local(self, f1, decomp)
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

    def __call__(self, f2, f1=None, decomp=None):
        """Interpolate the coarse array ``f2`` (a tensor, or a
        :class:`ShardedArray` block by block); with ``correct=True``
        returns ``f1 + I(f2)``."""
        out = _run_local(self, f2, decomp)
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
