"""Lattice specification for 3-D periodic grids.

PyTorch counterpart of ``pystella_tpu/grid.py``: the lattice is a single
first-class object, and arrays are unpadded ``(..., X, Y, Z)`` tensors.
"""

from __future__ import annotations

import dataclasses
import math
from functools import cached_property

import numpy as np
import torch

from pystella_tpu_torch._device import resolve_device, torch_dtype


@dataclasses.dataclass(frozen=True)
class Lattice:
    """A 3-D periodic lattice.

    :arg grid_shape: number of points per axis, e.g. ``(64, 64, 64)``.
    :arg box_dim: physical side lengths; defaults to unit box per axis.
    :arg dtype: real dtype of fields living on this lattice (numpy or
        torch; stored as a :class:`torch.dtype`).
    """

    grid_shape: tuple[int, ...]
    box_dim: tuple[float, ...] = None
    dtype: torch.dtype = torch.float32

    def __post_init__(self):
        object.__setattr__(self, "grid_shape",
                           tuple(int(n) for n in self.grid_shape))
        if self.box_dim is None:
            object.__setattr__(self, "box_dim",
                               tuple(1.0 for _ in self.grid_shape))
        else:
            object.__setattr__(self, "box_dim",
                               tuple(float(b) for b in self.box_dim))
        if len(self.box_dim) != len(self.grid_shape):
            raise ValueError("box_dim and grid_shape must have equal length")
        object.__setattr__(self, "dtype", torch_dtype(self.dtype))

    @property
    def dim(self) -> int:
        return len(self.grid_shape)

    @cached_property
    def dx(self) -> tuple[float, ...]:
        return tuple(b / n for b, n in zip(self.box_dim, self.grid_shape))

    @cached_property
    def dk(self) -> tuple[float, ...]:
        return tuple(2 * math.pi / b for b in self.box_dim)

    @property
    def grid_size(self) -> int:
        return int(np.prod(self.grid_shape))

    @property
    def volume(self) -> float:
        return float(np.prod(self.box_dim))

    @property
    def dV(self) -> float:
        return float(np.prod(self.dx))

    def coords(self, axis: int, device=None) -> torch.Tensor:
        """Coordinate values along ``axis`` (length ``grid_shape[axis]``)."""
        n = self.grid_shape[axis]
        return (torch.arange(n, dtype=self.dtype,
                             device=resolve_device(device))
                * self.dx[axis])

    def mode_numbers(self, axis: int, real_last: bool = True) -> np.ndarray:
        """Integer FFT mode numbers along ``axis``.

        The Nyquist mode is returned *positive*. If ``real_last`` and
        ``axis`` is the final axis, returns the r2c half-spectrum
        ``0..n//2``.
        """
        n = self.grid_shape[axis]
        if real_last and axis == self.dim - 1:
            return np.arange(n // 2 + 1)
        freqs = np.fft.fftfreq(n, 1 / n)
        freqs[n // 2] = abs(freqs[n // 2])  # positive Nyquist
        return freqs

    def __repr__(self):
        return (f"Lattice(grid_shape={self.grid_shape}, box_dim={self.box_dim}, "
                f"dtype={str(self.dtype).replace('torch.', '')})")
