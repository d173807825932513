"""Finite-difference operators on one device.

PyTorch counterpart of the single-device subset of
``pystella_tpu/ops/derivs.py``: the centered-difference coefficient tables,
the stencils' eigenvalues, and a :class:`FiniteDifferencer` whose ``lap``
and ``grad`` are periodic ``torch.roll`` sums (the JAX package's
``mode="roll"`` bodies). This is the generic path the fused stepper is
checked against; multi-device operators and their kernels come later.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "FirstCenteredDifference", "SecondCenteredDifference",
    "FiniteDifferencer",
]


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
    """Gradient and Laplacian on a periodic lattice held whole on one
    device. Operators return new tensors; lattice axes trail.

    :arg halo_shape: the stencil radius ``h`` (1..4 -> order 2..8).
    :arg dx: lattice spacing per axis (scalar or 3-tuple).
    """

    def __init__(self, halo_shape, dx, *,
                 first_stencil_factory=FirstCenteredDifference,
                 stencil_factory=SecondCenteredDifference):
        self.h = int(halo_shape)
        if np.isscalar(dx):
            dx = (dx,) * 3
        self.dx = tuple(float(d) for d in dx)
        self.first = first_stencil_factory(self.h)
        self.second = stencil_factory(self.h)

    def get_eigenvalues(self, k, dx, order=1):
        stencil = self.first if order == 1 else self.second
        return stencil.get_eigenvalues(k, dx)

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

    def lap(self, f):
        """Laplacian of ``f`` (lattice axes trailing)."""
        la = f.ndim - 3
        return sum(self._roll_apply(f, la + d, self.second.coefs, 2,
                                    1 / self.dx[d]**2) for d in range(3))

    def grad(self, f):
        """Gradient; inserts a length-3 component axis before the lattice
        axes."""
        la = f.ndim - 3
        return torch.stack([
            self._roll_apply(f, la + d, self.first.coefs, 1, 1 / self.dx[d])
            for d in range(3)], dim=la)
