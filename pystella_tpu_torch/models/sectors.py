"""Physics sectors: symbolic equation systems for preheating simulations.

PyTorch counterpart of the scalar subset of
``pystella_tpu/models/sectors.py``. A Sector bundles a symbolic
``rhs_dict`` (consumed by :class:`~pystella_tpu_torch.step.Stepper`) and
energy ``reducers``. Expressions evaluate against state environments holding
the field tensors plus auxiliary names (``lap_f``, ``a``, ``hubble``)
supplied by the caller.
"""

from __future__ import annotations

import numpy as np

from pystella_tpu_torch.field import DynamicField, Var, diff

__all__ = ["Sector", "ScalarSector", "tensor_index", "get_rho_and_p"]


def tensor_index(i, j):
    """Pack 1-based symmetric rank-2 indices ``(i, j)`` into a 0-based
    length-6 storage index (``tensor_index(1, 1) == 0``)."""
    a, b = min(i, j), max(i, j)
    return (7 - a) * a // 2 - 4 + b


class Sector:
    """Base class."""

    @property
    def rhs_dict(self):
        """Symbolic system of equations for time integration."""
        raise NotImplementedError

    @property
    def reducers(self):
        """Quantities to reduce over the lattice (energy components etc.)."""
        raise NotImplementedError


class ScalarSector(Sector):
    """Scalar fields with an arbitrary potential in conformal FLRW
    spacetime.

    :arg nscalars: number of scalar fields.
    :arg f: the :class:`~pystella_tpu_torch.field.DynamicField`; defaults
        to ``DynamicField("f", shape=(nscalars,))``.
    :arg potential: callable mapping the field (symbolically) to the scalar
        potential; defaults to zero.

    The Klein-Gordon right-hand side in conformal time is
    ``f'' = lap f - 2 H f' - a^2 dV/df``.
    """

    def __init__(self, nscalars, **kwargs):
        self.nscalars = nscalars
        self.f = kwargs.pop("f", DynamicField("f", shape=(nscalars,)))
        self.potential = kwargs.pop("potential", lambda x: 0)

    @property
    def rhs_dict(self):
        f = self.f
        H = Var("hubble")
        a = Var("a")

        rhs_dict = {}
        V = self.potential(f)
        for fld in range(self.nscalars):
            rhs_dict[f[fld]] = f.dot[fld]
            rhs_dict[f.dot[fld]] = (f.lap[fld]
                                    - 2 * H * f.dot[fld]
                                    - a**2 * diff(V, f[fld]))
        return rhs_dict

    @property
    def reducers(self):
        f = self.f
        a = Var("a")

        return {
            "kinetic": [f.dot[fld]**2 / 2 / a**2
                        for fld in range(self.nscalars)],
            "potential": [self.potential(f)],
            "gradient": [-f[fld] * f.lap[fld] / 2 / a**2
                         for fld in range(self.nscalars)],
        }


def get_rho_and_p(energy):
    """Callback for energy reductions computing total density and
    pressure."""
    energy["total"] = sum(np.sum(e) for e in energy.values())
    energy["pressure"] = 0
    if "kinetic" in energy:
        energy["pressure"] = energy["pressure"] + np.sum(energy["kinetic"])
    if "gradient" in energy:
        energy["pressure"] = energy["pressure"] - np.sum(energy["gradient"]) / 3
    if "potential" in energy:
        energy["pressure"] = energy["pressure"] - np.sum(energy["potential"])
    return energy
