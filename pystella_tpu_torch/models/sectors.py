"""Physics sectors: symbolic equation systems for preheating simulations.

PyTorch counterpart of ``pystella_tpu/models/sectors.py``. A Sector bundles
a symbolic ``rhs_dict`` (consumed by :class:`~pystella_tpu_torch.step.Stepper`),
energy ``reducers`` and a ``stress_tensor`` method (consumed by
:class:`TensorPerturbationSector`). Expressions evaluate against state
environments holding the field tensors plus auxiliary names (``lap_f``,
``dfdx``, ``a``, ``hubble``) supplied by the caller.
"""

from __future__ import annotations

import numpy as np

from pystella_tpu_torch.field import DynamicField, Var, diff

__all__ = ["Sector", "ScalarSector", "TensorPerturbationSector",
           "tensor_index", "get_rho_and_p"]


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

    def stress_tensor(self, mu, nu, drop_trace=True):
        """The component ``T_{mu nu}`` of this sector's stress-energy."""
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

    def energy_means(self, f, dfdt, a=1.0, lap_f=None):
        """Mean energy densities of the scalar system: ``kinetic`` and
        ``potential`` (plus ``gradient`` when ``lap_f`` is given, in the
        reducers' integration-by-parts form) and their ``total``, matching
        :attr:`reducers` up to the lattice average. Tensor operations only
        (0-d tensors, no host sync), in the arithmetic order of the JAX
        package's ``energy_means``.

        :arg f, dfdt: field tensors ``(nscalars, ...)``.
        :arg a: scale factor.
        :arg lap_f: optional Laplacian of ``f``; without it the gradient
            energy is left out rather than paid for with a stencil pass.
        """
        import torch

        from pystella_tpu_torch.field import evaluate

        out = {"kinetic": torch.mean(torch.sum(dfdt * dfdt, dim=0))
               / 2 / a**2}
        if lap_f is not None:
            out["gradient"] = (torch.mean(torch.sum(-f * lap_f, dim=0))
                               / 2 / a**2)
        pot = torch.as_tensor(evaluate(self.potential(self.f),
                                       {self.f.name: f}),
                              dtype=f.dtype, device=f.device)
        out["potential"] = torch.mean(torch.broadcast_to(pot, f.shape[1:]))
        out["total"] = sum(out.values())
        return out

    def stress_tensor(self, mu, nu, drop_trace=False):
        f = self.f
        a = Var("a")

        tmunu = sum(f.d(fld, mu) * f.d(fld, nu)
                    for fld in range(self.nscalars))
        if drop_trace:
            return tmunu

        metric_inv = np.diag((-1, 1, 1, 1))  # times 1/a^2 (contravariant)
        lag = (- sum(sum(metric_inv[alpha, beta] / a**2
                         * f.d(fld, alpha) * f.d(fld, beta)
                         for alpha in range(4) for beta in range(4))
                     for fld in range(self.nscalars)) / 2
               - self.potential(f))
        metric = np.diag((-1, 1, 1, 1))  # times a^2 (covariant)
        return tmunu + metric[mu, nu] * a**2 * lag


class TensorPerturbationSector(Sector):
    """Transverse-traceless metric perturbations ``h_ij`` sourced by the
    anisotropic stress of other sectors:
    ``h_ij'' = lap h_ij - 2 H h_ij' + 16 pi S_ij``.

    :arg sectors: list of Sectors whose ``stress_tensor`` sources ``hij``.
    :arg hij: defaults to ``DynamicField("hij", shape=(6,))``; component
        ``tensor_index(i, j)`` holds ``h_ij``.
    """

    def __init__(self, sectors, **kwargs):
        self.hij = kwargs.pop("hij", DynamicField("hij", shape=(6,)))
        self.sectors = sectors

    @property
    def rhs_dict(self):
        hij = self.hij
        H = Var("hubble")

        rhs_dict = {}
        for i in range(1, 4):
            for j in range(i, 4):
                fld = tensor_index(i, j)
                sij = sum(sector.stress_tensor(i, j, drop_trace=True)
                          for sector in self.sectors)
                rhs_dict[hij[fld]] = hij.dot[fld]
                rhs_dict[hij.dot[fld]] = (hij.lap[fld]
                                          - 2 * H * hij.dot[fld]
                                          + 16 * np.pi * sij)
        return rhs_dict

    @property
    def reducers(self):
        return {}


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
