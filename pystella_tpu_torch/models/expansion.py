"""FLRW scale-factor evolution in conformal time.

PyTorch-package counterpart of ``pystella_tpu/models/expansion.py`` (a copy:
the module is plain numpy, and the port loads nothing of the JAX package).
The two-variable scale-factor ODE runs on the host, in float64 numpy
scalars, on the port's :class:`~pystella_tpu_torch.step.LowStorageRKStepper`
classes (whose ``init_carry`` keeps host scalars host-side).
"""

from __future__ import annotations

import numpy as np

__all__ = ["Expansion"]


class Expansion:
    """Scale-factor stepping for conformal FLRW spacetime.

    :arg energy: initial energy density (initializes ``adot`` via
        Friedmann 1).
    :arg Stepper: a :class:`~pystella_tpu_torch.step.Stepper` subclass.
    :arg mpl: unreduced Planck mass; sets units.
    """

    def __init__(self, energy, Stepper, mpl=1.0, dtype=np.float64):
        self.mpl = mpl
        self.dtype = np.dtype(dtype)
        self.a = self.dtype.type(1.0)
        self.adot = self.adot_friedmann_1(self.a, energy)
        self.hubble = self.adot / self.a

        def rhs(state, t, energy=0.0, pressure=0.0):
            return {"a": state["adot"],
                    "adot": self.addot_friedmann_2(state["a"], energy,
                                                   pressure)}

        self.stepper = Stepper(rhs)
        self._carry = None

    def adot_friedmann_1(self, a, energy):
        """``da/dtau`` from Friedmann's first equation,
        ``H² = 8 pi a² rho / (3 mpl²)``."""
        return np.sqrt(8 * np.pi * a**2 / 3 / self.mpl**2 * energy) * a

    def addot_friedmann_2(self, a, energy, pressure):
        """``d²a/dtau²`` from Friedmann's second equation."""
        return (4 * np.pi * a**2 / 3 / self.mpl**2
                * (energy - 3 * pressure) * a)

    def step(self, stage, energy, pressure, dt):
        """Execute one stage of the stepper; updates ``a``, ``adot``,
        ``hubble``."""
        state_or_carry = ({"a": self.a, "adot": self.adot}
                          if stage == 0 else self._carry)
        result = self.stepper(stage, state_or_carry, 0.0, dt,
                              energy=energy, pressure=pressure)
        if stage == self.stepper.num_stages - 1:
            self.a = self.dtype.type(result["a"])
            self.adot = self.dtype.type(result["adot"])
            self._carry = None
        else:
            self._carry = result
            current = self.stepper.current(result)
            self.a = self.dtype.type(current["a"])
            self.adot = self.dtype.type(current["adot"])
        self.hubble = self.adot / self.a

    def stage_sequence(self, nsteps, energy, pressure, dt):
        """Advance ``nsteps`` full steps with FROZEN ``(energy, pressure)``,
        recording the per-stage ``(a, hubble)`` a driver loop would have
        passed to each field stage (the value *entering* the stage): the
        host-side precompute for :meth:`FusedScalarStepper.multi_step`'s
        ``rhs_seq``. ``self`` IS advanced to the chunk end. Returns two
        ``(nsteps * num_stages,)`` float arrays ``(a_seq, hubble_seq)``."""
        ns = self.stepper.num_stages
        a_seq = np.empty(nsteps * ns, self.dtype)
        hubble_seq = np.empty(nsteps * ns, self.dtype)
        i = 0
        for _ in range(nsteps):
            for s in range(ns):
                a_seq[i], hubble_seq[i] = self.a, self.hubble
                self.step(s, energy, pressure, dt)
                i += 1
        return a_seq, hubble_seq

    def constraint(self, energy):
        """Dimensionless violation of Friedmann 1 as an evolution
        constraint."""
        return np.abs(self.adot_friedmann_1(self.a, energy) / self.adot - 1)

    def constraint_residual(self, a, adot, energy):
        """The same Friedmann-1 residual as :meth:`constraint`, computed
        from explicit ``(a, adot, energy)`` with power/abs arithmetic only
        (so it also evaluates on tensors)."""
        adot_f1 = (8 * np.pi * a**2 / 3 / self.mpl**2 * energy) ** 0.5 * a
        return abs(adot_f1 / adot - 1)
