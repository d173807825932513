"""Explicit Runge-Kutta time steppers over tree states.

PyTorch counterpart of ``pystella_tpu/step.py``. A state is a dict (or
list/tuple) of tensors, or of Python numbers for a scalar ODE; stage
updates are tree maps run eagerly. All tableaus carry over digit for
digit (the coefficients are published constants: Carpenter & Kennedy 1994;
Niegemann, Diehl & Busch 2012; Williamson 1980).

The right-hand side is a plain function ``rhs(state, t, **args) -> dstate``
(same tree structure), or a symbolic ``rhs_dict`` mapping
:class:`~pystella_tpu_torch.field.Field`\\ s to expressions (compiled via
:func:`~pystella_tpu_torch.field.evaluate`).
"""

from __future__ import annotations

import numpy as np
import torch

from pystella_tpu_torch import field as _field

__all__ = [
    "Stepper", "RungeKuttaStepper", "LowStorageRKStepper", "compile_rhs_dict",
    "RungeKutta4", "RungeKutta3Heun", "RungeKutta3Nystrom",
    "RungeKutta3Ralston", "RungeKutta3SSP", "RungeKutta2Midpoint",
    "RungeKutta2Heun", "RungeKutta2Ralston",
    "LowStorageRK54", "LowStorageRK144", "LowStorageRK134", "LowStorageRK124",
    "LowStorageRK3Williamson", "LowStorageRK3Inhomogeneous",
    "LowStorageRK3Symmetric", "LowStorageRK3PredictorCorrector",
    "LowStorageRK3SSP", "all_steppers",
]


def _tree_map(fn, tree, *rest):
    """``fn`` over the leaves of dict/list/tuple trees of equal structure."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def _axpy(a, x, b, y):
    """a*x + b*y over trees (a, b scalars)."""
    return _tree_map(lambda u, v: a * u + b * v, x, y)


def _key_name(key):
    if isinstance(key, _field.Field):
        return key.name
    if isinstance(key, str):
        return key
    raise TypeError(f"rhs_dict keys must be Field or str, got {type(key)}")


def compile_rhs_dict(rhs_dict):
    """Compile a symbolic ``{Field: expr}`` dict into a function
    ``rhs(state, t, **args) -> dstate``. Non-state names in the expressions
    (laplacians, scale factor, ...) are looked up in ``args``.

    Keys may be whole Fields or indexed components (``f[0]``, ``f[1]``, ...,
    as Sectors produce); component results are stacked along the leading
    axis of the state entry."""
    scalar_items = []
    indexed = {}
    for k, v in rhs_dict.items():
        if isinstance(k, _field.Indexed):
            if len(k.index) != 1:
                raise ValueError(
                    "only single-axis indexed rhs_dict keys are supported")
            indexed.setdefault(k.field.name, {})[k.index[0]] = v
        else:
            scalar_items.append((_key_name(k), v))

    for name, comps in indexed.items():
        missing = set(range(len(comps))) - set(comps)
        if missing:
            raise ValueError(f"rhs_dict for {name} missing components "
                             f"{sorted(missing)}")

    def rhs(state, t=0.0, **args):
        env = {**args, **state, "t": t}
        out = {name: _field.evaluate(expr, env)
               for name, expr in scalar_items}
        for name, comps in indexed.items():
            ref = state[name]
            per_comp_shape = ref.shape[1:]
            vals = []
            for i in range(len(comps)):
                v = _field.evaluate(comps[i], env)
                if not isinstance(v, torch.Tensor):
                    v = torch.as_tensor(v, dtype=ref.dtype, device=ref.device)
                vals.append(torch.broadcast_to(v, per_comp_shape))
            out[name] = torch.stack(vals)
        return out

    return rhs


class Stepper:
    """Base class. Construct with a right-hand side (callable or symbolic
    dict) and call :meth:`step` (whole RK step) or the per-stage
    :meth:`__call__` for a reference-style stepping loop."""

    num_stages = NotImplemented
    expected_order = NotImplemented

    def __init__(self, rhs, dt=None, **kwargs):
        # ``kwargs``: the JAX package's stepper options (``donate``), taken
        # and ignored so that a constructor call written for it runs here;
        # PyTorch runs eagerly and donates nothing
        if isinstance(rhs, dict) and rhs and not callable(rhs):
            rhs = compile_rhs_dict(rhs)
        elif hasattr(rhs, "rhs_dict"):  # a Sector (or list of Sectors)
            rhs = compile_rhs_dict(rhs.rhs_dict)
        elif isinstance(rhs, (list, tuple)):
            merged = {}
            for sector in rhs:
                merged.update(sector.rhs_dict)
            rhs = compile_rhs_dict(merged)
        self.rhs = rhs
        self.dt = dt

    def _step_impl(self, state, t, dt, rhs_args):
        carry = self.init_carry(state)
        for s in range(self.num_stages):
            carry = self.stage(s, carry, t, dt, rhs_args)
        return self.extract(carry)

    # -- whole-step interface ---------------------------------------------

    def step(self, state, t=0.0, dt=None, rhs_args=None):
        """Advance ``state`` by one full RK step; returns the new state.
        The first call emits a ``kernel_tier`` event with tier ``"eager"``
        (the JAX package's generic stepper records ``"xla"``, its rung of
        the fused tiers' fallback ladder)."""
        dt = dt if dt is not None else self.dt
        if not getattr(self, "_tier_emitted", False):
            self._tier_emitted = True
            from pystella_tpu_torch.obs import events as _events
            _events.emit("kernel_tier", entrypoint="step", tier="eager",
                         label=type(self).__name__)
        return self._step_impl(state, t, dt, rhs_args or {})

    def step_with_health(self, state, sentinel, t=0.0, dt=None,
                         rhs_args=None, aux=None):
        """Like :meth:`step`, additionally returning ``sentinel``'s health
        vector of the NEW state (:mod:`pystella_tpu_torch.obs.sentinel`):
        K15 and its finish enqueued right behind the step's last launch,
        with no host sync. Hand the vector to ``SentinelMonitor.push`` and
        poll it later. ``aux`` (a dict of scalars, e.g. the expansion
        background) is forwarded to the sentinel's invariants. Returns
        ``(new_state, health_vector)``."""
        new = self.step(state, t, dt, rhs_args)
        return new, sentinel.compute_jit(new, aux)

    # -- ensemble (member-axis) interface ----------------------------------

    def multi_step_fn(self, nsteps):
        """A ``(state, t, dt, rhs_args) -> state`` function advancing
        ``nsteps`` full RK steps, the time argument advanced by ``dt`` per
        step: the single-member body of the ensemble tier. Fused steppers
        override it with their stage-paired chunk body; :meth:`batched`
        drives it over a batch of members."""
        nsteps = int(nsteps)

        def fn(state, t, dt, rhs_args):
            for i in range(nsteps):
                state = self._step_impl(state, t + i * dt, dt, rhs_args)
            return state
        return fn

    def on_device(self, device):
        """This stepper for member states on ``device``: the ensemble's map
        tier runs each slice's members through it. A generic stepper holds
        no device (its right-hand side follows its operands), so it is
        itself; the fused steppers return a twin bound to ``device``."""
        return self

    def batched(self, size, **kwargs):
        """An :class:`~pystella_tpu_torch.ensemble.EnsembleStepper` driving
        ``size`` members of this stepper as one batch (per-member t, dt and
        parameters as batched leaves; see :mod:`~pystella_tpu_torch.
        ensemble`)."""
        from pystella_tpu_torch.ensemble import EnsembleStepper
        return EnsembleStepper(self, size, **kwargs)

    # -- per-stage interface (reference-style stepping loops) --------------

    def __call__(self, stage, state_or_carry, t=0.0, dt=None, **rhs_args):
        """Run stage ``stage``. At stage 0 pass the state; afterwards pass
        the returned carry. After the last stage the return value is the new
        state."""
        dt = dt if dt is not None else self.dt
        carry = (self.init_carry(state_or_carry) if stage == 0
                 else state_or_carry)
        carry = self.stage(stage, carry, t, dt, rhs_args)
        if stage == self.num_stages - 1:
            return self.extract(carry)
        return carry

    def init_carry(self, state):
        raise NotImplementedError

    def stage(self, s, carry, t, dt, rhs_args):
        raise NotImplementedError

    def extract(self, carry):
        raise NotImplementedError

    def current(self, carry):
        """The stage-updated solution inside a mid-step carry (what callers
        should read between stages, e.g. for per-stage energy
        reductions)."""
        raise NotImplementedError


class RungeKuttaStepper(Stepper):
    """Classical explicit RK in the same bounded-copy formulation the
    reference uses (step.py:173-239): a carry of ``num_copies`` state copies
    ``q[0..]``, updated per stage by :meth:`step_statements`. ``q[0]`` is the
    solution, ``q[1]`` the stage input, ``q[2]`` (if present) the
    accumulator."""

    num_copies = NotImplemented

    def init_carry(self, state):
        return [state] * self.num_copies

    def extract(self, carry):
        return carry[0]

    def current(self, carry):
        return carry[1]

    #: per-stage evaluation point offsets (c values) for the time argument
    _c = None

    def stage(self, s, carry, t, dt, rhs_args):
        q = list(carry)
        c = self._c[s] if self._c is not None else 0.0
        y = q[0] if s == 0 else q[1]
        r = self.rhs(y, t + c * dt, **rhs_args)
        return self.step_statements(s, q, r, dt)

    def step_statements(self, s, q, r, dt):
        raise NotImplementedError


class RungeKutta4(RungeKuttaStepper):
    """Classical RK4 (reference step.py:242-265)."""

    num_stages, expected_order, num_copies = 4, 4, 3
    _c = [0, 1 / 2, 1 / 2, 1]

    def step_statements(self, s, q, r, dt):
        if s == 0:
            return [q[0], _axpy(1, q[0], dt / 2, r), _axpy(1, q[0], dt / 6, r)]
        if s == 1:
            return [q[0], _axpy(1, q[0], dt / 2, r), _axpy(1, q[2], dt / 3, r)]
        if s == 2:
            return [q[0], _axpy(1, q[0], dt, r), _axpy(1, q[2], dt / 3, r)]
        return [_axpy(1, q[2], dt / 6, r), q[1], q[2]]


class RungeKutta3Heun(RungeKuttaStepper):
    """Heun's RK3 (reference step.py:268-287)."""

    num_stages, expected_order, num_copies = 3, 3, 3
    _c = [0, 1 / 3, 2 / 3]

    def step_statements(self, s, q, r, dt):
        if s == 0:
            return [q[0], _axpy(1, q[0], dt / 3, r), _axpy(1, q[0], dt / 4, r)]
        if s == 1:
            return [q[0], _axpy(1, q[0], dt * 2 / 3, r), q[2]]
        return [_axpy(1, q[2], dt * 3 / 4, r), q[1], q[2]]


class RungeKutta3Nystrom(RungeKuttaStepper):
    """Nystrom's RK3 (reference step.py:290-310)."""

    num_stages, expected_order, num_copies = 3, 3, 3
    _c = [0, 2 / 3, 2 / 3]

    def step_statements(self, s, q, r, dt):
        if s == 0:
            return [q[0], _axpy(1, q[0], dt * 2 / 3, r),
                    _axpy(1, q[0], dt * 2 / 8, r)]
        if s == 1:
            return [q[0], _axpy(1, q[0], dt * 2 / 3, r),
                    _axpy(1, q[2], dt * 3 / 8, r)]
        return [_axpy(1, q[2], dt * 3 / 8, r), q[1], q[2]]


class RungeKutta3Ralston(RungeKuttaStepper):
    """Ralston's RK3 (reference step.py:313-333)."""

    num_stages, expected_order, num_copies = 3, 3, 3
    _c = [0, 1 / 2, 3 / 4]

    def step_statements(self, s, q, r, dt):
        if s == 0:
            return [q[0], _axpy(1, q[0], dt / 2, r),
                    _axpy(1, q[0], dt * 2 / 9, r)]
        if s == 1:
            return [q[0], _axpy(1, q[0], dt * 3 / 4, r),
                    _axpy(1, q[2], dt / 3, r)]
        return [_axpy(1, q[2], dt * 4 / 9, r), q[1], q[2]]


class RungeKutta3SSP(RungeKuttaStepper):
    """Third-order strong-stability-preserving RK (reference
    step.py:336-354)."""

    num_stages, expected_order, num_copies = 3, 3, 2
    _c = [0, 1, 1 / 2]

    def step_statements(self, s, q, r, dt):
        if s == 0:
            return [q[0], _axpy(1, q[0], dt, r)]
        if s == 1:
            return [q[0], _axpy(3 / 4, q[0],
                                1 / 4, _axpy(1, q[1], dt, r))]
        return [_axpy(1 / 3, q[0], 2 / 3, _axpy(1, q[1], dt, r)), q[1]]


class RungeKutta2Midpoint(RungeKuttaStepper):
    """Midpoint RK2 (reference step.py:357-375)."""

    num_stages, expected_order, num_copies = 2, 2, 2
    _c = [0, 1 / 2]

    def step_statements(self, s, q, r, dt):
        if s == 0:
            return [q[0], _axpy(1, q[0], dt / 2, r)]
        return [_axpy(1, q[0], dt, r), q[1]]


class RungeKutta2Heun(RungeKuttaStepper):
    """Heun's RK2 (reference step.py:379-391; may order-reduce)."""

    num_stages, expected_order, num_copies = 2, 2, 2
    _c = [0, 1]

    def step_statements(self, s, q, r, dt):
        if s == 0:
            return [_axpy(1, q[0], dt / 2, r), _axpy(1, q[0], dt, r)]
        return [_axpy(1, q[0], dt / 2, r), q[1]]


class RungeKutta2Ralston(RungeKuttaStepper):
    """Ralston's RK2 (reference step.py:394-411)."""

    num_stages, expected_order, num_copies = 2, 2, 2
    _c = [0, 2 / 3]

    def step_statements(self, s, q, r, dt):
        if s == 0:
            return [_axpy(1, q[0], dt / 4, r), _axpy(1, q[0], dt * 2 / 3, r)]
        return [_axpy(1, q[0], dt * 3 / 4, r), q[1]]


class LowStorageRKStepper(Stepper):
    """2N-storage RK (reference step.py:441-528): one auxiliary pytree ``k``;
    per stage ``k = A[s]*k + dt*rhs(y)``, ``y = y + B[s]*k``. The auxiliary
    allocation of ``get_tmp_arrays_like`` (step.py:493-517) becomes a
    ``tree_map(x * 0)`` in :meth:`init_carry`."""

    _A = []
    _B = []
    _C = []

    def init_carry(self, state):
        # x * 0 (not torch.zeros_like) keeps host scalars plain Python
        # numbers, so a scalar ODE integrates without touching a device
        k = _tree_map(lambda x: x * 0, state)
        return (state, k)

    def extract(self, carry):
        return carry[0]

    def current(self, carry):
        return carry[0]

    def stage(self, s, carry, t, dt, rhs_args):
        y, k = carry
        r = self.rhs(y, t + self._C[s] * dt, **rhs_args)
        k = _tree_map(
            lambda kk, rr: self._A[s] * kk + dt * rr, k, r)
        y = _tree_map(
            lambda yy, kk: yy + self._B[s] * kk, y, k)
        return (y, k)


class LowStorageRK54(LowStorageRKStepper):
    """Carpenter & Kennedy five-stage fourth-order 2N-storage RK
    (reference step.py:531-565)."""

    num_stages, expected_order = 5, 4
    _A = [0,
          -567301805773 / 1357537059087,
          -2404267990393 / 2016746695238,
          -3550918686646 / 2091501179385,
          -1275806237668 / 842570457699]
    _B = [1432997174477 / 9575080441755,
          5161836677717 / 13612068292357,
          1720146321549 / 2090206949498,
          3134564353537 / 4481467310338,
          2277821191437 / 14882151754819]
    _C = [0,
          1432997174477 / 9575080441755,
          2526269341429 / 6820363962896,
          2006345519317 / 3224310063776,
          2802321613138 / 2924317926251]


class LowStorageRK144(LowStorageRKStepper):
    """Niegemann et al. 14-stage fourth-order scheme optimized for elliptic
    stability regions (reference step.py:568-631)."""

    num_stages, expected_order = 14, 4
    _A = [0, -0.7188012108672410, -0.7785331173421570, -0.0053282796654044,
          -0.8552979934029281, -3.9564138245774565, -1.5780575380587385,
          -2.0837094552574054, -0.7483334182761610, -0.7032861106563359,
          0.0013917096117681, -0.0932075369637460, -0.9514200470875948,
          -7.1151571693922548]
    _B = [0.0367762454319673, 0.3136296607553959, 0.1531848691869027,
          0.0030097086818182, 0.3326293790646110, 0.2440251405350864,
          0.3718879239592277, 0.6204126221582444, 0.1524043173028741,
          0.0760894927419266, 0.0077604214040978, 0.0024647284755382,
          0.0780348340049386, 5.5059777270269628]
    _C = [0, 0.0367762454319673, 0.1249685262725025, 0.2446177702277698,
          0.2476149531070420, 0.2969311120382472, 0.3978149645802642,
          0.5270854589440328, 0.6981269994175695, 0.8190890835352128,
          0.8527059887098624, 0.8604711817462826, 0.8627060376969976,
          0.8734213127600976]


class LowStorageRK134(LowStorageRKStepper):
    """Niegemann et al. 13-stage fourth-order scheme optimized for circular
    stability regions (reference step.py:634-694)."""

    num_stages, expected_order = 13, 4
    _A = [0, 0.6160178650170565, 0.4449487060774118, 1.0952033345276178,
          1.2256030785959187, 0.2740182222332805, 0.0411952089052647,
          0.179708489915356, 1.1771530652064288, 0.4078831463120878,
          0.8295636426191777, 4.789597058425229, 0.6606671432964504]
    _B = [0.0271990297818803, 0.1772488819905108, 0.0378528418949694,
          0.6086431830142991, 0.21543139743161, 0.2066152563885843,
          0.0415864076069797, 0.0219891884310925, 0.9893081222650993,
          0.0063199019859826, 0.3749640721105318, 1.6080235151003195,
          0.0961209123818189]
    _C = [0, 0.0271990297818803, 0.0952594339119365, 0.1266450286591127,
          0.1825883045699772, 0.3737511439063931, 0.5301279418422206,
          0.5704177433952291, 0.5885784947099155, 0.6160769826246714,
          0.6223252334314046, 0.6897593128753419, 0.9126827615920843]


class LowStorageRK124(LowStorageRKStepper):
    """Niegemann et al. 12-stage fourth-order scheme optimized for inviscid
    problems (reference step.py:697-754)."""

    num_stages, expected_order = 12, 4
    _A = [0, 0.0923311242368072, 0.9441056581158819, 4.327127324757639,
          2.155777132902607, 0.9770727190189062, 0.7581835342571139,
          1.79775254708255, 2.691566797270077, 4.646679896026814,
          0.1539613783825189, 0.5943293901830616]
    _B = [0.0650008435125904, 0.0161459902249842, 0.5758627178358159,
          0.1649758848361671, 0.3934619494248182, 0.0443509641602719,
          0.2074504268408778, 0.6914247433015102, 0.3766646883450449,
          0.0757190350155483, 0.2027862031054088, 0.2167029365631842]
    _C = [0, 0.0650008435125904, 0.0796560563081853, 0.1620416710085376,
          0.2248877362907778, 0.2952293985641261, 0.3318332506149405,
          0.4094724050198658, 0.6356954475753369, 0.6806551557645497,
          0.714377371241835, 0.9032588871651854]


class LowStorageRK3Williamson(LowStorageRKStepper):
    """Williamson's three-stage third-order 2N-storage RK
    (reference step.py:757-773)."""

    num_stages, expected_order = 3, 3
    _A = [0, -5 / 9, -153 / 128]
    _B = [1 / 3, 15 / 16, 8 / 15]
    _C = [0, 4 / 9, 15 / 32]


class LowStorageRK3Inhomogeneous(LowStorageRKStepper):
    """Three-stage third-order 2N-storage RK (reference step.py:776-788)."""

    num_stages, expected_order = 3, 3
    _A = [0, -17 / 32, -32 / 27]
    _B = [1 / 4, 8 / 9, 3 / 4]
    _C = [0, 15 / 32, 4 / 9]


class LowStorageRK3Symmetric(LowStorageRKStepper):
    """Reference step.py:792-800 (may order-reduce)."""

    num_stages, expected_order = 3, 3
    _A = [0, -2 / 3, -1]
    _B = [1 / 3, 1, 1 / 2]
    _C = [0, 1 / 3, 2 / 3]


class LowStorageRK3PredictorCorrector(LowStorageRKStepper):
    """Reference step.py:804-812 (may order-reduce)."""

    num_stages, expected_order = 3, 3
    _A = [0, -1 / 4, -4 / 3]
    _B = [1 / 2, 2 / 3, 1 / 2]
    _C = [0, 1 / 2, 1]


def _rk3ssp_coefficients():
    # computed coefficients of the SSP scheme (reference step.py:815-830)
    c2 = .924574
    z1 = np.sqrt(36 * c2**4 + 36 * c2**3 - 135 * c2**2 + 84 * c2 - 12)
    z2 = 2 * c2**2 + c2 - 2
    z3 = 12 * c2**4 - 18 * c2**3 + 18 * c2**2 - 11 * c2 + 2
    z4 = 36 * c2**4 - 36 * c2**3 + 13 * c2**2 - 8 * c2 + 4
    z5 = 69 * c2**3 - 62 * c2**2 + 28 * c2 - 8
    z6 = 34 * c2**4 - 46 * c2**3 + 34 * c2**2 - 13 * c2 + 2
    b1 = c2
    b2 = ((12 * c2 * (c2 - 1) * (3 * z2 - z1) - (3 * z2 - z1)**2)
          / (144 * c2 * (3 * c2 - 2) * (c2 - 1)**2))
    b3 = (- 24 * (3 * c2 - 2) * (c2 - 1)**2
          / ((3 * z2 - z1)**2 - 12 * c2 * (c2 - 1) * (3 * z2 - z1)))
    a2 = ((- z1 * (6 * c2**2 - 4 * c2 + 1) + 3 * z3)
          / ((2 * c2 + 1) * z1 - 3 * (c2 + 2) * (2 * c2 - 1)**2))
    a3 = ((- z4 * z1 + 108 * (2 * c2 - 1) * c2**5 - 3 * (2 * c2 - 1) * z5)
          / (24 * z1 * c2 * (c2 - 1)**4 + 72 * c2 * z6
             + 72 * c2**6 * (2 * c2 - 13)))
    return a2, a3, b1, b2, b3


_a2, _a3, _b1, _b2, _b3 = _rk3ssp_coefficients()


class LowStorageRK3SSP(LowStorageRKStepper):
    """Three-stage third-order strong-stability-preserving 2N-storage RK
    (reference step.py:833-846)."""

    num_stages, expected_order = 3, 3
    _A = [0, _a2, _a3]
    _B = [_b1, _b2, _b3]
    _C = [0, _b1, _b1 + _b2 * (_a2 + 1)]


#: the reference's exported stepper list (step.py:849-853)
all_steppers = [RungeKutta4, RungeKutta3SSP, RungeKutta3Heun,
                RungeKutta3Nystrom, RungeKutta3Ralston, RungeKutta2Midpoint,
                RungeKutta2Ralston, LowStorageRK54, LowStorageRK144,
                LowStorageRK3Williamson, LowStorageRK3Inhomogeneous,
                LowStorageRK3SSP]
