"""The port's Runge-Kutta steppers against the JAX package's: equal
tableaus, the same wave-equation step, and the convergence orders of
tests/test_step.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pystella_tpu as ps
import pystella_tpu_torch as pt
from pystella_tpu import step as jstep
from pystella_tpu_torch import step as tstep

LOW_STORAGE = [n for n in tstep.__all__ if n.startswith("LowStorageRK")
               and n != "LowStorageRKStepper"]
CLASSICAL = [n for n in tstep.__all__ if n.startswith("RungeKutta")
             and n != "RungeKuttaStepper"]


@pytest.mark.parametrize("name", LOW_STORAGE)
def test_low_storage_tableau_equal(name):
    jc, tc = getattr(jstep, name), getattr(tstep, name)
    assert (tc._A, tc._B, tc._C) == (jc._A, jc._B, jc._C)
    assert (tc.num_stages, tc.expected_order) == \
        (jc.num_stages, jc.expected_order)


@pytest.mark.parametrize("name", CLASSICAL)
def test_classical_tableau_equal(name):
    jc, tc = getattr(jstep, name), getattr(tstep, name)
    assert tc._c == jc._c
    assert (tc.num_stages, tc.expected_order, tc.num_copies) == \
        (jc.num_stages, jc.expected_order, jc.num_copies)


def test_all_steppers_mirror_jax():
    assert [c.__name__ for c in tstep.all_steppers] == \
        [c.__name__ for c in jstep.all_steppers]


def exact_solution(n, t, y0=1.0):
    if n == 1:
        return y0 * np.exp(t)
    return (y0 ** (1 - n) - (n - 1) * t) ** (1 / (1 - n))


@pytest.mark.parametrize("stepper_cls", tstep.all_steppers)
@pytest.mark.parametrize("n", [2, 3])
def test_convergence_order(stepper_cls, n):
    """tests/test_step.py's check, on the port (host scalars)."""
    def rhs(state, t):
        return {"y": state["y"] ** n}

    stepper = stepper_cls(rhs)
    t_end = 0.4
    errors, dts = [], []
    for m in (10, 20, 40, 80):
        dt = t_end / m
        state = {"y": 1.0}
        t = 0.0
        for _ in range(m):
            state = stepper.step(state, t, dt)
            t += dt
        errors.append(abs(float(state["y"]) - exact_solution(n, t_end)))
        dts.append(dt)

    tol = {2: 5e-3, 3: 1e-4, 4: 1e-7}[stepper_cls.expected_order]
    assert errors[-1] < tol, f"{stepper_cls.__name__}: err {errors[-1]}"
    order = np.log(errors[-2] / errors[-1]) / np.log(dts[-2] / dts[-1])
    assert order > 0.9 * stepper_cls.expected_order


def test_per_stage_interface_matches_step():
    stepper = pt.LowStorageRK54(lambda s, t: {"y": s["y"] ** 2}, dt=0.01)
    whole = stepper.step({"y": 1.0}, 0.0, 0.01)
    carry = {"y": 1.0}
    for s in range(stepper.num_stages):
        carry = stepper(s, carry, 0.0)
    assert np.isclose(whole["y"], carry["y"], rtol=1e-14)


def test_symbolic_rhs_dict():
    y = pt.Field("y")
    stepper = pt.RungeKutta4({y: y ** 2})
    state = {"y": torch.tensor(1.0, dtype=torch.float64)}
    t, dt = 0.0, 0.01
    for _ in range(50):
        state = stepper.step(state, t, dt)
        t += dt
    assert np.isclose(float(state["y"]), exact_solution(2, t), rtol=1e-8)


def test_wave_equation_step_matches_jax():
    """Port LowStorageRK54 + roll-mode Laplacian vs the JAX package's
    LowStorageRK54 + FiniteDifferencer(mode="roll"): one 16^3 f64 step
    of the wave equation, to 1e-12 relative."""
    grid_shape, h, dx, dt = (16, 16, 16), 2, (0.3, 0.25, 0.2), 0.02
    rng = np.random.default_rng(21)
    f0 = rng.standard_normal(grid_shape)
    df0 = rng.standard_normal(grid_shape)

    decomp = ps.DomainDecomposition((1, 1, 1), devices=jax.devices()[:1])
    fdj = ps.FiniteDifferencer(decomp, h, dx, mode="roll")
    jst = ps.LowStorageRK54(
        lambda s, t: {"f": s["dfdt"], "dfdt": fdj.lap(s["f"])}, dt=dt)
    ref = jst.step({"f": jnp.asarray(f0), "dfdt": jnp.asarray(df0)}, 0.0, dt)

    fdt = pt.FiniteDifferencer(h, dx, device="cpu")
    tst = pt.LowStorageRK54(
        lambda s, t: {"f": s["dfdt"], "dfdt": fdt.lap(s["f"])}, dt=dt)
    got = tst.step({"f": torch.tensor(f0), "dfdt": torch.tensor(df0)},
                   0.0, dt)
    for k in ("f", "dfdt"):
        r = np.asarray(ref[k])
        err = np.max(np.abs(got[k].numpy() - r)) / np.max(np.abs(r))
        assert err < 1e-12, f"{k}: rel err {err}"


def test_sector_rhs_dict_steps_like_jax():
    """ScalarSector's symbolic right-hand side, compiled by each package's
    compile_rhs_dict, gives the same step."""
    def potential(f):
        return 0.5 * 1.2e-2 * f[0] ** 2 + 0.125 * f[0] ** 2 * f[1] ** 2

    grid_shape, h, dx, dt = (8, 8, 8), 1, 0.3, 0.01
    rng = np.random.default_rng(4)
    f0 = rng.standard_normal((2,) + grid_shape)
    df0 = 0.1 * rng.standard_normal((2,) + grid_shape)
    args = {"a": 1.3, "hubble": 0.21}

    decomp = ps.DomainDecomposition((1, 1, 1), devices=jax.devices()[:1])
    fdj = ps.FiniteDifferencer(decomp, h, dx, mode="roll")
    rj = ps.compile_rhs_dict(ps.ScalarSector(2, potential=potential).rhs_dict)
    jst = ps.LowStorageRK54(
        lambda s, t, a, hubble: rj(s, t, lap_f=fdj.lap(s["f"]), a=a,
                                   hubble=hubble), dt=dt)
    ref = jst.step({"f": jnp.asarray(f0), "dfdt": jnp.asarray(df0)},
                   0.0, dt, args)

    fdt = pt.FiniteDifferencer(h, dx, device="cpu")
    rt = pt.compile_rhs_dict(pt.ScalarSector(2, potential=potential).rhs_dict)
    tst = pt.LowStorageRK54(
        lambda s, t, a, hubble: rt(s, t, lap_f=fdt.lap(s["f"]), a=a,
                                   hubble=hubble), dt=dt)
    got = tst.step({"f": torch.tensor(f0), "dfdt": torch.tensor(df0)},
                   0.0, dt, args)
    for k in ("f", "dfdt"):
        r = np.asarray(ref[k])
        err = np.max(np.abs(got[k].numpy() - r)) / np.max(np.abs(r))
        assert err < 1e-12, f"{k}: rel err {err}"


def test_sector_reducers_and_rho_p_match_jax():
    """ScalarSector.reducers evaluated on the same arrays, their lattice
    means through get_rho_and_p, and tensor_index: equal to the JAX
    package's."""
    def potential(f):
        return 0.5 * 1.2e-2 * f[0] ** 2 + 0.125 * f[0] ** 2 * f[1] ** 2

    rng = np.random.default_rng(8)
    arrs = {n: rng.standard_normal((2, 6, 6, 6))
            for n in ("f", "dfdt", "lap_f")}
    energies = []
    for mod, conv in ((ps, jnp.asarray), (pt, torch.tensor)):
        env = {**{n: conv(v) for n, v in arrs.items()}, "a": 1.3}
        reducers = mod.ScalarSector(2, potential=potential).reducers
        energies.append(mod.get_rho_and_p(
            {k: np.array([float(np.mean(np.asarray(mod.evaluate(e, env))))
                          for e in exprs]) for k, exprs in reducers.items()}))
    ej, et = energies
    assert ej.keys() == et.keys()
    for k in ej:
        np.testing.assert_allclose(et[k], ej[k], rtol=1e-14, atol=0)
    assert [pt.tensor_index(i, j) for i in (1, 2, 3) for j in (1, 2, 3)] \
        == [ps.tensor_index(i, j) for i in (1, 2, 3) for j in (1, 2, 3)]
