"""The port's FusedScalarStepper against the JAX package's, against its own
generic path. (The CUDA kernels' own tests, which need the card, are in
tests/test_torch_kernels.py.)

The JAX fused stepper runs its Pallas kernels in interpret mode here, about
5 s per jitted call at 16^3, so its results are computed once per module
(four calls) and every comparison reads them."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pystella_tpu as ps
import pystella_tpu_torch as pt
from pystella_tpu.ops.fused import FusedScalarStepper as JaxFused

GRID, H, DX, DT = (16, 16, 16), 2, (0.3, 0.25, 0.2), 0.01
ARGS = {"a": 1.3, "hubble": 0.21}
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def fused_test_potential(f):
    # tests/test_fused.py's potential
    return 0.5 * 1.2e-2 * f[0] ** 2 + 0.125 * f[0] ** 2 * f[1] ** 2


def bench_potential(f):
    # the preheating model of bench.py:build_preheat_step
    mphi, gsq = 1.20e-6, 2.5e-7
    phi, chi = f[0], f[1]
    return (mphi**2 / 2 * phi**2 + gsq / 2 * phi**2 * chi**2) / mphi**2


def _state(seed, famp=1.0, dfamp=0.1, grid=GRID, dtype=np.float64):
    rng = np.random.default_rng(seed)
    return {"f": (famp * rng.standard_normal((2,) + grid)).astype(dtype),
            "dfdt": (dfamp * rng.standard_normal((2,) + grid)).astype(dtype)}


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.max(np.abs(got - ref)) / np.max(np.abs(ref))


def _port(potential=fused_test_potential, dtype=torch.float64, **kw):
    return pt.FusedScalarStepper(pt.ScalarSector(2, potential=potential),
                                 GRID, DX, H, dtype=dtype, device="cpu", **kw)


def _copy(state):
    return {k: v.clone() for k, v in state.items()}


@pytest.fixture(scope="module")
def jax_ref():
    """JAX FusedScalarStepper results (interpret mode, bx=4, by=8, as
    tests/test_fused.py builds it): f64 step and multi_step(2, 3) on the
    test_fused potential, and an f32 step of the bench model."""
    decomp = ps.DomainDecomposition((1, 1, 1), devices=jax.devices()[:1])
    out = {}
    st64 = _state(11)
    fused = JaxFused(ps.ScalarSector(2, potential=fused_test_potential),
                     decomp, GRID, DX, H, dtype=jnp.float64, bx=4, by=8)
    out["step"] = fused.step({k: jnp.asarray(v) for k, v in st64.items()},
                             0.0, DT, ARGS)
    for n in (2, 3):
        out[f"multi{n}"] = fused.multi_step(
            {k: jnp.asarray(v) for k, v in st64.items()}, n, 0.0, DT, ARGS)
    st32 = _state(7, 1e-3, 1e-4, dtype=np.float32)
    fused32 = JaxFused(ps.ScalarSector(2, potential=bench_potential),
                       decomp, GRID, DX, H, dtype=jnp.float32, bx=4, by=8)
    out["step32"] = fused32.step({k: jnp.asarray(v) for k, v in st32.items()},
                                 0.0, np.float32(DT),
                                 {"a": np.float32(1.0),
                                  "hubble": np.float32(0.5)})
    return {k: {n: np.asarray(a) for n, a in v.items()}
            for k, v in out.items()}


@pytest.mark.parametrize("how", ["step", "multi2", "multi3"])
def test_matches_jax_fused_f64(jax_ref, how):
    """(a) step() and multi_step with nsteps 2 and 3 (the odd tail) vs the
    JAX fused stepper, f64, to 1e-12 relative: the two packages round the
    same operations but XLA may contract or reorder a few."""
    st = _port()
    state = pt.state_from_numpy(_state(11), device="cpu")
    if how == "step":
        got = st.step(state, 0.0, DT, ARGS)
    else:
        got = st.multi_step(state, int(how[-1]), 0.0, DT, ARGS)
    for name in ("f", "dfdt"):
        err = _rel(got[name], jax_ref[how][name])
        assert err < 1e-12, f"{how} {name}: rel err {err}"


def test_matches_jax_fused_f32(jax_ref):
    """(a) f32 step() of the bench model vs the JAX fused stepper. Each of
    the 5 stages rounds ~30 operations per site in f32 (unit roundoff
    6e-8); holding the difference to 2e-6 relative to the largest value
    allows a few ulp per stage where the two packages round differently."""
    st = _port(bench_potential, torch.float32)
    state = pt.state_from_numpy(_state(7, 1e-3, 1e-4, dtype=np.float32),
                                device="cpu")
    got = st.step(state, 0.0, DT, {"a": 1.0, "hubble": 0.5})
    for name in ("f", "dfdt"):
        assert got[name].dtype == torch.float32
        err = _rel(got[name], jax_ref["step32"][name])
        assert err < 2e-6, f"{name}: rel err {err}"


@pytest.mark.parametrize("potential", [fused_test_potential, bench_potential])
def test_pair_equals_two_singles(potential):
    """(b) The plain pair body keeps the arithmetic of two single stages
    (the stage-2 Laplacian recomposes f1 at every tap): 1e-14 relative."""
    paired = _port(potential)
    single = _port(potential, pair_stages=False)
    state = pt.state_from_numpy(_state(11), device="cpu")
    got = paired.step(_copy(state), 0.0, DT, ARGS)
    ref = single.step(_copy(state), 0.0, DT, ARGS)
    for name in ("f", "dfdt"):
        assert _rel(got[name], ref[name]) < 1e-14


@pytest.mark.parametrize("nsteps", [2, 3])
def test_multi_step_matches_sequential_steps(nsteps):
    st = _port()
    state = pt.state_from_numpy(_state(13), device="cpu")
    ref = _copy(state)
    for _ in range(nsteps):
        ref = _copy(st.step(ref, 0.0, DT, ARGS))
    got = st.multi_step(_copy(state), nsteps, 0.0, DT, ARGS)
    for name in ("f", "dfdt"):
        assert _rel(got[name], ref[name]) < 1e-14


def test_multi_step_launch_schedule():
    """Cross-boundary pairing: RK54 runs ceil(5n/2) pair stages and one
    trailing single stage only for odd n; step() runs 2 pairs + 1 single."""
    st = _port()
    calls = []
    st.stage = lambda s, c, *a, **k: calls.append(("stage", s)) or c
    st.stage_pair = (lambda s, c, *a, s2=None, **k:
                     calls.append(("pair", s, s2)) or c)
    state = pt.state_from_numpy(_state(1), device="cpu")
    st.multi_step(state, 2, 0.0, DT, ARGS)
    assert calls == [("pair", 0, 1), ("pair", 2, 3), ("pair", 4, 0),
                     ("pair", 1, 2), ("pair", 3, 4)]
    calls.clear()
    st.multi_step(state, 3, 0.0, DT, ARGS)
    assert [c[0] for c in calls] == ["pair"] * 7 + ["stage"]
    assert calls[-1] == ("stage", 4)
    calls.clear()
    st.step(state, 0.0, DT, ARGS)
    assert calls == [("pair", 0, None), ("pair", 2, None), ("stage", 4)]


def test_wrapped_pair_needs_zero_A():
    class Tableau(pt.LowStorageRK54):
        _A = [0.5] + pt.LowStorageRK54._A[1:]

    st = _port(tableau=Tableau)
    carry = st.init_carry(pt.state_from_numpy(_state(2), device="cpu"))
    with pytest.raises(ValueError, match="A\\[0\\] == 0"):
        st.stage_pair(4, carry, 0.0, DT, ARGS, s2=0)
    # multi_step then steps sequentially, resetting k at every step
    state = pt.state_from_numpy(_state(2), device="cpu")
    ref = _copy(state)
    for _ in range(2):
        ref = _copy(st.step(ref, 0.0, DT, ARGS))
    got = st.multi_step(_copy(state), 2, 0.0, DT, ARGS)
    for name in ("f", "dfdt"):
        assert _rel(got[name], ref[name]) < 1e-14
    with pytest.raises(RuntimeError):
        _port(pair_stages=False).stage_pair(0, carry, 0.0, DT, ARGS)


def test_rhs_seq_matches_per_stage_loop():
    st = _port()
    n = 2
    a = 1 + 0.01 * np.arange(5 * n)
    hub = 0.2 + 0.003 * np.arange(5 * n)
    state = pt.state_from_numpy(_state(5), device="cpu")
    # clone: the loop below reuses the stepper's buffers
    got = _copy(st.multi_step(_copy(state), n, 0.0, DT, {},
                              {"a": a, "hubble": hub}))
    carry = st.init_carry(_copy(state))
    for i in range(5 * n):
        carry = st.stage(i % 5, carry, 0.0, DT,
                         {"a": a[i], "hubble": hub[i]})
    for name in ("f", "dfdt"):
        assert _rel(got[name], carry[0][name]) < 1e-14
    with pytest.raises(ValueError, match="one per stage"):
        st.multi_step(state, n, 0.0, DT, {}, {"a": a[:3]})


@pytest.mark.parametrize("potential", [fused_test_potential, bench_potential,
                                       lambda f: 0],
                         ids=["fused_test", "bench", "zero"])
def test_fused_matches_generic(potential):
    """(c) The fused stepper vs the port's generic LowStorageRK54 +
    FiniteDifferencer.lap on the sector's rhs_dict (a different summation
    order for the Laplacian): 1e-12 relative over two steps. The zero
    potential covers a dV/df that does not depend on f."""
    st = _port(potential)
    sector = pt.ScalarSector(2, potential=potential)
    fd = pt.FiniteDifferencer(H, DX, device="cpu")
    rhs = pt.compile_rhs_dict(sector.rhs_dict)
    gen = pt.LowStorageRK54(
        lambda s, t, a, hubble: rhs(s, t, lap_f=fd.lap(s["f"]), a=a,
                                    hubble=hubble), dt=DT)
    state = pt.state_from_numpy(_state(17), device="cpu")
    ref = _copy(state)
    for _ in range(2):
        ref = gen.step(ref, 0.0, DT, ARGS)
    got = st.multi_step(_copy(state), 2, 0.0, DT, ARGS)
    for name in ("f", "dfdt"):
        assert _rel(got[name], ref[name]) < 1e-12, name


def test_buffers_never_alias_inputs():
    """Each launch writes a buffer set disjoint from its inputs, and
    repeated calls on the stepper's own outputs stay correct."""
    st = _port()
    state = pt.state_from_numpy(_state(3), device="cpu")
    ref = _copy(state)
    for _ in range(3):
        ref = _copy(st.step(ref, 0.0, DT, ARGS))
    got = state
    for _ in range(3):
        got = st.step(got, 0.0, DT, ARGS)  # stepper buffers in, buffers out
    for name in ("f", "dfdt"):
        assert _rel(got[name], ref[name]) < 1e-14


def test_state_device_must_match():
    st = _port()
    state = {k: v.to("meta") for k, v in
             pt.state_from_numpy(_state(3), device="cpu").items()}
    with pytest.raises(ValueError, match="runs on cpu"):
        st.step(state, 0.0, DT, ARGS)


def test_convert_round_trip():
    s = _state(6)
    t = pt.state_from_numpy(s, device="cpu", dtype=np.float32)
    assert t["f"].dtype == torch.float32 and t["f"].device.type == "cpu"
    state, k = pt.carry_from_numpy((s, s), device="cpu")
    back = pt.to_numpy((state, k))
    np.testing.assert_array_equal(back[0]["f"], s["f"])
    np.testing.assert_array_equal(back[1]["dfdt"], s["dfdt"])


def test_import_pulls_in_no_jax():
    """(e) The port imports neither jax nor any pystella_tpu module."""
    code = ("import sys, pystella_tpu_torch\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'pystella_tpu' or "
            "m.startswith('pystella_tpu.')]\n"
            "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                         capture_output=True, text=True)
    assert out.stdout.strip() == "[]", out.stdout


def test_default_device_is_cuda(monkeypatch):
    """(f) Without CUDA and without device=, construction raises instead of
    running on the CPU; device='cpu' is the explicit opt-in."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sector = pt.ScalarSector(2, potential=bench_potential)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pt.FusedScalarStepper(sector, GRID, DX, H)
    with pytest.raises(RuntimeError):
        pt.state_from_numpy(_state(1))
    with pytest.raises(RuntimeError):
        pt.Lattice(GRID).coords(0)
    assert pt.resolve_device("cpu").type == "cpu"
    assert pt.FusedScalarStepper(sector, GRID, DX, H,
                                 device="cpu").device.type == "cpu"
