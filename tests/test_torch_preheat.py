"""The port's gravitational-wave system -- ``TensorPerturbationSector`` and
``FusedPreheatStepper`` -- against the JAX package's, and the port's fused
stepper against its own generic path. (The CUDA kernels themselves, K7, K8,
K5' and K9, are held to the plain versions on the card, in
tests/test_torch_kernels.py; the coupled driver is in
tests/test_torch_preheat_coupled.py.)

The JAX fused stepper runs its Pallas kernels in interpret mode here, about
12 s per GW step at 16^3, so its two results are computed once per module
and every comparison reads them."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pystella_tpu as ps
import pystella_tpu_torch as pt
from pystella_tpu.field import evaluate as jax_evaluate
from pystella_tpu.ops.fused import FusedPreheatStepper as JaxPreheat
from pystella_tpu_torch.ops import fused as tfused

GRID, H, DX, DT = (16, 16, 16), 2, 0.3, 0.01
NAMES = ("f", "dfdt", "hij", "dhijdt")


def fused_test_potential(f):
    # tests/test_fused.py's potential
    return 0.5 * 1.2e-2 * f[0] ** 2 + 0.125 * f[0] ** 2 * f[1] ** 2


def _state(seed, dtype=np.float64):
    # the states of tests/test_fused.py:494-501 (seed 12) and :614-619
    # (seed 7)
    rng = np.random.default_rng(seed)
    return {"f": rng.standard_normal((2,) + GRID).astype(dtype),
            "dfdt": (0.1 * rng.standard_normal((2,) + GRID)).astype(dtype),
            "hij": (1e-3 * rng.standard_normal((6,) + GRID)).astype(dtype),
            "dhijdt": (1e-4 * rng.standard_normal((6,) + GRID)).astype(
                dtype)}


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.max(np.abs(got - ref)) / np.max(np.abs(ref))


def _port(potential=fused_test_potential, dtype=torch.float64, **kw):
    sector = pt.ScalarSector(2, potential=potential)
    return pt.FusedPreheatStepper(sector, pt.TensorPerturbationSector(
        [sector]), GRID, DX, H, dtype=dtype, device="cpu", **kw)


def _copy(state):
    return {k: v.clone() for k, v in state.items()}


def _decomp():
    return ps.DomainDecomposition((1, 1, 1), devices=jax.devices()[:1])


@pytest.fixture(scope="module")
def jax_ref():
    """JAX FusedPreheatStepper steps (interpret mode, bx=4, by=8, pairing
    on, as tests/test_fused.py builds it): f64 on the seed-12 state of
    tests/test_fused.py:494, and f32 on the seed-7 state."""
    decomp = _decomp()
    sector = ps.ScalarSector(2, potential=fused_test_potential)
    gw = ps.TensorPerturbationSector([sector])
    out = {}
    for dtype, seed, args in ((np.float64, 12, {"a": 1.3, "hubble": 0.21}),
                              (np.float32, 7, {"a": 1.1, "hubble": 0.13})):
        fused = JaxPreheat(sector, gw, decomp, GRID, DX, H,
                           dtype=jnp.dtype(dtype), bx=4, by=8)
        assert fused._pair_call is not None
        res = fused.step({k: jnp.asarray(v)
                          for k, v in _state(seed, dtype).items()},
                         0.0, dtype(DT),
                         {k: dtype(v) for k, v in args.items()})
        out[np.dtype(dtype).name] = ({k: np.asarray(v)
                                      for k, v in res.items()}, seed, args)
    return out


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_step_matches_jax(jax_ref, dtype):
    """The port's FusedPreheatStepper.step (two pairs and a single stage,
    plain versions here) against the JAX one on the same state: 1e-12
    (f64) and 1e-6 (f32) of each output's largest value."""
    ref, seed, args = jax_ref[dtype]
    tdtype = getattr(torch, dtype)
    st = _port(dtype=tdtype)
    got = st.step(pt.state_from_numpy(_state(seed, np.dtype(dtype)),
                                      device="cpu"), 0.0, DT, args)
    tol = {"float64": 1e-12, "float32": 1e-6}[dtype]
    for name in NAMES:
        assert got[name].dtype == tdtype
        err = _rel(got[name], ref[name])
        assert err <= tol, f"{name}: rel err {err}"


def _jax_generic_gw_step(state, args):
    """The generic scalar + GW step of tests/test_fused.py:41-61
    (_generic_step(..., gravitational_waves=True))."""
    decomp = _decomp()
    derivs = ps.FiniteDifferencer(decomp, H, (DX,) * 3, mode="halo")
    sector = ps.ScalarSector(2, potential=fused_test_potential)
    merged = {}
    for s in (sector, ps.TensorPerturbationSector([sector])):
        merged.update(s.rhs_dict)
    rhs = ps.compile_rhs_dict(merged)

    def full_rhs(st, t, a, hubble):
        return rhs(st, t, lap_f=derivs.lap(st["f"]), a=a, hubble=hubble,
                   dfdx=derivs.grad(st["f"]),
                   lap_hij=derivs.lap(st["hij"]))
    stepper = ps.LowStorageRK54(full_rhs, dt=DT)
    out = stepper.step({k: jnp.asarray(v) for k, v in state.items()}, 0.0,
                       DT, args)
    return {k: np.asarray(v) for k, v in out.items()}


def _port_generic_stepper(potential=fused_test_potential):
    """The port's generic scalar + GW stepper: the merged rhs_dict with
    dfdx from FiniteDifferencer.grad and lap_hij from lap."""
    sector = pt.ScalarSector(2, potential=potential)
    merged = {}
    for s in (sector, pt.TensorPerturbationSector([sector])):
        merged.update(s.rhs_dict)
    rhs = pt.compile_rhs_dict(merged)
    fd = pt.FiniteDifferencer(H, DX, device="cpu")
    return pt.LowStorageRK54(
        lambda s, t, a, hubble: rhs(s, t, lap_f=fd.lap(s["f"]),
                                    dfdx=fd.grad(s["f"]),
                                    lap_hij=fd.lap(s["hij"]), a=a,
                                    hubble=hubble))


def test_generic_step_matches_jax():
    """The port's generic GW step (the fused stepper's reference path)
    against the JAX package's _generic_step with gravitational waves:
    1e-12 in f64."""
    args = {"a": 1.1, "hubble": 0.13}
    state = _state(7)
    ref = _jax_generic_gw_step(state, args)
    got = _port_generic_stepper().step(
        pt.state_from_numpy(state, device="cpu"), 0.0, DT, args)
    for name in NAMES:
        assert _rel(got[name], ref[name]) <= 1e-12, name


@pytest.mark.parametrize("nsteps", [1, 3])
def test_fused_matches_generic(nsteps):
    """The port's fused multi_step against its generic GW stepper (the
    bar of tests/test_fused.py:634): 1e-11."""
    args = {"a": 1.1, "hubble": 0.13}
    state = pt.state_from_numpy(_state(7), device="cpu")
    gen = _port_generic_stepper()
    ref = state
    for _ in range(nsteps):
        ref = gen.step(ref, 0.0, DT, args)
    got = _port().multi_step(_copy(state), nsteps, 0.0, DT, args)
    for name in NAMES:
        assert _rel(got[name], ref[name]) <= 1e-11, name


@pytest.mark.parametrize("nsteps", [1, 2])
def test_pair_matches_single(nsteps):
    """Pairing (K8 plain version) against single stages (K7): the same
    operations in the same order, so 1e-14 in f64 (bitwise in practice)."""
    args = {"a": 1.3, "hubble": 0.21}
    state = pt.state_from_numpy(_state(12), device="cpu")
    got = _port().multi_step(_copy(state), nsteps, 0.0, DT, args)
    ref = _port(pair_stages=False).multi_step(_copy(state), nsteps, 0.0, DT,
                                              args)
    for name in NAMES:
        assert _rel(got[name], ref[name]) <= 1e-14, name


def _env(seed=31):
    rng = np.random.default_rng(seed)
    return {"f": rng.standard_normal((2,) + GRID),
            "dfdt": rng.standard_normal((2,) + GRID),
            "lap_f": rng.standard_normal((2,) + GRID),
            "dfdx": rng.standard_normal((2, 3) + GRID),
            "hij": rng.standard_normal((6,) + GRID),
            "dhijdt": rng.standard_normal((6,) + GRID),
            "lap_hij": rng.standard_normal((6,) + GRID),
            "a": 1.3, "hubble": 0.7}


@pytest.mark.parametrize("mu,nu,drop", [(0, 0, False), (1, 2, True),
                                        (3, 3, False), (2, 2, True)])
def test_stress_tensor_matches_jax(mu, nu, drop):
    """ScalarSector.stress_tensor evaluated on the same arrays in both
    packages: 1e-15 (the same expression tree, evaluated in the same
    order)."""
    def potential(f):
        return 0.5 * f[0] ** 2 + 0.25 * f[1] ** 4 + 0.1 * f[0] ** 2 * f[1] ** 2
    env = _env()
    ref = np.asarray(jax_evaluate(ps.ScalarSector(
        2, potential=potential).stress_tensor(mu, nu, drop_trace=drop),
        {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
         for k, v in env.items()}))
    got = pt.evaluate(pt.ScalarSector(2, potential=potential).stress_tensor(
        mu, nu, drop_trace=drop), pt.state_from_numpy(
            {k: v for k, v in env.items() if isinstance(v, np.ndarray)},
            device="cpu") | {"a": env["a"], "hubble": env["hubble"]})
    assert _rel(got, ref) <= 1e-15


def test_tensor_perturbation_rhs_matches_jax():
    """TensorPerturbationSector.rhs_dict, compiled and evaluated in both
    packages on the same arrays: 1e-15."""
    env = _env(32)
    state = {"hij": env["hij"], "dhijdt": env["dhijdt"]}
    aux = {k: env[k] for k in ("lap_hij", "dfdx", "dfdt", "f", "a",
                               "hubble")}
    jgw = ps.TensorPerturbationSector(
        [ps.ScalarSector(2, potential=fused_test_potential)])
    ref = ps.compile_rhs_dict(jgw.rhs_dict)(
        {k: jnp.asarray(v) for k, v in state.items()}, 0.0,
        **{k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
           for k, v in aux.items()})
    tgw = pt.TensorPerturbationSector(
        [pt.ScalarSector(2, potential=fused_test_potential)])
    assert len(tgw.rhs_dict) == 12
    got = pt.compile_rhs_dict(tgw.rhs_dict)(
        pt.state_from_numpy(state, device="cpu"), 0.0,
        **{k: (torch.tensor(v) if isinstance(v, np.ndarray) else v)
           for k, v in aux.items()})
    for name in ("hij", "dhijdt"):
        assert _rel(got[name], ref[name]) <= 1e-15, name


class _HubbleStressSector(pt.ScalarSector):
    """A sector whose anisotropic stress reads the Hubble rate."""

    def stress_tensor(self, mu, nu, drop_trace=False):
        return pt.Var("hubble") * super().stress_tensor(mu, nu, drop_trace)


def test_header_and_hubble_gate():
    """The generated header prints PK_NH, the 16 pi source coefficient and
    pk_sij (and its no-hubble twin for a hubble-free model); an S_ij or a
    potential that reads hubble leaves the _nohub functions and K9 out.
    The scalar stepper's header has none of it."""
    st = _port()
    header = st.kernel_header()
    assert "#define PK_NH 6" in header
    assert f"#define PK_GW_COEF {16 * np.pi!r}" in header
    assert "pk_sij(" in header and "pk_sij_nohub(" in header
    assert "dfdx[1][2]" in header
    assert st.coupled_pair_available
    assert st.kernel_names() == list(st._KERNEL.values())
    assert "PK_NH" not in pt.FusedScalarStepper(
        pt.ScalarSector(2, potential=fused_test_potential), GRID, DX, H,
        device="cpu").kernel_header()

    sector = _HubbleStressSector(2, potential=fused_test_potential)
    hub_sij = pt.FusedPreheatStepper(
        sector, pt.TensorPerturbationSector([sector]), GRID, DX, H,
        dtype=torch.float64, device="cpu")
    hub_pot = _port(lambda f: 0.5 * f[0] ** 2 * pt.Var("hubble"))
    for other in (hub_sij, hub_pot):
        assert not other.coupled_pair_available
        assert "preheat_coupled_pair" not in other.kernel_names()
        header = other.kernel_header()
        assert "pk_sij(" in header and "_nohub" not in header
        assert "PK_HUBBLE_FREE" not in header
    with pytest.raises(RuntimeError, match="pair=True"):
        hub_sij.coupled_multi_step(
            pt.state_from_numpy(_state(12), device="cpu"), 1,
            pt.Expansion(1.0, pt.LowStorageRK54), 0.0, DT, pair=True)


def test_launch_checks():
    """launch takes the eight arrays of the GW system with their own
    component counts and only this stepper's kernels; without CUDA the
    default device raises instead of running on the CPU."""
    st = _port()
    state, k = st.init_carry(pt.state_from_numpy(_state(12), device="cpu"))
    ins = st._inputs((state, k))
    assert [t.shape[0] for t in ins] == [2, 2, 2, 2, 6, 6, 6, 6]
    params = (DT, 1.3, 0.21, pt.LowStorageRK54._A[1],
              pt.LowStorageRK54._B[1])
    outs = st.launch("preheat_stage", ins, st._out_set(ins), params)
    assert len(outs) == 8 and outs[4].shape == (6,) + GRID
    with pytest.raises(ValueError, match="not a kernel of this stepper"):
        st.launch("fused_stage", ins, st._out_set(ins), params)
    with pytest.raises(ValueError, match="8 arrays in"):
        st.launch("preheat_stage", ins[:4], st._out_set(ins)[:4], params)
    with pytest.raises(ValueError, match="shape"):
        st.launch("preheat_stage", ins[:4] + ins[:4], st._out_set(ins),
                  params)
    if not torch.cuda.is_available():
        sector = pt.ScalarSector(2, potential=fused_test_potential)
        with pytest.raises(RuntimeError):
            pt.FusedPreheatStepper(sector, pt.TensorPerturbationSector(
                [sector]), GRID, DX, H)
    assert set(st.kernel_names()) <= set(tfused.KERNELS)


def test_gw_state_round_trip():
    """A GW state and carry carry across from the JAX package and back:
    JAX -> numpy -> port -> numpy, bit for bit, hij and dhijdt as
    (6, X, Y, Z)."""
    s = {k: jnp.asarray(v) for k, v in _state(12).items()}
    k = {n: 2 * v for n, v in s.items()}
    state, kt = pt.carry_from_numpy(
        ({n: np.asarray(v) for n, v in s.items()},
         {n: np.asarray(v) for n, v in k.items()}), device="cpu")
    assert state["hij"].shape == (6,) + GRID
    assert state["hij"].dtype == torch.float64
    back_s, back_k = pt.to_numpy((state, kt))
    for n in NAMES:
        assert np.array_equal(back_s[n], np.asarray(s[n]))
        assert np.array_equal(back_k[n], np.asarray(k[n]))
    st = _port()
    out = st.multi_step(state, 1, 0.0, DT, {"a": 1.0, "hubble": 0.0})
    assert set(pt.to_numpy(out)) == set(NAMES)
