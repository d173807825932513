"""The port's energy-coupled driver for the gravitational-wave system,
``FusedPreheatStepper.coupled_multi_step``, against the JAX package's and
against the port's own per-stage driver loop; the launch schedule of K9
and K5'. (The CUDA kernels are held to their plain versions on the card, in
tests/test_torch_kernels.py.)

The JAX coupled chunk runs its Pallas kernels in interpret mode here, so
its two results are computed once per module and every comparison reads
them."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import pystella_tpu as ps
import pystella_tpu_torch as pt
from pystella_tpu.ops.fused import FusedPreheatStepper as JaxPreheat

GRID, H, DX, DT = (16, 16, 16), 2, 0.3, 0.01
NAMES = ("f", "dfdt", "hij", "dhijdt")


def fused_test_potential(f):
    # tests/test_fused.py's potential
    return 0.5 * 1.2e-2 * f[0] ** 2 + 0.125 * f[0] ** 2 * f[1] ** 2


def _state():
    # the state of tests/test_fused.py:265-271
    rng = np.random.default_rng(29)
    return {"f": 0.1 * rng.standard_normal((2,) + GRID),
            "dfdt": 0.01 * rng.standard_normal((2,) + GRID),
            "hij": 1e-3 * rng.standard_normal((6,) + GRID),
            "dhijdt": 1e-4 * rng.standard_normal((6,) + GRID)}


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.max(np.abs(got - ref)) / max(np.max(np.abs(ref)), 1e-30)


def _port(**kw):
    sector = pt.ScalarSector(2, potential=fused_test_potential)
    return pt.FusedPreheatStepper(sector, pt.TensorPerturbationSector(
        [sector]), GRID, DX, H, device="cpu", **{"dtype": np.float64, **kw})


def _coupled(st, nsteps, expansion, pair):
    out = st.coupled_multi_step(pt.state_from_numpy(_state(), device="cpu"),
                                nsteps, expansion, 0.0, DT, pair=pair)
    return {k: v.clone() for k, v in out.items()}


@pytest.fixture(scope="module")
def jax_coupled():
    """The JAX GW coupled chunk (interpret mode, bx=4, by=8, as
    tests/test_fused.py builds it), nsteps=1, for pair=True (2 pairs, the
    mid-chunk finalize and the odd tail) and pair=False, from a unit-energy
    background (hubble ~ 2.9)."""
    decomp = ps.DomainDecomposition((1, 1, 1), devices=jax.devices()[:1])
    sector = ps.ScalarSector(2, potential=fused_test_potential)
    fused = JaxPreheat(sector, ps.TensorPerturbationSector([sector]), decomp,
                       GRID, DX, H, dtype=jnp.float64, bx=4, by=8)
    out = {}
    for pair in (True, False):
        exp = ps.Expansion(1.0, ps.LowStorageRK54)
        entry = {"a": exp.a, "adot": exp.adot, "mpl": exp.mpl}
        res = fused.coupled_multi_step(
            {k: jnp.asarray(v) for k, v in _state().items()}, 1, exp, 0.0,
            DT, pair=pair)
        out[pair] = ({n: np.asarray(v) for n, v in res.items()},
                     float(exp.a), float(exp.adot), entry)
    return out


@pytest.mark.parametrize("pair", [True, False], ids=["pair", "single"])
def test_coupled_matches_jax(jax_coupled, pair):
    """coupled_multi_step vs the JAX package's, from the same background:
    f, dfdt, hij and dhijdt to 1e-12, a and adot to 1e-13 relative (the
    energy sums add in another order)."""
    ref, a_ref, adot_ref, entry = jax_coupled[pair]
    exp = pt.expansion_from_numpy(entry)
    got = _coupled(_port(), 1, exp, pair)
    for name in NAMES:
        err = _rel(got[name], ref[name])
        assert err < 1e-12, f"{name}: rel err {err}"
    assert abs(exp.a - a_ref) / a_ref < 1e-13
    assert abs(exp.adot - adot_ref) / abs(adot_ref) < 1e-13


@pytest.mark.parametrize("nsteps", [1, 2])
def test_pair_matches_single_stage(nsteps):
    """The deferred-drag pair path (K9, the finalize, K5') equals the
    single-stage path (K5') up to the re-association of one dt
    distribution: 1e-12. nsteps=1 ends on the odd tail (mid-chunk
    finalize), nsteps=2 on a deferred pair (chunk-end finalize)."""
    outs = {}
    for pair in (False, True):
        exp = pt.Expansion(1.0, pt.LowStorageRK54)
        outs[pair] = (_coupled(_port(), nsteps, exp, pair), exp.a, exp.adot)
    (ref, a_ref, adot_ref), (got, a_got, adot_got) = outs[False], outs[True]
    for name in NAMES:
        assert _rel(got[name], ref[name]) < 1e-12, name
    assert abs(a_got - a_ref) / a_ref < 1e-13
    assert abs(adot_got - adot_ref) / abs(adot_ref) < 1e-12


def _driver_loop(st, state, nsteps):
    """The per-stage driver loop of tests/test_fused.py:283-295 on the
    port: the fused stepper's single stages, the expansion stepped on the
    entering scalar energy (Reduction with FiniteDifferencer.lap)."""
    fd = pt.FiniteDifferencer(H, DX, device="cpu")
    reduce_energy = pt.Reduction(st.sector, callback=pt.get_rho_and_p,
                                 grid_size=float(np.prod(GRID)))

    def energy_of(s, a):
        return reduce_energy(f=s["f"], dfdt=s["dfdt"], lap_f=fd.lap(s["f"]),
                             a=np.float64(a))

    energy = energy_of(state, 1.0)
    exp = pt.Expansion(energy["total"], pt.LowStorageRK54)
    energy0 = energy["total"]
    for _ in range(nsteps):
        carry = st.init_carry(state)
        for s in range(st.num_stages):
            carry = st.stage(s, carry, 0.0, DT, {"a": np.float64(exp.a),
                                                 "hubble": np.float64(
                                                     exp.hubble)})
            exp.step(s, energy["total"], energy["pressure"], DT)
            energy = energy_of(st.current(carry), exp.a)
        state = {k: v.clone() for k, v in st.extract(carry).items()}
    return state, exp, energy0


@pytest.mark.parametrize("pair", [True, False], ids=["pair", "single"])
def test_coupled_matches_driver_loop(pair):
    """coupled_multi_step vs the per-stage driver loop over two steps:
    1e-12 in every field, a and adot (the energy sums add in other
    orders)."""
    state = pt.state_from_numpy(_state(), device="cpu")
    ref, exp_ref, energy0 = _driver_loop(_port(), state, 2)
    exp = pt.Expansion(energy0, pt.LowStorageRK54)
    got = _port().coupled_multi_step(
        {k: v.clone() for k, v in state.items()}, 2, exp, 0.0, DT, pair=pair)
    for name in NAMES:
        assert _rel(got[name], ref[name]) < 1e-12, name
    assert abs(exp.a - exp_ref.a) / exp_ref.a < 1e-12
    assert abs(exp.adot - exp_ref.adot) / abs(exp_ref.adot) < 1e-12


def _schedule(st, nsteps, pair):
    calls = []
    launch, finalize = st.launch, st._finalize_deferred

    def rec_launch(name, *a, **k):
        calls.append(name)
        return launch(name, *a, **k)

    def rec_finalize(*a, **k):
        calls.append("finalize")
        return finalize(*a, **k)
    st.launch, st._finalize_deferred = rec_launch, rec_finalize
    st.coupled_multi_step(pt.state_from_numpy(_state(), device="cpu"),
                          nsteps, pt.Expansion(1.0, pt.LowStorageRK54), 0.0,
                          DT, pair=pair)
    return calls


def test_coupled_schedule():
    """The launch sequence of the JAX package's _coupled_pair_impl, by GW
    kernel name: the chunk's first pair takes the normal input, the rest
    the deferred one; an odd trailing stage finalizes (the tensor drag
    too) and runs K5'; a chunk that ends on a pair finalizes at the end.
    pair=False runs K5' at every stage; multi_step runs K8 and the odd K7."""
    assert _schedule(_port(), 1, None) == [
        "preheat_coupled_pair", "preheat_coupled_pair_deferred", "finalize",
        "preheat_stage_energy"]
    assert _schedule(_port(), 2, True) == (
        ["preheat_coupled_pair"] + ["preheat_coupled_pair_deferred"] * 4
        + ["finalize"])
    assert _schedule(_port(), 2, False) == ["preheat_stage_energy"] * 10
    st = _port()
    calls = []
    launch = st.launch
    st.launch = lambda name, *a, **k: (calls.append(name),
                                       launch(name, *a, **k))[1]
    st.multi_step(pt.state_from_numpy(_state(), device="cpu"), 3, 0.0, DT,
                  {"a": 1.0, "hubble": 0.1})
    assert calls == ["preheat_pair"] * 7 + ["preheat_stage"]


def test_finalize_completes_tensor_drag():
    """The finalize completes the deferred drag of both velocities with
    the kernels' arithmetic: K9's normal pair + finalize equals K8 with
    hubble2 = hubfix to 1e-12 in every output, and the deferred variant
    on the pair's outputs equals the normal one on the finalized state
    bitwise."""
    st = _port()
    A, B = pt.LowStorageRK54._A, pt.LowStorageRK54._B
    state = pt.state_from_numpy(_state(), device="cpu")
    rng = np.random.default_rng(5)
    k = {n: pt.state_from_numpy({n: 0.1 * rng.standard_normal(
        v.shape)}, device="cpu")[n] for n, v in state.items()}
    ins = st._inputs((state, k))
    dt, a1, hub1, a2, hubfix = DT, 1.3, 0.4, 1.31, 0.39
    pair = st.plain("preheat_coupled_pair", ins,
                    (dt, a1, hub1, A[1], B[1], a2, A[2], B[2]))
    assert len(pair) == 10
    fstate, fk = st._finalize_deferred(st._carry_of(pair), dt, hubfix, B[2])
    ref = st.plain("preheat_pair", ins, (dt, a1, hub1, A[1], B[1], a2,
                                         hubfix, A[2], B[2]))
    for got, r in zip(st._inputs((fstate, fk)), ref):
        assert _rel(got, r) < 1e-12
    nxt = (dt, a2, hubfix, A[2], B[2], 1.32, A[3], B[3])
    order = [0, 1, 3, 2, 4, 5, 7, 6]
    deferred = st.plain("preheat_coupled_pair_deferred",
                        [pair[j] for j in order], nxt + (hubfix, B[2]))
    normal = st.plain("preheat_coupled_pair", st._inputs((fstate, fk)), nxt)
    for got, r in zip(deferred, normal):
        assert np.array_equal(got.numpy(), r.numpy())
