"""The port's energy-coupled driver, ``coupled_multi_step``, against the JAX
package's and against the port's own per-stage driver loop; the plain
versions of the energy kernels K5 and K6. (The CUDA kernels themselves are
held to these plain versions on the card, in tests/test_torch_kernels.py.)

The JAX coupled chunk runs its Pallas kernels in interpret mode here, so
its two results are computed once per module and every comparison reads
them."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pystella_tpu as ps
import pystella_tpu_torch as pt
from pystella_tpu.ops.fused import FusedScalarStepper as JaxFused
from pystella_tpu_torch.ops import codegen, stencil
from pystella_tpu_torch.ops.derivs import _lap_coefs

GRID, H, DX, DT = (16, 16, 16), 2, (0.3, 0.25, 0.2), 0.01
A, B = pt.LowStorageRK54._A, pt.LowStorageRK54._B


def fused_test_potential(f):
    # tests/test_fused.py's potential
    return 0.5 * 1.2e-2 * f[0] ** 2 + 0.125 * f[0] ** 2 * f[1] ** 2


def hubble_potential(f):
    # a potential that reads the Hubble rate: no deferred-drag pair
    return 0.5 * f[0] ** 2 * pt.Var("hubble") + 0.125 * f[0] ** 2 * f[1] ** 2


def _o1_state():
    # the O(1)-energy state of tests/test_fused.py:381-388 (hubble ~ 3)
    rng = np.random.default_rng(41)
    return {"f": rng.standard_normal((2,) + GRID),
            "dfdt": 0.3 * rng.standard_normal((2,) + GRID)}


def _small_state(seed=23):
    # the state of tests/test_fused.py:187-191
    rng = np.random.default_rng(seed)
    return {"f": 0.1 * rng.standard_normal((2,) + GRID),
            "dfdt": 0.01 * rng.standard_normal((2,) + GRID)}


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.max(np.abs(got - ref)) / np.max(np.abs(ref))


def _port(potential=fused_test_potential, dtype=torch.float64, **kw):
    return pt.FusedScalarStepper(pt.ScalarSector(2, potential=potential),
                                 GRID, DX, H, dtype=dtype, device="cpu", **kw)


def _clone(state):
    return {k: v.clone() for k, v in state.items()}


def _coupled(st, state, nsteps, expansion, pair):
    out = st.coupled_multi_step(pt.state_from_numpy(state, device="cpu"),
                                nsteps, expansion, 0.0, DT, pair=pair)
    return _clone(out)


@pytest.fixture(scope="module")
def jax_coupled():
    """The JAX coupled chunk (interpret mode, bx=4, by=8, as
    tests/test_fused.py builds it) on the O(1)-energy state, nsteps=1, for
    pair=True (2 pairs + the odd tail) and pair=False."""
    decomp = ps.DomainDecomposition((1, 1, 1), devices=jax.devices()[:1])
    fused = JaxFused(ps.ScalarSector(2, potential=fused_test_potential),
                     decomp, GRID, DX, H, dtype=jnp.float64, bx=4, by=8)
    out = {}
    for pair in (True, False):
        exp = ps.Expansion(1.0, ps.LowStorageRK54)
        entry = {"a": exp.a, "adot": exp.adot, "mpl": exp.mpl}
        res = fused.coupled_multi_step(
            {k: jnp.asarray(v) for k, v in _o1_state().items()}, 1, exp,
            0.0, DT, pair=pair)
        out[pair] = ({n: np.asarray(v) for n, v in res.items()},
                     float(exp.a), float(exp.adot), entry)
    # the pair path in float32 (K6's f32 arithmetic)
    fused32 = JaxFused(ps.ScalarSector(2, potential=fused_test_potential),
                       decomp, GRID, DX, H, dtype=jnp.float32, bx=4, by=8)
    exp = ps.Expansion(1.0, ps.LowStorageRK54)
    entry = {"a": exp.a, "adot": exp.adot, "mpl": exp.mpl}
    res = fused32.coupled_multi_step(
        {k: jnp.asarray(v, jnp.float32) for k, v in _o1_state().items()},
        1, exp, 0.0, DT, pair=True)
    out["f32"] = ({n: np.asarray(v) for n, v in res.items()},
                  float(exp.a), float(exp.adot), entry)
    return out


@pytest.mark.parametrize("pair", [True, False], ids=["pair", "single"])
def test_coupled_matches_jax(jax_coupled, pair):
    """(c) coupled_multi_step vs the JAX package's, from the same
    background: f and dfdt to 1e-12, a and adot to 1e-13 relative. The
    host-side Friedmann stages repeat the JAX operation order, so a and
    adot differ only through the energy sums' summation order."""
    ref, a_ref, adot_ref, entry = jax_coupled[pair]
    exp = pt.expansion_from_numpy(entry)
    got = _coupled(_port(), _o1_state(), 1, exp, pair)
    for name in ("f", "dfdt"):
        err = _rel(got[name], ref[name])
        assert err < 1e-12, f"{name}: rel err {err}"
    assert abs(exp.a - a_ref) / a_ref < 1e-13
    assert abs(exp.adot - adot_ref) / abs(adot_ref) < 1e-13
    assert exp.hubble == exp.adot / exp.a


def test_coupled_matches_jax_f32(jax_coupled):
    """(c) The pair path (K6 in both inputs, then the odd tail) in float32
    vs the JAX package's, from the same background: f and dfdt to 5e-7
    relative (eight float32 ulp over the step's five stages, where the two
    packages round a few operations differently), a and adot to 2e-7 (the
    float32 energy sums add in other orders; the host's Friedmann stages
    are the same)."""
    ref, a_ref, adot_ref, entry = jax_coupled["f32"]
    exp = pt.expansion_from_numpy(entry)
    state = {k: v.astype(np.float32) for k, v in _o1_state().items()}
    got = _coupled(_port(dtype=torch.float32), state, 1, exp, True)
    for name in ("f", "dfdt"):
        assert got[name].dtype == torch.float32
        err = _rel(got[name], ref[name])
        assert err < 5e-7, f"{name}: rel err {err}"
    assert abs(exp.a - a_ref) / a_ref < 2e-7
    assert abs(exp.adot - adot_ref) / abs(adot_ref) < 2e-7


@pytest.mark.parametrize("nsteps", [1, 2])
def test_pair_matches_single_stage(nsteps):
    """(d) The deferred-drag pair path equals the single-stage path up to
    the re-association of one dt distribution: 1e-12."""
    st = _port()
    outs = {}
    for pair in (False, True):
        exp = pt.Expansion(1.0, pt.LowStorageRK54)
        outs[pair] = (_coupled(st, _o1_state(), nsteps, exp, pair),
                      exp.a, exp.adot)
    (ref, a_ref, adot_ref), (got, a_got, adot_got) = outs[False], outs[True]
    for name in ("f", "dfdt"):
        assert _rel(got[name], ref[name]) < 1e-12, name
    assert abs(a_got - a_ref) / a_ref < 1e-13
    assert abs(adot_got - adot_ref) / abs(adot_ref) < 1e-12


def _driver_loop(state, nsteps, potential):
    """The reference per-stage driver loop (tests/test_fused.py:206-219)
    on the port's generic pieces: LowStorageRK54 over the sector's
    rhs_dict with FiniteDifferencer.lap, the energy re-reduced by Reduction
    after every stage, Expansion stepped on the entering energy. Returns
    the final state and Expansion, and the initial energy the Expansion
    started from."""
    sector = pt.ScalarSector(2, potential=potential)
    fd = pt.FiniteDifferencer(H, DX, device="cpu")
    rhs = pt.compile_rhs_dict(sector.rhs_dict)
    gen = pt.LowStorageRK54(
        lambda s, t, a, hubble: rhs(s, t, lap_f=fd.lap(s["f"]), a=a,
                                    hubble=hubble))
    reduce_energy = pt.Reduction(sector, callback=pt.get_rho_and_p,
                                 grid_size=float(np.prod(GRID)))

    def energy_of(st, exp):
        return reduce_energy(f=st["f"], dfdt=st["dfdt"],
                             lap_f=fd.lap(st["f"]), a=np.float64(exp.a),
                             hubble=np.float64(exp.hubble))

    # the background starts from the energy at hubble = 0 (which only a
    # potential that reads hubble notices)
    energy0 = reduce_energy(f=state["f"], dfdt=state["dfdt"],
                            lap_f=fd.lap(state["f"]), a=np.float64(1.0),
                            hubble=np.float64(0.0))["total"]
    exp = pt.Expansion(energy0, pt.LowStorageRK54)
    energy = energy_of(state, exp)
    for _ in range(nsteps):
        carry = gen.init_carry(state)
        for s in range(gen.num_stages):
            carry = gen.stage(s, carry, 0.0, DT,
                              {"a": np.float64(exp.a),
                               "hubble": np.float64(exp.hubble)})
            exp.step(s, energy["total"], energy["pressure"], DT)
            energy = energy_of(gen.current(carry), exp)
        state = gen.extract(carry)
    return state, exp, energy0


@pytest.mark.parametrize("pair", [True, False], ids=["pair", "single"])
def test_coupled_matches_driver_loop(pair):
    """(d) coupled_multi_step vs the generic per-stage driver loop over
    two steps: 1e-12 in f, dfdt, a and adot (the Laplacian and the energy
    sums add in other orders)."""
    state = pt.state_from_numpy(_small_state(), device="cpu")
    ref, exp_ref, energy0 = _driver_loop(_clone(state), 2,
                                         fused_test_potential)
    exp = pt.Expansion(energy0, pt.LowStorageRK54)
    got = _port().coupled_multi_step(_clone(state), 2, exp, 0.0, DT,
                                     pair=pair)
    for name in ("f", "dfdt"):
        assert _rel(got[name], ref[name]) < 1e-12, name
    assert abs(exp.a - exp_ref.a) / exp_ref.a < 1e-12
    assert abs(exp.adot - exp_ref.adot) / abs(exp_ref.adot) < 1e-12


def _inputs(seed, dtype=torch.float64):
    rng = np.random.default_rng(seed)
    amps = (1.0, 0.3, 0.01, 0.1)
    return [torch.tensor(a * rng.standard_normal((2,) + GRID), dtype=dtype)
            for a in amps]


def _abs_term_sums(st, f, dfdt, a, hub):
    """Sum |term| of each energy sum, in float64 with math.fsum: the
    scale the kernels' sums are held to."""
    lap = stencil.lap_from_taps(stencil.RollTaps(f.double()),
                                _lap_coefs[H], [1 / d**2 for d in DX])
    V = pt.evaluate(st._V, {"f": f.double(), "a": a, "hubble": hub})
    terms = ([(dfdt[c].double() ** 2) for c in range(2)]
             + [-f[c].double() * lap[c] for c in range(2)]
             + [torch.broadcast_to(torch.as_tensor(V), GRID)])
    return terms, [math.fsum(t.abs().flatten().tolist()) for t in terms]


@pytest.mark.parametrize("potential", [fused_test_potential, lambda f: 0.25],
                         ids=["fused_test", "constant"])
def test_energy_stage_plain_identities(potential):
    """(e) K5's plain version: its four lattice outputs are bitwise K2's,
    and its sums equal exactly rounded float64 sums of the same terms to
    1e-14 of sum |term|. A V that does not depend on f is summed over
    every site (N * V)."""
    st = _port(potential)
    ins = _inputs(2)
    params = (DT, 1.3, 0.4, A[2], B[2])
    stage = st.plain("fused_stage", ins, params)
    energy = st.plain("fused_stage_energy", ins, params)
    assert len(energy) == 5 and energy[4].shape == (5,)
    for o, r in zip(energy[:4], stage):
        assert torch.equal(o, r)
    terms, scale = _abs_term_sums(st, ins[0], ins[1], 1.3, 0.4)
    exact = [math.fsum(t.flatten().tolist()) for t in terms]
    for i in range(5):
        assert abs(energy[4][i].item() - exact[i]) <= 1e-14 * scale[i], i
    # launch() on CPU tensors returns the same, outputs then sums
    bufs = [torch.empty_like(ins[0]) for _ in range(4)]
    outs = st.launch("fused_stage_energy", ins, bufs, params)
    for o, r in zip(outs, energy):
        assert torch.equal(o, r)
    with pytest.raises(ValueError, match="takes the scalars"):
        st.launch("coupled_pair", ins, bufs, params)


@pytest.mark.parametrize("potential", [fused_test_potential, lambda f: 0.25],
                         ids=["fused_test", "constant"])
def test_deferred_pair_plain_identities(potential):
    """(e) K6's plain versions: the normal pair + the finalize equals the
    K3 pair with hubble2 = hubfix to 1e-12 (one dt distribution
    re-associated); the deferred variant on the pair's output equals the
    normal variant on the finalized state bitwise (it recomposes the
    velocity with the finalize's arithmetic); esums1 are K5's sums of the
    entry state."""
    st = _port(potential)
    ins = _inputs(3)
    dt, a1, hub1, a2, hubfix = DT, 1.3, 0.4, 1.31, 0.39
    s, s2 = 1, 2
    pair = st.plain("coupled_pair", ins, (dt, a1, hub1, A[s], B[s], a2,
                                          A[s2], B[s2]))
    assert len(pair) == 6
    carry = st._carry_of(pair[:4])
    state, k = st._finalize_deferred(carry, dt, hubfix, B[s2])
    ref = st.plain("fused_pair", ins, (dt, a1, hub1, A[s], B[s], a2, hubfix,
                                       A[s2], B[s2]))
    for got, r in zip((state["f"], state["dfdt"], k["f"], k["dfdt"]), ref):
        assert _rel(got, r) < 1e-12
    energy = st.plain("fused_stage_energy", ins, (dt, a1, hub1, A[s], B[s]))
    assert torch.equal(pair[4], energy[4])

    # the next pair, deferred input vs the finalized normal input
    nxt = (dt, a2, hubfix, A[s2], B[s2], 1.32, A[3], B[3])
    deferred = st.plain("coupled_pair_deferred",
                        [pair[0], pair[1], pair[3], pair[2]],
                        nxt + (hubfix, B[s2]))
    normal = st.plain("coupled_pair", [state["f"], state["dfdt"], k["f"],
                                       k["dfdt"]], nxt)
    for got, r in zip(deferred, normal):
        assert torch.equal(got, r)
    # esums2 of the pair is the stage-1 state's energy with lap f1 (a
    # K5 launch on the finalized state reads the same state)
    stage2 = st.plain("fused_stage_energy",
                      [state["f"], state["dfdt"], k["f"], k["dfdt"]],
                      (dt, a2, hubfix, A[3], B[3]))
    assert _rel(normal[4], stage2[4]) < 1e-14


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
    st.coupled_multi_step(pt.state_from_numpy(_small_state(), device="cpu"),
                          nsteps, pt.Expansion(1.0, pt.LowStorageRK54), 0.0,
                          DT, pair=pair)
    return calls


def test_coupled_schedule():
    """(f) The launch sequence of the JAX package's _coupled_pair_impl:
    a chunk's first pair takes the normal input, the rest the deferred
    one; an odd trailing stage finalizes and runs K5; a chunk that ends on
    a pair finalizes at the end. pair=False runs K5 at every stage."""
    st = _port()
    assert _schedule(st, 1, None) == [
        "coupled_pair", "coupled_pair_deferred", "finalize",
        "fused_stage_energy"]
    assert _schedule(_port(), 2, True) == (
        ["coupled_pair"] + ["coupled_pair_deferred"] * 4 + ["finalize"])
    assert _schedule(_port(), 2, False) == ["fused_stage_energy"] * 10


def test_hubble_gate():
    """(g) A potential that reads hubble has no deferred-drag pair:
    pair=True raises, pair=None runs K5 at every stage, the kernel list
    and the generated header leave the pair out, and printing the
    potential where hubble is not in scope raises."""
    st = _port(hubble_potential)
    assert not st.coupled_pair_available
    assert "coupled_pair" not in st.kernel_names()
    assert "PK_HUBBLE_FREE" not in st.kernel_header()
    assert "pk_v(" in st.kernel_header()
    with pytest.raises(RuntimeError, match="pair=True"):
        st.coupled_multi_step(
            pt.state_from_numpy(_small_state(), device="cpu"), 1,
            pt.Expansion(1.0, pt.LowStorageRK54), 0.0, DT, pair=True)
    assert _schedule(st, 1, None) == ["fused_stage_energy"] * 5
    with pytest.raises(ValueError, match="hubble"):
        codegen.print_c(st._V, fields={"f": "f"},
                        variables=codegen.HUBBLE_FREE_VARIABLES)
    # the other two conditions of the gate
    for kw in ({"pair_stages": False},
               {"tableau": type("T", (pt.LowStorageRK54,),
                                {"_A": [0.5] + A[1:]})}):
        other = _port(**kw)
        assert not other.coupled_pair_available
        assert _schedule(other, 1, None) == ["fused_stage_energy"] * 5


def test_hubble_potential_single_stage_matches_driver_loop():
    """(g) With hubble in the potential the single-stage coupled path
    still reproduces the per-stage driver loop (K5 evaluates V and dV/df with the
    exact stage hubble)."""
    state = pt.state_from_numpy(_small_state(7), device="cpu")
    ref, exp_ref, energy0 = _driver_loop(_clone(state), 1,
                                         hubble_potential)
    exp = pt.Expansion(energy0, pt.LowStorageRK54)
    got = _port(hubble_potential).coupled_multi_step(_clone(state), 1, exp,
                                                     0.0, DT)
    for name in ("f", "dfdt"):
        assert _rel(got[name], ref[name]) < 1e-12, name
    assert abs(exp.a - exp_ref.a) / exp_ref.a < 1e-12


def test_constant_potential_header():
    """V and dV/df that do not depend on f print as constants, which the
    kernel evaluates (and sums) at every site."""
    st = _port(lambda f: 0.25)
    header = st.kernel_header()
    assert "return T(0.25);" in header and "out[0] = T(0);" in header
    assert "PK_HUBBLE_FREE" in header
