"""The port's gravitational-wave system with bfloat16 RK carries,
``FusedPreheatStepper(carry_dtype=torch.bfloat16)``: ``step``,
``multi_step`` and ``coupled_multi_step`` against the JAX package's
bf16-carry stepper (the 512^3-on-one-device configuration of bench.py's
gw-step bf16 cell, at 16^3); the plain versions of the bf16 variants of K7,
K8, K9 and K5' against the port's own identities. (The CUDA kernels are held
to these plain versions on the card, in tests/test_torch_kernels.py.)

The JAX steppers run their Pallas kernels in interpret mode here (the GW
coupled chunk about 27 s at 16^3), so their results are computed once per
module and every comparison reads them."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pystella_tpu as ps
import pystella_tpu_torch as pt
from pystella_tpu.ops.fused import FusedPreheatStepper as JaxPreheat
from pystella_tpu_torch.ops import fused as tfused

GRID, H, DX, DT = (16, 16, 16), 2, (0.3, 0.25, 0.2), 0.01
ARGS = {"a": 1.1, "hubble": 0.2}
NAMES = ("f", "dfdt", "hij", "dhijdt")
A, B = pt.LowStorageRK54._A, pt.LowStorageRK54._B

#: the bf16-carry accuracy bar of tests/test_fused.py:416
BF16_BAR = 1e-2
#: the port's bf16 result may differ from the JAX one by at most this share
#: of the bf16 effect (the JAX bf16 result vs the port's f32-carry one), in
#: root mean square over the lattice, as in tests/test_torch_bf16_coupled.py.
#: Measured: up to 6.5% (dhijdt of the two-step coupled chunk), against
#: 0.1-4% for the scalar fields: the tensor carries' f32 values differ
#: between the packages by more ulps (S_ij is a product of gradients, which
#: cancel), so more of their bf16 roundings flip
GAP_SHARE = 0.1
#: a and adot, port vs JAX: set by the f32 energy sums' order, not by the
#: carries (tests/test_torch_bf16_coupled.py states the measurement)
A_BAR = 2e-7


def potential(f):
    # tests/test_fused.py's potential
    return 0.5 * 1.2e-2 * f[0] ** 2 + 0.125 * f[0] ** 2 * f[1] ** 2


def _state():
    # the state of tests/test_fused.py:423-430 (test_bf16_carry_accuracy),
    # in float32
    rng = np.random.default_rng(47)
    st = {"f": 0.1 * rng.standard_normal((2,) + GRID),
          "dfdt": 0.01 * rng.standard_normal((2,) + GRID),
          "hij": 1e-3 * rng.standard_normal((6,) + GRID),
          "dhijdt": 1e-4 * rng.standard_normal((6,) + GRID)}
    return {k: v.astype(np.float32) for k, v in st.items()}


def _rms(got, ref):
    """Root-mean-square difference relative to the reference's."""
    got = np.asarray(pt.to_numpy(got), np.float64)
    ref = np.asarray(pt.to_numpy(ref), np.float64)
    return np.sqrt(np.mean((got - ref) ** 2) / np.mean(ref ** 2))


def _rel(got, ref):
    got = np.asarray(pt.to_numpy(got), np.float64)
    ref = np.asarray(pt.to_numpy(ref), np.float64)
    return np.max(np.abs(got - ref)) / max(np.max(np.abs(ref)), 1e-30)


def _port(carry_dtype=torch.bfloat16, **kw):
    sector = pt.ScalarSector(2, potential=potential)
    return pt.FusedPreheatStepper(
        sector, pt.TensorPerturbationSector([sector]), GRID, DX, H,
        dtype=torch.float32, carry_dtype=carry_dtype, device="cpu", **kw)


def _clone(state):
    return {k: v.clone() for k, v in state.items()}


def _torch_state():
    return pt.state_from_numpy(_state(), device="cpu")


def _run(st, how, entry=None):
    """The port's result of ``how`` (the keys of the JAX fixture) and, for
    the coupled runs, its Expansion."""
    if how == "step":
        return _clone(st.step(_torch_state(), 0.0, DT, ARGS)), None
    if how == "multi3":
        return _clone(st.multi_step(_torch_state(), 3, 0.0, DT, ARGS)), None
    exp = pt.expansion_from_numpy(entry)
    nsteps = int(how[-1])
    return _clone(st.coupled_multi_step(_torch_state(), nsteps, exp, 0.0,
                                        DT)), exp


@pytest.fixture(scope="module")
def jax_ref():
    """The JAX bf16-carry GW stepper (interpret mode, bx=4, by=8, f32
    state): step(), multi_step(3) (7 pairs and the odd K7), and
    coupled_multi_step with the deferred-drag pairs for nsteps 2 (ending on
    the chunk-end finalize) and 3 (the finalize and the odd K5'); then the
    hand-over carry (stage 0) and its energy stage 1."""
    decomp = ps.DomainDecomposition((1, 1, 1), devices=jax.devices()[:1])
    sector = ps.ScalarSector(2, potential=potential)
    st = JaxPreheat(sector, ps.TensorPerturbationSector([sector]), decomp,
                    GRID, DX, H, dtype=jnp.float32, bx=4, by=8,
                    carry_dtype=jnp.bfloat16)

    def jstate():
        return {k: jnp.asarray(v) for k, v in _state().items()}

    def numpy(tree):
        return jax.tree_util.tree_map(np.asarray, tree)

    out = {"step": (numpy(st.step(jstate(), 0.0, DT, ARGS)),),
           "multi3": (numpy(st.multi_step(jstate(), 3, 0.0, DT, ARGS)),)}
    for nsteps in (2, 3):
        exp = ps.Expansion(1.0, ps.LowStorageRK54)
        entry = {"a": exp.a, "adot": exp.adot, "mpl": exp.mpl}
        res = st.coupled_multi_step(jstate(), nsteps, exp, 0.0, DT)
        out[f"coupled{nsteps}"] = (numpy(res), float(exp.a),
                                   float(exp.adot), entry)
    st._ensure_energy_call()
    carry = st.stage(0, st.init_carry(jstate()), 0.0, DT, ARGS)
    assert carry[1]["dhijdt"].dtype == jnp.bfloat16
    nxt, es = st._stage_energy(1, carry, 0.0, DT, ARGS)
    out["handover"] = (numpy(carry), numpy(nxt), np.asarray(es))
    return out


@pytest.mark.parametrize("how", ["step", "multi3", "coupled2", "coupled3"])
def test_bf16_gw_matches_jax(jax_ref, how):
    """The bf16-carry GW stepper vs the JAX one: every field within
    BF16_BAR and within GAP_SHARE of the bf16 effect; the result differs
    from the f32-carry run; for the coupled chunks a and adot within
    A_BAR."""
    ref = jax_ref[how]
    entry = ref[3] if how.startswith("coupled") else None
    got, exp = _run(_port(), how, entry)
    f32, _ = _run(_port(None), how, entry)
    for name in NAMES:
        assert got[name].dtype == torch.float32
        err = _rel(got[name], ref[0][name])
        assert err < BF16_BAR, f"{name}: rel err {err}"
        err, gap = _rms(got[name], ref[0][name]), _rms(f32[name],
                                                       ref[0][name])
        assert err < GAP_SHARE * gap, f"{name}: {err} vs bf16 gap {gap}"
    assert any(not torch.equal(got[n], f32[n]) for n in NAMES)
    if exp is not None:
        assert abs(exp.a - ref[1]) / ref[1] < A_BAR
        assert abs(exp.adot - ref[2]) / abs(ref[2]) < A_BAR


def test_bf16_gw_carries_are_bf16():
    """Every carry the bf16 GW stepper stores is bfloat16, the tensor
    carries too; a coupled chunk's pairs store theirs in bf16 and the odd
    trailing stage takes the finalized velocity carries (kdfdt, kdhijdt)
    in float32."""
    st = _port()
    k = st.init_carry(_torch_state())[1]
    assert {v.dtype for v in k.values()} == {torch.bfloat16}
    seen = []
    launch = st.launch

    def rec(name, ins, outs, params):
        seen.append((name, [t.dtype for t in ins], [t.dtype for t in outs]))
        return launch(name, ins, outs, params)
    st.launch = rec
    st.coupled_multi_step(_torch_state(), 1, pt.Expansion(
        1.0, pt.LowStorageRK54), 0.0, DT)
    f32, bf = torch.float32, torch.bfloat16
    stored = [f32, f32, bf, bf] * 2
    assert seen == [
        ("preheat_coupled_pair", stored, stored),
        ("preheat_coupled_pair_deferred", stored, stored),
        ("preheat_stage_energy", [f32, f32, bf, f32] * 2, stored)]


def test_handover_from_jax(jax_ref):
    """A JAX bf16 GW carry after one stage (K7), carried across with
    carry_from_numpy, continues in the port: K5' gives the JAX stage's
    state and sums to f32 rounding and its carries to one bf16 ulp."""
    carry, ref, ref_es = jax_ref["handover"]
    st = _port()
    got = pt.carry_from_numpy(carry, device="cpu")
    assert got[1]["hij"].dtype == torch.bfloat16
    (state, k), es = st._stage_energy(1, got, 0.0, DT, ARGS)
    for name in NAMES:
        assert _rel(state[name], ref[0][name]) < 1e-6, name
        assert k[name].dtype == torch.bfloat16
        assert _rel(k[name], ref[1][name]) < 2 ** -7, name
    assert np.max(np.abs(es.double().numpy() - ref_es)) \
        / np.abs(ref_es).max() < 1e-5


# -- identities inside the port -----------------------------------------------

def _inputs(st, seed=3, fin=False):
    rng = np.random.default_rng(seed)
    amps = (0.5, 0.3, 0.01, 0.02, 1e-3, 1e-4, 1e-5, 1e-4)
    ins = [torch.tensor(a * rng.standard_normal((c,) + GRID),
                        dtype=torch.float32)
           for a, c in zip(amps, st._comps)]
    return [t.to(d) for t, d in zip(ins, st._in_dtypes(fin))]


def test_pair_equals_two_singles_bf16():
    """The GW pair (K8) that multi_step runs across a step boundary (stages
    4 and 0; A[0] == 0) equals two single GW stages (K7) bit for bit with
    bf16 carries: the singles round stage 4's carries where they store
    them, and A[0] == 0 keeps that rounding out of stage 0 (the pair keeps
    stage 1's carries unrounded, as the JAX pair body does; within a step
    the two differ by that rounding)."""
    st = _port()
    carry = (_torch_state(), st.init_carry(_torch_state())[1])
    carry = st.stage(0, carry, 0.0, DT, ARGS)
    carry = (_clone(carry[0]), _clone(carry[1]))
    pair = st.stage_pair(4, carry, 0.0, DT, ARGS, s2=0)
    pair = (_clone(pair[0]), _clone(pair[1]))
    mid = st.stage(4, carry, 0.0, DT, ARGS)
    two = st.stage(0, (_clone(mid[0]), _clone(mid[1])), 0.0, DT, ARGS)
    for part in (0, 1):
        for name in NAMES:
            assert pair[part][name].dtype == two[part][name].dtype
            assert torch.equal(pair[part][name], two[part][name]), name
    assert two[1]["hij"].dtype == torch.bfloat16


def test_energy_stage_equals_stage_bf16():
    """K5' lattice outputs equal K7's with bf16 carries, bit for bit."""
    st = _port()
    ins = _inputs(st)
    p = (DT, 1.1, 0.5, A[1], B[1])
    energy = st.plain("preheat_stage_energy", ins, p)
    stage = st.plain("preheat_stage", ins, p)
    assert len(energy) == 9
    for a, b in zip(energy, stage):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("name", ["preheat_stage", "preheat_pair",
                                  "preheat_stage_energy",
                                  "preheat_coupled_pair",
                                  "preheat_coupled_pair_deferred"])
def test_bf16_plain_is_widened_f32(name):
    """Each bf16 GW kernel's plain version is the f32-carry one on the
    widened inputs with the carries rounded where they are stored: state
    in f32, carries (the tensor ones too) in bf16; the energy stage also
    with the finalized (f32) velocity carries."""
    st, wide = _port(), _port(None)
    p = {"preheat_stage": (DT, 1.1, 0.5, A[1], B[1]),
         "preheat_pair": (DT, 1.1, 0.5, A[1], B[1], 1.2, 0.45, A[2], B[2]),
         "preheat_coupled_pair": (DT, 1.1, 0.5, A[1], B[1], 1.1001, A[2],
                                  B[2])}
    p["preheat_stage_energy"] = p["preheat_stage"]
    p["preheat_coupled_pair_deferred"] = p["preheat_coupled_pair"] + (
        0.49, B[0])
    fins = (False, True) if name == "preheat_stage_energy" else (False,)
    for fin in fins:
        ins = _inputs(st, seed=5, fin=fin)
        assert st._finalized(name, ins) == fin
        got = st.plain(name, ins, p[name])
        ref = wide.plain(name, [t.float() for t in ins], p[name])
        assert [t.dtype for t in got[:8]] == list(st._dtypes)
        for a, b in zip(got, ref):
            assert torch.equal(a, b.to(a.dtype))


def test_gw_bf16_kernel_names_and_bytes():
    """A bf16 GW stepper names its kernels <name>:bf16 and counts 16 state
    component-arrays at 4 bytes and 16 carry component-arrays at 2 per
    launch, each once in and once out: 96 bytes a site each way against 128
    with f32 carries."""
    st = _port()
    assert st.kernel_names() == [n + tfused.BF16 for n in (
        "preheat_stage", "preheat_pair", "preheat_stage_energy",
        "preheat_coupled_pair", "preheat_coupled_pair_deferred")]
    sites = int(np.prod(GRID))
    assert st.kernel_tier_report()["bytes_per_launch"] == 2 * 96 * sites
    assert _port(None).kernel_tier_report()["bytes_per_launch"] == \
        2 * 128 * sites
