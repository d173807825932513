"""The port's energy-coupled driver with bfloat16 RK carries,
``FusedScalarStepper(carry_dtype=torch.bfloat16).coupled_multi_step``,
against the JAX package's bf16-carry coupled chunk; the plain versions of
the bf16 variants of K5 and K6 against the port's own identities. (The CUDA
kernels are held to these plain versions on the card, in
tests/test_torch_kernels.py.)

The JAX coupled chunks run their Pallas kernels in interpret mode here
(about 10-14 s each at 16^3), so they are computed once per module and
every comparison reads them."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pystella_tpu as ps
import pystella_tpu_torch as pt
from pystella_tpu.ops.fused import FusedScalarStepper as JaxFused
from pystella_tpu_torch.ops import fused as tfused

GRID, H, DX, DT = (16, 16, 16), 2, (0.3, 0.25, 0.2), 0.01
A, B = pt.LowStorageRK54._A, pt.LowStorageRK54._B

#: the bf16-carry accuracy bar of tests/test_fused.py:416 (and of
#: tests/test_torch_chunk.py): the port's bf16 result vs the JAX one
BF16_BAR = 1e-2
#: ... and, tighter, against the bf16 effect itself: the port's bf16 result
#: may differ from the JAX one by at most this fraction of the gap between
#: the JAX bf16 result and the f32-carry result, both as root-mean-square
#: over the lattice (relative to the JAX result's). The two packages round
#: the same f32 values to bf16 only up to the f32 ulps they differ by (XLA
#: contracts multiply-adds the port keeps apart), which flips a rounding
#: where a value lies that close to a bf16 midpoint: at a few sites, each
#: flip moving one carry by one bf16 ulp -- as much, at that site, as the
#: bf16 effect itself, so the largest difference is no measure of it. A
#: carry left unrounded (or rounded once too often) moves every site, and
#: the root mean square by a large share of the whole gap.
GAP_SHARE = 0.1
#: a and adot, port vs JAX, relative, with bf16 carries and (in
#: test_f32_carries_match_jax) with f32 carries alike: the background
#: integrates the f32 energy sums, which the two packages add in other
#: orders (each sum 0-2.4e-7 apart, measured), and not the carries: with f32
#: carries the JAX chunk run op by op and jitted lands 2e-8 and 1e-10 from
#: the port in adot; with bf16 carries the measured gaps are up to 1.2e-8 (a)
#: and 5.2e-8 (adot). The bar is four times the largest.
A_BAR = 2e-7


def fused_test_potential(f):
    # tests/test_fused.py's potential
    return 0.5 * 1.2e-2 * f[0] ** 2 + 0.125 * f[0] ** 2 * f[1] ** 2


def _o1_state():
    # the O(1)-energy state of tests/test_fused.py:381-388 (hubble ~ 3), in
    # float32
    rng = np.random.default_rng(41)
    return {"f": rng.standard_normal((2,) + GRID).astype(np.float32),
            "dfdt": (0.3 * rng.standard_normal((2,) + GRID)).astype(
                np.float32)}


def _rms(got, ref):
    """Root-mean-square difference relative to the reference's."""
    got = np.asarray(pt.to_numpy(got), np.float64)
    ref = np.asarray(pt.to_numpy(ref), np.float64)
    return np.sqrt(np.mean((got - ref) ** 2) / np.mean(ref ** 2))


def _rel(got, ref):
    got = np.asarray(pt.to_numpy(got), np.float64)
    ref = np.asarray(pt.to_numpy(ref), np.float64)
    return np.max(np.abs(got - ref)) / np.max(np.abs(ref))


def _port(carry_dtype=torch.bfloat16, **kw):
    sector = pt.ScalarSector(2, potential=fused_test_potential)
    return pt.FusedScalarStepper(sector, GRID, DX, H, dtype=torch.float32,
                                 carry_dtype=carry_dtype, device="cpu", **kw)


def _clone(state):
    return {k: v.clone() for k, v in state.items()}


def _coupled(st, nsteps, expansion, pair):
    out = st.coupled_multi_step(
        pt.state_from_numpy(_o1_state(), device="cpu"), nsteps, expansion,
        0.0, DT, pair=pair)
    return _clone(out)


#: the JAX runs: (carry dtype, nsteps, pair)
RUNS = (("bf16", 2, True), ("bf16", 3, True), ("bf16", 2, False),
        ("f32", 3, True))


@pytest.fixture(scope="module")
def jax_ref():
    """The JAX coupled chunks (interpret mode, bx=4, by=8, f32 state) on
    the O(1)-energy state for :data:`RUNS`, and the hand-over carry: the
    JAX bf16 stepper's stage 0 from that state and its energy stage 1."""
    decomp = ps.DomainDecomposition((1, 1, 1), devices=jax.devices()[:1])
    sector = ps.ScalarSector(2, potential=fused_test_potential)
    steppers = {cd: JaxFused(sector, decomp, GRID, DX, H, dtype=jnp.float32,
                             bx=4, by=8,
                             carry_dtype=jnp.bfloat16 if cd == "bf16"
                             else None)
                for cd in ("bf16", "f32")}
    out = {}
    for cd, nsteps, pair in RUNS:
        exp = ps.Expansion(1.0, ps.LowStorageRK54)
        entry = {"a": exp.a, "adot": exp.adot, "mpl": exp.mpl}
        res = steppers[cd].coupled_multi_step(
            {k: jnp.asarray(v) for k, v in _o1_state().items()}, nsteps, exp,
            0.0, DT, pair=pair)
        out[cd, nsteps, pair] = ({n: np.asarray(v) for n, v in res.items()},
                                 float(exp.a), float(exp.adot), entry)
    st = steppers["bf16"]
    st._ensure_energy_call()
    args = {"a": 1.1, "hubble": 0.3}
    carry = st.stage(0, st.init_carry(
        {k: jnp.asarray(v) for k, v in _o1_state().items()}), 0.0, DT, args)
    nxt, es = st._stage_energy(1, carry, 0.0, DT, args)
    out["handover"] = (jax.tree_util.tree_map(np.asarray, carry),
                       jax.tree_util.tree_map(np.asarray, nxt),
                       np.asarray(es), args)
    return out


@pytest.mark.parametrize("nsteps,pair", [(2, True), (3, True), (2, False)],
                         ids=["pair-2", "pair-3", "single-2"])
def test_bf16_coupled_matches_jax(jax_ref, nsteps, pair):
    """coupled_multi_step with bf16 carries vs the JAX package's, from the
    same background: within BF16_BAR, and within GAP_SHARE of the bf16
    effect (the JAX bf16 result vs the port's f32-carry one, which stands
    within f32 rounding of the JAX f32-carry one: test_f32_carries_match_jax
    below); a and adot to A_BAR. nsteps=3 ends on the finalize and the odd
    energy stage (K5 reading the finalized velocity carry, ``_bf16_fin``);
    nsteps=2 on the chunk-end finalize; pair=False runs K5 at every
    stage."""
    ref, a_ref, adot_ref, entry = jax_ref["bf16", nsteps, pair]
    exp = pt.expansion_from_numpy(entry)
    got = _coupled(_port(), nsteps, exp, pair)
    f32 = _coupled(_port(None), nsteps, pt.expansion_from_numpy(entry), pair)
    for name in ("f", "dfdt"):
        assert got[name].dtype == torch.float32
        err = _rel(got[name], ref[name])
        assert err < BF16_BAR, f"{name}: rel err {err}"
        err, gap = _rms(got[name], ref[name]), _rms(f32[name],
                                                       ref[name])
        assert err < GAP_SHARE * gap, f"{name}: {err} vs bf16 gap {gap}"
        assert not torch.equal(got[name], f32[name])
    assert abs(exp.a - a_ref) / a_ref < A_BAR
    assert abs(exp.adot - adot_ref) / abs(adot_ref) < A_BAR


def test_f32_carries_match_jax(jax_ref):
    """The f32-carry port against the JAX f32-carry chunk (nsteps=3, f32
    state): f and dfdt within 1e-5 (f32 rounding over 15 stages; the JAX
    package with x64 on finalizes in float64), a and adot within the A_BAR
    the bf16 port is held to."""
    ref, a_ref, adot_ref, entry = jax_ref["f32", 3, True]
    exp = pt.expansion_from_numpy(entry)
    got = _coupled(_port(None), 3, exp, True)
    for name in ("f", "dfdt"):
        assert _rel(got[name], ref[name]) < 1e-5, name
    assert abs(exp.a - a_ref) / a_ref < A_BAR
    assert abs(exp.adot - adot_ref) / abs(adot_ref) < A_BAR


def test_bf16_carries_are_bf16():
    """The carries a bf16 coupled chunk stores are bfloat16 (the pairs'
    kf and kdfp); the finalize leaves the velocity carry in the working
    dtype, unrounded, as the JAX package's does, and the odd trailing stage
    takes it so."""
    st = _port()
    carries = []
    launch = st.launch

    def rec(name, ins, outs, params):
        carries.append((name, ins[2].dtype, ins[3].dtype, outs[2].dtype,
                        outs[3].dtype))
        return launch(name, ins, outs, params)
    st.launch = rec
    st.coupled_multi_step(pt.state_from_numpy(_o1_state(), device="cpu"), 1,
                          pt.Expansion(1.0, pt.LowStorageRK54), 0.0, DT)
    bf = torch.bfloat16
    assert carries == [
        ("coupled_pair", bf, bf, bf, bf),
        ("coupled_pair_deferred", bf, bf, bf, bf),
        ("fused_stage_energy", bf, torch.float32, bf, bf)]
    assert st.init_carry(pt.state_from_numpy(_o1_state(), device="cpu"))[1][
        "dfdt"].dtype == bf


def test_handover_from_jax(jax_ref):
    """A JAX bf16 carry after one stage, carried across with
    carry_from_numpy (bf16 stays bf16), continues in the port: the energy
    stage (K5's bf16 plain version) gives the JAX stage's state and sums to
    f32 rounding and its carries to one bf16 ulp."""
    carry, ref, ref_es, args = jax_ref["handover"]
    st = _port()
    got = pt.carry_from_numpy(carry, device="cpu")
    assert got[1]["f"].dtype == torch.bfloat16
    (state, k), es = st._stage_energy(1, got, 0.0, DT, args)
    for name in ("f", "dfdt"):
        assert _rel(state[name], ref[0][name]) < 1e-6, name
        assert k[name].dtype == torch.bfloat16
        # one bf16 ulp is 2^-8 relative
        assert _rel(k[name], ref[1][name]) < 2 ** -7, name
    scale = np.abs(ref_es).max()
    assert np.max(np.abs(es.double().numpy() - ref_es)) / scale < 1e-5


# -- identities inside the port -----------------------------------------------

def _inputs(st, seed=3, fin=False):
    rng = np.random.default_rng(seed)
    amps = (0.5, 0.3, 0.01, 0.02)
    ins = [torch.tensor(a * rng.standard_normal((2,) + GRID),
                        dtype=torch.float32) for a in amps]
    return [t.to(d) for t, d in zip(ins, st._in_dtypes(fin))]


def test_energy_stage_equals_stage_bf16():
    """K5's lattice outputs equal K2's with bf16 carries, bit for bit (the
    energy sums are added after the stage, never inside it)."""
    st = _port()
    ins = _inputs(st)
    p = (DT, 1.1, 0.5, A[1], B[1])
    energy = st.plain("fused_stage_energy", ins, p)
    stage = st.plain("fused_stage", ins, p)
    assert len(energy) == 5
    for a, b in zip(energy, stage):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert energy[2].dtype == torch.bfloat16


def test_finalized_energy_stage():
    """The energy stage after a finalize (velocity carry in f32, kf in
    bf16) is the stage on the same values: its outputs equal those of the
    f32-carry stepper's stage on the widened kf, rounded where they are
    stored."""
    st, wide = _port(), _port(None)
    ins = _inputs(st, fin=True)
    assert ins[3].dtype == torch.float32 and ins[2].dtype == torch.bfloat16
    assert st._finalized("fused_stage_energy", ins)
    p = (DT, 1.1, 0.5, A[3], B[3])
    got = st.plain("fused_stage_energy", ins, p)
    ref = wide.plain("fused_stage_energy", [t.float() for t in ins], p)
    for a, b, d in zip(got, ref, st._dtypes + (torch.float32,)):
        assert torch.equal(a, b.to(d))


def test_coupled_pair_bf16_plain():
    """The bf16 coupled pairs: carries stored in bf16 (kf2, kdfp), state
    in f32 (f2 and the velocity dfp); the lattice outputs equal the
    f32-carry pair's on the widened inputs with the carries rounded on
    store (stage 1's carries are not rounded), and the sums too; the
    deferred variant widens kdfp where it completes the velocity."""
    st, wide = _port(), _port(None)
    for name in ("coupled_pair", "coupled_pair_deferred"):
        ins = _inputs(st, seed=5)
        p = (DT, 1.1, 0.5, A[1], B[1], 1.1001, A[2], B[2])
        if name == "coupled_pair_deferred":
            p += (0.49, B[0])
        got = st.plain(name, ins, p)
        ref = wide.plain(name, [t.float() for t in ins], p)
        assert [t.dtype for t in got[:4]] == list(st._dtypes)
        for a, b in zip(got, ref):
            assert torch.equal(a, b.to(a.dtype))


def test_launch_counts_bf16_names():
    """kernel_names and kernel_tier_report name the :bf16 kernels a bf16
    stepper launches; every kernel has a :bf16 launch counter, and the
    energy stages one for their _bf16_fin variant too."""
    st = _port()
    assert st.kernel_names() == [
        n + tfused.BF16 for n in ("fused_stage", "fused_pair",
                                  "fused_stage_energy", "coupled_pair",
                                  "coupled_pair_deferred")]
    assert st.kernel_tier_report()["kernel_names"] == {
        "pair": "fused_pair:bf16"}
    assert {n + tfused.BF16 for n in tfused.KERNELS} | {
        "fused_stage_energy:bf16_fin", "preheat_stage_energy:bf16_fin"} \
        <= set(tfused.LAUNCHES)
    assert st.counted_name("fused_stage_energy", True) == \
        "fused_stage_energy:bf16_fin"
    assert _port(None).kernel_names()[0] == "fused_stage"
