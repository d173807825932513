"""The port's sharded steppers with bfloat16 RK carries,
``FusedScalarStepper`` and ``FusedPreheatStepper`` with ``decomp=`` and
``carry_dtype=torch.bfloat16`` (every shard a CPU tensor here, the kernels'
plain versions): stepping bit for bit against the port's single-device bf16
stepper, stepping and the energy-coupled chunk against the JAX package's
sharded bf16 stepper on its virtual CPU devices (interpret mode, x64 on),
the finalize's working-dtype velocity carry, and where the carries are
stored.

The JAX sharded calls cost 2-10 s each here, so they run once per module
(the whole file takes about 50 s on one worker). The card's padded and
overlapped bf16 launches are held to these plain versions and to the
unpadded bf16 kernels in tests/test_torch_kernels.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pystella_tpu as ps
import pystella_tpu_torch as pt
from pystella_tpu.ops.fused import FusedPreheatStepper as JaxPreheat
from pystella_tpu.ops.fused import FusedScalarStepper as JaxFused
from pystella_tpu_torch.ops import fused as tfused

GRID, H, DX, DT = (16, 16, 16), 2, (0.3, 0.25, 0.2), 0.01
ARGS = {"a": 1.1, "hubble": 0.2}
BF = torch.bfloat16
#: the port's meshes: (mesh, overlap)
MESHES = [((2, 1, 1), False), ((2, 1, 1), True), ((2, 2, 1), False),
          ((1, 2, 1), False), ((4, 1, 1), False)]
MESH_IDS = ["211-padded", "211-overlap", "221", "121", "411"]
#: the JAX sharded stepper's meshes
JAX_MESHES = [(2, 1, 1), (2, 2, 1)]
JAX_IDS = ["211", "221"]
#: the bf16-carry bars of tests/test_torch_bf16_coupled.py: the port's bf16
#: result within BF16_BAR of the JAX one (max relative), and within
#: GAP_SHARE of the bf16 effect (root mean square: the JAX bf16 result's
#: gap from the port's f32-carry one). Not tighter: the packages' f32 values
#: differ by a few ulp (XLA contracts multiply-adds the port keeps apart),
#: and where a carry lies that close to a bf16 rounding midpoint the two
#: round it to neighbouring bf16 values -- one bf16 ulp at a few sites, as
#: large there as the bf16 effect itself. A carry left unrounded, or
#: rounded once too often, moves every site and a large share of the rms.
BF16_BAR = 1e-2
GAP_SHARE = 0.1
#: a and adot, port vs JAX and sharded vs single-device (relative): the
#: background integrates f32 energy sums that add in other orders (the JAX
#: package's psum, the port's rank order on the CPU); the bar of
#: tests/test_torch_bf16_coupled.py
A_BAR = 2e-7
#: the coupled runs held to the JAX sharded chunk: (mesh, nsteps, pair);
#: nsteps 1 ends on the finalize and the odd trailing stage (the _bf16_fin
#: energy stage), nsteps 2 on the chunk-end finalize
COUPLED = [((2, 1, 1), 1, True), ((2, 1, 1), 2, True),
           ((2, 1, 1), 1, False), ((2, 2, 1), 1, True)]
COUPLED_IDS = ["211-n1", "211-n2", "211-n1-single", "221-n1"]


def potential(f):
    # tests/test_fused.py's potential
    return 0.5 * 1.2e-2 * f[0] ** 2 + 0.125 * f[0] ** 2 * f[1] ** 2


def _state(gw, dtype=np.float32, seed=29):
    rng = np.random.default_rng(seed)
    out = {"f": 0.1 * rng.standard_normal((2,) + GRID),
           "dfdt": 0.01 * rng.standard_normal((2,) + GRID)}
    if gw:
        out["hij"] = 1e-3 * rng.standard_normal((6,) + GRID)
        out["dhijdt"] = 1e-4 * rng.standard_normal((6,) + GRID)
    return {k: v.astype(dtype) for k, v in out.items()}


def _np(dtype):
    return np.float64 if dtype == torch.float64 else np.float32


def _decomp(mesh):
    return pt.DomainDecomposition(mesh, devices=["cpu"] * int(np.prod(mesh)))


def _port(gw, decomp=None, dtype=torch.float32, carry_dtype=BF, **kw):
    sector = pt.ScalarSector(2, potential=potential)
    if gw:
        return pt.FusedPreheatStepper(
            sector, pt.TensorPerturbationSector([sector]), GRID, DX, H,
            dtype=dtype, carry_dtype=carry_dtype, device="cpu",
            decomp=decomp, **kw)
    return pt.FusedScalarStepper(sector, GRID, DX, H, dtype=dtype,
                                 carry_dtype=carry_dtype, device="cpu",
                                 decomp=decomp, **kw)


def _load(st, state):
    """A numpy state on the stepper's device(s): sharded or one tensor."""
    if st.decomp is not None:
        return pt.shard_state(st.decomp, state)
    return pt.state_from_numpy(state, device="cpu")


def _host(tree):
    """Copies on the host: a single-device call returns the stepper's own
    buffers, which its next call overwrites."""
    return jax.tree_util.tree_map(np.array, pt.to_numpy(tree))


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.max(np.abs(got - ref)) / max(np.max(np.abs(ref)), 1e-30)


def _rms(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.sqrt(np.mean((got - ref) ** 2) / np.mean(ref ** 2))


def _calls(st, state):
    """The stepping calls held bit for bit: step, multi_step(2), and from a
    fresh carry stage(1) then stage_pair(2) (state and carries)."""
    out = {"step": _host(st.step(_load(st, state), 0.0, DT, ARGS)),
           "multi_step": _host(st.multi_step(_load(st, state), 2, 0.0, DT,
                                             ARGS))}
    carry = st.stage(1, st.init_carry(_load(st, state)), 0.0, DT, ARGS)
    carry = st.stage_pair(2, carry, 0.0, DT, ARGS)
    assert all(v.dtype == BF for v in carry[1].values())
    out["stage_pair"] = _host(carry)
    return out


def _coupled(st, state, nsteps, pair=None, entry=None):
    exp = (pt.Expansion(1.0, pt.LowStorageRK54) if entry is None
           else pt.expansion_from_numpy(entry))
    out = st.coupled_multi_step(_load(st, state), nsteps, exp, 0.0, DT,
                                pair=pair)
    return _host(out), float(exp.a), float(exp.adot)


@pytest.fixture(scope="module")
def single():
    """The port's single-device bf16 calls, per (gw, dtype)."""
    return {(gw, dtype): _calls(_port(gw, dtype=dtype),
                                _state(gw, _np(dtype)))
            for gw in (False, True)
            for dtype in (torch.float32, torch.float64)}


@pytest.fixture(scope="module")
def jax_ref():
    """The JAX sharded bf16 steppers (f32 state, bx=4, by=8, padded,
    interpret mode): multi_step(2) of the scalar and GW systems on both
    meshes, the scalar coupled chunks of :data:`COUPLED` and the GW
    coupled chunk of nsteps 1 on (2, 1, 1), each with its entry
    background."""
    out = {}
    sector = ps.ScalarSector(2, potential=potential)
    gwsec = ps.TensorPerturbationSector([sector])
    kw = dict(dtype=jnp.float32, bx=4, by=8, overlap=False,
              carry_dtype=jnp.bfloat16)
    for mesh in JAX_MESHES:
        d = ps.DomainDecomposition(
            mesh, devices=jax.devices()[:int(np.prod(mesh))])
        steppers = {False: JaxFused(sector, d, GRID, DX, H, **kw),
                    True: JaxPreheat(sector, gwsec, d, GRID, DX, H, **kw)}
        for gw, st in steppers.items():
            res = st.multi_step({k: d.shard(v) for k, v in
                                 _state(gw).items()}, 2, 0.0, DT, ARGS)
            out[mesh, gw] = {k: np.asarray(v) for k, v in res.items()}
        runs = [(False, n, p) for m, n, p in COUPLED if m == mesh]
        if mesh == (2, 1, 1):
            runs.append((True, 1, True))
        for gw, nsteps, pair in runs:
            exp = ps.Expansion(1.0, ps.LowStorageRK54)
            entry = {"a": float(exp.a), "adot": float(exp.adot),
                     "mpl": exp.mpl}
            res = steppers[gw].coupled_multi_step(
                {k: d.shard(v) for k, v in _state(gw).items()}, nsteps,
                exp, 0.0, DT, pair=pair)
            out[mesh, gw, nsteps, pair] = (
                {k: np.asarray(v) for k, v in res.items()}, float(exp.a),
                float(exp.adot), entry)
    return out


# -- (a) sharded == single-device, bit for bit --------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("mesh,overlap", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("gw", [False, True], ids=["scalar", "gw"])
def test_stepping_equals_single_device(single, gw, mesh, overlap, dtype):
    """step, multi_step(2) and stage_pair on a sharded bf16 state equal
    the single-device bf16 calls bit for bit, the state and the bf16
    carries: every padded, interior or shell launch reads the same widened
    tap values in the same order and rounds its carries where the
    unpadded one does. (4, 1, 1) and (1, 2, 1) take the padded launch."""
    d = _decomp(mesh)
    st = _port(gw, d, dtype, overlap=overlap)
    got = _calls(st, _state(gw, _np(dtype)))
    ref = single[gw, dtype]
    for call in ("step", "multi_step"):
        for k, v in ref[call].items():
            np.testing.assert_array_equal(got[call][k], v,
                                          err_msg=f"{call} {k}")
    for part, (g, r) in enumerate(zip(got["stage_pair"],
                                      ref["stage_pair"])):
        for k in r:
            np.testing.assert_array_equal(g[k], r[k],
                                          err_msg=f"stage_pair {part} {k}")
    kind = ({"interior": 1, "shell": 2} if overlap and mesh == (2, 1, 1)
            else {{(2, 1, 1): "xpad", (4, 1, 1): "xpad", (1, 2, 1): "ypad",
                   (2, 2, 1): "xypad"}[mesh]: 1})
    assert st.sharded_kinds() == kind


# -- (b) against the JAX sharded bf16 stepper ---------------------------------

@pytest.mark.parametrize("mesh", JAX_MESHES, ids=JAX_IDS)
@pytest.mark.parametrize("gw", [False, True], ids=["scalar", "gw"])
def test_multi_step_matches_jax_sharded(jax_ref, gw, mesh):
    """multi_step(2) with bf16 carries on a sharded state vs the JAX
    sharded bf16 stepper: within BF16_BAR and within GAP_SHARE of the bf16
    effect (the JAX result vs the port's f32-carry run on the same mesh);
    the port's result differs from its f32-carry one."""
    d = _decomp(mesh)
    ref = jax_ref[mesh, gw]
    st = _port(gw, d)
    got = _host(st.multi_step(_load(st, _state(gw)), 2, 0.0, DT, ARGS))
    f32 = _host(_port(gw, d, carry_dtype=None).multi_step(
        pt.shard_state(d, _state(gw)), 2, 0.0, DT, ARGS))
    for k in ref:
        assert got[k].dtype == np.float32
        assert _rel(got[k], ref[k]) < BF16_BAR, k
        err, gap = _rms(got[k], ref[k]), _rms(f32[k], ref[k])
        assert err < GAP_SHARE * gap, f"{k}: {err} vs bf16 gap {gap}"
        assert not np.array_equal(got[k], f32[k]), k


# -- (c) the sharded coupled chunk with bf16 carries --------------------------

@pytest.mark.parametrize("mesh,nsteps,pair", COUPLED, ids=COUPLED_IDS)
def test_coupled_matches_jax_sharded(jax_ref, mesh, nsteps, pair):
    """The sharded bf16 coupled chunk vs the JAX sharded bf16 chunk from the
    same background, on the bars of the multi_step comparison (the bf16
    effect from the port's sharded f32-carry chunk), a and adot to A_BAR;
    and vs the port's single-device bf16 chunk on the same bars (the sums
    add per block, then in rank order, here on the CPU)."""
    ref, a_ref, adot_ref, entry = jax_ref[mesh, False, nsteps, pair]
    d = _decomp(mesh)
    got, a, adot = _coupled(_port(False, d), _state(False), nsteps, pair,
                            entry)
    f32, _, _ = _coupled(_port(False, d, carry_dtype=None), _state(False),
                         nsteps, pair, entry)
    one, a1, adot1 = _coupled(_port(False), _state(False), nsteps, pair,
                              entry)
    for k in ref:
        gap = _rms(f32[k], ref[k])
        for other in (ref[k], one[k]):
            assert _rel(got[k], other) < BF16_BAR, k
            err = _rms(got[k], other)
            assert err < GAP_SHARE * gap, f"{k}: {err} vs bf16 gap {gap}"
    for r, r1, g in ((a_ref, a1, a), (adot_ref, adot1, adot)):
        assert abs(g - r) / abs(r) < A_BAR
        assert abs(g - r1) / abs(r1) < A_BAR


def test_gw_coupled_matches_jax_sharded(jax_ref):
    """The sharded bf16 GW coupled chunk (nsteps 1: pairs, the finalize
    and the odd tail) on (2, 1, 1) overlapped (its sum kernels padded) vs
    the JAX sharded bf16 chunk and the port's single-device bf16 chunk, on
    the bars above."""
    ref, a_ref, adot_ref, entry = jax_ref[(2, 1, 1), True, 1, True]
    d = _decomp((2, 1, 1))
    got, a, adot = _coupled(_port(True, d, overlap=True), _state(True), 1,
                            entry=entry)
    f32, _, _ = _coupled(_port(True, d, carry_dtype=None), _state(True), 1,
                         entry=entry)
    one, a1, _ = _coupled(_port(True), _state(True), 1, entry=entry)
    for k in ref:
        gap = _rms(f32[k], ref[k])
        for other in (ref[k], one[k]):
            assert _rel(got[k], other) < BF16_BAR, k
            assert _rms(got[k], other) < GAP_SHARE * gap, k
    assert abs(a - a_ref) / a_ref < A_BAR and abs(a - a1) / a1 < A_BAR
    assert abs(adot - adot_ref) / abs(adot_ref) < A_BAR


@pytest.mark.parametrize("gw", [False, True], ids=["scalar", "gw"])
def test_finalize_leaves_velocity_carry_unrounded(gw):
    """Before the odd trailing stage the finalize has completed the
    velocity carries (kdfdt, kdhijdt) in the working dtype, unrounded, in
    the stepper's own arrays, and the trailing energy stage reads them so;
    the field carries stay bf16. The completed carry equals the
    single-device finalize's bit for bit."""
    seen = {}

    def spy(st, key):
        fin = st._finalize_deferred

        def wrapped(carry, *a):
            out = fin(carry, *a)
            seen[key] = pt.to_numpy(out[1]), {k: v.dtype for k, v in
                                              out[1].items()}
            return out
        st._finalize_deferred = wrapped
        return st

    d = _decomp((2, 2, 1))
    _coupled(spy(_port(gw, d), "sharded"), _state(gw), 1)
    _coupled(spy(_port(gw), "single"), _state(gw), 1)
    got, dtypes = seen["sharded"]
    ref, _ = seen["single"]
    velocities = ("dfdt", "dhijdt") if gw else ("dfdt",)
    for k, dt in dtypes.items():
        assert dt == (torch.float32 if k in velocities else BF), k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


# -- (d) carry storage, exchange buffers, names -------------------------------

def test_carries_and_exchange_buffers_are_bf16():
    """The carries are bf16 ShardedArrays; the padded exchange buffers of
    the carry windows (kf; the deferred pair's kdfp, kf; their tensor
    counterparts) are bf16, one set per slot and dtype; a bf16 window moves
    half the bytes of an f32 one; kernel_tier_report names the bf16 kinds
    and the launch counters exist for every bf16 sharded launch."""
    d = _decomp((2, 2, 1))
    st = _port(True, d)
    carry = st.init_carry(pt.shard_state(d, _state(True)))
    assert all(isinstance(v, pt.ShardedArray) and v.dtype == BF
               for v in carry[1].values())
    d.bytes_exchanged = 0
    st.stage_pair(0, carry, 0.0, DT, ARGS)
    bf16_bytes = d.bytes_exchanged
    assert {k: b[0].dtype for k, b in st._pad_bufs.items()} == {
        (j, dt): dt for j, dt in [(0, torch.float32), (1, torch.float32),
                                  (2, BF), (4, torch.float32),
                                  (5, torch.float32), (6, BF)]}
    _coupled(st, _state(True), 1)
    assert {k for k in st._pad_bufs if k[1] == BF} == {
        (j, BF) for j in (2, 3, 6, 7)}
    wide = _port(True, d, carry_dtype=None)
    d.bytes_exchanged = 0
    wide.stage_pair(0, wide.init_carry(pt.shard_state(d, _state(True))),
                    0.0, DT, ARGS)
    # windows f, dfdt, kf (2 components each), hij, dhijdt, khij (6 each):
    # the carry windows at 2 bytes instead of 4
    assert bf16_bytes * 24 == d.bytes_exchanged * 20
    rep = _port(False, _decomp((2, 1, 1)), overlap=True).kernel_tier_report()
    assert rep["sharded_launches_per_2_steps"] == {
        "fused_pair:bf16:interior": 10, "fused_pair:bf16:shell": 20}
    assert rep["kernel_names"] == {"pair": "fused_pair:bf16"}
    assert st.kernel_tier_report()["sharded_launches_per_2_steps"] == {
        "preheat_pair:bf16:xypad": 20}
    assert st.counted_name("preheat_stage_energy", True, "xpad") == \
        "preheat_stage_energy:bf16_fin:xpad"
    for name in tfused._WINDOWS:
        for kind in ("xpad", "ypad", "xypad"):
            assert f"{name}:bf16:{kind}" in tfused.LAUNCHES
            assert f"{name}:bf16:{kind}" in tfused.SHARDED_KERNELS
    for name in ("fused_stage_energy", "preheat_stage_energy"):
        assert f"{name}:bf16_fin:xypad" in tfused.SHARDED_KERNELS
        assert f"{name}:bf16:interior" not in tfused.LAUNCHES


def test_launch_block_checks_slot_dtypes():
    """launch_block takes each array in its slot's storage dtype: an f32
    carry window on a bf16 stepper is refused, the bf16 one runs."""
    st = _port(False, _decomp((2, 1, 1)))
    X, Y, Z = st.local_shape
    rng = np.random.default_rng(5)
    ins = [torch.tensor(rng.standard_normal((2, X + 2 * H, Y, Z)),
                        dtype=torch.float32) for _ in range(3)]
    ins.append(torch.zeros((2, X, Y, Z), dtype=BF))
    outs = st._new_set("cpu")
    params = (DT, 1.0, 0.1, 0.0, 0.3, 1.0, 0.1, -0.4, 0.5)
    with pytest.raises(ValueError, match=r"array 2 in torch.bfloat16"):
        st.launch_block("fused_pair", "xpad", ins, outs, params)
    ins[2] = ins[2].to(BF)
    got = st.launch_block("fused_pair", "xpad", ins, outs, params)
    assert [t.dtype for t in got] == [torch.float32] * 2 + [BF] * 2


def test_shard_state_round_trips_bf16_carries():
    """shard_state and to_numpy round-trip a bf16 carry dict bit for bit,
    from tensors and from the bf16 numpy arrays a JAX carry gives."""
    d = _decomp((2, 2, 1))
    rng = np.random.default_rng(9)
    k = {n: torch.tensor(rng.standard_normal((2,) + GRID),
                         dtype=torch.float32).to(BF) for n in ("f", "dfdt")}
    jk = {n: np.asarray(jnp.asarray(v.float().numpy(), jnp.bfloat16))
          for n, v in k.items()}
    for src in (k, jk):
        sharded = pt.shard_state(d, src)
        assert all(v.dtype == BF for v in sharded.values())
        back = pt.to_numpy(sharded)
        for n in k:
            np.testing.assert_array_equal(back[n], k[n].float().numpy())
