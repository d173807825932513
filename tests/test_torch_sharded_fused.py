"""The port's FusedScalarStepper on sharded states (every shard a CPU
tensor here, the kernels' plain versions) against the JAX package's sharded
stepper on its virtual CPU devices (interpret mode) and against the port's
own single-device stepper; its refusals; Reduction of a sharded state.

The JAX sharded stepper costs 2-8 s a jitted call here, so its results are
computed once per module."""

import warnings

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
#: (mesh, overlap) of the JAX comparisons
CASES = [((2, 1, 1), False), ((2, 1, 1), True), ((2, 2, 1), False)]
CASE_IDS = ["211-padded", "211-overlap", "221"]


def potential(f):
    # tests/test_fused.py's potential
    return 0.5 * 1.2e-2 * f[0] ** 2 + 0.125 * f[0] ** 2 * f[1] ** 2


def _state(seed=11, dtype=np.float64):
    rng = np.random.default_rng(seed)
    return {"f": rng.standard_normal((2,) + GRID).astype(dtype),
            "dfdt": (0.1 * rng.standard_normal((2,) + GRID)).astype(dtype)}


def _decomp(mesh):
    return pt.DomainDecomposition(mesh, devices=["cpu"] * int(np.prod(mesh)))


def _port(decomp=None, dtype=torch.float64, **kw):
    return pt.FusedScalarStepper(pt.ScalarSector(2, potential=potential),
                                 GRID, DX, H, dtype=dtype, device="cpu",
                                 decomp=decomp, **kw)


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.max(np.abs(got - ref)) / np.max(np.abs(ref))


def _gather(state):
    return {k: v.decomp.gather_array(v) for k, v in state.items()}


@pytest.fixture(scope="module")
def jax_ref():
    """The JAX sharded stepper (bx=4, by=8, interpret mode): multi_step(3)
    in f64 on each case, and one f32 multi_step(3) on (2, 1, 1)."""
    out = {}
    for mesh, overlap in CASES + [((2, 1, 1), None)]:
        f32 = overlap is None
        dtype = jnp.float32 if f32 else jnp.float64
        d = ps.DomainDecomposition(
            mesh, devices=jax.devices()[:int(np.prod(mesh))])
        st = JaxFused(ps.ScalarSector(2, potential=potential), d, GRID, DX,
                      H, dtype=dtype, bx=4, by=8, overlap=bool(overlap))
        state = {k: d.shard(v) for k, v in _state(
            dtype=np.float32 if f32 else np.float64).items()}
        res = st.multi_step(state, 3, 0.0, DT, ARGS)
        out[mesh, overlap] = {k: np.asarray(v) for k, v in res.items()}
        if overlap is False:
            # stage 1, then the pair (2, 3), from a fresh carry (multi_step
            # donated the state above)
            state = {k: d.shard(v) for k, v in _state().items()}
            carry = st.stage(1, st.init_carry(state), 0.0, DT, ARGS)
            out[mesh, "stage"] = _numpy_carry(carry)
            out[mesh, "stage_pair"] = _numpy_carry(
                st.stage_pair(2, carry, 0.0, DT, ARGS))
    return out


def _numpy_carry(carry):
    return tuple({k: np.asarray(v) for k, v in c.items()} for c in carry)


@pytest.fixture(scope="module")
def single():
    """The port's single-device multi_step(3), f64 and f32."""
    out = {}
    for dtype in (torch.float64, torch.float32):
        np_dtype = np.float64 if dtype == torch.float64 else np.float32
        res = _port(dtype=dtype).multi_step(
            pt.state_from_numpy(_state(dtype=np_dtype), device="cpu"), 3,
            0.0, DT, ARGS)
        out[dtype] = {k: v.numpy().copy() for k, v in res.items()}
    return out


@pytest.mark.parametrize("mesh,overlap", CASES, ids=CASE_IDS)
def test_multi_step_matches_jax_sharded(jax_ref, mesh, overlap):
    """multi_step(3) on a sharded state vs the JAX sharded stepper, f64:
    1e-12 relative (the standing bar of the unsharded comparison)."""
    d = _decomp(mesh)
    got = _gather(_port(d, overlap=overlap).multi_step(
        pt.shard_state(d, _state()), 3, 0.0, DT, ARGS))
    for k in ("f", "dfdt"):
        assert _rel(got[k], jax_ref[mesh, overlap][k]) < 1e-12, k


@pytest.mark.parametrize("mesh", [(2, 1, 1), (2, 2, 1)], ids=["211", "221"])
def test_stage_and_stage_pair_match_jax_sharded(jax_ref, mesh):
    """stage(1) and then stage_pair(2) on a sharded carry vs the JAX sharded
    stepper's, f64: 1e-12 relative, state and carries."""
    d = _decomp(mesh)
    st = _port(d, overlap=False)
    carry = st.stage(1, st.init_carry(pt.shard_state(d, _state())), 0.0, DT,
                     ARGS)
    for call, got in (("stage", carry),
                      ("stage_pair", st.stage_pair(2, carry, 0.0, DT,
                                                   ARGS))):
        for g, r in zip(got, jax_ref[mesh, call]):
            for k in r:
                err = _rel(d.gather_array(g[k]), r[k])
                assert err < 1e-12, f"{call} {k}: {err}"


def test_multi_step_matches_jax_sharded_f32(jax_ref):
    """The same in f32 on (2, 1, 1): 2e-6 relative, a few ulp a stage, as
    the unsharded f32 comparison (tests/test_torch_fused.py)."""
    d = _decomp((2, 1, 1))
    got = _gather(_port(d, torch.float32, overlap=False).multi_step(
        pt.shard_state(d, _state(dtype=np.float32)), 3, 0.0, DT, ARGS))
    for k in ("f", "dfdt"):
        assert got[k].dtype == np.float32
        assert _rel(got[k], jax_ref[(2, 1, 1), None][k]) < 2e-6, k


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("mesh,overlap", CASES + [
    ((1, 1, 1), False), ((1, 2, 1), False), ((4, 1, 1), True),
    ((2, 2, 1), True)], ids=CASE_IDS + ["111", "121", "411-overlap",
                                        "221-overlap"])
def test_multi_step_equals_single_device(single, mesh, overlap, dtype):
    """A sharded multi_step(3) equals the port's single-device one bit for
    bit: every launch reads the same tap values in the same order (the
    JAX package meets the same bar). (4, 1, 1) at 16^3 leaves blocks of 4
    rows, thinner than 3h, and (2, 2, 1) shards y: both take the padded
    launch with the overlap asked for."""
    d = _decomp(mesh)
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    st = _port(d, dtype, overlap=overlap)
    got = _gather(st.multi_step(pt.shard_state(d, _state(dtype=np_dtype)),
                                3, 0.0, DT, ARGS))
    for k in ("f", "dfdt"):
        np.testing.assert_array_equal(got[k], single[dtype][k], err_msg=k)
    kinds = st.sharded_kinds()
    if mesh == (2, 1, 1) and overlap:
        assert kinds == {"interior": 1, "shell": 2}
    elif mesh == (1, 1, 1):
        assert kinds == {None: 1}
    else:
        assert kinds == {{(2, 1, 1): "xpad", (4, 1, 1): "xpad",
                          (1, 2, 1): "ypad", (2, 2, 1): "xypad"}[mesh]: 1}


@pytest.mark.parametrize("mesh,overlap", CASES, ids=CASE_IDS)
def test_stage_and_stage_pair_equal_single_device(mesh, overlap):
    """stage, stage_pair (also across a step boundary) and step on a
    sharded carry equal the single-device calls bit for bit; the returned
    carry is sharded like the input."""
    d = _decomp(mesh)
    sh, one = _port(d, overlap=overlap), _port()
    state = _state(13)
    carry_s = sh.init_carry(pt.shard_state(d, state))
    carry_1 = one.init_carry(pt.state_from_numpy(state, device="cpu"))
    for call, args in (("stage", (1,)), ("stage_pair", (2,)),
                       ("stage_pair", (4,))):
        kw = {"s2": 0} if args == (4,) else {}
        carry_s = getattr(sh, call)(*args, carry_s, 0.0, DT, ARGS, **kw)
        carry_1 = getattr(one, call)(*args, carry_1, 0.0, DT, ARGS, **kw)
        carry_s = tuple({k: v.map(torch.clone) for k, v in c.items()}
                        for c in carry_s)
        carry_1 = tuple({k: v.clone() for k, v in c.items()}
                        for c in carry_1)
        for got, ref in zip(carry_s, carry_1):
            for k in ref:
                assert isinstance(got[k], pt.ShardedArray)
                np.testing.assert_array_equal(d.gather_array(got[k]),
                                              ref[k].numpy(),
                                              err_msg=f"{call} {k}")
    got = _gather(sh.step(pt.shard_state(d, state), 0.0, DT, ARGS))
    ref = one.step(pt.state_from_numpy(state, device="cpu"), 0.0, DT, ARGS)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k].numpy())
    fn = sh.multi_step_fn(2)
    got = _gather(fn(pt.shard_state(d, state), 0.0, DT, ARGS))
    ref = one.multi_step(pt.state_from_numpy(state, device="cpu"), 2, 0.0,
                         DT, ARGS)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k].numpy())


def test_kernel_tier_report_counts_sharded_launches():
    """The tier report names the sharded launches a 2-step window makes
    on every block (RK54: 5 pairs)."""
    d = _decomp((2, 1, 1))
    rep = _port(d, overlap=True).kernel_tier_report()
    assert rep["proc_shape"] == [2, 1, 1]
    assert rep["sharded_launches_per_2_steps"] == {
        "fused_pair:interior": 10, "fused_pair:shell": 20}
    rep = _port(_decomp((2, 2, 1))).kernel_tier_report()
    assert rep["sharded_launches_per_2_steps"] == {"fused_pair:xypad": 20}
    assert "proc_shape" not in _port().kernel_tier_report()


def test_refusals():
    """What the JAX package refuses, with its text; a chunk request on a
    sharded mesh warns and runs pairs. The sharded GW stepper, the sharded
    coupled driver and bf16 carries on a sharded stepper are no longer
    refused (tests/test_torch_sharded_gw.py, _coupled.py, _bf16.py hold
    them)."""
    with pytest.raises(NotImplementedError, match=r"x/y sharding"):
        _port(_decomp((2, 2, 2)))
    d = _decomp((2, 1, 1))
    assert _port(d, carry_dtype=torch.bfloat16).carry_dtype == torch.bfloat16
    sec = pt.ScalarSector(2, potential=potential)
    gw = pt.TensorPerturbationSector([sec])
    with pytest.raises(NotImplementedError, match=r"x/y sharding"):
        pt.FusedPreheatStepper(sec, gw, GRID, DX, H, device="cpu",
                               decomp=_decomp((1, 1, 2)))
    st = pt.FusedPreheatStepper(sec, gw, GRID, DX, H, device="cpu",
                                decomp=d, carry_dtype=torch.bfloat16)
    assert st.decomp is d and st.carry_dtype == torch.bfloat16
    assert pt.FusedPreheatStepper(sec, gw, GRID, DX, H, device="cpu",
                                  decomp=d).decomp is d
    st = _port(d)
    exp = pt.Expansion(1.0, pt.LowStorageRK54)
    out = st.coupled_multi_step(pt.shard_state(d, _state()), 1, exp, 0.0, DT)
    assert all(isinstance(v, pt.ShardedArray) for v in out.values())
    with pytest.warns(UserWarning, match=r"whole-RK-chunk fusion disabled "
                      r"\(sharded mesh \(2,1\): chunk windows need "
                      r"ceil\(depth/2\)\*h-wide halos\); step\(\) will run "
                      r"pair-stage fused kernels"):
        chunked = _port(d, chunk_stages=4)
    assert chunked.kernel_tier_report()["tier"] == "pair"
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert _port(_decomp((1, 1, 1)), chunk_stages=4)._chunk_depth == 4
    with pytest.raises(ValueError, match="ShardedArrays"):
        st.multi_step(pt.state_from_numpy(_state(), device="cpu"), 1, 0.0,
                      DT, ARGS)
    with pytest.raises(ValueError, match="runs on"):
        _port().multi_step(pt.shard_state(d, _state()), 1, 0.0, DT, ARGS)


@pytest.mark.parametrize("mesh", [(2, 1, 1), (2, 2, 1)], ids=["211", "221"])
def test_reduction_matches_jax(mesh):
    """Reduction (the sector's energy reducers with get_rho_and_p) and
    FieldStatistics of a sharded state vs the JAX package's on its sharded
    arrays: 1e-13 relative (per-block partials in rank order against
    XLA's order)."""
    state = _state(17)
    rng = np.random.default_rng(2)
    lap = rng.standard_normal((2,) + GRID)
    dj = ps.DomainDecomposition(mesh,
                                devices=jax.devices()[:int(np.prod(mesh))])
    dp = _decomp(mesh)
    jsec = ps.ScalarSector(2, potential=potential)
    tsec = pt.ScalarSector(2, potential=potential)
    ref = ps.Reduction(dj, jsec, callback=ps.get_rho_and_p)(
        f=dj.shard(state["f"]), dfdt=dj.shard(state["dfdt"]),
        lap_f=dj.shard(lap), a=1.3)
    got = pt.Reduction(tsec, callback=pt.get_rho_and_p)(
        f=dp.shard(state["f"]), dfdt=dp.shard(state["dfdt"]),
        lap_f=dp.shard(lap), a=1.3)
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(got[k], np.asarray(ref[k]), rtol=1e-13,
                                   atol=0, err_msg=k)
    stats = pt.FieldStatistics(max_min=True)(dp.shard(state["f"]))
    jstats = ps.FieldStatistics(dj, max_min=True)(f=dj.shard(state["f"]))
    for k in jstats:
        np.testing.assert_allclose(stats[k], np.asarray(jstats[k]),
                                   rtol=1e-13, atol=1e-15, err_msg=k)
