"""The port's numerics sentinel (obs/sentinel.py, its field statistics by
K15's plain version on the CPU), HealthMonitor and the in-step health
vectors (``Stepper.step_with_health``, ``multi_step(sentinel=)``,
``coupled_multi_step(sentinel=)``) against the JAX package's on shared
numpy states, and the port's own identities: the stepped state bit for bit
the one without the sentinel, the vector the sentinel's ``compute`` on it,
a (2, 2, 1) decomposition the single-device vector bit for bit.

Tolerances against the JAX package: ``finite`` and ``max_abs`` equal
(``max_abs`` where the field holds no NaN), ``rms`` and the invariants
within 4e-6 relative in f32 and 1e-12 in f64. The JAX package sums an f32
field's squares in float32 (XLA's CPU reduction), which puts its own rms
up to 1.12e-6 from the float64 sum of the same squares at 2 x 16^3
(seeds 1, 2, 3, 41); the port sums them in float64, and its rms is held
within 1e-13 of numpy's float64 sum of the same f32 squares."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pystella_tpu as ps
import pystella_tpu_torch as pt
from pystella_tpu.ops.fused import FusedScalarStepper as JaxFused

GRID, H, DX, DT = (16, 16, 16), 2, (0.3, 0.25, 0.2), 0.01
TOL = {np.float32: 4e-6, np.float64: 1e-12}
#: the port's rms against numpy's float64 sum of the same squares
EXACT_TOL = 1e-13
ARGS = {"a": 1.0, "hubble": 0.0}


def fused_test_potential(f):
    # tests/test_fused.py's potential
    return 0.5 * 1.2e-2 * f[0] ** 2 + 0.125 * f[0] ** 2 * f[1] ** 2


def _state(dtype=np.float64, seed=41):
    rng = np.random.default_rng(seed)
    return {"f": rng.standard_normal((2,) + GRID).astype(dtype),
            "dfdt": (0.3 * rng.standard_normal((2,) + GRID)).astype(dtype)}


def _poisoned(dtype, kind):
    """The cases of tests/test_sentinel.py:49-86: a NaN, +-inf, and finite
    f32 values near 1e20 whose squares overflow."""
    st = _state(dtype)
    if kind == "big":
        st["f"] = np.full_like(st["f"], 1e20)
    elif kind != "clean":
        st["dfdt"][1, 2, 3, 4] = {"nan": np.nan, "inf": np.inf,
                                  "-inf": -np.inf}[kind]
    return st


def _kin(pkg, sector):
    def kin(st, aux):
        return sector.energy_means(st["f"], st["dfdt"])["kinetic"]
    return kin


def _hub(st, aux):
    return aux["adot"] / aux["a"]


def _sentinels(dtype, invariants=("kin",)):
    """The JAX and port sentinels of one state layout, vectors in the
    state's dtype."""
    jsec = ps.ScalarSector(2, potential=fused_test_potential)
    tsec = pt.ScalarSector(2, potential=fused_test_potential)
    jinv = {"kin": _kin(ps, jsec), "hub": _hub}
    tinv = {"kin": _kin(pt, tsec), "hub": _hub}
    names = ("dfdt", "f")
    js = ps.obs.Sentinel(names, {k: jinv[k] for k in invariants},
                         dtype=dtype)
    ts = pt.obs.Sentinel(names, {k: tinv[k] for k in invariants},
                         dtype=dtype)
    return js, ts


def _close(g, r, tol):
    """Within ``tol`` relative where finite, the same non-finite value
    where not."""
    if np.isfinite(r):
        return abs(g - r) <= tol * abs(r)
    return str(g) == str(r)


def _agrees(got, ref, dtype, fields_nan=(), same_state=True):
    """Hold a port vector to a JAX one (both decoded): ``max_abs`` equal on
    the same state (within the tolerance on states stepped by each
    package), except in ``fields_nan``."""
    tol = TOL[dtype]
    assert set(got["fields"]) == set(ref["fields"])
    for name, r in ref["fields"].items():
        g = got["fields"][name]
        assert g["finite"] == r["finite"], name
        if name not in fields_nan:
            assert (g["max_abs"] == r["max_abs"] if same_state
                    else _close(g["max_abs"], r["max_abs"], tol)), name
        assert _close(g["rms"], r["rms"], tol), name
    for name, r in ref["invariants"].items():
        assert _close(got["invariants"][name], r, tol), name


# -- the health vector -------------------------------------------------------

@pytest.mark.parametrize("kind", ["clean", "nan", "inf", "-inf", "big"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["f32", "f64"])
def test_health_vector_matches_jax(dtype, kind):
    """Sentinel.compute on the same numpy state in both packages: equal
    slot names, finite and max_abs (where no NaN), rms and the invariant
    within the tolerance; problems() names the same fields."""
    js, ts = _sentinels(dtype)
    assert ts.slot_names == js.slot_names and ts.size == js.size
    st = _poisoned(dtype, kind)
    ref = js.decode(js.compute_jit({k: jnp.asarray(v)
                                    for k, v in st.items()}))
    got = ts.decode(ts.compute_jit(pt.state_from_numpy(st, device="cpu")))
    _agrees(got, ref, dtype, fields_nan=("dfdt",) if kind == "nan"
            else ())
    assert ts.problems(got)[0] == js.problems(ref)[0]
    # the port's rms against numpy's float64 sum of the field's squares
    # (each formed in the field's dtype)
    t64 = pt.obs.Sentinel(ts.fields, dtype=torch.float64)
    exact = t64.decode(t64.compute(pt.state_from_numpy(st, device="cpu")))
    for name in ts.fields:
        x = st[name]
        rms = np.sqrt(np.sum((x * x).astype(np.float64)) / x.size)
        if np.isfinite(rms):
            got_rms = exact["fields"][name]["rms"]
            assert abs(got_rms - rms) <= EXACT_TOL * rms, name
    # f32 values near 1e20: the squares overflow, which is not divergence
    if kind == "big" and dtype == np.float32:
        assert got["fields"]["f"]["finite"] and not ts.problems(got)[0]


def test_health_vector_float32_vector_of_f64_state():
    """The default float32 vector of an f64 state: the values rounded as
    the JAX package rounds them."""
    st = _state(np.float64)
    js = ps.obs.Sentinel.for_state(st)
    ts = pt.obs.Sentinel.for_state(st)
    ref = np.asarray(js.compute_jit({k: jnp.asarray(v)
                                     for k, v in st.items()}))
    got = ts.compute(pt.state_from_numpy(st, device="cpu"))
    assert got.dtype == torch.float32 and ref.dtype == np.float32
    assert np.array_equal(got.numpy()[[0, 1, 3, 4]], ref[[0, 1, 3, 4]])
    assert np.allclose(got.numpy(), ref, rtol=1e-7, atol=0)


def test_sharded_vector_is_single_device():
    """A (2, 2, 1) decomposition on the CPU gives the single-device vector
    bit for bit, NaN sites included."""
    _, ts = _sentinels(np.float64, ())
    st = _poisoned(np.float64, "clean")
    st["f"][0, 9, 2, 5] = np.nan
    one = ts.compute(pt.state_from_numpy(st, device="cpu"))
    d = pt.DomainDecomposition((2, 2, 1), devices=["cpu"] * 4)
    many = ts.compute(pt.shard_state(d, st))
    assert torch.equal(one.nan_to_num(7.0), many.nan_to_num(7.0))


def test_named_leaves_match_jax():
    """Dotted leaf names of nested states in the JAX package's order."""
    st = {"b": {"y": np.zeros(2), "x": [np.ones(1), np.ones(1)]},
          "a": np.zeros(3), "n": None}
    jnames = list(ps.obs.sentinel.named_leaves(
        jax.tree_util.tree_map(jnp.asarray, st)))
    tnames = list(pt.obs.sentinel.named_leaves(st))
    assert tnames == jnames == ["a", "b.x.0", "b.x.1", "b.y"]


def test_compute_members_rows_are_compute():
    """The member axis: row i of compute_members is compute of member i."""
    _, ts = _sentinels(np.float64)
    st = [pt.state_from_numpy(_state(np.float64, s), device="cpu")
          for s in (1, 2, 3)]
    batched = {k: torch.stack([s[k] for s in st]) for k in ("f", "dfdt")}
    mat = ts.compute_members(batched)
    assert mat.shape == (3, ts.size)
    for i, s in enumerate(st):
        assert torch.equal(mat[i], ts.compute(s))
    assert len(ts.decode_members(mat)) == 3


# -- monitor semantics (tests/test_sentinel.py:118-176, test_monitor.py) ----

def _const(val_f=3.0, val_df=0.0, shape=(2, 4, 4, 4)):
    return {"f": torch.full(shape, val_f, dtype=torch.float32),
            "dfdt": torch.full(shape, val_df, dtype=torch.float32)}


def test_monitor_polls_lag_behind_driver():
    sen = pt.obs.Sentinel.for_state(_const())
    mon = pt.obs.SentinelMonitor(sen, every=5)
    for step in range(1, 21):
        mon.observe(step, _const())
        mon.poll()
        assert mon.pending_steps == list(range(max(1, step - 5 + 1),
                                               step + 1))
        if mon.checked_through is not None:
            assert mon.checked_through <= step - 5
    assert mon.checked_through == 15
    assert mon.flush() == 5
    assert mon.checked_through == 20 and not mon.pending_steps


def test_monitor_trip_reports_actual_step_and_fields():
    sen = pt.obs.Sentinel.for_state(_const())
    mon = pt.obs.SentinelMonitor(sen, every=3)
    bad = _const()
    bad["dfdt"][0, 0, 0, 0] = float("inf")
    for step in range(1, 8):
        mon.observe(step, _const())
        mon.poll()
    for step in range(8, 12):
        mon.observe(step, bad)
        if step < 11:
            mon.poll()
    with pytest.raises(pt.SimulationDiverged) as exc:
        mon.poll()
    assert exc.value.step == 8
    assert exc.value.bad_fields == ("dfdt",)
    assert mon.history[-1]["step"] == 8


def test_monitor_history_ring_and_discard():
    sen = pt.obs.Sentinel.for_state(_const())
    mon = pt.obs.SentinelMonitor(sen, every=0, history=4)
    for step in range(10):
        mon.observe(step, _const())
        mon.poll()
    assert [h["step"] for h in mon.history] == [6, 7, 8, 9]
    mon2 = pt.obs.SentinelMonitor(sen, every=5)
    for step in range(3):
        mon2.observe(step, _const())
    assert mon2.discard() == 3 and not mon2.pending_steps


def test_health_monitor_sync_and_check_now():
    """The legacy sync contract, check_now's step, the magnitude bound and
    the async trip (tests/test_monitor.py)."""
    mon = pt.HealthMonitor(every=2)
    ok = {"f": torch.ones(4, 4, 4), "dfdt": torch.zeros(4, 4, 4)}
    assert mon(0, ok) is True and mon(1, ok) is False and mon(2, ok)
    nan = {"f": torch.full((4, 4, 4), float("nan"))}
    with pytest.raises(pt.SimulationDiverged) as exc:
        pt.HealthMonitor(every=1)(3, {**ok, "dfdt": nan["f"]})
    assert exc.value.step == 3 and exc.value.bad_fields == ("dfdt",)
    with pytest.raises(pt.SimulationDiverged) as exc:
        pt.HealthMonitor(every=50).check_now(nan, step=1234)
    assert exc.value.step == 1234
    bound = pt.HealthMonitor(every=1, max_abs=10.0)
    with pytest.raises(pt.SimulationDiverged):
        bound(0, {"f": torch.full((2, 2, 2), 100.0)})
    assert bound(0, {"f": torch.full((2, 2, 2), 5.0)})
    amon = pt.HealthMonitor(every=2, max_abs=10.0)
    for step in range(1, 5):
        amon.observe(step, {"f": torch.ones(4, 4, 4)})
        amon.poll()
        if amon.checked_through is not None:
            assert amon.checked_through <= step - 2
    amon.observe(5, {"f": torch.full((4, 4, 4), 100.0)})
    with pytest.raises(pt.SimulationDiverged) as exc:
        amon.flush()
    assert exc.value.step == 5 and exc.value.bad_fields == ("f",)


def test_health_monitor_push_matches_observe():
    """push() of a vector from the monitor's own sentinel checks it as
    observe() would."""
    mon = pt.HealthMonitor(every=0)
    st = _const(2.0, 0.5)
    vec = mon.sentinel_for(st).compute(st)
    mon.push(7, vec)
    mon.poll()
    ref = pt.HealthMonitor(every=0)
    ref.observe(7, st)
    ref.poll()
    assert mon.history == ref.history


# -- the in-step vectors -----------------------------------------------------

def test_step_with_health_is_step_plus_compute():
    _, ts = _sentinels(np.float64)

    def rhs(st, t, **kw):
        return {"f": st["dfdt"], "dfdt": -st["f"]}
    stepper = pt.LowStorageRK54(rhs, dt=0.01)
    st = pt.state_from_numpy(_state(), device="cpu")
    new, hv = stepper.step_with_health(st, ts, 0.0, 0.01)
    ref = stepper.step(st, 0.0, 0.01)
    assert all(torch.equal(new[k], ref[k]) for k in ref)
    assert torch.equal(hv, ts.compute(ref))


def _port_stepper(gw=False, dtype=torch.float64, decomp=None):
    sector = pt.ScalarSector(2, potential=fused_test_potential)
    kw = dict(dtype=dtype, dt=DT, device="cpu", decomp=decomp)
    if gw:
        return pt.FusedPreheatStepper(
            sector, pt.TensorPerturbationSector([sector]), GRID, DX, H, **kw)
    return pt.FusedScalarStepper(sector, GRID, DX, H, **kw)


def _gw_state():
    st = _state()
    rng = np.random.default_rng(7)
    st["hij"] = 1e-3 * rng.standard_normal((6,) + GRID)
    st["dhijdt"] = 1e-4 * rng.standard_normal((6,) + GRID)
    return st


@pytest.mark.parametrize("gw", [False, True], ids=["scalar", "gw"])
def test_fused_sentinel_identities(gw):
    """multi_step(sentinel=) and coupled_multi_step(sentinel=): the state
    bit for bit the one without the sentinel, a and adot too, and the
    vector compute() on it; a (2, 2, 1) stepper's vector the single
    device's bit for bit."""
    st0 = _gw_state() if gw else _state()
    sen = pt.obs.Sentinel.for_state(st0, dtype=torch.float64)
    csen = pt.obs.Sentinel(sen.fields, {"hub": _hub}, dtype=torch.float64)
    stepper = _port_stepper(gw)

    def fresh():
        return pt.state_from_numpy(st0, device="cpu")
    ref = {k: v.clone() for k, v in stepper.multi_step(
        fresh(), 3, rhs_args=ARGS).items()}
    got, hv = stepper.multi_step(fresh(), 3, rhs_args=ARGS, sentinel=sen)
    assert all(torch.equal(got[k], ref[k]) for k in ref)
    assert torch.equal(hv, sen.compute(got))
    exps = [pt.Expansion(1.0, pt.LowStorageRK54) for _ in range(2)]
    cref = {k: v.clone() for k, v in stepper.coupled_multi_step(
        fresh(), 1, exps[0], 0.0, DT).items()}
    cgot, chv = stepper.coupled_multi_step(fresh(), 1, exps[1], 0.0, DT,
                                           sentinel=csen)
    assert all(torch.equal(cgot[k], cref[k]) for k in cref)
    assert (exps[0].a, exps[0].adot) == (exps[1].a, exps[1].adot)
    assert torch.equal(chv, csen.compute(cgot, {"a": float(exps[1].a),
                                                "adot": float(
                                                    exps[1].adot)}))
    d = pt.DomainDecomposition((2, 2, 1), devices=["cpu"] * 4)
    sharded = _port_stepper(gw, decomp=d)
    _, shv = sharded.multi_step(pt.shard_state(d, st0), 3, rhs_args=ARGS,
                                sentinel=sen)
    assert torch.equal(shv, hv)


@pytest.fixture(scope="module")
def jax_fused_vectors():
    """The JAX fused stepper's multi_step(sentinel=) (3 steps) and
    coupled_multi_step(sentinel=) (1 step, pairs) vectors on the f64
    state, in interpret mode, once per module."""
    decomp = ps.DomainDecomposition((1, 1, 1), devices=jax.devices()[:1])
    js, _ = _sentinels(np.float64)
    jc, _ = _sentinels(np.float64, ("kin", "hub"))
    fused = JaxFused(ps.ScalarSector(2, potential=fused_test_potential),
                     decomp, GRID, DX, H, dtype=jnp.float64, bx=4, by=8)
    st = {k: jnp.asarray(v) for k, v in _state().items()}
    _, hv = fused.multi_step(st, 3, 0.0, DT, rhs_args=ARGS, sentinel=js)
    exp = ps.Expansion(1.0, ps.LowStorageRK54)
    st = {k: jnp.asarray(v) for k, v in _state().items()}
    _, chv = fused.coupled_multi_step(st, 1, exp, 0.0, DT, pair=True,
                                      sentinel=jc)
    return js.decode(hv), jc.decode(chv)


def test_fused_vectors_match_jax(jax_fused_vectors):
    """The port's multi_step(sentinel=) and coupled_multi_step(sentinel=)
    vectors (scalar stepper, f64) within the f64 tolerance of the JAX
    package's on the same state."""
    ref, cref = jax_fused_vectors
    _, ts = _sentinels(np.float64)
    _, tc = _sentinels(np.float64, ("kin", "hub"))
    stepper = _port_stepper()
    _, hv = stepper.multi_step(pt.state_from_numpy(_state(), device="cpu"),
                               3, 0.0, DT, rhs_args=ARGS, sentinel=ts)
    _agrees(ts.decode(hv), ref, np.float64, same_state=False)
    exp = pt.Expansion(1.0, pt.LowStorageRK54)
    _, chv = stepper.coupled_multi_step(
        pt.state_from_numpy(_state(), device="cpu"), 1, exp, 0.0, DT,
        pair=True, sentinel=tc)
    _agrees(tc.decode(chv), cref, np.float64, same_state=False)
