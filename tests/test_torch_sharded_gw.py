"""The port's gravitational-wave stepper on sharded states,
``FusedPreheatStepper(decomp=...)`` (every shard a CPU tensor here, the
kernels' plain versions): ``step``, ``multi_step``, ``multi_step_fn`` and
``coupled_multi_step`` against the JAX package's sharded GW stepper on its
virtual CPU devices (interpret mode) and against the port's own
single-device GW stepper; ``kernel_tier_report``.

The JAX package's overlapped path is bit-exact with its padded one
(tests/test_overlap.py), so the port's padded and overlapped runs are both
held to the JAX padded run. The JAX sharded GW calls cost 6-11 s each here,
so they are computed once per module."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pystella_tpu as ps
import pystella_tpu_torch as pt
from pystella_tpu.ops.fused import FusedPreheatStepper as JaxPreheat

GRID, H, DX, DT = (16, 16, 16), 2, (0.3, 0.25, 0.2), 0.01
ARGS = {"a": 1.1, "hubble": 0.2}
NAMES = ("f", "dfdt", "hij", "dhijdt")
#: (mesh, overlap) of the port's runs
CASES = [((2, 1, 1), False), ((2, 1, 1), True), ((2, 2, 1), False)]
CASE_IDS = ["211-padded", "211-overlap", "221"]
#: the stepping calls: step, and multi_step(2) (5 pairs across the step
#: boundary)
CALLS = ["step", "multi_step"]


def potential(f):
    # tests/test_fused.py's potential
    return 0.5 * 1.2e-2 * f[0] ** 2 + 0.125 * f[0] ** 2 * f[1] ** 2


def _state():
    # the state of tests/test_fused.py:265-271
    rng = np.random.default_rng(29)
    return {"f": 0.1 * rng.standard_normal((2,) + GRID),
            "dfdt": 0.01 * rng.standard_normal((2,) + GRID),
            "hij": 1e-3 * rng.standard_normal((6,) + GRID),
            "dhijdt": 1e-4 * rng.standard_normal((6,) + GRID)}


def _decomp(mesh):
    return pt.DomainDecomposition(mesh, devices=["cpu"] * int(np.prod(mesh)))


def _port(decomp=None, **kw):
    sector = pt.ScalarSector(2, potential=potential)
    return pt.FusedPreheatStepper(sector, pt.TensorPerturbationSector(
        [sector]), GRID, DX, H, dtype=torch.float64, device="cpu",
        decomp=decomp, **kw)


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.max(np.abs(got - ref)) / max(np.max(np.abs(ref)), 1e-30)


def _call(st, state, call):
    if call == "step":
        return st.step(state, 0.0, DT, ARGS)
    return st.multi_step(state, 2, 0.0, DT, ARGS)


def _background():
    exp = pt.Expansion(1.0, pt.LowStorageRK54)
    return {"a": float(exp.a), "adot": float(exp.adot), "mpl": exp.mpl}


def _coupled(st, state, nsteps, pair=None):
    exp = pt.expansion_from_numpy(_background())
    out = st.coupled_multi_step(state, nsteps, exp, 0.0, DT, pair=pair)
    out = (pt.to_numpy(out) if st.decomp is not None
           else {k: v.numpy().copy() for k, v in out.items()})
    return out, float(exp.a), float(exp.adot)


@pytest.fixture(scope="module")
def jax_ref():
    """The JAX sharded GW stepper (bx=4, by=8, interpret mode, padded):
    step and multi_step(2) on (2, 1, 1) and (2, 2, 1); the coupled chunk
    (nsteps 1: two deferred pairs, the finalize and the odd tail) on
    (2, 1, 1)."""
    out = {}
    sector = ps.ScalarSector(2, potential=potential)
    gw = ps.TensorPerturbationSector([sector])
    for mesh in ((2, 1, 1), (2, 2, 1)):
        d = ps.DomainDecomposition(
            mesh, devices=jax.devices()[:int(np.prod(mesh))])
        st = JaxPreheat(sector, gw, d, GRID, DX, H, dtype=jnp.float64, bx=4,
                        by=8, overlap=False)
        for call in CALLS:
            res = _call(st, {k: d.shard(v) for k, v in _state().items()},
                        call)
            out[mesh, call] = {k: np.asarray(v) for k, v in res.items()}
        if mesh == (2, 1, 1):
            exp = ps.Expansion(1.0, ps.LowStorageRK54)
            res = st.coupled_multi_step(
                {k: d.shard(v) for k, v in _state().items()}, 1, exp, 0.0,
                DT)
            out[mesh, "coupled"] = ({k: np.asarray(v) for k, v in
                                     res.items()}, float(exp.a),
                                    float(exp.adot))
    return out


@pytest.fixture(scope="module")
def single():
    """The port's single-device GW stepper: step, multi_step(2) and the
    coupled chunks of nsteps 1 and 2."""
    st = _port()
    out = {}
    for call in CALLS:
        res = _call(st, pt.state_from_numpy(_state(), device="cpu"), call)
        out[call] = {k: v.numpy().copy() for k, v in res.items()}
    for nsteps in (1, 2):
        out["coupled", nsteps] = _coupled(
            st, pt.state_from_numpy(_state(), device="cpu"), nsteps)
    return out


@pytest.mark.parametrize("call", CALLS)
@pytest.mark.parametrize("mesh,overlap", CASES, ids=CASE_IDS)
def test_stepping_matches_jax_sharded(jax_ref, mesh, overlap, call):
    """step and multi_step(2) on a sharded GW state vs the JAX sharded
    stepper, f64: every field to 1e-12 relative."""
    d = _decomp(mesh)
    got = pt.to_numpy(_call(_port(d, overlap=overlap),
                            pt.shard_state(d, _state()), call))
    for k in NAMES:
        assert _rel(got[k], jax_ref[mesh, call][k]) < 1e-12, k


@pytest.mark.parametrize("call", CALLS)
@pytest.mark.parametrize("mesh,overlap", CASES + [((4, 1, 1), True),
                                                  ((1, 2, 1), False)],
                         ids=CASE_IDS + ["411-overlap", "121"])
def test_stepping_equals_single_device(single, mesh, overlap, call):
    """The sharded step and multi_step(2) equal the single-device GW
    stepper's bit for bit: every launch (padded, interior or shell) reads
    the same tap values in the same order. (4, 1, 1) at 16^3 leaves blocks
    thinner than 3h: the padded launch, the overlap asked for."""
    d = _decomp(mesh)
    st = _port(d, overlap=overlap)
    got = pt.to_numpy(_call(st, pt.shard_state(d, _state()), call))
    for k in NAMES:
        np.testing.assert_array_equal(got[k], single[call][k], err_msg=k)
    want = {"interior": 1, "shell": 2} if mesh == (2, 1, 1) and overlap \
        else {{(2, 1, 1): "xpad", (4, 1, 1): "xpad", (1, 2, 1): "ypad",
               (2, 2, 1): "xypad"}[mesh]: 1}
    assert st.sharded_kinds() == want


def test_coupled_matches_jax_sharded(jax_ref):
    """The sharded GW coupled chunk (nsteps 1) on (2, 1, 1) vs the JAX
    package's, from the same background: every field to 1e-12 relative,
    a and adot to 1e-13."""
    d = _decomp((2, 1, 1))
    got, a, adot = _coupled(_port(d), pt.shard_state(d, _state()), 1)
    ref, a_ref, adot_ref = jax_ref[(2, 1, 1), "coupled"]
    for k in NAMES:
        assert _rel(got[k], ref[k]) < 1e-12, k
    assert abs(a - a_ref) / a_ref < 1e-13
    assert abs(adot - adot_ref) / abs(adot_ref) < 1e-13


@pytest.mark.parametrize("nsteps", [1, 2])
@pytest.mark.parametrize("mesh,overlap", [((2, 1, 1), True),
                                          ((2, 2, 1), False)],
                         ids=["211-overlap", "221"])
def test_coupled_equals_single_device(single, mesh, overlap, nsteps):
    """The sharded GW coupled chunk vs the port's single-device one: the
    lattice arithmetic is the same, the energy sums add per block and then
    in rank order on the CPU: every field, a and adot to 1e-13."""
    d = _decomp(mesh)
    got, a, adot = _coupled(_port(d, overlap=overlap),
                            pt.shard_state(d, _state()), nsteps)
    ref, a_ref, adot_ref = single["coupled", nsteps]
    for k in NAMES:
        assert _rel(got[k], ref[k]) < 1e-13, k
    assert abs(a - a_ref) / a_ref < 1e-13
    assert abs(adot - adot_ref) / abs(adot_ref) < 1e-13


def test_coupled_single_stage_path(single):
    """``pair=False`` on a sharded GW stepper (K5' at every stage, padded)
    agrees with the deferred-drag pair path to 1e-12, as unsharded
    (tests/test_torch_preheat_coupled.py)."""
    d = _decomp((2, 1, 1))
    got, a, adot = _coupled(_port(d), pt.shard_state(d, _state()), 1,
                            pair=False)
    ref, a_ref, adot_ref = single["coupled", 1]
    for k in NAMES:
        assert _rel(got[k], ref[k]) < 1e-12, k
    assert abs(a - a_ref) / a_ref < 1e-13


def test_multi_step_fn_and_report(single):
    """multi_step_fn(2) on a sharded GW state equals multi_step(2) (bit for
    bit with the single-device one); the tier report counts the sharded
    pair launches of a 2-step window (RK54: 5 pairs a block) and the sum
    kernels' padded launch."""
    d = _decomp((2, 1, 1))
    st = _port(d, overlap=True)
    got = pt.to_numpy(st.multi_step_fn(2)(pt.shard_state(d, _state()),
                                               0.0, DT, ARGS))
    for k in NAMES:
        np.testing.assert_array_equal(got[k], single["multi_step"][k],
                                      err_msg=k)
    rep = st.kernel_tier_report()
    assert rep["tier"] == "pair" and rep["proc_shape"] == [2, 1, 1]
    assert rep["sharded_launches_per_2_steps"] == {
        "preheat_pair:interior": 10, "preheat_pair:shell": 20}
    assert rep["sum_kernel_launch_kinds"] == {"xpad": 1}
    assert rep["sum_order"] == "rank"
    rep = _port(_decomp((2, 2, 1))).kernel_tier_report()
    assert rep["sharded_launches_per_2_steps"] == {"preheat_pair:xypad": 20}
