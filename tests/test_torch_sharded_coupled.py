"""The port's energy-coupled driver on sharded states,
``FusedScalarStepper(decomp=...).coupled_multi_step`` (every shard a CPU
tensor here, the kernels' plain versions), against the JAX package's sharded
coupled driver on its virtual CPU devices (interpret mode) and against the
port's own single-device driver.

On the CPU each block's energy sums are finished on their own and added in
rank order, as the JAX package's ``psum`` does; the card's padded launches
place every block's partials where the whole lattice's launch does, so
there the sharded chunk equals the single-device one bit for bit
(tests/test_torch_kernels.py, chip_smoke.py). The JAX sharded chunks cost
2-8 s each here, so they are computed once per module."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pystella_tpu as ps
import pystella_tpu_torch as pt
from pystella_tpu.ops.fused import FusedScalarStepper as JaxFused

GRID, H, DX, DT = (16, 16, 16), 2, (0.3, 0.25, 0.2), 0.01
MESHES = [(2, 1, 1), (2, 2, 1)]
MESH_IDS = ["211", "221"]
#: (nsteps, pair): nsteps 1 ends on the odd trailing stage after a
#: mid-chunk finalize, nsteps 2 on a deferred pair and the chunk-end one
RUNS = [(1, True), (1, False), (2, True), (2, False)]
RUN_IDS = ["n1-pair", "n1-single", "n2-pair", "n2-single"]


def potential(f):
    # tests/test_fused.py's potential
    return 0.5 * 1.2e-2 * f[0] ** 2 + 0.125 * f[0] ** 2 * f[1] ** 2


def _state(dtype=np.float64):
    # the state of tests/test_fused.py:336-365 (the JAX sharded coupled test)
    rng = np.random.default_rng(31)
    return {"f": (0.1 * rng.standard_normal((2,) + GRID)).astype(dtype),
            "dfdt": (0.01 * rng.standard_normal((2,) + GRID)).astype(dtype)}


def _decomp(mesh):
    return pt.DomainDecomposition(mesh, devices=["cpu"] * int(np.prod(mesh)))


def _port(decomp=None, dtype=torch.float64, **kw):
    return pt.FusedScalarStepper(pt.ScalarSector(2, potential=potential),
                                 GRID, DX, H, dtype=dtype, device="cpu",
                                 decomp=decomp, **kw)


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.max(np.abs(got - ref)) / np.max(np.abs(ref))


def _background():
    """The entry background of every chunk here: unit energy."""
    exp = pt.Expansion(1.0, pt.LowStorageRK54)
    return {"a": float(exp.a), "adot": float(exp.adot), "mpl": exp.mpl}


def _sharded_run(mesh, nsteps, pair, dtype=torch.float64, overlap=None):
    """The port's sharded chunk: the gathered final state, a and adot."""
    d = _decomp(mesh)
    exp = pt.expansion_from_numpy(_background())
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    st = _port(d, dtype, overlap=overlap)
    out = st.coupled_multi_step(pt.shard_state(d, _state(np_dtype)), nsteps,
                                exp, 0.0, DT, pair=pair)
    return pt.to_numpy(out), float(exp.a), float(exp.adot)


@pytest.fixture(scope="module")
def jax_ref():
    """The JAX sharded coupled chunk (bx=4, by=8, interpret mode) on each
    mesh and run in f64, and nsteps=2 with pairs in f32 on (2, 1, 1)."""
    out = {}
    for mesh in MESHES:
        d = ps.DomainDecomposition(
            mesh, devices=jax.devices()[:int(np.prod(mesh))])
        for dtype in (jnp.float64, jnp.float32):
            if dtype == jnp.float32 and mesh != (2, 1, 1):
                continue
            st = JaxFused(ps.ScalarSector(2, potential=potential), d, GRID,
                          DX, H, dtype=dtype, bx=4, by=8)
            np_dtype = np.float64 if dtype == jnp.float64 else np.float32
            runs = RUNS if dtype == jnp.float64 else [(2, True)]
            for nsteps, pair in runs:
                exp = ps.Expansion(1.0, ps.LowStorageRK54)
                res = st.coupled_multi_step(
                    {k: d.shard(v) for k, v in _state(np_dtype).items()},
                    nsteps, exp, 0.0, DT, pair=pair)
                out[mesh, nsteps, pair, np_dtype] = (
                    {k: np.asarray(v) for k, v in res.items()},
                    float(exp.a), float(exp.adot))
    return out


@pytest.fixture(scope="module")
def single():
    """The port's single-device chunks of every run, f64."""
    out = {}
    st = _port()
    for nsteps, pair in RUNS:
        exp = pt.expansion_from_numpy(_background())
        res = st.coupled_multi_step(pt.state_from_numpy(_state(),
                                                        device="cpu"),
                                    nsteps, exp, 0.0, DT, pair=pair)
        out[nsteps, pair] = ({k: v.numpy().copy() for k, v in res.items()},
                             float(exp.a), float(exp.adot))
    return out


@pytest.mark.parametrize("nsteps,pair", RUNS, ids=RUN_IDS)
@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
def test_coupled_matches_jax_sharded(jax_ref, mesh, nsteps, pair):
    """The sharded coupled chunk vs the JAX package's on the same mesh, from
    the same background, f64: f and dfdt to 1e-12 relative, a and adot to
    1e-13 (the energy sums add in another order)."""
    got, a, adot = _sharded_run(mesh, nsteps, pair)
    ref, a_ref, adot_ref = jax_ref[mesh, nsteps, pair, np.float64]
    for k in ("f", "dfdt"):
        assert _rel(got[k], ref[k]) < 1e-12, k
    assert abs(a - a_ref) / a_ref < 1e-13
    assert abs(adot - adot_ref) / abs(adot_ref) < 1e-13


def test_coupled_matches_jax_sharded_f32(jax_ref):
    """The same in f32 on (2, 1, 1), nsteps 2 with pairs: a few ulp a stage
    (2e-6 relative over ten stages, the bar of the f32 multi_step
    comparison); a and adot, integrated in float64 by both packages from
    the f32 sums, to 1e-6."""
    got, a, adot = _sharded_run((2, 1, 1), 2, True, torch.float32)
    ref, a_ref, adot_ref = jax_ref[(2, 1, 1), 2, True, np.float32]
    for k in ("f", "dfdt"):
        assert got[k].dtype == np.float32
        assert _rel(got[k], ref[k]) < 2e-6, k
    assert abs(a - a_ref) / a_ref < 1e-6
    assert abs(adot - adot_ref) / abs(adot_ref) < 1e-6


@pytest.mark.parametrize("nsteps,pair", RUNS, ids=RUN_IDS)
@pytest.mark.parametrize("mesh", MESHES + [(4, 1, 1), (1, 2, 1)],
                         ids=MESH_IDS + ["411", "121"])
def test_coupled_equals_single_device(single, mesh, nsteps, pair):
    """The sharded chunk vs the port's single-device one: every lattice
    output is the same arithmetic (bit for bit, tests/test_torch_sharded_
    fused.py), and only the energy sums' order differs on the CPU (per
    block, then in rank order), so f, dfdt, a and adot agree to 1e-13."""
    got, a, adot = _sharded_run(mesh, nsteps, pair)
    ref, a_ref, adot_ref = single[nsteps, pair]
    for k in ("f", "dfdt"):
        assert _rel(got[k], ref[k]) < 1e-13, k
    assert abs(a - a_ref) / a_ref < 1e-13
    assert abs(adot - adot_ref) / abs(adot_ref) < 1e-13


@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
def test_pair_default_is_pair(mesh):
    """``pair=None`` runs the deferred-drag pairs where they are available
    (this model: hubble-free, RK54): the same chunk as ``pair=True`` bit
    for bit, also with the overlap asked for (the sum kernels keep the
    padded launch)."""
    got, a, adot = _sharded_run(mesh, 2, None, overlap=True)
    ref, a_ref, adot_ref = _sharded_run(mesh, 2, True)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    assert (a, adot) == (a_ref, adot_ref)


def test_sharded_sum_launches_and_report():
    """The sum kernels take the padded launch even where the overlap splits
    the others, and the tier report says so and names the sums' order
    (the plain versions, on the CPU: rank order); a coupled chunk
    returns sharded arrays of the decomposition."""
    d = _decomp((2, 1, 1))
    st = _port(d, overlap=True)
    assert st.sharded_kinds() == {"interior": 1, "shell": 2}
    for name in ("fused_stage_energy", "coupled_pair",
                 "coupled_pair_deferred"):
        assert st.sharded_kinds(name) == {"xpad": 1}
    rep = st.kernel_tier_report()
    assert rep["sum_kernel_launch_kinds"] == {"xpad": 1}
    assert rep["sum_order"] == "rank"
    assert _port(_decomp((2, 2, 1))).kernel_tier_report()[
        "sum_kernel_launch_kinds"] == {"xypad": 1}
    assert "sum_order" not in _port().kernel_tier_report()
    out = st.coupled_multi_step(pt.shard_state(d, _state()), 1,
                                pt.Expansion(1.0, pt.LowStorageRK54), 0.0,
                                DT)
    assert all(isinstance(v, pt.ShardedArray) and v.decomp is d
               for v in out.values())
