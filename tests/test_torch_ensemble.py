"""The port's ensemble engine (pystella_tpu_torch.ensemble, the ensemble mesh
of parallel/decomp.py, Sentinel.compute_members) against the JAX package's
on shared numpy inputs, and the port's own identities. Mirrors
tests/test_ensemble.py.

- Mesh: the ``(ensemble, x, y, z)`` layouts and the decomposition's member
  placement and checks, on CPU devices, equal to the JAX package's.
- Map tier: bit for bit the port's sequential ``multi_step`` of each member
  (FusedScalarStepper and FusedPreheatStepper, f32 and bf16 carries);
  within 1e-12 relative of the JAX map tier (f64).
- Vmap tier: within rtol 1e-6, atol 1e-12 of sequential runs (f32; the
  JAX bar, tests/test_ensemble.py:98-123; they come out bit for bit on the
  CPU), one ``lap`` call a stage for the whole batch, within 1e-12 of the
  JAX vmap tier (f64); the (2, 2, 1) + ensemble layout within the JAX
  test's rtol 1e-5 of sequential spatially sharded runs.
- Health matrix: rows bit for bit the member's ``compute`` (a NaN member
  included), on a plain batch, a ShardedArray batch and a MemberArray
  batch; its decode equal to the JAX matrix's in ``finite`` and
  ``max_abs`` and within 1e-6 (f32) and 1e-12 (f64) in ``rms`` (the JAX
  package sums an f32 field's squares in float32, the port in float64).
- Monitor and driver: the JAX tests' eviction round trip, retire-time
  check, budget, final-chunk catch, mask policy, grouping and refill; the
  same driver run in both packages finishes the same seeds and evicts at
  the same steps with equal event kinds, steps and payload keys; a
  preempted and requeued member equals its uninterrupted run bit for bit.
- The decomposition's ``halo_exchanges`` and ``halo_bytes_exchanged``
  counters equal the JAX package's for one padded exchange.
"""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pystella_tpu as ps
import pystella_tpu_torch as pt
from pystella_tpu import obs as jobs
from pystella_tpu_torch import obs as tobs
from pystella_tpu_torch.ensemble import EnsembleMonitor, EnsembleStepper
from pystella_tpu_torch.obs.forensics import ForensicSink, load_bundle
from pystella_tpu_torch.obs.sentinel import SimulationDiverged
from pystella_tpu_torch.ops import derivs as tderivs

REPO = Path(__file__).resolve().parents[1]
GRID = (8, 8, 8)
CPU8 = ["cpu"] * 8


def _jax_rhs(state, t, m2):
    f, dfdt = state["f"], state["dfdt"]
    lap = sum(jnp.roll(f, 1, i) + jnp.roll(f, -1, i) - 2 * f
              for i in (-3, -2, -1))
    return {"f": dfdt, "dfdt": lap - m2 * f}


def _torch_rhs(state, t, m2):
    f, dfdt = state["f"], state["dfdt"]
    lap = sum(torch.roll(f, 1, i) + torch.roll(f, -1, i) - 2 * f
              for i in (-3, -2, -1))
    return {"f": dfdt, "dfdt": lap - m2 * f}


def _member(seed, shape=GRID, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return {
        "f": (1e-3 * rng.standard_normal((1,) + shape)).astype(dtype),
        "dfdt": (1e-4 * rng.standard_normal((1,) + shape)).astype(dtype),
    }


def _edecomp(ensemble_devices, proc_shape=(1, 1, 1), halo_shape=0):
    need = ensemble_devices * int(np.prod(proc_shape))
    mesh = pt.ensemble_mesh(proc_shape=proc_shape,
                            ensemble_devices=ensemble_devices,
                            devices=["cpu"] * need)
    return pt.DomainDecomposition(mesh=mesh, halo_shape=halo_shape,
                                  ensemble_axis=mesh.axis_names[0])


def _t(tree):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in tree.items()}


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


# -- mesh / decomposition ---------------------------------------------------

def test_ensemble_mesh_layout():
    """(ensemble, x, y, z) mesh shapes: pure member packing uses every
    device along the leading axis; a spatial proc_shape splits them; the
    same shapes as the JAX package's on its 8 CPU devices."""
    mesh = pt.ensemble_mesh(devices=CPU8)
    assert mesh.axis_names == ("ensemble", "x", "y", "z")
    assert mesh.devices.shape == (8, 1, 1, 1)
    assert mesh.devices.shape == ps.ensemble_mesh().devices.shape
    mesh = pt.ensemble_mesh(proc_shape=(2, 2, 1), ensemble_devices=2,
                            devices=CPU8)
    assert mesh.devices.shape == (2, 2, 2, 1)
    assert mesh.shape == {"ensemble": 2, "x": 2, "y": 2, "z": 1}
    assert mesh.devices.shape == ps.ensemble_mesh(
        proc_shape=(2, 2, 1), ensemble_devices=2).devices.shape
    with pytest.raises(ValueError, match="devices"):
        pt.ensemble_mesh(proc_shape=(2, 2, 1), ensemble_devices=8,
                         devices=CPU8)
    with pytest.raises(ValueError, match="tile"):
        pt.ensemble_mesh(proc_shape=(3, 1, 1), devices=CPU8)


def test_ensemble_decomp_describes_member_lattice():
    """The decomposition hides the ensemble axis from the single-member
    verbs (spec/proc_shape see only x/y/z) and exposes it through the
    member_* placement API, with the JAX package's specs."""
    decomp = _edecomp(4, proc_shape=(2, 1, 1))
    assert decomp.proc_shape == (2, 1, 1)
    assert decomp.axis_names == ("x", "y", "z")
    assert decomp.ensemble_devices == 4
    assert "ensemble" not in decomp.spec()
    assert decomp.member_spec(outer_axes=1) == (
        "ensemble", None, "x", None, None)
    jmesh = ps.ensemble_mesh(proc_shape=(2, 1, 1), ensemble_devices=4,
                             devices=jax.devices()[:8])
    jdec = ps.DomainDecomposition(mesh=jmesh, ensemble_axis="ensemble")
    assert tuple(jdec.member_spec(outer_axes=1)) == \
        decomp.member_spec(outer_axes=1)
    batch = np.arange(8 * 512, dtype=np.float32).reshape((8, 1) + GRID)
    placed = decomp.shard_members(batch)
    assert isinstance(placed, pt.MemberArray)
    assert placed.sharding.spec == decomp.member_spec(outer_axes=1)
    assert placed.shape == batch.shape and len(placed.parts) == 4
    # members in order over the slices, each a ShardedArray of its blocks
    for i in range(8):
        assert isinstance(placed[i], pt.ShardedArray)
        np.testing.assert_array_equal(decomp.gather_array(placed[i]),
                                      batch[i])
    assert placed.parts[1].blocks[0].shape == (2, 1, 4, 8, 8)
    with pytest.raises(ValueError, match="divisible"):
        decomp.shard_members(np.zeros((3, 1) + GRID, np.float32))
    # per-member scalars carry no lattice axes: only the member axis splits
    sc = decomp.shard_members(np.arange(8.0))
    assert [p.tolist() for p in sc.parts] == [[0, 1], [2, 3], [4, 5],
                                              [6, 7]]


def test_ensemble_decomp_requires_leading_axis():
    mesh = pt.make_mesh((2, 2, 1), devices=["cpu"] * 4)
    with pytest.raises(ValueError, match="leading"):
        pt.DomainDecomposition(mesh=mesh, ensemble_axis="ensemble")
    with pytest.raises(ValueError, match="explicit mesh"):
        pt.DomainDecomposition((2, 2, 1), ensemble_axis="ensemble")
    # a spatial mesh: the verbs of a plain decomposition, with_devices
    d = pt.DomainDecomposition(mesh=mesh, halo_shape=1)
    assert d.proc_shape == (2, 2, 1) and d.ensemble_devices == 1
    assert d.with_devices(["cpu"] * 2).proc_shape == (2, 1, 1)
    with pytest.raises(ValueError, match="spatial"):
        _edecomp(2).with_devices(["cpu"] * 2)


# -- the map tier -------------------------------------------------------------

def _potential(f):
    return 0.5 * 1.2e-2 * f[0] ** 2 + 0.125 * f[0] ** 2 * f[1] ** 2


def _fused_members(size, grid, dtype, gw=False, seed=17):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(size):
        m = {"f": (1e-1 * rng.standard_normal((2,) + grid)).astype(dtype),
             "dfdt": (1e-2 * rng.standard_normal((2,) + grid)).astype(
                 dtype)}
        if gw:
            m["hij"] = (1e-3 * rng.standard_normal((6,) + grid)).astype(
                dtype)
            m["dhijdt"] = (1e-3 * rng.standard_normal((6,) + grid)).astype(
                dtype)
        out.append(m)
    return out


@pytest.mark.parametrize("kind", ["scalar", "preheat"])
@pytest.mark.parametrize("carry", ["f32", "bf16"])
def test_map_tier_bitexact_with_fused_sequential(kind, carry):
    """The map tier runs the fused chunk body at single-member shapes, so
    a mapped member is BIT-EXACT with the same member run through the
    stepper's own multi_step (per-member a and hubble, a float32 dt), and
    its health-matrix row is the member's health vector."""
    sector = pt.ScalarSector(2, potential=_potential)
    cd = torch.bfloat16 if carry == "bf16" else None
    dx = (5 / 8,) * 3
    if kind == "scalar":
        fused = pt.FusedScalarStepper(sector, GRID, dx, 2, device="cpu",
                                      carry_dtype=cd)
    else:
        gw = pt.TensorPerturbationSector([sector])
        fused = pt.FusedPreheatStepper(sector, gw, GRID, dx, 2,
                                       device="cpu", carry_dtype=cd)
    size, nsteps = 3, 3
    ens = fused.batched(size)
    assert ens.via == "map"  # auto-detected fused tier
    members = _fused_members(size, GRID, np.float32, gw=kind == "preheat")
    args = {"a": np.array([1.1, 1.2, 1.05]), "hubble": 0.3}
    dt = np.float32(1e-3)
    sen = tobs.Sentinel.for_state(members[0])
    out, matrix = ens.multi_step(ens.stack(members), nsteps, t=0.0, dt=dt,
                                 rhs_args=args, sentinel=sen)
    for i in range(size):
        ref = fused.multi_step(_t(members[i]), nsteps, t=0.0, dt=dt,
                               rhs_args={"a": float(args["a"][i]),
                                         "hubble": 0.3})
        for k in ref:
            assert torch.equal(out[k][i], ref[k]), f"member {i} field {k}"
        assert torch.equal(matrix[i], sen.compute(ref))


def test_fused_stepper_on_device_twin():
    """A fused stepper on its own device is itself; on another device a
    twin bound there, sharing the model and owning its buffers, while the
    original stays where it was. A generic stepper holds no device and is
    itself; a sharded fused stepper cannot move."""
    sector = pt.ScalarSector(2, potential=_potential)
    fused = pt.FusedScalarStepper(sector, GRID, (5 / 8,) * 3, 2,
                                  device="cpu")
    assert fused.on_device("cpu") is fused
    state = _t(_fused_members(1, GRID, np.float32)[0])
    fused.multi_step(state, 1, dt=1e-3)
    twin = fused.on_device("meta")
    assert twin is not fused and twin.device.type == "meta"
    assert fused.device.type == "cpu" and twin._buffers is None
    assert twin.sector is fused.sector and twin._pad_bufs is not \
        fused._pad_bufs
    with pytest.raises(ValueError, match="runs on meta"):
        twin.multi_step(state, 1, dt=1e-3)
    fused.multi_step(state, 1, dt=1e-3)
    generic = pt.LowStorageRK54(_torch_rhs, dt=1e-3)
    assert generic.on_device("meta") is generic
    sharded = pt.FusedScalarStepper(
        sector, GRID, (5 / 8,) * 3, 2, device="cpu",
        decomp=pt.DomainDecomposition((2, 1, 1), halo_shape=2,
                                      devices=["cpu"] * 2))
    with pytest.raises(ValueError, match="sharded fused stepper"):
        sharded.on_device("meta")


def test_map_tier_runs_each_slice_through_its_stepper():
    """Over an ensemble mesh the map tier runs each slice's members
    through that slice's stepper (the stepper's twin on the slice's card),
    each member bit for bit its sequential multi_step."""
    sector = pt.ScalarSector(2, potential=_potential)
    fused = pt.FusedScalarStepper(sector, GRID, (5 / 8,) * 3, 2,
                                  device="cpu")
    size, nsteps = 4, 2
    ens = fused.batched(size, decomp=_edecomp(2), via="map")
    assert ens.steppers == [fused, fused]
    seen = []

    class Slice1:
        """Slice 1's stepper, recording the members it runs."""
        def multi_step_fn(self, n):
            body = fused.multi_step_fn(n)

            def fn(state, t, dt, rhs_args):
                seen.append(float(rhs_args["a"]))
                return body(state, t, dt, rhs_args)
            return fn

    ens.steppers = [fused, Slice1()]
    members = _fused_members(size, GRID, np.float32)
    args = {"a": np.array([1.1, 1.2, 1.05, 1.3]), "hubble": 0.3}
    dt = np.float32(1e-3)
    out = ens.multi_step(ens.stack(members), nsteps, t=0.0, dt=dt,
                         rhs_args=args)
    assert seen == [1.05, 1.3]
    for i in range(size):
        ref = fused.multi_step(_t(members[i]), nsteps, t=0.0, dt=dt,
                               rhs_args={"a": float(args["a"][i]),
                                         "hubble": 0.3})
        for k in ref:
            assert torch.equal(out[k][i], ref[k]), f"member {i} field {k}"


def test_map_tier_matches_jax():
    """The port's map tier against the JAX package's (lax.map of the
    fused Pallas body), f64 at 8^3: within 1e-12 relative."""
    dx = (5 / 8,) * 3
    jdec = ps.DomainDecomposition((1, 1, 1), devices=jax.devices()[:1])
    jf = ps.FusedScalarStepper(ps.ScalarSector(2, potential=_potential),
                               jdec, GRID, dx, 2, dtype=jnp.float64,
                               bx=4, by=8)
    tf = pt.FusedScalarStepper(pt.ScalarSector(2, potential=_potential),
                               GRID, dx, 2, dtype=torch.float64,
                               device="cpu")
    members = _fused_members(2, GRID, np.float64)
    args = {"a": np.array([1.1, 1.2]), "hubble": 0.3}
    jout = jf.batched(2).multi_step(
        jf.batched(2).stack(members), 2, t=0.0, dt=1e-3, rhs_args=args)
    tens = tf.batched(2)
    tout = tens.multi_step(tens.stack(members), 2, t=0.0, dt=1e-3,
                           rhs_args=args)
    for k in jout:
        assert _rel(tout[k].numpy(), jout[k]) < 1e-12, k


# -- the vmap tier -------------------------------------------------------------

def _fd_rhs(fd):
    def rhs(state, t, m2):
        return {"f": state["dfdt"],
                "dfdt": fd.lap(state["f"]) - m2 * state["f"]}
    return rhs


def test_vmap_tier_agrees_with_sequential():
    """The vmap tier advances each member as a sequential single-member
    run does (the JAX bar: rtol 1e-6, atol 1e-12 in f32), per-member dt and
    parameters entering as batched leaves, with ONE lap call a stage for
    the whole batch. On the CPU the members come out bit for bit."""
    fd = pt.FiniteDifferencer(2, (0.3, 0.3, 0.3), device="cpu")
    stepper = pt.LowStorageRK54(_fd_rhs(fd), dt=1e-3)
    size, nsteps = 4, 3
    ens = stepper.batched(size, device="cpu", via="vmap")
    members = [_member(s) for s in range(size)]
    batch = ens.stack(members)
    m2 = np.linspace(0.1, 0.7, size)
    dt = np.linspace(1e-3, 2e-3, size)
    tderivs.reset_launch_counts()
    out = ens.multi_step(batch, nsteps, t=0.0, dt=dt, rhs_args={"m2": m2})
    assert tderivs.CALLS["lap"] == nsteps * stepper.num_stages
    body = stepper.multi_step_fn(nsteps)
    for i in range(size):
        ref = body(_t(members[i]), 0.0, float(dt[i]), {"m2": float(m2[i])})
        for k in ref:
            np.testing.assert_allclose(out[k][i].numpy(), ref[k].numpy(),
                                       rtol=1e-6, atol=1e-12)
            assert torch.equal(out[k][i], ref[k])
    # the input batch is left as it was; one batched body per key
    assert torch.equal(batch["f"][0], _t(members[0])["f"])
    ens.step(batch, t=0.5, dt=1e-3, rhs_args={"m2": m2})
    ens.step(batch, t=0.0, dt=1e-3, rhs_args={"m2": np.ones(size)})
    assert len(ens.bodies) == 2


def test_vmap_tier_matches_jax():
    """The port's vmap tier (its lap the batched custom operator of
    FiniteDifferencer, h = 1 at unit spacing) against the JAX package's
    (jax.vmap of the generic RK54 body over jnp.roll sums), f64,
    per-member dt and m2: within 1e-12."""
    size = 3
    jst = ps.LowStorageRK54(_jax_rhs, dt=1e-3)
    tst = pt.LowStorageRK54(
        _fd_rhs(pt.FiniteDifferencer(1, 1.0, device="cpu")), dt=1e-3)
    members = [_member(s, dtype=np.float64) for s in range(size)]
    m2 = np.linspace(0.1, 0.7, size)
    dt = np.linspace(1e-3, 2e-3, size)
    jens = jst.batched(size, via="vmap")
    jout = jens.multi_step(jens.stack(members), 3, t=0.0, dt=dt,
                           rhs_args={"m2": m2})
    tens = tst.batched(size, via="vmap", device="cpu")
    tout = tens.multi_step(tens.stack(members), 3, t=0.0, dt=dt,
                           rhs_args={"m2": m2})
    for k in jout:
        assert _rel(tout[k].numpy(), jout[k]) < 1e-12, k


def test_spatial_plus_ensemble_mesh_packing():
    """The (2,2,1)+ensemble packing: members split over the two ensemble
    slices while each member's lattice keeps its spatial sharding (halo
    exchanges inside the vmapped body, one sharded lap call a stage and
    slice), and members agree with a sequential spatially-sharded run
    within the JAX test's rtol 1e-5."""
    grid = (16, 16, 16)
    decomp = _edecomp(2, proc_shape=(2, 2, 1), halo_shape=2)
    dx = (5 / 16,) * 3
    fd = pt.FiniteDifferencer(2, dx, decomp=decomp, overlap=False)
    stepper = pt.LowStorageRK54(_fd_rhs(fd), dt=1e-3)
    size = 4
    ens = stepper.batched(size, decomp=decomp, via="vmap")
    members = [_member(s, shape=grid) for s in range(size)]
    batch = ens.stack(members)
    spec = batch["f"].sharding.spec
    assert spec[0] == "ensemble" and "x" in spec and "y" in spec
    assert batch["f"].parts[1].blocks[3].shape == (2, 1, 8, 8, 16)
    m2 = np.linspace(0.1, 0.4, size)
    tderivs.reset_launch_counts()
    out = ens.multi_step(batch, 2, t=0.0, dt=1e-3, rhs_args={"m2": m2})
    assert tderivs.CALLS["lap"] == 2 * stepper.num_stages * 2
    assert isinstance(out["f"], pt.MemberArray)

    sdec = pt.DomainDecomposition((2, 2, 1), halo_shape=2,
                                  devices=["cpu"] * 4)
    sfd = pt.FiniteDifferencer(2, dx, decomp=sdec, overlap=False)
    body = pt.LowStorageRK54(_fd_rhs(sfd), dt=1e-3).multi_step_fn(2)
    for i in range(size):
        ref = body({k: sdec.shard(v) for k, v in members[i].items()},
                   0.0, 1e-3, {"m2": float(m2[i])})
        for k in ref:
            np.testing.assert_allclose(
                decomp.gather_array(out[k][i]), sdec.gather_array(ref[k]),
                rtol=1e-5, atol=1e-10)


def test_write_member_touches_one_slot():
    size = 3
    stepper = pt.LowStorageRK54(_torch_rhs, dt=1e-3)
    ens = EnsembleStepper(stepper, size, via="vmap", device="cpu")
    batch = ens.stack([_member(s) for s in range(size)])
    before = batch["f"].clone()
    fresh = _member(99)
    out = ens.write_member(batch, 1, fresh)
    assert np.array_equal(out["f"][1].numpy(), fresh["f"])
    for i in (0, 2):  # untouched slots stay bit-identical
        assert torch.equal(out["f"][i], batch["f"][i])
    assert torch.equal(batch["f"], before)  # the input batch intact
    # on an ensemble mesh too, a float64 draw cast to the batch's float32
    dec = _edecomp(3)
    eens = EnsembleStepper(stepper, size, decomp=dec, via="vmap")
    eb = eens.stack([_member(s) for s in range(size)])
    eout = eens.write_member(eb, 2, _member(7, dtype=np.float64))
    assert torch.equal(eout["dfdt"][2], torch.from_numpy(
        _member(7, dtype=np.float64)["dfdt"].astype(np.float32)))
    assert torch.equal(eout["dfdt"][0], eb["dfdt"][0])
    # donate: written in place
    dens = EnsembleStepper(stepper, size, via="vmap", device="cpu",
                           donate=True)
    db = dens.stack([_member(s) for s in range(size)])
    assert dens.write_member(db, 0, fresh)["f"] is db["f"]
    assert np.array_equal(db["f"][0].numpy(), fresh["f"])


# -- per-member health ------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_health_matrix_rows_match_single_vectors(dtype):
    """compute_members row i is compute of member i bit for bit (one read
    of each leaf for the batch), a NaN member included, and its decode
    equals the JAX matrix's: finite and max_abs exactly, rms within 1e-6
    (f32) and 1e-12 (f64)."""
    size = 3
    members = [_member(s, dtype=dtype) for s in range(size)]
    members[1]["f"][0, 1, 2, 3] = np.nan
    kin = {"kin": lambda st, aux: 0.5 * torch.mean(st["dfdt"] ** 2)}
    tsen = tobs.Sentinel.for_state(members[0], invariants=kin,
                                   dtype=dtype)
    batched = {k: torch.from_numpy(np.stack([m[k] for m in members]))
               for k in members[0]}
    matrix = tsen.compute_members(batched)
    assert matrix.shape == (size, tsen.size)
    for i, m in enumerate(members):
        assert torch.equal(matrix[i].nan_to_num(7.0),
                           tsen.compute(_t(m)).nan_to_num(7.0))
    jsen = jobs.Sentinel.for_state(members[0], dtype=dtype)
    jmat = jax.jit(jsen.compute_members)(
        {k: jnp.asarray(v.numpy()) for k, v in batched.items()})
    jdec = jsen.decode_members(jmat)
    tdec = tsen.decode_members(matrix)
    tol = 1e-6 if dtype == np.float32 else 1e-12
    for i in range(size):
        for name in jdec[i]["fields"]:
            got, want = tdec[i]["fields"][name], jdec[i]["fields"][name]
            assert got["finite"] == want["finite"]
            assert got["max_abs"] == want["max_abs"] or (
                np.isnan(got["max_abs"]) and np.isnan(want["max_abs"]))
            assert got["rms"] == pytest.approx(want["rms"], rel=tol,
                                               nan_ok=True)
    assert not tdec[1]["fields"]["f"]["finite"]
    assert tdec[0]["fields"]["f"]["finite"]


def test_health_matrix_on_sharded_and_member_batches():
    """The same rows from a ShardedArray batch on (2, 2, 1) and from a
    MemberArray batch over two ensemble slices, bit for bit."""
    size = 4
    members = [_member(s, shape=(16, 16, 16)) for s in range(size)]
    members[2]["dfdt"][0, 0, 0, 0] = np.inf
    sen = tobs.Sentinel.for_state(members[0])
    whole = {k: torch.from_numpy(np.stack([m[k] for m in members]))
             for k in members[0]}
    ref = sen.compute_members(whole)
    d = pt.DomainDecomposition((2, 2, 1), devices=["cpu"] * 4)
    sharded = sen.compute_members({k: d.shard(v) for k, v in whole.items()})
    assert torch.equal(sharded.nan_to_num(7.0), ref.nan_to_num(7.0))
    e = _edecomp(2, proc_shape=(2, 1, 1))
    placed = {k: e.shard_members(v) for k, v in whole.items()}
    assert torch.equal(sen.compute_members(placed).nan_to_num(7.0),
                       ref.nan_to_num(7.0))


def _stacked(members):
    return {k: torch.from_numpy(np.stack([m[k] for m in members]))
            for k in members[0]}


def test_health_checks_hold_no_state_in_cycles():
    """Once the caller drops a batch and the chunk's outputs, no tensor of
    them is left for the cycle collector: the health checks and the map
    tier keep no checked state in a reference cycle (a leaf walk that
    called itself as a closure did, until the collector ran: tens of GiB
    of device memory at 512^3), and a dropped wrapper frees its base
    stepper (and with it a fused stepper's buffers) at once."""
    import gc
    import weakref
    size = 3
    sen = tobs.Sentinel.for_state(_member(0))
    ens = EnsembleStepper(pt.LowStorageRK54(_torch_rhs, dt=1e-3), size,
                          via="map", device="cpu")
    gc.collect()
    gc.disable()
    try:
        batch = _stacked([_member(s) for s in range(size)])
        out, matrix = ens.multi_step(batch, 2, rhs_args={"m2": 1.0},
                                     sentinel=sen)
        one = _t(_member(7))
        vector = sen.compute(one)
        refs = [weakref.ref(x) for tree in (batch, out, one)
                for x in tree.values()] + [weakref.ref(ens.stepper)]
        del batch, out, matrix, one, vector, ens
        assert [r() is None for r in refs] == [True] * len(refs)
    finally:
        gc.enable()


def test_monitor_evicts_without_killing_batch(tmp_path):
    """An unhealthy row becomes an Eviction naming the member and its
    parameter draw (no raise); masked members never trip; a resampled
    slot skips its stale pending matrices."""
    tobs.configure(str(tmp_path / "ev.jsonl"))
    try:
        size = 3
        members = [_member(s) for s in range(size)]
        sen = tobs.Sentinel.for_state(members[0])
        sink = ForensicSink(str(tmp_path), label="ens")
        mon = EnsembleMonitor(sen, size, every=1, forensics=sink)
        mon.set_member(1, params={"g2": 0.25, "seed": 7},
                       scenario="preheat")
        bad = [_member(s) for s in range(size)]
        bad[1]["f"][0, 0, 0, 0] = np.inf

        def matrix(mems):
            return sen.compute_members(_stacked(mems))

        mon.push(1, matrix(bad))
        assert mon.poll() == []  # maturity lag: nothing converted yet
        mon.push(2, matrix(bad))
        evs = mon.poll()
        assert len(evs) == 1
        ev = evs[0]
        assert ev.member == 1 and ev.scenario == "preheat"
        assert ev.params["g2"] == 0.25
        assert "f" in ev.fields
        # the member-scoped bundle names the member and its draw
        bundle = load_bundle(ev.bundle)
        assert bundle["trip"]["member"] == 1
        assert bundle["trip"]["member_params"]["g2"] == 0.25
        assert "member1" in ev.bundle
        # still bad in the queue, but suspended: no second eviction
        mon.push(3, matrix(bad))
        mon.push(4, matrix(bad))
        assert mon.poll() == []
        # resample: stale matrices (<= at_step) skipped, fresh ones
        # checked again
        mon.reset_member(1, at_step=4, params={"g2": 0.5})
        mon.push(5, matrix(bad))
        mon.push(6, matrix(members))
        mon.push(7, matrix(members))
        evs = mon.flush()
        assert [e.step for e in evs] == [5]
        assert evs[0].params["g2"] == 0.5
        kinds = [e["kind"] for e in tobs.read_events(
            str(tmp_path / "ev.jsonl"))]
        assert kinds.count("member_evicted") == 2
        assert tobs.registry().snapshot()["ensemble_evictions"] >= 2
    finally:
        tobs.configure(None)


def test_monitor_retire_time_check():
    """check_member_now converts a member's still-immature pending rows
    synchronously: an unhealthy tail becomes an Eviction, a healthy member
    returns None, and the matrices stay queued for the asynchronous
    path."""
    size = 2
    members = [_member(s) for s in range(size)]
    sen = tobs.Sentinel.for_state(members[0])
    mon = EnsembleMonitor(sen, size, every=1)
    mon.set_member(1, params={"seed": 3}, scenario="wave")
    bad = [_member(s) for s in range(size)]
    bad[1]["f"][0, 0, 0, 0] = np.nan
    mon.push(1, sen.compute_members(_stacked(bad)))
    assert mon.poll() == []  # inside the maturity lag
    assert mon.check_member_now(0, through_step=1) is None
    assert len(mon.history) == 0
    ev = mon.check_member_now(1, through_step=1)
    assert ev is not None and ev.member == 1
    assert ev.params["seed"] == 3 and "f" in ev.fields
    assert mon.pending_steps == [1]  # stays queued for the async path
    hist = mon._member_history(1)
    assert [h["step"] for h in hist] == [1]
    assert not hist[0]["fields"]["f"]["finite"]
    assert mon.check_member_now(1, through_step=1) is None
    assert mon.flush() == []


def test_monitor_eviction_budget_exhaustion(monkeypatch):
    size = 2
    sen = tobs.Sentinel.for_state(_member(0))
    bad = [_member(s) for s in range(size)]
    for m in bad:
        m["f"][0, 0, 0, 0] = np.nan
    mon = EnsembleMonitor(sen, size, every=0, max_evictions=1)
    mon.push(1, sen.compute_members(_stacked(bad)))
    with pytest.raises(SimulationDiverged, match="budget"):
        mon.poll()
    # the registered default budget
    monkeypatch.setenv("PYSTELLA_ENSEMBLE_MAX_EVICTIONS", "0")
    assert EnsembleMonitor(sen, size).max_evictions == 0


# -- driver: queue, refill, evict-and-resample ------------------------------

def _scenario(pkg, stepper, nsteps=6, bad_seed=None, name="wave"):
    def sample(seed):
        state = _member(100 + seed)
        if seed == bad_seed:
            state["f"][0, 0, 0, 0] = np.nan
        return state, {"m2": float(0.1 + 0.02 * seed)}
    return pkg.Scenario(name, stepper, sample, nsteps=nsteps, dt=1e-3)


#: the event kinds the ensemble engine emits (JAX also logs compiles)
ENSEMBLE_KINDS = {"ensemble_run", "ensemble_chunk", "ensemble_done",
                  "ensemble_health", "member_started", "member_finished",
                  "member_evicted", "member_preempted", "forensic_bundle",
                  "diverged"}


def _eviction_round_trip(pkg, stepper, tmp_path, decomp):
    ev_path = str(tmp_path / "ev.jsonl")
    pkg.obs.configure(ev_path)
    try:
        sink = pkg.obs.ForensicSink(str(tmp_path), events_path=ev_path,
                                    label="ens")
        kw = {} if pkg is ps else {"device": "cpu"}
        drv = pkg.EnsembleDriver(size=4, chunk=2, decomp=decomp,
                                 forensics=sink, emit_steps=True,
                                 label="test", **kw)
        drv.submit(_scenario(pkg, stepper, nsteps=4, bad_seed=2), range(6))
        out = drv.run()
    finally:
        pkg.obs.configure(None)
    return out, pkg.obs.read_events(ev_path)


def test_driver_eviction_round_trip(tmp_path):
    """The acceptance round trip: one seeded-NaN member in a full batch ->
    the batch completes every job, forensics names the bad member and its
    parameter draw, the slot is resampled under a fresh seed, and the
    throughput totals land in ensemble_done. The same run of the JAX
    driver finishes the same seeds, evicts at the same steps and logs the
    same event kinds, steps and payload keys."""
    stepper = pt.LowStorageRK54(_torch_rhs, dt=1e-3)
    out, recs = _eviction_round_trip(pt, stepper, tmp_path / "port",
                                     _edecomp(4))
    st = out["stats"]
    assert st["members_completed"] == 6
    assert st["evictions"] == 1
    assert st["member_steps"] > 0 and st["member_steps_per_s"] > 0
    ev = out["evictions"][0]
    assert ev.scenario == "wave"
    assert ev.params["seed"] == 2
    bundle = load_bundle(ev.bundle)
    assert bundle["trip"]["member"] == ev.member
    assert bundle["trip"]["member_params"]["seed"] == 2
    started = [e for e in recs if e["kind"] == "member_started"]
    reseeds = [e["data"]["seed"] for e in started
               if e["data"]["member"] == ev.member]
    assert reseeds[0] == 2 and all(s != 2 for s in reseeds[1:])
    done = [e for e in recs if e["kind"] == "ensemble_done"]
    assert len(done) == 1 and done[0]["data"]["evictions"] == 1

    jmesh = ps.ensemble_mesh(ensemble_devices=4, devices=jax.devices()[:4])
    jdec = ps.DomainDecomposition(mesh=jmesh, ensemble_axis="ensemble")
    jout, jrecs = _eviction_round_trip(
        ps, ps.LowStorageRK54(_jax_rhs, dt=1e-3), tmp_path / "jax", jdec)
    assert sorted(r["seed"] for r in out["results"]) == \
        sorted(r["seed"] for r in jout["results"])
    assert [(e.member, e.step, e.fields) for e in out["evictions"]] == \
        [(e.member, e.step, e.fields) for e in jout["evictions"]]

    def shape(records):
        return [(e["kind"], e.get("step"), sorted(e.get("data", {})))
                for e in records if e["kind"] in ENSEMBLE_KINDS]
    assert shape(recs) == shape(jrecs)
    assert set(st) == set(jout["stats"])


def test_driver_catches_divergence_in_final_chunk(tmp_path):
    """A member that diverges inside its FINAL chunk (whose health matrix
    is still inside the maturity lag at retire time) is evicted at retire,
    not reported member_finished with a NaN state."""
    tobs.configure(str(tmp_path / "ev.jsonl"))
    try:
        stepper = pt.LowStorageRK54(_torch_rhs, dt=1e-3)
        drv = pt.EnsembleDriver(size=2, chunk=4, every=1, label="retire",
                                device="cpu")
        drv.submit(_scenario(pt, stepper, nsteps=4, bad_seed=1), range(2))
        out = drv.run()
        assert out["stats"]["evictions"] == 1
        assert out["evictions"][0].params["seed"] == 1
        seeds = [r["seed"] for r in out["results"]]
        assert 1 not in seeds and len(seeds) == 2
    finally:
        tobs.configure(None)


def test_driver_mask_policy_retires_slot(monkeypatch):
    """resample=False (here through PYSTELLA_ENSEMBLE_RESAMPLE=0): the
    evicted slot is masked out instead of refilled: its job is not
    completed and no fresh seed is drawn."""
    monkeypatch.setenv("PYSTELLA_ENSEMBLE_RESAMPLE", "0")
    stepper = pt.LowStorageRK54(_torch_rhs, dt=1e-3)
    drv = pt.EnsembleDriver(size=3, chunk=2, label="mask", device="cpu")
    assert drv.resample is False
    drv.submit(_scenario(pt, stepper, nsteps=4, bad_seed=1), range(3))
    out = drv.run()
    assert out["stats"]["evictions"] == 1
    assert out["stats"]["members_completed"] == 2


def test_driver_groups_shape_incompatible_scenarios(tmp_path):
    """Scenarios with different state shapes run as separate sequential
    batches; all jobs still complete."""
    tobs.configure(str(tmp_path / "ev.jsonl"))
    try:
        stepper = pt.LowStorageRK54(_torch_rhs, dt=1e-3)
        small = _scenario(pt, stepper, nsteps=4, name="small")

        def sample_big(seed):
            return _member(seed, shape=(12, 8, 8)), {"m2": 0.2}
        big = pt.Scenario("big", stepper, sample_big, nsteps=4, dt=1e-3)
        drv = pt.EnsembleDriver(size=2, chunk=2, label="groups",
                                device="cpu")
        drv.submit(small, range(2)).submit(big, range(2))
        out = drv.run()
        assert out["stats"]["members_completed"] == 4
        assert out["stats"]["batches"] == 2
        recs = tobs.read_events(str(tmp_path / "ev.jsonl"))
        run_ev = [e for e in recs if e["kind"] == "ensemble_run"][0]
        assert len(run_ev["data"]["groups"]) == 2
    finally:
        tobs.configure(None)


def test_driver_refills_from_queue():
    """More jobs than slots: retired members' slots are refilled from the
    queue until it drains; the default size is the registered one."""
    stepper = pt.LowStorageRK54(_torch_rhs, dt=1e-3)
    drv = pt.EnsembleDriver(size=2, chunk=2, label="refill", device="cpu")
    drv.submit(_scenario(pt, stepper, nsteps=4), range(5))
    out = drv.run()
    assert out["stats"]["members_completed"] == 5
    assert out["stats"]["evictions"] == 0
    assert pt.EnsembleDriver(device="cpu").size == 8


@pytest.mark.parametrize("via", ["vmap", "map"])
def test_preempt_requeue_resumes_bit_for_bit(via):
    """A drained member requeued into a new driver resumes its own
    trajectory: its final state equals the uninterrupted run's bit for bit
    (the same chunks), in the vmap tier and in the map tier over the fused
    stepper."""
    if via == "vmap":
        stepper = pt.LowStorageRK54(_torch_rhs, dt=1e-3)
        sc = _scenario(pt, stepper, nsteps=6)
    else:
        stepper = pt.FusedScalarStepper(
            pt.ScalarSector(2, potential=_potential), GRID, (5 / 8,) * 3, 2,
            device="cpu")

        def sample(seed):
            return (_fused_members(1, GRID, np.float32, seed=seed)[0],
                    {"a": 1.0 + 0.01 * seed, "hubble": 0.2})
        sc = pt.Scenario("fused", stepper, sample, nsteps=6, dt=1e-3)

    def finals(drv):
        got = {}
        out = drv.run(on_finish=lambda rec, st: got.__setitem__(
            rec["seed"], st))
        return out, got

    _, whole = finals(pt.EnsembleDriver(size=2, chunk=2, device="cpu")
                      .submit(sc, range(3)))
    drv = pt.EnsembleDriver(size=2, chunk=2, device="cpu",
                            preempt=lambda chunk: chunk == 1)
    out, early = finals(drv.submit(sc, range(3)))
    assert not early and len(out["preempted"]) == 2
    assert [p["seed"] for p in out["pending"]] == [2]
    again = pt.EnsembleDriver(size=2, chunk=2, device="cpu")
    for rec in out["preempted"]:
        assert rec["step"] == 2
        again.requeue(rec["scenario"], rec["state"], rec["step"],
                      seed=rec["seed"], params=rec["params"], t=rec["t"])
    again.submit(sc, [p["seed"] for p in out["pending"]])
    out2, resumed = finals(again)
    assert sorted(resumed) == [0, 1, 2]
    for seed in resumed:
        for k in whole[seed]:
            assert np.array_equal(resumed[seed][k], whole[seed][k]), \
                (seed, k)


# -- the decomposition's counters ---------------------------------------------

def test_halo_counters_match_jax():
    """One padded exchange (share_halos, h = 2 on (2, 2, 1)) adds the same
    halo_exchanges and halo_bytes_exchanged to both packages' counters;
    the same exchange again adds exchanges but no new program bytes."""
    x = np.random.default_rng(3).standard_normal((1, 16, 16, 8))
    jd = ps.DomainDecomposition((2, 2, 1), devices=jax.devices()[:4])
    td = pt.DomainDecomposition((2, 2, 1), devices=["cpu"] * 4)

    def delta(pkg, fn):
        reg = pkg.obs.metrics.registry()
        names = ("halo_exchanges", "halo_bytes_exchanged")
        before = [reg.counter(n).value for n in names]
        fn()
        return [reg.counter(n).value - b for n, b in zip(names, before)]
    jd_first = delta(ps, lambda: jax.block_until_ready(
        jd.share_halos(jd.shard(x, outer_axes=1), 2, outer_axes=1)))
    td_first = delta(pt, lambda: td.share_halos(x, 2, outer_axes=1))
    assert td_first == jd_first and td_first[0] == 2 and td_first[1] > 0
    assert delta(pt, lambda: td.share_halos(x, 2)) == [2, 0]


def test_ensemble_modules_import_no_jax():
    """The ensemble engine and the new examples pull in neither jax nor
    pystella_tpu."""
    mods = ["pystella_tpu_torch.ensemble", "pystella_tpu_torch.ensemble.batch",
            "pystella_tpu_torch.ensemble.driver",
            "pystella_tpu_torch.ensemble.health",
            "pystella_tpu_torch.parallel.decomp"]
    code = ("import sys, importlib, runpy\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "for ex in ('torch_ensemble_scan', 'torch_wave_equation'):\n"
            "    runpy.run_path(f'examples/{ex}.py', run_name='example')\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'pystella_tpu')]\n"
            "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                         capture_output=True, text=True)
    assert out.stdout.strip() == "[]", out.stdout


def test_step_with_health_and_repack():
    """step_with_health: one step and the matrix of the new batch, its
    invariant column from per-member aux; repack_members onto another
    ensemble decomposition keeps every member bit for bit."""
    size = 4
    stepper = pt.LowStorageRK54(_torch_rhs, dt=1e-3)
    members = [_member(s) for s in range(size)]
    sen = tobs.Sentinel.for_state(
        members[0], invariants={"scaled": lambda st, aux: aux["a"] * 2.0})
    ens = EnsembleStepper(stepper, size, decomp=_edecomp(4), via="vmap")
    batch = ens.stack(members)
    m2 = np.linspace(0.1, 0.4, size)
    new, mat = ens.step_with_health(batch, sen, rhs_args={"m2": m2},
                                    aux={"a": np.arange(size) + 1.0})
    assert ens.health_jit(sen) is ens.health_jit(sen)
    for i in range(size):
        ref = stepper.step(_t(members[i]), 0.0, 1e-3, {"m2": float(m2[i])})
        assert torch.equal(new["f"][i], ref["f"])
        assert torch.equal(mat[i], sen.compute(ref, {"a": i + 1.0}))
    repacked = pt.ensemble.repack_members(new, _edecomp(2))
    assert len(repacked["f"].parts) == 2
    for i in range(size):
        assert torch.equal(repacked["dfdt"][i], new["dfdt"][i])
