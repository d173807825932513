"""The port's FiniteDifferencer on sharded arrays (every shard a CPU tensor
here, the kernels' plain versions) against the JAX package's sharded
FiniteDifferencer on its virtual CPU devices, against the port's own
single-device operators, and overlapped against padded."""

import jax
import numpy as np
import pytest
import torch

import pystella_tpu as ps
import pystella_tpu_torch as pt

MESHES = [(1, 1, 1), (2, 1, 1), (2, 2, 1), (2, 2, 2)]
MESH_IDS = ["111", "211", "221", "222"]
GRID, DX = (32, 16, 8), (0.3, 0.25, 0.2)
OPS = ("lap", "grad", "grad_lap", "pdx", "pdy", "pdz", "divergence")


def _inputs(grid=GRID):
    rng = np.random.default_rng(5)
    return {"f": rng.standard_normal((2,) + grid),
            "v": rng.standard_normal((2, 3) + grid)}


def _port_decomp(mesh):
    return pt.DomainDecomposition(mesh, devices=["cpu"] * int(np.prod(mesh)))


def _apply(fd, op, f, v):
    out = getattr(fd, op)(v if op == "divergence" else f)
    return out if isinstance(out, tuple) else (out,)


@pytest.fixture(scope="module")
def jax_ref():
    """Every operator of the JAX sharded FiniteDifferencer (halo mode,
    h = 2, f64) on each mesh, computed once."""
    x = _inputs()
    out = {}
    for mesh in MESHES:
        d = ps.DomainDecomposition(
            mesh, devices=jax.devices()[:int(np.prod(mesh))])
        fd = ps.FiniteDifferencer(d, 2, DX, mode="halo", overlap=False)
        f, v = d.shard(x["f"]), d.shard(x["v"])
        out[mesh] = {op: tuple(np.asarray(a) for a in _apply(fd, op, f, v))
                     for op in OPS}
    return out


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
def test_matches_jax_sharded(jax_ref, mesh, op):
    """Sharded (kernel path; roll sums on the z-sharded mesh) vs the JAX
    sharded operator, f64: 1e-12 of the largest value (XLA orders a few
    sums differently)."""
    x = _inputs()
    d = _port_decomp(mesh)
    fd = pt.FiniteDifferencer(2, DX, decomp=d, overlap=False)
    got = _apply(fd, op, d.shard(x["f"]), d.shard(x["v"]))
    for g, r in zip(got, jax_ref[mesh][op]):
        g = d.gather_array(g)
        assert g.shape == r.shape
        assert np.max(np.abs(g - r)) <= 1e-12 * np.max(np.abs(r)), op


@pytest.mark.parametrize("overlap", [False, True], ids=["padded", "overlap"])
@pytest.mark.parametrize("h", [1, 2])
@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
def test_equals_single_device(mesh, h, overlap):
    """Every operator, sharded, equals the port's single-device operator
    bit for bit: the kernels' plain versions on padded windows (and, with
    the overlap, on the interior and the two x shells) read the same tap
    values; on the z-sharded mesh the roll sums on padded blocks equal the
    single-device ``mode="roll"`` result, whose sums that path shares."""
    x = _inputs()
    d = _port_decomp(mesh)
    fd = pt.FiniteDifferencer(h, DX, decomp=d, overlap=overlap)
    ref_fd = pt.FiniteDifferencer(h, DX, device="cpu",
                                  mode="roll" if mesh[2] > 1 else "kernel")
    f, v = torch.tensor(x["f"]), torch.tensor(x["v"])
    fs, vs = d.shard(x["f"]), d.shard(x["v"])
    for op in OPS:
        got = _apply(fd, op, fs, vs)
        for g, r in zip(got, _apply(ref_fd, op, f, v)):
            assert isinstance(g, pt.ShardedArray)
            np.testing.assert_array_equal(d.gather_array(g), r.numpy(),
                                          err_msg=op)


@pytest.mark.parametrize("h", [1, 2])
@pytest.mark.parametrize("mesh", [(2, 1, 1), (4, 1, 1)], ids=["211", "411"])
def test_overlap_equals_padded(mesh, h):
    """The interior + two x-shell path equals the padded path bit for bit
    (f32 too), and it ran: the profiler sees its labels, and the padded
    path's do not include them."""
    from torch.profiler import profile
    grid = (48, 8, 8)
    x = {k: a.astype(np.float32) for k, a in _inputs(grid).items()}
    d = _port_decomp(mesh)
    ov = pt.FiniteDifferencer(h, DX, decomp=d, overlap=True)
    pd = pt.FiniteDifferencer(h, DX, decomp=d, overlap=False)
    fs, vs = d.shard(x["f"]), d.shard(x["v"])
    for op in OPS:
        with profile() as prof:
            got = _apply(ov, op, fs, vs)
        names = {e.name for e in prof.events()}
        assert {"halo_overlap", "halo_overlap_interior",
                "halo_overlap_shells", "halo_exchange"} <= names, op
        with profile() as prof:
            ref = _apply(pd, op, fs, vs)
        names = {e.name for e in prof.events()}
        assert "halo_exchange" in names and "halo_overlap" not in names
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(d.gather_array(g),
                                          d.gather_array(r), err_msg=op)


def test_roll_mode_and_contracts():
    """``mode="roll"`` on a sharded array runs the roll sums on padded
    blocks (equal to the unsharded roll mode); a sharded operand needs the
    FiniteDifferencer of its decomposition; the overlap policy resolves
    as the JAX package's."""
    x = _inputs()
    d = _port_decomp((2, 2, 1))
    fd = pt.FiniteDifferencer(2, DX, decomp=d, mode="roll")
    ref = pt.FiniteDifferencer(2, DX, device="cpu", mode="roll")
    np.testing.assert_array_equal(
        d.gather_array(fd.lap(d.shard(x["f"]))),
        ref.lap(torch.tensor(x["f"])).numpy())
    with pytest.raises(ValueError, match="decomposition"):
        ref.lap(d.shard(x["f"]))
    other = _port_decomp((2, 2, 1))
    with pytest.raises(ValueError, match="decomposition"):
        fd.lap(other.shard(x["f"]))
    assert pt.FiniteDifferencer(2, DX, decomp=d, overlap=True).overlap
    assert not pt.FiniteDifferencer(2, DX, decomp=d, overlap=False).overlap
    # the tests' environment pins PYSTELLA_HALO_OVERLAP=0 (tests/conftest.py)
    assert not pt.FiniteDifferencer(2, DX, decomp=d).overlap
    with pytest.raises(ValueError, match="one type"):
        pt.FiniteDifferencer(2, DX, decomp=d, device="cuda")
