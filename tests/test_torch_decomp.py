"""The port's DomainDecomposition (single controller: every shard a tensor
on the CPU here) against the JAX package's on its virtual CPU devices: the
halo exchange (pure data movement, so equal exactly), the exchange-width
narrowing, gather/scatter, the collectives, the overlap split and its
refusals, overlap_stencil against the padded path, and the exchange's byte
counts."""

import jax
import numpy as np
import pytest
import torch

import pystella_tpu as ps
import pystella_tpu_torch as pt
from pystella_tpu_torch.parallel import HaloShells

MESHES = [(1, 1, 1), (2, 1, 1), (2, 2, 1), (2, 2, 2)]
GRIDS = [(16, 16, 16), (32, 16, 8)]


def _port(mesh):
    return pt.DomainDecomposition(mesh, devices=["cpu"] * int(np.prod(mesh)))


def _jax(mesh):
    return ps.DomainDecomposition(mesh,
                                  devices=jax.devices()[:int(np.prod(mesh))])


def _field(grid, seed=7, outer=(), dtype=np.float64):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(tuple(outer) + tuple(grid)).astype(dtype)


@pytest.mark.parametrize("grid", GRIDS, ids=["16cubed", "32x16x8"])
@pytest.mark.parametrize("h", [1, 2])
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "".join(map(str, m)))
def test_share_halos_matches_jax(mesh, h, grid):
    """share_halos: every padded block equals the JAX package's, exactly
    (the global layout of both is the padded blocks side by side), and so
    does the per-program byte count."""
    host = _field(grid)
    dp, dj = _port(mesh), _jax(mesh)
    got = dp.share_halos(dp.shard(host), h)
    ref = dj.share_halos(dj.shard(host), h)
    assert isinstance(got, pt.ShardedArray)
    assert got.shape == ref.shape
    np.testing.assert_array_equal(dp.gather_array(got), np.asarray(ref))
    assert dp.traced_halo_bytes() == dj.traced_halo_bytes()
    assert dp.halo_exchanges == len(dp.comm_axes((h,) * 3))


@pytest.mark.parametrize("h", [(2, 0, 3), (0, 2, 1)], ids=["203", "021"])
@pytest.mark.parametrize("mesh", [(2, 2, 1), (2, 2, 2)],
                         ids=["221", "222"])
def test_share_halos_anisotropic(mesh, h):
    """Anisotropic halos, zero-width axes included: every block is the
    wrap-padded slab of the global array (tests/test_decomp.py's check)."""
    grid = (16, 16, 16)
    host = _field(grid)
    dp = _port(mesh)
    got = dp.share_halos(dp.shard(host), h)
    lat = dp.rank_shape(grid)
    for r, blk in enumerate(got.blocks):
        idx = tuple(np.arange(b * n - hi, (b + 1) * n + hi) % g for b, n, g, hi
                    in zip(dp.coords(r), lat, grid, h))
        np.testing.assert_array_equal(blk.numpy(), host[np.ix_(*idx)])


def test_pad_with_halos_exchange_narrowing():
    """``exchange < halo``: along a sharded axis only the exchanged rows
    cross between ranks and the rows beyond them are zeros; the result is
    the JAX package's (tests/test_decomp.py:52)."""
    mesh, grid = (2, 2, 1), (16, 16, 16)
    host = _field(grid)
    halo, ex = (2, 8, 0), (2, 2, 2)
    dp, dj = _port(mesh), _jax(mesh)
    got = dp.pad_with_halos(dp.shard(host), halo, exchange=ex)
    spec = dj.spec(0)
    ref = jax.jit(dj.shard_map(
        lambda x: dj.pad_with_halos(x, halo, exchange=ex), spec, spec))(
            dj.shard(host))
    np.testing.assert_array_equal(dp.gather_array(got), np.asarray(ref))
    full = dp.share_halos(dp.shard(host), halo)
    for blk, want in zip(got.blocks, full.blocks):
        assert torch.equal(blk[:, 6:-6], want[:, 6:-6])
        assert not blk[:, :6].any() and not blk[:, -6:].any()


@pytest.mark.parametrize("outer", [(), (2,)], ids=["scalar", "outer2"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "".join(map(str, m)))
def test_gather_scatter_roundtrip(mesh, dtype, outer):
    """host -> blocks -> host is exact, blocks in rank order hold the
    mesh coordinates' slabs, and the blocks are the JAX shards."""
    grid = (16, 16, 16)
    host = _field(grid, 11, outer, dtype)
    dp, dj = _port(mesh), _jax(mesh)
    arr = dp.scatter_array(host)
    assert arr.shape == host.shape and arr.dtype == pt._device.torch_dtype(
        dtype)
    np.testing.assert_array_equal(dp.gather_array(arr), host)
    ref = dj.shard(host)
    lat = dp.rank_shape(grid)
    for shard in ref.addressable_shards:
        pos = tuple((s.start or 0) // n for s, n in
                    zip(shard.index[len(outer):], lat))
        r = int(np.ravel_multi_index(pos, mesh))
        np.testing.assert_array_equal(arr.blocks[r].numpy(),
                                      np.asarray(shard.data))
    zeros = dp.zeros(grid, dtype, outer_shape=outer)
    assert zeros.shape == host.shape and not dp.gather_array(zeros).any()


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "".join(map(str, m)))
def test_allreduce_matches_jax(mesh):
    """allreduce sum (per-block partials added in rank order: rounding
    apart from XLA's order), max and min (exact), prod; psum."""
    grid = (16, 16, 16)
    host = _field(grid, 3)
    dp, dj = _port(mesh), _jax(mesh)
    arr, ref = dp.shard(host), dj.shard(host)
    assert abs(float(dp.allreduce(arr, "sum"))
               - float(dj.allreduce(ref, "sum"))) <= 1e-13 * np.abs(
                   host).sum()
    for op in ("max", "min"):
        assert float(dp.allreduce(arr, op)) == float(dj.allreduce(ref, op))
    small = dp.shard(1 + 1e-3 * host)
    np.testing.assert_allclose(float(dp.allreduce(small, "prod")),
                               np.prod(1 + 1e-3 * host), rtol=1e-12)
    parts = [b.sum() for b in arr.blocks]
    acc = parts[0]
    for p in parts[1:]:
        acc = acc + p
    assert float(dp.psum(parts)) == float(acc)
    assert dp.psum(3.0) == 3.0
    with pytest.raises(ValueError, match="unknown op"):
        dp.allreduce(arr, "mean")


def test_rank_shape_and_verbs():
    dp = _port((2, 2, 1))
    assert dp.rank_shape((16, 16, 16)) == (8, 8, 16)
    with pytest.raises(ValueError, match="not divisible"):
        dp.rank_shape((15, 16, 16))
    with pytest.raises(ValueError, match="does not cover"):
        pt.DomainDecomposition((2, 2, 1), devices=["cpu"] * 3)
    assert (dp.rank, dp.nranks, dp.rank_tuple(), dp.rankID(3, 1, 0)) == \
        (0, 1, (0, 0, 0), 0)
    assert dp.nshards == 4 and dp.reduce_axes == ("x", "y")
    assert [dp.coords(r) for r in range(4)] == [
        (0, 0, 0), (0, 1, 0), (1, 0, 0), (1, 1, 0)]
    assert dp.neighbor(0, 0, -1) == 2 and dp.neighbor(3, 1, 1) == 2
    assert dp.bcast(5) == 5
    dp.barrier()
    assert "proc_shape=(2, 2, 1)" in repr(dp)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            pt.DomainDecomposition((2, 1, 1))


def test_pad_with_halos_overlap_contract():
    """``overlap=True`` returns ``(interior, shells)``: the regions tile
    the block once, and the centres of the interior and shell inputs
    stitch back to the block (tests/test_overlap.py:39)."""
    mesh, grid, h = (2, 2, 1), (16, 16, 16), 2
    halo = (h, h, h)
    host = _field(grid)
    dp = _port(mesh)
    interior, shells = dp.pad_with_halos(dp.shard(host), halo, overlap=True)
    assert isinstance(shells, HaloShells)
    assert shells.comm_axes == (0, 1)
    block = dp.rank_shape(grid)
    vol = np.prod([b - a for a, b in shells.interior_region()])
    vol += sum(np.prod([b - a for a, b in reg]) for reg in shells.regions())
    assert vol == np.prod(block)

    def centre(p):
        return p[tuple(slice(halo[d], p.shape[d] - halo[d])
                       for d in range(3))]
    out = shells.stitch(interior.map(centre),
                        [x.map(centre) for x in shells.inputs()])
    np.testing.assert_array_equal(dp.gather_array(out), host)


def test_overlap_split_rejects_infeasible():
    """No split on an unsharded mesh, under a z exchange, or for a block
    thinner than MIN_INTERIOR_FACTOR * h: ``ValueError``."""
    grid = (16, 16, 16)
    host = _field(grid)
    for mesh, halo in (((1, 1, 1), (1, 1, 1)), ((1, 1, 2), (1, 1, 1)),
                       ((4, 1, 1), (2, 2, 2))):
        dp = _port(mesh)
        with pytest.raises(ValueError, match="no overlappable axis"):
            dp.pad_with_halos(dp.shard(host), halo, overlap=True)
    dp = _port((2, 1, 1))
    assert dp.split_axes((2, 2, 2), (8, 16, 16)) == (0,)
    assert dp.split_axes((2, 2, 2), (5, 16, 16)) == ()
    with pytest.raises(ValueError, match="exceeds the local block"):
        _port((4, 1, 1)).share_halos(_field((8, 8, 8)), 3)


def _lap_on_padded(p, h=2):
    """A radius-h Laplacian of a padded block by slices (elementwise)."""
    coefs = pt.SecondCenteredDifference(h).coefs
    n = [p.shape[a] - 2 * h for a in range(p.ndim - 3, p.ndim)]

    def tap(axis, s):
        idx = [slice(None)] * (p.ndim - 3)
        for a in range(3):
            lo = h + (s if a == axis else 0)
            idx.append(slice(lo, lo + n[a]))
        return p[tuple(idx)]
    acc = coefs[0] * 3 * tap(0, 0)
    for s in range(1, h + 1):
        for a in range(3):
            acc = acc + coefs[s] * (tap(a, s) + tap(a, -s))
    return acc


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "".join(map(str, m)))
def test_overlap_stencil_bitexact(mesh):
    """overlap_stencil with the split (where one exists) equals the padded
    path bit for bit, extras sliced to each region; a tree of inputs and
    outputs."""
    grid, h = (32, 16, 8), 2
    dp = _port(mesh)
    xs = {"a": dp.shard(_field(grid, 1, (2,))), "b": dp.shard(_field(grid, 2))}
    extras = {"e": dp.shard(_field(grid, 3)), "s": 0.5}

    def apply(padded, ex):
        return {"la": _lap_on_padded(padded["a"]) * ex["s"],
                "lb": _lap_on_padded(padded["b"]) + ex["e"]}
    halo = (h, h, h)
    got = dp.overlap_stencil(xs, halo, apply, extras=extras, overlap=True)
    ref = dp.overlap_stencil(xs, halo, apply, extras=extras, overlap=False)
    for k in ref:
        np.testing.assert_array_equal(dp.gather_array(got[k]),
                                      dp.gather_array(ref[k]))
