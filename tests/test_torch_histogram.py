"""The port's ElementWiseMap and histograms (ops/elementwise.py,
ops/histogram.py: K13's plain version on the CPU) against the JAX
package's on shared numpy inputs: the map with temporaries and callables,
weighted_bincount, Histogrammer and FieldHistogrammer (counts exactly,
weighted sums 1e-12 in f64 and 1e-5 in f32 against the JAX package's
float32 chunks, automatic bounds equal); sharded inputs equal to the
single-device result bit for bit; the plain version's unit order fixed."""

import jax
import numpy as np
import pytest
import torch

import pystella_tpu as ps
import pystella_tpu_torch as pt
from pystella_tpu_torch.ops import histogram as thist

GRID = (16, 16, 16)
MESHES = [(2, 1, 1), (2, 2, 1)]
WEIGHTED_TOL = {np.float64: 1e-12, np.float32: 1e-5}


def _jdecomp():
    return ps.DomainDecomposition((1, 1, 1), devices=jax.devices()[:1])


def _pdecomp(mesh):
    return pt.DomainDecomposition(mesh, devices=["cpu"] * int(np.prod(mesh)))


def _field(shape, seed=3, dtype=np.float64):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(shape).astype(dtype)


def _rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    return np.max(np.abs(got - ref)) / np.max(np.abs(ref))


# -- ElementWiseMap -----------------------------------------------------------

def _maps(field):
    f = field.Field("f", shape=(2,))
    g, tmp = field.Field("g"), field.Field("tmp")
    a = field.Var("a")
    maps = {field.Field("out"): tmp * f[0] + a * field.exp(g) / f[1],
            "sq": f[1]**2 - 0.5 * g,
            field.Field("call"): lambda env: env["tmp"] * 2 + env["g"]}
    tmps = {tmp: field.sin(g) + f[0] * f[1]}
    return maps, tmps


@pytest.mark.parametrize("dtype", [np.float64, np.float32],
                         ids=["f64", "f32"])
def test_elementwise_map_matches_jax(dtype):
    """Temporaries, symbolic instructions and a callable: 1e-14 (f64) of
    the JAX package's map; sharded inputs bit for bit the single-device
    map."""
    env = {"f": _field((2,) + GRID, dtype=dtype),
           "g": _field(GRID, seed=5, dtype=dtype) + 3.0}
    mj = ps.ElementWiseMap(*_maps(ps))
    mt = pt.ElementWiseMap(*_maps(pt))
    ref = mj(a=1.25, **{k: jax.numpy.asarray(v) for k, v in env.items()})
    got = mt(a=1.25, **{k: torch.from_numpy(v) for k, v in env.items()})
    assert set(got) == set(ref) == {"out", "sq", "call"}
    tol = 1e-14 if dtype == np.float64 else 1e-6
    for k in ref:
        assert got[k].dtype == torch.from_numpy(np.asarray(ref[k])).dtype
        assert _rel(got[k].numpy(), ref[k]) < tol, k
    d = _pdecomp((2, 2, 1))
    sharded = mt(a=1.25, **{k: d.shard(v) for k, v in env.items()})
    for k in got:
        assert isinstance(sharded[k], pt.ShardedArray)
        np.testing.assert_array_equal(pt.to_numpy(sharded[k]),
                                      got[k].numpy())


# -- weighted_bincount, Histogrammer ------------------------------------------

def _bins(outer, nbins, seed=2):
    rng = np.random.default_rng(seed)
    return rng.integers(0, nbins, size=outer + GRID).astype(np.int32)


@pytest.mark.parametrize("outer", [(), (2,), (6,)],
                         ids=["scalar", "2fields", "6comps"])
@pytest.mark.parametrize("dtype", [np.float64, np.float32],
                         ids=["f64", "f32"])
def test_weighted_bincount_matches_jax(outer, dtype):
    """Counts equal the JAX package's exactly; weighted sums within 1e-12
    (f64) and 1e-5 (f32 weights: the JAX package sums float32 chunks, the
    port float64 units)."""
    nbins = 37
    b = _bins(outer, nbins)
    w = _field(outer + GRID, seed=7, dtype=dtype)
    dj = _jdecomp()
    cj = ps.ops.histogram.weighted_bincount(dj, jax.numpy.asarray(b), None,
                                            nbins)
    ct = pt.ops.histogram.weighted_bincount(None, torch.from_numpy(b), None,
                                            nbins)
    assert ct.dtype == np.int64 and ct.shape == outer + (nbins,)
    np.testing.assert_array_equal(ct, cj)
    wj = ps.ops.histogram.weighted_bincount(
        dj, jax.numpy.asarray(b), jax.numpy.asarray(w), nbins)
    wt = pt.ops.histogram.weighted_bincount(
        None, torch.from_numpy(b), torch.from_numpy(w), nbins)
    assert wt.dtype == np.float64 and wt.shape == outer + (nbins,)
    assert _rel(wt, wj) < WEIGHTED_TOL[dtype]


@pytest.mark.parametrize("dtype", [np.float64, np.float32],
                         ids=["f64", "f32"])
def test_histogrammer_matches_jax(dtype):
    """Histogrammer with a weighted and a unit-weight (exact count)
    histogram; output in ``dtype``."""
    def hists(field):
        f = field.Field("f")
        return {"w": ((f + 3) * 8, f * f + 1), "n": (f * 10 + 20, 1)}
    nbins = 50
    x = _field((2,) + GRID, dtype=dtype)
    hj = ps.Histogrammer(_jdecomp(), hists(ps), nbins, dtype)
    ht = pt.Histogrammer(None, hists(pt), nbins, dtype)
    assert ht._count_names == {"n"}
    ref = hj(f=jax.numpy.asarray(x))
    got = ht(f=torch.from_numpy(x))
    for k in ref:
        assert got[k].dtype == np.dtype(dtype) and got[k].shape == (2, nbins)
    np.testing.assert_array_equal(got["n"], ref["n"])
    assert _rel(got["w"], ref["w"]) < WEIGHTED_TOL[dtype]


@pytest.mark.parametrize("nbins", [7, 50, 3000])
@pytest.mark.parametrize("dtype", [np.float64, np.float32],
                         ids=["f64", "f32"])
def test_histogrammer_nonfinite_sites_match_jax(dtype, nbins):
    """A NaN bin value lands in bin 0, as the JAX package's int32 cast
    puts it there, and +-inf in the last and first bins: the count
    histogram equal to the JAX package's (every site counted), the
    weighted one equal where finite and NaN where the JAX one is."""
    def hists(field):
        f = field.Field("f")
        return {"w": ((f + 3) * 8, f * f + 1), "n": (f * 10 + 20, 1)}
    x = np.random.default_rng(1).standard_normal((2,) + GRID).astype(dtype)
    x[0, 0, 0, :3] = [np.inf, -np.inf, np.nan]
    ref = ps.Histogrammer(_jdecomp(), hists(ps), nbins, dtype)(
        f=jax.numpy.asarray(x))
    got = pt.Histogrammer(None, hists(pt), nbins, dtype)(
        f=torch.from_numpy(x))
    np.testing.assert_array_equal(got["n"], ref["n"])
    assert got["n"][0].sum() == got["n"][1].sum() == 16**3
    if nbins == 50:
        # the site the fix moved: bin 0 of slice 0 (ROADMAP queue 3 item 1)
        assert got["n"][0, 0] == 115
    w, wj = np.asarray(got["w"]), np.asarray(ref["w"])
    assert np.array_equal(np.isnan(w), np.isnan(wj))
    fin = np.isfinite(wj)
    assert np.array_equal(np.isfinite(w), fin)
    np.testing.assert_allclose(w[fin], wj[fin], rtol=0,
                               atol=WEIGHTED_TOL[dtype] * np.abs(
                                   wj[fin]).max())


def _field_cases(dtype):
    x = _field((2,) + GRID, dtype=dtype)
    zeros = x.copy()
    zeros[1, :4] = 0.0  # log|f| = -inf there
    return {"random": x, "with_zeros": zeros,
            "constant": np.full(GRID, 0.5, dtype)}


@pytest.mark.parametrize("case", ["random", "with_zeros", "constant"])
@pytest.mark.parametrize("dtype", [np.float64, np.float32],
                         ids=["f64", "f32"])
def test_field_histogrammer_matches_jax(case, dtype):
    """Linear and log histograms of 1000 bins (the science example's):
    counts and bin edges equal the JAX package's exactly, automatic
    bounds too (degenerate and -inf bounds sanitized alike); passed
    bounds as well."""
    x = _field_cases(dtype)[case]
    hj = ps.FieldHistogrammer(_jdecomp(), 1000, dtype)
    ht = pt.FieldHistogrammer(None, 1000, dtype)
    bj = hj._auto_bounds(jax.numpy.asarray(x))
    bt = ht._auto_bounds(torch.from_numpy(x))
    for k in bj:
        np.testing.assert_array_equal(bt[k], bj[k], err_msg=k)
    ref = hj(jax.numpy.asarray(x))
    got = ht(torch.from_numpy(x))
    assert set(got) == set(ref)
    for k in ref:
        assert got[k].dtype == np.dtype(dtype)
        np.testing.assert_array_equal(got[k], np.asarray(ref[k]), err_msg=k)
    kw = {"max_f": np.max(x) + 1, "min_f": np.min(x) - 1,
          "max_log_f": 2.0, "min_log_f": -9.0}
    np.testing.assert_array_equal(ht(torch.from_numpy(x), **kw)["log"],
                                  hj(jax.numpy.asarray(x), **kw)["log"])


# -- sharded == single device; the units --------------------------------------

@pytest.mark.parametrize("mesh", MESHES, ids=["211", "221"])
def test_sharded_equals_single_device(mesh):
    """bincount (counts and weights), Histogrammer and FieldHistogrammer
    of a ShardedArray equal the single-device results bit for bit: each
    block adds into its own units at their global rows."""
    d = _pdecomp(mesh)
    b = _bins((2,), 41)
    w = _field((2,) + GRID, seed=9)
    for weights in (None, w):
        single = thist.bincount(torch.from_numpy(b), None if weights is None
                                else torch.from_numpy(weights), 41)
        sharded = thist.bincount(d.shard(b), None if weights is None
                                 else d.shard(weights), 41)
        assert torch.equal(sharded, single)
    x = _field((2,) + GRID, seed=4)
    ht = pt.FieldHistogrammer(d, 1000)
    single, sharded = ht(torch.from_numpy(x)), ht(d.shard(x))
    for k in single:
        np.testing.assert_array_equal(sharded[k], single[k])
    h = pt.Histogrammer(d, {"w": ((pt.Field("f") + 3) * 8,
                                  pt.Field("f")**2)}, 50)
    np.testing.assert_array_equal(h(f=d.shard(x))["w"],
                                  h(f=torch.from_numpy(x))["w"])


def test_plain_unit_order_fixed():
    """The plain version sums each unit's sites in lattice order and the
    units in order: the same inputs give the same bits twice, whatever the
    data."""
    b = _bins((2,), 13)
    w = _field((2,) + GRID, seed=11) * 1e3
    one = thist.bincount_plain(torch.from_numpy(b), torch.from_numpy(w), 13)
    two = thist.bincount_plain(torch.from_numpy(b.copy()),
                               torch.from_numpy(w.copy()), 13)
    assert torch.equal(one, two)
    assert torch.equal(one, thist.bincount(torch.from_numpy(b),
                                           torch.from_numpy(w), 13))


@pytest.mark.parametrize("Y,ry", [(512, 32), (64, 16), (40, 8), (36, 4),
                                  (32, 8), (16, 4), (2, 1), (7, 1)])
def test_unit_rows(Y, ry):
    assert thist.unit_rows(Y) == ry


def test_bincount_refusals():
    """Out-of-range bins are dropped (as jnp.bincount's length does);
    non-int32 bins and mis-shaped weights raise; a mesh that splits units
    raises."""
    b = _bins((), 10)
    b[0, 0, :3] = [-1, 10, 99]
    got = thist.bincount(torch.from_numpy(b), None, 10)
    assert int(got.sum()) == b.size - 3
    with pytest.raises(TypeError, match="int32"):
        thist.bincount(torch.from_numpy(b.astype(np.int64)), None, 10)
    with pytest.raises(TypeError, match="weights"):
        thist.bincount(torch.from_numpy(b), torch.ones(4), 10)
    d = _pdecomp((1, 4, 1))
    with pytest.raises(ValueError, match="unit_rows"):
        thist.bincount(d.shard(np.zeros((8, 24, 4), np.int32)), None, 3)
    with pytest.raises(ValueError, match="shard x"):
        thist.bincount(_pdecomp((1, 1, 2)).shard(b), None, 10)
    assert thist.max_bins(True) >= 1000 and thist.max_bins(False) >= 2000
    for weighted in (True, False):
        most = thist.max_bins(weighted)
        assert thist.hist_smem(weighted, most) <= thist.SMEM_LIMIT
        assert thist.hist_smem(weighted, most + 1) > thist.SMEM_LIMIT
