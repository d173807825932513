"""The port's RayleighGenerator against the JAX package's, on the CPU.

With the JAX package's white-noise draws handed to the port's generator
(its one draw method, ``_white_noise``, replaced), ``random=False`` modes,
``random=True`` modes, the fields made from them and the WKB pair equal
the JAX package's within 1e-12 (f64). On the port's own RNG (a
``torch.Generator``, whose numbers are not ``jax.random``'s) the fields
are held to statistics only, as tests/test_rayleigh.py holds the JAX
package's: the recovered power law and Gaussianity."""

import jax
import numpy as np
import pytest
import torch

import pystella_tpu as ps
import pystella_tpu_torch as pt

GRID = (16, 16, 16)
BOX = (10.0, 10.0, 10.0)


def _rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    return np.max(np.abs(got - ref)) / np.max(np.abs(ref))


def _np(x):
    return pt.to_numpy(x)


def _setup(dtype=np.float64, seed=42, decomp=None, grid=GRID):
    lat = ps.Lattice(grid, BOX, dtype=np.dtype(dtype).type)
    dj = ps.DomainDecomposition((1, 1, 1), devices=jax.devices()[:1])
    fj = ps.DFT(dj, grid_shape=grid, dtype=dtype)
    ft = pt.DFT(decomp, grid_shape=grid, dtype=dtype,
                device=None if decomp else "cpu")
    gj = ps.RayleighGenerator(fft=fj, dk=lat.dk, volume=lat.volume,
                              seed=seed)
    gt = pt.RayleighGenerator(fft=ft, dk=lat.dk, volume=lat.volume,
                              seed=seed)
    return lat, fj, ft, gj, gt


def _feed_jax_noise(monkeypatch, gt, seed, n, dtype=np.float64,
                    grid=GRID):
    """Replace the port's draw by the JAX generator's next ``n`` draws
    (its key split as RayleighGenerator._next_key splits it)."""
    key = jax.random.key(seed)
    draws = []
    for _ in range(n):
        key, sub = jax.random.split(key)
        draws.append(np.asarray(jax.random.normal(sub, grid, dtype)))
    it = iter(draws)
    monkeypatch.setattr(type(gt), "_white_noise",
                        lambda self: torch.from_numpy(next(it)).to(
                            self.device))
    return draws


@pytest.mark.parametrize("random", [False, True], ids=["exact", "random"])
def test_generate_matches_jax_fed(monkeypatch, random):
    """generate (the modes) and init_field, on the JAX package's noise:
    1e-12."""
    lat, fj, ft, gj, gt = _setup()
    _feed_jax_noise(monkeypatch, gt, 42, 2)
    ps_ = (lambda k: k**-2.5)
    ref = np.asarray(gj.generate(random=random, field_ps=ps_))
    got = gt.generate(random=random, field_ps=lambda k: k**-2.5)
    assert got.dtype == torch.complex128
    assert _rel(got.numpy(), ref) < 1e-12
    fx_j = np.asarray(gj.init_field(random=random, field_ps=ps_))
    fx_t = gt.init_field(random=random, field_ps=lambda k: k**-2.5)
    assert _rel(fx_t.numpy(), fx_j) < 1e-12


@pytest.mark.parametrize("random", [False, True], ids=["exact", "random"])
def test_wkb_fields_match_jax_fed(monkeypatch, random):
    """init_WKB_fields with the science example's dispersion and Hubble
    drag, on the JAX package's noise: both fields within 1e-12."""
    lat, fj, ft, gj, gt = _setup(seed=49279)
    _feed_jax_noise(monkeypatch, gt, 49279, 2)
    m2, hub = 0.73, 0.31
    fj_, dfj = gj.init_WKB_fields(
        norm=1.44e-12, random=random,
        omega_k=lambda k: jax.numpy.sqrt(k**2 + m2), hubble=hub)
    ft_, dft = gt.init_WKB_fields(
        norm=1.44e-12, random=random,
        omega_k=lambda k: torch.sqrt(k**2 + m2), hubble=hub)
    assert _rel(ft_.numpy(), fj_) < 1e-12
    assert _rel(dft.numpy(), dfj) < 1e-12


def test_vectors_match_jax_fed(monkeypatch):
    """init_transverse_vector and init_vector_from_pol through the
    Projector, on the JAX package's noise."""
    lat, fj, ft, gj, gt = _setup(seed=5)
    _feed_jax_noise(monkeypatch, gt, 5, 5)
    pj = ps.Projector(fj, 2, lat.dk, lat.dx)
    pp = pt.Projector(ft, 2, lat.dk, lat.dx)
    vj = gj.init_transverse_vector(pj, field_ps=lambda k: k**-3)
    vt = gt.init_transverse_vector(pp, field_ps=lambda k: k**-3)
    assert vt.shape == (3,) + GRID
    assert _rel(vt.numpy(), vj) < 1e-12
    wj = gj.init_vector_from_pol(pj, plus_ps=lambda k: k**-3,
                                 minus_ps=lambda k: 2 * k**-3)
    wt = gt.init_vector_from_pol(pp, plus_ps=lambda k: k**-3,
                                 minus_ps=lambda k: 2 * k**-3)
    assert _rel(wt.numpy(), wj) < 1e-12


@pytest.mark.parametrize("dtype", [np.float64, np.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("alpha", [-3.0, -1.0])
def test_power_law_recovered(dtype, alpha):
    """The port's own RNG: k^3 P(k) / (2 pi^2) recovered within 10% on the
    well-sampled shells (tests/test_rayleigh.py's band), at 32^3."""
    grid = (32, 32, 32)
    lat = pt.Lattice(grid, BOX, dtype=dtype)
    ft = pt.DFT(None, grid_shape=grid, dtype=dtype, device="cpu")
    gt = pt.RayleighGenerator(fft=ft, dk=lat.dk, volume=lat.volume, seed=42)
    spectra = pt.PowerSpectra(None, ft, lat.dk, lat.volume)
    fx = gt.init_field(field_ps=lambda k: k**alpha, random=False)
    result = spectra(fx, k_power=3)
    kbins = np.arange(spectra.num_bins) * spectra.bin_width
    mid = slice(3, spectra.num_bins // 2)
    expected = kbins[mid]**3 * kbins[mid]**alpha / (2 * np.pi**2)
    rel = np.abs(result[mid] - expected) / expected
    assert np.max(rel) < 0.1, f"max rel deviation {np.max(rel)}"


def test_gaussianity():
    """The port's own RNG: a random field's skewness and kurtosis within
    tests/test_rayleigh.py's bands."""
    grid = (32, 32, 32)
    lat = pt.Lattice(grid, BOX)
    ft = pt.DFT(None, grid_shape=grid, dtype=np.float64, device="cpu")
    gt = pt.RayleighGenerator(fft=ft, dk=lat.dk, volume=lat.volume, seed=7)
    fx = gt.init_field(field_ps=lambda k: k**-3).numpy()
    std = fx.std()
    skew = np.mean((fx - fx.mean())**3) / std**3
    kurt = np.mean((fx - fx.mean())**4) / std**4
    assert abs(skew) < 0.3, skew
    assert abs(kurt - 3) < 0.8, kurt


@pytest.mark.parametrize("mesh", [(2, 1, 1), (2, 2, 1)], ids=["211", "221"])
def test_sharded_equals_single_device(mesh):
    """On a sharded decomposition the modes are made whole on the first
    device and sharded: the same seed gives the single-device fields bit
    for bit."""
    d = pt.DomainDecomposition(mesh, devices=["cpu"] * int(np.prod(mesh)))
    *_, gs = _setup(decomp=d, seed=3)
    *_, g1 = _setup(seed=3)
    fs, dfs = gs.init_WKB_fields(norm=1.0, hubble=0.2)
    f1, df1 = g1.init_WKB_fields(norm=1.0, hubble=0.2)
    assert isinstance(fs, pt.ShardedArray)
    np.testing.assert_array_equal(_np(fs), f1.numpy())
    np.testing.assert_array_equal(_np(dfs), df1.numpy())
