"""The port's Fourier stack (pystella_tpu_torch.fourier, ops/fft_stencil.py)
against the JAX package's on shared numpy inputs, on the CPU: DFT forward
and inverse, fftfreq / make_hermitian / zero_corner_modes, the Projector's
eight methods, PowerSpectra (bin_counts exactly; the spectra binned by
K14's plain version), SpectralCollocator, SpectralPoissonSolver and
fft_laplacian; every sharded result equal to the single-device one bit for
bit; the pencil scheme refused; complex arrays across the boundary."""

import jax
import numpy as np
import pytest
import torch

import pystella_tpu as ps
import pystella_tpu_torch as pt
from pystella_tpu_torch import config as tconfig
from pystella_tpu_torch._device import torch_dtype
from pystella_tpu_torch.fourier import (
    ensure_spectral_fft, fftfreq, make_hermitian,
)
from pystella_tpu_torch.ops.histogram import unit_rows

BOX = (5.0, 5.0, 5.0)
GRIDS = [(16, 16, 16), (12, 16, 20)]
MESHES = [(2, 1, 1), (2, 2, 1)]
#: f64 against the JAX package: the transforms (pocketfft in both, other
#: plans) and the binning's float64 sums differ in order only
TOL = {np.float64: 1e-12, np.float32: 1e-5}


def _jdecomp():
    return ps.DomainDecomposition((1, 1, 1), devices=jax.devices()[:1])


def _pdecomp(mesh):
    return pt.DomainDecomposition(mesh, devices=["cpu"] * int(np.prod(mesh)))


def _rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    return np.max(np.abs(got - ref)) / np.max(np.abs(ref))


def _np(x):
    return pt.to_numpy(x) if not isinstance(x, np.ndarray) else x


def _field(shape, seed=3, dtype=np.float64):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(shape).astype(dtype)


def _kfield(shape, seed=4, dtype=np.complex128):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(dtype)


def _pair(grid, dtype=np.float64):
    """The JAX and the port's transforms and lattices of one problem."""
    lat = ps.Lattice(grid, BOX, dtype=np.dtype(dtype).type)
    fj = ps.DFT(_jdecomp(), grid_shape=grid, dtype=dtype)
    ft = pt.DFT(None, grid_shape=grid, dtype=dtype, device="cpu")
    return lat, fj, ft


# -- complex dtypes across the boundary ---------------------------------------

@pytest.mark.parametrize("dtype", [np.complex64, np.complex128],
                         ids=["c64", "c128"])
def test_complex_round_trip(dtype):
    """torch_dtype maps complex64/128; a complex k-space array (as the JAX
    package's dft returns it) crosses into tensors and back unchanged in
    dtype and value, whole and sharded."""
    assert torch_dtype(dtype) == {np.complex64: torch.complex64,
                                  np.complex128: torch.complex128}[dtype]
    fk = _kfield((2, 8, 8, 5), dtype=dtype)
    t = pt.state_from_numpy({"fk": fk}, device="cpu")
    assert t["fk"].dtype == torch_dtype(dtype)
    back = pt.to_numpy(t)["fk"]
    assert back.dtype == np.dtype(dtype)
    np.testing.assert_array_equal(back, fk)
    d = _pdecomp((2, 2, 1))
    sharded = pt.shard_state(d, {"fk": fk})
    np.testing.assert_array_equal(pt.to_numpy(sharded)["fk"], fk)
    assert d.zeros((8, 8, 4), dtype).dtype == torch_dtype(dtype)


def test_fft_knobs_registered(monkeypatch):
    """The knobs the new modules read, with the JAX package's defaults."""
    assert tconfig.getenv("PYSTELLA_FFT_SCHEME") == "auto"
    assert tconfig.getenv("PYSTELLA_FFT_STENCIL") == "auto"
    assert tconfig.get_float("PYSTELLA_FFT_STENCIL_CROSSOVER") == 1.5
    monkeypatch.setenv("PYSTELLA_FFT_STENCIL_CROSSOVER", "2.5")
    assert tconfig.get_float("PYSTELLA_FFT_STENCIL_CROSSOVER") == 2.5
    with pytest.raises(KeyError):
        tconfig.getenv("PYSTELLA_FFT_REPLICATE_LIMIT")
    for override in (True, False):
        assert pt.ops.fft_stencil.use_fft_stencil(
            (16,) * 3, 1, override=override) == ps.ops.fft_stencil.\
            use_fft_stencil((16,) * 3, 1, override=override)
    for r, n in ((1, 1), (4, 20), (8, 40)):
        assert pt.ops.fft_stencil.use_fft_stencil((64,) * 3, r, n) == \
            ps.ops.fft_stencil.use_fft_stencil((64,) * 3, r, n)


# -- transforms ---------------------------------------------------------------

@pytest.mark.parametrize("kind", ["r2c", "c2c"])
@pytest.mark.parametrize("grid", GRIDS, ids=["16cubed", "12x16x20"])
def test_dft_matches_jax(grid, kind):
    """Forward and inverse transforms, with an outer axis: 1e-13 relative
    (f64)."""
    dtype = np.float64 if kind == "r2c" else np.complex128
    _, fj, ft = _pair(grid, dtype)
    x = (_field((2,) + grid) if kind == "r2c"
         else _kfield((2,) + grid))
    kj = np.asarray(fj.dft(jax.numpy.asarray(x)))
    kt = ft.dft(torch.from_numpy(x))
    assert tuple(kt.shape) == (2,) + ft.shape(True) == kj.shape
    assert _rel(kt.numpy(), kj) < 1e-13
    xj = np.asarray(fj.idft(jax.numpy.asarray(kj)))
    xt = ft.idft(torch.from_numpy(kj))
    assert xt.dtype == torch_dtype(dtype)
    assert _rel(xt.numpy(), xj) < 1e-13
    assert _rel(xt.numpy(), x) < 1e-13
    # a numpy operand, as the JAX package's dft takes one
    assert _rel(ft.dft(x).numpy(), kj) < 1e-13


@pytest.mark.parametrize("n", [7, 8, 9, 16])
def test_fftfreq_exact(n):
    np.testing.assert_array_equal(fftfreq(n), ps.fftfreq(n))


@pytest.mark.parametrize("shape", [(12, 16, 11), (2, 9, 8, 5)],
                         ids=["12x16x11", "outer_9x8x5"])
def test_make_hermitian_exact(shape):
    fk = _kfield(shape)
    ref = np.asarray(ps.make_hermitian(fk))
    np.testing.assert_array_equal(make_hermitian(fk), ref)
    np.testing.assert_array_equal(
        make_hermitian(torch.from_numpy(fk)).numpy(), ref)


@pytest.mark.parametrize("only_imag", [False, True])
def test_zero_corner_modes_exact(only_imag):
    grid = (12, 16, 20)
    _, fj, ft = _pair(grid)
    fk = _kfield((2,) + ft.shape(True))
    ref = np.asarray(fj.zero_corner_modes(fk, only_imag=only_imag))
    np.testing.assert_array_equal(
        ft.zero_corner_modes(fk, only_imag=only_imag), ref)
    got = ft.zero_corner_modes(torch.from_numpy(fk), only_imag=only_imag)
    np.testing.assert_array_equal(got.numpy(), ref)


# -- projections --------------------------------------------------------------

PROJECTIONS = ["transversify", "vec_to_pol", "pol_to_vec",
               "decompose_vector", "decomp_to_vec", "transverse_traceless",
               "tensor_to_pol", "pol_to_tensor"]


def _projection_args(name, kshape):
    vec, pol = (3,) + kshape, kshape
    return {"transversify": [vec], "vec_to_pol": [vec],
            "pol_to_vec": [pol, pol], "decompose_vector": [vec],
            "decomp_to_vec": [pol, pol, pol],
            "transverse_traceless": [(6,) + kshape],
            "tensor_to_pol": [(6,) + kshape],
            "pol_to_tensor": [pol, pol]}[name]


@pytest.mark.parametrize("h", [0, 2])
@pytest.mark.parametrize("name", PROJECTIONS)
def test_projector_matches_jax(name, h):
    """Each projection within 1e-12 of the JAX package's (f64), continuum
    and stencil-effective momenta."""
    grid = (12, 16, 20)
    lat, fj, ft = _pair(grid)
    pj = ps.Projector(fj, h, lat.dk, lat.dx)
    pp = pt.Projector(ft, h, lat.dk, lat.dx)
    for k in pj.eff_mom:
        np.testing.assert_array_equal(pp.eff_mom[k], pj.eff_mom[k])
    args = [_kfield(s, seed=10 + i)
            for i, s in enumerate(_projection_args(name, ft.shape(True)))]
    kw = {"times_abs_k": True} if name in ("decompose_vector",
                                           "decomp_to_vec") else {}
    ref = getattr(pj, name)(*map(jax.numpy.asarray, args), **kw)
    got = getattr(pp, name)(*map(torch.from_numpy, args), **kw)
    ref = ref if isinstance(ref, tuple) else (ref,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        assert _rel(g.numpy(), r) < 1e-12


# -- spectra ------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.float64, np.float32],
                         ids=["f64", "f32"])
def test_power_spectra_matches_jax(dtype):
    """bin_counts and the number of bins exactly; __call__ (2 fields),
    gw, polarization and vector_decomposition within 1e-12 (f64) / 1e-5
    (f32)."""
    grid = (16, 16, 16)
    lat, fj, ft = _pair(grid, dtype)
    sj = ps.PowerSpectra(_jdecomp(), fj, lat.dk, lat.volume)
    st = pt.PowerSpectra(None, ft, lat.dk, lat.volume)
    assert st.num_bins == sj.num_bins
    np.testing.assert_array_equal(st.bin_counts, sj.bin_counts)
    pj = ps.Projector(fj, 2, lat.dk, lat.dx)
    pp = pt.Projector(ft, 2, lat.dk, lat.dx)
    f = _field((2,) + grid, dtype=dtype)
    vec = _field((3,) + grid, seed=5, dtype=dtype)
    hij = _field((6,) + grid, seed=6, dtype=dtype)
    cases = [(sj(jax.numpy.asarray(f)), st(torch.from_numpy(f))),
             (sj(jax.numpy.asarray(f), k_power=2),
              st(torch.from_numpy(f), k_power=2)),
             (sj.gw(jax.numpy.asarray(hij), pj, 0.7),
              st.gw(torch.from_numpy(hij), pp, 0.7)),
             (sj.polarization(jax.numpy.asarray(vec), pj),
              st.polarization(torch.from_numpy(vec), pp)),
             (sj.vector_decomposition(jax.numpy.asarray(vec), pj),
              st.vector_decomposition(torch.from_numpy(vec), pp)),
             (sj.gw_polarization(jax.numpy.asarray(hij), pj, 0.7),
              st.gw_polarization(torch.from_numpy(hij), pp, 0.7))]
    for ref, got in cases:
        assert np.shape(got) == np.shape(ref)
        assert _rel(got, ref) < TOL[dtype]


@pytest.mark.parametrize("dtype", [np.float64, np.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("case", [((16, 16, 16), (5., 5., 5.), True),
                                  ((12, 16, 20), (5., 4., 7.), True),
                                  ((9, 8, 7), (3., 5., 4.), True),
                                  ((12, 16, 20), (5., 4., 7.), False)],
                         ids=["16cubed", "12x16x20", "9x8x7", "c2c"])
def test_spectra_bins_from_axis_tables_exact(case, dtype):
    """K14 derives |k|, the bin and the count weight from each site's index
    and three axis tables; those equal the host arrays PowerSpectra (and
    the JAX package) make with numpy over the whole k-grid, bit for bit."""
    grid, box, real = case
    lat = ps.Lattice(grid, box, dtype=dtype)
    dt = dtype if real else {np.float64: np.complex128,
                             np.float32: np.complex64}[dtype]
    ft = pt.DFT(None, grid_shape=grid, dtype=dt, device="cpu")
    st = pt.PowerSpectra(None, ft, lat.dk, lat.volume)
    kvecs = np.meshgrid(*ft.sub_k.values(), indexing="ij", sparse=False)
    kmags = np.sqrt(sum((dki * ki)**2 for dki, ki in zip(lat.dk, kvecs)))
    bins = np.round(kmags / st.bin_width).astype(np.int32)
    kshape = ft.shape(True)
    kmag, tbins, counts = st.binner.site_arrays("cpu", 0, 0, *kshape[:2])
    np.testing.assert_array_equal(kmag.numpy(), kmags)
    np.testing.assert_array_equal(tbins.numpy(), bins)
    ref_counts = np.ones(kshape)
    if real:
        ref_counts = 2.0 * ref_counts
        ref_counts[kvecs[2] == 0] = 1.0
        ref_counts[kvecs[2] == grid[-1] // 2] = 1.0
    np.testing.assert_array_equal(counts.numpy(), ref_counts)
    assert np.array_equal(
        np.histogram(kmags, weights=ref_counts,
                     bins=np.arange(-0.5, st.num_bins + 0.5)
                     * st.bin_width)[0], st.bin_counts)


# -- spectral derivatives, Poisson, FFT stencils ------------------------------

@pytest.mark.parametrize("op", ["lap", "grad", "grad_lap", "pdx", "pdy",
                                "pdz", "divergence"])
def test_spectral_collocator_matches_jax(op):
    grid = (12, 16, 20)
    lat, fj, ft = _pair(grid)
    cj = ps.SpectralCollocator(fj, lat.dk)
    ct = pt.SpectralCollocator(ft, lat.dk)
    x = _field(((6,) if op == "divergence" else (2,)) + grid)
    if op == "divergence":
        x = x.reshape((2, 3) + grid)
    ref = getattr(cj, op)(jax.numpy.asarray(x))
    got = getattr(ct, op)(torch.from_numpy(x))
    ref = ref if isinstance(ref, tuple) else (ref,)
    got = got if isinstance(got, tuple) else (got,)
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        assert _rel(g.numpy(), r) < 1e-12


@pytest.mark.parametrize("m_squared", [0.0, 1.5])
def test_poisson_matches_jax(m_squared):
    grid = (16, 16, 16)
    lat, fj, ft = _pair(grid)
    eig = ps.SecondCenteredDifference(2).get_eigenvalues
    sj = ps.SpectralPoissonSolver(fj, lat.dk, lat.dx, eig)
    sp = pt.SpectralPoissonSolver(
        ft, lat.dk, lat.dx, pt.SecondCenteredDifference(2).get_eigenvalues)
    rho = _field(grid)
    rho = rho - rho.mean()
    ref = sj(rho=jax.numpy.asarray(rho), m_squared=m_squared)
    got = sp(rho=torch.from_numpy(rho), m_squared=m_squared)
    assert _rel(got.numpy(), ref) < 1e-12


@pytest.mark.parametrize("h", [1, 2, 4])
def test_fft_laplacian_matches_fd_lap_and_jax(h):
    """fft_laplacian applied once is the order-2h Laplacian: within 1e-13
    (relative to its largest value) of the port's FiniteDifferencer.lap
    and of the JAX package's fft_laplacian."""
    grid = (12, 16, 20)
    lat, fj, ft = _pair(grid)
    f = _field((2,) + grid)
    got = pt.fft_laplacian(ft, lat.dx, h)(torch.from_numpy(f))
    fd = pt.FiniteDifferencer(h, lat.dx, device="cpu").lap(
        torch.from_numpy(f))
    ref = ps.ops.fft_stencil.fft_laplacian(fj, lat.dx, h)(
        jax.numpy.asarray(f))
    assert _rel(got.numpy(), fd.numpy()) < 1e-13
    assert _rel(got.numpy(), ref) < 1e-13
    two = pt.fft_laplacian(ft, lat.dx, h)(torch.from_numpy(f), repeats=2)
    assert _rel(two.numpy(), pt.FiniteDifferencer(h, lat.dx, device="cpu")
                .lap(fd).numpy()) < 1e-12


# -- sharded == single device -------------------------------------------------

@pytest.mark.parametrize("mesh", MESHES, ids=["211", "221"])
def test_sharded_equals_single_device(mesh):
    """On (2, 1, 1) and (2, 2, 1): the transforms, the spectra (K14's plain
    version block by block), the projections, the spectral derivatives,
    Poisson and fft_laplacian equal the single-device results bit for
    bit; k-space is sharded along x and y with z whole."""
    grid = (16, 16, 16)
    assert 16 // mesh[1] % unit_rows(16) == 0
    lat = ps.Lattice(grid, BOX, dtype=np.float64)
    d = _pdecomp(mesh)
    ft = pt.DFT(None, grid_shape=grid, dtype=np.float64, device="cpu")
    fs = pt.DFT(d, grid_shape=grid, dtype=np.float64)
    f = _field((2,) + grid)
    hij = _field((6,) + grid, seed=8)
    fx, fxs = torch.from_numpy(f), d.shard(f)

    ks = fs.dft(fxs)
    assert isinstance(ks, pt.ShardedArray)
    assert ks.block_shape == (2, 16 // mesh[0], 16 // mesh[1], 9)
    np.testing.assert_array_equal(_np(ks), ft.dft(fx).numpy())
    np.testing.assert_array_equal(_np(fs.idft(ks)),
                                  ft.idft(ft.dft(fx)).numpy())

    st = pt.PowerSpectra(None, ft, lat.dk, lat.volume)
    ss = pt.PowerSpectra(d, fs, lat.dk, lat.volume)
    np.testing.assert_array_equal(ss(fxs), st(fx))
    pp = pt.Projector(ft, 2, lat.dk, lat.dx)
    ps_ = pt.Projector(fs, 2, lat.dk, lat.dx)
    np.testing.assert_array_equal(
        ss.gw(d.shard(hij), ps_, 0.7), st.gw(torch.from_numpy(hij), pp, 0.7))
    tt = ps_.transverse_traceless(fs.dft(d.shard(hij)))
    assert isinstance(tt, pt.ShardedArray)
    np.testing.assert_array_equal(
        _np(tt), pp.transverse_traceless(ft.dft(torch.from_numpy(hij)))
        .numpy())

    ct, cs = pt.SpectralCollocator(ft, lat.dk), pt.SpectralCollocator(
        fs, lat.dk)
    for op in ("lap", "grad", "pdy"):
        np.testing.assert_array_equal(_np(getattr(cs, op)(fxs)),
                                      getattr(ct, op)(fx).numpy())
    eig = pt.SecondCenteredDifference(2).get_eigenvalues
    np.testing.assert_array_equal(
        _np(pt.SpectralPoissonSolver(fs, lat.dk, lat.dx, eig)(rho=fxs)),
        pt.SpectralPoissonSolver(ft, lat.dk, lat.dx, eig)(rho=fx).numpy())
    np.testing.assert_array_equal(
        _np(pt.fft_laplacian(fs, lat.dx, 2)(fxs)),
        pt.fft_laplacian(ft, lat.dx, 2)(fx).numpy())


def test_z_sharded_mesh_refused():
    with pytest.raises(NotImplementedError, match="queue 1 item 5"):
        pt.DFT(_pdecomp((1, 1, 2)), grid_shape=(8, 8, 8))


# -- the pencil scheme --------------------------------------------------------

def test_pencil_scheme_raises(monkeypatch):
    grid = (16, 16, 16)
    lat = ps.Lattice(grid, BOX, dtype=np.float64)
    d = _pdecomp((2, 1, 1))
    with pytest.raises(NotImplementedError, match="queue 1 item 5"):
        pt.make_dft(d, grid_shape=grid, scheme="pencil")
    fft = pt.make_dft(d, grid_shape=grid)
    assert isinstance(fft, pt.DFT) and fft.scheme == "gather"
    assert ensure_spectral_fft(fft, "dft") is fft
    with pytest.raises(NotImplementedError):
        pt.PowerSpectra(d, fft, lat.dk, lat.volume, scheme="pencil")
    with pytest.raises(ValueError, match="unknown FFT scheme"):
        pt.make_dft(d, grid_shape=grid, scheme="slab")
    monkeypatch.setenv("PYSTELLA_FFT_SCHEME", "pencil")
    with pytest.raises(NotImplementedError):
        pt.make_dft(d, grid_shape=grid)
    with pytest.raises(NotImplementedError):
        pt.Projector(fft, 2, lat.dk, lat.dx)
