"""The port's finite differences and lattice against the JAX package's,
and against the stencil eigenvalues on plane waves."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pystella_tpu as ps
import pystella_tpu_torch as pt
from pystella_tpu_torch.ops import stencil


def make_plane_wave(grid_shape, box_dim, modes):
    lattice = pt.Lattice(grid_shape, box_dim, dtype=np.float64)
    xs = [np.arange(n) * d for n, d in zip(grid_shape, lattice.dx)]
    X, Y, Z = np.meshgrid(*xs, indexing="ij")
    kx, ky, kz = [m * dk for m, dk in zip(modes, lattice.dk)]
    phase = kx * X + ky * Y + kz * Z
    return lattice, np.sin(phase), np.cos(phase), (kx, ky, kz)


@pytest.mark.parametrize("h", [1, 2, 3, 4])
def test_lap_grad_match_jax(h):
    grid_shape, dx = (16, 16, 16), (0.3, 0.25, 0.2)
    f = np.random.default_rng(8).standard_normal((2,) + grid_shape)
    decomp = ps.DomainDecomposition((1, 1, 1), devices=jax.devices()[:1])
    fdj = ps.FiniteDifferencer(decomp, h, dx, mode="halo")
    fdt = pt.FiniteDifferencer(h, dx)
    for op in ("lap", "grad"):
        ref = np.asarray(getattr(fdj, op)(jnp.asarray(f)))
        got = getattr(fdt, op)(torch.tensor(f)).numpy()
        assert got.shape == ref.shape
        err = np.max(np.abs(got - ref)) / np.max(np.abs(ref))
        assert err < 1e-12, f"{op}, h={h}: rel err {err}"


@pytest.mark.parametrize("h", [1, 2, 3, 4])
def test_plane_wave_eigenvalues(h):
    lattice, f, cosph, ks = make_plane_wave((16, 16, 16), (5.0, 4.0, 7.0),
                                            (2, 3, 1))
    fd = pt.FiniteDifferencer(h, lattice.dx)
    lap = fd.lap(torch.tensor(f)).numpy()
    eig = sum(pt.SecondCenteredDifference(h).get_eigenvalues(k, d)
              for k, d in zip(ks, lattice.dx))
    assert np.max(np.abs(lap - eig * f)) / np.max(np.abs(eig * f)) < 1e-11

    grd = fd.grad(torch.tensor(f)).numpy()
    first = pt.FirstCenteredDifference(h)
    for d, k in enumerate(ks):
        expected = first.get_eigenvalues(k, lattice.dx[d]) * cosph
        err = np.max(np.abs(grd[d] - expected)) / np.max(np.abs(expected))
        assert err < 1e-11, f"axis {d}"
    # the eigenvalue tables themselves are the JAX package's
    th = np.linspace(0, np.pi, 7)
    np.testing.assert_array_equal(
        pt.SecondCenteredDifference(h).get_eigenvalues(th, 0.3),
        ps.SecondCenteredDifference(h).get_eigenvalues(th, 0.3))
    np.testing.assert_array_equal(
        first.get_eigenvalues(th, 0.3),
        ps.FirstCenteredDifference(h).get_eigenvalues(th, 0.3))


@pytest.mark.parametrize("h", [1, 2])
def test_taps_lap_matches_difference_operator(h):
    """RollTaps' sign (taps(s)[i] == f[i+s]) and lap_from_taps' order give
    the operator's Laplacian to rounding, on a non-cubic lattice."""
    f = np.random.default_rng(9).standard_normal((2, 12, 10, 6))
    dx = (0.3, 0.25, 0.2)
    taps = stencil.RollTaps(torch.tensor(f))
    assert taps(1)[0, 3, 4, 5] == f[0, 4, 4, 5]
    assert taps(0, -1)[1, 3, 0, 5] == f[1, 3, 9, 5]
    assert taps(0, 0, 2)[0, 1, 2, 5] == f[0, 1, 2, 1]
    inv_dx2 = [1 / d**2 for d in dx]
    got = stencil.lap_from_taps(taps, pt.SecondCenteredDifference(h).coefs,
                                inv_dx2).numpy()
    ref = pt.FiniteDifferencer(h, dx).lap(torch.tensor(f)).numpy()
    assert np.max(np.abs(got - ref)) / np.max(np.abs(ref)) < 1e-13
    inv_dx = [1 / d for d in dx]
    grads = stencil.grad_from_taps(taps, pt.FirstCenteredDifference(h).coefs,
                                   inv_dx)
    ref = pt.FiniteDifferencer(h, dx).grad(torch.tensor(f)).numpy()
    for d in range(3):
        assert np.max(np.abs(grads[d].numpy() - ref[:, d])) \
            / np.max(np.abs(ref[:, d])) < 1e-13


def test_lattice_matches_jax():
    args = ((16, 12, 10), (5.0, 4.0, 7.0))
    lj, lt = ps.Lattice(*args), pt.Lattice(*args)
    assert (lt.dx, lt.dk, lt.grid_size, lt.volume, lt.dV, lt.dim) == \
        (lj.dx, lj.dk, lj.grid_size, lj.volume, lj.dV, lj.dim)
    for axis in range(3):
        np.testing.assert_array_equal(lt.mode_numbers(axis),
                                      lj.mode_numbers(axis))
        np.testing.assert_allclose(lt.coords(axis, device="cpu").numpy(),
                                   np.asarray(lj.coords(axis)), rtol=1e-6)
    assert pt.Lattice(*args, dtype=np.float64).dtype == torch.float64
