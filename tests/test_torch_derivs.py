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
    fdt = pt.FiniteDifferencer(h, dx, device="cpu")
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
    fd = pt.FiniteDifferencer(h, lattice.dx, device="cpu")
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
    fd = pt.FiniteDifferencer(h, dx, device="cpu")
    ref = fd.lap(torch.tensor(f)).numpy()
    assert np.max(np.abs(got - ref)) / np.max(np.abs(ref)) < 1e-13
    inv_dx = [1 / d for d in dx]
    grads = stencil.grad_from_taps(taps, pt.FirstCenteredDifference(h).coefs,
                                   inv_dx)
    ref = fd.grad(torch.tensor(f)).numpy()
    for d in range(3):
        assert np.max(np.abs(grads[d].numpy() - ref[:, d])) \
            / np.max(np.abs(ref[:, d])) < 1e-13


#: the stencil radius whose batch call on two outer axes is compared
OUTER_H = 2


@pytest.fixture(scope="module")
def jax_operators():
    """Every operator of the JAX FiniteDifferencer on one shared input, in
    its halo mode and its Pallas mode (interpret; 16^3 takes the resident
    kernel), for h = 1..4, computed once: a scalar-like (2, 16^3) input
    for grad_lap/pd* (lap and grad alone: test_lap_grad_match_jax), a
    (2, 3, 16^3) vector for div and, at one h, for the batch call on two
    outer axes."""
    grid_shape, dx = (16, 16, 16), (0.3, 0.25, 0.2)
    rng = np.random.default_rng(8)
    f = rng.standard_normal((2,) + grid_shape)
    vec = rng.standard_normal((2, 3) + grid_shape)
    decomp = ps.DomainDecomposition((1, 1, 1), devices=jax.devices()[:1])
    out = {"f": f, "vec": vec, "dx": dx}
    for h in (1, 2, 3, 4):
        for mode in ("halo", "pallas"):
            fd = ps.FiniteDifferencer(decomp, h, dx, mode=mode)
            jf, jvec = jnp.asarray(f), jnp.asarray(vec)
            res = {op: getattr(fd, op)(jf) for op in ("pdx", "pdy", "pdz")}
            res["grad_lap.grad"], res["grad_lap.lap"] = fd.grad_lap(jf)
            res["divergence"] = fd.divergence(jvec)
            if h == OUTER_H:
                call = fd(jvec, lap=True, grd=True, div=True)
                res.update({"call." + k: v for k, v in call.items()})
            out[h, mode] = {k: np.asarray(v) for k, v in res.items()}
    return out


def port_operators(fd, f, vec):
    f, vec = torch.tensor(f), torch.tensor(vec)
    res = {op: getattr(fd, op)(f)
           for op in ("lap", "grad", "pdx", "pdy", "pdz")}
    res["grad_lap.grad"], res["grad_lap.lap"] = fd.grad_lap(f)
    res["divergence"] = fd.divergence(vec)
    # two outer axes, through the batch call
    res.update({"call." + k: v
                for k, v in fd(vec, lap=True, grd=True, div=True).items()})
    return {k: v.numpy() for k, v in res.items()}


@pytest.mark.parametrize("mode", ["halo", "pallas"])
@pytest.mark.parametrize("h", [1, 2, 3, 4])
def test_operators_match_jax(jax_operators, h, mode):
    """grad_lap, pdx/pdy/pdz, divergence, outer axes and the batch call
    against the JAX package, <= 1e-12 of the output's largest value."""
    ref = jax_operators[h, mode]
    got = port_operators(pt.FiniteDifferencer(h, jax_operators["dx"],
                                              device="cpu"),
                         jax_operators["f"], jax_operators["vec"])
    assert set(ref) <= set(got) and ("call.grd" in ref) == (h == OUTER_H)
    for op in ref:
        assert got[op].shape == ref[op].shape, op
        err = np.max(np.abs(got[op] - ref[op])) / np.max(np.abs(ref[op]))
        assert err < 1e-12, f"{op}, h={h}, {mode}: rel err {err}"


@pytest.mark.parametrize("h", [1, 2, 3, 4])
def test_plain_versions_match_roll_mode(h):
    """The kernels' plain versions (taps order, what a CPU tensor takes)
    against the explicit ``mode="roll"`` sums, <= 1e-13, on a non-cubic
    lattice; the fused gradient + Laplacian equal the separate ones bit
    for bit."""
    rng = np.random.default_rng(10)
    f = rng.standard_normal((2, 12, 10, 8))
    vec = rng.standard_normal((2, 3, 12, 10, 8))
    dx = (0.3, 0.25, 0.2)
    got = port_operators(pt.FiniteDifferencer(h, dx, device="cpu"), f, vec)
    ref = port_operators(pt.FiniteDifferencer(h, dx, mode="roll",
                                                device="cpu"), f, vec)
    for op in ref:
        err = np.max(np.abs(got[op] - ref[op])) / np.max(np.abs(ref[op]))
        assert err < 1e-13, f"{op}, h={h}: rel err {err}"
    np.testing.assert_array_equal(got["grad_lap.grad"], got["grad"])
    np.testing.assert_array_equal(got["grad_lap.lap"], got["lap"])
    np.testing.assert_array_equal(got["call.div"], got["divergence"])


def test_operator_contracts():
    """A lattice array without component axes works; the vector axis must
    have length 3; unknown modes and operators and non-float inputs are
    refused; nothing is counted as a launch on the CPU."""
    from pystella_tpu_torch.ops import derivs
    fd = pt.FiniteDifferencer(2, 0.1, device="cpu")
    x = torch.tensor(np.random.default_rng(1).standard_normal((8, 6, 4)))
    derivs.reset_launch_counts()
    assert fd.lap(x).shape == (8, 6, 4)
    assert fd.grad(x).shape == (3, 8, 6, 4)
    assert fd.pdz(x.float()).dtype == torch.float32
    # a transposed (non-contiguous) view is taken as its values
    xt = x.transpose(0, 1)
    torch.testing.assert_close(fd.lap(xt), fd.lap(xt.contiguous()),
                               rtol=0, atol=0)
    assert fd(x) == {}
    assert set(derivs.KERNELS) == {"fd_" + op for op in derivs.OPS}
    assert set(derivs.LAUNCHES) == set(derivs.KERNELS) | {
        f"fd_{op}:{kind}" for op in derivs.OPS for kind in derivs.PAD_KINDS}
    assert set(derivs.LAUNCHES.values()) == {0}
    with pytest.raises(ValueError):
        fd.divergence(torch.zeros(2, 8, 6, 4, dtype=torch.float64))
    with pytest.raises(ValueError):
        fd.divergence(x)
    with pytest.raises(ValueError):
        pt.FiniteDifferencer(2, 0.1, mode="halo")
    with pytest.raises(ValueError):
        fd.launch("curl", x[None])
    with pytest.raises(ValueError):
        fd.launch("lap", x)
    with pytest.raises(ValueError):
        fd.lap(torch.zeros(8, 6, 4, dtype=torch.int64))
    assert "#define PK_H 3" in derivs.kernel_header(3)


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
