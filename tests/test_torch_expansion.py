"""The port's Expansion, Reduction and FieldStatistics against the JAX
package's, on the same numpy inputs."""

import jax
import numpy as np
import pytest
import torch

import pystella_tpu as ps
import pystella_tpu_torch as pt

GRID, H, DX = (16, 16, 16), 2, (0.3, 0.25, 0.2)


def fused_test_potential(f):
    # tests/test_fused.py's potential
    return 0.5 * 1.2e-2 * f[0] ** 2 + 0.125 * f[0] ** 2 * f[1] ** 2


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.max(np.abs(got - ref) / np.maximum(np.abs(ref), 1e-300))


@pytest.mark.parametrize("mpl", [1.0, 0.7])
def test_expansion_matches_jax(mpl):
    """(a) Ten stages with given (energy, pressure), then stage_sequence:
    a, adot, hubble and the constraint agree to 1e-14 relative (both run
    the same float64 numpy arithmetic on the same tableau)."""
    rng = np.random.default_rng(3)
    energies = 1e-2 * (1 + rng.random(10))
    pressures = 1e-3 * rng.standard_normal(10)
    ref = ps.Expansion(energies[0], ps.LowStorageRK54, mpl=mpl)
    got = pt.Expansion(energies[0], pt.LowStorageRK54, mpl=mpl)
    dt = 0.05
    for i, (e, p) in enumerate(zip(energies, pressures)):
        s = i % 5
        ref.step(s, e, p, dt)
        got.step(s, e, p, dt)
        for name in ("a", "adot", "hubble"):
            assert _rel(getattr(got, name), getattr(ref, name)) < 1e-14
        assert _rel(got.constraint(e), ref.constraint(e)) < 1e-14
        assert _rel(got.constraint_residual(got.a, got.adot, e),
                    ref.constraint_residual(ref.a, ref.adot, e)) < 1e-14
    seq_ref = ref.stage_sequence(2, energies[-1], pressures[-1], dt)
    seq_got = got.stage_sequence(2, energies[-1], pressures[-1], dt)
    for r, g in zip(seq_ref, seq_got):
        assert g.shape == (10,) and _rel(g, r) < 1e-14
    assert _rel(got.a, ref.a) < 1e-14 and _rel(got.adot, ref.adot) < 1e-14


def test_expansion_from_numpy():
    ref = ps.Expansion(0.3, ps.LowStorageRK54, mpl=0.9)
    ref.step(0, 0.3, 0.01, 0.1)
    got = pt.expansion_from_numpy({"a": ref.a, "adot": ref.adot,
                                   "mpl": ref.mpl})
    assert (got.a, got.adot, got.hubble, got.mpl) == \
        (ref.a, ref.adot, ref.hubble, ref.mpl)
    # a fresh carry: the next full step agrees with JAX's from the same
    # background
    ref = ps.Expansion(0.3, ps.LowStorageRK54, mpl=0.9)
    got = pt.expansion_from_numpy({"a": ref.a, "adot": ref.adot,
                                   "mpl": 0.9})
    for s in range(5):
        ref.step(s, 0.3, 0.01, 0.1)
        got.step(s, 0.3, 0.01, 0.1)
    assert _rel(got.a, ref.a) < 1e-14 and _rel(got.adot, ref.adot) < 1e-14


def _fields(seed):
    rng = np.random.default_rng(seed)
    return {"f": 0.1 * rng.standard_normal((2,) + GRID),
            "dfdt": 0.01 * rng.standard_normal((2,) + GRID)}


def test_reduction_energy_matches_jax():
    """(b) Reduction(sector, callback=get_rho_and_p) fed lap f from each
    package's FiniteDifferencer, 16^3 f64, to 1e-13 (the two sum in other
    orders)."""
    sector_j = ps.ScalarSector(2, potential=fused_test_potential)
    sector_t = pt.ScalarSector(2, potential=fused_test_potential)
    grid_size = float(np.prod(GRID))
    st = _fields(5)
    decomp = ps.DomainDecomposition((1, 1, 1), devices=jax.devices()[:1])
    fd_j = ps.FiniteDifferencer(decomp, H, DX, mode="halo")
    red_j = ps.Reduction(decomp, sector_j, callback=ps.get_rho_and_p,
                         grid_size=grid_size)
    fj = jax.numpy.asarray(st["f"])
    ref = red_j(f=fj, dfdt=jax.numpy.asarray(st["dfdt"]),
                lap_f=fd_j.lap(fj), a=np.float64(1.3))

    fd_t = pt.FiniteDifferencer(H, DX, device="cpu")
    red_t = pt.Reduction(sector_t, callback=pt.get_rho_and_p,
                         grid_size=grid_size)
    t = pt.state_from_numpy(st, device="cpu")
    got = red_t(f=t["f"], dfdt=t["dfdt"], lap_f=fd_t.lap(t["f"]),
                a=np.float64(1.3))
    assert set(got) == set(ref)
    for name in ref:
        assert np.shape(got[name]) == np.shape(ref[name]), name
        assert _rel(got[name], ref[name]) < 1e-13, name


def test_reduction_ops_and_inputs_match_jax():
    """Every op, dict / list / tuple input, and the default grid size."""
    ft_j = ps.DynamicField("f", shape=(2,))
    ft_t = pt.DynamicField("f", shape=(2,))

    def spec(ft):
        return {"avg": ft[0] * ft[1],
                "sum": (ft[0] ** 2, "sum"),
                "ext": [(ft[1], "max"), (ft[1], "min"), (ft[0], "avg")],
                "prod": (1 + 0.01 * ft[0], "prod")}
    st = _fields(9)
    decomp = ps.DomainDecomposition((1, 1, 1), devices=jax.devices()[:1])
    ref = ps.Reduction(decomp, spec(ft_j))(f=jax.numpy.asarray(st["f"]))
    got = pt.Reduction(spec(ft_t))(f=torch.tensor(st["f"]))
    for name in ref:
        assert np.shape(got[name]) == np.shape(ref[name]), name
        assert _rel(got[name], ref[name]) < 1e-13, name
    with pytest.raises(ValueError, match="unknown reduction op"):
        pt.Reduction({"x": (ft_t[0], "median")})
    with pytest.raises(ValueError, match="lattice"):
        pt.Reduction(spec(ft_t))(a=1.0)


@pytest.mark.parametrize("max_min", [False, True])
def test_field_statistics_match_jax(max_min):
    st = _fields(12)
    decomp = ps.DomainDecomposition((1, 1, 1), devices=jax.devices()[:1])
    ref = ps.FieldStatistics(decomp, max_min=max_min)(
        jax.numpy.asarray(st["f"]))
    got = pt.FieldStatistics(max_min=max_min)(torch.tensor(st["f"]))
    assert set(got) == set(ref)
    for name in ref:
        assert got[name].shape == (2,)
        assert _rel(got[name], ref[name]) < 1e-12, name
