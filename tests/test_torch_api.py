"""The smaller parts of the port's public surface against the JAX package's:
``ScalarSector.energy_means``, the steppers' ``multi_step_fn``, the
symbolic stencils ``expand_stencil`` and ``centered_diff``, the top-level
math functions and coordinate symbols, and ``FiniteDifferencer``'s device
resolution."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pystella_tpu as ps
import pystella_tpu_torch as pt
from pystella_tpu.ops.fused import FusedScalarStepper as JaxFused

GRID, H, DX, DT = (16, 16, 16), 2, (0.3, 0.25, 0.2), 0.01
ARGS = {"a": 1.3, "hubble": 0.21}


def potential(f):
    # tests/test_energy.py's potential
    return 0.3 * f[0] ** 2 + 0.05 * f[0] ** 2 * f[1] ** 2


def fused_test_potential(f):
    # tests/test_fused.py's potential
    return 0.5 * 1.2e-2 * f[0] ** 2 + 0.125 * f[0] ** 2 * f[1] ** 2


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.max(np.abs(got - ref)) / np.max(np.abs(ref))


# -- ScalarSector.energy_means ------------------------------------------------

@pytest.mark.parametrize("with_lap", [True, False], ids=["lap", "no-lap"])
def test_energy_means_matches_jax(with_lap):
    """energy_means on the same arrays as the JAX package's: every entry
    (kinetic, potential, gradient when lap_f is given, total) to 1e-14
    relative or 1e-15 absolute (the means of O(1) terms; the gradient
    energy of this random input cancels to 1e-4, and the two packages sum
    in other orders); 0-d tensors of the input's dtype."""
    rng = np.random.default_rng(21)
    f, dfdt, lap = (rng.standard_normal((2, 8, 6, 10)) for _ in range(3))
    a = 1.7
    ref = ps.ScalarSector(2, potential=potential).energy_means(
        jnp.asarray(f), jnp.asarray(dfdt), a,
        jnp.asarray(lap) if with_lap else None)
    got = pt.ScalarSector(2, potential=potential).energy_means(
        torch.tensor(f), torch.tensor(dfdt), a,
        torch.tensor(lap) if with_lap else None)
    assert set(got) == set(ref) == (
        {"kinetic", "potential", "total"} | ({"gradient"} if with_lap
                                              else set()))
    for k in ref:
        assert got[k].dtype == torch.float64 and got[k].ndim == 0
        np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=1e-14,
                                   atol=1e-15)


def test_energy_means_vs_direct_and_reducers():
    """tests/test_energy.py's direct sums and the reducers' lattice means
    (through get_rho_and_p), summed over the fields: energy_means gives
    the same kinetic, gradient and potential energy to 1e-12, with
    FiniteDifferencer's Laplacian."""
    rng = np.random.default_rng(21)
    grid = (16, 16, 16)
    f = rng.standard_normal((2,) + grid)
    dfdt = rng.standard_normal((2,) + grid)
    a = 1.7
    lattice = pt.Lattice(grid, (2 * np.pi,) * 3, dtype=np.float64)
    lap = pt.FiniteDifferencer(2, lattice.dx, device="cpu").lap(
        torch.tensor(f))
    sector = pt.ScalarSector(2, potential=potential)
    got = sector.energy_means(torch.tensor(f), torch.tensor(dfdt), a, lap)
    kin = np.sum(np.mean(dfdt ** 2, axis=(1, 2, 3))) / 2 / a ** 2
    pot = np.mean(0.3 * f[0] ** 2 + 0.05 * f[0] ** 2 * f[1] ** 2)
    grad = np.sum(np.mean(-f * lap.numpy(), axis=(1, 2, 3))) / 2 / a ** 2
    np.testing.assert_allclose(float(got["kinetic"]), kin, rtol=1e-12)
    np.testing.assert_allclose(float(got["potential"]), pot, rtol=1e-12)
    np.testing.assert_allclose(float(got["gradient"]), grad, rtol=1e-12)
    red = pt.Reduction(sector, callback=pt.get_rho_and_p,
                       grid_size=float(np.prod(grid)))(
        f=torch.tensor(f), dfdt=torch.tensor(dfdt), lap_f=lap, a=a)
    np.testing.assert_allclose(float(got["total"]), float(red["total"]),
                               rtol=1e-12)


# -- multi_step_fn ------------------------------------------------------------

def test_stepper_multi_step_fn_matches_jax():
    """The generic stepper's multi_step_fn (time advanced by dt per step)
    vs the JAX package's on the wave equation with a time-dependent drive,
    three steps, to 1e-12, and bit-equal to three step() calls; the
    constructor takes the JAX package's keyword options (donate=) and runs
    as without them."""
    rng = np.random.default_rng(3)
    f0, df0 = rng.standard_normal((2,) + (12, 10, 8))
    decomp = ps.DomainDecomposition((1, 1, 1), devices=jax.devices()[:1])
    fdj = ps.FiniteDifferencer(decomp, 2, DX, mode="roll")
    fdt = pt.FiniteDifferencer(2, DX, device="cpu")

    def rhs(fd):
        # a time-dependent drive, so the time argument counts
        return lambda s, t: {"f": s["dfdt"],
                             "dfdt": fd.lap(s["f"]) + 0.1 * t * s["f"]}
    jfn = ps.LowStorageRK54(rhs(fdj)).multi_step_fn(3)
    ref = jfn({"f": jnp.asarray(f0), "dfdt": jnp.asarray(df0)}, 0.5, 0.02,
              {})
    fn = pt.LowStorageRK54(rhs(fdt), donate=True).multi_step_fn(3)
    got = fn({"f": torch.tensor(f0), "dfdt": torch.tensor(df0)}, 0.5, 0.02,
             {})
    for k in ("f", "dfdt"):
        assert _rel(got[k], ref[k]) < 1e-12, k
    seq = {"f": torch.tensor(f0), "dfdt": torch.tensor(df0)}
    st = pt.LowStorageRK54(rhs(fdt))
    for i in range(3):
        seq = st.step(seq, 0.5 + i * 0.02, 0.02)
    for k in ("f", "dfdt"):
        assert torch.equal(got[k], seq[k])


@pytest.fixture(scope="module")
def jax_fused_fn():
    """The JAX fused stepper's multi_step_fn(2) and (3) on the f64 state,
    jitted (interpret mode, bx=4, by=8)."""
    decomp = ps.DomainDecomposition((1, 1, 1), devices=jax.devices()[:1])
    fused = JaxFused(ps.ScalarSector(2, potential=fused_test_potential),
                     decomp, GRID, DX, H, dtype=jnp.float64, bx=4, by=8)
    out = {}
    for n in (2, 3):
        res = jax.jit(fused.multi_step_fn(n))(
            {k: jnp.asarray(v) for k, v in _fused_state().items()}, 0.0, DT,
            ARGS)
        out[n] = {k: np.asarray(v) for k, v in res.items()}
    return out


def _fused_state():
    rng = np.random.default_rng(11)
    return {"f": rng.standard_normal((2,) + GRID),
            "dfdt": 0.1 * rng.standard_normal((2,) + GRID)}


@pytest.mark.parametrize("nsteps", [2, 3])
def test_fused_multi_step_fn(jax_fused_fn, nsteps):
    """FusedScalarStepper.multi_step_fn runs the stage-paired chunk body:
    bit-equal to multi_step, and within 1e-12 of the JAX package's
    multi_step_fn (nsteps=3 ends on the odd single stage)."""
    st = pt.FusedScalarStepper(
        pt.ScalarSector(2, potential=fused_test_potential), GRID, DX, H,
        dtype=torch.float64, device="cpu")
    state = pt.state_from_numpy(_fused_state(), device="cpu")
    got = {k: v.clone() for k, v in st.multi_step_fn(nsteps)(
        {k: v.clone() for k, v in state.items()}, 0.0, DT, ARGS).items()}
    ref = st.multi_step({k: v.clone() for k, v in state.items()}, nsteps,
                        0.0, DT, ARGS)
    for k in ("f", "dfdt"):
        assert torch.equal(got[k], ref[k])
        assert _rel(got[k], jax_fused_fn[nsteps][k]) < 1e-12


# -- symbolic stencils and top-level names ------------------------------------

@pytest.mark.parametrize("direction", [1, 2, 3])
@pytest.mark.parametrize("order", [1, 2])
def test_centered_diff_matches_jax(direction, order):
    """centered_diff (through expand_stencil) evaluates, on the same
    array, to the JAX package's: the same periodic rolls and sums, to
    1e-15; and, for the first derivative at dx = 1, to FiniteDifferencer's
    pd along that axis."""
    coefs = (pt.FirstCenteredDifference(2) if order == 1
             else pt.SecondCenteredDifference(2)).coefs
    arr = np.random.default_rng(direction).standard_normal((12, 10, 8))
    ref = ps.evaluate(ps.centered_diff(ps.Field("f"), coefs, direction,
                                       order), {"f": jnp.asarray(arr)})
    expr = pt.centered_diff(pt.Field("f"), coefs, direction, order)
    got = pt.evaluate(expr, {"f": torch.tensor(arr)})
    assert _rel(got, ref) < 1e-15
    if order == 1:
        fd = pt.FiniteDifferencer(2, 1.0, device="cpu")
        pd = getattr(fd, "pd" + "xyz"[direction - 1])(torch.tensor(arr))
        assert _rel(got, pd) < 1e-14


def test_expand_stencil_matches_jax():
    """expand_stencil over an indexed field with arbitrary offsets."""
    f = np.random.default_rng(5).standard_normal((2, 6, 5, 4))
    coefs = {(1, 0, 0): 0.5, (0, -2, 1): -1.25, (0, 0, 0): 2.0}
    ref = ps.evaluate(ps.expand_stencil(ps.Field("f", shape=(2,))[1],
                                        coefs), {"f": jnp.asarray(f)})
    got = pt.evaluate(pt.expand_stencil(pt.Field("f", shape=(2,))[1],
                                        coefs), {"f": torch.tensor(f)})
    assert _rel(got, ref) < 1e-15


FUNCS = ("exp", "log", "sin", "cos", "tan", "sinh", "cosh", "tanh", "sqrt",
         "fabs", "sign")


def test_top_level_math_and_coordinates():
    """The math functions and t, x, y, z are exported as the JAX package
    exports them; each function builds a symbolic call that evaluates as
    the JAX package's does, and the coordinates are Vars that diff
    knows."""
    arr = np.random.default_rng(2).uniform(0.2, 1.4, (4, 3, 5))
    for name in FUNCS:
        assert name in pt.__all__
        ref = ps.evaluate(getattr(ps, name)(ps.Field("f")),
                          {"f": jnp.asarray(arr)})
        got = pt.evaluate(getattr(pt, name)(pt.Field("f")),
                          {"f": torch.tensor(arr)})
        assert _rel(got, ref) < 1e-15, name
    for c in ("t", "x", "y", "z"):
        assert c in pt.__all__
        assert isinstance(getattr(pt, c), pt.Var)
        assert getattr(pt, c).name == getattr(ps, c).name == c
    assert pt.diff(pt.exp(2 * pt.t), pt.t) is not None
    assert float(pt.evaluate(pt.diff(pt.x ** 3, pt.x), {"x": 2.0})) == 12.0


# -- FiniteDifferencer's device -----------------------------------------------

def test_fd_device_defaults_to_the_card():
    """FiniteDifferencer resolves its device as every entry point does:
    the card unless the caller asks for the CPU; here, without one, the
    default raises RuntimeError (on a GPU machine it resolves to it)."""
    if torch.cuda.is_available():
        assert pt.FiniteDifferencer(2, 0.1).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            pt.FiniteDifferencer(2, 0.1)
    assert pt.FiniteDifferencer(2, 0.1, device="cpu").device.type == "cpu"


@pytest.mark.parametrize("mode", ["kernel", "roll"])
def test_fd_operand_on_another_device_raises(mode):
    """An operand on another device than the FiniteDifferencer's raises
    ValueError, in either mode and for every operator, before any
    computation."""
    fd = pt.FiniteDifferencer(2, 0.1, mode=mode, device="cpu")
    x = torch.zeros((2, 8, 6, 4), dtype=torch.float64, device="meta")
    for op in ("lap", "grad", "grad_lap", "pdx", "pdy", "pdz"):
        with pytest.raises(ValueError, match="runs on cpu"):
            getattr(fd, op)(x)
    with pytest.raises(ValueError, match="runs on cpu"):
        fd.divergence(torch.zeros((3, 8, 6, 4), device="meta"))
    with pytest.raises(ValueError, match="runs on cpu"):
        fd(x, lap=True)
