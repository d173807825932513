"""The port's multigrid subsystem against the JAX package's, on shared
numpy inputs made from a seed: the transfer operators, the sweep, residual
and coarse right-hand-side passes (the JAX side through its Pallas tier in
interpret mode and through its XLA tier), one FAS cycle, and the
convergence checks of tests/test_multigrid.py on the port alone.

On the CPU the port's sweep wrapper runs the kernels' plain version; the
CUDA kernels themselves are held against it on the card
(tests/test_torch_kernels.py, chip_smoke.py).
"""

import jax
import numpy as np
import pytest
import torch

import pystella_tpu as ps
import pystella_tpu_torch as pt
from pystella_tpu import multigrid as jmg
from pystella_tpu.multigrid.relax import LevelSpec as JLevelSpec
from pystella_tpu_torch import multigrid as tmg
from pystella_tpu_torch.multigrid.relax import LevelSpec
from pystella_tpu_torch.ops import codegen

GRID = (16, 16, 16)
DX = 10.0 / GRID[0]

#: sweeps, residuals and coarse right-hand sides, port vs JAX, relative to
#: the output's largest value: the two run the same sums in the same order
#: (XLA may contract a multiply-add or divide by a reciprocal: an ulp each)
SWEEP_TOL = {np.float64: 1e-13, np.float32: 1e-6}
#: in float32 that is ~8 ulp over three sweeps of ~15 roundings each
#: (measured: 1.1e-7 to 1.6e-7; in float64 2e-16 to 4e-16)


def linear_problems(mod):
    """The reference's two test problems: Poisson ``lap f = rho`` and
    Helmholtz ``lap f2 - f2 = rho2`` (tests/test_multigrid.py:15)."""
    return {
        mod.Field("f"): (mod.Field("lap_f"), mod.Field("rho")),
        mod.Field("f2"): (mod.Field("lap_f2") - mod.Field("f2"),
                          mod.Field("rho2")),
    }


def nonlinear_problem(mod):
    """``lap f - f + f**3 = rho`` (tests/test_multigrid.py:106)."""
    f = mod.Field("f")
    return {f: (mod.Field("lap_f") - f + f**3, mod.Field("rho"))}


PROBLEMS = {
    "jacobi-linear": ("JacobiIterator", linear_problems, 1 / 2),
    "newton-nonlinear": ("NewtonIterator", nonlinear_problem, 2 / 3),
}


def zero_mean(rng, shape, n, dtype=np.float64):
    out = []
    for _ in range(n):
        a = rng.random(shape)
        out.append((a - a.mean()).astype(dtype))
    return out


def problem_arrays(key, dtype, seed=77):
    """Unknowns and sources of a problem, and a second set standing in for
    restricted residuals, as dicts of numpy arrays."""
    names = (("f", "rho"), ("f2", "rho2")) if key == "jacobi-linear" \
        else (("f", "rho"),)
    rng = np.random.default_rng(seed)
    arrs = zero_mean(rng, GRID, 3 * len(names), dtype)
    fs = {f: arrs[3 * i] for i, (f, _) in enumerate(names)}
    rhos = {r: arrs[3 * i + 1] for i, (_, r) in enumerate(names)}
    rr = {f: arrs[3 * i + 2] for i, (f, _) in enumerate(names)}
    return fs, rhos, rr


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Arrays of 32^3 and less: torch's intra-op threads only contend with
    the other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def decomp():
    return ps.DomainDecomposition((1, 1, 1), devices=jax.devices()[:1])


def rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.max(np.abs(got - ref)) / np.max(np.abs(ref))


# -- transfer operators -------------------------------------------------------

TRANSFERS = {
    "FullWeighting": ({}, GRID),
    "Injection": ({}, GRID),
    "LinearInterpolation": ({}, tuple(n // 2 for n in GRID)),
    "CubicInterpolation": ({"halo_shape": 2}, tuple(n // 2 for n in GRID)),
}


@pytest.mark.parametrize("name", list(TRANSFERS))
def test_transfer_matches_jax(name):
    kwargs, shape = TRANSFERS[name]
    x = np.random.default_rng(3).random((2,) + shape)
    ref = np.asarray(getattr(jmg, name)(**kwargs)(jax.numpy.asarray(x)))
    got = getattr(tmg, name)(**kwargs)(torch.tensor(x)).numpy()
    assert got.shape == ref.shape
    assert np.max(np.abs(got - ref)) <= 1e-14


@pytest.mark.parametrize("name", ["FullWeighting", "LinearInterpolation"])
def test_transfer_correct_matches_jax(name):
    """``correct=True``: ``f2 - R(f1)`` and ``f1 + I(f2)``."""
    rng = np.random.default_rng(4)
    fine, coarse = rng.random(GRID), rng.random(tuple(n // 2 for n in GRID))
    a, b = (fine, coarse) if name == "FullWeighting" else (coarse, fine)
    ref = np.asarray(getattr(jmg, name)(correct=True)(
        jax.numpy.asarray(a), jax.numpy.asarray(b)))
    got = getattr(tmg, name)(correct=True)(torch.tensor(a),
                                           torch.tensor(b)).numpy()
    assert np.max(np.abs(got - ref)) <= 1e-14
    with pytest.raises(ValueError):
        getattr(tmg, name)(correct=True)(torch.tensor(a))


def test_transfer_identities():
    """Restriction and interpolation preserve constants; injection picks
    even-index points; interpolation reproduces the coarse field at
    coinciding points; full weighting is the 27-point average
    (tests/test_multigrid.py:128-164)."""
    rng = np.random.default_rng(3)
    const = torch.full(GRID, 2.5, dtype=torch.float64)
    for op in (tmg.FullWeighting(), tmg.Injection()):
        out = op(const).numpy()
        assert out.shape == tuple(n // 2 for n in GRID)
        assert np.allclose(out, 2.5, atol=1e-13)

    for op in (tmg.LinearInterpolation(),
               tmg.CubicInterpolation(halo_shape=2)):
        coarse_np = rng.random(tuple(n // 2 for n in GRID))
        fine = op(torch.tensor(coarse_np)).numpy()
        assert fine.shape == GRID
        assert np.allclose(fine[::2, ::2, ::2], coarse_np, atol=1e-13)

    fine_np = rng.random(GRID)
    picked = tmg.Injection()(torch.tensor(fine_np)).numpy()
    assert np.array_equal(picked, fine_np[::2, ::2, ::2])

    fw = tmg.FullWeighting()(torch.tensor(fine_np)).numpy()
    expect = np.zeros_like(fw)
    w1 = {-1: 0.25, 0: 0.5, 1: 0.25}
    for a, ca in w1.items():
        for b, cb in w1.items():
            for c, cc in w1.items():
                expect += (ca * cb * cc
                           * np.roll(fine_np, (-a, -b, -c),
                                     (0, 1, 2))[::2, ::2, ::2])
    assert np.allclose(fw, expect, atol=1e-13)


def test_periodic_pad_matches_jax():
    x = np.random.default_rng(5).random((2, 6, 4, 8))
    ref = np.asarray(jmg.periodic_pad(jax.numpy.asarray(x), (1, 0, 2)))
    got = tmg.periodic_pad(torch.tensor(x), (1, 0, 2)).numpy()
    np.testing.assert_array_equal(got, ref)


# -- sweeps, residuals and coarse right-hand sides ----------------------------

def _jax_sweeps(decomp, h):
    """smooth(3), residual and tau_rhs of both problems at stencil radius
    ``h`` through both JAX tiers, in f64 and (the XLA tier) f32."""
    level = JLevelSpec(GRID, (DX,) * 3, False)
    out = {}
    for key, (cls, problems, omega) in PROBLEMS.items():
        for smoother, dtype in (("pallas", np.float64), ("xla", np.float64),
                                ("xla", np.float32)):
            fs, rhos, rr = problem_arrays(key, dtype)
            solver = getattr(jmg, cls)(
                decomp, problems(ps), halo_shape=h, dtype=dtype,
                smoother=smoother, fixed_parameters=dict(omega=omega))
            res = {
                "smooth": solver.smooth(level, fs, rhos, {}, 3, decomp),
                "residual": solver.residual(level, fs, rhos, {}, decomp),
                "tau": solver.tau_rhs(level, fs, rr, {}, decomp),
            }
            out[key, smoother, dtype] = {
                k: {n: np.asarray(v) for n, v in d.items()}
                for k, d in res.items()}
    return out


@pytest.fixture(scope="module")
def jax_sweeps(decomp):
    """:func:`_jax_sweeps` at h = 1, computed once."""
    return _jax_sweeps(decomp, 1)


@pytest.fixture(scope="module")
def jax_sweeps_h2(decomp):
    """:func:`_jax_sweeps` at h = 2, computed once."""
    return _jax_sweeps(decomp, 2)


def port_sweeps(key, dtype, smoother=None, h=1):
    cls, problems, omega = PROBLEMS[key]
    fs, rhos, rr = problem_arrays(key, dtype)
    solver = getattr(tmg, cls)(
        problems(pt), halo_shape=h, dtype=dtype, smoother=smoother,
        fixed_parameters=dict(omega=omega), device="cpu")
    level = LevelSpec(GRID, (DX,) * 3, False)
    return {"smooth": solver.smooth(level, fs, rhos, {}, 3),
            "residual": solver.residual(level, fs, rhos, {}),
            "tau": solver.tau_rhs(level, fs, rr, {})}


def _check_sweeps(sweeps, key, tier, kind, h):
    smoother, dtype = tier.split("-")
    dtype = {"f64": np.float64, "f32": np.float32}[dtype]
    ref = sweeps[key, smoother, dtype][kind]
    got = port_sweeps(key, dtype, h=h)[kind]
    assert set(got) == set(ref)
    for n in ref:
        assert got[n].dtype == pt.convert.torch_dtype(dtype)
        err = rel(got[n].numpy(), ref[n])
        assert err <= SWEEP_TOL[dtype], (n, kind)


@pytest.mark.parametrize("kind", ["smooth", "residual", "tau"])
@pytest.mark.parametrize("tier", ["pallas-f64", "xla-f64", "xla-f32"])
@pytest.mark.parametrize("key", list(PROBLEMS))
def test_sweeps_match_jax(jax_sweeps, key, tier, kind):
    _check_sweeps(jax_sweeps, key, tier, kind, 1)


@pytest.mark.parametrize("kind", ["smooth", "residual", "tau"])
@pytest.mark.parametrize("tier", ["pallas-f64", "xla-f64", "xla-f32"])
@pytest.mark.parametrize("key", list(PROBLEMS))
def test_sweeps_match_jax_h2(jax_sweeps_h2, key, tier, kind):
    """:func:`test_sweeps_match_jax` at stencil radius 2: the order-4
    Laplacian the sweeps' march taps from two planes on either side."""
    _check_sweeps(jax_sweeps_h2, key, tier, kind, 2)


@pytest.mark.parametrize("key", list(PROBLEMS))
def test_kernel_tier_on_cpu_is_plain(key):
    """``smoother="kernel"`` on CPU tensors runs the kernels' plain
    version (the wrapper decides by the tensor's device): the same bits
    as ``smoother="plain"``; an unknown tier is refused."""
    a = port_sweeps(key, np.float64, "kernel")
    b = port_sweeps(key, np.float64, "plain")
    for kind in a:
        for n in a[kind]:
            assert torch.equal(a[kind][n], b[kind][n])
    with pytest.raises(ValueError):
        tmg.JacobiIterator(linear_problems(pt), smoother="pallas",
                           device="cpu")


def test_smooth_is_functional_and_counts_nothing_on_cpu():
    """The inputs are not written, zero sweeps return them, and no launch
    is counted for a CPU run."""
    from pystella_tpu_torch.multigrid import relax
    fs, rhos, _ = problem_arrays("jacobi-linear", np.float64)
    solver = tmg.JacobiIterator(linear_problems(pt), omega=1 / 2,
                                smoother="kernel", device="cpu")
    level = LevelSpec(GRID, (DX,) * 3)
    tfs = {n: torch.tensor(v) for n, v in fs.items()}
    relax.reset_launch_counts()
    out = solver.smooth(level, tfs, rhos, {}, 2)
    same = solver.smooth(level, tfs, rhos, {}, 0)
    for n in fs:
        np.testing.assert_array_equal(tfs[n].numpy(), fs[n])
        np.testing.assert_array_equal(same[n].numpy(), fs[n])
        assert not torch.equal(out[n], tfs[n])
    assert set(relax.LAUNCHES.values()) == {0}


def test_aux_arrays_and_scalars():
    """A lattice-valued and a scalar auxiliary input: ``lap f - m2 f + c g
    = rho`` against the same equation with the values folded in."""
    rng = np.random.default_rng(9)
    f, rho, g = zero_mean(rng, GRID, 3)
    fld = pt.Field
    lhs = fld("lap_f") - pt.Var("m2") * fld("f") + fld("c") * fld("g")
    solver = tmg.NewtonIterator({fld("f"): (lhs, fld("rho"))}, omega=2 / 3,
                                device="cpu")
    assert solver._aux_struct({"g": g, "m2": 0.5, "c": np.float64(2.0)}) \
        == (("c", "scalar"), ("g", "lattice"), ("m2", "scalar"))
    # what a solver with such inputs cannot build before its first call
    assert solver.aux_names == ["c", "g", "m2"]
    assert tmg.JacobiIterator(linear_problems(pt), device="cpu").aux_names \
        == []
    folded = tmg.NewtonIterator(
        {fld("f"): (fld("lap_f") - 0.5 * fld("f") + fld("g2"), fld("rho"))},
        omega=2 / 3, device="cpu")
    level = LevelSpec(GRID, (DX,) * 3)
    got = solver.smooth(level, {"f": f}, {"rho": rho},
                        {"g": g, "m2": 0.5, "c": 2.0}, 2)["f"]
    ref = folded.smooth(level, {"f": f}, {"rho": rho}, {"g2": 2.0 * g},
                        2)["f"]
    assert rel(got.numpy(), ref.numpy()) <= 1e-14
    with pytest.raises(ValueError):
        solver.smooth(level, {"f": f}, {"rho": rho},
                      {"g": g[:8], "m2": 0.5, "c": 2.0}, 1)


# -- the generated header -----------------------------------------------------

def test_relax_header_prints_the_updates():
    solver = tmg.NewtonIterator(nonlinear_problem(pt), omega=2 / 3,
                                device="cpu")
    header = solver.kernel_header()
    assert "#define PK_H 1" in header and "#define MG_NF 1" in header
    # the Newton diagonal as evaluate computes it: -1 + 3 f*f + lap_diag,
    # f**3 as repeated multiplication, omega and lap_diag cast to T
    assert "((T(-1) + (T(3) * (s.f[0] * s.f[0]))) + T(s.lap_diag))" in header
    assert "((s.f[0] * s.f[0]) * s.f[0])" in header
    assert "T(s.omega)" in header and "pow" not in header
    jac = tmg.JacobiIterator(linear_problems(pt), halo_shape=2,
                             omega=1 / 2, device="cpu")
    header = jac.kernel_header((("g", "lattice"), ("m2", "scalar")))
    assert "#define PK_H 2" in header and "#define MG_NF 2" in header
    assert "#define MG_NLAT 1" in header and "#define MG_NSCAL 1" in header
    # (1 - omega) folds in double, as Python folds it, before it meets f
    assert "(T((1.0 + (-1.0 * s.omega))) * s.f[0])" in header
    assert "T((-1.0 * s.lap_diag))" in header
    # the coarse operator sees no rho
    lhs = header[header.index("void mg_lhs"):]
    assert "s.rho" not in lhs and "s.lap[1]" in lhs


def test_double_scalars_fold_like_python():
    D = codegen.DoubleExpr
    om, x = pt.Var("omega"), pt.Field("x")
    syms = {"omega": D("w"), "x": "x"}
    assert codegen.print_c(2 * om, None, syms) == "T((2.0 * w))"
    assert codegen.print_c(om**2 * x, None, syms) == "(T((w * w)) * x)"
    assert codegen.print_c(pt.field.exp(om) + x, None, syms) \
        == "(T(pk_exp(w)) + x)"
    assert codegen.print_c(x**om, None, syms) == "pk_pow(x, T(w))"
    with pytest.raises(ValueError):
        codegen.print_c(pt.Field("y"), None, syms)
    with pytest.raises(ValueError):
        codegen.print_c(pt.Field("x", (2,)), None, syms)


# -- cycles -------------------------------------------------------------------

@pytest.mark.parametrize("name,args", [
    ("v_cycle", (25, 50, 3)), ("w_cycle", (10, 20, 2)),
    ("f_cycle", (10, 20, 3)), ("mu_cycle", (3, 0, 2, 4, 2))])
def test_cycles_equal_jax(name, args):
    assert getattr(tmg, name)(*args) == getattr(jmg, name)(*args)


@pytest.fixture(scope="module")
def jax_fas_cycle(decomp):
    """One FAS ``v_cycle(5, 10, 1)`` of each problem in the JAX package."""
    out = {}
    for key, (cls, problems, omega) in PROBLEMS.items():
        fs, rhos, _ = problem_arrays(key, np.float64, seed=5)
        solver = getattr(jmg, cls)(decomp, problems(ps), halo_shape=1,
                                   dtype=np.float64, omega=omega)
        errs, sol = jmg.FullApproximationScheme(solver=solver, halo_shape=1)(
            decomp, dx0=DX, cycle=jmg.v_cycle(5, 10, 1), **fs, **rhos)
        out[key] = (errs, {n: np.asarray(v) for n, v in sol.items()})
    return out


@pytest.mark.parametrize("defer", [False, True], ids=["eager", "deferred"])
@pytest.mark.parametrize("key", list(PROBLEMS))
def test_fas_cycle_matches_jax(jax_fas_cycle, key, defer):
    """Solution <= 1e-12 and every recorded ``(level, {name: [Linf, L2]})``
    entry <= 1e-10 relative; deferred norms give the same record."""
    cls, problems, omega = PROBLEMS[key]
    fs, rhos, _ = problem_arrays(key, np.float64, seed=5)
    solver = getattr(tmg, cls)(problems(pt), halo_shape=1,
                               dtype=np.float64, omega=omega, device="cpu")
    mg = tmg.FullApproximationScheme(solver=solver, halo_shape=1,
                                     defer_errors=defer)
    errs, sol = mg(dx0=DX, cycle=tmg.v_cycle(5, 10, 1),
                   **pt.state_from_numpy(fs, device="cpu"), **rhos)
    ref_errs, ref_sol = jax_fas_cycle[key]
    for n in ref_sol:
        assert rel(pt.to_numpy(sol)[n], ref_sol[n]) <= 1e-12
    assert [lvl for lvl, _ in errs] == [lvl for lvl, _ in ref_errs]
    for (_, got), (_, ref) in zip(errs, ref_errs):
        assert set(got) == set(ref)
        for n in ref:
            for g, r in zip(got[n], ref[n]):
                assert isinstance(g, float)
                assert abs(g - r) <= 1e-10 * abs(r)


@pytest.fixture(scope="module")
def jax_linear_cycle(decomp):
    """One linear ``MultiGridSolver`` ``v_cycle(5, 10, 2)`` of the Poisson
    + Helmholtz pair in the JAX package (its correction scheme: the
    restricted residual as the coarse source, a zero coarse guess)."""
    cls, problems, omega = PROBLEMS["jacobi-linear"]
    fs, rhos, _ = problem_arrays("jacobi-linear", np.float64, seed=6)
    solver = getattr(jmg, cls)(decomp, problems(ps), halo_shape=1,
                               dtype=np.float64, omega=omega)
    errs, sol = jmg.MultiGridSolver(solver=solver, halo_shape=1)(
        decomp, dx0=DX, cycle=jmg.v_cycle(5, 10, 2), **fs, **rhos)
    return errs, {n: np.asarray(v) for n, v in sol.items()}


def test_multigrid_solver_matches_jax(jax_linear_cycle):
    """The linear ``MultiGridSolver`` on one device against the JAX
    package's, f64: the solution within 1e-12 of its largest value and
    every recorded ``(level, {name: [Linf, L2]})`` within 1e-12 relative
    (the same sums; XLA orders the Laplacian axis by axis)."""
    cls, problems, omega = PROBLEMS["jacobi-linear"]
    fs, rhos, _ = problem_arrays("jacobi-linear", np.float64, seed=6)
    solver = getattr(tmg, cls)(problems(pt), halo_shape=1,
                               dtype=np.float64, omega=omega, device="cpu")
    errs, sol = tmg.MultiGridSolver(solver=solver, halo_shape=1)(
        dx0=DX, cycle=tmg.v_cycle(5, 10, 2), **fs, **rhos)
    ref_errs, ref_sol = jax_linear_cycle
    for n in ref_sol:
        assert rel(sol[n].numpy(), ref_sol[n]) <= 1e-12
    assert [lvl for lvl, _ in errs] == [lvl for lvl, _ in ref_errs]
    for (_, got), (_, ref) in zip(errs, ref_errs):
        for n in ref:
            for g, r in zip(got[n], ref[n]):
                assert abs(g - r) <= 1e-12 * abs(r)


@pytest.mark.parametrize("Solver", ["NewtonIterator", "JacobiIterator"])
@pytest.mark.parametrize("MG", ["FullApproximationScheme",
                                "MultiGridSolver"])
def test_multigrid_converges(Solver, MG):
    """tests/test_multigrid.py:33-72 on the port: Poisson and Helmholtz to
    machine precision in 10 default V-cycles at 32^3."""
    grid = (32, 32, 32)
    dx = 10.0 / grid[0]
    solver = getattr(tmg, Solver)(linear_problems(pt), halo_shape=1,
                                  dtype=np.float64, device="cpu",
                                  fixed_parameters=dict(omega=1 / 2))
    mg = getattr(tmg, MG)(solver=solver, halo_shape=1)
    f, rho, f2, rho2 = zero_mean(np.random.default_rng(5521), grid, 4)
    history = []
    for _ in range(10):
        errs, sol = mg(dx0=dx, f=f, rho=rho, f2=f2, rho2=rho2)
        f, f2 = sol["f"], sol["f2"]
        history.append(errs[-1][-1])
    tol = 5e-14
    for name in ("f", "f2"):
        assert history[-1][name][1] < tol
        assert history[-2][name][1] < 10 * tol


@pytest.mark.parametrize("cycle", [tmg.v_cycle(25, 50, 3),
                                   tmg.w_cycle(10, 20, 2)],
                         ids=["deep-v", "w"])
def test_multigrid_deep_cycles(cycle):
    """Deep cycles reach levels of 2^3 and 4^3 sites
    (tests/test_multigrid.py:75-101)."""
    solver = tmg.NewtonIterator(linear_problems(pt), halo_shape=1,
                                omega=1 / 2, device="cpu")
    mg = tmg.FullApproximationScheme(solver=solver, halo_shape=1)
    f, rho, f2, rho2 = zero_mean(np.random.default_rng(77), GRID, 4)
    for _ in range(10):
        errs, sol = mg(dx0=DX, cycle=cycle, f=f, rho=rho, f2=f2, rho2=rho2)
        f, f2 = sol["f"], sol["f2"]
    assert errs[-1][-1]["f"][1] < 5e-14
    assert errs[-1][-1]["f2"][1] < 5e-14


def test_fas_nonlinear_converges():
    """tests/test_multigrid.py:104-125 on the port."""
    grid = (32, 32, 32)
    solver = tmg.NewtonIterator(nonlinear_problem(pt), halo_shape=1,
                                omega=2 / 3, device="cpu")
    mg = tmg.FullApproximationScheme(solver=solver, halo_shape=1)
    f, rho = zero_mean(np.random.default_rng(11), grid, 2)
    for _ in range(12):
        errs, sol = mg(dx0=10.0 / grid[0], f=f, rho=rho)
        f = sol["f"]
    assert errs[-1][-1]["f"][1] < 1e-13, errs[-1][-1]["f"]


def test_standalone_relaxation():
    """tests/test_multigrid.py:167-185 on the port."""
    solver = tmg.JacobiIterator(
        {pt.Field("f"): (pt.Field("lap_f"), pt.Field("rho"))},
        halo_shape=1, omega=1 / 2, device="cpu")
    f, rho = zero_mean(np.random.default_rng(8), GRID, 2)
    level = LevelSpec(GRID, (DX,) * 3, False)
    e0 = solver.get_error(level, {"f": f}, {"rho": rho}, {})["f"][1]
    out = solver(iterations=200, dx=DX, f=f, rho=rho)
    e1 = solver.get_error(level, out, {"rho": rho}, {})["f"][1]
    assert e1 < e0 / 3, (e0, e1)
    with pytest.raises(ValueError):
        solver(iterations=1, f=f, rho=rho)


def test_entry_point_contracts():
    """Unknown keywords raise; a cycle that skips a level is refused; an
    odd lattice cannot be coarsened; without a CUDA device the default
    device raises instead of running on the CPU."""
    solver = tmg.JacobiIterator(linear_problems(pt), omega=1 / 2,
                                device="cpu")
    with pytest.raises(TypeError, match="defer_error"):
        tmg.FullApproximationScheme(solver=solver, defer_error=True)
    mg = tmg.FullApproximationScheme(solver=solver)
    f, rho, f2, rho2 = zero_mean(np.random.default_rng(1), (8, 8, 8), 4)
    arrays = dict(f=f, rho=rho, f2=f2, rho2=rho2)
    with pytest.raises(ValueError, match="dx0"):
        mg(**arrays)
    with pytest.raises(ValueError, match="spaced by one"):
        mg(dx0=1.0, cycle=[(0, 1), (2, 1)], **arrays)
    odd = {k: v[:6, :6, :6] for k, v in arrays.items()}
    with pytest.raises(ValueError, match="not divisible"):
        mg(dx0=1.0, cycle=tmg.v_cycle(1, 1, 2), **odd)
    with pytest.raises(TypeError):
        tmg.JacobiIterator({pt.Field("f"): (pt.Field("lap_f"), 1.0)},
                           device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tmg.JacobiIterator(linear_problems(pt))


def test_exports_and_numpy_crossing():
    """The JAX names exist in the port; 3-D arrays without a component
    axis and the error record cross through convert.py."""
    for name in jmg.__all__:
        assert hasattr(tmg, name), name
    assert pt.FullApproximationScheme is tmg.FullApproximationScheme
    a = np.random.default_rng(2).random((4, 6, 8)).astype(np.float32)
    t = pt.state_from_numpy({"rho": a}, device="cpu")["rho"]
    assert t.shape == (4, 6, 8) and t.dtype == torch.float32
    back = pt.to_numpy([(0, {"f": [1.5, t]})])
    np.testing.assert_array_equal(back[0][1]["f"][1], a)
