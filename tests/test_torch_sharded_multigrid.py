"""The port's multigrid solvers on sharded lattices
(``NewtonIterator``/``JacobiIterator(decomp=...)``, every shard a CPU
tensor here, the sweep kernels' plain versions) against the JAX package's
sharded solvers on its virtual CPU devices, against the port's own
single-device solvers, and overlapped against padded.

The JAX side runs its default CPU tier (``smoother="auto"``: the XLA
halo-pad bodies) and, on one mesh, its Pallas tier in interpret mode. Its
sharded cycles cost seconds each here, so each mesh's results are
computed once, in a module fixture, with one solver per mesh (its
compiled sweeps shared by the level passes, both cycles and the
standalone relaxation)."""

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

GRID = (16, 16, 16)
DX = 10.0 / GRID[0]
#: the JAX comparisons' meshes ((2, 2, 2): the port's plain tier, as the
#: JAX package runs XLA there)
MESHES = [(2, 1, 1), (2, 2, 1), (1, 2, 1), (2, 2, 2)]
MESH_IDS = ["211", "221", "121", "222"]
#: depth 3 at 16^3: the 2^3 level's blocks are 1 wide on every mesh, so
#: it is replicated (tests/test_multigrid.py:83's shape)
CYCLE = [(0, 3), (1, 3), (2, 3), (3, 5), (2, 5), (1, 5), (0, 5)]
#: port vs JAX, f64, relative to the largest value (a recorded norm: to
#: itself): the same sums, but XLA orders the Laplacian axis by axis and
#: may contract or reassociate (measured: 3e-16 for the passes and the
#: transfers, 1e-15 for a cycle's solution, 2e-14 for its smallest
#: recorded norms)
TOL = 1e-12
#: f32: a few ulp over three sweeps (measured: 1.8e-7)
TOL_F32 = 1e-5
#: the L2 error norms: per-block sums added in rank order against one sum
#: over the whole lattice (measured: 2.8e-16)
L2_TOL = 1e-13


def linear_problems(mod):
    """Poisson ``lap f = rho`` and Helmholtz ``lap f2 - f2 = rho2``
    (tests/test_multigrid.py:15)."""
    return {
        mod.Field("f"): (mod.Field("lap_f"), mod.Field("rho")),
        mod.Field("f2"): (mod.Field("lap_f2") - mod.Field("f2"),
                          mod.Field("rho2")),
    }


def nonlinear_problem(mod):
    """``lap f - f + f**3 = rho`` (the bench problem, bench.py:765)."""
    f = mod.Field("f")
    return {f: (mod.Field("lap_f") - f + f**3, mod.Field("rho"))}


def arrays(names=("f", "rho", "f2", "rho2"), dtype=np.float64, seed=21):
    """Zero-mean uniform arrays, and a second set standing in for the
    restricted residuals of tau."""
    rng = np.random.default_rng(seed)
    out = {}
    for n in list(names) + ["rr_" + n for n in names]:
        a = rng.random(GRID)
        out[n] = (a - a.mean()).astype(dtype)
    return out


def rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.max(np.abs(got - ref)) / np.max(np.abs(ref))


def port_decomp(mesh):
    return pt.DomainDecomposition(mesh, devices=["cpu"] * int(np.prod(mesh)))


def jax_decomp(mesh):
    return ps.DomainDecomposition(
        mesh, devices=jax.devices()[:int(np.prod(mesh))])


def port_solver(decomp=None, problem="linear", dtype=np.float64, **kw):
    cls, probs, omega = ((tmg.JacobiIterator, linear_problems, 1 / 2)
                         if problem == "linear" else
                         (tmg.NewtonIterator, nonlinear_problem, 2 / 3))
    kw.setdefault("smoother", "kernel")
    return cls(probs(pt), halo_shape=1, omega=omega, dtype=dtype,
               device="cpu", decomp=decomp, **kw)


def level0(mod, sharded):
    return (LevelSpec if mod is tmg else JLevelSpec)(
        GRID, (DX,) * 3, sharded)


LEVEL_KINDS = ("smooth", "residual", "tau")


def level_ops(solver, level, a, decomp=None):
    """smooth(3), residual and tau_rhs of the linear pair on ``level``,
    the inputs sharded over ``decomp`` (a JAX decomposition is also passed
    to each call, as the JAX signatures take it)."""
    extra = (decomp,) if isinstance(decomp, ps.DomainDecomposition) else ()
    fs = {n: a[n] for n in ("f", "f2")}
    rhos = {n: a[n] for n in ("rho", "rho2")}
    rr = {n: a["rr_" + n] for n in ("f", "f2")}
    if decomp is not None:
        fs, rhos, rr = ({k: decomp.shard(v) for k, v in d.items()}
                        for d in (fs, rhos, rr))
    return {"smooth": solver.smooth(level, fs, rhos, {}, 3, *extra),
            "residual": solver.residual(level, fs, rhos, {}, *extra),
            "tau": solver.tau_rhs(level, fs, rr, {}, *extra)}


def on_host(passes):
    """Every array of :func:`level_ops`'s result as numpy."""
    return {k: {n: host(v) for n, v in d.items()} for k, d in passes.items()}


def host(x):
    if isinstance(x, pt.ShardedArray):
        return x.decomp.gather_array(x)
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def jax_ref():
    """Per mesh, one JAX sharded JacobiIterator (XLA tier, f64): the level
    passes, the FAS and the linear V-cycle, the standalone relaxation and
    the four transfers; the (2, 2, 1) passes through the Pallas tier in
    interpret mode and the (2, 1, 1) passes in f32."""
    a = arrays()
    out = {}
    for mesh in MESHES:
        d = jax_decomp(mesh)
        solver = jmg.JacobiIterator(d, linear_problems(ps), halo_shape=1,
                                    omega=1 / 2, dtype=np.float64)
        res = {"level": on_host(level_ops(solver, level0(jmg, True), a,
                                          d))}
        for MG in ("FullApproximationScheme", "MultiGridSolver"):
            errs, sol = getattr(jmg, MG)(solver=solver, halo_shape=1)(
                d, dx0=DX, cycle=CYCLE,
                **{n: d.shard(a[n]) for n in ("f", "rho", "f2", "rho2")})
            res[MG] = (errs, {n: host(v) for n, v in sol.items()})
        res["standalone"] = {n: host(v) for n, v in solver(
            d, iterations=3, dx=DX, **{n: d.shard(a[n]) for n in (
                "f", "rho", "f2", "rho2")}).items()}
        res["transfers"] = {name: host(getattr(jmg, name)(**kw)(
            d.shard(transfer_input(name)), decomp=d))
            for name, kw in TRANSFERS.items()}
        out[mesh] = res
    d = jax_decomp((2, 2, 1))
    pallas = jmg.JacobiIterator(d, linear_problems(ps), halo_shape=1,
                                omega=1 / 2, dtype=np.float64,
                                smoother="pallas")
    out["pallas"] = on_host(level_ops(pallas, level0(jmg, True), a, d))
    d = jax_decomp((2, 1, 1))
    f32 = jmg.JacobiIterator(d, linear_problems(ps), halo_shape=1,
                             omega=1 / 2, dtype=np.float32)
    out["f32"] = on_host(level_ops(f32, level0(jmg, True),
                                   arrays(dtype=np.float32), d))
    return out


# -- level placement ----------------------------------------------------------

@pytest.mark.parametrize("grid,depth", [((16, 16, 16), 3), ((32, 16, 8), 3),
                                        ((32, 32, 32), 4)])
@pytest.mark.parametrize("mesh", MESHES + [(4, 1, 1), (1, 1, 1)],
                         ids=MESH_IDS + ["411", "111"])
def test_level_placement_matches_jax(mesh, grid, depth):
    """``_make_levels``: the JAX package's placement (sharded fine levels,
    replicated from the first level whose blocks are odd or thinner than
    every halo pad on), spacing included."""
    dx = (0.3, 0.25, 0.2)
    kw = dict(halo_shape=1)
    jax_mg = jmg.FullApproximationScheme(
        solver=jmg.JacobiIterator(jax_decomp(mesh), linear_problems(ps),
                                  **kw), **kw)
    port_mg = tmg.FullApproximationScheme(
        solver=port_solver(port_decomp(mesh)), **kw)
    ref = jax_mg._make_levels(jax_decomp(mesh), grid, dx, depth)
    got = port_mg._make_levels(grid, dx, depth)
    assert [(lv.grid_shape, lv.dx, lv.sharded) for lv in got] == \
        [(lv.grid_shape, lv.dx, lv.sharded) for lv in ref]
    assert any(lv.sharded for lv in got) == (mesh != (1, 1, 1))


# -- level passes, transfers, cycles: against the JAX sharded solver ----------

@pytest.mark.parametrize("overlap", [False, True], ids=["padded", "overlap"])
@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
def test_level_passes_match_jax(jax_ref, mesh, overlap):
    """smooth(3), residual and tau_rhs on a sharded level (kernel tier:
    padded windows, or interior + shells; plain tier on (2, 2, 2)) vs the
    JAX sharded passes, f64."""
    d = port_decomp(mesh)
    got = level_ops(port_solver(d, overlap=overlap), level0(tmg, True),
                    arrays(), d)
    for kind in LEVEL_KINDS:
        ref = jax_ref[mesh]["level"][kind]
        assert set(got[kind]) == set(ref)
        for n in ref:
            assert isinstance(got[kind][n], pt.ShardedArray)
            assert rel(host(got[kind][n]), ref[n]) <= TOL, (kind, n)


def test_level_passes_match_jax_pallas_tier(jax_ref):
    """The same on (2, 2, 1) against the JAX package's Pallas sweep tier
    (halo-input kernels, interpret mode; tests/test_multigrid.py:219)."""
    d = port_decomp((2, 2, 1))
    got = level_ops(port_solver(d), level0(tmg, True), arrays(), d)
    for kind in LEVEL_KINDS:
        for n, ref in jax_ref["pallas"][kind].items():
            assert rel(host(got[kind][n]), ref) <= TOL, (kind, n)


@pytest.mark.parametrize("overlap", [False, True], ids=["padded", "overlap"])
def test_level_passes_match_jax_f32(jax_ref, overlap):
    """float32 on (2, 1, 1) against the JAX package's f32 passes."""
    d = port_decomp((2, 1, 1))
    got = level_ops(port_solver(d, dtype=np.float32, overlap=overlap),
                    level0(tmg, True), arrays(dtype=np.float32), d)
    for kind in LEVEL_KINDS:
        for n, ref in jax_ref["f32"][kind].items():
            assert got[kind][n].dtype == torch.float32
            assert rel(host(got[kind][n]), ref) <= TOL_F32, (kind, n)


TRANSFERS = {"FullWeighting": {}, "Injection": {},
             "LinearInterpolation": {},
             "CubicInterpolation": {"halo_shape": 2}}


def transfer_input(name):
    shape = GRID if name in ("FullWeighting", "Injection") else tuple(
        n // 2 for n in GRID)
    return np.random.default_rng(3).random(shape)


@pytest.mark.parametrize("name", list(TRANSFERS))
@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
def test_transfers_match_jax(jax_ref, mesh, name):
    """The four transfer operators on a ShardedArray (per block, halos of
    the operator's pad from the neighbours) vs the JAX sharded operators
    and, bit for bit, vs the port's operator on the whole array."""
    d = port_decomp(mesh)
    x = transfer_input(name)
    op = getattr(tmg, name)(**TRANSFERS[name])
    got = op(d.shard(x), decomp=d)
    assert isinstance(got, pt.ShardedArray)
    ref = jax_ref[mesh]["transfers"][name]
    assert got.shape == ref.shape
    assert rel(host(got), ref) <= TOL
    np.testing.assert_array_equal(host(got), op(torch.tensor(x)).numpy())


@pytest.mark.parametrize("MG", ["FullApproximationScheme",
                                "MultiGridSolver"])
@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
def test_cycles_match_jax(jax_ref, mesh, MG):
    """One V-cycle of depth 3 (its 2^3 level replicated) of each scheme
    over the linear pair vs the JAX sharded cycle: the solution within
    TOL, every recorded (level, {name: [Linf, L2]}) within TOL relative."""
    d = port_decomp(mesh)
    a = arrays()
    errs, sol = getattr(tmg, MG)(solver=port_solver(d), halo_shape=1)(
        dx0=DX, cycle=CYCLE, **{n: a[n] for n in ("f", "rho", "f2",
                                                   "rho2")})
    ref_errs, ref_sol = jax_ref[mesh][MG]
    for n in ref_sol:
        assert isinstance(sol[n], pt.ShardedArray)
        assert rel(host(sol[n]), ref_sol[n]) <= TOL
    assert [lv for lv, _ in errs] == [lv for lv, _ in ref_errs]
    for (_, got), (_, ref) in zip(errs, ref_errs):
        for n in ref:
            for g, r in zip(got[n], ref[n]):
                assert isinstance(g, float)
                assert abs(g - r) <= TOL * abs(r)


@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
def test_standalone_relaxation_matches_jax(jax_ref, mesh):
    """``solver(iterations, dx, **arrays)`` on a sharded solver cuts its
    inputs into blocks and relaxes the sharded level, as the JAX
    package's relax.py:501-517."""
    d = port_decomp(mesh)
    a = arrays()
    got = port_solver(d)(iterations=3, dx=DX, **{
        n: a[n] for n in ("f", "rho", "f2", "rho2")})
    for n, ref in jax_ref[mesh]["standalone"].items():
        assert isinstance(got[n], pt.ShardedArray)
        assert rel(host(got[n]), ref) <= TOL


# -- against the port's own single-device solver ------------------------------

SINGLE_CASES = [((2, 1, 1), False), ((2, 1, 1), True), ((2, 2, 1), False),
                ((1, 2, 1), False), ((4, 1, 1), True), ((2, 2, 2), False)]
SINGLE_IDS = ["211-padded", "211-overlap", "221", "121", "411-overlap",
              "222"]


@pytest.mark.parametrize("problem", ["linear", "nonlinear"])
@pytest.mark.parametrize("MG", ["FullApproximationScheme",
                                "MultiGridSolver"])
@pytest.mark.parametrize("mesh,overlap", SINGLE_CASES, ids=SINGLE_IDS)
def test_cycle_equals_single_device(mesh, overlap, MG, problem):
    """A sharded V-cycle (replicated 2^3 level included) equals the port's
    single-device cycle: the unknowns and every L-infinity record bit for
    bit, the L2 records within L2_TOL (rank-order sums); overlapped and
    padded alike, so each equals the other."""
    a = arrays()
    names = ("f", "rho", "f2", "rho2") if problem == "linear" \
        else ("f", "rho")
    kw = {n: a[n] for n in names}
    ref_errs, ref_sol = getattr(tmg, MG)(
        solver=port_solver(problem=problem))(dx0=DX, cycle=CYCLE, **kw)
    d = port_decomp(mesh)
    errs, sol = getattr(tmg, MG)(solver=port_solver(
        d, problem=problem, overlap=overlap))(dx0=DX, cycle=CYCLE, **kw)
    for n in ref_sol:
        np.testing.assert_array_equal(host(sol[n]), ref_sol[n].numpy())
    for (lg, got), (lr, ref) in zip(errs, ref_errs):
        assert lg == lr
        for n in ref:
            assert got[n][0] == ref[n][0]
            assert abs(got[n][1] - ref[n][1]) <= L2_TOL * ref[n][1]


@pytest.mark.parametrize("mesh,overlap", SINGLE_CASES, ids=SINGLE_IDS)
def test_level_passes_equal_single_device(mesh, overlap):
    """Each sharded pass equals the single-device pass bit for bit, on the
    kernel tier's windows and on the plain tier (``smoother="plain"``:
    windows padded along every sharded axis), which name themselves in
    ``level_tier``."""
    a = arrays()
    ref = level_ops(port_solver(), level0(tmg, False), a)
    d = port_decomp(mesh)
    level = level0(tmg, True)
    for smoother in ("kernel", "plain"):
        solver = port_solver(d, overlap=overlap, smoother=smoother)
        got = level_ops(solver, level, a, d)
        for kind in LEVEL_KINDS:
            for n in ref[kind]:
                np.testing.assert_array_equal(host(got[kind][n]),
                                              ref[kind][n].numpy())
        expect = ("plain:halo" if smoother == "plain" or mesh[2] > 1
                  else "kernel:interior+shell" if overlap
                  else "kernel:" + {(2, 1): "xpad", (1, 2): "ypad",
                                    (2, 2): "xypad"}[mesh[:2]])
        assert solver.level_tier(level) == expect


def test_tier_report_and_launch_counts():
    """``kernel_tier_report`` names each level's placement, block and
    tier; on the CPU no launch is counted, and the inputs are not
    written."""
    from pystella_tpu_torch.multigrid import relax
    d = port_decomp((2, 1, 1))
    mg = tmg.FullApproximationScheme(solver=port_solver(d, overlap=True))
    report = mg.kernel_tier_report(GRID, DX, 3)
    assert [(r["sharded"], r["block"], r["tier"]) for r in report] == [
        (True, (8, 16, 16), "kernel:interior+shell"),
        (True, (4, 8, 8), "kernel:interior+shell"),
        (True, (2, 4, 4), "kernel:xpad"),
        (False, (2, 2, 2), "kernel")]
    a = arrays()
    f = d.shard(a["f"])
    before = [b.clone() for b in f.blocks]
    relax.reset_launch_counts()
    mg(dx0=DX, cycle=CYCLE, f=f, rho=a["rho"], f2=a["f2"], rho2=a["rho2"])
    assert set(relax.LAUNCHES.values()) == {0}
    assert all(torch.equal(b, c) for b, c in zip(f.blocks, before))


def test_auto_overlap_splits_large_blocks_only(monkeypatch):
    """``overlap=None`` with ``PYSTELLA_HALO_OVERLAP`` unset splits a sweep
    into interior and shells on blocks of at least
    ``AUTO_OVERLAP_MIN_SITES`` sites only, and takes the padded launch on
    smaller ones; ``overlap=True``/``False``, or the variable set to 1/0,
    applies to every level where the split exists."""
    from pystella_tpu_torch.multigrid import relax
    monkeypatch.delenv("PYSTELLA_HALO_OVERLAP", raising=False)
    n = round(relax.AUTO_OVERLAP_MIN_SITES ** (1 / 3))
    assert n ** 3 == relax.AUTO_OVERLAP_MIN_SITES
    # blocks on (2, 1, 1): n^3 sites, then half of them
    levels = [LevelSpec(shape, (DX,) * 3, True)
              for shape in ((2 * n, n, n), (2 * n, n, n // 2))]
    split, padded = "kernel:interior+shell", "kernel:xpad"

    def tiers(mesh=(2, 1, 1), **kw):
        solver = port_solver(port_decomp(mesh), **kw)
        return [solver.level_tier(lv) for lv in levels]

    assert tiers() == [split, padded]
    assert tiers(overlap=True) == [split, split]
    assert tiers(overlap=False) == [padded, padded]
    assert tiers((2, 2, 1)) == ["kernel:xypad"] * 2
    monkeypatch.setenv("PYSTELLA_HALO_OVERLAP", "1")
    assert tiers() == [split, split]
    monkeypatch.setenv("PYSTELLA_HALO_OVERLAP", "0")
    assert tiers() == [padded, padded]
    assert tiers(overlap=True) == [split, split]


@pytest.mark.parametrize("mesh,overlap", [((2, 2, 1), False),
                                          ((2, 1, 1), True),
                                          ((2, 2, 2), False)],
                         ids=["221", "211-overlap", "222"])
def test_sweeps_bind_each_block_on_its_device(monkeypatch, mesh, overlap):
    """A sharded sweep binds one launcher per block, for that block, so
    each rank's launches run on its own device and stream; a bound launch
    refuses operands on another device than its own."""
    d = port_decomp(mesh)
    solver = port_solver(d, overlap=overlap)
    refs = []
    real = solver._launcher

    def spy(kind, level, ref, *args):
        refs.append(ref.data_ptr())
        return real(kind, level, ref, *args)

    monkeypatch.setattr(solver, "_launcher", spy)
    a = arrays()
    fs = {n: d.shard(a[n]) for n in ("f", "f2")}
    solver.smooth(level0(tmg, True), fs,
                  {n: d.shard(a[n]) for n in ("rho", "rho2")}, {}, 2)
    assert refs == [b.data_ptr() for b in fs["f"].blocks]

    cpu = torch.zeros(GRID, dtype=torch.float64)
    meta = torch.empty(GRID, dtype=torch.float64, device="meta")
    bind = real("smooth", level0(tmg, False), cpu, {}, ())
    with pytest.raises(ValueError, match="bound on cpu"):
        bind([meta, cpu], [cpu, cpu], [], [cpu, cpu])


def test_sharded_arrays_contracts():
    """Blockwise + and - of ShardedArrays (one decomposition only),
    ``unshard`` as the inverse of ``shard``, a ShardedArray of another
    decomposition refused by a sharded level, and one assembled onto the
    device on a replicated level."""
    d, other = port_decomp((2, 2, 1)), port_decomp((2, 2, 1))
    x, y = (np.random.default_rng(s).random(GRID) for s in (1, 2))
    sx, sy = d.shard(x), d.shard(y)
    np.testing.assert_array_equal(host(sx + sy), x + y)
    np.testing.assert_array_equal(host(sx - sy), x - y)
    np.testing.assert_array_equal(d.unshard(sx).numpy(), x)
    with pytest.raises(TypeError):
        sx + other.shard(y)
    with pytest.raises(TypeError):
        sx + torch.tensor(y)
    solver = port_solver(d)
    level = level0(tmg, True)
    with pytest.raises(ValueError, match="another decomposition"):
        solver.residual(level, {"f": other.shard(x), "f2": sx},
                        {"rho": sx, "rho2": sx}, {})
    got = solver.residual(level0(tmg, False), {"f": sx, "f2": sy},
                          {"rho": sy, "rho2": sx}, {})
    ref = port_solver().residual(level0(tmg, False), {"f": x, "f2": y},
                                 {"rho": y, "rho2": x}, {})
    for n in ref:
        assert isinstance(got[n], torch.Tensor)
        assert torch.equal(got[n], ref[n])
    with pytest.raises(ValueError, match="decomposition"):
        port_solver().residual(level, {"f": x, "f2": y},
                               {"rho": y, "rho2": x}, {})
