"""The port's CUDA kernels against their plain PyTorch versions, on the
card.

These tests need an NVIDIA GPU and nvcc, and skip without them: a CUDA
kernel has no CPU mode. The file imports neither JAX nor the JAX package,
so it runs on a machine that has only PyTorch:

    python -m pytest --noconftest tests/test_torch_kernels.py
"""

import contextlib

import numpy as np
import pytest
import torch

import pystella_tpu_torch as pt
from pystella_tpu_torch.ops import fused as tfused

H = 2


def bench_potential(f):
    # the preheating model of bench.py:build_preheat_step
    mphi, gsq = 1.20e-6, 2.5e-7
    phi, chi = f[0], f[1]
    return (mphi**2 / 2 * phi**2 + gsq / 2 * phi**2 * chi**2) / mphi**2


def _rel(got, ref):
    # through float64 in torch: numpy has no bfloat16
    got = got.detach().cpu().double().numpy()
    ref = ref.detach().cpu().double().numpy()
    return np.max(np.abs(got - ref)) / np.max(np.abs(ref))


def _copy(state):
    return {k: v.clone() for k, v in state.items()}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc: the CUDA kernels have no "
                    "CPU mode (run this file on the GPU machine)")
    return torch.device("cuda")


#: kernel vs plain, relative to the output's largest value. The two differ
#: where PyTorch's CUDA division by a Python scalar multiplies by the
#: reciprocal (one extra rounding in dV/df), propagated through ~10
#: roundings of terms no larger than the output: a few ulp.
KERNEL_TOL = {torch.float32: 1e-5, torch.float64: 1e-13}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("grid", [(16, 16, 16), (48, 40, 36)],
                         ids=["16cubed", "48x40x36"])
@pytest.mark.parametrize("kernel", ["fused_stage", "fused_pair"])
def test_kernel_matches_plain(cuda, kernel, grid, dtype):
    """Each CUDA kernel vs its plain version on the same inputs, and the
    launch is counted."""
    st = pt.FusedScalarStepper(pt.ScalarSector(2, potential=bench_potential),
                               grid, 5.0 / grid[0], H, dtype=dtype,
                               device=cuda)
    g = torch.Generator(device=cuda).manual_seed(0)
    amps = (1e-3, 1e-4, 1e-5, 1e-3)
    ins = [a * torch.randn((2,) + grid, generator=g, device=cuda,
                           dtype=dtype) for a in amps]
    A, B = pt.LowStorageRK54._A, pt.LowStorageRK54._B
    params = (0.1 * 5.0 / grid[0], 1.0, 0.5, A[1], B[1])
    if kernel == "fused_pair":
        params += (1.0, 0.5, A[2], B[2])
    plain = st.plain(kernel, ins, params)
    before = tfused.LAUNCHES[kernel]
    outs = st.launch(kernel, ins, [torch.empty_like(ins[0])
                                    for _ in range(4)], params)
    torch.cuda.synchronize()
    assert tfused.LAUNCHES[kernel] == before + 1
    for o, p in zip(outs, plain):
        assert _rel(o, p) <= KERNEL_TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_kernel_pair_equals_two_singles(cuda, dtype):
    """One fused_pair launch equals two fused_stage launches on the card."""
    grid = (48, 40, 36)
    sector = pt.ScalarSector(2, potential=bench_potential)
    kw = dict(dtype=dtype, device=cuda)
    paired = pt.FusedScalarStepper(sector, grid, 0.1, H, **kw)
    single = pt.FusedScalarStepper(sector, grid, 0.1, H, pair_stages=False,
                                   **kw)
    g = torch.Generator(device=cuda).manual_seed(1)
    state = {k: 1e-3 * torch.randn((2,) + grid, generator=g, device=cuda,
                                   dtype=dtype) for k in ("f", "dfdt")}
    got = paired.step(_copy(state), 0.0, 0.01, {"a": 1.0, "hubble": 0.5})
    ref = single.step(_copy(state), 0.0, 0.01, {"a": 1.0, "hubble": 0.5})
    for name in ("f", "dfdt"):
        assert _rel(got[name], ref[name]) <= 1e-14


A, B = pt.LowStorageRK54._A, pt.LowStorageRK54._B

#: sums, kernel vs plain, relative to sum |term| (in float64): f32 sums of
#: ~1e5 (tests) to ~1e8 (512^3) terms in two different orders differ by a
#: few ulp times log2 of the count; -f lap f has mixed signs, so the sum
#: itself is no scale
SUM_TOL = {torch.float32: 1e-5, torch.float64: 1e-12}

#: shapes at the edges of the pairs' x-march (a block's tile is 32 z by
#: 8 y sites, its run 24 x planes for K3 and K6, 32 for K8 and K9;
#: ops/fused.py:march_tile): X not a multiple of the run with Y and Z not
#: multiples of the tile; X below the run and Y below the tile; and 16^3
MARCH_GRIDS = [(70, 12, 40), (5, 9, 33), (16, 16, 16)]
MARCH_IDS = ["70x12x40", "5x9x33", "16cubed"]
#: the x-marching pairs: K3, K6 (both inputs), K8, K9 (both inputs)
MARCH_KERNELS = ["fused_pair", "coupled_pair", "coupled_pair_deferred",
                 "preheat_pair", "preheat_coupled_pair",
                 "preheat_coupled_pair_deferred"]


#: the single stages that march: K5, K7, K5'
STAGE_MARCH_KERNELS = ["fused_stage_energy", "preheat_stage",
                       "preheat_stage_energy"]


def _params(kernel, dx):
    dt = 0.1 * dx
    if kernel == "fused_stage_energy":
        return (dt, 1.0, 0.5, A[1], B[1])
    params = (dt, 1.0, 0.5, A[1], B[1], 1.0001, A[2], B[2])
    if kernel == "coupled_pair_deferred":
        params += (0.49, B[0])
    return params


def term_scale(st, f, df, a, hub):
    """sum |term| of each energy sum of the state (f, df), in float64."""
    f, df = f.double(), df.double()
    lap = pt.FiniteDifferencer(st.h, st.dx, device=f.device).lap(f)
    V = pt.evaluate(st._V, {"f": f, "a": a, "hubble": hub})
    V = torch.as_tensor(V, dtype=torch.float64, device=f.device)
    return torch.cat([(df * df).sum((1, 2, 3)),
                      (f * lap).abs().sum((1, 2, 3)),
                      torch.broadcast_to(V, f.shape[1:]).abs().sum()[None]])


def sum_scales(st, kernel, ins, outs, params):
    """The term scale of each sum set a kernel emits: the entry state's
    and, for a pair, the stage-1 state's (f1 = f2 - B2 kf2 to rounding;
    the velocity df1 is the dfp output)."""
    f, v = ins[0], ins[1]
    if kernel == "coupled_pair_deferred":
        dt, hubfix, B2p = params[0], params[8], params[9]
        v = v + B2p * (ins[2] - 2 * dt * hubfix * v)
    scales = [term_scale(st, f, v, params[1], params[2])]
    if kernel != "fused_stage_energy":
        f1 = outs[0].double() - params[7] * outs[2].double()
        scales.append(term_scale(st, f1, outs[1], params[5], None))
    return scales


def _energy_case(cuda, kernel, grid, dtype, seed=0):
    st = pt.FusedScalarStepper(pt.ScalarSector(2, potential=bench_potential),
                               grid, 5.0 / grid[0], H, dtype=dtype,
                               device=cuda)
    g = torch.Generator(device=cuda).manual_seed(seed)
    amps = (1e-3, 1e-4, 1e-5, 1e-3)
    ins = [a * torch.randn((2,) + grid, generator=g, device=cuda,
                           dtype=dtype) for a in amps]
    return st, ins, _params(kernel, 5.0 / grid[0])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("grid", [(16, 16, 16), (48, 40, 36)],
                         ids=["16cubed", "48x40x36"])
@pytest.mark.parametrize("kernel", ["fused_stage_energy", "coupled_pair",
                                    "coupled_pair_deferred"])
def test_energy_kernel_matches_plain(cuda, kernel, grid, dtype):
    """K5 and both K6 variants vs their plain versions: lattice outputs
    at KERNEL_TOL, sums at SUM_TOL of sum |term|; the launch is counted."""
    st, ins, params = _energy_case(cuda, kernel, grid, dtype)
    plain = st.plain(kernel, ins, params)
    before = tfused.LAUNCHES[kernel]
    outs = st.launch(kernel, ins, [torch.empty_like(ins[0])
                                    for _ in range(4)], params)
    torch.cuda.synchronize()
    assert tfused.LAUNCHES[kernel] == before + 1
    assert len(outs) == len(plain) == 4 + tfused.SUM_SETS[kernel]
    for o, p in zip(outs[:4], plain[:4]):
        assert _rel(o, p) <= KERNEL_TOL[dtype]
    scales = sum_scales(st, kernel, ins, outs, params)
    for got, ref, scale in zip(outs[4:], plain[4:], scales):
        err = ((got.double() - ref.double()).abs() / scale).max().item()
        assert err <= SUM_TOL[dtype], err


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("kernel", ["fused_stage_energy", "coupled_pair",
                                    "coupled_pair_deferred"])
def test_sums_bitwise_repeatable(cuda, kernel, dtype):
    """Two launches on the same inputs give bit-equal sums (fixed
    reduction order, no atomics) and bit-equal lattice outputs."""
    st, ins, params = _energy_case(cuda, kernel, (48, 40, 36), dtype, 1)
    new = lambda: [torch.empty_like(ins[0]) for _ in range(4)]  # noqa
    one = st.launch(kernel, ins, new(), params)
    two = st.launch(kernel, ins, new(), params)
    torch.cuda.synchronize()
    for a, b in zip(one, two):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("grid", [(48, 40, 36)] + MARCH_GRIDS,
                         ids=["48x40x36"] + MARCH_IDS)
@pytest.mark.parametrize("gw", [False, True], ids=["scalar", "gw"])
def test_kernel_identities(cuda, gw, grid, dtype):
    """K5's lattice outputs are bitwise K2's; the K3 pair equals two K2
    stages bit for bit (the x-march's shared f1 is the value the first
    stage stores); the K6 pair + the finalize equals the K3 pair with
    hubble2 = hubfix to rounding. GW: the K8 pair equals two K7 stages bit
    for bit (the shared f1 and h1)."""
    if gw:
        st, ins, params = _preheat_case(cuda, "preheat_pair", grid, dtype, 2)
        new = lambda: [torch.empty_like(t) for t in ins]  # noqa
        dt = params[0]
        pair = st.launch("preheat_pair", ins, new(),
                         (dt, 1.0, 0.5, A[1], B[1], 1.01, 0.49, A[2], B[2]))
        mid = st.launch("preheat_stage", ins, new(),
                        (dt, 1.0, 0.5, A[1], B[1]))
        two = st.launch("preheat_stage", mid, new(),
                        (dt, 1.01, 0.49, A[2], B[2]))
        torch.cuda.synchronize()
        for a, b in zip(pair, two):
            assert torch.equal(a, b)
        return
    st, ins, params = _energy_case(cuda, "coupled_pair", grid, dtype, 2)
    new = lambda: [torch.empty_like(ins[0]) for _ in range(4)]  # noqa
    k2 = st.launch("fused_stage", ins, new(), params[:5])
    k5 = st.launch("fused_stage_energy", ins, new(), params[:5])
    for a, b in zip(k2, k5):
        assert torch.equal(a, b)
    dt = params[0]
    pair = st.launch("fused_pair", ins, new(),
                     (dt, 1.0, 0.5, A[1], B[1], 1.01, 0.49, A[2], B[2]))
    mid = st.launch("fused_stage", ins, new(), (dt, 1.0, 0.5, A[1], B[1]))
    two = st.launch("fused_stage", mid, new(), (dt, 1.01, 0.49, A[2], B[2]))
    torch.cuda.synchronize()
    for a, b in zip(pair, two):
        assert torch.equal(a, b)
    hubfix = 0.49
    pair = st.launch("coupled_pair", ins, new(), params)
    state, k = st._finalize_deferred(st._carry_of(pair[:4]), params[0],
                                     hubfix, params[7])
    ref = st.launch("fused_pair", ins, new(), params[:5] + (
        params[5], hubfix, params[6], params[7]))
    torch.cuda.synchronize()
    tol = {torch.float32: 1e-5, torch.float64: 1e-12}[dtype]
    for got, r in zip((state["f"], state["dfdt"], k["f"], k["dfdt"]), ref):
        assert _rel(got, r) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("pair", [True, False], ids=["pair", "single"])
def test_coupled_multi_step_card_matches_cpu(cuda, pair):
    """coupled_multi_step on the card (K6 / K5) vs the plain versions on
    the CPU, 16^3 f64, two steps: 1e-12 in f, dfdt, a and adot."""
    grid = (16, 16, 16)
    sector = pt.ScalarSector(2, potential=bench_potential)
    g = torch.Generator().manual_seed(4)
    state = {"f": torch.tensor([0.193, 0.0], dtype=torch.float64)[
                 :, None, None, None] + 1e-5 * torch.randn(
                     (2,) + grid, generator=g, dtype=torch.float64),
             "dfdt": torch.tensor([-0.142231, 0.0], dtype=torch.float64)[
                 :, None, None, None] + 1e-5 * torch.randn(
                     (2,) + grid, generator=g, dtype=torch.float64)}
    res = {}
    for dev in ("cpu", cuda):
        st = pt.FusedScalarStepper(sector, grid, 5.0 / 16, H,
                                   dtype=torch.float64, device=dev)
        exp = pt.Expansion(0.03, pt.LowStorageRK54)
        out = st.coupled_multi_step({k: v.to(dev) for k, v in
                                     state.items()}, 2, exp, 0.0,
                                    0.1 * 5.0 / 16, pair=pair)
        res[str(dev)] = ({k: v.cpu() for k, v in out.items()}, exp)
    (ref, e_ref), (got, e_got) = res["cpu"], res[str(cuda)]
    for name in ("f", "dfdt"):
        assert _rel(got[name], ref[name]) <= 1e-12
    assert abs(e_got.a - e_ref.a) / e_ref.a <= 1e-12
    assert abs(e_got.adot - e_ref.adot) / abs(e_ref.adot) <= 1e-12


# -- the whole-RK chunk (K10) and the bfloat16-carry variants ----------------

def _chunk_params(dx, stages=(1, 2, 3, 4)):
    """dt, then per stage a, hubble, A, B (K10's scalars)."""
    p = [0.1 * dx]
    for k, s in enumerate(stages):
        p += [1.0 + 0.01 * k, 0.5 - 0.01 * k, A[s], B[s]]
    return tuple(p)


def _carry_case(cuda, kernel, grid, dtype, carry_dtype, seed=0):
    """A chunk stepper of the bench model, the kernel's four inputs (the
    carries in ``carry_dtype``) and its scalars."""
    st = pt.FusedScalarStepper(pt.ScalarSector(2, potential=bench_potential),
                               grid, 5.0 / grid[0], H, dtype=dtype,
                               carry_dtype=carry_dtype, chunk_stages=4,
                               device=cuda)
    g = torch.Generator(device=cuda).manual_seed(seed)
    amps = (1e-3, 1e-4, 1e-5, 1e-3)
    ins = [(a * torch.randn((2,) + grid, generator=g, device=cuda,
                            dtype=dtype)).to(dt)
           for a, dt in zip(amps, st._dtypes)]
    dx = 5.0 / grid[0]
    params = {"fused_stage": (0.1 * dx, 1.0, 0.5, A[1], B[1]),
              "fused_pair": (0.1 * dx, 1.0, 0.5, A[1], B[1], 1.01, 0.49,
                             A[2], B[2]),
              "fused_chunk": _chunk_params(dx)}[kernel]
    return st, ins, params


CARRIES = {"f32": (torch.float32, None), "f64": (torch.float64, None),
           "f32-bf16": (torch.float32, torch.bfloat16),
           "f64-bf16": (torch.float64, torch.bfloat16)}


#: K10 in every working and carry type; K2 and K3 with bfloat16 carries
#: (in the working type: test_kernel_matches_plain)
CARRY_CASES = [("fused_chunk", c) for c in CARRIES] + [
    (k, c) for k in ("fused_stage", "fused_pair")
    for c in ("f32-bf16", "f64-bf16")]


@pytest.mark.cuda
@pytest.mark.parametrize("grid", [(16, 16, 16), (48, 40, 36)],
                         ids=["16cubed", "48x40x36"])
@pytest.mark.parametrize("kernel,carry", CARRY_CASES)
def test_carry_kernel_matches_plain(cuda, kernel, carry, grid):
    """Each kernel of CARRY_CASES vs its plain version: KERNEL_TOL of the
    working type on every output (the bf16 carries compared as values),
    and the launch is counted under its variant's name."""
    dtype, cd = CARRIES[carry]
    st, ins, params = _carry_case(cuda, kernel, grid, dtype, cd)
    plain = st.plain(kernel, ins, params)
    key = st.counted_name(kernel)
    before = tfused.LAUNCHES[key]
    outs = st.launch(kernel, ins, [torch.empty_like(t) for t in ins], params)
    torch.cuda.synchronize()
    assert tfused.LAUNCHES[key] == before + 1
    for o, p, dt in zip(outs, plain, st._dtypes):
        assert o.dtype == p.dtype == dt
        assert _rel(o, p) <= KERNEL_TOL[dtype]


#: K10's march (ops/fused.py:chunk_tile) at its edges: the bench model at
#: 48x40x36 and the pairs' march shapes (runs cut short, tiles hanging over
#: Y and Z), and at 2^3, where the grown tiles wrap several times; and the
#: five-field model at h = 4 (SPLIT_F, SPLIT_H, SPLIT_GRID below), whose
#: planes take a lower rung of the ladder of tiles, in f32 and in f64
CHUNK_CASES = [("bench", (48, 40, 36)), ("bench", (70, 12, 40)),
               ("bench", (5, 9, 33)), ("bench", (2, 2, 2)),
               ("wide", (37, 12, 40))]
CHUNK_IDS = ["48x40x36", "70x12x40", "5x9x33", "2cubed", "wide-h4"]


def _chunk_stepper(cuda, model, grid, dtype, carry_dtype):
    """A chunk stepper of the bench model (two fields, h = 2) or of the
    wide one (five fields, h = 4), on ``cuda`` or the CPU."""
    if model == "bench":
        sector, h = pt.ScalarSector(2, potential=bench_potential), H
    else:
        sector = pt.ScalarSector(SPLIT_F, potential=many_potential(SPLIT_F))
        h = SPLIT_H
    return pt.FusedScalarStepper(sector, grid, 5.0 / grid[0], h, dtype=dtype,
                                 carry_dtype=carry_dtype, chunk_stages=4,
                                 device=cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("model,grid", CHUNK_CASES, ids=CHUNK_IDS)
@pytest.mark.parametrize("carry", list(CARRIES))
def test_chunk_equals_two_pairs(cuda, carry, model, grid):
    """One K10 launch equals two K3 launches bit for bit, state and
    carries (the same operations in the same order under -fmad=false; the
    bf16 carries rounded at the same place), at the march's edges; the
    wide model runs on a lower rung of the ladder than the first, the
    tile the host mirror predicts."""
    dtype, cd = CARRIES[carry]
    st = _chunk_stepper(cuda, model, grid, dtype, cd)
    tile = st.chunk_kernel_tile(dtype)
    assert tile == tfused.chunk_tile(st.F, st.h, dtype.itemsize, 4)
    assert (tile[0][1:] == (tfused.CHUNK_ROWS, 32)) == (model == "bench")
    g = torch.Generator(device=cuda).manual_seed(3)
    amps = (1e-3, 1e-4, 1e-5, 1e-3)
    ins = [(a * torch.randn((st.F,) + grid, generator=g, device=cuda,
                            dtype=dtype)).to(d)
           for a, d in zip(amps, st._dtypes)]
    params = _chunk_params(5.0 / grid[0])
    new = lambda: [torch.empty_like(t) for t in ins]  # noqa
    chunk = st.launch("fused_chunk", ins, new(), params)
    mid = st.launch("fused_pair", ins, new(), params[:9])
    two = st.launch("fused_pair", mid, new(), params[:1] + params[9:])
    torch.cuda.synchronize()
    for a, b in zip(chunk, two):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("model,grid", [("bench", (16, 16, 16))]
                         + CHUNK_CASES[1:], ids=["16cubed"] + CHUNK_IDS[1:])
@pytest.mark.parametrize("carry", ["f64", "f32-bf16"])
def test_chunk_multi_step_card_matches_cpu(cuda, carry, model, grid):
    """multi_step(3) with chunk_stages=4 on the card (K10, K3, K2) vs the
    plain versions on the CPU, at 16^3 and the march's edges: f64 to
    1e-12; with bf16 carries to 1e-5 (the kernels' f32 may differ from the
    plain versions' by an ulp where PyTorch divides by the reciprocal,
    which can flip a carry's bf16 rounding: one bf16 ulp of a carry,
    scaled by B*dt)."""
    dtype, cd = CARRIES[carry]
    F = 2 if model == "bench" else SPLIT_F
    g = torch.Generator().manual_seed(5)
    state = {"f": 1e-3 * torch.randn((F,) + grid, generator=g, dtype=dtype),
             "dfdt": 1e-4 * torch.randn((F,) + grid, generator=g,
                                        dtype=dtype)}
    res = {}
    for dev in ("cpu", cuda):
        st = _chunk_stepper(dev, model, grid, dtype, cd)
        out = st.multi_step({k: v.to(dev) for k, v in state.items()}, 3,
                            0.0, 0.1 * 5.0 / grid[0],
                            {"a": 1.0, "hubble": 0.5})
        res[str(dev)] = {k: v.cpu() for k, v in out.items()}
    tol = 1e-12 if cd is None else 1e-5
    for name in ("f", "dfdt"):
        assert _rel(res[str(cuda)][name], res["cpu"][name]) <= tol


# -- the gravitational-wave system: K7, K8, K5', K9 --------------------------

GW_KERNELS = ("preheat_stage", "preheat_pair", "preheat_stage_energy",
              "preheat_coupled_pair", "preheat_coupled_pair_deferred")


def _preheat_case(cuda, kernel, grid, dtype, seed=0):
    """A GW stepper of the bench model and the kernel's eight inputs:
    bench-like scalar arrays, hij 1e-3 N(0, 1), dhijdt 1e-4 N(0, 1) and
    small tensor k-carries (the deferred pair takes them as f, dfp, kdfp,
    kf, hij, dhp, kdhp, khij)."""
    sector = pt.ScalarSector(2, potential=bench_potential)
    st = pt.FusedPreheatStepper(sector, pt.TensorPerturbationSector(
        [sector]), grid, 5.0 / grid[0], H, dtype=dtype, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(seed)
    amps = (1e-3, 1e-4, 1e-5, 1e-3, 1e-3, 1e-4, 1e-5, 1e-4)
    ins = [a * torch.randn((2 if j < 4 else 6,) + grid, generator=g,
                           device=cuda, dtype=dtype)
           for j, a in enumerate(amps)]
    return st, ins, _gw_params(kernel, 5.0 / grid[0])


def _gw_params(kernel, dx):
    """A GW kernel takes its scalar counterpart's scalars (a scalar kernel
    its own)."""
    scalar = tfused._GW_OF.get(kernel, kernel)
    if scalar == "fused_pair":
        return (0.1 * dx, 1.0, 0.5, A[1], B[1], 1.0, 0.5, A[2], B[2])
    return _params("fused_stage_energy" if scalar == "fused_stage"
                   else scalar, dx)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("grid", [(16, 16, 16), (48, 40, 36)],
                         ids=["16cubed", "48x40x36"])
@pytest.mark.parametrize("kernel", GW_KERNELS)
def test_preheat_kernel_matches_plain(cuda, kernel, grid, dtype):
    """K7, K8, K5' and both K9 variants vs their plain versions: the eight
    lattice outputs at KERNEL_TOL, the scalar sector's sums at SUM_TOL of
    sum |term|; the launch is counted."""
    st, ins, params = _preheat_case(cuda, kernel, grid, dtype)
    plain = st.plain(kernel, ins, params)
    before = tfused.LAUNCHES[kernel]
    outs = st.launch(kernel, ins, [torch.empty_like(t) for t in ins],
                     params)
    torch.cuda.synchronize()
    assert tfused.LAUNCHES[kernel] == before + 1
    assert len(outs) == len(plain) == 8 + tfused.SUM_SETS[kernel]
    for o, p in zip(outs[:8], plain[:8]):
        assert _rel(o, p) <= KERNEL_TOL[dtype]
    if not tfused.SUM_SETS[kernel]:
        return
    scales = sum_scales(st, tfused._GW_OF[kernel], ins, outs, params)
    for got, ref, scale in zip(outs[8:], plain[8:], scales):
        err = ((got.double() - ref.double()).abs() / scale).max().item()
        assert err <= SUM_TOL[dtype], err


@pytest.mark.cuda
@pytest.mark.parametrize("grid", MARCH_GRIDS, ids=MARCH_IDS)
@pytest.mark.parametrize("carry", ["f32", "f64", "f32-bf16", "f64-bf16"])
@pytest.mark.parametrize("kernel", MARCH_KERNELS + STAGE_MARCH_KERNELS)
def test_march_edges_match_plain(cuda, kernel, carry, grid):
    """K3, K8, both inputs of K6 and K9, and the stage marches K5, K7 and
    K5' at the x-march's edges (runs cut short, tiles hanging over Y and
    Z), with carries in the working type and in bf16: every lattice output
    at KERNEL_TOL of the plain version, the sums at SUM_TOL of sum |term|,
    and a second launch bit-equal to the first."""
    dtype, carry_dtype = CARRIES[carry]
    if carry_dtype is None and kernel in GW_KERNELS:
        st, ins, params = _preheat_case(cuda, kernel, grid, dtype, 4)
    else:
        st, ins, params = _bf16_case(cuda, kernel, False, grid, dtype, 4,
                                     carry_dtype)
    n = len(ins)
    plain = st.plain(kernel, ins, params)
    one = st.launch(kernel, ins, st._new_set(cuda), params)
    two = st.launch(kernel, ins, st._new_set(cuda), params)
    torch.cuda.synchronize()
    assert len(one) == len(plain) == n + tfused.SUM_SETS[kernel]
    for a, b in zip(one, two):
        assert torch.equal(a, b)
    for o, p in zip(one[:n], plain[:n]):
        assert _rel(o, p) <= KERNEL_TOL[dtype]
    if tfused.SUM_SETS[kernel]:
        wide = [t.to(dtype) for t in ins]
        assert max(_sum_errs(st, kernel, wide, [t.to(dtype) for t in
                                                one[:n]] + one[n:],
                             plain, params)) <= SUM_TOL[dtype]


def many_potential(n):
    """A potential of ``n`` fields: each massive, the first coupled to the
    others."""
    def potential(f):
        return (sum((0.5 + 0.1 * i) * f[i]**2 / 2 for i in range(n))
                + 0.25 * f[0]**2 * sum(f[i]**2 for i in range(1, n)))
    return potential


#: a model wide enough for the x-march's split layout (ops/fused.py:
#: march_tile): five fields at h = 4 leave no room for a tensor component
#: beside every field's f and f1 in f64, which marches scalar passes of
#: four fields and one, then tensor passes of three components; f32 stays
#: joint, three components a pass. The scalar march of the same model holds
#: every field's f and f1 in f32 (at one block an SM) but not in f64, so
#: it marches scalar passes there. The grid's runs and tiles are cut short
SPLIT_F, SPLIT_H, SPLIT_GRID = 5, 4, (37, 12, 40)


@pytest.mark.cuda
@pytest.mark.parametrize("carry", ["f32", "f64", "f32-bf16", "f64-bf16"])
@pytest.mark.parametrize("kernel", MARCH_KERNELS)
def test_march_split_layout_matches_plain(cuda, kernel, carry):
    """K3, K8 and both inputs of K6 and K9 of the five-field model at h =
    4, carries in the working type and in bf16: every lattice output at
    KERNEL_TOL of the plain version, the sums at SUM_TOL of sum |term|; a
    second launch and the x- and y-padded launch on windows padded by hand
    equal the first bit for bit; the pair (K3, K8) equals two single
    stages (K2, K7) across a step boundary bit for bit, and its interior
    and two x-shell launches its x-padded one."""
    dtype, carry_dtype = CARRIES[carry]
    grid, h = SPLIT_GRID, SPLIT_H
    sector = pt.ScalarSector(SPLIT_F, potential=many_potential(SPLIT_F))
    kw = dict(dtype=dtype, carry_dtype=carry_dtype, device=cuda)
    if kernel in GW_KERNELS:
        st = pt.FusedPreheatStepper(sector, pt.TensorPerturbationSector(
            [sector]), grid, 5.0 / grid[0], h, **kw)
    else:
        st = pt.FusedScalarStepper(sector, grid, 5.0 / grid[0], h, **kw)
    g = torch.Generator(device=cuda).manual_seed(6)
    amps = (1e-3, 1e-4, 1e-5, 1e-3, 1e-3, 1e-4, 1e-5, 1e-4)
    ins = [(a * torch.randn((c,) + grid, generator=g, device=cuda,
                            dtype=dtype)).to(d)
           for a, c, d in zip(amps, st._comps, st._in_dtypes(False))]
    params = _gw_params(kernel, 5.0 / grid[0])
    n = len(ins)
    plain = st.plain(kernel, ins, params)
    one = st.launch(kernel, ins, st._new_set(cuda), params)
    two = st.launch(kernel, ins, st._new_set(cuda), params)
    wins = tfused._WINDOWS[kernel]
    padded = st.launch_block(
        kernel, "xypad", [_pad_periodic(t, h, h) if j in wins else t
                          for j, t in enumerate(ins)],
        st._new_set(cuda), params)
    torch.cuda.synchronize()
    tile = st.march_kernel_tile(dtype, tfused.KERNELS[kernel][0])
    (_, gf, g_, joint), _ = tile
    assert tile == tfused.march_tile(SPLIT_F, h, dtype.itemsize,
                                     st._march_nh)
    if kernel in GW_KERNELS:
        assert (joint, gf, g_) == ((1, 5, 3) if dtype == torch.float32
                                   else (0, 4, 3))
    else:
        assert g_ == 0 and (dtype == torch.float32 or not joint)
    assert len(one) == len(plain) == n + tfused.SUM_SETS[kernel]
    for a, b, c in zip(one, two, padded):
        assert torch.equal(a, b) and torch.equal(a, c)
    for o, p in zip(one[:n], plain[:n]):
        assert _rel(o, p) <= KERNEL_TOL[dtype]
    if tfused.SUM_SETS[kernel]:
        wide = [t.to(dtype) for t in ins]
        assert max(_sum_errs(st, kernel, wide, [t.to(dtype) for t in
                                                one[:n]] + one[n:],
                             plain, params)) <= SUM_TOL[dtype]
        return
    dt = params[0]
    stage = st._KERNEL["stage"]
    pair = st.launch(kernel, ins, st._new_set(cuda),
                     (dt, 1.0, 0.5, A[4], B[4], 1.01, 0.49, A[0], B[0]))
    mid = st.launch(stage, ins, st._new_set(cuda),
                    (dt, 1.0, 0.5, A[4], B[4]))
    stages = st.launch(stage, mid, st._new_set(cuda),
                       (dt, 1.01, 0.49, A[0], B[0]))
    X = grid[0]
    xpad = [_pad_periodic(t, h, 0) if j in wins else t
            for j, t in enumerate(ins)]
    ref = st.launch_block(kernel, "xpad", xpad, st._new_set(cuda), params)
    outs = st._new_set(cuda)
    st.launch_block(kernel, "interior", ins, outs, params, x0=h)
    for x0 in (0, X - h):
        st.launch_block(kernel, "shell", [
            t.narrow(1, x0, 3 * h).contiguous() if j in wins else t
            for j, t in enumerate(xpad)], outs, params, x0=x0)
    torch.cuda.synchronize()
    for a, b in zip(pair, stages):
        assert torch.equal(a, b)
    for o, r in zip(outs, ref):
        assert torch.equal(o, r)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("kernel", ["preheat_stage_energy",
                                    "preheat_coupled_pair",
                                    "preheat_coupled_pair_deferred"])
def test_preheat_sums_bitwise_repeatable(cuda, kernel, dtype):
    """Two launches on the same inputs give bit-equal sums and lattice
    outputs; K5''s lattice outputs are K7's bit for bit."""
    st, ins, params = _preheat_case(cuda, kernel, (48, 40, 36), dtype, 1)
    new = lambda: [torch.empty_like(t) for t in ins]  # noqa
    one = st.launch(kernel, ins, new(), params)
    two = st.launch(kernel, ins, new(), params)
    torch.cuda.synchronize()
    for a, b in zip(one, two):
        assert torch.equal(a, b)
    if kernel == "preheat_stage_energy":
        k7 = st.launch("preheat_stage", ins, new(), params)
        torch.cuda.synchronize()
        for a, b in zip(one[:8], k7):
            assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("pair", [True, False], ids=["pair", "single"])
def test_preheat_coupled_card_matches_cpu(cuda, pair):
    """FusedPreheatStepper.coupled_multi_step on the card (K9, K5') vs
    the plain versions on the CPU, 16^3 f64, two steps: 1e-12 in every
    field, a and adot."""
    grid = (16, 16, 16)
    sector = pt.ScalarSector(2, potential=bench_potential)
    gw = pt.TensorPerturbationSector([sector])
    g = torch.Generator().manual_seed(4)
    state = {"f": torch.tensor([0.193, 0.0], dtype=torch.float64)[
                 :, None, None, None] + 1e-5 * torch.randn(
                     (2,) + grid, generator=g, dtype=torch.float64),
             "dfdt": torch.tensor([-0.142231, 0.0], dtype=torch.float64)[
                 :, None, None, None] + 1e-5 * torch.randn(
                     (2,) + grid, generator=g, dtype=torch.float64),
             "hij": 1e-6 * torch.randn((6,) + grid, generator=g,
                                       dtype=torch.float64),
             "dhijdt": 1e-7 * torch.randn((6,) + grid, generator=g,
                                          dtype=torch.float64)}
    res = {}
    for dev in ("cpu", cuda):
        st = pt.FusedPreheatStepper(sector, gw, grid, 5.0 / 16, H,
                                    dtype=torch.float64, device=dev)
        exp = pt.Expansion(0.03, pt.LowStorageRK54)
        out = st.coupled_multi_step({k: v.to(dev) for k, v in
                                     state.items()}, 2, exp, 0.0,
                                    0.1 * 5.0 / 16, pair=pair)
        res[str(dev)] = ({k: v.cpu() for k, v in out.items()}, exp)
    (ref, e_ref), (got, e_got) = res["cpu"], res[str(cuda)]
    for name in ("f", "dfdt", "hij", "dhijdt"):
        assert _rel(got[name], ref[name]) <= 1e-12
    assert abs(e_got.a - e_ref.a) / e_ref.a <= 1e-12
    assert abs(e_got.adot - e_ref.adot) / abs(e_ref.adot) <= 1e-12


# -- the finite-difference operators (K12) and the multigrid sweeps (K11) -----

from pystella_tpu_torch import multigrid as tmg  # noqa: E402
from pystella_tpu_torch.multigrid import relax as trelax  # noqa: E402
from pystella_tpu_torch.ops import derivs as tderivs  # noqa: E402
from pystella_tpu_torch.ops import stencil as tstencil  # noqa: E402

#: the operators add and multiply in the plain versions' order and nothing
#: else: a few ulp of the output's largest value at most (0 expected)
FD_TOL = {torch.float32: 1e-6, torch.float64: 1e-14}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("grid", [(16, 16, 16), (48, 40, 36), (4, 2, 6)],
                         ids=["16cubed", "48x40x36", "4x2x6"])
@pytest.mark.parametrize("h", [1, 2, 3, 4])
@pytest.mark.parametrize("op", tderivs.OPS)
def test_fd_kernel_matches_plain(cuda, op, h, grid, dtype):
    """Each K12 operator vs its plain version on the same input (also on
    a lattice narrower than the stencil, where taps wrap more than once),
    and the launch is counted."""
    fd = pt.FiniteDifferencer(h, (0.3, 0.25, 0.2))
    g = torch.Generator(device=cuda).manual_seed(h)
    x = torch.randn((6,) + grid, generator=g, device=cuda, dtype=dtype)
    plain = fd.plain(op, x)
    before = tderivs.LAUNCHES["fd_" + op]
    outs = fd.launch(op, x)
    torch.cuda.synchronize()
    assert tderivs.LAUNCHES["fd_" + op] == before + 1
    assert len(outs) == len(plain) == (2 if op == "grad_lap" else 1)
    for o, p in zip(outs, plain):
        assert o.shape == p.shape and o.dtype == dtype
        # not _rel: at Y = 2 both y neighbours are one site and pdy is 0
        assert (o - p).abs().max() <= FD_TOL[dtype] * p.abs().max()


@pytest.mark.cuda
def test_fd_public_operators_on_card(cuda):
    """The public operators on CUDA tensors with outer axes: the shapes
    of the CPU path, values within rounding of it, every operator through
    its kernel; ``mode="roll"`` launches nothing."""
    fd = pt.FiniteDifferencer(2, 0.1)
    fd_cpu = pt.FiniteDifferencer(2, 0.1, device="cpu")
    x = torch.randn((2, 3, 12, 10, 8), dtype=torch.float64,
                    generator=torch.Generator().manual_seed(3))
    tderivs.reset_launch_counts()
    xc = x.to(cuda)
    g, lap = fd.grad_lap(xc)
    res = {"lap": fd.lap(xc), "grad": fd.grad(xc), "pdx": fd.pdx(xc),
           "pdy": fd.pdy(xc), "pdz": fd.pdz(xc),
           "divergence": fd.divergence(xc), "g": g, "l": lap}
    ref_g, ref_l = fd_cpu.grad_lap(x)
    ref = {"lap": fd_cpu.lap(x), "grad": fd_cpu.grad(x),
           "pdx": fd_cpu.pdx(x), "pdy": fd_cpu.pdy(x), "pdz": fd_cpu.pdz(x),
           "divergence": fd_cpu.divergence(x), "g": ref_g, "l": ref_l}
    unsharded = {k: v for k, v in tderivs.LAUNCHES.items()
                 if k in tderivs.KERNELS}
    assert set(unsharded.values()) == {1}
    assert sum(tderivs.LAUNCHES.values()) == len(unsharded)
    for k in ref:
        assert res[k].shape == ref[k].shape
        assert _rel(res[k], ref[k]) <= 1e-14
    pt.FiniteDifferencer(2, 0.1, mode="roll").lap(xc)
    assert sum(tderivs.LAUNCHES.values()) == len(unsharded)


def _mg_problem(kind):
    fld = pt.Field
    if kind == "newton":
        f = fld("f")
        return tmg.NewtonIterator, {f: (fld("lap_f") - f + f**3,
                                        fld("rho"))}, 2 / 3
    return tmg.JacobiIterator, {
        fld("f"): (fld("lap_f"), fld("rho")),
        fld("f2"): (fld("lap_f2") - fld("f2"), fld("rho2"))}, 1 / 2


#: sweeps, kernel vs plain: the same operations in the same order (0
#: expected; the bar leaves room for a few ulp over three sweeps)
MG_TOL = {torch.float32: 1e-5, torch.float64: 1e-13}

#: the defines of K11 builds that march every launch, however small its
#: level, and that run every launch per site (the site threshold past any
#: level); of the K12 build whose operators run per site, and of the
#: fused_stage.cu build whose K2 runs per site
MG_MARCH_ALL = "\n#define MG_MARCH_MIN_SITES 1\n"
MG_PER_SITE = f"\n#define MG_MARCH_MIN_SITES {2**31 - 1}\n"
FD_PER_SITE = "\n#define PK_FD_PER_SITE 1\n"
STAGE_PER_SITE = "\n#define PK_STAGE_PER_SITE 1\n"
_BUILDS = {}


def _mg_build(solver, defines):
    """The K11 entry points of ``solver``'s equations built with
    ``defines`` after the generated header, their tile held to
    ``mg_tile``."""
    header = solver.kernel_header() + defines
    if header not in _BUILDS:
        lib = tstencil.build_kernels(["mg_relax.cu"], header)["mg_relax.cu"]
        solver.check_tile(lib, min_sites=int(defines.split()[-1]))
        _BUILDS[header] = trelax.bind_kernels(lib)
    return _BUILDS[header]


@contextlib.contextmanager
def _mg_lib(solver, defines):
    """Within, ``solver``'s launches run the build with ``defines`` (None:
    its own)."""
    keep = solver.build_kernels()
    if defines is not None:
        solver._libs[()] = _mg_build(solver, defines)
    try:
        yield
    finally:
        solver._libs[()] = keep


@contextlib.contextmanager
def _stage_per_site(st):
    """Within, stepper ``st``'s K2 launches (every entry point) run the
    fused_stage.cu build whose K2 runs per site (``PK_STAGE_PER_SITE``),
    bound as ``st`` binds its own."""
    header = st.kernel_header() + STAGE_PER_SITE
    if header not in _BUILDS:
        _BUILDS[header] = tstencil.build_kernels(["fused_stage.cu"],
                                                 header)["fused_stage.cu"]
    keep = dict(st._libs)
    for key, fn in keep.items():
        if key[0] == "fused_stage":
            other = getattr(_BUILDS[header], fn.__name__)
            other.argtypes, other.restype = fn.argtypes, fn.restype
            st._libs[key] = other
    try:
        yield
    finally:
        st._libs.update(keep)


def _fd_per_site(h):
    """Within, the operators of stencil radius ``h`` run the build whose
    operators run per site."""
    return _fd_lib(h, FD_PER_SITE)


@contextlib.contextmanager
def _fd_lib(h, defines):
    """Within, the operators of stencil radius ``h`` run the fd_ops.cu
    build with ``defines`` after the generated header."""
    keep = tderivs.build_kernels(h)
    header = tderivs.kernel_header(h) + defines
    if header not in _BUILDS:
        _BUILDS[header] = tderivs.bind_kernels(tstencil.build_kernels(
            ["fd_ops.cu"], header)["fd_ops.cu"])
    tderivs._LIBS[h] = _BUILDS[header]
    try:
        yield
    finally:
        tderivs._LIBS[h] = keep


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("grid", [(16, 16, 16), (48, 40, 36), (8, 8, 8),
                                  (2, 2, 2), (64, 256, 256)],
                         ids=["16cubed", "48x40x36", "8cubed", "2cubed",
                              "64x256x256"])
@pytest.mark.parametrize("problem", ["newton", "jacobi"])
def test_mg_kernel_matches_plain(cuda, problem, grid, dtype):
    """mg_smooth (1 and 3 sweeps), mg_residual and mg_tau vs the plain
    version, down to a 2^3 level; each sweep is one counted launch. The
    default build runs the per-site kernel on the small levels and the
    march on a region of ``mg_tile``'s threshold (64 x 256^2 sites);
    a build that marches every launch is held to the plain version too."""
    cls, lhs, omega = _mg_problem(problem)
    solver = cls(lhs, halo_shape=1, omega=omega, device=cuda)
    plain = cls(lhs, halo_shape=1, omega=omega, smoother="plain",
                device=cuda)
    level = trelax.LevelSpec(grid, (10.0 / 16,) * 3)
    g = torch.Generator(device=cuda).manual_seed(5)
    fs = {n: torch.rand(grid, generator=g, device=cuda, dtype=dtype) - 0.5
          for n in solver.f_to_rho_dict}
    rhos = {r: torch.rand(grid, generator=g, device=cuda, dtype=dtype) - 0.5
            for r in solver.f_to_rho_dict.values()}
    rr = {n: rhos[r] for n, r in solver.f_to_rho_dict.items()}
    for build in (None, MG_MARCH_ALL):
        trelax.reset_launch_counts()
        with _mg_lib(solver, build):
            pairs = [(solver.smooth(level, fs, rhos, {}, 1),
                      plain.smooth(level, fs, rhos, {}, 1)),
                     (solver.smooth(level, fs, rhos, {}, 3),
                      plain.smooth(level, fs, rhos, {}, 3)),
                     (solver.residual(level, fs, rhos, {}),
                      plain.residual(level, fs, rhos, {})),
                     (solver.tau_rhs(level, fs, rr, {}),
                      plain.tau_rhs(level, fs, rr, {}))]
        torch.cuda.synchronize()
        assert {k: v for k, v in trelax.LAUNCHES.items() if v} == {
            "mg_smooth": 4, "mg_residual": 1, "mg_tau": 1}
        for got, ref in pairs:
            assert set(got) == set(ref)
            for n in ref:
                assert got[n].dtype == dtype
                assert _rel(got[n], ref[n]) <= MG_TOL[dtype]


@pytest.mark.cuda
def test_mg_kernel_aux_inputs(cuda):
    """A lattice-valued and a scalar auxiliary input reach the kernel
    (a library of its own, built at first use)."""
    fld = pt.Field
    lhs = fld("lap_f") - pt.Var("m2") * fld("f") + fld("c") * fld("g")
    grid = (12, 10, 8)
    level = trelax.LevelSpec(grid, (0.5, 0.4, 0.3))
    g = torch.Generator(device=cuda).manual_seed(6)
    f, rho, aux = (torch.rand(grid, generator=g, device=cuda,
                              dtype=torch.float64) for _ in range(3))
    args = (level, {"f": f}, {"rho": rho}, {"g": aux, "m2": 0.5, "c": 2.0})
    res = {}
    for smoother in ("kernel", "plain"):
        solver = tmg.NewtonIterator({fld("f"): (lhs, fld("rho"))},
                                    omega=2 / 3, smoother=smoother,
                                    device=cuda)
        res[smoother] = solver.smooth(*args, 2)["f"]
    assert _rel(res["kernel"], res["plain"]) <= 1e-13


@pytest.mark.cuda
@pytest.mark.parametrize("MG", ["FullApproximationScheme",
                                "MultiGridSolver"])
def test_mg_cycle_card_matches_cpu(cuda, MG):
    """One default V-cycle at 32^3 f64 on the card (K11) vs the plain
    versions on the CPU: solution and every recorded error within 1e-12;
    the errors come back as floats from the deferred record."""
    cls, lhs, omega = _mg_problem("jacobi")
    g = torch.Generator().manual_seed(7)
    arrays = {}
    for name in ("f", "rho", "f2", "rho2"):
        a = torch.rand((32,) * 3, generator=g, dtype=torch.float64)
        arrays[name] = a - a.mean()
    res = {}
    for dev in ("cpu", cuda):
        solver = cls(lhs, halo_shape=1, omega=omega, device=dev)
        errs, sol = getattr(tmg, MG)(solver=solver)(dx0=10.0 / 32, **arrays)
        res[str(dev)] = (errs, {k: v.cpu() for k, v in sol.items()})
    (e_ref, s_ref), (e_got, s_got) = res["cpu"], res[str(cuda)]
    for n in s_ref:
        assert _rel(s_got[n], s_ref[n]) <= 1e-12
    for (lg, got), (lr, ref) in zip(e_got, e_ref):
        assert lg == lr
        for n in ref:
            for a, b in zip(got[n], ref[n]):
                assert isinstance(a, float) and abs(a - b) <= 1e-12 * abs(b)


def _periodic_window(t, hx, hy):
    """An (X, Y, Z) tensor padded by its own periodic rows along x and y:
    the window a sharded level's launch reads when one block is the whole
    lattice."""
    if hx:
        t = torch.cat([t[-hx:], t, t[:hx]], 0)
    if hy:
        t = torch.cat([t[:, -hy:], t, t[:, :hy]], 1)
    return t.contiguous()


def _mg_case(cuda, problem, grid, dtype, seed=8):
    cls, lhs, omega = _mg_problem(problem)
    solver = cls(lhs, halo_shape=1, omega=omega, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(seed)
    names = list(solver.f_to_rho_dict)
    fs = [torch.rand(grid, generator=g, device=cuda, dtype=dtype) - 0.5
          for _ in names]
    rhos = [torch.rand(grid, generator=g, device=cuda, dtype=dtype) - 0.5
            for _ in names]
    level = trelax.LevelSpec(grid, (10.0 / 16, 0.5, 0.4))
    return solver, level, fs, rhos


def _new(fs):
    return [torch.empty_like(f) for f in fs]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("pad", ["xpad", "ypad", "xypad"])
@pytest.mark.parametrize("kind", ["smooth", "residual", "tau"])
@pytest.mark.parametrize("problem", ["newton", "jacobi"])
def test_mg_padded_kernel_matches_plain(cuda, problem, kind, pad, dtype):
    """Each padded K11 entry point (a sharded level's launch) on windows
    built from the lattice's own periodic rows: against its plain version
    on the same windows (0.0 expected), bit for bit against the unpadded
    launch on the whole lattice, and counted as ``mg_<kind>:<pad>``."""
    solver, level, fs, rhos = _mg_case(cuda, problem, (20, 16, 12), dtype)
    hx, hy = (1 if pad != "ypad" else 0), (1 if pad != "xpad" else 0)
    wins = [_periodic_window(f, hx, hy) for f in fs]
    ref = solver.launch_block(kind, level, fs, rhos, {}, _new(fs))
    before = trelax.LAUNCHES[f"mg_{kind}:{pad}"]
    got = solver.launch_block(kind, level, wins, rhos, {}, _new(fs), pad)
    plain = solver.plain(kind, level, wins, rhos, {}, {}, pad=(hx, hy))
    torch.cuda.synchronize()
    assert trelax.LAUNCHES[f"mg_{kind}:{pad}"] == before + 1
    for o, r, p in zip(got, ref, plain):
        assert torch.equal(o, r)
        assert _rel(o, p) <= MG_TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("kind", ["smooth", "residual", "tau"])
@pytest.mark.parametrize("problem", ["newton", "jacobi"])
def test_mg_interior_and_shells_equal_padded(cuda, problem, kind, dtype):
    """The overlapped path's launches: the interior on the raw block and
    the two x shells on ``(3h, Y, Z)`` slabs, each writing its rows of the
    full output block, together equal the x-padded launch bit for bit;
    each region against its plain version. The default build (per site
    on this block) and a build that marches every launch (a shell is a
    run of h planes)."""
    solver, level, fs, rhos = _mg_case(cuda, problem, (12, 10, 8), dtype)
    X, h = fs[0].shape[0], 1
    padded = [_periodic_window(f, h, 0) for f in fs]
    lows = [p[:3 * h].contiguous() for p in padded]
    highs = [p[X - h:X + 2 * h].contiguous() for p in padded]
    for build in (None, MG_MARCH_ALL):
        with _mg_lib(solver, build):
            ref = solver.launch_block(kind, level, padded, rhos, {},
                                      _new(fs), "xpad")
            outs = _new(fs)
            solver.launch_block(kind, level, fs, rhos, {}, outs, "interior",
                                h)
            solver.launch_block(kind, level, lows, rhos, {}, outs, "shell",
                                0)
            solver.launch_block(kind, level, highs, rhos, {}, outs, "shell",
                                X - h)
        torch.cuda.synchronize()
        for o, r in zip(outs, ref):
            assert torch.equal(o, r)
        for wins, a, b in ((fs, h, X - h), (lows, 0, h),
                           (highs, X - h, X)):
            plain = solver.plain(kind, level, wins, [r[a:b] for r in rhos],
                                 {}, {}, pad=(h, 0))
            for o, p in zip(outs, plain):
                assert _rel(o[a:b], p) <= MG_TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("MG", ["FullApproximationScheme",
                                "MultiGridSolver"])
@pytest.mark.parametrize("mesh,overlap", [
    ((2, 1, 1), False), ((2, 1, 1), True), ((2, 2, 1), False),
    ((1, 2, 1), False), ((4, 1, 1), True)],
    ids=["211-padded", "211-overlap", "221", "121", "411-overlap"])
def test_mg_sharded_cycle_equals_single_device(cuda, mesh, overlap, MG):
    """A V-cycle of depth 4 at 32^3 f64 (its 2^3 level replicated, on
    (4, 1, 1) its 4^3 level too) with every shard on the card equals the
    single-device
    cycle: the solution and every L-infinity record bit for bit, the L2
    records within 1e-13 (per-block sums added in rank order); every
    sharded level runs the launch kinds its mesh implies."""
    cls, lhs, omega = _mg_problem("jacobi")
    g = torch.Generator().manual_seed(9)
    arrays = {}
    for name in ("f", "rho", "f2", "rho2"):
        a = torch.rand((32,) * 3, generator=g, dtype=torch.float64)
        arrays[name] = (a - a.mean()).to(cuda)
    cycle = tmg.v_cycle(5, 10, 4)
    ref_errs, ref = getattr(tmg, MG)(
        solver=cls(lhs, omega=omega, device=cuda))(dx0=0.3, cycle=cycle,
                                                   **arrays)
    decomp = pt.DomainDecomposition(mesh)
    mg = getattr(tmg, MG)(solver=cls(lhs, omega=omega, decomp=decomp,
                                     overlap=overlap))
    trelax.reset_launch_counts()
    errs, sol = mg(dx0=0.3, cycle=cycle, **arrays)
    torch.cuda.synchronize()
    for n in ref:
        assert torch.equal(decomp.unshard(sol[n]), ref[n])
    for (lg, got), (lr, want) in zip(errs, ref_errs):
        assert lg == lr
        for n in want:
            assert got[n][0] == want[n][0]
            assert abs(got[n][1] - want[n][1]) <= 1e-13 * want[n][1]
    tiers = {r["tier"] for r in mg.kernel_tier_report((32,) * 3, 0.3, 4)
             if r["sharded"]}
    kinds = {k.split(":")[1] for k, v in trelax.LAUNCHES.items()
             if v and ":" in k}
    assert kinds == {k for t in tiers for k in t[7:].split("+")}


@pytest.mark.cuda
@pytest.mark.parametrize("mesh,overlap", [
    ((2, 1, 1), False), ((2, 1, 1), True), ((2, 2, 1), False)],
    ids=["211-padded", "211-overlap", "221"])
def test_mg_sharded_cycle_across_cards(cuda, mesh, overlap):
    """With rank r on card r % n (the decomposition's default), each
    block's sweeps run on its own card: a FAS V-cycle at 32^3 f64 equals
    the single-card cycle bit for bit."""
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two or more cards")
    cls, lhs, omega = _mg_problem("jacobi")
    g = torch.Generator().manual_seed(9)
    arrays = {}
    for name in ("f", "rho", "f2", "rho2"):
        a = torch.rand((32,) * 3, generator=g, dtype=torch.float64)
        arrays[name] = (a - a.mean()).to(cuda)
    cycle = tmg.v_cycle(5, 10, 4)
    _, ref = tmg.FullApproximationScheme(
        solver=cls(lhs, omega=omega, device=cuda))(dx0=0.3, cycle=cycle,
                                                   **arrays)
    decomp = pt.DomainDecomposition(mesh)
    assert len({b.device for b in decomp.zeros(
        (32,) * 3, torch.float64).blocks}) == min(n, decomp.nshards)
    _, sol = tmg.FullApproximationScheme(solver=cls(
        lhs, omega=omega, decomp=decomp, overlap=overlap))(
        dx0=0.3, cycle=cycle, **arrays)
    for dev in range(n):
        torch.cuda.synchronize(dev)
    for name in ref:
        assert torch.equal(decomp.unshard(sol[name], cuda), ref[name])


# -- bfloat16 carries on the energy and GW kernels (K5, K6, K7, K8, K9, K5') --

#: (kernel, velocity carries in the working type): every bf16 entry point
#: of the energy-coupled and GW kernels; the energy stages also in their
#: _bf16_fin variant, which the coupled driver runs after a finalize
BF16_CASES = [(k, False) for k in ("fused_stage_energy", "coupled_pair",
                                   "coupled_pair_deferred") + GW_KERNELS] + [
    ("fused_stage_energy", True), ("preheat_stage_energy", True)]


def _bf16_case(cuda, kernel, fin, grid, dtype, seed=0,
               carry_dtype=torch.bfloat16):
    """A bf16-carry stepper of the bench model (the GW one for a GW
    kernel), the kernel's inputs at bench-like amplitudes (carries in
    bf16; with ``fin`` the velocity carries in the working type) and its
    scalars; with ``carry_dtype=None`` the same with carries in the working
    type."""
    sector = pt.ScalarSector(2, potential=bench_potential)
    kw = dict(dtype=dtype, carry_dtype=carry_dtype, device=cuda)
    if kernel in GW_KERNELS:
        st = pt.FusedPreheatStepper(sector, pt.TensorPerturbationSector(
            [sector]), grid, 5.0 / grid[0], H, **kw)
        params = _gw_params(kernel, 5.0 / grid[0])
    else:
        st = pt.FusedScalarStepper(sector, grid, 5.0 / grid[0], H, **kw)
        params = _gw_params(kernel, 5.0 / grid[0])
    g = torch.Generator(device=cuda).manual_seed(seed)
    amps = (1e-3, 1e-4, 1e-5, 1e-3, 1e-3, 1e-4, 1e-5, 1e-4)
    ins = [(a * torch.randn((c,) + grid, generator=g, device=cuda,
                            dtype=dtype)).to(d)
           for a, c, d in zip(amps, st._comps, st._in_dtypes(fin))]
    return st, ins, params


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("kernel,fin", BF16_CASES)
def test_bf16_kernel_matches_plain(cuda, kernel, fin, dtype):
    """Each bf16 variant of K5, K6, K7, K8, K9 and K5' (and the _bf16_fin
    energy stages) vs its plain version at 16^3: every lattice output at
    KERNEL_TOL of the working type (the bf16 carries compared as values),
    the sums at SUM_TOL of sum |term|; the launch is counted under
    ``<name>:bf16`` (``<name>:bf16_fin``); the storage dtypes are the
    stepper's."""
    st, ins, params = _bf16_case(cuda, kernel, fin, (16, 16, 16), dtype)
    assert st._finalized(kernel, ins) == fin
    n = len(ins)
    plain = st.plain(kernel, ins, params)
    key = st.counted_name(kernel, fin)
    assert key == kernel + tfused.BF16 + (tfused.FIN if fin else "")
    before = tfused.LAUNCHES[key]
    outs = st.launch(kernel, ins, st._new_set(cuda), params)
    torch.cuda.synchronize()
    assert tfused.LAUNCHES[key] == before + 1
    assert len(outs) == len(plain) == n + tfused.SUM_SETS[kernel]
    for o, p, d in zip(outs[:n], plain[:n], st._dtypes):
        assert o.dtype == p.dtype == d
        assert _rel(o, p) <= KERNEL_TOL[dtype]
    if not tfused.SUM_SETS[kernel]:
        return
    scalar = tfused._GW_OF.get(kernel, kernel)
    wide = [t.to(dtype) for t in ins]
    scales = sum_scales(st, scalar, wide, [t.to(dtype) for t in outs[:n]]
                        + outs[n:], params)
    for got, ref, scale in zip(outs[n:], plain[n:], scales):
        err = ((got.double() - ref.double()).abs() / scale).max().item()
        assert err <= SUM_TOL[dtype], err


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("grid", [(48, 40, 36)] + MARCH_GRIDS,
                         ids=["48x40x36"] + MARCH_IDS)
@pytest.mark.parametrize("gw", [False, True], ids=["scalar", "gw"])
def test_bf16_kernel_identities(cuda, gw, grid, dtype):
    """With bf16 carries on the card: the energy stage's lattice outputs
    are the stage's bit for bit (K5 == K2, K5' == K7), its sums bit-equal
    on a second launch; the pair across a step boundary (stages 4 and 0,
    A[0] == 0) equals two single stages bit for bit (K3, K8)."""
    energy = "preheat_stage_energy" if gw else "fused_stage_energy"
    st, ins, params = _bf16_case(cuda, energy, False, grid, dtype, 2)
    kn = st._KERNEL
    one = st.launch(kn["stage_energy"], ins, st._new_set(cuda), params)
    two = st.launch(kn["stage_energy"], ins, st._new_set(cuda), params)
    stage = st.launch(kn["stage"], ins, st._new_set(cuda), params)
    dt = params[0]
    pair = st.launch(kn["pair"], ins, st._new_set(cuda),
                     (dt, 1.0, 0.5, A[4], B[4], 1.01, 0.49, A[0], B[0]))
    mid = st.launch(kn["stage"], ins, st._new_set(cuda),
                    (dt, 1.0, 0.5, A[4], B[4]))
    two_stages = st.launch(kn["stage"], mid, st._new_set(cuda),
                           (dt, 1.01, 0.49, A[0], B[0]))
    torch.cuda.synchronize()
    for a, b in zip(one, two):
        assert torch.equal(a, b)
    for a, b in zip(one, stage):
        assert torch.equal(a, b)
    for a, b in zip(pair, two_stages):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("gw", [False, True], ids=["scalar", "gw"])
def test_bf16_coupled_card_matches_cpu(cuda, gw):
    """coupled_multi_step with bf16 carries on the card (K6 / K9, the
    finalize, K5 / K5' _bf16_fin) vs the plain versions on the CPU, 16^3
    f32, three steps: within 1e-5 (an ulp where PyTorch divides by the
    reciprocal can flip a carry's bf16 rounding: one bf16 ulp of a carry,
    scaled by B*dt), a and adot within 1e-6."""
    grid = (16, 16, 16)
    sector = pt.ScalarSector(2, potential=bench_potential)
    g = torch.Generator().manual_seed(4)
    state = {"f": torch.tensor([0.193, 0.0])[:, None, None, None]
             + 1e-5 * torch.randn((2,) + grid, generator=g),
             "dfdt": torch.tensor([-0.142231, 0.0])[:, None, None, None]
             + 1e-5 * torch.randn((2,) + grid, generator=g)}
    if gw:
        state["hij"] = 1e-6 * torch.randn((6,) + grid, generator=g)
        state["dhijdt"] = 1e-7 * torch.randn((6,) + grid, generator=g)
    res = {}
    for dev in ("cpu", cuda):
        kw = dict(dtype=torch.float32, carry_dtype=torch.bfloat16,
                  device=dev)
        st = (pt.FusedPreheatStepper(sector, pt.TensorPerturbationSector(
            [sector]), grid, 5.0 / 16, H, **kw) if gw else
            pt.FusedScalarStepper(sector, grid, 5.0 / 16, H, **kw))
        exp = pt.Expansion(0.03, pt.LowStorageRK54)
        out = st.coupled_multi_step({k: v.to(dev) for k, v in
                                     state.items()}, 3, exp, 0.0,
                                    0.1 * 5.0 / 16)
        res[str(dev)] = ({k: v.cpu() for k, v in out.items()}, exp)
    (ref, e_ref), (got, e_got) = res["cpu"], res[str(cuda)]
    for name in ref:
        assert _rel(got[name], ref[name]) <= 1e-5, name
    assert abs(e_got.a - e_ref.a) / e_ref.a <= 1e-6
    assert abs(e_got.adot - e_ref.adot) / abs(e_ref.adot) <= 1e-6


def nonpoly_potential(f):
    # every non-polynomial path of the printer: exp, tanh, sin and cos (V
    # and dV/df), sqrt, powers 2.5 (and 1.5), -2 (and -3), quotients
    return (0.1 * pt.exp(0.3 * f[0]) + 0.2 * pt.tanh(f[1]) * pt.cos(f[0])
            + 0.05 * pt.sqrt(1 + f[0] ** 2) + 0.01 * (2 + f[1] ** 2) ** 2.5
            + 0.02 * (1.5 + f[0] ** 2) ** -2 + f[0] * f[1] / (3 + f[0] ** 2))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("kernel", ["fused_stage", "fused_pair",
                                    "fused_stage_energy"])
def test_nonpoly_kernel_matches_plain(cuda, kernel, dtype):
    """K2, K3 and K5 with a non-polynomial potential (pk_exp, pk_tanh,
    pk_sin, pk_cos, pk_sqrt, pk_pow in the printed dV/df and V) vs their
    plain versions at 16^3, O(1) fields: KERNEL_TOL (CUDA's math functions
    and PyTorch's may differ by an ulp or two in dV/df, which enters the
    outputs scaled by dt a^2)."""
    grid = (16, 16, 16)
    st = pt.FusedScalarStepper(pt.ScalarSector(2, potential=nonpoly_potential),
                               grid, 5.0 / 16, H, dtype=dtype, device=cuda)
    assert "pk_pow" in st.kernel_header() and "pk_exp" in st.kernel_header()
    g = torch.Generator(device=cuda).manual_seed(9)
    ins = [a * torch.randn((2,) + grid, generator=g, device=cuda,
                           dtype=dtype) for a in (0.8, 0.3, 0.01, 0.02)]
    params = _params("fused_stage_energy", 5.0 / 16)
    if kernel == "fused_pair":
        params += (1.0, 0.5, A[2], B[2])
    plain = st.plain(kernel, ins, params)
    outs = st.launch(kernel, ins, st._new_set(cuda), params)
    torch.cuda.synchronize()
    for o, p in zip(outs[:4], plain[:4]):
        assert _rel(o, p) <= KERNEL_TOL[dtype]
    if kernel == "fused_stage_energy":
        scale = term_scale(st, ins[0], ins[1], params[1], params[2])
        err = ((outs[4].double() - plain[4].double()).abs() / scale).max()
        assert err.item() <= SUM_TOL[dtype]


# -- the sharded tier: padded, interior and shell launches ------------------

#: the sharded tier's kernels: the fused stage and pair, and the operators
SHARDED_KERNELS = ["fused_stage", "fused_pair"] + list(tderivs.OPS)
SHARDED_GRIDS = [(16, 16, 16), (48, 40, 36), (256, 256, 256)]
SHARDED_IDS = ["16cubed", "48x40x36", "256cubed"]


def _pad_periodic(t, hx, hy):
    """A (..., X, Y, Z) tensor padded by its own periodic rows: what a
    sharded window holds when one block is the whole lattice."""
    ax = t.ndim - 3
    if hx:
        t = torch.cat([t.narrow(ax, t.shape[ax] - hx, hx), t,
                       t.narrow(ax, 0, hx)], ax)
    if hy:
        t = torch.cat([t.narrow(ax + 1, t.shape[ax + 1] - hy, hy), t,
                       t.narrow(ax + 1, 0, hy)], ax + 1)
    return t.contiguous()


class _Sharded:
    """One kernel of the sharded tier on a lattice ``grid`` held whole: its
    unsharded launch, and the padded, interior or shell launch on windows
    padded by hand (``run``), with the plain version of the same."""

    def __init__(self, kernel, grid, dtype, device):
        self.kernel, self.grid, self.dtype = kernel, grid, dtype
        g = torch.Generator(device=device).manual_seed(5)
        if kernel in tderivs.OPS:
            self.st = pt.FiniteDifferencer(H, (0.3, 0.25, 0.2), device=device)
            self.x = torch.randn((6,) + grid, generator=g, device=device,
                                 dtype=dtype)
            self.wins = (0,)
        else:
            self.st = pt.FusedScalarStepper(
                pt.ScalarSector(2, potential=bench_potential), grid,
                5.0 / grid[0], H, dtype=dtype, device=device)
            self.x = [a * torch.randn((2,) + grid, generator=g,
                                      device=device, dtype=dtype)
                      for a in (1e-3, 1e-4, 1e-5, 1e-3)]
            self.params = (0.1 * 5.0 / grid[0], 1.0, 0.5, A[1], B[1])
            if kernel == "fused_pair":
                self.params += (1.0, 0.5, A[2], B[2])
            self.wins = tfused._WINDOWS[kernel]

    def outs(self):
        if self.kernel in tderivs.OPS:
            C = self.x.shape[0]
            return [torch.empty(s, dtype=self.dtype, device=self.x.device)
                    for s in self.st._out_shapes(self.kernel, C, self.grid)]
        return [torch.empty_like(t) for t in self.x]

    def unsharded(self):
        if self.kernel in tderivs.OPS:
            return self.st.launch(self.kernel, self.x)
        return self.st.launch(self.kernel, self.x, self.outs(), self.params)

    def windows(self, fn):
        """The inputs with ``fn`` applied to the windows."""
        if self.kernel in tderivs.OPS:
            return fn(self.x)
        return [fn(t) if j in self.wins else t
                for j, t in enumerate(self.x)]

    def run(self, kind, ins, outs, x0=0):
        if self.kernel in tderivs.OPS:
            return self.st.launch_block(self.kernel, kind, ins, outs, x0)
        return self.st.launch_block(self.kernel, kind, ins, outs,
                                    self.params, x0)

    def plain(self, ins, pad):
        if self.kernel in tderivs.OPS:
            return self.st.plain(self.kernel, ins, pad=pad)
        return self.st.plain(self.kernel, ins, self.params, pad=pad)

    def counted(self, kind):
        name = (f"fd_{self.kernel}" if self.kernel in tderivs.OPS
                else self.kernel)
        launches = (tderivs.LAUNCHES if self.kernel in tderivs.OPS
                    else tfused.LAUNCHES)
        return launches[f"{name}:{kind}"]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("grid", SHARDED_GRIDS, ids=SHARDED_IDS)
@pytest.mark.parametrize("kind", ["xpad", "ypad", "xypad"])
@pytest.mark.parametrize("kernel", SHARDED_KERNELS)
def test_padded_kernel_matches_plain_and_unpadded(cuda, kernel, kind, grid,
                                                  dtype):
    """A padded launch on a window padded by hand with the lattice's own
    periodic rows: equal to its plain version, and bit for bit to the
    unsharded kernel on the whole lattice (a sharded update checked
    without any exchange); the launch is counted under its kind."""
    case = _Sharded(kernel, grid, dtype, cuda)
    bits = tderivs.PAD_KINDS[kind]
    pad = (H if bits & 1 else 0, H if bits & 2 else 0)
    ins = case.windows(lambda t: _pad_periodic(t, *pad))
    before = case.counted(kind)
    outs = case.run(kind, ins, case.outs())
    torch.cuda.synchronize()
    assert case.counted(kind) == before + 1
    ref = case.unsharded()
    plain = case.plain(ins, pad)
    for o, r, p in zip(outs, ref, plain):
        assert torch.equal(o, r)
        assert (o - p).abs().max() <= FD_TOL[dtype] * p.abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("grid", SHARDED_GRIDS, ids=SHARDED_IDS)
@pytest.mark.parametrize("kernel", SHARDED_KERNELS)
def test_interior_and_shells_equal_padded_launch(cuda, kernel, grid, dtype):
    """An interior launch on the raw block and two x-shell launches on
    ``concat(halo, 2h rows)`` write the same output block as one x-padded
    launch, bit for bit, each launch counted under its kind."""
    case = _Sharded(kernel, grid, dtype, cuda)
    X, h = grid[0], H
    padded = case.windows(lambda t: _pad_periodic(t, h, 0))
    ref = case.run("xpad", padded, case.outs())
    ax = 1
    lows = case.windows(lambda t: _pad_periodic(t, h, 0).narrow(
        ax, 0, 3 * h).contiguous())
    highs = case.windows(lambda t: _pad_periodic(t, h, 0).narrow(
        ax, X - h, 3 * h).contiguous())
    n_int, n_shell = case.counted("interior"), case.counted("shell")
    outs = case.outs()
    case.run("interior", case.x, outs, x0=h)
    case.run("shell", lows, outs, x0=0)
    case.run("shell", highs, outs, x0=X - h)
    torch.cuda.synchronize()
    assert case.counted("interior") == n_int + 1
    assert case.counted("shell") == n_shell + 2
    for o, r in zip(outs, ref):
        assert torch.equal(o, r)


@pytest.mark.cuda
@pytest.mark.parametrize("mesh,overlap", [((2, 1, 1), False),
                                          ((2, 1, 1), True),
                                          ((2, 2, 1), False),
                                          ((1, 2, 1), False),
                                          ((4, 1, 1), True)],
                         ids=["211-padded", "211-overlap", "221", "121",
                              "411-overlap"])
def test_sharded_multi_step_on_card(cuda, mesh, overlap):
    """multi_step(3) on shards that share the card equals the unsharded
    multi_step bit for bit, through the launches its mesh implies."""
    grid, dtype = (48, 40, 36), torch.float64
    sector = pt.ScalarSector(2, potential=bench_potential)
    g = torch.Generator(device=cuda).manual_seed(2)
    state = {k: 1e-3 * torch.randn((2,) + grid, generator=g, device=cuda,
                                   dtype=dtype) for k in ("f", "dfdt")}
    args = {"a": 1.0, "hubble": 0.5}
    ref = pt.FusedScalarStepper(sector, grid, 0.1, H, dtype=dtype,
                                device=cuda).multi_step(
        _copy(state), 3, 0.0, 0.01, args)
    decomp = pt.DomainDecomposition(mesh)
    st = pt.FusedScalarStepper(sector, grid, 0.1, H, dtype=dtype,
                               decomp=decomp, overlap=overlap)
    tfused.reset_launch_counts()
    out = st.multi_step({k: decomp.shard(v) for k, v in state.items()}, 3,
                        0.0, 0.01, args)
    torch.cuda.synchronize()
    # RK54 over 3 steps: 7 pairs across step boundaries, then one stage
    want = {f"{name}:{kind}": n * m * decomp.nshards
            for name, n in (("fused_pair", 7), ("fused_stage", 1))
            for kind, m in st.sharded_kinds().items()}
    assert {k: v for k, v in tfused.LAUNCHES.items() if v} == want
    for k in ref:
        assert torch.equal(torch.from_numpy(decomp.gather_array(out[k])),
                           ref[k].cpu()), k


@pytest.mark.cuda
@pytest.mark.parametrize("mesh,overlap", [((2, 1, 1), False),
                                          ((2, 1, 1), True),
                                          ((2, 2, 1), False),
                                          ((1, 2, 1), False)],
                         ids=["211-padded", "211-overlap", "221", "121"])
def test_sharded_operators_on_card(cuda, mesh, overlap):
    """Every operator on shards that share the card equals the unsharded
    operator bit for bit, launched as its mesh implies."""
    grid = (48, 40, 36)
    g = torch.Generator(device=cuda).manual_seed(4)
    x = torch.randn((2,) + grid, generator=g, device=cuda,
                    dtype=torch.float64)
    v = torch.randn((2, 3) + grid, generator=g, device=cuda,
                    dtype=torch.float64)
    fd = pt.FiniteDifferencer(H, (0.3, 0.25, 0.2))
    decomp = pt.DomainDecomposition(mesh)
    sfd = pt.FiniteDifferencer(H, (0.3, 0.25, 0.2), decomp=decomp,
                               overlap=overlap)
    xs, vs = decomp.shard(x), decomp.shard(v)
    tderivs.reset_launch_counts()
    for op in ("lap", "grad", "pdx", "pdy", "pdz", "divergence"):
        arg, sarg = (v, vs) if op == "divergence" else (x, xs)
        got = getattr(sfd, op)(sarg)
        assert torch.equal(torch.from_numpy(decomp.gather_array(got)),
                           getattr(fd, op)(arg).cpu()), op
    kinds = ({"interior": 1, "shell": 2} if overlap else
             {{(2, 1, 1): "xpad", (2, 2, 1): "xypad",
               (1, 2, 1): "ypad"}[mesh]: 1})
    for op in ("lap", "grad", "pdx", "pdy", "pdz", "div"):
        for kind, m in kinds.items():
            assert tderivs.LAUNCHES[f"fd_{op}:{kind}"] == \
                m * decomp.nshards, (op, kind)


# -- the sharded tier of the energy-coupled and GW kernels -------------------

#: the kernels with a sharded tier since the sharded coupled driver and GW
#: stepper: padded launches of all, interior and shell ones of K7 and K8
NEW_SHARDED = ["fused_stage_energy", "coupled_pair", "coupled_pair_deferred",
               "preheat_stage", "preheat_pair", "preheat_stage_energy",
               "preheat_coupled_pair", "preheat_coupled_pair_deferred"]


def _new_sharded_case(cuda, kernel, grid, dtype, seed=0):
    """A stepper, the inputs and the scalars of one of NEW_SHARDED."""
    if kernel.startswith("preheat"):
        return _preheat_case(cuda, kernel, grid, dtype, seed)
    return _energy_case(cuda, kernel, grid, dtype, seed)


def _sum_errs(st, kernel, ins, outs, plain, params):
    """Each sum vector's largest gap to the plain version's, relative to
    sum |term|."""
    n = len(ins)
    scales = sum_scales(st, tfused._GW_OF.get(kernel, kernel), ins, outs,
                        params)
    return [((o.double() - p.double()).abs() / s).max().item()
            for o, p, s in zip(outs[n:], plain[n:], scales)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("grid", [(16, 16, 16), (48, 40, 36)]
                         + MARCH_GRIDS[:2],
                         ids=["16cubed", "48x40x36"] + MARCH_IDS[:2])
@pytest.mark.parametrize("kind", ["xpad", "ypad", "xypad"])
@pytest.mark.parametrize("kernel", NEW_SHARDED)
def test_new_padded_kernel_matches_plain_and_unpadded(cuda, kernel, kind,
                                                      grid, dtype):
    """A padded launch of the coupled and GW kernels on windows padded by
    hand with the lattice's own periodic rows: its lattice outputs equal
    the unsharded kernel's bit for bit and the plain version's at
    KERNEL_TOL; a sum kernel's own sums (its partials at the block's own
    places, then the second launch) equal the unsharded launch's bit for
    bit and the plain version's at SUM_TOL; the launch is counted."""
    st, ins, params = _new_sharded_case(cuda, kernel, grid, dtype)
    wins = tfused._WINDOWS[kernel]
    bits = tderivs.PAD_KINDS[kind]
    pad = (H if bits & 1 else 0, H if bits & 2 else 0)
    padded = [_pad_periodic(t, *pad) if j in wins else t
              for j, t in enumerate(ins)]
    before = tfused.LAUNCHES[f"{kernel}:{kind}"]
    outs = st.launch_block(kernel, kind, padded,
                           [torch.empty_like(t) for t in ins], params)
    ref = st.launch(kernel, ins, [torch.empty_like(t) for t in ins], params)
    torch.cuda.synchronize()
    assert tfused.LAUNCHES[f"{kernel}:{kind}"] == before + 1
    assert len(outs) == len(ref)
    for o, r in zip(outs, ref):
        assert torch.equal(o, r)
    plain = st.plain(kernel, padded, params, pad=pad)
    n = len(ins)
    for o, p in zip(outs[:n], plain[:n]):
        assert _rel(o, p) <= KERNEL_TOL[dtype]
    if tfused.SUM_SETS[kernel]:
        assert max(_sum_errs(st, kernel, ins, outs, plain, params)) \
            <= SUM_TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("grid", [(16, 16, 16), (48, 40, 36)]
                         + MARCH_GRIDS[:2],
                         ids=["16cubed", "48x40x36"] + MARCH_IDS[:2])
@pytest.mark.parametrize("kernel", ["preheat_stage", "preheat_pair"])
def test_gw_interior_and_shells_equal_padded_launch(cuda, kernel, grid,
                                                    dtype):
    """K7 and K8: an interior launch on the raw block and two x-shell
    launches on ``concat(halo, 2h rows)`` write the output block of one
    x-padded launch bit for bit, each counted under its kind; a sum kernel
    has no such launch."""
    st, ins, params = _new_sharded_case(cuda, kernel, grid, dtype)
    wins, X, h = tfused._WINDOWS[kernel], grid[0], H

    def windows(fn):
        return [fn(t) if j in wins else t for j, t in enumerate(ins)]
    ref = st.launch_block(kernel, "xpad",
                          windows(lambda t: _pad_periodic(t, h, 0)),
                          [torch.empty_like(t) for t in ins], params)
    lows = windows(lambda t: _pad_periodic(t, h, 0)[:, :3 * h].contiguous())
    highs = windows(lambda t: _pad_periodic(t, h, 0)[
        :, X - h:X + 2 * h].contiguous())
    n_int = tfused.LAUNCHES[f"{kernel}:interior"]
    n_shell = tfused.LAUNCHES[f"{kernel}:shell"]
    outs = [torch.empty_like(t) for t in ins]
    st.launch_block(kernel, "interior", ins, outs, params, x0=h)
    st.launch_block(kernel, "shell", lows, outs, params, x0=0)
    st.launch_block(kernel, "shell", highs, outs, params, x0=X - h)
    torch.cuda.synchronize()
    assert tfused.LAUNCHES[f"{kernel}:interior"] == n_int + 1
    assert tfused.LAUNCHES[f"{kernel}:shell"] == n_shell + 2
    for o, r in zip(outs, ref):
        assert torch.equal(o, r)
    with pytest.raises(ValueError, match="no interior launch"):
        st.launch_block("preheat_stage_energy", "interior", ins, outs,
                        _gw_params("preheat_stage_energy", 5.0 / X), x0=h)


@pytest.mark.cuda
@pytest.mark.parametrize("grid", [(32, 48, 36), (70, 16, 40)],
                         ids=["32x48x36", "70x16x40"])
@pytest.mark.parametrize("mesh", [(2, 1, 1), (2, 2, 1), (1, 2, 1)],
                         ids=["211", "221", "121"])
@pytest.mark.parametrize("kernel", ["fused_stage_energy", "coupled_pair",
                                    "coupled_pair_deferred",
                                    "preheat_stage_energy",
                                    "preheat_coupled_pair",
                                    "preheat_coupled_pair_deferred"])
def test_sharded_sums_equal_unsharded(cuda, kernel, mesh, grid):
    """A sum kernel on shards that share the card: every block's partials
    at their places in the whole lattice's launch and one second launch
    give the unsharded launch's sums bit for bit (local Y = 24 or 8, a
    multiple of the kernel block's 8 rows; at 70x16x40 a block's 35 or 70
    x rows are no multiple of the x-march's run), and its lattice outputs;
    the stepper says so (sum_order)."""
    _sharded_sums_case(cuda, kernel, mesh, grid)


@pytest.mark.cuda
@pytest.mark.parametrize("grid", [(70, 12, 40), (10, 9, 33)],
                         ids=["70x12x40", "10x9x33"])
@pytest.mark.parametrize("kernel", ["fused_stage_energy", "coupled_pair",
                                    "coupled_pair_deferred",
                                    "preheat_coupled_pair",
                                    "preheat_coupled_pair_deferred"])
def test_sharded_sums_equal_unsharded_march_shapes(cuda, kernel, grid):
    """The same on (2, 1, 1) at the x-march's edge shapes: blocks of
    35x12x40 and 5x9x33 (runs cut short, y tiles hanging past Y, which is
    unsharded): the sums and lattice outputs of the pairs and of K5 equal
    the unsharded launch's bit for bit."""
    _sharded_sums_case(cuda, kernel, (2, 1, 1), grid)


def _sharded_sums_case(cuda, kernel, mesh, grid):
    dtype = torch.float64
    st, ins, params = _new_sharded_case(cuda, kernel, grid, dtype, 3)
    ref = st.launch(kernel, ins, [torch.empty_like(t) for t in ins], params)
    decomp = pt.DomainDecomposition(mesh)
    if kernel.startswith("preheat"):
        sector = pt.ScalarSector(2, potential=bench_potential)
        sh = pt.FusedPreheatStepper(sector, pt.TensorPerturbationSector(
            [sector]), grid, 5.0 / grid[0], H, dtype=dtype, decomp=decomp)
    else:
        sh = pt.FusedScalarStepper(pt.ScalarSector(
            2, potential=bench_potential), grid, 5.0 / grid[0], H,
            dtype=dtype, decomp=decomp)
    assert sh.sum_order() == "single-device"
    got = sh.launch(kernel, [decomp.shard(t) for t in ins],
                    sh._new_set("sharded"), params)
    torch.cuda.synchronize()
    n = len(ins)
    for g, r in zip(got[:n], ref[:n]):
        assert torch.equal(torch.from_numpy(decomp.gather_array(g)), r.cpu())
    assert len(got) == len(ref)
    for g, r in zip(got[n:], ref[n:]):
        assert torch.equal(g, r)


@pytest.mark.cuda
@pytest.mark.parametrize("pair", [True, False], ids=["pair", "single"])
@pytest.mark.parametrize("gw", [False, True], ids=["scalar", "gw"])
@pytest.mark.parametrize("mesh", [(2, 1, 1), (2, 2, 1), (4, 1, 1)],
                         ids=["211", "221", "411"])
def test_sharded_coupled_on_card(cuda, mesh, gw, pair):
    """coupled_multi_step(1) (two pairs, the finalize and the odd tail, or
    five energy stages) on shards that share the card equals the unsharded
    chunk bit for bit, a and adot included, through the padded launches of
    the sum kernels (every block's y extent, 48 or 24, a multiple of 8)."""
    _sharded_coupled_case(cuda, mesh, gw, pair, (48, 48, 36), exact=True)


@pytest.mark.cuda
@pytest.mark.parametrize("gw", [False, True], ids=["scalar", "gw"])
def test_sharded_coupled_rank_order_on_card(cuda, gw):
    """On (2, 2, 1) with blocks 20 rows wide along y (not a multiple of the
    kernel block's 8), each block finishes its own sums and they add in
    rank order: the chunk agrees with the unsharded one to 1e-13, as the
    JAX package's psum does."""
    _sharded_coupled_case(cuda, (2, 2, 1), gw, True, (48, 40, 36),
                          exact=False)


def _sharded_coupled_case(cuda, mesh, gw, pair, grid, exact):
    dtype = torch.float64
    sector = pt.ScalarSector(2, potential=bench_potential)
    g = torch.Generator(device=cuda).manual_seed(6)
    names = ("f", "dfdt") + (("hij", "dhijdt") if gw else ())
    state = {k: 1e-3 * torch.randn(((6 if k in ("hij", "dhijdt") else 2),)
                                   + grid, generator=g, device=cuda,
                                   dtype=dtype) for k in names}
    state["f"] += 0.2

    def make(**kw):
        if gw:
            return pt.FusedPreheatStepper(sector, pt.TensorPerturbationSector(
                [sector]), grid, 0.1, H, dtype=dtype, **kw)
        return pt.FusedScalarStepper(sector, grid, 0.1, H, dtype=dtype, **kw)
    e1 = pt.Expansion(1.0, pt.LowStorageRK54)
    ref = make(device=cuda).coupled_multi_step(_copy(state), 1, e1, 0.0,
                                               0.01, pair=pair)
    decomp = pt.DomainDecomposition(mesh)
    st = make(decomp=decomp, overlap=True)
    e2 = pt.Expansion(1.0, pt.LowStorageRK54)
    tfused.reset_launch_counts()
    out = st.coupled_multi_step({k: decomp.shard(v) for k, v in
                                 state.items()}, 1, e2, 0.0, 0.01, pair=pair)
    torch.cuda.synchronize()
    (kind,) = st.sharded_kinds(st._KERNEL["stage_energy"])
    counted = {k for k, v in tfused.LAUNCHES.items() if v}
    assert counted and all(k.endswith(f":{kind}") for k in counted)
    assert st.sum_order() == ("single-device" if exact else "rank")
    for k in ref:
        got = torch.from_numpy(decomp.gather_array(out[k]))
        if exact:
            assert torch.equal(got, ref[k].cpu()), k
        else:
            assert _rel(got, ref[k]) < 1e-13, k
    if exact:
        assert (e2.a, e2.adot) == (e1.a, e1.adot)
    else:
        assert abs(e2.a - e1.a) / e1.a < 1e-13
        assert abs(e2.adot - e1.adot) / abs(e1.adot) < 1e-13


# -- the sharded tier with bf16 carries --------------------------------------

#: every bf16 entry point of the sharded tier: (kernel, velocity carries in
#: the working type); each in its three paddings and in f32 and f64
BF16_SHARDED = [(k, False) for k in tfused._WINDOWS] + [
    (k, True) for k in tfused._FINALIZED]
BF16_SHARDED_IDS = [k + ("-fin" if fin else "") for k, fin in BF16_SHARDED]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("grid", [(48, 40, 36)] + MARCH_GRIDS[:2],
                         ids=["48x40x36"] + MARCH_IDS[:2])
@pytest.mark.parametrize("kind", ["xpad", "ypad", "xypad"])
@pytest.mark.parametrize("kernel,fin", BF16_SHARDED, ids=BF16_SHARDED_IDS)
def test_bf16_padded_kernel_matches_plain_and_unpadded(cuda, kernel, fin,
                                                       kind, grid, dtype):
    """A padded bf16 launch (``_bf16_<pad>``, ``_bf16_fin_<pad>``) on
    windows padded by hand with the lattice's own periodic rows (the carry
    windows in bf16): its lattice outputs equal the unpadded
    bf16 kernel's on the whole lattice bit for bit and the plain version's
    at KERNEL_TOL (the bf16 carries compared as values); a sum kernel's own
    sums equal the unpadded launch's and a second launch's bit for bit and
    the plain version's at SUM_TOL; counted under
    ``<name>:bf16[_fin]:<kind>``."""
    st, ins, params = _bf16_case(cuda, kernel, fin, grid, dtype, 1)
    wins = tfused._WINDOWS[kernel]
    bits = tderivs.PAD_KINDS[kind]
    pad = (H if bits & 1 else 0, H if bits & 2 else 0)
    padded = [_pad_periodic(t, *pad) if j in wins else t
              for j, t in enumerate(ins)]
    key = st.counted_name(kernel, fin, kind)
    assert key == f"{kernel}:bf16{'_fin' if fin else ''}:{kind}"
    before = tfused.LAUNCHES[key]
    outs = st.launch_block(kernel, kind, padded, st._new_set(cuda), params)
    again = st.launch_block(kernel, kind, padded, st._new_set(cuda), params)
    ref = st.launch(kernel, ins, st._new_set(cuda), params)
    torch.cuda.synchronize()
    assert tfused.LAUNCHES[key] == before + 2
    assert len(outs) == len(ref) == len(ins) + tfused.SUM_SETS[kernel]
    for o, a, r in zip(outs, again, ref):
        assert torch.equal(o, r) and torch.equal(a, r)
    plain = st.plain(kernel, padded, params, pad=pad)
    n = len(ins)
    for o, p, d in zip(outs[:n], plain[:n], st._dtypes):
        assert o.dtype == p.dtype == d
        assert _rel(o, p) <= KERNEL_TOL[dtype]
    if tfused.SUM_SETS[kernel]:
        wide = [t.to(dtype) for t in ins]
        assert max(_sum_errs(st, kernel, wide, [t.to(dtype) for t in
                                                outs[:n]] + outs[n:],
                             plain, params)) <= SUM_TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("grid", [(48, 40, 36)] + MARCH_GRIDS[:2],
                         ids=["48x40x36"] + MARCH_IDS[:2])
@pytest.mark.parametrize("kernel", ["fused_stage", "fused_pair",
                                    "preheat_stage", "preheat_pair"])
def test_bf16_interior_and_shells_equal_padded_launch(cuda, kernel, grid,
                                                      dtype):
    """K2, K3, K7 and K8 with bf16 carries: an interior launch on the raw
    block and two x-shell launches on ``concat(halo, 2h rows)`` (the kf
    and khij windows in bf16) write the output block of one x-padded bf16
    launch bit for bit, each counted under ``<name>:bf16:<kind>``."""
    st, ins, params = _bf16_case(cuda, kernel, False, grid, dtype, 2)
    wins, X, h = tfused._WINDOWS[kernel], grid[0], H

    def windows(fn):
        return [fn(t) if j in wins else t for j, t in enumerate(ins)]
    ref = st.launch_block(kernel, "xpad",
                          windows(lambda t: _pad_periodic(t, h, 0)),
                          st._new_set(cuda), params)
    lows = windows(lambda t: _pad_periodic(t, h, 0)[:, :3 * h].contiguous())
    highs = windows(lambda t: _pad_periodic(t, h, 0)[
        :, X - h:X + 2 * h].contiguous())
    n_int = tfused.LAUNCHES[f"{kernel}:bf16:interior"]
    n_shell = tfused.LAUNCHES[f"{kernel}:bf16:shell"]
    outs = st._new_set(cuda)
    st.launch_block(kernel, "interior", ins, outs, params, x0=h)
    st.launch_block(kernel, "shell", lows, outs, params, x0=0)
    st.launch_block(kernel, "shell", highs, outs, params, x0=X - h)
    torch.cuda.synchronize()
    assert tfused.LAUNCHES[f"{kernel}:bf16:interior"] == n_int + 1
    assert tfused.LAUNCHES[f"{kernel}:bf16:shell"] == n_shell + 2
    for o, r in zip(outs, ref):
        assert torch.equal(o, r)


@pytest.mark.cuda
@pytest.mark.parametrize("gw", [False, True], ids=["scalar", "gw"])
@pytest.mark.parametrize("mesh,overlap", [((2, 1, 1), False),
                                          ((2, 1, 1), True),
                                          ((2, 2, 1), False),
                                          ((1, 2, 1), False),
                                          ((4, 1, 1), True)],
                         ids=["211-padded", "211-overlap", "221", "121",
                              "411-overlap"])
def test_sharded_bf16_on_card(cuda, mesh, overlap, gw):
    """With bf16 carries on shards that share the card: multi_step(3) and
    coupled_multi_step(1) (two pairs, the finalize, the odd _bf16_fin
    tail) equal the unsharded bf16 runs bit for bit, a and adot included
    (every block's y extent a multiple of 8), each launch counted under
    ``<name>:bf16[_fin]:<kind>``."""
    grid, dtype = (48, 48, 36), torch.float32
    sector = pt.ScalarSector(2, potential=bench_potential)
    g = torch.Generator(device=cuda).manual_seed(7)
    names = ("f", "dfdt") + (("hij", "dhijdt") if gw else ())
    state = {k: 1e-3 * torch.randn(((6 if k in ("hij", "dhijdt") else 2),)
                                   + grid, generator=g, device=cuda,
                                   dtype=dtype) for k in names}
    state["f"] += 0.2

    def make(**kw):
        kw.update(dtype=dtype, carry_dtype=torch.bfloat16)
        if gw:
            return pt.FusedPreheatStepper(sector, pt.TensorPerturbationSector(
                [sector]), grid, 0.1, H, **kw)
        return pt.FusedScalarStepper(sector, grid, 0.1, H, **kw)
    one = make(device=cuda)
    args = {"a": 1.0, "hubble": 0.5}
    ref = _copy(one.multi_step(_copy(state), 3, 0.0, 0.01, args))
    e1 = pt.Expansion(1.0, pt.LowStorageRK54)
    cref = _copy(one.coupled_multi_step(_copy(state), 1, e1, 0.0, 0.01))
    decomp = pt.DomainDecomposition(mesh)
    st = make(decomp=decomp, overlap=overlap)
    assert st.sum_order() == "single-device"
    tfused.reset_launch_counts()
    out = st.multi_step({k: decomp.shard(v) for k, v in state.items()}, 3,
                        0.0, 0.01, args)
    torch.cuda.synchronize()
    kinds = st.sharded_kinds()
    counted = {k for k, v in tfused.LAUNCHES.items() if v}
    assert counted == {st.counted_name(st._KERNEL[r], kind=k)
                       for r in ("pair", "stage") for k in kinds}
    for k in ref:
        assert torch.equal(torch.from_numpy(decomp.gather_array(out[k])),
                           ref[k].cpu()), k
    e2 = pt.Expansion(1.0, pt.LowStorageRK54)
    tfused.reset_launch_counts()
    out = st.coupled_multi_step({k: decomp.shard(v) for k, v in
                                 state.items()}, 1, e2, 0.0, 0.01)
    torch.cuda.synchronize()
    (kind,) = st.sharded_kinds(st._KERNEL["stage_energy"])
    kn = st._KERNEL
    assert {k for k, v in tfused.LAUNCHES.items() if v} == {
        st.counted_name(kn["coupled_pair"], kind=kind),
        st.counted_name(kn["coupled_pair_deferred"], kind=kind),
        st.counted_name(kn["stage_energy"], True, kind)}
    for k in cref:
        assert torch.equal(torch.from_numpy(decomp.gather_array(out[k])),
                           cref[k].cpu()), k
    assert (e2.a, e2.adot) == (e1.a, e1.adot)


# -- the stage marches (K5', K7, K5) and fd_lap against each other and the
#    per-site template -------------------------------------------------------

#: the stage marches at their edges (runs cut short, tiles hanging over Y
#: and Z, 16^3) and on 2^3, where the +-taps wrap onto one site
STAGE_GRIDS = MARCH_GRIDS + [(2, 2, 2)]
STAGE_IDS = MARCH_IDS + ["2cubed"]
#: a model whose f64 f and h arrays at h = 4 leave no room for a tensor
#: component beside every field: the split layout of the K5' and K7 march
#: (ops/fused.py: march_tile with values=1), scalar passes of nine fields
#: and one; K5's ten f arrays do not fit one block either (passes of nine
#: fields and one)
STAGE_SPLIT_F = 10


def _stage_launches(cuda, st, kernel, ins, params, grid, h):
    """``kernel`` on ``ins``: every padded launch on windows padded by hand,
    the interior and two x-shell launches of a kernel without sums, and
    two x blocks' partials of a kernel with sums equal the unpadded launch
    bit for bit; its lattice outputs are at KERNEL_TOL of the plain
    version. Returns the unpadded launch's outputs."""
    n = len(ins)
    one = st.launch(kernel, ins, st._new_set(cuda), params)
    torch.cuda.synchronize()
    plain = st.plain(kernel, ins, params)
    for o, p in zip(one[:n], plain[:n]):
        assert _rel(o, p) <= KERNEL_TOL[st.dtype]
    X, Y, Z = grid
    if min(X, Y) < h:
        return one
    wins = tfused._WINDOWS[kernel]

    def windows(fn):
        return [fn(t) if j in wins else t for j, t in enumerate(ins)]
    for kind, (hx, hy) in (("xpad", (h, 0)), ("ypad", (0, h)),
                           ("xypad", (h, h))):
        padded = st.launch_block(
            kernel, kind, windows(lambda t: _pad_periodic(t, hx, hy)),
            st._new_set(cuda), params)
        torch.cuda.synchronize()
        for a, b in zip(one, padded):
            assert torch.equal(a, b)
    xpad = windows(lambda t: _pad_periodic(t, h, 0))
    outs = st._new_set(cuda)
    if not tfused.SUM_SETS[kernel]:
        if X <= 2 * h:
            return one
        st.launch_block(kernel, "interior", ins, outs, params, x0=h)
        for x0 in (0, X - h):
            st.launch_block(kernel, "shell", [
                t.narrow(1, x0, 3 * h).contiguous() if j in wins else t
                for j, t in enumerate(xpad)], outs, params, x0=x0)
        torch.cuda.synchronize()
        for a, b in zip(outs, one):
            assert torch.equal(a, b)
        return one
    if X % 2:
        return one
    nb = st._num_blocks(X, Y, Z)
    buf = torch.full(((2 * st.F + 1) * nb,), float("nan"), dtype=st.dtype,
                     device=cuda)
    for x0 in (0, X // 2):
        st.launch_block(kernel, "xpad", [
            t.narrow(1, x0, X // 2 + 2 * h).contiguous() if j in wins else t
            for j, t in enumerate(xpad)], outs, params, x0=x0,
            partials=(buf, nb, x0, 0, -(-Y // 8)))
    sums = st._finish_sums(kernel, buf, nb, cuda)
    torch.cuda.synchronize()
    for a, b in zip(outs + sums, one):
        assert torch.equal(a, b)
    return one


def _stage_vs_per_site(cuda, st, sst, ins, params, grid, h):
    """The stage marches on ``ins`` (:func:`_stage_launches` each, every
    padding, K7's and K2's interior and shells, two x blocks' partials of
    K5' and K5), held to each other and to the per-site K2 (the
    ``PK_STAGE_PER_SITE`` build's, :func:`_stage_per_site`, in every
    entry point) bit for bit: K5''s scalar outputs and sums are K5's
    (``sst``'s fused_stage_energy); on carries that are not finalized
    K5''s lattice outputs are K7's, K5's scalar outputs K2's march's, and
    K2's march the per-site K2's."""
    n = len(ins)
    fin = st._finalized("preheat_stage_energy", ins)
    one = _stage_launches(cuda, st, "preheat_stage_energy", ins, params,
                          grid, h)
    k5 = _stage_launches(cuda, sst, "fused_stage_energy", ins[:4], params,
                         grid, h)
    for a, b in zip(one[:4] + one[n:], k5):
        assert torch.equal(a, b)
    if fin:
        return
    k7 = _stage_launches(cuda, st, "preheat_stage", ins, params, grid, h)
    k2 = _stage_launches(cuda, sst, "fused_stage", ins[:4], params, grid, h)
    with _stage_per_site(sst):
        per_site = _stage_launches(cuda, sst, "fused_stage", ins[:4], params,
                                   grid, h)
    for a, b in zip(one[:n], k7):
        assert torch.equal(a, b)
    for a, b in zip(k5[:4], k2):
        assert torch.equal(a, b)
    for a, b in zip(k2, per_site):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("grid", STAGE_GRIDS, ids=STAGE_IDS)
@pytest.mark.parametrize("carry", ["f32", "f64", "f32-bf16", "f64-bf16",
                                   "f32-bf16-fin", "f64-bf16-fin"])
def test_stage_march_equals_per_site(cuda, carry, grid):
    """K5', K7, K5 and K2 (one x-march template) in every entry point --
    carries in the working type, in bf16 and, for K5' and K5, on finalized
    velocity carries (``_bf16_fin``), unpadded, x-, y- and xy-padded, K7's
    and K2's interior and shells, two x blocks -- held to each other and
    to the per-site K2 build bit for bit (:func:`_stage_vs_per_site`) at
    the march's edges and on 2^3."""
    fin = carry.endswith("-fin")
    dtype, carry_dtype = CARRIES[carry[:-4] if fin else carry]
    st, ins, params = _bf16_case(cuda, "preheat_stage_energy", fin, grid,
                                 dtype, 7, carry_dtype)
    sst = pt.FusedScalarStepper(st.sector, grid, 5.0 / grid[0], H,
                                dtype=dtype, carry_dtype=carry_dtype,
                                device=cuda)
    assert st._finalized("preheat_stage_energy", ins) == fin
    _stage_vs_per_site(cuda, st, sst, ins, params, grid, H)


@pytest.mark.cuda
@pytest.mark.parametrize("carry", ["f32", "f64", "f64-bf16"])
def test_stage_march_split_layout_equals_per_site(cuda, carry):
    """Ten fields at h = 4: the K5' and K7 march in f64 takes the split
    layout (scalar passes of nine fields and one, grad f parked for a
    tensor pass of the six components), in f32 the joint one; K5 and K2
    in f64 scalar passes of nine fields and one, in f32 one pass. Each is
    held as :func:`_stage_vs_per_site` holds it."""
    dtype, carry_dtype = CARRIES[carry]
    F, h, grid = STAGE_SPLIT_F, 4, (13, 12, 40)
    sector = pt.ScalarSector(F, potential=many_potential(F))
    kw = dict(dtype=dtype, carry_dtype=carry_dtype, device=cuda)
    st = pt.FusedPreheatStepper(sector, pt.TensorPerturbationSector(
        [sector]), grid, 5.0 / grid[0], h, **kw)
    sst = pt.FusedScalarStepper(sector, grid, 5.0 / grid[0], h, **kw)
    tile = st.march_kernel_tile(dtype, "fused_stage.cu")
    assert tile == tfused.march_tile(F, h, dtype.itemsize, values=1)
    assert tile[0][1:] == ((10, 6, 1) if dtype == torch.float32
                           else (9, 6, 0))
    stile = sst.march_kernel_tile(dtype, "fused_stage.cu")
    assert stile == tfused.march_tile(F, h, dtype.itemsize, nh=0, values=1)
    assert stile[0][1:] == ((10, 0, 1) if dtype == torch.float32
                            else (9, 0, 0))
    g = torch.Generator(device=cuda).manual_seed(8)
    amps = (1e-3, 1e-4, 1e-5, 1e-3, 1e-3, 1e-4, 1e-5, 1e-4)
    ins = [(a * torch.randn((c,) + grid, generator=g, device=cuda,
                            dtype=dtype)).to(d)
           for a, c, d in zip(amps, st._comps, st._in_dtypes(False))]
    _stage_vs_per_site(cuda, st, sst, ins,
                       _gw_params("preheat_stage_energy", 5.0 / grid[0]),
                       grid, h)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("grid", STAGE_GRIDS, ids=STAGE_IDS)
@pytest.mark.parametrize("h", [1, 2, 3, 4])
def test_fd_lap_march_equals_per_site(cuda, h, grid, dtype):
    """fd_lap (the x-march) equals the per-site template's Laplacian (a
    build's whose fd_lap and fd_grad_lap run per site: both) bit for bit,
    unpadded, x-, y- and xy-padded on windows padded by hand, and as an
    interior launch plus two x shells, at the march's edges and on 2^3."""
    fd = pt.FiniteDifferencer(h, (0.3, 0.25, 0.2))
    g = torch.Generator(device=cuda).manual_seed(h)
    x = torch.randn((3,) + grid, generator=g, device=cuda, dtype=dtype)
    lap = fd.launch("lap", x)[0]
    with _fd_per_site(h):
        ref = fd.launch("lap", x)[0]
        ref_gl = fd.launch("grad_lap", x)[1]
    torch.cuda.synchronize()
    assert torch.equal(lap, ref) and torch.equal(lap, ref_gl)
    X, Y, _ = grid
    if min(X, Y) < h:
        return
    for kind, (hx, hy) in (("xpad", (h, 0)), ("ypad", (0, h)),
                           ("xypad", (h, h))):
        out = [torch.full_like(x, float("nan"))]
        fd.launch_block("lap", kind, _pad_periodic(x, hx, hy), out)
        torch.cuda.synchronize()
        assert torch.equal(out[0], lap)
    if X <= 2 * h:
        return
    xpad = _pad_periodic(x, h, 0)
    out = [torch.full_like(x, float("nan"))]
    fd.launch_block("lap", "interior", x, out, x0=h)
    for x0 in (0, X - h):
        fd.launch_block("lap", "shell",
                        xpad.narrow(1, x0, 3 * h).contiguous(), out, x0=x0)
    torch.cuda.synchronize()
    assert torch.equal(out[0], lap)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("grid", STAGE_GRIDS, ids=STAGE_IDS)
@pytest.mark.parametrize("h", [1, 2, 3, 4])
def test_fd_grad_lap_march_equals_per_site(cuda, h, grid, dtype):
    """fd_grad_lap (the x-march) equals the per-site build's fd_grad_lap
    and, output by output, the marching fd_grad's gradient and fd_lap's
    Laplacian bit for bit; unpadded, x-, y- and xy-padded on windows padded
    by hand (the padded fd_grad too), and as an interior launch plus two x
    shells (fd_grad's too), at the march's edges and on 2^3."""
    fd = pt.FiniteDifferencer(h, (0.3, 0.25, 0.2))
    g = torch.Generator(device=cuda).manual_seed(h)
    x = torch.randn((3,) + grid, generator=g, device=cuda, dtype=dtype)
    got = fd.launch("grad_lap", x)
    with _fd_per_site(h):
        ref = fd.launch("grad_lap", x)
    grad, lap = fd.launch("grad", x)[0], fd.launch("lap", x)[0]
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    assert torch.equal(got[0], grad) and torch.equal(got[1], lap)

    def nans():
        return [torch.full_like(o, float("nan")) for o in got]
    X, Y, _ = grid
    if min(X, Y) < h:
        return
    for kind, (hx, hy) in (("xpad", (h, 0)), ("ypad", (0, h)),
                           ("xypad", (h, h))):
        win = _pad_periodic(x, hx, hy)
        out = fd.launch_block("grad_lap", kind, win, nans())
        out_grad = fd.launch_block("grad", kind, win, nans()[:1])
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(out, got))
        assert torch.equal(out_grad[0], got[0])
    if X <= 2 * h:
        return
    xpad = _pad_periodic(x, h, 0)
    out, out_grad = nans(), nans()[:1]
    for op, o in (("grad_lap", out), ("grad", out_grad)):
        fd.launch_block(op, "interior", x, o, x0=h)
        for x0 in (0, X - h):
            fd.launch_block(op, "shell",
                            xpad.narrow(1, x0, 3 * h).contiguous(), o, x0=x0)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(out, got))
    assert torch.equal(out_grad[0], got[0])


#: the fd_grad and fd_div marches at their edges: 16^3, 48x40x36, 8^3,
#: 2^3 (the +-taps wrap onto one site) and 70 x rows (not a multiple of
#: the run length)
FD_MARCH_GRIDS = [(16, 16, 16), (48, 40, 36), (8, 8, 8), (2, 2, 2),
                  (70, 12, 40)]
FD_MARCH_IDS = ["16cubed", "48x40x36", "8cubed", "2cubed", "70x12x40"]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("grid", FD_MARCH_GRIDS, ids=FD_MARCH_IDS)
@pytest.mark.parametrize("h", [1, 2, 3, 4])
@pytest.mark.parametrize("op", ["grad", "div"])
def test_fd_grad_div_march_equals_per_site(cuda, op, h, grid, dtype):
    """fd_grad and fd_div (the x-marches on pk_queue_march, div's three
    arrays of a vector tapped together, each with its own halo) equal the
    per-site build's kernels bit for bit: unpadded, x-, y- and xy-padded on
    windows padded by hand, and as an interior launch plus two x shells;
    each padded launch and the split equal the unpadded one. Two vectors
    (six components) for div, three components for grad."""
    fd = pt.FiniteDifferencer(h, (0.3, 0.25, 0.2))
    g = torch.Generator(device=cuda).manual_seed(20 + h)
    x = torch.randn((6 if op == "div" else 3,) + grid, generator=g,
                    device=cuda, dtype=dtype)
    march = _fd_launches(fd, op, x)
    with _fd_per_site(h):
        per_site = _fd_launches(fd, op, x)
    assert set(march) == set(per_site)
    for key, got in march.items():
        assert torch.equal(got[0], per_site[key][0]), key
        assert torch.equal(got[0], march[None][0]), key


def _fd_launches(fd, op, x):
    """``op`` on ``x`` in every launch of the operator's kernel: unpadded
    (key None), x-, y- and xy-padded on windows padded by hand where a
    neighbour holds h rows, and an interior launch plus two x shells
    (``"split"``) where the block is more than 2h rows long."""
    h = fd.h
    X, Y, _ = x.shape[1:]
    out = {None: fd.launch(op, x)}
    if min(X, Y) >= h:
        for kind, (hx, hy) in (("xpad", (h, 0)), ("ypad", (0, h)),
                               ("xypad", (h, h))):
            out[kind] = fd.launch_block(
                op, kind, _pad_periodic(x, hx, hy),
                [torch.full_like(o, float("nan")) for o in out[None]])
    if X > 2 * h:
        xpad = _pad_periodic(x, h, 0)
        o = [torch.full_like(t, float("nan")) for t in out[None]]
        fd.launch_block(op, "interior", x, o, x0=h)
        for x0 in (0, X - h):
            fd.launch_block(op, "shell",
                            xpad.narrow(1, x0, 3 * h).contiguous(), o,
                            x0=x0)
        out["split"] = o
    torch.cuda.synchronize()
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("grid", FD_MARCH_GRIDS, ids=FD_MARCH_IDS)
@pytest.mark.parametrize("h", [1, 2, 3, 4])
@pytest.mark.parametrize("op", ["pdx", "pdy", "pdz"])
def test_fd_pd_march_equals_per_site(cuda, op, h, grid, dtype):
    """fd_pdx (the x-march on pk_queue_march, one array and no plane
    stored), fd_pdy and fd_pdz (the per-site kernel) of the default build
    equal the per-site build's kernels bit for bit, and fd_grad's matching
    output (the march) on the same input: unpadded, x-, y- and xy-padded
    on windows padded by hand, and as an interior launch plus two x
    shells; each padded launch and the split equal the unpadded one. Three
    components."""
    fd = pt.FiniteDifferencer(h, (0.3, 0.25, 0.2))
    g = torch.Generator(device=cuda).manual_seed(30 + h)
    x = torch.randn((3,) + grid, generator=g, device=cuda, dtype=dtype)
    default = _fd_launches(fd, op, x)
    grad = _fd_launches(fd, "grad", x)
    with _fd_per_site(h):
        per_site = _fd_launches(fd, op, x)
    assert set(per_site) == set(grad) == set(default)
    d = "xyz".index(op[2])
    for key, got in default.items():
        assert torch.equal(got[0], per_site[key][0]), key
        assert torch.equal(got[0], default[None][0]), key
        assert torch.equal(got[0], grad[key][0][:, d]), key


#: K11's march at its edges: runs cut short (70 rows: not a multiple of
#: the run length), tiles hanging over Y and Z, 16^3, 48x40x36, the 8^3
#: coarsest level of the multigrid path and 2^3
MG_MARCH_GRIDS = [(16, 16, 16), (48, 40, 36), (8, 8, 8), (2, 2, 2),
                  (70, 12, 40)]
MG_MARCH_IDS = ["16cubed", "48x40x36", "8cubed", "2cubed", "70x12x40"]


def _flat(out):
    return list(out.values()) if isinstance(out, dict) else list(out)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("grid", MG_MARCH_GRIDS, ids=MG_MARCH_IDS)
@pytest.mark.parametrize("h", [1, 2])
@pytest.mark.parametrize("problem", ["newton", "jacobi"])
def test_mg_march_equals_per_site(cuda, problem, h, grid, dtype):
    """K11's march (a build that marches every launch) equals the per-site
    kernel (a build that marches none) bit for bit: mg_smooth (1 and 3
    sweeps), mg_residual and mg_tau, unpadded, x-, y- and xy-padded on
    windows padded by hand, and as an interior launch plus two x shells;
    each padded launch and the split equal the unpadded one. nf = 1 (the
    Newton problem) and 2 (the Jacobi pair)."""
    cls, lhs, omega = _mg_problem(problem)
    solver = cls(lhs, halo_shape=h, omega=omega, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(10 + h)
    names = list(solver.f_to_rho_dict)
    rnames = list(solver.f_to_rho_dict.values())

    def rand():
        return torch.rand(grid, generator=g, device=cuda, dtype=dtype) - 0.5
    fs, rhos, rr = ([rand() for _ in names] for _ in range(3))
    level = trelax.LevelSpec(grid, (10.0 / 16, 0.5, 0.4))
    X, Y, _ = grid

    def launches(build):
        out = {}
        fd, rd = dict(zip(names, fs)), dict(zip(rnames, rhos))
        with _mg_lib(solver, build):
            out["smooth1"] = solver.smooth(level, fd, rd, {}, 1)
            out["smooth3"] = solver.smooth(level, fd, rd, {}, 3)
            out["residual"] = solver.residual(level, fd, rd, {})
            out["tau"] = solver.tau_rhs(level, fd, dict(zip(names, rr)), {})
            for kind, src in (("smooth", rhos), ("residual", rhos),
                              ("tau", rr)):
                out[kind, None] = solver.launch_block(kind, level, fs, src,
                                                      {}, _new(fs))
                if min(X, Y) >= h:
                    for pad, (hx, hy) in (("xpad", (h, 0)),
                                          ("ypad", (0, h)),
                                          ("xypad", (h, h))):
                        wins = [_periodic_window(f, hx, hy) for f in fs]
                        out[kind, pad] = solver.launch_block(
                            kind, level, wins, src, {}, _new(fs), pad)
                if X > 2 * h:
                    padded = [_periodic_window(f, h, 0) for f in fs]
                    outs = _new(fs)
                    solver.launch_block(kind, level, fs, src, {}, outs,
                                        "interior", h)
                    for x0 in (0, X - h):
                        solver.launch_block(
                            kind, level,
                            [p[x0:x0 + 3 * h].contiguous() for p in padded],
                            src, {}, outs, "shell", x0)
                    out[kind, "split"] = outs
        torch.cuda.synchronize()
        return out

    march, per_site = launches(MG_MARCH_ALL), launches(MG_PER_SITE)
    assert set(march) == set(per_site)
    for key, got in march.items():
        assert all(torch.equal(a, b)
                   for a, b in zip(_flat(got), _flat(per_site[key]))), key
        if isinstance(key, tuple):
            assert all(torch.equal(a, b) for a, b in zip(
                got, march[key[0], None])), key


# -- the binning kernels K13 (bincount), K14 (spectra_bin), the finish ------

#: K13 / K14 vs their plain versions, relative to the largest bin: float64
#: sums in another order (float32 inputs: their weights' own rounding too)
HIST_TOL = {torch.float32: 1e-6, torch.float64: 1e-13}
HIST_GRIDS = [(16, 16, 16), (48, 40, 36)]


def _spectra(cuda, grid, dtype, real=True):
    ndt = {torch.float32: np.float32, torch.float64: np.float64}[dtype]
    if not real:
        ndt = {np.float32: np.complex64, np.float64: np.complex128}[ndt]
    lat = pt.Lattice(grid, (5.0, 4.0, 7.0))
    fft = pt.DFT(None, grid_shape=grid, dtype=ndt, device=cuda)
    return pt.PowerSpectra(None, fft, lat.dk, lat.volume)


def _hist_rel(got, ref):
    return ((got.double() - ref.double()).abs().max()
            / ref.double().abs().max().clamp_min(1e-300)).item()


@pytest.mark.cuda
@pytest.mark.parametrize("weights", [None, torch.float32, torch.float64],
                         ids=["counts", "f32", "f64"])
@pytest.mark.parametrize("outer", [1, 2, 6])
@pytest.mark.parametrize("grid", HIST_GRIDS, ids=["16cubed", "48x40x36"])
def test_bincount_matches_plain(cuda, grid, outer, weights):
    """K13 against its plain version (counts equal, sums within HIST_TOL),
    the same launch twice equal bits, one launch and one finish counted,
    and (2, 1, 1) / (2, 2, 1) blocks equal to the whole lattice's launch
    bit for bit where they hold whole units."""
    from pystella_tpu_torch.ops import histogram as thist
    g = torch.Generator(device=cuda).manual_seed(outer)
    b = torch.randint(-1, 1001, (outer,) + grid, generator=g, device=cuda,
                      dtype=torch.int32)
    w = None if weights is None else torch.randn(
        (outer,) + grid, generator=g, device=cuda, dtype=weights)
    before = dict(thist.LAUNCHES)
    one = thist.bincount(b, w, 1000)
    torch.cuda.synchronize()
    assert thist.LAUNCHES["bincount"] == before["bincount"] + 1
    assert thist.LAUNCHES["bin_finish"] == before["bin_finish"] + 1
    ref = thist.bincount_plain(b, w, 1000)
    if w is None:
        assert torch.equal(one, ref)
    else:
        assert _hist_rel(one, ref) <= HIST_TOL[weights]
    assert torch.equal(thist.bincount(b, w, 1000), one)
    for mesh in ((2, 1, 1), (2, 2, 1)):
        if grid[1] // mesh[1] % thist.unit_rows(grid[1]):
            continue
        d = pt.DomainDecomposition(mesh)
        got = thist.bincount(d.shard(b), None if w is None else d.shard(w),
                             1000)
        assert torch.equal(got, one), mesh


@pytest.mark.cuda
@pytest.mark.parametrize("real", [True, False], ids=["r2c", "c2c"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("grid", HIST_GRIDS + [(5, 9, 33)],
                         ids=["16cubed", "48x40x36", "5x9x33"])
def test_spectra_bin_matches_plain(cuda, grid, dtype, real):
    """K14 against its plain version within HIST_TOL (k powers 3 and 2),
    its bins exact (unit modes at k^0 give the shells' count weights,
    whole numbers, equal), repeat bits, the sharded k-space launches equal
    the whole lattice's."""
    from pystella_tpu_torch.ops import histogram as thist
    sp = _spectra(cuda, grid, dtype, real)
    cdt = {torch.float32: torch.complex64,
           torch.float64: torch.complex128}[dtype]
    g = torch.Generator(device=cuda).manual_seed(3)
    fk = torch.randn((2,) + sp.kshape, generator=g, device=cuda, dtype=cdt)
    for kp in (3, 2):
        got = sp.binner(fk, kp)
        assert _hist_rel(got, sp.binner.plain(fk, kp)) <= HIST_TOL[dtype]
        assert torch.equal(sp.binner(fk, kp), got)
    ones = torch.ones_like(fk)
    assert torch.equal(sp.binner(ones, 0), sp.binner.plain(ones, 0))
    whole = sp.binner(fk, 3)
    for mesh in ((2, 1, 1), (2, 2, 1)):
        if sp.kshape[1] // mesh[1] % thist.unit_rows(sp.kshape[1]) or \
                sp.kshape[0] % mesh[0] or sp.kshape[1] % mesh[1]:
            continue
        d = pt.DomainDecomposition(mesh)
        assert torch.equal(sp.binner(d.shard(fk), 3), whole), mesh


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_measurement_step_on_card_matches_cpu(cuda, dtype):
    """PowerSpectra (K14) and FieldHistogrammer (K13) on the card against
    the same entry points on the CPU (the plain versions): spectra within
    1e-5 / 1e-12 (cuFFT against pocketfft), the histograms' counts equal
    where the bins are formed alike (float64)."""
    grid = (32, 32, 32)
    ndt = {torch.float32: np.float32, torch.float64: np.float64}[dtype]
    rng = np.random.default_rng(4)
    f = rng.standard_normal((2,) + grid).astype(ndt)
    lat = pt.Lattice(grid, (5.0,) * 3)
    out = {}
    for dev in (cuda, "cpu"):
        fft = pt.DFT(None, grid_shape=grid, dtype=ndt, device=dev)
        sp = pt.PowerSpectra(None, fft, lat.dk, lat.volume)
        x = torch.from_numpy(f).to(dev)
        out[str(dev)[:3]] = (sp(x), pt.FieldHistogrammer(None, 1000)(x))
    (sg, hg), (sc, hc) = out["cud"], out["cpu"]
    assert np.max(np.abs(sg - sc)) / np.max(np.abs(sc)) <= (
        1e-5 if dtype == torch.float32 else 1e-12)
    if dtype == torch.float64:
        for k in hc:
            np.testing.assert_array_equal(hg[k], hc[k], err_msg=k)


@pytest.mark.cuda
def test_binning_refuses_too_many_bins(cuda):
    from pystella_tpu_torch.ops import histogram as thist
    b = torch.zeros((8, 8, 8), device=cuda, dtype=torch.int32)
    with pytest.raises(ValueError, match="at most"):
        thist.bincount(b, None, thist.max_bins(False) + 1)
    thist.bincount(b, None, thist.max_bins(False))
    with pytest.raises(ValueError, match="at most"):
        thist.bincount(b, b.double(), thist.max_bins(True) + 1)


#: the histogram.cu build that bins counts and K14 every site through the
#: warp grouping, the yardstick of the run designs, and the entry points
#: whose design it changes
HIST_MATCH = "\n#define PK_HIST_MATCH 1\n"
HIST_MATCH_ENTRIES = ("pk_bincount_count", "pk_spectra_bin_f32",
                      "pk_spectra_bin_f64")


@contextlib.contextmanager
def _hist_grouping():
    """Within, the binning wrappers launch the grouping build's counts and
    K14."""
    from pystella_tpu_torch.ops import histogram as thist
    fns = thist.build_kernels()
    header = thist._HEADER + HIST_MATCH
    if header not in _BUILDS:
        _BUILDS[header] = thist.bind_kernels(tstencil.build_kernels(
            ["histogram.cu"], header)["histogram.cu"])
    keep = {k: fns[k] for k in HIST_MATCH_ENTRIES}
    fns.update({k: _BUILDS[header][k] for k in HIST_MATCH_ENTRIES})
    try:
        yield
    finally:
        fns.update(keep)


def _kind_bins(kind, shape, g, cuda):
    """Seeded int32 bins over 1000: uniform over [-1, 1000] (some out of
    range), every site in one bin (``hot1``), 90% of the sites in two bins
    (``hot2``), sorted (long runs), or uniform from a 4-byte offset (no
    unit's first bin 16-byte aligned: the scalar loads)."""
    b = torch.randint(-1, 1001, shape, generator=g, device=cuda,
                      dtype=torch.int32)
    if kind == "hot1":
        b.fill_(500)
    elif kind == "hot2":
        u = torch.rand(shape, generator=g, device=cuda)
        b = torch.where(u < 0.45, 333, torch.where(u < 0.9, 999, b)).to(
            torch.int32)
    elif kind == "sorted":
        b = b.reshape(-1).sort().values.reshape(shape)
    elif kind == "misaligned":
        b = torch.cat([b.new_zeros(1), b.reshape(-1)])[1:].view(shape)
        assert b.is_contiguous() and b.data_ptr() % 16
    return b


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["uniform", "hot1", "hot2", "sorted",
                                  "misaligned"])
@pytest.mark.parametrize("grid", HIST_GRIDS + [(5, 9, 33)],
                         ids=["16cubed", "48x40x36", "5x9x33"])
def test_bincount_counts_match_grouping(cuda, grid, kind):
    """K13's counts, by runs and shared-memory atomics, on hot-bin, sorted
    and misaligned inputs: equal to the plain version's and to the grouping
    build's exactly, the same twice, and (2, 1, 1) / (2, 2, 1) blocks equal
    to the whole lattice's."""
    from pystella_tpu_torch.ops import histogram as thist
    g = torch.Generator(device=cuda).manual_seed(7)
    b = _kind_bins(kind, (2,) + grid, g, cuda)
    one = thist.bincount(b, None, 1000)
    assert torch.equal(one, thist.bincount_plain(b, None, 1000))
    assert torch.equal(thist.bincount(b, None, 1000), one)
    with _hist_grouping():
        assert torch.equal(thist.bincount(b, None, 1000), one)
    if kind == "hot1":
        assert int(one[:, 500].sum()) == b.numel()
    for mesh in ((2, 1, 1), (2, 2, 1)):
        if grid[1] // mesh[1] % thist.unit_rows(grid[1]) or \
                grid[0] % mesh[0] or grid[1] % mesh[1]:
            continue
        d = pt.DomainDecomposition(mesh)
        assert torch.equal(thist.bincount(d.shard(b), None, 1000), one), mesh


@pytest.mark.cuda
@pytest.mark.parametrize("weights", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_bincount_weights_match_grouping(cuda, weights):
    """K13's float64 sums keep the grouping: bit for bit the grouping
    build's."""
    from pystella_tpu_torch.ops import histogram as thist
    g = torch.Generator(device=cuda).manual_seed(8)
    b = _kind_bins("hot2", (2, 48, 40, 36), g, cuda)
    w = torch.randn(b.shape, generator=g, device=cuda, dtype=weights)
    one = thist.bincount(b, w, 1000)
    with _hist_grouping():
        assert torch.equal(thist.bincount(b, w, 1000), one)


@pytest.mark.cuda
@pytest.mark.parametrize("real", [True, False], ids=["r2c", "c2c"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("grid", HIST_GRIDS + [(5, 9, 33), (2, 4, 600)],
                         ids=["16cubed", "48x40x36", "5x9x33", "2x4x600"])
def test_spectra_bin_matches_grouping(cuda, grid, dtype, real):
    """K14 by runs (a c2c row's bins fall, so it bins site by site; rows of
    301 and 600 sites go in segments) within HIST_TOL of the plain version
    and of the grouping build, its bins (unit modes at k^0) equal to both,
    repeat bits, the sharded k-space launches equal the whole lattice's."""
    from pystella_tpu_torch.ops import histogram as thist
    sp = _spectra(cuda, grid, dtype, real)
    cdt = {torch.float32: torch.complex64,
           torch.float64: torch.complex128}[dtype]
    g = torch.Generator(device=cuda).manual_seed(9)
    fk = torch.randn((3,) + sp.kshape, generator=g, device=cuda, dtype=cdt)
    ones = torch.ones_like(fk)
    got, shells = sp.binner(fk, 3), sp.binner(ones, 0)
    with _hist_grouping():
        grouped, grouped_shells = sp.binner(fk, 3), sp.binner(ones, 0)
    assert _hist_rel(got, sp.binner.plain(fk, 3)) <= HIST_TOL[dtype]
    assert _hist_rel(got, grouped) <= HIST_TOL[dtype]
    assert torch.equal(shells, sp.binner.plain(ones, 0))
    assert torch.equal(shells, grouped_shells)
    assert torch.equal(sp.binner(fk, 3), got)
    for mesh in ((2, 1, 1), (2, 2, 1)):
        if sp.kshape[1] // mesh[1] % thist.unit_rows(sp.kshape[1]) or \
                sp.kshape[0] % mesh[0] or sp.kshape[1] % mesh[1]:
            continue
        d = pt.DomainDecomposition(mesh)
        assert torch.equal(sp.binner(d.shard(fk), 3), got), mesh
    # wide shells (a few a row): runs across many lanes
    wide = thist.SpectraBins(sp.binner.sq_axes, 4 * sp.bin_width
                             * max(grid) / 8, grid, real, 6)
    got = wide(fk, 3)
    with _hist_grouping():
        grouped = wide(fk, 3)
    assert _hist_rel(got, wide.plain(fk, 3)) <= HIST_TOL[dtype]
    assert _hist_rel(got, grouped) <= HIST_TOL[dtype]
    assert torch.equal(wide(ones, 0), wide.plain(ones, 0))


# -- the health kernel (K15) and the NaN bin ------------------------------

#: K15's rms against its plain version, relative: the same float64 squares
#: summed in another order
HEALTH_TOL = 1e-12


def _health_field(cuda, shape, dtype, kind, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn(shape, generator=g, device=cuda, dtype=torch.float64)
    if kind == "overflow":
        x = x * 1e20
    elif kind in ("nan", "inf", "-inf"):
        x.view(-1)[x.numel() // 3] = float(kind)
    return x.to(dtype)


def _health_agrees(got, ref):
    got, ref = got.view(-1, 3).double(), ref.view(-1, 3).double()
    assert torch.equal(got[:, :2].nan_to_num(7.0), ref[:, :2].nan_to_num(7.0))
    fin = torch.isfinite(ref[:, 2])
    assert torch.equal(got[~fin, 2].nan_to_num(7.0),
                       ref[~fin, 2].nan_to_num(7.0))
    assert bool(((got[fin, 2] - ref[fin, 2]).abs()
                 <= HEALTH_TOL * ref[fin, 2].abs()).all())


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["clean", "nan", "inf", "-inf", "overflow"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.bfloat16],
                         ids=["f32", "f64", "bf16"])
@pytest.mark.parametrize("shape", [(2, 16, 16, 16), (48, 40, 36),
                                   (3, 4, 1200)],
                         ids=["2x16cubed", "48x40x36", "3x4x1200"])
def test_health_matches_plain(cuda, shape, dtype, kind):
    """K15 and its finish: finite and max_abs equal to the plain version's,
    rms within HEALTH_TOL (equal where not finite), a second launch bit for
    bit, (2, 2, 1) blocks on the card the single-device vector bit for bit,
    and a view off 16-byte alignment (the scalar loads) the same."""
    from pystella_tpu_torch.ops import health as thealth
    x = _health_field(cuda, shape, dtype, kind, 3)
    y = _health_field(cuda, shape, dtype, "clean", 4)
    got = thealth.field_stats([x, y], torch.float64)
    _health_agrees(got, thealth.field_stats_plain([x, y], torch.float64))
    assert torch.equal(got.nan_to_num(7.0), thealth.field_stats(
        [x, y], torch.float64).nan_to_num(7.0))
    if shape[-3] % 2 == 0 and shape[-2] // 2 % thealth.unit_rows(
            shape[-2]) == 0:
        d = pt.DomainDecomposition((2, 2, 1))
        assert torch.equal(got.nan_to_num(7.0), thealth.field_stats(
            [d.shard(x), d.shard(y)], torch.float64).nan_to_num(7.0))
    off = torch.cat([torch.zeros(1, dtype=dtype, device=cuda),
                     x.reshape(-1)])[1:].view(shape)
    assert off.data_ptr() % 16
    assert torch.equal(thealth.field_stats([off, y], torch.float64)
                       .nan_to_num(7.0), got.nan_to_num(7.0))


@pytest.mark.cuda
@pytest.mark.parametrize("gw", [False, True], ids=["scalar", "gw"])
def test_sentinel_on_fused_chunks(cuda, gw):
    """multi_step(sentinel=) and coupled_multi_step(sentinel=) on the card:
    the state bit for bit the one without the sentinel, the vector equal to
    Sentinel.compute on it, K15 launched."""
    from pystella_tpu_torch.ops import health as thealth
    grid, dx = (16, 16, 16), (0.3, 0.25, 0.2)

    def potential(f):
        # tests/test_fused.py's potential
        return 0.5 * 1.2e-2 * f[0] ** 2 + 0.125 * f[0] ** 2 * f[1] ** 2
    sector = pt.ScalarSector(2, potential=potential)
    if gw:
        st = pt.FusedPreheatStepper(sector, pt.TensorPerturbationSector(
            [sector]), grid, dx, H, dtype=torch.float64, dt=0.01,
            device=cuda)
    else:
        st = pt.FusedScalarStepper(sector, grid, dx, H, dtype=torch.float64,
                                   dt=0.01, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(5)
    state = {"f": torch.randn((2,) + grid, generator=g, device=cuda,
                              dtype=torch.float64),
             "dfdt": 0.3 * torch.randn((2,) + grid, generator=g,
                                       device=cuda, dtype=torch.float64)}
    if gw:
        state["hij"] = 1e-3 * torch.randn((6,) + grid, generator=g,
                                          device=cuda, dtype=torch.float64)
        state["dhijdt"] = 1e-4 * torch.randn((6,) + grid, generator=g,
                                             device=cuda,
                                             dtype=torch.float64)
    sen = pt.obs.Sentinel.for_state(state, dtype=torch.float64)
    args = {"a": 1.0, "hubble": 0.0}
    ref = _copy(st.multi_step(_copy(state), 3, rhs_args=args))
    thealth.reset_launch_counts()
    got, hv = st.multi_step(_copy(state), 3, rhs_args=args, sentinel=sen)
    assert thealth.LAUNCHES["health"] == len(state)
    assert all(bool(torch.isfinite(v).all()) for v in got.values())
    assert all(torch.equal(got[k], ref[k]) for k in ref)
    assert torch.equal(hv, sen.compute(got))
    exp = [pt.Expansion(1.0, pt.LowStorageRK54) for _ in range(2)]
    cref = _copy(st.coupled_multi_step(_copy(state), 3, exp[0]))
    cgot, chv = st.coupled_multi_step(_copy(state), 3, exp[1], sentinel=sen)
    assert all(bool(torch.isfinite(v).all()) for v in cgot.values())
    assert all(torch.equal(cgot[k], cref[k]) for k in cref)
    assert (exp[0].a, exp[0].adot) == (exp[1].a, exp[1].adot)
    assert torch.equal(chv, sen.compute(cgot))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float64, np.float32],
                         ids=["f64", "f32"])
def test_histogrammer_nan_bin_on_card(cuda, dtype):
    """A NaN bin value lands in bin 0 on the card too: the K13 path's
    counts equal the plain version's (on the CPU), every site counted."""
    def hists():
        f = pt.Field("f")
        return {"n": (f * 10 + 20, 1), "w": ((f + 3) * 8, f * f + 1)}
    x = np.random.default_rng(1).standard_normal((2, 16, 16, 16)).astype(
        dtype)
    x[0, 0, 0, :3] = [np.inf, -np.inf, np.nan]
    hist = pt.Histogrammer(None, hists(), 50, dtype)
    card = hist(f=torch.from_numpy(x).to(cuda))
    plain = hist(f=torch.from_numpy(x))
    np.testing.assert_array_equal(card["n"], plain["n"])
    assert card["n"][0].sum() == 16**3 and card["n"][0, 0] == 115
    assert np.array_equal(np.isnan(card["w"]), np.isnan(plain["w"]))
