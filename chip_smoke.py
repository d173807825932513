#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``pystella_tpu_torch/ops/csrc`` (into
the ignored ``pystella_tpu_torch/ops/_build``), holds each kernel against
its plain PyTorch version, and drives the port's main paths through the
entry points a user calls, at 512^3 in float32:

- the 2-field scalar-preheating hot loop, ``FusedScalarStepper.multi_step``
  (kernels ``fused_pair`` and ``fused_stage``), and the same with the
  whole-RK-chunk tier, ``chunk_stages=4`` (``fused_chunk`` first), with
  float32 and with bfloat16 carries (``carry_dtype=torch.bfloat16``: the
  ``:bf16`` variants of the three kernels);
- the energy-coupled driver, ``FusedScalarStepper.coupled_multi_step`` with
  ``Expansion`` and ``Reduction`` (kernels ``coupled_pair``,
  ``coupled_pair_deferred`` and ``fused_stage_energy``);
- the same with bfloat16 carries (the ``:bf16`` variants of its kernels,
  and ``fused_stage_energy:bf16_fin``, the odd trailing stage after a
  finalize), and a single-stage chunk (``pair=False``, the plain
  ``:bf16`` energy stage);
- the same two for the gravitational-wave system, ``FusedPreheatStepper``
  with a ``TensorPerturbationSector`` (2 scalar fields and 6 ``hij``
  components; 48 GiB of state, carries and buffers): ``multi_step``
  (kernels ``preheat_pair`` and ``preheat_stage``) and
  ``coupled_multi_step`` (``preheat_coupled_pair``,
  ``preheat_coupled_pair_deferred`` and ``preheat_stage_energy``), each
  also with bfloat16 carries (the JAX package's 512^3-on-one-device
  configuration: the ``:bf16`` variants, 36 GiB);
- the wave equation through the generic stepper, ``RungeKutta4`` over
  ``FiniteDifferencer.lap`` (bench.py:run_wave at 512^3 instead of 64^3),
  and the other operators on its final state (kernels ``fd_lap``,
  ``fd_grad``, ``fd_grad_lap``, ``fd_pdx``, ``fd_pdy``, ``fd_pdz``,
  ``fd_div``);
- the multigrid solver, ``FullApproximationScheme`` over a
  ``NewtonIterator`` on ``lap f - f + f**3 = rho`` (bench.py:run_multigrid:
  default V-cycles; kernels ``mg_smooth``, ``mg_residual``, ``mg_tau``);
- the sharded tier, every shard on the one card
  (``DomainDecomposition(proc_shape)``): the hot loop,
  ``FusedScalarStepper(decomp=...).multi_step``, on ``(2, 1, 1)`` padded
  and overlapped, ``(2, 2, 1)``, ``(4, 1, 1)`` overlapped and ``(1, 2, 1)``,
  each final state bit-equal to the single-block run's, and every
  ``FiniteDifferencer`` operator on it (kernels ``<name>:xpad``,
  ``:ypad``, ``:xypad``, ``:interior``, ``:shell`` of ``fused_stage``,
  ``fused_pair`` and the seven ``fd_*``);
- the sharded energy-coupled driver,
  ``FusedScalarStepper(decomp=...).coupled_multi_step``, on ``(2, 1, 1)``,
  ``(2, 2, 1)``, ``(4, 1, 1)`` and ``(1, 2, 1)``, and the sharded GW
  stepper, ``FusedPreheatStepper(decomp=...)``'s ``multi_step`` (on
  ``(2, 1, 1)`` overlapped and padded, ``(2, 2, 1)``, ``(1, 2, 1)``) and
  ``coupled_multi_step`` (on the coupled driver's four meshes), each final
  state (and a, adot) bit-equal to the single-device run's (the padded
  entry points of ``fused_stage_energy``, ``coupled_pair``,
  ``coupled_pair_deferred`` and of the five GW kernels, the interior and
  shell ones of ``preheat_stage`` and ``preheat_pair``);
- the multigrid solver on a sharded lattice: the bench cycle through
  ``FullApproximationScheme`` over ``NewtonIterator(decomp=...)`` on
  ``(2, 1, 1)`` overlapped and padded, ``(2, 2, 1)`` and ``(1, 2, 1)``,
  each final f bit-equal to the single-device cycle's, and the identity
  cycles at 256^3 f64 (replicated coarse levels, the linear scheme)
  (kernels ``mg_smooth``, ``mg_residual`` and ``mg_tau`` as ``:xpad``,
  ``:ypad``, ``:xypad``, ``:interior`` and ``:shell``);
- the sharded steppers with bfloat16 carries, every shard on the one card:
  the bench hot loop on ``(2, 1, 1)`` overlapped and ``(2, 2, 1)``, the
  coupled driver on ``(2, 1, 1)`` and ``(2, 2, 1)``, the GW bench's
  ``multi_step`` on ``(2, 1, 1)`` overlapped and the coupled GW driver on
  ``(2, 1, 1)`` padded, each final state (and a, adot) bit-equal to the
  single-device bf16 run's (kernels ``<name>:bf16:<kind>`` of every kernel
  with a sharded tier, and ``fused_stage_energy:bf16_fin:<kind>``,
  ``preheat_stage_energy:bf16_fin:<kind>``).

- the science example's start and measurement step
  (examples/scalar_preheating.py, examples/torch_scalar_preheating.py):
  ``RayleighGenerator.init_WKB_fields`` for both fields, four steps of
  ``coupled_multi_step``, then ``FieldStatistics``,
  ``FiniteDifferencer.grad``, rho through ``ElementWiseMap``,
  ``FieldHistogrammer(1000)(rho)``, ``PowerSpectra`` of the two fields and
  of rho, and ``PowerSpectra.gw`` on a GW stepper's state (kernels
  ``bincount``, ``spectra_bin`` and ``bin_finish``: the deterministic
  binning of ``ops/csrc/histogram.cu``); its spectra and histogram on
  ``(2, 2, 1)`` bit-equal to the single device's.
- run safety on the coupled-preheat path (examples/scalar_preheating.py
  ``--checkpoint-dir``, ``--health-every``): ``coupled_multi_step(...,
  sentinel=)`` in chunks under a ``HealthMonitor`` (kernels ``health`` and
  ``health_finish``, K15 of ``ops/csrc/health.cu``, beside K6 and K5), a
  ``Checkpointer`` save, finalize and restore whose resumed run equals the
  uninterrupted one bit for bit, and a NaN trip with its forensic bundle.

A non-polynomial potential (exp, tanh, sqrt, cos, powers 2.5 and -2, a
quotient) compiles the printer's math-function paths into K2, K3 and K5 and
holds them against their plain versions. Every phase prints one JSON line;
the run fails (non-zero exit, no result line) if any phase fails. Then come
the ``{"kernels": [...]}`` line, the card's name and power limit as
nvidia-smi prints them, and, last, the result line ``{"ok": true,
"device": {...}}``.

Without a CUDA device, or without the ``pystella_tpu_torch`` package beside
it, it exits non-zero before printing any result.
"""

import contextlib
import ctypes
import json
import math
import os
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

#: the bench and example model (bench.py:build_preheat_step,
#: examples/scalar_preheating.py): V = (m^2 phi^2/2 + g^2 phi^2 chi^2/2) /
#: m^2, box 5^3, dt = 0.1 dx, order-4 Laplacian, RK54, mpl = 1
MPHI, GSQ = 1.20e-6, 2.5e-7
BOX, HALO, GRID = 5.0, 2, (512, 512, 512)
NSTEPS = 10
#: the other kernel-vs-plain shapes (the first also serves the identities)
#: and the reference comparisons' lattice
ALT_SHAPES = ((256,) * 3, (48, 40, 36))
SMALL = (32, 32, 32)
#: the example's homogeneous background (examples/scalar_preheating.py:167)
F0, DF0 = (0.193, 0.0), (-0.142231, 0.0)

#: kernel vs plain version, max |kernel - plain| / max |plain| per output.
#: They differ where PyTorch's CUDA division by a Python scalar multiplies
#: by the reciprocal (one extra rounding in dV/df); that difference passes
#: through ~10 roundings of terms no larger than the output: a few ulp.
KERNEL_TOL = {torch.float32: 1e-5, torch.float64: 1e-13}
#: energy sums, kernel vs plain, relative to sum |term| (in float64): the
#: two add ~1e8 terms in different orders (about log2(n) ulp apart), and
#: -f lap f has mixed signs, so the sum itself is no scale
SUM_TOL = {torch.float32: 1e-5, torch.float64: 1e-12}
#: one pair launch vs two single-stage launches, one chunk launch vs two
#: pair launches, and the chunk path's final state vs the pair path's: the
#: same operations in the same order (tests/test_fused.py:64 holds the JAX
#: pair to 1e-14; 0.0 is expected under -fmad=false)
IDENTITY_TOL = {torch.float32: 1e-6, torch.float64: 1e-14}
#: the bf16-carry main path vs the f32-carry one: the carry quantization's
#: accuracy bar (tests/test_fused.py:416)
BF16_PATH_TOL = 1e-2
#: the chunk depth the chunk paths run
CHUNK = 4
#: the deferred-drag pair + finalize vs the K3 pair with hubble2 = hubfix:
#: one dt distribution re-associated (rounding level)
DEFERRED_TOL = {torch.float32: 1e-5, torch.float64: 1e-12}
#: the Friedmann constraint of the coupled main path's final state
CONSTRAINT_TOL = 1e-4
#: H100 SXM data sheet: HBM3 bandwidth and the non-tensor FP32 peak
HBM_BYTES_PER_S = 3.35e12
PEAK_F32_OPS = 67e12

#: the science example's measurement step (examples/scalar_preheating.py:
#: 243-292): the 1000-bin rho histogram and the scalar, rho and GW spectra
#: of the 2-field model at 512^3 f32, after its WKB start (seed 49279,
#: :337-349) and 4 coupled steps; the binning kernels it runs
SPECTRA_KERNELS = ("bincount", "spectra_bin", "bin_finish")
HIST_BINS, SPECTRA_SEED, SPECTRA_STEPS = 1000, 49279, 4
#: the example's background (:214-215)
F0, DF0 = (0.193, 0.0), (-0.142231, 0.0)
#: K13 / K14 vs their plain versions, relative to the largest bin: float64
#: sums in another order (float32 inputs: the weights' own rounding too)
HIST_TOL = {torch.float32: 1e-6, torch.float64: 1e-13}
#: the binning meshes held bit for bit to the whole lattice's launch
HIST_MESHES = ((2, 1, 1), (2, 2, 1))
#: the histogram.cu build that bins counts and K14 every site through the
#: warp grouping: the yardstick K13 and K14 are timed beside and held to
#: (counts and K14's bins equal, K14's sums within HIST_TOL)
HIST_MATCH = "\n#define PK_HIST_MATCH 1\n"
#: the entry points whose design the yardstick build changes
HIST_MATCH_ENTRIES = ("pk_bincount_count", "pk_spectra_bin_f32",
                      "pk_spectra_bin_f64")
#: the study builds of the opt-in hist_variants group, each histogram.cu
#: with (old, new) patches applied to a copy of its text, timed beside the
#: default build on the main path's inputs (k13_*: K13's rows, k14_*:
#: K14's): K13 with 1 and 2 interleaved copies of its count histogram (the
#: default 4); K14 with its registers fitted to 1, 3 and 5 blocks an SM
#: (the default 4), and three builds that leave out a part of K14's work
#: to time what it costs (the histogram adds, the hypot, the IEEE
#: division: their sums are not K14's and are never compared)
HIST_STUDY = {
    **{f"k13_copies={c}": [("#define PK_COUNT_COPIES 4",
                            f"#define PK_COUNT_COPIES {c}")] for c in (1, 2)},
    **{f"k14_min_blocks={b}": [("#define PK_SPECTRA_MINB 4",
                                f"#define PK_SPECTRA_MINB {b}")]
       for b in (1, 3, 5)},
    "k14_without_adds": [(
        "if ((unsigned)b < (unsigned)nbins) mine[b] += s;",
        "if ((unsigned)b < (unsigned)nbins && s == -1.0) mine[b] += s;")],
    "k14_without_hypot": [(
        "const R mod = pk_hypot(v.x, v.y);\n"
        "  return (double)((cnt * pk_kpow(kmag, a.ipow, a.p)) * (mod * mod));",
        "return (double)((cnt * pk_kpow(kmag, a.ipow, a.p))\n"
        "                  * (v.x * v.x + v.y * v.y));")],
    "k14_without_division": [(
        "  return (int)pk_rint(kmag / a.bin_width);\n}",
        "  return (int)pk_rint(kmag * (R(1) / a.bin_width));\n}")]}
#: the bound entry points of the HIST_STUDY builds, by label (filled where
#: the hist_variants group is selected)
HIST_STUDY_BUILDS = {}

#: the wave path (bench.py:run_wave): box (2 pi)^3, order-4 Laplacian,
#: RungeKutta4, dt = 0.1 dx, 5 warm-up and 50 timed steps
WAVE_BOX, WAVE_WARMUP, WAVE_STEPS = 2 * math.pi, 5, 50
#: the wave reference: kernel-mode vs roll-mode drive after 40 steps, and
#: the RK54 energy-drift ratio at dt vs dt / 2 (5th order: 32)
WAVE_REFERENCE_TOL, WAVE_DRIFT_RATIO = 1e-12, (25.0, 40.0)
#: RungeKutta4 damps the modes it does not resolve: the wave path's energy
#: may fall by this fraction over its 55 steps, and no more
WAVE_ENERGY_TOL = 1e-2
#: the multigrid path (bench.py:run_multigrid): dx = 10 / n, h = 1,
#: omega = 2/3, default V-cycle; 1 warm-up and 2 timed cycles
MG_BOX, MG_HALO, MG_OMEGA, MG_CYCLES = 10.0, 1, 2 / 3, 2
#: K12 vs plain: multiplies and adds in one order on both sides (0
#: expected), and so K11 vs plain -- both held to KERNEL_TOL.
#: The converged multigrid residual (tests/test_multigrid.py:67) and one
#: kernel-tier cycle against one plain-tier cycle:
MG_CONVERGED_TOL, MG_CYCLE_TOL = 5e-14, 1e-12
#: the stencil radii whose operator kernels are built and checked
FD_HALOS = (1, 2, 4)
#: the spill bytes (the larger of stores and loads) ptxas gives each float
#: instantiation of the register-queue marches (fd_lap, fd_grad, fd_grad_lap,
#: fd_pd*, fd_div, K11)
#: that spills at all, by demangled name and stencil radius or problem, as
#: an H100 build measured them: a few bytes at 40-48 registers, mostly in
#: padded instantiations; a register floor removed fd_lap's at a 10% cost
#: (PERF.md). The build fails if one spills more or another starts to spill.
QUEUE_MARCH_F32_SPILLS = {
    "pk_fd_lap_kernel<float, 3> (h=1)": 4,
    "pk_fd_lap_kernel<float, 3> (h=2)": 8,
    "pk_fd_lap_kernel<float, 2> (h=2)": 8,
    "pk_fd_lap_kernel<float, 3> (h=4)": 4,
    "pk_fd_lap_kernel<float, 2> (h=4)": 8,
    "pk_fd_grad_lap_kernel<float, 3> (h=1)": 12,
    "pk_fd_grad_lap_kernel<float, 2> (h=1)": 12,
    "pk_fd_grad_lap_kernel<float, 3> (h=4)": 4,
    "pk_fd_grad_kernel<float, 2> (h=1)": 12,
    "pk_fd_grad_kernel<float, 0> (h=4)": 4,
    "pk_fd_div_kernel<float, 2> (h=1)": 12,
    "pk_fd_div_kernel<float, 2> (h=4)": 12,
    "pk_fd_div_kernel<float, 3> (h=4)": 12,
    "mg_relax_march_kernel<float, 0, 2> (newton)": 4,
    "mg_relax_march_kernel<float, 2, 2> (jacobi)": 8,
    "mg_relax_march_kernel<float, 1, 2> (jacobi)": 8,
    "mg_relax_march_kernel<float, 0, 3> (jacobi)": 20,
    "mg_relax_march_kernel<float, 0, 2> (jacobi)": 28}
FD_KERNELS = ("fd_lap", "fd_grad", "fd_grad_lap", "fd_pdx", "fd_pdy",
              "fd_pdz", "fd_div")
MG_KERNELS = ("mg_smooth", "mg_residual", "mg_tau")
#: the operators that march (fd_lap's loop, pk_queue_march; pdy and pdz
#: run per site), and the defines of the build whose operators run per
#: site: the marches are timed beside it and held to it bit for bit
FD_MARCHED = ("lap", "grad", "grad_lap", "pdx", "div")
FD_PER_SITE = "\n#define PK_FD_PER_SITE 1\n"
#: the defines of the fused_stage.cu build whose K2 runs per site: K2's
#: march is timed beside it and held to it bit for bit
STAGE_PER_SITE = "\n#define PK_STAGE_PER_SITE 1\n"
#: the defines of K11 builds that run every launch per site (the site
#: threshold past any level) and that march every launch, however small
#: its region
MG_PER_SITE = f"\n#define MG_MARCH_MIN_SITES {2**31 - 1}\n"
MG_MARCH_ALL = "\n#define MG_MARCH_MIN_SITES 1\n"

SUM_KERNELS = ("fused_stage_energy", "coupled_pair", "coupled_pair_deferred")
#: the bf16-carry variants this run holds against their plain versions and
#: times, beyond the chunk phases' K2, K3, K10: (kernel, velocity carries
#: finalized)
BF16_SUM_KERNELS = [(n, False) for n in SUM_KERNELS] + [
    ("fused_stage_energy", True)]
GW_KERNELS = ("preheat_stage", "preheat_pair", "preheat_stage_energy",
              "preheat_coupled_pair", "preheat_coupled_pair_deferred")
GW_SUM_KERNELS = GW_KERNELS[2:]
BF16_GW_KERNELS = [(n, False) for n in GW_KERNELS] + [
    ("preheat_stage_energy", True)]
#: the coupled paths' launches with bf16 carries: the pairs, the trailing
#: energy stage on the finalized carries and, from a pair=False chunk, the
#: energy stage
BF16_COUPLED = ("coupled_pair:bf16", "coupled_pair_deferred:bf16",
                "fused_stage_energy:bf16_fin", "fused_stage_energy:bf16")
BF16_GW_COUPLED = ("preheat_coupled_pair:bf16",
                   "preheat_coupled_pair_deferred:bf16",
                   "preheat_stage_energy:bf16_fin",
                   "preheat_stage_energy:bf16")
#: the path memory predicted before the first chip run (PERF.md): three
#: sets of state (4 B a value) and carries (2 B) -- the caller's state with
#: its zero carries and the stepper's two ping-pong sets -- and, on the
#: coupled paths, the finalize's float32 velocities, velocity carries and
#: temporaries (up to 8 GiB for the GW system, 2 for the scalar one)
PREDICTED_PATH_GIB = {"gw_bf16_main_path": 36.0,
                      "coupled_gw_bf16_main_path": 44.0,
                      "coupled_bf16_main_path": 11.0}
#: the test shape of the non-polynomial case
NONPOLY_SHAPE = (16, 16, 16)
#: bench.py:build_gw_step / run_gw_step: its potential, its state (numpy
#: seed 9: f 0.1 N(0, 1), dfdt 0.01 N(0, 1), hij = dhijdt = 0) and its
#: background scalars
GW_BENCH_SEED, GW_BENCH_ARGS = 9, {"a": 1.0, "hubble": 0.1}
#: the GW fused multi_step vs the generic GW stepper (the bar of
#: tests/test_fused.py:634: S_ij's products of gradients add rounding)
GW_REFERENCE_TOL = 1e-11


def emit(obj):
    print(json.dumps(obj), flush=True)


def potential(f):
    phi, chi = f[0], f[1]
    return (MPHI**2 / 2 * phi**2 + GSQ / 2 * phi**2 * chi**2) / MPHI**2


def gw_bench_potential(f):
    """The GW bench's model (bench.py:build_gw_step)."""
    return 0.5 * 1.2e-2 * f[0]**2 + 0.125 * f[0]**2 * f[1]**2


def gw_bench_state():
    """bench.py:build_gw_step's state at 512^3 f32, drawn with its numpy
    generator and seed, on the host."""
    rng = np.random.default_rng(GW_BENCH_SEED)
    f = torch.from_numpy(
        (0.1 * rng.standard_normal((2,) + GRID)).astype(np.float32))
    dfdt = torch.from_numpy(
        (0.01 * rng.standard_normal((2,) + GRID)).astype(np.float32))
    zeros = torch.zeros((6,) + GRID, dtype=torch.float32)
    return {"f": f, "dfdt": dfdt, "hij": zeros, "dhijdt": zeros}


def on_card(state):
    return {k: v.to("cuda") for k, v in state.items()}


def nonpoly_potential(f):
    """Every non-polynomial path of the kernel printer: exp, tanh, sin and
    cos (V and dV/df), sqrt, powers 2.5 (and 1.5), -2 (and -3),
    quotients."""
    import pystella_tpu_torch as pt
    return (0.1 * pt.exp(0.3 * f[0]) + 0.2 * pt.tanh(f[1]) * pt.cos(f[0])
            + 0.05 * pt.sqrt(1 + f[0] ** 2) + 0.01 * (2 + f[1] ** 2) ** 2.5
            + 0.02 * (1.5 + f[0] ** 2) ** -2 + f[0] * f[1] / (3 + f[0] ** 2))


def rel_err(out, ref):
    d = (out.double() - ref.double()).abs().max().item()
    scale = ref.double().abs().max().item()
    return d / scale if scale else d, d


def cuda_ms(fn, reps, warmup=1):
    """Mean milliseconds per call of ``fn`` on the card (CUDA events)."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_inputs(shape, dtype, seed, F=2, gw=False, dtypes=None):
    """Four lattice inputs at bench-like amplitudes from a seeded generator
    (f, dfdt, kf, kdfdt; for the deferred pair f, dfp, kdfp, kf); with
    ``gw`` four more of 6 components, the tensor system's: hij 1e-3 N(0, 1),
    dhijdt 1e-4 N(0, 1) and small k-carries. ``dtypes``: each array's
    storage dtype (bf16 carries are drawn in ``dtype`` and rounded)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    amps = [(F, a) for a in (1e-3, 1e-4, 1e-5, 1e-3)]
    if gw:
        amps += [(6, a) for a in (1e-3, 1e-4, 1e-5, 1e-4)]
    out = [a * torch.randn((c,) + shape, generator=g, device="cuda",
                           dtype=dtype) for c, a in amps]
    return out if dtypes is None else [t.to(d) for t, d in zip(out, dtypes)]


def kernel_params(name, dx):
    """The scalars of a launch (a GW kernel takes its scalar
    counterpart's)."""
    import pystella_tpu_torch as pt
    from pystella_tpu_torch.ops import fused as tfused
    name = tfused._GW_OF.get(name, name)
    A, B = pt.LowStorageRK54._A, pt.LowStorageRK54._B
    dt = 0.1 * dx
    if name == "fused_chunk":
        # stages 1-4 of RK54 with a slowly varying background
        params = [dt]
        for k, s in enumerate(range(1, CHUNK + 1)):
            params += [1.0 + 0.01 * k, 0.5 - 0.01 * k, A[s % 5], B[s % 5]]
        return tuple(params)
    if name in ("fused_stage", "fused_stage_energy"):
        return (dt, 1.0, 0.5, A[1], B[1])
    if name == "fused_pair":
        return (dt, 1.0, 0.5, A[1], B[1], 1.0, 0.5, A[2], B[2])
    params = (dt, 1.0, 0.5, A[1], B[1], 1.0001, A[2], B[2])
    if name == "coupled_pair_deferred":
        params += (0.49, B[0])
    return params


def background_state(shape, dtype, seed, gw=False):
    """The example's homogeneous background plus 1e-5 N(0, 1) fluctuations
    from a seeded generator (stands in for the WKB initial state); with
    ``gw``, hij = dhijdt = 0, the example's GW initial condition
    (examples/scalar_preheating.py:317-320)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    out = {}
    for name, mean in (("f", F0), ("dfdt", DF0)):
        v = 1e-5 * torch.randn((2,) + shape, generator=g, device="cuda",
                               dtype=dtype)
        for c, m in enumerate(mean):
            v[c] += m
        out[name] = v
    if gw:
        for name in ("hij", "dhijdt"):
            out[name] = torch.zeros((6,) + shape, device="cuda", dtype=dtype)
    return out


def count_ops(exprs, fields, variables):
    """Arithmetic operations of the printed expressions."""
    from pystella_tpu_torch.ops import codegen
    src = " ".join(codegen.print_c(e, fields, variables) for e in exprs)
    return sum(src.count(op) for op in (" * ", " + ", " / ", " - ", "pk_"))


def printed_ops(sector):
    """Arithmetic operations of the printed dV/df (all F) and of the
    printed V, per site."""
    import pystella_tpu_torch as pt
    from pystella_tpu_torch.ops import codegen
    V = sector.potential(sector.f)
    dvdf = [pt.diff(V, sector.f[i]) for i in range(sector.nscalars)]
    return (count_ops(dvdf, {"f": "f"}, codegen.STAGE_VARIABLES),
            count_ops([V], {"f": "f"}, codegen.STAGE_VARIABLES))


def ops_per_site(name, stepper):
    """Arithmetic a kernel does per site, counted from its source: per
    component the Laplacian (1 + 9h) and the stage update (14), plus two
    shared scalar products and the printed dV/df; the pair does two
    stages and recomposes f1 (5 operations) at each of its 6h taps. An
    energy sum set adds dfdt*dfdt, -f and *lap per component, the printed
    V and one add per term into the block tree. The coupled pair's second
    stage has no drag (2 operations fewer per component); its deferred
    input completes the velocity (4 operations) at the site and at each of
    the 6h taps the f1 composition reads.

    A GW kernel adds, per stage, the gradients of f (9h per component),
    the printed S_ij and per hij component a Laplacian (1 + 9h) and the
    stage update (14, one shared 2*hubble); its pair recomposes f1 once
    more for the gradients and h1 for the Laplacian (5 per tap), the
    coupled pair's second tensor stage has no drag (2 fewer per
    component) and its deferred input completes both velocities at the
    taps it reads."""
    F, h = stepper.F, stepper.h
    dv, v = printed_ops(stepper.sector)
    stage = F * (1 + 9 * h + 14) + 2 + dv
    sums = 3 * F + v + (2 * F + 1)
    pair = 2 * stage + F * 5 * 6 * h
    coupled = pair - 2 * F + 2 * sums
    deferred = F * 4 * (6 * h + 1) + 2
    ops = {"fused_stage": stage, "fused_stage_energy": stage + sums,
           # the chunk's stages without the halo's redundant recompute
           "fused_chunk": CHUNK * stage,
           "fused_pair": pair, "coupled_pair": coupled,
           "coupled_pair_deferred": coupled + deferred}
    if name in ops:
        return ops[name]
    from pystella_tpu_torch.ops import codegen
    from pystella_tpu_torch.ops import fused as tfused
    NH = stepper.n_hij
    sij = count_ops(stepper._sij_exprs, {"dfdx": "dfdx"},
                    codegen.STAGE_VARIABLES)
    gw_stage = F * 9 * h + sij + NH * (1 + 9 * h + 14) + 1
    gw_pair = 2 * gw_stage + F * 5 * 6 * h + NH * 5 * 6 * h
    gw = {"preheat_stage": gw_stage, "preheat_stage_energy": gw_stage,
          "preheat_pair": gw_pair, "preheat_coupled_pair": gw_pair - 2 * NH,
          "preheat_coupled_pair_deferred": gw_pair - 2 * NH
          + F * 4 * 6 * h + NH * 4 * (6 * h + 1)}[name]
    return ops[tfused._GW_OF[name]] + gw


def term_scale(st, f, df, a, hub):
    """sum |term| of each energy sum of the state (f, df), in float64."""
    import pystella_tpu_torch as pt
    f, df = f.double(), df.double()
    lap = pt.FiniteDifferencer(st.h, st.dx, device=f.device).lap(f)
    V = pt.evaluate(st.sector.potential(st.sector.f),
                    {st.sector.f.name: f, "a": a, "hubble": hub})
    V = torch.as_tensor(V, dtype=torch.float64, device=f.device)
    return torch.cat([(df * df).sum((1, 2, 3)),
                      (f * lap).abs().sum((1, 2, 3)),
                      torch.broadcast_to(V, f.shape[1:]).abs().sum()[None]])


def sum_errors(st, name, ins, outs, plain, params):
    """max |kernel sum - plain sum| / sum |term| over a kernel's sum sets:
    the entry state's and, for a pair, the stage-1 state's (f1 = f2 - B2
    kf2 to rounding; the velocity df1 is the dfp output). The GW kernels'
    sums are the scalar sector's."""
    from pystella_tpu_torch.ops import fused as tfused
    name = tfused._GW_OF.get(name, name)
    f, v = ins[0], ins[1]
    if name == "coupled_pair_deferred":
        dt, hubfix, B2p = params[0], params[8], params[9]
        v = v + B2p * (ins[2] - 2 * dt * hubfix * v)
    scales = [term_scale(st, f, v, params[1], params[2])]
    if name != "fused_stage_energy":
        f1 = outs[0].double() - params[7] * outs[2].double()
        scales.append(term_scale(st, f1, outs[1], params[5], None))
    n = len(ins)
    return max(((k.double() - p.double()).abs() / s).max().item()
               for k, p, s in zip(outs[n:], plain[n:], scales))


def generic_stepper(sector, dx, gw=False):
    """The port's generic LowStorageRK54 over the sector's rhs_dict (with
    ``gw``, merged with the TensorPerturbationSector's) on
    FiniteDifferencer's lap (and grad)."""
    import pystella_tpu_torch as pt
    fd = pt.FiniteDifferencer(HALO, dx)
    merged = dict(sector.rhs_dict)
    if gw:
        merged.update(pt.TensorPerturbationSector([sector]).rhs_dict)
    rhs = pt.compile_rhs_dict(merged)

    def full_rhs(s, t, a, hubble):
        aux = {"lap_f": fd.lap(s["f"]), "a": a, "hubble": hubble}
        if gw:
            aux["dfdx"] = fd.grad(s["f"])
            aux["lap_hij"] = fd.lap(s["hij"])
        return rhs(s, t, **aux)
    return pt.LowStorageRK54(full_rhs)


def driver_loop(sector, state, nsteps, dx, dt, gw=False):
    """The reference per-stage driver loop (tests/test_fused.py:206-219)
    on the port's generic pieces: LowStorageRK54 + FiniteDifferencer
    (:func:`generic_stepper`), the scalar energy re-reduced by Reduction
    after every stage, Expansion stepped on the entering energy. Returns
    the final state and Expansion and the initial energy."""
    import pystella_tpu_torch as pt
    fd = pt.FiniteDifferencer(HALO, dx)
    gen = generic_stepper(sector, dx, gw)
    grid_size = float(math.prod(state["f"].shape[1:]))
    reduce_energy = pt.Reduction(sector, callback=pt.get_rho_and_p,
                                 grid_size=grid_size)

    def energy_of(st, a):
        return reduce_energy(f=st["f"], dfdt=st["dfdt"],
                             lap_f=fd.lap(st["f"]), a=np.float64(a))

    energy = energy_of(state, 1.0)
    energy0 = energy["total"]
    exp = pt.Expansion(energy0, pt.LowStorageRK54)
    for _ in range(nsteps):
        carry = gen.init_carry(state)
        for s in range(gen.num_stages):
            carry = gen.stage(s, carry, 0.0, dt,
                              {"a": np.float64(exp.a),
                               "hubble": np.float64(exp.hubble)})
            exp.step(s, energy["total"], energy["pressure"], dt)
            energy = energy_of(gen.current(carry), exp.a)
        state = gen.extract(carry)
    return state, exp, energy0


def trace_chunk(run, untraced_s):
    """Device time of one chunk under torch.profiler: the busy time of
    every kernel and copy on the card, by name, against the span from the
    first to the last; the idle share is 1 - busy / span. The profiler's
    own host cost widens the gaps, so the busy time is also set against
    the untraced chunk's CUDA-event time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    # (the profiler also lays the record_function labels on the device
    # timeline; they are spans around work counted already)
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and e.name not in SHARDED_LABELS + ("mg_transfer",)]
    if not events:
        return {"device_events": 0, "idle_share": "not measured"}
    by_name = {}
    for e in events:
        key = e.name[:60]
        by_name[key] = by_name.get(key, 0.0) + e.time_range.elapsed_us()
    busy = sum(by_name.values())
    span = (max(e.time_range.end for e in events)
            - min(e.time_range.start for e in events))
    return {"device_events": len(events), "busy_ms": busy / 1e3,
            "span_ms": span / 1e3, "idle_share": 1 - busy / span,
            "idle_share_vs_untraced": 1 - busy / 1e6 / untraced_s,
            "busy_ms_by_name": {k: v / 1e3 for k, v in sorted(
                by_name.items(), key=lambda kv: -kv[1])}}


def sourced(final):
    """The GW paths start from hij = 0: the source S_ij must have reached
    hij by the end."""
    hmax = final["hij"].abs().max().item()
    return {"hij_max_abs": hmax}, hmax > 0


def case_tag(shape, dtype):
    return "x".join(map(str, shape)) + ":" + str(dtype)[6:]


def kernel_item(item):
    """``(name, finalized)`` of a kernel list entry: a name, or a name and
    whether the launch takes finalized velocity carries (the ``_bf16_fin``
    energy stages)."""
    return item if isinstance(item, tuple) else (item, False)


def kernels_vs_plain(phase, make_stepper, names, cases, errs, gw=False,
                     tag=""):
    """Each kernel vs its plain version on seeded inputs, at every (shape,
    dtype) of ``cases``; every sum-emitting kernel twice for bit-equal
    sums. Fills ``errs[key][case_tag]`` (``key``: the kernel's LAUNCHES
    name, ``<name>:bf16`` (``<name>:bf16_fin``) on a bf16-carry stepper)
    and fails on a disagreement."""
    from pystella_tpu_torch.ops import fused as tfused
    for shape, dtype in cases:
        st = make_stepper(shape, dtype)
        for seed, item in enumerate(names):
            name, fin = kernel_item(item)
            ins = kernel_inputs(shape, dtype, seed, gw=gw,
                                dtypes=st._in_dtypes(fin))
            params = kernel_params(name, BOX / shape[0])
            plain = st.plain(name, ins, params)
            outs = st.launch(name, ins, st._new_set(ins[0].device), params)
            torch.cuda.synchronize()
            labels = ("f", "dfdt", "kf", "kdfdt", "hij", "dhijdt", "khij",
                      "kdhijdt")
            n = len(ins)  # the lattice outputs; the sum vectors follow
            per_output = {lbl: rel_err(o, p) for lbl, o, p in
                          zip(labels[:n], outs[:n], plain[:n])}
            worst_rel = max(r for r, _ in per_output.values())
            worst_abs = max(a for _, a in per_output.values())
            row = {"max_rel_err": worst_rel, "max_abs_err": worst_abs,
                   "tol": KERNEL_TOL[dtype]}
            ok = worst_rel <= KERNEL_TOL[dtype]
            if tfused.SUM_SETS[name]:
                row["sum_err"] = sum_errors(st, name, ins, outs, plain,
                                            params)
                row["sum_tol"] = SUM_TOL[dtype]
                del plain
                again = st.launch(name, ins, st._new_set(ins[0].device),
                                  params)
                torch.cuda.synchronize()
                row["sums_bitwise_repeatable"] = all(
                    torch.equal(a, b) for a, b in zip(outs, again))
                ok = (ok and row["sum_err"] <= SUM_TOL[dtype]
                      and row["sums_bitwise_repeatable"])
                del again
            else:
                del plain
            key = st.counted_name(name, fin)
            errs.setdefault(key, {})[case_tag(shape, dtype) + tag] = row
            emit({"phase": phase, "kernel": key, "shape": shape,
                  "dtype": str(dtype),
                  "rel_err": {n: r for n, (r, _) in per_output.items()},
                  **row})
            if not ok:
                raise SystemExit(f"{key} disagrees with its plain version "
                                 f"at {shape} {dtype}: {row}")
            del ins, outs
            torch.cuda.empty_cache()
        del st
        torch.cuda.empty_cache()


def identities(phase, make_stepper, gw=False):
    """On the card, at 256^3 in f64 and f32: one pair launch == two
    single-stage launches; the energy stage's lattice outputs == the
    stage's, bitwise; the coupled pair + finalize == the pair with hubble2
    = hubfix; K2's march == the per-site build's K2 (the scalar system),
    bitwise."""
    for dtype in (torch.float64, torch.float32):
        shape = ALT_SHAPES[0]
        st = make_stepper(shape, dtype)
        kn = st._KERNEL
        ins = kernel_inputs(shape, dtype, 7, gw=gw)
        p = kernel_params("fused_pair", BOX / shape[0])
        new = lambda: [torch.empty_like(t) for t in ins]  # noqa
        pair = st.launch(kn["pair"], ins, new(), p)
        mid = st.launch(kn["stage"], ins, new(), p[:5])
        two = st.launch(kn["stage"], mid, new(), (p[0],) + p[5:])
        energy = st.launch(kn["stage_energy"], ins, new(), p[:5])
        torch.cuda.synchronize()
        worst = max(rel_err(a, b)[0] for a, b in zip(pair, two))
        energy_bitwise = all(torch.equal(a, b) for a, b in zip(energy, mid))
        per_site = {}
        if not gw:
            key = (kn["stage"], dtype, None, False)
            with swapped(st._libs, stage_per_site(st), [key]):
                ref = st.launch(kn["stage"], ins, new(), p[:5])
            torch.cuda.synchronize()
            per_site["stage_bitwise_per_site_build"] = all(
                torch.equal(a, b) for a, b in zip(mid, ref))
            del ref
        del mid, two, energy
        cp = kernel_params("coupled_pair", BOX / shape[0])
        hubfix = 0.49
        coupled = st.launch(kn["coupled_pair"], ins, new(), cp)
        n = len(ins)
        state, k = st._finalize_deferred(st._carry_of(coupled[:n]), cp[0],
                                         hubfix, cp[7])
        ref = st.launch(kn["pair"], ins, new(),
                        cp[:5] + (cp[5], hubfix, cp[6], cp[7]))
        torch.cuda.synchronize()
        deferred = max(rel_err(a, b)[0] for a, b in zip(
            st._inputs((state, k)), ref))
        emit({"phase": phase, "dtype": str(dtype), "shape": shape,
              "max_rel_err": worst, "tol": IDENTITY_TOL[dtype],
              "energy_stage_bitwise_stage": energy_bitwise, **per_site,
              "deferred_pair_vs_pair_rel_err": deferred,
              "deferred_tol": DEFERRED_TOL[dtype]})
        if not worst <= IDENTITY_TOL[dtype]:
            raise SystemExit(f"pair != two singles ({dtype}): {worst}")
        if not energy_bitwise:
            raise SystemExit(f"{kn['stage_energy']} != {kn['stage']} "
                             f"({dtype})")
        if not all(per_site.values()):
            raise SystemExit(f"{kn['stage']}'s march != its per-site build "
                             f"({dtype})")
        if not deferred <= DEFERRED_TOL[dtype]:
            raise SystemExit(f"coupled pair + finalize != fused pair "
                             f"({dtype}): {deferred}")
        del st, ins, pair, coupled, state, k, ref
        torch.cuda.empty_cache()


def stage_march_identity(phase, gw_stepper, scalar_stepper):
    """On the card, at 256^3 in f64, f32 and f32 with bfloat16 carries (and
    on finalized velocity carries): the stage marches (K5', K7, K5: one
    template with K2) held to each other and to K2 on the same inputs, bit
    for bit -- K5''s scalar outputs and sums K5's (``fused_stage_energy``
    of the same sector's scalar stepper); and, on carries that are not
    finalized (which K7, K2 and K8 do not take), K5''s lattice outputs K7's
    (``preheat_stage``), K5's scalar outputs K2's (``fused_stage``) and one
    K8 pair launch across a step boundary two K7 stages."""
    import pystella_tpu_torch as pt
    A, B = pt.LowStorageRK54._A, pt.LowStorageRK54._B
    shape = ALT_SHAPES[0]

    def equal(xs, ys):
        return all(torch.equal(a, b) for a, b in zip(xs, ys))
    for dtype, cd, fin in ((torch.float64, None, False),
                           (torch.float32, None, False),
                           (torch.float32, torch.bfloat16, False),
                           (torch.float32, torch.bfloat16, True)):
        gst = gw_stepper(shape, dtype, cd)
        sst = scalar_stepper(shape, dtype, cd)
        ins = kernel_inputs(shape, dtype, 12, gw=True,
                            dtypes=gst._in_dtypes(fin))
        p = kernel_params("fused_stage", BOX / shape[0])
        dev = ins[0].device
        k5p = gst.launch("preheat_stage_energy", ins, gst._new_set(dev), p)
        k5 = sst.launch("fused_stage_energy", ins[:4], sst._new_set(dev), p)
        torch.cuda.synchronize()
        row = {"scalar_outputs_bitwise_k5": equal(k5p[:4], k5[:4]),
               "sums_bitwise_k5": torch.equal(k5p[8], k5[4])}
        if not fin:
            k7 = gst.launch("preheat_stage", ins, gst._new_set(dev), p)
            k2 = sst.launch("fused_stage", ins[:4], sst._new_set(dev), p)
            torch.cuda.synchronize()
            row["lattice_outputs_bitwise_k7"] = equal(k5p[:8], k7)
            row["k5_scalar_outputs_bitwise_k2"] = equal(k5[:4], k2)
            del k7, k2
            # across a step boundary (stages 4 and 0, A[0] == 0), where a
            # pair equals two stages with bf16 carries too: the second
            # stage reads no rounded carry
            pp = (p[0], 1.0, 0.5, A[4], B[4], 1.01, 0.49, A[0], B[0])
            pair = gst.launch("preheat_pair", ins, gst._new_set(dev), pp)
            mid = gst.launch("preheat_stage", ins, gst._new_set(dev), pp[:5])
            two = gst.launch("preheat_stage", mid, gst._new_set(dev),
                             (pp[0],) + pp[5:])
            torch.cuda.synchronize()
            row["k8_bitwise_two_k7"] = equal(pair, two)
            del pair, mid, two
        emit({"phase": phase, "shape": shape, "dtype": str(dtype),
              "carry_dtype": str(cd or dtype), "finalized": fin, **row})
        if not all(row.values()):
            raise SystemExit(f"{phase}: the stage marches differ from each "
                             f"other or from K2 ({dtype}, "
                             f"{cd}, fin={fin}): {row}")
        del gst, sst, ins, k5p, k5
        torch.cuda.empty_cache()


def chunk_identity(phase, make_stepper):
    """On the card, at 256^3: one chunk launch (K10) == two pair launches
    (K3), state and carries, in f64, f32 and f32 with bf16 carries; the
    gap is recorded (0.0 expected) and the bf16 carries must be bit-equal."""
    shape = ALT_SHAPES[0]
    for dtype, cd in ((torch.float64, None), (torch.float32, None),
                      (torch.float32, torch.bfloat16)):
        st = make_stepper(shape, dtype, cd)
        ins = kernel_inputs(shape, dtype, 8, dtypes=st._dtypes)
        p = kernel_params("fused_chunk", BOX / shape[0])
        new = lambda: [torch.empty_like(t) for t in ins]  # noqa
        chunk = st.launch("fused_chunk", ins, new(), p)
        mid = st.launch("fused_pair", ins, new(), p[:9])
        two = st.launch("fused_pair", mid, new(), p[:1] + p[9:])
        torch.cuda.synchronize()
        labels = ("f", "dfdt", "kf", "kdfdt")
        errs = {n: rel_err(a, b)[0] for n, a, b in zip(labels, chunk, two)}
        bitwise = {n: torch.equal(a, b)
                   for n, a, b in zip(labels, chunk, two)}
        worst = max(errs.values())
        emit({"phase": phase, "shape": shape, "dtype": str(dtype),
              "carry_dtype": str(cd or dtype),
              "chunk_vs_two_pairs_rel_err": errs, "max_rel_err": worst,
              "bitwise": bitwise, "tol": IDENTITY_TOL[dtype]})
        if not worst <= IDENTITY_TOL[dtype]:
            raise SystemExit(f"chunk != two pairs ({dtype}, {cd}): {errs}")
        if cd is not None and not (bitwise["kf"] and bitwise["kdfdt"]):
            raise SystemExit(f"chunk carries != two pairs' ({dtype}, {cd})")
        del st, ins, chunk, mid, two
        torch.cuda.empty_cache()


def bf16_identities(phase, make_stepper, gw=False):
    """On the card, at 256^3 in f64 and f32, with bfloat16 carries: the
    energy stage's lattice outputs == the stage's, bitwise, and its sums
    bit-equal on a second launch; the pair across a step boundary (stages
    4 and 0: A[0] == 0 keeps stage 1's carry rounding out of stage 2) ==
    two single stages, bitwise; the energy stage on finalized velocity
    carries (``_bf16_fin``) == the f32-carry stepper's energy stage on the
    same values, its carries rounded to bf16, bitwise."""
    import pystella_tpu_torch as pt
    A, B = pt.LowStorageRK54._A, pt.LowStorageRK54._B
    shape = ALT_SHAPES[0]
    for dtype in (torch.float64, torch.float32):
        st = make_stepper(shape, dtype, torch.bfloat16)
        kn = st._KERNEL
        ins = kernel_inputs(shape, dtype, 9, gw=gw, dtypes=st._dtypes)
        p = kernel_params("fused_stage", BOX / shape[0])
        new = lambda: st._new_set(ins[0].device)  # noqa
        one = st.launch(kn["stage_energy"], ins, new(), p)
        two = st.launch(kn["stage_energy"], ins, new(), p)
        stage = st.launch(kn["stage"], ins, new(), p)
        torch.cuda.synchronize()
        energy_bitwise = all(torch.equal(a, b) for a, b in zip(one, stage))
        sums_bitwise = all(torch.equal(a, b) for a, b in zip(one, two))
        del one, two, stage
        dt = p[0]
        pair = st.launch(kn["pair"], ins, new(),
                         (dt, 1.0, 0.5, A[4], B[4], 1.01, 0.49, A[0], B[0]))
        mid = st.launch(kn["stage"], ins, new(), (dt, 1.0, 0.5, A[4], B[4]))
        twos = st.launch(kn["stage"], mid, new(), (dt, 1.01, 0.49, A[0], B[0]))
        torch.cuda.synchronize()
        pair_bitwise = all(torch.equal(a, b) for a, b in zip(pair, twos))
        del pair, mid, twos
        fins = kernel_inputs(shape, dtype, 10, gw=gw,
                             dtypes=st._in_dtypes(True))
        pf = kernel_params("fused_stage", BOX / shape[0])[:3] + (A[3], B[3])
        fin = st.launch(kn["stage_energy"], fins, new(), pf)
        wide = make_stepper(shape, dtype, None)
        ref = wide.launch(kn["stage_energy"], [t.to(dtype) for t in fins],
                          wide._new_set(fins[0].device), pf)
        torch.cuda.synchronize()
        n = len(fins)
        fin_bitwise = all(torch.equal(a, b.to(a.dtype))
                          for a, b in zip(fin[:n], ref[:n]))
        fin_sums = max((a - b).abs().max().item()
                       for a, b in zip(fin[n:], ref[n:]))
        emit({"phase": phase, "dtype": str(dtype), "shape": shape,
              "carry_dtype": "torch.bfloat16",
              "energy_stage_bitwise_stage": energy_bitwise,
              "sums_bitwise_repeatable": sums_bitwise,
              "cross_boundary_pair_bitwise_two_stages": pair_bitwise,
              "finalized_energy_stage_bitwise_f32_carry_stage": fin_bitwise,
              "finalized_energy_stage_sums_abs_diff": fin_sums})
        if not (energy_bitwise and sums_bitwise and pair_bitwise
                and fin_bitwise and fin_sums == 0.0):
            raise SystemExit(f"{phase}: a bf16-carry identity fails "
                             f"({dtype})")
        del st, wide, ins, fins, fin, ref
        torch.cuda.empty_cache()


def nonpoly_kernels_vs_plain(phase, errs):
    """K2, K3 and K5 with a non-polynomial potential (pk_exp, pk_tanh,
    pk_sin, pk_cos, pk_sqrt and pk_pow printed into dV/df and V) vs their
    plain versions at 16^3 in f64 and f32, on O(1) fields: KERNEL_TOL on
    the lattice outputs, SUM_TOL on K5's sums. Rows go to
    ``errs[name][<case>:nonpoly]``."""
    import pystella_tpu_torch as pt
    sector = pt.ScalarSector(2, potential=nonpoly_potential)
    shape = NONPOLY_SHAPE
    for dtype in (torch.float64, torch.float32):
        st = pt.FusedScalarStepper(sector, shape, BOX / shape[0], HALO,
                                   dtype=dtype, device="cuda")
        header = st.kernel_header()
        funcs = sorted(f for f in ("pk_exp", "pk_tanh", "pk_sin", "pk_cos",
                                   "pk_sqrt", "pk_pow") if f in header)
        g = torch.Generator(device="cuda").manual_seed(9)
        ins = [a * torch.randn((2,) + shape, generator=g, device="cuda",
                               dtype=dtype) for a in (0.8, 0.3, 0.01, 0.02)]
        for name in ("fused_stage", "fused_pair", "fused_stage_energy"):
            params = kernel_params(name, BOX / shape[0])
            plain = st.plain(name, ins, params)
            outs = st.launch(name, ins, st._new_set(ins[0].device), params)
            torch.cuda.synchronize()
            worst = max(rel_err(o, q)[0] for o, q in zip(outs[:4],
                                                        plain[:4]))
            row = {"max_rel_err": worst,
                   "max_abs_err": max(rel_err(o, q)[1] for o, q in
                                      zip(outs[:4], plain[:4])),
                   "tol": KERNEL_TOL[dtype]}
            ok = worst <= KERNEL_TOL[dtype]
            if len(outs) > 4:
                row["sum_err"] = sum_errors(st, name, ins, outs, plain,
                                            params)
                row["sum_tol"] = SUM_TOL[dtype]
                ok = ok and row["sum_err"] <= SUM_TOL[dtype]
            errs.setdefault(name, {})[case_tag(shape, dtype)
                                      + ":nonpoly"] = row
            emit({"phase": phase, "kernel": name, "shape": shape,
                  "dtype": str(dtype), "math_functions": funcs, **row})
            if not ok:
                raise SystemExit(f"{name} with the non-polynomial potential "
                                 f"disagrees with its plain version: {row}")
        if len(funcs) != 6:
            raise SystemExit(f"the non-polynomial header prints {funcs}")


def on_host(state):
    """A copy of a state in host memory (room on the card for the next
    path)."""
    return {k: v.to("cpu", copy=True) for k, v in state.items()}


def bf16_gap(phase, final, ref, held=("f", "dfdt", "hij", "dhijdt")):
    """The bf16-carry path's final state against the f32-carry path's
    (moved back from the host): the fields ``held`` within BF16_PATH_TOL,
    and the two not equal; the others' gap is recorded."""
    errs = {k: rel_err(final[k], ref[k].to(final[k].device))[0]
            for k in ref}
    differs = any(not torch.equal(final[k].cpu(), ref[k]) for k in ref)
    held = [k for k in held if k in errs]
    emit({"phase": phase + "_vs_f32_carries", "rel_err": errs,
          "held_to_tol": held, "differs": differs, "tol": BF16_PATH_TOL})
    if not (max(errs[k] for k in held) <= BF16_PATH_TOL and differs):
        raise SystemExit(f"{phase} is not within {BF16_PATH_TOL} of the "
                         f"f32-carry path, or equals it: {errs}")


def small_state(gw, seed=3):
    """The reference phases' random state at 32^3 f64 (with ``gw``, hij
    1e-3 N(0, 1) and dhijdt 1e-4 N(0, 1) too)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    comps = [("f", 2, 1e-3), ("dfdt", 2, 1e-4)]
    if gw:
        comps += [("hij", 6, 1e-3), ("dhijdt", 6, 1e-4)]
    return {n: a * torch.randn((c,) + SMALL, generator=g, device="cuda",
                               dtype=torch.float64) for n, c, a in comps}


def reference(phase, st, sector, tol, gw=False):
    """multi_step(3) of the fused kernels vs the generic stepper, 32^3
    f64."""
    small_dx = BOX / SMALL[0]
    gen = generic_stepper(sector, small_dx, gw)
    state = small_state(gw)
    args = {"a": 1.0, "hubble": 0.5}
    ref = dict(state)
    for _ in range(3):
        ref = gen.step(ref, 0.0, 0.1 * small_dx, args)
    got = st.multi_step({k: v.clone() for k, v in state.items()}, 3, 0.0,
                        0.1 * small_dx, args)
    errs = {k: rel_err(got[k], ref[k])[0] for k in state}
    worst = max(errs.values())
    emit({"phase": phase, "shape": SMALL, "dtype": "torch.float64",
          "nsteps": 3, "max_rel_err_vs_generic": worst,
          "rel_err_vs_generic": errs, "tol": tol})
    if not worst <= tol:
        raise SystemExit(f"fused multi_step disagrees with the generic "
                         f"stepper: {worst}")


def coupled_reference(phase, st, sector, gw=False):
    """coupled_multi_step (pair and single, nsteps 1 and 2) vs the
    per-stage driver loop, 32^3 f64: the scalar system from the example's
    background, the GW system from the random state of
    :func:`small_state`. (From the background, S_ij is the product of the
    fluctuations' gradients, 2e4 times smaller than f: a rounding-level
    difference in f between the two paths becomes a ~1e-12 one in hij.)"""
    import pystella_tpu_torch as pt
    small_dx = BOX / SMALL[0]
    dt_small = 0.1 * small_dx
    state = (small_state(True, seed=5) if gw
             else background_state(SMALL, torch.float64, 5))
    for nsteps in (1, 2):
        ref, exp_ref, energy0 = driver_loop(
            sector, {k: v.clone() for k, v in state.items()}, nsteps,
            small_dx, dt_small, gw)
        for pair in (True, False):
            exp = pt.Expansion(energy0, pt.LowStorageRK54)
            got = st.coupled_multi_step(
                {k: v.clone() for k, v in state.items()}, nsteps, exp, 0.0,
                dt_small, pair=pair)
            row = {k: rel_err(got[k], ref[k])[0] for k in state}
            row["a"] = abs(exp.a - exp_ref.a) / exp_ref.a
            row["adot"] = abs(exp.adot - exp_ref.adot) / abs(exp_ref.adot)
            emit({"phase": phase, "shape": SMALL,
                  "dtype": "torch.float64", "nsteps": nsteps, "pair": pair,
                  "rel_err_vs_driver_loop": row, "tol": 1e-12})
            if not max(row.values()) <= 1e-12:
                raise SystemExit(f"coupled_multi_step(pair={pair}, "
                                 f"nsteps={nsteps}) disagrees with the "
                                 f"driver loop: {row}")


def time_kernels(phase, st, names, seed0, timing):
    """Each kernel at the main path's shape (512^3 f32), timed with CUDA
    events over 20 launches alternating two output sets, and its plain
    version; with the bound: the larger of the bytes (each input read
    once, each output written once, the sum vectors) over the HBM rate
    and the operations over the f32 peak."""
    from pystella_tpu_torch.ops import fused as tfused
    sites = math.prod(GRID)
    gw = len(st._comps) > 4
    for seed, item in enumerate(names):
        name, fin = kernel_item(item)
        ins = kernel_inputs(GRID, torch.float32, seed0 + seed, gw=gw,
                            dtypes=st._in_dtypes(fin))
        params = kernel_params(name, BOX / GRID[0])
        sets = [st._new_set(ins[0].device) for _ in range(2)]
        n = [0]

        def launch():
            n[0] += 1
            st.launch(name, ins, sets[n[0] % 2], params)
        ms = cuda_ms(launch, reps=20, warmup=2)
        # K2's per-site build beside its march
        per_site = {} if name != "fused_stage" else {
            "per_site_ms": per_site_ms(st._libs, stage_per_site(st), [
                (name, torch.float32, st.carry_dtype, fin)], launch, 20)}
        del sets
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        plain_ms = cuda_ms(lambda: st.plain(name, ins, params),
                           reps=2 if gw else 3)
        plain_peak = torch.cuda.max_memory_allocated() / 2**30
        # each array once in and once out at its storage width (the bf16
        # carries at 2 bytes), plus the f32 sum vectors
        nbytes = (sites * sum(c * (di.itemsize + do.itemsize) for c, di, do
                              in zip(st._comps, st._in_dtypes(fin),
                                     st._dtypes))
                  + tfused.SUM_SETS[name] * (2 * st.F + 1) * 4)
        ops = ops_per_site(name, st) * sites
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / PEAK_F32_OPS * 1e3
        bound = max(bytes_ms, ops_ms)
        key = st.counted_name(name, fin)
        timing[key] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                       "bound_by": "bytes" if bytes_ms >= ops_ms
                       else "operations",
                       "bytes": nbytes, "ops": ops,
                       "share_of_bound": bound / ms, **per_site}
        row = dict(timing[key])
        if gw:
            row["plain_peak_memory_GiB"] = plain_peak
        emit({"phase": phase, "kernel": key, "shape": GRID,
              "dtype": "torch.float32", **row})
        del ins
        torch.cuda.empty_cache()


def schedule(st, nsteps):
    """Launches by role of ``multi_step(nsteps)`` (A[0] == 0: chunks, then
    pairs, then a single stage, across step boundaries)."""
    counts = {}
    for role, _, _ in st._plan(st.num_stages * nsteps):
        counts[role] = counts.get(role, 0) + 1
    return counts


def main_path(phase, st, state, timing, launches, extra_check=None,
              predicted_gib=None, args=None):
    """``multi_step(NSTEPS)`` at 512^3 f32: a warm-up chunk, a timed chunk
    and one tail step (the odd remainder of a run whose length is not a
    multiple of the chunk). The launch counts of the whole run must be
    the schedule's (for RK54 on the pair tier 2 x 25 pairs + 2 pairs and 1
    single stage; with ``chunk_stages=4`` 2 x (12 chunks + 1 pair) + 1
    chunk and 1 single) and go to ``launches`` for each kernel a path
    before has not counted; bytes and kernel share follow the tier report.
    Returns the final state."""
    from pystella_tpu_torch.ops import fused as tfused
    sites = math.prod(GRID)
    dt = 0.1 * BOX / GRID[0]
    args = args or {"a": 1.0, "hubble": 0.5}
    report = st.kernel_tier_report()
    names = {r: st.counted_name(st._KERNEL[k]) for r, k in st._ROLE.items()
             if k in st._KERNEL}
    expected = {}
    for n in (NSTEPS, NSTEPS, 1):
        for r, c in schedule(st, n).items():
            expected[names[r]] = expected.get(names[r], 0) + c
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # what the path holds: its input state, the k-carry and two buffer sets
    held_before = torch.cuda.memory_allocated() - sum(
        v.numel() * v.element_size() for v in state.values())
    tfused.reset_launch_counts()
    state = st.multi_step(state, NSTEPS, 0.0, dt, args)  # warmup chunk
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    host0 = time.perf_counter()
    start.record()
    state = st.multi_step(state, NSTEPS, 0.0, dt, args)  # timed chunk
    end.record()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - host0
    elapsed = start.elapsed_time(end) / 1e3
    state = st.multi_step(state, 1, 0.0, dt, args)  # the tail step
    torch.cuda.synchronize()
    path_launches = {k: v for k, v in tfused.LAUNCHES.items() if v}
    for name in expected:
        launches.setdefault(name, path_launches.get(name, 0))

    timed = schedule(st, NSTEPS)
    # the timed chunk's bytes: its launches, each array once in and once out
    timed_bytes = report["bytes_per_launch"] * sum(timed.values())
    finite = all(bool(torch.isfinite(v).all()) for v in state.values())
    shapes_ok = all(tuple(v.shape[1:]) == GRID for v in state.values())
    row = {"phase": phase, "grid": GRID, "dtype": "torch.float32",
           "carry_dtype": str(st.carry_dtype or st.dtype),
           "tier": report["tier"], "nsteps_timed": NSTEPS,
           "ms_per_step": elapsed / NSTEPS * 1e3,
           "site_updates_per_s": sites * NSTEPS / elapsed,
           "effective_GB_per_s": timed_bytes / elapsed / 1e9,
           "bytes_floor_ms_per_step": timed_bytes / NSTEPS
           / HBM_BYTES_PER_S * 1e3,
           "tier_report": report,
           "host_s": host_s, "launches": path_launches,
           "expected_launches": expected,
           # the timed chunk's launches at the separately timed per-launch
           # costs, over the chunk's device time: the share the card spent
           # in the kernels (1 minus it is launch gaps and other work)
           "kernel_share_est": sum(
               c * timing[names[r]]["ms"] for r, c in timed.items())
           / 1e3 / elapsed,
           "peak_memory_GiB": torch.cuda.max_memory_allocated() / 2**30,
           "path_memory_GiB": (torch.cuda.max_memory_allocated()
                               - held_before) / 2**30,
           "predicted_path_memory_GiB": predicted_gib,
           "finite": finite, "f_rms": state["f"].double().pow(2).mean()
           .sqrt().item()}
    ok = finite and shapes_ok
    if extra_check is not None:
        extra, extra_ok = extra_check(state)
        row.update(extra)
        ok = ok and extra_ok
    PATH_ROWS[phase] = row
    emit(row)
    if not ok:
        raise SystemExit(f"{phase} produced a non-finite, misshapen or "
                         "unsourced state")
    if path_launches != expected:
        raise SystemExit(f"{phase} launched {path_launches}, not the "
                         f"schedule's {expected}")
    return state


def coupled_main_path(phase, st, state, names, launches, trace=None,
                      extra_check=None, single=False, predicted_gib=None):
    """``coupled_multi_step(NSTEPS)`` at 512^3 f32 from ``state``: a
    warm-up chunk, a timed chunk (25 pairs, ending on a deferred pair and
    the chunk-end finalize) and the odd tail (2 pairs, a mid-chunk
    finalize and one energy stage); the Friedmann constraint of the final
    state must hold, and so must ``extra_check`` (as in
    :func:`main_path`). With ``single``, then one step of single-stage
    energy kernels (``pair=False``) from a copy of the final state and
    background, which must stay finite. With ``trace`` (a phase name), one
    more chunk under torch.profiler. Returns the final state (a copy of it
    taken before those, the stepper's buffers being theirs to write)."""
    import pystella_tpu_torch as pt
    from pystella_tpu_torch.ops import fused as tfused
    sites = math.prod(GRID)
    dx = BOX / GRID[0]
    dt = 0.1 * dx
    fd = pt.FiniteDifferencer(HALO, dx)
    reduce_energy = pt.Reduction(st.sector, callback=pt.get_rho_and_p,
                                 grid_size=float(sites))

    def energy_of(s, a):
        return reduce_energy(f=s["f"], dfdt=s["dfdt"],
                             lap_f=fd.lap(s["f"]), a=np.float64(a))

    energy0 = energy_of(state, 1.0)
    expand = pt.Expansion(energy0["total"], pt.LowStorageRK54, mpl=1.0)
    a0, adot0 = float(expand.a), float(expand.adot)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # what the path holds: its input state, the k-carry, two buffer sets and
    # the finalize's arrays
    held_before = torch.cuda.memory_allocated() - sum(
        v.numel() * v.element_size() for v in state.values())
    tfused.reset_launch_counts()
    state = st.coupled_multi_step(state, NSTEPS, expand, 0.0, dt)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    host0 = time.perf_counter()
    start.record()
    state = st.coupled_multi_step(state, NSTEPS, expand, 0.0, dt)
    end.record()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - host0
    device_s = start.elapsed_time(end) / 1e3
    state = st.coupled_multi_step(state, 1, expand, 0.0, dt)
    torch.cuda.synchronize()
    # a copy: the steps below write into the stepper's buffers, the state
    state = {k: v.clone() for k, v in state.items()}
    path_memory = (torch.cuda.max_memory_allocated() - held_before) / 2**30
    single_row, single_ref = {}, {}
    if single:
        exp1 = pt.Expansion(energy0["total"], pt.LowStorageRK54, mpl=1.0)
        exp1.a, exp1.adot, exp1.hubble = expand.a, expand.adot, expand.hubble
        t1 = time.perf_counter()
        out = st.coupled_multi_step({k: v.clone() for k, v in state.items()},
                                    1, exp1, 0.0, dt, pair=False)
        torch.cuda.synchronize()
        single_row = {"single_stage_step_s": time.perf_counter() - t1,
                      "single_stage_finite": all(
                          bool(torch.isfinite(v).all())
                          for v in out.values())}
        # what the sharded paths' single-stage step is held to
        single_ref = {"single_final": on_host(out), "single_a":
                      float(exp1.a), "single_adot": float(exp1.adot)}
        del out
    path_launches = dict(tfused.LAUNCHES)
    for name in names:
        launches[name] = path_launches[name]

    npairs = -(-st.num_stages * NSTEPS // 2)
    bytes_per_pair = st.kernel_tier_report()["bytes_per_launch"]
    energy = energy_of(state, expand.a)
    constraint = float(expand.constraint(energy["total"]))
    finite = all(bool(torch.isfinite(v).all()) for v in state.values())
    shapes_ok = all(tuple(v.shape[1:]) == GRID for v in state.values())
    extra, extra_ok = ({}, True) if extra_check is None else extra_check(
        state)
    # what the sharded paths of this model start from and are held to
    PATH_ROWS[phase] = {"ms_per_step": device_s / NSTEPS * 1e3,
                        "energy0": energy0["total"], "a": float(expand.a),
                        "adot": float(expand.adot), **single_ref}
    emit({"phase": phase, "grid": GRID,
          "dtype": "torch.float32",
          "carry_dtype": str(st.carry_dtype or st.dtype),
          "nsteps_timed": NSTEPS,
          "ms_per_step": device_s / NSTEPS * 1e3,
          "site_updates_per_s": sites * NSTEPS / device_s,
          "effective_GB_per_s": bytes_per_pair * npairs / device_s / 1e9,
          # wall clock of the chunk (ending in a synchronize) and the CUDA
          # events around it; the host waits for every pair's sums, so the
          # two agree and the device's idle gaps are inside both
          "host_s": host_s, "device_s": device_s,
          "launches": {k: v for k, v in path_launches.items() if v},
          "peak_memory_GiB": torch.cuda.max_memory_allocated() / 2**30,
          "path_memory_GiB": path_memory,
          "predicted_path_memory_GiB": predicted_gib, **single_row,
          "a0": a0, "adot0": adot0, "a": float(expand.a),
          "adot": float(expand.adot), "energy_total": float(energy["total"]),
          "constraint": constraint, "constraint_tol": CONSTRAINT_TOL,
          "finite": finite, **extra})
    if not (finite and shapes_ok and extra_ok
            and single_row.get("single_stage_finite", True)):
        raise SystemExit(f"{phase} produced a non-finite, misshapen or "
                         "unsourced state")
    if not constraint <= CONSTRAINT_TOL:
        raise SystemExit(f"{phase} violates the Friedmann constraint: "
                         f"{constraint}")
    for name in names:
        if launches[name] < 1:
            raise SystemExit(f"{phase} never launched {name}")
    if trace:
        emit({"phase": trace, **trace_chunk(
            lambda: st.coupled_multi_step(state, NSTEPS, expand, 0.0, dt),
            device_s)})
    return state


def fd_build(h, defines):
    """fd_ops.cu's entry points at stencil radius ``h`` built with
    ``defines`` after the generated header (from the build cache when the
    build phase made them), bound as ``ops/derivs.py`` binds its own."""
    from pystella_tpu_torch.ops import derivs, stencil
    return derivs.bind_kernels(stencil.build_kernels(
        ["fd_ops.cu"], derivs.kernel_header(h) + defines)["fd_ops.cu"])


def mg_build(solver, defines):
    """mg_relax.cu's entry points for ``solver``'s equations built with
    ``defines`` (a site threshold last) after its generated header, the
    tile held to ``mg_tile``."""
    from pystella_tpu_torch.multigrid import relax
    from pystella_tpu_torch.ops import stencil
    lib = stencil.build_kernels(["mg_relax.cu"], solver.kernel_header()
                                + defines)["mg_relax.cu"]
    solver.check_tile(lib, min_sites=int(defines.split()[-1]))
    return relax.bind_kernels(lib)


@contextlib.contextmanager
def swapped(fns, other, keys):
    """Within, the entry points ``keys`` of the bound library ``fns`` (a
    dict the launches read) are those of ``other``."""
    keep = {k: fns[k] for k in keys}
    fns.update({k: other[k] for k in keys})
    try:
        yield
    finally:
        fns.update(keep)


def per_site_ms(fns, other, keys, run, reps):
    """CUDA-event ms of ``run`` with the entry points ``keys`` of ``fns``
    swapped for the per-site build ``other``'s."""
    with swapped(fns, other, keys):
        return cuda_ms(run, reps=reps, warmup=2)


def stage_per_site(st):
    """The entry points of stepper ``st``'s bound kernels (``st._libs``)
    that launch K2, from fused_stage.cu built with STAGE_PER_SITE after
    ``st``'s model header (from the build cache when the build phase made
    it), bound as ``st`` binds its own."""
    from pystella_tpu_torch.ops import stencil
    lib = stencil.build_kernels(["fused_stage.cu"], st.kernel_header()
                                + STAGE_PER_SITE)["fused_stage.cu"]
    fns = {}
    for key, fn in st._libs.items():
        if key[0] == "fused_stage":
            other = getattr(lib, fn.__name__)
            other.argtypes, other.restype = fn.argtypes, fn.restype
            fns[key] = other
    return fns


def ptxas_of(source, header):
    """Registers and spill bytes of the kernels of one built library."""
    from pystella_tpu_torch.ops import stencil
    return stencil.ptxas_usage(stencil.build_log(source, header))


# -- the finite-difference operators (K12) and the wave equation --------------

def fd_input(op, shape, dtype, seed, C=None):
    """A seeded N(0, 1) input of operator ``op``: (2, X, Y, Z), for the
    divergence a (2, 3, X, Y, Z) vector field, folded to (6, X, Y, Z); or
    ``C`` components."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    if C is None:
        C = 6 if op == "div" else 2
    return torch.randn((C,) + tuple(shape), generator=g, device="cuda",
                       dtype=dtype)


def fd_kernels_vs_plain(phase, cases, errs):
    """Each K12 operator's kernel vs its plain version at every (shape,
    dtype, h) of ``cases``; the marches (FD_MARCHED) also bit for bit
    against the per-site build's, fd_lap against fd_grad_lap's Laplacian,
    fd_grad_lap's outputs against fd_grad's and fd_lap's, and fd_pdx's,
    fd_pdy's and fd_pdz's against fd_grad's three."""
    import pystella_tpu_torch as pt
    from pystella_tpu_torch.ops import derivs
    for shape, dtype, h in cases:
        fd = pt.FiniteDifferencer(h, WAVE_BOX / shape[0])
        fns, per_site = derivs.build_kernels(h), fd_build(h, FD_PER_SITE)
        tag = case_tag(shape, dtype) + ("" if h == HALO else f":h{h}")
        for seed, op in enumerate(derivs.OPS):
            x = fd_input(op, shape, dtype, 50 + seed)
            outs = fd.launch(op, x)
            torch.cuda.synchronize()
            plain = fd.plain(op, x)
            per_output = [rel_err(o, p_) for o, p_ in zip(outs, plain)]
            row = {"max_rel_err": max(r for r, _ in per_output),
                   "max_abs_err": max(a for _, a in per_output),
                   "tol": KERNEL_TOL[dtype]}
            if op in FD_MARCHED:
                with swapped(fns, per_site, [(op, dtype, 0)]):
                    ref = fd.launch(op, x)
                row["bitwise_per_site"] = all(
                    torch.equal(a, b) for a, b in zip(outs, ref))
                del ref
            if op == "lap":
                row["bitwise_grad_lap_lap"] = torch.equal(
                    outs[0], fd.launch("grad_lap", x)[1])
            if op == "grad_lap":
                row["bitwise_fd_grad"] = torch.equal(
                    outs[0], fd.launch("grad", x)[0])
                row["bitwise_fd_lap"] = torch.equal(
                    outs[1], fd.launch("lap", x)[0])
            if op in ("pdx", "pdy", "pdz"):
                row["bitwise_fd_grad"] = torch.equal(
                    outs[0], fd.launch("grad", x)[0][:, "xyz".index(op[2])])
            errs.setdefault("fd_" + op, {})[tag] = row
            emit({"phase": phase, "kernel": "fd_" + op, "shape": shape,
                  "dtype": str(dtype), "h": h, **row})
            if not (row["max_rel_err"] <= KERNEL_TOL[dtype]
                    and all(v for k, v in row.items()
                            if k.startswith("bitwise"))):
                raise SystemExit(f"fd_{op} disagrees with its plain version "
                                 f"or an identity at {shape} {dtype} h={h}: "
                                 f"{row}")
            del x, outs, plain
            torch.cuda.empty_cache()


#: arithmetic per site and input component: the Laplacian 1 + 9h, a
#: derivative 3h an axis
FD_OPS_PER_COMPONENT = {
    "lap": lambda h: 1 + 9 * h, "grad": lambda h: 9 * h,
    "grad_lap": lambda h: 1 + 18 * h, "pdx": lambda h: 3 * h,
    "pdy": lambda h: 3 * h, "pdz": lambda h: 3 * h, "div": lambda h: 3 * h}
#: output component-arrays per input component-array
FD_OUT_PER_IN = {"lap": 1, "grad": 3, "grad_lap": 4, "pdx": 1, "pdy": 1,
                 "pdz": 1, "div": 1 / 3}


#: the library call against the kernel, f32 with cuDNN's TF32 off: its
#: sums run in another order (3e-7 measured)
LIBRARY_TOL = 1e-5
#: the K12 operators one PyTorch call also computes: a convolution with
#: circular padding, (input channels, output channels, kernel extent per
#: axis). div reads its (n, 3, X, Y, Z) input as it is; grad_lap's channels
#: are the three derivatives, then the Laplacian
FD_LIBRARY = {"lap": (1, 1, (1, 1, 1)), "grad": (1, 3, (1, 1, 1)),
              "pdx": (1, 1, (1, 0, 0)), "pdy": (1, 1, (0, 1, 0)),
              "pdz": (1, 1, (0, 0, 1)), "div": (3, 1, (1, 1, 1)),
              "grad_lap": (1, 4, (1, 1, 1))}


def fd_library_conv(fd, op, device="cuda", dtype=torch.float32):
    """The yardstick of K12 operator ``op``: ``torch.nn.Conv3d`` with
    ``padding_mode="circular"`` (one call; the port never calls it) whose
    weights are the operator's stencil -- cross-correlation, so weight h + s
    of an axis multiplies the tap at +s. Input (C, channels in, X, Y, Z),
    output (C, channels out, X, Y, Z) (:func:`fd_library_io`). cuDNN's
    default TF32 is off for it (the caller sets
    ``torch.backends.cudnn.allow_tf32 = False``)."""
    nin, nout, axes = FD_LIBRARY[op]
    h = fd.h
    size = tuple(2 * h + 1 if a else 1 for a in axes)
    conv = torch.nn.Conv3d(nin, nout, size,
                           padding=tuple(h * a for a in axes),
                           padding_mode="circular", bias=False,
                           device=device, dtype=dtype)
    w = torch.zeros((nout, nin) + size, dtype=torch.float64)
    centre = tuple(h * a for a in axes)

    def at(d, s):  # the weight index of offset s along axis d
        i = list(centre)
        i[d] += s
        return tuple(i)

    def lap(k):
        for s, c in fd.second.coefs.items():
            for d in range(3):
                if s == 0:
                    w[(k, 0) + centre] = c * sum(fd._inv_dx2)
                else:
                    w[(k, 0) + at(d, s)] += c * fd._inv_dx2[d]
                    w[(k, 0) + at(d, -s)] += c * fd._inv_dx2[d]

    def derivative(k, j, d):  # output k, input j, along axis d
        for s, c in fd.first.coefs.items():
            w[(k, j) + at(d, s)] += c * fd._inv_dx[d]
            w[(k, j) + at(d, -s)] -= c * fd._inv_dx[d]
    if op in ("lap", "grad_lap"):
        lap(nout - 1)
    if op in ("grad", "grad_lap"):
        for d in range(3):
            derivative(d, 0, d)
    elif op == "div":
        for d in range(3):
            derivative(0, d, d)
    elif op != "lap":
        derivative(0, 0, axes.index(1))
    with torch.no_grad():
        conv.weight.copy_(w.to(dtype))
    return conv


def fd_library_io(op, x, outs):
    """The convolution's input for the kernel's (C, X, Y, Z) input ``x``,
    and the kernel's outputs ``outs`` laid out as the convolution's
    output."""
    nin = FD_LIBRARY[op][0]
    lat = tuple(x.shape[1:])
    xin = x.view((x.shape[0] // nin, nin) + lat)
    if op == "grad_lap":
        return xin, torch.cat([outs[0], outs[1].unsqueeze(1)], dim=1)
    return xin, outs[0].view((xin.shape[0], -1) + lat)


#: fd_lap's row at the shape the wave path launches it (one component,
#: (1, 512^3) f32); the K12 rows under their own names are at (2, 512^3)
FD_LAP_ONE = "fd_lap:one_component"


def time_fd_kernels(phase, timing, errs):
    """Each K12 operator at (2, 512^3) f32, h = 2 (the divergence on (2, 3,
    512^3)), and fd_lap at the wave path's (1, 512^3) as FD_LAP_ONE (held
    to its plain version there into ``errs``): CUDA-event ms over 20
    launches, its plain version, the bound (each component-array once in
    and once out over the HBM rate, against the operations over the f32
    peak) and, for the operators one PyTorch call computes (FD_LIBRARY),
    that call's time and its gap from the kernel, with cuDNN's TF32 off."""
    import pystella_tpu_torch as pt
    from pystella_tpu_torch.ops import derivs
    torch.backends.cudnn.allow_tf32 = False
    fd = pt.FiniteDifferencer(HALO, WAVE_BOX / GRID[0])
    for seed, op in enumerate(derivs.OPS):
        x = fd_input(op, GRID, torch.float32, 60 + seed)
        time_fd_op(phase, fd, op, x, "fd_" + op, timing)
        del x
        torch.cuda.empty_cache()
    x = fd_input("lap", GRID, torch.float32, 67, C=1)
    out = fd.launch("lap", x)[0]
    torch.cuda.synchronize()
    rel, abs_ = rel_err(out, fd.plain("lap", x)[0])
    row = {"max_rel_err": rel, "max_abs_err": abs_,
           "tol": KERNEL_TOL[torch.float32]}
    errs.setdefault(FD_LAP_ONE, {})[case_tag(GRID, torch.float32)] = row
    del out
    if not rel <= KERNEL_TOL[torch.float32]:
        raise SystemExit(f"fd_lap disagrees with its plain version at "
                         f"{tuple(x.shape)}: {row}")
    time_fd_op(phase, fd, "lap", x, FD_LAP_ONE, timing)
    del x
    torch.cuda.empty_cache()


def time_fd_op(phase, fd, op, x, name, timing):
    """:func:`time_fd_kernels` for operator ``op`` on the input ``x``, its
    row under ``name``."""
    from pystella_tpu_torch.ops import derivs
    sites = math.prod(GRID)
    ms = cuda_ms(lambda: fd.launch(op, x), reps=20, warmup=2)
    # a march's per-site build beside it
    per_site = {} if op not in FD_MARCHED else {"per_site_ms": per_site_ms(
        derivs.build_kernels(fd.h), fd_build(fd.h, FD_PER_SITE),
        [(op, x.dtype, 0)], lambda: fd.launch(op, x), 20)}
    torch.cuda.empty_cache()
    plain_ms = cuda_ms(lambda: fd.plain(op, x), reps=3)
    library = {"library_ms": None}
    if op in FD_LIBRARY:
        conv = fd_library_conv(fd, op)
        xin, ref = fd_library_io(op, x, fd.launch(op, x))
        with torch.no_grad():
            library["library_ms"] = cuda_ms(lambda: conv(xin), reps=5)
            got = conv(xin)
        library["library_call"] = (
            f"torch.nn.Conv3d({conv.in_channels}, {conv.out_channels}, "
            f"{tuple(conv.kernel_size)}, padding_mode='circular')")
        library["library_rel_err_vs_kernel"] = rel_err(got, ref)[0]
        library["cudnn_allow_tf32"] = torch.backends.cudnn.allow_tf32
        del conv, got, ref
        torch.cuda.empty_cache()
        # a yardstick that computes another function times nothing
        if not library["library_rel_err_vs_kernel"] <= LIBRARY_TOL:
            raise SystemExit(f"{name}: the library call disagrees with the "
                             f"kernel: {library}")
    C = x.shape[0]
    nbytes = round(C * (1 + FD_OUT_PER_IN[op])) * sites * 4
    ops = C * FD_OPS_PER_COMPONENT[op](HALO) * sites
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / PEAK_F32_OPS * 1e3
    bound = max(bytes_ms, ops_ms)
    timing[name] = {
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "bytes": nbytes, "ops": ops, "share_of_bound": bound / ms,
        **per_site, **library}
    emit({"phase": phase, "kernel": name, "shape": tuple(x.shape),
          "dtype": "torch.float32", "h": HALO, **timing[name]})


def wave_energy(fd, state):
    """The semi-discrete wave energy mean(dfdt^2 / 2 - f lap f / 2)."""
    f, dfdt = state["f"].double(), state["dfdt"].double()
    return (0.5 * dfdt * dfdt
            - 0.5 * f * fd.lap(state["f"]).double()).mean().item()


def wave_reference(phase):
    """The wave equation {f: f.dot, f.dot: lap f} through compile_rhs_dict
    and LowStorageRK54 (examples/wave_equation.py:49-55) at 64^3 f64 from a
    seeded sum of plane waves (modes <= 4): the kernel-mode drive vs the
    roll-mode drive after 40 steps, and the energy drift at dt against dt /
    2 over the same time (the order check of a conserved quantity)."""
    import pystella_tpu_torch as pt
    n = 64
    dx = WAVE_BOX / n
    g = torch.Generator(device="cuda").manual_seed(3)
    x = torch.arange(n, device="cuda", dtype=torch.float64) * dx
    X, Y, Z = torch.meshgrid(x, x, x, indexing="ij")
    f0 = torch.zeros((n,) * 3, device="cuda", dtype=torch.float64)
    modes = torch.randint(-4, 5, (12, 3), generator=g, device="cuda")
    phases = 2 * math.pi * torch.rand(12, generator=g, device="cuda",
                                      dtype=torch.float64)
    for (a, b, c), ph in zip(modes.tolist(), phases.tolist()):
        f0 += torch.sin(a * X + b * Y + c * Z + ph)
    field = pt.DynamicField("f")
    rhs = pt.compile_rhs_dict({field: field.dot, field.dot: field.lap})

    def drive(mode, dt, nsteps):
        fd = pt.FiniteDifferencer(HALO, dx, mode=mode)
        stepper = pt.LowStorageRK54(
            lambda st, t: rhs(st, t, lap_f=fd.lap(st["f"])))
        state = {"f": f0.clone(), "dfdt": torch.zeros_like(f0)}
        e0 = wave_energy(fd, state)
        for _ in range(nsteps):
            state = stepper.step(state, 0.0, dt)
        return state, abs(wave_energy(fd, state) - e0) / abs(e0)

    dt = 0.5 * dx
    kernel, drift = drive("kernel", dt, 40)
    roll, _ = drive("roll", dt, 40)
    _, drift_half = drive("kernel", dt / 2, 80)
    torch.cuda.synchronize()
    errs = {k: rel_err(kernel[k], roll[k])[0] for k in kernel}
    ratio = drift / drift_half
    emit({"phase": phase, "shape": (n,) * 3, "dtype": "torch.float64",
          "nsteps": 40, "rel_err_kernel_vs_roll": errs,
          "tol": WAVE_REFERENCE_TOL, "energy_drift": drift,
          "energy_drift_half_dt": drift_half, "drift_ratio": ratio,
          "drift_ratio_band": WAVE_DRIFT_RATIO})
    if not max(errs.values()) <= WAVE_REFERENCE_TOL:
        raise SystemExit(f"the kernel-mode wave drive disagrees with the "
                         f"roll-mode one: {errs}")
    if not WAVE_DRIFT_RATIO[0] <= ratio <= WAVE_DRIFT_RATIO[1]:
        raise SystemExit(f"wave energy drift ratio {ratio} outside "
                         f"{WAVE_DRIFT_RATIO}")


def wave_main_path(phase, launches):
    """bench.py:run_wave (RungeKutta4 over FiniteDifferencer.lap, h = 2,
    box (2 pi)^3, dt = 0.1 dx, f = N(0, 1), dfdt = 0) at 512^3 f32 instead
    of the bench's 64^3 (a 1 MiB lattice says nothing of the card): 5
    warm-up and 50 timed steps; then the operators a user takes
    observables with, on the final state: the batch call (grad_lap), grad,
    divergence and the three single derivatives, held against each other."""
    import pystella_tpu_torch as pt
    from pystella_tpu_torch.ops import derivs
    sites = math.prod(GRID)
    lattice = pt.Lattice(GRID, (WAVE_BOX,) * 3, dtype=np.float32)
    dt = float(np.float32(0.1 * min(lattice.dx)))
    fd = pt.FiniteDifferencer(HALO, lattice.dx)

    def rhs(state, t):
        return {"f": state["dfdt"], "dfdt": fd.lap(state["f"])}

    stepper = pt.RungeKutta4(rhs, dt=dt)
    g = torch.Generator(device="cuda").manual_seed(3)
    state = {"f": torch.randn(GRID, generator=g, device="cuda",
                              dtype=torch.float32),
             "dfdt": torch.zeros(GRID, device="cuda", dtype=torch.float32)}
    # the Laplacian at the path's shape (one component), for its share
    lap_ms = cuda_ms(lambda: fd.lap(state["f"]), reps=20, warmup=2)
    torch.cuda.reset_peak_memory_stats()
    derivs.reset_launch_counts()
    e0 = wave_energy(fd, state)
    for _ in range(WAVE_WARMUP):
        state = stepper.step(state, 0.0, dt)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    host0 = time.perf_counter()
    start.record()
    for _ in range(WAVE_STEPS):
        state = stepper.step(state, 0.0, dt)
    end.record()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - host0
    elapsed = start.elapsed_time(end) / 1e3
    e1 = wave_energy(fd, state)

    # observables of the final state
    f = state["f"]
    both = fd(f, lap=True, grd=True)
    lap, grad = fd.lap(f), fd.grad(f)
    pds = [fd.pdx(f), fd.pdy(f), fd.pdz(f)]
    div = fd.divergence(grad)
    div_pd = fd.pdx(grad[0]) + fd.pdy(grad[1]) + fd.pdz(grad[2])
    torch.cuda.synchronize()
    path_launches = {k: v for k, v in derivs.LAUNCHES.items() if v}
    launches.update(path_launches)
    nsteps = WAVE_WARMUP + WAVE_STEPS
    # 4 stages a step, the two energies and the observables' Laplacian
    expected = {"fd_lap": 4 * nsteps + 3, "fd_grad_lap": 1, "fd_grad": 1,
                "fd_div": 1, "fd_pdx": 2, "fd_pdy": 2, "fd_pdz": 2}
    checks = {
        "grad_lap_grad_equals_grad": torch.equal(both["grd"], grad),
        "grad_lap_lap_equals_lap": torch.equal(both["lap"], lap),
        "pd_equals_grad_components": all(
            torch.equal(pd, grad[d]) for d, pd in enumerate(pds)),
        "div_grad_vs_sum_of_pd_rel_err": rel_err(div, div_pd)[0]}
    drift = (e1 - e0) / abs(e0)
    finite = all(bool(torch.isfinite(v).all()) for v in state.values())
    shapes_ok = all(tuple(v.shape) == GRID for v in state.values())
    ms_step = elapsed / WAVE_STEPS * 1e3
    emit({"phase": phase, "grid": GRID, "dtype": "torch.float32",
          "stepper": "RungeKutta4", "h": HALO,
          "source": "bench.py:480-508 at n = 512 (the bench runs 64^3)",
          "nsteps_timed": WAVE_STEPS, "ms_per_step": ms_step,
          "site_updates_per_s": sites * WAVE_STEPS / elapsed,
          "host_s": host_s, "device_s": elapsed,
          "launches": path_launches, "expected_launches": expected,
          # 4 Laplacians a step at the separately timed cost, over the step
          "fd_lap_share_est": 4 * lap_ms / ms_step,
          "fd_lap_ms_at_path_shape": lap_ms,
          "peak_memory_GiB": torch.cuda.max_memory_allocated() / 2**30,
          "energy0": e0, "energy1": e1, "energy_drift": drift,
          "energy_tol": WAVE_ENERGY_TOL, "finite": finite, **checks})
    if not (finite and shapes_ok):
        raise SystemExit(f"{phase} produced a non-finite or misshapen state")
    if not -WAVE_ENERGY_TOL <= drift <= 1e-6:
        raise SystemExit(f"{phase}: wave energy moved by {drift}")
    if path_launches != expected:
        raise SystemExit(f"{phase} launched {path_launches}, not "
                         f"{expected}")
    if not (checks["grad_lap_grad_equals_grad"]
            and checks["grad_lap_lap_equals_lap"]
            and checks["pd_equals_grad_components"]
            and checks["div_grad_vs_sum_of_pd_rel_err"]
            <= KERNEL_TOL[torch.float32]):
        raise SystemExit(f"{phase}: the operators disagree with each "
                         f"other: {checks}")


# -- the multigrid solver (K11) -----------------------------------------------

def mg_problem(kind):
    """``"newton"``: the bench's nonlinear problem lap f - f + f**3 = rho
    (NewtonIterator, omega = 2/3); ``"jacobi"``: the tests' Poisson +
    Helmholtz pair (JacobiIterator, omega = 1/2)."""
    import pystella_tpu_torch as pt
    fld = pt.Field
    if kind == "newton":
        f = fld("f")
        return (pt.NewtonIterator,
                {f: (fld("lap_f") - f + f**3, fld("rho"))}, MG_OMEGA)
    return (pt.JacobiIterator,
            {fld("f"): (fld("lap_f"), fld("rho")),
             fld("f2"): (fld("lap_f2") - fld("f2"), fld("rho2"))}, 1 / 2)


def mg_solver(kind, smoother=None, solver_cls=None, device="cuda"):
    cls, lhs, omega = mg_problem(kind)
    return (solver_cls or cls)(lhs, halo_shape=MG_HALO, omega=omega,
                               smoother=smoother, device=device)


def mg_arrays(solver, shape, dtype, seed):
    """Seeded zero-mean uniform unknowns and sources of a level."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def one():
        a = torch.rand(tuple(shape), generator=g, device="cuda", dtype=dtype)
        return a - a.mean()
    fs = {n: one() for n in solver.f_to_rho_dict}
    rhos = {r: one() for r in solver.f_to_rho_dict.values()}
    return fs, rhos


def mg_kernels_vs_plain(phase, cases, errs):
    """mg_smooth (1 and 3 sweeps), mg_residual and mg_tau vs the plain
    version, for the Newton problem (nf = 1) and the Jacobi pair (nf = 2),
    at every (shape, dtype) of ``cases``; and bit for bit, the launch of
    the default build (the march on a region of
    ``mg_tile``'s threshold, else per site), of a build that marches every
    level and of one that runs every level per site against each other."""
    from pystella_tpu_torch.multigrid.relax import LevelSpec
    for kind in ("newton", "jacobi"):
        kernel, plain = mg_solver(kind), mg_solver(kind, "plain")
        fns = kernel.build_kernels()
        builds = {"march": mg_build(kernel, MG_MARCH_ALL),
                  "per_site": mg_build(kernel, MG_PER_SITE)}
        for shape, dtype in cases:
            level = LevelSpec(tuple(shape), (MG_BOX / shape[0],) * 3)
            fs, rhos = mg_arrays(kernel, shape, dtype, 70)
            rr = {n: rhos[r] for n, r in kernel.f_to_rho_dict.items()}
            runs = {
                "mg_smooth": [lambda s: s.smooth(level, fs, rhos, {}, 1),
                              lambda s: s.smooth(level, fs, rhos, {}, 3)],
                "mg_residual": [lambda s: s.residual(level, fs, rhos, {})],
                "mg_tau": [lambda s: s.tau_rhs(level, fs, rr, {})]}
            for name, calls in runs.items():
                per_output, same = [], {"march": True, "per_site": True}
                keys = [(name, dtype, 0)]
                for call in calls:
                    got, ref = call(kernel), call(plain)
                    for b, other in builds.items():
                        with swapped(fns, other, keys):
                            alt = call(kernel)
                        same[b] = same[b] and all(
                            torch.equal(got[n], alt[n]) for n in got)
                        del alt
                    torch.cuda.synchronize()
                    per_output += [rel_err(got[n], ref[n]) for n in ref]
                    del got, ref
                row = {"max_rel_err": max(r for r, _ in per_output),
                       "max_abs_err": max(a for _, a in per_output),
                       "tol": KERNEL_TOL[dtype],
                       "marches": kernel_marches(kernel, shape, dtype),
                       "bitwise_march_every_level": same["march"],
                       "bitwise_per_site": same["per_site"]}
                tag = case_tag(shape, dtype) + ":" + kind
                errs.setdefault(name, {})[tag] = row
                emit({"phase": phase, "kernel": name, "problem": kind,
                      "nf": len(fs), "shape": shape, "dtype": str(dtype),
                      **row})
                if not (row["max_rel_err"] <= KERNEL_TOL[dtype]
                        and same["march"] and same["per_site"]):
                    raise SystemExit(f"{name} ({kind}) disagrees with its "
                                     f"plain version or the march with the "
                                     f"per-site kernel at {shape} {dtype}: "
                                     f"{row}")
            del fs, rhos, rr
            torch.cuda.empty_cache()


def kernel_marches(solver, shape, dtype):
    """Whether ``solver``'s default build marches a launch over ``shape``
    (``mg_tile``)."""
    from pystella_tpu_torch.multigrid import relax
    return relax.mg_tile(solver.halo_shape, dtype.itemsize,
                         len(solver.f_to_rho_dict), shape) is not None


def mg_ops_per_site(solver, name):
    """Arithmetic of one sweep per site, counted from the generated header:
    the Laplacian (1 + 9h) per unknown plus the printed update (for tau,
    plus the added restricted residual)."""
    fn = {"mg_smooth": "mg_step", "mg_residual": "mg_resid",
          "mg_tau": "mg_lhs"}[name]
    body = solver.kernel_header().split(f"void {fn}(")[1].split("}")[0]
    printed = sum(body.count(op) for op in (" * ", " + ", " / ", " - ",
                                            "pk_"))
    nf = len(solver.f_to_rho_dict)
    return nf * (1 + 9 * solver.halo_shape) + printed + (
        nf if name == "mg_tau" else 0)


def time_mg_kernels(phase, timing):
    """Each K11 kernel at 512^3 f32 for the Newton problem (the main
    path's) and the Jacobi pair: CUDA-event ms per launch (the sweep over
    20 ping-ponged sweeps of one call), the plain version, and the bound
    (nf unknowns and nf sources in, nf out)."""
    from pystella_tpu_torch.multigrid.relax import LevelSpec
    sites = math.prod(GRID)
    level = LevelSpec(GRID, (MG_BOX / GRID[0],) * 3)
    for kind in ("newton", "jacobi"):
        kernel, plain = mg_solver(kind), mg_solver(kind, "plain")
        fns, per_site = kernel.build_kernels(), mg_build(kernel, MG_PER_SITE)
        fs, rhos = mg_arrays(kernel, GRID, torch.float32, 80)
        rr = {n: rhos[r] for n, r in kernel.f_to_rho_dict.items()}
        nf = len(fs)
        calls = {
            "mg_smooth": (lambda s, nu: s.smooth(level, fs, rhos, {}, nu),
                          20),
            "mg_residual": (lambda s, nu: s.residual(level, fs, rhos, {}),
                            1),
            "mg_tau": (lambda s, nu: s.tau_rhs(level, fs, rr, {}), 1)}
        for name, (call, nu) in calls.items():
            ms = cuda_ms(lambda: call(kernel, nu), reps=20 // nu,
                         warmup=1) / nu
            # the per-site kernel beside the march
            with swapped(fns, per_site, [(name, torch.float32, 0)]):
                site_ms = cuda_ms(lambda: call(kernel, nu), reps=20 // nu,
                                  warmup=1) / nu
            torch.cuda.empty_cache()
            plain_ms = cuda_ms(lambda: call(plain, 1), reps=3)
            nbytes = 3 * nf * sites * 4
            ops = mg_ops_per_site(kernel, name) * sites
            bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
            ops_ms = ops / PEAK_F32_OPS * 1e3
            bound = max(bytes_ms, ops_ms)
            row = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                   "bound_by": "bytes" if bytes_ms >= ops_ms
                   else "operations", "bytes": nbytes, "ops": ops,
                   "share_of_bound": bound / ms,
                   "marches": kernel_marches(kernel, GRID, torch.float32),
                   "per_site_ms": site_ms}
            timing[name if kind == "newton" else f"{name}:{kind}"] = row
            emit({"phase": phase, "kernel": name, "problem": kind, "nf": nf,
                  "shape": GRID, "dtype": "torch.float32", **row})
        del fs, rhos, rr
        torch.cuda.empty_cache()


def mg_reference(phase):
    """tests/test_multigrid.py:33-72 on the card at 32^3 f64: the four
    Solver x MG combinations on Poisson + Helmholtz converge in 10 default
    V-cycles; and one kernel-tier cycle against one plain-tier cycle,
    solution and every recorded error."""
    import pystella_tpu_torch as pt
    shape = SMALL
    dx = MG_BOX / shape[0]
    for solver_cls in (pt.NewtonIterator, pt.JacobiIterator):
        solver = mg_solver("jacobi", solver_cls=solver_cls)
        fs, rhos = mg_arrays(solver, shape, torch.float64, 90)
        for mg_cls in (pt.FullApproximationScheme, pt.MultiGridSolver):
            mg = mg_cls(solver=solver, halo_shape=MG_HALO)
            sol = dict(fs)
            for _ in range(10):
                errs, sol = mg(dx0=dx, **sol, **rhos)
            final = {n: e[1] for n, e in errs[-1][1].items()}
            emit({"phase": phase, "solver": solver_cls.__name__,
                  "mg": mg_cls.__name__, "shape": shape,
                  "dtype": "torch.float64", "cycles": 10,
                  "final_l2_residual": final, "tol": MG_CONVERGED_TOL})
            if not max(final.values()) < MG_CONVERGED_TOL:
                raise SystemExit(f"{mg_cls.__name__} over "
                                 f"{solver_cls.__name__} did not converge: "
                                 f"{final}")
    res = {}
    for smoother in ("kernel", "plain"):
        solver = mg_solver("jacobi", smoother)
        fs, rhos = mg_arrays(solver, shape, torch.float64, 90)
        res[smoother] = pt.FullApproximationScheme(solver=solver)(
            dx0=dx, **fs, **rhos)
    (e_k, s_k), (e_p, s_p) = res["kernel"], res["plain"]
    sol_err = max(rel_err(s_k[n], s_p[n])[0] for n in s_p)
    err_err = max(abs(a - b) / abs(b) for (_, got), (_, ref) in zip(e_k, e_p)
                  for n in ref for a, b in zip(got[n], ref[n]))
    emit({"phase": phase, "check": "kernel-tier cycle vs plain-tier cycle",
          "shape": shape, "dtype": "torch.float64",
          "solution_rel_err": sol_err, "recorded_errors_rel_err": err_err,
          "entries": len(e_k), "tol": MG_CYCLE_TOL})
    if not (sol_err <= MG_CYCLE_TOL and err_err <= MG_CYCLE_TOL
            and len(e_k) == len(e_p)):
        raise SystemExit(f"the kernel-tier cycle disagrees with the "
                         f"plain-tier one: {sol_err}, {err_err}")


def mg_main_path(phase, timing, launches, trace):
    """bench.py:run_multigrid as it stands: FAS over NewtonIterator on lap
    f - f + f**3 = rho at 512^3 f32 (h = 1, omega = 2/3, dx = 10 / n, rho a
    zero-mean N(0, 1), f = 0, the default V-cycle v_cycle(25, 50, 6)): one
    warm-up and two timed cycles, then one more under torch.profiler.
    Returns the solution after the three cycles, rho, the residuals and
    the ms per cycle (the sharded paths' reference)."""
    import pystella_tpu_torch as pt
    from pystella_tpu_torch.multigrid import relax
    sites = math.prod(GRID)
    dx = MG_BOX / GRID[0]
    solver = mg_solver("newton")
    mg = pt.FullApproximationScheme(solver=solver, halo_shape=MG_HALO)
    g = torch.Generator(device="cuda").manual_seed(11)
    rho = torch.randn(GRID, generator=g, device="cuda", dtype=torch.float32)
    rho -= rho.mean()
    f = torch.zeros(GRID, device="cuda", dtype=torch.float32)
    depth = max(1, int(np.log2(min(GRID) / 8)))
    cycle = pt.v_cycle(25, 50, depth)
    per_cycle = {"mg_smooth": sum(nu for _, nu in cycle),
                 "mg_residual": 2 * len(cycle) + depth, "mg_tau": depth}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    relax.reset_launch_counts()
    residuals = []
    errs, sol = mg(dx0=dx, f=f, rho=rho)  # warm-up cycle
    f = sol["f"]
    residuals.append(errs[-1][1]["f"][1])
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    host0 = time.perf_counter()
    start.record()
    for _ in range(MG_CYCLES):
        errs, sol = mg(dx0=dx, f=f, rho=rho)
        f = sol["f"]
        residuals.append(errs[-1][1]["f"][1])
    end.record()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - host0
    device_s = start.elapsed_time(end) / 1e3
    path_launches = {k: v for k, v in relax.LAUNCHES.items() if v}
    launches.update(path_launches)
    expected = {k: (1 + MG_CYCLES) * v for k, v in per_cycle.items()}
    finite = bool(torch.isfinite(f).all()) and all(
        math.isfinite(r) for r in residuals)
    falling = all(b < a for a, b in zip(residuals, residuals[1:]))
    # the last cycle's record, level by level: (level, sweeps, L2 residual
    # before, after)
    record = [(lvl, nu, errs[2 * k][1]["f"][1], errs[2 * k + 1][1]["f"][1])
              for k, (lvl, nu) in enumerate(cycle)]
    ms_cycle = device_s / MG_CYCLES * 1e3
    emit({"phase": phase, "grid": GRID, "dtype": "torch.float32",
          "source": "bench.py:765-801", "cycle": f"v_cycle(25, 50, {depth})",
          "levels": [GRID[0] >> i for i in range(depth + 1)],
          "cycles_timed": MG_CYCLES, "ms_per_cycle": ms_cycle,
          "host_s": host_s, "device_s": device_s,
          "site_sweeps_per_s": sites * 75 * MG_CYCLES / device_s,
          "launches": path_launches, "expected_launches": expected,
          # the level-0 sweeps, residuals and tau at the separately timed
          # per-launch cost, over the cycle: what the finest level's
          # kernels take of it
          "level0_kernel_share_est": (
              75 * timing["mg_smooth"]["ms"]
              + 5 * timing["mg_residual"]["ms"]) / ms_cycle,
          "l2_residual_after_each_cycle": residuals,
          "last_cycle_record": record,
          "peak_memory_GiB": torch.cuda.max_memory_allocated() / 2**30,
          "finite": finite, "falling": falling})
    if not finite or tuple(f.shape) != GRID:
        raise SystemExit(f"{phase} produced a non-finite or misshapen "
                         "solution")
    if not falling:
        raise SystemExit(f"{phase}: the residual did not fall from cycle to "
                         f"cycle: {residuals}")
    if path_launches != expected:
        raise SystemExit(f"{phase} launched {path_launches}, not "
                         f"{expected}")
    emit({"phase": trace, **trace_chunk(
        lambda: mg(dx0=dx, f=f, rho=rho), device_s / MG_CYCLES),
        "steps": mg_step_times(mg, lambda: mg(dx0=dx, f=f, rho=rho))})
    return f, rho, residuals, ms_cycle


def mg_step_times(mg, run):
    """One more cycle with a CUDA-event pair and a host-clock pair around
    every step of it (a level visit: the sweeps and the two error records;
    a transfer down or up): ``[step, level, device ms, host ms]`` in cycle
    order. The host time is what enqueueing the step took; where it passes
    the device time, the device waits unless the host was ahead."""
    marks = []

    def timed(name):
        inner = getattr(mg, name)

        def step(levels, i, *args):
            begin = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            host0 = time.perf_counter()
            begin.record()
            out = inner(levels, i, *args)
            end.record()
            marks.append((name, i, begin, end, time.perf_counter() - host0))
            return out
        setattr(mg, name, step)

    steps = ("smooth", "transfer_down", "transfer_up")
    for name in steps:
        timed(name)
    try:
        run()
        torch.cuda.synchronize()
    finally:
        for name in steps:
            delattr(mg, name)  # the instance's wrapper; the method stays
    return [(name, i, begin.elapsed_time(end), host_s * 1e3)
            for name, i, begin, end, host_s in marks]


# -- the multigrid solver on sharded levels (K11 padded, interior, shell) -----

#: the sharded multigrid main paths: (mesh, overlap), every shard on the
#: one card; each final f bit-equal to mg_main_path's. overlap None is the
#: solver's default (auto: the split on the 512^3 level's blocks only)
SHARDED_MG_CONFIGS = [((2, 1, 1), True), ((2, 1, 1), False),
                      ((2, 1, 1), None), ((2, 2, 1), False),
                      ((1, 2, 1), False)]
#: the identity phase: 256^3 f64 (the L2 records held to 1e-13), FAS over
#: the bench problem with the default cycle on (1, 2, 1) and (2, 2, 1), a
#: cycle one level deeper on (4, 1, 1) (its 4^3 level's blocks are 1 wide:
#: replicated), and the linear MultiGridSolver over the Jacobi pair on
#: (2, 1, 1) overlapped: (mesh, overlap, problem, scheme, depth)
MG_IDENTITY_SHAPE = (256, 256, 256)
MG_IDENTITY_CASES = [((1, 2, 1), False, "newton", "FullApproximationScheme",
                      5),
                     ((2, 2, 1), False, "newton", "FullApproximationScheme",
                      5),
                     ((4, 1, 1), True, "newton", "FullApproximationScheme",
                      6),
                     ((2, 1, 1), True, "jacobi", "MultiGridSolver", 5)]
#: the sharded L2 records: per-block sums added in rank order
MG_L2_TOL = 1e-13
MG_KINDS = ("xpad", "ypad", "xypad", "interior", "shell")


def sharded_mg_kernel_names():
    """``mg_<kind>:<launch kind>`` of every sharded K11 launch."""
    from pystella_tpu_torch.multigrid import relax
    return list(relax.SHARDED_KERNELS)


def mg_padded_window(t, hx, hy):
    """An (X, Y, Z) lattice padded by its own periodic rows: a sharded
    level's window when one block is the whole lattice."""
    return pad_periodic(t[None], hx, hy)[0].contiguous()


def mg_block_case(kind, shape, dtype, seed):
    """A solver of ``kind`` and seeded unknowns, sources and restricted
    residuals (as lists in the unknowns' order) on a lattice held whole."""
    from pystella_tpu_torch.multigrid.relax import LevelSpec
    solver = mg_solver(kind)
    fs, rhos = mg_arrays(solver, shape, dtype, seed)
    names = list(solver.f_to_rho_dict)
    rr = [rhos[solver.f_to_rho_dict[n]].flip(0).contiguous()
          for n in names]
    level = LevelSpec(tuple(shape), (MG_BOX / shape[0],) * 3)
    return (solver, level, [fs[n] for n in names],
            {"smooth": [rhos[solver.f_to_rho_dict[n]] for n in names],
             "residual": [rhos[solver.f_to_rho_dict[n]] for n in names],
             "tau": rr})


def sharded_mg_kernels_vs_plain(phase, errs):
    """Each sharded K11 launch of ``mg_smooth``, ``mg_residual`` and
    ``mg_tau`` on lattices held whole and windows built from their own
    periodic rows: ``:xpad``, ``:ypad``, ``:xypad`` against their plain
    versions on the same windows and bit for bit against the unpadded
    launch on the whole lattice; ``:interior`` (the raw block) and the two
    ``:shell`` launches (``(3h, Y, Z)`` slabs) against their plain
    versions on their regions, and together bit for bit against the
    x-padded launch. The Newton problem (nf = 1) and the Jacobi pair (nf =
    2); f32 at the block each kind runs on in the 512^3 paths, f32 and f64
    at 48x40x36. Rows go to ``errs["mg_<kind>:<launch kind>"]``."""
    h = MG_HALO
    cases = [(block_of(SHARDED_KIND_MESH[k]), torch.float32, (k,))
             for k in ("xpad", "ypad", "xypad")]
    cases[0] = cases[0][:2] + (("xpad", "interior", "shell"),)
    cases += [(ALT_SHAPES[1], dtype, MG_KINDS)
              for dtype in (torch.float32, torch.float64)]
    for problem in ("newton", "jacobi"):
        for shape, dtype, kinds in cases:
            solver, level, fs, rhos = mg_block_case(problem, shape, dtype,
                                                    60)
            X = shape[0]
            for kind in ("smooth", "residual", "tau"):
                name = f"mg_{kind}"

                def new():
                    return [torch.empty_like(f) for f in fs]
                ref = solver.launch_block(kind, level, fs, rhos[kind], {},
                                          new())
                rows = {}
                for pad in ("xpad", "ypad", "xypad"):
                    if pad not in kinds:
                        continue
                    hx = h if pad != "ypad" else 0
                    hy = h if pad != "xpad" else 0
                    wins = [mg_padded_window(f, hx, hy) for f in fs]
                    outs = solver.launch_block(kind, level, wins,
                                               rhos[kind], {}, new(), pad)
                    torch.cuda.synchronize()
                    plain = solver.plain(kind, level, wins, rhos[kind], {},
                                         {}, pad=(hx, hy))
                    e = [rel_err(o, q) for o, q in zip(outs, plain)]
                    rows[pad] = {
                        "max_rel_err": max(a for a, _ in e),
                        "max_abs_err": max(b for _, b in e),
                        "tol": KERNEL_TOL[dtype],
                        "bitwise_unsharded_kernel": all(
                            torch.equal(o, r) for o, r in zip(outs, ref))}
                    del wins, outs, plain
                if "interior" in kinds:
                    padded = [mg_padded_window(f, h, 0) for f in fs]
                    lows = [t[:3 * h].contiguous() for t in padded]
                    highs = [t[X - h:X + 2 * h].contiguous() for t in padded]
                    del padded
                    outs = new()
                    solver.launch_block(kind, level, fs, rhos[kind], {},
                                        outs, "interior", h)
                    solver.launch_block(kind, level, lows, rhos[kind], {},
                                        outs, "shell", 0)
                    solver.launch_block(kind, level, highs, rhos[kind], {},
                                        outs, "shell", X - h)
                    torch.cuda.synchronize()
                    bitwise = all(torch.equal(o, r)
                                  for o, r in zip(outs, ref))
                    for launch, pieces in (
                            ("interior", [(fs, h, X - h)]),
                            ("shell", [(lows, 0, h), (highs, X - h, X)])):
                        e = []
                        for wins, a, b in pieces:
                            plain = solver.plain(
                                kind, level, wins,
                                [r[a:b] for r in rhos[kind]], {}, {},
                                pad=(h, 0))
                            e += [rel_err(o[a:b], q)
                                  for o, q in zip(outs, plain)]
                        rows[launch] = {
                            "max_rel_err": max(a for a, _ in e),
                            "max_abs_err": max(b for _, b in e),
                            "tol": KERNEL_TOL[dtype],
                            "interior_and_shells_bitwise_unsharded": bitwise}
                    del outs, lows, highs
                for launch, row in rows.items():
                    key = f"{name}:{launch}"
                    errs.setdefault(key, {})[
                        case_tag(shape, dtype) + ":" + problem] = row
                    emit({"phase": phase, "kernel": key, "problem": problem,
                          "shape": shape, "dtype": str(dtype), **row})
                    exact = row.get(
                        "bitwise_unsharded_kernel",
                        row.get("interior_and_shells_bitwise_unsharded"))
                    if not (row["max_rel_err"] <= KERNEL_TOL[dtype]
                            and exact):
                        raise SystemExit(f"{key} ({problem}) disagrees at "
                                         f"{shape} {dtype}: {row}")
                del ref
            del solver, fs, rhos
            torch.cuda.empty_cache()


def mg_expected_launches(mg, cycle, shape, dx):
    """Launches by counted name of one cycle of ``mg``: per level visit
    ``nu`` sweeps and two residuals (the error records), per transfer down
    a residual on the finer level and a tau on the coarser (the linear
    scheme: no tau); each a launch per block and kind on a sharded level
    (the solver's ``level_kinds``), one unsharded launch on a replicated
    one."""
    import pystella_tpu_torch as pt
    solver = mg.solver
    d = solver.decomp
    depth = max(i for i, _ in cycle)
    levels = mg._make_levels(shape, dx, depth)
    fas = not isinstance(mg, pt.MultiGridSolver)
    out = {}

    def add(name, i, n=1):
        lv = levels[i]
        if not lv.sharded:
            out[name] = out.get(name, 0) + n
            return
        for k, c in solver.level_kinds(lv).items():
            key = name + ("" if k is None else f":{k}")
            out[key] = out.get(key, 0) + n * c * d.nshards

    previous = cycle[0][0]
    for j, (i, nu) in enumerate(cycle):
        if j and i == previous + 1:
            add("mg_residual", previous)
            if fas:
                add("mg_tau", i)
        add("mg_smooth", i, nu)
        add("mg_residual", i, 2)
        previous = i
    return out


def time_sharded_mg_kernels(phase, timing, per_cycle):
    """Each sharded K11 launch of the Newton problem at the block its kind
    runs on in the 512^3 paths (f32; the interior and one shell launch
    alone): CUDA-event ms over 20 launches, its plain version, and the
    bound: the window at its padded storage extent, rho (or the restricted
    residual) and the output over the computed region, each once, over the
    HBM rate, against the operations over the f32 peak. ``per_cycle``: the
    launches of one V-cycle on its main path. The per-site kernel beside
    each."""
    from pystella_tpu_torch.ops.derivs import PAD_KINDS
    h = MG_HALO
    for seed, name in enumerate(sharded_mg_kernel_names()):
        kind, launch = name.split(":")
        kind = kind[3:]
        shape = block_of(SHARDED_KIND_MESH[launch])
        solver, level, fs, rhos = mg_block_case("newton", shape,
                                                torch.float32, 90 + seed)
        X = shape[0]
        hx = h if launch != "ypad" else 0
        hy = h if launch in ("ypad", "xypad") else 0
        if launch == "interior":
            wins, x0 = fs, h
        elif launch == "shell":
            wins = [mg_padded_window(f, h, 0)[:3 * h].contiguous()
                    for f in fs]
            x0 = 0
        else:
            wins, x0 = [mg_padded_window(f, hx, hy) for f in fs], 0
        outs = [torch.empty_like(f) for f in fs]

        def run():
            return solver.launch_block(kind, level, wins, rhos[kind], {},
                                       outs, launch, x0)
        ms = cuda_ms(run, reps=20, warmup=2)
        site_ms = per_site_ms(
            solver.build_kernels(), mg_build(solver, MG_PER_SITE),
            [(f"mg_{kind}", torch.float32, PAD_KINDS[launch])], run, 20)
        rows = {"interior": X - 2 * h, "shell": h}.get(launch, X)
        plain_ms = cuda_ms(lambda: solver.plain(
            kind, level, wins, [r[x0:x0 + rows] for r in rhos[kind]], {},
            {}, pad=(hx, hy)), reps=3)
        region = rows * shape[1] * shape[2]
        nf = len(fs)
        nbytes = 4 * nf * (wins[0].numel() + 2 * region)
        ops = mg_ops_per_site(solver, f"mg_{kind}") * region
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / PEAK_F32_OPS * 1e3
        bound = max(bytes_ms, ops_ms)
        timing[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                        "bound_by": "bytes" if bytes_ms >= ops_ms
                        else "operations", "bytes": nbytes, "ops": ops,
                        "share_of_bound": bound / ms, "region_rows": rows,
                        "marches": kernel_marches(
                            solver, (rows,) + shape[1:], torch.float32),
                        "per_site_ms": site_ms,
                        "launches_per_cycle": per_cycle.get(name, 0)}
        emit({"phase": phase, "kernel": name, "block": shape,
              "dtype": "torch.float32", **timing[name]})
        del solver, fs, rhos, wins, outs
        torch.cuda.empty_cache()


def sharded_mg_main_path(phase, ref_f, rho, ref_residuals, single_ms,
                         launches):
    """mg_main_path's run (FAS over NewtonIterator, 512^3 f32, h = 1,
    omega = 2/3, v_cycle(25, 50, 6); one warm-up and two timed cycles from
    f = 0 and the same rho, sharded) on each of SHARDED_MG_CONFIGS, every
    shard on the one card: ms per V-cycle against the single-device cycle,
    site-sweeps/s, launches by kind against the expected count, exchanged
    bytes a cycle, peak memory, the L2 residual after each cycle (it must
    fall), and the final f bit-equal to the single-device path's. The
    first config that launches a kind gives its launch count."""
    import pystella_tpu_torch as pt
    from pystella_tpu_torch.multigrid import relax
    sites = math.prod(GRID)
    dx = MG_BOX / GRID[0]
    depth = max(1, int(np.log2(min(GRID) / 8)))
    cycle = pt.v_cycle(25, 50, depth)
    sweeps = sum(nu for _, nu in cycle)
    rows = {}
    for mesh, overlap in SHARDED_MG_CONFIGS:
        decomp = pt.DomainDecomposition(mesh)
        mg = pt.FullApproximationScheme(solver=mg_solver_on(
            "newton", decomp, overlap), halo_shape=MG_HALO)
        rho_s = decomp.shard(rho)
        f = decomp.zeros(GRID, torch.float32)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        relax.reset_launch_counts()
        residuals = []
        errs, sol = mg(dx0=dx, f=f, rho=rho_s)  # warm-up cycle
        f = sol["f"]
        residuals.append(errs[-1][1]["f"][1])
        bytes0 = decomp.bytes_exchanged
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        host0 = time.perf_counter()
        start.record()
        for _ in range(MG_CYCLES):
            errs, sol = mg(dx0=dx, f=f, rho=rho_s)
            f = sol["f"]
            residuals.append(errs[-1][1]["f"][1])
        end.record()
        torch.cuda.synchronize()
        host_s = time.perf_counter() - host0
        device_s = start.elapsed_time(end) / 1e3
        path_launches = {k: v for k, v in relax.LAUNCHES.items() if v}
        per_cycle = mg_expected_launches(mg, cycle, GRID, dx)
        expected = {k: (1 + MG_CYCLES) * v for k, v in per_cycle.items()}
        for k, v in path_launches.items():
            launches.setdefault(k, v)
        whole = decomp.unshard(f)
        bitwise = torch.equal(whole, ref_f)
        falling = all(b < a for a, b in zip(residuals, residuals[1:]))
        finite = bool(torch.isfinite(whole).all()) and all(
            math.isfinite(r) for r in residuals)
        ms_cycle = device_s / MG_CYCLES * 1e3
        row = {"mesh": mesh, "overlap": overlap,
               "devices": [str(dv) for dv in decomp.devices],
               "tiers": [r["tier"] for r in mg.kernel_tier_report(
                   GRID, dx, depth)],
               "ms_per_cycle": ms_cycle,
               "vs_single_device": ms_cycle / single_ms,
               "host_s": host_s, "device_s": device_s,
               "site_sweeps_per_s": sites * sweeps * MG_CYCLES / device_s,
               "launches": path_launches, "expected_launches": expected,
               "exchanged_bytes_per_cycle": (decomp.bytes_exchanged
                                             - bytes0) / MG_CYCLES,
               "peak_memory_GiB": torch.cuda.max_memory_allocated() / 2**30,
               "l2_residual_after_each_cycle": residuals,
               "single_device_residuals": ref_residuals,
               "final_f_bitwise_single_device": bitwise,
               "finite": finite, "falling": falling}
        rows[(mesh, overlap)] = row
        emit({"phase": phase, "grid": GRID, "dtype": "torch.float32",
              "cycle": f"v_cycle(25, 50, {depth})", **row})
        if not (finite and falling and bitwise):
            raise SystemExit(f"{phase} on {mesh} (overlap {overlap}): "
                             f"finite {finite}, falling {residuals}, "
                             f"bitwise {bitwise}")
        if path_launches != expected:
            raise SystemExit(f"{phase} on {mesh} launched {path_launches}, "
                             f"not {expected}")
        del mg, rho_s, f, sol, errs, whole
        torch.cuda.empty_cache()
    return rows


def mg_solver_on(kind, decomp, overlap):
    """The solver of ``kind`` (mg_problem) over ``decomp``."""
    cls, lhs, omega = mg_problem(kind)
    return cls(lhs, halo_shape=MG_HALO, omega=omega, decomp=decomp,
               overlap=overlap)


def sharded_mg_identity(phase, launches):
    """Each of MG_IDENTITY_CASES at 256^3 f64, every shard on the one card,
    against the same cycle on one device from the same arrays: the
    unknowns and every L-infinity record bit for bit, every L2 record
    within MG_L2_TOL (rank-order sums); replicated levels named in the
    tier report."""
    import pystella_tpu_torch as pt
    from pystella_tpu_torch.multigrid import relax
    shape = MG_IDENTITY_SHAPE
    dx = MG_BOX / shape[0]
    for mesh, overlap, problem, scheme, depth in MG_IDENTITY_CASES:
        cycle = pt.v_cycle(25, 50, depth)
        single = mg_solver(problem)
        fs, rhos = mg_arrays(single, shape, torch.float64, 40)
        arrays = {**fs, **rhos}
        ref_errs, ref = getattr(pt, scheme)(solver=single)(
            dx0=dx, cycle=cycle, **arrays)
        decomp = pt.DomainDecomposition(mesh)
        mg = getattr(pt, scheme)(solver=mg_solver_on(problem, decomp,
                                                     overlap))
        relax.reset_launch_counts()
        errs, sol = mg(dx0=dx, cycle=cycle, **arrays)
        torch.cuda.synchronize()
        path_launches = {k: v for k, v in relax.LAUNCHES.items() if v}
        for k, v in path_launches.items():
            launches.setdefault(k, v)
        expected = mg_expected_launches(mg, cycle, shape, dx)
        bitwise = all(torch.equal(decomp.unshard(sol[n]), ref[n])
                      for n in ref)
        linf = all(g[n][0] == r[n][0] for (_, g), (_, r)
                   in zip(errs, ref_errs) for n in r)
        l2 = max(abs(g[n][1] - r[n][1]) / r[n][1] for (_, g), (_, r)
                 in zip(errs, ref_errs) for n in r)
        report = mg.kernel_tier_report(shape, dx, depth)
        row = {"phase": phase, "mesh": mesh, "overlap": overlap,
               "problem": problem, "scheme": scheme, "shape": shape,
               "dtype": "torch.float64", "cycle": f"v_cycle(25, 50, {depth})",
               "levels": [(r["grid_shape"][0], r["sharded"], r["tier"])
                          for r in report],
               "replicated_levels": sum(not r["sharded"] for r in report),
               "unknowns_bitwise": bitwise, "linf_records_bitwise": linf,
               "l2_records_max_rel_err": l2, "l2_tol": MG_L2_TOL,
               "launches": path_launches,
               "launches_as_expected": path_launches == expected}
        emit(row)
        if not (bitwise and linf and l2 <= MG_L2_TOL
                and path_launches == expected
                and len(errs) == len(ref_errs)):
            raise SystemExit(f"{phase} failed: {row}")
        del mg, sol, ref, fs, rhos, arrays
        torch.cuda.empty_cache()


def sharded_mg_trace(phase, rho):
    """One V-cycle of the sharded main path under torch.profiler on (2, 1,
    1), padded, overlapped at every level and by default (auto): the
    device's busy time in the K11 launches, in the halo exchange's copies
    (kernels and copies launched inside the ``halo_exchange`` labels), in
    the transfers (inside ``mg_transfer``)
    and the rest (the error norms), as shares of the cycle's device span,
    and the idle share (1 - the union of busy intervals over the span);
    then one more cycle with CUDA events and the host clock around every
    step, and the host time spent on the levels below 64^3."""
    import pystella_tpu_torch as pt
    from torch.profiler import ProfilerActivity, profile
    dx = MG_BOX / GRID[0]
    for overlap in (False, True, None):
        decomp = pt.DomainDecomposition((2, 1, 1))
        mg = pt.FullApproximationScheme(solver=mg_solver_on(
            "newton", decomp, overlap), halo_shape=MG_HALO)
        rho_s = decomp.shard(rho)
        f = decomp.zeros(GRID, torch.float32)
        _, sol = mg(dx0=dx, f=f, rho=rho_s)
        f = sol["f"]
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            mg(dx0=dx, f=f, rho=rho_s)
            torch.cuda.synchronize()
        events = prof.events()
        device = [e for e in events
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        labels = SHARDED_LABELS + ("mg_transfer",)
        work = sorted((e for e in device if e.name not in labels),
                      key=lambda e: e.time_range.start)
        if not work:
            emit({"phase": phase, "overlap": overlap, "device_events": 0,
                  "idle_share": "not measured"})
            continue
        span = (max(e.time_range.end for e in work)
                - work[0].time_range.start)
        busy = sum(e - s for s, e in device_intervals(work))
        kernels = sum(e.time_range.elapsed_us() for e in work
                      if "mg_relax" in e.name)

        def under(label):
            """Device time of the kernels and copies launched inside
            ``label`` (host-side spans; the profiler links each launch to
            the ranges open on its thread)."""
            spans = [(e.time_range.start, e.time_range.end)
                     for e in events if e.name == label
                     and e.device_type == torch.autograd.DeviceType.CPU]
            total = 0.0
            for e in events:
                if e.device_type != torch.autograd.DeviceType.CPU:
                    continue
                if not any(a <= e.time_range.start and e.time_range.end <= b
                           for a, b in spans) or e.name == label:
                    continue
                total += sum(k.duration for k in e.kernels)
            return total
        exchange = under("halo_exchange")
        transfers = under("mg_transfer")
        steps = mg_step_times(mg, lambda: mg(dx0=dx, f=f, rho=rho_s))
        coarse = [s for s in steps if GRID[0] >> s[1] < 64]
        emit({"phase": phase, "mesh": (2, 1, 1), "overlap": overlap,
              "device_events": len(work), "span_ms": span / 1e3,
              "busy_ms": busy / 1e3, "idle_share": 1 - busy / span,
              "share_of_span": {
                  "mg_relax_launches": kernels / span,
                  "halo_exchange_copies": exchange / span,
                  "transfers": transfers / span,
                  "other": (busy - kernels - exchange - transfers) / span},
              "busy_ms_by_group": {"mg_relax_launches": kernels / 1e3,
                                   "halo_exchange_copies": exchange / 1e3,
                                   "transfers": transfers / 1e3},
              "mg_relax_launches": sum("mg_relax" in e.name for e in work),
              "below_64_cubed": {
                  "steps": len(coarse),
                  "host_ms": sum(s[3] for s in coarse),
                  "device_ms": sum(s[2] for s in coarse)},
              "cycle_host_ms": sum(s[3] for s in steps),
              "cycle_device_ms": sum(s[2] for s in steps),
              "steps": steps})
        del mg, rho_s, f, sol
        torch.cuda.empty_cache()


def ptxas_report(*steppers):
    """Registers and spill bytes of every kernel each stepper built, from
    the build's -Xptxas -v output (names demangled by c++filt where the
    toolkit's host has it)."""
    from pystella_tpu_torch.ops import fused as tfused
    from pystella_tpu_torch.ops import stencil
    report = {}
    for st in steppers:
        header = st.kernel_header()
        usage = {}
        for src in sorted({tfused.KERNELS[n][0]
                           for n in st._kernel_bases()}):
            usage.update(stencil.ptxas_usage(stencil.build_log(src, header)))
        report[type(st).__name__] = demangled(usage)
    return report


def demangled(usage):
    """A ptxas usage dict with its kernel names demangled by c++filt (where
    the toolkit's host has it)."""
    names = list(usage)
    try:
        out = subprocess.run(
            ["c++filt"], input="\n".join(names), capture_output=True,
            text=True, timeout=60).stdout.splitlines()
    except OSError:
        out = names
    if len(out) != len(names):
        out = names
    return {d: usage[n] for n, d in zip(names, out)}


def bf16_padded_ptxas(report):
    """The rows of a :func:`ptxas_report` that are padded bfloat16-carry
    instantiations of the stage, stage march, pair and coupled pair kernels
    (template arguments ``<T, __nv_bfloat16, ..., PAD>`` with PAD 1, 2 or
    3), with their registers and spill bytes."""
    rows = {}
    for usage in report.values():
        for name, u in usage.items():
            m = re.search(r"(pk_(?:fused_stage|stage_march|fused_pair|"
                          r"coupled_pair|preheat_pair|preheat_coupled_pair)"
                          r"_kernel<[^<>]*__nv_bfloat16[^<>]*, ([123])>)",
                          name)
            if m:
                rows[m.group(1)] = u
    return rows


def march_ptxas(report):
    """The rows of a :func:`ptxas_report` that are instantiations of the
    x-marching kernels (K3 ``pk_fused_pair_kernel``, K6
    ``pk_coupled_pair_kernel``, K8 ``pk_preheat_pair_kernel``, K9
    ``pk_preheat_coupled_pair_kernel``, K10
    ``pk_fused_chunk_march_kernel``, K5', K7 and K5
    ``pk_stage_march_kernel`` (K2 too), fd_lap ``pk_fd_lap_kernel``,
    fd_grad ``pk_fd_grad_kernel``, fd_grad_lap ``pk_fd_grad_lap_kernel``,
    fd_pd* ``pk_fd_pd_kernel``, fd_div ``pk_fd_div_kernel``, K11
    ``mg_relax_march_kernel``), with their registers and spill bytes."""
    rows = {}
    for usage in report.values():
        for name, u in usage.items():
            m = re.search(r"((?:pk_(?:(?:fused_|coupled_|preheat_|"
                          r"preheat_coupled_)pair|fused_chunk_march|"
                          r"stage_march|fd_lap|fd_grad|fd_grad_lap|fd_pd|"
                          r"fd_div)|"
                          r"mg_relax_march)"
                          r"_kernel<[^<>]*>)", name)
            if m:
                rows[m.group(1)] = u
    return rows


#: the x-march variants march_variants builds and times: the x planes a
#: block of the pairs marches (PK_MARCH_LX for the GW pairs,
#: PK_SCALAR_MARCH_LX for the scalar pairs), and for the chunk those
#: (PK_CHUNK_LX) by the rows of its first y-z tile (PK_CHUNK_ROWS); one of
#: them is each family's default
MARCH_VARIANTS = (16, 24, 32, 64)
CHUNK_VARIANTS = tuple((lx, rows) for rows in (8, 16)
                       for lx in MARCH_VARIANTS)
#: the run lengths of the stage march (PK_STAGE_MARCH_LX for K5' and K7,
#: PK_SCALAR_STAGE_MARCH_LX for K5 and K2) and of fd_lap's (PK_FD_LAP_LX);
#: K5's and K2's also without the next plane's loads a step ahead
#: (PK_SCALAR_STAGE_AHEAD 0), and beside the build whose K2 runs per site
#: ("per_site")
STAGE_VARIANTS = (16, 32, 64)
FD_LAP_VARIANTS = STAGE_VARIANTS
SCALAR_STAGE_VARIANTS = tuple((lx, ahead) for ahead in (1, 0)
                              for lx in STAGE_VARIANTS) + ("per_site",)
#: the kernels of each family (each with f32 and with bf16 carries), and
#: the rounds of launches each variant gets in turn
MARCH_KERNELS = ("preheat_pair", "preheat_coupled_pair_deferred")
SCALAR_MARCH_KERNELS = ("fused_pair", "coupled_pair_deferred")
CHUNK_MARCH_KERNELS = ("fused_chunk",)
STAGE_MARCH_KERNELS = ("preheat_stage_energy", "preheat_stage")
SCALAR_STAGE_MARCH_KERNELS = ("fused_stage_energy", "fused_stage")
MARCH_ROUNDS, MARCH_REPS = 3, 5
#: a shell launch takes tens of microseconds: more rounds of more launches
SHELL_ROUNDS, SHELL_REPS = 5, 40


def march_defines(lx, nh):
    """The define of run length ``lx`` for a march of ``nh`` tensor
    components (0: the scalar pairs)."""
    return f"\n#define {'PK_MARCH_LX' if nh else 'PK_SCALAR_MARCH_LX'} {lx}\n"


def chunk_defines(variant):
    """The defines of a chunk march variant ``(lx, rows)``."""
    lx, rows = variant
    return f"\n#define PK_CHUNK_LX {lx}\n#define PK_CHUNK_ROWS {rows}\n"


def stage_defines(variant):
    """The defines of a variant ``(lx, ahead)`` of K5's and K2's march
    (K2 with bf16 carries never looks ahead), or of the build whose K2 runs
    per site (``"per_site"``)."""
    if variant == "per_site":
        return STAGE_PER_SITE
    lx, ahead = variant
    return (f"\n#define PK_SCALAR_STAGE_MARCH_LX {lx}\n"
            f"#define PK_SCALAR_STAGE_AHEAD {ahead}\n")


def fd_lap_defines(lx):
    """The define of fd_lap's march run length ``lx``."""
    return f"\n#define PK_FD_LAP_LX {lx}\n"


#: the variants of K11's march and of fd_ops.cu's queue marches: run length
#: and whether the next plane's loads go a step ahead (MG_MARCH_LX,
#: MG_MARCH_AHEAD; PK_FD_<OP>_LX, PK_FD_<OP>_AHEAD); each family is also
#: timed with the per-site kernel ("per_site")
QUEUE_VARIANTS = tuple((lx, ahead) for ahead in (1, 0)
                       for lx in STAGE_VARIANTS)
#: the multigrid path's levels on which K11's march (a build that marches
#: every level) and the per-site kernel are timed against each other: where
#: the per-site kernel wins, the site threshold (MG_MARCH_MIN_SITES) keeps it
MG_LEVELS = (GRID, (256,) * 3, (128,) * 3, (64,) * 3, (32,) * 3)
MG_VARIANT_SWEEPS = 10


def mg_defines(variant):
    """The defines of a K11 variant ``(lx, ahead)`` or ``"per_site"``."""
    if variant == "per_site":
        return MG_PER_SITE
    lx, ahead = variant
    return f"\n#define MG_MARCH_LX {lx}\n#define MG_MARCH_AHEAD {ahead}\n"


#: fd_ops.cu's operators on pk_queue_march: one build a variant ``(lx,
#: ahead)`` of QUEUE_VARIANTS sets each tile's (ops/derivs.py:QUEUE_TILES)
#: run length and look-ahead
FD_QUEUE_OPS = ("grad", "grad_lap", "div", "pdx")
FD_QUEUE_VARIANTS = QUEUE_VARIANTS


def fd_queue_defines(variant):
    """The defines of a variant ``(lx, ahead)`` of every queue march's
    tile, or of the per-site build (``"per_site"``)."""
    from pystella_tpu_torch.ops import derivs
    if variant == "per_site":
        return FD_PER_SITE
    lx, ahead = variant
    return "\n" + "".join(
        f"#define PK_FD_{t.upper()}_LX {lx}\n"
        f"#define PK_FD_{t.upper()}_AHEAD {ahead}\n"
        for t in derivs.QUEUE_TILES)


def march_variants(phase, sector, gw_sector, dx):
    """The x-marching kernels at 512^3 f32, with f32 and with bf16
    carries: K3 and K6 deferred, and K8 and K9 deferred, through each run
    length of MARCH_VARIANTS; K10 through each run length and first-rung
    rows of CHUNK_VARIANTS; K5' and K7 through each run length of
    STAGE_VARIANTS, and K5 and K2 through each of SCALAR_STAGE_VARIANTS
    (and K2's per-site build; fd_lap, fd_grad, fd_grad_lap, fd_pd*, fd_div
    and K11: :func:`fd_lap_variants`,
    :func:`fd_queue_variants`, :func:`mg_variants`). Each variant is
    built from the same sources into libraries of its own (the model
    header with the variant's
    defines: one nvcc a source and variant, all of a family at once), its
    tile is held to ops/fused.py:march_tile (chunk_tile), its registers
    and spills come from ptxas, and its outputs must equal the default
    build's bit for bit. Then the variants are timed in turns
    (MARCH_ROUNDS rounds of MARCH_REPS launches each) on one set of
    arrays, so every variant runs on the same placement."""
    import ctypes
    import pystella_tpu_torch as pt
    from pystella_tpu_torch.ops import fused as tfused

    def stepper(cls, *args, **kw):
        return lambda carry: cls(*args, GRID, dx, HALO,
                                 dtype=torch.float32, carry_dtype=carry,
                                 device="cuda", **kw)

    def pair_family(nh, values=2):
        def tile(st, lib, v):
            lx = (v[0] if isinstance(v, tuple) else None if v == "per_site"
                  else v)
            query = getattr(lib, ("pk_stage_march_tile" if nh
                                  else "pk_scalar_stage_march_tile")
                            if values == 1 else "pk_preheat_march_tile"
                            if nh else "pk_scalar_march_tile")
            query.argtypes = [ctypes.c_int, ctypes.c_void_p]
            out = (ctypes.c_int * 5)()
            query(0, out)
            return ((tuple(out[:4]), out[4]),
                    tfused.march_tile(st.F, st.h, 4, nh, lx=lx,
                                      values=values))
        if values == 1 and not nh:
            return (SCALAR_STAGE_VARIANTS, stage_defines, tile, queue_label)
        if values == 1:
            return (STAGE_VARIANTS,
                    lambda lx: f"\n#define PK_STAGE_MARCH_LX {lx}\n", tile,
                    lambda lx: {"lx": lx})
        return (MARCH_VARIANTS, lambda lx: march_defines(lx, nh), tile,
                lambda lx: {"lx": lx})

    def chunk_tile(st, lib, v):
        query = lib.pk_fused_chunk_tile
        query.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        out = (ctypes.c_int * 4)()
        query(CHUNK, 0, out)
        return ((tuple(out[:3]), out[3]),
                tfused.chunk_tile(st.F, st.h, 4, CHUNK, lx=v[0], rows=v[1]))

    for label, make, kernels, family in (
            ("scalar", stepper(pt.FusedScalarStepper, sector),
             SCALAR_MARCH_KERNELS, pair_family(0)),
            ("gw", stepper(pt.FusedPreheatStepper, sector, gw_sector),
             MARCH_KERNELS, pair_family(6)),
            ("chunk", stepper(pt.FusedScalarStepper, sector,
                              chunk_stages=CHUNK),
             CHUNK_MARCH_KERNELS,
             (CHUNK_VARIANTS, chunk_defines, chunk_tile,
              lambda v: {"lx": v[0], "rows": v[1]})),
            ("stage", stepper(pt.FusedPreheatStepper, sector, gw_sector),
             STAGE_MARCH_KERNELS, pair_family(6, values=1)),
            ("scalar_stage", stepper(pt.FusedScalarStepper, sector),
             SCALAR_STAGE_MARCH_KERNELS, pair_family(0, values=1))):
        march_family(f"{phase}_{label}", make, kernels, *family)
    fd_lap_variants(f"{phase}_fd_lap")
    fd_queue_variants(f"{phase}_fd")
    mg_variants(f"{phase}_mg")


def variant_row(label, rounds, equal):
    """A variant's row of a family's timing: its mean ms over the rounds,
    each round's ms, and whether its outputs equalled the default
    build's."""
    return {**label, "ms": sum(rounds) / len(rounds), "ms_rounds": rounds,
            "equal_to_default": equal}


def queue_label(v):
    if v == "per_site":
        return {"per_site": True}
    return dict(zip(("lx", "ahead"), v))


def fd_queue_variants(phase):
    """fd_grad, fd_grad_lap, fd_div and fd_pdx (FD_QUEUE_OPS) at h = 2 on
    (2, 512^3) f32 (fd_div on (2, 3, 512^3)) through each variant of
    FD_QUEUE_VARIANTS and the per-site build: one build a variant for all
    (one nvcc a variant, all at once), each tile held to its mirror in
    ops/derivs.py (QUEUE_TILES), registers and spills from ptxas, every
    output the default build's bit for bit; then the variants timed in
    turns (MARCH_ROUNDS rounds of MARCH_REPS launches each) on one input
    an operator. Last, each operator's x shell (the overlapped path's
    ``(C, 3h, 512, 512)`` window, ``:shell``) through the default build and
    the per-site one, in turns: where the per-site kernel wins, a shell
    should not march."""
    import pystella_tpu_torch as pt
    from pystella_tpu_torch.ops import derivs
    from pystella_tpu_torch.ops import stencil
    header = derivs.kernel_header(HALO)
    variants = FD_QUEUE_VARIANTS + ("per_site",)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(variants)) as pool:
        libs = list(pool.map(lambda v: stencil.build_kernels(
            ["fd_ops.cu"], header + fd_queue_defines(v))["fd_ops.cu"],
            variants))
    build_s = time.perf_counter() - t0
    builds = {}
    for v, lib in zip(variants, libs):
        tiles = {}
        for op, (query, mirror) in derivs.QUEUE_TILES.items():
            got = derivs.reported_queue_tile(getattr(lib, query),
                                             torch.float32)
            want = (mirror(HALO, 4) if v == "per_site" else
                    mirror(HALO, 4, lx=v[0], ahead=v[1]))
            if v == "per_site":
                want = (0,) + want[1:]
            if got != want:
                raise SystemExit(f"fd_{op} variant {v}: the library's tile "
                                 f"{got}, the mirror's {want}")
            tiles[op] = got
        builds[v] = {"fns": derivs.bind_kernels(lib), "tiles": tiles,
                     "ptxas": march_ptxas({"fd_ops": demangled(
                         stencil.ptxas_usage(stencil.build_log(
                             "fd_ops.cu", header + fd_queue_defines(v))))})}
    emit({"phase": phase + "_build", "seconds": build_s,
          "variants": [{**queue_label(v), "tiles": b["tiles"],
                        "ptxas": b["ptxas"]} for v, b in builds.items()]})
    fd = pt.FiniteDifferencer(HALO, WAVE_BOX / GRID[0])
    fns = derivs.build_kernels(HALO)
    for seed, op in enumerate(FD_QUEUE_OPS):
        keys = [(op, torch.float32, 0)]
        x = fd_input(op, GRID, torch.float32, 74 + seed)
        ref = [t.clone() for t in fd.launch(op, x)]
        equal, rounds = {}, {v: [] for v in builds}
        for v, b in builds.items():
            with swapped(fns, b["fns"], keys):
                equal[v] = all(torch.equal(a, r) for a, r in zip(
                    fd.launch(op, x), ref))
        for _ in range(MARCH_ROUNDS):
            for v, b in builds.items():
                with swapped(fns, b["fns"], keys):
                    rounds[v].append(cuda_ms(lambda: fd.launch(op, x),
                                             reps=MARCH_REPS, warmup=1))
        emit({"phase": f"{phase}_{op}", "kernel": "fd_" + op,
              "shape": tuple(x.shape), "dtype": "torch.float32", "h": HALO,
              "bound_ms": round(x.shape[0] * (1 + FD_OUT_PER_IN[op]))
              * math.prod(GRID) * 4 / HBM_BYTES_PER_S * 1e3,
              "variants": [variant_row(queue_label(v), r, equal[v])
                           for v, r in rounds.items()]})
        if not all(equal.values()):
            raise SystemExit(f"fd_{op}: a march variant's output differs "
                             f"from the default build's: {equal}")
        # the x shell: the default build against the per-site one
        win = x[:, :3 * HALO].contiguous()
        outs = [torch.empty_like(t) for t in ref]
        del x, ref
        keys = [(op, torch.float32, 1)]
        shell = {"march": [], "per_site": []}
        for _ in range(SHELL_ROUNDS):
            for b, other in (("march", fns), ("per_site",
                                              builds["per_site"]["fns"])):
                with swapped(fns, other, keys):
                    shell[b].append(cuda_ms(lambda: fd.launch_block(
                        op, "shell", win, outs), reps=SHELL_REPS, warmup=5))
        emit({"phase": f"{phase}_{op}_shell", "kernel": f"fd_{op}:shell",
              "shape": tuple(win.shape), "dtype": "torch.float32",
              **{f"{b}_ms": sum(r) / len(r) for b, r in shell.items()},
              **{f"{b}_ms_rounds": r for b, r in shell.items()}})
        del win, outs
        torch.cuda.empty_cache()


def mg_variants(phase):
    """K11's sweep (mg_smooth) of the Newton problem (nf = 1) and of the
    Jacobi pair (nf = 2) at 512^3 f32 through each variant of
    QUEUE_VARIANTS and the per-site build: each built into a library of
    its own (one nvcc a variant and problem, all at once), its tile held
    to multigrid/relax.py:mg_tile, its registers and spills from ptxas, its
    outputs the default build's bit for bit; then the variants timed in
    turns (MARCH_ROUNDS rounds of MG_VARIANT_SWEEPS sweeps). Then, on every
    level of MG_LEVELS, the Newton sweep of a build that marches every
    level against the per-site build's, in turns."""
    from pystella_tpu_torch.multigrid import relax
    from pystella_tpu_torch.multigrid.relax import LevelSpec
    from pystella_tpu_torch.ops import stencil
    variants = QUEUE_VARIANTS + ("per_site",)
    solvers = {k: mg_solver(k) for k in ("newton", "jacobi")}
    jobs = [(k, v) for k in solvers for v in variants]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(jobs)) as pool:
        libs = list(pool.map(lambda j: stencil.build_kernels(
            ["mg_relax.cu"], solvers[j[0]].kernel_header()
            + mg_defines(j[1]))["mg_relax.cu"], jobs))
    build_s = time.perf_counter() - t0
    builds = {}
    for (k, v), lib in zip(jobs, libs):
        solver = solvers[k]
        if v == "per_site":
            solver.check_tile(lib, min_sites=int(MG_PER_SITE.split()[-1]))
        else:
            solver.check_tile(lib, lx=v[0], ahead=v[1])
        builds[k, v] = {
            "fns": relax.bind_kernels(lib),
            "tile": relax.reported_mg_tile(lib.pk_mg_tile, torch.float32),
            "ptxas": march_ptxas({"mg_relax": demangled(stencil.ptxas_usage(
                stencil.build_log("mg_relax.cu", solver.kernel_header()
                                  + mg_defines(v))))})}
    emit({"phase": phase + "_build", "seconds": build_s,
          "variants": [{"problem": k, **queue_label(v), "tile": b["tile"],
                        "ptxas": b["ptxas"]} for (k, v), b in builds.items()]})
    keys = [("mg_smooth", torch.float32, 0)]
    nu = MG_VARIANT_SWEEPS
    for k, solver in solvers.items():
        level = LevelSpec(GRID, (MG_BOX / GRID[0],) * 3)
        fs, rhos = mg_arrays(solver, GRID, torch.float32, 95)
        fns = solver.build_kernels()
        ref = solver.smooth(level, fs, rhos, {}, 1)
        equal, rounds = {}, {v: [] for v in variants}
        for v in variants:
            with swapped(fns, builds[k, v]["fns"], keys):
                got = solver.smooth(level, fs, rhos, {}, 1)
            equal[v] = all(torch.equal(got[n], ref[n]) for n in ref)
            del got
        for _ in range(MARCH_ROUNDS):
            for v in variants:
                with swapped(fns, builds[k, v]["fns"], keys):
                    rounds[v].append(cuda_ms(
                        lambda: solver.smooth(level, fs, rhos, {}, nu),
                        reps=1, warmup=1) / nu)
        emit({"phase": phase, "kernel": "mg_smooth", "problem": k,
              "nf": len(fs), "shape": GRID, "dtype": "torch.float32",
              "bound_ms": 3 * len(fs) * math.prod(GRID) * 4
              / HBM_BYTES_PER_S * 1e3,
              "variants": [variant_row(queue_label(v), r, equal[v])
                           for v, r in rounds.items()]})
        if not all(equal.values()):
            raise SystemExit(f"mg_smooth ({k}): a march variant's outputs "
                             f"differ from the default build's: {equal}")
        del fs, rhos, ref
        torch.cuda.empty_cache()
    solver = solvers["newton"]
    fns = solver.build_kernels()
    pair = {"march": mg_build(solver, MG_MARCH_ALL),
            "per_site": mg_build(solver, MG_PER_SITE)}
    for shape in MG_LEVELS:
        level = LevelSpec(shape, (MG_BOX / shape[0],) * 3)
        fs, rhos = mg_arrays(solver, shape, torch.float32, 96)
        rounds = {b: [] for b in pair}
        for _ in range(MARCH_ROUNDS):
            for b, other in pair.items():
                with swapped(fns, other, keys):
                    rounds[b].append(cuda_ms(
                        lambda: solver.smooth(level, fs, rhos, {}, nu),
                        reps=1, warmup=1) / nu)
        emit({"phase": phase + "_levels", "kernel": "mg_smooth",
              "problem": "newton", "shape": shape,
              "marches_by_default": kernel_marches(solver, shape,
                                                   torch.float32),
              **{f"{b}_ms": sum(r) / len(r) for b, r in rounds.items()},
              **{f"{b}_ms_rounds": r for b, r in rounds.items()}})
        del fs, rhos
        torch.cuda.empty_cache()


def fd_lap_variants(phase):
    """fd_lap at h = 2 on (1, 512^3) and (2, 512^3) f32 through each
    variant of FD_LAP_VARIANTS: each built from the same source into a
    library of its own (one nvcc a variant, all at once), its tile held to
    ops/derivs.py:lap_tile, its registers and spills from ptxas, its output
    the default build's bit for bit; then the variants timed in turns
    (MARCH_ROUNDS rounds of MARCH_REPS launches each) on one input."""
    import pystella_tpu_torch as pt
    from pystella_tpu_torch.ops import derivs
    from pystella_tpu_torch.ops import stencil
    header = derivs.kernel_header(HALO)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(FD_LAP_VARIANTS)) as pool:
        libs = list(pool.map(lambda v: stencil.build_kernels(
            ["fd_ops.cu"], header + fd_lap_defines(v))["fd_ops.cu"],
            FD_LAP_VARIANTS))
    build_s = time.perf_counter() - t0
    builds = {}
    for v, lib in zip(FD_LAP_VARIANTS, libs):
        got = derivs.reported_lap_tile(lib.pk_fd_lap_tile, torch.float32)
        want = derivs.lap_tile(HALO, 4, lx=v)
        builds[v] = {"fn": derivs.bind_kernels(lib)["lap", torch.float32, 0],
                     "tile": got, "ptxas": march_ptxas({"fd_ops": demangled(
                         stencil.ptxas_usage(stencil.build_log(
                             "fd_ops.cu", header + fd_lap_defines(v))))})}
        if got != want:
            raise SystemExit(f"fd_lap variant {v}: the library's tile {got}, "
                             f"the mirror's {want}")
    emit({"phase": phase + "_build", "seconds": build_s,
          "variants": [{"lx": v, "smem_bytes_per_block": b["tile"][1],
                        "ptxas": b["ptxas"]} for v, b in builds.items()]})
    fd = pt.FiniteDifferencer(HALO, WAVE_BOX / GRID[0])
    fns = derivs.build_kernels(HALO)
    key = ("lap", torch.float32, 0)
    default = fns[key]
    for C in (1, 2):
        x = fd_input("lap", GRID, torch.float32, 70 + C, C=C)
        ref = fd.launch("lap", x)[0].clone()
        equal, rounds = {}, {v: [] for v in builds}
        for v, b in builds.items():
            fns[key] = b["fn"]
            equal[v] = torch.equal(fd.launch("lap", x)[0], ref)
        for _ in range(MARCH_ROUNDS):
            for v, b in builds.items():
                fns[key] = b["fn"]
                rounds[v].append(cuda_ms(lambda: fd.launch("lap", x),
                                         reps=MARCH_REPS, warmup=1))
        fns[key] = default
        emit({"phase": phase, "kernel": "fd_lap", "shape": tuple(x.shape),
              "dtype": "torch.float32", "h": HALO,
              "bound_ms": 2 * x.numel() * 4 / HBM_BYTES_PER_S * 1e3,
              "variants": [{"lx": v, "ms": sum(r) / len(r),
                            "ms_rounds": r, "equal_to_default": equal[v]}
                           for v, r in rounds.items()]})
        if not all(equal.values()):
            raise SystemExit(f"fd_lap: a march variant's output differs "
                             f"from the default build's: {equal}")
        del x, ref
        torch.cuda.empty_cache()


def march_family(phase, make, kernels, variants, defines, tile, label):
    """:func:`march_variants` for one family of march kernels: its
    ``variants``, the model header's suffix ``defines(v)`` of each, its
    ``tile(stepper, library, v)`` as (the library's, the host mirror's),
    and the ``label(v)`` of its rows."""
    import ctypes
    from pystella_tpu_torch.ops import fused as tfused
    from pystella_tpu_torch.ops import stencil
    srcs = sorted({tfused.KERNELS[n][0] for n in kernels})
    sites = math.prod(GRID)
    builds = {}
    for carry in (None, torch.bfloat16):
        st = make(carry)
        header = st.kernel_header()
        if not builds:
            t0 = time.perf_counter()
            with ThreadPoolExecutor(len(variants)) as pool:
                libs = list(pool.map(lambda v: stencil.build_kernels(
                    srcs, header + defines(v)), variants))
            build_s = time.perf_counter() - t0
            for v, lib in zip(variants, libs):
                got, want = tile(st, lib[srcs[0]], v)
                usage = march_ptxas({src: demangled(stencil.ptxas_usage(
                    stencil.build_log(src, header + defines(v))))
                    for src in srcs})
                builds[v] = {"lib": lib, "tile": got, "mirror": want,
                             "ptxas": usage}
                if got != want:
                    raise SystemExit(f"march variant {v}: the library's "
                                     f"tile {got}, the mirror's {want}")
            emit({"phase": phase + "_build", "seconds": build_s,
                  "variants": [{**label(v), "tile": b["tile"][0],
                                "smem_bytes_per_block": b["tile"][1],
                                "ptxas": b["ptxas"]}
                               for v, b in builds.items()]})
        for seed, name in enumerate(kernels):
            key = (name, torch.float32, st.carry_dtype, False)
            default = st._libs[key]
            entry = f"pk_{name}_f32" + ("_bf16" if carry else "")
            fns = {}
            for v, b in builds.items():
                fn = getattr(b["lib"][tfused.KERNELS[name][0]], entry)
                fn.argtypes = default.argtypes
                fn.restype = ctypes.c_int
                fns[v] = fn
            ins = kernel_inputs(GRID, torch.float32, 90 + seed, F=st.F,
                                gw=bool(st._march_nh),
                                dtypes=st._in_dtypes(False))
            params = kernel_params(name, st.dx[0])
            ref = [t.clone() for t in st.launch(name, ins, st._new_set(
                ins[0].device), params)]
            outs = st._new_set(ins[0].device)
            equal = {}
            for v, fn in fns.items():
                st._libs[key] = fn
                got = st.launch(name, ins, outs, params)
                torch.cuda.synchronize()
                equal[v] = all(torch.equal(a, b) for a, b in zip(got, ref))
            del ref
            rounds = {v: [] for v in fns}
            for _ in range(MARCH_ROUNDS):
                for v, fn in fns.items():
                    st._libs[key] = fn
                    rounds[v].append(cuda_ms(
                        lambda: st.launch(name, ins, outs, params),
                        reps=MARCH_REPS, warmup=1))
            st._libs[key] = default
            nbytes = (sites * sum(c * (di.itemsize + do.itemsize)
                                  for c, di, do in zip(
                                      st._comps, st._in_dtypes(False),
                                      st._dtypes))
                      + tfused.SUM_SETS[name] * (2 * st.F + 1) * 4)
            emit({"phase": phase, "kernel": st.counted_name(name),
                  "shape": GRID, "dtype": "torch.float32",
                  "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                  "variants": [{**label(v), "ms": sum(r) / len(r),
                                "ms_rounds": r,
                                "equal_to_default": equal[v]}
                               for v, r in rounds.items()]})
            if not all(equal.values()):
                raise SystemExit(f"{name}: a march variant's outputs differ "
                                 f"from the default build's: {equal}")
            del ins, outs
            torch.cuda.empty_cache()
        del st
        torch.cuda.empty_cache()


# -- the sharded tier: halo-input and overlapped launches (several shards on
#    the one card) ------------------------------------------------------------

#: the sharded configurations, every shard on the one card: (mesh, overlap);
#: the first three are the sharded main paths (timed), the others checked
#: against the single-device final state too
SHARDED_CONFIGS = [((2, 1, 1), False), ((2, 1, 1), True), ((2, 2, 1), False),
                   ((4, 1, 1), True), ((1, 2, 1), False)]
SHARDED_TIMED = 3
#: each kind of sharded launch and the mesh whose 512^3 block it runs on in
#: those paths
SHARDED_KIND_MESH = {"xpad": (2, 1, 1), "ypad": (1, 2, 1),
                     "xypad": (2, 2, 1), "interior": (2, 1, 1),
                     "shell": (2, 1, 1)}
#: the path rows by phase (the sharded paths' ms/step against the preheat
#: cell's of the same run)
PATH_ROWS = {}
#: the profiler labels of the exchange and the overlap regions
SHARDED_LABELS = ("halo_exchange", "halo_overlap", "halo_overlap_interior",
                  "halo_overlap_shells")


def sharded_kernel_names():
    """The kernels of the sharded tier with working-dtype carries, as the
    ``<name>:<kind>`` they are counted under: the fused kernels and the
    seven operators."""
    from pystella_tpu_torch.ops import derivs, fused
    return [n for n in fused.SHARDED_KERNELS if fused.BF16 not in n] + list(
        derivs.SHARDED_KERNELS)


def sharded_bf16_kernel_names():
    """The sharded tier's bfloat16-carry entry points, as counted:
    ``<name>:bf16:<kind>`` and ``<name>:bf16_fin:<kind>``."""
    from pystella_tpu_torch.ops import fused
    return [n for n in fused.SHARDED_KERNELS if fused.BF16 in n]


def split_sharded(name):
    """``(kernel, carry variant, kind)`` of a sharded tier's counted name
    ``<kernel>[:bf16[_fin]]:<kind>`` (variant ``""``, ``"bf16"`` or
    ``"bf16_fin"``)."""
    kernel, *variant, kind = name.split(":")
    return kernel, "".join(variant), kind


def block_of(mesh):
    """The block of the 512^3 lattice on ``mesh``."""
    return tuple(n // p for n, p in zip(GRID, mesh))


def pad_periodic(t, hx, hy):
    """A (C, X, Y, Z) tensor padded by its own periodic rows along x and y:
    what a sharded window holds when one block is the whole lattice."""
    if hx:
        t = torch.cat([t[:, -hx:], t, t[:, :hx]], 1)
    if hy:
        t = torch.cat([t[:, :, -hy:], t, t[:, :, :hy]], 2)
    return t.contiguous()


class ShardedCase:
    """One kernel of the sharded tier on a lattice held whole (seeded
    inputs): its unsharded launch, a launch of any kind on windows built by
    hand, and the plain version of the same. A sum kernel's launch of any
    kind on such a block finishes its own sums (its partials at the block's
    own places), which are then the unsharded launch's. With ``variant``
    ``"bf16"`` the stepper stores its carries in bfloat16 (``"bf16_fin"``:
    an energy stage on finalized velocity carries)."""

    def __init__(self, kernel, shape, dtype, seed, variant=""):
        import pystella_tpu_torch as pt
        from pystella_tpu_torch.ops import fused as tfused
        self.kernel, self.shape, self.dtype = kernel, shape, dtype
        self.fd = kernel.startswith("fd_")
        if self.fd:
            self.op = kernel[3:]
            self.st = pt.FiniteDifferencer(HALO, WAVE_BOX / shape[0])
            self.ins = [fd_input(self.op, shape, dtype, seed)]
            self.wins = (0,)
        else:
            sector = pt.ScalarSector(2, potential=potential)
            gw = kernel.startswith("preheat")
            kw = dict(dtype=dtype, device="cuda",
                      carry_dtype=torch.bfloat16 if variant else None)
            self.st = (pt.FusedPreheatStepper(
                sector, pt.TensorPerturbationSector([sector]), shape,
                BOX / shape[0], HALO, **kw) if gw
                else pt.FusedScalarStepper(sector, shape, BOX / shape[0],
                                           HALO, **kw))
            self.ins = kernel_inputs(shape, dtype, seed, gw=gw,
                                     dtypes=self.st._in_dtypes(
                                         variant == "bf16_fin"))
            self.params = kernel_params(kernel, BOX / shape[0])
            self.wins = tfused._WINDOWS[kernel]
            self.sums = bool(tfused.SUM_SETS[kernel])

    def outs(self):
        if self.fd:
            return [torch.empty(s, dtype=self.dtype, device="cuda")
                    for s in self.st._out_shapes(
                        self.op, self.ins[0].shape[0], self.shape)]
        return self.st._new_set(self.ins[0].device)

    def windows(self, fn):
        return [fn(t) if j in self.wins else t
                for j, t in enumerate(self.ins)]

    def unsharded(self):
        if self.fd:
            return self.st.launch(self.op, self.ins[0])
        return self.st.launch(self.kernel, self.ins, self.outs(),
                              self.params)

    def run(self, kind, ins, outs, x0=0):
        if self.fd:
            return self.st.launch_block(self.op, kind, ins[0], outs, x0)
        return self.st.launch_block(self.kernel, kind, ins, outs,
                                    self.params, x0)

    def plain(self, ins, pad, x0=0, rows=None):
        """The plain version on windows ``ins`` padded by ``pad``; the
        block-wise inputs cut to the ``rows`` x rows from ``x0`` that the
        windows compute (the interior and shell regions)."""
        if self.fd:
            return self.st.plain(self.op, ins[0], pad=pad)
        if rows is not None:
            ins = [t if j in self.wins else t[:, x0:x0 + rows]
                   for j, t in enumerate(ins)]
        return self.st.plain(self.kernel, ins, self.params, pad=pad)

    def region_bytes_ops(self, kind):
        """Bytes (windows at their padded storage extent, the block-wise
        inputs and the outputs over the computed region, each once at its
        storage width, and the sum vectors) and operations of one launch of
        ``kind`` on this lattice."""
        from pystella_tpu_torch.ops import derivs
        from pystella_tpu_torch.ops import fused as tfused
        bits = derivs.PAD_KINDS[kind]
        h = HALO
        X, Y, Z = self.shape
        rows = {"interior": X - 2 * h, "shell": h}.get(kind, X)
        wrows = {"interior": X, "shell": 3 * h}.get(kind, X + 2 * h)
        ycols = Y + (2 * h if bits & 2 else 0)
        item = 4 if self.dtype == torch.float32 else 8
        region = rows * Y * Z
        if self.fd:
            C = self.ins[0].shape[0]
            out_per_in = FD_OUT_PER_IN[self.op]
            nbytes = item * (C * wrows * ycols * Z
                             + round(C * out_per_in) * region)
            ops = C * FD_OPS_PER_COMPONENT[self.op](h) * region
        else:
            comps = self.st._comps
            nbytes = (sum(c * t.element_size()
                          * (wrows * ycols * Z if j in self.wins else region)
                          for j, (c, t) in enumerate(zip(comps, self.ins)))
                      + sum(c * d.itemsize for c, d in
                            zip(comps, self.st._dtypes)) * region
                      + item * tfused.SUM_SETS[self.kernel]
                      * (2 * self.st.F + 1))
            ops = ops_per_site(self.kernel, self.st) * region
        return nbytes, ops


def sharded_main_tag(name):
    """The case tag of a sharded kernel's row at the main path's size."""
    return case_tag(block_of(SHARDED_KIND_MESH[split_sharded(name)[2]]),
                    torch.float32)


def sharded_kernels_vs_plain(phase, errs, sharded):
    """Each kernel of the sharded tier, on lattices held whole and windows
    built by hand from their own periodic rows: the padded launches
    (``xpad``, ``ypad``, ``xypad``) vs their plain versions and bit for bit
    vs the unsharded kernel (a sum kernel's sums included, and launched
    twice for bit-equal sums); the interior launch (on the raw block) and
    the two x-shell launches (on ``concat(halo, 2h rows)``) of the kernels
    without sums vs their plain versions, and together bit for bit vs the
    x-padded launch. At the block each kind runs on in the 512^3 sharded
    paths (f32), and at 48x40x36 in f32 and f64. ``sharded``: the counted
    names checked (:func:`split_sharded`). Rows go to
    ``errs["<name>:<kind>"]``."""
    from pystella_tpu_torch.ops import derivs
    h = HALO
    names = sorted({split_sharded(n)[:2] for n in sharded})
    cases = [(block_of(SHARDED_KIND_MESH[k]), torch.float32, (k,))
             for k in ("xpad", "ypad", "xypad")]
    cases[0] = cases[0][:2] + (("xpad", "interior", "shell"),)
    cases += [(ALT_SHAPES[1], dtype, tuple(derivs.PAD_KINDS))
              for dtype in (torch.float32, torch.float64)]
    for seed, (kernel, variant) in enumerate(names):
        prefix = kernel + (f":{variant}" if variant else "")
        for shape, dtype, kinds in cases:
            kinds = [k for k in kinds if f"{prefix}:{k}" in sharded]
            case = ShardedCase(kernel, shape, dtype, 70 + seed, variant)
            sums = not case.fd and case.sums
            ref = case.unsharded()
            rows = {}
            for kind in kinds:
                if kind in ("interior", "shell"):
                    continue
                bits = derivs.PAD_KINDS[kind]
                pad = (h if bits & 1 else 0, h if bits & 2 else 0)
                ins = case.windows(lambda t: pad_periodic(t, *pad))
                outs = case.run(kind, ins, case.outs())
                torch.cuda.synchronize()
                plain = case.plain(ins, pad)
                n = len(case.ins) if sums else len(plain)
                errs_ = [rel_err(o, p) for o, p in zip(outs[:n], plain)]
                rows[kind] = {
                    "max_rel_err": max(e for e, _ in errs_),
                    "max_abs_err": max(a for _, a in errs_),
                    "tol": KERNEL_TOL[dtype],
                    "bitwise_unsharded_kernel": all(
                        torch.equal(o, r) for o, r in zip(outs, ref))}
                if sums:
                    rows[kind]["sum_err"] = sum_errors(
                        case.st, kernel, case.ins, outs, plain, case.params)
                    rows[kind]["sum_tol"] = SUM_TOL[dtype]
                    again = case.run(kind, ins, case.outs())
                    torch.cuda.synchronize()
                    rows[kind]["sums_bitwise_repeatable"] = all(
                        torch.equal(a, b) for a, b in zip(outs[n:],
                                                          again[n:]))
                    rows[kind]["sums_bitwise_unsharded_kernel"] = all(
                        torch.equal(a, b) for a, b in zip(outs[n:],
                                                          ref[n:]))
                    del again
                del ins, plain
                if kind == "xpad":
                    xpad_outs = outs
                else:
                    del outs
            if "interior" in kinds:
                X = shape[0]
                outs = case.outs()
                ins_lo = case.windows(lambda t: pad_periodic(t, h, 0)[
                    :, :3 * h].contiguous())
                ins_hi = case.windows(lambda t: pad_periodic(t, h, 0)[
                    :, X - h:X + 2 * h].contiguous())
                case.run("interior", case.ins, outs, x0=h)
                case.run("shell", ins_lo, outs, x0=0)
                case.run("shell", ins_hi, outs, x0=X - h)
                torch.cuda.synchronize()
                n = len(outs)
                bitwise = all(torch.equal(o, r)
                              for o, r in zip(outs, xpad_outs))
                for kind, ins, pieces in (
                        ("interior", case.ins, [(h, X - h)]),
                        ("shell", None, [(0, h), (X - h, X)])):
                    errs_ = []
                    for (a, b), wins in zip(
                            pieces, [ins] if ins is not None
                            else [ins_lo, ins_hi]):
                        plain = case.plain(wins, (h, 0), a, b - a)
                        errs_ += [rel_err(o[:, a:b] if o.ndim == 4 else
                                          o[:, :, a:b], p)
                                  for o, p in zip(outs, plain)]
                    rows[kind] = {
                        "max_rel_err": max(e for e, _ in errs_),
                        "max_abs_err": max(a for _, a in errs_),
                        "tol": KERNEL_TOL[dtype],
                        "interior_and_shells_bitwise_xpad": bitwise}
                del outs, ins_lo, ins_hi
            xpad_outs = None
            for kind, row in rows.items():
                name = f"{prefix}:{kind}"
                errs.setdefault(name, {})[case_tag(shape, dtype)] = row
                emit({"phase": phase, "kernel": name, "shape": shape,
                      "dtype": str(dtype), **row})
                exact = row.get("bitwise_unsharded_kernel",
                                row.get("interior_and_shells_bitwise_xpad"))
                ok = row["max_rel_err"] <= KERNEL_TOL[dtype] and exact
                if "sum_err" in row:
                    ok = (ok and row["sum_err"] <= row["sum_tol"]
                          and row["sums_bitwise_repeatable"]
                          and row["sums_bitwise_unsharded_kernel"])
                if not ok:
                    raise SystemExit(f"{name} disagrees at {shape} "
                                     f"{dtype}: {row}")
            del case, ref
            torch.cuda.empty_cache()


def time_sharded_kernels(phase, timing, sharded):
    """Each kernel of ``sharded`` (counted names, :func:`split_sharded`) at
    the block its kind runs on in the 512^3 paths (the interior and one
    shell launch alone): CUDA-event ms over 20 launches (a sum kernel's
    with its second launch, as unsharded), its plain version, and the bound
    (the windows at their padded storage extent, the block-wise inputs and
    the outputs over the computed region, each once at its storage width,
    over the HBM rate, against the operations over the f32 peak)."""
    from pystella_tpu_torch.ops import derivs
    h = HALO
    for seed, name in enumerate(sharded):
        kernel, variant, kind = split_sharded(name)
        bits = derivs.PAD_KINDS[kind]
        shape = block_of(SHARDED_KIND_MESH[kind])
        case = ShardedCase(kernel, shape, torch.float32, 90 + seed, variant)
        X = shape[0]
        if kind == "interior":
            ins, x0, pad = case.ins, h, (h, 0)
        elif kind == "shell":
            ins = case.windows(lambda t: pad_periodic(t, h, 0)[
                :, :3 * h].contiguous())
            x0, pad = 0, (h, 0)
        else:
            pad = (h if bits & 1 else 0, h if bits & 2 else 0)
            ins, x0 = case.windows(lambda t: pad_periodic(t, *pad)), 0
        outs = case.outs()
        ms = cuda_ms(lambda: case.run(kind, ins, outs, x0), reps=20,
                     warmup=2)
        per_site = {}
        if case.fd and case.op in FD_MARCHED:
            per_site["per_site_ms"] = per_site_ms(
                derivs.build_kernels(h), fd_build(h, FD_PER_SITE),
                [(case.op, torch.float32, bits)],
                lambda: case.run(kind, ins, outs, x0), 20)
        elif kernel == "fused_stage":
            per_site["per_site_ms"] = per_site_ms(
                case.st._libs, stage_per_site(case.st),
                [(kernel, torch.float32, case.st.carry_dtype, False, bits)],
                lambda: case.run(kind, ins, outs, x0), 20)
        rows = {"interior": X - 2 * h, "shell": h}.get(kind)
        plain_ms = cuda_ms(lambda: case.plain(ins, pad, x0, rows),
                           reps=2 if kernel.startswith("preheat") else 3)
        nbytes, ops = case.region_bytes_ops(kind)
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / PEAK_F32_OPS * 1e3
        bound = max(bytes_ms, ops_ms)
        timing[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                        "bound_by": "bytes" if bytes_ms >= ops_ms
                        else "operations", "bytes": nbytes, "ops": ops,
                        "share_of_bound": bound / ms,
                        "region_rows": rows or X, **per_site}
        emit({"phase": phase, "kernel": name, "block": shape,
              "dtype": "torch.float32", **timing[name]})
        del case, ins, outs
        torch.cuda.empty_cache()


def host_block(ref, decomp, r):
    """Rank ``r``'s block of a whole host tensor, on the card."""
    lat = decomp.rank_shape(tuple(ref.shape[-3:]))
    idx = [slice(None)] * (ref.ndim - 3) + [
        slice(i * n, (i + 1) * n) for i, n in zip(decomp.coords(r), lat)]
    return ref[tuple(idx)].to("cuda")


def equals_whole(sharded, ref):
    """Every block of a ShardedArray equals its slab of the whole tensor
    ``ref`` (on the host or the card), bit for bit."""
    return all(torch.equal(b, host_block(ref, sharded.decomp, r))
               for r, b in enumerate(sharded.blocks))


def sharded_expected(st, nsteps_list):
    """Launches by counted name of ``multi_step`` runs of ``nsteps_list``
    on a sharded stepper: each launch of the plan once per block per kind
    (the overlapped path: an interior and two shells)."""
    names = {r: st._KERNEL[k] for r, k in st._ROLE.items()
             if k in st._KERNEL}
    out = {}
    for n in nsteps_list:
        for role, c in schedule(st, n).items():
            for kind, m in st.sharded_kinds().items():
                key = st.counted_name(names[role], kind=kind)
                out[key] = out.get(key, 0) + c * m * st.decomp.nshards
    return out


def sharded_paths(make_state, ref_final, launches):
    """The scalar hot loop on each of SHARDED_CONFIGS, every shard on the
    one card, from the preheat path's initial state: ``multi_step`` 10
    warm-up + 10 timed + 1 steps (the preheat cell's run), its launches
    against the plan and the mesh, its final state bit for bit against the
    single-device path's (``ref_final``, on the host); then every operator
    of FiniteDifferencer on the final state, sharded, bit for bit against
    the single-device operator. The first SHARDED_TIMED configurations are
    the sharded main paths (phase ``sharded_main_path``: ms/step against
    the preheat cell's in this run, exchanged bytes, memory); every one
    has a ``sharded_identity`` row."""
    import pystella_tpu_torch as pt
    from pystella_tpu_torch.ops import derivs
    from pystella_tpu_torch.ops import fused as tfused
    sector = pt.ScalarSector(2, potential=potential)
    sites = math.prod(GRID)
    dt = 0.1 * BOX / GRID[0]
    args = {"a": 1.0, "hubble": 0.5}
    preheat_ms = PATH_ROWS["main_path"]["ms_per_step"]
    fd = pt.FiniteDifferencer(HALO, WAVE_BOX / GRID[0])
    ops = ("lap", "grad", "grad_lap", "pdx", "pdy", "pdz")
    emit({"phase": "sharded_meshes", "configs": [
        {"mesh": m, "overlap": o, "devices": [
            str(d) for d in pt.DomainDecomposition(m).devices]}
        for m, o in SHARDED_CONFIGS]})
    for i, (mesh, overlap) in enumerate(SHARDED_CONFIGS):
        decomp = pt.DomainDecomposition(mesh)
        st = pt.FusedScalarStepper(sector, GRID, BOX / GRID[0], HALO,
                                   dtype=torch.float32, decomp=decomp,
                                   overlap=overlap)
        whole = make_state()
        state = {k: decomp.shard(v) for k, v in whole.items()}
        del whole
        expected = sharded_expected(st, (NSTEPS, NSTEPS, 1))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held_before = torch.cuda.memory_allocated() - sum(
            b.numel() * b.element_size() for v in state.values()
            for b in v.blocks)
        tfused.reset_launch_counts()
        state = st.multi_step(state, NSTEPS, 0.0, dt, args)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        bytes0 = decomp.bytes_exchanged
        host0 = time.perf_counter()
        start.record()
        state = st.multi_step(state, NSTEPS, 0.0, dt, args)
        end.record()
        torch.cuda.synchronize()
        host_s = time.perf_counter() - host0
        elapsed = start.elapsed_time(end) / 1e3
        step_bytes = (decomp.bytes_exchanged - bytes0) / NSTEPS
        state = st.multi_step(state, 1, 0.0, dt, args)
        torch.cuda.synchronize()
        path_launches = {k: v for k, v in tfused.LAUNCHES.items() if v}
        for name, c in path_launches.items():
            launches.setdefault(name, c)
        bitwise = {k: equals_whole(state[k], ref_final[k])
                   for k in ref_final}
        finite = all(bool(torch.isfinite(b).all())
                     for v in state.values() for b in v.blocks)
        ms = elapsed / NSTEPS * 1e3
        report = st.kernel_tier_report()
        row = {"grid": GRID, "dtype": "torch.float32", "mesh": mesh,
               "overlap_requested": overlap,
               "launch_kinds": {str(k): m for k, m in
                                st.sharded_kinds().items()},
               "devices": [str(d) for d in decomp.devices],
               "nsteps_timed": NSTEPS, "ms_per_step": ms,
               "site_updates_per_s": sites * NSTEPS / elapsed,
               "ms_per_step_vs_preheat": ms / preheat_ms,
               "preheat_ms_per_step": preheat_ms, "host_s": host_s,
               "launches": path_launches, "expected_launches": expected,
               "exchanged_bytes_per_step": step_bytes,
               "traced_halo_bytes": decomp.traced_halo_bytes(),
               "tier_report": report,
               "peak_memory_GiB": torch.cuda.max_memory_allocated() / 2**30,
               "path_memory_GiB": (torch.cuda.max_memory_allocated()
                                   - held_before) / 2**30,
               "finite": finite, "bitwise_single_device": bitwise}
        if i < SHARDED_TIMED:
            emit({"phase": "sharded_main_path", **row})
            PATH_ROWS[f"sharded_main_path{mesh}{overlap}"] = row
        if path_launches != expected:
            raise SystemExit(f"sharded path {mesh} overlap={overlap} "
                             f"launched {path_launches}, not {expected}")
        # every operator of the final state, sharded vs single-device
        sfd = pt.FiniteDifferencer(HALO, WAVE_BOX / GRID[0], decomp=decomp,
                                   overlap=overlap)
        derivs.reset_launch_counts()
        f1 = ref_final["f"].to("cuda")
        fd_bitwise = {}
        grads = None
        for op in ops:
            got, want = getattr(sfd, op)(state["f"]), getattr(fd, op)(f1)
            if op == "grad_lap":
                fd_bitwise[op] = (equals_whole(got[0], want[0])
                                  and equals_whole(got[1], want[1]))
            else:
                fd_bitwise[op] = equals_whole(got, want)
            if op == "grad":
                grads = (got, want)
            del got, want
        fd_bitwise["divergence"] = equals_whole(
            sfd.divergence(grads[0]), fd.divergence(grads[1]))
        torch.cuda.synchronize()
        fd_launches = {k: v for k, v in derivs.LAUNCHES.items()
                       if v and ":" in k}
        for name, c in fd_launches.items():
            launches.setdefault(name, c)
        del f1, grads, sfd
        emit({"phase": "sharded_identity", "mesh": mesh,
              "overlap_requested": overlap,
              "devices": [str(d) for d in decomp.devices],
              "launch_kinds": row["launch_kinds"], "nsteps": 2 * NSTEPS + 1,
              "bitwise_single_device_preheat": bitwise,
              "fd_bitwise_single_device": fd_bitwise,
              "fd_launches": fd_launches, "finite": finite})
        if not (finite and all(bitwise.values())
                and all(fd_bitwise.values())):
            raise SystemExit(f"sharded path {mesh} overlap={overlap} is not "
                             f"the single-device path: {bitwise} "
                             f"{fd_bitwise}")
        del st, state
        torch.cuda.empty_cache()


#: the sharded coupled driver and GW stepper, every shard on the one card:
#: (mesh, overlap) per path; the first SHARDED_*_TIMED of each list are its
#: main paths (timed against the single-device cell of the same run), every
#: one is held to the single-device final state bit for bit and launches
#: the padded (or interior and shell) entry points its mesh implies
SHARDED_COUPLED_CONFIGS = [((2, 1, 1), False), ((2, 2, 1), False),
                           ((4, 1, 1), False), ((1, 2, 1), False)]
SHARDED_COUPLED_TIMED = 2
SHARDED_GW_CONFIGS = [((2, 1, 1), True), ((2, 1, 1), False),
                      ((2, 2, 1), False), ((1, 2, 1), False)]
SHARDED_GW_COUPLED_CONFIGS = [((2, 1, 1), False), ((2, 2, 1), False),
                              ((1, 2, 1), False), ((4, 1, 1), False)]
SHARDED_GW_TIMED = 1
#: the sharded paths with bf16 carries: the hot loops' meshes (the bench
#: model's first two timed, the GW bench's first), the coupled drivers'
#: (the scalar one's first two timed, the GW one's first); together they
#: launch every bf16 entry point of the sharded tier
SHARDED_BF16_CONFIGS = [((2, 1, 1), True), ((2, 2, 1), False),
                        ((2, 1, 1), False), ((1, 2, 1), False)]
SHARDED_BF16_COUPLED_CONFIGS = [((2, 1, 1), False), ((2, 2, 1), False),
                                ((1, 2, 1), False)]
SHARDED_BF16_GW_COUPLED_CONFIGS = SHARDED_BF16_COUPLED_CONFIGS


def coupled_expected(st):
    """Launches by counted name of the coupled paths' run (10 + 10 + 1
    steps: 3 normal pairs, 49 deferred pairs, 1 energy stage, on finalized
    carries) on a sharded stepper: each once per block, padded."""
    (kind,) = st.sharded_kinds(st._KERNEL["stage_energy"])
    n = st.decomp.nshards
    kn = st._KERNEL
    return {st.counted_name(kn["coupled_pair"], kind=kind): 3 * n,
            st.counted_name(kn["coupled_pair_deferred"], kind=kind): 49 * n,
            st.counted_name(kn["stage_energy"], True, kind): n}


def sharded_energy(st, decomp, state, a):
    """The scalar energy (Reduction with the sharded Laplacian) of a
    sharded state, for the Friedmann constraint."""
    import pystella_tpu_torch as pt
    sfd = pt.FiniteDifferencer(HALO, BOX / GRID[0], decomp=decomp)
    red = pt.Reduction(st.sector, callback=pt.get_rho_and_p,
                       grid_size=float(math.prod(GRID)))
    return red(f=state["f"], dfdt=state["dfdt"], lap_f=sfd.lap(state["f"]),
               a=np.float64(a))


def sharded_stepping_paths(phase, configs, ntimed, make_stepper, make_state,
                           ref, launches, coupled, cell, args=None,
                           compare=None, single=False):
    """A path on each of ``configs``, every shard on the one card, from the
    single-device path's initial state (``make_state``, whole on the card,
    then sharded) and, for ``coupled``, its initial background
    (``PATH_ROWS[cell]["energy0"]``): 10 warm-up + 10 timed + 1 steps of
    ``multi_step`` or ``coupled_multi_step`` (the single-device cell's run,
    ``cell``), its launches against the mesh's, the final state (and a,
    adot) bit for bit against the single-device path's (``ref``, on the
    host), and for ``coupled`` the Friedmann constraint. The first
    ``ntimed`` configurations are main paths (phase ``phase``: ms/step
    against the cell's in this run, exchanged bytes, memory); every one has
    a ``sharded_coupled_identity`` row. ``args``: ``multi_step``'s background
    scalars; ``compare``: ``{(mesh, overlap): PATH_ROWS key}`` of another
    sharded cell of this run (the f32-carry one) whose ms/step and
    exchanged bytes the row reports beside its own. ``single`` (coupled):
    then one step of single-stage energy kernels (``pair=False``) from the
    final state and background, held bit for bit to the single-device
    cell's (``PATH_ROWS[cell]["single_final"]``)."""
    import pystella_tpu_torch as pt
    from pystella_tpu_torch.ops import fused as tfused
    sites = math.prod(GRID)
    dt = 0.1 * BOX / GRID[0]
    args = args or {"a": 1.0, "hubble": 0.5}
    cell_row = PATH_ROWS[cell]
    for i, (mesh, overlap) in enumerate(configs):
        decomp = pt.DomainDecomposition(mesh)
        st = make_stepper(decomp, overlap)
        whole = make_state()
        state = {k: decomp.shard(v) for k, v in whole.items()}
        del whole
        torch.cuda.empty_cache()
        free_before = torch.cuda.mem_get_info()[0]
        if coupled:
            expand = pt.Expansion(cell_row["energy0"], pt.LowStorageRK54,
                                  mpl=1.0)
            expected = coupled_expected(st)

            def run(state, n):
                return st.coupled_multi_step(state, n, expand, 0.0, dt)
        else:
            expected = sharded_expected(st, (NSTEPS, NSTEPS, 1))

            def run(state, n):
                return st.multi_step(state, n, 0.0, dt, args)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held_before = torch.cuda.memory_allocated() - sum(
            b.numel() * b.element_size() for v in state.values()
            for b in v.blocks)
        tfused.reset_launch_counts()
        state = run(state, NSTEPS)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        bytes0 = decomp.bytes_exchanged
        host0 = time.perf_counter()
        start.record()
        state = run(state, NSTEPS)
        end.record()
        torch.cuda.synchronize()
        host_s = time.perf_counter() - host0
        elapsed = start.elapsed_time(end) / 1e3
        step_bytes = (decomp.bytes_exchanged - bytes0) / NSTEPS
        state = run(state, 1)
        torch.cuda.synchronize()
        path_launches = {k: v for k, v in tfused.LAUNCHES.items() if v}
        for name, c in path_launches.items():
            launches.setdefault(name, c)
        bitwise = {k: equals_whole(state[k], ref[k]) for k in ref}
        finite = all(bool(torch.isfinite(b).all())
                     for v in state.values() for b in v.blocks)
        ms = elapsed / NSTEPS * 1e3
        row = {"grid": GRID, "dtype": "torch.float32", "mesh": mesh,
               "overlap_requested": overlap,
               "launch_kinds": {str(k): m for k, m in
                                st.sharded_kinds().items()},
               "devices": [str(d) for d in decomp.devices],
               "nsteps_timed": NSTEPS, "ms_per_step": ms,
               "site_updates_per_s": sites * NSTEPS / elapsed,
               "ms_per_step_vs_single_device": ms / cell_row["ms_per_step"],
               "single_device_ms_per_step": cell_row["ms_per_step"],
               "host_s": host_s, "launches": path_launches,
               "expected_launches": expected,
               "exchanged_bytes_per_step": step_bytes,
               "tier_report": st.kernel_tier_report(),
               "free_before_GiB": free_before / 2**30,
               "peak_memory_GiB": torch.cuda.max_memory_allocated() / 2**30,
               "path_memory_GiB": (torch.cuda.max_memory_allocated()
                                   - held_before) / 2**30,
               "finite": finite, "bitwise_single_device": bitwise}
        other = PATH_ROWS.get((compare or {}).get((mesh, overlap)))
        if other is not None:
            row.update({
                "compared_cell": compare[mesh, overlap],
                "compared_ms_per_step": other["ms_per_step"],
                "ms_per_step_vs_compared": ms / other["ms_per_step"],
                "compared_exchanged_bytes_per_step":
                    other["exchanged_bytes_per_step"],
                "exchanged_bytes_vs_compared":
                    step_bytes / other["exchanged_bytes_per_step"]})
        ok = finite and all(bitwise.values()) and path_launches == expected
        if coupled:
            energy = sharded_energy(st, decomp, state, expand.a)
            row.update({"a": float(expand.a), "adot": float(expand.adot),
                        "a_adot_bitwise_single_device": (
                            float(expand.a) == cell_row["a"]
                            and float(expand.adot) == cell_row["adot"]),
                        "constraint": float(expand.constraint(
                            energy["total"])),
                        "constraint_tol": CONSTRAINT_TOL})
            ok = (ok and row["a_adot_bitwise_single_device"]
                  and row["constraint"] <= CONSTRAINT_TOL)
        if single:
            exp1 = pt.Expansion(cell_row["energy0"], pt.LowStorageRK54,
                                mpl=1.0)
            exp1.a, exp1.adot = expand.a, expand.adot
            exp1.hubble = expand.hubble
            tfused.reset_launch_counts()
            out = st.coupled_multi_step(state, 1, exp1, 0.0, dt, pair=False)
            torch.cuda.synchronize()
            single_launches = {k: v for k, v in tfused.LAUNCHES.items() if v}
            for name, c in single_launches.items():
                launches.setdefault(name, c)
            (kind,) = st.sharded_kinds(st._KERNEL["stage_energy"])
            want = {st.counted_name(st._KERNEL["stage_energy"], kind=kind):
                    st.num_stages * decomp.nshards}
            row["single_stage_step"] = {
                "launches": single_launches, "expected_launches": want,
                "bitwise_single_device": {
                    k: equals_whole(out[k], cell_row["single_final"][k])
                    for k in cell_row["single_final"]},
                "a_adot_bitwise_single_device": (
                    float(exp1.a) == cell_row["single_a"]
                    and float(exp1.adot) == cell_row["single_adot"])}
            one = row["single_stage_step"]
            ok = (ok and single_launches == want
                  and all(one["bitwise_single_device"].values())
                  and one["a_adot_bitwise_single_device"])
            del out
        if "hij" in state:
            row["hij_max_abs"] = max(b.abs().max().item()
                                     for b in state["hij"].blocks)
            ok = ok and row["hij_max_abs"] > 0
        if i < ntimed:
            emit({"phase": phase, "path": cell, **row})
            PATH_ROWS[f"{phase}:{cell}{mesh}{overlap}"] = row
        emit({"phase": "sharded_coupled_identity", "path": cell,
              "mesh": mesh,
              "overlap_requested": overlap, "nsteps": 2 * NSTEPS + 1,
              "launch_kinds": row["launch_kinds"],
              "bitwise_single_device": bitwise,
              **{k: row[k] for k in ("a_adot_bitwise_single_device",
                                     "constraint", "launches",
                                     "single_stage_step") if k in row},
              "finite": finite})
        if not ok:
            raise SystemExit(f"{phase} {mesh} overlap={overlap} is not the "
                             f"single-device path or launched "
                             f"{path_launches}, not {expected}: {row}")
        del st, state
        torch.cuda.empty_cache()


def sharded_coupled_trace(phase, make_state):
    """One sharded coupled chunk (10 steps: 25 padded pairs) on (2, 1, 1)
    under torch.profiler: the device time of the exchange copies and of
    the padded launches as shares of the chunk's device span, the idle
    share (1 - the union of busy intervals over the span) and the host
    syncs (device-to-host copies of the energy sums: one a launch)."""
    import pystella_tpu_torch as pt
    from torch.profiler import ProfilerActivity, profile
    dt = 0.1 * BOX / GRID[0]
    decomp = pt.DomainDecomposition((2, 1, 1))
    st = pt.FusedScalarStepper(pt.ScalarSector(2, potential=potential),
                               GRID, BOX / GRID[0], HALO,
                               dtype=torch.float32, decomp=decomp,
                               overlap=False)
    whole = make_state()
    state = {k: decomp.shard(v) for k, v in whole.items()}
    del whole
    expand = pt.Expansion(PATH_ROWS["coupled_main_path"]["energy0"],
                          pt.LowStorageRK54, mpl=1.0)
    state = st.coupled_multi_step(state, 1, expand, 0.0, dt)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        state = st.coupled_multi_step(state, NSTEPS, expand, 0.0, dt)
        torch.cuda.synchronize()
    device = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    events = sorted((e for e in device if e.name not in SHARDED_LABELS),
                    key=lambda e: e.time_range.start)
    if not events:
        emit({"phase": phase, "device_events": 0,
              "idle_share": "not measured"})
        return
    syncs = [e for e in events if "DtoH" in e.name
             or "Device -> Pageable" in e.name]
    kern = [e for e in events if e.name.startswith("void pk_")
            and "reduce_partials" not in e.name]
    finish = [e for e in events if "reduce_partials" in e.name]
    copies = [e for e in events if e not in kern and e not in finish
              and e not in syncs]
    groups = {"padded_launches": kern, "sum_finish": finish,
              "exchange_and_other": copies, "sum_reads": syncs}
    span = (events[-1].time_range.end
            - min(e.time_range.start for e in events))
    busy = sum(e - s for s, e in device_intervals(events))
    emit({"phase": phase, "mesh": (2, 1, 1),
          "devices": [str(d) for d in decomp.devices],
          "nsteps": NSTEPS, "device_events": len(events),
          "span_ms": span / 1e3, "busy_ms": busy / 1e3,
          "idle_share": 1 - busy / span,
          "host_syncs": len(syncs),
          "busy_ms_by_group": {
              g: sum(e.time_range.elapsed_us() for e in evs) / 1e3
              for g, evs in groups.items()},
          "share_of_span_by_group": {
              g: sum(e.time_range.elapsed_us() for e in evs) / span
              for g, evs in groups.items()},
          "launches_by_group": {g: len(evs) for g, evs in groups.items()},
          "other_event_names": sorted({e.name[:60] for e in copies})})
    del st, state
    torch.cuda.empty_cache()


def device_intervals(events):
    """Merged (start, end) busy intervals of device events, in us."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    merged = []
    for s, e in spans:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def sharded_trace(phase, make_state):
    """One sharded RK54 step (2 pairs and a stage) under torch.profiler on
    (2, 1, 1), padded and overlapped: the device time of the exchange
    copies, of the interior and of the shell launches (in launch order on
    the compute stream: per launch both blocks' interiors, then their four
    shells), as shares of the step's device span, and the idle share (1 -
    the union of busy intervals over the span)."""
    import pystella_tpu_torch as pt
    from torch.profiler import ProfilerActivity, profile
    sector = pt.ScalarSector(2, potential=potential)
    dt = 0.1 * BOX / GRID[0]
    args = {"a": 1.0, "hubble": 0.5}
    for overlap in (False, True, None):
        decomp = pt.DomainDecomposition((2, 1, 1))
        st = pt.FusedScalarStepper(sector, GRID, BOX / GRID[0], HALO,
                                   dtype=torch.float32, decomp=decomp,
                                   overlap=overlap)
        whole = make_state()
        state = {k: decomp.shard(v) for k, v in whole.items()}
        del whole
        state = st.multi_step(state, 1, 0.0, dt, args)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            state = st.multi_step(state, 1, 0.0, dt, args)
            torch.cuda.synchronize()
        # the device's kernels and copies (the profiler also lays the
        # record_function labels on the device timeline: their spans are
        # reported apart)
        device = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        labels = [e for e in device if e.name in SHARDED_LABELS]
        events = sorted((e for e in device if e.name not in SHARDED_LABELS),
                        key=lambda e: e.time_range.start)
        if not events:
            emit({"phase": phase, "overlap": overlap, "device_events": 0,
                  "idle_share": "not measured"})
            continue
        kern = [e for e in events if "pk_fused" in e.name]
        copies = [e for e in events if "pk_fused" not in e.name]
        groups = {"halo_exchange": copies}
        if overlap:
            per = 3 * decomp.nshards  # an interior and two shells a block
            groups["interior"] = [e for i, e in enumerate(kern)
                                  if i % per < decomp.nshards]
            groups["shells"] = [e for i, e in enumerate(kern)
                                if i % per >= decomp.nshards]
        else:
            groups["padded_launches"] = kern
        span = (events[-1].time_range.end
                - min(e.time_range.start for e in events))
        busy = sum(e - s for s, e in device_intervals(events))
        emit({"phase": phase, "mesh": (2, 1, 1), "overlap": overlap,
              "devices": [str(d) for d in decomp.devices],
              "device_events": len(events), "span_ms": span / 1e3,
              "busy_ms": busy / 1e3, "idle_share": 1 - busy / span,
              "busy_ms_by_group": {
                  g: sum(e.time_range.elapsed_us() for e in evs) / 1e3
                  for g, evs in groups.items()},
              "share_of_span_by_group": {
                  g: sum(e.time_range.elapsed_us() for e in evs) / span
                  for g, evs in groups.items()},
              "launches_by_group": {g: len(evs) for g, evs in
                                    groups.items()},
              "label_span_ms": {n: sum(e.time_range.elapsed_us()
                                       for e in labels if e.name == n) / 1e3
                                for n in sorted({e.name for e in labels})},
              "copy_event_names": sorted({e.name[:60] for e in copies})})
        del st, state
        torch.cuda.empty_cache()


def sharded_fd_kernel_time(phase):
    """``lap`` of a (2, 512^3) f32 field on (2, 1, 1), padded and
    overlapped (the whole operator: exchange copies and launches), against
    the single-device ``fd_lap`` in the same run: CUDA-event ms over 20
    calls."""
    import pystella_tpu_torch as pt
    x = fd_input("lap", GRID, torch.float32, 66)
    fd = pt.FiniteDifferencer(HALO, WAVE_BOX / GRID[0])
    single_ms = cuda_ms(lambda: fd.lap(x), reps=20, warmup=2)
    row = {"phase": phase, "shape": tuple(x.shape), "mesh": (2, 1, 1),
           "dtype": "torch.float32", "fd_lap_ms": single_ms}
    decomp = pt.DomainDecomposition((2, 1, 1))
    xs = decomp.shard(x)
    row["devices"] = [str(d) for d in decomp.devices]
    for overlap in (False, True):
        sfd = pt.FiniteDifferencer(HALO, WAVE_BOX / GRID[0], decomp=decomp,
                                   overlap=overlap)
        key = "overlapped" if overlap else "padded"
        row[f"{key}_ms"] = cuda_ms(lambda: sfd.lap(xs), reps=20, warmup=2)
        row[f"{key}_vs_fd_lap"] = row[f"{key}_ms"] / single_ms
    emit(row)
    del x, xs
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# the spectra group: K13, K14, the finish, and the measurement step
# ---------------------------------------------------------------------------

def spectra_binner(shape, dtype, device="cuda"):
    """The K14 binner of PowerSpectra on a lattice ``shape`` (box 5^3) for
    a real ``dtype`` (the host arrays at 512^3 take a few seconds)."""
    import pystella_tpu_torch as pt
    ndt = {torch.float32: np.float32, torch.float64: np.float64}[dtype]
    lat = pt.Lattice(shape, (BOX,) * 3, dtype=ndt)
    fft = pt.DFT(None, grid_shape=shape, dtype=ndt, device=device)
    return pt.PowerSpectra(None, fft, lat.dk, lat.volume)


def hist_row(errs, name, tag, got, ref, dtype, exact):
    """Hold a binning result to its plain version: equal (``exact``) or
    within HIST_TOL of the largest bin; the row goes into ``errs``."""
    rel, abs_ = rel_err(got, ref)
    ok = torch.equal(got, ref) if exact else rel <= HIST_TOL[dtype]
    row = {"max_rel_err": rel, "max_abs_err": abs_, "exact": exact,
           "equal": torch.equal(got, ref), "ok": ok,
           "tol": 0.0 if exact else HIST_TOL[dtype]}
    prev = errs.setdefault(name, {}).get(tag)
    if prev is None or abs_ >= prev["max_abs_err"]:
        errs[name][tag] = row
    return row


def hist_build(defines):
    """The bound entry points of histogram.cu built with ``defines`` after
    its header (from the build cache when the build phase made it)."""
    from pystella_tpu_torch.ops import histogram as thist
    from pystella_tpu_torch.ops import stencil
    return thist.bind_kernels(stencil.build_kernels(
        ["histogram.cu"], thist._HEADER + defines)["histogram.cu"])


def hot_bins(kind, shape, g):
    """Hot-bin int32 bins of ``shape``: every site in bin 500 (``hot1``),
    or 90% of the sites in bins 333 and 999 and the rest uniform
    (``hot2``)."""
    if kind == "hot1":
        return torch.full(shape, HIST_BINS // 2, device="cuda",
                          dtype=torch.int32)
    u = torch.rand(shape, generator=g, device="cuda")
    b = torch.randint(0, HIST_BINS, shape, generator=g, device="cuda",
                      dtype=torch.int32)
    return torch.where(u < 0.45, HIST_BINS // 3, torch.where(
        u < 0.9, HIST_BINS - 1, b)).to(torch.int32)


def histogram_kernels_vs_plain(phase, errs):
    """K13 (counts, float32 and float64 weights) and K14 (the spectra's
    weighting and binning) against their plain versions at 512^3 and
    48x40x36, f32 and f64, 1, 2 and 6 outer slices: counts and K14's bins
    (unit modes, k^0) equal, sums within HIST_TOL of the largest bin, the
    same launch twice equal bits, and on HIST_MESHES (where the blocks
    hold whole units) the sharded launches equal the whole lattice's bit
    for bit; counts (hot bins too) and K14's bins equal the grouping
    build's (HIST_MATCH), K14's sums within HIST_TOL of it. The finish
    launch alone against a sum over the units."""
    import pystella_tpu_torch as pt
    from pystella_tpu_torch.ops import histogram as thist
    g = torch.Generator(device="cuda").manual_seed(21)
    fns, match = thist.build_kernels(), hist_build(HIST_MATCH)

    def grouped(fn, *a):
        with swapped(fns, match, HIST_MATCH_ENTRIES):
            return fn(*a)
    fails = []
    for shape in (GRID, ALT_SHAPES[1]):
        for dtype in (torch.float32, torch.float64):
            tag = case_tag(shape, dtype)
            sp = spectra_binner(shape, dtype)
            for outer in (1, 2, 6):
                bins = torch.randint(-1, HIST_BINS + 1, (outer,) + shape,
                                     generator=g, device="cuda",
                                     dtype=torch.int32)
                w = torch.randn((outer,) + shape, generator=g,
                                device="cuda", dtype=dtype)
                rows = {}
                for label, weights in (("counts", None), ("weights", w)):
                    one = thist.bincount(bins, weights, HIST_BINS)
                    two = thist.bincount(bins, weights, HIST_BINS)
                    ref = thist.bincount_plain(bins, weights, HIST_BINS)
                    rows[label] = hist_row(errs, "bincount", tag, one, ref,
                                           dtype, weights is None)
                    rows[label]["repeat_equal"] = torch.equal(one, two)
                    rows[label]["match_equal"] = torch.equal(grouped(
                        thist.bincount, bins, weights, HIST_BINS), one)
                    for mesh in HIST_MESHES:
                        if shape[1] // mesh[1] % thist.unit_rows(shape[1]):
                            continue
                        d = pt.DomainDecomposition(mesh)
                        sh = thist.bincount(
                            d.shard(bins), None if weights is None
                            else d.shard(weights), HIST_BINS)
                        rows[label][f"sharded_{''.join(map(str, mesh))}"] \
                            = torch.equal(sh, one)
                        del sh
                del bins, w
                for kind in ("hot1", "hot2") if outer == 1 else ():
                    bins = hot_bins(kind, (outer,) + shape, g)
                    one = thist.bincount(bins, None, HIST_BINS)
                    rows[f"counts_{kind}"] = hist_row(
                        errs, "bincount", tag, one,
                        thist.bincount_plain(bins, None, HIST_BINS), dtype,
                        True)
                    rows[f"counts_{kind}"]["match_equal"] = torch.equal(
                        grouped(thist.bincount, bins, None, HIST_BINS), one)
                    del bins, one
                torch.cuda.empty_cache()
                cdt = {torch.float32: torch.complex64,
                       torch.float64: torch.complex128}[dtype]
                kshape = sp.kshape
                fk = torch.randn((outer,) + kshape, generator=g,
                                 device="cuda", dtype=cdt)
                one = sp.binner(fk, 3)
                two = sp.binner(fk, 3)
                rows["spectra"] = hist_row(errs, "spectra_bin", tag, one,
                                           sp.binner.plain(fk, 3), dtype,
                                           False)
                rows["spectra"]["repeat_equal"] = torch.equal(one, two)
                rows["spectra"]["match_rel_err"] = rel_err(
                    grouped(sp.binner, fk, 3), one)[0]
                rows["spectra"]["match_ok"] = \
                    rows["spectra"]["match_rel_err"] <= HIST_TOL[dtype]
                ones = torch.ones_like(fk)
                shells = sp.binner(ones, 0)
                rows["spectra_bins"] = hist_row(
                    errs, "spectra_bin:bins", tag, shells,
                    sp.binner.plain(ones, 0), dtype, True)
                rows["spectra_bins"]["match_equal"] = torch.equal(
                    grouped(sp.binner, ones, 0), shells)
                del ones, shells
                for mesh in HIST_MESHES:
                    if kshape[1] // mesh[1] % thist.unit_rows(kshape[1]):
                        continue
                    d = pt.DomainDecomposition(mesh)
                    rows["spectra"][f"sharded_{''.join(map(str, mesh))}"] \
                        = torch.equal(sp.binner(d.shard(fk), 3), one)
                del fk, one, two
                torch.cuda.empty_cache()
                emit({"phase": phase, "shape": shape, "dtype": str(dtype),
                      "outer": outer, "bins": HIST_BINS,
                      "spectra_bins": sp.num_bins,
                      "unit_rows": thist.unit_rows(shape[1]), **rows})
                for label, row in rows.items():
                    if not (row["ok"] and row.get("repeat_equal", True)
                            and row.get("match_equal", True)
                            and row.get("match_ok", True)
                            and all(v for k, v in row.items()
                                    if k.startswith("sharded_"))):
                        fails.append((tag, outer, label))
            del sp
    # the finish alone: random partials of the 512^3 layout (8192 units)
    fns = thist.build_kernels()
    nunits = GRID[0] * (GRID[1] // thist.unit_rows(GRID[1]))
    stream = torch.cuda.current_stream().cuda_stream
    for label, pdt, entry in (("sums", torch.float64, "pk_bin_finish_sum"),
                              ("counts", torch.int32,
                               "pk_bin_finish_count")):
        parts = (torch.randn((2, nunits, HIST_BINS), generator=g,
                             device="cuda", dtype=torch.float64)
                 if pdt == torch.float64 else torch.randint(
                     0, 2**20, (2, nunits, HIST_BINS), generator=g,
                     device="cuda", dtype=torch.int32))
        out = torch.empty((2, HIST_BINS), device="cuda", dtype=(
            torch.float64 if pdt == torch.float64 else torch.int64))
        rc = fns[entry](parts.data_ptr(), out.data_ptr(), 2, HIST_BINS,
                        nunits, stream)
        torch.cuda.synchronize()
        row = hist_row(errs, "bin_finish", case_tag(GRID, torch.float32),
                       out, parts.to(out.dtype).sum(dim=1), torch.float64,
                       pdt != torch.float64)
        emit({"phase": phase, "kernel": "bin_finish", "partials": label,
              "rc": rc, **row})
        if rc or not row["ok"]:
            fails.append(("bin_finish", label))
        del parts, out
    torch.cuda.empty_cache()
    if fails:
        raise SystemExit(f"{phase}: the binning kernels disagree with their "
                         f"plain versions or the grouping build, do not "
                         f"repeat or shard bit for bit: {fails}")


def hist_timing(name, ms, plain_ms, nbytes, library_ms, library_call):
    """A kernels-line row of a binning kernel: its bound is bytes (each
    input read once over the HBM rate); the operations per site are a few
    and the binning's compares none of the FP32 peak."""
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": "bytes", "bytes": nbytes,
            "share_of_bound": bound / ms, "library_ms": library_ms,
            "library_call": library_call}


def in_turns(make, builds, reps=20):
    """CUDA-event ms per launch of ``make(fns)`` for the default build
    (``kernel``) and the grouping yardstick (``match``) in turns (match,
    kernel, kernel, match; each the mean of its two), and of every other
    build of ``builds`` (the HIST_STUDY ones) once after them."""
    got = {}
    for label in ("match", "kernel", "kernel", "match"):
        got.setdefault(label, []).append(
            cuda_ms(make(builds[label]), reps=reps, warmup=2))
    ms = {k: sum(v) / len(v) for k, v in got.items()}
    ms.update({k: cuda_ms(make(fns), reps=reps, warmup=2)
               for k, fns in builds.items() if k not in ms})
    return ms


def hist_builds():
    """The bound entry points of the default histogram.cu build, of its
    grouping yardstick and of the HIST_STUDY builds where they are built."""
    from pystella_tpu_torch.ops import histogram as thist
    return {"kernel": thist.build_kernels(), "match": hist_build(HIST_MATCH),
            **HIST_STUDY_BUILDS}


def hist_study_builds(phase):
    """Build every HIST_STUDY variant of histogram.cu (a patched copy of
    its text under the build directory, one nvcc each, all started
    together, the flags of build_kernels) into HIST_STUDY_BUILDS, and emit
    each build's registers and spills. A patch whose text the source no
    longer holds exits."""
    import ctypes
    from pystella_tpu_torch.ops import histogram as thist
    from pystella_tpu_torch.ops import stencil
    text = (stencil.CSRC_DIR / "histogram.cu").read_text()
    jobs, t0 = {}, time.perf_counter()
    for label, patches in HIST_STUDY.items():
        src = text
        for old, new in patches:
            if src.count(old) != 1:
                raise SystemExit(f"{phase}: {label}: histogram.cu does not "
                                 f"hold {old!r} once")
            src = src.replace(old, new)
        d = stencil.BUILD_DIR / "hist_study" / label
        d.mkdir(parents=True, exist_ok=True)
        (d / "pk_model.cuh").write_text(thist._HEADER)
        (d / "histogram.cu").write_text(src)
        jobs[label] = (d / "libhistogram.so", subprocess.Popen(
            [stencil._nvcc(), *stencil.NVCC_FLAGS, f"-I{d}",
             f"-I{stencil.CSRC_DIR}", "-o", str(d / "libhistogram.so"),
             str(d / "histogram.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    ptxas = {}
    for label, (lib, proc) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"{phase}: {label}: nvcc failed:\n{log}")
        ptxas[label] = stencil.ptxas_usage(log)
        HIST_STUDY_BUILDS[label] = thist.bind_kernels(ctypes.CDLL(str(lib)))
    emit({"phase": phase, "seconds": time.perf_counter() - t0,
          "builds": list(HIST_STUDY), "ptxas": ptxas})


def k14_timing(fk, sp, builds, direct, finish=None):
    """K14's ms per launch on ``fk`` (outer, X, Y, nzk) complex64 by every
    build (``in_turns``), its bytes bound, its plain version's time and
    ``torch.bincount``'s on precomputed bins and weights; ``direct`` gets
    the direct launch's result (sums, finished) against the wrapper's. With
    a dict ``finish``, the finish's row on K14's own partials (most of a
    unit's shells are empty: zeros, which the card reads faster) goes into
    it."""
    from pystella_tpu_torch.ops import histogram as thist
    outer, X, Y, nzk = fk.shape
    ry = thist.unit_rows(Y)
    nyr, nunits, nb = Y // ry, X * (Y // ry), sp.num_bins
    stream = torch.cuda.current_stream().cuda_stream
    p14 = torch.empty((outer, nunits, nb), device="cuda",
                      dtype=torch.float64)
    sx, sy, sz = sp.binner.tables(fk.device)

    def k14(fns):
        return lambda: fns["pk_spectra_bin_f32"](
            fk.data_ptr(), sx.data_ptr(), sy.data_ptr(), sz.data_ptr(),
            sp.bin_width, 3, 3.0, GRID[2], 1, 0, 0, p14.data_ptr(), outer,
            X, Y, nzk, nb, ry, 0, 0, nyr, nunits, stream)
    k14(builds["kernel"])()
    out = torch.empty((outer, nb), device="cuda", dtype=torch.float64)
    builds["kernel"]["pk_bin_finish_sum"](p14.data_ptr(), out.data_ptr(),
                                          outer, nb, nunits, stream)
    direct["spectra_bin"] = torch.equal(out, sp.binner(fk, 3))
    ms = in_turns(k14, {k: v for k, v in builds.items()
                        if not k.startswith("k13")})
    kmag, kb, counts = sp.binner.site_arrays(fk.device, 0, 0, X, Y)
    w = (counts * kmag**3 * torch.abs(fk)**2).reshape(outer, -1)
    kflat = (kb.reshape(1, -1).to(torch.int64)
             + nb * torch.arange(outer, device="cuda")[:, None]).reshape(-1)
    del kmag, kb, counts
    row = hist_timing(
        "spectra_bin", ms["kernel"],
        cuda_ms(lambda: sp.binner.plain(fk, 3), reps=3),
        fk.numel() * fk.element_size(),
        cuda_ms(lambda: torch.bincount(kflat, weights=w.reshape(-1),
                                       minlength=outer * nb), reps=5),
        f"torch.bincount(bins, weights=counts*|k|^3*|fk|^2, "
        f"minlength={outer}*num_bins) on precomputed bins and weights "
        "(float atomics)")
    row.update({"match_ms": ms["match"],
                "variants_ms": {k: v for k, v in ms.items()
                                if k not in ("kernel", "match")},
                "outer": outer, "partials_bytes": p14.numel() * 8})
    if finish is not None:
        k14(builds["kernel"])()

        def fin():
            builds["kernel"]["pk_bin_finish_sum"](
                p14.data_ptr(), out.data_ptr(), outer, nb, nunits, stream)
        finish.update(hist_timing(
            "bin_finish", cuda_ms(fin, reps=20, warmup=2),
            cuda_ms(lambda: p14.sum(dim=1), reps=5), p14.numel() * 8,
            cuda_ms(lambda: torch.sum(p14, dim=1), reps=5),
            "torch.sum(partials, dim=1) (also the plain version)"))
        finish["partials_bytes"] = p14.numel() * 8
    del p14, out, w, kflat
    torch.cuda.empty_cache()
    return row


def time_binning(rho_bins, fk, sp, timing):
    """K13's, K14's and the finish's ms per launch on the main path's
    inputs (the linear rho histogram's int32 bins; the two fields' half
    spectrum), each against its bytes bound, its plain version and
    ``torch.bincount`` (the finish: ``torch.sum`` over the units); K13 and
    K14 beside the grouping yardstick (``match_ms``) and the HIST_STUDY
    builds where they are built, and K13 also on hot-bin inputs of the same
    size (every site in one bin, 90% of them in two) by each build."""
    from pystella_tpu_torch.ops import histogram as thist
    builds = hist_builds()
    fns = builds["kernel"]
    stream = torch.cuda.current_stream().cuda_stream
    _, X, Y, Z = rho_bins.shape
    ry = thist.unit_rows(Y)
    nyr, nunits = Y // ry, X * (Y // ry)
    p13 = torch.empty((1, nunits, HIST_BINS), device="cuda",
                      dtype=torch.int32)

    def k13(bins):
        return lambda fns: lambda: fns["pk_bincount_count"](
            bins.data_ptr(), p13.data_ptr(), 1, X, Y, Z, HIST_BINS, ry, 0,
            0, nyr, nunits, stream)
    k13(rho_bins)(fns)()
    torch.cuda.synchronize()
    # the direct launches agree with the wrappers'
    direct = {"bincount": torch.equal(
        p13.to(torch.int64).sum(dim=1)[0],
        thist.bincount(rho_bins, None, HIST_BINS)[0])}
    k13_builds = {k: v for k, v in builds.items() if not k.startswith("k14")}
    ms = in_turns(k13(rho_bins), k13_builds)
    g = torch.Generator(device="cuda").manual_seed(22)
    hot = {}
    for kind in ("hot1", "hot2"):
        bins = hot_bins(kind, tuple(rho_bins.shape), g)
        hot[kind] = in_turns(k13(bins), k13_builds)
        del bins
    flat = rho_bins.reshape(-1).to(torch.int64)
    timing["bincount"] = hist_timing(
        "bincount", ms["kernel"],
        cuda_ms(lambda: thist.bincount_plain(rho_bins, None, HIST_BINS),
                reps=3), rho_bins.numel() * 4,
        cuda_ms(lambda: torch.bincount(flat, minlength=HIST_BINS), reps=5),
        "torch.bincount(bins.long().flatten(), minlength=1000) (atomics)")
    timing["bincount"].update({
        "match_ms": ms["match"],
        "variants_ms": {k: v for k, v in ms.items()
                        if k not in ("kernel", "match")},
        "hot_bins_ms": hot, "copies": thist.HIST_COPIES,
        "partials_bytes": p13.numel() * 4})
    del flat, p13
    timing["bin_finish"] = {}
    timing["spectra_bin"] = k14_timing(fk, sp, builds, direct,
                                       timing["bin_finish"])
    same = all(direct.values())
    for name in SPECTRA_KERNELS:
        timing[name]["launch_matches_wrapper"] = same
        timing[name]["unit_rows"] = ry
    torch.cuda.empty_cache()
    return same


def spectra_main_path(phase, timing, launches):
    """The science example's start and measurement step at 512^3 f32, two
    fields, through the port's entry points: the WKB initial state
    (RayleighGenerator.init_WKB_fields, seed 49279), SPECTRA_STEPS steps of
    coupled_multi_step, then FieldStatistics, FiniteDifferencer.grad, rho
    through ElementWiseMap, FieldHistogrammer(1000)(rho), PowerSpectra of
    the two fields and of rho, and, on a GW stepper's state after two
    steps, PowerSpectra.gw. Each piece's ms per call (CUDA events after a
    warm-up), torch.fft.rfftn's own time on the same arrays, the binning
    kernels' launches (counts set to 0 just before the measurement step,
    read just after) and times (K14 also on the GW spectrum's projected
    input), peak memory; every result finite, and the spectra and
    histogram of (2, 2, 1) bit for bit the single device's."""
    import pystella_tpu_torch as pt
    from pystella_tpu_torch.ops import derivs as tderivs
    from pystella_tpu_torch.ops import fused as tfused
    from pystella_tpu_torch.ops import histogram as thist
    t0 = time.perf_counter()
    lattice = pt.Lattice(GRID, (BOX,) * 3, dtype=np.float32)
    dx, sites = lattice.dx[0], math.prod(GRID)
    dt = 0.1 * dx
    sector = pt.ScalarSector(2, potential=potential)
    fd = pt.FiniteDifferencer(HALO, lattice.dx)
    fft = pt.DFT(None, grid_shape=GRID, dtype=np.float32, device="cuda")
    reduce_energy = pt.Reduction(sector, callback=pt.get_rho_and_p,
                                 grid_size=float(sites))

    def energy_of(state, a):
        return reduce_energy(f=state["f"], dfdt=state["dfdt"],
                             lap_f=fd.lap(state["f"]), a=np.float64(a))

    torch.cuda.reset_peak_memory_stats()
    state = {k: torch.stack([torch.full(GRID, v[i], device="cuda",
                                        dtype=torch.float32)
                             for i in range(2)])
             for k, v in (("f", F0), ("dfdt", DF0))}
    energy = energy_of(state, 1.0)
    expand = pt.Expansion(energy["total"], pt.LowStorageRK54, mpl=1.0)
    addot = expand.addot_friedmann_2(expand.a, energy["total"],
                                     energy["pressure"])
    fsym = pt.Field("f0_bg", shape=(2,))
    eff_mass = [float(pt.evaluate(pt.diff(potential(fsym), fsym[i], fsym[i]),
                                  {"f0_bg": np.array(F0)})) - addot / expand.a
                for i in range(2)]
    modes = pt.RayleighGenerator(fft=fft, dk=lattice.dk,
                                 volume=lattice.volume, seed=SPECTRA_SEED)
    torch.cuda.synchronize()
    init0 = time.perf_counter()
    for fld in range(2):
        fx, dfx = modes.init_WKB_fields(
            norm=MPHI**2, hubble=expand.hubble,
            omega_k=lambda k, m=eff_mass[fld]: torch.sqrt(k**2 + m))
        state["f"][fld] += fx
        state["dfdt"][fld] += dfx
        del fx, dfx
    torch.cuda.synchronize()
    init_s = time.perf_counter() - init0
    energy = energy_of(state, expand.a)
    expand = pt.Expansion(energy["total"], pt.LowStorageRK54, mpl=1.0)
    st = pt.FusedScalarStepper(sector, GRID, dx, HALO, dtype=torch.float32,
                               device="cuda")
    state = {k: v.clone() for k, v in st.coupled_multi_step(
        state, SPECTRA_STEPS, expand, 0.0, dt).items()}
    del st
    torch.cuda.empty_cache()
    f, dfdt = state["f"], state["dfdt"]

    stats = pt.FieldStatistics(grid_size=float(sites))
    spectra = pt.PowerSpectra(None, fft, lattice.dk, lattice.volume)
    projector = pt.Projector(fft, HALO, lattice.dk, lattice.dx)
    hist = pt.FieldHistogrammer(None, HIST_BINS)
    hubble_var = pt.Var("hubble")
    compute_rho = pt.ElementWiseMap(
        {pt.Field("rho"): sector.stress_tensor(0, 0)
         / (3 * hubble_var**2 / 8 / np.pi)})
    a, hub = np.float64(expand.a), np.float64(expand.hubble)

    # the measurement step, once, with the launch counts set to 0 just
    # before it and read just after
    for mod in (tfused, tderivs, thist):
        mod.reset_launch_counts()
    torch.cuda.synchronize()
    step0 = time.perf_counter()
    f_stats = stats(f)
    dfdx = fd.grad(f)
    rho = compute_rho(a=a, hubble=hub, f=f, dfdt=dfdt, dfdx=dfdx)["rho"]
    rho_hist = hist(rho)
    spec_f, spec_rho = spectra(f), spectra(rho)
    step_s = time.perf_counter() - step0
    step_launches = {n: c for mod in (tfused, tderivs, thist)
                     for n, c in mod.LAUNCHES.items() if c}
    for name in SPECTRA_KERNELS:
        launches[name] = thist.LAUNCHES[name]

    # each piece's time per call
    pieces = {
        "FieldStatistics": lambda: stats(f),
        "FiniteDifferencer.grad": lambda: fd.grad(f),
        "ElementWiseMap(rho)": lambda: compute_rho(
            a=a, hubble=hub, f=f, dfdt=dfdt, dfdx=dfdx),
        "FieldHistogrammer(1000)(rho)": lambda: hist(rho),
        "PowerSpectra(f)": lambda: spectra(f),
        "PowerSpectra(rho)": lambda: spectra(rho),
        "torch.fft.rfftn(f)": lambda: torch.fft.rfftn(f, dim=(-3, -2, -1)),
        "torch.fft.rfftn(rho)": lambda: torch.fft.rfftn(rho,
                                                        dim=(-3, -2, -1))}
    ms = {k: cuda_ms(fn, reps=3) for k, fn in pieces.items()}
    # a shell numpy's histogram leaves empty (the last at 512^3 f32, as in
    # the JAX package) divides by 0: finite is asked of the others
    shells = spectra.bin_counts > 0
    finite = bool(all(np.all(np.isfinite(v)) for v in f_stats.values())
                  and all(np.all(np.isfinite(v)) for v in rho_hist.values())
                  and np.all(np.isfinite(spec_f[..., shells]))
                  and np.all(np.isfinite(spec_rho[shells]))
                  and bool(torch.isfinite(rho).all()))
    shapes = (spec_f.shape == (2, spectra.num_bins)
              and spec_rho.shape == (spectra.num_bins,)
              and rho_hist["linear"].shape == (HIST_BINS,)
              and int(rho_hist["linear"].sum()) == sites)

    # the binning kernels alone, on these inputs
    bins = hist._prepare({"f": rho, **{
        k: torch.as_tensor(np.reshape(v, np.shape(v) + (1, 1, 1)),
                           device="cuda")
        for k, v in hist._sanitize_bounds(hist._auto_bounds(rho),
                                          np.float32).items()}})["linear"][0]
    fk = torch.fft.rfftn(f, dim=(-3, -2, -1))
    direct_ok = time_binning(bins[None].contiguous(), fk, spectra, timing)
    del bins, fk, dfdx
    torch.cuda.empty_cache()

    # (2, 2, 1): the spectra and the histogram bit for bit
    d = pt.DomainDecomposition((2, 2, 1))
    fs = pt.DFT(d, grid_shape=GRID, dtype=np.float32)
    ss = pt.PowerSpectra(d, fs, lattice.dk, lattice.volume)
    sharded_equal = {
        "spectra_f": np.array_equal(ss(d.shard(f)), spec_f, equal_nan=True),
        "spectra_rho": np.array_equal(ss(d.shard(rho)), spec_rho,
                                      equal_nan=True),
        "rho_histogram": all(np.array_equal(v, rho_hist[k]) for k, v in
                             pt.FieldHistogrammer(d, HIST_BINS)(
                                 d.shard(rho)).items())}
    del ss, fs, d
    torch.cuda.empty_cache()

    # the GW spectrum of a GW stepper's state, two steps from hij = 0
    gw_sector = pt.TensorPerturbationSector([sector])
    gst = pt.FusedPreheatStepper(sector, gw_sector, GRID, dx, HALO,
                                 dtype=torch.float32, device="cuda")
    zeros = torch.zeros((6,) + GRID, device="cuda", dtype=torch.float32)
    gstate = gst.multi_step({"f": f, "dfdt": dfdt, "hij": zeros,
                             "dhijdt": zeros.clone()}, 2, 0.0, dt,
                            {"a": float(a), "hubble": float(hub)})
    dhijdt = gstate["dhijdt"].clone()
    del gst, gstate, zeros
    torch.cuda.empty_cache()
    thist.reset_launch_counts()
    spec_gw = spectra.gw(dhijdt, projector, hub)
    gw_launches = dict(thist.LAUNCHES)
    ms["PowerSpectra.gw(dhijdt)"] = cuda_ms(
        lambda: spectra.gw(dhijdt, projector, hub), reps=2)
    ms["torch.fft.rfftn(dhijdt)"] = cuda_ms(
        lambda: torch.fft.rfftn(dhijdt, dim=(-3, -2, -1)), reps=3)
    finite = finite and bool(np.all(np.isfinite(spec_gw[shells])))
    sourced = bool(np.any(spec_gw[shells] > 0))
    peak = torch.cuda.max_memory_allocated() / 2**30
    # K14 alone on the GW spectrum's input: the six projected components
    hij_tt = projector.transverse_traceless(
        spectra._dft_whole(dhijdt)).contiguous()
    gw_direct = {}
    timing["spectra_bin"]["gw_input"] = k14_timing(
        hij_tt, spectra, hist_builds(), gw_direct)
    direct_ok = direct_ok and gw_direct["spectra_bin"]
    del hij_tt
    del dhijdt
    torch.cuda.empty_cache()
    row = {"phase": phase, "grid": GRID, "dtype": "torch.float32",
           "steps": SPECTRA_STEPS, "init_WKB_s": init_s,
           "measurement_step_host_s": step_s, "ms_per_call": ms,
           "launches_per_measurement_step": step_launches,
           "launches_gw_spectrum": {k: v for k, v in gw_launches.items()
                                    if v},
           "peak_memory_GiB": peak, "a": float(a), "hubble": float(hub),
           "spectra_bins": spectra.num_bins,
           "empty_shells": np.flatnonzero(~shells).tolist(),
           "constraint": float(expand.constraint(
               energy_of(state, expand.a)["total"])),
           "f_mean": f_stats["mean"].tolist(),
           "f_variance": f_stats["variance"].tolist(),
           "finite": finite, "shapes_ok": shapes, "gw_sourced": sourced,
           "direct_launch_matches_wrapper": direct_ok,
           "sharded_221_equal": sharded_equal,
           "binning": {k: timing[k] for k in SPECTRA_KERNELS},
           "seconds": time.perf_counter() - t0}
    emit(row)
    if not (finite and shapes and sourced and direct_ok
            and all(sharded_equal.values())):
        raise SystemExit(f"{phase}: a non-finite or misshapen result, an "
                         "unsourced GW spectrum, or a (2, 2, 1) result that "
                         f"differs from the single device's: {row}")
    for name in SPECTRA_KERNELS:
        if launches[name] < 1:
            raise SystemExit(f"{phase} never launched {name}")
    del state, f, dfdt, rho
    torch.cuda.empty_cache()


#: the health kernel (K15) and its finish (ops/csrc/health.cu)
HEALTH_KERNELS = ("health", "health_finish")
#: K15's rms against its plain version, relative: both sum the same
#: float64 squares, in another order
HEALTH_TOL = 1e-12
#: the health path: steps a coupled chunk, the steps run uninterrupted and
#: the step of the checkpoint that the resumed run restarts from
HEALTH_CHUNK, HEALTH_STEPS, HEALTH_RESUME = 3, 6, 3


def health_poisoned(x, kind):
    """A copy of ``x`` with a NaN, +inf or -inf site, or scaled to 1e20
    (finite in f32, its square not: ``overflow``); ``clean`` is ``x``."""
    if kind == "clean":
        return x
    if kind == "overflow":
        return x * 1e20
    y = x.clone()
    y.view(-1)[y.numel() // 3 + 7] = float(kind)
    return y


def health_row(errs, tag, got, ref, again, sharded):
    """Hold K15's vector to its plain version's (finite and max_abs equal,
    NaN where NaN; rms within HEALTH_TOL, equal where not finite), a second
    launch's and a (2, 2, 1) run's bit for bit; the row goes into
    ``errs["health"]`` and the finish's share into
    ``errs["health_finish"]``."""
    g, r = got.view(-1, 3), ref.view(-1, 3)
    exact = torch.equal(g[:, :2].nan_to_num(7.0), r[:, :2].nan_to_num(7.0))
    fin = torch.isfinite(r[:, 2])
    d = (g[:, 2] - r[:, 2]).abs()
    rel = (d[fin] / r[fin, 2].abs().clamp_min(1e-300)).max().item() \
        if bool(fin.any()) else 0.0
    same_nf = torch.equal(g[~fin, 2].nan_to_num(7.0),
                          r[~fin, 2].nan_to_num(7.0))
    repeat = torch.equal(got.nan_to_num(7.0), again.nan_to_num(7.0))
    shard_eq = None if sharded is None else torch.equal(
        got.nan_to_num(7.0), sharded.nan_to_num(7.0))
    row = {"max_rel_err": rel, "max_abs_err": d[fin].max().item()
           if bool(fin.any()) else 0.0,
           "finite_and_max_abs_equal": exact, "nonfinite_rms_equal": same_nf,
           "repeat_equal": repeat, "sharded_221_equal": shard_eq,
           "tol": HEALTH_TOL,
           "ok": exact and same_nf and repeat and shard_eq is not False
           and rel <= HEALTH_TOL}
    for name in HEALTH_KERNELS:
        errs.setdefault(name, {})[tag] = row
    return row


def health_kernel_vs_plain(phase, errs):
    """K15 and its finish against their plain version on two fields of
    (2, X, Y, Z): at 512^3 f32 the coupled-preheat state (the example's
    background plus fluctuations), with a NaN site in a copy; at 256^3 and
    48x40x36 in f32 and f64 (and bf16 at 48x40x36) clean and with a NaN,
    +inf, -inf or overflowing site. Each twice for equal bits, and on
    (2, 2, 1) blocks on the card equal to the single-device vector (where
    a block's y-extent holds whole units: not at 48x40x36)."""
    import pystella_tpu_torch as pt
    from pystella_tpu_torch.ops import health as thealth
    t0 = time.perf_counter()
    d221 = pt.DomainDecomposition((2, 2, 1))
    cases = [(GRID, torch.float32, k) for k in ("clean", "nan")]
    cases += [(s, dt, k) for s in ALT_SHAPES
              for dt in (torch.float32, torch.float64)
              for k in ("clean", "nan", "inf", "-inf", "overflow")]
    cases += [(ALT_SHAPES[1], torch.bfloat16, k)
              for k in ("clean", "nan", "overflow")]
    rows, ok = {}, True
    for shape, dtype, kind in cases:
        st = background_state(shape, torch.float32, 5)
        x, y = (health_poisoned(st[n].to(dtype), kind)
                for n in ("dfdt", "f"))
        del st
        fields = [x, y]
        ref = thealth.field_stats_plain(fields, torch.float64)
        got = thealth.field_stats(fields, torch.float64)
        again = thealth.field_stats(fields, torch.float64)
        # (2, 2, 1) where a block's y-extent holds whole units (K13's rule)
        sharded = None if shape[-2] // 2 % thealth.unit_rows(shape[-2]) \
            else thealth.field_stats([d221.shard(x), d221.shard(y)],
                                     torch.float64)
        tag = case_tag(shape, dtype) + ("" if kind == "clean"
                                        else f":{kind}")
        row = health_row(errs, tag, got, ref, again, sharded)
        rows[tag] = row
        ok = ok and row["ok"]
        del x, y, fields, sharded
        torch.cuda.empty_cache()
    emit({"phase": phase, "cases": rows, "ok": ok,
          "seconds": time.perf_counter() - t0})
    if not ok:
        raise SystemExit(f"{phase}: K15 disagrees with its plain version, "
                         "with itself or with its (2, 2, 1) launches")


def time_health(timing, state):
    """K15's ms on the coupled-preheat state at 512^3 f32 (its two main
    launches, one a field, by direct calls to the entry point) and its
    finish's, each against its bytes bound (the state read once; the
    partials read once), the plain version's time and the library
    yardstick's: torch.aminmax and torch.linalg.vector_norm a field, which
    together give max|x| and the rms."""
    from pystella_tpu_torch.ops import health as thealth
    fns = thealth.build_kernels()
    stream = torch.cuda.current_stream().cuda_stream
    fields = [state["dfdt"], state["f"]]
    n, X, Y, Z = fields[0].shape
    ry = thealth.unit_rows(Y)
    units = n * X * (Y // ry)
    pmax = torch.empty(2 * units, device="cuda", dtype=torch.float64)
    psum = torch.empty_like(pmax)
    out = torch.empty(6, device="cuda", dtype=torch.float32)
    nsm = torch.cuda.get_device_properties(0).multi_processor_count

    def mains():
        for k, x in enumerate(fields):
            fns["pk_health_f32"](x.data_ptr(), pmax.data_ptr(),
                                 psum.data_ptr(), units, ry, X, Y, Z, X, Y,
                                 0, 0, k * units, nsm, stream)
    arr = (lambda t, v: (t * len(v))(*v))
    fargs = (pmax.data_ptr(), psum.data_ptr(), 2,
             arr(ctypes.c_int64, [0, units]),
             arr(ctypes.c_int64, [units] * 2),
             arr(ctypes.c_double, [float(n * X * Y * Z)] * 2),
             arr(ctypes.c_int, [0, 3]), out.data_ptr(), stream)

    def finish():
        fns["pk_health_finish_f32"](*fargs)
    mains()
    finish()
    torch.cuda.synchronize()
    direct_ok = torch.equal(out, thealth.field_stats(fields))
    state_bytes = sum(x.numel() * x.element_size() for x in fields)
    part_bytes = pmax.numel() * 16

    def library():
        for x in fields:
            torch.aminmax(x)
            torch.linalg.vector_norm(x)
    ms = cuda_ms(mains, reps=10, warmup=2)
    timing["health"] = {
        "ms": ms, "plain_ms": cuda_ms(
            lambda: thealth.field_stats_plain(fields), reps=3),
        "bound_ms": state_bytes / HBM_BYTES_PER_S * 1e3,
        "bound_by": "bytes", "bytes": state_bytes,
        "library_ms": cuda_ms(library, reps=10, warmup=2),
        "library_call": "torch.aminmax(x) and torch.linalg.vector_norm(x) "
                        "a field",
        "call_ms": cuda_ms(lambda: thealth.field_stats(fields), reps=10),
        "gw_state_bound_ms": 16 * math.prod(GRID) * 4 / HBM_BYTES_PER_S
        * 1e3, "launch_matches_wrapper": direct_ok,
        "launches_timed": len(fields), "unit_rows": ry,
        "partials_bytes": pmax.numel() * 16}
    timing["health"]["share_of_bound"] = (timing["health"]["bound_ms"]
                                          / ms)
    fms = cuda_ms(finish, reps=20, warmup=2)
    timing["health_finish"] = {
        "ms": fms, "plain_ms": cuda_ms(
            lambda: (torch.amax(pmax), torch.sum(psum)), reps=10),
        "bound_ms": part_bytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
        "bytes": part_bytes, "library_ms": None,
        "launch_matches_wrapper": direct_ok}
    del pmax, psum
    return direct_ok


def health_path(phase, sector, timing, launches):
    """Run safety on the coupled-preheat path at 512^3 f32 (the example's
    background plus fluctuations; K6 and K5 through coupled_multi_step):
    HEALTH_STEPS steps in chunks of HEALTH_CHUNK with
    ``coupled_multi_step(sentinel=)`` under a HealthMonitor (the main path,
    launch counts set to 0 just before it and read just after); the same
    steps again with a synchronous check, a Checkpointer save, finalize
    and restore at HEALTH_RESUME, the final state, a and adot bit for bit
    the uninterrupted run's; a NaN in a copy of the state must raise
    SimulationDiverged at its step, with a forensic bundle that loads and
    names the last good checkpoint. Prints K15's time against its bound,
    the library yardstick's, the check's share of a step, and the save,
    finalize and restore seconds with the bytes written."""
    import shutil
    import tempfile
    import pystella_tpu_torch as pt
    from pystella_tpu_torch.ops import fused as tfused
    from pystella_tpu_torch.ops import health as thealth
    t_start = time.perf_counter()
    sites = math.prod(GRID)
    dx = BOX / GRID[0]
    dt = 0.1 * dx
    st = pt.FusedScalarStepper(sector, GRID, dx, HALO, dtype=torch.float32,
                               device="cuda")
    fd = pt.FiniteDifferencer(HALO, dx)
    reduce_energy = pt.Reduction(sector, callback=pt.get_rho_and_p,
                                 grid_size=float(sites))
    state0 = background_state(GRID, torch.float32, 11)
    energy0 = reduce_energy(f=state0["f"], dfdt=state0["dfdt"],
                            lap_f=fd.lap(state0["f"]), a=np.float64(1.0))
    del fd

    def expansion(a=None, adot=None):
        e = pt.Expansion(energy0["total"], pt.LowStorageRK54, mpl=1.0)
        if a is not None:
            e.a, e.adot = e.dtype.type(a), e.dtype.type(adot)
            e.hubble = e.adot / e.a
        return e

    def run(state, exp, mon, step, nsteps):
        t = step * dt
        for _ in range(nsteps // HEALTH_CHUNK):
            state, hv = st.coupled_multi_step(
                state, HEALTH_CHUNK, exp, t, dt,
                sentinel=mon.sentinel_for(state))
            step += HEALTH_CHUNK
            t += HEALTH_CHUNK * dt
            mon.push(step, hv)
            mon.poll()
        return state, step

    work = tempfile.mkdtemp(prefix="health_path_")
    log = os.path.join(work, "events.jsonl")
    pt.obs.configure(log)
    try:
        # the main path: uninterrupted, counts read just after it
        mon = pt.HealthMonitor(every=HEALTH_CHUNK)
        exp = expansion()
        for mod in (tfused, thealth):
            mod.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        final, _ = run({k: v.clone() for k, v in state0.items()}, exp, mon,
                       0, HEALTH_STEPS)
        mon.flush()
        torch.cuda.synchronize()
        path_s = time.perf_counter() - t0
        path_launches = {n: c for mod in (tfused, thealth)
                         for n, c in mod.LAUNCHES.items() if c}
        for name in HEALTH_KERNELS:
            launches[name] = thealth.LAUNCHES[name]
        final = {k: v.clone() for k, v in final.items()}
        a_ref, adot_ref = float(exp.a), float(exp.adot)
        checked = mon.checked_through

        # the same run, checkpointed and resumed at HEALTH_RESUME
        ck = pt.Checkpointer(os.path.join(work, "ckpts"), max_to_keep=2)
        mon = pt.HealthMonitor(every=HEALTH_CHUNK)
        sink = pt.obs.ForensicSink(os.path.join(work, "forensics"),
                                   events_path=log, checkpoint=ck,
                                   label="health_path")
        mon.forensics = sink
        exp = expansion()
        state, step = run({k: v.clone() for k, v in state0.items()}, exp,
                          mon, 0, HEALTH_RESUME)
        mon.check_now(state, step=step)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ck.save(step, state, metadata={"t": step * dt, "a": float(exp.a),
                                       "adot": float(exp.adot)})
        save_s = time.perf_counter() - t0
        last_good_before = ck.last_good
        t0 = time.perf_counter()
        ck.finalize()
        finalize_s = time.perf_counter() - t0
        nbytes = ck.bytes_written[step]
        del state
        t0 = time.perf_counter()
        rstep, state, meta = ck.restore()
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        exp = expansion(meta["a"], meta["adot"])
        state, step = run(state, exp, mon, rstep,
                          HEALTH_STEPS - HEALTH_RESUME)
        mon.flush()
        resumed_equal = (all(torch.equal(state[k], final[k])
                             for k in final)
                         and float(exp.a) == a_ref
                         and float(exp.adot) == adot_ref)

        # a NaN in a copy of the state trips at its step, with a bundle
        bad = {k: v.clone() for k, v in state.items()}
        bad["dfdt"][1, 100, 200, 300] = float("nan")
        trip_step = step + HEALTH_CHUNK
        mon.observe(trip_step, bad)
        tripped = None
        try:
            mon.flush()
        except pt.SimulationDiverged as e:
            tripped = e
        bundle = (pt.obs.load_bundle(sink.last_bundle)
                  if sink.last_bundle else None)
        trip_ok = (tripped is not None and tripped.step == trip_step
                   and tripped.bad_fields == ("dfdt",)
                   and bundle is not None
                   and bundle["trip"]["step"] == trip_step
                   and bundle["last_good_checkpoint"]["step"]
                   == HEALTH_RESUME)
        ck.close()

        # the check's share of a step: one call of the sentinel on the
        # state against one coupled step's ms
        sen = mon.sentinel_for(final)
        check_ms = cuda_ms(lambda: sen.compute_jit(final), reps=10)
        exp_t = expansion(a_ref, adot_ref)
        chunk_ms = cuda_ms(lambda: st.coupled_multi_step(
            final, HEALTH_CHUNK, exp_t, 0.0, dt), reps=2)
        step_ms = chunk_ms / HEALTH_CHUNK
        direct_ok = time_health(timing, final)
        kinds = sorted({e["kind"] for e in pt.obs.read_events(log)})
    finally:
        pt.obs.configure(None)
        shutil.rmtree(work, ignore_errors=True)
    t = timing["health"]
    row = {"phase": phase, "grid": GRID, "dtype": "torch.float32",
           "steps": HEALTH_STEPS, "chunk_steps": HEALTH_CHUNK,
           "resume_step": HEALTH_RESUME, "path_s": path_s,
           "launches": path_launches, "checked_through": checked,
           "resumed_equal_bitwise": resumed_equal,
           "trip_step": None if tripped is None else tripped.step,
           "trip_fields": None if tripped is None else tripped.bad_fields,
           "bundle_loads": bundle is not None, "trip_ok": trip_ok,
           "last_good_before_finalize": last_good_before,
           "save_s": save_s, "finalize_s": finalize_s,
           "restore_s": restore_s, "bytes_written": nbytes,
           "k15_ms": t["ms"], "k15_bound_ms": t["bound_ms"],
           "k15_share_of_bound": t["share_of_bound"],
           "library_ms": t["library_ms"], "plain_ms": t["plain_ms"],
           "check_call_ms": check_ms, "step_ms": step_ms,
           "check_share_of_step": check_ms / step_ms,
           "event_kinds": kinds, "direct_launch_matches_wrapper": direct_ok,
           "seconds": time.perf_counter() - t_start}
    emit(row)
    del st, state0, final, state, bad
    torch.cuda.empty_cache()
    needed = ("coupled_pair", "coupled_pair_deferred", "fused_stage_energy",
              "health", "health_finish")
    missing = [n for n in needed if not path_launches.get(n)]
    if not (resumed_equal and trip_ok and direct_ok
            and last_good_before is None) or missing:
        raise SystemExit(f"{phase}: resume not bitwise, the trip or its "
                         f"bundle wrong, or kernels {missing} never "
                         f"launched: {row}")


#: the phase groups of a run, in run order, each with the groups whose
#: results it reads; with no selection a run takes every one of PHASES
PHASES = ("scalar", "gw", "fd", "mg", "sharded_mg", "sharded",
          "sharded_coupled", "sharded_gw", "sharded_bf16", "spectra",
          "health")
PHASE_DEPS = {"sharded_mg": ("mg",), "sharded": ("scalar",),
              "sharded_coupled": ("scalar",), "sharded_gw": ("gw",),
              "sharded_bf16": ("scalar", "gw"), "hist_variants": ("spectra",)}
#: phases a run takes only when selected: march_variants builds the x-march
#: variants of K3 and K6, of K8 and K9, of K10, of K5' and K7, of K5 and K2
#: (beside K2's per-site build), of fd_lap, of fd_grad, fd_grad_lap, fd_div
#: and fd_pd* and of K11 into libraries of their own and times them
#: (fd_ops.cu's queue marches and K11 beside their per-site builds, on the
#: x shells and on the multigrid path's levels); hist_variants builds the
#: HIST_STUDY variants of histogram.cu and times them in the spectra group
OPT_IN_PHASES = ("march_variants", "hist_variants")
PHASE_HELP = {
    "scalar": "the scalar system: kernels vs plain, identities, references, "
              "kernel times, the pair, chunk, bf16 and coupled main paths",
    "gw": "the GW system: the same, and the gw-bf16 and coupled-gw-bf16 "
          "paths",
    "fd": "the operators (K12) vs plain, their times (and the circular "
          "convolution's), the wave reference and main path",
    "mg": "the multigrid sweeps (K11) vs plain, their times, reference, "
          "main path and trace",
    "sharded_mg": "the sharded multigrid phases",
    "sharded": "the padded launches vs plain and their times, the sharded "
               "hot loop, its trace and the sharded operators",
    "sharded_coupled": "the sharded coupled driver and its trace",
    "sharded_gw": "the sharded GW multi_step and coupled driver",
    "sharded_bf16": "the sharded bf16-carry launches and paths",
    "spectra": "the binning kernels (K13, K14, the finish) vs plain, and "
               "the science example's start and measurement step (rho "
               "histogram, scalar, rho and GW spectra) at 512^3 f32",
    "march_variants": "the x-march tile variants of K3 and K6 deferred, "
                      "of K8 and K9 deferred, of K10, of K5' and K7, of K5 "
                      "and K2, of fd_lap, of fd_grad, fd_grad_lap, fd_div "
                      "and fd_pd* and of K11, built apart and timed "
                      "against each other "
                      "(beside the per-site builds; the fd x shells, K11 "
                      "on each level)",
    "health": "the health kernel (K15, its finish) vs plain, and run "
              "safety on the coupled-preheat path at 512^3 f32 "
              "(coupled_multi_step(sentinel=) under a HealthMonitor, "
              "checkpoint, finalize, restore and resume bit for bit, a NaN "
              "trip with its forensic bundle)",
    "hist_variants": "study builds of histogram.cu (K13's histogram copies, "
                     "K14's blocks an SM, K14 without a part of its work) "
                     "timed beside the default in the spectra group"}


def selected_phases(argv):
    """The phase groups a run takes: ``--phases a,b,...`` (or the
    environment's ``PYSTELLA_SMOKE_PHASES``) and every group they read;
    every group of :data:`PHASES` without either. An unknown name exits
    with status 2."""
    import argparse
    parser = argparse.ArgumentParser(
        description="Smoke run of the PyTorch/CUDA port on one GPU.",
        epilog="phases: " + "; ".join(f"{k}: {v}"
                                      for k, v in PHASE_HELP.items()))
    parser.add_argument(
        "--phases", default=os.environ.get("PYSTELLA_SMOKE_PHASES"),
        help="comma-separated phase groups (default: all of "
             f"{', '.join(PHASES)})")
    args = parser.parse_args(argv)
    if not args.phases:
        return set(PHASES)
    wanted = [p.strip() for p in args.phases.split(",") if p.strip()]
    unknown = [p for p in wanted if p not in PHASE_HELP]
    if unknown or not wanted:
        parser.error(f"unknown phases {unknown}; choose from "
                     f"{', '.join(PHASE_HELP)}")
    out = set()
    while wanted:
        p = wanted.pop()
        if p not in out:
            out.add(p)
            wanted.extend(PHASE_DEPS.get(p, ()))
    return out


def main(argv=None):
    start_s = time.perf_counter()
    phases = selected_phases(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import pystella_tpu_torch as pt
    from pystella_tpu_torch.ops import fused as tfused

    # -- 1. device -----------------------------------------------------------
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    emit({"phase": "device", "name": kind, "nvidia_smi": smi,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "phases": [p for p in PHASES + OPT_IN_PHASES if p in phases]})

    sector = pt.ScalarSector(2, potential=potential)
    gw_sector = pt.TensorPerturbationSector([sector])
    gw_bench_sector = pt.ScalarSector(2, potential=gw_bench_potential)
    gw_bench_gw = pt.TensorPerturbationSector([gw_bench_sector])
    dx = BOX / GRID[0]
    scalar_kernels = [n for r, n in pt.FusedScalarStepper._KERNEL.items()
                      if r != "chunk"]
    chunk_kernels = ["fused_stage", "fused_pair", "fused_chunk"]

    # -- 2. build (every kernel, float32 and float64, with and without bf16
    #       carries, one nvcc a source; the scalar model's sources, the
    #       chunk's included, and the GW model's all at once) ----------------
    #       the operators' (one library a stencil radius) and the multigrid
    #       solvers' (one a set of equations), each source its own nvcc
    from pystella_tpu_torch.multigrid import relax as trelax
    from pystella_tpu_torch.ops import derivs as tderivs
    from pystella_tpu_torch.ops import health as thealth
    from pystella_tpu_torch.ops import histogram as thist
    from pystella_tpu_torch.ops import stencil as tstencil
    # the per-site builds beside the marches (fd_ops.cu's, K2's of the
    # bench model; K11 on every level) and K11's build that marches every
    # level, each its own nvcc beside the others
    variant_builds = {
        f"fd_ops.cu (h={h}, per site)": (
            ["fd_ops.cu"], tderivs.kernel_header(h) + FD_PER_SITE)
        for h in FD_HALOS}
    variant_builds["fused_stage.cu (bench, K2 per site)"] = (
        ["fused_stage.cu"], pt.FusedScalarStepper(
            sector, SMALL, dx, HALO, device="cpu").kernel_header()
        + STAGE_PER_SITE)
    variant_builds.update({
        f"mg_relax.cu ({k}, {label})": (
            ["mg_relax.cu"], mg_solver(k, device="cpu").kernel_header() + d)
        for k in ("newton", "jacobi")
        for label, d in (("per site", MG_PER_SITE),
                         ("march every level", MG_MARCH_ALL))})
    # the binning kernels' grouping yardstick
    variant_builds["histogram.cu (grouping)"] = (
        ["histogram.cu"], thist._HEADER + HIST_MATCH)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(16) as pool:
        # no future outlives this line: a future would keep its stepper,
        # and so its buffers, alive after the stepper is deleted
        chunk_st, nonpoly_st, gwb_st, gw_st, newton, jacobi, *_ = [
            f.result() for f in [
            pool.submit(pt.FusedScalarStepper, sector, GRID, dx, HALO,
                        dtype=torch.float32, chunk_stages=CHUNK,
                        device="cuda"),
            # the non-polynomial model's kernels (nonpoly_kernel_vs_plain)
            pool.submit(pt.FusedScalarStepper, pt.ScalarSector(
                2, potential=nonpoly_potential), NONPOLY_SHAPE, dx, HALO,
                dtype=torch.float32, device="cuda"),
            # the GW bench's model (gw_bf16_main_path)
            pool.submit(pt.FusedPreheatStepper, gw_bench_sector,
                        gw_bench_gw, NONPOLY_SHAPE, dx, HALO,
                        dtype=torch.float32, device="cuda"),
            pool.submit(pt.FusedPreheatStepper, sector, gw_sector, GRID, dx,
                        HALO, dtype=torch.float32, device="cuda"),
            pool.submit(mg_solver, "newton"),
            pool.submit(mg_solver, "jacobi"),
            *(pool.submit(tderivs.build_kernels, h) for h in FD_HALOS),
            pool.submit(thist.build_kernels),
            pool.submit(thealth.build_kernels),
            *(pool.submit(tstencil.build_kernels, *b)
              for b in variant_builds.values())]]
    build_s = time.perf_counter() - t0
    main_st = pt.FusedScalarStepper(sector, GRID, dx, HALO,
                                    dtype=torch.float32, device="cuda")
    tiles = {str(d): chunk_st.chunk_kernel_tile(d)
             for d in (torch.float32, torch.float64)}
    new_kernels = {**tderivs.KERNELS, **trelax.KERNELS, **thist.KERNELS,
                   **thealth.KERNELS}
    # each nvcc's wall seconds (they ran together), by source and model
    source_s = {}
    for label, st in (("bench", chunk_st), ("nonpoly", nonpoly_st),
                      ("gw_bench", gwb_st), ("gw", gw_st)):
        header = st.kernel_header()
        for src in sorted({tfused.KERNELS[n][0]
                           for n in st._kernel_bases()}):
            source_s[f"{src} ({label})"] = pt.ops.stencil.build_seconds(
                src, header)
    for h in FD_HALOS:
        source_s[f"fd_ops.cu (h={h})"] = pt.ops.stencil.build_seconds(
            "fd_ops.cu", tderivs.kernel_header(h))
    for label, solver in (("newton", newton), ("jacobi", jacobi)):
        source_s[f"mg_relax.cu ({label})"] = pt.ops.stencil.build_seconds(
            "mg_relax.cu", solver.kernel_header())
    for label, ((src,), header) in variant_builds.items():
        source_s[label] = pt.ops.stencil.build_seconds(src, header)
    source_s["histogram.cu"] = pt.ops.stencil.build_seconds(
        "histogram.cu", thist._HEADER)
    source_s["health.cu"] = pt.ops.stencil.build_seconds(
        "health.cu", thealth._HEADER)
    ptxas = ptxas_report(chunk_st, gw_st)
    emit({"phase": "build", "seconds": build_s,
          "sources": sorted({src for src, _ in tfused.KERNELS.values()}
                            | {src for src, _ in new_kernels.values()}),
          "kernels": chunk_st.kernel_names() + gw_st.kernel_names()
          + list(new_kernels),
          "sharded_kernels": sharded_kernel_names(),
          "sharded_bf16_kernels": sharded_bf16_kernel_names(),
          "build_dir": str(pt.ops.stencil.BUILD_DIR),
          "seconds_per_source": source_s,
          "ptxas": {**ptxas,
                    **{f"fd_ops h={h}": ptxas_of(
                        "fd_ops.cu", tderivs.kernel_header(h))
                       for h in FD_HALOS},
                    **{f"mg_relax {kind}": ptxas_of(
                        "mg_relax.cu", solver.kernel_header())
                       for kind, solver in (("newton", newton),
                                            ("jacobi", jacobi))},
                    "histogram": ptxas_of("histogram.cu", thist._HEADER),
                    "histogram grouping": ptxas_of(
                        "histogram.cu", thist._HEADER + HIST_MATCH),
                    "health": ptxas_of("health.cu", thealth._HEADER)},
          # K10's x-march: run length, y-z tile and bytes a block
          "fused_chunk_tile": {d: {"lx": t[0][0], "tile": t[0][1:],
                                   "smem_bytes_per_block": t[1]}
                               for d, t in tiles.items()}})
    emit({"phase": "build_sharded_bf16_ptxas",
          "kernels": bf16_padded_ptxas(ptxas)})
    # the x-marching kernels (K3, K6; K8, K9; K10; K5'): each source's tile
    # and dynamic shared memory as the library reports it (build_kernels
    # held it to the host mirror), and each instantiation's registers and
    # spills; none of the float ones may spill
    march_rows = march_ptxas(ptxas)
    # the register-queue marches (fd_lap, fd_grad, fd_grad_lap, fd_div,
    # K11): their float
    # instantiations may spill no more than QUEUE_MARCH_F32_SPILLS allows
    queue_rows = {f"{k} (h={h})": u for h in FD_HALOS
                   for k, u in march_ptxas({"fd_ops": demangled(ptxas_of(
                       "fd_ops.cu", tderivs.kernel_header(h)))}).items()}
    queue_rows.update({
        f"{k} ({label})": u for label, solver in (("newton", newton),
                                                  ("jacobi", jacobi))
        for k, u in march_ptxas({"mg_relax": demangled(ptxas_of(
            "mg_relax.cu", solver.kernel_header()))}).items()})
    f32_spills = [n for n, u in march_rows.items() if "<float," in n
                  and (u.get("spill_stores") or u.get("spill_loads"))]
    f32_spills += [n for n, u in queue_rows.items() if "<float," in n
                   and max(u.get("spill_stores", 0), u.get("spill_loads", 0))
                   > QUEUE_MARCH_F32_SPILLS.get(n, 0)]
    mg_tiles = {label: {str(d): trelax.reported_mg_tile(
        tstencil.build_kernels(["mg_relax.cu"], solver.kernel_header())[
            "mg_relax.cu"].pk_mg_tile, d)
        for d in (torch.float32, torch.float64)}
        for label, solver in (("newton", newton), ("jacobi", jacobi))}
    emit({"phase": "build_march_ptxas",
          "tiles": {**{f"{src} ({label})": {
              str(d): st.march_kernel_tile(d, src)
              for d in (torch.float32, torch.float64)}
              for label, st in (("scalar", chunk_st), ("gw", gw_st))
              for src, _ in st._march_sources()},
              "fused_chunk.cu (scalar)": tiles,
              **{f"fd_ops.cu (h={h})": {
                  str(d): {"lap": tderivs.lap_kernel_tile(h, d),
                           **{op: tderivs.reported_queue_tile(
                               tderivs.build_kernels(h)[op + "_tile"], d)
                              for op in tderivs.QUEUE_TILES}}
                  for d in (torch.float32, torch.float64)}
                 for h in FD_HALOS},
              **{f"mg_relax.cu ({k})": t for k, t in mg_tiles.items()}},
          "kernels": march_rows, "f32_spills": f32_spills,
          "queue_march_kernels": queue_rows,
          "queue_march_f32_spill_bytes_allowed": QUEUE_MARCH_F32_SPILLS})
    if f32_spills:
        raise SystemExit(f"float x-march instantiations spill (fd_ops.cu's, "
                         f"K11: beyond QUEUE_MARCH_F32_SPILLS): "
                         f"{f32_spills}")
    del nonpoly_st, gwb_st
    if main_st.kernel_names() != scalar_kernels:
        raise SystemExit("the main model did not build every kernel")
    if chunk_st.kernel_names() != scalar_kernels[:2] + ["fused_chunk"] + \
            scalar_kernels[2:]:
        raise SystemExit("the chunk stepper did not build the chunk kernel")
    if gw_st.kernel_names() != list(GW_KERNELS):
        raise SystemExit("the GW model did not build every kernel")
    if tuple(new_kernels) != FD_KERNELS + MG_KERNELS + SPECTRA_KERNELS \
            + HEALTH_KERNELS:
        raise SystemExit("the operator, multigrid, binning and health "
                         "kernels are not the ones this run checks")
    del newton, jacobi

    # -- 3. kernels vs plain, at the main path's shape and others; every
    #       sum-emitting kernel twice for bit-equal sums ----------------------
    errs = {}
    cases = [(GRID, torch.float32)] + [
        (shape, dtype) for shape in ALT_SHAPES
        for dtype in (torch.float32, torch.float64)]

    def scalar_stepper(shape, dtype, carry_dtype=None, chunk=0):
        return pt.FusedScalarStepper(sector, shape, BOX / shape[0], HALO,
                                     dtype=dtype, carry_dtype=carry_dtype,
                                     chunk_stages=chunk, device="cuda")

    def chunk_stepper(shape, dtype, carry_dtype=None):
        return scalar_stepper(shape, dtype, carry_dtype, CHUNK)

    def bf16_stepper(shape, dtype):
        return chunk_stepper(shape, dtype, torch.bfloat16)

    def gw_stepper(shape, dtype, carry_dtype=None):
        return pt.FusedPreheatStepper(sector, gw_sector, shape,
                                      BOX / shape[0], HALO, dtype=dtype,
                                      carry_dtype=carry_dtype, device="cuda")

    def bf16_scalar(shape, dtype):
        return scalar_stepper(shape, dtype, torch.bfloat16)

    def bf16_gw(shape, dtype):
        return gw_stepper(shape, dtype, torch.bfloat16)

    timing = {}
    launches = {}

    # -- 2b. the x-march variants of K3, K6, K8, K9, K10 (opt-in) ------------
    if "march_variants" in phases:
        march_variants("march_variants", sector, gw_sector, dx)

    if "scalar" in phases:
        kernels_vs_plain("kernel_vs_plain", scalar_stepper, scalar_kernels,
                         cases, errs)

        # -- 4. identities on the card ----------------------------------------
        # one pair launch == two single-stage launches; K5's lattice outputs ==
        # K2's, bitwise; K6 pair + finalize == K3 pair with hubble2 = hubfix
        identities("identity", scalar_stepper)

        # -- 4b. the printer's non-polynomial paths compiled into K2, K3, K5 --
        nonpoly_kernels_vs_plain("nonpoly_kernel_vs_plain", errs)

        # -- 5. reference: fused kernels vs the generic path, small input -----
        st = scalar_stepper(SMALL, torch.float64)
        reference("reference", st, sector, 1e-12)

        # -- 6. coupled reference: coupled_multi_step vs the per-stage loop ---
        coupled_reference("coupled_reference", st, sector)
        del st

        # -- 7. the chunk kernel (K10) vs plain at the main path's shape and
        #       the others; the bf16-carry K2, K3 and K10 in f32 at 512^3 and
        #       48x40x36 ------------------------------------------------------
        kernels_vs_plain("chunk_kernel_vs_plain", chunk_stepper,
                         ["fused_chunk"], cases, errs)
        kernels_vs_plain("chunk_kernel_vs_plain", bf16_stepper, chunk_kernels,
                         [(GRID, torch.float32),
                          (ALT_SHAPES[1], torch.float32)], errs)

        # -- 8. chunk identity: one K10 == two K3, state and carries ----------
        chunk_identity("chunk_identity", chunk_stepper)

        # -- 9. chunk reference: chunk multi_step(3) vs the generic stepper ---
        st = chunk_stepper(SMALL, torch.float64)
        reference("chunk_reference", st, sector, 1e-12)
        del st

        # -- 10. kernel and plain times at the main path's shape --------------
        time_kernels("kernel_time", main_st, scalar_kernels, 10, timing)
        time_kernels("chunk_kernel_time", chunk_st, ["fused_chunk"], 30,
                     timing)
        bf16_st = bf16_stepper(GRID, torch.float32)
        time_kernels("chunk_kernel_time", bf16_st, chunk_kernels, 40, timing)

        # -- 11. main path: bench model, 512^3 f32, multi_step on the pair
        #        tier, then on the chunk tier from the same state (the final
        #        states must agree) and with bf16 carries --------------------
        def bench_state():
            g = torch.Generator(device="cuda").manual_seed(7)
            return {"f": 1e-3 * torch.randn((2,) + GRID, generator=g,
                                            device="cuda",
                                            dtype=torch.float32),
                    "dfdt": 1e-4 * torch.randn((2,) + GRID, generator=g,
                                               device="cuda",
                                               dtype=torch.float32)}

        pair_final = {k: v.clone() for k, v in main_path(
            "main_path", main_st, bench_state(), timing, launches).items()}
        # the sharded paths' reference waits on the host (and their initial
        # state is this one's)
        preheat_final = on_host(pair_final)
        preheat_state = bench_state
        torch.cuda.empty_cache()
        chunk_final = {k: v.clone() for k, v in main_path(
            "chunk_main_path", chunk_st, bench_state(), timing,
            launches).items()}
        del chunk_st
        torch.cuda.empty_cache()
        errs_vs_pair = {k: rel_err(chunk_final[k], pair_final[k])[0]
                        for k in pair_final}
        emit({"phase": "chunk_main_path_vs_pair", "rel_err": errs_vs_pair,
              "bitwise": {k: torch.equal(chunk_final[k], pair_final[k])
                          for k in pair_final},
              "tol": IDENTITY_TOL[torch.float32]})
        if not max(errs_vs_pair.values()) <= IDENTITY_TOL[torch.float32]:
            raise SystemExit(f"the chunk path's final state differs from the "
                             f"pair path's: {errs_vs_pair}")
        del pair_final
        bf16_final = main_path("chunk_bf16_main_path", bf16_st, bench_state(),
                               timing, launches)
        errs_vs_f32 = {k: rel_err(bf16_final[k], chunk_final[k])[0]
                       for k in chunk_final}
        differs = any(not torch.equal(bf16_final[k], chunk_final[k])
                      for k in chunk_final)
        emit({"phase": "chunk_bf16_main_path_vs_f32_carries",
              "rel_err": errs_vs_f32, "differs": differs,
              "tol": BF16_PATH_TOL})
        if not (max(errs_vs_f32.values()) <= BF16_PATH_TOL and differs):
            raise SystemExit(f"the bf16-carry path is not within "
                             f"{BF16_PATH_TOL} of the f32-carry one, or "
                             f"equals it: {errs_vs_f32}")
        del bf16_st, bf16_final, chunk_final
        torch.cuda.empty_cache()
        # the same with bf16 carries on the pair tier (the sharded bf16 paths'
        # reference waits on the host)
        st = bf16_scalar(GRID, torch.float32)
        preheat_bf16_ref = on_host(main_path(
            "preheat_bf16_main_path", st, bench_state(), timing, launches))
        del st
        torch.cuda.empty_cache()

        # -- 11b. the energy kernels with bf16 carries (K5, K6 and K5 on
        #         finalized carries) vs plain, their identities and times -----
        kernels_vs_plain("bf16_kernel_vs_plain", bf16_scalar,
                         BF16_SUM_KERNELS,
                         [(GRID, torch.float32),
                          (ALT_SHAPES[1], torch.float32),
                          (ALT_SHAPES[1], torch.float64)], errs)
        bf16_identities("bf16_identity", scalar_stepper)
        coupled_bf16_st = bf16_scalar(GRID, torch.float32)
        time_kernels("bf16_kernel_time", coupled_bf16_st, BF16_SUM_KERNELS, 50,
                     timing)

        # -- 12. coupled main path: the example model, 512^3 f32, and
        # -- 13. where its chunk's device time goes (torch.profiler) ----------
        coupled_f32_final = coupled_main_path(
            "coupled_main_path", main_st,
            background_state(GRID, torch.float32, 11), SUM_KERNELS, launches,
            trace="coupled_trace")
        # the sharded coupled paths' reference waits on the host
        coupled_ref = on_host(coupled_f32_final)
        # the scalar paths' buffers (12 GiB) make room for the GW system's 48
        del main_st
        torch.cuda.empty_cache()

        # -- 13b. the coupled main path with bf16 carries (K6, the finalize, K5
        #         on finalized carries; one pair=False step: K5) --------------
        final = coupled_main_path(
            "coupled_bf16_main_path", coupled_bf16_st,
            background_state(GRID, torch.float32, 11), BF16_COUPLED, launches,
            single=True, predicted_gib=PREDICTED_PATH_GIB[
                "coupled_bf16_main_path"])
        bf16_gap("coupled_bf16_main_path", final, on_host(coupled_f32_final))
        # the sharded bf16 coupled paths' reference waits on the host
        coupled_bf16_ref = on_host(final)
        del coupled_bf16_st, coupled_f32_final, final
        torch.cuda.empty_cache()

    # (the scalar group released them; without it they hold no buffers)
    main_st = chunk_st = None
    torch.cuda.empty_cache()

    # -- 14. the GW kernels vs plain (the main path's shape and others) ----
    if "gw" in phases:
        kernels_vs_plain("preheat_kernel_vs_plain", gw_stepper, GW_KERNELS,
                         cases, errs, gw=True)

        # -- 15. GW identities: K8 == two K7, K5' == K7 bitwise, K9 + finalize
        #        == K8 with hubble2 = hubfix ----------------------------------
        identities("preheat_identity", gw_stepper, gw=True)
        # the stage marches K5', K7 and K5 == each other, K2 and, two K7,
        # K8, bit for bit
        stage_march_identity("preheat_stage_march_identity", gw_stepper,
                             scalar_stepper)

        # -- 16. GW reference: multi_step vs the generic GW stepper, and
        #        coupled_multi_step vs the per-stage driver loop, 32^3 f64 ----
        st = gw_stepper(SMALL, torch.float64)
        reference("preheat_reference", st, sector, GW_REFERENCE_TOL, gw=True)
        coupled_reference("preheat_coupled_reference", st, sector, gw=True)
        del st

        # -- 17. GW kernel and plain times at 512^3 f32 -----------------------
        time_kernels("preheat_kernel_time", gw_st, GW_KERNELS, 20, timing)

        # -- 18. GW main path: multi_step at 512^3 f32 from the bench state for
        #        f and hij = dhijdt = 0; the source must reach hij ------------
        def gw_main_state():
            g = torch.Generator(device="cuda").manual_seed(7)
            return {"f": 1e-3 * torch.randn((2,) + GRID, generator=g,
                                            device="cuda",
                                            dtype=torch.float32),
                    "dfdt": 1e-4 * torch.randn((2,) + GRID, generator=g,
                                               device="cuda",
                                               dtype=torch.float32),
                    "hij": torch.zeros((6,) + GRID, device="cuda",
                                       dtype=torch.float32),
                    "dhijdt": torch.zeros((6,) + GRID, device="cuda",
                                          dtype=torch.float32)}

        # the final state waits on the host for the sharded GW paths
        gw_multi_ref = on_host(main_path("preheat_main_path", gw_st,
                                         gw_main_state(), timing, launches,
                                         extra_check=sourced))
        torch.cuda.empty_cache()

        # -- 19. GW coupled main path: coupled_multi_step at 512^3 f32 from the
        #        coupled path's background and hij = dhijdt = 0 ---------------
        # the f32-carry final state waits on the host for the bf16 path
        cgw_f32_final = on_host(coupled_main_path(
            "preheat_coupled_main_path", gw_st,
            background_state(GRID, torch.float32, 11, gw=True), GW_SUM_KERNELS,
            launches, trace="preheat_coupled_trace", extra_check=sourced))
        del gw_st
        torch.cuda.empty_cache()

        # -- 19b. the GW kernels with bf16 carries (K7, K8, K9, K5', and K5' on
        #         finalized carries) vs plain, their identities and times -----
        kernels_vs_plain("preheat_bf16_kernel_vs_plain", bf16_gw,
                         BF16_GW_KERNELS, [(GRID, torch.float32),
                                           (ALT_SHAPES[1], torch.float64)],
                         errs, gw=True)
        bf16_identities("preheat_bf16_identity", gw_stepper, gw=True)
        gw_bf16_st = bf16_gw(GRID, torch.float32)
        time_kernels("preheat_bf16_kernel_time", gw_bf16_st, BF16_GW_KERNELS,
                     60, timing)

        del gw_bf16_st
        torch.cuda.empty_cache()

        # -- 19c. the GW main path with bf16 carries: bench.py's gw-step bf16
        #         configuration (build_gw_step: its model, numpy seed 9 state,
        #         a = 1, hubble = 0.1) at 512^3 f32 through multi_step (K8,
        #         K7), after the same path with f32 carries; its two kernels
        #         held against their plain versions on this model too -------
        def gw_bench_stepper(shape, dtype, carry_dtype=None):
            return pt.FusedPreheatStepper(gw_bench_sector, gw_bench_gw, shape,
                                          BOX / shape[0], HALO, dtype=dtype,
                                          carry_dtype=carry_dtype,
                                          device="cuda")

        # the model's own kernel times (each model prints its own dV/df, so its
        # kernels compile apart): the two paths' kernel shares read them
        bench_timing = {}
        bench_state = gw_bench_state()
        st = gw_bench_stepper(GRID, torch.float32)
        time_kernels("gw_bench_kernel_time", st, ["preheat_stage",
                                                  "preheat_pair"], 80,
                     bench_timing)
        gwb_f32_final = on_host(main_path(
            "gw_bench_f32_main_path", st, on_card(bench_state), bench_timing,
            launches, extra_check=sourced, args=GW_BENCH_ARGS))
        del st
        torch.cuda.empty_cache()
        kernels_vs_plain("gw_bf16_kernel_vs_plain",
                         lambda sh, dt: gw_bench_stepper(sh, dt,
                                                         torch.bfloat16),
                         ["preheat_stage", "preheat_pair"],
                         [(GRID, torch.float32)], errs, gw=True, tag=":bench")
        st = gw_bench_stepper(GRID, torch.float32, torch.bfloat16)
        time_kernels("gw_bench_kernel_time", st, ["preheat_stage",
                                                  "preheat_pair"], 82,
                     bench_timing)
        final = main_path(
            "gw_bf16_main_path", st, on_card(bench_state), bench_timing,
            launches, extra_check=sourced, args=GW_BENCH_ARGS,
            predicted_gib=PREDICTED_PATH_GIB["gw_bf16_main_path"])
        bf16_gap("gw_bf16_main_path", final, gwb_f32_final)
        # the sharded gw-bf16 paths' reference and initial state wait on the
        # host
        gw_bf16_ref = on_host(final)
        gw_bench_host = bench_state
        del st, bench_state, gwb_f32_final, final
        torch.cuda.empty_cache()
        gw_bf16_st = bf16_gw(GRID, torch.float32)

        # -- 19d. the GW coupled main path with bf16 carries (K9, the finalize,
        #         K5' on finalized carries; one pair=False step: K5') ---------
        # (from the homogeneous background, the fluctuation part of a carry --
        # 1e-4 of it -- lies below bf16's resolution, so the S_ij that hij
        # integrates is mostly carry rounding: hij's gap is recorded, not held)
        final = coupled_main_path(
            "coupled_gw_bf16_main_path", gw_bf16_st,
            background_state(GRID, torch.float32, 11, gw=True),
            BF16_GW_COUPLED, launches, extra_check=sourced, single=True,
            predicted_gib=PREDICTED_PATH_GIB["coupled_gw_bf16_main_path"])
        bf16_gap("coupled_gw_bf16_main_path", final, cgw_f32_final,
                 held=("f", "dfdt"))
        # the sharded bf16 GW coupled paths' reference waits on the host
        cgw_bf16_ref = on_host(final)
        del final
        # (the f32-carry final state stays on the host for the sharded GW
        # paths)
        cgw_ref = cgw_f32_final
        del gw_bf16_st, cgw_f32_final
        torch.cuda.empty_cache()

    gw_st = None
    torch.cuda.empty_cache()

    # -- 20. the operator kernels (K12) vs plain: the wave path's shape, two
    #        others in f32 and f64, and h = 1 and 4 at the small shape -------
    if "fd" in phases:
        fd_kernels_vs_plain(
            "fd_kernel_vs_plain",
            [(shape, dtype, HALO) for shape, dtype in cases]
            + [(ALT_SHAPES[1], dtype, h) for h in FD_HALOS if h != HALO
               for dtype in (torch.float32, torch.float64)], errs)

    # -- 21. the sweep kernels (K11) vs plain: the Newton problem and the
    #        Jacobi pair at the multigrid path's finest level, 256^3 f64,
    #        48x40x36 and its coarsest level, 8^3 ---------------------------
    if "mg" in phases:
        mg_kernels_vs_plain(
            "mg_kernel_vs_plain",
            [(GRID, torch.float32), (ALT_SHAPES[0], torch.float64)]
            + [(shape, dtype) for shape in (ALT_SHAPES[1], (8, 8, 8))
               for dtype in (torch.float32, torch.float64)], errs)

    # -- 22. their times at 512^3 f32 ----------------------------------------
    if "fd" in phases:
        time_fd_kernels("fd_kernel_time", timing, errs)
    if "mg" in phases:
        time_mg_kernels("mg_kernel_time", timing)

    # -- 23. wave reference and main path ------------------------------------
    if "fd" in phases:
        wave_reference("wave_reference")
        wave_main_path("wave_main_path", launches)

    # -- 24. multigrid reference, main path and trace ------------------------
    if "mg" in phases:
        mg_reference("mg_reference")
        mg_f, mg_rho, mg_residuals, mg_ms = mg_main_path(
            "mg_main_path", timing, launches, trace="mg_trace")

    # -- 24b. the multigrid solver on sharded levels (several shards on the
    #         one card): the padded, interior and shell launches of K11 vs
    #         their plain versions and the unpadded launch; the sharded
    #         bench cycle on four meshes, its final f bit for bit the
    #         single-device path's; the launches' times; the identity
    #         meshes at 256^3 f64 (replicated coarse levels, the linear
    #         scheme); two traced sharded cycles ------------------------------
    if "sharded_mg" in phases:
        sharded_mg_kernels_vs_plain("sharded_mg_kernel_vs_plain", errs)
        mg_rows = sharded_mg_main_path("sharded_mg_main_path", mg_f, mg_rho,
                                       mg_residuals, mg_ms, launches)
        mg_per_cycle = {}
        for row in mg_rows.values():
            for k, v in row["expected_launches"].items():
                mg_per_cycle.setdefault(k, v // (1 + MG_CYCLES))
        del mg_f
        torch.cuda.empty_cache()
        time_sharded_mg_kernels("sharded_mg_kernel_time", timing, mg_per_cycle)
        sharded_mg_identity("sharded_mg_identity", launches)
        sharded_mg_trace("sharded_mg_trace", mg_rho)
        del mg_rho
        torch.cuda.empty_cache()

    # -- 25. the sharded tier (several shards on the one card): the padded,
    #        interior and shell launches vs their plain versions and vs the
    #        unsharded kernels; the sharded hot loop on five meshes, bit for
    #        bit the preheat path, and the operators on its final state;
    #        a traced sharded step; the sharded Laplacian's time --------------
    if "sharded" in phases:
        sharded_kernels_vs_plain("xpad_kernel_vs_plain", errs,
                                 sharded_kernel_names())
        time_sharded_kernels("sharded_kernel_time", timing,
                             sharded_kernel_names())
        sharded_paths(preheat_state, preheat_final, launches)
        del preheat_final
        sharded_trace("sharded_trace", preheat_state)
        sharded_fd_kernel_time("sharded_fd_kernel_time")

    # -- 26. the sharded energy-coupled driver and GW stepper (several shards
    #        on the one card): the coupled-preheat run on four meshes, the
    #        preheat-gw multi_step and the coupled-preheat-gw run on four
    #        each, every final state (and a, adot) bit for bit the
    #        single-device path's; a traced sharded coupled chunk -------------
    def sharded_scalar(decomp, overlap):
        return pt.FusedScalarStepper(sector, GRID, dx, HALO,
                                     dtype=torch.float32, decomp=decomp,
                                     overlap=overlap)

    def sharded_gw(decomp, overlap):
        return pt.FusedPreheatStepper(sector, gw_sector, GRID, dx, HALO,
                                      dtype=torch.float32, decomp=decomp,
                                      overlap=overlap)

    def coupled_state():
        return background_state(GRID, torch.float32, 11)

    if "sharded_coupled" in phases:
        sharded_stepping_paths(
            "sharded_coupled_main_path", SHARDED_COUPLED_CONFIGS,
            SHARDED_COUPLED_TIMED, sharded_scalar, coupled_state, coupled_ref,
            launches, True, "coupled_main_path")
        del coupled_ref
        sharded_coupled_trace("sharded_coupled_trace", coupled_state)
    if "sharded_gw" in phases:
        sharded_stepping_paths(
            "sharded_gw_main_path", SHARDED_GW_CONFIGS, SHARDED_GW_TIMED,
            sharded_gw, gw_main_state, gw_multi_ref, launches, False,
            "preheat_main_path")
        del gw_multi_ref
        sharded_stepping_paths(
            "sharded_gw_main_path", SHARDED_GW_COUPLED_CONFIGS,
            SHARDED_GW_TIMED,
            sharded_gw, lambda: background_state(GRID, torch.float32, 11,
                                                 gw=True),
            cgw_ref, launches, True, "preheat_coupled_main_path")
        del cgw_ref
    torch.cuda.empty_cache()

    # -- 27. the sharded tier with bf16 carries (several shards on the one
    #        card): every padded, interior and shell bf16 entry point vs its
    #        plain version and the unpadded bf16 kernel, and its time; the
    #        bench hot loop, the coupled driver, the GW bench's multi_step
    #        and the coupled GW driver with bf16 carries on their meshes,
    #        each final state (and a, adot) bit for bit the single-device
    #        bf16 path's, the first of each timed against it and against
    #        the sharded f32-carry cell; the coupled meshes also run one
    #        pair=False step ------------------------------------------------
    if "sharded_bf16" in phases:
        sharded_kernels_vs_plain("sharded_bf16_kernel_vs_plain", errs,
                                 sharded_bf16_kernel_names())
        time_sharded_kernels("sharded_bf16_kernel_time", timing,
                             sharded_bf16_kernel_names())
        bf16 = torch.bfloat16

        def sharded_bf16_scalar(decomp, overlap):
            return pt.FusedScalarStepper(sector, GRID, dx, HALO,
                                         dtype=torch.float32, carry_dtype=bf16,
                                         decomp=decomp, overlap=overlap)

        def sharded_bf16_gw(decomp, overlap, bench=False):
            s, g = (gw_bench_sector, gw_bench_gw) if bench else (sector,
                                                                 gw_sector)
            return pt.FusedPreheatStepper(s, g, GRID, dx, HALO,
                                          dtype=torch.float32,
                                          carry_dtype=bf16, decomp=decomp,
                                          overlap=overlap)

        def f32_cells(key):
            return {(m, o): key.format(m, o) for m, o in
                    [((2, 1, 1), True), ((2, 1, 1), False),
                     ((2, 2, 1), False)]}

        sharded_stepping_paths(
            "sharded_bf16_main_path", SHARDED_BF16_CONFIGS, 2,
            sharded_bf16_scalar, preheat_state, preheat_bf16_ref, launches,
            False, "preheat_bf16_main_path",
            compare=f32_cells("sharded_main_path{}{}"))
        del preheat_bf16_ref
        sharded_stepping_paths(
            "sharded_bf16_main_path", SHARDED_BF16_COUPLED_CONFIGS, 2,
            sharded_bf16_scalar, coupled_state, coupled_bf16_ref, launches,
            True, "coupled_bf16_main_path", compare=f32_cells(
                "sharded_coupled_main_path:coupled_main_path{}{}"),
            single=True)
        del coupled_bf16_ref
        PATH_ROWS["coupled_bf16_main_path"].pop("single_final")
        sharded_stepping_paths(
            "sharded_bf16_main_path", SHARDED_BF16_CONFIGS, 1,
            lambda d, o: sharded_bf16_gw(d, o, bench=True),
            lambda: on_card(gw_bench_host), gw_bf16_ref, launches, False,
            "gw_bf16_main_path", args=GW_BENCH_ARGS, compare=f32_cells(
                "sharded_gw_main_path:preheat_main_path{}{}"))
        del gw_bf16_ref, gw_bench_host
        sharded_stepping_paths(
            "sharded_bf16_main_path", SHARDED_BF16_GW_COUPLED_CONFIGS, 1,
            sharded_bf16_gw, lambda: background_state(GRID, torch.float32, 11,
                                                      gw=True),
            cgw_bf16_ref, launches, True, "coupled_gw_bf16_main_path",
            compare=f32_cells(
                "sharded_gw_main_path:preheat_coupled_main_path{}{}"),
            single=True)
        del cgw_bf16_ref
        PATH_ROWS["coupled_gw_bf16_main_path"].pop("single_final")

    # -- 28. the binning kernels (K13, K14, the finish) vs plain, and the
    #        science example's start and measurement step at 512^3 f32 ------
    if "spectra" in phases:
        spectra_s = time.perf_counter()
        if "hist_variants" in phases:
            hist_study_builds("hist_variants_build")
        histogram_kernels_vs_plain("histogram_kernel_vs_plain", errs)
        spectra_main_path("spectra_main_path", timing, launches)
        emit({"phase": "spectra_seconds",
              "seconds": time.perf_counter() - spectra_s})

    # -- 29. the health kernel (K15, its finish) vs plain, and run safety on
    #        the coupled-preheat path at 512^3 f32 ----------------------------
    if "health" in phases:
        health_s = time.perf_counter()
        health_kernel_vs_plain("health_kernel_vs_plain", errs)
        health_path("health_path", sector, timing, launches)
        emit({"phase": "health_seconds",
              "seconds": time.perf_counter() - health_s})

    kernels = []
    sharded = sharded_kernel_names() + sharded_bf16_kernel_names()
    sharded_mg = sharded_mg_kernel_names()
    names = [n for n in tfused.LAUNCHES if n not in sharded]
    sites = {**tfused.KERNELS, **new_kernels, **tfused.SHARDED_KERNELS,
             **tderivs.SHARDED_KERNELS, **trelax.SHARDED_KERNELS}
    main_tag = {name: case_tag(GRID, torch.float32) + (
        ":newton" if name in MG_KERNELS else "")
        for name in names + list(new_kernels) + [FD_LAP_ONE]}
    main_tag.update({name: sharded_main_tag(name)
                     for name in sharded + sharded_mg})
    main_tag.update({name: main_tag[name] + ":newton"
                     for name in sharded_mg})
    full = set(PHASES) <= phases
    for name in names + list(new_kernels) + [FD_LAP_ONE] + sharded \
            + sharded_mg:
        if not full and (name not in timing or name not in errs):
            continue  # a phase this run did not select
        src, replaces = sites.get(name) or sites[name.split(":")[0]]
        t = timing[name]
        main_case = errs[name][main_tag[name]]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"pystella_tpu_torch/ops/csrc/{src}",
            "replaces": replaces.split(" ")[0],
            "jax_site": replaces,
            # FD_LAP_ONE: the launches of fd_lap, at its shape
            "launches": launches.get("fd_lap" if name == FD_LAP_ONE
                                     else name, 0),
            "max_abs_err": main_case["max_abs_err"],
            "max_rel_err": main_case["max_rel_err"],
            "parity": errs[name],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t.get("library_ms"),
            # a march's per-site build, timed beside it; a binning
            # kernel's grouping yardstick build
            **({"per_site_ms": t["per_site_ms"]} if "per_site_ms" in t
               else {}),
            **({"match_ms": t["match_ms"]} if "match_ms" in t else {})})
    # a subset run holds to it the kernels its selected main paths launch
    never = [k["name"] for k in kernels if k["launches"] < 1
             and (full or k["name"] in launches)]
    if never:
        raise SystemExit(f"no main path launched {never}")
    # where a faster kernel would save the most on this run's main paths:
    # launches x (ms - bound ms), largest first; fd_lap's launches (the
    # wave path's, one component each) on its FD_LAP_ONE row
    emit({"phase": "rule2_ranking", "excess_ms": sorted(
        ([k["name"], k["launches"] * (k["ms"] - k["bound_ms"])]
         for k in kernels if k["name"] != "fd_lap"), key=lambda r: -r[1])})
    emit({"phase": "total", "seconds": time.perf_counter() - start_s,
          "build_seconds": build_s})
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
