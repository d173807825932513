#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``pystella_tpu_torch/ops/csrc`` (into
the ignored ``pystella_tpu_torch/ops/_build``), holds each kernel against
its plain PyTorch version, and drives the port's two main paths through the
entry points a user calls, at 512^3 in float32:

- the 2-field scalar-preheating hot loop, ``FusedScalarStepper.multi_step``
  (kernels ``fused_pair`` and ``fused_stage``);
- the energy-coupled driver, ``FusedScalarStepper.coupled_multi_step`` with
  ``Expansion`` and ``Reduction`` (kernels ``coupled_pair``,
  ``coupled_pair_deferred`` and ``fused_stage_energy``).

Every phase prints one JSON line; the run fails (non-zero exit, no result
line) if any phase fails. Then come the ``{"kernels": [...]}`` line, the
card's name and power limit as nvidia-smi prints them, and, last, the
result line ``{"ok": true, "device": {...}}``.

Without a CUDA device, or without the ``pystella_tpu_torch`` package beside
it, it exits non-zero before printing any result.
"""

import json
import math
import os
import subprocess
import sys
import time

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
#: one pair launch vs two single-stage launches: the same operations in
#: the same order (tests/test_fused.py:64 holds the JAX pair to 1e-14)
IDENTITY_TOL = {torch.float32: 1e-6, torch.float64: 1e-14}
#: the deferred-drag pair + finalize vs the K3 pair with hubble2 = hubfix:
#: one dt distribution re-associated (rounding level)
DEFERRED_TOL = {torch.float32: 1e-5, torch.float64: 1e-12}
#: the Friedmann constraint of the coupled main path's final state
CONSTRAINT_TOL = 1e-4
#: H100 SXM data sheet: HBM3 bandwidth and the non-tensor FP32 peak
HBM_BYTES_PER_S = 3.35e12
PEAK_F32_OPS = 67e12

SUM_KERNELS = ("fused_stage_energy", "coupled_pair", "coupled_pair_deferred")


def emit(obj):
    print(json.dumps(obj), flush=True)


def potential(f):
    phi, chi = f[0], f[1]
    return (MPHI**2 / 2 * phi**2 + GSQ / 2 * phi**2 * chi**2) / MPHI**2


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


def kernel_inputs(shape, dtype, seed, F=2):
    """Four lattice inputs at bench-like amplitudes from a seeded generator
    (f, dfdt, kf, kdfdt; for the deferred pair f, dfp, kdfp, kf)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    amps = (1e-3, 1e-4, 1e-5, 1e-3)
    return [a * torch.randn((F,) + shape, generator=g, device="cuda",
                            dtype=dtype) for a in amps]


def kernel_params(name, dx):
    import pystella_tpu_torch as pt
    A, B = pt.LowStorageRK54._A, pt.LowStorageRK54._B
    dt = 0.1 * dx
    if name in ("fused_stage", "fused_stage_energy"):
        return (dt, 1.0, 0.5, A[1], B[1])
    if name == "fused_pair":
        return (dt, 1.0, 0.5, A[1], B[1], 1.0, 0.5, A[2], B[2])
    params = (dt, 1.0, 0.5, A[1], B[1], 1.0001, A[2], B[2])
    if name == "coupled_pair_deferred":
        params += (0.49, B[0])
    return params


def background_state(shape, dtype, seed):
    """The example's homogeneous background plus 1e-5 N(0, 1) fluctuations
    from a seeded generator (stands in for the WKB initial state)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    out = {}
    for name, mean in (("f", F0), ("dfdt", DF0)):
        v = 1e-5 * torch.randn((2,) + shape, generator=g, device="cuda",
                               dtype=dtype)
        for c, m in enumerate(mean):
            v[c] += m
        out[name] = v
    return out


def printed_ops(sector):
    """Arithmetic operations of the printed dV/df (all F) and of the
    printed V, per site."""
    import pystella_tpu_torch as pt
    from pystella_tpu_torch.ops import codegen
    V = sector.potential(sector.f)
    dvdf = [pt.diff(V, sector.f[i]) for i in range(sector.nscalars)]

    def count(exprs):
        src = " ".join(codegen.print_c(e, {"f": "f"},
                                       codegen.STAGE_VARIABLES)
                       for e in exprs)
        return sum(src.count(op) for op in (" * ", " + ", " / ", " - ",
                                             "pk_"))
    return count(dvdf), count([V])


def ops_per_site(name, stepper):
    """Arithmetic a kernel does per site, counted from its source: per
    component the Laplacian (1 + 9h) and the stage update (14), plus two
    shared scalar products and the printed dV/df; the pair does two
    stages and recomposes f1 (5 operations) at each of its 6h taps. An
    energy sum set adds dfdt*dfdt, -f and *lap per component, the printed
    V and one add per term into the block tree. The coupled pair's second
    stage has no drag (2 operations fewer per component); its deferred
    input completes the velocity (4 operations) at the site and at each of
    the 6h taps the f1 composition reads."""
    F, h = stepper.F, stepper.h
    dv, v = printed_ops(stepper.sector)
    stage = F * (1 + 9 * h + 14) + 2 + dv
    sums = 3 * F + v + (2 * F + 1)
    pair = 2 * stage + F * 5 * 6 * h
    coupled = pair - 2 * F + 2 * sums
    return {"fused_stage": stage, "fused_stage_energy": stage + sums,
            "fused_pair": pair, "coupled_pair": coupled,
            "coupled_pair_deferred": coupled + F * 4 * (6 * h + 1) + 2}[name]


def term_scale(st, f, df, a, hub):
    """sum |term| of each energy sum of the state (f, df), in float64."""
    import pystella_tpu_torch as pt
    f, df = f.double(), df.double()
    lap = pt.FiniteDifferencer(st.h, st.dx).lap(f)
    V = pt.evaluate(st.sector.potential(st.sector.f),
                    {st.sector.f.name: f, "a": a, "hubble": hub})
    V = torch.as_tensor(V, dtype=torch.float64, device=f.device)
    return torch.cat([(df * df).sum((1, 2, 3)),
                      (f * lap).abs().sum((1, 2, 3)),
                      torch.broadcast_to(V, f.shape[1:]).abs().sum()[None]])


def sum_errors(st, name, ins, outs, plain, params):
    """max |kernel sum - plain sum| / sum |term| over a kernel's sum sets:
    the entry state's and, for a pair, the stage-1 state's (f1 = f2 - B2
    kf2 to rounding; the velocity df1 is the dfp output)."""
    f, v = ins[0], ins[1]
    if name == "coupled_pair_deferred":
        dt, hubfix, B2p = params[0], params[8], params[9]
        v = v + B2p * (ins[2] - 2 * dt * hubfix * v)
    scales = [term_scale(st, f, v, params[1], params[2])]
    if name != "fused_stage_energy":
        f1 = outs[0].double() - params[7] * outs[2].double()
        scales.append(term_scale(st, f1, outs[1], params[5], None))
    return max(((k.double() - p.double()).abs() / s).max().item()
               for k, p, s in zip(outs[4:], plain[4:], scales))


def driver_loop(sector, state, nsteps, dx, dt):
    """The reference per-stage driver loop (tests/test_fused.py:206-219)
    on the port's generic pieces: LowStorageRK54 + FiniteDifferencer.lap,
    the energy re-reduced by Reduction after every stage, Expansion
    stepped on the entering energy. Returns the final state and Expansion
    and the initial energy."""
    import pystella_tpu_torch as pt
    fd = pt.FiniteDifferencer(HALO, dx)
    rhs = pt.compile_rhs_dict(sector.rhs_dict)
    gen = pt.LowStorageRK54(
        lambda s, t, a, hubble: rhs(s, t, lap_f=fd.lap(s["f"]), a=a,
                                    hubble=hubble))
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
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
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


def main():
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
          "cuda": torch.version.cuda})

    sector = pt.ScalarSector(2, potential=potential)
    dx = BOX / GRID[0]

    # -- 2. build (every kernel, float32 and float64, one nvcc a source) -----
    t0 = time.perf_counter()
    main_st = pt.FusedScalarStepper(sector, GRID, dx, HALO,
                                    dtype=torch.float32, device="cuda")
    build_s = time.perf_counter() - t0
    emit({"phase": "build", "seconds": build_s,
          "sources": sorted({src for src, _ in tfused.KERNELS.values()}),
          "kernels": main_st.kernel_names(),
          "build_dir": str(pt.ops.stencil.BUILD_DIR)})
    if main_st.kernel_names() != list(tfused.KERNELS):
        raise SystemExit("the main model did not build every kernel")

    # -- 3. kernels vs plain, at the main path's shape and others; every
    #       sum-emitting kernel twice for bit-equal sums ----------------------
    errs = {name: {} for name in tfused.KERNELS}
    cases = [(GRID, torch.float32)] + [
        (shape, dtype) for shape in ALT_SHAPES
        for dtype in (torch.float32, torch.float64)]
    for shape, dtype in cases:
        st = pt.FusedScalarStepper(sector, shape, BOX / shape[0], HALO,
                                   dtype=dtype, device="cuda")
        for seed, name in enumerate(tfused.KERNELS):
            ins = kernel_inputs(shape, dtype, seed)
            params = kernel_params(name, BOX / shape[0])
            plain = st.plain(name, ins, params)
            outs = st.launch(name, ins, [torch.empty_like(ins[0])
                                          for _ in range(4)], params)
            torch.cuda.synchronize()
            per_output = {n: rel_err(o, p) for n, o, p in
                          zip(("f", "dfdt", "kf", "kdfdt"), outs, plain)}
            worst_rel = max(r for r, _ in per_output.values())
            worst_abs = max(a for _, a in per_output.values())
            tag = "x".join(map(str, shape)) + ":" + str(dtype)[6:]
            row = {"max_rel_err": worst_rel, "max_abs_err": worst_abs,
                   "tol": KERNEL_TOL[dtype]}
            ok = worst_rel <= KERNEL_TOL[dtype]
            if name in SUM_KERNELS:
                row["sum_err"] = sum_errors(st, name, ins, outs, plain,
                                            params)
                row["sum_tol"] = SUM_TOL[dtype]
                again = st.launch(name, ins, [torch.empty_like(ins[0])
                                               for _ in range(4)], params)
                torch.cuda.synchronize()
                row["sums_bitwise_repeatable"] = all(
                    torch.equal(a, b) for a, b in zip(outs, again))
                ok = (ok and row["sum_err"] <= SUM_TOL[dtype]
                      and row["sums_bitwise_repeatable"])
                del again
            errs[name][tag] = row
            emit({"phase": "kernel_vs_plain", "kernel": name, "shape": shape,
                  "dtype": str(dtype),
                  "rel_err": {n: r for n, (r, _) in per_output.items()},
                  **row})
            if not ok:
                raise SystemExit(f"{name} disagrees with its plain version "
                                 f"at {shape} {dtype}: {row}")
            del ins, plain, outs
        del st
        torch.cuda.empty_cache()

    # -- 4. identities on the card ------------------------------------------
    # one pair launch == two single-stage launches; K5's lattice outputs ==
    # K2's, bitwise; K6 pair + finalize == K3 pair with hubble2 = hubfix
    for dtype in (torch.float64, torch.float32):
        shape = ALT_SHAPES[0]
        st = pt.FusedScalarStepper(sector, shape, BOX / shape[0], HALO,
                                   dtype=dtype, device="cuda")
        ins = kernel_inputs(shape, dtype, 7)
        p = kernel_params("fused_pair", BOX / shape[0])
        new = lambda: [torch.empty_like(ins[0]) for _ in range(4)]  # noqa
        pair = st.launch("fused_pair", ins, new(), p)
        mid = st.launch("fused_stage", ins, new(), p[:5])
        two = st.launch("fused_stage", mid, new(), (p[0],) + p[5:])
        energy = st.launch("fused_stage_energy", ins, new(), p[:5])
        torch.cuda.synchronize()
        worst = max(rel_err(a, b)[0] for a, b in zip(pair, two))
        k5_bitwise = all(torch.equal(a, b) for a, b in zip(energy, mid))
        del mid, two, energy
        cp = kernel_params("coupled_pair", BOX / shape[0])
        hubfix = 0.49
        coupled = st.launch("coupled_pair", ins, new(), cp)
        state, k = st._finalize_deferred(st._carry_of(coupled[:4]), cp[0],
                                         hubfix, cp[7])
        ref = st.launch("fused_pair", ins, new(),
                        cp[:5] + (cp[5], hubfix, cp[6], cp[7]))
        torch.cuda.synchronize()
        deferred = max(rel_err(a, b)[0] for a, b in zip(
            (state["f"], state["dfdt"], k["f"], k["dfdt"]), ref))
        emit({"phase": "identity", "dtype": str(dtype), "shape": shape,
              "max_rel_err": worst, "tol": IDENTITY_TOL[dtype],
              "energy_stage_bitwise_stage": k5_bitwise,
              "deferred_pair_vs_pair_rel_err": deferred,
              "deferred_tol": DEFERRED_TOL[dtype]})
        if not worst <= IDENTITY_TOL[dtype]:
            raise SystemExit(f"pair != two singles ({dtype}): {worst}")
        if not k5_bitwise:
            raise SystemExit(f"fused_stage_energy != fused_stage ({dtype})")
        if not deferred <= DEFERRED_TOL[dtype]:
            raise SystemExit(f"coupled pair + finalize != fused pair "
                             f"({dtype}): {deferred}")
        del st, ins, pair, coupled, state, k, ref
    torch.cuda.empty_cache()

    # -- 5. reference: fused kernels vs the generic path, small input --------
    small = SMALL
    small_dx = BOX / small[0]
    st = pt.FusedScalarStepper(sector, small, small_dx, HALO,
                               dtype=torch.float64, device="cuda")
    fd = pt.FiniteDifferencer(HALO, small_dx)
    rhs = pt.compile_rhs_dict(sector.rhs_dict)
    gen = pt.LowStorageRK54(
        lambda s, t, a, hubble: rhs(s, t, lap_f=fd.lap(s["f"]), a=a,
                                    hubble=hubble))
    g = torch.Generator(device="cuda").manual_seed(3)
    state = {"f": 1e-3 * torch.randn((2,) + small, generator=g,
                                     device="cuda", dtype=torch.float64),
             "dfdt": 1e-4 * torch.randn((2,) + small, generator=g,
                                        device="cuda", dtype=torch.float64)}
    args = {"a": 1.0, "hubble": 0.5}
    ref = dict(state)
    for _ in range(3):
        ref = gen.step(ref, 0.0, 0.1 * small_dx, args)
    got = st.multi_step({k: v.clone() for k, v in state.items()}, 3, 0.0,
                        0.1 * small_dx, args)
    worst = max(rel_err(got[k], ref[k])[0] for k in ("f", "dfdt"))
    emit({"phase": "reference", "shape": small, "dtype": "torch.float64",
          "nsteps": 3, "max_rel_err_vs_generic": worst, "tol": 1e-12})
    if not worst <= 1e-12:
        raise SystemExit(f"fused multi_step disagrees with the generic "
                         f"stepper: {worst}")
    del state, ref, got

    # -- 6. coupled reference: coupled_multi_step vs the per-stage loop -----
    dt_small = 0.1 * small_dx
    state = background_state(small, torch.float64, 5)
    for nsteps in (1, 2):
        ref, exp_ref, energy0 = driver_loop(
            sector, {k: v.clone() for k, v in state.items()}, nsteps,
            small_dx, dt_small)
        for pair in (True, False):
            exp = pt.Expansion(energy0, pt.LowStorageRK54)
            got = st.coupled_multi_step(
                {k: v.clone() for k, v in state.items()}, nsteps, exp, 0.0,
                dt_small, pair=pair)
            row = {k: rel_err(got[k], ref[k])[0] for k in ("f", "dfdt")}
            row["a"] = abs(exp.a - exp_ref.a) / exp_ref.a
            row["adot"] = abs(exp.adot - exp_ref.adot) / abs(exp_ref.adot)
            emit({"phase": "coupled_reference", "shape": small,
                  "dtype": "torch.float64", "nsteps": nsteps, "pair": pair,
                  "rel_err_vs_driver_loop": row, "tol": 1e-12})
            if not max(row.values()) <= 1e-12:
                raise SystemExit(f"coupled_multi_step(pair={pair}, "
                                 f"nsteps={nsteps}) disagrees with the "
                                 f"driver loop: {row}")
    del st, state, ref, got

    # -- 7. kernel and plain times at the main path's shape ------------------
    timing = {}
    sites = math.prod(GRID)
    for seed, name in enumerate(tfused.KERNELS):
        ins = kernel_inputs(GRID, torch.float32, 10 + seed)
        params = kernel_params(name, dx)
        sets = [[torch.empty_like(ins[0]) for _ in range(4)]
                for _ in range(2)]
        n = [0]

        def launch():
            n[0] += 1
            main_st.launch(name, ins, sets[n[0] % 2], params)
        ms = cuda_ms(launch, reps=20, warmup=2)
        del sets
        plain_ms = cuda_ms(lambda: main_st.plain(name, ins, params), reps=3)
        # each input read once, each output written once: four lattice
        # arrays in, four out, and the (2F+1)-term sum vectors
        nbytes = (8 * main_st.F * sites
                  + tfused.SUM_SETS[name] * (2 * main_st.F + 1)) * 4
        ops = ops_per_site(name, main_st) * sites
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / PEAK_F32_OPS * 1e3
        timing[name] = {"ms": ms, "plain_ms": plain_ms,
                        "bound_ms": max(bytes_ms, ops_ms),
                        "bound_by": "bytes" if bytes_ms >= ops_ms
                        else "operations",
                        "bytes": nbytes, "ops": ops}
        emit({"phase": "kernel_time", "kernel": name, "shape": GRID,
              "dtype": "torch.float32", **timing[name]})
        del ins
    torch.cuda.empty_cache()

    launches = {}

    # -- 8. main path: bench model, 512^3 f32, multi_step --------------------
    g = torch.Generator(device="cuda").manual_seed(7)
    state = {"f": 1e-3 * torch.randn((2,) + GRID, generator=g,
                                     device="cuda", dtype=torch.float32),
             "dfdt": 1e-4 * torch.randn((2,) + GRID, generator=g,
                                        device="cuda", dtype=torch.float32)}
    dt = 0.1 * dx
    args = {"a": 1.0, "hubble": 0.5}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tfused.reset_launch_counts()
    state = main_st.multi_step(state, NSTEPS, 0.0, dt, args)  # warmup chunk
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    host0 = time.perf_counter()
    start.record()
    state = main_st.multi_step(state, NSTEPS, 0.0, dt, args)  # timed chunk
    end.record()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - host0
    elapsed = start.elapsed_time(end) / 1e3
    # the odd remainder of a run whose length is not a multiple of the
    # chunk: one step = 2 pair launches + 1 single-stage launch
    state = main_st.multi_step(state, 1, 0.0, dt, args)
    torch.cuda.synchronize()
    path_launches = dict(tfused.LAUNCHES)
    for name in ("fused_pair", "fused_stage"):
        launches[name] = path_launches[name]

    npairs = -(-main_st.num_stages * NSTEPS // 2)
    finite = all(bool(torch.isfinite(v).all()) for v in state.values())
    shapes_ok = all(tuple(v.shape) == (2,) + GRID for v in state.values())
    emit({"phase": "main_path", "grid": GRID, "dtype": "torch.float32",
          "nsteps_timed": NSTEPS,
          "ms_per_step": elapsed / NSTEPS * 1e3,
          "site_updates_per_s": sites * NSTEPS / elapsed,
          "effective_GB_per_s": 8 * npairs * sites * 2 * 4 / elapsed / 1e9,
          "host_s": host_s, "launches": path_launches,
          # the chunk's pair launches at the separately timed per-launch
          # cost, over the chunk's device time: the share the card spent
          # in the kernel (1 minus it is launch gaps and other work)
          "kernel_share_est": npairs * timing["fused_pair"]["ms"] / 1e3
          / elapsed,
          "peak_memory_GiB": torch.cuda.max_memory_allocated() / 2**30,
          "finite": finite, "f_rms": state["f"].double().pow(2).mean()
          .sqrt().item()})
    if not (finite and shapes_ok):
        raise SystemExit("main path produced a non-finite or misshapen "
                         "state")
    for name in ("fused_pair", "fused_stage"):
        if launches[name] < 1:
            raise SystemExit(f"main path never launched {name}")
    del state
    torch.cuda.empty_cache()

    # -- 9. coupled main path: the example model, 512^3 f32 -----------------
    fd = pt.FiniteDifferencer(HALO, dx)
    reduce_energy = pt.Reduction(sector, callback=pt.get_rho_and_p,
                                 grid_size=float(sites))

    def energy_of(st, a):
        return reduce_energy(f=st["f"], dfdt=st["dfdt"],
                             lap_f=fd.lap(st["f"]), a=np.float64(a))

    state = background_state(GRID, torch.float32, 11)
    energy0 = energy_of(state, 1.0)
    expand = pt.Expansion(energy0["total"], pt.LowStorageRK54, mpl=1.0)
    a0, adot0 = float(expand.a), float(expand.adot)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tfused.reset_launch_counts()
    state = main_st.coupled_multi_step(state, NSTEPS, expand, 0.0, dt)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    host0 = time.perf_counter()
    start.record()
    # timed chunk: 25 pairs, ends on a deferred pair (chunk-end finalize)
    state = main_st.coupled_multi_step(state, NSTEPS, expand, 0.0, dt)
    end.record()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - host0
    device_s = start.elapsed_time(end) / 1e3
    # the odd tail: 2 pairs, a mid-chunk finalize and one K5 stage
    state = main_st.coupled_multi_step(state, 1, expand, 0.0, dt)
    torch.cuda.synchronize()
    path_launches = dict(tfused.LAUNCHES)
    for name in SUM_KERNELS:
        launches[name] = path_launches[name]

    energy = energy_of(state, expand.a)
    constraint = float(expand.constraint(energy["total"]))
    finite = all(bool(torch.isfinite(v).all()) for v in state.values())
    shapes_ok = all(tuple(v.shape) == (2,) + GRID for v in state.values())
    emit({"phase": "coupled_main_path", "grid": GRID,
          "dtype": "torch.float32", "nsteps_timed": NSTEPS,
          "ms_per_step": device_s / NSTEPS * 1e3,
          "site_updates_per_s": sites * NSTEPS / device_s,
          "effective_GB_per_s": 8 * npairs * sites * 2 * 4 / device_s / 1e9,
          # wall clock of the chunk (ending in a synchronize) and the CUDA
          # events around it; the host waits for every pair's sums, so the
          # two agree and the device's idle gaps are inside both
          "host_s": host_s, "device_s": device_s,
          "launches": path_launches,
          "peak_memory_GiB": torch.cuda.max_memory_allocated() / 2**30,
          "a0": a0, "adot0": adot0, "a": float(expand.a),
          "adot": float(expand.adot), "energy_total": float(energy["total"]),
          "constraint": constraint, "constraint_tol": CONSTRAINT_TOL,
          "finite": finite})
    if not (finite and shapes_ok):
        raise SystemExit("coupled main path produced a non-finite or "
                         "misshapen state")
    if not constraint <= CONSTRAINT_TOL:
        raise SystemExit(f"coupled main path violates the Friedmann "
                         f"constraint: {constraint}")
    for name in SUM_KERNELS:
        if launches[name] < 1:
            raise SystemExit(f"coupled main path never launched {name}")

    # -- 10. where the coupled chunk's device time goes (torch.profiler) ----
    emit({"phase": "coupled_trace", **trace_chunk(
        lambda: main_st.coupled_multi_step(state, NSTEPS, expand, 0.0, dt),
        device_s)})
    del state

    kernels = []
    for name, (src, replaces) in tfused.KERNELS.items():
        t = timing[name]
        main_case = errs[name]["x".join(map(str, GRID)) + ":float32"]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"pystella_tpu_torch/ops/csrc/{src}",
            "replaces": replaces.split(" ")[0],
            "jax_site": replaces,
            "launches": launches[name],
            "max_abs_err": main_case["max_abs_err"],
            "max_rel_err": main_case["max_rel_err"],
            "parity": errs[name],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": None})
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
