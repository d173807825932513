#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``pystella_tpu_torch/ops/csrc`` (into
the ignored ``pystella_tpu_torch/ops/_build``), holds each kernel against
its plain PyTorch version, and drives the port's main path -- the 2-field
scalar-preheating hot loop, ``FusedScalarStepper.multi_step`` at 512^3 in
float32 -- through the entry points a user calls. Every phase prints one
JSON line; the run fails (non-zero exit, no result line) if any phase
fails. Then come the ``{"kernels": [...]}`` line, the card's name and power
limit as nvidia-smi prints them, and, last, the result line
``{"ok": true, "device": {...}}``.

Without a CUDA device, or without the ``pystella_tpu_torch`` package beside
it, it exits non-zero before printing any result.
"""

import json
import math
import os
import subprocess
import sys
import time

import torch

#: the bench model (bench.py:build_preheat_step): V = (m^2 phi^2/2 +
#: g^2 phi^2 chi^2/2) / m^2, box 5^3, dt = 0.1 dx, order-4 Laplacian, RK54
MPHI, GSQ = 1.20e-6, 2.5e-7
BOX, HALO, GRID = 5.0, 2, (512, 512, 512)
NSTEPS = 10

#: kernel vs plain version, max |kernel - plain| / max |plain| per output.
#: They differ where PyTorch's CUDA division by a Python scalar multiplies
#: by the reciprocal (one extra rounding in dV/df); that difference passes
#: through ~10 roundings of terms no larger than the output: a few ulp.
KERNEL_TOL = {torch.float32: 1e-5, torch.float64: 1e-13}
#: one pair launch vs two single-stage launches: the same operations in
#: the same order (tests/test_fused.py:64 holds the JAX pair to 1e-14)
IDENTITY_TOL = {torch.float32: 1e-6, torch.float64: 1e-14}
#: H100 SXM data sheet: HBM3 bandwidth and the non-tensor FP32 peak
HBM_BYTES_PER_S = 3.35e12
PEAK_F32_OPS = 67e12


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
    """f, dfdt, kf, kdfdt at bench-like amplitudes from a seeded generator."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    amps = (1e-3, 1e-4, 1e-5, 1e-3)
    return [a * torch.randn((F,) + shape, generator=g, device="cuda",
                            dtype=dtype) for a in amps]


def kernel_params(name, dx):
    import pystella_tpu_torch as pt
    A, B = pt.LowStorageRK54._A, pt.LowStorageRK54._B
    dt = 0.1 * dx
    if name == "fused_stage":
        return (dt, 1.0, 0.5, A[1], B[1])
    return (dt, 1.0, 0.5, A[1], B[1], 1.0, 0.5, A[2], B[2])


def printed_ops(stepper):
    """Arithmetic operations of the printed dV/df per site (all F)."""
    body = stepper.kernel_header().split("{", 1)[1]
    return sum(body.count(op) for op in (" * ", " + ", " / ", " - ", "pk_"))


def ops_per_site(name, stepper):
    """Arithmetic a kernel does per site, counted from its source: per
    component the Laplacian (1 + 9h) and the stage update (14), plus two
    shared scalar products and the printed dV/df; the pair does two
    stages and recomposes f1 (5 operations) at each of its 6h taps."""
    F, h = stepper.F, stepper.h
    stage = F * (1 + 9 * h + 14) + 2 + printed_ops(stepper)
    return stage if name == "fused_stage" else 2 * stage + F * 5 * 6 * h


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

    # -- 2. build (both kernels, float32 and float64, one nvcc each) ---------
    t0 = time.perf_counter()
    main_st = pt.FusedScalarStepper(sector, GRID, dx, HALO,
                                    dtype=torch.float32, device="cuda")
    build_s = time.perf_counter() - t0
    emit({"phase": "build", "seconds": build_s,
          "sources": [src for src, _ in tfused.KERNELS.values()],
          "build_dir": str(pt.ops.stencil.BUILD_DIR)})

    # -- 3. kernels vs plain, at the main path's shape and others ------------
    errs = {name: {} for name in tfused.KERNELS}
    cases = [(GRID, torch.float32), ((256,) * 3, torch.float32),
             ((256,) * 3, torch.float64), ((48, 40, 36), torch.float32),
             ((48, 40, 36), torch.float64)]
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
            errs[name][tag] = {"max_rel_err": worst_rel,
                               "max_abs_err": worst_abs,
                               "tol": KERNEL_TOL[dtype]}
            emit({"phase": "kernel_vs_plain", "kernel": name, "shape": shape,
                  "dtype": str(dtype),
                  "rel_err": {n: r for n, (r, _) in per_output.items()},
                  "max_rel_err": worst_rel, "max_abs_err": worst_abs,
                  "tol": KERNEL_TOL[dtype]})
            if not worst_rel <= KERNEL_TOL[dtype]:
                raise SystemExit(f"{name} disagrees with its plain version "
                                 f"at {shape} {dtype}: {worst_rel}")
            del ins, plain, outs
        del st
    torch.cuda.empty_cache()

    # -- 4. identity: one pair launch == two single-stage launches ----------
    for dtype in (torch.float64, torch.float32):
        shape = (256,) * 3
        st = pt.FusedScalarStepper(sector, shape, BOX / shape[0], HALO,
                                   dtype=dtype, device="cuda")
        ins = kernel_inputs(shape, dtype, 7)
        p = kernel_params("fused_pair", BOX / shape[0])
        new = lambda: [torch.empty_like(ins[0]) for _ in range(4)]  # noqa
        pair = st.launch("fused_pair", ins, new(), p)
        mid = st.launch("fused_stage", ins, new(), p[:5])
        two = st.launch("fused_stage", mid, new(), (p[0],) + p[5:])
        torch.cuda.synchronize()
        worst = max(rel_err(a, b)[0] for a, b in zip(pair, two))
        emit({"phase": "identity", "dtype": str(dtype), "shape": shape,
              "max_rel_err": worst, "tol": IDENTITY_TOL[dtype]})
        if not worst <= IDENTITY_TOL[dtype]:
            raise SystemExit(f"pair != two singles ({dtype}): {worst}")
        del st, ins, pair, mid, two
    torch.cuda.empty_cache()

    # -- 5. reference: fused kernels vs the generic path, small input --------
    small = (32, 32, 32)
    st = pt.FusedScalarStepper(sector, small, BOX / 32, HALO,
                               dtype=torch.float64, device="cuda")
    fd = pt.FiniteDifferencer(HALO, BOX / 32)
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
        ref = gen.step(ref, 0.0, 0.1 * BOX / 32, args)
    got = st.multi_step({k: v.clone() for k, v in state.items()}, 3, 0.0,
                        0.1 * BOX / 32, args)
    worst = max(rel_err(got[k], ref[k])[0] for k in ("f", "dfdt"))
    emit({"phase": "reference", "shape": small, "dtype": "torch.float64",
          "nsteps": 3, "max_rel_err_vs_generic": worst, "tol": 1e-12})
    if not worst <= 1e-12:
        raise SystemExit(f"fused multi_step disagrees with the generic "
                         f"stepper: {worst}")
    del st, state, ref, got

    # -- kernel and plain times at the main path's shape ---------------------
    timing = {}
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
        sites = math.prod(GRID)
        nbytes = 8 * main_st.F * sites * 4
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

    # -- 6. main path: bench model, 512^3 f32, multi_step --------------------
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
    launches = dict(tfused.LAUNCHES)

    sites = math.prod(GRID)
    npairs = -(-main_st.num_stages * NSTEPS // 2)
    finite = all(bool(torch.isfinite(v).all()) for v in state.values())
    shapes_ok = all(tuple(v.shape) == (2,) + GRID for v in state.values())
    emit({"phase": "main_path", "grid": GRID, "dtype": "torch.float32",
          "nsteps_timed": NSTEPS,
          "ms_per_step": elapsed / NSTEPS * 1e3,
          "site_updates_per_s": sites * NSTEPS / elapsed,
          "effective_GB_per_s": 8 * npairs * sites * 2 * 4 / elapsed / 1e9,
          "host_s": host_s, "launches": launches,
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
    for name in tfused.KERNELS:
        if launches[name] < 1:
            raise SystemExit(f"main path never launched {name}")

    kernels = []
    for name, (src, replaces) in tfused.KERNELS.items():
        t = timing[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"pystella_tpu_torch/ops/csrc/{src}",
            "replaces": replaces.split(" ")[0],
            "jax_site": replaces,
            "launches": launches[name],
            "max_abs_err": errs[name]["512x512x512:float32"]["max_abs_err"],
            "max_rel_err": errs[name]["512x512x512:float32"]["max_rel_err"],
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
