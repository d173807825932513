"""Scalar-field preheating after inflation, with optional gravitational-wave
production, on the PyTorch/CUDA port (``pystella_tpu_torch``).

The model, arguments, defaults and loop of ``examples/scalar_preheating.py``:
two coupled scalars in conformal FLRW spacetime with WKB vacuum-fluctuation
initial conditions (:class:`RayleighGenerator`), self-consistent scale-factor
evolution via the Friedmann equations, energy reductions, field statistics,
the energy-density histogram (:class:`FieldHistogrammer` over rho from an
:class:`ElementWiseMap`), scalar, rho and GW power spectra
(:class:`PowerSpectra`, :class:`Projector`) and HDF5 output
(:class:`OutputFile`), over a :class:`DomainDecomposition` whose shards one
process drives. It prints the same ``final constraint`` line.

``--device`` (not in the JAX example) picks the device: the GPU by default,
``cpu`` for the plain PyTorch versions of every kernel. ``--outfile`` needs
``h5py`` (imported when the file is opened); without ``--outfile`` the run
writes ``bench_results/output-N.h5`` as the JAX example does.

Run safety as in the JAX example: ``--checkpoint-dir`` (resume from the
newest good checkpoint; a synchronous health check before every save, the
durability barrier one interval later), ``--checkpoint-interval``,
``--health-every`` (the asynchronous numerics sentinel's poll lag: a health
vector every iteration, K15 on the card), ``--forensics-dir`` (a bundle on
a trip) and ``--event-log`` (or ``PYSTELLA_EVENT_LOG``), with the run
events ``run_start``, ``spectra_time``, ``health``, ``step_time``,
``step_timer``, ``checkpoint_*``, ``diverged``, ``forensic_bundle``,
``run_aborted`` and ``run_complete``. Left out, because their modules are
not ported yet (ROADMAP queue 1 item 7): ``--profile``, ``--profile-start``,
``--profile-steps`` (``obs/trace``), ``--perf-report`` (``obs/ledger``) and
``--compile-cache-dir`` with the ``cold_start`` event (``obs/memory``,
``obs/warmstart``).

    python examples/torch_scalar_preheating.py -grid 32 32 32 -end-t 1 \\
        --device cpu
"""

import os
import time
from argparse import ArgumentParser

import numpy as np
import torch

import pystella_tpu_torch as pt

parser = ArgumentParser()
parser.add_argument("--grid-shape", "-grid", type=int, nargs=3,
                    metavar=("Nx", "Ny", "Nz"), default=(128, 128, 128))
parser.add_argument("--proc-shape", "-proc", type=int, nargs=3,
                    metavar=("Npx", "Npy", "Npz"), default=(1, 1, 1))
parser.add_argument("--dtype", type=np.dtype, default=np.float64)
parser.add_argument("--halo-shape", type=int, default=2, metavar="h",
                    help="stencil radius; 0 selects spectral derivatives")
parser.add_argument("--box-dim", "-box", type=float, nargs=3,
                    metavar=("Lx", "Ly", "Lz"), default=(5., 5., 5.))
parser.add_argument("--kappa", type=float, default=1 / 10,
                    help="timestep to grid-spacing ratio")
parser.add_argument("--mpl", type=float, default=1.)
parser.add_argument("--mphi", type=float, default=1.20e-6)
parser.add_argument("--mchi", type=float, default=0.)
parser.add_argument("--gsq", type=float, default=2.5e-7)
parser.add_argument("--sigma", type=float, default=0.)
parser.add_argument("--lambda4", type=float, default=0.)
parser.add_argument("--end-time", "-end-t", type=float, default=20)
parser.add_argument("--end-scale-factor", "-end-a", type=float, default=20)
parser.add_argument("--gravitational-waves", "-gws", action="store_true")
parser.add_argument("--outfile", type=str, default=None)
parser.add_argument("--seed", type=int, default=49279)
parser.add_argument("--fused", action="store_true",
                    help="use the fused RK-stage kernels (requires z "
                         "unsharded and halo-shape >= 1)")
parser.add_argument("--chunk-steps", type=int, default=0, metavar="N",
                    help="with --fused: advance N steps per call "
                         "(coupled_multi_step, or multi_step with "
                         "--chunk-mode frozen); energy output coarsens to "
                         "chunk boundaries")
parser.add_argument("--chunk-mode", choices=("coupled", "frozen"),
                    default="coupled",
                    help="coupled (default): the Friedmann ODE advanced "
                         "with every stage's energy; frozen: the "
                         "background precomputed from the chunk-entry "
                         "energy (first-order coupling)")
parser.add_argument("--chunk-pair", choices=("auto", "on", "off"),
                    default="auto",
                    help="with --chunk-mode coupled: the deferred-drag "
                         "stage-pair kernels when available (auto), "
                         "required (on) or never (off)")
parser.add_argument("--spectra-cadence", type=float, default=1.05,
                    metavar="RATIO",
                    help="scale-factor growth ratio between spectra "
                         "outputs (1.0 outputs every driver step)")
parser.add_argument("--fft-scheme", type=str, default=None,
                    metavar="SCHEME",
                    help="FFT scheme of the spectra/projection transform "
                         "(default PYSTELLA_FFT_SCHEME); 'pencil' is not "
                         "ported and raises")
parser.add_argument("--checkpoint-dir", type=str, default=None,
                    help="enable checkpoint/resume under this directory")
parser.add_argument("--checkpoint-interval", type=int, default=100,
                    metavar="STEPS")
parser.add_argument("--health-every", type=int, default=50,
                    metavar="STEPS",
                    help="poll lag of the async numerics sentinel: the "
                    "driver observes a health vector every iteration "
                    "(no sync) and only ever blocks on one at least "
                    "this many steps behind")
parser.add_argument("--forensics-dir", type=str, default="forensics",
                    metavar="DIR",
                    help="where a forensic bundle is written when the "
                    "sentinel trips (last-K health vectors, event-log "
                    "tail, config/env fingerprint, last-good-checkpoint"
                    " pointer); only created on divergence")
parser.add_argument("--event-log", type=str, default=None,
                    metavar="PATH", help="structured JSONL run-event log; "
                    "PYSTELLA_EVENT_LOG also works")
parser.add_argument("--device", type=str, default=None,
                    help="torch device: the GPU by default, 'cpu' for the "
                         "plain PyTorch versions")


def main(argv=None):
    p = parser.parse_args(argv)
    if p.event_log is not None:
        # health trips, checkpoint saves and restores, per-step timings
        # and the StepTimer reports land in one record
        pt.obs.configure(p.event_log)
    p.grid_shape = tuple(p.grid_shape)
    p.proc_shape = tuple(p.proc_shape)
    p.box_dim = tuple(p.box_dim)
    p.grid_size = float(np.prod(p.grid_shape))

    lattice = pt.Lattice(p.grid_shape, p.box_dim, dtype=p.dtype)
    dt = p.kappa * min(lattice.dx)
    tdtype = torch.from_numpy(np.zeros(0, p.dtype)).dtype

    p.nscalars = 2
    f0 = [.193 * p.mpl, 0]
    df0 = [-.142231 * p.mpl, 0]
    Stepper = pt.LowStorageRK54

    ndev = int(np.prod(p.proc_shape))
    device = pt.resolve_device(p.device)
    decomp = pt.DomainDecomposition(
        p.proc_shape, devices=None if p.device is None else [device] * ndev)
    sharded = ndev > 1

    def place(array):
        """A host array as the run holds lattice arrays: sharded over the
        mesh, or a tensor on the device."""
        if sharded:
            return decomp.shard(np.ascontiguousarray(array))
        return torch.from_numpy(np.ascontiguousarray(array)).to(device)

    fft = pt.DFT(decomp, grid_shape=p.grid_shape, dtype=p.dtype)
    if p.halo_shape == 0:
        derivs = pt.SpectralCollocator(fft, lattice.dk)
    else:
        derivs = pt.FiniteDifferencer(p.halo_shape, lattice.dx,
                                      device=device,
                                      decomp=decomp if sharded else None)

    def potential(f):
        phi, chi = f[0], f[1]
        unscaled = (p.mphi**2 / 2 * phi**2
                    + p.mchi**2 / 2 * chi**2
                    + p.gsq / 2 * phi**2 * chi**2
                    + p.sigma / 2 * phi * chi**2
                    + p.lambda4 / 4 * chi**4)
        return unscaled / p.mphi**2

    scalar_sector = pt.ScalarSector(p.nscalars, potential=potential)
    sectors = [scalar_sector]
    if p.gravitational_waves:
        gw_sector = pt.TensorPerturbationSector([scalar_sector])
        sectors.append(gw_sector)

    merged = {}
    for sector in sectors:
        merged.update(sector.rhs_dict)
    sector_rhs = pt.compile_rhs_dict(merged)

    def full_rhs(state, t, a, hubble):
        aux = {"lap_f": derivs.lap(state["f"]), "a": a, "hubble": hubble}
        if p.gravitational_waves:
            aux["dfdx"] = derivs.grad(state["f"])
            aux["lap_hij"] = derivs.lap(state["hij"])
        # elementwise in the state and aux arrays: block by block
        return pt.blockwise(sector_rhs, state, t, **aux)

    if p.fused and p.halo_shape == 0:
        raise ValueError("--fused requires finite differences "
                         "(--halo-shape >= 1), not spectral derivatives")
    if p.chunk_steps and not p.fused:
        raise ValueError("--chunk-steps requires --fused (multi_step is "
                         "a fused-stepper driver)")
    if p.fused:
        fused = dict(tableau=Stepper, dtype=tdtype, dt=dt, device=device,
                     decomp=decomp if sharded else None)
        if p.gravitational_waves:
            stepper = pt.FusedPreheatStepper(
                scalar_sector, gw_sector, p.grid_shape, lattice.dx,
                p.halo_shape, **fused)
        else:
            stepper = pt.FusedScalarStepper(
                scalar_sector, p.grid_shape, lattice.dx, p.halo_shape,
                **fused)
    else:
        stepper = Stepper(full_rhs, dt=dt)

    reduce_energy = pt.Reduction(scalar_sector, callback=pt.get_rho_and_p,
                                 grid_size=p.grid_size)

    def compute_energy(state, a):
        return reduce_energy(f=state["f"], dfdt=state["dfdt"],
                             lap_f=derivs.lap(state["f"]),
                             a=np.float64(a))

    # observables; the default output lands in bench_results/, beside the
    # JAX example's
    out = pt.OutputFile(
        runfile=__file__, name=p.outfile,
        out_dir=os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "bench_results")) \
        if decomp.rank == 0 else None
    statistics = pt.FieldStatistics(grid_size=p.grid_size)
    spectra = pt.PowerSpectra(decomp, fft, lattice.dk, lattice.volume,
                              scheme=p.fft_scheme)
    projector = pt.Projector(fft, p.halo_shape, lattice.dk, lattice.dx,
                             scheme=p.fft_scheme)
    hist = pt.FieldHistogrammer(decomp, 1000, p.dtype)

    hubble_var = pt.Var("hubble")
    a_sq_rho = 3 * p.mpl**2 * hubble_var**2 / 8 / np.pi
    compute_rho = pt.ElementWiseMap(
        {pt.Field("rho"): scalar_sector.stress_tensor(0, 0) / a_sq_rho})

    def output(step_count, t, energy, expand, state):
        if step_count % 4 == 0:
            f_stats = statistics(state["f"])
            if out is not None:
                out.output(
                    "energy", t=t, a=expand.a,
                    adot=expand.adot / expand.a,
                    hubble=expand.hubble / expand.a,
                    **{k: np.asarray(v) for k, v in energy.items()},
                    eos=energy["pressure"] / energy["total"],
                    constraint=expand.constraint(energy["total"]))
                out.output("statistics/f", t=t, a=expand.a, **f_stats)

        if expand.a / output.a_last_spec >= p.spectra_cadence:
            output.a_last_spec = expand.a

            dfdx = derivs.grad(state["f"])
            rho = compute_rho(
                a=np.float64(expand.a), hubble=np.float64(expand.hubble),
                f=state["f"], dfdt=state["dfdt"], dfdx=dfdx)["rho"]
            rho_hist = hist(rho)
            t_spec0 = time.perf_counter()
            spec_out = {"scalar": spectra(state["f"]), "rho": spectra(rho)}
            if p.gravitational_waves:
                spec_out["gw"] = spectra.gw(state["dhijdt"], projector,
                                            expand.hubble)
            spec_ms = (time.perf_counter() - t_spec0) * 1e3
            output.spectra_ms.append(spec_ms)
            pt.obs.emit("spectra_time", step=step_count, ms=spec_ms,
                        a=float(expand.a), gw=bool(p.gravitational_waves),
                        label="scalar_preheating")

            if out is not None:
                out.output("rho_histogram", t=t, a=expand.a, **rho_hist)
                out.output("spectra", t=t, a=expand.a, **spec_out)

    output.a_last_spec = .1
    output.spectra_ms = []

    print("Initializing fields")
    state = {
        "f": place(np.stack([np.full(p.grid_shape, f0[i], p.dtype)
                             for i in range(p.nscalars)])),
        "dfdt": place(np.stack([np.full(p.grid_shape, df0[i], p.dtype)
                                for i in range(p.nscalars)])),
    }
    if p.gravitational_waves:
        state["hij"] = place(np.zeros((6,) + p.grid_shape, p.dtype))
        state["dhijdt"] = place(np.zeros((6,) + p.grid_shape, p.dtype))

    # background energy -> initial expansion
    energy = compute_energy(state, 1.)
    expand = pt.Expansion(energy["total"], Stepper, mpl=p.mpl)

    # effective masses (with Hubble correction) for WKB initialization,
    # via symbolic second derivatives of the potential
    addot = expand.addot_friedmann_2(expand.a, energy["total"],
                                     energy["pressure"])
    hubble_correction = - addot / expand.a
    fsym = pt.Field("f0_bg", shape=(p.nscalars,))
    eff_mass = [
        float(pt.evaluate(pt.diff(potential(fsym), fsym[i], fsym[i]),
                          {"f0_bg": np.array(f0)})) + hubble_correction
        for i in range(p.nscalars)]

    modes = pt.RayleighGenerator(fft=fft, dk=lattice.dk,
                                 volume=lattice.volume, seed=p.seed)

    fluct_f, fluct_df = [], []
    for fld in range(p.nscalars):
        fx, dfx = modes.init_WKB_fields(
            norm=p.mphi**2,
            omega_k=lambda k, fld=fld: torch.sqrt(k**2 + eff_mass[fld]),
            hubble=expand.hubble)
        fluct_f.append(pt.to_numpy(fx))
        fluct_df.append(pt.to_numpy(dfx))

    state["f"] = state["f"] + place(np.stack(fluct_f))
    state["dfdt"] = state["dfdt"] + place(np.stack(fluct_df))

    # re-initialize energy and expansion with fluctuations included
    energy = compute_energy(state, expand.a)
    expand = pt.Expansion(energy["total"], Stepper, mpl=p.mpl)

    t, step_count = 0., 0

    ckpt = None
    if p.checkpoint_dir is not None:
        ckpt = pt.Checkpointer(p.checkpoint_dir,
                               save_interval_steps=p.checkpoint_interval,
                               device=device)
        if ckpt.latest_step is not None:
            step_count, state, meta = ckpt.restore(
                decomp=decomp if sharded else None)
            t = meta["t"]
            expand = pt.Expansion(meta["energy_total"], Stepper, mpl=p.mpl)
            expand.a = expand.dtype.type(meta["a"])
            expand.adot = expand.dtype.type(meta["adot"])
            expand.hubble = expand.adot / expand.a
            energy = compute_energy(state, expand.a)
            if decomp.rank == 0:
                print(f"Resumed from checkpoint at step {step_count}")

    output(step_count, t, energy, expand, state)

    if decomp.rank == 0:
        print("Time evolution beginning")
        print("time\t", "scale factor", "ms/step\t", "steps/second",
              sep="\t")
    pt.obs.emit("run_start", step=step_count, t=t, a=float(expand.a),
                grid_shape=p.grid_shape, proc_shape=p.proc_shape,
                gravitational_waves=p.gravitational_waves,
                chunk_steps=p.chunk_steps)

    # per-step step_time events cost nothing without an event log
    steptimer = pt.StepTimer(report_every=30.0, emit_steps=True)
    # the async numerics sentinel: a health vector every iteration (K15 on
    # the card, no sync) polled health_every steps behind; a synchronous
    # check_now still guards every checkpoint save, and a trip writes the
    # forensic bundle before SimulationDiverged propagates
    monitor = pt.HealthMonitor(every=p.health_every)
    monitor.forensics = pt.obs.ForensicSink(
        p.forensics_dir, events_path=pt.obs.get_log().path,
        checkpoint=ckpt, config={k: v for k, v in vars(p).items()
                                 if isinstance(v, (bool, int, float,
                                                   str, tuple, list,
                                                   type(None)))},
        label="scalar_preheating")

    def metadata():
        return {"t": t, "a": float(expand.a), "adot": float(expand.adot),
                "energy_total": float(np.sum(energy["total"]))}

    carry = None
    try:
        while t < p.end_time and expand.a < p.end_scale_factor:
            if p.chunk_steps:
                n = p.chunk_steps
                if p.chunk_mode == "coupled":
                    pair = {"auto": None, "on": True,
                            "off": False}[p.chunk_pair]
                    state = stepper.coupled_multi_step(
                        state, n, expand, t, dt, grid_size=p.grid_size,
                        pair=pair)
                else:
                    a_seq, hubble_seq = expand.stage_sequence(
                        n, energy["total"], energy["pressure"], dt)
                    state = stepper.multi_step(
                        state, n, t, dt,
                        rhs_seq={"a": a_seq, "hubble": hubble_seq})
                energy = compute_energy(state, expand.a)
                t += n * dt
                step_count += n
            else:
                for s in range(stepper.num_stages):
                    carry = stepper(s, state if s == 0 else carry, t,
                                    a=np.float64(expand.a),
                                    hubble=np.float64(expand.hubble))
                    expand.step(s, energy["total"], energy["pressure"], dt)
                    if s == stepper.num_stages - 1:
                        state = carry
                        energy = compute_energy(state, expand.a)
                    else:
                        energy = compute_energy(stepper.current(carry),
                                                expand.a)
                t += dt
                step_count += 1
            output(step_count, t, energy, expand, state)
            # the model invariants beside the sentinel's field statistics
            pt.obs.emit("health", step=step_count, invariants={
                "constraint": float(expand.constraint(energy["total"])),
                "energy_total": float(np.sum(energy["total"]))})
            monitor.observe(step_count, state)
            monitor.poll()
            # a NaN state is never checkpointed: every save follows a
            # synchronous check of the state it saves; a chunked run steps
            # past interval multiples, so a save is due whenever this
            # advance crossed one
            prev = step_count - (p.chunk_steps or 1)
            if ckpt is not None and step_count // p.checkpoint_interval \
                    > prev // p.checkpoint_interval:
                monitor.check_now(state, step=step_count)
                # the durability barrier of the previous interval's save:
                # last_good names only checkpoints confirmed on disk
                ckpt.finalize()
                ckpt.save(step_count, state, metadata=metadata(),
                          force=True)
            telemetry = steptimer.tick()
            if telemetry is not None and decomp.rank == 0:
                ms_per_step, steps_per_s = telemetry
                print(f"{t:<15.3f}", f"{expand.a:<15.3f}",
                      f"{ms_per_step:<15.3f}", f"{steps_per_s:<15.3f}")

        # normal completion: drain the async queue, check the final state
        # synchronously, then the final checkpoint
        monitor.flush()
        monitor.check_now(state, step=step_count)
        if ckpt is not None and ckpt.latest_step != step_count:
            ckpt.save(step_count, state, metadata=metadata())
        constraint = expand.constraint(energy["total"])
        if out is not None:
            out.file.attrs["final_constraint"] = constraint
    except BaseException as e:
        # the forensic tail of the run record (a diverged event, if any,
        # directly precedes it)
        pt.obs.emit("run_aborted", step=step_count, t=t,
                    error=f"{type(e).__name__}: {e}")
        raise
    finally:
        # persistence is finalized on divergence and interrupt too
        if ckpt is not None:
            ckpt.wait()
            ckpt.close()
        if out is not None:
            out.close()

    if decomp.rank == 0:
        print("Simulation complete")
        if output.spectra_ms:
            print(f"spectra ms per output: {np.mean(output.spectra_ms):.3f}")
        print(f"final constraint: {constraint:.16e}")
    pt.obs.emit("run_complete", step=step_count, t=t, a=float(expand.a),
                constraint=float(constraint))
    return constraint


if __name__ == "__main__":
    main()
