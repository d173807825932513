"""Example: a coupling-constant scan as an ensemble population, on the
PyTorch/CUDA port (``pystella_tpu_torch``).

The arguments, physics and output lines of ``examples/ensemble_scan.py``: a
queue of two-field preheating scenarios with per-member coupling draws and
initial-condition seeds, packed along the ``(ensemble, x, y, z)`` mesh
(:func:`ensemble_mesh` over the visible cards), advanced by
:class:`EnsembleDriver` in the ``"vmap"`` tier (``torch.func.vmap`` of one
member's RK54 body, whose ``fd_lap`` kernel runs once a stage for the whole
batch), with the per-member numerics sentinel behind every chunk (one K15
read of the batch): a diverged draw is evicted and its slot resampled
without stopping the batch. The coupling is a batched ``rhs_args`` leaf,
so one body serves every draw.

``--device`` (not in the JAX example) picks the device: the GPU by default
(every visible card along the ensemble axis), ``cpu`` for the plain PyTorch
versions of the kernels. The operator is built with the port's signature,
``FiniteDifferencer(2, dx)`` (one per device of the mesh): the JAX
example's ``mode="halo"`` has no counterpart, the port's modes being
``"kernel"`` and ``"roll"``.

    python examples/torch_ensemble_scan.py --members 8 --jobs 32 \\
        --device cpu

Emits the ensemble run events (``--event-log``): ``ensemble_run``,
``ensemble_chunk``, ``ensemble_health``, ``member_*`` and
``ensemble_done``.
"""

from argparse import ArgumentParser

import numpy as np
import torch

import pystella_tpu_torch as pt

parser = ArgumentParser()
parser.add_argument("--grid-shape", "-grid", type=int, nargs=3,
                    default=(16, 16, 16))
parser.add_argument("--members", type=int, default=None,
                    help="batch size (default: PYSTELLA_ENSEMBLE_SIZE)")
parser.add_argument("--jobs", type=int, default=32,
                    help="total scenario jobs (seeds) to drain")
parser.add_argument("--nsteps", type=int, default=64,
                    help="per-member step budget")
parser.add_argument("--chunk", type=int, default=8,
                    help="steps per batched dispatch")
parser.add_argument("--g2-range", type=float, nargs=2,
                    default=(1e-7, 5e-7),
                    help="uniform range of the phi^2 chi^2 coupling")
parser.add_argument("--event-log", default=None,
                    help="run-event JSONL path (observability)")
parser.add_argument("--forensics-dir", default=None,
                    help="directory for member-scoped forensic "
                         "bundles on eviction")
parser.add_argument("--device", default=None,
                    help="'cpu' for the plain versions (default: every "
                         "visible GPU)")


def build(p):
    """The scan's mesh, stepper and scenario: ``{"decomp", "stepper",
    "rhs", "sample", "scenario", "dt"}`` (``rhs(state, t, a, hubble,
    g2_over_2)`` is one member's right-hand side, ``sample(seed) ->
    (state, params)`` one member's draw)."""
    grid_shape = tuple(p.grid_shape)
    # mesh: members pack the devices (small lattices are not split
    # spatially: proc_shape (1, 1, 1), and shard over `ensemble`)
    mesh = pt.ensemble_mesh(
        devices=None if p.device is None else [p.device])
    decomp = pt.DomainDecomposition(mesh=mesh,
                                    ensemble_axis=mesh.axis_names[0])

    # one member's physics: the two-field preheating system of the JAX
    # example, at example scale
    lattice = pt.Lattice(grid_shape, (5.0, 5.0, 5.0), dtype=np.float32)
    dt = np.float32(0.1 * min(lattice.dx))
    mphi = 1.20e-6

    def potential(f):
        phi, chi = f[0], f[1]
        return (mphi**2 / 2 * phi**2
                + pt.Field("g2_over_2") * phi**2 * chi**2) / mphi**2

    # keep the coupling a runtime parameter (a batched rhs_args leaf), not
    # a constant of the body: one body serves every draw
    sector = pt.ScalarSector(2, potential=potential)
    derivs = {d: pt.FiniteDifferencer(2, lattice.dx, device=d)
              for d in set(mesh.devices.reshape(-1))}
    sector_rhs = pt.compile_rhs_dict(sector.rhs_dict)

    def full_rhs(state, t, a, hubble, g2_over_2):
        f = state["f"]
        return sector_rhs(state, t, lap_f=derivs[f.device].lap(f),
                          a=a, hubble=hubble, g2_over_2=g2_over_2)

    stepper = pt.LowStorageRK54(full_rhs, dt=dt)

    def sample(seed):
        rng = np.random.default_rng(seed)
        state = {
            "f": 1e-3 * rng.standard_normal(
                (2,) + grid_shape).astype(np.float32),
            "dfdt": 1e-4 * rng.standard_normal(
                (2,) + grid_shape).astype(np.float32),
        }
        g2 = rng.uniform(*p.g2_range)
        # the potential divides by mphi^2 itself; the draw is the bare
        # g^2/2 coefficient of phi^2 chi^2
        return state, {"a": 1.0, "hubble": 0.5, "g2_over_2": g2 / 2}

    scenario = pt.Scenario(
        "g2-scan", stepper, sample, nsteps=p.nsteps, dt=dt,
        invariants={"kinetic_mean": lambda st, aux: 0.5 * torch.mean(
            torch.sum(torch.square(st["dfdt"]), dim=0))})
    return {"decomp": decomp, "stepper": stepper, "rhs": full_rhs,
            "sample": sample, "scenario": scenario, "dt": dt}


def main(argv=None, keep_seeds=()):
    """Run the scan; returns the driver's output, with ``finals`` (per
    retired seed: seed, g2/2 and final <dfdt^2>) and ``states`` (the final
    host states of the seeds in ``keep_seeds``) added."""
    p = parser.parse_args(argv)
    if p.event_log:
        pt.obs.configure(p.event_log)
    scan = build(p)
    decomp = scan["decomp"]

    sink = (pt.obs.ForensicSink(p.forensics_dir, events_path=p.event_log,
                                label="ensemble-scan")
            if p.forensics_dir else None)
    driver = pt.EnsembleDriver(size=p.members, chunk=p.chunk,
                               decomp=decomp, forensics=sink,
                               emit_steps=True, label="g2-scan")
    driver.submit(scan["scenario"], seeds=range(p.jobs))

    finals, states = [], {}

    def on_finish(record, state):
        # retire-time host sync: keep a population-level summary, not
        # the full member state
        finals.append((record["seed"],
                       record["params"].get("g2_over_2"),
                       float(np.mean(np.square(state["dfdt"])))))
        if record["seed"] in keep_seeds:
            states[record["seed"]] = state

    out = driver.run(on_finish=on_finish)
    st = out["stats"]
    print(f"{st['members_completed']} member(s) completed, "
          f"{st['evictions']} eviction(s): "
          f"{st['member_steps']} member-steps in {st['wall_s']:.2f}s "
          f"-> {st['member_steps_per_s']:.1f} member-steps/s "
          f"(occupancy {st['occupancy_mean']:.0%}, "
          f"{len(set(decomp.mesh.devices.reshape(-1)))} device(s))")
    for ev in out["evictions"]:
        print(f"  evicted member {ev.member} "
              f"(seed {ev.params.get('seed')}) at step {ev.step}: "
              f"{list(ev.fields)}"
              + (f" -> {ev.bundle}" if ev.bundle else ""))
    for seed, g2_half, kin in sorted(finals)[:8]:
        print(f"  seed {seed}: g2/2 = {g2_half:.4g}, "
              f"final <dfdt^2> = {kin:.4g}")
    out["finals"] = sorted(finals)
    out["states"] = states
    return out


if __name__ == "__main__":
    main()
