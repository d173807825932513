"""Minimal example: the 3-D wave equation on a periodic lattice, on the
PyTorch/CUDA port (``pystella_tpu_torch``).

The arguments, physics and output lines of ``examples/wave_equation.py``:
Gaussian-random initial conditions (:class:`RayleighGenerator`), the
symbolic system ``{f: f.dot, f.dot: lap(f)}``, LowStorageRK54 time stepping
and finite-difference derivatives (:class:`FiniteDifferencer`, the
hand-written ``fd_lap`` kernel on the card), on one device or on a
:class:`DomainDecomposition` whose shards one process drives. It prints the
semi-discrete energy before and after, and its relative drift.

``--device`` (not in the JAX example) picks the device: the GPU by default,
``cpu`` for the plain PyTorch versions of the kernels.

    python examples/torch_wave_equation.py -grid 32 32 32 --end-time 1 \\
        --device cpu
"""

from argparse import ArgumentParser

import numpy as np
import torch

import pystella_tpu_torch as pt

parser = ArgumentParser()
parser.add_argument("--grid-shape", "-grid", type=int, nargs=3,
                    default=(64, 64, 64))
parser.add_argument("--proc-shape", "-proc", type=int, nargs=3,
                    default=(1, 1, 1))
parser.add_argument("--halo-shape", type=int, default=2)
parser.add_argument("--box-dim", "-box", type=float, nargs=3,
                    default=(2 * np.pi, 2 * np.pi, 2 * np.pi))
parser.add_argument("--kappa", type=float, default=1 / 10)
parser.add_argument("--end-time", type=float, default=2.0)
parser.add_argument("--dtype", type=np.dtype, default=np.float64)
parser.add_argument("--device", default=None,
                    help="'cpu' for the plain versions (default: the GPU)")


def main(argv=None):
    p = parser.parse_args(argv)
    p.grid_shape = tuple(p.grid_shape)
    p.box_dim = tuple(p.box_dim)
    device = pt.resolve_device(p.device)

    lattice = pt.Lattice(p.grid_shape, p.box_dim, dtype=p.dtype)
    ndev = int(np.prod(p.proc_shape))
    decomp = (pt.DomainDecomposition(tuple(p.proc_shape),
                                     devices=[device] * ndev)
              if ndev > 1 else None)
    fft = pt.DFT(decomp, grid_shape=p.grid_shape, dtype=p.dtype,
                 device=device)
    derivs = pt.FiniteDifferencer(p.halo_shape, lattice.dx, device=device,
                                  decomp=decomp)

    # Gaussian random initial data
    gen = pt.RayleighGenerator(fft=fft, dk=lattice.dk,
                               volume=lattice.volume)
    f0 = gen.init_field(field_ps=lambda k: k**-3)
    state = {
        "f": f0,
        "dfdt": (decomp.zeros(p.grid_shape, p.dtype) if decomp is not None
                 else torch.zeros_like(f0)),
    }

    f = pt.DynamicField("f")
    rhs = pt.compile_rhs_dict({f: f.dot, f.dot: f.lap})

    def full_rhs(state, t):
        return rhs(state, t, lap_f=derivs.lap(state["f"]))

    stepper = pt.LowStorageRK54(full_rhs)

    def energy(state):
        lap = pt.to_numpy(derivs.lap(state["f"]))
        host = pt.to_numpy(state)
        kin = 0.5 * float(np.mean(host["dfdt"]**2))
        grd = -0.5 * float(np.mean(host["f"] * lap))
        return kin + grd

    dt = p.kappa * min(lattice.dx)
    t, step_count = 0.0, 0
    e0 = energy(state)
    print(f"initial energy: {e0:.8e}")

    while t < p.end_time:
        state = stepper.step(state, t, dt)
        t += dt
        step_count += 1

    e1 = energy(state)
    print(f"final energy:   {e1:.8e}")
    print(f"energy drift:   {abs(e1 - e0) / abs(e0):.3e} "
          f"after {step_count} steps")
    return abs(e1 - e0) / abs(e0)


if __name__ == "__main__":
    main()
