#!/usr/bin/env python3
"""Wall seconds of ``nvcc`` for each CUDA source of the port's fused
steppers, built as ``chip_smoke.py`` builds them: every source of its four
fused models (the bench model with the chunk kernel, the non-polynomial
model, the GW bench model and the GW example model) at once, into a fresh
directory. Needs ``nvcc`` (the GPU machine).

    python3 build_times.py [CSRC_DIR]

``CSRC_DIR`` defaults to this checkout's ``pystella_tpu_torch/ops/csrc``;
another checkout's directory times its sources against the same models'
headers (the headers come from this checkout's code printer). Prints one
JSON line: ``{"csrc": ..., "wall_s": ..., "seconds": {"<source>
(<model>)": s}}``.
"""

import json
import os
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path


def main():
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import chip_smoke as cs
    import pystella_tpu_torch as pt
    from pystella_tpu_torch.ops import fused, stencil

    csrc = Path(sys.argv[1] if len(sys.argv) > 1 else stencil.CSRC_DIR)
    sector = pt.ScalarSector(2, potential=cs.potential)
    bench = pt.ScalarSector(2, potential=cs.gw_bench_potential)
    shape, dx = cs.NONPOLY_SHAPE, cs.BOX / cs.GRID[0]
    # the steppers only print the headers here: on the CPU nothing builds
    models = {
        "bench": pt.FusedScalarStepper(sector, shape, dx, cs.HALO,
                                       chunk_stages=cs.CHUNK, device="cpu"),
        "nonpoly": pt.FusedScalarStepper(pt.ScalarSector(
            2, potential=cs.nonpoly_potential), shape, dx, cs.HALO,
            device="cpu"),
        "gw_bench": pt.FusedPreheatStepper(
            bench, pt.TensorPerturbationSector([bench]), shape, dx, cs.HALO,
            device="cpu"),
        "gw": pt.FusedPreheatStepper(
            sector, pt.TensorPerturbationSector([sector]), shape, dx,
            cs.HALO, device="cpu")}
    jobs = {label: (sorted({fused.KERNELS[n][0]
                            for n in st._kernel_bases()}),
                    st.kernel_header()) for label, st in models.items()}
    stencil.CSRC_DIR = csrc
    stencil.BUILD_DIR = Path(tempfile.mkdtemp(prefix="build_times-"))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(jobs)) as pool:
        for f in [pool.submit(stencil.build_kernels, *job)
                  for job in jobs.values()]:
            f.result()
    wall = time.perf_counter() - t0
    print(json.dumps({"csrc": str(csrc), "wall_s": wall, "seconds": {
        f"{src} ({label})": stencil.build_seconds(src, header)
        for label, (srcs, header) in jobs.items() for src in srcs}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
