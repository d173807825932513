"""The port's CUDA kernels against their plain PyTorch versions, on the
card.

These tests need an NVIDIA GPU and nvcc, and skip without them: a CUDA
kernel has no CPU mode. The file imports neither JAX nor the JAX package,
so it runs on a machine that has only PyTorch:

    python -m pytest --noconftest tests/test_torch_kernels.py
"""

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
    got = np.asarray(got.cpu(), np.float64)
    ref = np.asarray(ref.cpu(), np.float64)
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
