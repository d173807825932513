"""pystella_tpu_torch: the PyTorch/CUDA port of pystella_tpu.

A second package beside the JAX one. It imports ``torch`` and never
``jax`` or ``pystella_tpu``; the JAX package is the reference its tests
hold it to. It runs the 2-field scalar-preheating hot loop,
:meth:`FusedScalarStepper.multi_step`, the energy-coupled driver,
:meth:`FusedScalarStepper.coupled_multi_step` with :class:`Expansion` and
:class:`Reduction`, and the same two for the gravitational-wave system
(:class:`FusedPreheatStepper` with a :class:`TensorPerturbationSector`); the
finite-difference operators of :class:`FiniteDifferencer` behind the
generic steppers; and the multigrid solvers (:mod:`.multigrid`:
:class:`FullApproximationScheme`, :class:`MultiGridSolver` over
:class:`JacobiIterator` / :class:`NewtonIterator`), on an NVIDIA H100 with
hand-written CUDA kernels (``ops/csrc``). With a
:class:`DomainDecomposition` (one process driving a grid of devices, several
shards per card allowed) the fused scalar stepper, :class:`FiniteDifferencer`
and :class:`Reduction` take :class:`ShardedArray` s: halo-padded and
overlapped (interior + shell) launches of the same kernels.

The science example's measurement step is ported too: :class:`ElementWiseMap`,
:class:`Histogrammer` / :class:`FieldHistogrammer` and the Fourier stack
(:class:`DFT` on ``torch.fft``, :class:`Projector`, :class:`PowerSpectra`,
:class:`RayleighGenerator`, :class:`SpectralCollocator`,
:class:`SpectralPoissonSolver`, :class:`FFTStencil`), with the histograms and
the spectra binned by hand-written deterministic kernels
(``ops/csrc/histogram.cu``), and :class:`OutputFile` (h5py, imported when a
file is opened).

The science driver's run safety is ported too: the run-event log and
metrics (:mod:`.obs`), the numerics sentinel (:class:`obs.Sentinel`, its
field statistics by a hand-written kernel, ``ops/csrc/health.cu``) behind
:class:`HealthMonitor`, forensic bundles, :class:`Checkpointer` with resume
and :class:`StepTimer`.

Entry points run on the GPU unless the caller asks for the CPU
(``device="cpu"``); without CUDA and without that request they raise.
"""

from pystella_tpu_torch._device import resolve_device
from pystella_tpu_torch.convert import (
    carry_from_numpy, expansion_from_numpy, shard_state, state_from_numpy,
    to_numpy,
)
from pystella_tpu_torch.field import (
    Call, Constant, DynamicField, Expr, Field, Indexed, Power, Product,
    Quotient, Shifted, Sum, Var, diff, evaluate, field_names, shift_fields,
    simplify, substitute,
    exp, log, sin, cos, tan, sinh, cosh, tanh, sqrt, fabs, sign,
    t, x, y, z,
)
from pystella_tpu_torch.fourier import (
    DFT, PowerSpectra, Projector, RayleighGenerator, SpectralCollocator,
    SpectralPoissonSolver, make_dft,
)
from pystella_tpu_torch.grid import Lattice
from pystella_tpu_torch import multigrid
from pystella_tpu_torch.models.expansion import Expansion
from pystella_tpu_torch.models.sectors import (
    ScalarSector, Sector, TensorPerturbationSector, get_rho_and_p,
    tensor_index,
)
from pystella_tpu_torch.multigrid import (
    CubicInterpolation, FullApproximationScheme, FullWeighting, Injection,
    JacobiIterator, LinearInterpolation, MultiGridSolver, NewtonIterator,
    f_cycle, v_cycle, w_cycle,
)
from pystella_tpu_torch.ops.derivs import (
    FiniteDifferencer, FirstCenteredDifference, SecondCenteredDifference,
    centered_diff, expand_stencil,
)
from pystella_tpu_torch.ops.elementwise import ElementWiseMap
from pystella_tpu_torch.ops.fft_stencil import FFTStencil, fft_laplacian
from pystella_tpu_torch.ops.fused import (
    FusedPreheatStepper, FusedScalarStepper,
)
from pystella_tpu_torch.ops.histogram import FieldHistogrammer, Histogrammer
from pystella_tpu_torch.ops.reduction import FieldStatistics, Reduction
from pystella_tpu_torch.parallel import (
    DomainDecomposition, HaloShells, ShardedArray, blockwise,
)
from pystella_tpu_torch.step import (
    LowStorageRK3Inhomogeneous, LowStorageRK3PredictorCorrector,
    LowStorageRK3SSP, LowStorageRK3Symmetric, LowStorageRK3Williamson,
    LowStorageRK54, LowStorageRK124, LowStorageRK134, LowStorageRK144,
    LowStorageRKStepper, RungeKutta2Heun, RungeKutta2Midpoint,
    RungeKutta2Ralston, RungeKutta3Heun, RungeKutta3Nystrom,
    RungeKutta3Ralston, RungeKutta3SSP, RungeKutta4, RungeKuttaStepper,
    Stepper, all_steppers, compile_rhs_dict,
)
from pystella_tpu_torch import obs
from pystella_tpu_torch.utils import (
    Checkpointer, HealthMonitor, OutputFile, SimulationDiverged, StepTimer,
    timer, trace)

__all__ = [
    "resolve_device", "state_from_numpy", "carry_from_numpy", "to_numpy",
    "expansion_from_numpy", "shard_state", "DomainDecomposition",
    "HaloShells", "ShardedArray", "blockwise", "Expansion", "Reduction",
    "FieldStatistics",
    "Expr", "Constant", "Sum", "Product", "Quotient", "Power", "Call", "Var",
    "Field", "Indexed", "Shifted", "DynamicField", "diff", "evaluate",
    "field_names", "shift_fields", "simplify", "substitute",
    "exp", "log", "sin", "cos", "tan", "sinh", "cosh", "tanh", "sqrt",
    "fabs", "sign", "t", "x", "y", "z",
    "Lattice", "Sector", "ScalarSector", "TensorPerturbationSector",
    "get_rho_and_p", "tensor_index",
    "FiniteDifferencer", "FirstCenteredDifference",
    "SecondCenteredDifference", "expand_stencil", "centered_diff",
    "FusedScalarStepper", "FusedPreheatStepper",
    "multigrid", "FullApproximationScheme", "MultiGridSolver",
    "JacobiIterator", "NewtonIterator", "FullWeighting", "Injection",
    "LinearInterpolation", "CubicInterpolation", "v_cycle", "w_cycle",
    "f_cycle",
    "Stepper", "RungeKuttaStepper", "LowStorageRKStepper",
    "compile_rhs_dict", "RungeKutta4", "RungeKutta3Heun",
    "RungeKutta3Nystrom", "RungeKutta3Ralston", "RungeKutta3SSP",
    "RungeKutta2Midpoint", "RungeKutta2Heun", "RungeKutta2Ralston",
    "LowStorageRK54", "LowStorageRK144", "LowStorageRK134",
    "LowStorageRK124", "LowStorageRK3Williamson",
    "LowStorageRK3Inhomogeneous", "LowStorageRK3Symmetric",
    "LowStorageRK3PredictorCorrector", "LowStorageRK3SSP", "all_steppers",
    "ElementWiseMap", "Histogrammer", "FieldHistogrammer", "DFT",
    "make_dft", "Projector", "PowerSpectra", "RayleighGenerator",
    "SpectralCollocator", "SpectralPoissonSolver", "FFTStencil",
    "fft_laplacian", "OutputFile",
    "obs", "Checkpointer", "HealthMonitor", "SimulationDiverged",
    "StepTimer", "timer", "trace",
]
