"""The port's Fourier stack on one device (``torch.fft``): transforms,
projections, power spectra, spectral derivatives, the spectral Poisson
solver and Gaussian random fields. The JAX package's ``PencilFFT`` and
``pencil_feasible`` (``fourier/pencil.py``) wait for ROADMAP queue 1
item 5."""

from pystella_tpu_torch.fourier.dft import (
    DFT, fftfreq, pfftfreq, make_hermitian, get_sliced_momenta,
    get_real_dtype_with_matching_prec, get_complex_dtype_with_matching_prec,
)
from pystella_tpu_torch.fourier.plan import make_dft, ensure_spectral_fft
from pystella_tpu_torch.fourier.projectors import Projector, tensor_index
from pystella_tpu_torch.fourier.spectra import PowerSpectra
from pystella_tpu_torch.fourier.rayleigh import RayleighGenerator
from pystella_tpu_torch.fourier.derivs import SpectralCollocator
from pystella_tpu_torch.fourier.poisson import SpectralPoissonSolver

__all__ = [
    "DFT", "make_dft", "ensure_spectral_fft",
    "fftfreq", "pfftfreq", "make_hermitian", "get_sliced_momenta",
    "get_real_dtype_with_matching_prec",
    "get_complex_dtype_with_matching_prec",
    "Projector", "tensor_index", "PowerSpectra", "RayleighGenerator",
    "SpectralCollocator", "SpectralPoissonSolver",
]
