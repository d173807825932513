"""Transform-scheme planning, single controller.

PyTorch counterpart of ``pystella_tpu/fourier/plan.py``. The JAX package
chooses between its fully distributed ``pencil`` tier (``fourier/
pencil.py``) and the ``DFT`` class's reshard tiers; the port has one
transform, :class:`~pystella_tpu_torch.fourier.DFT` (on one device, or
gathering a sharded lattice to one), so every scheme name but
``"pencil"`` selects it. ``"pencil"``, forced or chosen through
``PYSTELLA_FFT_SCHEME``, raises ``NotImplementedError``: the pencil tier
waits for ROADMAP queue 1 item 5 and is never quietly replaced by the
gather.
"""

from __future__ import annotations

import numpy as np

__all__ = ["SCHEMES", "make_dft", "resolve_scheme", "ensure_spectral_fft"]

#: accepted scheme names (the JAX package's); all but "pencil" name the
#: port's DFT
SCHEMES = ("auto", "pencil", "dft", "reshard", "partial", "replicate",
           "local")


def resolve_scheme(scheme=None):
    """The effective scheme name: explicit argument >
    ``PYSTELLA_FFT_SCHEME`` > ``"auto"``. Unknown names raise."""
    if scheme is None:
        from pystella_tpu_torch import config as _config
        scheme = _config.getenv("PYSTELLA_FFT_SCHEME") or "auto"
    scheme = str(scheme).strip().lower()
    if scheme not in SCHEMES:
        raise ValueError(
            f"unknown FFT scheme {scheme!r}; known: {SCHEMES}")
    return scheme


def _refuse_pencil():
    raise NotImplementedError(
        "the pencil FFT tier (pystella_tpu/fourier/pencil.py) is not ported "
        "yet: it waits for ROADMAP queue 1 item 5 (the rest of the "
        "decomposition); use scheme='auto' or 'dft' for the port's DFT")


def make_dft(decomp, context=None, queue=None, grid_shape=None,
             dtype=np.float64, scheme=None, **kwargs):
    """Construct the transform for ``(decomp, grid_shape)``: the
    ``DFT(...)`` constructor plus a ``scheme`` knob (see the module
    docstring)."""
    from pystella_tpu_torch.fourier.dft import DFT
    if grid_shape is None:
        raise ValueError("grid_shape is required")
    if resolve_scheme(scheme) == "pencil":
        _refuse_pencil()
    return DFT(decomp, grid_shape=grid_shape, dtype=dtype, **kwargs)


def ensure_spectral_fft(fft, scheme=None):
    """The transform a k-space consumer should use: the one passed (the
    port has one transform class); ``"pencil"`` raises."""
    if resolve_scheme(scheme) == "pencil":
        _refuse_pencil()
    return fft
