"""Spectral Poisson solver.

PyTorch counterpart of ``pystella_tpu/fourier/poisson.py``: solves
``lap f - m**2 f = rho`` in k-space with *stencil-consistent* eigenvalues
``effective_k(k, dx)`` (so the solution satisfies the finite-difference
discretization exactly), the zero mode projected out. A
:class:`~pystella_tpu_torch.parallel.ShardedArray` is gathered to the
transform's device and the solution sharded back.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["SpectralPoissonSolver"]


class SpectralPoissonSolver:
    """Solve ``lap f - m**2 f = rho`` spectrally.

    :arg fft: a :class:`~pystella_tpu_torch.fourier.DFT`.
    :arg dk: momentum-space grid spacing per axis.
    :arg dx: position-space grid spacing per axis.
    :arg effective_k: callable ``(k, dx)`` returning the second-difference
        stencil eigenvalue (the effective ``-k**2``); use
        ``SecondCenteredDifference(h).get_eigenvalues`` for consistency
        with an h-order FD Laplacian, or ``lambda k, dx: -k**2`` for
        spectral.
    :arg scheme: transform-scheme override; ``"pencil"`` raises (not
        ported).
    """

    def __init__(self, fft, dk, dx, effective_k, scheme=None):
        from pystella_tpu_torch.fourier.plan import ensure_spectral_fft
        fft = ensure_spectral_fft(fft, scheme)
        self.fft = fft
        rdtype = fft.rdtype
        self._eig = [
            fft.k_axis_array(mu, np.asarray(
                effective_k(dk[mu] * kk.astype(rdtype), dx[mu]), rdtype))
            for mu, kk in enumerate(fft.sub_k.values())]

    def _solve(self, rho, m_squared):
        rhok = self.fft._dft_impl(rho)
        minus_ksq = sum(self._eig)  # negative semi-definite
        denom = minus_ksq - m_squared
        # the zero mode (denom == 0 when m**2 = 0) projected out
        good = minus_ksq < 0
        fk = torch.where(good, rhok / torch.where(good, denom, 1.0), 0.0)
        return self.fft._idft_impl(fk).to(rho.dtype)

    def __call__(self, fx=None, rho=None, m_squared=0, queue=None,
                 allocator=None):
        """Solve and return ``f`` (the reference fills the passed ``fx``;
        here the solution is returned)."""
        if rho is None:
            raise ValueError("rho is required")
        return self.fft.on_whole(lambda r: self._solve(r, m_squared), rho)
