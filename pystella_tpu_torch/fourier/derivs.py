"""Spectral-collocation derivatives.

PyTorch counterpart of ``pystella_tpu/fourier/derivs.py``: the interface
of :class:`~pystella_tpu_torch.FiniteDifferencer`, computing derivatives
by FFT, a multiply by ``i k`` (Nyquist modes zeroed for odd derivatives)
or ``-k**2``, and the inverse FFT (normalized, so no ``1/grid_size``
factor). A :class:`~pystella_tpu_torch.parallel.ShardedArray` is gathered
to the transform's device and its result sharded back, the single-device
result bit for bit.
"""

from __future__ import annotations

import torch

__all__ = ["SpectralCollocator"]


class SpectralCollocator:
    """Spectral derivatives of lattice fields (functional: returns new
    arrays).

    :arg fft: a :class:`~pystella_tpu_torch.fourier.DFT`.
    :arg dk: momentum-space grid spacing per axis.
    """

    def __init__(self, fft, dk, **kwargs):
        self.fft = fft
        self.decomp = fft.decomp
        rdtype = fft.rdtype
        self._k1 = []  # first-derivative momenta (zero & Nyquist zeroed)
        self._k2 = []  # second-derivative momenta
        for mu, kk in enumerate(fft.sub_k.values()):
            kk_int = kk.astype(int)
            k2 = (dk[mu] * kk.astype(rdtype))
            k1 = k2.copy()
            k1[abs(kk_int) == fft.grid_shape[mu] // 2] = 0.0
            k1[kk_int == 0] = 0.0
            self._k1.append(fft.k_axis_array(mu, k1))
            self._k2.append(fft.k_axis_array(mu, k2))

    def _lap_impl(self, fx):
        fk = self.fft._dft_impl(fx)
        ksq = sum(k * k for k in self._k2)
        return self.fft._idft_impl(-ksq * fk).to(fx.dtype)

    def _pd_impl(self, fx, mu):
        fk = self.fft._dft_impl(fx)
        return self.fft._idft_impl(1j * self._k1[mu] * fk).to(fx.dtype)

    def _grad_impl(self, fx):
        fk = self.fft._dft_impl(fx)
        la = fx.ndim - 3
        return torch.stack(
            [self.fft._idft_impl(1j * self._k1[mu] * fk).to(fx.dtype)
             for mu in range(3)], dim=la)

    def _grad_lap_impl(self, fx):
        fk = self.fft._dft_impl(fx)
        la = fx.ndim - 3
        grd = torch.stack(
            [self.fft._idft_impl(1j * self._k1[mu] * fk).to(fx.dtype)
             for mu in range(3)], dim=la)
        ksq = sum(k * k for k in self._k2)
        lap = self.fft._idft_impl(-ksq * fk).to(fx.dtype)
        return grd, lap

    def _div_impl(self, vec):
        # the i k_mu-weighted spectra summed in k-space: one inverse FFT
        fk = self.fft._dft_impl(vec)
        la = fk.ndim - 4
        div_k = sum(1j * self._k1[mu] * torch.select(fk, la, mu)
                    for mu in range(3))
        return self.fft._idft_impl(div_k).to(vec.dtype)

    # -- public interface (mirrors FiniteDifferencer) ----------------------

    def lap(self, f):
        return self.fft.on_whole(self._lap_impl, f)

    def grad(self, f):
        return self.fft.on_whole(self._grad_impl, f)

    def grad_lap(self, f):
        return self.fft.on_whole(self._grad_lap_impl, f)

    def pdx(self, f):
        return self.fft.on_whole(lambda x: self._pd_impl(x, 0), f)

    def pdy(self, f):
        return self.fft.on_whole(lambda x: self._pd_impl(x, 1), f)

    def pdz(self, f):
        return self.fft.on_whole(lambda x: self._pd_impl(x, 2), f)

    def divergence(self, vec):
        return self.fft.on_whole(self._div_impl, vec)

    def __call__(self, fx, *, lap=False, grd=False, div=False):
        out = {}
        if lap and grd:
            g, lp = self.grad_lap(fx)
            out["grd"], out["lap"] = g, lp
        elif lap:
            out["lap"] = self.lap(fx)
        elif grd:
            out["grd"] = self.grad(fx)
        if div:
            out["div"] = self.divergence(fx)
        return out
