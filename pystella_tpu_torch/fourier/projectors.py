"""k-space projections: transverse/longitudinal/polarization decompositions
of vectors and the transverse-traceless projection of rank-2 tensors.

PyTorch counterpart of ``pystella_tpu/fourier/projectors.py``: each
projection is a sequence of elementwise torch operations over the
k-space arrays, in the JAX package's operation order, relative to
*stencil-effective* momenta (``effective_k(k, dx)`` with the zero and
Nyquist modes zeroed), so spectral identities hold exactly for fields
differentiated with the matching stencil. Methods return new arrays.

A :class:`~pystella_tpu_torch.parallel.ShardedArray` operand is gathered
to the transform's device, projected there and sharded back, as the
transform itself is (:class:`~pystella_tpu_torch.fourier.DFT`), so its
result is the single-device one bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from pystella_tpu_torch.models.sectors import tensor_index

__all__ = ["Projector", "tensor_index"]


def _stack(xs):
    return torch.stack(list(xs))


class Projector:
    """k-space projector (see the module docstring).

    :arg fft: a :class:`~pystella_tpu_torch.fourier.DFT`.
    :arg effective_k: callable ``(k, dx) -> k_eff`` or an integer ``h``
        selecting :class:`~pystella_tpu_torch.FirstCenteredDifference`
        ``(h)`` eigenvalues; ``0`` means continuum momenta.
    :arg dk: momentum-space grid spacing per axis.
    :arg dx: position-space grid spacing per axis.
    :arg scheme: transform-scheme override
        (:func:`~pystella_tpu_torch.fourier.plan.ensure_spectral_fft`):
        ``"pencil"`` raises (not ported).
    """

    def __init__(self, fft, effective_k, dk, dx, scheme=None):
        from pystella_tpu_torch.fourier.plan import ensure_spectral_fft
        fft = ensure_spectral_fft(fft, scheme)
        self.fft = fft

        if not callable(effective_k):
            if effective_k != 0:
                from pystella_tpu_torch.ops.derivs import (
                    FirstCenteredDifference)
                effective_k = FirstCenteredDifference(
                    int(effective_k)).get_eigenvalues
            else:
                def effective_k(k, dx):  # noqa: ARG001
                    return k

        rdtype = fft.rdtype
        self.eff_mom = {}
        self._eff_dev = []
        for mu, (name, kk) in enumerate(zip(
                ("eff_mom_x", "eff_mom_y", "eff_mom_z"),
                fft.sub_k.values())):
            kk_int = kk.astype(int)
            eff = np.asarray(
                effective_k(dk[mu] * kk.astype(rdtype), dx[mu]), rdtype)
            eff[np.abs(kk_int) == fft.grid_shape[mu] // 2] = 0.0
            eff[kk_int == 0] = 0.0
            self.eff_mom[name] = eff
            self._eff_dev.append(fft.k_axis_array(mu, eff))

    # -- shared geometry ---------------------------------------------------

    def _geometry(self):
        kx, ky, kz = self._eff_dev
        ksq = kx * kx + ky * ky + kz * kz
        kvec_zero = ksq < 1e-28
        ksq_safe = torch.where(kvec_zero, 1.0, ksq)
        kmag = torch.sqrt(ksq_safe)
        return (kx, ky, kz), kvec_zero, ksq_safe, kmag

    def _eps(self):
        """Transverse polarization vector: for kx = ky = 0 use
        ``(1, i, 0)/sqrt(2)`` if kz != 0, else 0."""
        (kx, ky, kz), kvec_zero, ksq_safe, kmag = self._geometry()
        kap_sq = kx * kx + ky * ky
        kx_ky_zero = kap_sq < 1e-20
        kz_nonzero = torch.abs(kz) > 1e-10
        kappa_safe = torch.sqrt(torch.where(kx_ky_zero, 1.0, kap_sq))
        rt2 = np.sqrt(2.0)

        # (the constant branches in the momenta's precision: torch.where of
        # two Python numbers gives the default dtype)
        one, zero = kz.new_tensor(1 / rt2), kz.new_tensor(0.0)
        eps0 = torch.where(
            kx_ky_zero,
            torch.where(kz_nonzero, one, zero) + 0j,
            (kx * kz / kmag - 1j * ky) / kappa_safe / rt2)
        eps1 = torch.where(
            kx_ky_zero,
            torch.where(kz_nonzero, one * 1j, zero + 0j),
            (ky * kz / kmag + 1j * kx) / kappa_safe / rt2)
        eps2 = torch.where(kx_ky_zero, 0.0 + 0j,
                           (-kappa_safe / kmag / rt2) + 0j)
        return (eps0, eps1, eps2), kvec_zero, ksq_safe, kmag

    # -- implementations ---------------------------------------------------

    def _transversify_impl(self, vector):
        (kx, ky, kz), kvec_zero, ksq_safe, _ = self._geometry()
        kvec = (kx, ky, kz)
        div = sum(kvec[mu] * vector[mu] for mu in range(3))
        return _stack(
            torch.where(kvec_zero, 0.0,
                        vector[mu] - kvec[mu] / ksq_safe * div)
            for mu in range(3))

    def _vec_to_pol_impl(self, vector):
        eps, *_ = self._eps()
        plus = sum(vector[mu] * torch.conj(eps[mu]) for mu in range(3))
        minus = sum(vector[mu] * eps[mu] for mu in range(3))
        return plus, minus

    def _pol_to_vec_impl(self, plus, minus):
        eps, *_ = self._eps()
        return _stack(plus * eps[mu] + minus * torch.conj(eps[mu])
                      for mu in range(3))

    def _decompose_vector_impl(self, vector, times_abs_k):
        eps, kvec_zero, ksq_safe, kmag = self._eps()
        (kx, ky, kz), *_ = self._geometry()
        kvec = (kx, ky, kz)
        plus = sum(vector[mu] * torch.conj(eps[mu]) for mu in range(3))
        minus = sum(vector[mu] * eps[mu] for mu in range(3))
        div = sum(kvec[mu] * vector[mu] for mu in range(3))
        denom = kmag if times_abs_k else ksq_safe
        lng = torch.where(kvec_zero, 0.0, -1j * div / denom)
        return plus, minus, lng

    def _decomp_to_vec_impl(self, plus, minus, lng, times_abs_k):
        eps, kvec_zero, ksq_safe, kmag = self._eps()
        (kx, ky, kz), *_ = self._geometry()
        kvec = (kx, ky, kz)
        out = []
        for mu in range(3):
            v = plus * eps[mu] + minus * torch.conj(eps[mu])
            scale = kvec[mu] if times_abs_k else kvec[mu] / kmag
            v = v + torch.where(kvec_zero, 0.0, 1j * scale * lng)
            out.append(v)
        return _stack(out)

    def _tt_impl(self, hij):
        (kx, ky, kz), kvec_zero, ksq_safe, kmag = self._geometry()
        khat = tuple(k / kmag for k in (kx, ky, kz))

        def tid(a, b):
            return tensor_index(a, b)

        P = {}
        for a in range(1, 4):
            for b in range(a, 4):
                delta = 1.0 if a == b else 0.0
                P[tid(a, b)] = delta - khat[a - 1] * khat[b - 1]

        def P_(a, b):
            return P[tid(a, b)]

        out = []
        for a in range(1, 4):
            for b in range(a, 4):
                acc = 0.0
                for c in range(1, 4):
                    for d in range(1, 4):
                        acc = acc + ((P_(a, c) * P_(d, b)
                                      - P_(a, b) * P_(c, d) / 2)
                                     * hij[tid(c, d)])
                out.append(torch.where(kvec_zero, 0.0, acc))
        return _stack(out)

    def _tensor_to_pol_impl(self, hij):
        eps, *_ = self._eps()
        plus = sum(hij[tensor_index(c, d)] * torch.conj(eps[c - 1])
                   * torch.conj(eps[d - 1])
                   for c in range(1, 4) for d in range(1, 4))
        minus = sum(hij[tensor_index(c, d)] * eps[c - 1] * eps[d - 1]
                    for c in range(1, 4) for d in range(1, 4))
        return plus, minus

    def _pol_to_tensor_impl(self, plus, minus):
        eps, *_ = self._eps()
        return _stack(
            plus * eps[a - 1] * eps[b - 1]
            + minus * torch.conj(eps[a - 1]) * torch.conj(eps[b - 1])
            for a in range(1, 4) for b in range(a, 4))

    # -- public API --------------------------------------------------------

    def transversify(self, vector, vector_T=None, queue=None):
        """Project out the longitudinal component: returns
        ``v - k (k.v)/k**2`` (zero where k = 0)."""
        return self.fft.on_whole(self._transversify_impl, vector)

    def vec_to_pol(self, vector, queue=None):
        """Project a vector onto the (plus, minus) polarization basis;
        returns ``(plus, minus)``."""
        return self.fft.on_whole(self._vec_to_pol_impl, vector)

    def pol_to_vec(self, plus, minus, queue=None):
        """Build the vector field from its (plus, minus) polarizations;
        returns the ``(3,) + kshape`` array."""
        return self.fft.on_whole(self._pol_to_vec_impl, plus, minus)

    def decompose_vector(self, vector, *, times_abs_k=False, queue=None):
        """Full decomposition; returns ``(plus, minus, lng)`` where the
        longitudinal mode is ``-i k.v / |k|**2`` (or ``-i k.v / |k|`` with
        ``times_abs_k``)."""
        return self.fft.on_whole(
            lambda v: self._decompose_vector_impl(v, times_abs_k), vector)

    def decomp_to_vec(self, plus, minus, lng, *, times_abs_k=False,
                      queue=None):
        """Inverse of :meth:`decompose_vector`."""
        return self.fft.on_whole(
            lambda p, m, lo: self._decomp_to_vec_impl(p, m, lo, times_abs_k),
            plus, minus, lng)

    def transverse_traceless(self, hij, hij_TT=None, queue=None):
        """Transverse-traceless projection of a packed symmetric tensor
        ``(6,) + kshape``: ``(P_ac P_db - P_ab P_cd / 2) h_cd``."""
        return self.fft.on_whole(self._tt_impl, hij)

    def tensor_to_pol(self, hij, queue=None):
        """Project a tensor onto polarizations; returns ``(plus, minus)``."""
        return self.fft.on_whole(self._tensor_to_pol_impl, hij)

    def pol_to_tensor(self, plus, minus, queue=None):
        """Build the packed tensor from its polarizations."""
        return self.fft.on_whole(self._pol_to_tensor_impl, plus, minus)
