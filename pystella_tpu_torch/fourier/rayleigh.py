"""Gaussian random field initialization in k-space.

PyTorch counterpart of ``pystella_tpu/fourier/rayleigh.py``: modes with
Rayleigh-distributed amplitudes and uniform phases for a chosen power
spectrum, Hermitian by construction. As there, white Gaussian noise is
drawn on the position-space lattice and forward-transformed: the DFT of
real white noise is the Rayleigh-amplitude / uniform-phase ensemble with
the Hermitian constraint exact, so scaling its modes by ``sqrt(P(k))``
realizes the target spectrum with no fix-up pass; ``random=False`` keeps
only the modes' phases.

Randomness comes from an explicit ``torch.Generator`` seeded from ``seed``
on the transform's device; its numbers are not ``jax.random``'s. The draw
is the one small method :meth:`RayleighGenerator._white_noise`, so a test
can hand both packages the same noise. On a sharded decomposition the
modes are made whole on the transform's device and the results sharded
(:class:`~pystella_tpu_torch.fourier.DFT`'s gather tier).
"""

from __future__ import annotations

import numpy as np
import torch

from pystella_tpu_torch._device import torch_dtype

__all__ = ["RayleighGenerator"]


class RayleighGenerator:
    """Generate Gaussian-random fields with a chosen power spectrum.

    :arg context: unused (API parity with the reference's pyopencl context).
    :arg fft: a :class:`~pystella_tpu_torch.fourier.DFT`.
    :arg dk: momentum-space grid spacing per axis.
    :arg volume: physical grid volume.
    :arg seed: RNG seed (default 13298, like the reference).

    The spectrum, window and dispersion callables receive tensors.
    """

    def __init__(self, context=None, fft=None, dk=None, volume=None,
                 seed=13298):
        if fft is None:
            raise ValueError("fft is required")
        self.fft = fft
        self.decomp = fft.decomp
        self.dtype = fft.dtype
        self.rdtype = fft.rdtype
        self.cdtype = fft.cdtype
        self.volume = volume
        self.dk = tuple(float(d) for d in
                        ((dk,) * 3 if np.isscalar(dk) else dk))
        # modes in the unnormalized-forward-FFT convention (the one
        # PowerSpectra assumes), so the normalized fft.idft yields the
        # physical field
        self.grid_size = float(np.prod(fft.grid_shape))
        self.device = fft.device
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(int(seed))

    @property
    def kmags(self):
        """Host wavenumber magnitudes over the k-grid."""
        sub_k = list(self.fft.sub_k.values())
        kvecs = np.meshgrid(*sub_k, indexing="ij", sparse=True)
        return np.sqrt(sum((dki * ki)**2
                           for dki, ki in zip(self.dk, kvecs)))

    def _rt(self, value):
        return torch.as_tensor(value, dtype=torch_dtype(self.rdtype),
                               device=self.device)

    def _kmag_device(self):
        """Wavenumber magnitudes over the k-grid, on the device."""
        return torch.sqrt(sum(
            (self._rt(dki) * ki.to(torch_dtype(self.rdtype)))**2
            for dki, ki in zip(self.dk, self.fft.sub_k_device)))

    def _protect_zero_mode(self, kmag):
        """The ``k = 0`` mask, and ``kmag`` with that entry replaced by its
        kz-neighbour's magnitude (a host scalar); callers zero the mode's
        power after evaluating the spectrum."""
        k_ax = list(self.fft.sub_k.values())
        neighbor = np.sqrt(sum(
            (dki * ki[idx])**2
            for dki, ki, idx in zip(self.dk, k_ax, (0, 0, 1))))
        zero = kmag == 0
        return zero, torch.where(zero, self._rt(neighbor), kmag)

    def _white_noise(self):
        """One draw of unit white noise on the position-space lattice
        (complex for a complex ``dtype``), a whole tensor on the
        transform's device."""
        shape = self.fft.grid_shape
        rdt = torch_dtype(self.rdtype)
        if self.fft.is_real:
            return torch.randn(shape, generator=self.generator, dtype=rdt,
                               device=self.device)
        u = torch.randn((2,) + shape, generator=self.generator, dtype=rdt,
                        device=self.device)
        return (u[0] + 1j * u[1]) / np.sqrt(2.0).astype(self.rdtype)

    def _noise_modes(self):
        """Fourier modes of a unit white-noise lattice: complex Gaussian
        with ``E|n_k|**2 = grid_size``, uniform phases, and (for a real
        ``dtype``) exact Hermitian symmetry."""
        return self.fft._dft_impl(self._white_noise())

    def _scale(self, nk, root, random):
        """Scale noise modes by ``root = sqrt(P)``: Rayleigh amplitudes
        for ``random=True``, exact amplitudes (phase only) otherwise."""
        cdt = torch_dtype(self.cdtype)
        if random:
            return (nk * (root / np.sqrt(self.grid_size))).to(cdt)
        mag = torch.abs(nk)
        one = torch.ones((), dtype=nk.dtype, device=nk.device)
        phase = torch.where(mag > 0, nk / torch.where(mag > 0, mag, 1),
                            one)
        return (phase * root).to(cdt)

    def _power_root(self, kmag, ps_arg, field_ps, norm, window):
        amplitude_sq = norm / self.volume * self.grid_size**2
        zero = ps_arg[0]
        f_power = (amplitude_sq * window(kmag)**2
                   * torch.where(zero, self._rt(0),
                                 torch.as_tensor(field_ps(ps_arg[1])).to(
                                     torch_dtype(self.rdtype))))
        return torch.sqrt(torch.as_tensor(f_power).to(
            torch_dtype(self.rdtype)))

    def generate(self, queue=None, random=True,
                 field_ps=lambda kmag: 1 / 2 / kmag,
                 norm=1, window=lambda kmag: 1.0):
        """Fourier modes with power spectrum ``field_ps`` and random phases:
        a k-space array (sharded on a sharded decomposition; pass it
        through ``fft.idft`` / :meth:`init_field` for the field)."""
        kmag = self._kmag_device()
        zero, kmag_safe = self._protect_zero_mode(kmag)
        root = self._power_root(kmag, (zero, kmag_safe), field_ps, norm,
                                window)
        return self.fft.shard_k(self._scale(self._noise_modes(), root,
                                            random))

    def init_field(self, fx=None, queue=None, **kwargs):
        """A position-space field with :meth:`generate`'s modes."""
        return self.fft.idft(self.generate(**kwargs))

    def init_transverse_vector(self, projector, vector=None, queue=None,
                               **kwargs):
        """A transverse 3-vector field (the same power spectrum per
        component); returns the ``(3,) + grid_shape`` array."""
        vector_k = torch.stack([self.fft.gathered(self.generate(**kwargs))
                                for _ in range(3)])
        vector_k = projector.transversify(vector_k)
        return self.fft.idft(self.fft.shard_k(vector_k))

    def init_vector_from_pol(self, projector, vector=None, plus_ps=None,
                             minus_ps=None, queue=None, **kwargs):
        """A transverse vector from polarization spectra."""
        if plus_ps is None or minus_ps is None:
            raise ValueError("plus_ps and minus_ps are required")
        plus_k = self.fft.gathered(self.generate(field_ps=plus_ps, **kwargs))
        minus_k = self.fft.gathered(self.generate(field_ps=minus_ps,
                                                  **kwargs))
        vector_k = projector.pol_to_vec(plus_k, minus_k)
        return self.fft.idft(self.fft.shard_k(vector_k))

    def generate_WKB(self, queue=None, random=True,
                     field_ps=lambda wk: 1 / 2 / wk,
                     norm=1, omega_k=lambda kmag: kmag,
                     hubble=0.0, window=lambda kmag: 1.0):
        """Modes for a field and its conformal-time derivative in the WKB
        approximation: left/right-moving modes with dispersion ``omega_k``
        and Hubble drag, in the manifestly Hermitian form of the JAX
        package (``fk`` from one noise transform, ``dfk = omega * (a
        second one) - hubble * fk``, both scaled by ``sqrt(P)``).

        :returns: ``(fk, dfk)`` k-space arrays (sharded on a sharded
            decomposition).
        """
        kmag = self._kmag_device()
        zero, kmag_safe = self._protect_zero_mode(kmag)
        wk = torch.as_tensor(omega_k(kmag_safe)).to(torch_dtype(self.rdtype))
        root = self._power_root(kmag, (zero, wk), field_ps, norm, window)

        fk = self._scale(self._noise_modes(), root, random)
        dfree = self._scale(self._noise_modes(), root, random)
        dfk = (wk * dfree - self._rt(hubble) * fk).to(
            torch_dtype(self.cdtype))
        return self.fft.shard_k(fk), self.fft.shard_k(dfk)

    def init_WKB_fields(self, fx=None, dfx=None, queue=None, **kwargs):
        """A field and its time derivative from WKB modes; returns ``(fx,
        dfx)``."""
        fk, dfk = self.generate_WKB(**kwargs)
        return self.fft.idft(fk), self.fft.idft(dfk)
