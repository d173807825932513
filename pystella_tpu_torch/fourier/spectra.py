"""Radially binned power spectra.

PyTorch counterpart of ``pystella_tpu/fourier/spectra.py``. The
conventions are the JAX package's: bin index ``round(|k| / bin_width)``,
the r2c double-count weighting (2 except on the ``kz in {0, Nyquist}``
planes), bin-count normalization, and the overall ``1/(2 pi**2 V) *
(d3x)**2`` normalization. ``bin_counts`` and the number of bins are
computed on the host with numpy, as there.

The weighting ``counts * |k|**p * |f(k)|**2`` and the binning are one
launch of K14 on a CUDA spectrum (``SpectraBins`` in
:mod:`~pystella_tpu_torch.ops.histogram`: |k|, the count weight and the
bin derived from each site's index, float64 sums over units, one finish
launch), and the plain weighting plus the plain binning elsewhere. Outer
axes (fields, tensor components) batch through one launch. A
:class:`~pystella_tpu_torch.parallel.ShardedArray` field is transformed
through the gather of :class:`~pystella_tpu_torch.fourier.DFT` and binned
block by block from its sharded k-space: the single-device spectrum, bit
for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from pystella_tpu_torch.fourier.projectors import tensor_index
from pystella_tpu_torch.ops.histogram import SpectraBins, fetch_partials

__all__ = ["PowerSpectra"]


class PowerSpectra:
    """Power spectra of scalar, vector, and tensor fields.

    :arg decomp: a :class:`~pystella_tpu_torch.DomainDecomposition` (or
        ``None``).
    :arg fft: a :class:`~pystella_tpu_torch.fourier.DFT`.
    :arg dk: momentum-space grid spacing per axis (taken as Python floats,
        so |k| is formed in the transform's real type, as numpy forms it
        from the JAX package's ``Lattice.dk``).
    :arg volume: physical grid volume.
    :arg bin_width: defaults to ``min(dk)``.
    :arg scheme: transform-scheme override
        (:func:`~pystella_tpu_torch.fourier.plan.ensure_spectral_fft`):
        ``"pencil"`` raises (not ported).
    """

    def __init__(self, decomp, fft, dk, volume, **kwargs):
        from pystella_tpu_torch.fourier.plan import ensure_spectral_fft
        fft = ensure_spectral_fft(fft, kwargs.pop("scheme", None))
        self.decomp = decomp
        self.fft = fft
        self.grid_shape = fft.grid_shape
        self.dtype = fft.dtype
        self.rdtype = fft.rdtype
        self.cdtype = fft.cdtype
        self.kshape = fft.shape(True)
        self.dk = tuple(float(d) for d in dk)
        self.bin_width = float(kwargs.pop("bin_width", min(self.dk)))

        d3x = volume / np.prod(self.grid_shape)
        self.norm = (1 / 2 / np.pi**2 / volume) * d3x**2

        # |k| over the k-grid, as the JAX package forms it (a sparse grid
        # broadcasts to the same values, site by site)
        sub_k = list(fft.sub_k.values())
        kvecs = np.meshgrid(*sub_k, indexing="ij", sparse=True)
        sq_axes = [(dki * ki)**2 for dki, ki in zip(self.dk, sub_k)]
        kmags = np.sqrt(sum((dki * ki)**2 for dki, ki in zip(self.dk, kvecs)))
        if fft.is_real:
            single = ((kvecs[2] == 0)
                      | (kvecs[2] == self.grid_shape[-1] // 2))
            counts = np.broadcast_to(
                np.where(single, 1.0, 2.0).astype(kmags.dtype), kmags.shape)
        else:
            counts = np.ones_like(kmags)

        max_k = np.max(kmags)
        self.num_bins = int(max_k / self.bin_width + 0.5) + 1
        bins = np.arange(-0.5, self.num_bins + 0.5) * self.bin_width
        self.bin_counts = np.histogram(kmags, weights=counts, bins=bins)[0]
        #: K14 and its plain version, from the three axis tables
        self.binner = SpectraBins(sq_axes, self.bin_width, self.grid_shape,
                                  fft.is_real, self.num_bins)

    def bin_power(self, fk, queue=None, k_power=3, allocator=None):
        """Unnormalized binned power spectrum of a momentum-space field,
        weighted by ``|k|**k_power``; outer axes batch through one binning
        launch. Returns a host array ``fk.shape[:-3] + (num_bins,)``."""
        if isinstance(fk, np.ndarray):
            fk = self.fft.shard_k(fk)
        hist = fetch_partials(self.binner(fk, k_power))
        return hist / self.bin_counts

    def __call__(self, fx, queue=None, k_power=3, allocator=None):
        """Power spectrum of a position-space field; outer axes are batched
        through the transform and one binning launch."""
        if isinstance(fx, np.ndarray):
            fx = self.fft._place(np.asarray(fx, self.fft.dtype))
        fk = self.fft.dft(fx)
        return self.norm * self.bin_power(fk, k_power=k_power)

    def _dft_whole(self, x):
        """The transform of ``x`` whole on the transform's device (the
        projections gather anyway)."""
        return self.fft._dft_impl(self.fft.gathered(x))

    def polarization(self, vector, projector, queue=None, k_power=3,
                     allocator=None):
        """Spectra of the plus/minus polarizations of a vector field;
        returns shape ``vector.shape[:-4] + (2, num_bins)``."""
        vec_k = torch.movedim(self._dft_whole(vector), -4, 0)
        plus, minus = projector.vec_to_pol(vec_k)
        pm = torch.stack([plus, minus], dim=-4)
        return self.norm * self.bin_power(pm, k_power=k_power)

    def vector_decomposition(self, vector, projector, queue=None, k_power=3,
                             allocator=None):
        """Spectra of the plus/minus polarizations and the longitudinal
        component; returns ``vector.shape[:-4] + (3, num_bins)``."""
        vec_k = torch.movedim(self._dft_whole(vector), -4, 0)
        plus, minus, lng = projector.decompose_vector(
            vec_k, times_abs_k=True)
        pml = torch.stack([plus, minus, lng], dim=-4)
        return self.norm * self.bin_power(pml, k_power=k_power)

    def gw(self, hij, projector, hubble, queue=None, k_power=3,
           allocator=None):
        """Spectral abundance of transverse-traceless gravitational waves
        from the (6,)-packed tensor ``hij``."""
        hij_tt = projector.transverse_traceless(self._dft_whole(hij))
        gw_spec = self.bin_power(hij_tt, k_power=k_power)
        gw_tot = sum(gw_spec[tensor_index(i, j)]
                     for i in range(1, 4) for j in range(1, 4))
        return self.norm / 12 / hubble**2 * gw_tot

    def gw_polarization(self, hij, projector, hubble, queue=None, k_power=3,
                        allocator=None):
        """GW spectral abundance decomposed onto circular polarizations;
        returns shape ``(2, num_bins)``."""
        plus, minus = projector.tensor_to_pol(self._dft_whole(hij))
        pm = torch.stack([plus, minus])
        return self.norm / 12 / hubble**2 * self.bin_power(
            pm, k_power=k_power)
