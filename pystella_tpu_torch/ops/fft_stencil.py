"""FFT-applied stencils: large-radius or repeated stencil application as
one k-space multiply through the transform.

PyTorch counterpart of ``pystella_tpu/ops/fft_stencil.py``. A periodic
linear stencil is a circular convolution, so ``n`` applications of a
radius-``r`` stencil cost one forward/inverse transform pair plus a
multiply by the stencil's symbol raised to the ``n``-th power. The
crossover against the direct tier is the JAX package's flops model:
direct ``repeats * taps(r) * 2 * N`` flops (``taps = 6 r + 1``) against
``2 * 5 N log2 N`` for the transform pair, with the env-tunable safety
ratio ``PYSTELLA_FFT_STENCIL_CROSSOVER``; ``PYSTELLA_FFT_STENCIL=1/0``
forces either path.

Symbols are stencil-consistent eigenvalues, so :func:`fft_laplacian`
applied once is the order-``2h`` finite-difference Laplacian of
:class:`~pystella_tpu_torch.FiniteDifferencer` up to transform roundoff.
The JAX module's ``obs.memory`` instrumentation of its jitted applies is
left out: the port's ``obs`` waits for ROADMAP queue 1 item 7, and no
``obs`` call is stubbed.
"""

from __future__ import annotations

import math

import numpy as np

__all__ = ["FFTStencil", "fft_laplacian", "stencil_flops",
           "transform_flops", "use_fft_stencil"]


def stencil_flops(grid_shape, radius, repeats=1, taps=None):
    """Direct-tier flops: ``repeats`` sweeps of a ``taps``-point stencil
    (default the axis-separable ``6r + 1``), one multiply-add per tap per
    site."""
    n = int(np.prod(grid_shape))
    if taps is None:
        taps = 6 * int(radius) + 1
    return int(repeats) * int(taps) * 2 * n


def transform_flops(grid_shape, pair=True):
    """FFT-tier flops by the ``5 N log2 N`` model; ``pair`` counts forward
    and inverse."""
    n = int(np.prod(grid_shape))
    return (2 if pair else 1) * int(5 * n * math.log2(max(n, 2)))


def use_fft_stencil(grid_shape, radius, repeats=1, taps=None,
                    override=None):
    """Should this application take the k-space path? Explicit
    ``override`` > ``PYSTELLA_FFT_STENCIL`` (1/0) > the flops crossover
    model."""
    if override is not None:
        return bool(override)
    from pystella_tpu_torch import config as _config
    setting = (_config.getenv("PYSTELLA_FFT_STENCIL") or "auto")
    setting = str(setting).strip().lower()
    if setting in ("1", "true", "on", "yes"):
        return True
    if setting in ("0", "false", "off", "no"):
        return False
    ratio = _config.get_float("PYSTELLA_FFT_STENCIL_CROSSOVER")
    return (stencil_flops(grid_shape, radius, repeats, taps)
            > ratio * transform_flops(grid_shape))


class FFTStencil:
    """Apply a periodic stencil as a k-space multiply through ``fft``.

    :arg fft: a :class:`~pystella_tpu_torch.fourier.DFT`.
    :arg symbol: the stencil's k-space symbol as a tensor broadcastable
        against the transform's k-space arrays (per-axis factors from
        ``fft.k_axis_array``), or a callable ``(kx, ky, kz) -> symbol``
        over those axis arrays.
    :arg radius: the equivalent direct-stencil radius (crossover
        accounting only).

    ``stencil(f, repeats=n)`` computes ``n`` applications in one transform
    pair; ``apply_if_profitable`` consults :func:`use_fft_stencil` and
    returns ``None`` when the direct tier should run instead. A
    :class:`ShardedArray` is gathered to the transform's device and the
    result sharded back.
    """

    def __init__(self, fft, symbol, radius=1, name="fft_stencil"):
        self.fft = fft
        self.radius = int(radius)
        self.name = str(name)
        if callable(symbol):
            kx, ky, kz = (fft.k_axis_array(mu, kk)
                          for mu, kk in enumerate(fft.sub_k.values()))
            symbol = symbol(kx, ky, kz)
        self._symbol = symbol

    def _apply(self, x, repeats):
        fk = self.fft._dft_impl(x)
        fk = fk * (self._symbol if repeats == 1 else self._symbol ** repeats)
        out = self.fft._idft_impl(fk)
        return out.to(x.dtype) if self.fft.is_real else out

    def __call__(self, fx, repeats=1):
        """``repeats`` stencil applications through one transform pair."""
        return self.fft.on_whole(lambda x: self._apply(x, repeats), fx)

    def apply_if_profitable(self, fx, repeats=1, override=None):
        """The k-space result when the crossover model (or the override /
        env) selects this path, else ``None``."""
        if not use_fft_stencil(self.fft.grid_shape, self.radius,
                               repeats, override=override):
            return None
        return self(fx, repeats=repeats)


def fft_laplacian(fft, dx, halo_shape=2):
    """The order-``2h`` finite-difference Laplacian as an
    :class:`FFTStencil`: the per-axis ``SecondCenteredDifference``
    eigenvalues summed into the (negative semi-definite) symbol."""
    from pystella_tpu_torch.ops.derivs import SecondCenteredDifference
    h = int(halo_shape)
    eig = SecondCenteredDifference(h).get_eigenvalues
    if np.isscalar(dx):
        dx = (dx,) * 3
    grid = fft.grid_shape
    rdtype = fft.rdtype
    parts = []
    for mu, kk in enumerate(fft.sub_k.values()):
        dk = 2 * np.pi / (grid[mu] * dx[mu])
        vals = np.asarray(eig(dk * kk.astype(rdtype), dx[mu]), rdtype)
        parts.append(fft.k_axis_array(mu, vals))
    symbol = sum(parts)
    return FFTStencil(fft, symbol, radius=h, name="fft_laplacian")
