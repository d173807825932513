"""FFTs of lattice arrays, on one device.

PyTorch counterpart of ``pystella_tpu/fourier/dft.py``, on ``torch.fft``
(cuFFT on the card): ``rfftn`` / ``irfftn`` for real dtypes, ``fftn`` /
``ifftn`` for complex ones, over the last three axes, every leading axis
batched. The JAX package computes them in XLA too (``jnp.fft``), outside
any Pallas kernel, so there is no kernel of the port's own here.

Conventions are the JAX package's: the forward transform unnormalized, the
backward normalized (``idft(dft(x)) == x``); mode numbers from
:func:`fftfreq` with a positive Nyquist; the r2c half-spectrum z axis
last.

On a :class:`~pystella_tpu_torch.parallel.ShardedArray` the transform
gathers the lattice to the first block's device
(:meth:`DomainDecomposition.unshard`), transforms it there, and shards
k-space back along x and y with the (half-spectrum) z axis whole, as the
JAX package's ``k_sharding`` lays it out. That gather is the port's only
distributed tier: the JAX package's ``pencil`` and ``partial`` tiers (no
gather at any size) wait for ROADMAP queue 1 item 5, and a mesh that
shards z raises. Every sharded result is the single-device one, bit for
bit.
"""

from __future__ import annotations

import numpy as np
import torch

from pystella_tpu_torch._device import resolve_device, torch_dtype
from pystella_tpu_torch.parallel.decomp import ShardedArray

__all__ = ["DFT", "fftfreq", "pfftfreq", "make_hermitian",
           "get_sliced_momenta", "get_real_dtype_with_matching_prec",
           "get_complex_dtype_with_matching_prec"]


def get_real_dtype_with_matching_prec(dtype):
    dtype = np.dtype(dtype)
    return np.dtype({8: np.float32, 16: np.float64}[dtype.itemsize] if
                    dtype.kind == "c" else dtype)


def get_complex_dtype_with_matching_prec(dtype):
    dtype = np.dtype(dtype)
    if dtype.kind == "c":
        return dtype
    return np.dtype({4: np.complex64, 8: np.complex128}[dtype.itemsize])


def fftfreq(n):
    """Integer FFT mode numbers with positive Nyquist."""
    freq = np.fft.fftfreq(n, 1 / n)
    if n % 2 == 0:
        freq[n // 2] = np.abs(freq[n // 2])
    return freq


pfftfreq = fftfreq


def get_sliced_momenta(grid_shape, dtype, local_slice=None):
    """Per-axis FFT mode numbers (the whole axes with one controller; pass
    ``local_slice``, a tuple of slices, to subset)."""
    rdtype = get_real_dtype_with_matching_prec(dtype)
    k = [fftfreq(n).astype(rdtype) for n in grid_shape]
    if np.dtype(dtype).kind == "f":
        n = grid_shape[-1]
        k[-1] = np.fft.rfftfreq(n, 1 / n).astype(rdtype)
    if local_slice is not None:
        k = [ki[sl] for ki, sl in zip(k, local_slice)]
    return k


def _self_conjugate_and_negative(n):
    """Partition axis indices under mode negation ``i -> (-i) % n``: the
    fixed points (``0`` and, for even ``n``, the Nyquist index) and the
    strictly-negative-mode half ``i > n//2``."""
    i = np.arange(n)
    fixed = (i == 0) | ((n % 2 == 0) & (i == n // 2))
    negative = i > n // 2
    return fixed, negative


def make_hermitian(fk):
    """Impose on the r2c-layout array ``fk`` (``(..., Nx, Ny, Nz//2+1)``,
    numpy or a tensor) the Hermitian symmetry a real field's modes
    satisfy: on the ``kz = 0`` and ``kz = Nyquist`` planes ``fk[-i, -j] =
    conj(fk[i, j])``, and the self-conjugate corner modes are real. Each
    mode in the negative half-plane (``ky`` negative, or ``ky``
    self-conjugate and ``kx`` negative) is overwritten by the conjugate of
    its mirror, a flip-then-roll in (x, y)."""
    on_host = isinstance(fk, np.ndarray)
    arr = torch.from_numpy(np.asarray(fk)) if on_host else fk
    nx, ny, nzh = arr.shape[-3:]
    nz = 2 * (nzh - 1)

    mirror = torch.roll(torch.flip(arr, dims=(-3, -2)), (1, 1), dims=(-3, -2))

    fix_x, neg_x = _self_conjugate_and_negative(nx)
    fix_y, neg_y = _self_conjugate_and_negative(ny)
    replace_xy = neg_y[None, :] | (fix_y[None, :] & neg_x[:, None])
    corner_xy = fix_x[:, None] & fix_y[None, :]
    kz_fixed = np.zeros(nzh, bool)
    kz_fixed[0] = True
    if nz:
        kz_fixed[nz // 2] = True

    replace = torch.from_numpy(replace_xy[:, :, None] & kz_fixed).to(
        arr.device)
    corner = torch.from_numpy(corner_xy[:, :, None] & kz_fixed).to(
        arr.device)
    out = torch.where(replace, torch.conj(mirror), arr)
    out = torch.where(corner, torch.real(out).to(out.dtype), out)
    return out.numpy() if on_host else out


class DFT:
    """Forward/backward 3-D (r2c or c2c) FFTs of lattice arrays.

    :arg decomp: a :class:`~pystella_tpu_torch.DomainDecomposition` (or
        ``None``: one device). With one, :class:`ShardedArray` s are
        transformed through a gather to its first device (see the module
        docstring); its mesh must not shard z.
    :arg grid_shape: position-space shape.
    :arg dtype: position-space dtype; a real dtype selects r2c transforms.
    :arg device: the device without a ``decomp`` (``None``: the GPU).

    ``dft`` / ``idft`` return new arrays (tensors, or :class:`ShardedArray` s
    for sharded operands).
    """

    #: the fully distributed pencil tier is not ported
    is_pencil = False

    def __init__(self, decomp=None, context=None, queue=None,
                 grid_shape=None, dtype=np.float64, device=None, **kwargs):
        if grid_shape is None:
            raise ValueError("grid_shape is required")
        self.decomp = decomp
        self.grid_shape = tuple(int(n) for n in grid_shape)
        self.dtype = np.dtype(dtype)
        self.is_real = self.dtype.kind == "f"
        self.rdtype = get_real_dtype_with_matching_prec(self.dtype)
        self.cdtype = get_complex_dtype_with_matching_prec(self.dtype)
        kwargs.pop("replicate_limit", None)
        kwargs.pop("allow_replicate", None)
        if kwargs:
            import warnings
            warnings.warn(f"DFT: unrecognized keyword arguments ignored: "
                          f"{sorted(kwargs)}", stacklevel=2)
        if decomp is not None:
            if decomp.proc_shape[2] > 1:
                raise NotImplementedError(
                    "DFT on a mesh that shards z: the port's transform "
                    "gathers to one device and shards k-space along x and "
                    "y only; the distributed tiers wait for ROADMAP queue "
                    "1 item 5")
            self.device = decomp.devices[0]
        else:
            self.device = resolve_device(device)
        self._nproc = 1 if decomp is None else decomp.nshards

        k = get_sliced_momenta(self.grid_shape, self.dtype)
        #: mode-number arrays (host, whole axes), keyed like the
        #: reference's sub_k
        self.sub_k = {name: ki for name, ki
                      in zip(("momenta_x", "momenta_y", "momenta_z"), k)}
        self.sub_k_device = [self.k_axis_array(mu, ki)
                             for mu, ki in enumerate(k)]

    def shape(self, forward_output=True):
        """Global array shape (k-space's with ``forward_output``)."""
        if forward_output and self.is_real:
            return self.grid_shape[:-1] + (self.grid_shape[-1] // 2 + 1,)
        return self.grid_shape

    @property
    def proc_permutation(self):
        """k-space axes are not permuted relative to position space."""
        return tuple(range(len(self.grid_shape)))

    @property
    def scheme(self):
        """The transform scheme: the single-device transform, or the gather
        to one device on a sharded mesh."""
        return "local" if self._nproc == 1 else "gather"

    def k_axis_array(self, mu, values):
        """Per-axis k-space constants (momenta, stencil eigenvalues) as a
        tensor on the transform's device shaped to broadcast against its
        k-space arrays along lattice axis ``mu``."""
        shape = [1, 1, 1]
        shape[mu] = -1
        return torch.as_tensor(np.asarray(values)).to(
            self.device).reshape(shape)

    # -- transforms on one device ---------------------------------------------

    def _dft_impl(self, fx):
        if self.is_real:
            return torch.fft.rfftn(fx, dim=(-3, -2, -1))
        return torch.fft.fftn(fx, dim=(-3, -2, -1))

    def _idft_impl(self, fk):
        if self.is_real:
            return torch.fft.irfftn(fk, s=self.grid_shape, dim=(-3, -2, -1))
        return torch.fft.ifftn(fk, dim=(-3, -2, -1))

    # -- layout ---------------------------------------------------------------

    def gathered(self, x):
        """``x`` whole on the transform's device: a :class:`ShardedArray`
        gathered, a numpy array copied, a tensor as it is."""
        if isinstance(x, ShardedArray):
            return x.decomp.unshard(x, self.device)
        if not isinstance(x, torch.Tensor):
            return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)
        return x

    def sharded(self, x, like):
        """``x`` (a whole array on the transform's device) laid out as
        ``like``: cut into the blocks of ``like``'s decomposition (k-space
        along x and y, z whole) when ``like`` is a :class:`ShardedArray`,
        else as it is."""
        if isinstance(like, ShardedArray):
            return like.decomp.shard(x)
        return x

    def on_whole(self, impl, *arrays):
        """``impl`` on ``arrays`` gathered whole to the transform's device
        (:meth:`gathered`); its output (or each of a tuple's) laid out as
        the first :class:`ShardedArray` operand (:meth:`sharded`): how the
        k-space consumers (projections, spectral derivatives, Poisson, FFT
        stencils) take sharded operands."""
        like = next((a for a in arrays if isinstance(a, ShardedArray)), None)
        out = impl(*(self.gathered(a) for a in arrays))
        if isinstance(out, tuple):
            return tuple(self.sharded(o, like) for o in out)
        return self.sharded(out, like)

    def shard_k(self, array, outer_axes=None):
        """A host or whole k-space array in the k-home layout: sharded
        along x and y on a multi-block decomposition, else a tensor on the
        transform's device."""
        t = self.gathered(array)
        if self.decomp is not None and self._nproc > 1:
            return self.decomp.shard(t)
        return t

    def dft(self, fx=None, fk=None, **kwargs):
        """Forward transform; returns the momentum-space array (the ``fk``
        out-argument of the reference API is accepted and ignored). A numpy
        operand is first placed as the decomposition places lattice
        arrays."""
        if isinstance(fx, np.ndarray):
            fx = self._place(np.asarray(fx, self.dtype))
        return self.sharded(self._dft_impl(self.gathered(fx)), fx)

    def idft(self, fk=None, fx=None, **kwargs):
        """Backward (normalized) transform; returns the position-space
        array, real for r2c transforms, in ``dtype``."""
        if isinstance(fk, np.ndarray):
            fk = self.shard_k(np.asarray(fk, self.cdtype))
        out = self._idft_impl(self.gathered(fk))
        if self.is_real:
            out = out.to(torch_dtype(self.dtype))
        return self.sharded(out, fk)

    def _place(self, array):
        if self.decomp is not None and self._nproc > 1:
            return self.decomp.shard(array)
        return torch.from_numpy(np.ascontiguousarray(array)).to(self.device)

    def zero_corner_modes(self, array, only_imag=False):
        """Zero the eight corner modes (each wavenumber component 0 or
        Nyquist), or just their imaginary parts; returns a new array (numpy
        in, numpy out)."""
        corners = []
        for mu, name in enumerate(self.sub_k):
            kk = self.sub_k[name].astype(int)
            corners.append(np.flatnonzero(
                (np.abs(kk) == 0)
                | (np.abs(kk) == self.grid_shape[mu] // 2)))
        idx = (Ellipsis,) + np.ix_(*corners)

        if isinstance(array, np.ndarray):
            arr = np.array(array)
            if only_imag:
                arr[idx] = arr[idx].real.astype(arr.dtype)
            else:
                arr[idx] = 0
            return arr
        whole = self.gathered(array).clone()
        tidx = (Ellipsis,) + tuple(torch.as_tensor(i, device=whole.device)
                                   for i in np.ix_(*corners))
        if only_imag:
            whole[tidx] = torch.real(whole[tidx]).to(whole.dtype)
        else:
            whole[tidx] = 0
        return self.sharded(whole, array)
