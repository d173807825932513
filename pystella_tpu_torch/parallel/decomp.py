"""Domain decomposition with a single controller.

PyTorch counterpart of ``pystella_tpu/parallel/decomp.py``. The JAX package
is single-controller: one process holds a mesh of devices and drives every
shard. The port keeps that design without ``jax.sharding``: a
:class:`DomainDecomposition` holds a grid of torch devices (``proc_shape``
ranks; a device may appear more than once, so several shards can share one
card, as the JAX suite's virtual CPU devices share one host), and a lattice
array is a :class:`ShardedArray`, one block per rank. The verbs map so:

========================  =====================================================
JAX verb                   here
========================  =====================================================
``shard`` / ``scatter``    slice the global array into blocks, copy each to its
                           rank's device
``pad_with_halos``         per block, copies of the neighbours' boundary rows
                           (periodic along every axis; a copy between devices
                           where the neighbour lives on another card)
``psum`` / ``allreduce``   per-block partials combined in rank order
``spec`` / ``sharding`` /  the per-block launch loop: an operator runs once per
``shard_map``              block, on that block's device
========================  =====================================================

The exchange and the overlap regions carry ``torch.profiler`` labels
(``halo_exchange``, ``halo_overlap``, ``halo_overlap_interior``,
``halo_overlap_shells``), the counterparts of the JAX ``named_scope``s. The
JAX package's ``obs`` counters count here too: ``halo_exchanges`` (the
per-axis exchanges of :meth:`~DomainDecomposition.share_halos`) and
``halo_bytes_exchanged`` (the bytes of one execution of each distinct halo
program, the first time it runs), with the same counts on the same calls;
:attr:`DomainDecomposition.bytes_exchanged` counts every execution.

The ensemble mesh is here too: :func:`make_mesh` and :func:`ensemble_mesh`
return a :class:`Mesh` (a numpy array of torch devices with axis names), and
a ``DomainDecomposition(mesh=..., ensemble_axis=...)`` describes one member's
lattice while :meth:`~DomainDecomposition.shard_members` places a batch of
members over the ensemble slices (:class:`MemberArray`). Multi-process runs
(``torch.distributed``) come later, and so does ``axis_array``, which serves
the pencil FFT (ROADMAP queue 1 item 5).
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
from torch.profiler import record_function

from pystella_tpu_torch._device import resolve_device, torch_dtype
from pystella_tpu_torch.parallel.overlap import MIN_INTERIOR_FACTOR

__all__ = ["DomainDecomposition", "HaloPlan", "HaloShells", "MemberArray",
           "Mesh", "NamedSharding", "ShardedArray", "blockwise",
           "ensemble_mesh", "make_mesh"]


class ShardedArray:
    """A lattice array held as one block per rank of a
    :class:`DomainDecomposition`: ``blocks`` in rank order (C order over
    ``proc_shape``), each ``(*outer, nx, ny, nz)`` on its rank's device.
    The global shape is the blocks' lattice extents times ``proc_shape``
    (for padded blocks, the padded blocks side by side, as the JAX
    ``share_halos`` returns them)."""

    def __init__(self, blocks, decomp):
        self.blocks = list(blocks)
        self.decomp = decomp
        if len(self.blocks) != decomp.nshards:
            raise ValueError(f"{len(self.blocks)} blocks for "
                             f"{decomp.nshards} ranks")

    @property
    def block_shape(self):
        return tuple(self.blocks[0].shape)

    @property
    def shape(self):
        b = self.block_shape
        return b[:-3] + tuple(p * n for p, n in
                              zip(self.decomp.proc_shape, b[-3:]))

    @property
    def ndim(self):
        return self.blocks[0].ndim

    @property
    def dtype(self):
        return self.blocks[0].dtype

    def map(self, fn):
        """A new array of ``fn(block)`` per block."""
        return ShardedArray([fn(b) for b in self.blocks], self.decomp)

    def _zip(self, other, fn):
        if not isinstance(other, ShardedArray) or other.decomp is not \
                self.decomp:
            raise TypeError("blockwise arithmetic takes two ShardedArrays "
                            "of one decomposition")
        return ShardedArray([fn(a, b) for a, b in
                             zip(self.blocks, other.blocks)], self.decomp)

    def __add__(self, other):
        """Blockwise sum (the JAX array's ``+``)."""
        return self._zip(other, torch.add)

    def __sub__(self, other):
        """Blockwise difference."""
        return self._zip(other, torch.sub)

    def __mul__(self, other):
        """Blockwise product with a number (the generic steppers' ``a * x``
        and ``x * 0``)."""
        return self.map(lambda b: b * other)

    __rmul__ = __mul__

    def __repr__(self):
        return (f"ShardedArray(shape={self.shape}, dtype={self.dtype}, "
                f"proc_shape={self.decomp.proc_shape})")


# a ShardedArray is a pytree node to ``torch.func``: ``vmap`` maps over the
# leading axis of its blocks, and the body sees ShardedArrays of the blocks'
# member slices (the ensemble tier's vmap over a spatial mesh)
torch.utils._pytree.register_pytree_node(
    ShardedArray, lambda a: (a.blocks, a.decomp),
    lambda blocks, decomp: ShardedArray(blocks, decomp))


class Mesh:
    """The port's device mesh: ``devices``, a numpy object array of
    :class:`torch.device` s, one axis per name of ``axis_names`` (the role
    of a ``jax.sharding.Mesh``; a device may repeat)."""

    def __init__(self, devices, axis_names):
        self.devices = devices
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"a mesh of shape {self.devices.shape} needs "
                             f"{self.devices.ndim} axis names, got "
                             f"{self.axis_names}")

    @property
    def shape(self):
        """``{axis name: extent}``, in axis order."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self):
        return int(self.devices.size)

    def __repr__(self):
        return f"Mesh({self.shape})"


def _device_array(devices, shape):
    arr = np.empty(len(devices), dtype=object)
    for i, d in enumerate(devices):
        arr[i] = d
    return arr.reshape(shape)


def _default_devices():
    """Every visible card (the default device set of a mesh); raises
    without one, as every entry point does."""
    resolve_device(None)
    return [torch.device("cuda", r)
            for r in range(torch.cuda.device_count())]


def make_mesh(proc_shape=None, axis_names=("x", "y", "z"), devices=None):
    """A :class:`Mesh` over the lattice axes: ``proc_shape`` devices per
    axis (default every device on the first axis), from ``devices``
    (default the visible cards; a device may repeat)."""
    devices = ([resolve_device(d) for d in devices] if devices is not None
               else _default_devices())
    if proc_shape is None:
        proc_shape = (len(devices),) + (1,) * (len(axis_names) - 1)
    proc_shape = tuple(int(p) for p in proc_shape)
    if int(np.prod(proc_shape)) != len(devices):
        raise ValueError(
            f"proc_shape {proc_shape} does not cover {len(devices)} devices")
    return Mesh(_device_array(devices, proc_shape),
                axis_names[:len(proc_shape)])


def ensemble_mesh(proc_shape=None, ensemble_devices=None,
                  axis_names=("x", "y", "z"), ensemble_axis=None,
                  devices=None):
    """An ``(ensemble, x, y, z)`` :class:`Mesh`, the ensemble tier's layout
    (:mod:`~pystella_tpu_torch.ensemble`): small lattices keep
    ``proc_shape == (1, 1, 1)`` and pack the devices along the leading
    ensemble axis, large ones keep their spatial sharding with a smaller
    ensemble extent.

    :arg proc_shape: devices per lattice axis within one ensemble slice
        (default ``(1, 1, 1)``).
    :arg ensemble_devices: the slices along the ensemble axis (default
        ``len(devices) // prod(proc_shape)``). This is the device extent;
        a batch of E members over D slices places E / D members a slice.
    :arg ensemble_axis: the leading axis's name (default the registered
        ``PYSTELLA_ENSEMBLE_AXIS``, normally ``"ensemble"``).
    :arg devices: default the visible cards; a device may repeat (several
        slices on one card, as the JAX suite's virtual CPU devices share one
        host).
    """
    from pystella_tpu_torch import config as _config
    devices = ([resolve_device(d) for d in devices] if devices is not None
               else _default_devices())
    if ensemble_axis is None:
        ensemble_axis = _config.getenv("PYSTELLA_ENSEMBLE_AXIS")
    if proc_shape is None:
        proc_shape = (1,) * len(axis_names)
    proc_shape = tuple(int(p) for p in proc_shape)
    spatial = int(np.prod(proc_shape))
    if ensemble_devices is None:
        if len(devices) % spatial:
            raise ValueError(
                f"{len(devices)} devices do not tile proc_shape "
                f"{proc_shape}; pass ensemble_devices or a device "
                "subset explicitly")
        ensemble_devices = len(devices) // spatial
    ensemble_devices = int(ensemble_devices)
    need = ensemble_devices * spatial
    if need > len(devices):
        raise ValueError(
            f"ensemble mesh ({ensemble_devices},)+{proc_shape} needs "
            f"{need} devices, have {len(devices)}")
    return Mesh(_device_array(devices[:need],
                              (ensemble_devices,) + proc_shape),
                (ensemble_axis,) + tuple(axis_names[:len(proc_shape)]))


class NamedSharding:
    """A layout description: a :class:`Mesh` and a spec, one entry per
    array axis (a mesh axis name, or ``None`` for an axis kept whole), as
    ``jax.sharding.NamedSharding`` gives it."""

    def __init__(self, mesh, spec):
        self.mesh = mesh
        self.spec = tuple(spec)

    def __eq__(self, other):
        return (isinstance(other, NamedSharding) and other.mesh is self.mesh
                and other.spec == self.spec)

    def __repr__(self):
        return f"NamedSharding({self.mesh}, spec={self.spec})"


class MemberArray:
    """A batch of members, ``(members, *outer, *lattice)``, over the slices
    of an ensemble decomposition (:meth:`DomainDecomposition.shard_members`):
    ``parts[e]`` holds the members ``e * m .. (e + 1) * m - 1`` (``m`` a
    slice) as a tensor on slice ``e``'s device, or, on a spatial mesh, as a
    :class:`ShardedArray` whose blocks carry the member axis as their leading
    outer axis and lie on slice ``e``'s devices. The role of a JAX array
    sharded over the ensemble axis."""

    def __init__(self, parts, decomp):
        self.parts = list(parts)
        self.decomp = decomp
        if len(self.parts) != decomp.ensemble_devices:
            raise ValueError(f"{len(self.parts)} parts for "
                             f"{decomp.ensemble_devices} ensemble slices")

    @property
    def members_per_slice(self):
        return int(self.parts[0].shape[0])

    @property
    def shape(self):
        first = tuple(self.parts[0].shape)
        return (first[0] * len(self.parts),) + first[1:]

    @property
    def ndim(self):
        return len(self.shape)

    @property
    def dtype(self):
        return self.parts[0].dtype

    @property
    def sharding(self):
        """The layout as :class:`NamedSharding` (the JAX array's
        ``sharding``)."""
        return NamedSharding(self.decomp.mesh, self.decomp.member_spec(
            outer_axes=max(0, self.ndim - 1 - len(self.decomp.axis_names))))

    def locate(self, index):
        """``(slice, index in the slice)`` of member ``index``."""
        index = int(index)
        if not -self.shape[0] <= index < self.shape[0]:
            raise IndexError(f"member {index} of {self.shape[0]}")
        return divmod(index % self.shape[0], self.members_per_slice)

    def __getitem__(self, index):
        """Member ``index``: a view of its slice's tensor, or a
        :class:`ShardedArray` of views of its blocks."""
        e, j = self.locate(index)
        return take_index(self.parts[e], j)

    def map(self, fn):
        """A new batch of ``fn(part)`` per slice."""
        return MemberArray([fn(p) for p in self.parts], self.decomp)

    def __repr__(self):
        return (f"MemberArray(shape={self.shape}, dtype={self.dtype}, "
                f"slices={len(self.parts)})")


def take_index(part, j):
    """Entry ``j`` along the leading axis of a tensor, or of every block of
    a :class:`ShardedArray`."""
    if isinstance(part, ShardedArray):
        return part.map(lambda b: b[j])
    return part[j]


def _tree_map(fn, tree, *rest):
    """``fn`` over the leaves of dict/list/tuple trees of one structure
    (``None`` stays ``None``)."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return None if tree is None else fn(tree, *rest)


def _leaves(tree):
    """The leaves of a dict/list/tuple tree, ``None`` left out."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [] if tree is None else [tree]


def _device_of(leaf):
    """The device of a tensor, or of a :class:`ShardedArray`'s first
    block."""
    if isinstance(leaf, ShardedArray):
        return leaf.blocks[0].device
    return leaf.device


def _block_of(tree, r):
    """Rank ``r``'s block of every :class:`ShardedArray` leaf."""
    return _tree_map(lambda a: a.blocks[r] if isinstance(a, ShardedArray)
                     else a, tree)


def _lattice_map(fn, tree):
    """``fn`` over the lattice leaves (``ndim >= 3``) of a tree whose
    leaves are tensors or :class:`ShardedArray` s (then block by block);
    other leaves pass through."""
    def one(a):
        if isinstance(a, ShardedArray):
            return a.map(fn)
        return fn(a) if getattr(a, "ndim", 0) >= 3 else a
    return _tree_map(one, tree)


def blockwise(fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` once per block when any argument (a leaf of
    a dict, list or tuple) is a :class:`ShardedArray`: each call sees its
    rank's block of every sharded leaf and every other leaf as it is, and
    the tensor leaves of the results (``ndim >= 3``) are assembled into
    :class:`ShardedArray` s (other leaves from rank 0). Without a sharded
    argument, one plain call. For elementwise functions, so each block's
    result is the whole lattice's at its sites, bit for bit."""
    sharded = [a for a in _leaves((args, kwargs))
               if isinstance(a, ShardedArray)]
    if not sharded:
        return fn(*args, **kwargs)
    decomp = sharded[0].decomp
    outs = [fn(*_block_of(args, r), **_block_of(kwargs, r))
            for r in range(decomp.nshards)]

    def assemble(path_outs):
        first = path_outs[0]
        if isinstance(first, dict):
            return {k: assemble([o[k] for o in path_outs]) for k in first}
        if isinstance(first, (list, tuple)):
            return type(first)(assemble([o[i] for o in path_outs])
                               for i in range(len(first)))
        if isinstance(first, torch.Tensor) and first.ndim >= 3:
            return ShardedArray(path_outs, decomp)
        return first
    return assemble(outs)


def _slice_region(tree, region):
    """Slice every lattice leaf of ``tree`` to the block-coordinate
    ``region`` (three ``(start, stop)`` pairs); ``None``: the whole
    block."""
    if tree is None or region is None:
        return tree

    def cut(a):
        idx = [slice(None)] * a.ndim
        for d, (s, e) in enumerate(region):
            idx[a.ndim - 3 + d] = slice(s, e)
        return a[tuple(idx)]
    return _lattice_map(cut, tree)


class DomainDecomposition:
    """Shards 3-D lattice arrays over a grid of devices and provides the
    halo exchange and the collective verbs, driven from one process.

    :arg proc_shape: ranks per lattice axis, e.g. ``(2, 2, 1)``; default
        every device on the x axis (as the JAX ``make_mesh``).
    :arg halo_shape: default halo width ``h`` (scalar or 3-tuple).
    :arg devices: one device per rank, in rank order (C order over
        ``proc_shape``); a device may repeat, and several shards then share
        it. ``None``: the GPUs, rank ``r`` on ``cuda:(r % device_count)``,
        so a ``proc_shape`` larger than the card count puts several shards
        on each card; without a GPU this raises (nothing falls back to the
        CPU unasked: pass ``devices=["cpu"] * n``).
    :arg mesh: a :class:`Mesh` (:func:`make_mesh`, :func:`ensemble_mesh`)
        in place of ``proc_shape`` and ``devices``.
    :arg ensemble_axis: the name of a LEADING mesh axis that carries an
        ensemble of members (a mesh from :func:`ensemble_mesh`). The
        decomposition then describes one member's lattice: ``proc_shape``,
        ``axis_names`` and ``devices`` are those of the first ensemble slice
        (a lattice array placed with :meth:`shard` lies there), while
        :meth:`shard_members` places batched ``(members, ...)`` arrays with
        the member axis over the slices. A :class:`ShardedArray` of another
        slice's members names this decomposition too: its blocks lie on that
        slice's devices, and the operators exchange halos between the blocks
        where they lie.
    """

    def __init__(self, proc_shape=None, halo_shape=0, devices=None,
                 mesh=None, axis_names=("x", "y", "z"),
                 ensemble_axis=None):
        self.ensemble_axis = ensemble_axis
        if mesh is None and ensemble_axis is not None:
            raise ValueError("an ensemble decomposition needs an explicit "
                             "mesh (ensemble_mesh(...))")
        if mesh is not None:
            names = tuple(mesh.axis_names)
            grid = mesh.devices
            if ensemble_axis is not None:
                if not names or names[0] != ensemble_axis:
                    raise ValueError(
                        f"ensemble axis {ensemble_axis!r} must be the "
                        f"mesh's leading axis; mesh has {names}")
                names, grid = names[1:], grid[0]
            proc_shape = tuple(grid.shape)
            devices = list(grid.reshape(-1))
            axis_names = names
        else:
            axis_names = tuple(axis_names)
        if devices is None:
            resolve_device(None)  # the card, or a RuntimeError
            count = torch.cuda.device_count()
            if proc_shape is None:
                proc_shape = (count, 1, 1)
            n = int(np.prod(proc_shape))
            devices = [torch.device("cuda", r % count) for r in range(n)]
        else:
            devices = [resolve_device(d) for d in devices]
            if proc_shape is None:
                proc_shape = (len(devices), 1, 1)
        proc_shape = tuple(int(p) for p in proc_shape)
        if len(proc_shape) != 3 or min(proc_shape) < 1:
            raise ValueError(f"proc_shape must be three positive ranks per "
                             f"axis; got {proc_shape}")
        if int(np.prod(proc_shape)) != len(devices):
            raise ValueError(
                f"proc_shape {proc_shape} does not cover {len(devices)} "
                "devices")
        self.proc_shape = proc_shape
        self.devices = devices
        #: mesh coordinates of every rank, and its neighbours one step
        #: along each axis (the exchange looks them up per copy)
        self._coords = [tuple(int(i) for i in np.unravel_index(
            r, proc_shape)) for r in range(len(devices))]
        self._neighbors = {(r, d, s): self._neighbor(r, d, s)
                           for r in range(len(devices)) for d in range(3)
                           for s in (-1, 1)}
        self.axis_names = axis_names
        self.mesh = mesh if mesh is not None else Mesh(
            _device_array(devices, proc_shape), axis_names)
        if np.isscalar(halo_shape):
            halo_shape = (halo_shape,) * 3
        self.halo_shape = tuple(int(h) for h in halo_shape)
        #: per-execution bytes of each distinct halo program run through
        #: this decomposition (see :meth:`traced_halo_bytes`)
        self._halo_program_bytes = {}
        #: bytes copied between ranks by every exchange so far, summed over
        #: the ranks (a host count; the ``obs`` counter
        #: ``halo_bytes_exchanged`` counts each distinct program once, as
        #: the JAX package's does)
        self.bytes_exchanged = 0
        #: per-axis exchanges made by :meth:`share_halos` (what the ``obs``
        #: counter ``halo_exchanges`` adds up)
        self.halo_exchanges = 0
        self._side_streams = {}

    # -- ensemble (member-axis) placement --------------------------------

    @property
    def ensemble_devices(self):
        """The slices along the ensemble mesh axis (1 without one)."""
        if self.ensemble_axis is None:
            return 1
        return int(self.mesh.shape[self.ensemble_axis])

    def slice_devices(self, e):
        """The devices of ensemble slice ``e``, in rank order (without an
        ensemble axis, slice 0 is the whole mesh)."""
        if self.ensemble_axis is None:
            if e != 0:
                raise IndexError(f"slice {e} of a mesh without an ensemble "
                                 "axis")
            return list(self.devices)
        return list(self.mesh.devices[e].reshape(-1))

    def spec(self, outer_axes=0):
        """The layout of an array with ``outer_axes`` leading axes kept
        whole followed by the 3 lattice axes: one entry per axis, a lattice
        axis's name where the mesh shards it (the JAX ``PartitionSpec``)."""
        names = [n if self.proc_shape[i] > 1 else None
                 for i, n in enumerate(self.axis_names)]
        return (None,) * outer_axes + tuple(names)

    def member_spec(self, outer_axes=0):
        """The layout of a batched ``(members, *outer, *lattice)`` array:
        the member axis over the ensemble slices (``None`` with one slice),
        the lattice axes over each slice's spatial mesh, as
        :meth:`spec` describes them."""
        lead = (self.ensemble_axis if self.ensemble_devices > 1 else None,)
        return lead + self.spec(outer_axes)

    def member_sharding(self, outer_axes=0):
        """:meth:`member_spec` on this decomposition's mesh."""
        return NamedSharding(self.mesh, self.member_spec(outer_axes))

    def shard_members(self, array, outer_axes=None):
        """Place a batched ``(members, ...)`` array (numpy, a tensor, or a
        :class:`MemberArray` of any decomposition, gathered first) as a
        :class:`MemberArray`: the members split over the ensemble slices in
        order, each slice's members a tensor on its device, or with a
        spatial ``proc_shape`` a :class:`ShardedArray` on its devices whose
        blocks carry the member axis as their leading outer axis. The slice
        count must divide the member count. Leaves of fewer than ``1 + 3``
        axes (per-member scalars or vectors) carry no lattice axes: only
        the member axis splits them, onto each slice's first device.
        ``outer_axes`` is accepted for the JAX signature."""
        if isinstance(array, MemberArray):
            array = np.concatenate([_host_whole(p) for p in array.parts])
        elif isinstance(array, ShardedArray):
            array = array.decomp.gather_array(array)
        if not isinstance(array, torch.Tensor):
            array = torch.from_numpy(np.ascontiguousarray(np.asarray(array)))
        E = self.ensemble_devices
        if array.shape[0] % E:
            raise ValueError(
                f"member count {array.shape[0]} not divisible by the "
                f"ensemble device extent {E}; pad the batch or choose a "
                "compatible mesh")
        m = array.shape[0] // E
        lattice = array.ndim >= 1 + len(self.axis_names)
        parts = []
        for e in range(E):
            part = array[e * m:(e + 1) * m]
            devs = self.slice_devices(e)
            if lattice and self.nshards > 1:
                parts.append(ShardedArray(self._blocks_of(part, devs), self))
            else:
                parts.append(torch.empty(part.shape, dtype=part.dtype,
                                         device=devs[0]).copy_(part))
        return MemberArray(parts, self)

    def with_devices(self, devices, proc_shape=None):
        """A new decomposition with the same halo widths and axis names over
        another device set (default ``proc_shape``: every device along x),
        as a re-mesh builds a degraded continuation. An ensemble
        decomposition cannot be rebuilt so: build an :func:`ensemble_mesh`
        for the member axis."""
        if self.ensemble_axis is not None:
            raise ValueError(
                "with_devices rebuilds spatial decompositions only; "
                "build an ensemble_mesh for the member-axis path")
        return DomainDecomposition(proc_shape, halo_shape=self.halo_shape,
                                   devices=list(devices))

    # -- ranks -----------------------------------------------------------

    @property
    def nshards(self):
        """The number of blocks (ranks of the mesh)."""
        return len(self.devices)

    def coords(self, r):
        """Mesh coordinates of rank ``r`` (C order over ``proc_shape``)."""
        return self._coords[r]

    def neighbor(self, r, d, shift):
        """The rank ``shift`` steps from rank ``r`` along axis ``d``, with
        periodic wrap."""
        n = self._neighbors.get((r, d, shift))
        return self._neighbor(r, d, shift) if n is None else n

    def _neighbor(self, r, d, shift):
        c = list(self._coords[r])
        c[d] = (c[d] + shift) % self.proc_shape[d]
        return int(np.ravel_multi_index(c, self.proc_shape))

    @property
    def reduce_axes(self):
        """The axes the lattice is actually sharded over."""
        return tuple(n for i, n in enumerate(self.axis_names)
                     if self.proc_shape[i] > 1)

    @property
    def rank(self):
        """This process's rank: one process drives every shard."""
        return 0

    @property
    def nranks(self):
        """The number of processes: one."""
        return 1

    def rank_tuple(self, rank=None):
        """Cartesian coordinates of process ``rank`` in the process grid
        (processes are laid out along x; with one controller this is
        ``(0, 0, 0)``)."""
        rank = self.rank if rank is None else rank
        return (rank % max(1, self.nranks), 0, 0)

    def rankID(self, *tup):
        """Flat id of process-grid coordinates with periodic wrap."""
        return tup[0] % max(1, self.nranks)

    def rank_shape(self, grid_shape):
        """Per-rank block shape; requires divisibility (the JAX package's
        design decision: even blocks)."""
        for n, p in zip(grid_shape, self.proc_shape):
            if n % p:
                raise ValueError(
                    f"grid_shape {tuple(grid_shape)} not divisible by "
                    f"proc_shape {self.proc_shape}; choose divisible shapes")
        return tuple(n // p for n, p in zip(grid_shape, self.proc_shape))

    # -- placement -------------------------------------------------------

    def _blocks_of(self, array, devices=None):
        """The blocks of a global array (numpy or tensor), each a new
        contiguous tensor on its rank's device (of ``devices``, default
        :attr:`devices`: another ensemble slice's)."""
        if not isinstance(array, torch.Tensor):
            a = np.asarray(array)
            array = torch.from_numpy(np.ascontiguousarray(a))
        lat = self.rank_shape(tuple(array.shape[-3:]))
        blocks = []
        for r, dev in enumerate(self.devices if devices is None
                                else devices):
            idx = [slice(None)] * (array.ndim - 3) + [
                slice(i * n, (i + 1) * n)
                for i, n in zip(self.coords(r), lat)]
            view = array[tuple(idx)]
            blocks.append(torch.empty(view.shape, dtype=view.dtype,
                                      device=dev).copy_(view))
        return blocks

    def shard(self, array, outer_axes=None):
        """Place ``array`` (numpy, a tensor or a :class:`ShardedArray`,
        which is returned as it is) as a :class:`ShardedArray`: the lattice
        axes (the last three) split over the ranks, the leading axes kept
        whole in every block. ``outer_axes`` is accepted for the JAX
        signature; the lattice axes are always the trailing three."""
        if isinstance(array, ShardedArray):
            return array
        if array.ndim < 3:
            raise ValueError("a sharded array needs three lattice axes")
        return ShardedArray(self._blocks_of(array), self)

    scatter_array = shard

    def gather_array(self, array):
        """The whole lattice array on the host as a numpy array (bfloat16
        blocks widened to float32, exactly)."""
        if not isinstance(array, ShardedArray):
            return np.asarray(array)
        b = array.block_shape
        lat = b[-3:]
        out = None
        for r, blk in enumerate(array.blocks):
            blk = blk.detach().cpu()
            if blk.dtype == torch.bfloat16:
                blk = blk.float()
            blk = blk.numpy()
            if out is None:
                out = np.empty(array.shape, dtype=blk.dtype)
            idx = [slice(None)] * (len(b) - 3) + [
                slice(i * n, (i + 1) * n)
                for i, n in zip(self.coords(r), lat)]
            out[tuple(idx)] = blk
        return out

    def unshard(self, array, device=None):
        """The whole lattice array of a :class:`ShardedArray` as one tensor
        on ``device`` (default: rank 0's), each block copied into its place
        device to device (no host round trip, no sync): how a replicated
        multigrid level is assembled. :meth:`shard` of a tensor cuts one
        back into blocks the same way."""
        dev = self.devices[0] if device is None else resolve_device(device)
        out = torch.empty(array.shape, dtype=array.dtype, device=dev)
        b = array.block_shape
        for r, blk in enumerate(array.blocks):
            idx = [slice(None)] * (len(b) - 3) + [
                slice(i * n, (i + 1) * n)
                for i, n in zip(self.coords(r), b[-3:])]
            out[tuple(idx)].copy_(blk)
        return out

    def zeros(self, grid_shape, dtype, outer_shape=()):
        lat = self.rank_shape(tuple(grid_shape))
        dt = torch_dtype(dtype)
        return ShardedArray(
            [torch.zeros(tuple(outer_shape) + lat, dtype=dt, device=dev)
             for dev in self.devices], self)

    # -- collectives -----------------------------------------------------

    @staticmethod
    def _combine(parts, op):
        """Per-rank values combined in rank order, on rank 0's device."""
        acc = parts[0]
        for p in parts[1:]:
            p = p.to(acc.device) if isinstance(p, torch.Tensor) else p
            if op == "sum":
                acc = acc + p
            elif op == "prod":
                acc = acc * p
            elif op == "max":
                acc = torch.maximum(acc, torch.as_tensor(p))
            elif op == "min":
                acc = torch.minimum(acc, torch.as_tensor(p))
            else:
                raise ValueError(f"unknown op {op}")
        return acc

    def psum(self, x):
        """Sum of per-rank partials (a list or tuple, one per rank), added
        in rank order: the JAX ``lax.psum`` of a ``shard_map`` body, whose
        per-block values the per-block launch loop here collects. Anything
        else (one value) passes through, as on a single-device mesh."""
        if isinstance(x, (list, tuple)):
            if len(x) != self.nshards:
                raise ValueError(f"psum takes one partial per rank "
                                 f"({self.nshards}); got {len(x)}")
            return self._combine(list(x), "sum")
        return x

    def allreduce(self, x, op="sum"):
        """Reduce ``x`` over the full lattice (``op``: ``sum``, ``max``,
        ``min``, ``prod``): per-block reductions combined in rank order;
        a 0-d tensor on rank 0's device."""
        reduce = {"sum": torch.sum, "max": torch.max, "min": torch.min,
                  "prod": torch.prod}.get(op)
        if reduce is None:
            raise ValueError(f"unknown op {op}")
        if not isinstance(x, ShardedArray):
            return reduce(x)
        return self._combine([reduce(b) for b in x.blocks], op)

    def bcast(self, x, root=0):
        """With one controller there is nothing to broadcast."""
        return x

    def barrier(self):
        """Wait for every card of the mesh to finish its queued work."""
        for dev in {d for d in self.devices if d.type == "cuda"}:
            torch.cuda.synchronize(dev)

    # -- halo exchange ---------------------------------------------------

    def _canon_halo(self, halo, exchange):
        if np.isscalar(halo):
            halo = (halo,) * 3
        halo = tuple(int(h) for h in halo)
        if exchange is None:
            exchange = halo
        elif np.isscalar(exchange):
            exchange = (exchange,) * 3
        return halo, tuple(int(e) for e in exchange)

    def comm_axes(self, halo):
        """Lattice axes whose halos actually cross between ranks."""
        return tuple(d for d in range(3)
                     if self.proc_shape[d] > 1 and halo[d] > 0)

    def split_axes(self, halo, shape):
        """The axes the interior/shell split divides, or ``()`` when the
        configuration must keep the padded path: nothing communicated, a
        communicated z axis, or a block thinner than
        ``MIN_INTERIOR_FACTOR * halo`` along a communicated axis (the JAX
        package's rule)."""
        comm = self.comm_axes(halo)
        if not comm or 2 in comm:
            return ()
        if any(shape[d] < MIN_INTERIOR_FACTOR * halo[d] for d in comm):
            return ()
        return comm

    def halo_bytes(self, shape, itemsize, halo, exchange=None,
                   lattice_axes=None):
        """Bytes ONE rank's exchange with these parameters moves between
        ranks: two ``exchange[d]``-wide slabs per sharded axis (unsharded
        axes wrap locally; later axes' slabs include earlier axes'
        padding)."""
        if lattice_axes is None:
            lattice_axes = tuple(range(len(shape) - len(halo), len(shape)))
        extents = list(shape)
        total = 0
        for d, ax in enumerate(lattice_axes):
            h = halo[d]
            if h == 0:
                continue
            e = min(int(exchange[d]), h) if exchange is not None else h
            if self.proc_shape[d] > 1 and e > 0:
                slab = int(itemsize) * e
                for a, n in enumerate(extents):
                    if a != ax:
                        slab *= int(n)
                total += 2 * slab
            extents[ax] += 2 * h
        return total

    def _record_halo_bytes(self, key, nbytes):
        """Count an exchange: every execution in :attr:`bytes_exchanged`;
        the first execution of a distinct program (``key``) in the
        per-program figure and in the ``halo_bytes_exchanged`` counter, as
        the JAX package counts at trace time."""
        self.bytes_exchanged += nbytes * self.nshards
        if not nbytes or key in self._halo_program_bytes:
            return
        self._halo_program_bytes[key] = nbytes
        from pystella_tpu_torch.obs import metrics as _metrics
        _metrics.counter("halo_bytes_exchanged").inc(nbytes)

    def traced_halo_bytes(self):
        """Per-rank bytes of one execution of each distinct halo exchange
        run through this decomposition so far, summed: the JAX package's
        per-program figure. :attr:`bytes_exchanged` counts every execution
        on every rank."""
        return sum(self._halo_program_bytes.values())

    def pad_into(self, blocks, outs, halo, exchange=None):
        """Write each block of ``blocks`` (tensors in rank order) into the
        matching preallocated padded block of ``outs``, grown by
        ``2 * halo[d]`` along lattice axis ``d``: the centre, then, axis by
        axis (x, y, z), the halo rows, from the neighbours along sharded
        axes and by local wrap along the others. Along a sharded axis only
        ``exchange[d]`` rows cross between ranks and the rest are zeros
        (the JAX package's alignment rows; stencil taps reach at most the
        radius). Later axes' slabs include earlier axes' halos, as in the
        JAX ``pad_with_halos``; the result equals it element for
        element."""
        self.pad_plan(blocks, outs, halo, exchange)()
        return outs

    def pad_plan(self, blocks, outs, halo, exchange=None):
        """The copies of :meth:`pad_into` as a :class:`HaloPlan`: built
        once, run (``plan()``) for every exchange between the same
        tensors, as a smoother's sweeps exchange the same buffers."""
        halo, exchange = self._canon_halo(halo, exchange)
        lat = tuple(blocks[0].shape[-3:])
        nout = blocks[0].ndim - 3
        for d in range(3):
            if (halo[d] if self.proc_shape[d] == 1
                    else min(exchange[d], halo[d])) > lat[d]:
                raise ValueError(
                    f"halo width {halo[d]} exceeds the local block size "
                    f"{lat[d]} along axis {d}; use a wider grid or a "
                    "smaller mesh axis")

        def region(d, rows, full_before=True):
            """Index of ``rows`` along axis ``d``: axes before ``d`` at
            their padded extent, axes after it at their real rows."""
            idx = [slice(None)] * nout
            for a in range(3):
                if a == d:
                    idx.append(rows)
                elif a < d and full_before:
                    idx.append(slice(None))
                else:
                    idx.append(slice(halo[a], halo[a] + lat[a]))
            return tuple(idx)

        centre = region(-1, None, full_before=False)
        # the centres, then axis by axis the halo rows (each stage reads
        # what the earlier ones wrote)
        stages = [[(out[centre], blk) for blk, out in zip(blocks, outs)]]
        for d in range(3):
            h, n = halo[d], lat[d]
            if h == 0:
                continue
            e = h if self.proc_shape[d] == 1 else min(exchange[d], h)
            stage = []
            for r, out in enumerate(outs):
                lo = outs[self.neighbor(r, d, -1)]
                hi = outs[self.neighbor(r, d, +1)]
                stage.append((out[region(d, slice(h - e, h))],
                              lo[region(d, slice(h + n - e, h + n))]))
                stage.append((out[region(d, slice(h + n, h + n + e))],
                              hi[region(d, slice(h, h + e))]))
                if e < h:
                    stage.append((out[region(d, slice(0, h - e))], None))
                    stage.append((out[region(d, slice(h + n + e,
                                                      n + 2 * h))], None))
            stages.append(stage)
        key = (tuple(blocks[0].shape), str(blocks[0].dtype), halo, exchange)
        return HaloPlan(self, stages, key, self.halo_bytes(
            blocks[0].shape, blocks[0].element_size(), halo, exchange))

    def _pad_blocks(self, blocks, halo, exchange):
        halo, exchange = self._canon_halo(halo, exchange)
        outs = [torch.empty(b.shape[:-3] + tuple(
            n + 2 * h for n, h in zip(b.shape[-3:], halo)), dtype=b.dtype,
            device=b.device) for b in blocks]
        return self.pad_into(blocks, outs, halo, exchange)

    def pad_with_halos(self, x, halo, lattice_axes=None, exchange=None,
                       overlap=False):
        """``x`` (a :class:`ShardedArray`) with every block padded by
        periodic halos of width ``halo[d]`` along lattice axis ``d``
        (:meth:`pad_into`). The lattice axes are the trailing three
        (``lattice_axes`` must name them, if given).

        With ``overlap=True`` the padded blocks come back split for
        communication/computation overlap, as ``(interior, shells)``:
        ``interior`` is ``x`` padded along the axes that need no exchange
        only (a stencil on it yields the radius-``halo`` inset of each
        block), ``shells`` a :class:`HaloShells` over the fully padded
        blocks. Raises ``ValueError`` when no split exists
        (:meth:`split_axes`)."""
        halo, exchange = self._canon_halo(halo, exchange)
        if lattice_axes is not None and tuple(lattice_axes) != tuple(
                range(x.ndim - 3, x.ndim)):
            raise ValueError("the lattice axes must be the trailing three")
        if overlap:
            return self._overlap_split(x, halo, exchange)
        return ShardedArray(self._pad_blocks(x.blocks, halo, exchange),
                            self)

    def _local_halo(self, halo, exchange, split):
        return (tuple(0 if d in split else halo[d] for d in range(3)),
                tuple(0 if d in split else exchange[d] for d in range(3)))

    def _overlap_split(self, x, halo, exchange):
        shape = tuple(x.block_shape[-3:])
        split = self.split_axes(halo, shape)
        if not split:
            raise ValueError(
                f"no overlappable axis for block {shape} with halo "
                f"{halo} on mesh {self.proc_shape}: needs a sharded x/y "
                f"axis spanning >= {MIN_INTERIOR_FACTOR}*halo (the z "
                "axis is never split; see split_axes)")
        padded = self.pad_with_halos(x, halo, exchange=exchange)
        local_halo, local_ex = self._local_halo(halo, exchange, split)
        interior = ShardedArray(
            self._pad_blocks(x.blocks, local_halo, local_ex), self)
        return interior, HaloShells(padded, halo, split, shape)

    def exchange_slabs(self, x, d, width, lattice_axes=None):
        """``(left_halo, right_halo)``: for every rank the last ``width``
        rows of its left neighbour and the first ``width`` rows of its
        right neighbour along lattice axis ``d`` (periodic), as
        :class:`ShardedArray` s on the ranks' devices."""
        ax = x.ndim - 3 + d
        n = x.block_shape[ax]
        blk = x.blocks[0]
        nbytes = 2 * int(width) * blk.element_size() * int(
            np.prod([m for a, m in enumerate(blk.shape) if a != ax]))
        self._record_halo_bytes(("slabs", tuple(blk.shape), str(blk.dtype),
                                 d, width), nbytes)
        with record_function("halo_exchange"):
            left = [x.blocks[self.neighbor(r, d, -1)].narrow(
                ax, n - width, width).to(dev, copy=True)
                for r, dev in enumerate(self.devices)]
            right = [x.blocks[self.neighbor(r, d, +1)].narrow(
                ax, 0, width).to(dev, copy=True)
                for r, dev in enumerate(self.devices)]
        return ShardedArray(left, self), ShardedArray(right, self)

    def x_shells_into(self, blocks, lows, highs, h):
        """The inputs of the two x shells of every block, written into
        preallocated ``(..., 3h, ny, nz)`` tensors: ``lows[r]`` is the left
        neighbour's last ``h`` rows then the block's first ``2h``,
        ``highs[r]`` the block's last ``2h`` rows then the right
        neighbour's first ``h`` (``concat(halo, 2h rows)`` of the JAX
        ``OverlapStreamingStencil``)."""
        self.x_shells_plan(blocks, lows, highs, h)()
        return lows, highs

    def x_shells_plan(self, blocks, lows, highs, h):
        """The copies of :meth:`x_shells_into` as a :class:`HaloPlan`."""
        ax = blocks[0].ndim - 3
        n = blocks[0].shape[ax]
        blk = blocks[0]
        nbytes = 2 * h * blk.element_size() * int(
            np.prod([m for a, m in enumerate(blk.shape) if a != ax]))
        copies = []
        for r, (blk, lo, hi) in enumerate(zip(blocks, lows, highs)):
            left = blocks[self.neighbor(r, 0, -1)]
            right = blocks[self.neighbor(r, 0, +1)]
            copies += [(lo.narrow(ax, 0, h), left.narrow(ax, n - h, h)),
                       (lo.narrow(ax, h, 2 * h), blk.narrow(ax, 0, 2 * h)),
                       (hi.narrow(ax, 0, 2 * h),
                        blk.narrow(ax, n - 2 * h, 2 * h)),
                       (hi.narrow(ax, 2 * h, h), right.narrow(ax, 0, h))]
        return HaloPlan(self, [copies], ("slabs", tuple(blk.shape),
                                         str(blk.dtype), 0, h), nbytes)

    def side_exchange(self, reads=(), writes=()):
        """A context for exchange copies on a side stream of each card of
        the mesh: every CUDA tensor in ``reads`` and ``writes`` is marked as
        used on its side stream (``record_stream``, once); on entry the side
        streams wait for the work queued so far on the current streams;
        inside, copies go to the side streams; the
        returned object's ``wait()`` makes the current streams wait for
        them. Without a card it runs the copies in place and ``wait()`` does
        nothing. The object may be entered again for later exchanges
        between the same tensors."""
        return _SideExchange(self, reads, writes)

    def _side_stream(self, dev):
        s = self._side_streams.get(dev)
        if s is None:
            s = self._side_streams[dev] = torch.cuda.Stream(dev)
        return s

    def share_halos(self, array, halo, outer_axes=0):
        """The padded blocks of ``array`` (shape grown by ``2 * halo`` per
        axis and block): :meth:`pad_with_halos` as a standalone verb."""
        halo, _ = self._canon_halo(halo, None)
        n = len(self.comm_axes(halo))
        self.halo_exchanges += n
        from pystella_tpu_torch.obs import metrics as _metrics
        _metrics.counter("halo_exchanges").inc(n)
        return self.pad_with_halos(self.shard(array), halo)

    def overlap_stencil(self, xs, halo, apply_fn, extras=None,
                        exchange=None, overlap=True):
        """Apply a radius-``halo`` stencil with the halo exchange overlapped
        behind the interior compute.

        ``xs`` is a tree (dicts, lists, tuples) of :class:`ShardedArray` s
        with the same lattice blocks; ``apply_fn(padded_xs[, extras])`` is
        called once per block -- the per-block launch loop that takes the
        place of ``shard_map`` -- on the block's halo-padded tensors (every
        lattice axis grown by ``2 * halo[d]``) and must return a tree of
        outputs of the unpadded lattice extent, elementwise over sites.
        ``extras`` is an optional tree of unpadded :class:`ShardedArray` s
        (and scalars, passed through) sliced to each computed region.

        The split: every block's exchange first; then the interior (the
        radius-``halo`` inset along communicated axes) of every block from
        its local data; then the boundary shells from the padded blocks,
        stitched around the interiors. Bit-exact with the padded path;
        configurations without a split (:meth:`split_axes`) run the padded
        path. Returns the tree of outputs as :class:`ShardedArray` s."""
        halo, exchange = self._canon_halo(halo, exchange)
        shape = tuple(_leaves(xs)[0].block_shape[-3:])
        split = self.split_axes(halo, shape) if overlap else ()

        def call(padded_xs, r, region):
            if extras is None:
                return apply_fn(padded_xs)
            return apply_fn(padded_xs,
                            _slice_region(_block_of(extras, r), region))

        def pad(a):
            return self.pad_with_halos(a, halo, exchange=exchange)

        if not split:
            padded = _tree_map(pad, xs)
            return self._assemble([call(_block_of(padded, r), r, None)
                                   for r in range(self.nshards)])
        with record_function("halo_overlap"):
            padded = _tree_map(pad, xs)
            local_halo, local_ex = self._local_halo(halo, exchange, split)
            outs = []
            with record_function("halo_overlap_interior"):
                interior_in = _tree_map(lambda a: ShardedArray(
                    self._pad_blocks(a.blocks, local_halo, local_ex), self),
                    xs)
                shells = [HaloShells(_block_of(padded, r), halo, split,
                                     shape) for r in range(self.nshards)]
                interiors = [call(_block_of(interior_in, r), r,
                                  shells[r].interior_region())
                             for r in range(self.nshards)]
            with record_function("halo_overlap_shells"):
                for r, sh in enumerate(shells):
                    shell_outs = [call(inp, r, reg) for inp, reg in
                                  zip(sh.inputs(), sh.regions())]
                    outs.append(sh.stitch(interiors[r], shell_outs))
        return self._assemble(outs)

    def _assemble(self, per_rank):
        """A list (one per rank) of trees of tensors -> one tree of
        :class:`ShardedArray` s."""
        first = per_rank[0]
        if isinstance(first, dict):
            return {k: self._assemble([t[k] for t in per_rank])
                    for k in first}
        if isinstance(first, (list, tuple)):
            return type(first)(self._assemble([t[i] for t in per_rank])
                               for i in range(len(first)))
        return ShardedArray(per_rank, self)

    def __repr__(self):
        ens = (f", ensemble_devices={self.ensemble_devices}"
               if self.ensemble_axis is not None else "")
        return f"DomainDecomposition(proc_shape={self.proc_shape}{ens})"


def _host_whole(part):
    """One slice's members as a whole host array."""
    if isinstance(part, ShardedArray):
        return part.decomp.gather_array(part)
    return part.detach().cpu().numpy()


class HaloPlan:
    """The copies of one halo exchange between fixed tensors, as stages of
    ``(destination, source)`` views (a ``None`` source writes zeros; a
    stage reads what earlier stages wrote, never its own destinations),
    and the bytes one execution moves between ranks. Calling it runs each
    stage as one ``torch._foreach_copy_`` on the current stream under the
    ``halo_exchange`` label and counts the bytes
    (:attr:`DomainDecomposition.bytes_exchanged`); a caller that exchanges
    the same buffers many times builds it once and saves the indexing and
    the per-copy dispatch of every call."""

    def __init__(self, decomp, stages, key, nbytes):
        self.decomp = decomp
        self.stages = []
        for stage in stages:
            copies = [(d, s) for d, s in stage if s is not None]
            self.stages.append(([d for d, _ in copies],
                                [s for _, s in copies],
                                [d for d, s in stage if s is None]))
        self._key = key
        self.nbytes = nbytes

    def __call__(self):
        self.decomp._record_halo_bytes(self._key, self.nbytes)
        with record_function("halo_exchange"):
            for dsts, srcs, zeros in self.stages:
                if dsts:
                    torch._foreach_copy_(dsts, srcs)
                if zeros:
                    torch._foreach_zero_(zeros)


class _SideExchange:
    """See :meth:`DomainDecomposition.side_exchange`. The tensors are
    marked as used on the side streams once, here, so one object can serve
    as the context of many exchanges between the same tensors."""

    def __init__(self, decomp, reads, writes):
        self._devs = sorted({t.device for t in list(reads) + list(writes)
                             if t.is_cuda}, key=str)
        self._streams = [decomp._side_stream(d) for d in self._devs]
        side = dict(zip(self._devs, self._streams))
        for t in list(reads) + list(writes):
            if t.is_cuda:
                t.record_stream(side[t.device])
        self._stack = None
        self._events = []

    def __enter__(self):
        for dev, s in zip(self._devs, self._streams):
            s.wait_stream(torch.cuda.current_stream(dev))
        self._stack = contextlib.ExitStack()
        for s in self._streams:
            self._stack.enter_context(torch.cuda.stream(s))
        return self

    def __exit__(self, *exc):
        self._stack.close()
        self._events = []
        for s in self._streams:
            ev = torch.cuda.Event()
            ev.record(s)
            self._events.append(ev)
        return False

    def wait(self):
        """The current streams wait for the copies made inside."""
        for dev, ev in zip(self._devs, self._events):
            torch.cuda.current_stream(dev).wait_event(ev)


class HaloShells:
    """The shells half of the overlapped halo exchange
    (:meth:`DomainDecomposition.pad_with_halos` with ``overlap=True``): the
    fully padded block(s) -- the part that waits on the exchange -- and the
    bookkeeping that partitions the radius-``halo`` boundary into ``2 *
    len(comm_axes)`` shells (an onion partition: the shell pair of the k-th
    communicated axis spans the interior of earlier communicated axes and
    the full extent of everything else) and stitches shell outputs around
    an independently computed interior.

    ``padded`` is a tree whose leaves are tensors (one block) or
    :class:`ShardedArray` s (every block at once); lattice axes trail."""

    def __init__(self, padded, halo, comm_axes, block_shape):
        self.padded = padded
        self.halo = tuple(halo)
        self.comm_axes = tuple(comm_axes)
        self.block_shape = tuple(block_shape)

    def interior_region(self):
        """Block-coordinate region the interior covers: the
        radius-``halo`` inset along communicated axes, full extent
        elsewhere."""
        return tuple(
            (self.halo[d], self.block_shape[d] - self.halo[d])
            if d in self.comm_axes else (0, self.block_shape[d])
            for d in range(3))

    def regions(self):
        """Output regions (block coordinates) of the shells, ``(low,
        high)`` per communicated axis."""
        out = []
        for k, d in enumerate(self.comm_axes):
            n, h = self.block_shape[d], self.halo[d]
            for bounds in ((0, h), (n - h, n)):
                region = []
                for a in range(3):
                    na, ha = self.block_shape[a], self.halo[a]
                    if a == d:
                        region.append(bounds)
                    elif a in self.comm_axes[:k]:
                        region.append((ha, na - ha))
                    else:
                        region.append((0, na))
                out.append(tuple(region))
        return out

    def inputs(self):
        """One padded input per shell, its stencil footprint: output rows
        ``[a, b)`` along an axis read padded rows ``[a, b + 2 * halo)``."""
        ins = []
        for region in self.regions():
            def cut(p, region=region):
                idx = [slice(None)] * p.ndim
                for a, (s, e) in enumerate(region):
                    idx[p.ndim - 3 + a] = slice(s, e + 2 * self.halo[a])
                return p[tuple(idx)]
            ins.append(_lattice_map(cut, self.padded))
        return ins

    def stitch(self, interior_out, shell_outs):
        """Concatenate the shell outputs around the interior, innermost
        communicated axis first (the inverse of the onion partition)."""
        res = interior_out
        for k in range(len(self.comm_axes) - 1, -1, -1):
            d = self.comm_axes[k]
            res = _tree_map(lambda lo, mid, hi, d=d: _cat(
                [lo, mid, hi], d), shell_outs[2 * k], res,
                shell_outs[2 * k + 1])
        return res


def _cat(parts, d):
    """Concatenate lattice axis ``d`` of tensors or ShardedArrays."""
    if isinstance(parts[1], ShardedArray):
        return ShardedArray([torch.cat(bs, dim=bs[1].ndim - 3 + d)
                             for bs in zip(*(p.blocks for p in parts))],
                            parts[1].decomp)
    return torch.cat(parts, dim=parts[1].ndim - 3 + d)

