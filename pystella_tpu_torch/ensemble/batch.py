"""Batched member stepping: mapped and vmapped wrappers over the steppers.

PyTorch counterpart of ``pystella_tpu/ensemble/batch.py``. The single-run
steppers (:class:`~pystella_tpu_torch.Stepper`,
:class:`~pystella_tpu_torch.FusedScalarStepper`) advance ONE lattice per
call. :class:`EnsembleStepper` turns any of them into a population engine: a
batch of ``size`` members is one state whose leaves carry a leading member
axis, and per-member parameters (couplings, dt, time) enter as batched
leaves, so one body serves every member.

Two batching tiers, chosen by ``via``:

``"map"``
    A loop over the members through the stepper's ``multi_step_fn`` (its
    ``_step_impl`` for one step): the fused steppers' kernels run exactly as
    built, at single-member shapes, so a mapped member is bit for bit the
    same member run through the stepper's own ``multi_step`` in the same
    chunks (the JAX package's ``lax.map`` tier). Per-member scalars reach
    each member's launch as the batch holds them: numpy scalars of the
    batched leaves, never device tensors (a sequential run's Python float
    and the batch's float64 scalar are the same number in the same
    arithmetic). Each member runs on its own slice's device, through the
    stepper's twin there (:meth:`~pystella_tpu_torch.Stepper.on_device`:
    a fused stepper is bound to one card).
``"vmap"``
    ``torch.func.vmap`` of the member body, once per ensemble slice (no
    loop over members). The hand-written operators the body reaches
    (:class:`~pystella_tpu_torch.FiniteDifferencer`, K12) are PyTorch custom
    operators with a batching rule that folds the member axis into the
    kernel's outer axes, so one launch per operator call serves the whole
    slice, as the JAX package's batched ``pallas_call`` does. Per-member
    scalars enter as tensors of the batch's device (float64, which PyTorch
    promotes like a Python number), so members agree with sequential runs
    to rounding, not bit for bit. On a spatial + ensemble mesh the body
    meets :class:`~pystella_tpu_torch.parallel.ShardedArray` s: the port
    registers ShardedArray as a pytree node, so vmap maps over its blocks'
    leading (member) axis and the body sees a ShardedArray of one member's
    blocks; the sharded operator is one custom operator over every block
    (its halo exchange inside), batched the same way.

``via="auto"`` picks ``"map"`` for fused steppers (anything with the
``_multi_step_impl`` marker) and ``"vmap"`` otherwise. The fused steppers'
kernels have no batching rule, so ``via="vmap"`` on one raises.

Batches: without a ``decomp`` the leaves are tensors on the ensemble's
device; with an ensemble decomposition
(:func:`~pystella_tpu_torch.parallel.ensemble_mesh`) they are
:class:`~pystella_tpu_torch.parallel.MemberArray` s over its slices.

Left out beside the JAX module: ``obs.memory.instrument_jit`` around each
batched body and the member-slot write (JAX batch.py:221, :287); the port
has no ``obs.memory`` yet (ROADMAP queue 1 item 7). PyTorch compiles
nothing, so there is no jit cache to instrument: :attr:`EnsembleStepper.
bodies` caches one batched body per ``(nsteps, sentinel, aux)`` key.
"""

from __future__ import annotations

import numpy as np
import torch

from pystella_tpu_torch._device import resolve_device
from pystella_tpu_torch.obs.scope import trace_scope
from pystella_tpu_torch.parallel.decomp import (
    MemberArray, ShardedArray, _device_of, _leaves, _tree_map, take_index)

__all__ = ["EnsembleStepper", "repack_members"]


def _host(x):
    """A leaf as a numpy array (bfloat16 widened to float32, exactly)."""
    if isinstance(x, ShardedArray):
        return x.decomp.gather_array(x)
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x)


def _member(a, i):
    """Member ``i`` of a batch leaf: a view of a tensor's entry, a
    ShardedArray of views of its blocks' entries, or the member of a
    MemberArray's slice."""
    return a[i] if isinstance(a, MemberArray) else take_index(a, i)


def _empty_like(a):
    if isinstance(a, MemberArray):
        return a.map(_empty_like)
    if isinstance(a, ShardedArray):
        return a.map(torch.empty_like)
    return torch.empty_like(a)


def _write_slot(batch_leaf, j, value):
    """Write one member's leaf ``value`` (numpy, a tensor, or a
    ShardedArray of the batch's decomposition) into slot ``j`` of a batch
    leaf, in place, cast to the batch's dtype."""
    if isinstance(batch_leaf, MemberArray):
        e, k = batch_leaf.locate(j)
        _write_slot(batch_leaf.parts[e], k, value)
    elif isinstance(batch_leaf, ShardedArray):
        blocks = (value.blocks if isinstance(value, ShardedArray)
                  else batch_leaf.decomp._blocks_of(
                      value, [b.device for b in batch_leaf.blocks]))
        for dst, src in zip(batch_leaf.blocks, blocks):
            dst[j].copy_(src)
    else:
        batch_leaf[j].copy_(torch.as_tensor(value))


def repack_members(batch, decomp):
    """Re-place a batched ``(members, ...)`` state onto ANOTHER ensemble
    decomposition (the member-axis repack of a re-mesh): the member count is
    unchanged, and the new slice count must divide it
    (:meth:`~pystella_tpu_torch.DomainDecomposition.shard_members` raises
    otherwise). Each leaf goes through the host once."""
    return _tree_map(decomp.shard_members, batch)


class EnsembleStepper:
    """Drive ``size`` members of a base stepper as one batch.

    :arg stepper: any :class:`~pystella_tpu_torch.Stepper` (the fused
        steppers included).
    :arg size: member count of every batch this wrapper steps.
    :arg decomp: optional ensemble
        :class:`~pystella_tpu_torch.DomainDecomposition` (over an
        :func:`~pystella_tpu_torch.ensemble_mesh`): :meth:`stack` then
        places the member axis over its slices.
    :arg via: ``"vmap"`` | ``"map"`` | ``"auto"`` (module docstring).
    :arg donate: write each step's result into the input batch (the batch
        is rebound ``batch = step(batch)`` in driver loops; off by default
        because the eviction path re-reads slots).
    :arg device: where a batch without ``decomp`` lives: default the
        stepper's ``device`` where it has one, else the GPU (``"cpu"`` runs
        the plain versions).
    """

    def __init__(self, stepper, size, decomp=None, via="auto",
                 donate=False, device=None):
        self.stepper = stepper
        self.size = int(size)
        if self.size < 1:
            raise ValueError(f"ensemble size must be >= 1, got {size}")
        self.decomp = decomp
        fused = hasattr(stepper, "_multi_step_impl")
        if via == "auto":
            via = "map" if fused else "vmap"
        if via not in ("vmap", "map"):
            raise ValueError(f"unknown batching tier {via!r}")
        if via == "vmap" and fused:
            raise ValueError("the fused steppers' kernels have no batching "
                             "rule; batch them with via='map'")
        self.via = via
        self._donate = bool(donate)
        if decomp is None:
            self.device = resolve_device(
                device if device is not None
                else getattr(stepper, "device", None))
        else:
            self.device = decomp.devices[0]
        #: the base stepper of each ensemble slice in the map tier: the
        #: stepper on the slice's (first) device
        self.steppers = ([stepper.on_device(decomp.slice_devices(e)[0])
                          for e in range(decomp.ensemble_devices)]
                         if via == "map" and decomp is not None
                         else [stepper])
        #: (nsteps, sentinel id, aux) -> the batched body
        self.bodies = {}

    # -- batch construction -------------------------------------------------

    def batch_args(self, tree):
        """Normalize an argument tree to batched leaves: a leaf whose
        leading axis is already ``size`` passes through, anything else is
        broadcast to a leading member axis. Non-tensor leaves become numpy
        arrays on the host (so a per-member SCALAR parameter is a
        ``(size,)`` array), tensors stay tensors."""
        def go(x):
            if isinstance(x, torch.Tensor):
                if x.ndim >= 1 and x.shape[0] == self.size:
                    return x
                return x.expand((self.size,) + tuple(x.shape))
            x = np.asarray(x)
            if x.ndim >= 1 and x.shape[0] == self.size:
                return x
            return np.broadcast_to(x, (self.size,) + x.shape)
        return _tree_map(go, tree)

    def stack(self, states):
        """One batched state from ``size`` member states (numpy or
        tensors), stacked along a new leading axis and placed: with an
        ensemble ``decomp`` stacked on the host and split over its slices
        (one device's copy of the whole population never exists), else on
        the ensemble's device."""
        states = list(states)
        if len(states) != self.size:
            raise ValueError(f"need {self.size} member states, "
                             f"got {len(states)}")
        if self.decomp is not None:
            return self.place(_tree_map(
                lambda *xs: np.stack([_host(x) for x in xs]), *states))

        def stack(*xs):
            if all(isinstance(x, torch.Tensor) for x in xs):
                return torch.stack([x.to(self.device) for x in xs])
            return torch.from_numpy(np.stack([_host(x) for x in xs])).to(
                self.device)
        return _tree_map(stack, *states)

    def place(self, batched):
        """Place an already-batched state: over the ensemble slices with a
        ``decomp``, else on the ensemble's device."""
        if self.decomp is not None:
            return _tree_map(self.decomp.shard_members, batched)
        return _tree_map(lambda a: (
            a if isinstance(a, torch.Tensor)
            else torch.from_numpy(np.array(a))).to(self.device), batched)

    def take_member(self, batched, index):
        """Host copy of member ``index``'s state, as numpy arrays (forces a
        sync: use at retire or checkpoint points, not in the hot loop)."""
        return _tree_map(lambda a: _host(_member(a, index)), batched)

    # -- the batched bodies -------------------------------------------------

    def _member_fns(self, nsteps):
        """The member body of each slice's stepper."""
        return [st._step_impl if nsteps == 1 else st.multi_step_fn(nsteps)
                for st in self.steppers]

    def _batched_impl(self, nsteps):
        """The batched chunk body ``(batch, t_vec, dt_vec, rhs_args) ->
        batch`` under the selected tier. It holds no reference to this
        wrapper, which caches it: a cycle would keep the base stepper's
        buffers until the cycle collector ran."""
        members = self._member_fns(int(nsteps))
        run = _run_vmap if self.via == "vmap" else _run_map
        size, donate = self.size, self._donate

        def body(batch, t, dt, rhs_args):
            with trace_scope("ensemble_step"):
                return run(members, size, donate, batch, t, dt, rhs_args)
        return body

    def _get_body(self, nsteps, sentinel=None, aux_arg=False):
        key = (int(nsteps), None if sentinel is None else id(sentinel),
               bool(aux_arg))
        fn = self.bodies.get(key)
        if fn is not None:
            return fn
        run = self._batched_impl(nsteps)
        if sentinel is None:
            fn = run
        else:
            def fn(batch, t, dt, rhs_args, aux=None):
                new = run(batch, t, dt, rhs_args)
                with trace_scope("sentinel"):
                    return new, sentinel.compute_members(new, aux)
        self.bodies[key] = fn
        return fn

    def health_jit(self, sentinel):
        """The cached step + health body for ``sentinel``, ``(batch, t_vec,
        dt_vec, rhs_args, aux) -> (batch, health_matrix)`` (the JAX
        package's jitted executable; here the plain callable)."""
        return self._get_body(1, sentinel, aux_arg=True)

    # -- dispatch ------------------------------------------------------------

    def _norm(self, t, dt, rhs_args):
        dt = dt if dt is not None else self.stepper.dt
        if dt is None:
            raise ValueError("no dt: pass dt= or construct the base "
                             "stepper with one")
        return (self.batch_args(t), self.batch_args(dt),
                self.batch_args(rhs_args or {}))

    def step(self, batch, t=0.0, dt=None, rhs_args=None):
        """Advance every member one full RK step. ``t``/``dt`` scalars or
        ``(size,)`` arrays; ``rhs_args`` leaves scalar or member-batched."""
        t, dt, rhs_args = self._norm(t, dt, rhs_args)
        return self._get_body(1)(batch, t, dt, rhs_args)

    def multi_step(self, batch, nsteps, t=0.0, dt=None, rhs_args=None,
                   sentinel=None):
        """Advance every member ``nsteps`` steps as one chunk (the fused
        tier pairs stages across step boundaries inside each member, exactly
        as its single-run ``multi_step`` does). With ``sentinel`` (a
        :class:`~pystella_tpu_torch.obs.Sentinel` built for ONE member's
        state), also returns the ``(size, len(vector))`` health MATRIX of
        the new batch (one K15 read of each leaf for the batch), enqueued
        right behind the chunk with no host sync."""
        t, dt, rhs_args = self._norm(t, dt, rhs_args)
        return self._get_body(int(nsteps), sentinel)(batch, t, dt,
                                                     rhs_args)

    def step_with_health(self, batch, sentinel, t=0.0, dt=None,
                         rhs_args=None, aux=None):
        """One step and the member-axis health matrix (``aux`` leaves
        scalar or member-batched)."""
        t, dt, rhs_args = self._norm(t, dt, rhs_args)
        aux = self.batch_args(aux or {})
        return self.health_jit(sentinel)(batch, t, dt, rhs_args, aux)

    # -- eviction / slot management -----------------------------------------

    def write_member(self, batch, index, member_state):
        """A batch in which slot ``index`` holds ``member_state`` (cast to
        the batch's dtypes) and every other slot is the input's, bit for
        bit: the evict-and-resample write. The input batch is left intact
        (its slots copied first) unless ``donate=True``, when the slot is
        written in place."""
        with trace_scope("ensemble_evict"):
            out = batch if self._donate else _tree_map(_clone, batch)
            _tree_map(lambda o, m: _write_slot(o, int(index), m), out,
                      member_state)
            return out


def _slices(batch, size):
    """``[(member range, state part), ...]``, one per ensemble slice (a
    batch without ``decomp`` is one slice)."""
    first = _leaves(batch)[0]
    if not isinstance(first, MemberArray):
        return [((0, size), batch)]
    m = first.members_per_slice
    return [((e * m, (e + 1) * m), _tree_map(lambda a: a.parts[e], batch))
            for e in range(len(first.parts))]


def _run_map(members, size, donate, batch, t, dt, rhs_args):
    """Member ``i`` through the body of its slice (``members``: one body a
    slice, the slices of ``size // len(members)`` members each)."""
    out = batch if donate else _tree_map(_empty_like, batch)
    per_slice = size // len(members)
    for i in range(size):
        st = _tree_map(lambda a: _member(a, i), batch)
        new = members[i // per_slice](st, t[i], dt[i],
                                      _tree_map(lambda a: a[i], rhs_args))
        # a fused stepper returns its own buffers, which the next
        # member's call overwrites: the result is copied at once
        _tree_map(lambda o, n: _write_slot(o, i, n), out, new)
    return out


def _run_vmap(members, size, donate, batch, t, dt, rhs_args):
    """One vmapped call of the member body a slice (the body follows its
    operands' device)."""
    member, outs = members[0], []
    for (lo, hi), part in _slices(batch, size):
        dev = _device_of(_leaves(part)[0])

        def vec(a):
            a = a[lo:hi]
            if isinstance(a, torch.Tensor):
                return a.to(dev)
            return torch.tensor(np.asarray(a), device=dev)
        outs.append(torch.func.vmap(member)(
            part, vec(t), vec(dt), _tree_map(vec, rhs_args)))
    if len(outs) == 1 and not isinstance(_leaves(batch)[0], MemberArray):
        out = outs[0]
    else:
        out = _tree_map(lambda like, *ps: MemberArray(ps, like.decomp),
                        batch, *outs)
    if donate:
        _tree_map(_copy_into, batch, out)
        return batch
    return out


def _clone(a):
    if isinstance(a, MemberArray):
        return a.map(_clone)
    if isinstance(a, ShardedArray):
        return a.map(torch.clone)
    return a.clone()


def _copy_into(dst, src):
    if isinstance(dst, MemberArray):
        for d, s in zip(dst.parts, src.parts):
            _copy_into(d, s)
    elif isinstance(dst, ShardedArray):
        for d, s in zip(dst.blocks, src.blocks):
            d.copy_(s)
    else:
        dst.copy_(src)
