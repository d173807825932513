"""Carry state across from the JAX package and back.

The system has no weights: what carries across is the state and carry
dicts (``(F, X, Y, Z)`` arrays, the same layout in both packages), the
expansion background (``a``, ``adot``, ``mpl``), the tableau coefficients
(copied digit for digit in :mod:`.step`) and the model (the same
``potential`` callable applied to each package's own ``DynamicField``). A
JAX array arrives here as a numpy array (``np.asarray``) and leaves as
one.
"""

from __future__ import annotations

import numpy as np
import torch

from pystella_tpu_torch._device import resolve_device, torch_dtype
from pystella_tpu_torch.models.expansion import Expansion
from pystella_tpu_torch.parallel.decomp import ShardedArray
from pystella_tpu_torch.step import LowStorageRK54, _tree_map

__all__ = ["state_from_numpy", "carry_from_numpy", "to_numpy",
           "expansion_from_numpy", "shard_state"]


def _tensor(v, dtype, device):
    """One array -> a tensor. A bfloat16 array (what ``np.asarray`` of a
    JAX bf16 array gives) goes through float32, which ``torch.tensor``
    takes and which holds every bfloat16 value exactly, so the round trip
    changes no bit; a tensor (a bfloat16 carry included) is copied as it
    is."""
    if isinstance(v, torch.Tensor):
        return v.detach().to(device=device, dtype=dtype or v.dtype,
                             copy=True).contiguous()
    a = np.asarray(v)
    if a.dtype.name == "bfloat16":
        t = torch.tensor(a.astype(np.float32), device=device)
        return t.to(torch.bfloat16 if dtype is None else dtype)
    return torch.tensor(a, dtype=dtype, device=device)


def state_from_numpy(state, device=None, dtype=None):
    """A dict of arrays -> a dict of contiguous tensors on ``device``
    (default the GPU), copied, in ``dtype`` (default: the arrays' own;
    bfloat16 arrays included)."""
    dev = resolve_device(device)
    dt = None if dtype is None else torch_dtype(dtype)
    return {k: _tensor(v, dt, dev) for k, v in state.items()}


def shard_state(decomp, state, dtype=None):
    """A dict of global arrays (numpy, or tensors; a JAX array through
    ``np.asarray`` by the caller) -> a dict of
    :class:`~pystella_tpu_torch.parallel.ShardedArray` s over ``decomp``,
    each block copied to its rank's device, in ``dtype`` (default: the
    arrays' own; bfloat16 arrays through float32, exactly): the state
    carrier of a sharded run, the scalar system's or the GW system's
    (hij, dhijdt: six components a block) alike."""
    dt = None if dtype is None else torch_dtype(dtype)
    return {k: decomp.shard(_tensor(v, dt, "cpu")) for k, v in state.items()}


def carry_from_numpy(carry, device=None, dtype=None):
    """A ``(state, k)`` carry of array dicts -> the same of tensors."""
    state, k = carry
    return (state_from_numpy(state, device, dtype),
            state_from_numpy(k, device, dtype))


def expansion_from_numpy(values, Stepper=LowStorageRK54, dtype=np.float64):
    """An :class:`~pystella_tpu_torch.Expansion` holding the background
    ``values`` (``{"a", "adot", "mpl"}``, e.g. read off the JAX package's
    ``Expansion``), with ``hubble = adot / a`` and a fresh stage carry."""
    exp = Expansion(0.0, Stepper, mpl=float(values["mpl"]), dtype=dtype)
    exp.a = exp.dtype.type(values["a"])
    exp.adot = exp.dtype.type(values["adot"])
    exp.hubble = exp.adot / exp.a
    return exp


def _array(t):
    """One tensor (or sharded array, gathered) -> a numpy array. numpy has
    no bfloat16 (``.numpy()`` refuses one), so a bfloat16 tensor is widened
    to float32, exactly."""
    if isinstance(t, ShardedArray):
        return t.decomp.gather_array(t)
    if not isinstance(t, torch.Tensor):
        return np.asarray(t)
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def to_numpy(tree):
    """Tensors (in dicts, lists, tuples) -> numpy arrays on the host
    (bfloat16 ones as float32); a
    :class:`~pystella_tpu_torch.parallel.ShardedArray` comes back whole, so
    ``to_numpy`` of a sharded state (scalar or GW) is the inverse of
    :func:`shard_state`."""
    return _tree_map(_array, tree)
