"""Lattice-wide reductions and field statistics.

PyTorch counterpart of ``pystella_tpu/ops/reduction.py`` on one device.
Each reduction is a plain ``torch`` reduction over the whole lattice tensor
(the JAX package's are ``jnp`` reductions under ``jit``); results come back
to the host as numpy values, as there. No Pallas kernel is involved, so
there is no kernel here either.

A :class:`~pystella_tpu_torch.parallel.ShardedArray` argument is reduced
block by block, and the per-block partials are combined in rank order (the
JAX package's reductions over a sharded global array, where XLA inserts
the cross-device reduce).
"""

from __future__ import annotations

import numpy as np
import torch

from pystella_tpu_torch import field as _field
from pystella_tpu_torch.parallel.decomp import ShardedArray

__all__ = ["Reduction", "FieldStatistics"]

_OPS = {
    "avg": torch.sum,  # divided by grid_size afterwards
    "sum": torch.sum,
    "prod": torch.prod,
    "max": torch.max,
    "min": torch.min,
}


def _normalize_input(input):
    """Accept a dict, a Sector (uses ``.reducers``), or a list of Sectors."""
    if hasattr(input, "reducers"):
        return dict(input.reducers)
    if isinstance(input, (list, tuple)):
        merged = {}
        for sector in input:
            merged.update(sector.reducers)
        return merged
    return dict(input)


def _to_numpy(v):
    return v.detach().cpu().numpy()


#: how per-block partials of each op combine
_COMBINE = {"avg": "sum", "sum": "sum", "prod": "prod", "max": "max",
            "min": "min"}


def _reduce(env, fn, op):
    """``op``-reduction of ``fn(env)`` over the lattice: directly, or, when
    ``env`` holds :class:`ShardedArray` s, block by block (a value with no
    lattice axes once, from rank 0) with the partials combined in rank
    order."""
    sharded = [v for v in env.values() if isinstance(v, ShardedArray)]
    if not sharded:
        return _OPS[op](torch.as_tensor(fn(env)))
    decomp = sharded[0].decomp
    parts = []
    for r in range(decomp.nshards):
        arr = torch.as_tensor(fn({k: v.blocks[r] if isinstance(
            v, ShardedArray) else v for k, v in env.items()}))
        if arr.ndim < 3:
            return _OPS[op](arr)
        parts.append(_OPS[op](arr))
    return decomp._combine(parts, _COMBINE[op])


class Reduction:
    """Reduces symbolic expressions over the lattice.

    :arg input: dict mapping names to an expression, an ``(expr, op)``
        tuple, or a list of either; or a Sector / list of Sectors whose
        ``reducers`` are used. Ops are ``"avg"`` (the default: the sum
        divided by the grid size), ``"sum"``, ``"prod"``, ``"max"`` and
        ``"min"``.
    :arg grid_size: the divisor of ``"avg"``; default the number of sites
        of the first lattice (>= 3-D) argument.
    :arg callback: post-processes the result dict (e.g.
        :func:`~pystella_tpu_torch.models.sectors.get_rho_and_p`).

    Call with the expressions' names as keywords (``f=``, ``dfdt=``,
    ``lap_f=``, ``a=``, ...); returns a dict of numpy values, one per name
    (stacked when the name has several entries).
    """

    def __init__(self, input, grid_size=None, callback=None):
        self.callback = callback
        self.grid_size = grid_size

        self.reducers = {}
        for name, val in _normalize_input(input).items():
            if not isinstance(val, list):
                val = [val]
            entries = []
            for item in val:
                if isinstance(item, tuple):
                    expr, op = item
                else:
                    expr, op = item, "avg"
                if op not in _OPS:
                    raise ValueError(f"unknown reduction op {op}")
                entries.append((expr, op))
            self.reducers[name] = entries

    def __call__(self, **env):
        first = next((a for a in env.values()
                      if getattr(a, "ndim", 0) >= 3), None)
        if first is None:
            raise ValueError(
                "Reduction needs at least one lattice (>= 3-D) array "
                f"argument to infer the grid size; got only scalars/"
                f"low-rank values for {sorted(env)}; pass grid_size= at "
                "construction or include a lattice array")
        grid_size = self.grid_size or int(np.prod(first.shape[-3:]))
        result = {}
        for name, entries in self.reducers.items():
            vals = []
            for expr, op in entries:
                if isinstance(expr, _field.Expr):
                    def fn(e, expr=expr):
                        return _field.evaluate(expr, e)
                else:
                    def fn(e, expr=expr):
                        return expr(e) if callable(expr) else expr
                red = _reduce(env, fn, op)
                if op == "avg":
                    red = red / grid_size
                vals.append(red)
            out = torch.stack(vals) if len(vals) > 1 else vals[0]
            result[name] = _to_numpy(out)
        if self.callback is not None:
            result = self.callback(result)
        return result


class FieldStatistics(Reduction):
    """Mean and variance (plus optional extrema) of a field, per outer-axis
    component.

    Call with ``stats(f=tensor)`` (or a :class:`ShardedArray`, reduced
    block by block, the partials combined in rank order); returns a dict
    with keys ``mean``,
    ``variance`` and, if requested, ``max``, ``min``, ``abs_max``,
    ``abs_min``, each a numpy array over the outer axes.
    """

    def __init__(self, max_min=False, grid_size=None):
        self.max_min = max_min
        self.callback = None
        self.grid_size = grid_size

    def __call__(self, f):
        grid_size = self.grid_size or int(np.prod(f.shape[-3:]))
        lat = (-3, -2, -1)
        if isinstance(f, ShardedArray):
            blocks, combine = f.blocks, f.decomp._combine
        else:
            blocks = [f]

            def combine(parts, op):
                return parts[0]

        def red(fn, op):
            return combine([fn(b) for b in blocks], op)
        mean = red(lambda b: torch.sum(b, dim=lat), "sum") / grid_size
        mean_sq = red(lambda b: torch.sum(b * b, dim=lat), "sum") / grid_size
        out = {"mean": mean, "variance": mean_sq - mean * mean}
        if self.max_min:
            out["max"] = red(lambda b: torch.amax(b, dim=lat), "max")
            out["min"] = red(lambda b: torch.amin(b, dim=lat), "min")
            out["abs_max"] = red(lambda b: torch.amax(torch.abs(b), dim=lat),
                                 "max")
            out["abs_min"] = red(lambda b: torch.amin(torch.abs(b), dim=lat),
                                 "min")
        return {k: _to_numpy(v) for k, v in out.items()}
