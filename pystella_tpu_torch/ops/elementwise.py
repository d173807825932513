"""Elementwise maps of symbolic assignments over the lattice.

PyTorch counterpart of ``pystella_tpu/ops/elementwise.py``. There the
instructions are traced through ``field.evaluate`` into one ``jax.jit``;
here they are evaluated eagerly with the port's
:func:`~pystella_tpu_torch.field.evaluate`, in the same order: the
temporaries first, then the map instructions. No Pallas kernel is
involved, so there is no kernel here either.

:class:`~pystella_tpu_torch.parallel.ShardedArray` inputs are evaluated
block by block (:func:`~pystella_tpu_torch.parallel.blockwise`), so each
block's result is the single-device result at its sites, bit for bit.
"""

from __future__ import annotations

from pystella_tpu_torch import field as _field
from pystella_tpu_torch.parallel.decomp import blockwise

__all__ = ["ElementWiseMap"]


def _assignee_name(key):
    if isinstance(key, _field.Field):
        return key.name
    if isinstance(key, str):
        return key
    raise TypeError(f"assignees must be Field or str, got {type(key)}")


class ElementWiseMap:
    """Maps a dict of ``{assignee: expression}`` over the lattice.

    :arg map_instructions: dict whose keys are
        :class:`~pystella_tpu_torch.Field` s (or strings) naming outputs
        and whose values are symbolic expressions (or callables
        ``env -> tensor``).
    :arg tmp_instructions: like ``map_instructions`` but for intermediate
        quantities usable by later expressions.

    Calling the map with keyword tensors, :class:`ShardedArray` s or
    scalars evaluates all instructions and returns a dict of the outputs.
    """

    def __init__(self, map_instructions, tmp_instructions=None, **kwargs):
        self.map_instructions = [(_assignee_name(k), v)
                                 for k, v in dict(map_instructions).items()]
        self.tmp_instructions = [
            (_assignee_name(k), v)
            for k, v in dict(tmp_instructions or {}).items()]

    @staticmethod
    def _eval(expr, env):
        if callable(expr) and not isinstance(expr, _field.Expr):
            return expr(env)
        return _field.evaluate(expr, env)

    def _run(self, env):
        env = dict(env)
        for name, expr in self.tmp_instructions:
            env[name] = self._eval(expr, env)
        return {name: self._eval(expr, env)
                for name, expr in self.map_instructions}

    def __call__(self, **kwargs):
        return blockwise(self._run, kwargs)
