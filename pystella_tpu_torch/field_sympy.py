"""Sympy interoperation for the symbolic field layer.

The port's own copy of the JAX package's sympy bridge
(``pystella_tpu/field_sympy.py``), on :mod:`pystella_tpu_torch.field`:
:func:`to_sympy` / :func:`from_sympy` convert losslessly (fields, indexed
fields and lattice shifts survive the round trip), and :func:`simplify`
runs an expression through ``sympy.simplify`` so that sympy's
simplification machinery can be applied to right-hand sides before they
are evaluated or printed into a kernel.

sympy is imported lazily: it is not a dependency of the rest of the port,
and without it this module raises a clear ``ImportError`` when used.
"""

from __future__ import annotations

import numbers

from pystella_tpu_torch.field import (
    Call, Constant, Field, Indexed, Power, Product,
    Quotient, Shifted, Sum, Var, _wrap,
)

__all__ = ["to_sympy", "from_sympy", "simplify", "SympyField",
           "reset_field_registry"]


def _sympy():
    try:
        import sympy
    except ImportError as err:  # pragma: no cover
        raise ImportError(
            "sympy is required for pystella_tpu_torch.field_sympy") from err
    return sympy


#: maps symbol names created by :func:`to_sympy` back to their Fields so
#: :func:`from_sympy` can restore them. Process-global by necessity (sympy
#: symbols carry only a name); :func:`simplify` scopes its own additions,
#: and :func:`reset_field_registry` clears the map for long-lived processes
#: doing many unrelated conversions.
_FIELD_REGISTRY: dict = {}


def reset_field_registry():
    """Clear the symbol→Field registry used by the sympy round trip.

    After a reset, sympy expressions produced by *earlier* ``to_sympy``
    calls can no longer be converted back with field restoration (their
    symbols fall back to plain :class:`~pystella_tpu_torch.field.Var`)."""
    _FIELD_REGISTRY.clear()


def SympyField(field, index=(), shift=()):
    """A sympy leaf that remembers the originating :class:`Field`.

    A plain ``sympy.Symbol`` with a registry entry: sympy's simplification
    treats it atomically, and :func:`from_sympy` restores the Field (and
    its index / lattice shift) from the registry.
    """
    sym = _sympy()
    name = field.name
    if index:
        name += "__idx__" + "_".join(map(str, index))
    if shift and any(shift):
        name += "__sft__" + "_".join(
            f"m{-s}" if s < 0 else str(s) for s in shift)
    s = sym.Symbol(name)
    prior = _FIELD_REGISTRY.get(name)
    if prior is not None and prior[0]._key() != field._key():
        raise ValueError(
            f"sympy round-trip name collision: two distinct Fields both "
            f"map to symbol {name!r} ({prior[0]!r} vs {field!r}); rename "
            f"one of them")
    _FIELD_REGISTRY[name] = (field, tuple(index), tuple(shift))
    return s


# math-function mapping: both directions map by name onto the field
# layer's Call functions
_TO_SYMPY_FUNCS = {
    "exp": "exp", "log": "log", "sin": "sin", "cos": "cos", "tan": "tan",
    "sinh": "sinh", "cosh": "cosh", "tanh": "tanh", "sqrt": "sqrt",
    "fabs": "Abs", "sign": "sign", "arcsin": "asin", "arccos": "acos",
    "arctan": "atan",
}
_FROM_SYMPY_FUNCS = {v: k for k, v in _TO_SYMPY_FUNCS.items()}


def to_sympy(expr):
    """Convert a field-layer expression to a sympy expression.

    """
    sym = _sympy()
    expr = _wrap(expr)

    if isinstance(expr, Constant):
        if isinstance(expr.value, numbers.Number):
            return sym.sympify(expr.value)
        raise TypeError("cannot convert array-valued Constant to sympy")
    if isinstance(expr, Indexed):
        return SympyField(expr.field, expr.index)
    if isinstance(expr, Field):
        return SympyField(expr)
    if isinstance(expr, Shifted):
        child = expr.child
        if isinstance(child, Indexed):
            return SympyField(child.field, child.index, expr.shift)
        if isinstance(child, Field):
            return SympyField(child, (), expr.shift)
        raise TypeError(
            "only shifted Field/Indexed leaves convert to sympy")
    if isinstance(expr, Var):
        return sym.Symbol(expr.name)
    if isinstance(expr, Sum):
        return sym.Add(*(to_sympy(c) for c in expr.children))
    if isinstance(expr, Product):
        return sym.Mul(*(to_sympy(c) for c in expr.children))
    if isinstance(expr, Quotient):
        return to_sympy(expr.num) / to_sympy(expr.den)
    if isinstance(expr, Power):
        return sym.Pow(to_sympy(expr.base), to_sympy(expr.exponent))
    if isinstance(expr, Call):
        fn = getattr(sym, _TO_SYMPY_FUNCS[expr.func])
        return fn(*(to_sympy(a) for a in expr.args))
    raise TypeError(f"cannot convert {type(expr)} to sympy")


def from_sympy(s_expr):
    """Convert a sympy expression back to the field layer.

    Fields created by :func:`to_sympy` are restored exactly (same
    ``Field`` instance semantics, including indices).
    """
    sym = _sympy()

    if isinstance(s_expr, sym.Symbol):
        entry = _FIELD_REGISTRY.get(s_expr.name)
        if entry is not None:
            field, index, shift = entry
            out = field[index] if index else field
            if shift and any(shift):
                out = Shifted(out, shift)
            return out
        return Var(s_expr.name)
    if isinstance(s_expr, (sym.Integer, int)):
        return Constant(int(s_expr))
    if isinstance(s_expr, sym.Rational):
        return Quotient(Constant(int(s_expr.p)), Constant(int(s_expr.q)))
    if isinstance(s_expr, (sym.Float, float)):
        return Constant(float(s_expr))
    if s_expr is sym.pi:
        import math
        return Constant(math.pi)
    if isinstance(s_expr, sym.Add):
        return Sum.make(*(from_sympy(a) for a in s_expr.args))
    if isinstance(s_expr, sym.Mul):
        return Product.make(*(from_sympy(a) for a in s_expr.args))
    if isinstance(s_expr, sym.Pow):
        return Power(from_sympy(s_expr.base), from_sympy(s_expr.exp))
    if isinstance(s_expr, sym.Function):
        name = type(s_expr).__name__
        if name in _FROM_SYMPY_FUNCS:
            args = tuple(from_sympy(a) for a in s_expr.args)
            return Call(_FROM_SYMPY_FUNCS[name], args)
        raise ValueError(f"no mapping for sympy function {name}")
    if s_expr.is_number:
        return Constant(float(s_expr))
    raise TypeError(f"cannot convert {type(s_expr)} from sympy")


def simplify(expr, sympify=None):
    """Simplify an expression via sympy.

    :arg sympify: optional callable applied to the sympy form (defaults to
        ``sympy.simplify``); pass e.g. ``sympy.expand`` or
        ``sympy.factor`` for a different canonicalization.
    """
    sym = _sympy()
    fn = sympify if sympify is not None else sym.simplify
    # scope this call's registry additions: the round trip completes inside
    # the call, so its temporary symbol→Field entries need not outlive it
    before = set(_FIELD_REGISTRY)
    try:
        return from_sympy(fn(to_sympy(expr)))
    finally:
        for name in set(_FIELD_REGISTRY) - before:
            del _FIELD_REGISTRY[name]
