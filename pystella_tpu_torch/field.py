"""Lightweight symbolic field layer.

PyTorch counterpart of ``pystella_tpu/field.py``: users write symbolic
right-hand sides (``{f.dot: f.lap - m2 * f}``) or potentials, ``diff``
differentiates them symbolically, and ``evaluate`` computes them on torch
tensors. The fused CUDA kernels take the same expressions through
:mod:`pystella_tpu_torch.ops.codegen`, which prints them as C.

Grid-less by construction: an expression evaluates against an *environment*
dict mapping field names to tensors; lattice axes broadcast naturally.
"""

from __future__ import annotations

import numbers
from functools import reduce

import torch

# ---------------------------------------------------------------------------
# expression nodes
# ---------------------------------------------------------------------------

class Expr:
    """Base class for symbolic expressions with operator overloading."""

    _fields: tuple[str, ...] = ()

    def __add__(self, other):
        return Sum.make(self, other)

    def __radd__(self, other):
        return Sum.make(other, self)

    def __sub__(self, other):
        return Sum.make(self, Product.make(-1, other))

    def __rsub__(self, other):
        return Sum.make(other, Product.make(-1, self))

    def __mul__(self, other):
        return Product.make(self, other)

    def __rmul__(self, other):
        return Product.make(other, self)

    def __truediv__(self, other):
        return Quotient(self, _wrap(other))

    def __rtruediv__(self, other):
        return Quotient(_wrap(other), self)

    def __pow__(self, other):
        return Power(self, _wrap(other))

    def __rpow__(self, other):
        return Power(_wrap(other), self)

    def __neg__(self):
        return Product.make(-1, self)

    def __pos__(self):
        return self

    def _key(self):
        return (type(self).__name__,
                tuple(getattr(self, f) for f in self._fields))

    def __eq__(self, other):
        if self is other:
            return True
        return isinstance(other, Expr) and self._key() == other._key()

    def __hash__(self):
        return hash(self._key())

    def __repr__(self):
        args = ", ".join(repr(getattr(self, f)) for f in self._fields)
        return f"{type(self).__name__}({args})"


def _wrap(x):
    if isinstance(x, Expr):
        return x
    if isinstance(x, (numbers.Number, torch.Tensor)) or hasattr(x, "shape"):
        return Constant(x)
    raise TypeError(f"cannot convert {type(x)} to Expr")


class Constant(Expr):
    _fields = ("value",)

    def __init__(self, value):
        self.value = value

    def _key(self):
        v = self.value
        if isinstance(v, numbers.Number):
            return ("Constant", v)
        return ("Constant", id(v))

    def __repr__(self):
        return repr(self.value)


class Sum(Expr):
    _fields = ("children",)

    def __init__(self, children):
        self.children = tuple(children)

    @staticmethod
    def make(*terms):
        flat = []
        for t in terms:
            t = _wrap(t)
            if isinstance(t, Sum):
                flat.extend(t.children)
            elif isinstance(t, Constant) and isinstance(t.value, numbers.Number) \
                    and t.value == 0:
                continue
            else:
                flat.append(t)
        if not flat:
            return Constant(0)
        if len(flat) == 1:
            return flat[0]
        return Sum(flat)


class Product(Expr):
    _fields = ("children",)

    def __init__(self, children):
        self.children = tuple(children)

    @staticmethod
    def make(*factors):
        flat = []
        for f in factors:
            f = _wrap(f)
            if isinstance(f, Product):
                flat.extend(f.children)
            elif isinstance(f, Constant) and isinstance(f.value, numbers.Number):
                if f.value == 0:
                    return Constant(0)
                if f.value == 1:
                    continue
                flat.append(f)
            else:
                flat.append(f)
        if not flat:
            return Constant(1)
        if len(flat) == 1:
            return flat[0]
        return Product(flat)


class Quotient(Expr):
    _fields = ("num", "den")

    def __init__(self, num, den):
        self.num, self.den = num, den


class Power(Expr):
    _fields = ("base", "exponent")

    def __init__(self, base, exponent):
        self.base, self.exponent = base, exponent


class Call(Expr):
    """Application of a named elementwise function (exp, sin, ...)."""

    _fields = ("func", "args")

    def __init__(self, func, args):
        self.func = func
        self.args = tuple(args)


class Var(Expr):
    """A free scalar variable (time, parameters)."""

    _fields = ("name",)

    def __init__(self, name):
        self.name = name

    def __repr__(self):
        return self.name


class Field(Expr):
    """A symbolic field.

    Mirrors the role of the reference ``Field``
    (pystella's field/__init__.py:52-194) minus all halo/offset/
    index bookkeeping: arrays are unpadded and the operators own indexing.

    :arg name: key under which the field's array appears in evaluation
        environments.
    :arg shape: *outer* (component) shape, e.g. ``(nscalars,)``. The lattice
        axes are implicit and trail the outer axes in the backing array.
    """

    _fields = ("name", "shape")

    def __init__(self, name, shape=()):
        self.name = name
        self.shape = tuple(shape)

    def __getitem__(self, idx):
        if not isinstance(idx, tuple):
            idx = (idx,)
        if len(idx) > len(self.shape):
            raise IndexError(f"too many indices for Field {self.name}")
        return Indexed(self, idx)

    def __iter__(self):
        if not self.shape:
            raise TypeError("cannot iterate scalar Field")
        return (self[i] for i in range(self.shape[0]))

    def __repr__(self):
        return self.name


class Indexed(Expr):
    _fields = ("field", "index")

    def __init__(self, field, index):
        self.field = field
        self.index = tuple(index)

    def _key(self):
        return ("Indexed", self.field._key(), self.index)

    def __repr__(self):
        return f"{self.field.name}[{', '.join(map(str, self.index))}]"


class Shifted(Expr):
    """A field (or indexed component) evaluated at a lattice-site offset:
    ``Shifted(f, (1, 0, 0))`` is the reference's ``f[i+1, j, k]``
    (``shift_fields``, pystella's field/__init__.py:471-491).
    Under :func:`evaluate` this is a periodic ``torch.roll`` over the three
    trailing lattice axes — the array-level meaning of a subscript shift on
    a periodic lattice. Like the reference construct (which lives inside
    kernels whose halos were pre-exchanged), this evaluates on *unsharded*
    (or replicated) lattice axes; on sharded meshes use the
    halo-exchanging operators (``FiniteDifferencer``), whose ``ppermute``
    pads play the role shifts play symbolically."""

    _fields = ("child", "shift")

    def __init__(self, child, shift):
        self.child = child
        self.shift = tuple(int(s) for s in shift)
        if len(self.shift) != 3:
            raise ValueError("shift must be a 3-tuple of site offsets")

    def _key(self):
        return ("Shifted", self.child._key(), self.shift)

    def __repr__(self):
        return f"Shifted({self.child!r}, {self.shift})"


def shift_fields(expr, shift):
    """Return ``expr`` with every :class:`Field`/:class:`Indexed` leaf read
    at lattice offset ``shift`` (a 3-tuple of site counts). Reference-API
    analog of ``shift_fields`` (field/__init__.py:471-491), with array
    semantics instead of subscript rewriting: shifted leaves evaluate to
    periodic rolls. Scalars (:class:`Var`, constants) are unaffected."""
    shift = tuple(int(s) for s in shift)
    expr = _wrap(expr)
    if not any(shift):
        return expr

    def walk(e):
        e = _wrap(e)
        if isinstance(e, (Field, Indexed)):
            return Shifted(e, shift)
        if isinstance(e, Shifted):
            total = tuple(a + b for a, b in zip(e.shift, shift))
            return Shifted(e.child, total) if any(total) else e.child
        if isinstance(e, Sum):
            return Sum.make(*(walk(c) for c in e.children))
        if isinstance(e, Product):
            return Product.make(*(walk(c) for c in e.children))
        if isinstance(e, Quotient):
            return Quotient(walk(e.num), walk(e.den))
        if isinstance(e, Power):
            return Power(walk(e.base), walk(e.exponent))
        if isinstance(e, Call):
            return Call(e.func, tuple(walk(a) for a in e.args))
        return e

    return walk(expr)


class DynamicField(Field):
    """A field with bundled time-derivative / Laplacian / gradient fields.

    Analog of the reference ``DynamicField``
    (pystella's field/__init__.py:204-300): ``.dot`` is the time
    derivative (named ``d{name}dt``), ``.lap`` the Laplacian (``lap_{name}``),
    ``.pd`` the spatial gradient (``d{name}dx``, one extra trailing component
    axis of length ``dim``).
    """

    def __init__(self, name, shape=(), dim=3,
                 dot=None, lap=None, pd=None):
        super().__init__(name, shape)
        self.dim = dim
        self.dot = dot if dot is not None else Field(f"d{name}dt", shape)
        self.lap = lap if lap is not None else Field(f"lap_{name}", shape)
        self.pd = pd if pd is not None else Field(f"d{name}dx", shape + (dim,))

    def d(self, *args):
        """``f.d(mu)`` or ``f.d(i, mu)``: mu=0 → dot, mu=1..dim → pd[mu-1]."""
        *outer, mu = args
        outer = tuple(outer)
        if mu == 0:
            return self.dot[outer] if outer else self.dot
        pd_idx = outer + (mu - 1,)
        return self.pd[pd_idx]


# ---------------------------------------------------------------------------
# math functions
# ---------------------------------------------------------------------------

_FUNCS = {
    "exp": torch.exp, "log": torch.log, "sin": torch.sin, "cos": torch.cos,
    "tan": torch.tan, "sinh": torch.sinh, "cosh": torch.cosh,
    "tanh": torch.tanh, "sqrt": torch.sqrt, "fabs": torch.abs,
    "sign": torch.sign, "arcsin": torch.arcsin, "arccos": torch.arccos,
    "arctan": torch.arctan,
}


def _apply(name, x):
    """``_FUNCS[name]`` on a tensor, or on a Python number (computed in
    float64, as a 0-d tensor that does not promote lattice tensors)."""
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(x, dtype=torch.float64)
    return _FUNCS[name](x)


def _make_func(name):
    def fn(x):
        if isinstance(x, Expr):
            return Call(name, (x,))
        return _apply(name, x)
    fn.__name__ = name
    return fn


exp = _make_func("exp")
log = _make_func("log")
sin = _make_func("sin")
cos = _make_func("cos")
tan = _make_func("tan")
sinh = _make_func("sinh")
cosh = _make_func("cosh")
tanh = _make_func("tanh")
sqrt = _make_func("sqrt")
fabs = _make_func("fabs")
sign = _make_func("sign")


# ---------------------------------------------------------------------------
# evaluation
# ---------------------------------------------------------------------------

def evaluate(expr, env):
    """Evaluate ``expr`` against ``env`` (dict: field/var name -> tensor or
    number), in the same operation order as the JAX package's
    ``evaluate``: sums and products reduce left to right, and small integer
    powers expand to repeated multiplication."""
    if isinstance(expr, numbers.Number):
        return expr
    if isinstance(expr, Constant):
        return expr.value
    if isinstance(expr, Indexed):
        return env[expr.field.name][expr.index]
    if isinstance(expr, Field):
        return env[expr.name]
    if isinstance(expr, Var):
        return env[expr.name]
    if isinstance(expr, Shifted):
        val = evaluate(expr.child, env)
        # subscript shift f[i+s] reads site i+s, i.e. roll by -s; periodic
        # wrap matches the lattice boundary conditions. A homogeneous value
        # (fewer than 3 lattice axes, e.g. a scalar background) is shift-
        # invariant, preserving the "lattice axes broadcast" contract.
        if getattr(val, "ndim", 0) < 3:
            return val
        return torch.roll(val, tuple(-s for s in expr.shift),
                          dims=(-3, -2, -1))
    if isinstance(expr, Sum):
        return reduce(lambda a, b: a + b,
                      (evaluate(c, env) for c in expr.children))
    if isinstance(expr, Product):
        return reduce(lambda a, b: a * b,
                      (evaluate(c, env) for c in expr.children))
    if isinstance(expr, Quotient):
        num, den = evaluate(expr.num, env), evaluate(expr.den, env)
        # a division, as the kernels and the JAX package compute it: PyTorch
        # multiplies by the reciprocal of a Python number (on CUDA), and
        # divides a Python number by a tensor as the tensor's reciprocal
        # times it (everywhere) -- one rounding more. A 0-d tensor of the
        # other operand's dtype (the kernels' T(c)) makes both a division.
        if (isinstance(num, torch.Tensor) and num.is_floating_point()
                and isinstance(den, numbers.Number)):
            den = torch.tensor(den, dtype=num.dtype, device=num.device)
        elif (isinstance(den, torch.Tensor) and den.is_floating_point()
              and isinstance(num, numbers.Number)):
            num = torch.tensor(num, dtype=den.dtype, device=den.device)
        return num / den
    if isinstance(expr, Power):
        base = evaluate(expr.base, env)
        expo = expr.exponent
        if isinstance(expo, Constant) and isinstance(expo.value, numbers.Number):
            ev = expo.value
            if isinstance(ev, int) or (isinstance(ev, float) and ev.is_integer()):
                iv = int(ev)
                if 0 <= iv <= 8:  # cheap repeated multiply; keeps f(x)=x**n exact
                    result = 1
                    for _ in range(iv):
                        result = result * base
                    return result
            return base ** ev
        return base ** evaluate(expo, env)
    if isinstance(expr, Call):
        args = [evaluate(a, env) for a in expr.args]
        return _apply(expr.func, *args)
    raise TypeError(f"cannot evaluate {type(expr)}")


def field_names(expr):
    """Collect the set of field/var names appearing in ``expr``.

    Analog of the reference's ``FieldCollector``
    (pystella's field/__init__.py:529-533).
    """
    out = set()

    def visit(e):
        if isinstance(e, Indexed):
            out.add(e.field.name)
        elif isinstance(e, Field):
            out.add(e.name)
        elif isinstance(e, Var):
            out.add(e.name)
        elif isinstance(e, Shifted):
            visit(e.child)
        elif isinstance(e, Sum) or isinstance(e, Product):
            for c in e.children:
                visit(c)
        elif isinstance(e, Quotient):
            visit(e.num), visit(e.den)
        elif isinstance(e, Power):
            visit(e.base), visit(e.exponent)
        elif isinstance(e, Call):
            for a in e.args:
                visit(a)

    visit(_wrap(expr))
    return out


def substitute(expr, mapping):
    """Replace subexpressions per ``mapping`` (Expr → Expr/number).

    Analog of reference ``substitute``
    (pystella's field/__init__.py:494-526).
    """
    expr = _wrap(expr)
    for key, val in mapping.items():
        if expr == _wrap(key):
            return _wrap(val)
    if isinstance(expr, Sum):
        return Sum.make(*(substitute(c, mapping) for c in expr.children))
    if isinstance(expr, Product):
        return Product.make(*(substitute(c, mapping) for c in expr.children))
    if isinstance(expr, Quotient):
        return Quotient(substitute(expr.num, mapping),
                        substitute(expr.den, mapping))
    if isinstance(expr, Power):
        return Power(substitute(expr.base, mapping),
                     substitute(expr.exponent, mapping))
    if isinstance(expr, Call):
        return Call(expr.func, tuple(substitute(a, mapping) for a in expr.args))
    if isinstance(expr, Shifted):
        return Shifted(substitute(expr.child, mapping), expr.shift)
    return expr


# ---------------------------------------------------------------------------
# symbolic differentiation
# ---------------------------------------------------------------------------

_DERIVS = {
    "exp": lambda x: exp(x),
    "log": lambda x: 1 / x,
    "sin": lambda x: cos(x),
    "cos": lambda x: -1 * sin(x),
    "tan": lambda x: 1 / cos(x) ** 2,
    "sinh": lambda x: cosh(x),
    "cosh": lambda x: sinh(x),
    "tanh": lambda x: 1 - tanh(x) ** 2,
    "sqrt": lambda x: Quotient(_wrap(1), 2 * sqrt(x)),
    "fabs": lambda x: sign(x),
}

#: spacetime coordinate symbols, usable as ``diff(f, t)`` / ``diff(f, x)``
t, x, y, z = Var("t"), Var("x"), Var("y"), Var("z")
_COORDS = {"t": 0, "x": 1, "y": 2, "z": 3}


def _diff1(expr, var):
    expr = _wrap(expr)
    var = _wrap(var)

    # d/d(coordinate) on a DynamicField → its .d(mu) field
    # (reference FieldDifferentiationMapper, field/diff.py:37-55)
    if isinstance(var, Var) and var.name in _COORDS:
        mu = _COORDS[var.name]

        def coord_diff(e):
            e = _wrap(e)
            if isinstance(e, DynamicField):
                return e.d(mu)
            if isinstance(e, Indexed) and isinstance(e.field, DynamicField):
                return e.field.d(*e.index, mu)
            if isinstance(e, Var) and e.name == var.name:
                return Constant(1)
            if isinstance(e, (Constant, Field, Var, Indexed)):
                return Constant(0)
            if isinstance(e, Shifted):
                # coordinate derivatives commute with lattice shifts
                inner = coord_diff(e.child)
                if isinstance(inner, Constant) and inner.value == 0:
                    return inner
                return Shifted(inner, e.shift)
            return _structural_diff(e, coord_diff)
        return coord_diff(expr)

    def ddvar(e):
        e = _wrap(e)
        if e == var:
            return Constant(1)
        if isinstance(e, (Constant, Var)):
            return Constant(0)
        if isinstance(e, (Field, Indexed)):
            return Constant(0)
        if isinstance(e, Shifted):
            # a shifted field occurrence lives at a different lattice site,
            # independent of the origin-site variable (unless var is the
            # same shifted expression, caught by the e == var test; to
            # differentiate through a shift, substitute first)
            return Constant(0)
        return _structural_diff(e, ddvar)
    return ddvar(expr)


def _structural_diff(e, rec):
    if isinstance(e, Sum):
        return Sum.make(*(rec(c) for c in e.children))
    if isinstance(e, Product):
        terms = []
        cs = e.children
        for i in range(len(cs)):
            d = rec(cs[i])
            if isinstance(d, Constant) and d.value == 0:
                continue
            terms.append(Product.make(*cs[:i], d, *cs[i + 1:]))
        return Sum.make(*terms) if terms else Constant(0)
    if isinstance(e, Quotient):
        return Quotient(
            Sum.make(Product.make(rec(e.num), e.den),
                     Product.make(-1, e.num, rec(e.den))),
            Power(e.den, Constant(2)))
    if isinstance(e, Power):
        b, p = e.base, e.exponent
        db, dp = rec(b), rec(p)
        dp_zero = isinstance(dp, Constant) and dp.value == 0
        db_zero = isinstance(db, Constant) and db.value == 0
        terms = []
        if not db_zero:
            terms.append(Product.make(p, Power(b, Sum.make(p, -1)), db))
        if not dp_zero:
            terms.append(Product.make(Power(b, p), log(b), dp))
        return Sum.make(*terms) if terms else Constant(0)
    if isinstance(e, Call):
        if e.func not in _DERIVS:
            raise ValueError(f"no derivative rule for function {e.func}")
        (arg,) = e.args
        return Product.make(_DERIVS[e.func](arg), rec(arg))
    raise TypeError(f"cannot differentiate {type(e)}")


def diff(expr, *vars):
    """Symbolic derivative of ``expr`` with respect to each of ``vars`` in turn.

    Matches the reference ``pystella.diff`` semantics
    (pystella's field/diff.py:80-94): multiple variables
    differentiate sequentially; coordinate symbols ``t, x, y, z`` map
    ``DynamicField``s to their ``.dot`` / ``.pd`` members.
    """
    result = _wrap(expr)
    for v in vars:
        result = _diff1(result, v)
    return result


def simplify(expr):
    """Constant-fold an expression (best-effort structural simplification)."""
    expr = _wrap(expr)
    if isinstance(expr, Sum):
        children = [simplify(c) for c in expr.children]
        const = 0
        rest = []
        for c in children:
            if isinstance(c, Constant) and isinstance(c.value, numbers.Number):
                const += c.value
            else:
                rest.append(c)
        if const != 0 or not rest:
            rest.append(Constant(const))
        return Sum.make(*rest)
    if isinstance(expr, Product):
        children = [simplify(c) for c in expr.children]
        const = 1
        rest = []
        for c in children:
            if isinstance(c, Constant) and isinstance(c.value, numbers.Number):
                const *= c.value
            else:
                rest.append(c)
        if const == 0:
            return Constant(0)
        if const != 1 or not rest:
            rest.insert(0, Constant(const))
        return Product.make(*rest)
    if isinstance(expr, Quotient):
        return Quotient(simplify(expr.num), simplify(expr.den))
    if isinstance(expr, Power):
        base, expo = simplify(expr.base), simplify(expr.exponent)
        if isinstance(expo, Constant) and isinstance(expo.value, numbers.Number):
            if expo.value == 1:
                return base
            if expo.value == 0:
                return Constant(1)
            if isinstance(base, Constant) \
                    and isinstance(base.value, numbers.Number):
                return Constant(base.value ** expo.value)
        return Power(base, expo)
    if isinstance(expr, Call):
        return Call(expr.func, tuple(simplify(a) for a in expr.args))
    return expr
