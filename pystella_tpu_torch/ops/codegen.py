"""Print :mod:`~pystella_tpu_torch.field` expressions as CUDA C.

The fused kernels in ``ops/csrc`` evaluate the model's ``dV/df`` (and, for
the energy sums, ``V``; for the gravitational-wave system, the anisotropic
stress ``S_ij``) at every lattice site. The model is a user
expression, so it is printed into the kernel source here, the way loopy
printed it for pystella's GPU kernels.

The printer follows :func:`~pystella_tpu_torch.field.evaluate` operation
by operation, so that the kernel rounds where the plain PyTorch version
rounds:

- a subtree whose leaves are all numbers is folded here, in Python (double)
  arithmetic, exactly where ``evaluate`` would fold it; the result becomes
  one literal;
- every literal is written ``T(...)``, a cast to the kernel's template type
  ``T``, so an ``f32`` kernel never promotes to double (a Python float meets
  an ``f32`` tensor the same way in PyTorch);
- sums and products associate left to right, as ``reduce`` does;
- ``x**n`` for integer ``0 <= n <= 8`` is repeated multiplication in the
  order ``evaluate`` uses (``((x * x) * x)``); any other power takes the
  special cases of PyTorch's ``pow(tensor, scalar)`` (``x ** 1`` is ``x``,
  ``x ** 2`` is ``x * x``, ...) or is ``pk_pow``;
- a :class:`~pystella_tpu_torch.field.Call` prints as the ``pk_<name>``
  device function of ``csrc/pk_common.cuh``, which maps to the CUDA math
  library's ``float`` or ``double`` version;
- a scalar that ``evaluate`` meets as a Python float (the multigrid
  solvers' ``omega`` and ``_lap_diag``) is a C ``double``
  (:class:`DoubleExpr`): a subtree of numbers and such scalars alone is
  computed in double, as Python computes it, and cast to ``T`` where it
  meets a lattice value, as PyTorch casts a Python scalar to the tensor's
  type.
"""

from __future__ import annotations

import math
import numbers

from pystella_tpu_torch import field as _field

__all__ = ["print_c", "C_FUNCS", "model_header", "relax_header",
           "DoubleExpr", "STAGE_VARIABLES", "HUBBLE_FREE_VARIABLES"]

#: field.py function name -> device function in csrc/pk_common.cuh
C_FUNCS = {name: f"pk_{name}" for name in _field._FUNCS}

#: the scalars a stage kernel has in scope (Var name -> C name)
STAGE_VARIABLES = {"a": "a", "hubble": "hubble"}
#: the scalars in scope where the Hubble rate is not known yet (the
#: deferred-drag pair's second stage): printing an expression that reads
#: ``hubble`` here raises instead of binding some value to it
HUBBLE_FREE_VARIABLES = {"a": "a"}


def _literal(v):
    if isinstance(v, bool):
        v = int(v)
    if isinstance(v, numbers.Integral):
        return f"T({int(v)})"
    if isinstance(v, numbers.Real):
        v = float(v)
        if not math.isfinite(v):
            raise ValueError(f"cannot print non-finite constant {v}")
        return f"T({v!r})"
    raise TypeError(f"cannot print constant of type {type(v)}")


class DoubleExpr(str):
    """A C expression of type ``double``: a scalar that ``evaluate`` sees
    as a Python float, or arithmetic on such scalars and numbers alone.
    Map a variable to one (``variables={"omega": DoubleExpr("s.omega")}``)
    to have it printed that way."""


def _is_num(x):
    return isinstance(x, numbers.Number)


def _is_host(x):
    """A value Python would hold as a float: a number or a double."""
    return _is_num(x) or isinstance(x, DoubleExpr)


def _double(v):
    """A folded number or a :class:`DoubleExpr` as a C double."""
    if isinstance(v, DoubleExpr):
        return v
    v = float(v)
    if not math.isfinite(v):
        raise ValueError(f"cannot print non-finite constant {v}")
    return repr(v)


def _typed(v):
    """A folded number, a :class:`DoubleExpr` or a C string as a ``T``."""
    if _is_num(v):
        return _literal(v)
    return f"T({v})" if isinstance(v, DoubleExpr) else v


def _binary(a, b, op):
    """``a op b`` where each side is a folded number, a double or a C
    string of type ``T``."""
    if _is_num(a) and _is_num(b):
        return {"+": lambda: a + b, "*": lambda: a * b,
                "/": lambda: a / b}[op]()
    if _is_host(a) and _is_host(b):
        return DoubleExpr(f"({_double(a)} {op} {_double(b)})")
    return f"({_typed(a)} {op} {_typed(b)})"


def _call(fn, *args):
    """``fn(args)``: in double when every argument is one, else in ``T``."""
    if all(_is_host(a) for a in args):
        return DoubleExpr(f"{fn}({', '.join(_double(a) for a in args)})")
    return f"{fn}({', '.join(_typed(a) for a in args)})"


def _pow(base, ev):
    """``base ** ev`` for a C ``base`` and a numeric exponent, with the
    special cases PyTorch's ``pow(tensor, scalar)`` takes (so ``x ** 1`` is
    ``x`` exactly and ``x ** 2`` is ``x * x``)."""
    if ev == 0:
        return 1
    if ev == 1:
        return base
    sq = _binary(base, base, "*")
    special = {2: sq, 3: _binary(sq, base, "*"),
               0.5: _call("pk_sqrt", base),
               -1: _binary(1, base, "/"), -2: _binary(1, sq, "/"),
               -0.5: _binary(1, _call("pk_sqrt", base), "/")}
    if ev in special:
        return special[ev]
    return _call("pk_pow", base, ev)


def _emit(expr, fields, variables):
    rec = lambda e: _emit(e, fields, variables)  # noqa: E731
    if _is_num(expr):
        return expr
    if isinstance(expr, _field.Constant):
        if not _is_num(expr.value):
            raise TypeError("array-valued constants cannot be printed")
        return expr.value
    if isinstance(expr, _field.Indexed):
        name = expr.field.name
        if name not in fields or not expr.index:
            raise ValueError(f"no kernel symbol for {expr!r}")
        return fields[name] + "".join(f"[{int(i)}]" for i in expr.index)
    if isinstance(expr, _field.Var):
        if expr.name not in variables:
            raise ValueError(f"no kernel symbol for variable {expr.name!r}")
        return variables[expr.name]
    if isinstance(expr, _field.Field):
        if not expr.shape and expr.name in variables:
            return variables[expr.name]
        raise ValueError(f"whole field {expr.name!r} has no kernel symbol; "
                         "index its components")
    if isinstance(expr, _field.Shifted):
        raise ValueError("shifted fields cannot be printed: the kernel "
                         "evaluates the expression at its own site")
    if isinstance(expr, (_field.Sum, _field.Product)):
        op = "+" if isinstance(expr, _field.Sum) else "*"
        parts = [rec(c) for c in expr.children]
        acc = parts[0]
        for p in parts[1:]:
            acc = _binary(acc, p, op)
        return acc
    if isinstance(expr, _field.Quotient):
        return _binary(rec(expr.num), rec(expr.den), "/")
    if isinstance(expr, _field.Power):
        base = rec(expr.base)
        expo = expr.exponent
        if isinstance(expo, _field.Constant) and _is_num(expo.value):
            ev = expo.value
            if isinstance(ev, int) or (isinstance(ev, float)
                                       and ev.is_integer()):
                iv = int(ev)
                if 0 <= iv <= 8:
                    if _is_num(base):
                        result = 1
                        for _ in range(iv):
                            result = result * base
                        return result
                    if iv == 0:
                        return 1
                    # 1 * x == x exactly, so the leading 1 is dropped
                    result = base
                    for _ in range(iv - 1):
                        result = _binary(result, base, "*")
                    return result
            if _is_num(base):
                return base ** ev
            return _pow(base, ev)
        e = rec(expo)
        if _is_num(e):
            return base ** e if _is_num(base) else _pow(base, e)
        return _call("pk_pow", base, e)
    if isinstance(expr, _field.Call):
        (arg,) = [rec(a) for a in expr.args]
        if _is_num(arg):
            return float(_field._apply(expr.func, arg))
        return _call(C_FUNCS[expr.func], arg)
    raise TypeError(f"cannot print {type(expr)}")


def print_c(expr, fields=None, variables=None):
    """A CUDA C expression of type ``T`` computing ``expr``.

    :arg fields: field name -> C array name; component ``f[i]`` of field
        ``f`` prints as ``<name>[i]``, ``dfdx[i, j]`` as ``<name>[i][j]``.
    :arg variables: :class:`~pystella_tpu_torch.field.Var` name (or the
        name of a whole :class:`~pystella_tpu_torch.field.Field` without
        component axes) -> C name of a ``T``, or a :class:`DoubleExpr`.
    """
    out = _emit(_field._wrap(expr), dict(fields or {}), dict(variables or {}))
    return _typed(out)


def _site_functions(suffix, dvdf, potential, fields, variables):
    """``pk_dvdf<suffix>`` (dV/df_i for every component) and
    ``pk_v<suffix>`` (V) at one site, over the scalars ``variables``."""
    params = "".join(f", const T {c}" for c in variables.values())
    unused = " ".join(f"(void){c};" for c in ("f", *variables.values()))
    lines = [
        "template <typename T>",
        f"__device__ __forceinline__ void pk_dvdf{suffix}(",
        f"    const T (&f)[PK_F]{params}, T (&out)[PK_F]) {{",
        f"  {unused}",
    ]
    for i, e in enumerate(dvdf):
        lines.append(f"  out[{i}] = {print_c(e, fields, variables)};")
    lines += [
        "}",
        "",
        "template <typename T>",
        f"__device__ __forceinline__ T pk_v{suffix}(",
        f"    const T (&f)[PK_F]{params}) {{",
        f"  {unused}",
        f"  return {print_c(potential, fields, variables)};",
        "}",
        "",
    ]
    return lines


def _sij_functions(suffix, sij, variables):
    """``pk_sij<suffix>``: every ``S_ij`` component at one site from the
    site's field gradients ``dfdx[PK_F][3]`` (``dfdx[i][j]`` is
    ``d f_i / d x_j``), over the scalars ``variables``."""
    params = "".join(f", const T {c}" for c in variables.values())
    unused = " ".join(f"(void){c};" for c in ("dfdx", *variables.values()))
    lines = [
        "template <typename T>",
        f"__device__ __forceinline__ void pk_sij{suffix}(",
        f"    const T (&dfdx)[PK_F][3]{params}, T (&out)[PK_NH]) {{",
        f"  {unused}",
    ]
    for i, e in enumerate(sij):
        lines.append(
            f"  out[{i}] = {print_c(e, {'dfdx': 'dfdx'}, variables)};")
    return lines + ["}", ""]


def model_header(dvdf, potential, nfields, halo, field_name="f",
                 hubble_free=False, sij=None):
    """The generated header the fused kernels include: the number of
    fields ``PK_F``, the stencil radius ``PK_H``, and the model at one site
    from the site's field values ``f[PK_F]``:

    - ``pk_dvdf<T>(f, a, hubble, out)``: ``dV/df_i`` for every component;
    - ``pk_v<T>(f, a, hubble)``: the potential ``V``;
    - with ``hubble_free``, ``PK_HUBBLE_FREE`` and the same two functions
      without ``hubble``, ``pk_dvdf_nohub<T>(f, a, out)`` and
      ``pk_v_nohub<T>(f, a)``, which the deferred-drag coupled pair
      evaluates before the stage's Hubble rate exists. They are printed
      over :data:`HUBBLE_FREE_VARIABLES`, so an expression that reads
      ``hubble`` raises ``ValueError`` here.

    With ``sij`` (the gravitational-wave system's anisotropic stress, one
    expression per ``hij`` component, reading the gradients ``dfdx``) it
    also prints ``PK_NH`` (the number of components), the source
    coefficient ``PK_GW_COEF`` (the Python double ``16 * pi``, which the
    kernels cast to ``T`` as the plain version's Python float meets a
    tensor), ``pk_sij<T>(dfdx, a, hubble, out)`` and, with
    ``hubble_free``, ``pk_sij_nohub<T>(dfdx, a, out)``. Without ``sij``
    the header is the scalar system's alone.

    A ``V`` or ``dV/df_i`` that does not depend on ``f`` prints as a
    constant; the kernel still evaluates it at (and sums it over) every
    site, as the plain versions broadcast it.
    """
    fields = {field_name: "f"}
    lines = [
        "// Generated by pystella_tpu_torch.ops.codegen; do not edit.",
        "#pragma once",
        f"#define PK_F {int(nfields)}",
        f"#define PK_H {int(halo)}",
        "",
    ]
    lines += _site_functions("", dvdf, potential, fields, STAGE_VARIABLES)
    if hubble_free:
        lines += ["#define PK_HUBBLE_FREE 1", ""]
        lines += _site_functions("_nohub", dvdf, potential, fields,
                                 HUBBLE_FREE_VARIABLES)
    if sij is not None:
        lines += [f"#define PK_NH {len(sij)}",
                  f"#define PK_GW_COEF {16 * math.pi!r}", ""]
        lines += _sij_functions("", sij, STAGE_VARIABLES)
        if hubble_free:
            lines += _sij_functions("_nohub", sij, HUBBLE_FREE_VARIABLES)
    return "\n".join(lines)


def relax_header(names, rho_names, step_exprs, resid_exprs, lhs_exprs, halo,
                 aux_lattice=(), aux_scalar=()):
    """The generated header the multigrid sweep kernels (``mg_relax.cu``)
    are compiled against: the stencil radius ``PK_H``, the number of
    unknowns ``MG_NF``, of lattice-valued and of scalar auxiliary inputs
    (``MG_NLAT``, ``MG_NSCAL``), the values a site holds,

    - ``s.f[i]``, ``s.lap[i]``, ``s.rho[i]``: unknown ``names[i]``, its
      Laplacian ``lap_<name>`` and its source ``rho_names[i]``;
    - ``s.aux[j]``, ``s.scal[j]``: the auxiliary arrays and scalars, in the
      order given (of type ``T``: the solver hands them over in the
      working type);
    - ``s.omega``, ``s.lap_diag``: the damping factor and the Laplacian's
      centre weight, doubles, as the plain version's Python floats;

    and per kind one function computing, for every unknown from the OLD
    values of all of them, ``mg_step`` (the relaxation update,
    ``step_exprs``), ``mg_resid`` (``rho - L(f)``, ``resid_exprs``) and
    ``mg_lhs`` (``L(f)``, ``lhs_exprs``; it sees no ``rho``: the FAS
    coarse right-hand side adds the restricted residual outside it).
    """
    symbols = {"omega": DoubleExpr("s.omega"),
               "_lap_diag": DoubleExpr("s.lap_diag")}
    for j, k in enumerate(aux_lattice):
        symbols[k] = f"s.aux[{j}]"
    for j, k in enumerate(aux_scalar):
        symbols[k] = f"s.scal[{j}]"
    for i, n in enumerate(names):
        symbols[n] = f"s.f[{i}]"
        symbols["lap_" + n] = f"s.lap[{i}]"
    with_rho = dict(symbols)
    for i, r in enumerate(rho_names):
        with_rho[r] = f"s.rho[{i}]"
    nf = len(names)
    lines = [
        "// Generated by pystella_tpu_torch.ops.codegen; do not edit.",
        "#pragma once",
        f"#define PK_H {int(halo)}",
        f"#define MG_NF {nf}",
        f"#define MG_NLAT {len(aux_lattice)}",
        f"#define MG_NSCAL {len(aux_scalar)}",
        "",
        "template <typename T>",
        "struct MgSite {",
        "  T f[MG_NF], lap[MG_NF], rho[MG_NF];",
        "  T aux[MG_NLAT > 0 ? MG_NLAT : 1], scal[MG_NSCAL > 0 ? MG_NSCAL : 1];",
        "  double omega, lap_diag;",
        "};",
        "",
    ]
    for fn, exprs, syms in (("mg_step", step_exprs, with_rho),
                            ("mg_resid", resid_exprs, with_rho),
                            ("mg_lhs", lhs_exprs, symbols)):
        lines += ["template <typename T>",
                  f"__device__ __forceinline__ void {fn}(",
                  "    const MgSite<T>& s, T (&out)[MG_NF]) {",
                  "  (void)s;"]
        for i, n in enumerate(names):
            lines.append(f"  out[{i}] = {print_c(exprs[n], None, syms)};")
        lines += ["}", ""]
    return "\n".join(lines)
