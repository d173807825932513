"""The port's symbolic layer and C printer against the JAX package's.

Inputs are made once with numpy and fed to both packages; expressions are
built by applying the same potential callable to each package's own
``DynamicField``."""

import math
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pystella_tpu as ps
import pystella_tpu_torch as pt
from pystella_tpu_torch.ops import codegen


def bench_potential(f):
    # the preheating model of bench.py:build_preheat_step
    mphi, gsq = 1.20e-6, 2.5e-7
    phi, chi = f[0], f[1]
    return (mphi**2 / 2 * phi**2 + gsq / 2 * phi**2 * chi**2) / mphi**2


def fused_test_potential(f):
    # tests/test_fused.py's potential
    return 0.5 * 1.2e-2 * f[0] ** 2 + 0.125 * f[0] ** 2 * f[1] ** 2


def transcendental_potential(f):
    return ps_any_exp(f[0]) * f[1] ** 3 / (2.5 + f[0] ** 2) + 0.3 * f[1] ** 1.5


def ps_any_exp(x):
    # exp from whichever package's field module built x
    mod = pt if isinstance(x, pt.Expr) else ps
    return mod.field.exp(x)


POTENTIALS = [bench_potential, fused_test_potential]


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300)


@pytest.fixture(scope="module")
def fields():
    rng = np.random.default_rng(3)
    return rng.standard_normal((2, 8, 8, 8))


@pytest.mark.parametrize("potential", POTENTIALS + [transcendental_potential])
def test_evaluate_and_diff_match_jax(potential, fields):
    fj = ps.DynamicField("f", shape=(2,))
    ft = pt.DynamicField("f", shape=(2,))
    if potential is transcendental_potential:
        arr = np.abs(fields) + 0.1  # keep f**1.5 real
    else:
        arr = fields
    Vj, Vt = potential(fj), potential(ft)
    envj = {"f": jnp.asarray(arr)}
    envt = {"f": torch.tensor(arr)}
    assert _rel(pt.evaluate(Vt, envt), ps.evaluate(Vj, envj)) < 1e-14
    for i in range(2):
        dj = ps.evaluate(ps.diff(Vj, fj[i]), envj)
        dt = pt.evaluate(pt.diff(Vt, ft[i]), envt)
        assert _rel(dt, dj) < 1e-14, f"dV/df{i}"


def test_expression_trees_match_jax():
    """The port's tree is built node for node like the JAX package's."""
    fj = ps.DynamicField("f", shape=(2,))
    ft = pt.DynamicField("f", shape=(2,))
    for potential in POTENTIALS:
        for i in range(2):
            assert (repr(pt.diff(potential(ft), ft[i]))
                    == repr(ps.diff(potential(fj), fj[i])))
    x = pt.Var("x")
    assert repr(pt.simplify(2 * x * 3 + 1 + 4)) == repr(
        ps.simplify(2 * ps.Var("x") * 3 + 1 + 4))


def test_shifted_rolls_like_jax(fields):
    fj, ft = ps.Field("g"), pt.Field("g")
    ej = ps.shift_fields(fj, (1, -2, 3)) - 2 * fj
    et = pt.shift_fields(ft, (1, -2, 3)) - 2 * ft
    got = pt.evaluate(et, {"g": torch.tensor(fields)})
    ref = ps.evaluate(ej, {"g": jnp.asarray(fields)})
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert pt.field_names(et) == {"g"}
    sub = pt.substitute(et, {ft: pt.Field("h")})
    assert pt.field_names(sub) == {"h"}


def _c_namespace(T, f, a=0.7, hubble=0.3):
    ns = {"T": T, "f": f, "a": T(a), "hubble": T(hubble),
          "pk_pow": lambda x, y: T(x ** y), "pk_sign": np.sign}
    for name in codegen.C_FUNCS:
        fn = {"fabs": abs, "arcsin": math.asin, "arccos": math.acos,
              "arctan": math.atan}.get(name, getattr(math, name, None))
        ns[codegen.C_FUNCS[name]] = (lambda fn: lambda x: T(fn(x)))(fn)
    return ns


@pytest.mark.parametrize("potential", POTENTIALS + [transcendental_potential])
def test_printed_c_evaluates_equal_on_scalars(potential):
    """Map the printed C back to Python (``T`` -> float) and evaluate it on
    scalars: it must equal ``evaluate`` of the same expression."""
    ft = pt.DynamicField("f", shape=(2,))
    V = potential(ft)
    vals = [0.8, 1.7]
    for i in range(2):
        dv = pt.diff(V, ft[i])
        src = codegen.print_c(dv, fields={"f": "f"},
                              variables={"a": "a", "hubble": "hubble"})
        got = eval(src, _c_namespace(float, vals))  # noqa: S307
        ref = float(pt.evaluate(dv, {"f": torch.tensor(vals,
                                                       dtype=torch.float64)}))
        assert abs(got - ref) <= 1e-15 * abs(ref), (src, got, ref)


@pytest.mark.parametrize("potential", POTENTIALS)
def test_printed_c_stays_float32(potential):
    """Every literal is cast to ``T``, so with ``T = float32`` the printed
    expression rounds exactly where PyTorch rounds an f32 tensor meeting
    Python floats."""
    ft = pt.DynamicField("f", shape=(2,))
    V = potential(ft)
    vals = np.array([1e-3, -2e-3], dtype=np.float32)
    for i in range(2):
        dv = pt.diff(V, ft[i])
        src = codegen.print_c(dv, fields={"f": "f"})
        bare = re.sub(r"T\([^()]*\)|f\[\d\]", "", src)
        assert not re.search(r"\d", bare), f"uncast literal in {src}"
        got = eval(src, _c_namespace(np.float32, list(vals)))  # noqa: S307
        ref = pt.evaluate(dv, {"f": torch.tensor(vals)})
        assert ref.dtype == torch.float32
        assert np.float32(got) == ref.item(), (src, got, ref.item())


def test_printer_edge_cases():
    ft = pt.DynamicField("f", shape=(2,))
    # constant dV/df (V = 0; a linear V) prints as a literal
    assert codegen.print_c(pt.diff(0, ft[0])) == "T(0)"
    assert codegen.print_c(pt.diff(3 * ft[0] + ft[1], ft[0])) == "T(3)"
    # small integer powers are repeated multiplication, in evaluate's order
    assert codegen.print_c(ft[0] ** 3, fields={"f": "f"}) == \
        "((f[0] * f[0]) * f[0])"
    # a folded integer exponent follows torch.pow's special cases
    assert codegen.print_c(pt.diff(ft[0] ** 2, ft[0]), fields={"f": "f"}) \
        == "(T(2) * f[0])"
    assert codegen.print_c(pt.field.exp(ft[1]), fields={"f": "f"}) == \
        "pk_exp(f[1])"
    with pytest.raises(ValueError):
        codegen.print_c(pt.Var("t"))
    with pytest.raises(ValueError):
        codegen.print_c(pt.shift_fields(ft[0], (1, 0, 0)), fields={"f": "f"})
    V = bench_potential(ft)
    dvdf = [pt.diff(V, ft[i]) for i in range(2)]
    header = codegen.model_header(dvdf, V, 2, 2)
    assert "#define PK_F 2" in header and "#define PK_H 2" in header
    assert header.count("out[") == 2 and "PK_HUBBLE_FREE" not in header
    # dV/df and V also printed without hubble in scope
    header = codegen.model_header(dvdf, V, 2, 2, hubble_free=True)
    assert header.count("out[") == 4 and "PK_HUBBLE_FREE" in header
    with pytest.raises(ValueError, match="hubble"):
        codegen.model_header(dvdf, V * pt.Var("hubble"), 2, 2,
                             hubble_free=True)
