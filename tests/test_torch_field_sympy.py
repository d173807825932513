"""The port's sympy bridge, ``pystella_tpu_torch.field_sympy``: the cases
of tests/test_field_sympy.py on the port's field layer, and each
conversion against the JAX package's bridge (the same sympy expression, the
same values after the round trip)."""

import numpy as np
import pytest
import torch

import pystella_tpu as ps
import pystella_tpu_torch as pt
from pystella_tpu import field_sympy as jax_sympy
from pystella_tpu_torch import field_sympy

sympy = pytest.importorskip("sympy")


@pytest.fixture(autouse=True)
def _jax_registry():
    """Leave the JAX package's process-wide symbol registry as this file
    found it empty: a ``Field("f")`` converted here would otherwise collide
    with a later JAX test's ``Field("f", shape=(3,))`` in the same
    process."""
    jax_sympy.reset_field_registry()
    yield
    jax_sympy.reset_field_registry()


def _value(expr, env):
    return float(pt.evaluate(expr, {k: torch.tensor(v)
                                    for k, v in env.items()}))


def test_round_trip_scalar_field():
    f = pt.Field("f")
    expr = 3 * f ** 2 + pt.exp(f) / 2 - 1
    back = field_sympy.from_sympy(field_sympy.to_sympy(expr))
    env = {"f": np.array(0.7)}
    assert np.allclose(_value(back, env), _value(expr, env))


def test_round_trip_indexed_field():
    f = pt.Field("f", shape=(3,))
    expr = f[0] * f[1] + pt.sin(f[2])
    back = field_sympy.from_sympy(field_sympy.to_sympy(expr))
    env = {"f": np.array([0.3, -1.2, 2.0])}
    assert np.allclose(_value(back, env), _value(expr, env))


def test_round_trip_preserves_field_identity():
    f = pt.Field("phi")
    back = field_sympy.from_sympy(field_sympy.to_sympy(f))
    assert isinstance(back, pt.Field)
    assert back.name == "phi"


def test_round_trip_dynamic_field_members():
    f = pt.DynamicField("f")
    expr = f.dot * f.lap
    back = field_sympy.from_sympy(field_sympy.to_sympy(expr))
    env = {"dfdt": np.array(2.0), "lap_f": np.array(3.0)}
    assert np.allclose(_value(back, env), 6.0)


def test_sympy_simplify():
    f = pt.Field("f")
    simplified = field_sympy.simplify(f * f / f)  # sympy reduces it to f
    assert np.allclose(_value(simplified, {"f": np.array(1.7)}), 1.7)


def test_sympy_simplify_trig_identity():
    f = pt.Field("f")
    simplified = field_sympy.simplify(pt.sin(f) ** 2 + pt.cos(f) ** 2)
    assert np.allclose(_value(simplified, {"f": np.array(0.4)}), 1.0)


def test_vars_and_functions():
    a = pt.Var("a")
    f = pt.Field("f")
    expr = pt.sqrt(a) * pt.tanh(f) + pt.fabs(f)
    back = field_sympy.from_sympy(field_sympy.to_sympy(expr))
    env = {"a": np.array(4.0), "f": np.array(-0.5)}
    assert np.allclose(_value(back, env), _value(expr, env))


def test_rational_constants():
    f = pt.Field("f")
    # sympy canonicalizes 1/3 into a Rational; it must evaluate
    expr = field_sympy.simplify(f / 3 + f / 6)
    assert np.allclose(_value(expr, {"f": np.array(2.0)}), 1.0)


def test_shifted_round_trip():
    """Stencil expressions (Shifted leaves) survive the round trip."""
    f = pt.Field("f")
    stencil = pt.expand_stencil(f, {(1, 0, 0): 1, (-1, 0, 0): -1})
    out = field_sympy.simplify(stencil)
    arr = torch.tensor(np.random.default_rng(1).random((4, 4, 4)))
    torch.testing.assert_close(pt.evaluate(out, {"f": arr}),
                               pt.evaluate(stencil, {"f": arr}))


def test_name_collision_and_registry_reset():
    """Two distinct fields that would share a sympy symbol are refused;
    after a reset, a symbol from an earlier conversion comes back as a
    plain Var."""
    field_sympy.to_sympy(pt.Field("g", shape=(2,))[1])
    with pytest.raises(ValueError, match="collision"):
        field_sympy.to_sympy(pt.Field("g", shape=(3,))[1])
    sym = field_sympy.to_sympy(pt.Field("q"))
    field_sympy.reset_field_registry()
    back = field_sympy.from_sympy(sym)
    assert isinstance(back, pt.Var) and back.name == "q"


def _pair(mod):
    """The same expression in either package's field layer: every node
    kind the bridge converts (indexed and shifted fields, a Var, sums,
    products, a quotient, powers, the math functions)."""
    f = mod.Field("f", shape=(2,))
    a = mod.Var("a")
    shifted = mod.expand_stencil(f[0], {(0, 1, 0): 0.5, (0, -1, 0): -0.5})
    return (mod.exp(f[0]) * a ** 2 / (1 + f[1] ** 2) + mod.sqrt(a) * shifted
            - mod.fabs(f[1]) + mod.tanh(f[0]) ** 3)


@pytest.mark.parametrize("how", ["to_sympy", "simplify"])
def test_matches_jax_bridge(how):
    """The port's bridge gives the JAX package's sympy expression for the
    same tree, and after the round trip (and after simplify) an expression
    that evaluates to the JAX package's on the same arrays, to 1e-14."""
    if how == "to_sympy":
        assert field_sympy.to_sympy(_pair(pt)) == \
            jax_sympy.to_sympy(_pair(ps))
        got = field_sympy.from_sympy(field_sympy.to_sympy(_pair(pt)))
        ref = jax_sympy.from_sympy(jax_sympy.to_sympy(_pair(ps)))
    else:
        got = field_sympy.simplify(_pair(pt))
        ref = jax_sympy.simplify(_pair(ps))
    rng = np.random.default_rng(4)
    f = rng.uniform(0.1, 1.0, (2, 5, 4, 3))
    import jax.numpy as jnp
    vj = np.asarray(ps.evaluate(ref, {"f": jnp.asarray(f), "a": 1.3}))
    vt = pt.evaluate(got, {"f": torch.tensor(f), "a": 1.3}).numpy()
    np.testing.assert_allclose(vt, vj, rtol=1e-14, atol=1e-14)
