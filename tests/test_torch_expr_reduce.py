"""The reduction rules of the port's expression factories held to the JAX
package's: each case of ``tests/test_expr_reduce.py`` runs through both
modules (``test_torch_expr.Side``), its assertions hold on both, the
reduced graphs give identical ``to_latex`` strings and their values agree
to 1e-12 relative."""

import numpy as np
import pytest

from test_torch_expr import result, run_both


def xy(s):
    return s.var(1, 10.0, "x"), s.var(1, 5.0, "y")


def constant_folding(s):
    g = s.g
    assert isinstance(g.constant(1.0) + g.constant(2.0), g.Constant)
    assert (g.constant(1.0) + g.constant(2.0)).value == 3.0
    assert (g.constant(5.0) - g.constant(2.0)).value == 3.0
    assert (g.constant(4.0) * g.constant(2.0)).value == 8.0
    assert (g.constant(8.0) / g.constant(2.0)).value == 4.0
    assert (g.constant(2.0) ** g.constant(3.0)).value == 8.0
    assert g.sqrt(g.constant(9.0)).value == 3.0
    assert g.exp(g.constant(0.0)).value == 1.0
    assert g.log(g.constant(1.0)).value == 0.0
    return result([g.sqrt(g.constant(9.0)), g.constant(2.0) ** 3.0])


def division_by_zero_constant_not_folded(s):
    d = s.g.constant(1.0) / s.g.constant(0.0)
    assert isinstance(d, s.g.Div)
    assert s.ev(d) == np.inf
    return result([d], [s.ev(d)])


def add_zero_identity(s):
    x, _ = xy(s)
    assert (x + 0.0) is x
    assert (0.0 + x) is x
    return result([x + 0.0])


def sub_identities(s):
    x, _ = xy(s)
    assert (x - 0.0) is x
    neg = 0.0 - x
    assert isinstance(neg, s.g.Mul)
    assert s.ev(neg)[0] == -10.0
    assert isinstance(x - x, s.g.Constant) and (x - x).is_(0)
    return result([neg, x - x], [s.ev(neg)])


def mul_identities(s):
    x, _ = xy(s)
    assert (x * 1.0) is x
    assert (1.0 * x) is x
    assert isinstance(x * 0.0, s.g.Constant) and (x * 0.0).is_(0)
    assert isinstance(0.0 * x, s.g.Constant)
    return result([x * 1.0, x * 0.0])


def div_identities(s):
    x, _ = xy(s)
    assert (x / 1.0) is x
    assert isinstance(x / x, s.g.Constant) and (x / x).is_(1)
    z = s.g.constant(0.0) / x
    assert isinstance(z, s.g.Constant) and z.is_(0)
    return result([x / x, z])


def add_same_becomes_multiply(s):
    x, _ = xy(s)
    two_x = x + x
    assert isinstance(two_x, s.g.Mul)
    assert isinstance(two_x.a, s.g.Constant) and two_x.a.is_(2)
    assert s.ev(two_x)[0] == 20.0
    return result([two_x], [s.ev(two_x)])


def constant_moves_left(s):
    x, _ = xy(s)
    m = x * 2.0
    assert isinstance(m, s.g.Mul)
    assert isinstance(m.a, s.g.Constant)
    return result([m], [s.ev(m)])


def nested_constant_gathering(s):
    x, _ = xy(s)
    m = 2.0 * (3.0 * x)
    assert isinstance(m, s.g.Mul)
    assert isinstance(m.a, s.g.Constant) and m.a.is_(6)
    assert m.b is x
    return result([m], [s.ev(m)])


def fma_formation(s):
    x, y = xy(s)
    assert isinstance(x * y + 3.0, s.g.Fma)
    assert isinstance(3.0 + x * y, s.g.Fma)
    f = x * y + 3.0
    assert s.ev(f)[0] == 53.0
    return result([f, 3.0 + x * y], [s.ev(f)])


def fma_reductions(s):
    g = s.g
    x, y = xy(s)
    assert g.fma(0.0, x, y) is y
    assert g.fma(x, 0.0, y) is y
    assert isinstance(g.fma(1.0, x, y), (g.Add, g.Fma, g.Mul))
    assert s.ev(g.fma(1.0, x, y))[0] == 15.0
    c = g.fma(2.0, g.constant(3.0), g.constant(4.0))
    assert isinstance(c, g.Constant) and c.value == 10.0
    m = g.fma(x, y, 0.0)
    assert isinstance(m, g.Mul)
    return result([g.fma(1.0, x, y), c, m],
                  [s.ev(g.fma(1.0, x, y)), s.ev(m)])


def exponent_gathering(s):
    g = s.g
    x, _ = xy(s)
    sq = x * x
    assert isinstance(sq, g.Pow)
    assert sq.b.is_(2)
    cube = x * sq
    assert isinstance(cube, g.Pow) and cube.b.is_(3)
    five = sq * (x ** 3.0)
    assert isinstance(five, g.Pow) and five.b.is_(5)
    assert s.ev(five)[0] == 1.0e5
    return result([sq, cube, five], [s.ev(cube), s.ev(five)])


def pow_identities(s):
    g = s.g
    x, _ = xy(s)
    assert (x ** 1.0) is x
    p0 = x ** 0.0
    assert isinstance(p0, g.Constant) and p0.is_(1)
    nested = (x ** 2.0) ** 3.0
    assert isinstance(nested, g.Pow) and nested.b.is_(6)
    return result([p0, nested], [s.ev(nested)])


def sqrt_of_square(s):
    g = s.g
    x, _ = xy(s)
    assert g.sqrt(x * x) is x
    assert g.sqrt(x ** 2.0) is x
    assert (g.sqrt(x) ** 2.0) is x
    return result([g.sqrt(x * x)])


def exp_log_inverses(s):
    g = s.g
    x, _ = xy(s)
    assert g.exp(g.log(x)) is x
    assert g.log(g.exp(x)) is x
    return result([g.exp(g.log(x))])


def random_identity_rules(s):
    g = s.g
    r = g.random(8)
    assert (r + 0.0) is r
    assert (r * 1.0) is r
    rr = r + r
    assert isinstance(rr, g.Add)
    assert isinstance(r - r, g.Sub)
    assert isinstance(r / r, g.Div)
    assert isinstance(r * r, g.Mul)
    return result([rr, r - r, r / r, r * r])


def reduce_method_on_raw_nodes(s):
    g = s.g
    x, _ = xy(s)
    raw = g.Add(g.Mul(g.Constant(1.0), x), g.Constant(0.0))
    red = raw.reduce()
    assert red is x
    raw2 = g.Mul(g.Constant(2.0), g.Mul(g.Constant(3.0), x))
    red2 = raw2.reduce()
    assert isinstance(red2, g.Mul) and red2.a.is_(6)
    # the raw trees evaluate to what they reduce to
    return result([raw, red, raw2, red2],
                  [s.ev(raw), s.ev(raw2), s.ev(red2)])


def reduce_after_remove_pseudo(s):
    g = s.g
    x, _ = xy(s)
    p = g.pseudo_variable(x * 0.0)
    e = g.Add(p, x)
    stripped = e.remove_pseudo().reduce()
    assert stripped is x
    return result([e, stripped], [s.ev(e)])


def df_compaction(s):
    g = s.g
    x, _ = xy(s)
    d = (x ** 3.0).df(x)
    assert s.ev(d)[0] == 300.0
    assert isinstance(d, g.Mul)
    assert d.a.is_(3)
    dc = (x * x + 2.0 * x + 1.0).df(x)
    assert all(not isinstance(n, g.Add) or not (
        isinstance(n.a, g.Constant) and n.a.is_(0))
        for n in g.walk(dc))
    assert s.ev(dc)[0] == 22.0
    return result([d, dc], [s.ev(d), s.ev(dc)])


def df_of_constant_subtree_folds(s):
    g = s.g
    x, y = xy(s)
    e = g.constant(4.0) * y + x * 0.0 + g.constant(7.0)
    d = e.df(y)
    assert isinstance(d, g.Constant) and d.is_(4)
    return result([e, d])


def reductions_preserve_values(s):
    g = s.g
    rng = np.random.default_rng(3)
    a = s.var(16, rng.uniform(0.5, 2.0, 16), "a")
    b = s.var(16, rng.uniform(0.5, 2.0, 16), "b")
    e = ((a * b + a) / (b + 1.0) - a) + (a ** 2.0) / a + g.sqrt(b * b)
    got = s.ev(e)
    av, bv = s.data(a), s.data(b)
    want = ((av * bv + av) / (bv + 1.0) - av) + av + bv
    np.testing.assert_allclose(got, want, rtol=1e-6)
    return result([e], [got])


def tan_composite(s):
    g = s.g
    x = s.var(4, 0.3, "x")
    t = g.tan(x)
    np.testing.assert_allclose(s.ev(t), np.tan(0.3) * np.ones(4),
                               rtol=1e-12)
    d = t.df(x)
    np.testing.assert_allclose(s.ev(d), 1.0 / np.cos(0.3) ** 2 * np.ones(4),
                               rtol=1e-12)
    return result([t, d], [s.ev(t), s.ev(d)])


def piecewise_constant_folding(s):
    g = s.g
    x = s.var(3, 1.2, "x")
    data = np.array([1.0, 2.0, 3.0, 4.0])
    t = g.piecewise_1D(data, x, 1.0, 0.0)
    e = g.add(g.constant(10.0), t)
    assert isinstance(e, g.Piecewise1D)
    np.testing.assert_allclose(e.data, data + 10.0)
    e2 = g.mul(t, g.constant(2.0))
    assert isinstance(e2, g.Piecewise1D)
    np.testing.assert_allclose(e2.data, data * 2.0)
    t2 = g.piecewise_1D(data * 3, x, 1.0, 0.0)
    e3 = g.add(t, t2)
    assert isinstance(e3, g.Piecewise1D)
    np.testing.assert_allclose(e3.data, data * 4.0)
    t3 = g.piecewise_1D(data, x, 2.0, 0.0)
    assert not isinstance(g.add(t, t3), g.Piecewise1D) or \
        g.add(t, t3) is not t
    return result([e, e2, e3, g.add(t, t3)],
                  [s.ev(e), s.ev(e2), s.ev(e3), s.ev(g.add(t, t3))])


def piecewise_2d_row_col_extraction(s):
    g = s.g
    x = s.var(2, 0.0, "x")
    data = np.arange(12.0).reshape(3, 4)
    e = g.piecewise_2D(data, 4, g.constant(2.0), 1.0, 0.0, x, 1.0, 0.0)
    assert isinstance(e, g.Piecewise1D)
    np.testing.assert_allclose(e.data, data[2, :])
    out = [s.ev(e)]
    e = g.piecewise_2D(data, 4, x, 1.0, 0.0, g.constant(1.0), 1.0, 0.0)
    assert isinstance(e, g.Piecewise1D)
    np.testing.assert_allclose(e.data, data[:, 1])
    out.append(s.ev(e))
    c = g.piecewise_2D(data, 4, g.constant(2.7), 1.0, 0.0,
                       g.constant(99.0), 1.0, 0.0)
    assert isinstance(c, g.Constant) and c.value == data[2, 3]
    k = g.piecewise_1D(np.full(5, 7.0), x, 1.0, 0.0)
    assert isinstance(k, g.Constant) and k.value == 7.0
    return result([e, c, k], out)


CASES = {f.__name__: f for f in (
    constant_folding, division_by_zero_constant_not_folded,
    add_zero_identity, sub_identities, mul_identities, div_identities,
    add_same_becomes_multiply, constant_moves_left,
    nested_constant_gathering, fma_formation, fma_reductions,
    exponent_gathering, pow_identities, sqrt_of_square, exp_log_inverses,
    random_identity_rules, reduce_method_on_raw_nodes,
    reduce_after_remove_pseudo, df_compaction, df_of_constant_subtree_folds,
    reductions_preserve_values, tan_composite, piecewise_constant_folding,
    piecewise_2d_row_col_extraction)}


@pytest.mark.parametrize("case", list(CASES))
def test_reduce_case_matches_jax(case):
    """tests/test_expr_reduce.py's case ``case`` on both packages."""
    run_both(CASES[case])
