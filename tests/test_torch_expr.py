"""The port's expression layer (``graph_framework_tpu_torch.expr``) held to
the JAX package's (``graph_framework_tpu.expr``).

Each case of ``tests/test_expr.py`` is a function that builds its graphs
through either module, and runs through both (a :class:`Side` each): the
assertions of the JAX test hold on both, the reduced graphs give identical
``to_latex`` strings, and their
values agree to 1e-12 relative in float64 and complex128 (``erfi`` to the
1e-10 that ``tests/test_torch_special.py`` holds it to).  The random cases
check statistics and that the stream changes from run to run: the port
draws from ``torch.Generator``\\ s, JAX from its counter-based keys.  The
cases after those are the port's own: complex128, float32 variables, the
tables' single upload, the workflow's devices.
"""

import re

import numpy as np
import pytest
import scipy.special as sps
import torch

from graph_framework_tpu import expr as jg
from graph_framework_tpu_torch import expr as pg

RTOL = 1.0e-12
#: ``erfi`` against JAX (tests/test_torch_special.py RTOL).
ERFI_RTOL = 1.0e-10


class Side:
    """One package's module, with how to make a variable, evaluate a node
    and read a variable on the host (the port on the CPU)."""

    def __init__(self, g, port):
        self.g, self.port = g, port

    def var(self, size, value=0.0, name="v"):
        if self.port:
            return self.g.variable(size, value, name, device="cpu")
        return self.g.variable(size, value, name)

    def ev(self, e):
        if self.port:
            return e.evaluate(device="cpu").numpy()
        return np.asarray(e.evaluate())

    def data(self, v):
        return v.data.cpu().numpy() if self.port else np.asarray(v.data)

    def workflow(self):
        return self.g.Workflow(device="cpu") if self.port else \
            self.g.Workflow()


JAX = Side(jg, port=False)
PORT = Side(pg, port=True)


def close(got, want, rtol=RTOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=0.0)


def result(latex=(), values=(), erfi_values=()):
    return {"latex": [e.to_latex() for e in latex], "values": list(values),
            "erfi_values": list(erfi_values)}


def run_both(case):
    """Run ``case`` through both modules; the port must give JAX's latex
    strings and values."""
    want, got = case(JAX), case(PORT)
    assert got["latex"] == want["latex"]
    assert len(got["values"]) == len(want["values"])
    for a, b in zip(got["values"], want["values"]):
        close(a, b)
    for a, b in zip(got["erfi_values"], want["erfi_values"]):
        close(a, b, ERFI_RTOL)
    return got


# -- the cases of tests/test_expr.py -----------------------------------------

def evaluate_arithmetic(s):
    a = s.var(3, 2.0, "a")
    b = s.var(3, 5.0, "b")
    e = (a + b) * a - b / a
    np.testing.assert_allclose(s.ev(e), (2 + 5) * 2 - 5 / 2)
    return result([e], [s.ev(e)])


def df_product_rule(s):
    x = s.var(1, 3.0, "x")
    e = x * x * x
    d = e.df(x)
    np.testing.assert_allclose(s.ev(d), 27.0)  # 3x^2
    return result([e, d], [s.ev(d)])


def df_chain_rules(s):
    g = s.g
    x = s.var(1, 0.7, "x")
    cases = [
        (g.sqrt(x), lambda v: 0.5 / np.sqrt(v)),
        (g.exp(x), np.exp),
        (g.log(x), lambda v: 1 / v),
        (g.sin(x), np.cos),
        (g.cos(x), lambda v: -np.sin(v)),
        (g.pow_(x, g.constant(3.0)), lambda v: 3 * v ** 2),
    ]
    ders = [e.df(x) for e, _ in cases]
    for d, (_, dref) in zip(ders, cases):
        np.testing.assert_allclose(s.ev(d), dref(0.7), rtol=1e-12)
    return result(ders, [s.ev(d) for d in ders])


def df_erfi(s):
    x = s.var(1, 0.5, "x")
    e = s.g.erfi(x)
    np.testing.assert_allclose(s.ev(e), sps.erfi(0.5), rtol=1e-12)
    d = float(s.ev(e.df(x)).ravel()[0])
    np.testing.assert_allclose(d, 2 / np.sqrt(np.pi) * np.exp(0.25),
                               rtol=1e-12)
    return result([e, e.df(x)], [s.ev(e.df(x))], [s.ev(e)])


def pseudo_variable_blocks_df(s):
    x = s.var(1, 2.0, "x")
    p = s.g.pseudo_variable(x * x)
    e = p * p
    np.testing.assert_allclose(s.ev(e.df(x)), 0.0)
    np.testing.assert_allclose(s.ev(e.df(p)), 8.0)
    full = e.remove_pseudo()
    np.testing.assert_allclose(s.ev(full.df(x)), 4 * 2.0 ** 3)
    return result([e, e.df(p), full, full.df(x)],
                  [s.ev(e.df(p)), s.ev(full.df(x))])


def atan_conventions(s):
    x = s.var(1, 1.0, "x")
    y = s.var(1, 1.0, "y")
    e = s.g.atan(x, y)
    np.testing.assert_allclose(s.ev(e), np.pi / 4)
    return result([e, e.df(x)], [s.ev(e), s.ev(e.df(x))])


def workflow_setter_loop(s):
    a = s.var(4, 0.0, "a")
    w = s.workflow()
    w.add_loop_item([a], [], [(a + s.g.one(), a)], loops=10)
    w.compile()
    w.run()
    np.testing.assert_allclose(s.data(a), 10.0)
    return result([a + s.g.one()], [s.data(a)])


def workflow_setters_read_pre_update_state(s):
    a = s.var(1, 1.0, "a")
    b = s.var(1, 10.0, "b")
    w = s.workflow()
    w.add_item([a, b], [], [(b, a), (a, b)])   # swap
    w.compile()
    w.run()
    assert float(s.data(a)[0]) == 10.0 and float(s.data(b)[0]) == 1.0
    return result([], [s.data(a), s.data(b)])


def workflow_newton_sqrt2(s):
    x = s.var(8, 3.0, "x")
    f = x * x - s.g.constant(2.0)
    w = s.workflow()
    s.g.newton(w, [x], [x], f, tolerance=1e-28)
    w.compile()
    w.run()
    np.testing.assert_allclose(s.data(x), np.sqrt(2.0), rtol=1e-12)
    setter, = w.items[0].setters
    return result([setter[0], w.items[0].outputs[0]], [s.data(x)])


def random_node_changes_per_run(s):
    r = s.g.random(16, seed=7)
    a = s.var(16, 0.0, "a")
    w = s.workflow()
    w.add_item([a], [], [(s.g.as_expr(r) + a * s.g.zero(), a)])
    w.compile()
    w.run()
    first = s.data(a).copy()
    w.run()
    assert not np.allclose(first, s.data(a))
    assert (s.data(a) >= 0).all() and (s.data(a) < 1).all()
    return result([s.g.as_expr(r) + a * s.g.zero()])


def random_df_zero_and_identity(s):
    r = s.g.random(4)
    x = s.var(4, 1.0, "x")
    d = s.g.as_expr(r).df(x)
    assert float(s.ev(d)) == 0.0
    return result([d], [s.ev(d)])


def piecewise_node(s):
    data = np.arange(8.0)
    x = s.var(3, 0.0, "x")
    x.set(np.array([0.5, 3.7, 9.0]))
    e = s.g.piecewise_1D(data, x, 1.0, 0.0)
    np.testing.assert_allclose(s.ev(e), [0, 3, 7])
    assert float(s.ev(e.df(x))) == 0.0
    return result([e, e.df(x)], [s.ev(e)])


def latex_output(s):
    x = s.var(1, 1.0, "x")
    e = s.g.sin(x) * x
    assert "sin" in e.to_latex() and "x" in e.to_latex()
    return result([e])


def hash_consing_dedupes_structural_builds(s):
    g = s.g
    x = g.Variable(4, name="x", **({"device": "cpu"} if s.port else {}))
    assert (x + 2.0) is (x + 2.0)
    assert g.Sin(x * x) is g.Sin(x * x)
    assert (x + 2.0) is not (x + 2.5)
    assert (x + 2.0) is not (x - 2.0)
    assert g.Random(4) is not g.Random(4)
    assert g.PseudoVariable(x + 1.0) is not g.PseudoVariable(x + 1.0)
    return result([x + 2.0, g.Sin(x * x)])


def is_match_structural_equality(s):
    g = s.g
    x = s.var(4, 0.0, "x")
    y = s.var(4, 0.0, "y")
    a = (x + 1.0) * g.Cos(y)
    b = (x + 1.0) * g.Cos(y)
    assert a.is_match(b)
    assert not a.is_match((x + 1.0) * g.Sin(y))
    assert not (x + 1.0).is_match(y + 1.0)
    clone = a._rebuild(a.children())
    assert clone is not a and a.is_match(clone)
    return result([a, clone])


def random_statistical_quality(s):
    r = s.g.random(20000, seed=11)
    x = s.ev(r)
    assert 0.45 < x.mean() < 0.55
    assert 0.07 < x.var() < 0.10          # uniform: 1/12 ~ 0.0833
    xc = x - x.mean()
    for lag in (1, 2, 5, 10):
        ac = float(np.mean(xc[:-lag] * xc[lag:]) / x.var())
        assert abs(ac) < 0.05, (lag, ac)
    # direct evaluation advances the node's own stream
    assert not np.array_equal(x, s.ev(r))
    return result([r])


CASES = {f.__name__: f for f in (
    evaluate_arithmetic, df_product_rule, df_chain_rules, df_erfi,
    pseudo_variable_blocks_df, atan_conventions, workflow_setter_loop,
    workflow_setters_read_pre_update_state, workflow_newton_sqrt2,
    random_node_changes_per_run, random_df_zero_and_identity,
    piecewise_node, latex_output, hash_consing_dedupes_structural_builds,
    is_match_structural_equality, random_statistical_quality)}


@pytest.mark.parametrize("case", list(CASES))
def test_expr_case_matches_jax(case):
    """tests/test_expr.py's case ``case`` on both packages."""
    run_both(CASES[case])


# -- the port's own ------------------------------------------------------------

def complex_graph(s):
    """complex128 through every node that takes complex values: atan's
    arctan(y/x), erfi, a complex base of pow, complex constants."""
    g = s.g
    rng = np.random.default_rng(5)
    zv = rng.uniform(0.2, 1.5, 6) + 1j * rng.uniform(-1.0, 1.0, 6)
    wv = rng.uniform(0.2, 1.5, 6) + 1j * rng.uniform(-1.0, 1.0, 6)
    z = s.var(6, zv, "z")
    w = s.var(6, wv, "w")
    exprs = [g.atan(z, w), g.pow_(z, g.constant(2.5)), z * (1.0 + 2.0j),
             g.exp(z) / g.log(w) + g.sqrt(z), g.sin(z) * g.cos(w),
             g.atan(z, w).df(z), g.pow_(z, w), (z * z * w).df(w)]
    e = g.erfi(z * w)
    return result(exprs + [e, e.df(z)],
                  [s.ev(x) for x in exprs] + [s.ev(e.df(z))], [s.ev(e)])


def real_variable_complex_constant(s):
    """A complex constant with a float64 variable: complex128, as jnp
    promotes it with x64."""
    x = s.var(3, np.array([0.5, 1.0, 2.0]), "x")
    e = x * (0.5 - 1.5j) + s.g.constant(2.0) * x
    assert s.ev(e).dtype == np.complex128
    return result([e], [s.ev(e)])


def tables_and_gathers(s):
    """piecewise_2D, index_1D and index_2D over a variable's buffer."""
    g = s.g
    rng = np.random.default_rng(9)
    table = rng.standard_normal((6, 5))
    x = s.var(7, rng.uniform(-0.5, 7.0, 7), "x")
    y = s.var(7, rng.uniform(-0.5, 6.0, 7), "y")
    field = s.var(30, rng.standard_normal(30), "field")
    exprs = [g.piecewise_2D(table, 5, x, 1.0, 0.0, y, 1.0, 0.0) * x,
             g.index_1D(field, x, 0.25, -0.5),
             g.index_2D(field, 5, x, 1.0, 0.0, y, 1.0, 0.0) + y,
             2.0 * g.piecewise_1D(table[:, 0], x, 1.0, 0.0) + 1.0]
    return result(exprs, [s.ev(e) for e in exprs])


def tan_and_fma_derivatives(s):
    g = s.g
    x = s.var(5, np.linspace(0.1, 1.2, 5), "x")
    y = s.var(5, np.linspace(-2.0, 3.0, 5), "y")
    e = g.fma(x, y, g.tan(x)) / (x * y + 3.0)
    exprs = [e, e.df(x), e.df(y), e.df(x).df(y)]
    return result(exprs, [s.ev(d) for d in exprs])


OWN_CASES = {f.__name__: f for f in (
    complex_graph, real_variable_complex_constant, tables_and_gathers,
    tan_and_fma_derivatives)}


@pytest.mark.parametrize("case", list(OWN_CASES))
def test_port_case_matches_jax(case):
    run_both(OWN_CASES[case])


def test_vizgraph_matches_jax():
    """The GraphViz dump names the same nodes and edges (node ids aside)."""
    def dump(s):
        x = s.var(2, 1.0, "x")
        return s.g.to_vizgraph((s.g.sin(x) * x + 2.0).df(x))

    def canonical(text):
        ids = {}
        return re.sub(r"n(\d+)",
                      lambda m: "n%d" % ids.setdefault(m.group(1), len(ids)),
                      text)
    assert canonical(dump(PORT)) == canonical(dump(JAX))


def test_float32_variables_compute_in_float32():
    """A float32 variable with Python and numpy constants stays float32
    (the constants are weakly typed, as in jnp)."""
    x = pg.variable(4, 2.0, "x", dtype=torch.float32, device="cpu")
    e = (x * np.float64(3.0) + 1.5) / pg.sqrt(x) + pg.exp(x * x)
    assert e.evaluate().dtype == torch.float32
    w = pg.Workflow(device="cpu")
    w.add_item([x], [e], [(e, x)])
    w.compile()
    out, = w.run()
    assert out.dtype == torch.float32 and x.data.dtype == torch.float32


def test_tables_upload_once():
    """A piecewise table is copied to a device once, not at every emit."""
    rng = np.random.default_rng(2)
    table = rng.standard_normal((9, 9))
    x = pg.variable(5, rng.uniform(0.0, 9.0, 5), "x", device="cpu")
    y = pg.variable(5, rng.uniform(0.0, 9.0, 5), "y", device="cpu")
    e = pg.piecewise_2D(table, 9, x, 1.0, 0.0, y, 1.0, 0.0) * x
    w = pg.Workflow(device="cpu")
    w.add_loop_item([x, y], [], [(e + y, y)], loops=3)
    w.compile()
    before = pg.table_uploads
    w.run()
    w.run()
    e.evaluate()
    assert pg.table_uploads - before == 1
    # a float32 copy of the table is another upload
    e32 = pg.piecewise_1D(table[0].astype(np.float32), x, 1.0, 0.0)
    e32.evaluate()
    e32.evaluate()
    assert pg.table_uploads - before == 2


def test_setter_result_broadcasts():
    """A size-1 setter result fills the variable, as np.broadcast_to does
    in the JAX package; the variable stays on its device."""
    a = pg.variable(4, 0.0, "a", device="cpu")
    b = pg.variable(1, 2.5, "b", device="cpu")
    w = pg.Workflow(device="cpu")
    w.add_item([a, b], [], [(b * 2.0, a), (pg.constant(7.0), b)])
    w.compile()
    w.run()
    assert a.data.shape == (4,) and torch.all(a.data == 5.0)
    assert b.data.shape == (1,) and float(b.data[0]) == 7.0


def test_workflow_random_stream_is_seeded():
    """An item's generator is seeded 1234 + len(setters): two workflows of
    the same item draw the same stream, run after run."""
    def draws():
        a = pg.variable(64, 0.0, "a", device="cpu")
        w = pg.Workflow(device="cpu")
        w.add_item([a], [], [(pg.random(64, seed=3) + a * pg.zero(), a)])
        w.compile()
        w.run()
        first = a.data.clone()
        w.run()
        return first, a.data.clone()
    (a1, a2), (b1, b2) = draws(), draws()
    assert torch.equal(a1, b1) and torch.equal(a2, b2)
    assert not torch.equal(a1, a2)


def test_evaluate_without_variables_takes_a_device():
    """A graph without variables evaluates on the device the caller names,
    in float64 (complex128), as jnp with x64 gives it."""
    e = pg.constant(1.0) / pg.constant(0.0) + pg.sqrt(pg.Constant(4.0))
    out = e.evaluate(device="cpu")
    assert out.dtype == torch.float64 and out.device.type == "cpu"
    assert float(out) == np.inf
    c = pg.Sin(pg.Constant(1.0 + 1.0j)).evaluate(device="cpu")
    assert c.dtype == torch.complex128
    np.testing.assert_allclose(c.numpy(), np.sin(1.0 + 1.0j), rtol=RTOL)


def test_variable_rejects_non_finite():
    with pytest.raises(AssertionError, match="NaN or inf"):
        pg.variable(3, np.array([1.0, np.nan, 0.0]), "x", device="cpu")
    with pytest.raises(AssertionError, match="NaN or inf"):
        pg.variable(3, torch.tensor([1.0, np.inf, 0.0]), "x")


def test_schedule_orders_children_first():
    """An item's schedule holds every node once, each after its children;
    deep graphs need no recursion."""
    x = pg.variable(2, 1.0, "x", device="cpu")
    e = x
    for k in range(3000):
        e = pg.Sin(e) + float(k)
    nodes = pg.schedule([e, e * x])
    position = {n.id: i for i, n in enumerate(nodes)}
    assert len(position) == len(nodes)
    for n in nodes:
        assert all(position[c.id] < position[n.id] for c in n.children())
    assert torch.isfinite(e.evaluate()).all()


def test_copy_and_check_value():
    x = pg.variable(3, 1.0, "x", device="cpu")
    w = pg.Workflow(device="cpu")
    w.copy_to_device(x, np.array([1.0, 2.0, 3.0]))
    np.testing.assert_array_equal(w.copy_to_host(x), [1.0, 2.0, 3.0])
    assert w.check_value(2, x * x) == 9.0
    w.wait()
