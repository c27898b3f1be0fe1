"""Expression graphs and their workflow (the embedding API).

Counterpart of ``graph_framework_tpu.expr``.  The reference's user-facing
embedding API is symbolic graph construction -
``graph::variable/constant/add/.../df`` - plus a ``workflow::manager`` that
compiles setter kernels (reference: graph_c_binding/graph_c_binding.h:177-639,
graph_framework/workflow.hpp).  The physics stack (models/, solver.py) does
not need it; legacy embedders (the C and Fortran bindings over
``capi_bridge``) speak it.

The graph-building half is the JAX package's, pure Python and numpy, so the
two packages reduce one build sequence to one structure:

* hash-consed nodes (``_InternMeta``), ``is_match``, ``remove_pseudo``,
  ``reduce``;
* ``df()`` applies textbook derivative rules producing new expression nodes;
* the factory functions (``add/sub/mul/div/fma_/...``, also reached through
  operator sugar) apply the numerically load-bearing subset of the
  reference's ``reduce()`` rewrite system at construction time (constant
  folding, identity elimination, fma formation, exponent gathering, exp/log
  inverses, piecewise-table folding; arithmetic.hpp:132-3736, math.hpp).

The evaluation half is eager PyTorch.  ``emit_cached(rec, env)`` is a plain
function of its children's tensors; ``env`` (:class:`Env`) names the device
a graph without variables runs on, and the values that stand in for
variables and random nodes.  A constant emits its Python or numpy scalar,
which torch promotes as a weakly typed scalar (as jnp does): a float32
variable times a constant stays float32, a complex constant with a float64
variable gives complex128.  A graph made of constants alone evaluates in
float64 (complex128), as jnp does with x64.

* A variable holds a tensor on its device (the card unless the caller names
  another); ``Workflow`` never uploads it and reads it back only in
  ``copy_to_host``, ``check_value`` and a converge item's one scalar an
  iteration.
* A piecewise table keeps its numpy copy (hashing, ``_match_payload``,
  ``_fold_tables``) and is uploaded once for each (device, dtype), at its
  first use there (``table_uploads`` counts the uploads).
* There is no jit: ``_Item.compile`` works out the topological order of its
  expressions once (:func:`schedule`) and ``run`` executes that schedule
  eagerly, one device operation or a few for each node.
* Random nodes draw from ``torch.Generator``\\ s: a workflow item has one on
  its device, seeded ``1234 + len(setters)`` as the JAX item seeds its key,
  and direct evaluation uses a generator of the node's own, seeded with its
  seed.  The streams differ from JAX's by design; only their statistics
  are comparable.
"""

from __future__ import annotations

import itertools
import math
import weakref
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from graph_framework_tpu_torch.ops import special as _special
from graph_framework_tpu_torch.ops import tables as _tables


#: hash-consing cache: structural key -> live node (weak, so unreferenced
#: subgraphs are evicted rather than leaking across graph builds).
_INTERN: "weakref.WeakValueDictionary" = weakref.WeakValueDictionary()

#: How many times a piecewise table was copied to a device (each table once
#: for each device and dtype it is evaluated on).
table_uploads = 0


class _InternMeta(type):
    """Hash-consing constructor cache (node.hpp:946-960).

    Constructing a structurally identical immutable node returns the cached
    instance, so identical subexpressions share one object (and one emit
    per evaluation) - the reference's thread_local node caches with
    linear-probe collision handling, done with a Python dict.  Classes
    opt in by defining ``_intern_key`` (returning None skips the cache);
    mutable nodes (Variable, Random) and identity-like wrappers
    (PseudoVariable) stay uncached.
    """

    def __call__(cls, *args, **kw):
        keyfn = getattr(cls, "_intern_key", None)
        key = keyfn(*args, **kw) if keyfn is not None else None
        if key is None:
            return super().__call__(*args, **kw)
        key = (cls, *key)
        hit = _INTERN.get(key)
        if hit is None:
            hit = super().__call__(*args, **kw)
            _INTERN[key] = hit
        return hit


# -- evaluation context -------------------------------------------------------

def _scalar_dtype(value) -> torch.dtype:
    """The dtype jnp (with x64) gives a scalar of its own: numpy scalars
    keep theirs; Python float, complex and int are 64-bit."""
    if isinstance(value, np.generic):
        return torch.from_numpy(np.asarray(value)).dtype
    if isinstance(value, bool):
        return torch.bool
    if isinstance(value, int):
        return torch.int64
    if isinstance(value, complex):
        return torch.complex128
    return torch.float64


class Env:
    """What a node's emit needs besides its children's values.

    ``device``: where values that are not yet tensors are made (the
    variables' device; for a graph without variables the caller's);
    ``values``: tensors that stand in for variables (``evaluate(env=...)``);
    ``draws``: the uniform samples of the random nodes, by node (a workflow
    item draws them from its generator before it runs the schedule)."""

    def __init__(self, device, values=None, draws=None):
        self.device = torch.device(device)
        self.values = values or {}
        self.draws = draws or {}

    def tensor(self, value, like=None) -> torch.Tensor:
        """``value`` as a tensor on the device: a tensor as it is; a scalar
        in the dtype torch promotes it to against ``like`` (a tensor), else
        in its own dtype."""
        if isinstance(value, torch.Tensor):
            return value
        if isinstance(value, np.ndarray):
            return torch.as_tensor(value, device=self.device)
        dtype = (torch.result_type(like, value)
                 if isinstance(like, torch.Tensor) else _scalar_dtype(value))
        if isinstance(value, np.generic):
            value = value.item()
        return torch.as_tensor(value, dtype=dtype, device=self.device)

    def pair(self, a, b):
        """Two operands of an arithmetic operator, at least one a tensor."""
        if not isinstance(a, torch.Tensor) and not isinstance(b, torch.Tensor):
            a = self.tensor(a)
        return a, b


def _graph_device(root: "Expr", device):
    """The device of the variables in ``root``, else ``device`` (the card
    unless the caller names another)."""
    for e in walk(root):
        if isinstance(e, Variable):
            return e.data.device
    return torch.device("cuda" if device is None else device)


class Expr(metaclass=_InternMeta):
    """Base expression node."""

    _ids = itertools.count()

    def __init__(self):
        self.id = next(Expr._ids)

    # -- operator sugar (matches the C API's graph_add/sub/mul/div);
    # routed through the reducing factories so graphs simplify as they
    # are built, like the reference's factory functions (node.hpp
    # constant()/add()/... each call reduce()).
    def __add__(self, o):
        return add(self, o)

    def __radd__(self, o):
        return add(o, self)

    def __sub__(self, o):
        return sub(self, o)

    def __rsub__(self, o):
        return sub(o, self)

    def __mul__(self, o):
        return mul(self, o)

    def __rmul__(self, o):
        return mul(o, self)

    def __truediv__(self, o):
        return div(self, o)

    def __rtruediv__(self, o):
        return div(o, self)

    def __neg__(self):
        return mul(Constant(-1.0), self)

    def __pow__(self, o):
        return pow_(self, o)

    # -- interface ---------------------------------------------------------
    def children(self) -> Tuple["Expr", ...]:
        return ()

    def emit_cached(self, rec, env: Env):
        """This node's value from its children's (``rec(child)``)."""
        raise NotImplementedError

    def df(self, var: "Expr") -> "Expr":
        """Symbolic derivative w.r.t. ``var`` (node.hpp df)."""
        raise NotImplementedError

    def evaluate(self, env=None, device=None) -> torch.Tensor:
        """Evaluate now (leaf_node::evaluate): on the device of the graph's
        variables; a graph without variables on ``device``, the card unless
        the caller names another.  ``env`` maps variables to values that
        stand in for their buffers."""
        dev = _graph_device(self, device)
        values = {v: torch.as_tensor(x, device=dev)
                  for v, x in (env or {}).items()}
        e = Env(dev, values)
        return e.tensor(_eval(self, e))

    # latex / visualization (node.hpp to_latex/to_vizgraph)
    def to_latex(self) -> str:
        raise NotImplementedError

    def _match_payload(self):
        """Structural payload for is_match; None = identity-only node
        (Variable, PseudoVariable, Random - the reference's variable-like
        nodes match only themselves)."""
        return ()

    def is_match(self, other: "Expr") -> bool:
        """Structural equality (node.hpp is_match).  With the constructor
        cache (hash-consing) structurally identical graphs are usually the
        same object, so this is an O(1) identity hit in practice; the
        recursive compare covers nodes built outside the cache
        (_rebuild clones, uncacheable payloads)."""
        if self is other:
            return True
        if type(self) is not type(other):
            return False
        pa, pb = self._match_payload(), other._match_payload()
        if pa is None or pb is None or pa != pb:
            return False
        ca, cb = self.children(), other.children()
        return len(ca) == len(cb) and all(
            x.is_match(y) for x, y in zip(ca, cb))

    def remove_pseudo(self) -> "Expr":
        """Strip pseudo-variable wrappers (node.hpp remove_pseudo)."""
        subs = tuple(c.remove_pseudo() for c in self.children())
        if subs == self.children():
            return self
        return self._rebuild(subs)

    def reduce(self) -> "Expr":
        """Bottom-up algebraic simplification (leaf_node::reduce).

        Graphs built through the factories/operators are already reduced
        as constructed; this re-runs the rules over a whole tree (useful
        after ``remove_pseudo`` or for hand-assembled nodes)."""
        ch = tuple(c.reduce() for c in self.children())
        fac = _REDUCE_FACTORIES.get(type(self))
        if fac is not None:
            return fac(*ch)
        if ch == self.children():
            return self
        return self._rebuild(ch)

    def _rebuild(self, children):
        clone = type(self).__new__(type(self))
        clone.__dict__.update(self.__dict__)
        clone.id = next(Expr._ids)
        clone._set_children(children)
        return clone

    def _set_children(self, children):
        raise NotImplementedError


def as_expr(v):
    return v if isinstance(v, Expr) else Constant(v)


def schedule(roots: Sequence[Expr]) -> List[Expr]:
    """Every node under ``roots`` once, each after its children (the
    topological order a workflow item runs; iterative, so deep graphs do
    not reach Python's recursion limit)."""
    order, seen = [], set()
    for root in roots:
        stack = [(root, False)]
        while stack:
            e, ready = stack.pop()
            if ready:
                order.append(e)
                continue
            if e.id in seen:
                continue
            seen.add(e.id)
            stack.append((e, True))
            stack.extend((c, False) for c in reversed(e.children())
                         if c.id not in seen)
    return order


def _run_schedule(nodes: Sequence[Expr], env: Env) -> Dict[int, object]:
    vals: Dict[int, object] = {}
    rec = lambda e: vals[e.id]        # noqa: E731 - children come first
    for e in nodes:
        vals[e.id] = e.emit_cached(rec, env)
    return vals


def _eval(root: Expr, env: Env):
    return _run_schedule(schedule([root]), env)[root.id]


def walk(root: Expr):
    """Yield every node in the tree once."""
    seen = set()
    stack = [root]
    while stack:
        e = stack.pop()
        if e.id in seen:
            continue
        seen.add(e.id)
        yield e
        stack.extend(e.children())


class Constant(Expr):
    def __init__(self, value):
        super().__init__()
        self.value = value

    @staticmethod
    def _intern_key(value):
        if isinstance(value, (bool, int, float, complex,
                              np.integer, np.floating, np.complexfloating)):
            return (type(value), value)
        return None           # array-valued constants: not interned

    def _match_payload(self):
        if isinstance(self.value, np.ndarray):
            return (self.value.tobytes(), self.value.shape)
        return (self.value,)

    def emit_cached(self, rec, env):
        if isinstance(self.value, np.ndarray):
            return env.tensor(self.value)
        if isinstance(self.value, np.generic):
            # as a Python scalar: torch reads a numpy complex64 scalar
            # operand as real
            return self.value.item()
        return self.value     # a weakly typed scalar, promoted by torch

    def df(self, var):
        return Constant(0.0)

    def is_(self, v):
        return (not isinstance(self.value, np.ndarray)
                and complex(self.value) == v)

    def to_latex(self):
        return f"{self.value}"


def _variable_data(size, value, dtype, device):
    """A variable's buffer: ``value`` (a scalar, a numpy array or a tensor)
    as a tensor of ``size`` elements on ``device``."""
    if isinstance(value, torch.Tensor):
        data = value.to(device=device if device is not None
                        else value.device)
    elif np.ndim(value) == 0:
        dev = "cuda" if device is None else device
        data = torch.full((size,), value, device=dev,
                          dtype=_scalar_dtype(value))
    else:
        data = torch.as_tensor(np.asarray(value),
                               device="cuda" if device is None else device)
    return data if dtype is None else data.to(dtype)


class Variable(Expr):
    """Named mutable buffer (node.hpp variable_node): a tensor on its device
    (the card unless the caller names another), float64 (complex128 for a
    complex value) unless ``dtype`` says otherwise."""

    def __init__(self, size: int, value=0.0, name: str = "v", *,
                 dtype: Optional[torch.dtype] = None, device=None):
        super().__init__()
        self.size = size
        self.name = name
        self.data = _variable_data(size, value, dtype, device)
        assert bool(torch.isfinite(self.data).all()), \
            "NaN or inf in variable buffer (node.hpp:1426)"

    def _match_payload(self):
        return None           # a variable matches only itself

    def set(self, value):
        """Replace the buffer (on the same device; a scalar keeps the
        buffer's dtype, promoted to complex for a complex value)."""
        dev = self.data.device
        if isinstance(value, np.ndarray) and value.ndim == 0:
            value = value.item()
        if np.ndim(value) == 0 and not isinstance(value, torch.Tensor):
            dtype = torch.result_type(self.data, value)
            self.data = torch.full((self.size,), value, dtype=dtype,
                                   device=dev)
        else:
            self.data = _variable_data(self.size, value, None, dev)

    def emit_cached(self, rec, env):
        return env.values.get(self, self.data)

    def df(self, var):
        return Constant(1.0 if var is self else 0.0)

    def to_latex(self):
        return self.name


class PseudoVariable(Expr):
    """Wrap a subexpression so df treats it as independent
    (node.hpp:1745-1860)."""

    def __init__(self, inner: Expr):
        super().__init__()
        self.inner = inner

    def _match_payload(self):
        return None           # pseudo variables are distinct variables

    def children(self):
        return (self.inner,)

    def _set_children(self, c):
        (self.inner,) = c

    def emit_cached(self, rec, env):
        return rec(self.inner)

    def df(self, var):
        return Constant(1.0 if var is self else 0.0)

    def remove_pseudo(self):
        return self.inner.remove_pseudo()

    def to_latex(self):
        return self.inner.to_latex()


class _Binary(Expr):
    sym = "?"

    def __init__(self, a: Expr, b: Expr):
        super().__init__()
        self.a, self.b = a, b

    @staticmethod
    def _intern_key(a, b):
        if isinstance(a, Expr) and isinstance(b, Expr):
            return (id(a), id(b))
        return None

    def children(self):
        return (self.a, self.b)

    def _set_children(self, c):
        self.a, self.b = c

    def to_latex(self):
        return f"\\left({self.a.to_latex()}{self.sym}{self.b.to_latex()}\\right)"


class Add(_Binary):
    sym = "+"

    def emit_cached(self, rec, env):
        a, b = env.pair(rec(self.a), rec(self.b))
        return a + b

    def df(self, var):
        return self.a.df(var) + self.b.df(var)


class Sub(_Binary):
    sym = "-"

    def emit_cached(self, rec, env):
        a, b = env.pair(rec(self.a), rec(self.b))
        return a - b

    def df(self, var):
        return self.a.df(var) - self.b.df(var)


class Mul(_Binary):
    sym = " "

    def emit_cached(self, rec, env):
        a, b = env.pair(rec(self.a), rec(self.b))
        return a * b

    def df(self, var):
        return self.a.df(var) * self.b + self.a * self.b.df(var)


class Div(_Binary):
    sym = "/"

    def emit_cached(self, rec, env):
        a, b = env.pair(rec(self.a), rec(self.b))
        return a / b

    def df(self, var):
        return (self.a.df(var) * self.b - self.a * self.b.df(var)) \
            / (self.b * self.b)


class Fma(Expr):
    """fma(a, b, c) = a*b + c (arithmetic.hpp fma_node)."""

    @staticmethod
    def _intern_key(a, b, c):
        if all(isinstance(v, Expr) for v in (a, b, c)):
            return (id(a), id(b), id(c))
        return None

    def __init__(self, a, b, c):
        super().__init__()
        self.a, self.b, self.c = as_expr(a), as_expr(b), as_expr(c)

    def children(self):
        return (self.a, self.b, self.c)

    def _set_children(self, ch):
        self.a, self.b, self.c = ch

    def emit_cached(self, rec, env):
        a, b = env.pair(rec(self.a), rec(self.b))
        return a * b + rec(self.c)

    def df(self, var):
        return fma_(self.a.df(var), self.b,
                    fma_(self.a, self.b.df(var), self.c.df(var)))

    def to_latex(self):
        return (f"\\left({self.a.to_latex()} {self.b.to_latex()}"
                f"+{self.c.to_latex()}\\right)")


class _Unary(Expr):
    fn = None
    name = "?"

    @staticmethod
    def _intern_key(a):
        return (id(a),) if isinstance(a, Expr) else None

    def __init__(self, a: Expr):
        super().__init__()
        self.a = as_expr(a)

    def children(self):
        return (self.a,)

    def _set_children(self, c):
        (self.a,) = c

    def emit_cached(self, rec, env):
        return type(self).fn(env.tensor(rec(self.a)))

    def to_latex(self):
        return f"\\{self.name}\\left({self.a.to_latex()}\\right)"


class Sqrt(_Unary):
    fn = torch.sqrt
    name = "sqrt"

    def df(self, var):
        return self.a.df(var) / (Constant(2.0) * Sqrt(self.a))


class Exp(_Unary):
    fn = torch.exp
    name = "exp"

    def df(self, var):
        return self.a.df(var) * Exp(self.a)


class Log(_Unary):
    fn = torch.log
    name = "ln"

    def df(self, var):
        return self.a.df(var) / self.a


class Sin(_Unary):
    fn = torch.sin
    name = "sin"

    def df(self, var):
        return self.a.df(var) * Cos(self.a)


class Cos(_Unary):
    fn = torch.cos
    name = "cos"

    def df(self, var):
        return Constant(-1.0) * self.a.df(var) * Sin(self.a)


class Erfi(_Unary):
    name = "erfi"
    fn = staticmethod(_special.erfi)

    def df(self, var):
        # d erfi/dz = 2/sqrt(pi) exp(z^2) (math.hpp erfi_node df)
        return (Constant(2.0 / math.sqrt(math.pi))
                * Exp(self.a * self.a) * self.a.df(var))


class Pow(_Binary):
    sym = "^"

    def emit_cached(self, rec, env):
        a, b = rec(self.a), rec(self.b)
        if not isinstance(a, torch.Tensor):
            a = env.tensor(a, like=b)
        return a ** b

    def df(self, var):
        # general rule a^b (b constant in practice; math.hpp pow_node)
        if isinstance(self.b, Constant):
            return (self.b * pow_(self.a, Constant(self.b.value - 1))
                    * self.a.df(var))
        return pow_(self.a, self.b) * (
            self.b.df(var) * log(self.a) + self.b * self.a.df(var) / self.a)


class Atan(_Binary):
    """atan(x, y) = atan2(y, x) for real; atan(y/x) for complex
    (trigonometry.hpp arctan, backend.hpp:1130-1150)."""
    sym = ","

    def emit_cached(self, rec, env):
        x, y = rec(self.a), rec(self.b)
        x = env.tensor(x, like=y)
        y = env.tensor(y, like=x)
        if x.is_complex() or y.is_complex():
            return torch.atan(y / x)
        return torch.atan2(y, x)

    def df(self, var):
        x, y = self.a, self.b
        return (x * y.df(var) - y * x.df(var)) / (x * x + y * y)


class Random(Expr):
    """Uniform random node (random.hpp random_node): a fresh sample per
    evaluation per element, of ``dtype`` (float64 unless named).  A
    workflow item draws it from the item's generator; direct evaluate()
    from a generator of the node's own on the device, seeded with
    ``seed`` (the reference advances per-thread MT state on device,
    random.hpp:314-340)."""

    def __init__(self, size: int, seed: int = 0, *,
                 dtype: torch.dtype = torch.float64):
        super().__init__()
        self.size = size
        self.seed = seed
        self.dtype = dtype
        self._generators = {}

    def _match_payload(self):
        return None           # every random node is an independent stream

    def draw(self, generator, device):
        return torch.rand(self.size, generator=generator, device=device,
                          dtype=self.dtype)

    def emit_cached(self, rec, env):
        if self in env.draws:
            return env.draws[self]
        gen = self._generators.get(env.device)
        if gen is None:
            gen = torch.Generator(device=env.device).manual_seed(self.seed)
            self._generators[env.device] = gen
        return self.draw(gen, env.device)

    def df(self, var):
        return Constant(0.0)

    def to_latex(self):
        return "\\mathrm{rand}"


class _Table(Expr):
    """A node that gathers from a constant numpy table: the table is copied
    to a device once for each (device, dtype) and kept there."""

    def _table(self, device) -> torch.Tensor:
        global table_uploads
        cache = self.__dict__.setdefault("_uploaded", {})
        key = (device, self.data.dtype)
        table = cache.get(key)
        if table is None:
            data = self.data if self.data.flags.writeable else \
                self.data.copy()
            table = torch.as_tensor(data, device=device)
            cache[key] = table
            table_uploads += 1
        return table


class Piecewise1D(_Table):
    """piecewise_1D table lookup (piecewise.hpp:105-...)."""

    @staticmethod
    def _intern_key(data, arg, scale, offset):
        # hash the table data like the reference does (piecewise.hpp:140-189)
        if isinstance(arg, Expr) and np.isscalar(scale) and np.isscalar(offset):
            d = np.asarray(data)
            return (hash(d.tobytes()), d.shape, id(arg), scale, offset)
        return None

    def _match_payload(self):
        return (self.data.tobytes(), self.scale, self.offset)

    def __init__(self, data, arg: Expr, scale, offset):
        super().__init__()
        self.data = np.asarray(data)
        self.arg = as_expr(arg)
        self.scale, self.offset = scale, offset

    def children(self):
        return (self.arg,)

    def _set_children(self, c):
        (self.arg,) = c

    def emit_cached(self, rec, env):
        return _tables.piecewise_1d(self._table(env.device),
                                    env.tensor(rec(self.arg)),
                                    self.scale, self.offset)

    def df(self, var):
        return Constant(1.0 if var is self else 0.0)

    def to_latex(self):
        return "\\mathrm{table}\\left(%s\\right)" % self.arg.to_latex()


class Piecewise2D(_Table):
    """piecewise_2D table lookup (piecewise.hpp:686-...)."""

    @staticmethod
    def _intern_key(data, num_cols, x, x_scale, x_offset,
                    y, y_scale, y_offset):
        if isinstance(x, Expr) and isinstance(y, Expr):
            d = np.asarray(data)
            return (hash(d.tobytes()), d.shape, int(num_cols), id(x),
                    x_scale, x_offset, id(y), y_scale, y_offset)
        return None

    def _match_payload(self):
        return (self.data.tobytes(), self.x_scale, self.x_offset,
                self.y_scale, self.y_offset)

    def __init__(self, data, num_cols, x, x_scale, x_offset,
                 y, y_scale, y_offset):
        super().__init__()
        self.data = np.asarray(data).reshape(-1, num_cols)
        self.x, self.y = as_expr(x), as_expr(y)
        self.x_scale, self.x_offset = x_scale, x_offset
        self.y_scale, self.y_offset = y_scale, y_offset

    def children(self):
        return (self.x, self.y)

    def _set_children(self, c):
        self.x, self.y = c

    def emit_cached(self, rec, env):
        return _tables.piecewise_2d(
            self._table(env.device), env.tensor(rec(self.x)), self.x_scale,
            self.x_offset, env.tensor(rec(self.y)), self.y_scale,
            self.y_offset)

    def df(self, var):
        return Constant(1.0 if var is self else 0.0)

    def to_latex(self):
        return "\\mathrm{table2d}\\left(%s,%s\\right)" % (
            self.x.to_latex(), self.y.to_latex())


class Index1D(Expr):
    """index_1D gather from a mutable variable (piecewise.hpp:1448-1755):
    the PIC field gather - identical arithmetic to Piecewise1D but the
    source is a workflow variable updated between runs."""

    @staticmethod
    def _intern_key(var, arg, scale, offset):
        if isinstance(var, Variable) and isinstance(arg, Expr):
            return (id(var), id(arg), scale, offset)
        return None

    def _match_payload(self):
        return (self.scale, self.offset)

    def __init__(self, var: "Variable", arg: Expr, scale, offset):
        super().__init__()
        self.var = var
        self.arg = as_expr(arg)
        self.scale, self.offset = scale, offset

    def children(self):
        return (self.var, self.arg)

    def _set_children(self, c):
        self.var, self.arg = c

    def emit_cached(self, rec, env):
        return _tables.index_1d(rec(self.var), env.tensor(rec(self.arg)),
                                self.scale, self.offset)

    def df(self, var):
        return Constant(1.0 if var is self else 0.0)

    def to_latex(self):
        return "%s\\left[%s\\right]" % (self.var.to_latex(),
                                        self.arg.to_latex())


class Index2D(Expr):
    """index_2D gather from a mutable variable over a 2D grid
    (the 2D analogue of Index1D; reference graph_c_binding.h index_2D)."""

    @staticmethod
    def _intern_key(var, num_cols, x, x_scale, x_offset,
                    y, y_scale, y_offset):
        if isinstance(var, Variable) and isinstance(x, Expr) \
                and isinstance(y, Expr):
            return (id(var), int(num_cols), id(x), x_scale, x_offset,
                    id(y), y_scale, y_offset)
        return None

    def _match_payload(self):
        return (self.num_cols, self.x_scale, self.x_offset,
                self.y_scale, self.y_offset)

    def __init__(self, var: "Variable", num_cols, x, x_scale, x_offset,
                 y, y_scale, y_offset):
        super().__init__()
        self.var = var
        self.num_cols = int(num_cols)
        self.x, self.y = as_expr(x), as_expr(y)
        self.x_scale, self.x_offset = x_scale, x_offset
        self.y_scale, self.y_offset = y_scale, y_offset

    def children(self):
        return (self.var, self.x, self.y)

    def _set_children(self, c):
        self.var, self.x, self.y = c

    def emit_cached(self, rec, env):
        data = rec(self.var).reshape(-1, self.num_cols)
        return _tables.piecewise_2d(
            data, env.tensor(rec(self.x)), self.x_scale, self.x_offset,
            env.tensor(rec(self.y)), self.y_scale, self.y_offset)

    def df(self, var):
        return Constant(1.0 if var is self else 0.0)

    def to_latex(self):
        return "%s\\left[%s,%s\\right]" % (
            self.var.to_latex(), self.x.to_latex(), self.y.to_latex())


def to_vizgraph(root: Expr) -> str:
    """GraphViz DAG dump (node.hpp make_vizgraph, :700-717)."""
    lines = ["digraph G {"]
    for e in walk(root):
        label = type(e).__name__
        if isinstance(e, Variable):
            label = f"var {e.name}"
        elif isinstance(e, Constant):
            label = f"{e.value}"
        lines.append(f'  n{e.id} [label="{label}"];')
        for c in e.children():
            lines.append(f"  n{e.id} -> n{c.id};")
    lines.append("}")
    return "\n".join(lines)


# factory helpers mirroring the graph:: namespace
def variable(size, value=0.0, name="v", *, dtype=None, device=None):
    """A variable of ``size`` elements on ``device`` (the card unless the
    caller names another)."""
    return Variable(size, value, name, dtype=dtype, device=device)


def constant(v):
    return Constant(v)


def pseudo_variable(e):
    return PseudoVariable(e)


def one():
    return Constant(1.0)


def zero():
    return Constant(0.0)


# ---------------------------------------------------------------------------
# reducing factories: the numerically load-bearing subset of the
# reference's reduce() rewrite system (arithmetic.hpp:132-3736,
# math.hpp:26-1439), applied at construction time like the reference's
# graph:: factory functions.  Rules involving structural identity
# (a+a -> 2a, a-a -> 0, a*a -> a^2, a/a -> 1) are guarded against random
# subtrees: two uses of a random stream are NOT the same value
# (random_test.cpp graph-identity rules), while identity elimination
# (r+0 -> r, r*1 -> r) is always safe.
# ---------------------------------------------------------------------------

def _has_random(e: Expr) -> bool:
    flag = getattr(e, "_rand_flag", None)
    if flag is None:
        flag = isinstance(e, Random) or any(
            _has_random(c) for c in e.children())
        e._rand_flag = flag
    return flag


def _same(a: Expr, b: Expr) -> bool:
    return (a is b or a.is_match(b)) and not _has_random(a)


def _c(e):
    """Constant payload or None."""
    return e.value if isinstance(e, Constant) else None


def _fold_tables(op, a, b):
    """Piecewise-table folding (the is_constant_combinable branch of the
    reference's arithmetic reduce, arithmetic.hpp:24-61, 192-248):
    ``scalar-constant OP table`` folds into ONE new table, and
    ``table OP table`` with matching argument/scale/offset likewise -
    the kernel then carries a single gather where the source had two
    nodes.  Returns the folded Expr or None."""
    va, vb = _c(a), _c(b)
    with np.errstate(all="ignore"):
        if isinstance(a, Piecewise1D):
            if vb is not None:
                return piecewise_1D(op(a.data, vb), a.arg,
                                    a.scale, a.offset)
            if (isinstance(b, Piecewise1D) and _same(a.arg, b.arg)
                    and a.scale == b.scale and a.offset == b.offset
                    and a.data.shape == b.data.shape):
                return piecewise_1D(op(a.data, b.data), a.arg,
                                    a.scale, a.offset)
        if isinstance(b, Piecewise1D) and va is not None:
            return piecewise_1D(op(va, b.data), b.arg, b.scale, b.offset)
        if isinstance(a, Piecewise2D):
            if vb is not None:
                return piecewise_2D(op(a.data, vb), a.data.shape[1],
                                    a.x, a.x_scale, a.x_offset,
                                    a.y, a.y_scale, a.y_offset)
            if (isinstance(b, Piecewise2D) and _same(a.x, b.x)
                    and _same(a.y, b.y)
                    and (a.x_scale, a.x_offset, a.y_scale, a.y_offset)
                    == (b.x_scale, b.x_offset, b.y_scale, b.y_offset)
                    and a.data.shape == b.data.shape):
                return piecewise_2D(op(a.data, b.data), a.data.shape[1],
                                    a.x, a.x_scale, a.x_offset,
                                    a.y, a.y_scale, a.y_offset)
        if isinstance(b, Piecewise2D) and va is not None:
            return piecewise_2D(op(va, b.data), b.data.shape[1],
                                b.x, b.x_scale, b.x_offset,
                                b.y, b.y_scale, b.y_offset)
    return None


def add(a, b) -> Expr:
    """a + b with reductions (add_node::reduce, arithmetic.hpp:132-870)."""
    a, b = as_expr(a), as_expr(b)
    va, vb = _c(a), _c(b)
    if va is not None and vb is not None:
        return Constant(va + vb)
    if va is not None and a.is_(0):
        return b
    if vb is not None and b.is_(0):
        return a
    folded = _fold_tables(np.add, a, b)
    if folded is not None:
        return folded
    if _same(a, b):
        return mul(Constant(2.0), a)
    # fma formation: a*b + c -> fma(a, b, c) (arithmetic.hpp:271-277)
    if isinstance(a, Mul):
        return Fma(a.a, a.b, b)
    if isinstance(b, Mul):
        return Fma(b.a, b.b, a)
    return Add(a, b)


def sub(a, b) -> Expr:
    """a - b with reductions (subtract_node::reduce,
    arithmetic.hpp:879-1710)."""
    a, b = as_expr(a), as_expr(b)
    va, vb = _c(a), _c(b)
    if va is not None and vb is not None:
        return Constant(va - vb)
    if vb is not None and b.is_(0):
        return a
    if va is not None and a.is_(0):
        return mul(Constant(-1.0), b)
    folded = _fold_tables(np.subtract, a, b)
    if folded is not None:
        return folded
    if _same(a, b):
        return Constant(0.0)
    return Sub(a, b)


def mul(a, b) -> Expr:
    """a * b with reductions (multiply_node::reduce,
    arithmetic.hpp:1720-2760): folding, identities, constant-left
    normalization, exponent gathering."""
    a, b = as_expr(a), as_expr(b)
    va, vb = _c(a), _c(b)
    if va is not None and vb is not None:
        return Constant(va * vb)
    if (va is not None and a.is_(0)) or (vb is not None and b.is_(0)):
        return Constant(0.0)
    if va is not None and a.is_(1):
        return b
    if vb is not None and b.is_(1):
        return a
    if vb is not None and va is None:            # constants move left
        a, b = b, a
        va, vb = vb, va
    if va is not None and isinstance(b, Mul) and isinstance(b.a, Constant):
        return mul(Constant(va * b.a.value), b.b)
    folded = _fold_tables(np.multiply, a, b)
    if folded is not None:
        return folded
    # exponent gathering: x*x -> x^2, x * x^c -> x^(c+1), x^c1 * x^c2
    if _same(a, b):
        return Pow(a, Constant(2.0))
    if (isinstance(b, Pow) and isinstance(b.b, Constant)
            and _same(a, b.a)):
        return pow_(a, Constant(b.b.value + 1))
    if (isinstance(a, Pow) and isinstance(a.b, Constant)
            and _same(a.a, b)):
        return pow_(b, Constant(a.b.value + 1))
    if (isinstance(a, Pow) and isinstance(b, Pow)
            and isinstance(a.b, Constant) and isinstance(b.b, Constant)
            and _same(a.a, b.a)):
        return pow_(a.a, Constant(a.b.value + b.b.value))
    return Mul(a, b)


def div(a, b) -> Expr:
    """a / b with reductions (divide_node::reduce,
    arithmetic.hpp:2769-3730)."""
    a, b = as_expr(a), as_expr(b)
    va, vb = _c(a), _c(b)
    if va is not None and vb is not None and np.all(np.asarray(vb) != 0):
        return Constant(va / vb)
    if va is not None and a.is_(0):
        return Constant(0.0)
    if vb is not None and b.is_(1):
        return a
    folded = _fold_tables(np.divide, a, b)
    if folded is not None:
        return folded
    if _same(a, b):
        return Constant(1.0)
    return Div(a, b)


def fma_(a, b, c) -> Expr:
    """fma(a, b, c) = a*b + c with reductions (fma_node::reduce,
    arithmetic.hpp:3736+)."""
    a, b, c = as_expr(a), as_expr(b), as_expr(c)
    va, vb, vc = _c(a), _c(b), _c(c)
    if va is not None and vb is not None:
        return add(Constant(va * vb), c)
    if (va is not None and a.is_(0)) or (vb is not None and b.is_(0)):
        return c
    if va is not None and a.is_(1):
        return add(b, c)
    if vb is not None and b.is_(1):
        return add(a, c)
    if vc is not None and c.is_(0):
        return mul(a, b)
    return Fma(a, b, c)


def pow_(a, b) -> Expr:
    """a ** b with reductions (pow_node::reduce, math.hpp:844-1439):
    x^0 -> 1, x^1 -> x, constant folding, sqrt(x)^2 -> x, (x^a)^b."""
    a, b = as_expr(a), as_expr(b)
    vb = _c(b)
    if vb is not None:
        if b.is_(0):
            return Constant(1.0)
        if b.is_(1):
            return a
        va = _c(a)
        if va is not None:
            return Constant(va ** vb)
        if isinstance(a, Sqrt) and b.is_(2):
            return a.a
        if isinstance(a, Pow) and isinstance(a.b, Constant):
            return pow_(a.a, Constant(a.b.value * vb))
    return Pow(a, b)


def sqrt(a) -> Expr:
    """sqrt with reductions (sqrt_node::reduce, math.hpp:26-330):
    constant folding, sqrt(x^2) -> x (the reference's sqrt(x*x) rule -
    x*x gathers to x^2 in mul)."""
    a = as_expr(a)
    va = _c(a)
    if va is not None:
        return Constant(np.sqrt(va))
    if isinstance(a, Pow) and isinstance(a.b, Constant) and a.b.is_(2):
        return a.a
    return Sqrt(a)


def exp(a) -> Expr:
    """exp with reductions (exp_node::reduce, math.hpp:337-595):
    constant folding, exp(log(x)) -> x."""
    a = as_expr(a)
    va = _c(a)
    if va is not None:
        return Constant(np.exp(va))
    if isinstance(a, Log):
        return a.a
    return Exp(a)


def log(a) -> Expr:
    """log with reductions (log_node::reduce, math.hpp:602-840):
    constant folding, log(exp(x)) -> x."""
    a = as_expr(a)
    va = _c(a)
    if va is not None:
        return Constant(np.log(va))
    if isinstance(a, Exp):
        return a.a
    return Log(a)


def tan(a) -> Expr:
    """tan(x) = sin(x)/cos(x) - a composite, exactly as the reference
    builds it (trigonometry.hpp:539: `return sin(x)/cos(x)`)."""
    a = as_expr(a)
    return div(Sin(a), Cos(a))


def piecewise_1D(data, arg, scale, offset) -> Expr:
    """piecewise_1D with reductions (piecewise_1D_node::reduce,
    piecewise.hpp:~200-240): a CONSTANT argument collapses to the gathered
    constant, and an all-equal table is a constant regardless of the
    argument.  Index convention: clamp(trunc((x - offset)/scale)) - the
    convention the reference's generated kernels use (compile_index,
    piecewise.hpp:26-60; its host-side reduce uses `(x + offset)/scale`,
    :880-899 - a sign inconsistency with its own kernels, reachable only
    through constant args, which we do not replicate)."""
    data = np.asarray(data)
    arg = as_expr(arg)
    va = _c(arg)
    if va is not None:
        i = int(np.clip(np.real(va - offset) / scale, 0,
                        data.shape[0] - 1))
        return Constant(data[i])
    if data.size and np.all(data == data.flat[0]):
        return Constant(data.flat[0])
    return Piecewise1D(data, arg, scale, offset)


def piecewise_2D(data, num_cols, x, x_scale, x_offset,
                 y, y_scale, y_offset) -> Expr:
    """piecewise_2D with reductions (piecewise_2D_node::reduce,
    piecewise.hpp:856-940): both args constant -> the gathered constant;
    one arg constant -> a piecewise_1D over the extracted row/column;
    all-equal table -> constant.  Same kernel-consistent index convention
    as :func:`piecewise_1D`."""
    data = np.asarray(data).reshape(-1, int(num_cols))
    x, y = as_expr(x), as_expr(y)
    vx, vy = _c(x), _c(y)
    nr, nc = data.shape
    if vx is not None and vy is not None:
        i = int(np.clip(np.real(vx - x_offset) / x_scale, 0, nr - 1))
        j = int(np.clip(np.real(vy - y_offset) / y_scale, 0, nc - 1))
        return Constant(data[i, j])
    if vx is not None:          # row extraction (piecewise.hpp:901-916)
        i = int(np.clip(np.real(vx - x_offset) / x_scale, 0, nr - 1))
        return piecewise_1D(data[i, :], y, y_scale, y_offset)
    if vy is not None:          # column extraction (piecewise.hpp:917-933)
        j = int(np.clip(np.real(vy - y_offset) / y_scale, 0, nc - 1))
        return piecewise_1D(data[:, j], x, x_scale, x_offset)
    if data.size and np.all(data == data.flat[0]):
        return Constant(data.flat[0])
    return Piecewise2D(data, nc, x, x_scale, x_offset,
                       y, y_scale, y_offset)


#: node-type -> reducing factory, for Expr.reduce()
_REDUCE_FACTORIES = {
    Add: add, Sub: sub, Mul: mul, Div: div, Fma: fma_, Pow: pow_,
    Sqrt: sqrt, Exp: exp, Log: log,
}

fma = fma_
sin, cos, atan = Sin, Cos, Atan
erfi = Erfi
random = Random
index_1D = Index1D
index_2D = Index2D


# ---------------------------------------------------------------------------
# workflow manager (workflow.hpp:215-425)
# ---------------------------------------------------------------------------

class _Item:
    def __init__(self, inputs, outputs, setters, name, kind="item",
                 tol=1e-30, max_iter=1000, loops=1, device=None):
        self.inputs = list(inputs)
        self.outputs = list(outputs)
        self.setters = list(setters)   # [(expr, target_variable)]
        self.name = name
        self.kind = kind
        self.tol = tol
        self.max_iter = max_iter
        self.loops = loops
        self.device = device           # for an item without variables
        self._fn = None

    def compile(self):
        """Work out the item's schedule once: every node of its setters'
        and outputs' expressions in topological order, on the device of
        its variables."""
        exprs = [e for e, _ in self.setters] + self.outputs
        nodes = schedule(exprs)
        variables = [e for e in nodes if isinstance(e, Variable)]
        variables += list(self.inputs) + [t for _, t in self.setters]
        self.device = (variables[0].data.device if variables
                       else torch.device("cuda" if self.device is None
                                         else self.device))
        # random nodes get a fresh draw per invocation (random.hpp device
        # MT) from the item's generator, in the order of their ids
        rand_nodes = sorted((e for e in nodes if isinstance(e, Random)),
                            key=lambda r: r.id)
        self.schedule = nodes
        generator = torch.Generator(device=self.device).manual_seed(
            1234 + len(self.setters))

        def run_once():
            env = Env(self.device, draws={
                r: r.draw(generator, self.device) for r in rand_nodes})
            vals = _run_schedule(nodes, env)
            results = [vals[e.id] for e in exprs]
            # all setters read pre-update state; write as a batch
            # (work_item setter-map semantics, workflow.hpp:21-80)
            for (_, tgt), val in zip(self.setters, results):
                tgt.data = _broadcast(env.tensor(val), tgt.size)
            return results[len(self.setters):]

        self._fn = run_once

    def run(self):
        """Run the schedule (``loops`` times, or until a converge item
        converges); ``iterations`` counts the runs."""
        if self.kind == "item":
            for _ in range(self.loops):
                out = self._fn()
            self.iterations = self.loops
            return out
        # converge item (workflow.hpp:179-205): one scalar read an iteration
        it = 0
        last = off_last = float("inf")
        out = self._fn()
        res = _max_abs(out[-1])
        while (abs(res) > self.tol and abs(last - res) > self.tol
               and abs(off_last - res) > self.tol and it < self.max_iter):
            last = res
            if it % 2 == 0:
                off_last = res
            out = self._fn()
            res = _max_abs(out[-1])
            it += 1
        self.iterations = it + 1
        return out


def _broadcast(value: torch.Tensor, size: int) -> torch.Tensor:
    """A setter's result as the target's buffer: a size-1 (or 0-d) result
    broadcast to ``size`` elements, as np.broadcast_to does in the JAX
    package."""
    if value.shape == (size,):
        return value
    return value.expand(size).contiguous()


def _max_abs(value) -> float:
    if isinstance(value, torch.Tensor):
        return float(value.abs().max().item())
    return float(np.max(np.abs(value)))


class Workflow:
    """Ordered pre-items + items (workflow::manager).  ``device`` is where
    an item without variables runs (the card unless the caller names
    another); an item with variables runs on theirs."""

    def __init__(self, index: int = 0, device=None):
        self.index = index
        self.device = device
        self.pre_items: List[_Item] = []
        self.items: List[_Item] = []

    def _item(self, inputs, outputs, setters, name, **kw):
        return _Item(inputs, outputs, setters, name, device=self.device,
                     **kw)

    def add_preitem(self, inputs, outputs, setters, name="pre", **kw):
        self.pre_items.append(self._item(inputs, outputs, setters, name,
                                         **kw))

    def add_item(self, inputs, outputs, setters, name="item", **kw):
        self.items.append(self._item(inputs, outputs, setters, name, **kw))

    def add_loop_item(self, inputs, outputs, setters, name="loop",
                      loops=1, **kw):
        self.items.append(self._item(inputs, outputs, setters, name,
                                     loops=loops, **kw))

    def add_converge_item(self, inputs, outputs, setters, name="converge",
                          tol=1e-30, max_iter=1000):
        self.items.append(self._item(inputs, outputs, setters, name,
                                     kind="converge", tol=tol,
                                     max_iter=max_iter))

    def compile(self):
        for item in self.pre_items + self.items:
            item.compile()

    def pre_run(self):
        for item in self.pre_items:
            item.run()

    def run(self):
        out = None
        for item in self.items:
            out = item.run()
        return out

    def wait(self):
        """Wait until the card has finished what the items queued."""
        for item in self.pre_items + self.items:
            if getattr(item.device, "type", None) == "cuda":
                torch.cuda.synchronize(item.device)

    def copy_to_host(self, var: Variable) -> np.ndarray:
        return var.data.cpu().numpy()

    def copy_to_device(self, var: Variable, data):
        var.set(data)

    def check_value(self, index: int, expr: Expr):
        return expr.evaluate(device=self.device).cpu().numpy()[index]


def newton(work: Workflow, vars: Sequence[Variable], inputs, func: Expr,
           tolerance=1e-30, max_iterations=1000, step=1.0):
    """solver::newton (newton.hpp:34-51): register setters
    x <- x - step*f/f'(x) and a converge item on f*f."""
    setters = [(v - Constant(step) * func / func.df(v), v) for v in vars]
    work.add_converge_item(inputs, [func * func], setters,
                           name="loss_kernel", tol=tolerance,
                           max_iter=max_iterations)
