"""Spans at the port's layer boundaries, on the profiler's clock.

A span is a named stretch of host time: ``with telemetry.span("gft.efit_
window"): ...``.  Every name starts with ``gft.``, so it never meets an
ATen operation's name or a caller's own ``record_function``.  A span knows
its name, its parent (the span open around it on the same thread), its
thread, and its start and end in ``time.time_ns()`` nanoseconds, the time
base of ``torch.profiler``'s host events.

Spans are off by default; a span site then costs one check and allocates
nothing.  They turn on in two ways, which may hold together:

* while ``torch.profiler`` records on the span's thread, each span enters
  the profiler's host timeline as a record-function range (its fast path),
  beside the ATen operations and the device's kernels of the same trace
  (:func:`follow_profiler` turns this off and on again);
* :func:`enable` keeps spans in memory, as an aggregate per name: the
  count, the total seconds and the self seconds (the total less what the
  spans opened inside it on its thread cover).  :func:`summary` reads it;
  ``xrays --timing_json`` writes it as ``timings["spans"]``.

Counts are counts of spans: a span per Newton iteration counts the
iterations.  A :class:`Span` made directly (not through :func:`span`)
always measures its own seconds: the programs' phase timers (``xrays``'s
``init_s``, ``trace_s``...) are such spans.
"""

from __future__ import annotations

import threading
import time

import torch

_profiling = torch._C._autograd._profiler_enabled
_Range = torch._C._profiler._RecordFunctionFast

_keep = False          # enable(): the in-memory aggregate
_follow = True         # follow_profiler(): ranges in the profiler's trace
_lock = threading.Lock()
_totals = {}           # name -> [count, total ns, self ns]
_local = threading.local()


def _stack():
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class Span:
    """One span; a context manager (see :func:`span`).

    ``start_ns`` and ``end_ns`` are ``time.time_ns()`` readings; a kept
    span (:func:`enable`) also holds ``parent``, the kept span open around
    it on its thread (None at the top), and ``thread``, that thread's
    ident; :attr:`seconds` is its length."""

    __slots__ = ("name", "start_ns", "end_ns", "parent", "thread",
                 "_range", "_kept", "_child_ns")

    def __init__(self, name: str):
        self.name = name
        self.start_ns = self.end_ns = None
        self.parent = self.thread = self._range = None
        self._kept = False
        self._child_ns = 0

    def __enter__(self):
        if _follow and _profiling():
            self._range = _Range(self.name)
            self._range.__enter__()
        if _keep:
            stack = _stack()
            self.parent = stack[-1] if stack else None
            stack.append(self)
            self.thread = threading.get_ident()
            self._kept = True
        self.start_ns = time.time_ns()
        return self

    def stop(self):
        """End the span here (the ``with`` block's exit then does
        nothing): for a phase that ends before the block it opened with."""
        if self.end_ns is not None:
            return
        self.end_ns = time.time_ns()
        if self._range is not None:
            self._range.__exit__(None, None, None)
        if self._kept:
            stack = _stack()
            if stack and stack[-1] is self:
                stack.pop()
            else:
                stack.remove(self)
            total = self.end_ns - self.start_ns
            if self.parent is not None:
                self.parent._child_ns += total
            with _lock:
                agg = _totals.setdefault(self.name, [0, 0, 0])
                agg[0] += 1
                agg[1] += total
                agg[2] += total - self._child_ns

    def __exit__(self, *exc):
        self.stop()
        return False

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9


class _Off:
    """The span of a site while spans are off: nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def span(name: str):
    """The span ``name`` if spans are on for this thread (the profiler
    records here, or :func:`enable`), else a shared object that does
    nothing."""
    if _keep or (_follow and _profiling()):
        return Span(name)
    return _OFF


def enable(on: bool = True) -> bool:
    """Keep spans in memory (the aggregate :func:`summary` reads), or stop
    keeping them; returns the previous setting."""
    global _keep
    previous, _keep = _keep, bool(on)
    return previous


def enabled() -> bool:
    return _keep


def follow_profiler(on: bool = True) -> bool:
    """Whether spans enter ``torch.profiler``'s trace while it records
    (the default); returns the previous setting."""
    global _follow
    previous, _follow = _follow, bool(on)
    return previous


def snapshot() -> dict:
    """The aggregate as it stands: name -> [count, total ns, self ns]."""
    with _lock:
        return {name: list(agg) for name, agg in _totals.items()}


def summary(since: dict | None = None) -> dict:
    """The aggregate kept so far (less a :func:`snapshot` taken earlier):
    name -> {"count", "total_s", "self_s"}, names in order."""
    now, since = snapshot(), since or {}
    out = {}
    for name in sorted(now):
        count, total, own = (a - b for a, b in zip(
            now[name], since.get(name, (0, 0, 0))))
        if count:
            out[name] = {"count": count, "total_s": total * 1e-9,
                         "self_s": own * 1e-9}
    return out


def reset() -> None:
    """Forget the aggregate."""
    with _lock:
        _totals.clear()
