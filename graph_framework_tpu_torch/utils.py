"""Timing, profiling, kernel dumps and the debug mode.

Counterpart of ``graph_framework_tpu.utils`` (the reference's observability
layer: ``timing::measure_diagnostic`` wall-clock blocks, timing.hpp:18-154;
SAVE_KERNEL_SOURCE kernel dumps, jit.hpp:215-230; the --verbose device
info), rebuilt on ``torch.profiler``, ``torch.cuda`` and the kernels' own
build (``kernels/build.py``).

Debug mode.  The reference's sanitizer builds with sync-after-async CUDA
checking (CMakeLists.txt:104-130, cuda_context.hpp:100-107) turn silent
device-side corruption into located host-side errors; the JAX package
wraps its hot steps in checkify's float checks.  Here, under
:func:`set_debug`, (1) :func:`checked_step` runs a step under a
``TorchFunctionMode`` that looks at the output of every eager torch
operation and remembers the first one that makes a NaN or an inf from
finite inputs, and at the step's end raises :class:`NonFiniteError`
naming that operation and its call site, each non-finite leaf of the
step's output and its first bad ray; (2) every kernel wrapper checks its
outputs after its launch (:func:`check_kernel_outputs`) and raises naming
the kernel, the output and the first bad ray.  The Solver's recorded step
is a checked step.  With debug off (the default) nothing is wrapped and
nothing is checked: behaviour and launch counts are unchanged.  The
production scrub stays where it is (``absorption.run_absorption``'s
SAFE_MATH).  The JAX package's guard of its VMEC geometry kernel K4
(``pallas/vmec_geom.py``) checks the 128-cell table cut of its TPU layout,
which the port does not have, so it has no counterpart; K4's outputs get
the finiteness check of every kernel.
"""

from __future__ import annotations

import contextlib
import os
import pathlib
import shutil
import subprocess
import threading
import time
import traceback
from typing import Dict, List, Optional

import torch
from torch.overrides import TorchFunctionMode
from torch.utils._pytree import tree_flatten


class MeasureDiagnostic:
    """Wall-clock phase timer (timing.hpp:18-64).

    >>> t = MeasureDiagnostic("Setup Time")
    ... work ...
    >>> t.print()
    """

    def __init__(self, name: str):
        self.name = name
        self.start = time.perf_counter()

    def elapsed(self) -> float:
        return time.perf_counter() - self.start

    def print(self):
        print(f"{self.name} : {self.elapsed():.6f}s")


class MeasureDiagnosticThreaded:
    """Per-thread phase timer with print/print_max (timing.hpp:67-154)."""

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._start: Dict[int, float] = {}
        self._elapsed: Dict[int, float] = {}

    def start_time(self, thread_number: int):
        with self._lock:
            self._start[thread_number] = time.perf_counter()

    def end_time(self, thread_number: int):
        with self._lock:
            self._elapsed[thread_number] = (
                time.perf_counter() - self._start[thread_number])

    def print(self):
        with self._lock:
            for k in sorted(self._elapsed):
                print(f"{self.name}[{k}] : {self._elapsed[k]:.6f}s")

    def print_max(self):
        with self._lock:
            if self._elapsed:
                print(f"{self.name} (max) : "
                      f"{max(self._elapsed.values()):.6f}s")


def save_kernel_source(unit: str, out_dir) -> List[pathlib.Path]:
    """Write a kernel unit's CUDA source and its PTX into ``out_dir``
    (SAVE_KERNEL_SOURCE's counterpart, jit.hpp:215-230; the JAX package
    writes HLO).  ``unit``: a source of ``csrc/`` by its stem (for example
    ``"efit_window"``); the PTX is ``nvcc -ptx`` of it with the flags the
    library is built with (``kernels/build.NVCC_FLAGS``), the SASS of which
    sits in the built library.  Returns the two paths.  Needs ``nvcc``."""
    from graph_framework_tpu_torch.kernels import build

    src = build.CSRC / f"{unit}.cu"
    if not src.is_file():
        raise FileNotFoundError(f"no kernel unit {src}")
    out = pathlib.Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    cu, ptx = out / src.name, out / f"{unit}.ptx"
    shutil.copyfile(src, cu)
    cmd = [build.find_nvcc(), *build.NVCC_FLAGS, "-ptx", "-o", str(ptx),
           str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc -ptx failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    return [cu, ptx]


@contextlib.contextmanager
def profile_trace(log_dir):
    """A ``torch.profiler`` trace of the block (host and, where there is a
    card, device activity), written to ``log_dir/trace.json`` (Chrome
    trace format: Perfetto or chrome://tracing); yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def device_info() -> List[str]:
    """--verbose device summary (cuda_context.hpp:225-241 analogue): one
    line a CUDA device, from ``torch.cuda.get_device_properties``; empty
    where torch has no CUDA device."""
    if not torch.cuda.is_available():
        return []
    lines = []
    for i in range(torch.cuda.device_count()):
        p = torch.cuda.get_device_properties(i)
        lines.append(f"{p.name} id={i} sm_{p.major}{p.minor} "
                     f"multiprocessors={p.multi_processor_count} "
                     f"memory={p.total_memory / 2 ** 30:.1f} GiB")
    return lines


# -- debug mode ----------------------------------------------------------------

_DEBUG_MODE = False


def set_debug(enabled: bool) -> None:
    """Enable/disable debug mode (the CLI's --debug): the steps built and
    the kernels launched after the call check for NaN and inf."""
    global _DEBUG_MODE
    _DEBUG_MODE = bool(enabled)


def debug_enabled() -> bool:
    return _DEBUG_MODE


class NonFiniteError(FloatingPointError):
    """A NaN or an inf where debug mode looks: the message names the
    operation or kernel that made it, the leaf and the first bad ray."""


def _is_float(a) -> bool:
    return isinstance(a, torch.Tensor) and (a.is_floating_point()
                                            or a.is_complex())


def _non_finite(a: torch.Tensor, unit: str = "index") -> Optional[str]:
    """What ``a`` first holds that is not finite and where - its index
    along the last axis (the ray axis of the port's tensors), as ``unit``
    - or None."""
    if a.numel() == 0:
        return None
    flat = a.detach().reshape(-1, a.shape[-1] if a.ndim else 1)
    bad = ~torch.isfinite(flat)
    if not bool(bad.any()):
        return None
    row, col = torch.nonzero(bad)[0].tolist()
    what = "nan" if bool(torch.isnan(flat[row, col])) else "inf"
    return f"{what} first at {unit} {col}"


def _call_site() -> str:
    """The innermost frame of the package below this module."""
    here = pathlib.Path(__file__).resolve()
    package = here.parent
    for frame in reversed(traceback.extract_stack()[:-2]):
        path = pathlib.Path(frame.filename).resolve()
        if package in path.parents and path != here:
            return (f"{path.relative_to(package.parent)}:{frame.lineno} "
                    f"in {frame.name}")
    return "outside the package"


_UNCHECKED = ("empty", "empty_like", "new_empty", "empty_strided")


class _FiniteChecks(TorchFunctionMode):
    """Remembers the first torch operation whose floating output holds a
    NaN or an inf while all its floating inputs are finite (what made it;
    the operations that merely pass it on are not blamed)."""

    def __init__(self):
        super().__init__()
        self.first = None

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = getattr(func, "__name__", str(func))
        if self.first is not None or name in _UNCHECKED:
            return out
        outs = [a for a in tree_flatten(out)[0] if _is_float(a)]
        where = next((w for w in map(_non_finite, outs) if w), None)
        if where is None:
            return out
        inputs = [a for a in tree_flatten((args, kwargs))[0] if _is_float(a)]
        if not any(_non_finite(a) for a in inputs):
            self.first = f"{name} at {_call_site()}: {where}"
        return out


def _named_leaves(out, prefix=""):
    """(name, tensor) of each floating tensor in ``out`` (named tuples by
    their fields: a RayState's x, a CompCarry's hi.x)."""
    if _is_float(out):
        return [(prefix or "output", out)]
    if hasattr(out, "_fields"):
        return [pair for f in out._fields for pair in _named_leaves(
            getattr(out, f), f"{prefix}.{f}" if prefix else f)]
    if isinstance(out, (tuple, list)):
        return [pair for i, a in enumerate(out) for pair in _named_leaves(
            a, f"{prefix}[{i}]")]
    return []


def _bad_leaves(out) -> List[str]:
    bad = []
    for name, leaf in _named_leaves(out):
        where = _non_finite(leaf, "ray")
        if where:
            bad.append(f"{name} ({where})")
    return bad


def checked_step(fn, name: Optional[str] = None):
    """``fn`` itself outside debug mode (no wrapper, nothing checked); in
    debug mode ``fn`` under float checks: a call whose eager operations
    make a NaN or an inf from finite inputs, or whose output has a leaf
    that is not finite, raises :class:`NonFiniteError` naming the first
    such operation (and where it was called), the bad leaves and each
    one's first bad ray.  The counterpart of the JAX package's
    ``checked_jit``."""
    if not _DEBUG_MODE:
        return fn
    label = name or getattr(fn, "__qualname__", repr(fn))

    def checked(*args, **kwargs):
        mode = _FiniteChecks()
        with mode:
            out = fn(*args, **kwargs)
        bad = _bad_leaves(out)
        if mode.first is not None or bad:
            raise NonFiniteError(
                f"debug mode: {label} made a non-finite value: "
                f"{mode.first or 'no eager operation made it from finite inputs'}; "
                f"non-finite leaves of its output: "
                f"{'; '.join(bad) if bad else 'none'}")
        return out

    return checked


def check_kernel_outputs(kernel: str, names, outputs, inputs=(),
                         unit: str = "ray") -> None:
    """In debug mode: raise :class:`NonFiniteError` if an output of a
    kernel launch is not finite, naming the kernel, the output and its
    first bad ``unit`` (the index along the last axis), and whether an
    input already held a non-finite value.  Nothing outside debug mode."""
    if not _DEBUG_MODE:
        return
    for name, out in zip(names, outputs):
        where = _non_finite(out, unit)
        if where is None:
            continue
        passed = [f"{i}" for i, a in enumerate(inputs)
                  if _is_float(a) and _non_finite(a)]
        origin = (f"its inputs {', '.join(passed)} were already non-finite"
                  if passed else "its inputs were finite")
        raise NonFiniteError(
            f"debug mode: kernel {kernel} wrote a non-finite {name}: "
            f"{where}; {origin}")
