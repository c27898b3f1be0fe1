"""The port's utils (the JAX package's utils.py counterpart): the timers,
the device summary, the profiler trace and the kernel-source dump; and the
kernel wrappers' launch protocol in ``kernels/build.py``.  The debug mode
is tests/test_torch_debug_mode.py's."""

import contextlib
import json
import os
import stat

import pytest
import torch

from graph_framework_tpu_torch import utils
from graph_framework_tpu_torch.kernels import build


def test_timers(capsys):
    t = utils.MeasureDiagnostic("Setup Time")
    assert t.elapsed() >= 0.0
    t.print()
    threaded = utils.MeasureDiagnosticThreaded("Trace")
    for k in (1, 0):
        threaded.start_time(k)
        threaded.end_time(k)
    threaded.print()
    threaded.print_max()
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("Setup Time : ")
    assert [line.split(" : ")[0] for line in out[1:]] == [
        "Trace[0]", "Trace[1]", "Trace (max)"]


def test_device_info():
    """One line a CUDA device, none where torch has no CUDA device."""
    lines = utils.device_info()
    assert len(lines) == (torch.cuda.device_count()
                          if torch.cuda.is_available() else 0)


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    with utils.profile_trace(tmp_path / "trace") as prof:
        torch.ones(8).cumsum(0)
    assert prof is not None
    events = json.loads((tmp_path / "trace" / "trace.json").read_text())
    assert any("cumsum" in e.get("name", "")
               for e in events["traceEvents"])


def test_build_call_raises_on_a_failed_launch(monkeypatch):
    """``build.call`` hands the library's function its arguments and the
    stream, and a non-zero return code raises with the label and the
    library's own error string."""
    monkeypatch.setattr(build.torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(build, "stream", lambda like: 77)
    monkeypatch.setattr(build, "error_string",
                        lambda rc: f"planted error {rc}")
    calls = []

    def fn(*args):
        calls.append(args)
        return args[0]

    like = torch.zeros(3)
    assert build.call(fn, "efit_window", like, 0, "a") is None
    with pytest.raises(RuntimeError, match=r"^efit_window kernel launch "
                       r"failed \(3\): planted error 3$"):
        build.call(fn, "efit_window", like, 3, "b")
    assert calls == [(0, "a", 77), (3, "b", 77)]


def test_build_check_refuses_what_no_kernel_takes():
    """The shared checks: the dtype code of float32/float64, and refusals
    of float16, a strided tensor, a second device or dtype, a length
    that differs, and a first tensor on neither cuda nor cpu."""
    x = torch.zeros(8)
    assert build.check("k", [x, x.clone()], "leaves", length=True) == 0
    assert build.check("k", [x.double(), x.double()[None]], "leaves") == 1
    with pytest.raises(TypeError, match="k takes float32/float64, not "
                       "torch.float16"):
        build.check("k", [x.half(), x.half()], "leaves")
    with pytest.raises(ValueError, match="contiguous 1-D leaves of one "
                       "length, dtype and device"):
        build.check("k", [x, torch.zeros(16)[::2]], "leaves", length=True)
    with pytest.raises(ValueError, match="contiguous 1-D"):
        build.check("k", [x, torch.zeros(7)], "leaves", length=True)
    for other in (torch.zeros(16)[::2], x.double(),
                  torch.zeros(8, device="meta")):
        with pytest.raises(ValueError, match="k needs contiguous leaves of "
                           "one dtype and device"):
            build.check("k", [x, other], "leaves")
    with pytest.raises(ValueError, match=r"k runs on cuda \(or cpu via the "
                       r"plain version\), not meta"):
        build.check("k", [torch.zeros(8, device="meta")], "leaves")
    assert build.DTYPE_CODES == {torch.float32: 0, torch.float64: 1}


def test_save_kernel_source(tmp_path, monkeypatch):
    """The unit's source is copied and nvcc is asked for its PTX with the
    library's flags (an nvcc stand-in records the call here, where there
    is no CUDA toolkit); an unknown unit raises."""
    fake = tmp_path / "nvcc"
    fake.write_text('#!/bin/sh\necho "$@" > "$(dirname "$0")/args"\n'
                    'while [ "$1" != "-o" ]; do shift; done\n'
                    'echo "// ptx" > "$2"\n')
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(build, "find_nvcc", lambda: str(fake))
    cu, ptx = utils.save_kernel_source("efit_window", tmp_path / "dump")
    assert cu.read_text() == (build.CSRC / "efit_window.cu").read_text()
    assert ptx.read_text() == "// ptx\n"
    args = (tmp_path / "args").read_text().split()
    assert "-ptx" in args and "arch=compute_90a,code=sm_90a" in args
    with pytest.raises(FileNotFoundError):
        utils.save_kernel_source("no_such_unit", tmp_path / "dump")
    assert sorted(os.listdir(tmp_path / "dump")) == ["efit_window.cu",
                                                     "efit_window.ptx"]
