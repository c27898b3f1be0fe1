"""The port's utils (the JAX package's utils.py counterpart): the timers,
the device summary, the profiler trace and the kernel-source dump.  The
debug mode is tests/test_torch_debug_mode.py's."""

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
