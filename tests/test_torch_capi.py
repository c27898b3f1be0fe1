"""The C API over the port: ``graph_framework_tpu_torch.capi_bridge`` held
to the JAX package's bridge, the port's header to ``capi/graph_c_binding.h``,
and the unchanged embedders' programs (``capi/c_binding_test.c``,
``capi/f_binding_test.f90``) built against ``libgraph_tpu_torch.so`` and run
on the CPU (``GRAPH_TORCH_DEVICE=cpu``).

The bridge-level parity runs one sequence of bridge calls - the pattern of
``c_binding_test.c``: variables from C buffers, arithmetic, ``df``, a
setter item, a Newton converge item, a table from a C buffer, random
numbers, ``print_nodes`` - through both bridges and compares the bytes
``copy_to_host`` returns.  DOUBLE and COMPLEX_DOUBLE agree to 1e-12
relative.  FLOAT computes in float32 on the port but in float64 in the JAX
bridge (which stores every variable as float64 and enables x64): there the
limit is 2e-6, about 16 float32 roundings of a value (2^-23 = 1.2e-7 each;
the deepest graph here rounds a handful of times, Newton's last step a
few more).
"""

import os
import shutil
import subprocess
from unittest import mock

import numpy as np
import pytest
import torch

import test_fortran_binding
from graph_framework_tpu import capi_bridge as jax_bridge
from graph_framework_tpu_torch import capi_bridge as bridge
from graph_framework_tpu_torch.capi import build

RTOL = {0: 2.0e-6, 1: 1.0e-12, 2: 2.0e-6, 3: 1.0e-12}
NAMES = {0: "FLOAT", 1: "DOUBLE", 2: "COMPLEX_FLOAT", 3: "COMPLEX_DOUBLE"}


@pytest.fixture
def cpu_contexts(monkeypatch):
    monkeypatch.setenv(bridge.DEVICE_VARIABLE, "cpu")


def _buffer(ctx, values):
    return memoryview(np.asarray(values, dtype=ctx.dtype).tobytes())


def _read(ctx, b, node):
    return np.frombuffer(b.copy_to_host(ctx, node), dtype=ctx.dtype)


def bridge_sequence(b, type_code, capsys):
    """c_binding_test.c's calls and a few more through bridge ``b``; the
    values every copy_to_host returned, and what print_nodes printed."""
    ctx = b.make_context(type_code, False)
    out = {}
    x = b.variable(ctx, 4, "x")
    b.set_variable(ctx, x, _buffer(ctx, [1.0, 2.0, 3.0, 4.0]))
    three = b.constant(ctx, 3.0)
    y = b.add(ctx, b.mul(ctx, x, x), b.mul(ctx, three, x))
    dy = b.df(ctx, y, x)
    tab = b.piecewise_1d(ctx, x, 1.0, 0.0,
                         _buffer(ctx, [0.5, 1.5, 2.5, 3.5, 4.5, 5.5]), 6)
    z = b.div(ctx, b.sub(ctx, b.exp(ctx, b.sin(ctx, x)), tab),
              b.sqrt(ctx, b.add(ctx, b.cos(ctx, x), b.constant(ctx, 2.0))))
    z = b.add(ctx, z, b.pow(ctx, b.log(ctx, x), b.constant(ctx, 2.0)))
    x_next = b.add(ctx, x, b.constant(ctx, 1.0))
    b.add_item(ctx, [x], [y, dy], [x_next], [x], "test_kernel", 4)
    b.compile(ctx)
    b.run(ctx)
    b.wait(ctx)
    for name, node in (("x", x), ("dy", dy), ("z", z), ("tab", tab)):
        out[name] = _read(ctx, b, node)
    # print_nodes on size-1 nodes: the JAX bridge's broadcasts every
    # node's value to one element first, so it refuses larger ones
    w = b.variable(ctx, 1, "w")
    b.set_variable(ctx, w, _buffer(ctx, [0.75]))
    capsys.readouterr()
    b.print_nodes(ctx, 0, [w, b.df(ctx, b.mul(ctx, w, b.exp(ctx, w)), w)])
    out["printed"] = capsys.readouterr().out

    # Newton through a converge item (c_binding_test.c's second test)
    ctx = b.make_context(type_code, False)
    x = b.variable(ctx, 2, "x")
    b.copy_to_device(ctx, x, _buffer(ctx, [3.0, 0.5]))
    f = b.sub(ctx, b.mul(ctx, x, x), b.constant(ctx, 2.0))
    x_next = b.sub(ctx, x, b.div(ctx, f, b.df(ctx, f, x)))
    b.add_converge_item(ctx, [x], [b.mul(ctx, f, f)], [x_next], [x],
                        "newton", 2, 1e-28, 100)
    b.compile(ctx)
    b.run(ctx)
    out["newton"] = _read(ctx, b, x)

    # pseudo variables and the gathers over a variable
    v = b.variable(ctx, 6, "v")
    b.set_variable(ctx, v, _buffer(ctx, np.arange(6.0) + 0.25))
    p = b.pseudo_variable(ctx, b.mul(ctx, x, x))
    q = b.mul(ctx, p, p)
    out["pseudo"] = _read(ctx, b, b.df(ctx, q, p))
    out["removed"] = _read(ctx, b, b.df(ctx, b.remove_pseudo(ctx, q), x))
    out["index_1d"] = _read(ctx, b, b.index_1d(ctx, v, x, 0.5, 0.0))
    out["index_2d"] = _read(ctx, b, b.index_2d(ctx, v, 3, x, 1.0, 0.0, x,
                                               1.0, 0.0))
    out["table_2d"] = _read(ctx, b, b.piecewise_2d(
        ctx, 2, x, 1.0, 0.0, x, 1.0, 0.0, _buffer(ctx, [1, 2, 3, 4, 5, 6]),
        6))
    out["atan"] = _read(ctx, b, b.atan(ctx, x, b.constant(ctx, 1.0)))
    if type_code >= 2:
        c = b.constant_c(ctx, 0.5, 0.25)
        out["erfi"] = _read(ctx, b, b.erfi(ctx, b.mul(ctx, c, x)))
        out["complex"] = _read(ctx, b, b.atan(ctx, b.add(ctx, x, c), c))
    # the random node: one uniform draw in [0, 1)
    r = _read(ctx, b, b.random(ctx, b.random_state(ctx, 5)))
    assert r.shape == (1,) and 0.0 <= float(np.real(r[0])) < 1.0
    assert b.get_max_concurrency(ctx) >= 1
    b.set_device_number(ctx, 0)
    return out


@pytest.mark.parametrize("type_code", [0, 1, 2, 3],
                         ids=lambda t: NAMES[t])
def test_bridge_matches_jax(type_code, cpu_contexts, capsys):
    """Every bridge function the C library calls, on both bridges."""
    want = bridge_sequence(jax_bridge, type_code, capsys)
    got = bridge_sequence(bridge, type_code, capsys)
    assert set(got) == set(want)
    for name in want:
        if name == "printed":
            continue
        assert got[name].dtype == want[name].dtype, name
        np.testing.assert_allclose(got[name], want[name],
                                   rtol=RTOL[type_code], atol=0.0,
                                   err_msg=name)
    if type_code in (1, 3):
        assert got["printed"] == want["printed"]
    np.testing.assert_allclose(np.real(got["newton"]), np.sqrt(2.0),
                               rtol=RTOL[type_code])


@pytest.mark.parametrize("type_code", [0, 1, 2, 3],
                         ids=lambda t: NAMES[t])
def test_context_computes_in_its_type(type_code, cpu_contexts):
    """A context's variables, and what it computes from them, are of its
    own type (FLOAT float32: the JAX bridge computes it in float64)."""
    ctx = bridge.make_context(type_code, False)
    x = bridge.variable(ctx, 3, "x")
    bridge.set_variable(ctx, x, _buffer(ctx, [1.0, 2.0, 3.0]))
    y = bridge.mul(ctx, bridge.exp(ctx, x), bridge.constant(ctx, 0.5))
    assert x.data.dtype == ctx.torch_dtype
    assert y.evaluate().dtype == ctx.torch_dtype
    assert x.data.device.type == "cpu"


def test_bridge_raises_without_a_card(monkeypatch):
    """No card and no GRAPH_TORCH_DEVICE: make_context raises, naming the
    variable that chooses the CPU; it never runs on the CPU instead."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    monkeypatch.delenv(bridge.DEVICE_VARIABLE, raising=False)
    with pytest.raises(RuntimeError, match="GRAPH_TORCH_DEVICE=cpu"):
        bridge.make_context(1, False)


def test_header_declares_the_same_prototypes():
    """The port's graph_c_binding.h declares every function of
    capi/graph_c_binding.h with the same argument and return classes (the
    parser of tests/test_fortran_binding.py), and nothing else."""
    want = test_fortran_binding._c_prototypes()
    with mock.patch.object(test_fortran_binding, "CAPI", build.CAPI):
        got = test_fortran_binding._c_prototypes()
    assert len(want) == 39
    assert got == want


def test_library_source_differs_only_in_its_bridge():
    """The port's graph_c_binding.c is the JAX package's but for the module
    it imports (and its opening comment)."""
    def body(path, module):
        text = path.read_text()
        text = text[text.index("#define PY_SSIZE_T_CLEAN"):]
        return text.replace(module, "BRIDGE")
    assert body(build.CAPI / "graph_c_binding.c",
                "graph_framework_tpu_torch.capi_bridge") == body(
        build.PROGRAMS / "graph_c_binding.c",
        "graph_framework_tpu.capi_bridge")


def _needs(*tools):
    for tool in tools:
        if shutil.which(tool) is None:
            pytest.skip(f"{tool} is not present")
    try:
        build.python_config()
    except RuntimeError as exc:
        pytest.skip(str(exc))


def test_c_binding_test_runs_on_the_cpu():
    """The unchanged capi/c_binding_test.c, linked against
    libgraph_tpu_torch.so, passes with GRAPH_TORCH_DEVICE=cpu."""
    _needs("gcc")
    exe = build.build_program("c_binding_test.c")
    assert (exe.parent / build.LIBRARY).is_file()
    out = subprocess.run([str(exe)], env=build.program_env("cpu"),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "All C binding tests passed." in out.stdout


def test_c_library_refuses_without_a_card():
    """Without GRAPH_TORCH_DEVICE the library's context is on the card:
    where there is none the program stops with the bridge's error."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _needs("gcc")
    exe = build.build_program("c_binding_test.c")
    out = subprocess.run([str(exe)], env=build.program_env(None),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "GRAPH_TORCH_DEVICE=cpu" in out.stderr
    assert "passed" not in out.stdout


def test_fortran_binding_test_runs_on_the_cpu():
    """The unchanged capi/f_binding_test.f90 (over
    capi/graph_fortran_binding.f90), linked against libgraph_tpu_torch.so,
    passes with GRAPH_TORCH_DEVICE=cpu."""
    _needs("gcc", "gfortran")
    exe = build.build_program("f_binding_test.f90", compiler="gfortran")
    out = subprocess.run([str(exe)], env=build.program_env("cpu"),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "All Fortran binding tests passed." in out.stdout


def test_print_nodes_prints_the_index(cpu_contexts, capsys):
    """print_nodes prints each node's value at the index (the last one
    where a node has fewer)."""
    ctx = bridge.make_context(1, False)
    x = bridge.variable(ctx, 4, "x")
    bridge.set_variable(ctx, x, _buffer(ctx, [1.0, 2.0, 3.0, 4.0]))
    bridge.print_nodes(ctx, 2, [x, bridge.mul(ctx, x, x),
                                bridge.constant(ctx, 7.0)])
    assert capsys.readouterr().out == "3.0 9.0 7.0\n"


def test_program_env_names_the_device():
    env = build.program_env("cpu", base={"GRAPH_TORCH_DEVICE": "cuda:1"})
    assert env["GRAPH_TORCH_DEVICE"] == "cpu"
    assert env["GRAPH_TPU_ROOT"] == str(build.REPO)
    assert env["PYTHONPATH"].split(os.pathsep)[0] == str(build.REPO)
    assert "GRAPH_TORCH_DEVICE" not in build.program_env(
        None, base={"GRAPH_TORCH_DEVICE": "cpu"})
