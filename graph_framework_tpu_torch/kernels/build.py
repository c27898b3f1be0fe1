"""Build the package's CUDA sources with ``nvcc`` at first use.

The kernels in ``graph_framework_tpu_torch/csrc/*.cu`` have a plain C
interface; each source is compiled to an object by its own ``nvcc``, all
of them at once, and the objects are linked into one shared library,
loaded with ``ctypes`` (no PyTorch headers: the build takes seconds, not
minutes).  Every pointer and the stream go through ctypes as
``c_void_p``.

The library lands in ``graph_framework_tpu_torch/_build/`` under a name
keyed by a hash of the sources and flags, so it is rebuilt only when
either changes.  Importing this module needs no ``nvcc``; :func:`load`
builds on the first call, from the package's own sources alone, and
raises if the build fails.

It also owns the protocol every wrapper launches its kernel with: the
C interfaces' dtype codes (:data:`DTYPE_CODES`), the checks that the tensors a kernel reads share one device and dtype and are
contiguous (:func:`check`), and the call on the current stream that raises
on a non-zero return code (:func:`call`).

Spans (``telemetry``): ``gft.load``, the first :func:`load`, build
included; ``gft.build``, a build that compiles; in it ``gft.build.nvcc``,
the wait for each source's ``nvcc``, one a source compiled.

Never add ``--use_fast_math``: it changes division and square root and
breaks the comparison with the plain PyTorch versions.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

import torch

from graph_framework_tpu_torch import telemetry

PACKAGE = pathlib.Path(__file__).resolve().parent.parent
CSRC = PACKAGE / "csrc"
BUILD_DIR = PACKAGE / "_build"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_VOID_P, _INT, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong

_PTRS = ctypes.POINTER(_VOID_P)

#: The ``dtype`` argument of every C interface.
DTYPE_CODES = {torch.float32: 0, torch.float64: 1}

#: argtypes/restype of every exported function (csrc/efit_window.cu,
#: csrc/efit_window_bwd.cu, csrc/boris.cu, csrc/deposit.cu,
#: csrc/vmec_geom.cu, csrc/vmec_modes.cu, csrc/vmec_rhs.cu,
#: csrc/table_scatter.cu).  The window kernels' disp is the dispersion's
#: code (kernels/efit_step.py KERNEL_DISPERSIONS).
SIGNATURES = {
    "gft_efit_window": (
        [_INT, _INT, _INT, _INT, _INT, _LL,           # dtype disp method
                                                      # comp K n
         _PTRS, _PTRS,                                # state in/out
         _VOID_P, _INT, _INT, _VOID_P, _INT,          # psi nr nz prof npsi
         ctypes.POINTER(ctypes.c_double), _VOID_P],   # params stream
        _INT),
    "gft_efit_window_bwd": (
        [_INT, _INT, _INT, _INT, _LL,                 # dtype disp method K n
         _PTRS, _PTRS, _PTRS,                         # state, ct in, ct out
         _VOID_P, _INT, _INT, _VOID_P, _INT,          # psi nr nz prof npsi
         ctypes.POINTER(ctypes.c_double),             # params
         _VOID_P, _VOID_P, _VOID_P, _VOID_P,          # dpsi dprof cells
         _VOID_P],                                    # stream
        _INT),
    "gft_slab_push": (
        [_INT, _LL, _INT,                             # dtype n steps
         _PTRS, _PTRS,                                # state in/out
         ctypes.POINTER(ctypes.c_double), _VOID_P],   # params stream
        _INT),
    "gft_deposit": (
        [_INT, _LL, _INT,                             # dtype n grid
         _VOID_P, _VOID_P, _VOID_P,                   # x mask grid
         _VOID_P, _VOID_P, _VOID_P,                   # scratch n e
         ctypes.POINTER(ctypes.c_double), _VOID_P],   # params stream
        _INT),
    "gft_deposit_scratch_bytes": ([_INT, _LL, _INT], _LL),  # dtype n grid
    "gft_vmec_geom": (
        [_INT, _LL,                                   # dtype n
         _VOID_P, _VOID_P, _VOID_P,                   # s u v
         _VOID_P, _VOID_P, _VOID_P, _INT,             # rz lm runs n_runs
         _INT, _INT, _INT,                            # ns_f ns_h g
         ctypes.POINTER(ctypes.c_double),             # params
         _VOID_P, _VOID_P],                           # out stream
        _INT),
    "gft_vmec_modes": (
        [_INT, _LL, _INT,                             # dtype n m
         _VOID_P, _VOID_P, _PTRS,                     # u v blocks
         _VOID_P, _VOID_P, _VOID_P, _VOID_P],         # xm xn out stream
        _INT),
    "gft_vmec_rhs": (
        [_INT, _LL, _PTRS,                            # dtype n leaves
         _VOID_P, _VOID_P, _INT,                      # jet chi nchi
         ctypes.POINTER(ctypes.c_double),             # params
         _VOID_P, _VOID_P],                           # out stream
        _INT),
    "gft_table_scatter": (
        [_INT, _LL, _INT, _LL,                        # dtype n width cells
         _VOID_P, _VOID_P, _INT, _INT,                # grad idx vec sms
         _VOID_P, _VOID_P],                           # out stream
        _INT),
    "gft_error_string": ([_INT], ctypes.c_char_p),
}

_library = None
#: What the build of the loaded library printed (ptxas registers, spills).
build_log = ""


def find_nvcc() -> str:
    """nvcc from $CUDA_HOME / $CUDA_PATH, then $PATH, then the toolkit's
    default install prefix."""
    for var in ("CUDA_HOME", "CUDA_PATH"):
        root = os.environ.get(var)
        if root and (pathlib.Path(root) / "bin" / "nvcc").is_file():
            return str(pathlib.Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if default.is_file():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> pathlib.Path:
    """The content-keyed library file for the current sources and flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libgft_kernels_{h.hexdigest()[:16]}.so"


def build() -> pathlib.Path:
    """Compile csrc/*.cu into the keyed library unless it exists already:
    one ``nvcc -c`` per source, all started together, then one link.
    Writes to a temporary name and renames, so concurrent builders never
    load a half-written file."""
    global build_log
    out = library_path()
    if out.is_file():
        log = out.with_suffix(".log")
        build_log = log.read_text() if log.is_file() else ""
        return out
    with telemetry.span("gft.build"):
        _compile(out)
    return out


def _compile(out):
    """Every source's ``nvcc -c`` at once, then the link into ``out``."""
    global build_log
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        jobs = []
        for src in (s for s in _sources() if s.suffix == ".cu"):
            obj = pathlib.Path(tmpdir) / f"{src.stem}.o"
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            jobs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs, failed = [], []
        for cmd, _, proc in jobs:
            with telemetry.span("gft.build.nvcc"):
                logs.append(proc.communicate()[0])
            if proc.returncode != 0:
                failed.append(f"{' '.join(cmd)} ({proc.returncode})")
        build_log = "".join(logs)
        if failed:
            raise RuntimeError(f"nvcc failed: {'; '.join(failed)}\n"
                               f"{build_log}")
        tmp = pathlib.Path(tmpdir) / "lib.so"
        cmd = [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp),
               *[str(obj) for _, obj, _ in jobs]]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stdout}"
                               f"{proc.stderr}")
        os.replace(tmp, out)
    out.with_suffix(".log").write_text(build_log)


def load() -> ctypes.CDLL:
    """The kernel library, built on first use, with every exported
    function's argtypes and restype declared."""
    global _library
    if _library is None:
        with telemetry.span("gft.load"):
            lib = ctypes.CDLL(str(build()))
            for name, (argtypes, restype) in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes, fn.restype = argtypes, restype
        _library = lib
    return _library


def error_string(code: int) -> str:
    return load().gft_error_string(code).decode()


def pointers(tensors):
    """A ctypes array of the tensors' data pointers (a ``void**``)."""
    return (_VOID_P * len(tensors))(*[a.data_ptr() for a in tensors])


def stream(x):
    """PyTorch's current CUDA stream on ``x``'s device, as an int."""
    return torch.cuda.current_stream(x.device).cuda_stream


def check(kernel, tensors, what, *, length=False) -> int:
    """Refuse what ``kernel`` cannot read: the first of ``tensors`` on a
    device other than cuda (or cpu, which runs the plain version) or of a
    dtype other than float32/float64 (TypeError), or any of them not
    contiguous, on another device or of another dtype than the first
    (``what`` names them in the error); with ``length``, also any that is
    not 1-D of the first's length.  Returns the dtype's code
    (:data:`DTYPE_CODES`)."""
    x = tensors[0]
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{kernel} runs on cuda (or cpu via the plain "
                         f"version), not {x.device}")
    code = DTYPE_CODES.get(x.dtype)
    if code is None:
        raise TypeError(f"{kernel} takes float32/float64, not {x.dtype}")
    for a in tensors:
        if (a.device != x.device or a.dtype != x.dtype
                or not a.is_contiguous()
                or (length and (a.ndim != 1 or a.shape != x.shape))):
            if length:
                raise ValueError(f"{kernel} needs contiguous 1-D {what} of "
                                 f"one length, dtype and device")
            raise ValueError(f"{kernel} needs contiguous {what} of one "
                             f"dtype and device")
    return code


def call(fn, label, like, *args):
    """Launch through the library's function ``fn`` with ``args`` and the
    current stream on ``like``'s device, that device current; a non-zero
    return code raises, naming ``label`` and the library's error."""
    with torch.cuda.device(like.device):
        rc = fn(*args, stream(like))
    if rc != 0:
        raise RuntimeError(f"{label} kernel launch failed ({rc}): "
                           f"{error_string(rc)}")
