"""Build ``libgraph_tpu_torch.so`` and the programs that link it.

    python -m graph_framework_tpu_torch.capi.build [--probe]

The library embeds CPython, so it is compiled and linked with the flags of
the interpreter's own ``python3-config``::

    gcc $(python3-config --includes) -shared -fPIC -o libgraph_tpu_torch.so \\
        graph_c_binding.c $(python3-config --ldflags --embed)

It lands in ``graph_framework_tpu_torch/_build/capi_<key>/``, keyed by a
hash of the sources and flags, so it is rebuilt only when either changes;
a build writes to a temporary directory and renames it, so concurrent
builds never load a half-written file.  The embedders' programs
(``capi/c_binding_test.c``, ``capi/f_binding_test.f90`` with
``capi/graph_fortran_binding.f90``) compile unchanged against the port's
header and link the library with an rpath to it (:func:`build_program`);
:func:`program_env` is the environment they run in (the repository and the
interpreter's ``sys.path`` for the embedded interpreter, and
``GRAPH_TORCH_DEVICE``).  Importing this module needs no compiler.
"""

from __future__ import annotations

import hashlib
import os
import pathlib
import shutil
import subprocess
import sys
import sysconfig
import tempfile

CAPI = pathlib.Path(__file__).resolve().parent
PACKAGE = CAPI.parent
REPO = PACKAGE.parent
BUILD_DIR = PACKAGE / "_build"
#: The embedders' side of the contract, shared with the JAX package's
#: library.
PROGRAMS = REPO / "capi"

LIBRARY = "libgraph_tpu_torch.so"
CFLAGS = ["-O2", "-fPIC", "-Wall", "-Wextra"]
SOURCES = ("graph_c_binding.c", "graph_c_binding.h")


def python_config() -> str:
    """The ``python3-config`` of the running interpreter's installation
    (beside its base executable), else the one on ``PATH``."""
    version = sysconfig.get_config_var("VERSION") or ""
    base = pathlib.Path(sys.base_prefix) / "bin"
    for name in (f"python{version}-config", "python3-config"):
        if (base / name).is_file():
            return str(base / name)
    found = shutil.which(f"python{version}-config") or shutil.which(
        "python3-config")
    if found is None:
        raise RuntimeError("python3-config not found: the C library embeds "
                           "CPython and needs its build flags")
    return found


def python_flags():
    """(compile flags, link flags) of ``python3-config --includes`` and
    ``--ldflags --embed``, with an rpath for each library directory."""
    cfg = python_config()
    includes = subprocess.run([cfg, "--includes"], capture_output=True,
                              text=True, check=True).stdout.split()
    ldflags = subprocess.run([cfg, "--ldflags", "--embed"],
                             capture_output=True, text=True,
                             check=True).stdout.split()
    rpaths = [f"-Wl,-rpath,{f[2:]}" for f in ldflags if f.startswith("-L")]
    return includes, ldflags + rpaths


def probe() -> dict:
    """What a build of the library needs from the machine: the compiler,
    ``python3-config`` and its flags, and ``Python.h``."""
    out = {"gcc": shutil.which("gcc"), "gfortran": shutil.which("gfortran")}
    try:
        out["python3-config"] = python_config()
        includes, ldflags = python_flags()
    except (RuntimeError, subprocess.CalledProcessError) as exc:
        out["error"] = str(exc)
        return out
    out["includes"] = " ".join(includes)
    out["ldflags --embed"] = " ".join(ldflags)
    out["Python.h"] = [str(pathlib.Path(f[2:]) / "Python.h")
                       for f in dict.fromkeys(includes) if f.startswith("-I")
                       and (pathlib.Path(f[2:]) / "Python.h").is_file()]
    return out


def _key(*flags) -> str:
    h = hashlib.sha256(" ".join(map(str, flags)).encode())
    for name in SOURCES:
        h.update((CAPI / name).read_bytes())
    return h.hexdigest()[:16]


def _run(cmd):
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{' '.join(map(str, cmd))} failed "
                           f"({proc.returncode}):\n{proc.stdout}{proc.stderr}")
    return proc


def build() -> pathlib.Path:
    """Compile ``graph_c_binding.c`` into the keyed library unless it exists
    already; returns its path."""
    includes, ldflags = python_flags()
    out_dir = BUILD_DIR / f"capi_{_key(CFLAGS, includes, ldflags)}"
    lib = out_dir / LIBRARY
    if lib.is_file():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = pathlib.Path(tempfile.mkdtemp(dir=BUILD_DIR, prefix="capi_tmp_"))
    try:
        _run(["gcc", *CFLAGS, *includes, "-shared", "-o", str(tmp / LIBRARY),
              str(CAPI / "graph_c_binding.c"), *ldflags])
        try:
            tmp.rename(out_dir)
        except OSError:
            if not lib.is_file():      # not a concurrent build's result
                raise
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return lib


def build_program(source: str, compiler: str = "gcc") -> pathlib.Path:
    """Build one of the embedders' programs in ``capi/`` (``c_binding_test.c``
    with gcc, ``f_binding_test.f90`` with gfortran over
    ``graph_fortran_binding.f90``) against the port's header and library;
    returns the executable's path."""
    lib = build()
    includes, ldflags = python_flags()
    src = PROGRAMS / source
    exe = lib.parent / pathlib.Path(source).stem
    with tempfile.TemporaryDirectory(dir=lib.parent) as tmp:
        link = ["-L", str(lib.parent), "-lgraph_tpu_torch",
                f"-Wl,-rpath,{lib.parent}", *ldflags]
        if source.endswith(".f90"):
            obj = pathlib.Path(tmp) / "graph_fortran_binding.o"
            _run([compiler, "-O2", "-Wall", "-J", tmp, "-c", "-o", str(obj),
                  str(PROGRAMS / "graph_fortran_binding.f90")])
            _run([compiler, "-O2", "-Wall", "-I", tmp, "-o",
                  str(pathlib.Path(tmp) / "a.out"), str(src), str(obj),
                  *link])
        else:
            _run([compiler, *CFLAGS, "-I", str(CAPI), *includes, "-o",
                  str(pathlib.Path(tmp) / "a.out"), str(src), *link])
        os.replace(pathlib.Path(tmp) / "a.out", exe)
    return exe


def program_env(device=None, base=None) -> dict:
    """The environment a program that embeds the library runs in: the
    repository on ``GRAPH_TPU_ROOT`` and, with the running interpreter's
    ``sys.path``, on ``PYTHONPATH`` (so the embedded interpreter finds torch
    and numpy where this one does); ``GRAPH_TORCH_DEVICE`` set to ``device``,
    or removed (the card) when it is None."""
    env = dict(os.environ if base is None else base)
    env["GRAPH_TPU_ROOT"] = str(REPO)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + [p for p in sys.path if p and pathlib.Path(p).is_dir()])
    env.pop("GRAPH_TORCH_DEVICE", None)
    if device is not None:
        env["GRAPH_TORCH_DEVICE"] = str(device)
    return env


def main(argv=None):
    import json
    args = sys.argv[1:] if argv is None else argv
    if "--probe" in args:
        print(json.dumps(probe()))
        return 0
    print(build())
    return 0


if __name__ == "__main__":
    sys.exit(main())
