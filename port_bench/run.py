#!/usr/bin/env python3
"""Run one cell of the port's benchmark on this machine's card.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  Prints the cell's numbers as the last line
of standard output (one JSON object) and each compared number beside its
limit as the last lines of standard error.  Exits non-zero, printing no
result, without a CUDA card or with too few, or where the process loaded
JAX or the JAX package.  Every cache the program and PyTorch keep goes
under the checkout, at fixed paths.
"""

import time

START = time.perf_counter()

import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
CACHE = ROOT / ".bench_cache"
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "nv")):
    os.environ[var] = str(CACHE / sub)
# one process with few threads: the program's host work is one Python
# thread and its writers; idle worker pools only add noise to host clocks
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[var] = "2"
os.environ["USE_FLAX"] = "0"
sys.path.insert(0, str(ROOT))

from port_bench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(start=START))
