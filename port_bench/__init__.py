"""The benchmark of the PyTorch and CUDA port (``graph_framework_tpu_torch``).

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

``BENCHMARK.json`` at the root of the repository names the cells; this
package runs one of them on one card and prints one JSON line.  It is the
yardstick, kept apart from the program: input generation (``inputs``), the
frozen operation counts and peaks (``counts``), the reduction of a profiler
trace to per-layer numbers (``profiling``), the plain references
(``reference/``) and the comparison that decides ``correct`` (each job's
``check``).  A configuration is a file in ``configs/``, a traffic mix a file
in ``traffic/`` naming the job it runs (``jobs/<job>.py``), and a per-layer
metric a reader in ``layer_metrics/<metric>.py``: the harness finds each by
the name ``BENCHMARK.json`` gives it.
"""
