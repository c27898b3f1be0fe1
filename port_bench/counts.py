"""The yardstick's fixed numbers: operation counts of the kernels and the
card's peaks.

The counts are what each kernel's function needs per ray and window of 10
substeps, as ``graph_framework_tpu_torch/tools/count_ops.py`` counts them
from the CUDA sources over a counting scalar type (K1 rk2 compensated f32:
the main path's forward window; K3 rk4 f32: config 5's backward window,
each operation once).  They are copied here so that a change to the program
cannot move the yardstick; ``tests/test_bench_harness.py``'s
``test_frozen_counts_equal_the_programs`` holds the copy to what
``count_ops`` gives.

Peaks: one NVIDIA H100 SXM, NVIDIA's data sheet, at its 700 W power limit:
67 TFLOP/s in float32 outside the tensor cores, 3.35 TB/s of HBM.
"""

WINDOW_OPS = {
    "K1 rk2 comp": 8812,        # cold plasma, rk2, compensated f32
    "K3 rk4": 52742,            # cold plasma, rk4, plain f32, with tables
}

PEAK_F32_OPS = 67.0e12
PEAK_BYTES = 3.35e12

# the bytes a window moves at the least, per ray: the state leaves in and
# out (K1 compensated: 16 in, 16 out; K3: the state in, its cotangent in
# and out, 32 block cotangents and 2 cell rows), f32
WINDOW_BYTES = {"K1 rk2 comp": 32 * 4, "K3 rk4": 24 * 4 + 32 * 4 + 16}


def window_bound_s(kernel, rays, table_bytes):
    """(seconds, what bounds it) of the least time one window of
    ``kernel`` over ``rays`` rays can take on the card: operations over
    the f32 peak or bytes (the leaves a ray and the tables once) over the
    HBM rate, the larger."""
    ops_s = WINDOW_OPS[kernel] * rays / PEAK_F32_OPS
    bytes_s = (WINDOW_BYTES[kernel] * rays + table_bytes) / PEAK_BYTES
    return (ops_s, "operations") if ops_s >= bytes_s else (bytes_s, "bytes")
