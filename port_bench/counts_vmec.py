"""The yardstick's fixed numbers for the VMEC geometry jet K4: its operation
count and the bytes a launch moves at the least.

The counts are what K4's function needs, as ``graph_framework_tpu_torch/
tools/count_ops.py`` counts them from ``csrc/vmec_geom.cu`` over a
counting scalar type (its ``"K4"`` entry): per ray a fixed part and a part
per mode, and the operations on the tables alone, which a launch needs
once and not once a ray.  They are copied here so that a change to the
program cannot move the yardstick; ``tests/test_port_bench_vmec_readers.py``
holds the copy to what ``count_ops`` gives.  The card's peaks are
``counts.py``'s.
"""

from port_bench.counts import PEAK_BYTES, PEAK_F32_OPS

JET_OPS = {"per_ray_fixed": 420, "per_mode": 90, "table_fixed": 27,
           "table_per_mode": 7}

# the bytes a launch moves at the least, per ray: s, u and v in, the 27
# jet sums out, f32
JET_BYTES_PER_RAY = (3 + 27) * 4


def jet_ops(rays, modes):
    """The operations one launch of K4 over ``rays`` rays and ``modes``
    modes needs."""
    per_ray = JET_OPS["per_ray_fixed"] + JET_OPS["per_mode"] * modes
    tables = JET_OPS["table_fixed"] + JET_OPS["table_per_mode"] * modes
    return per_ray * rays + tables


def jet_bound_s(rays, modes, table_bytes):
    """(seconds, what bounds it) of the least time one launch of K4 can
    take on the card: its operations over the f32 peak or its bytes (each
    ray's coordinates in and sums out, the tables once) over the HBM rate,
    the larger."""
    ops_s = jet_ops(rays, modes) / PEAK_F32_OPS
    bytes_s = (JET_BYTES_PER_RAY * rays + table_bytes) / PEAK_BYTES
    return (ops_s, "operations") if ops_s >= bytes_s else (bytes_s, "bytes")
