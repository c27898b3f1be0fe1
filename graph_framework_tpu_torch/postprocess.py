"""Post-processing of result files: NaN cleanup and 3D power deposition.

Counterpart of ``graph_framework_tpu.postprocess`` (the reference's
utilities/bin.py and fix_NaN.py).  Host-only numpy over the result files
(h5py): each trajectory segment's d_power lands in the bin holding its
midpoint, one histogram over every segment.
"""

from __future__ import annotations

import glob

import numpy as np

from graph_framework_tpu_torch.io.output import ResultFile


def fix_nan(path, spike_threshold=2.0):
    """Scrub NaNs and kamp spikes in a result file in place
    (utilities/fix_NaN.py): NaN -> 0, and a step-to-step kamp jump larger
    than ``spike_threshold`` zeroes the earlier sample."""
    import h5py

    with h5py.File(path, "r+") as h:
        if "kamp" not in h:
            return
        k = h["kamp"][...]
        k = np.where(np.isnan(k), 0.0, k)
        jump = np.abs(k[1:] - k[:-1])
        k[:-1] = np.where(jump > spike_threshold, 0.0, k[:-1])
        h["kamp"][...] = k


def bin_power_3d(paths, *, num=(64, 64, 128),
                 lo=(-3.0, -3.0, -3.0), hi=(3.0, 3.0, 3.0)):
    """Accumulate d_power into a 3D cartesian grid over all result files
    (utilities/bin.py); ``paths`` a list or a glob pattern.  Returns
    (bins, (x_edges, y_edges, z_edges))."""
    edges = [np.linspace(lo[d], hi[d], num[d] + 1) for d in range(3)]
    bins = np.zeros(num)
    if isinstance(paths, str):
        paths = sorted(glob.glob(paths))
    for path in paths:
        with ResultFile(path, mode="r") as f:
            rows = [f.read_step(i, ["x", "y", "z", "d_power"])
                    for i in range(f.num_steps)]
        xs, ys, zs, dp = (np.stack([r[n] for r in rows])
                          for n in ("x", "y", "z", "d_power"))
        # each segment's absorbed power at the segment's midpoint
        mid = [0.5 * (a[1:] + a[:-1]).ravel() for a in (xs, ys, zs)]
        h, _ = np.histogramdd(np.stack(mid, axis=-1), bins=edges,
                              weights=dp[1:].ravel())
        bins += h
    return bins, tuple(edges)


def save_bins(path, bins, edges):
    """Write the bins file (bins.nc layout of utilities/bin.py)."""
    import h5py

    with h5py.File(path, "w") as h:
        h.create_dataset("bins", data=bins)
        for name, edge in zip(("xbins", "ybins", "zbins"), edges):
            h.create_dataset(name, data=edge)
