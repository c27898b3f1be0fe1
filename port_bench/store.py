"""An in-memory result store, so that the pipeline writes nothing to disk.

A frozen copy of the port's smoke-run store (``chip_smoke.MemoryStore`` /
``MemoryFiles``): the methods of the program's ``io.output.ResultFile``
that its CLIs call, each variable's rows kept as host numpy arrays,
float64 or complex128 as the file would store them.  The card's machine
has no h5py, and a file a run would write some GiB.
"""

from __future__ import annotations

import numpy as np


def _host(value):
    """A row as a host numpy array (a tensor's ``.cpu().numpy()``)."""
    if hasattr(value, "detach"):
        value = value.detach().cpu().numpy()
    return np.asarray(value)


class MemoryStore:
    def __init__(self, num_rays=None):
        self.num_rays = num_rays
        self.rows = {}

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def close(self):
        pass

    def create_variable(self, name, complex_valued=False):
        self.rows.setdefault(name, {})

    def variables(self):
        return list(self.rows)

    @property
    def num_steps(self):
        return max((max(r) + 1 for r in self.rows.values() if r), default=0)

    def write_step(self, index, values):
        for name, value in values.items():
            value = _host(value)
            kind = np.complex128 if np.iscomplexobj(value) else np.float64
            self.rows[name][index] = value.astype(kind)

    def read_step(self, index, names, complex_valued=False):
        return {name: self.rows[name][index] for name in names}

    def stack(self, name, rays=slice(None)):
        """The (rows, rays) array of one variable."""
        return np.stack([self.rows[name][i][rays]
                         for i in range(self.num_steps)])


class MemoryFiles(dict):
    """Path -> MemoryStore; ``open`` is a store factory with the signature
    of the program's ``cli.open_result_file``: mode "w" starts the path's
    store afresh, "r+" reopens it."""

    def open(self, path, mode, num_rays=None):
        if mode == "w":
            self[path] = MemoryStore(num_rays)
        return self[path]
