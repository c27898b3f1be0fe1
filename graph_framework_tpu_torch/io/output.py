"""Result files: time series of per-ray variables, in NetCDF4 format.

Counterpart of ``graph_framework_tpu.io.output`` (reference:
output.hpp:32-472, solver.hpp:418-424), with the same on-disk layout, so
each package reads the other's files.  The reference writes NetCDF with
dimensions (time=unlimited, num_rays, ray_dim), ray_dim = 2 holding the
real and imaginary parts of complex scalars (output.hpp:61-64, 175-177,
221-231).

NetCDF4 is an HDF5 profile: the files are written with h5py and follow
netcdf-c's on-disk conventions, so the netCDF4 library, ncdump, xarray
and the reference's utilities/bin.py open them:

  * every dimension is an HDF5 dimension scale with
    ``CLASS="DIMENSION_SCALE"``, netcdf-c's phantom ``NAME`` string for a
    dimension without a coordinate variable, and ``_Netcdf4Dimid``;
  * every variable attaches the scales of all its dimensions;
  * a variable named like a dimension without being its 1D coordinate
    variable (the reference's 2D ``time(time, num_rays)``) is stored
    under netcdf-c's ``_nc4_non_coord_`` name;
  * the root group carries ``_NCProperties``.

``h5py`` is imported when a :class:`ResultFile` opens, not with the
module, so the module (and :class:`AsyncWriter`, :func:`state_row`)
imports where h5py is absent.

:class:`AsyncWriter` overlaps writes with device compute: its worker
thread copies each row's tensors to the host (``.cpu()`` of a CUDA
tensor waits for the work that makes it) and writes them, so the
producer only queues references and returns.  Its spans (``telemetry``):
``gft.writer.put``, the producer's wait for room in the queue;
``gft.writer.row``, a row's copy and write on the worker thread;
``gft.writer.close``, the wait for the queue to drain.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from graph_framework_tpu_torch import telemetry

# netcdf-c naming conventions (netcdf-c include/nc4internal.h)
_NON_COORD = "_nc4_non_coord_"
_DIM_WITHOUT_VARIABLE = \
    "This is a netCDF dimension but not a netCDF variable."
_NC_PROPERTIES = "version=2,netcdf=4.9.2,hdf5=1.14.3"


def _nc_str(s: str) -> np.bytes_:
    """Fixed-length ASCII attribute payload (netcdf-c writes H5T_C_S1)."""
    return np.bytes_(s.encode("ascii"))


class ResultFile:
    """A time-series result file (output.hpp:32-158).

    Mode "w" creates; "r+" reopens an existing file to append variables
    (the absorption phase reopens the trace output, output.hpp:73-82).
    """

    def __init__(self, path, num_rays: Optional[int] = None, mode="w"):
        import h5py

        self.path = str(path)
        self._h = h5py.File(self.path, mode)
        if mode == "w":
            self._h.attrs["_NCProperties"] = _nc_str(_NC_PROPERTIES)
        if num_rays is None:
            num_rays = int(self._h.attrs.get("num_rays", 0)) or None
            if num_rays is None and "num_rays" in self._h:
                num_rays = self._h["num_rays"].shape[0]
            if num_rays is None:
                for ds in self._h.values():
                    if not self._is_dim(ds):
                        num_rays = ds.shape[1]
                        break
        else:
            self._h.attrs["num_rays"] = num_rays
        self.num_rays = num_rays
        self._lock = threading.Lock()
        if mode == "w":
            if num_rays is None:
                raise ValueError("num_rays is required to create a file "
                                 "(result_file ctor, output.hpp:48-64)")
            # dims "time" (unlimited) and "num_rays" (output.hpp:61-64)
            self._def_dim("time", 0, unlimited=True, dimid=0)
            self._def_dim("num_rays", num_rays, dimid=1)

    # -- netCDF4 dimension machinery ---------------------------------------
    @staticmethod
    def _is_dim(ds) -> bool:
        return ds.attrs.get("CLASS", b"") == b"DIMENSION_SCALE"

    def _def_dim(self, name: str, size: int, *, unlimited=False,
                 dimid: int):
        """Create a netcdf-c style dimension-without-variable scale."""
        if name in self._h:
            return self._h[name]
        ds = self._h.create_dataset(
            name, shape=(size,), maxshape=(None,) if unlimited else (size,),
            dtype="f4")
        # netcdf-c registers the scale through H5DSset_scale with the
        # phantom string as the scale NAME: sprintf("%s%10d",
        # DIM_WITHOUT_VARIABLE, (int)len) - len is the CREATION length
        # (0 for unlimited).  h5py's make_scale is the same H5DS call.
        ds.make_scale(f"{_DIM_WITHOUT_VARIABLE}{size:10d}")
        ds.attrs["_Netcdf4Dimid"] = np.int32(dimid)
        return ds

    @staticmethod
    def _patch_reference_list(sc):
        """Match netcdf-c's REFERENCE_LIST grammar exactly: libhdf5 1.12
        (which netcdf-c 4.7.4 files like the reference's efit.nc were
        written with) stores the 'dimension' field as int32, while newer
        h5py/libhdf5 H5DSattach_scale writes uint32.  Rewritten here so the
        on-disk fingerprint is identical (tests/test_netcdf4_format.py
        cross-validates against the genuine netcdf-c file)."""
        rl = sc.attrs.get("REFERENCE_LIST")
        if rl is None or rl.dtype["dimension"] == np.dtype("<i4"):
            return
        dt = np.dtype({"names": ["dataset", "dimension"],
                       "formats": [rl.dtype["dataset"], "<i4"],
                       "offsets": [0, 8], "itemsize": 16})
        patched = np.empty(rl.shape, dtype=dt)
        patched["dataset"] = rl["dataset"]
        patched["dimension"] = rl["dimension"].astype("<i4")
        del sc.attrs["REFERENCE_LIST"]
        sc.attrs.create("REFERENCE_LIST", patched, dtype=dt)

    def _ray_dim(self):
        """The complex re/im dimension, created on first complex variable
        (output.hpp:221-231 defines it lazily per complex type)."""
        if "ray_dim" not in self._h:
            self._def_dim("ray_dim", 2, dimid=len(self._dims()))
        return self._h["ray_dim"]

    def _dims(self):
        return [n for n, ds in self._h.items() if self._is_dim(ds)]

    def _dataset_name(self, name: str) -> str:
        """Variables named like a dimension are not 1D coordinate
        variables here (e.g. 2D time(time, num_rays)), so netcdf-c's
        mangled non-coordinate name applies."""
        mangled = _NON_COORD + name
        if mangled in self._h:
            return mangled
        if name in self._h and not self._is_dim(self._h[name]):
            return name
        if name in self._dims():
            return mangled
        return name

    # -- define mode -------------------------------------------------------
    def create_variable(self, name: str, complex_valued=False):
        """(data_set::create_variable, output.hpp:260-273): a resizable
        (time, num_rays[, ray_dim]) netCDF4 variable."""
        dsname = self._dataset_name(name)
        if dsname in self._h:
            return
        shape = (0, self.num_rays) + ((2,) if complex_valued else ())
        maxshape = (None,) + shape[1:]
        ds = self._h.create_dataset(dsname, shape=shape, maxshape=maxshape,
                                    dtype="f8", chunks=(1,) + shape[1:])
        scales = [self._h["time"], self._h["num_rays"]]
        if complex_valued:
            scales.append(self._ray_dim())
        for i, sc in enumerate(scales):
            ds.dims[i].attach_scale(sc)
            self._patch_reference_list(sc)
        return ds

    def variables(self):
        out = []
        for n, ds in self._h.items():
            if self._is_dim(ds):
                continue
            out.append(n[len(_NON_COORD):] if n.startswith(_NON_COORD)
                       else n)
        return out

    def _get(self, name: str):
        return self._h[self._dataset_name(name)]

    # -- read/write --------------------------------------------------------
    def write_step(self, index: int, values: Dict[str, np.ndarray]):
        """Write one time row for each named variable (strided
        nc_put_vara, output.hpp:353-400)."""
        with self._lock:
            for name, val in values.items():
                ds = self._get(name)
                val = host_array(val)
                if np.iscomplexobj(val):
                    val = np.stack([val.real, val.imag], axis=-1)
                if ds.shape[0] <= index:
                    ds.resize(index + 1, axis=0)
                ds[index] = val
            # unlimited dims track the longest variable (netcdf-c keeps the
            # scale dataset's extent in sync on write)
            tdim = self._h["time"]
            if tdim.shape[0] <= index:
                tdim.resize(index + 1, axis=0)
            self._h.flush()

    def read_step(self, index: int, names: Sequence[str],
                  complex_valued=False) -> Dict[str, np.ndarray]:
        """Read one time row (the absorption phase's per-timestep read,
        absorption.hpp:465-483)."""
        out = {}
        with self._lock:
            for name in names:
                a = np.asarray(self._get(name)[index])
                if a.ndim == 2 and a.shape[-1] == 2 and complex_valued:
                    # by parts: re + 1j * im would make inf parts NaN
                    parts = a
                    a = np.empty(parts.shape[:-1], dtype=np.complex128)
                    a.real, a.imag = parts[..., 0], parts[..., 1]
                out[name] = a
        return out

    @property
    def num_steps(self):
        # max over variables: freshly-appended variables (e.g. kamp before
        # the absorption pass fills it) still have zero rows.
        sizes = [ds.shape[0] for ds in self._h.values()
                 if not self._is_dim(ds)]
        return max(sizes) if sizes else 0

    def close(self):
        with self._lock:
            self._h.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def host_array(value) -> np.ndarray:
    """``value`` as a numpy array: a tensor (on any device) is detached
    and copied to the host."""
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().resolve_conj().numpy()
    return np.asarray(value)


class AsyncWriter:
    """Single worker thread draining a write queue (the reference's
    detached writer thread + work.wait() handshake, solver.hpp:418-424).

    Tensors are copied to the host *in the worker*, so the producer only
    queues references and returns; the copy of a CUDA tensor then
    overlaps the device work queued after it.  A queued tensor is never
    written to again: the port's steps make new tensors.  A write that
    fails raises from the next ``write_step`` or from ``close``.
    """

    def __init__(self, file: ResultFile, max_pending: int = 2):
        self.file = file
        self._q = queue.Queue(maxsize=max_pending)
        self._err = None
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            index, values = item
            try:
                with telemetry.span("gft.writer.row"):
                    self.file.write_step(
                        index, {k: host_array(v) for k, v in values.items()})
            except Exception as e:          # surfaced on close()
                self._err = e

    def write_step(self, index: int, values: Dict):
        if self._err:
            raise self._err
        with telemetry.span("gft.writer.put"):
            self._q.put((index, dict(values)))

    def close(self):
        with telemetry.span("gft.writer.close"):
            self._q.put(None)
            self._thread.join()
        if self._err:
            raise self._err


def state_row(state, residual=None):
    """Map a RayState (+ optional residual) to the reference's output
    variable names (solver.hpp:352-360)."""
    row = {"time": state.t, "w": state.w, "x": state.x, "y": state.y,
           "z": state.z, "kx": state.kx, "ky": state.ky, "kz": state.kz}
    if residual is not None:
        row["residual"] = residual
    return row
