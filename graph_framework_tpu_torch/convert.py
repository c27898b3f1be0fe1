"""Carry equilibria and ray and particle states across from the JAX package.

The port imports no ``jax``, so these take the JAX objects duck-typed:
anything with the right attributes whose arrays ``numpy.asarray`` accepts
(a ``graph_framework_tpu`` EfitEquilibrium, VmecEquilibrium, RayState,
ParticleState or PicState, or their numpy copies).  The tests use them to feed both
packages the same inputs.  The tensors land on the card unless the caller
names another ``device``.
"""

from __future__ import annotations

import numpy as np
import torch

from graph_framework_tpu_torch.models.efit import EfitEquilibrium
from graph_framework_tpu_torch.models.korc import ParticleState
from graph_framework_tpu_torch.models.pic import PicState
from graph_framework_tpu_torch.models.rays import RayState
from graph_framework_tpu_torch.models.vmec import VmecEquilibrium

_EFIT_TABLES = ("psi_coeffs", "ne_coeffs", "te_coeffs", "pres_coeffs",
                "fpol_coeffs", "profile_coeffs")
_EFIT_SCALARS = ("psimin", "dpsi", "rmin", "dr", "zmin", "dz",
                 "ne_scale", "te_scale", "pres_scale")


def _tensor(a, dtype, device):
    return torch.as_tensor(np.array(a, dtype=np.float64),
                           dtype=dtype, device=device)


def efit_from_numpy(eq, *, dtype=torch.float64, device="cuda"):
    """The port's :class:`EfitEquilibrium` holding the same tables and
    scalars as ``eq`` (the JAX package's EfitEquilibrium)."""
    return EfitEquilibrium(
        **{k: _tensor(getattr(eq, k), dtype, device) for k in _EFIT_TABLES},
        **{k: float(getattr(eq, k)) for k in _EFIT_SCALARS},
        cell_local=bool(eq.cell_local))


_VMEC_TABLES = ("chi_coeffs", "rmnc_coeffs", "zmns_coeffs", "lmns_coeffs",
                "xm", "xn")
_VMEC_GRID = ("xm_unique", "xn_unique", "xm_grid", "xn_grid")
_VMEC_SCALARS = ("signj", "dphi", "sminf", "sminh", "ds")
_VMEC_FLAGS = ("cell_local", "fused_mode_sums", "quirky_chi")


def vmec_from_numpy(eq, *, dtype=torch.float64, device="cuda"):
    """The port's :class:`VmecEquilibrium` holding the same tables, mode
    and mode-grid metadata, scalars and flags as ``eq`` (the JAX package's
    VmecEquilibrium)."""
    return VmecEquilibrium(
        **{k: _tensor(getattr(eq, k), dtype, device)
           for k in _VMEC_TABLES + _VMEC_GRID},
        grid_scatter=torch.as_tensor(
            np.array(eq.grid_scatter, dtype=np.int64), device=device),
        **{k: float(getattr(eq, k)) for k in _VMEC_SCALARS},
        **{k: bool(getattr(eq, k)) for k in _VMEC_FLAGS})


def _fields(cls, state, dtype, device):
    return cls(*[_tensor(getattr(state, f), dtype, device)
                 for f in cls._fields])


def ray_state_from_numpy(state, *, dtype=torch.float64, device="cuda"):
    """The port's :class:`RayState` with the leaves of ``state`` (any
    object with fields t, w, x, y, z, kx, ky, kz)."""
    return _fields(RayState, state, dtype, device)


def particle_state_from_numpy(state, *, dtype=torch.float64,
                              device="cuda"):
    """The port's :class:`ParticleState` with the leaves of ``state`` (any
    object with fields x, y, z, ux, uy, uz, gamma)."""
    return _fields(ParticleState, state, dtype, device)


def pic_state_from_numpy(state, *, dtype=torch.float64, device="cuda"):
    """The port's :class:`PicState` with the leaves of ``state`` (any
    object with fields x, vpara, epara, n)."""
    return _fields(PicState, state, dtype, device)
