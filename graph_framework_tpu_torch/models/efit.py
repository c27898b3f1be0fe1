"""EFIT tokamak equilibrium: bicubic psi(R, Z) + cubic profiles of psi.

Counterpart of ``graph_framework_tpu.models.efit`` (reference:
equilibrium.hpp:1145-1844).  The coefficient tables are cell-major tensors
- psi (nr, nz, 4, 4), profiles (npsi, 4, 4) - so one ray's cell is one
contiguous 16-value block, gathered by a linearized index.  The field
derivatives dpsi/dr, dpsi/dz come from the analytic spline jet.

Loading is split in two so that a caller without ``h5py`` or a file can
still build an equilibrium: :func:`read_efit_tables` reads the file's
tables into numpy (``h5py``), and :func:`efit_from_tables` builds the
equilibrium from such tables - also from
``tools.make_splines.efit_tables`` of gridded samples.

Reference quirks are kept exactly, for trajectory parity with the JAX
package and the reference's golden data: ne's c0/c1 tables come from te's
(equilibrium.hpp:1478), the ion density is the te profile (:1361), and the
ion temperature uses the rounded charge 1.60218e-19 (:1358).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from graph_framework_tpu_torch.models.equilibrium import (
    Equilibrium, PlasmaQuantities)
from graph_framework_tpu_torch.ops.newton import newton_solve_multi
from graph_framework_tpu_torch.ops.spline import (
    eval_bicubic_2d, eval_bicubic_jet, eval_bicubic_jet_block,
    eval_cubic_1d, eval_cubic_multi, eval_cubic_multi_block, rebase_cells_1d,
    rebase_cells_2d, to_cell_major_1d, to_cell_major_2d)
from graph_framework_tpu_torch.ops.tables import table_index_1d

#: The reference's rounded elementary charge in the ion temperature
#: (equilibrium.hpp:1358-1362).
Q_ROUNDED = 1.60218e-19

#: The single deuterium ion species of EFIT (equilibrium.hpp:1475).
DEUTERIUM_MASS = 3.34449469e-27


def _magnetic_field(x, y, r, psi_r, psi_z, fpol):
    """B from psi's R/Z derivatives and fpol, rotated to cartesian with
    cos(phi) = x/r, sin(phi) = y/r (equilibrium.hpp:1364-1382)."""
    br = psi_z / r
    bp = fpol / r
    bz = -psi_r / r
    c, s = x / r, y / r
    return torch.stack([br * c - bp * s, br * s + bp * c, bz])


def _plasma_quantities(x, y, r, psi_r, psi_z, vals, base):
    """PlasmaQuantities from the jet and the four profile values
    (ne, te, pressure, fpol) - shared by the full and the frozen views."""
    ne = base.ne_scale * vals[..., 0]
    te = base.te_scale * vals[..., 1]
    pres = base.pres_scale * vals[..., 2]
    b = _magnetic_field(x, y, r, psi_r, psi_z, vals[..., 3])
    ni = te                              # ni = te quirk (:1361)
    # (pres - ne te q) / (ni q), the reference's ti (:1358), with q divided
    # out first: ni q is about 3e-16, and autograd's second derivatives
    # of a quotient by it take its cube, which is below f32's range (NaN
    # gradients of acoustic_wave and ion_cyclotron in f32)
    ti = (pres / Q_ROUNDED - ne * te) / ni
    return PlasmaQuantities(b=b, ne=ne, te=te, ni=(ni,), ti=(ti,))


@dataclasses.dataclass(frozen=True)
class EfitEquilibrium(Equilibrium):
    """Tokamak equilibrium from EFIT bicubic-spline data."""

    # psi tables, cell-major (nr, nz, 4, 4): [i, j, r_power, z_power].
    psi_coeffs: torch.Tensor
    # 1D profile tables, cell-major (numpsi, 4).
    ne_coeffs: torch.Tensor
    te_coeffs: torch.Tensor
    pres_coeffs: torch.Tensor
    fpol_coeffs: torch.Tensor
    # fused profile stack (numpsi, 4, 4): [cell, (ne,te,pres,fpol), power].
    profile_coeffs: torch.Tensor
    psimin: float
    dpsi: float
    rmin: float
    dr: float
    zmin: float
    dz: float
    ne_scale: float
    te_scale: float
    pres_scale: float
    # True when the tables were rebased to cell-local coordinates at load.
    cell_local: bool = False

    ion_masses = (DEUTERIUM_MASS,)
    ion_charges = (1,)

    def psi_rz(self, r, z):
        """psi(R, Z) (efit::build_psi, equilibrium.hpp:1278-1313)."""
        return eval_bicubic_2d(self.psi_coeffs, r, self.dr, self.rmin,
                               z, self.dz, self.zmin, local=self.cell_local)

    def psi(self, pos):
        r = torch.sqrt(pos[0] * pos[0] + pos[1] * pos[1])
        return self.psi_rz(r, pos[2])

    def profiles(self, psi_val):
        """(ne, te, pressure, fpol) at a psi value with one fused gather."""
        vals = eval_cubic_multi(self.profile_coeffs, psi_val, self.dpsi,
                                self.psimin, local=self.cell_local)
        return (self.ne_scale * vals[..., 0], self.te_scale * vals[..., 1],
                self.pres_scale * vals[..., 2], vals[..., 3])

    def _jet(self, x, y, z):
        r = torch.sqrt(x * x + y * y)
        psi_val, psi_r, psi_z = eval_bicubic_jet(
            self.psi_coeffs, r, self.dr, self.rmin, z, self.dz, self.zmin,
            local=self.cell_local)
        return r, psi_val, psi_r, psi_z

    def magnetic_field(self, pos):
        x, y, z = pos[0], pos[1], pos[2]
        r, psi_val, psi_r, psi_z = self._jet(x, y, z)
        fpol = eval_cubic_1d(self.fpol_coeffs, psi_val, self.dpsi,
                             self.psimin, local=self.cell_local)
        return _magnetic_field(x, y, r, psi_r, psi_z, fpol)

    def plasma_quantities(self, pos):
        """All dispersion inputs from two gathers: one bicubic jet block
        and one fused profile block (ne, te, pressure, fpol share psi's
        cell index)."""
        x, y, z = pos[0], pos[1], pos[2]
        r, psi_val, psi_r, psi_z = self._jet(x, y, z)
        vals = eval_cubic_multi(self.profile_coeffs, psi_val, self.dpsi,
                                self.psimin, local=self.cell_local)
        return _plasma_quantities(x, y, r, psi_r, psi_z, vals, self)

    def characteristic_field(self):
        """|B| at the magnetic axis (a 0-dim tensor), found by Newton on
        the normalized flux from the seed (1.7, 0, 0) with step 0.1
        (equilibrium.hpp:1584-1615)."""

        def flux(xa, za):
            pos = torch.stack([xa, torch.zeros_like(xa), za])
            return (self.psi(pos) - self.psimin) / self.dpsi

        like = self.psi_coeffs
        start = (torch.tensor(1.7, dtype=like.dtype, device=like.device),
                 torch.tensor(0.0, dtype=like.dtype, device=like.device))
        (xa, za), _, _ = newton_solve_multi(
            flux, start, tolerance=1.0e-30, max_iterations=1000, step=0.1)
        b = self.magnetic_field(torch.stack([xa, torch.zeros_like(xa), za]))
        return torch.sqrt(torch.sum(b * b))

    def freeze_cells(self, pos):
        """Gather this position's spline blocks ONCE and return a
        :class:`FrozenCellEfit` view that evaluates plasma_quantities
        against them (the freeze window's shared gather)."""
        if not self.cell_local:
            raise ValueError("freeze_cells requires cell_local tables "
                             "(the default load path)")
        x, y, z = pos[0], pos[1], pos[2]
        r = torch.sqrt(x * x + y * y)
        nr, nc = self.psi_coeffs.shape[:2]
        i = table_index_1d(r, self.dr, self.rmin, nr)
        j = table_index_1d(z, self.dz, self.zmin, nc)
        psi_block = self.psi_coeffs.reshape(nr * nc, 16)[i * nc + j]
        u = (r - self.rmin) / self.dr - i.to(r.dtype)
        v = (z - self.zmin) / self.dz - j.to(r.dtype)
        psi_val, _, _ = eval_bicubic_jet_block(psi_block, u, v,
                                               self.dr, self.dz)
        pidx = table_index_1d(psi_val, self.dpsi, self.psimin,
                              self.profile_coeffs.shape[0])
        prof_block = self.profile_coeffs[pidx]          # (..., 4, 4)
        f = r.dtype
        return FrozenCellEfit(
            psi_block=psi_block, iu=i.to(f), jv=j.to(f),
            prof_block=prof_block, pidx=pidx.to(f), base=self)


@dataclasses.dataclass(frozen=True)
class FrozenCellEfit(Equilibrium):
    """Cell-frozen view for freeze-window stepping (narrowed contract).

    ``EfitEquilibrium.freeze_cells(pos)`` gathers each ray's bicubic psi
    block and fused profile block once, at the window's base state; this
    view then serves every stage of the window's substeps from those
    blocks with cell-local coordinates that may run slightly past [0, 1).
    Valid while the stage positions stay within O(K dt v_g) of the base
    point: a stage that crosses a cell boundary extrapolates the base
    cell's polynomial, and cubic pieces are C2, so the deviation is
    |third-derivative jump| delta^3 / 6 with delta the crossing depth in
    cell units (the JAX package's FrozenCellEfit documents the measured
    bound).  Requires cell_local tables.
    """
    psi_block: torch.Tensor    # (..., 16) bicubic coefficients
    iu: torch.Tensor           # frozen r-cell index (as float)
    jv: torch.Tensor           # frozen z-cell index
    prof_block: torch.Tensor   # (..., 4, 4) [profile, power]
    pidx: torch.Tensor         # frozen psi-cell index (as float)
    base: EfitEquilibrium

    @property
    def ion_masses(self):
        return self.base.ion_masses

    @property
    def ion_charges(self):
        return self.base.ion_charges

    def plasma_quantities(self, pos):
        base = self.base
        x, y, z = pos[0], pos[1], pos[2]
        r = torch.sqrt(x * x + y * y)
        u = (r - base.rmin) / base.dr - self.iu
        v = (z - base.zmin) / base.dz - self.jv
        psi_val, psi_r, psi_z = eval_bicubic_jet_block(
            self.psi_block, u, v, base.dr, base.dz)
        up = (psi_val - base.psimin) / base.dpsi - self.pidx
        vals = eval_cubic_multi_block(self.prof_block, up)
        return _plasma_quantities(x, y, r, psi_r, psi_z, vals, base)


def read_efit_tables(path):
    """Read an EFIT spline file's tables (make_efit's loader keys,
    equilibrium.hpp:1627-1844) into the dict :func:`efit_from_tables`
    takes.  Needs ``h5py``."""
    import h5py

    with h5py.File(path, "r") as h:
        def arr(name):
            return np.asarray(h[name][...], dtype=np.float64)

        tables = {key: float(arr(key)) for key in (
            "psimin", "dpsi", "rmin", "dr", "zmin", "dz",
            "ne_scale", "te_scale", "pres_scale")}
        tables["psi"] = np.stack([
            np.stack([arr(f"psi_c{a}{b}") for b in range(4)])
            for a in range(4)])                      # (4, 4, nr, nz)
        for name in ("ne", "te", "pressure", "fpol"):
            tables[name] = np.stack([arr(f"{name}_c{i}") for i in range(4)])
    return tables


def efit_from_tables(tables, *, dtype=torch.float64, device="cuda",
                     replicate_reference_quirks=True, cell_local=True):
    """Build an :class:`EfitEquilibrium` from file-format tables: ``psi``
    (4, 4, nr, nz) and ``ne``/``te``/``pressure``/``fpol`` (4, npsi) in the
    global normalized coordinate, plus the float scalars (see
    :func:`read_efit_tables`, ``tools.make_splines.efit_tables``).

    ``replicate_reference_quirks``: initialize ne's c0/c1 tables from te's,
    as the reference's efit constructor does (equilibrium.hpp:1478).
    ``cell_local``: rebase the tables to cell-local coordinates in extended
    precision (well-conditioned evaluation; required by freeze_cells).
    """
    psi = tables["psi"]
    ne, te = tables["ne"], tables["te"]
    pres, fpol = tables["pressure"], tables["fpol"]
    if replicate_reference_quirks:
        ne = np.stack([te[0], te[1], ne[2], ne[3]])
    if cell_local:
        psi = rebase_cells_2d(psi)
        ne, te = rebase_cells_1d(ne), rebase_cells_1d(te)
        pres, fpol = rebase_cells_1d(pres), rebase_cells_1d(fpol)
    psi = to_cell_major_2d(psi)
    ne, te = to_cell_major_1d(ne), to_cell_major_1d(te)
    pres, fpol = to_cell_major_1d(pres), to_cell_major_1d(fpol)
    profile = np.stack([ne, te, pres, fpol], axis=1)   # (n, 4, 4)

    def tensor(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=device)

    return EfitEquilibrium(
        psi_coeffs=tensor(psi), ne_coeffs=tensor(ne), te_coeffs=tensor(te),
        pres_coeffs=tensor(pres), fpol_coeffs=tensor(fpol),
        profile_coeffs=tensor(profile), cell_local=cell_local,
        **{key: float(tables[key]) for key in (
            "psimin", "dpsi", "rmin", "dr", "zmin", "dz",
            "ne_scale", "te_scale", "pres_scale")})


def make_efit(path, *, dtype=torch.float64, device="cuda",
              replicate_reference_quirks=True, cell_local=True):
    """Load an EFIT spline file (make_efit, equilibrium.hpp:1627-1844)."""
    return efit_from_tables(
        read_efit_tables(path), dtype=dtype, device=device,
        replicate_reference_quirks=replicate_reference_quirks,
        cell_local=cell_local)
