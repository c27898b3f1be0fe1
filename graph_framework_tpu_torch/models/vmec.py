"""VMEC stellarator equilibrium: Fourier-mode radial splines in flux coords.

Counterpart of ``graph_framework_tpu.models.vmec`` (reference:
equilibrium.hpp:1867-2651).  Coordinates are flux coordinates (s, u, v);
the cylindrical R, Z and the stream function lambda are Fourier series
over (xm, xn) modes with per-mode cubic radial splines:

    R(s,u,v) = sum_m rmnc_m(s) cos(xm_m u - xn_m v)        (:2113-2119)
    Z(s,u,v) = sum_m zmns_m(s) sin(xm_m u - xn_m v)
    l(s,u,v) = sum_m lmns_m(s) sin(xm_m u - xn_m v)        (half grid)

The Jacobian of (R, Z, l) with respect to (s, u, v) is written out
analytically (:func:`_rzl_and_jac`); the covariant and contravariant bases
and B follow from cross products and the Jacobian (:2030-2140).  All of it
is plain batched torch: positions are (3, ...) with the component axis
leading, so autograd gives the ray equations their derivatives.

Tables are cell-major, (num_s, 4, num_modes), so a ray's radial cell is
one contiguous (4, num_modes) block, fetched by the spline tables' row
gather ``ops.tables.gather_rows``, whose transpose is the table scatter
kernel where a table takes a gradient (the JAX package's one-hot matrix
product for f32 ensembles is a TPU gather workaround and is not carried
over).  The geometry runs on the mode grid, which ``vmec_from_tables``
builds: the (unique xm) x (unique xn) slots - 90 for the reference's 86
modes - onto which the runtime scatters the tables, so that the trig
factors come from outer products of per-unique-mode cos/sin
(:func:`_grid_trig`).

``fused_mode_sums=True`` routes the batched f32 geometry through the
hand-written kernel K4 (:mod:`graph_framework_tpu_torch.kernels.
vmec_geom`), under the JAX package's condition: cell-local tables, (rays,)
coordinates, float32.  The kernel loops over the per-mode tables, not the
grid.  There the tables are constants: table gradients
need ``fused_mode_sums=False``, and ``l`` and dl/ds come back as zeros
(the geometry reads neither).  The value path of cold plasma's ray
equations takes the kernel K8 there
(:mod:`graph_framework_tpu_torch.kernels.vmec_rhs`, over K4's jet) in
place of the eager geometry, D and autograd
(:meth:`VmecEquilibrium.value_rhs`).

Loading is split like EFIT's: :func:`read_vmec_tables` reads a file's
tables into numpy (``h5py``, host only), :func:`vmec_from_tables` builds
the equilibrium from such tables - also from
``tools.make_splines.vmec_tables`` of gridded samples.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from graph_framework_tpu_torch.kernels import vmec_geom, vmec_rhs
from graph_framework_tpu_torch.models.dispersion import cold_plasma
from graph_framework_tpu_torch.models.equilibrium import (
    Equilibrium, PlasmaQuantities)
from graph_framework_tpu_torch.ops.spline import (
    rebase_cells_1d, to_cell_major_1d)
from graph_framework_tpu_torch.ops.tables import gather_rows, table_index_1d

#: The single deuterium ion species of VMEC (equilibrium.hpp:2206).
DEUTERIUM_MASS = 3.34449469e-27


def _radial_block(coeffs, s, scale, offset, local):
    """Each point's (..., 4, M) radial block and its (cell-local, when
    ``local``) normalized coordinate, broadcast over the modes."""
    u = (s - offset) / scale
    idx = table_index_1d(s, scale, offset, coeffs.shape[0])
    if local:
        u = u - idx.to(u.dtype)
    return gather_rows(coeffs, idx), u.unsqueeze(-1)


def _spline_modes(coeffs, s, scale, offset, local):
    """All per-mode radial splines at s: ``coeffs`` (num_s, 4, M) gives
    (..., M)."""
    block, u = _radial_block(coeffs, s, scale, offset, local)
    return (block[..., 0, :] + u * (block[..., 1, :]
            + u * (block[..., 2, :] + u * block[..., 3, :])))


def _horner_jet(block, u, scale):
    """Value and d/ds of the cubic over the (..., 4, M) block at the
    normalized coordinate u (..., 1): one fetch serves both."""
    c0, c1 = block[..., 0, :], block[..., 1, :]
    c2, c3 = block[..., 2, :], block[..., 3, :]
    val = c0 + u * (c1 + u * (c2 + u * c3))
    dval = (c1 + u * (2.0 * c2 + 3.0 * u * c3)) / scale
    return val, dval


def _spline_modes_jet(coeffs, s, scale, offset, local):
    """All per-mode radial splines AND their s-derivatives from one block
    fetch.  Returns (value, d/ds), each (..., M)."""
    block, u = _radial_block(coeffs, s, scale, offset, local)
    return _horner_jet(block, u, scale)


def _grid_trig(xm_u, xn_u, u, v):
    """cos/sin of every (unique-xm x unique-xn) grid angle via outer
    products: cos(a - b) = cos a cos b + sin a sin b over a = xm_i u,
    b = xn_j v, so only 2 (n_xm + n_xn) transcendentals a point.

    Returns (ca, sa), each (..., n_xm * n_xn), grid index g = i n_xn + j.
    """
    au = u.unsqueeze(-1) * xm_u
    bv = v.unsqueeze(-1) * xn_u
    cm, sm = torch.cos(au), torch.sin(au)
    cn, sn = torch.cos(bv), torch.sin(bv)
    ca = (cm.unsqueeze(-1) * cn.unsqueeze(-2)
          + sm.unsqueeze(-1) * sn.unsqueeze(-2))
    sa = (sm.unsqueeze(-1) * cn.unsqueeze(-2)
          - cm.unsqueeze(-1) * sn.unsqueeze(-2))
    return ca.flatten(-2), sa.flatten(-2)


def _profile(s):
    """(1 - (sqrt(s^2))^1.5)^2 (equilibrium.hpp:2150-2153)."""
    return (1.0 - torch.sqrt(s * s) ** 1.5) ** 2


class _VmecView(Equilibrium):
    """What every VMEC view shares: one deuterium species, flux
    coordinates (not cartesian, batched), and the analytic profiles of s
    (equilibrium.hpp:2150-2172)."""

    ion_masses = (DEUTERIUM_MASS,)
    ion_charges = (1,)

    def is_cartesian(self):
        return False

    def supports_batched(self):
        return True

    def electron_density(self, pos):
        return 1.0e19 * _profile(pos[0])

    def ion_density(self, index, pos):
        return self.electron_density(pos)

    def electron_temperature(self, pos):
        return 1000.0 * _profile(pos[0])

    def ion_temperature(self, index, pos):
        return self.electron_temperature(pos)

    def bind_point(self, pos):
        return _BoundVmec(self, self._geometry(pos))

    def esup(self, pos):
        return self._geometry(pos)["esup"]

    def magnetic_field(self, pos):
        return self._geometry(pos)["bvec"]


@dataclasses.dataclass(frozen=True)
class VmecEquilibrium(_VmecView):
    """Stellarator equilibrium in VMEC flux coordinates."""

    chi_coeffs: torch.Tensor     # (numsf, 4) poloidal flux chi(s)
    rmnc_coeffs: torch.Tensor    # (numsf, 4, num_modes) cell-major
    zmns_coeffs: torch.Tensor    # (numsf, 4, num_modes) cell-major
    lmns_coeffs: torch.Tensor    # (numsh, 4, num_modes) half grid
    xm: torch.Tensor             # (num_modes,) poloidal mode numbers
    xn: torch.Tensor             # (num_modes,) toroidal mode numbers
    signj: float
    dphi: float
    sminf: float
    sminh: float
    ds: float
    # the mode grid (built by vmec_from_tables): each mode's slot in the
    # dense (unique xm) x (unique xn) grid, the unique mode numbers and
    # each slot's (xm, xn); missing combinations hold zero coefficients
    grid_scatter: torch.Tensor   # (num_modes,) int64
    xm_unique: torch.Tensor      # (n_xm,)
    xn_unique: torch.Tensor      # (n_xn,)
    xm_grid: torch.Tensor        # (n_xm * n_xn,)
    xn_grid: torch.Tensor
    cell_local: bool = False
    # route the batched f32 geometry through the kernel K4 (module doc)
    fused_mode_sums: bool = False
    # replicate the reference's double-normalized chi argument (see chi())
    quirky_chi: bool = False
    # derived tables of this object (K4's), built at first use
    _cache: dict = dataclasses.field(default_factory=dict, init=False,
                                     repr=False, compare=False)

    def k4_serves(self, s):
        """Whether the kernel K4 computes the geometry's sums at the
        coordinates ``s``: ``fused_mode_sums``, cell-local tables, (rays,)
        float32 (the JAX package's condition)."""
        return (self.fused_mode_sums and self.cell_local and s.ndim == 1
                and s.dtype == torch.float32)

    def value_rhs(self, dispersion):
        """K4 and K8 (``kernels.vmec_rhs``) as the ray RHS's value path of
        cold plasma with the physical chi (not ``quirky_chi``):
        ``rhs(leaves)`` gives the six derivatives of the leaves (w, s, u, v,
        k_s, k_u, k_v), or None unless K4 serves s (:meth:`k4_serves`) and
        all seven leaves share its shape, dtype and device with the chi
        table.  None for another dispersion, or where K4 serves no
        coordinates.

        On the card the first call goes through the two wrappers, which
        check the tables against the leaves; later calls, whose leaves the
        condition above holds to that same dtype and device, launch the
        two kernels without the wrappers' checks."""
        if not (dispersion is cold_plasma and self.fused_mode_sums
                and self.cell_local and not self.quirky_chi):
            return None
        chi = self.chi_coeffs
        checked = []

        def rhs(leaves):
            s = leaves[1]
            if not (self.k4_serves(s) and chi.dtype == s.dtype
                    and chi.device == s.device and all(
                        a.dtype == s.dtype and a.shape == s.shape
                        and a.device == s.device for a in leaves)):
                return None
            leaves = [a.contiguous() for a in leaves]
            tables = vmec_geom.jet_tables(self)
            params = vmec_rhs.rhs_params(self)
            if checked:
                return vmec_rhs.launch(
                    leaves, vmec_geom.launch(*leaves[1:4], tables), params)
            out = vmec_rhs.ray_rhs(
                leaves, vmec_geom.geometry_jet(*leaves[1:4], tables), params)
            if s.device.type == "cuda":
                checked.append(True)
            return out

        return rhs

    def _grid_table(self, coeffs):
        """Scatter a (num_s, 4, num_modes) table onto the dense mode grid
        (differentiable in ``coeffs``)."""
        n_grid = self.xm_grid.shape[0]
        out = coeffs.new_zeros(coeffs.shape[:-1] + (n_grid,))
        return out.index_copy(-1, self.grid_scatter, coeffs)

    # -- Fourier geometry --------------------------------------------------
    def _rzl(self, s, u, v):
        """R, Z, lambda at a flux-space point (equilibrium.hpp:2083-2121)."""
        rm = _spline_modes(self._grid_table(self.rmnc_coeffs), s, self.ds,
                           self.sminf, self.cell_local)
        zm = _spline_modes(self._grid_table(self.zmns_coeffs), s, self.ds,
                           self.sminf, self.cell_local)
        lm = _spline_modes(self._grid_table(self.lmns_coeffs), s, self.ds,
                           self.sminh, self.cell_local)
        ca, sa = _grid_trig(self.xm_unique, self.xn_unique, u, v)
        return ((rm * ca).sum(-1), (zm * sa).sum(-1), (lm * sa).sum(-1))

    def _chi_jet(self, s):
        """chi(s) and dchi/ds (see :meth:`chi`)."""
        arg = (s - self.sminf) / self.ds if self.quirky_chi else s
        un = (arg - self.sminf) / self.ds
        idx = table_index_1d(arg, self.ds, self.sminf,
                             self.chi_coeffs.shape[0])
        if self.cell_local:
            un = un - idx.to(un.dtype)
        c = gather_rows(self.chi_coeffs, idx)
        c0, c1, c2, c3 = c[..., 0], c[..., 1], c[..., 2], c[..., 3]
        val = c0 + un * (c1 + un * (c2 + un * c3))
        d = (c1 + un * (2.0 * c2 + 3.0 * un * c3)) / self.ds
        if self.quirky_chi:
            d = d / self.ds
        return val, d

    def radial_modes(self, s):
        """Every mode's radial splines at s, per mode (no mode grid):
        (rm, zm, rm', zm', lm), each (..., num_modes) - the coefficient
        blocks the mode sums take (kernels/vmec_modes.py, K7)."""
        m = self.xm.shape[0]
        rz = torch.cat([self.rmnc_coeffs, self.zmns_coeffs], dim=-1)
        rzm, rzm_s = _spline_modes_jet(rz, s, self.ds, self.sminf,
                                       self.cell_local)
        lm, _ = _spline_modes_jet(self.lmns_coeffs, s, self.ds, self.sminh,
                                  self.cell_local)
        return (rzm[..., :m], rzm[..., m:], rzm_s[..., :m], rzm_s[..., m:],
                lm)

    def chi(self, s):
        """Poloidal flux spline chi(s).

        The reference evaluates chi at the *normalized* radial coordinate
        (``get_chi(s_norm_f)``, equilibrium.hpp:2131), which normalizes
        the argument twice; as the JAX package does, this evaluates the
        physically intended chi(s), and ``quirky_chi=True`` reproduces the
        literal reference arithmetic for comparison runs."""
        return self._chi_jet(s)[0]

    def phi(self, s):
        """Toroidal flux: signj * dphi * s (equilibrium.hpp:2061)."""
        return self.signj * self.dphi * s

    def _geometry(self, pos):
        """Covariant/contravariant bases, Jacobian and B at (s, u, v)
        (set_cache, equilibrium.hpp:2073-2141); ``pos`` is (3,) or
        (3, num_rays)."""
        s, u, v = pos[0], pos[1], pos[2]
        (r, z, _l), (dr, dz, dl) = _rzl_and_jac(self, s, u, v)
        dchi_ds = self._chi_jet(s)[1]
        return _assemble_geometry(v, r, z, dr, dz, dl, dchi_ds,
                                  self.signj * self.dphi)

    def freeze_cells(self, pos):
        """Radial freeze window: fetch each ray's radial blocks (rmnc and
        zmns concatenated, lmns, chi) ONCE at the window-base s and return
        a :class:`FrozenRadialVmec` whose geometry evaluates the radial
        polynomials against them with cell-local coordinates - only the
        radial CELL is frozen; the polynomial in s and the trig stay exact
        at every stage.  Enables ``Solver(frozen_cells=True,
        freeze_every=K)`` for VMEC."""
        if not self.cell_local:
            raise ValueError("freeze_cells requires cell_local tables")
        if self.quirky_chi:
            raise ValueError("freeze_cells with quirky_chi is not "
                             "supported (comparison-only path)")
        s = pos[0]
        rz_tab = torch.cat([self._grid_table(self.rmnc_coeffs),
                            self._grid_table(self.zmns_coeffs)], dim=-1)
        l_tab = self._grid_table(self.lmns_coeffs)
        idx_f = table_index_1d(s, self.ds, self.sminf, rz_tab.shape[0])
        idx_h = table_index_1d(s, self.ds, self.sminh, l_tab.shape[0])
        idx_c = table_index_1d(s, self.ds, self.sminf,
                               self.chi_coeffs.shape[0])
        f = s.dtype
        return FrozenRadialVmec(
            base=self, rz_block=gather_rows(rz_tab, idx_f),
            l_block=gather_rows(l_tab, idx_h),
            chi_block=gather_rows(self.chi_coeffs, idx_c), idx_f=idx_f.to(f),
            idx_h=idx_h.to(f), idx_c=idx_c.to(f))

    def characteristic_field(self):
        """|B| at (s, u, v) = 0 (equilibrium.hpp:2198-2205), a 0-dim
        tensor."""
        b = self.magnetic_field(self.rmnc_coeffs.new_zeros(3))
        return torch.sqrt(torch.sum(b * b))

    def to_xyz(self, pos):
        s, u, v = pos[0], pos[1], pos[2]
        r, z, _ = self._rzl(s, u, v)
        return torch.stack([r * torch.cos(v), r * torch.sin(v), z])

    def profile(self, s):
        """(1 - (sqrt(s^2))^1.5)^2 (equilibrium.hpp:2150-2153)."""
        return _profile(s)


def _assemble_geometry(v, r, z, dr, dz, dl, dchi_ds, phip):
    """Covariant/contravariant bases, Jacobian and B from the (R, Z, l)
    jet (equilibrium.hpp:2073-2141), shared by the full and frozen-radial
    paths."""
    cv, sv = torch.cos(v), torch.sin(v)

    def rot(a, b, c):      # rot(v) applied to (a, b, c)
        return (a * cv - b * sv, a * sv + b * cv, c)

    def cross(a, b):
        return (a[1] * b[2] - a[2] * b[1],
                a[2] * b[0] - a[0] * b[2],
                a[0] * b[1] - a[1] * b[0])

    def dot(a, b):
        return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]

    zero = torch.zeros_like(r)
    esub_s = rot(dr[0], zero, dz[0])
    esub_u = rot(dr[1], zero, dz[1])
    esub_v = rot(dr[2], r, dz[2])

    cuv = cross(esub_u, esub_v)
    jac = dot(esub_s, cuv)
    inv_jac = 1.0 / jac

    def scale(vec, f):
        return torch.stack([vec[0] * f, vec[1] * f, vec[2] * f])

    esup_s = scale(cuv, inv_jac)
    esup_u = scale(cross(esub_v, esub_s), inv_jac)
    esup_v = scale(cross(esub_s, esub_u), inv_jac)

    jbsupu = (dchi_ds - phip * dl[2]) * inv_jac
    jbsupv = phip * (1.0 + dl[1]) * inv_jac
    bvec = torch.stack([
        jbsupu * esub_u[0] + jbsupv * esub_v[0],
        jbsupu * esub_u[1] + jbsupv * esub_v[1],
        jbsupu * esub_u[2] + jbsupv * esub_v[2]])
    return dict(r=r, z=z, esup=torch.stack([esup_s, esup_u, esup_v]),
                bvec=bvec, jac=jac)


class _BoundVmec(Equilibrium):
    """Point-bound VMEC view: the basis vectors, B and the Jacobian come
    from ONE geometry evaluation that every accessor shares (the
    reference's set_cache hit path, equilibrium.hpp:2073).  Positions
    passed to the accessors are ignored: they are the binding point by
    contract."""

    def __init__(self, eq, geo):
        self._eq = eq
        self._geo = geo

    @property
    def ion_masses(self):
        return self._eq.ion_masses

    @property
    def ion_charges(self):
        return self._eq.ion_charges

    def is_cartesian(self):
        return False

    def supports_batched(self):
        return True

    def bind_point(self, pos):
        return self

    def esup(self, pos):
        return self._geo["esup"]

    def magnetic_field(self, pos):
        return self._geo["bvec"]

    def plasma_quantities(self, pos) -> PlasmaQuantities:
        n = self.num_ion_species
        return PlasmaQuantities(
            b=self._geo["bvec"], ne=self._eq.electron_density(pos),
            te=self._eq.electron_temperature(pos),
            ni=tuple(self._eq.ion_density(i, pos) for i in range(n)),
            ti=tuple(self._eq.ion_temperature(i, pos) for i in range(n)))

    def electron_density(self, pos):
        return self._eq.electron_density(pos)

    def electron_temperature(self, pos):
        return self._eq.electron_temperature(pos)

    def ion_density(self, index, pos):
        return self._eq.ion_density(index, pos)

    def ion_temperature(self, index, pos):
        return self._eq.ion_temperature(index, pos)


@dataclasses.dataclass(frozen=True)
class FrozenRadialVmec(_VmecView):
    """Radial-cell-frozen VMEC view (see VmecEquilibrium.freeze_cells).

    The geometry evaluates the radial polynomials against the window-base
    blocks with cell-local coordinates that may run slightly past [0, 1)
    (s drifts O(dt v_s) a substep against cells of ds); the trig, the
    mode sums and the analytic profiles stay exact functions of the
    CURRENT (s, u, v).  Plain torch: the kernel K4 is not used here."""
    base: VmecEquilibrium
    rz_block: torch.Tensor     # (..., 4, 2 M) [rmnc | zmns]
    l_block: torch.Tensor      # (..., 4, M)
    chi_block: torch.Tensor    # (..., 4)
    idx_f: torch.Tensor        # frozen cells, as floats
    idx_h: torch.Tensor
    idx_c: torch.Tensor

    def _geometry(self, pos):
        eq = self.base
        s, u, v = pos[0], pos[1], pos[2]
        un_f = ((s - eq.sminf) / eq.ds - self.idx_f).unsqueeze(-1)
        un_h = ((s - eq.sminh) / eq.ds - self.idx_h).unsqueeze(-1)
        rzm, rzm_s = _horner_jet(self.rz_block, un_f, eq.ds)
        lm, lm_s = _horner_jet(self.l_block, un_h, eq.ds)
        ca, sa = _grid_trig(eq.xm_unique, eq.xn_unique, u, v)
        xm, xn = eq.xm_grid.to(ca.dtype), eq.xn_grid.to(ca.dtype)
        m = ca.shape[-1]
        (r, z, _l), (dr, dz, dl) = _mode_sums(
            rzm[..., :m], rzm[..., m:], lm, rzm_s[..., :m], rzm_s[..., m:],
            lm_s, ca, sa, xm, xn)
        un_c = (s - eq.sminf) / eq.ds - self.idx_c
        cb = self.chi_block
        dchi_ds = (cb[..., 1] + un_c * (2.0 * cb[..., 2]
                   + 3.0 * un_c * cb[..., 3])) / eq.ds
        return _assemble_geometry(v, r, z, dr, dz, dl, dchi_ds,
                                  eq.signj * eq.dphi)


def _rzl_and_jac(eq: VmecEquilibrium, s, u, v):
    """(R, Z, l) and their (s, u, v) derivatives in one analytic pass
    (the reference differentiates symbolically, equilibrium.hpp:
    1958-2018):

        dR/ds = sum rm' ca      dR/du = -sum xm rm sa   dR/dv = sum xn rm sa
        dZ/ds = sum zm' sa      dZ/du =  sum xm zm ca   dZ/dv = -sum xn zm ca
        (l identical in shape to Z)

    One radial-block gather per table and one trig evaluation serve the
    values and all nine derivatives.  Returns ((R, Z, l), (dR, dZ, dl))
    with each dX = (d/ds, d/du, d/dv).

    Under ``eq.fused_mode_sums`` (cell-local tables, (rays,) float32
    coordinates, as in the JAX package) the kernel K4 computes the ten
    sums the geometry consumes; ``l`` and dl/ds are returned as zeros
    there.
    """
    if eq.k4_serves(s):
        (r, z, drs, dru, drv, dzs, dzu, dzv, dlu, dlv) = \
            vmec_geom.fused_geometry(eq, s, u, v)
        zero = torch.zeros_like(r)
        return ((r, z, zero),
                ((drs, dru, drv), (dzs, dzu, dzv), (zero, dlu, dlv)))
    # rmnc and zmns share the full radial grid: one concatenated table, one
    # block gather for both
    rz = torch.cat([eq._grid_table(eq.rmnc_coeffs),
                    eq._grid_table(eq.zmns_coeffs)], dim=-1)
    lmt = eq._grid_table(eq.lmns_coeffs)
    ca, sa = _grid_trig(eq.xm_unique, eq.xn_unique, u, v)
    xm, xn = eq.xm_grid.to(ca.dtype), eq.xn_grid.to(ca.dtype)
    m = xm.shape[0]
    rzm, rzm_s = _spline_modes_jet(rz, s, eq.ds, eq.sminf, eq.cell_local)
    lm, lm_s = _spline_modes_jet(lmt, s, eq.ds, eq.sminh, eq.cell_local)
    return _mode_sums(rzm[..., :m], rzm[..., m:], lm, rzm_s[..., :m],
                      rzm_s[..., m:], lm_s, ca, sa, xm, xn)


def _mode_sums(rm, zm, lm, rm_s, zm_s, lm_s, ca, sa, xm, xn):
    """Fourier mode sums for (R, Z, l) and the nine derivatives (the tail
    of :func:`_rzl_and_jac`, shared with the frozen-radial path)."""
    rm_sa = rm * sa
    zm_ca = zm * ca
    lm_ca = lm * ca

    def msum(t):
        return t.sum(-1)

    r = msum(rm * ca)
    z = msum(zm * sa)
    l = msum(lm * sa)
    dr = (msum(rm_s * ca), -msum(xm * rm_sa), msum(xn * rm_sa))
    dz = (msum(zm_s * sa), msum(xm * zm_ca), -msum(xn * zm_ca))
    dl = (msum(lm_s * sa), msum(xm * lm_ca), -msum(xn * lm_ca))
    return (r, z, l), (dr, dz, dl)


def read_vmec_tables(path):
    """Read a VMEC spline file's tables (make_vmec's loader keys,
    equilibrium.hpp:2424-2651) into the dict :func:`vmec_from_tables`
    takes.  Needs ``h5py``."""
    import h5py

    with h5py.File(path, "r") as h:
        def arr(name):
            return np.asarray(h[name][...], dtype=np.float64)

        tables = {key: float(arr(key))
                  for key in ("signj", "dphi", "sminf", "sminh", "ds")}
        tables["xm"], tables["xn"] = arr("xm"), arr("xn")
        for name in ("chi", "rmnc", "zmns", "lmns"):
            tables[name] = np.stack([arr(f"{name}_c{k}") for k in range(4)])
    return tables


def vmec_from_tables(tables, *, dtype=torch.float64, device="cuda",
                     cell_local=True, quirky_chi=False,
                     fused_mode_sums=False):
    """Build a :class:`VmecEquilibrium` from file-format tables: ``chi``
    (4, numsf), ``rmnc``/``zmns`` (4, num_modes, numsf) and ``lmns``
    (4, num_modes, numsh) in the global normalized coordinate, ``xm``,
    ``xn``, and the float scalars signj, dphi, sminf, sminh, ds (see
    :func:`read_vmec_tables`, ``tools.make_splines.vmec_tables``).

    ``cell_local``: rebase the tables to cell-local coordinates in
    extended precision (well-conditioned evaluation; required by
    freeze_cells and by the fused path).
    """
    chi = tables["chi"]
    rmnc, zmns, lmns = tables["rmnc"], tables["zmns"], tables["lmns"]
    if cell_local:
        def rebase_modes(c):
            return np.stack([rebase_cells_1d(c[:, m, :])
                             for m in range(c.shape[1])], axis=1)

        chi = rebase_cells_1d(chi)
        rmnc, zmns, lmns = (rebase_modes(rmnc), rebase_modes(zmns),
                            rebase_modes(lmns))

    def cell_major(c):                   # (4, M, n) -> (n, 4, M)
        return np.ascontiguousarray(np.asarray(c).transpose(2, 0, 1))

    # the mode grid: each mode's slot in the dense (n_xm, n_xn) grid
    xm, xn = np.asarray(tables["xm"]), np.asarray(tables["xn"])
    xm_vals, iu = np.unique(xm, return_inverse=True)
    xn_vals, jv = np.unique(xn, return_inverse=True)

    def tensor(a, kind=dtype):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=kind,
                               device=device)

    return VmecEquilibrium(
        chi_coeffs=tensor(to_cell_major_1d(chi)),
        rmnc_coeffs=tensor(cell_major(rmnc)),
        zmns_coeffs=tensor(cell_major(zmns)),
        lmns_coeffs=tensor(cell_major(lmns)),
        xm=tensor(xm), xn=tensor(xn),
        signj=float(tables["signj"]), dphi=float(tables["dphi"]),
        sminf=float(tables["sminf"]), sminh=float(tables["sminh"]),
        ds=float(tables["ds"]), cell_local=cell_local,
        fused_mode_sums=fused_mode_sums, quirky_chi=quirky_chi,
        grid_scatter=tensor(iu * len(xn_vals) + jv, torch.int64),
        xm_unique=tensor(xm_vals), xn_unique=tensor(xn_vals),
        xm_grid=tensor(np.repeat(xm_vals, len(xn_vals))),
        xn_grid=tensor(np.tile(xn_vals, len(xm_vals))))


def make_vmec(path, *, dtype=torch.float64, device="cuda", cell_local=True,
              quirky_chi=False, fused_mode_sums=False):
    """Load a VMEC spline file (make_vmec, equilibrium.hpp:2424-2651)."""
    return vmec_from_tables(read_vmec_tables(path), dtype=dtype,
                            device=device, cell_local=cell_local,
                            quirky_chi=quirky_chi,
                            fused_mode_sums=fused_mode_sums)
