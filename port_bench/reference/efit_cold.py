"""Plain NumPy reference of the EFIT cold-plasma ray trace, in float64.

The benchmark holds the program to this file.  It imports numpy and scipy
only: nothing of the program, and it reads nothing the program made.  It
fits its own spline tables from the equilibrium's grid samples, solves its
own launch wave number, and steps the rays with its own derivatives of the
dispersion relation, written out by hand below (no autograd).

What it computes is what the upstream code states
(https://github.com/ORNL-Fusion/graph_framework, ``equilibrium.hpp``
efit, ``dispersion.hpp`` cold_plasma, ``solver.hpp`` rk2 / rk4):

* psi(R, Z) a tensor-product natural bicubic spline of the grid samples,
  ne, te, pressure and fpol natural cubic splines of psi, each evaluated in
  cell-local coordinates; ne's c0 and c1 come from te's normalised table
  and the ion density is the te profile (the upstream loader's quirks,
  equilibrium.hpp:1361, :1478);
* B = (psi_z / R, fpol / R, -psi_R / R) in (R, phi, Z), turned into
  cartesian components with cos phi = x / R, sin phi = y / R;
* D the cold-plasma determinant of electrons and one deuterium species;
* the ray equations dx/dt = -D_k / D_w, dk/dt = D_x / D_w;
* frozen cells: each ray's spline blocks are picked once per window of
  ``freeze`` substeps at the window's first state, and every stage of the
  window evaluates those blocks' polynomials (extrapolated where a stage
  leaves the cell);
* Newton on one wave-vector component, until D^2 stops falling.
"""

from __future__ import annotations

import math

import numpy as np
from scipy.interpolate import CubicSpline

# physical constants of the upstream dispersion base (dispersion.hpp:493-501)
EPSILON0 = 8.8541878138e-12
MU0 = math.pi * 4.0e-7
Q = 1.602176634e-19
ME = 9.1093837015e-31
C = 1.0 / math.sqrt(EPSILON0 * MU0)
MI = 3.34449469e-27                   # deuterium, EFIT's one ion species

KE = Q * Q / (EPSILON0 * ME * C * C)  # wpe^2 = KE ne  (normalised to c)
KEC = -Q / (ME * C)                   # electron cyclotron = KEC |B|
KI = Q * Q / (EPSILON0 * MI * C * C)
KIC = Q / (MI * C)

STATE = ("t", "w", "x", "y", "z", "kx", "ky", "kz")


# -- the tables -------------------------------------------------------------
def _local(spline, h):
    """scipy's piecewise coefficients (highest power first, in x - x_i) as
    cell-local ones: [..., p] multiplies t^p, t = (x - x_i) / h."""
    c = spline.c
    return np.stack([c[3 - p] * h ** p for p in range(4)], axis=-1)


def fit_tables(samples):
    """Cell-local spline tables of the grid samples (a dict with ``r``,
    ``z``, ``psi`` (nr, nz), ``psi_profile``, ``ne``, ``te``,
    ``pressure``, ``fpol``): ``psi`` (nr - 1, nz - 1, 4, 4) indexed [i, j,
    power of the R coordinate, power of the Z coordinate] and ``prof``
    (npsi - 1, 4, 4) [cell, (ne, te, pressure, fpol), power], with the
    grid scalars."""
    r, z = np.asarray(samples["r"]), np.asarray(samples["z"])
    psi_grid = np.asarray(samples["psi"], dtype=np.float64)
    dr, dz = r[1] - r[0], z[1] - z[0]
    # splines along Z on every R line, then each Z coefficient along R
    along_z = _local(CubicSpline(z, psi_grid, axis=1, bc_type="natural"), dz)
    # along_z: (nz - 1, nr, 4 [Z power]) -> spline over the nr axis
    along_r = CubicSpline(r, along_z, axis=1, bc_type="natural")
    psi = _local(along_r, dr)            # (nr - 1, nz - 1, 4 [Z], 4 [R])
    psi = np.ascontiguousarray(psi.transpose(0, 1, 3, 2))

    grid = np.asarray(samples["psi_profile"])
    dpsi = grid[1] - grid[0]
    scales, tables = {}, {}
    for name in ("ne", "te", "pressure", "fpol"):
        values = np.asarray(samples[name], dtype=np.float64)
        scale = 1.0 if name == "fpol" else (
            float(np.max(np.abs(values))) or 1.0)
        scales[name] = scale
        tables[name] = _local(CubicSpline(grid, values / scale,
                                          bc_type="natural"), dpsi)
    # the upstream loader fills ne's c0 and c1 from te's table
    tables["ne"] = np.concatenate([tables["te"][:, :2], tables["ne"][:, 2:]],
                                  axis=1)
    prof = np.stack([tables[n] * scales[n]
                     for n in ("ne", "te", "pressure", "fpol")], axis=1)
    return dict(psi=psi, prof=prof, rmin=float(r[0]), dr=float(dr),
                zmin=float(z[0]), dz=float(dz), psimin=float(grid[0]),
                dpsi=float(dpsi))


def bfloat16_tables(tab):
    """``tab`` with its spline coefficients rounded to bfloat16 (to
    nearest, ties to even): the controls' tables, the precision below the
    configuration's float32 tables."""
    def rounded(a):
        u = np.asarray(a, dtype=np.float32).view(np.uint32).astype(np.uint64)
        u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
        return u.astype(np.uint32).view(np.float32).astype(np.float64)

    return {**tab, "psi": rounded(tab["psi"]), "prof": rounded(tab["prof"])}


def _index(u, length):
    """Clamped truncation of the normalised coordinate u."""
    return np.clip(np.nan_to_num(u, nan=0.0), 0.0, length - 1).astype(
        np.int64)


def _horner(c, u):
    """c[0] + u (c[1] + u (c[2] + u c[3])) and its first and second
    derivatives in u, for c a sequence of four arrays (of one shape)."""
    val = c[0] + u * (c[1] + u * (c[2] + u * c[3]))
    d1 = c[1] + u * (2.0 * c[2] + 3.0 * u * c[3])
    d2 = 2.0 * c[2] + 6.0 * u * c[3]
    return val, d1, d2


class Frozen:
    """Each ray's psi and profile blocks, picked at ``pos`` = (x, y, z)."""

    def __init__(self, tab, x, y, z):
        self.tab = tab
        r = np.sqrt(x * x + y * y)
        nr, nz = tab["psi"].shape[:2]
        ur = (r - tab["rmin"]) / tab["dr"]
        vz = (z - tab["zmin"]) / tab["dz"]
        i, j = _index(ur, nr), _index(vz, nz)
        self.iu, self.jv = i.astype(np.float64), j.astype(np.float64)
        # [Z power] -> (R power, n)
        self.psi_block = np.ascontiguousarray(
            tab["psi"][i, j].transpose(2, 1, 0))
        psi = self.psi_jet(r, z)[0]
        up = (psi - tab["psimin"]) / tab["dpsi"]
        p = _index(up, tab["prof"].shape[0])
        self.pidx = p.astype(np.float64)
        # [power] -> (profile, n)
        self.prof_block = np.ascontiguousarray(
            tab["prof"][p].transpose(2, 1, 0))

    def psi_jet(self, r, z):
        """psi and its first and second derivatives in (R, Z)."""
        tab = self.tab
        u = (r - tab["rmin"]) / tab["dr"] - self.iu
        v = (z - tab["zmin"]) / tab["dz"] - self.jv
        # the cubic in v of each power of u, and its derivatives in v:
        # each (4 [R power], n)
        cv, cdv, cddv = _horner(self.psi_block, v)
        hr, hz = tab["dr"], tab["dz"]
        psi, psi_u, psi_uu = _horner(cv, u)
        psi_v, psi_uv, _ = _horner(cdv, u)
        psi_vv = _horner(cddv, u)[0]
        return (psi, psi_u / hr, psi_v / hz, psi_uu / (hr * hr),
                psi_uv / (hr * hz), psi_vv / (hz * hz))

    def profiles(self, psi):
        """(ne, te, pressure, fpol) and their derivatives in psi, each
        (4, n)."""
        tab = self.tab
        up = (psi - tab["psimin"]) / tab["dpsi"] - self.pidx
        vals, dvals, _ = _horner(self.prof_block, up)
        return vals, dvals / tab["dpsi"]


# -- the dispersion relation and its derivatives -----------------------------
def dispersion_partials(fz, w, x, y, z, kx, ky, kz):
    """D and its partial derivatives (D_w, D_x, D_y, D_z, D_kx, D_ky,
    D_kz) of the cold plasma over the frozen view ``fz``.  Arithmetic
    only, so that the same lines run on numpy arrays and on torch tensors
    (``config5.py``)."""
    r = (x * x + y * y) ** 0.5
    c, s = x / r, y / r
    psi, psi_r, psi_z, psi_rr, psi_rz, psi_zz = fz.psi_jet(r, z)
    vals, dvals = fz.profiles(psi)
    ne, te, fpol = vals[0], vals[1], vals[3]
    br, bp, bz = psi_z / r, fpol / r, -psi_r / r
    bx, by = br * c - bp * s, br * s + bp * c
    b2 = bx * bx + by * by + bz * bz
    b = b2 ** 0.5
    wpe2, wpi2 = KE * ne, KI * te              # ni = te (quirk)
    ec, ic = KEC * b, KIC * b
    w2 = w * w
    nx, ny, nz_ = kx / w, ky / w, kz / w
    n2 = nx * nx + ny * ny + nz_ * nz_
    npara = (bx * nx + by * ny + bz * nz_) / b
    np2 = npara * npara

    pe, pi = wpe2 / w2, wpi2 / w2
    de, di = 1.0 - ec * ec / w2, 1.0 - ic * ic / w2
    e11 = 1.0 - pe / de - pi / di
    e12 = -((ec / w) * pe / de + (ic / w) * pi / di)
    e33 = 1.0 - (wpe2 + wpi2) / w2
    nperp2 = n2 - np2
    m11, m22, m33 = e11 - np2, e11 - n2, e33 - nperp2
    m13 = np2 * nperp2
    d = (m11 * m22 - e12 * e12) * m33 - m22 * m13

    # D over (e11, e12, e33, n2, np2)
    g11, g22, g33, g13 = m22 * m33, m11 * m33 - m13, m11 * m22 - e12 * e12, \
        -m22
    g_e11 = g11 + g22
    g_e12 = -2.0 * e12 * m33
    g_e33 = g33
    g_n2 = -g22 - g33 + np2 * g13
    g_np2 = -g11 + g33 + (n2 - 2.0 * np2) * g13

    # e11, e12 = -e12p, e33 over wpe2, wpi2, |B| and w (n held)
    def species(p, dd, cyc, kc):
        """(d(p/dd)/dwp2 w2, d(p/dd)/d|B|, d(p/dd)/dw, and the same of
        (cyc/w) p/dd) of one species."""
        f = p / dd
        f_wp2 = 1.0 / (w2 * dd)
        f_cyc = 2.0 * f * cyc / (w2 * dd)
        f_w = -2.0 * f / w - f / dd * 2.0 * cyc * cyc / (w2 * w)
        h_wp2 = (cyc / w) * f_wp2
        h_cyc = f / w + (cyc / w) * f_cyc
        h_w = -(cyc / (w * w)) * f + (cyc / w) * f_w
        return f_wp2, f_cyc * kc, f_w, h_wp2, h_cyc * kc, h_w

    fe_wp, fe_b, fe_w, he_wp, he_b, he_w = species(pe, de, ec, KEC)
    fi_wp, fi_b, fi_w, hi_wp, hi_b, hi_w = species(pi, di, ic, KIC)
    g_wpe2 = -g_e11 * fe_wp - g_e12 * he_wp - g_e33 / w2
    g_wpi2 = -g_e11 * fi_wp - g_e12 * hi_wp - g_e33 / w2
    g_b = -g_e11 * (fe_b + fi_b) - g_e12 * (he_b + hi_b)
    d_w = (-g_e11 * (fe_w + fi_w) - g_e12 * (he_w + hi_w)
           + g_e33 * 2.0 * (wpe2 + wpi2) / (w2 * w)
           - 2.0 * (g_n2 * n2 + g_np2 * np2) / w)

    # the wave vector: n2 = k.k / w^2, np2 = (bhat.k)^2 / w^2
    bhx, bhy, bhz = bx / b, by / b, bz / b
    kn = 2.0 * g_n2 / w2
    kp = 2.0 * g_np2 * npara / w
    d_kx, d_ky, d_kz = kn * kx + kp * bhx, kn * ky + kp * bhy, \
        kn * kz + kp * bhz

    # B: through |B| and through np2 = (B.n)^2 / |B|^2
    q = 2.0 * g_np2 * npara / b
    g_bx = g_b * bhx + q * (nx - npara * bhx)
    g_by = g_b * bhy + q * (ny - npara * bhy)
    g_bz = g_b * bhz + q * (nz_ - npara * bhz)

    # back to the position
    g_br = g_bx * c + g_by * s
    g_bp = -g_bx * s + g_by * c
    g_c = g_bx * br + g_by * bp
    g_s = -g_bx * bp + g_by * br
    g_psi_z = g_br / r
    g_psi_r = -g_bz / r
    g_fpol = g_bp / r
    g_r = (-(g_br * psi_z + g_bp * fpol - g_bz * psi_r) / (r * r)
           - (g_c * x + g_s * y) / (r * r))
    g_psi = (g_wpe2 * KE * dvals[0] + g_wpi2 * KI * dvals[1]
             + g_fpol * dvals[3])
    g_r = g_r + g_psi * psi_r + g_psi_r * psi_rr + g_psi_z * psi_rz
    d_z = g_psi * psi_z + g_psi_r * psi_rz + g_psi_z * psi_zz
    d_x = g_r * c + g_c / r
    d_y = g_r * s + g_s / r
    return d, (d_w, d_x, d_y, d_z, d_kx, d_ky, d_kz)


def dispersion(tab, state):
    """D at a state (a dict of the eight leaves), cells picked there."""
    fz = Frozen(tab, state["x"], state["y"], state["z"])
    return dispersion_partials(fz, *(state[k] for k in STATE[1:]))[0]


# -- stepping ----------------------------------------------------------------
def _rhs(fz, s):
    _, (dw, dx, dy, dz, dkx, dky, dkz) = dispersion_partials(
        fz, *(s[k] for k in STATE[1:]))
    return (-dkx / dw, -dky / dw, -dkz / dw, dx / dw, dy / dw, dz / dw)


_MOVING = ("x", "y", "z", "kx", "ky", "kz")


def _shift(s, d, f, dt):
    out = dict(s)
    out["t"] = s["t"] + dt
    for k, v in zip(_MOVING, d):
        out[k] = s[k] + f * v
    return out


def substep(fz, s, method, dt):
    """One rk2 (Heun) or rk4 substep against the frozen view."""
    if method == "rk2":
        d1 = _rhs(fz, s)
        d2 = _rhs(fz, _shift(s, d1, dt, dt))
        inc = [dt / 2.0 * (a + b) for a, b in zip(d1, d2)]
    else:
        h = dt / 2.0
        d1 = _rhs(fz, s)
        d2 = _rhs(fz, _shift(s, d1, h, h))
        d3 = _rhs(fz, _shift(s, d2, h, h))
        d4 = _rhs(fz, _shift(s, d3, dt, dt))
        inc = [dt / 6.0 * (a + 2.0 * (b + c) + e)
               for a, b, c, e in zip(d1, d2, d3, d4)]
    return _shift(s, inc, 1.0, dt)


def trace(tab, state, *, steps, sub_steps, freeze, method, dt,
          rows=None):
    """``steps`` recorded steps of ``sub_steps`` substeps, in windows of
    ``freeze``; returns the final state, and with ``rows`` (a list) appends
    every recorded state, the launch first."""
    s = {k: np.array(v, dtype=np.float64) for k, v in state.items()}
    if rows is not None:
        rows.append(dict(s))
    for _ in range(steps):
        for _ in range(sub_steps // freeze):
            fz = Frozen(tab, s["x"], s["y"], s["z"])
            for _ in range(freeze):
                s = substep(fz, s, method, dt)
        if rows is not None:
            rows.append(dict(s))
    return s


def solve_k(tab, state, which="kx", max_iterations=100):
    """Newton on ``which`` until D^2 stops falling on every ray (the cells
    picked afresh at each iterate's position)."""
    s = {k: np.array(v, dtype=np.float64) for k, v in state.items()}
    slot = STATE.index(which) - 1
    last = np.inf
    for _ in range(max_iterations):
        fz = Frozen(tab, s["x"], s["y"], s["z"])
        d, grads = dispersion_partials(fz, *(s[k] for k in STATE[1:]))
        cur = float(np.max(d * d))
        if cur == 0.0 or cur >= last:
            break
        s[which] = s[which] - d / grads[slot]
        last = cur
    return s
