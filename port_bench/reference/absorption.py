"""Plain NumPy reference of the xrays pipeline's phases 2 and 3, in
complex128 and float64: the weak-damping amplitude kamp of each recorded
ray state and the absorbed power binned along each ray.

What it computes is the upstream code's (absorption.hpp:328-432,
dispersion.hpp:1017-1092 and :1208-1299, xrays.cpp:673-793):

    kamp = |k| - Dw / (khat . dDc/dk)

with Dc the electron cold-plasma expansion (its k-gradient written out by
hand below) and Dw the weakly damped hot-plasma expansion, whose plasma
dispersion function Z(zeta) = i sqrt(pi) w(zeta) takes scipy's Faddeeva
function; a kamp that is not finite counts 0 (the upstream SAFE_MATH
stores).  Then along each ray dl_j = |pos_j - pos_(j-1)|, and power_j =
exp(-2 sum_(i<j) Im(kamp_i) dl_i) with power_0 = power_1 = 1.  The plasma
quantities come from :mod:`efit_cold`'s tables, evaluated at each point's
own cell.  It imports numpy, scipy and that module only.
"""

from __future__ import annotations

import math

import numpy as np
from scipy.special import wofz

from port_bench.reference.efit_cold import C, KE, ME, Q, Frozen

KEC_POS = Q / (ME * C)               # the expansions' ec = +q |B| / (m c)


def _plasma(tab, x, y, z):
    """|B|, its unit vector, ne and te at the points (x, y, z)."""
    fz = Frozen(tab, x, y, z)
    r = np.sqrt(x * x + y * y)
    psi, psi_r, psi_z = fz.psi_jet(r, z)[:3]
    vals = fz.profiles(psi)[0]
    br, bp, bz = psi_z / r, vals[3] / r, -psi_r / r
    c, s = x / r, y / r
    b = np.stack([br * c - bp * s, br * s + bp * c, bz])
    blen = np.sqrt((b * b).sum(axis=0))
    return blen, b / blen, vals[0], vals[1]


def weak_damping(tab, t, w, x, y, z, kx, ky, kz):
    """kamp at each (real) ray state, complex128, 0 where not finite."""
    blen, bhat, ne, te = _plasma(tab, x, y, z)
    k = np.stack([kx, ky, kz])
    klen = np.sqrt((k * k).sum(axis=0))
    ec = KEC_POS * blen
    P = KE * ne / (w * w)
    q = P / (2.0 * (1.0 + ec / w))
    n = k / w
    n2 = (n * n).sum(axis=0)
    npara = (n * bhat).sum(axis=0)
    npara2 = npara * npara
    nperp2 = n2 - npara2
    q_func, n_func, p_func = 1.0 - 2.0 * q, n2 + npara2, 1.0 - P

    # dDc/dk through n2 and npara2, projected on khat
    a = -P / 2.0 * (1.0 + ec / w)
    bc = 1.0 - ec * ec / (w * w)
    g1_n2 = ((1.0 - q) * (nperp2 + n2) + p_func * (npara2 - (1.0 - q))
             - q_func)
    g1_np2 = -(1.0 - q) * n2 + p_func * (n2 - (1.0 - q)) + q_func
    g0_n2 = (n2 - 2.0 * q_func) + nperp2 - p_func
    g0_np2 = -(n2 - 2.0 * q_func) - p_func
    dc_n2 = a * g0_n2 + bc * g1_n2
    dc_np2 = a * g0_np2 + bc * g1_np2
    bk = (bhat * k).sum(axis=0) / klen
    slope = dc_n2 * 2.0 * klen / (w * w) + dc_np2 * 2.0 * npara * bk / w

    # Dw, the hot-plasma expansion
    vt = np.sqrt(2.0 * Q * te / ME) / C
    zeta = (1.0 - ec / w) / (npara * vt)
    zf = 1j * math.sqrt(math.pi) * wofz(zeta.astype(np.complex128))
    n2nperp2 = n2 * nperp2
    gamma5 = P * (n2 * npara2 - (1.0 - q) * n_func + q_func)
    gamma2 = (P * w / ec * nperp2 * (n2 - q_func)
              + P * P * w * w / (4.0 * ec * ec)
              * (n_func - 2.0 * q_func) * nperp2 / npara2)
    gamma1 = ((1.0 - q) * n2nperp2
              + p_func * (n2 * npara2 - (1.0 - q) * n_func)
              + q_func * (p_func - nperp2))
    dw = (-(1.0 + ec / w) * npara * vt
          * (gamma1 + gamma2 + nperp2 / (2.0 * npara) * (w * w / (ec * ec))
             * vt * zeta * gamma5)
          * (1.0 / zf + zeta))
    with np.errstate(all="ignore"):
        kamp = klen - dw / slope
    return np.where(np.isfinite(kamp), kamp, 0.0)


def bin_power(x, y, z, kamp_imag):
    """power (rows, rays) along each ray's recorded positions."""
    pos = np.stack([x, y, z], axis=-1)
    dl = np.sqrt((np.diff(pos, axis=0) ** 2).sum(axis=-1))
    kdl = kamp_imag[1:] * dl
    before = np.concatenate([np.zeros_like(kdl[:1]),
                             np.cumsum(kdl, axis=0)[:-1]])
    return np.concatenate([np.ones_like(kdl[:1]), np.exp(-2.0 * before)])
