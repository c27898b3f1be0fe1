"""The VMEC cells' inputs, made from a configuration's numbers and the seed.

A frozen copy of the port's smoke-run generator for its stellarator
(``chip_smoke.py``: ``synthetic_vmec_samples``, ``vmec_mode_numbers``,
``vmec_launch_arrays``), with the constants it takes moved into the
configuration's ``equilibrium`` and ``launch`` numbers, so that the
benchmark's inputs cannot move with the program.  No machine here has the
reference's ``vmec.nc``: the equilibrium is a W7-X-like stellarator with
that file's shapes (86 modes, 199 full-grid knots on s in [-1, 1] and the
half grid at ds / 2), sampled on the grids, which both the program and the
reference fit their own splines to.  Everything here is numpy float64 on
the host; each side converts what it takes.
"""

from __future__ import annotations

import numpy as np


def mode_numbers(m):
    """The reference file's modes in VMEC's order: m = 0 with n = 0..n_max,
    then m = 1..m_max with n = -n_max..n_max; xn = nfp n.  (xm, xn) as
    float64 arrays: 86 modes for m_max 9, n_max 4."""
    m_max, n_max = m["m_max"], m["n_max"]
    pairs = [(0, n) for n in range(n_max + 1)] + [
        (j, n) for j in range(1, m_max + 1) for n in range(-n_max, n_max + 1)]
    xm, n = np.array(pairs, dtype=np.float64).T
    return xm, m["nfp"] * n


def vmec_samples(m):
    """Grid samples of the synthetic stellarator of the configuration's
    ``equilibrium`` numbers ``m`` (the keyword arguments of the program's
    ``tools.make_splines.vmec_tables``): ``knots`` full-grid knots on s in
    [-1, 1], the half grid shifted by ds / 2, rmnc, zmns and lmns of every
    mode on them, chi on the full grid, signj and dphi.

    The minor radius rho = a sqrt((s + hollow) / (1 + hollow)) (s = -1 is
    a surface, not a singular axis); R00 the major radius, elongation
    ``kappa``, a rotating ellipse (m, n) = (1, 1) and a helical axis
    excursion (0, 1); every other mode carries shape decay^(m + |n|)
    (rho / a)^m, and lambda ``lambda`` times the same."""
    s_full = np.linspace(-1.0, 1.0, m["knots"])
    ds = s_full[1] - s_full[0]
    s_half = s_full[:-1] + 0.5 * ds
    xm, xn = mode_numbers(m)
    a = m["a"]

    def coefficients(s):
        """(rmnc, zmns, lmns) of every mode at the radii ``s``."""
        rho = a * np.sqrt((s + m["hollow"]) / (1.0 + m["hollow"]))
        x = rho / a
        rmnc = np.zeros((xm.size, s.size))
        zmns = np.zeros((xm.size, s.size))
        lmns = np.zeros((xm.size, s.size))
        for k, (j, n) in enumerate(zip(xm, xn / m["nfp"])):
            decay = m["decay"] ** (j + abs(n)) * x ** j
            sign = (-1.0) ** (j + n)
            rmnc[k] = m["shape"] * sign * decay
            zmns[k] = -m["shape"] * decay
            lmns[k] = m["lambda"] * sign * decay
            if (j, n) == (0, 0):
                rmnc[k], zmns[k], lmns[k] = m["r00"], 0.0, 0.0
                continue
            if (j, n) == (1, 0):
                rmnc[k], zmns[k] = rho, m["kappa"] * rho
            elif (j, n) == (1, 1):
                rmnc[k], zmns[k] = m["ellipse"] * rho, -m["ellipse"] * rho
            elif (j, n) == (0, 1):
                rmnc[k], zmns[k] = m["axis"], -m["axis"]
        return rmnc, zmns, lmns

    rmnc, zmns, _ = coefficients(s_full)
    _, _, lmns = coefficients(s_half)
    # toroidal flux phi = signj dphi s gives B_phi = b0 (the Jacobian of
    # the circular part is rho rho' R = R a^2 / (2 (1 + hollow)));
    # chi' = iota phi' with the rotational transform iota(s) = iota0 +
    # iota1 s
    dphi = m["b0"] * a ** 2 / (2.0 * (1.0 + m["hollow"]))
    iota0, iota1 = m["iota"]
    chi = -dphi * (iota0 * s_full + 0.5 * iota1 * s_full ** 2)
    return dict(s_full=s_full, s_half=s_half, chi=chi, rmnc=rmnc,
                zmns=zmns, lmns=lmns, xm=xm, xn=xn, signj=m["signj"],
                dphi=dphi)


def launch(rays, p, seed):
    """The launch of ``rays`` rays as float64 arrays, the eight leaves of a
    ray state in flux coordinates (x, y, z = s, u, v): w fixed, s and u
    normal around the configuration's ``launch`` numbers ``p``, v fixed,
    kx (the covariant s component) the Newton guess, ky = kz fixed.  The
    same seed gives the same rays; every seed gives as many."""
    rng = np.random.default_rng(seed)
    full = np.ones(rays)
    return dict(t=0.0 * full, w=p["w"] * full,
                x=p["s"] + p["s_spread"] * rng.standard_normal(rays),
                y=p["u"] + p["u_spread"] * rng.standard_normal(rays),
                z=p["v"] * full, kx=p["kx"] * full, ky=p["ky"] * full,
                kz=p["kz"] * full)
