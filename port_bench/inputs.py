"""The cells' inputs, made from a configuration's numbers and the seed.

A frozen copy of the port's smoke-run generator (``chip_smoke.py``:
``synthetic_samples``, ``launch``), so that the benchmark's inputs cannot
move with the program.  The card's machine has no ``efit.nc``: the
equilibrium is a smooth up-down symmetric tokamak flux map sampled on the
EFIT grid, with tanh-pedestal profiles, which both the program and the
reference fit their own splines to.  Everything here is numpy float64 on
the host; each side converts what it takes.
"""

from __future__ import annotations

import numpy as np

Q = 1.602176634e-19


def efit_samples(m):
    """Grid samples of the synthetic EFIT map of the configuration's
    ``equilibrium`` numbers ``m``: psi on an (n, n) R-Z grid, and ne, te,
    pressure and fpol on n psi knots (the keyword arguments of the
    program's ``tools.make_splines.efit_tables``)."""
    n = m["grid"]
    r = np.linspace(*m["r_range"], n)
    z = np.linspace(*m["z_range"], n)
    a, kappa, psi0 = m["a_minor"], m["kappa"], m["psi0"]
    psi = psi0 * ((r[:, None] - m["r0"]) ** 2 / a ** 2
                  + z[None, :] ** 2 / (kappa * a) ** 2)
    psi_profile = np.linspace(0.0, 1.02 * psi.max(), n)
    s = psi_profile / psi0                       # 1 at the plasma edge
    shape = 0.005 + 0.995 * 0.5 * (1.0 - np.tanh((s - 0.8) / 0.12))
    ne, te = m["ne0"] * shape, m["te0"] * shape
    return dict(r=r, z=z, psi=psi, psi_profile=psi_profile, ne=ne, te=te,
                pressure=2.0 * Q * ne * te,
                fpol=np.full_like(psi_profile, m["r0"] * m["b0"]))


def launch(rays, p, seed):
    """The launch of ``rays`` rays as float64 arrays, the eight leaves of a
    ray state: w fixed, x and ky normal around the configuration's
    ``launch`` numbers ``p``, y = z = 0, kx the Newton guess, kz fixed.
    The same seed gives the same rays; every seed gives as many."""
    rng = np.random.default_rng(seed)
    x = p["x"] + p["x_spread"] * rng.standard_normal(rays)
    ky = p["ky"] + p["ky_spread"] * rng.standard_normal(rays)
    full = np.ones(rays)
    return dict(t=0.0 * full, w=p["w"] * full, x=x, y=0.0 * full,
                z=0.0 * full, kx=p["kx"] * full, ky=ky, kz=p["kz"] * full)


def sample(rays, count, seed):
    """The sorted indices of ``count`` rays drawn from the seed, the rays
    the check compares."""
    rng = np.random.default_rng([seed, 1])
    return np.sort(rng.choice(rays, size=min(count, rays), replace=False))
