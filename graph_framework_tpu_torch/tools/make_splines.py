"""Build EFIT and VMEC spline-coefficient tables from raw grid samples.

Counterpart of ``graph_framework_tpu.tools.make_splines`` (the pure-numpy
replacement of the reference's Mathematica notebooks,
utilities/BiCubicSplines.nb and VMECSplines.nb): natural cubic splines of
the 1D profiles and per-mode radial Fourier coefficients, and a
tensor-product bicubic of psi(R, Z), stored as per-cell polynomial
coefficients **in the global normalized coordinate** u = (x - offset)/scale
(the format ``build_1D_spline`` evaluates, equilibrium.hpp:1120-1131).

:func:`efit_tables` and :func:`vmec_tables` return the tables as the dicts
that :func:`graph_framework_tpu_torch.models.efit.efit_from_tables` and
:func:`graph_framework_tpu_torch.models.vmec.vmec_from_tables` take, so a
caller can build an equilibrium in memory without a file (and without
``h5py``); :func:`write_efit_file` and :func:`write_vmec_file` write the
same dicts in the reference's file format.

All coefficient algebra runs in ``np.longdouble``: the local->global
monomial rebase is ill-conditioned at large cell indices.
"""

from __future__ import annotations

import math

import numpy as np


def _natural_spline_local(y, axis=0):
    """Natural cubic spline of uniformly-spaced samples, cell-local form.

    ``y``: samples along ``axis`` (n points -> n-1 cells).  Returns an array
    with a new leading axis of size 4: coefficients (c0, c1, c2, c3) of
    c0 + c1 t + c2 t^2 + c3 t^3 with t in [0, 1] the in-cell coordinate.
    Second derivatives solve the standard tridiagonal system with natural
    boundary conditions (M_0 = M_{n-1} = 0).
    """
    y = np.moveaxis(np.asarray(y, dtype=np.longdouble), axis, 0)
    n = y.shape[0]
    if n < 2:
        raise ValueError("need at least 2 samples")
    m = np.zeros_like(y)
    if n > 2:
        # tridiagonal [1, 4, 1] m_inner = 6 * second difference
        rhs = 6.0 * (y[2:] - 2.0 * y[1:-1] + y[:-2])
        k = n - 2
        diag = np.full(k, 4.0, dtype=np.longdouble)
        lower = np.ones(k - 1, dtype=np.longdouble)
        upper = np.ones(k - 1, dtype=np.longdouble)
        # Thomas algorithm (vectorized over trailing dims)
        cp = np.zeros(k, dtype=np.longdouble)
        dp = np.zeros((k,) + y.shape[1:], dtype=np.longdouble)
        cp[0] = upper[0] / diag[0] if k > 1 else 0.0
        dp[0] = rhs[0] / diag[0]
        for i in range(1, k):
            denom = diag[i] - lower[i - 1] * cp[i - 1]
            if i < k - 1:
                cp[i] = upper[i] / denom
            dp[i] = (rhs[i] - lower[i - 1] * dp[i - 1]) / denom
        sol = np.zeros_like(dp)
        sol[-1] = dp[-1]
        for i in range(k - 2, -1, -1):
            sol[i] = dp[i] - cp[i] * sol[i + 1]
        m[1:-1] = sol
    c0 = y[:-1]
    c1 = (y[1:] - y[:-1]) - (2.0 * m[:-1] + m[1:]) / 6.0
    c2 = m[:-1] / 2.0
    c3 = (m[1:] - m[:-1]) / 6.0
    out = np.stack([c0, c1, c2, c3])              # (4, n-1, ...)
    return np.moveaxis(out, 1, axis + 1)


def _local_to_global_1d(coeffs):
    """Rebase (4, ncells, ...) cell-local coefficients to the global
    normalized coordinate u = t + i (the file format; inverse of
    ops.spline.rebase_cells_1d)."""
    c = np.asarray(coeffs, dtype=np.longdouble)
    ncells = c.shape[1]
    cells = np.arange(ncells, dtype=np.longdouble)
    cells = cells.reshape((ncells,) + (1,) * (c.ndim - 2))
    out = np.zeros_like(c)
    # c_k t^k = c_k (u - i)^k = sum_{a<=k} C(k,a) c_k (-i)^(k-a) u^a
    for k in range(4):
        for a in range(k + 1):
            out[a] += math.comb(k, a) * c[k] * (-cells) ** (k - a)
    return out


def cubic_spline_coeffs(y, *, local=False):
    """Natural cubic spline coefficients of 1D uniform-grid samples.

    Returns (4, n-1) float64: tables c0..c3 in the file's global normalized
    coordinate (or cell-local when ``local=True``).
    """
    c = _natural_spline_local(y, axis=0)
    if not local:
        c = _local_to_global_1d(c)
    return c.astype(np.float64)


def bicubic_spline_coeffs(f, *, local=False):
    """Tensor-product bicubic coefficients of 2D uniform-grid samples.

    ``f``: (nr, nz) samples.  Returns (4, 4, nr-1, nz-1) float64 indexed
    [a, b, i, j] with a the power of the normalized r coordinate and b the
    power of the normalized z coordinate - the reference's ``psi_cAB``
    layout (equilibrium.hpp:84-115).
    """
    f = np.asarray(f, dtype=np.longdouble)
    # splines along z for every r grid line: (4, nr, nz-1) local in t_z
    cz = _natural_spline_local(f, axis=1)
    # spline each z-coefficient field along r: (4, 4, nr-1, nz-1),
    # [a (r power), b (z power), i, j] local in t_r
    cr = np.stack([_natural_spline_local(cz[b], axis=0)
                   for b in range(4)], axis=1)
    if not local:
        # _local_to_global_1d expects (power, cells, ...): rebase r with
        # the r-cell axis i second, then z with the z-cell axis j second.
        t = np.moveaxis(cr, 2, 1)                 # (4a, i, 4b, j)
        t = _local_to_global_1d(t)                # rebase over i
        t = np.moveaxis(t, 1, 2)                  # (4a, 4b, i, j)
        t = np.transpose(t, (1, 3, 0, 2))         # (4b, j, 4a, i)
        t = _local_to_global_1d(t)                # rebase over j
        cr = np.transpose(t, (2, 0, 3, 1))        # (4a, 4b, i, j)
    return cr.astype(np.float64)


def _uniform_step(g, name):
    d = np.diff(g)
    if not np.allclose(d, d[0], rtol=1e-10, atol=0.0):
        raise ValueError(f"{name} grid must be uniform")
    return float(d[0])


def efit_tables(*, r, z, psi, psi_profile, ne, te, pressure, fpol):
    """EFIT spline tables of raw uniform-grid samples, in file format.

    ``r``/``z``: uniform 1D grids [m]; ``psi``: (nr, nz) flux samples;
    ``psi_profile``: uniform 1D grid of psi values the profile samples live
    on; ``ne``/``te``/``pressure``/``fpol``: 1D profile samples on that
    grid (SI units; ne/te/pressure are normalized by their max into the
    ``*_scale`` scalars, as the reference's files are).

    Returns a dict: ``psi`` (4, 4, nr-1, nz-1), ``ne``/``te``/``pressure``/
    ``fpol`` (4, npsi-1) global-coordinate tables, and the float scalars
    rmin, dr, zmin, dz, psimin, dpsi, ne_scale, te_scale, pres_scale.
    """
    r = np.asarray(r, dtype=np.float64)
    z = np.asarray(z, dtype=np.float64)
    psi_profile = np.asarray(psi_profile, dtype=np.float64)
    tables = dict(
        rmin=float(r[0]), dr=_uniform_step(r, "r"),
        zmin=float(z[0]), dz=_uniform_step(z, "z"),
        psimin=float(psi_profile[0]),
        dpsi=_uniform_step(psi_profile, "psi_profile"),
        psi=bicubic_spline_coeffs(psi))
    # scale keys: ne_scale/te_scale/pres_scale; fpol unscaled
    for name, scale_key, samples in (
            ("ne", "ne_scale", ne), ("te", "te_scale", te),
            ("pressure", "pres_scale", pressure), ("fpol", None, fpol)):
        samples = np.asarray(samples, dtype=np.float64)
        scale = 1.0
        if scale_key is not None:
            scale = float(np.max(np.abs(samples))) or 1.0
            tables[scale_key] = scale
        tables[name] = cubic_spline_coeffs(samples / scale)
    return tables


def vmec_tables(*, s_full, s_half, chi, rmnc, zmns, lmns, xm, xn, signj,
                dphi):
    """VMEC spline tables of raw uniform-grid samples, in file format.

    ``s_full``/``s_half``: uniform radial grids (full and half mesh, one
    step ds); ``chi``: poloidal-flux samples on the full grid;
    ``rmnc``/``zmns``: (num_modes, ns_full) Fourier-coefficient samples on
    the full grid; ``lmns``: (num_modes, ns_half) on the half grid;
    ``xm``/``xn``: mode numbers; ``signj``: Jacobian sign; ``dphi``:
    toroidal-flux derivative.  Each mode gets a natural cubic spline in s.

    Returns a dict: ``chi`` (4, ns_full-1), ``rmnc``/``zmns``
    (4, num_modes, ns_full-1) and ``lmns`` (4, num_modes, ns_half-1)
    global-coordinate tables, ``xm``/``xn``, and the float scalars signj,
    dphi, sminf, sminh, ds.
    """
    s_full = np.asarray(s_full, dtype=np.float64)
    s_half = np.asarray(s_half, dtype=np.float64)
    ds = _uniform_step(s_full, "s_full")
    if not np.isclose(ds, _uniform_step(s_half, "s_half"), rtol=1e-10):
        raise ValueError("full and half mesh must share the step ds")

    def mode_tables(samples):
        # (num_modes, ns) -> (4, num_modes, ns-1): one spline in s per mode
        c = cubic_spline_coeffs(np.asarray(samples, dtype=np.float64).T)
        return np.moveaxis(c, 2, 1)

    return dict(
        signj=float(signj), dphi=float(dphi), sminf=float(s_full[0]),
        sminh=float(s_half[0]), ds=ds,
        xm=np.asarray(xm, dtype=np.float64),
        xn=np.asarray(xn, dtype=np.float64),
        chi=cubic_spline_coeffs(np.asarray(chi, dtype=np.float64)),
        rmnc=mode_tables(rmnc), zmns=mode_tables(zmns),
        lmns=mode_tables(lmns))


def write_vmec_file(path, **samples):
    """Write :func:`vmec_tables` of ``samples`` as a VMEC spline file in
    the reference's format (make_vmec loader keys,
    equilibrium.hpp:2424-2651), which both packages' ``make_vmec`` read.
    Needs ``h5py``."""
    import h5py

    tables = vmec_tables(**samples)
    with h5py.File(path, "w") as h:
        for key in ("signj", "dphi", "sminf", "sminh", "ds"):
            h.create_dataset(key, data=np.float64(tables[key]))
        h.create_dataset("xm", data=tables["xm"])
        h.create_dataset("xn", data=tables["xn"])
        for name in ("chi", "rmnc", "zmns", "lmns"):
            for k in range(4):
                h.create_dataset(f"{name}_c{k}", data=tables[name][k])
    return path


def write_efit_file(path, **samples):
    """Write :func:`efit_tables` of ``samples`` as an EFIT spline file in
    the reference's format (loader keys: equilibrium.hpp:1627-1844), which
    both packages' ``make_efit`` read.  Needs ``h5py``."""
    import h5py

    tables = efit_tables(**samples)
    with h5py.File(path, "w") as h:
        for key in ("rmin", "dr", "zmin", "dz", "psimin", "dpsi",
                    "ne_scale", "te_scale", "pres_scale"):
            h.create_dataset(key, data=np.float64(tables[key]))
        for a in range(4):
            for b in range(4):
                h.create_dataset(f"psi_c{a}{b}", data=tables["psi"][a, b])
        for name in ("ne", "te", "pressure", "fpol"):
            for k in range(4):
                h.create_dataset(f"{name}_c{k}", data=tables[name][k])
    return path
