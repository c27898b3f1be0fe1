"""Dispersion relations D(omega, k, x, t).

Counterpart of ``graph_framework_tpu.models.dispersion`` (reference:
dispersion.hpp:227-1305).  Each dispersion is a batched torch function

    D(w, kvec, pos, t, eq) -> residual

with ``kvec`` the physical wave vector and ``pos`` the coordinates, both
(3, ...) with the component axis leading.  Frequencies are normalized to
the speed of light (w' = w/c in 1/m; see constants.py).

The whole zoo of the JAX package is here, under its names in
:data:`DISPERSIONS`, with the reference's quirks (``ion_cyclotron``'s
first-power wce; the B = 0 branches of ``bohm_gross`` and
``acoustic_wave``).  Scalar factors are folded in Python float64 before
they meet a tensor, as in the JAX package.  The two hot plasmas
(:func:`make_hot_plasma`, :func:`make_hot_plasma_expansion`) are complex
only: they take complex tensors and the plasma dispersion function of
``ops.special``; every dispersion here is holomorphic in its complex
arguments, so the ray equations and Newton solves of a complex state
differentiate them as such (``ops.special.holomorphic_grad``).

The EFIT window kernels (csrc/efit_adjoint.cuh) take D's gradient by a
reverse sweep written by hand for ``cold_plasma``, ``ordinary_wave`` and
``extra_ordinary_wave`` (their dispersion tails ``ColdPlasma``,
``OrdinaryWave`` and ``ExtraOrdinaryWave``), in the operation order of the
functions here; keep the two in step.
"""

from __future__ import annotations

from typing import Callable

import torch

from graph_framework_tpu_torch.constants import (
    C, Q, ME, plasma_frequency_squared, cyclotron_frequency)
from graph_framework_tpu_torch.ops.special import z_plasma

_C2 = C * C


def _vdot(a, b):
    """Dot product over the leading component axis."""
    return (a * b).sum(dim=0)


def _norm(v):
    return _vdot(v, v).sqrt()


def _bhat(b):
    """Unit vector of b (the callers use it with non-zero B only)."""
    return b / _norm(b)


def _kpar2(b, kvec):
    """k_par^2 along B, or |k|^2 where B = 0 (bohm_gross, acoustic_wave)."""
    b2 = _vdot(b, b)
    return torch.where(b2 == 0.0, _vdot(kvec, kvec),
                       _vdot(b, kvec) ** 2 / torch.where(b2 == 0.0, 1.0, b2))


def stiff(w, kvec, pos, t, eq):
    """Stiff test system (dispersion.hpp:399-443):
    D = (1e3 (x - e^-t) - e^-t) kx + w."""
    e = torch.exp(-torch.as_tensor(t, dtype=pos.dtype, device=pos.device))
    return (1.0e3 * (pos[0] - e) - e) * kvec[0] + w


def simple(w, kvec, pos, t, eq):
    """Vacuum wave (dispersion.hpp:450-505): D = |k|^2 c^2/w^2 - 1 with
    c = 1 in normalized units."""
    return _vdot(kvec, kvec) / (w * w) - 1.0


def bohm_gross(w, kvec, pos, t, eq):
    """Warm electron plasma wave (dispersion.hpp:511-567):
    D = wpe^2 + 3/2 k_par^2 vth^2 - w^2, with k parallel to B when a field
    is present, vth^2 = 2 q te / (me c^2)."""
    pq = eq.plasma_quantities(pos)
    wpe2 = plasma_frequency_squared(pq.ne, Q, ME)
    vterm2 = pq.te * (2.0 * Q / (ME * _C2))
    return wpe2 + 1.5 * _kpar2(pq.b, kvec) * vterm2 - w * w


def light_wave(w, kvec, pos, t, eq):
    """Electromagnetic wave in unmagnetized plasma (dispersion.hpp:574-619):
    D = wpe^2 + |k|^2 - w^2."""
    wpe2 = plasma_frequency_squared(eq.plasma_quantities(pos).ne, Q, ME)
    return wpe2 + _vdot(kvec, kvec) - w * w


def _sound_speed2(pq, eq):
    """vs^2 = (q te + 3 q ti) / (mi c^2) of the first ion species."""
    mi = eq.ion_masses[0]
    return pq.te * (Q / (mi * _C2)) + pq.ti[0] * (3.0 * Q / (mi * _C2))


def acoustic_wave(w, kvec, pos, t, eq):
    """Ion acoustic wave (dispersion.hpp:626-676):
    D = k_par^2 vs^2 - w^2, vs^2 = (q te + 3 q ti)/(mi c^2)."""
    pq = eq.plasma_quantities(pos)
    return _kpar2(pq.b, kvec) * _sound_speed2(pq, eq) - w * w


def gaussian_well(w, kvec, pos, t, eq):
    """Gaussian refractive well (dispersion.hpp:683-714):
    D = |n|^2 - (1 - 0.5 exp(-(x^2+y^2)/0.1))."""
    well = 1.0 - 0.5 * torch.exp(-(pos[0] * pos[0] + pos[1] * pos[1])
                                 / 0.1)
    return _vdot(kvec, kvec) / (w * w) - well


def ion_cyclotron(w, kvec, pos, t, eq):
    """Electrostatic ion-cyclotron wave (dispersion.hpp:722-776):
    D = wce - kperp^2 vs^2 - w^2 (as written in the reference, including
    the first-power wce term)."""
    pq = eq.plasma_quantities(pos)
    vs2 = _sound_speed2(pq, eq)
    b = pq.b
    wce = cyclotron_frequency(-Q, _norm(b), ME)
    kperp2 = _vdot(kvec, kvec) - _vdot(_bhat(b), kvec) ** 2
    return wce - kperp2 * vs2 - w * w


def ordinary_wave(w, kvec, pos, t, eq):
    """O mode (dispersion.hpp:784-829): D = 1 - wpe^2/w^2 - nperp^2."""
    pq = eq.plasma_quantities(pos)
    wpe2 = plasma_frequency_squared(pq.ne, Q, ME)
    n = kvec / w
    nperp2 = _vdot(n, n) - _vdot(_bhat(pq.b), n) ** 2
    return 1.0 - wpe2 / (w * w) - nperp2


def extra_ordinary_wave(w, kvec, pos, t, eq):
    """X mode (dispersion.hpp:837-895):
    D = 1 - wpe^2/w^2 (w^2 - wpe^2)/(w^2 - wh^2) - nperp^2 with
    wh^2 = wpe^2 + wce^2."""
    pq = eq.plasma_quantities(pos)
    wpe2 = plasma_frequency_squared(pq.ne, Q, ME)
    b = pq.b
    wce = cyclotron_frequency(-Q, _norm(b), ME)
    n = kvec / w
    nperp2 = _vdot(n, n) - _vdot(_bhat(b), n) ** 2
    wh2 = wpe2 + wce * wce
    w2 = w * w
    return 1.0 - wpe2 / w2 * (w2 - wpe2) / (w2 - wh2) - nperp2


def cold_plasma(w, kvec, pos, t, eq):
    """Multi-species cold-plasma determinant (dispersion.hpp:903-1009):
    D = det(eps + n n - n.n I) written out with Onsager symmetry; electrons
    plus every ion species contribute to eps11/eps12/eps33."""
    pq = eq.plasma_quantities(pos)
    wpe2 = plasma_frequency_squared(pq.ne, Q, ME)
    b = pq.b
    b_len = _norm(b)
    ec = cyclotron_frequency(-Q, b_len, ME)

    w2 = w * w
    denome = 1.0 - ec * ec / w2
    e11 = 1.0 - (wpe2 / w2) / denome
    e12 = ((ec / w) * (wpe2 / w2)) / denome
    e33 = wpe2

    for i in range(eq.num_ion_species):
        mi = eq.ion_masses[i]
        charge = float(eq.ion_charges[i]) * Q
        wpi2 = plasma_frequency_squared(pq.ni[i], charge, mi)
        ic = cyclotron_frequency(charge, b_len, mi)
        denomi = 1.0 - ic * ic / w2
        e11 = e11 - (wpi2 / w2) / denomi
        e12 = e12 + ((ic / w) * (wpi2 / w2)) / denomi
        e33 = e33 + wpi2

    e12 = -e12
    e33 = 1.0 - e33 / w2

    n = kvec / w
    bhat = b / b_len
    n2 = _vdot(n, n)
    npara = _vdot(bhat, n)
    npara2 = npara * npara
    # |n x bhat|^2 = |n|^2 - (n.bhat)^2: m13 enters the determinant only
    # squared, so the reference's nperp = sqrt(...) is never evaluated.
    nperp2 = n2 - npara2

    m11 = e11 - npara2
    m12 = e12
    m13_sq = npara2 * nperp2
    m22 = e11 - n2
    m33 = e33 - nperp2
    return (m11 * m22 - m12 * m12) * m33 - m22 * m13_sq


def cold_plasma_expansion(w, kvec, pos, t, eq):
    """Electron cold-plasma expansion Dc (dispersion.hpp:1017-1092):
    Dc = -P/2 (1 + ec/w) Gamma0 + (1 - ec^2/w^2) Gamma1."""
    pq = eq.plasma_quantities(pos)
    b = pq.b
    b_len = _norm(b)
    bhat = b / b_len

    ec = cyclotron_frequency(Q, b_len, ME)
    wpe2 = plasma_frequency_squared(pq.ne, Q, ME)

    P = wpe2 / (w * w)
    q = P / (2.0 * (1.0 + ec / w))

    n = kvec / w
    n2 = _vdot(n, n)
    npara = _vdot(n, bhat)
    npara2 = npara * npara
    nperp2 = n2 - npara2
    n2nperp2 = n2 * nperp2

    q_func = 1.0 - 2.0 * q
    n_func = n2 + npara2
    p_func = 1.0 - P

    gamma1 = ((1.0 - q) * n2nperp2
              + p_func * (n2 * npara2 - (1.0 - q) * n_func)
              + q_func * (p_func - nperp2))
    gamma0 = (nperp2 * (n2 - 2.0 * q_func)
              + p_func * (2.0 * q_func - n_func))

    return (-P / 2.0 * (1.0 + ec / w) * gamma0
            + (1.0 - ec * ec / (w * w)) * gamma1)


def make_hot_plasma(z_function: Callable = z_plasma):
    """Hot electron plasma with Landau damping (dispersion.hpp:1099-1199):
    D = i sigma Gamma0 + Gamma1 + nperp^2 P w/ec (1 + zeta Z)(Gamma2 +
    Gamma5 F).  Complex only; ``z_function`` evaluates Z (``z_plasma`` is
    the reference's z_erfi analytically)."""

    def hot_plasma(w, kvec, pos, t, eq):
        pq = eq.plasma_quantities(pos)
        b = pq.b
        b_len = _norm(b)
        bhat = b / b_len
        ne, te = pq.ne, pq.te

        ve = torch.sqrt(2.0 * Q * te / ME) / C
        ec = cyclotron_frequency(Q, b_len, ME)
        wpe2 = plasma_frequency_squared(ne, Q, ME)

        P = wpe2 / (w * w)
        q = P / (2.0 * (1.0 + ec / w))

        n = kvec / w
        n2 = _vdot(n, n)
        npara = _vdot(n, bhat)
        npara2 = npara * npara
        nperp2 = n2 - npara2

        zeta = (1.0 - ec / w) / (npara * ve)
        Zf = z_function(zeta)
        zeta_func = 1.0 + zeta * Zf
        F = ve * zeta * w / (2.0 * npara * ec)
        isigma = P * Zf / (2.0 * npara * ve)

        q_func = 1.0 - 2.0 * q
        n_func = n2 + npara2
        p_func = 1.0 - P

        gamma5 = n2 * npara2 - (1.0 - q) * n_func + q_func
        gamma2 = ((n2 - q_func)
                  + P * w / (4.0 * ec * npara2) * (n_func - 2.0 * q_func))
        gamma1 = (nperp2 * ((1.0 - q) * n2 - q_func)
                  + p_func * (n2 * npara2 - (1.0 - q) * n_func + q_func))
        gamma0 = (nperp2 * (n2 - 2.0 * q_func)
                  + p_func * (2.0 * q_func - n_func))

        return (isigma * gamma0 + gamma1
                + nperp2 * P * w / ec * zeta_func * (gamma2 + gamma5 * F))

    return hot_plasma


def make_hot_plasma_expansion(z_function: Callable = z_plasma):
    """Weakly damped hot-plasma expansion Dw (dispersion.hpp:1208-1299):
    Dw = -(1 + ec/w) npara vt (Gamma1 + Gamma2 + nperp^2/(2 npara)
    (w^2/ec^2) vt zeta Gamma5)(1/Z + zeta).  Complex only."""

    def hot_plasma_expansion(w, kvec, pos, t, eq):
        pq = eq.plasma_quantities(pos)
        b = pq.b
        b_len = _norm(b)
        bhat = b / b_len
        ne, te = pq.ne, pq.te

        ve = torch.sqrt(2.0 * Q * te / ME)
        ec = cyclotron_frequency(Q, b_len, ME)
        wpe2 = plasma_frequency_squared(ne, Q, ME)

        P = wpe2 / (w * w)
        q = P / (2.0 * (1.0 + ec / w))

        n = kvec / w
        n2 = _vdot(n, n)
        npara = _vdot(bhat, n)
        npara2 = npara * npara
        nperp2 = n2 - npara2

        vtnorm = ve / C
        zeta = (1.0 - ec / w) / (npara * vtnorm)
        Zf = z_function(zeta)

        q_func = 1.0 - 2.0 * q
        n_func = n2 + npara2
        n2nperp2 = n2 * nperp2
        p_func = 1.0 - P

        gamma5 = P * (n2 * npara2 - (1.0 - q) * n_func + q_func)
        gamma2 = (P * w / ec * nperp2 * (n2 - q_func)
                  + P * P * w * w / (4.0 * ec * ec)
                  * (n_func - 2.0 * q_func) * nperp2 / npara2)
        gamma1 = ((1.0 - q) * n2nperp2
                  + p_func * (n2 * npara2 - (1.0 - q) * n_func)
                  + q_func * (p_func - nperp2))

        return (-(1.0 + ec / w) * npara * vtnorm
                * (gamma1 + gamma2
                   + nperp2 / (2.0 * npara) * (w * w / (ec * ec))
                   * vtnorm * zeta * gamma5)
                * (1.0 / Zf + zeta))

    return hot_plasma_expansion


#: The dispersions by the JAX package's names (the CLI's --dispersion,
#: xrays.cpp:955-1037).
DISPERSIONS = {
    "simple": simple,
    "stiff": stiff,
    "bohm_gross": bohm_gross,
    "light_wave": light_wave,
    "acoustic_wave": acoustic_wave,
    "gaussian_well": gaussian_well,
    "ion_cyclotron": ion_cyclotron,
    "ordinary_wave": ordinary_wave,
    "extra_ordinary_wave": extra_ordinary_wave,
    "cold_plasma": cold_plasma,
    "cold_plasma_expansion": cold_plasma_expansion,
    "hot_plasma": make_hot_plasma(),
    "hot_plasma_expansion": make_hot_plasma_expansion(),
}
