"""Special functions: Faddeeva w(z), complex erf, erfi, Dawson, plasma Z.

Counterpart of ``graph_framework_tpu.ops.special`` (reference:
special_functions.hpp:40-1590), on torch's native complex dtypes.  Three
regionally exact evaluations are selected with ``torch.where``:

* ``|z| >= 6``  - the Laplace continued fraction of w(z), 12 levels;
* ``|z| <  6``  - Weideman's (1994, SIAM J. Numer. Anal. 31) rational
  series with N = 64 terms, its coefficients from an FFT of the scaled
  Gaussian in numpy float64, computed once;
* ``|z| < 0.2`` - the Maclaurin series of erf, where erf(z) = 1 -
  exp(-z^2) w(iz) cancels (the reference's ``taylor`` branches,
  special_functions.hpp:1472-1485).

Lower half-plane values use w(z) = 2 exp(-z^2) - w(-z), which keeps the
function holomorphic under autograd.  ``torch.where`` passes a NaN
gradient of the branch it does not select, so each branch's argument is
guarded as in the JAX package; where the JAX package builds a complex
number from parts (``lax.complex``) this module calls ``torch.complex``,
which has no 0 * inf cross terms.

Only the complex path is here: CUDA tensors have complex dtypes, so the
JAX package's split (re, im) forms for backends without them
(``dawson_real``, ``z_plasma_real``) have no counterpart.

Autograd of a holomorphic f in torch returns conj(f'(z)) for the
cotangent 1; callers that need f'(z) conjugate it (``holomorphic_grad``).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

_SQRT_PI = math.sqrt(math.pi)
_ISPI = 1.0 / _SQRT_PI
_N_TERMS = 64
_LEVELS = 12


@functools.lru_cache(maxsize=None)
def _weideman_coeffs(n_terms: int):
    """(L, a) of Weideman's rational approximation of w, in float64
    (J.A.C. Weideman, "Computation of the complex error function", SIAM
    J. Numer. Anal. 31 (1994) 1497-1518: an FFT of f(theta) = exp(-t^2)
    (L^2 + t^2) with t = L tan(theta/2))."""
    m = 2 * n_terms
    k = np.arange(-m + 1, m)
    ell = math.sqrt(n_terms / math.sqrt(2.0))
    t = ell * np.tan(k * np.pi / m / 2.0)
    f = np.concatenate([[0.0], np.exp(-t * t) * (ell * ell + t * t)])
    a = np.real(np.fft.fft(np.fft.fftshift(f))) / (2 * m)
    return ell, a[1:n_terms + 1][::-1]


@functools.lru_cache(maxsize=None)
def _weideman_table(real_dtype: torch.dtype):
    """The coefficients rounded to ``real_dtype``, as Python floats (one
    list per dtype, shared by every device)."""
    ell, a = _weideman_coeffs(_N_TERMS)
    rounded = torch.as_tensor(a.copy(), dtype=real_dtype).double()
    return ell, rounded.tolist()


def _as_complex(z):
    """``z`` as a complex tensor (a real one promoted to the complex dtype
    of its precision; float32 and below to complex64)."""
    z = torch.as_tensor(z)
    if z.is_complex():
        return z
    if z.dtype != torch.float64:
        z = z.to(torch.float32)
    return torch.complex(z, torch.zeros_like(z))


def _w_weideman(z):
    """Weideman's rational w(z) for Im(z) >= 0, |z| small."""
    ell, a = _weideman_table(z.real.dtype)
    iz = 1j * z
    recip = 1.0 / (ell - iz)
    bigz = (ell + iz) * recip
    poly = torch.zeros_like(z)
    for coeff in a:
        poly = poly * bigz + coeff
    return recip * recip * 2.0 * poly + _ISPI * recip


def _w_contfrac(z):
    """Laplace continued fraction of w(z) for Im(z) >= 0, |z| large:
    w(z) = (i/sqrt(pi)) / (z - (1/2)/(z - 1/(z - (3/2)/(z - ...))))."""
    r = torch.zeros_like(z)
    for n in range(_LEVELS, 0, -1):
        r = (0.5 * n) / (z - r)
    return (1j * _ISPI) / (z - r)


def wofz_upper(z):
    """Faddeeva w(z) = exp(-z^2) erfc(-iz) for Im(z) >= 0 (unchecked)."""
    big = (z.real * z.real + z.imag * z.imag) >= 36.0
    # each branch sees a guarded argument, so the one not selected makes
    # no inf/NaN that torch.where would pass on to the gradient
    z_big = torch.where(big, z, torch.full_like(z, 8.0))
    z_small = torch.where(big, torch.zeros_like(z), z)
    return torch.where(big, _w_contfrac(z_big), _w_weideman(z_small))


def _exp_parts(mre, mim):
    """exp(mre + i mim) from its parts (no complex exp overflow NaN; the
    reference avoids complex exp too, special_functions.hpp:1544-1547)."""
    return torch.exp(mre) * torch.complex(torch.cos(mim), torch.sin(mim))


def wofz(z):
    """Faddeeva function w(z) on the whole complex plane; the lower
    half-plane by w(z) = 2 exp(-z^2) - w(-z)."""
    z = _as_complex(z)
    upper = z.imag >= 0.0
    wu = wofz_upper(torch.where(upper, z, -z))
    mre = (z.imag - z.real) * (z.imag + z.real)
    mim = -2.0 * z.real * z.imag
    mre = torch.where(upper, torch.zeros_like(mre), mre)   # lower only
    return torch.where(upper, wu, 2.0 * _exp_parts(mre, mim) - wu)


_ERF_SERIES = (1.0, -1.0 / 3.0, 1.0 / 10.0, -1.0 / 42.0, 1.0 / 216.0,
               -1.0 / 1320.0, 1.0 / 9360.0)


def _erf_series(z):
    """Maclaurin series of erf(z), accurate to ~1e-16 for |z| <= 0.2:
    erf(z) = 2/sqrt(pi) z sum_k (-1)^k z^(2k) / (k! (2k+1))."""
    z2 = z * z
    s = torch.zeros_like(z)
    for c in reversed(_ERF_SERIES):
        s = s * z2 + c
    return (2.0 * _ISPI) * z * s


def erf_complex(z):
    """erf(z) for complex z (``special::erf_complex``,
    special_functions.hpp:1498-1568): 1 - exp(-z^2) w(iz) for Re(z) >= 0,
    extended by oddness, with the axis guards and the series near 0."""
    z = _as_complex(z)
    sigma = torch.where(z.real >= 0.0, 1.0, -1.0).to(z.real.dtype)
    zt = sigma * z
    x, y = zt.real, zt.imag
    mre = (y - x) * (x + y)          # Re(-z^2), as the reference has it
    mim = -2.0 * x * y               # Im(-z^2)
    w_iz = wofz_upper(1j * zt)       # Im(i zt) = Re(zt) >= 0
    main = 1.0 - _exp_parts(mre, mim) * w_iz
    # underflow: erf -> 1 (special_functions.hpp:1528-1531)
    main = torch.where(mre < -750.0, torch.ones_like(main), main)
    # x == 0: erf(iy) = i exp(y^2) Im(w(y)), +-inf past y^2 ~ 709
    # (special_functions.hpp:1503-1513)
    y2 = y * y
    exp_y2 = torch.exp(torch.clamp(y2, max=700.0))
    w_im_y = wofz_upper(torch.complex(y, torch.zeros_like(y))).imag
    imag_axis = torch.where(y2 > 700.0, torch.sign(y) * math.inf,
                            exp_y2 * w_im_y)
    main = torch.where(x == 0.0,
                       torch.complex(torch.zeros_like(imag_axis), imag_axis),
                       main)
    # y == 0: the real erf (special_functions.hpp:1503-1505)
    main = torch.where(y == 0.0, torch.special.erf(x).to(main.dtype), main)
    small = (x * x + y * y) < 0.04
    series = _erf_series(torch.where(small, zt, torch.zeros_like(zt)))
    out = torch.where(small, series, main)
    # undo the flip by parts: sigma * out as a complex product would turn
    # (0, inf) into NaN
    return torch.complex(sigma * out.real, sigma * out.imag)


def erfi(z):
    """erfi(z) = -i erf(iz) (special_functions.hpp:1571-1587); a real
    argument gives the real erfi."""
    z = torch.as_tensor(z)
    if z.is_complex():
        temp = erf_complex(1j * z)
        return torch.complex(temp.imag, -temp.real)
    return erf_complex(1j * _as_complex(z)).imag


def dawson(x):
    """Dawson integral D(x) = sqrt(pi)/2 Im(w(x)) for real x."""
    return 0.5 * _SQRT_PI * wofz(x).imag


def erfcx(x):
    """Scaled complementary error function exp(x^2) erfc(x) for real x
    (``special::erfcx``, special_functions.hpp:1036-1055): Re(w(ix)) for
    x >= 0, 2 exp(x^2) - erfcx(-x) below."""
    x = torch.as_tensor(x)
    ax = x.abs()
    pos = wofz_upper(torch.complex(torch.zeros_like(ax), ax)).real
    return torch.where(x >= 0.0, pos, 2.0 * torch.exp(x * x) - pos)


def z_plasma(zeta):
    """Plasma dispersion function Z(zeta) = i sqrt(pi) w(zeta): the
    reference's ``z_erfi`` form (dispersion.hpp:288-302) analytically,
    without its exp(-zeta^2) exp(+zeta^2) round trip."""
    return 1j * _SQRT_PI * wofz(zeta)


def z_power_series(zeta):
    """Large-argument Z (dispersion.hpp:261-280):
    i sqrt(pi) exp(-z^2) - 2 z (1 - 2/3 z^2 + 4/15 z^4 - 8/105 z^6)."""
    z2 = zeta * zeta
    z4 = z2 * z2
    z6 = z4 * z2
    return (1j * _SQRT_PI) * torch.exp(-z2) - 2.0 * (
        1.0 - 2.0 / 3.0 * z2 + 4.0 / 15.0 * z4 - 8.0 / 105.0 * z6) * zeta


def z_erfi(zeta):
    """Z in the reference's erfi form (dispersion.hpp:288-302)."""
    return -_SQRT_PI * torch.exp(-zeta * zeta) * (erfi(zeta) - 1j)


def holomorphic_grad(out, inputs, *, create_graph=False, allow_unused=False):
    """d out / d input for each of ``inputs``, of an ``out`` that is
    elementwise and holomorphic in them: ``torch.autograd.grad`` with the
    cotangent 1 gives conj(f'(z)) for complex tensors, so complex
    gradients are conjugated back (real ones pass as they are)."""
    grads = torch.autograd.grad(out, inputs,
                                grad_outputs=torch.ones_like(out),
                                create_graph=create_graph,
                                allow_unused=allow_unused)
    return tuple(None if g is None
                 else (torch.conj_physical(g) if g.is_complex() else g)
                 for g in grads)
