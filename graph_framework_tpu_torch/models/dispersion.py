"""Dispersion relations D(omega, k, x, t).

Counterpart of ``graph_framework_tpu.models.dispersion`` (reference:
dispersion.hpp:227-1305).  Each dispersion is a batched torch function

    D(w, kvec, pos, t, eq) -> residual

with ``kvec`` the physical wave vector and ``pos`` the coordinates, both
(3, ...) with the component axis leading.  Frequencies are normalized to
the speed of light (w' = w/c in 1/m; see constants.py).

Only ``cold_plasma`` - the main path's dispersion - is ported so far.  The
CUDA window kernel (csrc/efit_window.cu, ``cold_plasma_D``) evaluates the
same algebra on forward-mode dual numbers; keep the two in step.
"""

from __future__ import annotations

from graph_framework_tpu_torch.constants import (
    Q, ME, plasma_frequency_squared, cyclotron_frequency)


def _vdot(a, b):
    """Dot product over the leading component axis."""
    return (a * b).sum(dim=0)


def _norm(v):
    return _vdot(v, v).sqrt()


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


#: The dispersions ported so far, by the JAX package's names.
DISPERSIONS = {
    "cold_plasma": cold_plasma,
}
