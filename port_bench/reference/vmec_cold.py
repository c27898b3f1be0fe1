"""Plain PyTorch reference of the VMEC cold-plasma ray trace, in float64.

The benchmark holds the program's VMEC cell to this file.  It runs on the
host's CPU in float64 with TF32 off, and imports torch and the physical
constants of :mod:`efit_cold` only: nothing of the program, and it reads
nothing the program made.  It fits its own radial splines to the
equilibrium's grid samples, solves its own launch wave number and steps
the rays with derivatives that torch's autograd takes of the formulas
below.

What it computes is what the upstream code states
(https://github.com/ORNL-Fusion/graph_framework, ``equilibrium.hpp``
class ``equilibrium::vmec``, :1867-2651; ``dispersion.hpp`` cold_plasma;
``solver.hpp`` rk2):

* every mode's rmnc, zmns (full grid) and lmns (half grid) a natural cubic
  spline of s, and chi(s) one on the full grid, each evaluated in its
  clamped cell's local coordinate;
* R, Z and lambda the direct sums over the modes of c_m(s) cos or sin(xm
  u - xn v), one angle a mode (no mode grid, no rotations);
* the covariant basis e_i = d(R cos v, R sin v, Z) / d(s, u, v) by
  autograd, the Jacobian J = e_s . (e_u x e_v), the contravariant basis
  e^s = (e_u x e_v) / J and its cyclic kin, and B = ((chi' - phi'
  lambda_v) e_u + phi' (1 + lambda_u) e_v) / J with phi' = signj dphi
  (:2030-2140);
* the analytic profiles ne = ni = 1e19 (1 - |s|^1.5)^2, one deuterium
  species (:2150-2172, :2206);
* D the cold-plasma determinant of electrons and deuterium, written out;
* the ray equations dx/dt = -D_k / D_w, dk/dt = D_x / D_w in (s, u, v)
  with covariant k, from one autograd pass over D;
* Newton on kx until D^2 stops falling; Heun's rk2.

Departures from upstream, each the program's too:

* the canonical form of the ray equations: D is evaluated at kvec = sum_i
  k_i e^i of the point itself, and its x-derivatives are total ones,
  through the basis too.  Upstream's literal equations
  (dispersion.hpp:1392-1433) take kvec at a separate copy of the position,
  which the x-derivatives do not see; the program gives them under
  ``reference_correction=True``, which this cell does not run;
* chi is evaluated at the physical s.  Upstream evaluates it at the
  normalised radial coordinate (``get_chi(s_norm_f)``, :2131), which
  normalises the argument twice; the program reproduces that under
  ``quirky_chi=True``, which this cell does not run.
"""

from __future__ import annotations

import torch

from port_bench.reference.efit_cold import KE, KEC, KI, KIC, STATE

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

DTYPE = torch.float64


# -- the tables -------------------------------------------------------------
def natural_spline(y):
    """Cell-local coefficients (..., n - 1, 4) of the natural cubic spline
    through the samples ``y`` (..., n) on uniform knots: [..., i, p]
    multiplies t^p, t the coordinate in cell i from 0 to 1."""
    n = y.shape[-1]
    # second derivatives in t at the inner knots: [1, 4, 1] m = 6 y''
    system = (4.0 * torch.eye(n - 2, dtype=y.dtype)
              + torch.diag(torch.ones(n - 3, dtype=y.dtype), 1)
              + torch.diag(torch.ones(n - 3, dtype=y.dtype), -1))
    rhs = 6.0 * (y[..., 2:] - 2.0 * y[..., 1:-1] + y[..., :-2])
    inner = torch.linalg.solve(system, rhs.unsqueeze(-1)).squeeze(-1)
    zero = torch.zeros_like(y[..., :1])
    m = torch.cat([zero, inner, zero], dim=-1)
    c0 = y[..., :-1]
    c1 = (y[..., 1:] - y[..., :-1]) - (2.0 * m[..., :-1] + m[..., 1:]) / 6.0
    c2 = m[..., :-1] / 2.0
    c3 = (m[..., 1:] - m[..., :-1]) / 6.0
    return torch.stack([c0, c1, c2, c3], dim=-1)


def fit_tables(samples):
    """Spline tables of the equilibrium's grid samples (the dict of
    ``inputs_vmec.vmec_samples``): ``rmnc``, ``zmns`` (n_full - 1, 4, M)
    and ``lmns`` (n_half - 1, 4, M) cell-major, ``chi`` (n_full - 1, 4),
    the grids' first knots, the step, the mode numbers and phi'."""
    def tensor(a):
        return torch.as_tensor(a, dtype=DTYPE)

    s_full, s_half = tensor(samples["s_full"]), tensor(samples["s_half"])

    def modes(values):                    # (M, n) -> (n - 1, 4, M)
        return natural_spline(tensor(values)).permute(1, 2, 0).contiguous()

    return dict(rmnc=modes(samples["rmnc"]), zmns=modes(samples["zmns"]),
                lmns=modes(samples["lmns"]),
                chi=natural_spline(tensor(samples["chi"])),
                sminf=float(s_full[0]), sminh=float(s_half[0]),
                ds=float(s_full[1] - s_full[0]),
                xm=tensor(samples["xm"]), xn=tensor(samples["xn"]),
                phip=float(samples["signj"]) * float(samples["dphi"]))


def spline(table, s, smin, ds):
    """The splines of ``table`` (cells, 4[, M]) at s (n,), in the clamped
    cell of each point: (n[, M]), differentiable in s (the cell index is
    not)."""
    x = (s - smin) / ds
    cell = torch.clamp(x.detach(), 0.0, table.shape[0] - 1).long()
    t = x - cell.to(x.dtype)
    block = table[cell]                    # (n, 4[, M])
    if block.ndim == 3:
        t = t.unsqueeze(-1)
    c = block.unbind(1)
    return c[0] + t * (c[1] + t * (c[2] + t * c[3]))


# -- the geometry -----------------------------------------------------------
def _cross(a, b):
    return torch.stack([a[1] * b[2] - a[2] * b[1],
                        a[2] * b[0] - a[0] * b[2],
                        a[0] * b[1] - a[1] * b[0]])


def _dot(a, b):
    return (a * b).sum(0)


def _partials(f, coords):
    """d f / d (s, u, v) per ray, themselves differentiable."""
    return torch.autograd.grad(f.sum(), coords, create_graph=True)


def geometry(tab, s, u, v):
    """The contravariant basis (3 [s, u, v], 3 [x, y, z], n), B (3, n) and
    the Jacobian (n,) at (s, u, v), each (n,) and differentiable in
    them."""
    angle = u.unsqueeze(-1) * tab["xm"] - v.unsqueeze(-1) * tab["xn"]
    cos, sin = torch.cos(angle), torch.sin(angle)
    r = (spline(tab["rmnc"], s, tab["sminf"], tab["ds"]) * cos).sum(-1)
    z = (spline(tab["zmns"], s, tab["sminf"], tab["ds"]) * sin).sum(-1)
    lam = (spline(tab["lmns"], s, tab["sminh"], tab["ds"]) * sin).sum(-1)
    chi = spline(tab["chi"], s, tab["sminf"], tab["ds"])
    coords = (s, u, v)
    # the covariant basis: rows e_s, e_u, e_v of d(x, y, z)/d(s, u, v)
    jac = torch.stack([torch.stack(_partials(c, coords)) for c in (
        r * torch.cos(v), r * torch.sin(v), z)], dim=1)
    e_s, e_u, e_v = jac[0], jac[1], jac[2]
    _, lam_u, lam_v = _partials(lam, coords)
    (chi_s,) = torch.autograd.grad(chi.sum(), s, create_graph=True)
    cuv = _cross(e_u, e_v)
    j = _dot(e_s, cuv)
    esup = torch.stack([cuv, _cross(e_v, e_s), _cross(e_s, e_u)]) / j
    phip = tab["phip"]
    b = ((chi_s - phip * lam_v) * e_u + phip * (1.0 + lam_u) * e_v) / j
    return esup, b, j


def fields(tab, s, u, v):
    """e^s (3, n), B (3, n) and the Jacobian (n,) at the points (s, u, v)
    (float64 arrays), as float64 arrays keyed as the job keys them."""
    with torch.enable_grad():
        coords = [torch.as_tensor(a, dtype=DTYPE).detach().clone()
                  .requires_grad_(True) for a in (s, u, v)]
        esup, b, j = geometry(tab, *coords)
    return {"esup_s": esup[0].detach().numpy(), "b": b.detach().numpy(),
            "jac": j.detach().numpy()}


def density(s):
    """ne = ni, 1e19 (1 - |s|^1.5)^2 in m^-3."""
    return 1.0e19 * (1.0 - torch.sqrt(s * s) ** 1.5) ** 2


def cold_plasma(w, kvec, b, ne):
    """The cold-plasma determinant of electrons and one deuterium species
    (ni = ne), kvec and b (3, n)."""
    bl = torch.sqrt(_dot(b, b))
    wpe2, wpi2 = KE * ne, KI * ne
    ec, ic = KEC * bl, KIC * bl
    w2 = w * w
    pe, pi = wpe2 / w2, wpi2 / w2
    de, di = 1.0 - ec * ec / w2, 1.0 - ic * ic / w2
    e11 = 1.0 - pe / de - pi / di
    e12 = -((ec / w) * pe / de + (ic / w) * pi / di)
    e33 = 1.0 - (wpe2 + wpi2) / w2
    n = kvec / w
    n2 = _dot(n, n)
    npara = _dot(b, n) / bl
    np2 = npara * npara
    nperp2 = n2 - np2
    m11, m22, m33 = e11 - np2, e11 - n2, e33 - nperp2
    return (m11 * m22 - e12 * e12) * m33 - m22 * np2 * nperp2


def dispersion(tab, w, s, u, v, ks, ku, kv):
    """D at the rays, kvec = ks e^s + ku e^u + kv e^v of the same point."""
    esup, b, _ = geometry(tab, s, u, v)
    kvec = ks * esup[0] + ku * esup[1] + kv * esup[2]
    return cold_plasma(w, kvec, b, density(s))


def _leaves(state):
    """The seven differentiated leaves (w, s, u, v, ks, ku, kv), fresh."""
    return [torch.as_tensor(state[k], dtype=DTYPE).detach().clone()
            .requires_grad_(True) for k in STATE[1:]]


def partials(tab, state):
    """D and its seven partial derivatives at ``state`` (dict of the
    eight leaves)."""
    with torch.enable_grad():
        leaves = _leaves(state)
        d = dispersion(tab, *leaves)
        grads = torch.autograd.grad(d.sum(), leaves)
    return d.detach(), grads


def rhs(tab, state):
    """(ds, du, dv, dks, dku, dkv) / dt: -D_k / D_w, D_x / D_w."""
    _, (dw, ds_, du, dv, dks, dku, dkv) = partials(tab, state)
    return (-dks / dw, -dku / dw, -dkv / dw, ds_ / dw, du / dw, dv / dw)


# -- Newton and stepping ------------------------------------------------------
_MOVING = ("x", "y", "z", "kx", "ky", "kz")


def _shift(state, d, f, dt):
    out = dict(state)
    out["t"] = state["t"] + dt
    for k, a in zip(_MOVING, d):
        out[k] = state[k] + f * a
    return out


def _tensors(state):
    return {k: torch.as_tensor(state[k], dtype=DTYPE) for k in STATE}


def _arrays(state):
    return {k: state[k].detach().numpy() for k in STATE}


def solve_k(tab, state, max_iterations=100):
    """Newton on kx until D^2 stops falling on every ray; the launch
    (float64 arrays) with kx replaced by the root."""
    s = _tensors(state)
    last = float("inf")
    for _ in range(max_iterations):
        d, grads = partials(tab, s)
        cur = float((d * d).max())
        if cur == 0.0 or cur >= last:
            break
        s["kx"] = s["kx"] - d / grads[4]
        last = cur
    return _arrays(s)


def trace(tab, state, *, steps, sub_steps, dt):
    """``steps`` recorded steps of ``sub_steps`` Heun substeps from
    ``state`` (float64 arrays); the final state as float64 arrays."""
    s = _tensors(state)
    for _ in range(steps * sub_steps):
        d1 = rhs(tab, s)
        d2 = rhs(tab, _shift(s, d1, dt, dt))
        s = _shift(s, [0.5 * dt * (a + b) for a, b in zip(d1, d2)], 1.0, dt)
    return _arrays(s)
