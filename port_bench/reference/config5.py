"""Plain PyTorch reference of config 5, the absorbed power of an EFIT ray
batch and its gradient with respect to the psi spline table and the
launch kz, in float64.

The loss is the upstream code's power binning (xrays.cpp:673-793) made
differentiable, as the JAX package's benchmark states it: cold-plasma rays
traced by frozen-cell rk4 from their solved launch with every kz set to
kz0; after each recorded step the weak damping's Im(kamp) at the new state
(``absorption.py``'s formula, Z(zeta) of a real zeta being -2 F(zeta) + i
sqrt(pi) exp(-zeta^2) with F scipy's Dawson function), 0 where not finite,
times the step's path length, added to each ray's k_sum; the loss is
sum(1 - exp(-2 |k_sum|)).  The ray equations take :mod:`efit_cold`'s
hand-written derivatives of D (its same lines, on tensors), so one reverse
pass of torch's autograd gives the gradient; each recorded step is
checkpointed.  Tables: :func:`efit_cold.fit_tables` of the grid samples,
on the device.  Imports torch, numpy, scipy and :mod:`efit_cold` only.
"""

from __future__ import annotations

import math

import numpy as np
import scipy.special
import torch
import torch.utils.checkpoint

from port_bench.reference import efit_cold as ec


class _Dawson(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        out = scipy.special.dawsn(x.detach().cpu().numpy())
        return torch.from_numpy(out).to(x)

    @staticmethod
    def backward(ctx, grad):
        (x,) = ctx.saved_tensors
        return grad * (1.0 - 2.0 * x * _Dawson.apply(x))


class _View(ec.Frozen):
    """:class:`efit_cold.Frozen` over torch tables: the blocks of the cells
    at (x, y, z), gathered differentiably from the psi table."""

    def __init__(self, tab, x, y, z):
        self.tab = tab
        r = (x * x + y * y) ** 0.5
        psi_t, prof_t = tab["psi"], tab["prof"]
        nr, nz = psi_t.shape[:2]

        def index(u, length):
            u = torch.nan_to_num(u.detach(), nan=0.0)
            return torch.clamp(u, 0.0, length - 1).long()

        i = index((r - tab["rmin"]) / tab["dr"], nr)
        j = index((z - tab["zmin"]) / tab["dz"], nz)
        self.iu, self.jv = i.double(), j.double()
        self.psi_block = psi_t[i, j].permute(2, 1, 0)
        psi = self.psi_jet(r, z)[0]
        p = index((psi - tab["psimin"]) / tab["dpsi"], prof_t.shape[0])
        self.pidx = p.double()
        self.prof_block = prof_t[p].permute(2, 1, 0)


def device_tables(tab, device):
    """:func:`efit_cold.fit_tables`'s tables as float64 tensors."""
    return {k: (torch.as_tensor(v, dtype=torch.float64, device=device)
                if isinstance(v, np.ndarray) else v) for k, v in tab.items()}


def kamp_imag(tab, s):
    """Im(kamp) of the weak damping at the ray states ``s`` (cells at each
    point), 0 where not finite."""
    view = _View(tab, s["x"], s["y"], s["z"])
    x, y, z, w = s["x"], s["y"], s["z"], s["w"]
    r = (x * x + y * y) ** 0.5
    psi, psi_r, psi_z = view.psi_jet(r, z)[:3]
    vals = view.profiles(psi)[0]
    br, bp, bz = psi_z / r, vals[3] / r, -psi_r / r
    c, sn = x / r, y / r
    bx, by = br * c - bp * sn, br * sn + bp * c
    blen = (bx * bx + by * by + bz * bz) ** 0.5
    kx, ky, kz = s["kx"], s["ky"], s["kz"]
    klen = (kx * kx + ky * ky + kz * kz) ** 0.5
    ec_ = ec.Q / (ec.ME * ec.C) * blen
    P = ec.KE * vals[0] / (w * w)
    q = P / (2.0 * (1.0 + ec_ / w))
    n2 = (kx * kx + ky * ky + kz * kz) / (w * w)
    npara = (bx * kx + by * ky + bz * kz) / (blen * w)
    npara2 = npara * npara
    nperp2 = n2 - npara2
    q_func, n_func, p_func = 1.0 - 2.0 * q, n2 + npara2, 1.0 - P

    a = -P / 2.0 * (1.0 + ec_ / w)
    bc = 1.0 - ec_ * ec_ / (w * w)
    g1_n2 = ((1.0 - q) * (nperp2 + n2) + p_func * (npara2 - (1.0 - q))
             - q_func)
    g1_np2 = -(1.0 - q) * n2 + p_func * (n2 - (1.0 - q)) + q_func
    g0_n2 = (n2 - 2.0 * q_func) + nperp2 - p_func
    g0_np2 = -(n2 - 2.0 * q_func) - p_func
    bk = (bx * kx + by * ky + bz * kz) / (blen * klen)
    slope = ((a * g0_n2 + bc * g1_n2) * 2.0 * klen / (w * w)
             + (a * g0_np2 + bc * g1_np2) * 2.0 * npara * bk / w)

    vt = (2.0 * ec.Q * vals[1] / ec.ME) ** 0.5 / ec.C
    zeta = (1.0 - ec_ / w) / (npara * vt)
    re_z = -2.0 * _Dawson.apply(zeta)
    im_z = math.sqrt(math.pi) * torch.exp(-zeta * zeta)
    gamma5 = P * (n2 * npara2 - (1.0 - q) * n_func + q_func)
    gamma2 = (P * w / ec_ * nperp2 * (n2 - q_func)
              + P * P * w * w / (4.0 * ec_ * ec_)
              * (n_func - 2.0 * q_func) * nperp2 / npara2)
    gamma1 = ((1.0 - q) * n2 * nperp2
              + p_func * (n2 * npara2 - (1.0 - q) * n_func)
              + q_func * (p_func - nperp2))
    c0 = (-(1.0 + ec_ / w) * npara * vt
          * (gamma1 + gamma2 + nperp2 / (2.0 * npara) * (w * w / (ec_ * ec_))
             * vt * zeta * gamma5))
    # Dw = c0 (1/Z + zeta): Im(kamp) = -Im(Dw) / slope
    kim = c0 * im_z / ((re_z * re_z + im_z * im_z) * slope)
    return torch.nan_to_num(kim, nan=0.0, posinf=0.0, neginf=0.0)


def _recorded_step(tab, sub, dt, *leaves):
    """``sub`` rk4 substeps in one freeze window from ``leaves``."""
    s = dict(zip(ec.STATE, leaves))
    view = _View(tab, s["x"], s["y"], s["z"])
    for _ in range(sub):
        s = ec.substep(view, s, "rk4", dt)
    return tuple(s[k] for k in ec.STATE)


def absorbed_power(tab, root, kz0, steps, sub):
    """The loss of the rays ``root`` (a dict of float64 tensors) with
    every kz set to ``kz0`` (a 0-dim tensor)."""
    dt = 1.0 / (steps * sub)
    s = dict(root)
    s["kz"] = torch.zeros_like(s["x"]) + kz0
    k_sum = torch.zeros_like(s["x"])
    leaves = tuple(s[k] for k in ec.STATE)
    for _ in range(steps):
        nxt = torch.utils.checkpoint.checkpoint(
            lambda *a: _recorded_step(tab, sub, dt, *a), *leaves,
            use_reentrant=False)
        new = dict(zip(ec.STATE, nxt))
        dl = ((new["x"] - s["x"]) ** 2 + (new["y"] - s["y"]) ** 2
              + (new["z"] - s["z"]) ** 2) ** 0.5
        k_sum = k_sum + kamp_imag(tab, new) * dl
        s, leaves = new, nxt
    return (1.0 - torch.exp(-2.0 * torch.abs(k_sum))).sum()


def value_and_grad(tab_np, launch, kz0, steps, sub, device):
    """(loss, dL/dpsi, dL/dkz0) of the launch rays (float64 numpy arrays,
    kx Newton-solved here with the launch's own kz) over the tables
    ``tab_np``, as float64 numpy."""
    root = ec.solve_k(tab_np, launch)
    tab = device_tables(tab_np, device)
    psi = tab["psi"].clone().requires_grad_(True)
    tab["psi"] = psi
    kz = torch.tensor(float(kz0), dtype=torch.float64, device=device,
                      requires_grad=True)
    state = {k: torch.as_tensor(v, dtype=torch.float64, device=device)
             for k, v in root.items()}
    loss = absorbed_power(tab, state, kz, steps, sub)
    g_psi, g_kz = torch.autograd.grad(loss, [psi, kz])
    return (float(loss.detach()), g_psi.detach().cpu().numpy(), float(g_kz))
