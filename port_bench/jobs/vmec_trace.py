"""The job ``vmec_trace``: a VMEC ray ensemble traced in flux coordinates
by ``Solver.run`` from its solved launch, back to back.

Set-up builds the synthetic stellarator's splines (``inputs_vmec``) and the
launch from the seed, builds the equilibrium with the configuration's
``fused_mode_sums`` (the geometry jet by K4), solves kx with ``init_k`` and
runs one unit (which loads the kernel library and warms the caching
allocator).  A unit is one whole trace of ``steps`` recorded steps x
``sub_steps`` substeps of the eager ray RHS (``models/rays.make_ray_rhs``),
timed from the call to the synchronize after it.  The check compares the
last unit's final state on a sample of rays drawn from the seed, and its
displacement from the launch root, with the PyTorch reference
(``reference/vmec_cold.py``) traced in float64 from its own tables and its
own root, and counts the rays, of all, that went non-finite or left 0 < s
< 1.  It also holds the timed equilibrium's geometry (K4 on the card) at
the sampled rays' final (s, u, v) to the reference's at the same points:
B, e^s and the Jacobian, which the trace alone barely sees (the launch's k
lies along e^s, so n_par is 0 and the O-mode root's D_k / D_w and D_x /
D_w hardly depend on B).  The control is the program with its mode
tables rounded to bfloat16, the precision below the configuration's
float32 tables.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from port_bench import inputs, inputs_vmec
from port_bench.harness import span, sync
from port_bench.jobs.trace import state_gap
from port_bench.reference import vmec_cold


class Job:
    SPANS = ("Solver.run",)

    def __init__(self, config, traffic, seed, device, control=False):
        self.c, self.t, self.seed, self.device = config, traffic, seed, device
        self.control = control
        self.tracing = False
        self.final = None

    # -- set-up --------------------------------------------------------------
    def setup(self):
        import torch
        from graph_framework_tpu_torch.kernels import vmec_geom
        from graph_framework_tpu_torch.models.dispersion import cold_plasma
        from graph_framework_tpu_torch.models.vmec import vmec_from_tables
        from graph_framework_tpu_torch.solver import (
            Solver, init_k, make_ray_state)
        from graph_framework_tpu_torch.tools.make_splines import vmec_tables

        c = self.c
        self._vmec_geom = vmec_geom
        clock = time.perf_counter()
        self.samples = inputs_vmec.vmec_samples(c["equilibrium"])
        self.launch = inputs_vmec.launch(c["rays"], c["launch"], self.seed)
        dtype = getattr(torch, c["dtype"])
        eq = vmec_from_tables(vmec_tables(**self.samples), dtype=dtype,
                              device=self.device, cell_local=c["cell_local"],
                              fused_mode_sums=c["fused_mode_sums"])
        if self.control:
            eq = bfloat16_tables(eq)
        self.eq = eq
        self.stages = {"tables_s": time.perf_counter() - clock}
        state = make_ray_state(c["rays"], dtype=dtype, device=self.device,
                               **{k: torch.from_numpy(v)
                                  for k, v in self.launch.items()})
        self.root, diag = init_k(state, cold_plasma, eq,
                                 return_diagnostics=True)
        self.newton = (diag.iterations, float(diag.residual))
        self.stages["init_k_s"] = time.perf_counter() - clock
        self.solver = Solver(cold_plasma, eq, method=c["method"],
                             dt=c["dt"], sub_steps=c["sub_steps"])
        self.unit()                               # warm-up: one whole unit
        self.stages["warm_unit_s"] = time.perf_counter() - clock

    def setup_notes(self):
        return {"rays": self.c["rays"], "newton_iterations": self.newton[0],
                "newton_max_d2": self.newton[1], "control": self.control,
                "cumulative": self.stages}

    # -- the window ----------------------------------------------------------
    def unit(self):
        import torch

        with torch.no_grad(), span(self, "Solver.run"):
            final = self.solver.run(self.root, self.c["steps"])
        sync(self.device)
        self.final = final
        return bool(torch.isfinite(torch.stack(list(final))).all())

    def end_to_end(self, walls, window):
        if not walls:
            return {}
        return {"trace_p95_ms": 1e3 * float(np.percentile(walls, 95))}

    def counters(self):
        return {"k4_launches": self._vmec_geom.vmec_geom_launches}

    def info(self):
        eq = self.eq
        return {"rays": self.c["rays"], "modes": int(eq.xm.shape[0]),
                "substeps_per_run": self.c["steps"] * self.c["sub_steps"],
                "table_bytes": sum(t.nbytes for t in (
                    eq.rmnc_coeffs, eq.zmns_coeffs, eq.lmns_coeffs))}

    def timings(self):
        return {}

    # -- the check -----------------------------------------------------------
    def release(self):
        """Keep the last unit's final state and the root on the host, and
        the equilibrium's geometry at the sampled rays' final positions;
        free the rest."""
        import torch

        c = self.c

        def host(state):
            return {k: getattr(state, k).detach().double().cpu().numpy()
                    for k in vmec_cold.STATE}

        leaves = host(self.final)
        finite = np.all([np.isfinite(v) for v in leaves.values()], axis=0)
        with np.errstate(invalid="ignore"):
            inside = (leaves["x"] > 0.0) & (leaves["x"] < 1.0)
        self.lost = int(np.sum(~(finite & inside)))
        self.index = inputs.sample(c["rays"], self.t["check_rays"], self.seed)
        self.got = {k: v[self.index] for k, v in leaves.items()}
        at = torch.from_numpy(self.index).to(self.final.x.device)
        pos = torch.stack([self.final.x, self.final.y, self.final.z])[:, at]
        self.got_fields = None                    # no geometry off the map
        if bool(torch.isfinite(pos).all()):
            with torch.no_grad():
                g = self.eq._geometry(pos)
            self.got_fields = {k: a.double().cpu().numpy() for k, a in (
                ("esup_s", g["esup"][0]), ("b", g["bvec"]),
                ("jac", g["jac"]))}
        self.got_root = {k: v[self.index]
                         for k, v in host(self.root).items()}
        self.final = self.root = self.solver = self.eq = None

    def reference(self):
        """The reference's root and final state of the sampled rays, from
        its own tables and its own root of the same launch."""
        c = self.c
        tab = vmec_cold.fit_tables(self.samples)
        launch = {k: v[self.index] for k, v in self.launch.items()}
        root = vmec_cold.solve_k(tab, launch)
        final = vmec_cold.trace(tab, root, steps=c["steps"],
                                sub_steps=c["sub_steps"], dt=c["dt"])
        fields = (None if self.got_fields is None else
                  vmec_cold.fields(tab, *(self.got[k] for k in "xyz")))
        return {"root": root, "final": final, "fields": fields}

    def compare(self, want):
        lim = self.t["limits"]
        gap = state_gap(self.got, want["final"])
        drift = state_gap(
            {k: self.got[k] - self.got_root[k] for k in self.got},
            {k: want["final"][k] - want["root"][k] for k in self.got})
        geometry = (float("inf") if self.got_fields is None
                    else field_gap(self.got_fields, want["fields"]))
        kx = self.got_root["kx"]
        self.notes = {"rays_compared": int(self.index.size),
                      "kx_root_gap": float(
                          np.abs(kx - want["root"]["kx"]).max()
                          / np.abs(want["root"]["kx"]).max()),
                      "s_moved": float(np.abs(
                          want["final"]["x"] - want["root"]["x"]).max())}
        return {"trace_gap": (gap, lim["trace_gap"], gap <= lim["trace_gap"]),
                "drift_gap": (drift, lim["drift_gap"],
                              drift <= lim["drift_gap"]),
                "geometry_gap": (geometry, lim["geometry_gap"],
                                 geometry <= lim["geometry_gap"]),
                "rays_lost": (self.lost, lim["rays_lost"],
                              self.lost <= lim["rays_lost"])}

    def check(self):
        return self.compare(self.reference())

    def check_notes(self):
        return self.notes


def field_gap(got, want):
    """The largest deviation of a component of ``got`` from ``want`` (dicts
    of (3, n) or (n,) float64 arrays at the same points), each relative to
    that component's largest magnitude in ``want``; inf where a compared
    value is not finite."""
    worst = 0.0
    for k, w in want.items():
        w = np.atleast_2d(w)
        d = np.abs(np.atleast_2d(got[k]) - w)
        if not np.isfinite(d).all():
            return float("inf")
        worst = max(worst, float((d.max(1) / np.abs(w).max(1)).max()))
    return worst


def bfloat16_tables(eq):
    """``eq`` with its rmnc, zmns and lmns tables rounded to bfloat16 (to
    nearest) and back: the control's equilibrium, a new object, so that K4
    builds its tables afresh."""
    import torch

    def rounded(t):
        return t.to(torch.bfloat16).to(t.dtype)

    return dataclasses.replace(eq, rmnc_coeffs=rounded(eq.rmnc_coeffs),
                               zmns_coeffs=rounded(eq.zmns_coeffs),
                               lmns_coeffs=rounded(eq.lmns_coeffs))
