"""The job ``trace``: the ray ensemble of a configuration traced by
``Solver.run`` from its solved launch, back to back.

Set-up builds the synthetic EFIT map's splines and the launch from the
seed, solves kx with ``init_k`` and runs one trace (which loads the kernel
library and warms the caching allocator).  A unit is one whole trace of
``steps`` recorded steps x ``sub_steps`` substeps, timed from the call to
the synchronize after it.  The check compares the last unit's final state
on a sample of rays drawn from the seed with the NumPy reference
(``reference/efit_cold.py``) traced in float64 from its own tables and its
own root, and counts the rays, of all, that left the table or went
non-finite.
"""

from __future__ import annotations

import time

import numpy as np

from port_bench import inputs
from port_bench.harness import span, sync
from port_bench.reference import efit_cold

GROUPS = {"t": ("t",), "w": ("w",), "pos": ("x", "y", "z"),
          "k": ("kx", "ky", "kz")}



def state_gap(got, want):
    """The largest per-leaf deviation of ``got`` from ``want`` (dicts of
    float64 arrays over the same rays), each relative to the largest
    magnitude of its leaf's group in ``want`` (time, frequency, position,
    wave vector); inf where a compared value is not finite."""
    worst = 0.0
    for leaves in GROUPS.values():
        scale = max(float(np.abs(want[k]).max()) for k in leaves) or 1.0
        for k in leaves:
            d = np.abs(got[k] - want[k])
            if not np.isfinite(d).all():
                return float("inf")
            worst = max(worst, float(d.max()) / scale)
    return worst


class Job:
    SPANS = ("Solver.run",)

    def __init__(self, config, traffic, seed, device, control=False):
        self.c, self.t, self.seed, self.device = config, traffic, seed, device
        # the control: the program's own uncompensated path, the next
        # precision below the configuration's compensated float32
        self.compensated = config["compensated"] and not control
        self.tracing = False
        self.final = None

    # -- set-up --------------------------------------------------------------
    def setup(self):
        import torch
        from graph_framework_tpu_torch.kernels import efit_step
        from graph_framework_tpu_torch.models.dispersion import cold_plasma
        from graph_framework_tpu_torch.models.efit import efit_from_tables
        from graph_framework_tpu_torch.solver import (
            Solver, init_k, make_ray_state)
        from graph_framework_tpu_torch.tools.make_splines import efit_tables

        c = self.c
        self._efit_step = efit_step
        clock = time.perf_counter()
        self.samples = inputs.efit_samples(c["equilibrium"])
        self.launch = inputs.launch(c["rays"], c["launch"], self.seed)
        dtype = getattr(torch, c["dtype"])
        self.eq = efit_from_tables(efit_tables(**self.samples), dtype=dtype,
                                   device=self.device)
        self.stages = {"tables_s": time.perf_counter() - clock}
        state = make_ray_state(c["rays"], dtype=dtype, device=self.device,
                               **{k: torch.from_numpy(v)
                                  for k, v in self.launch.items()})
        self.root, diag = init_k(state, cold_plasma, self.eq,
                                 return_diagnostics=True)
        self.newton = (diag.iterations, float(diag.residual))
        self.stages["init_k_s"] = time.perf_counter() - clock
        self.solver = Solver(cold_plasma, self.eq, method=c["method"],
                             dt=c["dt"], sub_steps=c["sub_steps"],
                             frozen_cells=True, freeze_every=c["freeze"],
                             compensated=self.compensated,
                             window_kernel=True)
        self.unit()                               # warm-up: one whole unit
        self.stages["warm_unit_s"] = time.perf_counter() - clock

    def setup_notes(self):
        return {"rays": self.c["rays"], "newton_iterations": self.newton[0],
                "newton_max_d2": self.newton[1],
                "compensated": self.compensated, "cumulative": self.stages}

    # -- the window ----------------------------------------------------------
    def unit(self):
        import torch

        with torch.no_grad(), span(self, "Solver.run"):
            final = self.solver.run(self.root, self.c["steps"])
        sync(self.device)
        self.final = final
        return bool(torch.isfinite(torch.stack(list(final))).all())

    def ray_steps(self):
        c = self.c
        return c["rays"] * c["steps"] * c["sub_steps"]

    def end_to_end(self, walls, window):
        if not walls:
            return {}
        return {"ray_steps_per_s": self.ray_steps() * len(walls) / window,
                "trace_p95_ms": 1e3 * float(np.percentile(walls, 95))}

    def counters(self):
        return {"k1_launches": self._efit_step.efit_window_launches}

    def info(self):
        psi, prof = self.eq.psi_coeffs, self.eq.profile_coeffs
        return {"rays": self.c["rays"],
                "k1": "K1 rk2 comp" if self.compensated else None,
                "table_bytes": psi.nbytes + prof.nbytes}

    def timings(self):
        return {}

    # -- the check -----------------------------------------------------------
    def release(self):
        """Keep the last unit's final state on the host, free the rest."""
        eq, c = self.c["equilibrium"], self.c
        leaves = {k: getattr(self.final, k).detach().double().cpu().numpy()
                  for k in efit_cold.STATE}
        r = np.sqrt(leaves["x"] ** 2 + leaves["y"] ** 2)
        finite = np.all([np.isfinite(v) for v in leaves.values()], axis=0)
        with np.errstate(invalid="ignore"):
            inside = ((r >= eq["r_range"][0]) & (r <= eq["r_range"][1])
                      & (leaves["z"] >= eq["z_range"][0])
                      & (leaves["z"] <= eq["z_range"][1]))
        self.lost = int(np.sum(~(finite & inside)))
        self.index = inputs.sample(c["rays"], self.t["check_rays"], self.seed)
        self.got = {k: v[self.index] for k, v in leaves.items()}
        self.kx_root = self.root.kx.double().cpu().numpy()[self.index]
        self.final = self.root = self.solver = self.eq = None

    def reference(self):
        """The reference's final state of the sampled rays, from its own
        tables and its own root of the same launch."""
        c = self.c
        tab = efit_cold.fit_tables(self.samples)
        launch = {k: v[self.index] for k, v in self.launch.items()}
        root = efit_cold.solve_k(tab, launch)
        final = efit_cold.trace(tab, root, steps=c["steps"],
                                sub_steps=c["sub_steps"], freeze=c["freeze"],
                                method=c["method"], dt=c["dt"])
        return {"kx_root": root["kx"], "final": final}

    def compare(self, want):
        lim = self.t["limits"]
        gap = state_gap(self.got, want["final"])
        self.notes = {"rays_compared": int(self.index.size),
                      "kx_root_gap": float(
                          np.abs(self.kx_root - want["kx_root"]).max()
                          / np.abs(want["kx_root"]).max())}
        return {"trace_gap": (gap, lim["trace_gap"], gap <= lim["trace_gap"]),
                "rays_lost": (self.lost, lim["rays_lost"],
                              self.lost <= lim["rays_lost"])}

    def check(self):
        return self.compare(self.reference())

    def check_notes(self):
        return self.notes
