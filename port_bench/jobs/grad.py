"""The job ``grad``: config 5, the gradient of the absorbed power of a ray
ensemble with respect to the psi spline table and the launch kz, through
the program's ``models/absorbed_power.absorbed_power_grad`` in its kernel
form (K1 forward and K3 backward a freeze window).

Set-up builds the synthetic map's splines and the configuration's launch
from the seed, solves kx with ``init_k`` (the launch's own kz), cuts the
rays into the configuration's batches and warms up with one batch.  A unit is
one batch traced and differentiated, value and gradients ending in a
synchronize; the units go through the batches in turn, whole passes.  The
check takes the batch drawn from the seed, as the window last computed
it, and compares its value, dL/dpsi and dL/dkz0 with the PyTorch
reference (``reference/config5.py``, float64, its own tables and root).
The control is that reference with its tables rounded to bfloat16, the
precision below the configuration's float32 tables, in the program's
place.
"""

from __future__ import annotations

import time

import numpy as np

from port_bench import inputs
from port_bench.harness import span, sync
from port_bench.reference import config5, efit_cold



class Job:
    SPANS = ("absorbed_power_grad",)

    def __init__(self, config, traffic, seed, device, control=False):
        self.c, self.t, self.seed, self.device = config, traffic, seed, device
        self.control = control
        self.tracing = False
        self.done = 0
        self.outputs = {}

    def setup(self):
        import torch
        from graph_framework_tpu_torch.kernels import efit_step
        from graph_framework_tpu_torch.models import absorbed_power
        from graph_framework_tpu_torch.models.dispersion import cold_plasma
        from graph_framework_tpu_torch.models.efit import efit_from_tables
        from graph_framework_tpu_torch.solver import init_k, make_ray_state
        from graph_framework_tpu_torch.tools.make_splines import efit_tables

        clock = time.perf_counter()
        c = self.c
        # the program's config 5 runs rk4 at dt 1 / (steps sub_steps) in a
        # freeze window of its own: hold the configuration to it
        runs = ("rk4", 1.0 / (c["steps"] * c["sub_steps"]),
                absorbed_power.FREEZE_EVERY, False)
        states = (c["method"], c["dt"], c["freeze"], c["compensated"])
        if runs != states:
            raise RuntimeError(f"the program's config 5 runs (method, dt, "
                               f"freeze, compensated) {runs}, the "
                               f"configuration states {states}")
        self._ap, self._efit_step = absorbed_power, efit_step
        self.samples = inputs.efit_samples(c["equilibrium"])
        self.launch = inputs.launch(c["rays"], c["launch"], self.seed)
        dtype = getattr(torch, c["dtype"])
        self.eq = efit_from_tables(efit_tables(**self.samples), dtype=dtype,
                                   device=self.device)
        state = make_ray_state(c["rays"], dtype=dtype, device=self.device,
                               **{k: torch.from_numpy(v)
                                  for k, v in self.launch.items()})
        root, diag = init_k(state, cold_plasma, self.eq,
                            return_diagnostics=True)
        self.newton = (diag.iterations, float(diag.residual))
        self.batches = absorbed_power.ray_batches(root, c["batches"])
        self.stages = {"tables_and_init_k_s": time.perf_counter() - clock}
        self.unit()                               # warm-up: one batch
        self.done, self.outputs = 0, {}
        self.stages["warm_unit_s"] = time.perf_counter() - clock

    def setup_notes(self):
        return {"rays": self.c["rays"], "batches": self.c["batches"],
                "newton_iterations": self.newton[0],
                "newton_max_d2": self.newton[1], "cumulative": self.stages}

    def unit(self):
        import torch

        c = self.c
        b = self.done % len(self.batches)
        with span(self, "absorbed_power_grad"):
            value, (g_psi, g_kz) = self._ap.absorbed_power_grad(
                self.eq, self.batches[b], c["steps"], c["sub_steps"],
                self.eq.psi_coeffs, c["kz0"], form=c["form"])
        sync(self.device)
        self.done += 1
        self.outputs[b] = (value, g_psi, g_kz)
        return bool(torch.isfinite(value) and torch.isfinite(g_kz)
                    and torch.isfinite(g_psi).all())

    def batch_rays(self):
        return self.batches[0].x.shape[0]

    def end_to_end(self, walls, window):
        if not walls:
            return {}
        c = self.c
        return {"grad_ray_steps_per_s": self.batch_rays() * c["steps"]
                * c["sub_steps"] * len(walls) / window}

    def counters(self):
        e = self._efit_step
        return {"k1_launches": e.efit_window_launches,
                "k2_launches": e.efit_window_bwd_launches,
                "k3_launches": e.efit_window_bwd_tab_launches}

    def info(self):
        psi, prof = self.eq.psi_coeffs, self.eq.profile_coeffs
        return {"rays": self.batch_rays(), "k3": "K3 rk4",
                "table_bytes": psi.nbytes + prof.nbytes}

    def timings(self):
        return {}

    # -- the check -----------------------------------------------------------
    def release(self):
        # a batch the window computed, drawn from the seed
        rng = np.random.default_rng([self.seed, 2])
        done = sorted(self.outputs)
        self.batch = done[int(rng.integers(len(done)))]
        size = self.batch_rays()
        self.rows = slice(self.batch * size, (self.batch + 1) * size)
        value, g_psi, g_kz = self.outputs[self.batch]
        self.got = (float(value), g_psi.double().cpu().numpy(), float(g_kz))
        self.outputs = self.batches = self.eq = None
        if self.control:
            self.got = self._reference(efit_cold.bfloat16_tables(
                efit_cold.fit_tables(self.samples)))

    def _reference(self, tab):
        c = self.c
        launch = {k: v[self.rows] for k, v in self.launch.items()}
        return config5.value_and_grad(tab, launch, c["kz0"], c["steps"],
                                      c["sub_steps"], self.device)

    def reference(self):
        return self._reference(efit_cold.fit_tables(self.samples))

    def compare(self, want):
        lim = self.t["limits"]
        (v, gp, gk), (wv, wgp, wgk) = self.got, want

        def rel(a, b, scale):
            d = abs(a - b) / scale
            return float(d) if np.isfinite(d) else float("inf")

        values = {"value_gap": rel(v, wv, abs(wv)),
                  "kz_gap": rel(gk, wgk, abs(wgk)),
                  "psi_gap": rel(np.abs(gp - wgp).max(), 0.0,
                                 np.abs(wgp).max())}
        self.notes = {"batch": self.batch, "value": v, "value_ref": wv,
                      "dL_dkz": gk, "dL_dkz_ref": wgk}
        return {k: (x, lim[k], x <= lim[k]) for k, x in values.items()}

    def check(self):
        return self.compare(self.reference())

    def check_notes(self):
        return self.notes
