"""The job ``pipeline``: the xrays program's three phases, as an ECRH user
runs them, back to back.

A unit is one call of the program's ``cli/xrays.run_xrays`` with the
traffic's options: Newton init of kx, phase 1 (the trace, each recorded
row written through the program's writer thread into an in-memory store),
phase 2 (the weak-damping kamp of every row), phase 3 (the power binned
along each ray).  The launch is the traffic's, drawn by the program's CLI
from the seed as :func:`inputs.launch` draws it.  On a card the CLI
resolves its own stack, which the job holds to the configuration's.

The check takes a sample of rays drawn from the seed from the last unit's
store and compares (i) the recorded rows with the NumPy reference's own
trace (``reference/efit_cold.py``, float64, its own tables and root),
(ii) kamp with the reference's (``reference/absorption.py``, complex128)
at the program's rows, and (iii) the power with the reference's binning
of the program's rows and the reference's kamp.  The control is the
reference with its tables rounded to bfloat16, the precision below the
configuration's float32 tables, put in the program's place.
"""

from __future__ import annotations

import time

import numpy as np

from port_bench import inputs
from port_bench.harness import span
from port_bench.jobs.trace import state_gap
from port_bench.reference import absorption as ref_abs
from port_bench.reference import efit_cold
from port_bench.store import MemoryFiles

NAMES = ("time", "w", "x", "y", "z", "kx", "ky", "kz")   # the store's


def complex_gap(got, want):
    """The larger of the real and imaginary parts' largest deviations,
    each relative to that part's largest magnitude in ``want``."""
    out = 0.0
    for part in (np.real, np.imag):
        d = np.abs(part(got) - part(want))
        if not np.isfinite(d).all():
            return float("inf")
        out = max(out, float(d.max()) / (float(np.abs(part(want)).max())
                                         or 1.0))
    return out


class Job:
    SPANS = ("run_xrays",)

    def __init__(self, config, traffic, seed, device, control=False):
        self.c, self.t, self.seed, self.device = config, traffic, seed, device
        self.control = control
        self.tracing = False
        self.run_timings = []

    def _args(self):
        from graph_framework_tpu_torch.cli import xrays

        c, t = self.c, self.t
        p, steps = t["launch"], t["rows"] * c["sub_steps"]
        if p["kz"] != 0.0:
            raise ValueError("the CLI launches kz = 0 unless told otherwise")
        options = [
            "--dispersion=cold_plasma", "--equilibrium=efit",
            f"--num_rays={c['rays']}", f"--num_times={steps}",
            f"--sub_steps={c['sub_steps']}", f"--endtime={c['dt'] * steps}",
            f"--init_w_mean={p['w']}", f"--init_x_mean={p['x']}",
            "--init_x_dist=normal", f"--init_x_sigma={p['x_spread']}",
            f"--init_ky_mean={p['ky']}", "--init_ky_dist=normal",
            f"--init_ky_sigma={p['ky_spread']}", f"--init_kx_mean={p['kx']}",
            f"--stream_segment={t['stream_segment']}", f"--seed={self.seed}",
            f"--absorption_model={t['absorption_model']}",
            f"--device={self.device}"]
        import torch

        if torch.device(self.device).type != "cuda":
            # the card's stack by name: the CLI takes it by itself there
            options += ["--solver=" + c["method"], "--frozen_cells",
                        f"--freeze_every={c['freeze']}", "--window_kernel",
                        "--f32" if c["dtype"] == "float32" else "--x64"]
            options += ["--compensated"] * c["compensated"]
        args = xrays.resolve_stack(xrays.build_parser().parse_args(options),
                                   self.device)
        stack = (args.solver, args.frozen_cells, args.freeze_every,
                 args.compensated, args.window_kernel, args.x64)
        want = (c["method"], True, c["freeze"], c["compensated"], True,
                c["dtype"] == "float64")
        if stack != want:
            raise RuntimeError(f"the CLI resolved the stack {stack}, the "
                               f"configuration states {want}")
        return args

    # -- set-up --------------------------------------------------------------
    def setup(self):
        import torch
        from graph_framework_tpu_torch.cli import xrays
        from graph_framework_tpu_torch.kernels import efit_step
        from graph_framework_tpu_torch.models.efit import efit_from_tables
        from graph_framework_tpu_torch.tools.make_splines import efit_tables

        clock = time.perf_counter()
        self._xrays, self._efit_step = xrays, efit_step
        self.samples = inputs.efit_samples(self.c["equilibrium"])
        self.args = self._args()
        self.eq = efit_from_tables(efit_tables(**self.samples),
                                   dtype=getattr(torch, self.c["dtype"]),
                                   device=self.device)
        self.stages = {"tables_s": time.perf_counter() - clock}
        self.unit()                               # warm-up: one whole run
        self.warm = self.run_timings.pop()
        self.stages["warm_unit_s"] = time.perf_counter() - clock

    def setup_notes(self):
        return {"rays": self.c["rays"], "rows": self.t["rows"],
                "warm_unit": self.warm, "cumulative": self.stages}

    # -- the window ----------------------------------------------------------
    def unit(self):
        files = MemoryFiles()
        self.files = None                         # the last unit's store only
        with span(self, "run_xrays"):
            run = self._xrays.run_xrays(self.args, self.eq, files.open)
        self.files = files
        self.run_timings.append({k: v for k, v in run.timings.items()
                                 if k.endswith("_s")})
        last = files[self.args.output].read_step(
            files[self.args.output].num_steps - 1, NAMES)
        return all(bool(np.isfinite(v).all()) for v in last.values())

    def end_to_end(self, walls, window):
        if not walls:
            return {}
        return {"xrays_s": window / len(walls)}

    def counters(self):
        return {"k1_launches": self._efit_step.efit_window_launches}

    def info(self):
        return {"rays": self.c["rays"], "rows": self.t["rows"]}

    def timings(self):
        """Each phase timer of the program's CLI, averaged over the units
        run since the warm-up."""
        runs = self.run_timings
        return {k: sum(r[k] for r in runs) / len(runs)
                for k in (runs[0] if runs else {})}

    # -- the check -----------------------------------------------------------
    def release(self):
        c, eq = self.c, self.c["equilibrium"]
        store = self.files[self.args.output]
        last = store.read_step(store.num_steps - 1, NAMES)
        r = np.sqrt(last["x"] ** 2 + last["y"] ** 2)
        finite = np.all([np.isfinite(v) for v in last.values()], axis=0)
        with np.errstate(invalid="ignore"):
            inside = ((r >= eq["r_range"][0]) & (r <= eq["r_range"][1])
                      & (last["z"] >= eq["z_range"][0])
                      & (last["z"] <= eq["z_range"][1]))
        self.lost = int(np.sum(~(finite & inside)))
        self.index = inputs.sample(c["rays"], self.t["check_rays"], self.seed)
        self.got = {
            "rows": {k: store.stack(n, self.index)
                     for k, n in zip(efit_cold.STATE, NAMES)},
            "kamp": store.stack("kamp", self.index),
            "power": store.stack("power", self.index)}
        self.files = self.eq = None
        if self.control:
            self.got = self._outputs(bf16=True)

    def _outputs(self, bf16=False):
        """The reference's rows, kamp and power of the sampled rays, from
        its own tables (rounded to bfloat16 for the control)."""
        c = self.c
        tab = efit_cold.fit_tables(self.samples)
        if bf16:
            tab = efit_cold.bfloat16_tables(tab)
        launch = inputs.launch(c["rays"], self.t["launch"], self.seed)
        launch = {k: v[self.index] for k, v in launch.items()}
        rows = []
        efit_cold.trace(tab, efit_cold.solve_k(tab, launch),
                        steps=self.t["rows"], sub_steps=c["sub_steps"],
                        freeze=c["freeze"], method=c["method"], dt=c["dt"],
                        rows=rows)
        rows = {k: np.stack([row[k] for row in rows])
                for k in efit_cold.STATE}
        kamp = self._kamp(tab, rows)
        return {"rows": rows, "kamp": kamp,
                "power": ref_abs.bin_power(rows["x"], rows["y"], rows["z"],
                                           kamp.imag)}

    @staticmethod
    def _kamp(tab, rows):
        shape = rows["x"].shape
        return ref_abs.weak_damping(
            tab, *(rows[k].ravel() for k in efit_cold.STATE)).reshape(shape)

    def reference(self):
        """The reference's own rows, and its tables for kamp and the
        power at the program's rows."""
        return {"rows": self._outputs()["rows"],
                "tab": efit_cold.fit_tables(self.samples)}

    def compare(self, want):
        lim, got = self.t["limits"], self.got
        kamp = self._kamp(want["tab"], got["rows"])
        power = ref_abs.bin_power(got["rows"]["x"], got["rows"]["y"],
                                  got["rows"]["z"], kamp.imag)
        values = {"rows_gap": state_gap(
                      {k: v.ravel() for k, v in got["rows"].items()},
                      {k: v.ravel() for k, v in want["rows"].items()}),
                  "kamp_gap": complex_gap(got["kamp"], kamp),
                  "power_gap": float(np.abs(got["power"] - power).max()),
                  "rays_lost": self.lost}
        self.notes = {"rays_compared": int(self.index.size),
                      "rows": int(got["kamp"].shape[0]),
                      "min_power": float(got["power"].min()),
                      "max_im_kamp": float(np.abs(kamp.imag).max())}
        return {k: (v, lim[k], v <= lim[k]) for k, v in values.items()}

    def check(self):
        return self.compare(self.reference())

    def check_notes(self):
        return self.notes
