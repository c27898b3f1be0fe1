"""The port's ray ensembles split across processes (``parallel``) on the
CPU: gloo ranks as subprocesses, each with its own timeout, against the
JAX package's sharded runs on its 8-device virtual mesh and against the
port's one-process runs.

* Four ranks run ``init_k(mesh=)`` and ``Solver.trace`` on
  tests/test_sharding.py's slab problem (64 rays, f64): each rank's rows
  within 1e-12 of each leaf's scale of JAX's sharded trace, and equal bit
  for bit to the port's one-process rows; the Newton iteration count equal
  on every rank and to one process's, also with a NaN ray on rank 0 or on
  rank 3 (gloo's MAX all-reduce alone loses a NaN that a higher rank
  holds).
* Two ranks run the production stack (frozen rk2, K = 10, compensated;
  the window kernel's plain version on the CPU) over the synthetic EFIT
  map (and ``efit.nc`` where present) against JAX's
  ``run_blocked_sharded(block_rays=None)``, from JAX's sharded root, to
  1e-10 of each leaf's scale (tests/test_torch_solver.py's limit).
* Config 5 in two ranks, ``absorbed_power_grad(mesh=)``, against
  tests/test_config5.py's loss on JAX's sharded state: the value to 1e-12,
  the gradients to 1e-10 (tests/test_torch_config5.py's limits).
* ``host_local_rows`` partitions the rays; ``host_output_filename`` names a
  file a rank; a checkpoint the two ranks saved is restored whole by one
  process and slice by slice under four ranks.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from conftest import REPO_ROOT
from graph_framework_tpu.models import dispersion as jax_disp
from graph_framework_tpu.models.equilibrium import (
    make_slab_density as jax_slab_density)
from graph_framework_tpu.parallel.mesh import (
    ray_mesh as jax_ray_mesh, replicate as jax_replicate,
    run_blocked_sharded as jax_run_blocked_sharded,
    shard_rays as jax_shard_rays)
from graph_framework_tpu.solver import Solver as JaxSolver
from graph_framework_tpu.solver import init_k as jax_init_k
from graph_framework_tpu.solver import make_ray_state as jax_make_ray_state
from graph_framework_tpu_torch.io import restore_ray_state, save_ray_state
from graph_framework_tpu_torch.models.dispersion import cold_plasma
from graph_framework_tpu_torch.models.equilibrium import make_slab_density
from graph_framework_tpu_torch.models.rays import RayState
from graph_framework_tpu_torch.parallel import (
    replicate, run_blocked_sharded, shard_rays)
from graph_framework_tpu_torch.parallel.mesh import (
    RayMesh, local_rows, pad_to_devices)
from graph_framework_tpu_torch.solver import Solver, init_k, make_ray_state
from test_config5 import _absorbed_power_fn
from test_torch_common import SOURCES, efit_path, launch_arrays

TIMEOUT = 150                    # seconds a rank may take
SLAB_RAYS, SLAB_STEPS, NAN_RAY = 64, 3, 5
EFIT_RAYS, EFIT_STEPS = 64, 2
C5_RAYS, C5_STEPS, C5_SUB = 16, 4, 10
PRODUCTION = dict(method="rk2", dt=1e-4, sub_steps=10, frozen_cells=True,
                  freeze_every=10, compensated=True)

_WORKER = r"""
import json, pathlib, sys
import numpy as np
import torch
torch.set_num_threads(1)
from graph_framework_tpu_torch.io import restore_ray_state, save_ray_state
from graph_framework_tpu_torch.models.absorbed_power import (
    absorbed_power_grad)
from graph_framework_tpu_torch.models.dispersion import cold_plasma
from graph_framework_tpu_torch.models.efit import make_efit
from graph_framework_tpu_torch.models.equilibrium import make_slab_density
from graph_framework_tpu_torch.models.rays import RayState
from graph_framework_tpu_torch.parallel import (
    distributed, ray_mesh, run_blocked_sharded, shard_rays,
    sharded_trace_fn)
from graph_framework_tpu_torch.parallel import mesh as pmesh
from graph_framework_tpu_torch.solver import Solver, init_k

cfg = json.loads(sys.argv[1])
distributed.initialize(f"localhost:{cfg['port']}", cfg["world"],
                       cfg["rank"], backend="gloo")
mesh = ray_mesh(device="cpu")
out = pathlib.Path(cfg["out"])
inputs = np.load(cfg["inputs"])
arrays, info = {}, {"rank": mesh.rank, "world": mesh.world_size,
                    "file": distributed.host_output_filename(),
                    "info": list(distributed.process_info())}


def state(prefix):
    return RayState(*[torch.from_numpy(inputs[f"{prefix}_{f}"])
                      for f in RayState._fields])


def keep(prefix, s):
    for f, leaf in zip(RayState._fields, s):
        arrays[f"{prefix}_{f}"] = leaf.detach().numpy()


if cfg["job"] == "two":
    for source, path in cfg["efit"].items():
        sol = Solver(cold_plasma, make_efit(path, device="cpu"),
                     **cfg["production"])
        final = run_blocked_sharded(sol, shard_rays(state(source), mesh),
                                    cfg["efit_steps"], mesh)
        keep(source, final)
        idx, vals = distributed.host_local_rows(final.x, mesh)
        arrays[f"{source}_idx"], arrays[f"{source}_vals"] = idx, vals
        save_ray_state(out / f"checkpoint_{source}", final, mesh=mesh)
    eq = make_efit(cfg["efit"]["synthetic"], device="cpu")
    value, (g_psi, g_kz) = absorbed_power_grad(
        eq, shard_rays(state("c5"), mesh), cfg["c5_steps"], cfg["c5_sub"],
        eq.psi_coeffs, cfg["kz0"], mesh=mesh)
    arrays.update(c5_value=value.numpy(), c5_psi=g_psi.numpy(),
                  c5_kz=g_kz.numpy())
    info["all_reduce_calls"] = pmesh.all_reduce_calls
else:
    eq = make_slab_density()
    sol = Solver(cold_plasma, eq, method="rk4", dt=1e-4, sub_steps=5)
    start = pmesh.all_reduce_calls
    root, diag = init_k(shard_rays(state("slab"), mesh), cold_plasma, eq,
                        "kx", tolerance=1e-24, return_diagnostics=True,
                        mesh=mesh)
    info["iterations"] = diag.iterations
    info["newton_all_reduces"] = pmesh.all_reduce_calls - start
    final, traj = sharded_trace_fn(sol, mesh, cfg["slab_steps"])(root)
    keep("root", root)
    keep("final", final)
    arrays["traj_x"] = traj.x.numpy()
    for nan_rank in (0, 3):
        _, diag = init_k(shard_rays(state(f"nan{nan_rank}"), mesh),
                         cold_plasma, eq, "kx", tolerance=1e-24,
                         return_diagnostics=True, mesh=mesh)
        info[f"nan{nan_rank}_iterations"] = diag.iterations
    restored = restore_ray_state(cfg["checkpoint"], mesh=mesh)
    keep("restored", restored)

np.savez(out / f"{cfg['job']}{mesh.rank}.npz", **arrays)
print("RESULT", json.dumps(info))
"""


def _spawn(job, world, out, **cfg):
    """Start ``world`` gloo ranks of ``job``; returns their processes."""
    script = out / "worker.py"
    script.write_text(_WORKER)
    env = dict(os.environ, PYTHONPATH=str(REPO_ROOT), OMP_NUM_THREADS="1")
    port = chip_smoke.free_port()
    return [subprocess.Popen(
        [sys.executable, str(script), json.dumps(dict(
            cfg, job=job, world=world, rank=rank, port=port, out=str(out)))],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env,
        cwd=out) for rank in range(world)]


def _finish(procs, job, out):
    """Wait for each rank (its own timeout); (infos, arrays) by rank."""
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o
    infos = [json.loads(next(line for line in o.splitlines()
                             if line.startswith("RESULT"))[7:])
             for o in outs]
    return infos, [dict(np.load(out / f"{job}{r}.npz"))
                   for r in range(len(procs))]


def _leaves(state, prefix=None):
    """A state's leaves as numpy arrays by name (``<prefix>_<name>``)."""
    return {f if prefix is None else f"{prefix}_{f}": np.asarray(leaf)
            for f, leaf in zip(RayState._fields, state)}


def _port_state(arrays, prefix):
    return RayState(*[torch.from_numpy(arrays[f"{prefix}_{f}"])
                      for f in RayState._fields])


def _scale_errors(got, want):
    """Per leaf max |got - want| over the leaf's scale in ``want``."""
    return {f: float(np.abs(got[f] - want[f]).max()
                     / max(np.abs(want[f]).max(), 1e-300)) for f in want}


def _slab_arrays(n=SLAB_RAYS):
    """test_sharding.py's slab launch, kx unsolved, as float64 arrays."""
    full = np.ones(n)
    return dict(t=0 * full, w=900 * full, x=0.1 * full,
                y=0 * full, z=0 * full, kx=np.linspace(700.0, 900.0, n),
                ky=25 * full, kz=400 * full)


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """The two-rank job (EFIT production stack, config 5, checkpoints)
    beside JAX's sharded runs of the same, computed while the ranks run."""
    out = tmp_path_factory.mktemp("two_ranks")
    mesh8 = jax_ray_mesh()
    efit = {}
    for source in SOURCES:
        try:
            efit[source] = str(efit_path(source, tmp_path_factory))
        except pytest.skip.Exception:
            continue
    from graph_framework_tpu.models.efit import make_efit as jax_make_efit
    jeqs = {s: jax_make_efit(p, dtype=jnp.float64) for s, p in efit.items()}
    inputs, roots = {}, {}
    for source, jeq in jeqs.items():
        st = jax_shard_rays(jax_make_ray_state(
            EFIT_RAYS, **launch_arrays(EFIT_RAYS)), mesh8)
        roots[source] = jax_init_k(st, jax_disp.cold_plasma, jeq, "kx")
        inputs.update(_leaves(roots[source], source))
    spec = chip_smoke.CONFIG5_LAUNCH
    rng = np.random.default_rng(0)
    full = np.ones(C5_RAYS)
    c5 = dict(t=0 * full, w=spec["w"] * full,
              x=spec["x"] + spec["x_spread"] * rng.standard_normal(C5_RAYS),
              y=0 * full, z=0 * full, kx=spec["kx"] * full,
              ky=spec["ky"] + spec["ky_spread"]
              * rng.standard_normal(C5_RAYS), kz=spec["kz"] * full)
    c5_root = jax_init_k(jax_shard_rays(jax_make_ray_state(C5_RAYS, **c5),
                                        mesh8),
                         jax_disp.cold_plasma, jeqs["synthetic"], "kx",
                         tolerance=1.0e-16, max_iterations=100)
    inputs.update(_leaves(c5_root, "c5"))
    np.savez(out / "inputs.npz", **inputs)
    procs = _spawn("two", 2, out, inputs=str(out / "inputs.npz"), efit=efit,
                   production=PRODUCTION, efit_steps=EFIT_STEPS,
                   c5_steps=C5_STEPS, c5_sub=C5_SUB,
                   kz0=chip_smoke.CONFIG5_KZ)
    want = {}
    for source, jeq in jeqs.items():
        sol = JaxSolver(jax_disp.cold_plasma, jax_replicate(jeq, mesh8),
                        **PRODUCTION)
        want[source] = _leaves(jax_run_blocked_sharded(
            sol, roots[source], EFIT_STEPS, mesh8, block_rays=None))
    jeq = jeqs["synthetic"]
    value, (g_psi, g_kz) = jax.value_and_grad(
        _absorbed_power_fn(jeq, c5_root, C5_STEPS, C5_SUB), argnums=(0, 1))(
        jeq.psi_coeffs, jnp.float64(chip_smoke.CONFIG5_KZ))
    want["c5"] = (float(value), np.asarray(g_psi), float(g_kz))
    infos, arrays = _finish(procs, "two", out)
    return dict(out=out, efit=efit, infos=infos, arrays=arrays, want=want)


@pytest.fixture(scope="module")
def four_ranks(two_ranks, tmp_path_factory):
    """The four-rank slab job (init_k, trace, the NaN rays, the two ranks'
    checkpoint restored slice by slice) beside JAX's sharded trace and the
    port's one-process runs."""
    out = tmp_path_factory.mktemp("four_ranks")
    slab = _slab_arrays()
    inputs = {f"slab_{f}": v for f, v in slab.items()}
    for nan_rank in (0, 3):
        x = slab["x"].copy()
        x[nan_rank * SLAB_RAYS // 4 + NAN_RAY] = np.nan
        inputs.update({f"nan{nan_rank}_{f}": v for f, v in
                       dict(slab, x=x).items()})
    np.savez(out / "inputs.npz", **inputs)
    procs = _spawn("four", 4, out, inputs=str(out / "inputs.npz"),
                   slab_steps=SLAB_STEPS,
                   checkpoint=str(two_ranks["out"] / "checkpoint_synthetic"))
    # JAX's sharded run (test_sharding.py's)
    mesh8 = jax_ray_mesh()
    jeq = jax_slab_density()
    jroot = jax_init_k(jax_shard_rays(jax_make_ray_state(SLAB_RAYS, **slab),
                                      mesh8),
                       jax_disp.cold_plasma, jeq, "kx", tolerance=1e-24)
    jfinal, _ = JaxSolver(jax_disp.cold_plasma, jeq, method="rk4", dt=1e-4,
                          sub_steps=5).trace(jroot, SLAB_STEPS)
    # the port in one process
    eq = make_slab_density()
    state = _port_state(inputs, "slab")
    root, diag = init_k(state, cold_plasma, eq, "kx", tolerance=1e-24,
                        return_diagnostics=True)
    final, traj = Solver(cold_plasma, eq, method="rk4", dt=1e-4,
                         sub_steps=5).trace(root, SLAB_STEPS)
    one = dict(root=root, final=final, traj_x=traj.x.numpy(),
               iterations=diag.iterations)
    for nan_rank in (0, 3):
        one[f"nan{nan_rank}_iterations"] = init_k(
            _port_state(inputs, f"nan{nan_rank}"), cold_plasma, eq, "kx",
            tolerance=1e-24, return_diagnostics=True)[1].iterations
    infos, arrays = _finish(procs, "four", out)
    return dict(infos=infos, arrays=arrays, jax_root=_leaves(jroot),
                jax_final=_leaves(jfinal), one=one)


def _gather(arrays, prefix):
    """The ranks' rows of one state, concatenated in rank order."""
    return {f: np.concatenate([a[f"{prefix}_{f}"] for a in arrays])
            for f in RayState._fields}


# -- the mesh without processes ----------------------------------------------

def test_pad_to_devices_and_slice_bounds():
    meshes = [RayMesh(4, r, torch.device("cpu")) for r in range(4)]
    assert [pad_to_devices(n, meshes[0]) for n in (1, 4, 5, 8, 9)] == [
        4, 4, 8, 8, 12]
    state = make_ray_state(64, w=1.0, x=torch.arange(64.0), device="cpu")
    for mesh in meshes:
        part = shard_rays(state, mesh)
        rows = slice(16 * mesh.rank, 16 * (mesh.rank + 1))
        assert local_rows(64, mesh) == rows
        assert all(torch.equal(a, b[rows]) for a, b in zip(part, state))


def test_shard_rays_refuses_a_ragged_ensemble():
    """The counterpart of test_sharding.py's pad_to_devices: a count that
    the world size does not divide is refused, pointing to the pad."""
    mesh = RayMesh(4, 1, torch.device("cpu"))
    with pytest.raises(ValueError, match=r"pad_to_devices\(n, mesh\) = 64"):
        shard_rays(make_ray_state(63, w=1.0, device="cpu"), mesh)
    with pytest.raises(ValueError, match="ray counts"):
        shard_rays(RayState(*[torch.zeros(8)] * 7, torch.zeros(4)), mesh)


def test_replicate_moves_every_table():
    """replicate puts every tensor of an equilibrium on the rank's device
    and keeps its numbers (the meta device stands in for a card)."""
    eq = chip_smoke.synthetic_equilibrium(torch.float64, "cpu", grid=9)
    moved = replicate(eq, RayMesh(2, 1, torch.device("meta")))
    assert moved.psi_coeffs.device.type == "meta"
    assert moved.profile_coeffs.shape == eq.profile_coeffs.shape
    assert (moved.rmin, moved.dr, moved.cell_local) == (
        eq.rmin, eq.dr, eq.cell_local)


def test_run_blocked_sharded_keeps_the_separability_guard():
    eq = make_slab_density()
    mesh = RayMesh(1, 0, torch.device("cpu"))
    state = shard_rays(make_ray_state(
        4, w=900.0, x=0.1, kx=800.0, ky=25.0, kz=400.0, device="cpu"), mesh)
    sol = Solver(cold_plasma, eq, method="split_simplextic", dt=1e-4)
    with pytest.raises(ValueError, match="not separable"):
        run_blocked_sharded(sol, state, 1, mesh)
    with pytest.raises(ValueError, match="rank's device"):
        run_blocked_sharded(sol, state, 1,
                            RayMesh(1, 0, torch.device("meta")))


def test_checkpoint_slices_tile_under_any_world_size(tmp_path):
    """A checkpoint written slice by slice by two ranks (meshes without a
    group: each rank's call alone) restores whole and under four ranks; a
    later save by one process or by fewer ranks leaves no stale slice."""
    state = make_ray_state(8, w=1.0, x=torch.arange(8.0), device="cpu")
    for rank in range(2):
        mesh = RayMesh(2, rank, torch.device("cpu"))
        save_ray_state(tmp_path, shard_rays(state, mesh), mesh=mesh)
    assert torch.equal(restore_ray_state(tmp_path, device="cpu").x, state.x)
    for rank in range(4):
        mesh = RayMesh(4, rank, torch.device("cpu"))
        part = restore_ray_state(tmp_path, shard_rays(state, mesh), mesh=mesh)
        assert torch.equal(part.x, state.x[2 * rank:2 * rank + 2])
    with pytest.raises(FileExistsError):
        save_ray_state(tmp_path, state, force=False)
    save_ray_state(tmp_path, state._replace(x=state.x + 1))
    assert sorted(p.name for p in tmp_path.iterdir()) == ["ray_state.rank0.pt"]
    assert torch.equal(restore_ray_state(
        tmp_path, mesh=RayMesh(2, 1, torch.device("cpu"))).x,
        state.x[4:] + 1)
    with pytest.raises(ValueError, match="do not split"):
        restore_ray_state(tmp_path, mesh=RayMesh(3, 0, torch.device("cpu")))
    (tmp_path / "ray_state.rank0.pt").unlink()
    mesh = RayMesh(2, 1, torch.device("cpu"))
    save_ray_state(tmp_path, shard_rays(state, mesh), mesh=mesh)
    with pytest.raises(ValueError, match="cover rows up to 0"):
        restore_ray_state(tmp_path, device="cpu")


# -- four ranks: the slab ---------------------------------------------------

def test_four_ranks_trace_matches_jax_sharded(four_ranks):
    for prefix, want in (("root", four_ranks["jax_root"]),
                         ("final", four_ranks["jax_final"])):
        errs = _scale_errors(_gather(four_ranks["arrays"], prefix), want)
        assert max(errs.values()) <= 1e-12, (prefix, errs)


def test_four_ranks_match_one_process_bit_for_bit(four_ranks):
    one = four_ranks["one"]
    for prefix in ("root", "final"):
        got = _gather(four_ranks["arrays"], prefix)
        for f, leaf in zip(RayState._fields, one[prefix]):
            assert np.array_equal(got[f], leaf.numpy()), (prefix, f)
    traj = np.concatenate([a["traj_x"] for a in four_ranks["arrays"]],
                          axis=1)
    assert np.array_equal(traj, one["traj_x"])


@pytest.mark.parametrize("case", ["", "nan0_", "nan3_"])
def test_four_ranks_take_one_process_newton_iterations(four_ranks, case):
    """Every rank takes the iterations one process takes; a NaN ray on any
    rank stops every rank where one process stops."""
    counts = [info[f"{case}iterations"] for info in four_ranks["infos"]]
    assert counts == [four_ranks["one"][f"{case}iterations"]] * 4
    if case:
        assert counts[0] == 0
    else:
        assert counts[0] > 1
        # one ensemble max an iteration, and the last test's
        assert [info["newton_all_reduces"] for info in four_ranks["infos"]
                ] == [counts[0] + 1] * 4


def test_four_ranks_restore_the_two_rank_checkpoint(two_ranks, four_ranks):
    got = _gather(four_ranks["arrays"], "restored")
    want = _gather(two_ranks["arrays"], "synthetic")
    assert all(np.array_equal(got[f], want[f]) for f in want)


# -- two ranks: EFIT's production stack and config 5 ---------------------------

@pytest.mark.parametrize("source", SOURCES)
def test_two_ranks_frozen_window_matches_jax(two_ranks, source):
    if source not in two_ranks["efit"]:
        pytest.skip(f"{source} is not present")
    errs = _scale_errors(_gather(two_ranks["arrays"], source),
                         two_ranks["want"][source])
    assert max(errs.values()) <= 1e-10, errs


def test_two_ranks_config5_matches_jax_sharded(two_ranks):
    value, g_psi, g_kz = two_ranks["want"]["c5"]
    for arrays in two_ranks["arrays"]:
        assert abs(float(arrays["c5_value"]) - value) <= 1e-12 * abs(value)
        assert abs(float(arrays["c5_kz"]) - g_kz) <= 1e-10 * abs(g_kz)
        scale = np.abs(g_psi).max()
        assert scale > 0
        assert np.abs(arrays["c5_psi"] - g_psi).max() <= 1e-10 * scale
    # Newton is not on this path: config 5's sums are its one all-reduce
    assert [i["all_reduce_calls"] for i in two_ranks["infos"]] == [1, 1]


def test_host_local_rows_and_output_filenames(two_ranks):
    arrays, infos = two_ranks["arrays"], two_ranks["infos"]
    idx = np.concatenate([a["synthetic_idx"] for a in arrays])
    assert np.array_equal(idx, np.arange(EFIT_RAYS))
    for a in arrays:
        assert np.array_equal(a["synthetic_vals"], a["synthetic_x"])
    assert [i["file"] for i in infos] == ["result0.nc", "result1.nc"]
    assert [i["info"][:2] for i in infos] == [[0, 2], [1, 2]]


def test_two_rank_checkpoint_restores_in_one_process(two_ranks):
    path = two_ranks["out"] / "checkpoint_synthetic"
    assert sorted(p.name for p in path.iterdir()) == [
        "ray_state.rank0.pt", "ray_state.rank1.pt"]
    whole = restore_ray_state(path, device="cpu")
    want = _gather(two_ranks["arrays"], "synthetic")
    assert all(np.array_equal(leaf.numpy(), want[f])
               for f, leaf in zip(RayState._fields, whole))
