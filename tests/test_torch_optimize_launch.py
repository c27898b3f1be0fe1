"""examples/optimize_launch_torch.py (the port's launch optimiser) against
the JAX example's computation.

On the synthetic map, with a 5-step trace (the example traces 30): the
miss^2 and its gradient with respect to (ky, kz) at the start (30, 30),
through ``init_k``'s root and the rk4 trace, against ``jax.value_and_grad``
of the JAX example's loss on the same file and target (1e-10 relative,
float64); then 3 iterations of the optimiser lower the miss.
"""

import importlib.util

import jax
import jax.numpy as jnp
import numpy as np
import torch

from conftest import REPO_ROOT
from graph_framework_tpu.models import dispersion as jax_disp
from graph_framework_tpu.solver import Solver as JaxSolver
from graph_framework_tpu.solver import init_k as jax_init_k
from graph_framework_tpu.solver import make_ray_state as jax_make_ray_state
from test_torch_common import load_both

STEPS = 5


def _example():
    spec = importlib.util.spec_from_file_location(
        "optimize_launch_torch",
        REPO_ROOT / "examples" / "optimize_launch_torch.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_first_gradient_matches_jax_and_the_miss_falls(tmp_path_factory):
    ex = _example()
    jeq, peq = load_both("synthetic", tmp_path_factory)
    target = ex.target_of(peq, "synthetic", STEPS)
    loss = ex.make_loss(peq, STEPS, target)
    start = torch.tensor(ex.START, dtype=torch.float64)
    v, g = ex.value_and_grad(loss, start)

    def jax_loss(params):
        st = jax_make_ray_state(1, **ex.LAUNCH, ky=params[0], kz=params[1])
        st = jax_init_k(st, jax_disp.cold_plasma, jeq, "kx",
                        tolerance=1e-22, max_iterations=50)
        fin, _ = JaxSolver(jax_disp.cold_plasma, jeq, method="rk4",
                           dt=ex.DT, sub_steps=ex.SUB_STEPS).trace(st, STEPS)
        d = jnp.stack([fin.x[0], fin.y[0], fin.z[0]]) - jnp.asarray(target)
        return jnp.sum(d * d)

    jv, jg = jax.value_and_grad(jax_loss)(jnp.asarray(ex.START))
    np.testing.assert_allclose(float(v), float(jv), rtol=1e-10)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-10)

    _, history = ex.optimize(loss, start, 3, log=lambda line: None)
    assert len(history) > 1 and history[-1] < history[0]
    assert all(b < a for a, b in zip(history, history[1:]))
