"""The port's endpoint gradients against the independent referee.

tests/test_reference_parity.py's ``test_endpoint_gradients_match_referee``
for the port: d(endpoint x, y, z) / d(launch parameter) of one ray, by
reverse mode through the port's autograd over the whole rk4 trace (2000
steps for configs 1, 2 and 2b), against the referee's central differences
over full re-integrations (tests/fixtures/golden_*.npz), at the JAX
test's tolerances: rtol 2e-4 of each component and of the gradient's
scale for the analytic configs, 2e-3 for the spline ones.

The three rows of the Jacobian come from one backward pass: three copies
of the ray, copy i's endpoint coordinate i summed into the loss, each
copy with its own launch leaves (w, position, wave vector), so copy i's
leaf gradients are row i.  Config 3 reads ``efit.nc`` and config 4
``vmec.nc``: their legs skip where the file is absent.
"""

import numpy as np
import pytest
import torch

import test_torch_referee as referee
from graph_framework_tpu_torch.solver import make_ray_state

CASES = [
    ("golden_config1_omode_slab", "grad_k_0"),
    ("golden_config1_omode_slab", "grad_p_0"),
    ("golden_config1_omode_slab", "grad_w"),
    ("golden_config2_xmode_slab", "grad_k_0"),
    ("golden_config2_bohm_gross", "grad_k_0"),
    ("golden_config3_efit", "grad_k_0"),
    ("golden_config3_efit", "grad_p_2"),
    ("golden_config4_vmec", "grad_k_0"),
    ("golden_config4_vmec", "grad_p_0"),
]

_JACOBIANS = {}


def endpoint_jacobian(name):
    """{"w": (3,), "p": (3, 3), "k": (3, 3)}: d(endpoint coordinate i) /
    d(launch w, position j, wave vector j) of the fixture's first ray,
    over its gradient horizon, by one backward pass (module docstring)."""
    if name not in _JACOBIANS:
        gold = referee.load(name)
        t_grad = float(gold.get("t_grad", gold["t_record"][-1]))
        sol, _, _ = referee.solver_for(name, gold, horizon=t_grad)
        w = torch.full((3,), float(gold["w"]), dtype=torch.float64,
                       requires_grad=True)
        p = torch.from_numpy(np.tile(gold["p_launch"][0], (3, 1))
                             ).requires_grad_(True)
        k = torch.from_numpy(np.tile(gold["k_init"][0], (3, 1))
                             ).requires_grad_(True)
        st = make_ray_state(3, w=w, x=p[:, 0], y=p[:, 1], z=p[:, 2],
                            kx=k[:, 0], ky=k[:, 1], kz=k[:, 2],
                            dtype=torch.float64, device="cpu")
        fin = sol.run(st, 1)
        loss = fin.x[0] + fin.y[1] + fin.z[2]
        gw, gp, gk = torch.autograd.grad(loss, [w, p, k])
        _JACOBIANS[name] = {"w": gw.numpy(), "p": gp.numpy(),
                            "k": gk.numpy()}
    return _JACOBIANS[name]


@pytest.mark.parametrize("name,key", CASES)
def test_endpoint_gradients_match_referee(name, key):
    gold = referee.load(name)
    jac = endpoint_jacobian(name)
    if key == "grad_w":
        ours = jac["w"]
    else:
        ours = jac[key.split("_")[1]][:, int(key.split("_")[-1])]
    scale = float(np.abs(gold[key]).max())
    spline_cfg = not name.startswith(("golden_config1", "golden_config2"))
    rtol = 2e-3 if spline_cfg else 2e-4
    np.testing.assert_allclose(ours, gold[key], rtol=rtol,
                               atol=rtol * scale)
