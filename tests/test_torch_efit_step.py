"""The port's freeze-window step against the JAX window kernel.

On the CPU the port's wrapper (``kernels.efit_step.efit_window``) runs its
plain PyTorch version; the JAX side runs the Pallas window kernel
(``make_frozen_window_step``) in interpret mode, as
tests/test_pallas_efit_step.py does.  256 rays, 3 recorded steps x 10
substeps, float64.  Tolerance 1e-10 relative to each leaf group's scale:
both sides freeze the same blocks (test_torch_efit) and step the same
algebra, whose right-hand sides agree to ~1e-14 (test_torch_rays).

The kernel itself only runs on a CUDA card: tests/test_torch_card.py
holds it to the plain version there and skips elsewhere.
"""

import dataclasses
import re

import jax
import pytest
import torch

from graph_framework_tpu.models.dispersion import cold_plasma as jax_cold
from graph_framework_tpu.ops.compensated import (
    comp_state as jax_comp_state, init_comp_carry as jax_init_comp_carry)
from graph_framework_tpu.pallas.efit_step import make_frozen_window_step
from graph_framework_tpu.solver import (
    Solver as JaxSolver, init_k as jax_init_k)
from graph_framework_tpu_torch.kernels import build, efit_step
from graph_framework_tpu_torch.models.dispersion import (
    cold_plasma, gaussian_well, simple, stiff)
from graph_framework_tpu_torch.models.rays import RayState
from graph_framework_tpu_torch.ops.compensated import (
    comp_state, init_comp_carry)
from graph_framework_tpu_torch.solver import Solver, init_k
from test_torch_common import (
    SOURCES, both_states, launch_arrays, leaf_errors, load_both)

DT, SUB_STEPS, STEPS = 1e-4, 10, 3


@pytest.fixture(scope="module", params=SOURCES)
def setup(request, tmp_path_factory):
    jeq, peq = load_both(request.param, tmp_path_factory)
    jstate, pstate = both_states(launch_arrays())
    return (jeq, peq, jax_init_k(jstate, jax_cold, jeq, "kx"),
            init_k(pstate, cold_plasma, peq, "kx"))


def _jax_windows(jeq, jroot, method, k, compensated):
    step = make_frozen_window_step(
        jeq, jax_cold, method=method, dt=DT, sub_steps=SUB_STEPS,
        freeze_every=k, block_rows=2, compensated=compensated,
        interpret=True)

    def go(c):
        def body(c, _):
            return step(c), None
        return jax.lax.scan(body, c, None, length=STEPS)[0]

    carry = jax_init_comp_carry(jroot) if compensated else jroot
    out = jax.jit(go)(carry)
    return jax_comp_state(out) if compensated else out


def _port_windows(peq, proot, method, k, compensated):
    carry = init_comp_carry(proot) if compensated else proot
    for _ in range(STEPS * SUB_STEPS // k):
        carry = efit_step.efit_window(peq, carry, method=method, dt=DT,
                                      steps=k, compensated=compensated)
    return comp_state(carry) if compensated else carry


@pytest.mark.parametrize("compensated", [False, True],
                         ids=["plain", "compensated"])
@pytest.mark.parametrize("k", [1, 5])
@pytest.mark.parametrize("method", ["rk2", "rk4"])
def test_window_step_matches_jax_window_kernel(setup, method, k,
                                               compensated):
    jeq, peq, jroot, proot = setup
    efit_step.efit_window_launches = 0
    got = _port_windows(peq, proot, method, k, compensated)
    want = _jax_windows(jeq, jroot, method, k, compensated)
    errs = leaf_errors(got, want)
    assert max(errs.values()) < 1e-10, errs
    # CPU tensors run the plain version: the kernel was never launched
    assert efit_step.efit_window_launches == 0


def test_solver_window_kernel_end_to_end(setup):
    """Solver(window_kernel=True) against the JAX Solver(pallas_window=
    True), both with the production stack, float64."""
    jeq, peq, jroot, proot = setup
    kw = dict(method="rk2", dt=DT, sub_steps=SUB_STEPS, frozen_cells=True,
              freeze_every=5, compensated=True)
    want = JaxSolver(jax_cold, jeq, pallas_window=True,
                     pallas_block_rows=2, **kw).run(jroot, STEPS)
    efit_step.efit_window_launches = 0
    got = Solver(cold_plasma, peq, window_kernel=True, **kw).run(proot,
                                                                 STEPS)
    errs = leaf_errors(got, want)
    assert max(errs.values()) < 1e-10, errs
    assert efit_step.efit_window_launches == 0
    # and the port's own frozen path gives the same numbers exactly
    same = Solver(cold_plasma, peq, **kw).run(proot, STEPS)
    assert all(torch.equal(a, b) for a, b in zip(got, same))


def test_wrapper_rejects_what_the_kernel_does_not_take(setup):
    _, peq, _, proot = setup
    with pytest.raises(TypeError, match="CompCarry"):
        efit_step.efit_window(peq, proot, method="rk2", dt=DT, steps=2,
                              compensated=True)
    with pytest.raises(TypeError, match="RayState"):
        efit_step.efit_window(peq, init_comp_carry(proot), method="rk2",
                              dt=DT, steps=2, compensated=False)
    leaves = list(proot)
    with pytest.raises(ValueError, match="rk2/rk4"):
        efit_step._check_launch(peq, leaves, "euler", 2)
    with pytest.raises(ValueError, match="positive"):
        efit_step._check_launch(peq, leaves, "rk2", 0)
    with pytest.raises(TypeError, match="float32/float64"):
        efit_step._check_launch(peq, [a.to(torch.float16) for a in leaves],
                                "rk2", 2)
    with pytest.raises(ValueError, match="contiguous 1-D"):
        efit_step._check_launch(peq, [leaves[0][::2]] + leaves[1:], "rk2", 2)
    with pytest.raises(ValueError, match="psi_coeffs"):
        efit_step._check_launch(peq, [a.float() for a in leaves], "rk2", 2)


def test_kernel_params_fold_the_constants(setup):
    """The kernel's frequency factors are constants.py's, and its thermal
    factors models/dispersion.py's, folded in double the same way."""
    from graph_framework_tpu_torch.constants import (
        C, ME, Q, cyclotron_frequency, plasma_frequency_squared)

    _, peq, _, _ = setup
    p = efit_step.kernel_params(peq, DT)
    mi = peq.ion_masses[0]
    assert p[8] == plasma_frequency_squared(1.0, Q, ME)
    assert p[9] == cyclotron_frequency(-Q, 1.0, ME)
    assert p[10] == plasma_frequency_squared(1.0, Q, mi)
    assert p[11] == cyclotron_frequency(Q, 1.0, mi)
    assert p[12] == DT and len(p) == 17
    assert p[13] == peq.pres_scale
    # bohm_gross's vth^2 and _sound_speed2's factors (dispersion.py: _C2)
    assert p[14] == 2.0 * Q / (ME * (C * C))
    assert p[15] == Q / (mi * (C * C))
    assert p[16] == 3.0 * Q / (mi * (C * C))
    assert len(efit_step.kernel_param_array(peq, DT)) == 17


def test_kernel_tails_match_the_sources():
    """KERNEL_TAILS is the CUDA sources' list: GFT_DISPERSIONS
    (csrc/efit_adjoint.cuh) names the same tail structs under the same
    codes, each struct's kReadsEq is its reads_map, and each tail has its
    K1 and K2/K3 instantiation units."""
    csrc = build.CSRC
    text = (csrc / "efit_adjoint.cuh").read_text()
    body = re.search(r"#define GFT_DISPERSIONS\(X\)(.*?)\n\n", text, re.S)[1]
    listed = [(int(code), name)
              for code, name in re.findall(r"X\((\d+), (\w+)\)", body)]
    assert listed == [(code, t.struct)
                      for code, t in enumerate(efit_step.KERNEL_TAILS)]
    for t in efit_step.KERNEL_TAILS:
        flag = re.search(rf"struct {t.struct} {{\s*static constexpr bool "
                         rf"kReadsEq = (true|false)", text)[1]
        assert flag == ("true" if t.reads_map else "false"), t.struct
        suffix = f"_{t.tag}" if t.tag else ""
        k1 = (csrc / f"efit_window{suffix}.cu").read_text()
        bwd = (csrc / f"efit_window_bwd{suffix}.cu").read_text()
        assert f"template int launch<{t.struct}, float>" in k1
        assert f"template int launch_bwd_of<{t.struct}>" in bwd
    assert efit_step.TABLE_FREE == {simple, gaussian_well, stiff}


def test_table_free_tails_keep_the_tables_out_of_autograd(setup):
    """A dispersion that reads no table has no K3: efit_window keeps the
    tables out of the autograd graph (D does not read them), and
    efit_window_vjp refuses ``tables``; a dispersion that reads the map
    takes table gradients."""
    _, peq, _, proot = setup
    psi = peq.psi_coeffs.clone().requires_grad_(True)
    eq = dataclasses.replace(peq, psi_coeffs=psi)
    kw = dict(method="rk2", dt=DT, steps=2, compensated=False)
    out = efit_step.efit_window(eq, proot, dispersion=simple, **kw)
    assert not out.x.requires_grad
    leaves = [a.clone().requires_grad_(True) for a in proot]
    out = efit_step.efit_window(eq, RayState(*leaves), dispersion=simple,
                                **kw)
    grads = torch.autograd.grad(out.kx.sum(), [psi] + leaves,
                                allow_unused=True)
    assert grads[0] is None and grads[1 + 5] is not None
    with pytest.raises(ValueError, match="reads no table"):
        efit_step.efit_window_vjp(eq, proot, proot, method="rk2", dt=DT,
                                  steps=2, tables=True, dispersion=stiff)
    out = efit_step.efit_window(eq, proot, dispersion=cold_plasma, **kw)
    (g,) = torch.autograd.grad(out.x.sum(), [psi])
    assert float(g.abs().max()) > 0
