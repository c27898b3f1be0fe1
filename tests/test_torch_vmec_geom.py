"""K4, the fused VMEC geometry jet: its plain version and autograd Function.

On the CPU the wrapper runs the plain version (``reference_jet``), which
is held here to the JAX package: in float64 to ``jax.jacfwd`` of the JAX
package's default geometry ``_rzl_and_jac`` (1e-10 of each sum's scale:
two frameworks rounding the same arithmetic), and in float32 to the JAX
kernel itself in Pallas interpret mode (``make_fused_geometry``).  The JAX
kernel fetches its tables as three bf16 words and reduces its angles by
Cody-Waite before the trig; both differ from the port's plain f32
arithmetic in the last bits, and over sums of 90 modes weighted by up to
xn^2 = 400 that reads about 1e-6 of each sum's scale (``F32_TOL`` = 2e-5).
The kernel itself is held to this plain version on the card
(``tests/test_torch_card.py``, ``chip_smoke.py`` phase 14).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from graph_framework_tpu.models.vmec import _rzl_and_jac as jax_rzl_and_jac
from graph_framework_tpu.models.vmec import make_vmec as jax_make_vmec
from graph_framework_tpu.pallas.vmec_geom import make_fused_geometry
from graph_framework_tpu_torch.convert import vmec_from_numpy
from graph_framework_tpu_torch.kernels import vmec_geom
from graph_framework_tpu_torch.models.dispersion import cold_plasma
from graph_framework_tpu_torch.models.rays import make_ray_rhs
from graph_framework_tpu_torch.solver import Solver, init_k, make_ray_state
from test_torch_vmec import KNOTS, vmec_file

F64_TOL = 1.0e-10
F32_TOL = 2.0e-5


@pytest.fixture(scope="module")
def path(tmp_path_factory):
    return vmec_file(tmp_path_factory)


def _coords(n, seed, lo=0.05, hi=0.95):
    rng = np.random.default_rng(seed)
    return (rng.uniform(lo, hi, n), rng.uniform(0.0, 6.28, n),
            rng.uniform(0.0, 6.28, n))


def _scaled(got, want):
    """Per sum: max |got - want| / max |want|."""
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    return [float(np.max(np.abs(g - w)) / max(np.max(np.abs(w)), 1e-300))
            for g, w in zip(got, want)]


def _jax_jet(jeq, s, u, v):
    """The 27 sums from JAX's default geometry: the 10 values and, by
    forward mode per coordinate, the second partials of the nine first
    derivatives (rays are independent, so a tangent of ones gives each
    ray's own partial)."""
    def first(s_, u_, v_):
        (r, z, _), (dr, dz, dl) = jax_rzl_and_jac(jeq, s_, u_, v_)
        return (r, z, *dr, *dz, *dl)

    ones, zeros = jnp.ones_like(s), jnp.zeros_like(s)
    d = [jax.jvp(first, (s, u, v), t)[1]
         for t in ((ones, zeros, zeros), (zeros, ones, zeros),
                   (zeros, zeros, ones))]
    out = first(s, u, v)
    # first: r z drs dru drv dzs dzu dzv dls dlu dlv -> jet order
    ten = [out[i] for i in (0, 1, 2, 3, 4, 5, 6, 7, 9, 10)]
    ds_, du_, dv_ = d
    second = [ds_[2], ds_[3], ds_[4], du_[3], du_[4], dv_[4],
              ds_[5], ds_[6], ds_[7], du_[6], du_[7], dv_[7],
              ds_[9], ds_[10], du_[9], du_[10], dv_[10]]
    return ten + second


def test_plain_jet_matches_jacfwd_of_jax_geometry(path):
    jeq = jax_make_vmec(path, dtype=jnp.float64)
    peq = vmec_from_numpy(jeq, device="cpu")
    s, u, v = _coords(97, seed=0, lo=-1.05, hi=1.05)
    s[:4] = [-1.0, 1.0, -0.4, 0.0]     # table edges and a cell edge
    got = vmec_geom.reference_jet(
        *[torch.from_numpy(a) for a in (s, u, v)],
        vmec_geom.jet_tables(peq))
    want = _jax_jet(jeq, *[jnp.asarray(a) for a in (s, u, v)])
    errs = _scaled(got, want)
    assert max(errs) < F64_TOL, dict(zip(vmec_geom.JET_NAMES, errs))


def test_plain_jet_matches_jax_kernel_f32(path):
    """The port's f32 plain version against the JAX kernel in interpret
    mode (with this file's 20 cells the JAX kernel's 128-cell radial cut
    keeps the whole table)."""
    jeq = jax_make_vmec(path, dtype=jnp.float32)
    peq = vmec_from_numpy(jeq, dtype=torch.float32, device="cpu")
    s, u, v = [a.astype(np.float32) for a in _coords(193, seed=1)]
    want = make_fused_geometry(jeq, block=64, interpret=True)(
        *[jnp.asarray(a) for a in (s, u, v)])
    got = vmec_geom.reference_jet(
        *[torch.from_numpy(a) for a in (s, u, v)],
        vmec_geom.jet_tables(peq))[:10]
    errs = _scaled(got, want)
    assert max(errs) < F32_TOL, dict(zip(vmec_geom.JET_NAMES, errs))


@pytest.mark.parametrize("dtype, tol", [(torch.float64, 1e-13),
                                        (torch.float32, 2e-6)],
                         ids=["f64", "f32"])
def test_function_vjp_matches_autograd_of_plain_jet(dtype, tol):
    """FusedGeometry's backward (the jet contracted with JVP_IDX) against
    autograd of the plain version's first ten sums, seeded cotangents;
    this checks every entry and sign of the Hessian index table."""
    eq = chip_smoke.synthetic_vmec(dtype, "cpu", knots=KNOTS)
    tables = vmec_geom.jet_tables(eq)
    rng = np.random.default_rng(2)
    s, u, v = [torch.from_numpy(a).to(dtype).requires_grad_(True)
               for a in _coords(67, seed=3)]
    cts = [torch.from_numpy(rng.standard_normal(67)).to(dtype)
           for _ in range(10)]
    got = torch.autograd.grad(vmec_geom.FusedGeometry.apply(s, u, v, tables),
                              [s, u, v], cts)
    ref = vmec_geom.reference_jet(s, u, v, tables)[:10].unbind(0)
    want = torch.autograd.grad(ref, [s, u, v], cts)
    assert max(_scaled(torch.stack(got), torch.stack(want))) < tol


def _pair(dtype=torch.float32):
    eq = chip_smoke.synthetic_vmec(dtype, "cpu", knots=KNOTS)
    return eq, dataclasses.replace(eq, fused_mode_sums=True)


def _rhs_fused_against_unfused(eq, eqf, **options):
    st = make_ray_state(33, w=900.0, x=0.5, y=0.5, z=0.1, kx=54.6, ky=3.0,
                        kz=2.0, dtype=torch.float32, device="cpu")
    d0 = make_ray_rhs(cold_plasma, eq, **options)(st)
    d1 = make_ray_rhs(cold_plasma, eqf, **options)(st)
    for a, b, name in zip(d0, d1, d0._fields):
        scale = max(1.0, float(a.abs().max()))
        assert float((a - b).abs().max()) <= 1e-5 * scale, name


def test_fused_rhs_matches_unfused():
    """The ray RHS fused against unfused, f32; the pattern of
    test_pallas_vmec_geom.py, whose 5e-4 tolerance covers the JAX kernel's
    bf16 words.  The fused side is the main path's value RHS: K4's plain
    jet and K8's plain version (``kernels.vmec_rhs.ray_rhs_plain``); the
    eager fused route is held by the test after this one."""
    _rhs_fused_against_unfused(*_pair())


@pytest.mark.parametrize("option", ["quirky_chi", "reference_correction"])
def test_fused_geometry_backward_rhs_matches_unfused(option):
    """test_fused_rhs_matches_unfused on the eager fused route, which
    ``quirky_chi`` and ``reference_correction`` keep: autograd through the
    geometry, FusedGeometry's backward in the composition of
    ``make_ray_rhs``.  The two differ by the f32 rounding of the
    geometry's sums, read 3.7e-7 (quirky_chi) and 7.0e-7 of each
    derivative's scale."""
    eq, eqf = _pair()
    if option == "quirky_chi":
        _rhs_fused_against_unfused(dataclasses.replace(eq, quirky_chi=True),
                                   dataclasses.replace(eqf, quirky_chi=True))
    else:
        _rhs_fused_against_unfused(eq, eqf, reference_correction=True)


def _trace_fused_against_default(eq, eqf):
    st = init_k(make_ray_state(8, w=900.0, x=0.5, y=0.5, z=0.0, kx=500.0,
                               dtype=torch.float32, device="cpu"),
                cold_plasma, eqf)
    f0 = Solver(cold_plasma, eq, method="rk4", dt=2e-7, sub_steps=5).run(st, 3)
    f1 = Solver(cold_plasma, eqf, method="rk4", dt=2e-7,
                sub_steps=5).run(st, 3)
    for a, b, name in zip(f0, f1, f0._fields):
        scale = max(1.0, float(a.abs().max()))
        assert float((a - b).abs().max()) <= 1e-4 * scale, name


def test_fused_trace_matches_default():
    """test_pallas_vmec_geom.py's short rk4 trace (dt 2e-7, 5 substeps, 3
    recorded steps, f32) from init_k's root, to its tolerance (1e-4 of
    each leaf's scale).  The fused trace's RHS is K4's plain jet and K8's
    plain version."""
    _trace_fused_against_default(*_pair())


def test_fused_geometry_backward_trace_matches_default():
    """test_fused_trace_matches_default with ``quirky_chi``, whose fused
    trace keeps the eager RHS through FusedGeometry's backward."""
    eq, eqf = _pair()
    _trace_fused_against_default(dataclasses.replace(eq, quirky_chi=True),
                                 dataclasses.replace(eqf, quirky_chi=True))


def test_fused_routing(monkeypatch):
    """K4 serves exactly the JAX package's condition: fused_mode_sums,
    cell-local tables, (rays,) coordinates, float32."""
    calls = []
    plain = vmec_geom.reference_jet

    def counted(*args):
        calls.append(args[0].shape)
        return plain(*args)

    monkeypatch.setattr(vmec_geom, "reference_jet", counted)
    eq32, eqf32 = _pair()
    _, eqf64 = _pair(torch.float64)
    pos32 = torch.tensor([[0.5, 0.6], [0.5, 0.4], [0.1, 0.2]])
    for eq, pos, fused in ((eqf32, pos32, True), (eq32, pos32, False),
                           (eqf64, pos32.double(), False),
                           (eqf32, pos32[:, 0], False),
                           (dataclasses.replace(eqf32, cell_local=False),
                            pos32, False)):
        calls.clear()
        eq.magnetic_field(pos)
        assert calls == ([(2,)] if fused else []), fused


def test_second_derivative_and_table_gradients_raise():
    """A backward that would be differentiated again raises (its (s, u, v)
    derivative needs the jet's third order), as grad-of-grad does on the
    JAX kernel; so does a table that requires grad."""
    _, eqf = _pair()
    s, u, v = [torch.tensor([0.5, 0.6], requires_grad=True)
               for _ in range(3)]
    out = vmec_geom.fused_geometry(eqf, s, u, v)
    with pytest.raises(RuntimeError, match="differentiable once"):
        torch.autograd.grad(out[3].sum(), [s], create_graph=True)
    st = make_ray_state(2, w=900.0, x=0.5, y=0.5, kx=99.0,
                        dtype=torch.float32, device="cpu")
    st = st._replace(x=st.x.clone().requires_grad_(True))
    with pytest.raises(RuntimeError, match="differentiable once"):
        make_ray_rhs(cold_plasma, eqf)(st)
    rmnc = eqf.rmnc_coeffs.clone().requires_grad_(True)
    with pytest.raises(ValueError, match="constants"):
        vmec_geom.fused_geometry(
            dataclasses.replace(eqf, rmnc_coeffs=rmnc), s, u, v)


def test_wrapper_refuses():
    eq, _ = _pair()
    tables = vmec_geom.jet_tables(eq)
    s = torch.tensor([0.5, 0.6])
    with pytest.raises(ValueError, match="one dtype and device"):
        vmec_geom.geometry_jet(s, s.double(), s, tables)
    with pytest.raises(ValueError, match="tables must be"):
        vmec_geom.geometry_jet(s, s, s, tables._replace(
            xm=tables.xm[:-1].contiguous()))
    before = vmec_geom.vmec_geom_launches
    assert vmec_geom.geometry_jet(s, s, s, tables).shape == (27, 2)
    assert vmec_geom.vmec_geom_launches == before
