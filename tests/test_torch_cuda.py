"""The CUDA box-QP IPM kernel against its plain twins, on an NVIDIA GPU:
the plain mode (`box_qp_solve`), the fuse_cost mode (`batched_fused_tick`)
and the fuse_lin mode (`fused_rti_solve`), whose linearization prologue is
also held pointwise against `dynamics/fastlin.py::fast_linearize`.

Needs the card (marker `cuda`; skipped without one) and imports no JAX, so
it also runs where only the port's dependencies are installed:

    python -m pytest --noconftest -o addopts="" tests/test_torch_cuda.py -q

Tolerances as in tests/test_torch_ipm.py: one IPM iteration pointwise (u0
atol 2e-3, dx/du atol 5e-3); the full budget on the QP objective (1.2e-2
relative) and kkt_eq (rtol 0.2 / atol 1e-3), because past a few iterations
f32 rounding moves the weakly determined rotor-thrust split. The fused
modes' step norms and bound violation: rtol 0.05 / atol 1e-3
(tests/test_batched_fused.py). The prologue's A, B and c: rtol and atol
2e-4 (tests/test_fastlin.py's float32 bound; dual-number rounding is not
jvp's).
"""
import dataclasses

import numpy as np
import pytest
import torch
from torch.func import vmap

from mpc_blaster_tpu_torch import config as cfg
from mpc_blaster_tpu_torch.dynamics.blaster import BlasterParams, blaster_ode
from mpc_blaster_tpu_torch.dynamics.integrators import discrete_dynamics
from mpc_blaster_tpu_torch.ocp.spec import build_spec
from mpc_blaster_tpu_torch.ops import box_qp_ipm as K
from mpc_blaster_tpu_torch.qp.data import qp_objective
from mpc_blaster_tpu_torch.sqp.rti import (RTIState, build_qp,
                                           fused_dyn_statics, init_rti_state)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


def _blaster_qps(dev, B=3, N=8):
    """Linearized BLASTER QPs at different states, built by the port on
    `dev` (the construction of tests/test_torch_ipm.py)."""
    pre = cfg.simulation_preset()
    ocp = dataclasses.replace(pre.ocp, N=N, Tf=N / 30.0)
    spec = build_spec(ocp, yref=pre.loop.yref, device=dev)
    rng = np.random.default_rng(0)
    x0s = np.zeros((B, cfg.NX), np.float32)
    x0s[:, 0:3] = rng.uniform(-0.4, 0.4, (B, 3))
    x0s[:, 2] = rng.uniform(1.5, 3.4, B)
    x0 = torch.as_tensor(x0s, device=dev)
    st = init_rti_state(ocp, x0)
    F = discrete_dynamics(blaster_ode, ocp.dt)
    P = BlasterParams.from_config(ocp.model, device=dev)
    return vmap(lambda xb, ub, x: build_qp(spec, RTIState(xb, ub), x, F, P))(
        st.xbar, st.ubar, x0)


@pytest.mark.cuda
@pytest.mark.parametrize("iters", [1, 10])
def test_kernel_matches_plain_on_gpu(cuda_device, iters):
    qp = _blaster_qps(cuda_device)
    n0 = K.box_qp_solve.launches
    sk = K.box_qp_solve(qp, iters=iters)
    torch.cuda.synchronize()
    assert K.box_qp_solve.launches == n0 + 1
    sp = K.box_qp_solve_plain(qp, iters=iters)
    assert torch.isfinite(sk.dx).all() and torch.isfinite(sk.du).all()
    if iters == 1:
        assert (sk.du[:, 0] - sp.du[:, 0]).abs().max().item() <= 2e-3
        torch.testing.assert_close(sk.du, sp.du, rtol=0, atol=5e-3)
        torch.testing.assert_close(sk.dx, sp.dx, rtol=0, atol=5e-3)
        return
    ok = vmap(qp_objective)(qp, sk.dx, sk.du)
    op = vmap(qp_objective)(qp, sp.dx, sp.du)
    assert ((ok - op).abs() / op.abs().clamp(min=1.0) < 1.2e-2).all(), (ok, op)
    torch.testing.assert_close(sk.kkt_eq, sp.kkt_eq, rtol=0.2, atol=1e-3)


def _fused_inputs(dev, B=3, N=8):
    """A perturbed hover iterate with its fused-tick arguments, on `dev`:
    (ocp, spec, xbar, ubar, x0, the ten spec arguments broadcast to B)."""
    pre = cfg.simulation_preset()
    ocp = dataclasses.replace(pre.ocp, N=N, Tf=N / 30.0)
    spec = build_spec(ocp, yref=pre.loop.yref, device=dev)
    rng = np.random.default_rng(1)
    x0s = np.zeros((B, cfg.NX), np.float32)
    x0s[:, 0:3] = rng.uniform(-0.4, 0.4, (B, 3))
    x0s[:, 2] += 2.0
    x0 = torch.as_tensor(x0s, device=dev)
    st = init_rti_state(ocp, x0)
    # inside the boxes, as the main path's iterates are
    xbar = st.xbar + torch.as_tensor(
        rng.uniform(-0.02, 0.02, st.xbar.shape), dtype=torch.float32,
        device=dev)
    du = np.zeros(st.ubar.shape, np.float32)
    du[..., 0:4] = rng.uniform(-0.5, 0.5, du[..., 0:4].shape)
    ubar = st.ubar + torch.as_tensor(du, device=dev)

    def bc(a):
        return a.expand(B, *a.shape)
    args = (bc(spec.dt * spec.Q), bc(spec.Q_t), bc(spec.dt * spec.R),
            bc(spec.yref_x), bc(spec.yref_u), bc(spec.yref_e),
            bc(spec.lbx), bc(spec.ubx), bc(spec.lbu), bc(spec.ubu))
    return ocp, spec, xbar, ubar, x0, args


def _fused_qp(f_args, A, Bm, c):
    """The QP the fused modes assemble, for the objective comparison."""
    xbar, ubar, x0, args = f_args
    return K._fused_qp(K._fused_prep(xbar, ubar, x0, *args, None), A, Bm, c)


@pytest.mark.cuda
@pytest.mark.parametrize("iters", [1, 6])
def test_fuse_cost_kernel_matches_plain_on_gpu(cuda_device, iters):
    from mpc_blaster_tpu_torch.dynamics.fastlin import fast_linearize
    ocp, spec, xbar, ubar, x0, args = _fused_inputs(cuda_device)
    P = BlasterParams.from_config(ocp.model, device=cuda_device)
    xp, A, Bm = fast_linearize(xbar, ubar, spec.stage_params, P, ocp.dt)
    AB, c = torch.cat([A, Bm], -1), xp - xbar[:, 1:]
    n0 = K.batched_fused_tick.launches
    xk, uk, dk, _ = K.batched_fused_tick(AB, c, xbar, ubar, x0, *args,
                                         iters=iters)
    torch.cuda.synchronize()
    assert K.batched_fused_tick.launches == n0 + 1
    xp_, up_, dp_, _ = K.batched_fused_tick_plain(AB, c, xbar, ubar, x0,
                                                  *args, iters=iters)
    assert torch.isfinite(xk).all() and torch.isfinite(uk).all()
    if iters == 1:
        assert (uk[:, 0] - up_[:, 0]).abs().max().item() <= 2e-3
        torch.testing.assert_close(xk, xp_, rtol=0, atol=5e-3)
        torch.testing.assert_close(uk, up_, rtol=0, atol=5e-3)
    else:
        qp = _fused_qp((xbar, ubar, x0, args), A, Bm, c)
        ok = vmap(qp_objective)(qp, xk - xbar, uk - ubar)
        op = vmap(qp_objective)(qp, xp_ - xbar, up_ - ubar)
        assert ((ok - op).abs() / op.abs().clamp(min=1.0) < 1.2e-2).all()
    torch.testing.assert_close(dk["kkt_eq"], dp_["kkt_eq"], rtol=0.2,
                               atol=1e-3)
    for f in ("step_norm_x", "step_norm_u", "bound_viol"):
        torch.testing.assert_close(dk[f], dp_[f], rtol=0.05, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("iters", [1, 6])
def test_fuse_lin_kernel_matches_plain_on_gpu(cuda_device, iters):
    ocp, spec, xbar, ubar, x0, args = _fused_inputs(cuda_device, B=1)
    model, dt, nsteps = fused_dyn_statics(ocp)
    sp = spec.stage_params[None]
    n0 = K.fused_rti_solve.launches
    sk, (Ak, Bk, ck) = K.fused_rti_solve(
        xbar, ubar, sp, x0, *args, model=model, dt=dt, num_steps=nsteps,
        iters=iters, return_lin=True)
    torch.cuda.synchronize()
    assert K.fused_rti_solve.launches == n0 + 1
    spl, (Ap, Bp, cp) = K.fused_rti_solve_plain(
        xbar, ubar, sp, x0, *args, model=model, dt=dt, num_steps=nsteps,
        iters=iters, return_lin=True)
    # the prologue against fast_linearize, pointwise
    for g, r in ((Ak, Ap), (Bk, Bp), (ck, cp)):
        torch.testing.assert_close(g, r, rtol=2e-4, atol=2e-4)
    assert torch.isfinite(sk.dx).all() and torch.isfinite(sk.du).all()
    if iters == 1:
        assert (sk.du[:, 0] - spl.du[:, 0]).abs().max().item() <= 2e-3
        torch.testing.assert_close(sk.du, spl.du, rtol=0, atol=5e-3)
        torch.testing.assert_close(sk.dx, spl.dx, rtol=0, atol=5e-3)
    else:
        qp = _fused_qp((xbar, ubar, x0, args), Ap, Bp, cp)
        ok = vmap(qp_objective)(qp, sk.dx, sk.du)
        op = vmap(qp_objective)(qp, spl.dx, spl.du)
        assert ((ok - op).abs() / op.abs().clamp(min=1.0) < 1.2e-2).all()
    torch.testing.assert_close(sk.kkt_eq, spl.kkt_eq, rtol=0.2, atol=1e-3)
