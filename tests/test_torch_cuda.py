"""The CUDA box-QP IPM kernel against its plain twin, on an NVIDIA GPU.

Needs the card (marker `cuda`; skipped without one) and imports no JAX, so
it also runs where only the port's dependencies are installed:

    python -m pytest --noconftest -o addopts="" tests/test_torch_cuda.py -q

Tolerances as in tests/test_torch_ipm.py: one IPM iteration pointwise (u0
atol 2e-3, dx/du atol 5e-3); the full budget on the QP objective (1.2e-2
relative) and kkt_eq (rtol 0.2 / atol 1e-3), because past a few iterations
f32 rounding moves the weakly determined rotor-thrust split.
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
from mpc_blaster_tpu_torch.sqp.rti import RTIState, build_qp, init_rti_state


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
