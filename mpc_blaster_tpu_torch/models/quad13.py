"""13-state quaternion-attitude quadrotor: the second model family.

Port of `mpc_blaster_tpu/models/quad13.py`. A singularity-free 13-state
rigid-body model

    x = [p(3), q(wxyz 4), v(3), omega(3)],  u = [T1..T4]

    p_dot = v
    q_dot = 1/2 q (x) [0, omega]
    v_dot = R(q) e3 (sum T)/m + g
    w_dot = J^-1 (M(T) - w x J w)

running on the same dimension-generic OCP / QP / SQP stack as the 17-state
BLASTER model. Its RTI tick runs every QP backend: "riccati" (the eager
Riccati IPM), "pallas" (the box-QP IPM kernel's 13x4 plain instantiation)
and "pallas_fused" (the one-launch tick, whose prologue runs the "quad13"
rows-form ODE of `dynamics/fastlin.py::FAMILIES`).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from mpc_blaster_tpu_torch import config as cfg
from mpc_blaster_tpu_torch.core.rotations import quat_mul, quat_to_rot
from mpc_blaster_tpu_torch.device import resolve_device
from mpc_blaster_tpu_torch.dynamics.blaster import (BlasterParams, _cross,
                                                    _unit_z)
from mpc_blaster_tpu_torch.dynamics.integrators import discrete_dynamics
from mpc_blaster_tpu_torch.ocp.spec import OCPSpec
from mpc_blaster_tpu_torch.sqp.rti import RTIState, _check_backend, rti_step
from mpc_blaster_tpu_torch.utils import capture

QUAD13_NX = 13
QUAD13_NU = 4


@dataclasses.dataclass(frozen=True)
class Quad13Config:
    mass: float = 9.0
    inertia_diag: Tuple[float, float, float] = (0.50781, 0.47314, 0.72975)
    arm_length_x: float = 0.3434
    arm_length_y: float = 0.3475
    yaw_coefficient: float = 0.03
    gravity: float = 9.81
    N: int = 20
    Tf: float = 20 / 30.0
    q_diag: Tuple[float, ...] = (1e3, 1e3, 1e3,           # position
                                 5e2, 5e2, 5e2, 5e2,      # quaternion
                                 5.0, 5.0, 5.0,           # velocity
                                 1e1, 1e1, 1e1)           # omega
    r_diag: Tuple[float, ...] = (5e-2,) * 4
    thrust_max: float = 65.0
    # state box: position/velocity/rate envelopes; quat box wide open
    pos_bound: float = 5.0
    vel_bound: float = 2.0
    rate_bound: float = 1.0

    @property
    def dt(self) -> float:
        return self.Tf / self.N


def quad13_ode(x: torch.Tensor, u: torch.Tensor, p: torch.Tensor,
               params: BlasterParams) -> torch.Tensor:
    """xdot for one node; `p` is unused (kept for the stage-parameter
    API)."""
    del p
    q = x[3:7]
    v = x[7:10]
    omega = x[10:13]
    thrust = u[0:4]

    qn = q / torch.linalg.norm(q)
    R = quat_to_rot(qn)
    e3 = _unit_z(x)
    zero = torch.zeros_like(params.gravity)
    g_vec = torch.stack([zero, zero, -params.gravity])
    v_dot = R @ (e3 * torch.sum(thrust)) / params.mass + g_vec

    omega_q = torch.cat([torch.zeros(1, dtype=x.dtype, device=x.device),
                         omega])
    q_dot = 0.5 * quat_mul(q, omega_q)

    t1, t2, t3, t4 = thrust[0], thrust[1], thrust[2], thrust[3]
    moments = torch.stack([
        (t2 + t4 - t1 - t3) * params.arm_length_y,
        (-t1 - t4 + t2 + t3) * params.arm_length_x,
        (-t1 - t2 + t3 + t4) * params.yaw_coefficient,
    ])
    J = params.inertia
    omega_dot = (moments - _cross(omega, J * omega)) / J

    return torch.cat([v, q_dot, v_dot, omega_dot])


def _params(c: Quad13Config, dtype=torch.float32, device=None
            ) -> BlasterParams:
    device = resolve_device(device)

    def t(v):
        return torch.as_tensor(v, dtype=dtype, device=device)
    return BlasterParams(
        mass=t(c.mass), inertia=t(c.inertia_diag),
        arm_length_x=t(c.arm_length_x), arm_length_y=t(c.arm_length_y),
        yaw_coefficient=t(c.yaw_coefficient), gravity=t(c.gravity))


def build_quad13_spec(c: Quad13Config, target_pos=(0.0, 0.0, 2.0),
                      dtype=torch.float32, device=None) -> OCPSpec:
    """OCPSpec for hover/waypoint tracking with identity-quat reference."""
    N = c.N
    yref_x = np.zeros((N, QUAD13_NX))
    yref_x[:, 0:3] = np.asarray(target_pos)
    yref_x[:, 3] = 1.0  # identity quaternion
    yref_u = np.zeros((N, QUAD13_NU))
    lbx = np.r_[[-c.pos_bound] * 2, 0.0, [-1.01] * 4,
                [-c.vel_bound] * 3, [-c.rate_bound] * 3]
    ubx = np.r_[[c.pos_bound] * 2, 2 * c.pos_bound, [1.01] * 4,
                [c.vel_bound] * 3, [c.rate_bound] * 3]

    device = resolve_device(device)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float64), dtype=dtype,
                               device=device)
    return OCPSpec(
        Q=t(np.diag(c.q_diag)), R=t(np.diag(c.r_diag)),
        Q_t=t(10.0 * np.diag(c.q_diag)),
        yref_x=t(yref_x), yref_u=t(yref_u), yref_e=t(yref_x[-1]),
        lbx=t(lbx), ubx=t(ubx), lbu=t(np.zeros(QUAD13_NU)),
        ubu=t(np.full(QUAD13_NU, c.thrust_max)),
        stage_params=t(np.zeros((N, 1))), dt=t(c.dt))


def init_quad13_rti_state(c: Quad13Config, x0, dtype=torch.float32,
                          device=None) -> RTIState:
    """Constant-state, hover-thrust initial trajectory; `x0` may carry
    leading batch axes."""
    x0 = torch.as_tensor(x0, dtype=dtype,
                         device=resolve_device(device, x0))
    lead = x0.shape[:-1]
    u_h = torch.full((QUAD13_NU,), c.mass * c.gravity / 4.0, dtype=dtype,
                     device=x0.device)
    return RTIState(
        xbar=x0.unsqueeze(-2).expand(*lead, c.N + 1, QUAD13_NX).clone(),
        ubar=u_h.expand(*lead, c.N, QUAD13_NU).clone())


def quad13_dyn_statics(c: Quad13Config, num_steps: int = 1) -> tuple:
    """Static dynamics tuple for `qp_backend="pallas_fused"` on the
    quaternion family (the packing of `sqp/rti.py::fused_dyn_statics`;
    the kernel's QUAD13 prologue reads the same constants)."""
    return (("quad13", float(c.mass), float(c.gravity),
             float(c.arm_length_x), float(c.arm_length_y),
             float(c.yaw_coefficient), float(c.inertia_diag[0]),
             float(c.inertia_diag[1]), float(c.inertia_diag[2])),
            float(c.dt), int(num_steps))


def make_quad13_rti_step(c: Quad13Config, dtype=torch.float32,
                         jit: bool = True, solver=None, device=None):
    """RTI tick `step(spec, state, x0) -> (u0, state, diag)` on the
    quaternion model, on the solver's QP backend: "riccati" (the eager
    Riccati IPM), "pallas" (one launch of the 13x4 box-QP IPM kernel) or
    "pallas_fused" (one launch of the kernel with the "quad13" prologue:
    linearization, assembly and solve). `lin_backend="fused"` maps to the
    rows-form linearizer on the host path. With `jit` the step is a
    `utils/capture.py` runner (a CUDA graph per shape on the card), as
    `sqp/rti.py::make_rti_step`'s; `jit=False` returns the eager step."""
    params = _params(c, dtype, device)
    F = discrete_dynamics(quad13_ode, c.dt, num_steps=1)
    solver = solver if solver is not None else cfg.SolverConfig()
    _check_backend(solver)
    lin = None
    if solver.lin_backend == "fused":
        from mpc_blaster_tpu_torch.dynamics.fastlin import fast_linearize

        def lin(xbar, ubar, stage_params):
            return fast_linearize(xbar, ubar, stage_params, params, c.dt,
                                  1, family="quad13")
    elif solver.lin_backend != "jacfwd":
        raise ValueError("quad13 supports lin_backend 'jacfwd'/'fused'")
    dyn = (quad13_dyn_statics(c, 1)
           if solver.qp_backend == "pallas_fused" else None)

    def step(spec: OCPSpec, state: RTIState, x0: torch.Tensor):
        return rti_step(spec, state, x0, params, F, solver,
                        linearizer=lin, dyn_statics=dyn)

    return capture.jit(step) if jit else step


def hover_state(z: float = 2.0, dtype=torch.float32,
                device=None) -> torch.Tensor:
    x = torch.zeros(QUAD13_NX, dtype=dtype, device=resolve_device(device))
    x[2] = z
    x[3] = 1.0
    return x
