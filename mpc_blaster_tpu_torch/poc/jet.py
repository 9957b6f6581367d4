"""Ballistic water-jet model with linear drag — closed form.

Port of `mpc_blaster_tpu/poc/jet.py`. With scalar drag c the jet ODE
p_dot = v, v_dot = -c v + g is linear, so the exact solution replaces the
reference's integrator:

    v(t) = v_inf + (v0 - v_inf) e^{-c t},        v_inf = g / c
    p(t) = p0 + v_inf t + (v0 - v_inf)(1 - e^{-c t}) / c

An RK4 mode is kept to validate the closed form.
"""
from __future__ import annotations

import torch

from mpc_blaster_tpu_torch.core.htm import nozzle_pose
from mpc_blaster_tpu_torch.dynamics.integrators import erk_integrate

GRAVITY = 9.81


def _gravity(like: torch.Tensor) -> torch.Tensor:
    return torch.tensor([0.0, 0.0, -GRAVITY], dtype=like.dtype,
                        device=like.device)


def jet_init_conditions(euler, alpha, position, stream_velocity,
                        convention: str = "htm"):
    """Initial jet state [p_nozzle, v_exit] (6,): the jet leaves the
    nozzle at `stream_velocity` along the nozzle frame's -z axis."""
    euler = torch.as_tensor(euler)
    alpha = torch.as_tensor(alpha)
    position = torch.as_tensor(position)
    p, R = nozzle_pose(euler, alpha, position, convention)
    down = torch.tensor([0.0, 0.0, -1.0], dtype=R.dtype, device=R.device)
    v_exit = R @ down * stream_velocity
    return torch.cat([p, v_exit])


def jet_state(t, init, drag: float):
    """Exact jet state at time t >= 0 from init = [p0, v0]."""
    p0, v0 = init[..., 0:3], init[..., 3:6]
    g = _gravity(init)
    c = drag
    v_inf = g / c
    decay = torch.exp(-c * torch.as_tensor(t, dtype=init.dtype,
                                           device=init.device))
    v = v_inf + (v0 - v_inf) * decay
    p = p0 + v_inf * t + (v0 - v_inf) * (1.0 - decay) / c
    return torch.cat([p, v], dim=-1)


def jet_altitude(t, init, drag: float):
    """z(t), the root function for the time of impact."""
    return jet_state(t, init, drag)[..., 2]


def jet_altitude_rate(t, init, drag: float):
    """dz/dt = v_z(t), the exact Newton derivative."""
    return jet_state(t, init, drag)[..., 5]


def _jet_ode(x, u, drag):
    v = x[3:6]
    return torch.cat([v, -drag * v + _gravity(x)])


def jet_state_rk4(t, init, drag: float, num_steps: int = 10):
    """RK4 reference path (the reference's ERK(4, 10) integrator setup)."""
    u = torch.zeros(0, dtype=init.dtype, device=init.device)
    return erk_integrate(_jet_ode, init, u, t, drag, num_steps=num_steps)
