"""Explicit Runge-Kutta discretization + forward-mode sensitivities.

Port of `mpc_blaster_tpu/dynamics/integrators.py`: the classic RK4
tableau (acados' 4-stage ERK) with `num_steps` substeps, and (A, B) from
`torch.func.jacfwd` of the whole discrete map.
"""
from __future__ import annotations

from typing import Callable

import torch
from torch.func import jacfwd

Ode = Callable[..., torch.Tensor]  # f(x, u, *args) -> xdot


def rk4_step(f: Ode, x: torch.Tensor, u: torch.Tensor, dt,
             *args) -> torch.Tensor:
    """One classic RK4 step."""
    k1 = f(x, u, *args)
    k2 = f(x + 0.5 * dt * k1, u, *args)
    k3 = f(x + 0.5 * dt * k2, u, *args)
    k4 = f(x + dt * k3, u, *args)
    return x + (dt / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)


def erk_integrate(f: Ode, x: torch.Tensor, u: torch.Tensor, T, *args,
                  num_steps: int = 1) -> torch.Tensor:
    """Integrate over [0, T] with `num_steps` RK4 substeps. `T` may be a
    tensor (the POC solver differentiates through it)."""
    dt = T / num_steps
    for _ in range(num_steps):
        x = rk4_step(f, x, u, dt, *args)
    return x


def discrete_dynamics(f: Ode, dt: float, num_steps: int = 1) -> Callable:
    """Build F(x, u, *args) -> x_next for a fixed shooting interval."""
    def F(x, u, *args):
        return erk_integrate(f, x, u, dt, *args, num_steps=num_steps)
    return F


def discrete_jacobians(F: Callable) -> Callable:
    """Build (x, u, *args) -> (x_next, A, B) with A = dF/dx, B = dF/du.

    One `jacfwd` over both arguments; the primal rides out of the same
    pass as an auxiliary output (the forward-sensitivity ERK analog).
    """
    def FAB(x, u, *args):
        def f(x_, u_):
            y = F(x_, u_, *args)
            return y, y
        (A, B), x_next = jacfwd(f, argnums=(0, 1), has_aux=True)(x, u)
        return x_next, A, B
    return FAB


def rollout(F: Callable, x0: torch.Tensor, us: torch.Tensor, horizon: int,
            *args) -> torch.Tensor:
    """Open-loop rollout of `horizon` steps under the control sequence
    `us` (N, nu): the states (horizon + 1, nx), x0 first."""
    xs = [x0]
    for k in range(horizon):
        xs.append(F(xs[-1], us[k], *args))
    return torch.stack(xs)
