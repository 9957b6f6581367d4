"""Point-of-contact solve + Jacobians, differentiable end to end.

Port of `mpc_blaster_tpu/poc/solver.py`:

  - time of impact: Newton with the exact derivative dz/dT = v_z(T) on
    the closed-form jet, a fixed iteration budget, the |v_z| >= 1e-6
    guard and the reference's reflection of negative iterates;
  - Jacobians: one `torch.func.jacfwd` through the whole solve.
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch.func import jacfwd

from mpc_blaster_tpu_torch import config as cfg
from mpc_blaster_tpu_torch.poc.jet import (
    jet_altitude,
    jet_altitude_rate,
    jet_init_conditions,
    jet_state,
)


def time_of_impact(init: torch.Tensor, drag: float, t0: float = 0.1,
                   iters: int = 12) -> torch.Tensor:
    """Newton solve for T with z(T) = 0 from the 0.1 initial guess; the
    negative-iterate reflection keeps it on the positive root."""
    t = torch.as_tensor(t0, dtype=init.dtype, device=init.device)
    for _ in range(iters):
        f = jet_altitude(t, init, drag)
        fp = jet_altitude_rate(t, init, drag)
        # Guard |v_z| >= 1e-6 against division blow-up near apogee.
        fp = torch.where(torch.abs(fp) < 1e-6,
                         torch.where(fp < 0, -1e-6, 1e-6), fp)
        t = torch.abs(t - f / fp)
    return t


def solve_poc(euler: torch.Tensor, alpha: torch.Tensor,
              position: torch.Tensor, stream_velocity: float = 150.0,
              drag: float = 1.0, iters: int = 12, convention: str = "htm"):
    """(poc (3,), T_impact) for a vehicle pose + gimbal configuration."""
    init = jet_init_conditions(euler, alpha, position, stream_velocity,
                               convention)
    T = time_of_impact(init, drag, iters=iters)
    poc = jet_state(T, init, drag)[0:3]
    return poc, T


def poc_jacobians(euler: torch.Tensor, alpha: torch.Tensor,
                  position: torch.Tensor, stream_velocity: float = 150.0,
                  drag: float = 1.0, iters: int = 12,
                  convention: str = "htm") -> Tuple[torch.Tensor, ...]:
    """(J_mot (3,2), J_eul (3,3), J_pos (3,3)) = dPOC/d(alpha, euler,
    position), from one forward-mode pass per argument group."""
    def poc_only(a, e, p):
        return solve_poc(e, a, p, stream_velocity, drag, iters,
                         convention)[0]

    j_mot, j_eul, j_pos = jacfwd(poc_only, argnums=(0, 1, 2))(
        alpha, euler, position)
    return j_mot, j_eul, j_pos


class PocSolver:
    """Object-style facade with the reference class's workflow: construct
    with (stream velocity, drag, Ts); `initialise()` computes the
    Jacobians at the canonical pose (zero angles, z=4). Runs in float64
    on the host, as the JAX package's tests run it."""

    def __init__(self, stream_velocity: float = 150.0, drag: float = 1.0,
                 ts: float = 1.5e-5, newton_iters: int = 12,
                 convention: str = "htm"):
        del ts  # the closed-form path needs no integrator step size
        self._stream_velocity = float(stream_velocity)
        self._drag = float(drag)
        self._iters = int(newton_iters)
        self._convention = convention
        z, f64 = torch.zeros, torch.float64
        self._poc = z(3, dtype=f64)
        self._T = z((), dtype=f64)
        self._j_mot = z((3, 2), dtype=f64)
        self._j_eul = z((3, 3), dtype=f64)
        self._j_pos = z((3, 3), dtype=f64)

    @classmethod
    def from_config(cls, c: cfg.PocSolverConfig) -> "PocSolver":
        return cls(c.stream_velocity, c.drag, newton_iters=c.newton_iters)

    def initialise(self):
        """Jacobians at the reference's canonical pose."""
        self.solve_jacobians([0.0, 0.0, 0.0], [0.0, 0.0], [0.0, 0.0, 4.0])
        return self

    def solve_jacobians(self, euler, alpha, position):
        def t(v):
            return torch.as_tensor(v, dtype=torch.float64)
        euler, alpha, position = t(euler), t(alpha), t(position)
        self._poc, self._T = solve_poc(
            euler, alpha, position, self._stream_velocity, self._drag,
            self._iters, self._convention)
        self._j_mot, self._j_eul, self._j_pos = poc_jacobians(
            euler, alpha, position, self._stream_velocity, self._drag,
            self._iters, self._convention)
        return self._j_mot, self._j_eul, self._j_pos

    def get_jacobians(self):
        """(J_mot, J_eul, J_pos), the reference's getter ordering."""
        return self._j_mot, self._j_eul, self._j_pos

    @property
    def poc(self):
        return self._poc

    @property
    def time_of_impact(self):
        return self._T
