"""Point-of-contact solve + Jacobians, differentiable end to end.

Port of `mpc_blaster_tpu/poc/solver.py`:

  - time of impact: Newton with the exact derivative dz/dT = v_z(T) on
    the closed-form jet, a fixed iteration budget, the |v_z| >= 1e-6
    guard and the reference's reflection of negative iterates;
  - Jacobians: one `torch.func.jacfwd` through the whole solve, the
    value riding the same pass where a caller needs both
    (`poc_value_and_jacobians`), forward differences for parity with the
    reference's procedure (`poc_jacobians_fd`);
  - `torch.func.vmap` over poses: the true impact points along a
    trajectory (`true_poc_traj`) and the per-stage parameters of the
    online POC modes (`poc_stage_params_along`).
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch.func import jacfwd, vmap

from mpc_blaster_tpu_torch import config as cfg
from mpc_blaster_tpu_torch.dynamics.blaster import pack_stage_params
from mpc_blaster_tpu_torch.poc.jet import jet_init_conditions, jet_state


def time_of_impact(init: torch.Tensor, drag: float, t0: float = 0.1,
                   iters: int = 12) -> torch.Tensor:
    """Newton solve for T with z(T) = 0 from the 0.1 initial guess; the
    negative-iterate reflection keeps it on the positive root."""
    t = torch.full((), t0, dtype=init.dtype, device=init.device)
    for _ in range(iters):
        s = jet_state(t, init, drag)
        f, fp = s[..., 2], s[..., 5]
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


def poc_value_and_jacobians(euler: torch.Tensor, alpha: torch.Tensor,
                            position: torch.Tensor,
                            stream_velocity: float = 150.0,
                            drag: float = 1.0, iters: int = 12,
                            convention: str = "htm"):
    """(poc (3,), J_mot, J_eul, J_pos) in one forward pass: the POC value
    rides the Jacobians' jacfwd as its auxiliary output, so no second
    Newton solve runs."""
    def f(a, e, p):
        poc = solve_poc(e, a, p, stream_velocity, drag, iters,
                        convention)[0]
        return poc, poc

    (j_mot, j_eul, j_pos), poc = jacfwd(f, argnums=(0, 1, 2),
                                        has_aux=True)(alpha, euler, position)
    return poc, j_mot, j_eul, j_pos


def poc_jacobians_fd(euler, alpha, position, stream_velocity=150.0,
                     drag=1.0, iters: int = 12, convention: str = "htm",
                     eps: float = 1e-6):
    """The reference's forward differences (eps=1e-6), in the dtype of
    the inputs (float64 for Python numbers), to validate the autodiff
    path."""
    def t(v):
        if isinstance(v, torch.Tensor) and v.is_floating_point():
            return v
        return torch.as_tensor(v, dtype=torch.float64)
    euler, alpha, position = t(euler), t(alpha), t(position)

    def poc_at(e, a, p):
        return solve_poc(e, a, p, stream_velocity, drag, iters,
                         convention)[0]

    poc0 = poc_at(euler, alpha, position)

    def cols(arg_idx):
        args = [euler, alpha, position]
        base = args[arg_idx]
        out = []
        for i in range(base.shape[-1]):
            step = torch.zeros_like(base)
            step[i] = eps
            args[arg_idx] = base + step
            out.append((poc_at(*args) - poc0) / eps)
        return torch.stack(out, dim=1)

    return cols(1), cols(0), cols(2)


def true_poc_traj(xs: torch.Tensor, stream_velocity: float = 150.0,
                  drag: float = 1.0, iters: int = 12,
                  convention: str = "htm") -> torch.Tensor:
    """The true nonlinear jet impact points (T, 3) along a state
    trajectory xs (T, nx) (euler x[3:6], gimbal x[12:14], position
    x[0:3]): the physical ground truth the linearized POC belief
    x[14:17] is judged against. One vmapped solve over the poses."""
    return vmap(lambda x: solve_poc(x[3:6], x[12:14], x[0:3],
                                    stream_velocity, drag, iters,
                                    convention)[0])(xs)


def poc_stage_params(x: torch.Tensor, t_blast: torch.Tensor,
                     pc: cfg.PocSolverConfig) -> torch.Tensor:
    """The 25 stage parameters of the POC rows linearized at the pose of
    state x (the Jacobians in x's dtype, T_blast kept)."""
    return pack_stage_params(*poc_jacobians(
        x[3:6], x[12:14], x[0:3], pc.stream_velocity, pc.drag,
        pc.newton_iters), t_blast)


def poc_stage_params_along(xs: torch.Tensor, t_blast: torch.Tensor,
                           pc: cfg.PocSolverConfig) -> torch.Tensor:
    """`poc_stage_params` at every state of xs (N, nx) in one vmap: the
    per-stage parameters of the online_stagewise modes, stage k
    linearized at its predicted pose."""
    return vmap(lambda x: poc_stage_params(x, t_blast, pc))(xs)


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
