"""Gauss-Newton SQP-RTI: one linearize -> QP -> update per control tick.

Port of `mpc_blaster_tpu/sqp/rti.py`, the slice with
`qp_backend="pallas"` (the box-QP IPM kernel, `ops/box_qp_ipm.py`) and
`lin_backend="jacfwd"` (`torch.func.jacfwd` + `vmap` over the shooting
nodes). Everything else raises `NotImplementedError` naming the ROADMAP
item that ports it; the port never switches a backend by itself.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
from torch.func import vmap

from mpc_blaster_tpu_torch import config as cfg
from mpc_blaster_tpu_torch.dynamics.blaster import BlasterParams, blaster_ode
from mpc_blaster_tpu_torch.dynamics.integrators import (discrete_dynamics,
                                                        discrete_jacobians)
from mpc_blaster_tpu_torch.ocp.spec import OCPSpec
from mpc_blaster_tpu_torch.qp.data import QPData

# What ports each option outside the slice (ROADMAP.md, queue 1 / 2).
_TODO = {
    "riccati": "queue 1 item 5 (torch-eager Riccati IPM, qp/ipm.py)",
    "condensed": "queue 1 item 12 (qp/condense.py)",
    "pallas_fused": "queue 1 item 9 and queue 2 K6 (fuse_lin kernel)",
    "fused": "queue 1 item 3 (dynamics/fastlin.py)",
    "warm": "queue 1 item 9 and queue 2 K3 (warm-start kernel)",
    "soft": "queue 1 item 10 and queue 2 K4 (soft-bound kernel)",
    "online": "queue 1 item 8 (online POC re-linearization)",
    "jac_refresh": "queue 1 item 12 (Jacobian-reuse ticks)",
    "batched_xla": "queue 1 item 7 (the general batched tick, with item "
                   "5's IPM)",
    "batched_pallas_fused": "queue 1 item 7 and queue 2 K5 (fuse_cost "
                            "kernel)",
}


def not_ported(what: str, key: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet; ROADMAP {_TODO[key]} ports it")


class RTIState(NamedTuple):
    """Iterate carried between ticks."""

    xbar: torch.Tensor  # (N+1, nx)
    ubar: torch.Tensor  # (N, nu)


class RTIDiagnostics(NamedTuple):
    """Per-solve stats."""

    qp_kkt_stat: torch.Tensor
    qp_kkt_eq: torch.Tensor
    qp_mu: torch.Tensor
    step_norm_x: torch.Tensor
    step_norm_u: torch.Tensor
    bound_viol: torch.Tensor  # worst primal box violation of the new iterate


def _bound_violation(spec: OCPSpec, state: RTIState) -> torch.Tensor:
    """Worst box-bound violation of an iterate (0 when feasible); leading
    batch axes of the state are reduced per problem."""
    vx = torch.maximum(spec.lbx - state.xbar, state.xbar - spec.ubx)
    vu = torch.maximum(spec.lbu - state.ubar, state.ubar - spec.ubu)
    return torch.clamp(torch.maximum(vx.amax((-2, -1)), vu.amax((-2, -1))),
                       min=0.0)


def diag_converged(diag: RTIDiagnostics,
                   solver: cfg.SolverConfig) -> torch.Tensor:
    """Per-solve health flag against the configured acceptance tolerances
    (the acados `nlp_solver_tol_*` test on static-budget solves)."""
    return ((diag.qp_kkt_stat < solver.tol_stat)
            & (diag.qp_kkt_eq < solver.tol_eq)
            & (diag.bound_viol < solver.tol_ineq)
            & (diag.qp_mu < solver.tol_comp))


def init_rti_state(ocp: cfg.OCPConfig, x0, dtype=torch.float32,
                   device=None) -> RTIState:
    """Constant-state, hover-thrust initial trajectory. `x0` may carry
    leading batch axes, which the iterate then carries too."""
    x0 = torch.as_tensor(x0, dtype=dtype, device=device)
    N = ocp.N
    hover = ocp.model.mass * ocp.model.gravity / 4.0
    u_hover = torch.zeros(cfg.NU, dtype=dtype, device=x0.device)
    u_hover[0:4] = hover
    u_hover = torch.minimum(
        torch.maximum(u_hover, torch.as_tensor(ocp.bounds.lbu, dtype=dtype,
                                               device=x0.device)),
        torch.as_tensor(ocp.bounds.ubu, dtype=dtype, device=x0.device))
    lead = x0.shape[:-1]
    return RTIState(
        xbar=x0.unsqueeze(-2).expand(*lead, N + 1, x0.shape[-1]).clone(),
        ubar=u_hover.expand(*lead, N, cfg.NU).clone())


def _linearize_nodes(F, xbar, ubar, stage_params, params):
    """(x_next, A, B) across all shooting nodes: one jacfwd per node,
    vmapped over the horizon."""
    FAB = discrete_jacobians(lambda x, u, p: F(x, u, p, params))
    return vmap(FAB)(xbar[:-1], ubar, stage_params)


def make_linearizer(ocp: cfg.OCPConfig, params: BlasterParams,
                    num_steps: int = 1):
    """Resolve `solver.lin_backend`: None means the jacfwd path."""
    lb = ocp.solver.lin_backend
    if lb == "fused":
        raise not_ported("lin_backend='fused'", "fused")
    if lb != "jacfwd":
        raise ValueError(f"unknown lin_backend {lb!r} "
                         "(expected 'jacfwd' or 'fused')")
    return None


def qp_hessian_R(spec: OCPSpec, solver) -> torch.Tensor:
    """The R of the QP's Gauss-Newton Hessian: `solver.qp_r_floor` raises
    selected diagonal entries to a minimum (proximal damping of weakly
    determined controls); the QP gradient always keeps `spec.R`."""
    if solver is None or solver.qp_r_floor is None:
        return spec.R
    fl = torch.as_tensor(solver.qp_r_floor, dtype=spec.R.dtype,
                         device=spec.R.device)
    d = torch.diagonal(spec.R)
    return spec.R + torch.diag(torch.clamp(fl - d, min=0.0))


def build_qp(spec: OCPSpec, state: RTIState, x0: torch.Tensor, F,
             params: BlasterParams, solver=None) -> QPData:
    """Linearize dynamics (jacfwd) + cost around the iterate -> delta-form
    QP. `solver` feeds the optional QP-only Hessian floor."""
    xbar, ubar = state.xbar, state.ubar
    x_pred, A, B = _linearize_nodes(F, xbar, ubar, spec.stage_params, params)
    c = x_pred - xbar[1:]                       # shooting defects

    N = spec.horizon
    dtw = spec.dt
    Qs = torch.cat([(dtw * spec.Q).expand(N, -1, -1), spec.Q_t[None]], 0)
    q_stage = dtw * (xbar[:-1] - spec.yref_x) @ spec.Q.T
    q_term = ((xbar[-1] - spec.yref_e) @ spec.Q_t.T)[None]
    qs = torch.cat([q_stage, q_term], 0)
    Rs = (dtw * qp_hessian_R(spec, solver)).expand(N, -1, -1)
    rs = dtw * (ubar - spec.yref_u) @ spec.R.T

    return QPData(
        A=A, B=B, c=c, Q=Qs, q=qs, R=Rs, r=rs,
        lbx=spec.lbx[None] - xbar, ubx=spec.ubx[None] - xbar,
        lbu=spec.lbu[None] - ubar, ubu=spec.ubu[None] - ubar,
        dx0=x0 - xbar[0],
    )


def _check_backend(solver: cfg.SolverConfig):
    if solver.qp_backend != "pallas":
        raise not_ported(f"qp_backend={solver.qp_backend!r}",
                         solver.qp_backend)


def solve_batched_qp(qp: QPData, solver: cfg.SolverConfig):
    """Solve a batch of QPs (leading axis) with the box-QP IPM kernel and
    the solver's IPM settings (the regularization floored at 1e-6, as the
    Pallas path always passes it)."""
    # Looked up per call: chip_smoke.py times the plain twin on the same
    # ticks by swapping it in for the wrapper.
    from mpc_blaster_tpu_torch.ops.box_qp_ipm import box_qp_solve
    return box_qp_solve(qp, iters=solver.ipm_iters, mu0=solver.ipm_mu0,
                        alpha_frac=solver.ipm_alpha_frac,
                        reg=max(solver.ipm_reg, 1e-6))


def solve_qp_backend(qp: QPData, solver: cfg.SolverConfig, warm=None):
    """Solve one QP with the configured backend: "pallas" runs the box-QP
    IPM kernel on a batch of one."""
    if warm is not None:
        raise not_ported("slack/dual warm starts", "warm")
    _check_backend(solver)
    sol = solve_batched_qp(QPData(*(a[None] for a in qp)), solver)
    return type(sol)(*(None if a is None else a[0] for a in sol))


def rti_step(spec: OCPSpec, state: RTIState, x0: torch.Tensor,
             params: BlasterParams, F, solver: cfg.SolverConfig
             ) -> Tuple[torch.Tensor, RTIState, RTIDiagnostics]:
    """One real-time iteration. Returns (u0, updated iterate, diagnostics)."""
    qp = build_qp(spec, state, x0, F, params, solver=solver)
    sol = solve_qp_backend(qp, solver)
    new_state = RTIState(xbar=state.xbar + sol.dx, ubar=state.ubar + sol.du)
    diag = RTIDiagnostics(
        qp_kkt_stat=sol.kkt_stat, qp_kkt_eq=sol.kkt_eq, qp_mu=sol.mu,
        step_norm_x=sol.dx.abs().amax(),
        step_norm_u=sol.du.abs().amax(),
        bound_viol=_bound_violation(spec, new_state),
    )
    return new_state.ubar[0], new_state, diag


def rti_step_soft(spec: OCPSpec, state: RTIState, x0: torch.Tensor,
                  params: BlasterParams, F, solver: cfg.SolverConfig, soft):
    """RTI tick with soft (slacked) state bounds: not ported yet."""
    raise not_ported("soft state bounds (rti_step_soft)", "soft")


def make_rti_step(ocp: cfg.OCPConfig, dtype=torch.float32,
                  num_steps: int = 1, device=None):
    """Build `step(spec, state, x0) -> (u0, state, diag)` closed over the
    static configuration."""
    params = BlasterParams.from_config(ocp.model, dtype, device)
    F = discrete_dynamics(blaster_ode, ocp.dt, num_steps=num_steps)
    solver = ocp.solver
    _check_backend(solver)
    make_linearizer(ocp, params, num_steps=num_steps)

    def step(spec: OCPSpec, state: RTIState, x0: torch.Tensor):
        return rti_step(spec, state, x0, params, F, solver)

    return step
