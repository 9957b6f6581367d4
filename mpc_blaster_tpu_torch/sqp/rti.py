"""Gauss-Newton SQP-RTI: one linearize -> QP -> update per control tick.

Port of `mpc_blaster_tpu/sqp/rti.py`, the ticks of three QP backends:

  - `qp_backend="riccati"` (the presets' default): the host builds the QP
    and the eager Riccati IPM of `qp/ipm.py` solves it;
  - `qp_backend="pallas"`: the host builds the QP (`build_qp`, with the
    `lin_backend` linearizer: "jacfwd", `torch.func.jacfwd` + `vmap` over
    the nodes, or "fused", `dynamics/fastlin.py`), then one launch of the
    box-QP IPM kernel solves it (`ops/box_qp_ipm.py::box_qp_solve`);
  - `qp_backend="pallas_fused"`, the deployed tick: linearization, QP
    assembly and solve are ONE kernel launch
    (`ops/box_qp_ipm.py::fused_rti_solve`), fed the static dynamics
    constants of `fused_dyn_statics`.

Each runs cold (`rti_step`), with slack/dual warm starts carried between
ticks (`rti_step_warm`, kernel K3 on the two kernel backends), optionally
under the online divergence watchdog (`rti_step_warm_guarded`, the chain
behind `config.deployed_solver("fastest")`), or with soft state bounds
(`rti_step_soft`: `qp/soft.py` on "riccati", kernel K4 on the two kernel
backends). The Jacobian-reuse ticks (`rti_step_jacreuse`,
`rti_step_warm_jacreuse`) refresh A and B only on the ticks the caller
names and keep the shooting defects exact on every tick; `sqp_solve` runs
several full Gauss-Newton iterations at a fixed x0 and keeps the best
iterate by an L1 merit. `qp_backend="condensed"` builds the same QP
and solves it by partial condensing with block size `solver.cond_M`
(`qp/condense.py`, eager PyTorch); its solves are cold, so a warm start
with it raises `ValueError`, as in the JAX package. The port never
switches a backend by itself.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch
from torch.func import vmap

from mpc_blaster_tpu_torch import config as cfg
from mpc_blaster_tpu_torch.device import resolve_device
from mpc_blaster_tpu_torch.dynamics.blaster import BlasterParams, blaster_ode
from mpc_blaster_tpu_torch.dynamics.integrators import (discrete_dynamics,
                                                        discrete_jacobians)
from mpc_blaster_tpu_torch.ocp.spec import OCPSpec, total_cost
from mpc_blaster_tpu_torch.qp.condense import condensed_qp_solve
from mpc_blaster_tpu_torch.qp.data import QPData
from mpc_blaster_tpu_torch.qp.ipm import (IpmWarmStart, box_qp_solve,
                                          warm_start_from,
                                          warm_start_recenter)
from mpc_blaster_tpu_torch.qp.soft import (SoftBounds, SoftQPSolution,
                                           _violation, soft_box_qp_solve,
                                           violations_from_primal)

QP_BACKENDS = ("riccati", "condensed", "pallas", "pallas_fused")


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
    batch axes of the state are reduced per problem, and the boxes may
    carry the same batch axes (one box per problem)."""
    lbx, ubx = spec.lbx.unsqueeze(-2), spec.ubx.unsqueeze(-2)
    lbu, ubu = spec.lbu.unsqueeze(-2), spec.ubu.unsqueeze(-2)
    vx = torch.maximum(lbx - state.xbar, state.xbar - ubx)
    vu = torch.maximum(lbu - state.ubar, state.ubar - ubu)
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
    x0 = torch.as_tensor(x0, dtype=dtype,
                         device=resolve_device(device, x0))
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
    """Resolve `solver.lin_backend` to a `linearizer` hook of `build_qp`:
    None for the jacfwd path, the component-form closure for "fused"."""
    lb = ocp.solver.lin_backend
    if lb == "fused":
        from mpc_blaster_tpu_torch.dynamics.fastlin import \
            make_fused_linearizer
        return make_fused_linearizer(ocp, params, num_steps)
    if lb != "jacfwd":
        raise ValueError(f"unknown lin_backend {lb!r} "
                         "(expected 'jacfwd' or 'fused')")
    return None


def fused_dyn_statics(ocp: cfg.OCPConfig, num_steps: int = 1,
                      family: str = "blaster") -> tuple:
    """Dynamics constants of the one-launch tick
    (`qp_backend="pallas_fused"`): ((family, mass, g, arm_x, arm_y, yaw_c,
    Jx, Jy, Jz), dt, num_steps). The kernel takes them as runtime
    arguments; `family` names the rows-form ODE of
    `dynamics/fastlin.py::FAMILIES` ("blaster", or "blaster_dist" for the
    offset-free loop's disturbance rows; `models/quad13.py` builds the
    "quad13" tuple)."""
    m = ocp.model
    return ((family, float(m.mass), float(m.gravity),
             float(m.arm_length_x), float(m.arm_length_y),
             float(m.yaw_coefficient),
             float(m.inertia_diag[0]), float(m.inertia_diag[1]),
             float(m.inertia_diag[2])),
            float(ocp.dt), int(num_steps))


def _batch1(t):
    """A single problem's container as a batch of one (or None)."""
    return None if t is None else type(t)(*(a[None] for a in t))


def _unbatch1(sol):
    return type(sol)(*(None if a is None else a[0] for a in sol))


# Dimensions of an unbatched spec's fields; a field with one more carries a
# leading batch axis (one row per problem).
_SPEC_NDIM = OCPSpec(Q=2, R=2, Q_t=2, yref_x=2, yref_u=2, yref_e=1, lbx=1,
                     ubx=1, lbu=1, ubu=1, stage_params=2, dt=0)


def spec_batch_dims(spec: OCPSpec) -> OCPSpec:
    """Per field, 0 where it carries a leading batch axis and None where
    it is shared: the `in_dims` of a `vmap` over a batch of problems."""
    return OCPSpec(*(0 if a.ndim > n else None
                     for a, n in zip(spec, _SPEC_NDIM)))


def batch_spec(spec: OCPSpec, B: int) -> OCPSpec:
    """`spec` with a leading batch axis of B on every field: per-problem
    fields keep their rows, shared ones are broadcast (views)."""
    return OCPSpec(*(a if d == 0 else a.expand(B, *a.shape)
                     for a, d in zip(spec, spec_batch_dims(spec))))


def fused_qp_solve_batched(spec: OCPSpec, state: RTIState, x0: torch.Tensor,
                           solver: cfg.SolverConfig, dyn_statics,
                           warm: Optional[IpmWarmStart] = None, skip=None,
                           soft=None):
    """One-launch RTI QP solve of B problems: linearization, cost
    gradients, delta bounds and dx0 are all assembled inside the IPM
    kernel (one thread block per problem) from the iterates and the raw
    spec tensors. `state` and `x0` carry the batch axis; each spec field
    either carries it too (one spec per problem) or is shared. `warm` (an
    IpmWarmStart with the batch axis) blends a slack/dual warm start (K3),
    `soft` (a `qp/soft.py::SoftBounds`) softens bounds (K4). This is what
    `jax.vmap` of the JAX package's `_fused_qp_solve` computes. Returns
    the delta-form solution with the batch axis."""
    from mpc_blaster_tpu_torch.ops.box_qp_ipm import fused_rti_solve
    if dyn_statics is None:
        raise ValueError(
            "qp_backend='pallas_fused' needs static dynamics constants: "
            "build ticks via make_rti_step/closed_loop, or pass "
            "dyn_statics=fused_dyn_statics(ocp, num_steps)")
    model, dt, nsteps = dyn_statics
    B = x0.shape[0]
    s = batch_spec(spec, B)
    dtw = s.dt.reshape(B, 1, 1)
    Rh = qp_hessian_R(s, solver)   # QP-only floor (gradient keeps R)
    Rg = dtw * s.R if solver.qp_r_floor is not None else None
    return fused_rti_solve(
        state.xbar, state.ubar, s.stage_params, x0, dtw * s.Q, s.Q_t,
        dtw * Rh, s.yref_x, s.yref_u, s.yref_e, s.lbx, s.ubx, s.lbu, s.ubu,
        model=model, dt=dt, num_steps=nsteps, iters=solver.ipm_iters,
        mu0=solver.ipm_mu0, alpha_frac=solver.ipm_alpha_frac,
        reg=max(solver.ipm_reg, 1e-6), warm=warm, soft=soft, R_grad=Rg,
        skip=skip)


def _fused_qp_solve(spec: OCPSpec, state: RTIState, x0: torch.Tensor,
                    solver: cfg.SolverConfig, dyn_statics,
                    warm: Optional[IpmWarmStart] = None, skip=None,
                    soft=None):
    """`fused_qp_solve_batched` of one problem (the deployed B=1 tick):
    unbatched spec, iterate, x0 and warm start; returns the delta-form
    solution."""
    return _unbatch1(fused_qp_solve_batched(
        spec, _batch1(state), x0[None], solver, dyn_statics,
        warm=_batch1(warm), skip=skip, soft=soft))


def qp_hessian_R(spec: OCPSpec, solver) -> torch.Tensor:
    """The R of the QP's Gauss-Newton Hessian: `solver.qp_r_floor` raises
    selected diagonal entries to a minimum (proximal damping of weakly
    determined controls); the QP gradient always keeps `spec.R`."""
    if solver is None or solver.qp_r_floor is None:
        return spec.R
    fl = torch.as_tensor(solver.qp_r_floor, dtype=spec.R.dtype,
                         device=spec.R.device)
    d = torch.diagonal(spec.R, dim1=-2, dim2=-1)
    return spec.R + torch.diag_embed(torch.clamp(fl - d, min=0.0))


def _linearize(spec, state, F, params, linearizer):
    """(x_next, A, B) at every node of the iterate: the `linearizer` hook
    where given, else jacfwd over the nodes."""
    if linearizer is not None:
        return linearizer(state.xbar, state.ubar, spec.stage_params)
    return _linearize_nodes(F, state.xbar, state.ubar, spec.stage_params,
                            params)


def _linearize_pair(spec, a: RTIState, b: RTIState, F, params, linearizer):
    """(x_next, A, B) at the nodes of two iterates of one horizon N, from
    one linearization over 2N nodes, a's then b's (every linearizer reads
    xbar[:-1], ubar and stage_params node by node)."""
    N = a.ubar.shape[0]
    both = RTIState(xbar=torch.cat([a.xbar[:-1], b.xbar], 0),
                    ubar=torch.cat([a.ubar, b.ubar], 0))
    sp = torch.cat([spec.stage_params, spec.stage_params], 0)
    lin = _linearize(spec._replace(stage_params=sp), both, F, params,
                     linearizer)
    return tuple(t[:N] for t in lin), tuple(t[N:] for t in lin)


def build_qp(spec: OCPSpec, state: RTIState, x0: torch.Tensor, F,
             params: BlasterParams, linearizer=None, solver=None) -> QPData:
    """Linearize dynamics + cost around the iterate -> delta-form QP.
    `linearizer`, when given, replaces the jacfwd linearization with a
    `(xbar, ubar, stage_params) -> (x_next, A, B)` callable (the
    component-form backend, `dynamics/fastlin.py`). `solver` feeds the
    optional QP-only Hessian floor."""
    x_pred, A, B = _linearize(spec, state, F, params, linearizer)
    return _assemble_qp(spec, state, x0, x_pred, A, B, solver)


def _assemble_qp(spec, state, x0, x_pred, A, B, solver) -> QPData:
    """The delta-form QP of an iterate from its forward map and
    Jacobians."""
    xbar, ubar = state.xbar, state.ubar
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


class JacCache(NamedTuple):
    """The dynamics Jacobians the Jacobian-reuse ticks carry between
    refreshes."""

    A: torch.Tensor  # (N, nx, nx)
    B: torch.Tensor  # (N, nx, nu)

    @staticmethod
    def zeros(N, nx, nu, dtype=torch.float32, device=None) -> "JacCache":
        device = resolve_device(device)
        return JacCache(A=torch.zeros(N, nx, nx, dtype=dtype, device=device),
                        B=torch.zeros(N, nx, nu, dtype=dtype, device=device))


def build_qp_jacreuse(spec: OCPSpec, state: RTIState, x0: torch.Tensor, F,
                      params: BlasterParams, cache: JacCache, refresh: bool,
                      linearizer=None, solver=None) -> tuple:
    """`build_qp` with optional Jacobian reuse (the reference's
    `sim_method_jac_reuse` option). With `refresh` the QP is `build_qp`'s
    and its A, B become the new cache; otherwise A and B come from
    `cache` and only the forward map runs, so the shooting defects stay
    exact and only the Gauss-Newton model is stale. Returns (QPData,
    new cache).

    The JAX package branches with `lax.cond` on a traced flag. Here
    `refresh` is a Python bool (the loop's tick counter decides it): a
    device tensor would cost a host sync per tick or both branches, so it
    is refused."""
    if not isinstance(refresh, bool):
        raise TypeError("refresh must be a Python bool (the tick counter's "
                        f"decision), not {type(refresh).__name__}")
    if refresh:
        x_pred, A, B = _linearize(spec, state, F, params, linearizer)
    else:
        x_pred = vmap(lambda x, u, p: F(x, u, p, params))(
            state.xbar[:-1], state.ubar, spec.stage_params)
        A, B = cache.A, cache.B
    return (_assemble_qp(spec, state, x0, x_pred, A, B, solver),
            JacCache(A=A, B=B))


def _check_backend(solver: cfg.SolverConfig):
    if solver.qp_backend not in QP_BACKENDS:
        raise ValueError(f"qp_backend={solver.qp_backend!r}; expected one "
                         f"of {QP_BACKENDS}")


def solve_batched_qp(qp: QPData, solver: cfg.SolverConfig, warm=None,
                     skip=None, soft=None):
    """Solve a batch of QPs (leading axis) with the box-QP IPM kernel and
    the solver's IPM settings (the regularization floored at 1e-6, as the
    Pallas path always passes it)."""
    # Looked up per call: chip_smoke.py times the plain twin on the same
    # ticks by swapping it in for the wrapper.
    from mpc_blaster_tpu_torch.ops import box_qp_ipm as K
    return K.box_qp_solve(qp, iters=solver.ipm_iters, mu0=solver.ipm_mu0,
                          alpha_frac=solver.ipm_alpha_frac,
                          reg=max(solver.ipm_reg, 1e-6), warm=warm,
                          skip=skip, soft=soft)


def solve_qp_backend(qp: QPData, solver: cfg.SolverConfig, warm=None,
                     skip=None):
    """Solve one QP, or a batch of them on its leading axes, with the
    configured backend: "condensed" applies partial condensing with block
    size `solver.cond_M` (`qp/condense.py`; cold solves only: a warm start
    raises `ValueError`); "pallas" runs the box-QP IPM kernel on a batch
    of one; every other backend (pallas_fused included, as in the JAX
    dispatch) the Riccati IPM with `solver.riccati`. `warm` (an
    IpmWarmStart) is honoured by the last two; `skip` (see
    `ops/box_qp_ipm.py`) only by the kernel."""
    if solver.qp_backend == "condensed":
        if warm is not None:
            raise ValueError("qp_backend='condensed' does not support "
                             "slack/dual warm starts")
        return condensed_qp_solve(qp, M=solver.cond_M,
                                  iters=solver.ipm_iters, mu0=solver.ipm_mu0,
                                  alpha_frac=solver.ipm_alpha_frac,
                                  reg=solver.ipm_reg)
    if solver.qp_backend == "pallas":
        return _unbatch1(solve_batched_qp(_batch1(qp), solver,
                                          warm=_batch1(warm), skip=skip))
    return box_qp_solve(qp, iters=solver.ipm_iters, mu0=solver.ipm_mu0,
                        alpha_frac=solver.ipm_alpha_frac, reg=solver.ipm_reg,
                        riccati=solver.riccati, warm=warm)


def rti_step(spec: OCPSpec, state: RTIState, x0: torch.Tensor,
             params: BlasterParams, F, solver: cfg.SolverConfig,
             linearizer=None, dyn_statics=None
             ) -> Tuple[torch.Tensor, RTIState, RTIDiagnostics]:
    """One real-time iteration. Returns (u0, updated iterate, diagnostics).

    With `solver.qp_backend == "pallas_fused"` the linearization runs
    inside the IPM kernel (`linearizer` is unused; pass
    `dyn_statics=fused_dyn_statics(ocp, num_steps)`)."""
    sol = _solve_tick(spec, state, x0, params, F, solver, linearizer,
                      dyn_statics)
    new_state, diag = _update(spec, state, sol)
    return new_state.ubar[0], new_state, diag


def _solve_tick(spec, state, x0, params, F, solver, linearizer, dyn_statics,
                warm=None, skip=None):
    """The tick's QP solve on the configured backend (delta form)."""
    if solver.qp_backend == "pallas_fused":
        return _fused_qp_solve(spec, state, x0, solver, dyn_statics,
                               warm=warm, skip=skip)
    qp = build_qp(spec, state, x0, F, params, linearizer=linearizer,
                  solver=solver)
    return solve_qp_backend(qp, solver, warm=warm, skip=skip)


def _update(spec, state, sol):
    """(new iterate, diagnostics) of a tick from its delta solution."""
    new_state = RTIState(xbar=state.xbar + sol.dx, ubar=state.ubar + sol.du)
    diag = RTIDiagnostics(
        qp_kkt_stat=sol.kkt_stat, qp_kkt_eq=sol.kkt_eq, qp_mu=sol.mu,
        step_norm_x=sol.dx.abs().amax(),
        step_norm_u=sol.du.abs().amax(),
        bound_viol=_bound_violation(spec, new_state),
    )
    return new_state, diag


def rti_step_warm(spec: OCPSpec, state: RTIState, warm: IpmWarmStart,
                  x0: torch.Tensor, params: BlasterParams, F,
                  solver: cfg.SolverConfig, linearizer=None,
                  dyn_statics=None, skip=None):
    """RTI tick with slack/dual warm starting (HPIPM warm_start=1 analog).

    Returns (u0, new_state, warm_out, diag). Pass `warm_out` into the next
    tick; seed the first with `IpmWarmStart.zeros(...)` (valid=0 -> cold).
    The carried slacks/duals are conditioned per `solver.warm_mode`
    ("full", "primal", "centrality"; `qp/ipm.py::warm_start_recenter`)
    and, with `solver.warm_shift`, time-shifted together with the
    iterate. `skip` (a device bool) lets the kernel backends skip the
    solve on the device; the results are then undefined (the watchdog's
    redo)."""
    sol = _solve_tick(spec, state, x0, params, F, solver, linearizer,
                      dyn_statics, warm=warm, skip=skip)
    new_state, diag = _update(spec, state, sol)
    u0 = new_state.ubar[0]
    warm_out = warm_start_from(sol, shift=solver.warm_shift)
    if solver.warm_mode != "full":
        warm_out = warm_start_recenter(warm_out, mu0=solver.ipm_mu0,
                                       mode=solver.warm_mode)
    if solver.warm_shift:
        new_state = shift_state(new_state)
    return u0, new_state, warm_out, diag


def shift_state(state: RTIState) -> RTIState:
    """Shift the iterate one stage forward (classic RTI warm start)."""
    return RTIState(
        xbar=torch.cat([state.xbar[1:], state.xbar[-1:]], 0),
        ubar=torch.cat([state.ubar[1:], state.ubar[-1:]], 0))


def rti_step_jacreuse(spec: OCPSpec, state: RTIState, cache: JacCache,
                      refresh: bool, x0: torch.Tensor,
                      params: BlasterParams, F, solver: cfg.SolverConfig,
                      linearizer=None):
    """RTI tick with Jacobian reuse (`build_qp_jacreuse`), solved by the
    configured backend (on "pallas" one plain kernel launch: stale A and
    B with exact c are still a plain QP). Returns (u0, state, cache,
    diag)."""
    qp, cache = build_qp_jacreuse(spec, state, x0, F, params, cache,
                                  refresh, linearizer=linearizer,
                                  solver=solver)
    new_state, diag = _update(spec, state, solve_qp_backend(qp, solver))
    return new_state.ubar[0], new_state, cache, diag


def rti_step_warm_jacreuse(spec: OCPSpec, state: RTIState,
                           warm: IpmWarmStart, cache: JacCache,
                           refresh: bool, x0: torch.Tensor,
                           params: BlasterParams, F,
                           solver: cfg.SolverConfig, linearizer=None):
    """The slack/dual warm chain of `rti_step_warm` (its conditioning and
    shift) on a Jacobian-reuse tick. When the iterate is time-shifted the
    cache rows shift with it (stage k's new linearization point is the old
    stage k+1). Returns (u0, new_state, warm_out, new_cache, diag)."""
    qp, cache = build_qp_jacreuse(spec, state, x0, F, params, cache,
                                  refresh, linearizer=linearizer,
                                  solver=solver)
    sol = solve_qp_backend(qp, solver, warm=warm)
    new_state, diag = _update(spec, state, sol)
    u0 = new_state.ubar[0]
    warm_out = warm_start_from(sol, shift=solver.warm_shift)
    if solver.warm_mode != "full":
        warm_out = warm_start_recenter(warm_out, mu0=solver.ipm_mu0,
                                       mode=solver.warm_mode)
    if solver.warm_shift:
        new_state = shift_state(new_state)
        cache = JacCache(A=torch.cat([cache.A[1:], cache.A[-1:]], 0),
                         B=torch.cat([cache.B[1:], cache.B[-1:]], 0))
    return u0, new_state, warm_out, cache, diag


class WatchdogState(NamedTuple):
    """Running health state of `rti_step_warm_guarded`: an EMA of the
    accepted ticks' QP equality residual, the number of warm->cold
    downgrades, and the remaining ticks of the cold hold. Tensors on the
    loop's device, so the guard never waits for the host."""

    ema_eq: torch.Tensor  # scalar EMA of accepted qp_kkt_eq
    trips: torch.Tensor   # int32
    hold: torch.Tensor    # int32

    @staticmethod
    def init(dtype=torch.float32, device=None) -> "WatchdogState":
        device = resolve_device(device)
        return WatchdogState(
            ema_eq=torch.zeros((), dtype=dtype, device=device),
            trips=torch.zeros((), dtype=torch.int32, device=device),
            hold=torch.zeros((), dtype=torch.int32, device=device))


def _select(pred, a, b):
    """`a` where `pred` else `b`, through nested tuples of tensors."""
    if isinstance(a, tuple):
        out = (_select(pred, x, y) for x, y in zip(a, b))
        return type(a)(*out) if hasattr(a, "_fields") else tuple(out)
    return torch.where(pred, a, b)


def rti_step_warm_guarded(spec: OCPSpec, state: RTIState,
                          warm: IpmWarmStart, wd: WatchdogState,
                          x0: torch.Tensor, params: BlasterParams, F,
                          solver: cfg.SolverConfig, linearizer=None,
                          dyn_statics=None, jump: float = 30.0,
                          floor: float = 0.5, ema_rate: float = 0.9,
                          viol_cap: float = 0.25, hold_ticks: int = 10):
    """`rti_step_warm` under the online divergence watchdog.

    A tick trips when u0 or the QP equality residual is nonfinite, the
    residual jumps above max(jump * EMA(accepted residual), floor), or the
    new iterate violates its box by more than `viol_cap`. A tripped tick
    is recomputed COLD (warm valid=0) from the carried iterate sanitized
    (nonfinite xbar rows -> x0, ubar box-clipped), and the chain then stays
    cold for hold_ticks + 2 * (earlier trips) ticks; the EMA reseeds from
    the accepted solve.

    The JAX package branches with `lax.cond`; here the decision stays on
    the device: the redo is always enqueued, with `skip = not bad`, so the
    kernel backends return at once on an accepted tick (one short launch)
    and the results are selected with `torch.where`. No host sync per
    tick. The eager Riccati backend and the plain twins always compute the
    redo. Off "pallas_fused" one linearizer call over the two iterates'
    2N nodes (`_linearize_pair`) serves both solves: an eager
    linearization costs its op count more than its width. Returns (u0,
    new_state, warm_out, wd_out, diag), diag of the ACCEPTED solve.
    """
    force_cold = wd.hold > 0
    warm_in = warm._replace(valid=torch.where(
        force_cold, torch.zeros_like(warm.valid), warm.valid))
    x0_safe = torch.where(torch.isfinite(x0), x0, torch.zeros_like(x0))
    xb = torch.where(torch.isfinite(state.xbar), state.xbar, x0_safe)
    ub = torch.where(torch.isfinite(state.ubar), state.ubar,
                     torch.zeros_like(state.ubar))
    ub = torch.minimum(torch.maximum(ub, spec.lbu), spec.ubu)
    sane = RTIState(xbar=xb, ubar=ub)
    lin_keep = lin_redo = linearizer
    if solver.qp_backend != "pallas_fused":
        at_keep, at_redo = _linearize_pair(spec, state, sane, F, params,
                                           linearizer)
        lin_keep, lin_redo = (lambda *_: at_keep), (lambda *_: at_redo)

    keep = rti_step_warm(spec, state, warm_in, x0, params, F, solver,
                         linearizer=lin_keep, dyn_statics=dyn_statics)
    u0, _, _, diag1 = keep
    thresh = torch.clamp(jump * wd.ema_eq, min=floor)
    bad = (~torch.isfinite(u0).all() | ~torch.isfinite(diag1.qp_kkt_eq)
           | (diag1.qp_kkt_eq > thresh) | (diag1.bound_viol > viol_cap))

    warm_cold = warm._replace(valid=torch.zeros_like(warm.valid))
    redo = rti_step_warm(spec, sane, warm_cold, x0, params, F, solver,
                         linearizer=lin_redo, dyn_statics=dyn_statics,
                         skip=~bad)
    u0g, stg, warmg, diagg = _select(bad, redo, keep)

    eq_acc = diagg.qp_kkt_eq
    ema_new = torch.where(bad | (wd.ema_eq <= 0.0), eq_acc,
                          ema_rate * wd.ema_eq + (1.0 - ema_rate) * eq_acc)
    # escalating hold: each trip lengthens the cold period by 2 ticks
    hold_new = torch.where(bad, (hold_ticks + 2 * wd.trips).to(torch.int32),
                           torch.clamp(wd.hold - 1, min=0))
    wd_new = WatchdogState(ema_eq=ema_new.to(wd.ema_eq.dtype),
                           trips=wd.trips + bad.to(torch.int32),
                           hold=hold_new)
    return u0g, stg, warmg, wd_new, diagg


def rti_step_soft(spec: OCPSpec, state: RTIState, x0: torch.Tensor,
                  params: BlasterParams, F, solver: cfg.SolverConfig,
                  soft: SoftBounds, linearizer=None, dyn_statics=None):
    """RTI tick with soft (slacked) state bounds, the acados ns>0 analog.

    Use where disturbances can push the state outside the hard box (the
    simulation preset's position box is +-1.5 m): a hard QP is infeasible
    there, the soft QP trades L1+L2-penalized violations. `soft` is a
    `qp/soft.py::SoftBounds` in delta units (the penalties are
    shift-invariant). Returns (u0, new_state, diag, SoftQPSolution).

    "pallas_fused": one launch of the fuse_lin kernel with soft rows
    (kernel K4; pass `dyn_statics`), violations from the absolute updated
    iterate. "pallas": `build_qp`, one launch of the plain kernel with
    soft rows, violations from the returned primal. Every other backend
    solves with `qp/soft.py::soft_box_qp_solve` (the eager Riccati IPM).
    """
    if solver.qp_backend == "pallas_fused":
        sol = _fused_qp_solve(spec, state, x0, solver, dyn_statics,
                              soft=soft)
        new_state, diag = _update(spec, state, sol)
        # violations of the ABSOLUTE updated iterate: t = max(-sgn (v - b),
        # 0) is the same in delta and absolute units
        vx, vu = new_state.xbar[1:], new_state.ubar
        res = SoftQPSolution(sol, *(
            _violation(v, b[None], sgn, pen) for v, b, sgn, pen in (
                (vx, spec.lbx, 1.0, soft.lx), (vx, spec.ubx, -1.0, soft.ux),
                (vu, spec.lbu, 1.0, soft.lu), (vu, spec.ubu, -1.0, soft.uu))))
        return new_state.ubar[0], new_state, diag, res
    qp = build_qp(spec, state, x0, F, params, linearizer=linearizer,
                  solver=solver)
    if solver.qp_backend == "pallas":
        # unbatched (N, w) penalty fields broadcast over the batch of one
        sol = _unbatch1(solve_batched_qp(_batch1(qp), solver, soft=soft))
        res = SoftQPSolution(sol, *violations_from_primal(qp, soft, sol.dx,
                                                          sol.du))
    else:
        res = soft_box_qp_solve(qp, soft, iters=solver.ipm_iters,
                                mu0=solver.ipm_mu0,
                                alpha_frac=solver.ipm_alpha_frac,
                                reg=solver.ipm_reg)
    new_state, diag = _update(spec, state, res.sol)
    return new_state.ubar[0], new_state, diag, res


def make_rti_step(ocp: cfg.OCPConfig, dtype=torch.float32,
                  num_steps: int = 1, jit: bool = True, device=None):
    """Build `step(spec, state, x0) -> (u0, state, diag)` closed over the
    static configuration, for specs and states on `device` (default: the
    card, `device.py`). `jit` holds the JAX package's slot so that a
    positional call binds as it does there; the eager port accepts it and
    ignores it."""
    params = BlasterParams.from_config(ocp.model, dtype, device)
    F = discrete_dynamics(blaster_ode, ocp.dt, num_steps=num_steps)
    solver = ocp.solver
    _check_backend(solver)
    lin = make_linearizer(ocp, params, num_steps=num_steps)
    dyn = (fused_dyn_statics(ocp, num_steps)
           if solver.qp_backend == "pallas_fused" else None)

    def step(spec: OCPSpec, state: RTIState, x0: torch.Tensor):
        return rti_step(spec, state, x0, params, F, solver, linearizer=lin,
                        dyn_statics=dyn)

    return step


@dataclasses.dataclass(frozen=True)
class RTIController:
    """The static configuration of a controller; `make()` builds its
    tick (`make_rti_step`) on `device`."""

    ocp: cfg.OCPConfig
    dtype: torch.dtype = torch.float32
    num_steps: int = 1  # integrator substeps per shooting node
    device: object = None

    def make(self):
        return make_rti_step(self.ocp, dtype=self.dtype,
                             num_steps=self.num_steps, device=self.device)


def sqp_solve(spec: OCPSpec, state: RTIState, x0: torch.Tensor,
              params: BlasterParams, F, solver: cfg.SolverConfig,
              iters: int = 10, linearizer=None):
    """Multi-iteration SQP at a fixed x0 (the reference's `SQP` mode:
    `iters` full Gauss-Newton steps). Returns the best iterate by the L1
    exact-penalty merit (the true cost + 1e4 |dynamics defect|_1) and the
    step norms of u per iteration. In f32, full steps on states pinned at
    their bounds limit-cycle in the near-free gimbal subspace, so the last
    iterate is a lottery; the best one never gets worse with more
    iterations. The selection stays on the device (no host sync)."""
    def merit(st):
        xs_next = vmap(lambda x, u, p: F(x, u, p, params))(
            st.xbar[:-1], st.ubar, spec.stage_params)
        defect = ((xs_next - st.xbar[1:]).abs().sum()
                  + (st.xbar[0] - x0).abs().sum())
        return total_cost(spec, st.xbar, st.ubar) + 1e4 * defect

    best, best_m, st, norms = state, merit(state), state, []
    for _ in range(iters):
        _, st, diag = rti_step(spec, st, x0, params, F, solver,
                               linearizer=linearizer)
        m = merit(st)
        better = m < best_m
        best = _select(better, st, best)
        best_m = torch.where(better, m, best_m)
        norms.append(diag.step_norm_u)
    return best, torch.stack(norms)
