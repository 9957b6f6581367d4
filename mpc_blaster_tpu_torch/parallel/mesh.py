"""Scenario batching of the RTI tick on one device.

Port of `mpc_blaster_tpu/parallel/mesh.py::batched_rti_step` with its
three backends:

  - "xla" (the default): the tick of `make_rti_step(ocp)` over the batch.
    With the presets' `qp_backend="riccati"` that is `build_qp` for every
    scenario at once and the Riccati IPM of `qp/ipm.py` on its leading
    batch axes (eager PyTorch, no kernel of ours: launch-bound on the
    card); a "pallas" solver makes it the "pallas" backend below. The
    B=1 one-launch tick ("pallas_fused") has no batched form here: use
    backend="pallas_fused";
  - "pallas": the QP assembly runs for every scenario at once
    (`torch.func.vmap` of `build_qp` with the `lin_backend` linearizer),
    then one launch of the box-QP IPM kernel solves the whole batch;
  - "pallas_fused": the host runs only the component-form linearizer
    (`dynamics/fastlin.py::fast_linearize`, batched); cost gradients,
    delta bounds, dx0, the IPM solve and the iterate update run in one
    launch of the fuse_cost kernel (`ops/box_qp_ipm.py::
    batched_fused_tick`).

Multi-device sharding (`sharded_rti_step`, `sharded_sweep`) ports with
ROADMAP queue 1 item 13.
"""
from __future__ import annotations

import torch
from torch.func import vmap

from mpc_blaster_tpu_torch import config as cfg
from mpc_blaster_tpu_torch.dynamics.blaster import BlasterParams, blaster_ode
from mpc_blaster_tpu_torch.dynamics.integrators import discrete_dynamics
from mpc_blaster_tpu_torch.ocp.spec import OCPSpec
from mpc_blaster_tpu_torch.qp.ipm import box_qp_solve
from mpc_blaster_tpu_torch.sqp.rti import (RTIDiagnostics, RTIState,
                                           _bound_violation,
                                           _check_backend, build_qp,
                                           make_linearizer, not_ported,
                                           qp_hessian_R,
                                           solve_batched_qp)


def batched_rti_step(ocp: cfg.OCPConfig, dtype=torch.float32,
                     backend: str = "xla", device=None):
    """The RTI tick over a scenario batch.

    Returns step(spec, states, x0s) -> (u0s, states, diags); `spec` is
    shared, states/x0s carry a leading batch axis. `backend="xla"` runs
    the tick of `make_rti_step(ocp)` over the batch (the module
    docstring), `backend="pallas"` solves the host-built QPs with the
    box-QP IPM kernel, `backend="pallas_fused"` runs the fuse_cost
    kernel.
    """
    if backend == "xla":
        return _batched_rti_step_xla(ocp, dtype=dtype, device=device)
    if backend == "pallas":
        return _batched_rti_step_pallas(ocp, dtype=dtype, device=device)
    if backend == "pallas_fused":
        return _batched_rti_step_pallas_fused(ocp, dtype=dtype,
                                              device=device)
    raise ValueError(f"unknown batched backend {backend!r}")


def _batched_diag(spec, sol, new_states) -> RTIDiagnostics:
    return RTIDiagnostics(
        qp_kkt_stat=sol.kkt_stat, qp_kkt_eq=sol.kkt_eq, qp_mu=sol.mu,
        step_norm_x=sol.dx.abs().amax((1, 2)),
        step_norm_u=sol.du.abs().amax((1, 2)),
        bound_viol=_bound_violation(spec, new_states))


def _batched_rti_step_xla(ocp: cfg.OCPConfig, dtype=torch.float32,
                          device=None):
    """`make_rti_step(ocp)`'s tick over a scenario batch (the JAX package
    vmaps it): the host-built QPs go to the solver's own backend."""
    solver = ocp.solver
    if solver.qp_backend == "pallas":
        return _batched_rti_step_pallas(ocp, dtype=dtype, device=device)
    _check_backend(solver)
    if solver.qp_backend == "pallas_fused":
        raise not_ported("backend='xla' with qp_backend='pallas_fused'",
                         "batched_xla_fused")

    def solve(qps):
        return box_qp_solve(qps, iters=solver.ipm_iters, mu0=solver.ipm_mu0,
                            alpha_frac=solver.ipm_alpha_frac,
                            reg=solver.ipm_reg, riccati=solver.riccati)
    return _batched_rti_step_pallas(ocp, dtype=dtype, device=device,
                                    solve=solve)


def _batched_rti_step_pallas(ocp: cfg.OCPConfig, dtype=torch.float32,
                             device=None, solve=None):
    """`build_qp` for every scenario at once, then `solve` on the batch of
    QPs (default: one launch of the box-QP IPM kernel)."""
    params = BlasterParams.from_config(ocp.model, dtype, device)
    F = discrete_dynamics(blaster_ode, ocp.dt, num_steps=1)
    solver = ocp.solver
    lin = make_linearizer(ocp, params)
    solve = solve or (lambda qps: solve_batched_qp(qps, solver))

    def step(spec: OCPSpec, states: RTIState, x0s: torch.Tensor):
        qps = vmap(lambda xb, ub, x: build_qp(
            spec, RTIState(xb, ub), x, F, params, linearizer=lin,
            solver=solver))(states.xbar, states.ubar, x0s)
        sol = solve(qps)
        new_states = RTIState(xbar=states.xbar + sol.dx,
                              ubar=states.ubar + sol.du)
        return new_states.ubar[:, 0], new_states, _batched_diag(
            spec, sol, new_states)

    return step


def _batched_rti_step_pallas_fused(ocp: cfg.OCPConfig, dtype=torch.float32,
                                   device=None):
    """Batched RTI tick with in-kernel QP assembly and state update: per
    tick the host runs only the batched component-form linearizer, then
    one fuse_cost launch does the rest. The shared spec tensors are
    broadcast over the batch, as the JAX tick does."""
    from mpc_blaster_tpu_torch.dynamics.fastlin import fast_linearize
    from mpc_blaster_tpu_torch.ops.box_qp_ipm import batched_fused_tick

    params = BlasterParams.from_config(ocp.model, dtype, device)
    solver = ocp.solver

    def step(spec: OCPSpec, states: RTIState, x0s: torch.Tensor):
        B = x0s.shape[0]
        xbar, ubar = states.xbar, states.ubar
        x_pred, A, Bm = fast_linearize(xbar, ubar, spec.stage_params, params,
                                       ocp.dt, 1)
        AB = torch.cat([A, Bm], dim=-1)
        c = x_pred - xbar[:, 1:]
        dtw = spec.dt

        def bc(a):
            return a.expand(B, *a.shape)

        Rg = (dtw * spec.R) if solver.qp_r_floor is not None else None
        new_xbar, new_ubar, dg, _ = batched_fused_tick(
            AB, c, xbar, ubar, x0s,
            bc(dtw * spec.Q), bc(spec.Q_t),
            bc(dtw * qp_hessian_R(spec, solver)),
            bc(spec.yref_x), bc(spec.yref_u), bc(spec.yref_e),
            bc(spec.lbx), bc(spec.ubx), bc(spec.lbu), bc(spec.ubu),
            iters=solver.ipm_iters, mu0=solver.ipm_mu0,
            alpha_frac=solver.ipm_alpha_frac,
            reg=max(solver.ipm_reg, 1e-6),
            R_grad=None if Rg is None else bc(Rg))
        diag = RTIDiagnostics(
            qp_kkt_stat=dg["kkt_stat"], qp_kkt_eq=dg["kkt_eq"],
            qp_mu=dg["mu"], step_norm_x=dg["step_norm_x"],
            step_norm_u=dg["step_norm_u"], bound_viol=dg["bound_viol"])
        return new_ubar[:, 0], RTIState(xbar=new_xbar, ubar=new_ubar), diag

    return step
