"""Scenario batching of the RTI tick on one device.

Port of `mpc_blaster_tpu/parallel/mesh.py::batched_rti_step` with
`backend="pallas"`: the QP assembly runs for every scenario at once
(`torch.func.vmap` of `build_qp`, jacfwd linearization inside), then one
launch of the box-QP IPM kernel solves the whole batch. Multi-device
sharding (`sharded_rti_step`, `sharded_sweep`) ports with ROADMAP queue 1
item 13.
"""
from __future__ import annotations

import torch
from torch.func import vmap

from mpc_blaster_tpu_torch import config as cfg
from mpc_blaster_tpu_torch.dynamics.blaster import BlasterParams, blaster_ode
from mpc_blaster_tpu_torch.dynamics.integrators import discrete_dynamics
from mpc_blaster_tpu_torch.ocp.spec import OCPSpec
from mpc_blaster_tpu_torch.sqp.rti import (RTIDiagnostics, RTIState,
                                           _bound_violation, build_qp,
                                           make_linearizer, not_ported,
                                           solve_batched_qp)


def batched_rti_step(ocp: cfg.OCPConfig, dtype=torch.float32,
                     backend: str = "xla", device=None):
    """The RTI tick over a scenario batch.

    Returns step(spec, states, x0s) -> (u0s, states, diags); `spec` is
    shared, states/x0s carry a leading batch axis. `backend="pallas"`
    solves the batch with the box-QP IPM kernel; the JAX package's other
    backends ("xla", its default, and "pallas_fused") are refused.
    """
    if backend in ("xla", "pallas_fused"):
        raise not_ported(f"batched backend {backend!r}", "batched_" + backend)
    if backend != "pallas":
        raise ValueError(f"unknown batched backend {backend!r}")
    return _batched_rti_step_pallas(ocp, dtype=dtype, device=device)


def _batched_rti_step_pallas(ocp: cfg.OCPConfig, dtype=torch.float32,
                             device=None):
    params = BlasterParams.from_config(ocp.model, dtype, device)
    F = discrete_dynamics(blaster_ode, ocp.dt, num_steps=1)
    solver = ocp.solver
    make_linearizer(ocp, params)

    def step(spec: OCPSpec, states: RTIState, x0s: torch.Tensor):
        qps = vmap(lambda xb, ub, x: build_qp(
            spec, RTIState(xb, ub), x, F, params, solver=solver))(
                states.xbar, states.ubar, x0s)
        sol = solve_batched_qp(qps, solver)
        new_states = RTIState(xbar=states.xbar + sol.dx,
                              ubar=states.ubar + sol.du)
        diag = RTIDiagnostics(
            qp_kkt_stat=sol.kkt_stat, qp_kkt_eq=sol.kkt_eq, qp_mu=sol.mu,
            step_norm_x=sol.dx.abs().amax((1, 2)),
            step_norm_u=sol.du.abs().amax((1, 2)),
            bound_viol=_bound_violation(spec, new_states),
        )
        return new_states.ubar[:, 0], new_states, diag

    return step
