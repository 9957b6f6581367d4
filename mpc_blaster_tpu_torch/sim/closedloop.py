"""Closed-loop NMPC simulation.

Port of `mpc_blaster_tpu/sim/closedloop.py`, the cold, frozen-POC,
`jac_refresh=1` branch, with `qp_backend="pallas"` (either linearizer) or
the deployed one-launch tick `"pallas_fused"`. The JAX package runs the
whole rollout as one `lax.scan`; here it is a Python loop of ticks whose
tensors stay on the device of the spec (the QP solve is one kernel launch
per tick on CUDA).
The plant is the same RK4 model with its own stage parameters (T_blast
pinned to 2.2*9.81, as the reference's simulation entry point sets it).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from mpc_blaster_tpu_torch import config as cfg
from mpc_blaster_tpu_torch.dynamics.blaster import BlasterParams, blaster_ode
from mpc_blaster_tpu_torch.dynamics.integrators import discrete_dynamics
from mpc_blaster_tpu_torch.ocp.spec import OCPSpec, build_spec, total_cost
from mpc_blaster_tpu_torch.sqp.rti import (RTIState, fused_dyn_statics,
                                           init_rti_state, make_linearizer,
                                           not_ported, rti_step)


class ClosedLoopResult(NamedTuple):
    xs: torch.Tensor        # (Nsim+1, nx)
    us: torch.Tensor        # (Nsim, nu)
    costs: torch.Tensor     # (Nsim,) controller objective per tick
    kkt_stat: torch.Tensor  # (Nsim,)
    kkt_eq: torch.Tensor    # (Nsim,)


def closed_loop(spec: OCPSpec, ocp: cfg.OCPConfig, x0, n_steps: int,
                plant_params: Optional[torch.Tensor] = None,
                dtype=torch.float32, plant_substeps: int = 1,
                rti0: Optional[RTIState] = None,
                poc_mode: str = "frozen",
                warm_start: bool = False,
                jac_refresh: int = 1) -> ClosedLoopResult:
    """Run `n_steps` control ticks from x0 on the spec's device.

    poc_mode="frozen" keeps the spec's stage parameters for the whole run
    (the reference computes its POC Jacobians once before the loop).
    """
    # One substep count feeds both the forward map and the linearizer.
    ctrl_substeps = 1
    solver = ocp.solver
    # qp_backend="pallas_fused" re-linearizes inside the kernel every tick,
    # so Jacobian reuse is refused with it, as in the JAX package.
    dyn = (fused_dyn_statics(ocp, ctrl_substeps)
           if solver.qp_backend == "pallas_fused" else None)
    if dyn is not None and jac_refresh > 1:
        raise ValueError("jac_refresh>1 is not supported with "
                         "qp_backend='pallas_fused' (the fused kernel "
                         "re-linearizes in-kernel every tick)")
    if poc_mode in ("online", "online_stagewise"):
        raise not_ported(f"poc_mode={poc_mode!r}", "online")
    if poc_mode != "frozen":
        raise ValueError(f"unknown poc_mode {poc_mode!r}")
    if warm_start:
        raise not_ported("warm_start=True", "warm")
    if jac_refresh > 1:
        raise not_ported("jac_refresh>1", "jac_refresh")
    device = spec.Q.device
    params = BlasterParams.from_config(ocp.model, dtype, device)
    F = discrete_dynamics(blaster_ode, ocp.dt, num_steps=ctrl_substeps)
    F_plant = discrete_dynamics(blaster_ode, ocp.dt,
                                num_steps=plant_substeps)
    lin = make_linearizer(ocp, params, num_steps=ctrl_substeps)
    x = torch.as_tensor(x0, dtype=dtype, device=device)
    if plant_params is None:
        # the plant uses the controller's stage-0 parameters with T_blast
        # pinned to 2.2*9.81
        plant_params = spec.stage_params[0].clone()
        plant_params[-1] = 2.2 * 9.81
    plant_params = torch.as_tensor(plant_params, dtype=dtype, device=device)
    state = rti0 if rti0 is not None else init_rti_state(ocp, x, dtype)

    xs, us, costs, stats, eqs = [x], [], [], [], []
    for _ in range(n_steps):
        u0, state, diag = rti_step(spec, state, x, params, F, solver,
                                   linearizer=lin, dyn_statics=dyn)
        x = F_plant(x, u0, plant_params, params)
        xs.append(x)
        us.append(u0)
        costs.append(total_cost(spec, state.xbar, state.ubar))
        stats.append(diag.qp_kkt_stat)
        eqs.append(diag.qp_kkt_eq)
    return ClosedLoopResult(xs=torch.stack(xs), us=torch.stack(us),
                            costs=torch.stack(costs),
                            kkt_stat=torch.stack(stats),
                            kkt_eq=torch.stack(eqs))


def make_closed_loop(ocp: cfg.OCPConfig, n_steps: int, dtype=torch.float32,
                     plant_substeps: int = 1, poc_mode: str = "frozen",
                     warm_start: bool = False, jac_refresh: int = 1):
    """Closed-loop runner `run(spec, x0)` with static configuration."""
    def run(spec: OCPSpec, x0):
        return closed_loop(spec, ocp, x0, n_steps, dtype=dtype,
                           plant_substeps=plant_substeps, poc_mode=poc_mode,
                           warm_start=warm_start, jac_refresh=jac_refresh)
    return run


def preset_stage_params(preset: cfg.Preset, dtype=torch.float32,
                        device=None):
    """Stage parameters exactly as the reference entry point supplies them.

    - simulation: POC Jacobians solved once at the canonical pose before
      the loop and held constant; computed in float64 on the host, then
      cast to the loop's dtype;
    - flight: never set -> None (codegen defaults: zero Jacobians).
    """
    quirks = preset.ocp.quirks
    if quirks.zero_poc_jacobians or not quirks.constant_poc_jacobians:
        return None  # build_spec applies the codegen defaults
    from mpc_blaster_tpu_torch.dynamics.blaster import pack_stage_params
    from mpc_blaster_tpu_torch.poc.solver import PocSolver

    solver = PocSolver.from_config(preset.poc).initialise()
    j_mot, j_eul, j_pos = solver.get_jacobians()
    t_blast = (2.2 * 9.81 if quirks.hardcode_t_blast
               else preset.ocp.model.blast_thruster)
    p = pack_stage_params(j_mot, j_eul, j_pos, t_blast)
    return p.to(dtype=dtype, device=device)


def run_preset(preset: cfg.Preset, n_steps: Optional[int] = None,
               dtype=torch.float32, stage_params=None,
               with_poc: bool = False, poc_mode: str = "frozen",
               device=None) -> ClosedLoopResult:
    """Reproduce a reference entry point end to end on `device`.

    with_poc=True computes the POC Jacobians through the jet solver first,
    as the reference's simulation entry point does. The preset's solver
    must select a ported backend (`qp_backend="pallas"` or
    `"pallas_fused"`, e.g. `config.deployed_solver("safe")`)."""
    n = n_steps if n_steps is not None else preset.loop.n_steps
    if stage_params is None and (with_poc or poc_mode == "online"):
        stage_params = preset_stage_params(preset, dtype, device)
    spec = build_spec(preset.ocp, yref=preset.loop.yref,
                      stage_params=stage_params, dtype=dtype, device=device)
    run = make_closed_loop(preset.ocp, n, dtype=dtype, poc_mode=poc_mode)
    return run(spec, torch.as_tensor(preset.loop.x0, dtype=dtype,
                                     device=device))
