"""Closed-loop NMPC simulation.

Port of `mpc_blaster_tpu/sim/closedloop.py`, the frozen-POC,
`jac_refresh=1` branches: cold ticks, warm-started ticks, and warm ticks
under the divergence watchdog (`solver.warm_watchdog`, the chain behind
`config.deployed_solver("fastest")`), on the `"riccati"` (the presets'
default), `"pallas"` or deployed one-launch `"pallas_fused"` QP backend.
The JAX package runs the whole rollout as one `lax.scan`; here it is a
Python loop of ticks whose tensors stay on the device of the spec (on
CUDA the kernel backends' QP solve is one kernel launch per tick; the
guarded chain adds the redo launch, which returns at once unless the tick
tripped).
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
from mpc_blaster_tpu_torch.sqp import rti as R
from mpc_blaster_tpu_torch.sqp.rti import (RTIState, fused_dyn_statics,
                                           init_rti_state, make_linearizer,
                                           not_ported)


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
    warm_start=True carries IPM slack/dual warm starts between ticks
    (`rti_step_warm`), under the watchdog when `solver.warm_watchdog`
    (`rti_step_warm_guarded`); pair it with a reduced `solver.ipm_iters`
    and `solver.warm_shift=True` (raw unshifted chains degrade on
    transients).
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
    if warm_start and solver.warm_watchdog and jac_refresh > 1:
        raise ValueError("warm_watchdog does not compose with "
                         "jac_refresh>1 (the guarded tick has no "
                         "jac-reuse variant); use jac_refresh=1")
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
    guarded = warm_start and solver.warm_watchdog
    if warm_start:
        warm = R.IpmWarmStart.zeros(spec.horizon, x.shape[-1],
                                    state.ubar.shape[-1], dtype, device)
        wd = R.WatchdogState.init(dtype, device)
    kw = dict(linearizer=lin, dyn_statics=dyn)

    xs, us, costs, stats, eqs = [x], [], [], [], []
    for _ in range(n_steps):
        # the tick functions are looked up per call, so a caller can wrap
        # them (chip_smoke.py reads the watchdog's trips this way)
        if guarded:
            u0, state, warm, wd, diag = R.rti_step_warm_guarded(
                spec, state, warm, wd, x, params, F, solver, **kw)
        elif warm_start:
            u0, state, warm, diag = R.rti_step_warm(
                spec, state, warm, x, params, F, solver, **kw)
        else:
            u0, state, diag = R.rti_step(spec, state, x, params, F, solver,
                                         **kw)
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
    as the reference's simulation entry point does. Cold ticks, as in the
    JAX package: a warm loop is `make_closed_loop(ocp, n,
    warm_start=True)`."""
    n = n_steps if n_steps is not None else preset.loop.n_steps
    if stage_params is None and (with_poc or poc_mode == "online"):
        stage_params = preset_stage_params(preset, dtype, device)
    spec = build_spec(preset.ocp, yref=preset.loop.yref,
                      stage_params=stage_params, dtype=dtype, device=device)
    run = make_closed_loop(preset.ocp, n, dtype=dtype, poc_mode=poc_mode)
    return run(spec, torch.as_tensor(preset.loop.x0, dtype=dtype,
                                     device=device))
