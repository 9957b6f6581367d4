"""Closed-loop NMPC simulation.

Port of `mpc_blaster_tpu/sim/closedloop.py`: cold ticks, warm-started
ticks, warm ticks under the divergence watchdog (`solver.warm_watchdog`,
the chain behind `config.deployed_solver("fastest")`) and the
Jacobian-reuse ticks (`jac_refresh > 1`, cold or warm), with the POC
stage parameters frozen or re-linearized every tick ("online",
"online_stagewise"), on the `"riccati"` (the presets' default),
`"pallas"` or deployed one-launch `"pallas_fused"` QP backend.
The JAX package runs the whole rollout as one jitted `lax.scan`; here
`closed_loop` is a Python loop of eager ticks whose tensors stay on the
device of the spec, and `make_closed_loop` captures the tick as a CUDA
graph and replays it (`utils/capture.py::Scan`). On CUDA the kernel
backends' QP solve is one kernel launch per tick; the guarded chain adds
the redo launch, which returns at once unless the tick tripped.
The plant is the same RK4 model with its own stage parameters (T_blast
pinned to 2.2*9.81, as the reference's simulation entry point sets it).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from mpc_blaster_tpu_torch import config as cfg
from mpc_blaster_tpu_torch.device import resolve_device
from mpc_blaster_tpu_torch.dynamics.blaster import BlasterParams, blaster_ode
from mpc_blaster_tpu_torch.dynamics.integrators import discrete_dynamics
from mpc_blaster_tpu_torch.ocp.spec import OCPSpec, build_spec, total_cost
from mpc_blaster_tpu_torch.poc.solver import (poc_stage_params,
                                              poc_stage_params_along)
from mpc_blaster_tpu_torch.sqp import rti as R
from mpc_blaster_tpu_torch.sqp.rti import (RTIState, fused_dyn_statics,
                                           init_rti_state, make_linearizer)
from mpc_blaster_tpu_torch.utils import capture


class ClosedLoopResult(NamedTuple):
    xs: torch.Tensor        # (Nsim+1, nx)
    us: torch.Tensor        # (Nsim, nu)
    costs: torch.Tensor     # (Nsim,) controller objective per tick
    kkt_stat: torch.Tensor  # (Nsim,)
    kkt_eq: torch.Tensor    # (Nsim,)


def poc_relinearizer(poc_mode: str, pc: cfg.PocSolverConfig):
    """f(stage_params, x, xbar) -> the (N, np) stage parameters of one tick
    under `poc_mode`: "frozen" keeps `stage_params`; "online"
    re-linearizes the jet at the live pose x (one solve, every stage the
    same row); "online_stagewise" linearizes stage k at its predicted
    pose xbar[k] (N solves in one vmap). T_blast is kept."""
    if poc_mode == "online":
        def f(stage_params, x, xbar):
            return poc_stage_params(x, stage_params[0, -1], pc).expand(
                stage_params.shape[0], -1)
    elif poc_mode == "online_stagewise":
        def f(stage_params, x, xbar):
            return poc_stage_params_along(xbar[:-1], stage_params[0, -1],
                                          pc)
    elif poc_mode == "frozen":
        def f(stage_params, x, xbar):
            return stage_params
    else:
        raise ValueError(f"unknown poc_mode {poc_mode!r}")
    return f


class _Carry(NamedTuple):
    """What one tick hands the next (None where the loop has none)."""

    x: torch.Tensor
    state: RTIState
    warm: Optional[R.IpmWarmStart]
    wd: Optional[R.WatchdogState]
    cache: Optional[R.JacCache]


def _loop(spec: OCPSpec, ocp: cfg.OCPConfig, x0, plant_params, dtype,
          plant_substeps, rti0, poc_mode, poc_cfg, warm_start, jac_refresh):
    """The closed loop as (consts, carry0, tick): tick(consts, carry,
    refresh) -> (carry, (x_next, u0, cost, kkt_stat, kkt_eq)), `refresh`
    the Python bool of the Jacobian-reuse ticks. `consts` (the spec and
    the plant's stage parameters) and the carry hold every tensor that
    depends on the call; the tick closes over the configuration alone."""
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
    stage_params_for = poc_relinearizer(poc_mode,
                                        poc_cfg or cfg.PocSolverConfig())
    if warm_start and solver.warm_watchdog and jac_refresh > 1:
        raise ValueError("warm_watchdog does not compose with "
                         "jac_refresh>1 (the guarded tick has no "
                         "jac-reuse variant); use jac_refresh=1")
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
    nx, nu = x.shape[-1], state.ubar.shape[-1]
    carry = _Carry(
        x=x, state=state,
        warm=(R.IpmWarmStart.zeros(spec.horizon, nx, nu, dtype, device)
              if warm_start else None),
        wd=R.WatchdogState.init(dtype, device) if warm_start else None,
        cache=(R.JacCache.zeros(spec.horizon, nx, nu, dtype, device)
               if jac_refresh > 1 else None))
    kw = dict(linearizer=lin, dyn_statics=dyn)

    def tick(consts, c: _Carry, refresh: bool):
        spec, plant_params = consts
        x, state, warm, wd, cache = c
        spec_t = spec._replace(stage_params=stage_params_for(
            spec.stage_params, x, state.xbar))
        # the tick functions are looked up per call, so a caller can wrap
        # them (chip_smoke.py reads the watchdog's trips this way)
        if warm_start and jac_refresh > 1:
            u0, state, warm, cache, diag = R.rti_step_warm_jacreuse(
                spec_t, state, warm, cache, refresh, x, params, F, solver,
                linearizer=lin)
        elif guarded:
            u0, state, warm, wd, diag = R.rti_step_warm_guarded(
                spec_t, state, warm, wd, x, params, F, solver, **kw)
        elif warm_start:
            u0, state, warm, diag = R.rti_step_warm(
                spec_t, state, warm, x, params, F, solver, **kw)
        elif jac_refresh > 1:
            u0, state, cache, diag = R.rti_step_jacreuse(
                spec_t, state, cache, refresh, x, params, F, solver,
                linearizer=lin)
        else:
            u0, state, diag = R.rti_step(spec_t, state, x, params, F,
                                         solver, **kw)
        x_next = F_plant(x, u0, plant_params, params)
        out = (x_next, u0, total_cost(spec_t, state.xbar, state.ubar),
               diag.qp_kkt_stat, diag.qp_kkt_eq)
        return _Carry(x_next, state, warm, wd, cache), out

    return (spec, plant_params), carry, tick


def _result(x0: torch.Tensor, outs) -> ClosedLoopResult:
    xs, us, costs, stats, eqs = outs
    return ClosedLoopResult(xs=torch.cat([x0[None], xs], 0), us=us,
                            costs=costs, kkt_stat=stats, kkt_eq=eqs)


def closed_loop(spec: OCPSpec, ocp: cfg.OCPConfig, x0, n_steps: int,
                plant_params: Optional[torch.Tensor] = None,
                dtype=torch.float32, plant_substeps: int = 1,
                rti0: Optional[RTIState] = None,
                poc_mode: str = "frozen",
                poc_cfg: Optional[cfg.PocSolverConfig] = None,
                warm_start: bool = False,
                jac_refresh: int = 1) -> ClosedLoopResult:
    """Run `n_steps` control ticks from x0 on the spec's device, eagerly
    (the JAX package's traced body; `make_closed_loop` captures it).

    poc_mode: "frozen" keeps the spec's stage parameters for the whole run
    (the reference computes its POC Jacobians once before the loop);
    "online" re-linearizes the jet POC Jacobians at the current pose every
    tick (one jet solve, every stage the same row); "online_stagewise"
    linearizes stage k at its predicted pose xbar[k] (N jet solves in one
    vmap). `poc_cfg` sets the jet (default `PocSolverConfig()`).
    warm_start=True carries IPM slack/dual warm starts between ticks
    (`rti_step_warm`), under the watchdog when `solver.warm_watchdog`
    (`rti_step_warm_guarded`); pair it with a reduced `solver.ipm_iters`
    and `solver.warm_shift=True` (raw unshifted chains degrade on
    transients). jac_refresh > 1 re-linearizes the dynamics only every
    jac_refresh-th tick and keeps the shooting defects exact on every
    tick (`rti_step_jacreuse`, or `rti_step_warm_jacreuse` with
    warm_start).
    """
    consts, carry, tick = _loop(spec, ocp, x0, plant_params, dtype,
                                plant_substeps, rti0, poc_mode, poc_cfg,
                                warm_start, jac_refresh)
    outs = []
    for k in range(n_steps):
        carry, out = tick(consts, carry, k % jac_refresh == 0)
        outs.append(out)
    return _result(torch.as_tensor(x0, dtype=dtype, device=spec.Q.device),
                   tuple(torch.stack(col) for col in zip(*outs)))


def make_closed_loop(ocp: cfg.OCPConfig, n_steps: int, dtype=torch.float32,
                     plant_substeps: int = 1, poc_mode: str = "frozen",
                     poc_cfg: Optional[cfg.PocSolverConfig] = None,
                     warm_start: bool = False, jac_refresh: int = 1):
    """Closed-loop runner `run(spec, x0)` with static configuration: the
    JAX package's jitted `lax.scan`, as a `utils/capture.py` Scan. On the
    card each tick (the RTI tick, the plant step and the cost) is one
    CUDA graph replayed `n_steps` times (a refresh and a reuse graph with
    `jac_refresh > 1`), the carry handed on inside the graph and the
    history written into preallocated outputs, with no host sync until
    the end; on the CPU the same steps run without a graph. The results
    equal `closed_loop`'s bit for bit."""
    scan = capture.Scan()
    refresh = [k % jac_refresh == 0 for k in range(n_steps)]

    def run(spec: OCPSpec, x0):
        consts, carry, tick = _loop(spec, ocp, x0, None, dtype,
                                    plant_substeps, None, poc_mode, poc_cfg,
                                    warm_start, jac_refresh)
        outs, _ = scan(tick, consts, carry, refresh)
        return _result(carry.x, outs)
    run.scan = scan
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

    device = resolve_device(device)
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
    as the reference's simulation entry point does; poc_mode="online"
    re-linearizes them at the live pose every tick, with the preset's jet
    (`preset.poc`). Cold ticks, as in the JAX package: a warm loop is
    `make_closed_loop(ocp, n, warm_start=True)`."""
    n = n_steps if n_steps is not None else preset.loop.n_steps
    device = resolve_device(device)
    if stage_params is None and (with_poc or poc_mode == "online"):
        stage_params = preset_stage_params(preset, dtype, device)
    spec = build_spec(preset.ocp, yref=preset.loop.yref,
                      stage_params=stage_params, dtype=dtype, device=device)
    run = make_closed_loop(preset.ocp, n, dtype=dtype, poc_mode=poc_mode,
                           poc_cfg=preset.poc)
    return run(spec, torch.as_tensor(preset.loop.x0, dtype=dtype,
                                     device=device))
