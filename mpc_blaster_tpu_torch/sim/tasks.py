"""Task library: figure-8 tracking, the blasting task and the blast scan.

Port of `mpc_blaster_tpu/sim/tasks.py`: a time-varying figure-8 reference
(BASELINE config 2), the nozzle-pointing blasting task with its POC
Jacobians solved at the hover pose (config 3), and the blast scan, where
the vehicle hovers or descends while the jet's point of contact traces a
lemniscate on the ground, judged against the true nonlinear impact point.
The tracking loop re-linearizes the POC rows online ("online",
"online_stagewise", "stagewise_anchored") or keeps them frozen, and its
plant reports the exact impact point (plant_poc="exact") or propagates
the linearized one. The JAX package streams the waypoint window with
`lax.dynamic_slice` inside one `lax.scan`; here the tracking loop is a
Python loop of ticks whose tensors stay on the spec's device: under
`qp_backend="pallas_fused"` each tick is one kernel launch (the window is
a slice of the reference on the device), beside the jet solves of the
online modes and the exact plant.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
from torch.func import vmap

from mpc_blaster_tpu_torch import config as cfg
from mpc_blaster_tpu_torch.device import resolve_device
from mpc_blaster_tpu_torch.dynamics.blaster import (BlasterParams, blaster_ode,
                                                    pack_stage_params)
from mpc_blaster_tpu_torch.dynamics.integrators import discrete_dynamics
from mpc_blaster_tpu_torch.ocp.spec import OCPSpec, build_spec
from mpc_blaster_tpu_torch.poc.solver import (poc_value_and_jacobians,
                                              solve_poc)
from mpc_blaster_tpu_torch.qp.ipm import IpmWarmStart
from mpc_blaster_tpu_torch.sim.closedloop import poc_relinearizer
from mpc_blaster_tpu_torch.sqp.rti import (_check_backend, fused_dyn_statics,
                                           init_rti_state, make_linearizer,
                                           rti_step, rti_step_warm)


class TrackingResult(NamedTuple):
    xs: torch.Tensor      # (Nsim+1, nx)
    us: torch.Tensor      # (Nsim, nu)
    refs: torch.Tensor    # (Nsim, nx) stage-0 reference per tick
    kkt_stat: torch.Tensor
    kkt_eq: torch.Tensor


def figure8_refs(n_points: int, dt: float, amplitude_x: float = 1.0,
                 amplitude_y: float = 0.75, period_s: float = 12.0,
                 z: float = 2.0) -> np.ndarray:
    """(n_points, nx) state references along a lemniscate at altitude z."""
    t = np.arange(n_points) * dt
    w = 2.0 * np.pi / period_s
    refs = np.zeros((n_points, cfg.NX))
    refs[:, 0] = amplitude_x * np.sin(w * t)
    refs[:, 1] = amplitude_y * np.sin(2.0 * w * t)
    refs[:, 2] = z
    # velocity feedforward (consistent reference derivative)
    refs[:, 6] = amplitude_x * w * np.cos(w * t)
    refs[:, 7] = amplitude_y * 2.0 * w * np.cos(2.0 * w * t)
    return refs


def make_tracking_loop(ocp: cfg.OCPConfig, n_steps: int, dtype=torch.float32,
                       plant_substeps: int = 1, warm_start: bool = False,
                       poc_mode: str = "frozen", plant_poc: str = "linear",
                       poc_cfg: Optional[cfg.PocSolverConfig] = None):
    """run(spec, x0, ref_traj) with ref_traj (n_steps + N + 1, nx), on the
    spec's device.

    Per tick i the controller tracks the stage references ref_traj[i+1 :
    i+N+1] (terminal = the last of the window). warm_start=True carries
    IPM slack/dual warm starts between ticks (`rti_step_warm`).

    poc_mode: "frozen" keeps the POC Jacobians in `spec` for the run;
    "online" re-linearizes the jet at the live pose every tick (one jet
    solve); "online_stagewise" linearizes each node at its predicted pose
    xbar[k] (N jet solves in one vmap); "stagewise_anchored" does the
    same and re-anchors the iterate's POC rows to the exact impact point
    at each predicted pose (the value rides the Jacobians' pass; one more
    solve for the terminal node), row 0 staying the measured state.

    plant_poc: "linear" propagates the plant's POC states with the same
    linearized poc_dot the controller model uses; "exact" overwrites them
    after each step with the true nonlinear impact point at the new pose
    (one jet solve per tick). `poc_cfg` sets the jet (default
    `PocSolverConfig()`).
    """
    solver = ocp.solver
    _check_backend(solver)
    N = ocp.N
    pc = poc_cfg or cfg.PocSolverConfig()
    F = discrete_dynamics(blaster_ode, ocp.dt, num_steps=1)
    F_plant = discrete_dynamics(blaster_ode, ocp.dt,
                                num_steps=plant_substeps)
    dyn = (fused_dyn_statics(ocp, 1)
           if solver.qp_backend == "pallas_fused" else None)

    if poc_mode == "stagewise_anchored":
        def relinearize(spec, x, state):
            def at(s):
                poc, *jac = poc_value_and_jacobians(
                    s[3:6], s[12:14], s[0:3], pc.stream_velocity, pc.drag,
                    pc.newton_iters)
                return pack_stage_params(*jac, spec.stage_params[0, -1]), poc
            ps, pocs = vmap(at)(state.xbar[:-1])
            last = state.xbar[-1]
            poc_n, _ = solve_poc(last[3:6], last[12:14], last[0:3],
                                 pc.stream_velocity, pc.drag,
                                 pc.newton_iters)
            xbar = state.xbar.clone()
            # row 0 stays the measured state: the x0 pin acts on xbar[0]
            xbar[1:-1, 14:17] = pocs[1:]
            xbar[-1, 14:17] = poc_n
            return ps, state._replace(xbar=xbar)
    else:
        stage_params_for = poc_relinearizer(poc_mode, pc)

        def relinearize(spec, x, state):
            return stage_params_for(spec.stage_params, x, state.xbar), state

    if plant_poc == "exact":
        def plant_step(x, u0, plant_params, params):
            xn = F_plant(x, u0, plant_params, params)
            poc, _ = solve_poc(xn[3:6], xn[12:14], xn[0:3],
                               pc.stream_velocity, pc.drag, pc.newton_iters)
            xn = xn.clone()
            xn[14:17] = poc
            return xn
    elif plant_poc == "linear":
        def plant_step(x, u0, plant_params, params):
            return F_plant(x, u0, plant_params, params)
    else:
        raise ValueError(f"unknown plant_poc {plant_poc!r}")

    def run(spec: OCPSpec, x0, ref_traj) -> TrackingResult:
        device = spec.Q.device
        params = BlasterParams.from_config(ocp.model, dtype, device)
        lin = make_linearizer(ocp, params)
        x = torch.as_tensor(x0, dtype=dtype, device=device)
        ref_traj = torch.as_tensor(ref_traj, dtype=dtype, device=device)
        state = init_rti_state(ocp, x, dtype)
        plant_params = spec.stage_params[0]
        if warm_start:
            warm = IpmWarmStart.zeros(N, cfg.NX, cfg.NU, dtype, device)
        xs, us, refs, stats, eqs = [x], [], [], [], []
        for i in range(n_steps):
            window = ref_traj[i + 1:i + 1 + N]
            stage_params, state = relinearize(spec, x, state)
            spec_i = spec._replace(yref_x=window, yref_e=window[-1],
                                   stage_params=stage_params)
            if warm_start:
                u0, state, warm, diag = rti_step_warm(
                    spec_i, state, warm, x, params, F, solver,
                    linearizer=lin, dyn_statics=dyn)
            else:
                u0, state, diag = rti_step(spec_i, state, x, params, F,
                                           solver, linearizer=lin,
                                           dyn_statics=dyn)
            x = plant_step(x, u0, plant_params, params)
            xs.append(x)
            us.append(u0)
            refs.append(window[0])
            stats.append(diag.qp_kkt_stat)
            eqs.append(diag.qp_kkt_eq)
        return TrackingResult(xs=torch.stack(xs), us=torch.stack(us),
                              refs=torch.stack(refs),
                              kkt_stat=torch.stack(stats),
                              kkt_eq=torch.stack(eqs))

    return run


def run_figure8(preset: Optional[cfg.Preset] = None, n_steps: int = 240,
                dtype=torch.float32, warm_start: bool = False, device=None,
                **fig_kwargs) -> TrackingResult:
    """BASELINE config 2: figure-8 waypoint tracking, single trajectory,
    on `device`."""
    preset = preset or cfg.simulation_preset()
    ocp = preset.ocp
    device = resolve_device(device)
    refs = figure8_refs(n_steps + ocp.N + 1, ocp.dt, **fig_kwargs)
    spec = build_spec(ocp, dtype=dtype, device=device)
    run = make_tracking_loop(ocp, n_steps, dtype=dtype,
                             warm_start=warm_start)
    x0 = np.zeros(cfg.NX)
    x0[0:3] = refs[0, 0:3]
    x0[6:9] = refs[0, 6:9]
    return run(spec, x0, refs)


def run_blasting(preset: Optional[cfg.Preset] = None, n_steps: int = 200,
                 dtype=torch.float32, device=None):
    """BASELINE config 3: the nozzle-pointing task, its POC Jacobians
    solved at the hover pose (z = 3.5) and held for the run, through the
    frozen closed loop. Returns (ClosedLoopResult, PocSolver)."""
    from mpc_blaster_tpu_torch.dynamics.blaster import pack_stage_params
    from mpc_blaster_tpu_torch.poc.solver import PocSolver
    from mpc_blaster_tpu_torch.sim.closedloop import make_closed_loop

    preset = preset or cfg.simulation_preset()
    ocp = preset.ocp
    device = resolve_device(device)
    solver = PocSolver.from_config(preset.poc)
    solver.solve_jacobians([0.0, 0.0, 0.0], [0.0, 0.0], [0.0, 0.0, 3.5])
    j_mot, j_eul, j_pos = solver.get_jacobians()
    t_blast = 2.2 * 9.81 if ocp.quirks.hardcode_t_blast \
        else ocp.model.blast_thruster
    p = pack_stage_params(j_mot, j_eul, j_pos, t_blast)
    spec = build_spec(ocp, yref=preset.loop.yref, stage_params=p,
                      dtype=dtype, device=device)
    run = make_closed_loop(ocp, n_steps, dtype=dtype)
    return run(spec, torch.as_tensor(preset.loop.x0, dtype=dtype,
                                     device=device)), solver


def blast_scan_refs(n_points: int, dt: float,
                    center=(-0.6, 0.0), amp_x: float = 0.7,
                    amp_y: float = 0.3, period_s: float = 40.0,
                    hover=(0.0, 0.0, 3.5), z_end: Optional[float] = None,
                    t_ramp_s: float = 6.0,
                    carry_frac: float = 0.0) -> np.ndarray:
    """(n_points, nx) references: hover in place while the jet's point of
    contact sweeps a ground lemniscate toward -x (the side the gimbal's
    asymmetric alpha1 box reaches).

    z_end ramps the hover altitude from hover[2] to z_end over t_ramp_s
    (descend while washing, which makes any frozen POC linearization
    stale). carry_frac makes the hover reference co-move: the position
    reference (with a matching velocity feedforward) follows carry_frac of
    the sweep's deviation from its center, so the vehicle carries the
    low-frequency raster the gimbal-rate box cannot follow alone.
    """
    t = np.arange(n_points) * dt
    w = 2.0 * np.pi / period_s
    refs = np.zeros((n_points, cfg.NX))
    refs[:, 0:2] = hover[0:2]
    if z_end is None:
        refs[:, 2] = hover[2]
    else:
        frac = np.minimum(t / t_ramp_s, 1.0)
        refs[:, 2] = hover[2] + (z_end - hover[2]) * frac
        refs[:, 8] = np.where(frac < 1.0, (z_end - hover[2]) / t_ramp_s, 0.0)
    refs[:, 14] = center[0] + amp_x * np.sin(w * t)
    refs[:, 15] = center[1] + amp_y * np.sin(2.0 * w * t)
    if carry_frac:
        dev = refs[:, 14:16] - np.asarray(center)[None]
        refs[:, 0:2] += carry_frac * dev
        refs[:-1, 6:8] += carry_frac * np.diff(refs[:, 14:16],
                                               axis=0) / dt
    return refs


def _staleness_rate(amp_x, amp_y, period_s, hover, z_end, t_ramp_s):
    """How fast the commanded scan moves the jet geometry away from any
    fixed linearization point, in m/s: the lemniscate's sweep speed
    w (amp_x + 2 amp_y) plus the descent rate."""
    w = 2.0 * np.pi / period_s
    descent = 0.0 if z_end is None else abs(hover[2] - z_end) / t_ramp_s
    return w * (amp_x + 2.0 * amp_y) + descent


def select_poc_mode(amp_x: float = 0.7, amp_y: float = 0.3,
                    period_s: float = 40.0, hover=(0.0, 0.0, 3.5),
                    z_end: Optional[float] = None,
                    t_ramp_s: float = 6.0, **_ignored) -> str:
    """The POC-linearization mode for a scan: "online_stagewise" above a
    staleness rate of 0.8 m/s (the aggressive bench profile, ~1.10 m/s),
    "frozen" below it (the gentle one, ~0.54 m/s, where per-stage
    re-linearization only adds jet-solve noise)."""
    rate = _staleness_rate(amp_x, amp_y, period_s, hover, z_end, t_ramp_s)
    return "online_stagewise" if rate > 0.8 else "frozen"


def select_carry_frac(amp_x: float = 0.7, amp_y: float = 0.3,
                      period_s: float = 40.0, hover=(0.0, 0.0, 3.5),
                      z_end: Optional[float] = None,
                      t_ramp_s: float = 6.0, **_ignored) -> float:
    """The co-moving reference's share for a scan, on the same staleness
    rate as `select_poc_mode`: 0.6 above 0.8 m/s (fast sweeps exceed the
    gimbal's rate authority), 0.0 below it (gentle sweeps are cheaper on
    the gimbal alone)."""
    rate = _staleness_rate(amp_x, amp_y, period_s, hover, z_end, t_ramp_s)
    return 0.6 if rate > 0.8 else 0.0


def run_blast_scan(preset: Optional[cfg.Preset] = None, n_steps: int = 240,
                   dtype=torch.float32, poc_mode: str = "auto",
                   plant_poc: str = "exact", frozen_at: str = "hover",
                   device=None, **scan_kwargs) -> TrackingResult:
    """The blast scan on `device`: the drone hovers (or descends) while
    the jet traces a lemniscate on the ground (`blast_scan_refs` with
    `scan_kwargs`). With plant_poc="exact" the plant reports the true
    impact point each tick, so `xs[:, 14:17]` is the true POC.

    frozen_at: where the frozen linearization is taken, "hover" (the
    task's start pose) or "canonical" (the reference's: zero angles,
    z=4); the Jacobians are solved in float64 on the host. poc_mode="auto"
    applies `select_poc_mode` to the scan, and carry_frac="auto" applies
    `select_carry_frac`.
    """
    from mpc_blaster_tpu_torch.dynamics.blaster import pack_stage_params
    from mpc_blaster_tpu_torch.poc.solver import PocSolver

    if poc_mode == "auto":
        poc_mode = select_poc_mode(**scan_kwargs)
    if scan_kwargs.get("carry_frac") == "auto":
        scan_kwargs = dict(scan_kwargs,
                           carry_frac=select_carry_frac(**{
                               k: v for k, v in scan_kwargs.items()
                               if k != "carry_frac"}))
    preset = preset or cfg.simulation_preset()
    ocp = preset.ocp
    device = resolve_device(device)
    hover = scan_kwargs.get("hover", (0.0, 0.0, 3.5))
    refs = blast_scan_refs(n_steps + ocp.N + 1, ocp.dt, **scan_kwargs)

    solver = PocSolver.from_config(preset.poc)
    lin_pos = (0.0, 0.0, 4.0) if frozen_at == "canonical" else hover
    solver.solve_jacobians([0.0, 0.0, 0.0], [0.0, 0.0], lin_pos)
    j_mot, j_eul, j_pos = solver.get_jacobians()
    t_blast = 2.2 * 9.81 if ocp.quirks.hardcode_t_blast \
        else ocp.model.blast_thruster
    p = pack_stage_params(j_mot, j_eul, j_pos, t_blast)
    spec = build_spec(ocp, stage_params=p, dtype=dtype, device=device)

    run = make_tracking_loop(ocp, n_steps, dtype=dtype, poc_mode=poc_mode,
                             plant_poc=plant_poc, poc_cfg=preset.poc)
    f64 = torch.float64
    poc0, _ = solve_poc(torch.zeros(3, dtype=f64), torch.zeros(2, dtype=f64),
                        torch.tensor(hover, dtype=f64),
                        preset.poc.stream_velocity, preset.poc.drag,
                        preset.poc.newton_iters)
    x0 = np.zeros(cfg.NX)
    x0[0:3] = hover
    x0[14:17] = poc0.numpy()
    return run(spec, x0, refs)
