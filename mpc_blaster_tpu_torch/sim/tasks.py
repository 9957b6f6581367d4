"""Task library: figure-8 tracking and the blasting task.

Port of `mpc_blaster_tpu/sim/tasks.py`, the frozen-POC tracking loop: a
time-varying figure-8 reference (BASELINE config 2) and the nozzle-pointing
blasting task with its POC Jacobians solved at the hover pose (config 3).
The JAX package streams the waypoint window with `lax.dynamic_slice` inside
one `lax.scan`; here the tracking loop is a Python loop of ticks whose
tensors stay on the spec's device: under `qp_backend="pallas_fused"`
each tick is one kernel launch (the window is a slice of the reference on
the device).

Not ported yet, and raising (ROADMAP queue 1 item 11): the online POC
modes of `make_tracking_loop` ("online", "online_stagewise",
"stagewise_anchored"), `plant_poc="exact"`, and the blast scan that needs
them (`blast_scan_refs`, `select_poc_mode`, `select_carry_frac`,
`run_blast_scan`).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from mpc_blaster_tpu_torch import config as cfg
from mpc_blaster_tpu_torch.dynamics.blaster import BlasterParams, blaster_ode
from mpc_blaster_tpu_torch.dynamics.integrators import discrete_dynamics
from mpc_blaster_tpu_torch.ocp.spec import OCPSpec, build_spec
from mpc_blaster_tpu_torch.qp.ipm import IpmWarmStart
from mpc_blaster_tpu_torch.sqp.rti import (_check_backend, fused_dyn_statics,
                                           init_rti_state, make_linearizer,
                                           not_ported, rti_step,
                                           rti_step_warm)

_ONLINE = ("online", "online_stagewise", "stagewise_anchored")


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
    IPM slack/dual warm starts between ticks (`rti_step_warm`). The POC
    Jacobians in `spec` stay fixed for the run (poc_mode="frozen") and the
    plant propagates its POC states with the same linearized poc_dot
    (plant_poc="linear"); the online modes and the exact plant POC are
    not ported yet and raise.
    """
    if poc_mode in _ONLINE:
        raise not_ported(f"poc_mode={poc_mode!r}", "blast_scan")
    if poc_mode != "frozen":
        raise ValueError(f"unknown poc_mode {poc_mode!r}")
    if plant_poc == "exact":
        raise not_ported("plant_poc='exact'", "blast_scan")
    if plant_poc != "linear":
        raise ValueError(f"unknown plant_poc {plant_poc!r}")
    del poc_cfg  # read by the online modes and the exact plant only
    solver = ocp.solver
    _check_backend(solver)
    N = ocp.N
    F = discrete_dynamics(blaster_ode, ocp.dt, num_steps=1)
    F_plant = discrete_dynamics(blaster_ode, ocp.dt,
                                num_steps=plant_substeps)
    dyn = (fused_dyn_statics(ocp, 1)
           if solver.qp_backend == "pallas_fused" else None)

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
            spec_i = spec._replace(yref_x=window, yref_e=window[-1])
            if warm_start:
                u0, state, warm, diag = rti_step_warm(
                    spec_i, state, warm, x, params, F, solver,
                    linearizer=lin, dyn_statics=dyn)
            else:
                u0, state, diag = rti_step(spec_i, state, x, params, F,
                                           solver, linearizer=lin,
                                           dyn_statics=dyn)
            x = F_plant(x, u0, plant_params, params)
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


def blast_scan_refs(*args, **kwargs):
    """The blast scan's raster references: not ported yet."""
    raise not_ported("blast_scan_refs", "blast_scan")


def select_poc_mode(*args, **kwargs):
    """The blast scan's POC-mode rule: not ported yet."""
    raise not_ported("select_poc_mode", "blast_scan")


def select_carry_frac(*args, **kwargs):
    """The blast scan's co-moving reference rule: not ported yet."""
    raise not_ported("select_carry_frac", "blast_scan")


def run_blast_scan(*args, **kwargs):
    """The blast-scan showcase (online POC modes, exact plant POC): not
    ported yet."""
    raise not_ported("run_blast_scan", "blast_scan")
