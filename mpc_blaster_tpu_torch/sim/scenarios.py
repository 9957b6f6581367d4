"""Scenario generation and the offset-free deployment loop.

Port of `mpc_blaster_tpu/sim/scenarios.py`: the scenario draws, the
plant- and controller-side disturbance models, and `offset_free_loop`, the
B=1 offset-free loop (a constant-disturbance observer whose six force and
torque estimates ride in stage-parameter rows 25-30, the "blaster_dist"
model family). The JAX package runs the loop as one `lax.scan`; here it
is a Python loop of ticks whose tensors stay on the spec's device: under
`qp_backend="pallas_fused"` each tick is one launch of the box-QP IPM
kernel with the "blaster_dist" prologue, and the observer update needs no
host sync.

`fault_sweep` and `disturbance_sweep` run a closed loop per scenario.
The JAX package vmaps a scan of ticks over scenarios, each with its own
disturbance closure; here they are written batch-explicit: a Python loop
of ticks over a (B, ...) batch on the spec's device, each tick one
`parallel/mesh.py::batched_tick` with one spec per scenario (its target
in `yref`). The disturbances are data: the plant's wind rides in the
stage-parameter rows 25-27 of `dist_param_ode`, and the observer's six
estimates in the controller's rows 25-30, so one controller model serves
the whole batch and a "pallas" tick is one kernel launch for all B.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from mpc_blaster_tpu_torch import config as cfg
from mpc_blaster_tpu_torch.device import resolve_device
from mpc_blaster_tpu_torch.dynamics.blaster import BlasterParams, blaster_ode
from mpc_blaster_tpu_torch.dynamics.integrators import discrete_dynamics
from mpc_blaster_tpu_torch.ocp.spec import OCPSpec
from mpc_blaster_tpu_torch.parallel.mesh import batched_tick
from mpc_blaster_tpu_torch.sqp.rti import (_check_backend, fused_dyn_statics,
                                           init_rti_state, make_linearizer,
                                           rti_step)


class ScenarioBatch(NamedTuple):
    x0: torch.Tensor        # (B, nx) initial states
    wind: torch.Tensor      # (B, 3) constant wind acceleration [m/s^2]
    target: torch.Tensor    # (B, 3) position targets


class SweepResult(NamedTuple):
    final_states: torch.Tensor   # (B, nx)
    pos_err: torch.Tensor        # (B,) final position error
    worst_kkt_eq: torch.Tensor   # (B,)
    settled: torch.Tensor        # (B,) bool: err < 0.25 m


def sample_scenarios(batch: int, seed: int = 0, pos_spread: float = 0.4,
                     wind_max: float = 1.0, target_spread: float = 0.3,
                     base_target=(0.0, 0.0, 3.5),
                     device=None) -> ScenarioBatch:
    """The JAX package's draws (same numpy generator, same numbers)."""
    rng = np.random.default_rng(seed)
    x0 = np.zeros((batch, cfg.NX), np.float32)
    x0[:, 0:2] = rng.uniform(-pos_spread, pos_spread, (batch, 2))
    x0[:, 2] = rng.uniform(0.0, 0.5, batch)
    wind = rng.uniform(-wind_max, wind_max, (batch, 3)).astype(np.float32)
    wind[:, 2] *= 0.3  # vertical gusts weaker
    target = (np.asarray(base_target, np.float32)
              + rng.uniform(-target_spread, target_spread,
                            (batch, 3)).astype(np.float32))
    target[:, 2] = np.clip(target[:, 2], 1.0, 4.5)
    device = resolve_device(device)
    return ScenarioBatch(*(torch.as_tensor(a, device=device)
                           for a in (x0, wind, target)))


def _add_rows(xdot, lo, d):
    """xdot with `d` added to rows lo .. lo + len(d) (no in-place write:
    jacfwd differentiates through it)."""
    return torch.cat([xdot[:lo], xdot[lo:lo + d.shape[-1]] + d,
                      xdot[lo + d.shape[-1]:]])


def _windy_plant_ode(x, u, p, params, wind):
    """Plant-side model mismatch: constant wind acceleration on v."""
    return _add_rows(blaster_ode(x, u, p, params), 6, wind)


def _disturbed_ode(x, u, p, params, d_v, d_w):
    """Controller-side disturbance model: force (v_dot) and torque
    (omega_dot) acceleration offsets, the 6-channel observer target."""
    return _add_rows(_add_rows(blaster_ode(x, u, p, params), 6, d_v), 9,
                     d_w)


def dist_param_ode(x, u, p, params):
    """`_disturbed_ode` with the 6 disturbance channels carried as extra
    stage-parameter rows p[25:31] (the vector form of
    `dynamics/fastlin.py::_ode_rows_dist`): the estimates stay data, so
    one kernel prologue serves every estimate."""
    return _disturbed_ode(x, u, p, params, p[25:28], p[28:31])


class OffsetFreeResult(NamedTuple):
    xs: torch.Tensor        # (n_steps+1, nx)
    us: torch.Tensor        # (n_steps, nu)
    d_hist: torch.Tensor    # (n_steps, 6) force+torque disturbance estimates
    kkt_eq: torch.Tensor    # (n_steps,)


def offset_free_loop(spec: OCPSpec, ocp: cfg.OCPConfig, x0, wind,
                     n_steps: int = 120, dtype=torch.float32,
                     observer_gain: float = 0.5,
                     derate=None) -> OffsetFreeResult:
    """B=1 offset-free deployment loop (Pannocchia/Rawlings constant-
    disturbance observer) with the disturbance estimates riding the
    stage-parameter rows p[25:31] ("blaster_dist" model family), on the
    spec's device.

    With `ocp.solver.qp_backend == "pallas_fused"` the whole tick, the RK4
    linearization of the disturbance-augmented model included, is one
    kernel launch; any other backend linearizes the same family on the
    host (`fast_linearize(family="blaster_dist")`).

    wind: (3,) constant plant wind acceleration (the controller is blind
    to it); derate: optional (4,) rotor effectiveness. The JAX docstring
    records the horizon caveat: the sim preset needs N >= 24 at dt = 1/30
    for the compensated loop to settle.
    """
    device = spec.Q.device
    params = BlasterParams.from_config(ocp.model, dtype, device)
    solver = ocp.solver
    _check_backend(solver)
    F = discrete_dynamics(dist_param_ode, ocp.dt, num_steps=1)
    use_fused = solver.qp_backend == "pallas_fused"
    dyn = (fused_dyn_statics(ocp, 1, family="blaster_dist")
           if use_fused else None)
    if use_fused:
        lin = None
    else:
        from mpc_blaster_tpu_torch.dynamics.fastlin import fast_linearize

        def lin(xbar, ubar, stage_params):
            return fast_linearize(xbar, ubar, stage_params, params,
                                  ocp.dt, 1, family="blaster_dist")

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=device)
    x = t(x0)
    wind = t(wind)
    dr = torch.ones(4, dtype=dtype, device=device) if derate is None \
        else t(derate)
    N = spec.horizon
    plant_p = spec.stage_params[0].clone()
    plant_p[-1] = 2.2 * 9.81
    F_plant = discrete_dynamics(
        lambda xx, uu, pp, par: _windy_plant_ode(xx, uu, pp, par, wind),
        ocp.dt, num_steps=1)

    st = init_rti_state(ocp, x, dtype)
    d_est = torch.zeros(6, dtype=dtype, device=device)
    vw_pred = x[6:12]
    xs, us, ds, eqs = [x], [], [], []
    for _ in range(n_steps):
        d_est = d_est + observer_gain * (x[6:12] - vw_pred) / ocp.dt
        sp = torch.cat([spec.stage_params, d_est.expand(N, 6)], 1)
        u0, st, diag = rti_step(spec._replace(stage_params=sp), st, x,
                                params, F, solver, linearizer=lin,
                                dyn_statics=dyn)
        u_eff = torch.cat([u0[0:4] * dr, u0[4:]])
        x_next = F_plant(x, u_eff, plant_p, params)
        vw_pred = F(x, u0, sp[0], params)[6:12]
        x = x_next
        xs.append(x)
        us.append(u0)
        ds.append(d_est)
        eqs.append(diag.qp_kkt_eq)
    return OffsetFreeResult(xs=torch.stack(xs), us=torch.stack(us),
                            d_hist=torch.stack(ds), kkt_eq=torch.stack(eqs))


def _sweep(spec: OCPSpec, ocp: cfg.OCPConfig, x0, target, plant_d, derate,
           n_steps: int, dtype, offset_free: bool, observer_gain: float,
           torque: bool) -> SweepResult:
    """The closed loops of a sweep, batch-explicit on the spec's device.

    x0, target: (B, nx), (B, 3); plant_d: (B, 6) the plant's force and
    torque accelerations (rows 25-30 of `dist_param_ode`); derate: (B, 4)
    rotor effectiveness. With `offset_free` the observer innovates the
    force estimate (and the torque estimate when `torque`) from the
    velocity residuals and the controller predicts with `dist_param_ode`
    carrying the estimates, linearized with jacfwd; blind, it predicts
    with the nominal model and `solver.lin_backend`.
    """
    device = spec.Q.device
    solver = ocp.solver
    _check_backend(solver)
    if solver.qp_backend == "pallas_fused":
        # the JAX rule: sweeps solve on the batched kernel, never the
        # one-launch tick (its B=1 offset-free form is offset_free_loop)
        solver = dataclasses.replace(solver, qp_backend="pallas")
    params = BlasterParams.from_config(ocp.model, dtype, device)
    F_dist = discrete_dynamics(dist_param_ode, ocp.dt, num_steps=1)
    if offset_free:
        # lin_backend is honoured on the nominal model only
        step = batched_tick(solver, params, F_dist, None, None)
    else:
        F = discrete_dynamics(blaster_ode, ocp.dt, num_steps=1)
        step = batched_tick(solver, params, F,
                            make_linearizer(ocp, params), None)

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=device)
    x, target, plant_d, derate = t(x0), t(target), t(plant_d), t(derate)
    B, N = x.shape[0], spec.horizon
    yref_x = spec.yref_x.expand(B, N, cfg.NX).clone()
    yref_x[:, :, 0:3] = target[:, None]
    yref_e = spec.yref_e.expand(B, cfg.NX).clone()
    yref_e[:, 0:3] = target
    spec_b = spec._replace(yref_x=yref_x, yref_e=yref_e)
    x, _, worst_eq = batched_loop(
        step, spec_b, ocp, x, n_steps, params, plant_d=plant_d,
        derate=derate, observer_gain=observer_gain if offset_free else None,
        torque=torque)
    err = torch.linalg.norm(x[:, 0:3] - target, dim=-1)
    return SweepResult(final_states=x, pos_err=err, worst_kkt_eq=worst_eq,
                       settled=err < 0.25)


def batched_loop(step, spec: OCPSpec, ocp: cfg.OCPConfig, x: torch.Tensor,
                 n_steps: int, params: BlasterParams, plant_d=None,
                 derate=None, observer_gain=None, torque: bool = False):
    """The closed loops of a batch: `n_steps` ticks of `step` (a
    `parallel/mesh.py::batched_tick`, or a tick built on it), each
    followed by the plant's RK4 step, on x's device.

    x: (B, nx). The plant is the nominal model with the controller's
    stage-0 parameters and T_blast pinned to 2.2*9.81, as in
    `sim/closedloop.py::closed_loop`; `plant_d` (B, 6) adds force and
    torque accelerations (rows 25-30 of `dist_param_ode`) and `derate`
    (B, 4) scales each rotor's commanded thrust. With `observer_gain` the
    constant-disturbance observer innovates the force estimate (and the
    torque estimate when `torque`) from the velocity residuals, and its
    six estimates ride in the controller's stage-parameter rows 25-30.
    Returns (final states (B, nx), first-tick controls (B, nu), worst
    kkt_eq per scenario (B,)).
    """
    dtype, device = x.dtype, x.device
    B, N = x.shape[0], spec.horizon
    plant_p = spec.stage_params[0].clone()
    plant_p[-1] = 2.2 * 9.81
    plant_p = plant_p.expand(B, plant_p.shape[0])
    if plant_d is None:
        plant_d = torch.zeros(B, 6, dtype=dtype, device=device)
    pp_plant = torch.cat([plant_p, plant_d], 1)
    F_dist = discrete_dynamics(dist_param_ode, ocp.dt, num_steps=1)
    vF = torch.func.vmap(lambda xx, uu, pp: F_dist(xx, uu, pp, params))

    st = init_rti_state(ocp, x, dtype)
    d_v = torch.zeros(B, 3, dtype=dtype, device=device)
    d_w = torch.zeros(B, 3, dtype=dtype, device=device)
    pred = x[:, 6:12]
    u_first, eqs = None, []
    for _ in range(n_steps):
        if observer_gain is not None:
            # innovation: the part of v_dot (omega_dot) the model missed
            d_v = d_v + observer_gain * (x[:, 6:9] - pred[:, 0:3]) / ocp.dt
            if torque:
                d_w = d_w + observer_gain * (x[:, 9:12] - pred[:, 3:6]) \
                    / ocp.dt
            d = torch.cat([d_v, d_w], 1)
            spec_t = spec._replace(stage_params=torch.cat(
                [spec.stage_params.expand(B, N, spec.stage_params.shape[-1]),
                 d[:, None].expand(B, N, 6)], 2))
        else:
            spec_t = spec
        u0, st, diag = step(spec_t, st, x)
        u_first = u0 if u_first is None else u_first
        u_eff = u0 if derate is None else torch.cat(
            [u0[:, 0:4] * derate, u0[:, 4:]], 1)
        x_next = vF(x, u_eff, pp_plant)
        if observer_gain is not None:
            pred = vF(x, u0, torch.cat([plant_p, d], 1))[:, 6:12]
        x = x_next
        eqs.append(diag.qp_kkt_eq)
    return x, u_first, torch.stack(eqs).amax(0)


def fault_sweep(spec: OCPSpec, ocp: cfg.OCPConfig, derate, n_steps: int = 150,
                dtype=torch.float32, offset_free: bool = False,
                observer_gain: float = 0.5, hover=(0.0, 0.0, 3.5)
                ) -> SweepResult:
    """Fault injection and recovery over a batch of rotor deratings, on
    the spec's device.

    derate: (B, 4) per-scenario rotor effectiveness in (0, 1]: the plant
    multiplies each rotor's commanded thrust by it; the controller is not
    told. Every scenario starts at rest at `hover`, its target.
    offset_free=True runs the six-channel (force + torque) constant-
    disturbance observer: a derated rotor gives both a thrust deficit and
    a moment imbalance, whose estimates enter the prediction model (the
    JAX docstring: the force-only observer diverges on a 30% single-rotor
    loss). A "pallas_fused" solver is swapped to "pallas".
    """
    device = spec.Q.device
    derate = torch.as_tensor(derate, dtype=dtype, device=device)
    B = derate.shape[0]
    target = torch.as_tensor(hover, dtype=dtype, device=device).expand(B, 3)
    x0 = torch.zeros(B, cfg.NX, dtype=dtype, device=device)
    x0[:, 0:3] = target
    return _sweep(spec, ocp, x0, target,
                  torch.zeros(B, 6, dtype=dtype, device=device), derate,
                  n_steps, dtype, offset_free, observer_gain, torque=True)


def disturbance_sweep(spec: OCPSpec, ocp: cfg.OCPConfig,
                      scenarios: ScenarioBatch, n_steps: int = 120,
                      dtype=torch.float32, offset_free: bool = False,
                      observer_gain: float = 0.5) -> SweepResult:
    """Closed loop per wind / x0 / target scenario, on the spec's device:
    the controller is blind to the wind and the per-scenario target enters
    through yref. offset_free=True turns on the force-only constant-
    disturbance observer (its torque rows stay zero): each tick the
    velocity residual innovates the acceleration estimate and the
    controller plans against it. A "pallas_fused" solver is swapped to
    "pallas"."""
    device = spec.Q.device
    wind = torch.as_tensor(scenarios.wind, dtype=dtype, device=device)
    B = wind.shape[0]
    plant_d = torch.cat([wind, torch.zeros_like(wind)], 1)
    return _sweep(spec, ocp, scenarios.x0, scenarios.target, plant_d,
                  torch.ones(B, 4, dtype=dtype, device=device), n_steps,
                  dtype, offset_free, observer_gain, torque=False)
