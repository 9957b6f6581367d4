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

`fault_sweep` and `disturbance_sweep` vmap the tick over scenarios, each
with its own disturbance closure; they are not ported yet (ROADMAP queue
1 item 11) and raise.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from mpc_blaster_tpu_torch import config as cfg
from mpc_blaster_tpu_torch.dynamics.blaster import BlasterParams, blaster_ode
from mpc_blaster_tpu_torch.dynamics.integrators import discrete_dynamics
from mpc_blaster_tpu_torch.ocp.spec import OCPSpec
from mpc_blaster_tpu_torch.sqp.rti import (_check_backend, fused_dyn_statics,
                                           init_rti_state, not_ported,
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


def fault_sweep(spec: OCPSpec, ocp: cfg.OCPConfig, derate, n_steps: int = 150,
                dtype=torch.float32, offset_free: bool = False,
                observer_gain: float = 0.5, hover=(0.0, 0.0, 3.5)):
    """Fault injection and recovery over a batch of rotor deratings: not
    ported yet (it vmaps the tick over scenarios with a disturbance
    closure each; the port writes it batch-explicit)."""
    raise not_ported("fault_sweep", "sweeps")


def disturbance_sweep(spec: OCPSpec, ocp: cfg.OCPConfig,
                      scenarios: ScenarioBatch, n_steps: int = 120,
                      dtype=torch.float32, offset_free: bool = False,
                      observer_gain: float = 0.5):
    """Closed loop per wind / x0 / target scenario: not ported yet (see
    `fault_sweep`)."""
    raise not_ported("disturbance_sweep", "sweeps")
