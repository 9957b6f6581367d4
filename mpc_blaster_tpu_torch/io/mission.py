"""Endurance-mission harness: SITL-lite vehicle + faulty MAVLink link +
offset-free flight controller.

The reference's flight topology is NMPC -> `AttitudeTarget` -> MAVROS ->
PX4 inner attitude loop -> vehicle, with pose telemetry coming back
(`mavros_blaster_sim.py:33,102`; `getPose_scripts/`). No PX4 endpoint
exists in-image, so this module provides the missing half as a
deterministic stand-in that preserves the CONTRACT:

- `SitlLiteVehicle` — a 9-state (p, eul, v) vehicle whose attitude tracks
  the commanded quaternion through a first-order lag (the PX4 inner-loop
  stand-in) and whose collective thrust comes from inverting the
  reference's `thruster_cumul` cubic; constant wind acceleration as the
  unmodeled disturbance.
- `FaultyLink` — UDP sender with seeded fault injection (drops,
  truncations, noise bursts with embedded magic bytes) for testing parser
  resync and control robustness mid-mission.
- `OffsetFreeFlightController` — the deployed control stack: measured
  p/eul/v feedback (MAVLink LOCAL_POSITION_NED + ATTITUDE_QUATERNION),
  constant-disturbance observer on the velocity-prediction residual
  ("blaster_dist" stage-param rows), watchdog-guarded warm RTI chain
  (`sqp/rti.py::rti_step_warm_guarded`) on the spec's device.

The vehicle, the link and the two conversions are numpy and make no torch
call: the mission's vehicle and telemetry processes run them
(`io/endurance.py`), and such a process must not touch torch's thread
pools or the card. Only the controller is torch.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from mpc_blaster_tpu_torch import config as cfg
from mpc_blaster_tpu_torch.core.rotations import euler_zyx_to_quat
from mpc_blaster_tpu_torch.device import resolve_device
from mpc_blaster_tpu_torch.dynamics.blaster import BlasterParams
from mpc_blaster_tpu_torch.dynamics.integrators import discrete_dynamics
from mpc_blaster_tpu_torch.io.flight import (THRUSTER_COEFFICIENT,
                                             thruster_cumul)
from mpc_blaster_tpu_torch.ocp.spec import OCPSpec
from mpc_blaster_tpu_torch.sim.scenarios import dist_param_ode


def invert_thruster_cumul(norm: float) -> float:
    """Mean rotor thrust [N] from the normalized collective setpoint —
    numerical inverse of the reference's calibrated cubic
    (`mavros_blaster_sim.py:27-30`). Newton on the monotone branch."""
    avg = max(norm, 0.0) / 0.2464 + 0.2  # decent init on the linear part
    for _ in range(20):
        f = (0.0014 * avg ** 3 - 0.0263 * avg ** 2 + 0.2464 * avg
             - 0.0286 - norm)
        df = 3 * 0.0014 * avg ** 2 - 2 * 0.0263 * avg + 0.2464
        avg -= f / df
    return float(avg * 9.81 / THRUSTER_COEFFICIENT)


def quat_wxyz_to_euler_zyx(q: np.ndarray) -> np.ndarray:
    """Inverse of core.rotations.euler_zyx_to_quat (numpy, host-side)."""
    w, x, y, z = q
    phi = np.arctan2(2 * (w * x + y * z), 1 - 2 * (x * x + y * y))
    s = np.clip(2 * (w * y - z * x), -1.0, 1.0)
    th = np.arcsin(s)
    psi = np.arctan2(2 * (w * z + x * y), 1 - 2 * (y * y + z * z))
    return np.array([phi, th, psi])


class SitlLiteVehicle:
    """9-state vehicle: p (ENU), eul (zyx), v. Attitude -> commanded
    attitude with time constant `tau_att`; specific force = R e3 *
    (4*T_mean + T_blast)/m - g + wind. Euler integration at `dt`."""

    def __init__(self, x0_pos, wind, dt: float, mass: float = 9.0,
                 t_blast: float = 2.2 * 9.81, tau_att: float = 0.15,
                 gravity: float = 9.81):
        self.p = np.asarray(x0_pos, np.float64).copy()
        self.eul = np.zeros(3)
        self.v = np.zeros(3)
        self.wind = np.asarray(wind, np.float64)
        self.dt = float(dt)
        self.mass = mass
        self.t_blast = t_blast
        self.tau = tau_att
        self.g = gravity
        self.cmd_eul = np.zeros(3)
        self.cmd_thrust_mean = mass * gravity / 4.0 - t_blast / 4.0

    def command(self, quat_wxyz: np.ndarray, thrust_norm: float) -> None:
        self.cmd_eul = quat_wxyz_to_euler_zyx(np.asarray(quat_wxyz))
        self.cmd_thrust_mean = invert_thruster_cumul(float(thrust_norm))

    def step(self) -> None:
        a = self.dt / max(self.tau, self.dt)
        self.eul = self.eul + a * (self.cmd_eul - self.eul)
        phi, th, psi = self.eul
        cphi, sphi = np.cos(phi), np.sin(phi)
        cth, sth = np.cos(th), np.sin(th)
        cpsi, spsi = np.cos(psi), np.sin(psi)
        # world-from-body R = Rz Ry Rx, third column (body z in world)
        e3 = np.array([cpsi * sth * cphi + spsi * sphi,
                       spsi * sth * cphi - cpsi * sphi,
                       cth * cphi])
        f = 4.0 * self.cmd_thrust_mean + self.t_blast
        acc = e3 * (f / self.mass) + self.wind
        acc[2] -= self.g
        self.v = self.v + self.dt * acc
        self.p = self.p + self.dt * self.v


class FaultyLink:
    """UDP sender with seeded fault injection. Each datagram is dropped
    with p_drop, truncated with p_trunc; every `burst_every`-th send is
    preceded by a noise burst that EMBEDS a MAVLink magic byte (the
    parser-resync worst case, same class as tests/test_mavlink.py)."""

    def __init__(self, sock, addr: Tuple[str, int], seed: int = 0,
                 p_drop: float = 0.05, p_trunc: float = 0.02,
                 burst_every: int = 400):
        self.sock = sock
        self.addr = addr
        self.rng = np.random.default_rng(seed)
        self.p_drop = p_drop
        self.p_trunc = p_trunc
        self.burst_every = burst_every
        self.sent = 0
        self.dropped = 0
        self.truncated = 0
        self.bursts = 0

    def send(self, data: bytes) -> None:
        self.sent += 1
        if self.burst_every and self.sent % self.burst_every == 0:
            noise = bytes(self.rng.integers(0, 256, 32, dtype=np.uint8))
            self.sock.sendto(noise[:16] + b"\xfd" + noise[16:], self.addr)
            self.bursts += 1
        r = self.rng.random()
        if r < self.p_drop:
            self.dropped += 1
            return
        if r < self.p_drop + self.p_trunc and len(data) > 8:
            self.truncated += 1
            data = data[: len(data) // 2]
        self.sock.sendto(data, self.addr)


class OffsetFreeFlightController:
    """Measured-feedback offset-free NMPC tick for the mission harness.

    Per control tick: assemble the 17-state from measured p/eul/v (omega
    and gimbal from belief; POC rows zero — flight preset semantics),
    innovate the force-disturbance estimate from the velocity-prediction
    residual, run ONE watchdog-guarded warm RTI solve ("blaster_dist"
    prediction model), return (attitude quat, normalized thrust).

    The tick runs on the spec's device (or `device`). As in the JAX
    package it passes no `dyn_statics`, so `qp_backend="pallas_fused"`
    raises on the first tick; "pallas" launches the plain IPM kernel (K3
    warm, K1 cold and for the watchdog's redo). One host copy a tick
    carries u0, the velocity prediction, the command quaternion and the
    next tick's omega / gimbal belief.
    """

    def __init__(self, ocp: cfg.OCPConfig, spec: OCPSpec,
                 observer_gain: float = 0.4, dtype=torch.float32,
                 device=None):
        from mpc_blaster_tpu_torch.dynamics.fastlin import fast_linearize
        from mpc_blaster_tpu_torch.qp.ipm import IpmWarmStart
        from mpc_blaster_tpu_torch.sqp.rti import (WatchdogState,
                                                   init_rti_state,
                                                   rti_step_warm_guarded)

        dev = resolve_device(device, spec.stage_params)
        self.ocp = ocp
        self.spec = spec
        self.dtype = dtype
        self.device = dev
        self.gain = observer_gain
        self.params = BlasterParams.from_config(ocp.model, dtype, dev)
        self.F = discrete_dynamics(dist_param_ode, ocp.dt, num_steps=1)
        params = self.params

        def lin(xbar, ubar, stage_params):
            return fast_linearize(xbar, ubar, stage_params, params, ocp.dt,
                                  1, family="blaster_dist")

        self._sp0 = torch.cat(
            [spec.stage_params.to(dtype),
             torch.zeros((spec.horizon, 6), dtype=dtype, device=dev)], 1)
        x0 = torch.zeros(cfg.NX, dtype=dtype, device=dev)
        self.state = init_rti_state(ocp, x0, dtype)
        self.warm = IpmWarmStart.zeros(ocp.N, cfg.NX, cfg.NU, dtype, dev)
        self.wd = WatchdogState.init(dtype, dev)
        self.d_est = np.zeros(6)
        self._v_pred: Optional[np.ndarray] = None
        # the belief's omega / gimbal rows (previous plan's stage 1)
        self._belief = self.state.xbar[1, 9:14].cpu().numpy()
        F = self.F
        solver = ocp.solver

        def _tick(spec_t, st, warm, wd, x):
            return rti_step_warm_guarded(spec_t, st, warm, wd, x, params,
                                         F, solver, linearizer=lin)

        self._tick = _tick
        self._predict = lambda x, u, sp: self.F(x, u, sp, params)[6:12]

    def warmup(self, x_like: np.ndarray) -> None:
        self.tick(x_like[0:3], x_like[3:6], x_like[6:9])

    def tick(self, p_meas, eul_meas, v_meas):
        x = np.zeros(cfg.NX, np.float32)
        x[0:3] = p_meas
        x[3:6] = eul_meas
        x[6:9] = v_meas
        # omega/alpha/poc ride the belief (previous plan's stage 1)
        xb = self._belief
        x[9:14] = xb if np.isfinite(xb).all() else 0.0
        if self._v_pred is not None:
            self.d_est[0:3] += (self.gain
                                * (np.asarray(v_meas) - self._v_pred[0:3])
                                / self.ocp.dt)
        sp = self._sp0.clone()
        sp[:, 25:31] = torch.as_tensor(self.d_est, dtype=self.dtype)
        spec_t = self.spec._replace(stage_params=sp)
        xj = torch.as_tensor(x, dtype=self.dtype, device=self.device)
        u0, self.state, self.warm, self.wd, diag = self._tick(
            spec_t, self.state, self.warm, self.wd, xj)
        quat = euler_zyx_to_quat(self.state.xbar[1, 3:6])
        nu = u0.shape[-1]
        host = torch.cat([u0, self._predict(xj, u0, sp[0]), quat,
                          self.state.xbar[1, 9:14]]).cpu().numpy()
        u0_np = host[:nu]
        self._v_pred = host[nu:nu + 6]
        self._belief = host[nu + 10:]
        return host[nu + 6:nu + 10], thruster_cumul(*u0_np[0:4]), diag
