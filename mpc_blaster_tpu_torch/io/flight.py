"""Flight-node analog: the I/O shell where the reference's ROS layer sat.

Re-designs `src/scripts/mavros_blaster_sim.py` without ROS: the control loop
is the same RTI tick; the transport is an `AttitudeAdapter` protocol object
(publish attitude+thrust setpoints; optionally supply measured pose). The
reference publishes `mavros_msgs/AttitudeTarget` with type_mask=7
(attitude + collective thrust only, `mavros_blaster_sim.py:91-102`) at
10 Hz and — notably — never feeds the measured vehicle pose back: its state
belief is the model integrator (`:109-118`, SURVEY.md §3.4). Both behaviors
are reproduced, feedback as an option the reference lacks.

The tick runs on the node's device (the card unless `device` says
otherwise, `device.py`); under `deployed_solver(...)` it is one launch of
the IPM kernel (K6), or the warm chain's launch and the watchdog's redo
(K3). The tick (`make_rti_step`'s, or the warm chain's) and the plant's
belief advance are `utils/capture.py` runners, as the JAX package jits
them: a CUDA graph replay each on the card. The published message and
the histories are host numpy: one host copy a tick.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Protocol

import numpy as np
import torch

from mpc_blaster_tpu_torch import config as cfg
from mpc_blaster_tpu_torch.core.rotations import euler_zyx_to_quat
from mpc_blaster_tpu_torch.device import resolve_device
from mpc_blaster_tpu_torch.dynamics.blaster import BlasterParams, blaster_ode
from mpc_blaster_tpu_torch.dynamics.integrators import discrete_dynamics
from mpc_blaster_tpu_torch.ocp.spec import OCPSpec, build_spec
from mpc_blaster_tpu_torch.sqp.rti import (RTIState, init_rti_state,
                                           make_rti_step)
from mpc_blaster_tpu_torch.utils import capture

# Thrust normalization (`mavros_blaster_sim.py:24-30`): mean rotor thrust ->
# normalized collective setpoint via the calibrated cubic.
THRUSTER_COEFFICIENT = 2.3


def thruster_cumul(t1: float, t2: float, t3: float, t4: float) -> float:
    """Cubic thrust normalization, exact reference polynomial (`:27-30`)."""
    avg = THRUSTER_COEFFICIENT * np.mean([t1, t2, t3, t4]) / 9.81
    return float(0.0014 * avg ** 3 - 0.0263 * avg ** 2 + 0.2464 * avg
                 - 0.0286)


@dataclasses.dataclass
class AttitudeTarget:
    """mavros_msgs/AttitudeTarget analog (quat wxyz + normalized thrust)."""

    type_mask: int
    orientation: np.ndarray  # (4,) [w, x, y, z]
    thrust: float


class AttitudeAdapter(Protocol):
    """Transport seam. Implementations: logging, UDP, ROS bridge, SITL..."""

    def publish(self, msg: AttitudeTarget) -> None: ...

    def measured_pose(self) -> Optional[np.ndarray]: ...


class CollectAdapter:
    """Default adapter: records published setpoints (for tests/offline)."""

    def __init__(self):
        self.messages: List[AttitudeTarget] = []

    def publish(self, msg: AttitudeTarget) -> None:
        self.messages.append(msg)

    def measured_pose(self) -> Optional[np.ndarray]:
        return None


class FlightNode:
    """The `talker()` loop (`mavros_blaster_sim.py:32-133`), ROS-free.

    Per tick: RTI solve -> publish AttitudeTarget(quat(stage-0 euler),
    thruster_cumul(u0)) -> advance internal belief with the plant model.
    `use_measured_pose=True` closes the loop through the adapter (the
    capability the reference's dead `getPose_scripts` probes hint at).
    """

    def __init__(self, preset: Optional[cfg.Preset] = None,
                 adapter: Optional[AttitudeAdapter] = None,
                 dtype=torch.float32,
                 use_measured_pose: bool = False,
                 warm_start: bool = False, device=None):
        self.preset = preset or cfg.flight_preset()
        self.adapter = adapter or CollectAdapter()
        self.dtype = dtype
        self.use_measured_pose = use_measured_pose
        self.warm_start = warm_start
        self.device = resolve_device(device)

        ocp = self.preset.ocp
        dev = self.device
        self.spec: OCPSpec = build_spec(ocp, yref=self.preset.loop.yref,
                                        dtype=dtype, device=dev)
        self.params = BlasterParams.from_config(ocp.model, dtype, dev)
        self._plant = capture.jit(discrete_dynamics(blaster_ode, ocp.dt,
                                                    num_steps=1))
        self._plant_params = self.spec.stage_params[0]
        self.x = torch.as_tensor(self.preset.loop.x0, dtype=dtype,
                                 device=dev)
        self.state: RTIState = init_rti_state(ocp, self.x, dtype)
        self.history_x: List[np.ndarray] = [self.x.cpu().numpy()]
        self.history_u: List[np.ndarray] = []

        if warm_start:
            # warm-chain flight loop: the deployed_solver("fastest")
            # profile threads IPM slack/dual state between ticks, with
            # the online divergence watchdog when
            # solver.warm_watchdog=True — the flight shell runs the SAME
            # guarded chain the sim loops deploy
            from mpc_blaster_tpu_torch.qp.ipm import IpmWarmStart
            from mpc_blaster_tpu_torch.sqp.rti import (WatchdogState,
                                                       fused_dyn_statics,
                                                       make_linearizer,
                                                       rti_step_warm,
                                                       rti_step_warm_guarded)
            F = self._plant.__wrapped__
            lin = make_linearizer(ocp, self.params)
            dyn = (fused_dyn_statics(ocp, 1)
                   if ocp.solver.qp_backend == "pallas_fused" else None)
            self._warm = IpmWarmStart.zeros(ocp.N, cfg.NX, cfg.NU, dtype,
                                            dev)
            self._wd = WatchdogState.init(dtype, dev)
            if ocp.solver.warm_watchdog:
                def step_warm(spec, st, w, wd, x):
                    return rti_step_warm_guarded(
                        spec, st, w, wd, x, self.params, F, ocp.solver,
                        linearizer=lin, dyn_statics=dyn)
            else:
                def step_warm(spec, st, w, x):
                    return rti_step_warm(spec, st, w, x, self.params, F,
                                         ocp.solver, linearizer=lin,
                                         dyn_statics=dyn)
            self._step_warm = capture.jit(step_warm)
        else:
            self._step = make_rti_step(ocp, dtype=dtype, device=dev)

    def tick(self) -> AttitudeTarget:
        """One 10 Hz control tick (`mavros_blaster_sim.py:67-121`)."""
        if self.use_measured_pose:
            pose = self.adapter.measured_pose()
            if pose is not None:
                x = self.x.clone()
                x[0:6] = torch.as_tensor(np.asarray(pose[0:6]),
                                         dtype=self.dtype)
                self.x = x
        if self.warm_start:
            if self.preset.ocp.solver.warm_watchdog:
                (u0, self.state, self._warm, self._wd,
                 _diag) = self._step_warm(self.spec, self.state,
                                          self._warm, self._wd, self.x)
            else:
                u0, self.state, self._warm, _diag = self._step_warm(
                    self.spec, self.state, self._warm, self.x)
        else:
            u0, self.state, _diag = self._step(self.spec, self.state,
                                               self.x)

        # Reference publishes the *stage-0* attitude (== current state due
        # to the x0 equality bound) as the setpoint (`:92-95`) — kept as-is.
        quat = euler_zyx_to_quat(self.state.xbar[0, 3:6])
        # Open-loop model belief advance (`:109-118`), enqueued before the
        # tick's one host copy (u0, the quaternion, the next belief).
        self.x = self._plant(self.x, u0, self._plant_params, self.params)
        nu = u0.shape[-1]
        host = torch.cat([u0, quat, self.x]).cpu().numpy()
        u0_np, quat_np = host[:nu], host[nu:nu + 4]
        msg = AttitudeTarget(type_mask=7, orientation=quat_np,
                             thrust=thruster_cumul(*u0_np[0:4]))
        self.adapter.publish(msg)
        self.history_x.append(host[nu + 4:])
        self.history_u.append(u0_np)
        return msg

    def run(self, n_steps: Optional[int] = None) -> None:
        n = n_steps if n_steps is not None else self.preset.loop.n_steps
        for _ in range(n):
            self.tick()
        self.shutdown()

    def shutdown(self) -> None:
        """Level-hover exit message (`mavros_blaster_sim.py:128-133`),
        computed on the host."""
        quat = euler_zyx_to_quat(torch.zeros(3, dtype=self.dtype))
        self.adapter.publish(AttitudeTarget(type_mask=7,
                                            orientation=quat.numpy(),
                                            thrust=0.705))
