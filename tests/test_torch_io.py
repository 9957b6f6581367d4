"""The port's flight node and telemetry probes (`mpc_blaster_tpu_torch/
io/flight.py`, `io/telemetry.py`) against the JAX package's.

The same FlightNode configurations run 5 ticks in each package on the
CPU and their published messages and histories are compared, component
by component, at tolerances set from the measured gaps. Every tick is a
take-off transient whose 12-iteration (or warm 3-iteration) QP no solver
converges, so the two implementations' rounding moves the weakly
determined rotor split most (the thrust message reads only the rotors'
mean). In float32 on the warm watchdog chain the gaps grow further
(f32 parity past one IPM iteration is objective-level only).
"""
import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mpc_blaster_tpu import config as jcfg
from mpc_blaster_tpu.io import flight as J
from mpc_blaster_tpu.io.telemetry import PoseProbe as JPoseProbe
from mpc_blaster_tpu_torch import config as tcfg
from mpc_blaster_tpu_torch.io import flight as T
from mpc_blaster_tpu_torch.io.telemetry import PoseProbe
from torch_threads import one_intraop_thread  # noqa: F401

DEV = torch.device("cpu")

# Tolerances per compared quantity, (float64 default node, float32 warm
# watchdog node); measured gaps in the comments, in that order.
TOL = {
    "quat": (5e-4, 1e-3),         # 2.3e-5, 2.5e-4
    "thrust": (1e-5, 0.1),        # 1.3e-6, 2.3e-2 (normalized setpoint)
    "u_mean": (5e-4, 3.0),        # rotor mean, N: 5.4e-5, 0.95
    "u": (0.5, 5.0),              # each rotor, N: 0.114, 1.67
    "gimbal": (1e-4, 0.05),       # u[4:6], rad/s: 7.5e-6, 1.6e-2
    "pos": (1e-6, 1e-3),          # x[0:3], m: 2.7e-8, 1.9e-4
    "eul": (5e-4, 2e-3),          # x[3:6]: 5.9e-5, 4.9e-4
    "vel": (1e-5, 3e-2),          # x[6:9]: 8.1e-7, 8.7e-3
    "omega": (5e-3, 6e-2),        # x[9:12]: 6.2e-4, 1.9e-2
    "alpha": (1e-5, 2e-3),        # x[12:14]: 2.5e-7, 5.9e-4
}
X_ROWS = {"pos": (0, 3), "eul": (3, 6), "vel": (6, 9), "omega": (9, 12),
          "alpha": (12, 14), "poc": (14, 17)}


def _compare(jn, tn, col):
    jm, tm = jn.adapter.messages, tn.adapter.messages
    assert len(jm) == len(tm)
    for a, b in zip(jm, tm):
        assert a.type_mask == b.type_mask == 7
        np.testing.assert_allclose(b.orientation, a.orientation, rtol=0,
                                   atol=TOL["quat"][col])
        assert abs(a.thrust - b.thrust) <= TOL["thrust"][col]
    hx_j, hx_t = np.asarray(jn.history_x), np.asarray(tn.history_x)
    hu_j, hu_t = np.asarray(jn.history_u), np.asarray(tn.history_u)
    assert hx_t.shape == hx_j.shape and hu_t.shape == hu_j.shape
    assert hx_t.dtype == hx_j.dtype
    np.testing.assert_array_equal(hx_t[0], hx_j[0])
    for k, (a, b) in X_ROWS.items():
        tol = 0.0 if k == "poc" else TOL[k][col]
        np.testing.assert_allclose(hx_t[:, a:b], hx_j[:, a:b], rtol=0,
                                   atol=tol, err_msg=k)
    np.testing.assert_allclose(hu_t[:, :4].mean(1), hu_j[:, :4].mean(1),
                               rtol=0, atol=TOL["u_mean"][col])
    np.testing.assert_allclose(hu_t[:, :4], hu_j[:, :4], rtol=0,
                               atol=TOL["u"][col])
    np.testing.assert_allclose(hu_t[:, 4:], hu_j[:, 4:], rtol=0,
                               atol=TOL["gimbal"][col])


def test_thruster_cumul_equals_jax():
    rng = np.random.default_rng(0)
    for thrusts in [(22.0, 22.0, 22.0, 22.0), (10.0, 12.0, 9.0, 11.0),
                    *rng.uniform(0, 65, (20, 4))]:
        assert T.thruster_cumul(*thrusts) == J.thruster_cumul(*thrusts)
    u = rng.uniform(0, 65, 4).astype(np.float32)
    assert T.thruster_cumul(*u) == J.thruster_cumul(*u)


def test_flight_node_matches_jax_f64():
    """The default flight preset in float64 ("riccati", 12 iterations),
    five ticks and the shutdown message, against the JAX node."""
    jn = J.FlightNode(dtype=jnp.float64)
    tn = T.FlightNode(dtype=torch.float64, device=DEV)
    jn.run(n_steps=5)
    tn.run(n_steps=5)
    _compare(jn, tn, 0)
    # the level-hover exit (`mavros_blaster_sim.py:128-133`)
    last = tn.adapter.messages[-1]
    np.testing.assert_array_equal(last.orientation, [1.0, 0, 0, 0])
    assert last.thrust == 0.705
    # the belief climbs toward the 3.5 m target
    assert tn.history_x[-1][2] > tn.history_x[0][2]
    assert tn.x.device == DEV and tn.history_x[-1].dtype == np.float64


def _warm_presets():
    out = []
    for c in (jcfg, tcfg):
        sv = dataclasses.replace(c.deployed_solver("fastest"),
                                 qp_backend="riccati", lin_backend="fused")
        pre = c.flight_preset()
        out.append(dataclasses.replace(
            pre, ocp=dataclasses.replace(pre.ocp, solver=sv)))
    return out


def test_flight_node_warm_watchdog_matches_jax_f32():
    """tests/test_io.py:61-86's warm watchdog profile ("fastest"'s warm /
    shift / watchdog flags on "riccati" with the fused linearizer),
    float32: the JAX test's criteria on the port, and the port's node
    against the JAX node."""
    jpre, tpre = _warm_presets()
    jn = J.FlightNode(preset=jpre, warm_start=True)
    tn = T.FlightNode(preset=tpre, warm_start=True, device=DEV)
    jn.run(n_steps=5)
    tn.run(n_steps=5)
    msgs = tn.adapter.messages
    assert len(msgs) == 6  # 5 ticks + hover-out
    for m in msgs:
        assert m.type_mask == 7
        assert np.isfinite(m.thrust)
        assert abs(np.linalg.norm(m.orientation) - 1.0) < 1e-5
    assert int(tn._wd.trips) == 0 == int(jn._wd.trips)
    assert np.isfinite(np.asarray(tn.history_x)).all()
    _compare(jn, tn, 1)


class _PoseAdapter:
    """A CollectAdapter that also reports a scripted measured pose."""

    def __init__(self, poses):
        self.messages, self._poses = [], list(poses)

    def publish(self, msg):
        self.messages.append(msg)

    def measured_pose(self):
        return self._poses.pop(0) if self._poses else None


def test_flight_node_measured_pose_matches_jax():
    """use_measured_pose=True: the adapter's [p, eul] replaces the belief's
    first six states before each tick (float64; the first tick has no
    measurement, the later ones a drifting pose)."""
    poses = [None] + [np.array([0.1 * k, -0.05 * k, 0.2 + 0.1 * k,
                                0.01 * k, -0.02 * k, 0.03 * k])
                      for k in range(1, 4)]
    jn = J.FlightNode(adapter=_PoseAdapter(poses), dtype=jnp.float64,
                      use_measured_pose=True)
    tn = T.FlightNode(adapter=_PoseAdapter(poses), dtype=torch.float64,
                      use_measured_pose=True, device=DEV)
    for _ in range(4):
        jn.tick()
        tn.tick()
    _compare(jn, tn, 0)
    # the last tick started from the last measured pose: one 1/30 s step
    # of the plant from it
    np.testing.assert_allclose(tn.history_x[-1][0:3], poses[-1][0:3],
                               rtol=0, atol=0.05)
    assert not np.allclose(tn.history_x[-1][0:3], jn.history_x[1][0:3])


def test_collect_adapter_and_shutdown():
    tn = T.FlightNode(dtype=torch.float64, device=DEV)
    tn.run(n_steps=2)
    assert isinstance(tn.adapter, T.CollectAdapter)
    assert tn.adapter.measured_pose() is None
    assert len(tn.adapter.messages) == 3
    last = tn.adapter.messages[-1]
    np.testing.assert_array_equal(last.orientation, [1, 0, 0, 0])
    assert last.thrust == 0.705 and last.orientation.dtype == np.float64


def test_pose_probe_callback_and_poll():
    """tests/test_io.py's probe case on the port's copy, and the same
    samples as the JAX probe."""
    for cls in (PoseProbe, JPoseProbe):
        probe = cls()
        seen = []
        probe.on_pose(lambda s: seen.append(s))
        assert probe.latest() is None
        probe.update([1.0, 2.0, 3.0], [1.0, 0, 0, 0], stamp=100.0)
        assert len(seen) == 1
        latest = probe.latest()
        np.testing.assert_allclose(latest.position, [1, 2, 3])
        assert latest.orientation.dtype == np.float64
        assert latest.age(now=100.5) == 0.5


def test_flight_node_device_default_is_the_card():
    """Without a device the node goes to the card; on a machine without
    one it raises and names device="cpu" (`device.py`)."""
    if torch.cuda.is_available():
        assert T.FlightNode().x.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match='device="cpu"'):
            T.FlightNode()
