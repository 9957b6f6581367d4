"""The port's UDP transport (`mpc_blaster_tpu_torch/io/transport.py`)
against the JAX package's.

tests/test_transport.py's framing and loopback cases run on the port's
module (the JAX test functions with their module globals pointed at the
port's objects); the port's frames equal the JAX module's byte for byte;
and the flight node flies over UDP under the native `RateLoop` with
test_transport.py:91-150's functional contract: frame counts, type masks,
unit quaternions, the shutdown thrust, pose frames reaching the node and
the loop's tick count.

The wall-clock half of that test (10 Hz pacing within 0.6-2.0 x n/10,
deadline misses <= n/2, worst lateness < 0.25 s, mean < 0.06 s) is not
asserted here: one eager flight-preset tick on this CPU takes ~600 ms
(the JAX package jit-compiles it to a few ms), longer than the 100 ms
slot. chip_smoke.py's phase 23 asserts those bounds unchanged on the
card, where the deployed profiles' tick is one kernel launch.
"""
import time

import numpy as np
import pytest
import torch

import test_transport as J
from mpc_blaster_tpu.io import flight as jflight
from mpc_blaster_tpu.io import transport as jt
from mpc_blaster_tpu_torch.io import flight as tflight
from mpc_blaster_tpu_torch.io import transport as tt
from mpc_blaster_tpu_torch.runtime import PoseRingBuffer, RateLoop
from torch_threads import one_intraop_thread  # noqa: F401

DEV = torch.device("cpu")

PORTED = ("MSG_ATTITUDE_TARGET", "UdpAttitudeAdapter", "UdpEndpoint",
          "_unframe", "decode_attitude_target", "decode_pose",
          "encode_attitude_target", "encode_pose")


@pytest.mark.parametrize("name", ["test_frame_roundtrip_attitude",
                                  "test_frame_roundtrip_pose_and_corruption",
                                  "test_udp_loopback_roundtrip"])
def test_jax_transport_case_on_port(name, monkeypatch):
    """tests/test_transport.py's framing and loopback cases, on the port's
    transport and `AttitudeTarget`."""
    for attr in PORTED:
        monkeypatch.setattr(J, attr, getattr(tt, attr))
    monkeypatch.setattr(J, "AttitudeTarget", tflight.AttitudeTarget)
    getattr(J, name)()


def test_frames_equal_jax_bytes():
    """Attitude and pose frames: the same bytes as the JAX module's for
    the same values and sequence numbers (including seq wrap-around and
    values that round in float32), and each side decodes the other's."""
    rng = np.random.default_rng(0)
    for seq in (0, 1, 255, 2**32 - 1, 2**32 + 5):
        q = rng.normal(size=4)
        thrust = float(rng.uniform(0, 1.2))
        mask = int(rng.integers(0, 512))
        a = tt.encode_attitude_target(tflight.AttitudeTarget(mask, q, thrust),
                                      seq)
        b = jt.encode_attitude_target(jflight.AttitudeTarget(mask, q, thrust),
                                      seq)
        assert a == b
        dt_, dj = (tt.decode_attitude_target(jt._unframe(b)[2]),
                   jt.decode_attitude_target(tt._unframe(a)[2]))
        assert dt_.type_mask == dj.type_mask and dt_.thrust == dj.thrust
        np.testing.assert_array_equal(dt_.orientation, dj.orientation)
        stamp, p = float(rng.uniform(0, 1e5)), rng.normal(size=3)
        a = tt.encode_pose(stamp, p, q, seq)
        assert a == jt.encode_pose(stamp, p, q, seq)
        for x, y in zip(tt.decode_pose(tt._unframe(a)[2]),
                        jt.decode_pose(jt._unframe(a)[2])):
            np.testing.assert_array_equal(x, y)
        bad = bytearray(a)
        bad[len(a) // 2] ^= 0x5A
        assert tt._unframe(bytes(bad)) is None
        assert jt._unframe(bytes(bad)) is None


def test_measured_pose_matches_jax_adapter():
    """The same pose datagrams into the port's and the JAX adapter give
    the same [p, eul] (the port converts the quaternion with
    `core/rotations.py` in float64 on the CPU; measured gap 0 to 2 ulp),
    and the port's adapter drains them into the native ring."""
    ep = tt.UdpEndpoint().start()
    ta = tt.UdpAttitudeAdapter(("127.0.0.1", ep.port), recv_port=0)
    ja = jt.UdpAttitudeAdapter(("127.0.0.1", ep.port), recv_port=0)
    try:
        assert isinstance(ta._ring, PoseRingBuffer)
        rng = np.random.default_rng(5)
        for i in range(5):
            q = rng.normal(size=4)
            q /= np.linalg.norm(q)
            p = rng.normal(size=3)
            for ad in (ta, ja):
                ep.send_pose(("127.0.0.1", ad.recv_port), float(i), p, q)
            got = {}
            deadline = time.monotonic() + 5.0
            while len(got) < 2 and time.monotonic() < deadline:
                for k, ad in (("t", ta), ("j", ja)):
                    if ad.pose_frames == i + 1 and k not in got:
                        got[k] = ad.measured_pose()
                    elif k not in got:
                        ad.measured_pose()
                time.sleep(0.005)
            assert len(got) == 2, got
            np.testing.assert_array_equal(got["t"][0:3], got["j"][0:3])
            np.testing.assert_allclose(got["t"][3:6], got["j"][3:6],
                                       rtol=0, atol=1e-14)
        assert ta.bad_frames == 0 and ta.pose_frames == 5
    finally:
        ta.close()
        ja.close()
        ep.stop()


def test_flight_node_over_udp_under_rate_loop():
    """test_transport.py:91-150 on the port: the FlightNode (flight
    preset, float64, measured-pose feedback) publishing real datagrams
    under the native `RateLoop` at 10 Hz, pose telemetry flowing back
    through the native `PoseRingBuffer`. The functional half of the JAX
    test's assertions, unchanged; the wall-clock half runs on the card
    (module docstring)."""
    ep = tt.UdpEndpoint().start()
    adapter = tt.UdpAttitudeAdapter(("127.0.0.1", ep.port), recv_port=0)
    node = tflight.FlightNode(adapter=adapter, dtype=torch.float64,
                              use_measured_pose=True, device=DEV)
    n_ticks = 8
    try:
        assert isinstance(adapter._ring, PoseRingBuffer)
        node.tick()
        rate = RateLoop(10.0)
        for i in range(n_ticks):
            ep.send_pose(("127.0.0.1", adapter.recv_port),
                         time.monotonic(), node.x.numpy()[0:3],
                         [1.0, 0, 0, 0])
            node.tick()
            rate.sleep()
        node.shutdown()
        stats = rate.stats()
        assert stats["ticks"] == n_ticks

        deadline = time.monotonic() + 2.0
        # publishes: 1 warmup + n_ticks + shutdown
        while len(ep.received) < n_ticks + 2 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert len(ep.received) == n_ticks + 2
        assert [s for _, s, _ in ep.received] == list(range(n_ticks + 2))
        msgs = [m for _, _, m in ep.received]
        assert all(m.type_mask == 7 for m in msgs)
        for m in msgs[:-1]:
            np.testing.assert_allclose(np.linalg.norm(m.orientation), 1.0,
                                       atol=1e-5)
            assert np.isfinite(m.thrust)
        assert abs(msgs[-1].thrust - 0.705) < 1e-6
        assert adapter.pose_frames >= n_ticks
        assert np.isfinite(np.asarray(node.history_x)).all()
    finally:
        adapter.close()
        ep.stop()
