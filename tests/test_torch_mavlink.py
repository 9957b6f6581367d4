"""The port's MAVLink codec (`mpc_blaster_tpu_torch/io/mavlink.py`, a copy
of the JAX package's module) against the JAX package's.

Every case of tests/test_mavlink.py runs on the port's module: the JAX
test functions are called with their module globals (the codec, the
transport's adapter and endpoint, `AttitudeTarget`) pointed at the port's
objects, so the cases and their assertions stay the JAX file's own. Then
the two codecs are held to each other: the same values and sequence
numbers give the same bytes, and each side's parser decodes the other's
frames to the same values.
"""
import inspect

import numpy as np
import pytest

import test_mavlink as J
from mpc_blaster_tpu.io import mavlink as jm
from mpc_blaster_tpu_torch.io import mavlink as tm
from mpc_blaster_tpu_torch.io import flight as tflight
from mpc_blaster_tpu_torch.io import transport as ttransport
from torch_threads import one_intraop_thread  # noqa: F401


def _jax_cases():
    """(name, kwargs) of every case of tests/test_mavlink.py, its
    parametrizations expanded."""
    out = []
    for name, fn in vars(J).items():
        if not name.startswith("test_") or not inspect.isfunction(fn):
            continue
        marks = [m for m in getattr(fn, "pytestmark", [])
                 if m.name == "parametrize"]
        if not marks:
            out.append((name, {}))
            continue
        (argname, values), = [m.args for m in marks]
        out += [(f"{name}[{v}]", {argname: v}) for v in values]
    return out


CASES = _jax_cases()


def test_every_jax_case_is_run():
    """tests/test_mavlink.py's 13 test functions (18 cases with their
    parametrizations) all run below."""
    assert len({n.split("[")[0] for n, _ in CASES}) == 13
    assert len(CASES) == 18


@pytest.mark.parametrize("name,kwargs", CASES, ids=[n for n, _ in CASES])
def test_jax_mavlink_case_on_port(name, kwargs, monkeypatch):
    monkeypatch.setattr(J, "m", tm)
    monkeypatch.setattr(J, "AttitudeTarget", tflight.AttitudeTarget)
    monkeypatch.setattr(J, "UdpAttitudeAdapter",
                        ttransport.UdpAttitudeAdapter)
    monkeypatch.setattr(J, "UdpEndpoint", ttransport.UdpEndpoint)
    getattr(J, name.split("[")[0])(**kwargs)


def _values(rng):
    """One value set per message of the port's catalog (random floats,
    the u8 and u32 fields within range)."""
    mod = tm
    f = lambda: float(rng.normal())  # noqa: E731
    return {
        mod.HEARTBEAT: {"type": 2, "autopilot": 12, "base_mode": 81,
                        "custom_mode": int(rng.integers(0, 2**32)),
                        "system_status": 4, "mavlink_version": 3},
        mod.LOCAL_POSITION_NED: {"time_boot_ms": int(rng.integers(0, 2**32)),
                                 "x": f(), "y": f(), "z": f(), "vx": f(),
                                 "vy": f(), "vz": f()},
        mod.ATTITUDE_QUATERNION: {"time_boot_ms": int(rng.integers(0, 2**32)),
                                  "q1": f(), "q2": f(), "q3": f(), "q4": f(),
                                  "rollspeed": f(), "pitchspeed": f(),
                                  "yawspeed": f()},
        mod.SET_ATTITUDE_TARGET: {
            "time_boot_ms": int(rng.integers(0, 2**32)), "target_system": 1,
            "target_component": 1, "type_mask": int(rng.integers(0, 256)),
            "q": rng.normal(size=4), "body_roll_rate": f(),
            "body_pitch_rate": f(), "body_yaw_rate": f(), "thrust": f()},
    }


def test_catalog_and_crc_extra_equal_jax():
    assert tm.CRC_EXTRA == jm.CRC_EXTRA
    assert [tuple(m) for m in tm.MESSAGES.values()] == \
        [tuple(m) for m in jm.MESSAGES.values()]
    rng = np.random.default_rng(0)
    data = bytes(rng.integers(0, 256, 4096, dtype=np.uint8))
    assert tm.x25_crc(data) == jm.x25_crc(data)


@pytest.mark.parametrize("mavlink2", [False, True])
def test_frames_equal_jax_bytes(mavlink2):
    """For the same values and sequence numbers the port's frames are the
    JAX module's byte for byte (20 random value sets per message), and
    each side's parser decodes the other's stream to the same values."""
    rng = np.random.default_rng(1 + mavlink2)
    t_stream, j_stream = b"", b""
    for i in range(20):
        for tmsg, v in _values(rng).items():
            jmsg = jm.MESSAGES[tmsg.msg_id]
            seq = (4 * i + tmsg.msg_id) % 256
            tb = tm.encode_frame(tmsg, v, seq, sysid=255, compid=190,
                                 mavlink2=mavlink2)
            jb = jm.encode_frame(jmsg, v, seq, sysid=255, compid=190,
                                 mavlink2=mavlink2)
            assert tb == jb, (tmsg.name, i)
            t_stream += tb
            j_stream += jb
    t_frames = jm.MavlinkParser().feed(t_stream)
    j_frames = tm.MavlinkParser().feed(j_stream)
    assert len(t_frames) == len(j_frames) == 80
    for a, b in zip(t_frames, j_frames):
        assert (a.msg_id, a.seq, a.sysid, a.compid, a.payload,
                a.mavlink2) == (b.msg_id, b.seq, b.sysid, b.compid,
                                b.payload, b.mavlink2)
        va, vb = a.values(), b.values()
        assert va.keys() == vb.keys()
        for k in va:
            np.testing.assert_array_equal(va[k], vb[k])


@pytest.mark.parametrize("mavlink2", [False, True])
def test_set_attitude_target_and_conversions_equal_jax(mavlink2):
    """The flight shell's own encoder and the MAVROS frame conversions:
    equal bytes, and conversions equal to the last bit."""
    rng = np.random.default_rng(3)
    for seq in range(30):
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        thrust = float(rng.uniform(0, 1))
        for convert in (True, False):
            assert tm.encode_set_attitude_target(
                q, thrust, 7, seq, time_boot_ms=seq * 100,
                mavlink2=mavlink2, convert_frames=convert) == \
                jm.encode_set_attitude_target(
                    q, thrust, 7, seq, time_boot_ms=seq * 100,
                    mavlink2=mavlink2, convert_frames=convert)
        p = rng.normal(size=3)
        for fn in ("enu_to_ned", "ned_to_enu"):
            np.testing.assert_array_equal(getattr(tm, fn)(p),
                                          getattr(jm, fn)(p))
        for fn in ("quat_flu_enu_to_frd_ned", "quat_frd_ned_to_flu_enu"):
            np.testing.assert_array_equal(getattr(tm, fn)(q),
                                          getattr(jm, fn)(q))
    frames = tm.MavlinkParser().feed(jm.encode_frame(
        jm.LOCAL_POSITION_NED, {"time_boot_ms": 1500, "x": 1.0, "y": 2.0,
                                "z": -3.0, "vx": 0.0, "vy": 0.0, "vz": 0.0},
        0, mavlink2=mavlink2))
    (kind_t, t_t, p_t), = tm.decode_pose_messages(frames)
    (kind_j, t_j, p_j), = jm.decode_pose_messages(frames)
    assert (kind_t, t_t) == (kind_j, t_j) and np.array_equal(p_t, p_j)
