"""UDP transport for the flight I/O shell — real bytes where ROS sat.

The reference publishes `mavros_msgs/AttitudeTarget` over ROS pub/sub to
MAVROS/PX4 (`mavros_blaster_sim.py:33,91-102`) and reads
`geometry_msgs/PoseStamped` telemetry (`getPose_scripts/`). This module
carries the same two messages over UDP datagrams with a compact framed
encoding (magic + version + type + seq + payload + additive checksum —
the MAVLink v1 framing idea, sized for these two messages), giving the
framework a concrete transport:

  controller side:  `UdpAttitudeAdapter` — an `io.flight.AttitudeAdapter`
      publishing setpoint frames and draining pose frames into the native
      lock-free `PoseRingBuffer` (the port's runtime/native/executor.cpp,
      built by runtime/bindings.py) so the
      control loop never blocks on telemetry (the fix for the reference's
      acknowledged pose-lag race, `getPose_ext.py:27`).
  vehicle/GCS side: `UdpEndpoint` — bind/receive/send counterpart used by
      SITL bridges and the loopback integration test
      (tests/test_torch_transport.py; chip_smoke.py's phase 23 flies it
      at 10 Hz on the card).

No external deps; stdlib socket + struct, and torch only to turn the
received quaternion into Euler angles on the host (`core/rotations.py`,
float64 on the CPU).
"""
from __future__ import annotations

import socket
import struct
import threading
import time
from collections import deque
from typing import List, Optional, Tuple

import numpy as np
import torch

from mpc_blaster_tpu_torch.core.rotations import quat_to_euler_zyx
from mpc_blaster_tpu_torch.io.flight import AttitudeTarget

MAGIC = 0xB5
VERSION = 1
MSG_ATTITUDE_TARGET = 1
MSG_POSE_STAMPED = 2

# header: magic u8 | version u8 | msg u8 | seq u32  (little-endian)
_HDR = struct.Struct("<BBBI")
# attitude target payload: type_mask u8 | quat wxyz 4f | thrust f
_ATT = struct.Struct("<B4ff")
# pose payload: stamp d | position 3f | quat wxyz 4f
_POSE = struct.Struct("<d3f4f")


def _checksum(b: bytes) -> int:
    s = 0
    for x in b:
        s = (s + x) & 0xFF
    return s


def _frame(msg_id: int, seq: int, payload: bytes) -> bytes:
    body = _HDR.pack(MAGIC, VERSION, msg_id, seq & 0xFFFFFFFF) + payload
    return body + bytes([_checksum(body)])


def _unframe(datagram: bytes) -> Optional[Tuple[int, int, bytes]]:
    """-> (msg_id, seq, payload) or None for malformed/corrupt frames."""
    if len(datagram) < _HDR.size + 1:
        return None
    body, ck = datagram[:-1], datagram[-1]
    if _checksum(body) != ck:
        return None
    magic, version, msg_id, seq = _HDR.unpack_from(body)
    if magic != MAGIC or version != VERSION:
        return None
    return msg_id, seq, body[_HDR.size:]


def encode_attitude_target(msg: AttitudeTarget, seq: int) -> bytes:
    q = np.asarray(msg.orientation, dtype=np.float32)
    return _frame(MSG_ATTITUDE_TARGET, seq,
                  _ATT.pack(msg.type_mask & 0xFF, *q.tolist(),
                            float(msg.thrust)))


def decode_attitude_target(payload: bytes) -> AttitudeTarget:
    vals = _ATT.unpack(payload)
    return AttitudeTarget(type_mask=vals[0],
                          orientation=np.asarray(vals[1:5], np.float64),
                          thrust=float(vals[5]))


def encode_pose(stamp: float, position, quat_wxyz, seq: int) -> bytes:
    p = np.asarray(position, dtype=np.float32)
    q = np.asarray(quat_wxyz, dtype=np.float32)
    return _frame(MSG_POSE_STAMPED, seq,
                  _POSE.pack(float(stamp), *p.tolist(), *q.tolist()))


def decode_pose(payload: bytes) -> Tuple[float, np.ndarray, np.ndarray]:
    vals = _POSE.unpack(payload)
    return (vals[0], np.asarray(vals[1:4], np.float64),
            np.asarray(vals[4:8], np.float64))


class UdpAttitudeAdapter:
    """`AttitudeAdapter` over UDP (controller side).

    publish() sends one AttitudeTarget frame to `send_addr`;
    measured_pose() drains any received pose frames (non-blocking) into
    the native PoseRingBuffer (or a Python deque fallback) and returns
    the newest pose as [p(3), euler-free quat-derived rpy? no —
    [x, y, z, qw, qx, qy, qz]] — the FlightNode consumes [p(3), eul(3)]
    so the quaternion is converted to ZYX Euler on the way out.

    wire: "framed" (this module's compact framing, default),
    "mavlink1" or "mavlink2" (`io/mavlink.py`) — the latter two speak the
    real PX4 wire format: setpoints go out as `SET_ATTITUDE_TARGET` (#82)
    with the MAVROS ENU/FLU->NED/FRD attitude conversion applied, and
    telemetry is parsed from `LOCAL_POSITION_NED` (#32) +
    `ATTITUDE_QUATERNION` (#31) streams (fused into pose records the way
    MAVROS fuses `mavros/local_position/pose`).
    """

    def __init__(self, send_addr: Tuple[str, int],
                 recv_port: Optional[int] = None,
                 ring_capacity: int = 256, wire: str = "framed"):
        if wire not in ("framed", "mavlink1", "mavlink2"):
            raise ValueError(f"unknown wire format {wire!r}")
        self.wire = wire
        if wire != "framed":
            from mpc_blaster_tpu_torch.io import mavlink as _mav
            self._mav = _mav
            self._parser = _mav.MavlinkParser()
            self._last_att = np.array([1.0, 0.0, 0.0, 0.0])
        self.send_addr = send_addr
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._sock.setblocking(False)
        if recv_port is not None:
            self._sock.bind(("0.0.0.0", recv_port))
        self.seq = 0
        self.sent = 0
        self.pose_frames = 0
        self.bad_frames = 0
        self._ring = None
        try:
            from mpc_blaster_tpu_torch.runtime.bindings import PoseRingBuffer
            self._ring = PoseRingBuffer(ring_capacity)
        except RuntimeError:  # the native library did not build
            self._fallback: deque = deque(maxlen=ring_capacity)

    @property
    def recv_port(self) -> int:
        return self._sock.getsockname()[1]

    def publish(self, msg: AttitudeTarget) -> None:
        if self.wire == "framed":
            out = encode_attitude_target(msg, self.seq)
        else:
            out = self._mav.encode_set_attitude_target(
                msg.orientation, msg.thrust, msg.type_mask, self.seq,
                mavlink2=(self.wire == "mavlink2"))
        self._sock.sendto(out, self.send_addr)
        self.seq += 1
        self.sent += 1

    def _push_pose(self, stamp, p, q) -> None:
        self.pose_frames += 1
        if self._ring is not None:
            self._ring.push(stamp, p, q)
        else:
            self._fallback.append((stamp, p, q))

    def _drain(self) -> None:
        while True:
            try:
                datagram, _ = self._sock.recvfrom(2048)
            except BlockingIOError:
                return
            if self.wire != "framed":
                frames = self._parser.feed(datagram)
                for kind, t, v in self._mav.decode_pose_messages(frames):
                    if kind == "att":
                        self._last_att = v
                    else:  # position sample completes a pose record
                        self._push_pose(t, v, self._last_att)
                self.bad_frames = self._parser.bad_frames
                continue
            parsed = _unframe(datagram)
            if parsed is None:
                self.bad_frames += 1
                continue
            msg_id, _seq, payload = parsed
            if msg_id != MSG_POSE_STAMPED:
                continue
            stamp, p, q = decode_pose(payload)
            self._push_pose(stamp, p, q)

    def measured_pose(self) -> Optional[np.ndarray]:
        self._drain()
        if self._ring is not None:
            rec = self._ring.latest()
            if rec is None:
                return None
            p, q = rec[1:4], rec[4:8]
        else:
            if not self._fallback:
                return None
            _, p, q = self._fallback[-1]
        eul = quat_to_euler_zyx(torch.as_tensor(np.asarray(q, np.float64)))
        return np.concatenate([p, eul.numpy()])

    def close(self) -> None:
        self._sock.close()


class UdpEndpoint:
    """Vehicle/GCS-side counterpart: receives setpoints, sends telemetry.

    Used by the loopback integration test and as the seam for a SITL
    bridge (decode frames -> MAVROS/PX4 of your choice). With
    wire="mavlink1"/"mavlink2" it behaves as a minimal PX4-side peer:
    receives SET_ATTITUDE_TARGET frames, emits LOCAL_POSITION_NED +
    ATTITUDE_QUATERNION telemetry."""

    def __init__(self, bind_port: int = 0, wire: str = "framed"):
        if wire not in ("framed", "mavlink1", "mavlink2"):
            raise ValueError(f"unknown wire format {wire!r}")
        self.wire = wire
        if wire != "framed":
            from mpc_blaster_tpu_torch.io import mavlink as _mav
            self._mav = _mav
            self._parser = _mav.MavlinkParser()
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._sock.bind(("127.0.0.1", bind_port))
        self._sock.settimeout(0.5)
        self.received: List[Tuple[float, int, AttitudeTarget]] = []
        self.bad_frames = 0
        self.seq = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self._sock.getsockname()[1]

    def send_pose(self, addr: Tuple[str, int], stamp: float, position,
                  quat_wxyz) -> None:
        out = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        try:
            if self.wire != "framed":
                m = self._mav
                mav2 = self.wire == "mavlink2"
                t_ms = int(stamp * 1e3) & 0xFFFFFFFF
                ned = m.enu_to_ned(position)
                q = m.quat_flu_enu_to_frd_ned(quat_wxyz)
                out.sendto(m.encode_frame(m.LOCAL_POSITION_NED, {
                    "time_boot_ms": t_ms,
                    "x": float(ned[0]), "y": float(ned[1]),
                    "z": float(ned[2]),
                    "vx": 0.0, "vy": 0.0, "vz": 0.0,
                }, self.seq, mavlink2=mav2), addr)
                out.sendto(m.encode_frame(m.ATTITUDE_QUATERNION, {
                    "time_boot_ms": t_ms,
                    "q1": float(q[0]), "q2": float(q[1]),
                    "q3": float(q[2]), "q4": float(q[3]),
                    "rollspeed": 0.0, "pitchspeed": 0.0, "yawspeed": 0.0,
                }, self.seq + 1, mavlink2=mav2), addr)
                self.seq += 2
            else:
                out.sendto(encode_pose(stamp, position, quat_wxyz,
                                       self.seq), addr)
                self.seq += 1
        finally:
            out.close()

    def _rx_loop(self) -> None:
        while not self._stop.is_set():
            try:
                datagram, _ = self._sock.recvfrom(2048)
            except socket.timeout:
                continue
            except OSError:
                return
            if self.wire != "framed":
                m = self._mav
                for fr in self._parser.feed(datagram):
                    if fr.msg_id != m.SET_ATTITUDE_TARGET.msg_id:
                        continue
                    v = fr.values()
                    # back to the controller's ENU/FLU convention for
                    # apples-to-apples loopback assertions
                    q = m.quat_frd_ned_to_flu_enu(v["q"])
                    self.received.append((time.monotonic(), fr.seq,
                                          AttitudeTarget(
                                              type_mask=v["type_mask"],
                                              orientation=q,
                                              thrust=float(v["thrust"]))))
                self.bad_frames = self._parser.bad_frames
                continue
            parsed = _unframe(datagram)
            if parsed is None:
                self.bad_frames += 1
                continue
            msg_id, seq, payload = parsed
            if msg_id == MSG_ATTITUDE_TARGET:
                self.received.append((time.monotonic(), seq,
                                      decode_attitude_target(payload)))

    def start(self) -> "UdpEndpoint":
        self._thread = threading.Thread(target=self._rx_loop, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
        self._sock.close()
