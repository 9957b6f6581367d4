"""MAVLink v1/v2 wire format for the flight shell — PX4/SITL byte compat.

The reference's transport is `mavros_msgs/AttitudeTarget` published to
MAVROS, which re-encodes it as a MAVLink `SET_ATTITUDE_TARGET` (#82) on the
serial/UDP link to PX4 (the reference's `src/scripts/mavros_blaster_sim.py:
33,91-102`); pose telemetry comes back as `LOCAL_POSITION_NED` (#32) +
`ATTITUDE_QUATERNION` (#31), which MAVROS fuses into the
`mavros/local_position/pose` topic the reference's probes subscribe to
(`getPose_scripts/getPose_int.py:12-13`). This module implements that wire
format directly — stdlib-only — so `io.transport.UdpAttitudeAdapter` can
speak to a PX4 SITL endpoint with no ROS/MAVROS in between. A copy of the
JAX package's module (struct + numpy): the port imports nothing of it, and
the two produce the same bytes.

Correct by construction, not by copied tables: the per-message CRC_EXTRA
seed byte is DERIVED from the message definition exactly the way the
MAVLink generator derives it from common.xml (x25 CRC over
"<NAME> " + "<type> <name> "... over size-sorted fields, arrays appending
the length byte), and the unit tests pin the derived values to the
published constants (HEARTBEAT=50, SET_ATTITUDE_TARGET=49, ...) plus the
CRC-16/MCRF4XX check vector crc("123456789") = 0x6F91.

Scope notes:
  - v1 framing (0xFE) and v2 framing (0xFD, zero-truncated payloads,
    unsigned / no signature) both supported; PX4 accepts either.
  - Frames: the ENU<->NED / FLU<->FRD conversions MAVROS applies live in
    `enu_to_ned` / `quat_flu_enu_to_frd_ned` (and inverses) so the
    controller keeps working in the reference's ENU world frame.
"""
from __future__ import annotations

import struct
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np

MAVLINK1_MAGIC = 0xFE
MAVLINK2_MAGIC = 0xFD

_TYPE_FMT = {
    "double": "d", "uint64_t": "Q", "int64_t": "q",
    "float": "f", "uint32_t": "I", "int32_t": "i",
    "uint16_t": "H", "int16_t": "h",
    "uint8_t": "B", "int8_t": "b", "char": "c",
}
_TYPE_SIZE = {k: struct.calcsize(v) for k, v in _TYPE_FMT.items()}


class FieldDef(NamedTuple):
    name: str
    type: str       # element type, e.g. "float"
    count: int      # array length; 1 for scalars


class MessageDef(NamedTuple):
    name: str
    msg_id: int
    fields: Tuple[FieldDef, ...]  # XML declaration order

    @property
    def wire_fields(self) -> List[FieldDef]:
        """MAVLink wire order: stable sort by element size, descending."""
        return sorted(self.fields, key=lambda f: -_TYPE_SIZE[f.type])

    @property
    def payload_len(self) -> int:
        return sum(_TYPE_SIZE[f.type] * f.count for f in self.fields)


def x25_crc(data: bytes, crc: int = 0xFFFF) -> int:
    """CRC-16/MCRF4XX — the MAVLink checksum (x25_crc_accumulate)."""
    for b in data:
        tmp = (b ^ (crc & 0xFF)) & 0xFF
        tmp = (tmp ^ (tmp << 4)) & 0xFF
        crc = ((crc >> 8) ^ (tmp << 8) ^ (tmp << 3) ^ (tmp >> 4)) & 0xFFFF
    return crc


def crc_extra(msg: MessageDef) -> int:
    """Derive the message's CRC_EXTRA seed the way the MAVLink code
    generator does: x25 over name + wire-ordered "type name " strings,
    arrays contributing their length byte; fold to one byte."""
    crc = x25_crc((msg.name + " ").encode())
    for f in msg.wire_fields:
        crc = x25_crc((f.type + " ").encode(), crc)
        crc = x25_crc((f.name + " ").encode(), crc)
        if f.count > 1:
            crc = x25_crc(bytes([f.count]), crc)
    return (crc & 0xFF) ^ (crc >> 8)


# ---- message catalog (MAVLink common.xml definitions, XML field order;
# the "uint8_t_mavlink_version" pseudo-type is plain uint8_t on the wire
# and in the CRC seed) ----
HEARTBEAT = MessageDef("HEARTBEAT", 0, (
    FieldDef("type", "uint8_t", 1),
    FieldDef("autopilot", "uint8_t", 1),
    FieldDef("base_mode", "uint8_t", 1),
    FieldDef("custom_mode", "uint32_t", 1),
    FieldDef("system_status", "uint8_t", 1),
    FieldDef("mavlink_version", "uint8_t", 1),
))
ATTITUDE_QUATERNION = MessageDef("ATTITUDE_QUATERNION", 31, (
    FieldDef("time_boot_ms", "uint32_t", 1),
    FieldDef("q1", "float", 1),
    FieldDef("q2", "float", 1),
    FieldDef("q3", "float", 1),
    FieldDef("q4", "float", 1),
    FieldDef("rollspeed", "float", 1),
    FieldDef("pitchspeed", "float", 1),
    FieldDef("yawspeed", "float", 1),
))
LOCAL_POSITION_NED = MessageDef("LOCAL_POSITION_NED", 32, (
    FieldDef("time_boot_ms", "uint32_t", 1),
    FieldDef("x", "float", 1),
    FieldDef("y", "float", 1),
    FieldDef("z", "float", 1),
    FieldDef("vx", "float", 1),
    FieldDef("vy", "float", 1),
    FieldDef("vz", "float", 1),
))
SET_ATTITUDE_TARGET = MessageDef("SET_ATTITUDE_TARGET", 82, (
    FieldDef("time_boot_ms", "uint32_t", 1),
    FieldDef("target_system", "uint8_t", 1),
    FieldDef("target_component", "uint8_t", 1),
    FieldDef("type_mask", "uint8_t", 1),
    FieldDef("q", "float", 4),
    FieldDef("body_roll_rate", "float", 1),
    FieldDef("body_pitch_rate", "float", 1),
    FieldDef("body_yaw_rate", "float", 1),
    FieldDef("thrust", "float", 1),
))

MESSAGES: Dict[int, MessageDef] = {
    m.msg_id: m for m in (HEARTBEAT, ATTITUDE_QUATERNION,
                          LOCAL_POSITION_NED, SET_ATTITUDE_TARGET)
}
CRC_EXTRA: Dict[int, int] = {mid: crc_extra(m) for mid, m in MESSAGES.items()}


def pack_payload(msg: MessageDef, values: Dict) -> bytes:
    """Pack named values into the wire-ordered little-endian payload."""
    out = b""
    for f in msg.wire_fields:
        v = values[f.name]
        fmt = "<" + _TYPE_FMT[f.type] * f.count
        if f.count == 1:
            out += struct.pack(fmt, v)
        else:
            seq = list(np.asarray(v).reshape(-1))
            if len(seq) != f.count:
                raise ValueError(f"{msg.name}.{f.name}: expected "
                                 f"{f.count} values, got {len(seq)}")
            out += struct.pack(fmt, *seq)
    return out


def unpack_payload(msg: MessageDef, payload: bytes) -> Dict:
    """Inverse of pack_payload. Accepts v2 zero-truncated payloads."""
    full = msg.payload_len
    if len(payload) < full:  # MAVLink 2 trailing-zero truncation
        payload = payload + b"\x00" * (full - len(payload))
    values: Dict = {}
    off = 0
    for f in msg.wire_fields:
        fmt = "<" + _TYPE_FMT[f.type] * f.count
        size = _TYPE_SIZE[f.type] * f.count
        vals = struct.unpack_from(fmt, payload, off)
        values[f.name] = vals[0] if f.count == 1 else np.asarray(vals)
        off += size
    return values


class Frame(NamedTuple):
    msg_id: int
    seq: int
    sysid: int
    compid: int
    payload: bytes
    mavlink2: bool

    def values(self) -> Dict:
        return unpack_payload(MESSAGES[self.msg_id], self.payload)


def encode_frame(msg: MessageDef, values: Dict, seq: int, sysid: int = 1,
                 compid: int = 1, mavlink2: bool = True) -> bytes:
    payload = pack_payload(msg, values)
    if mavlink2:
        # zero-truncation: strip trailing zero bytes, keep at least one
        trimmed = payload.rstrip(b"\x00")
        if not trimmed:
            trimmed = b"\x00"
        hdr = struct.pack("<BBBBBBB", MAVLINK2_MAGIC, len(trimmed), 0, 0,
                          seq & 0xFF, sysid, compid)
        hdr += struct.pack("<I", msg.msg_id)[:3]  # 24-bit LE msgid
        body = hdr + trimmed
    else:
        if msg.msg_id > 0xFF:
            raise ValueError("MAVLink 1 cannot carry msgid > 255")
        body = struct.pack("<BBBBBB", MAVLINK1_MAGIC, len(payload),
                           seq & 0xFF, sysid, compid, msg.msg_id) + payload
    crc = x25_crc(body[1:])  # magic byte excluded
    crc = x25_crc(bytes([CRC_EXTRA[msg.msg_id]]), crc)
    return body + struct.pack("<H", crc)


class MavlinkParser:
    """Incremental MAVLink v1+v2 byte-stream parser.

    Feed arbitrary byte chunks (datagrams, serial reads); complete frames
    with valid CRCs for known messages come back in order. Unknown message
    ids can't be CRC-checked (CRC_EXTRA unknown) and are skipped; corrupt
    frames increment `bad_frames` and resync on the next magic byte.
    """

    def __init__(self):
        self._buf = bytearray()
        self.bad_frames = 0
        self.skipped_unknown = 0

    def feed(self, data: bytes) -> List[Frame]:
        self._buf.extend(data)
        frames: List[Frame] = []
        while True:
            frame = self._try_parse()
            if frame is None:
                break
            if frame is not False:  # False = consumed garbage, retry
                frames.append(frame)
        return frames

    def _resync(self) -> None:
        """Drop the current magic byte and scan to the next candidate."""
        del self._buf[0]
        while self._buf and self._buf[0] not in (MAVLINK1_MAGIC,
                                                 MAVLINK2_MAGIC):
            del self._buf[0]

    def _try_parse(self):
        buf = self._buf
        while buf and buf[0] not in (MAVLINK1_MAGIC, MAVLINK2_MAGIC):
            del buf[0]
        if len(buf) < 8:
            return None
        if buf[0] == MAVLINK2_MAGIC:
            plen = buf[1]
            total = 12 + plen  # hdr 10 + payload + crc 2 (unsigned)
            if buf[2] & 0x01:  # signed frame: 13 more signature bytes
                total += 13
            if len(buf) < total:
                return None
            seq, sysid, compid = buf[4], buf[5], buf[6]
            msg_id = buf[7] | (buf[8] << 8) | (buf[9] << 16)
            payload = bytes(buf[10:10 + plen])
            crc_rx = struct.unpack_from("<H", buf, 10 + plen)[0]
            mav2 = True
            crc_span = bytes(buf[1:10 + plen])
        else:
            plen = buf[1]
            total = 8 + plen
            if len(buf) < total:
                return None
            seq, sysid, compid, msg_id = buf[2], buf[3], buf[4], buf[5]
            payload = bytes(buf[6:6 + plen])
            crc_rx = struct.unpack_from("<H", buf, 6 + plen)[0]
            mav2 = False
            crc_span = bytes(buf[1:6 + plen])
        if msg_id not in CRC_EXTRA:
            self.skipped_unknown += 1
            del buf[:total]
            return False
        crc = x25_crc(crc_span)
        crc = x25_crc(bytes([CRC_EXTRA[msg_id]]), crc)
        if crc != crc_rx:
            self.bad_frames += 1
            self._resync()
            return False
        del buf[:total]
        return Frame(msg_id, seq, sysid, compid, payload, mav2)


# --------------- frame conventions (the MAVROS conversions) ---------------
# MAVROS presents ENU world / FLU body to ROS; PX4 speaks NED world / FRD
# body. The reference works in the MAVROS (ENU) convention, so a direct
# PX4 link needs these two conversions (mavros ftf transforms).

def enu_to_ned(p_enu: np.ndarray) -> np.ndarray:
    """World-frame vector ENU -> NED: (x,y,z)_ned = (y, x, -z)_enu."""
    p = np.asarray(p_enu, dtype=np.float64)
    return np.array([p[1], p[0], -p[2]])


def ned_to_enu(p_ned: np.ndarray) -> np.ndarray:
    """Inverse of enu_to_ned (the map is an involution)."""
    return enu_to_ned(p_ned)


def _quat_mul(a, b):
    aw, ax, ay, az = a
    bw, bx, by, bz = b
    return np.array([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ])

# ENU->NED is a 180deg rotation about (sqrt2/2, sqrt2/2, 0);
# FLU->FRD is a 180deg rotation about body x.
_Q_NS = np.array([0.0, np.sqrt(0.5), np.sqrt(0.5), 0.0])
_Q_BS = np.array([0.0, 1.0, 0.0, 0.0])


def quat_flu_enu_to_frd_ned(q_wxyz: np.ndarray) -> np.ndarray:
    """Attitude quaternion (body FLU in world ENU) -> (FRD in NED), the
    transform MAVROS applies to attitude setpoints before PX4."""
    q = np.asarray(q_wxyz, dtype=np.float64)
    return _quat_mul(_quat_mul(_Q_NS, q), _Q_BS)


def quat_frd_ned_to_flu_enu(q_wxyz: np.ndarray) -> np.ndarray:
    """Inverse of quat_flu_enu_to_frd_ned (both factors are involutions
    up to sign; quaternion sign is irrelevant for rotations)."""
    q = np.asarray(q_wxyz, dtype=np.float64)
    # conj(Q_NS) = -Q_NS (pure quaternion); signs cancel in the sandwich
    return _quat_mul(_quat_mul(_Q_NS, q), _Q_BS)


# ------------------------- high-level encoders ----------------------------

def encode_set_attitude_target(q_wxyz, thrust: float, type_mask: int,
                               seq: int, time_boot_ms: int = 0,
                               target_system: int = 1,
                               target_component: int = 1,
                               sysid: int = 255, compid: int = 190,
                               mavlink2: bool = True,
                               convert_frames: bool = True) -> bytes:
    """One SET_ATTITUDE_TARGET frame from the reference's publish fields
    (`mavros_blaster_sim.py:91-102`: orientation quat + type_mask=7 +
    normalized thrust). sysid/compid default to the conventional GCS
    (255/190). convert_frames applies the MAVROS ENU/FLU -> NED/FRD
    attitude conversion; pass False if the quat is already PX4-frame."""
    q = np.asarray(q_wxyz, dtype=np.float64)
    if convert_frames:
        q = quat_flu_enu_to_frd_ned(q)
    return encode_frame(SET_ATTITUDE_TARGET, {
        "time_boot_ms": int(time_boot_ms) & 0xFFFFFFFF,
        "target_system": target_system,
        "target_component": target_component,
        "type_mask": type_mask & 0xFF,
        "q": np.asarray(q, np.float64),
        "body_roll_rate": 0.0, "body_pitch_rate": 0.0,
        "body_yaw_rate": 0.0,
        "thrust": float(thrust),
    }, seq, sysid=sysid, compid=compid, mavlink2=mavlink2)


def decode_pose_messages(frames: List[Frame]
                         ) -> List[Tuple[str, float, np.ndarray]]:
    """LOCAL_POSITION_NED / ATTITUDE_QUATERNION frames -> ENU/FLU samples:
    ("pos", t, p_enu(3)) and ("att", t, q_wxyz FLU-ENU). Together these are
    the `mavros/local_position/pose` content the reference subscribes to."""
    out = []
    for fr in frames:
        if fr.msg_id == LOCAL_POSITION_NED.msg_id:
            v = fr.values()
            p = ned_to_enu(np.array([v["x"], v["y"], v["z"]]))
            out.append(("pos", v["time_boot_ms"] * 1e-3, p))
        elif fr.msg_id == ATTITUDE_QUATERNION.msg_id:
            v = fr.values()
            q = quat_frd_ned_to_flu_enu(
                np.array([v["q1"], v["q2"], v["q3"], v["q4"]]))
            out.append(("att", v["time_boot_ms"] * 1e-3, q))
    return out
