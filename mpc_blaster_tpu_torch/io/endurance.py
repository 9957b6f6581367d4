"""The endurance mission: the flight shell through real transport.

The SITL-lite vehicle (`io/mission.py::SitlLiteVehicle`, the PX4
inner-loop stand-in) runs in its OWN PROCESS, as the real vehicle would,
and exchanges byte-level MAVLink v2 with the controller over UDP, with
seeded link faults (drops, truncations, noise bursts embedding magic
bytes) injected mid-mission. Clocked loops under the native `RateLoop`:

  vehicle proc    100 Hz — apply setpoints, integrate plant + wind, stream
                           LOCAL_POSITION_NED + ATTITUDE_QUATERNION
  telemetry proc  100 Hz — drain UDP, incremental MAVLink parse (resync),
                           publish the latest measurement (shared memory)
  control (caller) 10 Hz — `OffsetFreeFlightController`'s watchdog-guarded
                           warm RTI tick with measured feedback + wind
                           observer (the reference's own publish rate,
                           `mavros_blaster_sim.py:35`)

The JAX package keeps this harness in `tests/test_endurance.py`; the port
keeps it here, where `tests/test_torch_endurance.py` and chip_smoke.py's
phase 23 both run it. The two processes are started with `spawn`, not
`fork`: the controller's process may hold the card and torch's thread
pools, and a fresh interpreter inherits neither. They make no torch call.
GC is off in the clocked region (a collector pause is not a controller
property).
"""
from __future__ import annotations

import dataclasses
import gc
import multiprocessing
import os
import socket
import time

import numpy as np
import torch

from mpc_blaster_tpu_torch import config as cfg
from mpc_blaster_tpu_torch.io import mavlink as mv
from mpc_blaster_tpu_torch.io.mission import (FaultyLink,
                                              OffsetFreeFlightController,
                                              SitlLiteVehicle,
                                              quat_wxyz_to_euler_zyx)
from mpc_blaster_tpu_torch.ocp.spec import build_spec
from mpc_blaster_tpu_torch.runtime import RateLoop

WIND = np.array([0.6, -0.4, 0.15])
TARGET = np.array([0.5, 1.0, 3.5])
# the two processes report their port within this many seconds (a spawned
# interpreter imports torch first)
READY_S = 120.0


def _euler_to_quat_np(eul):
    phi, th, psi = eul
    cy, sy = np.cos(psi / 2), np.sin(psi / 2)
    cp, sp = np.cos(th / 2), np.sin(th / 2)
    cr, sr = np.cos(phi / 2), np.sin(phi / 2)
    return np.array([cr * cp * cy + sr * sp * sy,
                     sr * cp * cy - cr * sp * sy,
                     cr * sp * cy + sr * cp * sy,
                     cr * cp * sy - sr * sp * cy])


def vehicle_process(ctrl_port: int, ready_q, stats_q, duration_s: float,
                    go):
    """The vehicle side, in its own process: numpy + sockets only. Its
    clocked loop starts when `go` (a multiprocessing Event) is set."""
    vsock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    vsock.bind(("127.0.0.1", 0))
    vsock.setblocking(False)
    tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    down = FaultyLink(tx, ("127.0.0.1", ctrl_port), seed=1,
                      p_drop=0.05, p_trunc=0.02, burst_every=400)
    vehicle = SitlLiteVehicle([0.0, 0.0, 3.0], WIND, dt=0.01,
                              mass=9.0, t_blast=2.2 * 9.81)
    parser = mv.MavlinkParser()
    # pre-warm the encoder, then report the bound port
    mv.encode_frame(mv.LOCAL_POSITION_NED, dict(
        time_boot_ms=0, x=0, y=0, z=0, vx=0, vy=0, vz=0), 0)
    ready_q.put(vsock.getsockname()[1])
    go.wait(READY_S)
    gc.disable()

    rl = RateLoop(100.0)
    seq = 0
    n = int(duration_s * 100)
    for _ in range(n):
        try:
            while True:
                data, _ = vsock.recvfrom(2048)
                for fr in parser.feed(data):
                    if fr.msg_id == mv.SET_ATTITUDE_TARGET.msg_id:
                        v = fr.values()
                        vehicle.command(np.asarray(v["q"]),
                                        float(v["thrust"]))
        except BlockingIOError:
            pass
        vehicle.step()
        p_ned = mv.enu_to_ned(vehicle.p)
        v_ned = mv.enu_to_ned(vehicle.v)
        q = _euler_to_quat_np(vehicle.eul)
        t_ms = int(seq * 10)
        down.send(mv.encode_frame(mv.LOCAL_POSITION_NED, dict(
            time_boot_ms=t_ms, x=p_ned[0], y=p_ned[1], z=p_ned[2],
            vx=v_ned[0], vy=v_ned[1], vz=v_ned[2]), seq))
        down.send(mv.encode_frame(mv.ATTITUDE_QUATERNION, dict(
            time_boot_ms=t_ms, q1=q[0], q2=q[1], q3=q[2], q4=q[3],
            rollspeed=0.0, pitchspeed=0.0, yawspeed=0.0), seq))
        seq = (seq + 1) % 256
        rl.sleep()
    stats_q.put(dict(rate=rl.stats(), sent=down.sent, dropped=down.dropped,
                     truncated=down.truncated, bursts=down.bursts,
                     final_p=np.asarray(vehicle.p)))
    vsock.close()
    tx.close()


def telemetry_process(ready_q, stats_q, shm_name, duration_s: float, go):
    """The product's telemetry ingest, as its own PROCESS (the GIL-free
    twin of the native SPSC ring design, `runtime/native/executor.cpp`):
    drain UDP at 100 Hz, MAVLink-parse with resync, publish the latest
    measurement into a shared-memory seqlock mailbox
    [seq, have_p, have_eul, have_v, p(3), eul(3), v(3)]. Its clocked
    loop starts when `go` is set."""
    from multiprocessing import shared_memory

    shm = shared_memory.SharedMemory(name=shm_name)
    box = np.ndarray((13,), dtype=np.float64, buffer=shm.buf)
    csock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    csock.bind(("127.0.0.1", 0))
    csock.setblocking(False)
    parser = mv.MavlinkParser()
    ready_q.put(csock.getsockname()[1])
    go.wait(READY_S)
    gc.disable()

    have = [0.0, 0.0, 0.0]
    vals_cache = {}
    rx_total = 0
    rx_final = 0
    late_events = []
    rl = RateLoop(100.0)
    n = int(duration_s * 100)
    final_window = n - 100
    for i in range(n):
        updated = False
        try:
            while True:
                data, _ = csock.recvfrom(2048)
                for fr in parser.feed(data):
                    vals = fr.values()
                    if fr.msg_id == mv.LOCAL_POSITION_NED.msg_id:
                        vals_cache["p"] = mv.ned_to_enu(np.array(
                            [vals["x"], vals["y"], vals["z"]]))
                        vals_cache["v"] = mv.ned_to_enu(np.array(
                            [vals["vx"], vals["vy"], vals["vz"]]))
                        have[0] = have[2] = 1.0
                        updated = True
                    elif fr.msg_id == mv.ATTITUDE_QUATERNION.msg_id:
                        vals_cache["eul"] = quat_wxyz_to_euler_zyx(
                            np.array([vals["q1"], vals["q2"],
                                      vals["q3"], vals["q4"]]))
                        have[1] = 1.0
                        updated = True
                    rx_total += 1
                    if i >= final_window:
                        rx_final += 1
        except BlockingIOError:
            pass
        if updated:
            seq = box[0]
            box[0] = seq + 1.0          # odd: write in progress
            box[1:4] = have
            if "p" in vals_cache:
                box[4:7] = vals_cache["p"]
            if "eul" in vals_cache:
                box[7:10] = vals_cache["eul"]
            if "v" in vals_cache:
                box[10:13] = vals_cache["v"]
            box[0] = seq + 2.0          # even: consistent
        late = rl.sleep()
        if late > 0.001:
            late_events.append((i, round(late, 4)))
    stats_q.put(dict(rate=rl.stats(), bad_frames=parser.bad_frames,
                     rx_total=rx_total, rx_final=rx_final,
                     late_events=late_events[:50]))
    csock.close()
    shm.close()


def mission_ocp(qp_backend: str = "riccati") -> cfg.OCPConfig:
    """The flight preset cut to the mission's controller: N=10 over 1 s
    (dt == the 10 Hz control period), 6 warm IPM iterations with a
    shifted primal warm start, on `qp_backend`."""
    fl = cfg.flight_preset()
    return dataclasses.replace(
        fl.ocp, N=10, Tf=1.0,
        solver=dataclasses.replace(
            fl.ocp.solver, qp_backend=qp_backend, ipm_iters=6,
            warm_shift=True, warm_mode="primal"))


def _stop(proc, timeout: float = 10.0) -> None:
    proc.join(timeout=timeout)
    if proc.is_alive():
        proc.terminate()
        proc.join(timeout=timeout)


def run_mission(duration_s: float, ocp=None, device=None) -> dict:
    """Fly the mission for `duration_s` (the vehicle's and the telemetry
    loop's span; the control loop runs duration_s * 10 ticks) with the
    controller on `device` (the card unless asked otherwise). Returns the
    loops' rate statistics, the link's fault counts, the parser's, the
    position errors of every control tick, the controller's work per
    tick (`work_s`), its final disturbance estimate and its watchdog's
    trips."""
    from multiprocessing import shared_memory

    ocp = ocp or mission_ocp()
    yref = (tuple(TARGET) + (0.0,) * 20)
    spec = build_spec(ocp, yref=yref, dtype=torch.float32, device=device)
    ctrl = OffsetFreeFlightController(ocp, spec, observer_gain=0.4)

    # ---- pre-warm everything BEFORE any mission clock starts ----
    x_like = np.zeros(cfg.NX, np.float32)
    x_like[2] = 3.0
    ctrl.warmup(x_like)
    mv.encode_frame(mv.SET_ATTITUDE_TARGET, dict(
        time_boot_ms=0, target_system=1, target_component=1, type_mask=7,
        q=(1.0, 0.0, 0.0, 0.0), body_roll_rate=0.0, body_pitch_rate=0.0,
        body_yaw_rate=0.0, thrust=0.7), 0)

    shm = shared_memory.SharedMemory(create=True, size=13 * 8)
    box = np.ndarray((13,), dtype=np.float64, buffer=shm.buf)
    box[:] = 0.0
    mp = multiprocessing.get_context("spawn")
    # A spawned process takes seconds to start (it imports torch), so the
    # two 100 Hz loops wait for `go`, set when both are up, and start
    # together with the control loop, as forked ones would.
    go = mp.Event()
    procs = []
    tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        io_ready, io_stats_q = mp.Queue(), mp.Queue()
        procs.append(mp.Process(target=telemetry_process,
                                args=(io_ready, io_stats_q, shm.name,
                                      duration_s, go), daemon=True))
        procs[-1].start()
        ctrl_port = io_ready.get(timeout=READY_S)

        veh_ready, veh_stats_q = mp.Queue(), mp.Queue()
        procs.append(mp.Process(target=vehicle_process,
                                args=(ctrl_port, veh_ready, veh_stats_q,
                                      duration_s, go), daemon=True))
        procs[-1].start()
        vport = veh_ready.get(timeout=READY_S)
        up = FaultyLink(tx, ("127.0.0.1", vport), seed=2,
                        p_drop=0.05, p_trunc=0.0, burst_every=0)

        # Deprioritize the SOLVER process (this one): its 10 Hz loop has
        # a 100 ms budget, while the two 100 Hz loops need microseconds.
        # nice() is process-wide and irreversible without privileges; the
        # two loops' processes started above keep their priority.
        try:
            os.nice(5)
        except OSError:
            pass

        def read_box():
            for _ in range(8):  # seqlock retry
                s0 = box[0]
                if s0 % 2.0 != 0.0:
                    continue
                snap = box[1:13].copy()
                if box[0] == s0:
                    return snap
            return None

        gc.collect()
        gc.disable()
        go.set()
        # ---- control loop (this thread, 10 Hz) ----
        rlc = RateLoop(10.0)
        seq = 0
        errs, work, worst_work = [], [], 0.0
        try:
            for _ in range(int(duration_s * 10)):
                t_work = time.perf_counter()
                snap = read_box()
                if snap is not None and snap[0:3].all():
                    p_m, eul_m, v_m = snap[3:6], snap[6:9], snap[9:12]
                    quat, thrust, _diag = ctrl.tick(p_m, eul_m, v_m)
                    up.send(mv.encode_frame(mv.SET_ATTITUDE_TARGET, dict(
                        time_boot_ms=0, target_system=1, target_component=1,
                        type_mask=7, q=tuple(float(x) for x in quat),
                        body_roll_rate=0.0, body_pitch_rate=0.0,
                        body_yaw_rate=0.0, thrust=float(thrust)), seq))
                    seq = (seq + 1) % 256
                    errs.append(float(np.linalg.norm(p_m - TARGET)))
                    work.append(time.perf_counter() - t_work)
                worst_work = max(worst_work, time.perf_counter() - t_work)
                rlc.sleep()
        finally:
            gc.enable()
        ctrl_stats = rlc.stats()
        ctrl_stats["worst_work_s"] = worst_work
        io = io_stats_q.get(timeout=60)
        veh = veh_stats_q.get(timeout=60)
    finally:
        for p in procs:
            _stop(p)
        tx.close()
        shm.close()
        shm.unlink()

    return dict(veh=veh, io=io["rate"], ctrl=ctrl_stats, up=up,
                io_late=io.get("late_events"),
                parser={"bad_frames": io["bad_frames"]},
                errs=np.asarray(errs), work_s=np.asarray(work),
                rx_total=io["rx_total"], rx_final=io["rx_final"],
                d_est=ctrl.d_est.copy(), watchdog_trips=int(ctrl.wd.trips))
