"""The port's endurance-mission parts (`mpc_blaster_tpu_torch/io/
mission.py`) against the JAX package's: the numpy vehicle, link and
conversions equal to the last bit (and free of torch calls), and the
offset-free flight controller against the JAX controller on the same
scripted measurements.

The controller's inputs are scripted, not flown: the measurements do not
answer its commands, so its disturbance observer integrates the
velocity-prediction residual (gain 0.4 over dt 0.1 s) without bound and
the warm chain runs into its rotor bounds. Any rounding difference grows
about tenfold a tick there (measured in float64: 1e-16 after the first
tick, 1e-11 after the second, 5e-7 after the sixth, 1e-2 after the
fifteenth; in float32 the first warm tick already moves the thrust by
1.4e-2). So float64 is held tightly over six ticks and float32, the
mission's dtype, over fifteen at bounds set from its measured gaps.
"""
import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from torch.overrides import TorchFunctionMode

import chip_smoke
from mpc_blaster_tpu import config as jcfg
from mpc_blaster_tpu.io import mission as J
from mpc_blaster_tpu.ocp.spec import build_spec as jbuild_spec
from mpc_blaster_tpu_torch.io import mission as T
from mpc_blaster_tpu_torch.io.endurance import TARGET, WIND, mission_ocp
from mpc_blaster_tpu_torch.ocp.spec import build_spec
from torch_threads import one_intraop_thread  # noqa: F401

DEV = torch.device("cpu")
YREF = tuple(TARGET) + (0.0,) * 20


class _NoTorch(TorchFunctionMode):
    """Fails on any torch function call inside its context."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        raise AssertionError(f"torch call {func} in a numpy-only part")


def test_invert_thruster_cumul_and_euler_equal_jax():
    rng = np.random.default_rng(0)
    with _NoTorch():
        for norm in (0.0, 0.3, 0.705, 1.0, *rng.uniform(-0.2, 1.2, 50)):
            assert T.invert_thruster_cumul(norm) == \
                J.invert_thruster_cumul(norm)
        for _ in range(50):
            q = rng.normal(size=4)
            q /= np.linalg.norm(q)
            np.testing.assert_array_equal(T.quat_wxyz_to_euler_zyx(q),
                                          J.quat_wxyz_to_euler_zyx(q))
    # the inverse of the port's thrust normalization
    for t in (5.0, 22.0, 40.0):
        assert abs(T.invert_thruster_cumul(T.thruster_cumul(t, t, t, t))
                   - t) < 1e-9


def test_sitl_lite_vehicle_equals_jax():
    """200 steps of the vehicle under changing commands: every state
    equal to the JAX vehicle's, with no torch call."""
    rng = np.random.default_rng(1)
    tv = T.SitlLiteVehicle([0.0, 0.0, 3.0], WIND, dt=0.01)
    jv = J.SitlLiteVehicle([0.0, 0.0, 3.0], WIND, dt=0.01)
    with _NoTorch():
        for k in range(200):
            if k % 10 == 0:
                q = np.array([1.0, *rng.normal(scale=0.05, size=3)])
                q /= np.linalg.norm(q)
                thrust = float(rng.uniform(0.4, 0.8))
                tv.command(q, thrust)
                jv.command(q, thrust)
            tv.step()
            jv.step()
            for a in ("p", "eul", "v"):
                np.testing.assert_array_equal(getattr(tv, a),
                                              getattr(jv, a))
    assert np.isfinite(tv.p).all()


class _Sock:
    def __init__(self):
        self.sent = []

    def sendto(self, data, addr):
        self.sent.append((bytes(data), addr))


def test_faulty_link_equals_jax():
    """The seeded drops, truncations and noise bursts: the same datagrams
    and counts as the JAX link's, with no torch call."""
    rng = np.random.default_rng(2)
    frames = [bytes(rng.integers(0, 256, int(rng.integers(4, 60)),
                                 dtype=np.uint8)) for _ in range(1200)]
    ts, js = _Sock(), _Sock()
    tl = T.FaultyLink(ts, ("127.0.0.1", 1), seed=1, burst_every=400)
    jl = J.FaultyLink(js, ("127.0.0.1", 1), seed=1, burst_every=400)
    with _NoTorch():
        for f in frames:
            tl.send(f)
            jl.send(f)
    assert ts.sent == js.sent
    assert (tl.sent, tl.dropped, tl.truncated, tl.bursts) == \
        (jl.sent, jl.dropped, jl.truncated, jl.bursts)
    assert tl.dropped > 30 and tl.truncated > 10 and tl.bursts == 3


def _jax_mission_ocp(qp_backend="riccati"):
    """tests/test_endurance.py:188-196's `_mission_ocp` on `qp_backend`."""
    fl = jcfg.flight_preset()
    return dataclasses.replace(
        fl.ocp, N=10, Tf=1.0,
        solver=dataclasses.replace(
            fl.ocp.solver, qp_backend=qp_backend, ipm_iters=6,
            warm_shift=True, warm_mode="primal"))


def test_mission_ocp_equals_jax():
    from test_torch_closedloop import _same_fields
    for backend in ("riccati", "pallas", "pallas_fused"):
        _same_fields(mission_ocp(backend), _jax_mission_ocp(backend))


def _controllers(jdtype, tdtype):
    jocp, tocp = _jax_mission_ocp(), mission_ocp()
    jc = J.OffsetFreeFlightController(
        jocp, jbuild_spec(jocp, yref=YREF, dtype=jdtype), observer_gain=0.4,
        dtype=jdtype)
    tc = T.OffsetFreeFlightController(
        tocp, build_spec(tocp, yref=YREF, dtype=tdtype, device=DEV),
        observer_gain=0.4, dtype=tdtype)
    return jc, tc


def _measurement(k):
    """A scripted hover-region measurement (p, eul, v) at tick k."""
    return (np.array([0.5 + 0.01 * k, 1.0 - 0.01 * k, 3.5 + 0.005 * k]),
            np.array([0.01 * np.sin(k / 3), -0.005, 0.002 * k]),
            np.array([0.1, -0.1, 0.05]))


def _gaps(jc, tc, n):
    out = np.zeros((n, 3))
    for k in range(n):
        qj, thj, _ = jc.tick(*_measurement(k))
        qt, tht, diag = tc.tick(*_measurement(k))
        assert qt.shape == (4,) and np.isfinite(qt).all()
        assert abs(np.linalg.norm(qt) - 1.0) < 1e-5
        out[k] = (np.abs(qj - qt).max(), abs(thj - tht),
                  np.abs(jc.d_est - tc.d_est).max())
    assert int(tc.wd.trips) == int(jc.wd.trips) == 0
    return out


def test_offset_free_controller_matches_jax_f64():
    """Six ticks in float64: quaternion, thrust and d_est within 1e-5
    (measured at most 3.8e-7, 5.1e-7 and 1.2e-6)."""
    jc, tc = _controllers(jnp.float64, torch.float64)
    g = _gaps(jc, tc, 6)
    assert (g <= 1e-5).all(), g
    assert tc.d_est.dtype == np.float64 and tc.d_est[3:].tolist() == [0] * 3


def test_offset_free_controller_matches_jax_f32():
    """Fifteen ticks in float32 on "riccati", the mission's dtype:
    quaternion within 0.04, normalized thrust within 0.5 and d_est within
    4 m/s^2 (measured at most 1.2e-2, 0.16 and 1.19; the first tick within
    1e-6: 7.5e-9, 1.2e-7 and 0)."""
    jc, tc = _controllers(jnp.float32, torch.float32)
    g = _gaps(jc, tc, 15)
    assert (g[0] <= 1e-6).all(), g[0]
    assert (g.max(0) <= [0.04, 0.5, 4.0]).all(), g.max(0)


def test_offset_free_controller_pallas_twin_matches_riccati():
    """chip_smoke.py's mission witness on the CPU: the controller on
    "pallas" (here the kernel's plain twin) against "riccati" over the
    same fifteen scripted ticks, no watchdog trip on either, the gaps
    within the bounds the card's run is held to (`WITNESS_TOL`, this
    file's f32 bounds on the port against JAX; measured 7.8e-3, 0.24 and
    2.0), the first (cold) tick within `WITNESS_FIRST_TOL` (measured
    1.7e-8, 0 and 0)."""
    assert chip_smoke.WITNESS_TICKS == 15
    assert chip_smoke.WITNESS_TOL == (0.04, 0.5, 4.0)
    p = chip_smoke.scripted_controller(DEV, 15, "pallas")
    r = chip_smoke.scripted_controller(DEV, 15, "riccati")
    assert p["trips"] == r["trips"] == 0
    g = np.stack([np.abs(p["q"] - r["q"]).max(1),
                  np.abs(p["thrust"] - r["thrust"]),
                  np.abs(p["d_est"] - r["d_est"]).max(1)], 1)
    assert (g[0] <= chip_smoke.WITNESS_FIRST_TOL).all(), g[0]
    assert (g.max(0) <= chip_smoke.WITNESS_TOL).all(), g.max(0)


def test_offset_free_controller_refuses_pallas_fused():
    """As in the JAX package the controller passes no `dyn_statics`, so on
    the one-launch backend its first tick raises, in both packages."""
    jocp, tocp = _jax_mission_ocp("pallas_fused"), mission_ocp(
        "pallas_fused")
    jc = J.OffsetFreeFlightController(
        jocp, jbuild_spec(jocp, yref=YREF, dtype=jnp.float32))
    tc = T.OffsetFreeFlightController(
        tocp, build_spec(tocp, yref=YREF, device=DEV))
    for c in (jc, tc):
        with pytest.raises(ValueError, match="dyn_statics"):
            c.tick(*_measurement(0))


def test_offset_free_controller_runs_on_pallas_twin():
    """On "pallas" the controller runs (on the CPU the kernel's plain
    twin): three ticks, finite unit quaternions."""
    tocp = mission_ocp("pallas")
    tc = T.OffsetFreeFlightController(
        tocp, build_spec(tocp, yref=YREF, device=DEV))
    for k in range(3):
        q, thrust, diag = tc.tick(*_measurement(k))
        assert abs(np.linalg.norm(q) - 1.0) < 1e-5 and np.isfinite(thrust)
    assert tc.device == DEV
