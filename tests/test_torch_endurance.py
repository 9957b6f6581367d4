"""The port's endurance mission (`mpc_blaster_tpu_torch/io/endurance.py`)
on the CPU: the SITL-lite vehicle and the telemetry ingest in their own
processes, byte-level MAVLink 2 over UDP with seeded link faults, and the
port's `OffsetFreeFlightController` on the eager Riccati IPM ticking at
10 Hz under the native `RateLoop` (tests/test_endurance.py's mission).

tests/test_endurance.py:396-407's functional criteria hold here: frames
flow through the faults, the 100 Hz loops run all their ticks, no NaNs.
No timing is asserted on the CPU. The controller's tick is a
`utils/capture.py` runner, the port's `jax.jit`: on the card one CUDA
graph replay a tick, and there chip_smoke.py's phase 23c flies the 60 s
mission and holds it to tests/test_endurance.py:356-393, the 0.090 s work
bound included. On CPU tensors the runner runs the same tick without a
graph, an eager tick of ~160 ms on an idle core, which the tier-1 load
multiplies; so the work bound is not asserted here.
"""
import numpy as np
import pytest
import torch

from mpc_blaster_tpu_torch.io.endurance import mission_ocp, run_mission
from torch_threads import one_intraop_thread  # noqa: F401

DEV = torch.device("cpu")


def _assert_functional(r, duration_s):
    # the vehicle and telemetry loops ran all their ticks
    assert r["veh"]["rate"]["ticks"] == int(duration_s * 100)
    assert r["io"]["ticks"] == int(duration_s * 100)
    assert r["ctrl"]["ticks"] == int(duration_s * 10)
    # frames flowed through the injected faults, which the parser survived
    assert r["rx_total"] > 300
    assert r["veh"]["dropped"] > 0 and r["veh"]["truncated"] > 0
    assert r["parser"]["bad_frames"] > 0
    # every control tick closed the loop on a measurement
    assert len(r["errs"]) > 0 and np.isfinite(r["errs"]).all()
    assert r["up"].sent == len(r["errs"])
    assert np.isfinite(r["veh"]["final_p"]).all()
    assert np.isfinite(r["d_est"]).all()


def test_endurance_mission_smoke():
    """The 6 s mission on "riccati": the machinery end to end."""
    r = run_mission(6.0, mission_ocp("riccati"), device=DEV)
    _assert_functional(r, 6.0)
    assert r["veh"]["bursts"] >= 1


@pytest.mark.slow
def test_endurance_mission_60s():
    """The 60 s mission with its mid-mission link faults
    (tests/test_endurance.py:312-325's fault counts). Tracking and the
    disturbance estimate are not asserted here: on the CPU the tick runs
    without a graph and overruns its slot, so the vehicle flies on stale
    setpoints. On the card (chip_smoke.py's phase 23c) the captured tick
    flies the same mission to tests/test_endurance.py:356-393."""
    r = run_mission(60.0, mission_ocp("riccati"), device=DEV)
    _assert_functional(r, 60.0)
    assert r["veh"]["dropped"] > 50 and r["veh"]["truncated"] > 10
    assert r["veh"]["bursts"] > 10
    sent_ok = r["veh"]["sent"] - r["veh"]["dropped"]
    assert r["rx_total"] > 0.85 * sent_ok, (r["rx_total"], sent_ok)
    assert r["rx_final"] > 100
