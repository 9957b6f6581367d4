"""The port's endurance mission (`mpc_blaster_tpu_torch/io/endurance.py`)
on the CPU: the SITL-lite vehicle and the telemetry ingest in their own
processes, byte-level MAVLink 2 over UDP with seeded link faults, and the
port's `OffsetFreeFlightController` on the eager Riccati IPM ticking at
10 Hz under the native `RateLoop` (tests/test_endurance.py's mission).

tests/test_endurance.py:396-407's functional criteria hold here: frames
flow through the faults, the 100 Hz loops run all their ticks, no NaNs.
Its work bound (`worst_work_s < 0.5` inside the 100 ms slot) is asserted
on the card by chip_smoke.py's phase 23, not here: one eager CPU tick of
the mission's controller takes ~160 ms on an idle core (the JAX package
jit-compiles it to a few ms) and the tier-1 load multiplies that.
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
    disturbance estimate are not asserted: on the CPU the eager tick
    overruns its slot, so the vehicle flies on stale setpoints."""
    r = run_mission(60.0, mission_ocp("riccati"), device=DEV)
    _assert_functional(r, 60.0)
    assert r["veh"]["dropped"] > 50 and r["veh"]["truncated"] > 10
    assert r["veh"]["bursts"] > 10
    sent_ok = r["veh"]["sent"] - r["veh"]["dropped"]
    assert r["rx_total"] > 0.85 * sent_ok, (r["rx_total"], sent_ok)
    assert r["rx_final"] > 100
