"""Port of `mpc_blaster_tpu.io`: the flight I/O shell."""
from mpc_blaster_tpu_torch.io.flight import (  # noqa: F401
    AttitudeTarget,
    CollectAdapter,
    FlightNode,
    thruster_cumul,
)
from mpc_blaster_tpu_torch.io.telemetry import PoseProbe, PoseSample  # noqa: F401
