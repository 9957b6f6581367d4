"""Port of `mpc_blaster_tpu.sqp`."""
from mpc_blaster_tpu_torch.sqp.rti import (  # noqa: F401
    RTIState,
    init_rti_state,
    make_rti_step,
    rti_step,
)
