"""Port of `mpc_blaster_tpu.ocp`."""
from mpc_blaster_tpu_torch.ocp.spec import OCPSpec, build_spec  # noqa: F401
from mpc_blaster_tpu_torch.ocp.terminal import (  # noqa: F401
    lqr_terminal_weight,
)
