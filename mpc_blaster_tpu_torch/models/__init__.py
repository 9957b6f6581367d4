"""Port of `mpc_blaster_tpu.models`."""
from mpc_blaster_tpu_torch.models.quad13 import (  # noqa: F401
    QUAD13_NU,
    QUAD13_NX,
    Quad13Config,
    build_quad13_spec,
    init_quad13_rti_state,
    quad13_ode,
)
