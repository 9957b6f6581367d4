"""Port of `mpc_blaster_tpu.dynamics`."""
from mpc_blaster_tpu_torch.dynamics.blaster import (  # noqa: F401
    BlasterParams,
    blaster_ode,
    pack_stage_params,
    unpack_stage_params,
)
from mpc_blaster_tpu_torch.dynamics.fastlin import (  # noqa: F401
    fast_linearize,
    make_fused_linearizer,
)
from mpc_blaster_tpu_torch.dynamics.integrators import (  # noqa: F401
    discrete_dynamics,
    discrete_jacobians,
    erk_integrate,
    rk4_step,
    rollout,
)
