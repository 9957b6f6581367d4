"""Port of `mpc_blaster_tpu.poc`."""
from mpc_blaster_tpu_torch.poc.jet import (  # noqa: F401
    jet_init_conditions,
    jet_state,
)
from mpc_blaster_tpu_torch.poc.solver import (  # noqa: F401
    PocSolver,
    poc_jacobians,
    solve_poc,
    time_of_impact,
)
