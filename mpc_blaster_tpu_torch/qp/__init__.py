"""Port of `mpc_blaster_tpu.qp`."""
from mpc_blaster_tpu_torch.qp.data import QPData, QPSolution  # noqa: F401
from mpc_blaster_tpu_torch.qp.riccati import lqr_solve  # noqa: F401
from mpc_blaster_tpu_torch.qp.ipm import (  # noqa: F401
    IpmWarmStart,
    box_qp_solve,
    warm_start_from,
)
from mpc_blaster_tpu_torch.qp.pscan import lqr_solve_pscan  # noqa: F401
from mpc_blaster_tpu_torch.qp.soft import (  # noqa: F401
    SoftBounds,
    SoftPenalty,
    SoftQPSolution,
    soft_box_qp_solve,
)
