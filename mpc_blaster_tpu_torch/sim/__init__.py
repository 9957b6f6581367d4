"""Port of `mpc_blaster_tpu.sim`."""
from mpc_blaster_tpu_torch.sim.closedloop import (  # noqa: F401
    ClosedLoopResult,
    closed_loop,
    make_closed_loop,
    run_preset,
)
from mpc_blaster_tpu_torch.sim.tasks import (  # noqa: F401
    run_blasting,
    run_figure8,
)
from mpc_blaster_tpu_torch.sim.scenarios import (  # noqa: F401
    disturbance_sweep,
    sample_scenarios,
)
