"""Port of `mpc_blaster_tpu.parallel`: the batched ticks, the mesh and the
sharded tick and sweep (`mesh.py`), the process-group glue
(`distributed.py`)."""
from mpc_blaster_tpu_torch.parallel.mesh import (  # noqa: F401
    batched_rti_step,
    batched_rti_step_per_scenario_spec,
    make_mesh,
    sharded_rti_step,
    sharded_sweep,
)
