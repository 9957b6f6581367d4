"""Port of `mpc_blaster_tpu.parallel` (the batched ticks on one device;
`make_mesh`, `sharded_rti_step` and `sharded_sweep` are ROADMAP queue 1
step 7)."""
from mpc_blaster_tpu_torch.parallel.mesh import (  # noqa: F401
    batched_rti_step,
    batched_rti_step_per_scenario_spec,
)
