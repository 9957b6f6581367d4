"""Port of `mpc_blaster_tpu.ops`: the launch wrappers of the port's own
kernels (`csrc/`) and their plain twins. The JAX package exports the
Pallas entry point `pallas_box_qp_solve`; its counterpart here is
`box_qp_solve`. Importing this package builds nothing and does not
initialise CUDA: each library is compiled at its first launch."""
from mpc_blaster_tpu_torch.ops.box_qp_ipm import (  # noqa: F401
    batched_fused_tick,
    batched_fused_tick_plain,
    box_qp_solve,
    box_qp_solve_plain,
    fused_rti_solve,
    fused_rti_solve_plain,
    kernel_info,
    launch_plan,
)
from mpc_blaster_tpu_torch.ops.probes import (  # noqa: F401
    fma_chain,
    fma_chain_plain,
    smem_capacity,
    smem_capacity_plain,
)
