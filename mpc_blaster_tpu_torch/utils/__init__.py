"""Port of `mpc_blaster_tpu.utils`: solve statistics, timers and profiler
traces, device timing, checkpoints."""
from mpc_blaster_tpu_torch.utils.metrics import SolveStats, summarize  # noqa: F401
from mpc_blaster_tpu_torch.utils.profiling import Timer, trace  # noqa: F401
from mpc_blaster_tpu_torch.utils.checkpoint import (  # noqa: F401
    load_pytree,
    save_pytree,
)
