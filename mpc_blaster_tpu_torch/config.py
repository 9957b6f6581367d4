"""Presets and solver configuration: `mpc_blaster_tpu.config`, re-exported.
That module uses only numpy and dataclasses, so the port and the JAX
package share one source of every constant, `deployed_solver` included
("safe" and "fast": cold one-launch fused ticks; "fastest": the
3-iteration shifted primal-recentred warm chain under the divergence
watchdog, run with `make_closed_loop(..., warm_start=True)`)."""
from mpc_blaster_tpu.config import *  # noqa: F401,F403
