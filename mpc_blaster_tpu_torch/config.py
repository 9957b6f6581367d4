"""Presets and solver configuration: `mpc_blaster_tpu.config`, re-exported.
That module uses only numpy and dataclasses, so the port and the JAX
package share one source of every constant. One name is wrapped:
`deployed_solver` refuses the "fastest" profile, whose guarded warm chain
is not ported yet."""
from mpc_blaster_tpu import config as _ref
from mpc_blaster_tpu.config import *  # noqa: F401,F403


def deployed_solver(profile: str = "safe") -> SolverConfig:  # noqa: F405
    """`mpc_blaster_tpu.config.deployed_solver` for the ported profiles:
    "safe" (cold, 6 iterations) and "fast" (cold, 4 iterations), both the
    one-launch fused tick (`qp_backend="pallas_fused"`,
    `lin_backend="fused"`)."""
    if profile == "fastest":
        raise NotImplementedError(
            "deployed_solver('fastest') (a shifted warm chain with the "
            "divergence watchdog) is not ported yet; ROADMAP queue 1 item 9 "
            "and queue 2 K3 (warm-start kernel) port it")
    return _ref.deployed_solver(profile)
