"""Presets and solver configuration: `mpc_blaster_tpu.config`, re-exported
unchanged. That module uses only numpy and dataclasses, so the port and
the JAX package share one source of every constant."""
from mpc_blaster_tpu.config import *  # noqa: F401,F403
