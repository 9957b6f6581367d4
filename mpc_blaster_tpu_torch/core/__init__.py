"""Port of `mpc_blaster_tpu.core`."""
from mpc_blaster_tpu_torch.core import htm as htm  # noqa: F401
from mpc_blaster_tpu_torch.core import rotations as rotations  # noqa: F401
