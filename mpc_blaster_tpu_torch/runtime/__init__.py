"""Port of `mpc_blaster_tpu.runtime`: the native C++ runtime (host code),
built at first use, not at import."""
from mpc_blaster_tpu_torch.runtime.bindings import (  # noqa: F401
    NativeQPSolver,
    PoseRingBuffer,
    RateLoop,
    load_native,
    native_available,
)
