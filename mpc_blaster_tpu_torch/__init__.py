"""mpc_blaster_tpu_torch — the PyTorch + CUDA (NVIDIA Hopper) port of
`mpc_blaster_tpu`.

The JAX package beside it stays the reference; every module here keeps
its counterpart's name and subpackage so a reader finds one from the
other. Plain tensor code is eager PyTorch; the TPU kernel on the slice's
path (the Pallas box-QP IPM, `mpc_blaster_tpu/ops/pallas_ipm.py`, in its
plain, fuse_cost and fuse_lin modes, cold or warm-started, soft-bounded
in the plain and fuse_lin modes, for the 17x6 BLASTER and the 13x4 quad13
models, at any horizon) is a hand-written CUDA C++ kernel for sm_90a
(`csrc/box_qp_ipm.cu`, wrapped by `ops/box_qp_ipm.py`).

Ported (the RTI ticks and closed loop, cold, warm-started or
soft-bounded, on the presets' default `qp_backend="riccati"`, on `"pallas"`
and on the deployed one-launch `"pallas_fused"`, with the divergence
watchdog; the batched ticks on the "xla", "pallas" and "pallas_fused"
backends; the quad13 model; the offset-free loop and figure-8 tracking):

  - ``core``      rotations, nozzle homogeneous-transform chain
  - ``dynamics``  the 17-state BLASTER ODE, RK4, jacfwd sensitivities,
                  the component-form linearizer (`fastlin`)
  - ``poc``       water-jet point-of-contact solve + Jacobians
  - ``models``    the 13-state quaternion quadrotor (`quad13`)
  - ``ocp``       OCP specification and cost, the DARE terminal weight
  - ``qp``        QP data containers, the small-matrix algebra, the Riccati
                  recursion (sequential, log-depth `pscan`, square-root
                  `sqrt_riccati`), the Riccati IPM with its warm starts,
                  the soft-bounded IPM (`soft`) and partial condensing
                  (`condense`)
  - ``ops``       the box-QP IPM kernel's three modes (each with the
                  warm-start blend; plain and fuse_lin with soft bounds),
                  their plain twins and launch wrappers
  - ``sqp``       the SQP-RTI ticks: cold, warm, warm under the watchdog,
                  soft-bounded
  - ``sim``       the closed loop, the scenario draws and sweeps, the
                  offset-free loop, figure-8 tracking, the blasting task
                  and the blast scan, the plots
  - ``parallel``  the batched ticks, the mesh and the sharded tick and
                  sweep, the `torch.distributed` process group
  - ``utils``     solve statistics, timers and profiler traces, device
                  timing, checkpoints
  - ``io``        the flight I/O shell: the flight node and its adapters,
                  the UDP transport (framed and MAVLink 1/2), the MAVLink
                  codec, the pose probes, the endurance-mission harness
                  (SITL-lite vehicle, faulty link, offset-free controller)
  - ``runtime``   the native C++ runtime (host code: the CPU box-QP IPM,
                  the fixed-rate loop, the lock-free pose ring), built
                  with g++ at first use into the git-ignored `build/`
  - ``convert``   numpy <-> port containers (state shared with the JAX side)

`python -m mpc_blaster_tpu_torch [--device cpu]` is the build-sanity CLI;
`examples/torch_*.py` are the JAX package's examples on the port. An
option the port lacks raises `NotImplementedError` naming the ROADMAP
item that ports it. Presets are the port's own copy of
`mpc_blaster_tpu.config` (`config.py`): the port imports nothing of the
JAX package.

float32 matrix products run in full float32: TF32 (10-bit mantissa) is
switched off at import, the Hopper form of the reduced-precision matmul
trap that broke the QP on the TPU (its bf16 matmul passes).
"""
import torch

from mpc_blaster_tpu_torch import config as config  # noqa: F401

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
