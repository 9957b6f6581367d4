"""mpc_blaster_tpu_torch — the PyTorch + CUDA (NVIDIA Hopper) port of
`mpc_blaster_tpu`.

The JAX package beside it stays the reference; every module here keeps
its counterpart's name and subpackage so a reader finds one from the
other. Plain tensor code is eager PyTorch; the TPU kernel on the slice's
path (the Pallas box-QP IPM, `mpc_blaster_tpu/ops/pallas_ipm.py`, in its
plain, fuse_cost and fuse_lin modes) is a hand-written CUDA C++ kernel
for sm_90a (`csrc/box_qp_ipm.cu`, wrapped by `ops/box_qp_ipm.py`).

Ported so far (the cold RTI ticks and closed loop with
`qp_backend="pallas"` or the deployed one-launch `"pallas_fused"`):

  - ``core``      rotations, nozzle homogeneous-transform chain
  - ``dynamics``  the 17-state BLASTER ODE, RK4, jacfwd sensitivities,
                  the component-form linearizer (`fastlin`)
  - ``poc``       water-jet point-of-contact solve + Jacobians
  - ``ocp``       OCP specification and cost
  - ``qp``        QP data containers
  - ``ops``       the box-QP IPM kernel's three modes, their plain twins
                  and launch wrappers
  - ``sqp``       the SQP-RTI tick
  - ``sim``       the closed loop (cold, frozen-POC branch)
  - ``parallel``  the batched ticks on one device
  - ``convert``   numpy <-> port containers (state shared with the JAX side)

Options outside that slice raise `NotImplementedError` naming the
ROADMAP item that ports them. Presets are `mpc_blaster_tpu.config`,
re-exported (numpy + dataclasses only; it imports no JAX), with
`deployed_solver("fastest")` refused until its warm chain is ported.

float32 matrix products run in full float32: TF32 (10-bit mantissa) is
switched off at import, the Hopper form of the reduced-precision matmul
trap that broke the QP on the TPU (its bf16 matmul passes).
"""
import torch

from mpc_blaster_tpu_torch import config as config  # noqa: F401

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
