"""Build-sanity smoke run: `python -m mpc_blaster_tpu_torch [--device cpu]`.

Parity with the reference's `python blastermodel.py` (`blastermodel.py:294-318`)
and with `python -m mpc_blaster_tpu`: construct the smoke-preset model +
controller, run one RTI tick (the preset's eager Riccati IPM), and print
the body rotation at a sample attitude (the reference prints the symbolic
R). It runs on the CUDA card unless `--device` names another device; on a
machine without a card a bare call exits non-zero and says how to ask for
the CPU (`device.py`).
"""
import argparse
import sys

import torch

from mpc_blaster_tpu_torch import config as cfg
from mpc_blaster_tpu_torch.core.rotations import euler_zyx_to_rot
from mpc_blaster_tpu_torch.device import resolve_device
from mpc_blaster_tpu_torch.ocp.spec import build_spec
from mpc_blaster_tpu_torch.sqp.rti import init_rti_state, make_rti_step


def main(device=None):
    dev = resolve_device(device)
    preset = cfg.smoke_preset()
    ocp = preset.ocp
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"blaster-tpu-mpc smoke build: N={ocp.N} Tf={ocp.Tf} "
          f"mass={ocp.model.mass} on {dev} ({name})")
    spec = build_spec(ocp, device=dev)
    step = make_rti_step(ocp, device=dev)
    x0 = torch.zeros(cfg.NX, device=dev)
    x0[2] = 1.0
    state = init_rti_state(ocp, x0)
    u0, state, diag = step(spec, state, x0)
    print("one RTI tick: u0 =", u0.cpu().numpy().round(4),
          " qp_eq = %.2e" % float(diag.qp_kkt_eq))
    R = euler_zyx_to_rot(torch.tensor([0.1, -0.2, 0.3], device=dev))
    print("R(0.1, -0.2, 0.3) =\n", R.cpu().numpy().round(5))


if __name__ == "__main__":
    ap = argparse.ArgumentParser(prog="python -m mpc_blaster_tpu_torch",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device to run on (default: the CUDA card)")
    args = ap.parse_args()
    try:
        dev = resolve_device(args.device)
    except RuntimeError as e:
        sys.exit(f"python -m mpc_blaster_tpu_torch: {e}")
    main(dev)
