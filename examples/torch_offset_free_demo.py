"""Offset-free deployment demo of the PyTorch port, as
`examples/offset_free_demo.py` runs it on the JAX package: constant wind
the controller cannot see, learned online by the force+torque observer,
compensated through the "blaster_dist" prediction model (the disturbance
estimates ride stage-parameter rows 25:31 as *data*).

On the card the loop runs at full kernel fusion (`qp_backend=
"pallas_fused"`: the RK4 linearization of the disturbance-augmented
model runs inside the IPM kernel, one launch a tick); on the CPU on the
eager Riccati IPM, as the JAX demo runs everywhere. The simulation preset
at N=30, inside its stable envelope (the JAX package's r5 finding: N=20
hunts, N >= 24 settles to millimetres with the preset's weights).

The reference flight node has no state feedback at all (it integrates its
own model open-loop, `mavros_blaster_sim.py:109-118`); this is the
capability gap that matters most in real wind.

Run on the card:  python examples/torch_offset_free_demo.py
Run on the CPU:   python examples/torch_offset_free_demo.py --device cpu
"""
import argparse
import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from mpc_blaster_tpu_torch import config as cfg  # noqa: E402
from mpc_blaster_tpu_torch.device import resolve_device  # noqa: E402
from mpc_blaster_tpu_torch.ocp.spec import build_spec  # noqa: E402
from mpc_blaster_tpu_torch.sim.scenarios import offset_free_loop  # noqa: E402


def main(device=None):
    dev = resolve_device(device)
    t0 = time.perf_counter()
    preset = cfg.simulation_preset()
    n = 30
    wind = torch.tensor([0.7, -0.5, 0.2], device=dev)  # m/s^2, unseen
    x0 = torch.zeros(cfg.NX, device=dev)
    x0[2] = 3.0
    out = {}

    backend = "pallas_fused" if dev.type == "cuda" else "riccati"
    ocp = dataclasses.replace(
        preset.ocp, N=n, Tf=n / 30.0,
        solver=dataclasses.replace(preset.ocp.solver, qp_backend=backend,
                                   ipm_iters=8))
    spec = build_spec(ocp, yref=preset.loop.yref, dtype=torch.float32,
                      device=dev)
    target = spec.yref_x[0, 0:3].cpu().numpy()
    for name, gain in (("blind", 0.0), ("offset_free", 0.5)):
        res = offset_free_loop(spec, ocp, x0, wind, n_steps=250,
                               observer_gain=gain)
        xs = res.xs.cpu().numpy()
        err = float(np.linalg.norm(xs[-1, 0:3] - target))
        out[name] = {
            "final_pos_err_m": round(err, 4),
            "wind_estimate": [round(float(v), 3)
                              for v in res.d_hist[-1, 0:3].tolist()],
            "finite": bool(np.isfinite(xs).all()),
        }
        print(f"{name}: settle err {err:.3f} m, "
              f"d_est {out[name]['wind_estimate']}", flush=True)

    # the observer must beat the blind loop by a wide margin
    if not (out["offset_free"]["final_pos_err_m"]
            < 0.2 * out["blind"]["final_pos_err_m"]):
        raise SystemExit(f"the observer did not beat the blind loop: {out}")
    out["backend"] = backend
    print(json.dumps(out))
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"device: {dev} ({name}); wall {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    try:
        device = resolve_device(ap.parse_args().device)
    except RuntimeError as e:
        sys.exit(f"{sys.argv[0]}: {e}")
    main(device)
