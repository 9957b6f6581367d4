"""Flagship demo of the PyTorch port: descend-while-washing with TRUE-POC
accounting, as `examples/blast_scan_demo.py` runs it on the JAX package.

The quadrotor descends from 3.5 m to 1.5 m while the water jet traces a
figure-8 on the ground. Three controller configurations:

  reference-config : POC Jacobians frozen at the canonical pose AND the
                     POC belief propagated by that same linearization —
                     exactly the reference's `simulation_blaster.py`
                     behavior (Jacobians solved once before the loop,
                     `:37-39`; plant == model). Its *belief* tracks at
                     mm level while the TRUE impact point drifts.
  anchored         : per-tick nonlinear POC evaluation (closed-form jet
                     solve at the live pose) replaces the drifting belief.
  online+anchored  : additionally re-linearizes dPOC/d(alpha,euler,p) at
                     the live pose every tick.

On the card the loops run in float32 on the one-launch IPM kernel
(`qp_backend="pallas_fused"`, 12 iterations, as chip_smoke.py's phase 19
runs the blast rows); on the CPU in float64 on the simulation preset's
eager Riccati IPM, as the JAX demo runs off the TPU. Writes the figure to
`--out` (default `blast_scan_torch.png` in the working directory; where
matplotlib is not installed it says so and writes none) and prints a
JSON summary.

Run on the card:  python examples/torch_blast_scan_demo.py
Run on the CPU:   python examples/torch_blast_scan_demo.py --device cpu
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
from mpc_blaster_tpu_torch.poc.solver import true_poc_traj  # noqa: E402
from mpc_blaster_tpu_torch.sim.tasks import run_blast_scan  # noqa: E402


def main(out="blast_scan_torch.png", device=None):
    dev = resolve_device(device)
    t0 = time.perf_counter()
    preset = cfg.simulation_preset()
    if dev.type == "cuda":
        dtype = torch.float32
        preset = dataclasses.replace(preset, ocp=dataclasses.replace(
            preset.ocp, solver=dataclasses.replace(
                preset.ocp.solver, qp_backend="pallas_fused")))
    else:
        dtype = torch.float64
    # 1260 ticks = 42 s = one full lemniscate period after the descent
    kw = dict(n_steps=1260, dtype=dtype, z_end=1.5, t_ramp_s=6.0,
              device=dev)
    configs = {
        "reference-config": dict(poc_mode="frozen", plant_poc="linear",
                                 frozen_at="canonical"),
        "anchored": dict(poc_mode="frozen", plant_poc="exact",
                         frozen_at="canonical"),
        "online+anchored": dict(poc_mode="online", plant_poc="exact"),
    }
    results, summary = {}, {}
    for label, c in configs.items():
        res = run_blast_scan(preset, **c, **kw)
        results[label] = res
        tp = true_poc_traj(res.xs).cpu().numpy()
        xs, refs = res.xs.cpu().numpy(), res.refs.cpu().numpy()
        terr = np.linalg.norm(tp[1:, 0:2] - refs[:, 14:16], axis=1)
        berr = np.linalg.norm(xs[1:, 14:16] - refs[:, 14:16], axis=1)
        summary[label] = {
            "true_poc_err_mean_m": round(float(terr[90:].mean()), 4),
            "true_poc_err_max_m": round(float(terr[90:].max()), 4),
            "believed_err_mean_m": round(float(berr[90:].mean()), 4),
        }
        print(f"{label}: {summary[label]}", flush=True)

    try:  # the figure needs matplotlib, which a card's host may lack
        from mpc_blaster_tpu_torch.sim.plots import plot_blast_scan
    except ModuleNotFoundError as e:
        print(f"no figure written ({e})", file=sys.stderr)
    else:
        plot_blast_scan(results, path=os.path.abspath(out), settle=90)
    summary["improvement_x"] = round(
        summary["reference-config"]["true_poc_err_mean_m"]
        / summary["anchored"]["true_poc_err_mean_m"], 1)
    print(json.dumps(summary))
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"device: {dev} ({name}); wall {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--out", default="blast_scan_torch.png",
                    help="where to write the figure")
    args = ap.parse_args()
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        sys.exit(f"{sys.argv[0]}: {e}")
    main(args.out, device)
