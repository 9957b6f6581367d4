"""Quickstart of the PyTorch port: the three reference workflows + two
beyond-reference ones, as `examples/quickstart.py` runs them on the JAX
package.

Run on the card:  python examples/torch_quickstart.py
Run on the CPU:   python examples/torch_quickstart.py --device cpu

Every loop here keeps the presets' own QP backend, the eager Riccati IPM
(`qp_backend="riccati"`): no kernel runs, and each tick is hundreds of
small launches, so the whole run takes minutes (PERF.md records its wall
time on the card).
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from mpc_blaster_tpu_torch import config as cfg  # noqa: E402
from mpc_blaster_tpu_torch.device import resolve_device  # noqa: E402
from mpc_blaster_tpu_torch.io.flight import FlightNode  # noqa: E402
from mpc_blaster_tpu_torch.ocp.spec import build_spec  # noqa: E402
from mpc_blaster_tpu_torch.poc.solver import PocSolver  # noqa: E402
from mpc_blaster_tpu_torch.sim.closedloop import run_preset  # noqa: E402
from mpc_blaster_tpu_torch.sim.scenarios import (  # noqa: E402
    disturbance_sweep, sample_scenarios)
from mpc_blaster_tpu_torch.sim.tasks import run_figure8  # noqa: E402


def main(device=None):
    dev = resolve_device(device)
    t0 = time.perf_counter()
    # 1. The jet POC solve (Jacobian_POC_Solver.py workflow; float64 on
    # the host)
    solver = PocSolver(150.0, 1.0).initialise()
    j_mot, j_eul, j_pos = solver.get_jacobians()
    print("POC:", np.asarray(solver.poc).round(4),
          "impact T:", float(solver.time_of_impact))

    # 2. The offline closed-loop sim (simulation_blaster.py workflow)
    res = run_preset(cfg.simulation_preset(), n_steps=120, with_poc=True,
                     device=dev)
    print("sim preset: z(end) = %.3f (target 3.5), worst QP eq residual %.1e"
          % (float(res.xs[-1, 2]), float(res.kkt_eq.max())))

    # 3. The flight node (mavros_blaster_sim.py workflow, ROS-free)
    node = FlightNode(device=dev)
    node.run(n_steps=10)
    print("flight node: %d AttitudeTarget msgs, final thrust setpoint %.3f"
          % (len(node.adapter.messages), node.adapter.messages[-1].thrust))

    # 4. Beyond reference: figure-8 waypoint tracking
    trk = run_figure8(n_steps=120, device=dev)
    err = np.linalg.norm(trk.xs.cpu().numpy()[1:, 0:2]
                         - trk.refs.cpu().numpy()[:, 0:2], axis=1)
    print("figure-8: worst xy tracking error after settle = %.3f m"
          % err[40:].max())

    # 5. Beyond reference: wind-disturbance robustness sweep
    preset = cfg.simulation_preset()
    spec = build_spec(preset.ocp, yref=preset.loop.yref, device=dev)
    scen = sample_scenarios(batch=8, seed=0, wind_max=0.8, device=dev)
    sweep = disturbance_sweep(spec, preset.ocp, scen, n_steps=100)
    print("wind sweep: %d/%d scenarios settled within 25 cm, max err %.3f m"
          % (int(sweep.settled.sum()), 8, float(sweep.pos_err.max())))

    # 6. Beyond reference: offset-free MPC (disturbance observer) — the
    # same sweep with the velocity-residual observer feeding the
    # prediction model.
    sweep_of = disturbance_sweep(spec, preset.ocp, scen, n_steps=150,
                                 offset_free=True)
    print("wind sweep (offset-free): %d/%d settled, max err %.3f m"
          % (int(sweep_of.settled.sum()), 8, float(sweep_of.pos_err.max())))
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
