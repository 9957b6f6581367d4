"""Deployment profiles demo of the PyTorch port: the latency/quality
trade-offs by name, plus the PX4-wire flight shell, as
`examples/deployed_profiles_demo.py` runs them on the JAX package.

Profiles (`config.deployed_solver`; the simulation preset at N=20):

  safe     cold 6-iteration one-launch fused ticks
  fast     cold 4-iteration fused ticks
  fastest  3-iteration shifted primal warm chain under the online
           divergence watchdog (`sqp/rti.py::rti_step_warm_guarded`: a
           tick whose diagnostics jump is recomputed cold and the chain
           held cold with escalating holds)

On the card each profile runs as deployed, one launch of the IPM kernel a
tick (`qp_backend="pallas_fused"`; "fastest" adds the watchdog's redo
launch). On the CPU the kernel's plain twin is slow, so there the demo
swaps in the eager Riccati IPM and the jacfwd linearizer (the same
algorithm), as the JAX demo does off the TPU. The timed loops of these
profiles are chip_smoke.py's phases 6-8 (PERF.md).

Then the same controller drives the PX4-byte-compatible flight shell over
a UDP loopback in MAVLink 2.

Run on the card:  python examples/torch_deployed_profiles_demo.py
Run on the CPU:   python examples/torch_deployed_profiles_demo.py --device cpu
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
from mpc_blaster_tpu_torch.io.flight import FlightNode  # noqa: E402
from mpc_blaster_tpu_torch.io.transport import (  # noqa: E402
    UdpAttitudeAdapter, UdpEndpoint)
from mpc_blaster_tpu_torch.ocp.spec import build_spec  # noqa: E402
from mpc_blaster_tpu_torch.sim.closedloop import make_closed_loop  # noqa: E402


def main(device=None):
    dev = resolve_device(device)
    t0 = time.perf_counter()
    dtype = torch.float32
    preset = cfg.simulation_preset()
    ocp = dataclasses.replace(preset.ocp, N=20, Tf=20 / 30.0)
    spec = build_spec(ocp, yref=preset.loop.yref, dtype=dtype, device=dev)
    x0 = torch.zeros(cfg.NX, dtype=dtype, device=dev)
    x0[2] = 0.5  # 3 m altitude step

    out = {}
    for profile in ("safe", "fast", "fastest"):
        solver = cfg.deployed_solver(profile)
        if dev.type != "cuda":
            solver = dataclasses.replace(solver, qp_backend="riccati",
                                         lin_backend="jacfwd")
        ocp_p = dataclasses.replace(ocp, solver=solver)
        run = make_closed_loop(ocp_p, 150, dtype=dtype,
                               warm_start=solver.warm_shift)
        res = run(spec, x0)
        xs = res.xs.cpu().numpy()
        z = xs[:, 2]
        out[profile] = {
            "iters": solver.ipm_iters,
            "warm": bool(solver.warm_shift),
            "backend": solver.qp_backend,
            "overshoot_m": round(float(max(z.max() - 3.5, 0.0)), 4),
            "settle_err_m": round(float(abs(z[100:] - 3.5).max()), 4),
            "finite": bool(np.isfinite(xs).all()),
        }
        print(f"{profile}: {out[profile]}", flush=True)

    # The same controller drives the PX4-byte-compatible flight shell:
    endpoint = UdpEndpoint(wire="mavlink2").start()
    adapter = UdpAttitudeAdapter(("127.0.0.1", endpoint.port),
                                 recv_port=0, wire="mavlink2")
    try:
        node = FlightNode(dtype=torch.float64, adapter=adapter, device=dev)
        node.run(n_steps=5)
        time.sleep(0.3)
        out["mavlink_frames"] = len(endpoint.received)
        print(f"PX4-wire loopback: {len(endpoint.received)} "
              f"SET_ATTITUDE_TARGET frames received, "
              f"{endpoint.bad_frames} bad")
    finally:
        adapter.close()
        endpoint.stop()
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
