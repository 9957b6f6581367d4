"""The port's multi-process glue (`mpc_blaster_tpu_torch/parallel/
distributed.py`): tests/test_distributed.py's cases. The single-process
forms, and a real two-process run: this file's own `__main__` is started
twice as a gloo rank (two CPU shards each, four in all), each rank runs
the sharded tick on its half of a 16-scenario batch, and the reductions
(`dist.all_reduce`) must give both ranks the same numbers, equal to the
global mean and max of the same tick run on the whole batch in the test's
process (float32: rtol 1e-6 on the mean, which sums in another order;
the max exactly).

This file imports no JAX: the worker ranks run it as a script.
"""
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch_threads import one_intraop_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
DEV = torch.device("cpu")
B_GLOBAL = 16


def _problem():
    import dataclasses
    from mpc_blaster_tpu_torch import config as cfg
    from mpc_blaster_tpu_torch.ocp.spec import build_spec
    pre = cfg.simulation_preset()
    ocp = dataclasses.replace(pre.ocp, N=8, Tf=8 / 30.0)
    spec = build_spec(ocp, yref=pre.loop.yref, dtype=torch.float32,
                      device=DEV)
    rng = np.random.default_rng(0)
    x0s = np.zeros((B_GLOBAL, cfg.NX), dtype=np.float32)
    x0s[:, 0:3] = rng.uniform(-0.3, 0.3, (B_GLOBAL, 3))
    x0s[:, 2] += 2.0
    return ocp, spec, x0s


def test_initialize_single_process_noop():
    from mpc_blaster_tpu_torch.parallel.distributed import initialize
    assert initialize(num_processes=1) is False
    assert not torch.distributed.is_initialized()


def test_initialize_needs_an_address(monkeypatch):
    """No address and none in the environment: it raises, there is no
    quiet single-process fallback."""
    from mpc_blaster_tpu_torch.parallel.distributed import initialize
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    with pytest.raises(ValueError, match="coordinator_address"):
        initialize(num_processes=2, process_id=0, device="cpu")


def test_global_mesh_covers_this_rank():
    from mpc_blaster_tpu_torch.parallel.distributed import global_mesh
    mesh = global_mesh(device="cpu")
    assert mesh.devices == (DEV,) and mesh.axis_names == ("dp",)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='device="cpu"'):
            global_mesh()


def test_host_local_batch():
    from mpc_blaster_tpu_torch.parallel.distributed import host_local_batch
    assert host_local_batch(64) == 64      # one process


def test_make_global_array_roundtrip():
    from mpc_blaster_tpu_torch.parallel.distributed import (
        global_mesh, make_global_array)
    data = np.arange(4 * 3, dtype=np.float32).reshape(4, 3)
    local, n = make_global_array(data, global_mesh(device="cpu"))
    assert local.device == DEV and n == 4
    np.testing.assert_array_equal(local.numpy(), data)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_sharded_rti():
    """Two gloo ranks, one sharded tick: the reductions cross the process
    boundary (both ranks see the same values, the global ones), the local
    controls differ (each rank solved its own scenarios)."""
    from mpc_blaster_tpu_torch.parallel.mesh import batched_rti_step
    from mpc_blaster_tpu_torch.sqp.rti import init_rti_state
    coord = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ, PYTHONPATH=str(REPO) + os.pathsep
               + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, __file__, coord, "2",
                               str(pid)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, env=env)
             for pid in range(2)]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {pid} failed:\n{out[-3000:]}"
    res = []
    for out in outs:
        lines = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
        assert lines, out[-2000:]
        res.append(json.loads(lines[-1][len("RESULT "):]))
    r0, r1 = sorted(res, key=lambda r: r["rank"])
    assert r0["world"] == r1["world"] == 2
    assert r0["distributed"] and r1["distributed"]
    assert r0["finite"] and r1["finite"]
    assert r0["mean_step"] == r1["mean_step"]
    assert r0["worst_kkt"] == r1["worst_kkt"]
    assert abs(r0["local_u0_mean"] - r1["local_u0_mean"]) > 1e-6
    # the global reductions of the same tick on the whole batch here
    ocp, spec, x0s = _problem()
    x0s = torch.as_tensor(x0s)
    _, _, diag = batched_rti_step(ocp, device=DEV)(
        spec, init_rti_state(ocp, x0s), x0s)
    assert r0["mean_step"] == pytest.approx(float(diag.step_norm_u.mean()),
                                            rel=1e-6)
    assert r0["worst_kkt"] == float(diag.qp_kkt_stat.max())


def _rank_main(coordinator: str, world: int, rank: int):
    """One gloo rank of `test_two_process_sharded_rti`: two CPU shards,
    this rank's half of the scenario batch, one sharded tick."""
    import torch.distributed as dist
    from mpc_blaster_tpu_torch.parallel.distributed import (
        host_local_batch, initialize, make_global_array)
    from mpc_blaster_tpu_torch.parallel.mesh import (make_mesh,
                                                     sharded_rti_step)
    from mpc_blaster_tpu_torch.sqp.rti import init_rti_state
    ok = initialize(coordinator, world, rank, device="cpu")
    ocp, spec, x0s_all = _problem()
    b = host_local_batch(B_GLOBAL)
    mesh = make_mesh(2, device="cpu")
    x0s, n_global = make_global_array(x0s_all[rank * b:(rank + 1) * b], mesh)
    assert n_global == B_GLOBAL
    u0s, states, mean_step, worst_kkt = sharded_rti_step(ocp, mesh)(
        spec, init_rti_state(ocp, x0s), x0s)
    print("RESULT " + json.dumps({
        "rank": dist.get_rank(), "world": dist.get_world_size(),
        "distributed": ok, "mean_step": float(mean_step),
        "worst_kkt": float(worst_kkt),
        "local_u0_mean": float(u0s.mean()),
        "finite": bool(torch.isfinite(u0s).all()
                       & torch.isfinite(states.xbar).all())}), flush=True)
    dist.destroy_process_group()


if __name__ == "__main__":
    _rank_main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]))
