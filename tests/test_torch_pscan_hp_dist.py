"""Horizon sharding across processes: this file's own `__main__` is
started twice as a gloo rank, each with a 4-chunk "hp" mesh of CPU
shards and its own contiguous half of the stages of one QP (rank 0
stages 0-31 and dx0, rank 1 stages 32-63 and the terminal state; its dx0
is zeros, which the solve must not read). Each rank runs `lqr_solve_pscan`
and `box_qp_solve(riccati="pscan")`, cold and warm. Each rank's stages
must equal the same stages of the one-process solve over the same eight
chunks (bit for bit: the ranks exchange exactly what the chunks of one
process exchange, and every rank reduces the gathered list as one
process does), and the scalars must be the same on both ranks.

This file imports no JAX: the worker ranks run it as a script.
"""
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch
from torch_threads import one_intraop_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
DEV = torch.device("cpu")
N, HALF, CHUNKS = 64, 32, 4
ITERS = 12


def _qps():
    from mpc_blaster_tpu_torch.convert import qp_from_numpy
    from pscan_hp_golden import random_qp
    return (qp_from_numpy(random_qp(N, 4, 2, 5, np.inf), dtype=torch.float64,
                          device=DEV),
            qp_from_numpy(random_qp(N, 4, 2, 6, 0.3), dtype=torch.float64,
                          device=DEV))


def _warm(box):
    from mpc_blaster_tpu_torch.qp.ipm import box_qp_solve, warm_start_from
    return warm_start_from(box_qp_solve(box, iters=ITERS, riccati="pscan"),
                           shift=True)


STATE_FIELDS = ("Q", "q", "lbx", "ubx")
X_SLACKS = ("s_lx", "s_ux", "lam_lx", "lam_ux")


def _rank_part(qp, rank):
    """Rank `rank`'s stages of a whole QP (and dx0 only on rank 0)."""
    lo, hi = rank * HALF, (rank + 1) * HALF
    return qp._replace(**{
        f: getattr(qp, f)[lo:hi + (rank == 1 and f in STATE_FIELDS)]
        for f in qp._fields if f != "dx0"},
        dx0=qp.dx0 if rank == 0 else torch.zeros_like(qp.dx0))


def _rank_warm(w, rank):
    """Rank `rank`'s rows of a warm start: the state slacks are indexed by
    states 1..N, so rank 0 holds states 1-31 and rank 1 states 32-64."""
    def part(f, x):
        if f == "valid":
            return x
        if f in X_SLACKS:
            return x[:HALF - 1] if rank == 0 else x[HALF - 1:]
        return x[rank * HALF:(rank + 1) * HALF]
    return w._replace(**{f: part(f, getattr(w, f)) for f in w._fields})


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _solutions(sols):
    return {name: {f: (v.tolist() if v.dim() else float(v))
                   for f, v in zip(s._fields, s)
                   if isinstance(v, torch.Tensor) and v.is_floating_point()}
            for name, s in sols.items()}


def test_two_ranks_shard_the_horizon():
    from mpc_blaster_tpu_torch.parallel.mesh import make_mesh
    from mpc_blaster_tpu_torch.qp.ipm import box_qp_solve
    from mpc_blaster_tpu_torch.qp.pscan import lqr_solve_pscan
    coord = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO), str(REPO / "tests"), os.environ.get("PYTHONPATH", "")]),
        OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, __file__, coord, str(rank)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, env=env)
             for rank in range(2)]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{out[-3000:]}"
    res = {}
    for out in outs:
        lines = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
        assert lines, out[-2000:]
        r = json.loads(lines[-1][len("RESULT "):])
        res[r["rank"]] = r
    assert res[0]["world"] == res[1]["world"] == 2

    # the same eight chunks in one process
    lqr_qp, box = _qps()
    mesh = make_mesh(2 * CHUNKS, axis="hp", device="cpu")
    w = _warm(box)
    one = _solutions({
        "lqr": lqr_solve_pscan(lqr_qp, mesh=mesh),
        "cold": box_qp_solve(box, iters=ITERS, riccati="pscan", mesh=mesh),
        "warm": box_qp_solve(box, iters=ITERS, riccati="pscan", warm=w,
                             mesh=mesh)})
    for name, whole in one.items():
        for f, v in whole.items():
            got = [res[rank]["sols"][name][f] for rank in (0, 1)]
            if isinstance(v, float):
                assert got[0] == got[1] == v, (name, f, got, v)
            else:
                assert got[0] + got[1] == v, (name, f)


def _rank_main(coordinator: str, rank: int):
    """One gloo rank: four CPU chunks, this rank's half of the stages."""
    import torch.distributed as dist
    from mpc_blaster_tpu_torch.parallel.distributed import initialize
    from mpc_blaster_tpu_torch.parallel.mesh import make_mesh
    from mpc_blaster_tpu_torch.qp.ipm import box_qp_solve
    from mpc_blaster_tpu_torch.qp.pscan import lqr_solve_pscan
    torch.set_num_threads(1)
    initialize(coordinator, 2, rank, device="cpu")
    lqr_qp, box = _qps()
    w = _rank_warm(_warm(box), rank)
    mesh = make_mesh(CHUNKS, axis="hp", device="cpu")
    box_r = _rank_part(box, rank)
    sols = {
        "lqr": lqr_solve_pscan(_rank_part(lqr_qp, rank), mesh=mesh),
        "cold": box_qp_solve(box_r, iters=ITERS, riccati="pscan", mesh=mesh),
        "warm": box_qp_solve(box_r, iters=ITERS, riccati="pscan", warm=w,
                             mesh=mesh)}
    print("RESULT " + json.dumps({
        "rank": dist.get_rank(), "world": dist.get_world_size(),
        "sols": _solutions(sols)}), flush=True)
    dist.destroy_process_group()


if __name__ == "__main__":
    _rank_main(sys.argv[1], int(sys.argv[2]))
