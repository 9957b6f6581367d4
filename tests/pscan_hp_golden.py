"""The unsharded results (`mesh=None`) of the port's pscan solves and of
its Riccati IPM in every mode, kept in `tests/golden/pscan_hp_mesh_none.npz`
so that `tests/test_torch_pscan_hp.py` can hold `mesh=None` bit for bit to
the code before the horizon sharding was added.

`cases()` computes them with the port found on `sys.path`. The golden file
was written by running this script from the tree before the change, with
one torch thread (as the tests run):

    PYTHONPATH=<that tree> python tests/pscan_hp_golden.py <out.npz>

This file imports no JAX.
"""
import sys

import numpy as np
import torch

GOLDEN = "pscan_hp_mesh_none.npz"
MODES = ("scan", "pscan", "hybrid", "sqrt")
ITERS = 8


def random_qp(N, nx, nu, seed, bound_scale):
    """tests/test_qp.py::random_qp's draws, as numpy."""
    rng = np.random.default_rng(seed)
    A = rng.uniform(-0.5, 0.5, (N, nx, nx)) + np.eye(nx) * 0.8
    B = rng.uniform(-0.5, 0.5, (N, nx, nu))
    c = rng.uniform(-0.1, 0.1, (N, nx))

    def spd(n, scale):
        M = rng.uniform(-1, 1, (n, n))
        return M @ M.T + scale * np.eye(n)
    Q = np.stack([spd(nx, 1.0) for _ in range(N + 1)])
    R = np.stack([spd(nu, 1.0) for _ in range(N)])
    q = rng.uniform(-1, 1, (N + 1, nx))
    r = rng.uniform(-1, 1, (N, nu))
    dx0 = rng.uniform(-0.3, 0.3, nx)
    return dict(A=A, B=B, c=c, Q=Q, q=q, R=R, r=r,
                lbx=np.full((N + 1, nx), -bound_scale),
                ubx=np.full((N + 1, nx), bound_scale),
                lbu=np.full((N, nu), -bound_scale),
                ubu=np.full((N, nu), bound_scale), dx0=dx0)


def cases(call_kw=None) -> dict:
    """Every result as numpy, by name. `call_kw` (e.g. {"mesh": None}) is
    passed to each call; the tree before the change takes none."""
    from mpc_blaster_tpu_torch.convert import qp_from_numpy
    from mpc_blaster_tpu_torch.qp.ipm import box_qp_solve, warm_start_from
    from mpc_blaster_tpu_torch.qp.pscan import (eqp_solve_pscan,
                                                lqr_solve_pscan,
                                                riccati_factorize_pscan,
                                                riccati_solve_rhs_pscan)
    kw = call_kw or {}
    cpu = torch.device("cpu")
    out = {}
    for dtype in (torch.float64, torch.float32):
        tag = str(dtype).split(".")[-1]
        free = qp_from_numpy(random_qp(16, 4, 2, 3, np.inf), dtype=dtype,
                             device=cpu)
        d = free
        out[f"lqr_{tag}"] = lqr_solve_pscan(d, 1e-10, **kw)
        out[f"eqp_{tag}"] = eqp_solve_pscan(d.A, d.B, d.c, d.Q, d.q, d.R,
                                            d.r, d.dx0, 1e-10, **kw)
        fac = riccati_factorize_pscan(d.A, d.B, d.Q, d.R, 1e-10, **kw)
        out[f"factor_{tag}"] = fac
        out[f"solve_{tag}"] = riccati_solve_rhs_pscan(
            fac, d.A, d.B, d.c, d.q, d.r, d.dx0, **kw)
        box = qp_from_numpy(random_qp(16, 4, 2, 4, 0.3), dtype=dtype,
                            device=cpu)
        for mode in MODES:
            cold = box_qp_solve(box, iters=ITERS, riccati=mode, **kw)
            out[f"box_{mode}_cold_{tag}"] = cold
            out[f"box_{mode}_warm_{tag}"] = box_qp_solve(
                box, iters=ITERS, riccati=mode,
                warm=warm_start_from(cold, shift=True), **kw)
    flat = {}
    for name, res in out.items():
        fields = getattr(res, "_fields", None) or range(len(res))
        for f, v in zip(fields, res):
            if isinstance(v, torch.Tensor):
                flat[f"{name}.{f}"] = v.numpy()
    return flat


if __name__ == "__main__":
    torch.set_num_threads(1)
    np.savez_compressed(sys.argv[1], **cases())
