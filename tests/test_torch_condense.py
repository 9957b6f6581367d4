"""Port parity of partial condensing (`mpc_blaster_tpu_torch/qp/
condense.py`) against the JAX package in float64: tests/test_condense.py's
random-QP cases on the same numpy inputs (the blaster QP and the closed
loops are in tests/test_torch_condense_loop.py).

Tolerances: the condensed QP's fields and the block maps run the JAX
arithmetic operation for operation: 1e-12. Solves where the arithmetic is
the same and the answer well determined: du within 1e-8 of the JAX
solve. The active-bound case at M=2 is weakly determined (degenerate
interior rows: the JAX test's own note) and is held to the JAX test's
tolerance, du within 1e-3 (measured 2.3e-7 between the packages). Against
the full-horizon solvers the JAX test's tolerances are kept (2e-6, 1e-3,
the objective at rel 1e-5, the KKT check at 5e-4); M=1 equals the port's
`box_qp_solve` within 1e-12.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mpc_blaster_tpu.qp import condense as jc
from mpc_blaster_tpu.qp import riccati as jric
from mpc_blaster_tpu_torch.convert import qp_from_numpy
from mpc_blaster_tpu_torch.qp.condense import (condense, condensed_qp_solve,
                                               expand)
from mpc_blaster_tpu_torch.qp.data import QPData, qp_objective
from mpc_blaster_tpu_torch.qp.ipm import box_qp_solve
from mpc_blaster_tpu_torch.qp.riccati import lqr_solve
from test_qp import _check_box_kkt, random_qp
from torch_threads import one_intraop_thread  # noqa: F401

DEV = torch.device("cpu")


def _t(jd):
    return qp_from_numpy({k: np.asarray(v) for k, v in jd._asdict().items()},
                         dtype=torch.float64, device=DEV)


def _jsolve(jd, M, iters, **kw):
    return jax.jit(lambda d: jc.condensed_qp_solve(d, M=M, iters=iters,
                                                   **kw))(jd)


def _close(a, b, atol, err_msg=""):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0,
                               atol=atol, err_msg=err_msg)


def test_block_maps_reproduce_dynamics():
    jd = random_qp(N=12, nx=4, nu=2, seed=11)
    d = _t(jd)
    cqp = condense(d, M=3)
    jcqp = jax.jit(jc.condense, static_argnums=1)(jd, 3)
    for f in cqp._fields:
        a, b = getattr(cqp, f).numpy(), np.asarray(getattr(jcqp, f))
        fin = np.isfinite(b)
        assert (np.isfinite(a) == fin).all(), f
        _close(np.where(fin, a, 0.0), np.where(fin, b, 0.0), 1e-12, f)
    rng = np.random.default_rng(0)
    dX = torch.as_tensor(rng.uniform(-1, 1, (cqp.ncond + 1, 4)))
    dU = torch.as_tensor(rng.uniform(-1, 1, (cqp.ncond, 6)))
    dx, du = expand(cqp, dX, dU)
    jdx, jdu = jax.jit(jc.expand)(jcqp, jnp.asarray(dX.numpy()),
                                  jnp.asarray(dU.numpy()))
    _close(dx, jdx, 1e-12)
    _close(du, jdu, 1e-12)
    # the interiors from the maps against a plain rollout of A, B, c from
    # each block-start state, and the block end by the condensed dynamics
    for j in range(cqp.ncond):
        x = dX[j]
        for i in range(3):
            k = 3 * j + i
            _close(dx[k], x, 1e-12)
            x = d.A[k] @ x + d.B[k] @ du[k] + d.c[k]
        end = cqp.Abar[j] @ dX[j] + cqp.Bbar[j] @ dU[j] + cqp.cbar[j]
        _close(end, x, 1e-12)


def test_condensed_cost_exact():
    """The condensed objective equals the original one on dynamics-
    consistent trajectories up to one constant."""
    jd = random_qp(N=8, nx=4, nu=2, seed=12)
    d = _t(jd)
    cqp = condense(d, M=4)

    def cond_obj(dX, dU):
        return (0.5 * torch.einsum("ci,cij,cj->", dX, cqp.Qbar, dX)
                + (cqp.qbar * dX).sum()
                + 0.5 * torch.einsum("ci,cij,cj->", dU, cqp.Rbar, dU)
                + (cqp.rbar * dU).sum()
                + torch.einsum("ci,cij,cj->", dU, cqp.Sbar, dX[:-1]))

    rng = np.random.default_rng(1)
    offs = []
    for _ in range(2):
        dU = torch.as_tensor(rng.uniform(-1, 1, (cqp.ncond, 8)))
        dXs = [d.dx0]
        for j in range(cqp.ncond):
            dXs.append(cqp.Abar[j] @ dXs[-1] + cqp.Bbar[j] @ dU[j]
                       + cqp.cbar[j])
        dX = torch.stack(dXs)
        dx, du = expand(cqp, dX, dU)
        offs.append(float(qp_objective(d, dx, du)) - float(cond_obj(dX, dU)))
    assert offs[0] == pytest.approx(offs[1], abs=1e-9)


def test_condensed_equality_only_matches_riccati():
    """M=2 (even split), 3 (ragged tail), 6 (coarse) against the Riccati
    solve (2e-6), and M=3 against the JAX condensed solve (1e-8)."""
    jd = random_qp(N=12, nx=5, nu=3, seed=13)
    d = _t(jd)
    ref = lqr_solve(d)
    _close(ref.du, jric.lqr_solve(jd).du, 1e-10)
    for M in (2, 3, 6):
        sol = condensed_qp_solve(d, M=M, iters=25)
        _close(sol.du, ref.du, 2e-6, f"M={M}")
        if M == 3:
            _close(sol.du, _jsolve(jd, 3, 25).du, 1e-8)


@pytest.mark.parametrize("M", [2, 4])
def test_condensed_matches_full_ipm_active_bounds(M):
    jd = random_qp(N=8, nx=5, nu=3, seed=14)
    free = jric.lqr_solve(jd)
    lim = 0.4 * float(jnp.max(jnp.abs(free.du)))
    xlim = 0.6 * float(jnp.max(jnp.abs(free.dx[1:])))
    jd = jd._replace(lbu=jnp.full_like(jd.lbu, -lim),
                     ubu=jnp.full_like(jd.ubu, lim),
                     lbx=jnp.full_like(jd.lbx, -xlim),
                     ubx=jnp.full_like(jd.ubx, xlim))
    d = _t(jd)
    ref = box_qp_solve(d, iters=30)
    sol = condensed_qp_solve(d, M=M, iters=30)
    # interior state bounds really are active
    on_bound = np.isclose(np.abs(sol.dx[1:].numpy()), xlim, atol=1e-5)
    interior = np.ones(d.horizon, bool)
    interior[M - 1::M] = False
    assert on_bound[interior].any(), "no interior state bound active"
    _close(sol.du, ref.du, 1e-3)
    assert float(qp_objective(d, sol.dx, sol.du)) == pytest.approx(
        float(qp_objective(d, ref.dx, ref.du)), rel=1e-5, abs=1e-6)
    _check_box_kkt(jd, sol._replace(**{
        k: getattr(sol, k).numpy() for k in ("dx", "du", "lam_lx", "lam_ux",
                                             "lam_lu", "lam_uu")}), tol=5e-4)
    js = _jsolve(jd, M, 30)
    _close(sol.du, js.du, 1e-3 if M == 2 else 1e-8)
    assert float(qp_objective(d, sol.dx, sol.du)) == pytest.approx(
        float(qp_objective(d, torch.as_tensor(np.asarray(js.dx)),
                           torch.as_tensor(np.asarray(js.du)))), rel=1e-9)


def test_condensed_vmap_batch():
    """A batch on the leading axis (the JAX test vmaps) equals the single
    solves and the JAX vmapped solve."""
    jds = [random_qp(N=6, nx=4, nu=2, seed=s, bound_scale=1.5)
           for s in range(2)]
    ds = [_t(j) for j in jds]
    stacked = QPData(*(torch.stack(xs) for xs in zip(*ds)))
    out = condensed_qp_solve(stacked, M=3, iters=15)
    jout = jax.jit(jax.vmap(lambda d: jc.condensed_qp_solve(
        d, M=3, iters=15)))(jax.tree.map(lambda *xs: jnp.stack(xs), *jds))
    for i, d in enumerate(ds):
        _close(out.du[i], condensed_qp_solve(d, M=3, iters=15).du, 1e-8)
    _close(out.du, jout.du, 1e-8)
    _close(out.kkt_eq, jout.kkt_eq, 1e-10)


def test_condensed_m1_identical_to_full_ipm():
    """M=1 (no interior stages) reproduces `box_qp_solve`: the same
    iteration, fraction-to-boundary and best-iterate selection."""
    jd = random_qp(N=6, nx=4, nu=2, seed=21)
    free = jric.lqr_solve(jd)
    lim = 0.4 * float(jnp.max(jnp.abs(free.du)))
    jd = jd._replace(lbu=jnp.full_like(jd.lbu, -lim),
                     ubu=jnp.full_like(jd.ubu, lim),
                     lbx=jnp.full_like(jd.lbx, -2.0),
                     ubx=jnp.full_like(jd.ubx, 2.0))
    d = _t(jd)
    ref = box_qp_solve(d, iters=20)
    sol = condensed_qp_solve(d, M=1, iters=20, refine=0)
    _close(sol.du, ref.du, 1e-12)
    _close(sol.dx, ref.dx, 1e-12)
