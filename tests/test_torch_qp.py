"""Port parity of the Riccati QP layer (`mpc_blaster_tpu_torch/qp/`:
`smallalg.py`, `riccati.py`, `ipm.py`) against the JAX package in float64:
the JAX package's tests/test_qp.py cases (Riccati vs the dense KKT
system, inactive and active bounds, the scipy reference, a batch) run
through both packages on the same numpy inputs, plus the small-matrix
inverses on SPD, indefinite and tiny-pivot inputs.

Tolerances: float64 throughout. The port runs the JAX algorithm operation
for operation (sums over a column in one reduction instead of a chain), so
single solves agree to rounding: 1e-10 absolute on solutions of O(1)
(measured <= 1.2e-16 on these inputs). The dense-KKT, KKT-condition and
scipy checks keep tests/test_qp.py's own tolerances.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mpc_blaster_tpu.qp import ipm as jipm
from mpc_blaster_tpu.qp import riccati as jric
from mpc_blaster_tpu.qp import smallalg as jsa
from mpc_blaster_tpu.qp.data import qp_objective
from mpc_blaster_tpu_torch.convert import qp_from_numpy
from mpc_blaster_tpu_torch.qp import smallalg
from mpc_blaster_tpu_torch.qp.ipm import box_qp_solve
from mpc_blaster_tpu_torch.qp.riccati import lqr_kkt_residuals, lqr_solve
from test_qp import _check_box_kkt, dense_equality_solve, random_qp
from torch_threads import one_intraop_thread  # noqa: F401

# The port runs on the CUDA card unless asked for the CPU; these tests
# ask for it.
DEV = torch.device("cpu")

ATOL = 1e-10


def _t(jd):
    """The port's float64 QPData from a JAX one."""
    return qp_from_numpy({k: np.asarray(v) for k, v in jd._asdict().items()},
                         dtype=torch.float64, device=DEV)


def _close(t, j, atol=ATOL, err_msg=""):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=atol,
                               err_msg=err_msg)


def _active_box(data, frac, xbox):
    """tests/test_qp.py's active-bound construction: control boxes at
    `frac` of the unconstrained optimum's largest |du|."""
    lim = frac * float(jnp.max(jnp.abs(jric.lqr_solve(data).du)))
    return data._replace(lbu=jnp.full_like(data.lbu, -lim),
                         ubu=jnp.full_like(data.ubu, lim),
                         lbx=jnp.full_like(data.lbx, -xbox),
                         ubx=jnp.full_like(data.ubx, xbox)), lim


def test_riccati_matches_dense_kkt_and_jax():
    data = random_qp(seed=1)
    sol = lqr_solve(_t(data))
    dx_ref, du_ref = dense_equality_solve(data)
    np.testing.assert_allclose(sol.dx.numpy(), dx_ref, rtol=1e-8, atol=1e-9)
    np.testing.assert_allclose(sol.du.numpy(), du_ref, rtol=1e-8, atol=1e-9)
    stat, eq = lqr_kkt_residuals(_t(data), sol.dx, sol.du)
    assert float(stat) < 1e-9 and float(eq) < 1e-9
    ref = jric.lqr_solve(data)
    _close(sol.dx, ref.dx)
    _close(sol.du, ref.du)


def test_ipm_inactive_bounds_matches_riccati():
    data = random_qp(seed=2, bound_scale=1e3)  # bounds never active
    free = lqr_solve(_t(data))
    sol = box_qp_solve(_t(data), iters=20)
    np.testing.assert_allclose(sol.dx.numpy(), free.dx.numpy(), atol=5e-6)
    np.testing.assert_allclose(sol.du.numpy(), free.du.numpy(), atol=5e-6)
    ref = jipm.box_qp_solve(data, iters=20)
    _close(sol.dx, ref.dx)
    _close(sol.du, ref.du)


def test_ipm_active_bounds_kkt():
    data, lim = _active_box(random_qp(seed=3), 0.4, 5.0)
    sol = box_qp_solve(_t(data), iters=30)
    assert float(sol.du.abs().max()) <= lim + 1e-7
    _check_box_kkt(data, sol, tol=2e-5)
    free = lqr_solve(_t(data))
    assert float(qp_objective(data, jnp.asarray(sol.dx.numpy()),
                              jnp.asarray(sol.du.numpy()))) >= \
        float(qp_objective(data, jnp.asarray(free.dx.numpy()),
                           jnp.asarray(free.du.numpy()))) - 1e-9
    ref = jipm.box_qp_solve(data, iters=30)
    for f in ("dx", "du", "lam_lu", "lam_uu", "s_lx", "mu", "kkt_stat",
              "kkt_eq"):
        _close(getattr(sol, f), getattr(ref, f), err_msg=f)


def test_ipm_vs_scipy_reference():
    from scipy.optimize import LinearConstraint, minimize
    data, lim = _active_box(random_qp(N=4, nx=3, nu=2, seed=5), 0.5, 3.0)
    sol = box_qp_solve(_t(data), iters=30)
    N, nx, nu = data.horizon, data.nx, data.nu
    nz, off = (N + 1) * nx + N * nu, (N + 1) * nx

    def obj(z):
        return float(qp_objective(data, jnp.asarray(z[:off].reshape(N + 1,
                                                                    nx)),
                                  jnp.asarray(z[off:].reshape(N, nu))))

    E = np.zeros(((N + 1) * nx, nz))
    h = np.zeros((N + 1) * nx)
    E[:nx, :nx] = np.eye(nx)
    h[:nx] = np.asarray(data.dx0)
    for k in range(N):
        row = (k + 1) * nx
        E[row:row + nx, (k + 1) * nx:(k + 2) * nx] = np.eye(nx)
        E[row:row + nx, k * nx:(k + 1) * nx] = -np.asarray(data.A[k])
        E[row:row + nx, off + k * nu:off + (k + 1) * nu] = \
            -np.asarray(data.B[k])
        h[row:row + nx] = np.asarray(data.c[k])
    lb = np.r_[np.full(nx, -np.inf), np.full(N * nx, -3.0),
               np.full(N * nu, -lim)]
    ub = np.r_[np.full(nx, np.inf), np.full(N * nx, 3.0), np.full(N * nu, lim)]
    z0 = np.zeros(nz)
    z0[:nx] = np.asarray(data.dx0)
    res = minimize(obj, z0, method="SLSQP", bounds=list(zip(lb, ub)),
                   constraints=[LinearConstraint(E, h, h)],
                   options={"maxiter": 500, "ftol": 1e-12})
    assert res.success
    ours = float(qp_objective(data, jnp.asarray(sol.dx.numpy()),
                              jnp.asarray(sol.du.numpy())))
    assert ours == pytest.approx(res.fun, abs=1e-5, rel=1e-6)


def test_ipm_batch():
    """Leading batch axes are vectorised: the batched solve is each
    problem's own solve (1e-12) and JAX's vmapped solve (1e-10)."""
    datas = [random_qp(seed=s, bound_scale=2.0) for s in range(4)]
    stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *datas)
    sols = box_qp_solve(_t(stacked), iters=15)
    assert sols.du.shape == (4, 8, 3) and sols.kkt_eq.shape == (4,)
    for i, d in enumerate(datas):
        one = box_qp_solve(_t(d), iters=15)
        _close(sols.du[i], one.du.numpy(), atol=1e-12)
        _close(sols.mu[i], one.mu.numpy(), atol=1e-12)
    ref = jax.vmap(lambda d: jipm.box_qp_solve(d, iters=15))(stacked)
    _close(sols.du, ref.du)
    _close(sols.kkt_eq, ref.kkt_eq)


def test_ipm_float32_floors_match_jax():
    """float32 selects the dtype floors (mu_min 1e-7, reg 1e-6, sigma and
    lambda caps 1e7): the port's f32 solve follows JAX's to f32 rounding
    (measured 6.6e-7 on du; bound 1e-4)."""
    data, _ = _active_box(random_qp(seed=3), 0.4, 5.0)
    d32 = jax.tree.map(lambda a: a.astype(jnp.float32), data)
    t32 = qp_from_numpy({k: np.asarray(v) for k, v in d32._asdict().items()},
                        device=DEV)
    sol = box_qp_solve(t32, iters=15)
    ref = jipm.box_qp_solve(d32, iters=15)
    assert sol.du.dtype == torch.float32
    _close(sol.du, ref.du, atol=1e-4)
    assert float(sol.kkt_eq) < 1e-5


def _spd_cases(case, n, dtype):
    rng = np.random.default_rng(11 + n)
    G = rng.normal(size=(4, n, n))
    M = G @ np.swapaxes(G, -1, -2) + np.diag(np.logspace(-5, 7, n))
    if case == "indefinite":
        M[:, 2, 2] = -1.0
    elif case == "tiny_pivot":
        # exactly singular after equilibration: the second pivot is 0
        M = np.tile(2.0 * np.eye(n), (4, 1, 1))
        M[:, 0, 1] = M[:, 1, 0] = 2.0
    return M.astype(dtype)


@pytest.mark.parametrize("n", [6, 12])
@pytest.mark.parametrize("case", ["spd", "indefinite", "tiny_pivot"])
def test_inverses_match_jax(case, n):
    """chol_inverse and spd_inverse (the Schur recursion above n=8) against
    the JAX package in float64, relative to each matrix's largest inverse
    entry (1e-8: condition numbers up to ~1e12 after the spread diagonal);
    chol_inverse returns the zero sentinel on indefinite or singular
    input, and chol_factor reproduces M on SPD input."""
    M = _spd_cases(case, n, np.float64)
    for port, ref in ((smallalg.chol_inverse, jsa.chol_inverse),
                      (smallalg.spd_inverse, jsa.spd_inverse)):
        out = port(torch.as_tensor(M)).numpy()
        want = np.asarray(ref(jnp.asarray(M)))
        scale = np.abs(want).max(axis=(-1, -2), keepdims=True) + 1e-30
        np.testing.assert_allclose(out / scale, want / scale, rtol=0,
                                   atol=1e-8, err_msg=port.__name__)
    if case != "spd" and n <= 8:
        assert (smallalg.chol_inverse(torch.as_tensor(M)) == 0).all()
    if case == "spd":
        L = smallalg.chol_factor(torch.as_tensor(M))
        np.testing.assert_allclose(L.numpy(), np.asarray(
            jsa.chol_factor(jnp.asarray(M))), rtol=1e-10, atol=1e-10)
        assert torch.allclose(L @ L.transpose(-1, -2), torch.as_tensor(M),
                              rtol=1e-10, atol=1e-10)


def test_ipm_refusals():
    """Every inner solver of the JAX package runs (since the pscan and sqrt
    cores were ported; tests/test_torch_pscan.py and
    test_torch_sqrt_riccati.py hold them to the JAX package) and agrees
    with "scan" on this unconstrained QP within 1e-8; an unknown one is
    refused with ValueError, not switched."""
    td = _t(random_qp(seed=2))
    ref = box_qp_solve(td)
    for mode in ("pscan", "hybrid", "sqrt"):
        sol = box_qp_solve(td, riccati=mode)
        assert torch.allclose(sol.du, ref.du, rtol=0, atol=1e-8), mode
    with pytest.raises(ValueError, match="riccati"):
        box_qp_solve(td, riccati="dense")
