"""Port parity of the horizon-parallel LQR (`mpc_blaster_tpu_torch/qp/
pscan.py`) and the IPM's "pscan" / "hybrid" modes against the sequential
Riccati recursion and the JAX package: tests/test_pscan.py's cases on the
same numpy inputs, plus the port's own log-depth scan against a
sequential fold.

Tolerances: tests/test_pscan.py's own (the scan's summation order differs
from both the sequential sweep and XLA's odd/even recursion, so results
agree to rounding, not bit for bit): solves rtol 1e-7 / atol 1e-8, the
factor/solve split rtol 1e-6, the IPM modes du rtol 1e-3 / atol 5e-4
with the objective at rtol 1e-5. The scan against a fold, and the
scanned KKT residuals against the sequential ones: 1e-12 (f64).
N=64 runs here on one device; tests/test_torch_pscan_hp.py runs it with
the stage axis sharded, as the JAX test does.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mpc_blaster_tpu.qp import ipm as jipm
from mpc_blaster_tpu.qp import pscan as jps
from mpc_blaster_tpu.qp import riccati as jric
from mpc_blaster_tpu.qp.data import qp_objective as jobjective
from mpc_blaster_tpu_torch.convert import qp_from_numpy
from mpc_blaster_tpu_torch.qp import ipm as tipm
from mpc_blaster_tpu_torch.qp.data import qp_objective
from mpc_blaster_tpu_torch.qp.ipm import box_qp_solve
from mpc_blaster_tpu_torch.qp.pscan import (associative_scan,
                                            backward_pass_pscan,
                                            lqr_solve_pscan,
                                            riccati_factorize_pscan,
                                            riccati_solve_rhs_pscan)
from mpc_blaster_tpu_torch.qp.riccati import (lqr_solve, riccati_factorize,
                                              riccati_solve_rhs)
from test_qp import random_qp
from torch_threads import one_intraop_thread  # noqa: F401

DEV = torch.device("cpu")


def _t(jd):
    return qp_from_numpy({k: np.asarray(v) for k, v in jd._asdict().items()},
                         dtype=torch.float64, device=DEV)


_JIT_LQR = jax.jit(jps.lqr_solve_pscan)


def _free(N=16, nx=5, nu=3, seed=0):
    return random_qp(N=N, nx=nx, nu=nu, seed=seed, bound_scale=np.inf)


def _close(a, b, rtol, atol):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pscan_matches_riccati(seed):
    jd = _free(seed=seed)
    d = _t(jd)
    sol_par, sol_seq = lqr_solve_pscan(d), lqr_solve(d)
    _close(sol_par.du, sol_seq.du, 1e-7, 1e-8)
    _close(sol_par.dx, sol_seq.dx, 1e-7, 1e-8)
    jsol = _JIT_LQR(jd)
    _close(sol_par.du, jsol.du, 1e-7, 1e-8)
    _close(sol_par.dx, jsol.dx, 1e-7, 1e-8)


def test_pscan_value_functions_match():
    jd = _free(seed=3)
    d = _t(jd)
    P, p = backward_pass_pscan(d.A, d.B, d.c, d.Q, d.q, d.R, d.r)
    _close(P, riccati_factorize(d.A, d.B, d.Q, d.R).P, 1e-7, 1e-8)
    jP, jp = jax.jit(jps.backward_pass_pscan)(jd.A, jd.B, jd.c, jd.Q, jd.q,
                                              jd.R, jd.r)
    _close(P, jP, 1e-7, 1e-8)
    _close(p, jp, 1e-7, 1e-8)


def test_pscan_factor_solve_split_matches_sequential():
    """One factorization, two right-hand sides (the Mehrotra pattern), and
    the pscan solve against the sequential factor (the "hybrid" mode)."""
    jd = _free(seed=7)
    d = _t(jd)
    fac_seq = riccati_factorize(d.A, d.B, d.Q, d.R, reg=1e-10)
    fac_par = riccati_factorize_pscan(d.A, d.B, d.Q, d.R, reg=1e-10)
    _close(fac_par.P, fac_seq.P, 1e-7, 1e-8)
    _close(fac_par.K, fac_seq.K, 1e-6, 1e-8)
    jfac = jax.jit(lambda *a: jps.riccati_factorize_pscan(*a, reg=1e-10))(
        jd.A, jd.B, jd.Q, jd.R)
    _close(fac_par.K, jfac.K, 1e-6, 1e-8)
    rng = np.random.default_rng(11)
    for _ in range(2):
        q2 = torch.as_tensor(rng.normal(size=d.q.shape))
        r2 = torch.as_tensor(rng.normal(size=d.r.shape))
        dx_seq, du_seq = riccati_solve_rhs(fac_seq, d.A, d.B, d.c, q2, r2,
                                           d.dx0)
        dx_par, du_par = riccati_solve_rhs_pscan(fac_par, d.A, d.B, d.c, q2,
                                                 r2, d.dx0)
        _close(du_par, du_seq, 1e-6, 1e-8)
        _close(dx_par, dx_seq, 1e-6, 1e-8)
        _, du_h = riccati_solve_rhs_pscan(fac_seq, d.A, d.B, d.c, q2, r2,
                                          d.dx0)
        _close(du_h, du_seq, 1e-6, 1e-8)
        _, jdu = jax.jit(jps.riccati_solve_rhs_pscan)(
            jfac, jd.A, jd.B, jd.c, jnp.asarray(q2.numpy()),
            jnp.asarray(r2.numpy()), jd.dx0)
        _close(du_par, jdu, 1e-6, 1e-8)


@pytest.mark.parametrize("backend", ["pscan", "hybrid"])
def test_ipm_riccati_backends_match_scan(backend):
    """box_qp_solve(riccati=...) agrees with the sequential mode on an
    actively constrained QP at control grade, on the objective tighter,
    and with the JAX package's same mode."""
    jd = random_qp(N=12, nx=5, nu=3, seed=9, bound_scale=0.3)
    d = _t(jd)
    ref = box_qp_solve(d, iters=20)
    sol = box_qp_solve(d, iters=20, riccati=backend)
    _close(sol.du, ref.du, 1e-3, 5e-4)
    assert float(sol.kkt_eq) < 1e-4
    _close(float(qp_objective(d, sol.dx, sol.du)),
           float(qp_objective(d, ref.dx, ref.du)), 1e-5, 1e-7)
    js = jax.jit(lambda q: jipm.box_qp_solve(q, iters=20,
                                             riccati=backend))(jd)
    _close(sol.du, js.du, 1e-3, 5e-4)
    _close(float(qp_objective(d, sol.dx, sol.du)),
           float(jobjective(jd, js.dx, js.du)), 1e-5, 1e-7)


def test_ipm_riccati_backend_validated():
    with pytest.raises(ValueError, match="riccati"):
        box_qp_solve(_t(_free(seed=0)), riccati="pscam")


def test_pscan_long_horizon_one_device():
    """tests/test_pscan.py's N=64 QP on one device (the JAX test shards
    the stage axis over a mesh; the port's sharded run of it is
    tests/test_torch_pscan_hp.py::test_lqr_pscan_hp_matches_jax_sharded)."""
    jd = _free(N=64, nx=4, nu=2, seed=5)
    d = _t(jd)
    sol = lqr_solve_pscan(d)
    _close(sol.du, lqr_solve(d).du, 1e-6, 1e-7)
    _close(sol.du, jric.lqr_solve(jd).du, 1e-6, 1e-7)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("n", [1, 2, 3, 5, 60, 64])
def test_associative_scan_matches_fold(n, reverse):
    """The port's log-depth scan of random affine maps x -> F x + g equals
    the sequential fold, forward and reversed, at lengths that are and are
    not powers of two; a batch axis in front of the scanned one is
    carried."""
    rng = np.random.default_rng(n + 100 * reverse)
    F = torch.as_tensor(rng.uniform(-0.6, 0.6, (2, n, 3, 3)))
    g = torch.as_tensor(rng.normal(size=(2, n, 3)))

    def compose(m1, m2):          # m2 after m1
        return m2[0] @ m1[0], (m2[0] @ m1[1][..., None])[..., 0] + m2[1]

    fn = (lambda a, b: compose(b, a)) if reverse else compose
    Fs, gs = associative_scan(fn, (F, g), reverse=reverse, dim=1)
    order = range(n - 1, -1, -1) if reverse else range(n)
    acc = None
    for k in order:
        m = (F[:, k], g[:, k])
        # a suffix adds the earlier element first, a prefix the later last
        acc = m if acc is None else (compose(m, acc) if reverse
                                     else compose(acc, m))
        torch.testing.assert_close(Fs[:, k], acc[0], rtol=0, atol=1e-12)
        torch.testing.assert_close(gs[:, k], acc[1], rtol=0, atol=1e-12)


def test_kkt_residuals_pscan_matches_scan():
    """The merit's adjoint recursion as a suffix scan equals the
    sequential one and the JAX package's scanned one on an IPM iterate
    with active bounds (f64)."""
    jd = random_qp(N=12, nx=5, nu=3, seed=9, bound_scale=0.3)
    d = _t(jd)
    rng = np.random.default_rng(4)

    def rnd(*shape):
        return rng.uniform(0.0, 1.0, shape)
    N, nx, nu = d.horizon, d.nx, d.nu
    st = tipm._IpmState(
        dx=torch.as_tensor(rng.normal(size=(N + 1, nx))),
        du=torch.as_tensor(rng.normal(size=(N, nu))),
        s_lx=torch.as_tensor(rnd(N, nx)), s_ux=torch.as_tensor(rnd(N, nx)),
        lam_lx=torch.as_tensor(rnd(N, nx)),
        lam_ux=torch.as_tensor(rnd(N, nx)),
        s_lu=torch.as_tensor(rnd(N, nu)), s_uu=torch.as_tensor(rnd(N, nu)),
        lam_lu=torch.as_tensor(rnd(N, nu)),
        lam_uu=torch.as_tensor(rnd(N, nu)))
    masks = (torch.isfinite(d.lbx[1:]), torch.isfinite(d.ubx[1:]),
             torch.isfinite(d.lbu), torch.isfinite(d.ubu))
    seq = tipm._kkt_residuals(d, st, *masks)
    par = tipm._kkt_residuals_pscan(d, st, *masks)
    jst = jipm._IpmState(*(jnp.asarray(x.numpy()) for x in st))
    jpar = jax.jit(jipm._kkt_residuals_pscan)(
        jd, jst, *(jnp.asarray(m.numpy()) for m in masks))
    for a, b, c in zip(seq, par, jpar):
        assert abs(float(a) - float(b)) <= 1e-12 * max(1.0, abs(float(a)))
        assert abs(float(b) - float(c)) <= 1e-12 * max(1.0, abs(float(c)))
