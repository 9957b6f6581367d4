"""Port parity of the square-root Riccati core
(`mpc_blaster_tpu_torch/qp/sqrt_riccati.py`, `box_qp_solve(riccati=
"sqrt")`) against the JAX package: tests/test_sqrt_riccati.py's four
cases on the same numpy inputs.

Tolerances: the f64 factor is held as K, Z'Z and the solves (never R
entry by entry: LAPACK may pick other row signs in either package) to the
plain recursion with tests/test_sqrt_riccati.py's bounds (1e-9, P 1e-7)
and to the JAX function at 1e-9; the f64 IPM to the "scan" mode and to
the JAX "sqrt" IPM at 1e-8. The f32 cases keep the JAX test's criteria
(the simulation preset's QP: sqrt's objective gap at most 1.05x scan's,
kkt_eq < 1e-2; the stiff barrier: sqrt within 1e-3 relative of f64,
plain at least 10x worse).
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import torch

from mpc_blaster_tpu.qp import ipm as jipm
from mpc_blaster_tpu.qp import riccati as jric
from mpc_blaster_tpu.qp import sqrt_riccati as jsr
from mpc_blaster_tpu_torch import config as tcfg
from mpc_blaster_tpu_torch.convert import qp_from_numpy
from mpc_blaster_tpu_torch.qp.data import qp_objective
from mpc_blaster_tpu_torch.qp.ipm import box_qp_solve
from mpc_blaster_tpu_torch.qp.riccati import (riccati_factorize,
                                              riccati_solve_rhs)
from mpc_blaster_tpu_torch.qp.smallalg import chol_factor
from mpc_blaster_tpu_torch.qp.sqrt_riccati import (sqrt_factorize,
                                                   sqrt_solve_rhs)
from test_qp import random_qp
from torch_threads import one_intraop_thread  # noqa: F401

DEV = torch.device("cpu")


def _t(jd, dtype=torch.float64):
    return qp_from_numpy({k: np.asarray(v) for k, v in jd._asdict().items()},
                         dtype=dtype, device=DEV)


def _cost_rows(Q, R):
    """Row factors C with C'C = blkdiag(R_k, Q_k) per stage ([u|x] cols)."""
    N, nx, nu = Q.shape[0] - 1, Q.shape[-1], R.shape[-1]
    Lq, Lr = chol_factor(Q[:-1]), chol_factor(R)
    rows_q = torch.cat([Q.new_zeros(N, nx, nu), Lq.mT], -1)
    rows_r = torch.cat([Lr.mT, Q.new_zeros(N, nu, nx)], -1)
    return torch.cat([rows_r, rows_q], -2)


def test_sqrt_matches_plain_riccati_f64():
    jd = random_qp(N=10, nx=5, nu=3, seed=3)
    d = _t(jd)
    C = _cost_rows(d.Q, d.R)
    ZN = chol_factor(d.Q[-1]).mT
    fac_s = sqrt_factorize(d.A, d.B, C, ZN)
    fac_p = riccati_factorize(d.A, d.B, d.Q, d.R)
    torch.testing.assert_close(fac_s.K, fac_p.K, rtol=0, atol=1e-9)
    torch.testing.assert_close(fac_s.Z.mT @ fac_s.Z, fac_p.P, rtol=0,
                               atol=1e-7)
    dx_s, du_s = sqrt_solve_rhs(fac_s, d.A, d.B, d.c, d.q, d.r, d.dx0)
    dx_p, du_p = riccati_solve_rhs(fac_p, d.A, d.B, d.c, d.q, d.r, d.dx0)
    torch.testing.assert_close(du_s, du_p, rtol=0, atol=1e-9)
    torch.testing.assert_close(dx_s, dx_p, rtol=0, atol=1e-9)
    # against the JAX function on the same rows
    jfac = jsr.sqrt_factorize(jd.A, jd.B, jnp.asarray(C.numpy()),
                              jnp.asarray(ZN.numpy()))
    np.testing.assert_allclose(fac_s.K.numpy(), np.asarray(jfac.K), atol=1e-9)
    np.testing.assert_allclose(
        (fac_s.Ruu.mT @ fac_s.Ruu).numpy(),
        np.asarray(jnp.einsum("kji,kjl->kil", jfac.Ruu, jfac.Ruu)),
        rtol=1e-12, atol=1e-9)
    jdx, jdu = jsr.sqrt_solve_rhs(jfac, jd.A, jd.B, jd.c, jd.q, jd.r, jd.dx0)
    np.testing.assert_allclose(du_s.numpy(), np.asarray(jdu), atol=1e-9)
    np.testing.assert_allclose(dx_s.numpy(), np.asarray(jdx), atol=1e-9)


def test_box_qp_sqrt_backend_matches_scan():
    """box_qp_solve(riccati='sqrt') == the default mode in f64, and the
    JAX package's sqrt IPM."""
    jd = random_qp(N=8, nx=4, nu=2, seed=5, bound_scale=1.0)
    d = _t(jd)
    ref = box_qp_solve(d, iters=15)
    sol = box_qp_solve(d, iters=15, riccati="sqrt")
    torch.testing.assert_close(sol.du, ref.du, rtol=0, atol=1e-8)
    torch.testing.assert_close(sol.dx, ref.dx, rtol=0, atol=1e-8)
    js = jax.jit(lambda q: jipm.box_qp_solve(q, iters=15,
                                             riccati="sqrt"))(jd)
    np.testing.assert_allclose(sol.du.numpy(), np.asarray(js.du), atol=1e-8)
    np.testing.assert_allclose(sol.dx.numpy(), np.asarray(js.dx), atol=1e-8)


def test_box_qp_sqrt_backend_f32_accuracy():
    """The simulation preset's cold-transient QP (N=20): the f32 "sqrt"
    mode converges and is no less accurate than "scan" against the f64
    solve (tests/test_sqrt_riccati.py's criteria; the QP built by the
    port equals the JAX package's within 1e-10)."""
    from mpc_blaster_tpu import config as jcfg
    from mpc_blaster_tpu.dynamics.blaster import BlasterParams as JP
    from mpc_blaster_tpu.dynamics.blaster import blaster_ode as jode
    from mpc_blaster_tpu.dynamics.integrators import discrete_dynamics as jdd
    from mpc_blaster_tpu.ocp.spec import build_spec as jbuild_spec
    from mpc_blaster_tpu.sqp.rti import build_qp as jbuild_qp
    from mpc_blaster_tpu.sqp.rti import init_rti_state as jinit
    from mpc_blaster_tpu_torch.dynamics.blaster import (BlasterParams,
                                                        blaster_ode)
    from mpc_blaster_tpu_torch.dynamics.integrators import discrete_dynamics
    from mpc_blaster_tpu_torch.ocp.spec import build_spec
    from mpc_blaster_tpu_torch.sqp.rti import build_qp, init_rti_state

    pre = tcfg.simulation_preset()
    ocp = dataclasses.replace(pre.ocp, N=20, Tf=20 / 30.0)

    def first_qp(dtype):
        x0 = torch.as_tensor(np.asarray(pre.loop.x0), dtype=dtype)
        spec = build_spec(ocp, yref=pre.loop.yref, dtype=dtype, device=DEV)
        params = BlasterParams.from_config(ocp.model, dtype, DEV)
        F = discrete_dynamics(blaster_ode, ocp.dt, num_steps=1)
        return build_qp(spec, init_rti_state(ocp, x0, dtype), x0, F, params)

    qp64, qp32 = first_qp(torch.float64), first_qp(torch.float32)
    jpre = jcfg.simulation_preset()
    jocp = dataclasses.replace(jpre.ocp, N=20, Tf=20 / 30.0)
    jx0 = jnp.asarray(np.asarray(jpre.loop.x0), jnp.float64)
    jqp = jax.jit(jbuild_qp, static_argnums=(3,))(
        jbuild_spec(jocp, yref=jpre.loop.yref, dtype=jnp.float64),
        jinit(jocp, jx0, jnp.float64), jx0, jdd(jode, jocp.dt, num_steps=1),
        JP.from_config(jocp.model, jnp.float64))
    for f in ("A", "B", "c", "Q", "q", "R", "r", "dx0"):
        np.testing.assert_allclose(getattr(qp64, f).numpy(),
                                   np.asarray(getattr(jqp, f)), rtol=0,
                                   atol=1e-10, err_msg=f)
    ref = box_qp_solve(qp64, iters=12)
    o_ref = float(qp_objective(qp64, ref.dx, ref.du))

    def gap(riccati):
        s = box_qp_solve(qp32, iters=12, riccati=riccati)
        o = float(qp_objective(qp64, s.dx.double(), s.du.double()))
        return abs(o - o_ref), float(s.kkt_eq)

    g_scan, _ = gap("scan")
    g_sqrt, eq_sqrt = gap("sqrt")
    assert np.isfinite(g_sqrt)
    assert eq_sqrt < 1e-2
    assert g_sqrt < 1.05 * g_scan, (g_sqrt, g_scan)


def test_sqrt_f32_survives_stiff_barrier():
    """A dense rank-1 barrier row of weight 1e7 (the condensed IPM's
    G' sigma G): the plain recursion loses the Newton solve in f32, the
    sqrt form stays accurate. The f64 plain solve (the reference of the
    JAX test) is itself condition-limited (cond ~1e11, so ~1e-5 relative):
    the two packages' f64 plain solves are held within 1e-4 of |du|
    (measured 1.4e-5), their f64 sqrt solves within 1e-9."""
    rng = np.random.default_rng(7)
    jd = random_qp(N=8, nx=4, nu=2, seed=9)
    d = _t(jd)
    g = rng.normal(size=(8, 2 + 4))
    g = torch.as_tensor(g / np.linalg.norm(g, axis=-1, keepdims=True))
    w = 1e7
    Rm = d.R + w * torch.einsum("ki,kj->kij", g[:, :2], g[:, :2])
    Qm = d.Q.clone()
    Qm[:-1] += w * torch.einsum("ki,kj->kij", g[:, 2:], g[:, 2:])
    Sm = w * torch.einsum("ki,kj->kij", g[:, :2], g[:, 2:])
    C = torch.cat([_cost_rows(d.Q, d.R), (np.sqrt(w) * g)[:, None, :]], -2)
    ZN = chol_factor(d.Q[-1]).mT

    def solve(dtype, use_sqrt):
        A, B, c, q, r, dx0 = (x.to(dtype) for x in (d.A, d.B, d.c, d.q,
                                                     d.r, d.dx0))
        if use_sqrt:
            fac = sqrt_factorize(A, B, C.to(dtype), ZN.to(dtype))
            return sqrt_solve_rhs(fac, A, B, c, q, r, dx0)
        fac = riccati_factorize(A, B, Qm.to(dtype), Rm.to(dtype),
                                S=Sm.to(dtype))
        return riccati_solve_rhs(fac, A, B, c, q, r, dx0)

    _, du64 = solve(torch.float64, False)
    jfac = jric.riccati_factorize(jd.A, jd.B, jnp.asarray(Qm.numpy()),
                                  jnp.asarray(Rm.numpy()),
                                  S=jnp.asarray(Sm.numpy()))
    _, jdu = jric.riccati_solve_rhs(jfac, jd.A, jd.B, jd.c, jd.q, jd.r,
                                    jd.dx0)
    scale = float(du64.abs().max())
    np.testing.assert_allclose(du64.numpy(), np.asarray(jdu), rtol=0,
                               atol=1e-4 * scale)
    _, du_sqrt64 = solve(torch.float64, True)
    jf64 = jsr.sqrt_factorize(jd.A, jd.B, jnp.asarray(C.numpy()),
                              jnp.asarray(ZN.numpy()))
    _, jdu_sqrt64 = jsr.sqrt_solve_rhs(jf64, jd.A, jd.B, jd.c, jd.q, jd.r,
                                       jd.dx0)
    np.testing.assert_allclose(du_sqrt64.numpy(), np.asarray(jdu_sqrt64),
                               rtol=0, atol=1e-9 * scale)
    _, du_sqrt32 = solve(torch.float32, True)
    err_sqrt = float((du_sqrt32.double() - du64).abs().max()) / scale
    _, du_plain32 = solve(torch.float32, False)
    err_plain = float((du_plain32.double() - du64).abs().max()) / scale
    assert err_sqrt < 1e-3, err_sqrt
    assert err_plain > 10 * err_sqrt, (err_plain, err_sqrt)
    # the JAX sqrt core in f32 on the same rows meets the same bound
    jf = jsr.sqrt_factorize(*(jnp.asarray(x.numpy(), jnp.float32)
                              for x in (d.A, d.B, C, ZN)))
    _, jdu32 = jsr.sqrt_solve_rhs(jf, *(jnp.asarray(x.numpy(), jnp.float32)
                                        for x in (d.A, d.B, d.c, d.q, d.r,
                                                  d.dx0)))
    assert float(np.abs(np.asarray(jdu32, np.float64)
                        - du64.numpy()).max()) / scale < 1e-3
