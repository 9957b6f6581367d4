"""Port parity of the box-QP IPM: the plain PyTorch twin
(`ops/box_qp_ipm.py::box_qp_solve_plain`, which the CUDA kernel follows
operation for operation) against the Pallas kernel in interpret mode, on
real linearized BLASTER QPs and on QPs with infinite bounds.

Tolerances and why:
  - after ONE IPM iteration every phase (init, KKT sweep, factorization,
    predictor, corrector, step, best-merit tracking, final KKT) has run
    once and the two f32 solvers still agree to rounding (measured du
    5e-5, dx 1e-6): u0 atol 2e-3 and dx/du atol 5e-3 as in
    tests/test_batched_fused.py, slacks/duals rtol 1e-3;
  - after the full budget (10 iterations) the iterates have left each
    other pointwise: rounding is amplified through the ill-conditioned
    Riccati recursion, and the individual rotor thrusts are weakly
    determined (measured, N=20 B=64, 12 iterations: objectives within
    2.2e-4 relative, du up to 0.44 apart -- and the f64 twin differs from
    either f32 solver by as much). So the full solve is held on what is
    determined: the QP objective within 1.2e-2 relative
    (tests/test_pallas_ipm.py), kkt_eq within rtol 0.2 / atol 1e-3
    (tests/test_batched_fused.py), and the control bounds.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mpc_blaster_tpu import config as cfg
from mpc_blaster_tpu.ops.pallas_ipm import pallas_box_qp_solve
from mpc_blaster_tpu.qp.data import qp_objective
from mpc_blaster_tpu_torch.convert import qp_from_numpy
from mpc_blaster_tpu_torch.ops import box_qp_ipm as K

# The port runs on the CUDA card unless asked for the CPU; these tests
# ask for it.
DEV = torch.device("cpu")


def _blaster_qps(B=2, N=8):
    """Linearized BLASTER QPs at different states (the JAX package's
    tests/test_pallas_ipm.py construction), as a batched JAX QPData."""
    from mpc_blaster_tpu.dynamics.blaster import BlasterParams, blaster_ode
    from mpc_blaster_tpu.dynamics.integrators import discrete_dynamics
    from mpc_blaster_tpu.ocp.spec import build_spec
    from mpc_blaster_tpu.sqp.rti import build_qp, init_rti_state

    preset = cfg.simulation_preset()
    ocp = dataclasses.replace(preset.ocp, N=N, Tf=N / 30.0)
    spec = build_spec(ocp, yref=np.asarray(preset.loop.yref),
                      dtype=jnp.float32)
    params = BlasterParams.from_config(ocp.model, jnp.float32)
    F = discrete_dynamics(blaster_ode, ocp.dt, num_steps=1)
    rng = np.random.default_rng(0)
    x0s = np.zeros((B, cfg.NX), np.float32)
    x0s[:, 0:3] = rng.uniform(-0.4, 0.4, (B, 3))
    x0s[:, 2] = rng.uniform(1.5, 3.4, B)
    return jax.vmap(lambda x: build_qp(spec, init_rti_state(ocp, x),
                                       x, F, params))(jnp.asarray(x0s))


def _to_torch(jd):
    return qp_from_numpy({k: np.asarray(v) for k, v in jd._asdict().items()},
                         device=DEV)


def _objectives(jd, sol):
    """Per-problem QP objective of a JAX or a (CPU) torch solution."""
    dx = jnp.asarray(np.asarray(sol.dx))
    du = jnp.asarray(np.asarray(sol.du))
    return np.asarray(jax.vmap(qp_objective)(jd, dx, du))


def _assert_one_iteration_parity(sj, st):
    np.testing.assert_allclose(st.du[:, 0].numpy(), np.asarray(sj.du)[:, 0],
                               rtol=0, atol=2e-3)
    np.testing.assert_allclose(st.du.numpy(), np.asarray(sj.du), rtol=0,
                               atol=5e-3)
    np.testing.assert_allclose(st.dx.numpy(), np.asarray(sj.dx), rtol=0,
                               atol=5e-3)
    for f in ("s_lx", "s_ux", "s_lu", "s_uu",
              "lam_lx", "lam_ux", "lam_lu", "lam_uu"):
        np.testing.assert_allclose(getattr(st, f).numpy(),
                                   np.asarray(getattr(sj, f)),
                                   rtol=1e-3, atol=1e-3, err_msg=f)
    for f in ("kkt_eq", "kkt_stat", "mu"):
        np.testing.assert_allclose(getattr(st, f).numpy(),
                                   np.asarray(getattr(sj, f)),
                                   rtol=1e-3, atol=1e-6, err_msg=f)


def _assert_full_solve_parity(jd, sj, st, obj_rtol=1.2e-2):
    oj, ot = _objectives(jd, sj), _objectives(jd, st)
    assert (np.abs(ot - oj) / np.maximum(np.abs(oj), 1.0) < obj_rtol).all(), \
        (ot, oj)
    np.testing.assert_allclose(st.kkt_eq.numpy(), np.asarray(sj.kkt_eq),
                               rtol=0.2, atol=1e-3)
    assert torch.isfinite(st.du).all() and torch.isfinite(st.dx).all()


@pytest.fixture(scope="module")
def qps():
    jd = _blaster_qps(B=2, N=8)
    return jd, _to_torch(jd)


def test_plain_ipm_one_iteration_matches_pallas(qps):
    jd, td = qps
    sj = pallas_box_qp_solve(jd, iters=1, interpret=True)
    st = K.box_qp_solve_plain(td, iters=1)
    _assert_one_iteration_parity(sj, st)


def test_plain_ipm_full_solve_matches_pallas(qps):
    jd, td = qps
    sj = pallas_box_qp_solve(jd, iters=10, interpret=True)
    st = K.box_qp_solve_plain(td, iters=10)
    _assert_full_solve_parity(jd, sj, st)
    assert (st.du >= td.lbu - 1e-4).all() and (st.du <= td.ubu + 1e-4).all()


def test_plain_ipm_infinite_bounds_match_pallas(qps):
    """+-inf bounds are masked (slack 1e20, dual 0). All-free reduces to
    the unconstrained LQR problem, which is well determined: objective
    within 1e-3 relative (tests/test_pallas_ipm.py's LQR bound). Mixed
    (only the active thrust lower bounds kept) uses the full-solve
    tolerances."""
    jd, _ = qps
    inf = jnp.inf
    free = jd._replace(lbx=jnp.full_like(jd.lbx, -inf),
                       ubx=jnp.full_like(jd.ubx, inf),
                       lbu=jnp.full_like(jd.lbu, -inf),
                       ubu=jnp.full_like(jd.ubu, inf))
    mixed = free._replace(lbu=jd.lbu)
    for case, rtol in ((free, 1e-3), (mixed, 1.2e-2)):
        sj = pallas_box_qp_solve(case, iters=10, interpret=True)
        st = K.box_qp_solve_plain(_to_torch(case), iters=10)
        _assert_full_solve_parity(case, sj, st, obj_rtol=rtol)
        for f in ("s_lx", "lam_lx", "s_uu", "lam_uu"):
            np.testing.assert_allclose(getattr(st, f).numpy(),
                                       np.asarray(getattr(sj, f)), rtol=1e-6,
                                       err_msg=f)
    assert (st.du.numpy() >= np.asarray(jd.lbu) - 1e-3).all()


@pytest.mark.parametrize("case", ["spd", "indefinite", "tiny_pivot"])
def test_chol_inverse_matches_smallalg(case):
    """The fail-safe equilibrated inverse of the 6x6 Huu against
    qp/smallalg.py::chol_inverse (f32, atol 1e-4 of the largest entry: a
    6x6 inverse with condition number up to ~1e6 after equilibration),
    and the zero sentinel on indefinite or singular input."""
    from mpc_blaster_tpu.qp.smallalg import chol_inverse
    rng = np.random.default_rng(11)
    G = rng.normal(size=(4, 6, 6))
    M = G @ np.swapaxes(G, -1, -2) + np.diag(
        [1e-5, 1e-3, 1.0, 1e2, 1e4, 1e7])
    if case == "indefinite":
        M[:, 2, 2] = -1.0
    elif case == "tiny_pivot":
        # exactly singular after equilibration: the second pivot is 0
        M = np.tile(2.0 * np.eye(6), (4, 1, 1))
        M[:, 0, 1] = M[:, 1, 0] = 2.0
    M = M.astype(np.float32)
    ref = np.asarray(chol_inverse(jnp.asarray(M)))
    out = K.chol_inverse_plain(torch.as_tensor(M)).numpy()
    scale = np.abs(ref).max(axis=(-1, -2), keepdims=True) + 1e-30
    np.testing.assert_allclose(out / scale, ref / scale, rtol=0, atol=1e-4)
    if case != "spd":
        assert (out == 0).all()


def test_wrapper_runs_plain_twin_on_cpu(qps):
    """On CPU tensors the wrapper IS the plain twin: same numbers, and no
    kernel launch is counted."""
    _, td = qps
    n0 = K.box_qp_solve.launches
    a = K.box_qp_solve(td, iters=3)
    b = K.box_qp_solve_plain(td, iters=3)
    assert K.box_qp_solve.launches == n0
    for f in ("dx", "du", "kkt_eq", "mu", "lam_lu", "s_ux"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
