"""Port parity of the second model family, `models/quad13.py` (13 states, 4
inputs), against the JAX package: the ODE, its RK4 step and the spec in
float64; the box-QP IPM kernel's plain twin at 13x4 against the Pallas
kernel in interpret mode; the fuse_lin twin with the "quad13" prologue
against `pallas_fused_rti_solve` (interpret); the RTI tick on all three
QP backends; the refusals of the instantiations no path uses.

Tolerances and why:
  - the ODE, RK4 and the spec: float64, 1e-12 (the same formulas);
  - the plain twin at 13x4: tests/test_torch_ipm.py's helpers (one IPM
    iteration pointwise: u0 atol 2e-3, dx/du atol 5e-3, slacks/duals
    rtol 1e-3; the full budget on the QP objective, 1.2e-2 relative, and
    kkt_eq, rtol 0.2 / atol 1e-3);
  - the fuse_lin twin: tests/test_torch_fused.py's (one iteration
    pointwise, u0 atol 2e-3, dx/du atol 5e-3; six on the objective,
    1e-2 relative, and u0 atol 5e-2 as tests/test_fused_tick.py:196);
  - the "riccati" tick in float64: u0 and the new iterate within 1e-6
    (the same algorithm, rounding only; the climb saturates the rotors at
    their 65 N bound, where the interior point sits within ~mu of the
    bound: measured 1.3e-8 N apart);
  - "pallas" against "riccati" in float32: rtol 0.02 / atol 0.2 on u0,
    as tests/test_quad13.py:90-91.
"""
import dataclasses
import functools

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from torch.func import vmap

from mpc_blaster_tpu import config as jcfg
from mpc_blaster_tpu.dynamics.integrators import discrete_dynamics as jdd
from mpc_blaster_tpu.models import quad13 as JQ
from mpc_blaster_tpu.ops.pallas_ipm import (pallas_box_qp_solve,
                                            pallas_fused_rti_solve)
from mpc_blaster_tpu.qp.data import QPData as JQPData
from mpc_blaster_tpu_torch import config as cfg
from mpc_blaster_tpu_torch.convert import (qp_to_numpy,
                                           quad13_config_from_numpy,
                                           quad13_config_to_numpy,
                                           rti_state_from_numpy,
                                           spec_from_numpy)
from mpc_blaster_tpu_torch.dynamics.integrators import discrete_dynamics
from mpc_blaster_tpu_torch.models import quad13 as TQ
from mpc_blaster_tpu_torch.ops import box_qp_ipm as K
from mpc_blaster_tpu_torch.qp.data import qp_objective

from test_torch_ipm import (_assert_full_solve_parity,
                            _assert_one_iteration_parity)
from torch_threads import one_intraop_thread  # noqa: F401

# The port runs on the CUDA card unless asked for the CPU; these tests
# ask for it.
DEV = torch.device("cpu")


def _np(x):
    return {k: np.asarray(v) for k, v in x._asdict().items()}


def _states(n, seed=0):
    """Random quad13 states (a quaternion near identity, not unit) and
    rotor thrusts around hover."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0.0, 0.3, (n, 13))
    x[:, 3] += 1.0
    u = 22.0 + rng.normal(0.0, 3.0, (n, 4))
    return x, u


def test_quad13_ode_rk4_and_spec_match_jax():
    c = JQ.Quad13Config()
    tc = TQ.Quad13Config()
    assert dataclasses.asdict(tc) == dataclasses.asdict(c)
    assert (TQ.QUAD13_NX, TQ.QUAD13_NU) == (JQ.QUAD13_NX, JQ.QUAD13_NU)
    jp, tp = JQ._params(c, jnp.float64), TQ._params(tc, torch.float64,
                                                    device=DEV)
    Fj, Ft = jdd(JQ.quad13_ode, c.dt), discrete_dynamics(TQ.quad13_ode,
                                                        tc.dt)
    p0 = np.zeros(1)
    xs, us = _states(6)
    for x, u in zip(xs, us):
        jx, ju = jnp.asarray(x), jnp.asarray(u)
        tx, tu = torch.as_tensor(x), torch.as_tensor(u)
        np.testing.assert_allclose(
            TQ.quad13_ode(tx, tu, torch.zeros(1, dtype=torch.float64),
                          tp).numpy(),
            np.asarray(JQ.quad13_ode(jx, ju, jnp.asarray(p0), jp)),
            rtol=0, atol=1e-12)
        np.testing.assert_allclose(
            Ft(tx, tu, torch.zeros(1, dtype=torch.float64), tp).numpy(),
            np.asarray(Fj(jx, ju, jnp.asarray(p0), jp)), rtol=0, atol=1e-12)
    # the hover trim is an equilibrium
    u_h = torch.full((4,), tc.mass * tc.gravity / 4.0, dtype=torch.float64)
    xd = TQ.quad13_ode(TQ.hover_state(2.0, torch.float64, device=DEV), u_h,
                       torch.zeros(1, dtype=torch.float64), tp)
    assert xd.abs().max().item() < 1e-12
    js = JQ.build_quad13_spec(c, target_pos=(0.3, -0.2, 1.5),
                              dtype=jnp.float64)
    ts = TQ.build_quad13_spec(tc, target_pos=(0.3, -0.2, 1.5),
                              dtype=torch.float64, device=DEV)
    for k, v in _np(js).items():
        np.testing.assert_allclose(getattr(ts, k).numpy(), v, rtol=0,
                                   atol=1e-12, err_msg=k)
    st_j = JQ.init_quad13_rti_state(c, JQ.hover_state(1.0, jnp.float64),
                                    jnp.float64)
    st_t = TQ.init_quad13_rti_state(tc, TQ.hover_state(1.0, torch.float64,
                                                       device=DEV),
                                    torch.float64, device=DEV)
    for k, v in _np(st_j).items():
        np.testing.assert_array_equal(getattr(st_t, k).numpy(), v)
    assert TQ.quad13_dyn_statics(tc, 2) == JQ.quad13_dyn_statics(c, 2)


@pytest.fixture(scope="module")
def quad13_qps():
    """Linearized quad13 QPs around hover at z=1 with x0 spread +-0.4 m
    (B=2, N=8, float32), built once for the module by the port (the JAX
    build dispatches op by op for seconds), and their JAX copies."""
    from test_torch_cuda import _quad13_case
    *_, td = _quad13_case(torch.device("cpu"), B=2)
    jd = JQPData(**{k: jnp.asarray(v) for k, v in qp_to_numpy(td).items()})
    return jd, td


@pytest.mark.parametrize("iters", [1, 8])
def test_plain_twin_13x4_matches_pallas(quad13_qps, iters):
    jd, td = quad13_qps
    assert td.A.shape[-2:] == (13, 13) and td.B.shape[-1] == 4
    sj = pallas_box_qp_solve(jd, iters=iters, interpret=True)
    st = K.box_qp_solve_plain(td, iters=iters)
    if iters == 1:
        _assert_one_iteration_parity(sj, st)
    else:
        _assert_full_solve_parity(jd, sj, st)
    # the wrapper on CPU tensors is the twin
    n0 = K.box_qp_solve.launches
    assert torch.equal(K.box_qp_solve(td, iters=iters).du, st.du)
    assert K.box_qp_solve.launches == n0


@functools.cache
def _fused_args(N=8, z=1.7):
    """The fused arguments at a perturbed hover (JAX and port copies),
    built once for the module: the JAX build dispatches op by op."""
    c = JQ.Quad13Config(N=N, Tf=N / 30.0)
    js = JQ.build_quad13_spec(c, dtype=jnp.float32)
    x0 = JQ.hover_state(z)
    st = JQ.init_quad13_rti_state(c, x0)
    rng = np.random.default_rng(5)
    st = st._replace(xbar=st.xbar + jnp.asarray(
        rng.uniform(-0.02, 0.02, st.xbar.shape), jnp.float32))
    dtw = js.dt
    jargs = (st.xbar[None], st.ubar[None], js.stage_params[None], x0[None],
             (dtw * js.Q)[None], js.Q_t[None], (dtw * js.R)[None],
             js.yref_x[None], js.yref_u[None], js.yref_e[None],
             js.lbx[None], js.ubx[None], js.lbu[None], js.ubu[None])
    targs = tuple(torch.as_tensor(np.array(a)) for a in jargs)
    model, dt, ns = JQ.quad13_dyn_statics(c)
    return c, js, st, jargs, targs, dict(model=model, dt=dt, num_steps=ns)


def _fused_objectives(targs, lin, sj, stt):
    """The QP objective of the Pallas solve `sj` and of the twin's `stt`
    (batch of one), both on the QP the fused mode assembles from `targs`
    (the fused arguments as tensors) and the twin's linearization `lin`."""
    qp = K._fused_qp(K._fused_prep(targs[0], targs[1], targs[3], *targs[4:],
                                   None), *lin)
    return tuple(float(vmap(qp_objective)(qp, dx, du)[0]) for dx, du in (
        (torch.as_tensor(np.array(sj.dx)), torch.as_tensor(np.array(sj.du))),
        (stt.dx, stt.du)))


@pytest.mark.parametrize("iters", [1, 6])
def test_fused_twin_quad13_matches_pallas(iters):
    *_, jargs, targs, kw = _fused_args()
    sj = pallas_fused_rti_solve(*jargs, iters=iters, interpret=True, **kw)
    stt, lin = K.fused_rti_solve_plain(*targs, iters=iters, return_lin=True,
                                       **kw)
    np.testing.assert_allclose(stt.du[:, 0].numpy(),
                               np.asarray(sj.du)[:, 0], rtol=0,
                               atol=2e-3 if iters == 1 else 5e-2)
    if iters == 1:
        np.testing.assert_allclose(stt.du.numpy(), np.asarray(sj.du),
                                   rtol=0, atol=5e-3)
        np.testing.assert_allclose(stt.dx.numpy(), np.asarray(sj.dx),
                                   rtol=0, atol=5e-3)
        np.testing.assert_allclose(stt.mu.numpy(), np.asarray(sj.mu),
                                   rtol=1e-3, atol=1e-6)
        return
    oj, ot = _fused_objectives(targs, lin, sj, stt)
    assert abs(ot - oj) <= 1e-2 * max(abs(oj), 1.0), (ot, oj)
    assert float(stt.kkt_eq[0]) < 1e-2


def test_quad13_riccati_tick_matches_jax_f64():
    c = JQ.Quad13Config(N=8, Tf=8 / 30.0)
    tc = TQ.Quad13Config(N=8, Tf=8 / 30.0)
    sv = dataclasses.replace(jcfg.SolverConfig(), qp_backend="riccati",
                             ipm_iters=10)
    tsv = dataclasses.replace(cfg.SolverConfig(), qp_backend="riccati",
                              ipm_iters=10)
    js = JQ.build_quad13_spec(c, target_pos=(0.0, 0.0, 1.4),
                              dtype=jnp.float64)
    x0 = JQ.hover_state(1.0, jnp.float64)
    jst = JQ.init_quad13_rti_state(c, x0, jnp.float64)
    u_j, st_j, dg_j = JQ.make_quad13_rti_step(
        c, dtype=jnp.float64, solver=sv)(js, jst, x0)
    u_t, st_t, dg_t = TQ.make_quad13_rti_step(
        tc, dtype=torch.float64, solver=tsv, device=DEV)(
        spec_from_numpy(_np(js), dtype=torch.float64, device=DEV),
        rti_state_from_numpy(_np(jst), dtype=torch.float64, device=DEV),
        torch.as_tensor(np.array(x0)))
    assert u_t.dtype == torch.float64
    np.testing.assert_allclose(u_t.numpy(), np.asarray(u_j), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(st_t.xbar.numpy(), np.asarray(st_j.xbar),
                               rtol=0, atol=1e-6)
    # both converged: equality residuals at rounding level (measured
    # 1.4e-11 and 2.8e-9)
    assert float(dg_t.qp_kkt_eq) < 1e-8 and float(dg_j.qp_kkt_eq) < 1e-8


def test_quad13_kernel_backends_match_riccati():
    """The climb tick of tests/test_quad13.py:61-91 on the port: "pallas"
    (the 13x4 plain twin here) and "pallas_fused" (the quad13 fuse_lin
    twin) against "riccati", float32."""
    tc = TQ.Quad13Config(N=8)
    spec = TQ.build_quad13_spec(tc, target_pos=(0.0, 0.0, 1.4), device=DEV)
    x0 = TQ.hover_state(1.0, device=DEV)
    st = TQ.init_quad13_rti_state(tc, x0, device=DEV)
    outs = {}
    for backend in ("riccati", "pallas", "pallas_fused"):
        sv = dataclasses.replace(cfg.SolverConfig(), qp_backend=backend,
                                 ipm_iters=8)
        u0, _, diag = TQ.make_quad13_rti_step(tc, solver=sv,
                                              device=DEV)(spec, st, x0)
        assert torch.isfinite(u0).all()
        assert float(diag.qp_kkt_eq) < 1e-2
        outs[backend] = u0.numpy()
    for b in ("pallas", "pallas_fused"):
        np.testing.assert_allclose(outs[b], outs["riccati"], rtol=0.02,
                                   atol=0.2)


def test_quad13_refusals_and_config_round_trip(quad13_qps):
    """The kernel has no soft 13x4 instantiation and no fuse_cost one at
    13x4: the wrappers refuse them on every device; an unknown family is
    a ValueError; the config survives its numpy round trip."""
    _, td = quad13_qps
    from mpc_blaster_tpu_torch.qp.soft import SoftBounds
    soft = SoftBounds.state_bounds(8, 13, 4, Zl=1e3, zl=1e2, device=DEV)
    with pytest.raises(NotImplementedError, match="ROADMAP queue 2"):
        K.box_qp_solve(td, iters=1, soft=soft)
    c, js, st, jargs, targs, kw = _fused_args()
    with pytest.raises(NotImplementedError, match="ROADMAP queue 2"):
        K.fused_rti_solve(*targs, soft=soft, **kw)
    AB = torch.cat([td.A, td.B], -1)[:1]
    with pytest.raises(NotImplementedError, match="no fuse_cost"):
        K.batched_fused_tick(AB, td.c[:1], *targs[:2], *targs[3:])
    with pytest.raises(ValueError, match="unknown model family"):
        K.fused_rti_solve(*targs, **dict(kw, model=("quad14",)
                                         + kw["model"][1:]))
    tc = TQ.Quad13Config(N=12, rate_bound=0.5)
    back = quad13_config_from_numpy(quad13_config_to_numpy(tc))
    assert back == tc and isinstance(back.inertia_diag, tuple)
