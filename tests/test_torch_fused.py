"""Port parity of the fused RTI ticks against the JAX package (Pallas in
interpret mode): the batched fused tick `batched_rti_step(backend=
"pallas_fused")` (the fuse_cost kernel's plain twin on the CPU), the
one-launch B=1 tick `make_rti_step` with `qp_backend="pallas_fused"` (the
fuse_lin twin), `lin_backend="fused"` on the "pallas" backend, the
`qp_r_floor` Hessian-only damping, a few fused closed-loop ticks, and the
refusals.

Tolerances and why:
  - one IPM iteration: pointwise, u0 atol 2e-3, the new iterate atol
    5e-3, diagnostics rtol 1e-3 (every phase has run once; the f32 solvers
    agree to rounding);
  - the full budget, batched (tests/test_batched_fused.py:51-69): u0 atol
    2e-3, xbar atol 5e-3, kkt_eq rtol 0.2 / atol 1e-3, step norms and
    bound violation rtol 0.05 / atol 1e-3. ubar is held on the QP
    objective of the step (1.2e-2 relative) instead of pointwise: past a
    few iterations the deep-stage rotor thrusts are weakly determined in
    f32 (measured here, 6 iterations: u0 1.3e-3, xbar 3.3e-4 apart, ubar
    8.0e-2 apart on the last stages);
  - the B=1 tick (tests/test_fused_tick.py:43-83): u0 atol 2e-3, the QP
    objective of the step within 1e-2 relative, kkt_eq < 1e-2, mu within
    6e-2.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mpc_blaster_tpu import config as jcfg
from mpc_blaster_tpu.dynamics.blaster import BlasterParams as JBP
from mpc_blaster_tpu.dynamics.fastlin import make_fused_linearizer as jmfl
from mpc_blaster_tpu.ocp.spec import build_spec as jbuild_spec
from mpc_blaster_tpu.parallel.mesh import batched_rti_step as jbatched
from mpc_blaster_tpu.qp.data import qp_objective
from mpc_blaster_tpu.sqp import rti as jrti
from mpc_blaster_tpu_torch import config as cfg
from mpc_blaster_tpu_torch.convert import rti_state_from_numpy, spec_from_numpy
from mpc_blaster_tpu_torch.ops import box_qp_ipm as K
from mpc_blaster_tpu_torch.parallel.mesh import batched_rti_step
from mpc_blaster_tpu_torch.sqp import rti as trti

# The port runs on the CUDA card unless asked for the CPU; these tests
# ask for it.
DEV = torch.device("cpu")


def _ocp(N=8, ipm_iters=6, backend="pallas_fused", **kw):
    base = jcfg.simulation_preset().ocp
    return dataclasses.replace(
        base, N=N, Tf=N / 30.0,
        solver=dataclasses.replace(base.solver, qp_backend=backend,
                                   lin_backend="fused", ipm_iters=ipm_iters,
                                   **kw))


def _spec_pair(ocp, yref=True):
    js = jbuild_spec(ocp, yref=(np.asarray(jcfg.simulation_preset().loop.yref)
                                if yref else None), dtype=jnp.float32)
    ts = spec_from_numpy({k: np.asarray(v) for k, v in js._asdict().items()},
                         device=DEV)
    return js, ts


def _x0s(B, seed=7):
    rng = np.random.default_rng(seed)
    x0s = np.zeros((B, jcfg.NX), np.float32)
    x0s[:, 0:3] = rng.uniform(-0.3, 0.3, (B, 3))
    x0s[:, 2] += 1.0
    return x0s


def _np(x):
    return {k: np.asarray(v) for k, v in x._asdict().items()}


def _batched_pair(ocp, B=3):
    js, ts = _spec_pair(ocp, yref=False)
    x0s = _x0s(B)
    jst = jax.vmap(lambda x: jrti.init_rti_state(ocp, x))(jnp.asarray(x0s))
    j = jbatched(ocp, jit=False, backend="pallas_fused")(
        js, jst, jnp.asarray(x0s))
    t = batched_rti_step(ocp, backend="pallas_fused", device=DEV)(
        ts, trti.init_rti_state(ocp, torch.as_tensor(x0s), device=DEV),
        torch.as_tensor(x0s))
    return js, jst, x0s, j, t


@pytest.mark.parametrize("ipm_iters", [1, 6])
def test_batched_fused_matches_jax(ipm_iters):
    ocp = _ocp(ipm_iters=ipm_iters)
    js, jst, x0s, (u_j, st_j, dg_j), (u_t, st_t, dg_t) = _batched_pair(ocp)
    assert u_t.shape == (3, jcfg.NU) and st_t.xbar.shape == st_j.xbar.shape
    np.testing.assert_allclose(u_t.numpy(), np.asarray(u_j), rtol=0,
                               atol=2e-3)
    np.testing.assert_allclose(st_t.xbar.numpy(), np.asarray(st_j.xbar),
                               rtol=0, atol=5e-3)
    if ipm_iters == 1:
        np.testing.assert_allclose(st_t.ubar.numpy(), np.asarray(st_j.ubar),
                                   rtol=0, atol=5e-3)
        for f in dg_t._fields:
            np.testing.assert_allclose(getattr(dg_t, f).numpy(),
                                       np.asarray(getattr(dg_j, f)),
                                       rtol=1e-3, atol=1e-6, err_msg=f)
        return
    np.testing.assert_allclose(dg_t.qp_kkt_eq.numpy(),
                               np.asarray(dg_j.qp_kkt_eq), rtol=0.2,
                               atol=1e-3)
    for f in ("step_norm_x", "step_norm_u", "bound_viol"):
        np.testing.assert_allclose(getattr(dg_t, f).numpy(),
                                   np.asarray(getattr(dg_j, f)), rtol=0.05,
                                   atol=1e-3, err_msg=f)
    # the QP objective of the step, on the JAX side's own QP
    F = None
    P = JBP.from_config(ocp.model, jnp.float32)
    lin = jmfl(ocp, P, 1)
    qps = jax.vmap(lambda st, x: jrti.build_qp(js, st, x, F, P,
                                               linearizer=lin))(
        jst, jnp.asarray(x0s))

    def obj(st_new):
        dx = jnp.asarray(np.asarray(st_new.xbar)) - jst.xbar
        du = jnp.asarray(np.asarray(st_new.ubar)) - jst.ubar
        return np.asarray(jax.vmap(qp_objective)(qps, dx, du))

    oj, ot = obj(st_j), obj(st_t)
    assert (np.abs(ot - oj) / np.maximum(np.abs(oj), 1.0) < 1.2e-2).all(), \
        (ot, oj)
    assert torch.isfinite(st_t.ubar).all()


def test_batched_fused_chain_stays_finite():
    """Three chained fused ticks (tests/test_batched_fused.py's chain):
    the iterate stays finite and every QP stays converged on its
    linearization (kkt_eq < 1e-2)."""
    ocp = _ocp()
    _, ts = _spec_pair(ocp, yref=False)
    x0 = torch.as_tensor(_x0s(2))
    states = trti.init_rti_state(ocp, x0, device=DEV)
    step = batched_rti_step(ocp, backend="pallas_fused", device=DEV)
    eqs = []
    for _ in range(3):
        _, states, dg = step(ts, states, x0)
        eqs.append(dg.qp_kkt_eq.max().item())
    assert torch.isfinite(states.xbar).all()
    assert torch.isfinite(states.ubar).all()
    assert max(eqs) < 1e-2


def test_qp_r_floor_hessian_only():
    """tests/test_batched_fused.py:89-118 on the port: a zero floor is the
    unfloored tick bit for bit, a floor on the swivel rates makes their
    step smaller; and the floored tick matches JAX's (u0 atol 2e-3, one
    IPM iteration pointwise), on the batched and on the B=1 fused tick."""
    ocp0 = _ocp(ipm_iters=1)
    floored = dataclasses.replace(ocp0, solver=dataclasses.replace(
        ocp0.solver, qp_r_floor=(0.0,) * 4 + (5.0, 5.0)))
    zero = dataclasses.replace(ocp0, solver=dataclasses.replace(
        ocp0.solver, qp_r_floor=(0.0,) * 6))
    _, ts = _spec_pair(ocp0, yref=False)
    x0 = torch.as_tensor(_x0s(2))
    st = trti.init_rti_state(ocp0, x0, device=DEV)
    u0, s0, _ = batched_rti_step(ocp0, backend="pallas_fused",
                                 device=DEV)(ts, st, x0)
    uf, sf, _ = batched_rti_step(floored, backend="pallas_fused",
                                 device=DEV)(ts, st, x0)
    uz, _, _ = batched_rti_step(zero, backend="pallas_fused",
                                device=DEV)(ts, st, x0)
    assert torch.equal(uz, u0)
    d0 = (s0.ubar[:, :, 4:6] - st.ubar[:, :, 4:6]).abs().max()
    df = (sf.ubar[:, :, 4:6] - st.ubar[:, :, 4:6]).abs().max()
    assert df < d0
    _, _, _, (u_j, _, _), (u_t, _, _) = _batched_pair(floored, B=2)
    np.testing.assert_allclose(u_t.numpy(), np.asarray(u_j), rtol=0,
                               atol=2e-3)
    # B=1: the floor reaches the one-launch tick's Hessian only
    js, ts = _spec_pair(floored)
    x0 = _x0s(1)[0]
    jst = jrti.init_rti_state(floored, jnp.asarray(x0))
    u_j, _, _ = jrti.make_rti_step(floored, jit=False)(js, jst,
                                                       jnp.asarray(x0))
    u_t, _, _ = trti.make_rti_step(floored, device=DEV)(
        ts, rti_state_from_numpy(_np(jst), device=DEV), torch.as_tensor(x0))
    np.testing.assert_allclose(u_t.numpy(), np.asarray(u_j), rtol=0,
                               atol=2e-3)


@pytest.mark.parametrize("ipm_iters", [1, 6])
def test_fused_tick_matches_jax(ipm_iters):
    """The one-launch B=1 tick from an off-reference x0 (the JAX package's
    tests/test_fused_tick.py construction)."""
    ocp = _ocp(ipm_iters=ipm_iters)
    js, ts = _spec_pair(ocp, yref=False)
    x0 = np.array(jcfg.simulation_preset().loop.x0, np.float32)
    x0[2] += 0.3
    jst = jrti.init_rti_state(ocp, jnp.asarray(x0))
    u_j, st_j, dg_j = jrti.make_rti_step(ocp, jit=False)(js, jst,
                                                         jnp.asarray(x0))
    n0 = K.fused_rti_solve.launches
    u_t, st_t, dg_t = trti.make_rti_step(ocp, device=DEV)(
        ts, rti_state_from_numpy(_np(jst), device=DEV), torch.as_tensor(x0))
    assert K.fused_rti_solve.launches == n0   # CPU: the plain twin
    np.testing.assert_allclose(u_t.numpy(), np.asarray(u_j), rtol=0,
                               atol=2e-3)
    if ipm_iters == 1:
        np.testing.assert_allclose(st_t.xbar.numpy(), np.asarray(st_j.xbar),
                                   rtol=0, atol=5e-3)
        np.testing.assert_allclose(st_t.ubar.numpy(), np.asarray(st_j.ubar),
                                   rtol=0, atol=5e-3)
        for f in dg_t._fields:
            np.testing.assert_allclose(getattr(dg_t, f).numpy(),
                                       np.asarray(getattr(dg_j, f)),
                                       rtol=1e-3, atol=1e-6, err_msg=f)
        return
    P = JBP.from_config(ocp.model, jnp.float32)
    qp = jrti.build_qp(js, jst, jnp.asarray(x0), None, P,
                       linearizer=jmfl(ocp, P, 1))

    def obj(st):
        return float(qp_objective(
            qp, jnp.asarray(np.asarray(st.xbar)) - jst.xbar,
            jnp.asarray(np.asarray(st.ubar)) - jst.ubar))

    o_j, o_t = obj(st_j), obj(st_t)
    assert abs(o_t - o_j) <= 1e-2 * max(abs(o_j), 1.0), (o_t, o_j)
    assert float(dg_t.qp_kkt_eq) < 1e-2
    assert abs(float(dg_t.qp_mu) - float(dg_j.qp_mu)) < 6e-2


def test_fused_lin_backend_on_pallas_matches_jax():
    """`lin_backend="fused"` on the "pallas" backend: the host-built QP
    with the component-form linearizer, one IPM iteration pointwise."""
    ocp = _ocp(ipm_iters=1, backend="pallas")
    js, ts = _spec_pair(ocp)
    x0 = _x0s(1)[0]
    jst = jrti.init_rti_state(ocp, jnp.asarray(x0))
    u_j, st_j, _ = jrti.make_rti_step(ocp, jit=False)(js, jst,
                                                      jnp.asarray(x0))
    u_t, st_t, _ = trti.make_rti_step(ocp, device=DEV)(
        ts, rti_state_from_numpy(_np(jst), device=DEV), torch.as_tensor(x0))
    np.testing.assert_allclose(u_t.numpy(), np.asarray(u_j), rtol=0,
                               atol=2e-3)
    np.testing.assert_allclose(st_t.ubar.numpy(), np.asarray(st_j.ubar),
                               rtol=0, atol=5e-3)


def test_fused_closed_loop_matches_jax():
    """Five ticks of the simulation preset's loop from the ground under
    `deployed_solver("safe")` (the one-launch tick, 6 IPM iterations),
    N=8, float32. As in tests/test_torch_closedloop.py every tick is an
    unconverged take-off transient, so the loops drift apart by f32
    rounding alone. Measured gap on this input (this file's JAX settings,
    x64 enabled): positions 2.5e-3 m, per-tick cost 3.3e-2 relative.
    Bounds: positions 1e-2 m, cost 0.1 relative (each 3-4x the gap)."""
    from mpc_blaster_tpu.sim.closedloop import run_preset as jrun_preset
    from mpc_blaster_tpu_torch.sim.closedloop import run_preset
    pre = jcfg.simulation_preset()
    pre = dataclasses.replace(pre, ocp=dataclasses.replace(
        pre.ocp, N=8, Tf=8 / 30.0, solver=cfg.deployed_solver("safe")))
    rj = jrun_preset(pre, n_steps=5, dtype=jnp.float32, with_poc=True)
    rt = run_preset(pre, n_steps=5, dtype=torch.float32, with_poc=True,
                    device=DEV)
    xs_j, xs_t = np.asarray(rj.xs), rt.xs.numpy()
    assert xs_t.shape == xs_j.shape == (6, jcfg.NX)
    assert np.isfinite(xs_t).all() and torch.isfinite(rt.us).all()
    np.testing.assert_allclose(xs_t[:, 0:3], xs_j[:, 0:3], rtol=0, atol=1e-2)
    np.testing.assert_allclose(rt.costs.numpy(), np.asarray(rj.costs),
                               rtol=0.1)
    assert xs_t[-1, 2] > 0.1 and xs_j[-1, 2] > 0.1


def test_fused_wrappers_run_plain_twins_on_cpu():
    """On CPU tensors the fused wrappers ARE the plain twins: same
    numbers, no kernel launch counted."""
    ocp = _ocp()
    _, ts = _spec_pair(ocp)
    x0 = torch.as_tensor(_x0s(1))
    st = trti.init_rti_state(ocp, x0, device=DEV)
    model, dt, ns = trti.fused_dyn_statics(ocp)
    args = (st.xbar, st.ubar, ts.stage_params[None], x0,
            (ts.dt * ts.Q)[None], ts.Q_t[None], (ts.dt * ts.R)[None],
            ts.yref_x[None], ts.yref_u[None], ts.yref_e[None],
            ts.lbx[None], ts.ubx[None], ts.lbu[None], ts.ubu[None])
    n0 = K.fused_rti_solve.launches
    a = K.fused_rti_solve(*args, model=model, dt=dt, num_steps=ns, iters=2)
    b = K.fused_rti_solve_plain(*args, model=model, dt=dt, num_steps=ns,
                                iters=2)
    assert K.fused_rti_solve.launches == n0
    for f in ("dx", "du", "kkt_eq", "mu", "lam_lu"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    from mpc_blaster_tpu_torch.dynamics.fastlin import fast_linearize
    from mpc_blaster_tpu_torch.dynamics.blaster import BlasterParams
    xp, A, Bm = fast_linearize(st.xbar, st.ubar, ts.stage_params,
                               BlasterParams.from_config(ocp.model,
                                                         device=DEV), dt)
    fargs = (torch.cat([A, Bm], -1), xp - st.xbar[:, 1:], *args[:2],
             *args[3:])
    n0 = K.batched_fused_tick.launches
    a = K.batched_fused_tick(*fargs, iters=2)
    b = K.batched_fused_tick_plain(*fargs, iters=2)
    assert K.batched_fused_tick.launches == n0
    for x, y in zip(a[:2], b[:2]):
        assert torch.equal(x, y)
    for k in a[2]:
        assert torch.equal(a[2][k], b[2][k]), k


def test_fused_refusals():
    """An x0 without the batch axis on the one-launch tick (B = 2 runs,
    each problem as its own B=1 solve), missing dynamics statics, an unknown
    family or too few stage parameters for one ("blaster_dist" reads rows
    25-30; it and "quad13" run since the fuse_lin kernel has their
    prologues), soft bounds with a warm start and with the "blaster_dist"
    prologue (not instantiated), and Jacobian reuse with the fused tick;
    the deployed profiles,
    "fastest" included, are the JAX package's (field by field: the port
    keeps its own copy of the config classes)."""
    from mpc_blaster_tpu_torch.dynamics.blaster import BlasterParams
    from mpc_blaster_tpu_torch.sim.closedloop import closed_loop
    ocp = _ocp()
    _, ts = _spec_pair(ocp)
    x0 = torch.as_tensor(_x0s(2))
    st = trti.init_rti_state(ocp, x0, device=DEV)
    model, dt, ns = trti.fused_dyn_statics(ocp)
    args = (st.xbar, st.ubar, ts.stage_params.expand(2, -1, -1), x0,
            *(a.expand(2, *a.shape) for a in (
                ts.dt * ts.Q, ts.Q_t, ts.dt * ts.R, ts.yref_x, ts.yref_u,
                ts.yref_e, ts.lbx, ts.ubx, ts.lbu, ts.ubu)))
    two = K.fused_rti_solve(*args, model=model, dt=dt, iters=2)
    for i in range(2):
        solo = K.fused_rti_solve(*(a[i:i + 1] for a in args), model=model,
                                 dt=dt, iters=2)
        torch.testing.assert_close(two.du[i:i + 1], solo.du, rtol=0,
                                   atol=1e-5)
    with pytest.raises(ValueError, match="B >= 1"):
        K.fused_rti_solve(*args[:3], x0[0], *args[4:], model=model, dt=dt)
    one = tuple(a[:1] for a in args)
    with pytest.raises(ValueError, match="unknown model family"):
        K.fused_rti_solve(*one, model=("quad14",) + model[1:], dt=dt)
    with pytest.raises(ValueError, match="reads 31 stage parameters"):
        K.fused_rti_solve(*one, model=("blaster_dist",) + model[1:], dt=dt)
    # the "blaster_dist" prologue with zero disturbance rows is "blaster"
    sp31 = torch.cat([one[2], torch.zeros(1, ocp.N, 6)], -1)
    a = K.fused_rti_solve(*one[:2], sp31, *one[3:], dt=dt, iters=2,
                          model=("blaster_dist",) + model[1:])
    b = K.fused_rti_solve(*one, model=model, dt=dt, iters=2)
    torch.testing.assert_close(a.du, b.du, rtol=0, atol=1e-5)
    # a warm start must carry the launch's batch axis (valid (B,))
    with pytest.raises(ValueError, match="warm.valid"):
        K._warm_args(trti.IpmWarmStart.zeros(8, 17, 6,
                                             device=DEV), 1, 8, 17, 6,
                     x0.device)
    from mpc_blaster_tpu_torch.qp.soft import SoftBounds
    soft = SoftBounds.state_bounds(ocp.N, 17, 6, Zl=1e3, zl=1e2, device=DEV)
    with pytest.raises(ValueError, match="soft bounds do not support"):
        K.fused_rti_solve(*one, model=model, dt=dt, soft=soft,
                          warm=trti.IpmWarmStart(*(
                              a[None] for a in trti.IpmWarmStart.zeros(
                                  ocp.N, 17, 6, device=DEV))))
    with pytest.raises(NotImplementedError, match="ROADMAP queue 2"):
        K.fused_rti_solve(*one[:2], sp31, *one[3:], dt=dt, soft=soft,
                          model=("blaster_dist",) + model[1:])
    with pytest.raises(ValueError, match="dyn_statics"):
        trti.rti_step(ts, _first(st), x0[0], BlasterParams.from_config(
            ocp.model, device=DEV), None, ocp.solver)
    assert dataclasses.asdict(cfg.deployed_solver("fastest")) == \
        dataclasses.asdict(jcfg.deployed_solver("fastest"))
    for profile, iters in (("safe", 6), ("fast", 4)):
        sv = cfg.deployed_solver(profile)
        assert (sv.qp_backend, sv.lin_backend, sv.ipm_iters) == \
            ("pallas_fused", "fused", iters)
    with pytest.raises(ValueError, match="jac_refresh"):
        closed_loop(ts, ocp, x0[0], 1, jac_refresh=2)


def _first(st):
    """The first trajectory of a batched iterate."""
    return trti.RTIState(xbar=st.xbar[0], ubar=st.ubar[0])
