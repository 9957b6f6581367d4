"""Port parity of the warm-started chain against the JAX package: the
Riccati IPM's slack/dual warm start (`qp/ipm.py`: `box_qp_solve(warm=)`,
`warm_start_from`, `warm_start_recenter`), the warm-start blend of the
box-QP IPM kernel (K3) in its plain twins against the Pallas kernel in
interpret mode, `rti_step_warm`, the divergence watchdog
(`rti_step_warm_guarded`, the JAX package's tests/test_watchdog.py cases)
and a few ticks of the `deployed_solver("fastest")` closed loop.

Tolerances and why:
  - the Riccati IPM in float64: 1e-10 absolute (the same algorithm, op for
    op; measured <= 1.2e-16);
  - the kernel twins in float32 against Pallas: the blend itself
    pointwise (0 IPM iterations return the blended initial slacks and
    duals: rtol 1e-5 / atol 1e-6, the cold rows' f32 rollout rounding);
    valid=0 rows equal the cold solve exactly after any budget. Past the
    blend the valid problem of this chained case is chaotic in f32:
    moving its warm slacks and duals by 1e-7 relative moves the twin's du
    by 0.3-2.9 within 1-6 iterations (the float64 Riccati IPM: 8e-6), and
    twin, Pallas and the Riccati IPM differ by as much. So iterated warm
    solves are held to the cold kernel's tolerances (one iteration
    pointwise, atol 5e-3; the 3-iteration budget on the QP objective,
    1.2e-2) only on the problems that are not chaotic by that measure,
    and on finiteness everywhere;
  - `rti_step_warm` on "pallas_fused" in float32: the cold first tick on
    the QP objective of its step (1e-2 relative,
    tests/test_torch_fused.py), the warm second tick on finiteness and
    the conditioning of its warm output; the "fastest" loop's positions
    within 1e-2 m;
  - the watchdog on the float32 Riccati backend: JAX's own tolerances
    (tests/test_watchdog.py), and the port's trip is its cold redo bit for
    bit.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mpc_blaster_tpu import config as jcfg
from mpc_blaster_tpu.dynamics.blaster import BlasterParams as JBP
from mpc_blaster_tpu.dynamics.blaster import blaster_ode as jode
from mpc_blaster_tpu.dynamics.fastlin import fast_linearize as jfl
from mpc_blaster_tpu.dynamics.fastlin import make_fused_linearizer
from mpc_blaster_tpu.dynamics.integrators import discrete_dynamics as jdd
from mpc_blaster_tpu.ocp.spec import build_spec as jbuild_spec
from mpc_blaster_tpu.ops import pallas_ipm as JP
from mpc_blaster_tpu.qp import ipm as jipm
from mpc_blaster_tpu.qp.data import qp_objective
from mpc_blaster_tpu.sqp import rti as jrti
from mpc_blaster_tpu_torch import config as cfg
from mpc_blaster_tpu_torch import convert
from mpc_blaster_tpu_torch.dynamics.blaster import BlasterParams, blaster_ode
from mpc_blaster_tpu_torch.dynamics.integrators import discrete_dynamics
from mpc_blaster_tpu_torch.ocp.spec import build_spec
from mpc_blaster_tpu_torch.ops import box_qp_ipm as K
from mpc_blaster_tpu_torch.qp import ipm as tipm
from mpc_blaster_tpu_torch.sqp import rti as trti
from test_qp import random_qp
from torch_threads import one_intraop_thread  # noqa: F401

# The port runs on the CUDA card unless asked for the CPU; these tests
# ask for it.
DEV = torch.device("cpu")

NX, NU = jcfg.NX, jcfg.NU


def _np(x):
    return {k: np.asarray(v) for k, v in x._asdict().items()}


def _close(t, j, atol, err_msg="", rtol=0):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), rtol=rtol,
                               atol=atol, err_msg=err_msg)


# ------------------------- the Riccati IPM, float64 -------------------------

def _qp64(seed, bound_scale=2.0):
    jd = random_qp(seed=seed, bound_scale=bound_scale)
    return jd, convert.qp_from_numpy(_np(jd), dtype=torch.float64, device=DEV)


def test_box_qp_solve_warm_matches_jax():
    """A warm start from the previous solve of a neighbouring QP: the
    port's blend and solve are JAX's (float64, 1e-10); valid=0 is the cold
    solve bit for bit; NaN and +-inf warm entries go through the same
    per-entry guard on both sides, and an all-NaN warm start is the cold
    solve."""
    jd1, td1 = _qp64(3)
    jd2, td2 = jd1._replace(q=1.1 * jd1.q), td1._replace(q=1.1 * td1.q)
    j1 = jipm.box_qp_solve(jd1, iters=10)
    wj = jipm.warm_start_from(j1)
    wt = convert.warm_from_numpy(_np(wj), dtype=torch.float64, device=DEV)
    sj = jipm.box_qp_solve(jd2, iters=5, warm=wj)
    st = tipm.box_qp_solve(td2, iters=5, warm=wt)
    for f in ("dx", "du", "s_lx", "lam_uu", "mu", "kkt_eq"):
        _close(getattr(st, f), getattr(sj, f), 1e-10, f)
    cold = tipm.box_qp_solve(td2, iters=5)
    assert not torch.equal(st.du, cold.du)
    off = tipm.box_qp_solve(td2, iters=5, warm=wt._replace(
        valid=torch.zeros((), dtype=torch.float64)))
    for f in ("dx", "du", "s_lx", "lam_lx", "mu"):
        assert torch.equal(getattr(off, f), getattr(cold, f)), f
    # poisoned entries: NaN falls back per entry, +-inf clips
    poison = {k: np.array(v) for k, v in _np(wj).items()}
    poison["s_lu"][0, :2] = np.nan
    poison["lam_uu"][1, 0] = np.nan
    poison["s_ux"][2, 3] = np.inf
    poison["lam_lx"][3, 1] = np.inf
    sj = jipm.box_qp_solve(jd2, iters=5, warm=jipm.IpmWarmStart(**{
        k: jnp.asarray(v) for k, v in poison.items()}))
    st = tipm.box_qp_solve(td2, iters=5, warm=convert.warm_from_numpy(
        poison, dtype=torch.float64, device=DEV))
    assert torch.isfinite(st.du).all()
    _close(st.du, sj.du, 1e-10)
    nan = wt._replace(**{f: torch.full_like(getattr(wt, f), float("nan"))
                         for f in wt._fields if f != "valid"})
    assert torch.equal(tipm.box_qp_solve(td2, iters=5, warm=nan).du, cold.du)


@pytest.mark.parametrize("shift", [False, True])
@pytest.mark.parametrize("mode", ["primal", "centrality"])
def test_warm_start_from_and_recenter_match_jax(mode, shift):
    jd, td = _qp64(4)
    sj = jipm.box_qp_solve(jd, iters=6)
    st = tipm.box_qp_solve(td, iters=6)
    wj = jipm.warm_start_recenter(jipm.warm_start_from(sj, shift=shift),
                                  mu0=0.1, mode=mode)
    wt = tipm.warm_start_recenter(tipm.warm_start_from(st, shift=shift),
                                  mu0=0.1, mode=mode)
    for f in wj._fields:
        _close(getattr(wt, f), getattr(wj, f), 1e-10, f)
    assert float(wt.valid) == 1.0
    if shift:
        assert torch.equal(wt.s_lx[-1], wt.s_lx[-2])
        assert torch.equal(wt.s_lx[:-1], st.s_lx[1:])
    else:
        assert wt.s_lx is st.s_lx   # no copy: the next solve never aliases
    with pytest.raises(ValueError, match="recenter mode"):
        tipm.warm_start_recenter(wt, mode="stale")


# -------------------- the kernel's warm blend (K3), f32 ---------------------

def _fused_case(N=8, B=3, seed=5):
    """Two chained ticks of the "fastest" chain on the JAX side: perturbed
    hover iterates inside the boxes (chip_smoke's fused construction), a
    cold 3-iteration Pallas solve of their QPs, the iterate updated and
    shifted, x0 moved to the predicted next state; the second tick's
    inputs (its fused-linearizer QPs too) and a warm start from the first
    solve, shifted and primal-recentred. Problem 1 is invalid (valid=0),
    problem 2 poisoned with NaN and +inf entries."""
    pre = jcfg.simulation_preset()
    ocp = dataclasses.replace(pre.ocp, N=N, Tf=N / 30.0)
    js = jbuild_spec(ocp, yref=np.asarray(pre.loop.yref), dtype=jnp.float32)
    P = JBP.from_config(ocp.model, jnp.float32)
    lin = make_fused_linearizer(ocp, P, 1)
    rng = np.random.default_rng(seed)
    x0 = np.zeros((B, NX), np.float32)
    x0[:, 0:3] = rng.uniform(-0.4, 0.4, (B, 3))
    x0[:, 2] += 2.0
    st = jax.vmap(lambda x: jrti.init_rti_state(ocp, x))(jnp.asarray(x0))
    xbar = st.xbar + rng.uniform(-0.02, 0.02, st.xbar.shape).astype(
        np.float32)
    du = np.zeros(st.ubar.shape, np.float32)
    du[..., 0:4] = rng.uniform(-0.5, 0.5, du[..., 0:4].shape)
    ubar = st.ubar + du

    def qps(xbar, ubar, x0):
        return jax.vmap(lambda xb, ub, x: jrti.build_qp(
            js, jrti.RTIState(xb, ub), x, None, P, linearizer=lin))(
            xbar, ubar, x0)

    prev = JP.pallas_box_qp_solve(qps(xbar, ubar, jnp.asarray(x0)), iters=3,
                                  interpret=True)
    nxt = jax.vmap(lambda xb, ub: jrti.shift_state(jrti.RTIState(xb, ub)))(
        xbar + prev.dx, ubar + prev.du)
    xbar, ubar = nxt.xbar, nxt.ubar
    x0 = np.asarray(xbar[:, 0])
    warm = jax.vmap(lambda s: jipm.warm_start_recenter(
        jipm.warm_start_from(s, shift=True), mode="primal"))(prev)
    w = {k: np.array(v) for k, v in _np(warm).items()}
    w["valid"][1] = 0.0
    w["s_lu"][2, :3] = np.nan
    w["lam_lx"][2, 1, :4] = np.nan
    w["s_ux"][2, 2, 0] = np.inf
    w["lam_uu"][2, 0, 1] = np.inf
    xp, A, Bm = jax.vmap(lambda xb, ub: jfl(xb, ub, js.stage_params, P,
                                             ocp.dt, 1))(xbar, ubar)

    def bc(a):
        return jnp.broadcast_to(a[None], (B,) + a.shape)
    args = (bc(js.dt * js.Q), bc(js.Q_t), bc(js.dt * js.R), bc(js.yref_x),
            bc(js.yref_u), bc(js.yref_e), bc(js.lbx), bc(js.ubx),
            bc(js.lbu), bc(js.ubu))
    return dict(ocp=ocp, js=js, x0=x0, xbar=np.asarray(xbar),
                ubar=np.asarray(ubar),
                AB=np.asarray(jnp.concatenate([A, Bm], -1)),
                c=np.asarray(xp - xbar[:, 1:]), args=args,
                qp=qps(xbar, ubar, jnp.asarray(x0)), warm=w)


@pytest.fixture(scope="module")
def fcase():
    return _fused_case()


def _tw(w, sl=slice(None)):
    return convert.warm_from_numpy({k: v[sl] for k, v in w.items()},
                                   device=DEV)


def _jw(w, sl=slice(None)):
    return jipm.IpmWarmStart(**{k: jnp.asarray(v[sl]) for k, v in w.items()})


def _moved(w, eps):
    """A numpy warm start with every slack and dual scaled by 1 + eps."""
    return {k: v if k == "valid" else v * np.float32(1 + eps)
            for k, v in w.items()}


def _solve_both(fc, mode, iters, warm_slice=slice(None), eps=1e-7):
    """Solutions of one kernel mode in delta form, each (dx, du,
    QPSolution), keyed "pallas" (JAX, interpret mode, warm), "twin" (the
    port's plain twin, warm), "cold" (the twin, cold) and "moved" (the
    twin from the warm state moved by `eps` relative); and "qp", the QPs."""
    w, sl = fc["warm"], warm_slice
    x0 = fc["x0"][sl]
    targs = [torch.as_tensor(np.asarray(a)[sl]) for a in fc["args"]]
    jargs = [a[sl] for a in fc["args"]]
    xb, ub = fc["xbar"][sl], fc["ubar"][sl]
    jq = jax.tree.map(lambda a: a[sl], fc["qp"])
    kw = dict(iters=iters)
    warms = {"twin": _tw(w, sl), "cold": None,
             "moved": _tw(_moved(w, eps), sl)}
    if mode == "plain":
        tq = convert.qp_from_numpy(_np(jq), device=DEV)
        sj = JP.pallas_box_qp_solve(jq, interpret=True, warm=_jw(w, sl), **kw)
        out = {k: K.box_qp_solve_plain(tq, warm=v, **kw)
               for k, v in warms.items()}
        out = {k: (s.dx, s.du, s) for k, s in out.items()}
    elif mode == "fuse_cost":
        AB, c = fc["AB"][sl], fc["c"][sl]
        _, _, _, sj = JP.pallas_batched_fused_tick(
            jnp.asarray(AB), jnp.asarray(c), jnp.asarray(xb), jnp.asarray(ub),
            jnp.asarray(x0), *jargs, interpret=True, warm=_jw(w, sl), **kw)
        targ = (torch.as_tensor(AB), torch.as_tensor(c), torch.as_tensor(xb),
                torch.as_tensor(ub), torch.as_tensor(x0), *targs)
        # sol.dx / sol.du of this mode are the updated absolute iterate
        out = {}
        for k, v in warms.items():
            s = K.batched_fused_tick_plain(*targ, warm=v, **kw)[3]
            s = s._replace(dx=s.dx.numpy(), du=s.du.numpy())
            out[k] = (s.dx - xb, s.du - ub, s)
        sj = (sj.dx - xb, sj.du - ub, sj)
    else:
        model, dt, ns = trti.fused_dyn_statics(fc["ocp"])
        sp = fc["js"].stage_params[None]
        jkw = dict(model=model, dt=dt, num_steps=ns, **kw)
        sj = JP.pallas_fused_rti_solve(
            jnp.asarray(xb), jnp.asarray(ub), sp, jnp.asarray(x0), *jargs,
            interpret=True, warm=_jw(w, sl), **jkw)
        targ = (torch.as_tensor(xb), torch.as_tensor(ub),
                torch.as_tensor(np.asarray(sp)), torch.as_tensor(x0), *targs)
        out = {k: K.fused_rti_solve_plain(*targ, warm=v, **jkw)
               for k, v in warms.items()}
        out = {k: (s.dx, s.du, s) for k, s in out.items()}
    if mode != "fuse_cost":
        sj = (sj.dx, sj.du, sj)
    return dict(out, pallas=sj, qp=jq)


def _objectives(qp, dx, du):
    return np.asarray(jax.vmap(qp_objective)(
        qp, jnp.asarray(np.asarray(dx)), jnp.asarray(np.asarray(du))))


@pytest.mark.parametrize("iters", [0, 1, 3])
@pytest.mark.parametrize("mode", ["plain", "fuse_cost", "fuse_lin"])
def test_warm_twins_match_pallas(fcase, mode, iters):
    """Each kernel mode's plain twin with `warm=` against the Pallas
    kernel's `warm_on` variant in interpret mode. plain and fuse_cost run
    the batch of three (valid, invalid, poisoned); fuse_lin (B=1) the
    poisoned problem, then the invalid one against its cold solve.

    0 iterations: the blend pointwise on every problem. 1 and 3 (the
    "fastest" budget) iterations: on every problem whose f32 warm solve is
    not chaotic, i.e. where moving the warm state by 1e-7 relative moves
    the twin's du by less than 1e-3 (the valid problem 0 here moves by
    0.3-2.9; the float64 Riccati IPM, 8e-6), one iteration pointwise (dx
    and du atol 5e-3, as the cold kernel) and the budget on the QP
    objective (1.2e-2 relative); everywhere, finite."""
    sl = slice(2, 3) if mode == "fuse_lin" else slice(None)
    r = _solve_both(fcase, mode, iters, sl)
    (jdx, jdu, sj), (tdx, tdu, st) = r["pallas"], r["twin"]
    cdx, cdu, sc = r["cold"]
    tdx, tdu = np.asarray(tdx), np.asarray(tdu)
    assert np.isfinite(tdx).all() and np.isfinite(tdu).all()
    if iters == 0:   # the blended initial slacks and duals
        for f in ("s_lx", "s_ux", "s_lu", "s_uu",
                  "lam_lx", "lam_ux", "lam_lu", "lam_uu"):
            np.testing.assert_allclose(np.asarray(getattr(st, f)),
                                       np.asarray(getattr(sj, f)),
                                       rtol=1e-5, atol=1e-6, err_msg=f)
        # the warm start changed the valid problems' initial duals
        assert not torch.equal(st.lam_lu[-1], sc.lam_lu[-1])
    else:
        assert np.isfinite(np.asarray(jdu)).all()
        assert np.isfinite(np.asarray(st.kkt_eq)).all()
        spread = np.abs(tdu - np.asarray(r["moved"][1])).max(axis=(-2, -1))
        calm = spread < 1e-3
        assert calm.any(), spread
        if iters == 1:
            for t, j in ((tdx, jdx), (tdu, jdu)):
                np.testing.assert_allclose(t[calm], np.asarray(j)[calm],
                                           rtol=0, atol=5e-3)
        else:
            ot = _objectives(r["qp"], tdx, tdu)
            oj = _objectives(r["qp"], jdx, jdu)
            rel = np.abs(ot - oj) / np.maximum(np.abs(oj), 1.0)
            assert (rel[calm] <= 1.2e-2).all(), rel
    if mode == "fuse_lin":
        r1 = _solve_both(fcase, mode, iters, slice(1, 2))
        assert torch.equal(torch.as_tensor(np.asarray(r1["twin"][1])),
                           torch.as_tensor(np.asarray(r1["cold"][1])))
    else:   # valid=0 leaves a problem the cold solve, bit for bit
        assert np.array_equal(tdu[1], np.asarray(cdu)[1])
        assert np.array_equal(tdx[1], np.asarray(cdx)[1])


def test_warm_wrappers_run_plain_twins_and_never_alias(fcase):
    """On CPU tensors the wrappers with `warm=` ARE the twins (no launch
    counted, warm or cold), and no output shares storage with a warm
    input, even with the raw chain's un-shifted, un-recentred warm start
    (warm_start_from hands the previous outputs straight back)."""
    tq = convert.qp_from_numpy(_np(fcase["qp"]), device=DEV)
    n0, w0 = K.box_qp_solve.launches, K.box_qp_solve.warm_launches
    prev = K.box_qp_solve(tq, iters=2)
    warm = tipm.warm_start_from(prev)   # the raw chain: previous outputs
    assert warm.s_lx is prev.s_lx
    a = K.box_qp_solve(tq, iters=2, warm=warm, skip=torch.tensor(True))
    b = K.box_qp_solve_plain(tq, iters=2, warm=warm)
    assert (K.box_qp_solve.launches, K.box_qp_solve.warm_launches) == (n0, w0)
    for f in ("dx", "du", "s_lx", "lam_uu", "kkt_eq"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    ins = {t.untyped_storage().data_ptr() for t in warm if t.numel()}
    for f, t in a._asdict().items():
        if t is not None:
            assert t.untyped_storage().data_ptr() not in ins, f
    assert not torch.equal(a.du, K.box_qp_solve_plain(tq, iters=2).du)


# ------------------------------- warm ticks --------------------------------

def _warm_ocp(backend, N=8, iters=3, warm_shift=True):
    base = jcfg.simulation_preset().ocp
    sv = dataclasses.replace(base.solver, qp_backend=backend,
                             lin_backend="fused", ipm_iters=iters,
                             warm_mode="primal", warm_shift=warm_shift)
    return dataclasses.replace(base, N=N, Tf=N / 30.0, solver=sv)


@pytest.mark.parametrize("backend", ["riccati", "pallas_fused"])
def test_rti_step_warm_matches_jax(backend):
    """Two chained warm ticks from the same state: the first cold
    (IpmWarmStart.zeros), the second from the JAX tick's warm output on
    both sides. riccati in float64, shifted and primal-recentred: every
    output within 1e-8 (1e-6 relative on the duals mu0/s, which reach
    1e4). pallas_fused in float32, unshifted: the cold tick's step on its
    QP objective (1e-2 relative), the warm tick finite with its warm
    output the primal re-centring of its solve."""
    f64 = backend == "riccati"
    jdt, tdt = ((jnp.float64, torch.float64) if f64
                else (jnp.float32, torch.float32))
    ocp = _warm_ocp(backend, warm_shift=f64)
    pre = jcfg.simulation_preset()
    js = jbuild_spec(ocp, yref=np.asarray(pre.loop.yref), dtype=jdt)
    ts = convert.spec_from_numpy(_np(js), dtype=tdt, device=DEV)
    P = JBP.from_config(ocp.model, jdt)
    F = jdd(jode, ocp.dt)
    jlin = jrti.make_linearizer(ocp, P)
    tP = BlasterParams.from_config(ocp.model, tdt, device=DEV)
    tF = discrete_dynamics(blaster_ode, ocp.dt)
    tlin = trti.make_linearizer(ocp, tP)
    dyn = trti.fused_dyn_statics(ocp) if not f64 else None
    x0 = np.zeros(NX)
    x0[2], x0[0] = 1.5, 0.1
    st = jrti.init_rti_state(ocp, jnp.asarray(x0, jdt), jdt)
    warm = jipm.IpmWarmStart.zeros(ocp.N, NX, NU, jdt)
    for tick in range(2):
        x = jnp.asarray(x0, jdt)
        uj, stj, wj, dj = jrti.rti_step_warm(js, st, warm, x, P, F,
                                              ocp.solver, linearizer=jlin,
                                              dyn_statics=dyn)
        ut, stt, wt, dt_ = trti.rti_step_warm(
            ts, convert.rti_state_from_numpy(_np(st), dtype=tdt, device=DEV),
            convert.warm_from_numpy(_np(warm), dtype=tdt, device=DEV),
            torch.as_tensor(x0, dtype=tdt), tP, tF, ocp.solver,
            linearizer=tlin, dyn_statics=dyn)
        assert float(wt.valid) == 1.0 and torch.isfinite(ut).all()
        if f64:
            _close(ut, uj, 1e-8, f"u0, tick {tick}")
            _close(stt.xbar, stj.xbar, 1e-8, "xbar")
            assert torch.equal(stt.xbar[-1], stt.xbar[-2])   # shifted
            for f in wj._fields:
                _close(getattr(wt, f), getattr(wj, f), 1e-8, f, rtol=1e-6)
            _close(dt_.qp_kkt_eq, dj.qp_kkt_eq, 1e-8)
        elif tick == 0:
            qp = jrti.build_qp(js, st, x, F, P, linearizer=jlin)

            def obj(new):
                return float(qp_objective(
                    qp, jnp.asarray(np.asarray(new.xbar)) - st.xbar,
                    jnp.asarray(np.asarray(new.ubar)) - st.ubar))
            o_j, o_t = obj(stj), obj(stt)
            assert abs(o_t - o_j) <= 1e-2 * max(abs(o_j), 1.0), (o_t, o_j)
        else:
            assert torch.isfinite(stt.xbar).all()
            torch.testing.assert_close(wt.lam_lu, 0.1 / wt.s_lu.clamp(
                min=1e-9))
        st, warm = stj, wj
        x0 = np.asarray(F(jnp.asarray(x0, jdt), uj, js.stage_params[0], P))


# ------------------------------- the watchdog -------------------------------

WD_N = 10


def _wd_setup(iters=4, dtype=torch.float32, **sv_kw):
    """tests/test_watchdog.py's setup on the port: the Riccati backend,
    the fused linearizer, N=10, float32."""
    preset = jcfg.simulation_preset()
    ocp = dataclasses.replace(preset.ocp, N=WD_N, Tf=WD_N / 30.0)
    sv = dataclasses.replace(ocp.solver, ipm_iters=iters,
                             qp_backend="riccati", lin_backend="fused",
                             warm_mode="full", warm_shift=False, **sv_kw)
    ocp = dataclasses.replace(ocp, solver=sv)
    spec = build_spec(ocp, yref=preset.loop.yref, dtype=dtype, device=DEV)
    params = BlasterParams.from_config(ocp.model, dtype, device=DEV)
    F = discrete_dynamics(blaster_ode, ocp.dt)
    return ocp, spec, params, F, trti.make_linearizer(ocp, params), sv


def test_watchdog_trips_out_of_envelope():
    """A state below the z box pins stage 0 outside it -> bound_viol >
    viol_cap -> the tick is downgraded and its result IS the cold redo
    (bit for bit: one code path), the EMA reseeds from it, the hold is 10
    ticks and escalates by 2 per earlier trip; the JAX package's guarded
    tick agrees (tests/test_watchdog.py's tolerances)."""
    ocp, spec, params, F, lin, sv = _wd_setup()
    x0 = torch.zeros(NX)
    x0[2] = -1.0
    st = trti.init_rti_state(ocp, x0, device=DEV)
    warm = tipm.IpmWarmStart.zeros(WD_N, NX, NU, device=DEV)._replace(
        valid=torch.tensor(1.0))
    wd0 = trti.WatchdogState.init(device=DEV)
    u_g, st_g, _, wd1, diag_g = trti.rti_step_warm_guarded(
        spec, st, warm, wd0, x0, params, F, sv, linearizer=lin)
    assert (int(wd1.trips), int(wd1.hold)) == (1, 10)
    cold = warm._replace(valid=torch.tensor(0.0))
    st_cold = trti.RTIState(xbar=st.xbar, ubar=torch.minimum(
        torch.maximum(st.ubar, spec.lbu), spec.ubu))
    u_c, st_c, _, diag_c = trti.rti_step_warm(spec, st_cold, cold, x0,
                                              params, F, sv, linearizer=lin)
    assert torch.equal(u_g, u_c) and torch.equal(st_g.xbar, st_c.xbar)
    assert torch.equal(wd1.ema_eq, diag_c.qp_kkt_eq)
    *_, wd2, _ = trti.rti_step_warm_guarded(spec, st, warm, wd1, x0, params,
                                            F, sv, linearizer=lin)
    assert (int(wd2.trips), int(wd2.hold)) == (2, 12)
    # the JAX package's guarded tick on the same inputs
    jocp = ocp
    js = jbuild_spec(jocp, yref=jcfg.simulation_preset().loop.yref,
                     dtype=jnp.float32)
    P = JBP.from_config(jocp.model, jnp.float32)
    jx0 = jnp.asarray(x0.numpy())
    ju, jst, _, jwd, _ = jrti.rti_step_warm_guarded(
        js, jrti.init_rti_state(jocp, jx0),
        jipm.IpmWarmStart.zeros(WD_N, NX, NU, jnp.float32)._replace(
            valid=jnp.asarray(1.0)), jrti.WatchdogState.init(), jx0, P,
        jdd(jode, jocp.dt), sv, linearizer=jrti.make_linearizer(jocp, P))
    assert int(jwd.trips) == 1 and int(jwd.hold) == 10
    np.testing.assert_allclose(u_g.numpy(), np.asarray(ju), rtol=3e-2,
                               atol=1e-3)
    assert torch.isfinite(u_g).all()


@pytest.mark.parametrize("lin_backend", ["fused", "jacfwd"])
def test_watchdog_linearizes_once_a_tick(lin_backend, monkeypatch):
    """Off "pallas_fused" the guarded tick makes one linearization, over
    the carried iterate's and its sanitized copy's 2N nodes (a NaN row
    and an out-of-box control make the two differ), and each half equals
    that iterate's own linearization bit for bit."""
    ocp, spec, params, F, lin, sv = _wd_setup(iters=3)
    calls = []
    if lin_backend == "fused":
        fused = lin

        def lin(xbar, ubar, sp):
            calls.append(ubar.shape[0])
            return fused(xbar, ubar, sp)
        own = fused
    else:
        lin, nodes = None, trti._linearize_nodes

        def spy(F_, xbar, ubar, sp, params_):
            calls.append(ubar.shape[0])
            return nodes(F_, xbar, ubar, sp, params_)
        monkeypatch.setattr(trti, "_linearize_nodes", spy)

        def own(xbar, ubar, sp):
            return nodes(F, xbar, ubar, sp, params)
    x0 = torch.zeros(NX)
    x0[2] = 1.0
    st = trti.init_rti_state(ocp, x0, device=DEV)
    xbar, ubar = st.xbar.clone(), st.ubar.clone()
    xbar[4, 0] = float("nan")
    ubar[2, 0] = spec.ubu[0] + 1.0
    st = trti.RTIState(xbar=xbar, ubar=ubar)
    warm = tipm.IpmWarmStart.zeros(WD_N, NX, NU, device=DEV)
    wd = trti.WatchdogState.init(device=DEV)
    spied = []
    pair = trti._linearize_pair
    monkeypatch.setattr(trti, "_linearize_pair", lambda *a: spied.append(
        pair(*a)) or spied[-1])
    trti.rti_step_warm_guarded(spec, st, warm, wd, x0, params, F, sv,
                               linearizer=lin)
    assert calls == [2 * WD_N] and len(spied) == 1
    sane = trti.RTIState(
        xbar=torch.where(torch.isfinite(xbar), xbar, x0),
        ubar=torch.minimum(torch.maximum(ubar, spec.lbu), spec.ubu))
    for got, it in zip(spied[0], (st, sane)):
        want = own(it.xbar, it.ubar, spec.stage_params)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=0, atol=0, equal_nan=True)


def test_watchdog_quiet_on_deployed_chain():
    """The deployed warm profile (3-iteration shifted primal chain, the
    settings of deployed_solver("fastest")) through the climb transient
    never trips, and climbs towards z=3.5 (JAX: tests/test_watchdog.py)."""
    ocp, spec, params, F, lin, sv = _wd_setup(iters=3)
    sv = dataclasses.replace(sv, warm_mode="primal", warm_shift=True)
    x = torch.zeros(NX)
    x[2] = 0.5
    st = trti.init_rti_state(ocp, x, device=DEV)
    warm = tipm.IpmWarmStart.zeros(WD_N, NX, NU, device=DEV)
    wd = trti.WatchdogState.init(device=DEV)
    plant_p = spec.stage_params[0].clone()
    plant_p[-1] = 2.2 * 9.81
    for _ in range(80):
        u0, st, warm, wd, _ = trti.rti_step_warm_guarded(
            spec, st, warm, wd, x, params, F, sv, linearizer=lin)
        x = F(x, u0, plant_p, params)
    assert int(wd.trips) == 0
    assert abs(float(x[2]) - 3.5) < 0.8


def test_watchdog_closed_loop_wiring():
    """closed_loop(warm_start=True) with warm_watchdog=True runs the
    guarded chain end to end and, with nothing tripping, equals the
    unguarded warm chain."""
    from mpc_blaster_tpu_torch.sim.closedloop import closed_loop
    ocp, spec, *_ = _wd_setup(iters=4)
    svw = dataclasses.replace(ocp.solver, warm_mode="primal",
                              warm_shift=True, warm_watchdog=True)
    sv0 = dataclasses.replace(svw, warm_watchdog=False)
    x0 = torch.zeros(NX)
    x0[2] = 2.0
    res_w = closed_loop(spec, dataclasses.replace(ocp, solver=svw), x0, 30,
                        warm_start=True)
    res_0 = closed_loop(spec, dataclasses.replace(ocp, solver=sv0), x0, 30,
                        warm_start=True)
    assert torch.isfinite(res_w.xs).all()
    torch.testing.assert_close(res_w.xs, res_0.xs, rtol=0, atol=1e-5)


def test_watchdog_rejects_jacreuse_composition():
    from mpc_blaster_tpu_torch.sim.closedloop import closed_loop
    ocp, spec, *_ = _wd_setup(warm_watchdog=True)
    with pytest.raises(ValueError, match="warm_watchdog"):
        closed_loop(spec, ocp, torch.zeros(NX), 5, warm_start=True,
                    jac_refresh=2)


def test_convert_warm_and_watchdog_round_trips():
    w = jipm.IpmWarmStart.zeros(4, NX, NU, jnp.float64)._replace(
        s_lx=jnp.arange(4 * NX, dtype=jnp.float64).reshape(4, NX))
    out = convert.warm_to_numpy(convert.warm_from_numpy(
        _np(w), dtype=torch.float64, device=DEV))
    for k, v in _np(w).items():
        np.testing.assert_array_equal(out[k], v, err_msg=k)
    wd = jrti.WatchdogState(ema_eq=jnp.asarray(0.25), trips=jnp.asarray(
        3, jnp.int32), hold=jnp.asarray(7, jnp.int32))
    t = convert.watchdog_from_numpy(_np(wd), device=DEV)
    assert t.trips.dtype == torch.int32 and t.ema_eq.dtype == torch.float32
    assert convert.watchdog_to_numpy(t) == {"ema_eq": np.float32(0.25),
                                           "trips": 3, "hold": 7}


# --------------------------- the "fastest" loop -----------------------------

def test_fastest_closed_loop_matches_jax():
    """Six ticks of the simulation preset's loop from the ground under
    deployed_solver("fastest") (the one-launch tick, 3 IPM iterations, the
    shifted primal warm chain under the watchdog) through
    make_closed_loop(..., warm_start=True), N=8, float32, against the JAX
    package's loop (Pallas in interpret mode). Every tick is a take-off
    transient, so the loops drift apart by f32 rounding alone; positions
    within 1e-2 m, as the cold fused loop's test."""
    from mpc_blaster_tpu.sim.closedloop import make_closed_loop as jmcl
    from mpc_blaster_tpu.sim.closedloop import preset_stage_params as jpsp
    from mpc_blaster_tpu_torch.sim.closedloop import (make_closed_loop,
                                                      preset_stage_params)
    pre = jcfg.simulation_preset()
    ocp = dataclasses.replace(pre.ocp, N=8, Tf=8 / 30.0,
                              solver=cfg.deployed_solver("fastest"))
    assert dataclasses.asdict(ocp.solver) == \
        dataclasses.asdict(jcfg.deployed_solver("fastest"))
    js = jbuild_spec(ocp, yref=pre.loop.yref,
                     stage_params=jpsp(pre, jnp.float32), dtype=jnp.float32)
    rj = jmcl(ocp, 6, warm_start=True)(js, jnp.asarray(pre.loop.x0,
                                                      jnp.float32))
    ts = build_spec(ocp, yref=pre.loop.yref,
                    stage_params=preset_stage_params(pre, device=DEV),
                    device=DEV)
    n0 = K.fused_rti_solve.warm_launches
    rt = make_closed_loop(ocp, 6, warm_start=True)(
        ts, torch.as_tensor(pre.loop.x0, dtype=torch.float32))
    assert K.fused_rti_solve.warm_launches == n0   # CPU: the plain twin
    xs_j, xs_t = np.asarray(rj.xs), rt.xs.numpy()
    assert xs_t.shape == xs_j.shape == (7, NX)
    assert np.isfinite(xs_t).all() and torch.isfinite(rt.us).all()
    np.testing.assert_allclose(xs_t[:, 0:3], xs_j[:, 0:3], rtol=0, atol=1e-2)
    assert xs_t[-1, 2] > 0.1 and xs_j[-1, 2] > 0.1
