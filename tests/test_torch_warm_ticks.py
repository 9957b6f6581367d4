"""Port parity of the warm-started chain's ticks against the JAX package:
`rti_step_warm`, the divergence watchdog (`rti_step_warm_guarded`, the JAX
package's tests/test_watchdog.py cases) and a few ticks of the
`deployed_solver("fastest")` closed loop (tests/test_torch_warm.py holds
the warm-started solves themselves).

Tolerances and why:
  - `rti_step_warm` on "riccati" in float64: every output within 1e-8;
    on "pallas_fused" in float32: the cold first tick on the QP objective
    of its step (1e-2 relative, tests/test_torch_fused.py), the warm
    second tick on finiteness and the conditioning of its warm output;
    the "fastest" loop's positions within 1e-2 m;
  - the watchdog on the float32 Riccati backend: JAX's own tolerances
    (tests/test_watchdog.py), and the port's trip is its cold redo bit for
    bit.
"""
import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mpc_blaster_tpu import config as jcfg
from mpc_blaster_tpu.dynamics.blaster import BlasterParams as JBP
from mpc_blaster_tpu.dynamics.blaster import blaster_ode as jode
from mpc_blaster_tpu.dynamics.integrators import discrete_dynamics as jdd
from mpc_blaster_tpu.ocp.spec import build_spec as jbuild_spec
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
