"""Port parity of `sim/scenarios.py` (the scenario draws, the disturbance
models, the offset-free loop) and `ocp/terminal.py` (the DARE terminal
weight) against the JAX package; the numbers chip_smoke.py's offset-free
phase is held to.

Tolerances and why:
  - the draws: exact (the same numpy generator); the disturbance ODEs:
    float64, 1e-12 (the same formulas);
  - `lqr_terminal_weight`: float64, 1e-8 relative (the same float32
    linearization, the same scipy DARE);
  - `offset_free_loop` on "riccati" in float64, N=6, 30 ticks (the case of
    tests/test_scenarios.py::test_offset_free_loop_smoke): states and the
    disturbance estimates within 1e-4 (the closed loops agree to ~1e-4
    across implementations: the best-merit iterate flips inside the
    weakly determined rotor split, tests/test_torch_golden.py);
  - the fuse_lin twin with the "blaster_dist" prologue against
    `pallas_fused_rti_solve` (interpret), N=8, disturbance rows non-zero:
    tests/test_torch_fused.py's tolerances (one IPM iteration pointwise:
    u0 atol 2e-3, dx/du atol 5e-3, mu rtol 1e-3; six on the QP objective,
    1e-2 relative, and kkt_eq < 1e-2);
  - `offset_free_loop` on "pallas_fused" (the same twin in the loop)
    against the JAX loop with Pallas in interpret mode, N=8, 2 ticks: the
    first tick's u0 within 5e-2 (tests/test_fused_tick.py:196), positions
    within 1e-3 m. Past the first tick u0 is not held pointwise: the
    observer's first innovation makes tick 2 a transient whose QP the
    JAX solve does not converge in 6 iterations (kkt_eq 1.6e-2), and the
    two f32 solvers end at different rotor splits (measured 1.15 N apart,
    the same at 12 iterations); the positions after it agree to 2.0e-4 m
    (1.6e-3 m one tick later).
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mpc_blaster_tpu import config as jcfg
from mpc_blaster_tpu.dynamics.blaster import BlasterParams as JBP
from mpc_blaster_tpu.ocp.spec import build_spec as jbuild_spec
from mpc_blaster_tpu.ocp import terminal as JT
from mpc_blaster_tpu.sim import scenarios as JS
from mpc_blaster_tpu_torch import config as cfg
from mpc_blaster_tpu_torch.convert import (offset_free_from_numpy,
                                           offset_free_to_numpy,
                                           spec_from_numpy)
from mpc_blaster_tpu_torch.dynamics.blaster import BlasterParams
from mpc_blaster_tpu_torch.ocp import terminal as TT
from mpc_blaster_tpu_torch.sim import scenarios as TS


# The port runs on the CUDA card unless asked for the CPU; these tests
# ask for it.
DEV = torch.device("cpu")


def _np(x):
    return {k: np.asarray(v) for k, v in x._asdict().items()}


def _ocp(N, backend="riccati", iters=6):
    base = jcfg.simulation_preset()
    return dataclasses.replace(
        base.ocp, N=N, Tf=N / 30.0,
        solver=dataclasses.replace(base.ocp.solver, qp_backend=backend,
                                   ipm_iters=iters))


def _tocp(N, backend="riccati", iters=6):
    """The port's own config of `_ocp`."""
    base = cfg.simulation_preset()
    return dataclasses.replace(
        base.ocp, N=N, Tf=N / 30.0,
        solver=dataclasses.replace(base.ocp.solver, qp_backend=backend,
                                   ipm_iters=iters))


def _spec_pair(ocp, dtype=jnp.float32, tdtype=torch.float32):
    js = jbuild_spec(ocp, yref=np.asarray(jcfg.simulation_preset().loop.yref),
                     dtype=dtype)
    return js, spec_from_numpy(_np(js), dtype=tdtype, device=DEV)


def test_sample_scenarios_and_disturbance_odes_match_jax():
    a, b = JS.sample_scenarios(5, seed=3), TS.sample_scenarios(5, seed=3,
                                                               device=DEV)
    for f in a._fields:
        np.testing.assert_array_equal(getattr(b, f).numpy(),
                                      np.asarray(getattr(a, f)), err_msg=f)
    rng = np.random.default_rng(4)
    x, u = rng.normal(0, 0.3, 17), 20.0 + rng.normal(0, 2.0, 6)
    p = rng.normal(0, 0.5, 31)
    p[24] = 21.0
    d = rng.normal(0, 0.5, 6)
    jp = JBP.from_config(jcfg.simulation_preset().ocp.model, jnp.float64)
    tp = BlasterParams.from_config(cfg.simulation_preset().ocp.model,
                                   torch.float64, device=DEV)
    J, T = (jnp.asarray, torch.as_tensor)
    for jf, tf in (
            (lambda: JS._windy_plant_ode(J(x), J(u), J(p[:25]), jp,
                                         J(d[:3])),
             lambda: TS._windy_plant_ode(T(x), T(u), T(p[:25]), tp,
                                         T(d[:3]))),
            (lambda: JS._disturbed_ode(J(x), J(u), J(p[:25]), jp, J(d[:3]),
                                       J(d[3:])),
             lambda: TS._disturbed_ode(T(x), T(u), T(p[:25]), tp, T(d[:3]),
                                       T(d[3:]))),
            (lambda: JS.dist_param_ode(J(x), J(u), J(p), jp),
             lambda: TS.dist_param_ode(T(x), T(u), T(p), tp))):
        np.testing.assert_allclose(tf().numpy(), np.asarray(jf()), rtol=0,
                                   atol=1e-12)


def test_lqr_terminal_weight_matches_jax():
    ocp = _ocp(12)
    js, ts = _spec_pair(ocp)
    tocp = _tocp(12)
    xj, uj = JT.hover_equilibrium(ocp, js)
    xt, ut = TT.hover_equilibrium(tocp, ts)
    np.testing.assert_array_equal(xt, xj)
    np.testing.assert_array_equal(ut, uj)
    Qj = np.asarray(JT.lqr_terminal_weight(ocp, js, dtype=jnp.float64))
    Qt = TT.lqr_terminal_weight(tocp, ts, dtype=torch.float64).numpy()
    np.testing.assert_allclose(Qt, Qj, rtol=1e-8,
                               atol=1e-8 * np.abs(Qj).max())
    # the POC rows (zero Jacobians in this spec) keep the preset's terminal
    np.testing.assert_array_equal(Qt[14:, 14:], ts.Q_t[14:, 14:].numpy())


def _offset_free_pair(N, backend, n_steps, jdt, tdt, wind, z0):
    ocp = _ocp(N, backend)
    js, ts = _spec_pair(ocp, jdt, tdt)
    x0 = np.zeros(17)
    x0[2] = z0
    rj = jax.jit(lambda s, x: JS.offset_free_loop(
        s, ocp, x, jnp.asarray(wind, jdt), n_steps=n_steps, dtype=jdt))(
        js, jnp.asarray(x0, jdt))
    rt = TS.offset_free_loop(ts, _tocp(N, backend),
                             torch.as_tensor(x0, dtype=tdt), wind,
                             n_steps=n_steps, dtype=tdt)
    return rj, rt


def test_offset_free_loop_riccati_matches_jax_f64():
    wind = [0.5, -0.3, 0.1]
    rj, rt = _offset_free_pair(6, "riccati", 30, jnp.float64,
                               torch.float64, wind, 3.2)
    assert rt.xs.shape == (31, 17) and rt.d_hist.shape == (30, 6)
    np.testing.assert_allclose(rt.xs.numpy(), np.asarray(rj.xs), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(rt.d_hist.numpy(), np.asarray(rj.d_hist),
                               rtol=0, atol=1e-4)
    # the observer has learned the wind (tests/test_scenarios.py)
    np.testing.assert_allclose(rt.d_hist[-1, 0:3].numpy(), wind, atol=0.05)
    back = offset_free_from_numpy(offset_free_to_numpy(rt),
                                  dtype=torch.float64, device=DEV)
    for f in rt._fields:
        assert torch.equal(getattr(back, f), getattr(rt, f)), f


def test_offset_free_loop_pallas_fused_matches_jax():
    """The one-launch tick with the "blaster_dist" prologue (its twin on
    the CPU) in the loop against the JAX loop, Pallas in interpret mode."""
    rj, rt = _offset_free_pair(8, "pallas_fused", 2, jnp.float32,
                               torch.float32, [0.7, -0.5, 0.2], 3.0)
    np.testing.assert_allclose(rt.us[0].numpy(), np.asarray(rj.us[0]),
                               rtol=0, atol=5e-2)
    np.testing.assert_allclose(rt.xs[:, 0:3].numpy(),
                               np.asarray(rj.xs[:, 0:3]), rtol=0, atol=1e-3)
    np.testing.assert_allclose(rt.d_hist.numpy(), np.asarray(rj.d_hist),
                               rtol=0, atol=5e-2)
    assert torch.isfinite(rt.xs).all()


@pytest.mark.parametrize("iters",
                         [1, pytest.param(6, marks=pytest.mark.slow)])
def test_fused_twin_blaster_dist_matches_pallas(iters):
    """K6's "blaster_dist" prologue: the twin (fast_linearize of the family
    and the plain solve) against `pallas_fused_rti_solve` in interpret
    mode, at a perturbed hover iterate with disturbance rows
    (0.7, -0.5, 0.2, 0.05, -0.03, 0.01). Each iteration count is an
    interpret compile of ~10 s, so the six-iteration case is slow; its
    fast siblings are the one-iteration case and
    test_offset_free_loop_pallas_fused_matches_jax, whose first tick runs
    the same kernel at six iterations."""
    from mpc_blaster_tpu.ops.pallas_ipm import pallas_fused_rti_solve
    from mpc_blaster_tpu.sqp import rti as jrti
    from test_torch_quad13 import _fused_objectives
    from mpc_blaster_tpu_torch.ops import box_qp_ipm as K
    ocp = _ocp(8, "pallas_fused", iters)
    js, _ = _spec_pair(ocp)
    rng = np.random.default_rng(6)
    x0 = np.zeros(17, np.float32)
    x0[2] = 2.0
    st = jrti.init_rti_state(ocp, jnp.asarray(x0))
    du = np.zeros(st.ubar.shape, np.float32)
    du[:, 0:4] = rng.uniform(-0.5, 0.5, (8, 4))
    st = st._replace(
        xbar=st.xbar + jnp.asarray(rng.uniform(-0.02, 0.02, st.xbar.shape),
                                   jnp.float32),
        ubar=st.ubar + jnp.asarray(du))
    d = jnp.asarray([0.7, -0.5, 0.2, 0.05, -0.03, 0.01], jnp.float32)
    sp = jnp.concatenate([js.stage_params, jnp.tile(d[None], (8, 1))], 1)
    dtw = js.dt
    jargs = (st.xbar[None], st.ubar[None], sp[None], jnp.asarray(x0)[None],
             (dtw * js.Q)[None], js.Q_t[None], (dtw * js.R)[None],
             js.yref_x[None], js.yref_u[None], js.yref_e[None],
             js.lbx[None], js.ubx[None], js.lbu[None], js.ubu[None])
    model, dt, ns = jrti.fused_dyn_statics(ocp, 1, family="blaster_dist")
    kw = dict(model=model, dt=dt, num_steps=ns, iters=iters)
    sj = pallas_fused_rti_solve(*jargs, interpret=True, **kw)
    targs = tuple(torch.as_tensor(np.array(a)) for a in jargs)
    stt, lin = K.fused_rti_solve_plain(*targs, return_lin=True, **kw)
    np.testing.assert_allclose(stt.du[:, 0].numpy(), np.asarray(sj.du)[:, 0],
                               rtol=0, atol=2e-3 if iters == 1 else 5e-2)
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


def test_sweeps_refused():
    """The sweeps run since they were ported (tests/test_torch_sweeps.py
    holds them against the JAX package): a "pallas_fused" solver is
    swapped to "pallas" as in the JAX package, never refused, so both
    give the same sweep bit for bit; a QP backend the port lacks is still
    refused."""
    _, ts = _spec_pair(_ocp(8))
    scen = TS.sample_scenarios(2, device=DEV)
    a = TS.disturbance_sweep(ts, _tocp(8, "pallas_fused", 1), scen,
                             n_steps=1)
    b = TS.disturbance_sweep(ts, _tocp(8, "pallas", 1), scen, n_steps=1)
    assert torch.equal(a.final_states, b.final_states)
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 12"):
        TS.fault_sweep(ts, _tocp(8, "condensed"), torch.ones(2, 4))


def jax_offset_free_numbers():
    """The JAX package's own float32 run of chip_smoke.py's phase 13 on the
    CPU: bench.py's offset-free configuration (the simulation preset at
    N=30, Tf 1 s) on its Riccati IPM at 6 iterations, 250 ticks from z=3,
    wind (0.7, -0.5, 0.2): (settle error, wind-estimate error)."""
    pre = jcfg.simulation_preset()
    ocp = dataclasses.replace(pre.ocp, N=30, Tf=1.0, solver=dataclasses.replace(
        pre.ocp.solver, qp_backend="riccati", ipm_iters=6))
    spec = jbuild_spec(ocp, yref=pre.loop.yref, dtype=jnp.float32)
    wind = jnp.asarray([0.7, -0.5, 0.2], jnp.float32)
    res = jax.jit(lambda s, x: JS.offset_free_loop(s, ocp, x, wind,
                                                   n_steps=250))(
        spec, jnp.zeros(17, jnp.float32).at[2].set(3.0))
    settle = np.linalg.norm(np.asarray(res.xs[-1, 0:3])
                            - np.asarray(spec.yref_x[0, 0:3]))
    west = np.linalg.norm(np.asarray(res.d_hist[-1, 0:3]) - np.asarray(wind))
    return float(settle), float(west)


def test_chip_smoke_offset_free_bounds_are_jax_run():
    import chip_smoke
    settle, west = jax_offset_free_numbers()
    assert round(settle, 4) == chip_smoke.OFFSET_FREE_JAX["settle_err_m"]
    assert round(west, 4) == chip_smoke.OFFSET_FREE_JAX["wind_est_err"]
