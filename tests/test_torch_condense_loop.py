"""`qp_backend="condensed"` end to end in the port: tests/test_condense.py's
simulation-preset QP (N=60, M=5) against the JAX package, its condensed
closed loop (N=30, M=5, 15 ticks) in float64 and float32, and the warm
start it refuses.

Tolerances (tests/test_condense.py's): on the N=60 QP the condensed
objective within rel 1e-5 of the full-horizon Riccati IPM's, the
strongly determined channels du[:, :4] within 0.3 N, kkt_eq < 1e-6, and
the port's condensed objective within rel 1e-9 of the JAX condensed one
(the same arithmetic in f64; du is weakly determined in the gimbal chain,
so it is compared at 1e-6). The closed loop: the vehicle states within
1.5e-2 (f64) and 2e-2 (f32) of the f64 "riccati" loop. The first tick's
QP of the short N=8 loop of tests/test_torch_closedloop.py: the objective
within rel 1e-10 of JAX's, du and the merit within the spread a few-ulp
perturbation of the QP gives JAX's own solve.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mpc_blaster_tpu_torch import config as cfg
from mpc_blaster_tpu_torch.qp.condense import condensed_qp_solve
from mpc_blaster_tpu_torch.qp.data import qp_objective
from mpc_blaster_tpu_torch.qp.ipm import box_qp_solve
from mpc_blaster_tpu_torch.sim.closedloop import run_preset
from torch_threads import one_intraop_thread  # noqa: F401

DEV = torch.device("cpu")


def _blaster_qp(DTYPE):
    from mpc_blaster_tpu_torch.dynamics.blaster import (BlasterParams,
                                                        blaster_ode)
    from mpc_blaster_tpu_torch.dynamics.integrators import discrete_dynamics
    from mpc_blaster_tpu_torch.ocp.spec import build_spec
    from mpc_blaster_tpu_torch.sqp.rti import build_qp, init_rti_state
    ocp = cfg.simulation_preset().ocp
    x0 = np.zeros(cfg.NX)
    x0[2] = 2.0
    yref = np.zeros(cfg.NY)
    yref[:3] = (0.4, 0.0, 3.0)
    spec = build_spec(ocp, yref=yref, dtype=DTYPE, device=DEV)
    x0 = torch.as_tensor(x0, dtype=DTYPE)
    params = BlasterParams.from_config(ocp.model, DTYPE, DEV)
    F = discrete_dynamics(blaster_ode, ocp.dt, num_steps=1)
    return build_qp(spec, init_rti_state(ocp, x0, DTYPE), x0, F, params)


def test_condensed_blaster_rti_qp():
    """One simulation-preset RTI QP (N=60), condensed with M=5 (Nc=12),
    against the Riccati IPM and the JAX condensed solve on the same QP."""
    from mpc_blaster_tpu.qp.condense import condensed_qp_solve as jsolve
    from mpc_blaster_tpu.qp.data import QPData as JQP
    qp = _blaster_qp(torch.float64)
    ref = box_qp_solve(qp, iters=25)
    sol = condensed_qp_solve(qp, M=5, iters=25)
    o_ref = float(qp_objective(qp, ref.dx, ref.du))
    o_cond = float(qp_objective(qp, sol.dx, sol.du))
    assert o_cond == pytest.approx(o_ref, rel=1e-5)
    np.testing.assert_allclose(sol.du[:, :4].numpy(), ref.du[:, :4].numpy(),
                               atol=0.3)
    assert float(sol.kkt_eq) < 1e-6
    jqp = JQP(*(jnp.asarray(x.numpy()) for x in qp))
    js = jax.jit(lambda d: jsolve(d, M=5, iters=25))(jqp)
    o_j = float(qp_objective(qp, torch.as_tensor(np.asarray(js.dx)),
                             torch.as_tensor(np.asarray(js.du))))
    assert o_cond == pytest.approx(o_j, rel=1e-9)
    np.testing.assert_allclose(sol.du.numpy(), np.asarray(js.du), rtol=0,
                               atol=1e-6)


def _presets():
    pre = cfg.simulation_preset()
    pre = dataclasses.replace(
        pre, ocp=dataclasses.replace(pre.ocp, N=30, Tf=1.0))
    pc = dataclasses.replace(pre, ocp=dataclasses.replace(
        pre.ocp, solver=dataclasses.replace(pre.ocp.solver,
                                            qp_backend="condensed",
                                            cond_M=5)))
    return pre, pc


@pytest.fixture(scope="module")
def riccati_loop():
    pre, _ = _presets()
    return run_preset(pre, n_steps=15, with_poc=False, dtype=torch.float64,
                      device=DEV)


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1.5e-2),
                                       (torch.float32, 2e-2)])
def test_condensed_backend_closed_loop(riccati_loop, dtype, tol):
    """qp_backend='condensed' threads through the whole stack: the short
    hover closed loop matches the riccati backend's f64 loop on the
    vehicle channels (the gimbal chain is weakly determined)."""
    _, pc = _presets()
    res = run_preset(pc, n_steps=15, with_poc=False, dtype=dtype, device=DEV)
    assert torch.isfinite(res.xs).all()
    np.testing.assert_allclose(res.xs[:, :12].double().numpy(),
                               riccati_loop.xs[:, :12].numpy(), rtol=0,
                               atol=tol)


def test_condensed_tick_qp_weakly_determined(monkeypatch):
    """Why tests/test_torch_closedloop.py holds the condensed loop's first
    tick at 1e-3 N: the 12-iteration condensed solve of that tick's QP
    (the simulation preset at N=8, cond_M=4, with the POC) is weakly
    determined in du. On the same QP the port's solve and the JAX
    package's jitted one agree in objective to rel 1e-10 (measured
    2.4e-13 on an 8-core x86 CPU), and their du part by 1.3e-3 N; a
    perturbation of every QP entry by a few ulps moves JAX's own solve as
    far (1.3e-3 to 3.9e-3 N over four draws), so the port's du and merit
    are held within that spread, and the spread is shown to reach 1e-3 N.
    More iterations change nothing: the best-merit iterate is found
    before the 11th and kept."""
    from functools import partial
    from mpc_blaster_tpu.qp.condense import condensed_qp_solve as jcsolve
    from mpc_blaster_tpu.qp.ipm import QPData as JQPData
    import mpc_blaster_tpu_torch.sqp.rti as R
    pre = cfg.simulation_preset()
    ocp = dataclasses.replace(pre.ocp, N=8, Tf=8 / 30.0,
                              solver=dataclasses.replace(
                                  pre.ocp.solver, qp_backend="condensed",
                                  cond_M=4))
    seen = []

    def spy(qp, **kw):
        sol = condensed_qp_solve(qp, **kw)
        seen.append((qp, kw, sol))
        return sol
    monkeypatch.setattr(R, "condensed_qp_solve", spy)
    run_preset(dataclasses.replace(pre, ocp=ocp), n_steps=1,
               dtype=torch.float64, with_poc=True, device=DEV)
    qp, kw, sol = seen[0]
    assert kw["iters"] == 12 and kw["M"] == 4
    jqp = JQPData(*(jnp.asarray(f.numpy()) for f in qp))
    jsolve = jax.jit(partial(jcsolve, **kw))
    js = jsolve(jqp)

    def obj(s):
        return float(qp_objective(qp, torch.as_tensor(np.asarray(s.dx)),
                                  torch.as_tensor(np.asarray(s.du))))

    def merit(s):
        return float(s.kkt_stat) + float(s.kkt_eq) + float(s.mu)
    assert float(qp_objective(qp, sol.dx, sol.du)) == pytest.approx(
        obj(js), rel=1e-10)
    du_gap = np.abs(sol.du.numpy() - np.asarray(js.du)).max()
    du_moves, merit_moves = [], []
    for seed in range(4):
        rng = np.random.default_rng(seed)
        jp = jsolve(JQPData(*(
            f * (1 + np.finfo(np.float64).eps * rng.standard_normal(f.shape))
            for f in jqp)))
        du_moves.append(np.abs(np.asarray(jp.du) - np.asarray(js.du)).max())
        merit_moves.append(abs(merit(jp) - merit(js)))
    assert max(du_moves) >= 1e-3, du_moves
    assert du_gap <= max(du_moves), (du_gap, du_moves)
    assert abs(merit(sol) - merit(js)) <= max(merit_moves)


def test_condensed_warm_start_refused():
    """Condensed solves are cold: a slack/dual warm start raises
    ValueError, in the QP dispatch and in the warm closed loop, as in the
    JAX package."""
    from mpc_blaster_tpu_torch.ocp.spec import build_spec
    from mpc_blaster_tpu_torch.qp.ipm import IpmWarmStart
    from mpc_blaster_tpu_torch.sim.closedloop import closed_loop
    from mpc_blaster_tpu_torch.sqp.rti import solve_qp_backend
    _, pc = _presets()
    ocp = dataclasses.replace(pc.ocp, N=10, Tf=10 / 30.0)
    qp = _blaster_qp(torch.float64)
    warm = IpmWarmStart.zeros(60, cfg.NX, cfg.NU, torch.float64, DEV)
    with pytest.raises(ValueError, match="condensed"):
        solve_qp_backend(qp, ocp.solver, warm=warm)
    with pytest.raises(ValueError, match="condensed"):
        closed_loop(build_spec(ocp, device=DEV), ocp, np.zeros(cfg.NX), 1,
                    warm_start=True)
