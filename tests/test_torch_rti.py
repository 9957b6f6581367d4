"""Port parity of the RTI tick: QP assembly, the single-trajectory tick with
`qp_backend="pallas"` and the batched tick `batched_rti_step(...,
backend="pallas")`, against the JAX package (Pallas in interpret mode).

Tolerances: QP assembly float64 atol 1e-10 / float32 rtol 1e-6 (the same
formulas; measured bit-identical in f32). Ticks use the IPM tolerances of
tests/test_torch_ipm.py: one IPM iteration is held pointwise (u0 atol
2e-3, new iterate atol 5e-3, diagnostics rtol 1e-3); the full budget is
held on the QP objective of the step (1.2e-2 relative), kkt_eq (rtol 0.2
/ atol 1e-3) and the new iterate's bound violation (atol 1e-3), because
the individual rotor thrusts are weakly determined in f32.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mpc_blaster_tpu import config as cfg
from mpc_blaster_tpu.dynamics.blaster import BlasterParams as JBP
from mpc_blaster_tpu.dynamics.blaster import blaster_ode as jode
from mpc_blaster_tpu.dynamics.integrators import discrete_dynamics as jdd
from mpc_blaster_tpu.ocp.spec import build_spec as jbuild_spec
from mpc_blaster_tpu.parallel.mesh import batched_rti_step as jbatched
from mpc_blaster_tpu.qp.data import qp_objective
from mpc_blaster_tpu.sqp import rti as jrti
from mpc_blaster_tpu_torch.convert import (qp_to_numpy, rti_state_from_numpy,
                                           spec_from_numpy)
from mpc_blaster_tpu_torch.dynamics.blaster import BlasterParams, blaster_ode
from mpc_blaster_tpu_torch.dynamics.integrators import discrete_dynamics
from mpc_blaster_tpu_torch.parallel.mesh import batched_rti_step
from mpc_blaster_tpu_torch.sqp import rti as trti

# The port runs on the CUDA card unless asked for the CPU; these tests
# ask for it.
DEV = torch.device("cpu")


def _ocp(N=8, ipm_iters=6):
    base = cfg.simulation_preset().ocp
    return dataclasses.replace(
        base, N=N, Tf=N / 30.0,
        solver=dataclasses.replace(base.solver, qp_backend="pallas",
                                   ipm_iters=ipm_iters))


def _x0s(B, seed=7):
    rng = np.random.default_rng(seed)
    x0s = np.zeros((B, cfg.NX), np.float32)
    x0s[:, 0:3] = rng.uniform(-0.3, 0.3, (B, 3))
    x0s[:, 2] += 1.0
    return x0s


def _spec_pair(ocp, jdtype=jnp.float32, tdtype=torch.float32):
    pre = cfg.simulation_preset()
    js = jbuild_spec(ocp, yref=np.asarray(pre.loop.yref), dtype=jdtype)
    ts = spec_from_numpy({k: np.asarray(v) for k, v in js._asdict().items()},
                         dtype=tdtype, device=DEV)
    return js, ts


def _np(x):
    return {k: np.asarray(v) for k, v in x._asdict().items()}


@pytest.mark.parametrize("prec", ["f64", "f32"])
def test_build_qp_matches_jax(prec):
    jdt, tdt, npdt = ((jnp.float64, torch.float64, np.float64)
                      if prec == "f64" else
                      (jnp.float32, torch.float32, np.float32))
    ocp = _ocp()
    js, ts = _spec_pair(ocp, jdt, tdt)
    x0 = _x0s(1)[0].astype(npdt)
    rng = np.random.default_rng(3)
    jst = jrti.init_rti_state(ocp, jnp.asarray(x0), jdt)
    # a non-trivial iterate: perturb the hover trajectory
    jst = jrti.RTIState(
        xbar=jst.xbar + jnp.asarray(rng.normal(0, 0.05, jst.xbar.shape), jdt),
        ubar=jst.ubar + jnp.asarray(rng.normal(0, 0.5, jst.ubar.shape), jdt))
    tst = rti_state_from_numpy(_np(jst), dtype=tdt, device=DEV)
    np.testing.assert_array_equal(
        trti.init_rti_state(ocp, torch.as_tensor(x0), tdt,
                            device=DEV).ubar.numpy(),
        np.asarray(jrti.init_rti_state(ocp, jnp.asarray(x0), jdt).ubar))
    F, P = jdd(jode, ocp.dt), JBP.from_config(ocp.model, jdt)
    jq = jax.jit(lambda st, x: jrti.build_qp(js, st, x, F, P))(
        jst, jnp.asarray(x0))
    tq = trti.build_qp(ts, tst, torch.as_tensor(x0),
                       discrete_dynamics(blaster_ode, ocp.dt),
                       BlasterParams.from_config(ocp.model, tdt, device=DEV))
    tq = qp_to_numpy(tq)
    rtol, atol = (1e-12, 1e-10) if prec == "f64" else (1e-6, 1e-6)
    for f, a in _np(jq).items():
        np.testing.assert_allclose(tq[f], a, rtol=rtol, atol=atol, err_msg=f)
    # the controller's cost of the iterate, whole and per stage
    from mpc_blaster_tpu.ocp.spec import stage_cost as jstage, \
        total_cost as jtotal
    from mpc_blaster_tpu_torch.ocp.spec import stage_cost, total_cost
    np.testing.assert_allclose(
        total_cost(ts, tst.xbar, tst.ubar).numpy(),
        np.asarray(jtotal(js, jst.xbar, jst.ubar)), rtol=rtol, atol=atol)
    np.testing.assert_allclose(
        stage_cost(ts, tst.xbar[2], tst.ubar[2], 2).numpy(),
        np.asarray(jstage(js, jst.xbar[2], jst.ubar[2], 2)), rtol=rtol,
        atol=atol)


def test_rti_step_matches_jax_one_iteration():
    ocp = _ocp(ipm_iters=1)
    js, ts = _spec_pair(ocp)
    x0 = _x0s(1)[0]
    jst = jrti.init_rti_state(ocp, jnp.asarray(x0))
    u_j, st_j, dg_j = jrti.make_rti_step(ocp)(js, jst, jnp.asarray(x0))
    step = trti.make_rti_step(ocp, device=DEV)
    u_t, st_t, dg_t = step(ts, rti_state_from_numpy(_np(jst), device=DEV),
                           torch.as_tensor(x0))
    np.testing.assert_allclose(u_t.numpy(), np.asarray(u_j), rtol=0,
                               atol=2e-3)
    np.testing.assert_allclose(st_t.xbar.numpy(), np.asarray(st_j.xbar),
                               rtol=0, atol=5e-3)
    np.testing.assert_allclose(st_t.ubar.numpy(), np.asarray(st_j.ubar),
                               rtol=0, atol=5e-3)
    for f in ("qp_kkt_stat", "qp_kkt_eq", "qp_mu", "step_norm_x",
              "step_norm_u", "bound_viol"):
        np.testing.assert_allclose(getattr(dg_t, f).numpy(),
                                   np.asarray(getattr(dg_j, f)), rtol=1e-3,
                                   atol=1e-6, err_msg=f)
    conv = trti.diag_converged(dg_t, ocp.solver)
    assert bool(conv) == bool(jrti.diag_converged(dg_j, ocp.solver))


@pytest.mark.parametrize("ipm_iters", [1, 6])
def test_batched_rti_step_matches_jax(ipm_iters):
    ocp = _ocp(ipm_iters=ipm_iters)
    js, ts = _spec_pair(ocp)
    x0s = _x0s(3)
    jst = jax.vmap(lambda x: jrti.init_rti_state(ocp, x))(jnp.asarray(x0s))
    u_j, st_j, dg_j = jbatched(ocp, jit=False, backend="pallas")(
        js, jst, jnp.asarray(x0s))
    u_t, st_t, dg_t = batched_rti_step(ocp, backend="pallas", device=DEV)(
        ts, trti.init_rti_state(ocp, torch.as_tensor(x0s), device=DEV),
        torch.as_tensor(x0s))
    assert u_t.shape == (3, cfg.NU) and st_t.xbar.shape == st_j.xbar.shape
    if ipm_iters == 1:
        np.testing.assert_allclose(u_t.numpy(), np.asarray(u_j), rtol=0,
                                   atol=2e-3)
        np.testing.assert_allclose(st_t.xbar.numpy(), np.asarray(st_j.xbar),
                                   rtol=0, atol=5e-3)
        for f in dg_t._fields:
            np.testing.assert_allclose(getattr(dg_t, f).numpy(),
                                       np.asarray(getattr(dg_j, f)),
                                       rtol=1e-3, atol=1e-6, err_msg=f)
        return
    # full budget: the QP objective of the step, kkt_eq, bound violation
    F, P = jdd(jode, ocp.dt), JBP.from_config(ocp.model, jnp.float32)
    qps = jax.vmap(lambda st, x: jrti.build_qp(js, st, x, F, P))(
        jst, jnp.asarray(x0s))

    def obj(st_new):
        dx = jnp.asarray(np.asarray(st_new.xbar)) - jst.xbar
        du = jnp.asarray(np.asarray(st_new.ubar)) - jst.ubar
        return np.asarray(jax.vmap(qp_objective)(qps, dx, du))

    oj, ot = obj(st_j), obj(st_t)
    assert (np.abs(ot - oj) / np.maximum(np.abs(oj), 1.0) < 1.2e-2).all(), \
        (ot, oj)
    np.testing.assert_allclose(dg_t.qp_kkt_eq.numpy(),
                               np.asarray(dg_j.qp_kkt_eq), rtol=0.2,
                               atol=1e-3)
    np.testing.assert_allclose(dg_t.bound_viol.numpy(),
                               np.asarray(dg_j.bound_viol), rtol=0,
                               atol=1e-3)
    assert torch.isfinite(st_t.xbar).all() and torch.isfinite(u_t).all()
