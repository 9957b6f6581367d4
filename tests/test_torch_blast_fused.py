"""Port parity of one online_stagewise blast-scan tick on the deployed
one-launch backend (`qp_backend="pallas_fused"`, the fuse_lin kernel K6's
plain twin on the CPU) against the JAX package's Pallas kernel in
interpret mode, float32, N=8: the first tick whose stage parameters
differ from stage to stage (each node's POC rows linearized at its own
predicted pose).

Tolerances and why:
  - the per-stage parameters: the port's vmapped jet solves within 2e-5
    of the JAX package's in float32 (12 Newton steps through float32
    exponentials; measured 2.4e-6 on Jacobian entries up to 23);
  - one IPM iteration pointwise: u0 atol 2e-3, the new iterate atol
    5e-3, the diagnostics rtol 1e-3 (tests/test_torch_fused.py: every
    phase has run once, the f32 solvers agree to rounding);
  - 12 iterations, PERF.md's rule for full f32 solves: the step's QP
    objective within 1e-2 relative (tests/test_torch_fused.py's B=1
    bound), kkt_eq within rtol 0.2 / atol 1e-3 and the new iterate's box
    violation within 1e-3 (tests/test_batched_fused.py), not u0 or mu:
    past a few iterations the rotor split is weakly determined in f32,
    and 12 iterations do not converge this tick's QP (measured: u0 2.1e-2
    N apart with one rotor near its lower bound, mu 0.44 and 0.11, the
    objectives agreeing).
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
from mpc_blaster_tpu.dynamics.blaster import pack_stage_params as jpack
from mpc_blaster_tpu.dynamics.integrators import discrete_dynamics as jdd
from mpc_blaster_tpu.dynamics.fastlin import make_fused_linearizer as jmfl
from mpc_blaster_tpu.ocp.spec import build_spec as jbuild_spec
from mpc_blaster_tpu.poc.solver import PocSolver as JPocSolver
from mpc_blaster_tpu.poc.solver import poc_jacobians as jpoc_jac
from mpc_blaster_tpu.qp.data import qp_objective
from mpc_blaster_tpu.sqp import rti as jrti
from mpc_blaster_tpu_torch import config as cfg
from mpc_blaster_tpu_torch.convert import rti_state_from_numpy, spec_from_numpy
from mpc_blaster_tpu_torch.ops import box_qp_ipm as K
from mpc_blaster_tpu_torch.poc.solver import poc_stage_params_along
from mpc_blaster_tpu_torch.sim.tasks import blast_scan_refs
from mpc_blaster_tpu_torch.sqp import rti as trti

# The port runs on the CUDA card unless asked for the CPU; these tests
# ask for it.
DEV = torch.device("cpu")
N = 8


def _np(x):
    return {k: np.asarray(v) for k, v in x._asdict().items()}


def _tick_inputs(ipm_iters):
    """The aggressive scan's first window, the POC rows frozen at the
    canonical pose, and an iterate whose nodes sit at different poses, as
    a scan's predicted trajectory does."""
    base = jcfg.simulation_preset().ocp
    ocp = dataclasses.replace(
        base, N=N, Tf=N / 30.0, solver=dataclasses.replace(
            base.solver, qp_backend="pallas_fused", ipm_iters=ipm_iters))
    refs = blast_scan_refs(N + 2, ocp.dt, z_end=1.2, t_ramp_s=4.0,
                           amp_x=1.1, amp_y=0.45, period_s=24.0)
    p = jpack(*JPocSolver().initialise().get_jacobians(), 2.2 * 9.81)
    js = jbuild_spec(ocp, stage_params=np.asarray(p), dtype=jnp.float32)
    js = js._replace(yref_x=jnp.asarray(refs[1:N + 1], jnp.float32),
                     yref_e=jnp.asarray(refs[N], jnp.float32))
    x0 = np.zeros(17, np.float32)
    x0[2] = 3.5
    x0[12:14] = (0.2, -0.1)
    # the iterate: the rollout of a slow descent with the gimbal turning
    # at its rate bounds, so each node's pose (and its POC rows) differ
    F = jdd(jode, ocp.dt)
    P = JBP.from_config(ocp.model, jnp.float32)
    u = np.zeros(6, np.float32)
    u[0:4] = 0.97 * (9.0 - 2.2) * 9.81 / 4.0
    u[4:6] = (0.087, -0.087)
    xs = [jnp.asarray(x0)]
    for _ in range(N):
        xs.append(F(xs[-1], jnp.asarray(u), js.stage_params[0], P))
    st = jrti.RTIState(xbar=jnp.stack(xs),
                       ubar=jnp.tile(jnp.asarray(u)[None], (N, 1)))
    return ocp, js, st, x0


@pytest.mark.parametrize("ipm_iters", [1, 12])
def test_online_stagewise_fused_tick_matches_jax_f32(ipm_iters):
    ocp, js, jst, x0 = _tick_inputs(ipm_iters)
    pc = jcfg.PocSolverConfig()

    def params_at(x):
        return jpack(*jpoc_jac(x[3:6], x[12:14], x[0:3], pc.stream_velocity,
                               pc.drag, pc.newton_iters),
                     js.stage_params[0, -1]).astype(jnp.float32)
    jp = jax.vmap(params_at)(jst.xbar[:-1])
    tst = rti_state_from_numpy(_np(jst), device=DEV)
    tp = poc_stage_params_along(tst.xbar[:-1],
                                torch.tensor(float(js.stage_params[0, -1])),
                                cfg.PocSolverConfig())
    assert tp.dtype == torch.float32 and tp.shape == (N, 25)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=0, atol=2e-5)
    # every stage its own row
    assert (np.abs(np.diff(np.asarray(jp), axis=0)).max(axis=1) > 1e-3).all()
    js = js._replace(stage_params=jp)
    ts = spec_from_numpy(_np(js), device=DEV)
    u_j, st_j, dg_j = jrti.make_rti_step(ocp, jit=False)(js, jst,
                                                         jnp.asarray(x0))
    n0 = K.fused_rti_solve.launches
    u_t, st_t, dg_t = trti.make_rti_step(ocp, device=DEV)(
        ts, tst, torch.as_tensor(x0))
    assert K.fused_rti_solve.launches == n0   # CPU: the plain twin
    if ipm_iters == 1:
        np.testing.assert_allclose(u_t.numpy(), np.asarray(u_j), rtol=0,
                                   atol=2e-3)
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
    np.testing.assert_allclose(float(dg_t.qp_kkt_eq), float(dg_j.qp_kkt_eq),
                               rtol=0.2, atol=1e-3)
    np.testing.assert_allclose(float(dg_t.bound_viol), float(dg_j.bound_viol),
                               rtol=0, atol=1e-3)
