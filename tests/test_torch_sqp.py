"""Port parity of the multi-iteration SQP (`sqp/rti.py::sqp_solve`)
against the JAX package, in float64 on the "riccati" backend, on the hover
problem of tests/test_sqp_sim.py:17-50.

Tolerances and why:
  - `sqp_solve` at hover (N=60, 12 iterations): the best iterate within
    1e-6 (measured 1.2e-9), the first three step norms within 1e-6
    (measured 2.2e-7); past them the f64 iterates limit-cycle in the
    gimbal-rate box (steps of 2 x 0.0873 on both sides, the best-iterate
    rule's reason), and tests/test_sqp_sim.py:28-50's criteria.
"""
import dataclasses

import numpy as np
import jax.numpy as jnp
import torch

from mpc_blaster_tpu import config as jcfg
from mpc_blaster_tpu.dynamics.blaster import BlasterParams as JBP
from mpc_blaster_tpu.dynamics.blaster import blaster_ode as jode
from mpc_blaster_tpu.dynamics.integrators import discrete_dynamics as jdd
from mpc_blaster_tpu.ocp.spec import build_spec as jbuild_spec
from mpc_blaster_tpu.sqp import rti as jrti
from mpc_blaster_tpu_torch import config as cfg
from mpc_blaster_tpu_torch import convert
from mpc_blaster_tpu_torch.dynamics.blaster import BlasterParams, blaster_ode
from mpc_blaster_tpu_torch.dynamics.integrators import discrete_dynamics
from mpc_blaster_tpu_torch.sqp import rti as trti
from torch_threads import one_intraop_thread  # noqa: F401

# The port runs on the CUDA card unless asked for the CPU; these tests
# ask for it.
DEV = torch.device("cpu")
F64 = torch.float64


def _np(x):
    return {k: np.asarray(v) for k, v in x._asdict().items()}


def _hover(c, N=60):
    """tests/test_sqp_sim.py:17-26's hover problem at horizon N."""
    pre = c.simulation_preset()
    ocp = dataclasses.replace(pre.ocp, N=N, Tf=N / 30.0)
    x0 = np.zeros(17)
    x0[2] = 2.0
    yref = np.zeros(23)
    yref[2] = 2.0
    return ocp, yref, x0


def test_sqp_solve_matches_jax_f64():
    jocp, yref, x0 = _hover(jcfg)
    tocp, _, _ = _hover(cfg)
    js = jbuild_spec(jocp, yref=yref, dtype=jnp.float64)
    ts = convert.spec_from_numpy(_np(js), dtype=F64, device=DEV)
    jbest, jnorms = jrti.sqp_solve(
        js, jrti.init_rti_state(jocp, jnp.asarray(x0), jnp.float64),
        jnp.asarray(x0), JBP.from_config(jocp.model, jnp.float64),
        jdd(jode, jocp.dt), jocp.solver, iters=12)
    tbest, tnorms = trti.sqp_solve(
        ts, trti.init_rti_state(tocp, torch.as_tensor(x0), F64),
        torch.as_tensor(x0), BlasterParams.from_config(tocp.model, F64,
                                                       device=DEV),
        discrete_dynamics(blaster_ode, tocp.dt), tocp.solver, iters=12)
    assert tnorms.shape == (12,)
    np.testing.assert_allclose(tnorms[:3].numpy(), np.asarray(jnorms)[:3],
                               rtol=0, atol=1e-6)
    assert bool((tnorms[3:] <= 2 * 0.0872665 + 1e-6).all())
    np.testing.assert_allclose(tbest.xbar.numpy(), np.asarray(jbest.xbar),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(tbest.ubar.numpy(), np.asarray(jbest.ubar),
                               rtol=0, atol=1e-6)
    # tests/test_sqp_sim.py:28-50's criteria
    assert float(tnorms[-1]) < 1.0
    u0 = tbest.ubar[0].numpy()
    np.testing.assert_allclose(u0[0:4], (9.0 - 2.2) * 9.81 / 4.0, rtol=2e-3)
    assert np.abs(u0[4:6]).max() <= 0.0872665 + 1e-9
    assert np.abs(tbest.xbar[:, 12:14].numpy()).max() < 0.02
    np.testing.assert_allclose(tbest.xbar[:, 2].numpy(), 2.0, atol=2e-2)
