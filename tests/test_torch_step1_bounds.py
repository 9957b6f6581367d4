"""The JAX package's own float32 runs behind chip_smoke.py's phase 19b
(`ALT_COLD6_JAX`, `FIG8_COLD12_JAX`), recomputed on the CPU, to 4
decimals as chip_smoke.py stores them:

  - bench.py's alt_overshoot_cold6_m (:566-575): the simulation preset at
    N=20 with its yref, 200 cold ticks from z=0.5, the fused linearizer, 6
    IPM iterations; the bench ran it on the Pallas kernel, this run on
    the JAX Riccati IPM (the same QP and Mehrotra algorithm; a 200-tick
    Pallas interpret run would cost far more);
  - bench.py's fig8_cold12_settle_err_m (:551-557): `run_figure8` on the
    simulation preset at N=20, the JAX Riccati IPM at 12 iterations, 220
    ticks, the max xy error after tick 60.
"""
import dataclasses

import numpy as np
import jax.numpy as jnp

import chip_smoke
from mpc_blaster_tpu import config as jcfg
from mpc_blaster_tpu.ocp.spec import build_spec
from mpc_blaster_tpu.sim.closedloop import make_closed_loop
from mpc_blaster_tpu.sim.tasks import run_figure8
from torch_threads import one_intraop_thread  # noqa: F401


def _n20(**solver):
    pre = jcfg.simulation_preset()
    ocp = dataclasses.replace(pre.ocp, N=20, Tf=20 / 30.0)
    return pre, dataclasses.replace(ocp, solver=dataclasses.replace(
        ocp.solver, qp_backend="riccati", **solver))


def test_chip_smoke_alt_cold6_bound_is_jax_run():
    pre, ocp = _n20(ipm_iters=6, lin_backend="fused")
    spec = build_spec(ocp, yref=pre.loop.yref, dtype=jnp.float32)
    x0 = jnp.zeros(17, jnp.float32).at[2].set(0.5)
    res = make_closed_loop(ocp, chip_smoke.ALT_COLD6_TICKS,
                           dtype=jnp.float32)(spec, x0)
    over = max(float(np.asarray(res.xs[:, 2]).max()) - 3.5, 0.0)
    assert round(over, 4) == chip_smoke.ALT_COLD6_JAX


def test_chip_smoke_fig8_cold12_bound_is_jax_run():
    pre, ocp = _n20(ipm_iters=12)
    fig = run_figure8(dataclasses.replace(pre, ocp=ocp),
                      n_steps=chip_smoke.FIG8_COLD12_TICKS,
                      dtype=jnp.float32)
    err = np.linalg.norm(np.asarray(fig.xs)[1:, 0:2]
                         - np.asarray(fig.refs)[:, 0:2], axis=1)
    assert round(float(err[60:].max()), 4) == chip_smoke.FIG8_COLD12_JAX
