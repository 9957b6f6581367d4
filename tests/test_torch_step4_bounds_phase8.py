"""chip_smoke.py's `ALT_JAX_M["fastest"]`: phase 8's altitude step (the
simulation preset at N=20, Tf=20/30, 200 ticks from z=0.5 towards its
yref) on `deployed_solver("fastest")`, the JAX package's own float32 run
with its Riccati IPM in place of the kernel, recomputed to 4 decimals."""
import dataclasses

import numpy as np
import jax.numpy as jnp

import chip_smoke
from mpc_blaster_tpu import config as jcfg
from mpc_blaster_tpu.ocp.spec import build_spec
from mpc_blaster_tpu.sim.closedloop import make_closed_loop
from test_torch_step4_bounds_alt import phase8_solver
from torch_threads import one_intraop_thread  # noqa: F401


def test_chip_smoke_alt_fastest_bound_is_jax_run():
    pre = jcfg.simulation_preset()
    ocp = dataclasses.replace(pre.ocp, N=20, Tf=20 / 30.0,
                              solver=phase8_solver("fastest"))
    spec = build_spec(ocp, yref=pre.loop.yref, dtype=jnp.float32)
    x0 = jnp.zeros(17, jnp.float32).at[2].set(0.5)
    res = make_closed_loop(ocp, chip_smoke.ALT_TICKS, dtype=jnp.float32,
                           warm_start=True)(spec, x0)
    over = max(float(np.asarray(res.xs[:, 2]).max()) - 3.5, 0.0)
    assert round(over, 4) == chip_smoke.ALT_JAX_M["fastest"], over
