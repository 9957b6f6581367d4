"""chip_smoke.py's `FASTEST_JAX_M`, recomputed as
tests/test_torch_step4_bounds_loops.py describes."""
import jax.numpy as jnp

import chip_smoke
from mpc_blaster_tpu.ocp.spec import build_spec
from mpc_blaster_tpu.sim.closedloop import (make_closed_loop,
                                            preset_stage_params)
from test_torch_step4_bounds_loops import F32, golden_dist, profile_preset
from torch_threads import one_intraop_thread  # noqa: F401


def test_chip_smoke_fastest_bound_is_jax_run():
    pre = profile_preset("fastest")
    spec = build_spec(pre.ocp, yref=pre.loop.yref,
                      stage_params=preset_stage_params(pre, F32), dtype=F32)
    res = make_closed_loop(pre.ocp, chip_smoke.LOOP_TICKS, dtype=F32,
                           warm_start=True)(spec, jnp.asarray(pre.loop.x0,
                                                              F32))
    assert round(golden_dist(res.xs), 4) == chip_smoke.FASTEST_JAX_M
