"""The JAX package's own float32 wind sweeps that chip_smoke.py's phase 17
holds the port to (`chip_smoke.SWEEP_JAX`), recomputed on the CPU: the
simulation preset at N=60 under `deployed_solver("safe")` with
`qp_backend="riccati"` (the JAX Riccati IPM at the same 6 iterations),
tests/test_scenarios.py's 8 wind scenarios, 150 ticks, blind and
offset-free. Each number as chip_smoke.py stores it, to 4 decimals. The
fault sweeps' numbers are recomputed in
tests/test_torch_sweep_fault_bounds.py. Each sweep is its own JAX program
(a compile of 11-13 s and its 150 ticks, ~20 s on one worker), so nothing
is shared between them and the four are split over two files."""
import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest

import chip_smoke
from mpc_blaster_tpu import config as jcfg
from mpc_blaster_tpu.ocp.spec import build_spec
from mpc_blaster_tpu.sim import scenarios as JS
from torch_threads import one_intraop_thread  # noqa: F401


def jax_sweep_numbers(name):
    """(per-scenario position errors, worst kkt_eq) of the JAX package's
    float32 run of chip_smoke.py's phase-17 sweep `name`, rounded as
    chip_smoke.SWEEP_JAX stores them."""
    res = _run(name)
    return ([round(float(e), 4) for e in np.asarray(res.pos_err)],
            round(float(np.asarray(res.worst_kkt_eq).max()), 4))


def _run(name):
    pre = jcfg.simulation_preset()
    ocp = dataclasses.replace(pre.ocp, solver=dataclasses.replace(
        jcfg.deployed_solver("safe"), qp_backend="riccati"))
    spec = build_spec(ocp, yref=pre.loop.yref, dtype=jnp.float32)
    kw = dict(n_steps=chip_smoke.SWEEP_TICKS, dtype=jnp.float32,
              offset_free=name.endswith("offset_free"))
    if name.startswith("wind"):
        return JS.disturbance_sweep(
            spec, ocp, JS.sample_scenarios(batch=8, seed=1, wind_max=0.8),
            **kw)
    return JS.fault_sweep(spec, ocp, np.asarray(chip_smoke.FAULT_DERATE),
                          **kw)


@pytest.mark.parametrize("name", ["wind_blind", "wind_offset_free"])
def test_chip_smoke_sweep_bounds_are_jax_run(name):
    ref = chip_smoke.SWEEP_JAX[name]
    assert jax_sweep_numbers(name) == (ref["pos_err_m"], ref["worst_kkt_eq"])
