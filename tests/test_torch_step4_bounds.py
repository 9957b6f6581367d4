"""The JAX package's own float32 runs behind chip_smoke.py's phase 20
(`STEP4_JAX`, `STEP4_SPREAD`), recomputed on the CPU to 4 decimals as
chip_smoke.py stores them. This file holds the two cold rows and the
helpers the other tests/test_torch_step4_bounds_*.py files share.

Each row is bench.py's (`rt_runner`, :248-258, with the row's solver
fields: chip_smoke.STEP4_ROWS): the simulation preset at N=20, Tf=20/30,
the fused linearizer, float32. The bench ran it on the Pallas kernel;
these runs put the JAX package's Riccati IPM in its place (the same QP
and Mehrotra algorithm; a 220-tick Pallas interpret run would cost far
more). The figure-8 rows run `make_tracking_loop` on `run_figure8`'s
inputs for 220 ticks and take the max xy error after tick 60 (the
unmoved run is `run_figure8`'s own computation); the altitude rows run
`make_closed_loop(ocp, 200, warm_start=True)` from z=0.5 and take the
overshoot above z=3.5. A warm row's spread is the min and max over the
unmoved run and x0's position moved by each of chip_smoke.STEP4_MOVES_M
along (1, -1, 1); each move changes every moved float32 entry of x0.
"""
import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest

import chip_smoke
from mpc_blaster_tpu import config as jcfg
from mpc_blaster_tpu.ocp.spec import build_spec
from mpc_blaster_tpu.sim.closedloop import make_closed_loop
from mpc_blaster_tpu.sim.tasks import figure8_refs, make_tracking_loop
from torch_threads import one_intraop_thread  # noqa: F401

F32 = jnp.float32


def step4_ocp(row):
    """The JAX package's configuration of a phase-20 row, the Riccati IPM
    in place of the Pallas kernel."""
    pre = jcfg.simulation_preset()
    ocp = dataclasses.replace(pre.ocp, N=20, Tf=20 / 30.0)
    return pre, dataclasses.replace(ocp, solver=dataclasses.replace(
        ocp.solver, qp_backend="riccati", **chip_smoke.step4_fields(row)))


def _moved(x0, move):
    x = np.asarray(x0, np.float32).copy()
    x[0:3] += np.float32(move) * np.array([1, -1, 1], np.float32)
    if move:
        assert (x[0:3] != np.asarray(x0, np.float32)[0:3]).all()
    return jnp.asarray(x)


def jax_step4_values(row, moves=(0.0,)):
    """The row's metric for each move of x0 (one compiled loop)."""
    pre, ocp = step4_ocp(row)
    task, warm, _ = chip_smoke.STEP4_ROWS[row]
    n = chip_smoke.STEP4_TICKS[task]
    out = []
    if task == "fig8":
        refs = figure8_refs(n + ocp.N + 1, ocp.dt)
        spec = build_spec(ocp, dtype=F32)
        run = make_tracking_loop(ocp, n, dtype=F32, warm_start=warm)
        x0 = np.zeros(17)
        x0[0:3] = refs[0, 0:3]
        x0[6:9] = refs[0, 6:9]
        for m in moves:
            res = run(spec, _moved(x0, m), jnp.asarray(refs, F32))
            err = np.linalg.norm(np.asarray(res.xs)[1:, 0:2]
                                 - np.asarray(res.refs)[:, 0:2], axis=1)
            out.append(float(err[60:].max()))
    else:
        spec = build_spec(ocp, yref=pre.loop.yref, dtype=F32)
        run = make_closed_loop(ocp, n, dtype=F32, warm_start=warm)
        x0 = np.zeros(17)
        x0[2] = 0.5
        for m in moves:
            res = run(spec, _moved(x0, m))
            out.append(max(float(np.asarray(res.xs[:, 2]).max()) - 3.5,
                           0.0))
    return out


def check_warm_row(row):
    """The unmoved run and the spread, as chip_smoke.py stores them."""
    vals = jax_step4_values(row, (0.0,) + chip_smoke.STEP4_MOVES_M)
    assert round(vals[0], 4) == chip_smoke.STEP4_JAX[row], vals
    assert (round(min(vals), 4), round(max(vals), 4)) == \
        chip_smoke.STEP4_SPREAD[row], vals


@pytest.mark.parametrize("row", ["fig8_rt6_settle_err_m",
                                 "fig8_rt4_settle_err_m"])
def test_chip_smoke_step4_cold_bounds_are_jax_run(row):
    assert not chip_smoke.STEP4_ROWS[row][1]
    assert row not in chip_smoke.STEP4_SPREAD
    val, = jax_step4_values(row)
    assert round(val, 4) == chip_smoke.STEP4_JAX[row], val
