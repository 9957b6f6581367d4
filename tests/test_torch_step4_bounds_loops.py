"""chip_smoke.py's `SAFE_JAX_M` (and, in
tests/test_torch_step4_bounds_fastest.py, `FASTEST_JAX_M`): the JAX
package's own float32 closed loops of phases 6 and 7 on the CPU, its
Riccati IPM in place of the kernel, recomputed to 4 decimals. The
simulation preset at its N=60, 100 ticks from its x0:
`deployed_solver("safe")` through `run_preset(..., with_poc=True)`, and
`deployed_solver("fastest")` as the warm chain of
`make_closed_loop(..., warm_start=True)` with the preset's POC stage
parameters; each the max position distance from
tests/golden/simulation_poc_100.npz.

`SAFE_JAX_M` was taken with JAX's 64-bit types off, so that
`run_preset(with_poc=True)` solves the POC Jacobians in float32; it is
recomputed so. With them on (this suite's setting) the Jacobians are
solved in float64 and cast, as the port solves them, and the loop ends
0.1428 m from the golden (measured on the CPU): the bound the card is
held to is the tighter of the two.
"""
import dataclasses
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp

import chip_smoke
from mpc_blaster_tpu import config as jcfg
from mpc_blaster_tpu.sim.closedloop import run_preset
from torch_threads import one_intraop_thread  # noqa: F401

GOLDEN = Path(__file__).resolve().parent / "golden" / "simulation_poc_100.npz"
F32 = jnp.float32


def profile_preset(profile):
    pre = jcfg.simulation_preset()
    return dataclasses.replace(pre, ocp=dataclasses.replace(
        pre.ocp, solver=dataclasses.replace(jcfg.deployed_solver(profile),
                                            qp_backend="riccati")))


def golden_dist(xs):
    xs = np.asarray(xs)
    golden = np.load(GOLDEN)["xs"][:xs.shape[0]]
    return float(np.abs(xs[:, 0:3] - golden[:, 0:3]).max())


def test_chip_smoke_safe_bound_is_jax_run():
    pre = profile_preset("safe")
    with jax.enable_x64(False):
        res = run_preset(pre, n_steps=chip_smoke.LOOP_TICKS, dtype=F32,
                         with_poc=True)
    assert round(golden_dist(res.xs), 4) == chip_smoke.SAFE_JAX_M
