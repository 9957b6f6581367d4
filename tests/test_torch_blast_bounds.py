"""The JAX package's own float32 blast-scan rows that chip_smoke.py's
phase 19a holds the port to (`chip_smoke.BLAST_JAX`), recomputed on the
CPU: bench.py's rows (:640-700), the simulation preset at N=60 on its
Riccati IPM at 12 iterations, 300 ticks, the POC rows frozen at the
canonical pose, the mean true-POC error from tick 90 on
(`chip_smoke.blast_settle_err`), to 4 decimals as chip_smoke.py stores it.
Each row is its own JAX program (~20 s on one worker), so the eight rows
are split three, three and two over this file,
tests/test_torch_blast_bounds_aggr.py and
tests/test_torch_blast_bounds_carry.py."""
import numpy as np
import jax.numpy as jnp
import pytest

import chip_smoke
from mpc_blaster_tpu.poc.solver import true_poc_traj
from mpc_blaster_tpu.sim.tasks import run_blast_scan


def jax_blast_err(row: str) -> float:
    """The JAX package's float32 run of chip_smoke.py's blast row `row`,
    rounded as chip_smoke.BLAST_JAX stores it."""
    prof, mode, plant, extra = chip_smoke.BLAST_ROWS[row]
    res = run_blast_scan(poc_mode=mode, plant_poc=plant,
                         n_steps=chip_smoke.BLAST_TICKS, dtype=jnp.float32,
                         frozen_at="canonical",
                         **chip_smoke.BLAST_PROFILES[prof], **extra)
    return round(chip_smoke.blast_settle_err(
        np.asarray(true_poc_traj(res.xs)), np.asarray(res.refs)), 4)


@pytest.mark.parametrize("row", ["blast_true_poc_err_ref_m",
                                 "blast_true_poc_err_anchored_m",
                                 "blast_true_poc_err_stagewise_m"])
def test_chip_smoke_blast_bounds_are_jax_run(row):
    assert jax_blast_err(row) == chip_smoke.BLAST_JAX[row]
