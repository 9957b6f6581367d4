"""The aggressive blast-scan rows of `chip_smoke.BLAST_JAX` without the
co-moving reference, recomputed on the CPU as
tests/test_torch_blast_bounds.py recomputes the gentle ones."""
import pytest

import chip_smoke
from test_torch_blast_bounds import jax_blast_err


@pytest.mark.parametrize("row", ["blast_aggr_err_frozen_m",
                                 "blast_aggr_err_online_m",
                                 "blast_aggr_err_stagewise_m"])
def test_chip_smoke_aggressive_blast_bounds_are_jax_run(row):
    assert jax_blast_err(row) == chip_smoke.BLAST_JAX[row]
