"""The aggressive blast-scan rows of `chip_smoke.BLAST_JAX` with the
co-moving reference (carry_frac 0.6, and both rules on "auto", which
choose online_stagewise and 0.6 there), recomputed on the CPU as
tests/test_torch_blast_bounds.py recomputes the gentle ones."""
import pytest

import chip_smoke
from test_torch_blast_bounds import jax_blast_err
from torch_threads import one_intraop_thread  # noqa: F401


@pytest.mark.parametrize("row", ["blast_aggr_err_carry_m",
                                 "blast_aggr_err_auto_m"])
def test_chip_smoke_carry_blast_bounds_are_jax_run(row):
    assert jax_blast_err(row) == chip_smoke.BLAST_JAX[row]
