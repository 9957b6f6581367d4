"""chip_smoke.py's phase-20 bound for bench.py's fig8_warm4shift_err_m: the
JAX package's own float32 run and its spread over moves of x0,
recomputed as tests/test_torch_step4_bounds.py describes."""
from test_torch_step4_bounds import check_warm_row
from torch_threads import one_intraop_thread  # noqa: F401


def test_chip_smoke_step4_warm4shift_bound_is_jax_spread():
    check_warm_row("fig8_warm4shift_err_m")
