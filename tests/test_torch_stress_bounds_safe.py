"""tests/test_torch_stress_bounds.py's check on the JAX package's loops
at `deployed_solver("safe")`'s budget."""
from test_torch_stress_bounds import check_jax_recovery
from torch_threads import one_intraop_thread  # noqa: F401


def test_jax_safe_recovery_loops_meet_chip_smoke_criteria():
    check_jax_recovery("safe_6")
