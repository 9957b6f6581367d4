"""The recovery loop of tests/test_torch_stress_recovery.py on
`qp_backend="pallas"`: kernel K1's plain twin on the CPU, 12 iterations,
held to the same criteria."""
from test_torch_stress_recovery import check_recovery
from torch_threads import one_intraop_thread  # noqa: F401


def test_closed_loop_recovery_from_outside_box_on_k1_twin():
    check_recovery("pallas")
