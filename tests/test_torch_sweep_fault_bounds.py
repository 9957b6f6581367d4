"""The JAX package's own float32 fault sweeps that chip_smoke.py's phase
17 holds the port to (`chip_smoke.SWEEP_JAX`), recomputed on the CPU as
tests/test_torch_sweep_bounds.py recomputes the wind sweeps': the
simulation preset at N=60 under `deployed_solver("safe")` with
`qp_backend="riccati"`, tests/test_scenarios.py's four rotor deratings,
150 ticks, blind and offset-free."""
import pytest

import chip_smoke
from test_torch_sweep_bounds import jax_sweep_numbers


@pytest.mark.parametrize("name", ["fault_blind", "fault_offset_free"])
def test_chip_smoke_fault_sweep_bounds_are_jax_run(name):
    ref = chip_smoke.SWEEP_JAX[name]
    assert jax_sweep_numbers(name) == (ref["pos_err_m"], ref["worst_kkt_eq"])
