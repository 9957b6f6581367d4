"""chip_smoke.py's phase-20 bound for bench.py's alt_overshoot_warmraw_wd_m
(the JAX package's own float32 run and its spread, as
tests/test_torch_step4_bounds.py describes) and phase 8's
`ALT_JAX_M["raw_watchdog"]`: the altitude step from z=0.5 on
`deployed_solver("fastest")` with 4 iterations, warm_mode "full" and no
shift, the JAX package's Riccati IPM in place of the kernel. That chain
is bench.py's row's configuration field for field, so one run gives both
constants."""
import chip_smoke
from test_torch_step4_bounds import check_warm_row, step4_ocp
from test_torch_step4_bounds_alt import phase8_solver
from torch_threads import one_intraop_thread  # noqa: F401


def test_chip_smoke_step4_alt_warmraw_bound_is_jax_spread():
    _, ocp = step4_ocp("alt_overshoot_warmraw_wd_m")
    assert ocp.solver == phase8_solver("raw_watchdog")
    check_warm_row("alt_overshoot_warmraw_wd_m")
    assert chip_smoke.ALT_JAX_M["raw_watchdog"] == \
        chip_smoke.STEP4_JAX["alt_overshoot_warmraw_wd_m"]
