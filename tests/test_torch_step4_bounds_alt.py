"""chip_smoke.py's phase-20 bound for bench.py's alt_overshoot_warm4shift_m
(the JAX package's own float32 run and its spread, as
tests/test_torch_step4_bounds.py describes); `phase8_solver`, phase 8's
altitude-step chains with the Riccati IPM in place of the kernel, for
tests/test_torch_step4_bounds_altraw.py and _phase8.py."""
import dataclasses

from mpc_blaster_tpu import config as jcfg
from test_torch_step4_bounds import check_warm_row
from torch_threads import one_intraop_thread  # noqa: F401


def phase8_solver(chain):
    fastest = jcfg.deployed_solver("fastest")
    if chain == "raw_watchdog":
        fastest = dataclasses.replace(fastest, ipm_iters=4,
                                      warm_mode="full", warm_shift=False)
    return dataclasses.replace(fastest, qp_backend="riccati")


def test_chip_smoke_step4_alt_warm4shift_bound_is_jax_spread():
    check_warm_row("alt_overshoot_warm4shift_m")
