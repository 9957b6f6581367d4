"""The recovery loop of tests/test_stress.py:144-164 on the port, on the
CPU: the simulation preset at N=20, Tf=20/30, float32, 90 ticks of
`closed_loop` from (2.4, -2.4, 2.0), 60% outside the +-1.5 m position
box, towards the hover at z=3.5, on the preset's "riccati" (12
iterations). tests/test_torch_stress_recovery_twin.py runs it on the
plain twin of kernel K1 ("pallas").

The loop is an underdamped transient that float32 rounding steers, so it
is held as chip_smoke.py's phase 21 holds it on the card
(`chip_smoke.recovery_checks`): finite, inside the position box on some
tick, and within 0.6 of z=3.5 on some tick of the last 30. The JAX test
holds the last tick, which the JAX package's own float32 loops miss under
moves of x0 by a few float32 ulps (tests/test_torch_stress_bounds.py).
"""
import torch

import chip_smoke
from mpc_blaster_tpu_torch import config as cfg
from mpc_blaster_tpu_torch.ocp.spec import build_spec
from mpc_blaster_tpu_torch.sim.closedloop import closed_loop
from test_torch_stress import DEV, DTYPE, stress_ocp, with_backend
from torch_threads import one_intraop_thread  # noqa: F401


def recovery_loop(backend):
    pre, ocp = stress_ocp()
    ocp = with_backend(ocp, backend)
    spec = build_spec(ocp, yref=pre.loop.yref, dtype=DTYPE, device=DEV)
    x0 = torch.zeros(cfg.NX, dtype=DTYPE)
    x0[0:3] = torch.tensor(chip_smoke.RECOVERY_X0)
    return closed_loop(spec, ocp, x0, n_steps=chip_smoke.RECOVERY_TICKS,
                       dtype=DTYPE).xs


def check_recovery(backend):
    xs = recovery_loop(backend)
    chip_smoke.FAILURES.clear()
    out = chip_smoke.recovery_checks(backend, xs)
    assert not chip_smoke.FAILURES, chip_smoke.FAILURES
    assert out["recovered"], out


def test_closed_loop_recovery_from_outside_box():
    check_recovery("riccati")
