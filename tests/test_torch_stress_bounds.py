"""The recovery criteria of chip_smoke.py's phase 21
(`chip_smoke.recovery_checks`) hold for the JAX package's own float32
loops: tests/test_stress.py:144-164's loop (the simulation preset at
N=20, Tf=20/30, 90 ticks of `closed_loop` from (2.4, -2.4, 2.0) towards
its yref) on its Riccati IPM at the preset's 12 iterations and at
`deployed_solver("safe")`'s budget (6 iterations, the fused linearizer),
each run vmapped over 32 starts (the "safe" runs in
tests/test_torch_stress_bounds_safe.py): x0's position moved along (1,
-1, 1) by -4e-6 to +3.75e-6 m in steps of 2.5e-7 m. Every run enters the
position box and comes within 0.6 of z=3.5 in the last 30 ticks. The JAX
test's own criteria at the last tick do not hold over the same runs
(measured on the CPU: at 12 iterations 50% of them end more than 0.6
from z=3.5; under "safe" none ends inside the box), which is why the
port is held to the criteria over the loop."""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import torch

import chip_smoke
from mpc_blaster_tpu import config as jcfg
from mpc_blaster_tpu.ocp.spec import build_spec
from mpc_blaster_tpu.sim.closedloop import closed_loop
from torch_threads import one_intraop_thread  # noqa: F401

F32 = jnp.float32
MOVES_M = np.arange(-16, 16) * 2.5e-7


def jax_recovery_runs(solver):
    """The loop's states (32, 91, 17) over the moved starts."""
    pre = jcfg.simulation_preset()
    ocp = dataclasses.replace(pre.ocp, N=20, Tf=20 / 30.0, solver=solver)
    spec = build_spec(ocp, yref=pre.loop.yref, dtype=F32)
    x0 = np.zeros(17, np.float32)
    x0[0:3] = chip_smoke.RECOVERY_X0
    starts = np.stack([x0 + np.float32(m) * np.array([1, -1, 1] + [0] * 14,
                                                     np.float32)
                       for m in MOVES_M])
    run = jax.jit(jax.vmap(lambda x: closed_loop(
        spec, ocp, x, n_steps=chip_smoke.RECOVERY_TICKS, dtype=F32).xs))
    return np.asarray(run(jnp.asarray(starts)))


def check_jax_recovery(profile):
    if profile == "safe_6":
        solver = dataclasses.replace(jcfg.deployed_solver("safe"),
                                     qp_backend="riccati")
    else:
        solver = jcfg.simulation_preset().ocp.solver
    runs = jax_recovery_runs(solver)
    chip_smoke.FAILURES.clear()
    outs = [chip_smoke.recovery_checks(profile, torch.tensor(xs))
            for xs in runs]
    assert not chip_smoke.FAILURES, chip_smoke.FAILURES[:3]
    assert all(o["recovered"] for o in outs)
    # the last tick's criteria are not robust over the same runs
    end_ok = [o["end_in_box"] and o["end_z_err"] < 0.6 for o in outs]
    assert not all(end_ok)


def test_jax_recovery_loops_meet_chip_smoke_criteria():
    check_jax_recovery("preset_12")
