"""The float32 jet solve vmapped over a trajectory against the same solve
pose by pose, in both packages, on the same poses: 20 ticks of the
aggressive blast scan with the exact plant and the frozen POC (the
simulation preset at N=20 on "riccati", float32, on the CPU).

`sim/tasks.py`'s exact plant runs the unbatched solve, so its belief
x[14:17] equals the port's unbatched solve recomputed bit for bit; the
vmapped solve (`poc/solver.py::true_poc_traj`, batched matrix products)
parts from it by a few float32 ulps of the jet's exp (~9e-6 m each at
150 m/s). The JAX package's own vmapped solve parts from its unbatched one
by as much on the same poses (measured on an 8-core x86 CPU: the port
9.06e-6 m, the JAX package 8.58e-6 m; the test prints both), so the gap is
the reference's semantics, not a fault of the port: held at twice the JAX
package's own gap, and both below 2e-5 m.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import torch

from mpc_blaster_tpu.poc.solver import solve_poc as jsolve
from mpc_blaster_tpu.poc.solver import true_poc_traj as jtrue
from mpc_blaster_tpu_torch import config as cfg
from mpc_blaster_tpu_torch.poc.solver import solve_poc, true_poc_traj
from mpc_blaster_tpu_torch.sim import tasks as TK
from torch_threads import one_intraop_thread  # noqa: F401

DEV = torch.device("cpu")


def test_vmapped_jet_solve_gap_is_the_references():
    pre = cfg.simulation_preset()
    pre = dataclasses.replace(pre, ocp=dataclasses.replace(
        pre.ocp, N=20, Tf=20 / 30.0))
    res = TK.run_blast_scan(pre, n_steps=20, poc_mode="frozen",
                            plant_poc="exact", frozen_at="canonical",
                            device=DEV, z_end=1.2, t_ramp_s=4.0, amp_x=1.1,
                            amp_y=0.45, period_s=24.0)
    xs = res.xs
    assert xs.dtype == torch.float32
    belief = xs[1:, 14:17].numpy()
    vmapped = true_poc_traj(xs).numpy()[1:]
    unbatched = torch.stack([solve_poc(x[3:6], x[12:14], x[0:3])[0]
                             for x in xs[1:]]).numpy()
    assert np.array_equal(unbatched, belief)
    port_gap = float(np.abs(vmapped - unbatched).max())
    jx = jnp.asarray(xs.numpy()[1:])
    jv = np.asarray(jax.jit(jtrue)(jx))
    one = jax.jit(lambda x: jsolve(x[3:6], x[12:14], x[0:3])[0])
    ju = np.stack([np.asarray(one(x)) for x in jx])
    jax_gap = float(np.abs(jv - ju).max())
    print(f"vmapped - unbatched: port {port_gap:.3g} m, JAX {jax_gap:.3g} m")
    assert port_gap <= 2e-5 and jax_gap <= 2e-5, (port_gap, jax_gap)
    assert port_gap <= 2.0 * max(jax_gap, 1e-7), (port_gap, jax_gap)
