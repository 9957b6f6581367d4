"""The float32 scenario sweep tick against the JAX package.

One tick of `disturbance_sweep(offset_free=True)` under
`deployed_solver("safe")` ("pallas_fused", swapped to "pallas" as the JAX
package swaps it), N=8, B=2, through the plain twin against the JAX sweep
with Pallas in interpret mode: positions and `pos_err` within 1e-4 m, the
whole state within 1e-3 (measured 2.5e-6 m and 1.5e-4 m/s). Later ticks
of the take-off transient are not held pointwise: neither f32 solve
converges them in 6 iterations (after a second tick the two loops stand
6.6e-3 m apart in z). The JAX package's own f32 sweeps behind
`chip_smoke.SWEEP_JAX` are recomputed in tests/test_torch_sweep_bounds.py
(wind) and tests/test_torch_sweep_fault_bounds.py (faults).
"""
import dataclasses

import numpy as np
import jax.numpy as jnp
import torch

from mpc_blaster_tpu import config as jcfg
from mpc_blaster_tpu.ocp.spec import build_spec as jbuild_spec
from mpc_blaster_tpu.sim import scenarios as JS
from mpc_blaster_tpu_torch import config as cfg
from mpc_blaster_tpu_torch.convert import spec_from_numpy
from mpc_blaster_tpu_torch.sim import scenarios as TS


# The port runs on the CUDA card unless asked for the CPU; these tests
# ask for it.
DEV = torch.device("cpu")


def _ocps(N, solver):
    """(JAX, port) configs: the simulation preset at horizon N, same dt,
    with `solver(package)` as its solver."""
    return [dataclasses.replace(pkg.simulation_preset().ocp, N=N,
                                Tf=N / 30.0, solver=solver(pkg))
            for pkg in (jcfg, cfg)]


def _tspec(js, dtype):
    return spec_from_numpy({k: np.asarray(v) for k, v in js._asdict().items()},
                           dtype=dtype, device=DEV)


def test_pallas_sweep_tick_matches_jax_interpret():
    """One tick of the offset-free wind sweep under the deployed "safe"
    profile ("pallas_fused", swapped to "pallas"): the port's twin against
    the JAX kernel in interpret mode."""
    jo, to = _ocps(8, lambda pkg: pkg.deployed_solver("safe"))
    js = jbuild_spec(jo, yref=np.asarray(jcfg.simulation_preset().loop.yref),
                     dtype=jnp.float32)
    ts = _tspec(js, torch.float32)
    jsc = JS.sample_scenarios(2, seed=1, wind_max=0.8)
    tsc = TS.sample_scenarios(2, seed=1, wind_max=0.8, device=DEV)
    rj = JS.disturbance_sweep(js, jo, jsc, n_steps=1, offset_free=True)
    rt = TS.disturbance_sweep(ts, to, tsc, n_steps=1, offset_free=True)
    assert torch.isfinite(rt.final_states).all()
    np.testing.assert_allclose(rt.final_states[:, 0:3].numpy(),
                               np.asarray(rj.final_states)[:, 0:3], rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(rt.pos_err.numpy(), np.asarray(rj.pos_err),
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(rt.final_states.numpy(),
                               np.asarray(rj.final_states), rtol=0,
                               atol=1e-3)
