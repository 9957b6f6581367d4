"""Port parity of the scenario sweeps (`sim/scenarios.py::disturbance_sweep`,
`fault_sweep`) against the JAX package.

Tolerances and why:
  - the sweeps on "riccati" in float64, the simulation preset cut to N=20
    (Tf 2/3 s, the same dt), 10 ticks: final positions and `pos_err`
    within 1e-4 m, the cross-implementation float64 tolerance of
    tests/test_torch_golden.py (the closed loops agree to ~1e-4 across
    implementations: the best-merit iterate flips inside the weakly
    determined rotor split). Measured here: 1e-9 m on the wind sweeps,
    1.3e-5 m on the fault sweep. The float32 "pallas" sweep tick is in
    tests/test_torch_batched.py.
"""
import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mpc_blaster_tpu import config as jcfg
from mpc_blaster_tpu.ocp.spec import build_spec as jbuild_spec
from mpc_blaster_tpu.sim import scenarios as JS
from mpc_blaster_tpu_torch import config as cfg
from mpc_blaster_tpu_torch.convert import spec_from_numpy
from mpc_blaster_tpu_torch.sim import scenarios as TS
from torch_threads import one_intraop_thread  # noqa: F401


# The port runs on the CUDA card unless asked for the CPU; these tests
# ask for it.
DEV = torch.device("cpu")
# tests/test_scenarios.py's deratings: healthy, symmetric 20% loss, one
# rotor at 70%, one arm weak
DERATE = np.array([[1.0, 1.0, 1.0, 1.0], [0.8, 0.8, 0.8, 0.8],
                   [0.7, 1.0, 1.0, 1.0], [0.85, 0.85, 1.0, 1.0]])


def _ocps(N, solver=None):
    """(JAX, port) configs: the simulation preset at horizon N, same dt,
    with `solver(package)` as its solver (default: the preset's)."""
    out = []
    for pkg in (jcfg, cfg):
        base = pkg.simulation_preset().ocp
        out.append(dataclasses.replace(
            base, N=N, Tf=N / 30.0,
            solver=base.solver if solver is None else solver(pkg)))
    return out


def _specs(ocp, jdt, tdt):
    js = jbuild_spec(ocp, yref=np.asarray(jcfg.simulation_preset().loop.yref),
                     dtype=jdt)
    return js, spec_from_numpy({k: np.asarray(v)
                                for k, v in js._asdict().items()},
                               dtype=tdt, device=DEV)


def _assert_sweeps_close(rj, rt, atol):
    assert rt.final_states.shape == np.asarray(rj.final_states).shape
    np.testing.assert_allclose(rt.final_states[:, 0:3].numpy(),
                               np.asarray(rj.final_states)[:, 0:3], rtol=0,
                               atol=atol)
    np.testing.assert_allclose(rt.pos_err.numpy(), np.asarray(rj.pos_err),
                               rtol=0, atol=atol)
    assert torch.equal(rt.settled, rt.pos_err < 0.25)


@pytest.mark.parametrize("offset_free", [False, True],
                         ids=["blind", "offset_free"])
def test_disturbance_sweep_matches_jax_f64(offset_free):
    jo, to = _ocps(20)
    js, ts = _specs(jo, jnp.float64, torch.float64)
    jsc = JS.sample_scenarios(3, seed=1, wind_max=0.8)
    tsc = TS.sample_scenarios(3, seed=1, wind_max=0.8, device=DEV)
    rj = JS.disturbance_sweep(js, jo, jsc, n_steps=10, dtype=jnp.float64,
                              offset_free=offset_free)
    rt = TS.disturbance_sweep(ts, to, tsc, n_steps=10, dtype=torch.float64,
                              offset_free=offset_free)
    assert rt.final_states.dtype == torch.float64
    _assert_sweeps_close(rj, rt, 1e-4)
    # the solves' residuals, to the solver's own acceptance tol_eq
    np.testing.assert_allclose(rt.worst_kkt_eq.numpy(),
                               np.asarray(rj.worst_kkt_eq), rtol=0,
                               atol=to.solver.tol_eq)


def test_fault_sweep_matches_jax_f64():
    jo, to = _ocps(20)
    js, ts = _specs(jo, jnp.float64, torch.float64)
    rj = JS.fault_sweep(js, jo, DERATE, n_steps=10, dtype=jnp.float64,
                        offset_free=True)
    rt = TS.fault_sweep(ts, to, DERATE, n_steps=10, dtype=torch.float64,
                        offset_free=True)
    _assert_sweeps_close(rj, rt, 1e-4)
