"""Flight safety of the port's tick on pathological states: the criteria of
tests/test_stress.py on the port, on the CPU.

The 16 stress states of tests/test_stress.py::_pathological_batch (box
corners, 2x outside the position box, at the velocity and omega bounds,
the gimbal pinned, random draws at 1.5x the box; the port's copy is
chip_smoke.py::pathological_states, held equal to it), at N=20,
Tf=20/30, in float32, go through the port's batched tick (the JAX test
vmaps its tick) on each QP backend: "riccati" (the eager Riccati IPM),
"pallas" (kernel K1's plain twin), "pallas_fused" (K6's twin over the
batch) and the batched fused tick (K5's twin). Each meets
tests/test_stress.py:70-97's criteria exactly: u0 finite and inside the
control box with a skin of 1e-3 of its width, `qp_kkt_eq` and
`bound_viol` finite, and the far state (index 3) reported as a bound
violation above 1.

The port's float64 "riccati" tick is held against the JAX package's on
the same states: the thrusts (u0 channels 0-3) within 1e-7 N where the
JAX float64 solve converges (`qp_kkt_eq` < 1e-6: the cold origin alone
after 12 iterations; measured 2.4e-9 N) and within 1e-6 N on every state
(measured 1.6e-8 N). The gimbal rates are weakly determined and are not
held pointwise.

The recovery loop (tests/test_stress.py:144-164) is in
tests/test_torch_stress_recovery*.py; the deep 40-iteration `sqp_solve`
(tests/test_stress.py:100-141) is here, `slow` as in the JAX file.
"""
import dataclasses

import numpy as np
import pytest
import torch

from chip_smoke import pathological_states
from mpc_blaster_tpu_torch import config as cfg
from mpc_blaster_tpu_torch.dynamics.blaster import BlasterParams, blaster_ode
from mpc_blaster_tpu_torch.dynamics.integrators import discrete_dynamics
from mpc_blaster_tpu_torch.ocp.spec import build_spec
from mpc_blaster_tpu_torch.parallel.mesh import batched_rti_step
from mpc_blaster_tpu_torch.sqp.rti import init_rti_state, sqp_solve
from torch_threads import one_intraop_thread  # noqa: F401

# The port runs on the CUDA card unless asked for the CPU; these tests
# ask for it.
DEV = torch.device("cpu")
DTYPE = torch.float32


def test_stress_states_are_the_jax_tests():
    """chip_smoke.py's copy of the stress states (phase 21 and this file)
    equals tests/test_stress.py::_pathological_batch exactly."""
    from test_stress import _pathological_batch
    _, ocp = stress_ocp()
    np.testing.assert_array_equal(pathological_states(ocp),
                                  _pathological_batch(ocp))


def stress_ocp():
    pre = cfg.simulation_preset()
    return pre, dataclasses.replace(pre.ocp, N=20, Tf=20 / 30.0)


def with_backend(ocp, backend):
    return dataclasses.replace(ocp, solver=dataclasses.replace(
        ocp.solver, qp_backend=backend))


# name -> (the solver's qp_backend, batched_rti_step's backend)
BACKENDS = {"riccati": ("riccati", "xla"), "pallas": ("pallas", "xla"),
            "pallas_fused": ("pallas_fused", "xla"),
            "batched_fused": ("riccati", "pallas_fused")}


def stress_tick(backend, dtype=DTYPE):
    """One tick of the port on the 16 stress states from a cold
    iterate: (u0s, diags) as numpy float64 / the diagnostics."""
    pre, ocp = stress_ocp()
    qp_backend, batched = BACKENDS[backend]
    ocp = with_backend(ocp, qp_backend)
    spec = build_spec(ocp, yref=pre.loop.yref, dtype=dtype, device=DEV)
    x0s = torch.as_tensor(pathological_states(ocp), dtype=dtype)
    step = batched_rti_step(ocp, dtype=dtype, backend=batched, device=DEV)
    u0s, _, diag = step(spec, init_rti_state(ocp, x0s, dtype=dtype,
                                             device=DEV), x0s)
    return u0s.double().numpy(), diag


def flight_safe(ocp, u0s, diag):
    """tests/test_stress.py:80-97's criteria."""
    assert np.isfinite(u0s).all(), "non-finite control on stress batch"
    lbu = np.asarray(ocp.bounds.lbu)
    ubu = np.asarray(ocp.bounds.ubu)
    eps = 1e-3 * (ubu - lbu)
    assert (u0s >= lbu - eps).all(), (u0s.min(axis=0), lbu)
    assert (u0s <= ubu + eps).all(), (u0s.max(axis=0), ubu)
    assert torch.isfinite(diag.qp_kkt_eq).all()
    assert torch.isfinite(diag.bound_viol).all()
    assert float(diag.bound_viol[3]) > 1.0


@pytest.mark.parametrize("backend", list(BACKENDS))
def test_pathological_states_flight_safe(backend):
    """Every pathological tick returns u0 finite and inside the control
    box, with finite diagnostics, on each backend."""
    _, ocp = stress_ocp()
    u0s, diag = stress_tick(backend)
    assert u0s.shape == (16, cfg.NU)
    flight_safe(ocp, u0s, diag)


def test_riccati_tick_matches_jax_f64():
    """The port's float64 tick on the stress states against the JAX
    package's vmapped tick (the thrust channels; tolerances measured and
    stated in the module docstring)."""
    import jax
    import jax.numpy as jnp
    from mpc_blaster_tpu import config as jcfg
    from mpc_blaster_tpu.dynamics.blaster import BlasterParams as JP
    from mpc_blaster_tpu.dynamics.blaster import blaster_ode as jode
    from mpc_blaster_tpu.dynamics.integrators import discrete_dynamics as jdd
    from mpc_blaster_tpu.ocp.spec import build_spec as jbuild_spec
    from mpc_blaster_tpu.sqp.rti import init_rti_state as jinit
    from mpc_blaster_tpu.sqp.rti import rti_step as jrti_step
    jpre = jcfg.simulation_preset()
    jocp = dataclasses.replace(jpre.ocp, N=20, Tf=20 / 30.0)
    jspec = jbuild_spec(jocp, yref=jpre.loop.yref, dtype=jnp.float64)
    jparams = JP.from_config(jocp.model, jnp.float64)
    jF = jdd(jode, jocp.dt)

    def tick(x0):
        u0, _, diag = jrti_step(jspec, jinit(jocp, x0, jnp.float64), x0,
                                jparams, jF, jocp.solver)
        return u0, diag.qp_kkt_eq
    _, ocp = stress_ocp()
    x0s = pathological_states(ocp)
    u_j, kkt_j = (np.asarray(a) for a in jax.jit(jax.vmap(tick))(
        jnp.asarray(x0s, jnp.float64)))
    u_t, diag = stress_tick("riccati", torch.float64)
    flight_safe(ocp, u_t, diag)
    conv = kkt_j < 1e-6
    assert conv.any()
    gap = np.abs(u_t[:, :4] - u_j[:, :4]).max(axis=1)
    assert gap[conv].max() < 1e-7, gap
    assert gap.max() < 1e-6, gap


@pytest.mark.slow
def test_deep_iteration_budget_stable():
    """The deep solve budget (40 SQP iterations of 12 IPM iterations) on
    the velocity-bound state: the best-merit iterate of 40 iterations
    stays within 0.5 N (thrusts) of 20 iterations', the raw step norms
    stay bounded, and in float64 the same problem contracts
    (tests/test_stress.py:100-141's criteria)."""
    pre, ocp = stress_ocp()
    spec = build_spec(ocp, yref=pre.loop.yref, dtype=DTYPE, device=DEV)
    params = BlasterParams.from_config(ocp.model, DTYPE, device=DEV)
    F = discrete_dynamics(blaster_ode, ocp.dt, num_steps=1)
    x0 = torch.as_tensor(pathological_states(ocp)[4], dtype=DTYPE)
    st0 = init_rti_state(ocp, x0, DTYPE)
    st_short, _ = sqp_solve(spec, st0, x0, params, F, ocp.solver, iters=20)
    st_deep, norms = sqp_solve(spec, st0, x0, params, F, ocp.solver,
                               iters=40)
    assert torch.isfinite(st_deep.ubar).all()
    d = (st_deep.ubar[:, :4].double() - st_short.ubar[:, :4].double()).abs()
    assert d.max() < 0.5, d.max()
    norms = norms.numpy()
    assert norms.max() < 10.0 * max(norms[0], 1.0), norms.max()
    f64 = torch.float64
    spec64 = build_spec(ocp, yref=pre.loop.yref, dtype=f64, device=DEV)
    params64 = BlasterParams.from_config(ocp.model, f64, device=DEV)
    _, norms64 = sqp_solve(spec64, init_rti_state(ocp, x0.double(), f64),
                           x0.double(), params64, F, ocp.solver, iters=12)
    norms64 = norms64.numpy()
    assert norms64[-1] < 1e-6 * norms64[0], (norms64[0], norms64[-1])
