"""The port's scale-out (`mpc_blaster_tpu_torch/parallel/mesh.py`: `Mesh`,
`make_mesh`, `sharded_rti_step`, `sharded_sweep`) on a mesh of CPU
shards: tests/test_parallel.py's cases.

Tolerances: a shard runs the batched tick on its slice of the batch with
the same arithmetic per problem, so the sharded tick equals the batched
one within 1e-12 and its reductions equal the global mean (rtol 1e-12)
and max (exactly); against the JAX package's vmapped tick the JAX test's
sharded-vs-batched tolerance holds (u0 within 1e-3; measured at rounding
level). The sweep keeps the JAX test's criterion (the mean final position
error below 0.55 of the initial one, mean_err equal to the errors' mean)
at N=12 and 6 IPM iterations instead of N=24 and 12: each shard's eager
tick costs the same at any batch, and 4 shards x 40 ticks at N=24 took
78 s on an 8-core CPU.

The sweep is also held to the JAX package's `sharded_sweep` on a mesh of
four CPU devices, in float64 on the same x0s (measured on an 8-core x86
CPU): the first-tick controls within 1e-8 N (measured 9.4e-10), the final
positions within 1e-5 m (1.9e-6), the whole final state within 1e-3
(1.35e-4, in the rotor states), mean_err within 1e-6 m (4.8e-10) and
worst_kkt within rel 1e-6 (3e-11). The final states are looser because
the 6-iteration loops turn weakly determined late in the run: on scenario
2 the JAX package's own vmapped loop parts from its unbatched
`closed_loop` by 6e-4 N at tick 33 and by up to 6e-3 N after it (from
1e-9 N before), and the port's batched loop parts from the port's
`closed_loop` at the same tick by as much; the port's `closed_loop`
agrees with JAX's to 1e-6 N over all 40 ticks.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mpc_blaster_tpu_torch import config as cfg
from mpc_blaster_tpu_torch.ocp.spec import build_spec
from mpc_blaster_tpu_torch.parallel import (batched_rti_step, make_mesh,
                                            sharded_rti_step, sharded_sweep)
from mpc_blaster_tpu_torch.sqp.rti import init_rti_state
from torch_threads import one_intraop_thread  # noqa: F401

DEV = torch.device("cpu")
DTYPE = torch.float64
B = 16
# the sweep against the JAX package's sharded_sweep (the module docstring)
SWEEP_U0_TOL, SWEEP_POS_TOL, SWEEP_STATE_TOL = 1e-8, 1e-5, 1e-3
SWEEP_ERR_TOL, SWEEP_KKT_REL = 1e-6, 1e-6


def _setup(N=24, iters=None):
    pre = cfg.simulation_preset()
    solver = pre.ocp.solver if iters is None else dataclasses.replace(
        pre.ocp.solver, ipm_iters=iters)
    ocp = dataclasses.replace(pre.ocp, N=N, Tf=N / 30.0, solver=solver)
    spec = build_spec(ocp, yref=pre.loop.yref, dtype=DTYPE, device=DEV)
    rng = np.random.default_rng(3)
    x0s = np.zeros((B, cfg.NX))
    x0s[:, 0:3] = rng.uniform(-0.5, 0.5, (B, 3))
    x0s[:, 2] += 2.0
    return ocp, spec, torch.as_tensor(x0s, dtype=DTYPE)


def test_make_mesh():
    mesh = make_mesh(4, device="cpu")
    assert mesh.size == 4 and mesh.axis_names == ("dp",)
    assert all(d == DEV for d in mesh.devices)
    assert make_mesh(device="cpu").size == 1
    if not torch.cuda.is_available():
        # the default is the card: without one, it raises and names the CPU
        with pytest.raises(RuntimeError, match='device="cpu"'):
            make_mesh()
        with pytest.raises(RuntimeError, match='device="cpu"'):
            make_mesh(2)
    else:
        with pytest.raises(ValueError, match="CUDA device"):
            make_mesh(torch.cuda.device_count() + 1)
    ocp, spec, x0s = _setup(N=8)
    step = sharded_rti_step(ocp, make_mesh(3, device="cpu"), dtype=DTYPE)
    with pytest.raises(ValueError, match="not divisible"):
        step(spec, init_rti_state(ocp, x0s, DTYPE), x0s)


@pytest.fixture(scope="module")
def batched():
    ocp, spec, x0s = _setup()
    states = init_rti_state(ocp, x0s, DTYPE)
    return (ocp, spec, x0s, states,
            batched_rti_step(ocp, dtype=DTYPE, device=DEV)(spec, states,
                                                           x0s))


@pytest.mark.parametrize("n_shards", [4, 8])
def test_sharded_step_matches_batched(batched, n_shards):
    ocp, spec, x0s, states, (u0s_b, states_b, diags) = batched
    sstep = sharded_rti_step(ocp, make_mesh(n_shards, device="cpu"),
                             dtype=DTYPE)
    u0s_s, states_s, mean_step, worst_kkt = sstep(spec, states, x0s)
    assert u0s_s.shape == (B, cfg.NU)
    torch.testing.assert_close(u0s_s, u0s_b, rtol=0, atol=1e-12)
    torch.testing.assert_close(states_s.xbar, states_b.xbar, rtol=0,
                               atol=1e-12)
    assert float(mean_step) == pytest.approx(
        float(diags.step_norm_u.mean()), rel=1e-12)
    assert float(worst_kkt) == float(diags.qp_kkt_stat.max())
    assert mean_step.dim() == 0 and worst_kkt.dim() == 0


def test_batched_step_matches_jax(batched):
    """The tick every shard runs, against the JAX package's vmapped tick
    on the same inputs."""
    from mpc_blaster_tpu import config as jcfg
    from mpc_blaster_tpu.ocp.spec import build_spec as jbuild_spec
    from mpc_blaster_tpu.parallel.mesh import batched_rti_step as jbatched
    from mpc_blaster_tpu.sqp.rti import init_rti_state as jinit
    ocp, spec, x0s, states, (u0s_b, _, diags) = batched
    jpre = jcfg.simulation_preset()
    jocp = dataclasses.replace(jpre.ocp, N=24, Tf=24 / 30.0)
    jx0s = jnp.asarray(x0s.numpy())
    js = jax.vmap(lambda x: jinit(jocp, x, jnp.float64))(jx0s)
    ju0s, _, jd = jbatched(jocp, dtype=jnp.float64)(
        jbuild_spec(jocp, yref=jpre.loop.yref, dtype=jnp.float64), js, jx0s)
    np.testing.assert_allclose(u0s_b.numpy(), np.asarray(ju0s), rtol=0,
                               atol=1e-3)
    np.testing.assert_allclose(float(diags.step_norm_u.mean()),
                               float(jnp.mean(jd.step_norm_u)), rtol=1e-6)


def test_sharded_sweep_runs_and_tracks():
    """The sweep tracks (the JAX test's criterion) and equals the JAX
    package's `sharded_sweep` on a mesh of four CPU devices, on the same
    inputs: finals, first-tick controls, mean_err and worst_kkt."""
    from mpc_blaster_tpu import config as jcfg
    from mpc_blaster_tpu.ocp.spec import build_spec as jbuild_spec
    from mpc_blaster_tpu.parallel.mesh import make_mesh as jmake_mesh
    from mpc_blaster_tpu.parallel.mesh import sharded_sweep as jsweep
    ocp, spec, x0s = _setup(N=12, iters=6)
    sweep = sharded_sweep(ocp, make_mesh(4, device="cpu"), n_steps=40,
                          dtype=DTYPE)
    finals, u0s, mean_err, worst_kkt = sweep(spec, x0s)
    assert finals.shape == (B, cfg.NX) and u0s.shape == (B, cfg.NU)
    assert torch.isfinite(finals).all() and torch.isfinite(worst_kkt)
    target = torch.tensor([0.0, 0.0, 3.5], dtype=DTYPE)
    errs = torch.linalg.norm(finals[:, 0:3] - target, dim=-1)
    x0errs = torch.linalg.norm(x0s[:, 0:3] - target, dim=-1)
    assert float(errs.mean()) < 0.55 * float(x0errs.mean())
    assert float(mean_err) == pytest.approx(float(errs.mean()), rel=1e-12)

    jpre = jcfg.simulation_preset()
    jocp = dataclasses.replace(
        jpre.ocp, N=12, Tf=12 / 30.0,
        solver=dataclasses.replace(jpre.ocp.solver, ipm_iters=6))
    jf, ju, jerr, jkkt = jsweep(jocp, jmake_mesh(4), n_steps=40,
                                dtype=jnp.float64)(
        jbuild_spec(jocp, yref=jpre.loop.yref, dtype=jnp.float64),
        jnp.asarray(x0s.numpy()))
    np.testing.assert_allclose(u0s.numpy(), np.asarray(ju), rtol=0,
                               atol=SWEEP_U0_TOL)
    np.testing.assert_allclose(finals[:, 0:3].numpy(), np.asarray(jf)[:, 0:3],
                               rtol=0, atol=SWEEP_POS_TOL)
    np.testing.assert_allclose(finals.numpy(), np.asarray(jf), rtol=0,
                               atol=SWEEP_STATE_TOL)
    assert float(mean_err) == pytest.approx(float(jerr), abs=SWEEP_ERR_TOL)
    assert float(worst_kkt) == pytest.approx(float(jkkt), rel=SWEEP_KKT_REL)
