"""Port parity: the water-jet model and the point-of-contact solver against
the JAX package in float64 (atol 1e-9: a 12-step Newton solve and its
forward-mode derivative through closed-form exponentials; both sides
agree to rounding, ~1e-12, and the bound leaves headroom for the
Newton iterate's amplification near the root).

The functions of the online POC modes, float64:
  - `poc_value_and_jacobians` within 1e-10 of the JAX function (the value
    rides the Jacobians' pass: measured ~1e-15 apart), and equal to the
    port's own `solve_poc` / `poc_jacobians` bit for bit (the same
    operations);
  - `poc_jacobians_fd` within 5e-8 of the JAX finite differences: each
    side divides its solve's rounding by eps = 1e-6, and at |poc| up to
    20 m one ulp is 3.6e-15, so a few ulps become ~1e-8 (measured
    1.65e-8 on the poses below); within 1e-4 of autodiff
    (tests/test_poc.py:41-53's bound);
  - `true_poc_traj` within 1e-9 of the JAX function on 50 seeded states
    (the solve's tolerance above);
  - the stage parameters of the online modes under `vmap` within 1e-12
    of the per-state solves (the batched products sum in another order:
    measured 7e-15), and the JAX package's packing of its Jacobians within
    1e-9.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch
from torch.func import vmap

from mpc_blaster_tpu.poc import jet as jjet
from mpc_blaster_tpu.poc import solver as jsol
from mpc_blaster_tpu_torch.poc import jet as tjet
from mpc_blaster_tpu_torch.poc import solver as tsol
from torch_threads import one_intraop_thread  # noqa: F401

ATOL = 1e-9
POSES = [  # (euler, alpha, position)
    ((0.0, 0.0, 0.0), (0.0, 0.0), (0.0, 0.0, 4.0)),
    ((0.1, -0.05, 0.3), (0.2, -0.1), (0.4, -0.3, 2.5)),
    ((-0.15, 0.12, -0.2), (1.0, 0.4), (-1.0, 0.5, 3.2)),
]


def _close(j, t, atol=ATOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=0,
                               atol=atol)


def _args(pose):
    return ([jnp.asarray(a, jnp.float64) for a in pose],
            [torch.tensor(a, dtype=torch.float64) for a in pose])


@pytest.mark.parametrize("pose", POSES)
def test_jet_model(pose):
    (je, ja, jp), (te, ta, tp) = _args(pose)
    ji = jjet.jet_init_conditions(je, ja, jp, 150.0)
    ti = tjet.jet_init_conditions(te, ta, tp, 150.0)
    _close(ji, ti)
    for t in (0.0, 0.05, 0.3):
        _close(jjet.jet_state(t, ji, 1.0), tjet.jet_state(t, ti, 1.0))
        _close(jjet.jet_altitude(t, ji, 1.0), tjet.jet_altitude(t, ti, 1.0))
        _close(jjet.jet_altitude_rate(t, ji, 1.0),
               tjet.jet_altitude_rate(t, ti, 1.0))
        _close(jjet.jet_state_rk4(t, ji, 1.0), tjet.jet_state_rk4(t, ti, 1.0))


@pytest.mark.parametrize("pose", POSES)
def test_solve_poc_and_jacobians(pose):
    (je, ja, jp), (te, ta, tp) = _args(pose)
    jpoc, jT = jsol.solve_poc(je, ja, jp, 150.0, 1.0, 12, "htm")
    tpoc, tT = tsol.solve_poc(te, ta, tp, 150.0, 1.0, 12, "htm")
    _close(jpoc, tpoc)
    _close(jT, tT)
    ji = jjet.jet_init_conditions(je, ja, jp, 150.0)
    _close(jsol.time_of_impact(ji, 1.0),
           tsol.time_of_impact(tjet.jet_init_conditions(te, ta, tp, 150.0),
                               1.0))
    for a, b in zip(jsol.poc_jacobians(je, ja, jp, 150.0, 1.0, 12, "htm"),
                    tsol.poc_jacobians(te, ta, tp, 150.0, 1.0, 12, "htm")):
        _close(a, b)


def test_poc_solver_initialise():
    from mpc_blaster_tpu import config as cfg
    pc = cfg.simulation_preset().poc
    js = jsol.PocSolver.from_config(pc).initialise()
    ts = tsol.PocSolver.from_config(pc).initialise()
    assert ts.get_jacobians()[0].dtype == torch.float64
    for a, b in zip(js.get_jacobians(), ts.get_jacobians()):
        _close(a, b)
    _close(js.poc, ts.poc)
    _close(js.time_of_impact, ts.time_of_impact)


@pytest.mark.parametrize("pose", POSES)
def test_poc_value_and_jacobians(pose):
    (je, ja, jp), (te, ta, tp) = _args(pose)
    jout = jsol.poc_value_and_jacobians(je, ja, jp, 150.0, 1.0, 12, "htm")
    tout = tsol.poc_value_and_jacobians(te, ta, tp, 150.0, 1.0, 12, "htm")
    for a, b in zip(jout, tout):
        _close(a, b, atol=1e-10)
    own = (tsol.solve_poc(te, ta, tp)[0],
           *tsol.poc_jacobians(te, ta, tp))
    for a, b in zip(tout, own):
        assert torch.equal(a, b)


@pytest.mark.parametrize("pose", POSES)
def test_poc_jacobians_fd(pose):
    (je, ja, jp), (te, ta, tp) = _args(pose)
    fd_t = tsol.poc_jacobians_fd(te, ta, tp)
    assert all(a.dtype == torch.float64 for a in fd_t)
    for a, b in zip(jsol.poc_jacobians_fd(je, ja, jp), fd_t):
        _close(a, b, atol=5e-8)
    for a, b in zip(tsol.poc_jacobians(te, ta, tp), fd_t):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-4,
                                   atol=1e-4)
    # Python numbers are taken as float64, as the JAX function takes them
    for a, b in zip(tsol.poc_jacobians_fd(*pose), fd_t):
        assert torch.equal(a, b)


def _states(n, seed):
    """Poses a blast scan passes through: small attitudes, the gimbal
    across its box, 1.2-4 m up."""
    rng = np.random.default_rng(seed)
    xs = np.zeros((n, 17))
    xs[:, 0:2] = rng.uniform(-1.0, 1.0, (n, 2))
    xs[:, 2] = rng.uniform(1.2, 4.0, n)
    xs[:, 3:6] = rng.uniform(-0.15, 0.15, (n, 3))
    xs[:, 12] = rng.uniform(-0.17, 1.2, n)
    xs[:, 13] = rng.uniform(-0.5, 0.5, n)
    return xs


def test_true_poc_traj():
    xs = _states(50, 3)
    tp = tsol.true_poc_traj(torch.as_tensor(xs))
    assert tp.shape == (50, 3) and tp.dtype == torch.float64
    _close(jsol.true_poc_traj(jnp.asarray(xs)), tp)
    assert np.abs(tp[:, 2].numpy()).max() < 1e-9   # on the ground


def test_online_stage_params_under_vmap():
    from mpc_blaster_tpu.dynamics.blaster import pack_stage_params
    from mpc_blaster_tpu_torch import config as cfg
    pc = cfg.PocSolverConfig()
    xs = torch.as_tensor(_states(7, 4))
    t_blast = torch.tensor(2.2 * 9.81, dtype=torch.float64)
    ps = tsol.poc_stage_params_along(xs, t_blast, pc)
    pocs = vmap(lambda x: tsol.poc_value_and_jacobians(
        x[3:6], x[12:14], x[0:3])[0])(xs)
    assert ps.shape == (7, 25) and pocs.shape == (7, 3)
    for k in range(7):
        _close(tsol.poc_stage_params(xs[k], t_blast, pc), ps[k], 1e-12)
        _close(tsol.solve_poc(xs[k, 3:6], xs[k, 12:14], xs[k, 0:3])[0],
               pocs[k], 1e-12)
        x = jnp.asarray(xs[k].numpy())
        _close(pack_stage_params(*jsol.poc_jacobians(x[3:6], x[12:14],
                                                     x[0:3]), 2.2 * 9.81),
               ps[k])
