"""Port parity: the water-jet model and the point-of-contact solver against
the JAX package in float64 (atol 1e-9: a 12-step Newton solve and its
forward-mode derivative through closed-form exponentials; both sides
agree to rounding, ~1e-12, and the bound leaves headroom for the
Newton iterate's amplification near the root)."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mpc_blaster_tpu.poc import jet as jjet
from mpc_blaster_tpu.poc import solver as jsol
from mpc_blaster_tpu_torch.poc import jet as tjet
from mpc_blaster_tpu_torch.poc import solver as tsol

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
