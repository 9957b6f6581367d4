"""Port parity: core rotations, the nozzle transform chain, the BLASTER ODE,
RK4 and the jacfwd discrete Jacobians against the JAX package, on the
same numpy inputs.

Tolerances: float64 atol 1e-10 (both sides evaluate the same formulas;
differences are rounding only), float32 atol 1e-5 (f32 rounding of O(1)
to O(10) quantities, ~10x the unit roundoff times the largest entry).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mpc_blaster_tpu import config as cfg
from mpc_blaster_tpu.core import htm as jhtm
from mpc_blaster_tpu.core import rotations as jrot
from mpc_blaster_tpu.dynamics import blaster as jbl
from mpc_blaster_tpu.dynamics import integrators as jint
from mpc_blaster_tpu_torch.core import htm as thtm
from mpc_blaster_tpu_torch.core import rotations as trot
from mpc_blaster_tpu_torch.dynamics import blaster as tbl
from mpc_blaster_tpu_torch.dynamics import integrators as tint

# The port runs on the CUDA card unless asked for the CPU; these tests
# ask for it.
DEV = torch.device("cpu")

DTYPES = [(np.float64, torch.float64, jnp.float64, 1e-10),
          (np.float32, torch.float32, jnp.float32, 1e-5)]
DTYPE_IDS = ["f64", "f32"]


def _close(j, t, atol):
    np.testing.assert_allclose(t.detach().cpu().numpy(), np.asarray(j),
                               rtol=0, atol=atol)


ROT_FUNCS = [
    ("rot_x", (3,)), ("rot_y", (3,)), ("rot_z", (3,)),
    ("euler_zyx_to_rot", (5, 3)), ("euler_rate_matrix", (5, 3)),
    ("euler_zyx_to_quat", (5, 3)),
]


@pytest.mark.parametrize("dt", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("name,shape", ROT_FUNCS, ids=[f[0] for f in ROT_FUNCS])
def test_rotation_unary(name, shape, dt):
    npd, td, jd, atol = dt
    a = np.random.default_rng(1).uniform(-1.2, 1.2, shape).astype(npd)
    _close(getattr(jrot, name)(jnp.asarray(a, jd)),
           getattr(trot, name)(torch.as_tensor(a)), atol)


@pytest.mark.parametrize("dt", DTYPES, ids=DTYPE_IDS)
def test_rotation_binary_and_quaternions(dt):
    npd, td, jd, atol = dt
    rng = np.random.default_rng(2)
    eul = rng.uniform(-1.0, 1.0, (6, 3)).astype(npd)
    om = rng.normal(size=(6, 3)).astype(npd)
    q1 = rng.normal(size=(6, 4)).astype(npd)
    q2 = rng.normal(size=(6, 4)).astype(npd)
    qu = q1 / np.linalg.norm(q1, axis=-1, keepdims=True)

    def both(name, *args):
        j = getattr(jrot, name)(*(jnp.asarray(a, jd) for a in args))
        t = getattr(trot, name)(*(torch.as_tensor(a) for a in args))
        _close(j, t, atol)

    both("euler_rates_from_omega", eul, om)
    both("gimbal_rotation", eul[:, 0], eul[:, 1])
    both("quat_mul", q1, q2)
    both("unit_quat_inv", qu)
    both("quat_to_rot", qu)
    both("quat_to_euler_zyx", qu)


@pytest.mark.parametrize("dt", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("convention", ["htm", "model"])
def test_htm_chain(dt, convention):
    npd, td, jd, atol = dt
    rng = np.random.default_rng(3)
    eul = rng.uniform(-0.5, 0.5, 3).astype(npd)
    alpha = rng.uniform(-0.5, 0.5, 2).astype(npd)
    pos = rng.uniform(-2.0, 4.0, 3).astype(npd)
    _close(jhtm.T_b_s2(jnp.asarray(alpha[0], jd), jnp.asarray(alpha[1], jd)),
           thtm.T_b_s2(torch.as_tensor(alpha[0]), torch.as_tensor(alpha[1])),
           atol)
    _close(jhtm.T_w_b(jnp.asarray(eul, jd), jnp.asarray(pos, jd), convention),
           thtm.T_w_b(torch.as_tensor(eul), torch.as_tensor(pos), convention),
           atol)
    jp, jR = jhtm.nozzle_pose(jnp.asarray(eul, jd), jnp.asarray(alpha, jd),
                              jnp.asarray(pos, jd), convention)
    tp, tR = thtm.nozzle_pose(torch.as_tensor(eul), torch.as_tensor(alpha),
                              torch.as_tensor(pos), convention)
    _close(jp, tp, atol)
    _close(jR, tR, atol)


def _xup(npd, n=4, seed=4):
    """Random states near the flight envelope, controls near hover and
    POC stage parameters with O(1) Jacobian entries."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-0.3, 0.3, (n, cfg.NX))
    x[:, 2] += 2.0
    u = np.concatenate([rng.uniform(15.0, 30.0, (n, 4)),
                        rng.uniform(-0.08, 0.08, (n, 2))], axis=1)
    p = rng.normal(size=(n, cfg.NP))
    p[:, -1] = 2.2 * 9.81
    return x.astype(npd), u.astype(npd), p.astype(npd)


def _params(jd, td):
    m = cfg.simulation_preset().ocp.model
    return jbl.BlasterParams.from_config(m, jd), \
        tbl.BlasterParams.from_config(m, td, device=DEV)


def test_stage_params_pack_unpack():
    rng = np.random.default_rng(5)
    ja, je, jp = rng.normal(size=(3, 2)), rng.normal(size=(3, 3)), \
        rng.normal(size=(3, 3))
    pj = jbl.pack_stage_params(ja, je, jp, 21.582)
    pt = tbl.pack_stage_params(torch.as_tensor(ja), torch.as_tensor(je),
                               torch.as_tensor(jp), 21.582)
    _close(pj, pt, 0.0)
    for a, b in zip(jbl.unpack_stage_params(pj),
                    tbl.unpack_stage_params(pt)):
        _close(a, b, 0.0)
    _close(jbl.default_stage_params(dtype=jnp.float64),
           tbl.default_stage_params(dtype=torch.float64, device=DEV), 0.0)


@pytest.mark.parametrize("dt", DTYPES, ids=DTYPE_IDS)
def test_blaster_ode(dt):
    npd, td, jd, atol = dt
    jp_, tp_ = _params(jd, td)
    for x, u, p in zip(*_xup(npd)):
        _close(jbl.blaster_ode(jnp.asarray(x), jnp.asarray(u),
                               jnp.asarray(p), jp_),
               tbl.blaster_ode(torch.as_tensor(x), torch.as_tensor(u),
                               torch.as_tensor(p), tp_), atol)


@pytest.mark.parametrize("num_steps", [1, 3])
@pytest.mark.parametrize("dt", DTYPES, ids=DTYPE_IDS)
def test_rk4_and_discrete_jacobians(dt, num_steps):
    npd, td, jd, atol = dt
    jp_, tp_ = _params(jd, td)
    h = 1.0 / 30.0
    Fj = jint.discrete_dynamics(jbl.blaster_ode, h, num_steps=num_steps)
    Ft = tint.discrete_dynamics(tbl.blaster_ode, h, num_steps=num_steps)
    FABj = jax.jit(jax.vmap(jint.discrete_jacobians(Fj),
                            in_axes=(0, 0, 0, None)))
    FABt = tint.discrete_jacobians(Ft)
    x, u, p = _xup(npd, n=3)
    for a, b in zip(FABj(jnp.asarray(x), jnp.asarray(u), jnp.asarray(p),
                         jp_),
                    zip(*(FABt(torch.as_tensor(xi), torch.as_tensor(ui),
                               torch.as_tensor(pi), tp_)
                          for xi, ui, pi in zip(x, u, p)))):
        _close(a, torch.stack(b), atol)
    _close(jint.rk4_step(jbl.blaster_ode, jnp.asarray(x[0]),
                         jnp.asarray(u[0]), h, jnp.asarray(p[0]), jp_),
           tint.rk4_step(tbl.blaster_ode, torch.as_tensor(x[0]),
                         torch.as_tensor(u[0]), h, torch.as_tensor(p[0]),
                         tp_), atol)
