"""Port parity of the component-form linearizer (`dynamics/fastlin.py`):
the port's `fast_linearize` against the JAX package's on the same inputs,
for the three rows-form families and 1 or 2 RK4 substeps, and against the
port's own jacfwd linearizer (tests/test_fastlin.py's checks).

Tolerances: float64 rtol 1e-10 / atol 1e-12 on A and B and 1e-12 on the
primal (the same formulas, only summation order and library sin/cos/tan
differ); float32 rtol and atol 2e-5 on the primal and 2e-4 on A and B
(tests/test_fastlin.py's f32 bounds: f32 rounding only).
"""
import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mpc_blaster_tpu import config as cfg
from mpc_blaster_tpu.dynamics.blaster import BlasterParams as JBP
from mpc_blaster_tpu.dynamics.blaster import pack_stage_params
from mpc_blaster_tpu.dynamics.fastlin import fast_linearize as jfast
from mpc_blaster_tpu_torch.dynamics.blaster import BlasterParams, blaster_ode
from mpc_blaster_tpu_torch.dynamics.fastlin import (fast_linearize,
                                                    make_fused_linearizer)
from mpc_blaster_tpu_torch.dynamics.integrators import discrete_dynamics
from mpc_blaster_tpu_torch.sqp.rti import _linearize_nodes, make_linearizer
from torch_threads import one_intraop_thread  # noqa: F401

# The port runs on the CUDA card unless asked for the CPU; these tests
# ask for it.
DEV = torch.device("cpu")

PRECS = {"f64": (jnp.float64, torch.float64, np.float64),
         "f32": (jnp.float32, torch.float32, np.float32)}


def _blaster_inputs(N, seed=0, n_dist=0):
    """The iterate and stage parameters of tests/test_fastlin.py, with
    `n_dist` disturbance rows appended to the stage parameters."""
    rng = np.random.default_rng(seed)
    xbar = rng.normal(0, 0.3, (N + 1, cfg.NX))
    xbar[:, 2] += 2.0
    ubar = rng.normal(0, 1.0, (N, cfg.NU))
    ubar[:, 0:4] += 5.0
    p = np.asarray(pack_stage_params(rng.normal(0, 0.5, (3, 2)),
                                     rng.normal(0, 0.5, (3, 3)),
                                     rng.normal(0, 0.5, (3, 3)), 2.2 * 9.81))
    sp = np.tile(p[None], (N, 1))
    if n_dist:
        sp = np.concatenate([sp, rng.normal(0, 0.4, (N, n_dist))], axis=1)
    return xbar, ubar, sp


def _quad13_inputs(N, seed=11):
    rng = np.random.default_rng(seed)
    xbar = rng.normal(0, 0.3, (N + 1, 13))
    xbar[:, 2] += 2.0
    xbar[:, 3] += 1.0  # near-identity quaternions
    ubar = rng.normal(0, 1.0, (N, 4)) + 20.0
    return xbar, ubar, np.zeros((N, 1))


def _params(family, jdt, tdt):
    if family == "quad13":
        from mpc_blaster_tpu.models.quad13 import Quad13Config
        c = Quad13Config(N=6)
        vals = dict(mass=c.mass, inertia=c.inertia_diag,
                    arm_length_x=c.arm_length_x, arm_length_y=c.arm_length_y,
                    yaw_coefficient=c.yaw_coefficient, gravity=c.gravity)
        dt = c.dt
    else:
        pre = cfg.simulation_preset()
        m = pre.ocp.model
        vals = dict(mass=m.mass, inertia=m.inertia_diag,
                    arm_length_x=m.arm_length_x, arm_length_y=m.arm_length_y,
                    yaw_coefficient=m.yaw_coefficient, gravity=m.gravity)
        dt = pre.ocp.dt
    jp = JBP(**{k: jnp.asarray(v, jdt) for k, v in vals.items()})
    tp = BlasterParams(**{k: torch.as_tensor(v, dtype=tdt)
                          for k, v in vals.items()})
    return jp, tp, dt


def _tol(prec):
    return ((1e-12, 1e-12, 1e-10, 1e-12) if prec == "f64"
            else (2e-5, 2e-5, 2e-4, 2e-4))


def _assert_lin_close(got, ref, prec):
    rtol_x, atol_x, rtol_ab, atol_ab = _tol(prec)
    for name, g, r, rt, at in (("x_next", got[0], ref[0], rtol_x, atol_x),
                               ("A", got[1], ref[1], rtol_ab, atol_ab),
                               ("B", got[2], ref[2], rtol_ab, atol_ab)):
        np.testing.assert_allclose(np.asarray(g), np.asarray(r), rtol=rt,
                                   atol=at, err_msg=name)


@pytest.mark.parametrize("num_steps", [1, 2])
@pytest.mark.parametrize("prec", ["f64", "f32"])
@pytest.mark.parametrize("family", ["blaster", "blaster_dist", "quad13"])
def test_fast_linearize_matches_jax(family, prec, num_steps):
    jdt, tdt, npdt = PRECS[prec]
    if family == "quad13":
        xbar, ubar, sp = _quad13_inputs(6)
    else:
        xbar, ubar, sp = _blaster_inputs(
            8, seed=5, n_dist=6 if family == "blaster_dist" else 0)
    xbar, ubar, sp = (a.astype(npdt) for a in (xbar, ubar, sp))
    jp, tp, dt = _params(family, jdt, tdt)
    ref = jfast(jnp.asarray(xbar), jnp.asarray(ubar), jnp.asarray(sp), jp,
                dt, num_steps=num_steps, family=family)
    got = fast_linearize(torch.as_tensor(xbar), torch.as_tensor(ubar),
                         torch.as_tensor(sp), tp, dt, num_steps=num_steps,
                         family=family)
    assert got[0].dtype == tdt and got[1].shape == ref[1].shape
    _assert_lin_close([g.numpy() for g in got], ref, prec)


@pytest.mark.parametrize("case", [("f64", 1), ("f64", 2), ("f32", 1)])
def test_fast_linearize_matches_port_jacfwd(case):
    """Against the port's jacfwd + vmap linearizer (`sqp/rti.py`)."""
    prec, num_steps = case
    _, tdt, npdt = PRECS[prec]
    pre = cfg.simulation_preset()
    tp = BlasterParams.from_config(pre.ocp.model, tdt, device=DEV)
    xbar, ubar, sp = (torch.as_tensor(a.astype(npdt))
                      for a in _blaster_inputs(12 if prec == "f32" else 8,
                                               seed=3))
    F = discrete_dynamics(blaster_ode, pre.ocp.dt, num_steps=num_steps)
    ref = _linearize_nodes(F, xbar, ubar, sp, tp)
    got = fast_linearize(xbar, ubar, sp, tp, pre.ocp.dt,
                         num_steps=num_steps)
    _assert_lin_close([g.numpy() for g in got], [r.numpy() for r in ref],
                      prec)


def test_fast_linearize_batched_matches_single():
    """Leading batch axes (the batched fused tick) give each trajectory's
    own linearization, with the stage parameters shared."""
    pre = cfg.simulation_preset()
    tp = BlasterParams.from_config(pre.ocp.model, torch.float64, device=DEV)
    ins = [_blaster_inputs(6, seed=s) for s in (1, 2)]
    sp = torch.as_tensor(ins[0][2])
    xbs = torch.as_tensor(np.stack([i[0] for i in ins]))
    ubs = torch.as_tensor(np.stack([i[1] for i in ins]))
    out = fast_linearize(xbs, ubs, sp, tp, pre.ocp.dt)
    for b in range(2):
        one = fast_linearize(xbs[b], ubs[b], sp, tp, pre.ocp.dt)
        for g, r in zip(out, one):
            torch.testing.assert_close(g[b], r, rtol=1e-12, atol=1e-12)


def test_make_linearizer_fused_and_unknown():
    pre = cfg.simulation_preset()
    tp = BlasterParams.from_config(pre.ocp.model, torch.float64, device=DEV)
    ocp = dataclasses.replace(pre.ocp, N=6, Tf=0.2, solver=dataclasses.replace(
        pre.ocp.solver, lin_backend="fused"))
    lin = make_linearizer(ocp, tp)
    xbar, ubar, sp = (torch.as_tensor(a) for a in _blaster_inputs(6))
    for g, r in zip(lin(xbar, ubar, sp),
                    make_fused_linearizer(ocp, tp)(xbar, ubar, sp)):
        assert torch.equal(g, r)
    bad = dataclasses.replace(ocp, solver=dataclasses.replace(
        ocp.solver, lin_backend="nope"))
    with pytest.raises(ValueError, match="lin_backend"):
        make_linearizer(bad, tp)


@pytest.mark.parametrize("family", ["blaster", "blaster_dist", "quad13"])
def test_fused_lin_prologue_matches_jax(family):
    """The fuse_lin prologue's wrapper (`ops/box_qp_ipm.py::
    fused_lin_prologue`, one problem) on CPU tensors, its plain version,
    against the JAX `fast_linearize` in float32: A and B within the f32
    bounds above, c = x_next - xbar_{k+1} within the primal's; a batch
    refused."""
    from mpc_blaster_tpu_torch.ops import box_qp_ipm as K
    if family == "quad13":
        xbar, ubar, sp = _quad13_inputs(6)
    else:
        xbar, ubar, sp = _blaster_inputs(
            8, seed=5, n_dist=6 if family == "blaster_dist" else 0)
    xbar, ubar, sp = (a.astype(np.float32) for a in (xbar, ubar, sp))
    jp, _, dt = _params(family, jnp.float32, torch.float32)
    ref = jfast(jnp.asarray(xbar), jnp.asarray(ubar), jnp.asarray(sp), jp,
                dt, num_steps=1, family=family)
    model = (family, float(jp.mass), float(jp.gravity),
             float(jp.arm_length_x), float(jp.arm_length_y),
             float(jp.yaw_coefficient), *map(float, np.asarray(jp.inertia)))
    t = [torch.as_tensor(a, device=DEV)[None] for a in (xbar, ubar, sp)]
    A, B, c = K.fused_lin_prologue(*t, model, dt, 1)
    assert A.shape == (1, *ref[1].shape) and c.dtype == torch.float32
    _assert_lin_close([(c[0] + t[0][0, 1:]).numpy(), A[0].numpy(),
                       B[0].numpy()], ref, "f32")
    np.testing.assert_allclose(c[0].numpy(), np.asarray(ref[0]) - xbar[1:],
                               rtol=2e-5, atol=2e-5)
    with pytest.raises(ValueError):
        K.fused_lin_prologue(*(torch.cat([a, a]) for a in t), model, dt, 1)
