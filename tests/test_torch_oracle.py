"""The independent correctness oracle of tests/test_oracle.py, on the port.

The exact NLP the controller solves (LINEAR_LS cost, RK4 shooting, box
bounds on states and controls) is solved by an independent optimizer,
scipy's SLSQP on the single-shooting reduction (control bounds as variable
bounds, state boxes as nonlinear inequality constraints), with float64
gradients and Jacobians from `torch.func`; the port's converged
`sqp_solve` iterate must match it at the JAX file's tolerances (thrusts
<= 1e-3, the objective to 1e-6 relative; every control <= 1e-3 where the
gimbal is well posed). These six tests are `slow`, as in the JAX file.

`test_rti_step_is_one_exact_gauss_newton_step` (tier 1) pins the SQP-RTI
semantics: the port's float64 `rti_step` with every box widened equals one
full Gauss-Newton step solved densely in numpy (xbar within 1e-7, ubar and
u0 within 1e-6). No test here imports JAX.
"""
import dataclasses

import numpy as np
import pytest
import torch
from scipy.optimize import minimize
from torch.func import grad, jacfwd

from mpc_blaster_tpu_torch import config as cfg
from mpc_blaster_tpu_torch.dynamics.blaster import BlasterParams, blaster_ode
from mpc_blaster_tpu_torch.dynamics.integrators import discrete_dynamics
from mpc_blaster_tpu_torch.ocp.spec import build_spec, total_cost
from mpc_blaster_tpu_torch.sqp.rti import init_rti_state, sqp_solve
from torch_threads import one_intraop_thread  # noqa: F401

# The port runs on the CUDA card unless asked for the CPU; these tests
# ask for it.
DEV = torch.device("cpu")
DTYPE = torch.float64
N = 8


def _make_problem(r_swivel=None, ubu_thrust=None, yref_z=3.5,
                  yref_poc_x=0.2):
    preset = cfg.simulation_preset()
    ocp = dataclasses.replace(preset.ocp, N=N, Tf=N / 30.0)
    if r_swivel is not None:
        r = list(ocp.cost.r_diag)
        r[4] = r[5] = r_swivel
        ocp = dataclasses.replace(
            ocp, cost=dataclasses.replace(ocp.cost, r_diag=tuple(r)))
    if ubu_thrust is not None:
        ubu = (ubu_thrust,) * 4 + tuple(ocp.bounds.ubu[4:])
        ocp = dataclasses.replace(
            ocp, bounds=dataclasses.replace(ocp.bounds, ubu=ubu))
    yref = np.zeros(cfg.NY)
    yref[2] = yref_z
    yref[14] = yref_poc_x
    spec = build_spec(ocp, yref=yref, dtype=DTYPE, device=DEV)
    params = BlasterParams.from_config(ocp.model, DTYPE, device=DEV)
    F = discrete_dynamics(blaster_ode, ocp.dt, num_steps=1)
    return ocp, spec, params, F


def _x0(**entries):
    x = torch.zeros(cfg.NX, dtype=DTYPE)
    for k, v in entries.items():
        x[int(k[1:])] = v
    return x


def _rollout(spec, params, F, x0, us):
    xs = [x0]
    for u in us:
        xs.append(F(xs[-1], u, spec.stage_params[0], params))
    return torch.stack(xs)


def _slsqp(cost, cons, u_init, bounds, maxiter, ftol):
    """SLSQP with exact float64 gradients (`torch.func`), every function
    evaluated once before `minimize` (the JAX helper warms its jitted
    functions there, tests/test_oracle.py:103-108)."""
    vg = grad(cost)
    cj = jacfwd(cons)

    def fun(u_flat):
        u = torch.as_tensor(u_flat, dtype=DTYPE)
        return float(cost(u)), vg(u).numpy()

    constraints = [{
        "type": "ineq",
        "fun": lambda u: cons(torch.as_tensor(u, dtype=DTYPE)).numpy(),
        "jac": lambda u: cj(torch.as_tensor(u, dtype=DTYPE)).numpy(),
    }]
    u0_flat = np.asarray(u_init, np.float64).ravel()
    fun(u0_flat)
    constraints[0]["fun"](u0_flat)
    constraints[0]["jac"](u0_flat)
    res = minimize(fun, u0_flat, jac=True, method="SLSQP", bounds=bounds,
                   constraints=constraints,
                   options={"maxiter": maxiter, "ftol": ftol})
    assert res.success, res.message
    return res


def _control_bounds(spec, n):
    return [(float(spec.lbu[i]), float(spec.ubu[i]))
            for _ in range(n) for i in range(cfg.NU)]


def _oracle_solve(spec, params, F, x0, u_init, ftol=1e-12):
    """SLSQP on the single-shooting NLP: control bounds as variable
    bounds, state boxes as inequality constraints."""
    n = spec.horizon

    def cost(u_flat):
        us = u_flat.reshape(n, cfg.NU)
        return total_cost(spec, _rollout(spec, params, F, x0, us), us)

    def cons(u_flat):
        xs = _rollout(spec, params, F, x0, u_flat.reshape(n, cfg.NU))[1:]
        return torch.cat([(xs - spec.lbx).ravel(), (spec.ubx - xs).ravel()])

    res = _slsqp(cost, cons, u_init, _control_bounds(spec, n), 600, ftol)
    us = torch.as_tensor(res.x.reshape(n, cfg.NU), dtype=DTYPE)
    # the oracle itself satisfies the state boxes it enforces
    assert float(cons(torch.as_tensor(res.x)).min()) > -1e-6
    return _rollout(spec, params, F, x0, us), us, res.fun


def _sqp_fixed_point(ocp, spec, params, F, x0, iters=40):
    state = init_rti_state(ocp, x0, DTYPE)
    state, step_norms = sqp_solve(spec, state, x0, params, F, ocp.solver,
                                  iters=iters)
    return state, step_norms.numpy()


@pytest.mark.slow
def test_oracle_hover_nlp():
    """(a) Hover OCP, reference cost: thrusts match <= 1e-3, objective to
    1e-6 relative (the gimbal rates lie in the R_swivel=1e-5 flat
    subspace)."""
    ocp, spec, params, F = _make_problem()
    x0 = _x0(x0=0.1, x1=-0.1, x2=3.3)
    state, step_norms = _sqp_fixed_point(ocp, spec, params, F, x0)
    assert step_norms[-1] < 1e-7, step_norms[-5:]
    _, us_o, f_o = _oracle_solve(spec, params, F, x0, state.ubar)
    np.testing.assert_allclose(state.ubar[:, :4].numpy(),
                               us_o[:, :4].numpy(), atol=1e-3)
    f_rti = float(total_cost(spec, state.xbar, state.ubar))
    assert abs(f_rti - f_o) <= 1e-6 * max(1.0, abs(f_o)), (f_rti, f_o)


@pytest.mark.slow
def test_oracle_well_posed_all_controls():
    """(b) A well-posed R_swivel: every control of the converged SQP
    matches the independent optimizer <= 1e-3."""
    ocp, spec, params, F = _make_problem(r_swivel=1e-1)
    x0 = _x0(x2=3.2, x6=0.2)
    state, step_norms = _sqp_fixed_point(ocp, spec, params, F, x0)
    assert step_norms[-1] < 1e-7
    _, us_o, _ = _oracle_solve(spec, params, F, x0, state.ubar)
    np.testing.assert_allclose(state.ubar.numpy(), us_o.numpy(), atol=1e-3)


@pytest.mark.slow
def test_oracle_active_control_bounds():
    """(c) Thrust saturation: ubu barely above hover makes the upper
    control bound active during the climb; the constrained optimum still
    matches (the flight preset's r_swivel=1e1, as in the JAX file)."""
    hover = 9.0 * 9.81 / 4.0
    ocp, spec, params, F = _make_problem(r_swivel=1e1,
                                         ubu_thrust=hover + 1.5,
                                         yref_poc_x=0.0)
    x0 = _x0(x2=3.3)
    state, step_norms = _sqp_fixed_point(ocp, spec, params, F, x0)
    assert step_norms[-1] < 1e-6, step_norms[-5:]
    _, us_o, _ = _oracle_solve(spec, params, F, x0, state.ubar)
    # the bound is active somewhere, or the scenario is vacuous
    assert (us_o[:, :4].numpy() > hover + 1.5 - 1e-6).any()
    np.testing.assert_allclose(state.ubar.numpy(), us_o.numpy(), atol=1e-3)


@pytest.mark.slow
def test_oracle_closed_loop():
    """(d) The closed loop: converged-SQP MPC against the oracle MPC
    (SLSQP solved per tick), the same plant and x0; positions and
    velocities agree to <= 1e-3 over 8 ticks (the active transient)."""
    ocp, spec, params, F = _make_problem(r_swivel=1e-1)
    x_rti = _x0(x2=3.25, x0=0.05)
    x_orc = x_rti.clone()
    state = init_rti_state(ocp, x_rti, DTYPE)
    u_prev = state.ubar
    xs_rti, xs_orc = [x_rti.numpy()], [x_orc.numpy()]
    for _ in range(8):
        state, _ = sqp_solve(spec, state, x_rti, params, F, ocp.solver,
                             iters=25)
        x_rti = F(x_rti, state.ubar[0], spec.stage_params[0], params)
        xs_rti.append(x_rti.numpy())
        _, us_o, _ = _oracle_solve(spec, params, F, x_orc, u_prev,
                                   ftol=1e-10)
        u_prev = us_o
        x_orc = F(x_orc, us_o[0], spec.stage_params[0], params)
        xs_orc.append(x_orc.numpy())
    np.testing.assert_allclose(np.stack(xs_rti)[:, 0:9],
                               np.stack(xs_orc)[:, 0:9], atol=1e-3)


@pytest.mark.slow
def test_oracle_flagship_n60_poc_params():
    """(e) The simulation preset at its native N=60 with the jet solver's
    non-zero POC stage parameters: thrusts <= 2e-3 (SLSQP's own accuracy
    on the 360-variable problem), objective to 1e-6 relative."""
    from mpc_blaster_tpu_torch.sim.closedloop import preset_stage_params
    preset = cfg.simulation_preset()
    ocp = preset.ocp
    sp = preset_stage_params(preset, DTYPE, device=DEV)
    spec = build_spec(ocp, yref=preset.loop.yref, stage_params=sp,
                      dtype=DTYPE, device=DEV)
    assert float(spec.stage_params[0, :24].abs().max()) > 0.0
    params = BlasterParams.from_config(ocp.model, DTYPE, device=DEV)
    F = discrete_dynamics(blaster_ode, ocp.dt, num_steps=1)
    x0 = _x0(x0=0.1, x2=3.3)
    state, step_norms = sqp_solve(spec, init_rti_state(ocp, x0, DTYPE), x0,
                                  params, F, ocp.solver, iters=30)
    assert step_norms.numpy()[-1] < 1e-5
    _, us_o, f_o = _oracle_solve(spec, params, F, x0, state.ubar)
    np.testing.assert_allclose(state.ubar[:, :4].numpy(),
                               us_o[:, :4].numpy(), atol=2e-3)
    f_rti = float(total_cost(spec, state.xbar, state.ubar))
    assert abs(f_rti - f_o) <= 1e-6 * max(1.0, abs(f_o)), (f_rti, f_o)


@pytest.mark.slow
def test_oracle_soft_bounds():
    """(f) Soft bounds: the velocity box tightened to +-0.25 so that the
    optimum violates it, softened with a pure-L2 penalty (Z=1e3). The
    `rti_step_soft` fixed point matches SLSQP on the penalized NLP (the
    soft rows leave the hard constraints, their penalty enters the
    objective) from an independent perturbed start, every control
    <= 1e-3."""
    from mpc_blaster_tpu_torch.qp.soft import SoftBounds
    from mpc_blaster_tpu_torch.sqp.rti import rti_step_soft
    preset = cfg.simulation_preset()
    b = preset.ocp.bounds
    tight = dataclasses.replace(
        b, lbx=b.lbx[:6] + (-0.25, -0.25, -0.25) + b.lbx[9:],
        ubx=b.ubx[:6] + (0.25, 0.25, 0.25) + b.ubx[9:])
    r = list(preset.ocp.cost.r_diag)
    r[4] = r[5] = 1e-1
    ocp = dataclasses.replace(
        preset.ocp, N=N, Tf=N / 30.0, bounds=tight,
        cost=dataclasses.replace(preset.ocp.cost, r_diag=tuple(r)),
        solver=dataclasses.replace(preset.ocp.solver, ipm_iters=25))
    spec = build_spec(ocp, yref=preset.loop.yref, dtype=DTYPE, device=DEV)
    params = BlasterParams.from_config(ocp.model, DTYPE, device=DEV)
    F = discrete_dynamics(blaster_ode, ocp.dt, num_steps=1)
    x0 = _x0(x2=2.9)
    Z = 1e3
    soft = SoftBounds.state_bounds(N, cfg.NX, cfg.NU, Zl=Z, zl=0.0,
                                   idx=[6, 7, 8], dtype=DTYPE, device=DEV)
    st = init_rti_state(ocp, x0, DTYPE)
    for _ in range(60):
        _, st, _, _ = rti_step_soft(spec, st, x0, params, F, ocp.solver,
                                    soft)
    _, st, diag, res = rti_step_soft(spec, st, x0, params, F, ocp.solver,
                                     soft)
    assert float(diag.qp_kkt_eq) < 1e-8
    viol = float(res.t_lx.max() + res.t_ux.max())
    assert viol > 0.05, "soft bounds not active; scenario vacuous"
    hard = [i for i in range(cfg.NX) if i not in (6, 7, 8)]

    def cost(u_flat):
        us = u_flat.reshape(N, cfg.NU)
        xs = _rollout(spec, params, F, x0, us)
        v = xs[1:, 6:9]
        lo = torch.clamp(spec.lbx[6:9] - v, min=0.0)
        hi = torch.clamp(v - spec.ubx[6:9], min=0.0)
        return total_cost(spec, xs, us) + 0.5 * Z * (
            (lo ** 2).sum() + (hi ** 2).sum())

    def cons(u_flat):
        xs = _rollout(spec, params, F, x0, u_flat.reshape(N, cfg.NU))[1:]
        xs = xs[:, hard]
        return torch.cat([(xs - spec.lbx[hard]).ravel(),
                          (spec.ubx[hard] - xs).ravel()])

    rng = np.random.default_rng(3)
    u_init = (init_rti_state(ocp, x0, DTYPE).ubar.numpy()
              + rng.uniform(-0.5, 0.5, (N, cfg.NU)))
    res_o = _slsqp(cost, cons, u_init, _control_bounds(spec, N), 400, 1e-12)
    np.testing.assert_allclose(st.ubar.numpy(),
                               res_o.x.reshape(N, cfg.NU), atol=1e-3)


def test_rti_step_is_one_exact_gauss_newton_step():
    """The acados SQP-RTI single-iteration semantics: one `rti_step` from a
    retained iterate equals one full Gauss-Newton step computed by hand
    (linearize, assemble the LINEAR_LS QP, solve the equality-constrained
    KKT system densely in numpy float64, take the full step). Every box
    is widened so that no bound is active; the IPM (30 iterations) must
    reach the same stationary point."""
    import numpy.linalg as npl
    from mpc_blaster_tpu_torch.sqp.rti import build_qp, rti_step
    preset = cfg.simulation_preset()
    wide = cfg.BoundsConfig(lbx=tuple([-1e4] * cfg.NX),
                            ubx=tuple([1e4] * cfg.NX),
                            lbu=tuple([-1e4] * cfg.NU),
                            ubu=tuple([1e4] * cfg.NU))
    ocp = dataclasses.replace(preset.ocp, N=6, Tf=0.2, bounds=wide,
                              solver=dataclasses.replace(
                                  preset.ocp.solver, ipm_iters=30))
    spec = build_spec(ocp, yref=preset.loop.yref, dtype=DTYPE, device=DEV)
    params = BlasterParams.from_config(ocp.model, DTYPE, device=DEV)
    F = discrete_dynamics(blaster_ode, ocp.dt, num_steps=1)
    x0 = _x0(x2=3.3, x0=0.05)
    state = init_rti_state(ocp, x0, DTYPE)

    u0, new_state, _ = rti_step(spec, state, x0, params, F, ocp.solver)

    qp = build_qp(spec, state, x0, F, params)
    n, nx, nu = ocp.N, cfg.NX, cfg.NU
    nz = (n + 1) * nx + n * nu     # decision: every dx and du
    nc = (n + 1) * nx              # constraints: the dx0 pin, n dynamics
    H = np.zeros((nz, nz))
    g = np.zeros(nz)
    A, B = qp.A.numpy(), qp.B.numpy()

    def xi(k):
        return slice(k * nx, (k + 1) * nx)

    def ui(k):
        return slice((n + 1) * nx + k * nu, (n + 1) * nx + (k + 1) * nu)

    for k in range(n + 1):
        H[xi(k), xi(k)] = qp.Q[k].numpy()
        g[xi(k)] = qp.q[k].numpy()
    for k in range(n):
        H[ui(k), ui(k)] = qp.R[k].numpy()
        g[ui(k)] = qp.r[k].numpy()
    C = np.zeros((nc, nz))
    b = np.zeros(nc)
    C[0:nx, xi(0)] = np.eye(nx)
    b[0:nx] = qp.dx0.numpy()
    for k in range(n):
        rows = slice((k + 1) * nx, (k + 2) * nx)
        C[rows, xi(k)] = A[k]
        C[rows, ui(k)] = B[k]
        C[rows, xi(k + 1)] = -np.eye(nx)
        b[rows] = -qp.c[k].numpy()
    KKT = np.block([[H, C.T], [C, np.zeros((nc, nc))]])
    sol = npl.solve(KKT, np.concatenate([-g, b]))
    dx_ref = sol[: (n + 1) * nx].reshape(n + 1, nx)
    du_ref = sol[(n + 1) * nx: nz].reshape(n, nu)

    np.testing.assert_allclose(new_state.xbar.numpy(),
                               state.xbar.numpy() + dx_ref, atol=1e-7)
    np.testing.assert_allclose(new_state.ubar.numpy(),
                               state.ubar.numpy() + du_ref, atol=1e-6)
    np.testing.assert_allclose(u0.numpy(),
                               state.ubar[0].numpy() + du_ref[0], atol=1e-6)
