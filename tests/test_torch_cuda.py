"""The CUDA box-QP IPM kernel against its plain twins, on an NVIDIA GPU:
the plain mode (`box_qp_solve`), the fuse_cost mode (`batched_fused_tick`)
and the fuse_lin mode (`fused_rti_solve`), whose linearization prologue is
also held pointwise against `dynamics/fastlin.py::fast_linearize`; and
each mode's warm-start blend (K3) with its valid=0, NaN and skip
semantics; the soft-bound instantiations (K4) of the plain and fuse_lin
modes, with the all-hard case against the hard kernel; the instantiations
for other models: the plain mode at 13x4 (the quad13 model) and the
fuse_lin mode with the "quad13" and "blaster_dist" prologues; the
fuse_lin mode with stage parameters that differ from stage to stage (the
blast scan's online_stagewise ticks); the plain mode at long horizons (K7, N=120 and 240: a batch, and a
single problem on the cluster plan against the twin in its order, also
captured in a CUDA graph); the fuse_lin mode over a
batch with one spec per problem (K6 at B > 1); the launch plan (the
library's `box_qp_ipm_plan` against `launch_plan`, a launch of each
layout, resident and global, against its twin and counted in
`by_layout`, and the single plan of a B=1 launch against the batch plan
on the same problem twice); and the hardware probes P1 and P2
(`ops/probes.py`).

Needs the card (marker `cuda`; skipped without one) and imports no JAX, so
it also runs where only the port's dependencies are installed:

    python -m pytest --noconftest -o addopts="" tests/test_torch_cuda.py -q

Tolerances as in tests/test_torch_ipm.py: one IPM iteration pointwise (u0
atol 2e-3, dx/du atol 5e-3); the full budget on the QP objective (1.2e-2
relative) and kkt_eq (rtol 0.2 / atol 1e-3), because past a few iterations
f32 rounding moves the weakly determined rotor-thrust split. The fused
modes' step norms and bound violation: rtol 0.05 / atol 1e-3
(tests/test_batched_fused.py). The prologue's A, B and c: rtol and atol
2e-4 (tests/test_fastlin.py's float32 bound; dual-number rounding is not
jvp's).
"""
import dataclasses

import numpy as np
import pytest
import torch
from torch.func import vmap

from mpc_blaster_tpu_torch import config as cfg
from mpc_blaster_tpu_torch.dynamics.blaster import BlasterParams, blaster_ode
from mpc_blaster_tpu_torch.dynamics.integrators import discrete_dynamics
from mpc_blaster_tpu_torch.ocp.spec import build_spec
from mpc_blaster_tpu_torch.ops import box_qp_ipm as K
from mpc_blaster_tpu_torch.qp.data import qp_objective
from mpc_blaster_tpu_torch.sqp.rti import (RTIState, build_qp,
                                           fused_dyn_statics, init_rti_state)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


def _blaster_qps(dev, B=3, N=8):
    """Linearized BLASTER QPs at different states, built by the port on
    `dev` (the construction of tests/test_torch_ipm.py)."""
    pre = cfg.simulation_preset()
    ocp = dataclasses.replace(pre.ocp, N=N, Tf=N / 30.0)
    spec = build_spec(ocp, yref=pre.loop.yref, device=dev)
    rng = np.random.default_rng(0)
    x0s = np.zeros((B, cfg.NX), np.float32)
    x0s[:, 0:3] = rng.uniform(-0.4, 0.4, (B, 3))
    x0s[:, 2] = rng.uniform(1.5, 3.4, B)
    x0 = torch.as_tensor(x0s, device=dev)
    st = init_rti_state(ocp, x0)
    F = discrete_dynamics(blaster_ode, ocp.dt)
    P = BlasterParams.from_config(ocp.model, device=dev)
    return vmap(lambda xb, ub, x: build_qp(spec, RTIState(xb, ub), x, F, P))(
        st.xbar, st.ubar, x0)


@pytest.mark.cuda
@pytest.mark.parametrize("iters", [1, 10])
def test_kernel_matches_plain_on_gpu(cuda_device, iters):
    qp = _blaster_qps(cuda_device)
    n0 = K.box_qp_solve.launches
    sk = K.box_qp_solve(qp, iters=iters)
    torch.cuda.synchronize()
    assert K.box_qp_solve.launches == n0 + 1
    sp = K.box_qp_solve_plain(qp, iters=iters)
    assert torch.isfinite(sk.dx).all() and torch.isfinite(sk.du).all()
    if iters == 1:
        assert (sk.du[:, 0] - sp.du[:, 0]).abs().max().item() <= 2e-3
        torch.testing.assert_close(sk.du, sp.du, rtol=0, atol=5e-3)
        torch.testing.assert_close(sk.dx, sp.dx, rtol=0, atol=5e-3)
        return
    ok = vmap(qp_objective)(qp, sk.dx, sk.du)
    op = vmap(qp_objective)(qp, sp.dx, sp.du)
    assert ((ok - op).abs() / op.abs().clamp(min=1.0) < 1.2e-2).all(), (ok, op)
    torch.testing.assert_close(sk.kkt_eq, sp.kkt_eq, rtol=0.2, atol=1e-3)


def _fused_inputs(dev, B=3, N=8):
    """A perturbed hover iterate with its fused-tick arguments, on `dev`:
    (ocp, spec, xbar, ubar, x0, the ten spec arguments broadcast to B)."""
    pre = cfg.simulation_preset()
    ocp = dataclasses.replace(pre.ocp, N=N, Tf=N / 30.0)
    spec = build_spec(ocp, yref=pre.loop.yref, device=dev)
    rng = np.random.default_rng(1)
    x0s = np.zeros((B, cfg.NX), np.float32)
    x0s[:, 0:3] = rng.uniform(-0.4, 0.4, (B, 3))
    x0s[:, 2] += 2.0
    x0 = torch.as_tensor(x0s, device=dev)
    st = init_rti_state(ocp, x0)
    # inside the boxes, as the main path's iterates are
    xbar = st.xbar + torch.as_tensor(
        rng.uniform(-0.02, 0.02, st.xbar.shape), dtype=torch.float32,
        device=dev)
    du = np.zeros(st.ubar.shape, np.float32)
    du[..., 0:4] = rng.uniform(-0.5, 0.5, du[..., 0:4].shape)
    ubar = st.ubar + torch.as_tensor(du, device=dev)

    def bc(a):
        return a.expand(B, *a.shape)
    args = (bc(spec.dt * spec.Q), bc(spec.Q_t), bc(spec.dt * spec.R),
            bc(spec.yref_x), bc(spec.yref_u), bc(spec.yref_e),
            bc(spec.lbx), bc(spec.ubx), bc(spec.lbu), bc(spec.ubu))
    return ocp, spec, xbar, ubar, x0, args


def _fused_qp(f_args, A, Bm, c):
    """The QP the fused modes assemble, for the objective comparison."""
    xbar, ubar, x0, args = f_args
    return K._fused_qp(K._fused_prep(xbar, ubar, x0, *args, None), A, Bm, c)


@pytest.mark.cuda
@pytest.mark.parametrize("iters", [1, 6])
def test_fuse_cost_kernel_matches_plain_on_gpu(cuda_device, iters):
    from mpc_blaster_tpu_torch.dynamics.fastlin import fast_linearize
    ocp, spec, xbar, ubar, x0, args = _fused_inputs(cuda_device)
    P = BlasterParams.from_config(ocp.model, device=cuda_device)
    xp, A, Bm = fast_linearize(xbar, ubar, spec.stage_params, P, ocp.dt)
    AB, c = torch.cat([A, Bm], -1), xp - xbar[:, 1:]
    n0 = K.batched_fused_tick.launches
    xk, uk, dk, _ = K.batched_fused_tick(AB, c, xbar, ubar, x0, *args,
                                         iters=iters)
    torch.cuda.synchronize()
    assert K.batched_fused_tick.launches == n0 + 1
    xp_, up_, dp_, _ = K.batched_fused_tick_plain(AB, c, xbar, ubar, x0,
                                                  *args, iters=iters)
    assert torch.isfinite(xk).all() and torch.isfinite(uk).all()
    if iters == 1:
        assert (uk[:, 0] - up_[:, 0]).abs().max().item() <= 2e-3
        torch.testing.assert_close(xk, xp_, rtol=0, atol=5e-3)
        torch.testing.assert_close(uk, up_, rtol=0, atol=5e-3)
    else:
        qp = _fused_qp((xbar, ubar, x0, args), A, Bm, c)
        ok = vmap(qp_objective)(qp, xk - xbar, uk - ubar)
        op = vmap(qp_objective)(qp, xp_ - xbar, up_ - ubar)
        assert ((ok - op).abs() / op.abs().clamp(min=1.0) < 1.2e-2).all()
    torch.testing.assert_close(dk["kkt_eq"], dp_["kkt_eq"], rtol=0.2,
                               atol=1e-3)
    for f in ("step_norm_x", "step_norm_u", "bound_viol"):
        torch.testing.assert_close(dk[f], dp_[f], rtol=0.05, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("iters", [1, 6])
def test_fuse_lin_kernel_matches_plain_on_gpu(cuda_device, iters):
    ocp, spec, xbar, ubar, x0, args = _fused_inputs(cuda_device, B=1)
    model, dt, nsteps = fused_dyn_statics(ocp)
    sp = spec.stage_params[None]
    n0 = K.fused_rti_solve.launches
    sk, (Ak, Bk, ck) = K.fused_rti_solve(
        xbar, ubar, sp, x0, *args, model=model, dt=dt, num_steps=nsteps,
        iters=iters, return_lin=True)
    torch.cuda.synchronize()
    assert K.fused_rti_solve.launches == n0 + 1
    spl, (Ap, Bp, cp) = K.fused_rti_solve_plain(
        xbar, ubar, sp, x0, *args, model=model, dt=dt, num_steps=nsteps,
        iters=iters, return_lin=True)
    # the prologue against fast_linearize, pointwise
    for g, r in ((Ak, Ap), (Bk, Bp), (ck, cp)):
        torch.testing.assert_close(g, r, rtol=2e-4, atol=2e-4)
    assert torch.isfinite(sk.dx).all() and torch.isfinite(sk.du).all()
    if iters == 1:
        assert (sk.du[:, 0] - spl.du[:, 0]).abs().max().item() <= 2e-3
        torch.testing.assert_close(sk.du, spl.du, rtol=0, atol=5e-3)
        torch.testing.assert_close(sk.dx, spl.dx, rtol=0, atol=5e-3)
    else:
        qp = _fused_qp((xbar, ubar, x0, args), Ap, Bp, cp)
        ok = vmap(qp_objective)(qp, sk.dx, sk.du)
        op = vmap(qp_objective)(qp, spl.dx, spl.du)
        assert ((ok - op).abs() / op.abs().clamp(min=1.0) < 1.2e-2).all()
    torch.testing.assert_close(sk.kkt_eq, spl.kkt_eq, rtol=0.2, atol=1e-3)


def _warm_from(sol, B):
    """The "fastest" chain's warm start from a solve (shifted, primal
    re-centred), with problem 1 invalid and problem 2 poisoned by NaN and
    +inf entries."""
    from mpc_blaster_tpu_torch.qp.ipm import (warm_start_from,
                                              warm_start_recenter)
    w = warm_start_recenter(warm_start_from(sol, shift=True), mode="primal")
    w = w._replace(**{f: getattr(w, f).clone() for f in w._fields})
    if B > 1:
        w.valid[1] = 0.0
    j = B - 1
    w.s_lu[j, :2] = float("nan")
    w.lam_lx[j, 1, :3] = float("nan")
    w.s_ux[j, 2, 0] = float("inf")
    w.lam_uu[j, 0, 1] = float("inf")
    return w


def _warm_calls(dev, mode):
    """(kernel call, plain twin call) of one mode on the test inputs, each
    taking (iters, warm, skip)."""
    if mode == "plain":
        qp = _blaster_qps(dev)
        return (lambda it, w=None, skip=None: K.box_qp_solve(
                    qp, iters=it, warm=w, skip=skip),
                lambda it, w=None: K.box_qp_solve_plain(qp, iters=it,
                                                        warm=w))
    from mpc_blaster_tpu_torch.dynamics.fastlin import fast_linearize
    B = 1 if mode == "fuse_lin" else 3
    ocp, spec, xbar, ubar, x0, args = _fused_inputs(dev, B=B)
    if mode == "fuse_cost":
        P = BlasterParams.from_config(ocp.model, device=dev)
        xp, A, Bm = fast_linearize(xbar, ubar, spec.stage_params, P, ocp.dt)
        fa = (torch.cat([A, Bm], -1), xp - xbar[:, 1:], xbar, ubar, x0,
              *args)
        return (lambda it, w=None, skip=None: K.batched_fused_tick(
                    *fa, iters=it, warm=w)[3],
                lambda it, w=None: K.batched_fused_tick_plain(
                    *fa, iters=it, warm=w)[3])
    model, dt, nsteps = fused_dyn_statics(ocp)
    fa = (xbar, ubar, spec.stage_params[None], x0, *args)
    kw = dict(model=model, dt=dt, num_steps=nsteps)
    return (lambda it, w=None, skip=None: K.fused_rti_solve(
                *fa, iters=it, warm=w, skip=skip, **kw),
            lambda it, w=None: K.fused_rti_solve_plain(*fa, iters=it,
                                                       warm=w, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["plain", "fuse_cost", "fuse_lin"])
def test_warm_kernel_matches_plain_on_gpu(cuda_device, mode):
    """K3: with 0 IPM iterations the kernel returns its blended initial
    slacks and duals, held pointwise against the twin (rtol 1e-5 / atol
    1e-6) on valid, invalid and NaN/+inf-poisoned problems; valid=0 is the
    cold launch bit for bit; no output shares storage with a warm input;
    a launch with skip=True is counted and returns."""
    kern, plain = _warm_calls(cuda_device, mode)
    prev = kern(3)
    B = prev.du.shape[0]
    w = _warm_from(prev, B)
    sk, sp = kern(0, w), plain(0, w)
    torch.cuda.synchronize()
    for f in ("s_lx", "s_ux", "s_lu", "s_uu",
              "lam_lx", "lam_ux", "lam_lu", "lam_uu"):
        torch.testing.assert_close(getattr(sk, f), getattr(sp, f),
                                   rtol=1e-5, atol=1e-6, msg=f)
    ins = {t.untyped_storage().data_ptr() for t in w}
    for f, t in sk._asdict().items():
        if isinstance(t, torch.Tensor):
            assert t.untyped_storage().data_ptr() not in ins, f
    for it in (1, 6):
        a, c = kern(it, w), kern(it)
        torch.cuda.synchronize()
        assert torch.isfinite(a.du).all() and torch.isfinite(a.dx).all()
        off = kern(it, w._replace(valid=torch.zeros_like(w.valid)))
        for f in ("dx", "du", "s_lx", "lam_uu", "kkt_eq"):
            assert torch.equal(getattr(off, f), getattr(c, f)), f
        if B > 1:
            assert torch.equal(a.du[1], c.du[1])
    if mode != "fuse_cost":
        launches = getattr(K, "box_qp_solve" if mode == "plain"
                           else "fused_rti_solve")
        n1 = launches.launches
        kern(3, w, skip=torch.tensor(True, device=cuda_device))
        torch.cuda.synchronize()
        assert launches.launches == n1 + 1
        a = kern(3, w, skip=torch.tensor(False, device=cuda_device))
        b = kern(3, w)
        assert torch.equal(a.du, b.du) and torch.equal(a.s_lu, b.s_lu)


def _soft_calls(dev, mode):
    """(kernel call, plain twin call, the QP) of one mode on the out-of-box
    inputs: dx0 pushed 2.2 past the x box (plain, B=3) or x0[0] moved out
    to 2.4 (fuse_lin, B=1); each call takes (iters, soft)."""
    if mode == "plain":
        qp = _blaster_qps(dev)
        qp = qp._replace(dx0=qp.dx0.clone())
        qp.dx0[:, 0] += 2.2
        return (lambda it, s: K.box_qp_solve(qp, iters=it, soft=s),
                lambda it, s: K.box_qp_solve_plain(qp, iters=it, soft=s), qp)
    from mpc_blaster_tpu_torch.dynamics.fastlin import fast_linearize
    ocp, spec, xbar, ubar, x0, args = _fused_inputs(dev, B=1)
    x0 = x0.clone()
    x0[0, 0] = 2.4
    model, dt, nsteps = fused_dyn_statics(ocp)
    fa = (xbar, ubar, spec.stage_params[None], x0, *args)
    kw = dict(model=model, dt=dt, num_steps=nsteps)
    P = BlasterParams.from_config(ocp.model, device=dev)
    xp, A, Bm = fast_linearize(xbar, ubar, spec.stage_params, P, ocp.dt)
    qp = _fused_qp((xbar, ubar, x0, args), A, Bm, xp - xbar[:, 1:])
    return (lambda it, s: K.fused_rti_solve(*fa, iters=it, soft=s, **kw),
            lambda it, s: K.fused_rti_solve_plain(*fa, iters=it, soft=s,
                                                  **kw), qp)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["plain", "fuse_lin"])
def test_soft_kernel_matches_plain_on_gpu(cuda_device, mode):
    """K4: an all-hard SoftBounds through the soft instantiation equals the
    hard kernel after one iteration (bit for bit, or within 1e-6 relative
    where nvcc contracts a multiply-add differently in the two
    instantiations); soft position bounds (Zl=1e3, zl=1e2) after one
    iteration pointwise against the twin (u0 atol 2e-3, dx/du atol 5e-3),
    after 12 on the penalized objective (2e-3 relative + 1e-3); outputs are
    fresh; launches and soft launches are counted."""
    from mpc_blaster_tpu_torch.qp.soft import (SoftBounds, SoftPenalty,
                                               soft_qp_objective)
    kern, plain, qp = _soft_calls(cuda_device, mode)
    N = qp.A.shape[1]
    soft = SoftBounds.state_bounds(N, cfg.NX, cfg.NU, Zl=1e3, zl=1e2,
                                   idx=(0, 1, 2), device=cuda_device)
    hard = SoftBounds(*(SoftPenalty.hard((N, w), device=cuda_device)
                        for w in (cfg.NX, cfg.NX, cfg.NU, cfg.NU)))
    wrapper = K.box_qp_solve if mode == "plain" else K.fused_rti_solve
    key = K.instance_name(cfg.NX, cfg.NU,
                          None if mode == "plain" else "blaster", soft=True)
    n0, s0 = wrapper.launches, wrapper.by_instance.get(key, 0)
    a, b = kern(1, None), kern(1, hard)
    torch.cuda.synchronize()
    assert (wrapper.launches, wrapper.by_instance.get(key, 0)) == (n0 + 2,
                                                                  s0 + 1)
    for f in ("dx", "du", "s_lx", "lam_ux", "mu"):
        x, y = getattr(a, f), getattr(b, f)
        assert torch.equal(x, y) or torch.allclose(x, y, rtol=1e-6,
                                                   atol=0.0), f
    c = kern(1, hard)
    assert c.du.data_ptr() != b.du.data_ptr()     # fresh outputs
    for iters in (1, 12):
        sk, sp = kern(iters, soft), plain(iters, soft)
        torch.cuda.synchronize()
        assert torch.isfinite(sk.dx).all() and torch.isfinite(sk.du).all()
        if iters == 1:
            assert (sk.du[:, 0] - sp.du[:, 0]).abs().max().item() <= 2e-3
            torch.testing.assert_close(sk.du, sp.du, rtol=0, atol=5e-3)
            torch.testing.assert_close(sk.dx, sp.dx, rtol=0, atol=5e-3)
            continue
        ok = soft_qp_objective(qp, soft, sk.dx, sk.du)   # per problem
        op = soft_qp_objective(qp, soft, sp.dx, sp.du)
        assert ((ok - op).abs() <= 2e-3 * op.abs() + 1e-3).all(), (ok, op)


def _quad13_case(dev, B=3, N=8):
    """Linearized quad13 QPs around hover at z=1 (x0 spread +-0.4 m), the
    spec and the iterate, built by the port on `dev`."""
    from mpc_blaster_tpu_torch.models.quad13 import (
        Quad13Config, _params, build_quad13_spec, hover_state,
        init_quad13_rti_state, quad13_ode)
    c = Quad13Config(N=N, Tf=N / 30.0)
    spec = build_quad13_spec(c, device=dev)
    rng = np.random.default_rng(2)
    x0 = hover_state(1.0, device=dev).repeat(B, 1)
    x0[:, 0:3] += torch.as_tensor(rng.uniform(-0.4, 0.4, (B, 3)),
                                  dtype=torch.float32, device=dev)
    st = init_quad13_rti_state(c, x0)
    F = discrete_dynamics(quad13_ode, c.dt)
    P = _params(c, device=dev)
    qp = vmap(lambda xb, ub, x: build_qp(spec, RTIState(xb, ub), x, F, P))(
        st.xbar, st.ubar, x0)
    return c, spec, x0, st, qp


def _solve_check(sk, spl, lin_k, lin_p, qp, iters):
    for g, r in zip(lin_k, lin_p):
        torch.testing.assert_close(g, r, rtol=2e-4, atol=2e-4)
    assert torch.isfinite(sk.dx).all() and torch.isfinite(sk.du).all()
    if iters == 1:
        assert (sk.du[:, 0] - spl.du[:, 0]).abs().max().item() <= 2e-3
        torch.testing.assert_close(sk.du, spl.du, rtol=0, atol=5e-3)
        torch.testing.assert_close(sk.dx, spl.dx, rtol=0, atol=5e-3)
        return
    ok = vmap(qp_objective)(qp, sk.dx, sk.du)
    op = vmap(qp_objective)(qp, spl.dx, spl.du)
    assert ((ok - op).abs() / op.abs().clamp(min=1.0) < 1.2e-2).all()


@pytest.mark.cuda
@pytest.mark.parametrize("iters", [1, 6])
def test_quad13_plain_kernel_matches_plain_on_gpu(cuda_device, iters):
    """K1 at 13x4: the plain instantiation of the quad13 model."""
    *_, qp = _quad13_case(cuda_device)
    n0 = K.box_qp_solve.launches
    sk = K.box_qp_solve(qp, iters=iters)
    torch.cuda.synchronize()
    assert K.box_qp_solve.launches == n0 + 1
    sp = K.box_qp_solve_plain(qp, iters=iters)
    _solve_check(sk, sp, (), (), qp, iters)
    torch.testing.assert_close(sk.kkt_eq, sp.kkt_eq, rtol=0.2, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("iters", [1, 6])
def test_fuse_lin_quad13_kernel_matches_plain_on_gpu(cuda_device, iters):
    """K6's "quad13" prologue (13x4): the prologue against
    `fast_linearize(family="quad13")`, the solve against the twin."""
    from mpc_blaster_tpu_torch.models.quad13 import quad13_dyn_statics
    c, spec, x0, st, _ = _quad13_case(cuda_device, B=1)
    model, dt, ns = quad13_dyn_statics(c)
    args = tuple(a[None] for a in (
        spec.dt * spec.Q, spec.Q_t, spec.dt * spec.R, spec.yref_x,
        spec.yref_u, spec.yref_e, spec.lbx, spec.ubx, spec.lbu, spec.ubu))
    fa = (st.xbar, st.ubar, spec.stage_params[None], x0, *args)
    kw = dict(model=model, dt=dt, num_steps=ns, iters=iters,
              return_lin=True)
    n0 = K.fused_rti_solve.launches
    sk, lin_k = K.fused_rti_solve(*fa, **kw)
    torch.cuda.synchronize()
    assert K.fused_rti_solve.launches == n0 + 1
    spl, lin_p = K.fused_rti_solve_plain(*fa, **kw)
    qp = _fused_qp((st.xbar, st.ubar, x0, args), *lin_p[:2], lin_p[2])
    _solve_check(sk, spl, lin_k, lin_p, qp, iters)


@pytest.mark.cuda
@pytest.mark.parametrize("iters", [1, 6])
def test_fuse_lin_blaster_dist_kernel_matches_plain_on_gpu(cuda_device,
                                                           iters):
    """K6's "blaster_dist" prologue: six non-zero disturbance rows in
    stage parameters 25-30."""
    ocp, spec, xbar, ubar, x0, args = _fused_inputs(cuda_device, B=1)
    model, dt, ns = fused_dyn_statics(ocp, family="blaster_dist")
    d = torch.tensor([0.7, -0.5, 0.2, 0.05, -0.03, 0.01], device=cuda_device)
    sp = torch.cat([spec.stage_params, d.expand(ocp.N, 6)], -1)[None]
    kw = dict(model=model, dt=dt, num_steps=ns, iters=iters,
              return_lin=True)
    n0 = K.fused_rti_solve.launches
    sk, lin_k = K.fused_rti_solve(xbar, ubar, sp, x0, *args, **kw)
    torch.cuda.synchronize()
    assert K.fused_rti_solve.launches == n0 + 1
    spl, lin_p = K.fused_rti_solve_plain(xbar, ubar, sp, x0, *args, **kw)
    qp = _fused_qp((xbar, ubar, x0, args), *lin_p[:2], lin_p[2])
    _solve_check(sk, spl, lin_k, lin_p, qp, iters)


@pytest.mark.cuda
@pytest.mark.parametrize("iters", [1, 12])
def test_fuse_lin_stagewise_kernel_matches_plain_on_gpu(cuda_device, iters):
    """K6 with stage parameters that differ from stage to stage, as the
    blast scan's online_stagewise ticks give it: each node's POC rows
    linearized at its own pose of the iterate."""
    from mpc_blaster_tpu_torch.poc.solver import poc_stage_params_along
    ocp, spec, xbar, ubar, x0, args = _fused_inputs(cuda_device, B=1, N=60)
    model, dt, ns = fused_dyn_statics(ocp)
    sp = poc_stage_params_along(xbar[0, :-1], spec.stage_params[0, -1],
                                cfg.PocSolverConfig())[None]
    assert (sp[0, 1:] - sp[0, :-1]).abs().amax(-1).min().item() > 1e-4
    kw = dict(model=model, dt=dt, num_steps=ns, iters=iters,
              return_lin=True)
    n0 = K.fused_rti_solve.launches
    sk, lin_k = K.fused_rti_solve(xbar, ubar, sp, x0, *args, **kw)
    torch.cuda.synchronize()
    assert K.fused_rti_solve.launches == n0 + 1
    spl, lin_p = K.fused_rti_solve_plain(xbar, ubar, sp, x0, *args, **kw)
    qp = _fused_qp((xbar, ubar, x0, args), *lin_p[:2], lin_p[2])
    _solve_check(sk, spl, lin_k, lin_p, qp, iters)
    torch.testing.assert_close(sk.kkt_eq, spl.kkt_eq, rtol=0.2, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("N", [120, 240])
def test_long_horizon_kernel_matches_plain_on_gpu(cuda_device, N):
    """K7: the one layout at the long horizons (Tf 4 s and 8 s at 30 Hz),
    B=2, after one iteration and after 12."""
    qp = _blaster_qps(cuda_device, B=2, N=N)
    for iters in (1, 12):
        n0 = K.box_qp_solve.launches
        sk = K.box_qp_solve(qp, iters=iters)
        torch.cuda.synchronize()
        assert K.box_qp_solve.launches == n0 + 1
        sp = K.box_qp_solve_plain(qp, iters=iters)
        _solve_check(sk, sp, (), (), qp, iters)
        if iters > 1:
            torch.testing.assert_close(sk.kkt_eq, sp.kkt_eq, rtol=0.2,
                                       atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("N", [120, 240])
def test_cluster_plan_matches_plain_on_gpu(cuda_device, N):
    """K7's cluster plan (B=1, N >= 61): 8 CTAs of one thread-block
    cluster, against the twin in the plan's order, after one iteration
    and after 12; counted under ("cluster", "single"); a CUDA graph of
    the launch replays it bit for bit."""
    qp = _blaster_qps(cuda_device, B=1, N=N)
    plan = K.launch_plan(N, K.PLAIN, False, 17, 6, 1)
    assert plan.layout == "cluster" and plan.cluster == 8
    info = K.kernel_info(N, K.PLAIN, 17, 6, B=1, device=cuda_device)
    assert info["cluster"] == 8 and info["max_clusters"] >= 1, info
    for iters in (1, 12):
        before = K.box_qp_solve.by_layout.get(("cluster", "single"), 0)
        sk = K.box_qp_solve(qp, iters=iters)
        torch.cuda.synchronize()
        assert K.box_qp_solve.by_layout[("cluster", "single")] == before + 1
        sp = K.box_qp_solve_plain(qp, iters=iters)
        _solve_check(sk, sp, (), (), qp, iters)
        if iters > 1:
            torch.testing.assert_close(sk.kkt_eq, sp.kkt_eq, rtol=0.2,
                                       atol=1e-3)
    ref = K.box_qp_solve(qp, iters=3)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        K.box_qp_solve(qp, iters=3)
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = K.box_qp_solve(qp, iters=3)
    g.replay()
    torch.cuda.synchronize()
    for f in ("dx", "du", "kkt_eq", "mu", "s_lx", "lam_uu"):
        assert torch.equal(getattr(out, f), getattr(ref, f)), f


@pytest.mark.cuda
@pytest.mark.parametrize("iters", [1, 6])
def test_fuse_lin_batched_kernel_matches_plain_on_gpu(cuda_device, iters):
    """K6 over a batch: B=5 problems in one launch, each with its own
    iterate, stage parameters (T_blast) and targets (yref z); the
    prologue, one iteration and the full budget as at B=1."""
    B = 5
    ocp, spec, xbar, ubar, x0, args = _fused_inputs(cuda_device, B=B)
    model, dt, nsteps = fused_dyn_statics(ocp)
    dz = torch.linspace(-0.4, 0.4, B, device=cuda_device)
    args = list(args)
    args[3] = args[3].clone()
    args[3][:, :, 2] += dz[:, None]
    args[5] = args[5].clone()
    args[5][:, 2] += dz
    sp = spec.stage_params.expand(B, *spec.stage_params.shape).clone()
    sp[:, :, 24] *= torch.linspace(0.98, 1.02, B, device=cuda_device)[:, None]
    kw = dict(model=model, dt=dt, num_steps=nsteps, iters=iters,
              return_lin=True)
    n0 = K.fused_rti_solve.launches
    sk, lin_k = K.fused_rti_solve(xbar, ubar, sp, x0, *args, **kw)
    torch.cuda.synchronize()
    assert K.fused_rti_solve.launches == n0 + 1
    spl, lin_p = K.fused_rti_solve_plain(xbar, ubar, sp, x0, *args, **kw)
    qp = _fused_qp((xbar, ubar, x0, args), *lin_p)
    _solve_check(sk, spl, lin_k, lin_p, qp, iters)
    torch.testing.assert_close(sk.kkt_eq, spl.kkt_eq, rtol=0.2, atol=1e-3)


@pytest.mark.cuda
def test_probes_match_plain_on_gpu(cuda_device):
    """P1 reads back 3x at 16 KB and at the card's opt-in ceiling, and
    raises one word above it (and the next launch is clean); P2 equals
    its twin within 1e-5 relative after 1, 3 and 17 steps (where the
    result still depends on y and on the count) and 10^3 steps, 1 and 4
    chains."""
    from mpc_blaster_tpu_torch.ops import probes as P
    optin = P.smem_optin_max(cuda_device)
    assert optin >= 48 * 1024
    x = torch.tensor([1.25], device=cuda_device)
    for nb in (16 * 1024, optin):
        assert P.smem_capacity(x, nb).item() == 3.75
    with pytest.raises(RuntimeError, match="probe_smem_capacity"):
        P.smem_capacity(x, optin + 4)
    rng = np.random.default_rng(0)
    for nc in (1, 4):
        xs, ys = (torch.as_tensor(rng.uniform(0.4, 0.6, (nc, 768)),
                                  dtype=torch.float32, device=cuda_device)
                  for _ in range(2))
        for steps in (1, 3, 17, 1000):
            n0 = P.fma_chain.launches
            got = P.fma_chain(xs, ys, steps)
            torch.cuda.synchronize()
            assert P.fma_chain.launches == n0 + 1
            want = P.fma_chain_plain(xs, ys, steps)
            torch.testing.assert_close(got, want, rtol=1e-5, atol=0)


@pytest.mark.cuda
def test_library_plan_matches_launch_plan_on_gpu(cuda_device):
    """The built library's plan (threads, dynamic shared bytes, layout)
    equals the wrapper's `launch_plan` at every horizon and model, hard and
    soft; each instantiation fits under the opt-in at the plan's shared
    memory."""
    assert K._library().box_qp_ipm_smem_optin() == K.SMEM_OPTIN
    for nx, nu, Ns in ((17, 6, (8, 20, 30, 60, 61, 62, 120, 128, 129, 240)),
                       (13, 4, (8, 20, 237, 238))):
        for N in Ns:
            for mode in (K.PLAIN, K.FUSE_COST, K.FUSE_LIN):
                for soft in (False, True):
                    for B in (1, 2, 1024):
                        assert K.library_plan(N, mode, soft, nx, nu, B) \
                            == K.launch_plan(N, mode, soft, nx, nu, B), \
                            (nx, N, mode, soft, B)
    for nx, nu, mode, family, soft in K.BUILT:
        for B in (1, 1024):
            info = K.kernel_info(60 if nx == 17 else 20, mode, nx, nu,
                                 family, soft, device=cuda_device, B=B)
            single = K.single_plan(mode, B)
            assert info["threads"] == (256 if single else 128), info
            assert info["plan"] == ("single" if single else "batch"), info
            assert info["blocks_per_sm"] >= 1, info


@pytest.mark.cuda
@pytest.mark.parametrize("N,layout", [(20, "resident"), (240, "global")])
def test_layouts_match_plain_on_gpu(cuda_device, N, layout):
    """A resident launch (N=20: the factor stacks in shared memory) and a
    global one (N=240: the stacks in the workspace) each against the twin
    after one iteration, pointwise, and counted under their layout."""
    qp = _blaster_qps(cuda_device, B=2, N=N)
    assert K.launch_plan(N, K.PLAIN, False, 17, 6, 2).layout == layout
    before = dict(K.box_qp_solve.by_layout)
    sk = K.box_qp_solve(qp, iters=1)
    torch.cuda.synchronize()
    after = K.box_qp_solve.by_layout
    assert after.get((layout, "batch"), 0) == \
        before.get((layout, "batch"), 0) + 1
    assert sum(after.values()) == sum(before.values()) + 1
    sp = K.box_qp_solve_plain(qp, iters=1)
    assert (sk.du[:, 0] - sp.du[:, 0]).abs().max().item() <= 2e-3
    torch.testing.assert_close(sk.du, sp.du, rtol=0, atol=5e-3)
    torch.testing.assert_close(sk.dx, sp.dx, rtol=0, atol=5e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["plain", "fuse_lin"])
def test_single_plan_matches_batch_plan_on_gpu(cuda_device, mode):
    """A B=1 launch (the single plan: 256 threads, fuse_lin's prologue as
    a grid of its own) against the same problem twice (B=2, the batch
    plan): the same bits, the warm-started blend, the prologue's record
    and one cold iteration (both plans keep every output's operation
    order, nvcc contracts their multiply-adds alike, and one compiled
    prologue serves both), each launch counted under its plan."""
    dev = cuda_device
    if mode == "plain":
        qp = _blaster_qps(dev, B=1)
        qp2 = type(qp)(*(torch.cat([a, a]) for a in qp))

        def run(it, w, B):
            return K.box_qp_solve(qp if B == 1 else qp2, iters=it, warm=w), \
                None
        twin = K.box_qp_solve_plain(qp, iters=2)
    else:
        ocp, spec, xbar, ubar, x0, args = _fused_inputs(dev, B=1)
        model, dt, nsteps = fused_dyn_statics(ocp)
        fa = (xbar, ubar, spec.stage_params[None], x0, *args)
        fa2 = tuple(torch.cat([a, a]) for a in fa)
        kw = dict(model=model, dt=dt, num_steps=nsteps)

        def run(it, w, B):
            return K.fused_rti_solve(*(fa if B == 1 else fa2), iters=it,
                                     warm=w, return_lin=True, **kw)
        twin = K.fused_rti_solve_plain(*fa, iters=2, **kw)
    from mpc_blaster_tpu_torch.qp.ipm import IpmWarmStart
    w = IpmWarmStart(*(getattr(twin, f) for f in IpmWarmStart._fields[:-1]),
                     valid=torch.ones(1, device=dev))
    w2 = type(w)(*(torch.cat([a, a]) for a in w))
    wrapper = K.box_qp_solve if mode == "plain" else K.fused_rti_solve
    before = dict(wrapper.by_layout)
    for it in (0, 1):
        (a, la), (b, lb) = (run(0, w, 1), run(0, w2, 2)) if it == 0 else \
            (run(1, None, 1), run(1, None, 2))
        torch.cuda.synchronize()
        if la is not None:
            assert all(torch.equal(x, y[:1]) for x, y in zip(la, lb))
        for f in ("s_lx", "s_ux", "s_lu", "s_uu", "lam_lx", "lam_ux",
                  "lam_lu", "lam_uu", "dx", "du", "kkt_eq", "mu"):
            assert torch.equal(getattr(a, f), getattr(b, f)[:1]), (it, f)
    after = wrapper.by_layout
    for kind in ("single", "batch"):
        key = ("resident", kind)
        assert after.get(key, 0) == before.get(key, 0) + 2


@pytest.mark.cuda
def test_prologue_alone_matches_fast_linearize_on_gpu(cuda_device):
    """The single plan's prologue grid launched alone
    (`fused_lin_prologue`, B=1) against its plain version on the CPU (rtol
    and atol 2e-4) and against the record the full B=1 launch's prologue
    writes (the same kernel: the same bits); each prologue grid counted
    once in `fused_lin_prologue.launches`, the solve only by
    `fused_rti_solve`; a batch refused."""
    dev = cuda_device
    ocp, spec, xbar, ubar, x0, args = _fused_inputs(dev, B=1, N=20)
    model, dt, nsteps = fused_dyn_statics(ocp)
    sp = spec.stage_params[None]
    n0, s0 = K.fused_lin_prologue.launches, K.fused_rti_solve.launches
    got = K.fused_lin_prologue(xbar, ubar, sp, model, dt, nsteps)
    _, lin = K.fused_rti_solve(xbar, ubar, sp, x0, *args, model=model, dt=dt,
                               num_steps=nsteps, iters=1, return_lin=True)
    torch.cuda.synchronize()
    assert K.fused_lin_prologue.launches == n0 + 2
    assert K.fused_rti_solve.launches == s0 + 1
    assert all(torch.equal(a, b) for a, b in zip(got, lin))
    ref = K.fused_lin_prologue(xbar.cpu(), ubar.cpu(), sp.cpu(), model, dt,
                               nsteps)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g.cpu(), r, rtol=2e-4, atol=2e-4)
    with pytest.raises(ValueError):
        K.fused_lin_prologue(torch.cat([xbar, xbar]), torch.cat([ubar, ubar]),
                             torch.cat([sp, sp]), model, dt, nsteps)
