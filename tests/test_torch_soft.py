"""Port parity of the soft-bounded slice: `qp/soft.py` (the eager Riccati
soft IPM), the soft plain twins of the box-QP IPM kernel (K4,
`ops/box_qp_ipm.py::box_qp_solve_plain(soft=)` and
`fused_rti_solve_plain(soft=)`), `sqp/rti.py::rti_step_soft` on its three
backends, the batched `"xla"` tick (`parallel/mesh.py`), and the numpy
round trip of `SoftBounds` (`convert.py`), each against the JAX package on
the CPU.

Tolerances and why:
  - `soft_box_qp_solve` in float64 follows the JAX function operation for
    operation: iterates within 1e-8 (rounding of two float64 runs);
  - the soft twins follow the Pallas kernel, not `qp/soft.py` (the kernel
    caps sig_s before the elimination and the pair sum after, clips T/s;
    `qp/soft.py` caps sig_eff). After ONE iteration both agree with the
    Pallas kernel (interpret mode) and with `qp/soft.py` in float32 to the
    cold tolerances of tests/test_torch_ipm.py (u0 atol 2e-3, dx/du atol
    5e-3; measured against Pallas: du 1.4e-5, dx 5.8e-7). Past a few
    iterations the out-of-box QPs are chaotic in float32 (the twin moves du
    by 2.3 when x0 moves by 1e-6, 6 iterations, N=8, on the CPU), so the
    full budget is held on the penalized objective within 2e-3 relative +
    1e-3 and on the peak upper-x violation within rtol 0.2
    (tests/test_pallas_ipm.py's soft checks);
  - the all-hard `SoftBounds` through the soft twin equals the hard twin
    bit for bit: hard rows take sig_s itself (the kernel's sentinel Z=1e18
    collapses the eliminated formula to sig_s only within one ulp in
    float32, test_sentinel_collapse_is_not_exact_in_f32);
  - the out-of-box `"riccati"` tick in float64 at the preset's N=60, 6
    ticks (tests/test_qp_soft.py): controls within 1e-6 (measured 1.5e-8);
  - the kernel backends in float32 at N=8, against `"riccati"` and each
    other with the JAX package's own cross-backend tolerances
    (tests/test_qp_soft.py, tests/test_fused_tick.py).
"""
import dataclasses
import sys
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mpc_blaster_tpu import config as jcfg
from mpc_blaster_tpu.ops.pallas_ipm import pallas_box_qp_solve
from mpc_blaster_tpu.qp import soft as jsoft
from mpc_blaster_tpu_torch import convert
from mpc_blaster_tpu_torch.ops import box_qp_ipm as K
from mpc_blaster_tpu_torch.qp import soft as tsoft

from test_qp import random_qp
from test_qp_soft import all_hard, bind_controls
from test_torch_ipm import _blaster_qps, _to_torch
from torch_threads import one_intraop_thread  # noqa: F401

# The port runs on the CUDA card unless asked for the CPU; these tests
# ask for it.
DEV = torch.device("cpu")

REPO = Path(__file__).resolve().parents[1]
NX, NU = 17, 6


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _soft_t(js, dtype=torch.float32):
    """The port's SoftBounds with the JAX one's numbers."""
    return convert.soft_from_numpy(
        {g: p._asdict() for g, p in _np(js)._asdict().items()}, dtype=dtype,
        device=DEV)


def _qp_t(jd, dtype=torch.float64):
    return convert.qp_from_numpy(_np(jd)._asdict(), dtype=dtype, device=DEV)


# ------------------------------ qp/soft.py ---------------------------------

def _case(name):
    """(JAX QPData, JAX SoftBounds, iters) of tests/test_qp_soft.py's
    cases, float64."""
    if name == "all_hard":
        d = bind_controls(random_qp(seed=3))
        return d, all_hard(d.horizon, d.nx, d.nu), 30
    if name == "stiff":
        d = bind_controls(random_qp(seed=4))
        return d, jsoft.SoftBounds.state_bounds(
            d.horizon, d.nx, d.nu, Zl=1e6, zl=1e3, dtype=d.A.dtype), 30
    if name == "infeasible":
        d = random_qp(N=6, nx=4, nu=2, seed=7)
        d = d._replace(dx0=jnp.full((4,), 3.0, d.A.dtype),
                       lbx=jnp.full_like(d.lbx, -0.5),
                       ubx=jnp.full_like(d.ubx, 0.5),
                       lbu=jnp.full_like(d.lbu, -0.2),
                       ubu=jnp.full_like(d.ubu, 0.2))
        return d, jsoft.SoftBounds.state_bounds(6, 4, 2, Zl=10.0, zl=1.0,
                                                dtype=d.A.dtype), 40
    d = random_qp(N=4, nx=3, nu=2, seed=5)      # the SLSQP-expanded case
    from mpc_blaster_tpu.qp.riccati import lqr_solve
    lim = 0.5 * float(jnp.max(jnp.abs(lqr_solve(d).du)))
    d = d._replace(lbu=jnp.full_like(d.lbu, -lim),
                   ubu=jnp.full_like(d.ubu, lim),
                   lbx=jnp.full_like(d.lbx, -0.15),
                   ubx=jnp.full_like(d.ubx, 0.15))
    return d, jsoft.SoftBounds.state_bounds(4, 3, 2, Zl=5.0, zl=0.5,
                                            dtype=d.A.dtype), 40


@pytest.mark.parametrize("name", ["all_hard", "stiff", "infeasible",
                                  "expanded"])
def test_soft_box_qp_solve_matches_jax(name):
    jd, js, iters = _case(name)
    rj = jsoft.soft_box_qp_solve(jd, js, iters=iters)
    td, ts = _qp_t(jd), _soft_t(js, torch.float64)
    rt = tsoft.soft_box_qp_solve(td, ts, iters=iters)
    for f in ("dx", "du", "lam_lx", "lam_ux", "s_lu", "mu", "kkt_eq",
              "kkt_stat"):
        np.testing.assert_allclose(getattr(rt.sol, f).numpy(),
                                   np.asarray(getattr(rj.sol, f)),
                                   rtol=1e-8, atol=1e-8, err_msg=f)
    for f in ("t_lx", "t_ux", "t_lu", "t_uu"):
        np.testing.assert_allclose(getattr(rt, f).numpy(),
                                   np.asarray(getattr(rj, f)), rtol=1e-8,
                                   atol=1e-8, err_msg=f)
    oj = float(jsoft.soft_qp_objective(jd, js, rj.sol.dx, rj.sol.du))
    ot = float(tsoft.soft_qp_objective(td, ts, rt.sol.dx, rt.sol.du))
    assert ot == pytest.approx(oj, rel=1e-10, abs=1e-10)
    if name == "infeasible":     # a real violation is reported
        assert float(rt.t_ux.max()) > 0.5


def test_soft_box_qp_solve_batched_matches_jax():
    """Leading batch axes (the JAX function is vmapped): three problems,
    one solve, each against its own JAX solve."""
    datas = [bind_controls(random_qp(N=5, nx=4, nu=2, seed=s), frac=0.3)
             for s in range(3)]
    js = jsoft.SoftBounds.state_bounds(5, 4, 2, Zl=100.0, zl=1.0,
                                       dtype=datas[0].A.dtype)
    stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *datas)
    rt = tsoft.soft_box_qp_solve(_qp_t(stacked), _soft_t(js, torch.float64),
                                 iters=20)
    for i, d in enumerate(datas):
        rj = jsoft.soft_box_qp_solve(d, js, iters=20)
        np.testing.assert_allclose(rt.sol.du[i].numpy(), np.asarray(rj.sol.du),
                                   rtol=0, atol=1e-8)
        np.testing.assert_allclose(rt.t_ux[i].numpy(), np.asarray(rj.t_ux),
                                   rtol=0, atol=1e-8)


def test_soft_objective_and_violations_match_jax():
    """`soft_qp_objective` and `violations_from_primal` on a primal point
    that violates the soft box, with one infinite and one hard bound."""
    jd, js, _ = _case("infeasible")
    rng = np.random.default_rng(1)
    jd = jd._replace(ubx=jd.ubx.at[2, 1].set(jnp.inf))
    js = js._replace(ux=js.ux._replace(soft=js.ux.soft.at[3, 0].set(False)))
    dx = rng.normal(0.0, 1.0, jd.lbx.shape)
    du = rng.normal(0.0, 0.3, jd.lbu.shape)
    td, ts = _qp_t(jd), _soft_t(js, torch.float64)
    oj = float(jsoft.soft_qp_objective(jd, js, jnp.asarray(dx),
                                       jnp.asarray(du)))
    ot = tsoft.soft_qp_objective(td, ts, torch.as_tensor(dx),
                                 torch.as_tensor(du))
    assert float(ot) == pytest.approx(oj, rel=1e-12)
    vj = jsoft.violations_from_primal(jd, js, jnp.asarray(dx),
                                      jnp.asarray(du))
    vt = tsoft.violations_from_primal(td, ts, torch.as_tensor(dx),
                                      torch.as_tensor(du))
    for a, b in zip(vt, vj):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert float(vt[1].max()) > 0.5 and float(vt[1][1, 1]) == 0.0


# --------------------------- the soft twins (K4) ----------------------------

@pytest.fixture(scope="module")
def out_of_box():
    """Linearized BLASTER QPs, N=8 B=2, with dx0 pushed 2.2 past the x
    box, and soft position bounds idx=(0,1,2), Zl=1e3, zl=1e2
    (tests/test_pallas_ipm.py:303-329)."""
    jd = _blaster_qps(B=2, N=8)
    jd = jd._replace(dx0=jd.dx0.at[:, 0].add(2.2))
    js = jsoft.SoftBounds.state_bounds(8, NX, NU, Zl=1e3, zl=1e2,
                                       idx=np.asarray((0, 1, 2)),
                                       dtype=jnp.float32)
    return jd, js, _to_torch(jd), _soft_t(js)


def _jax_soft(jd, js, iters):
    """qp/soft.py on each problem of the batch (float32)."""
    return [jsoft.soft_box_qp_solve(jax.tree.map(lambda a, i=i: a[i], jd), js,
                                    iters=iters, reg=1e-6)
            for i in range(jd.A.shape[0])]


def _peak_upper_x(dx, ubx):
    return np.maximum(np.asarray(dx)[:, 1:, 0] - np.asarray(ubx)[:, 1:, 0],
                      0.0).max(1)


def test_soft_twin_one_iteration_matches_pallas(out_of_box):
    """After one iteration the soft twin equals the Pallas kernel's soft
    mode (interpret mode) to rounding: pointwise, slacks and duals too."""
    jd, js, td, ts = out_of_box
    sj = pallas_box_qp_solve(jd, iters=1, interpret=True, soft=js)
    st = K.box_qp_solve_plain(td, iters=1, soft=ts)
    np.testing.assert_allclose(st.du[:, 0].numpy(), np.asarray(sj.du)[:, 0],
                               rtol=0, atol=2e-3)
    np.testing.assert_allclose(st.du.numpy(), np.asarray(sj.du), rtol=0,
                               atol=5e-3)
    np.testing.assert_allclose(st.dx.numpy(), np.asarray(sj.dx), rtol=0,
                               atol=5e-3)
    for f in ("s_lx", "s_ux", "lam_lx", "lam_ux", "lam_lu", "lam_uu"):
        np.testing.assert_allclose(getattr(st, f).numpy(),
                                   np.asarray(getattr(sj, f)), rtol=1e-3,
                                   atol=1e-3, err_msg=f)
    np.testing.assert_allclose(st.mu.numpy(), np.asarray(sj.mu), rtol=1e-3)


@pytest.mark.slow
def test_soft_twin_full_solve_matches_pallas(out_of_box):
    """The full budget against the Pallas kernel (interpret mode), on the
    penalized objective and the peak upper-x violation. Fast sibling:
    test_soft_twin_matches_qp_soft."""
    jd, js, td, ts = out_of_box
    sj = pallas_box_qp_solve(jd, iters=10, interpret=True, soft=js)
    st = K.box_qp_solve_plain(td, iters=10, soft=ts)
    for i in range(2):
        d1 = jax.tree.map(lambda a, i=i: a[i], jd)
        oj = float(jsoft.soft_qp_objective(d1, js, sj.dx[i], sj.du[i]))
        ot = float(jsoft.soft_qp_objective(d1, js, jnp.asarray(st.dx[i]),
                                           jnp.asarray(st.du[i])))
        assert abs(ot - oj) <= 2e-3 * abs(oj) + 1e-3, (i, ot, oj)
    np.testing.assert_allclose(_peak_upper_x(st.dx, jd.ubx),
                               _peak_upper_x(sj.dx, jd.ubx), rtol=0.2)


@pytest.mark.parametrize("iters", [1, 10])
def test_soft_twin_matches_qp_soft(out_of_box, iters):
    """The soft twin against `qp/soft.py` on the JAX side (float32): one
    iteration pointwise, the full budget on the penalized objective and
    the peak upper-x violation (the hard problem is infeasible: both find
    a real violation)."""
    jd, js, td, ts = out_of_box
    refs = _jax_soft(jd, js, iters)
    st = K.box_qp_solve_plain(td, iters=iters, soft=ts)
    assert torch.isfinite(st.dx).all() and torch.isfinite(st.du).all()
    if iters == 1:
        for i, r in enumerate(refs):
            np.testing.assert_allclose(st.du[i, 0].numpy(),
                                       np.asarray(r.sol.du)[0], rtol=0,
                                       atol=2e-3)
            np.testing.assert_allclose(st.du[i].numpy(), np.asarray(r.sol.du),
                                       rtol=0, atol=5e-3)
            np.testing.assert_allclose(st.dx[i].numpy(), np.asarray(r.sol.dx),
                                       rtol=0, atol=5e-3)
        return
    for i, r in enumerate(refs):
        d1 = jax.tree.map(lambda a, i=i: a[i], jd)
        ox = float(jsoft.soft_qp_objective(d1, js, r.sol.dx, r.sol.du))
        ot = float(jsoft.soft_qp_objective(d1, js, jnp.asarray(st.dx[i]),
                                           jnp.asarray(st.du[i])))
        assert abs(ot - ox) <= 2e-3 * abs(ox) + 1e-3, (i, ot, ox)
        vx = float(np.asarray(r.t_ux)[:, 0].max())
        assert vx > 1e-2        # the hard problem IS infeasible
        np.testing.assert_allclose(_peak_upper_x(st.dx[i:i + 1],
                                                 jd.ubx[i:i + 1]),
                                   [vx], rtol=0.2)


def test_all_hard_soft_twin_is_the_hard_twin(out_of_box):
    """An all-hard SoftBounds through the soft twins equals the hard twins
    bit for bit after one iteration: plain mode and the fuse_lin twin."""
    jd, js, td, ts = out_of_box
    hard = tsoft.SoftBounds(*(tsoft.SoftPenalty.hard((8, w), device=DEV)
                              for w in (NX, NX, NU, NU)))
    a = K.box_qp_solve_plain(td, iters=1)
    b = K.box_qp_solve_plain(td, iters=1, soft=hard)
    for f in a._fields:
        if getattr(a, f) is not None:
            assert torch.equal(getattr(a, f), getattr(b, f)), f
    args, kw = _fused_args(N=8)
    a = K.fused_rti_solve_plain(*args, iters=1, **kw)
    b = K.fused_rti_solve_plain(*args, iters=1, soft=hard, **kw)
    assert torch.equal(a.du, b.du) and torch.equal(a.dx, b.dx)
    assert torch.equal(a.lam_ux, b.lam_ux) and torch.equal(a.mu, b.mu)


def _fused_args(N=8):
    """fused_rti_solve arguments of the out-of-box tick (x0[0]=2.4, z=2,
    yref z=2) from the hover iterate, B=1, and its keyword constants."""
    from mpc_blaster_tpu_torch import config as cfg
    from mpc_blaster_tpu_torch.ocp.spec import build_spec
    from mpc_blaster_tpu_torch.sqp.rti import (fused_dyn_statics,
                                               init_rti_state)
    pre = cfg.simulation_preset()
    ocp = dataclasses.replace(pre.ocp, N=N, Tf=N / 30.0)
    yref = np.zeros(NX + NU)
    yref[2] = 2.0
    spec = build_spec(ocp, yref=yref, device=DEV)
    x0 = torch.zeros(1, NX)
    x0[0, 0], x0[0, 2] = 2.4, 2.0
    st = init_rti_state(ocp, x0, device=DEV)

    def bc(a):
        return a.expand(1, *a.shape)
    model, dt, ns = fused_dyn_statics(ocp)
    args = (st.xbar, st.ubar, bc(spec.stage_params), x0, bc(spec.dt * spec.Q),
            bc(spec.Q_t), bc(spec.dt * spec.R), bc(spec.yref_x),
            bc(spec.yref_u), bc(spec.yref_e), bc(spec.lbx), bc(spec.ubx),
            bc(spec.lbu), bc(spec.ubu))
    return args, dict(model=model, dt=dt, num_steps=ns)


def test_sentinel_collapse_is_not_exact_in_f32():
    """Why the kernel and its twin select sig_s on hard rows instead of
    trusting the Pallas kernel's sentinel: with Z = 1e18 the eliminated
    weight sig_s (Z + 0) / (Z + sig_s + 0) equals sig_s in float32 only
    within one ulp. Over 2**20 values of sig_s in [1e-20, 1e7) about a
    tenth round to a neighbour (the measured share is printed)."""
    rng = np.random.default_rng(0)
    x = (10.0 ** rng.uniform(-20, 7, 1 << 20)).astype(np.float32)
    Z = np.float32(1e18)
    y = (x * (Z + np.float32(0))) / ((Z + x) + np.float32(0))
    off = y != x
    share = float(off.mean())
    print(f"sentinel collapse inexact for {share:.4f} of sig_s")
    assert 0.05 < share < 0.2
    ulp = np.abs(y[off].view(np.int32) - x[off].view(np.int32))
    assert ulp.max() == 1


def test_soft_rejects_warm(out_of_box):
    """Soft and warm starts do not combine, in every wrapper and twin (the
    JAX package raises the same)."""
    from mpc_blaster_tpu_torch.qp.ipm import IpmWarmStart
    jd, js, td, ts = out_of_box
    w2 = IpmWarmStart(*(a.expand(2, *a.shape)
                        for a in IpmWarmStart.zeros(8, NX, NU, device=DEV)))
    for fn in (K.box_qp_solve, K.box_qp_solve_plain):
        with pytest.raises(ValueError, match="soft bounds do not support"
                                             ".*warm"):
            fn(td, iters=1, soft=ts, warm=w2)
    args, kw = _fused_args(N=8)
    w1 = IpmWarmStart(*(a[:1] for a in w2))
    for fn in (K.fused_rti_solve, K.fused_rti_solve_plain):
        with pytest.raises(ValueError, match="soft bounds do not support"
                                             ".*warm"):
            fn(*args, iters=1, soft=ts, warm=w1, **kw)
    # the JAX package refuses the same combination
    from mpc_blaster_tpu.qp.ipm import IpmWarmStart as JW
    jw = jax.tree.map(lambda a: jnp.broadcast_to(a, (2,) + a.shape),
                      JW.zeros(8, NX, NU, jnp.float32))
    with pytest.raises(ValueError, match="soft bounds do not support"):
        pallas_box_qp_solve(jd, iters=1, interpret=True, soft=js, warm=jw)


def test_soft_convert_round_trip():
    js = jsoft.SoftBounds.state_bounds(8, NX, NU, Zl=np.arange(NX) + 1.0,
                                       zl=2.0, Zu=3.0, idx=np.asarray((0, 4)),
                                       dtype=jnp.float32)
    ts = _soft_t(js)
    assert ts.lx.soft.dtype == torch.bool and ts.ux.Z.dtype == torch.float32
    out = convert.soft_to_numpy(ts)
    for g, pen in _np(js)._asdict().items():
        for f, v in pen._asdict().items():
            np.testing.assert_array_equal(out[g][f], v, err_msg=f"{g}.{f}")
    # the port's own constructor gives the same numbers
    tb = tsoft.SoftBounds.state_bounds(8, NX, NU, Zl=np.arange(NX) + 1.0,
                                       zl=2.0, Zu=3.0, idx=(0, 4), device=DEV)
    for g, pen in convert.soft_to_numpy(tb).items():
        for f, v in pen.items():
            np.testing.assert_array_equal(v, out[g][f], err_msg=f"{g}.{f}")


# ----------------------------- rti_step_soft --------------------------------

def _soft_tick_setup(N, dtype_j, dtype_t):
    """The out-of-box start of tests/test_qp_soft.py (x0[0]=2.4, z=2,
    yref z=2), the simulation preset at horizon N: JAX and port sides."""
    from mpc_blaster_tpu.dynamics.blaster import BlasterParams as JP
    from mpc_blaster_tpu.dynamics.blaster import blaster_ode as jode
    from mpc_blaster_tpu.dynamics.integrators import discrete_dynamics as jdd
    from mpc_blaster_tpu.ocp.spec import build_spec as jbuild
    from mpc_blaster_tpu_torch.dynamics.blaster import (BlasterParams,
                                                        blaster_ode)
    from mpc_blaster_tpu_torch.dynamics.integrators import discrete_dynamics
    from mpc_blaster_tpu_torch.ocp.spec import build_spec
    pre = jcfg.simulation_preset()
    ocp = dataclasses.replace(pre.ocp, N=N, Tf=pre.ocp.Tf * N / pre.ocp.N)
    x0 = np.zeros(NX)
    x0[0], x0[2] = 2.4, 2.0
    yref = np.zeros(NX + NU)
    yref[2] = 2.0
    js = jsoft.SoftBounds.state_bounds(N, NX, NU, Zl=1e3, zl=1e2,
                                       dtype=dtype_j)
    jside = (jbuild(ocp, yref=yref, dtype=dtype_j), jnp.asarray(x0, dtype_j),
             JP.from_config(ocp.model, dtype_j), jdd(jode, ocp.dt), js)
    tside = (build_spec(ocp, yref=yref, dtype=dtype_t, device=DEV),
             torch.as_tensor(x0, dtype=dtype_t),
             BlasterParams.from_config(ocp.model, dtype_t, device=DEV),
             discrete_dynamics(blaster_ode, ocp.dt), _soft_t(js, dtype_t))
    return ocp, jside, tside


def test_rti_step_soft_riccati_matches_jax():
    """Six out-of-box ticks of the preset at its N=60 on `"riccati"`
    (`qp/soft.py`) in float64 against the JAX package's, as
    tests/test_qp_soft.py runs them: controls within 1e-6 (measured
    1.5e-8), the stage-1 upper-x violation reported, the plan back inside
    the box late in the horizon."""
    from mpc_blaster_tpu.sqp.rti import init_rti_state as jinit
    from mpc_blaster_tpu.sqp.rti import rti_step_soft as jstep
    from mpc_blaster_tpu_torch.sqp.rti import init_rti_state, rti_step_soft
    ocp, (jspec, jx0, jp, jF, js), (spec, x0, P, F, ts) = _soft_tick_setup(
        60, jnp.float64, torch.float64)
    assert ocp.solver.qp_backend == "riccati"
    step = jax.jit(lambda sp, st, x, so: jstep(sp, st, x, jp, jF, ocp.solver,
                                                so))
    jst, st = jinit(ocp, jx0, jnp.float64), init_rti_state(ocp, x0,
                                                            torch.float64,
                                                            device=DEV)
    for _ in range(6):
        ju, jst, jdg, jres = step(jspec, jst, jx0, js)
        u, st, dg, res = rti_step_soft(spec, st, x0, P, F, ocp.solver, ts)
    np.testing.assert_allclose(u.numpy(), np.asarray(ju), rtol=0, atol=1e-6)
    np.testing.assert_allclose(st.xbar.numpy(), np.asarray(jst.xbar),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(res.t_ux.numpy(), np.asarray(jres.t_ux),
                               rtol=0, atol=1e-6)
    assert float(dg.qp_kkt_eq) < 1e-5
    assert float(res.t_ux[0, 0]) > 0.5
    assert float(res.t_ux[-10:, 0].max()) < 0.2


@pytest.fixture(scope="module")
def soft_ticks_f32():
    """One out-of-box tick at N=8 in float32 on each port backend (the
    kernel backends' plain twins here) and on the JAX package's
    `"riccati"`: {backend: (u0, new state, diag, SoftQPSolution)}."""
    from mpc_blaster_tpu.sqp.rti import init_rti_state as jinit
    from mpc_blaster_tpu.sqp.rti import rti_step_soft as jstep
    from mpc_blaster_tpu_torch.sqp.rti import (fused_dyn_statics,
                                               init_rti_state,
                                               make_linearizer,
                                               rti_step_soft)
    ocp, (jspec, jx0, jp, jF, js), (spec, x0, P, F, ts) = _soft_tick_setup(
        8, jnp.float32, torch.float32)
    out = {}
    sv = dataclasses.replace(ocp.solver, qp_backend="riccati", ipm_iters=6)
    out["jax_riccati"] = jax.jit(lambda sp, st, x, so: jstep(
        sp, st, x, jp, jF, sv, so))(jspec, jinit(ocp, jx0, jnp.float32),
                                    jx0, js)
    def counted():
        return (K.box_qp_solve.launches, dict(K.box_qp_solve.by_instance),
                K.fused_rti_solve.launches,
                dict(K.fused_rti_solve.by_instance))
    n0 = counted()
    for backend, lb in (("riccati", "jacfwd"), ("pallas", "fused"),
                        ("pallas_fused", "fused")):
        sv = dataclasses.replace(ocp.solver, qp_backend=backend,
                                 ipm_iters=6, lin_backend=lb)
        o = dataclasses.replace(ocp, solver=sv)
        out[backend] = rti_step_soft(
            spec, init_rti_state(o, x0, device=DEV), x0, P, F, sv, ts,
            linearizer=make_linearizer(o, P),
            dyn_statics=fused_dyn_statics(o))
    # on the CPU the wrappers ran the plain twins: no kernel launch counted
    assert counted() == n0
    return out


@pytest.mark.parametrize("backend", ["riccati", "pallas", "pallas_fused"])
def test_rti_step_soft_f32_matches_jax_riccati(soft_ticks_f32, backend):
    """Each port backend against the JAX package's `"riccati"` soft tick
    (float32, N=8, 6 iterations): the stage-1 upper-x violation within
    0.05 and the thrusts within rtol 0.05 (tests/test_qp_soft.py's
    pallas-vs-riccati bounds)."""
    ju, _, _, jres = soft_ticks_f32["jax_riccati"]
    u, st, dg, res = soft_ticks_f32[backend]
    assert torch.isfinite(u).all() and torch.isfinite(st.xbar).all()
    assert abs(float(res.t_ux[0, 0]) - float(jres.t_ux[0, 0])) < 0.05
    assert float(res.t_ux[0, 0]) > 0.5
    np.testing.assert_allclose(u[:4].numpy(), np.asarray(ju)[:4], rtol=0.05)


def test_rti_step_soft_fused_matches_pallas(soft_ticks_f32):
    """`"pallas_fused"` (one launch: linearize + soft IPM) against
    `"pallas"` with the fused linearizer (tests/test_fused_tick.py): u0
    within 2e-3, violations within 2e-3, mu within 2e-2."""
    u_f, st_f, dg_f, res_f = soft_ticks_f32["pallas_fused"]
    u_p, _, dg_p, res_p = soft_ticks_f32["pallas"]
    np.testing.assert_allclose(u_f.numpy(), u_p.numpy(), rtol=0, atol=2e-3)
    for f in ("t_lx", "t_ux"):
        np.testing.assert_allclose(getattr(res_f, f).numpy(),
                                   getattr(res_p, f).numpy(), rtol=0,
                                   atol=2e-3, err_msg=f)
    assert float(dg_f.qp_kkt_eq) < 1e-2
    assert abs(float(dg_f.qp_mu) - float(dg_p.qp_mu)) < 2e-2


# --------------------------- batched "xla" tick -----------------------------

def test_batched_xla_matches_jax():
    """`batched_rti_step(ocp)` (the default "xla" backend: the Riccati IPM
    on the batch) against the JAX package's vmapped tick, N=8, B=4,
    float64, two chained ticks from x0 around z=2, where the thrusts
    saturate at 65 N. The first tick's controls within 1e-5 N (measured
    7.1e-7), the second's within 1e-3 N and the states within 1e-5: the
    12-iteration solves at saturated bounds amplify rounding into the
    weakly determined rotor split (measured 2.7e-4 N on a 61 N thrust;
    tests/test_torch_closedloop.py sees the same)."""
    from mpc_blaster_tpu.ocp.spec import build_spec as jbuild
    from mpc_blaster_tpu.parallel.mesh import batched_rti_step as jbatched
    from mpc_blaster_tpu.sqp.rti import init_rti_state as jinit
    from mpc_blaster_tpu_torch.ocp.spec import build_spec
    from mpc_blaster_tpu_torch.parallel.mesh import batched_rti_step
    from mpc_blaster_tpu_torch.sqp.rti import init_rti_state
    pre = jcfg.simulation_preset()
    ocp = dataclasses.replace(pre.ocp, N=8, Tf=8 / 30.0)
    x0s = np.zeros((4, NX))
    rng = np.random.default_rng(3)
    x0s[:, 0:3] = rng.uniform(-0.4, 0.4, (4, 3))
    x0s[:, 2] += 2.0
    jspec = jbuild(ocp, yref=pre.loop.yref, dtype=jnp.float64)
    jx = jnp.asarray(x0s)
    jst = jax.vmap(lambda x: jinit(ocp, x, jnp.float64))(jx)
    jstep = jbatched(ocp, dtype=jnp.float64)
    spec = build_spec(ocp, yref=pre.loop.yref, dtype=torch.float64, device=DEV)
    tx = torch.as_tensor(x0s)
    st = init_rti_state(ocp, tx, torch.float64, device=DEV)
    step = batched_rti_step(ocp, dtype=torch.float64, device=DEV)
    for tick in range(2):
        ju, jst, jdg = jstep(jspec, jst, jx)
        u, st, dg = step(spec, st, tx)
        np.testing.assert_allclose(u.numpy(), np.asarray(ju), rtol=0,
                                   atol=1e-5 if tick == 0 else 1e-3)
    assert u.shape == (4, NU) and st.xbar.shape == (4, 9, NX)
    np.testing.assert_allclose(st.xbar.numpy(), np.asarray(jst.xbar),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(dg.qp_kkt_eq.numpy(), np.asarray(jdg.qp_kkt_eq),
                               rtol=1e-3, atol=1e-9)
    np.testing.assert_allclose(dg.bound_viol.numpy(),
                               np.asarray(jdg.bound_viol), rtol=0, atol=1e-8)


def test_batched_xla_kernel_solvers():
    """The "xla" tick with a kernel backend in the solver: "pallas" is the
    batched `pallas` tick (plain twin on the CPU; N=8, B=2), bit for bit;
    "pallas_fused" runs the one-launch tick over the batch, each problem
    as its own B=1 tick (the fuse_lin twin; within 1e-5: the batched and
    the single twin round alike but for the batched products' order)."""
    from mpc_blaster_tpu_torch.ocp.spec import build_spec
    from mpc_blaster_tpu_torch.parallel.mesh import batched_rti_step
    from mpc_blaster_tpu_torch.sqp.rti import init_rti_state
    pre = jcfg.simulation_preset()
    x0s = torch.zeros(2, NX)
    x0s[:, 2] = torch.tensor([1.5, 2.5])

    def ocp_with(backend):
        return dataclasses.replace(
            pre.ocp, N=8, Tf=8 / 30.0, solver=dataclasses.replace(
                pre.ocp.solver, qp_backend=backend, ipm_iters=4))
    ocp = ocp_with("pallas")
    spec = build_spec(ocp, yref=pre.loop.yref, device=DEV)
    st = init_rti_state(ocp, x0s, device=DEV)
    u, new, dg = batched_rti_step(ocp, device=DEV)(spec, st, x0s)
    u2, new2, _ = batched_rti_step(ocp, backend="pallas", device=DEV)(
        spec, st, x0s)
    assert torch.equal(u, u2) and torch.equal(new.xbar, new2.xbar)
    assert dg.qp_kkt_eq.shape == (2,) and torch.isfinite(u).all()
    from mpc_blaster_tpu_torch.sqp.rti import make_rti_step
    fused = ocp_with("pallas_fused")
    u, new, dg = batched_rti_step(fused, device=DEV)(spec, st, x0s)
    one = make_rti_step(fused, device=DEV)
    for i in range(2):
        ui, sti, dgi = one(spec, type(st)(st.xbar[i], st.ubar[i]), x0s[i])
        torch.testing.assert_close(u[i], ui, rtol=0, atol=1e-5)
        torch.testing.assert_close(new.xbar[i], sti.xbar, rtol=0, atol=1e-5)
        torch.testing.assert_close(dg.qp_kkt_eq[i], dgi.qp_kkt_eq, rtol=1e-4,
                                   atol=1e-7)


# ------------------------ chip_smoke's soft-loop bounds ---------------------

def test_chip_smoke_soft_loop_bounds_are_jax_run():
    """chip_smoke.py's phase 10 holds the port's soft closed loop to the
    JAX package's own float32 run of the same chain on the CPU
    (`qp_backend="riccati"`, `qp/soft.py` under `jit` and `lax.scan`: the
    preset at N=60, 100 ticks of `rti_step_soft` with the fused
    linearizer, 6 IPM iterations, plus the plant's RK4, from x0[0]=2.4,
    z=2, yref z=2, soft state bounds Zl=1e3, zl=1e2). This test is that
    run: the constants in chip_smoke.py are its numbers."""
    from mpc_blaster_tpu.sqp.rti import init_rti_state as jinit
    from mpc_blaster_tpu.sqp.rti import make_linearizer
    from mpc_blaster_tpu.sqp.rti import rti_step_soft as jstep
    sys.path.insert(0, str(REPO))
    import chip_smoke
    ocp, (spec, x0, P, F, js), _ = _soft_tick_setup(60, jnp.float32,
                                                    torch.float32)
    sv = dataclasses.replace(ocp.solver, qp_backend="riccati", ipm_iters=6,
                             lin_backend="fused")
    ocp = dataclasses.replace(ocp, solver=sv)
    lin = make_linearizer(ocp, P)

    @jax.jit
    def chain(st0, xa):
        def body(carry, _):
            st, x = carry
            u0, st, _, res = jstep(spec, st, x, P, F, sv, js, linearizer=lin)
            x = F(x, u0, spec.stage_params[0], P)
            return (st, x), (x, jnp.maximum(res.t_ux[0].max(),
                                            res.t_lx[0].max()))
        return jax.lax.scan(body, (st0, xa), None,
                            length=chip_smoke.LOOP_TICKS)[1]

    xs, v1 = chain(jinit(ocp, x0, jnp.float32), x0)
    xs = np.asarray(xs)
    ref = chip_smoke.SOFT_JAX
    dist = float(np.linalg.norm(xs[-1, :3] - np.asarray(spec.yref_e)[:3]))
    assert dist == pytest.approx(ref["final_dist_m"], abs=1e-3)
    assert bool(np.all(np.abs(xs[-1, :2]) <= 1.5)) == ref["inside_box"]
    assert float(np.max(v1)) == pytest.approx(ref["peak_stage1_viol_m"],
                                              abs=1e-3)
