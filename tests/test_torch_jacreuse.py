"""Port parity of the Jacobian-reuse ticks and the multi-iteration SQP
(`sqp/rti.py`) against the JAX package, in float64 on the "riccati"
backend: `build_qp_jacreuse`, `rti_step_jacreuse`,
`rti_step_warm_jacreuse` (with the cache shifted under `warm_shift`),
`closed_loop(jac_refresh=4)` cold and warm, `RTIController`, and the
`JacCache` round trip of `convert.py` (`sqp_solve`:
tests/test_torch_sqp.py).

Tolerances and why:
  - a refresh tick's QP is `build_qp`'s bit for bit (the same function
    assembles both); on a reuse tick A and B are the cache's tensors and
    the defects c are the forward map's bit for bit (within 1e-12 of
    `build_qp`'s, whose forward map rides the jacfwd pass);
  - 8 ticks of the reuse chains at N=8 from a hover 0.5 m below the
    reference, each tick from the port's inputs of that tick: the step's
    QP objective, u0's total thrust and swivel rates, u0, the iterate but
    its last two nodes, the cache and the warm start, each within a bound
    set from the measured gap and the IPM's stopping point (the QP's rotor
    split is weakly determined; see the asserts' comments);
  - 10 ticks of the loops: positions within 1e-4 m, the bound
    tests/test_torch_golden.py uses for f64 closed loops across the two
    implementations (see the test);
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mpc_blaster_tpu import config as jcfg
from mpc_blaster_tpu.dynamics.blaster import BlasterParams as JBP
from mpc_blaster_tpu.dynamics.blaster import blaster_ode as jode
from mpc_blaster_tpu.dynamics.integrators import discrete_dynamics as jdd
from mpc_blaster_tpu.ocp.spec import build_spec as jbuild_spec
from mpc_blaster_tpu.sim.closedloop import make_closed_loop as jmcl
from mpc_blaster_tpu.sqp import rti as jrti
from mpc_blaster_tpu_torch import config as cfg
from mpc_blaster_tpu_torch import convert
from mpc_blaster_tpu_torch.dynamics.blaster import BlasterParams, blaster_ode
from mpc_blaster_tpu_torch.dynamics.integrators import discrete_dynamics
from mpc_blaster_tpu_torch.qp.data import qp_objective
from mpc_blaster_tpu_torch.sim.closedloop import make_closed_loop
from mpc_blaster_tpu_torch.sqp import rti as trti
from torch_threads import one_intraop_thread  # noqa: F401

# The port runs on the CUDA card unless asked for the CPU; these tests
# ask for it.
DEV = torch.device("cpu")
F64 = torch.float64


def _np(x):
    return {k: np.asarray(v) for k, v in x._asdict().items()}


def _ocps(N=8, **solver):
    """The simulation preset at N of both packages, solver fields
    replaced."""
    out = []
    for c in (jcfg, cfg):
        pre = c.simulation_preset()
        out.append(dataclasses.replace(pre.ocp, N=N, Tf=N / 30.0,
                                       solver=dataclasses.replace(
                                           pre.ocp.solver, **solver)))
    return out


def _start(ocp):
    """The preset's spec (its yref and the POC Jacobians of the canonical
    pose), float64, for both packages, and a start at hover 0.5 m below
    the reference. From the preset's own start on the ground every tick
    is a take-off transient that no budget converges, and two float64
    implementations part there whatever the tick (the plain tick's loops:
    4e-2 N apart by the third tick, measured)."""
    from mpc_blaster_tpu.sim.closedloop import preset_stage_params
    pre = jcfg.simulation_preset()
    js = jbuild_spec(ocp, yref=np.asarray(pre.loop.yref),
                     stage_params=np.asarray(preset_stage_params(
                         pre, jnp.float64)), dtype=jnp.float64)
    ts = convert.spec_from_numpy(_np(js), dtype=F64, device=DEV)
    x0 = np.zeros(17)
    x0[2] = 3.0
    return js, ts, x0


def _perturbed(ocp, x0, seed=3):
    rng = np.random.default_rng(seed)
    st = trti.init_rti_state(ocp, torch.as_tensor(x0), F64, device=DEV)
    return trti.RTIState(
        xbar=st.xbar + torch.as_tensor(rng.normal(0, 0.05, st.xbar.shape)),
        ubar=st.ubar + torch.as_tensor(rng.normal(0, 0.5, st.ubar.shape)))


@pytest.mark.parametrize("lin_backend", ["jacfwd", "fused"])
def test_build_qp_jacreuse_refresh_and_reuse(lin_backend):
    _, ocp = _ocps(lin_backend=lin_backend)
    _, ts, x0 = _start(ocp)
    st = _perturbed(ocp, x0)
    x = torch.as_tensor(x0)
    F = discrete_dynamics(blaster_ode, ocp.dt)
    P = BlasterParams.from_config(ocp.model, F64, device=DEV)
    lin = trti.make_linearizer(ocp, P)
    full = trti.build_qp(ts, st, x, F, P, linearizer=lin, solver=ocp.solver)
    zero = trti.JacCache.zeros(ocp.N, cfg.NX, cfg.NU, F64, device=DEV)
    qp, cache = trti.build_qp_jacreuse(ts, st, x, F, P, zero, True,
                                       linearizer=lin, solver=ocp.solver)
    for f in qp._fields:
        assert torch.equal(getattr(qp, f), getattr(full, f)), f
    assert torch.equal(cache.A, full.A) and torch.equal(cache.B, full.B)
    # a reuse tick on a moved iterate: A and B are the cache's, c exact
    st2 = _perturbed(ocp, x0, seed=4)
    qp2, cache2 = trti.build_qp_jacreuse(ts, st2, x, F, P, cache, False,
                                         linearizer=lin, solver=ocp.solver)
    assert qp2.A is cache.A and qp2.B is cache.B
    assert cache2.A is cache.A and cache2.B is cache.B
    x_next = torch.stack([F(st2.xbar[k], st2.ubar[k], ts.stage_params[k], P)
                          for k in range(ocp.N)])
    np.testing.assert_allclose(qp2.c.numpy(), (x_next - st2.xbar[1:]).numpy(),
                               rtol=0, atol=1e-12)
    full2 = trti.build_qp(ts, st2, x, F, P, linearizer=lin,
                          solver=ocp.solver)
    np.testing.assert_allclose(qp2.c.numpy(), full2.c.numpy(), rtol=0,
                               atol=1e-12)
    for f in ("Q", "q", "R", "r", "lbx", "ubx", "lbu", "ubu", "dx0"):
        assert torch.equal(getattr(qp2, f), getattr(full2, f)), f
    assert not torch.equal(qp2.A, full2.A)
    # the tick counter decides on the host; a device flag is refused
    with pytest.raises(TypeError, match="Python bool"):
        trti.build_qp_jacreuse(ts, st, x, F, P, cache, torch.tensor(True))


def _port_ticks(ocp, spec, x0, warm, n):
    """n ticks of the port's reuse chain with the plant's RK4 (A and B
    refreshed on every 4th tick), driven by hand: per tick the inputs
    (iterate, cache, warm start, x) and the outputs."""
    F = discrete_dynamics(blaster_ode, ocp.dt)
    P = BlasterParams.from_config(ocp.model, F64, device=DEV)
    plant_p = spec.stage_params[0].clone()
    plant_p[-1] = 2.2 * 9.81
    st = trti.init_rti_state(ocp, torch.as_tensor(x0), F64)
    c = trti.JacCache.zeros(ocp.N, 17, 6, F64, DEV)
    w = trti.IpmWarmStart.zeros(ocp.N, 17, 6, F64, DEV) if warm else None
    x, ticks = torch.as_tensor(x0), []
    xs = [x]
    for k in range(n):
        rf = k % 4 == 0
        inp = (st, w, c, x)
        if warm:
            u, st, w, c, _ = trti.rti_step_warm_jacreuse(
                spec, st, w, c, rf, x, P, F, ocp.solver)
        else:
            u, st, c, _ = trti.rti_step_jacreuse(spec, st, c, rf, x, P, F,
                                                 ocp.solver)
        ticks.append((rf, inp, (u, st, w, c)))
        x = F(x, u, plant_p, P)
        xs.append(x)
    return ticks, torch.stack(xs)


@pytest.mark.parametrize("warm", [False, True])
def test_jacreuse_ticks_match_jax_f64(warm):
    """8 ticks of `rti_step_jacreuse` (cold) or `rti_step_warm_jacreuse`
    (4 iterations, "primal", shifted: the cache shifts with the iterate),
    A and B refreshed on ticks 0 and 4. Each tick of the JAX package
    starts from the port's inputs of that tick, so a tick is held alone
    (a closed loop amplifies the rotor split's rounding, below)."""
    kw = (dict(ipm_iters=4, warm_mode="primal", warm_shift=True)
          if warm else {})
    jocp, tocp = _ocps(**kw)
    js, ts, x0 = _start(jocp)
    jF, jP = jdd(jode, jocp.dt), JBP.from_config(jocp.model, jnp.float64)
    if warm:
        jstep = jax.jit(lambda st, w, c, rf, x: jrti.rti_step_warm_jacreuse(
            js, st, w, c, rf, x, jP, jF, jocp.solver))
    else:
        jstep = jax.jit(lambda st, w, c, rf, x: jrti.rti_step_jacreuse(
            js, st, c, rf, x, jP, jF, jocp.solver))
    ticks, _ = _port_ticks(tocp, ts, x0, warm, 8)
    tF = discrete_dynamics(blaster_ode, tocp.dt)
    tP = BlasterParams.from_config(tocp.model, F64, device=DEV)
    from mpc_blaster_tpu.qp.ipm import IpmWarmStart as JWarm
    from mpc_blaster_tpu.sqp.rti import RTIState as JState

    def to_j(cls, t):
        return None if t is None else cls(*(jnp.asarray(a.numpy())
                                            for a in t))
    for k, (rf, (st, w, c, x), (u, st_new, w_new, c_new)) in enumerate(
            ticks):
        out = jstep(to_j(JState, st), to_j(JWarm, w),
                    to_j(jrti.JacCache, c), jnp.asarray(rf),
                    jnp.asarray(x.numpy()))
        ju, jst, jc = out[0], out[1], out[-2]
        # Both sides solve one QP, whose rotor split is weakly determined
        # (measured: u0's split up to 2.2e-3 N apart, the last stage's
        # 2e-2 N, xbar[N] 3e-4; the shift copies that node): the step's
        # QP objective within 1e-6 relative (measured 5.3e-8: the IPM
        # stops at mu ~ 2e-8 over ~300 bound rows), u0's total
        # thrust and swivel rates within 1e-5 (measured 1.2e-6), u0 within
        # 1e-2 N, the iterate's positions but its last two nodes within
        # 1e-5 m (measured 6.1e-7 on the cold chain's tick 6, where the
        # split flips and moves the body rates by 2.1e-4; 1e-9 on the
        # other ticks), the cache within 1e-9 (measured 3e-12).
        if not warm:   # (the shifted warm iterate is no longer the step)
            qp, _ = trti.build_qp_jacreuse(ts, st, x, tF, tP, c, rf,
                                           solver=tocp.solver)
            obj_t, obj_j = (float(qp_objective(qp, xb - st.xbar,
                                               ub - st.ubar))
                            for xb, ub in ((st_new.xbar, st_new.ubar), (
                                torch.as_tensor(np.asarray(jst.xbar)),
                                torch.as_tensor(np.asarray(jst.ubar)))))
            assert abs(obj_t - obj_j) <= 1e-6 * max(abs(obj_j), 1.0), k
        uj = np.asarray(ju)
        np.testing.assert_allclose(
            [u[0:4].sum().item(), *u[4:6].tolist()],
            [uj[0:4].sum(), *uj[4:6]], rtol=0, atol=1e-5,
            err_msg=f"u0 thrust and rates, tick {k}")
        np.testing.assert_allclose(u.numpy(), uj, rtol=0, atol=1e-2,
                                   err_msg=f"u0, tick {k}")
        np.testing.assert_allclose(st_new.xbar[:-2, 0:3].numpy(),
                                   np.asarray(jst.xbar)[:-2, 0:3], rtol=0,
                                   atol=1e-5, err_msg=f"xbar, tick {k}")
        for f in ("A", "B"):
            np.testing.assert_allclose(
                getattr(c_new, f).numpy(), np.asarray(getattr(jc, f)),
                rtol=0, atol=1e-9, err_msg=f"{f}, tick {k}")
        if warm:
            for f in w_new._fields:
                np.testing.assert_allclose(
                    getattr(w_new, f).numpy(), np.asarray(getattr(out[2], f)),
                    rtol=1e-4, atol=1e-6, err_msg=f"warm {f}, tick {k}")
    if warm:
        # the shifted cache: its last two rows repeat the last stage's
        assert torch.equal(c_new.A[-1], c_new.A[-2])


@pytest.mark.parametrize("warm", [False, True])
def test_closed_loop_jac_refresh_matches_jax_f64(warm):
    """`closed_loop(jac_refresh=4)` is the hand-driven chain of the port's
    ticks bit for bit, and its positions stay within 1e-4 m of the JAX
    package's loop. The loops amplify rounding in the weakly determined
    rotor split, as every f64 closed loop across the two implementations
    does (tests/test_torch_golden.py): the body rates part by up to 1.1e-3
    rad/s and the controls by 1.5e-2 N after a few ticks (measured; the
    jac_refresh=1 loop parts the same way), the positions by 3.7e-6 m."""
    kw = (dict(ipm_iters=4, warm_mode="primal", warm_shift=True)
          if warm else {})
    jocp, tocp = _ocps(**kw)
    js, ts, x0 = _start(jocp)
    rj = jmcl(jocp, 10, dtype=jnp.float64, warm_start=warm,
              jac_refresh=4)(js, jnp.asarray(x0))
    rt = make_closed_loop(tocp, 10, dtype=F64, warm_start=warm,
                          jac_refresh=4)(ts, x0)
    _, xs = _port_ticks(tocp, ts, x0, warm, 10)
    assert torch.equal(rt.xs, xs)
    np.testing.assert_allclose(rt.xs[:, 0:3].numpy(),
                               np.asarray(rj.xs)[:, 0:3], rtol=0, atol=1e-4)
    assert float(rt.xs[-1, 2]) > 3.05   # climbing towards z = 3.5


def test_rti_controller_make_is_make_rti_step():
    _, ocp = _ocps()
    _, ts, x0 = _start(ocp)
    ctl = trti.RTIController(ocp, dtype=F64, device=DEV)
    st = trti.init_rti_state(ocp, torch.as_tensor(x0), F64)
    a = ctl.make()(ts, st, torch.as_tensor(x0))
    b = trti.make_rti_step(ocp, dtype=F64, device=DEV)(ts, st,
                                                         torch.as_tensor(x0))
    for x, y in zip(a[:2], b[:2]):
        for u, v in zip(x if isinstance(x, tuple) else (x,),
                        y if isinstance(y, tuple) else (y,)):
            assert torch.equal(u, v)
    assert dataclasses.is_dataclass(ctl) and ctl.num_steps == 1


def test_jac_cache_round_trip():
    rng = np.random.default_rng(5)
    src = {"A": rng.normal(size=(8, 17, 17)), "B": rng.normal(size=(8, 17,
                                                                    6))}
    c = convert.jac_cache_from_numpy(src, dtype=F64, device=DEV)
    assert isinstance(c, trti.JacCache)
    out = convert.jac_cache_to_numpy(c)
    for k in src:
        np.testing.assert_array_equal(out[k], src[k])
    jc = jrti.JacCache(A=jnp.asarray(src["A"]), B=jnp.asarray(src["B"]))
    back = convert.jac_cache_to_numpy(convert.jac_cache_from_numpy(
        _np(jc), dtype=F64, device=DEV))
    for k in src:
        np.testing.assert_array_equal(back[k], src[k])
