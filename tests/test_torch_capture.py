"""The port's `jax.jit`: `mpc_blaster_tpu_torch/utils/capture.py` and the
sites that use it, on the CPU.

On the card a runner captures its tick as a CUDA graph and replays it
(chip_smoke.py's phase 25 holds every site's replays to the eager ticks
bit for bit there). On the CPU the same buffer handling runs without a
graph, so here each site's runner is held to its eager function bit for
bit (`torch.equal`, no tolerance) over a few chained calls, at small
sizes (N <= 10, B <= 2):

- `sqp/rti.py::make_rti_step` on every QP backend;
- `sim/closedloop.py::make_closed_loop` (`capture.Scan`) against the
  eager `closed_loop` in every mode: plain, warm, guarded warm,
  Jacobian reuse cold and warm, the online POC modes;
- `parallel/mesh.py::batched_rti_step` ("xla", "pallas",
  "pallas_fused") and `batched_rti_step_per_scenario_spec`;
- `models/quad13.py::make_quad13_rti_step`;
- `io/mission.py::OffsetFreeFlightController` and `io/flight.py::
  FlightNode` ("safe" and the guarded "fastest" chain).

Against the JAX package's jitted counterparts, in float64 on "riccati":
`make_closed_loop` (the scan) over five ticks within 1e-4 m
(tests/test_torch_golden.py's bound for float64 loops across the two
implementations). The other sites' runners are what
tests/test_torch_rti.py (`make_rti_step`, the batched tick),
test_torch_batched.py, test_torch_quad13.py, test_torch_mission.py and
test_torch_io.py hold to JAX already: the sites return runners by
default.

Also: `jit=False` returns the eager function; a runner's results are the
caller's (a later call does not overwrite them) and share no storage with
its buffers, so a carried output fed back in is never the next call's
input in place; a new shape or static value captures anew; launch counts
recorded during a capture are added on each replay; and no tick body
makes a tensor from host data or waits for the card
(`torch_capture_guard.HostGuard`: `torch.tensor`, `torch.as_tensor` of
host data, value reads and the other calls a capture refuses).
"""
import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree

from mpc_blaster_tpu import config as jcfg
from mpc_blaster_tpu.ocp.spec import build_spec as jbuild_spec
from mpc_blaster_tpu.sim.closedloop import make_closed_loop as jmcl
from mpc_blaster_tpu_torch import config as cfg
from mpc_blaster_tpu_torch import convert
from mpc_blaster_tpu_torch.io.endurance import TARGET, mission_ocp
from mpc_blaster_tpu_torch.io.flight import FlightNode
from mpc_blaster_tpu_torch.io.mission import OffsetFreeFlightController
from mpc_blaster_tpu_torch.models import quad13 as Q
from mpc_blaster_tpu_torch.ocp.spec import build_spec
from mpc_blaster_tpu_torch.ops import box_qp_ipm as K
from mpc_blaster_tpu_torch.parallel import mesh as TM
from mpc_blaster_tpu_torch.sim import closedloop as CL
from mpc_blaster_tpu_torch.sqp import rti as trti
from mpc_blaster_tpu_torch.utils import capture
from torch_capture_guard import HostGuard
from torch_threads import one_intraop_thread  # noqa: F401

DEV = torch.device("cpu")
F64 = torch.float64


def _ocp(c, N=8, **solver):
    pre = c.simulation_preset()
    return dataclasses.replace(pre.ocp, N=N, Tf=N / 30.0,
                               solver=dataclasses.replace(pre.ocp.solver,
                                                          **solver))


@functools.lru_cache(maxsize=None)
def _preset_stage_params(dtype):
    return CL.preset_stage_params(cfg.simulation_preset(), dtype, DEV)


def _spec(ocp, dtype=torch.float32):
    return build_spec(ocp, yref=cfg.simulation_preset().loop.yref,
                      stage_params=_preset_stage_params(dtype), dtype=dtype,
                      device=DEV)


def _hover(dtype=torch.float32, B=None):
    x = torch.zeros(17, dtype=dtype)
    x[2] = 3.0
    return x if B is None else x + 0.01 * torch.arange(
        B, dtype=dtype)[:, None]


def _leaves(tree):
    return [v for v in pytree.tree_leaves(tree) if torch.is_tensor(v)]


def _equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y), (x - y).abs().max()


def _storages(tree):
    return {v.untyped_storage().data_ptr() for v in _leaves(tree)}


def _chain(run, args, n, carried):
    """n calls of run, each fed the previous call's carried outputs
    (`carried(args, out) -> args`). Returns the outputs, copied."""
    outs = []
    for _ in range(n):
        out = run(*args)
        outs.append(pytree.tree_map(
            lambda v: v.clone() if torch.is_tensor(v) else v, out))
        args = carried(args, out)
    return outs


def _held_to_eager(runner, args, n, carried):
    """The runner over n chained calls equals its eager function bit for
    bit; its results are the caller's and share no storage with its
    buffers or with the next call's inputs."""
    assert isinstance(runner, capture.Runner)
    want = _chain(runner.__wrapped__, args, n, carried)
    kept, prev = [], None
    for k in range(n):
        out = runner(*args)
        _equal(out, want[k])
        assert not (_storages(out) & _storages(args))
        if prev is not None:
            # a later call overwrote no earlier result
            _equal(prev[0], prev[1])
        prev = (out, pytree.tree_map(
            lambda v: v.clone() if torch.is_tensor(v) else v, out))
        kept.append(out)
        args = carried(args, out)
    for out, w in zip(kept, want):
        _equal(out, w)
    for entry in runner._entries.values():
        bufs = {b.untyped_storage().data_ptr() for b in entry.static
                if b is not None}
        assert not (bufs & set().union(*(_storages(o) for o in kept)))


def _step_carry(args, out):
    return (args[0], out[1], args[2])


# ---- the sites' runners against their eager functions ----

@pytest.mark.parametrize("backend", ["riccati", "pallas", "pallas_fused"])
def test_make_rti_step_runner_equals_eager(backend):
    ocp = _ocp(cfg, N=4, qp_backend=backend, ipm_iters=6)
    x = _hover()
    st = trti.init_rti_state(ocp, x, device=DEV)
    _held_to_eager(trti.make_rti_step(ocp, device=DEV), (_spec(ocp), st, x),
                   3, _step_carry)


LOOP_MODES = {
    "plain": (dict(), {}),
    "pallas_fused_lin": (dict(qp_backend="pallas", lin_backend="fused"), {}),
    "pallas_fused": (dict(qp_backend="pallas_fused", ipm_iters=6), {}),
    "warm": (dict(qp_backend="pallas", ipm_iters=4, warm_shift=True),
             dict(warm_start=True)),
    "guarded": (dict(qp_backend="pallas_fused", ipm_iters=3,
                     warm_shift=True, warm_watchdog=True),
                dict(warm_start=True)),
    "jac_refresh": (dict(qp_backend="pallas"), dict(jac_refresh=3)),
    "warm_jac_refresh": (dict(qp_backend="pallas", ipm_iters=4,
                              warm_shift=True),
                         dict(warm_start=True, jac_refresh=2)),
    "online": (dict(qp_backend="pallas_fused", ipm_iters=6),
               dict(poc_mode="online")),
    "online_stagewise": (dict(qp_backend="pallas_fused", ipm_iters=6),
                         dict(poc_mode="online_stagewise")),
}


@pytest.mark.parametrize("mode", list(LOOP_MODES))
def test_make_closed_loop_equals_closed_loop(mode):
    solver, kw = LOOP_MODES[mode]
    ocp = _ocp(cfg, N=4, **solver)
    spec, x = _spec(ocp), _hover()
    want = CL.closed_loop(spec, ocp, x, 3, **kw)
    run = CL.make_closed_loop(ocp, 3, **kw)
    first = run(spec, x)
    _equal(first, want)
    kept = pytree.tree_map(torch.clone, tuple(first))
    again = run(spec, x + 0.0)
    _equal(again, want)
    _equal(first, kept)
    assert not (_storages(first) & _storages(again))
    assert len(run.scan._entries) == 1


def test_batched_runners_equal_eager():
    ocp = _ocp(cfg, N=6, ipm_iters=6)
    spec = _spec(ocp)
    x0s = _hover(B=2)
    st = trti.init_rti_state(ocp, x0s, device=DEV)
    for backend in ("xla", "pallas", "pallas_fused"):
        _held_to_eager(TM.batched_rti_step(ocp, backend=backend, device=DEV),
                       (spec, st, x0s), 2, _step_carry)
    fused = _ocp(cfg, N=6, qp_backend="pallas_fused", ipm_iters=6)
    _held_to_eager(TM.batched_rti_step(fused, device=DEV), (spec, st, x0s),
                   2, _step_carry)
    _held_to_eager(TM.batched_rti_step_per_scenario_spec(ocp, device=DEV),
                   (trti.batch_spec(spec, 2), st, x0s), 2, _step_carry)


def _quad13(N=6):
    c = Q.Quad13Config()
    return dataclasses.replace(c, N=N, Tf=c.Tf * N / c.N)


@pytest.mark.parametrize("backend", ["riccati", "pallas_fused"])
def test_quad13_runner_equals_eager(backend):
    c = _quad13()
    x = Q.hover_state(device=DEV)
    x[2] = 1.8
    step = Q.make_quad13_rti_step(c, solver=cfg.SolverConfig(
        qp_backend=backend, ipm_iters=6), device=DEV)
    _held_to_eager(step, (Q.build_quad13_spec(c, device=DEV),
                          Q.init_quad13_rti_state(c, x), x), 3, _step_carry)


def _measurement(k):
    return (np.array([0.5 + 0.01 * k, 1.0 - 0.01 * k, 3.5 + 0.005 * k]),
            np.array([0.01 * np.sin(k / 3), -0.005, 0.002 * k]),
            np.array([0.1, -0.1, 0.05]))


def test_mission_controller_runner_equals_eager():
    """Three scripted ticks of the mission's controller ("pallas", N=10):
    the runner and the eager tick give the same commands, estimates and
    carried state bit for bit."""
    ocp = mission_ocp("pallas")
    yref = tuple(TARGET) + (0.0,) * 20
    ctrls = [OffsetFreeFlightController(
        ocp, build_spec(ocp, yref=yref, device=DEV)) for _ in range(2)]
    ctrls[1]._tick = ctrls[1]._tick.__wrapped__
    for k in range(3):
        (qa, ta, da), (qb, tb, db) = (c.tick(*_measurement(k))
                                      for c in ctrls)
        assert np.array_equal(qa, qb) and ta == tb
        _equal(da, db)
        assert np.array_equal(ctrls[0].d_est, ctrls[1].d_est)
        _equal((ctrls[0].state, ctrls[0].warm, ctrls[0].wd),
               (ctrls[1].state, ctrls[1].warm, ctrls[1].wd))


@pytest.mark.parametrize("profile", ["safe", "fastest"])
def test_flight_node_runners_equal_eager(profile):
    """Three ticks of the flight node under `deployed_solver(profile)`
    (N=6): the runners (the tick, the plant) and the eager functions
    publish the same messages and keep the same belief bit for bit."""
    pre = cfg.flight_preset()
    ocp = dataclasses.replace(pre.ocp, N=6, Tf=pre.ocp.Tf * 6 / pre.ocp.N,
                              solver=cfg.deployed_solver(profile))
    pre = dataclasses.replace(pre, ocp=ocp)
    nodes = [FlightNode(preset=pre, warm_start=profile == "fastest",
                        device=DEV) for _ in range(2)]
    eager = nodes[1]
    for name in ("_plant", "_step", "_step_warm"):
        if hasattr(eager, name):
            setattr(eager, name, getattr(eager, name).__wrapped__)
    for _ in range(3):
        ma, mb = (n.tick() for n in nodes)
        assert np.array_equal(ma.orientation, mb.orientation)
        assert ma.thrust == mb.thrust
    assert all(np.array_equal(a, b) for a, b in zip(nodes[0].history_x,
                                                     eager.history_x))
    _equal(nodes[0].state, eager.state)


# ---- against the JAX package's jitted counterparts (float64) ----

def _jax_start(N=6):
    jo, to = _ocp(jcfg, N=N), _ocp(cfg, N=N)
    from mpc_blaster_tpu.sim.closedloop import preset_stage_params
    pre = jcfg.simulation_preset()
    js = jbuild_spec(jo, yref=np.asarray(pre.loop.yref),
                     stage_params=np.asarray(preset_stage_params(
                         pre, jnp.float64)), dtype=jnp.float64)
    ts = convert.spec_from_numpy(
        {k: np.asarray(v) for k, v in js._asdict().items()}, dtype=F64,
        device=DEV)
    x0 = np.zeros(17)
    x0[2] = 3.0
    return jo, to, js, ts, x0


def test_closed_loop_runner_matches_jax_jit():
    jo, to, js, ts, x0 = _jax_start()
    jr = jmcl(jo, 5, dtype=jnp.float64)(js, jnp.asarray(x0))
    tr = CL.make_closed_loop(to, 5, dtype=F64)(ts, torch.as_tensor(x0))
    np.testing.assert_allclose(tr.xs[:, 0:3].numpy(),
                               np.asarray(jr.xs)[:, 0:3], rtol=0, atol=1e-4)


# ---- the mechanism ----

def test_jit_false_returns_the_eager_function():
    ocp = _ocp(cfg)
    c = Q.Quad13Config()
    for jitted, eager in (
            (trti.make_rti_step(ocp, device=DEV),
             trti.make_rti_step(ocp, jit=False, device=DEV)),
            (TM.batched_rti_step(ocp, device=DEV),
             TM.batched_rti_step(ocp, jit=False, device=DEV)),
            (TM.batched_rti_step_per_scenario_spec(ocp, device=DEV),
             TM.batched_rti_step_per_scenario_spec(ocp, jit=False,
                                                   device=DEV)),
            (Q.make_quad13_rti_step(c, device=DEV),
             Q.make_quad13_rti_step(c, jit=False, device=DEV))):
        assert isinstance(jitted, capture.Runner)
        assert not isinstance(eager, capture.Runner) and callable(eager)
        assert eager.__code__ is jitted.__wrapped__.__code__


def test_runner_keys_and_disable_jit():
    calls = []

    def f(a, flag, t):
        calls.append(flag)
        return a * 2 if flag else a + t.sum()
    run = capture.jit(f)
    a = torch.arange(6.0).reshape(2, 3)
    out = run(a, True, a)
    assert torch.equal(out, a * 2)
    run(a + 1, True, a)
    assert len(run._entries) == 1
    run(a, False, a)                       # a static value: a new key
    run(a.T, True, a)                      # new strides: a new key
    run(torch.zeros(3), True, torch.zeros(3))   # a new shape
    assert len(run._entries) == 4
    ex = a[:1].expand(4, 3)                # overlapping: a dense buffer
    assert torch.equal(run(ex, False, ex), ex + ex.sum())
    n = len(run._entries)
    with capture.disable_jit():
        assert torch.equal(run(a, False, a), a + a.sum())
    assert len(run._entries) == n and calls[-1] is False


def test_scan_hands_on_a_carry_that_aliases_another():
    """A tick whose new carry is a view of another carry buffer (a swap):
    the scan copies it out before it writes the buffers."""
    def tick(consts, carry, key):
        a, b = carry
        return (b, a + consts), a.sum()
    consts, carry = torch.tensor(1.0), (torch.zeros(2), torch.ones(2))
    stacked, last = capture.Scan()(tick, consts, carry, [True] * 4)
    want, c = [], carry
    for _ in range(4):
        c, o = tick(consts, c, True)
        want.append(o)
    assert torch.equal(stacked, torch.stack(want))
    _equal(last, c)


class _Graph:
    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


def test_launch_counts_recorded_during_a_capture_add_up_on_replays():
    """What a kernel wrapper counts while a graph is captured (nothing is
    launched) is recorded, and each replay adds it: the single plan's
    prologue grid too."""
    w = K.fused_rti_solve
    before = (w.launches, w.warm_launches, dict(w.by_instance),
              dict(w.by_layout), K.fused_lin_prologue.launches)
    plan = K.launch_plan(10, K.FUSE_LIN, False, 17, 6, 1)
    rec = []
    try:
        with capture._recording(rec):
            K._count(w, object(), "17x6 blaster", plan)
            K._count(w, None, "17x6 blaster", plan)
        assert (w.launches, w.warm_launches) == before[:2]
        g = _Graph()
        for _ in range(3):
            capture._replay(g, rec)
        assert g.replays == 3
        assert w.launches == before[0] + 6
        assert w.warm_launches == before[1] + 3
        assert w.by_instance["17x6 blaster"] == \
            before[2].get("17x6 blaster", 0) + 6
        assert w.by_layout[plan.key] == \
            before[3].get(plan.key, 0) + 6
        assert K.fused_lin_prologue.launches == before[4] + 6
        K._count(w, None, "17x6 blaster", plan)     # no capture: counted
        assert w.launches == before[0] + 7
        assert K.fused_lin_prologue.launches == before[4] + 7
    finally:
        w.launches, w.warm_launches = before[:2]
        w.by_instance, w.by_layout = before[2], before[3]
        K.fused_lin_prologue.launches = before[4]


# ---- the tick bodies make no tensor from host data ----

def test_host_guard_sees_host_data_and_syncs():
    t = torch.ones(3)
    with HostGuard() as seen:
        torch.tensor([1.0])
        torch.as_tensor(2.0)
        torch.as_tensor(t)                 # a tensor: no host data
        t.sum().item()
        t[t > 0]
    assert seen.count("tensor") == 1 and seen.count("as_tensor") == 1
    assert "item" in seen and "__getitem__" in seen


GUARD_SITES = ["rti_step riccati", "rti_step pallas",
               "rti_step pallas_fused", "batched xla", "batched pallas",
               "batched pallas_fused", "quad13", "loop plain",
               "loop pallas_fused_lin", "loop warm", "loop guarded",
               "loop jac_refresh reuse", "loop online_stagewise"]


def _site_call(name):
    """One eager call of a site's tick body: (fn, args)."""
    kind, what = name.split(" ", 1) if " " in name else (name, "")
    if kind == "rti_step":
        ocp = _ocp(cfg, N=6, qp_backend=what, ipm_iters=6)
        x = _hover()
        return (trti.make_rti_step(ocp, device=DEV).__wrapped__,
                (_spec(ocp), trti.init_rti_state(ocp, x, device=DEV), x))
    if kind == "batched":
        ocp = _ocp(cfg, N=6, ipm_iters=6)
        x0s = _hover(B=2)
        return (TM.batched_rti_step(ocp, backend=what,
                                    device=DEV).__wrapped__,
                (_spec(ocp), trti.init_rti_state(ocp, x0s, device=DEV),
                 x0s))
    if kind == "quad13":
        c = _quad13()
        x = Q.hover_state(device=DEV)
        return (Q.make_quad13_rti_step(c, device=DEV).__wrapped__,
                (Q.build_quad13_spec(c, device=DEV),
                 Q.init_quad13_rti_state(c, x), x))
    mode = what.split(" ")[0]
    solver, kw = LOOP_MODES[mode]
    ocp = _ocp(cfg, N=4, **solver)
    consts, carry, tick = CL._loop(
        _spec(ocp), ocp, _hover(), None, torch.float32, 1, None,
        kw.get("poc_mode", "frozen"), None, kw.get("warm_start", False),
        kw.get("jac_refresh", 1))
    return tick, (consts, carry, not what.endswith("reuse"))


@pytest.mark.parametrize("site", GUARD_SITES)
def test_tick_body_makes_no_tensor_from_host_data(site):
    fn, args = _site_call(site)
    with HostGuard() as seen:
        fn(*args)
    assert not seen, sorted(set(seen))


def test_shell_tick_bodies_make_no_tensor_from_host_data():
    ocp = mission_ocp("pallas")
    ctrl = OffsetFreeFlightController(ocp, build_spec(
        ocp, yref=tuple(TARGET) + (0.0,) * 20, device=DEV))
    x = torch.zeros(17)
    x[2] = 3.0
    with HostGuard() as seen:
        ctrl._tick.__wrapped__(torch.zeros(6), ctrl.state, ctrl.warm,
                               ctrl.wd, x)
    assert not seen, sorted(set(seen))
    for profile in ("safe", "fastest"):
        pre = cfg.flight_preset()
        pre = dataclasses.replace(pre, ocp=dataclasses.replace(
            pre.ocp, N=6, Tf=pre.ocp.Tf * 6 / pre.ocp.N,
            solver=cfg.deployed_solver(profile)))
        node = FlightNode(preset=pre, warm_start=profile == "fastest",
                          device=DEV)
        with HostGuard() as seen:
            if profile == "fastest":
                u0 = node._step_warm.__wrapped__(
                    node.spec, node.state, node._warm, node._wd,
                    node.x)[0]
            else:
                u0 = node._step.__wrapped__(node.spec, node.state,
                                            node.x)[0]
            node._plant.__wrapped__(node.x, u0, node._plant_params,
                                    node.params)
        assert not seen, (profile, sorted(set(seen)))
