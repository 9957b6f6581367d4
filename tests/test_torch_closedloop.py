"""The port's slice as a whole: the closed loop (`run_preset`, simulation
preset with `qp_backend="pallas"`, frozen POC) against the JAX package's
loop with Pallas in interpret mode, and on the presets' own default
`"riccati"` against the JAX loop in float64; the numpy round trips of
`convert.py`; that the port imports nothing of JAX or of the JAX package;
that its own copy of the config matches the JAX package's field by field;
that the loop entry points take their arguments in the JAX package's
order; and that options outside the slice are refused rather than silently
switched.
"""
import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mpc_blaster_tpu import config as cfg
from mpc_blaster_tpu.sim.closedloop import run_preset as jrun_preset
from mpc_blaster_tpu_torch.sim.closedloop import run_preset

# The port runs on the CUDA card unless asked for the CPU; these tests
# ask for it.
DEV = torch.device("cpu")

REPO = Path(__file__).resolve().parents[1]


def _pallas_preset(N=8):
    pre = cfg.simulation_preset()
    ocp = dataclasses.replace(
        pre.ocp, N=N, Tf=N / 30.0,
        solver=dataclasses.replace(pre.ocp.solver, qp_backend="pallas"))
    return dataclasses.replace(pre, ocp=ocp)


def test_closed_loop_matches_jax():
    """Five ticks from the preset's start on the ground towards z=3.5, in
    float32. Every tick here is a take-off transient whose QPs no solver
    converges within the budget (measured: Pallas, the f32 twin and the
    f64 twin end at different best-merit iterates, 12 to 30 iterations),
    so the loops drift apart by f32 rounding alone. Measured gap on this
    input: positions 3.8e-3 m, per-tick cost 8.6e-2 relative. Bounds:
    positions 1e-2 m and cost 0.25 relative (each under 3x the gap)."""
    pre = _pallas_preset()
    rj = jrun_preset(pre, n_steps=5, dtype=jnp.float32, with_poc=True)
    rt = run_preset(pre, n_steps=5, dtype=torch.float32, with_poc=True,
                    device=DEV)
    xs_j, xs_t = np.asarray(rj.xs), rt.xs.numpy()
    assert xs_t.shape == xs_j.shape == (6, cfg.NX)
    assert np.isfinite(xs_t).all() and torch.isfinite(rt.us).all()
    np.testing.assert_allclose(xs_t[:, 0:3], xs_j[:, 0:3], rtol=0, atol=1e-2)
    np.testing.assert_allclose(rt.costs.numpy(), np.asarray(rj.costs),
                               rtol=0.25)
    # the vehicle climbs in both loops
    assert xs_t[-1, 2] > 0.1 and xs_j[-1, 2] > 0.1


def test_preset_stage_params_match_jax():
    """POC Jacobians solved once in float64 on the host, then cast
    (atol 1e-9, the POC parity tolerance of tests/test_torch_poc.py; the
    f32 cast may round a last bit differently: rtol 1e-6)."""
    from mpc_blaster_tpu.sim.closedloop import preset_stage_params as jpsp
    from mpc_blaster_tpu_torch.sim.closedloop import preset_stage_params
    pre = cfg.simulation_preset()
    for jdt, tdt in ((jnp.float64, torch.float64),
                     (jnp.float32, torch.float32)):
        p = preset_stage_params(pre, tdt, device=DEV)
        assert p.dtype == tdt
        np.testing.assert_allclose(p.numpy(), np.asarray(jpsp(pre, jdt)),
                                   rtol=1e-6, atol=1e-9)
    assert preset_stage_params(cfg.flight_preset(), device=DEV) is None


def test_convert_round_trips():
    from mpc_blaster_tpu.ocp.spec import build_spec
    from mpc_blaster_tpu.sqp.rti import init_rti_state
    from mpc_blaster_tpu_torch import convert
    ocp = _pallas_preset().ocp
    js = build_spec(ocp, yref=np.asarray(cfg.simulation_preset().loop.yref),
                    dtype=jnp.float64)
    st = init_rti_state(ocp, jnp.ones(cfg.NX), jnp.float64)
    rng = np.random.default_rng(0)
    qp = {f: rng.normal(size=s) for f, s in (
        ("A", (8, 17, 17)), ("B", (8, 17, 6)), ("c", (8, 17)),
        ("Q", (9, 17, 17)), ("q", (9, 17)), ("R", (8, 6, 6)), ("r", (8, 6)),
        ("lbx", (9, 17)), ("ubx", (9, 17)), ("lbu", (8, 6)),
        ("ubu", (8, 6)), ("dx0", (17,)))}
    for obj, fwd, back in (
            (js, convert.spec_from_numpy, convert.spec_to_numpy),
            (st, convert.rti_state_from_numpy, convert.rti_state_to_numpy),
            (qp, convert.qp_from_numpy, convert.qp_to_numpy)):
        src = obj if isinstance(obj, dict) else \
            {k: np.asarray(v) for k, v in obj._asdict().items()}
        out = back(fwd(obj, dtype=torch.float64, device=DEV))
        assert out.keys() == src.keys()
        for k in src:
            np.testing.assert_array_equal(out[k], src[k], err_msg=k)
    spec = convert.spec_from_numpy(js, device=DEV)
    assert spec.horizon == 8 and spec.Q.dtype == torch.float32


PORT_MODULES = [
    "mpc_blaster_tpu_torch", "mpc_blaster_tpu_torch.config",
    "mpc_blaster_tpu_torch.convert", "mpc_blaster_tpu_torch.device",
    "mpc_blaster_tpu_torch.core.rotations", "mpc_blaster_tpu_torch.core.htm",
    "mpc_blaster_tpu_torch.dynamics.blaster",
    "mpc_blaster_tpu_torch.dynamics.fastlin",
    "mpc_blaster_tpu_torch.dynamics.integrators",
    "mpc_blaster_tpu_torch.poc.jet", "mpc_blaster_tpu_torch.poc.solver",
    "mpc_blaster_tpu_torch.ocp.spec", "mpc_blaster_tpu_torch.ocp.terminal",
    "mpc_blaster_tpu_torch.models.quad13", "mpc_blaster_tpu_torch.qp.data",
    "mpc_blaster_tpu_torch.qp.smallalg", "mpc_blaster_tpu_torch.qp.riccati",
    "mpc_blaster_tpu_torch.qp.ipm", "mpc_blaster_tpu_torch.qp.soft",
    "mpc_blaster_tpu_torch.ops.box_qp_ipm",
    "mpc_blaster_tpu_torch.ops.nvcc_build", "mpc_blaster_tpu_torch.ops.probes",
    "mpc_blaster_tpu_torch.sqp.rti",
    "mpc_blaster_tpu_torch.sim.closedloop",
    "mpc_blaster_tpu_torch.sim.scenarios", "mpc_blaster_tpu_torch.sim.tasks",
    "mpc_blaster_tpu_torch.parallel.mesh",
]


def _imports_clean(modules):
    """Import `modules` in a fresh interpreter; assert that no `jax` /
    `jaxlib` module and nothing of the JAX package (`mpc_blaster_tpu` or
    `mpc_blaster_tpu.*`) got loaded. The port's own
    `mpc_blaster_tpu_torch*` modules do not count."""
    code = ("import importlib, sys\n"
            f"for m in {list(modules)!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m in ('jax', 'jaxlib', "
            "'mpc_blaster_tpu') or m.startswith(('jax.', 'jaxlib.', "
            "'mpc_blaster_tpu.')))\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0 and "ok" in res.stdout, res.stderr


def test_port_imports_no_jax():
    """Importing every port module, chip_smoke.py and kernel_ab.py loads
    nothing of JAX or of the JAX package, and the module list above covers
    every file of the package."""
    found = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts).replace(
            ".__init__", "")
        for p in (REPO / "mpc_blaster_tpu_torch").rglob("*.py"))
    subpackages = {m for m in found if (REPO / m.replace(".", "/")).is_dir()}
    assert set(found) - subpackages <= set(PORT_MODULES), found
    _imports_clean(PORT_MODULES + ["chip_smoke", "kernel_ab"])


def test_default_device_is_the_card():
    """The port runs on the CUDA card unless asked for the CPU
    (`device.py`): an explicit device is used as given, a tensor the
    caller hands in keeps its device, and the default is the card. On a
    machine without one, a bare entry point raises and says how to ask
    for the CPU; it never falls back to it."""
    import numpy as np
    from mpc_blaster_tpu_torch import config as tcfg
    from mpc_blaster_tpu_torch.device import resolve_device
    from mpc_blaster_tpu_torch.dynamics.blaster import BlasterParams
    from mpc_blaster_tpu_torch.ocp.spec import build_spec
    from mpc_blaster_tpu_torch.parallel.mesh import batched_rti_step
    from mpc_blaster_tpu_torch.qp.ipm import IpmWarmStart
    from mpc_blaster_tpu_torch.sim.scenarios import sample_scenarios
    from mpc_blaster_tpu_torch.sqp.rti import init_rti_state, make_rti_step
    t = torch.zeros(1)
    assert resolve_device("cpu", None) == torch.device("cpu")
    assert resolve_device(None, np.zeros(1), t) == t.device
    pre = tcfg.simulation_preset()
    ocp = pre.ocp
    # a tensor's device wins over the default
    assert init_rti_state(ocp, torch.zeros(cfg.NX)).xbar.device == t.device
    bare = [lambda: run_preset(pre, n_steps=1),
            lambda: build_spec(ocp), lambda: sample_scenarios(2),
            lambda: make_rti_step(ocp), lambda: batched_rti_step(ocp),
            lambda: BlasterParams.from_config(ocp.model),
            lambda: init_rti_state(ocp, np.zeros(cfg.NX)),
            lambda: IpmWarmStart.zeros(ocp.N, cfg.NX, cfg.NU)]
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
        assert run_preset(pre, n_steps=1).xs.device.type == "cuda"
    else:
        for call in bare:
            with pytest.raises(RuntimeError, match='device="cpu"'):
                call()
    res = run_preset(pre, n_steps=1, device="cpu")
    assert res.xs.device.type == "cpu" and torch.isfinite(res.xs).all()


@pytest.mark.parametrize("module", PORT_MODULES + ["chip_smoke"])
def test_port_module_imports_nothing_of_jax(module):
    """The same check for each module alone, so that no module passes only
    because another one was imported first."""
    _imports_clean([module])


def _same_fields(a, b, where="config"):
    """Two configs (of either package) equal field by field; numpy arrays
    by value. The port's dataclasses are its own classes, so `==` between
    the two packages' instances is always False."""
    if dataclasses.is_dataclass(a):
        assert dataclasses.is_dataclass(b), where
        assert type(a).__name__ == type(b).__name__, where
        fa, fb = dataclasses.fields(a), dataclasses.fields(b)
        assert [f.name for f in fa] == [f.name for f in fb], where
        for f in fa:
            _same_fields(getattr(a, f.name), getattr(b, f.name),
                         f"{where}.{f.name}")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        np.testing.assert_array_equal(a, b, err_msg=where)
    else:
        assert type(a) is type(b) and a == b, (where, a, b)


def test_port_config_matches_jax_config():
    """The port's own copy of `mpc_blaster_tpu/config.py`: every preset
    (with the cost matrices it builds) and every `deployed_solver` profile
    against the JAX package's, field by field, and the module constants."""
    from mpc_blaster_tpu_torch import config as tcfg
    assert sorted(tcfg.PRESETS) == sorted(cfg.PRESETS)
    for name in cfg.PRESETS:
        a, b = tcfg.get_preset(name), cfg.get_preset(name)
        _same_fields(a, b, name)
        for m in ("Q", "R", "Q_t"):
            np.testing.assert_array_equal(getattr(a.ocp.cost, m)(),
                                          getattr(b.ocp.cost, m)())
        assert a.ocp.dt == b.ocp.dt
    for profile in ("safe", "fast", "fastest"):
        _same_fields(tcfg.deployed_solver(profile),
                     cfg.deployed_solver(profile), profile)
    with pytest.raises(ValueError, match="unknown deployment profile"):
        tcfg.deployed_solver("turbo")
    for k in ("NX", "NU", "NP", "NY", "IDX_P", "IDX_EUL", "IDX_V",
              "IDX_OMEGA", "IDX_ALPHA", "IDX_POC"):
        assert getattr(tcfg, k) == getattr(cfg, k), k
    _same_fields(tcfg.SolverConfig(), cfg.SolverConfig(), "SolverConfig()")


def _refused(fn):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        fn()


@pytest.mark.parametrize("backend", ["riccati", "condensed"])
def test_out_of_slice_qp_backends_refused(backend):
    """"condensed" is refused, not switched; the presets' own default
    "riccati" runs the port's Riccati IPM: three ticks of the simulation
    preset's loop at N=8 match the JAX package's in float64: the first
    tick's controls within 1e-9 (measured 2.2e-11); past it the
    12-iteration solves amplify rounding into the weakly determined rotor
    split (measured 1.2e-5 N on 35-65 N thrusts, states 3.1e-7), so the
    later ticks are held at 1e-4 N and 1e-5."""
    from mpc_blaster_tpu_torch.sqp.rti import make_rti_step
    pre = cfg.simulation_preset()
    ocp = dataclasses.replace(pre.ocp, N=8, Tf=8 / 30.0,
                              solver=dataclasses.replace(
                                  pre.ocp.solver, qp_backend=backend))
    pre = dataclasses.replace(pre, ocp=ocp)
    if backend == "condensed":
        _refused(lambda: make_rti_step(ocp, device=DEV))
        _refused(lambda: run_preset(pre, n_steps=1, device=DEV))
        return
    assert jrun_preset is not None and make_rti_step(ocp,
                                                     device=DEV) is not None
    rj = jrun_preset(pre, n_steps=3, dtype=jnp.float64, with_poc=True)
    rt = run_preset(pre, n_steps=3, dtype=torch.float64, with_poc=True,
                    device=DEV)
    assert rt.us.dtype == torch.float64
    np.testing.assert_allclose(rt.us[0].numpy(), np.asarray(rj.us[0]),
                               rtol=0, atol=1e-9)
    np.testing.assert_allclose(rt.us.numpy(), np.asarray(rj.us), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(rt.xs.numpy(), np.asarray(rj.xs), rtol=0,
                               atol=1e-5)


def test_out_of_slice_options_refused():
    from mpc_blaster_tpu_torch.ocp.spec import build_spec
    from mpc_blaster_tpu_torch.parallel.mesh import batched_rti_step
    from mpc_blaster_tpu_torch.sim.closedloop import closed_loop
    from mpc_blaster_tpu_torch.sqp.rti import (make_rti_step, rti_step_soft,
                                               solve_qp_backend)
    pre = _pallas_preset()
    ocp = pre.ocp
    spec = build_spec(ocp, device=DEV)
    x0 = torch.zeros(cfg.NX)
    # ported with the blast scan: the online POC modes and the
    # Jacobian-reuse ticks, cold and warm (rti_step_warm_jacreuse), run on
    # the kernel backend's CPU twin; tests/test_torch_online_loop.py and
    # tests/test_torch_jacreuse.py hold them against the JAX package
    for kw in (dict(warm_start=True, jac_refresh=2),
               dict(poc_mode="online"), dict(poc_mode="online_stagewise"),
               dict(jac_refresh=2)):
        res = closed_loop(spec, ocp, x0, 3, **kw)
        assert res.xs.shape == (4, cfg.NX), kw
        assert torch.isfinite(res.xs).all() and torch.isfinite(res.us).all()
    # the watchdog has no Jacobian-reuse tick
    with pytest.raises(ValueError, match="jac_refresh"):
        closed_loop(spec, dataclasses.replace(ocp, solver=dataclasses.replace(
            ocp.solver, warm_watchdog=True)), x0, 1, warm_start=True,
            jac_refresh=2)
    _refused(lambda: solve_qp_backend(None, dataclasses.replace(
        ocp.solver, qp_backend="condensed"), warm=object()))
    # ported in the soft slice: the soft tick and the batched "xla" tick
    # (the JAX default) run; tests/test_torch_soft.py holds them against
    # the JAX package
    from mpc_blaster_tpu_torch.dynamics.blaster import (BlasterParams,
                                                        blaster_ode)
    from mpc_blaster_tpu_torch.dynamics.integrators import discrete_dynamics
    from mpc_blaster_tpu_torch.qp.soft import SoftBounds
    from mpc_blaster_tpu_torch.sqp.rti import init_rti_state
    x_out = x0.clone()
    x_out[0], x_out[2] = 2.4, 2.0
    soft = SoftBounds.state_bounds(ocp.N, cfg.NX, cfg.NU, Zl=1e3, zl=1e2,
                                   device=DEV)
    u0, _, diag, res = rti_step_soft(
        spec, init_rti_state(ocp, x_out, device=DEV), x_out,
        BlasterParams.from_config(ocp.model, device=DEV), discrete_dynamics(
            blaster_ode, ocp.dt), ocp.solver, soft)
    assert torch.isfinite(u0).all() and float(res.t_ux[0, 0]) > 0.5
    for step in (batched_rti_step(ocp, device=DEV), batched_rti_step(ocp,
                                                         backend="xla",
                                                         device=DEV)):
        u0s, _, _ = step(spec, init_rti_state(ocp, x0[None].repeat(2, 1),
                                              device=DEV),
                         x0[None].repeat(2, 1))
        assert u0s.shape == (2, cfg.NU) and torch.isfinite(u0s).all()


def test_loop_signatures_follow_jax():
    """`closed_loop` and `make_closed_loop` take the JAX package's
    arguments in its order (`poc_cfg` between `poc_mode` and
    `warm_start`), so a positional call binds as it does there: a
    positional `make_closed_loop` equals the keyword call."""
    import inspect
    from mpc_blaster_tpu.sim import closedloop as J
    from mpc_blaster_tpu_torch import config as tcfg
    from mpc_blaster_tpu_torch.ocp.spec import build_spec
    from mpc_blaster_tpu_torch.sim import closedloop as T
    for name in ("closed_loop", "make_closed_loop"):
        jp = list(inspect.signature(getattr(J, name)).parameters)
        tp = list(inspect.signature(getattr(T, name)).parameters)
        assert tp == jp, (name, tp, jp)
    assert "device" in inspect.signature(T.run_preset).parameters
    pre = tcfg.simulation_preset()
    ocp = dataclasses.replace(pre.ocp, N=8, Tf=8 / 30.0)
    spec = build_spec(ocp, yref=pre.loop.yref, dtype=torch.float64,
                      device=DEV)
    x0 = torch.zeros(cfg.NX, dtype=torch.float64)
    x0[2] = 3.0
    pc = tcfg.PocSolverConfig(stream_velocity=120.0)
    a = T.make_closed_loop(ocp, 2, torch.float64, 1, "online", pc, True,
                           2)(spec, x0)
    b = T.make_closed_loop(ocp, 2, dtype=torch.float64, poc_mode="online",
                           poc_cfg=pc, warm_start=True,
                           jac_refresh=2)(spec, x0)
    c = T.make_closed_loop(ocp, 2, dtype=torch.float64, poc_mode="online",
                           warm_start=True, jac_refresh=2)(spec, x0)
    assert torch.equal(a.xs, b.xs) and torch.equal(a.us, b.us)
    # the jet of poc_cfg is the one the online mode linearizes
    assert not torch.equal(a.xs, c.xs)
