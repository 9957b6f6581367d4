"""The port's slice as a whole: the closed loop (`run_preset`, simulation
preset with `qp_backend="pallas"`, frozen POC) against the JAX package's
loop with Pallas in interpret mode; the numpy round trips of
`convert.py`; that the port imports no JAX; and that options outside the
slice are refused rather than silently switched.
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
    rt = run_preset(pre, n_steps=5, dtype=torch.float32, with_poc=True)
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
        p = preset_stage_params(pre, tdt)
        assert p.dtype == tdt
        np.testing.assert_allclose(p.numpy(), np.asarray(jpsp(pre, jdt)),
                                   rtol=1e-6, atol=1e-9)
    assert preset_stage_params(cfg.flight_preset()) is None


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
        out = back(fwd(obj, dtype=torch.float64))
        assert out.keys() == src.keys()
        for k in src:
            np.testing.assert_array_equal(out[k], src[k], err_msg=k)
    spec = convert.spec_from_numpy(js)
    assert spec.horizon == 8 and spec.Q.dtype == torch.float32


PORT_MODULES = [
    "mpc_blaster_tpu_torch", "mpc_blaster_tpu_torch.config",
    "mpc_blaster_tpu_torch.convert",
    "mpc_blaster_tpu_torch.core.rotations", "mpc_blaster_tpu_torch.core.htm",
    "mpc_blaster_tpu_torch.dynamics.blaster",
    "mpc_blaster_tpu_torch.dynamics.fastlin",
    "mpc_blaster_tpu_torch.dynamics.integrators",
    "mpc_blaster_tpu_torch.poc.jet", "mpc_blaster_tpu_torch.poc.solver",
    "mpc_blaster_tpu_torch.ocp.spec", "mpc_blaster_tpu_torch.qp.data",
    "mpc_blaster_tpu_torch.ops.box_qp_ipm", "mpc_blaster_tpu_torch.sqp.rti",
    "mpc_blaster_tpu_torch.sim.closedloop",
    "mpc_blaster_tpu_torch.parallel.mesh",
]


def test_port_imports_no_jax():
    """Importing every port module leaves `jax` out of sys.modules, and
    the module list above covers every file of the package."""
    found = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts).replace(
            ".__init__", "")
        for p in (REPO / "mpc_blaster_tpu_torch").rglob("*.py"))
    subpackages = {m for m in found if (REPO / m.replace(".", "/")).is_dir()}
    assert set(found) - subpackages <= set(PORT_MODULES), found
    code = ("import importlib, sys\n"
            f"for m in {PORT_MODULES!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' "
            "or m.startswith(('jax.', 'jaxlib')))\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0 and "ok" in res.stdout, res.stderr


def _refused(fn):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        fn()


@pytest.mark.parametrize("backend", ["riccati", "condensed"])
def test_out_of_slice_qp_backends_refused(backend):
    from mpc_blaster_tpu_torch.sqp.rti import make_rti_step
    pre = cfg.simulation_preset()
    ocp = dataclasses.replace(pre.ocp, solver=dataclasses.replace(
        pre.ocp.solver, qp_backend=backend))
    _refused(lambda: make_rti_step(ocp))
    # the preset's own default ("riccati") is refused, not switched
    _refused(lambda: run_preset(dataclasses.replace(pre, ocp=ocp),
                                n_steps=1))


def test_out_of_slice_options_refused():
    from mpc_blaster_tpu_torch.ocp.spec import build_spec
    from mpc_blaster_tpu_torch.parallel.mesh import batched_rti_step
    from mpc_blaster_tpu_torch.sim.closedloop import closed_loop
    from mpc_blaster_tpu_torch.sqp.rti import (make_rti_step, rti_step_soft,
                                               solve_qp_backend)
    pre = _pallas_preset()
    ocp = pre.ocp
    spec = build_spec(ocp)
    x0 = torch.zeros(cfg.NX)
    _refused(lambda: closed_loop(spec, ocp, x0, 1, warm_start=True))
    _refused(lambda: closed_loop(spec, ocp, x0, 1, poc_mode="online"))
    _refused(lambda: closed_loop(spec, ocp, x0, 1, jac_refresh=2))
    _refused(lambda: solve_qp_backend(None, ocp.solver, warm=object()))
    _refused(lambda: rti_step_soft(spec, None, x0, None, None, ocp.solver,
                                   soft=object()))
    _refused(lambda: batched_rti_step(ocp))   # the JAX default, "xla"
    _refused(lambda: batched_rti_step(ocp, backend="xla"))
