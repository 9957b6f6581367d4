"""Port parity of the blast scan (`sim/tasks.py`) against the JAX package:
the scan's references, the POC-mode and carry rules, the tracking loop's
online POC modes with the exact plant POC, and `run_blast_scan` with both
rules on "auto".

Tolerances and why:
  - `blast_scan_refs`: 1e-12 (the same numpy formulas);
  - the two rules: equal on tests/test_tasks.py:132-180's cases and on a
    seeded grid of scans around the 0.8 m/s threshold;
  - the loops, float64 on "riccati" at N=10, 5 ticks from the scan's
    hover start: states within 1e-6 (each tick's jet solves agree to
    ~1e-15, tests/test_torch_poc.py; the 12-iteration solves of a hovering
    vehicle converge, so the best-merit iterate does not flip between the
    two implementations as it does on take-off transients,
    tests/test_torch_golden.py). The controls within 1e-5 relative: the
    12-iteration solves amplify rounding into the weakly determined rotor
    split (measured 1.4e-7 relative in "online", 2.2e-6 in the stagewise
    modes, on 4-15 N thrusts), and through the rotors' differential
    torque the body rates within 1e-5 (measured: roll rate 1.8e-7 rad/s
    apart in "online", 7.8e-7 and 1.4e-6 in the stagewise modes, every
    other state within 1e-7 and the positions within 1e-9).
"""
import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mpc_blaster_tpu import config as jcfg
from mpc_blaster_tpu.dynamics.blaster import pack_stage_params as jpack
from mpc_blaster_tpu.ocp.spec import build_spec as jbuild_spec
from mpc_blaster_tpu.poc.solver import PocSolver as JPocSolver
from mpc_blaster_tpu.poc.solver import solve_poc as jsolve_poc
from mpc_blaster_tpu.sim import tasks as JK
from mpc_blaster_tpu_torch import config as cfg
from mpc_blaster_tpu_torch.convert import spec_from_numpy
from mpc_blaster_tpu_torch.sim import tasks as TK

# The port runs on the CUDA card unless asked for the CPU; these tests
# ask for it.
DEV = torch.device("cpu")

# bench.py's two scan profiles (its kwb and kwa) without the run's
# arguments
GENTLE = dict(z_end=1.5, t_ramp_s=6.0)
AGGRESSIVE = dict(z_end=1.2, t_ramp_s=4.0, amp_x=1.1, amp_y=0.45,
                  period_s=24.0)
STATE_ATOL = 1e-6
RATES_ATOL = 1e-5
CONTROL_RTOL = 1e-5


def _states_close(xs_t, xs_j):
    """States within STATE_ATOL, the body rates x[9:12] within
    RATES_ATOL."""
    tol = np.full(17, STATE_ATOL)
    tol[9:12] = RATES_ATOL
    gap = np.abs(xs_t - xs_j)
    assert (gap <= tol).all(), gap.max(axis=0)


def _np(x):
    return {k: np.asarray(v) for k, v in x._asdict().items()}


@pytest.mark.parametrize("kw", [
    {}, dict(carry_frac=0.6), GENTLE, dict(AGGRESSIVE, carry_frac=0.6),
    dict(center=(-0.3, 0.2), hover=(0.1, -0.2, 3.0), t_ramp_s=2.0,
         z_end=2.0, carry_frac=0.3)])
def test_blast_scan_refs_match_jax(kw):
    for n in (1, 57, 400):
        np.testing.assert_allclose(TK.blast_scan_refs(n, 1 / 30.0, **kw),
                                   JK.blast_scan_refs(n, 1 / 30.0, **kw),
                                   rtol=0, atol=1e-12)


def test_selectors_match_jax():
    cases = [{}, GENTLE, AGGRESSIVE,
             dict(center=(-0.6, 0.0), hover=(0.0, 0.0, 3.5), **GENTLE)]
    assert TK.select_poc_mode(**GENTLE) == "frozen"
    assert TK.select_poc_mode(**AGGRESSIVE) == "online_stagewise"
    assert TK.select_carry_frac(**GENTLE) == 0.0
    assert TK.select_carry_frac(**AGGRESSIVE) == 0.6
    rng = np.random.default_rng(11)
    for _ in range(200):
        cases.append(dict(
            amp_x=rng.uniform(0.1, 1.5), amp_y=rng.uniform(0.05, 0.6),
            period_s=rng.uniform(10.0, 60.0),
            hover=(0.0, 0.0, rng.uniform(2.0, 4.0)),
            z_end=None if rng.uniform() < 0.3 else rng.uniform(1.0, 3.0),
            t_ramp_s=rng.uniform(2.0, 8.0), carry_frac=0.6))
    modes = set()
    for kw in cases:
        assert TK.select_poc_mode(**kw) == JK.select_poc_mode(**kw), kw
        assert TK.select_carry_frac(**kw) == JK.select_carry_frac(**kw), kw
        modes.add(TK.select_poc_mode(**kw))
    assert modes == {"frozen", "online_stagewise"}


def _small_preset(c, N=10):
    """The simulation preset of config module `c` (the JAX package's or
    the port's) at horizon N."""
    pre = c.simulation_preset()
    return dataclasses.replace(pre, ocp=dataclasses.replace(
        pre.ocp, N=N, Tf=N / 30.0))


def _scan_start(ocp, n_steps, **scan):
    """The scan's references, its spec (the POC rows frozen at the
    canonical pose, float64) and its start at the hover with the exact
    POC, as `run_blast_scan` builds them."""
    refs = JK.blast_scan_refs(n_steps + ocp.N + 1, ocp.dt, **scan)
    ps = JPocSolver().initialise()
    p = jpack(*ps.get_jacobians(), 2.2 * 9.81)
    js = jbuild_spec(ocp, stage_params=np.asarray(p), dtype=jnp.float64)
    x0 = np.zeros(17)
    x0[0:3] = (0.0, 0.0, 3.5)
    x0[14:17] = np.asarray(jsolve_poc(jnp.zeros(3), jnp.zeros(2),
                                      jnp.asarray(x0[0:3]))[0])
    return refs, js, x0


@pytest.mark.parametrize("mode", ["online", "online_stagewise",
                                  "stagewise_anchored"])
def test_tracking_loop_online_modes_match_jax_f64(mode):
    ocp = _small_preset(jcfg).ocp
    refs, js, x0 = _scan_start(ocp, 5, **AGGRESSIVE)
    rj = JK.make_tracking_loop(ocp, 5, dtype=jnp.float64, poc_mode=mode,
                               plant_poc="exact")(
        js, jnp.asarray(x0), jnp.asarray(refs))
    rt = TK.make_tracking_loop(
        _small_preset(cfg).ocp, 5, dtype=torch.float64, poc_mode=mode,
        plant_poc="exact")(
        spec_from_numpy(_np(js), dtype=torch.float64, device=DEV), x0,
        refs)
    xs_j = np.asarray(rj.xs)
    assert rt.xs.shape == xs_j.shape == (6, 17)
    _states_close(rt.xs.numpy(), xs_j)
    np.testing.assert_allclose(rt.us.numpy(), np.asarray(rj.us),
                               rtol=CONTROL_RTOL, atol=1e-9)
    # the plant reports the exact impact point: truth equals belief
    from mpc_blaster_tpu_torch.poc.solver import true_poc_traj
    np.testing.assert_allclose(true_poc_traj(rt.xs).numpy(),
                               rt.xs[:, 14:17].numpy(), rtol=0, atol=1e-12)


def test_run_blast_scan_auto_matches_jax_f64():
    """`poc_mode="auto"` and `carry_frac="auto"` on the aggressive scan:
    both rules choose (online_stagewise, carry 0.6) on both sides."""
    pre, tpre = _small_preset(jcfg), _small_preset(cfg)
    kw = dict(n_steps=5, poc_mode="auto", carry_frac="auto",
              frozen_at="canonical", **AGGRESSIVE)
    rj = JK.run_blast_scan(pre, dtype=jnp.float64, **kw)
    rt = TK.run_blast_scan(tpre, dtype=torch.float64, device=DEV, **kw)
    np.testing.assert_allclose(rt.refs.numpy(), np.asarray(rj.refs),
                               rtol=0, atol=1e-12)
    _states_close(rt.xs.numpy(), np.asarray(rj.xs))
