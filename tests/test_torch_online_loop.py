"""Port parity of the closed loop's online POC modes
(`sim/closedloop.py`, poc_mode "online" and "online_stagewise", and
`run_preset(poc_mode="online")`) against the JAX package, in float64 on
the "riccati" backend at N=8.

Tolerances and why:
  - `closed_loop`, 5 ticks from a hover 0.5 m below the reference, the
    POC rows re-linearized every tick with a non-default jet
    (`poc_cfg`): every state within 1e-6 (measured: positions 1.7e-11,
    the POC states 5.2e-10, the body rates 4.6e-9, where the
    12-iteration solves amplify rounding into the weakly determined
    rotor split);
  - `run_preset(poc_mode="online")`, 3 ticks of the preset's own
    take-off: the first tick's controls within 1e-9 (measured 1.7e-10),
    every control within 1e-6 N and every state within 1e-6 (measured
    5.5e-10 and 1.5e-11).
"""
import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mpc_blaster_tpu import config as jcfg
from mpc_blaster_tpu.ocp.spec import build_spec as jbuild_spec
from mpc_blaster_tpu.sim.closedloop import closed_loop as jclosed_loop
from mpc_blaster_tpu.sim.closedloop import preset_stage_params as jpsp
from mpc_blaster_tpu.sim.closedloop import run_preset as jrun_preset
from mpc_blaster_tpu_torch import config as cfg
from mpc_blaster_tpu_torch.convert import spec_from_numpy
from mpc_blaster_tpu_torch.sim.closedloop import closed_loop, run_preset

# The port runs on the CUDA card unless asked for the CPU; these tests
# ask for it.
DEV = torch.device("cpu")


def _preset(c, N=8):
    pre = c.simulation_preset()
    return dataclasses.replace(pre, ocp=dataclasses.replace(
        pre.ocp, N=N, Tf=N / 30.0))


@pytest.mark.parametrize("mode", ["online", "online_stagewise"])
def test_closed_loop_online_modes_match_jax_f64(mode):
    jpre, tpre = _preset(jcfg), _preset(cfg)
    js = jbuild_spec(jpre.ocp, yref=np.asarray(jpre.loop.yref),
                     stage_params=np.asarray(jpsp(jpre, jnp.float64)),
                     dtype=jnp.float64)
    ts = spec_from_numpy({k: np.asarray(v) for k, v in js._asdict().items()},
                         dtype=torch.float64, device=DEV)
    x0 = np.zeros(17)
    x0[2] = 3.0
    pc = jcfg.PocSolverConfig(stream_velocity=140.0, drag=1.2)
    rj = jclosed_loop(js, jpre.ocp, jnp.asarray(x0), 5, dtype=jnp.float64,
                      poc_mode=mode, poc_cfg=pc)
    rt = closed_loop(ts, tpre.ocp, x0, 5, dtype=torch.float64,
                     poc_mode=mode, poc_cfg=cfg.PocSolverConfig(
                         stream_velocity=140.0, drag=1.2))
    xs_t, xs_j = rt.xs.numpy(), np.asarray(rj.xs)
    np.testing.assert_allclose(xs_t, xs_j, rtol=0, atol=1e-6)
    # the POC rows moved with the pose: online differs from frozen
    frozen = closed_loop(ts, tpre.ocp, x0, 5, dtype=torch.float64)
    assert np.abs(frozen.xs[:, 14:17].numpy() - xs_t[:, 14:17]).max() > 1e-4


def test_run_preset_online_matches_jax_f64():
    jpre, tpre = _preset(jcfg), _preset(cfg)
    rj = jrun_preset(jpre, n_steps=3, dtype=jnp.float64, poc_mode="online")
    rt = run_preset(tpre, n_steps=3, dtype=torch.float64, poc_mode="online",
                    device=DEV)
    np.testing.assert_allclose(rt.us[0].numpy(), np.asarray(rj.us[0]),
                               rtol=0, atol=1e-9)
    np.testing.assert_allclose(rt.us.numpy(), np.asarray(rj.us), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(rt.xs.numpy(), np.asarray(rj.xs), rtol=0,
                               atol=1e-6)
    frozen = run_preset(tpre, n_steps=3, dtype=torch.float64, with_poc=True,
                        device=DEV)
    assert not torch.equal(frozen.xs, rt.xs)
