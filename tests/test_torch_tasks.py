"""Port parity of `sim/tasks.py` against the JAX package: the figure-8
references, the frozen-POC tracking loop cold and warm, `run_figure8`
(and, marked slow, its 120 ticks against tests/golden/figure8_120.npz),
`run_blasting`, a tick of each of the blast scan's POC modes (its
refusals of unknown modes), and the number chip_smoke.py's fig8_rt6f
phase is held to.

Tolerances and why:
  - `figure8_refs`: exact (the same numpy formulas);
  - `make_tracking_loop` on "riccati" in float64, N=8, 10 ticks, cold and
    warm: positions within 1e-4 m (the closed loops agree to ~1e-4 m across
    implementations, tests/test_torch_golden.py);
  - `run_figure8` in float32 (the simulation preset, "riccati", N=60), 15
    ticks: positions within 1e-4 m (the loop starts on the reference, so
    every tick's QP converges and the two float32 loops stay together);
  - 120 ticks against the float64 golden: 5e-2 m (tests/test_golden.py:43);
  - `run_blasting` in float64, 3 ticks of the N=60 loop: states within
    1e-4.
"""
import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mpc_blaster_tpu import config as jcfg
from mpc_blaster_tpu.ocp.spec import build_spec as jbuild_spec
from mpc_blaster_tpu.sim import tasks as JK
from mpc_blaster_tpu_torch import config as cfg
from mpc_blaster_tpu_torch.convert import (spec_from_numpy,
                                           tracking_from_numpy,
                                           tracking_to_numpy)
from mpc_blaster_tpu_torch.ocp.spec import build_spec
from mpc_blaster_tpu_torch.sim import tasks as TK
from torch_threads import one_intraop_thread  # noqa: F401


# The port runs on the CUDA card unless asked for the CPU; these tests
# ask for it.
DEV = torch.device("cpu")

GOLDEN = "tests/golden/figure8_120.npz"


def _np(x):
    return {k: np.asarray(v) for k, v in x._asdict().items()}


def test_figure8_refs_match_jax():
    for kw in ({}, dict(amplitude_x=0.6, amplitude_y=0.3, period_s=8.0,
                        z=1.5)):
        np.testing.assert_array_equal(TK.figure8_refs(50, 1 / 30.0, **kw),
                                      JK.figure8_refs(50, 1 / 30.0, **kw))


@pytest.mark.parametrize("warm", [False, True])
def test_tracking_loop_riccati_matches_jax_f64(warm):
    pre, tpre = jcfg.simulation_preset(), cfg.simulation_preset()
    ocp = dataclasses.replace(pre.ocp, N=8, Tf=8 / 30.0)
    tocp = dataclasses.replace(tpre.ocp, N=8, Tf=8 / 30.0)
    refs = JK.figure8_refs(10 + 8 + 1, ocp.dt)
    js = jbuild_spec(ocp, dtype=jnp.float64)
    x0 = np.zeros(17)
    x0[0:3], x0[6:9] = refs[0, 0:3], refs[0, 6:9]
    rj = JK.make_tracking_loop(ocp, 10, dtype=jnp.float64, warm_start=warm)(
        js, jnp.asarray(x0), jnp.asarray(refs))
    rt = TK.make_tracking_loop(tocp, 10, dtype=torch.float64,
                               warm_start=warm)(
        spec_from_numpy(_np(js), dtype=torch.float64, device=DEV), x0, refs)
    assert rt.xs.shape == (11, 17) and rt.refs.shape == (10, 17)
    np.testing.assert_allclose(rt.xs[:, 0:3].numpy(),
                               np.asarray(rj.xs)[:, 0:3], rtol=0, atol=1e-4)
    np.testing.assert_array_equal(rt.refs.numpy(), np.asarray(rj.refs))
    back = tracking_from_numpy(tracking_to_numpy(rt), dtype=torch.float64,
                               device=DEV)
    for f in rt._fields:
        assert torch.equal(getattr(back, f), getattr(rt, f)), f


def test_run_figure8_f32_matches_jax():
    rj = JK.run_figure8(n_steps=15, dtype=jnp.float32)
    rt = TK.run_figure8(n_steps=15, dtype=torch.float32, device=DEV)
    assert rt.xs.dtype == torch.float32 and rt.xs.shape == (16, 17)
    np.testing.assert_allclose(rt.xs[:, 0:3].numpy(),
                               np.asarray(rj.xs)[:, 0:3], rtol=0, atol=1e-4)
    assert (rt.kkt_eq < 1e-3).all()


@pytest.mark.slow
def test_run_figure8_golden_f32():
    g = np.load(GOLDEN)
    rt = TK.run_figure8(n_steps=120, dtype=torch.float32, device=DEV)
    assert np.abs(rt.xs[:, 0:3].numpy() - g["xs"][:, 0:3]).max() < 5e-2


def test_run_blasting_matches_jax_f64():
    (rj, sj) = JK.run_blasting(n_steps=3, dtype=jnp.float64)
    (rt, st) = TK.run_blasting(n_steps=3, dtype=torch.float64, device=DEV)
    np.testing.assert_allclose(rt.xs.numpy(), np.asarray(rj.xs), rtol=0,
                               atol=1e-4)
    for a, b in zip(st.get_jacobians(), sj.get_jacobians()):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-9)


def test_blast_scan_slice_refused():
    """The blast scan's slice is ported: its online POC modes and the
    exact plant POC run (a tick each at N=8 on "riccati"; tests/
    test_torch_blast.py holds them against the JAX package), its helpers
    answer, and only unknown modes are refused."""
    pre = cfg.simulation_preset()
    ocp = dataclasses.replace(pre.ocp, N=8, Tf=8 / 30.0)
    spec = build_spec(ocp, dtype=torch.float64, device=DEV)
    refs = TK.blast_scan_refs(1 + 8 + 1, ocp.dt)
    x0 = np.zeros(17)
    x0[2] = 3.5
    for mode in ("online", "online_stagewise", "stagewise_anchored"):
        res = TK.make_tracking_loop(ocp, 1, dtype=torch.float64,
                                    poc_mode=mode, plant_poc="exact")(
            spec, x0, refs)
        assert torch.isfinite(res.xs).all(), mode
        assert abs(float(res.xs[1, 16])) < 1e-9   # the POC on the ground
    assert TK.select_poc_mode() == "frozen"
    assert TK.select_carry_frac() == 0.0
    res = TK.run_blast_scan(dataclasses.replace(pre, ocp=ocp), n_steps=1,
                            dtype=torch.float64, device=DEV)
    assert res.xs.shape == (2, 17) and torch.isfinite(res.xs).all()
    with pytest.raises(ValueError, match="poc_mode"):
        TK.make_tracking_loop(ocp, 2, poc_mode="live")
    with pytest.raises(ValueError, match="plant_poc"):
        TK.make_tracking_loop(ocp, 2, plant_poc="measured")


def jax_fig8_rt6_err() -> float:
    """The JAX package's own float32 run of chip_smoke.py's fig8_rt6f loop
    on the CPU (bench.py's fig8 rows: the simulation preset at N=20, Tf
    2/3 s, 220 ticks, the fused linearizer) on its Riccati IPM at 6
    iterations: the max xy error after tick 60."""
    pre = jcfg.simulation_preset()
    ocp = dataclasses.replace(pre.ocp, N=20, Tf=20 / 30.0)
    sv = dataclasses.replace(ocp.solver, ipm_iters=6, qp_backend="riccati",
                             lin_backend="fused")
    fig = JK.run_figure8(dataclasses.replace(
        pre, ocp=dataclasses.replace(ocp, solver=sv)), n_steps=220,
        dtype=jnp.float32)
    err = np.linalg.norm(np.asarray(fig.xs)[1:, 0:2]
                         - np.asarray(fig.refs)[:, 0:2], axis=1)
    return float(err[60:].max())


def test_chip_smoke_fig8_bound_is_jax_run():
    import chip_smoke
    assert round(jax_fig8_rt6_err(), 4) == chip_smoke.FIG8_JAX["settle_err_m"]
