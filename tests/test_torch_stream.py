"""The long horizons (kernel K7): the Pallas kernel's `stream_p` /
`stream_big` variants stream P, the A/B record and the Z gains through HBM
once an instance outgrows the TPU's resident budget. The port's kernel
picks its plan from N and the batch size alone: the factor stacks
resident in shared memory up to N=128 and in global memory past it, and
a single hard plain problem from N=61 on a thread-block cluster (the
cluster plan; its twin and plan: tests/test_torch_k7_cluster.py).
`box_qp_solve(stream_p=, stream_big=)` accept the Pallas wrapper's
switches and select nothing. Held here: the port's plain twin against
the JAX streaming modes (Pallas in interpret mode) at N=8 (chunk 4) and
N=7 (chunk 1), hard and soft; the N=120 twin (B=1: the cluster plan's
order) against the JAX Riccati IPM; the positions chip_smoke.py's phase
15 is held to.

Tolerances (tests/test_torch_ipm.py, tests/test_torch_soft.py): one IPM
iteration pointwise at the cold tolerances (u0 atol 2e-3, dx/du atol 5e-3,
slacks/duals rtol 1e-3); the full budget on the QP objective (1.2e-2
relative, soft: the penalized objective within 2e-3 relative + 1e-3) and
kkt_eq (rtol 0.2 / atol 1e-3). Each Pallas interpret call takes 8-14 s
here, so the fast cases cover stream_p at N=8 hard and stream_big at N=7
soft after one iteration; the rest of the matrix and N=120 / 240 are
marked slow.
"""
import dataclasses
import functools
import inspect

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mpc_blaster_tpu import config as jcfg
from mpc_blaster_tpu.ops.pallas_ipm import pallas_box_qp_solve
from mpc_blaster_tpu.qp import soft as jsoft
from mpc_blaster_tpu.qp.data import QPData as JQPData
from mpc_blaster_tpu_torch import config as cfg
from mpc_blaster_tpu_torch import convert
from mpc_blaster_tpu_torch.convert import qp_to_numpy
from mpc_blaster_tpu_torch.ops import box_qp_ipm as K

from test_torch_cuda import _blaster_qps as _port_blaster_qps
from test_torch_ipm import (_assert_full_solve_parity,
                            _assert_one_iteration_parity)
from torch_threads import one_intraop_thread  # noqa: F401

# The port runs on the CUDA card unless asked for the CPU; these tests
# ask for it.
DEV = torch.device("cpu")


@functools.cache
def _case(N, soft, B=2):
    """(JAX QPs, JAX SoftBounds or None, port QPs, port SoftBounds or None)
    at N, B: tests/test_torch_ipm.py's construction, built by the port
    (the JAX build dispatches op by op for seconds) and copied to JAX; the
    soft case pushes dx0 2.2 past the x box with soft position bounds
    (tests/test_pallas_ipm.py:303-329). Built once per (N, soft, B)."""
    td = _port_blaster_qps(torch.device("cpu"), B=B, N=N)
    if soft:
        dx0 = td.dx0.clone()
        dx0[:, 0] += 2.2
        td = td._replace(dx0=dx0)
    jd = JQPData(**{k: jnp.asarray(v) for k, v in qp_to_numpy(td).items()})
    if not soft:
        return jd, None, td, None
    js = jsoft.SoftBounds.state_bounds(N, 17, 6, Zl=1e3, zl=1e2,
                                       idx=np.asarray((0, 1, 2)),
                                       dtype=jnp.float32)
    ts = convert.soft_from_numpy(
        {g: {k: np.asarray(v) for k, v in p._asdict().items()}
         for g, p in js._asdict().items()}, device=DEV)
    return jd, js, td, ts


def _check(jd, js, sj, st, iters):
    if iters == 1:
        _assert_one_iteration_parity(sj, st)
        return
    if js is None:
        _assert_full_solve_parity(jd, sj, st)
        return
    for i in range(jd.A.shape[0]):
        d1 = jax.tree.map(lambda a, i=i: a[i], jd)
        oj = float(jsoft.soft_qp_objective(d1, js, sj.dx[i], sj.du[i]))
        ot = float(jsoft.soft_qp_objective(d1, js, jnp.asarray(st.dx[i]),
                                           jnp.asarray(st.du[i])))
        assert abs(ot - oj) <= 2e-3 * abs(oj) + 1e-3, (i, ot, oj)


@pytest.mark.parametrize("mode, N, soft", [("stream_p", 8, False),
                                           ("stream_big", 7, True)])
def test_stream_twin_matches_jax_streaming(mode, N, soft):
    jd, js, td, ts = _case(N, soft)
    sj = pallas_box_qp_solve(jd, iters=1, interpret=True, soft=js,
                             **{mode: True})
    st = K.box_qp_solve_plain(td, iters=1, soft=ts, **{mode: True})
    _check(jd, js, sj, st, 1)


@pytest.mark.slow
def test_stream_twin_matches_jax_streaming_all_modes():
    """The whole matrix: both streaming modes, N=8 and N=7, hard and
    soft, after one iteration and the full budget (10, as
    tests/test_torch_ipm.py and tests/test_torch_soft.py hold full solves:
    from outside the box the soft f32 solves are chaotic at 6, measured
    2.8e-3 relative apart). Fast siblings:
    test_stream_twin_matches_jax_streaming."""
    for N in (8, 7):
        for soft in (False, True):
            jd, js, td, ts = _case(N, soft)
            for mode in ("stream_p", "stream_big"):
                for iters in (1, 10):
                    sj = pallas_box_qp_solve(jd, iters=iters, interpret=True,
                                             soft=js, **{mode: True})
                    st = K.box_qp_solve_plain(td, iters=iters, soft=ts,
                                              **{mode: True})
                    _check(jd, js, sj, st, iters)


def test_stream_settings_are_one_layout():
    """`box_qp_solve` and its twin take the Pallas wrapper's switches
    (bool or None; anything else is refused) and select nothing with
    them; the one-launch tick takes no streaming switch (the JAX tick
    hard-codes the resident layout); the solver config keeps the two
    fields, which the ticks do not pass on."""
    _, _, td, _ = _case(8, False)
    for fn in (K.box_qp_solve, K.box_qp_solve_plain):
        assert {"stream_p", "stream_big"} <= set(
            inspect.signature(fn).parameters)
    with pytest.raises(TypeError, match="stream_p"):
        K.box_qp_solve(td, iters=1, stream_p="yes")
    with pytest.raises(TypeError, match="stream_big"):
        K.box_qp_solve_plain(td, iters=1, stream_big=1)
    for fn in (K.fused_rti_solve, K.fused_rti_solve_plain,
               K.batched_fused_tick):
        assert "stream_p" not in inspect.signature(fn).parameters
    assert dataclasses.asdict(cfg.SolverConfig())["pallas_stream_big"] is None


def test_long_horizon_twin_matches_riccati_ipm():
    """N=120 (Tf 4 s), B=1, 12 iterations: the twin against the JAX
    package's Riccati IPM (`qp/ipm.py::box_qp_solve`) on the QP objective
    and kkt_eq. B=1: at B=2 the twin's stage tensors pass PyTorch's
    intra-op grain size, and under several test workers its threads
    oversubscribe the cores (measured 3 s alone, 400 s beside five other
    workers)."""
    from mpc_blaster_tpu.qp.ipm import box_qp_solve as jbox
    jd, _, td, _ = _case(120, False, B=1)
    sj = jax.jit(jax.vmap(lambda d: jbox(d, iters=12, reg=1e-6)))(jd)
    st = K.box_qp_solve_plain(td, iters=12)
    _assert_full_solve_parity(jd, sj, st)


@pytest.mark.slow
def test_long_horizon_twin_matches_jax_streaming():
    """N=120 and N=240, B=1, 12 iterations: the twin against both JAX
    streaming modes (interpret) on the objective and kkt_eq."""
    for N in (120, 240):
        jd, _, td, _ = _case(N, False, B=1)
        st = K.box_qp_solve_plain(td, iters=12)
        for mode in ("stream_p", "stream_big"):
            sj = pallas_box_qp_solve(jd, iters=12, interpret=True,
                                     **{mode: True})
            _assert_full_solve_parity(jd, sj, st)


def jax_long_horizon_positions(N: int) -> np.ndarray:
    """The JAX package's own float32 run of chip_smoke.py's phase 15 on
    the CPU: the simulation preset at N (Tf = N / 30 s) on its Riccati IPM
    at 12 iterations, 20 ticks from the ground with the POC Jacobians
    solved (`run_preset(with_poc=True)`); positions every fifth tick."""
    from mpc_blaster_tpu.sim.closedloop import run_preset
    pre = jcfg.simulation_preset()
    ocp = dataclasses.replace(pre.ocp, N=N, Tf=N / 30.0, solver=(
        dataclasses.replace(pre.ocp.solver, qp_backend="riccati",
                            ipm_iters=12)))
    res = run_preset(dataclasses.replace(pre, ocp=ocp), n_steps=20,
                     dtype=jnp.float32, with_poc=True,
                     stage_params=_jax_poc_stage_params())
    return np.asarray(res.xs)[::5, 0:3]


@functools.cache
def _jax_poc_stage_params():
    """The preset's POC Jacobians as the JAX package's `run_preset(
    with_poc=True)` solves them (they do not depend on N), solved once
    for the module."""
    from mpc_blaster_tpu.sim.closedloop import preset_stage_params
    return preset_stage_params(jcfg.simulation_preset(), jnp.float32)


@pytest.mark.parametrize("N", [120, 240])
def test_chip_smoke_long_horizon_positions_are_jax_run(N):
    import chip_smoke
    np.testing.assert_allclose(chip_smoke.LONG_JAX[N],
                               jax_long_horizon_positions(N), rtol=0,
                               atol=1e-6)
