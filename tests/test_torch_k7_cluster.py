"""Kernel K7's cluster plan on the CPU: its twin and its launch plan.

A single hard plain problem at N >= 61 takes the cluster plan of
`csrc/box_qp_ipm.cu` (the horizon split over a thread-block cluster, the
linear sweeps chunked affine scans). Its twin follows the same order
(`box_qp_solve_plain(chunks=C)`), and here, at N=8 and 16 in 2 and 4
chunks:

  - against the JAX package's streaming K7 (`pallas_box_qp_solve` with
    `stream_p` / `stream_big`, Pallas in interpret mode): one iteration
    pointwise and the full budget (10 iterations, as
    tests/test_torch_stream.py holds full solves) on the objective and
    kkt_eq, by tests/test_torch_ipm.py's rules
    (`_assert_one_iteration_parity`, `_assert_full_solve_parity`); each
    JAX run is made once for the module;
  - against the sequential twin (`chunks=1`) on the same inputs, at N=8,
    16 and 120 by the same rules: the scans' boundaries round otherwise,
    so the two part as f32 solves moved by rounding do.

And `launch_plan` against the plan before the cluster plan (copied here:
`_parent_plan`) at every horizon up to N=60, every mode, soft or hard,
every batch size chip_smoke.py launches and both models: each keeps its
plan; past N=60 only a single hard plain problem changes plan. The g++
build of the kernel holds the library's own plan to `launch_plan`
(tests/test_torch_kernel_cpu.py).
"""
import functools

import pytest
import torch

from mpc_blaster_tpu.ops.pallas_ipm import pallas_box_qp_solve
from mpc_blaster_tpu_torch.ops import box_qp_ipm as K

from test_torch_ipm import (_assert_full_solve_parity,
                            _assert_one_iteration_parity)
from test_torch_stream import _case
from torch_threads import one_intraop_thread  # noqa: F401

DEV = torch.device("cpu")
FULL = 10
# (N, chunks, the JAX streaming mode it is held to)
CASES = [(8, 2, "stream_p"), (16, 4, "stream_big")]


@functools.cache
def _jax(N: int, mode: str, iters: int):
    """The JAX streaming K7 (interpret mode) on `_case(N, False)`'s QPs."""
    jd = _case(N, False)[0]
    return pallas_box_qp_solve(jd, iters=iters, interpret=True,
                               **{mode: True})


@pytest.mark.parametrize("iters", [1, FULL])
@pytest.mark.parametrize("N,C,mode", CASES)
def test_cluster_twin_matches_jax_streaming(N, C, mode, iters):
    jd, _, td, _ = _case(N, False)
    st = K.box_qp_solve_plain(td, iters=iters, chunks=C)
    sj = _jax(N, mode, iters)
    if iters == 1:
        _assert_one_iteration_parity(sj, st)
    else:
        _assert_full_solve_parity(jd, sj, st)


@pytest.mark.parametrize("N,C,B", [(8, 2, 2), (16, 4, 2), (16, 3, 2),
                                   (120, 8, 1)])
def test_cluster_twin_matches_sequential_twin(N, C, B):
    """The cluster order (C chunks) against the sequential twin: one
    iteration pointwise, 12 iterations on the objective and kkt_eq. N=120
    at B=1, as chip_smoke.py's n120_b1 row (and as
    tests/test_torch_stream.py keeps its long horizons to B=1)."""
    jd, _, td, _ = _case(N, False, B)
    for iters in (1, 12):
        seq = K.box_qp_solve_plain(td, iters=iters, chunks=1)
        cl = K.box_qp_solve_plain(td, iters=iters, chunks=C)
        if iters == 1:
            _assert_one_iteration_parity(seq, cl)
        else:
            _assert_full_solve_parity(jd, seq, cl)


def test_twin_takes_the_kernels_plan():
    """`chunks=None` follows the kernel's plan: the cluster order where
    `cluster_plan` (a single hard plain problem at N >= 61), else the
    sequential one; explicit chunks of a soft solve are refused."""
    for N, B in ((120, 1), (120, 2), (60, 1)):
        _, _, td, _ = _case(N, False, B)
        want = K.launch_plan(N, K.PLAIN, False, 17, 6, B).cluster or 1
        a = K.box_qp_solve_plain(td, iters=1)
        b = K.box_qp_solve_plain(td, iters=1, chunks=want)
        assert all(torch.equal(getattr(a, f), getattr(b, f))
                   for f in ("dx", "du", "mu", "s_lx", "lam_uu"))
    _, js, td, ts = _case(8, True)
    with pytest.raises(ValueError, match="chunks"):
        K.box_qp_solve_plain(td, iters=1, soft=ts, chunks=2)


def _parent_plan(N, mode, soft, nx, nu, B):
    """`launch_plan` before the cluster plan: (threads, shared bytes,
    resident, prologue blocks)."""
    scratch = 2 * nx * nx + 2 * nx * nu + 3 * nu * nu + 8 + 2 * 4
    ring = 4 * (nx * nx + nx * nu + 3 * (nx + nu))
    stacks = (N + 1) * nx * nx + N * nu * nx + N * nu * nu
    window = 2 * nx * nx + nu * nx + nu * nu
    resident = 4 * (scratch + ring + stacks) <= 232448
    words = scratch + ring + (stacks if resident else window)
    E = 2 * N * (nx + nu)
    area = 10 * E + (E + 3) // 4
    if soft and 4 * (words + area) <= 232448:
        words += area
    single = B == 1 and mode != K.FUSE_COST
    items = N * -(-(nx + nu) // 2)
    prologue = -(-items // 128) if single and mode == K.FUSE_LIN else 0
    return (256 if single else 128, 4 * words, resident, prologue)


# every batch size chip_smoke.py launches (phases 2-25), and 2
BATCHES = (1, 2, 3, 4, 8, 16, 64, 256, 1024)


@pytest.mark.parametrize("nx,nu", [(17, 6), (13, 4)])
def test_launch_plan_keeps_the_parent_plan_up_to_n60(nx, nu):
    for N in range(1, 61):
        for mode in (K.PLAIN, K.FUSE_COST, K.FUSE_LIN):
            for soft in (False, True):
                for B in BATCHES:
                    plan = K.launch_plan(N, mode, soft, nx, nu, B)
                    assert plan.cluster == 0, (N, mode, soft, B)
                    assert tuple(plan[:4]) == _parent_plan(
                        N, mode, soft, nx, nu, B), (N, mode, soft, B)


def test_only_a_single_hard_plain_problem_changes_plan_past_n60():
    for N in (61, 62, 120, 128, 129, 240):
        for mode in (K.PLAIN, K.FUSE_COST, K.FUSE_LIN):
            for soft in (False, True):
                for B in BATCHES:
                    plan = K.launch_plan(N, mode, soft, 17, 6, B)
                    cl = mode == K.PLAIN and not soft and B == 1
                    assert plan.cluster == (8 if cl else 0)
                    if not cl:
                        assert tuple(plan[:4]) == _parent_plan(
                            N, mode, soft, 17, 6, B), (N, mode, soft, B)
