"""The launch plan of the box-QP IPM kernel (`ops/box_qp_ipm.py::
launch_plan`) against a count by hand: threads per problem (128 in the
batch plan; 256 in the single plan, B=1 in the plain and fuse_lin modes,
whose fuse_lin launch also runs its prologue as a grid of its own),
dynamic shared bytes, and whether the Riccati factor stacks are resident
in shared memory (the "resident" layout) or stay in the global workspace
("global").

Shared memory per block, in float32 words: the per-stage scratch (P'A and
A'PA, nx^2 each; P'B and Hux, nx nu each; Huu and the Cholesky inverse's
two factors, nu^2 each; eight words for the block sums; two flags
per ring slot), the four-slot ring of stages (A_k, B_k and 3 (nx + nu)
words of vectors: 4 (nx^2 + nx nu + 3 (nx + nu))), then the stacks
P_0..P_N, Z_0..Z_{N-1},
Hinv_0..Hinv_{N-1} ((N+1) nx^2 + N nu nx + N nu^2) where everything fits
in the card's 232448-byte opt-in, else the factorization's window (two P
slots, one Z, one Hinv). A soft launch then adds its soft area where that
still fits: for each of the 2 N (nx + nu) bound entries ten words (t, gam,
Z, z, sig_s, the pair's denominator, four words handed between row
passes) and a class byte, the bytes rounded up to whole words. A single
hard plain problem at N >= 61 takes the cluster plan instead: min(8, N //
4) CTAs of 256 threads, each with the scratch, the ring, the stacks of
the largest chunk (ceil(N / C) stages) and its cluster area (eight nx^2
matrices, two nx nu blocks, three 32-word boundary slots, two 4-word
reduction slots).
Pure arithmetic: no JAX, no card.
"""
import re

import pytest

from mpc_blaster_tpu_torch.ops import box_qp_ipm as K
from torch_threads import one_intraop_thread  # noqa: F401

OPTIN = 232448   # cudaDevAttrMaxSharedMemoryPerBlockOptin on the H100
# the per-stage scratch and the ring, in bytes: 17x6 (906 + 1840 words),
# 13x4 (506 + 1088 words)
BASE = {(17, 6): 4 * (2 * 289 + 2 * 102 + 3 * 36 + 8 + 8
                      + 4 * (289 + 102 + 3 * 23)),
        (13, 4): 4 * (2 * 169 + 2 * 52 + 3 * 16 + 8 + 8
                      + 4 * (169 + 52 + 3 * 17))}
# the factor stacks in bytes (P with P_N, Z, Hinv)
STACKS = {(17, 6, 20): 35316, (17, 6, 30): 52396, (17, 6, 60): 103636,
          (17, 6, 120): 206116, (17, 6, 240): 411076, (13, 4, 20): 19636}
WINDOW = {(17, 6): 4 * (2 * 289 + 102 + 36), (13, 4): 4 * (2 * 169 + 52 + 16)}
# the 17x6 soft area in bytes where it is in shared memory: N=20 has 920
# entries, N=60 2760; at N=240 it stays in the workspace
SOFT_AREA = {20: 4 * (10 * 920 + 230), 60: 4 * (10 * 2760 + 690), 240: 0}
CASES = [(17, 6, 20, True), (17, 6, 30, True), (17, 6, 60, True),
         (17, 6, 120, True), (17, 6, 240, False), (13, 4, 20, True)]


@pytest.mark.parametrize("nx,nu,N,resident", CASES)
def test_plan_matches_hand_count(nx, nu, N, resident):
    plan = K.launch_plan(N, K.PLAIN, False, nx, nu, 2)
    stacks = STACKS[(nx, nu, N)]
    assert stacks == 4 * ((N + 1) * nx * nx + N * nu * nx + N * nu * nu)
    want = BASE[(nx, nu)] + (stacks if resident else WINDOW[(nx, nu)])
    assert plan == (128, want, resident, 0, 0)
    assert plan.layout == ("resident" if resident else "global")
    assert plan.key == (plan.layout, "batch")
    # a single problem: the single plan, the same shared memory (a soft
    # one here: a single hard plain problem at N >= 61 takes the cluster
    # plan, test_cluster_plan_matches_hand_count)
    single = K.launch_plan(N, K.PLAIN, N >= 61, nx, nu, 1)
    if N >= 61:
        want = K.launch_plan(N, K.PLAIN, True, nx, nu, 2).smem_bytes
    assert single == (256, want, resident, 0, 0)
    assert single.key == (plan.layout, "single")
    # resident exactly where the stacks fit beside the scratch and ring
    assert resident == (BASE[(nx, nu)] + stacks <= OPTIN)
    assert plan.smem_bytes <= OPTIN


@pytest.mark.parametrize("mode,soft", [(K.PLAIN, True), (K.FUSE_COST, False),
                                       (K.FUSE_LIN, False), (K.FUSE_LIN, True)])
def test_plan_is_the_same_for_every_mode(mode, soft):
    """The stacks, scratch and ring do not depend on the mode or on soft
    bounds; a soft launch adds its soft area (SOFT_AREA) after them."""
    for N in (20, 60, 240):
        hard = K.launch_plan(N, K.PLAIN, False, 17, 6, 2)
        plan = K.launch_plan(N, mode, soft, 17, 6, 2)
        if soft:
            assert plan == hard._replace(smem_bytes=hard.smem_bytes
                                         + SOFT_AREA[N])
            assert SOFT_AREA[N] in (0, 4 * K.soft_area_floats(N, 17, 6))
        else:
            assert plan == hard


def test_soft_area_in_shared_memory_up_to_n61():
    """17x6: the soft area joins the resident stacks up to N=61 (the soft
    closed loop's N=60 included); from N=62 (N=120 among the main path's
    horizons) it stays in the workspace and the soft plan is the hard
    one. Per entry 10 words and a byte: 46 N entries, about 1886 N bytes
    on top of the hard plan's 12140 + 1708 N."""
    extra = {N: K.launch_plan(N, K.PLAIN, True, 17, 6, 1).smem_bytes
             - K.launch_plan(N, K.PLAIN, False, 17, 6, 2).smem_bytes
             for N in range(1, 130)}
    assert max(N for N, b in extra.items() if b) == 61
    assert all(extra[N] == 4 * (460 * N + (46 * N + 3) // 4)
               for N in range(1, 62))
    assert all(extra[N] == 0 for N in range(62, 130))
    assert BASE[(17, 6)] + STACKS[(17, 6, 60)] + SOFT_AREA[60] <= OPTIN
    assert K.launch_plan(120, K.PLAIN, True, 17, 6, 2) \
        == K.launch_plan(120, K.PLAIN, False, 17, 6, 2)


def test_longest_resident_horizon():
    """17x6 is resident up to N=128 (the last horizon whose stacks fit),
    global past it (a batch; a single hard plain problem from N=61 takes
    the cluster plan)."""
    last = max(N for N in range(1, 400)
               if K.launch_plan(N, K.PLAIN, False, 17, 6, 2).resident)
    assert last == 128
    assert BASE[(17, 6)] + 4 * ((last + 1) * 289 + last * 138) <= OPTIN
    assert BASE[(17, 6)] + 4 * ((last + 2) * 289 + (last + 1) * 138) > OPTIN


def test_wrapper_refuses_a_plan_above_the_optin():
    plan = K.launch_plan(60, K.PLAIN, False, 17, 6, 1)
    assert K._require_plan(plan) is plan
    at = plan._replace(smem_bytes=OPTIN)
    assert K._require_plan(at) is at
    with pytest.raises(RuntimeError, match="opt-in"):
        K._require_plan(plan._replace(smem_bytes=OPTIN + 4))


@pytest.mark.parametrize("N,nx,nu,mode,B", [(0, 17, 6, K.PLAIN, 1),
                                            (20, 12, 6, K.PLAIN, 1),
                                            (20, 17, 6, 7, 1),
                                            (20, 17, 6, K.PLAIN, 0)])
def test_plan_refuses_what_is_not_built(N, nx, nu, mode, B):
    with pytest.raises(ValueError):
        K.launch_plan(N, mode, False, nx, nu, B)


def test_source_constants_match_the_wrapper():
    """The kernel source's block sizes (the two plans, the prologue grid),
    tangent columns per prologue item, opt-in, soft-area words per entry
    and the prologue-only iteration count are the wrapper's."""
    src = K.SOURCE.read_text()

    def const(name):
        return int(re.search(rf"constexpr (?:int|long long) {name} = "
                             rf"(-?\d+);", src)[1])
    assert const("PROLOGUE_ONLY") == K.PROLOGUE_ONLY == -1
    assert const("SOFT_WORDS") == K.SOFT_WORDS == 10
    assert const("BATCH_THREADS") == K.BATCH_THREADS == 128
    assert const("SINGLE_THREADS") == K.SINGLE_THREADS == 256
    assert const("LIN_THREADS") == K.LIN_THREADS == 128
    assert const("LIN_COLS") == K.LIN_COLS == 2
    assert const("SMEM_OPTIN") == K.SMEM_OPTIN == OPTIN
    assert const("CLUSTER_MIN_N") == K.CLUSTER_MIN_N == 61
    assert const("CLUSTER_CTAS") == K.CLUSTER_CTAS == 8
    assert const("CLUSTER_CHUNK_MIN") == K.CLUSTER_CHUNK_MIN == 4
    assert (const("CL_VEC"), const("CL_RED")) == (K.CL_VEC, K.CL_RED)
    assert ("__launch_bounds__(THREADS, THREADS == BATCH_THREADS ? 2 : 1)"
            in src)


def test_wrappers_count_launches_per_layout(monkeypatch):
    """Each launch counts once on its wrapper, under (layout, plan) in
    `by_layout`; a single-plan fuse_lin launch also counts its prologue
    grid in `fused_lin_prologue.launches`, and no other launch does."""
    for w in (K.box_qp_solve, K.batched_fused_tick, K.fused_rti_solve):
        assert isinstance(w.by_layout, dict)
    monkeypatch.setattr(K.fused_lin_prologue, "launches", 0)
    plan = K.launch_plan(240, K.PLAIN, False, 17, 6, 2)

    def fn():
        pass
    fn.launches, fn.warm_launches, fn.by_instance, fn.by_layout = 0, 0, {}, {}
    K._count(fn, None, "17x6", plan)
    K._count(fn, object(), "17x6", K.launch_plan(20, K.PLAIN, False, 17, 6,
                                                 2))
    K._count(fn, object(), "17x6", K.launch_plan(20, K.PLAIN, False, 17, 6,
                                                 1))
    assert fn.by_layout == {("global", "batch"): 1, ("resident", "batch"): 1,
                            ("resident", "single"): 1}
    assert (fn.launches, fn.warm_launches, fn.by_instance) == (3, 2,
                                                               {"17x6": 3})
    assert K.fused_lin_prologue.launches == 0
    for B in (1, 2, 1):
        K._count(fn, None, "17x6 blaster",
                 K.launch_plan(60, K.FUSE_LIN, False, 17, 6, B))
    assert fn.by_layout[("resident", "single")] == 3
    assert K.fused_lin_prologue.launches == 2


@pytest.mark.parametrize("mode,prologue", [
    (K.PLAIN, {}), (K.FUSE_COST, {}),
    # N ceil(23 / 2) items, 128 a block: 96 at N=8, 720 at N=60
    (K.FUSE_LIN, {8: 1, 20: 2, 30: 3, 60: 6, 120: 12, 240: 23})])
def test_plan_is_picked_from_the_batch_size(mode, prologue):
    """B=1 takes the single plan (256 threads) in the plain and fuse_lin
    modes, fuse_lin with its prologue as a grid of its own (blocks of 128
    items); fuse_cost and every batch (B >= 2) keep the batch plan (128
    threads, the prologue on the solve's block). The shared memory and
    the layout depend on N alone."""
    for N in (8, 20, 30, 60, 120, 240):
        for soft in (False, True):
            one = K.launch_plan(N, mode, soft, 17, 6, 1)
            cl = mode == K.PLAIN and not soft and N >= 61
            assert one.cluster == (8 if cl else 0)
            for B in (2, 16, 1024):
                many = K.launch_plan(N, mode, soft, 17, 6, B)
                if not cl:
                    assert many == (128, one.smem_bytes, one.resident, 0, 0)
                assert many.key == (many.layout, "batch")
                assert not many.single and not many.cluster
            single = mode != K.FUSE_COST
            assert one.threads == (256 if single else 128)
            assert one.single == single == K.single_plan(mode, 1)
            assert one.prologue_blocks == prologue.get(N, 0)
            assert one.key == (one.layout, "single" if single else "batch")


@pytest.mark.parametrize("nx,nu,N,C,n", [(17, 6, 61, 8, 8), (17, 6, 120, 8, 15),
                                         (17, 6, 240, 8, 30),
                                         (13, 4, 240, 8, 30)])
def test_cluster_plan_matches_hand_count(nx, nu, N, C, n):
    """A single hard plain problem from N=61: C CTAs of 256 threads, each
    with the scratch and the ring, the stacks of n = ceil(N / C) stages
    and its cluster area; resident, no prologue grid, the "cluster"
    layout. Every other launch at that N keeps its plan."""
    plan = K.launch_plan(N, K.PLAIN, False, nx, nu, 1)
    chunk = 4 * ((n + 1) * nx * nx + n * nu * nx + n * nu * nu)
    area = 4 * (8 * nx * nx + 2 * nx * nu + 3 * 32 + 2 * 4)
    assert plan == (256, BASE[(nx, nu)] + chunk + area, True, 0, C)
    assert plan.layout == "cluster" and plan.key == ("cluster", "single")
    assert K.cluster_ctas(N) == C and -(-N // C) == n
    assert plan.smem_bytes <= OPTIN
    if (nx, N) == (17, 240):      # the issue's ~52 KB of stacks per CTA
        assert chunk == 52396
    for mode, soft, B in ((K.PLAIN, True, 1), (K.PLAIN, False, 2),
                          (K.FUSE_LIN, False, 1), (K.FUSE_COST, False, 1)):
        assert K.launch_plan(N, mode, soft, nx, nu, B).cluster == 0


@pytest.mark.parametrize("N", [8, 16, 60, 61, 120, 240, 1000])
def test_chunks_cover_the_horizon(N):
    """`chunk_starts` cuts N stages into cluster_ctas(N) chunks in stage
    order, of ceil(N / C) stages at most and CLUSTER_CHUNK_MIN at least."""
    C = K.cluster_ctas(N)
    ks = K.chunk_starts(N, C)
    assert ks[0] == 0 and ks[-1] == N and len(ks) == C + 1
    sizes = [b - a for a, b in zip(ks, ks[1:])]
    assert max(sizes) == -(-N // C) and min(sizes) >= K.CLUSTER_CHUNK_MIN
