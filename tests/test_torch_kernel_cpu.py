"""The box-QP IPM kernel's CUDA source itself, run on the CPU: built with
g++ against a stand-in of the CUDA runtime (`tests/cuda_cpu/cuda_runtime.h`:
one std::thread per CUDA thread, std::barrier for __syncthreads, a barrier
per warp for __syncwarp and the shuffles, the launch as a loop over
blocks, NaN-filled dynamic shared memory) and called through the port's
own launch code (`ops/box_qp_ipm.py::_solve_kernel` and
`_fused_lin_kernel`) on CPU tensors, each launch on one CPU, against the
plain twins.

Only the instantiations held here are built (`-DBOX_QP_IPM_CPU_SUBSET`):
PLAIN hard and soft and FUSE_LIN `blaster` hard and soft (kernel K4 and
the hard solve it must reproduce; the warm start, kernel K3), each in both
launch plans. The soft cases are `chip_smoke.py::soft_runners`' out-of-box
QPs at N=8: the initial state pushed 2.2 past the x box, soft position
bounds (Zl=1e3, zl=1e2) or every state soft (the soft closed loop's rows).
The warm cases (K3) are single problems at N=8 (a hover QP, and a
perturbed hover iterate of the fused tick) warm-started from the twin's
slacks and duals after two iterations, so a B=1 launch takes the single
plan (256 threads; fuse_lin with its prologue as a grid of its own) and
the same problem twice, B=2, the batch plan (128 threads, the prologue on
the solve's block).

Tolerances, as tests/test_torch_soft.py holds the twin against the Pallas
kernel: after one iteration u0 atol 2e-3, dx/du atol 5e-3, slacks and
duals rtol 1e-3 / atol 1e-3, the merit rtol 1e-3. The full budget (12
iterations): the out-of-box QPs are chaotic in float32 past a few
iterations, so per problem the penalized objective within 2e-3 relative +
1e-3, the peak upper-x violation within 0.2 relative + 1e-3, kkt_eq within
0.2 relative + 1e-3 (chip_smoke.py's soft and kkt_eq rules), and the
controls' hard box no more violated than by the twin + 1e-3. An all-hard
SoftBounds through the soft instantiation equals the hard instantiation
bit for bit: g++ contracts no multiply-add (-ffp-contract=off), so the two
share every rounding. The warm cases, by chip_smoke.py's `compare_warm`
rules: the blend (0 iterations) within rtol 1e-5 / atol 1e-6 of the
twin; past it each component within its tolerance of the twin, or no
farther than the twin's own copies started from the warm state moved by
+-1e-6 relative (warm solves at N=8 are chaotic in float32: those copies
part from the twin by 0.02-0.09 in du after one iteration and by 4-8% of
the objective at the full budget): after one iteration u0, du and dx by
the tolerances above, at the full budget the objective (1.2e-2 relative
to max(|objective|, 1)) and kkt_eq (its gap less 0.2 of the twin's,
1e-3; `warm_gaps`' rules); and the single
plan equals the batch plan bit for bit after the blend, after one
iteration and at the full budget (every output keeps its operation order
and the block sums their 256-thread order), the fuse_lin prologue's
record too. A second build with the shared-memory opt-in
lowered to 30000 bytes keeps the soft area in the global workspace at N=8
(the stacks stay resident), as N=120 does on the card: the same bits.

Needs g++ (C++20); skipped, naming the reason, where it is missing.
"""
import ctypes
import os
import re
import shutil
import subprocess
from pathlib import Path

import pytest
import torch

import chip_smoke as S
from mpc_blaster_tpu_torch.ops import box_qp_ipm as K
from mpc_blaster_tpu_torch.qp.data import qp_objective
from mpc_blaster_tpu_torch.qp.soft import soft_qp_objective
from torch_threads import one_intraop_thread  # noqa: F401

DEV = torch.device("cpu")
N, FULL = 8, 12
MU0, ALPHA, REG = 1e-1, 0.995, 1e-6
STAND_IN = Path(__file__).resolve().parent / "cuda_cpu"


def cpu_source(src: str) -> str:
    """The kernel source in the stand-in's C++: the <<<...>>> launch and
    the dynamic shared memory rewritten, and the ring's spin loops
    yielding the core (128 threads share a few)."""
    def once(s, old, new):
        assert s.count(old) == 1, old
        return s.replace(old, new)
    src = once(src, "extern __shared__ float4 smem4[];",
               "float4* smem4 = cpu_dynamic_smem();")
    src = once(src, "return *(const volatile int*)p;",
               "cpu_spin_pause();\n  return *(const volatile int*)p;")
    src, n = re.subn(r"(\w+<[^<>;]*>)\s*<<<([^>]*)>>>\(", r"cpu_launch(\1, \2, ",
                     src)
    assert n == 3   # the batch plan's solve, the single plan's prologue and
    #                 solve
    return src


def start_build(d: Path, optin=None):
    """Start g++ on the kernel library into `d` (SMEM_OPTIN replaced by
    `optin` bytes where given); `finish_build` waits for it."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the CUDA source on the CPU")
    text = cpu_source(K.SOURCE.read_text())
    if optin is not None:
        old = f"constexpr long long SMEM_OPTIN = {K.SMEM_OPTIN};"
        assert text.count(old) == 1
        text = text.replace(old, f"constexpr long long SMEM_OPTIN = {optin};")
    src = d / "box_qp_ipm_cpu.cpp"
    src.write_text(text)
    so = d / "libbox_qp_ipm_cpu.so"
    proc = subprocess.Popen(
        [gxx, "-std=c++20", "-O2", "-ffp-contract=off", "-fPIC", "-shared",
         "-pthread", "-DBOX_QP_IPM_CPU_SUBSET", f"-I{STAND_IN}", "-o",
         str(so), str(src)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    return proc, so


def finish_build(build) -> ctypes.CDLL:
    """The library of a `start_build`, bound."""
    proc, so = build
    _, err = proc.communicate()
    assert proc.returncode == 0, err[-4000:]
    return K._bind(ctypes.CDLL(str(so)))


class OneCpu:
    """The built library, its two launch entries run on one CPU: the
    calling thread is pinned for the call, so the 128 threads a launch
    starts are too. A warp barrier then waits for threads of one core's
    run queue, not for 32 threads to be scheduled together on cores that
    other processes keep busy (beside a test run's six other workers,
    unpinned launches took up to 100x longer). The twins run unpinned."""

    def __init__(self, lib):
        self.lib = lib

    def __getattr__(self, name):
        fn = getattr(self.lib, name)
        if name not in ("box_qp_ipm_solve", "box_qp_ipm_fused_lin"):
            return fn

        def pinned(*args):
            cpus = os.sched_getaffinity(0)
            os.sched_setaffinity(0, {max(cpus)})
            try:
                return fn(*args)
            finally:
                os.sched_setaffinity(0, cpus)
        return pinned


# the shared-memory opt-in of the second build, which keeps the soft area
# in the global workspace at N=8
OPTIN_GLOBAL_SOFT = 30000


@pytest.fixture(scope="module")
def cpu_libs(tmp_path_factory):
    """The kernel library built for the CPU, and the second build with the
    opt-in lowered to OPTIN_GLOBAL_SOFT (both compiled at once)."""
    builds = [start_build(tmp_path_factory.mktemp("box_qp_ipm_cpu")),
              start_build(tmp_path_factory.mktemp("box_qp_ipm_cpu_global"),
                          OPTIN_GLOBAL_SOFT)]
    return [OneCpu(finish_build(b)) for b in builds]


@pytest.fixture(scope="module")
def cpu_kernel(cpu_libs):
    """The kernel library built for the CPU, bound into the wrapper module
    for the duration (the launch counters restored after)."""
    lib = cpu_libs[0]
    counters = {w: (w.launches, w.warm_launches, dict(w.by_instance),
                    dict(w.by_layout))
                for w in (K.box_qp_solve, K.fused_rti_solve)}
    prologues = K.fused_lin_prologue.launches
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(K, "_library", lambda: lib)
        mp.setattr(K, "_optin", lambda *a: None)
        mp.setattr(K, "_stream", lambda dev: None)
        yield lib
    for w, (n, nw, bi, bl) in counters.items():
        w.launches, w.warm_launches, w.by_instance, w.by_layout = n, nw, bi, bl
    K.fused_lin_prologue.launches = prologues


def _twice(t):
    """A batch of one problem as the same problem twice."""
    return torch.cat([t, t])


def _warm_from(sol):
    """The warm start (valid) of a solve's last-iterate slacks and duals."""
    from mpc_blaster_tpu_torch.qp.ipm import IpmWarmStart
    return IpmWarmStart(*(getattr(sol, f) for f in IpmWarmStart._fields[:-1]),
                        valid=torch.ones(sol.du.shape[0]))


def _warm_plain_case():
    """(kernel, twin, QP, warm) of a hover QP at N=8, B=1; kernel(iters,
    warm, B) launches the problem B times over, twin(iters, warm)."""
    qp = S.blaster_qps(N, 1, DEV)
    qp2 = type(qp)(*map(_twice, qp))

    def kern(it, w, B=1):
        if B == 2:
            w = type(w)(*map(_twice, w))
        return K._solve_kernel(qp if B == 1 else qp2, it, MU0, ALPHA, REG, w,
                               None, None), None

    def twin(it, w):
        return K.box_qp_solve_plain(qp, iters=it, warm=w)
    return kern, twin, qp, _warm_from(twin(2, None))


def _warm_fuse_lin_case():
    """As `_warm_plain_case`: a perturbed hover iterate of the fused tick
    at N=8, B=1 (`blaster`, hard); the kernel also returns the prologue's
    record (A, B, c)."""
    from mpc_blaster_tpu_torch.sqp.rti import fused_dyn_statics
    ocp, sp, xbar, ubar, x0, args, (A, Bm, c) = S.fused_case(N, 1, DEV, N + 5)
    model, dt, ns = fused_dyn_statics(ocp)
    ins = (sp, xbar, ubar, x0, *args)
    f1 = K._fused_prep(xbar, ubar, x0, *args, None)
    ins2 = tuple(map(_twice, ins))
    f2 = K._fused_prep(*ins2[1:], None)

    def kern(it, w, B=1):
        if B == 2:
            w = type(w)(*map(_twice, w))
        return K._fused_lin_kernel(ins[0] if B == 1 else ins2[0],
                                   f1 if B == 1 else f2, model, dt, ns, it,
                                   MU0, ALPHA, REG, True, w, None, None)

    def twin(it, w):
        return K.fused_rti_solve_plain(xbar, ubar, sp, x0, *args,
                                       model=model, dt=dt, num_steps=ns,
                                       iters=it, warm=w)
    return kern, twin, K._fused_qp(f1, A, Bm, c), _warm_from(twin(2, None))


WARM_CASES = {"plain": _warm_plain_case, "fuse_lin": _warm_fuse_lin_case}


def _plain_case(B=2):
    """(kernel, twin, QP): chip_smoke's out-of-box plain QPs; f(iters,
    soft) -> QPSolution."""
    qp = S.blaster_qps(N, B, DEV)
    qp = qp._replace(dx0=qp.dx0.clone())
    qp.dx0[:, 0] += 2.2
    return (lambda it, s: K._solve_kernel(qp, it, MU0, ALPHA, REG, None,
                                          None, s),
            lambda it, s: K.box_qp_solve_plain(qp, iters=it, soft=s), qp)


def _fuse_lin_case(B=2):
    """(kernel, twin, QP) of chip_smoke's out-of-box fuse_lin ticks."""
    from mpc_blaster_tpu_torch.sqp.rti import fused_dyn_statics
    ocp, sp, xbar, ubar, x0, args, (A, Bm, c) = S.fused_case(N, B, DEV, N + 3)
    x0 = x0.clone()
    x0[:, 0] += 2.2
    model, dt, ns = fused_dyn_statics(ocp)
    f = K._fused_prep(xbar, ubar, x0, *args, None)

    def kern(it, s):
        return K._fused_lin_kernel(
            sp, f, model, dt, ns, it, MU0, ALPHA, REG, False, None, None,
            K._fused_soft_rows(s, *args[6:], f))
    return (kern,
            lambda it, s: K.fused_rti_solve_plain(
                xbar, ubar, sp, x0, *args, model=model, dt=dt, num_steps=ns,
                iters=it, soft=s),
            K._fused_qp(f, A, Bm, c))


CASES = {"plain": _plain_case, "fuse_lin": _fuse_lin_case}
DENSITY = {"position": (0, 1, 2), "every_state": None}


@pytest.mark.parametrize("density", DENSITY)
@pytest.mark.parametrize("mode", CASES)
def test_soft_kernel_matches_twin_on_cpu(cpu_kernel, mode, density):
    """K4 built for the CPU against its twin: one iteration pointwise, the
    full budget on the objective, the violation, kkt_eq and the hard
    control box; the launch is counted as a soft one."""
    kern, plain, qp = CASES[mode]()
    soft, _ = S.soft_specs(N, DEV, idx=DENSITY[density])
    wrapper = K.box_qp_solve if mode == "plain" else K.fused_rti_solve
    n0 = S.soft_launches(wrapper)
    sk, sp = kern(1, soft), plain(1, soft)
    assert S.soft_launches(wrapper) == n0 + 1
    torch.testing.assert_close(sk.du[:, 0], sp.du[:, 0], rtol=0, atol=2e-3)
    torch.testing.assert_close(sk.du, sp.du, rtol=0, atol=5e-3)
    torch.testing.assert_close(sk.dx, sp.dx, rtol=0, atol=5e-3)
    for f in ("s_lx", "s_ux", "lam_lx", "lam_ux", "lam_lu", "lam_uu"):
        torch.testing.assert_close(getattr(sk, f), getattr(sp, f), rtol=1e-3,
                                   atol=1e-3, msg=f)
    torch.testing.assert_close(sk.mu, sp.mu, rtol=1e-3, atol=0)

    sk, sp = kern(FULL, soft), plain(FULL, soft)
    for f in ("dx", "du", "kkt_eq", "mu"):
        assert torch.isfinite(getattr(sk, f)).all(), f
    ok = soft_qp_objective(qp, soft, sk.dx, sk.du)
    op = soft_qp_objective(qp, soft, sp.dx, sp.du)
    assert ((ok - op).abs() <= 2e-3 * op.abs() + 1e-3).all(), (ok, op)
    vk = (sk.dx[:, 1:, 0] - qp.ubx[:, 1:, 0]).clamp(min=0).amax(1)
    vp = (sp.dx[:, 1:, 0] - qp.ubx[:, 1:, 0]).clamp(min=0).amax(1)
    assert vp.min() > 1e-2                 # the hard problem is infeasible
    assert ((vk - vp).abs() <= 0.2 * vp + 1e-3).all(), (vk, vp)
    assert ((sk.kkt_eq - sp.kkt_eq).abs()
            <= 0.2 * sp.kkt_eq.abs() + 1e-3).all(), (sk.kkt_eq, sp.kkt_eq)

    def box_viol(du):
        return torch.maximum(qp.lbu - du, du - qp.ubu).clamp(min=0).amax((1, 2))
    assert (box_viol(sk.du) <= box_viol(sp.du) + 1e-3).all()


@pytest.mark.parametrize("iters", [1, FULL])
def test_all_hard_soft_kernel_is_the_hard_kernel_on_cpu(cpu_kernel, iters):
    """An all-hard SoftBounds through the soft PLAIN instantiation gives
    the hard instantiation's results bit for bit."""
    kern, _, _ = _plain_case()
    _, hard = S.soft_specs(N, DEV)
    a, b = kern(iters, None), kern(iters, hard)
    for f in a._fields:
        if getattr(a, f) is not None:
            assert torch.equal(getattr(a, f), getattr(b, f)), f


def test_soft_area_in_workspace_gives_the_same_bits(cpu_kernel, cpu_libs,
                                                    monkeypatch):
    """The soft area in the global workspace (opt-in lowered so that only
    the stacks fit in shared memory at N=8) gives the shared-memory
    build's results bit for bit, dense soft rows, 1 and 3 iterations."""
    plan = K.launch_plan(N, K.PLAIN, False, 17, 6, 1)
    soft_plan = K.launch_plan(N, K.PLAIN, True, 17, 6, 1)
    assert plan.smem_bytes <= OPTIN_GLOBAL_SOFT < soft_plan.smem_bytes
    kern, _, _ = _plain_case(B=1)
    soft, _ = S.soft_specs(N, DEV, idx=None)
    shared = [kern(it, soft) for it in (1, 3)]
    monkeypatch.setattr(K, "_library", lambda: cpu_libs[1])
    for it, a in zip((1, 3), shared):
        b = kern(it, soft)
        for f in a._fields:
            if getattr(a, f) is not None:
                assert torch.equal(getattr(a, f), getattr(b, f)), (it, f)


@pytest.mark.parametrize("mode", WARM_CASES)
def test_warm_single_plan_matches_twin_and_batch_plan_on_cpu(cpu_kernel,
                                                            mode):
    """K3 (a warm start) at B=1 in the single plan against its twin: the
    blend pointwise, one iteration by the file's tolerances, the full
    budget by `warm_gaps`; and against the batch plan (the problem twice,
    B=2): the same bits after the blend, after one iteration and at the
    full budget, and the same prologue record. Each launch is counted
    under its plan."""
    kern, twin, qp, w = WARM_CASES[mode]()
    wrapper = K.box_qp_solve if mode == "plain" else K.fused_rti_solve
    lay0 = dict(wrapper.by_layout)
    sol = {}
    for it in (0, 1, FULL):
        one, lin1 = kern(it, w)
        two, lin2 = kern(it, w, B=2)
        for f in one._fields:
            a, b = getattr(one, f), getattr(two, f)
            if a is not None:
                assert torch.equal(a, b[:1]), (it, f)
                assert torch.equal(b[:1], b[1:]), (it, f)
        if lin1 is not None:
            assert all(torch.equal(a, b[:1]) for a, b in zip(lin1, lin2))
        sol[it] = one
    for kind in ("single", "batch"):
        key = ("resident", kind)
        assert wrapper.by_layout.get(key, 0) == lay0.get(key, 0) + 3

    blend, p0 = sol[0], twin(0, w)
    for f in S.SLACK_DUALS:
        torch.testing.assert_close(getattr(blend, f), getattr(p0, f),
                                   rtol=1e-5, atol=1e-6, msg=f)
    for f in ("dx", "du", "kkt_eq", "mu"):
        assert torch.isfinite(getattr(sol[FULL], f)).all(), f

    def one_it(x, t):
        return {"u0": (x.du[:, 0] - t.du[:, 0]).abs().max().item(),
                "du": (x.du - t.du).abs().max().item(),
                "dx": (x.dx - t.dx).abs().max().item()}

    def budget(x, t):
        ox, ot = (qp_objective(qp, y.dx[0], y.du[0]) for y in (x, t))
        return {"objective": ((ox - ot).abs() / ot.abs().clamp(min=1.0)
                              ).item(),
                "kkt_eq": ((x.kkt_eq - t.kkt_eq).abs()
                           - 0.2 * t.kkt_eq.abs()).max().item()}
    for it, gap, tol in ((1, one_it, {"u0": 2e-3, "du": 5e-3, "dx": 5e-3}),
                         (FULL, budget, {"objective": 1.2e-2,
                                         "kkt_eq": 1e-3})):
        t = twin(it, w)
        spread = [gap(twin(it, w._replace(**{f: getattr(w, f) * (1 + m)
                                             for f in S.SLACK_DUALS})), t)
                  for m in (1e-6, -1e-6)]
        for c, g in gap(sol[it], t).items():
            assert g <= max(tol[c], *(m[c] for m in spread)), (it, c, g,
                                                                spread)


def test_prologue_alone_is_the_full_launch_prologue_on_cpu(cpu_kernel):
    """The single plan's prologue grid launched alone (iters =
    PROLOGUE_ONLY at B=1, `fused_lin_prologue`'s launch) writes the record
    the full launch's prologue writes, bit for bit, and matches
    `fast_linearize` by chip_smoke's rule (2e-4 + 2e-4 |ref|); it counts
    in `fused_lin_prologue.launches` and not as a solve. At B=2 (the batch
    plan, which has no prologue grid) the library refuses it."""
    from mpc_blaster_tpu_torch.sqp.rti import fused_dyn_statics
    ocp, sp, xbar, ubar, x0, args, ref = S.fused_case(N, 1, DEV, N + 5)
    model, dt, ns = fused_dyn_statics(ocp)

    def run(it, ins):
        f = K._fused_prep(*ins[1:], None)
        return K._fused_lin_kernel(ins[0], f, model, dt, ns, it, MU0, ALPHA,
                                   REG, True, None, None, None)[1]
    ins = (sp, xbar, ubar, x0, *args)
    n0, s0 = K.fused_lin_prologue.launches, K.fused_rti_solve.launches
    alone = run(K.PROLOGUE_ONLY, ins)
    assert (K.fused_lin_prologue.launches, K.fused_rti_solve.launches) \
        == (n0 + 1, s0)
    full = run(1, ins)
    assert (K.fused_lin_prologue.launches, K.fused_rti_solve.launches) \
        == (n0 + 2, s0 + 1)
    assert all(torch.equal(a, b) for a, b in zip(alone, full))
    for g, r in zip(alone, ref):
        assert bool(((g - r).abs() <= 2e-4 + 2e-4 * r.abs()).all())
    with pytest.raises(RuntimeError, match="launch failed"):
        run(K.PROLOGUE_ONLY, tuple(map(_twice, ins)))
    assert K.fused_lin_prologue.launches == n0 + 2
