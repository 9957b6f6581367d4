"""The box-QP IPM kernel's CUDA source itself, run on the CPU: built with
g++ against a stand-in of the CUDA runtime (`tests/cuda_cpu/cuda_runtime.h`:
one std::thread per CUDA thread, std::barrier for __syncthreads, a barrier
per warp for __syncwarp and the shuffles, the launch as a loop over
blocks, NaN-filled dynamic shared memory) and called through the port's
own launch code (`ops/box_qp_ipm.py::_solve_kernel` and
`_fused_lin_kernel`) on CPU tensors, each launch on one CPU, against the
plain twins.

Only the instantiations held here are built (`-DBOX_QP_IPM_CPU_SUBSET`):
PLAIN hard and soft and FUSE_LIN `blaster` soft (kernel K4 and the hard
solve it must reproduce). The cases are `chip_smoke.py::soft_runners`'
out-of-box QPs at N=8: the initial state pushed 2.2 past the x box, soft
position bounds (Zl=1e3, zl=1e2) or every state soft (the soft closed
loop's rows).

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
share every rounding. A second build with the shared-memory opt-in
lowered to 30000 bytes keeps the soft area in the global workspace at N=8
(the stacks stay resident), as N=120 does on the card: the same bits.

Needs g++ (C++20); skipped, naming the reason, where it is missing. The
two builds take ~12 s of the file's ~55 s on one worker.
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
    assert n == 1
    return src


def build(d: Path, optin=None) -> ctypes.CDLL:
    """The kernel library built with g++ into `d` (SMEM_OPTIN replaced by
    `optin` bytes where given), bound."""
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
    res = subprocess.run(
        [gxx, "-std=c++20", "-O2", "-ffp-contract=off", "-fPIC", "-shared",
         "-pthread", "-DBOX_QP_IPM_CPU_SUBSET", f"-I{STAND_IN}", "-o",
         str(so), str(src)], capture_output=True, text=True)
    assert res.returncode == 0, res.stderr[-4000:]
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


@pytest.fixture(scope="module")
def cpu_kernel(tmp_path_factory):
    """The kernel library built for the CPU, bound into the wrapper module
    for the duration (the launch counters restored after)."""
    lib = OneCpu(build(tmp_path_factory.mktemp("box_qp_ipm_cpu")))
    counters = {w: (w.launches, w.warm_launches, dict(w.by_instance),
                    dict(w.by_layout))
                for w in (K.box_qp_solve, K.fused_rti_solve)}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(K, "_library", lambda: lib)
        mp.setattr(K, "_optin", lambda *a: None)
        mp.setattr(K, "_stream", lambda dev: None)
        yield lib
    for w, (n, nw, bi, bl) in counters.items():
        w.launches, w.warm_launches, w.by_instance, w.by_layout = n, nw, bi, bl


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


def test_soft_area_in_workspace_gives_the_same_bits(cpu_kernel,
                                                    tmp_path_factory,
                                                    monkeypatch):
    """The soft area in the global workspace (opt-in lowered so that only
    the stacks fit in shared memory at N=8) gives the shared-memory
    build's results bit for bit, dense soft rows, 1 and 3 iterations."""
    plan = K.launch_plan(N, K.PLAIN, False, 17, 6)
    soft_plan = K.launch_plan(N, K.PLAIN, True, 17, 6)
    optin = 30000
    assert plan.smem_bytes <= optin < soft_plan.smem_bytes
    kern, _, _ = _plain_case(B=1)
    soft, _ = S.soft_specs(N, DEV, idx=None)
    shared = [kern(it, soft) for it in (1, 3)]
    monkeypatch.setattr(K, "_library", lambda lib=OneCpu(build(
        tmp_path_factory.mktemp("box_qp_ipm_cpu_global"), optin)): lib)
    for it, a in zip((1, 3), shared):
        b = kern(it, soft)
        for f in a._fields:
            if getattr(a, f) is not None:
                assert torch.equal(getattr(a, f), getattr(b, f)), (it, f)
