"""Time the box-QP IPM kernel of this checkout against another checkout's,
on one NVIDIA GPU, in turns.

    python3 kernel_ab.py --other DIR [DIR ...] [--stamps] [--shapes K1,K6]
                         [--out FILE]

Each DIR holds another checkout of the repository (for example the
parent commit, unpacked with `git archive`), or at least its
`mpc_blaster_tpu_torch/` package. Its `ops/box_qp_ipm.py` is loaded under
another module name; it builds its own `csrc/box_qp_ipm.cu` with nvcc
(every build starts together). Every shape
below is launched through each checkout's own wrapper on the same inputs
(made once by `chip_smoke.py`'s case functions), warmed up once, then
timed with CUDA events over REPS launches in the order other, this, this,
other: eagerly, each call's host work included (`this_ms`, `other_ms`,
their `ratio` and `spread`: the difference between the two turns of each
over their sum), and on replays of a CUDA graph that captured REPS
launches (the host's work off the clock, as on the port's captured
ticks: `replay_this_ms`, `replay_other_ms`, `replay_ratio`,
`replay_spread`). Each build's ptxas lines (registers,
stack, spills per instantiation) are printed; for this checkout's kernel
each instantiation's launch plans (B=1 and a batch), registers and blocks
per SM (`ops/box_qp_ipm.py::kernel_info`) at the shapes it is timed at.

The soft-bound shapes (K4) start outside the box (the initial state 2.2
past the x box) with soft position bounds, or every state soft ("dense",
the soft closed loop's rows); each has a hard twin shape, the same inputs
without soft bounds, so that soft over hard is read within one run.

With --stamps the first other checkout's kernel and this one's are also
built as copies instrumented with clock64() stamps (written under the
first DIR, never into this checkout): thread 0 of block 0 charges the
cycles between consecutive stamps to the phase they close (the
factorization's matrix phases, its block barriers, the Cholesky inverse,
Z on warp 0, the solves' vector phases or sweeps, their barriers, the
waits for the cp.async ring, the KKT pass's adjoint sweep, each row pass
of an iteration: the complementarity sum, the factorization's barrier
weights, the right-hand sides, the step lengths, the affine
complementarity, the update, the merit; the FUSE_LIN prologue on the
solve's block; everything else), at B=1: the plain mode at N=60, hard at
12 iterations and soft (position bounds, from outside the box) at 6, and
kernel K3's warm launches at fuse_lin N=60, 3 iterations ("fastest") and
plain N=10, 6 (the mission). Thread 0 of block 0 runs the solve's
critical path in either plan; the single plan's prologue grid is a launch
of its own, outside the stamps (the "K6 prologue ... 0it" rows time it).
The stamp sites fit the kernel before the shared-memory redesign (one
thread per output), after it, and the single-problem plan; a source they
do not fit is refused.

Prints one JSON object per line and the card's name and power limit;
with --out also writes them to FILE.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

import chip_smoke as S

REPS = 20
LINES: list = []


def emit(kind: str, **kv):
    line = json.dumps({"kind": kind, **kv})
    LINES.append(line)
    print(line, flush=True)


def load_wrapper(root: Path, name: str):
    """The box_qp_ipm wrapper module of the checkout at `root`."""
    path = root / "mpc_blaster_tpu_torch" / "ops" / "box_qp_ipm.py"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---- the shapes -----------------------------------------------------------
# (label, kernel, a function of the device giving a function of a wrapper
# module that launches once)

# soft= of the K4 shapes (inputs pushed outside the box): the soft states,
# or "hard" for the same inputs without soft bounds
SOFT_STATES = {"position": (0, 1, 2), "dense": None}


def soft_bounds(soft, N, dev):
    if soft == "hard":
        return None
    return S.soft_specs(N, dev, idx=SOFT_STATES[soft])[0]


def plain(N, B, iters, nx=17, soft=None, warm=False):
    def make(dev):
        w = sb = None
        if warm:
            from mpc_blaster_tpu_torch.ops import box_qp_ipm as K
            _, inp, w, _ = S.warm_case(N, B, dev, N)
            qp = S.warm_runners("plain", None, inp, K)[2]
        elif nx == 13:
            qp = S.quad13_qps(N, B, dev)
        else:
            qp = S.blaster_qps(N, B, dev)
        if soft is not None:
            qp = qp._replace(dx0=qp.dx0.clone())
            qp.dx0[:, 0] += 2.2
            sb = soft_bounds(soft, N, dev)
        return lambda M: (lambda: M.box_qp_solve(qp, iters=iters, soft=sb,
                                                 warm=w))
    return make


def fuse_lin(N, B, iters, family="blaster", soft=None, warm=False):
    def make(dev):
        from mpc_blaster_tpu_torch.sqp.rti import fused_dyn_statics
        w = sb = None
        if warm:
            ocp, inp, w, _ = S.warm_case(N, B, dev, N)
            xbar, ubar, x0, args, sp = (inp["xbar"], inp["ubar"], inp["x0"],
                                        inp["args"], inp["sp"])
            statics = fused_dyn_statics(ocp)
        elif family == "quad13":
            statics, sp, xbar, ubar, x0, args, _ = S.quad13_fused_case(
                N, B, dev, N + 2)
        else:
            build = S.batched_fused_case if B > 1 else S.fused_case
            ocp, sp, xbar, ubar, x0, args, _ = build(
                N, B, dev, N + 2, **({} if B > 1 else {"family": family}))
            statics = fused_dyn_statics(ocp, family=family)
        if soft is not None:
            x0 = x0.clone()
            x0[:, 0] += 2.2
            sb = soft_bounds(soft, N, dev)
        model, dt, ns = statics
        kw = dict(model=model, dt=dt, num_steps=ns, iters=iters, warm=w,
                  soft=sb)
        return lambda M: (lambda: M.fused_rti_solve(xbar, ubar, sp, x0,
                                                    *args, **kw))
    return make


def fuse_cost(N, B, iters):
    def make(dev):
        ocp, sp, xbar, ubar, x0, args, (A, Bm, c) = S.fused_case(N, B, dev,
                                                                  N + 2)
        AB = torch.cat([A, Bm], -1)
        return lambda M: (lambda: M.batched_fused_tick(
            AB, c, xbar, ubar, x0, *args, iters=iters))
    return make


SHAPES = [
    ("K1 17x6 N=60 B=1 12it", "plain", plain(60, 1, 12)),
    ("K1 17x6 N=20 B=1024 12it", "plain", plain(20, 1024, 12)),
    ("K1 17x6 N=60 B=256 6it", "plain", plain(60, 256, 6)),
    ("K1 17x6 N=60 B=256 12it", "plain", plain(60, 256, 12)),
    ("K1 13x4 N=20 B=1 6it", "plain", plain(20, 1, 6, nx=13)),
    ("K1 13x4 N=20 B=1024 12it", "plain", plain(20, 1024, 12, nx=13)),
    ("K6 blaster N=60 B=1 12it", "fuse_lin", fuse_lin(60, 1, 12)),
    ("K6 blaster N=60 B=1 6it", "fuse_lin", fuse_lin(60, 1, 6)),
    ("K6 blaster N=20 B=1 6it", "fuse_lin", fuse_lin(20, 1, 6)),
    ("K6 blaster N=20 B=1024 6it", "fuse_lin", fuse_lin(20, 1024, 6)),
    ("K6 blaster N=20 B=1024 12it", "fuse_lin", fuse_lin(20, 1024, 12)),
    ("K6 blaster_dist N=30 B=1 6it", "fuse_lin",
     fuse_lin(30, 1, 6, family="blaster_dist")),
    ("K6 quad13 N=20 B=1 6it", "fuse_lin", fuse_lin(20, 1, 6,
                                                   family="quad13")),
    ("K6 prologue N=60 B=1 0it", "fuse_lin", fuse_lin(60, 1, 0)),
    ("K6 prologue N=20 B=1024 0it", "fuse_lin", fuse_lin(20, 1024, 0)),
    # K3 at every shape the main paths launch it (PERF.md section 6): the
    # "fastest" ticks (fuse_lin N=60), bench.py's warm rows (plain N=20,
    # 3 and 4 iterations), the 60 s mission's controller (plain N=10, 6),
    # the warm reuse loop (plain N=10, 3), the stress states' "fastest"
    # (fuse_lin N=20) and the flight node's (fuse_lin N=30)
    ("K3 fuse_lin warm N=60 B=1 3it", "fuse_lin",
     fuse_lin(60, 1, 3, warm=True)),
    ("K3 plain warm N=20 B=1 3it", "plain", plain(20, 1, 3, warm=True)),
    ("K3 plain warm N=20 B=1 4it", "plain", plain(20, 1, 4, warm=True)),
    ("K3 plain warm N=10 B=1 6it", "plain", plain(10, 1, 6, warm=True)),
    ("K3 plain warm N=10 B=1 3it", "plain", plain(10, 1, 3, warm=True)),
    ("K3 fuse_lin warm N=20 B=1 3it", "fuse_lin",
     fuse_lin(20, 1, 3, warm=True)),
    ("K3 fuse_lin warm N=30 B=1 3it", "fuse_lin",
     fuse_lin(30, 1, 3, warm=True)),
    ("K4 fuse_lin soft N=60 B=1 6it", "fuse_lin",
     fuse_lin(60, 1, 6, soft="position")),
    ("K4 fuse_lin soft dense N=60 B=1 6it", "fuse_lin",
     fuse_lin(60, 1, 6, soft="dense")),
    ("K4 fuse_lin hard N=60 B=1 6it", "fuse_lin", fuse_lin(60, 1, 6,
                                                          soft="hard")),
    ("K4 plain soft N=60 B=1 6it", "plain", plain(60, 1, 6, soft="position")),
    ("K4 plain soft dense N=60 B=1 6it", "plain", plain(60, 1, 6,
                                                        soft="dense")),
    ("K4 plain hard N=60 B=1 6it", "plain", plain(60, 1, 6, soft="hard")),
    ("K4 plain soft N=20 B=1024 12it", "plain",
     plain(20, 1024, 12, soft="position")),
    ("K4 plain hard N=20 B=1024 12it", "plain",
     plain(20, 1024, 12, soft="hard")),
    ("K5 fuse_cost N=20 B=1024 12it", "fuse_cost", fuse_cost(20, 1024, 12)),
    ("K5 fuse_cost N=20 B=1024 6it", "fuse_cost", fuse_cost(20, 1024, 6)),
    ("K7 N=120 B=1 12it", "plain", plain(120, 1, 12)),
    ("K7 N=240 B=1 12it", "plain", plain(240, 1, 12)),
    ("K7 N=240 B=256 12it", "plain", plain(240, 256, 12)),
]


class Replay:
    """REPS calls of a launch captured once as a CUDA graph (after a warm
    call on a side stream), replayed: the device's time for the wrapper's
    work with the host's off the clock, as on the port's captured ticks.
    Launch counts are taken once, at the capture."""

    def __init__(self, fn):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            for _ in range(REPS):
                fn()

    def ms(self) -> float:
        """Mean ms per launch over one replay."""
        return S.cuda_ms(self.graph.replay, 1) / REPS


def timed_turns(old, new) -> dict:
    """Mean ms per launch of each, timed other, this, this, other: eagerly,
    each call's host work included (`other_ms`, `this_ms`, their `ratio`
    and `spread`), and on replays of a CUDA graph of REPS launches
    (`Replay`: the host's work off the clock; the same keys with
    `replay_` before them)."""
    old()
    new()
    torch.cuda.synchronize()
    o1 = S.cuda_ms(old, REPS)
    n1 = S.cuda_ms(new, REPS)
    n2 = S.cuda_ms(new, REPS)
    o2 = S.cuda_ms(old, REPS)
    go, gn = Replay(old), Replay(new)
    go.graph.replay()
    gn.graph.replay()
    torch.cuda.synchronize()
    ro1, rn1, rn2, ro2 = go.ms(), gn.ms(), gn.ms(), go.ms()

    def turns(o1, n1, n2, o2, pre=""):
        return {pre + "other_ms": [o1, o2], pre + "this_ms": [n1, n2],
                pre + "ratio": (n1 + n2) / (o1 + o2),
                pre + "spread": (abs(o1 - o2) + abs(n1 - n2)) / (o1 + o2)}
    return {**turns(o1, n1, n2, o2), **turns(ro1, rn1, rn2, ro2, "replay_")}


def plan_rows(K, dev) -> list:
    """This checkout's launch per instantiation at the timed horizons, for
    a single problem and for a batch (its two plans)."""
    rows = []
    for nx, nu, mode, family, soft in sorted(
            K.BUILT, key=lambda b: (b[0], b[2], str(b[3]), b[4])):
        for N in (20, 30, 60, 120, 240):
            if nx == 13 and N > 20:
                continue
            for B in (1, 1024):
                info = K.kernel_info(N, mode, nx, nu, family, soft,
                                     device=dev, B=B)
                rows.append({"instance": K.instance_name(nx, nu, family,
                                                         soft),
                             "mode": K._MODE_NAMES[mode], "N": N, "B": B,
                             **info})
    return rows


# ---- clock64() stamps ---------------------------------------------------
# Thread 0 of block 0 takes part in every phase of either design, so the
# cycles between its consecutive stamps, charged to the phase they close,
# split the launch along its critical path.
STAMP_PHASES = ("other", "factorize_matrix", "factorize_barriers",
                "cholesky", "solve_vector", "solve_barriers", "kkt_sweep",
                "ring_waits", "z_on_warp0",
                # inside the backward sweep of the shared-memory design
                "back_release", "back_pcp_shuffles", "back_next_preq",
                "back_g_chain", "back_gu_shuffles", "back_z_chain",
                # inside its one-warp Cholesky inverse
                "chol_factor", "chol_inverse",
                # the row passes of an IPM iteration
                "rows_comp_sum", "rows_weights", "rows_rhs", "rows_alphas",
                "rows_mu_aff", "rows_update", "rows_merit",
                # the FUSE_LIN prologue on the solve's block (the single
                # plan runs it as a grid of its own before the solve: 0)
                "prologue")
NSTAMP = len(STAMP_PHASES)
ROWS = {p: STAMP_PHASES.index(p) for p in STAMP_PHASES if p.startswith("rows")}
# a launch's first stamp opens the clock: the gap since the previous
# launch is charged to no phase
STAMP_STATE = (f"__device__ unsigned long long g_stamp[{NSTAMP}], "
               "g_stamp_last;\n"
               "__device__ __forceinline__ void stamp(int i) {\n"
               "  if (threadIdx.x == 0 && blockIdx.x == 0) {\n"
               "    const unsigned long long now = clock64();\n"
               "    if (i >= 0) g_stamp[i] += now - g_stamp_last;\n"
               "    g_stamp_last = now;\n  }\n}\n")
# (call in run(), the phase it is charged to)
ROW_CALLS = (
    ("const float mu_cur = comp_sum() / n_ineq;", "rows_comp_sum"),
    ("rhs_grads(false);", "rows_rhs"),
    ("alphas(false, 1.f, ddxa, ddua, ap, ad);", "rows_alphas"),
    ("const float mu_aff = mu_aff_sum(ap, ad) / n_ineq;", "rows_mu_aff"),
    ("rhs_grads(true);", "rows_rhs"),
    ("alphas(true, alpha_frac, ddx, ddu, ap, ad);", "rows_alphas"),
    ("update(ap, ad);", "rows_update"),
    ("const float m = merit(st, eq);", "rows_merit"))


def _once(s, old, new):
    if s.count(old) != 1:
        raise ValueError(f"stamp site not found once: {old[:60]!r}")
    return s.replace(old, new)


def _body(s, start, end, fn):
    a = s.index(start)
    b = s.index(end, a)
    return s[:a] + fn(s[a:b]) + s[b:]


def stamped_source(src: str) -> str:
    """A kernel source with the stamps inserted: the one-thread-per-output
    design (256 threads, factor stacks in global memory, the Cholesky
    inverse on one thread) or the shared-memory one (128 threads, one-warp
    sweeps and Cholesky inverse, the cp.async ring). Raises where a site
    is missing."""
    src = _once(src, "namespace {\n", STAMP_STATE + "\nnamespace {\n")
    src = _once(src, "    if constexpr (MODE == FUSE_LIN) linearize(md);\n",
                "    stamp(-1);\n"
                "    if constexpr (MODE == FUSE_LIN) linearize(md);\n"
                f"    stamp({STAMP_PHASES.index('prologue')});\n")
    for call, phase in ROW_CALLS:
        src = _once(src, f"      {call}\n", f"      stamp(0);\n      {call}\n"
                    f"      stamp({ROWS[phase]});\n")
    src = _once(src, "e += THREADS) sgu[e] = sig_pair(2, e);\n",
                "e += THREADS) sgu[e] = sig_pair(2, e);\n"
                f"    stamp({ROWS['rows_weights']});\n")
    src = _once(src, "    if (t == 0) {\n      diag[0] = st;\n",
                "    stamp(0);\n    if (t == 0) {\n      diag[0] = st;\n")
    start = ("  __device__ void factorize() {",
             "  __device__ void factorize() {\n    stamp(0);")
    if "chol_inverse_warp" not in src:
        src = _body(src, start[0], "  // RHS gradients",
                    lambda b: b.replace("__syncthreads();", "stamp(1); "
                                        "__syncthreads(); stamp(2);")
                    .replace("if (t == 0) chol_inverse<NU>(sh.Huu, sh.Hi);",
                             "if (t == 0) chol_inverse<NU>(sh.Huu, sh.Hi); "
                             "stamp(3);").replace(*start, 1))
        src = _body(src, "  __device__ void solve_rhs(", "  // fraction-to",
                    lambda b: b.replace("__syncthreads();", "stamp(4); "
                                        "__syncthreads(); stamp(5);")
                    .replace("int cur = 0;", "int cur = 0;\n    stamp(0);",
                             1))
        src = _once(src, "    float stat = 0.f;\n    int cur = 0;\n",
                    "    float stat = 0.f;\n    int cur = 0;\n    stamp(0);\n")
        src = _once(src, "    stat_out = block_reduce(stat, sh.red, "
                    "OpMax());\n", "    stamp(6);\n    stat_out = "
                    "block_reduce(stat, sh.red, OpMax());\n")
    else:
        src = _body(src, start[0], "  // RHS gradients",
                    lambda b: b.replace("__syncthreads();", "stamp(1); "
                                        "__syncthreads(); stamp(2);")
                    .replace("lane);\n        __syncwarp();",
                             "lane);\n        stamp(3);\n        "
                             "__syncwarp();")
                    .replace("        if (!res) {\n          for (int e = "
                             "lane;", "        stamp(8);\n        if (!res) "
                             "{\n          for (int e = lane;")
                    .replace(*start, 1))
        src = _once(src, "  __device__ void solve_rhs(float* dX, float* dU) "
                    "{\n", "  __device__ void solve_rhs(float* dX, float* dU) "
                    "{\n    stamp(0);\n")
        src = _once(src, "      produce<V_FWD>(0, 1);\n    }\n    "
                    "__syncthreads();", "      produce<V_FWD>(0, 1);\n    }\n"
                    "    stamp(4); __syncthreads(); stamp(5);")
        sites = (("      const float* Ak = acquire(m);\n      const float* v = "
                  "Ak + NXX + NX * NU;  // req_k, qr_k, rr_k\n",
                  "      stamp(4);\n      const float* Ak = acquire(m);\n"
                  "      stamp(7);\n      const float* v = Ak + NXX + NX * "
                  "NU;  // req_k, qr_k, rr_k\n"),
                 ("w[j] = __shfl_sync(FULL, pcp, j);\n",
                  "w[j] = __shfl_sync(FULL, pcp, j);\n      stamp(10);\n"),
                 ("      // A_k' Pcp (state lanes), B_k' Pcp (control lanes)\n",
                  "      stamp(11);\n"
                  "      // A_k' Pcp (state lanes), B_k' Pcp (control lanes)\n"),
                 ("      const float qrk = v[NX + xi];\n      release(m);\n",
                  "      const float qrk = v[NX + xi];\n      stamp(12);\n"
                  "      release(m);\n      stamp(9);\n"),
                 ("u[j] = __shfl_sync(FULL, gu, NX + j);\n",
                  "u[j] = __shfl_sync(FULL, gu, NX + j);\n      stamp(13);\n"),
                 ("      pv = (qrk + g) - z;\n",
                  "      pv = (qrk + g) - z;\n      stamp(14);\n"),
                 ("  stamp_chol_factor;", ""))
        for old, new in sites[:-1]:
            src = _once(src, old, new)
        src = _once(src, "  if (lane < NU) {\n#pragma unroll\n    for (int c = 0; "
                    "c < NU; ++c) Ls[r * NU + c] = Lr[c];",
                    "  stamp(15);\n  if (lane < NU) {\n#pragma unroll\n    for "
                    "(int c = 0; c < NU; ++c) Ls[r * NU + c] = Lr[c];")
        src = _once(src, "  const bool ok = diag_ok && (min_piv > 1e-10f);\n",
                    "  stamp(16);\n"
                    "  const bool ok = diag_ok && (min_piv > 1e-10f);\n")
        src = _once(src, "    sweep_begin();\n    float stat = 0.f;\n",
                    "    stamp(0);\n    sweep_begin();\n    float stat = 0.f;\n")
        src = _once(src, "      produce<V_KKT>(N - 1, -1);\n    }\n",
                    "      produce<V_KKT>(N - 1, -1);\n    }\n    stamp(6);\n")
    return src + ('\nextern "C" int box_qp_ipm_stamps(unsigned long long* '
                  'out) {\n  return (int)cudaMemcpyFromSymbol(out, g_stamp, '
                  'sizeof(g_stamp));\n}\n')


def stamped_wrapper(root_in: Path, root: Path, name: str):
    """The wrapper of the checkout at `root_in` over a stamped copy of its
    kernel, written under `root`."""
    (root / "mpc_blaster_tpu_torch" / "ops").mkdir(parents=True,
                                                   exist_ok=True)
    (root / "mpc_blaster_tpu_torch" / "csrc").mkdir(exist_ok=True)
    base = root_in / "mpc_blaster_tpu_torch"
    (root / "mpc_blaster_tpu_torch" / "ops" / "box_qp_ipm.py").write_text(
        (base / "ops" / "box_qp_ipm.py").read_text())
    (root / "mpc_blaster_tpu_torch" / "csrc" / "box_qp_ipm.cu").write_text(
        stamped_source((base / "csrc" / "box_qp_ipm.cu").read_text()))
    return load_wrapper(root, name)


STAMP_CASES = (("plain 17x6 N=60 B=1 12it", 60, 12, plain(60, 1, 12)),
               ("plain 17x6 soft N=60 B=1 6it", 60, 6,
                plain(60, 1, 6, soft="position")),
               ("K3 fuse_lin warm N=60 B=1 3it", 60, 3,
                fuse_lin(60, 1, 3, warm=True)),
               ("K3 plain warm N=10 B=1 6it", 10, 6,
                plain(10, 1, 6, warm=True)))


def stamps(M, dev, label) -> list:
    """Phase split of a stamped kernel at B=1 (STAMP_CASES: the plain
    mode at N=60, hard at 12 iterations and soft from outside the box at
    6; K3's "fastest" fuse_lin launch at N=60, 3 iterations, and the
    mission's plain launch at N=10, 6): the cycles of each case's
    launches, the read before it taken off."""
    lib = M._library()
    lib.box_qp_ipm_stamps.argtypes = [ctypes.c_void_p]
    lib.box_qp_ipm_stamps.restype = ctypes.c_int

    def read():
        torch.cuda.synchronize()
        buf = (ctypes.c_ulonglong * NSTAMP)()
        if lib.box_qp_ipm_stamps(ctypes.cast(buf, ctypes.c_void_p)) != 0:
            raise RuntimeError("reading the stamps failed")
        return list(buf)

    out = []
    for case, N, iters, make in STAMP_CASES:
        run = make(dev)(M)
        before = read()
        ms = timed_turns(run, run)
        cyc = dict(zip(STAMP_PHASES, (a - b for a, b in zip(read(),
                                                             before))))
        total = sum(cyc.values())
        launch_ms = sum(ms["replay_this_ms"]) / 2
        stage_iters = N * iters
        out.append({"kernel": label, "case": case, "cycles": cyc,
                    "launch_ms": launch_ms, "cycles_total": total,
                    "share": {k: v / total for k, v in cyc.items()},
                    "us_per_stage_iteration": {
                        k: v / total * launch_ms * 1e3 / stage_iters
                        for k, v in cyc.items()}})
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", type=Path, nargs="+", required=True)
    ap.add_argument("--stamps", action="store_true")
    ap.add_argument("--shapes", default="",
                    help="comma-separated substrings; time only the shapes "
                         "whose label holds one (default: every shape)")
    ap.add_argument("--out", type=Path)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: no CUDA device is visible")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit("device", nvidia_smi=smi, name=torch.cuda.get_device_name(0))
    from mpc_blaster_tpu_torch.ops import box_qp_ipm as K
    others = {str(d): load_wrapper(d.resolve(), f"other{i}_box_qp_ipm")
              for i, d in enumerate(a.other)}
    mods = {**others, "this": K}
    stamped = {}
    if a.stamps:
        first = a.other[0].resolve()
        stamped = {
            str(a.other[0]): stamped_wrapper(first, first / "stamped",
                                             "stamped_other"),
            "this": stamped_wrapper(Path(S.REPO), first / "stamped_this",
                                    "stamped_this")}
    builds = {**mods, **{"stamped " + k: m for k, m in stamped.items()}}
    with ThreadPoolExecutor(len(builds)) as pool:
        built = [f.result() for f in [pool.submit(m.build_library)
                                      for m in builds.values()]]
    for who, (so, secs, log) in zip(builds, built):
        emit("build", which=who, nvcc_s=secs,
             ptxas=[ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln
                    or "Compiling entry" in ln])
    for m in builds.values():
        m._library()
    for r in plan_rows(K, dev):
        emit("plan", **r)
    keys = [k for k in a.shapes.split(",") if k]
    for label, kernel, make in SHAPES:
        if keys and not any(k in label for k in keys):
            continue
        t0 = time.perf_counter()
        launch = make(dev)
        for who, O in others.items():
            emit("ab", shape=label, kernel=kernel, other=who,
                 **timed_turns(launch(O), launch(K)),
                 build_s=time.perf_counter() - t0)
    for who, M in stamped.items():
        for row in stamps(M, dev, who):
            emit("stamps", **row)
    print(smi, flush=True)
    if a.out:
        a.out.parent.mkdir(parents=True, exist_ok=True)
        a.out.write_text("\n".join(LINES) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
