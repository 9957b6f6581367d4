"""Batched box-constrained OCP-QP interior-point solve: the Hopper kernel,
its plain PyTorch twins and the launch wrappers.

Replaces `mpc_blaster_tpu/ops/pallas_ipm.py::_ipm_kernel` in three modes
(VMEM-resident), cold or warm-started (its `warm_on` variant), hard or
soft-bounded (its `soft` variant, plain and fuse_lin modes), together with
its in-kernel algebra (`_contractT*`, `_matvec`, `_chol_inverse_lanes`)
and the host side of `_pallas_box_qp_solve`:

  - plain (`pallas_box_qp_solve`): `box_qp_solve`, twin
    `box_qp_solve_plain`. The host assembles the QP.
  - fuse_cost (`pallas_batched_fused_tick`): `batched_fused_tick`, twin
    `batched_fused_tick_plain`. The host linearizes; the kernel assembles
    the cost gradients, delta bounds and dx0 from the iterate and the spec,
    solves, and returns the updated absolute iterate with the step norms
    and the worst box violation.
  - fuse_lin (`pallas_fused_rti_solve`): `fused_rti_solve`, twin
    `fused_rti_solve_plain`. The kernel also linearizes (RK4 of the
    model family's rows-form ODE on dual numbers,
    `dynamics/fastlin.py::fast_linearize` is the twin): the whole RTI QP
    is one launch, for one problem (the deployed B=1 tick) or for B
    problems with their own iterates, stage parameters and specs (the
    Pallas kernel under `jax.vmap`: the batched `xla` tick over a
    "pallas_fused" solver).

The kernel is instantiated per model (dimensions and, in fuse_lin, the
ODE family of `dynamics/fastlin.py::FAMILIES`), as the Pallas kernel takes
its dimensions from the arrays: `BUILT` lists the instantiations of
`csrc/box_qp_ipm.cu`. The wrappers refuse any other combination with
`NotImplementedError`, on every device (no path of the port uses one).

Each launch follows a plan (`launch_plan`, a plain function of N, the
batch size B and the instantiation; the library's `box_qp_ipm_plan`
returns the same): one block per problem, of 128 threads (the batch
plan) or, for a single problem (B=1) in the plain and fuse_lin modes,
256 threads with the fuse_lin prologue run as a grid of its own before
the solve (the single plan); and dynamic shared memory that holds the
Riccati factor stacks (P, Z, Hinv of every stage) where they fit under
the card's 232448-byte opt-in (the "resident" layout: every 17x6 horizon
up to N=128), else only a window of them, the stacks staying in the
global workspace ("global": 17x6 at N=240). The wrapper opts each
instantiation in to that much shared memory once
(`box_qp_ipm_set_optin`) and raises if the runtime refuses or a plan
exceeds it; no option chooses the plan or the layout, and a plan that
fails to launch raises. The launches per layout and plan are counted in
each wrapper's `by_layout`, keyed (layout, plan): ("resident" or
"global", "single" or "batch"). The Pallas kernel's long-horizon
variants (K7, its `stream_p` / `stream_big` switches) are these two
layouts (`box_qp_solve` accepts the switches and selects nothing with
them). The single plan's fuse_lin prologue grid is a kernel launch of its
own: each is counted in `fused_lin_prologue.launches`, which also
launches it alone.

One call runs a whole Mehrotra predictor-corrector IPM (Gondzio-clipped
targets, Riccati factorization and sweeps, fraction-to-boundary steps,
best-merit tracking) for every problem of a batch. CUDA tensors go to the
kernel in `csrc/box_qp_ipm.cu` (one launch, every IPM iteration inside
it; counted in the wrapper's `launches`, per instantiation in its
`by_instance` (soft launches under keys ending in " soft",
`instance_name`), per layout in its `by_layout`, and in `warm_launches`
when a warm start is given); CPU tensors go to the plain twin.

Every wrapper takes `warm=`, an `qp/ipm.py::IpmWarmStart` with a leading
batch axis (fields (B, N, nx|nu), valid (B,)): per problem with valid >
0.5 the cold centred slacks and duals of the finite bounds are replaced by
the warm ones, slacks clipped to [1e-5, 1e20], duals to [0, lam_max] and
floored at 1e-8, wherever the clipped value is finite (kernel K3). valid =
0 is the cold solve bit for bit. `box_qp_solve` and `fused_rti_solve` also
take `skip=`, a one-element bool tensor on the device: when it holds True
the launch returns at once and the outputs are undefined (the watchdog's
redo, `sqp/rti.py::rti_step_warm_guarded`); the plain twins ignore it and
always compute. `box_qp_solve` and `fused_rti_solve` take `soft=`, a
`qp/soft.py::SoftBounds` with fields (N, nx|nu) (broadcast over the batch)
or (B, N, nx|nu): each soft bound row gains a violation pair eliminated
inside the kernel (kernel K4). The host
sanitises the penalties as the Pallas host does (`pen_in`): rows that are
hard or whose bound is infinite carry Z = 1e18, z = 0. Soft and warm do
not combine (ValueError, as in the JAX package). Nothing falls back: an
unsupported CUDA input raises. The CPU tests
hold the twins against the Pallas kernel in interpret mode;
`chip_smoke.py` holds the CUDA kernel against them on the card.

Host-side preparation (the K8 part of the Pallas wrapper): +-inf bounds
become +-1e18 before any subtraction (the kernel derives bound masks from
|b| > 5e17), the stage-0 state bound row is dropped (dx_0 is pinned),
everything is cast to contiguous float32, and outputs are fresh tensors
(never aliases of an input). The Pallas wrapper's 128-lane padding and
batch-last tiling have no counterpart: the kernel takes the batch
problem-major, one thread block per problem; its VMEM sizing is
`launch_plan`.

Semantics kept from the Pallas kernel (compare here first on a mismatch):
slacks floored at s_min=1e-3 at init and eps_s=1e-9 after each step;
masked bounds held at slack 1e20 / dual 0; barrier weights and RHS
factors capped at sigma_max=1e7; dual divides clipped at +-1e12; duals
clipped to [0, lam_max=1e7]; dx/du are the best-merit iterate while the
returned slacks/duals are the LAST iterate; diag rows are
[kkt_stat estimate, kkt_eq, best merit] (plus step_norm_x, step_norm_u,
bound_viol in the fuse_cost mode). `kkt_stat` is an upper-bound estimate
(last-iterate duals, clipped by the best merit), `kkt_eq` is exact on the
returned iterate.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from mpc_blaster_tpu_torch.dynamics.blaster import BlasterParams
from mpc_blaster_tpu_torch.dynamics.fastlin import fast_linearize
from mpc_blaster_tpu_torch.ops import nvcc_build
from mpc_blaster_tpu_torch.qp.data import QPData, QPSolution
from mpc_blaster_tpu_torch.utils import capture
# The 6x6 Huu inverse of the kernel's `chol_inverse`: one implementation,
# shared with the Riccati IPM.
from mpc_blaster_tpu_torch.qp.smallalg import \
    chol_inverse as chol_inverse_plain

# Kernel modes (the `Mode` template parameter of csrc/box_qp_ipm.cu).
PLAIN, FUSE_COST, FUSE_LIN = 0, 1, 2
_MODE_NAMES = {PLAIN: "plain", FUSE_COST: "fuse_cost", FUSE_LIN: "fuse_lin"}
# The fuse_lin prologue's ODE families (its `Family` template parameter)
# and the stage parameters each reads.
FAMILY_IDS = {"blaster": 0, "blaster_dist": 1, "quad13": 2}
FAMILY_NP = {"blaster": 25, "blaster_dist": 31, "quad13": 1}
# The instantiations csrc/box_qp_ipm.cu builds: (nx, nu, mode, family, soft);
# family None for the modes without a prologue. Warm starts (K3) are a
# runtime switch of each.
BUILT = frozenset({
    (17, 6, PLAIN, None, False), (17, 6, PLAIN, None, True),
    (13, 4, PLAIN, None, False),
    (17, 6, FUSE_COST, None, False),
    (17, 6, FUSE_LIN, "blaster", False), (17, 6, FUSE_LIN, "blaster", True),
    (17, 6, FUSE_LIN, "blaster_dist", False),
    (13, 4, FUSE_LIN, "quad13", False),
})

_BIG = 1e20     # slack sentinel for masked (infinite) bounds
_BIGB = 1e18    # finite stand-in for an infinite bound value
_MTHR = 5e17    # |bound| above this is treated as infinite (mask = 0)
_S_MIN, _MU_MIN = 1e-3, 1e-7
_SIGMA_MAX, _LAM_MAX, _EPS_S = 1e7, 1e7, 1e-9
_DUAL_CLIP = 1e12
_WARM_S_MIN = 1e-5   # _S_MIN * 1e-2, the warm slack floor
_WARM_FIELDS = ("s_lx", "s_ux", "lam_lx", "lam_ux", "s_lu", "s_uu",
                "lam_lu", "lam_uu")

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "box_qp_ipm.cu"

# The launch shapes of csrc/box_qp_ipm.cu: threads per problem in the batch
# and single plans, the single plan's fuse_lin prologue grid (threads per
# block, tangent columns per item), and the most dynamic shared memory a
# block may opt in to on the H100 (cudaDevAttrMaxSharedMemoryPerBlockOptin;
# probe P1 reads it back).
BATCH_THREADS = 128
SINGLE_THREADS = 256
LIN_THREADS = 128
LIN_COLS = 2
SMEM_OPTIN = 232448
RING_SLOTS = 4   # slots of the kernel's ring of stages
PROLOGUE_ONLY = -1  # a fuse_lin launch's iters: the prologue grid alone
SOFT_WORDS = 10  # float32 words per bound entry in the soft area


class LaunchPlan(NamedTuple):
    """How one launch runs: threads per block, dynamic shared bytes,
    whether the factor stacks are resident in shared memory, and the
    blocks of the fuse_lin prologue's own grid (0: the prologue, if any,
    runs on the solve's block)."""
    threads: int
    smem_bytes: int
    resident: bool
    prologue_blocks: int = 0

    @property
    def layout(self) -> str:
        return "resident" if self.resident else "global"

    @property
    def single(self) -> bool:
        return self.threads == SINGLE_THREADS

    @property
    def kind(self) -> str:
        return "single" if self.single else "batch"

    @property
    def key(self) -> tuple:
        """The launch's key in a wrapper's `by_layout`: (layout, kind)."""
        return self.layout, self.kind


def soft_area_floats(N: int, nx: int, nu: int) -> int:
    """float32 words of the soft instantiations' soft area at horizon N:
    SOFT_WORDS words for each of the 2 N (nx + nu) bound entries (the
    violation pair t, gam; the penalty Z, z; sig_s and the eliminated
    pair's denominator; four words the row passes hand on) and a class
    byte per entry, rounded up to whole words."""
    E = 2 * N * (nx + nu)
    return SOFT_WORDS * E + (E + 3) // 4


def single_plan(mode: int, B: int) -> bool:
    """Whether a launch of B problems takes the single plan: B=1 in the
    plain and fuse_lin modes (fuse_cost, the batched tick, builds only the
    batch plan)."""
    return B == 1 and mode != FUSE_COST


def launch_plan(N: int, mode: int, soft: bool, nx: int, nu: int, B: int
                ) -> LaunchPlan:
    """The plan of csrc/box_qp_ipm.cu's launch of B problems at horizon N
    for an nx x nu model. Threads per block: SINGLE_THREADS where
    `single_plan`, else BATCH_THREADS; the single plan's fuse_lin launch
    runs its prologue's N ceil((nx + nu) / LIN_COLS) items as a grid of
    blocks of LIN_THREADS before the solve. Dynamic shared memory (the
    same in both plans and every mode), in float32 words:
    the per-stage scratch (P'A, A'PA, P'B, Hux, Huu, the Cholesky
    inverse's two factors, eight words for the block reductions,
    the ring's two flags per slot), the ring of RING_SLOTS stages (A_k,
    B_k and up to 3 (nx + nu) words of the stage's vectors each), then the
    factor stacks P_0..P_N, Z_0..Z_{N-1}, Hinv_0..Hinv_{N-1} where the
    total fits in SMEM_OPTIN, else the factorization's window (two P
    slots, one Z, one Hinv). A soft launch adds its soft area
    (`soft_area_floats`, sized for every row being soft) after them where
    it still fits, else keeps it in the global workspace; the layout
    names where the stacks are."""
    if (nx, nu) not in {(b[0], b[1]) for b in BUILT} or N < 1 or B < 1 \
            or mode not in _MODE_NAMES:
        raise ValueError(f"no launch plan for N={N}, mode={mode}, B={B}, "
                         f"{nx}x{nu}")
    scratch = 2 * nx * nx + 2 * nx * nu + 3 * nu * nu + 8 + 2 * RING_SLOTS
    ring = RING_SLOTS * (nx * nx + nx * nu + 3 * (nx + nu))
    stacks = (N + 1) * nx * nx + N * nu * nx + N * nu * nu
    window = 2 * nx * nx + nu * nx + nu * nu
    resident = 4 * (scratch + ring + stacks) <= SMEM_OPTIN
    words = scratch + ring + (stacks if resident else window)
    if soft and 4 * (words + soft_area_floats(N, nx, nu)) <= SMEM_OPTIN:
        words += soft_area_floats(N, nx, nu)
    single = single_plan(mode, B)
    items = N * -(-(nx + nu) // LIN_COLS)
    prologue = (-(-items // LIN_THREADS) if single and mode == FUSE_LIN
                else 0)
    return LaunchPlan(SINGLE_THREADS if single else BATCH_THREADS,
                      4 * words, resident, prologue)


def _require_plan(plan: LaunchPlan) -> LaunchPlan:
    """Refuse a plan the card cannot launch (no fallback)."""
    if plan.smem_bytes > SMEM_OPTIN:
        raise RuntimeError(f"box_qp_ipm plan needs {plan.smem_bytes} B of "
                           f"shared memory, above the {SMEM_OPTIN} B opt-in")
    return plan


class _Prepped(NamedTuple):
    A: torch.Tensor    # (B, N, nx, nx)
    Bm: torch.Tensor   # (B, N, nx, nu)
    c: torch.Tensor    # (B, N, nx)
    Qs: torch.Tensor   # (B, nx, nx)  stage Hessian (shared by stages)
    Qt: torch.Tensor   # (B, nx, nx)  terminal Hessian
    q: torch.Tensor    # (B, N+1, nx)
    R: torch.Tensor    # (B, nu, nu)
    r: torch.Tensor    # (B, N, nu)
    lbx: torch.Tensor  # (B, N, nx)   state stages 1..N
    ubx: torch.Tensor
    lbu: torch.Tensor  # (B, N, nu)
    ubu: torch.Tensor
    dx0: torch.Tensor  # (B, nx)


def _f32(x):
    return x.to(torch.float32).contiguous()


def _san(b, lo):
    """+-inf bound -> -+1e18 (float32, contiguous)."""
    return _f32(torch.where(torch.isfinite(b), b,
                            torch.full_like(b, -_BIGB if lo else _BIGB)))


def _prep(data: QPData) -> _Prepped:
    """Sanitize +-inf bounds, drop the pinned stage-0 state bounds, cast
    to contiguous float32. Stage Hessians must be stage-invariant (the
    RTI's LINEAR_LS cost): Q[:, 0] and R[:, 0] are used."""
    f32, san = _f32, _san

    return _Prepped(
        A=f32(data.A), Bm=f32(data.B), c=f32(data.c),
        Qs=f32(data.Q[:, 0]), Qt=f32(data.Q[:, -1]), q=f32(data.q),
        R=f32(data.R[:, 0]), r=f32(data.r),
        lbx=san(data.lbx[:, 1:], True), ubx=san(data.ubx[:, 1:], False),
        lbu=san(data.lbu, True), ubu=san(data.ubu, False),
        dx0=f32(data.dx0))


# ------------------------------ plain twin ------------------------------

def _mv(M, y):
    """M y over leading batch axes."""
    return (M @ y.unsqueeze(-1)).squeeze(-1)


def _mtv(M, y):
    """M^T y over leading batch axes."""
    return (M.transpose(-1, -2) @ y.unsqueeze(-1)).squeeze(-1)


def _mtm(X, Y):
    """X^T Y over leading batch axes."""
    return X.transpose(-1, -2) @ Y


def _clip(x, lo, hi):
    return torch.minimum(torch.maximum(x, lo), hi)


def _warm_blend(S, LAM, masks, warm):
    """The kernel's warm blend (K3) over the cold centred slacks S and
    duals LAM (lists in group order lx, ux, lu, uu) of a batch."""
    use = (_f32(warm.valid) > 0.5)[:, None, None]
    for i, g in enumerate(("lx", "ux", "lu", "uu")):
        ok = use & (masks[i] > 0.5)
        w = torch.clamp(_f32(getattr(warm, "s_" + g)), _WARM_S_MIN, _BIG)
        wl = torch.clamp(torch.clamp(_f32(getattr(warm, "lam_" + g)), 0.0,
                                     _LAM_MAX), min=1e-8)
        S[i] = torch.where(ok & torch.isfinite(w), w, S[i])
        LAM[i] = torch.where(ok & torch.isfinite(wl), wl, LAM[i])


def _soft_rows(soft, bounds):
    """The kernel's penalty rows (the Pallas host's `pen_in`): per group
    (Z, z), float32 (B, N, w), from the group's raw (B, N, w) bounds. Hard
    rows and rows with an infinite bound carry the sentinel Z = 1e18 and
    z = 0. Unbatched (N, w) fields broadcast over B. None for a hard
    solve."""
    if soft is None:
        return None
    out = []
    for pen, b in zip((soft.lx, soft.ux, soft.lu, soft.uu), bounds):
        Z, z, sm = (a.to(b.device).expand(b.shape)
                    for a in (pen.Z, pen.z, pen.soft))
        smask = sm.to(torch.bool) & torch.isfinite(b)
        out.append((_f32(torch.where(smask, Z.to(torch.float32), _BIGB)),
                    _f32(torch.where(smask, z.to(torch.float32), 0.0))))
    return out


def _qp_bounds(data: QPData) -> tuple:
    """The four bound groups of a QP (state bounds of stages 1..N)."""
    return data.lbx[:, 1:], data.ubx[:, 1:], data.lbu, data.ubu


def _check_soft_warm(soft, warm):
    if soft is not None and warm is not None:
        raise ValueError("soft bounds do not support slack/dual warm "
                         "starts (violation pairs are not carried)")


def box_qp_solve_plain(data: QPData, iters: int = 12, mu0: float = 1e-1,
                       alpha_frac: float = 0.995, reg: float = 1e-6,
                       warm=None, skip=None, soft=None,
                       stream_p: bool | None = None,
                       stream_big: bool | None = None) -> QPSolution:
    """Eager PyTorch twin of the CUDA kernel. `data` fields carry a
    leading batch axis (B, ...); any device; any dimensions. Same
    arguments and result as `box_qp_solve` (`skip` is ignored: the twin
    always computes)."""
    _check_soft_warm(soft, warm)
    _check_stream(stream_p, stream_big)
    return _solve_plain(_prep(data), iters, mu0, alpha_frac, reg, warm,
                        _soft_rows(soft, _qp_bounds(data)))


def _solve_plain(p: _Prepped, iters, mu0, alpha_frac, reg, warm, pens
                 ) -> QPSolution:
    """The twin's solve on prepared inputs; `pens` are the soft penalty
    rows of `_soft_rows` (None: a hard solve)."""
    A, Bm, c, Qs, Qt, q, R, r = (p.A, p.Bm, p.c, p.Qs, p.Qt, p.q, p.R,
                                 p.r)
    Bsz, N, nx, nu = A.shape[0], A.shape[1], A.shape[-1], Bm.shape[-1]
    dev = A.device
    big = torch.full((), _BIG, dtype=torch.float32, device=dev)

    # Bound groups: (bound, sign, mask, is_state). Masks are derived from
    # the sanitized bound magnitude; they never change during a solve.
    mlx = (p.lbx > -_MTHR).float()
    mux = (p.ubx < _MTHR).float()
    mlu = (p.lbu > -_MTHR).float()
    muu = (p.ubu < _MTHR).float()
    groups = ((p.lbx, 1.0, mlx, True), (p.ubx, -1.0, mux, True),
              (p.lbu, 1.0, mlu, False), (p.ubu, -1.0, muu, False))
    soft = pens is not None
    if soft:
        # soft rows (K4): a finite bound with a non-sentinel penalty; the
        # (t, gam) violation pair of every group, inert (BIG, 0) on the
        # hard rows
        SM = [(g[2] > 0.5) & (pens[i][0] < _MTHR)
              for i, g in enumerate(groups)]
        hard = [g[2] * (~SM[i]).float() for i, g in enumerate(groups)]
    else:
        hard = [g[2] for g in groups]

    def clamp_into(v, lb, ub, ml, mu_):
        both = (ml > 0.5) & (mu_ > 0.5)
        w = torch.where(both, ub - lb, torch.ones_like(lb))
        lo = torch.where(ml > 0.5, lb + 0.1 * w, -big)
        hi = torch.where(mu_ > 0.5, ub - 0.1 * w, big)
        return _clip(v, lo, torch.maximum(hi, lo))

    # ---- initial point: rollout (du = 0) with the 10%-inset clamp (hard
    # rows only: a soft row may start outside its box), centred slacks and
    # duals ----
    xs = [p.dx0]
    for k in range(N):
        nxt = _mv(A[:, k], xs[-1]) + c[:, k]
        xs.append(clamp_into(nxt, p.lbx[:, k], p.ubx[:, k], hard[0][:, k],
                             hard[1][:, k]))
    dx = torch.stack(xs, 1)
    du = clamp_into(torch.zeros_like(p.lbu), p.lbu, p.ubu, hard[2], hard[3])

    S, LAM, TV, GV = [], [], [], []
    for i, (b, sgn, m, is_x) in enumerate(groups):
        v = dx[:, 1:] if is_x else du
        gap = sgn * (v - b)
        if soft:
            t = torch.where(SM[i], torch.clamp(-gap, min=0.0) + 0.1, big)
            TV.append(t)
            GV.append(torch.where(SM[i], mu0 / t, torch.zeros_like(t)))
            gap = torch.where(SM[i], gap + t, gap)
        s = torch.where(m > 0.5, torch.clamp(gap, min=_S_MIN), big)
        S.append(s)
        LAM.append(torch.where(m > 0.5, mu0 / s, torch.zeros_like(s)))
    if warm is not None:
        _warm_blend(S, LAM, [g[2] for g in groups], warm)

    n_ineq = sum(m.sum((1, 2)) for _, _, m, _ in groups)
    if soft:
        n_ineq = n_ineq + sum(sm.float().sum((1, 2)) for sm in SM)
    n_ineq = torch.clamp(n_ineq, min=1.0)

    def comp_sum():
        acc = sum((m * S[i] * LAM[i]).sum((1, 2))
                  for i, (_, _, m, _) in enumerate(groups))
        if soft:
            acc = acc + sum(torch.where(SM[i], TV[i] * GV[i], 0.0)
                            .sum((1, 2)) for i in range(4))
        return acc

    def soft_rt_max():
        """max |z + Z t - lam - gam| over the soft rows (0 when hard)."""
        out = torch.zeros(Bsz, dtype=torch.float32, device=dev)
        if soft:
            for i in range(4):
                rt = torch.where(SM[i], ((pens[i][1] + pens[i][0] * TV[i])
                                         - LAM[i]) - GV[i], 0.0)
                out = torch.maximum(out, rt.abs().amax((1, 2)))
        return out

    def kkt(dx, du):
        """(stat, eq, req): stationarity estimate, shooting residual max
        and the residuals themselves (the next solve's `req`)."""
        req = _mv(A, dx[:, :N]) + _mv(Bm, du) + c - dx[:, 1:]
        eq = torch.clamp(req.abs().amax((1, 2)), min=0.0)
        lam = _mtv(Qt, dx[:, N]) + q[:, N] - (LAM[0][:, N - 1]
                                              - LAM[1][:, N - 1])
        base = _mtv(Qs.unsqueeze(1), dx[:, :N]) + q[:, :N]
        bnd = LAM[0] - LAM[1]
        lam_in = [None] * N
        for k in range(N - 1, -1, -1):
            lam_in[k] = lam
            lam = base[:, k] + _mtv(A[:, k], lam)
            if k >= 1:
                lam = lam - bnd[:, k - 1]
        su = (_mtv(R.unsqueeze(1), du) + r
              + _mtv(Bm, torch.stack(lam_in, 1)) - (LAM[2] - LAM[3]))
        stat = torch.clamp(su.abs().amax((1, 2)), min=0.0)
        return stat, eq, req

    def merit(st, eq):
        if soft:
            return st + eq + soft_rt_max() + comp_sum() / n_ineq
        return st + eq + comp_sum() / n_ineq

    def g_rs(i, dx, du):
        b, sgn, _, is_x = groups[i]
        v = dx[:, 1:] if is_x else du
        gap = sgn * (v - b)
        if soft:
            gap = torch.where(SM[i], gap + TV[i], gap)
        return S[i] - gap

    def g_sig(i):
        m = groups[i][2]
        return torch.clamp(m * LAM[i] / S[i], max=_SIGMA_MAX)

    def g_soft(i, Ts, Tt, rs):
        """(den, w) of the eliminated violation pair of group i: the
        barrier denominator Z + sig_s + sig_t and the right-hand-side
        scalar w for the targets (Ts, Tt); read on the soft rows only."""
        ss, t, gam = g_sig(i), TV[i], GV[i]
        Z, z = pens[i]
        den = (Z + ss) + gam / t
        r_t = ((z + Z * t) - LAM[i]) - gam
        w = ((-r_t + (Ts / S[i] - LAM[i])) + (Tt / t - gam)) + ss * rs
        return den, w

    def g_fac(i):
        """The factorization's barrier weight: sig_s, or on soft rows the
        eliminated sig_s (Z + sig_t) / (Z + sig_s + sig_t). The hard rows
        take sig_s itself: with the Z = 1e18 sentinel the formula rounds
        to sig_s only to within one ulp in float32."""
        ss = g_sig(i)
        if not soft:
            return ss
        Z, t, gam = pens[i][0], TV[i], GV[i]
        st = gam / t
        return torch.where(SM[i], ss * (Z + st) / ((Z + ss) + st), ss)

    def dirs(i, T, ddx, ddu, dx, du):
        """(ds, dlam, dt, dgam) of group i for the Newton directions
        ddx/ddu and the group's targets T = (Ts, Tt); dt, dgam are None
        for a hard solve."""
        _, sgn, m, is_x = groups[i]
        dv = sgn * (ddx[:, 1:] if is_x else ddu)
        rs = g_rs(i, dx, du)
        Ts, Tt = T
        dt = dgam = None
        if soft:
            den, w = g_soft(i, Ts, Tt, rs)
            t, gam = TV[i], GV[i]
            dt = torch.where(SM[i], (w - g_sig(i) * dv) / den, 0.0)
            dgam = torch.where(SM[i], torch.clamp(
                ((Tt - t * gam) - gam * dt) / t, -_DUAL_CLIP, _DUAL_CLIP),
                0.0)
            dv = torch.where(SM[i], dv + dt, dv)
        ds = m * (dv - rs)
        dlam = m * torch.clamp((Ts - S[i] * LAM[i] - LAM[i] * ds) / S[i],
                               -_DUAL_CLIP, _DUAL_CLIP)
        return ds, dlam, dt, dgam

    def rhs_grads(T, dx, du):
        def g_b(i):
            _, sgn, m, _ = groups[i]
            Ts, Tt = T[i]
            rs = g_rs(i, dx, du)
            b = (torch.clamp(Ts / S[i], -_SIGMA_MAX, _SIGMA_MAX)
                 + g_sig(i) * rs)
            if soft:
                den, w = g_soft(i, Ts, Tt, rs)
                b = torch.where(SM[i], b - (g_sig(i) * w) / den, b)
            return -sgn * m * b
        bx = g_b(0) + g_b(1)
        bu = g_b(2) + g_b(3)
        g_stage = _mtv(Qs.unsqueeze(1), dx[:, :N]) + q[:, :N]
        g_term = _mtv(Qt, dx[:, N]) + q[:, N]
        qr = torch.cat([g_stage[:, :1],
                        torch.cat([g_stage[:, 1:], g_term[:, None]], 1)
                        + bx], 1)
        rr = _mtv(R.unsqueeze(1), du) + r + bu
        return qr, rr

    eye_u = torch.eye(nu, dtype=torch.float32, device=dev)

    def factorize():
        sig_x = torch.clamp(g_fac(0) + g_fac(1), max=_SIGMA_MAX)
        sig_u = torch.clamp(g_fac(2) + g_fac(3), max=_SIGMA_MAX)
        P = [None] * (N + 1)
        Z = [None] * N
        Hinv = [None] * N
        P[N] = Qt + torch.diag_embed(sig_x[:, N - 1])
        for k in range(N - 1, -1, -1):
            Pn = P[k + 1]
            PA = _mtm(Pn, A[:, k])
            PB = _mtm(Pn, Bm[:, k])
            Huu = (_mtm(Bm[:, k], PB) + R + reg * eye_u
                   + torch.diag_embed(sig_u[:, k]))
            Hux = _mtm(Bm[:, k], PA)
            Hinv[k] = chol_inverse_plain(Huu)
            Z[k] = _mtm(Hinv[k], Hux)                  # Hinv Hux = -K
            Pk = Qs + _mtm(A[:, k], PA) - _mtm(Hux, Z[k])
            if k >= 1:
                Pk = Pk + torch.diag_embed(sig_x[:, k - 1])
            P[k] = 0.5 * (Pk + Pk.transpose(-1, -2))
        return P, Z, Hinv

    def solve_rhs(P, Z, Hinv, req, qr, rr):
        kff = [None] * N
        pv = qr[:, N]
        for k in range(N - 1, -1, -1):
            Pcp = _mtv(P[k + 1], req[:, k]) + pv
            Gu = rr[:, k] + _mtv(Bm[:, k], Pcp)
            kff[k] = -_mtv(Hinv[k], Gu)
            pv = qr[:, k] + _mtv(A[:, k], Pcp) - _mtv(Z[k], Gu)
        ddx = [torch.zeros_like(p.dx0)]
        ddu = []
        for k in range(N):
            d = ddx[-1]
            ddu.append(-_mv(Z[k], d) + kff[k])
            ddx.append(_mv(A[:, k], d) + _mv(Bm[:, k], ddu[-1])
                       + req[:, k])
        return torch.stack(ddx, 1), torch.stack(ddu, 1)

    def min_ratio(v, dv, tau):
        neg = dv < 0
        r_ = torch.where(neg, -tau * v / torch.where(neg, dv, -1.0), big)
        return r_.amin((1, 2))

    def alphas(T, tau, ddx, ddu, dx, du):
        a_p = torch.ones(Bsz, dtype=torch.float32, device=dev)
        a_d = torch.ones_like(a_p)
        for i in range(4):
            ds, dlam, dt, dgam = dirs(i, T[i], ddx, ddu, dx, du)
            a_p = torch.minimum(a_p, min_ratio(S[i], ds, tau))
            a_d = torch.minimum(a_d, min_ratio(LAM[i], dlam, tau))
            if soft:
                a_p = torch.minimum(a_p, min_ratio(TV[i], dt, tau))
                a_d = torch.minimum(a_d, min_ratio(GV[i], dgam, tau))
        return torch.clamp(a_p, max=1.0), torch.clamp(a_d, max=1.0)

    st0, eq0, req = kkt(dx, du)
    dx_best, du_best = dx, du
    best_merit = merit(st0, eq0)
    zero_T = [(z, z) for z in (torch.zeros_like(S[i]) for i in range(4))]

    for _ in range(iters):
        mu_cur = comp_sum() / n_ineq
        P, Z, Hinv = factorize()
        # predictor (affine scaling, target 0)
        qr, rr = rhs_grads(zero_T, dx, du)
        ddxa, ddua = solve_rhs(P, Z, Hinv, req, qr, rr)
        ap_aff, ad_aff = alphas(zero_T, 1.0, ddxa, ddua, dx, du)
        aff = [dirs(i, zero_T[i], ddxa, ddua, dx, du) for i in range(4)]
        apb, adb = ap_aff[:, None, None], ad_aff[:, None, None]
        mu_aff = sum((groups[i][2] * (S[i] + apb * ds)
                      * (LAM[i] + adb * dlam)).sum((1, 2))
                     for i, (ds, dlam, _, _) in enumerate(aff))
        if soft:
            mu_aff = mu_aff + sum(
                torch.where(SM[i], (TV[i] + apb * dt) * (GV[i] + adb * dg),
                            0.0).sum((1, 2))
                for i, (_, _, dt, dg) in enumerate(aff))
        mu_aff = mu_aff / n_ineq
        ratio = mu_aff / torch.clamp(mu_cur, min=_MU_MIN)
        sigma = torch.clamp(ratio * ratio * ratio, 0.0, 1.0)
        mu_t = torch.clamp(sigma * mu_cur, min=_MU_MIN)[:, None, None]

        # corrector with Gondzio-clipped Mehrotra targets
        def clip_t(a, b):
            return _clip(mu_t - a * b, 0.05 * mu_t, 20.0 * mu_t)
        T = [(clip_t(ds, dlam), clip_t(dt, dg) if soft else None)
             for ds, dlam, dt, dg in aff]
        qr, rr = rhs_grads(T, dx, du)
        ddx, ddu = solve_rhs(P, Z, Hinv, req, qr, rr)
        a_p, a_d = alphas(T, alpha_frac, ddx, ddu, dx, du)
        apb, adb = a_p[:, None, None], a_d[:, None, None]
        # update (stage-0 state pinned)
        steps = [dirs(i, T[i], ddx, ddu, dx, du) for i in range(4)]
        for i, (ds, dlam, dt, dg) in enumerate(steps):
            S[i] = torch.clamp(S[i] + apb * ds, min=_EPS_S)
            LAM[i] = torch.clamp(LAM[i] + adb * dlam, 0.0, _LAM_MAX)
            if soft:
                TV[i] = torch.where(SM[i], torch.clamp(TV[i] + apb * dt,
                                                       min=_EPS_S), TV[i])
                GV[i] = torch.where(SM[i], torch.clamp(GV[i] + adb * dg,
                                                       0.0, _LAM_MAX), GV[i])
        dx = torch.cat([dx[:, :1], dx[:, 1:] + apb * ddx[:, 1:]], 1)
        du = du + apb * ddu
        st, eq, req = kkt(dx, du)
        m_ = merit(st, eq)
        better = m_ < best_merit
        dx_best = torch.where(better[:, None, None], dx, dx_best)
        du_best = torch.where(better[:, None, None], du, du_best)
        best_merit = torch.where(better, m_, best_merit)

    # final diagnostics on the returned (best) iterate, last-iterate duals
    stf, eqf, _ = kkt(dx_best, du_best)
    stf = torch.where(torch.isfinite(stf), torch.minimum(stf, best_merit),
                      best_merit)
    return QPSolution(dx=dx_best, du=du_best, kkt_stat=stf, kkt_eq=eqf,
                      mu=best_merit,
                      lam_lx=LAM[0], lam_ux=LAM[1], lam_lu=LAM[2],
                      lam_uu=LAM[3],
                      s_lx=S[0], s_ux=S[1], s_lu=S[2], s_uu=S[3])


class _Fused(NamedTuple):
    """The iterate and spec rows the fused modes assemble their QP from,
    float32 and contiguous, absolute boxes sanitized."""
    xbar: torch.Tensor  # (B, N+1, nx)
    ubar: torch.Tensor  # (B, N, nu)
    x0: torch.Tensor    # (B, nx)
    Qs: torch.Tensor    # (B, nx, nx)  dt-scaled stage Hessian
    Qt: torch.Tensor    # (B, nx, nx)  terminal Hessian (unscaled)
    R: torch.Tensor     # (B, nu, nu)  dt-scaled Hessian R
    Rg: torch.Tensor    # (B, nu, nu)  R of the cost gradient
    yrx: torch.Tensor   # (B, N, nx)
    yru: torch.Tensor   # (B, N, nu)
    yre: torch.Tensor   # (B, nx)
    lbx: torch.Tensor   # (B, nx)      single-row absolute boxes
    ubx: torch.Tensor
    lbu: torch.Tensor   # (B, nu)
    ubu: torch.Tensor


def _fused_prep(xbar, ubar, x0, Q, Q_t, R, yref_x, yref_u, yref_e, lbx, ubx,
                lbu, ubu, R_grad) -> _Fused:
    f32 = _f32
    return _Fused(
        xbar=f32(xbar), ubar=f32(ubar), x0=f32(x0), Qs=f32(Q), Qt=f32(Q_t),
        R=f32(R), Rg=f32(R if R_grad is None else R_grad),
        yrx=f32(yref_x), yru=f32(yref_u), yre=f32(yref_e),
        lbx=_san(lbx, True), ubx=_san(ubx, False), lbu=_san(lbu, True),
        ubu=_san(ubu, False))


def _fused_qp(f: _Fused, A, Bm, c) -> QPData:
    """`build_qp`'s delta-form QP from the fused inputs, as the kernel's
    assembly computes it: q_k = Qs' (xbar_k - yref_k), q_N with the
    unscaled Qt, r_k = Rg' (ubar_k - yref_u,k), delta bounds = sanitized
    absolute box - iterate, dx0 = x0 - xbar_0."""
    Bsz, N = f.ubar.shape[0], f.ubar.shape[1]
    q = torch.cat([_mtv(f.Qs.unsqueeze(1), f.xbar[:, :N] - f.yrx),
                   _mtv(f.Qt, f.xbar[:, N] - f.yre).unsqueeze(1)], 1)
    r = _mtv(f.Rg.unsqueeze(1), f.ubar - f.yru)
    return QPData(
        A=A, B=Bm, c=c,
        Q=torch.cat([f.Qs.unsqueeze(1).expand(Bsz, N, *f.Qs.shape[1:]),
                     f.Qt.unsqueeze(1)], 1),
        q=q, R=f.R.unsqueeze(1).expand(Bsz, N, *f.R.shape[1:]), r=r,
        lbx=f.lbx.unsqueeze(1) - f.xbar, ubx=f.ubx.unsqueeze(1) - f.xbar,
        lbu=f.lbu.unsqueeze(1) - f.ubar, ubu=f.ubu.unsqueeze(1) - f.ubar,
        dx0=f.x0 - f.xbar[:, 0])


def _tick_diag(f: _Fused, sol: QPSolution):
    """(new xbar, new ubar, diag dict) of the fuse_cost mode from a delta
    solution: step norms over every stage (stage 0 included) and the worst
    box violation of the new iterate (a sanitized box never counts)."""
    xn, un = f.xbar + sol.dx, f.ubar + sol.du
    vio = torch.maximum(
        torch.maximum(f.lbx.unsqueeze(1) - xn, xn - f.ubx.unsqueeze(1))
        .amax((1, 2)),
        torch.maximum(f.lbu.unsqueeze(1) - un, un - f.ubu.unsqueeze(1))
        .amax((1, 2)))
    diag = {"kkt_stat": sol.kkt_stat, "kkt_eq": sol.kkt_eq, "mu": sol.mu,
            "step_norm_x": sol.dx.abs().amax((1, 2)),
            "step_norm_u": sol.du.abs().amax((1, 2)),
            "bound_viol": torch.clamp(vio, min=0.0)}
    return xn, un, diag


def batched_fused_tick_plain(AB, c, xbar, ubar, x0, Q, Q_t, R, yref_x,
                             yref_u, yref_e, lbx, ubx, lbu, ubu,
                             iters: int = 6, mu0: float = 1e-1,
                             alpha_frac: float = 0.995, reg: float = 1e-6,
                             warm=None, R_grad=None):
    """Eager PyTorch twin of the fuse_cost kernel: the kernel's assembly
    on the host, `box_qp_solve_plain`, then the update and diagnostics.
    Same arguments and result as `batched_fused_tick`."""
    f = _fused_prep(xbar, ubar, x0, Q, Q_t, R, yref_x, yref_u, yref_e, lbx,
                    ubx, lbu, ubu, R_grad)
    nx = f.xbar.shape[-1]
    AB = _f32(AB)
    qp = _fused_qp(f, AB[..., :nx], AB[..., nx:], _f32(c))
    sol = box_qp_solve_plain(qp, iters=iters, mu0=mu0,
                             alpha_frac=alpha_frac, reg=reg, warm=warm)
    xn, un, diag = _tick_diag(f, sol)
    return xn, un, diag, sol._replace(dx=xn, du=un)


def _model_params(model, device):
    """BlasterParams (float32) from `fused_dyn_statics`' model tuple
    (family, mass, g, arm_x, arm_y, yaw_c, Jx, Jy, Jz)."""
    mass, g, ax, ay, yaw = capture.filled(model[1:6], torch.float32, device)
    return BlasterParams(mass=mass, gravity=g, arm_length_x=ax,
                         arm_length_y=ay, yaw_coefficient=yaw,
                         inertia=capture.filled(model[6:9], torch.float32,
                                                device))


def fused_rti_solve_plain(xbar, ubar, stage_params, x0, Q, Q_t, R, yref_x,
                          yref_u, yref_e, lbx, ubx, lbu, ubu, model: tuple,
                          dt: float, num_steps: int = 1, iters: int = 6,
                          mu0: float = 1e-1, alpha_frac: float = 0.995,
                          reg: float = 1e-6, warm=None, soft=None,
                          R_grad=None, return_lin: bool = False, skip=None):
    """Eager PyTorch twin of the fuse_lin kernel: the prologue's twin
    (`fused_lin_prologue_plain`), the kernel's assembly on the host and
    the plain solve. Same arguments and
    result as `fused_rti_solve` (`skip` is ignored: the twin always
    computes)."""
    _check_soft_warm(soft, warm)
    _check_fused_rti(x0, model, stage_params)
    f = _fused_prep(xbar, ubar, x0, Q, Q_t, R, yref_x, yref_u, yref_e, lbx,
                    ubx, lbu, ubu, R_grad)
    A, Bm, c = fused_lin_prologue_plain(f.xbar, f.ubar, stage_params, model,
                                        dt, num_steps)
    sol = _solve_plain(_prep(_fused_qp(f, A, Bm, c)), iters, mu0,
                       alpha_frac, reg, warm,
                       _fused_soft_rows(soft, lbx, ubx, lbu, ubu, f))
    return (sol, (A, Bm, c)) if return_lin else sol


def _fused_soft_rows(soft, lbx, ubx, lbu, ubu, f: _Fused):
    """Penalty rows of the fused modes: the single-row absolute boxes
    (finite where their delta twins are) broadcast over the stages."""
    Bsz, N = f.ubar.shape[0], f.ubar.shape[1]
    return _soft_rows(soft, [b.unsqueeze(1).expand(Bsz, N, b.shape[-1])
                             for b in (lbx, ubx, lbu, ubu)])


def _check_fused_rti(x0, model, stage_params):
    if x0.ndim != 2 or x0.shape[0] < 1:
        raise ValueError("fused_rti_solve takes a batch of B >= 1 problems "
                         f"with x0 (B, nx) (got {tuple(x0.shape)})")
    if model[0] not in FAMILY_IDS:
        raise ValueError(f"unknown model family {model[0]!r} (expected one "
                         f"of {sorted(FAMILY_IDS)})")
    if stage_params.shape[-1] < FAMILY_NP[model[0]]:
        raise ValueError(f"family {model[0]!r} reads {FAMILY_NP[model[0]]} "
                         f"stage parameters (got {stage_params.shape[-1]})")


def _check_built(nx: int, nu: int, mode: int, family=None, soft=False):
    """Refuse a combination csrc/box_qp_ipm.cu does not instantiate."""
    if (nx, nu, mode, family, bool(soft)) not in BUILT:
        what = (f"nx={nx}, nu={nu}"
                + ("" if family is None else f", family {family!r}")
                + (", soft bounds" if soft else ""))
        raise NotImplementedError(
            f"the CUDA box-QP IPM has no {_MODE_NAMES[mode]} instantiation "
            f"for {what}; no path of the port uses one yet: ROADMAP queue 2 "
            "(instantiations not built) adds it")


def _check_stream(stream_p, stream_big):
    for name, v in (("stream_p", stream_p), ("stream_big", stream_big)):
        if v is not None and not isinstance(v, bool):
            raise TypeError(f"{name} is a bool or None (got {v!r})")


# ------------------------------- the kernel -------------------------------

def build_library():
    """Compile `csrc/box_qp_ipm.cu` with nvcc into `build/` (rebuilt when
    the source or flags change). Returns (path, seconds, compiler log);
    seconds is 0.0 when an up-to-date build already existed."""
    return nvcc_build.build(SOURCE, "libbox_qp_ipm")


@functools.cache
def _library() -> ctypes.CDLL:
    so, _, _ = build_library()
    return _bind(ctypes.CDLL(str(so)))


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of the built library."""
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    # each entry ends its pointers with the warm start (valid + 8 fields)
    # and the skip flag; the plain and fuse_lin entries then take the
    # eight soft penalty rows (null: a hard solve); then B, N and the
    # model's dimensions (fuse_lin: np and the family, which fixes them)
    lib.box_qp_ipm_solve.argtypes = ([ptr] * 43 + [i32] * 5 + [f32] * 3
                                     + [ptr])
    lib.box_qp_ipm_fused_cost.argtypes = ([ptr] * 39 + [i32] * 5
                                          + [f32] * 3 + [ptr])
    lib.box_qp_ipm_fused_lin.argtypes = ([ptr] * 46 + [i32] * 5
                                         + [f32] * 14 + [i32, ptr])
    for fn in (lib.box_qp_ipm_solve, lib.box_qp_ipm_fused_cost,
               lib.box_qp_ipm_fused_lin):
        fn.restype = i32
    lib.box_qp_ipm_workspace_floats.argtypes = [i32] * 5
    lib.box_qp_ipm_workspace_floats.restype = ctypes.c_longlong
    lib.box_qp_ipm_lin_floats.argtypes = [i32] * 3
    lib.box_qp_ipm_lin_floats.restype = ctypes.c_longlong
    lib.box_qp_ipm_error_string.argtypes = [i32]
    lib.box_qp_ipm_error_string.restype = ctypes.c_char_p
    lib.box_qp_ipm_plan.argtypes = [i32] * 6 + [ptr] * 4
    lib.box_qp_ipm_plan.restype = i32
    lib.box_qp_ipm_smem_optin.argtypes = []
    lib.box_qp_ipm_smem_optin.restype = ctypes.c_longlong
    lib.box_qp_ipm_set_optin.argtypes = [i32] * 5
    lib.box_qp_ipm_set_optin.restype = i32
    lib.box_qp_ipm_kernel_attrs.argtypes = ([i32] * 5 + [ctypes.c_longlong]
                                            + [i32] + [ptr] * 3)
    lib.box_qp_ipm_kernel_attrs.restype = i32
    return lib


def library_plan(N: int, mode: int, soft: bool, nx: int, nu: int, B: int
                 ) -> LaunchPlan:
    """The built library's own plan (`box_qp_ipm_plan`); equals
    `launch_plan`."""
    lib = _library()
    th, res, pro = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    smem = ctypes.c_longlong()
    rc = lib.box_qp_ipm_plan(N, mode, int(soft), nx, nu, B,
                             ctypes.byref(th), ctypes.byref(smem),
                             ctypes.byref(res), ctypes.byref(pro))
    _launched(lib, rc, "box_qp_ipm_plan")
    return LaunchPlan(th.value, smem.value, bool(res.value), pro.value)


_OPTED_IN: set = set()   # (instantiation, device index) opted in


def _optin(lib, dev, mode, soft, nx, nu, family):
    """Opt the instantiation in to SMEM_OPTIN bytes of dynamic shared
    memory on `dev`, once; raise if the runtime refuses."""
    key = (mode, bool(soft), nx, nu, family, dev.index)
    if key in _OPTED_IN:
        return
    fam = FAMILY_IDS[family] if family is not None else 0
    with torch.cuda.device(dev):
        rc = lib.box_qp_ipm_set_optin(mode, int(soft), nx, nu, fam)
    if rc != 0:
        raise RuntimeError(
            f"box_qp_ipm: the {SMEM_OPTIN} B shared-memory opt-in of "
            f"{instance_name(nx, nu, family, soft)} {_MODE_NAMES[mode]} was "
            "refused: " + lib.box_qp_ipm_error_string(rc).decode())
    _OPTED_IN.add(key)


def kernel_info(N: int, mode: int, nx: int, nu: int, family=None,
                soft: bool = False, device=None, *, B: int) -> dict:
    """The launch of an instantiation for B problems at horizon N on a
    CUDA device: its plan ("single" or "batch"; layout, threads, dynamic
    shared bytes, the prologue grid's blocks; for a soft instantiation
    where its soft area lives, "shared" or "global") and the plan's
    compiled solve kernel's registers per thread, local (stack) bytes and
    blocks per SM at that shared memory
    (`cudaOccupancyMaxActiveBlocksPerMultiprocessor`)."""
    _check_built(nx, nu, mode, family, soft)
    dev = torch.device(device if device is not None else "cuda")
    if dev.type != "cuda":
        raise ValueError(f"kernel_info reads a CUDA device, not {dev}")
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    plan = _require_plan(launch_plan(N, mode, soft, nx, nu, B))
    lib = _library()
    _optin(lib, dev, mode, soft, nx, nu, family)
    regs, local, blocks = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    fam = FAMILY_IDS[family] if family is not None else 0
    with torch.cuda.device(dev):
        rc = lib.box_qp_ipm_kernel_attrs(
            mode, int(soft), nx, nu, fam, plan.smem_bytes, B,
            ctypes.byref(regs), ctypes.byref(local), ctypes.byref(blocks))
    _launched(lib, rc, "box_qp_ipm_kernel_attrs")
    hard = launch_plan(N, mode, False, nx, nu, B)
    area = (None if not soft else
            "shared" if plan.smem_bytes > hard.smem_bytes else "global")
    return {"plan": plan.kind,
            "layout": plan.layout, "threads": plan.threads,
            "smem_bytes": plan.smem_bytes,
            "prologue_blocks": plan.prologue_blocks, "soft_area": area,
            "registers": regs.value, "local_bytes": local.value,
            "blocks_per_sm": blocks.value}


def _stream(dev: torch.device) -> int:
    """The caller's current CUDA stream on `dev`, as a pointer value."""
    with torch.cuda.device(dev):
        return torch.cuda.current_stream(dev).cuda_stream


def _launched(lib, rc: int, what: str):
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: "
                           + lib.box_qp_ipm_error_string(rc).decode())


def _check_shapes(tensors: NamedTuple, shapes: dict, dev):
    for name, shape in shapes.items():
        t = getattr(tensors, name)
        if t.device != dev or tuple(t.shape) != shape:
            raise ValueError(f"field {name}: {tuple(t.shape)} on {t.device},"
                             f" expected {shape} on {dev}")


def _solve_outputs(lib, Bsz, N, nx, nu, mode, dev, soft=False):
    """Fresh output tensors of one launch: dx, du, diag, the slacks/duals
    (slx sux llx lux, slu suu llu luu) and the workspace (which holds the
    soft area of a soft solve where it is not in shared memory)."""
    def empty(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)
    return (empty(Bsz, N + 1, nx), empty(Bsz, N, nu), empty(Bsz, 6),
            [empty(Bsz, N, nx) for _ in range(4)],
            [empty(Bsz, N, nu) for _ in range(4)],
            empty(Bsz, int(lib.box_qp_ipm_workspace_floats(
                N, mode, int(soft), nx, nu))))


def _warm_args(warm, Bsz, N, nx, nu, dev) -> list:
    """(valid, the eight warm fields) as contiguous float32 tensors for a
    launch, shape-checked; nine Nones for a cold solve."""
    if warm is None:
        return [None] * 9
    ts = [_f32(warm.valid)] + [_f32(getattr(warm, f)) for f in _WARM_FIELDS]
    want = [(Bsz,)] + [(Bsz, N, nx)] * 4 + [(Bsz, N, nu)] * 4
    for name, t, shape in zip(("valid",) + _WARM_FIELDS, ts, want):
        if t.device != dev or tuple(t.shape) != shape:
            raise ValueError(f"warm.{name}: {tuple(t.shape)} on {t.device},"
                             f" expected {shape} on {dev}")
    return ts


def _skip_arg(skip, dev):
    """The launch's skip flag as a one-byte bool tensor on `dev` (or None)."""
    if skip is None:
        return None
    t = skip.to(torch.bool).reshape(-1).contiguous()
    if t.device != dev or t.numel() != 1:
        raise ValueError(f"skip: {tuple(skip.shape)} on {skip.device}, "
                         f"expected one element on {dev}")
    return t


def _ptrs(ts) -> list:
    return [None if t is None else t.data_ptr() for t in ts]


def instance_name(nx: int, nu: int, family=None, soft=False) -> str:
    """The key of an instantiation in a wrapper's `by_instance` counts,
    e.g. "17x6", "17x6 soft", "13x4 quad13"."""
    return (f"{nx}x{nu}" + ("" if family is None else f" {family}")
            + (" soft" if soft else ""))


def _count_prologue():
    fused_lin_prologue.launches += 1


def _count(wrapper, warm, inst, plan: LaunchPlan):
    """Count one launch on the wrapper, and the prologue grid launched
    before it where the plan has one (`fused_lin_prologue.launches`);
    under a CUDA graph capture the counts are recorded and added on each
    replay (`utils/capture.py`)."""
    def apply():
        wrapper.launches += 1
        wrapper.by_instance[inst] = wrapper.by_instance.get(inst, 0) + 1
        wrapper.by_layout[plan.key] = wrapper.by_layout.get(plan.key, 0) + 1
        if warm is not None:
            wrapper.warm_launches += 1
        if plan.prologue_blocks:
            _count_prologue()
    capture.launched(apply)


def _prepare_launch(lib, dev, N, mode, soft, nx, nu, B, family=None
                    ) -> LaunchPlan:
    """The launch's plan, checked, with the instantiation opted in."""
    plan = _require_plan(launch_plan(N, mode, soft, nx, nu, B))
    _optin(lib, dev, mode, soft, nx, nu, family)
    return plan


def _soft_args(pens, Bsz, N, nx, nu, dev) -> list:
    """The eight penalty rows (Z, z of lx, ux, lu, uu) of a launch,
    shape-checked; eight Nones for a hard solve."""
    if pens is None:
        return [None] * 8
    ts = [a for pair in pens for a in pair]
    for i, t in enumerate(ts):
        shape = (Bsz, N, nx if i < 4 else nu)
        if t.device != dev or tuple(t.shape) != shape:
            raise ValueError(f"soft penalty row {i}: {tuple(t.shape)} on "
                             f"{t.device}, expected {shape} on {dev}")
    return ts


def _solution(dx, du, diag, sx, su) -> QPSolution:
    return QPSolution(dx=dx, du=du, kkt_stat=diag[:, 0], kkt_eq=diag[:, 1],
                      mu=diag[:, 2],
                      lam_lx=sx[2], lam_ux=sx[3], lam_lu=su[2], lam_uu=su[3],
                      s_lx=sx[0], s_ux=sx[1], s_lu=su[0], s_uu=su[1])


def _fused_shapes(Bsz, N, nx, nu):
    return dict(xbar=(Bsz, N + 1, nx), ubar=(Bsz, N, nu), x0=(Bsz, nx),
                Qs=(Bsz, nx, nx), Qt=(Bsz, nx, nx), R=(Bsz, nu, nu),
                Rg=(Bsz, nu, nu), yrx=(Bsz, N, nx), yru=(Bsz, N, nu),
                yre=(Bsz, nx), lbx=(Bsz, nx), ubx=(Bsz, nx), lbu=(Bsz, nu),
                ubu=(Bsz, nu))


def _solve_kernel(data: QPData, iters: int, mu0: float, alpha_frac: float,
                  reg: float, warm, skip, soft) -> QPSolution:
    p = _prep(data)
    Bsz, N, nx, nu = p.A.shape[0], p.A.shape[1], p.A.shape[-1], \
        p.Bm.shape[-1]
    if Bsz == 0 or N < 1:
        raise ValueError(f"empty QP batch (B={Bsz}, N={N})")
    dev = p.A.device
    _check_shapes(p, dict(
        A=(Bsz, N, nx, nx), Bm=(Bsz, N, nx, nu), c=(Bsz, N, nx),
        Qs=(Bsz, nx, nx), Qt=(Bsz, nx, nx), q=(Bsz, N + 1, nx),
        R=(Bsz, nu, nu), r=(Bsz, N, nu), lbx=(Bsz, N, nx), ubx=(Bsz, N, nx),
        lbu=(Bsz, N, nu), ubu=(Bsz, N, nu), dx0=(Bsz, nx)), dev)
    pens = _soft_rows(soft, _qp_bounds(data))
    lib = _library()
    plan = _prepare_launch(lib, dev, N, PLAIN, soft is not None, nx, nu,
                           Bsz)
    dx, du, diag, sx, su, work = _solve_outputs(lib, Bsz, N, nx, nu, PLAIN,
                                                dev, soft is not None)
    # held until the launch is enqueued
    wa = [*_warm_args(warm, Bsz, N, nx, nu, dev), _skip_arg(skip, dev),
          *_soft_args(pens, Bsz, N, nx, nu, dev)]
    rc = lib.box_qp_ipm_solve(
        *_ptrs([*p, dx, du, diag, *sx, *su, work, *wa]),
        Bsz, N, nx, nu, iters, mu0, alpha_frac, reg, _stream(dev))
    _launched(lib, rc, "box_qp_ipm")
    _count(box_qp_solve, warm, instance_name(nx, nu, soft=soft is not None),
           plan)
    return _solution(dx, du, diag, sx, su)


def box_qp_solve(data: QPData, iters: int = 12, mu0: float = 1e-1,
                 alpha_frac: float = 0.995, reg: float = 1e-6, warm=None,
                 skip=None, soft=None, stream_p: bool | None = None,
                 stream_big: bool | None = None) -> QPSolution:
    """Batched box-QP IPM solve; the counterpart of `pallas_box_qp_solve`.

    `data` fields carry a leading batch axis (B, ...), for a model of a
    built instantiation (`BUILT`: 17x6, or 13x4 hard). Stage Hessians
    must be identical across stages 0..N-1 (Q[:, 0], R[:, 0] are used)
    with a distinct terminal Q[:, N]; bounds may be +-inf. `warm`, `skip`
    and `soft` as in the module docstring. `stream_p` / `stream_big`
    (bool or None) are `pallas_box_qp_solve`'s long-horizon switches,
    accepted so that its callers run unchanged; they select nothing: N
    chooses the layout (`launch_plan`), so the port's ticks do not pass
    `SolverConfig.pallas_stream_*` on. Tensors on a CUDA device run the
    hand-written kernel (one launch; counted in `box_qp_solve.launches`);
    tensors on the CPU run the plain twin.
    """
    _check_soft_warm(soft, warm)
    _check_stream(stream_p, stream_big)
    _check_built(data.A.shape[-1], data.B.shape[-1], PLAIN,
                 soft=soft is not None)
    dev = data.A.device
    if dev.type == "cuda":
        return _solve_kernel(data, iters, mu0, alpha_frac, reg, warm, skip,
                             soft)
    if dev.type == "cpu":
        return box_qp_solve_plain(data, iters=iters, mu0=mu0,
                                  alpha_frac=alpha_frac, reg=reg, warm=warm,
                                  soft=soft)
    raise ValueError(f"box_qp_solve runs on cuda or cpu tensors, "
                     f"not {dev.type}")


box_qp_solve.launches = 0
box_qp_solve.warm_launches = 0
box_qp_solve.by_layout = {}   # launches per LaunchPlan.key
box_qp_solve.by_instance = {}    # launches per instantiation (instance_name)


def _fused_cost_kernel(AB, c, f: _Fused, iters, mu0, alpha_frac, reg,
                       warm):
    Bsz, N, nx, nu = f.ubar.shape[0], f.ubar.shape[1], f.xbar.shape[-1], \
        f.ubar.shape[-1]
    if Bsz == 0 or N < 1:
        raise ValueError(f"empty batch (B={Bsz}, N={N})")
    dev = f.x0.device
    _check_shapes(f, _fused_shapes(Bsz, N, nx, nu), dev)
    if AB.device != dev or tuple(AB.shape) != (Bsz, N, nx, nx + nu) \
            or tuple(c.shape) != (Bsz, N, nx) or c.device != dev:
        raise ValueError(f"AB {tuple(AB.shape)} / c {tuple(c.shape)} do "
                         f"not match B={Bsz}, N={N} on {dev}")
    A, Bm = _f32(AB[..., :nx]), _f32(AB[..., nx:])
    lib = _library()
    plan = _prepare_launch(lib, dev, N, FUSE_COST, False, nx, nu, Bsz)
    xn, un, diag, sx, su, work = _solve_outputs(lib, Bsz, N, nx, nu,
                                                FUSE_COST, dev)
    ins = [A, Bm, _f32(c), f.xbar, f.ubar, f.x0, f.Qs, f.Qt, f.R, f.Rg,
           f.yrx, f.yru, f.yre, f.lbx, f.ubx, f.lbu, f.ubu]
    wa = [*_warm_args(warm, Bsz, N, nx, nu, dev), None]
    rc = lib.box_qp_ipm_fused_cost(
        *_ptrs([*ins, xn, un, diag, *sx, *su, work, *wa]),
        Bsz, N, nx, nu, iters, mu0, alpha_frac, reg, _stream(dev))
    _launched(lib, rc, "box_qp_ipm fuse_cost")
    _count(batched_fused_tick, warm, instance_name(nx, nu), plan)
    dg = {"kkt_stat": diag[:, 0], "kkt_eq": diag[:, 1], "mu": diag[:, 2],
          "step_norm_x": diag[:, 3], "step_norm_u": diag[:, 4],
          "bound_viol": diag[:, 5]}
    return xn, un, dg, _solution(xn, un, diag, sx, su)


def batched_fused_tick(AB, c, xbar, ubar, x0, Q, Q_t, R, yref_x, yref_u,
                       yref_e, lbx, ubx, lbu, ubu, iters: int = 6,
                       mu0: float = 1e-1, alpha_frac: float = 0.995,
                       reg: float = 1e-6, warm=None, R_grad=None):
    """The batched RTI tick body with in-kernel QP assembly and iterate
    update; the counterpart of `pallas_batched_fused_tick`.

    Arguments (leading batch axis B everywhere; shared spec tensors may be
    broadcast views): AB (B, N, nx, nx+nu) packed [A | B]; c (B, N, nx)
    shooting defects; xbar (B, N+1, nx), ubar (B, N, nu), x0 (B, nx);
    Q / R dt-scaled stage Hessians (B, nx, nx) / (B, nu, nu), Q_t the
    unscaled terminal one; yref_x (B, N, nx), yref_u (B, N, nu),
    yref_e (B, nx); lbx/ubx (B, nx), lbu/ubu (B, nu) single-row absolute
    boxes (+-inf allowed); R_grad (B, nu, nu) the R of the cost gradient
    when `qp_r_floor` makes it differ from the Hessian R; `warm` as in the
    module docstring.

    Returns (new_xbar, new_ubar, diag dict with kkt_stat / kkt_eq / mu /
    step_norm_x / step_norm_u / bound_viol per problem, QPSolution whose
    dx/du ARE the updated absolute iterate). CUDA tensors run the kernel
    (one launch, counted in `batched_fused_tick.launches`); CPU tensors the
    plain twin.
    """
    _check_built(xbar.shape[-1], ubar.shape[-1], FUSE_COST)
    dev = x0.device
    if dev.type == "cuda":
        f = _fused_prep(xbar, ubar, x0, Q, Q_t, R, yref_x, yref_u, yref_e,
                        lbx, ubx, lbu, ubu, R_grad)
        return _fused_cost_kernel(AB, c, f, iters, mu0, alpha_frac, reg,
                                  warm)
    if dev.type == "cpu":
        return batched_fused_tick_plain(
            AB, c, xbar, ubar, x0, Q, Q_t, R, yref_x, yref_u, yref_e, lbx,
            ubx, lbu, ubu, iters=iters, mu0=mu0, alpha_frac=alpha_frac,
            reg=reg, warm=warm, R_grad=R_grad)
    raise ValueError(f"batched_fused_tick runs on cuda or cpu tensors, "
                     f"not {dev.type}")


batched_fused_tick.launches = 0
batched_fused_tick.warm_launches = 0
batched_fused_tick.by_layout = {}   # launches per LaunchPlan.key
batched_fused_tick.by_instance = {}


def _fused_lin_kernel(stage_params, f: _Fused, model, dt, num_steps, iters,
                      mu0, alpha_frac, reg, return_lin, warm, skip, pens):
    Bsz, N, nx, nu = f.ubar.shape[0], f.ubar.shape[1], f.xbar.shape[-1], \
        f.ubar.shape[-1]
    if N < 1 or num_steps < 1:
        raise ValueError(f"empty horizon or substeps (N={N}, "
                         f"num_steps={num_steps})")
    dev = f.x0.device
    _check_shapes(f, _fused_shapes(Bsz, N, nx, nu), dev)
    sp = _f32(stage_params)
    np_min = FAMILY_NP[model[0]]
    if sp.device != dev or sp.ndim != 3 or tuple(sp.shape[:2]) != (Bsz, N) \
            or sp.shape[2] < np_min:
        raise ValueError(f"stage_params {tuple(sp.shape)} on {sp.device}: "
                         f"expected ({Bsz}, {N}, >={np_min}) on {dev}")
    lib = _library()
    plan = _prepare_launch(lib, dev, N, FUSE_LIN, pens is not None, nx, nu,
                           Bsz, model[0])
    dx, du, diag, sx, su, work = _solve_outputs(lib, Bsz, N, nx, nu,
                                                FUSE_LIN, dev,
                                                pens is not None)
    lin = (torch.empty((Bsz, int(lib.box_qp_ipm_lin_floats(N, nx, nu))),
                       dtype=torch.float32, device=dev)
           if return_lin else None)
    # the float32 roundings of the constants the Python linearizer uses
    h = dt / num_steps
    consts = [float(np.float32(v)) for v in (
        1.0 / model[1], model[2], model[3], model[4], model[5], model[6],
        model[7], model[8], h, 0.5 * h, h / 6.0)]
    ins = [f.xbar, f.ubar, sp, f.x0, f.Qs, f.Qt, f.R, f.Rg, f.yrx, f.yru,
           f.yre, f.lbx, f.ubx, f.lbu, f.ubu]
    wa = [*_warm_args(warm, Bsz, N, nx, nu, dev), _skip_arg(skip, dev),
          *_soft_args(pens, Bsz, N, nx, nu, dev)]
    rc = lib.box_qp_ipm_fused_lin(
        *_ptrs([*ins, dx, du, diag, *sx, *su, lin, work, *wa]),
        Bsz, N, sp.shape[2], FAMILY_IDS[model[0]], iters, mu0, alpha_frac,
        reg, *consts, num_steps, _stream(dev))
    _launched(lib, rc, "box_qp_ipm fuse_lin")
    if iters == PROLOGUE_ONLY:
        capture.launched(_count_prologue)
    else:
        _count(fused_rti_solve, warm,
               instance_name(nx, nu, model[0], pens is not None), plan)
    sol = _solution(dx, du, diag, sx, su)
    if not return_lin:
        return sol
    nA, nB = N * nx * nx, N * nx * nu
    return sol, (lin[:, :nA].view(Bsz, N, nx, nx),
                 lin[:, nA:nA + nB].view(Bsz, N, nx, nu),
                 lin[:, nA + nB:].view(Bsz, N, nx))


def fused_rti_solve(xbar, ubar, stage_params, x0, Q, Q_t, R, yref_x, yref_u,
                    yref_e, lbx, ubx, lbu, ubu, model: tuple, dt: float,
                    num_steps: int = 1, iters: int = 6, mu0: float = 1e-1,
                    alpha_frac: float = 0.995, reg: float = 1e-6, warm=None,
                    soft=None, R_grad=None, return_lin: bool = False,
                    skip=None):
    """The one-launch RTI QP solve: RK4 linearization (A, B, c of every
    node), the cost gradients, delta bounds and dx0 all happen inside the
    IPM kernel; the counterpart of `pallas_fused_rti_solve`.

    Arguments (leading batch axis B >= 1 everywhere, one thread block per
    problem; B > 1 is the Pallas kernel under `jax.vmap`, each problem
    with its own rows of every argument): xbar (B, N+1, nx),
    ubar (B, N, nu), stage_params (B, N, np) the linearization point and
    the 25-dim POC parameters; x0 (B, nx); Q / R dt-scaled, Q_t unscaled;
    yref_x (B, N, nx), yref_u (B, N, nu), yref_e (B, nx); lbx/ubx (B, nx),
    lbu/ubu (B, nu) single-row absolute boxes (+-inf allowed); `model` the
    tuple of `sqp/rti.py::fused_dyn_statics` (family "blaster", hard or
    soft; "blaster_dist", whose stage_params carry the six disturbance
    rows 25-30, hard; or `models/quad13.py::quad13_dyn_statics`' "quad13",
    13x4, hard), dt and the RK4 substep count; R_grad as in `batched_fused_tick`; `warm`
    and `skip` as in the module docstring.

    Returns the delta-form QPSolution (and, with return_lin, the (A, B, c)
    the linearization built). CUDA tensors run the kernel (one launch,
    counted in `fused_rti_solve.launches`); CPU tensors the plain twin.
    """
    _check_soft_warm(soft, warm)
    _check_fused_rti(x0, model, stage_params)
    _check_built(xbar.shape[-1], ubar.shape[-1], FUSE_LIN, model[0],
                 soft is not None)
    dev = x0.device
    if dev.type == "cuda":
        f = _fused_prep(xbar, ubar, x0, Q, Q_t, R, yref_x, yref_u, yref_e,
                        lbx, ubx, lbu, ubu, R_grad)
        return _fused_lin_kernel(
            stage_params, f, model, dt, num_steps, iters, mu0, alpha_frac,
            reg, return_lin, warm, skip,
            _fused_soft_rows(soft, lbx, ubx, lbu, ubu, f))
    if dev.type == "cpu":
        return fused_rti_solve_plain(
            xbar, ubar, stage_params, x0, Q, Q_t, R, yref_x, yref_u, yref_e,
            lbx, ubx, lbu, ubu, model, dt, num_steps=num_steps, iters=iters,
            mu0=mu0, alpha_frac=alpha_frac, reg=reg, warm=warm, soft=soft,
            R_grad=R_grad, return_lin=return_lin)
    raise ValueError(f"fused_rti_solve runs on cuda or cpu tensors, "
                     f"not {dev.type}")


fused_rti_solve.launches = 0
fused_rti_solve.warm_launches = 0
fused_rti_solve.by_layout = {}   # launches per LaunchPlan.key
fused_rti_solve.by_instance = {}


def fused_lin_prologue_plain(xbar, ubar, stage_params, model: tuple,
                             dt: float, num_steps: int = 1):
    """Eager PyTorch twin of the fuse_lin prologue (`fast_linearize`, as
    `fused_rti_solve_plain` linearizes): (A, B, c) in float32. Same
    arguments and result as `fused_lin_prologue`, at any batch size."""
    xb = _f32(xbar)
    x_next, A, Bm = fast_linearize(
        xb, _f32(ubar), _f32(stage_params), _model_params(model, xb.device),
        dt, num_steps, family=model[0])
    return A, Bm, x_next - xb[:, 1:]


def fused_lin_prologue(xbar, ubar, stage_params, model: tuple, dt: float,
                       num_steps: int = 1):
    """The fuse_lin mode's linearization alone, of one problem: (A, B, c)
    of every node, c = RK4(xbar_k, ubar_k) - xbar_{k+1}; xbar (1, N+1,
    nx), ubar (1, N, nu), stage_params (1, N, np), `model`, dt and
    num_steps as in `fused_rti_solve`. CUDA tensors launch the single
    plan's prologue grid alone (the kernel `fused_rti_solve` launches
    ahead of its solve at B=1; each launch of it, there or here, counted
    in `fused_lin_prologue.launches`); CPU tensors run its plain version,
    `fused_lin_prologue_plain`."""
    nx, nu = xbar.shape[-1], ubar.shape[-1]
    if xbar.ndim != 3 or xbar.shape[0] != 1:
        raise ValueError(f"fused_lin_prologue takes one problem, xbar "
                         f"(1, N+1, nx), not {tuple(xbar.shape)}")
    _check_fused_rti(xbar[:, 0], model, stage_params)
    _check_built(nx, nu, FUSE_LIN, model[0])
    dev, N = xbar.device, ubar.shape[1]
    if dev.type == "cuda":
        z = [torch.zeros(s, dtype=torch.float32, device=dev) for s in (
            (1, nx), (1, nx, nx), (1, nx, nx), (1, nu, nu), (1, N, nx),
            (1, N, nu), (1, nx), (1, nx), (1, nx), (1, nu), (1, nu))]
        f = _fused_prep(xbar, ubar, *z, None)
        return _fused_lin_kernel(stage_params, f, model, dt, num_steps,
                                 PROLOGUE_ONLY, 0.1, 0.995, 1e-6, True,
                                 None, None, None)[1]
    if dev.type == "cpu":
        return fused_lin_prologue_plain(xbar, ubar, stage_params, model, dt,
                                        num_steps)
    raise ValueError(f"fused_lin_prologue runs on cuda or cpu tensors, "
                     f"not {dev.type}")


fused_lin_prologue.launches = 0
