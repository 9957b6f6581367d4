"""Batched box-constrained OCP-QP interior-point solve: the Hopper kernel,
its plain PyTorch twin and the launch wrapper.

Replaces `mpc_blaster_tpu/ops/pallas_ipm.py::_ipm_kernel` in its plain
mode (cold start, hard bounds, VMEM-resident; reached through
`pallas_box_qp_solve` -> `_pallas_box_qp_solve` -> `pl.pallas_call`),
together with its in-kernel algebra (`_contractT*`, `_matvec`,
`_chol_inverse_lanes`) and the host side of `_pallas_box_qp_solve`.

One call runs a whole Mehrotra predictor-corrector IPM (Gondzio-clipped
targets, Riccati factorization and sweeps, fraction-to-boundary steps,
best-merit tracking) for every problem of a batch:

  - `box_qp_solve` is the wrapper the main path calls. A CUDA batch goes
    to the kernel in `csrc/box_qp_ipm.cu` (one launch, every IPM
    iteration inside it); a CPU batch goes to the plain twin. Nothing
    falls back: an unsupported CUDA input raises.
  - `box_qp_solve_plain` is the same algorithm in eager PyTorch, batched
    over a leading axis, with the kernel's f32 cast and +-inf handling.
    The CPU tests hold it against the Pallas kernel in interpret mode;
    `chip_smoke.py` holds the CUDA kernel against it on the card.

Host-side preparation (the K8 part of the Pallas wrapper): +-inf bounds
become +-1e18 (the kernel derives bound masks from |b| > 5e17), the
stage-0 state bound row is dropped (dx_0 is pinned), everything is cast
to contiguous float32. The Pallas wrapper's 128-lane padding, batch-last
tiling and VMEM sizing have no counterpart: the kernel takes the batch
problem-major, one thread block per problem.

Semantics kept from the Pallas kernel (compare here first on a mismatch):
slacks floored at s_min=1e-3 at init and eps_s=1e-9 after each step;
masked bounds held at slack 1e20 / dual 0; barrier weights and RHS
factors capped at sigma_max=1e7; dual divides clipped at +-1e12; duals
clipped to [0, lam_max=1e7]; dx/du are the best-merit iterate while the
returned slacks/duals are the LAST iterate; diag rows are
[kkt_stat estimate, kkt_eq, best merit]. `kkt_stat` is an upper-bound
estimate (last-iterate duals, clipped by the best merit), `kkt_eq` is
exact on the returned iterate.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
import time
from pathlib import Path
from typing import NamedTuple

import torch

from mpc_blaster_tpu_torch.qp.data import QPData, QPSolution

_BIG = 1e20     # slack sentinel for masked (infinite) bounds
_BIGB = 1e18    # finite stand-in for an infinite bound value
_MTHR = 5e17    # |bound| above this is treated as infinite (mask = 0)
_S_MIN, _MU_MIN = 1e-3, 1e-7
_SIGMA_MAX, _LAM_MAX, _EPS_S = 1e7, 1e7, 1e-9
_DUAL_CLIP = 1e12

# Dimensions the CUDA kernel is instantiated for (the BLASTER model).
KERNEL_NX, KERNEL_NU = 17, 6

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "box_qp_ipm.cu"
BUILD_DIR = _PKG / "build"
# No --use_fast_math: the f32 guards rely on IEEE division, square root
# and rounding (e.g. 1e18 + 1e7 rounds back to 1e18).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


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


def _prep(data: QPData) -> _Prepped:
    """Sanitize +-inf bounds, drop the pinned stage-0 state bounds, cast
    to contiguous float32. Stage Hessians must be stage-invariant (the
    RTI's LINEAR_LS cost): Q[:, 0] and R[:, 0] are used."""
    def f32(x):
        return x.to(torch.float32).contiguous()

    def san(b, lo):
        return f32(torch.where(torch.isfinite(b), b,
                               torch.full_like(b, -_BIGB if lo else _BIGB)))

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


def chol_inverse_plain(M: torch.Tensor) -> torch.Tensor:
    """(B, n, n) SPD -> inverse, Jacobi-equilibrated and fail-safe.

    The barrier-modified Huu mixes diagonal scales over ~14 orders of
    magnitude, so it is scaled to unit diagonal first; a problem whose
    matrix has a diagonal entry <= 0 or a Cholesky pivot <= 1e-10 gets
    the ZERO matrix (its feedback gain collapses to 0 for that stage
    instead of blowing the recursion up)."""
    n = M.shape[-1]
    d = torch.diagonal(M, dim1=-2, dim2=-1)
    diag_ok = (d > 0.0).all(-1)
    dscale = torch.sqrt(torch.clamp(d, min=1e-30))
    outer = dscale.unsqueeze(-1) * dscale.unsqueeze(-2)
    ent = M / outer
    L = torch.zeros_like(M)
    min_piv = None
    for j in range(n):
        s = ent[:, j, j] - (L[:, j, :j] * L[:, j, :j]).sum(-1)
        min_piv = s if min_piv is None else torch.minimum(min_piv, s)
        dj = torch.sqrt(torch.clamp(s, min=1e-12))
        L[:, j, j] = dj
        if j + 1 < n:
            t = ent[:, j + 1:, j] - (L[:, j + 1:, :j]
                                     * L[:, j, None, :j]).sum(-1)
            L[:, j + 1:, j] = t * (1.0 / dj).unsqueeze(-1)
    Li = torch.zeros_like(M)
    for i in range(n):
        Li[:, i, i] = 1.0 / L[:, i, i]
        if i > 0:
            s = (L[:, i, :i].unsqueeze(-1) * Li[:, :i, :i]).sum(-2)
            Li[:, i, :i] = -s / L[:, i, i].unsqueeze(-1)
    ok = diag_ok & (min_piv > 1e-10)
    out = _mtm(Li, Li) / outer
    return torch.where(ok[:, None, None], out, torch.zeros_like(out))


def box_qp_solve_plain(data: QPData, iters: int = 12, mu0: float = 1e-1,
                       alpha_frac: float = 0.995,
                       reg: float = 1e-6) -> QPSolution:
    """Eager PyTorch twin of the CUDA kernel. `data` fields carry a
    leading batch axis (B, ...); any device. Same arguments and result as
    `box_qp_solve`."""
    p = _prep(data)
    A, Bm, c, Qs, Qt, q, R, r = (p.A, p.Bm, p.c, p.Qs, p.Qt, p.q, p.R,
                                 p.r)
    Bsz, N, nx, nu = A.shape[0], A.shape[1], A.shape[-1], Bm.shape[-1]
    dev = A.device
    big = torch.tensor(_BIG, dtype=torch.float32, device=dev)

    # Bound groups: (bound, sign, mask, is_state). Masks are derived from
    # the sanitized bound magnitude; they never change during a solve.
    mlx = (p.lbx > -_MTHR).float()
    mux = (p.ubx < _MTHR).float()
    mlu = (p.lbu > -_MTHR).float()
    muu = (p.ubu < _MTHR).float()
    groups = ((p.lbx, 1.0, mlx, True), (p.ubx, -1.0, mux, True),
              (p.lbu, 1.0, mlu, False), (p.ubu, -1.0, muu, False))

    def clamp_into(v, lb, ub, ml, mu_):
        both = (ml > 0.5) & (mu_ > 0.5)
        w = torch.where(both, ub - lb, torch.ones_like(lb))
        lo = torch.where(ml > 0.5, lb + 0.1 * w, -big)
        hi = torch.where(mu_ > 0.5, ub - 0.1 * w, big)
        return _clip(v, lo, torch.maximum(hi, lo))

    # ---- initial point: rollout (du = 0) with the 10%-inset clamp,
    # centred slacks and duals ----
    xs = [p.dx0]
    for k in range(N):
        nxt = _mv(A[:, k], xs[-1]) + c[:, k]
        xs.append(clamp_into(nxt, p.lbx[:, k], p.ubx[:, k], mlx[:, k],
                             mux[:, k]))
    dx = torch.stack(xs, 1)
    du = clamp_into(torch.zeros_like(p.lbu), p.lbu, p.ubu, mlu, muu)

    def init_pair(v, b, sgn, m):
        s = torch.where(m > 0.5, torch.clamp(sgn * (v - b), min=_S_MIN), big)
        lam = torch.where(m > 0.5, mu0 / s, torch.zeros_like(s))
        return s, lam

    S, LAM = [], []
    for b, sgn, m, is_x in groups:
        s, lam = init_pair(dx[:, 1:] if is_x else du, b, sgn, m)
        S.append(s)
        LAM.append(lam)

    n_ineq = torch.clamp(sum(m.sum((1, 2)) for _, _, m, _ in groups),
                         min=1.0)

    def comp_sum():
        return sum((m * S[i] * LAM[i]).sum((1, 2))
                   for i, (_, _, m, _) in enumerate(groups))

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

    def g_rs(i, dx, du):
        b, sgn, _, is_x = groups[i]
        v = dx[:, 1:] if is_x else du
        return S[i] - sgn * (v - b)

    def g_sig(i):
        m = groups[i][2]
        return torch.clamp(m * LAM[i] / S[i], max=_SIGMA_MAX)

    def dirs(i, T, ddx, ddu, dx, du):
        """(ds, dlam) of group i for the Newton directions ddx/ddu."""
        _, sgn, m, is_x = groups[i]
        dv = sgn * (ddx[:, 1:] if is_x else ddu)
        ds = m * (dv - g_rs(i, dx, du))
        dlam = m * torch.clamp((T - S[i] * LAM[i] - LAM[i] * ds) / S[i],
                               -_DUAL_CLIP, _DUAL_CLIP)
        return ds, dlam

    def rhs_grads(T, dx, du):
        def g_b(i):
            _, sgn, m, _ = groups[i]
            b = (torch.clamp(T[i] / S[i], -_SIGMA_MAX, _SIGMA_MAX)
                 + g_sig(i) * g_rs(i, dx, du))
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
        sig_x = torch.clamp(g_sig(0) + g_sig(1), max=_SIGMA_MAX)
        sig_u = torch.clamp(g_sig(2) + g_sig(3), max=_SIGMA_MAX)
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
            ds, dlam = dirs(i, T[i], ddx, ddu, dx, du)
            a_p = torch.minimum(a_p, min_ratio(S[i], ds, tau))
            a_d = torch.minimum(a_d, min_ratio(LAM[i], dlam, tau))
        return torch.clamp(a_p, max=1.0), torch.clamp(a_d, max=1.0)

    st0, eq0, req = kkt(dx, du)
    dx_best, du_best = dx, du
    best_merit = st0 + eq0 + comp_sum() / n_ineq
    zero_T = [torch.zeros_like(S[i]) for i in range(4)]

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
                     for i, (ds, dlam) in enumerate(aff)) / n_ineq
        ratio = mu_aff / torch.clamp(mu_cur, min=_MU_MIN)
        sigma = torch.clamp(ratio * ratio * ratio, 0.0, 1.0)
        mu_t = torch.clamp(sigma * mu_cur, min=_MU_MIN)[:, None, None]
        # corrector with Gondzio-clipped Mehrotra targets
        T = [_clip(mu_t - ds * dlam, 0.05 * mu_t, 20.0 * mu_t)
             for ds, dlam in aff]
        qr, rr = rhs_grads(T, dx, du)
        ddx, ddu = solve_rhs(P, Z, Hinv, req, qr, rr)
        a_p, a_d = alphas(T, alpha_frac, ddx, ddu, dx, du)
        apb, adb = a_p[:, None, None], a_d[:, None, None]
        # update (stage-0 state pinned)
        steps = [dirs(i, T[i], ddx, ddu, dx, du) for i in range(4)]
        for i, (ds, dlam) in enumerate(steps):
            S[i] = torch.clamp(S[i] + apb * ds, min=_EPS_S)
            LAM[i] = torch.clamp(LAM[i] + adb * dlam, 0.0, _LAM_MAX)
        dx = torch.cat([dx[:, :1], dx[:, 1:] + apb * ddx[:, 1:]], 1)
        du = du + apb * ddu
        st, eq, req = kkt(dx, du)
        merit = st + eq + comp_sum() / n_ineq
        better = merit < best_merit
        dx_best = torch.where(better[:, None, None], dx, dx_best)
        du_best = torch.where(better[:, None, None], du, du_best)
        best_merit = torch.where(better, merit, best_merit)

    # final diagnostics on the returned (best) iterate, last-iterate duals
    stf, eqf, _ = kkt(dx_best, du_best)
    stf = torch.where(torch.isfinite(stf), torch.minimum(stf, best_merit),
                      best_merit)
    return QPSolution(dx=dx_best, du=du_best, kkt_stat=stf, kkt_eq=eqf,
                      mu=best_merit,
                      lam_lx=LAM[0], lam_ux=LAM[1], lam_lu=LAM[2],
                      lam_uu=LAM[3],
                      s_lx=S[0], s_ux=S[1], s_lu=S[2], s_uu=S[3])


# ------------------------------- the kernel -------------------------------

def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME); the "
                           "box-QP IPM kernel is built with nvcc")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _library_path() -> Path:
    """Path of the built library for the current source and flags."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libbox_qp_ipm_{h.hexdigest()[:16]}.so"


def build_library():
    """Compile `csrc/box_qp_ipm.cu` with nvcc into `build/` (rebuilt when
    the source or flags change). Returns (path, seconds, compiler log);
    seconds is 0.0 when an up-to-date build already existed."""
    so = _library_path()
    log = so.with_suffix(".log")
    if so.exists():
        return so, 0.0, log.read_text() if log.exists() else ""
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        t0 = time.perf_counter()
        res = subprocess.run([nvcc, *NVCC_FLAGS, "-o", tmp, str(SOURCE)],
                             capture_output=True, text=True)
        secs = time.perf_counter() - t0
        text = res.stdout + res.stderr
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}):\n{text}")
        log.write_text(text)
        os.replace(tmp, so)  # atomic: a concurrent build never sees half a file
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return so, secs, text


@functools.cache
def _library() -> ctypes.CDLL:
    so, _, _ = build_library()
    lib = ctypes.CDLL(str(so))
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.box_qp_ipm_solve.argtypes = ([ptr] * 25 + [i32] * 3 + [f32] * 3
                                     + [ptr])
    lib.box_qp_ipm_solve.restype = i32
    lib.box_qp_ipm_workspace_floats.argtypes = [i32]
    lib.box_qp_ipm_workspace_floats.restype = ctypes.c_longlong
    lib.box_qp_ipm_error_string.argtypes = [i32]
    lib.box_qp_ipm_error_string.restype = ctypes.c_char_p
    return lib


def _solve_kernel(data: QPData, iters: int, mu0: float, alpha_frac: float,
                  reg: float) -> QPSolution:
    p = _prep(data)
    Bsz, N, nx, nu = p.A.shape[0], p.A.shape[1], p.A.shape[-1], \
        p.Bm.shape[-1]
    if (nx, nu) != (KERNEL_NX, KERNEL_NU):
        raise NotImplementedError(
            f"the CUDA box-QP IPM is built for nx={KERNEL_NX}, "
            f"nu={KERNEL_NU} (got {nx}, {nu}); other models port with "
            "ROADMAP queue 1 item 11")
    if Bsz == 0 or N < 1:
        raise ValueError(f"empty QP batch (B={Bsz}, N={N})")
    dev = p.A.device
    expected = _Prepped(
        A=(Bsz, N, nx, nx), Bm=(Bsz, N, nx, nu), c=(Bsz, N, nx),
        Qs=(Bsz, nx, nx), Qt=(Bsz, nx, nx), q=(Bsz, N + 1, nx),
        R=(Bsz, nu, nu), r=(Bsz, N, nu), lbx=(Bsz, N, nx), ubx=(Bsz, N, nx),
        lbu=(Bsz, N, nu), ubu=(Bsz, N, nu), dx0=(Bsz, nx))
    for name, t, shape in zip(_Prepped._fields, p, expected):
        if t.device != dev or tuple(t.shape) != shape:
            raise ValueError(f"QP field {name}: {tuple(t.shape)} on "
                             f"{t.device}, expected {shape} on {dev}")
    lib = _library()

    def empty(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    dx, du, diag = empty(Bsz, N + 1, nx), empty(Bsz, N, nu), empty(Bsz, 6)
    sx = [empty(Bsz, N, nx) for _ in range(4)]     # slx sux llx lux
    su = [empty(Bsz, N, nu) for _ in range(4)]     # slu suu llu luu
    work = empty(Bsz, int(lib.box_qp_ipm_workspace_floats(N)))
    ins = list(p)
    outs = [dx, du, diag, *sx, *su, work]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.box_qp_ipm_solve(
            *[t.data_ptr() for t in ins + outs], Bsz, N, iters,
            mu0, alpha_frac, reg, stream)
    if rc != 0:
        raise RuntimeError("box_qp_ipm launch failed: "
                           + lib.box_qp_ipm_error_string(rc).decode())
    box_qp_solve.launches += 1
    return QPSolution(dx=dx, du=du, kkt_stat=diag[:, 0], kkt_eq=diag[:, 1],
                      mu=diag[:, 2],
                      lam_lx=sx[2], lam_ux=sx[3], lam_lu=su[2], lam_uu=su[3],
                      s_lx=sx[0], s_ux=sx[1], s_lu=su[0], s_uu=su[1])


def box_qp_solve(data: QPData, iters: int = 12, mu0: float = 1e-1,
                 alpha_frac: float = 0.995, reg: float = 1e-6) -> QPSolution:
    """Batched box-QP IPM solve; the counterpart of `pallas_box_qp_solve`.

    `data` fields carry a leading batch axis (B, ...). Stage Hessians
    must be identical across stages 0..N-1 (Q[:, 0], R[:, 0] are used)
    with a distinct terminal Q[:, N]; bounds may be +-inf. Tensors on a
    CUDA device run the hand-written kernel (one launch; counted in
    `box_qp_solve.launches`); tensors on the CPU run the plain twin.
    """
    dev = data.A.device
    if dev.type == "cuda":
        return _solve_kernel(data, iters, mu0, alpha_frac, reg)
    if dev.type == "cpu":
        return box_qp_solve_plain(data, iters=iters, mu0=mu0,
                                  alpha_frac=alpha_frac, reg=reg)
    raise ValueError(f"box_qp_solve runs on cuda or cpu tensors, "
                     f"not {dev.type}")


box_qp_solve.launches = 0
