"""Equality-constrained LQR via the backward Riccati sweep.

Port of `mpc_blaster_tpu/qp/riccati.py`. The JAX module's `lax.scan`s
become Python loops over the stages; every stage op is a batched
`torch.matmul` over the leading axes, so a batch of problems costs the
same number of ops as one. No Pallas kernel computes this recursion (the
JAX package leaves it to XLA), so plain tensor ops are its port.

Split into a factor pass (matrices: feedback gains K, inverses of H_uu,
value Hessians P) and a solve pass (vectors: feedforwards from the
gradients and affine defects); the IPM factors once per iteration and
solves twice (Mehrotra predictor + corrector).

Solves  min  sum_k 0.5 dx'Q_k dx + q_k'dx + 0.5 du'R_k du + r_k'du
             + 0.5 dx_N'Q_N dx_N + q_N'dx_N
        s.t. dx_{k+1} = A_k dx_k + B_k du_k + c_k,   dx_0 given.
Shapes carry optional leading batch axes: A (..., N, nx, nx), q (..., N+1,
nx), dx0 (..., nx).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from mpc_blaster_tpu_torch.qp.data import QPData, QPSolution
from mpc_blaster_tpu_torch.qp.smallalg import spd_inverse


class RiccatiFactor(NamedTuple):
    K: torch.Tensor     # (..., N, nu, nx) feedback gains
    Hinv: torch.Tensor  # (..., N, nu, nu) inverses of H_uu
    P: torch.Tensor     # (..., N+1, nx, nx) value Hessians


def _t(M):
    return M.transpose(-1, -2)


def _mv(M, v):
    return (M @ v.unsqueeze(-1)).squeeze(-1)


def riccati_factorize(A, B, Q, R, reg: float = 0.0, S=None) -> RiccatiFactor:
    """Matrix-only backward pass: P_k, K_k, inv(H_uu)_k. S (optional,
    (..., N, nu, nx)): cost cross terms 'u S x', so H_ux = S + B'PA."""
    N, nu = A.shape[-3], B.shape[-1]
    I_u = torch.eye(nu, dtype=B.dtype, device=B.device)
    P = Q[..., N, :, :]
    Ks, Hinvs, Ps = [None] * N, [None] * N, [None] * (N + 1)
    Ps[N] = P
    for k in range(N - 1, -1, -1):
        A_k, B_k = A[..., k, :, :], B[..., k, :, :]
        PA, PB = P @ A_k, P @ B_k
        H_uu = R[..., k, :, :] + _t(B_k) @ PB + reg * I_u
        H_ux = _t(B_k) @ PA
        if S is not None:
            H_ux = S[..., k, :, :] + H_ux
        Hinv = spd_inverse(H_uu)
        K_k = -(Hinv @ H_ux)
        P = Q[..., k, :, :] + _t(A_k) @ PA + _t(H_ux) @ K_k
        P = 0.5 * (P + _t(P))
        Ks[k], Hinvs[k], Ps[k] = K_k, Hinv, P
    return RiccatiFactor(K=torch.stack(Ks, -3), Hinv=torch.stack(Hinvs, -3),
                         P=torch.stack(Ps, -3))


def riccati_solve_rhs(fac: RiccatiFactor, A, B, c, q, r, dx0
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Vector-only backward + forward pass for a right-hand side
    (q, r, c, dx0). Returns (dx (..., N+1, nx), du (..., N, nu))."""
    N = A.shape[-3]
    p = q[..., N, :]
    ks = [None] * N
    for k in range(N - 1, -1, -1):
        Pc_p = _mv(fac.P[..., k + 1, :, :], c[..., k, :]) + p
        G_u = r[..., k, :] + _mv(_t(B[..., k, :, :]), Pc_p)
        ks[k] = -_mv(fac.Hinv[..., k, :, :], G_u)
        p = (q[..., k, :] + _mv(_t(A[..., k, :, :]), Pc_p)
             + _mv(_t(fac.K[..., k, :, :]), G_u))
    dxs, dus = [dx0], []
    for k in range(N):
        du = _mv(fac.K[..., k, :, :], dxs[-1]) + ks[k]
        dxs.append(_mv(A[..., k, :, :], dxs[-1]) + _mv(B[..., k, :, :], du)
                   + c[..., k, :])
        dus.append(du)
    return torch.stack(dxs, -2), torch.stack(dus, -2)


def riccati_solve(A, B, c, Q, q, R, r, dx0, reg: float = 0.0):
    """Factorize + solve. Returns (dx, du, factor)."""
    fac = riccati_factorize(A, B, Q, R, reg)
    dx, du = riccati_solve_rhs(fac, A, B, c, q, r, dx0)
    return dx, du, fac


def lqr_solve(data: QPData, reg: float = 0.0) -> QPSolution:
    """Solve the unconstrained (equality-only) OCP QP."""
    dx, du, _ = riccati_solve(data.A, data.B, data.c, data.Q, data.q,
                              data.R, data.r, data.dx0, reg)
    return QPSolution(dx=dx, du=du)


def lqr_kkt_residuals(data: QPData, dx: torch.Tensor, du: torch.Tensor):
    """(stationarity_inf, equality_inf) of one equality-only QP. Costates
    by the adjoint recursion lam_N = Q_N dx_N + q_N, lam_k = Q_k dx_k + q_k
    + A_k' lam_{k+1}; the control rows R_k du_k + r_k + B_k' lam_{k+1}
    are the nontrivial stationarity residuals."""
    lam = _mv(data.Q[-1], dx[-1]) + data.q[-1]
    stat = torch.zeros((), dtype=dx.dtype)
    for k in range(data.horizon - 1, -1, -1):
        stat_u = _mv(data.R[k], du[k]) + data.r[k] + _mv(_t(data.B[k]), lam)
        stat = torch.maximum(stat, stat_u.abs().max())
        lam = _mv(data.Q[k], dx[k]) + data.q[k] + _mv(_t(data.A[k]), lam)
    eq = (dx[1:] - _mv(data.A, dx[:-1]) - _mv(data.B, du) - data.c).abs().max()
    eq = torch.maximum(eq, (dx[0] - data.dx0).abs().max())
    return stat, eq
