"""Square-root (array-form) Riccati factorization: the f32-stable Newton core.

Port of `mpc_blaster_tpu/qp/sqrt_riccati.py`. The plain recursion
(`qp/riccati.py`) forms H_uu = R + B'PB and P_k = Q + A'PA - H_ux' H_uu^-1
H_ux explicitly; with interior-point barrier curvature on dense rows
(partial condensing's general constraints, `qp/condense.py`) the final
subtraction cancels catastrophically in f32. The array form stacks, per
stage, row factors F with F'F = [[Rmod, Smod], [Smod', Qmod]] on top of
Z_{k+1} [B | A] (P = Z'Z) and takes one QR:

    F = O [ Ruu  Rux ]     =>  H_uu = Ruu' Ruu   (never formed)
          [  0   Z_k ]         K    = -Ruu^-1 Rux
                               P_k  = Z_k' Z_k    (never formed)

so the subtraction happens inside the orthogonal transform, at the square
root of the plain recursion's condition number.

LAPACK (or cuSOLVER) may choose either sign for each row of R; every
quantity used below (K, Ruu'Ruu, Z'Z) is invariant under those row signs.
No Pallas kernel computes this recursion (the JAX package leaves it to
XLA's QR custom call), so `torch.linalg.qr` and `solve_triangular` are its
port. Every tensor may carry leading batch axes; the stages are a Python
loop.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from mpc_blaster_tpu_torch.qp.riccati import _mv, _t
from mpc_blaster_tpu_torch.qp.smallalg import chol_factor


class SqrtRiccatiFactor(NamedTuple):
    K: torch.Tensor     # (..., N, nu, nx) feedback gains
    Ruu: torch.Tensor   # (..., N, nu, nu) upper-tri, H_uu = Ruu' Ruu
    Z: torch.Tensor     # (..., N+1, nx, nx) value factors, P_k = Z_k' Z_k


def sqrt_factorize(A: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
                   ZN: torch.Tensor) -> SqrtRiccatiFactor:
    """Matrix-only backward pass on row factors.

    A (..., N, nx, nx); B (..., N, nx, nu); C (..., N, m, nu+nx) stage-cost
    row factors with C_k' C_k = [[Rmod_k, Smod_k], [Smod_k', Qmod_k]]
    (columns ordered [u | x]); ZN (..., nx, nx) with P_N = ZN' ZN.
    """
    N, nu = A.shape[-3], B.shape[-1]
    Z = ZN
    Ks, Ruus, Zs = [None] * N, [None] * N, [None] * (N + 1)
    Zs[N] = ZN
    for k in range(N - 1, -1, -1):
        BA = torch.cat([B[..., k, :, :], A[..., k, :, :]], -1)
        F = torch.cat([C[..., k, :, :], Z @ BA], -2)
        R = torch.linalg.qr(F, mode="r")[1]             # (..., nu+nx, nu+nx)
        Ruu, Rux = R[..., :nu, :nu], R[..., :nu, nu:]
        Z = R[..., nu:, nu:]
        Ks[k] = -torch.linalg.solve_triangular(Ruu, Rux, upper=True)
        Ruus[k], Zs[k] = Ruu, Z
    return SqrtRiccatiFactor(K=torch.stack(Ks, -3), Ruu=torch.stack(Ruus, -3),
                             Z=torch.stack(Zs, -3))


def riccati_factorize_sqrt(A, B, Q, R, reg: float = 0.0
                           ) -> SqrtRiccatiFactor:
    """Drop-in analog of `riccati.riccati_factorize` on the sqrt core: the
    stage cost factors come from the Jacobi-equilibrated Cholesky
    (`smallalg.chol_factor`). Pair with `sqrt_solve_rhs`; selected by
    `box_qp_solve(riccati="sqrt")`."""
    N = A.shape[-3]
    nx, nu = A.shape[-1], B.shape[-1]
    batch = A.shape[:-3]
    I_u = torch.eye(nu, dtype=A.dtype, device=A.device)
    Lr = chol_factor(R + reg * I_u)
    Lq = chol_factor(Q[..., :-1, :, :])
    rows_r = torch.cat([_t(Lr), A.new_zeros(*batch, N, nu, nx)], -1)
    rows_q = torch.cat([A.new_zeros(*batch, N, nx, nu), _t(Lq)], -1)
    C = torch.cat([rows_r, rows_q], -2)
    ZN = _t(chol_factor(Q[..., -1, :, :]))
    return sqrt_factorize(A, B, C, ZN)


def _h_solve(Ruu, v):
    """H_uu^-1 v through two triangular solves (H_uu = Ruu' Ruu)."""
    y = torch.linalg.solve_triangular(_t(Ruu), v.unsqueeze(-1), upper=False)
    return torch.linalg.solve_triangular(Ruu, y, upper=True).squeeze(-1)


def sqrt_solve_rhs(fac: SqrtRiccatiFactor, A, B, c, q, r, dx0
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Vector-only backward + forward pass for a right-hand side (q, r, c,
    dx0): the recursion of `riccati.riccati_solve_rhs`, with P products
    formed as Z'(Z v) and the H_uu solves as triangular solves against
    Ruu. Returns (dx (..., N+1, nx), du (..., N, nu))."""
    N = A.shape[-3]
    p = q[..., N, :]
    ks = [None] * N
    for k in range(N - 1, -1, -1):
        Zn = fac.Z[..., k + 1, :, :]
        Pc_p = _mv(_t(Zn), _mv(Zn, c[..., k, :])) + p
        G_u = r[..., k, :] + _mv(_t(B[..., k, :, :]), Pc_p)
        ks[k] = -_h_solve(fac.Ruu[..., k, :, :], G_u)
        p = (q[..., k, :] + _mv(_t(A[..., k, :, :]), Pc_p)
             + _mv(_t(fac.K[..., k, :, :]), G_u))
    dxs, dus = [dx0], []
    for k in range(N):
        du = _mv(fac.K[..., k, :, :], dxs[-1]) + ks[k]
        dxs.append(_mv(A[..., k, :, :], dxs[-1]) + _mv(B[..., k, :, :], du)
                   + c[..., k, :])
        dus.append(du)
    return torch.stack(dxs, -2), torch.stack(dus, -2)
