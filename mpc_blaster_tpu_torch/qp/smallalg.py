"""Small-matrix algebra of the Riccati recursion, batched over leading axes.

Port of `mpc_blaster_tpu/qp/smallalg.py`. The JAX module unrolls the
factorization at trace time into scalar ops that XLA fuses; eagerly that
would be ~n^3 separate launches per call. Here each column of the
factorization is one batched tensor op over every leading axis (n ops per
factor), the form the plain twin of the CUDA kernel
(`ops/box_qp_ipm.py::box_qp_solve_plain`) uses for the 6x6 Huu.
"""
from __future__ import annotations

import torch


def chol_unrolled(M: torch.Tensor):
    """Lower-Cholesky factor of SPD (..., n, n) and the minimum raw pivot
    (the definiteness certificate). Pivots are floored at 1e-12, so an
    epsilon-negative pivot (f32 cancellation) cannot emit NaN; a negative
    `min_piv` means the finite "factor" is garbage."""
    n = M.shape[-1]
    L = torch.zeros_like(M)
    min_piv = None
    for j in range(n):
        s = M[..., j, j] - (L[..., j, :j] * L[..., j, :j]).sum(-1)
        min_piv = s if min_piv is None else torch.minimum(min_piv, s)
        d = torch.sqrt(torch.clamp(s, min=1e-12))
        L[..., j, j] = d
        if j + 1 < n:
            t = M[..., j + 1:, j] - (L[..., j + 1:, :j]
                                     * L[..., j, None, :j]).sum(-1)
            L[..., j + 1:, j] = t * (1.0 / d).unsqueeze(-1)
    return L, min_piv


def _equilibrate(M: torch.Tensor):
    """(M scaled to unit diagonal, the scales d, their outer product)."""
    d = torch.sqrt(torch.clamp(torch.diagonal(M, dim1=-2, dim2=-1),
                               min=1e-30))
    outer = d.unsqueeze(-1) * d.unsqueeze(-2)
    return M / outer, d, outer


def chol_factor(M: torch.Tensor) -> torch.Tensor:
    """Dense lower-Cholesky factor L (M = L L') of a PSD (..., n, n),
    Jacobi-equilibrated (factor the unit-diagonal rescaling, then scale
    the rows back). Pivots are floored at 1e-12, so an exactly singular
    PSD input yields a finite factor whose Gram differs from M only on the
    null directions."""
    Ms, d, _ = _equilibrate(M)
    L, _ = chol_unrolled(Ms)
    return L * d.unsqueeze(-1)


def chol_inverse(M: torch.Tensor) -> torch.Tensor:
    """Inverse of an SPD (..., n, n) through Cholesky: M^-1 = L^-T L^-1.

    Jacobi-equilibrated and fail-safe: the barrier-modified Huu mixes
    diagonal scales over ~14 orders of magnitude, so it is scaled to unit
    diagonal first; a matrix with a diagonal entry <= 0 or a Cholesky pivot
    <= 1e-10 gets the ZERO matrix (its stage's feedback gain collapses to
    0 instead of blowing the recursion up to inf/NaN)."""
    n = M.shape[-1]
    diag_ok = (torch.diagonal(M, dim1=-2, dim2=-1) > 0.0).all(-1)
    Ms, _, outer = _equilibrate(M)
    L, min_piv = chol_unrolled(Ms)
    Li = torch.zeros_like(M)
    for i in range(n):
        Li[..., i, i] = 1.0 / L[..., i, i]
        if i > 0:
            s = (L[..., i, :i].unsqueeze(-1) * Li[..., :i, :i]).sum(-2)
            Li[..., i, :i] = -s / L[..., i, i].unsqueeze(-1)
    ok = diag_ok & (min_piv > 1e-10)
    out = (Li.transpose(-1, -2) @ Li) / outer
    return torch.where(ok[..., None, None], out, torch.zeros_like(out))


def spd_inverse(M: torch.Tensor, base: int = 8) -> torch.Tensor:
    """Inverse of an SPD (..., n, n): `chol_inverse` for n <= base, above
    it the 2x2 block Schur-complement recursion

        inv([[A, B], [B', C]]) via Ai = inv(A), S = C - B' Ai B

    with Cholesky leaves. The whole matrix is Jacobi-equilibrated once at
    the top, so every Schur complement is formed at unit scale."""
    if M.shape[-1] <= base:
        return chol_inverse(M)
    Ms, _, outer = _equilibrate(M)
    return _spd_inverse_rec(Ms, base) / outer


def _spd_inverse_rec(M: torch.Tensor, base: int) -> torch.Tensor:
    n = M.shape[-1]
    if n <= base:
        return chol_inverse(M)
    h = n // 2
    A, B, C = M[..., :h, :h], M[..., :h, h:], M[..., h:, h:]
    Ai = _spd_inverse_rec(A, base)
    AiB = Ai @ B
    Si = _spd_inverse_rec(C - B.transpose(-1, -2) @ AiB, base)
    AiB_Si = AiB @ Si
    TL = Ai + AiB_Si @ AiB.transpose(-1, -2)
    TR = -AiB_Si
    return torch.cat([torch.cat([TL, TR], -1),
                      torch.cat([TR.transpose(-1, -2), Si], -1)], -2)
