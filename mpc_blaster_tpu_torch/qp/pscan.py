"""Horizon-parallel LQR through an associative scan (log-depth in N).

Port of `mpc_blaster_tpu/qp/pscan.py`. The backward value recursion of the
LQR is an associative operation on conditional value-function elements
(Särkkä & García-Fernández, temporal parallelization of LQR), so a scan
evaluates it in O(log N) dependent steps; the forward rollout is likewise
a prefix scan of affine maps.

Element e = (A, b, C, eta, J) represents the span value function
  V_e(x, z) = 1/2 x'Jx - eta'x + max_lam [lam'(z - Ax - b) - 1/2 lam'C lam]
Stage init (integrating out u):
  A_e = A_k, b_e = c_k - B R^-1 r, C_e = B R^-1 B', J_e = Q_k, eta_e = -q_k
Terminal element: (0, 0, 0, -q_N, Q_N). Suffix-combining stages k..N gives
V_k: P_k = J, p_k = -eta.

The JAX package builds these on `jax.lax.associative_scan`; PyTorch has no
public counterpart, so `associative_scan` below is the port's own
log-depth scan, with JAX's conventions: a reversed scan feeds the combine
its operands as (later, earlier), which is why the suffix scans swap them.
Its summation order differs from XLA's odd/even recursion, so f32 results
differ from the JAX package's in the last bits. No Pallas kernel computes
any of this; the (nx, nx) systems of the combine are `torch.linalg.solve`.
Every tensor may carry leading batch axes before the stage axis (the
horizon itself runs on one device: the JAX package's horizon sharding
over a mesh is not ported).
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Sequence, Tuple

import torch

from mpc_blaster_tpu_torch.qp.data import QPData, QPSolution
from mpc_blaster_tpu_torch.qp.riccati import RiccatiFactor, _mv, _t
from mpc_blaster_tpu_torch.qp.smallalg import chol_inverse


def associative_scan(fn: Callable, elems: Sequence[torch.Tensor],
                     reverse: bool = False, dim: int = 0):
    """Inclusive scan of an associative `fn` over axis `dim` of every tensor
    of the tuple `elems` (a NamedTuple keeps its type), in ceil(log2 n)
    rounds of `fn` on all positions at once (Hillis-Steele), for any
    length n. fn(earlier, later) combines two tuples of the same structure
    as `elems`. reverse=True scans from the end, as JAX's does: the
    elements are flipped, scanned, and flipped back, so the combine sees
    (later, earlier) in the original order."""
    kind = type(elems)

    def pack(xs):
        return kind(*xs) if hasattr(kind, "_fields") else tuple(xs)

    xs = [torch.flip(x, (dim,)) if reverse else x for x in elems]
    n = xs[0].shape[dim]
    k = 1
    while k < n:
        earlier = pack(x.narrow(dim, 0, n - k) for x in xs)
        later = pack(x.narrow(dim, k, n - k) for x in xs)
        xs = [torch.cat([x.narrow(dim, 0, k), y], dim)
              for x, y in zip(xs, fn(earlier, later))]
        k *= 2
    return pack(torch.flip(x, (dim,)) if reverse else x for x in xs)


class _Elem(NamedTuple):
    A: torch.Tensor    # (..., nx, nx)
    b: torch.Tensor    # (..., nx)
    C: torch.Tensor    # (..., nx, nx)
    eta: torch.Tensor  # (..., nx)
    J: torch.Tensor    # (..., nx, nx)


def _inv_I_plus(C1, J2):
    """D = (I + C1 J2)^-1."""
    nx = C1.shape[-1]
    I = torch.eye(nx, dtype=C1.dtype, device=C1.device)
    M = I + C1 @ J2
    return torch.linalg.solve(M, I.expand(M.shape))


def _combine(e1: _Elem, e2: _Elem) -> _Elem:
    """Combine earlier-span e1 with later-span e2 (associative)."""
    D = _inv_I_plus(e1.C, e2.J)
    A = e2.A @ D @ e1.A
    b = _mv(e2.A, _mv(D, e1.b + _mv(e1.C, e2.eta))) + e2.b
    C = e2.A @ D @ e1.C @ _t(e2.A) + e2.C
    Dt = _t(D)    # (I + J2 C1)^-1 = D' for symmetric C1, J2
    eta = _mv(_t(e1.A), _mv(Dt, e2.eta - _mv(e2.J, e1.b))) + e1.eta
    J = _t(e1.A) @ Dt @ e2.J @ e1.A + e1.J
    J = 0.5 * (J + _t(J))
    return _Elem(A=A, b=b, C=C, eta=eta, J=J)


def _append_zero(M):
    """Matrices (..., N, n, n) with one zero stage appended."""
    return torch.cat([M, torch.zeros_like(M[..., :1, :, :])], -3)


def _stage_dim(A):
    return A.dim() - 3


def backward_pass_pscan(A, B, c, Q, q, R, r, reg: float = 0.0
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(P (..., N+1, nx, nx), p (..., N+1, nx)) by a log-depth suffix
    scan."""
    nu = B.shape[-1]
    Rinv = chol_inverse(R + reg * torch.eye(nu, dtype=A.dtype,
                                            device=A.device))
    BRinv = B @ Rinv
    elems = _Elem(
        A=_append_zero(A),
        b=torch.cat([c - _mv(BRinv, r), torch.zeros_like(c[..., :1, :])],
                    -2),
        C=_append_zero(BRinv @ _t(B)),
        eta=-q,
        J=Q,
    )
    # reverse=True feeds the combine (later-combined, earlier); _combine
    # takes (earlier, later), hence the swap
    suffix = associative_scan(lambda a, b: _combine(b, a), elems,
                              reverse=True, dim=_stage_dim(A))
    return suffix.J, -suffix.eta


def lqr_solve_pscan(data: QPData, reg: float = 0.0) -> QPSolution:
    """Equality-only OCP QP solved with O(log N) parallel depth: the
    solution of `riccati.lqr_solve`."""
    dx, du = eqp_solve_pscan(data.A, data.B, data.c, data.Q, data.q,
                             data.R, data.r, data.dx0, reg)
    return QPSolution(dx=dx, du=du)


def _gains(A, B, R, P1, reg):
    """(K, inv(H_uu)) of every stage from P_{k+1}, all stages at once."""
    nu = B.shape[-1]
    Huu = (R + _t(B) @ P1 @ B
           + reg * torch.eye(nu, dtype=A.dtype, device=A.device))
    Hinv = chol_inverse(Huu)
    return -(Hinv @ (_t(B) @ P1 @ A)), Hinv


def _compose(m1, m2):
    """The affine map m2 after m1 (a prefix scan's combine)."""
    F1, g1 = m1
    F2, g2 = m2
    return F2 @ F1, _mv(F2, g1) + g2


def _rollout(F, g, K, kff, dx0, d):
    """dx_{k+1} = F_k dx_k + g_k as a prefix scan; du = K dx + kff."""
    Fs, gs = associative_scan(_compose, (F, g), dim=d)
    dx = torch.cat([dx0.unsqueeze(-2), _mv(Fs, dx0.unsqueeze(-2)) + gs], -2)
    return dx, _mv(K, dx[..., :-1, :]) + kff


def eqp_solve_pscan(A, B, c, Q, q, R, r, dx0, reg: float = 0.0):
    """Equality-constrained LQR solve with O(log N) parallel depth (the
    whole solve; the IPM's "pscan" mode uses the factor / solve split
    below instead, so its two right-hand sides share one factor)."""
    P, p = backward_pass_pscan(A, B, c, Q, q, R, r, reg)
    P1, p1 = P[..., 1:, :, :], p[..., 1:, :]
    K, Hinv = _gains(A, B, R, P1, reg)
    Gu = r + _mv(_t(B), _mv(P1, c) + p1)
    kff = -_mv(Hinv, Gu)
    return _rollout(A + B @ K, _mv(B, kff) + c, K, kff, dx0, _stage_dim(A))


# --------- factor/solve split for the IPM (one factor, many RHS) ---------

class _MatElem(NamedTuple):
    """Matrix-only part of the value-function element (factorization)."""

    A: torch.Tensor    # (..., N+1, nx, nx)
    C: torch.Tensor    # (..., N+1, nx, nx)
    J: torch.Tensor    # (..., N+1, nx, nx)


def _combine_mat(e1: _MatElem, e2: _MatElem) -> _MatElem:
    """Matrix rows of `_combine` (earlier e1, later e2): b/eta drop out."""
    D = _inv_I_plus(e1.C, e2.J)
    A = e2.A @ D @ e1.A
    C = e2.A @ D @ e1.C @ _t(e2.A) + e2.C
    J = _t(e1.A) @ _t(D) @ e2.J @ e1.A + e1.J
    J = 0.5 * (J + _t(J))
    return _MatElem(A=A, C=C, J=J)


def riccati_factorize_pscan(A, B, Q, R, reg: float = 0.0) -> RiccatiFactor:
    """Log-depth Riccati factorization through a matrix-only associative
    scan: the `RiccatiFactor` (gains, inverses of H_uu, value Hessians) of
    `riccati.riccati_factorize`."""
    nu = B.shape[-1]
    Rinv = chol_inverse(R + reg * torch.eye(nu, dtype=A.dtype,
                                            device=A.device))
    elems = _MatElem(A=_append_zero(A), C=_append_zero(B @ Rinv @ _t(B)),
                     J=Q)
    P = associative_scan(lambda a, b: _combine_mat(b, a), elems,
                         reverse=True, dim=_stage_dim(A)).J
    K, Hinv = _gains(A, B, R, P[..., 1:, :, :], reg)
    return RiccatiFactor(K=K, Hinv=Hinv, P=P)


def _comp_suffix(earlier, later):
    """p_k = M_k p_{k+1} + v_k composed over a span (earlier, later)."""
    Me, ve = earlier
    Ml, vl = later
    return Me @ Ml, _mv(Me, vl) + ve


def riccati_solve_rhs_pscan(fac: RiccatiFactor, A, B, c, q, r, dx0
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Log-depth right-hand-side solve against an existing
    `RiccatiFactor`: the costate recursion p_k = F_k' p_{k+1} + h_k
    (F_k = A_k + B_k K_k) as a suffix scan and the forward rollout as a
    prefix scan of affine maps. The solution of
    `riccati.riccati_solve_rhs`."""
    K, Hinv, P = fac.K, fac.Hinv, fac.P
    d = _stage_dim(A)
    F = A + B @ K
    Pc = _mv(P[..., 1:, :, :], c)
    h = q[..., :-1, :] + _mv(_t(K), r) + _mv(_t(F), Pc)
    Ms = _append_zero(_t(F))
    vs = torch.cat([h, q[..., -1:, :]], -2)
    _, ps = associative_scan(lambda a, b: _comp_suffix(b, a), (Ms, vs),
                             reverse=True, dim=d)
    Gu = r + _mv(_t(B), Pc + ps[..., 1:, :])
    kff = -_mv(Hinv, Gu)
    return _rollout(F, _mv(B, kff) + c, K, kff, dx0, d)
