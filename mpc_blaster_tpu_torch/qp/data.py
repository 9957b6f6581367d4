"""Block-structured OCP-QP data as stacked tensors.

Port of `mpc_blaster_tpu/qp/data.py`. Quantities are in delta form around
a linearization trajectory (xbar, ubar): dx_k = x_k - xbar_k,
du_k = u_k - ubar_k. Stage 0 state is pinned (dx_0 = dx0), so state box
bounds apply at stages 1..N and control bounds at 0..N-1.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class QPData(NamedTuple):
    """One OCP-structured QP (or a batch, with a leading axis). Shapes:

    A: (N, nx, nx)     discrete dynamics Jacobians
    B: (N, nx, nu)
    c: (N, nx)         affine defect: dx_{k+1} = A dx + B du + c
    Q: (N+1, nx, nx)   state Hessians (incl. terminal)
    q: (N+1, nx)       state gradients
    R: (N, nu, nu)     control Hessians
    r: (N, nu)         control gradients
    lbx/ubx: (N+1, nx) delta-form state bounds (row 0 unused; +-inf allowed)
    lbu/ubu: (N, nu)   delta-form control bounds
    dx0: (nx,)         pinned initial state delta
    """

    A: torch.Tensor
    B: torch.Tensor
    c: torch.Tensor
    Q: torch.Tensor
    q: torch.Tensor
    R: torch.Tensor
    r: torch.Tensor
    lbx: torch.Tensor
    ubx: torch.Tensor
    lbu: torch.Tensor
    ubu: torch.Tensor
    dx0: torch.Tensor

    @property
    def horizon(self) -> int:
        return self.A.shape[-3]

    @property
    def nx(self) -> int:
        return self.A.shape[-1]

    @property
    def nu(self) -> int:
        return self.B.shape[-1]


class QPSolution(NamedTuple):
    """Primal/dual solution + solver diagnostics (per-solve scalars)."""

    dx: torch.Tensor
    du: torch.Tensor
    lam_lx: Optional[torch.Tensor] = None
    lam_ux: Optional[torch.Tensor] = None
    lam_lu: Optional[torch.Tensor] = None
    lam_uu: Optional[torch.Tensor] = None
    mu: Optional[torch.Tensor] = None
    kkt_stat: Optional[torch.Tensor] = None
    kkt_eq: Optional[torch.Tensor] = None
    iters: Optional[torch.Tensor] = None
    # final slacks (for warm-starting the next RTI tick's solve)
    s_lx: Optional[torch.Tensor] = None
    s_ux: Optional[torch.Tensor] = None
    s_lu: Optional[torch.Tensor] = None
    s_uu: Optional[torch.Tensor] = None


def qp_objective(data: QPData, dx: torch.Tensor,
                 du: torch.Tensor) -> torch.Tensor:
    """0.5 z'Hz + g'z for diagnostics and tests."""
    def quad(M, v):
        return 0.5 * torch.einsum("...i,...ij,...j->...", v, M, v)
    obj = torch.sum(quad(data.Q, dx)) + torch.sum(data.q * dx)
    obj = obj + torch.sum(quad(data.R, du)) + torch.sum(data.r * du)
    return obj
