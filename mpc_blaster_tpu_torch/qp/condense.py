"""Partial condensing: the HPIPM `qp_solver_cond_N` capability.

Port of `mpc_blaster_tpu/qp/condense.py`. Blocks of M consecutive stages
are condensed into one stage of a shorter OCP QP (horizon Nc = N/M,
control dimension M*nu), which the same Mehrotra IPM solves on a Riccati
recursion with cost cross terms S (`qp/riccati.py`).

Structure of one condensed stage j (block of stages k = jM .. jM+M-1):

    x_{jM+i} = Phi_i X_j + Gamma_i U_j + d_i,  i = 0..M
    (Phi_0 = I, Gamma_0 = 0, d_0 = 0; Abar = Phi_M etc.)

- the condensed cost is the exact substitution (S_j = Gamma' Q Phi);
- the boundary states X_j keep their box bounds;
- the interior state boxes become two-sided general constraints
  lbx <= Phi_i X_j + Gamma_i U_j + d_i <= ubx, whose barrier curvature
  lands as dense G' diag(sigma) G updates on the stage Hessian blocks.

In f32 the solve needs, as in the JAX package: the row and column
equilibrations of `condense`, general-constraint slacks started at >= 0.1,
and the square-root Riccati core (`qp/sqrt_riccati.py`, the default for
<= 32-bit dtypes through `sqrt=None`): the plain recursion's dense-barrier
squaring conditions past 1/eps_f32 whenever interior state bounds are
active. The JAX docstring measured the f32 objective 0.12% from the f64
one on the simulation preset's transient QP.

The JAX package's `lax.scan`s over the condensed stages (the rollout, the
refinement's adjoint pass, the merit's adjoint pass) and over the IPM
iterations are Python loops here; every tensor may carry leading batch
axes (QPData fields (..., N, ...)), the batch is vectorised. No Pallas
kernel computes any of this: eager PyTorch is its port.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from mpc_blaster_tpu_torch.qp.data import QPData, QPSolution
from mpc_blaster_tpu_torch.qp.riccati import (_mv, _t, riccati_factorize,
                                              riccati_solve_rhs)
from mpc_blaster_tpu_torch.qp.smallalg import chol_factor
from mpc_blaster_tpu_torch.qp.sqrt_riccati import (sqrt_factorize,
                                                   sqrt_solve_rhs)

_BIG = 1e20


class CondensedQP(NamedTuple):
    """The condensed OCP QP and the block maps needed for expansion.

    Shapes (leading batch axes ..., Nc condensed stages, nx, nU = M*nu,
    ng = (M-1)*nx):
      Abar (Nc, nx, nx); Bbar (Nc, nx, nU); cbar (Nc, nx)
      Qbar (Nc+1, nx, nx); qbar (Nc+1, nx); Rbar (Nc, nU, nU);
      rbar (Nc, nU); Sbar (Nc, nU, nx)
      lbX/ubX (Nc+1, nx) boundary-state boxes (row 0 unused: X_0 pinned)
      lbU/ubU (Nc, nU)
      Gx (Nc, ng, nx); Gu (Nc, ng, nU); goff (Nc, ng); lbg/ubg (Nc, ng)
      gscale (Nc, ng): row-equilibration factors (duals unscale by gscale)
      uscale (Nc, nU): control-column equilibration (dU_real = uscale*dU;
          Gamma/Bbar/Rbar/Sbar/rbar/lbU/ubU/Gu stored pre-scaled)
      Phi (Nc, M, nx, nx); Gamma (Nc, M, nx, nU); dvec (Nc, M, nx)
      dx0 (nx,)
      Crows (Nc, M*(nx+nu), nU+nx): stage-cost row factors, columns
          ordered [U | X], with Crows' Crows = [[Rbar, Sbar],
          [Sbar', Qbar_stage]] (scaled-U space): the square-root core's
          Gram-free stage cost
    """

    Abar: torch.Tensor
    Bbar: torch.Tensor
    cbar: torch.Tensor
    Qbar: torch.Tensor
    qbar: torch.Tensor
    Rbar: torch.Tensor
    rbar: torch.Tensor
    Sbar: torch.Tensor
    lbX: torch.Tensor
    ubX: torch.Tensor
    lbU: torch.Tensor
    ubU: torch.Tensor
    Gx: torch.Tensor
    Gu: torch.Tensor
    goff: torch.Tensor
    lbg: torch.Tensor
    ubg: torch.Tensor
    gscale: torch.Tensor
    uscale: torch.Tensor
    Phi: torch.Tensor
    Gamma: torch.Tensor
    dvec: torch.Tensor
    dx0: torch.Tensor
    Crows: torch.Tensor

    @property
    def ncond(self) -> int:
        return self.Abar.shape[-3]

    @property
    def block(self) -> int:
        return self.Phi.shape[-3]


def condense(data: QPData, M: int) -> CondensedQP:
    """Condense blocks of M stages (N % M == 0), all blocks at once."""
    N, nx, nu = data.horizon, data.nx, data.nu
    if N % M != 0:
        raise ValueError(f"horizon {N} not divisible by block size {M}")
    Nc, nU = N // M, M * nu
    bs = data.A.shape[:-3]
    dtype, dev = data.A.dtype, data.A.device

    A = data.A.reshape(*bs, Nc, M, nx, nx)
    B = data.B.reshape(*bs, Nc, M, nx, nu)
    c = data.c.reshape(*bs, Nc, M, nx)
    Q = data.Q[..., :-1, :, :].reshape(*bs, Nc, M, nx, nx)
    q = data.q[..., :-1, :].reshape(*bs, Nc, M, nx)
    R = data.R.reshape(*bs, Nc, M, nu, nu)
    r = data.r.reshape(*bs, Nc, M, nu)

    # block maps, unrolled over the in-block index i, all Nc blocks at once
    Phi_i = torch.eye(nx, dtype=dtype, device=dev).expand(*bs, Nc, nx, nx)
    Gam_i = torch.zeros(*bs, Nc, nx, nU, dtype=dtype, device=dev)
    d_i = torch.zeros(*bs, Nc, nx, dtype=dtype, device=dev)
    Phis, Gams, ds = [Phi_i], [Gam_i], [d_i]
    for i in range(M):
        A_i = A[..., i, :, :]
        Phi_i = A_i @ Phi_i
        Gam_i = A_i @ Gam_i
        Gam_i = torch.cat([Gam_i[..., :i * nu],
                           Gam_i[..., i * nu:(i + 1) * nu] + B[..., i, :, :],
                           Gam_i[..., (i + 1) * nu:]], -1)
        d_i = _mv(A_i, d_i) + c[..., i, :]
        Phis.append(Phi_i)
        Gams.append(Gam_i)
        ds.append(d_i)
    Phi = torch.stack(Phis[:M], -3)       # (..., Nc, M, nx, nx)
    Gamma = torch.stack(Gams[:M], -3)     # (..., Nc, M, nx, nU)
    dvec = torch.stack(ds[:M], -2)        # (..., Nc, M, nx)

    # condensed cost (exact substitution; constants dropped)
    Qbar_stage = torch.einsum("...cmji,...cmjk,...cmkl->...cil", Phi, Q, Phi)
    Sbar = torch.einsum("...cmji,...cmjk,...cmkl->...cil", Gamma, Q, Phi)
    Rcross = torch.einsum("...cmji,...cmjk,...cmkl->...cil", Gamma, Q,
                          Gamma)
    Rblk = torch.zeros(*bs, Nc, nU, nU, dtype=dtype, device=dev)
    for i in range(M):
        Rblk[..., i * nu:(i + 1) * nu, i * nu:(i + 1) * nu] = R[..., i, :, :]
    Rbar = Rblk + Rcross
    qd = _mv(Q, dvec) + q
    qbar_stage = torch.einsum("...cmji,...cmj->...ci", Phi, qd)
    rbar = r.reshape(*bs, Nc, nU) + torch.einsum("...cmji,...cmj->...ci",
                                                 Gamma, qd)
    Qbar = torch.cat([Qbar_stage, data.Q[..., -1:, :, :]], -3)
    qbar = torch.cat([qbar_stage, data.q[..., -1:, :]], -2)

    # interior state boxes -> general constraints (i = 1..M-1), each row
    # of [Gx | Gu] scaled to unit norm (bounds and offsets along): the
    # barrier weights then spread by activity only, not by ||row||^2
    ng = (M - 1) * nx
    Gx = Phi[..., 1:, :, :].reshape(*bs, Nc, ng, nx)
    Gu = Gamma[..., 1:, :, :].reshape(*bs, Nc, ng, nU)
    goff = dvec[..., 1:, :].reshape(*bs, Nc, ng)
    lbg = data.lbx[..., :-1, :].reshape(*bs, Nc, M, nx)[..., 1:, :] \
        .reshape(*bs, Nc, ng)
    ubg = data.ubx[..., :-1, :].reshape(*bs, Nc, M, nx)[..., 1:, :] \
        .reshape(*bs, Nc, ng)
    rownorm = torch.sqrt((Gx * Gx).sum(-1) + (Gu * Gu).sum(-1))
    rscale = 1.0 / torch.clamp(rownorm, min=1e-8)      # (..., Nc, ng)
    Gx = Gx * rscale[..., None]
    Gu = Gu * rscale[..., None]
    goff = goff * rscale
    lbg = lbg * rscale        # +-inf bounds stay +-inf
    ubg = ubg * rscale

    Abar, Bbar, cbar = Phis[M], Gams[M], ds[M]

    # control-column equilibration: dU_i scaled by 1/sqrt of the a-priori
    # curvature h_i = Rbar_ii + sum_c Bbar_ci^2 Qdiag_{j+1,c}, so H_uu's
    # diagonal sits at O(1) (the blaster cost spans ~11 decades, which f32
    # cannot factor); `expand` and the dual scatter undo it
    Qdiag_next = torch.diagonal(Qbar[..., 1:, :, :], dim1=-2, dim2=-1)
    h = (torch.diagonal(Rbar, dim1=-2, dim2=-1)
         + torch.einsum("...cji,...cj->...ci", Bbar ** 2, Qdiag_next))
    uscale = 1.0 / torch.sqrt(torch.clamp(h, min=1e-12))     # (..., Nc, nU)
    Bbar = Bbar * uscale[..., None, :]
    Rbar = Rbar * uscale[..., :, None] * uscale[..., None, :]
    Sbar = Sbar * uscale[..., :, None]
    rbar = rbar * uscale
    Gu = Gu * uscale[..., None, :]
    Gamma_s = Gamma * uscale[..., None, None, :]
    lbU = data.lbu.reshape(*bs, Nc, nU) / uscale
    ubU = data.ubu.reshape(*bs, Nc, nU) / uscale

    # stage-cost row factors for the square-root core: every row is an
    # original fine-stage cost factor pushed through the block maps, so
    # the Gram [[Rbar, Sbar], [Sbar', Qbar_stage]] is never formed
    #   fine Q_m rows: Lq_m' [Gamma_m | Phi_m]   (Q_m = Lq_m Lq_m')
    #   fine R_m rows: Lr_m' into column block m (uscale-scaled)
    Lq = chol_factor(Q)                                   # (..., Nc, M, nx, nx)
    GP = torch.cat([Gamma_s, Phi], -1)                    # (..., Nc, M, nx, nU+nx)
    Qrows = torch.einsum("...cmki,...cmkj->...cmij", Lq, GP).reshape(
        *bs, Nc, M * nx, nU + nx)
    Lr = chol_factor(R)                                   # (..., Nc, M, nu, nu)
    Rrows = torch.zeros(*bs, Nc, M, nu, nU + nx, dtype=dtype, device=dev)
    for i in range(M):
        Rrows[..., i, :, i * nu:(i + 1) * nu] = (
            _t(Lr[..., i, :, :]) * uscale[..., None, i * nu:(i + 1) * nu])
    Crows = torch.cat([Qrows, Rrows.reshape(*bs, Nc, M * nu, nU + nx)], -2)

    return CondensedQP(
        Abar=Abar, Bbar=Bbar, cbar=cbar,
        Qbar=Qbar, qbar=qbar, Rbar=Rbar, rbar=rbar, Sbar=Sbar,
        lbX=data.lbx[..., ::M, :], ubX=data.ubx[..., ::M, :],
        lbU=lbU, ubU=ubU,
        Gx=Gx, Gu=Gu, goff=goff, lbg=lbg, ubg=ubg, gscale=rscale,
        uscale=uscale, Phi=Phi, Gamma=Gamma_s, dvec=dvec, dx0=data.dx0,
        Crows=Crows)


def expand(cqp: CondensedQP, dX: torch.Tensor, dU: torch.Tensor):
    """The full trajectory from condensed decision variables: dX
    (..., Nc+1, nx) boundary states, dU (..., Nc, nU). Returns (dx
    (..., N+1, nx), du (..., N, nu)), the interior states reconstructed
    from the block maps (dynamics-consistent by construction)."""
    Nc, M = cqp.ncond, cqp.block
    nx = cqp.Abar.shape[-1]
    nu = cqp.Bbar.shape[-1] // M
    bs = dX.shape[:-2]
    dx_blocks = (torch.einsum("...cmij,...cj->...cmi", cqp.Phi,
                              dX[..., :-1, :])
                 + torch.einsum("...cmij,...cj->...cmi", cqp.Gamma, dU)
                 + cqp.dvec)
    dx = torch.cat([dx_blocks.reshape(*bs, Nc * M, nx), dX[..., -1:, :]], -2)
    return dx, (dU * cqp.uscale).reshape(*bs, Nc * M, nu)


class _CGS(NamedTuple):
    """Condensed-IPM state: boundary-X / U / general slack-dual pairs."""

    dX: torch.Tensor
    dU: torch.Tensor
    s_lX: torch.Tensor
    s_uX: torch.Tensor
    lam_lX: torch.Tensor
    lam_uX: torch.Tensor
    s_lU: torch.Tensor
    s_uU: torch.Tensor
    lam_lU: torch.Tensor
    lam_uU: torch.Tensor
    s_lg: torch.Tensor
    s_ug: torch.Tensor
    lam_lg: torch.Tensor
    lam_ug: torch.Tensor


def condensed_qp_solve(data: QPData, M: int, iters: int = 12,
                       mu0: float = 1e-1, alpha_frac: float = 0.995,
                       reg: float = 1e-9, s_min: float = 1e-3,
                       mu_min: float = 1e-12, refine: int = 1,
                       sqrt: bool | None = None) -> QPSolution:
    """Solve the OCP QP (leading batch axes allowed) by partial condensing
    with block size M: the QPData and QPSolution of `box_qp_solve`, the
    duals re-scattered to the per-stage shape. Condensed solves are cold.

    sqrt: use the square-root Riccati core (`qp/sqrt_riccati.py`). None
    (the default) is on for <= 32-bit dtypes, where the plain recursion's
    dense barrier squaring is unsolvable, off for f64, where the plain
    path is accurate and cheaper. refine: passes of iterative refinement
    on each Newton solve.
    """
    return _csolve(condense(data, M), data, iters, mu0, alpha_frac, reg,
                   s_min, mu_min, refine, sqrt)


def _where(m, a, b):
    return torch.where(m, a, torch.as_tensor(b, dtype=a.dtype,
                                             device=a.device))


def _csolve(cqp: CondensedQP, data: QPData, iters, mu0, alpha_frac, reg,
            s_min, mu_min, refine=1, sqrt=None):
    Nc, M = cqp.ncond, cqp.block
    nx, nU = cqp.Abar.shape[-1], cqp.Bbar.shape[-1]
    bs = cqp.Abar.shape[:-3]
    dtype, dev = cqp.Abar.dtype, cqp.Abar.device
    f32 = torch.finfo(dtype).bits <= 32
    if sqrt is None:
        sqrt = f32
    if f32:
        mu_min = max(mu_min, 1e-7)
        reg = max(reg, 1e-6)
        sigma_max = lam_max = 1e7
        eps_s = 1e-9
    else:
        sigma_max = lam_max = 1e14
        eps_s = 1e-16
    big = torch.tensor(_BIG, dtype=dtype, device=dev)
    inf = torch.tensor(float("inf"), dtype=dtype, device=dev)

    lbX, ubX = cqp.lbX[..., 1:, :], cqp.ubX[..., 1:, :]
    mask_lX, mask_uX = torch.isfinite(lbX), torch.isfinite(ubX)
    mask_lU, mask_uU = torch.isfinite(cqp.lbU), torch.isfinite(cqp.ubU)
    mask_lg, mask_ug = torch.isfinite(cqp.lbg), torch.isfinite(cqp.ubg)
    mks = (mask_lX, mask_uX, mask_lU, mask_uU, mask_lg, mask_ug)

    # ----- init: rollout, then clamp boundary states and controls into
    # their boxes -----
    dU0 = cqp.rbar * 0
    x, tail = cqp.dx0, []
    for j in range(Nc):
        x = (_mv(cqp.Abar[..., j, :, :], x) + _mv(cqp.Bbar[..., j, :, :],
                                                  dU0[..., j, :])
             + cqp.cbar[..., j, :])
        tail.append(x)
    dX_tail = torch.stack(tail, -2)

    def clamp_into(v, lb, ub, mask_l, mask_u):
        width = _where(mask_l & mask_u, ub - lb, 1.0)
        inset = 0.1 * width
        lo = torch.where(mask_l, lb + inset, -big)
        hi = torch.where(mask_u, ub - inset, big)
        return torch.minimum(torch.maximum(v, lo), torch.maximum(hi, lo))

    dX_tail = clamp_into(dX_tail, lbX, ubX, mask_lX, mask_uX)
    dU0 = clamp_into(dU0, cqp.lbU, cqp.ubU, mask_lU, mask_uU)
    dX0_traj = torch.cat([cqp.dx0.unsqueeze(-2), dX_tail], -2)

    def gvals(dX, dU):
        """General-constraint values per condensed stage (from the block
        start state, rows 0..Nc-1, the pinned dX_0 included)."""
        return _mv(cqp.Gx, dX[..., :-1, :]) + _mv(cqp.Gu, dU) + cqp.goff

    def init_pair(gap, mask, floor=s_min):
        s = torch.where(mask, torch.clamp(gap, min=floor), big)
        return s, _where(mask, mu0 / s, 0.0)

    # general-constraint slacks start at >= 0.1 (the rows are unit-
    # normalized, so 0.1 is scale-meaningful): at s_min a violated interior
    # row puts sigma ~ 1e5 on dense directions of G' sigma G, past f32
    v_g0 = gvals(dX0_traj, dU0)
    s_lX, lam_lX = init_pair(dX0_traj[..., 1:, :] - lbX, mask_lX)
    s_uX, lam_uX = init_pair(ubX - dX0_traj[..., 1:, :], mask_uX)
    s_lU, lam_lU = init_pair(dU0 - cqp.lbU, mask_lU)
    s_uU, lam_uU = init_pair(cqp.ubU - dU0, mask_uU)
    s_lg, lam_lg = init_pair(v_g0 - cqp.lbg, mask_lg, 0.1)
    s_ug, lam_ug = init_pair(cqp.ubg - v_g0, mask_ug, 0.1)
    st0 = _CGS(dX=dX0_traj, dU=dU0,
               s_lX=s_lX, s_uX=s_uX, lam_lX=lam_lX, lam_uX=lam_uX,
               s_lU=s_lU, s_uU=s_uU, lam_lU=lam_lU, lam_uU=lam_uU,
               s_lg=s_lg, s_ug=s_ug, lam_lg=lam_lg, lam_ug=lam_ug)

    def psum(x):
        return x.sum((-2, -1))

    n_ineq = torch.clamp(sum(psum(m) for m in mks).to(dtype), min=1.0)
    eye_x = torch.eye(nx, dtype=dtype, device=dev)
    eye_U = torch.eye(nU, dtype=dtype, device=dev)
    dX0_zero = cqp.dx0 * 0

    def e(a):
        """A per-problem scalar against (..., rows, cols) tensors."""
        return a[..., None, None]

    def comp_sum(st):
        return (psum(_where(mask_lX, st.s_lX * st.lam_lX, 0.0))
                + psum(_where(mask_uX, st.s_uX * st.lam_uX, 0.0))
                + psum(_where(mask_lU, st.s_lU * st.lam_lU, 0.0))
                + psum(_where(mask_uU, st.s_uU * st.lam_uU, 0.0))
                + psum(_where(mask_lg, st.s_lg * st.lam_lg, 0.0))
                + psum(_where(mask_ug, st.s_ug * st.lam_ug, 0.0)))

    def max_step(v, dv, mask, tau):
        if v.numel() == 0:    # M=1: no interior stages, ng == 0
            return inf.expand(bs)
        neg = dv < 0
        ratio = torch.where(mask & neg, -tau * v / _where(neg, dv, -1.0),
                            inf)
        return ratio.amin((-2, -1))

    def iteration(st: _CGS) -> _CGS:
        mu_cur = comp_sum(st) / n_ineq
        v_g = gvals(st.dX, st.dU)

        # slack residuals (infeasible start)
        r_slX = _where(mask_lX, st.s_lX - (st.dX[..., 1:, :] - lbX), 0.0)
        r_suX = _where(mask_uX, st.s_uX - (ubX - st.dX[..., 1:, :]), 0.0)
        r_slU = _where(mask_lU, st.s_lU - (st.dU - cqp.lbU), 0.0)
        r_suU = _where(mask_uU, st.s_uU - (cqp.ubU - st.dU), 0.0)
        r_slg = _where(mask_lg, st.s_lg - (v_g - cqp.lbg), 0.0)
        r_sug = _where(mask_ug, st.s_ug - (cqp.ubg - v_g), 0.0)

        sig_X = (_where(mask_lX, st.lam_lX / st.s_lX, 0.0)
                 + _where(mask_uX, st.lam_uX / st.s_uX, 0.0))
        sig_U = (_where(mask_lU, st.lam_lU / st.s_lU, 0.0)
                 + _where(mask_uU, st.lam_uU / st.s_uU, 0.0))
        sig_g = (_where(mask_lg, st.lam_lg / st.s_lg, 0.0)
                 + _where(mask_ug, st.lam_ug / st.s_ug, 0.0))
        sig_X = torch.clamp(sig_X, max=sigma_max)
        sig_U = torch.clamp(sig_U, max=sigma_max)
        sig_g = torch.clamp(sig_g, max=sigma_max)

        # stage Hessian updates: box sigmas diagonal, the general
        # (interior-state) sigmas dense G' diag(sig) G blocks
        zx = torch.zeros_like(cqp.Qbar[..., :1, :, :])
        GxS = cqp.Gx * sig_g[..., None]
        GuS = cqp.Gu * sig_g[..., None]
        Qmod = (cqp.Qbar
                + torch.cat([zx, sig_X[..., None] * eye_x], -3)
                + torch.cat([torch.einsum("...cgi,...cgj->...cij", GxS,
                                          cqp.Gx), zx], -3))
        Rmod = (cqp.Rbar + sig_U[..., None] * eye_U
                + torch.einsum("...cgi,...cgj->...cij", GuS, cqp.Gu))
        Smod = cqp.Sbar + torch.einsum("...cgi,...cgj->...cij", GuS, cqp.Gx)
        if sqrt:
            # square-root core: barrier rows stacked onto the stored cost
            # row factors; the modified Hessians above only evaluate
            # residuals (refinement, merit), they are never factored.
            # sig_X applies to stages 1..Nc: stage k's cost carries
            # sig_X[k-1] (k=0's state is pinned), the terminal one goes
            # into Z_N
            rowsU = torch.cat(
                [torch.sqrt(sig_U + reg)[..., None] * eye_U,
                 cqp.Bbar.new_zeros(*bs, Nc, nU, nx)], -1)
            sigX_stage = torch.cat([torch.zeros_like(sig_X[..., :1, :]),
                                    sig_X[..., :-1, :]], -2)
            rowsX = torch.cat(
                [cqp.Bbar.new_zeros(*bs, Nc, nx, nU),
                 torch.sqrt(sigX_stage)[..., None] * eye_x], -1)
            rowsG = torch.sqrt(sig_g)[..., None] * torch.cat(
                [cqp.Gu, cqp.Gx], -1)
            C = torch.cat([cqp.Crows, rowsU, rowsX, rowsG], -2)
            ZN = _t(chol_factor(Qmod[..., -1, :, :]))
            fac = sqrt_factorize(cqp.Abar, cqp.Bbar, C, ZN)

            def solve_rhs_fn(c_, q_, r_):
                return sqrt_solve_rhs(fac, cqp.Abar, cqp.Bbar, c_, q_, r_,
                                      dX0_zero)
        else:
            fac = riccati_factorize(cqp.Abar, cqp.Bbar, Qmod, Rmod, reg,
                                    S=Smod)

            def solve_rhs_fn(c_, q_, r_):
                return riccati_solve_rhs(fac, cqp.Abar, cqp.Bbar, c_, q_,
                                         r_, dX0_zero)

        zv = torch.zeros_like(cqp.qbar[..., :1, :])
        gX_full = (_mv(cqp.Qbar, st.dX) + cqp.qbar
                   + torch.cat([_mv(_t(cqp.Sbar), st.dU), zv], -2))
        gU_full = (_mv(cqp.Rbar, st.dU) + cqp.rbar
                   + _mv(cqp.Sbar, st.dX[..., :-1, :]))
        r_eq = (cqp.cbar + _mv(cqp.Abar, st.dX[..., :-1, :])
                + _mv(cqp.Bbar, st.dU) - st.dX[..., 1:, :])

        def rhs_grads(T_lX, T_uX, T_lU, T_uU, T_lg, T_ug):
            # lam/s and T/s capped at sigma_max, as in qp/ipm.py: with
            # slacks at the eps floor the divides overflow f32
            def slam(lam, s):
                return torch.clamp(lam / s, max=sigma_max)

            def cdiv(T, s):
                return torch.clamp(T / s, -sigma_max, sigma_max)

            bX = (- _where(mask_lX, cdiv(T_lX, st.s_lX), 0.0)
                  - _where(mask_lX, slam(st.lam_lX, st.s_lX), 0.0) * r_slX
                  + _where(mask_uX, cdiv(T_uX, st.s_uX), 0.0)
                  + _where(mask_uX, slam(st.lam_uX, st.s_uX), 0.0) * r_suX)
            bU = (- _where(mask_lU, cdiv(T_lU, st.s_lU), 0.0)
                  - _where(mask_lU, slam(st.lam_lU, st.s_lU), 0.0) * r_slU
                  + _where(mask_uU, cdiv(T_uU, st.s_uU), 0.0)
                  + _where(mask_uU, slam(st.lam_uU, st.s_uU), 0.0) * r_suU)
            bg = (- _where(mask_lg, cdiv(T_lg, st.s_lg), 0.0)
                  - _where(mask_lg, slam(st.lam_lg, st.s_lg), 0.0) * r_slg
                  + _where(mask_ug, cdiv(T_ug, st.s_ug), 0.0)
                  + _where(mask_ug, slam(st.lam_ug, st.s_ug), 0.0) * r_sug)
            q_rhs = (gX_full + torch.cat([zv, bX], -2)
                     + torch.cat([_mv(_t(cqp.Gx), bg), zv], -2))
            r_rhs = gU_full + bU + _mv(_t(cqp.Gu), bg)
            return q_rhs, r_rhs

        def refine_dirs(d_dX, d_dU, q_rhs, r_rhs):
            """One pass of iterative refinement on the reduced Newton
            solve: recover the multipliers by the adjoint recursion (the
            x-rows are then exact), form the u-row and dynamics residuals,
            re-solve with the same factorization and correct."""
            lam = _mv(Qmod[..., -1, :, :], d_dX[..., -1, :]) + q_rhs[..., -1, :]
            res_u = [None] * Nc
            for k in range(Nc - 1, -1, -1):
                S_k = Smod[..., k, :, :]
                dX_k, dU_k = d_dX[..., k, :], d_dU[..., k, :]
                res_u[k] = (_mv(Rmod[..., k, :, :], dU_k) + r_rhs[..., k, :]
                            + _mv(S_k, dX_k)
                            + _mv(_t(cqp.Bbar[..., k, :, :]), lam))
                lam = (_mv(Qmod[..., k, :, :], dX_k) + q_rhs[..., k, :]
                       + _mv(_t(S_k), dU_k)
                       + _mv(_t(cqp.Abar[..., k, :, :]), lam))
            res_c = (r_eq + _mv(cqp.Abar, d_dX[..., :-1, :])
                     + _mv(cqp.Bbar, d_dU) - d_dX[..., 1:, :])
            dd_dX, dd_dU = solve_rhs_fn(res_c, torch.zeros_like(q_rhs),
                                        torch.stack(res_u, -2))
            return d_dX + dd_dX, d_dU + dd_dU

        def directions(Ts):
            T_lX, T_uX, T_lU, T_uU, T_lg, T_ug = Ts
            q_rhs, r_rhs = rhs_grads(*Ts)
            d_dX, d_dU = solve_rhs_fn(r_eq, q_rhs, r_rhs)
            for _ in range(refine):
                d_dX, d_dU = refine_dirs(d_dX, d_dU, q_rhs, r_rhs)
            dv_g = _mv(cqp.Gx, d_dX[..., :-1, :]) + _mv(cqp.Gu, d_dU)
            d_slX = _where(mask_lX, d_dX[..., 1:, :] - r_slX, 0.0)
            d_suX = _where(mask_uX, -d_dX[..., 1:, :] - r_suX, 0.0)
            d_slU = _where(mask_lU, d_dU - r_slU, 0.0)
            d_suU = _where(mask_uU, -d_dU - r_suU, 0.0)
            d_slg = _where(mask_lg, dv_g - r_slg, 0.0)
            d_sug = _where(mask_ug, -dv_g - r_sug, 0.0)

            def dl(lam, s, ds, T, mask):
                # clamped: with s at the eps floor the divide can reach
                # inf, and a_d*inf with a collapsed dual step is NaN
                return _where(mask, torch.clamp((T - s * lam - lam * ds) / s,
                                                -1e12, 1e12), 0.0)
            return (d_dX, d_dU,
                    (d_slX, d_suX, d_slU, d_suU, d_slg, d_sug),
                    (dl(st.lam_lX, st.s_lX, d_slX, T_lX, mask_lX),
                     dl(st.lam_uX, st.s_uX, d_suX, T_uX, mask_uX),
                     dl(st.lam_lU, st.s_lU, d_slU, T_lU, mask_lU),
                     dl(st.lam_uU, st.s_uU, d_suU, T_uU, mask_uU),
                     dl(st.lam_lg, st.s_lg, d_slg, T_lg, mask_lg),
                     dl(st.lam_ug, st.s_ug, d_sug, T_ug, mask_ug)))

        ss = (st.s_lX, st.s_uX, st.s_lU, st.s_uU, st.s_lg, st.s_ug)
        lams = (st.lam_lX, st.lam_uX, st.lam_lU, st.lam_uU,
                st.lam_lg, st.lam_ug)

        def alphas(dss, dls, tau):
            a_p = torch.ones(bs, dtype=dtype, device=dev)
            a_d = torch.ones(bs, dtype=dtype, device=dev)
            for s, ds, lam, dl_, m in zip(ss, dss, lams, dls, mks):
                a_p = torch.minimum(a_p, max_step(s, ds, m, tau))
                a_d = torch.minimum(a_d, max_step(lam, dl_, m, tau))
            return (e(torch.clamp(a_p, max=1.0)),
                    e(torch.clamp(a_d, max=1.0)))

        zeros = tuple(torch.zeros_like(s) for s in
                      (r_slX, r_suX, r_slU, r_suU, r_slg, r_sug))
        # ---- predictor ----
        _, _, aff_s, aff_l = directions(zeros)
        a_p_aff, a_d_aff = alphas(aff_s, aff_l, 1.0)
        mu_aff = sum(psum(_where(m, (s + a_p_aff * ds)
                                 * (lam + a_d_aff * dl_), 0.0))
                     for s, ds, lam, dl_, m in zip(ss, aff_s, lams, aff_l,
                                                   mks)) / n_ineq
        ratio = mu_aff / torch.clamp(mu_cur, min=mu_min)
        sigma = torch.clamp(ratio * ratio * ratio, 0.0, 1.0)
        mu_t = e(torch.clamp(sigma * mu_cur, min=mu_min))

        # ---- corrector (Gondzio clipping) ----
        def target(ds, dl_):
            return torch.minimum(torch.maximum(mu_t - ds * dl_, 0.05 * mu_t),
                                 20.0 * mu_t)
        Ts = tuple(_where(m, target(ds, dl_), 0.0)
                   for ds, dl_, m in zip(aff_s, aff_l, mks))
        d_dX, d_dU, dss, dls = directions(Ts)
        a_p, a_d = alphas(dss, dls, alpha_frac)

        new_s = [torch.where(m, torch.clamp(s + a_p * ds, min=eps_s), big)
                 for s, ds, m in zip(ss, dss, mks)]
        new_l = [torch.clamp(lam + a_d * dl_, 0.0, lam_max)
                 for lam, dl_ in zip(lams, dls)]
        return _CGS(
            dX=st.dX + a_p * d_dX, dU=st.dU + a_p * d_dU,
            s_lX=new_s[0], s_uX=new_s[1], lam_lX=new_l[0], lam_uX=new_l[1],
            s_lU=new_s[2], s_uU=new_s[3], lam_lU=new_l[2], lam_uU=new_l[3],
            s_lg=new_s[4], s_ug=new_s[5], lam_lg=new_l[4], lam_ug=new_l[5])

    def merit(st: _CGS):
        """Stationarity by the condensed adjoint recursion + equality +
        complementarity, each per problem."""
        lam_Xb = (_where(mask_lX, st.lam_lX, 0.0)
                  - _where(mask_uX, st.lam_uX, 0.0))     # stages 1..Nc
        lam_Ub = (_where(mask_lU, st.lam_lU, 0.0)
                  - _where(mask_uU, st.lam_uU, 0.0))
        lam_gb = (_where(mask_lg, st.lam_lg, 0.0)
                  - _where(mask_ug, st.lam_ug, 0.0))     # (..., Nc, ng)
        lam = (_mv(cqp.Qbar[..., -1, :, :], st.dX[..., -1, :])
               + cqp.qbar[..., -1, :] - lam_Xb[..., -1, :])
        stat = None
        for k in range(Nc - 1, -1, -1):
            S_k = cqp.Sbar[..., k, :, :]
            dX_k, dU_k, lgb = st.dX[..., k, :], st.dU[..., k, :], \
                lam_gb[..., k, :]
            stat_u = (_mv(cqp.Rbar[..., k, :, :], dU_k) + cqp.rbar[..., k, :]
                      + _mv(S_k, dX_k)
                      + _mv(_t(cqp.Bbar[..., k, :, :]), lam)
                      - lam_Ub[..., k, :] - _mv(_t(cqp.Gu[..., k, :, :]), lgb))
            m_k = stat_u.abs().amax(-1)
            stat = m_k if stat is None else torch.maximum(stat, m_k)
            lam = (_mv(cqp.Qbar[..., k, :, :], dX_k) + cqp.qbar[..., k, :]
                   + _mv(_t(S_k), dU_k)
                   + _mv(_t(cqp.Abar[..., k, :, :]), lam))
            if k >= 1:
                lam = lam - lam_Xb[..., k - 1, :]
            lam = lam - _mv(_t(cqp.Gx[..., k, :, :]), lgb)
        kkt_eq = (st.dX[..., 1:, :] - _mv(cqp.Abar, st.dX[..., :-1, :])
                  - _mv(cqp.Bbar, st.dU) - cqp.cbar).abs().amax((-2, -1))
        return stat + kkt_eq + comp_sum(st) / n_ineq, stat, kkt_eq

    best, st = st0, st0
    best_m, _, _ = merit(st0)
    for _ in range(iters):
        st = iteration(st)
        m, _, _ = merit(st)
        better = m < best_m
        best = _CGS(*(torch.where(e(better), n, b) for n, b in zip(st, best)))
        best_m = torch.where(better, m, best_m)
    _, kkt_stat, kkt_eq = merit(best)

    # ----- expansion back to the full horizon -----
    dx, du = expand(cqp, best.dX, best.dU)
    nu = du.shape[-1]
    N = Nc * M

    def scatter_state_duals(lam_bound, lam_gen):
        """(..., Nc, nx) boundary + (..., Nc, ng) interior -> (..., N, nx)
        stages 1..N: block j gives stages jM+1..jM+M, the interiors from
        the general duals, the block end from lam_bound[j]."""
        interior = lam_gen.reshape(*bs, Nc, M - 1, nx)
        per_block = torch.cat([interior, lam_bound.unsqueeze(-2)], -2)
        return per_block.reshape(*bs, N, nx)

    # scaled-row multipliers -> original-unit bound multipliers
    lam_lx = scatter_state_duals(
        _where(mask_lX, best.lam_lX, 0.0),
        _where(mask_lg, best.lam_lg * cqp.gscale, 0.0))
    lam_ux = scatter_state_duals(
        _where(mask_uX, best.lam_uX, 0.0),
        _where(mask_ug, best.lam_ug * cqp.gscale, 0.0))
    lam_lu = _where(mask_lU, best.lam_lU / cqp.uscale, 0.0).reshape(
        *bs, N, nu)
    lam_uu = _where(mask_uU, best.lam_uU / cqp.uscale, 0.0).reshape(
        *bs, N, nu)
    return QPSolution(
        dx=dx, du=du, lam_lx=lam_lx, lam_ux=lam_ux, lam_lu=lam_lu,
        lam_uu=lam_uu, mu=comp_sum(best) / n_ineq, kkt_stat=kkt_stat,
        kkt_eq=kkt_eq, iters=torch.tensor(iters))
