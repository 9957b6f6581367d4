"""Box-constrained OCP-QP via Mehrotra predictor-corrector IPM + Riccati.

Port of `mpc_blaster_tpu/qp/ipm.py` (the Riccati IPM behind
`qp_backend="riccati"`, the presets' default), with its four inner Newton
solvers (`riccati=`): "scan", the sequential per-stage sweeps of
`qp/riccati.py`; "pscan", the log-depth factorization and right-hand-side
solves of `qp/pscan.py`; "hybrid", the sequential factorization with the
log-depth solves; "sqrt", the square-root factorization of
`qp/sqrt_riccati.py`. Every mode but "scan" evaluates the merit's adjoint
recursion as a suffix scan too (`_kkt_residuals_pscan`).

  - static iteration budget; the best iterate by KKT merit is returned,
    so iterations past convergence are harmless;
  - per iteration ONE Riccati factorization and TWO right-hand-side
    solves (Mehrotra predictor + corrector);
  - infeasible start: slacks are independent variables, so a
    bound-violating warm start is fine;
  - separate primal/dual fraction-to-boundary steps, from masked
    reductions.

Every tensor may carry leading batch axes (QPData fields (..., N, ...),
IpmWarmStart.valid (...,)): the batch is vectorised, the stages are a
Python loop. Bounds may be +-inf; masked entries contribute nothing.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from mpc_blaster_tpu_torch.device import resolve_device
from mpc_blaster_tpu_torch.qp.data import QPData, QPSolution
from mpc_blaster_tpu_torch.qp.pscan import (_append_zero, _comp_suffix,
                                            associative_scan,
                                            riccati_factorize_pscan,
                                            riccati_solve_rhs_pscan)
from mpc_blaster_tpu_torch.qp.riccati import (_mv, _t, riccati_factorize,
                                              riccati_solve_rhs)
from mpc_blaster_tpu_torch.qp.sqrt_riccati import (riccati_factorize_sqrt,
                                                   sqrt_solve_rhs)

_BIG = 1e20  # slack value standing in for an infinite bound
_RICCATI_BACKENDS = ("scan", "pscan", "hybrid", "sqrt")


class _IpmState(NamedTuple):
    dx: torch.Tensor      # (..., N+1, nx)
    du: torch.Tensor      # (..., N, nu)
    s_lx: torch.Tensor    # (..., N, nx)  slacks, states 1..N
    s_ux: torch.Tensor
    lam_lx: torch.Tensor
    lam_ux: torch.Tensor
    s_lu: torch.Tensor    # (..., N, nu)
    s_uu: torch.Tensor
    lam_lu: torch.Tensor
    lam_uu: torch.Tensor


class IpmWarmStart(NamedTuple):
    """Slack/dual warm start from a previous tick's solve (HPIPM
    warm_start=1 analog). Slacks are absolute bound distances, so they
    transfer across RTI ticks. `valid` gates the blend per problem: 0 ->
    cold start (first tick)."""

    s_lx: torch.Tensor
    s_ux: torch.Tensor
    lam_lx: torch.Tensor
    lam_ux: torch.Tensor
    s_lu: torch.Tensor
    s_uu: torch.Tensor
    lam_lu: torch.Tensor
    lam_uu: torch.Tensor
    valid: torch.Tensor  # (...,) 0/1

    @staticmethod
    def zeros(N: int, nx: int, nu: int, dtype=torch.float32, device=None):
        device = resolve_device(device)
        zx = torch.zeros((N, nx), dtype=dtype, device=device)
        zu = torch.zeros((N, nu), dtype=dtype, device=device)
        return IpmWarmStart(zx, zx, zx, zx, zu, zu, zu, zu,
                            torch.zeros((), dtype=dtype, device=device))


def _where(m, a, b):
    return torch.where(m, a, torch.as_tensor(b, dtype=a.dtype,
                                             device=a.device))


def _clip(x, lo, hi):
    return torch.minimum(torch.maximum(x, lo), hi)


def box_qp_solve(data: QPData, iters: int = 12, mu0: float = 1e-1,
                 alpha_frac: float = 0.995, reg: float = 1e-9,
                 s_min: float = 1e-3, mu_min: float = 1e-12,
                 warm_du: torch.Tensor | None = None,
                 warm: IpmWarmStart | None = None,
                 riccati: str = "scan") -> QPSolution:
    """Solve the box-constrained OCP QP (leading batch axes allowed).

    warm_du: optional (..., N, nu) control warm start, rolled out through
    the dynamics to seed the primal trajectory. warm: optional slack/dual
    warm start, blended over the cold centred init where warm.valid > 0.5.
    riccati: the inner Newton-system solver, "scan", "pscan", "hybrid" or
    "sqrt" (the module docstring).
    """
    if riccati not in _RICCATI_BACKENDS:
        raise ValueError(f"riccati={riccati!r}; expected one of "
                         f"{_RICCATI_BACKENDS}")
    if riccati == "scan":
        factorize, solve_rhs = riccati_factorize, riccati_solve_rhs
    elif riccati == "sqrt":
        factorize, solve_rhs = riccati_factorize_sqrt, sqrt_solve_rhs
    else:
        factorize = (riccati_factorize_pscan if riccati == "pscan"
                     else riccati_factorize)
        solve_rhs = riccati_solve_rhs_pscan
    kkt_fn = _kkt_residuals if riccati == "scan" else _kkt_residuals_pscan
    N = data.horizon
    dtype, dev = data.A.dtype, data.A.device
    # dtype-aware floors: f32 cannot resolve complementarity products
    # below ~1e-7 against O(1e3) cost weights
    if torch.finfo(dtype).bits <= 32:
        mu_min = max(mu_min, 1e-7)
        reg = max(reg, 1e-6)
        sigma_max = lam_max = 1e7   # keeps chol(H_uu) positive definite
        eps_s = 1e-9
    else:
        sigma_max = lam_max = 1e14
        eps_s = 1e-16
    big = torch.tensor(_BIG, dtype=dtype, device=dev)
    inf = torch.tensor(float("inf"), dtype=dtype, device=dev)

    lbx, ubx = data.lbx[..., 1:, :], data.ubx[..., 1:, :]
    lbu, ubu = data.lbu, data.ubu
    mask_lx, mask_ux = torch.isfinite(lbx), torch.isfinite(ubx)
    mask_lu, mask_uu = torch.isfinite(lbu), torch.isfinite(ubu)

    # ----- initial primal point: roll out the dynamics, then clamp states
    # and controls 10%-of-width inside the box (stage 0 stays pinned) -----
    du0 = torch.zeros_like(data.r) if warm_du is None else warm_du
    x, tail = data.dx0, []
    for k in range(N):
        x = (_mv(data.A[..., k, :, :], x) + _mv(data.B[..., k, :, :],
                                                du0[..., k, :])
             + data.c[..., k, :])
        tail.append(x)
    dx_tail = torch.stack(tail, -2)

    def clamp_into(v, lb, ub, ml, mu_):
        width = _where(ml & mu_, ub - lb, 1.0)
        inset = 0.1 * width
        lo = torch.where(ml, lb + inset, -big)
        hi = torch.where(mu_, ub - inset, big)
        return _clip(v, lo, torch.maximum(hi, lo))

    dx_tail = clamp_into(dx_tail, lbx, ubx, mask_lx, mask_ux)
    du0 = clamp_into(du0, lbu, ubu, mask_lu, mask_uu)
    dx0_traj = torch.cat([data.dx0.unsqueeze(-2), dx_tail], -2)

    # centred start: s from the actual gap (clamped positive), lam = mu0/s
    def init_slack(gap, mask):
        return torch.where(mask, torch.clamp(gap, min=s_min), big)

    s_lx = init_slack(dx_tail - lbx, mask_lx)
    s_ux = init_slack(ubx - dx_tail, mask_ux)
    s_lu = init_slack(du0 - lbu, mask_lu)
    s_uu = init_slack(ubu - du0, mask_uu)
    lam_lx = _where(mask_lx, mu0 / s_lx, 0.0)
    lam_ux = _where(mask_ux, mu0 / s_ux, 0.0)
    lam_lu = _where(mask_lu, mu0 / s_lu, 0.0)
    lam_uu = _where(mask_uu, mu0 / s_uu, 0.0)

    if warm is not None:
        # per-problem gate, per-entry isfinite guard: a NaN warm entry
        # falls back to the cold init instead of poisoning the chain
        use = (torch.as_tensor(warm.valid, device=dev) > 0.5)[..., None,
                                                              None]

        def blend(w, cold, mask):
            w = _clip(torch.where(mask, w.to(dtype), big), big.new_tensor(
                s_min * 1e-2), big)
            return torch.where(use & mask & torch.isfinite(w), w, cold)

        def blend_l(w, cold, mask):
            w = _clip(w.to(dtype), big.new_tensor(0.0),
                      big.new_tensor(lam_max))
            return torch.where(use & mask & torch.isfinite(w),
                               torch.clamp(w, min=1e-8), cold)

        s_lx = blend(warm.s_lx, s_lx, mask_lx)
        s_ux = blend(warm.s_ux, s_ux, mask_ux)
        s_lu = blend(warm.s_lu, s_lu, mask_lu)
        s_uu = blend(warm.s_uu, s_uu, mask_uu)
        lam_lx = blend_l(warm.lam_lx, lam_lx, mask_lx)
        lam_ux = blend_l(warm.lam_ux, lam_ux, mask_ux)
        lam_lu = blend_l(warm.lam_lu, lam_lu, mask_lu)
        lam_uu = blend_l(warm.lam_uu, lam_uu, mask_uu)

    state = _IpmState(dx=dx0_traj, du=du0, s_lx=s_lx, s_ux=s_ux,
                      lam_lx=lam_lx, lam_ux=lam_ux, s_lu=s_lu, s_uu=s_uu,
                      lam_lu=lam_lu, lam_uu=lam_uu)
    masks = (mask_lx, mask_ux, mask_lu, mask_uu)
    n_ineq = torch.clamp(sum(m.sum((-2, -1)) for m in masks).to(dtype),
                         min=1.0)
    dx0_zero = torch.zeros_like(data.dx0)

    def psum(x):
        return x.sum((-2, -1))

    def comp_sum(st):
        return (psum(_where(mask_lx, st.s_lx * st.lam_lx, 0.0))
                + psum(_where(mask_ux, st.s_ux * st.lam_ux, 0.0))
                + psum(_where(mask_lu, st.s_lu * st.lam_lu, 0.0))
                + psum(_where(mask_uu, st.s_uu * st.lam_uu, 0.0)))

    def max_step(v, dv, mask, tau):
        neg = dv < 0
        ratio = torch.where(mask & neg,
                            -tau * v / _where(neg, dv, -1.0), inf)
        return ratio.amin((-2, -1))

    def iteration(st: _IpmState) -> _IpmState:
        mu_cur = comp_sum(st) / n_ineq
        # bound residuals (infeasible start): r_s = s - gap
        r_slx = _where(mask_lx, st.s_lx - (st.dx[..., 1:, :] - lbx), 0.0)
        r_sux = _where(mask_ux, st.s_ux - (ubx - st.dx[..., 1:, :]), 0.0)
        r_slu = _where(mask_lu, st.s_lu - (st.du - lbu), 0.0)
        r_suu = _where(mask_uu, st.s_uu - (ubu - st.du), 0.0)

        # diagonal Hessian modification and factorization (once per iter)
        sig_x = (_where(mask_lx, st.lam_lx / st.s_lx, 0.0)
                 + _where(mask_ux, st.lam_ux / st.s_ux, 0.0))
        sig_u = (_where(mask_lu, st.lam_lu / st.s_lu, 0.0)
                 + _where(mask_uu, st.lam_uu / st.s_uu, 0.0))
        sig_x = torch.clamp(sig_x, max=sigma_max)
        sig_u = torch.clamp(sig_u, max=sigma_max)
        Qmod = torch.cat([data.Q[..., :1, :, :],
                          data.Q[..., 1:, :, :] + torch.diag_embed(sig_x)],
                         -3)
        Rmod = data.R + torch.diag_embed(sig_u)
        fac = factorize(data.A, data.B, Qmod, Rmod, reg)

        gx_full = _mv(data.Q, st.dx) + data.q
        gu_full = _mv(data.R, st.du) + data.r
        # dynamics residual of the current iterate
        r_eq = (data.c + _mv(data.A, st.dx[..., :-1, :])
                + _mv(data.B, st.du) - st.dx[..., 1:, :])

        def rhs_grads(T_lx, T_ux, T_lu, T_uu):
            """gbar for per-constraint complementarity targets T; the
            lam/s factors and centring forces capped at sigma_max."""
            slam_lx = torch.clamp(st.lam_lx / st.s_lx, max=sigma_max)
            slam_ux = torch.clamp(st.lam_ux / st.s_ux, max=sigma_max)
            slam_lu = torch.clamp(st.lam_lu / st.s_lu, max=sigma_max)
            slam_uu = torch.clamp(st.lam_uu / st.s_uu, max=sigma_max)

            def cdiv(T, s):
                return torch.clamp(T / s, -sigma_max, sigma_max)
            bx = (- _where(mask_lx, cdiv(T_lx, st.s_lx), 0.0)
                  - _where(mask_lx, slam_lx, 0.0) * r_slx
                  + _where(mask_ux, cdiv(T_ux, st.s_ux), 0.0)
                  + _where(mask_ux, slam_ux, 0.0) * r_sux)
            bu = (- _where(mask_lu, cdiv(T_lu, st.s_lu), 0.0)
                  - _where(mask_lu, slam_lu, 0.0) * r_slu
                  + _where(mask_uu, cdiv(T_uu, st.s_uu), 0.0)
                  + _where(mask_uu, slam_uu, 0.0) * r_suu)
            q_rhs = torch.cat([gx_full[..., :1, :], gx_full[..., 1:, :] + bx],
                              -2)
            return q_rhs, gu_full + bu

        def directions(q_rhs, r_rhs, T_lx, T_ux, T_lu, T_uu):
            d_dx, d_du = solve_rhs(fac, data.A, data.B, r_eq, q_rhs, r_rhs,
                                   dx0_zero)
            d_slx = _where(mask_lx, d_dx[..., 1:, :] - r_slx, 0.0)
            d_sux = _where(mask_ux, -d_dx[..., 1:, :] - r_sux, 0.0)
            d_slu = _where(mask_lu, d_du - r_slu, 0.0)
            d_suu = _where(mask_uu, -d_du - r_suu, 0.0)

            def dl(lam, s, ds, T, mask):
                # clamped: with s at the eps floor the divide can reach inf
                return _where(mask, torch.clamp((T - s * lam - lam * ds) / s,
                                                -1e12, 1e12), 0.0)
            return (d_dx, d_du, d_slx, d_sux, d_slu, d_suu,
                    dl(st.lam_lx, st.s_lx, d_slx, T_lx, mask_lx),
                    dl(st.lam_ux, st.s_ux, d_sux, T_ux, mask_ux),
                    dl(st.lam_lu, st.s_lu, d_slu, T_lu, mask_lu),
                    dl(st.lam_uu, st.s_uu, d_suu, T_uu, mask_uu))

        def alphas(dirs, tau):
            (_, _, d_slx, d_sux, d_slu, d_suu,
             d_llx, d_lux, d_llu, d_luu) = dirs
            a_p = torch.minimum(
                torch.minimum(max_step(st.s_lx, d_slx, mask_lx, tau),
                              max_step(st.s_ux, d_sux, mask_ux, tau)),
                torch.minimum(max_step(st.s_lu, d_slu, mask_lu, tau),
                              max_step(st.s_uu, d_suu, mask_uu, tau)))
            a_d = torch.minimum(
                torch.minimum(max_step(st.lam_lx, d_llx, mask_lx, tau),
                              max_step(st.lam_ux, d_lux, mask_ux, tau)),
                torch.minimum(max_step(st.lam_lu, d_llu, mask_lu, tau),
                              max_step(st.lam_uu, d_luu, mask_uu, tau)))
            return (torch.clamp(a_p, max=1.0)[..., None, None],
                    torch.clamp(a_d, max=1.0)[..., None, None])

        # ---- predictor (affine scaling, target 0) ----
        zs_x, zs_u = torch.zeros_like(r_slx), torch.zeros_like(r_slu)
        aff = directions(*rhs_grads(zs_x, zs_x, zs_u, zs_u),
                         zs_x, zs_x, zs_u, zs_u)
        ap, ad = alphas(aff, 1.0)
        (_, _, a_slx, a_sux, a_slu, a_suu, a_llx, a_lux, a_llu, a_luu) = aff
        mu_aff = (
            psum(_where(mask_lx, (st.s_lx + ap * a_slx)
                        * (st.lam_lx + ad * a_llx), 0.0))
            + psum(_where(mask_ux, (st.s_ux + ap * a_sux)
                          * (st.lam_ux + ad * a_lux), 0.0))
            + psum(_where(mask_lu, (st.s_lu + ap * a_slu)
                          * (st.lam_lu + ad * a_llu), 0.0))
            + psum(_where(mask_uu, (st.s_uu + ap * a_suu)
                          * (st.lam_uu + ad * a_luu), 0.0))) / n_ineq
        ratio = mu_aff / torch.clamp(mu_cur, min=mu_min)
        sigma = torch.clamp(ratio * ratio * ratio, 0.0, 1.0)
        mu_t = torch.clamp(sigma * mu_cur, min=mu_min)[..., None, None]

        # ---- corrector: Gondzio-clipped Mehrotra targets ----
        def target(ds, dl_):
            return _clip(mu_t - ds * dl_, 0.05 * mu_t, 20.0 * mu_t)
        T = (_where(mask_lx, target(a_slx, a_llx), 0.0),
             _where(mask_ux, target(a_sux, a_lux), 0.0),
             _where(mask_lu, target(a_slu, a_llu), 0.0),
             _where(mask_uu, target(a_suu, a_luu), 0.0))
        dirs = directions(*rhs_grads(*T), *T)
        a_p, a_d = alphas(dirs, alpha_frac)
        (d_dx, d_du, d_slx, d_sux, d_slu, d_suu,
         d_llx, d_lux, d_llu, d_luu) = dirs

        def upd_s(s, ds, mask):
            return torch.where(mask, torch.clamp(s + a_p * ds, min=eps_s),
                               big)

        def upd_l(lam, dl_):
            return torch.clamp(lam + a_d * dl_, 0.0, lam_max)

        return _IpmState(
            dx=st.dx + a_p * d_dx, du=st.du + a_p * d_du,
            s_lx=upd_s(st.s_lx, d_slx, mask_lx),
            s_ux=upd_s(st.s_ux, d_sux, mask_ux),
            lam_lx=upd_l(st.lam_lx, d_llx), lam_ux=upd_l(st.lam_ux, d_lux),
            s_lu=upd_s(st.s_lu, d_slu, mask_lu),
            s_uu=upd_s(st.s_uu, d_suu, mask_uu),
            lam_lu=upd_l(st.lam_lu, d_llu), lam_uu=upd_l(st.lam_uu, d_luu))

    def merit(st: _IpmState):
        """KKT merit for best-iterate selection: stationarity + equality +
        complementarity, all -> 0 at the solution."""
        kkt_stat, kkt_eq = kkt_fn(data, st, *masks)
        return kkt_stat + kkt_eq + comp_sum(st) / n_ineq, kkt_stat, kkt_eq

    # interior-point iterations are not a contraction once converged, so
    # the best iterate by merit is tracked and returned
    best, (best_m, _, _) = state, merit(state)
    for _ in range(iters):
        state = iteration(state)
        m, _, _ = merit(state)
        better = m < best_m
        bb = better[..., None, None]
        best = _IpmState(*(torch.where(bb, n, b)
                           for n, b in zip(state, best)))
        best_m = torch.where(better, m, best_m)

    _, kkt_stat, kkt_eq = merit(best)
    return QPSolution(
        dx=best.dx, du=best.du,
        lam_lx=best.lam_lx, lam_ux=best.lam_ux,
        lam_lu=best.lam_lu, lam_uu=best.lam_uu,
        mu=comp_sum(best) / n_ineq, kkt_stat=kkt_stat, kkt_eq=kkt_eq,
        iters=torch.tensor(iters),
        s_lx=best.s_lx, s_ux=best.s_ux, s_lu=best.s_lu, s_uu=best.s_uu)


def warm_start_from(sol: QPSolution, shift: bool = False) -> IpmWarmStart:
    """The next tick's warm start from a solve's slacks/duals. shift=True
    moves every stage one forward (the last one repeated), to pair with
    `sqp.rti.shift_state`."""
    def sh(a):
        if not shift:
            return a
        return torch.cat([a[..., 1:, :], a[..., -1:, :]], -2)

    return IpmWarmStart(
        s_lx=sh(sol.s_lx), s_ux=sh(sol.s_ux),
        lam_lx=sh(sol.lam_lx), lam_ux=sh(sol.lam_ux),
        s_lu=sh(sol.s_lu), s_uu=sh(sol.s_uu),
        lam_lu=sh(sol.lam_lu), lam_uu=sh(sol.lam_uu),
        valid=torch.ones(sol.dx.shape[:-2], dtype=sol.dx.dtype,
                         device=sol.dx.device))


def warm_start_recenter(warm: IpmWarmStart, mu0: float = 1e-1,
                        mode: str = "centrality",
                        band=(0.1, 10.0)) -> IpmWarmStart:
    """Tame a slack/dual warm start, keeping the slack geometry:
    mode="primal" re-centres every dual at lam = mu0/s (only primal
    information carries over); mode="centrality" clips each
    complementarity product into [band[0]*mu0, band[1]*mu0] by rescaling
    lam. Returns a new IpmWarmStart (same `valid`)."""
    lo, hi = band
    if mode not in ("primal", "centrality"):
        raise ValueError(f"unknown warm recenter mode {mode!r}")

    def recenter(s, lam):
        s_safe = torch.clamp(s, min=1e-9)
        if mode == "primal":
            return mu0 / s_safe
        return torch.clamp(s_safe * lam, lo * mu0, hi * mu0) / s_safe

    return warm._replace(
        lam_lx=recenter(warm.s_lx, warm.lam_lx),
        lam_ux=recenter(warm.s_ux, warm.lam_ux),
        lam_lu=recenter(warm.s_lu, warm.lam_lu),
        lam_uu=recenter(warm.s_uu, warm.lam_uu))


def _kkt_residuals(data: QPData, st: _IpmState, mask_lx, mask_ux,
                   mask_lu, mask_uu):
    """Stationarity (adjoint recursion over the stages) and equality
    residual of an iterate, each reduced per problem."""
    N = data.horizon
    lam_x_bnd = (_where(mask_lx, st.lam_lx, 0.0)
                 - _where(mask_ux, st.lam_ux, 0.0))   # stages 1..N
    lam_u_bnd = (_where(mask_lu, st.lam_lu, 0.0)
                 - _where(mask_uu, st.lam_uu, 0.0))
    lam = (_mv(data.Q[..., N, :, :], st.dx[..., N, :]) + data.q[..., N, :]
           - lam_x_bnd[..., N - 1, :])
    stat = None
    for k in range(N - 1, -1, -1):
        A_k, B_k = data.A[..., k, :, :], data.B[..., k, :, :]
        stat_u = (_mv(data.R[..., k, :, :], st.du[..., k, :])
                  + data.r[..., k, :] + _mv(_t(B_k), lam)
                  - lam_u_bnd[..., k, :])
        m = stat_u.abs().amax(-1)
        stat = m if stat is None else torch.maximum(stat, m)
        lam = (_mv(data.Q[..., k, :, :], st.dx[..., k, :]) + data.q[..., k, :]
               + _mv(_t(A_k), lam))
        if k >= 1:
            lam = lam - lam_x_bnd[..., k - 1, :]
    kkt_eq = (st.dx[..., 1:, :] - _mv(data.A, st.dx[..., :-1, :])
              - _mv(data.B, st.du) - data.c).abs().amax((-2, -1))
    return stat, kkt_eq


def _kkt_residuals_pscan(data: QPData, st: _IpmState, mask_lx, mask_ux,
                         mask_lu, mask_uu):
    """`_kkt_residuals` with the adjoint recursion lam_k = A_k' lam_{k+1} +
    v_k as a log-depth suffix scan of affine maps (the companion of
    `qp/pscan.py::riccati_solve_rhs_pscan`)."""
    lam_x_bnd = (_where(mask_lx, st.lam_lx, 0.0)
                 - _where(mask_ux, st.lam_ux, 0.0))   # stages 1..N
    lam_u_bnd = (_where(mask_lu, st.lam_lu, 0.0)
                 - _where(mask_uu, st.lam_uu, 0.0))
    lamN = (_mv(data.Q[..., -1, :, :], st.dx[..., -1, :]) + data.q[..., -1, :]
            - lam_x_bnd[..., -1, :])
    # stage k carries the bound duals of state k (k = 1..N-1; stage 0's
    # costate is unused)
    lxb_for_stage = torch.cat([torch.zeros_like(lam_x_bnd[..., :1, :]),
                               lam_x_bnd[..., :-1, :]], -2)
    v = (_mv(data.Q[..., :-1, :, :], st.dx[..., :-1, :]) + data.q[..., :-1, :]
         - lxb_for_stage)
    Ms = _append_zero(_t(data.A))
    vs = torch.cat([v, lamN.unsqueeze(-2)], -2)
    _, lams = associative_scan(lambda a, b: _comp_suffix(b, a), (Ms, vs),
                               reverse=True, dim=data.A.dim() - 3)
    stat_u = (_mv(data.R, st.du) + data.r + _mv(_t(data.B), lams[..., 1:, :])
              - lam_u_bnd)
    kkt_eq = (st.dx[..., 1:, :] - _mv(data.A, st.dx[..., :-1, :])
              - _mv(data.B, st.du) - data.c).abs().amax((-2, -1))
    return stat_u.abs().amax((-2, -1)), kkt_eq
