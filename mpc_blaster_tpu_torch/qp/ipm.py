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

`box_qp_solve(..., mesh=)` shards the stage axis over an "hp" mesh (and
the ranks of a process group; `qp/horizon.py`), as the JAX package runs
the same solve on a QP whose stage axis is sharded (GSPMD). `_ipm_hp` is
the same iteration on one chunk: the per-stage work stays on the chunk,
the reductions over the stage axis (n_ineq, mu, the step lengths, the
merit's maxima) run over the chunks and then the ranks, and the rows
where stages meet (dx_{k+1}, the costates) come from the next chunk. In
"pscan" mode every recursion is `qp/pscan.py`'s sharded scan; "hybrid"
runs its factorization, and "scan" and "sqrt" their factorization and
solves ("scan" also its merit's adjoint recursion), sequentially on the
whole horizon gathered to each process's first device (every rank
computes the same), each chunk keeping its rows of the result. The
initial rollout is a sharded prefix scan in every mode.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from mpc_blaster_tpu_torch.device import resolve_device
from mpc_blaster_tpu_torch.qp import horizon as hp
from mpc_blaster_tpu_torch.qp.data import QPData, QPSolution
from mpc_blaster_tpu_torch.qp.pscan import (_append_zero, _comp_suffix,
                                            _factorize_hp, _solve_rhs_hp,
                                            _states_hp, associative_scan,
                                            riccati_factorize_pscan,
                                            riccati_solve_rhs_pscan)
from mpc_blaster_tpu_torch.qp.riccati import (RiccatiFactor, _mv, _t,
                                              riccati_factorize,
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
    return torch.where(m, a, b)


def _clip(x, lo, hi):
    return torch.minimum(torch.maximum(x, lo), hi)


def box_qp_solve(data: QPData, iters: int = 12, mu0: float = 1e-1,
                 alpha_frac: float = 0.995, reg: float = 1e-9,
                 s_min: float = 1e-3, mu_min: float = 1e-12,
                 warm_du: torch.Tensor | None = None,
                 warm: IpmWarmStart | None = None,
                 riccati: str = "scan", mesh=None) -> QPSolution:
    """Solve the box-constrained OCP QP (leading batch axes allowed).

    warm_du: optional (..., N, nu) control warm start, rolled out through
    the dynamics to seed the primal trajectory. warm: optional slack/dual
    warm start, blended over the cold centred init where warm.valid > 0.5.
    riccati: the inner Newton-system solver, "scan", "pscan", "hybrid" or
    "sqrt" (the module docstring). mesh: an "hp" mesh to shard the stage
    axis over (the module docstring; `qp/horizon.py` for the layout).
    """
    if riccati not in _RICCATI_BACKENDS:
        raise ValueError(f"riccati={riccati!r}; expected one of "
                         f"{_RICCATI_BACKENDS}")
    if mesh is not None:
        opts = dict(iters=iters, mu0=mu0, alpha_frac=alpha_frac, reg=reg,
                    s_min=s_min, mu_min=mu_min, riccati=riccati)
        return hp.shard_map(
            mesh, lambda ch, d, wd, w: _ipm_hp(ch, d, wd, w, **opts),
            (data, warm_du, warm), (_QP_KINDS, hp.STAGE, _WARM_KINDS),
            _SOL_KINDS, data.A.dim() - 3)
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
    mu_min, reg, sigma_max, lam_max, eps_s = _floors(dtype, mu_min, reg)
    big = torch.full((), _BIG, dtype=dtype, device=dev)
    inf = torch.full((), float("inf"), dtype=dtype, device=dev)

    bounds = (data.lbx[..., 1:, :], data.ubx[..., 1:, :], data.lbu,
              data.ubu)
    masks = tuple(torch.isfinite(b) for b in bounds)

    # ----- initial primal point: roll out the dynamics, then clamp states
    # and controls 10%-of-width inside the box (stage 0 stays pinned) -----
    du0 = torch.zeros_like(data.r) if warm_du is None else warm_du
    x, tail = data.dx0, []
    for k in range(N):
        x = (_mv(data.A[..., k, :, :], x) + _mv(data.B[..., k, :, :],
                                                du0[..., k, :])
             + data.c[..., k, :])
        tail.append(x)
    dx_tail = _clamp_into(torch.stack(tail, -2), *bounds[:2], *masks[:2],
                          big)
    du0 = _clamp_into(du0, *bounds[2:], *masks[2:], big)
    state = _start(torch.cat([data.dx0.unsqueeze(-2), dx_tail], -2),
                   dx_tail, du0, bounds, masks, mu0, s_min, big, warm,
                   lam_max)
    n_ineq = torch.clamp(sum(m.sum((-2, -1)) for m in masks).to(dtype),
                         min=1.0)
    dx0_zero = torch.zeros_like(data.dx0)

    def iteration(st: _IpmState) -> _IpmState:
        mu_cur = _comp_sum(st, masks) / n_ineq
        r_s = _residuals(st, st.dx[..., 1:, :], bounds, masks)
        # diagonal Hessian modification and factorization (once per iter)
        sig_x, sig_u = _sigmas(st, masks, sigma_max)
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

        def directions(T):
            bx, bu = _bound_rhs(st, masks, r_s, T, sigma_max)
            q_rhs = torch.cat([gx_full[..., :1, :], gx_full[..., 1:, :] + bx],
                              -2)
            d_dx, d_du = solve_rhs(fac, data.A, data.B, r_eq, q_rhs,
                                   gu_full + bu, dx0_zero)
            return _directions(st, d_dx, d_dx[..., 1:, :], d_du, r_s, T,
                               masks)

        def alphas(dirs, tau):
            a_p, a_d = _step_lengths(st, dirs, masks, tau, inf)
            return (torch.clamp(a_p, max=1.0)[..., None, None],
                    torch.clamp(a_d, max=1.0)[..., None, None])

        # ---- predictor (affine scaling, target 0) ----
        zs_x, zs_u = torch.zeros_like(r_s[0]), torch.zeros_like(r_s[2])
        aff = directions((zs_x, zs_x, zs_u, zs_u))
        ap, ad = alphas(aff, 1.0)
        mu_t = _centring(_mu_aff_sum(st, aff, ap, ad, masks) / n_ineq,
                         mu_cur, mu_min)
        # ---- corrector: Gondzio-clipped Mehrotra targets ----
        T = _corrector_targets(aff, mu_t, masks)
        dirs = directions(T)
        a_p, a_d = alphas(dirs, alpha_frac)
        return _step(st, dirs, a_p, a_d, masks, eps_s, big, lam_max)

    def merit(st: _IpmState):
        """KKT merit for best-iterate selection: stationarity + equality +
        complementarity, all -> 0 at the solution."""
        kkt_stat, kkt_eq = kkt_fn(data, st, *masks)
        return (kkt_stat + kkt_eq + _comp_sum(st, masks) / n_ineq, kkt_stat,
                kkt_eq)

    # interior-point iterations are not a contraction once converged, so
    # the best iterate by merit is tracked and returned
    best, (best_m, _, _) = state, merit(state)
    for _ in range(iters):
        state = iteration(state)
        best, best_m = _keep_better(state, merit(state)[0], best, best_m)

    _, kkt_stat, kkt_eq = merit(best)
    return _solution(best, _comp_sum(best, masks) / n_ineq, kkt_stat, kkt_eq,
                     iters)


# ---- the iteration's stage-wise steps, shared by `box_qp_solve` and the
# horizon-sharded `_ipm_hp`. `bounds` are (lbx, ubx, lbu, ubu) and `masks`
# their finite entries; the state bounds are those of the states `x` a
# step takes: `box_qp_solve` passes states 1..N, `_ipm_hp` its chunk's
# states (state 0 masked). ----

def _floors(dtype, mu_min, reg):
    """(mu_min, reg, sigma_max, lam_max, eps_s) for `dtype`: f32 cannot
    resolve complementarity products below ~1e-7 against O(1e3) cost
    weights, and lam/s capped at 1e7 keeps chol(H_uu) positive definite."""
    if torch.finfo(dtype).bits <= 32:
        return max(mu_min, 1e-7), max(reg, 1e-6), 1e7, 1e7, 1e-9
    return mu_min, reg, 1e14, 1e14, 1e-16


def _clamp_into(v, lb, ub, ml, mu_, big):
    """v clamped 10%-of-width inside its box where the bounds are finite."""
    width = _where(ml & mu_, ub - lb, 1.0)
    inset = 0.1 * width
    lo = torch.where(ml, lb + inset, -big)
    hi = torch.where(mu_, ub - inset, big)
    return _clip(v, lo, torch.maximum(hi, lo))


def _start(dx, x, du, bounds, masks, mu0, s_min, big, warm, lam_max
           ) -> _IpmState:
    """The first iterate at the clamped primal point (dx; x its bounded
    states): a centred start, s from the actual gap (clamped positive)
    and lam = mu0/s, blended with `warm` per problem where warm.valid >
    0.5 and per entry where the warm value is finite (a NaN warm entry
    falls back to the cold init instead of poisoning the chain)."""
    mask_lx, mask_ux, mask_lu, mask_uu = masks
    lbx, ubx, lbu, ubu = bounds

    def init_slack(gap, mask):
        return torch.where(mask, torch.clamp(gap, min=s_min), big)

    s = (init_slack(x - lbx, mask_lx), init_slack(ubx - x, mask_ux),
         init_slack(du - lbu, mask_lu), init_slack(ubu - du, mask_uu))
    lam = tuple(_where(m, mu0 / s_i, 0.0) for s_i, m in zip(s, masks))
    if warm is not None:
        dtype = dx.dtype
        use = (torch.as_tensor(warm.valid, device=dx.device)
               > 0.5)[..., None, None]

        def blend(w, cold, mask):
            w = _clip(torch.where(mask, w.to(dtype), big), big.new_full(
                (), s_min * 1e-2), big)
            return torch.where(use & mask & torch.isfinite(w), w, cold)

        def blend_l(w, cold, mask):
            w = _clip(w.to(dtype), big.new_full((), 0.0),
                      big.new_full((), lam_max))
            return torch.where(use & mask & torch.isfinite(w),
                               torch.clamp(w, min=1e-8), cold)

        s = tuple(blend(w, c, m) for w, c, m in zip(
            (warm.s_lx, warm.s_ux, warm.s_lu, warm.s_uu), s, masks))
        lam = tuple(blend_l(w, c, m) for w, c, m in zip(
            (warm.lam_lx, warm.lam_ux, warm.lam_lu, warm.lam_uu), lam,
            masks))
    return _IpmState(dx=dx, du=du, s_lx=s[0], s_ux=s[1], lam_lx=lam[0],
                     lam_ux=lam[1], s_lu=s[2], s_uu=s[3], lam_lu=lam[2],
                     lam_uu=lam[3])


def _psum(x):
    return x.sum((-2, -1))


def _comp_sum(st: _IpmState, masks):
    """The complementarity products summed per problem."""
    mask_lx, mask_ux, mask_lu, mask_uu = masks
    return (_psum(_where(mask_lx, st.s_lx * st.lam_lx, 0.0))
            + _psum(_where(mask_ux, st.s_ux * st.lam_ux, 0.0))
            + _psum(_where(mask_lu, st.s_lu * st.lam_lu, 0.0))
            + _psum(_where(mask_uu, st.s_uu * st.lam_uu, 0.0)))


def _residuals(st: _IpmState, x, bounds, masks):
    """Bound residuals r_s = s - gap (infeasible start; x the bounded
    states)."""
    mask_lx, mask_ux, mask_lu, mask_uu = masks
    lbx, ubx, lbu, ubu = bounds
    return (_where(mask_lx, st.s_lx - (x - lbx), 0.0),
            _where(mask_ux, st.s_ux - (ubx - x), 0.0),
            _where(mask_lu, st.s_lu - (st.du - lbu), 0.0),
            _where(mask_uu, st.s_uu - (ubu - st.du), 0.0))


def _sigmas(st: _IpmState, masks, sigma_max):
    """lam/s of the states and of the controls, capped at sigma_max."""
    mask_lx, mask_ux, mask_lu, mask_uu = masks
    sig_x = (_where(mask_lx, st.lam_lx / st.s_lx, 0.0)
             + _where(mask_ux, st.lam_ux / st.s_ux, 0.0))
    sig_u = (_where(mask_lu, st.lam_lu / st.s_lu, 0.0)
             + _where(mask_uu, st.lam_uu / st.s_uu, 0.0))
    return (torch.clamp(sig_x, max=sigma_max),
            torch.clamp(sig_u, max=sigma_max))


def _bound_rhs(st: _IpmState, masks, r_s, T, sigma_max):
    """(bx, bu): the bound terms of the gradients for per-constraint
    complementarity targets T; the lam/s factors and centring forces
    capped at sigma_max."""
    mask_lx, mask_ux, mask_lu, mask_uu = masks
    r_slx, r_sux, r_slu, r_suu = r_s
    T_lx, T_ux, T_lu, T_uu = T
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
    return bx, bu


def _directions(st: _IpmState, d_dx, d_x, d_du, r_s, T, masks):
    """The full Newton direction from the primal one (d_x: the directions
    of the states whose bounds are masked by masks[:2])."""
    mask_lx, mask_ux, mask_lu, mask_uu = masks
    r_slx, r_sux, r_slu, r_suu = r_s
    d_slx = _where(mask_lx, d_x - r_slx, 0.0)
    d_sux = _where(mask_ux, -d_x - r_sux, 0.0)
    d_slu = _where(mask_lu, d_du - r_slu, 0.0)
    d_suu = _where(mask_uu, -d_du - r_suu, 0.0)

    def dl(lam, s, ds, T, mask):
        # clamped: with s at the eps floor the divide can reach inf
        return _where(mask, torch.clamp((T - s * lam - lam * ds) / s,
                                        -1e12, 1e12), 0.0)
    return (d_dx, d_du, d_slx, d_sux, d_slu, d_suu,
            dl(st.lam_lx, st.s_lx, d_slx, T[0], mask_lx),
            dl(st.lam_ux, st.s_ux, d_sux, T[1], mask_ux),
            dl(st.lam_lu, st.s_lu, d_slu, T[2], mask_lu),
            dl(st.lam_uu, st.s_uu, d_suu, T[3], mask_uu))


def _max_step(v, dv, mask, tau, inf):
    neg = dv < 0
    ratio = torch.where(mask & neg, -tau * v / _where(neg, dv, -1.0), inf)
    return ratio.amin((-2, -1))


def _step_lengths(st: _IpmState, dirs, masks, tau, inf):
    """The primal and dual fraction-to-boundary steps (uncapped), from
    masked reductions."""
    mask_lx, mask_ux, mask_lu, mask_uu = masks
    (_, _, d_slx, d_sux, d_slu, d_suu, d_llx, d_lux, d_llu, d_luu) = dirs
    a_p = torch.minimum(
        torch.minimum(_max_step(st.s_lx, d_slx, mask_lx, tau, inf),
                      _max_step(st.s_ux, d_sux, mask_ux, tau, inf)),
        torch.minimum(_max_step(st.s_lu, d_slu, mask_lu, tau, inf),
                      _max_step(st.s_uu, d_suu, mask_uu, tau, inf)))
    a_d = torch.minimum(
        torch.minimum(_max_step(st.lam_lx, d_llx, mask_lx, tau, inf),
                      _max_step(st.lam_ux, d_lux, mask_ux, tau, inf)),
        torch.minimum(_max_step(st.lam_lu, d_llu, mask_lu, tau, inf),
                      _max_step(st.lam_uu, d_luu, mask_uu, tau, inf)))
    return a_p, a_d


def _mu_aff_sum(st: _IpmState, aff, ap, ad, masks):
    """The complementarity products after the affine step, summed."""
    mask_lx, mask_ux, mask_lu, mask_uu = masks
    (_, _, a_slx, a_sux, a_slu, a_suu, a_llx, a_lux, a_llu, a_luu) = aff
    return (_psum(_where(mask_lx, (st.s_lx + ap * a_slx)
                         * (st.lam_lx + ad * a_llx), 0.0))
            + _psum(_where(mask_ux, (st.s_ux + ap * a_sux)
                           * (st.lam_ux + ad * a_lux), 0.0))
            + _psum(_where(mask_lu, (st.s_lu + ap * a_slu)
                           * (st.lam_lu + ad * a_llu), 0.0))
            + _psum(_where(mask_uu, (st.s_uu + ap * a_suu)
                           * (st.lam_uu + ad * a_luu), 0.0)))


def _centring(mu_aff, mu_cur, mu_min):
    """Mehrotra's centring target sigma * mu, sigma = (mu_aff / mu)^3."""
    ratio = mu_aff / torch.clamp(mu_cur, min=mu_min)
    sigma = torch.clamp(ratio * ratio * ratio, 0.0, 1.0)
    return torch.clamp(sigma * mu_cur, min=mu_min)[..., None, None]


def _corrector_targets(aff, mu_t, masks):
    """Gondzio-clipped Mehrotra complementarity targets."""
    mask_lx, mask_ux, mask_lu, mask_uu = masks
    (_, _, a_slx, a_sux, a_slu, a_suu, a_llx, a_lux, a_llu, a_luu) = aff

    def target(ds, dl_):
        return _clip(mu_t - ds * dl_, 0.05 * mu_t, 20.0 * mu_t)
    return (_where(mask_lx, target(a_slx, a_llx), 0.0),
            _where(mask_ux, target(a_sux, a_lux), 0.0),
            _where(mask_lu, target(a_slu, a_llu), 0.0),
            _where(mask_uu, target(a_suu, a_luu), 0.0))


def _step(st: _IpmState, dirs, a_p, a_d, masks, eps_s, big, lam_max
          ) -> _IpmState:
    """The next iterate along the direction."""
    mask_lx, mask_ux, mask_lu, mask_uu = masks
    (d_dx, d_du, d_slx, d_sux, d_slu, d_suu,
     d_llx, d_lux, d_llu, d_luu) = dirs

    def upd_s(s, ds, mask):
        return torch.where(mask, torch.clamp(s + a_p * ds, min=eps_s), big)

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


def _keep_better(state: _IpmState, m, best: _IpmState, best_m):
    """(best, best_m) after an iterate of merit m, per problem."""
    better = m < best_m
    bb = better[..., None, None]
    return (_IpmState(*(torch.where(bb, n, b) for n, b in zip(state, best))),
            torch.where(better, m, best_m))


def _solution(best: _IpmState, mu, kkt_stat, kkt_eq, iters) -> QPSolution:
    return QPSolution(
        dx=best.dx, du=best.du,
        lam_lx=best.lam_lx, lam_ux=best.lam_ux,
        lam_lu=best.lam_lu, lam_uu=best.lam_uu,
        mu=mu, kkt_stat=kkt_stat, kkt_eq=kkt_eq,
        iters=torch.full((), iters, device=best.dx.device),
        s_lx=best.s_lx, s_ux=best.s_ux, s_lu=best.s_lu, s_uu=best.s_uu)


_S, _X, _XS, _REP = hp.STAGE, hp.STATE, hp.XS, hp.REP
_QP_KINDS = QPData(A=_S, B=_S, c=_S, Q=_X, q=_X, R=_S, r=_S, lbx=_X, ubx=_X,
                   lbu=_S, ubu=_S, dx0=_REP)
_WARM_KINDS = IpmWarmStart(s_lx=_XS, s_ux=_XS, lam_lx=_XS, lam_ux=_XS,
                           s_lu=_S, s_uu=_S, lam_lu=_S, lam_uu=_S,
                           valid=_REP)
_SOL_KINDS = QPSolution(dx=_X, du=_S, lam_lx=_XS, lam_ux=_XS, lam_lu=_S,
                        lam_uu=_S, mu=_REP, kkt_stat=_REP, kkt_eq=_REP,
                        iters=_REP, s_lx=_XS, s_ux=_XS, s_lu=_S, s_uu=_S)


def _ipm_hp(ch, data: QPData, warm_du, warm, iters, mu0, alpha_frac, reg,
            s_min, mu_min, riccati):
    """`box_qp_solve` on one chunk of a horizon-sharded call (a generator
    run by `horizon.Horizon.run`). The chunk's per-state arrays (dx, Q, q,
    lbx, ubx and the state slacks and duals) hold its states s..e-1 and,
    on the last chunk, N; state 0's bounds are masked out. Step for step
    the iteration of `box_qp_solve`, with the exchanges marked `yield`."""
    n = data.A.shape[-3]
    dtype, dev = data.A.dtype, data.A.device
    mu_min, reg, sigma_max, lam_max, eps_s = _floors(dtype, mu_min, reg)
    big = torch.full((), _BIG, dtype=dtype, device=dev)
    inf = torch.full((), float("inf"), dtype=dtype, device=dev)
    newton = _HpNewton(ch, data, riccati, reg)
    yield from newton.setup()

    def live(m):
        # state 0 is pinned: its bounds never count
        if not ch.first:
            return m
        return torch.cat([torch.zeros_like(m[..., :1, :]), m[..., 1:, :]],
                         -2)
    bounds = (data.lbx, data.ubx, data.lbu, data.ubu)
    masks = (live(torch.isfinite(data.lbx)), live(torch.isfinite(data.ubx)),
             torch.isfinite(data.lbu), torch.isfinite(data.ubu))
    dx0 = yield from ch.bcast_first(data.dx0)

    # the rollout as a prefix scan across the chunks; state 0's row (its
    # bounds masked) is left where it is by the clamp
    du0 = torch.zeros_like(data.r) if warm_du is None else warm_du
    xs = yield from _states_hp(ch, data.A, _mv(data.B, du0) + data.c, dx0)
    dx = _clamp_into(xs if ch.last else xs[..., :-1, :], *bounds[:2],
                     *masks[:2], big)
    du0 = _clamp_into(du0, *bounds[2:], *masks[2:], big)
    state = _start(dx, dx, du0, bounds, masks, mu0, s_min, big, warm,
                   lam_max)
    (n_ineq,) = yield from ch.reduce(
        (sum(m.sum((-2, -1)) for m in masks).to(dtype),), ("sum",))
    n_ineq = torch.clamp(n_ineq, min=1.0)
    dx0_zero = torch.zeros_like(data.dx0)

    def iteration(st: _IpmState):
        (comp,) = yield from ch.reduce((_comp_sum(st, masks),), ("sum",))
        mu_cur = comp / n_ineq
        r_s = _residuals(st, st.dx, bounds, masks)
        sig_x, sig_u = _sigmas(st, masks, sigma_max)
        fac = yield from newton.factorize(data.Q + torch.diag_embed(sig_x),
                                          data.R + torch.diag_embed(sig_u))
        gx_full = _mv(data.Q, st.dx) + data.q
        gu_full = _mv(data.R, st.du) + data.r
        halo = yield from ch.next_first((st.dx,))
        r_eq = (data.c + _mv(data.A, st.dx[..., :n, :])
                + _mv(data.B, st.du) - ch.succ(st.dx, halo and halo[0]))

        def directions(T):
            bx, bu = _bound_rhs(st, masks, r_s, T, sigma_max)
            d_dx, d_du = yield from newton.solve(fac, r_eq, gx_full + bx,
                                                 gu_full + bu, dx0_zero)
            return _directions(st, d_dx, d_dx, d_du, r_s, T, masks)

        def alphas(dirs, tau):
            a_p, a_d = yield from ch.reduce(
                _step_lengths(st, dirs, masks, tau, inf), ("min", "min"))
            return (torch.clamp(a_p, max=1.0)[..., None, None],
                    torch.clamp(a_d, max=1.0)[..., None, None])

        zs_x, zs_u = torch.zeros_like(r_s[0]), torch.zeros_like(r_s[2])
        aff = yield from directions((zs_x, zs_x, zs_u, zs_u))
        ap, ad = yield from alphas(aff, 1.0)
        (aff_sum,) = yield from ch.reduce(
            (_mu_aff_sum(st, aff, ap, ad, masks),), ("sum",))
        mu_t = _centring(aff_sum / n_ineq, mu_cur, mu_min)
        T = _corrector_targets(aff, mu_t, masks)
        dirs = yield from directions(T)
        a_p, a_d = yield from alphas(dirs, alpha_frac)
        return _step(st, dirs, a_p, a_d, masks, eps_s, big, lam_max)

    def merit(st: _IpmState):
        stat, eq = yield from newton.kkt(st, masks)
        stat, eq, comp = yield from ch.reduce(
            (stat, eq, _comp_sum(st, masks)), ("max", "max", "sum"))
        return stat + eq + comp / n_ineq, stat, eq, comp

    best, (best_m, _, _, _) = state, (yield from merit(state))
    for _ in range(iters):
        state = yield from iteration(state)
        m, _, _, _ = yield from merit(state)
        best, best_m = _keep_better(state, m, best, best_m)

    _, kkt_stat, kkt_eq, comp = yield from merit(best)
    return _solution(best, comp / n_ineq, kkt_stat, kkt_eq, iters)


class _HpNewton:
    """The Newton-system solves and the merit's residuals of `_ipm_hp` in
    one Riccati mode (the module docstring): the sharded scans of
    `qp/pscan.py`, or the sequential recursions on the whole horizon."""

    def __init__(self, ch, data: QPData, riccati: str, reg: float):
        self.ch, self.data, self.riccati, self.reg = ch, data, riccati, reg
        self.whole = None   # the whole QP, for the sequential recursions

    def setup(self):
        if self.riccati == "pscan":
            return
        w = yield from self.ch.whole(self.data[:-1], _QP_KINDS[:-1],
                                     lambda *w: w)
        self.whole = QPData(*w, dx0=None)

    def factorize(self, Qmod, Rmod):
        ch, d, reg = self.ch, self.data, self.reg
        if self.riccati == "pscan":
            return (yield from _factorize_hp(ch, d.A, d.B, Qmod, Rmod, reg))
        A, B = self.whole.A, self.whole.B
        fn = (riccati_factorize_sqrt if self.riccati == "sqrt"
              else riccati_factorize)
        fac = yield from ch.whole((Qmod, Rmod), (_X, _S),
                                  lambda Q, R: fn(A, B, Q, R, reg))
        if self.riccati != "hybrid":
            return fac
        # the sequential factor, each chunk its rows, for the sharded solves
        return (RiccatiFactor(K=ch.stage_rows(fac.K),
                              Hinv=ch.stage_rows(fac.Hinv),
                              P=ch.state_rows(fac.P)), ch.next_rows(fac.P))

    def solve(self, fac, c, q, r, dx0):
        ch, d = self.ch, self.data
        if self.riccati in ("pscan", "hybrid"):
            return (yield from _solve_rhs_hp(ch, fac[0], fac[1], d.A, d.B,
                                             c, q, r, dx0))
        A, B = self.whole.A, self.whole.B
        fn = sqrt_solve_rhs if self.riccati == "sqrt" else riccati_solve_rhs
        dx, du = yield from ch.whole(
            (c, q, r), (_S, _X, _S),
            lambda c, q, r: fn(fac, A, B, c, q, r, torch.zeros_like(dx0)))
        return ch.state_rows(dx), ch.stage_rows(du)

    def kkt(self, st: _IpmState, masks):
        """(stat, kkt_eq): this chunk's maxima, or the whole horizon's."""
        ch, d = self.ch, self.data
        if self.riccati != "scan":
            return (yield from _kkt_residuals_hp(ch, d, st, *masks))
        w = self.whole

        def seq(dx, du, lam_lx, lam_ux, lam_lu, lam_uu):
            # the port's layout: the state duals of states 1..N
            st_w = _IpmState(dx=dx, du=du, s_lx=None, s_ux=None,
                             lam_lx=lam_lx[..., 1:, :],
                             lam_ux=lam_ux[..., 1:, :], s_lu=None,
                             s_uu=None, lam_lu=lam_lu, lam_uu=lam_uu)
            return _kkt_residuals(w, st_w, *(torch.isfinite(b) for b in (
                w.lbx[..., 1:, :], w.ubx[..., 1:, :], w.lbu, w.ubu)))
        return (yield from ch.whole(
            (st.dx, st.du, st.lam_lx, st.lam_ux, st.lam_lu, st.lam_uu),
            (_X, _S, _X, _X, _S, _S), seq))


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


def _kkt_residuals_hp(ch, data: QPData, st: _IpmState, mask_lx, mask_ux,
                      mask_lu, mask_uu):
    """`_kkt_residuals_pscan` on one chunk of a horizon-sharded call: the
    adjoint recursion as the sharded suffix scan; this chunk's maxima."""
    n = data.A.shape[-3]
    lam_x_bnd = (_where(mask_lx, st.lam_lx, 0.0)
                 - _where(mask_ux, st.lam_ux, 0.0))
    lam_u_bnd = (_where(mask_lu, st.lam_lu, 0.0)
                 - _where(mask_uu, st.lam_uu, 0.0))
    # the costate of state k takes its bound duals (none at state 0,
    # masked); on the last chunk the terminal row is lam_N
    v = _mv(data.Q, st.dx) + data.q - lam_x_bnd
    (_, lams), _ = yield from ch.scan(lambda a, b: _comp_suffix(b, a),
                                      (ch.pad_terminal(_t(data.A)), v),
                                      reverse=True)
    halo = yield from ch.next_first((lams, st.dx))
    stat_u = (_mv(data.R, st.du) + data.r
              + _mv(_t(data.B), ch.succ(lams, halo and halo[0]))
              - lam_u_bnd)
    kkt_eq = (ch.succ(st.dx, halo and halo[1])
              - _mv(data.A, st.dx[..., :n, :]) - _mv(data.B, st.du)
              - data.c).abs().amax((-2, -1))
    return stat_u.abs().amax((-2, -1)), kkt_eq
