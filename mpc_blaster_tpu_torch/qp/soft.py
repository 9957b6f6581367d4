"""Soft (slacked) box constraints: the acados ``ns > 0`` machinery.

Port of `mpc_blaster_tpu/qp/soft.py`, eager PyTorch with leading batch
axes as in `qp/ipm.py`. Per-component bound softening with an L1+L2
violation penalty

    lb - t_l <= v <= ub + t_u,   t >= 0,
    cost += z·t + 0.5·Z·t²,

solved by the Mehrotra predictor-corrector + Riccati IPM of `qp/ipm.py`.
The violation variable t and its nonnegativity dual gam are eliminated
stage-wise and component-wise, leaving a hard-bound-shaped system with a
modified barrier weight

    sigma_eff = sigma_s (Z + sigma_t) / (Z + sigma_s + sigma_t),
    sigma_s = lam/s,  sigma_t = gam/t,

(hard bound = limit Z -> inf) plus an extra right-hand-side term: with
d = Z + sigma_s + sigma_t and
w = -r_t + (T_s/s - lam) + (T_t/t - gam) + sigma_s r_s, the violation step
is dt = (w - sigma_s dv)/d and the bound row's forcing gains -sigma_s w/d.

This is the CPU reference and what `qp_backend="riccati"` runs in
`sqp/rti.py::rti_step_soft`; the kernel backends eliminate the same pairs
inside the box-QP IPM kernel (`ops/box_qp_ipm.py`, kernel K4).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from mpc_blaster_tpu_torch.device import resolve_device
from mpc_blaster_tpu_torch.qp.data import QPData, QPSolution
from mpc_blaster_tpu_torch.qp.ipm import (_clip, _IpmState, _kkt_residuals,
                                          _where)
from mpc_blaster_tpu_torch.qp.riccati import (_mv, riccati_factorize,
                                              riccati_solve_rhs)

_BIG = 1e20


class SoftPenalty(NamedTuple):
    """Per-component softening of one bound group.

    Z: quadratic violation weight (>0 where soft)
    z: linear violation weight (>=0; pure-L2 softening uses z=0)
    soft: bool mask of the soft components; the others behave exactly
        like `qp/ipm.py` hard bounds.
    """

    Z: torch.Tensor
    z: torch.Tensor
    soft: torch.Tensor

    @staticmethod
    def hard(shape, dtype=torch.float32, device=None) -> "SoftPenalty":
        device = resolve_device(device)
        return SoftPenalty(
            Z=torch.ones(shape, dtype=dtype, device=device),
            z=torch.zeros(shape, dtype=dtype, device=device),
            soft=torch.zeros(shape, dtype=torch.bool, device=device))


class SoftBounds(NamedTuple):
    """Soft-constraint spec for the four bound groups of the OCP QP.

    lx/ux: (N, nx) state lower/upper (stages 1..N, matching QPData.lbx[1:])
    lu/uu: (N, nu) control lower/upper
    Fields may carry leading batch axes; unbatched ones broadcast.
    """

    lx: SoftPenalty
    ux: SoftPenalty
    lu: SoftPenalty
    uu: SoftPenalty

    @staticmethod
    def state_bounds(N: int, nx: int, nu: int, Zl, zl, Zu=None, zu=None,
                     idx=None, dtype=torch.float32,
                     device=None) -> "SoftBounds":
        """Soften state bounds only (acados `idxsbx`; controls stay hard).

        Zl/zl (and optionally Zu/zu, defaulting to the lower weights) are
        scalars or (nx,) vectors; `idx` optionally restricts softening to a
        subset of state components.
        """
        device = resolve_device(device)
        Zu = Zl if Zu is None else Zu
        zu = zl if zu is None else zu

        def expand(w):
            w = torch.as_tensor(w, dtype=dtype, device=device).expand(nx)
            return w[None].repeat(N, 1)
        mask = torch.zeros(nx, dtype=torch.bool, device=device)
        sel = torch.arange(nx) if idx is None else torch.as_tensor(
            idx, dtype=torch.long)
        mask[sel.to(mask.device)] = True
        mask = mask[None].repeat(N, 1)
        return SoftBounds(
            lx=SoftPenalty(expand(Zl), expand(zl), mask),
            ux=SoftPenalty(expand(Zu), expand(zu), mask),
            lu=SoftPenalty.hard((N, nu), dtype, device),
            uu=SoftPenalty.hard((N, nu), dtype, device))


class _GS(NamedTuple):
    """IPM state of one bound group: slack pair (s, lam) + violation pair
    (t, gam); t/gam are _BIG/0 on non-soft entries (inert)."""

    s: torch.Tensor
    lam: torch.Tensor
    t: torch.Tensor
    gam: torch.Tensor


class SoftQPSolution(NamedTuple):
    """QPSolution + per-group bound violations (zero where hard/inactive)."""

    sol: QPSolution
    t_lx: torch.Tensor
    t_ux: torch.Tensor
    t_lu: torch.Tensor
    t_uu: torch.Tensor


def _groups(data: QPData, soft: SoftBounds, dx, du):
    """(value, bound, sign, penalty) of the four bound groups."""
    return ((dx[..., 1:, :], data.lbx[..., 1:, :], 1.0, soft.lx),
            (dx[..., 1:, :], data.ubx[..., 1:, :], -1.0, soft.ux),
            (du, data.lbu, 1.0, soft.lu),
            (du, data.ubu, -1.0, soft.uu))


def _violation(v, b, sgn, pen):
    sm = pen.soft & torch.isfinite(b)
    return torch.where(sm, torch.clamp(-sgn * (v - b), min=0.0),
                       torch.zeros_like(v))


def soft_qp_objective(data: QPData, soft: SoftBounds, dx, du) -> torch.Tensor:
    """Penalized objective 0.5 z'Hz + g'z + sum z·t + 0.5 Z·t² with t taken
    as the actual bound violation of (dx, du), per problem (a scalar for
    one problem, as in the JAX package)."""
    def quad(M, v):
        return 0.5 * torch.einsum("...i,...ij,...j->...", v, M, v).sum(-1)
    obj = quad(data.Q, dx) + (data.q * dx).sum((-2, -1))
    obj = obj + quad(data.R, du) + (data.r * du).sum((-2, -1))
    for v, b, sgn, pen in _groups(data, soft, dx, du):
        viol = _violation(v, b, sgn, pen)
        obj = obj + (pen.z * viol + 0.5 * pen.Z * viol ** 2).sum((-2, -1))
    return obj


def violations_from_primal(data: QPData, soft: SoftBounds, dx, du) -> tuple:
    """(t_lx, t_ux, t_lu, t_uu) implied by a primal point: at an optimum
    the violation variable equals the actual bound violation. Reports the
    violations of backends that eliminate t inside the kernel."""
    return tuple(_violation(v, b, sgn, pen)
                 for v, b, sgn, pen in _groups(data, soft, dx, du))


def soft_box_qp_solve(data: QPData, soft: SoftBounds, iters: int = 12,
                      mu0: float = 1e-1, alpha_frac: float = 0.995,
                      reg: float = 1e-9, s_min: float = 1e-3,
                      mu_min: float = 1e-12) -> SoftQPSolution:
    """Solve the OCP QP with per-component soft box bounds (leading batch
    axes allowed)."""
    N, nx = data.horizon, data.nx
    dtype, dev = data.A.dtype, data.A.device
    if torch.finfo(dtype).bits <= 32:
        mu_min = max(mu_min, 1e-7)
        reg = max(reg, 1e-6)
        lam_max = 1e7
        eps_s = 1e-9
    else:
        lam_max = 1e14
        eps_s = 1e-16
    sigma_max = lam_max
    big = torch.full((), _BIG, dtype=dtype, device=dev)
    inf = torch.full((), float("inf"), dtype=dtype, device=dev)

    bounds = (data.lbx[..., 1:, :], data.ubx[..., 1:, :], data.lbu,
              data.ubu)
    signs = (1.0, -1.0, 1.0, -1.0)
    masks = tuple(torch.isfinite(b) for b in bounds)
    pens = (soft.lx, soft.ux, soft.lu, soft.uu)
    softm = tuple(m & p.soft for m, p in zip(masks, pens))

    # ----- initial primal point: rollout + clamp into the *hard* box
    # (soft entries may start in violation; their t covers it) -----
    du0 = torch.zeros_like(data.r)
    x, tail = data.dx0, []
    for k in range(N):
        x = (_mv(data.A[..., k, :, :], x) + _mv(data.B[..., k, :, :],
                                                du0[..., k, :])
             + data.c[..., k, :])
        tail.append(x)
    dx_tail = torch.stack(tail, -2)

    def clamp_into(v, lb, ub, hard_l, hard_u, mask_l, mask_u):
        width = _where(mask_l & mask_u, ub - lb, 1.0)
        inset = 0.1 * width
        lo = torch.where(hard_l, lb + inset, -big)
        hi = torch.where(hard_u, ub - inset, big)
        return _clip(v, lo, torch.maximum(hi, lo))

    dx_tail = clamp_into(dx_tail, bounds[0], bounds[1],
                         masks[0] & ~softm[0], masks[1] & ~softm[1],
                         masks[0], masks[1])
    du0 = clamp_into(du0, bounds[2], bounds[3],
                     masks[2] & ~softm[2], masks[3] & ~softm[3],
                     masks[2], masks[3])
    dx0_traj = torch.cat([data.dx0.unsqueeze(-2), dx_tail], -2)

    def group_values(dx, du):
        return (dx[..., 1:, :], dx[..., 1:, :], du, du)

    def init_group(v, b, sgn, mask, sm):
        gap = sgn * (v - b)
        # an O(1) starting violation slack keeps gam = mu0/t moderate
        # whether or not the start violates the soft bound
        t = torch.where(sm, torch.clamp(-gap, min=0.0) + 0.1, big)
        s = torch.where(mask, torch.clamp(gap + _where(sm, t, 0.0),
                                          min=s_min), big)
        lam = _where(mask, mu0 / s, 0.0)
        gam = _where(sm, mu0 / t, 0.0)
        return _GS(s=s, lam=lam, t=t, gam=gam)

    gs0 = tuple(init_group(v, b, sgn, m, sm) for v, b, sgn, m, sm in zip(
        group_values(dx0_traj, du0), bounds, signs, masks, softm))

    def psum(a):
        return a.sum((-2, -1))

    n_pairs = sum(psum(m) for m in masks) + sum(psum(m) for m in softm)
    n_pairs = torch.clamp(n_pairs.to(dtype), min=1.0)
    eye_x = torch.eye(nx, dtype=dtype, device=dev)
    dx0_zero = torch.zeros_like(data.dx0)

    def comp_sum(gs):
        tot = 0.0
        for g, m, sm in zip(gs, masks, softm):
            tot = tot + psum(_where(m, g.s * g.lam, 0.0))
            tot = tot + psum(_where(sm, g.t * g.gam, 0.0))
        return tot

    def max_step(v, dv, mask, tau):
        neg = dv < 0
        ratio = torch.where(mask & neg, -tau * v / _where(neg, dv, -1.0),
                            inf)
        return ratio.amin((-2, -1))

    class _St(NamedTuple):
        dx: torch.Tensor
        du: torch.Tensor
        gs: tuple

    def iteration(st: _St) -> _St:
        vals = group_values(st.dx, st.du)
        mu_cur = comp_sum(st.gs) / n_pairs

        # per-group residuals and barrier weights
        r_ss, r_ts, sig_ss, dens, sig_effs = [], [], [], [], []
        for g, v, b, sgn, m, sm, pen in zip(st.gs, vals, bounds, signs,
                                            masks, softm, pens):
            t_eff = _where(sm, g.t, 0.0)
            r_s = _where(m, g.s - (sgn * (v - b) + t_eff), 0.0)
            r_t = _where(sm, pen.z + pen.Z * g.t - g.lam - g.gam, 0.0)
            sig_s = _where(m, g.lam / g.s, 0.0)
            sig_t = _where(sm, g.gam / g.t, 0.0)
            den = pen.Z + sig_s + sig_t
            sig_eff = torch.where(sm, sig_s * (pen.Z + sig_t) / den, sig_s)
            sig_eff = torch.clamp(sig_eff, max=sigma_max)
            r_ss.append(r_s)
            r_ts.append(r_t)
            sig_ss.append(sig_s)
            dens.append(den)
            sig_effs.append(sig_eff)

        Qmod = torch.cat([data.Q[..., :1, :, :],
                          data.Q[..., 1:, :, :]
                          + torch.diag_embed(sig_effs[0] + sig_effs[1])], -3)
        Rmod = data.R + torch.diag_embed(sig_effs[2] + sig_effs[3])
        fac = riccati_factorize(data.A, data.B, Qmod, Rmod, reg)

        gx_full = _mv(data.Q, st.dx) + data.q
        gu_full = _mv(data.R, st.du) + data.r
        r_eq = (data.c + _mv(data.A, st.dx[..., :-1, :])
                + _mv(data.B, st.du) - st.dx[..., 1:, :])

        def rhs_w(i, T_s, T_t):
            """Soft elimination scalar w and RHS contribution b of group
            i."""
            g, sgn, m, sm = st.gs[i], signs[i], masks[i], softm[i]
            w = _where(
                sm, -r_ts[i] + (T_s / g.s - g.lam)
                + (T_t / _where(sm, g.t, 1.0) - g.gam)
                + sig_ss[i] * r_ss[i], 0.0)
            b = -sgn * _where(
                m, T_s / g.s + sig_ss[i] * r_ss[i]
                - _where(sm, sig_ss[i] * w / dens[i], 0.0), 0.0)
            return w, b

        def directions(Ts, Tts):
            ws_bs = [rhs_w(i, Ts[i], Tts[i]) for i in range(4)]
            bx = ws_bs[0][1] + ws_bs[1][1]
            bu = ws_bs[2][1] + ws_bs[3][1]
            q_rhs = torch.cat([gx_full[..., :1, :],
                               gx_full[..., 1:, :] + bx], -2)
            r_rhs = gu_full + bu
            d_dx, d_du = riccati_solve_rhs(fac, data.A, data.B, r_eq, q_rhs,
                                           r_rhs, dx0_zero)
            dvs = group_values(d_dx, d_du)
            dgs = []
            for i in range(4):
                g, sgn, m, sm = st.gs[i], signs[i], masks[i], softm[i]
                w = ws_bs[i][0]
                dt = _where(sm, (w - sgn * sig_ss[i] * dvs[i]) / dens[i],
                            0.0)
                ds = _where(m, sgn * dvs[i] + dt - r_ss[i], 0.0)
                dlam = _where(m, (Ts[i] - g.s * g.lam - g.lam * ds) / g.s,
                              0.0)
                dgam = _where(sm, (Tts[i] - g.t * g.gam - g.gam * dt)
                              / _where(sm, g.t, 1.0), 0.0)
                dgs.append(_GS(s=ds, lam=dlam, t=dt, gam=dgam))
            return d_dx, d_du, tuple(dgs)

        def alphas(dgs, tau):
            a_p = a_d = torch.ones_like(mu_cur)
            for g, dg, m, sm in zip(st.gs, dgs, masks, softm):
                a_p = torch.minimum(a_p, max_step(g.s, dg.s, m, tau))
                a_p = torch.minimum(a_p, max_step(g.t, dg.t, sm, tau))
                a_d = torch.minimum(a_d, max_step(g.lam, dg.lam, m, tau))
                a_d = torch.minimum(a_d, max_step(g.gam, dg.gam, sm, tau))
            return a_p[..., None, None], a_d[..., None, None]

        zeros = tuple(torch.zeros_like(r) for r in r_ss)
        # ---- predictor (affine scaling, targets 0) ----
        _, _, aff = directions(zeros, zeros)
        ap, ad = alphas(aff, 1.0)
        mu_aff = 0.0
        for g, dg, m, sm in zip(st.gs, aff, masks, softm):
            mu_aff = mu_aff + psum(_where(
                m, (g.s + ap * dg.s) * (g.lam + ad * dg.lam), 0.0))
            mu_aff = mu_aff + psum(_where(
                sm, (g.t + ap * dg.t) * (g.gam + ad * dg.gam), 0.0))
        mu_aff = mu_aff / n_pairs
        ratio = mu_aff / torch.clamp(mu_cur, min=mu_min)
        sigma = torch.clamp(ratio * ratio * ratio, 0.0, 1.0)
        mu_t = torch.clamp(sigma * mu_cur, min=mu_min)[..., None, None]

        # ---- corrector (Gondzio-clipped per-constraint targets) ----
        def target(dv1, dv2):
            return _clip(mu_t - dv1 * dv2, 0.05 * mu_t, 20.0 * mu_t)
        Ts = tuple(_where(m, target(dg.s, dg.lam), 0.0)
                   for dg, m in zip(aff, masks))
        Tts = tuple(_where(sm, target(dg.t, dg.gam), 0.0)
                    for dg, sm in zip(aff, softm))
        d_dx, d_du, dgs = directions(Ts, Tts)
        a_p, a_d = alphas(dgs, alpha_frac)

        new_gs = []
        for g, dg, m, sm in zip(st.gs, dgs, masks, softm):
            new_gs.append(_GS(
                s=torch.where(m, torch.clamp(g.s + a_p * dg.s, min=eps_s),
                              big),
                lam=torch.clamp(g.lam + a_d * dg.lam, 0.0, lam_max),
                t=torch.where(sm, torch.clamp(g.t + a_p * dg.t, min=eps_s),
                              big),
                gam=torch.clamp(g.gam + a_d * dg.gam, 0.0, lam_max)))
        return _St(dx=st.dx + a_p * d_dx, du=st.du + a_p * d_du,
                   gs=tuple(new_gs))

    def merit(st: _St):
        shim = _IpmState(
            dx=st.dx, du=st.du,
            s_lx=st.gs[0].s, s_ux=st.gs[1].s,
            lam_lx=st.gs[0].lam, lam_ux=st.gs[1].lam,
            s_lu=st.gs[2].s, s_uu=st.gs[3].s,
            lam_lu=st.gs[2].lam, lam_uu=st.gs[3].lam)
        kkt_stat, kkt_eq = _kkt_residuals(data, shim, *masks)
        # soft stationarity: z + Z t - lam - gam = 0 on soft entries
        r_t_max = torch.zeros_like(kkt_eq)
        for g, sm, pen in zip(st.gs, softm, pens):
            r_t = _where(sm, pen.z + pen.Z * g.t - g.lam - g.gam, 0.0)
            r_t_max = torch.maximum(r_t_max, r_t.abs().amax((-2, -1)))
        m = kkt_stat + kkt_eq + r_t_max + comp_sum(st.gs) / n_pairs
        return m, kkt_stat, kkt_eq

    # best-iterate selection: a static budget past convergence is harmless
    def select(better, a, b):
        if isinstance(a, tuple):
            out = [select(better, x, y) for x, y in zip(a, b)]
            return type(a)(*out) if hasattr(a, "_fields") else tuple(out)
        bb = better.reshape(better.shape + (1,) * (a.ndim - better.ndim))
        return torch.where(bb, a, b)

    state = _St(dx=dx0_traj, du=du0, gs=gs0)
    best, (best_m, _, _) = state, merit(state)
    for _ in range(iters):
        state = iteration(state)
        m, _, _ = merit(state)
        better = m < best_m
        best = select(better, state, best)
        best_m = torch.where(better, m, best_m)

    _, kkt_stat, kkt_eq = merit(best)
    sol = QPSolution(
        dx=best.dx, du=best.du,
        lam_lx=best.gs[0].lam, lam_ux=best.gs[1].lam,
        lam_lu=best.gs[2].lam, lam_uu=best.gs[3].lam,
        mu=comp_sum(best.gs) / n_pairs, kkt_stat=kkt_stat, kkt_eq=kkt_eq,
        iters=torch.full((), iters, device=dev),
        s_lx=best.gs[0].s, s_ux=best.gs[1].s,
        s_lu=best.gs[2].s, s_uu=best.gs[3].s)

    def viol(g, sm):
        return _where(sm, g.t, 0.0)
    return SoftQPSolution(
        sol=sol,
        t_lx=viol(best.gs[0], softm[0]), t_ux=viol(best.gs[1], softm[1]),
        t_lu=viol(best.gs[2], softm[2]), t_uu=viol(best.gs[3], softm[3]))
