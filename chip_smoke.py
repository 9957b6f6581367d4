"""Smoke run of the PyTorch + CUDA port (`mpc_blaster_tpu_torch`) on one
NVIDIA GPU.

    python3 chip_smoke.py

Builds the box-QP IPM kernel (its plain, fuse_cost and fuse_lin modes)
from `mpc_blaster_tpu_torch/csrc/` with nvcc, holds each mode against its
plain PyTorch twin on the card, then drives the port's main paths, each
with the launch counts set to 0 just before it and read just after:

  3. the batched RTI tick, backend "pallas" (N=20, B=1024, 10 ticks);
  4. the simulation preset's closed loop, backend "pallas" (N=60, frozen
     POC, 100 ticks), checked against tests/golden/simulation_poc_100.npz;
  5. the batched fused tick, backend "pallas_fused" (N=20, B=1024, 10
     chained ticks at 6 and at 12 IPM iterations): one fuse_cost launch
     per tick;
  6. the fused closed loop, `qp_backend="pallas_fused"` (N=60, 100 ticks
     at 12 iterations, held to the golden; and under
     `deployed_solver("safe")`, 6 iterations): one fuse_lin launch per
     tick.

Every phase prints one line; any failure raises and the exit code is
non-zero. Without a CUDA device it fails before printing any result; it
never falls back to the CPU. The last two lines are the kernel report and
the device record, each one JSON object.

Tolerances (kernel vs plain twin, both float32 on the card):
  - one IPM iteration, pointwise: u0 atol 2e-3, dx/du (or the new xbar/
    ubar) atol 5e-3 (every phase of the solve has run once; the two agree
    to rounding);
  - the full budget (6 and 12 iterations): per-problem QP objective within
    1.2e-2 relative (tests/test_torch_ipm.py); past a few iterations f32
    rounding moves the weakly determined rotor-thrust split, so du is not
    compared pointwise there. The fused modes' batches start from perturbed
    iterates whose QPs the budget does not converge, so there the
    objective holds on at least 95% of the problems and within 5e-2 on all
    (measured on an H100, fuse_cost N=20 B=1024: worst problem 1.7e-2 at 6
    iterations, 1.2e-2 at 12). kkt_eq within rtol 0.2 / atol 1e-3
    (tests/test_batched_fused.py) on at least 95% of the problems and
    below 5e-2 on all: over 1024 problems the two f32 solvers end at
    different best-merit iterates on a few percent of them (measured on
    an H100: 96.8% within, the kernel's worst kkt_eq 3.4e-3 against the
    twin's 1.0e-2). The fused modes' step norms and bound violation
    within rtol 0.05 / atol 1e-3 (tests/test_batched_fused.py) on at least
    95% of the problems;
  - the fuse_lin prologue's A, B and c against `fast_linearize`: rtol and
    atol 2e-4 (tests/test_fastlin.py's float32 bound);
  - closed loops: positions within 5e-2 m of the float64 golden run (the
    float32 tolerance of tests/test_golden.py; the port's plain twin on
    the CPU stays within 3.4e-3 m). Under `deployed_solver("safe")` (6
    iterations) the JAX package's own float32 loop ends 0.1240 m from
    that 12-iteration golden (its Riccati IPM on the CPU), so the bound
    there is 0.1240 + 5e-2 m.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
GOLDEN = REPO / "tests" / "golden" / "simulation_poc_100.npz"
KERNEL_SOURCE = "mpc_blaster_tpu_torch/csrc/box_qp_ipm.cu"
REPLACES = {"box_qp_ipm": "mpc_blaster_tpu/ops/pallas_ipm.py:215",
            "box_qp_ipm_fuse_cost": "mpc_blaster_tpu/ops/pallas_ipm.py:1236",
            "box_qp_ipm_fuse_lin": "mpc_blaster_tpu/ops/pallas_ipm.py:1163"}
FULL_ITERS = 12   # the simulation preset's ipm_iters
SAFE_ITERS = 6    # deployed_solver("safe")
BATCH = 1024      # the batched ticks' scenarios
TICKS = 10        # chained batched ticks
LOOP_TICKS = 100  # closed-loop ticks (the golden's length)
SAFE_BOUND_M = 0.1240 + 5e-2


def log(phase: str, **kv):
    print(json.dumps({"phase": phase, **kv}), flush=True)


FAILURES: list = []


def check(ok: bool, what: str, **detail):
    """Record a failed check; the run fails at the end, after every phase
    has reported."""
    if not ok:
        FAILURES.append({"check": what, **detail})


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call, CUDA events around `reps` calls."""
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


WRAPPERS = ("box_qp_solve", "batched_fused_tick", "fused_rti_solve")
KERNEL_WRAPPERS: dict = {}   # the wrappers that hold the launch counts


def counts() -> dict:
    return {w: fn.launches for w, fn in KERNEL_WRAPPERS.items()}


def reset_counts():
    for fn in KERNEL_WRAPPERS.values():
        fn.launches = 0


@contextlib.contextmanager
def plain_twins():
    """Route the port's solves to the plain twins for the duration (the
    wrappers pick the kernel for every CUDA tensor). Used only to time the
    plain path of the same ticks; it launches no kernel."""
    from mpc_blaster_tpu_torch.ops import box_qp_ipm as K
    kernels = {w: getattr(K, w) for w in WRAPPERS}
    for w in WRAPPERS:
        setattr(K, w, getattr(K, w + "_plain"))
    try:
        yield
    finally:
        for w, fn in kernels.items():
            setattr(K, w, fn)


def simulation_ocp(N: int, iters: int = FULL_ITERS, solver=None):
    from mpc_blaster_tpu_torch import config as cfg
    pre = cfg.simulation_preset()
    solver = solver or dataclasses.replace(pre.ocp.solver,
                                           qp_backend="pallas",
                                           ipm_iters=iters)
    ocp = dataclasses.replace(pre.ocp, N=N, Tf=pre.ocp.Tf * N / pre.ocp.N,
                              solver=solver)
    return dataclasses.replace(pre, ocp=ocp)


def fused_ocp(N: int, iters: int):
    from mpc_blaster_tpu_torch import config as cfg
    return simulation_ocp(N, solver=dataclasses.replace(
        cfg.deployed_solver("safe"), ipm_iters=iters))


def draws(B: int, seed: int = 0) -> np.ndarray:
    """Initial states around hover at z=2 (bench.py's scenario draws)."""
    x0s = np.zeros((B, 17), np.float32)
    rng = np.random.default_rng(seed)
    x0s[:, 0:3] = rng.uniform(-0.4, 0.4, (B, 3))
    x0s[:, 2] += 2.0
    return x0s


def blaster_qps(N: int, B: int, dev):
    """Linearized BLASTER QPs built by the port on the card."""
    from torch.func import vmap
    from mpc_blaster_tpu_torch.dynamics.blaster import (BlasterParams,
                                                        blaster_ode)
    from mpc_blaster_tpu_torch.dynamics.integrators import discrete_dynamics
    from mpc_blaster_tpu_torch.ocp.spec import build_spec
    from mpc_blaster_tpu_torch.sqp.rti import (RTIState, build_qp,
                                               init_rti_state)
    pre = simulation_ocp(N)
    ocp = pre.ocp
    spec = build_spec(ocp, yref=pre.loop.yref, device=dev)
    x0 = torch.as_tensor(draws(B, seed=N), device=dev)
    st = init_rti_state(ocp, x0)
    F = discrete_dynamics(blaster_ode, ocp.dt)
    P = BlasterParams.from_config(ocp.model, device=dev)
    return vmap(lambda xb, ub, x: build_qp(spec, RTIState(xb, ub), x, F, P))(
        st.xbar, st.ubar, x0)


def kkt_eq_checks(name, kernel_eq, plain_eq, row, sfx="", cap=None):
    """kkt_eq within rtol 0.2 / atol 1e-3 on at least 95% of the problems
    (and below `cap` on all, where given)."""
    gap = (kernel_eq - plain_eq).abs()
    within = (gap <= 1e-3 + 0.2 * plain_eq.abs()).float().mean().item()
    row.update({"kkt_eq_within_frac" + sfx: within,
                "kkt_eq_max_kernel" + sfx: kernel_eq.max().item(),
                "kkt_eq_max_plain" + sfx: plain_eq.max().item()})
    check(within >= 0.95 and (cap is None or kernel_eq.max().item() < cap),
          "kkt_eq parity", case=name, within=within, cap=cap,
          max_gap=gap.max().item())


def objective_check(name, qp, dk, uk, dp, up, row, key, batch_rule=False):
    """Per-problem QP objective within 1.2e-2 relative: on every problem,
    or (batch_rule) on at least 95% of them and within 5e-2 on all."""
    from torch.func import vmap
    from mpc_blaster_tpu_torch.qp.data import qp_objective
    ok = vmap(qp_objective)(qp, dk, uk)
    op = vmap(qp_objective)(qp, dp, up)
    rel = (ok - op).abs() / op.abs().clamp(min=1.0)
    within = (rel <= 1.2e-2).float().mean().item()
    row[key] = rel.max().item()
    if batch_rule:
        row[key + "_within_frac"] = within
        good = within >= 0.95 and rel.max().item() <= 5e-2
    else:
        good = within == 1.0
    check(good, "objective parity", case=name, obj_rel_err=rel.max().item(),
          within=within)


def compare_kernel(name, qp, K):
    """Plain-mode kernel vs plain twin on one QP batch; the report row."""
    row = {"case": name, "B": qp.A.shape[0], "N": qp.A.shape[1]}
    for iters in (1, FULL_ITERS):
        n0 = K.box_qp_solve.launches
        sk = K.box_qp_solve(qp, iters=iters)
        torch.cuda.synchronize()
        check(K.box_qp_solve.launches == n0 + 1, "kernel launched",
              case=name)
        sp = K.box_qp_solve_plain(qp, iters=iters)
        for f in ("dx", "du", "kkt_eq", "mu"):
            check(bool(torch.isfinite(getattr(sk, f)).all()), "finite",
                  case=name, iters=iters, field=f)
        if iters == 1:
            u0 = (sk.du[:, 0] - sp.du[:, 0]).abs().max().item()
            err = max((sk.dx - sp.dx).abs().max().item(),
                      (sk.du - sp.du).abs().max().item())
            check(u0 <= 2e-3 and err <= 5e-3, "one-iteration parity",
                  case=name, u0_err=u0, max_abs_err=err)
            row["max_abs_err_1it"] = err
            continue
        objective_check(name, qp, sk.dx, sk.du, sp.dx, sp.du, row,
                        "obj_rel_err")
        kkt_eq_checks(name, sk.kkt_eq, sp.kkt_eq, row, cap=5e-2)
    row["kernel_ms"] = cuda_ms(lambda: K.box_qp_solve(qp, iters=FULL_ITERS),
                               reps=10)
    row["plain_ms"] = cuda_ms(
        lambda: K.box_qp_solve_plain(qp, iters=FULL_ITERS), reps=1)
    return row


def fused_case(N: int, B: int, dev, seed: int):
    """A perturbed hover iterate at N, B with the fused modes' spec
    arguments (shared rows broadcast over the batch) and the plain
    linearization of it: (ocp, stage params, xbar, ubar, x0, args, lin).
    The perturbation keeps the iterate inside the boxes, as the main
    path's iterates are: states +-0.02 around x0 (every node its own
    linearization point), rotor thrusts +-0.5 N around hover."""
    from mpc_blaster_tpu_torch.dynamics.blaster import BlasterParams
    from mpc_blaster_tpu_torch.dynamics.fastlin import fast_linearize
    from mpc_blaster_tpu_torch.ocp.spec import build_spec
    from mpc_blaster_tpu_torch.sqp.rti import init_rti_state
    pre = simulation_ocp(N)
    ocp = pre.ocp
    spec = build_spec(ocp, yref=pre.loop.yref, device=dev)
    x0 = torch.as_tensor(draws(B, seed=seed), device=dev)
    st = init_rti_state(ocp, x0)
    rng = np.random.default_rng(seed)
    xbar = st.xbar + torch.as_tensor(
        rng.uniform(-0.02, 0.02, st.xbar.shape), dtype=torch.float32,
        device=dev)
    du = np.zeros(st.ubar.shape, np.float32)
    du[..., 0:4] = rng.uniform(-0.5, 0.5, du[..., 0:4].shape)
    ubar = st.ubar + torch.as_tensor(du, device=dev)

    def bc(a):
        return a.expand(B, *a.shape)
    args = (bc(spec.dt * spec.Q), bc(spec.Q_t), bc(spec.dt * spec.R),
            bc(spec.yref_x), bc(spec.yref_u), bc(spec.yref_e),
            bc(spec.lbx), bc(spec.ubx), bc(spec.lbu), bc(spec.ubu))
    P = BlasterParams.from_config(ocp.model, device=dev)
    xp, A, Bm = fast_linearize(xbar, ubar, spec.stage_params, P, ocp.dt)
    return ocp, bc(spec.stage_params), xbar, ubar, x0, args, \
        (A, Bm, xp - xbar[:, 1:])


def fused_checks(name, K, qp, new_k, new_p, base, iters, row, dk=None,
                 dp=None):
    """One-iteration pointwise or full-budget checks of a fused mode;
    new_* are (xbar, ubar) of the new iterate, base the old one."""
    xk, uk = new_k
    xp, up = new_p
    for t, f in ((xk, "xbar"), (uk, "ubar")):
        check(bool(torch.isfinite(t).all()), "finite", case=name,
              iters=iters, field=f)
    if iters == 1:
        u0 = (uk[:, 0] - up[:, 0]).abs().max().item()
        err = max((xk - xp).abs().max().item(), (uk - up).abs().max().item())
        check(u0 <= 2e-3 and err <= 5e-3, "one-iteration parity", case=name,
              u0_err=u0, max_abs_err=err)
        row["max_abs_err_1it"] = err
        return
    objective_check(name, qp, xk - base[0], uk - base[1], xp - base[0],
                    up - base[1], row, f"obj_rel_err_{iters}it",
                    batch_rule=True)
    if dk is not None:
        sfx = f"_{iters}it"
        kkt_eq_checks(name, dk["kkt_eq"], dp["kkt_eq"], row, sfx)
        for f in ("step_norm_x", "step_norm_u", "bound_viol"):
            ok = ((dk[f] - dp[f]).abs() <= 1e-3 + 0.05 * dp[f].abs())
            frac = ok.float().mean().item()
            row[f"{f}_within_frac{sfx}"] = frac
            check(frac >= 0.95, f"{f} parity", case=name, iters=iters,
                  within=frac)


def compare_fuse_cost(name, N, B, dev, K):
    """fuse_cost kernel vs `batched_fused_tick_plain`; the report row."""
    ocp, _, xbar, ubar, x0, args, (A, Bm, c) = fused_case(N, B, dev, N + 1)
    AB = torch.cat([A, Bm], -1)
    qp = K._fused_qp(K._fused_prep(xbar, ubar, x0, *args, None), A, Bm, c)
    row = {"case": name, "B": B, "N": N}
    for iters in (1, SAFE_ITERS, FULL_ITERS):
        n0 = K.batched_fused_tick.launches
        xk, uk, dk, _ = K.batched_fused_tick(AB, c, xbar, ubar, x0, *args,
                                             iters=iters)
        torch.cuda.synchronize()
        check(K.batched_fused_tick.launches == n0 + 1, "kernel launched",
              case=name)
        xp, up, dp, _ = K.batched_fused_tick_plain(AB, c, xbar, ubar, x0,
                                                   *args, iters=iters)
        fused_checks(name, K, qp, (xk, uk), (xp, up), (xbar, ubar), iters,
                     row, dk, dp)
    for iters in (SAFE_ITERS, FULL_ITERS):
        sfx = "" if iters == FULL_ITERS else f"_{iters}it"
        row["kernel_ms" + sfx] = cuda_ms(lambda: K.batched_fused_tick(
            AB, c, xbar, ubar, x0, *args, iters=iters), reps=10)
        row["plain_ms" + sfx] = cuda_ms(lambda: K.batched_fused_tick_plain(
            AB, c, xbar, ubar, x0, *args, iters=iters), reps=1)
    return row


def compare_fuse_lin(name, N, dev, K):
    """fuse_lin kernel vs `fused_rti_solve_plain` (and its prologue vs
    `fast_linearize`); the report row."""
    from mpc_blaster_tpu_torch.sqp.rti import fused_dyn_statics
    ocp, sp, xbar, ubar, x0, args, (A, Bm, c) = fused_case(N, 1, dev, N + 2)
    model, dt, ns = fused_dyn_statics(ocp)
    kw = dict(model=model, dt=dt, num_steps=ns)
    qp = K._fused_qp(K._fused_prep(xbar, ubar, x0, *args, None), A, Bm, c)
    row = {"case": name, "B": 1, "N": N}
    for iters in (1, SAFE_ITERS, FULL_ITERS):
        n0 = K.fused_rti_solve.launches
        sk, lin = K.fused_rti_solve(xbar, ubar, sp, x0, *args, iters=iters,
                                    return_lin=True, **kw)
        torch.cuda.synchronize()
        check(K.fused_rti_solve.launches == n0 + 1, "kernel launched",
              case=name)
        spl = K.fused_rti_solve_plain(xbar, ubar, sp, x0, *args,
                                      iters=iters, **kw)
        if iters == 1:
            errs = [(g - r).abs().max().item() for g, r in zip(lin, (A, Bm, c))]
            ok = all(bool(((g - r).abs() <= 2e-4 + 2e-4 * r.abs()).all())
                     for g, r in zip(lin, (A, Bm, c)))
            row["prologue_max_abs_err"] = dict(zip(("A", "B", "c"), errs))
            check(ok, "prologue vs fast_linearize", case=name, errs=errs)
        fused_checks(name, K, qp, (xbar + sk.dx, ubar + sk.du),
                     (xbar + spl.dx, ubar + spl.du), (xbar, ubar), iters,
                     row)
        if iters > 1:
            check(abs(sk.kkt_eq.item() - spl.kkt_eq.item())
                  <= 1e-3 + 0.2 * abs(spl.kkt_eq.item()) or
                  sk.kkt_eq.item() < 1e-3, "kkt_eq parity", case=name,
                  iters=iters, kernel=sk.kkt_eq.item(),
                  plain=spl.kkt_eq.item())
    for iters in (SAFE_ITERS, FULL_ITERS):
        sfx = "" if iters == FULL_ITERS else f"_{iters}it"
        row["kernel_ms" + sfx] = cuda_ms(lambda: K.fused_rti_solve(
            xbar, ubar, sp, x0, *args, iters=iters, **kw), reps=10)
        row["plain_ms" + sfx] = cuda_ms(lambda: K.fused_rti_solve_plain(
            xbar, ubar, sp, x0, *args, iters=iters, **kw), reps=1)
    return row


def run_batched_ticks(step, spec, x0s, n_ticks, ocp):
    from mpc_blaster_tpu_torch.sqp.rti import init_rti_state
    states = init_rti_state(ocp, x0s)
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(n_ticks):
        u0s, states, diag = step(spec, states, x0s)
    e1.record()
    torch.cuda.synchronize()
    return u0s, states, diag, e0.elapsed_time(e1) / n_ticks


def timed_closed_loop(pre, n_ticks, dev):
    from mpc_blaster_tpu_torch.sim.closedloop import run_preset
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    res = run_preset(pre, n_steps=n_ticks, with_poc=True, device=dev)
    e1.record()
    torch.cuda.synchronize()
    return res, e0.elapsed_time(e1) / n_ticks


def loop_checks(name, res, bound):
    """Finite, and positions within `bound` m of the golden run."""
    xs = res.xs.cpu().numpy()
    check(bool(np.isfinite(xs).all() and np.isfinite(res.us.cpu().numpy())
               .all()), "closed-loop finite", case=name)
    golden = np.load(GOLDEN)["xs"][:xs.shape[0]]
    pos_err = float(np.abs(xs[:, 0:3] - golden[:, 0:3]).max())
    check(pos_err < bound, "closed loop vs golden", case=name,
          max_pos_err_m=pos_err, bound_m=bound)
    return xs, pos_err


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device is visible; this "
                         "script runs the port on an NVIDIA GPU only")
    return run(torch.device("cuda", 0))


def run(dev: torch.device) -> int:
    from mpc_blaster_tpu_torch import config as cfg
    from mpc_blaster_tpu_torch.ops import box_qp_ipm as K
    from mpc_blaster_tpu_torch.ocp.spec import build_spec
    from mpc_blaster_tpu_torch.parallel.mesh import batched_rti_step

    # ---- phase 0: the card ----
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    log("device", nvidia_smi=smi, torch=torch.__version__,
        cuda=torch.version.cuda, name=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count())

    KERNEL_WRAPPERS.update({w: getattr(K, w) for w in WRAPPERS})

    # ---- phase 1: build the kernel library from the checkout ----
    so, secs, build_log = K.build_library()
    ptxas = [ln.strip() for ln in build_log.splitlines()
             if "registers" in ln or "spill" in ln]
    K._library()
    log("build", library=str(so.relative_to(REPO)), nvcc_s=secs,
        ptxas=ptxas)

    # ---- phase 2: each kernel mode vs its plain twin on the card ----
    rows = []
    for name, N, B in (("n8_b3", 8, 3), ("n20_b1024", 20, BATCH),
                       ("n60_b1", 60, 1)):
        rows.append(compare_kernel(name, blaster_qps(N, B, dev), K))
        log("kernel_vs_plain", **rows[-1])
    qp = blaster_qps(8, 3, dev)
    inf = torch.full_like(qp.lbx, float("inf"))
    free = qp._replace(lbx=-inf, ubx=inf, ubu=torch.full_like(qp.ubu,
                                                              float("inf")))
    rows.append(compare_kernel("n8_b3_inf_bounds", free, K))
    log("kernel_vs_plain", **rows[-1])
    cost_rows = [compare_fuse_cost(n, N, B, dev, K)
                 for n, N, B in (("n8_b3", 8, 3), ("n20_b1024", 20, BATCH))]
    for r in cost_rows:
        log("fuse_cost_vs_plain", **r)
    lin_rows = [compare_fuse_lin(n, N, dev, K)
                for n, N in (("n8_b1", 8), ("n60_b1", 60))]
    for r in lin_rows:
        log("fuse_lin_vs_plain", **r)

    # ---- the main paths, each counted on its own ----
    pre20 = simulation_ocp(20)
    spec20 = build_spec(pre20.ocp, yref=pre20.loop.yref, device=dev)
    x0s = torch.as_tensor(draws(BATCH), device=dev)
    step = batched_rti_step(pre20.ocp, backend="pallas", device=dev)
    pre60 = simulation_ocp(60)

    def counted(expected: dict, what: str, fn):
        reset_counts()
        out = fn()
        got = counts()
        want = {w: expected.get(w, 0) for w in WRAPPERS}
        check(got == want, f"{what} launches", got=got, want=want)
        return out, got

    # phase 3: 10 chained batched ticks, N=20, B=1024, backend "pallas"
    (u0s, states, diag, tick_ms), c3 = counted(
        {"box_qp_solve": TICKS}, "batched tick",
        lambda: run_batched_ticks(step, spec20, x0s, TICKS, pre20.ocp))
    check(bool(torch.isfinite(u0s).all() & torch.isfinite(states.xbar).all()
               & torch.isfinite(diag.qp_kkt_eq).all()), "batched finite")

    # phase 4: the simulation preset's closed loop, N=60, backend "pallas"
    (res, loop_ms), c4 = counted(
        {"box_qp_solve": LOOP_TICKS}, "closed loop",
        lambda: timed_closed_loop(pre60, LOOP_TICKS, dev))
    xs, pos_err = loop_checks("pallas", res, 5e-2)

    log("batched_tick", N=20, B=BATCH, ticks=TICKS,
        launches=c3["box_qp_solve"], ms_per_tick=tick_ms,
        solves_per_s=BATCH * 1000.0 / tick_ms,
        kkt_eq_max=diag.qp_kkt_eq.max().item())
    # plain path of the same tick (fewer ticks: it is launch-bound)
    with plain_twins():
        plain_step = batched_rti_step(pre20.ocp, backend="pallas",
                                      device=dev)
        (*_, plain_tick_ms), _ = counted(
            {}, "plain batched tick",
            lambda: run_batched_ticks(plain_step, spec20, x0s, 2, pre20.ocp))
    log("batched_tick_plain", N=20, B=BATCH, ticks=2,
        ms_per_tick=plain_tick_ms,
        solves_per_s=BATCH * 1000.0 / plain_tick_ms)

    log("closed_loop", N=60, ticks=LOOP_TICKS, launches=c4["box_qp_solve"],
        ms_per_tick=loop_ms, golden_max_pos_err_m=pos_err,
        final_z=float(xs[-1, 2]), kkt_eq_max=res.kkt_eq.max().item())
    with plain_twins():
        (res_p, plain_loop_ms), _ = counted(
            {}, "plain closed loop", lambda: timed_closed_loop(pre60, 3, dev))
    check(bool(torch.isfinite(res_p.xs).all()), "plain closed-loop finite")
    log("closed_loop_plain", N=60, ticks=3, ms_per_tick=plain_loop_ms)

    # phase 5: the batched fused tick, N=20, B=1024, at 6 and 12 iterations
    fused_launches = 0
    fused_tick_ms = {}
    for iters in (SAFE_ITERS, FULL_ITERS):
        pre = fused_ocp(20, iters)
        fstep = batched_rti_step(pre.ocp, backend="pallas_fused", device=dev)
        (u0s, states, diag, ms), c5 = counted(
            {"batched_fused_tick": TICKS}, f"batched fused tick {iters}it",
            lambda: run_batched_ticks(fstep, spec20, x0s, TICKS, pre.ocp))
        fused_launches += c5["batched_fused_tick"]
        fused_tick_ms[iters] = ms
        check(bool(torch.isfinite(u0s).all()
                   & torch.isfinite(states.xbar).all()
                   & torch.isfinite(diag.qp_kkt_eq).all()),
              "batched fused finite", iters=iters)
        log("batched_fused_tick", N=20, B=BATCH, ticks=TICKS, iters=iters,
            launches=c5["batched_fused_tick"], ms_per_tick=ms,
            solves_per_s=BATCH * 1000.0 / ms,
            kkt_eq_max=diag.qp_kkt_eq.max().item(),
            bound_viol_max=diag.bound_viol.max().item())
        with plain_twins():
            pstep = batched_rti_step(pre.ocp, backend="pallas_fused",
                                     device=dev)
            (*_, pms), _ = counted(
                {}, "plain batched fused tick",
                lambda: run_batched_ticks(pstep, spec20, x0s, 2, pre.ocp))
        log("batched_fused_tick_plain", N=20, B=BATCH, ticks=2, iters=iters,
            ms_per_tick=pms, solves_per_s=BATCH * 1000.0 / pms)

    # phase 6: the fused closed loop, N=60: 12 iterations (held to the
    # golden) and deployed_solver("safe")
    lin_launches = 0
    for name, pre, bound in (
            ("fused_12it", fused_ocp(60, FULL_ITERS), 5e-2),
            ("deployed_safe",
             simulation_ocp(60, solver=cfg.deployed_solver("safe")),
             SAFE_BOUND_M)):
        (res, ms), c6 = counted(
            {"fused_rti_solve": LOOP_TICKS}, f"fused closed loop {name}",
            lambda: timed_closed_loop(pre, LOOP_TICKS, dev))
        lin_launches += c6["fused_rti_solve"]
        xs, err = loop_checks(name, res, bound)
        log("fused_closed_loop", case=name, N=60, ticks=LOOP_TICKS,
            iters=pre.ocp.solver.ipm_iters,
            launches=c6["fused_rti_solve"], ms_per_tick=ms,
            golden_max_pos_err_m=err, bound_m=bound,
            final_z=float(xs[-1, 2]), kkt_eq_max=res.kkt_eq.max().item())
    with plain_twins():
        (res_p, pms), _ = counted(
            {}, "plain fused closed loop",
            lambda: timed_closed_loop(fused_ocp(60, FULL_ITERS), 2, dev))
    check(bool(torch.isfinite(res_p.xs).all()),
          "plain fused closed-loop finite")
    log("fused_closed_loop_plain", N=60, ticks=2, iters=FULL_ITERS,
        ms_per_tick=pms)

    if FAILURES:
        for f in FAILURES:
            log("FAILED", **f)
        raise SystemExit(f"chip_smoke: {len(FAILURES)} check(s) failed")

    main_row = next(r for r in rows if r["case"] == "n60_b1")
    cost_main = next(r for r in cost_rows if r["case"] == "n20_b1024")
    lin_main = next(r for r in lin_rows if r["case"] == "n60_b1")

    def entry(name, launches, rs, main, **extra):
        return {"name": name, "route": "cuda", "source": KERNEL_SOURCE,
                "replaces": REPLACES[name], "launches": launches,
                "max_abs_err": max(r["max_abs_err_1it"] for r in rs),
                "ms": main["kernel_ms"], "plain_ms": main["plain_ms"],
                "by_shape": {r["case"]: [r["kernel_ms"], r["plain_ms"]]
                             for r in rs}, **extra}

    report = {"kernels": [
        entry("box_qp_ipm", c3["box_qp_solve"] + c4["box_qp_solve"], rows,
              main_row,
              max_obj_rel_err=max(r["obj_rel_err"] for r in rows)),
        entry("box_qp_ipm_fuse_cost", fused_launches, cost_rows, cost_main,
              ms_6it=cost_main["kernel_ms_6it"],
              plain_ms_6it=cost_main["plain_ms_6it"],
              tick_ms={str(k): v for k, v in fused_tick_ms.items()}),
        entry("box_qp_ipm_fuse_lin", lin_launches, lin_rows, lin_main,
              ms_6it=lin_main["kernel_ms_6it"],
              plain_ms_6it=lin_main["plain_ms_6it"],
              prologue_max_abs_err=max(
                  max(r["prologue_max_abs_err"].values())
                  for r in lin_rows)),
    ]}
    print(json.dumps(report), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
