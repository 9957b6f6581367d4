"""Smoke run of the PyTorch + CUDA port (`mpc_blaster_tpu_torch`) on one
NVIDIA GPU.

    python3 chip_smoke.py

Builds the box-QP IPM kernel from `mpc_blaster_tpu_torch/csrc/` with nvcc,
holds it against its plain PyTorch twin on the card, then drives the
port's main path: the batched RTI tick (N=20, B=1024, 10 chained ticks)
and the simulation preset's closed loop (N=60, frozen POC, 100 ticks),
checked against tests/golden/simulation_poc_100.npz. Every phase prints
one line; any failure raises and the exit code is non-zero. Without a
CUDA device it fails before printing any result; it never falls back to
the CPU. The last two lines are the kernel report and the device record,
each one JSON object.

Tolerances (kernel vs plain twin, both float32 on the card):
  - one IPM iteration, pointwise: u0 atol 2e-3, dx/du atol 5e-3 (every
    phase of the solve has run once; the two agree to rounding);
  - the full budget (12 iterations): per-problem QP objective within
    1.2e-2 relative (tests/test_torch_ipm.py); past a few iterations f32
    rounding moves the weakly determined rotor-thrust split, so du is not
    compared pointwise there. kkt_eq within rtol 0.2 / atol 1e-3
    (tests/test_batched_fused.py) on at least 95% of the problems and
    below 5e-2 on all: over 1024 problems the two f32 solvers end at
    different best-merit iterates on a few percent of them (measured on
    an H100: 96.8% within, the kernel's worst kkt_eq 3.4e-3 against the
    twin's 1.0e-2);
  - closed loop: positions within 5e-2 m of the float64 golden run (the
    float32 tolerance of tests/test_golden.py; the port's plain twin on
    the CPU stays within 3.4e-3 m).
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
REPLACES = "mpc_blaster_tpu/ops/pallas_ipm.py:215"
FULL_ITERS = 12   # the simulation preset's ipm_iters


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


@contextlib.contextmanager
def plain_qp_solver():
    """Route the port's QP solves to the plain twin for the duration (the
    wrapper picks the kernel for every CUDA tensor). Used only to time the
    plain path of the same ticks; it launches no kernel."""
    from mpc_blaster_tpu_torch.ops import box_qp_ipm
    kernel = box_qp_ipm.box_qp_solve
    box_qp_ipm.box_qp_solve = box_qp_ipm.box_qp_solve_plain
    try:
        yield
    finally:
        box_qp_ipm.box_qp_solve = kernel


def simulation_ocp(N: int, iters: int = FULL_ITERS):
    from mpc_blaster_tpu_torch import config as cfg
    pre = cfg.simulation_preset()
    ocp = dataclasses.replace(
        pre.ocp, N=N, Tf=pre.ocp.Tf * N / pre.ocp.N,
        solver=dataclasses.replace(pre.ocp.solver, qp_backend="pallas",
                                   ipm_iters=iters))
    return dataclasses.replace(pre, ocp=ocp)


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


def compare_kernel(name, qp, K):
    """Kernel vs plain twin on one QP batch; returns the report row."""
    from torch.func import vmap
    from mpc_blaster_tpu_torch.qp.data import qp_objective
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
        ok = vmap(qp_objective)(qp, sk.dx, sk.du)
        op = vmap(qp_objective)(qp, sp.dx, sp.du)
        rel = ((ok - op).abs() / op.abs().clamp(min=1.0)).max().item()
        eq_gap = (sk.kkt_eq - sp.kkt_eq).abs()
        eq_ok = (eq_gap <= 1e-3 + 0.2 * sp.kkt_eq.abs()).float().mean().item()
        row.update(obj_rel_err=rel, kkt_eq_within_frac=eq_ok,
                   kkt_eq_max_kernel=sk.kkt_eq.max().item(),
                   kkt_eq_max_plain=sp.kkt_eq.max().item())
        check(rel <= 1.2e-2, "objective parity", case=name, obj_rel_err=rel)
        check(eq_ok >= 0.95 and sk.kkt_eq.max().item() < 5e-2,
              "kkt_eq parity", case=name, within=eq_ok,
              max_gap=eq_gap.max().item())
    row["kernel_ms"] = cuda_ms(lambda: K.box_qp_solve(qp, iters=FULL_ITERS),
                               reps=10)
    row["plain_ms"] = cuda_ms(
        lambda: K.box_qp_solve_plain(qp, iters=FULL_ITERS), reps=1)
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


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device is visible; this "
                         "script runs the port on an NVIDIA GPU only")
    return run(torch.device("cuda", 0))


def run(dev: torch.device) -> int:
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

    # ---- phase 1: build the kernel library from the checkout ----
    so, secs, build_log = K.build_library()
    ptxas = [ln.strip() for ln in build_log.splitlines()
             if "registers" in ln or "spill" in ln]
    K._library()
    log("build", library=str(so.relative_to(REPO)), nvcc_s=secs,
        ptxas=ptxas)

    # ---- phase 2: kernel vs plain twin on the card ----
    rows = []
    for name, N, B in (("n8_b3", 8, 3), ("n20_b1024", 20, 1024),
                       ("n60_b1", 60, 1)):
        rows.append(compare_kernel(name, blaster_qps(N, B, dev), K))
        log("kernel_vs_plain", **rows[-1])
    qp = blaster_qps(8, 3, dev)
    inf = torch.full_like(qp.lbx, float("inf"))
    free = qp._replace(lbx=-inf, ubx=inf, ubu=torch.full_like(qp.ubu,
                                                              float("inf")))
    rows.append(compare_kernel("n8_b3_inf_bounds", free, K))
    log("kernel_vs_plain", **rows[-1])

    # ---- the main path: batched tick and closed loop, counted ----
    pre20 = simulation_ocp(20)
    spec20 = build_spec(pre20.ocp, yref=pre20.loop.yref, device=dev)
    x0s = torch.as_tensor(draws(1024), device=dev)
    step = batched_rti_step(pre20.ocp, backend="pallas", device=dev)
    pre60 = simulation_ocp(60)
    wrapper = K.box_qp_solve     # holds the launch count
    wrapper.launches = 0

    # phase 3: 10 chained batched ticks, N=20, B=1024
    u0s, states, diag, tick_ms = run_batched_ticks(step, spec20, x0s, 10,
                                                   pre20.ocp)
    launches_batched = wrapper.launches
    check(launches_batched == 10, "batched tick launches",
          launches=launches_batched)
    check(bool(torch.isfinite(u0s).all() & torch.isfinite(states.xbar).all()
               & torch.isfinite(diag.qp_kkt_eq).all()), "batched finite")

    # phase 4: the simulation preset's closed loop, N=60, 100 ticks
    res, loop_ms = timed_closed_loop(pre60, 100, dev)
    launches = wrapper.launches
    check(launches - launches_batched == 100, "closed-loop launches",
          launches=launches - launches_batched)
    xs = res.xs.cpu().numpy()
    check(bool(np.isfinite(xs).all() and np.isfinite(res.us.cpu().numpy())
               .all()), "closed-loop finite")
    golden = np.load(GOLDEN)["xs"]
    pos_err = float(np.abs(xs[:, 0:3] - golden[:, 0:3]).max())
    check(pos_err < 5e-2, "closed loop vs golden", max_pos_err_m=pos_err)

    log("batched_tick", N=20, B=1024, ticks=10, launches=launches_batched,
        ms_per_tick=tick_ms, solves_per_s=1024 * 1000.0 / tick_ms,
        kkt_eq_max=diag.qp_kkt_eq.max().item())
    # plain path of the same tick (fewer ticks: it is launch-bound)
    with plain_qp_solver():
        plain_step = batched_rti_step(pre20.ocp, backend="pallas",
                                      device=dev)
        *_, plain_tick_ms = run_batched_ticks(plain_step, spec20, x0s, 2,
                                              pre20.ocp)
    check(wrapper.launches == launches, "plain path launches no kernel")
    log("batched_tick_plain", N=20, B=1024, ticks=2,
        ms_per_tick=plain_tick_ms,
        solves_per_s=1024 * 1000.0 / plain_tick_ms)

    log("closed_loop", N=60, ticks=100, launches=launches - launches_batched,
        ms_per_tick=loop_ms, golden_max_pos_err_m=pos_err,
        final_z=float(xs[-1, 2]), kkt_eq_max=res.kkt_eq.max().item())
    with plain_qp_solver():
        res_p, plain_loop_ms = timed_closed_loop(pre60, 3, dev)
    check(wrapper.launches == launches, "plain path launches no kernel")
    check(bool(torch.isfinite(res_p.xs).all()), "plain closed-loop finite")
    log("closed_loop_plain", N=60, ticks=3, ms_per_tick=plain_loop_ms)
    if FAILURES:
        for f in FAILURES:
            log("FAILED", **f)
        raise SystemExit(f"chip_smoke: {len(FAILURES)} check(s) failed")

    main_row = next(r for r in rows if r["case"] == "n60_b1")
    report = {"kernels": [{
        "name": "box_qp_ipm", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": REPLACES, "launches": launches,
        "max_abs_err": max(r["max_abs_err_1it"] for r in rows),
        "ms": main_row["kernel_ms"], "plain_ms": main_row["plain_ms"],
        "max_obj_rel_err": max(r["obj_rel_err"] for r in rows),
        "by_shape": {r["case"]: [r["kernel_ms"], r["plain_ms"]]
                     for r in rows},
    }]}
    print(json.dumps(report), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
