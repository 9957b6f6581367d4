"""Smoke run of the PyTorch + CUDA port (`mpc_blaster_tpu_torch`) on one
NVIDIA GPU.

    python3 chip_smoke.py

Builds the box-QP IPM kernel (its plain, fuse_cost and fuse_lin modes,
each with the warm-start blend K3, the soft-bound instantiations K4 of
the plain and fuse_lin modes, the plain mode at 13x4 for the quad13 model
and the fuse_lin mode with the "quad13" and "blaster_dist" prologues) from
`mpc_blaster_tpu_torch/csrc/` with nvcc, holds each mode, cold, warm and
soft, against its plain PyTorch twin on the card (phases 2, 2b and 2c,
which also holds the long horizons N=120 and 240, kernel K7's shapes),
then drives the port's main paths, each with the launch counts set to 0
just before it and read just after:

  3. the batched RTI tick, backend "pallas" (N=20, B=1024, 10 ticks);
  4. the simulation preset's closed loop, backend "pallas" (N=60, frozen
     POC, 100 ticks), checked against tests/golden/simulation_poc_100.npz;
  5. the batched fused tick, backend "pallas_fused" (N=20, B=1024, 10
     chained ticks at 6 and at 12 IPM iterations): one fuse_cost launch
     per tick;
  6. the fused closed loop, `qp_backend="pallas_fused"` (N=60, 100 ticks
     at 12 iterations, held to the golden; and under
     `deployed_solver("safe")`, 6 iterations): one fuse_lin launch per
     tick;
  7. the `deployed_solver("fastest")` closed loop (N=60, 100 ticks,
     frozen POC) through `make_closed_loop(..., warm_start=True)`: the
     guarded warm chain, two warm fuse_lin launches per tick (the tick and
     the watchdog's redo, which returns at once unless the tick tripped);
  8. the altitude-step stress of bench.py (N=20, 200 ticks from z=0.5):
     "fastest", and the raw chain (4 iterations, warm_mode="full", no
     shift) under the watchdog;
  9. the presets' default `qp_backend="riccati"` (eager PyTorch, no kernel
     of ours): 3 ticks of the simulation preset's loop at N=60;
 10. the soft-bounded closed loop (`rti_step_soft` + the plant's RK4, the
     simulation preset at N=60, 100 ticks from x0[0]=2.4 outside the
     +-1.5 m box, soft state bounds Zl=1e3, zl=1e2, 6 IPM iterations):
     "pallas_fused" (one soft fuse_lin launch per tick) and "pallas" with
     the fused linearizer (one soft plain launch per tick);
 11. the batched "xla" tick (the Riccati IPM on the batch, eager PyTorch):
     2 ticks at N=20, B=1024;
 12. figure-8 tracking (`sim/tasks.py::run_figure8`), "pallas_fused": the
     simulation preset at N=60, 12 iterations, 120 ticks, held to
     tests/golden/figure8_120.npz; and bench.py's fig8_rt6f configuration
     (N=20, 6 iterations, 220 ticks), its settle error after tick 60;
 13. the offset-free loop (`sim/scenarios.py::offset_free_loop`) at
     bench.py's configuration (the simulation preset at N=30, Tf 1 s,
     "pallas_fused" at 6 iterations, wind (0.7, -0.5, 0.2), 250 ticks from
     z=3): one fuse_lin "blaster_dist" launch per tick;
 14. the quad13 hover chain (`models/quad13.py`, N=20, 6 iterations, 60
     ticks from z=1 to the hover at z=2 with the model's own RK4 plant)
     under "pallas" (one 13x4 plain launch per tick) and "pallas_fused"
     (one fuse_lin "quad13" launch per tick);
 15. long horizons: the simulation preset at N=120 and N=240 under
     "pallas", 12 iterations, 20 ticks from the ground (the kernel has one
     layout for every N, so the solver's streaming flags select nothing).

Each phase's wall seconds and the running total are printed ("wall"
lines).

Every phase prints one line; any failure raises and the exit code is
non-zero. Without a CUDA device it fails before printing any result; it
never falls back to the CPU. The last two lines are the kernel report and
the device record, each one JSON object. Each kernel entry carries its
bound: the larger of the FLOPs of the launch over the card's 67 TFLOP/s
float32 rate and its bytes (each input read once, each output written
once) over 3.35 TB/s, both counted from the launch's shapes
(`launch_work`); `library_ms` is null: no single PyTorch call solves a
box-constrained OCP-QP.

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
    there is 0.1240 + 5e-2 m; under "fastest" it ends 0.0111 m from it
    (the port's twins on the CPU: 0.0198 m), bound 0.0111 + 5e-2 m;
  - the altitude step: overshoot above z=3.5 within the JAX package's own
    float32 run of the same chain (its Riccati IPM on the CPU: 0.0186 m
    under "fastest", 0.0 m for the raw chain under the watchdog; the
    port's twins on the CPU: 0.0186 m and 0.0139 m) + 5e-2 m, finite
    states. Unguarded, the raw chain's failure is ~200 m;
  - soft bounds (K4), the out-of-box QPs of tests/test_pallas_ipm.py
    (dx0 pushed 2.2 past the x box, soft position bounds Zl=1e3, zl=1e2):
    an all-hard SoftBounds through the soft instantiation equals the hard
    kernel after one iteration bit for bit (or within 1e-6 relative where
    nvcc contracts a multiply-add differently in the two instantiations;
    the twins are bit-exact, tests/test_torch_soft.py); the soft kernel
    against its twin after one iteration pointwise as above; after the
    full budget the penalized objective within 2e-3 relative + 1e-3 and
    the peak upper-x violation within rtol 0.2 (+ 1e-3)
    (tests/test_pallas_ipm.py), on every problem, or at B=1024 on at least
    95% of them and within 5e-2 relative on all (the batch rule above). The
    plain mode at N=60 B=1 (phase 10's shape) adds the twin's own spread,
    capped at 2e-3 relative, to the objective tolerance at 12 iterations,
    which do not converge that QP (the twin moves its objective by 2.2e-3
    relative when dx0 moves by 1e-6 relative), and holds the converged
    24-iteration solve to the tolerance alone (compare_soft);
  - the soft closed loops: finite, the first tick's stage-1 upper-x
    violation above 0.5 m, the final distance to the reference within the
    JAX package's own float32 run of the same chain (its `qp/soft.py` on
    the CPU: SOFT_JAX) + 5e-2 m, back inside the +-1.5 m box if that run
    is, and the peak stage-1 violation within 0.05 m of that run's;
  - the other models' instantiations (phase 2c) as the plain and fuse_lin
    modes above, the prologues against `fast_linearize` of their family;
    the long horizons (K7) as the plain mode above at N=120 and 240 (the
    soft case at N=120 as the soft cases below, without the spread rule:
    12 iterations meet the tolerance there, 24 do not converge it);
  - figure-8: positions within 5e-2 m of figure8_120.npz (tests/
    test_golden.py:43); fig8_rt6f's max xy error after tick 60 within the
    JAX package's own float32 run of the same loop on the CPU (its Riccati
    IPM at 6 iterations: FIG8_JAX) + 5e-2 m;
  - the offset-free loop: settle error and wind-estimate error within the
    JAX package's own float32 run (its Riccati IPM: OFFSET_FREE_JAX) + 5e-2
    m;
  - quad13: both backends reach the hover within the criterion of
    tests/test_quad13.py::test_quad13_rti_converges_to_hover (|z - 2| <
    0.05, unit quaternion within 1e-3, |v| < 0.05), and their first-tick
    u0 agree within 5e-2 (tests/test_fused_tick.py:196);
  - long horizons: positions within 5e-2 m of the JAX package's own
    float32 "riccati" run (every fifth tick: LONG_JAX);
  - warm starts (K3): the blend itself pointwise (0 IPM iterations return
    the blended initial slacks and duals; rtol 1e-5 / atol 1e-6) on valid,
    invalid (valid=0) and NaN/+inf-poisoned problems; valid=0 problems
    equal a cold launch bit for bit. The warm cases are the last ticks of
    a 100-tick "fastest" chain (x0 spread by 1e-3 across a batch). Past
    the blend, the clean valid problems are held to the cold tolerances
    above at N=60 (the main path's shape, where the warm solve is well
    conditioned: 7e-5 of du per 1e-6 relative change of the warm state
    after one iteration, measured on the CPU). At N=8 and N=20 the same
    change moves du by 0.4-1.1 after one iteration (f32 warm solves are
    chaotic there; the JAX package's solvers differ from each other by as
    much), so the kernel is held to the twin's own spread against a copy
    of itself started 1e-6 away (compare_warm).
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
GOLDEN = REPO / "tests" / "golden" / "simulation_poc_100.npz"
GOLDEN_FIG8 = REPO / "tests" / "golden" / "figure8_120.npz"
KERNEL_SOURCE = "mpc_blaster_tpu_torch/csrc/box_qp_ipm.cu"
REPLACES = {"box_qp_ipm": "mpc_blaster_tpu/ops/pallas_ipm.py:215",
            "box_qp_ipm_fuse_cost": "mpc_blaster_tpu/ops/pallas_ipm.py:1236",
            "box_qp_ipm_fuse_lin": "mpc_blaster_tpu/ops/pallas_ipm.py:1163",
            "box_qp_ipm_warm": "mpc_blaster_tpu/ops/pallas_ipm.py:402",
            "box_qp_ipm_soft": "mpc_blaster_tpu/ops/pallas_ipm.py:249",
            "box_qp_ipm_13x4": "mpc_blaster_tpu/ops/pallas_ipm.py:215",
            "box_qp_ipm_fuse_lin_quad13":
                "mpc_blaster_tpu/ops/pallas_ipm.py:1163",
            "box_qp_ipm_fuse_lin_blaster_dist":
                "mpc_blaster_tpu/ops/pallas_ipm.py:1163",
            "box_qp_ipm_long_horizon": "mpc_blaster_tpu/ops/pallas_ipm.py:293"}
FULL_ITERS = 12   # the simulation preset's ipm_iters
SAFE_ITERS = 6    # deployed_solver("safe")
FASTEST_ITERS = 3  # deployed_solver("fastest")
BATCH = 1024      # the batched ticks' scenarios
TICKS = 10        # chained batched ticks
LOOP_TICKS = 100  # closed-loop ticks (the golden's length)
ALT_TICKS = 200   # the altitude-step stress (bench.py)
CHAIN_TICKS = 100  # the warm chain the warm-start cases are taken from
SAFE_BOUND_M = 0.1240 + 5e-2
FASTEST_BOUND_M = 0.0111 + 5e-2
ALT_BOUND_M = {"fastest": 0.0186 + 5e-2, "raw_watchdog": 0.0 + 5e-2}
# The JAX package's own float32 run of phase 10's soft chain on the CPU
# (qp_backend="riccati"; tests/test_torch_soft.py::
# test_chip_smoke_soft_loop_bounds_are_jax_run computes it)
SOFT_JAX = {"final_dist_m": 0.0420, "inside_box": True,
            "peak_stage1_viol_m": 0.9805}
# The JAX package's own float32 runs of phases 12-15 on the CPU, each
# recomputed by a test: fig8_rt6f's loop on its Riccati IPM at 6
# iterations (tests/test_torch_tasks.py::test_chip_smoke_fig8_bound_is_jax_run),
# the offset-free loop on its Riccati IPM at 6 iterations
# (tests/test_torch_scenarios.py::test_chip_smoke_offset_free_bounds_are_jax_run),
# and the long-horizon loops' positions every fifth tick on its Riccati
# IPM at 12 iterations (tests/test_torch_stream.py::
# test_chip_smoke_long_horizon_positions_are_jax_run). BENCH_R05 holds the
# round-5 bench rows (BENCH_r05.json, taken on a TPU v5e) printed beside
# the port's numbers; they bound nothing.
FIG8_JAX = {"settle_err_m": 0.0388}
OFFSET_FREE_JAX = {"settle_err_m": 0.0053, "wind_est_err": 0.0}
LONG_JAX = {
    120: [[0.0, 0.0, 0.0], [-0.000126, 0.0, 0.140538],
          [-0.001981, 1e-06, 0.307211], [-0.006096, 1e-06, 0.473889],
          [-0.0116, 0.0, 0.640565]],
    240: [[0.0, 0.0, 0.0], [-0.000124, 0.0, 0.140688],
          [-0.001975, 1e-06, 0.307471], [-0.006086, 1e-06, 0.474142],
          [-0.011584, 0.0, 0.640817]]}
BENCH_R05 = {"fig8_rt6f_settle_err_m": 0.0387,
             "fig8_cold12_settle_err_m": 0.0384,
             "offsetfree_settle_err_m": 0.0053}
LONG_TICKS = 20      # phase 15's ticks from the ground
FIG8_TICKS = 120     # the figure-8 golden's length
RT6F_TICKS = 220     # bench.py's fig8 rows
OF_TICKS = 250       # bench.py's offset-free row
Q13_TICKS = 60       # tests/test_quad13.py's hover test


# The card's peaks (NVIDIA's H100 SXM data sheet): float32 outside the
# tensor cores and HBM3 bandwidth.
PEAK_FLOPS = 67e12
PEAK_BYTES = 3.35e12


# Floating-point operations the solve needs, counted by hand from
# csrc/box_qp_ipm.cu: +, -, *, / and a min, max or compare count one, a
# clip two, a transcendental one; sign flips and selects count none. Each
# value the algorithm needs is counted once, where it is first needed,
# however often the kernel recomputes it.
#
# The rows-form ODE of a family at one point (`family_rows`), counted as
# FLOPs for the values (once per node) and per tangent column:
#   blaster: 150 for the values, 2 more for tan's derivative factor
#     1 + tan^2; 233 per tangent column (a product of two dual numbers 3,
#     with a constant 1, a quotient 3, a trig 1: its cosine or sine is the
#     value part's);
#   blaster_dist: blaster's and the six disturbance adds (values only);
#   quad13 (`quad13_rows`): 90 for the values (the norm 8, four divisions,
#     the thrust column 13, q_dot 24, the moments 12, Euler's equation
#     21); 159 per tangent column (sqrt's derivative 2, the quotients 3
#     each).
# RK4 (`rk4_rows`) adds 13 per state for the values and per column.
ODE_FLOPS = {"blaster": (150 + 2, 233), "blaster_dist": (150 + 2 + 6, 233),
             "quad13": (90, 159)}


def rk4_flops(family: str, nx: int) -> tuple:
    """(value FLOPs per node, tangent FLOPs per column) of one RK4 step."""
    value, tangent = ODE_FLOPS[family]
    return 4 * value + 13 * nx, 4 * tangent + 13 * nx


# Per bound entry (one side of a row) and IPM iteration: the barrier weight
# and its pair cap 3, the slack residual 2, the predictor's gradient term 2,
# directions 6 (s*lam from the complementarity sum), step ratios 6 and
# mu_aff term 6, the corrector's target 4, gradient term 5 (sig*r reused),
# directions 7 and ratios 8, the update 8 (the primal step shared by the
# row's two entries), the complementarity sum at the new iterate 2.
ENTRY_ITER = 3 + 2 + 2 + 6 + 6 + 6 + 4 + 5 + 7 + 8 + 8 + 2
# The same, more, per soft entry: the eliminated weight 6, the residual's
# -t 1, the predictor's right-hand side 6, directions (dt, dgam) 9, ratios
# 6, mu_aff term 6, the corrector's target 4, right-hand side 9,
# directions 10, ratios 8, the (t, gam) update 7, and at the new iterate
# t*gam 2 and the merit's |z + Z t - lam - gam| 8.
SOFT_ITER = 6 + 1 + 6 + 9 + 6 + 6 + 4 + 9 + 10 + 8 + 7 + 8
# At the start: per entry the initial slack and dual 10 and their
# complementarity 2; per soft entry the (t, gam) start 5 and as at the end
# of an iteration 8.
ENTRY_INIT, SOFT_INIT = 10 + 2, 5 + 8


def chol_flops(nu: int) -> int:
    """FLOPs of the kernel's equilibrated nu x nu Cholesky inverse
    (`chol_inverse`): the scaling 2 nu, the factor, the inverse of L and
    the product L^-T L^-1 with the unscaling, each value once."""
    fac = sum(5 + 2 * j + (nu - 1 - j) * (3 + 2 * j) for j in range(nu))
    inv = sum(1 + sum(2 + 2 * (i - j - 1) for i in range(j + 1, nu))
              for j in range(nu))
    out = sum(2 * (nu - max(i, j)) + 1 for i in range(nu) for j in range(nu))
    return 2 * nu + fac + inv + out


def launch_work(mode: str, N: int, B: int, iters: int, soft_rows: int = 0,
                warm: bool = False, nsteps: int = 1, nx: int = 17,
                nu: int = 6, family: str = "blaster") -> tuple:
    """(FLOPs, bytes) of one box-QP IPM launch, counted from its shapes.

    FLOPs: per problem, what the solve needs (the counts above): every
    matrix product at 2 FLOPs per multiply-add (the factorization's P'A,
    P'B, B'PB, B'PA, A'PA, Hux'Z and Hinv'Hux, the two sweeps' and the KKT
    pass's matrix-vector products; the right-hand side reuses the KKT
    pass's Q x + q and R u + r), the nu x nu Cholesky inverse
    (`chol_flops`), the elementwise terms of the bound rows, and the
    FUSE_LIN prologue's RK4 of the family's ODE (its value part once per
    node, its tangent part once per (node, column) pair). `soft_rows`
    counts the soft entries of one problem. Every bound of the main path
    is finite and every iteration runs, so the count does not depend on
    the data. Bytes: each input read once and each output written once
    (float32; the FUSE_LIN stage parameters at the family's width); the
    workspace is scratch and not counted."""
    from mpc_blaster_tpu_torch.ops.box_qp_ipm import FAMILY_NP
    n = N
    e = 2 * (nx + nu)                          # bound entries per stage
    fac = (4 * nx ** 3 + 6 * nx ** 2 * nu + 4 * nu ** 2 * nx + 4 * nx ** 2
           + nu ** 2 + 2 * nu + nx + chol_flops(nu))
    sweep = 6 * nx ** 2 + 8 * nx * nu + 2 * nu ** 2 + 5 * nx + 2 * nu
    kkt = 6 * nx ** 2 + 4 * nx * nu + 2 * nu ** 2 + 5 * nx + 3 * nu
    per_it = n * (fac + 2 * sweep + kkt + ENTRY_ITER * e) \
        + SOFT_ITER * soft_rows
    flops = (n * (2 * nx ** 2 + nx) + n * kkt + ENTRY_INIT * n * e
             + SOFT_INIT * soft_rows                         # init + seed
             + iters * per_it + n * kkt)                     # final KKT
    if mode != "plain":                        # cost and bound assembly
        flops += 2 * (n + 1) * nx ** 2 + 2 * n * nu ** 2 + 2 * n * (nx + nu)
    if mode == "fuse_lin":                     # RK4 on duals + the defect
        value, tangent = rk4_flops(family, nx)
        flops += n * nsteps * (value + (nx + nu) * tangent) + n * nx
    floats_in = 2 * nx * nx + nu * nu + nx     # Qs, Qt, R, x0 / dx0
    if mode == "fuse_lin":
        floats_in += (n + 1) * nx + n * nu + n * FAMILY_NP[family] \
            + nu * nu + n * (nx + nu) + nx + 2 * (nx + nu)
    else:
        floats_in += n * (nx * nx + nx * nu + nx)     # A, B, c
        if mode == "plain":
            floats_in += (n + 1) * nx + n * nu + 2 * n * (nx + nu)
        else:
            floats_in += (n + 1) * nx + n * nu + nu * nu \
                + n * (nx + nu) + nx + 2 * (nx + nu)
    if soft_rows:
        floats_in += 4 * n * (nx + nu)         # Z, z of the four groups
    if warm:
        floats_in += 1 + 4 * n * (nx + nu)
    floats_out = (n + 1) * nx + n * nu + 6 + 4 * n * (nx + nu)
    return float(B * flops), float(4 * B * (floats_in + floats_out))


def launch_bound(mode, N, B, iters, **kw) -> dict:
    """The least time the card could take for one launch, and what sets
    it."""
    flops, nbytes = launch_work(mode, N, B, iters, **kw)
    t_ops, t_bytes = flops / PEAK_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "flops": flops, "bytes": nbytes}


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


def soft_launches(fn) -> int:
    """A wrapper's launches of soft-bound instantiations (kernel K4)."""
    return sum(v for k, v in fn.by_instance.items() if k.endswith(" soft"))


def counts() -> dict:
    """Launches per wrapper, and ("<wrapper>.warm", "<wrapper>.soft") those
    with a warm start (kernel K3) and with soft bounds (kernel K4)."""
    out = {}
    for w, fn in KERNEL_WRAPPERS.items():
        out[w] = fn.launches
        out[w + ".warm"] = fn.warm_launches
        out[w + ".soft"] = soft_launches(fn)
    return out


def reset_counts():
    for fn in KERNEL_WRAPPERS.values():
        fn.launches = 0
        fn.warm_launches = 0
        fn.by_instance = {}


def instance_counts() -> dict:
    """Launches per wrapper and instantiation ("<wrapper>[<instance>]",
    e.g. "fused_rti_solve[13x4 quad13]"), the non-zero ones."""
    return {f"{w}[{k}]": v for w, fn in KERNEL_WRAPPERS.items()
            for k, v in fn.by_instance.items() if v}


START = time.perf_counter()
_LAST = [START]


def wall(phase: str):
    """Log the wall seconds since the previous mark and the total."""
    now = time.perf_counter()
    log("wall", step=phase, s=now - _LAST[0], total_s=now - START)
    _LAST[0] = now


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


def compare_kernel(name, qp, K, time_iters=(FULL_ITERS,)):
    """Plain-mode kernel vs plain twin on one QP batch; the report row
    (times at FULL_ITERS as kernel_ms / plain_ms, at other `time_iters`
    with an "_<n>it" suffix)."""
    row = {"case": name, "B": qp.A.shape[0], "N": qp.A.shape[1],
           "nx": qp.A.shape[-1], "nu": qp.B.shape[-1]}
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
    for it in time_iters:
        sfx = "" if it == FULL_ITERS else f"_{it}it"
        row["kernel_ms" + sfx] = cuda_ms(
            lambda: K.box_qp_solve(qp, iters=it), reps=10)
        row["plain_ms" + sfx] = cuda_ms(
            lambda: K.box_qp_solve_plain(qp, iters=it), reps=1)
    return row


# Non-zero disturbance estimates (force, torque accelerations) of the
# "blaster_dist" cases: the offset-free loop's wind and a small torque.
DIST_ROWS = (0.7, -0.5, 0.2, 0.05, -0.03, 0.01)


def fused_case(N: int, B: int, dev, seed: int, family: str = "blaster"):
    """A perturbed hover iterate at N, B with the fused modes' spec
    arguments (shared rows broadcast over the batch) and the plain
    linearization of it: (ocp, stage params, xbar, ubar, x0, args, lin).
    The perturbation keeps the iterate inside the boxes, as the main
    path's iterates are: states +-0.02 around x0 (every node its own
    linearization point), rotor thrusts +-0.5 N around hover. The
    "blaster_dist" family's stage parameters carry DIST_ROWS in rows
    25-30."""
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
    sp = spec.stage_params
    if family == "blaster_dist":
        d = torch.tensor(DIST_ROWS, dtype=torch.float32, device=dev)
        sp = torch.cat([sp, d.expand(N, 6)], -1)
    xp, A, Bm = fast_linearize(xbar, ubar, sp, P, ocp.dt, family=family)
    return ocp, bc(sp), xbar, ubar, x0, args, (A, Bm, xp - xbar[:, 1:])


def quad13_start(N: int, B: int, dev, rng):
    """The quad13 model at N: (config, spec, x0, hover iterate), x0 at
    hover z=1 spread +-0.4 m in position."""
    from mpc_blaster_tpu_torch.models import quad13 as Q
    c = Q.Quad13Config(N=N, Tf=N / 30.0)
    spec = Q.build_quad13_spec(c, device=dev)
    x0 = Q.hover_state(1.0, device=dev).repeat(B, 1)
    x0[:, 0:3] += torch.as_tensor(rng.uniform(-0.4, 0.4, (B, 3)),
                                  dtype=torch.float32, device=dev)
    return c, spec, x0, Q.init_quad13_rti_state(c, x0)


def quad13_fused_case(N: int, B: int, dev, seed: int):
    """fused_case for the quad13 model (`quad13_start`), the iterate
    perturbed as there: (statics, stage params, xbar, ubar, x0, args,
    lin)."""
    from mpc_blaster_tpu_torch.dynamics.fastlin import fast_linearize
    from mpc_blaster_tpu_torch.models import quad13 as Q
    rng = np.random.default_rng(seed)
    c, spec, x0, st = quad13_start(N, B, dev, rng)
    xbar = st.xbar + torch.as_tensor(
        rng.uniform(-0.02, 0.02, st.xbar.shape), dtype=torch.float32,
        device=dev)
    ubar = st.ubar + torch.as_tensor(
        rng.uniform(-0.5, 0.5, st.ubar.shape), dtype=torch.float32,
        device=dev)

    def bc(a):
        return a.expand(B, *a.shape)
    args = (bc(spec.dt * spec.Q), bc(spec.Q_t), bc(spec.dt * spec.R),
            bc(spec.yref_x), bc(spec.yref_u), bc(spec.yref_e),
            bc(spec.lbx), bc(spec.ubx), bc(spec.lbu), bc(spec.ubu))
    xp, A, Bm = fast_linearize(xbar, ubar, spec.stage_params,
                               Q._params(c, device=dev), c.dt,
                               family="quad13")
    return Q.quad13_dyn_statics(c), bc(spec.stage_params), xbar, ubar, \
        x0, args, (A, Bm, xp - xbar[:, 1:])


def quad13_qps(N: int, B: int, dev):
    """Linearized quad13 QPs at the hover iterate (z=1, x0 spread +-0.4
    m), built by the port on the card."""
    from torch.func import vmap
    from mpc_blaster_tpu_torch.dynamics.integrators import discrete_dynamics
    from mpc_blaster_tpu_torch.models import quad13 as Q
    from mpc_blaster_tpu_torch.sqp.rti import RTIState, build_qp
    c, spec, x0, st = quad13_start(N, B, dev, np.random.default_rng(N))
    F = discrete_dynamics(Q.quad13_ode, c.dt)
    P = Q._params(c, device=dev)
    return vmap(lambda xb, ub, x: build_qp(spec, RTIState(xb, ub), x, F, P))(
        st.xbar, st.ubar, x0)


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


def compare_fuse_lin(name, N, dev, K, family="blaster"):
    """fuse_lin kernel with the family's prologue vs
    `fused_rti_solve_plain` (and its prologue vs `fast_linearize` of the
    family); the report row."""
    from mpc_blaster_tpu_torch.sqp.rti import fused_dyn_statics
    if family == "quad13":
        statics, sp, xbar, ubar, x0, args, (A, Bm, c) = quad13_fused_case(
            N, 1, dev, N + 2)
    else:
        ocp, sp, xbar, ubar, x0, args, (A, Bm, c) = fused_case(
            N, 1, dev, N + 2, family)
        statics = fused_dyn_statics(ocp, family=family)
    model, dt, ns = statics
    kw = dict(model=model, dt=dt, num_steps=ns)
    qp = K._fused_qp(K._fused_prep(xbar, ubar, x0, *args, None), A, Bm, c)
    row = {"case": name, "B": 1, "N": N, "family": family}
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


def steady_chain(N: int, dev, keep: int):
    """The states before the last `keep` ticks of a CHAIN_TICKS-tick
    "fastest" warm chain (unguarded `rti_step_warm`, B=1, from the
    preset's start on the ground, default stage parameters, the plant's
    RK4): (ocp, spec, [(RTIState, x0, IpmWarmStart), ...])."""
    from mpc_blaster_tpu_torch import config as cfg
    from mpc_blaster_tpu_torch.dynamics.blaster import (BlasterParams,
                                                        blaster_ode)
    from mpc_blaster_tpu_torch.dynamics.integrators import discrete_dynamics
    from mpc_blaster_tpu_torch.ocp.spec import build_spec
    from mpc_blaster_tpu_torch.qp.ipm import IpmWarmStart
    from mpc_blaster_tpu_torch.sqp import rti as R
    pre = simulation_ocp(N, solver=cfg.deployed_solver("fastest"))
    ocp = pre.ocp
    spec = build_spec(ocp, yref=pre.loop.yref, device=dev)
    P = BlasterParams.from_config(ocp.model, device=dev)
    F = discrete_dynamics(blaster_ode, ocp.dt)
    dyn = R.fused_dyn_statics(ocp)
    x = torch.as_tensor(pre.loop.x0, dtype=torch.float32, device=dev)
    st = R.init_rti_state(ocp, x)
    warm = IpmWarmStart.zeros(N, 17, 6, device=dev)
    plant = spec.stage_params[0].clone()
    plant[-1] = 2.2 * 9.81
    tail = []
    for t in range(CHAIN_TICKS):
        if t >= CHAIN_TICKS - keep:
            tail.append((st, x, warm))
        u0, st, warm, _ = R.rti_step_warm(spec, st, warm, x, P, F,
                                          ocp.solver, dyn_statics=dyn)
        x = F(x, u0, plant, P)
    return ocp, spec, tail


def poison(w, j):
    """NaN and +inf entries in problem j of a warm start (in place)."""
    w.s_lu[j, :2] = float("nan")
    w.lam_lx[j, 1, :3] = float("nan")
    w.s_ux[j, 2, 0] = float("inf")
    w.lam_uu[j, 0, 1] = float("inf")


def warm_case(N: int, B: int, dev, seed: int):
    """A batch of B warm-start cases from a steady "fastest" chain at N:
    problem j takes the chain's state before tick (j mod 16) from the end
    (x0 spread by N(0, 1e-3) past the first 16). Problems with j % 4 == 1
    are invalid (valid=0), those with j % 7 == 2 poisoned with NaN/+inf.
    Returns (ocp, spec rows and inputs dict, warm, masks dict)."""
    from mpc_blaster_tpu_torch.dynamics.blaster import BlasterParams
    from mpc_blaster_tpu_torch.dynamics.fastlin import fast_linearize
    from mpc_blaster_tpu_torch.qp.ipm import IpmWarmStart
    keep = min(B, 16)
    ocp, spec, tail = steady_chain(N, dev, keep)
    pick = [tail[j % keep] for j in range(B)]
    xbar = torch.stack([p[0].xbar for p in pick])
    ubar = torch.stack([p[0].ubar for p in pick])
    x0 = torch.stack([p[1] for p in pick])
    rng = np.random.default_rng(seed)
    spread = rng.normal(0.0, 1e-3, x0.shape).astype(np.float32)
    spread[:keep] = 0.0
    x0 = x0 + torch.as_tensor(spread, device=dev)
    warm = IpmWarmStart(*(torch.stack([p[2][i] for p in pick]).clone()
                          for i in range(len(IpmWarmStart._fields))))
    j = torch.arange(B, device=dev)
    invalid = (j % 4 == 1) if B > 1 else torch.zeros(1, dtype=torch.bool,
                                                      device=dev)
    poisoned = (j % 7 == 2) & ~invalid
    warm.valid[invalid] = 0.0
    for k in poisoned.nonzero().flatten().tolist():
        poison(warm, k)

    def bc(a):
        return a.expand(B, *a.shape)
    args = (bc(spec.dt * spec.Q), bc(spec.Q_t), bc(spec.dt * spec.R),
            bc(spec.yref_x), bc(spec.yref_u), bc(spec.yref_e),
            bc(spec.lbx), bc(spec.ubx), bc(spec.lbu), bc(spec.ubu))
    P = BlasterParams.from_config(ocp.model, device=dev)
    xp, A, Bm = fast_linearize(xbar, ubar, spec.stage_params, P, ocp.dt)
    inp = dict(xbar=xbar, ubar=ubar, x0=x0, args=args, A=A, Bm=Bm,
               c=xp - xbar[:, 1:], sp=bc(spec.stage_params))
    return ocp, inp, warm, dict(invalid=invalid, poisoned=poisoned,
                                clean=~invalid & ~poisoned)


def warm_runners(mode, ocp, inp, K):
    """(kernel, twin) solve functions of one mode on a warm case:
    f(iters, warm) -> delta-form QPSolution; and the case's QP."""
    from mpc_blaster_tpu_torch.sqp.rti import fused_dyn_statics
    xb, ub, x0, args = inp["xbar"], inp["ubar"], inp["x0"], inp["args"]
    qp = K._fused_qp(K._fused_prep(xb, ub, x0, *args, None), inp["A"],
                     inp["Bm"], inp["c"])
    if mode == "plain":
        return (lambda it, w: K.box_qp_solve(qp, iters=it, warm=w),
                lambda it, w: K.box_qp_solve_plain(qp, iters=it, warm=w),
                qp)
    if mode == "fuse_cost":
        fa = (torch.cat([inp["A"], inp["Bm"]], -1), inp["c"], xb, ub, x0,
              *args)

        def delta(sol):
            return sol._replace(dx=sol.dx - xb, du=sol.du - ub)
        return (lambda it, w: delta(K.batched_fused_tick(
                    *fa, iters=it, warm=w)[3]),
                lambda it, w: delta(K.batched_fused_tick_plain(
                    *fa, iters=it, warm=w)[3]), qp)
    model, dt, ns = fused_dyn_statics(ocp)
    fa = (xb, ub, inp["sp"], x0, *args)
    kw = dict(model=model, dt=dt, num_steps=ns)
    return (lambda it, w: K.fused_rti_solve(*fa, iters=it, warm=w, **kw),
            lambda it, w: K.fused_rti_solve_plain(*fa, iters=it, warm=w,
                                                  **kw), qp)


SLACK_DUALS = ("s_lx", "s_ux", "s_lu", "s_uu",
               "lam_lx", "lam_ux", "lam_lu", "lam_uu")


def warm_gaps(a, b, qp, sel, iters) -> torch.Tensor:
    """Per selected problem, whether solutions a and b agree: pointwise
    after one iteration (u0 atol 2e-3, dx/du atol 5e-3), on the QP
    objective (1.2e-2 relative) and kkt_eq (rtol 0.2 / atol 1e-3) after
    more."""
    from torch.func import vmap
    from mpc_blaster_tpu_torch.qp.data import qp_objective
    if iters == 1:
        u0 = (a.du[:, 0] - b.du[:, 0]).abs().amax(1)
        du = (a.du - b.du).abs().amax((1, 2))
        dx = (a.dx - b.dx).abs().amax((1, 2))
        return ((u0 <= 2e-3) & (du <= 5e-3) & (dx <= 5e-3))[sel]
    oa = vmap(qp_objective)(qp, a.dx, a.du)
    ob = vmap(qp_objective)(qp, b.dx, b.du)
    obj = (oa - ob).abs() <= 1.2e-2 * ob.abs().clamp(min=1.0)
    eq = (a.kkt_eq - b.kkt_eq).abs() <= 1e-3 + 0.2 * b.kkt_eq.abs()
    return (obj & eq)[sel]


def compare_warm(name, mode, N, B, dev, K):
    """Warm-start kernel (K3, in one mode) vs its plain twin; the report
    row. fuse_lin (B=1) runs its clean, poisoned and invalid problems as
    three launches.

    Held everywhere: the blend pointwise (0 iterations), valid=0 bit for
    bit the cold launch, finite iterates. Past the blend the clean valid
    problems are held to the cold tolerances where the warm solve is
    well conditioned (the main path's case, fuse_lin N=60: measured 7e-5
    of du per 1e-6 relative change of the warm state after one
    iteration); at N=8 and N=20 the chain's warm solves are chaotic in f32
    (0.4-1.1 of du per 1e-6, measured on the CPU), so there the
    kernel-vs-twin agreement is held to the twin's own against a copy of
    itself started from the warm state moved by 1e-6 relative (the
    within-tolerance fraction no more than 0.05 lower, on batches of at
    least 64; reported for the others)."""
    ocp, inp, warm, masks = warm_case(N, max(B, 3), dev, seed=N + B)
    if mode == "fuse_lin":
        parts = []
        for k in (0, 2, 1):   # clean, poisoned, invalid
            sl = slice(k, k + 1)
            sub = dict(inp, xbar=inp["xbar"][sl], ubar=inp["ubar"][sl],
                       x0=inp["x0"][sl], sp=inp["sp"][sl],
                       args=tuple(a[sl] for a in inp["args"]),
                       A=inp["A"][sl], Bm=inp["Bm"][sl], c=inp["c"][sl])
            parts.append((sub, type(warm)(*(a[sl] for a in warm)),
                          {m: v[sl] for m, v in masks.items()}))
    else:
        parts = [(inp, warm, masks)]
    strict = mode == "fuse_lin" and N == 60
    row = {"case": name, "mode": mode, "B": B, "N": N, "strict": strict}
    errs = {"blend": 0.0, "1it": 0.0}
    for inp_p, w, m in parts:
        kern, plain, qp = warm_runners(mode, ocp, inp_p, K)
        # the blend: 0 iterations return the blended initial slacks/duals
        sk, sp = kern(0, w), plain(0, w)
        torch.cuda.synchronize()
        for f in SLACK_DUALS:
            a, b = getattr(sk, f), getattr(sp, f)
            err = (a - b).abs().max().item()
            errs["blend"] = max(errs["blend"], err)
            check(bool(torch.isclose(a, b, rtol=1e-5, atol=1e-6).all()),
                  "warm blend", case=name, field=f, err=err)
        cold_w = w._replace(valid=torch.zeros_like(w.valid))
        moved = w._replace(**{f: getattr(w, f) * (1 + 1e-6)
                              for f in SLACK_DUALS})
        sel = m["clean"].nonzero().flatten()
        for iters in (1, FASTEST_ITERS, FULL_ITERS):
            a, c = kern(iters, w), kern(iters, None)
            off = kern(iters, cold_w)
            torch.cuda.synchronize()
            p_, q_ = plain(iters, w), plain(iters, moved)
            for f in ("dx", "du"):
                check(bool(torch.isfinite(getattr(a, f)).all()), "finite",
                      case=name, iters=iters, field=f)
            # valid=0: the cold launch bit for bit (the watchdog's redo)
            inv = m["invalid"]
            same = all(torch.equal(getattr(off, f), getattr(c, f))
                       and torch.equal(getattr(a, f)[inv],
                                       getattr(c, f)[inv])
                       for f in ("dx", "du", "s_lx", "lam_uu", "kkt_eq"))
            check(same, "valid=0 is the cold launch", case=name, iters=iters)
            if sel.numel() == 0:
                continue
            kt = warm_gaps(a, p_, qp, sel, iters).float().mean().item()
            tt = warm_gaps(q_, p_, qp, sel, iters).float().mean().item()
            row[f"within_frac_{iters}it"] = kt
            row[f"twin_self_within_frac_{iters}it"] = tt
            if iters == 1 and strict:
                errs["1it"] = max(
                    (a.du - p_.du).abs().max().item(),
                    (a.dx - p_.dx).abs().max().item())
            if strict:
                check(kt == 1.0, "warm parity", case=name, iters=iters)
            elif sel.numel() >= 64:
                check(kt >= tt - 0.05, "warm parity within the twin's own "
                      "spread", case=name, iters=iters, within=kt,
                      twin_self=tt)
        if inp_p is parts[0][0]:
            w_ = w
            row["kernel_ms_3it"] = cuda_ms(lambda: kern(FASTEST_ITERS, w_),
                                           reps=10)
            row["plain_ms_3it"] = cuda_ms(lambda: plain(FASTEST_ITERS, w_),
                                          reps=1)
            row["cold_kernel_ms_3it"] = cuda_ms(
                lambda: kern(FASTEST_ITERS, None), reps=10)
    row["blend_max_abs_err"] = errs["blend"]
    row["max_abs_err_1it"] = errs["1it"]
    return row


def soft_specs(N: int, dev, idx=(0, 1, 2)):
    """(soft position bounds Zl=1e3, zl=1e2 on the components `idx` (None:
    every state), the all-hard SoftBounds) at horizon N."""
    from mpc_blaster_tpu_torch.qp.soft import SoftBounds, SoftPenalty
    soft = SoftBounds.state_bounds(N, 17, 6, Zl=1e3, zl=1e2, idx=idx,
                                   device=dev)
    hard = SoftBounds(*(SoftPenalty.hard((N, w), device=dev)
                        for w in (17, 17, 6, 6)))
    return soft, hard


def soft_runners(mode, N, B, dev, K):
    """(kernel, twin, QP) of one soft mode on the out-of-box QPs: f(iters,
    soft) -> delta-form QPSolution. dx0 is pushed 2.2 past the x box
    (tests/test_pallas_ipm.py:303-329)."""
    if mode == "plain":
        qp = blaster_qps(N, B, dev)
        qp = qp._replace(dx0=qp.dx0.clone())
        qp.dx0[:, 0] += 2.2
        return (lambda it, s: K.box_qp_solve(qp, iters=it, soft=s),
                lambda it, s: K.box_qp_solve_plain(qp, iters=it, soft=s),
                qp)
    from mpc_blaster_tpu_torch.sqp.rti import fused_dyn_statics
    ocp, sp, xbar, ubar, x0, args, (A, Bm, c) = fused_case(N, B, dev, N + 3)
    x0 = x0.clone()
    x0[:, 0] += 2.2
    model, dt, ns = fused_dyn_statics(ocp)
    fa = (xbar, ubar, sp, x0, *args)
    kw = dict(model=model, dt=dt, num_steps=ns)
    qp = K._fused_qp(K._fused_prep(xbar, ubar, x0, *args, None), A, Bm, c)
    return (lambda it, s: K.fused_rti_solve(*fa, iters=it, soft=s, **kw),
            lambda it, s: K.fused_rti_solve_plain(*fa, iters=it, soft=s,
                                                  **kw), qp)


def compare_soft(name, mode, N, B, dev, K, spread_rule=False):
    """Soft-bound kernel (K4, in one mode) vs its plain twin, and its
    all-hard case vs the hard kernel; the report row.

    spread_rule: the full-budget objective is held within the tolerance
    plus the twin's own spread (the largest objective change of the twin
    when dx0 moves by +-1e-6 or +-1e-7 relative), the spread capped at the
    tolerance's 2e-3 relative, and a converged solve (24 iterations) to the
    tolerance alone. For the plain mode at the main
    path's N=60, where 12 iterations do not converge the out-of-box QP (the
    twin's mu is in the row; measured on the CPU: mu ~315, the objective
    still falls 1.8% by 16 iterations and is steady from there) and the
    twin's own spread (in the row) reaches the tolerance."""
    from mpc_blaster_tpu_torch.qp.soft import soft_qp_objective
    kern, plain, qp = soft_runners(mode, N, B, dev, K)
    soft, hard = soft_specs(N, dev)
    row = {"case": name, "mode": mode, "B": B, "N": N}
    wrapper = K.box_qp_solve if mode == "plain" else K.fused_rti_solve
    # the sentinel: all-hard through the soft instantiation = hard kernel
    n0 = soft_launches(wrapper)
    a, b = kern(1, None), kern(1, hard)
    torch.cuda.synchronize()
    check(soft_launches(wrapper) == n0 + 1, "soft launch counted", case=name)
    fields = ("dx", "du", "s_lx", "s_ux", "s_lu", "s_uu", "lam_lx",
              "lam_ux", "lam_lu", "lam_uu", "kkt_eq", "kkt_stat", "mu")
    exact = all(torch.equal(getattr(a, f), getattr(b, f)) for f in fields)
    rel = max(((getattr(a, f) - getattr(b, f)).abs()
               / getattr(a, f).abs().clamp(min=1e-30)).max().item()
              for f in fields)
    row["all_hard_bit_exact"] = exact
    row["all_hard_max_rel_err"] = rel
    check(exact or rel <= 1e-6, "all-hard soft kernel is the hard kernel",
          case=name, max_rel_err=rel)
    for iters in (1, FULL_ITERS) + ((2 * FULL_ITERS,) if spread_rule
                                    else ()):
        sk, sp = kern(iters, soft), plain(iters, soft)
        torch.cuda.synchronize()
        for f in ("dx", "du", "kkt_eq", "mu"):
            check(bool(torch.isfinite(getattr(sk, f)).all()), "finite",
                  case=name, iters=iters, field=f)
        row[f"plain_mu_{iters}it"] = sp.mu.max().item()
        if iters == 1:
            u0 = (sk.du[:, 0] - sp.du[:, 0]).abs().max().item()
            err = max((sk.dx - sp.dx).abs().max().item(),
                      (sk.du - sp.du).abs().max().item())
            check(u0 <= 2e-3 and err <= 5e-3, "one-iteration parity",
                  case=name, u0_err=u0, max_abs_err=err)
            row["max_abs_err_1it"] = err
            continue
        ok = soft_qp_objective(qp, soft, sk.dx, sk.du)      # per problem
        op = soft_qp_objective(qp, soft, sp.dx, sp.du)
        obj = (ok - op).abs() / op.abs().clamp(min=1.0)
        vk = (sk.dx[:, 1:, 0] - qp.ubx[:, 1:, 0]).clamp(min=0).amax(1)
        vp = (sp.dx[:, 1:, 0] - qp.ubx[:, 1:, 0]).clamp(min=0).amax(1)
        tol = 2e-3 * op.abs() + 1e-3
        sfx = "" if iters == FULL_ITERS else f"_{iters}it"
        if spread_rule and iters == FULL_ITERS:
            spread = torch.zeros_like(op)
            for eps in (1e-6, -1e-6, 1e-7, -1e-7):
                moved = K.box_qp_solve_plain(qp._replace(
                    dx0=qp.dx0 * (1 + eps)), iters=iters, soft=soft)
                spread = torch.maximum(spread, (soft_qp_objective(
                    qp, soft, moved.dx, moved.du) - op).abs())
            row["twin_self_spread_rel"] = (spread / op.abs()).max().item()
            tol = tol + torch.minimum(spread, 2e-3 * op.abs())
        good = ((ok - op).abs() <= tol) \
            & ((vk - vp).abs() <= 0.2 * vp + 1e-3)
        frac = good.float().mean().item()
        row.update({"obj_rel_err" + sfx: obj.max().item(),
                    "within_frac" + sfx: frac,
                    "obj_err_over_tol" + sfx: ((ok - op).abs() / tol)
                    .max().item(),
                    "peak_viol_kernel" + sfx: vk.max().item(),
                    "peak_viol_plain" + sfx: vp.max().item()})
        if B > 3:
            ok_all = frac >= 0.95 and ((ok - op).abs()
                                       <= 5e-2 * op.abs()).all().item()
        else:
            ok_all = frac == 1.0
        check(ok_all and vp.max().item() > 1e-2, "soft full-budget parity",
              case=name, iters=iters, within=frac,
              obj_rel_err=obj.max().item())
    for iters in (SAFE_ITERS, FULL_ITERS):
        sfx = "" if iters == SAFE_ITERS else f"_{iters}it"
        row["kernel_ms" + sfx] = cuda_ms(lambda: kern(iters, soft), reps=10)
        row["hard_kernel_ms" + sfx] = cuda_ms(lambda: kern(iters, None),
                                              reps=10)
        row["plain_ms" + sfx] = cuda_ms(lambda: plain(iters, soft), reps=1)
    # every soft row of this spec has a finite bound (the preset's box)
    rows_soft = int(sum(p.soft.sum() for p in soft).item())
    row["bound"] = launch_bound(mode, N, B, SAFE_ITERS,
                                soft_rows=rows_soft)
    return row


def guarded_trips():
    """Wrap the port's guarded warm tick so the last watchdog state of a
    closed loop can be read back: (context manager, getter)."""
    from mpc_blaster_tpu_torch.sqp import rti as R
    seen = {}

    @contextlib.contextmanager
    def ctx():
        orig = R.rti_step_warm_guarded

        def wrapped(*a, **kw):
            out = orig(*a, **kw)
            seen["wd"] = out[3]
            return out
        R.rti_step_warm_guarded = wrapped
        try:
            yield
        finally:
            R.rti_step_warm_guarded = orig
    return ctx, lambda: int(seen["wd"].trips) if "wd" in seen else -1


def timed_warm_loop(ocp, spec, x0, n_ticks):
    from mpc_blaster_tpu_torch.sim.closedloop import make_closed_loop
    run = make_closed_loop(ocp, n_ticks, warm_start=True)
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    res = run(spec, x0)
    e1.record()
    torch.cuda.synchronize()
    return res, e0.elapsed_time(e1) / n_ticks


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


def timed(fn, n_ticks):
    """(fn(), ms per tick): CUDA events around a loop of n_ticks."""
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    res = fn()
    e1.record()
    torch.cuda.synchronize()
    return res, e0.elapsed_time(e1) / n_ticks


def quad13_hover_loop(step, dev):
    """Q13_TICKS of a quad13 RTI tick and the model's RK4 plant from
    hover_state(1.0) (tests/test_quad13.py's loop): (final state, first
    tick's u0)."""
    from mpc_blaster_tpu_torch.dynamics.integrators import discrete_dynamics
    from mpc_blaster_tpu_torch.models import quad13 as Q
    qc = Q.Quad13Config(N=20)
    spec = Q.build_quad13_spec(qc, device=dev)
    P = Q._params(qc, device=dev)
    F = discrete_dynamics(Q.quad13_ode, qc.dt)
    x = Q.hover_state(1.0, device=dev)
    st = Q.init_quad13_rti_state(qc, x)
    p0 = torch.zeros(1, device=dev)
    first = None
    for _ in range(Q13_TICKS):
        u0, st, _ = step(spec, st, x)
        first = u0 if first is None else first
        x = F(x, u0, p0, P)
    return x, first


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


def soft_loop_case(dev):
    """Phase 10's start: the simulation preset at its N=60 with yref z=2,
    x0[0]=2.4 (0.9 m outside the x box), z=2, and soft state bounds on
    every state, Zl=1e3, zl=1e2 (bench.py's soft rows): (preset, spec, x0,
    soft)."""
    from mpc_blaster_tpu_torch.ocp.spec import build_spec
    pre = simulation_ocp(60)
    yref = np.zeros(23)
    yref[2] = 2.0
    spec = build_spec(pre.ocp, yref=yref, device=dev)
    x0 = torch.zeros(17, device=dev)
    x0[0], x0[2] = 2.4, 2.0
    soft, _ = soft_specs(60, dev, idx=None)
    return pre, spec, x0, soft


def soft_closed_loop(ocp, spec, x0, soft, n_ticks, dev):
    """`n_ticks` of `rti_step_soft` and the plant's RK4 (stage parameters
    of stage 0, as bench.py's soft rows), all on the device; returns the
    states, the stage-1 violations (upper x, and the worst of any state
    bound) per tick, and ms/tick."""
    from mpc_blaster_tpu_torch.dynamics.blaster import (BlasterParams,
                                                        blaster_ode)
    from mpc_blaster_tpu_torch.dynamics.integrators import discrete_dynamics
    from mpc_blaster_tpu_torch.sqp import rti as R
    P = BlasterParams.from_config(ocp.model, device=dev)
    F = discrete_dynamics(blaster_ode, ocp.dt)
    lin = R.make_linearizer(ocp, P)
    dyn = R.fused_dyn_statics(ocp)
    st, x = R.init_rti_state(ocp, x0), x0
    xs, tux, v1 = [], [], []
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(n_ticks):
        u0, st, _, res = R.rti_step_soft(spec, st, x, P, F, ocp.solver, soft,
                                         linearizer=lin, dyn_statics=dyn)
        x = F(x, u0, spec.stage_params[0], P)
        xs.append(x)
        tux.append(res.t_ux[0, 0])
        v1.append(torch.maximum(res.t_ux[0].max(), res.t_lx[0].max()))
    e1.record()
    torch.cuda.synchronize()
    return (torch.stack(xs).cpu().numpy(), torch.stack(tux).cpu().numpy(),
            torch.stack(v1).cpu().numpy(), e0.elapsed_time(e1) / n_ticks)


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

    wall('1 build')
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
                for n, N in (("n8_b1", 8), ("n20_b1", 20), ("n60_b1", 60))]
    for r in lin_rows:
        log("fuse_lin_vs_plain", **r)
    warm_rows = [compare_warm(n, mode, N, B, dev, K) for n, mode, N, B in (
        ("plain_n8_b3", "plain", 8, 3),
        ("plain_n20_b1024", "plain", 20, BATCH),
        ("fuse_cost_n8_b3", "fuse_cost", 8, 3),
        ("fuse_cost_n20_b1024", "fuse_cost", 20, BATCH),
        ("fuse_lin_n8_b1", "fuse_lin", 8, 1),
        ("fuse_lin_n60_b1", "fuse_lin", 60, 1))]
    for r in warm_rows:
        log("warm_vs_plain", **r)
    wall('2 kernel vs twin')
    # ---- phase 2b: the soft-bound kernel (K4) vs its plain twin ----
    soft_rows = [compare_soft(n, mode, N, B, dev, K, spread_rule=sr)
                 for n, mode, N, B, sr in (
                     ("plain_n8_b3", "plain", 8, 3, False),
                     ("plain_n20_b1024", "plain", 20, BATCH, False),
                     ("plain_n60_b1", "plain", 60, 1, True),
                     ("fuse_lin_n8_b1", "fuse_lin", 8, 1, False),
                     ("fuse_lin_n60_b1", "fuse_lin", 60, 1, False))]
    for r in soft_rows:
        log("soft_vs_plain", **r)
    wall("2b soft kernel vs twin")
    # ---- phase 2c: the other models' instantiations and long horizons ----
    q13_rows = [compare_kernel(n, quad13_qps(N, B, dev), K,
                               time_iters=(SAFE_ITERS, FULL_ITERS))
                for n, N, B in (("q13_n8_b3", 8, 3),
                                ("q13_n20_b1024", 20, BATCH),
                                ("q13_n20_b1", 20, 1))]
    for r in q13_rows:
        log("kernel_13x4_vs_plain", **r)
    fam_rows = {fam: [compare_fuse_lin(f"{fam}_n{N}_b1", N, dev, K, fam)
                      for N in Ns]
                for fam, Ns in (("quad13", (8, 20)),
                                ("blaster_dist", (8, 30)))}
    for r in fam_rows["quad13"] + fam_rows["blaster_dist"]:
        log("fuse_lin_family_vs_plain", **r)
    # K7: the plain kernel at long horizons (one layout for every N)
    long_rows = [compare_kernel(n, blaster_qps(N, B, dev), K)
                 for n, N, B in (("n120_b1", 120, 1), ("n240_b1", 240, 1),
                                 ("n240_b256", 240, 256))]
    for r in long_rows:
        log("long_horizon_vs_plain", **r)
    # 24 iterations do not converge the out-of-box soft QP at N=120 (the
    # twin's mu 363, measured on an H100), so the spread rule's converged
    # check does not apply; 12 iterations meet the plain tolerance (0.35
    # of it, same run)
    long_soft = compare_soft("plain_n120_b1", "plain", 120, 1, dev, K)
    log("long_horizon_soft_vs_plain", **long_soft)
    wall("2c other models and long horizons vs twin")

    # ---- the main paths, each counted on its own ----
    pre20 = simulation_ocp(20)
    spec20 = build_spec(pre20.ocp, yref=pre20.loop.yref, device=dev)
    x0s = torch.as_tensor(draws(BATCH), device=dev)
    step = batched_rti_step(pre20.ocp, backend="pallas", device=dev)
    pre60 = simulation_ocp(60)

    def counted(expected: dict, what: str, fn, instances=None):
        """Run fn with the counts set to 0; check the launches per
        wrapper (and, where given, per instantiation)."""
        reset_counts()
        out = fn()
        got = counts()
        want = {k: expected.get(k, 0) for k in got}
        check(got == want, f"{what} launches", got=got, want=want)
        if instances is not None:
            inst = instance_counts()
            check(inst == instances, f"{what} launches per instantiation",
                  got=inst, want=instances)
        return out, got

    # phase 3: 10 chained batched ticks, N=20, B=1024, backend "pallas"
    (u0s, states, diag, tick_ms), c3 = counted(
        {"box_qp_solve": TICKS}, "batched tick",
        lambda: run_batched_ticks(step, spec20, x0s, TICKS, pre20.ocp))
    check(bool(torch.isfinite(u0s).all() & torch.isfinite(states.xbar).all()
               & torch.isfinite(diag.qp_kkt_eq).all()), "batched finite")

    wall('3 batched tick')
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

    wall('4 closed loop')
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

    wall('5 batched fused tick')
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

    wall('6 fused closed loops')
    # phase 7: deployed_solver("fastest"), N=60, 100 ticks, the guarded
    # warm chain: the tick and the watchdog's redo, two warm launches
    from mpc_blaster_tpu_torch.sim.closedloop import preset_stage_params
    trips_ctx, trips = guarded_trips()
    pre_f = simulation_ocp(60, solver=cfg.deployed_solver("fastest"))
    spec_f = build_spec(pre_f.ocp, yref=pre_f.loop.yref,
                        stage_params=preset_stage_params(pre_f, device=dev),
                        device=dev)
    x_start = torch.as_tensor(pre_f.loop.x0, dtype=torch.float32,
                              device=dev)
    two = {"fused_rti_solve": 2 * LOOP_TICKS,
           "fused_rti_solve.warm": 2 * LOOP_TICKS}
    with trips_ctx():
        (res, ms), c7 = counted(two, "fastest closed loop", lambda:
                                timed_warm_loop(pre_f.ocp, spec_f, x_start,
                                                LOOP_TICKS))
    xs, err = loop_checks("deployed_fastest", res, FASTEST_BOUND_M)
    log("fastest_closed_loop", N=60, ticks=LOOP_TICKS, iters=FASTEST_ITERS,
        launches=c7["fused_rti_solve"],
        warm_launches=c7["fused_rti_solve.warm"], ms_per_tick=ms,
        watchdog_trips=trips(), golden_max_pos_err_m=err,
        bound_m=FASTEST_BOUND_M, final_z=float(xs[-1, 2]),
        kkt_eq_max=res.kkt_eq.max().item())
    warm_launches = c7["fused_rti_solve.warm"]

    wall('7 fastest loop')
    # phase 8: the altitude-step stress, N=20, 200 ticks from z=0.5
    pre20f = simulation_ocp(20)
    spec20f = build_spec(pre20f.ocp, yref=pre20f.loop.yref, device=dev)
    x_alt = torch.zeros(17, device=dev)
    x_alt[2] = 0.5
    alt = {}
    for chain, solver in (
            ("fastest", cfg.deployed_solver("fastest")),
            ("raw_watchdog", dataclasses.replace(
                cfg.deployed_solver("fastest"), ipm_iters=4,
                warm_mode="full", warm_shift=False))):
        ocp_a = dataclasses.replace(pre20f.ocp, solver=solver)
        two = {"fused_rti_solve": 2 * ALT_TICKS,
               "fused_rti_solve.warm": 2 * ALT_TICKS}
        with trips_ctx():
            (res, ms), c8 = counted(two, f"altitude step {chain}", lambda:
                                    timed_warm_loop(ocp_a, spec20f, x_alt,
                                                    ALT_TICKS))
        z = res.xs[:, 2].cpu().numpy()
        over = float(max(z.max() - 3.5, 0.0))
        finite = bool(torch.isfinite(res.xs).all())
        check(finite and over <= ALT_BOUND_M[chain], "altitude step",
              chain=chain, overshoot_m=over, bound_m=ALT_BOUND_M[chain],
              finite=finite)
        alt[chain] = over
        warm_launches += c8["fused_rti_solve.warm"]
        log("altitude_step", chain=chain, N=20, ticks=ALT_TICKS,
            iters=solver.ipm_iters, launches=c8["fused_rti_solve"],
            ms_per_tick=ms, overshoot_m=over, bound_m=ALT_BOUND_M[chain],
            watchdog_trips=trips(), final_z=float(z[-1]),
            kkt_eq_max=res.kkt_eq.max().item())

    wall('8 altitude step')
    # phase 9: the presets' default qp_backend="riccati", eager PyTorch on
    # the card (no kernel of ours), 3 ticks at N=60
    pre_r = cfg.simulation_preset()
    (res, ms), c9 = counted({}, "riccati closed loop",
                            lambda: timed_closed_loop(pre_r, 3, dev))
    check(bool(torch.isfinite(res.xs).all() & torch.isfinite(res.us).all()),
          "riccati closed-loop finite")
    log("riccati_closed_loop", N=60, ticks=3,
        qp_backend=pre_r.ocp.solver.qp_backend, ms_per_tick=ms,
        final_z=float(res.xs[-1, 2]))

    wall('9 riccati loop')
    # phase 10: the soft closed loop, N=60, 100 ticks from outside the box,
    # "pallas_fused" and "pallas" (fused linearizer), 6 IPM iterations
    from mpc_blaster_tpu_torch.sqp import rti as R
    from mpc_blaster_tpu_torch.dynamics.blaster import (BlasterParams,
                                                        blaster_ode)
    from mpc_blaster_tpu_torch.dynamics.integrators import discrete_dynamics
    pre_s, spec_s, x_out, soft_s = soft_loop_case(dev)
    # why the soft tick exists: the hard one-launch tick from the same
    # start faces an infeasible QP (logged only)
    ocp_h = dataclasses.replace(pre_s.ocp, solver=cfg.deployed_solver(
        "safe"))
    _, _, dg_h = R.rti_step(
        spec_s, R.init_rti_state(ocp_h, x_out), x_out,
        BlasterParams.from_config(ocp_h.model, device=dev),
        discrete_dynamics(blaster_ode, ocp_h.dt), ocp_h.solver,
        dyn_statics=R.fused_dyn_statics(ocp_h))
    soft_loop = {}
    for name, solver, wrapper in (
            ("pallas_fused", cfg.deployed_solver("safe"), "fused_rti_solve"),
            ("pallas", dataclasses.replace(
                pre_s.ocp.solver, qp_backend="pallas", lin_backend="fused",
                ipm_iters=SAFE_ITERS), "box_qp_solve")):
        ocp_s = dataclasses.replace(pre_s.ocp, solver=solver)
        (xs, tux, v1, ms), c10 = counted(
            {wrapper: LOOP_TICKS, wrapper + ".soft": LOOP_TICKS},
            f"soft closed loop {name}",
            lambda: soft_closed_loop(ocp_s, spec_s, x_out, soft_s,
                                     LOOP_TICKS, dev))
        finite = bool(np.isfinite(xs).all() and np.isfinite(v1).all())
        dist = float(np.linalg.norm(xs[-1, :3] - np.array([0.0, 0.0, 2.0])))
        inside = bool(np.all(np.abs(xs[-1, :2]) <= 1.5))
        peak = float(v1.max())
        check(finite and float(tux[0]) > 0.5, "soft loop finite, first "
              "tick violates", case=name, t_ux_first=float(tux[0]))
        check(dist <= SOFT_JAX["final_dist_m"] + 5e-2
              and (inside or not SOFT_JAX["inside_box"])
              and abs(peak - SOFT_JAX["peak_stage1_viol_m"]) <= 0.05,
              "soft loop vs the JAX run", case=name, final_dist_m=dist,
              inside_box=inside, peak_stage1_viol_m=peak, jax=SOFT_JAX)
        soft_loop[name] = {"launches": c10[wrapper],
                           "soft_launches": c10[wrapper + ".soft"],
                           "ms_per_tick": ms}
        log("soft_closed_loop", case=name, N=60, ticks=LOOP_TICKS,
            iters=SAFE_ITERS, launches=c10[wrapper],
            soft_launches=c10[wrapper + ".soft"], ms_per_tick=ms,
            t_ux_first_m=float(tux[0]), final_dist_m=dist,
            inside_box=inside, peak_stage1_viol_m=peak,
            final_x=xs[-1, :3].tolist(), jax=SOFT_JAX,
            hard_tick_kkt_eq=float(dg_h.qp_kkt_eq))

    wall('10 soft loops')
    # phase 11: the batched "xla" tick (the Riccati IPM on the batch, eager
    # PyTorch, no kernel of ours), N=20, B=1024, 2 ticks
    pre_x = cfg.simulation_preset()
    ocp_x = dataclasses.replace(pre_x.ocp, N=20, Tf=pre_x.ocp.Tf / 3.0)
    spec_x = build_spec(ocp_x, yref=pre_x.loop.yref, device=dev)
    xstep = batched_rti_step(ocp_x, device=dev)
    (u0s, states, diag, xla_ms), _ = counted(
        {}, "batched xla tick",
        lambda: run_batched_ticks(xstep, spec_x, x0s, 2, ocp_x))
    check(bool(torch.isfinite(u0s).all() & torch.isfinite(states.xbar).all()
               & torch.isfinite(diag.qp_kkt_eq).all()), "batched xla finite")
    log("batched_xla_tick", N=20, B=BATCH, ticks=2,
        qp_backend=ocp_x.solver.qp_backend, ms_per_tick=xla_ms,
        solves_per_s=BATCH * 1000.0 / xla_ms,
        kkt_eq_max=diag.qp_kkt_eq.max().item())

    wall("11 batched xla tick")

    # phase 12: figure-8 tracking, "pallas_fused": the simulation preset at
    # N=60, 12 iterations, held to the golden; bench.py's fig8_rt6f
    from mpc_blaster_tpu_torch.sim.tasks import run_figure8
    base = cfg.simulation_preset().ocp.solver
    fig8 = {}
    for name, pre_8, n, iters in (
            ("golden_12it", simulation_ocp(60, solver=dataclasses.replace(
                base, qp_backend="pallas_fused", ipm_iters=FULL_ITERS)),
             FIG8_TICKS, FULL_ITERS),
            ("rt6f", simulation_ocp(20, solver=dataclasses.replace(
                base, qp_backend="pallas_fused", lin_backend="fused",
                ipm_iters=SAFE_ITERS)), RT6F_TICKS, SAFE_ITERS)):
        (res, ms), c12 = counted(
            {"fused_rti_solve": n}, f"figure-8 {name}",
            lambda: timed(lambda: run_figure8(pre_8, n_steps=n, device=dev),
                          n),
            instances={"fused_rti_solve[17x6 blaster]": n})
        xs, refs = res.xs.cpu().numpy(), res.refs.cpu().numpy()
        finite = bool(np.isfinite(xs).all())
        row = {"case": name, "N": pre_8.ocp.N, "ticks": n, "iters": iters,
               "launches": c12["fused_rti_solve"],
               "launches_per_tick": c12["fused_rti_solve"] / n,
               "ms_per_tick": ms}
        if name == "golden_12it":
            golden = np.load(GOLDEN_FIG8)["xs"][:xs.shape[0]]
            err = float(np.abs(xs[:, 0:3] - golden[:, 0:3]).max())
            row.update(golden_max_pos_err_m=err, bound_m=5e-2,
                       bench_r05_cold12_m=BENCH_R05[
                           "fig8_cold12_settle_err_m"])
            check(finite and err < 5e-2, "figure-8 vs golden",
                  max_pos_err_m=err)
        else:
            err = float(np.linalg.norm(xs[1:, 0:2] - refs[:, 0:2],
                                       axis=1)[60:].max())
            bound = FIG8_JAX["settle_err_m"] + 5e-2
            row.update(settle_err_m=err, bound_m=bound, jax=FIG8_JAX,
                       bench_r05_m=BENCH_R05["fig8_rt6f_settle_err_m"])
            check(finite and err <= bound, "fig8_rt6f vs the JAX run",
                  settle_err_m=err, bound_m=bound)
        fig8[name] = row
        log("figure8", **row)
    wall("12 figure-8")

    # phase 13: the offset-free loop, bench.py's configuration: one
    # fuse_lin "blaster_dist" launch per tick
    from mpc_blaster_tpu_torch.sim.scenarios import offset_free_loop
    pre_o = cfg.simulation_preset()
    ocp_o = dataclasses.replace(pre_o.ocp, N=30, Tf=1.0,
                                solver=dataclasses.replace(
                                    base, qp_backend="pallas_fused",
                                    ipm_iters=SAFE_ITERS))
    spec_o = build_spec(ocp_o, yref=pre_o.loop.yref, device=dev)
    x_o = torch.zeros(17, device=dev)
    x_o[2] = 3.0
    wind = (0.7, -0.5, 0.2)
    (res_o, of_ms), c13 = counted(
        {"fused_rti_solve": OF_TICKS}, "offset-free loop",
        lambda: timed(lambda: offset_free_loop(spec_o, ocp_o, x_o, wind,
                                               n_steps=OF_TICKS), OF_TICKS),
        instances={"fused_rti_solve[17x6 blaster_dist]": OF_TICKS})
    xs_o = res_o.xs.cpu().numpy()
    settle = float(np.linalg.norm(xs_o[-1, 0:3]
                                  - spec_o.yref_x[0, 0:3].cpu().numpy()))
    west = float(np.linalg.norm(res_o.d_hist[-1, 0:3].cpu().numpy()
                                - np.asarray(wind)))
    check(bool(np.isfinite(xs_o).all())
          and settle <= OFFSET_FREE_JAX["settle_err_m"] + 5e-2
          and west <= OFFSET_FREE_JAX["wind_est_err"] + 5e-2,
          "offset-free loop vs the JAX run", settle_err_m=settle,
          wind_est_err=west, jax=OFFSET_FREE_JAX)
    log("offset_free_loop", N=30, ticks=OF_TICKS, iters=SAFE_ITERS,
        launches=c13["fused_rti_solve"],
        launches_per_tick=c13["fused_rti_solve"] / OF_TICKS,
        ms_per_tick=of_ms, settle_err_m=settle, wind_est_err=west,
        jax=OFFSET_FREE_JAX,
        bench_r05_m=BENCH_R05["offsetfree_settle_err_m"],
        kkt_eq_max=res_o.kkt_eq.max().item())
    wall("13 offset-free loop")

    # phase 14: the quad13 hover chain on "pallas" (13x4 plain) and
    # "pallas_fused" (the quad13 prologue)
    from mpc_blaster_tpu_torch.models import quad13 as Q
    q13 = {}
    for backend, wrapper, inst in (("pallas", "box_qp_solve", "13x4"),
                                   ("pallas_fused", "fused_rti_solve",
                                    "13x4 quad13")):
        qstep = Q.make_quad13_rti_step(
            Q.Quad13Config(N=20), solver=dataclasses.replace(
                cfg.SolverConfig(), qp_backend=backend,
                ipm_iters=SAFE_ITERS), device=dev)
        ((xq, u_first), ms), c14 = counted(
            {wrapper: Q13_TICKS}, f"quad13 hover {backend}",
            lambda: timed(lambda: quad13_hover_loop(qstep, dev), Q13_TICKS),
            instances={f"{wrapper}[{inst}]": Q13_TICKS})
        xq = xq.cpu().numpy()
        hover = bool(np.isfinite(xq).all() and abs(xq[2] - 2.0) < 0.05
                     and abs(np.linalg.norm(xq[3:7]) - 1.0) < 1e-3
                     and np.abs(xq[7:10]).max() < 0.05)
        check(hover, "quad13 reaches the hover", backend=backend,
              final=xq.tolist())
        q13[backend] = {"launches": c14[wrapper],
                        "launches_per_tick": c14[wrapper] / Q13_TICKS,
                        "ms_per_tick": ms, "final_z": float(xq[2]),
                        "final_v_max": float(np.abs(xq[7:10]).max()),
                        "u0_first": u_first.cpu().numpy()}
    du0 = float(np.abs(q13["pallas"].pop("u0_first")
                       - q13["pallas_fused"].pop("u0_first")).max())
    check(du0 <= 5e-2, "quad13 backends agree on u0", u0_diff=du0)
    log("quad13_hover", N=20, ticks=Q13_TICKS, iters=SAFE_ITERS,
        u0_first_diff=du0, **q13)
    wall("14 quad13 hover")

    # phase 15: long horizons under "pallas"
    long_loop = {}
    for N in (120, 240):
        pre_l = simulation_ocp(N, solver=dataclasses.replace(
            base, qp_backend="pallas", ipm_iters=FULL_ITERS))
        (res_l, ms_l), c15 = counted(
            {"box_qp_solve": LONG_TICKS}, f"long horizon N={N}",
            lambda: timed_closed_loop(pre_l, LONG_TICKS, dev),
            instances={"box_qp_solve[17x6]": LONG_TICKS})
        xs_l = res_l.xs.cpu().numpy()
        err = float(np.abs(xs_l[::5, 0:3] - np.asarray(LONG_JAX[N])).max())
        check(bool(np.isfinite(xs_l).all()) and err < 5e-2,
              "long horizon vs the JAX run", N=N, max_pos_err_m=err)
        long_loop[N] = {"launches": c15["box_qp_solve"],
                        "ms_per_tick": ms_l, "max_pos_err_m": err}
        log("long_horizon_loop", N=N, ticks=LONG_TICKS, iters=FULL_ITERS,
            **long_loop[N])
    wall("15 long horizons")

    if FAILURES:
        for f in FAILURES:
            log("FAILED", **f)
        raise SystemExit(f"chip_smoke: {len(FAILURES)} check(s) failed")

    main_row = next(r for r in rows if r["case"] == "n60_b1")
    cost_main = next(r for r in cost_rows if r["case"] == "n20_b1024")
    lin_main = next(r for r in lin_rows if r["case"] == "n60_b1")
    lin_n20 = next(r for r in lin_rows if r["case"] == "n20_b1")  # rt6f
    warm_main = next(r for r in warm_rows if r["case"] == "fuse_lin_n60_b1")

    soft_main = next(r for r in soft_rows if r["case"] == "fuse_lin_n60_b1")

    def bound_keys(b):
        """The bound of the entry's timed launch (library_ms: no single
        PyTorch call solves a box-constrained OCP-QP)."""
        return {"bound_ms": b["bound_ms"], "bound_by": b["bound_by"],
                "library_ms": None, "flops": b["flops"], "bytes": b["bytes"]}

    q13_main = next(r for r in q13_rows if r["case"] == "q13_n20_b1")

    def kentry(name, launches, rs, main, iters, b, **extra):
        """An entry timed at `iters` IPM iterations (the main path's)."""
        sfx = "" if iters == FULL_ITERS else f"_{iters}it"
        return {"name": name, "route": "cuda", "source": KERNEL_SOURCE,
                "replaces": REPLACES[name], "launches": launches,
                "max_abs_err": max(r["max_abs_err_1it"] for r in rs),
                "ms": main["kernel_ms" + sfx],
                "plain_ms": main["plain_ms" + sfx], "iters": iters,
                **bound_keys(b),
                "by_shape": {r["case"]: [r["kernel_ms" + sfx],
                                         r["plain_ms" + sfx]] for r in rs},
                **extra}

    def entry(name, launches, rs, main, b, **extra):
        return {"name": name, "route": "cuda", "source": KERNEL_SOURCE,
                "replaces": REPLACES[name], "launches": launches,
                "max_abs_err": max(r["max_abs_err_1it"] for r in rs),
                "ms": main["kernel_ms"], "plain_ms": main["plain_ms"],
                **bound_keys(b),
                "by_shape": {r["case"]: [r["kernel_ms"], r["plain_ms"]]
                             for r in rs}, **extra}

    report = {"kernels": [
        entry("box_qp_ipm", c3["box_qp_solve"] + c4["box_qp_solve"], rows,
              main_row, launch_bound("plain", 60, 1, FULL_ITERS),
              max_obj_rel_err=max(r["obj_rel_err"] for r in rows)),
        entry("box_qp_ipm_fuse_cost", fused_launches, cost_rows, cost_main,
              launch_bound("fuse_cost", 20, BATCH, FULL_ITERS),
              ms_6it=cost_main["kernel_ms_6it"],
              plain_ms_6it=cost_main["plain_ms_6it"],
              tick_ms={str(k): v for k, v in fused_tick_ms.items()}),
        entry("box_qp_ipm_fuse_lin",
              lin_launches + sum(r["launches"] for r in fig8.values()),
              lin_rows, lin_main,
              launch_bound("fuse_lin", 60, 1, FULL_ITERS),
              ms_6it=lin_main["kernel_ms_6it"],
              plain_ms_6it=lin_main["plain_ms_6it"],
              launches_by_path={"fused_closed_loops": lin_launches,
                                **{f"figure8_{k}": r["launches"]
                                   for k, r in fig8.items()}},
              ms_n20_6it=lin_n20["kernel_ms_6it"],
              plain_ms_n20_6it=lin_n20["plain_ms_6it"],
              bound_ms_n20_6it=launch_bound("fuse_lin", 20, 1,
                                            SAFE_ITERS)["bound_ms"],
              prologue_max_abs_err=max(
                  max(r["prologue_max_abs_err"].values())
                  for r in lin_rows)),
        {"name": "box_qp_ipm_warm", "route": "cuda", "source": KERNEL_SOURCE,
         "replaces": REPLACES["box_qp_ipm_warm"], "launches": warm_launches,
         "max_abs_err": max(max(r["blend_max_abs_err"], r["max_abs_err_1it"])
                            for r in warm_rows),
         "blend_max_abs_err": max(r["blend_max_abs_err"] for r in warm_rows),
         "max_abs_err_1it_n60": warm_main["max_abs_err_1it"],
         "ms": warm_main["kernel_ms_3it"],
         "plain_ms": warm_main["plain_ms_3it"],
         **bound_keys(launch_bound("fuse_lin", 60, 1, FASTEST_ITERS,
                                  warm=True)),
         "cold_ms": warm_main["cold_kernel_ms_3it"],
         "by_shape": {r["case"]: [r["kernel_ms_3it"], r["plain_ms_3it"]]
                      for r in warm_rows},
         "altitude_overshoot_m": alt},
        {"name": "box_qp_ipm_soft", "route": "cuda", "source": KERNEL_SOURCE,
         "replaces": REPLACES["box_qp_ipm_soft"],
         "launches": sum(v["soft_launches"] for v in soft_loop.values()),
         "max_abs_err": max(r["max_abs_err_1it"] for r in soft_rows),
         "ms": soft_main["kernel_ms"], "plain_ms": soft_main["plain_ms"],
         **bound_keys(soft_main["bound"]),
         "hard_ms": soft_main["hard_kernel_ms"],
         "ms_12it": soft_main["kernel_ms_12it"],
         "all_hard_bit_exact": all(r["all_hard_bit_exact"]
                                   for r in soft_rows),
         "by_shape": {r["case"]: [r["kernel_ms"], r["plain_ms"],
                                  r["hard_kernel_ms"]] for r in soft_rows},
         "loop_ms_per_tick": {k: v["ms_per_tick"]
                              for k, v in soft_loop.items()}},
        kentry("box_qp_ipm_13x4", q13["pallas"]["launches"], q13_rows,
               q13_main, SAFE_ITERS,
               launch_bound("plain", 20, 1, SAFE_ITERS, nx=13, nu=4),
               loop_ms_per_tick=q13["pallas"]["ms_per_tick"]),
        kentry("box_qp_ipm_fuse_lin_quad13",
               q13["pallas_fused"]["launches"], fam_rows["quad13"],
               fam_rows["quad13"][-1], SAFE_ITERS,
               launch_bound("fuse_lin", 20, 1, SAFE_ITERS, nx=13, nu=4,
                            family="quad13"),
               prologue_max_abs_err=max(
                   max(r["prologue_max_abs_err"].values())
                   for r in fam_rows["quad13"]),
               loop_ms_per_tick=q13["pallas_fused"]["ms_per_tick"]),
        kentry("box_qp_ipm_fuse_lin_blaster_dist", c13["fused_rti_solve"],
               fam_rows["blaster_dist"], fam_rows["blaster_dist"][-1],
               SAFE_ITERS,
               launch_bound("fuse_lin", 30, 1, SAFE_ITERS,
                            family="blaster_dist"),
               prologue_max_abs_err=max(
                   max(r["prologue_max_abs_err"].values())
                   for r in fam_rows["blaster_dist"]),
               loop_ms_per_tick=of_ms),
        kentry("box_qp_ipm_long_horizon",
               sum(v["launches"] for v in long_loop.values()), long_rows,
               long_rows[1], FULL_ITERS,
               launch_bound("plain", 240, 1, FULL_ITERS),
               ms_n120=long_rows[0]["kernel_ms"],
               plain_ms_n120=long_rows[0]["plain_ms"],
               bound_ms_n120=launch_bound("plain", 120, 1,
                                          FULL_ITERS)["bound_ms"],
               ms_n240_b256=long_rows[2]["kernel_ms"],
               bound_ms_n240_b256=launch_bound("plain", 240, 256,
                                               FULL_ITERS)["bound_ms"],
               soft_n120=[long_soft["kernel_ms_12it"],
                          long_soft["plain_ms_12it"]],
               loop_ms_per_tick={str(k): v["ms_per_tick"]
                                 for k, v in long_loop.items()}),
    ]}
    wall("report")
    print(json.dumps(report), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
