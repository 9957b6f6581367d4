"""Smoke run of the PyTorch + CUDA port (`mpc_blaster_tpu_torch`) on one
NVIDIA GPU.

    python3 chip_smoke.py

Builds the box-QP IPM kernel (its plain, fuse_cost and fuse_lin modes,
each with the warm-start blend K3, the soft-bound instantiations K4 of
the plain and fuse_lin modes, the plain mode at 13x4 for the quad13 model
and the fuse_lin mode with the "quad13" and "blaster_dist" prologues) and
the hardware probes P1 and P2 from `mpc_blaster_tpu_torch/csrc/` with
nvcc (one nvcc per source, both started together), holds each mode,
cold, warm and soft, against its plain PyTorch twin on the card (phases
2, 2b and 2c, which also holds the long horizons N=120 and 240, kernel
K7's shapes), then drives the port's main paths, each with the launch
counts (the probes' included) set to 0 just before it and read just
after:

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
     "pallas", 12 iterations, 20 ticks from the ground (N chooses the
     kernel's layout, so the solver's streaming flags select nothing: the
     factor stacks are resident in shared memory at N=120 and stay in
     the global workspace at N=240);
 16. the one-launch tick over a batch (kernel K6 at B > 1): the fuse_lin
     kernel against its twin at N=20, B=64 with one spec per problem,
     timed at N=20, B=1024 beside the fuse_cost kernel (K5) on the same
     problems; then 10 chained ticks of the batched "xla" tick over
     `deployed_solver("safe")` (N=20, B=1024): one fuse_lin launch per
     tick, and one `torch.profiler` window of 3 ticks for the device's
     busy share;
 17. the scenario sweeps (`sim/scenarios.py`) on the simulation preset
     (N=60) under `deployed_solver("safe")`, swapped to "pallas" as the
     JAX package swaps it: `disturbance_sweep` on tests/test_scenarios.py's
     8 wind scenarios and `fault_sweep` on its 4 rotor deratings, 150
     ticks each, blind and offset-free, one plain launch per tick for the
     whole batch; then 20 ticks of the offset-free wind sweep at B=256,
     timed. This phase calls its entry points without `device=` and
     checks that their tensors are on the card (the port's default);
 18. the probes: P1, the largest dynamic shared memory one block can opt
     in to and read back (16 KB up to the card's ceiling, which it must
     reach; one more word must raise), and P2, the dependent FMA chains
     (rows 6 to 32 of 128 lanes, 1 or 4 independent chains per thread),
     held to the twin at 10^3 steps and timed at 10^6 (ns per dependent
     step, and 4 chains against 1);
 19. (a) the blast scan (`sim/tasks.py::run_blast_scan`), bench.py's
     eight rows: the simulation preset at N=60 on "pallas_fused" at 12
     iterations (one fuse_lin launch per tick, the online modes' per-stage
     parameters changing every tick), 300 ticks, the POC rows frozen at
     the canonical pose; the gentle profile as "frozen" with the linear
     and the exact plant POC and as "online_stagewise", the aggressive one
     as "frozen", "online", "online_stagewise", with carry_frac 0.6, and
     with both rules on "auto": each row's mean true-POC error from tick
     90, its ms per tick and its jet solves' host time, and one profiler
     window of 5 stagewise ticks; (b) bench.py's alt_overshoot_cold6_m
     ("pallas" with the fused linearizer, 6 iterations, N=20, 200 ticks
     from z=0.5) and fig8_cold12_settle_err_m (`run_figure8` at N=20, 12
     iterations, 220 ticks, on "pallas": the plain kernel stands in for
     the eager Riccati IPM of the bench's row); (c) Jacobian reuse:
     bench.py's rt4 and rt4jr4 loops (N=20, 4 iterations, 32 ticks),
     tests/test_sqp_sim.py's N=60 loop (60 ticks, A and B every 4th tick,
     against every tick) and its shifted warm reuse loop (N=10, 80 ticks,
     4 iterations, "primal": warm plain launches, K3) against the cold
     loop, all on "pallas", and `sqp_solve` at hover (N=60, 12
     iterations).

Each phase's wall seconds and the running total are printed ("wall"
lines). Phase 1 also prints each IPM instantiation's launch plan at N=20,
30, 60, 120 and 240 (13x4: N=20): the layout, threads, dynamic shared
bytes (a soft instantiation's soft area in shared memory or the
workspace), the compiled kernel's registers and local bytes, ptxas's
registers, stack frame and spill bytes, blocks per SM and
the waves of a launch at B=1, 256 and 1024 on the card's SMs. Every IPM
launch of phases 2-17 is held to its layout: resident (the Riccati
factor stacks in shared memory) at every N <= 120, global at phase 2c's
and phase 15's N=240 (the wrappers' `by_layout` counts).

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
    95% of the problems. The plain mode at the sweeps' shape (N=60,
    B=256) is also held at the deployed 6 iterations, there under the
    fused modes' batch rule and without the kkt_eq cap;
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
    (dx0 pushed 2.2 past the x box, soft position bounds Zl=1e3, zl=1e2,
    or at N=60 also every state soft, phase 10's rows, the "_all" cases):
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
  - the one-launch tick over a batch: the fuse_lin mode's rules above at
    B=64 and at the timed B=1024 (one iteration pointwise; the full
    budgets on the objective, kkt_eq and the step norms and box
    violation, the batch rule);
  - the sweeps: the criteria of tests/test_scenarios.py (the wind sweep's
    max error < 0.6 m and mean < 0.3 m; offset-free every scenario
    settled and max < 0.02 m; the blind controller's single-rotor fault >
    1.0 m; every fault recovered within 0.02 m), and every scenario's
    error within 5e-2 m of the JAX package's own float32 run of the same
    sweep (its Riccati IPM at the same 6 iterations: SWEEP_JAX), on both
    sides (a plant that dropped the wind would end too close), but
    for the one scenario that run leaves more than 1 m off (the blind
    single-rotor fault, which diverges): where a diverging loop stands
    after 150 ticks is set by f32 rounding, so it is held to the JAX
    test's > 1.0 m alone. The JAX test's worst kkt_eq < 1e-3 belongs to
    its float64 12-iteration run: the JAX package's float32 6-iteration
    sweeps reach 0.51-1.19 (SWEEP_JAX), so it is logged beside them, not
    held;
  - the probes: P1 reads back 3x at every size, exactly; P2 within 1e-5
    relative of its twin after 1, 3, 17 and 10^3 steps (the kernel fuses
    each multiply-add, the twin rounds twice; the recurrence contracts,
    so only the short counts show a wrong step count or a dropped y).
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
    of itself started 1e-6 away, on batches of at least 64; on smaller
    ones (N=8, and N=10 B=1, phase 19's warm reuse loop) at the full
    budget only (compare_warm).
  - the fuse_lin mode with per-stage parameters (phase 2's
    "n60_b1_stagewise": each stage's POC rows linearized at its own node
    of the iterate, as the online_stagewise ticks give them): the fuse_lin
    rules above;
  - the blast rows: finite, 300 launches each, the mean true-POC error
    within max(5e-3 m, 0.1 x the JAX package's own float32 run of the row
    on its Riccati IPM at 12 iterations: BLAST_JAX) on both sides (the
    port's f32 kernel and the JAX f32 Riccati IPM solve the same QPs; on
    the CPU the JAX runs land within 3.5e-3 m of the bench's TPU rows);
    with the exact plant and frozen POC rows the true impact point equals
    the belief x[14:17] within 5e-5 m (the analogue of
    tests/test_tasks.py:118-120's float64 1e-6: TRUTH_BELIEF_M);
  - cold6 and cold12: within 5e-3 m of the JAX package's own float32
    runs on its Riccati IPM (ALT_COLD6_JAX, FIG8_COLD12_JAX), both sides;
  - Jacobian reuse and the SQP: tests/test_sqp_sim.py's criteria (the
    N=60 reuse loop's final z within 0.1 m of the full loop's and its
    Euler angles below 0.2; the warm reuse loop settles within 0.05 m of
    z=3.5 and within 0.02 m of the cold loop; `sqp_solve`'s last step
    norm below 1, the hover thrusts within 2e-3 relative, the swivel
    rates inside their box (+1e-6 for f32), the gimbal below 0.02 and z
    within 2e-2 of 2 on every node).
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
GOLDEN = REPO / "tests" / "golden" / "simulation_poc_100.npz"
GOLDEN_FIG8 = REPO / "tests" / "golden" / "figure8_120.npz"
KERNEL_SOURCE = "mpc_blaster_tpu_torch/csrc/box_qp_ipm.cu"
PROBE_SOURCE = "mpc_blaster_tpu_torch/csrc/probes.cu"
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
            "box_qp_ipm_long_horizon": "mpc_blaster_tpu/ops/pallas_ipm.py:293",
            "box_qp_ipm_fuse_lin_batched":
                "mpc_blaster_tpu/ops/pallas_ipm.py:1163",
            "probe_smem_capacity": "scripts/probe_vmem_ceiling.py:32",
            "probe_fma_chain": "scripts/probe_r5_sublane.py:85"}
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
             "offsetfree_settle_err_m": 0.0053,
             "alt_overshoot_cold6_m": 0.0187,
             "blast_true_poc_err_ref_m": 0.1486,
             "blast_true_poc_err_anchored_m": 0.005,
             "blast_true_poc_err_stagewise_m": 0.0081,
             "blast_aggr_err_frozen_m": 0.2881,
             "blast_aggr_err_online_m": 0.1601,
             "blast_aggr_err_stagewise_m": 0.1386,
             "blast_aggr_err_carry_m": 0.0236,
             "blast_aggr_err_auto_m": 0.0236}
LONG_TICKS = 20      # phase 15's ticks from the ground
FIG8_TICKS = 120     # the figure-8 golden's length
RT6F_TICKS = 220     # bench.py's fig8 rows
OF_TICKS = 250       # bench.py's offset-free row
Q13_TICKS = 60       # tests/test_quad13.py's hover test
SWEEP_TICKS = 150    # tests/test_scenarios.py's sweeps
SWEEP_B = 256        # phase 17's timed sweep batch
SWEEP_TIMED_TICKS = 20
# The JAX package's own float32 sweeps of phase 17 on the CPU (the
# simulation preset at N=60 under deployed_solver("safe") with
# qp_backend="riccati", 6 iterations, 150 ticks; tests/test_scenarios.py's
# scenarios): per-scenario position errors in m and the worst QP kkt_eq,
# recomputed by tests/test_torch_sweep_bounds.py.
SWEEP_JAX = {
    "wind_blind": {"pos_err_m": [0.3327, 0.2936, 0.2225, 0.0939, 0.4062,
                                 0.3075, 0.0708, 0.0049],
                   "worst_kkt_eq": 0.5066},
    "wind_offset_free": {"pos_err_m": [0.0034, 0.0002, 0.0001, 0.0001,
                                       0.0003, 0.0019, 0.0001, 0.0],
                         "worst_kkt_eq": 0.5735},
    "fault_blind": {"pos_err_m": [0.0, 0.0676, 2.593, 0.0239],
                    "worst_kkt_eq": 1.1862},
    "fault_offset_free": {"pos_err_m": [0.0, 0.0, 0.0, 0.0],
                          "worst_kkt_eq": 0.0}}
# Phase 19a: bench.py's blast-scan rows (:640-700): the simulation preset
# at N=60, 300 ticks, the POC rows frozen at the reference's canonical
# pose; per row its scan profile, poc_mode, plant_poc and the scan's other
# arguments. The metric is the mean true-POC error from tick 90 on.
BLAST_TICKS = 300
BLAST_SETTLE = 90
BLAST_PROFILES = {"gentle": dict(z_end=1.5, t_ramp_s=6.0),
                  "aggressive": dict(z_end=1.2, t_ramp_s=4.0, amp_x=1.1,
                                     amp_y=0.45, period_s=24.0)}
BLAST_ROWS = {
    "blast_true_poc_err_ref_m": ("gentle", "frozen", "linear", {}),
    "blast_true_poc_err_anchored_m": ("gentle", "frozen", "exact", {}),
    "blast_true_poc_err_stagewise_m": ("gentle", "online_stagewise",
                                       "exact", {}),
    "blast_aggr_err_frozen_m": ("aggressive", "frozen", "exact", {}),
    "blast_aggr_err_online_m": ("aggressive", "online", "exact", {}),
    "blast_aggr_err_stagewise_m": ("aggressive", "online_stagewise",
                                   "exact", {}),
    "blast_aggr_err_carry_m": ("aggressive", "online_stagewise", "exact",
                               {"carry_frac": 0.6}),
    "blast_aggr_err_auto_m": ("aggressive", "auto", "exact",
                              {"carry_frac": "auto"})}
# The JAX package's own float32 runs of phase 19's rows on the CPU, each
# recomputed by a test: the blast rows on its Riccati IPM at 12 iterations
# (tests/test_torch_blast_bounds*.py), bench.py's alt_overshoot_cold6_m on
# its Riccati IPM at 6 iterations with the fused linearizer and its
# fig8_cold12_settle_err_m on its Riccati IPM at 12 iterations
# (tests/test_torch_step1_bounds.py). Each is held on both sides.
BLAST_JAX = {"blast_true_poc_err_ref_m": 0.1485,
             "blast_true_poc_err_anchored_m": 0.005,
             "blast_true_poc_err_stagewise_m": 0.0081,
             "blast_aggr_err_frozen_m": 0.2874,
             "blast_aggr_err_online_m": 0.1605,
             "blast_aggr_err_stagewise_m": 0.1421,
             "blast_aggr_err_carry_m": 0.0228,
             "blast_aggr_err_auto_m": 0.0228}
# With the exact plant the belief x[14:17] is the impact point the plant
# solved in float32 on every state after the first; the first holds the
# float64 solve that run_blast_scan starts from. The truth is the float32
# solve vmapped over the trajectory. A float32 solve moves its impact
# point by the jet's rounding: 1 - exp(-c T) at c T ~ 0.02 carries ~6e-8
# of absolute error, which the exit speed over the drag (150 m/s) turns
# into ~9e-6 m per ulp of exp. So the float32 truth leaves the first
# state's z 4.3e-6 m off the float64 belief, and on the later states the
# vmapped solve (batched matrix products) parts from the unbatched one
# the plant ran by such steps (8.8e-6 m in 20 ticks of the aggressive
# scan), while the unbatched solve recomputed is the belief bit for bit
# (all three on the CPU). The largest gap seen on an H100 was 2.6e-5 m
# (NVIDIA H100 80GB HBM3, 700 W); the limit is twice that.
TRUTH_BELIEF_M = 5e-5
ALT_COLD6_JAX = 0.0186
FIG8_COLD12_JAX = 0.0388
STEP1_BOUND_M = 5e-3
ALT_COLD6_TICKS = ALT_TICKS
FIG8_COLD12_TICKS = RT6F_TICKS
RT_TICKS = 32        # bench.py's deployed latency rows (rt4, rt4jr4)
JR_TICKS = 60        # tests/test_sqp_sim.py:207-241's reuse loop
WARM_JR_TICKS = 80   # tests/test_sqp_sim.py:264-290's warm reuse loop
P19_N20_ITERS = (4, SAFE_ITERS, FULL_ITERS)  # phase 19's K1 budgets at N=20
# tests/test_scenarios.py:57-62's rotor deratings
FAULT_DERATE = ((1.0, 1.0, 1.0, 1.0), (0.8, 0.8, 0.8, 0.8),
                (0.7, 1.0, 1.0, 1.0), (0.85, 0.85, 1.0, 1.0))
CHAIN_STEPS = 10 ** 6   # P2's dependent steps (scripts/probe_r5_sublane.py)
CHAIN_CHECK_STEPS = 10 ** 3
# Short step counts where the result still depends on y and on the count
# (the recurrence contracts by x <= 0.6 a step: after ~40 steps every
# element is x / (1 - x) to float32 rounding, whatever y and the count)
CHAIN_SHORT_STEPS = (1, 3, 17)
CHAIN_ROWS = (6, 8, 16, 17, 24, 32)


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
PROBES = ("smem_capacity", "fma_chain")
PROBE_WRAPPERS: dict = {}    # the probes' wrappers (no main path runs them)


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
    out.update({w: fn.launches for w, fn in PROBE_WRAPPERS.items()})
    return out


def reset_counts():
    for fn in KERNEL_WRAPPERS.values():
        fn.launches = 0
        fn.warm_launches = 0
        fn.by_instance = {}
        fn.by_layout = {}
    for fn in PROBE_WRAPPERS.values():
        fn.launches = 0


def layout_counts() -> dict:
    """The IPM launches per layout ("resident", "global") over every
    wrapper, the non-zero ones."""
    out: dict = {}
    for fn in KERNEL_WRAPPERS.values():
        for k, v in fn.by_layout.items():
            if v:
                out[k] = out.get(k, 0) + v
    return out


def layouts_only(what: str, layout: str, fn):
    """Run fn with the layout counts at 0 and check that every IPM launch
    in it took `layout` (the factor stacks resident in shared memory at
    N <= 120, in the global workspace at N=240)."""
    for w in KERNEL_WRAPPERS.values():
        w.by_layout = {}
    out = fn()
    got = layout_counts()
    check(set(got) == {layout}, f"{what} layout", got=got, want=layout)
    return out


def ptxas_usage(build_log: str) -> dict:
    """Per entry function of an nvcc -Xptxas -v log: registers, stack frame,
    spill stores and spill loads (bytes). A device function's properties
    (the FUSE_LIN prologue, compiled out of line) are not an entry's."""
    out, entry, props = {}, None, None
    for ln in build_log.splitlines():
        if m := re.search(r"Compiling entry function '(\w+)'", ln):
            entry = m[1]
            out.setdefault(entry, {})
        elif m := re.search(r"Function properties for (\w+)", ln):
            props = m[1]
        elif m := re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                            r"stores, (\d+) bytes spill loads", ln):
            if props in out:
                out[props].update(stack=int(m[1]), spill_stores=int(m[2]),
                                  spill_loads=int(m[3]))
        elif (m := re.search(r"Used (\d+) registers", ln)) and entry:
            out[entry]["registers"] = int(m[1])
    return out


def ipm_ptxas_usage(build_log: str) -> dict:
    """ptxas_usage of the IPM library's kernels by instantiation: (mode,
    soft, nx, nu, family) as in `BUILT` -> registers, stack and spills."""
    from mpc_blaster_tpu_torch.ops import box_qp_ipm as K
    fams = {v: k for k, v in K.FAMILY_IDS.items()}
    out = {}
    for name, use in ptxas_usage(build_log).items():
        m = re.search(r"box_qp_ipm_kernelILi(\d)ELb(\d)ELi(\d+)ELi(\d+)"
                      r"ELi(\d)E", name)
        if m:
            mode, soft, nx, nu, fam = (int(g) for g in m.groups())
            out[(mode, bool(soft), nx, nu,
                 fams[fam] if mode == K.FUSE_LIN else None)] = use
    return out


def launch_keys(K, N, mode, nx=17, nu=6, family=None, soft=False) -> dict:
    """A report entry's launch: the plan's layout, threads and dynamic
    shared bytes; the compiled kernel's registers and blocks per SM."""
    info = K.kernel_info(N, mode, nx, nu, family, soft)
    return {k: info[k] for k in ("layout", "threads", "smem_bytes",
                                 "blocks_per_sm", "registers")}


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


def compare_kernel(name, qp, K, time_iters=(FULL_ITERS,),
                   check_iters=(1, FULL_ITERS)):
    """Plain-mode kernel vs plain twin on one QP batch, at each of
    `check_iters`: one iteration pointwise, FULL_ITERS on the objective
    of every problem and kkt_eq, a smaller budget under the batch rule of
    `fused_checks`; the report row (times at FULL_ITERS as kernel_ms /
    plain_ms, at other `time_iters` with an "_<n>it" suffix)."""
    row = {"case": name, "B": qp.A.shape[0], "N": qp.A.shape[1],
           "nx": qp.A.shape[-1], "nu": qp.B.shape[-1]}
    for iters in check_iters:
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
        full = iters == FULL_ITERS
        sfx = "" if full else f"_{iters}it"
        objective_check(name, qp, sk.dx, sk.du, sp.dx, sp.du, row,
                        "obj_rel_err" + sfx, batch_rule=not full)
        kkt_eq_checks(name, sk.kkt_eq, sp.kkt_eq, row, sfx,
                      cap=5e-2 if full else None)
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


def fused_case(N: int, B: int, dev, seed: int, family: str = "blaster",
               stagewise: bool = False):
    """A perturbed hover iterate at N, B with the fused modes' spec
    arguments (shared rows broadcast over the batch) and the plain
    linearization of it: (ocp, stage params, xbar, ubar, x0, args, lin).
    The perturbation keeps the iterate inside the boxes, as the main
    path's iterates are: states +-0.02 around x0 (every node its own
    linearization point), rotor thrusts +-0.5 N around hover. The
    "blaster_dist" family's stage parameters carry DIST_ROWS in rows
    25-30. With `stagewise` each stage's POC rows are linearized at its
    own node of the iterate, as the blast scan's online_stagewise ticks
    give them (B=1)."""
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
    if stagewise:
        from mpc_blaster_tpu_torch import config as cfg
        from mpc_blaster_tpu_torch.poc.solver import poc_stage_params_along
        sp = poc_stage_params_along(xbar[0, :-1], sp[0, -1],
                                    cfg.PocSolverConfig())
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


def compare_fuse_lin(name, N, dev, K, family="blaster", stagewise=False):
    """fuse_lin kernel with the family's prologue vs
    `fused_rti_solve_plain` (and its prologue vs `fast_linearize` of the
    family), with the stage parameters of `fused_case`; the report row."""
    from mpc_blaster_tpu_torch.sqp.rti import fused_dyn_statics
    if family == "quad13":
        statics, sp, xbar, ubar, x0, args, (A, Bm, c) = quad13_fused_case(
            N, 1, dev, N + 2)
    else:
        ocp, sp, xbar, ubar, x0, args, (A, Bm, c) = fused_case(
            N, 1, dev, N + 2, family, stagewise)
        statics = fused_dyn_statics(ocp, family=family)
    model, dt, ns = statics
    kw = dict(model=model, dt=dt, num_steps=ns)
    qp = K._fused_qp(K._fused_prep(xbar, ubar, x0, *args, None), A, Bm, c)
    row = {"case": name, "B": 1, "N": N, "family": family}
    if stagewise:   # how far apart neighbouring stages' rows are
        row["stage_params_min_step"] = (
            sp[0, 1:] - sp[0, :-1]).abs().amax(-1).min().item()
        check(row["stage_params_min_step"] > 1e-4, "every stage its own "
              "row", case=name, min_step=row["stage_params_min_step"])
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
    row. At B=1 (every fuse_lin row) the clean, poisoned and invalid
    problems run as three launches.

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
    least 64; reported for the others). On smaller batches (N=8, and N=10,
    phase 19's warm reuse loop) every clean problem is held to the cold
    tolerances at FULL_ITERS, and the twin also runs on the host's CPU:
    its distance from the card's twin (float32 rounding alone) is
    reported beside the kernel's."""
    ocp, inp, warm, masks = warm_case(N, max(B, 3), dev, seed=N + B)
    if B == 1:
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
        # on small batches, the same twin on the host's CPU too: how far
        # float32 rounding alone moves the warm solve (reported)
        host = None
        if not strict and 0 < sel.numel() < 64:
            cpu = torch.device("cpu")
            inp_h = {k: (tuple(a.to(cpu) for a in v) if isinstance(v, tuple)
                         else v.to(cpu)) for k, v in inp_p.items()}
            host = (warm_runners(mode, ocp, inp_h, K)[1],
                    type(w)(*(t.to(cpu) for t in w)))
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
            if host is not None:
                h = host[0](iters, host[1])
                h = type(h)(*(t.to(p_.du.device) if torch.is_tensor(t)
                              else t for t in h))
                row[f"twin_cpu_within_frac_{iters}it"] = warm_gaps(
                    h, p_, qp, sel, iters).float().mean().item()
                row[f"du_gap_{iters}it"] = (
                    a.du - p_.du)[sel].abs().max().item()
                row[f"twin_cpu_du_gap_{iters}it"] = (
                    h.du - p_.du)[sel].abs().max().item()
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
            elif iters == FULL_ITERS:
                check(kt == 1.0, "warm parity at the full budget",
                      case=name, iters=iters)
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


def compare_soft(name, mode, N, B, dev, K, spread_rule=False,
                 idx=(0, 1, 2)):
    """Soft-bound kernel (K4, in one mode) vs its plain twin, and its
    all-hard case vs the hard kernel; the report row. `idx`: the soft
    states (soft_specs; None: every state).

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
    soft, hard = soft_specs(N, dev, idx=idx)
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


def batched_fused_case(N: int, B: int, dev, seed: int):
    """`fused_case` with one spec per problem: every problem's altitude
    target (yref z, +-0.5 m) and T_blast (+-2%) differ, so each
    per-problem row of a launch is its own: (ocp, stage params, xbar,
    ubar, x0, args, lin)."""
    from mpc_blaster_tpu_torch.dynamics.blaster import BlasterParams
    from mpc_blaster_tpu_torch.dynamics.fastlin import fast_linearize
    ocp, sp, xbar, ubar, x0, args, _ = fused_case(N, B, dev, seed)
    rng = np.random.default_rng(seed + 1)

    def draw(lo, hi):
        return torch.as_tensor(rng.uniform(lo, hi, B), dtype=torch.float32,
                               device=dev)
    Qs, Qt, R, yrx, yru, yre, lbx, ubx, lbu, ubu = args
    dz = draw(-0.5, 0.5)
    yrx = yrx.clone()
    yrx[:, :, 2] += dz[:, None]
    yre = yre.clone()
    yre[:, 2] += dz
    sp = sp.clone()
    sp[:, :, 24] *= 1.0 + draw(-0.02, 0.02)[:, None]
    P = BlasterParams.from_config(ocp.model, device=dev)
    xp, A, Bm = fast_linearize(xbar, ubar, sp, P, ocp.dt)
    return ocp, sp, xbar, ubar, x0, (Qs, Qt, R, yrx, yru, yre, lbx, ubx,
                                     lbu, ubu), (A, Bm, xp - xbar[:, 1:])


def compare_fuse_lin_batched(name, N, B, dev, K, seed, time_iters=()):
    """The fuse_lin kernel over a batch of B problems, one spec each, vs
    `fused_rti_solve_plain`: one iteration pointwise, the full budgets on
    the objective, kkt_eq and feasibility (step norms, box violation of
    the new iterate) under the batch rule of `fused_checks`. At each of
    `time_iters` the kernel, its twin and fuse_cost (K5) on the same
    problems with the host's linearization are timed on the card. The
    report row."""
    from mpc_blaster_tpu_torch.sqp.rti import fused_dyn_statics
    ocp, sp, xbar, ubar, x0, args, (A, Bm, c) = batched_fused_case(
        N, B, dev, seed)
    model, dt, ns = fused_dyn_statics(ocp)
    kw = dict(model=model, dt=dt, num_steps=ns)
    f = K._fused_prep(xbar, ubar, x0, *args, None)
    qp = K._fused_qp(f, A, Bm, c)
    row = {"case": name, "B": B, "N": N}
    for iters in (1, SAFE_ITERS, FULL_ITERS):
        n0 = K.fused_rti_solve.launches
        sk = K.fused_rti_solve(xbar, ubar, sp, x0, *args, iters=iters, **kw)
        torch.cuda.synchronize()
        check(K.fused_rti_solve.launches == n0 + 1, "kernel launched",
              case=name)
        spl = K.fused_rti_solve_plain(xbar, ubar, sp, x0, *args,
                                      iters=iters, **kw)
        xk, uk, dk = K._tick_diag(f, sk)
        xp, up, dp = K._tick_diag(f, spl)
        fused_checks(name, K, qp, (xk, uk), (xp, up), (xbar, ubar), iters,
                     row, dk, dp)
    AB = torch.cat([A, Bm], -1)
    for it in time_iters:
        sfx = "" if it == FULL_ITERS else f"_{it}it"
        row["kernel_ms" + sfx] = cuda_ms(lambda: K.fused_rti_solve(
            xbar, ubar, sp, x0, *args, iters=it, **kw), reps=10)
        row["plain_ms" + sfx] = cuda_ms(lambda: K.fused_rti_solve_plain(
            xbar, ubar, sp, x0, *args, iters=it, **kw), reps=1)
        row["fuse_cost_ms" + sfx] = cuda_ms(lambda: K.batched_fused_tick(
            AB, c, xbar, ubar, x0, *args, iters=it), reps=10)
        row["bound_ms" + sfx] = launch_bound("fuse_lin", N, B,
                                             it)["bound_ms"]
    return row


def device_busy(fn) -> dict:
    """One `torch.profiler` window around fn(): the device's kernel time
    (the device events' time, summed as the profiler's own table sums
    it), the window's wall time (host clock, synchronised) and their
    ratio, the busy share (None where the profiler recorded no device
    time); the host's aten ops (nested calls counted too) and kernel
    launches in the window."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    dev_us = sum(e.self_device_time_total for e in events
                 if e.device_type == DeviceType.CUDA
                 and not getattr(e, "is_user_annotation", False))
    return {"device_ms": dev_us / 1e3, "wall_ms": wall_ms,
            "busy_share": dev_us / 1e3 / wall_ms if dev_us > 0 else None,
            "aten_ops": sum(e.count for e in events
                            if e.key.startswith("aten::")),
            "kernel_launches": sum(e.count for e in events
                                   if e.key == "cudaLaunchKernel")}


def blast_settle_err(true_pocs: np.ndarray, refs: np.ndarray) -> float:
    """A blast row's metric (bench.py's): the mean xy distance, from tick
    BLAST_SETTLE on, between the true impact point after each tick and
    that tick's POC reference."""
    err = np.linalg.norm(true_pocs[1:, 0:2] - refs[:, 14:16], axis=1)
    return float(err[BLAST_SETTLE:].mean())


def blast_bound(row: str) -> float:
    """How far a blast row may sit from the JAX run, on either side."""
    return max(5e-3, 0.1 * BLAST_JAX[row])


@contextlib.contextmanager
def jet_timer():
    """Host seconds and calls of the blast scan's jet solves: wraps the
    POC functions of the tracking loop and of its shared online rules
    (each looked up per call) in a host clock."""
    from mpc_blaster_tpu_torch.sim import closedloop as CL
    from mpc_blaster_tpu_torch.sim import tasks as TK
    orig = {(m, n): getattr(m, n) for m, names in (
        (CL, ("poc_stage_params", "poc_stage_params_along")),
        (TK, ("poc_value_and_jacobians", "solve_poc"))) for n in names}
    acc = {"s": 0.0, "calls": 0}

    def wrap(fn):
        def timed_fn(*a, **kw):
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            acc["s"] += time.perf_counter() - t0
            acc["calls"] += 1
            return out
        return timed_fn
    for (m, n), fn in orig.items():
        setattr(m, n, wrap(fn))
    try:
        yield acc
    finally:
        for (m, n), fn in orig.items():
            setattr(m, n, fn)


def chain_case(rows: int, nchains: int, dev, seed: int):
    """P2's inputs: x in U[0.4, 0.6] and y as (nchains, E) chains, the
    row groups of one (rows, 128) tile (`_chain_kernel`) where rows
    split, else nchains separate tiles (`_sep_ref_kernel`); and the
    layout's name."""
    from mpc_blaster_tpu_torch.ops import probes as P
    rng = np.random.default_rng(seed)
    split = rows % nchains == 0
    shape = (rows, P.LANES) if split else (nchains, rows, P.LANES)

    def draw():
        t = torch.as_tensor(rng.uniform(0.4, 0.6, shape), dtype=torch.float32,
                            device=dev)
        return P.chain_tiles(t, nchains) if split else P.sep_tiles(t)
    return draw(), draw(), "row_groups" if split else "separate_tiles"


def probe_phase(dev) -> dict:
    """P1 and P2 on the card against their plain twins; their report
    rows."""
    from mpc_blaster_tpu_torch.ops import probes as P
    # P1: opt-in shared memory, 16 KB up to the card's ceiling
    optin = P.smem_optin_max(dev)
    x = torch.tensor([1.25], dtype=torch.float32, device=dev)
    sizes = sorted({kb * 1024 for kb in (16, 32, 48, 64, 96, 128, 160, 192,
                                         224)} | {optin})
    passed, err = [], 0.0
    for nb in (s for s in sizes if s <= optin):
        got = P.smem_capacity(x, nb).item()
        want = P.smem_capacity_plain(x, nb).item()
        err = max(err, abs(got - want))
        check(got == want == 3.75, "smem probe reads back", bytes=nb,
              got=got, plain=want)
        if got == want == 3.75:
            passed.append(nb)
    try:
        P.smem_capacity(x, optin + 4)
        refused = False
    except RuntimeError:
        refused = True
    torch.cuda.synchronize()
    check(refused, "smem probe above the ceiling raises", bytes=optin + 4)
    largest = max(passed) if passed else 0
    check(largest == optin, "smem probe reaches the ceiling",
          largest=largest, optin=optin)
    p1 = {"optin_bytes": optin, "largest_bytes": largest,
          "sizes_passed": passed, "above_ceiling_refused": refused,
          "max_abs_err": err,
          "ms": cuda_ms(lambda: P.smem_capacity(x, optin), reps=10),
          "plain_ms": cuda_ms(lambda: P.smem_capacity_plain(x, optin),
                              reps=10)}
    # P2: the dependent FMA chains, held to the twin at short step counts
    # (where a wrong count or a dropped y shows) and at 10^3 steps, timed
    # at 10^6
    p2 = {"ns_per_step": {}, "rel_err": {}, "layout": {}}
    for rows in CHAIN_ROWS:
        for nc in (1, 4):
            key = f"rows{rows}_chains{nc}"
            cx, cy, layout = chain_case(rows, nc, dev, rows * 10 + nc)
            rel = 0.0
            for steps in CHAIN_SHORT_STEPS + (CHAIN_CHECK_STEPS,):
                got = P.fma_chain(cx, cy, steps)
                want = P.fma_chain_plain(cx, cy, steps)
                r = ((got - want).abs() / want.abs()).max().item()
                check(bool(torch.isfinite(got).all()) and r <= 1e-5,
                      "fma chain vs plain", case=key, steps=steps,
                      rel_err=r)
                rel = max(rel, r)
            P.fma_chain(cx, cy, CHAIN_STEPS)          # warm the clocks
            ms = cuda_ms(lambda: P.fma_chain(cx, cy, CHAIN_STEPS), reps=3)
            p2["ns_per_step"][key] = ms * 1e6 / CHAIN_STEPS
            p2["rel_err"][key] = rel
            p2["layout"][key] = layout
            if (rows, nc) == (24, 4):
                p2["max_abs_err"] = (got - want).abs().max().item()
                p2["ms"] = cuda_ms(lambda: P.fma_chain(
                    cx, cy, CHAIN_CHECK_STEPS), reps=10)
                p2["plain_ms"] = cuda_ms(lambda: P.fma_chain_plain(
                    cx, cy, CHAIN_CHECK_STEPS), reps=1)
                p2["elements"] = cx.numel()
    ns = p2["ns_per_step"]
    p2["chains4_over_chains1"] = {
        f"rows{r}": ns[f"rows{r}_chains4"] / ns[f"rows{r}_chains1"]
        for r in CHAIN_ROWS}
    return {"p1": p1, "p2": p2}


def chain_bound(elements: int, steps: int) -> dict:
    """P2's least time: one FMA (2 FLOPs) per element and step at the
    card's float32 rate, or its bytes (x, y read, the result written)."""
    t_ops = 2.0 * elements * steps / PEAK_FLOPS * 1e3
    t_bytes = 3 * 4 * elements / PEAK_BYTES * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def phase19(dev, counted, base) -> dict:
    """Phase 19, each path with the counts at 0 (`counted`): (a) bench.py's
    eight blast-scan rows on "pallas_fused" at 12 iterations (one K6
    launch per tick, the per-stage parameters of the online modes
    changing every tick), each against the JAX run and its bound, with
    the jet solves' host time and one profiler window; (b) bench.py's
    alt_overshoot_cold6_m (K1, the fused linearizer) and
    fig8_cold12_settle_err_m (K1 standing in for the eager Riccati IPM);
    (c) Jacobian reuse: bench.py's rt4 / rt4jr4 loops, the N=60 reuse loop
    and the shifted warm reuse loop (K1 and K3 in PLAIN) of
    tests/test_sqp_sim.py, and `sqp_solve` at hover. Returns the logged
    rows and the launches per path."""
    from mpc_blaster_tpu_torch.dynamics.blaster import (BlasterParams,
                                                        blaster_ode)
    from mpc_blaster_tpu_torch.dynamics.integrators import discrete_dynamics
    from mpc_blaster_tpu_torch.ocp.spec import build_spec
    from mpc_blaster_tpu_torch.poc.solver import solve_poc, true_poc_traj
    from mpc_blaster_tpu_torch.sim import tasks as TK
    from mpc_blaster_tpu_torch.sim.closedloop import make_closed_loop
    from mpc_blaster_tpu_torch.sqp import rti as R
    out = {"blast": {}, "k1": {}, "k3": {}}

    def finite(*ts):
        return all(bool(torch.isfinite(t).all()) for t in ts)

    # 19a: the blast scan
    pre_b = simulation_ocp(60, solver=dataclasses.replace(
        base, qp_backend="pallas_fused", ipm_iters=FULL_ITERS))
    N = pre_b.ocp.N

    def scan(row, n):
        prof, mode, plant, extra = BLAST_ROWS[row]
        return TK.run_blast_scan(pre_b, n_steps=n, poc_mode=mode,
                                 plant_poc=plant, frozen_at="canonical",
                                 device=dev, **BLAST_PROFILES[prof], **extra)
    for row, (prof, mode, plant, extra) in BLAST_ROWS.items():
        with jet_timer() as jt:
            (res, ms), c = counted(
                {"fused_rti_solve": BLAST_TICKS}, f"blast {row}",
                lambda: timed(lambda: scan(row, BLAST_TICKS), BLAST_TICKS),
                instances={"fused_rti_solve[17x6 blaster]": BLAST_TICKS})
        xs = res.xs.cpu().numpy()
        refs = res.refs.cpu().numpy()
        err = blast_settle_err(true_poc_traj(res.xs).cpu().numpy(), refs)
        ok = finite(res.xs, res.us)
        check(ok and abs(err - BLAST_JAX[row]) <= blast_bound(row),
              "blast row vs the JAX run", row=row, err_m=err,
              jax_m=BLAST_JAX[row], bound_m=blast_bound(row), finite=ok)
        resolved = (TK.select_poc_mode(**BLAST_PROFILES[prof])
                    if mode == "auto" else mode)
        solves = ({"frozen": 0, "online": 1, "online_stagewise": N,
                   "stagewise_anchored": N + 1}[resolved]
                  + int(plant == "exact"))
        r = {"row": row, "profile": prof, "poc_mode": mode,
             "resolved_poc_mode": resolved, "plant_poc": plant, **extra,
             "N": N, "ticks": BLAST_TICKS, "iters": FULL_ITERS,
             "launches": c["fused_rti_solve"], "ms_per_tick": ms,
             "jet_solves_per_tick": solves,
             "jet_host_ms_per_tick": jt["s"] * 1e3 / BLAST_TICKS,
             "jet_calls": jt["calls"], "true_poc_err_m": err,
             "belief_err_m": blast_settle_err(xs[:, 14:17], refs),
             "jax_m": BLAST_JAX[row], "bound_m": blast_bound(row),
             "bench_r05_m": BENCH_R05[row]}
        if plant == "exact" and mode == "frozen":
            # the plant reports the exact impact point: truth == belief
            gap = np.abs(true_poc_traj(res.xs).cpu().numpy() - xs[:, 14:17])
            pc = pre_b.poc
            solo = torch.stack([solve_poc(
                x[3:6], x[12:14], x[0:3], pc.stream_velocity, pc.drag,
                pc.newton_iters)[0] for x in res.xs[1:]]).cpu().numpy()
            r.update(truth_minus_belief_m=float(gap.max()),
                     truth_minus_belief_first_m=gap[0].tolist(),
                     truth_minus_belief_later_m=float(gap[1:].max()),
                     unbatched_minus_belief_later_m=float(
                         np.abs(solo - xs[1:, 14:17]).max()))
            check(gap.max() <= TRUTH_BELIEF_M, "truth equals belief",
                  row=row, gap_m=float(gap.max()))
            check(r["unbatched_minus_belief_later_m"] == 0.0,
                  "the plant's own solve is the belief", row=row,
                  gap_m=r["unbatched_minus_belief_later_m"])
        out["blast"][row] = r
        log("blast_scan", **r)
    out["blast_launches"] = sum(r["launches"] for r in out["blast"].values())
    prof_row = "blast_aggr_err_stagewise_m"
    out["blast_profile"] = device_busy(lambda: scan(prof_row, 5))
    log("blast_scan_profile", row=prof_row, ticks=5,
        **out["blast_profile"])

    # 19b: bench.py's alt_overshoot_cold6_m and fig8_cold12_settle_err_m
    # on the plain kernel (K1)
    def k1(path, n, fn, what, **want):
        """Run a path of n plain-mode launches, counted; record the cold
        ones under K1 and the warm ones under K3 (as phases 7-8 do)."""
        res, c = counted({"box_qp_solve": n, **want}, what, fn,
                         instances={"box_qp_solve[17x6]": n})
        warm = c.get("box_qp_solve.warm", 0)
        if c["box_qp_solve"] > warm:
            out["k1"][path] = c["box_qp_solve"] - warm
        if warm:
            out["k3"][path] = warm
        return res
    pre6 = simulation_ocp(20, solver=dataclasses.replace(
        base, qp_backend="pallas", lin_backend="fused", ipm_iters=SAFE_ITERS))
    spec6 = build_spec(pre6.ocp, yref=pre6.loop.yref, device=dev)
    x_alt = torch.zeros(17, device=dev)
    x_alt[2] = 0.5
    res, ms = k1("alt_overshoot_cold6", ALT_COLD6_TICKS, lambda: timed(
        lambda: make_closed_loop(pre6.ocp, ALT_COLD6_TICKS)(spec6, x_alt),
        ALT_COLD6_TICKS), "altitude step cold6")
    over = float(max(res.xs[:, 2].max().item() - 3.5, 0.0))
    ok = finite(res.xs)
    check(ok and abs(over - ALT_COLD6_JAX) <= STEP1_BOUND_M,
          "alt_overshoot_cold6 vs the JAX run", overshoot_m=over,
          jax_m=ALT_COLD6_JAX, finite=ok)
    out["alt_cold6"] = {"N": 20, "iters": SAFE_ITERS,
                        "ticks": ALT_COLD6_TICKS,
                        "launches": out["k1"]["alt_overshoot_cold6"],
                        "ms_per_tick": ms, "overshoot_m": over,
                        "jax_m": ALT_COLD6_JAX, "bound_m": STEP1_BOUND_M,
                        "bench_r05_m": BENCH_R05["alt_overshoot_cold6_m"]}
    log("alt_overshoot_cold6", **out["alt_cold6"])
    pre12 = simulation_ocp(20, solver=dataclasses.replace(
        base, qp_backend="pallas", ipm_iters=FULL_ITERS))
    res, ms = k1("fig8_cold12", FIG8_COLD12_TICKS, lambda: timed(
        lambda: TK.run_figure8(pre12, n_steps=FIG8_COLD12_TICKS,
                               device=dev), FIG8_COLD12_TICKS),
        "figure-8 cold12")
    err = float(np.linalg.norm(res.xs[1:, 0:2].cpu().numpy()
                               - res.refs[:, 0:2].cpu().numpy(),
                               axis=1)[60:].max())
    ok = finite(res.xs)
    check(ok and abs(err - FIG8_COLD12_JAX) <= STEP1_BOUND_M,
          "fig8_cold12 vs the JAX run", settle_err_m=err,
          jax_m=FIG8_COLD12_JAX, finite=ok)
    out["fig8_cold12"] = {"N": 20, "iters": FULL_ITERS,
                          "ticks": FIG8_COLD12_TICKS,
                          "launches": out["k1"]["fig8_cold12"],
                          "ms_per_tick": ms, "settle_err_m": err,
                          "jax_m": FIG8_COLD12_JAX,
                          "bound_m": STEP1_BOUND_M,
                          "bench_r05_m": BENCH_R05[
                              "fig8_cold12_settle_err_m"],
                          "lin_backend": pre12.ocp.solver.lin_backend}
    log("fig8_cold12", **out["fig8_cold12"])

    # 19c: Jacobian reuse. bench.py's rt4 and rt4jr4 (N=20, 4 iterations,
    # the fused linearizer, from a draw around hover)
    pre4 = simulation_ocp(20, solver=dataclasses.replace(
        base, qp_backend="pallas", lin_backend="fused", ipm_iters=4))
    spec4 = build_spec(pre4.ocp, yref=pre4.loop.yref, device=dev)
    x_rt = torch.as_tensor(draws(1)[0], device=dev)
    out["rt"] = {}
    for name, jr in (("rt4", 1), ("rt4jr4", 4)):
        res, ms = k1(name, RT_TICKS, lambda: timed(
            lambda: make_closed_loop(pre4.ocp, RT_TICKS, jac_refresh=jr)(
                spec4, x_rt), RT_TICKS), f"deployed loop {name}")
        check(finite(res.xs), "deployed loop finite", case=name)
        out["rt"][name] = {"jac_refresh": jr, "ms_per_tick": ms,
                           "launches": out["k1"][name],
                           "final_z": float(res.xs[-1, 2])}
    log("jac_reuse_deployed", N=20, iters=4, ticks=RT_TICKS, **out["rt"])
    # tests/test_sqp_sim.py:207-241: the N=60 loop from the ground, A and
    # B refreshed every 4th tick, against every tick linearized
    pre60 = simulation_ocp(60)
    spec60 = build_spec(pre60.ocp, yref=pre60.loop.yref, device=dev)
    x_g = torch.as_tensor(pre60.loop.x0, dtype=torch.float32, device=dev)
    loops = {}
    for name, jr in (("jr_n60_full", 1), ("jr_n60_reuse", 4)):
        loops[name] = k1(name, JR_TICKS, lambda: timed(
            lambda: make_closed_loop(pre60.ocp, JR_TICKS, jac_refresh=jr)(
                spec60, x_g), JR_TICKS), f"N=60 loop {name}")
    xf = loops["jr_n60_full"][0].xs[-1].cpu().numpy()
    xr = loops["jr_n60_reuse"][0].xs[-1].cpu().numpy()
    dz, eul = float(abs(xf[2] - xr[2])), float(np.abs(xr[3:6]).max())
    ok = bool(np.isfinite(xr).all())
    check(ok and dz < 0.1 and eul < 0.2, "the reuse loop tracks the full "
          "loop", dz_m=dz, euler_max=eul, finite=ok)
    out["jr_n60"] = {"dz_m": dz, "euler_max": eul,
                     **{k: {"ms_per_tick": v[1], "final_z": float(
                         v[0].xs[-1, 2])} for k, v in loops.items()}}
    log("jac_reuse_n60", N=60, ticks=JR_TICKS, iters=FULL_ITERS,
        **out["jr_n60"])
    # tests/test_sqp_sim.py:264-290: N=10, 4 iterations, "primal",
    # shifted, A and B every 4th tick (K3 in PLAIN), against the cold loop
    pre10 = simulation_ocp(10)
    spec10 = build_spec(pre10.ocp, yref=pre10.loop.yref, device=dev)
    x_2 = torch.zeros(17, device=dev)
    x_2[2] = 2.0
    ocp_w = dataclasses.replace(pre10.ocp, solver=dataclasses.replace(
        pre10.ocp.solver, ipm_iters=4, warm_mode="primal", warm_shift=True))
    res_w, ms_w = k1("warm_jr", WARM_JR_TICKS, lambda: timed(
        lambda: make_closed_loop(ocp_w, WARM_JR_TICKS, warm_start=True,
                                 jac_refresh=4)(spec10, x_2), WARM_JR_TICKS),
        "warm reuse loop", **{"box_qp_solve.warm": WARM_JR_TICKS})
    res_c, ms_c = k1("warm_jr_cold_ref", WARM_JR_TICKS, lambda: timed(
        lambda: make_closed_loop(pre10.ocp, WARM_JR_TICKS)(spec10, x_2),
        WARM_JR_TICKS), "warm reuse loop's cold reference")
    zw, zc = float(res_w.xs[-1, 2]), float(res_c.xs[-1, 2])
    ok = finite(res_w.xs, res_c.xs)
    check(ok and abs(zw - 3.5) < 0.05 and abs(zw - zc) < 0.02,
          "the warm reuse loop settles", z_m=zw, cold_z_m=zc, finite=ok)
    out["warm_jr"] = {"N": 10, "iters": 4, "ticks": WARM_JR_TICKS,
                      "warm_launches": out["k3"]["warm_jr"],
                      "ms_per_tick": ms_w, "final_z": zw,
                      "cold_ms_per_tick": ms_c, "cold_final_z": zc}
    log("warm_jac_reuse", **out["warm_jr"])
    # sqp_solve at hover (tests/test_sqp_sim.py:17-50), 12 iterations
    x_h = torch.zeros(17, device=dev)
    x_h[2] = 2.0
    yref = np.zeros(23)
    yref[2] = 2.0
    spec_h = build_spec(pre60.ocp, yref=yref, device=dev)
    P = BlasterParams.from_config(pre60.ocp.model, device=dev)
    F = discrete_dynamics(blaster_ode, pre60.ocp.dt)
    (best, norms), ms = k1("sqp_solve", FULL_ITERS, lambda: timed(
        lambda: R.sqp_solve(spec_h, R.init_rti_state(pre60.ocp, x_h), x_h,
                            P, F, pre60.ocp.solver, iters=FULL_ITERS), 1),
        "sqp_solve at hover")
    u0 = best.ubar[0].cpu().numpy()
    hover = (9.0 - 2.2) * 9.81 / 4.0
    crit = {"last_step_norm": float(norms[-1]),
            "thrust_rel_err": float(np.abs(u0[0:4] / hover - 1.0).max()),
            "swivel_rate_max": float(np.abs(u0[4:6]).max()),
            "gimbal_max": float(best.xbar[:, 12:14].abs().max()),
            "z_err_max": float((best.xbar[:, 2] - 2.0).abs().max())}
    check(finite(best.xbar, best.ubar) and crit["last_step_norm"] < 1.0
          and crit["thrust_rel_err"] < 2e-3
          and crit["swivel_rate_max"] <= 0.0872665 + 1e-6
          and crit["gimbal_max"] < 0.02 and crit["z_err_max"] < 2e-2,
          "sqp_solve reaches the hover", **crit)
    out["sqp"] = {"N": 60, "iters": FULL_ITERS, "ms": ms,
                  "step_norms": norms.cpu().tolist(), **crit}
    log("sqp_solve", **out["sqp"])
    return out


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

    from mpc_blaster_tpu_torch.ops import probes as P
    KERNEL_WRAPPERS.update({w: getattr(K, w) for w in WRAPPERS})
    PROBE_WRAPPERS.update({w: getattr(P, w) for w in PROBES})

    # ---- phase 1: build both kernel libraries from the checkout, one
    # nvcc for each source, started together ----
    with ThreadPoolExecutor(2) as pool:
        builds = [pool.submit(lib.build_library) for lib in (K, P)]
        built = [b.result() for b in builds]
    for (so, secs, build_log), lib in zip(built, (K, P)):
        lib._library()
        log("build", library=str(so.relative_to(REPO)), nvcc_s=secs,
            ptxas=[ln.strip() for ln in build_log.splitlines()
                   if "registers" in ln or "spill" in ln])
    usage = ipm_ptxas_usage(built[0][2])

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for nx, nu, mode, family, soft in sorted(
            K.BUILT, key=lambda b: (b[0], b[2], str(b[3]), b[4])):
        for N in ((20, 30, 60, 120, 240) if nx == 17 else (20,)):
            info = K.kernel_info(N, mode, nx, nu, family, soft)
            check(info["layout"] == ("global" if N > 120 else "resident"),
                  "launch plan layout", N=N, **info)
            log("launch_plan", instance=K.instance_name(nx, nu, family, soft),
                mode=K._MODE_NAMES[mode], N=N, **info,
                ptxas=usage.get((mode, soft, nx, nu, family)),
                waves={str(B): -(-B // (info["blocks_per_sm"] * sms))
                       for B in (1, 256, BATCH)})
    wall('1 build')
    # ---- phase 2: each kernel mode vs its plain twin on the card ----
    for w in KERNEL_WRAPPERS.values():
        w.by_layout = {}
    rows = []
    for name, N, B in (("n8_b3", 8, 3), ("n20_b1024", 20, BATCH),
                       ("n60_b1", 60, 1)):
        rows.append(compare_kernel(name, blaster_qps(N, B, dev), K))
        log("kernel_vs_plain", **rows[-1])
    # phase 19's single-problem loops: N=20 at 4 (rt4, rt4jr4), 6 (cold6)
    # and 12 iterations (cold12); N=10 at 12 (the warm reuse loop's cold
    # reference)
    rows.append(compare_kernel("n20_b1", blaster_qps(20, 1, dev), K,
                               time_iters=P19_N20_ITERS,
                               check_iters=(1, *P19_N20_ITERS)))
    log("kernel_vs_plain", **rows[-1])
    rows.append(compare_kernel("n10_b1", blaster_qps(10, 1, dev), K))
    log("kernel_vs_plain", **rows[-1])
    qp = blaster_qps(8, 3, dev)
    inf = torch.full_like(qp.lbx, float("inf"))
    free = qp._replace(lbx=-inf, ubx=inf, ubu=torch.full_like(qp.ubu,
                                                              float("inf")))
    rows.append(compare_kernel("n8_b3_inf_bounds", free, K))
    log("kernel_vs_plain", **rows[-1])
    # the sweeps' shape (phase 17: N=60, several waves of blocks, the
    # deployed "safe" budget)
    rows.append(compare_kernel("n60_b256", blaster_qps(60, 256, dev), K,
                               check_iters=(1, SAFE_ITERS, FULL_ITERS)))
    log("kernel_vs_plain", **rows[-1])
    cost_rows = [compare_fuse_cost(n, N, B, dev, K)
                 for n, N, B in (("n8_b3", 8, 3), ("n20_b1024", 20, BATCH))]
    for r in cost_rows:
        log("fuse_cost_vs_plain", **r)
    # the last case: the stage parameters of an online_stagewise tick,
    # each stage its own row (phase 19's blast scan)
    lin_rows = [compare_fuse_lin(n, N, dev, K, stagewise=sw)
                for n, N, sw in (("n8_b1", 8, False), ("n20_b1", 20, False),
                                 ("n60_b1", 60, False),
                                 ("n60_b1_stagewise", 60, True))]
    for r in lin_rows:
        log("fuse_lin_vs_plain", **r)
    warm_rows = [compare_warm(n, mode, N, B, dev, K) for n, mode, N, B in (
        ("plain_n8_b3", "plain", 8, 3),
        ("plain_n20_b1024", "plain", 20, BATCH),
        ("plain_n10_b1", "plain", 10, 1),   # phase 19's warm reuse loop
        ("fuse_cost_n8_b3", "fuse_cost", 8, 3),
        ("fuse_cost_n20_b1024", "fuse_cost", 20, BATCH),
        ("fuse_lin_n8_b1", "fuse_lin", 8, 1),
        ("fuse_lin_n60_b1", "fuse_lin", 60, 1))]
    for r in warm_rows:
        log("warm_vs_plain", **r)
    wall('2 kernel vs twin')
    # ---- phase 2b: the soft-bound kernel (K4) vs its plain twin ----
    # the "_all" cases: every state soft (phase 10's rows)
    soft_rows = [compare_soft(n, mode, N, B, dev, K, spread_rule=sr,
                              idx=None if n.endswith("_all") else (0, 1, 2))
                 for n, mode, N, B, sr in (
                     ("plain_n8_b3", "plain", 8, 3, False),
                     ("plain_n20_b1024", "plain", 20, BATCH, False),
                     ("plain_n60_b1", "plain", 60, 1, True),
                     ("plain_n60_b1_all", "plain", 60, 1, True),
                     ("fuse_lin_n8_b1", "fuse_lin", 8, 1, False),
                     ("fuse_lin_n60_b1", "fuse_lin", 60, 1, False),
                     ("fuse_lin_n60_b1_all", "fuse_lin", 60, 1, False))]
    for r in soft_rows:
        log("soft_vs_plain", **r)
    lay = layout_counts()
    check(set(lay) == {"resident"}, "phases 2-2b layout", got=lay,
          want="resident")
    wall("2b soft kernel vs twin")
    # ---- phase 2c: the other models' instantiations and long horizons ----
    q13_rows = layouts_only("phase 2c 13x4", "resident", lambda: [
        compare_kernel(n, quad13_qps(N, B, dev), K,
                       time_iters=(SAFE_ITERS, FULL_ITERS))
        for n, N, B in (("q13_n8_b3", 8, 3), ("q13_n20_b1024", 20, BATCH),
                        ("q13_n20_b1", 20, 1))])
    for r in q13_rows:
        log("kernel_13x4_vs_plain", **r)
    fam_rows = layouts_only("phase 2c families", "resident", lambda: {
        fam: [compare_fuse_lin(f"{fam}_n{N}_b1", N, dev, K, fam)
              for N in Ns]
        for fam, Ns in (("quad13", (8, 20)), ("blaster_dist", (8, 30)))})
    for r in fam_rows["quad13"] + fam_rows["blaster_dist"]:
        log("fuse_lin_family_vs_plain", **r)
    # K7: the plain kernel at long horizons (N=120 resident, N=240 in the
    # global layout)
    long_rows = [layouts_only(f"long horizon {n}",
                              "resident" if N <= 120 else "global",
                              lambda N=N, B=B, n=n: compare_kernel(
                                  n, blaster_qps(N, B, dev), K))
                 for n, N, B in (("n120_b1", 120, 1), ("n240_b1", 240, 1),
                                 ("n240_b256", 240, 256))]
    for r in long_rows:
        log("long_horizon_vs_plain", **r)
    # 24 iterations do not converge the out-of-box soft QP at N=120 (the
    # twin's mu 363, measured on an H100), so the spread rule's converged
    # check does not apply; 12 iterations meet the plain tolerance (0.35
    # of it, same run)
    long_soft = layouts_only("long horizon soft n120", "resident",
                             lambda: compare_soft("plain_n120_b1", "plain",
                                                  120, 1, dev, K))
    log("long_horizon_soft_vs_plain", **long_soft)
    wall("2c other models and long horizons vs twin")

    # ---- the main paths, each counted on its own ----
    pre20 = simulation_ocp(20)
    spec20 = build_spec(pre20.ocp, yref=pre20.loop.yref, device=dev)
    x0s = torch.as_tensor(draws(BATCH), device=dev)
    step = batched_rti_step(pre20.ocp, backend="pallas", device=dev)
    pre60 = simulation_ocp(60)

    def counted(expected: dict, what: str, fn, instances=None,
                layout="resident"):
        """Run fn with the counts set to 0; check the launches per
        wrapper (and, where given, per instantiation), and that every IPM
        launch took `layout`."""
        reset_counts()
        out = fn()
        got = counts()
        want = {k: expected.get(k, 0) for k in got}
        check(got == want, f"{what} launches", got=got, want=want)
        if instances is not None:
            inst = instance_counts()
            check(inst == instances, f"{what} launches per instantiation",
                  got=inst, want=instances)
        n = sum(got[w] for w in WRAPPERS)
        lay = layout_counts()
        check(lay == ({layout: n} if n else {}), f"{what} layout", got=lay,
              want=layout)
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
            instances={"box_qp_solve[17x6]": LONG_TICKS},
            layout="resident" if N <= 120 else "global")
        xs_l = res_l.xs.cpu().numpy()
        err = float(np.abs(xs_l[::5, 0:3] - np.asarray(LONG_JAX[N])).max())
        check(bool(np.isfinite(xs_l).all()) and err < 5e-2,
              "long horizon vs the JAX run", N=N, max_pos_err_m=err)
        long_loop[N] = {"launches": c15["box_qp_solve"],
                        "ms_per_tick": ms_l, "max_pos_err_m": err}
        log("long_horizon_loop", N=N, ticks=LONG_TICKS, iters=FULL_ITERS,
            **long_loop[N])
    wall("15 long horizons")

    # phase 16: the one-launch tick over a batch (K6 at B > 1): the
    # kernel vs its twin (one spec per problem), its time beside K5 at
    # the same shape, then the batched "xla" tick over the deployed
    # "safe" solver, one fuse_lin launch per tick
    kb_rows = layouts_only("phase 16 kernel vs twin", "resident", lambda: [
        compare_fuse_lin_batched("n20_b64", 20, 64, dev, K, 23)])
    for r in kb_rows:
        log("fuse_lin_batched_vs_plain", **r)
    kb_time = compare_fuse_lin_batched(f"n20_b{BATCH}", 20, BATCH, dev, K,
                                       24, time_iters=(SAFE_ITERS,
                                                       FULL_ITERS))
    log("fuse_lin_batched_time", **kb_time)
    ocp16 = simulation_ocp(20, solver=cfg.deployed_solver("safe")).ocp
    xstep16 = batched_rti_step(ocp16, device=dev)
    (u0s, states, diag, ms16), c16 = counted(
        {"fused_rti_solve": TICKS}, "batched xla tick, pallas_fused",
        lambda: run_batched_ticks(xstep16, spec20, x0s, TICKS, ocp16),
        instances={"fused_rti_solve[17x6 blaster]": TICKS})
    check(bool(torch.isfinite(u0s).all() & torch.isfinite(states.xbar).all()
               & torch.isfinite(diag.qp_kkt_eq).all()),
          "batched xla fused tick finite")
    busy16 = device_busy(
        lambda: run_batched_ticks(xstep16, spec20, x0s, 3, ocp16))
    xla_fused = {"N": 20, "B": BATCH, "ticks": TICKS, "iters": SAFE_ITERS,
                 "launches": c16["fused_rti_solve"],
                 "launches_per_tick": c16["fused_rti_solve"] / TICKS,
                 "ms_per_tick": ms16, "solves_per_s": BATCH * 1000.0 / ms16,
                 "kkt_eq_max": diag.qp_kkt_eq.max().item(),
                 "bound_viol_max": diag.bound_viol.max().item(),
                 "profiler_window_3_ticks": busy16}
    log("batched_xla_fused_tick", **xla_fused)
    wall("16 one-launch tick over a batch")

    # phase 17: the scenario sweeps on the simulation preset under
    # deployed_solver("safe") (swapped to "pallas": one plain launch per
    # tick for the whole batch). Every entry point here is called
    # without device=: the port's default is the card.
    from mpc_blaster_tpu_torch.sim import scenarios as S
    from mpc_blaster_tpu_torch.sim.closedloop import run_preset
    pre17 = cfg.simulation_preset()
    ocp17 = dataclasses.replace(pre17.ocp,
                                solver=cfg.deployed_solver("safe"))
    bare = run_preset(cfg.simulation_preset(), n_steps=1)
    spec17 = build_spec(ocp17, yref=pre17.loop.yref)
    scen = S.sample_scenarios(batch=8, seed=1, wind_max=0.8)
    on_card = {"run_preset": bare.xs.device.type,
               "build_spec": spec17.Q.device.type,
               "sample_scenarios": scen.x0.device.type}
    check(set(on_card.values()) == {"cuda"}, "the default device is the "
          "card", devices=on_card)
    sweeps = {}
    for name, fn in (
            ("wind_blind", lambda: S.disturbance_sweep(
                spec17, ocp17, scen, n_steps=SWEEP_TICKS)),
            ("wind_offset_free", lambda: S.disturbance_sweep(
                spec17, ocp17, scen, n_steps=SWEEP_TICKS,
                offset_free=True)),
            ("fault_blind", lambda: S.fault_sweep(
                spec17, ocp17, FAULT_DERATE, n_steps=SWEEP_TICKS)),
            ("fault_offset_free", lambda: S.fault_sweep(
                spec17, ocp17, FAULT_DERATE, n_steps=SWEEP_TICKS,
                offset_free=True))):
        (res, ms), c17 = counted(
            {"box_qp_solve": SWEEP_TICKS}, f"sweep {name}",
            lambda: timed(fn, SWEEP_TICKS),
            instances={"box_qp_solve[17x6]": SWEEP_TICKS})
        err = res.pos_err.cpu().numpy()
        jax_err = np.asarray(SWEEP_JAX[name]["pos_err_m"])
        finite = bool(torch.isfinite(res.final_states).all())
        # a scenario the JAX run leaves more than 1 m off has diverged:
        # where a diverging loop ends is set by f32 rounding, so it is
        # held to the JAX test's criterion (> 1 m) below, not to the run
        held = jax_err <= 1.0
        check(finite and res.final_states.device.type == "cuda"
              and bool((np.abs(err[held] - jax_err[held]) <= 5e-2).all()),
              "sweep vs the JAX run", case=name, pos_err=err.tolist(),
              jax=jax_err.tolist())
        sweeps[name] = {"B": len(err), "launches": c17["box_qp_solve"],
                        "ms_per_tick": ms, "pos_err_m": err.tolist(),
                        "settled": res.settled.cpu().tolist(),
                        "worst_kkt_eq": res.worst_kkt_eq.max().item(),
                        "jax": SWEEP_JAX[name]}
        log("sweep", case=name, N=ocp17.N, ticks=SWEEP_TICKS,
            iters=SAFE_ITERS, **sweeps[name])
    e = {k: np.asarray(v["pos_err_m"]) for k, v in sweeps.items()}
    check(e["wind_blind"].max() < 0.6 and e["wind_blind"].mean() < 0.3,
          "wind sweep near its targets", pos_err=e["wind_blind"].tolist())
    check(all(sweeps["wind_offset_free"]["settled"])
          and e["wind_offset_free"].max() < 0.02, "offset-free sweep "
          "rejects the wind", pos_err=e["wind_offset_free"].tolist())
    check(e["fault_blind"][2] > 1.0, "the single-rotor fault defeats the "
          "blind controller", pos_err=e["fault_blind"].tolist())
    check(all(sweeps["fault_offset_free"]["settled"])
          and e["fault_offset_free"].max() < 0.02, "every fault recovers "
          "with the observer", pos_err=e["fault_offset_free"].tolist())
    scen_b = S.sample_scenarios(batch=SWEEP_B, seed=2, wind_max=0.8)
    (res_b, ms_b), c17b = counted(
        {"box_qp_solve": SWEEP_TIMED_TICKS}, "timed offset-free sweep",
        lambda: timed(lambda: S.disturbance_sweep(
            spec17, ocp17, scen_b, n_steps=SWEEP_TIMED_TICKS,
            offset_free=True), SWEEP_TIMED_TICKS))
    check(bool(torch.isfinite(res_b.final_states).all()),
          "timed sweep finite")
    sweep_timed = {"B": SWEEP_B, "ticks": SWEEP_TIMED_TICKS,
                   "launches": c17b["box_qp_solve"],
                   "launches_per_tick": c17b["box_qp_solve"]
                   / SWEEP_TIMED_TICKS, "ms_per_tick": ms_b,
                   "solves_per_s": SWEEP_B * 1000.0 / ms_b}
    log("sweep_timed", case="wind_offset_free", N=ocp17.N,
        default_device=on_card, **sweep_timed)
    sweep_launches = (sum(v["launches"] for v in sweeps.values())
                      + c17b["box_qp_solve"])
    wall("17 sweeps")

    # phase 18: the probes P1 and P2 against their twins
    probes = probe_phase(dev)
    log("probe_smem_capacity", **probes["p1"])
    log("probe_fma_chain", **probes["p2"])
    wall("18 probes")

    # phase 19: the blast scan (19a), the step-1 rows (19b), Jacobian
    # reuse and the SQP (19c)
    p19 = phase19(dev, counted, base)
    wall("19 blast scan, step-1 rows, Jacobian reuse, SQP")

    if FAILURES:
        for f in FAILURES:
            log("FAILED", **f)
        raise SystemExit(f"chip_smoke: {len(FAILURES)} check(s) failed")

    main_row = next(r for r in rows if r["case"] == "n60_b1")
    cost_main = next(r for r in cost_rows if r["case"] == "n20_b1024")
    lin_main = next(r for r in lin_rows if r["case"] == "n60_b1")
    lin_n20 = next(r for r in lin_rows if r["case"] == "n20_b1")  # rt6f
    lin_stagewise = next(r for r in lin_rows
                         if r["case"] == "n60_b1_stagewise")
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

    k1_19 = {f"phase19_{k}": v for k, v in p19["k1"].items()}
    report = {"kernels": [
        entry("box_qp_ipm", c3["box_qp_solve"] + c4["box_qp_solve"]
              + sweep_launches + sum(k1_19.values()), rows,
              main_row, launch_bound("plain", 60, 1, FULL_ITERS),
              **launch_keys(K, 60, K.PLAIN),
              max_obj_rel_err=max(r["obj_rel_err"] for r in rows),
              launches_by_path={"batched_tick": c3["box_qp_solve"],
                                "closed_loop": c4["box_qp_solve"],
                                "sweeps": sweep_launches, **k1_19}),
        entry("box_qp_ipm_fuse_cost", fused_launches, cost_rows, cost_main,
              launch_bound("fuse_cost", 20, BATCH, FULL_ITERS),
              **launch_keys(K, 20, K.FUSE_COST),
              ms_6it=cost_main["kernel_ms_6it"],
              plain_ms_6it=cost_main["plain_ms_6it"],
              tick_ms={str(k): v for k, v in fused_tick_ms.items()}),
        entry("box_qp_ipm_fuse_lin",
              lin_launches + sum(r["launches"] for r in fig8.values())
              + p19["blast_launches"],
              lin_rows, lin_main,
              launch_bound("fuse_lin", 60, 1, FULL_ITERS),
              **launch_keys(K, 60, K.FUSE_LIN, family="blaster"),
              ms_6it=lin_main["kernel_ms_6it"],
              plain_ms_6it=lin_main["plain_ms_6it"],
              launches_by_path={"fused_closed_loops": lin_launches,
                                **{f"figure8_{k}": r["launches"]
                                   for k, r in fig8.items()},
                                "phase19_blast_scan": p19["blast_launches"]},
              stagewise=[lin_stagewise["kernel_ms"],
                         lin_stagewise["plain_ms"]],
              blast_ms_per_tick={k: r["ms_per_tick"]
                                 for k, r in p19["blast"].items()},
              ms_n20_6it=lin_n20["kernel_ms_6it"],
              plain_ms_n20_6it=lin_n20["plain_ms_6it"],
              bound_ms_n20_6it=launch_bound("fuse_lin", 20, 1,
                                            SAFE_ITERS)["bound_ms"],
              prologue_max_abs_err=max(
                  max(r["prologue_max_abs_err"].values())
                  for r in lin_rows)),
        {"name": "box_qp_ipm_warm", "route": "cuda", "source": KERNEL_SOURCE,
         "replaces": REPLACES["box_qp_ipm_warm"],
         "launches": warm_launches + sum(p19["k3"].values()),
         "launches_by_path": {"fuse_lin_warm_chains": warm_launches,
                              **{f"phase19_{k}_plain": v
                                 for k, v in p19["k3"].items()}},
         "max_abs_err": max(max(r["blend_max_abs_err"], r["max_abs_err_1it"])
                            for r in warm_rows),
         "blend_max_abs_err": max(r["blend_max_abs_err"] for r in warm_rows),
         "max_abs_err_1it_n60": warm_main["max_abs_err_1it"],
         "ms": warm_main["kernel_ms_3it"],
         "plain_ms": warm_main["plain_ms_3it"],
         **bound_keys(launch_bound("fuse_lin", 60, 1, FASTEST_ITERS,
                                  warm=True)),
         "cold_ms": warm_main["cold_kernel_ms_3it"],
         **launch_keys(K, 60, K.FUSE_LIN, family="blaster"),
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
         **launch_keys(K, 60, K.FUSE_LIN, family="blaster", soft=True),
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
               **launch_keys(K, 20, K.PLAIN, nx=13, nu=4),
               loop_ms_per_tick=q13["pallas"]["ms_per_tick"]),
        kentry("box_qp_ipm_fuse_lin_quad13",
               q13["pallas_fused"]["launches"], fam_rows["quad13"],
               fam_rows["quad13"][-1], SAFE_ITERS,
               launch_bound("fuse_lin", 20, 1, SAFE_ITERS, nx=13, nu=4,
                            family="quad13"),
               **launch_keys(K, 20, K.FUSE_LIN, nx=13, nu=4,
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
               **launch_keys(K, 30, K.FUSE_LIN, family="blaster_dist"),
               prologue_max_abs_err=max(
                   max(r["prologue_max_abs_err"].values())
                   for r in fam_rows["blaster_dist"]),
               loop_ms_per_tick=of_ms),
        kentry("box_qp_ipm_long_horizon",
               sum(v["launches"] for v in long_loop.values()), long_rows,
               long_rows[1], FULL_ITERS,
               launch_bound("plain", 240, 1, FULL_ITERS),
               **launch_keys(K, 240, K.PLAIN),
               launch_n120=launch_keys(K, 120, K.PLAIN),
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
        {"name": "box_qp_ipm_fuse_lin_batched", "route": "cuda",
         "source": KERNEL_SOURCE,
         "replaces": REPLACES["box_qp_ipm_fuse_lin_batched"],
         "launches": c16["fused_rti_solve"],
         "max_abs_err": max(r["max_abs_err_1it"]
                            for r in kb_rows + [kb_time]),
         "ms": kb_time["kernel_ms_6it"], "plain_ms": kb_time["plain_ms_6it"],
         "iters": SAFE_ITERS,
         **bound_keys(launch_bound("fuse_lin", 20, BATCH, SAFE_ITERS)),
         **launch_keys(K, 20, K.FUSE_LIN, family="blaster"),
         "ms_12it": kb_time["kernel_ms"],
         "plain_ms_12it": kb_time["plain_ms"],
         "bound_ms_12it": kb_time["bound_ms"],
         "fuse_cost_ms": {"6": kb_time["fuse_cost_ms_6it"],
                          "12": kb_time["fuse_cost_ms"]},
         "tick": xla_fused,
         "by_shape": {r["case"]: r for r in kb_rows + [kb_time]}},
        {"name": "probe_smem_capacity", "route": "cuda",
         "source": PROBE_SOURCE, "replaces": REPLACES["probe_smem_capacity"],
         "launches": 0, "max_abs_err": probes["p1"]["max_abs_err"],
         "ms": probes["p1"]["ms"], "plain_ms": probes["p1"]["plain_ms"],
         "bound_ms": 8.0 / PEAK_BYTES * 1e3, "bound_by": "bytes",
         "library_ms": None,
         "optin_bytes": probes["p1"]["optin_bytes"],
         "largest_bytes": probes["p1"]["largest_bytes"]},
        {"name": "probe_fma_chain", "route": "cuda", "source": PROBE_SOURCE,
         "replaces": REPLACES["probe_fma_chain"], "launches": 0,
         "max_abs_err": probes["p2"]["max_abs_err"],
         "ms": probes["p2"]["ms"], "plain_ms": probes["p2"]["plain_ms"],
         **chain_bound(probes["p2"]["elements"], CHAIN_CHECK_STEPS),
         "library_ms": None, "case": "rows24_chains4",
         "steps": CHAIN_CHECK_STEPS,
         "bound_ms_1e6_steps": chain_bound(probes["p2"]["elements"],
                                           CHAIN_STEPS)["bound_ms"],
         "ns_per_step": probes["p2"]["ns_per_step"],
         "chains4_over_chains1": probes["p2"]["chains4_over_chains1"]},
    ]}
    wall("report")
    print(json.dumps(report), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
