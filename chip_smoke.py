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
K7's shapes; phase 2 also the single plan's fuse_lin prologue grid
launched alone, `fused_lin_prologue`, at each family's B=1 shapes), then
drives the port's main paths, each with the launch counts (the probes'
and the prologue grid's included) set to 0 just before it and read just
after (the prologue grid's held to the path's B=1 fuse_lin launches, one
before each, and summed into its report entry):

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
     iterations);
 20. bench.py's seven remaining quality rows (fig8_rt6, fig8_rt4, the
     three warm figure-8 rows, the two warm altitude-step rows; N=20 on
     "pallas" with the fused linearizer, 220 / 200 ticks): K1, and K3 in
     PLAIN for the warm rows (K1 again on the watchdog's redo), each row
     against the JAX package's float32 run or its spread, beside
     BENCH_r05's value; each row's first 20 ticks timed again alone;
 21. tests/test_stress.py's 16 stress states through every 17x6
     instantiation a deployed path launches: K1 (the batched "pallas"
     tick), K5 (the batched "pallas_fused" tick), K6 (the batched "xla"
     tick over deployed_solver("safe"), and `rti_step` on "safe" state by
     state), K3 in FUSE_LIN (two guarded "fastest" ticks from each state)
     and K4 (`rti_step_soft` on "pallas" and on "pallas_fused", position
     bounds soft), each flight-safe and held at one iteration to its twin
     on the card (and on the host's CPU where a state breaks the rule);
     the recovery loop from 60% outside the position box on K1 and K6;
     the deep 40-iteration `sqp_solve` on K1;
 22. the solvers off the main path and scale-out: (a) `box_qp_solve` in
     its "pscan", "hybrid" and "sqrt" modes against "scan" (the
     simulation preset's QP at N=60 in float32; tests/test_pscan.py's QP
     in float64) and `lqr_solve_pscan` at N=64; (b) `condensed_qp_solve`
     (M=5) on tests/test_condense.py's N=60 QP in float64 and float32;
     (c, in the worker pool) the condensed hover loop at N=30 in float64
     and float32 against the float64 "riccati" loop, and the simulation
     preset on "condensed" for 3 ticks; (d) `sharded_rti_step` on the
     card's mesh (`make_mesh()`) at N=20, B=1024 on "pallas" (K1) and on
     deployed_solver("safe") (K6 over a batch), each equal to
     `batched_rti_step` bit for bit, and `sharded_sweep` at N=60, B=256,
     20 ticks on "safe" (K6, held to its twin at that shape); (e) the
     sharded tick again under a one-rank NCCL process group
     (`parallel/distributed.py::initialize`); (f) `utils.timing.
     device_time` against CUDA events on one K1 launch, and
     `utils.profiling.trace` around one sharded "safe" tick (a Chrome
     trace under chiprun_out/phase22_trace/).
 23. The flight I/O shell and the native runtime: (a) `libblaster_rt.so`
     built with g++ from the checkout, `NativeQPSolver` against
     `box_qp_solve` in float64 on the card, the 100 Hz `RateLoop`, the
     pose ring; (b) the `FlightNode` on the flight preset (N=30, float32)
     at 10 Hz over UDP loopback under `deployed_solver("safe")` (K6, the
     framed wire) and "fastest" with warm_start=True (K3 and the redo,
     MAVLink 2), held to tests/test_transport.py:91-150's pacing,
     lateness and frame criteria unchanged, the native ring in use, no
     watchdog trip; (d) `python -m mpc_blaster_tpu_torch` on the card,
     its u0 against the JAX CLI's (`CLI_U0_JAX`); (c) the 60 s endurance
     mission (`io/endurance.py`) with the offset-free controller on
     "pallas" (K1 and K3 in PLAIN at N=10; its tick one CUDA graph
     replay), held to tests/test_endurance.py:356-393 (the certification
     path's timing, the 0.090 s work bound included, the faults, the
     tracking and the estimate; one retry, as that test allows), and the
     "riccati" controller's 6 s mission, reported; one launch of each
     kernel on these paths held to its twin at its shape.
 24. The horizon ("hp") sharding of the log-depth scans (eager PyTorch,
     no kernel of ours): (a) tests/test_pscan.py:107-125's QP (N=64,
     float64 and float32) through `lqr_solve_pscan` on 4- and 8-chunk
     "hp" meshes of the card against the unsharded solve and
     `lqr_solve`; (b) the simulation preset's QP at N=240 (float32)
     through `box_qp_solve(riccati="pscan")` on a 4-chunk mesh against the
     unsharded solve (objective, kkt_eq), both timed, the gap to K7's
     solve reported; (c) (b) again under a one-rank NCCL process group,
     bit for bit.
 25. `jit`, the port's `jax.jit`: the fixed-shape ticks captured as CUDA
     graphs (`utils/capture.py`) against their eager ticks on the card,
     bit for bit at every tick, with the eager and captured ms a tick,
     each capture's host ms, node count and memory pool: `make_rti_step`
     ("pallas", "pallas_fused", N=60), `make_closed_loop` in every mode
     (20 ticks), the batched ticks (N=20, B=1024), quad13 (N=20), the
     mission's controller ("pallas", "riccati", 15 scripted ticks) and
     the flight node ("safe", "fastest", 10 ticks).
     `python3 chip_smoke.py --phase 25` builds the IPM kernel and runs
     this phase alone.

The sites' runners capture on their first call and replay after it,
throughout phases 3-24 (the entry points' default, as in the JAX
package); the hooks that read each wrapper call (the plain twins,
`record_launches`, `capture_launch`) run the ticks eagerly
(`capture.disable_jit`). A replay counts the launches its capture made,
so every phase's launch counts hold as they did eagerly.

The host-bound paths of phases 17, 19, 20, 21 and 22 (the four sweeps, the
blast rows, the paths of 19b-c, the phase-20 rows, the deep SQP, phase
22c's condensed loops) run in worker processes of
this script (`--worker`), seven at a time, each counting its own
launches with the counts at 0; their ms per tick are taken beside the
pool's other processes on the card, which time-slices between them.

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
(`launch_work`; the prologue grid's: `prologue_bound`); `library_ms` is
null: no single PyTorch call solves a box-constrained OCP-QP or runs the
prologue's RK4 on dual numbers.

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
    within 2e-2 of 2 on every node);
  - phase 20: a cold row within 5e-3 m of the JAX package's own float32
    run on its Riccati IPM (STEP4_JAX), both sides; a warm row within
    5e-3 m of that run's spread over moves of x0 by a few float32 ulps
    (STEP4_SPREAD);
  - phase 21: tests/test_stress.py:80-97's criteria (u0 finite and in the
    control box with a skin of 1e-3 of its width, kkt_eq and bound_viol
    finite, the far state's violation above 1 on hard-bound paths); one
    iteration within the tolerances of phase 2 (`stress_gaps`); the
    recovery loop by `recovery_checks`, the deep SQP by `deep_sqp`'s
    criteria (see phase21).
"""
from __future__ import annotations

import atexit
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
            # the fuse_lin prologue inside the Pallas kernel
            "box_qp_ipm_prologue": "mpc_blaster_tpu/ops/pallas_ipm.py:508",
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
# The JAX package's own float32 runs of phases 6-8 on the CPU (its Riccati
# IPM standing in for the kernel), recomputed by
# tests/test_torch_step4_bounds_loops.py and _alt.py: the "safe" and
# "fastest" loops' distance from the golden, the altitude step's
# overshoot. Each bound is that run + 5e-2 m.
SAFE_JAX_M = 0.1240
FASTEST_JAX_M = 0.0111
ALT_JAX_M = {"fastest": 0.0186, "raw_watchdog": 0.0}
SAFE_BOUND_M = SAFE_JAX_M + 5e-2
FASTEST_BOUND_M = FASTEST_JAX_M + 5e-2
ALT_BOUND_M = {k: v + 5e-2 for k, v in ALT_JAX_M.items()}
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
             "fig8_rt6_settle_err_m": 0.0388,
             "fig8_rt4_settle_err_m": 0.0387,
             "fig8_warm4shift_err_m": 0.0285,
             "fig8_warm3shift_err_m": 0.0346,
             "fig8_warm3shiftwd_err_m": 0.0346,
             "alt_overshoot_warm4shift_m": 0.0187,
             "alt_overshoot_warmraw_wd_m": 0.0133,
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
# Phase 20: bench.py's seven remaining quality rows (:526-537, :576-587),
# each run through `rt_runner` (:248-258): the simulation preset at N=20,
# Tf=20/30, the solver's `ipm_iters`, `warm_mode`, `warm_shift` and
# `warm_watchdog` set by the row (rt_runner's defaults "full", no shift,
# no watchdog otherwise), `lin_backend="fused"`, on "pallas" (kernel K1;
# the warm rows launch K3 in PLAIN, and K1 where the watchdog redoes a
# tick cold). "fig8" rows: `run_figure8` for 220 ticks, the max xy error
# after tick 60 (:516-523); "alt" rows: `make_closed_loop(ocp, 200,
# warm_start=True)` from z=0.5 towards the preset's yref, the overshoot
# max(z) - 3.5 floored at 0 (:566-571).
STEP4_TICKS = {"fig8": RT6F_TICKS, "alt": ALT_TICKS}
STEP4_ROWS = {   # row -> (task, warm-started, the row's solver fields)
    "fig8_rt6_settle_err_m": ("fig8", False, dict(ipm_iters=6)),
    "fig8_rt4_settle_err_m": ("fig8", False, dict(ipm_iters=4)),
    "fig8_warm4shift_err_m": ("fig8", True, dict(
        ipm_iters=4, warm_mode="centrality", warm_shift=True)),
    "fig8_warm3shift_err_m": ("fig8", True, dict(
        ipm_iters=3, warm_mode="primal", warm_shift=True)),
    "fig8_warm3shiftwd_err_m": ("fig8", True, dict(
        ipm_iters=3, warm_mode="primal", warm_shift=True,
        warm_watchdog=True)),
    "alt_overshoot_warm4shift_m": ("alt", True, dict(
        ipm_iters=4, warm_mode="centrality", warm_shift=True)),
    "alt_overshoot_warmraw_wd_m": ("alt", True, dict(
        ipm_iters=4, warm_mode="full", warm_shift=False,
        warm_watchdog=True))}


def step4_fields(row: str) -> dict:
    """rt_runner's solver fields of a phase-20 row, but the backend."""
    return {"lin_backend": "fused", "warm_mode": "full",
            "warm_shift": False, "warm_watchdog": False,
            **STEP4_ROWS[row][2]}


# The JAX package's own float32 run of each row on the CPU, its Riccati
# IPM standing in for the Pallas kernel (the same QP and Mehrotra
# algorithm), recomputed by tests/test_torch_step4_bounds*.py. A cold row
# is held within STEP1_BOUND_M of it on both sides. The warm chains are
# chaotic in float32, so a warm row is held to the spread of the JAX run
# over x0's position moved by each of STEP4_MOVES_M along (1, -1, 1) (a
# few float32 ulps of x0; 1e-9 m moves would vanish in float32) and
# unmoved: within [min - STEP1_BOUND_M, max + STEP1_BOUND_M].
STEP4_MOVES_M = (2.5e-7, 5e-7, 7.5e-7, 1e-6)
STEP4_JAX = {"fig8_rt6_settle_err_m": 0.0388,
             "fig8_rt4_settle_err_m": 0.0384,
             "fig8_warm4shift_err_m": 0.0282,
             "fig8_warm3shift_err_m": 0.0314,
             "fig8_warm3shiftwd_err_m": 0.0314,
             "alt_overshoot_warm4shift_m": 0.0186,
             "alt_overshoot_warmraw_wd_m": 0.0}
STEP4_SPREAD = {"fig8_warm4shift_err_m": (0.0282, 0.0341),
                "fig8_warm3shift_err_m": (0.0304, 0.0383),
                "fig8_warm3shiftwd_err_m": (0.0304, 0.0383),
                "alt_overshoot_warm4shift_m": (0.0186, 0.0186),
                "alt_overshoot_warmraw_wd_m": (0.0, 0.0186)}
JR_TICKS = 60        # tests/test_sqp_sim.py:207-241's reuse loop
WARM_JR_TICKS = 80   # tests/test_sqp_sim.py:264-290's warm reuse loop
P19_N20_ITERS = (4, SAFE_ITERS, FULL_ITERS)  # phase 19's K1 budgets at N=20
# phase 20's warm rows: K3 in PLAIN at N=20 B=1, 3 and 4 iterations
P20_WARM = dict(check_iters=(1, FASTEST_ITERS, 4, FULL_ITERS),
                time_iters=(FASTEST_ITERS, 4))
# phase 2's plain N=10 warm row also at the mission controller's budget
# (6 iterations, phase 23's K3 shape), held there as at FULL_ITERS
P23_WARM = dict(check_iters=(1, FASTEST_ITERS, SAFE_ITERS, FULL_ITERS),
                time_iters=(FASTEST_ITERS, SAFE_ITERS),
                hold_iters=(SAFE_ITERS, FULL_ITERS))
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


def work_bound(flops: float, nbytes: float) -> dict:
    """The least time the card could take for this work, and what sets
    it."""
    t_ops, t_bytes = flops / PEAK_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "flops": flops, "bytes": nbytes}


def launch_bound(mode, N, B, iters, **kw) -> dict:
    """The least time the card could take for one launch, and what sets
    it."""
    return work_bound(*launch_work(mode, N, B, iters, **kw))


def prologue_bound(N: int, family: str = "blaster", nsteps: int = 1,
                   nx: int = 17, nu: int = 6) -> dict:
    """`launch_bound` of the single plan's fuse_lin prologue grid alone
    (B=1): `launch_work`'s prologue FLOPs (the RK4 of the family's ODE on
    dual numbers, its value part once per node and its tangent part once
    per (node, column) pair, and the defect); bytes: the iterate and the
    stage parameters read once, A, B and c written once (float32)."""
    from mpc_blaster_tpu_torch.ops.box_qp_ipm import FAMILY_NP
    value, tangent = rk4_flops(family, nx)
    flops = N * nsteps * (value + (nx + nu) * tangent) + N * nx
    floats = ((N + 1) * nx + N * nu + N * FAMILY_NP[family]
              + N * (nx * nx + nx * nu + nx))
    return work_bound(float(flops), float(4 * floats))


def log(phase: str, **kv):
    print(json.dumps({"phase": phase, **kv}), flush=True)


FAILURES: list = []


def check(ok: bool, what: str, **detail):
    """Record a failed check; the run fails at the end, after every phase
    has reported."""
    if not ok:
        FAILURES.append({"check": what, **detail})


def report_failures():
    """Log every failed check on stdout in full, and name each on stderr
    (its check and short details, a criteria dict by its false entries,
    one line each), so that the end of the error stream says which checks
    failed."""
    for f in FAILURES:
        log("FAILED", **f)
        brief = {}
        for k, v in f.items():
            if isinstance(v, dict) and v and all(
                    isinstance(x, bool) for x in v.values()):
                brief[k + "_false"] = [c for c, x in v.items() if not x]
            elif len(json.dumps(v, default=str)) <= 200:
                brief[k] = v
        print("chip_smoke FAILED: " + json.dumps(brief, default=str)[:800],
              file=sys.stderr, flush=True)


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


def graph_ms(fn, reps: int) -> float:
    """Mean milliseconds per call of `reps` calls captured once as a CUDA
    graph (after a warm call on a side stream) and replayed three times:
    the device's time, the host's work off the clock. The calls' launch
    counts are taken once, at the capture."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    return cuda_ms(g.replay, 3) / reps


WRAPPERS = ("box_qp_solve", "batched_fused_tick", "fused_rti_solve")
KERNEL_WRAPPERS: dict = {}   # the wrappers that hold the launch counts
# the count of the single plan's fuse_lin prologue grid, a launch of its
# own before each B=1 fuse_lin solve (`fused_lin_prologue.launches`), and
# its launches per counted path (`tally_prologue`)
PROLOGUE_WRAPPERS: dict = {}
PROLOGUE_LAUNCHES: dict = {}
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
    for fn in (*PROBE_WRAPPERS.values(), *PROLOGUE_WRAPPERS.values()):
        fn.launches = 0


def tally_prologue(what: str):
    """After a counted path: its prologue grid launches, held to its
    single-plan fuse_lin launches (one grid before each), added to
    PROLOGUE_LAUNCHES under `what`."""
    for fn in PROLOGUE_WRAPPERS.values():
        single = sum(v for k, v in KERNEL_WRAPPERS[
            "fused_rti_solve"].by_layout.items() if k[1] == "single")
        check(fn.launches == single, f"{what} prologue launches",
              got=fn.launches, want=single)
        if fn.launches:
            PROLOGUE_LAUNCHES[what] = (PROLOGUE_LAUNCHES.get(what, 0)
                                       + fn.launches)


def layout_counts(part: int = 0) -> dict:
    """The IPM launches per layout ("resident", "global") over every
    wrapper, the non-zero ones; with part=1, per plan ("single", "batch")
    instead (a wrapper's `by_layout` is keyed (layout, plan))."""
    out: dict = {}
    for fn in KERNEL_WRAPPERS.values():
        for k, v in fn.by_layout.items():
            if v:
                out[k[part]] = out.get(k[part], 0) + v
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
    """ptxas_usage of the IPM library's kernels: each solve kernel by its
    instantiation and plan, (mode, soft, nx, nu, family) as in `BUILT` and
    its threads -> registers, stack and spills; the single plan's
    prologue kernels by ("prologue", nx, nu, family, soft)."""
    from mpc_blaster_tpu_torch.ops import box_qp_ipm as K
    fams = {v: k for k, v in K.FAMILY_IDS.items()}
    out = {}
    for name, use in ptxas_usage(build_log).items():
        m = re.search(r"box_qp_ipm_kernelILi(\d)ELb(\d)ELi(\d+)ELi(\d+)"
                      r"ELi(\d)ELi(\d+)E", name)
        p = re.search(r"box_qp_ipm_prologueILi(\d+)ELi(\d+)ELi(\d)ELb(\d)E",
                      name)
        if m:
            mode, soft, nx, nu, fam, threads = (int(g) for g in m.groups())
            out[(mode, bool(soft), nx, nu,
                 fams[fam] if mode == K.FUSE_LIN else None, threads)] = use
        elif p:
            nx, nu, fam, soft = (int(g) for g in p.groups())
            out[("prologue", nx, nu, fams[fam], bool(soft))] = use
    return out


def launch_keys(K, N, mode, nx=17, nu=6, family=None, soft=False,
                B=1) -> dict:
    """A report entry's launch of B problems: the plan, its layout,
    threads, dynamic shared bytes and prologue grid; the plan's compiled
    kernel's registers and blocks per SM."""
    info = K.kernel_info(N, mode, nx, nu, family, soft, B=B)
    return {k: info[k] for k in ("plan", "layout", "threads", "smem_bytes",
                                 "prologue_blocks", "blocks_per_sm",
                                 "registers")}


def instance_counts() -> dict:
    """Launches per wrapper and instantiation ("<wrapper>[<instance>]",
    e.g. "fused_rti_solve[13x4 quad13]"), the non-zero ones."""
    return {f"{w}[{k}]": v for w, fn in KERNEL_WRAPPERS.items()
            for k, v in fn.by_instance.items() if v}


def counted(expected: dict, what: str, fn, instances=None,
            layout="resident"):
    """Run fn with the counts set to 0; check the launches per wrapper
    (and, where given, per instantiation), and that every IPM launch took
    `layout`."""
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
    tally_prologue(what)
    return out, got


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
    plain path of the same ticks; it launches no kernel. The ticks run
    eagerly meanwhile (`capture.disable_jit`): the twins are timed as
    the eager reference they are."""
    from mpc_blaster_tpu_torch.ops import box_qp_ipm as K
    from mpc_blaster_tpu_torch.utils import capture
    kernels = {w: getattr(K, w) for w in WRAPPERS}
    for w in WRAPPERS:
        setattr(K, w, getattr(K, w + "_plain"))
    try:
        with capture.disable_jit():
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
    plain_ms, at other `time_iters` with an "_<n>it" suffix; the twin is
    timed in its check call where there is one)."""
    row = {"case": name, "B": qp.A.shape[0], "N": qp.A.shape[1],
           "nx": qp.A.shape[-1], "nu": qp.B.shape[-1]}
    plain_ms = {}
    for iters in check_iters:
        n0 = K.box_qp_solve.launches
        sk = K.box_qp_solve(qp, iters=iters)
        torch.cuda.synchronize()
        check(K.box_qp_solve.launches == n0 + 1, "kernel launched",
              case=name)
        sp, plain_ms[iters] = timed(
            lambda: K.box_qp_solve_plain(qp, iters=iters), 1)
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
        row["plain_ms" + sfx] = plain_ms[it] if it in plain_ms else \
            cuda_ms(lambda: K.box_qp_solve_plain(qp, iters=it), reps=1)
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
    plain_ms = {}
    for iters in (1, SAFE_ITERS, FULL_ITERS):
        n0 = K.batched_fused_tick.launches
        xk, uk, dk, _ = K.batched_fused_tick(AB, c, xbar, ubar, x0, *args,
                                             iters=iters)
        torch.cuda.synchronize()
        check(K.batched_fused_tick.launches == n0 + 1, "kernel launched",
              case=name)
        (xp, up, dp, _), plain_ms[iters] = timed(
            lambda: K.batched_fused_tick_plain(AB, c, xbar, ubar, x0, *args,
                                               iters=iters), 1)
        fused_checks(name, K, qp, (xk, uk), (xp, up), (xbar, ubar), iters,
                     row, dk, dp)
    for iters in (SAFE_ITERS, FULL_ITERS):
        sfx = "" if iters == FULL_ITERS else f"_{iters}it"
        row["kernel_ms" + sfx] = cuda_ms(lambda: K.batched_fused_tick(
            AB, c, xbar, ubar, x0, *args, iters=iters), reps=10)
        row["plain_ms" + sfx] = plain_ms[iters]
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
    plain_ms = {}
    for iters in (1, SAFE_ITERS, FULL_ITERS):
        n0 = K.fused_rti_solve.launches
        sk, lin = K.fused_rti_solve(xbar, ubar, sp, x0, *args, iters=iters,
                                    return_lin=True, **kw)
        torch.cuda.synchronize()
        check(K.fused_rti_solve.launches == n0 + 1, "kernel launched",
              case=name)
        spl, plain_ms[iters] = timed(lambda: K.fused_rti_solve_plain(
            xbar, ubar, sp, x0, *args, iters=iters, **kw), 1)
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
        row["plain_ms" + sfx] = plain_ms[iters]
    return row


def compare_prologue(name, N, dev, K, family="blaster"):
    """The single plan's fuse_lin prologue grid launched alone
    (`fused_lin_prologue`, B=1) against its plain version on the same
    inputs (`fused_lin_prologue_plain`: A, B and c within 2e-4 + 2e-4
    |ref|, compare_fuse_lin's rule) and against the record the full B=1
    launch's prologue writes (the same bits); timed eagerly (CUDA events
    around each call, the host's work included), on graph replays
    (`graph_ms`) and the twin; the report row."""
    from mpc_blaster_tpu_torch.sqp.rti import fused_dyn_statics
    if family == "quad13":
        statics, sp, xbar, ubar, x0, args, _ = quad13_fused_case(
            N, 1, dev, N + 2)
    else:
        ocp, sp, xbar, ubar, x0, args, _ = fused_case(N, 1, dev, N + 2,
                                                      family)
        statics = fused_dyn_statics(ocp, family=family)
    model, dt, ns = statics

    def run():
        return K.fused_lin_prologue(xbar, ubar, sp, model, dt, ns)
    n0 = K.fused_lin_prologue.launches
    got = run()
    torch.cuda.synchronize()
    check(K.fused_lin_prologue.launches == n0 + 1, "kernel launched",
          case=name)
    ref, plain_ms = timed(lambda: K.fused_lin_prologue_plain(
        xbar, ubar, sp, model, dt, ns), 1)
    _, lin = K.fused_rti_solve(xbar, ubar, sp, x0, *args, iters=1,
                               return_lin=True, model=model, dt=dt,
                               num_steps=ns)
    torch.cuda.synchronize()
    errs = dict(zip(("A", "B", "c"), ((g - r).abs().max().item()
                                      for g, r in zip(got, ref))))
    check(all(bool(((g - r).abs() <= 2e-4 + 2e-4 * r.abs()).all())
              for g, r in zip(got, ref)), "prologue alone vs its twin",
          case=name, errs=errs)
    check(all(torch.equal(a, b) for a, b in zip(got, lin)),
          "prologue alone is the launch's prologue", case=name)
    return {"case": name, "B": 1, "N": N, "family": family,
            "num_steps": ns, "max_abs_err": max(errs.values()),
            "errs": errs, "kernel_ms": cuda_ms(run, reps=10),
            "replay_ms": graph_ms(run, 10), "plain_ms": plain_ms,
            "prologue_blocks": K.launch_plan(
                N, K.FUSE_LIN, False, xbar.shape[-1], ubar.shape[-1],
                1).prologue_blocks,
            **prologue_bound(N, family, ns, xbar.shape[-1],
                             ubar.shape[-1])}


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


def compare_warm(name, mode, N, B, dev, K,
                 check_iters=(1, FASTEST_ITERS, FULL_ITERS),
                 time_iters=(FASTEST_ITERS,), hold_iters=(FULL_ITERS,)):
    """Warm-start kernel (K3, in one mode) vs its plain twin; the report
    row. At B=1 (every fuse_lin row) the clean, poisoned and invalid
    problems run as three launches.

    Held everywhere: the blend pointwise (0 iterations), valid=0 bit for
    bit the cold launch, finite iterates. Past the blend the clean valid
    problems are held to the cold tolerances where the warm solve is
    well conditioned (the main path's case, fuse_lin N=60: measured 7e-5
    of du per 1e-6 relative change of the warm state after one
    iteration; and N=30, the flight node's: at most 2e-3 of du at 1, 3, 6
    and 12 iterations, measured on the CPU); at N=8 and N=20 the chain's
    warm solves are chaotic in f32
    (0.4-1.1 of du per 1e-6, measured on the CPU), so there the
    kernel-vs-twin agreement is held to the twin's own against a copy of
    itself started from the warm state moved by 1e-6 relative (the
    within-tolerance fraction no more than 0.05 lower, on batches of at
    least 64; reported for the others). On smaller batches (N=8, and N=10,
    phase 19's warm reuse loop and phase 23's mission) every clean problem
    is held to the cold tolerances at each of `hold_iters`, and the twin
    also runs on the host's CPU: its distance from the card's twin
    (float32 rounding alone) is
    reported beside the kernel's. The clean problems are compared at
    each of `check_iters` and the launches timed at each of `time_iters`
    (kernel_ms_<n>it, plain_ms_<n>it, cold_kernel_ms_<n>it)."""
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
    strict = mode == "fuse_lin" and N in (30, 60)
    row = {"case": name, "mode": mode, "B": B, "N": N, "strict": strict}
    errs = {"blend": 0.0, "1it": 0.0}
    for inp_p, w, m in parts:
        kern, plain, qp = warm_runners(mode, ocp, inp_p, K)
        plain_ms = {}
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
        for iters in check_iters:
            a, c = kern(iters, w), kern(iters, None)
            off = kern(iters, cold_w)
            torch.cuda.synchronize()
            p_, plain_ms[iters] = timed(lambda: plain(iters, w), 1)
            q_ = plain(iters, moved)
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
            elif iters in hold_iters:
                check(kt == 1.0, "warm parity at the full budget",
                      case=name, iters=iters)
        if inp_p is parts[0][0]:
            w_ = w
            for it in time_iters:
                row[f"kernel_ms_{it}it"] = cuda_ms(lambda: kern(it, w_),
                                                   reps=10)
                row[f"plain_ms_{it}it"] = plain_ms[it] if it in plain_ms \
                    else cuda_ms(lambda: plain(it, w_), reps=1)
                row[f"cold_kernel_ms_{it}it"] = cuda_ms(
                    lambda: kern(it, None), reps=10)
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
    plain_ms = {}
    for iters in (1, FULL_ITERS) + ((2 * FULL_ITERS,) if spread_rule
                                    else ()):
        sk = kern(iters, soft)
        torch.cuda.synchronize()
        sp, plain_ms[iters] = timed(lambda: plain(iters, soft), 1)
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
        row["plain_ms" + sfx] = plain_ms[iters] if iters in plain_ms else \
            cuda_ms(lambda: plain(iters, soft), reps=1)
    # every soft row of this spec has a finite bound (the preset's box)
    rows_soft = int(sum(p.soft.sum() for p in soft).item())
    row["bound"] = launch_bound(mode, N, B, SAFE_ITERS,
                                soft_rows=rows_soft)
    return row


def guarded_trips():
    """Wrap the port's guarded warm tick so the last watchdog state of a
    closed loop can be read back: (context manager, getter). Under
    `make_closed_loop`'s capture the wrapper runs on the first tick and
    once more while the tick is captured; the watchdog state it keeps then
    is the graph's output, which every replay rewrites before the carry
    takes it: after the loop it holds the last replay's state."""
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


def timed_rounds(fns: dict, rounds: int):
    """Each fn of `fns` called once to warm up, then `rounds` more times,
    the fns taking turns within each round: (the last result of each fn,
    its ms per call in each timed round)."""
    res, ms = {}, {k: [] for k in fns}
    for r in range(rounds + 1):
        for k, fn in fns.items():
            res[k], t = timed(fn, 1)
            if r:
                ms[k].append(t)
    return res, ms


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
    plain_ms = {}
    for iters in (1, SAFE_ITERS, FULL_ITERS):
        n0 = K.fused_rti_solve.launches
        sk = K.fused_rti_solve(xbar, ubar, sp, x0, *args, iters=iters, **kw)
        torch.cuda.synchronize()
        check(K.fused_rti_solve.launches == n0 + 1, "kernel launched",
              case=name)
        spl, plain_ms[iters] = timed(lambda: K.fused_rti_solve_plain(
            xbar, ubar, sp, x0, *args, iters=iters, **kw), 1)
        xk, uk, dk = K._tick_diag(f, sk)
        xp, up, dp = K._tick_diag(f, spl)
        fused_checks(name, K, qp, (xk, uk), (xp, up), (xbar, ubar), iters,
                     row, dk, dp)
    AB = torch.cat([A, Bm], -1)
    for it in time_iters:
        sfx = "" if it == FULL_ITERS else f"_{it}it"
        row["kernel_ms" + sfx] = cuda_ms(lambda: K.fused_rti_solve(
            xbar, ubar, sp, x0, *args, iters=it, **kw), reps=10)
        row["plain_ms" + sfx] = plain_ms[it]
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


def blast_preset():
    """Phase 19a's preset: the simulation preset at N=60 on "pallas_fused"
    at 12 iterations."""
    from mpc_blaster_tpu_torch import config as cfg
    return simulation_ocp(60, solver=dataclasses.replace(
        cfg.simulation_preset().ocp.solver, qp_backend="pallas_fused",
        ipm_iters=FULL_ITERS))


def blast_scan(row: str, n: int, dev):
    from mpc_blaster_tpu_torch.sim import tasks as TK
    prof, mode, plant, extra = BLAST_ROWS[row]
    return TK.run_blast_scan(blast_preset(), n_steps=n, poc_mode=mode,
                             plant_poc=plant, frozen_at="canonical",
                             device=dev, **BLAST_PROFILES[prof], **extra)


def blast_row(row: str, dev) -> dict:
    """One of bench.py's blast rows (phase 19a), counted: its mean
    true-POC error against the JAX run and its bound, ms per tick, the jet
    solves' host time; with the exact plant and frozen POC rows, truth
    against belief."""
    from mpc_blaster_tpu_torch.poc.solver import solve_poc, true_poc_traj
    from mpc_blaster_tpu_torch.sim import tasks as TK
    prof, mode, plant, extra = BLAST_ROWS[row]
    pre_b = blast_preset()
    N = pre_b.ocp.N
    with jet_timer() as jt:
        (res, ms), c = counted(
            {"fused_rti_solve": BLAST_TICKS}, f"blast {row}",
            lambda: timed(lambda: blast_scan(row, BLAST_TICKS, dev),
                          BLAST_TICKS),
            instances={"fused_rti_solve[17x6 blaster]": BLAST_TICKS})
    xs = res.xs.cpu().numpy()
    refs = res.refs.cpu().numpy()
    err = blast_settle_err(true_poc_traj(res.xs).cpu().numpy(), refs)
    ok = bool(torch.isfinite(res.xs).all() & torch.isfinite(res.us).all())
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
    log("blast_scan", **r)
    return r


P19_PATHS = ("alt_cold6", "fig8_cold12", "rt", "jr_n60", "warm_jr", "sqp")


def p19_path(name: str, dev) -> dict:
    """One path of phase 19b-c (P19_PATHS), counted: (b) bench.py's
    alt_overshoot_cold6_m (K1, the fused linearizer) and
    fig8_cold12_settle_err_m (K1 standing in for the eager Riccati IPM);
    (c) Jacobian reuse: bench.py's rt4 / rt4jr4 loops, the N=60 reuse loop
    and the shifted warm reuse loop (K1 and K3 in PLAIN) of
    tests/test_sqp_sim.py, and `sqp_solve` at hover. Returns its records
    and its launches under K1 and K3."""
    from mpc_blaster_tpu_torch import config as cfg
    from mpc_blaster_tpu_torch.dynamics.blaster import (BlasterParams,
                                                        blaster_ode)
    from mpc_blaster_tpu_torch.dynamics.integrators import discrete_dynamics
    from mpc_blaster_tpu_torch.ocp.spec import build_spec
    from mpc_blaster_tpu_torch.sim import tasks as TK
    from mpc_blaster_tpu_torch.sim.closedloop import make_closed_loop
    from mpc_blaster_tpu_torch.sqp import rti as R
    base = cfg.simulation_preset().ocp.solver
    out = {"k1": {}, "k3": {}}

    def finite(*ts):
        return all(bool(torch.isfinite(t).all()) for t in ts)

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

    def loop(ocp, n, spec, x, **kw):
        return lambda: timed(
            lambda: make_closed_loop(ocp, n, **kw)(spec, x), n)

    if name == "alt_cold6":     # 19b, on the plain kernel (K1)
        pre6 = simulation_ocp(20, solver=dataclasses.replace(
            base, qp_backend="pallas", lin_backend="fused",
            ipm_iters=SAFE_ITERS))
        spec6 = build_spec(pre6.ocp, yref=pre6.loop.yref, device=dev)
        x_alt = torch.zeros(17, device=dev)
        x_alt[2] = 0.5
        res, ms = k1("alt_overshoot_cold6", ALT_COLD6_TICKS,
                     loop(pre6.ocp, ALT_COLD6_TICKS, spec6, x_alt),
                     "altitude step cold6")
        over = float(max(res.xs[:, 2].max().item() - 3.5, 0.0))
        ok = finite(res.xs)
        check(ok and abs(over - ALT_COLD6_JAX) <= STEP1_BOUND_M,
              "alt_overshoot_cold6 vs the JAX run", overshoot_m=over,
              jax_m=ALT_COLD6_JAX, finite=ok)
        out["alt_cold6"] = {
            "N": 20, "iters": SAFE_ITERS, "ticks": ALT_COLD6_TICKS,
            "launches": out["k1"]["alt_overshoot_cold6"],
            "ms_per_tick": ms, "overshoot_m": over, "jax_m": ALT_COLD6_JAX,
            "bound_m": STEP1_BOUND_M,
            "bench_r05_m": BENCH_R05["alt_overshoot_cold6_m"]}
        log("alt_overshoot_cold6", **out["alt_cold6"])
    elif name == "fig8_cold12":
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
        out["fig8_cold12"] = {
            "N": 20, "iters": FULL_ITERS, "ticks": FIG8_COLD12_TICKS,
            "launches": out["k1"]["fig8_cold12"], "ms_per_tick": ms,
            "settle_err_m": err, "jax_m": FIG8_COLD12_JAX,
            "bound_m": STEP1_BOUND_M,
            "bench_r05_m": BENCH_R05["fig8_cold12_settle_err_m"],
            "lin_backend": pre12.ocp.solver.lin_backend}
        log("fig8_cold12", **out["fig8_cold12"])
    elif name == "rt":
        # 19c: Jacobian reuse. bench.py's rt4 and rt4jr4 (N=20, 4
        # iterations, the fused linearizer, from a draw around hover)
        pre4 = simulation_ocp(20, solver=dataclasses.replace(
            base, qp_backend="pallas", lin_backend="fused", ipm_iters=4))
        spec4 = build_spec(pre4.ocp, yref=pre4.loop.yref, device=dev)
        x_rt = torch.as_tensor(draws(1)[0], device=dev)
        out["rt"] = {}
        for row, jr in (("rt4", 1), ("rt4jr4", 4)):
            res, ms = k1(row, RT_TICKS, loop(pre4.ocp, RT_TICKS, spec4, x_rt,
                                             jac_refresh=jr),
                         f"deployed loop {row}")
            check(finite(res.xs), "deployed loop finite", case=row)
            out["rt"][row] = {"jac_refresh": jr, "ms_per_tick": ms,
                              "launches": out["k1"][row],
                              "final_z": float(res.xs[-1, 2])}
        log("jac_reuse_deployed", N=20, iters=4, ticks=RT_TICKS,
            **out["rt"])
    elif name == "jr_n60":
        # tests/test_sqp_sim.py:207-241: the N=60 loop from the ground, A
        # and B refreshed every 4th tick, against every tick linearized
        pre60 = simulation_ocp(60)
        spec60 = build_spec(pre60.ocp, yref=pre60.loop.yref, device=dev)
        x_g = torch.as_tensor(pre60.loop.x0, dtype=torch.float32,
                              device=dev)
        loops = {row: k1(row, JR_TICKS, loop(pre60.ocp, JR_TICKS, spec60,
                                             x_g, jac_refresh=jr),
                         f"N=60 loop {row}")
                 for row, jr in (("jr_n60_full", 1), ("jr_n60_reuse", 4))}
        xf = loops["jr_n60_full"][0].xs[-1].cpu().numpy()
        xr = loops["jr_n60_reuse"][0].xs[-1].cpu().numpy()
        dz, eul = float(abs(xf[2] - xr[2])), float(np.abs(xr[3:6]).max())
        ok = bool(np.isfinite(xr).all())
        check(ok and dz < 0.1 and eul < 0.2, "the reuse loop tracks the "
              "full loop", dz_m=dz, euler_max=eul, finite=ok)
        out["jr_n60"] = {"dz_m": dz, "euler_max": eul,
                         **{k: {"ms_per_tick": v[1], "final_z": float(
                             v[0].xs[-1, 2])} for k, v in loops.items()}}
        log("jac_reuse_n60", N=60, ticks=JR_TICKS, iters=FULL_ITERS,
            **out["jr_n60"])
    elif name == "warm_jr":
        # tests/test_sqp_sim.py:264-290: N=10, 4 iterations, "primal",
        # shifted, A and B every 4th tick (K3 in PLAIN), against the cold
        # loop
        pre10 = simulation_ocp(10)
        spec10 = build_spec(pre10.ocp, yref=pre10.loop.yref, device=dev)
        x_2 = torch.zeros(17, device=dev)
        x_2[2] = 2.0
        ocp_w = dataclasses.replace(pre10.ocp, solver=dataclasses.replace(
            pre10.ocp.solver, ipm_iters=4, warm_mode="primal",
            warm_shift=True))
        res_w, ms_w = k1("warm_jr", WARM_JR_TICKS,
                         loop(ocp_w, WARM_JR_TICKS, spec10, x_2,
                              warm_start=True, jac_refresh=4),
                         "warm reuse loop",
                         **{"box_qp_solve.warm": WARM_JR_TICKS})
        res_c, ms_c = k1("warm_jr_cold_ref", WARM_JR_TICKS,
                         loop(pre10.ocp, WARM_JR_TICKS, spec10, x_2),
                         "warm reuse loop's cold reference")
        zw, zc = float(res_w.xs[-1, 2]), float(res_c.xs[-1, 2])
        ok = finite(res_w.xs, res_c.xs)
        check(ok and abs(zw - 3.5) < 0.05 and abs(zw - zc) < 0.02,
              "the warm reuse loop settles", z_m=zw, cold_z_m=zc, finite=ok)
        out["warm_jr"] = {"N": 10, "iters": 4, "ticks": WARM_JR_TICKS,
                          "warm_launches": out["k3"]["warm_jr"],
                          "ms_per_tick": ms_w, "final_z": zw,
                          "cold_ms_per_tick": ms_c, "cold_final_z": zc}
        log("warm_jac_reuse", **out["warm_jr"])
    elif name == "sqp":
        # sqp_solve at hover (tests/test_sqp_sim.py:17-50), 12 iterations
        ocp = simulation_ocp(60).ocp
        x_h = torch.zeros(17, device=dev)
        x_h[2] = 2.0
        yref = np.zeros(23)
        yref[2] = 2.0
        spec_h = build_spec(ocp, yref=yref, device=dev)
        P = BlasterParams.from_config(ocp.model, device=dev)
        F = discrete_dynamics(blaster_ode, ocp.dt)
        (best, norms), ms = k1("sqp_solve", FULL_ITERS, lambda: timed(
            lambda: R.sqp_solve(spec_h, R.init_rti_state(ocp, x_h), x_h, P,
                                F, ocp.solver, iters=FULL_ITERS), 1),
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
    else:
        raise ValueError(f"unknown phase-19 path {name!r}")
    return out


def phase19(dev, blast: dict, paths: dict) -> dict:
    """Phase 19: (a) bench.py's eight blast-scan rows on "pallas_fused" at
    12 iterations (one K6 launch per tick, the per-stage parameters of the
    online modes changing every tick), each against the JAX run and its
    bound, with the jet solves' host time (`blast_row`), and one profiler
    window; (b-c) the paths of `p19_path`. The rows and paths come from
    worker processes (`blast`: row -> its record; `paths`: path -> its
    records and launches). Returns the logged rows and the launches per
    path."""
    out = {"blast": blast, "k1": {}, "k3": {}}
    out["blast_launches"] = sum(r["launches"] for r in blast.values())
    prof_row = "blast_aggr_err_stagewise_m"
    out["blast_profile"] = device_busy(lambda: blast_scan(prof_row, 5, dev))
    log("blast_scan_profile", row=prof_row, ticks=5,
        **out["blast_profile"])
    for rec in paths.values():
        for k, v in rec.items():
            if k in ("k1", "k3"):
                out[k].update(v)
            else:
                out[k] = v
    return out


def step4_loop(row: str, dev, n: int):
    """A phase-20 row's loop of n ticks: (fn() -> its result, solver)."""
    from mpc_blaster_tpu_torch import config as cfg
    from mpc_blaster_tpu_torch.ocp.spec import build_spec
    from mpc_blaster_tpu_torch.sim import tasks as TK
    from mpc_blaster_tpu_torch.sim.closedloop import make_closed_loop
    task, warm, _ = STEP4_ROWS[row]
    solver = dataclasses.replace(cfg.simulation_preset().ocp.solver,
                                 qp_backend="pallas", **step4_fields(row))
    pre = simulation_ocp(20, solver=solver)
    if task == "fig8":
        return (lambda: TK.run_figure8(pre, n_steps=n, warm_start=warm,
                                       device=dev)), solver
    spec = build_spec(pre.ocp, yref=pre.loop.yref, device=dev)
    x_alt = torch.zeros(17, device=dev)
    x_alt[2] = 0.5
    return (lambda: make_closed_loop(pre.ocp, n, warm_start=warm)(
        spec, x_alt)), solver


def step4_row(row: str, dev) -> dict:
    """One of bench.py's seven remaining quality rows (STEP4_ROWS) on
    "pallas" with the fused linearizer at N=20, counted: the two cold rows
    launch K1 once a tick, the warm rows K3 in PLAIN once a tick, and the
    altitude row under the watchdog two warm launches a tick, the tick
    (K3) and the redo (valid=0, the cold solve: K1; it returns at once
    unless the tick tripped). The figure-8 tracking loop has no watchdog
    in either package, so fig8_warm3shiftwd runs as fig8_warm3shift does.
    The row is held to the JAX package's own float32 run (a cold row
    within STEP1_BOUND_M on both sides) or to its spread (a warm row
    within STEP1_BOUND_M of [min, max]); its value is logged beside
    BENCH_r05's, with ms per tick, the K1 and K3 launches and the
    watchdog's trips."""
    task, warm, _ = STEP4_ROWS[row]
    n = STEP4_TICKS[task]
    fn, solver = step4_loop(row, dev, n)
    guarded = warm and solver.warm_watchdog and task == "alt"
    per_tick = 2 if guarded else 1
    want = {"box_qp_solve": per_tick * n}
    if warm:
        want["box_qp_solve.warm"] = per_tick * n
    trips_ctx, trips = guarded_trips()
    with trips_ctx():
        (res, ms), c = counted(want, f"phase 20 {row}", lambda: timed(fn, n),
                               instances={"box_qp_solve[17x6]":
                                          per_tick * n})
    if task == "fig8":
        val = float(np.linalg.norm(res.xs[1:, 0:2].cpu().numpy()
                                   - res.refs[:, 0:2].cpu().numpy(),
                                   axis=1)[60:].max())
    else:
        val = float(max(res.xs[:, 2].max().item() - 3.5, 0.0))
    lo, hi = STEP4_SPREAD.get(row, (STEP4_JAX[row], STEP4_JAX[row]))
    ok = bool(torch.isfinite(res.xs).all())
    check(ok and lo - STEP1_BOUND_M <= val <= hi + STEP1_BOUND_M,
          "phase 20 row vs the JAX run", row=row, value_m=val,
          jax_m=STEP4_JAX[row], jax_spread_m=[lo, hi],
          bound_m=STEP1_BOUND_M, finite=ok)
    k3 = n if warm else 0
    r = {"row": row, "task": task, "N": 20, "ticks": n,
         "iters": solver.ipm_iters, "warm": warm,
         "warm_mode": solver.warm_mode, "warm_shift": solver.warm_shift,
         "warm_watchdog": solver.warm_watchdog, "value_m": val,
         "jax_m": STEP4_JAX[row], "jax_spread_m": [lo, hi],
         "bound_m": STEP1_BOUND_M, "bench_r05_m": BENCH_R05[row],
         "ms_per_tick": ms, "k1_launches": c["box_qp_solve"] - k3,
         "k3_launches": k3, "watchdog_trips": trips() if guarded else None}
    log("step4_row", **r)
    return r


def sweep_row(name: str, dev) -> dict:
    """One of phase 17's four sweeps (SWEEP_JAX's keys) on the simulation
    preset under deployed_solver("safe") (swapped to "pallas": one plain
    launch per tick for the whole batch), counted, held to the JAX run
    per scenario; its entry points called without device= (the card)."""
    from mpc_blaster_tpu_torch import config as cfg
    from mpc_blaster_tpu_torch.ocp.spec import build_spec
    from mpc_blaster_tpu_torch.sim import scenarios as S
    pre = cfg.simulation_preset()
    ocp = dataclasses.replace(pre.ocp, solver=cfg.deployed_solver("safe"))
    spec = build_spec(ocp, yref=pre.loop.yref)
    scen = S.sample_scenarios(batch=8, seed=1, wind_max=0.8)
    kw = dict(n_steps=SWEEP_TICKS, offset_free=name.endswith("offset_free"))
    if name.startswith("wind"):
        def fn():
            return S.disturbance_sweep(spec, ocp, scen, **kw)
    else:
        def fn():
            return S.fault_sweep(spec, ocp, FAULT_DERATE, **kw)
    (res, ms), c = counted({"box_qp_solve": SWEEP_TICKS}, f"sweep {name}",
                           lambda: timed(fn, SWEEP_TICKS),
                           instances={"box_qp_solve[17x6]": SWEEP_TICKS})
    err = res.pos_err.cpu().numpy()
    jax_err = np.asarray(SWEEP_JAX[name]["pos_err_m"])
    finite = bool(torch.isfinite(res.final_states).all())
    # a scenario the JAX run leaves more than 1 m off has diverged: where a
    # diverging loop ends is set by f32 rounding, so it is held to the JAX
    # test's criterion (> 1 m, phase 17), not to the run
    held = jax_err <= 1.0
    check(finite and res.final_states.device.type == "cuda"
          and bool((np.abs(err[held] - jax_err[held]) <= 5e-2).all()),
          "sweep vs the JAX run", case=name, pos_err=err.tolist(),
          jax=jax_err.tolist())
    r = {"B": len(err), "launches": c["box_qp_solve"], "ms_per_tick": ms,
         "pos_err_m": err.tolist(), "settled": res.settled.cpu().tolist(),
         "worst_kkt_eq": res.worst_kkt_eq.max().item(),
         "jax": SWEEP_JAX[name]}
    log("sweep", case=name, N=ocp.N, ticks=SWEEP_TICKS, iters=SAFE_ITERS,
        **r)
    return r


STEP4_SOLO_TICKS = 20   # phase 20's ticks timed alone on the card


def phase20(rows: dict, dev) -> dict:
    """Phase 20: bench.py's seven remaining quality rows, each run by
    `step4_row` in a worker process (`rows`: row -> its record), whose
    ticks share the card with the pool's other processes; each row's
    first STEP4_SOLO_TICKS ticks are timed again here, alone on the card
    (`ms_per_tick_solo`). Returns the rows and the launches per path under
    K1 and K3."""
    for row, r in rows.items():
        fn, _ = step4_loop(row, dev, STEP4_SOLO_TICKS)
        r["ms_per_tick_solo"] = timed(fn, STEP4_SOLO_TICKS)[1]
        log("step4_row_solo", row=row, ticks=STEP4_SOLO_TICKS,
            ms_per_tick=r["ms_per_tick_solo"])
    return {"rows": rows,
            "k1": {k: r["k1_launches"] for k, r in rows.items()
                   if r["k1_launches"]},
            "k3": {k: r["k3_launches"] for k, r in rows.items()
                   if r["k3_launches"]}}


WORKERS = 7        # worker processes beside the waiting main one
WORKER_TAG = "chip_smoke worker result: "
WORKER_TIMEOUT_S = 900


def worker_task(task: str, dev) -> dict:
    """One task of the worker pool, "<kind>:<name>": one of phase 17's
    sweeps ("sweep"), phase 19a's blast rows ("blast"), phase 19b-c's
    paths ("p19"), phase 20's rows ("step4") or phase 21's deep SQP
    ("deep")."""
    kind, name = task.split(":", 1)
    if kind == "deep":
        return deep_sqp_check(dev)
    return {"blast": blast_row, "step4": step4_row, "p19": p19_path,
            "sweep": sweep_row, "cond": cond_task}[kind](name, dev)


def worker(dev) -> int:
    """`python3 chip_smoke.py --worker`: run the tasks named on standard
    input, one a line, on the card with the libraries phase 1 built, each
    with its launches counted in this process; after each, print its
    record and its failed checks on a line of their own."""
    import traceback
    from mpc_blaster_tpu_torch.ops import box_qp_ipm as K
    from mpc_blaster_tpu_torch.ops import probes as P
    KERNEL_WRAPPERS.update({w: getattr(K, w) for w in WRAPPERS})
    PROBE_WRAPPERS.update({w: getattr(P, w) for w in PROBES})
    PROLOGUE_WRAPPERS["fused_lin_prologue"] = K.fused_lin_prologue
    for line in sys.stdin:
        task = line.strip()
        if not task:
            break
        FAILURES.clear()
        PROLOGUE_LAUNCHES.clear()
        try:
            r = worker_task(task, dev)
            r["timed_beside_workers"] = WORKERS - 1
            r["prologue_launches"] = dict(PROLOGUE_LAUNCHES)
        except Exception:
            r = None
            FAILURES.append({"check": "worker task ran", "task": task,
                             "error": traceback.format_exc()[-3000:]})
        print(WORKER_TAG + json.dumps({"task": task, "row": r,
                                       "failures": FAILURES}), flush=True)
    return 0


def pool_tasks() -> list:
    """The worker pool's tasks, the longest first (the eager tracking
    loops: the deep SQP, the figure-8 rows, the online blast rows, the
    sweeps), so that no long task starts last."""
    eager = [f"step4:{r}" for r in STEP4_ROWS if STEP4_ROWS[r][0] == "fig8"]
    online = [f"blast:{r}" for r in BLAST_ROWS
              if BLAST_ROWS[r][1] != "frozen"]
    rest = ([f"cond:{t}" for t in COND_TASKS]
            + [f"step4:{r}" for r in STEP4_ROWS]
            + [f"blast:{r}" for r in BLAST_ROWS]
            + [f"p19:{p}" for p in P19_PATHS])
    first = (["deep:sqp", "p19:fig8_cold12"] + eager + online
             + [f"sweep:{r}" for r in SWEEP_JAX])
    return first + [t for t in rest if t not in first]


def run_workers(tasks: list) -> dict:
    """Run the tasks in WORKERS worker processes of this script, each
    taking the next task as it finishes one (the paths are host-bound:
    each process drives its loop on its own core, the card shared); then
    print their output in task order and merge their failed checks.
    Returns {task: record}; exits if a worker or a task fails."""
    import queue
    import tempfile
    todo = queue.Queue()
    for t in tasks:
        todo.put(t)
    me = str(Path(__file__).resolve())

    def drive():
        got = []
        with tempfile.TemporaryFile("w+") as err:
            p = subprocess.Popen([sys.executable, me, "--worker"], cwd=REPO,
                                 stdin=subprocess.PIPE,
                                 stdout=subprocess.PIPE, stderr=err,
                                 text=True)
            try:
                while True:
                    try:
                        task = todo.get_nowait()
                    except queue.Empty:
                        break
                    p.stdin.write(task + "\n")
                    p.stdin.flush()
                    lines, result = [], None
                    for ln in p.stdout:
                        if ln.startswith(WORKER_TAG):
                            result = json.loads(ln[len(WORKER_TAG):])
                            break
                        lines.append(ln.rstrip("\n"))
                    got.append((task, lines, result))
                    if result is None:
                        break
            finally:
                p.stdin.close()
                try:
                    p.wait(timeout=WORKER_TIMEOUT_S)
                except subprocess.TimeoutExpired:
                    p.kill()
                    p.wait()
                err.seek(0)
                tail = err.read()[-3000:]
        return got, p.returncode, tail
    with ThreadPoolExecutor(WORKERS) as pool:
        runs = list(pool.map(lambda _: drive(), range(WORKERS)))
    by_task = {t: (lines, res) for got, _, _ in runs
               for t, lines, res in got}
    out, broken = {}, []
    for task in tasks:
        lines, res = by_task.get(task, ([], None))
        for ln in lines:
            print(ln, flush=True)
        if res is None or res["row"] is None:
            broken.append(task)
        if res is not None:
            FAILURES.extend(res["failures"])
            out[task] = res["row"]
    for got, rc, tail in runs:
        if rc:
            FAILURES.append({"check": "worker exited", "rc": rc,
                             "stderr": tail})
            broken.append(rc)
    if broken:
        report_failures()
        raise SystemExit(f"chip_smoke: {len(broken)} worker task(s) or "
                         "process(es) failed")
    return out


def pathological_states(ocp) -> np.ndarray:
    """The 16 stress states of tests/test_stress.py::_pathological_batch
    (:31-57): the origin, every state at its upper and at its lower bound,
    2x outside the position box, at the velocity and omega bounds, the
    gimbal pinned at its limits, and ten draws at 1.5x the box (+-0.5)."""
    lbx = np.asarray(ocp.bounds.lbx, np.float64)
    ubx = np.asarray(ocp.bounds.ubx, np.float64)
    rows = [np.zeros(17), ubx.copy(), lbx.copy()]
    far = np.zeros(17)
    far[0:3] = 2.0 * ubx[0:3]
    rows.append(far)
    fast = np.zeros(17)
    fast[2] = 2.0
    fast[6:9] = ubx[6:9]
    fast[9:12] = lbx[9:12]
    rows.append(fast)
    gim = np.zeros(17)
    gim[2] = 2.0
    gim[12] = ubx[12]
    gim[13] = lbx[13]
    rows.append(gim)
    rng = np.random.default_rng(0)
    for _ in range(10):
        rows.append(rng.uniform(1.5 * lbx - 0.5, 1.5 * ubx + 0.5))
    return np.stack(rows)


def flight_safety(ocp, u0, kkt_eq, bound_viol, hard=True) -> dict:
    """tests/test_stress.py:80-97's criteria on a batch of controls: u0
    finite and inside the control box with a skin of 1e-3 of its width,
    kkt_eq and bound_viol finite, and (on hard-bound paths) the far state
    (index 3) reported as a violation above 1. Returns the criteria and
    the worst excess of u0 over the box (N, and over the width)."""
    u = u0.double().cpu().numpy().reshape(-1, 6)
    lbu, ubu = np.asarray(ocp.bounds.lbu), np.asarray(ocp.bounds.ubu)
    w = ubu - lbu
    over = np.maximum(lbu - u, u - ubu)
    out = {"u0_finite": bool(np.isfinite(u).all()),
           "u0_in_box": bool((over <= 1e-3 * w).all()),
           "worst_excess_N": float(np.nan_to_num(over, nan=np.inf).max()),
           "worst_excess_rel": float(np.nan_to_num(over / w,
                                                   nan=np.inf).max()),
           "diag_finite": bool(torch.isfinite(kkt_eq).all()
                               & torch.isfinite(bound_viol).all())}
    if hard:
        out["far_bound_viol"] = float(bound_viol.reshape(-1)[3])
    out["safe"] = (out["u0_finite"] and out["u0_in_box"]
                   and out["diag_finite"]
                   and (not hard or out["far_bound_viol"] > 1.0))
    return out


# Phase 21's instantiations: name -> (the kernel, the path, the launches a
# run of the 16 states makes at the full budget). STRESS_TIMED: the
# wrapper and the index of the launch of a run that is timed (the batch,
# or the far state's: its second tick's warm launch for K3).
STRESS_CASES = {
    "k1_batched": ("K1", "batched tick on \"pallas\", B=16",
                   {"box_qp_solve": 1}),
    "k5_batched": ("K5", "batched tick on \"pallas_fused\", B=16",
                   {"batched_fused_tick": 1}),
    "k6_batched_safe": ("K6", "batched \"xla\" tick on "
                        "deployed_solver(\"safe\"), B=16",
                        {"fused_rti_solve": 1}),
    "k6_b1_safe": ("K6", "rti_step on \"safe\", each state at B=1",
                   {"fused_rti_solve": 16}),
    "k3_fastest": ("K3", "two guarded \"fastest\" ticks from each state",
                   {"fused_rti_solve": 64, "fused_rti_solve.warm": 64}),
    "k4_soft_pallas": ("K4", "rti_step_soft on \"pallas\" (position "
                       "bounds soft), each state",
                       {"box_qp_solve": 16, "box_qp_solve.soft": 16}),
    "k4_soft_fused": ("K4", "rti_step_soft on \"pallas_fused\" (position "
                      "bounds soft), each state",
                      {"fused_rti_solve": 16, "fused_rti_solve.soft": 16})}
STRESS_TIMED = {"k1_batched": ("box_qp_solve", 0),
                "k5_batched": ("batched_fused_tick", 0),
                "k6_batched_safe": ("fused_rti_solve", 0),
                "k6_b1_safe": ("fused_rti_solve", 3),
                "k3_fastest": ("fused_rti_solve", 3 * 4 + 2),
                "k4_soft_pallas": ("box_qp_solve", 3),
                "k4_soft_fused": ("fused_rti_solve", 3)}
STRESS_SOFT = dict(Zl=1e3, zl=1e2)   # phase 10's soft weights
RECOVERY_TICKS = 90                  # tests/test_stress.py:144-164
RECOVERY_X0 = (2.4, -2.4, 2.0)
RECOVERY_LAST_TICKS = 30             # the loop's last third


def recovery_checks(name: str, xs: torch.Tensor) -> dict:
    """The recovery loop from 60% outside the position box, held to
    tests/test_stress.py:160-164's bounds over the loop rather than at its
    last tick: its states finite, the vehicle inside the box (|x|, |y| <=
    1.5 + 1e-3) on some tick, and within 0.6 of z=3.5 on some tick of the
    last RECOVERY_LAST_TICKS. The loop is an underdamped transient (the
    vehicle crosses the box and overshoots beyond it within the 90 ticks)
    and which phase of it the last tick catches is set by float32
    rounding: of 32 JAX float32 runs with x0 moved by up to 4e-6 m, about
    half miss |z - 3.5| < 0.6 at the last tick, and under
    `deployed_solver("safe")` none ends inside the box, while every one
    meets these bounds (tests/test_torch_stress_bounds.py). The last-tick
    criteria are reported."""
    x = xs.cpu().double().numpy()
    inside = (np.abs(x[:, 0:2]) <= 1.5 + 1e-3).all(1)
    z_err = np.abs(x[-RECOVERY_LAST_TICKS:, 2] - 3.5)
    out = {"finite": bool(np.isfinite(x).all()),
           "first_tick_in_box": int(inside.argmax()) if inside.any() else -1,
           "z_err_min_last_ticks": float(z_err.min()),
           "end_xyz": x[-1, 0:3].tolist(),
           "end_in_box": bool(inside[-1]),
           "end_z_err": float(abs(x[-1, 2] - 3.5))}
    out["recovered"] = (out["finite"] and out["first_tick_in_box"] >= 0
                        and out["z_err_min_last_ticks"] < 0.6)
    check(out["recovered"], "recovery loop re-enters the box and heads "
          "for z=3.5", case=name, **out)
    return out


DEEP_SQP_ITERS = (20, 40)            # tests/test_stress.py:100-141
# x0's position moves (along (1, -1, 1)) of the twin's deep runs on the
# host's CPU where the kernel misses the 0.5 N criterion
DEEP_SQP_MOVES_M = tuple(k * 2.5e-7 for k in range(1, 9))


def sqp_merit(spec, st, x0, P, F) -> float:
    """`sqp/rti.py::sqp_solve`'s merit of an iterate: the true cost plus
    1e4 times the L1 dynamics defect."""
    from torch.func import vmap
    from mpc_blaster_tpu_torch.ocp.spec import total_cost
    xs_next = vmap(lambda x, u, p: F(x, u, p, P))(
        st.xbar[:-1], st.ubar, spec.stage_params)
    defect = ((xs_next - st.xbar[1:]).abs().sum()
              + (st.xbar[0] - x0).abs().sum())
    return float(total_cost(spec, st.xbar, st.ubar) + 1e4 * defect)


def deep_sqp(dev, move: float = 0.0) -> dict:
    """tests/test_stress.py:100-141's deep budget on `dev`: `sqp_solve`
    for 20 and for 40 iterations from the velocity-bound stress state,
    its position moved by `move` along (1, -1, 1) (N=20, the preset's
    solver on "pallas"); its float32 criteria and the two best iterates'
    merits."""
    from mpc_blaster_tpu_torch.dynamics.blaster import (BlasterParams,
                                                        blaster_ode)
    from mpc_blaster_tpu_torch.dynamics.integrators import discrete_dynamics
    from mpc_blaster_tpu_torch.ocp.spec import build_spec
    from mpc_blaster_tpu_torch.sqp import rti as R
    pre = simulation_ocp(20)
    ocp = pre.ocp
    spec = build_spec(ocp, yref=pre.loop.yref, device=dev)
    P = BlasterParams.from_config(ocp.model, device=dev)
    F = discrete_dynamics(blaster_ode, ocp.dt)
    x_v = torch.as_tensor(pathological_states(ocp)[4], dtype=torch.float32,
                          device=dev)
    x_v[0:3] += torch.tensor([1.0, -1.0, 1.0], device=dev) * move
    st0 = R.init_rti_state(ocp, x_v)
    n_short, n_deep = DEEP_SQP_ITERS
    short, _ = R.sqp_solve(spec, st0, x_v, P, F, ocp.solver, iters=n_short)
    deep, norms = R.sqp_solve(spec, st0, x_v, P, F, ocp.solver,
                              iters=n_deep)
    nm = norms.cpu().numpy()
    out = {"move_m": move, "finite": bool(torch.isfinite(deep.ubar).all()),
           "thrust_gap_N": float((deep.ubar[:, :4].double()
                                  - short.ubar[:, :4].double()).abs().max()),
           "step_norm_max": float(nm.max()),
           "step_norm_first": float(nm[0]),
           "norms_bounded": bool(nm.max() < 10.0 * max(nm[0], 1.0)),
           "merit_short": sqp_merit(spec, short, x_v, P, F),
           "merit_deep": sqp_merit(spec, deep, x_v, P, F)}
    return out


def stress_case(name: str, dev, iters=None, start=None) -> dict:
    """Run one phase-21 instantiation on the 16 stress states (N=20,
    Tf=20/30, float32, the preset's yref) on `dev`, with the solver's
    budget, or `iters` IPM iterations where given (for K3: the second
    tick alone, warm from `start`, the first ticks `k3_first_ticks`
    returns). Returns u0 (every tick's), the new iterates and the
    diagnostics, stacked over the states."""
    from mpc_blaster_tpu_torch import config as cfg
    from mpc_blaster_tpu_torch.dynamics.blaster import (BlasterParams,
                                                        blaster_ode)
    from mpc_blaster_tpu_torch.dynamics.integrators import discrete_dynamics
    from mpc_blaster_tpu_torch.ocp.spec import build_spec
    from mpc_blaster_tpu_torch.parallel.mesh import batched_rti_step
    from mpc_blaster_tpu_torch.qp.soft import SoftBounds
    from mpc_blaster_tpu_torch.sqp import rti as R
    pre = simulation_ocp(20)
    solver = {"k1_batched": pre.ocp.solver, "k5_batched": pre.ocp.solver,
              "k6_batched_safe": cfg.deployed_solver("safe"),
              "k6_b1_safe": cfg.deployed_solver("safe"),
              "k3_fastest": cfg.deployed_solver("fastest"),
              "k4_soft_pallas": dataclasses.replace(
                  pre.ocp.solver, lin_backend="fused", ipm_iters=SAFE_ITERS),
              "k4_soft_fused": cfg.deployed_solver("safe")}[name]
    if iters is not None and name != "k3_fastest":
        solver = dataclasses.replace(solver, ipm_iters=iters)
    ocp = dataclasses.replace(pre.ocp, solver=solver)
    spec = build_spec(ocp, yref=pre.loop.yref, device=dev)
    x0s = torch.as_tensor(pathological_states(ocp), dtype=torch.float32,
                          device=dev)
    if name in ("k1_batched", "k5_batched", "k6_batched_safe"):
        backend = {"k1_batched": "pallas", "k5_batched": "pallas_fused",
                   "k6_batched_safe": "xla"}[name]
        u0, st, dg = batched_rti_step(ocp, backend=backend, device=dev)(
            spec, R.init_rti_state(ocp, x0s), x0s)
        return {"u0": u0, "xbar": st.xbar, "ubar": st.ubar,
                "kkt_eq": dg.qp_kkt_eq, "bound_viol": dg.bound_viol}
    P = BlasterParams.from_config(ocp.model, device=dev)
    F = discrete_dynamics(blaster_ode, ocp.dt)
    dyn = R.fused_dyn_statics(ocp)
    lin = R.make_linearizer(ocp, P)
    soft = SoftBounds.state_bounds(ocp.N, 17, 6, **STRESS_SOFT,
                                   idx=[0, 1, 2], device=dev)
    if name == "k3_fastest" and iters is None:
        first = k3_first_ticks(dev)
    rows = []
    for j, x in enumerate(x0s):
        st = R.init_rti_state(ocp, x)
        if name == "k6_b1_safe":
            u0, st, dg = R.rti_step(spec, st, x, P, F, solver,
                                    dyn_statics=dyn)
            u0s = u0[None]
        elif name.startswith("k4"):
            u0, st, dg, _ = R.rti_step_soft(spec, st, x, P, F, solver, soft,
                                            linearizer=lin, dyn_statics=dyn)
            u0s = u0[None]
        elif iters is None:   # k3_fastest: a second guarded tick
            st, warm, wd, x1, u0a, dg = first[j]
            u0b, st, _, _, dg2 = R.rti_step_warm_guarded(
                spec, st, warm, wd, x1, P, F, solver, dyn_statics=dyn)
            u0s = torch.stack([u0a, u0b])
            dg = dg._replace(
                qp_kkt_eq=torch.stack([dg.qp_kkt_eq, dg2.qp_kkt_eq]),
                bound_viol=torch.stack([dg.bound_viol, dg2.bound_viol]))
        else:   # k3_fastest's second tick alone, unguarded, from `start`
            st, warm, _, x1 = (t.to(dev) if torch.is_tensor(t) else
                               type(t)(*(f.to(dev) for f in t))
                               for t in start[j][:4])
            one = dataclasses.replace(solver, ipm_iters=iters)
            u0b, st, _, dg = R.rti_step_warm(spec, st, warm, x1, P, F, one,
                                             dyn_statics=dyn)
            u0s = u0b[None]
        rows.append((u0s, st.xbar, st.ubar, dg.qp_kkt_eq, dg.bound_viol))
    u0, xbar, ubar, eq, bv = (torch.stack(t) for t in zip(*rows))
    # the far state's violation on its first tick (index 3 of the batch)
    return {"u0": u0, "xbar": xbar, "ubar": ubar, "kkt_eq": eq,
            "bound_viol": bv.reshape(16, -1)[:, 0].contiguous(),
            "bound_viol_all": bv}


def k3_first_ticks(dev) -> list:
    """The first guarded "fastest" tick from each stress state: per state
    (iterate, warm start, watchdog state, the plant's next state, u0, the
    tick's diagnostics)."""
    from mpc_blaster_tpu_torch import config as cfg
    from mpc_blaster_tpu_torch.dynamics.blaster import (BlasterParams,
                                                        blaster_ode)
    from mpc_blaster_tpu_torch.dynamics.integrators import discrete_dynamics
    from mpc_blaster_tpu_torch.ocp.spec import build_spec
    from mpc_blaster_tpu_torch.qp.ipm import IpmWarmStart
    from mpc_blaster_tpu_torch.sqp import rti as R
    pre = simulation_ocp(20, solver=cfg.deployed_solver("fastest"))
    ocp = pre.ocp
    spec = build_spec(ocp, yref=pre.loop.yref, device=dev)
    P = BlasterParams.from_config(ocp.model, device=dev)
    F = discrete_dynamics(blaster_ode, ocp.dt)
    out = []
    for x in torch.as_tensor(pathological_states(ocp), dtype=torch.float32,
                             device=dev):
        u0, st, warm, wd, dg = R.rti_step_warm_guarded(
            spec, R.init_rti_state(ocp, x),
            IpmWarmStart.zeros(ocp.N, 17, 6, device=dev),
            R.WatchdogState.init(device=dev), x, P, F, ocp.solver,
            dyn_statics=R.fused_dyn_statics(ocp))
        # the plant's RK4 takes the vehicle to the second tick's state
        out.append((st, warm, wd, F(x, u0, spec.stage_params[0], P), u0,
                    dg))
    return out


class _Captured(Exception):
    pass


def capture_launch(wrapper: str, index: int, fn) -> dict:
    """The arguments of the index-th call of a kernel wrapper of
    `ops/box_qp_ipm.py` that fn() makes: the calls before it run the
    wrapper's plain twin (no launch), and fn stops at that call. The
    ticks run eagerly (`capture.disable_jit`)."""
    from mpc_blaster_tpu_torch.ops import box_qp_ipm as K
    from mpc_blaster_tpu_torch.utils import capture
    orig, seen, calls = getattr(K, wrapper), {}, [0]

    def hook(*a, **kw):
        if calls[0] == index:
            seen["args"], seen["kwargs"] = a, kw
            raise _Captured
        calls[0] += 1
        return getattr(K, wrapper + "_plain")(*a, **kw)
    setattr(K, wrapper, hook)
    try:
        with capture.disable_jit():
            fn()
    except _Captured:
        pass
    finally:
        setattr(K, wrapper, orig)
    return seen


def time_captured(wrapper: str, seen: dict) -> dict:
    """The captured launch timed again on the card (CUDA events over 10
    launches) and its twin once, with the launch's iterations."""
    from mpc_blaster_tpu_torch.ops import box_qp_ipm as K
    a, kw = seen["args"], dict(seen["kwargs"])
    kw.pop("skip", None)
    twin = getattr(K, wrapper + "_plain")
    return {"kernel_ms": cuda_ms(lambda: getattr(K, wrapper)(*a, **kw), 10),
            "plain_ms": timed(lambda: twin(*a, **kw), 1)[1],
            "iters": kw.get("iters"), "warm": kw.get("warm") is not None,
            "soft": kw.get("soft") is not None}


def stress_gaps(a: dict, b: dict) -> tuple:
    """Per state, the largest |u0| gap and the largest gap of the new
    iterate (xbar, ubar) between two runs of a case."""
    u = (a["u0"] - b["u0"]).abs().reshape(16, -1).amax(1)
    it = torch.maximum((a["xbar"] - b["xbar"]).abs().reshape(16, -1).amax(1),
                       (a["ubar"] - b["ubar"]).abs().reshape(16, -1).amax(1))
    return u, it


def deep_sqp_check(dev) -> dict:
    """Phase 21's deep SQP budget on K1 from the velocity-bound state,
    counted, with tests/test_stress.py:100-141's float32 criteria. In
    float32 the raw iterates limit-cycle, and whether the best of 20
    iterations is the best of 40 is set by rounding: the twin on the CPU,
    started 7.5e-7 m away, parts by 1.6 N (its merit 8211 -> 8161;
    measured on the CPU). So where the kernel parts by 0.5 N or more, the
    twin runs on the host's CPU from x0 moved by DEEP_SQP_MOVES_M, until
    one run parts as far; the kernel passes if one does and its deep
    merit is no worse than the twin's best by 1e-3 relative."""
    n_short, n_deep = DEEP_SQP_ITERS
    deep, c = counted({"box_qp_solve": n_short + n_deep},
                      "phase 21 deep sqp_solve", lambda: deep_sqp(dev))
    out = {"iters": list(DEEP_SQP_ITERS), "launches": c["box_qp_solve"],
           **deep}
    ok = deep["thrust_gap_N"] < 0.5
    if not ok:
        twin = []
        for m in DEEP_SQP_MOVES_M:
            twin.append(deep_sqp(torch.device("cpu"), m))
            if twin[-1]["thrust_gap_N"] >= 0.5:
                break
        best = min(t["merit_deep"] for t in twin)
        ok = (twin[-1]["thrust_gap_N"] >= 0.5
              and deep["merit_deep"] <= best * (1 + 1e-3))
        out["twin_cpu_moved"] = twin
    check(deep["finite"] and deep["norms_bounded"] and ok,
          "deep sqp_solve stable", **out)
    log("stress_deep_sqp", **out)
    return out


def phase21(dev, counted, deep: dict) -> dict:
    """Phase 21: the 16 stress states through every 17x6 IPM instantiation
    a deployed path launches (STRESS_CASES), each path with the counts at
    0. Each run at its budget meets tests/test_stress.py's criteria
    (`flight_safety`). Each is also run at one IPM iteration with the
    kernel and with its twin on the card and held by phase 2's rule (u0
    within 2e-3, the new iterate within 5e-3); where a state breaks it the
    twin also runs on the host's CPU, and the check fails only if the CPU
    twin meets the rule there (float32 rounding alone does not move the
    solve as far as the kernel). Then the recovery loop (RECOVERY_TICKS
    from RECOVERY_X0) on K1 ("pallas") and K6 ("safe"), held by
    `recovery_checks`. The deep `sqp_solve` on K1 ran in the worker pool
    (`deep_sqp_check`, its record `deep`). Returns the rows and the
    launches per path."""
    from mpc_blaster_tpu_torch import config as cfg
    from mpc_blaster_tpu_torch.ocp.spec import build_spec
    from mpc_blaster_tpu_torch.sim.closedloop import closed_loop
    out = {"cases": {}, "launches": {}}
    cpu = torch.device("cpu")
    for name, (kernel, path, want) in STRESS_CASES.items():
        res, c = counted(want, f"phase 21 {name}",
                         lambda name=name: stress_case(name, dev))
        seen = capture_launch(*STRESS_TIMED[name],
                              lambda name=name: stress_case(name, dev))
        crit = flight_safety(simulation_ocp(20).ocp, res["u0"],
                             res["kkt_eq"], res["bound_viol"],
                             hard=kernel != "K4")
        check(crit["safe"], "stress states flight safe", case=name, **crit)
        start = k3_first_ticks(dev) if name == "k3_fastest" else None
        k1 = stress_case(name, dev, iters=1, start=start)
        with plain_twins():
            t1 = stress_case(name, dev, iters=1, start=start)
        torch.cuda.synchronize()
        gu, gi = stress_gaps(k1, t1)
        bad = ((gu > 2e-3) | (gi > 5e-3)).nonzero().flatten().tolist()
        row = {"case": name, "kernel": kernel, "path": path,
               "launches": c, **crit,
               "timed_launch": time_captured(STRESS_TIMED[name][0], seen),
               "gap_1it_u0": gu.max().item(), "gap_1it_iterate":
               gi.max().item(), "agree_1it": not bad}
        if bad:
            h1 = stress_case(name, cpu, iters=1, start=start)
            h1 = {k: v.to(dev) for k, v in h1.items()}
            hu, hi = stress_gaps(h1, t1)
            host_ok = [(hu[j] <= 2e-3 and hi[j] <= 5e-3).item()
                       for j in bad]
            row.update(states_off_1it=bad,
                       kernel_gap_u0=[gu[j].item() for j in bad],
                       kernel_gap_iterate=[gi[j].item() for j in bad],
                       twin_cpu_gap_u0=[hu[j].item() for j in bad],
                       twin_cpu_gap_iterate=[hi[j].item() for j in bad])
            check(not any(host_ok), "one-iteration parity on stress "
                  "states (the CPU twin meets the rule where the kernel "
                  "does not)", case=name,
                  states=[j for j, h in zip(bad, host_ok) if h])
        out["cases"][name] = row
        out["launches"][name] = c
        log("stress_case", **row)
    # the recovery loop from 60% outside the position box
    pre = simulation_ocp(20)
    spec = build_spec(pre.ocp, yref=pre.loop.yref, device=dev)
    x_out = torch.zeros(17, device=dev)
    x_out[0:3] = torch.tensor(RECOVERY_X0)
    out["recovery"] = {}
    for name, solver, wrapper in (
            ("k1_pallas", pre.ocp.solver, "box_qp_solve"),
            ("k6_safe", cfg.deployed_solver("safe"), "fused_rti_solve")):
        ocp = dataclasses.replace(pre.ocp, solver=solver)
        (res, ms), c = counted(
            {wrapper: RECOVERY_TICKS}, f"phase 21 recovery {name}",
            lambda ocp=ocp: timed(lambda: closed_loop(
                spec, ocp, x_out, n_steps=RECOVERY_TICKS),
                RECOVERY_TICKS))
        r = {"iters": solver.ipm_iters, "launches": c[wrapper],
             "ms_per_tick": ms, **recovery_checks(name, res.xs)}
        out["recovery"][name] = r
        out["launches"][f"recovery_{name}"] = c[wrapper]
        log("stress_recovery", case=name, ticks=RECOVERY_TICKS, **r)
    # the deep SQP budget on K1, run in the worker pool (`deep_sqp_check`)
    out["deep_sqp"] = deep
    out["launches"]["deep_sqp"] = deep["launches"]
    return out


# ---- phase 22: the solvers off the main path, the sharded tick and
# sweep, a process group on the card, the utilities ----
RICCATI_MODES = ("scan", "pscan", "hybrid", "sqrt")
COND_M = 5          # condensing block (the presets' cond_M)
TIMED_ROUNDS = 2    # 22a / 22b: timed calls of each solve after a warm-up
COND_LOOP_TICKS = 15   # tests/test_condense.py's closed loop
COND_SIM_TICKS = 3     # the simulation preset on "condensed", as phase 9
SWEEP22_B = 256     # the sharded sweep's scenarios
SWEEP22_TICKS = 20
SWEEP22_CL = 4          # scenarios held to the unbatched closed_loop
SWEEP22_CL_TOL = 1e-2   # m, their final positions (f32, 20 ticks)
COND_LOOP_TOL = {"f64": 1.5e-2, "f32": 2e-2}


def random_qp(N=8, nx=5, nu=3, seed=0, bound_scale=np.inf, dev=None,
              dtype=torch.float64):
    """tests/test_qp.py::random_qp's QP (the same numpy draws) as the
    port's QPData on `dev`."""
    from mpc_blaster_tpu_torch.convert import qp_from_numpy
    rng = np.random.default_rng(seed)
    A = rng.uniform(-0.5, 0.5, (N, nx, nx)) + np.eye(nx) * 0.8
    B = rng.uniform(-0.5, 0.5, (N, nx, nu))
    c = rng.uniform(-0.1, 0.1, (N, nx))

    def spd(n, scale):
        M = rng.uniform(-1, 1, (n, n))
        return M @ M.T + scale * np.eye(n)
    Q = np.stack([spd(nx, 1.0) for _ in range(N + 1)])
    R = np.stack([spd(nu, 1.0) for _ in range(N)])
    q = rng.uniform(-1, 1, (N + 1, nx))
    r = rng.uniform(-1, 1, (N, nu))
    dx0 = rng.uniform(-0.3, 0.3, nx)
    box = dict(lbx=np.full((N + 1, nx), -bound_scale),
               ubx=np.full((N + 1, nx), bound_scale),
               lbu=np.full((N, nu), -bound_scale),
               ubu=np.full((N, nu), bound_scale))
    return qp_from_numpy(dict(A=A, B=B, c=c, Q=Q, q=q, R=R, r=r, dx0=dx0,
                              **box), dtype=dtype, device=dev)


def riccati_modes(dev) -> dict:
    """Phase 22a: `box_qp_solve(riccati=...)` in each inner-solver mode on
    the card. The simulation preset's QP at N=60 (float32, 12 iterations):
    each mode's objective within rel 1e-5 of "scan"'s and kkt_eq < 1e-4
    (past the first iterations f32 solvers agree on the objective, not
    pointwise). tests/test_pscan.py:76-97's QP in float64 (the dtype that
    test runs in), with its criteria: du within rtol 1e-3 / atol 5e-4 of
    "scan", the objective within rtol 1e-5 / atol 1e-7, kkt_eq < 1e-4.
    `lqr_solve_pscan` at N=64 (float64) against `lqr_solve`, rtol 1e-6 /
    atol 1e-7 (tests/test_pscan.py's sharded case, on one device). Each
    solve is warmed up once and timed in TIMED_ROUNDS rounds, the modes
    taking turns (eager PyTorch: launch-bound); "ms" is the least."""
    from mpc_blaster_tpu_torch.qp.data import QPData, qp_objective
    from mpc_blaster_tpu_torch.qp.ipm import box_qp_solve
    from mpc_blaster_tpu_torch.qp.pscan import lqr_solve_pscan
    from mpc_blaster_tpu_torch.qp.riccati import lqr_solve
    out = {}
    for case, qp, iters in (
            ("blaster_n60_f32", blaster_qps(60, 1, dev), FULL_ITERS),
            ("random_n12_f64", random_qp(N=12, nx=5, nu=3, seed=9,
                                         bound_scale=0.3, dev=dev), 20)):
        q64 = QPData(*(x.double() for x in qp))
        sols, rounds = timed_rounds(
            {m: (lambda m=m: box_qp_solve(qp, iters=iters, riccati=m))
             for m in RICCATI_MODES}, TIMED_ROUNDS)
        ms = {m: min(v) for m, v in rounds.items()}
        obj = {m: float(qp_objective(q64, s.dx.double(), s.du.double()))
               for m, s in sols.items()}
        row = {"iters": iters, "ms": ms, "ms_rounds": rounds,
               "objective": obj,
               "kkt_eq": {m: float(s.kkt_eq.max()) for m, s in
                          sols.items()},
               "du_gap": {m: float((s.du - sols["scan"].du).abs().max())
                          for m, s in sols.items()}}
        for m in RICCATI_MODES[1:]:
            s, ref = sols[m], sols["scan"]
            check(all(bool(torch.isfinite(getattr(s, f)).all())
                      for f in ("dx", "du", "kkt_eq")), "riccati mode finite",
                  case=case, mode=m)
            check(row["kkt_eq"][m] < 1e-4, "riccati mode kkt_eq", case=case,
                  mode=m, kkt_eq=row["kkt_eq"][m])
            if case.startswith("random"):
                check(bool(torch.allclose(s.du, ref.du, rtol=1e-3,
                                          atol=5e-4)),
                      "riccati mode du", case=case, mode=m,
                      gap=row["du_gap"][m])
                check(abs(obj[m] - obj["scan"])
                      <= 1e-7 + 1e-5 * abs(obj["scan"]),
                      "riccati mode objective", case=case, mode=m, **obj)
            else:
                check(abs(obj[m] - obj["scan"]) <= 1e-5 * abs(obj["scan"]),
                      "riccati mode objective", case=case, mode=m, **obj)
        out[case] = row
        log("riccati_modes", case=case, **row)
    qp = random_qp(N=64, nx=4, nu=2, seed=5, dev=dev)
    sols, rounds = timed_rounds({"pscan": lambda: lqr_solve_pscan(qp),
                                 "sequential": lambda: lqr_solve(qp)},
                                TIMED_ROUNDS)
    par, seq = sols["pscan"], sols["sequential"]
    ms_par, ms_seq = min(rounds["pscan"]), min(rounds["sequential"])
    gap = float((par.du - seq.du).abs().max())
    check(bool(torch.allclose(par.du, seq.du, rtol=1e-6, atol=1e-7)),
          "lqr_solve_pscan N=64", gap=gap)
    out["lqr_pscan_n64_f64"] = {"ms_pscan": ms_par, "ms_sequential": ms_seq,
                                "ms_rounds": rounds, "du_gap": gap}
    log("lqr_pscan", N=64, **out["lqr_pscan_n64_f64"])
    return out


def condense_qp(dtype, dev):
    """tests/test_condense.py:143-177's QP: the simulation preset's first
    RTI QP (N=60) from hover at z=2 toward (0.4, 0, 3)."""
    from mpc_blaster_tpu_torch import config as cfg
    from mpc_blaster_tpu_torch.dynamics.blaster import (BlasterParams,
                                                        blaster_ode)
    from mpc_blaster_tpu_torch.dynamics.integrators import discrete_dynamics
    from mpc_blaster_tpu_torch.ocp.spec import build_spec
    from mpc_blaster_tpu_torch.sqp.rti import build_qp, init_rti_state
    ocp = cfg.simulation_preset().ocp
    x0 = torch.zeros(17, dtype=dtype, device=dev)
    x0[2] = 2.0
    yref = np.zeros(cfg.NY)
    yref[:3] = (0.4, 0.0, 3.0)
    spec = build_spec(ocp, yref=yref, dtype=dtype, device=dev)
    params = BlasterParams.from_config(ocp.model, dtype, dev)
    F = discrete_dynamics(blaster_ode, ocp.dt, num_steps=1)
    return build_qp(spec, init_rti_state(ocp, x0, dtype), x0, F, params)


def condensed_qp_check(dev) -> dict:
    """Phase 22b: `condensed_qp_solve(M=5)` (25 iterations) on the N=60 QP
    in float64 (plain Riccati core) and float32 (square-root core, the
    f32 default). float64 meets tests/test_condense.py's criteria against
    the float64 Riccati IPM (objective within rel 1e-5, du[:, :4] within
    0.3 N, kkt_eq < 1e-6); float32 is held to the float64 condensed
    objective within rel 5e-3 (the JAX docstring measured 0.12%). The
    three solves are warmed up once and timed in TIMED_ROUNDS rounds,
    taking turns; each "ms_*" is the least."""
    from mpc_blaster_tpu_torch.qp.condense import condensed_qp_solve
    from mpc_blaster_tpu_torch.qp.data import qp_objective
    from mpc_blaster_tpu_torch.qp.ipm import box_qp_solve
    q64, q32 = condense_qp(torch.float64, dev), condense_qp(torch.float32,
                                                            dev)
    sols, rounds = timed_rounds(
        {"riccati_f64": lambda: box_qp_solve(q64, iters=25),
         "condensed_f64": lambda: condensed_qp_solve(q64, M=COND_M,
                                                     iters=25),
         "condensed_f32": lambda: condensed_qp_solve(q32, M=COND_M,
                                                     iters=25)},
        TIMED_ROUNDS)
    ref, s64, s32 = (sols["riccati_f64"], sols["condensed_f64"],
                     sols["condensed_f32"])
    ms_ref, ms64, ms32 = (min(rounds[k]) for k in
                          ("riccati_f64", "condensed_f64", "condensed_f32"))
    o_ref = float(qp_objective(q64, ref.dx, ref.du))
    o64 = float(qp_objective(q64, s64.dx, s64.du))
    o32 = float(qp_objective(q64, s32.dx.double(), s32.du.double()))
    row = {"N": 60, "M": COND_M, "iters": 25, "objective_riccati": o_ref,
           "objective_f64": o64, "objective_f32": o32,
           "obj_rel_f64": abs(o64 - o_ref) / abs(o_ref),
           "obj_rel_f32": abs(o32 - o64) / abs(o64),
           "du4_gap_f64": float((s64.du[:, :4] - ref.du[:, :4]).abs().max()),
           "kkt_eq_f64": float(s64.kkt_eq), "kkt_eq_f32": float(s32.kkt_eq),
           "ms_riccati_f64": ms_ref, "ms_f64": ms64, "ms_f32": ms32,
           "ms_rounds": rounds}
    check(row["obj_rel_f64"] <= 1e-5, "condensed f64 objective", **row)
    check(row["du4_gap_f64"] <= 0.3, "condensed f64 du[:, :4]", **row)
    check(row["kkt_eq_f64"] < 1e-6, "condensed f64 kkt_eq", **row)
    check(row["obj_rel_f32"] <= 5e-3 and np.isfinite(o32),
          "condensed f32 objective", **row)
    log("condensed_qp", **row)
    return row


def cond_task(name: str, dev) -> dict:
    """A phase-22c path in the worker pool: tests/test_condense.py's hover
    closed loop (the simulation preset at N=30, Tf 1 s, 15 ticks, no POC)
    on the float64 "riccati" reference ("riccati30") or on "condensed"
    with M=5 in float64 / float32 ("cond30_f64", "cond30_f32"); or the
    simulation preset at N=60 on "condensed", 3 ticks with the POC
    ("sim60", timed like phase 9). No kernel runs: the counts stay 0."""
    from mpc_blaster_tpu_torch import config as cfg
    from mpc_blaster_tpu_torch.sim.closedloop import run_preset
    pre = cfg.simulation_preset()
    cond = dataclasses.replace(pre.ocp.solver, qp_backend="condensed",
                               cond_M=COND_M)
    if name == "sim60":
        pc = dataclasses.replace(pre, ocp=dataclasses.replace(pre.ocp,
                                                              solver=cond))
        (res, ms), c = counted({}, "phase 22c condensed N=60", lambda:
                               timed_closed_loop(pc, COND_SIM_TICKS, dev))
        ok = bool(torch.isfinite(res.xs).all() & torch.isfinite(res.us).all())
        check(ok, "condensed N=60 loop finite")
        return {"N": 60, "ticks": COND_SIM_TICKS, "ms_per_tick": ms,
                "final_z": float(res.xs[-1, 2]), "finite": ok}
    ocp = dataclasses.replace(pre.ocp, N=30, Tf=1.0)
    if name != "riccati30":
        ocp = dataclasses.replace(ocp, solver=cond)
    dtype = torch.float32 if name.endswith("f32") else torch.float64
    pc = dataclasses.replace(pre, ocp=ocp)
    (res, ms), c = counted({}, f"phase 22c {name}", lambda: timed(
        lambda: run_preset(pc, n_steps=COND_LOOP_TICKS, with_poc=False,
                           dtype=dtype, device=dev), COND_LOOP_TICKS))
    ok = bool(torch.isfinite(res.xs).all())
    check(ok, "condensed loop finite", path=name)
    return {"N": 30, "ticks": COND_LOOP_TICKS, "ms_per_tick": ms,
            "finite": ok, "xs": res.xs.double().cpu().tolist()}


COND_TASKS = ("riccati30", "cond30_f64", "cond30_f32", "sim60")


def cond_loops(rows: dict) -> dict:
    """Phase 22c's checks on the pool's records: each condensed N=30 loop's
    vehicle states (x[0:12]) within 1.5e-2 (f64) / 2e-2 (f32) of the f64
    "riccati" loop's (tests/test_condense.py's criteria)."""
    ref = np.asarray(rows["riccati30"]["xs"])
    out = {"ms_per_tick": {k: r["ms_per_tick"] for k, r in rows.items()}}
    for prec in ("f64", "f32"):
        xs = np.asarray(rows[f"cond30_{prec}"]["xs"])
        gap = float(np.abs(xs[:, :12] - ref[:, :12]).max())
        out[f"state_gap_{prec}"] = gap
        check(gap <= COND_LOOP_TOL[prec], "condensed closed loop tracks the "
              "riccati loop", precision=prec, gap=gap,
              bound=COND_LOOP_TOL[prec])
    out["sim60_final_z"] = rows["sim60"]["final_z"]
    log("condensed_loops", **out)
    return out


def _free_port() -> int:
    import socket
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def phase22(dev, K, counted) -> dict:
    """Phase 22a-b and d-f (22c's loops ran in the worker pool): the
    Riccati modes, one condensed QP, the sharded tick on K1 ("pallas") and
    on K6 over a batch (`deployed_solver("safe")`) against the batched
    tick, the sharded sweep (K6 at N=60, B=256, held to its twin at that
    shape here), the tick again under a one-rank NCCL process group, and
    the utilities (`device_time` against `cuda_ms`, `trace`). Returns the
    rows and the kernel launches per path."""
    import os
    import torch.distributed as dist
    from mpc_blaster_tpu_torch import config as cfg
    from mpc_blaster_tpu_torch.ocp.spec import build_spec
    from mpc_blaster_tpu_torch.parallel import (batched_rti_step, make_mesh,
                                                sharded_rti_step,
                                                sharded_sweep)
    from mpc_blaster_tpu_torch.parallel.distributed import initialize
    from mpc_blaster_tpu_torch.sim.closedloop import closed_loop
    from mpc_blaster_tpu_torch.sqp.rti import init_rti_state
    from mpc_blaster_tpu_torch.utils.profiling import trace
    from mpc_blaster_tpu_torch.utils.timing import device_time
    out = {"launches": {}}
    out["riccati_modes"] = counted({}, "phase 22a riccati modes",
                                   lambda: riccati_modes(dev))[0]
    wall("22a riccati modes")
    out["condensed_qp"] = counted({}, "phase 22b condensed QP",
                                  lambda: condensed_qp_check(dev))[0]
    wall("22b condensed QP")

    # 22d: the sharded tick on the card's mesh against the batched tick
    mesh = make_mesh()
    check(mesh.devices == (torch.device("cuda", 0),), "make_mesh() is the "
          "card", devices=[str(d) for d in mesh.devices])
    pre20 = simulation_ocp(20)
    spec20 = build_spec(pre20.ocp, yref=pre20.loop.yref, device=dev)
    x0s = torch.as_tensor(draws(BATCH), device=dev)
    ticks = {}
    for name, ocp, wrapper in (
            ("k1_pallas", pre20.ocp, "box_qp_solve"),
            ("k6_safe", simulation_ocp(20, solver=cfg.deployed_solver(
                "safe")).ocp, "fused_rti_solve")):
        states = init_rti_state(ocp, x0s)
        sstep = sharded_rti_step(ocp, mesh)
        (u_s, st_s, mean_s, worst_s), c = counted(
            {wrapper: 1}, f"phase 22d sharded tick {name}",
            lambda: sstep(spec20, states, x0s))
        (u_b, st_b, d_b), _ = counted(
            {wrapper: 1}, f"phase 22d batched tick {name}",
            lambda: batched_rti_step(ocp, device=dev)(spec20, states, x0s))
        same = (torch.equal(u_s, u_b) and torch.equal(st_s.xbar, st_b.xbar)
                and torch.equal(st_s.ubar, st_b.ubar))
        mean_b = d_b.step_norm_u.mean()
        worst_b = d_b.qp_kkt_stat.amax()
        row = {"N": 20, "B": BATCH, "wrapper": wrapper,
               "launches": c[wrapper], "equal_to_batched": same,
               "mean_step": float(mean_s), "worst_kkt": float(worst_s),
               "batched_mean_step": float(mean_b),
               "batched_worst_kkt": float(worst_b),
               "kernel_vs_twin_at_this_shape":
                   "phase 2 n20_b1024" if wrapper == "box_qp_solve"
                   else "phase 16 n20_b1024"}
        check(same, "sharded tick equals the batched tick", case=name)
        check(bool(mean_s == mean_b) and bool(worst_s == worst_b),
              "sharded reductions equal the batch's mean and max", **row)
        out[f"sharded_{name}"] = row
        out["launches"][f"phase22_sharded_{name}"] = c[wrapper]
        ticks[name] = (ocp, sstep, states, u_s, mean_s, worst_s)
        log("sharded_tick", case=name, **row)
    # the sweep's kernel shape (K6 over a batch at N=60, B=256) vs its twin
    sw_row = compare_fuse_lin_batched(f"n60_b{SWEEP22_B}", 60, SWEEP22_B,
                                      dev, K, 25, time_iters=(SAFE_ITERS,))
    log("fuse_lin_batched_vs_plain", **sw_row)
    out["sweep_kernel_row"] = sw_row
    pre60 = simulation_ocp(60, solver=cfg.deployed_solver("safe"))
    spec60 = build_spec(pre60.ocp, yref=pre60.loop.yref, device=dev)
    sweep = sharded_sweep(pre60.ocp, mesh, n_steps=SWEEP22_TICKS)
    x0w = torch.as_tensor(draws(SWEEP22_B, seed=22), device=dev)
    ((finals, u0w, mean_err, worst_kkt), ms), c = counted(
        {"fused_rti_solve": SWEEP22_TICKS}, "phase 22d sharded sweep",
        lambda: timed(lambda: sweep(spec60, x0w), SWEEP22_TICKS))
    sw = {"N": 60, "B": SWEEP22_B, "ticks": SWEEP22_TICKS,
          "launches": c["fused_rti_solve"], "ms_per_tick": ms,
          "solves_per_s": SWEEP22_B * 1000.0 / ms,
          "mean_err_m": float(mean_err), "worst_kkt_eq": float(worst_kkt),
          "finite": bool(torch.isfinite(finals).all()
                         & torch.isfinite(u0w).all())}
    check(sw["finite"] and np.isfinite(sw["mean_err_m"]), "sharded sweep "
          "finite", **sw)
    # the sweep against what it is built from: its first-tick controls are
    # one batched tick on the same x0s (the same launch, bit for bit), its
    # mean_err the mean of its final position errors, and the first
    # SWEEP22_CL scenarios' final positions those of the port's unbatched
    # `closed_loop` on the same solver (K6 at B=1)
    u_b, _, _ = batched_rti_step(pre60.ocp, device=dev)(
        spec60, init_rti_state(pre60.ocp, x0w), x0w)
    errs = torch.linalg.norm(finals[:, 0:3] - spec60.yref_x[-1, 0:3], dim=-1)
    sw["first_tick_equal_batched"] = torch.equal(u0w, u_b)
    sw["mean_err_rel_gap"] = abs(float(errs.mean()) / sw["mean_err_m"] - 1)
    sw["closed_loop_pos_gap_m"] = max(
        float((closed_loop(spec60, pre60.ocp, x0w[i], SWEEP22_TICKS).xs[-1, 0:3]
               - finals[i, 0:3]).abs().max()) for i in range(SWEEP22_CL))
    check(sw["first_tick_equal_batched"], "sharded sweep's first tick equals "
          "the batched tick", **sw)
    check(sw["mean_err_rel_gap"] <= 1e-6, "sharded sweep's mean_err", **sw)
    check(sw["closed_loop_pos_gap_m"] <= SWEEP22_CL_TOL, "sharded sweep "
          "against closed_loop", **sw)
    out["sharded_sweep"] = sw
    out["launches"]["phase22_sharded_sweep"] = c["fused_rti_solve"]
    log("sharded_sweep", **sw)
    wall("22d sharded tick and sweep")

    # 22e: the sharded tick under a one-rank NCCL group: its reductions
    # run as dist.all_reduce on the card
    env = {k: os.environ.get(k) for k in ("WORLD_SIZE", "RANK")}
    os.environ.update(WORLD_SIZE="1", RANK="0")
    try:
        multi = initialize(f"localhost:{_free_port()}")
        ocp, sstep, states, u_s, mean_s, worst_s = ticks["k1_pallas"]
        grp = {"distributed": multi, "initialized": dist.is_initialized(),
               "backend": dist.get_backend(),
               "world_size": dist.get_world_size()}
        check(grp["initialized"] and grp["backend"] == "nccl"
              and grp["world_size"] == 1 and not multi,
              "one-rank NCCL group", **grp)
        (u_n, _, mean_n, worst_n), c = counted(
            {"box_qp_solve": 1}, "phase 22e sharded tick under NCCL",
            lambda: sstep(spec20, states, x0s))
        grp.update(launches=c["box_qp_solve"],
                   equal_to_22d=bool(torch.equal(u_n, u_s)
                                     and mean_n == mean_s
                                     and worst_n == worst_s),
                   mean_step=float(mean_n), worst_kkt=float(worst_n))
        check(grp["equal_to_22d"], "the tick under NCCL equals 22d's", **grp)
        out["launches"]["phase22_nccl_tick"] = c["box_qp_solve"]
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k, v in env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    out["nccl"] = grp
    log("nccl_group", **grp)
    wall("22e NCCL group")

    # 22f: the utilities on the card
    qp60 = blaster_qps(60, 1, dev)
    fn = lambda: K.box_qp_solve(qp60, iters=FULL_ITERS)  # noqa: E731
    ev_ms = cuda_ms(fn, reps=10)
    dt_ms = device_time(fn, reps=10) * 1e3
    # the trace of one deployed batched tick (K6): the "pallas" tick's
    # eager QP assembly at B=1024 would write ~90 MB of host events
    tdir = REPO / "chiprun_out" / "phase22_trace"
    ocp, sstep, states, *_ = ticks["k6_safe"]
    with trace(str(tdir)) as prof:
        sstep(spec20, states, x0s)
    tfile = tdir / "trace.json"
    from torch.autograd import DeviceType
    dev_events = sum(e.count for e in prof.key_averages()
                     if e.device_type == DeviceType.CUDA)
    util = {"cuda_ms": ev_ms, "device_time_ms": dt_ms,
            "rel_gap": abs(dt_ms - ev_ms) / ev_ms,
            "trace": str(tfile.relative_to(REPO)),
            "trace_bytes": tfile.stat().st_size if tfile.exists() else 0,
            "trace_device_events": dev_events}
    check(util["rel_gap"] <= 0.2, "device_time within 20% of cuda_ms",
          **util)
    check(util["trace_bytes"] > 0 and dev_events > 0,
          "trace written with device events", **util)
    out["utils"] = util
    log("utils_on_card", **util)
    wall("22f utilities")
    return out


# ---- phase 23: the flight I/O shell and the native runtime ----
FLIGHT_TICKS = 8      # tests/test_transport.py's n_ticks
MISSION_S = 60.0      # tests/test_endurance.py's full mission
MISSION_RICCATI_S = 6.0   # the "riccati" controller's mission (reported)
CERT_WORK_S = 0.090   # tests/test_endurance.py:360, the certification bound
RATE_HZ, RATE_S = 100.0, 1.0   # 23a's RateLoop run
# The JAX package's `python -m mpc_blaster_tpu` tick (the smoke preset in
# float32, its eager Riccati IPM): u0 as that entry point prints it (4
# decimals), recomputed by tests/test_torch_cli.py. The port's CLI on the
# card prints a u0 held within CLI_U0_TOL (N) of it.
CLI_U0_JAX = (5.85, 5.85, 5.85, 5.85, 0.0, 0.0)
CLI_U0_TOL = 1e-3


def parse_cli_u0(out: str) -> np.ndarray:
    """The u0 that `python -m mpc_blaster_tpu[_torch]` prints."""
    m = re.search(r"u0 = \[([^\]]*)\]", out)
    return np.array([float(v) for v in m[1].split()])


def tree_map(fn, obj):
    """fn on every tensor of obj and of the tuples (named or not) and dicts
    that hold them; anything else as it is."""
    if torch.is_tensor(obj):
        return fn(obj)
    if isinstance(obj, dict):
        return {k: tree_map(fn, v) for k, v in obj.items()}
    if isinstance(obj, tuple):
        vals = [tree_map(fn, v) for v in obj]
        return type(obj)(*vals) if hasattr(obj, "_fields") else tuple(vals)
    return obj


def to_device(obj, dev):
    return tree_map(lambda t: t.to(dev), obj)


def stack_launches(objs: list):
    """The batch of B=1 launches' arguments (or results): tensors with a
    leading axis of 1 joined on it; any other leaf the same in every one
    (the horizon's stage rows, the model's constants)."""
    o = objs[0]
    if torch.is_tensor(o):
        if o.ndim and o.shape[0] == 1:
            return torch.cat(objs, 0)
        if not all(torch.equal(o, x) for x in objs[1:]):
            raise ValueError("launches differ in an unbatched "
                             f"{tuple(o.shape)} argument")
        return o
    if isinstance(o, dict):
        return {k: stack_launches([x[k] for x in objs]) for k in o}
    if isinstance(o, tuple):
        vals = [stack_launches([x[i] for x in objs]) for i in range(len(o))]
        return type(o)(*vals) if hasattr(o, "_fields") else tuple(vals)
    return o


COUNTERS = ("launches", "warm_launches", "by_layout", "by_instance")


def through_hook(wrapper: str, hook, fn):
    """fn() with a kernel wrapper of `ops/box_qp_ipm.py` replaced by
    hook(orig, *args, **kwargs). The wrapper counts its launches on its
    module's name, so the hook holds the counts meanwhile and hands them
    back."""
    from mpc_blaster_tpu_torch.ops import box_qp_ipm as K
    orig = getattr(K, wrapper)

    def call(*a, **kw):
        return hook(orig, *a, **kw)
    for c in COUNTERS:
        setattr(call, c, getattr(orig, c))
    setattr(K, wrapper, call)
    try:
        return fn()
    finally:
        setattr(K, wrapper, orig)
        for c in COUNTERS:
            setattr(orig, c, getattr(call, c))


def record_launches(wrapper: str, fn) -> list:
    """(args, kwargs) of every call of a kernel wrapper that fn() makes,
    copied; each call goes on to the kernel, so the chain is the card's
    own. The ticks run eagerly (`capture.disable_jit`): a replay makes no
    call to record."""
    from mpc_blaster_tpu_torch.utils import capture
    seen = []

    def hook(orig, *a, **kw):
        seen.append(tree_map(torch.Tensor.clone, (a, kw)))
        return orig(*a, **kw)
    with capture.disable_jit():
        through_hook(wrapper, hook, fn)
    return seen


def one_iteration_gaps(x, y) -> dict:
    """Per problem, the u0 and the whole-iterate gaps of two solutions."""
    return {"u0": (x.du[:, 0] - y.du[:, 0]).abs().amax(1),
            "iterate": torch.maximum((x.du - y.du).abs().amax((1, 2)),
                                     (x.dx - y.dx).abs().amax((1, 2)))}


def captured_parity(wrapper: str, seen: dict, name: str) -> dict:
    """A cold launch captured on a phase-23 path (`capture_launch`) against
    its plain twin on the same inputs: one IPM iteration by phase 2's rule
    (u0 within 2e-3, the new iterate within 5e-3; a component the kernel
    misses is failed unless the same twin run on the host's CPU misses
    that component too), finite results at the launch's own budget, and
    both timed (`time_captured`)."""
    from mpc_blaster_tpu_torch.ops import box_qp_ipm as K
    a, kw = seen["args"], dict(seen["kwargs"])
    kw.pop("skip", None)
    kern, twin = getattr(K, wrapper), getattr(K, wrapper + "_plain")
    w = kw.get("warm")
    check(w is None or not bool(w.valid.any()), "a cold launch", case=name)
    row = {"case": name, "iters": kw.get("iters")}
    k1, t1 = kern(*a, **dict(kw, iters=1)), twin(*a, **dict(kw, iters=1))
    torch.cuda.synchronize()
    row["B"], row["N"] = k1.du.shape[0], k1.du.shape[1]
    g = {c: v.max().item() for c, v in one_iteration_gaps(k1, t1).items()}
    row["u0_err_1it"], row["max_abs_err_1it"] = g["u0"], g["iterate"]
    tol = {"u0": 2e-3, "iterate": 5e-3}
    if any(not g[c] <= tol[c] for c in tol):
        cpu = torch.device("cpu")
        h1 = to_device(twin(*to_device(a, cpu), **to_device(
            dict(kw, iters=1), cpu)), k1.du.device)
        h = {c: v.max().item() for c, v in one_iteration_gaps(h1, t1).items()}
        row.update(twin_cpu_u0_err_1it=h["u0"],
                   twin_cpu_max_abs_err_1it=h["iterate"])
        check(all(g[c] <= tol[c] or not h[c] <= tol[c] for c in tol),
              "one-iteration parity (a component the host's twin meets)",
              **row)
    kf, tf = kern(*a, **kw), twin(*a, **kw)
    torch.cuda.synchronize()
    check(all(bool(torch.isfinite(getattr(kf, f)).all())
              for f in ("dx", "du", "kkt_eq")), "finite", case=name)
    row["kkt_eq"] = [kf.kkt_eq.max().item(), tf.kkt_eq.max().item()]
    t = time_captured(wrapper, seen)
    row.update(kernel_ms=t["kernel_ms"], plain_ms=t["plain_ms"])
    return row


# chain_parity's reported bounds: after one iteration (phase 2's), and at
# the launch's budget (warm_gaps': the objective relative to max(|obj|, 1),
# kkt_eq's excess over 0.2 of the twin's; the box violation's gap)
CHAIN_TOL = {"u0": 2e-3, "iterate": 5e-3, "objective": 1.2e-2,
             "kkt_eq": 1e-3, "box": 1e-3}


def box_violation(qp, sol) -> torch.Tensor:
    """Per problem, the worst violation of the QP's box by a delta-form
    solution (state rows 1..N and every control row)."""
    off = sol.dx.shape[1] - qp.lbx.shape[1]   # 0: row 0 of the box unused
    dx = sol.dx[:, off:]
    vx = torch.maximum(qp.lbx - dx, dx - qp.ubx)[:, 1 - off:]
    vu = torch.maximum(qp.lbu - sol.du, sol.du - qp.ubu)
    return torch.maximum(vx.amax((1, 2)), vu.amax((1, 2))).clamp(min=0.0)


def chain_parity(wrapper: str, launches: list, name: str) -> dict:
    """The warm launches (K3) of a chain that ran on the card
    (`record_launches`: a valid warm start, not skipped) against the plain
    twin on the same inputs. The warm start acts only in the kernel's
    init (the blend of the carried slacks and duals,
    csrc/box_qp_ipm.cu's `warm_use`); every iteration after it is the
    cold code, which K1 and K6 hold pointwise. So the blend (0
    iterations) is held pointwise at every launch, and the results
    finite. Past the blend these launches are ill-conditioned: the twin
    started from the warm state moved by 1e-6 relative, or the same twin
    on the host's CPU (float32 rounding alone), parts from the card's twin
    by up to several N of u0 after one iteration (my chip run of PR 13's
    review repairs), so per component (CHAIN_TOL: after one iteration u0
    and the iterate; at the launch's budget the objective, kkt_eq and the
    box violation) the launches within the bound and the largest gap are
    reported for the kernel and for both references, and not held. K3 is
    held pointwise past the blend at each of these shapes on phase 2's
    warm case (`compare_warm`). The first launch is timed
    (`time_captured`); the twins run the launches as one batch."""
    from torch.func import vmap
    from mpc_blaster_tpu_torch.ops import box_qp_ipm as K
    from mpc_blaster_tpu_torch.qp.data import qp_objective
    kern, twin = getattr(K, wrapper), getattr(K, wrapper + "_plain")
    warm = []
    for a, kw in launches:
        w, s = kw.get("warm"), kw.get("skip")
        if w is not None and bool(w.valid.all()) and not (
                s is not None and bool(s.any())):
            warm.append((a, {k: v for k, v in kw.items() if k != "skip"}))
    row = {"case": name, "warm_launches": len(warm)}
    check(len(warm) > 0, "the chain made warm launches", case=name)
    if not warm:
        return row
    n, cpu = len(warm), torch.device("cpu")
    A = stack_launches([a for a, _ in warm])
    W = stack_launches([kw["warm"] for _, kw in warm])
    # the launches twice over, the second time from the moved warm state
    AA = stack_launches([a for a, _ in warm] * 2)
    WW = stack_launches([kw["warm"] for _, kw in warm] + [
        kw["warm"]._replace(**{f: getattr(kw["warm"], f) * (1 + 1e-6)
                               for f in SLACK_DUALS}) for _, kw in warm])
    kw0 = {k: v for k, v in warm[0][1].items() if k != "warm"}
    full = kw0["iters"]
    row.update(N=int(W.s_lu.shape[1]), iters=full)

    def kernel(it):
        return stack_launches([kern(*a, **dict(kw, iters=it))
                               for a, kw in warm])
    sk = kernel(0)
    sp = twin(*A, **dict(kw0, warm=W, iters=0))
    torch.cuda.synchronize()
    row["blend_max_abs_err"] = max((getattr(sk, f) - getattr(sp, f))
                                   .abs().max().item() for f in SLACK_DUALS)
    check(all(bool(torch.isclose(getattr(sk, f), getattr(sp, f), rtol=1e-5,
                                 atol=1e-6).all()) for f in SLACK_DUALS),
          "warm blend", case=name, err=row["blend_max_abs_err"])
    if wrapper == "box_qp_solve":
        qp = A[0]
    else:
        _, lin = twin(*A, **dict(kw0, warm=W, iters=1, return_lin=True))
        qp = K._fused_qp(K._fused_prep(A[0], A[1], A[3], *A[4:14],
                                       kw0.get("R_grad")), *lin)

    def budget_gaps(x, y):
        ox = vmap(qp_objective)(qp, x.dx, x.du)
        oy = vmap(qp_objective)(qp, y.dx, y.du)
        return {"objective": (ox - oy).abs() / oy.abs().clamp(min=1.0),
                "kkt_eq": (x.kkt_eq - y.kkt_eq).abs() - 0.2 * y.kkt_eq.abs(),
                "box": (box_violation(qp, x) - box_violation(qp, y)).abs()}
    for it in (1, full):
        gap = one_iteration_gaps if it == 1 else budget_gaps
        both = twin(*AA, **dict(kw0, warm=WW, iters=it))
        t = tree_map(lambda v: v[:n], both)
        m = tree_map(lambda v: v[n:], both)
        h = to_device(twin(*to_device(A, cpu), **to_device(
            dict(kw0, warm=W, iters=it), cpu)), t.du.device)
        k = kernel(it)
        torch.cuda.synchronize()
        check(all(bool(torch.isfinite(getattr(k, f)).all())
                  for f in ("dx", "du", "kkt_eq")), "finite", case=name,
              iters=it)
        kg, mg, hg = gap(k, t), gap(m, t), gap(h, t)
        for c, tol in CHAIN_TOL.items():
            if c in kg:
                row[f"{c}_{it}it"] = {
                    "of": n, **{f"{who}_within": int((g[c] <= tol).sum())
                                for who, g in (("kernel", kg),
                                               ("moved_twin", mg),
                                               ("host_twin", hg))},
                    **{f"{who}_max": g[c].max().item()
                       for who, g in (("kernel", kg), ("moved_twin", mg),
                                      ("host_twin", hg))}}
    t = time_captured(wrapper, {"args": warm[0][0], "kwargs": warm[0][1]})
    row.update(kernel_ms=t["kernel_ms"], plain_ms=t["plain_ms"])
    return row


def native_runtime(dev) -> dict:
    """Phase 23a: `libblaster_rt.so` built with g++ from the checkout into
    mpc_blaster_tpu_torch/build/; `NativeQPSolver` against the port's
    `box_qp_solve` in float64 on the card on tests/test_runtime.py:29-44's
    random QPs (status 0, kkt_stat < 1e-7, kkt_eq < 1e-9, dx and du
    within 5e-6, objectives within 1e-8) and its latency criterion (best
    of five blocks < 33.3 ms, :73-89); `RateLoop` at 100 Hz for 1 s
    (:92-101's criteria over the span: 0.8 to 5 times it, every tick
    counted); `PoseRingBuffer` pushed past its capacity and drained."""
    from mpc_blaster_tpu_torch.qp.data import qp_objective
    from mpc_blaster_tpu_torch.qp.ipm import box_qp_solve
    from mpc_blaster_tpu_torch.runtime import bindings as RB
    so = RB.library_path()
    fresh = not so.exists()
    t0 = time.perf_counter()
    RB.load_native()
    out = {"library": str(so.relative_to(REPO)), "built_here": fresh,
           "load_s": time.perf_counter() - t0}
    check(so.exists() and so.parent == REPO / "mpc_blaster_tpu_torch" /
          "build", "native library in the port's build dir", **out)
    native, qps = RB.NativeQPSolver(iters=15), []
    for seed in range(4):
        qp = random_qp(seed=seed, bound_scale=2.0, dev=dev)
        dx, du, st = native.solve(qp)
        sol = box_qp_solve(qp, iters=15)
        o_n = qp_objective(qp, torch.as_tensor(dx, device=dev),
                           torch.as_tensor(du, device=dev)).item()
        o_p = qp_objective(qp, sol.dx, sol.du).item()
        r = {"seed": seed, "status": st["status"],
             "kkt_stat": st["kkt_stat"], "kkt_eq": st["kkt_eq"],
             "du_gap": float(np.abs(du - sol.du.cpu().numpy()).max()),
             "dx_gap": float(np.abs(dx - sol.dx.cpu().numpy()).max()),
             "obj_gap": abs(o_n - o_p)}
        check(r["status"] == 0 and r["kkt_stat"] < 1e-7 and
              r["kkt_eq"] < 1e-9 and r["du_gap"] <= 5e-6 and
              r["dx_gap"] <= 5e-6 and r["obj_gap"] <= max(1e-8,
                                                          1e-8 * abs(o_p)),
              "native QP against box_qp_solve on the card", **r)
        qps.append(r)
    out["qp"] = qps
    lat = random_qp(N=20, nx=17, nu=6, seed=7, bound_scale=5.0, dev=dev)
    native10 = RB.NativeQPSolver(iters=10)
    native10.solve(lat)
    best = float("inf")
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(4):
            native10.solve(lat)
        best = min(best, (time.perf_counter() - t0) / 4 * 1e3)
    out["native_qp_best_ms_n20_17x6_10it"] = best
    check(best < 33.3, "native QP within 33.3 ms", best_ms=best)
    rl, n = RB.RateLoop(RATE_HZ), int(RATE_HZ * RATE_S)
    t0 = time.perf_counter()
    for _ in range(n):
        rl.sleep()
    elapsed = time.perf_counter() - t0
    out["rate_loop"] = {"hz": RATE_HZ, "elapsed_s": elapsed, **rl.stats()}
    check(0.8 * RATE_S < elapsed < 5 * RATE_S and
          out["rate_loop"]["ticks"] == n and
          out["rate_loop"]["deadline_misses"] <= n, "RateLoop at 100 Hz",
          **out["rate_loop"])
    ring = RB.PoseRingBuffer(capacity=8)
    empty = ring.latest() is None
    for i in range(12):
        ring.push(float(i), [i, 0, 0], [1, 0, 0, 0])
    latest, drained = ring.latest(), ring.drain(max_records=16)
    out["ring_ok"] = bool(empty and latest[0] == 11.0 and len(drained) == 8
                          and drained[0][0] == 4.0
                          and drained[-1][0] == 11.0)
    check(out["ring_ok"], "PoseRingBuffer push and drain")
    log("native_runtime", **out)
    return out


def flight_preset_on(profile: str):
    from mpc_blaster_tpu_torch import config as cfg
    pre = cfg.flight_preset()
    return dataclasses.replace(pre, ocp=dataclasses.replace(
        pre.ocp, solver=cfg.deployed_solver(profile)))


def fly_node(profile: str, wire: str, dev) -> dict:
    """Phase 23b's flight: tests/test_transport.py:91-150 on the port's
    FlightNode (the flight preset, float32, measured-pose feedback) under
    `deployed_solver(profile)`, "fastest" with warm_start=True: the first
    tick, then FLIGHT_TICKS ticks under the native `RateLoop` at 10 Hz
    with a pose datagram before each, then the hover-out message."""
    from mpc_blaster_tpu_torch.io.flight import FlightNode
    from mpc_blaster_tpu_torch.io.transport import (UdpAttitudeAdapter,
                                                     UdpEndpoint)
    from mpc_blaster_tpu_torch.runtime import PoseRingBuffer, RateLoop
    n = FLIGHT_TICKS
    ep = UdpEndpoint(wire=wire).start()
    adapter = UdpAttitudeAdapter(("127.0.0.1", ep.port), recv_port=0,
                                 wire=wire)
    try:
        node = FlightNode(preset=flight_preset_on(profile), adapter=adapter,
                          use_measured_pose=True,
                          warm_start=profile == "fastest", device=dev)
        native_ring = isinstance(adapter._ring, PoseRingBuffer)
        node.tick()
        rate = RateLoop(10.0)
        work = []
        t0 = time.monotonic()
        for _ in range(n):
            ep.send_pose(("127.0.0.1", adapter.recv_port), time.monotonic(),
                         node.history_x[-1][0:3], [1.0, 0, 0, 0])
            tw = time.perf_counter()
            node.tick()
            work.append(time.perf_counter() - tw)
            rate.sleep()
        elapsed = time.monotonic() - t0
        node.shutdown()
        stats = rate.stats()
        deadline = time.monotonic() + 2.0
        while len(ep.received) < n + 2 and time.monotonic() < deadline:
            time.sleep(0.01)
        msgs = [m for _, _, m in ep.received]
    finally:
        adapter.close()
        ep.stop()
    trips = int(node._wd.trips) if profile == "fastest" else 0
    row = {"profile": profile, "wire": wire, "ticks": n,
           "elapsed_s": elapsed, **stats,
           "work_ms_mean": 1e3 * float(np.mean(work)),
           "work_ms_max": 1e3 * float(np.max(work)),
           "frames": len(msgs), "pose_frames": adapter.pose_frames,
           "native_ring": native_ring, "watchdog_trips": trips}
    unit = all(abs(np.linalg.norm(m.orientation) - 1.0) <= 1e-5
               for m in msgs[:-1])
    crit = {
        "pacing": 0.6 * n / 10.0 < elapsed < 2.0 * n / 10.0,
        "ticks": stats["ticks"] == n,
        "deadline_misses": stats["deadline_misses"] <= n // 2,
        "worst_lateness": stats["worst_lateness_s"] < 0.25,
        "mean_lateness": stats["mean_lateness_s"] < 0.06,
        "frames": len(msgs) == n + 2,
        "type_mask": all(m.type_mask == 7 for m in msgs),
        "unit_quaternions": unit,
        "shutdown_thrust": bool(msgs) and abs(msgs[-1].thrust - 0.705)
        < 1e-6,
        "pose_frames": adapter.pose_frames >= n,
        "native_ring": native_ring,
        "no_watchdog_trip": trips == 0,
        "finite": bool(np.isfinite(np.asarray(node.history_x)).all())}
    row["criteria_met"] = crit
    check(all(crit.values()), "flight node at 10 Hz over UDP", **row)
    return row


# the mission controller's witness: tests/test_torch_mission.py's fifteen
# scripted ticks in float32, "pallas" (K1 / K3) against "riccati" (the
# eager Riccati IPM) on the card, held to that test's bounds on the port
# against the JAX package's "riccati" (quaternion, normalized thrust,
# d_est; the CPU's "pallas" twin against "riccati" parts by 7.8e-3, 0.24
# and 2.0 there), the first (cold) tick within WITNESS_FIRST_TOL
WITNESS_TICKS = 15
WITNESS_TOL = (0.04, 0.5, 4.0)
WITNESS_FIRST_TOL = 1e-3
LOCKSTEP_TICKS = 30   # 3 s of the mission's vehicle in lockstep


def launch_kinds(wrapper: str, dev, fn) -> tuple:
    """fn() with each call of a kernel wrapper of `ops/box_qp_ipm.py`
    sorted on the device, without a host sync, into a warm launch (K3: a
    valid warm start), a cold one (K1) and one whose `skip` holds (the
    watchdog's redo on an accepted tick: it returns at once). Returns
    (fn's result, {"warm": n, "cold": n, "skipped": n}), the tally read
    once after fn."""
    tally = torch.zeros(3, dtype=torch.int64, device=dev)
    no = torch.zeros((), dtype=torch.bool, device=dev)

    def hook(orig, *a, **kw):
        w, s = kw.get("warm"), kw.get("skip")
        sk = no if s is None else s.to(torch.bool).any()
        valid = no if w is None else (w.valid > 0.5).any()
        tally.add_(torch.stack([~sk & valid, ~sk & ~valid, sk]).long())
        return orig(*a, **kw)
    out = through_hook(wrapper, hook, fn)
    return out, dict(zip(("warm", "cold", "skipped"), tally.tolist()))


def mission_controller(dev, backend: str):
    from mpc_blaster_tpu_torch.io.endurance import TARGET, mission_ocp
    from mpc_blaster_tpu_torch.io.mission import OffsetFreeFlightController
    from mpc_blaster_tpu_torch.ocp.spec import build_spec
    ocp = mission_ocp(backend)
    return OffsetFreeFlightController(ocp, build_spec(
        ocp, yref=tuple(TARGET) + (0.0,) * 20, device=dev))


def scripted_controller(dev, n: int, backend: str = "pallas") -> dict:
    """n ticks of the mission's controller on `backend` on the card with
    tests/test_torch_mission.py's scripted hover-region measurements: per
    tick the command quaternion, the normalized thrust and d_est, and the
    watchdog's trips."""
    ctrl = mission_controller(dev, backend)
    out = {"q": [], "thrust": [], "d_est": []}
    for k in range(n):
        q, thrust, _ = ctrl.tick(
            np.array([0.5 + 0.01 * k, 1.0 - 0.01 * k, 3.5 + 0.005 * k]),
            np.array([0.01 * np.sin(k / 3), -0.005, 0.002 * k]),
            np.array([0.1, -0.1, 0.05]))
        out["q"].append(q)
        out["thrust"].append(thrust)
        out["d_est"].append(ctrl.d_est.copy())
    out = {k: np.asarray(v) for k, v in out.items()}
    out["trips"] = int(ctrl.wd.trips)
    return out


def mission_witness(dev) -> tuple:
    """The controller on "pallas" against "riccati", both on the card, over
    WITNESS_TICKS scripted ticks: no watchdog trip on either, and the
    gaps within WITNESS_TOL (the first tick WITNESS_FIRST_TOL). Returns
    the row and the "pallas" run's launches (`record_launches`)."""
    t0 = time.perf_counter()
    runs = {}
    launches = record_launches("box_qp_solve", lambda: runs.update(
        pallas=scripted_controller(dev, WITNESS_TICKS, "pallas")))
    t1 = time.perf_counter()
    runs["riccati"] = scripted_controller(dev, WITNESS_TICKS, "riccati")
    p, r = runs["pallas"], runs["riccati"]
    g = np.stack([np.abs(p["q"] - r["q"]).max(1),
                  np.abs(p["thrust"] - r["thrust"]),
                  np.abs(p["d_est"] - r["d_est"]).max(1)], 1)
    row = {"ticks": WITNESS_TICKS, "trips": {"pallas": p["trips"],
                                             "riccati": r["trips"]},
           "gap_max": g.max(0).tolist(), "gap_first": g[0].tolist(),
           "bounds": list(WITNESS_TOL), "first_bound": WITNESS_FIRST_TOL,
           "pallas_s": t1 - t0, "riccati_s": time.perf_counter() - t1}
    check(p["trips"] == 0 and r["trips"] == 0 and
          bool((g[0] <= WITNESS_FIRST_TOL).all()) and
          bool((g.max(0) <= WITNESS_TOL).all()),
          "mission controller: pallas against riccati on the card", **row)
    return row, launches


def lockstep_mission(dev, delay: int) -> dict:
    """The mission's controller on "pallas" with its vehicle in lockstep
    (io/endurance.py's SitlLiteVehicle, start, wind and target): each
    control tick reads the vehicle's exact state, its command lands
    `delay` ticks later, and the vehicle then steps 0.1 s. The controller's
    work is out of the loop; a delay of 1 is what an overrun 10 Hz slot
    does to the real-time mission. Reported: the watchdog's trips and the
    position error."""
    from mpc_blaster_tpu_torch.io.endurance import TARGET, WIND
    from mpc_blaster_tpu_torch.io.mission import SitlLiteVehicle
    ctrl = mission_controller(dev, "pallas")
    x_like = np.zeros(17, np.float32)
    x_like[2] = 3.0
    ctrl.warmup(x_like)
    veh = SitlLiteVehicle([0.0, 0.0, 3.0], WIND, dt=0.01, mass=9.0,
                          t_blast=2.2 * 9.81)
    errs, trips, queue = [], [], []
    for _ in range(LOCKSTEP_TICKS):
        q, thrust, _ = ctrl.tick(veh.p.copy(), veh.eul.copy(), veh.v.copy())
        errs.append(float(np.linalg.norm(veh.p - TARGET)))
        trips.append(int(ctrl.wd.trips))
        queue.append((q, thrust))
        if len(queue) > delay:
            veh.command(*queue.pop(0))
        for _ in range(10):
            veh.step()
    row = {"delay_ticks": delay, "ticks": LOCKSTEP_TICKS,
           "trips": trips[-1],
           "first_trip_tick": next((k for k, t in enumerate(trips) if t),
                                   None),
           "err_final_m": errs[-1], "err_max_m": max(errs),
           "err_every_10": errs[::10]}
    check(bool(np.isfinite(errs).all()), "lockstep mission finite", **row)
    return row


def mission_record(r: dict) -> dict:
    """A mission's loop, link and quality figures, as logged."""
    ticks = len(r["errs"])
    return {"ticks": ticks, "rx_total": r["rx_total"],
            "rx_final": r["rx_final"],
            "veh_ticks": r["veh"]["rate"]["ticks"],
            "sent": r["veh"]["sent"], "dropped": r["veh"]["dropped"],
            "truncated": r["veh"]["truncated"], "bursts": r["veh"]["bursts"],
            "bad_frames": r["parser"]["bad_frames"],
            "ctrl": r["ctrl"], "io": r["io"], "veh": r["veh"]["rate"],
            "worst_work_s": r["ctrl"]["worst_work_s"],
            "work_ms_mean": 1e3 * float(np.mean(r["work_s"])) if ticks
            else None,
            "work_ms_median": 1e3 * float(np.median(r["work_s"]))
            if ticks else None,
            "certification_bound_s": CERT_WORK_S,
            "err_final_m": float(r["errs"][-1]) if ticks else None,
            "err_max_m": float(r["errs"].max()) if ticks else None,
            "err_last20_max_m": float(r["errs"][-20:].max()) if ticks
            else None,
            "d_est": r["d_est"].tolist(),
            "watchdog_trips": r["watchdog_trips"]}


def mission_criteria(r: dict, seconds: float) -> dict:
    """tests/test_endurance.py:356-393 on one mission: the certification
    path's timing (the control loop's work under 0.090 s and at most 6
    missed deadlines; each loop's mean lateness under 2 ms, at most 120
    missed deadlines, the worst lateness under 0.3 s), the injected
    faults survived, the parser resynced, the tracking (every error below
    3 m, the last 20 below 0.5 m) and the disturbance estimate; and the
    100 Hz loops ran all their ticks."""
    from mpc_blaster_tpu_torch.io.endurance import WIND
    errs, d = r["errs"], r["d_est"]
    sent_ok = r["veh"]["sent"] - r["veh"]["dropped"]
    loops = {"io": r["io"], "veh": r["veh"]["rate"], "ctrl": r["ctrl"]}
    crit = {"worst_work": r["ctrl"]["worst_work_s"] < CERT_WORK_S,
            "ctrl_deadline_misses": r["ctrl"]["deadline_misses"] <= 6}
    for k, v in loops.items():
        crit[f"{k}_mean_lateness"] = v["mean_lateness_s"] < 2e-3
        crit[f"{k}_deadline_misses"] = v["deadline_misses"] <= 120
        crit[f"{k}_worst_lateness"] = v["worst_lateness_s"] < 0.3
    crit.update({
        "faults": r["veh"]["dropped"] > 50 and r["veh"]["truncated"] > 10,
        "bursts": r["veh"]["bursts"] > 10,
        "bad_frames": r["parser"]["bad_frames"] > 0,
        "rx_total": r["rx_total"] > 0.85 * sent_ok,
        "rx_final": r["rx_final"] > 100,
        "errs_finite": len(errs) > 0 and bool(np.isfinite(errs).all()),
        "errs_max": len(errs) > 0 and float(errs.max()) < 3.0,
        "errs_last20": len(errs) > 0 and float(errs[-20:].max()) < 0.5,
        "d_est_finite": bool(np.isfinite(d).all()),
        "d_est_norm": float(np.linalg.norm(d[0:3])) < 3.0,
        "d_est_wind_x": abs(float(d[0]) - float(WIND[0])) < 0.3,
        "veh_ticks": r["veh"]["rate"]["ticks"] == int(seconds * 100),
        "io_ticks": r["io"]["ticks"] == int(seconds * 100)})
    return crit


def fly_mission(dev) -> tuple:
    """Phase 23c's mission: MISSION_S seconds with the captured
    controller on "pallas" (K1 cold, K3 warm: PLAIN, N=10, B=1, 6
    iterations), counted (two launches a tick, the warm-up tick's
    included; every one resident), the launches sorted by `launch_kinds`.
    Returns (its record with `criteria_met`, the launch kinds)."""
    from mpc_blaster_tpu_torch.io.endurance import mission_ocp, run_mission
    reset_counts()
    r, kinds = launch_kinds("box_qp_solve", dev, lambda: run_mission(
        MISSION_S, mission_ocp("pallas"), device=dev))
    got = counts()
    ticks = len(r["errs"]) + 1   # the warm-up tick and the mission's
    want = {k: 0 for k in got}
    want.update({"box_qp_solve": 2 * ticks, "box_qp_solve.warm": 2 * ticks})
    check(got == want, "phase 23c mission launches", got=got, want=want)
    lay = layout_counts()
    check(lay == {"resident": 2 * ticks}, "phase 23c layout", got=lay)
    tally_prologue("phase 23c mission")
    check(sum(kinds.values()) == 2 * ticks, "phase 23c launch kinds",
          **kinds)
    m = mission_record(r)
    m["seconds"] = MISSION_S
    m["launch_kinds"] = kinds
    m["criteria_met"] = mission_criteria(r, MISSION_S)
    return m, kinds


def start_cli() -> subprocess.Popen:
    """`python -m mpc_blaster_tpu_torch` from the checkout, on the card
    (no --device), started now and read by phase 23d."""
    proc = subprocess.Popen([sys.executable, "-m", "mpc_blaster_tpu_torch"],
                            cwd=REPO, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    atexit.register(lambda: proc.poll() is None and proc.kill())
    return proc


def phase23(dev, cli_proc: subprocess.Popen) -> dict:
    """Phase 23: the flight I/O shell and the native runtime on the card.
    (a) `native_runtime`; (b) the flight node at 10 Hz over UDP loopback
    (`fly_node`) under "safe" (one K6 launch a tick, N=30, 6 iterations,
    the framed wire) and "fastest" (the guarded warm chain: K3 at N=30, 3
    iterations, and the watchdog's redo, K6's cold launch, which returns
    at once; MAVLink 2), each counted; K6's first launch held to its twin
    (`captured_parity`), the warm launches of a "fastest" chain
    (`chain_parity`) and K3 at N=30 on phase 2's warm case
    (`compare_warm`, held pointwise); (d) `python -m mpc_blaster_tpu_torch`
    in a subprocess (`start_cli`, started beside the worker pool: it
    takes ~20 s, mostly CUDA's start and one eager Riccati tick); (c) the
    6 s endurance mission (`io/endurance.py`: the vehicle and telemetry
    processes, the faulty MAVLink link) with the offset-free controller on
    "pallas" (K1 cold, K3 warm: PLAIN, N=10, B=1, 6 iterations; the
    launches sorted by `launch_kinds`), tests/test_endurance.py:396-407's
    smoke criteria, the worst work reported against the 0.090 s
    certification bound; the controller's witness (`mission_witness`:
    "pallas" against "riccati" on scripted ticks), the vehicle in
    lockstep (`lockstep_mission`, reported), K1's first launch, the
    witness chain's warm launches and K3 at N=10 on phase 2's warm case
    held to their twins. (d) runs before (c): the mission lowers this
    process's priority (os.nice), which a child would inherit."""
    from mpc_blaster_tpu_torch.io.endurance import mission_ocp, run_mission
    from mpc_blaster_tpu_torch.ops import box_qp_ipm as K
    out = {"launches": {}}
    out["native"] = native_runtime(dev)
    wall("23a native runtime")

    n = FLIGHT_TICKS
    out["flight"] = {}
    for profile, wire, want in (
            ("safe", "framed", {"fused_rti_solve": n + 1}),
            ("fastest", "mavlink2", {"fused_rti_solve": 2 * (n + 1),
                                     "fused_rti_solve.warm": 2 * (n + 1)})):
        row, c = counted(want, f"phase 23b flight node {profile}",
                         lambda p=profile, w=wire: fly_node(p, w, dev))
        out["flight"][profile] = row
        log("flight_node", **row)
    out["launches"].update(
        k6_safe=n + 1, k6_fastest_cold_and_redo=n + 2, k3_fastest=n)

    def node_ticks(profile, n_ticks):
        from mpc_blaster_tpu_torch.io.flight import FlightNode
        node = FlightNode(preset=flight_preset_on(profile),
                          warm_start=profile == "fastest", device=dev)
        for _ in range(n_ticks):
            node.tick()
    out["captured"] = {
        "k6_fuse_lin_n30_6it": captured_parity(
            "fused_rti_solve", capture_launch(
                "fused_rti_solve", 0, lambda: node_ticks("safe", 1)),
            "flight safe"),
        "k3_fuse_lin_n30_3it": chain_parity(
            "fused_rti_solve", record_launches(
                "fused_rti_solve", lambda: node_ticks("fastest", n)),
            "flight fastest chain")}
    # K3 at the flight's shape on phase 2's warm case, which the warm start
    # conditions (held pointwise at 1 and 3 iterations; at the mission's,
    # N=10, phase 2's plain_n10_b1 row)
    out["warm_cases"] = {"fuse_lin_n30_b1": compare_warm(
        "fuse_lin_n30_b1", "fuse_lin", 30, 1, dev, K,
        check_iters=(1, FASTEST_ITERS))}
    wall("23b flight node")

    stdout, stderr = cli_proc.communicate(timeout=600)
    name = torch.cuda.get_device_name(0)
    cli = {"rc": cli_proc.returncode, "names_card": name in stdout,
           "stdout": stdout[-600:], "stderr": stderr[-600:]}
    if cli_proc.returncode == 0:
        u0 = parse_cli_u0(stdout)
        cli["u0"] = u0.tolist()
        cli["u0_gap"] = float(np.abs(u0 - np.asarray(CLI_U0_JAX)).max())
    check(cli_proc.returncode == 0 and cli["names_card"] and
          cli.get("u0_gap", 1.0) <= CLI_U0_TOL,
          "python -m mpc_blaster_tpu_torch on the card", **cli)
    out["cli"] = cli
    log("cli", **cli)
    wall("23d CLI")

    m, kinds = fly_mission(dev)
    if not all(m["criteria_met"].values()):
        # tests/test_endurance.py:305-318's one retry: a fresh mission
        log("mission", retried=True, **m)
        m, kinds = fly_mission(dev)
    check(all(m["criteria_met"].values()),
          "the 60 s endurance mission meets tests/test_endurance.py:356-393",
          **m)
    out["mission"] = m
    log("mission", **m)
    out["launches"].update(k1_mission=kinds["cold"],
                           k3_mission=kinds["warm"],
                           k1_mission_skipped_redo=kinds["skipped"])
    r = run_mission(MISSION_RICCATI_S, mission_ocp("riccati"), device=dev)
    out["mission_riccati"] = mission_record(r)
    check(bool(np.isfinite(r["errs"]).all()) and len(r["errs"]) > 0,
          "the riccati controller's mission ticked, finite",
          **out["mission_riccati"])
    log("mission_riccati", **out["mission_riccati"])
    witness, launches = mission_witness(dev)
    out["witness"] = witness
    log("mission_witness", **witness)
    out["lockstep"] = [lockstep_mission(dev, d) for d in (0, 1)]
    for r in out["lockstep"]:
        log("mission_lockstep", **r)
    out["captured"].update({
        "k1_plain_n10_6it": captured_parity(
            "box_qp_solve", capture_launch(
                "box_qp_solve", 0, lambda: scripted_controller(dev, 1)),
            "mission cold"),
        "k3_plain_n10_6it": chain_parity("box_qp_solve", launches,
                                         "mission witness chain")})
    for k, v in out["warm_cases"].items():
        log("phase23_warm_case_vs_twin", **v)
    for k, v in out["captured"].items():
        log("phase23_kernel_vs_twin", launch=k, **v)
    wall("23c mission")
    return out


# ---- phase 24: the horizon ("hp") sharding of the log-depth scans ----
HP_SHARDS = (4, 8)     # 24a's meshes: chunks of cuda:0
HP_BOX_SHARDS = 4      # 24b-c
HP_N = 240             # 24b: phase 15's long horizon
HP_LQR_TOL = {"rtol": 1e-6, "atol": 1e-7}   # tests/test_pscan.py:124-125
# f64 gaps on this host's CPU 2.8e-16-5.0e-16 (sharded against unsharded
# and `lqr_solve`); held at 1e-12
HP_LQR_F64_ATOL = 1e-12
# 24b on the CPU (float32): the objective's relative gap 2.1e-8, kkt_eq
# 8.04e-6 against 7.93e-6; held at 1e-5 (phase 22a's bound between modes)
# and 1e-5 on kkt_eq's gap, kkt_eq below 1e-4 (phase 22a's)
HP_OBJ_RTOL = 1e-5
HP_EQ_GAP = 1e-5


def hp_lqr(dev) -> dict:
    """Phase 24a: tests/test_pscan.py:107-125's QP (N=64, nx=4, nu=2, seed
    5) through `lqr_solve_pscan` on 4- and 8-chunk "hp" meshes of the card,
    in float64 and float32, against the unsharded `lqr_solve_pscan` and
    `lqr_solve` on the card."""
    from mpc_blaster_tpu_torch.parallel.mesh import make_mesh
    from mpc_blaster_tpu_torch.qp.pscan import lqr_solve_pscan
    from mpc_blaster_tpu_torch.qp.riccati import lqr_solve
    out = {}
    for name, dtype in (("f64", torch.float64), ("f32", torch.float32)):
        qp = random_qp(N=64, nx=4, nu=2, seed=5, dev=dev, dtype=dtype)
        fns = {"unsharded": lambda: lqr_solve_pscan(qp),
               "sequential": lambda: lqr_solve(qp)}
        for n in HP_SHARDS:
            mesh = make_mesh(n, axis="hp", device=dev)
            fns[f"hp{n}"] = lambda mesh=mesh: lqr_solve_pscan(qp, mesh=mesh)
        sols, rounds = timed_rounds(fns, TIMED_ROUNDS)
        row = {"ms": {k: min(v) for k, v in rounds.items()}}
        # in float32 the log-depth scan and the sequential sweep part by a
        # few ulps, sharded or not (run 1: 2.2e-7 unsharded, 2.4e-7
        # sharded, past tests/test_pscan.py's f64 tolerance): against
        # `lqr_solve` the sharded solve may part by that tolerance more
        # than the unsharded scan does, element by element
        par, seq = sols["unsharded"].du, sols["sequential"].du
        own = (par - seq).abs() if name == "f32" else torch.zeros_like(seq)
        row["du_gap_unsharded_sequential"] = float((par - seq).abs().max())
        row["unsharded_within_f64_tol_of_sequential"] = bool(
            torch.allclose(par, seq, **HP_LQR_TOL))
        for n in HP_SHARDS:
            s = sols[f"hp{n}"]
            for ref, extra in (("unsharded", 0.0), ("sequential", own)):
                r = sols[ref]
                gap = float((s.du - r.du).abs().max())
                row[f"hp{n}_du_gap_{ref}"] = gap
                ok = bool(((s.du - r.du).abs() <= HP_LQR_TOL["atol"]
                           + HP_LQR_TOL["rtol"] * r.du.abs() + extra).all())
                if name == "f64":
                    ok = ok and gap <= HP_LQR_F64_ATOL
                check(ok and s.du.device == dev and s.dx.shape == (65, 4),
                      "phase 24a sharded lqr_solve_pscan", dtype=name,
                      shards=n, ref=ref, gap=gap)
        out[name] = row
        log("hp_lqr", dtype=name, N=64, **row)
    return out


def hp_box(dev, K, mesh):
    """Phase 24b: the 17x6 QP `build_qp` assembles for the simulation
    preset at N=240 (float32) through `box_qp_solve(riccati="pscan",
    iters=12)` on a 4-chunk "hp" mesh of the card against the unsharded
    solve (the objective's relative gap, kkt_eq); both timed, one warm-up
    each; the objective's gap to K7's solve of the same QP reported (a
    different solver: ROADMAP's parity rules). Returns (row, the sharded
    solution, the QP)."""
    from mpc_blaster_tpu_torch.qp.data import QPData, qp_objective
    from mpc_blaster_tpu_torch.qp.ipm import box_qp_solve
    t0 = time.perf_counter()
    qp = blaster_qps(HP_N, 1, dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    q64 = QPData(*(x.double() for x in qp))

    def obj(s):
        return float(qp_objective(q64, s.dx.double(), s.du.double()))

    def eager():
        first = timed(lambda: box_qp_solve(qp, iters=FULL_ITERS,
                                           riccati="pscan", mesh=mesh), 1)
        return first, *timed_rounds(
            {"unsharded": lambda: box_qp_solve(qp, iters=FULL_ITERS,
                                               riccati="pscan"),
             "hp": lambda: box_qp_solve(qp, iters=FULL_ITERS,
                                        riccati="pscan", mesh=mesh)}, 1)
    ((first, first_ms), sols, rounds), _ = counted(
        {}, "phase 24b eager solves", eager)
    sh, ref = sols["hp"], sols["unsharded"]
    (k7, _), c = counted({"box_qp_solve": 1}, "phase 24b K7", lambda: timed(
        lambda: K.box_qp_solve(qp, iters=FULL_ITERS), 1), layout="global")
    o_sh, o_ref, o_k7 = obj(sh), obj(ref), obj(k7)
    row = {"N": HP_N, "shards": mesh.size, "iters": FULL_ITERS,
           "ms_unsharded": rounds["unsharded"][0], "ms_hp": rounds["hp"][0],
           "ms_hp_first_call": first_ms, "qp_build_s": build_s,
           "objective": {"hp": o_sh, "unsharded": o_ref, "k7": o_k7},
           "obj_rel_gap": abs(o_sh - o_ref) / abs(o_ref),
           "obj_rel_gap_k7_reported": abs(o_sh - o_k7) / abs(o_k7),
           "kkt_eq": {"hp": float(sh.kkt_eq.max()),
                      "unsharded": float(ref.kkt_eq.max()),
                      "k7": float(k7.kkt_eq.max())},
           "kkt_stat": {"hp": float(sh.kkt_stat.max()),
                        "unsharded": float(ref.kkt_stat.max())},
           "du_gap": float((sh.du - ref.du).abs().max()),
           "repeat_equal": all(torch.equal(a, b) for a, b in zip(first, sh)
                               if isinstance(a, torch.Tensor)),
           "k7_launches": c["box_qp_solve"]}
    eq_gap = abs(row["kkt_eq"]["hp"] - row["kkt_eq"]["unsharded"])
    check(all(bool(torch.isfinite(getattr(sh, f)).all())
              for f in ("dx", "du", "kkt_eq")) and sh.du.device == dev
          and sh.dx.shape == ref.dx.shape, "phase 24b finite, whole", **row)
    check(row["obj_rel_gap"] <= HP_OBJ_RTOL, "phase 24b objective", **row)
    check(eq_gap <= HP_EQ_GAP and row["kkt_eq"]["hp"] < 1e-4,
          "phase 24b kkt_eq", eq_gap=eq_gap, **row)
    return row, sh, qp


def phase24(dev, K) -> dict:
    """Phase 24: the horizon sharding (`qp/horizon.py`) on the card: (a)
    `hp_lqr`; (b) `hp_box`; (c) (b)'s sharded solve under a one-rank NCCL
    process group (its exchanges through `dist.all_gather` on the card),
    equal to (b)'s bit for bit. No kernel of ours runs in (a) or in the
    eager solves of (b) and (c) (counted: none)."""
    import os
    import torch.distributed as dist
    from mpc_blaster_tpu_torch.parallel.distributed import initialize
    from mpc_blaster_tpu_torch.parallel.mesh import make_mesh
    from mpc_blaster_tpu_torch.qp.ipm import box_qp_solve
    out = {"lqr": counted({}, "phase 24a sharded lqr",
                          lambda: hp_lqr(dev))[0]}
    wall("24a sharded lqr_solve_pscan")
    mesh = make_mesh(HP_BOX_SHARDS, axis="hp", device=dev)
    out["box"], sh, qp = hp_box(dev, K, mesh)
    log("hp_box", **out["box"])
    wall("24b sharded box_qp_solve N=240")

    env = {k: os.environ.get(k) for k in ("WORLD_SIZE", "RANK")}
    os.environ.update(WORLD_SIZE="1", RANK="0")
    try:
        initialize(f"localhost:{_free_port()}")

        def solve():
            return box_qp_solve(qp, iters=FULL_ITERS, riccati="pscan",
                                mesh=mesh)
        # the first call also creates the NCCL communicator; the second
        # is timed
        ((first, (sol, ms))), _ = counted({}, "phase 24c under NCCL",
                                          lambda: (solve(),
                                                   timed(solve, 1)))
        grp = {"backend": dist.get_backend(),
               "world_size": dist.get_world_size(), "ms": ms,
               "equal_to_24b": all(
                   torch.equal(a, b) and torch.equal(c, b)
                   for a, c, b in zip(first, sol, sh)
                   if isinstance(b, torch.Tensor))}
        check(grp["backend"] == "nccl" and grp["world_size"] == 1
              and grp["equal_to_24b"], "phase 24c equal to 24b", **grp)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k, v in env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    out["nccl"] = grp
    log("hp_nccl", **grp)
    wall("24c sharded box_qp_solve under NCCL")
    return out


# ---- phase 25: the port's `jax.jit`, the ticks captured as CUDA graphs ----

CAPTURE_TICKS = 10        # chained calls of each tick runner
CAPTURE_LOOP_TICKS = 20   # ticks of each captured closed loop
MISSION_WITNESS_TICKS = 15
FLIGHT_CAPTURE_TICKS = 10


def tensor_leaves(obj) -> list:
    out = []
    tree_map(out.append, obj)
    return out


def bit_gap(a, b):
    """(equal bit for bit, the largest absolute gap) of two results."""
    la, lb = tensor_leaves(a), tensor_leaves(b)
    if len(la) != len(lb) or any(x.shape != y.shape or x.dtype != y.dtype
                                 for x, y in zip(la, lb)):
        return False, float("inf")
    eq = all(torch.equal(x, y) for x, y in zip(la, lb))
    gap = max(((x.double() - y.double()).abs().max().item()
               for x, y in zip(la, lb) if x.numel()), default=0.0)
    return eq, gap


def graph_stats(obj) -> dict:
    """A runner's or a scan's captures: host ms, graph nodes and the kernel
    launches each holds, and the bytes of its memory pool."""
    return {"captures": len(obj.stats),
            "capture_ms": [s["capture_ms"] for s in obj.stats],
            "nodes": [s["nodes"] for s in obj.stats],
            "graph_kernel_launches": [s["launches"] for s in obj.stats],
            "pool_bytes": obj.pool_bytes()}


def runner_site(name: str, runner, args, n: int = CAPTURE_TICKS) -> dict:
    """A tick runner (`utils/capture.py::jit`) over n chained calls, each
    fed the previous call's iterate, against its eager function on the
    same inputs, bit for bit at every call; both timed alone (CUDA events
    around one call: the eager tick over 3 calls, the runner's copy-in,
    replay and copy-out over 10)."""
    eager = runner.__wrapped__

    def chain(fn):
        outs, a = [], args
        for _ in range(n):
            o = fn(*a)
            outs.append(tree_map(torch.Tensor.clone, o))
            a = (a[0], o[1], a[2])
        return outs
    want = chain(eager)
    t0 = time.perf_counter()
    got = chain(runner)
    torch.cuda.synchronize()
    chain_s = time.perf_counter() - t0
    gaps = [bit_gap(w, g) for w, g in zip(want, got)]
    row = {"site": name, "ticks": n,
           "equal_ticks": sum(e for e, _ in gaps),
           "max_gap": max(g for _, g in gaps), "chain_s": chain_s,
           "eager_ms": cuda_ms(lambda: eager(*args), 3),
           "captured_ms": cuda_ms(lambda: runner(*args), 10),
           **graph_stats(runner)}
    check(row["equal_ticks"] == n, "phase 25 captured tick equals the eager "
          "tick bit for bit", **row)
    log("capture_site", **row)
    return row


def loop_site(name: str, ocp, spec, x0, n: int = CAPTURE_LOOP_TICKS,
              **kw) -> dict:
    """`make_closed_loop` (`capture.Scan`: the tick, the plant step and
    the cost one graph per step key, replayed) against the eager
    `closed_loop`, bit for bit over every tick, on two calls of one
    runner; the eager loop, both calls and the steady tick's graph
    replayed alone (on the carry buffers, the step counter from 0) timed
    with CUDA events."""
    from mpc_blaster_tpu_torch.sim import closedloop as CL
    want, eager_ms = timed(lambda: CL.closed_loop(spec, ocp, x0, n, **kw),
                           n)
    run = CL.make_closed_loop(ocp, n, **kw)
    first, first_ms = timed(lambda: run(spec, x0), n)
    again, again_ms = timed(lambda: run(spec, x0), n)
    eq1, gap1 = bit_gap(tuple(want), tuple(first))
    eq2, gap2 = bit_gap(tuple(want), tuple(again))
    (st,) = run.scan._entries.values()
    # the steady tick (with Jacobian reuse, the reuse tick)
    graph, _ = st.graphs.get(kw.get("jac_refresh", 1) == 1, (None, None))
    replay_ms = None
    if graph is not None:
        st.step.zero_()
        replay_ms = cuda_ms(graph.replay, min(10, n - 1))
    row = {"site": name, "ticks": n, "N": spec.horizon, **kw,
           "captured": graph is not None,
           "equal": [eq1, eq2], "max_gap": max(gap1, gap2),
           "eager_ms_per_tick": eager_ms,
           "first_call_ms_per_tick": first_ms,
           "second_call_ms_per_tick": again_ms, "replay_ms": replay_ms,
           "graphs": sorted(str(k) for k in st.graphs),
           **graph_stats(run.scan)}
    check(eq1 and eq2 and (graph is not None or not x0.is_cuda),
          "phase 25 captured loop equals the eager loop bit for bit",
          **row)
    log("capture_loop", **row)
    return row


def tick_events(fn) -> float:
    """ms of one host-synchronised tick (CUDA events around it)."""
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1)


def mission_site(dev, backend: str, n: int = MISSION_WITNESS_TICKS) -> dict:
    """The mission's controller (N=10) on `backend` over n scripted ticks
    (tests/test_torch_mission.py's measurements): the captured `_tick`
    against the eager one, commands, estimates and carried state bit for
    bit at every tick; each tick timed (its one host copy syncs)."""
    ctrls = [mission_controller(dev, backend) for _ in range(2)]
    ctrls[1]._tick = ctrls[1]._tick.__wrapped__
    eq, gaps, ms = [], [], {"captured": [], "eager": []}
    for k in range(n):
        meas = (np.array([0.5 + 0.01 * k, 1.0 - 0.01 * k, 3.5 + 0.005 * k]),
                np.array([0.01 * np.sin(k / 3), -0.005, 0.002 * k]),
                np.array([0.1, -0.1, 0.05]))
        res = []
        for c, who in zip(ctrls, ("captured", "eager")):
            out = {}
            ms[who].append(tick_events(
                lambda c=c: out.update(r=c.tick(*meas))))
            res.append(out["r"])
        (qa, ta, da), (qb, tb, db) = res
        e, g = bit_gap((da, ctrls[0].state, ctrls[0].warm, ctrls[0].wd),
                       (db, ctrls[1].state, ctrls[1].warm, ctrls[1].wd))
        eq.append(e and np.array_equal(qa, qb) and ta == tb
                  and np.array_equal(ctrls[0].d_est, ctrls[1].d_est))
        gaps.append(g)
    row = {"site": f"mission {backend}", "ticks": n,
           "equal_ticks": sum(eq), "max_gap": max(gaps),
           "trips": [int(c.wd.trips) for c in ctrls],
           "first_tick_ms": ms["captured"][0],
           "captured_ms": float(np.mean(ms["captured"][1:])),
           "captured_ms_max": float(np.max(ms["captured"][1:])),
           "eager_ms": float(np.mean(ms["eager"])),
           "eager_ms_max": float(np.max(ms["eager"])),
           **graph_stats(ctrls[0]._tick)}
    check(row["equal_ticks"] == n, "phase 25 mission controller captured "
          "equals eager bit for bit", **row)
    log("capture_mission", **row)
    return row


def flight_site(dev, profile: str, n: int = FLIGHT_CAPTURE_TICKS) -> dict:
    """The flight node (the flight preset, N=30, float32) under
    `deployed_solver(profile)` over n ticks: the runners (the tick, the
    plant) against the eager functions, the published messages and the
    belief bit for bit at every tick; each tick timed."""
    from mpc_blaster_tpu_torch.io.flight import FlightNode
    nodes = [FlightNode(preset=flight_preset_on(profile),
                        warm_start=profile == "fastest", device=dev)
             for _ in range(2)]
    for name in ("_plant", "_step", "_step_warm"):
        if hasattr(nodes[1], name):
            setattr(nodes[1], name, getattr(nodes[1], name).__wrapped__)
    ms = {"captured": [], "eager": []}
    eq = []
    for _ in range(n):
        msgs = []
        for node, who in zip(nodes, ("captured", "eager")):
            ms[who].append(tick_events(lambda node=node: msgs.append(
                node.tick())))
        eq.append(np.array_equal(msgs[0].orientation, msgs[1].orientation)
                  and msgs[0].thrust == msgs[1].thrust
                  and np.array_equal(nodes[0].history_x[-1],
                                     nodes[1].history_x[-1]))
    e, g = bit_gap(nodes[0].state, nodes[1].state)
    step = nodes[0]._step_warm if profile == "fastest" else nodes[0]._step
    row = {"site": f"flight {profile}", "ticks": n,
           "equal_ticks": sum(eq), "state_equal": e, "max_gap": g,
           "first_tick_ms": ms["captured"][0],
           "captured_ms": float(np.mean(ms["captured"][1:])),
           "eager_ms": float(np.mean(ms["eager"])),
           "tick": graph_stats(step), "plant": graph_stats(nodes[0]._plant)}
    check(row["equal_ticks"] == n and e, "phase 25 flight node captured "
          "equals eager bit for bit", **row)
    log("capture_flight", **row)
    return row


def phase25(dev) -> dict:
    """Phase 25: `jit`, the port's counterpart of `jax.jit`, captures the
    fixed-shape ticks as CUDA graphs (`mpc_blaster_tpu_torch/utils/
    capture.py`). At each site, at chip_smoke's shapes, the captured tick
    against the eager one on the card, bit for bit at every tick, with
    the eager and the captured ms a tick (CUDA events, alone on the
    card), each capture's host ms, the graph's node count and the memory
    pool's bytes: (a) `make_rti_step` on "pallas" and "pallas_fused", N=60;
    (b) `make_closed_loop` in every mode (plain "pallas", "pallas_fused",
    the guarded "fastest" chain, warm, Jacobian reuse cold and warm, the
    online POC modes), 20 ticks; (c) the batched ticks on
    "pallas", "pallas_fused" and "xla" over deployed_solver("safe"), N=20,
    B=1024; (d) quad13 on "pallas" and "pallas_fused", N=20; (e) the
    mission's controller on "pallas" and "riccati", 15 scripted ticks;
    (f) the flight node under "safe" and "fastest", 10 ticks."""
    from mpc_blaster_tpu_torch import config as cfg
    from mpc_blaster_tpu_torch.models import quad13 as Q
    from mpc_blaster_tpu_torch.ocp.spec import build_spec
    from mpc_blaster_tpu_torch.parallel.mesh import batched_rti_step
    from mpc_blaster_tpu_torch.sim.closedloop import preset_stage_params
    from mpc_blaster_tpu_torch.sqp import rti as R
    out = {"ticks": [], "loops": [], "shell": []}
    base = cfg.simulation_preset().ocp.solver

    def preset_spec(pre):
        return build_spec(pre.ocp, yref=pre.loop.yref,
                          stage_params=preset_stage_params(pre, device=dev),
                          device=dev)

    # (a) make_rti_step, N=60, from the preset's start
    for backend in ("pallas", "pallas_fused"):
        pre = simulation_ocp(60, solver=dataclasses.replace(
            base, qp_backend=backend))
        x = torch.as_tensor(pre.loop.x0, dtype=torch.float32, device=dev)
        out["ticks"].append(runner_site(
            f"make_rti_step {backend} N=60",
            R.make_rti_step(pre.ocp, device=dev),
            (preset_spec(pre), R.init_rti_state(pre.ocp, x), x)))
    wall("25a make_rti_step")

    # (b) make_closed_loop in every mode
    fields = {"warm4shift": step4_fields("alt_overshoot_warm4shift_m")}
    loops = {
        "pallas": (60, dict(qp_backend="pallas"), {}),
        "pallas_fused": (60, dict(qp_backend="pallas_fused"), {}),
        "fastest": (60, cfg.deployed_solver("fastest"),
                    dict(warm_start=True)),
        "warm4shift": (20, dict(qp_backend="pallas", **fields["warm4shift"]),
                       dict(warm_start=True)),
        "rt4jr4": (20, dict(qp_backend="pallas", lin_backend="fused",
                            ipm_iters=4), dict(jac_refresh=4)),
        "warm_jr": (10, dict(qp_backend="pallas", ipm_iters=4,
                             warm_mode="primal", warm_shift=True),
                    dict(warm_start=True, jac_refresh=4)),
        "online": (60, dict(qp_backend="pallas_fused"),
                   dict(poc_mode="online")),
        "online_stagewise": (60, dict(qp_backend="pallas_fused"),
                             dict(poc_mode="online_stagewise")),
    }
    for name, (N, solver, kw) in loops.items():
        if isinstance(solver, dict):
            solver = dataclasses.replace(base, **solver)
        pre = simulation_ocp(N, solver=solver)
        x = torch.as_tensor(pre.loop.x0, dtype=torch.float32, device=dev)
        if name in ("warm4shift", "rt4jr4", "warm_jr"):
            x = torch.zeros(17, device=dev)
            x[2] = 0.5
        out["loops"].append(loop_site(name, pre.ocp, preset_spec(pre), x,
                                      **kw))
    wall("25b make_closed_loop")

    # (c) the batched ticks, N=20, B=1024
    pre20 = simulation_ocp(20)
    spec20 = build_spec(pre20.ocp, yref=pre20.loop.yref, device=dev)
    x0s = torch.as_tensor(draws(BATCH), device=dev)
    st = R.init_rti_state(pre20.ocp, x0s)
    safe20 = simulation_ocp(20, solver=cfg.deployed_solver("safe"))
    for name, ocp, backend in (
            ("pallas", pre20.ocp, "pallas"),
            ("pallas_fused", fused_ocp(20, FULL_ITERS).ocp, "pallas_fused"),
            ("xla safe", safe20.ocp, "xla")):
        out["ticks"].append(runner_site(
            f"batched {name} N=20 B={BATCH}",
            batched_rti_step(ocp, backend=backend, device=dev),
            (spec20, st, x0s), n=5))
    wall("25c batched ticks")

    # (d) quad13, N=20, from z=1
    qc = Q.Quad13Config(N=20)
    x = Q.hover_state(1.0, device=dev)
    for backend in ("pallas", "pallas_fused"):
        out["ticks"].append(runner_site(
            f"quad13 {backend} N=20", Q.make_quad13_rti_step(
                qc, solver=cfg.SolverConfig(qp_backend=backend,
                                            ipm_iters=SAFE_ITERS),
                device=dev),
            (Q.build_quad13_spec(qc, device=dev),
             Q.init_quad13_rti_state(qc, x), x)))
    wall("25d quad13")

    # (e-f) the flight shell
    for backend in ("pallas", "riccati"):
        out["shell"].append(mission_site(dev, backend))
    for profile in ("safe", "fastest"):
        out["shell"].append(flight_site(dev, profile))
    wall("25e-f mission controller and flight node")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device is visible; this "
                         "script runs the port on an NVIDIA GPU only")
    if sys.argv[1:] == ["--worker"]:
        return worker(torch.device("cuda", 0))
    if sys.argv[1:] == ["--phase", "25"]:
        return run_phase25(torch.device("cuda", 0))
    return run(torch.device("cuda", 0))


def card_line() -> str:
    """The card's name and power limit as nvidia-smi gives them, printed
    on a line of its own."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    return smi


def run_phase25(dev: torch.device) -> int:
    """`python3 chip_smoke.py --phase 25`: the card, the IPM kernel's build
    and phase 25 alone (no kernel report, no contract line)."""
    from mpc_blaster_tpu_torch.ops import box_qp_ipm as K
    card_line()
    KERNEL_WRAPPERS.update({w: getattr(K, w) for w in WRAPPERS})
    so, secs, _ = K.build_library()
    K._library()
    log("build", library=str(so.relative_to(REPO)), nvcc_s=secs)
    wall("1 build")
    phase25(dev)
    wall("25 capture")
    report_failures()
    return 1 if FAILURES else 0


def run(dev: torch.device) -> int:
    from mpc_blaster_tpu_torch import config as cfg
    from mpc_blaster_tpu_torch.ops import box_qp_ipm as K
    from mpc_blaster_tpu_torch.ocp.spec import build_spec
    from mpc_blaster_tpu_torch.parallel.mesh import batched_rti_step

    # ---- phase 0: the card ----
    smi = card_line()
    log("device", nvidia_smi=smi, torch=torch.__version__,
        cuda=torch.version.cuda, name=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count())

    from mpc_blaster_tpu_torch.ops import probes as P
    KERNEL_WRAPPERS.update({w: getattr(K, w) for w in WRAPPERS})
    PROBE_WRAPPERS.update({w: getattr(P, w) for w in PROBES})
    PROLOGUE_WRAPPERS["fused_lin_prologue"] = K.fused_lin_prologue

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
            for B in (1, BATCH):   # the single plan (B=1), the batch plan
                info = K.kernel_info(N, mode, nx, nu, family, soft, B=B)
                check(info["layout"] == ("global" if N > 120 else
                                         "resident")
                      and info["plan"] == ("single" if K.single_plan(mode, B)
                                           else "batch"),
                      "launch plan layout", N=N, B=B, **info)
                log("launch_plan",
                    instance=K.instance_name(nx, nu, family, soft),
                    mode=K._MODE_NAMES[mode], N=N, B=B, **info,
                    ptxas=usage.get((mode, soft, nx, nu, family,
                                     info["threads"])),
                    prologue_ptxas=usage.get(("prologue", nx, nu, family,
                                              soft)),
                    waves={str(b): -(-b // (info["blocks_per_sm"] * sms))
                           for b in ((1,) if B == 1 else (256, BATCH))})
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
    # the single plan's prologue grid alone, at the B=1 fuse_lin shapes
    # of the main path (K3 and K6 of each family)
    pro_rows = [compare_prologue(n, N, dev, K, family=f)
                for n, N, f in (("n20_b1", 20, "blaster"),
                                ("n30_b1", 30, "blaster"),
                                ("n60_b1", 60, "blaster"),
                                ("dist_n30_b1", 30, "blaster_dist"),
                                ("q13_n20_b1", 20, "quad13"))]
    for r in pro_rows:
        log("prologue_vs_plain", **r)
    warm_opts = {"plain_n20_b1": P20_WARM, "plain_n10_b1": P23_WARM}
    warm_rows = [compare_warm(n, mode, N, B, dev, K, **warm_opts.get(n, {}))
                 for n, mode, N, B in (
        ("plain_n8_b3", "plain", 8, 3),
        ("plain_n20_b1024", "plain", 20, BATCH),
        ("plain_n10_b1", "plain", 10, 1),   # phase 19's and 23's
        ("plain_n20_b1", "plain", 20, 1),   # phase 20's warm rows
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
    # B=1 launches (the single plan) and batches (the batch plan) both
    plans = layout_counts(part=1)
    check(set(plans) == {"single", "batch"}, "phases 2-2b plans", got=plans)
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

    # the host-bound paths of phases 17, 19, 20 and 21 in WORKERS worker
    # processes: bench.py's seven remaining quality rows (phase 20: K1,
    # K3 in PLAIN), the blast scan's rows (19a: K6), the step-1 rows,
    # Jacobian reuse and the SQP (19b-c: K1, K3), the four sweeps (17: K1)
    # and the deep SQP with its twins on the CPU (21: K1)
    # phase 23d's CLI runs beside the pool (its result does not depend on
    # time; read in phase 23)
    cli = start_cli()
    pool = run_workers(pool_tasks())
    wall("17, 19 and 20 paths in worker processes")
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
    sweeps = {r: pool[f"sweep:{r}"] for r in SWEEP_JAX}
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

    # phase 19: the blast rows' profile window (19a); the rows and the
    # paths of 19b-c ran in the worker pool before phase 17
    p19 = phase19(dev, {r: pool[f"blast:{r}"] for r in BLAST_ROWS},
                  {p: pool[f"p19:{p}"] for p in P19_PATHS})
    wall("19 blast profile")
    p20 = phase20({r: pool[f"step4:{r}"] for r in STEP4_ROWS}, dev)
    wall("20 step-4 rows timed alone")
    # phase 21: the stress states through every 17x6 instantiation, the
    # recovery loops and the deep SQP
    p21 = phase21(dev, counted, pool["deep:sqp"])
    wall("21 stress states, recovery, deep SQP")
    # phase 22: the solvers off the main path, scale-out, the utilities
    p22 = phase22(dev, K, counted)
    p22["condensed_loops"] = cond_loops({t: pool[f"cond:{t}"]
                                         for t in COND_TASKS})
    wall("22 solvers, sharding, utilities")
    # phase 23: the flight I/O shell, the native runtime, the CLI and the
    # endurance mission
    p23 = phase23(dev, cli)
    wall("23 flight shell, runtime, CLI, mission")
    # phase 24: the horizon ("hp") sharding of the log-depth scans
    phase24(dev, K)
    wall("24 horizon sharding")
    # phase 25: the ticks captured as CUDA graphs against the eager ticks
    phase25(dev)
    wall("25 capture")
    # the prologue grid's launches on the counted paths, the worker
    # pool's included
    pro_paths = dict(PROLOGUE_LAUNCHES)
    for row in pool.values():
        for k, v in row.get("prologue_launches", {}).items():
            pro_paths[k] = pro_paths.get(k, 0) + v
    check(sum(pro_paths.values()) > 0, "the prologue grid ran on the "
          "main path", launches=pro_paths)

    if FAILURES:
        report_failures()
        raise SystemExit(f"chip_smoke: {len(FAILURES)} check(s) failed")

    main_row = next(r for r in rows if r["case"] == "n60_b1")
    cost_main = next(r for r in cost_rows if r["case"] == "n20_b1024")
    lin_main = next(r for r in lin_rows if r["case"] == "n60_b1")
    lin_n20 = next(r for r in lin_rows if r["case"] == "n20_b1")  # rt6f
    lin_stagewise = next(r for r in lin_rows
                         if r["case"] == "n60_b1_stagewise")
    warm_main = next(r for r in warm_rows if r["case"] == "fuse_lin_n60_b1")

    soft_main = next(r for r in soft_rows if r["case"] == "fuse_lin_n60_b1")
    pro_main = next(r for r in pro_rows if r["case"] == "n60_b1")

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
    k1_19.update({f"phase20_{k}": v for k, v in p20["k1"].items()})
    l21 = p21["launches"]
    # phase 21's guarded "fastest" ticks: the tick (K3) and the redo
    # (valid=0, the cold solve: K6), one each per tick
    k3_21 = l21["k3_fastest"]["fused_rti_solve"] // 2
    k1_19.update({"phase21_k1_batched": l21["k1_batched"]["box_qp_solve"],
                  "phase21_recovery": l21["recovery_k1_pallas"],
                  "phase21_deep_sqp": l21["deep_sqp"]})
    l22 = p22["launches"]
    k1_19.update({k: l22[k] for k in ("phase22_sharded_k1_pallas",
                                      "phase22_nccl_tick")})
    k6b_22 = {k: l22[k] for k in ("phase22_sharded_k6_safe",
                                  "phase22_sharded_sweep")}
    k6_21 = {"phase21_k6_b1_safe": l21["k6_b1_safe"]["fused_rti_solve"],
             "phase21_k3_fastest_redo": k3_21,
             "phase21_recovery_safe": l21["recovery_k6_safe"]}
    l23, c23 = p23["launches"], p23["captured"]
    k1_19.update({f"phase23_{k}": l23[k]
                  for k in ("k1_mission", "k1_mission_skipped_redo")})
    k6_21.update({"phase23_flight_safe": l23["k6_safe"],
                  "phase23_flight_fastest_cold_and_redo":
                  l23["k6_fastest_cold_and_redo"]})
    k3_23 = {"phase23_flight_fastest": l23["k3_fastest"],
             "phase23_mission": l23["k3_mission"]}
    k4_21 = {f"phase21_{k}": sum(v.values()) // 2 for k, v in l21.items()
             if k.startswith("k4")}
    warm_n20 = next(r for r in warm_rows if r["case"] == "plain_n20_b1")

    def stress_ms(*cases):
        """Phase 21's timed launches (kernel, twin ms) of these cases."""
        return {k: [p21["cases"][k]["timed_launch"]["kernel_ms"],
                    p21["cases"][k]["timed_launch"]["plain_ms"]]
                for k in cases}
    report = {"kernels": [
        entry("box_qp_ipm", c3["box_qp_solve"] + c4["box_qp_solve"]
              + sweep_launches + sum(k1_19.values()), rows,
              main_row, launch_bound("plain", 60, 1, FULL_ITERS),
              **launch_keys(K, 60, K.PLAIN),
              max_obj_rel_err=max(r["obj_rel_err"] for r in rows),
              launches_by_path={"batched_tick": c3["box_qp_solve"],
                                "closed_loop": c4["box_qp_solve"],
                                "sweeps": sweep_launches, **k1_19},
              stress_ms=stress_ms("k1_batched")),
        entry("box_qp_ipm_fuse_cost",
              fused_launches + l21["k5_batched"]["batched_fused_tick"],
              cost_rows, cost_main,
              launch_bound("fuse_cost", 20, BATCH, FULL_ITERS),
              **launch_keys(K, 20, K.FUSE_COST, B=BATCH),
              ms_6it=cost_main["kernel_ms_6it"],
              plain_ms_6it=cost_main["plain_ms_6it"],
              tick_ms={str(k): v for k, v in fused_tick_ms.items()},
              launches_by_path={"batched_fused_tick": fused_launches,
                                "phase21_k5_batched": l21["k5_batched"][
                                    "batched_fused_tick"]},
              stress_ms=stress_ms("k5_batched")),
        entry("box_qp_ipm_fuse_lin",
              lin_launches + sum(r["launches"] for r in fig8.values())
              + p19["blast_launches"] + sum(k6_21.values()),
              lin_rows, lin_main,
              launch_bound("fuse_lin", 60, 1, FULL_ITERS),
              **launch_keys(K, 60, K.FUSE_LIN, family="blaster"),
              ms_6it=lin_main["kernel_ms_6it"],
              plain_ms_6it=lin_main["plain_ms_6it"],
              launches_by_path={"fused_closed_loops": lin_launches,
                                **{f"figure8_{k}": r["launches"]
                                   for k, r in fig8.items()},
                                "phase19_blast_scan": p19["blast_launches"],
                                **k6_21},
              stagewise=[lin_stagewise["kernel_ms"],
                         lin_stagewise["plain_ms"]],
              blast_ms_per_tick_in_pool={
                  k: r["ms_per_tick"] for k, r in p19["blast"].items()},
              stress_ms=stress_ms("k6_b1_safe"),
              ms_n20_6it=lin_n20["kernel_ms_6it"],
              plain_ms_n20_6it=lin_n20["plain_ms_6it"],
              bound_ms_n20_6it=launch_bound("fuse_lin", 20, 1,
                                            SAFE_ITERS)["bound_ms"],
              prologue_max_abs_err=max(
                  max(r["prologue_max_abs_err"].values())
                  for r in lin_rows)),
        {"name": "box_qp_ipm_warm", "route": "cuda", "source": KERNEL_SOURCE,
         "replaces": REPLACES["box_qp_ipm_warm"],
         "launches": warm_launches + sum(p19["k3"].values())
         + sum(p20["k3"].values()) + k3_21 + sum(k3_23.values()),
         "launches_by_path": {"fuse_lin_warm_chains": warm_launches,
                              **{f"phase19_{k}_plain": v
                                 for k, v in p19["k3"].items()},
                              **{f"phase20_{k}_plain": v
                                 for k, v in p20["k3"].items()},
                              "phase21_k3_fastest": k3_21, **k3_23},
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
         "altitude_overshoot_m": alt,
         "stress_ms": stress_ms("k3_fastest"),
         "ms_plain_n20_b1": {f"{it}it": [warm_n20[f"kernel_ms_{it}it"],
                                         warm_n20[f"plain_ms_{it}it"],
                                         warm_n20[f"cold_kernel_ms_{it}it"]]
                             for it in P20_WARM["time_iters"]},
         "step4_ms_per_tick": {k: r["ms_per_tick_solo"]
                               for k, r in p20["rows"].items()}},
        {"name": "box_qp_ipm_soft", "route": "cuda", "source": KERNEL_SOURCE,
         "replaces": REPLACES["box_qp_ipm_soft"],
         "launches": sum(v["soft_launches"] for v in soft_loop.values())
         + sum(k4_21.values()),
         "launches_by_path": {"soft_loops": sum(
             v["soft_launches"] for v in soft_loop.values()), **k4_21},
         "stress_ms": stress_ms("k4_soft_pallas", "k4_soft_fused"),
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
         "launches": c16["fused_rti_solve"]
         + l21["k6_batched_safe"]["fused_rti_solve"] + sum(k6b_22.values()),
         "launches_by_path": {"batched_xla_safe": c16["fused_rti_solve"],
                              "phase21_k6_batched_safe": l21[
                                  "k6_batched_safe"]["fused_rti_solve"],
                              **k6b_22},
         "stress_ms": stress_ms("k6_batched_safe"),
         "max_abs_err": max(r["max_abs_err_1it"]
                            for r in kb_rows + [kb_time,
                                                p22["sweep_kernel_row"]]),
         "ms": kb_time["kernel_ms_6it"], "plain_ms": kb_time["plain_ms_6it"],
         "iters": SAFE_ITERS,
         **bound_keys(launch_bound("fuse_lin", 20, BATCH, SAFE_ITERS)),
         **launch_keys(K, 20, K.FUSE_LIN, family="blaster", B=BATCH),
         "ms_12it": kb_time["kernel_ms"],
         "plain_ms_12it": kb_time["plain_ms"],
         "bound_ms_12it": kb_time["bound_ms"],
         "fuse_cost_ms": {"6": kb_time["fuse_cost_ms_6it"],
                          "12": kb_time["fuse_cost_ms"]},
         "tick": xla_fused,
         "sharded_sweep": p22["sharded_sweep"],
         "by_shape": {r["case"]: r for r in kb_rows + [kb_time,
                                                      p22["sweep_kernel_row"]]}},
        {"name": "box_qp_ipm_prologue", "route": "cuda",
         "source": KERNEL_SOURCE,
         "replaces": REPLACES["box_qp_ipm_prologue"],
         "launches": sum(pro_paths.values()),
         "launches_by_path": pro_paths,
         "max_abs_err": max(r["max_abs_err"] for r in pro_rows),
         "ms": pro_main["kernel_ms"], "plain_ms": pro_main["plain_ms"],
         **bound_keys(pro_main), "replay_ms": pro_main["replay_ms"],
         "prologue_blocks": pro_main["prologue_blocks"],
         "by_shape": {r["case"]: {k: r[k] for k in (
             "kernel_ms", "replay_ms", "plain_ms", "bound_ms",
             "max_abs_err")} for r in pro_rows}},
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
    # phase 23's shapes: each launch's kernel and twin ms, its bound and
    # the largest error held pointwise to the twin at that shape, and where
    wc = dict(p23["warm_cases"], plain_n10_b1=next(
        r for r in warm_rows if r["case"] == "plain_n10_b1"))
    one_it = "one iteration, the captured launch"
    p23_shapes = {
        "box_qp_ipm": (("k1_plain_n10_6it", "plain", 10, SAFE_ITERS, False,
                        c23["k1_plain_n10_6it"]["max_abs_err_1it"],
                        one_it),),
        "box_qp_ipm_fuse_lin": (("k6_fuse_lin_n30_6it", "fuse_lin", 30,
                                 SAFE_ITERS, False,
                                 c23["k6_fuse_lin_n30_6it"][
                                     "max_abs_err_1it"], one_it),),
        "box_qp_ipm_warm": (
            ("k3_fuse_lin_n30_3it", "fuse_lin", 30, FASTEST_ITERS, True,
             wc["fuse_lin_n30_b1"]["max_abs_err_1it"],
             "one iteration, phase 2's warm case (also held at 3)"),
            ("k3_plain_n10_6it", "plain", 10, SAFE_ITERS, True,
             wc["plain_n10_b1"]["blend_max_abs_err"],
             "the blend, phase 2's warm case (objective and kkt_eq held "
             "at 6 and 12 iterations)"))}
    for e in report["kernels"]:
        for key, mode, N, iters, warm, err, held in p23_shapes.get(
                e["name"], ()):
            r = c23[key]
            e["phase23_" + key] = {
                "kernel_ms": r["kernel_ms"], "plain_ms": r["plain_ms"],
                "bound_ms": launch_bound(mode, N, 1, iters,
                                         warm=warm)["bound_ms"],
                "max_abs_err": err, "held": held}
            e["max_abs_err"] = max(e["max_abs_err"], err)
    wall("report")
    print(json.dumps(report), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
