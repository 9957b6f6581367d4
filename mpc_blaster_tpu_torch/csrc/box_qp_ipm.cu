// Batched box-constrained OCP-QP interior-point solve for Hopper (sm_90a).
//
// Replaces mpc_blaster_tpu/ops/pallas_ipm.py::_ipm_kernel in three of its
// modes (resident), hard or soft-bounded, with the in-kernel algebra of
// that file (_contractT, _contractT_vec, _matvec, _chol_inverse_lanes). One
// launch runs the whole Mehrotra predictor-corrector solve -- init, every IPM
// iteration, best-merit tracking and the final KKT sweep -- for a batch of
// problems. The mode is a template parameter of the kernel:
//
//   PLAIN      host-assembled QP in, deltas out (pallas_box_qp_solve);
//   FUSE_COST  host-linearized A/B/c in; the cost gradients, delta bounds and
//              dx0 are assembled in the kernel from the iterate and the spec,
//              and a last pass writes the updated ABSOLUTE iterate and the
//              step norms / worst box violation (pallas_batched_fused_tick);
//   FUSE_LIN   FUSE_COST's assembly plus a linearization prologue: RK4 of a
//              rows-form ODE on forward-mode dual numbers gives A, B and c
//              for every node inside the kernel; deltas out
//              (pallas_fused_rti_solve: the one-launch B=1 tick, and under
//              jax.vmap the batched tick over a "pallas_fused" solver;
//              every per-problem input, the lin record and the workspace
//              are strided by blockIdx.x, so B > 1 is the same launch).
//
// The model's dimensions NX, NU and, in FUSE_LIN, its ODE family are
// template parameters too, as the Pallas kernel takes its dimensions from
// the arrays and its prologue's ODE from dynamics/fastlin.py::FAMILIES:
// BLASTER (17x6, _ode_rows), BLASTER_DIST (17x6, _ode_rows_dist: the
// offset-free observer's six disturbance estimates ride in stage
// parameters 25-30) and QUAD13 (13x4, _quad13_rows: the quaternion
// quadrotor of models/quad13.py, no stage parameters). The extern "C"
// entries dispatch on (nx, nu, family) to the instantiations built here:
// PLAIN hard and soft, FUSE_COST hard, FUSE_LIN BLASTER hard and soft and
// BLASTER_DIST hard at 17x6; PLAIN hard and FUSE_LIN QUAD13 hard at 13x4.
// Any other combination returns cudaErrorInvalidValue (the Python
// wrappers refuse it first).
//
// Every mode takes an optional slack/dual warm start (the Pallas kernel's
// static `warm_on` variant, pallas_ipm.py:402-421, applied after the centred
// init as at :580-586): per problem with valid > 0.5, each cold slack of a
// finite bound is replaced by the previous tick's value clipped to
// [1e-5, 1e20] and each dual by its value clipped to [0, LAM_MAX] and
// floored at 1e-8, wherever the clipped value is finite (NaN falls back to
// the cold value; +inf clips and is taken). The blend runs once per launch,
// so it is a runtime switch (null warm pointers = cold solve, valid = 0
// reproduces the cold solve bit for bit), not a template parameter. An
// optional device flag `skip` makes every block return at once, before it
// touches shared memory: the divergence watchdog enqueues its cold redo
// every tick and lets the device decide whether it runs
// (sqp/rti.py::rti_step_warm_guarded).
//
// SOFT bounds (kernel K4, the Pallas kernel's static `soft` flag,
// pallas_ipm.py:249-257 and :457-1034; the acados ns>0 analog of
// qp/soft.py) are the second template parameter, instantiated for PLAIN and
// FUSE_LIN only (the Pallas fuse_cost tick has no soft form), so the hard
// instantiations compile exactly as before. Each bound row gains a
// violation pair (t, gam) with penalty z t + Z/2 t^2, eliminated row by
// row: the factorization takes sig_eff = sig_s (Z + sig_t) / (Z + sig_s +
// sig_t) with sig_s capped at SIGMA_MAX first and the pair sum capped again;
// the right-hand side gains -sig_s w / den; dt and dgam are recovered after
// each solve; t gam joins the complementarity sum and the pair count,
// |z + Z t - lam - gam| the best-iterate merit, t and gam the
// fraction-to-boundary ratios. Only hard rows are inset by the init clamp;
// soft rows start at t = max(-gap, 0) + 0.1, gam = mu0 / t. The host marks
// hard and infinite rows with the sentinel Z = 1e18, z = 0, and the kernel
// reads a row as soft where its bound is finite and Z < 5e17. A hard row
// takes sig_s itself, never the formula: with the sentinel the formula
// rounds to sig_s only within one ulp in float32 (measured with numpy:
// fl(fl(x 1e18) / 1e18) != x for about a tenth of all x), and on a hard row
// Z t overflows to inf, so every soft term is selected per row, never
// multiplied by a 0/1 mask. Soft and warm starts do not combine (null warm
// pointers when the penalty pointers are set).
//
// The soft instantiations keep a soft area beside the stacks: per bound
// entry its class (infinite, hard or soft; init classifies every entry
// once per launch, so no row pass reads a bound or Z to learn it), its
// pair (t, gam), its penalty (Z, z), its sig_s and the pair's denominator
// (formed once per iteration by the factorization's weight pass), and
// four words the row passes hand on: rhs_grads leaves the predictor's w,
// alphas the affine directions (read by mu_aff_sum and by the corrector's
// rhs_grads, which forms the targets Ts, Tt once and leaves them with its
// w), the corrector's alphas the directions that update applies. Every
// soft term is so formed once per row and iteration, not once per use
// (about eight times before), with the operations of the one-formula form
// in their order: the results are the same bits (checked with g++ against
// tests/cuda_cpu/, tests/test_torch_kernel_cpu.py). The area is sized for
// every row being soft (10 words and a class byte per entry, so the plan
// stays a function of N) and lives in dynamic shared memory where it fits
// beside the stacks (17x6 up to N=61: N=60 takes 227,780 B, one block per
// SM), else in the global workspace (N=120).
//
// The plain PyTorch twins are ops/box_qp_ipm.py::box_qp_solve_plain,
// batched_fused_tick_plain and fused_rti_solve_plain (the prologue's twin is
// dynamics/fastlin.py::fast_linearize); each follows the same operation
// order.
//
// What bounds it on this card: per problem the solve is a chain of
// O(N * iters) small dependent steps (17x17 products, a 6x6 factorization;
// 13x13 and 4x4 for QUAD13) -- latency, not FLOPs or bytes (N=60, 12
// iterations is ~33 MFLOP and ~0.15 MB of inputs and outputs). The layout
// shortens that chain and keeps memory latency off it:
//
//   - One problem per block. The host picks one of two plans from B and
//     the mode alone (box_qp_ipm_plan, ops/box_qp_ipm.py::launch_plan):
//     the batch plan, 128 threads (four warps, __launch_bounds__(128, 2):
//     two blocks per SM at B=1024), a batch of B problems B blocks; and
//     the single plan for B=1 in PLAIN and FUSE_LIN (the flight loop's
//     ticks, the warm launches of kernel K3), 256 threads
//     (__launch_bounds__(256, 1)): the launch has one SM to itself, and
//     eight warps of it shorten the block's phases. The solve's thread
//     count is a template parameter (THREADS), so each instantiation of
//     BUILT has a kernel per plan (FUSE_COST, the batched tick, only the
//     batch plan's). A matrix phase of the Riccati factorization gives
//     each thread a 2x2 tile of its products (P'A, P'B; B'PB, B'PA,
//     A'PA): four independent 17-long sums in registers, each
//     shared-memory operand feeding two of them (the phases are bound by
//     shared-memory loads, not FMAs). The single plan computes A'PA (read
//     only by P_k) on warps 1-3 and 5-7 (not on warp 0's SM
//     sub-partition) while warp 0 runs the Cholesky inverse; its row
//     passes and the block's loops over stages stride by its 256 threads.
//   - The single plan takes the FUSE_LIN prologue off the solve's block:
//     its N ceil((NX + NU) / 2) items (720 at N=60, each an RK4 of the
//     ODE on dual numbers, the prologue's whole time at ~6 items a thread
//     on 128 threads) run as a grid of their own (box_qp_ipm_prologue,
//     one item a thread in blocks of LIN_THREADS, on as many SMs) that
//     writes the record the solve then reads, on the same stream before
//     the solve: two launches, which a CUDA graph captures in order. The
//     grid runs the batch plan's Solver::linearize_items, the one compiled
//     prologue both plans call, so the two records are the same bits. A
//     thread-block cluster whose other CTAs linearize into the leader's
//     record would do the same work in one launch; it was not built or
//     timed (the record lives in global memory either way, since the ring
//     streams A_k and B_k from it). The prologue grid can also be launched
//     alone (`iters` = PROLOGUE_ONLY at B=1), to time and check it apart.
//   - The Riccati factor stacks P_0..P_N, Z_0..Z_{N-1} and Hinv_0..Hinv_{N-1}
//     live in dynamic shared memory (the "resident" layout, opted in up to
//     232448 B per block, the card's ceiling measured by probe P1) whenever
//     they fit with the per-stage scratch and the ring: every 17x6 horizon
//     up to N=128 (103,636 B of stacks at N=60: two blocks per SM). Past
//     that (17x6 N=240) they stay in the global workspace (the "global"
//     layout) and the factorization works in a two-slot shared window of
//     P, Z and Hinv that it copies out. The host's plan (smem_bytes /
//     resident, box_qp_ipm_plan) picks the layout from N and the
//     instantiation alone.
//   - A four-slot ring in shared memory holds, per stage, A_k, B_k and
//     the vectors the current sweep reads (the right-hand sides, the
//     shooting residuals, kff, the KKT pass's stage terms and multipliers).
//     The factorization's threads load A_{k-1}, B_{k-1} into registers at
//     the top of stage k and store them at its end. The vector sweeps of a
//     solve, the KKT pass's adjoint sweep and the init rollout run on warp
//     0 while warps 1-3, idle there, fill the ring: each loads a stage with
//     coalesced plain loads, waits until its slot is free, stores it and
//     raises the slot's `full` flag; warp 0 polls the flag and, done with
//     the stage, raises `empty` (shared-memory flags, ordered by
//     __threadfence_block). So the sweeping warp never waits on global
//     memory. (cp.async was measured first: four-byte copies, all a
//     stage's 17x17 block offers in alignment, took ~90 cycles each of
//     the sweeping warp's time, more than the stage's arithmetic.)
//   - In a sweep, lanes 0..NX-1 own the state rows and lanes NX..NX+NU-1
//     the control rows; the carries stay in registers and reach the other
//     lanes by __shfl_sync, and every product of a stage is one uniform
//     instruction stream (a lane-dependent column and stride). The
//     stage-invariant P_k' req_{k-1} is formed a stage ahead; the KKT
//     pass's Qs' dx_k + q_k and R' du_k + r_k are formed for all stages by
//     the block before its sweep. The other warps meet warp 0 at the block
//     barriers that open and close each sweep.
//   - The factorization's barrier weights are computed for every row in
//     one pass before it, and each stage's diagonal terms are loaded one
//     stage ahead.
//   - The NU x NU equilibrated Cholesky inverse runs on one warp: a lane
//     per row of the factor (pivots and rows by shuffles), a lane per
//     column of its inverse, a lane per entry of the product; warp 0 then
//     forms Z_k = Hinv_k Hux_k. The fail-safe (the zero matrix for a
//     non-positive diagonal or a pivot <= 1e-10) is kept; every operation
//     of the one-thread form is kept, in its order.
//
// Block barriers per stage and IPM iteration: 4, all in the factorization
// (PA|PB; Huu|Hux|A'PA, the single plan's A'PA in the next phase; the
// Cholesky inverse and Z on warp 0; the
// symmetrized P_k, computed for a pair (i, j) with i <= j by one thread as
// 0.5 (Pt_ij + Pt_ji) and written to both entries). The sweeps take none
// per stage (the ring's flags and __syncwarp); each sweep and each row pass
// adds two or three barriers per iteration, not per stage. Every output
// keeps the operation order of the one-thread-per-output form: the same
// products in the same order, so a fused multiply-add is contracted the
// same way. The per-problem block sums (complementarity, mu_aff) keep the
// order of a 256-thread block in both plans (`block_sum`), and the maxima,
// minima and counts do not depend on an order, so the two plans give the
// same bits: with g++ against tests/cuda_cpu/
// (tests/test_torch_kernel_cpu.py) and on the card, where nvcc contracts
// both plans' multiply-adds alike as long as their tiles and their
// FUSE_LIN Solver's layout are the same (tests/test_torch_cuda.py).
//
// The long-horizon variants of the Pallas kernel (stream_p / stream_big,
// pallas_ipm.py:293-393, kernel K7) stream P, the A/B record and the Z
// gains between HBM and VMEM once an instance outgrows the TPU's resident
// budget. Here a B=1 hard PLAIN launch at N >= CLUSTER_MIN_N takes the
// cluster plan below instead; every other launch keeps the two layouts
// above (resident while the stacks fit, global past it: N=240 at B=256).
// The wrappers accept the streaming flags and select nothing with them.
//
// The cluster plan (kernel K7 on Hopper). One problem's horizon is split
// over a thread-block cluster of cluster_ctas(N) CTAs of SINGLE_THREADS
// threads each (8 at N=120 and 240; launched with cudaLaunchKernelEx and a
// cluster-dimension attribute, which a CUDA graph captures), one
// contiguous chunk of stages per CTA in stage order: CTA j takes stages
// chunk_start(j) .. chunk_start(j + 1) - 1. Each CTA keeps its chunk's P,
// Z and Hinv resident in its own shared memory (30 stages, ~52 KB at
// N=240). It owns its chunk's stage vectors, the states dx_k of its stages
// (the last CTA also dx_N) and their bound rows, so no CTA reads global
// memory that another wrote: what crosses a chunk boundary goes through
// distributed shared memory (cluster.map_shared_rank) between
// cluster.sync()s.
//   - The row passes and the stage terms run on every CTA at once, each on
//     its chunk. A block sum is reduced per chunk in the 256-thread order
//     (block_sum), then the chunks' sums are added in rank (stage) order
//     (cluster_combine); maxima, minima and counts do not depend on an
//     order.
//   - The factorization is a chunked scan of the value-function elements
//     (A_k, B_k R_k^-1 B_k', Q_k) of qp/pscan.py::riccati_factorize_pscan
//     (`factorize`): every CTA but the first reduces its
//     chunk to its total by the single plan's Riccati stage body from
//     P = 0 (the last CTA from P_N: its recursion is already the true
//     one); rank 0 walks the C-2 boundaries between, one NX x NX solve
//     each (P <- J_T + A_T' P (I + C_T P)^-1 A_T); every other CTA then
//     runs its chunk's recursion from its true P_{ke+1} and forms its
//     chunk's closed-loop transition F_ke ... F_ks (F_k = A_k - B_k Z_k)
//     for the solves. The path is ~2N/C stage bodies and C-2 solves
//     instead of N stage bodies. (The sequential chain handed from CTA to
//     CTA, as the JAX package's riccati="hybrid", was measured beside it:
//     PERF.md, PR 18.)
//   - The five vector sweeps (each solve's backward p_k = F_k' p_{k+1} +
//     h_k and forward dx_{k+1} = F_k dx_k + g_k, the KKT pass's adjoint
//     sweep on A_k') are chunked affine scans, the maps of
//     qp/pscan.py::riccati_solve_rhs_pscan: (1) every CTA sweeps its chunk
//     from a zero boundary, the chunk that holds the true boundary from
//     it; (2) rank 0 runs the C-2 boundary steps b <- M_j b + out_j (M_j'
//     in a backward scan) on the other CTAs' shared memory, M_j the
//     chunk's product of F (formed once per factorization) or of A (once
//     per launch, for the KKT pass); (3) every other CTA sweeps its chunk
//     again from its true boundary. The critical path is ~2N/C + C steps
//     instead of N.
//   - The init rollout (a clamped recursion, not an affine one; once per
//     launch) runs CTA by CTA, each handing its last state on.
// The scans' boundaries round otherwise than the sequential sweeps, so
// the plan has bits of its own: the twin follows its order where
// launch_plan gives a cluster (ops/box_qp_ipm.py::box_qp_solve_plain,
// `chunks`), and every other plan keeps its bits.
//
// Interface: plain C (loaded with ctypes), float32, contiguous problem-major
// tensors; launches on the caller's stream and returns cudaGetLastError().
// Before the first launch of an instantiation the host calls
// box_qp_ipm_set_optin, which opts it in to SMEM_OPTIN bytes of dynamic
// shared memory; a launch whose plan exceeds that is refused. The
// FUSE_LIN prologue (`Solver::linearize_items`) is compiled out of line, so
// that the registers its dual numbers take do not crowd the solve's loops.
// Build without --use_fast_math: the guards rely on IEEE division, square
// root, sin/cos/tan and NaN behaviour.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace cg = cooperative_groups;

namespace {

// Threads per block of the two launch plans (a template parameter of the
// solve): the batch plan's four warps, two blocks per SM at B=1024,
// and the single-problem plan's eight warps for a B=1 launch, which has
// one SM to itself.
constexpr int BATCH_THREADS = 128;
constexpr int SINGLE_THREADS = 256;
// warps 1..PRODUCERS fill the ring in either plan
constexpr int PRODUCERS = 3;
// threads per block of the single plan's FUSE_LIN prologue grid
constexpr int LIN_THREADS = 128;
constexpr unsigned FULL = 0xffffffffu;
// The most dynamic shared memory one block may opt in to on the H100
// (cudaDevAttrMaxSharedMemoryPerBlockOptin; probe P1 reads it back).
constexpr long long SMEM_OPTIN = 232448;
// Tangent columns the FUSE_LIN prologue carries per thread (two
// independent chains on one value part).
constexpr int LIN_COLS = 2;
// The cluster plan: a B=1 hard PLAIN launch at N >= CLUSTER_MIN_N splits
// its horizon over min(CLUSTER_CTAS, N / CLUSTER_CHUNK_MIN) CTAs (a
// function of N alone, so the bits do not depend on the card).
constexpr int CLUSTER_MIN_N = 61;
constexpr int CLUSTER_CTAS = 8;
constexpr int CLUSTER_CHUNK_MIN = 4;
// words of a boundary-vector slot of the cluster area (one lane each) and
// of a cluster reduction slot
constexpr int CL_VEC = 32;
constexpr int CL_RED = 4;

constexpr float BIG = 1e20f;        // slack of a masked (infinite) bound
constexpr float MTHR = 5e17f;       // |bound| above this is infinite
constexpr float S_MIN = 1e-3f;
constexpr float MU_MIN = 1e-7f;
constexpr float SIGMA_MAX = 1e7f;
constexpr float LAM_MAX = 1e7f;
constexpr float EPS_S = 1e-9f;
constexpr float DUAL_CLIP = 1e12f;
constexpr float WARM_S_MIN = 1e-5f;  // S_MIN * 1e-2, the warm slack floor

enum Mode : int { PLAIN = 0, FUSE_COST = 1, FUSE_LIN = 2 };
// The FUSE_LIN prologue's ODE (dynamics/fastlin.py::FAMILIES); PLAIN and
// FUSE_COST instantiate with BLASTER and never read it.
enum Family : int { BLASTER = 0, BLASTER_DIST = 1, QUAD13 = 2 };

// NaN-propagating min/max/clip, as jnp.minimum/maximum/clip and
// torch.minimum/maximum/clamp behave (fminf/fmaxf drop NaNs).
__device__ __forceinline__ float nmax(float a, float b) {
  return (a > b || a != a) ? a : b;
}
__device__ __forceinline__ float nmin(float a, float b) {
  return (a < b || a != a) ? a : b;
}
__device__ __forceinline__ float clipf(float x, float lo, float hi) {
  return nmin(nmax(x, lo), hi);
}

struct OpSum {
  __device__ float operator()(float a, float b) const { return a + b; }
};
struct OpMax {
  __device__ float operator()(float a, float b) const { return nmax(a, b); }
};
struct OpMin {
  __device__ float operator()(float a, float b) const { return nmin(a, b); }
};

// Per-problem reduction across the block of WARPS warps; every thread gets
// the result.
template <int WARPS, class Op>
__device__ float block_reduce(float v, float* red, Op op) {
  for (int o = 16; o > 0; o >>= 1) {
    v = op(v, __shfl_xor_sync(FULL, v, o));
  }
  __syncthreads();  // earlier readers of red are done
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float out = red[0];
  for (int w = 1; w < WARPS; ++w) out = op(out, red[w]);
  return out;
}

// The per-problem sums keep the summation order of a 256-thread block
// (SUM_THREADS): thread t of a THREADS-thread block carries the partial
// sums of the virtual threads t + h THREADS (h < SUM_THREADS / THREADS:
// in the batch plan t and t + 128, rows t, t + 256, ... and t + 128,
// t + 384, ...; in the single plan t alone), each is reduced over its
// virtual warp by the same butterfly, and the eight warp sums are added
// in order. Rounding then does not depend on the block size or the plan:
// a sum over 128 threads would part from the twin's and the earlier
// kernels' f32 trajectories on unconverged solves.
constexpr int SUM_THREADS = 256;
constexpr int SUM_WARPS = SUM_THREADS / 32;
template <int THREADS>
__host__ __device__ constexpr int sum_parts() {
  static_assert(SUM_THREADS % THREADS == 0, "whole virtual threads");
  return SUM_THREADS / THREADS;
}

template <int THREADS>
__device__ float block_sum(const float (&v)[sum_parts<THREADS>()],
                           float* red) {
  constexpr int VT = sum_parts<THREADS>(), WARPS = THREADS / 32;
  float a[VT];
#pragma unroll
  for (int h = 0; h < VT; ++h) a[h] = v[h];
  for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
    for (int h = 0; h < VT; ++h) a[h] = a[h] + __shfl_xor_sync(FULL, a[h], o);
  }
  __syncthreads();  // earlier readers of red are done
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int h = 0; h < VT; ++h) red[h * WARPS + (threadIdx.x >> 5)] = a[h];
  }
  __syncthreads();
  float out = red[0];
  for (int w = 1; w < SUM_WARPS; ++w) out = out + red[w];
  return out;
}

// The ring's flags: shared-memory words written by one warp and polled by
// another, ordered with __threadfence_block on both sides.
__device__ __forceinline__ int ld_volatile(const int* p) {
  return *(const volatile int*)p;
}
__device__ __forceinline__ void st_volatile(int* p, int v) {
  *(volatile int*)p = v;
}

// Floats of the FUSE_LIN prologue's record per problem: A (N, NX, NX),
// B (N, NX, NU), c (N, NX).
template <int NX, int NU>
__host__ __device__ size_t lin_floats(int N) {
  return (size_t)N * (NX * NX + NX * NU + NX);
}

// The ring: RING_SLOTS slots, each A_k, B_k and the stage's vectors of
// the sweep that reads it (at most 3 (NX + NU) words, the KKT sweep's).
constexpr int RING_SLOTS = 4;
template <int NX, int NU>
__host__ __device__ constexpr int ring_stage() {
  return NX * NX + NX * NU + 3 * (NX + NU);
}

// ---- shared-memory plan -------------------------------------------------
// Dynamic shared memory of a block: the per-stage scratch (Shared), the A/B
// ring, then the factor stacks (resident) or the factorization's window
// (global). Everything is float, so the byte count is 4 x the floats.
template <int NX, int NU>
struct Shared {
  static constexpr int NXX = NX * NX;
  float PA[NXX];       // P_{k+1}' A_k
  float APA[NXX];      // A_k' P_{k+1} A_k
  float PB[NX * NU];   // P_{k+1}' B_k
  float Hux[NU * NX];  // B_k' P_{k+1} A_k
  float Huu[NU * NU];
  float L[NU * NU];    // the Cholesky inverse's factor and its inverse
  float Li[NU * NU];
  float red[SUM_WARPS];  // block reductions (a slot per warp, and per
                        // virtual warp of the sums)
  int full[RING_SLOTS];   // the sweep step whose data a slot holds
  int empty[RING_SLOTS];  // the last step a slot served
};

template <int NX, int NU>
__host__ __device__ constexpr int shared_floats() {
  return 2 * NX * NX + 2 * NX * NU + 3 * NU * NU + SUM_WARPS + 2 * RING_SLOTS;
}
static_assert(sizeof(Shared<17, 6>) == 4 * shared_floats<17, 6>(), "");
static_assert(sizeof(Shared<13, 4>) == 4 * shared_floats<13, 4>(), "");

template <int NX, int NU>
__host__ __device__ size_t stack_floats(int N) {  // P, Z, Hinv
  return (size_t)(N + 1) * NX * NX + (size_t)N * NU * NX + (size_t)N * NU * NU;
}

// the factorization's window of the global layout: two P slots, one Z,
// one Hinv
template <int NX, int NU>
__host__ __device__ constexpr int window_floats() {
  return 2 * NX * NX + NU * NX + NU * NU;
}

template <int NX, int NU>
__host__ __device__ bool resident(int N) {
  const size_t f = shared_floats<NX, NU>()
                   + RING_SLOTS * ring_stage<NX, NU>()
                   + stack_floats<NX, NU>(N);
  return 4 * f <= (size_t)SMEM_OPTIN;
}

template <int NX, int NU>
__host__ __device__ size_t smem_bytes(int N) {
  const size_t f = shared_floats<NX, NU>()
                   + RING_SLOTS * ring_stage<NX, NU>()
                   + (resident<NX, NU>(N) ? stack_floats<NX, NU>(N)
                                          : (size_t)window_floats<NX, NU>());
  return 4 * f;
}

// The soft area (SOFT only): per bound entry of the four groups (lx, ux
// with N NX entries each, lu, uu with N NU each) SOFT_WORDS float fields,
// one array per field, then one class byte per entry. Sized for every row
// being soft, so that the plan stays a function of N; in shared memory,
// after the stacks or the window, where it fits under SMEM_OPTIN, else in
// the global workspace.
constexpr int SOFT_WORDS = 10;
// the fields: the violation pair (t, gam) and the penalty (Z, z) for the
// launch; sig_s and the eliminated pair's denominator Z + sig_s + gam / t
// per iteration; four words handed from one row pass to the next (W0-W3)
enum SoftField : int { F_T, F_GAM, F_Z, F_ZL, F_SS, F_DEN, W0, W1, W2, W3 };
// a bound entry's class, fixed for the launch: infinite bound, finite hard
// bound, or soft (finite bound, Z below the sentinel)
enum RowClass : unsigned char { C_INF = 0, C_HARD = 1, C_SOFT = 2 };

template <int NX, int NU>
__host__ __device__ size_t soft_entries(int N) {
  return 2 * (size_t)N * (NX + NU);
}
template <int NX, int NU>
__host__ __device__ size_t soft_floats(int N) {
  const size_t E = soft_entries<NX, NU>(N);
  return SOFT_WORDS * E + (E + 3) / 4;
}
template <int NX, int NU>
__host__ __device__ bool soft_resident(int N) {
  return smem_bytes<NX, NU>(N) + 4 * soft_floats<NX, NU>(N)
         <= (size_t)SMEM_OPTIN;
}
// the launch's dynamic shared bytes
template <int NX, int NU>
__host__ __device__ size_t plan_bytes(int N, bool soft) {
  return smem_bytes<NX, NU>(N)
         + (soft && soft_resident<NX, NU>(N) ? 4 * soft_floats<NX, NU>(N)
                                             : 0);
}

// Global workspace per problem: the iterate and direction vectors, the
// right-hand sides, the factorization's barrier weights and the KKT pass's
// stage terms; the soft area where it is not in shared memory; the fused
// modes' assembled rows; the prologue's record when the caller does not
// keep it; the factor stacks in the global layout.
template <int NX, int NU>
__host__ __device__ size_t workspace_floats(int N, int mode, bool soft) {
  const size_t n = N, n1 = N + 1;
  size_t w = n1 * 4 * NX                 // dx, ddx, ddxa, qr
             + n * (5 * NU + 3 * NX + 2 * NU);  // kff du ddu ddua rr; req
                                                // sgx kx; sgu ku
  if (mode != PLAIN) w += n1 * NX + 2 * n * NX + 3 * n * NU;  // q, r, bounds
  if (mode == FUSE_LIN) w += lin_floats<NX, NU>(N);
  if (soft && !soft_resident<NX, NU>(N)) w += soft_floats<NX, NU>(N);
  if (!resident<NX, NU>(N)) w += stack_floats<NX, NU>(N);
  return w;
}

// The single plan's launch shapes. A B=1 launch takes the single plan in
// the modes a single-problem path runs (PLAIN, FUSE_LIN); FUSE_COST is the
// batched tick and keeps the batch plan at any B (its single variant is
// not built). The FUSE_LIN prologue's items (a node and LIN_COLS tangent
// columns each) then run as a grid of their own, one item per thread.
__host__ __device__ constexpr bool single_plan(int mode, int B) {
  return B == 1 && mode != FUSE_COST;
}
template <int NX, int NU>
__host__ __device__ constexpr int lin_items(int N) {
  return N * ((NX + NU + LIN_COLS - 1) / LIN_COLS);
}
template <int NX, int NU>
__host__ __device__ constexpr int lin_blocks(int N) {
  return (lin_items<NX, NU>(N) + LIN_THREADS - 1) / LIN_THREADS;
}
// The `iters` of a FUSE_LIN entry call at B=1 that launches the single
// plan's prologue grid alone, its record in `lin` (the prologue's own
// wrapper, ops/box_qp_ipm.py::fused_lin_prologue).
constexpr int PROLOGUE_ONLY = -1;

// The cluster plan's launch shapes: which launches take it, its CTAs, the
// first stage of chunk j (chunk_start(N, C, C) = N) and the most stages a
// chunk holds.
__host__ __device__ constexpr bool cluster_plan(int mode, bool soft, int B,
                                                int N) {
  return B == 1 && mode == PLAIN && !soft && N >= CLUSTER_MIN_N;
}
__host__ __device__ constexpr int cluster_ctas(int N) {
  return N / CLUSTER_CHUNK_MIN < CLUSTER_CTAS ? N / CLUSTER_CHUNK_MIN
                                              : CLUSTER_CTAS;
}
__host__ __device__ constexpr int chunk_start(int N, int C, int j) {
  return (int)(((long long)j * N) / C);
}
__host__ __device__ constexpr int chunk_max(int N, int C) {
  return (N + C - 1) / C;
}
// A CTA's cluster area after its chunk's stacks: the chunk's products M_f
// (of F) and M_a (of A), two product buffers, the factorization scan's
// chunk total (A_T, C_T; J_T is the chunk's first P) and work space (a
// NX x 2NX system, two NX x NU blocks), the boundary slots (the chunk's
// own carry out, its true carry in, the next chunk's first state) and two
// reduction slots.
template <int NX, int NU>
__host__ __device__ constexpr int cluster_area_floats() {
  return 8 * NX * NX + 2 * NX * NU + 3 * CL_VEC + 2 * CL_RED;
}
// the cluster plan's dynamic shared bytes per CTA: the scratch, the ring,
// the largest chunk's stacks and the cluster area
template <int NX, int NU>
__host__ __device__ size_t cluster_bytes(int N) {
  return 4 * (shared_floats<NX, NU>() + RING_SLOTS * ring_stage<NX, NU>()
              + stack_floats<NX, NU>(chunk_max(N, cluster_ctas(N)))
              + (size_t)cluster_area_floats<NX, NU>());
}

struct Inputs {  // problem-major float32, NX x NU the instantiation's model
  const float* A;    // (B, N, NX, NX)
  const float* Bm;   // (B, N, NX, NU)
  const float* c;    // (B, N, NX)
  const float* Qs;   // (B, NX, NX)   stage Hessian, shared by stages
  const float* Qt;   // (B, NX, NX)   terminal Hessian
  const float* q;    // (B, N+1, NX)
  const float* R;    // (B, NU, NU)
  const float* r;    // (B, N, NU)
  const float* lbx;  // (B, N, NX)    state stages 1..N, +-1e18 = infinite
  const float* ubx;
  const float* lbu;  // (B, N, NU)
  const float* ubu;
  const float* dx0;  // (B, NX)
  // fused modes (q, r, the bounds and dx0 above are unused there): the
  // iterate, the spec rows and the absolute boxes the kernel assembles from
  const float* xbar;    // (B, N+1, NX)
  const float* ubar;    // (B, N, NU)
  const float* x0;      // (B, NX)
  const float* Rg;      // (B, NU, NU)  R of the cost gradient (qp_r_floor)
  const float* yrx;     // (B, N, NX)
  const float* yru;     // (B, N, NU)
  const float* yre;     // (B, NX)
  const float* box[4];  // lbx, ubx (B, NX); lbu, ubu (B, NU); +-1e18 = inf
  const float* sp;      // (B, N, np) stage parameters (FUSE_LIN)
  int np;
  // optional warm start (null = cold): valid (B,); slacks and duals of the
  // groups lx, ux (B, N, NX) and lu, uu (B, N, NU)
  const float* wvalid;
  const float* ws[4];
  const float* wl[4];
  const unsigned char* skip;  // optional device flag: nonzero = do nothing
  // SOFT: penalty rows Z, z of the groups lx, ux (B, N, NX), lu, uu
  // (B, N, NU); hard and infinite rows carry Z = 1e18, z = 0
  const float* Zp[4];
  const float* zp[4];
};

// Model constants of the FUSE_LIN prologue (runtime arguments). The RK4
// step constants arrive as the float32 roundings of h = dt / nsteps, h / 2
// and h / 6, as the Python linearizers use them.
struct Model {
  float inv_m, g, lx, ly, cy, j1, j2, j3;
  float h, h2, h6;
  int nsteps;
};

struct Outputs {
  float* dx;    // (B, N+1, NX) best-merit iterate (FUSE_COST: xbar + dx)
  float* du;    // (B, N, NU)                      (FUSE_COST: ubar + du)
  float* diag;  // (B, 6)
  float* s[4];  // last-iterate slacks: lx, ux (B, N, NX); lu, uu (B, N, NU)
  float* lam[4];  // last-iterate duals, same layout
  float* work;  // (B, workspace_floats<NX, NU>(N, mode, soft))
  float* lin;   // FUSE_LIN, optional: (B, lin_floats<NX, NU>(N)) A, B, c
};

// Fail-safe, Jacobi-equilibrated inverse of the SPD NU x NU matrix M (6x6
// for BLASTER, 4x4 for QUAD13), run by all 32 lanes of one warp. Returns
// the zero matrix when a diagonal entry is <= 0 or the minimum Cholesky
// pivot is <= 1e-10: the stage's gain collapses to 0 instead of blowing
// the recursion up to inf/NaN. Lane r < NU owns row r of the factor L
// (column j: lane j forms the pivot, every lane takes it and row j's
// entries by shuffles, lanes r > j their entry); lane c owns column c of
// L^-1 (forward substitution down the column); lane e the entry e of
// L^-T L^-1 scaled back. Every operation of the one-thread form, in its
// order: the same roundings. Ls, Lis: NU x NU shared scratch; out: NU x NU.
template <int NU>
__device__ void chol_inverse_warp(const float* M, float* Ls, float* Lis,
                                  float* out, int lane) {
  const int r = lane < NU ? lane : NU - 1;  // lanes >= NU shadow row NU-1
  float Mr[NU];
#pragma unroll
  for (int c = 0; c < NU; ++c) Mr[c] = M[r * NU + c];
  const float mrr = M[r * NU + r];
  const bool diag_ok = __all_sync(FULL, mrr > 0.f);
  const float ds = sqrtf(nmax(mrr, 1e-30f));  // dscale[r]
  float dsc[NU];
#pragma unroll
  for (int c = 0; c < NU; ++c) dsc[c] = __shfl_sync(FULL, ds, c);
  float Lr[NU];
#pragma unroll
  for (int c = 0; c < NU; ++c) Lr[c] = 0.f;
  float min_piv = 0.f;
  // the equilibrated entries of row r, off the pivots' chain
  const float msd = Mr[r] / (ds * ds);
  float mst[NU];
#pragma unroll
  for (int j = 0; j < NU; ++j) mst[j] = Mr[j] / (ds * dsc[j]);
#pragma unroll
  for (int j = 0; j < NU; ++j) {
    float s = msd;  // lane j: M_jj / (d_j d_j)
#pragma unroll
    for (int p = 0; p < j; ++p) s = s - Lr[p] * Lr[p];
    const float sj = __shfl_sync(FULL, s, j);
    min_piv = (j == 0) ? sj : nmin(min_piv, sj);
    const float d = sqrtf(nmax(sj, 1e-12f));
    const float inv_d = 1.f / d;
    float tt = mst[j];  // lane r > j: M_rj / (d_r d_j)
#pragma unroll
    for (int p = 0; p < j; ++p) {
      const float ljp = __shfl_sync(FULL, Lr[p], j);
      tt = tt - Lr[p] * ljp;
    }
    if (r == j) {
      Lr[j] = d;
    } else if (r > j) {
      Lr[j] = tt * inv_d;
    }
  }
  if (lane < NU) {
#pragma unroll
    for (int c = 0; c < NU; ++c) Ls[r * NU + c] = Lr[c];
  }
  __syncwarp();
  // column c = r of L^-1
  const int c = r;
  const float licc = 1.f / Ls[c * NU + c];
  float Lc[NU];
#pragma unroll
  for (int i = 0; i < NU; ++i) {
    if (i < c) {
      Lc[i] = 0.f;
    } else if (i == c) {
      Lc[i] = licc;
    } else {
      float s = Ls[i * NU + c] * licc;
#pragma unroll
      for (int k = 0; k < NU; ++k) {
        if (k > c && k < i) s = s + Ls[i * NU + k] * Lc[k];
      }
      Lc[i] = -s / Ls[i * NU + i];
    }
  }
  if (lane < NU) {
#pragma unroll
    for (int i = 0; i < NU; ++i) Lis[i * NU + c] = Lc[i];
  }
  __syncwarp();
  const bool ok = diag_ok && (min_piv > 1e-10f);
#pragma unroll
  for (int ro = 0; ro < (NU * NU + 31) / 32; ++ro) {
    const int e = lane + 32 * ro;
    if (e < NU * NU) {
      const int i = e / NU, j = e - i * NU, k0 = i > j ? i : j;
      float s = Lis[k0 * NU + i] * Lis[k0 * NU + j];
#pragma unroll
      for (int k = 0; k < NU; ++k) {
        if (k > k0) s = s + Lis[k * NU + i] * Lis[k * NU + j];
      }
      float di = dsc[0], dj = dsc[0];
#pragma unroll
      for (int q = 1; q < NU; ++q) {
        di = q == i ? dsc[q] : di;
        dj = q == j ? dsc[q] : dj;
      }
      out[e] = ok ? s / (di * dj) : 0.f;
    }
  }
}

// The same inset with explicit masks: the soft init insets hard rows only.
__device__ __forceinline__ float clamp_masked(float v, float lb, float ub,
                                              bool ml, bool mu) {
  const float w = (ml && mu) ? ub - lb : 1.f;
  const float lo = ml ? lb + 0.1f * w : -BIG;
  const float hi = mu ? ub - 0.1f * w : BIG;
  return clipf(v, lo, nmax(hi, lo));
}

__device__ __forceinline__ float clamp_into(float v, float lb, float ub) {
  return clamp_masked(v, lb, ub, lb > -MTHR, ub < MTHR);
}

// ---- forward-mode dual numbers (value, C tangents) ------------------------
// The tangent rules are JAX's jvp rules (sin' = cos, cos' = -sin,
// tan' = 1 + tan^2, the quotient rule); the value part is the plain float
// arithmetic, so ode_rows<float> and the value of ode_rows<DualN<C>> agree.
// C tangent columns share one value part; each column's arithmetic is the
// one-column form's, so C independent chains run side by side.
template <int C>
struct DualN {
  float v, d[C];
};
// a DualN from its value and a function of the column giving each tangent
template <int C, class F>
__device__ __forceinline__ DualN<C> dual(float v, F d) {
  DualN<C> o;
  o.v = v;
#pragma unroll
  for (int c = 0; c < C; ++c) o.d[c] = d(c);
  return o;
}
template <int C>
__device__ __forceinline__ DualN<C> operator+(DualN<C> a, DualN<C> b) {
  return dual<C>(a.v + b.v, [&](int c) { return a.d[c] + b.d[c]; });
}
template <int C>
__device__ __forceinline__ DualN<C> operator-(DualN<C> a, DualN<C> b) {
  return dual<C>(a.v - b.v, [&](int c) { return a.d[c] - b.d[c]; });
}
template <int C>
__device__ __forceinline__ DualN<C> operator-(DualN<C> a, float b) {
  return dual<C>(a.v - b, [&](int c) { return a.d[c]; });
}
template <int C>
__device__ __forceinline__ DualN<C> operator+(DualN<C> a, float b) {
  return dual<C>(a.v + b, [&](int c) { return a.d[c]; });
}
template <int C>
__device__ __forceinline__ DualN<C> operator-(DualN<C> a) {
  return dual<C>(-a.v, [&](int c) { return -a.d[c]; });
}
template <int C>
__device__ __forceinline__ DualN<C> operator*(DualN<C> a, DualN<C> b) {
  return dual<C>(a.v * b.v,
                 [&](int c) { return a.d[c] * b.v + a.v * b.d[c]; });
}
template <int C>
__device__ __forceinline__ DualN<C> operator*(DualN<C> a, float b) {
  return dual<C>(a.v * b, [&](int c) { return a.d[c] * b; });
}
template <int C>
__device__ __forceinline__ DualN<C> operator*(float a, DualN<C> b) {
  return dual<C>(a * b.v, [&](int c) { return a * b.d[c]; });
}
template <int C>
__device__ __forceinline__ DualN<C> operator/(DualN<C> a, DualN<C> b) {
  const float q = a.v / b.v;
  return dual<C>(q, [&](int c) { return (a.d[c] - q * b.d[c]) / b.v; });
}
template <int C>
__device__ __forceinline__ DualN<C> operator/(DualN<C> a, float b) {
  return dual<C>(a.v / b, [&](int c) { return a.d[c] / b; });
}
__device__ __forceinline__ float fsin(float x) { return sinf(x); }
__device__ __forceinline__ float fcos(float x) { return cosf(x); }
__device__ __forceinline__ float ftan(float x) { return tanf(x); }
template <int C>
__device__ __forceinline__ DualN<C> fsin(DualN<C> x) {
  const float cv = cosf(x.v);
  return dual<C>(sinf(x.v), [&](int c) { return cv * x.d[c]; });
}
template <int C>
__device__ __forceinline__ DualN<C> fcos(DualN<C> x) {
  const float ns = -sinf(x.v);
  return dual<C>(cosf(x.v), [&](int c) { return ns * x.d[c]; });
}
template <int C>
__device__ __forceinline__ DualN<C> ftan(DualN<C> x) {
  const float t = tanf(x.v), f = 1.f + t * t;
  return dual<C>(t, [&](int c) { return f * x.d[c]; });
}
// sqrt' = 1 / (2 sqrt), as PyTorch's forward-mode rule writes it
__device__ __forceinline__ float fsqrt(float x) { return sqrtf(x); }
template <int C>
__device__ __forceinline__ DualN<C> fsqrt(DualN<C> x) {
  const float s = sqrtf(x.v), den = 2.f * s;
  return dual<C>(s, [&](int c) { return x.d[c] / den; });
}

// The BLASTER ODE with components as scalars, written once over the scalar
// type: dynamics/fastlin.py::_ode_rows term for term (its operation order),
// X (17), U (6), P (25 stage parameters) -> Xd (17).
template <class T>
__device__ __forceinline__ void ode_rows(const T* X, const T* U,
                                         const float* P, const Model& md,
                                         T* Xd) {
  const T phi = X[3], th = X[4], psi = X[5];
  const T vx = X[6], vy = X[7], vz = X[8];
  const T w1 = X[9], w2 = X[10], w3 = X[11];
  const T a1 = X[12], a2 = X[13];
  const T t1 = U[0], t2 = U[1], t3 = U[2], t4 = U[3];
  const T ad1 = U[4], ad2 = U[5];
  const float tb = P[24];

  const T cphi = fcos(phi), sphi = fsin(phi);
  const T cth = fcos(th), sth = fsin(th);
  const T cpsi = fcos(psi), spsi = fsin(psi);

  // world-from-body R = Rz(psi) Ry(th) Rx(phi)
  const T r00 = cpsi * cth;
  const T r01 = cpsi * sth * sphi - spsi * cphi;
  const T r02 = cpsi * sth * cphi + spsi * sphi;
  const T r10 = spsi * cth;
  const T r11 = spsi * sth * sphi + cpsi * cphi;
  const T r12 = spsi * sth * cphi - cpsi * sphi;
  const T r20 = -sth;
  const T r21 = cth * sphi;
  const T r22 = cth * cphi;

  // body-frame force: collective thrust + blast along the nozzle axis
  const T c1 = fcos(a1), s1 = fsin(a1);
  const T c2 = fcos(a2), s2 = fsin(a2);
  const T t_tot = t1 + t2 + t3 + t4;
  const T fb0 = s1 * c2 * tb;
  const T fb1 = -s2 * tb;
  const T fb2 = t_tot + c1 * c2 * tb;
  const T vdx = (r00 * fb0 + r01 * fb1 + r02 * fb2) * md.inv_m;
  const T vdy = (r10 * fb0 + r11 * fb1 + r12 * fb2) * md.inv_m;
  const T vdz = (r20 * fb0 + r21 * fb1 + r22 * fb2) * md.inv_m - md.g;

  // Euler's equation, diagonal inertia, rotor mixing
  const T m0 = (t2 + t4 - t1 - t3) * md.ly;
  const T m1 = (-t1 - t4 + t2 + t3) * md.lx;
  const T m2 = (-t1 - t2 + t3 + t4) * md.cy;
  const T wd1 = (m0 - (w2 * (md.j3 * w3) - w3 * (md.j2 * w2))) / md.j1;
  const T wd2 = (m1 - (w3 * (md.j1 * w1) - w1 * (md.j3 * w3))) / md.j2;
  const T wd3 = (m2 - (w1 * (md.j2 * w2) - w2 * (md.j1 * w1))) / md.j3;

  // attitude kinematics (closed-form E^-1)
  const T tth = ftan(th);
  const T phid = w1 + sphi * tth * w2 + cphi * tth * w3;
  const T thd = cphi * w2 - sphi * w3;
  const T psid = (sphi * w2 + cphi * w3) / cth;

  Xd[0] = vx;
  Xd[1] = vy;
  Xd[2] = vz;
  Xd[3] = phid;
  Xd[4] = thd;
  Xd[5] = psid;
  Xd[6] = vdx;
  Xd[7] = vdy;
  Xd[8] = vdz;
  Xd[9] = wd1;
  Xd[10] = wd2;
  Xd[11] = wd3;
  Xd[12] = ad1;
  Xd[13] = ad2;
  // POC propagation j_pos v + j_euler eul_dot + j_angles alpha_dot
  // (column-major packing of the 25-vector)
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    T acc = P[15 + i] * vx + P[18 + i] * vy + P[21 + i] * vz;
    acc = acc + P[6 + i] * phid + P[9 + i] * thd + P[12 + i] * psid;
    acc = acc + P[i] * ad1 + P[3 + i] * ad2;
    Xd[14 + i] = acc;
  }
}

// The 13-state quaternion quadrotor (models/quad13.py::quad13_ode) with
// components as scalars: dynamics/fastlin.py::_quad13_rows term for term,
// X (13), U (4) -> Xd (13); no stage parameters. The Hamilton-product
// q_dot takes the raw state quaternion, the thrust column R(q) e3 the
// normalized one: one IEEE sqrt and four divisions (the total thrust is
// scaled by 1/m, as the BLASTER rows do).
template <class T>
__device__ __forceinline__ void quad13_rows(const T* X, const T* U,
                                            const Model& md, T* Xd) {
  const T qw = X[3], qx = X[4], qy = X[5], qz = X[6];
  const T vx = X[7], vy = X[8], vz = X[9];
  const T w1 = X[10], w2 = X[11], w3 = X[12];
  const T t1 = U[0], t2 = U[1], t3 = U[2], t4 = U[3];

  const T qn = fsqrt(qw * qw + qx * qx + qy * qy + qz * qz);
  const T iw = qw / qn, ix = qx / qn, iy = qy / qn, iz = qz / qn;

  // R(qn) e3, the third column of quat_to_rot
  const T r02 = 2.f * (ix * iz + iw * iy);
  const T r12 = 2.f * (iy * iz - iw * ix);
  const T r22 = 2.f * (iw * iw + iz * iz) - 1.f;
  const T t_tot = (t1 + t2 + t3 + t4) * md.inv_m;

  const T qdw = 0.5f * (-qx * w1 - qy * w2 - qz * w3);
  const T qdx = 0.5f * (qw * w1 + qy * w3 - qz * w2);
  const T qdy = 0.5f * (qw * w2 - qx * w3 + qz * w1);
  const T qdz = 0.5f * (qw * w3 + qx * w2 - qy * w1);

  const T m0 = (t2 + t4 - t1 - t3) * md.ly;
  const T m1 = (-t1 - t4 + t2 + t3) * md.lx;
  const T m2 = (-t1 - t2 + t3 + t4) * md.cy;

  Xd[0] = vx;
  Xd[1] = vy;
  Xd[2] = vz;
  Xd[3] = qdw;
  Xd[4] = qdx;
  Xd[5] = qdy;
  Xd[6] = qdz;
  Xd[7] = r02 * t_tot;
  Xd[8] = r12 * t_tot;
  Xd[9] = r22 * t_tot - md.g;
  Xd[10] = (m0 - (w2 * (md.j3 * w3) - w3 * (md.j2 * w2))) / md.j1;
  Xd[11] = (m1 - (w3 * (md.j1 * w1) - w1 * (md.j3 * w3))) / md.j2;
  Xd[12] = (m2 - (w1 * (md.j2 * w2) - w2 * (md.j1 * w1))) / md.j3;
}

// The rows-form ODE of a family: BLASTER's; BLASTER_DIST adds the force
// and torque disturbance estimates P[25..30] to the v and omega rows
// (dynamics/fastlin.py::_ode_rows_dist); QUAD13's.
template <int FAM, class T>
__device__ __forceinline__ void family_rows(const T* X, const T* U,
                                            const float* P, const Model& md,
                                            T* Xd) {
  if constexpr (FAM == QUAD13) {
    quad13_rows(X, U, md, Xd);
  } else {
    ode_rows(X, U, P, md, Xd);
    if constexpr (FAM == BLASTER_DIST) {
#pragma unroll
      for (int i = 0; i < 6; ++i) Xd[6 + i] = Xd[6 + i] + P[25 + i];
    }
  }
}

// Classic RK4 with md.nsteps substeps, in place on X (NX rows):
// dynamics/fastlin.py::_rk4_rows, x + h/6 (((k1 + 2 k2) + 2 k3) + k4).
template <int FAM, int NX, class T>
__device__ __forceinline__ void rk4_rows(T* X, const T* U, const float* P,
                                         const Model& md) {
  for (int s = 0; s < md.nsteps; ++s) {
    T k[NX], acc[NX], Xs[NX];
    family_rows<FAM>(X, U, P, md, k);
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      acc[i] = k[i];
      Xs[i] = X[i] + md.h2 * k[i];
    }
    family_rows<FAM>(Xs, U, P, md, k);
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      acc[i] = acc[i] + 2.f * k[i];
      Xs[i] = X[i] + md.h2 * k[i];
    }
    family_rows<FAM>(Xs, U, P, md, k);
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      acc[i] = acc[i] + 2.f * k[i];
      Xs[i] = X[i] + md.h * k[i];
    }
    family_rows<FAM>(Xs, U, P, md, k);
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      acc[i] = acc[i] + k[i];
      X[i] = X[i] + md.h6 * acc[i];
    }
  }
}

// The soft rows of one problem: the penalty rows (inputs, read once by
// init) and the soft area (shared memory or the workspace). Empty unless
// SOFT, so the hard instantiations carry no extra state (the Solver is the
// empty base's only user).
template <bool SOFT>
struct SoftRows {};
template <>
struct SoftRows<true> {
  const float *Zg[4], *zg[4];
  float* sa;           // SOFT_WORDS fields of E entries
  unsigned char* cls;  // the entries' RowClass
  int E;
};

// A CTA's part of the cluster plan: its rank, the cluster's CTAs, its
// chunk of stages and bound rows, its cluster area. Empty unless CLUSTER,
// so the other plans' Solvers are laid out as before.
template <bool CLUSTER>
struct ClusterPart {};
template <>
struct ClusterPart<true> {
  int rank, ncta;
  int ks, ke;          // the chunk: stages ks .. ke
  int xr0, xr1;        // its state bound rows [xr0, xr1) (those of dx_k,
                       // k in its chunk; the last chunk's also of dx_N)
  int ur0, ur1;        // its control bound rows
  float *Mf, *Ma;      // the chunk's products of F and of A
  float *Mt, *Xk;      // a product buffer and the factor X_k
  float *At, *Ct, *Gs;  // the chunk's total A_T, C_T; an NX x 2NX system
  float *Wb, *WHb;     // NX x NU work space
  float* atc;          // the buffer that holds A_T so far
  float *vout, *vin, *halo;  // boundary slots (CL_VEC words each)
  float* cred;         // two reduction slots (CL_RED words each)
  mutable int par;     // the reduction slot in turn
};

// One problem's solve, run by one thread block of THREADS threads (the
// plan's): an NX-state, NU-control model; FAM is the FUSE_LIN prologue's
// ODE. With CLUSTER, one CTA's part of the cluster plan's solve: its
// chunk of the problem's stages.
template <int MODE, bool SOFT, int NX, int NU, int FAM, int THREADS,
          bool CLUSTER = false>
struct Solver : SoftRows<SOFT>, ClusterPart<CLUSTER> {
  static constexpr int WARPS = THREADS / 32;
  static constexpr bool SINGLE = THREADS != BATCH_THREADS;
  static_assert(THREADS == BATCH_THREADS || THREADS == SINGLE_THREADS, "");
  static_assert(!CLUSTER || (MODE == PLAIN && !SOFT && SINGLE),
                "the cluster plan: hard PLAIN, the single plan's threads");
  static_assert(WARPS > PRODUCERS && WARPS <= SUM_WARPS, "");
  static constexpr int VT = sum_parts<THREADS>();  // virtual threads
  static constexpr int NXX = NX * NX;
  static constexpr int RING = ring_stage<NX, NU>();
  static constexpr int NPAIR = NX * (NX + 1) / 2;  // P entries i <= j
  static constexpr int PR = (NPAIR + THREADS - 1) / THREADS;
  // inputs of this problem
  const float *A, *Bm, *c, *Qs, *Qt, *q, *R, *r, *dx0;
  const float* bnd[4];  // lbx, ubx, lbu, ubu (delta form)
  // fused modes: the iterate, spec rows, absolute boxes; the rows they fill
  const float *xbar, *ubar, *x0, *Rg, *yrx, *yru, *yre, *sp;
  const float* box[4];
  float *qf, *rf, *bd[4], *Aw, *Bw, *cw;
  int np;
  // warm start of this problem (used only when warm_use)
  const float *ws[4], *wl[4];
  bool warm_use;
  // outputs (slacks/duals double as the iterate's state)
  float *dxb, *dub, *diag;
  float *s[4], *lam[4];
  // workspace (global)
  float *kff, *dx, *du, *ddx, *ddu, *ddxa, *ddua, *qr, *rr, *req, *sgx,
      *sgu, *kx, *ku;
  // shared memory: scratch, the A/B ring, the factorization's window
  // (global layout); the factor stacks (shared or global)
  Shared<NX, NU>& sh;
  float *ring, *win, *Pst, *Zst, *Hst;
  bool res;
  int N, t, lane, warp;
  int pi[PR], pj[PR];  // this thread's (i, j) pairs of the P phase
  float mu0, reg, n_ineq, mu_t;

  // problem `prob` of the launch (the solve's block index)
  __device__ Solver(const Inputs& in, const Outputs& out, float* smem, int N_,
                    float mu0_, float reg_, int prob)
      : sh(*reinterpret_cast<Shared<NX, NU>*>(smem)), N(N_), t(threadIdx.x),
        lane(threadIdx.x & 31), warp(threadIdx.x >> 5), mu0(mu0_),
        reg(reg_), n_ineq(1.f), mu_t(0.f) {
    const size_t b = prob, n = N, n1 = N + 1;
    Qs = in.Qs + b * NXX;
    Qt = in.Qt + b * NXX;
    R = in.R + b * NU * NU;
    if constexpr (MODE != FUSE_LIN) {
      A = in.A + b * n * NXX;
      Bm = in.Bm + b * n * NX * NU;
      c = in.c + b * n * NX;
    }
    if constexpr (MODE == PLAIN) {
      q = in.q + b * n1 * NX;
      r = in.r + b * n * NU;
      dx0 = in.dx0 + b * NX;
      bnd[0] = in.lbx + b * n * NX;
      bnd[1] = in.ubx + b * n * NX;
      bnd[2] = in.lbu + b * n * NU;
      bnd[3] = in.ubu + b * n * NU;
    }
    dxb = out.dx + b * n1 * NX;
    dub = out.du + b * n * NU;
    diag = out.diag + b * 6;
    warm_use = in.wvalid != nullptr && in.wvalid[b] > 0.5f;
    for (int g = 0; g < 4; ++g) {
      const size_t w = g < 2 ? NX : NU;
      s[g] = out.s[g] + b * n * w;
      lam[g] = out.lam[g] + b * n * w;
      ws[g] = warm_use ? in.ws[g] + b * n * w : nullptr;
      wl[g] = warm_use ? in.wl[g] + b * n * w : nullptr;
    }
    float* w = out.work + b * workspace_floats<NX, NU>(N, MODE, SOFT);
    dx = w;       w += n1 * NX;
    ddx = w;      w += n1 * NX;
    ddxa = w;     w += n1 * NX;
    qr = w;       w += n1 * NX;
    kff = w;      w += n * NU;
    du = w;       w += n * NU;
    ddu = w;      w += n * NU;
    ddua = w;     w += n * NU;
    rr = w;       w += n * NU;
    req = w;      w += n * NX;
    sgx = w;      w += n * NX;
    kx = w;       w += n * NX;
    sgu = w;      w += n * NU;
    ku = w;       w += n * NU;
    [[maybe_unused]] float* soft_g = nullptr;  // the soft area in the workspace
    if constexpr (SOFT) {
      for (int g = 0; g < 4; ++g) {
        const size_t wd = g < 2 ? NX : NU;
        this->Zg[g] = in.Zp[g] + b * n * wd;
        this->zg[g] = in.zp[g] + b * n * wd;
      }
      if (!soft_resident<NX, NU>(N)) {
        soft_g = w;
        w += soft_floats<NX, NU>(N);
      }
    }
    if constexpr (MODE != PLAIN) {
      xbar = in.xbar + b * n1 * NX;
      ubar = in.ubar + b * n * NU;
      x0 = in.x0 + b * NX;
      Rg = in.Rg + b * NU * NU;
      yrx = in.yrx + b * n * NX;
      yru = in.yru + b * n * NU;
      yre = in.yre + b * NX;
      qf = w;     w += n1 * NX;
      rf = w;     w += n * NU;
      for (int g = 0; g < 4; ++g) {
        const size_t wd = g < 2 ? NX : NU;
        box[g] = in.box[g] + b * wd;
        bd[g] = w;
        w += n * wd;
        bnd[g] = bd[g];
      }
      q = qf;
      r = rf;
    }
    if constexpr (MODE == FUSE_LIN) {
      np = in.np;
      sp = in.sp + b * n * np;
      float* L = out.lin ? out.lin + b * lin_floats<NX, NU>(N) : w;
      w += lin_floats<NX, NU>(N);
      Aw = L;
      Bw = L + n * NXX;
      cw = Bw + n * NX * NU;
      A = Aw;
      Bm = Bw;
      c = cw;
    }
    ring = smem + shared_floats<NX, NU>();
    res = resident<NX, NU>(N);
    win = nullptr;
    Pst = res ? ring + RING_SLOTS * RING : w;
    if (!res) win = ring + RING_SLOTS * RING;
    Zst = Pst + n1 * NXX;
    Hst = Zst + n * NU * NX;
    if constexpr (SOFT) {
      this->E = (int)soft_entries<NX, NU>(N);
      this->sa = soft_g ? soft_g
                        : ring + RING_SLOTS * RING
                              + (res ? stack_floats<NX, NU>(N)
                                     : (size_t)window_floats<NX, NU>());
      this->cls = reinterpret_cast<unsigned char*>(this->sa
                                                   + SOFT_WORDS * this->E);
    }
    if constexpr (CLUSTER) {
      // this CTA's chunk, its stacks and its cluster area
      const int C = cluster_ctas(N), r = (int)cg::this_cluster().block_rank();
      this->rank = r;
      this->ncta = C;
      this->ks = chunk_start(N, C, r);
      this->ke = chunk_start(N, C, r + 1) - 1;
      this->xr0 = r == 0 ? 0 : (this->ks - 1) * NX;
      this->xr1 = (r == C - 1 ? N : this->ke) * NX;
      this->ur0 = this->ks * NU;
      this->ur1 = (this->ke + 1) * NU;
      const int nm = chunk_max(N, C);
      res = true;
      win = nullptr;
      Pst = ring + RING_SLOTS * RING;
      Zst = Pst + (size_t)(nm + 1) * NXX;
      Hst = Zst + (size_t)nm * NU * NX;
      float* a = Hst + (size_t)nm * NU * NU;
      this->Mf = a;
      this->Ma = a + NXX;
      this->Mt = a + 2 * NXX;
      this->Xk = a + 3 * NXX;
      this->At = a + 4 * NXX;
      this->Ct = a + 5 * NXX;
      this->Gs = a + 6 * NXX;
      this->Wb = a + 8 * NXX;
      this->WHb = this->Wb + NX * NU;
      this->atc = this->At;
      this->vout = this->WHb + NX * NU;
      this->vin = this->vout + CL_VEC;
      this->halo = this->vin + CL_VEC;
      this->cred = this->halo + CL_VEC;
      this->par = 0;
    }
    // pairs of the P phase: the diagonal first (thread t < NX owns (t, t)),
    // then the strict upper triangle row by row
#pragma unroll
    for (int h = 0; h < PR; ++h) {
      int p = t + h * THREADS, i = 0, j = 0;
      if (p < NX) {
        i = j = p;
      } else if (p < NPAIR) {
        p -= NX;
        int len = NX - 1;
        while (p >= len) {
          p -= len;
          ++i;
          --len;
        }
        j = i + 1 + p;
      }
      pi[h] = i;
      pj[h] = j;
    }
  }

  // ---- the chunk (the cluster plan; else the whole horizon) ----------------
  // the first and last stage this block sweeps and factors
  __device__ int kbase() const {
    if constexpr (CLUSTER) return this->ks;
    return 0;
  }
  __device__ int ktop() const {
    if constexpr (CLUSTER) return this->ke;
    return N - 1;
  }
  // whether the chunk holds stage 0 (dx_0, qr_0) and stage N - 1 (dx_N)
  __device__ bool first_chunk() const {
    if constexpr (CLUSTER) return this->rank == 0;
    return true;
  }
  __device__ bool last_chunk() const {
    if constexpr (CLUSTER) return this->rank == this->ncta - 1;
    return true;
  }

  // ---- the factor stacks and the A/B ring ----------------------------------
  // Where the sweeps read stage k's P, Z and Hinv (shared or global; the
  // cluster plan's stacks start at its chunk's first stage) ...
  __device__ const float* Ps(int k) const {
    return Pst + (size_t)(k - kbase()) * NXX;
  }
  __device__ const float* Zs(int k) const {
    return Zst + (size_t)(k - kbase()) * NU * NX;
  }
  __device__ const float* Hs(int k) const {
    return Hst + (size_t)(k - kbase()) * NU * NU;
  }
  // ... and where the factorization keeps them: the stacks themselves, or
  // the shared window whose entries it also copies out (global layout)
  __device__ float* Pw(int k) const {
    return res ? Pst + (size_t)(k - kbase()) * NXX : win + (k & 1) * NXX;
  }
  __device__ float* Zw(int k) const {
    return res ? Zst + (size_t)(k - kbase()) * NU * NX : win + 2 * NXX;
  }
  __device__ float* Hw(int k) const {
    return res ? Hst + (size_t)(k - kbase()) * NU * NU
               : win + 2 * NXX + NU * NX;
  }

  // ---- the cluster (the cluster plan only) ---------------------------------
  __device__ static void cluster_sync() { cg::this_cluster().sync(); }
  // p, an address in this CTA's shared memory, in CTA r's
  template <class T>
  __device__ static T* remote(T* p, int r) {
    return cg::this_cluster().map_shared_rank(p, (unsigned)r);
  }
  // The values v (uniform across the CTA) combined over the cluster's CTAs
  // with op, in rank order: every thread of every CTA gets the same
  // result. The two reduction slots alternate, so a slot is written again
  // only after the next combine's cluster barrier, which every reader of
  // it has passed.
  template <int NV, class Op>
  __device__ void cluster_combine(float (&v)[NV], Op op) const {
    static_assert(NV <= CL_RED, "");
    float* slot = this->cred + this->par * CL_RED;
    this->par ^= 1;
    if (t == 0) {
#pragma unroll
      for (int h = 0; h < NV; ++h) slot[h] = v[h];
    }
    cluster_sync();
    const float* s0 = remote(slot, 0);
#pragma unroll
    for (int h = 0; h < NV; ++h) v[h] = s0[h];
    for (int r = 1; r < this->ncta; ++r) {
      const float* sr = remote(slot, r);
#pragma unroll
      for (int h = 0; h < NV; ++h) v[h] = op(v[h], sr[h]);
    }
  }
  // M = X_ke ... X_ks of this CTA's chunk into `out` (256 threads): X_k =
  // A_k - B_k Z_k, the closed loop (`closed`), or A_k; each entry of a
  // product one sum over l in order
  __device__ void chunk_product(bool closed, float* out) {
    const int ks = this->ks, ke = this->ke;
    float* cur = ((ke - ks) & 1) ? this->Mt : out;  // ends in `out`
    float* const X = this->Xk;
    for (int k = ks; k <= ke; ++k) {
      float* dst = k == ks ? cur : X;
      const float* Zk = Zs(k);
      for (int e = t; e < NXX; e += THREADS) {
        float x = A[(size_t)k * NXX + e];
        if (closed) {
          const int i = e / NX, j = e - i * NX;
          const float* Bi = Bm + ((size_t)k * NX + i) * NU;
          float z = Bi[0] * Zk[j];
          for (int l = 1; l < NU; ++l) z += Bi[l] * Zk[l * NX + j];
          x = x - z;
        }
        dst[e] = x;
      }
      __syncthreads();
      if (k > ks) {
        float* nxt = cur == out ? this->Mt : out;
        for (int e = t; e < NXX; e += THREADS) {
          const int i = e / NX, j = e - i * NX;
          float a = X[i * NX] * cur[j];
          for (int l = 1; l < NX; ++l) a += X[i * NX + l] * cur[l * NX + j];
          nxt[e] = a;
        }
        __syncthreads();
        cur = nxt;
      }
    }
  }
  // A scan's step (2), between two cluster barriers: rank 0's warp 0 walks
  // the chunks from the head (the chunk whose step-1 sweep started from
  // the true boundary: the last in a backward scan, the first in a forward
  // one), handing each next chunk its true boundary b in its `vin` and
  // taking b <- M_j' b + out_j (backward) or M_j b + out_j (forward) over
  // the chunks between head and tail, M_j in each CTA's `M`.
  __device__ void scan_boundaries(bool back, float* M) {
    cluster_sync();  // every chunk's carry is in its vout
    const int C = this->ncta;
    if (this->rank == 0 && warp == 0 && C > 1) {
      const int head = back ? C - 1 : 0, step = back ? -1 : 1;
      const int xi = lane < NX ? lane : 0;
      float b = remote(this->vout, head)[xi];
      for (int h = 1; h < C; ++h) {
        const int j = head + h * step;
        if (lane < NX) remote(this->vin, j)[lane] = b;
        if (h == C - 1) break;  // the tail hands nothing on
        const float* Mj = remote(M, j);
        const float* oj = remote(this->vout, j);
        float bl[NX];
#pragma unroll
        for (int l = 0; l < NX; ++l) bl[l] = __shfl_sync(FULL, b, l);
        float a;
        if (back) {
          a = Mj[xi] * bl[0];
#pragma unroll
          for (int l = 1; l < NX; ++l) a += Mj[l * NX + xi] * bl[l];
        } else {
          a = Mj[xi * NX] * bl[0];
#pragma unroll
          for (int l = 1; l < NX; ++l) a += Mj[xi * NX + l] * bl[l];
        }
        b = a + oj[xi];
      }
    }
    cluster_sync();  // every chunk's true boundary is in its vin
  }

  // After stage k of a chunk's recursion from P = 0 (the scan's step 1):
  // F_k = A_k - B_k Z_k, W = A_T B_k, A_T <- A_T F_k and C_T <- C_T +
  // W Hinv_k W' (before the chunk's last stage A_T = I, C_T = 0); A_k and
  // B_k are still in their ring slot.
  __device__ void total_step(int k) {
    const float* Ak = ring_slot(k);
    const float* Bk = Ak + NXX;
    const float *Zk = Zw(k), *Hk = Hw(k);
    const bool first = k == this->ke;
    float* const cur = this->atc;
    float* const nxt = cur == this->At ? this->Mt : this->At;
    float* const F = first ? cur : this->Xk;
    for (int e = t; e < NXX; e += THREADS) {
      const int i = e / NX, j = e - i * NX;
      float z = Bk[i * NU] * Zk[j];
      for (int l = 1; l < NU; ++l) z += Bk[i * NU + l] * Zk[l * NX + j];
      F[e] = Ak[e] - z;
    }
    for (int e = t; e < NX * NU; e += THREADS) {
      const int i = e / NU, l = e - i * NU;
      float w = Bk[e];
      if (!first) {
        w = cur[i * NX] * Bk[l];
        for (int m = 1; m < NX; ++m) w += cur[i * NX + m] * Bk[m * NU + l];
      }
      this->Wb[e] = w;
    }
    __syncthreads();
    for (int e = t; e < NX * NU; e += THREADS) {
      const int i = e / NU, l = e - i * NU;
      float w = this->Wb[i * NU] * Hk[l];
      for (int q = 1; q < NU; ++q) w += this->Wb[i * NU + q] * Hk[q * NU + l];
      this->WHb[e] = w;
    }
    if (!first) {
      for (int e = t; e < NXX; e += THREADS) {
        const int i = e / NX, j = e - i * NX;
        float a = cur[i * NX] * F[j];
        for (int m = 1; m < NX; ++m) a += cur[i * NX + m] * F[m * NX + j];
        nxt[e] = a;
      }
    }
    __syncthreads();
    for (int e = t; e < NXX; e += THREADS) {
      const int i = e / NX, j = e - i * NX;
      float c = this->WHb[i * NU] * this->Wb[j * NU];
      for (int l = 1; l < NU; ++l) {
        c += this->WHb[i * NU + l] * this->Wb[j * NU + l];
      }
      this->Ct[e] = first ? c : this->Ct[e] + c;
    }
    if (!first) this->atc = nxt;
    __syncthreads();
  }

  // Gauss-Jordan elimination with partial pivoting on warp 0: G = [M | X]
  // (NX x 2NX, row-major) becomes [I | M^-1 X]. Every lane picks the same
  // pivot row (the largest |entry| of the column, the first on a tie);
  // lane c keeps columns c and c + 32.
  __device__ void gauss_jordan_warp(float* G) const {
    constexpr int W2 = 2 * NX;
    for (int p = 0; p < NX; ++p) {
      int best = p;
      float bv = fabsf(G[p * W2 + p]);
      for (int r = p + 1; r < NX; ++r) {
        const float v = fabsf(G[r * W2 + p]);
        if (v > bv) {
          bv = v;
          best = r;
        }
      }
      __syncwarp();
      for (int c = lane; c < W2; c += 32) {
        const float a = G[p * W2 + c], b = G[best * W2 + c];
        G[p * W2 + c] = b;
        G[best * W2 + c] = a;
      }
      __syncwarp();
      const float inv = 1.f / G[p * W2 + p];
      float f[NX];
#pragma unroll
      for (int i = 0; i < NX; ++i) f[i] = G[i * W2 + p];
      __syncwarp();
      for (int c = lane; c < W2; c += 32) {
        const float rp = G[p * W2 + c] * inv;
#pragma unroll
        for (int i = 0; i < NX; ++i) {
          if (i != p) G[i * W2 + c] = G[i * W2 + c] - f[i] * rp;
        }
        G[p * W2 + c] = rp;
      }
      __syncwarp();
    }
  }

  // The scan's step 2 on rank 0 (every thread): from P = P_{ks} of the
  // last chunk, for j = C-2 down to 1, P_{ke_j+1} = P into CTA j's stack,
  // then P <- sym(J_T + A_T' P (I + C_T P)^-1 A_T) of CTA j's total; CTA
  // 0's P_{ke+1} last. The totals are copied in first; Ma, Mt, Xk, At, Ct
  // and Gs of rank 0 (which forms no product and no total) are its work
  // space.
  __device__ void chain_boundaries() {
    const int C = this->ncta;
    float *const Pn = this->Ma, *const Aj = this->At, *const Cj = this->Ct,
                 *const G = this->Gs, *const Y = this->Mt,
                 *const V = this->Xk;
    constexpr int W2 = 2 * NX;
    {
      const float* P0 = remote(Pst, C - 1);
      for (int e = t; e < NXX; e += THREADS) Pn[e] = P0[e];
    }
    __syncthreads();
    for (int j = C - 2; j >= 0; --j) {
      const int nj = chunk_start(N, C, j + 1) - chunk_start(N, C, j);
      float* dst = remote(Pst, j) + (size_t)nj * NXX;  // its P_{ke+1}
      for (int e = t; e < NXX; e += THREADS) dst[e] = Pn[e];
      if (j == 0) break;
      const float* Ar = remote(this->At, j);
      const float* Cr = remote(this->Ct, j);
      const float* Jr = remote(Pst, j);
      for (int e = t; e < NXX; e += THREADS) {
        Aj[e] = Ar[e];
        Cj[e] = Cr[e];
        V[e] = Jr[e];
      }
      __syncthreads();
      for (int e = t; e < NXX; e += THREADS) {  // [I + C_T P | A_T]
        const int i = e / NX, c = e - i * NX;
        float a = Cj[i * NX] * Pn[c];
        for (int l = 1; l < NX; ++l) a += Cj[i * NX + l] * Pn[l * NX + c];
        G[i * W2 + c] = i == c ? a + 1.f : a;
        G[i * W2 + NX + c] = Aj[e];
      }
      __syncthreads();
      if (warp == 0) gauss_jordan_warp(G);
      __syncthreads();
      for (int e = t; e < NXX; e += THREADS) {  // Y = P X
        const int i = e / NX, c = e - i * NX;
        float a = Pn[i * NX] * G[NX + c];
        for (int l = 1; l < NX; ++l) a += Pn[i * NX + l] * G[l * W2 + NX + c];
        Y[e] = a;
      }
      __syncthreads();
      for (int e = t; e < NXX; e += THREADS) {  // J_T + A_T' Y
        const int i = e / NX, c = e - i * NX;
        float a = Aj[i] * Y[c];
        for (int l = 1; l < NX; ++l) a += Aj[l * NX + i] * Y[l * NX + c];
        V[e] = V[e] + a;
      }
      __syncthreads();
      for (int e = t; e < NXX; e += THREADS) {
        const int i = e / NX, c = e - i * NX;
        Pn[e] = 0.5f * (V[e] + V[c * NX + i]);
      }
      __syncthreads();
    }
  }

  // Slot of sweep step m (or of stage k in the factorization): A_k, B_k,
  // then the vectors of the sweep.
  __device__ float* ring_slot(int m) const {
    return ring + (m & (RING_SLOTS - 1)) * RING;
  }
  // The factorization's A_k | B_k: thread t loads words t + h THREADS into
  // registers a stage ahead and stores them into stage k's slot.
  static constexpr int AB = NXX + NX * NU;
  static constexpr int RF = (AB + THREADS - 1) / THREADS;
  __device__ void ab_load(int k, float (&r)[RF]) const {
#pragma unroll
    for (int h = 0; h < RF; ++h) {
      const int e = t + h * THREADS;
      r[h] = e >= AB ? 0.f
             : e < NXX ? A[(size_t)k * NXX + e]
                       : Bm[(size_t)k * NX * NU + (e - NXX)];
    }
  }
  __device__ void ab_store(int k, const float (&r)[RF]) const {
    float* dst = ring_slot(k);
#pragma unroll
    for (int h = 0; h < RF; ++h) {
      if (t + h * THREADS < AB) dst[t + h * THREADS] = r[h];
    }
  }
  // The factorization's matrix phases: every product L' R of the stage
  // (P'A, P'B; B'PB, B'PA, A'PA) is cut into 2x2 tiles of outputs, one
  // tile per thread, so that each operand loaded from shared memory feeds
  // two of the tile's four independent chains. Each output is still the
  // one sum over l = 0..NX-1 in order. Both plans take these tiles:
  // smaller tiles for the single plan's extra threads (2x1, 1x1) were
  // measured, and nvcc contracted their multiply-adds otherwise, so the
  // two plans' results parted in the last bits (at N=50-60 on the card;
  // equal with -fmad=false, and equal again with the 2x2 tiles). The
  // single plan computes A'PA, which only P_k reads, in the next phase, on
  // warps 1-3 and 5-7 while warp 0 runs the Cholesky inverse (warp 4 would
  // share warp 0's SM sub-partition: beside it the inverse took ~15%
  // longer at N=10).
  static constexpr int HX = (NX + 1) / 2, HU = (NU + 1) / 2;
  static constexpr int T1A = HX * HX, T1 = T1A + HX * HU;
  static constexpr int T2U = HU * HU, T2X = HU * HX,
                       T2 = T2U + T2X + (SINGLE ? 0 : HX * HX);
  static_assert(T1 <= THREADS && T2 <= THREADS, "one tile per thread");
  static_assert(!SINGLE || HX * HX <= 32 * (WARPS - WARPS / 4),
                "A'PA beside warp 0, off its sub-partition");
  // out (h x w, row-major) [i][j] = sum_l lp[l ll + i] rp[l rl + j] on
  // tile number `tile` (rows 2a, 2a + 1; columns 2b, 2b + 1; an odd edge
  // repeats its last row or column and does not store it)
  __device__ static void tile2x2(const float* lp, int ll, const float* rp,
                                 int rl, int h, int w, int tile, float* out) {
    const int wp = (w + 1) / 2, a = tile / wp, b = tile - a * wp;
    const int i0 = 2 * a, j0 = 2 * b;
    const int i1 = i0 + 1 < h ? i0 + 1 : i0, j1 = j0 + 1 < w ? j0 + 1 : j0;
    float c00 = lp[i0] * rp[j0], c01 = lp[i0] * rp[j1];
    float c10 = lp[i1] * rp[j0], c11 = lp[i1] * rp[j1];
#pragma unroll
    for (int l = 1; l < NX; ++l) {
      const float x0 = lp[l * ll + i0], x1 = lp[l * ll + i1];
      const float y0 = rp[l * rl + j0], y1 = rp[l * rl + j1];
      c00 += x0 * y0;
      c01 += x0 * y1;
      c10 += x1 * y0;
      c11 += x1 * y1;
    }
    out[i0 * w + j0] = c00;
    if (j1 != j0) out[i0 * w + j1] = c01;
    if (i1 != i0) {
      out[i1 * w + j0] = c10;
      if (j1 != j0) out[i1 * w + j1] = c11;
    }
  }
  enum Vec : int { V_INIT, V_BACK, V_FWD, V_KKT };
  // Where word e of stage k's slot comes from (nullptr: a word the sweep
  // does not read).
  template <int VEC>
  __device__ const float* ring_src(int k, int e) const {
    if (e < NXX) return A + (size_t)k * NXX + e;
    e -= NXX;
    if (e < NX * NU) return Bm + (size_t)k * NX * NU + e;
    e -= NX * NU;
    if constexpr (VEC == V_INIT) {
      if (e < NX) return c + k * NX + e;
    } else if constexpr (VEC == V_BACK) {
      if (e < NX) return req + k * NX + e;
      if (e < 2 * NX) return qr + k * NX + (e - NX);
      if (e < 2 * NX + NU) return rr + k * NU + (e - 2 * NX);
    } else if constexpr (VEC == V_FWD) {
      if (e < NX) return req + k * NX + e;
      if (e < NX + NU) return kff + k * NU + (e - NX);
    } else {
      if (e < NX) return kx + k * NX + e;
      if (e < NX + NU) return ku + k * NU + (e - NX);
      if (k >= 1 && e < 2 * NX + NU) {
        return lam[0] + (k - 1) * NX + (e - NX - NU);
      }
      if (k >= 1 && e < 3 * NX + NU) {
        return lam[1] + (k - 1) * NX + (e - 2 * NX - NU);
      }
      if (e >= 3 * NX + NU && e < 3 * NX + 2 * NU) {
        return lam[2] + k * NU + (e - 3 * NX - NU);
      }
      if (e >= 3 * NX + 2 * NU && e < 3 * NX + 3 * NU) {
        return lam[3] + k * NU + (e - 3 * NX - 2 * NU);
      }
    }
    return nullptr;
  }

  // A sweep on warp 0 reads each stage from the ring; warps 1..PRODUCERS
  // fill it (the single plan's other warps wait at the barrier that closes
  // the sweep). Step m < n of the sweep visits stage first + m dir. Producer
  // warp w takes the steps m = w - 1 (mod PRODUCERS): it loads the stage into
  // registers (coalesced plain loads, started before it waits), waits until
  // the slot's previous step m - RING_SLOTS has been served, stores it,
  // and publishes the step in full[slot]. Warp 0 polls full[slot] for the
  // step, reads the slot and publishes the step in empty[slot].
  __device__ void sweep_begin() {
    __syncthreads();  // the ring's previous readers and writers are done
    if (t < RING_SLOTS) {
      sh.full[t] = -1;
      sh.empty[t] = t - RING_SLOTS;
    }
    __syncthreads();
  }
  template <int VEC>
  __device__ void produce(int first, int dir, int n) {
    constexpr int W = (RING + 31) / 32;
    if (warp > PRODUCERS) return;
    for (int m = warp - 1; m < n; m += PRODUCERS) {
      const int k = first + m * dir, s = m & (RING_SLOTS - 1);
      float r[W];
#pragma unroll
      for (int h = 0; h < W; ++h) {
        const float* p = ring_src<VEC>(k, lane + 32 * h);
        r[h] = (lane + 32 * h < RING && p) ? *p : 0.f;
      }
      while (ld_volatile(&sh.empty[s]) < m - RING_SLOTS) {
      }
      __threadfence_block();
      float* dst = ring_slot(m);
#pragma unroll
      for (int h = 0; h < W; ++h) {
        if (lane + 32 * h < RING) dst[lane + 32 * h] = r[h];
      }
      __threadfence_block();
      __syncwarp();
      if (lane == 0) st_volatile(&sh.full[s], m);
    }
  }
  // warp 0: the slot of step m once it is filled
  __device__ const float* acquire(int m) const {
    while (ld_volatile(&sh.full[m & (RING_SLOTS - 1)]) != m) {
    }
    __threadfence_block();
    return ring_slot(m);
  }
  // warp 0: step m's slot may be refilled
  __device__ void release(int m) {
    __syncwarp();
    if (lane == 0) {
      __threadfence_block();
      st_volatile(&sh.empty[m & (RING_SLOTS - 1)], m);
    }
  }
  // The ring as a sweep on warp 0 sees it: acquire and release on the
  // Solver's fields copied out once. The ring's fences make every value
  // in memory stale, and every FUSE_LIN Solver lives in local memory (its
  // out-of-line prologue member takes its address), so a sweep that
  // reads them from the Solver reloads them at every step.
  struct Ring {
    float* base;
    int *full, *empty;
    bool lead;
    __device__ const float* acquire(int m) const {
      while (ld_volatile(&full[m & (RING_SLOTS - 1)]) != m) {
      }
      __threadfence_block();
      return base + (m & (RING_SLOTS - 1)) * RING;
    }
    __device__ void release(int m) const {
      __syncwarp();
      if (lead) {
        __threadfence_block();
        st_volatile(&empty[m & (RING_SLOTS - 1)], m);
      }
    }
  };
  __device__ Ring ring_view() const {
    return Ring{ring, sh.full, sh.empty, lane == 0};
  }

  // ---- fused assembly ----------------------------------------------------
  // FUSE_LIN prologue: items first, first + step, ... Item e takes node
  // k = e / CP and the LIN_COLS tangent columns j0 .. j0 + LIN_COLS - 1 of
  // that node (C = NX + NU columns; j < NX seeds x_j, else u_{j-NX}), runs
  // RK4 of the family's ODE on duals and writes those columns of A_k or
  // B_k; column 0 also writes the shooting defect c_k = x_next -
  // xbar_{k+1}. Compiled out of line, so that the registers its dual
  // numbers take do not crowd the solve's loops, and called on the batch
  // plan's Solver by both plans: on the solve's block (step THREADS) and
  // by the single plan's prologue grid (one item a thread), so that the
  // two records are the same bits.
  __device__ __noinline__ void linearize_items(const Model& md, int first,
                                               int step) {
    constexpr int C = NX + NU, CP = (C + LIN_COLS - 1) / LIN_COLS;
    for (int e = first; e < N * CP; e += step) {
      const int k = e / CP, j0 = (e - k * CP) * LIN_COLS;
      DualN<LIN_COLS> X[NX], U[NU];
#pragma unroll
      for (int i = 0; i < NX; ++i) {
        X[i].v = xbar[k * NX + i];
#pragma unroll
        for (int h = 0; h < LIN_COLS; ++h) X[i].d[h] = i == j0 + h ? 1.f : 0.f;
      }
#pragma unroll
      for (int i = 0; i < NU; ++i) {
        U[i].v = ubar[k * NU + i];
#pragma unroll
        for (int h = 0; h < LIN_COLS; ++h) {
          U[i].d[h] = NX + i == j0 + h ? 1.f : 0.f;
        }
      }
      rk4_rows<FAM, NX>(X, U, sp + (size_t)k * np, md);
#pragma unroll
      for (int h = 0; h < LIN_COLS; ++h) {
        const int j = j0 + h;
        if (j < NX) {
#pragma unroll
          for (int i = 0; i < NX; ++i) {
            Aw[((size_t)k * NX + i) * NX + j] = X[i].d[h];
          }
        } else if (j < C) {
#pragma unroll
          for (int i = 0; i < NX; ++i) {
            Bw[((size_t)k * NX + i) * NU + (j - NX)] = X[i].d[h];
          }
        }
      }
      if (j0 == 0) {
#pragma unroll
        for (int i = 0; i < NX; ++i) {
          cw[k * NX + i] = X[i].v - xbar[(k + 1) * NX + i];
        }
      }
    }
  }
  // the prologue on the block. The single plan has run it as a grid of its
  // own before this launch (`launch`): here it calls for no item, so that
  // its Solver is laid out as the batch plan's (whose address the call
  // takes; measured on the card, without the call nvcc contracted the
  // FUSE_LIN solve's multiply-adds otherwise and the plans parted by
  // 2e-4 in du after one iteration)
  __device__ void linearize(const Model& md) {
    if constexpr (SINGLE) {
      linearize_items(md, N * ((NX + NU + LIN_COLS - 1) / LIN_COLS), 1);
    } else {
      linearize_items(md, t, THREADS);
      __syncthreads();
    }
  }

  // build_qp's cost and bound rows from the iterate (Qs and R arrive
  // dt-scaled, the terminal Qt unscaled; the gradient uses Rg):
  // q_k = Qs' (xbar_k - yref_k), q_N = Qt' (xbar_N - yref_e),
  // r_k = Rg' (ubar_k - yref_u,k), delta bound = absolute box - iterate.
  // (the Solver's fields copied out first: every FUSE_LIN Solver lives in
  // local memory, and a store through a float pointer could alias it, so
  // each would be reloaded after every store)
  __device__ void cost_fill() {
    const int N = this->N, t = this->t;
    const float *const Qs = this->Qs, *const Qt = this->Qt,
                *const Rg = this->Rg, *const xbar = this->xbar,
                *const ubar = this->ubar, *const yrx = this->yrx,
                *const yru = this->yru, *const yre = this->yre;
    float *const qf = this->qf, *const rf = this->rf;
    float* const bd[4] = {this->bd[0], this->bd[1], this->bd[2],
                          this->bd[3]};
    const float* const box[4] = {this->box[0], this->box[1], this->box[2],
                                 this->box[3]};
    for (int e = t; e < (N + 1) * NX; e += THREADS) {
      const int k = e / NX, i = e - k * NX;
      const float* Qm = k == N ? Qt : Qs;
      const float* yr = k == N ? yre : yrx + k * NX;
      const float* xb = xbar + k * NX;
      float a = Qm[i] * (xb[0] - yr[0]);
      for (int j = 1; j < NX; ++j) a += Qm[j * NX + i] * (xb[j] - yr[j]);
      qf[e] = a;
    }
    for (int e = t; e < N * NU; e += THREADS) {
      const int k = e / NU, i = e - k * NU;
      const float* ub = ubar + k * NU;
      const float* yr = yru + k * NU;
      float a = Rg[i] * (ub[0] - yr[0]);
      for (int j = 1; j < NU; ++j) a += Rg[j * NU + i] * (ub[j] - yr[j]);
      rf[e] = a;
    }
    for (int e = t; e < N * NX; e += THREADS) {
      const int i = e % NX;
      const float x = xbar[e + NX];
      bd[0][e] = box[0][i] - x;
      bd[1][e] = box[1][i] - x;
    }
    for (int e = t; e < N * NU; e += THREADS) {
      const int i = e % NU;
      const float u = ubar[e];
      bd[2][e] = box[2][i] - u;
      bd[3][e] = box[3][i] - u;
    }
    __syncthreads();
  }

  // FUSE_COST's last pass: the best iterate (in dx/du) leaves as the
  // absolute xbar + dx / ubar + du; step norms (stage 0 included) and the
  // worst box violation of the new iterate (a +-1e18 box never counts).
  __device__ void finish(float& sx, float& su, float& vio) {
    float ax = 0.f, au = 0.f, v = 0.f;
    for (int e = t; e < (N + 1) * NX; e += THREADS) {
      const int i = e % NX;
      const float d = dx[e], xn = xbar[e] + d;
      ax = nmax(ax, fabsf(d));
      dxb[e] = xn;
      v = nmax(v, box[0][i] - xn);
      v = nmax(v, xn - box[1][i]);
    }
    for (int e = t; e < N * NU; e += THREADS) {
      const int i = e % NU;
      const float d = du[e], un = ubar[e] + d;
      au = nmax(au, fabsf(d));
      dub[e] = un;
      v = nmax(v, box[2][i] - un);
      v = nmax(v, un - box[3][i]);
    }
    sx = block_reduce<WARPS>(ax, sh.red, OpMax());
    su = block_reduce<WARPS>(au, sh.red, OpMax());
    vio = block_reduce<WARPS>(v, sh.red, OpMax());
  }

  // ---- bound rows -------------------------------------------------------
  // Row e of the N*(NX+NU) box rows: state rows first (slack index k bounds
  // dx[k+1], states are bounded at stages 1..N), then control rows. Each row
  // has a lower (group gb) and an upper (group gb+1) bound. f(gb, idx, vi):
  // idx indexes the (N, n) group arrays, vi the primal/direction arrays.
  template <class F>
  __device__ void for_rows(F f) const {
    for_rows_from(t, THREADS, f);
  }
  // rows first, first + step, ...: the rows of virtual thread `first` of
  // a `step`-thread block (two rows at a time; one in SOFT, whose row
  // passes would spill at two)
  template <class F>
  __device__ void for_rows_from(int first, int step, F f) const {
    if constexpr (CLUSTER) {  // the chunk's state rows, then its control rows
      const int x0 = this->xr0, u0 = this->ur0, nxr = this->xr1 - x0;
      const int tot = nxr + this->ur1 - u0;
#pragma unroll 2
      for (int e = first; e < tot; e += step) {
        if (e < nxr) {
          f(0, x0 + e, x0 + e + NX);
        } else {
          f(2, u0 + e - nxr, u0 + e - nxr);
        }
      }
      return;
    }
    const int nxr = N * NX, tot = N * (NX + NU);
#pragma unroll(SOFT ? 1 : 2)
    for (int e = first; e < tot; e += step) {
      if (e < nxr) {
        f(0, e, e + NX);
      } else {
        f(2, e - nxr, e - nxr);
      }
    }
  }
  // A per-problem sum over the rows in the order of a SUM_THREADS-thread
  // block: term(acc, gb, idx, vi) adds a row's terms to acc (block_sum).
  template <class F>
  __device__ float rows_sum(F term) const {
    float a[VT];
#pragma unroll
    for (int h = 0; h < VT; ++h) {
      float& acc = a[h];
      acc = 0.f;
      for_rows_from(t + h * THREADS, SUM_THREADS,
                    [&](int gb, int idx, int vi) { term(acc, gb, idx, vi); });
    }
    if constexpr (CLUSTER) {  // per chunk, then the chunks in stage order
      float v[1] = {block_sum<THREADS>(a, sh.red)};
      cluster_combine(v, OpSum());
      return v[0];
    }
    return block_sum<THREADS>(a, sh.red);
  }

  __device__ static float sgn(int g) { return (g & 1) ? -1.f : 1.f; }
  __device__ static float mask(int g, float b) {
    return (g & 1) ? (b < MTHR ? 1.f : 0.f) : (b > -MTHR ? 1.f : 0.f);
  }
  // slack residual s - sgn (v - b)
  __device__ float rs(int g, int idx, float v) const {
    return s[g][idx] - sgn(g) * (v - bnd[g][idx]);
  }
  __device__ float sig(int g, int idx) const {
    const float m = mask(g, bnd[g][idx]);
    return nmin(m * lam[g][idx] / s[g][idx], SIGMA_MAX);
  }
  // Newton slack/dual directions of one bound entry for primal direction dd
  __device__ void dirs(int g, int idx, float v, float dd, float T, float& ds,
                       float& dl) const {
    const float m = mask(g, bnd[g][idx]);
    const float sv = s[g][idx], lv = lam[g][idx];
    ds = m * (sgn(g) * dd - rs(g, idx, v));
    dl = m * clipf((T - sv * lv - lv * ds) / sv, -DUAL_CLIP, DUAL_CLIP);
  }
  // complementarity target: 0 (predictor) or the Gondzio-clipped Mehrotra
  // target from the affine directions in ddxa/ddua (corrector)
  __device__ float target(bool cor, int g, int idx, float v,
                          float dda) const {
    if (!cor) return 0.f;
    float ds, dl;
    dirs(g, idx, v, dda, 0.f, ds, dl);
    return clipf(mu_t - ds * dl, 0.05f * mu_t, 20.f * mu_t);
  }
  __device__ static float ratio(float v, float dv, float tau) {
    return dv < 0.f ? (-tau * v) / dv : BIG;
  }

  // ---- soft rows (SOFT only) ---------------------------------------------
  // Each bound entry (g, idx) has a slot e in the soft area: its class
  // (init classifies every entry once per launch), its violation pair and
  // penalty, and the per-iteration terms the row passes hand on. Every
  // soft term is formed once per row and iteration, by the pass that first
  // needs it, in the operation order of the one-formula-per-use form:
  //   factorize's weight pass   sig_s (every entry) and, on a soft row,
  //                             den = (Z + sig_s) + gam / t, then
  //                             sig_eff = sig_s (Z + gam / t) / den;
  //   rhs_grads, predictor      w for targets (0, 0) -> W0;
  //   alphas, predictor         the affine directions ds, dl, dt, dg
  //                             -> W0..W3 (mu_aff_sum reads them);
  //   rhs_grads, corrector      the targets Ts, Tt and w -> W0..W2;
  //   alphas, corrector         the directions -> W0..W3 (update reads
  //                             them).
  // A hard row of the soft instantiation takes the same slots (sig_s, its
  // directions and its target) and never the elimination: sig_s itself,
  // never the formula, whose Z = 1e18 sentinel rounds to sig_s only within
  // one ulp in float32.
  __device__ int sent(int g, int idx) const {
    return g < 2 ? g * N * NX + idx : 2 * N * NX + (g - 2) * N * NU + idx;
  }
  __device__ float& sf(int f, int e) const { return this->sa[f * this->E + e]; }
  // A row is soft where its bound is finite and its Z is not the sentinel.
  __device__ bool srow(int g, int idx) const {
    if constexpr (SOFT) return this->cls[sent(g, idx)] == C_SOFT;
    return false;
  }
  // every entry's class, Z and z (before anything reads the class); the
  // group loop is unrolled, so that no member array is indexed at run time
  // (that would put the Solver in local memory)
  __device__ void classify() {
    if constexpr (SOFT) {
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const int n = N * (g < 2 ? NX : NU);
        for (int idx = t; idx < n; idx += THREADS) {
          const int e = sent(g, idx);
          const float Z = this->Zg[g][idx];
          this->cls[e] = mask(g, bnd[g][idx]) <= 0.5f ? C_INF
                         : Z < MTHR                  ? C_SOFT
                                                     : C_HARD;
          sf(F_Z, e) = Z;
          sf(F_ZL, e) = this->zg[g][idx];
        }
      }
    }
  }
  // slack residual s - sgn (v - b) (- t on a soft row)
  __device__ float rs_soft(int g, int idx, int e, bool soft, float v) const {
    if (soft) {
      return s[g][idx] - (sgn(g) * (v - bnd[g][idx]) + sf(F_T, e));
    }
    return s[g][idx] - sgn(g) * (v - bnd[g][idx]);
  }
  // soft stationarity z + Z t - lam - gam of a soft row
  __device__ float soft_rt(int g, int idx, int e) const {
    return ((sf(F_ZL, e) + sf(F_Z, e) * sf(F_T, e)) - lam[g][idx])
           - sf(F_GAM, e);
  }
  // the right-hand-side scalar w = -r_t + (Ts/s - lam) + (Tt/t - gam) +
  // sig_s r of a soft row
  __device__ float soft_w(int g, int idx, int e, float r, float Ts,
                          float Tt) const {
    const float sv = s[g][idx], lv = lam[g][idx];
    const float tt = sf(F_T, e), gg = sf(F_GAM, e);
    return ((-soft_rt(g, idx, e) + (Ts / sv - lv)) + (Tt / tt - gg))
           + sf(F_SS, e) * r;
  }
  // max |z + Z t - lam - gam| over the soft rows (soft stationarity)
  __device__ float soft_rt_max() const {
    float acc = 0.f;
    for_rows([&](int gb, int idx, int) {
      for (int g = gb; g < gb + 2; ++g) {
        const int e = sent(g, idx);
        if (this->cls[e] == C_SOFT) acc = nmax(acc, fabsf(soft_rt(g, idx, e)));
      }
    });
    return block_reduce<WARPS>(acc, sh.red, OpMax());
  }
  // the best-iterate merit: stat + eq (+ soft stationarity) + mean comp
  __device__ float merit(float st, float eq) const {
    if constexpr (SOFT) return st + eq + soft_rt_max() + comp_sum() / n_ineq;
    return st + eq + comp_sum() / n_ineq;
  }

  // ---- phases -------------------------------------------------------------
  // the init's 10% inset of bound row idx of groups (gb, gb+1); SOFT insets
  // the hard rows only
  __device__ float clamp_init(float v, int gb, int idx) const {
    const float lb = bnd[gb][idx], ub = bnd[gb + 1][idx];
    if constexpr (SOFT) {
      return clamp_masked(v, lb, ub, lb > -MTHR && !srow(gb, idx),
                          ub < MTHR && !srow(gb + 1, idx));
    }
    return clamp_into(v, lb, ub);
  }

  // The rollout (du = 0) with the 10%-inset clamp over this block's
  // stages, on warp 0 (lane i < NX carries state i), from the state d at
  // its first stage; returns the state after its last stage (which the
  // cluster plan's chunk hands on, where it is not dx_N).
  __device__ float rollout(float d) {
    const Ring rg = ring_view();
    const auto acquire = [&rg](int m) { return rg.acquire(m); };
    const auto release = [&rg](int m) { rg.release(m); };
    const int kb = kbase(), kh = ktop(), lane = this->lane;
    const bool store_last = last_chunk();
    float* const dx = this->dx;
    const int xi = lane < NX ? lane : 0;
    if (lane < NX) dx[kb * NX + lane] = d;
    for (int k = kb; k <= kh; ++k) {
      const float* slot = acquire(k - kb);
      const float* Ar = slot + xi * NX;
      float dv[NX];
#pragma unroll
      for (int j = 0; j < NX; ++j) dv[j] = __shfl_sync(FULL, d, j);
      float a = Ar[0] * dv[0];
#pragma unroll
      for (int j = 1; j < NX; ++j) a += Ar[j] * dv[j];
      a += slot[NXX + NX * NU + xi];  // c_k
      release(k - kb);
      d = clamp_init(a, 0, k * NX + xi);
      if (lane < NX && (k < kh || store_last)) dx[(k + 1) * NX + lane] = d;
    }
    return d;
  }

  // the rollout, then centred slacks and duals and the warm blend over
  // them, on the block (the cluster plan: the rollout chunk by chunk, each
  // CTA from the state its predecessor handed it; then each CTA's rows and
  // its chunk's product of A for the KKT pass's scans)
  __device__ void init() {
    classify();
    if constexpr (CLUSTER) {
      for (int r = 0; r < this->ncta; ++r) {
        if (this->rank == r) {
          sweep_begin();
          if (warp == 0) {
            const int xi = lane < NX ? lane : 0;
            const float d = rollout(r == 0 ? dx0[xi] : this->vin[xi]);
            if (!last_chunk() && lane < NX) remote(this->vin, r + 1)[lane] = d;
          } else {
            produce<V_INIT>(this->ks, 1, this->ke - this->ks + 1);
          }
          __syncthreads();
        }
        cluster_sync();
      }
    } else {
      sweep_begin();
      if (warp == 0) {
        const int xi = lane < NX ? lane : 0;
        float d;
        if constexpr (MODE == PLAIN) {
          d = dx0[xi];
        } else {
          d = x0[xi] - xbar[xi];
        }
        rollout(d);
      } else {
        produce<V_INIT>(0, 1, N);
      }
    }
    __syncthreads();
    float cnt = 0.f;
    for_rows([&](int gb, int idx, int vi) {
      float* V = gb ? du : dx;
      if (gb) V[vi] = clamp_init(0.f, 2, idx);
      const float v = V[vi];
      for (int g = gb; g < gb + 2; ++g) {
        const float b = bnd[g][idx], m = mask(g, b);
        float gap = sgn(g) * (v - b);
        if constexpr (SOFT) {
          // violation pair: O(1) offset on a soft row, inert on a hard one
          const int e = sent(g, idx);
          const bool sr = this->cls[e] == C_SOFT;
          const float tt = sr ? nmax(-gap, 0.f) + 0.1f : BIG;
          sf(F_T, e) = tt;
          sf(F_GAM, e) = sr ? mu0 / tt : 0.f;
          if (sr) gap = gap + tt;
          cnt += sr ? 1.f : 0.f;
        }
        float sv = m > 0.5f ? nmax(gap, S_MIN) : BIG;
        float lv = m > 0.5f ? mu0 / sv : 0.f;
        if (warm_use && m > 0.5f) {
          // NaN-propagating clips: a NaN entry stays NaN and keeps the cold
          // value; fminf/fmaxf would turn it into a bound and accept it
          const float w = clipf(ws[g][idx], WARM_S_MIN, BIG);
          const float wlv = nmax(clipf(wl[g][idx], 0.f, LAM_MAX), 1e-8f);
          if (isfinite(w)) sv = w;
          if (isfinite(wlv)) lv = wlv;
        }
        s[g][idx] = sv;
        lam[g][idx] = lv;
        cnt += m;
      }
    });
    if constexpr (CLUSTER) {
      float v[1] = {block_reduce<WARPS>(cnt, sh.red, OpSum())};
      cluster_combine(v, OpSum());
      n_ineq = nmax(v[0], 1.f);
      if (this->rank >= 1 && this->rank <= this->ncta - 2) {
        chunk_product(false, this->Ma);
      }
    } else {
      n_ineq = nmax(block_reduce<WARPS>(cnt, sh.red, OpSum()), 1.f);
    }
    __syncthreads();
  }

  __device__ float comp_sum() const {
    return rows_sum([&](float& acc, int gb, int idx, int) {
      for (int g = gb; g < gb + 2; ++g) {
        if constexpr (SOFT) {
          const int e = sent(g, idx);
          const unsigned char c = this->cls[e];
          acc += (c != C_INF ? 1.f : 0.f) * s[g][idx] * lam[g][idx];
          if (c == C_SOFT) acc += sf(F_T, e) * sf(F_GAM, e);
        } else {
          acc += mask(g, bnd[g][idx]) * s[g][idx] * lam[g][idx];
        }
      }
    });
  }

  // (stat, eq) of the iterate in dx/du by the adjoint sweep; refreshes req
  // with the shooting residuals (the next solve's right-hand side). The
  // block forms the residuals and each stage's Qs' dx_k + q_k and
  // R' du_k + r_k; warp 0 runs the adjoint sweep (lane i < NX carries the
  // multiplier i; lane NX + t forms the control stationarity row t).
  __device__ void kkt(float& stat_out, float& eq_out) {
    if constexpr (CLUSTER) {
      kkt_cluster(stat_out, eq_out);
      return;
    }
    float eq = 0.f;
    for (int e = t; e < N * NX; e += THREADS) {
      const int k = e / NX, i = e - k * NX;
      const float* Ar = A + (size_t)k * NXX + i * NX;
      const float* Br = Bm + ((size_t)k * NX + i) * NU;
      const float* x = dx + k * NX;
      const float* u = du + k * NU;
      float a = Ar[0] * x[0];
      for (int j = 1; j < NX; ++j) a += Ar[j] * x[j];
      float bu = Br[0] * u[0];
      for (int j = 1; j < NU; ++j) bu += Br[j] * u[j];
      const float pred = ((a + bu) + c[e]) - dx[e + NX];
      req[e] = pred;
      eq = nmax(eq, fabsf(pred));
      float g = Qs[i] * x[0];
      for (int j = 1; j < NX; ++j) g += Qs[j * NX + i] * x[j];
      kx[e] = g + q[e];
    }
    for (int e = t; e < N * NU; e += THREADS) {
      const int k = e / NU, i = e - k * NU;
      const float* u = du + k * NU;
      float a = R[i] * u[0];
      for (int j = 1; j < NU; ++j) a += R[j * NU + i] * u[j];
      ku[e] = a + r[e];
    }
    sweep_begin();
    float stat = 0.f;
    if (warp == 0) {
      float lm = kkt_terminal();
      stat = kkt_sweep(lm);
    } else {
      produce<V_KKT>(N - 1, -1, N);
    }
    stat_out = block_reduce<WARPS>(stat, sh.red, OpMax());
    eq_out = block_reduce<WARPS>(eq, sh.red, OpMax());
  }

  // The cluster plan's KKT pass: the next chunk's first state into this
  // CTA's halo (req_ke reads dx_{ke+1}), the chunk's stage terms, the
  // adjoint sweep as a chunked scan on the chunks' products of A, and the
  // maxima over the cluster.
  __device__ void kkt_cluster(float& stat_out, float& eq_out) {
    const int ks = this->ks, ke = this->ke, n = ke - ks + 1;
    const bool last = last_chunk();
    __syncthreads();  // this CTA's states are written
    if (this->rank > 0 && t < NX) {
      remote(this->halo, this->rank - 1)[t] = dx[ks * NX + t];
    }
    cluster_sync();
    float eq = 0.f;
    for (int e = ks * NX + t; e < (ke + 1) * NX; e += THREADS) {
      const int k = e / NX, i = e - k * NX;
      const float* Ar = A + (size_t)k * NXX + i * NX;
      const float* Br = Bm + ((size_t)k * NX + i) * NU;
      const float* x = dx + k * NX;
      const float* u = du + k * NU;
      float a = Ar[0] * x[0];
      for (int j = 1; j < NX; ++j) a += Ar[j] * x[j];
      float bu = Br[0] * u[0];
      for (int j = 1; j < NU; ++j) bu += Br[j] * u[j];
      const float xn = (k == ke && !last) ? this->halo[i] : dx[e + NX];
      const float pred = ((a + bu) + c[e]) - xn;
      req[e] = pred;
      eq = nmax(eq, fabsf(pred));
      float g = Qs[i] * x[0];
      for (int j = 1; j < NX; ++j) g += Qs[j * NX + i] * x[j];
      kx[e] = g + q[e];
    }
    for (int e = ks * NU + t; e < (ke + 1) * NU; e += THREADS) {
      const int k = e / NU, i = e - k * NU;
      const float* u = du + k * NU;
      float a = R[i] * u[0];
      for (int j = 1; j < NU; ++j) a += R[j * NU + i] * u[j];
      ku[e] = a + r[e];
    }
    // (1) from the true boundary (the last chunk) or from 0
    float stat = 0.f;
    sweep_begin();
    if (warp == 0) {
      float lm = last ? kkt_terminal() : 0.f;
      stat = kkt_sweep(lm);
      if (lane < NX) this->vout[lane] = lm;
    } else {
      produce<V_KKT>(ke, -1, n);
    }
    scan_boundaries(true, this->Ma);  // (2)
    if (!last) {  // (3) from the true boundary
      sweep_begin();
      if (warp == 0) {
        float lm = this->vin[lane < NX ? lane : 0];
        stat = kkt_sweep(lm);
      } else {
        produce<V_KKT>(ke, -1, n);
      }
    }
    float v[2] = {block_reduce<WARPS>(stat, sh.red, OpMax()),
                  block_reduce<WARPS>(eq, sh.red, OpMax())};
    cluster_combine(v, OpMax());
    stat_out = v[0];
    eq_out = v[1];
  }

  // the adjoint sweep's multiplier into stage N - 1 (lane i < NX: entry i):
  // Qt' dx_N + q_N - (lam0 - lam1) of dx_N's rows
  __device__ float kkt_terminal() const {
    const int xi = lane < NX ? lane : 0;
    float a = Qt[xi] * dx[N * NX];
    for (int j = 1; j < NX; ++j) a += Qt[j * NX + xi] * dx[N * NX + j];
    const int l = (N - 1) * NX + xi;
    return (a + q[N * NX + xi]) - (lam[0][l] - lam[1][l]);
  }

  // The adjoint sweep over this block's stages from the multiplier lm into
  // its last one, on warp 0 (lane i < NX carries multiplier i; lane NX + t
  // forms the control stationarity row t); leaves the multiplier out of
  // its first stage in lm and returns the stationarity's maximum.
  __device__ float kkt_sweep(float& lm) {
    const Ring rg = ring_view();
    const auto acquire = [&rg](int m) { return rg.acquire(m); };
    const auto release = [&rg](int m) { rg.release(m); };
    const int k0 = kbase(), kh = ktop();
    const bool xl = lane < NX, ul = lane >= NX && lane < NX + NU;
    const int xi = xl ? lane : 0, ui = ul ? lane - NX : 0;
    float stat = 0.f;
    for (int m = 0; m <= kh - k0; ++m) {
      const int k = kh - m;
      const float* Ak = acquire(m);
      const float* v = Ak + NXX + NX * NU;
      // Qs' dx_k + q_k or R' du_k + r_k; the multiplier term of the row:
      // state lane i (lam0 - lam1) of row (k - 1) NX + i, control lane t
      // (lam2 - lam3) of row k NU + t
      const float kb = xl ? v[xi] : v[NX + ui];
      const float lt = xl ? v[NX + NU + xi] - v[2 * NX + NU + xi]
                          : v[3 * NX + NU + ui] - v[3 * NX + 2 * NU + ui];
      const float* col = xl ? Ak + xi : Ak + NXX + ui;
      const int ld = xl ? NX : NU;
      float lv[NX];
#pragma unroll
      for (int j = 0; j < NX; ++j) lv[j] = __shfl_sync(FULL, lm, j);
      float al = col[0] * lv[0];
#pragma unroll
      for (int j = 1; j < NX; ++j) al += col[j * ld] * lv[j];
      release(m);
      if (ul) {
        const float su = (kb + al) - lt;
        stat = nmax(stat, fabsf(su));
      }
      if (xl) {
        float y = kb + al;
        if (k >= 1) y = y - lt;
        lm = y;
      }
    }
    return stat;
  }

  // the factorization's weight of one entry: sig_s, or the eliminated
  // sig_eff on a soft row; SOFT keeps sig_s and the pair's denominator
  __device__ float sig_fac(int g, int idx) const {
    const float ss = sig(g, idx);
    if constexpr (SOFT) {
      const int e = sent(g, idx);
      sf(F_SS, e) = ss;
      if (this->cls[e] == C_SOFT) {
        const float Z = sf(F_Z, e), st = sf(F_GAM, e) / sf(F_T, e);
        const float den = (Z + ss) + st;
        sf(F_DEN, e) = den;
        return ss * (Z + st) / den;
      }
    }
    return ss;
  }

  __device__ float sig_pair(int gb, int idx) const {
    return nmin(sig_fac(gb, idx) + sig_fac(gb + 1, idx), SIGMA_MAX);
  }

  // backward Riccati factorization: P (N+1 stack), Z = Hinv Hux, Hinv.
  // Per stage four phases, each closed by a block barrier: PA|PB; Huu|Hux
  // (batch plan: |A'PA); the Cholesky inverse and Z on warp 0 (single
  // plan: A'PA on the other warps meanwhile); the symmetrized P_k.
  //
  // The cluster plan, after its chunk's barrier weights: the chunked scan
  // of the value-function elements (A_k, B_k R_k^-1 B_k', Q_k) of
  // qp/pscan.py::riccati_factorize_pscan. (1) The last CTA runs its
  // chunk's recursion from P_N; CTAs 1..C-2 reduce their chunks to their
  // totals (A_T, C_T, J_T) by the recursion from P = 0 (J_T its first P,
  // A_T the product of its closed-loop F_k, C_T the sum of A_T B_k Hinv_k
  // B_k' A_T': `total_step`). (2) Rank 0 walks the chunk boundaries from
  // the last chunk's first P, P <- J_T + A_T' P (I + C_T P)^-1 A_T
  // (`chain_boundaries`), and leaves each chunk's P_{ke+1} in its stack.
  // (3) Every other CTA runs its chunk's recursion from it, then forms its
  // chunk's product of F_k = A_k - B_k Z_k for the solves' scans (the first
  // and the last chunk need none: each holds a scan's true boundary).
  __device__ void factorize() {
    if constexpr (CLUSTER) {  // the barrier weights of the chunk's rows
      for (int e = this->xr0 + t; e < this->xr1; e += THREADS) {
        sgx[e] = sig_pair(0, e);
      }
      for (int e = this->ur0 + t; e < this->ur1; e += THREADS) {
        sgu[e] = sig_pair(2, e);
      }
      const auto none = [](int) {};
      const int r = this->rank, C = this->ncta;
      if (r == C - 1) {  // (1)
        factor_chunk(P_TERMINAL, none);
      } else if (r > 0) {
        this->atc = ((this->ke - this->ks) & 1) ? this->Mt : this->At;
        factor_chunk(P_ZERO, [this](int k) { total_step(k); });
      }
      cluster_sync();
      if (r == 0) chain_boundaries();  // (2)
      cluster_sync();
      if (r < C - 1) {  // (3)
        factor_chunk(P_IN_PLACE, none);
        if (r > 0) chunk_product(true, this->Mf);
      }
      cluster_sync();
      return;
    }
    // barrier weights of every row, one pass
    for (int e = t; e < N * NX; e += THREADS) sgx[e] = sig_pair(0, e);
    for (int e = t; e < N * NU; e += THREADS) sgu[e] = sig_pair(2, e);
    factor_chunk(P_TERMINAL, [](int) {});
  }

  // Where a chunk's recursion takes its P_{ktop()+1} from: P_N (the last
  // chunk; every block outside the cluster plan); zero (the scan's
  // totals); already in the stack (the scan's boundaries).
  enum PSource : int { P_TERMINAL, P_ZERO, P_IN_PLACE };

  // The factorization's stages ktop() down to kbase(), from P_{ktop()+1}
  // (`psrc`), with after(k) called by every thread after stage k.
  template <class After>
  __device__ void factor_chunk(int psrc, After after) {
    const int kb = kbase(), kh = ktop();
    {
      float r[RF];
      ab_load(kh, r);
      ab_store(kh, r);
    }
    __syncthreads();
    if constexpr (CLUSTER) {
      if (psrc == P_ZERO) {
        float* P1 = Pw(kh + 1);
        for (int e = t; e < NXX; e += THREADS) P1[e] = 0.f;
      }
    }
    if (psrc == P_TERMINAL) {
      float* PN = Pw(N);
      for (int e = t; e < NXX; e += THREADS) {
        const int i = e / NX, j = e - i * NX;
        float v = Qt[e];
        if (i == j) v = v + sgx[(N - 1) * NX + i];
        PN[e] = v;
        if (!res) Pst[(size_t)N * NXX + e] = v;
      }
    }
    // thread t < NX owns P's diagonal entry t, thread t < NU Huu's entry
    // (t, t): their weights, loaded one stage ahead
    const bool hdiag = t < NU;
    const int hi = t;
    float wx_next = (t < NX && kh >= 1) ? sgx[(kh - 1) * NX + t] : 0.f;
    float wu_next = hdiag ? sgu[kh * NU + hi] : 0.f;
    __syncthreads();
    for (int k = kh; k >= kb; --k) {
      const float wx_k = wx_next, wu_k = wu_next;
      float pre[RF];  // A_{k-1}, B_{k-1}, stored into the ring at the end
      if (k > kb) {
        ab_load(k - 1, pre);
        if (t < NX && k >= 2) wx_next = sgx[(k - 2) * NX + t];
        if (hdiag) wu_next = sgu[(k - 1) * NU + hi];
      }
      const float* Pn = Pw(k + 1);
      const float* Ak = ring_slot(k);
      const float* Bk = Ak + NXX;
      if (t < T1) {  // PA = P' A, PB = P' B (one instruction stream)
        const bool a = t < T1A;
        tile2x2(Pn, NX, a ? Ak : Bk, a ? NX : NU, NX, a ? NX : NU,
                a ? t : t - T1A, a ? sh.PA : sh.PB);
      }
      __syncthreads();
      if (t < T2) {  // B' P B, Hux = B' P A (batch plan: A' P A)
        const bool u = t < T2U, x = !u && t < T2U + T2X;
        tile2x2(u || x ? Bk : Ak, u || x ? NU : NX, u ? sh.PB : sh.PA,
                u ? NU : NX, u || x ? NU : NX, u ? NU : NX,
                u ? t : x ? t - T2U : t - T2U - T2X,
                u ? sh.Huu : x ? sh.Hux : sh.APA);
      }
      __syncthreads();
      if (t < NU) {  // Huu row t: + R, and on the diagonal + reg + sig_u
        for (int j = 0; j < NU; ++j) {
          float v = sh.Huu[t * NU + j] + R[t * NU + j];
          if (j == t) {
            v = v + reg;
            v = v + wu_k;
          }
          sh.Huu[t * NU + j] = v;
        }
      }
      __syncwarp();
      if (warp == 0) {  // Hinv, then Z = Hinv' Hux
        float* Hk = Hw(k);
        float* Zk = Zw(k);
        chol_inverse_warp<NU>(sh.Huu, sh.L, sh.Li, Hk, lane);
        __syncwarp();
        constexpr int RZ = (NU * NX + 31) / 32;
        float acc[RZ];
        int zi[RZ], zj[RZ];
#pragma unroll
        for (int h = 0; h < RZ; ++h) {
          const int e = lane + 32 * h, ee = e < NU * NX ? e : 0;
          zi[h] = ee / NX;
          zj[h] = ee - zi[h] * NX;
          acc[h] = Hk[zi[h]] * sh.Hux[zj[h]];
        }
#pragma unroll
        for (int l = 1; l < NU; ++l) {
#pragma unroll
          for (int h = 0; h < RZ; ++h) {
            acc[h] += Hk[l * NU + zi[h]] * sh.Hux[l * NX + zj[h]];
          }
        }
#pragma unroll
        for (int h = 0; h < RZ; ++h) {
          const int e = lane + 32 * h;
          if (e < NU * NX) {
            Zk[e] = acc[h];
            if (!res) Zst[(size_t)k * NU * NX + e] = acc[h];
          }
        }
        if (!res) {
          for (int e = lane; e < NU * NU; e += 32) {
            Hst[(size_t)k * NU * NU + e] = Hk[e];
          }
        }
      } else if constexpr (SINGLE) {  // A' P A beside the Cholesky inverse
        // on the warps that share no SM sub-partition with warp 0 (warp w
        // issues on sub-partition w % 4)
        const int ta = (warp - 1 - warp / 4) * 32 + lane;
        if ((warp & 3) != 0 && ta < HX * HX) {
          tile2x2(Ak, NX, sh.PA, NX, NX, NX, ta, sh.APA);
        }
      }
      __syncthreads();
      {  // P_k = sym(Qs + A' P A - Hux' Z (+ diag sig_x))
        const float* Zk = Zw(k);
        float* Pk = Pw(k);
        float h1[PR], h2[PR];
#pragma unroll
        for (int h = 0; h < PR; ++h) {
          const int i = pi[h], j = pj[h];
          h1[h] = sh.Hux[i] * Zk[j];
          h2[h] = sh.Hux[j] * Zk[i];
        }
#pragma unroll
        for (int l = 1; l < NU; ++l) {
#pragma unroll
          for (int h = 0; h < PR; ++h) {
            const int i = pi[h], j = pj[h];
            h1[h] += sh.Hux[l * NX + i] * Zk[l * NX + j];
            h2[h] += sh.Hux[l * NX + j] * Zk[l * NX + i];
          }
        }
#pragma unroll
        for (int h = 0; h < PR; ++h) {
          if (t + h * THREADS < NPAIR) {
            const int i = pi[h], j = pj[h];
            const int eij = i * NX + j, eji = j * NX + i;
            float v1 = (Qs[eij] + sh.APA[eij]) - h1[h];
            float v2 = (Qs[eji] + sh.APA[eji]) - h2[h];
            if (k >= 1 && i == j) {
              v1 = v1 + wx_k;
              v2 = v2 + wx_k;
            }
            const float v = 0.5f * (v1 + v2);
            Pk[eij] = v;
            Pk[eji] = v;
            if (!res) {
              Pst[(size_t)k * NXX + eij] = v;
              Pst[(size_t)k * NXX + eji] = v;
            }
          }
        }
      }
      if (k > kb) ab_store(k - 1, pre);
      __syncthreads();
      after(k);
    }
  }

  // RHS gradients qr/rr with the barrier terms of the given targets
  __device__ void rhs_grads(bool cor) {
    if (t < NX && first_chunk()) {
      float a = Qs[t] * dx[0];
      for (int j = 1; j < NX; ++j) a += Qs[j * NX + t] * dx[j];
      qr[t] = a + q[t];
    }
    for_rows([&](int gb, int idx, int vi) {
      const float* V = gb ? du : dx;
      [[maybe_unused]] const float* DA = gb ? ddua : ddxa;
      const float v = V[vi];
      float bsum = 0.f;
      for (int g = gb; g < gb + 2; ++g) {
        float b;
        if constexpr (SOFT) {
          // the targets from the affine directions alphas(false) left in
          // W0..W3; this pass leaves Ts, Tt and w there for alphas(true)
          const int e = sent(g, idx);
          const bool soft = this->cls[e] == C_SOFT;
          float Ts = 0.f, Tt = 0.f;
          if (cor) {
            const float ds = sf(W0, e), dl = sf(W1, e);
            Ts = clipf(mu_t - ds * dl, 0.05f * mu_t, 20.f * mu_t);
            if (soft) {
              const float dt = sf(W2, e), dg = sf(W3, e);
              Tt = clipf(mu_t - dt * dg, 0.05f * mu_t, 20.f * mu_t);
            }
            sf(W0, e) = Ts;
            sf(W1, e) = Tt;
          }
          const float r = rs_soft(g, idx, e, soft, v), ss = sf(F_SS, e);
          b = clipf(Ts / s[g][idx], -SIGMA_MAX, SIGMA_MAX) + ss * r;
          if (soft) {
            const float w = soft_w(g, idx, e, r, Ts, Tt);
            b = b - (ss * w) / sf(F_DEN, e);
            sf(cor ? W2 : W0, e) = w;
          }
        } else {
          const float T = target(cor, g, idx, v, DA[vi]);
          const float sv = s[g][idx];
          b = clipf(T / sv, -SIGMA_MAX, SIGMA_MAX)
              + sig(g, idx) * rs(g, idx, v);
        }
        const float gvl = (-sgn(g) * mask(g, bnd[g][idx])) * b;
        bsum = (g == gb) ? gvl : bsum + gvl;
      }
      if (gb == 0) {
        const int k = idx / NX, i = idx - k * NX;
        const float* Qm = (k + 1 == N) ? Qt : Qs;
        const float* x = dx + (k + 1) * NX;
        float a = Qm[i] * x[0];
        for (int j = 1; j < NX; ++j) a += Qm[j * NX + i] * x[j];
        qr[vi] = (a + q[vi]) + bsum;
      } else {
        const int k = idx / NU, i = idx - k * NU;
        const float* u = du + k * NU;
        float a = R[i] * u[0];
        for (int j = 1; j < NU; ++j) a += R[j * NU + i] * u[j];
        rr[idx] = (a + r[idx]) + bsum;
      }
    });
    __syncthreads();
  }

  // backward + forward sweeps with the current factor -> (dX, dU), on
  // warp 0; the block meets it at one barrier
  __device__ void solve_rhs(float* dX, float* dU) {
    if constexpr (CLUSTER) {
      solve_rhs_cluster(dX, dU);
      return;
    }
    sweep_begin();
    if (warp == 0) {
      sweep_back(qr[N * NX + (lane < NX ? lane : 0)]);
    } else {
      produce<V_BACK>(N - 1, -1, N);
    }
    sweep_begin();  // kff is read by the forward sweep's producers
    if (warp == 0) {
      sweep_fwd(dX, dU, 0.f);
    } else {
      produce<V_FWD>(0, 1, N);
    }
    __syncthreads();
  }

  // The cluster plan's solve: each sweep a chunked scan on the chunks'
  // products of F, the backward one from p_N = qr_N (the last chunk's),
  // the forward one from dx_0 = 0 (the first chunk's).
  __device__ void solve_rhs_cluster(float* dX, float* dU) {
    const int ks = this->ks, ke = this->ke, n = ke - ks + 1;
    const int xi = lane < NX ? lane : 0;
    const bool first = first_chunk(), last = last_chunk();
    sweep_begin();  // (1) from the true boundary or from 0
    if (warp == 0) {
      const float p = sweep_back(last ? qr[N * NX + xi] : 0.f);
      if (lane < NX) this->vout[lane] = p;
    } else {
      produce<V_BACK>(ke, -1, n);
    }
    scan_boundaries(true, this->Mf);  // (2)
    if (!last) {  // (3) from the true boundary
      sweep_begin();
      if (warp == 0) {
        sweep_back(this->vin[xi]);
      } else {
        produce<V_BACK>(ke, -1, n);
      }
    }
    sweep_begin();  // kff is read by the forward sweep's producers
    if (warp == 0) {
      const float d = sweep_fwd(dX, dU, 0.f);
      if (lane < NX) this->vout[lane] = d;
    } else {
      produce<V_FWD>(ks, 1, n);
    }
    scan_boundaries(false, this->Mf);
    if (!first) {
      sweep_begin();
      if (warp == 0) {
        sweep_fwd(dX, dU, this->vin[xi]);
      } else {
        produce<V_FWD>(ks, 1, n);
      }
    }
    __syncthreads();
  }

  // kff_k = -Hinv_k' (rr_k + B_k' Pcp), p_k = qr_k + A_k' Pcp - Z_k' Gu,
  // Pcp = P_{k+1}' req_k + p_{k+1}: lane i < NX carries p_i, lane NX + t
  // forms Gu_t and kff_t. P_k' req_{k-1} is formed one stage ahead. Over
  // this block's stages from pv = p_{ktop()+1}; returns p_{kbase()}.
  __device__ float sweep_back(float pv) {
    const Ring rg = ring_view();
    const auto acquire = [&rg](int m) { return rg.acquire(m); };
    const auto release = [&rg](int m) { rg.release(m); };
    const int kb = kbase(), kh = ktop();
    float* const kff = this->kff;
    const float *const Pst = this->Pst, *const Zst = this->Zst,
                *const Hst = this->Hst;
    const bool xl = lane < NX, ul = lane >= NX && lane < NX + NU;
    const int xi = xl ? lane : 0, ui = ul ? lane - NX : 0;
    float preq;  // P_{k+1}' req_k, formed a stage ahead
    {
      const float* v = acquire(0) + NXX + NX * NU;
      const float* P1 = Pst + (size_t)(kh + 1 - kb) * NXX + xi;
      preq = P1[0] * v[0];
#pragma unroll
      for (int j = 1; j < NX; ++j) preq += P1[j * NX] * v[j];
    }
    for (int m = 0; m <= kh - kb; ++m) {
      const int k = kh - m;
      const float* Ak = acquire(m);
      const float* v = Ak + NXX + NX * NU;  // req_k, qr_k, rr_k
      const float pcp = preq + pv;
      float w[NX];
#pragma unroll
      for (int j = 0; j < NX; ++j) w[j] = __shfl_sync(FULL, pcp, j);
      if (k > kb) {  // the next stage's P_k' req_{k-1}, off the chain
        const float* Pk = Pst + (size_t)(k - kb) * NXX + xi;
        const float* vn = acquire(m + 1) + NXX + NX * NU;
        preq = Pk[0] * vn[0];
#pragma unroll
        for (int j = 1; j < NX; ++j) preq += Pk[j * NX] * vn[j];
      }
      // A_k' Pcp (state lanes), B_k' Pcp (control lanes)
      const float* col = xl ? Ak + xi : Ak + NXX + ui;
      const int ld = xl ? NX : NU;
      float g = col[0] * w[0];
#pragma unroll
      for (int j = 1; j < NX; ++j) g += col[j * ld] * w[j];
      const float gu = v[2 * NX + ui] + g;
      const float qrk = v[NX + xi];
      release(m);
      float u[NU];
#pragma unroll
      for (int j = 0; j < NU; ++j) u[j] = __shfl_sync(FULL, gu, NX + j);
      // Z_k' Gu (state lanes), Hinv_k' Gu (control lanes)
      const float* c2 = xl ? Zst + (size_t)(k - kb) * NU * NX + xi
                           : Hst + (size_t)(k - kb) * NU * NU + ui;
      const int l2 = xl ? NX : NU;
      float z = c2[0] * u[0];
#pragma unroll
      for (int j = 1; j < NU; ++j) z += c2[j * l2] * u[j];
      if (ul) kff[k * NU + ui] = -z;
      pv = (qrk + g) - z;
    }
    return pv;
  }

  // du_k = -Z_k d + kff_k (control lanes), dx_{k+1} = A_k d + B_k du_k +
  // req_k (state lanes), d = dx_k carried by lanes i < NX. Over this
  // block's stages from d = dx_{kbase()}; returns dx_{ktop()+1}, which a
  // chunk that is not the last leaves to the next.
  __device__ float sweep_fwd(float* dX, float* dU, float d) {
    const Ring rg = ring_view();
    const auto acquire = [&rg](int m) { return rg.acquire(m); };
    const auto release = [&rg](int m) { rg.release(m); };
    const int kb = kbase(), kh = ktop(), lane = this->lane;
    const bool store_last = last_chunk();
    const float* const Zst = this->Zst;
    const bool xl = lane < NX, ul = lane >= NX && lane < NX + NU;
    const int xi = xl ? lane : 0, ui = ul ? lane - NX : 0;
    if (xl) dX[kb * NX + lane] = d;
    for (int k = kb; k <= kh; ++k) {
      const float* Ak = acquire(k - kb);
      const float* v = Ak + NXX + NX * NU;  // req_k, kff_k
      float dv[NX];
#pragma unroll
      for (int j = 0; j < NX; ++j) dv[j] = __shfl_sync(FULL, d, j);
      const float* row = xl ? Ak + xi * NX
                            : Zst + (size_t)(k - kb) * NU * NX + ui * NX;
      float a = row[0] * dv[0];
#pragma unroll
      for (int j = 1; j < NX; ++j) a += row[j] * dv[j];
      const float dun = -a + v[NX + ui];
      if (ul) dU[k * NU + ui] = dun;
      float uv[NU];
#pragma unroll
      for (int j = 0; j < NU; ++j) uv[j] = __shfl_sync(FULL, dun, NX + j);
      const float* brow = Ak + NXX + xi * NU;
      float bb = brow[0] * uv[0];
#pragma unroll
      for (int j = 1; j < NU; ++j) bb += brow[j] * uv[j];
      const float reqk = v[xi];
      release(k - kb);
      d = (a + bb) + reqk;
      if (xl && (k < kh || store_last)) dX[(k + 1) * NX + lane] = d;
    }
    return d;
  }

  // Newton directions (ds, dl, dt, dg) of entry e for primal direction dd
  // under the targets (Ts, Tt) and the right-hand-side scalar w that
  // rhs_grads formed for them; dt = dg = 0 on a hard row (SOFT)
  __device__ void soft_dirs(int g, int idx, int e, bool soft, float v,
                            float dd, float Ts, float Tt, float w, float& ds,
                            float& dl, float& dt, float& dg) const {
    const float m = mask(g, bnd[g][idx]);
    const float sv = s[g][idx], lv = lam[g][idx];
    const float r = rs_soft(g, idx, e, soft, v);
    float dv = sgn(g) * dd;
    dt = 0.f;
    dg = 0.f;
    if (soft) {
      const float tt = sf(F_T, e), gg = sf(F_GAM, e);
      dt = (w - sf(F_SS, e) * dv) / sf(F_DEN, e);
      dg = clipf(((Tt - tt * gg) - gg * dt) / tt, -DUAL_CLIP, DUAL_CLIP);
      dv = dv + dt;
    }
    ds = m * (dv - r);
    dl = m * clipf((Ts - sv * lv - lv * ds) / sv, -DUAL_CLIP, DUAL_CLIP);
  }

  // fraction-to-boundary step lengths for directions (dX, dU); SOFT leaves
  // the directions in W0..W3
  __device__ void alphas(bool cor, float tau, const float* dX, const float* dU,
                         float& a_p, float& a_d) const {
    float ap = 1.f, ad = 1.f;
    for_rows([&](int gb, int idx, int vi) {
      const float v = (gb ? du : dx)[vi];
      const float d = (gb ? dU : dX)[vi];
      [[maybe_unused]] const float da = (gb ? ddua : ddxa)[vi];
      for (int g = gb; g < gb + 2; ++g) {
        float ds, dl;
        if constexpr (SOFT) {
          const int e = sent(g, idx);
          const bool soft = this->cls[e] == C_SOFT;
          float dt, dg;
          const float Ts = cor ? sf(W0, e) : 0.f;
          const float Tt = cor ? sf(W1, e) : 0.f;
          const float w = soft ? sf(cor ? W2 : W0, e) : 0.f;
          soft_dirs(g, idx, e, soft, v, d, Ts, Tt, w, ds, dl, dt, dg);
          if (soft) {
            ap = nmin(ap, ratio(sf(F_T, e), dt, tau));
            ad = nmin(ad, ratio(sf(F_GAM, e), dg, tau));
          }
          sf(W0, e) = ds;
          sf(W1, e) = dl;
          sf(W2, e) = dt;
          sf(W3, e) = dg;
        } else {
          dirs(g, idx, v, d, target(cor, g, idx, v, da), ds, dl);
        }
        ap = nmin(ap, ratio(s[g][idx], ds, tau));
        ad = nmin(ad, ratio(lam[g][idx], dl, tau));
      }
    });
    if constexpr (CLUSTER) {
      float v[2] = {block_reduce<WARPS>(ap, sh.red, OpMin()),
                    block_reduce<WARPS>(ad, sh.red, OpMin())};
      cluster_combine(v, OpMin());
      a_p = nmin(v[0], 1.f);
      a_d = nmin(v[1], 1.f);
      return;
    }
    a_p = nmin(block_reduce<WARPS>(ap, sh.red, OpMin()), 1.f);
    a_d = nmin(block_reduce<WARPS>(ad, sh.red, OpMin()), 1.f);
  }

  // complementarity after the affine step (sum over bounds)
  __device__ float mu_aff_sum(float ap, float ad) const {
    return rows_sum([&](float& acc, int gb, int idx, int vi) {
      [[maybe_unused]] const float v = (gb ? du : dx)[vi];
      [[maybe_unused]] const float da = (gb ? ddua : ddxa)[vi];
      for (int g = gb; g < gb + 2; ++g) {
        if constexpr (SOFT) {
          // the affine directions alphas(false) left in W0..W3
          const int e = sent(g, idx);
          const unsigned char c = this->cls[e];
          const float ds = sf(W0, e), dl = sf(W1, e);
          if (c == C_SOFT) {
            acc += (sf(F_T, e) + ap * sf(W2, e))
                   * (sf(F_GAM, e) + ad * sf(W3, e));
          }
          acc += (c != C_INF ? 1.f : 0.f) * (s[g][idx] + ap * ds)
                 * (lam[g][idx] + ad * dl);
        } else {
          float ds, dl;
          dirs(g, idx, v, da, 0.f, ds, dl);
          acc += mask(g, bnd[g][idx]) * (s[g][idx] + ap * ds)
                 * (lam[g][idx] + ad * dl);
        }
      }
    });
  }

  // corrector step of the iterate (stage-0 state pinned)
  __device__ void update(float ap, float ad) {
    for_rows([&](int gb, int idx, int vi) {
      float* V = gb ? du : dx;
      const float d = (gb ? ddu : ddx)[vi];
      [[maybe_unused]] const float da = (gb ? ddua : ddxa)[vi];
      const float v = V[vi];
      float ds[2], dl[2];
      if constexpr (!SOFT) {
        for (int h = 0; h < 2; ++h) {
          const int g = gb + h;
          dirs(g, idx, v, d, target(true, g, idx, v, da), ds[h], dl[h]);
        }
      }
      for (int h = 0; h < 2; ++h) {
        const int g = gb + h;
        if constexpr (SOFT) {
          // the corrector's directions alphas(true) left in W0..W3
          const int e = sent(g, idx);
          ds[h] = sf(W0, e);
          dl[h] = sf(W1, e);
          if (this->cls[e] == C_SOFT) {
            sf(F_T, e) = nmax(sf(F_T, e) + ap * sf(W2, e), EPS_S);
            sf(F_GAM, e) = clipf(sf(F_GAM, e) + ad * sf(W3, e), 0.f, LAM_MAX);
          }
        }
        s[g][idx] = nmax(s[g][idx] + ap * ds[h], EPS_S);
        lam[g][idx] = clipf(lam[g][idx] + ad * dl[h], 0.f, LAM_MAX);
      }
      V[vi] = v + ap * d;
    });
    __syncthreads();
  }

  // (the cluster plan: this CTA's states and controls)
  __device__ void copy(float* dst_x, const float* src_x, float* dst_u,
                       const float* src_u) {
    if constexpr (CLUSTER) {
      const int x1 = (last_chunk() ? N + 1 : this->ke + 1) * NX;
      for (int e = this->ks * NX + t; e < x1; e += THREADS) {
        dst_x[e] = src_x[e];
      }
      for (int e = this->ur0 + t; e < this->ur1; e += THREADS) {
        dst_u[e] = src_u[e];
      }
      __syncthreads();
      return;
    }
    for (int e = t; e < (N + 1) * NX; e += THREADS) dst_x[e] = src_x[e];
    for (int e = t; e < N * NU; e += THREADS) dst_u[e] = src_u[e];
    __syncthreads();
  }

  __device__ void run(int iters, float alpha_frac, const Model& md) {
    if constexpr (MODE == FUSE_LIN) linearize(md);
    if constexpr (MODE != PLAIN) cost_fill();
    init();
    float st, eq;
    kkt(st, eq);
    copy(dxb, dx, dub, du);
    float best = merit(st, eq);
    for (int it = 0; it < iters; ++it) {
      const float mu_cur = comp_sum() / n_ineq;
      factorize();
      // predictor (affine scaling, target 0)
      rhs_grads(false);
      solve_rhs(ddxa, ddua);
      float ap, ad;
      alphas(false, 1.f, ddxa, ddua, ap, ad);
      const float mu_aff = mu_aff_sum(ap, ad) / n_ineq;
      const float ratio_ = mu_aff / nmax(mu_cur, MU_MIN);
      const float sigma = clipf(ratio_ * ratio_ * ratio_, 0.f, 1.f);
      mu_t = nmax(sigma * mu_cur, MU_MIN);
      // corrector
      rhs_grads(true);
      solve_rhs(ddx, ddu);
      alphas(true, alpha_frac, ddx, ddu, ap, ad);
      update(ap, ad);
      kkt(st, eq);
      const float m = merit(st, eq);
      if (m < best) {  // uniform across the block
        copy(dxb, dx, dub, du);
        best = m;
      }
    }
    // final diagnostics on the returned (best) iterate, last-iterate duals
    copy(dx, dxb, du, dub);
    kkt(st, eq);
    st = isfinite(st) ? nmin(st, best) : best;
    float sx = 0.f, su = 0.f, vio = 0.f;
    if constexpr (MODE == FUSE_COST) finish(sx, su, vio);
    if (t == 0 && first_chunk()) {
      diag[0] = st;
      diag[1] = eq;
      diag[2] = best;
      diag[3] = sx;
      diag[4] = su;
      diag[5] = vio;
    }
    // no CTA leaves while another may still read its shared memory
    if constexpr (CLUSTER) cluster_sync();
  }
};

// The solve: one block of THREADS threads per problem (the batch plan:
// two blocks per SM; the single plan: one problem, one block), or with
// CLUSTER one problem per cluster, a chunk of its stages per block.
template <int MODE, bool SOFT, int NX, int NU, int FAM, int THREADS,
          bool CLUSTER = false>
__global__ void __launch_bounds__(THREADS, THREADS == BATCH_THREADS ? 2 : 1)
box_qp_ipm_kernel(Inputs in, Outputs out, Model md, int N, int iters,
                  float mu0, float alpha_frac, float reg) {
  if (in.skip != nullptr && *in.skip) return;  // uniform across the grid
  extern __shared__ float4 smem4[];
  Solver<MODE, SOFT, NX, NU, FAM, THREADS, CLUSTER> solver(
      in, out, reinterpret_cast<float*>(smem4), N, mu0, reg,
      CLUSTER ? 0 : (int)blockIdx.x);
  solver.run(iters, alpha_frac, md);
}

// The single plan's FUSE_LIN prologue (B=1): lin_items(N) items, one a
// thread, into the problem's record (the caller's `lin`, else its place in
// the workspace) by the batch plan's Solver of the instantiation, before
// the solve on the same stream. The skip flag returns every block before
// it writes anything.
template <int NX, int NU, int FAM, bool SOFT>
__global__ void __launch_bounds__(LIN_THREADS)
box_qp_ipm_prologue(Inputs in, Outputs out, Model md, int N) {
  if (in.skip != nullptr && *in.skip) return;  // uniform across the grid
  const int e = blockIdx.x * LIN_THREADS + threadIdx.x;
  if (e >= lin_items<NX, NU>(N)) return;
  float none[1];  // no shared memory: linearize_items reads none
  Solver<FUSE_LIN, SOFT, NX, NU, FAM, BATCH_THREADS> solver(in, out, none, N,
                                                           0.f, 0.f, 0);
  solver.linearize_items(md, e, lin_items<NX, NU>(N));
}

// The warm-start arguments every entry takes (wvalid null = cold solve).
void set_warm(Inputs& in, const float* wvalid, const float* wslx,
              const float* wsux, const float* wllx, const float* wlux,
              const float* wslu, const float* wsuu, const float* wllu,
              const float* wluu, const unsigned char* skip) {
  in.wvalid = wvalid;
  in.ws[0] = wslx;
  in.ws[1] = wsux;
  in.ws[2] = wslu;
  in.ws[3] = wsuu;
  in.wl[0] = wllx;
  in.wl[1] = wlux;
  in.wl[2] = wllu;
  in.wl[3] = wluu;
  in.skip = skip;
}

// The soft penalty arguments of the plain and fuse_lin entries (Zlx null =
// a hard solve).
void set_soft(Inputs& in, const float* Zlx, const float* zlx,
              const float* Zux, const float* zux, const float* Zlu,
              const float* zlu, const float* Zuu, const float* zuu) {
  in.Zp[0] = Zlx;
  in.zp[0] = zlx;
  in.Zp[1] = Zux;
  in.zp[1] = zux;
  in.Zp[2] = Zlu;
  in.zp[2] = zlu;
  in.Zp[3] = Zuu;
  in.zp[3] = zuu;
}

template <int MODE, bool SOFT, int NX, int NU, int FAM = BLASTER>
int launch(const Inputs& in, const Outputs& out, const Model& md, int B,
           int N, int iters, float mu0, float alpha_frac, float reg,
           void* stream) {
  const bool prologue_only = MODE == FUSE_LIN && iters == PROLOGUE_ONLY &&
                             single_plan(MODE, B);
  if (B <= 0 || N <= 0 || (iters < 0 && !prologue_only)) {
    return (int)cudaErrorInvalidValue;
  }
  if (SOFT && in.wvalid != nullptr) {
    return (int)cudaErrorInvalidValue;  // soft takes no warm start
  }
  if (in.wvalid != nullptr) {
    for (int g = 0; g < 4; ++g) {
      if (in.ws[g] == nullptr || in.wl[g] == nullptr) {
        return (int)cudaErrorInvalidValue;
      }
    }
  }
  if (SOFT) {
    for (int g = 0; g < 4; ++g) {
      if (in.Zp[g] == nullptr || in.zp[g] == nullptr) {
        return (int)cudaErrorInvalidValue;
      }
    }
  }
  const size_t smem = plan_bytes<NX, NU>(N, SOFT);
  if (smem > (size_t)SMEM_OPTIN) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if constexpr (MODE == PLAIN && !SOFT) {
    if (cluster_plan(MODE, SOFT, B, N)) {  // one cluster, a chunk per CTA
      const size_t cb = cluster_bytes<NX, NU>(N);
      if (cb > (size_t)SMEM_OPTIN) return (int)cudaErrorInvalidValue;
      cudaLaunchConfig_t cfg = {};
      cudaLaunchAttribute attr[1];
      attr[0].id = cudaLaunchAttributeClusterDimension;
      attr[0].val.clusterDim.x = (unsigned)cluster_ctas(N);
      attr[0].val.clusterDim.y = 1;
      attr[0].val.clusterDim.z = 1;
      cfg.gridDim.x = (unsigned)cluster_ctas(N);
      cfg.gridDim.y = 1;
      cfg.gridDim.z = 1;
      cfg.blockDim.x = SINGLE_THREADS;
      cfg.blockDim.y = 1;
      cfg.blockDim.z = 1;
      cfg.dynamicSmemBytes = cb;
      cfg.stream = st;
      cfg.attrs = attr;
      cfg.numAttrs = 1;
      const cudaError_t e = cudaLaunchKernelEx(
          &cfg, box_qp_ipm_kernel<MODE, SOFT, NX, NU, FAM, SINGLE_THREADS, true>,
          in, out, md, N, iters, mu0, alpha_frac, reg);
      if (e != cudaSuccess) {
        cudaGetLastError();  // refused: clear it for the next launch
        return (int)e;
      }
      return (int)cudaGetLastError();
    }
  }
  if constexpr (MODE != FUSE_COST) {
    if (single_plan(MODE, B)) {
      if constexpr (MODE == FUSE_LIN) {
        const int pb = lin_blocks<NX, NU>(N);
        box_qp_ipm_prologue<NX, NU, FAM, SOFT>
            <<<pb, LIN_THREADS, 0, st>>>(in, out, md, N);
        const cudaError_t e = cudaGetLastError();
        if (e != cudaSuccess || prologue_only) return (int)e;
      }
      box_qp_ipm_kernel<MODE, SOFT, NX, NU, FAM, SINGLE_THREADS>
          <<<B, SINGLE_THREADS, smem, st>>>(in, out, md, N, iters, mu0,
                                            alpha_frac, reg);
      return (int)cudaGetLastError();
    }
  }
  box_qp_ipm_kernel<MODE, SOFT, NX, NU, FAM, BATCH_THREADS>
      <<<B, BATCH_THREADS, smem, st>>>(in, out, md, N, iters, mu0,
                                       alpha_frac, reg);
  return (int)cudaGetLastError();
}

// The model dimensions the entries take: BLASTER's 17x6 or QUAD13's 13x4.
bool is_17x6(int nx, int nu) { return nx == 17 && nu == 6; }
bool is_13x4(int nx, int nu) { return nx == 13 && nu == 4; }

// Calls f.run<MODE, SOFT, NX, NU, FAM>() for a built instantiation, else
// returns cudaErrorInvalidValue (family is read in FUSE_LIN only).
template <class F>
int with_instance(int mode, bool soft, int nx, int nu, int family,
                  const F& f) {
  if (is_17x6(nx, nu)) {
    if (mode == PLAIN) {
      return soft ? f.template run<PLAIN, true, 17, 6, BLASTER>()
                  : f.template run<PLAIN, false, 17, 6, BLASTER>();
    }
    if (mode == FUSE_LIN && family == BLASTER) {
      return soft ? f.template run<FUSE_LIN, true, 17, 6, BLASTER>()
                  : f.template run<FUSE_LIN, false, 17, 6, BLASTER>();
    }
#ifndef BOX_QP_IPM_CPU_SUBSET
    if (mode == FUSE_COST && !soft) {
      return f.template run<FUSE_COST, false, 17, 6, BLASTER>();
    }
    if (mode == FUSE_LIN && family == BLASTER_DIST && !soft) {
      return f.template run<FUSE_LIN, false, 17, 6, BLASTER_DIST>();
    }
#endif
  }
#ifndef BOX_QP_IPM_CPU_SUBSET
  if (is_13x4(nx, nu) && !soft) {
    if (mode == PLAIN) return f.template run<PLAIN, false, 13, 4, BLASTER>();
    if (mode == FUSE_LIN && family == QUAD13) {
      return f.template run<FUSE_LIN, false, 13, 4, QUAD13>();
    }
  }
#endif
  return (int)cudaErrorInvalidValue;
}

// The solve kernel of a plan: the batch plan's, the single plan's where
// the mode builds one (not FUSE_COST), or the cluster plan's (hard PLAIN).
template <int MODE, bool SOFT, int NX, int NU, int FAM>
const void* plan_kernel(bool single, bool cluster = false) {
  if constexpr (MODE == PLAIN && !SOFT) {
    if (cluster) {
      return (const void*)
          box_qp_ipm_kernel<MODE, SOFT, NX, NU, FAM, SINGLE_THREADS, true>;
    }
  }
  if constexpr (MODE != FUSE_COST) {
    if (single) {
      return (const void*)
          box_qp_ipm_kernel<MODE, SOFT, NX, NU, FAM, SINGLE_THREADS>;
    }
  }
  return (const void*)box_qp_ipm_kernel<MODE, SOFT, NX, NU, FAM,
                                        BATCH_THREADS>;
}

// Opts an instantiation's solve kernels (every plan) in to SMEM_OPTIN
// bytes of dynamic shared memory and prefers the largest shared-memory
// carveout (so that two resident blocks share an SM). The cluster plan
// launches at most the portable 8 CTAs. A refused attribute also sets the
// runtime's last error: it is cleared, and the error returned.
struct SetOptin {
  template <int MODE, bool SOFT, int NX, int NU, int FAM>
  int run() const {
    cudaError_t e = cudaSuccess;
    for (int plan = 0; plan < 3 && e == cudaSuccess; ++plan) {
      if (plan == 1 && MODE == FUSE_COST) break;
      if (plan == 2 && (MODE != PLAIN || SOFT)) break;
      const void* k = plan_kernel<MODE, SOFT, NX, NU, FAM>(plan == 1,
                                                          plan == 2);
      e = cudaFuncSetAttribute(
          k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_OPTIN);
      if (e == cudaSuccess) {
        e = cudaFuncSetAttribute(
            k, cudaFuncAttributePreferredSharedMemoryCarveout,
            (int)cudaSharedmemCarveoutMaxShared);
      }
    }
    if (e != cudaSuccess) cudaGetLastError();
    return (int)e;
  }
};

// The compiled solve kernel of the plan for a batch of B: its registers per
// thread and local (stack) bytes, and the blocks of it one SM holds at
// `smem` bytes of dynamic shared memory.
struct Attrs {
  long long smem;
  int B, N;
  int *regs, *local_bytes, *blocks_per_sm;
  template <int MODE, bool SOFT, int NX, int NU, int FAM>
  int run() const {
    const bool single = single_plan(MODE, B);
    const void* k = plan_kernel<MODE, SOFT, NX, NU, FAM>(
        single, cluster_plan(MODE, SOFT, B, N));
    cudaFuncAttributes a;
    cudaError_t e = cudaFuncGetAttributes(&a, k);
    if (e == cudaSuccess) {
      *regs = a.numRegs;
      *local_bytes = (int)a.localSizeBytes;
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          blocks_per_sm, k, single ? SINGLE_THREADS : BATCH_THREADS,
          (size_t)smem);
    }
    if (e != cudaSuccess) cudaGetLastError();
    return (int)e;
  }
};

// The clusters of the cluster plan's kernel at horizon N the card can hold
// at once (cudaOccupancyMaxActiveClusters at the plan's CTAs, threads and
// shared bytes); 0 where the plan is not a cluster.
struct MaxClusters {
  int N;
  int* n;
  template <int MODE, bool SOFT, int NX, int NU, int FAM>
  int run() const {
    *n = 0;
    if (!cluster_plan(MODE, SOFT, 1, N)) return 0;
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = (unsigned)cluster_ctas(N);
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.gridDim.x = (unsigned)cluster_ctas(N);
    cfg.gridDim.y = 1;
    cfg.gridDim.z = 1;
    cfg.blockDim.x = SINGLE_THREADS;
    cfg.blockDim.y = 1;
    cfg.blockDim.z = 1;
    cfg.dynamicSmemBytes = cluster_bytes<NX, NU>(N);
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t e = cudaOccupancyMaxActiveClusters(
        n, plan_kernel<MODE, SOFT, NX, NU, FAM>(true, true), &cfg);
    if (e != cudaSuccess) cudaGetLastError();
    return (int)e;
  }
};

}  // namespace

extern "C" long long box_qp_ipm_workspace_floats(int N, int mode, int soft,
                                                int nx, int nu) {
  if (is_17x6(nx, nu)) return (long long)workspace_floats<17, 6>(N, mode, soft);
  if (is_13x4(nx, nu)) return (long long)workspace_floats<13, 4>(N, mode, soft);
  return -1;
}

extern "C" long long box_qp_ipm_lin_floats(int N, int nx, int nu) {
  if (is_17x6(nx, nu)) return (long long)lin_floats<17, 6>(N);
  if (is_13x4(nx, nu)) return (long long)lin_floats<13, 4>(N);
  return -1;
}

// The plan of a launch of B problems: threads per block (the single plan
// for B=1 outside FUSE_COST, else the batch plan), dynamic shared bytes
// and whether the factor stacks are resident in shared memory (the same in
// both plans; soft bounds add the soft area where it fits), the blocks
// of the FUSE_LIN prologue's own grid (0: it runs on the solve's block),
// and the cluster plan's CTAs (0: not a cluster), whose shared bytes are
// per CTA and whose stacks are resident, a chunk per CTA.
extern "C" int box_qp_ipm_plan(int N, int mode, int soft, int nx, int nu,
                               int B, int* threads, long long* smem,
                               int* res, int* prologue_blocks, int* cluster) {
  if (N <= 0 || B <= 0) return (int)cudaErrorInvalidValue;
  const bool single = single_plan(mode, B);
  const bool cl = cluster_plan(mode, soft != 0, B, N);
  *cluster = cl ? cluster_ctas(N) : 0;
  if (is_17x6(nx, nu)) {
    *smem = (long long)plan_bytes<17, 6>(N, soft != 0);
    *res = resident<17, 6>(N);
    *prologue_blocks = single && mode == FUSE_LIN ? lin_blocks<17, 6>(N) : 0;
  } else if (is_13x4(nx, nu)) {
    *smem = (long long)plan_bytes<13, 4>(N, soft != 0);
    *res = resident<13, 4>(N);
    *prologue_blocks = single && mode == FUSE_LIN ? lin_blocks<13, 4>(N) : 0;
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (cl) {
    *smem = (long long)(is_17x6(nx, nu) ? cluster_bytes<17, 6>(N)
                                         : cluster_bytes<13, 4>(N));
    *res = 1;
  }
  *threads = single ? SINGLE_THREADS : BATCH_THREADS;
  return 0;
}

extern "C" long long box_qp_ipm_smem_optin() { return SMEM_OPTIN; }

extern "C" int box_qp_ipm_set_optin(int mode, int soft, int nx, int nu,
                                    int family) {
  return with_instance(mode, soft != 0, nx, nu, family, SetOptin{});
}

extern "C" int box_qp_ipm_kernel_attrs(int mode, int soft, int nx, int nu,
                                       int family, long long smem, int B,
                                       int N, int* regs, int* local_bytes,
                                       int* blocks_per_sm) {
  return with_instance(mode, soft != 0, nx, nu, family,
                       Attrs{smem, B, N, regs, local_bytes, blocks_per_sm});
}

// The cluster plan's clusters the card holds at once at horizon N (0 where
// the launch is not a cluster, B=1): a wrapper refuses the plan below 1.
extern "C" int box_qp_ipm_max_clusters(int mode, int soft, int nx, int nu,
                                       int family, int N, int* n) {
  return with_instance(mode, soft != 0, nx, nu, family, MaxClusters{N, n});
}

extern "C" const char* box_qp_ipm_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// PLAIN: one launch solves the whole batch: grid = B blocks of the plan's
// threads. Non-null penalty rows (Zlx ...) select the soft instantiation
// (17x6 only).
extern "C" int box_qp_ipm_solve(
    const float* A, const float* Bm, const float* c, const float* Qs,
    const float* Qt, const float* q, const float* R, const float* r,
    const float* lbx, const float* ubx, const float* lbu, const float* ubu,
    const float* dx0,
    float* dx, float* du, float* diag,
    float* slx, float* sux, float* llx, float* lux,
    float* slu, float* suu, float* llu, float* luu,
    float* work, const float* wvalid, const float* wslx, const float* wsux,
    const float* wllx, const float* wlux, const float* wslu,
    const float* wsuu, const float* wllu, const float* wluu,
    const unsigned char* skip, const float* Zlx, const float* zlx,
    const float* Zux, const float* zux, const float* Zlu, const float* zlu,
    const float* Zuu, const float* zuu, int B, int N, int nx, int nu,
    int iters, float mu0, float alpha_frac, float reg, void* stream) {
  Inputs in{A, Bm, c, Qs, Qt, q, R, r, lbx, ubx, lbu, ubu, dx0};
  set_warm(in, wvalid, wslx, wsux, wllx, wlux, wslu, wsuu, wllu, wluu, skip);
  set_soft(in, Zlx, zlx, Zux, zux, Zlu, zlu, Zuu, zuu);
  Outputs out{dx, du, diag, {slx, sux, slu, suu}, {llx, lux, llu, luu}, work};
  const bool soft = Zlx != nullptr;
  if (is_17x6(nx, nu)) {
    if (soft) {
      return launch<PLAIN, true, 17, 6>(in, out, Model{}, B, N, iters, mu0,
                                        alpha_frac, reg, stream);
    }
    return launch<PLAIN, false, 17, 6>(in, out, Model{}, B, N, iters, mu0,
                                       alpha_frac, reg, stream);
  }
#ifndef BOX_QP_IPM_CPU_SUBSET
  if (is_13x4(nx, nu) && !soft) {
    return launch<PLAIN, false, 13, 4>(in, out, Model{}, B, N, iters, mu0,
                                       alpha_frac, reg, stream);
  }
#endif
  return (int)cudaErrorInvalidValue;
}

// FUSE_COST (the batched fused tick, 17x6): xnew/unew receive the updated
// absolute iterate, diag rows 3-5 the step norms and the box violation.
extern "C" int box_qp_ipm_fused_cost(
    const float* A, const float* Bm, const float* c,
    const float* xbar, const float* ubar, const float* x0,
    const float* Qs, const float* Qt, const float* R, const float* Rg,
    const float* yrx, const float* yru, const float* yre,
    const float* lbx, const float* ubx, const float* lbu, const float* ubu,
    float* xnew, float* unew, float* diag,
    float* slx, float* sux, float* llx, float* lux,
    float* slu, float* suu, float* llu, float* luu,
    float* work, const float* wvalid, const float* wslx, const float* wsux,
    const float* wllx, const float* wlux, const float* wslu,
    const float* wsuu, const float* wllu, const float* wluu,
    const unsigned char* skip, int B, int N, int nx, int nu, int iters,
    float mu0, float alpha_frac, float reg, void* stream) {
#ifdef BOX_QP_IPM_CPU_SUBSET
  return (int)cudaErrorInvalidValue;
#else
  if (!is_17x6(nx, nu)) return (int)cudaErrorInvalidValue;
  Inputs in{};
  set_warm(in, wvalid, wslx, wsux, wllx, wlux, wslu, wsuu, wllu, wluu, skip);
  in.A = A;
  in.Bm = Bm;
  in.c = c;
  in.Qs = Qs;
  in.Qt = Qt;
  in.R = R;
  in.xbar = xbar;
  in.ubar = ubar;
  in.x0 = x0;
  in.Rg = Rg;
  in.yrx = yrx;
  in.yru = yru;
  in.yre = yre;
  in.box[0] = lbx;
  in.box[1] = ubx;
  in.box[2] = lbu;
  in.box[3] = ubu;
  Outputs out{xnew, unew, diag, {slx, sux, slu, suu}, {llx, lux, llu, luu},
              work};
  return launch<FUSE_COST, false, 17, 6>(in, out, Model{}, B, N, iters, mu0,
                                         alpha_frac, reg, stream);
#endif
}

// FUSE_LIN (the one-launch RTI tick): dx/du receive deltas; `lin`, when not
// null, receives the A, B and c the prologue built (B, lin_floats(N)).
// iters = PROLOGUE_ONLY at B=1 launches the prologue grid alone.
// `family` picks the ODE and with it the dimensions: BLASTER (17x6, np >=
// 25, hard or soft), BLASTER_DIST (17x6, np >= 31, hard) or QUAD13 (13x4,
// hard). Non-null penalty rows (Zlx ...) select the soft instantiation.
extern "C" int box_qp_ipm_fused_lin(
    const float* xbar, const float* ubar, const float* sp, const float* x0,
    const float* Qs, const float* Qt, const float* R, const float* Rg,
    const float* yrx, const float* yru, const float* yre,
    const float* lbx, const float* ubx, const float* lbu, const float* ubu,
    float* dx, float* du, float* diag,
    float* slx, float* sux, float* llx, float* lux,
    float* slu, float* suu, float* llu, float* luu,
    float* lin, float* work, const float* wvalid, const float* wslx,
    const float* wsux, const float* wllx, const float* wlux,
    const float* wslu, const float* wsuu, const float* wllu,
    const float* wluu, const unsigned char* skip, const float* Zlx,
    const float* zlx, const float* Zux, const float* zux, const float* Zlu,
    const float* zlu, const float* Zuu, const float* zuu, int B, int N,
    int np, int family,
    int iters, float mu0, float alpha_frac, float reg, float inv_m, float g,
    float lx, float ly, float cy, float j1, float j2, float j3, float h,
    float h2, float h6, int nsteps, void* stream) {
  const bool soft = Zlx != nullptr;
  const int np_min = family == BLASTER ? 25 : family == BLASTER_DIST ? 31 : 1;
  if (np < np_min || nsteps < 1) return (int)cudaErrorInvalidValue;
  Inputs in{};
  set_warm(in, wvalid, wslx, wsux, wllx, wlux, wslu, wsuu, wllu, wluu, skip);
  in.Qs = Qs;
  in.Qt = Qt;
  in.R = R;
  in.xbar = xbar;
  in.ubar = ubar;
  in.x0 = x0;
  in.Rg = Rg;
  in.yrx = yrx;
  in.yru = yru;
  in.yre = yre;
  in.box[0] = lbx;
  in.box[1] = ubx;
  in.box[2] = lbu;
  in.box[3] = ubu;
  in.sp = sp;
  in.np = np;
  set_soft(in, Zlx, zlx, Zux, zux, Zlu, zlu, Zuu, zuu);
  Outputs out{dx, du, diag, {slx, sux, slu, suu}, {llx, lux, llu, luu},
              work, lin};
  const Model md{inv_m, g, lx, ly, cy, j1, j2, j3, h, h2, h6, nsteps};
  if (family == BLASTER && soft) {
    return launch<FUSE_LIN, true, 17, 6>(in, out, md, B, N, iters, mu0,
                                         alpha_frac, reg, stream);
  }
  if (family == BLASTER) {
    return launch<FUSE_LIN, false, 17, 6>(in, out, md, B, N, iters, mu0,
                                          alpha_frac, reg, stream);
  }
#ifndef BOX_QP_IPM_CPU_SUBSET
  if (family == BLASTER_DIST && !soft) {
    return launch<FUSE_LIN, false, 17, 6, BLASTER_DIST>(
        in, out, md, B, N, iters, mu0, alpha_frac, reg, stream);
  }
  if (family == QUAD13 && !soft) {
    return launch<FUSE_LIN, false, 13, 4, QUAD13>(
        in, out, md, B, N, iters, mu0, alpha_frac, reg, stream);
  }
#endif
  return (int)cudaErrorInvalidValue;
}
