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
// optional device flag `skip` makes every block return at once: the
// divergence watchdog enqueues its cold redo every tick and lets the
// device decide whether it runs (sqp/rti.py::rti_step_warm_guarded).
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
// multiplied by a 0/1 mask. Soft and warm starts do not combine (null
// warm pointers when the penalty pointers are set).
//
// The plain PyTorch twins are ops/box_qp_ipm.py::box_qp_solve_plain,
// batched_fused_tick_plain and fused_rti_solve_plain (the prologue's twin is
// dynamics/fastlin.py::fast_linearize); each follows the same operation
// order.
//
// What bounds it on this card: the solve is a chain of O(N * iters) small
// dependent steps (17x17 products, a 6x6 factorization; 13x13 and 4x4 for
// QUAD13) -- per problem it is
// latency-bound, not FLOP- or byte-bound (N=60, 12 iterations is ~60 MFLOP
// and ~0.3 MB of per-problem state). The Pallas kernel answered that with a
// batch-on-lanes layout; a warp-wide lane layout would run a B=1 closed-loop
// solve on one thread. The design here instead gives each problem one thread
// block: the threads share a stage's products (up to 289 outputs), one
// thread runs the 6x6 equilibrated Cholesky inverse, block reductions carry
// the per-problem min/sum/max, and the stage stacks live in a problem-major
// global workspace (a problem's A/B record, P stack, Z, Hinv and vectors reach
// ~230 KB at N=60, more than one block's 227 KB of shared memory). A batch of
// B problems is B blocks, spread over the 132 SMs. The fused modes' assembly
// is elementwise over the block's threads; the FUSE_LIN prologue gives each
// thread one (node, tangent column) pair (N * (NX + NU) pairs: 23 per node
// for BLASTER, 17 for QUAD13), so it needs no jvp and no cross-thread
// traffic. Shared-memory staging, warp-level factorization and
// tensor-core products are later work.
//
// The long-horizon variants of the Pallas kernel (stream_p / stream_big,
// pallas_ipm.py:293-393, kernel K7) stream P, the A/B record and the Z
// gains between HBM and VMEM once an instance outgrows the TPU's resident
// budget. Here every stage stack already lives in the global workspace,
// indexed with size_t, and the shared memory does not grow with N, so the
// one layout above serves every horizon: K7 has no code of its own (the
// wrappers accept the streaming flags and ignore them).
//
// Interface: plain C (loaded with ctypes), float32, contiguous problem-major
// tensors; launches on the caller's stream and returns cudaGetLastError().
// Build without --use_fast_math: the guards rely on IEEE division, square
// root, sin/cos/tan and NaN behaviour.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

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

// Per-problem reduction across the block; every thread gets the result.
template <class Op>
__device__ float block_reduce(float v, float* red, Op op) {
  for (int o = 16; o > 0; o >>= 1) {
    v = op(v, __shfl_xor_sync(0xffffffffu, v, o));
  }
  __syncthreads();  // earlier readers of red are done
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float out = red[0];
  for (int w = 1; w < WARPS; ++w) out = op(out, red[w]);
  return out;
}

// Floats of the FUSE_LIN prologue's record per problem: A (N, NX, NX),
// B (N, NX, NU), c (N, NX).
template <int NX, int NU>
__host__ __device__ size_t lin_floats(int N) {
  return (size_t)N * (NX * NX + NX * NU + NX);
}

template <int NX, int NU>
__host__ __device__ size_t workspace_floats(int N, int mode, bool soft) {
  constexpr int NXX = NX * NX;
  const size_t n = N, n1 = N + 1;
  size_t w = n1 * (NXX + 4 * NX)                  // P, dx, ddx, ddxa, qr
             + n * (NU * NX + NU * NU + 5 * NU + NX);  // Z, Hinv, kff, du,
                                                       // ddu, ddua, rr, req
  if (mode != PLAIN) w += n1 * NX + 2 * n * NX + 3 * n * NU;  // q, r, bounds
  if (mode == FUSE_LIN) w += lin_floats<NX, NU>(N);
  if (soft) w += 4 * n * (NX + NU);  // t, gam of the four groups
  return w;
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

template <int NX, int NU>
struct Shared {
  static constexpr int NXX = NX * NX;
  float Pn[NXX];   // P_{k+1}: the factorization's carry
  float PA[NXX];
  float Pt[NXX];
  float PB[NX * NU];
  float Huu[NU * NU];
  float Hux[NU * NX];
  float Hi[NU * NU];
  float Zk[NU * NX];
  float vx[2][NX];  // ping-pong carry of the backward sweeps
  float wx[NX];
  float wu[NU];
  float red[WARPS];
};

// Fail-safe, Jacobi-equilibrated inverse of the SPD NU x NU Huu (one
// thread; 6x6 for BLASTER, 4x4 for QUAD13). Returns the zero matrix when a
// diagonal entry is <= 0 or the minimum Cholesky pivot is <= 1e-10: the
// stage's gain collapses to 0 instead of blowing the recursion up to
// inf/NaN.
template <int NU>
__device__ void chol_inverse(const float* M, float* out) {
  float dscale[NU], L[NU][NU], Li[NU][NU];
  bool diag_ok = true;
#pragma unroll
  for (int i = 0; i < NU; ++i) {
    diag_ok = diag_ok && (M[i * NU + i] > 0.f);
    dscale[i] = sqrtf(nmax(M[i * NU + i], 1e-30f));
  }
  float min_piv = 0.f;
#pragma unroll
  for (int j = 0; j < NU; ++j) {
    float s = M[j * NU + j] / (dscale[j] * dscale[j]);
#pragma unroll
    for (int p = 0; p < j; ++p) s = s - L[j][p] * L[j][p];
    min_piv = (j == 0) ? s : nmin(min_piv, s);
    const float d = sqrtf(nmax(s, 1e-12f));
    L[j][j] = d;
    const float inv_d = 1.f / d;
#pragma unroll
    for (int i = j + 1; i < NU; ++i) {
      float t = M[i * NU + j] / (dscale[i] * dscale[j]);
#pragma unroll
      for (int p = 0; p < j; ++p) t = t - L[i][p] * L[j][p];
      L[i][j] = t * inv_d;
    }
  }
#pragma unroll
  for (int j = 0; j < NU; ++j) {
    Li[j][j] = 1.f / L[j][j];
#pragma unroll
    for (int i = j + 1; i < NU; ++i) {
      float s = L[i][j] * Li[j][j];
#pragma unroll
      for (int k = j + 1; k < i; ++k) s = s + L[i][k] * Li[k][j];
      Li[i][j] = -s / L[i][i];
    }
  }
  const bool ok = diag_ok && (min_piv > 1e-10f);
#pragma unroll
  for (int i = 0; i < NU; ++i) {
#pragma unroll
    for (int j = 0; j < NU; ++j) {
      const int k0 = i > j ? i : j;
      float s = Li[k0][i] * Li[k0][j];
#pragma unroll
      for (int k = k0 + 1; k < NU; ++k) s = s + Li[k][i] * Li[k][j];
      out[i * NU + j] = ok ? s / (dscale[i] * dscale[j]) : 0.f;
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

// ---- forward-mode dual numbers (value, tangent) ---------------------------
// The tangent rules are JAX's jvp rules (sin' = cos, cos' = -sin,
// tan' = 1 + tan^2, the quotient rule); the value part is the plain float
// arithmetic, so ode_rows<float> and the value of ode_rows<Dual> agree.
struct Dual {
  float v, d;
};
__device__ __forceinline__ Dual operator+(Dual a, Dual b) {
  return {a.v + b.v, a.d + b.d};
}
__device__ __forceinline__ Dual operator-(Dual a, Dual b) {
  return {a.v - b.v, a.d - b.d};
}
__device__ __forceinline__ Dual operator-(Dual a, float b) {
  return {a.v - b, a.d};
}
__device__ __forceinline__ Dual operator+(Dual a, float b) {
  return {a.v + b, a.d};
}
__device__ __forceinline__ Dual operator-(Dual a) { return {-a.v, -a.d}; }
__device__ __forceinline__ Dual operator*(Dual a, Dual b) {
  return {a.v * b.v, a.d * b.v + a.v * b.d};
}
__device__ __forceinline__ Dual operator*(Dual a, float b) {
  return {a.v * b, a.d * b};
}
__device__ __forceinline__ Dual operator*(float a, Dual b) {
  return {a * b.v, a * b.d};
}
__device__ __forceinline__ Dual operator/(Dual a, Dual b) {
  const float q = a.v / b.v;
  return {q, (a.d - q * b.d) / b.v};
}
__device__ __forceinline__ Dual operator/(Dual a, float b) {
  return {a.v / b, a.d / b};
}
__device__ __forceinline__ float fsin(float x) { return sinf(x); }
__device__ __forceinline__ float fcos(float x) { return cosf(x); }
__device__ __forceinline__ float ftan(float x) { return tanf(x); }
__device__ __forceinline__ Dual fsin(Dual x) {
  return {sinf(x.v), cosf(x.v) * x.d};
}
__device__ __forceinline__ Dual fcos(Dual x) {
  return {cosf(x.v), -sinf(x.v) * x.d};
}
__device__ __forceinline__ Dual ftan(Dual x) {
  const float t = tanf(x.v);
  return {t, (1.f + t * t) * x.d};
}
// sqrt' = 1 / (2 sqrt), as PyTorch's forward-mode rule writes it
__device__ __forceinline__ float fsqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ Dual fsqrt(Dual x) {
  const float s = sqrtf(x.v);
  return {s, x.d / (2.f * s)};
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

// The soft rows of one problem: penalty rows and the violation pairs (in
// the workspace). Empty unless SOFT, so the hard instantiations carry no
// extra state (the Solver is the empty base's only user).
template <bool SOFT>
struct SoftRows {};
template <>
struct SoftRows<true> {
  const float *Zg[4], *zg[4];
  float *tv[4], *gv[4];
};

// One problem's solve, run by one thread block: an NX-state, NU-control
// model; FAM is the FUSE_LIN prologue's ODE.
template <int MODE, bool SOFT, int NX, int NU, int FAM>
struct Solver : SoftRows<SOFT> {
  static constexpr int NXX = NX * NX;
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
  // workspace
  float *P, *Z, *Hinv, *kff, *dx, *du, *ddx, *ddu, *ddxa, *ddua, *qr, *rr,
      *req;
  Shared<NX, NU>& sh;
  int N, t;
  float mu0, reg, n_ineq, mu_t;

  __device__ Solver(const Inputs& in, const Outputs& out, Shared<NX, NU>& sh_,
                    int N_, float mu0_, float reg_)
      : sh(sh_), N(N_), t(threadIdx.x), mu0(mu0_), reg(reg_), n_ineq(1.f),
        mu_t(0.f) {
    const size_t b = blockIdx.x, n = N, n1 = N + 1;
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
    P = w;        w += n1 * NXX;
    dx = w;       w += n1 * NX;
    ddx = w;      w += n1 * NX;
    ddxa = w;     w += n1 * NX;
    qr = w;       w += n1 * NX;
    Z = w;        w += n * NU * NX;
    Hinv = w;     w += n * NU * NU;
    kff = w;      w += n * NU;
    du = w;       w += n * NU;
    ddu = w;      w += n * NU;
    ddua = w;     w += n * NU;
    rr = w;       w += n * NU;
    req = w;      w += n * NX;
    if constexpr (SOFT) {
      for (int g = 0; g < 4; ++g) {
        const size_t wd = g < 2 ? NX : NU;
        this->Zg[g] = in.Zp[g] + b * n * wd;
        this->zg[g] = in.zp[g] + b * n * wd;
        this->tv[g] = w;  w += n * wd;
        this->gv[g] = w;  w += n * wd;
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
      Aw = L;
      Bw = L + n * NXX;
      cw = Bw + n * NX * NU;
      A = Aw;
      Bm = Bw;
      c = cw;
    }
  }

  // ---- fused assembly ----------------------------------------------------
  // FUSE_LIN prologue: thread e takes node k = e / C and tangent column
  // j = e % C, C = NX + NU (j < NX seeds x_j, else u_{j-NX}), runs RK4 of
  // the family's ODE on duals and writes column j of A_k or B_k; column 0
  // also writes the shooting defect c_k = x_next - xbar_{k+1}.
  __device__ void linearize(const Model& md) {
    constexpr int C = NX + NU;
    for (int e = t; e < N * C; e += THREADS) {
      const int k = e / C, j = e - k * C;
      Dual X[NX], U[NU];
#pragma unroll
      for (int i = 0; i < NX; ++i) {
        X[i] = {xbar[k * NX + i], i == j ? 1.f : 0.f};
      }
#pragma unroll
      for (int i = 0; i < NU; ++i) {
        U[i] = {ubar[k * NU + i], NX + i == j ? 1.f : 0.f};
      }
      rk4_rows<FAM, NX>(X, U, sp + (size_t)k * np, md);
      if (j < NX) {
#pragma unroll
        for (int i = 0; i < NX; ++i) Aw[((size_t)k * NX + i) * NX + j] = X[i].d;
      } else {
#pragma unroll
        for (int i = 0; i < NX; ++i) {
          Bw[((size_t)k * NX + i) * NU + (j - NX)] = X[i].d;
        }
      }
      if (j == 0) {
#pragma unroll
        for (int i = 0; i < NX; ++i) {
          cw[k * NX + i] = X[i].v - xbar[(k + 1) * NX + i];
        }
      }
    }
    __syncthreads();
  }

  // build_qp's cost and bound rows from the iterate (Qs and R arrive
  // dt-scaled, the terminal Qt unscaled; the gradient uses Rg):
  // q_k = Qs' (xbar_k - yref_k), q_N = Qt' (xbar_N - yref_e),
  // r_k = Rg' (ubar_k - yref_u,k), delta bound = absolute box - iterate.
  __device__ void cost_fill() {
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
    sx = block_reduce(ax, sh.red, OpMax());
    su = block_reduce(au, sh.red, OpMax());
    vio = block_reduce(v, sh.red, OpMax());
  }

  // ---- bound rows -------------------------------------------------------
  // Row e of the N*(NX+NU) box rows: state rows first (slack index k bounds
  // dx[k+1], states are bounded at stages 1..N), then control rows. Each row
  // has a lower (group gb) and an upper (group gb+1) bound. f(gb, idx, vi):
  // idx indexes the (N, n) group arrays, vi the primal/direction arrays.
  template <class F>
  __device__ void for_rows(F f) const {
    const int nxr = N * NX, tot = N * (NX + NU);
    for (int e = t; e < tot; e += THREADS) {
      if (e < nxr) {
        f(0, e, e + NX);
      } else {
        f(2, e - nxr, e - nxr);
      }
    }
  }

  __device__ static float sgn(int g) { return (g & 1) ? -1.f : 1.f; }
  __device__ static float mask(int g, float b) {
    return (g & 1) ? (b < MTHR ? 1.f : 0.f) : (b > -MTHR ? 1.f : 0.f);
  }
  // slack residual s - sgn (v - b) (- t on a soft row)
  __device__ float rs(int g, int idx, float v) const {
    if constexpr (SOFT) {
      if (srow(g, idx)) {
        return s[g][idx] - (sgn(g) * (v - bnd[g][idx]) + this->tv[g][idx]);
      }
    }
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
  // A row is soft where its bound is finite and its Z is not the sentinel.
  __device__ bool srow(int g, int idx) const {
    if constexpr (SOFT) {
      return mask(g, bnd[g][idx]) > 0.5f && this->Zg[g][idx] < MTHR;
    }
    return false;
  }
  // the eliminated pair's denominator Z + sig_s + sig_t and RHS scalar
  // w = -r_t + (Ts/s - lam) + (Tt/t - gam) + sig_s r_s of a soft row
  __device__ void soft_terms(int g, int idx, float r, float Ts, float Tt,
                             float& den, float& w) const {
    const float ss = sig(g, idx), sv = s[g][idx], lv = lam[g][idx];
    const float tt = this->tv[g][idx], gg = this->gv[g][idx], Z = this->Zg[g][idx];
    den = (Z + ss) + gg / tt;
    const float r_t = ((this->zg[g][idx] + Z * tt) - lv) - gg;
    w = ((-r_t + (Ts / sv - lv)) + (Tt / tt - gg)) + ss * r;
  }
  // Newton directions (ds, dl, dt, dg) of one bound entry for primal
  // direction dd under the targets (Ts, Tt); dt = dg = 0 on a hard row,
  // where ds and dl are `dirs`'
  __device__ void sdirs(int g, int idx, float v, float dd, float Ts,
                        float Tt, float& ds, float& dl, float& dt,
                        float& dg) const {
    const float m = mask(g, bnd[g][idx]);
    const float sv = s[g][idx], lv = lam[g][idx];
    const float r = rs(g, idx, v);
    float dv = sgn(g) * dd;
    dt = 0.f;
    dg = 0.f;
    if (srow(g, idx)) {
      float den, w;
      soft_terms(g, idx, r, Ts, Tt, den, w);
      const float tt = this->tv[g][idx], gg = this->gv[g][idx];
      dt = (w - sig(g, idx) * dv) / den;
      dg = clipf(((Tt - tt * gg) - gg * dt) / tt, -DUAL_CLIP, DUAL_CLIP);
      dv = dv + dt;
    }
    ds = m * (dv - r);
    dl = m * clipf((Ts - sv * lv - lv * ds) / sv, -DUAL_CLIP, DUAL_CLIP);
  }
  // the corrector's targets (Ts, Tt) from the affine directions in
  // ddxa/ddua (0 in the predictor)
  __device__ void stargets(bool cor, int g, int idx, float v, float dda,
                           float& Ts, float& Tt) const {
    Ts = 0.f;
    Tt = 0.f;
    if (!cor) return;
    float ds, dl, dt, dg;
    sdirs(g, idx, v, dda, 0.f, 0.f, ds, dl, dt, dg);
    Ts = clipf(mu_t - ds * dl, 0.05f * mu_t, 20.f * mu_t);
    Tt = clipf(mu_t - dt * dg, 0.05f * mu_t, 20.f * mu_t);
  }
  // max |z + Z t - lam - gam| over the soft rows (soft stationarity)
  __device__ float soft_rt_max() const {
    float acc = 0.f;
    for_rows([&](int gb, int idx, int) {
      for (int g = gb; g < gb + 2; ++g) {
        if (srow(g, idx)) {
          const float r_t = ((this->zg[g][idx] + this->Zg[g][idx] * this->tv[g][idx])
                             - lam[g][idx]) - this->gv[g][idx];
          acc = nmax(acc, fabsf(r_t));
        }
      }
    });
    return block_reduce(acc, sh.red, OpMax());
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

  // rollout (du = 0) with the 10%-inset clamp, centred slacks and duals,
  // then the warm blend over them
  __device__ void init() {
    if (t < NX) {
      if constexpr (MODE == PLAIN) {
        dx[t] = dx0[t];
      } else {
        dx[t] = x0[t] - xbar[t];
      }
    }
    __syncthreads();
    for (int k = 0; k < N; ++k) {
      if (t < NX) {
        const float* Ar = A + (size_t)k * NXX + t * NX;
        const float* x = dx + k * NX;
        float a = Ar[0] * x[0];
        for (int j = 1; j < NX; ++j) a += Ar[j] * x[j];
        a += c[k * NX + t];
        const int idx = k * NX + t;
        dx[(k + 1) * NX + t] = clamp_init(a, 0, idx);
      }
      __syncthreads();
    }
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
          const bool sr = srow(g, idx);
          const float tt = sr ? nmax(-gap, 0.f) + 0.1f : BIG;
          this->tv[g][idx] = tt;
          this->gv[g][idx] = sr ? mu0 / tt : 0.f;
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
    n_ineq = nmax(block_reduce(cnt, sh.red, OpSum()), 1.f);
    __syncthreads();
  }

  __device__ float comp_sum() const {
    float acc = 0.f;
    for_rows([&](int gb, int idx, int) {
      for (int g = gb; g < gb + 2; ++g) {
        acc += mask(g, bnd[g][idx]) * s[g][idx] * lam[g][idx];
        if constexpr (SOFT) {
          if (srow(g, idx)) acc += this->tv[g][idx] * this->gv[g][idx];
        }
      }
    });
    return block_reduce(acc, sh.red, OpSum());
  }

  // (stat, eq) of the iterate in dx/du by the adjoint sweep; refreshes req
  // with the shooting residuals (the next solve's right-hand side).
  __device__ void kkt(float& stat_out, float& eq_out) {
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
    }
    if (t < NX) {
      float a = Qt[t] * dx[N * NX];
      for (int j = 1; j < NX; ++j) a += Qt[j * NX + t] * dx[N * NX + j];
      const int l = (N - 1) * NX + t;
      sh.vx[0][t] = (a + q[N * NX + t]) - (lam[0][l] - lam[1][l]);
    }
    __syncthreads();
    float stat = 0.f;
    int cur = 0;
    for (int k = N - 1; k >= 0; --k) {
      const float* lm = sh.vx[cur];
      if (t < NU) {
        const float* Bk = Bm + (size_t)k * NX * NU;
        float a = R[t] * du[k * NU];
        for (int j = 1; j < NU; ++j) a += R[j * NU + t] * du[k * NU + j];
        float bl = Bk[t] * lm[0];
        for (int j = 1; j < NX; ++j) bl += Bk[j * NU + t] * lm[j];
        const int l = k * NU + t;
        const float su = ((a + r[l]) + bl) - (lam[2][l] - lam[3][l]);
        stat = nmax(stat, fabsf(su));
      } else if (t >= 32 && t < 32 + NX) {
        const int i = t - 32;
        const float* Ak = A + (size_t)k * NXX;
        float a = Qs[i] * dx[k * NX];
        for (int j = 1; j < NX; ++j) a += Qs[j * NX + i] * dx[k * NX + j];
        float al = Ak[i] * lm[0];
        for (int j = 1; j < NX; ++j) al += Ak[j * NX + i] * lm[j];
        float ln = (a + q[k * NX + i]) + al;
        if (k >= 1) {
          const int l = (k - 1) * NX + i;
          ln = ln - (lam[0][l] - lam[1][l]);
        }
        sh.vx[cur ^ 1][i] = ln;
      }
      __syncthreads();
      cur ^= 1;
    }
    stat_out = block_reduce(stat, sh.red, OpMax());
    eq_out = block_reduce(eq, sh.red, OpMax());
  }

  // the factorization's weight of one entry: sig_s, or the eliminated
  // sig_eff on a soft row
  __device__ float sig_fac(int g, int idx) const {
    const float ss = sig(g, idx);
    if constexpr (SOFT) {
      if (srow(g, idx)) {
        const float Z = this->Zg[g][idx], st = this->gv[g][idx] / this->tv[g][idx];
        return ss * (Z + st) / ((Z + ss) + st);
      }
    }
    return ss;
  }

  __device__ float sig_pair(int gb, int idx) const {
    return nmin(sig_fac(gb, idx) + sig_fac(gb + 1, idx), SIGMA_MAX);
  }

  // backward Riccati factorization: P (N+1 stack), Z = Hinv Hux, Hinv
  __device__ void factorize() {
    for (int e = t; e < NXX; e += THREADS) {
      const int i = e / NX, j = e - i * NX;
      float v = Qt[e];
      if (i == j) v = v + sig_pair(0, (N - 1) * NX + i);
      sh.Pn[e] = v;
      P[(size_t)N * NXX + e] = v;
    }
    __syncthreads();
    for (int k = N - 1; k >= 0; --k) {
      const float* Ak = A + (size_t)k * NXX;
      const float* Bk = Bm + (size_t)k * NX * NU;
      for (int e = t; e < NXX + NX * NU; e += THREADS) {
        if (e < NXX) {  // PA = P' A
          const int i = e / NX, j = e - i * NX;
          float a = sh.Pn[i] * Ak[j];
          for (int l = 1; l < NX; ++l) a += sh.Pn[l * NX + i] * Ak[l * NX + j];
          sh.PA[e] = a;
        } else {  // PB = P' B
          const int e2 = e - NXX, i = e2 / NU, j = e2 - i * NU;
          float a = sh.Pn[i] * Bk[j];
          for (int l = 1; l < NX; ++l) a += sh.Pn[l * NX + i] * Bk[l * NU + j];
          sh.PB[e2] = a;
        }
      }
      __syncthreads();
      for (int e = t; e < NU * NU + NU * NX; e += THREADS) {
        if (e < NU * NU) {  // Huu = B' P B + R + reg I + diag(sig_u)
          const int i = e / NU, j = e - i * NU;
          float a = Bk[i] * sh.PB[j];
          for (int l = 1; l < NX; ++l) a += Bk[l * NU + i] * sh.PB[l * NU + j];
          float v = a + R[e];
          if (i == j) {
            v = v + reg;
            v = v + sig_pair(2, k * NU + i);
          }
          sh.Huu[e] = v;
        } else {  // Hux = B' P A
          const int e2 = e - NU * NU, i = e2 / NX, j = e2 - i * NX;
          float a = Bk[i] * sh.PA[j];
          for (int l = 1; l < NX; ++l) a += Bk[l * NU + i] * sh.PA[l * NX + j];
          sh.Hux[e2] = a;
        }
      }
      __syncthreads();
      if (t == 0) chol_inverse<NU>(sh.Huu, sh.Hi);
      __syncthreads();
      for (int e = t; e < NU * NX + NU * NU; e += THREADS) {
        if (e < NU * NX) {  // Z = Hinv' Hux
          const int i = e / NX, j = e - i * NX;
          float a = sh.Hi[i] * sh.Hux[j];
          for (int l = 1; l < NU; ++l) a += sh.Hi[l * NU + i] * sh.Hux[l * NX + j];
          sh.Zk[e] = a;
          Z[(size_t)k * NU * NX + e] = a;
        } else {
          const int e2 = e - NU * NX;
          Hinv[(size_t)k * NU * NU + e2] = sh.Hi[e2];
        }
      }
      __syncthreads();
      for (int e = t; e < NXX; e += THREADS) {  // Qs + A' P A - Hux' Z
        const int i = e / NX, j = e - i * NX;
        float a = Ak[i] * sh.PA[j];
        for (int l = 1; l < NX; ++l) a += Ak[l * NX + i] * sh.PA[l * NX + j];
        float h = sh.Hux[i] * sh.Zk[j];
        for (int l = 1; l < NU; ++l) h += sh.Hux[l * NX + i] * sh.Zk[l * NX + j];
        float v = (Qs[e] + a) - h;
        if (k >= 1 && i == j) v = v + sig_pair(0, (k - 1) * NX + i);
        sh.Pt[e] = v;
      }
      __syncthreads();
      for (int e = t; e < NXX; e += THREADS) {  // symmetrize
        const int i = e / NX, j = e - i * NX;
        const float v = 0.5f * (sh.Pt[i * NX + j] + sh.Pt[j * NX + i]);
        sh.Pn[e] = v;
        P[(size_t)k * NXX + e] = v;
      }
      __syncthreads();
    }
  }

  // RHS gradients qr/rr with the barrier terms of the given targets
  __device__ void rhs_grads(bool cor) {
    if (t < NX) {
      float a = Qs[t] * dx[0];
      for (int j = 1; j < NX; ++j) a += Qs[j * NX + t] * dx[j];
      qr[t] = a + q[t];
    }
    for_rows([&](int gb, int idx, int vi) {
      const float* V = gb ? du : dx;
      const float* DA = gb ? ddua : ddxa;
      const float v = V[vi];
      float bsum = 0.f;
      for (int g = gb; g < gb + 2; ++g) {
        float b;
        if constexpr (SOFT) {
          float Ts, Tt;
          stargets(cor, g, idx, v, DA[vi], Ts, Tt);
          const float r = rs(g, idx, v), ss = sig(g, idx);
          b = clipf(Ts / s[g][idx], -SIGMA_MAX, SIGMA_MAX) + ss * r;
          if (srow(g, idx)) {
            float den, w;
            soft_terms(g, idx, r, Ts, Tt, den, w);
            b = b - (ss * w) / den;
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

  // backward + forward sweeps with the current factor -> (dX, dU)
  __device__ void solve_rhs(float* dX, float* dU) {
    if (t < NX) sh.vx[0][t] = qr[N * NX + t];
    __syncthreads();
    int cur = 0;
    for (int k = N - 1; k >= 0; --k) {
      const float* Ak = A + (size_t)k * NXX;
      const float* Bk = Bm + (size_t)k * NX * NU;
      const float* pv = sh.vx[cur];
      if (t < NX) {  // Pcp = P_{k+1}' req_k + p
        const float* Pk1 = P + (size_t)(k + 1) * NXX;
        const float* rq = req + k * NX;
        float a = Pk1[t] * rq[0];
        for (int j = 1; j < NX; ++j) a += Pk1[j * NX + t] * rq[j];
        sh.wx[t] = a + pv[t];
      }
      __syncthreads();
      if (t < NU) {  // Gu = rr_k + B' Pcp
        float a = Bk[t] * sh.wx[0];
        for (int j = 1; j < NX; ++j) a += Bk[j * NU + t] * sh.wx[j];
        sh.wu[t] = rr[k * NU + t] + a;
      }
      __syncthreads();
      if (t < NU) {  // kff = -Hinv' Gu
        const float* Hk = Hinv + (size_t)k * NU * NU;
        float a = Hk[t] * sh.wu[0];
        for (int j = 1; j < NU; ++j) a += Hk[j * NU + t] * sh.wu[j];
        kff[k * NU + t] = -a;
      } else if (t >= 32 && t < 32 + NX) {  // p = qr_k + A' Pcp - Z' Gu
        const int i = t - 32;
        const float* Zk = Z + (size_t)k * NU * NX;
        float a = Ak[i] * sh.wx[0];
        for (int j = 1; j < NX; ++j) a += Ak[j * NX + i] * sh.wx[j];
        float z = Zk[i] * sh.wu[0];
        for (int j = 1; j < NU; ++j) z += Zk[j * NX + i] * sh.wu[j];
        sh.vx[cur ^ 1][i] = (qr[k * NX + i] + a) - z;
      }
      __syncthreads();
      cur ^= 1;
    }
    if (t < NX) dX[t] = 0.f;
    __syncthreads();
    for (int k = 0; k < N; ++k) {
      const float* d = dX + k * NX;
      if (t < NU) {  // du = -Z d + kff
        const float* Zr = Z + ((size_t)k * NU + t) * NX;
        float a = Zr[0] * d[0];
        for (int j = 1; j < NX; ++j) a += Zr[j] * d[j];
        dU[k * NU + t] = -a + kff[k * NU + t];
      }
      __syncthreads();
      if (t < NX) {  // dx_{k+1} = A d + B du + req
        const float* Ar = A + (size_t)k * NXX + t * NX;
        const float* Br = Bm + ((size_t)k * NX + t) * NU;
        const float* u = dU + k * NU;
        float a = Ar[0] * d[0];
        for (int j = 1; j < NX; ++j) a += Ar[j] * d[j];
        float b = Br[0] * u[0];
        for (int j = 1; j < NU; ++j) b += Br[j] * u[j];
        dX[(k + 1) * NX + t] = (a + b) + req[k * NX + t];
      }
      __syncthreads();
    }
  }

  // fraction-to-boundary step lengths for directions (dX, dU)
  __device__ void alphas(bool cor, float tau, const float* dX, const float* dU,
                         float& a_p, float& a_d) const {
    float ap = 1.f, ad = 1.f;
    for_rows([&](int gb, int idx, int vi) {
      const float v = (gb ? du : dx)[vi];
      const float d = (gb ? dU : dX)[vi];
      const float da = (gb ? ddua : ddxa)[vi];
      for (int g = gb; g < gb + 2; ++g) {
        float ds, dl;
        if constexpr (SOFT) {
          float Ts, Tt, dt, dg;
          stargets(cor, g, idx, v, da, Ts, Tt);
          sdirs(g, idx, v, d, Ts, Tt, ds, dl, dt, dg);
          if (srow(g, idx)) {
            ap = nmin(ap, ratio(this->tv[g][idx], dt, tau));
            ad = nmin(ad, ratio(this->gv[g][idx], dg, tau));
          }
        } else {
          dirs(g, idx, v, d, target(cor, g, idx, v, da), ds, dl);
        }
        ap = nmin(ap, ratio(s[g][idx], ds, tau));
        ad = nmin(ad, ratio(lam[g][idx], dl, tau));
      }
    });
    a_p = nmin(block_reduce(ap, sh.red, OpMin()), 1.f);
    a_d = nmin(block_reduce(ad, sh.red, OpMin()), 1.f);
  }

  // complementarity after the affine step (sum over bounds)
  __device__ float mu_aff_sum(float ap, float ad) const {
    float acc = 0.f;
    for_rows([&](int gb, int idx, int vi) {
      const float v = (gb ? du : dx)[vi];
      const float da = (gb ? ddua : ddxa)[vi];
      for (int g = gb; g < gb + 2; ++g) {
        float ds, dl;
        if constexpr (SOFT) {
          float dt, dg;
          sdirs(g, idx, v, da, 0.f, 0.f, ds, dl, dt, dg);
          if (srow(g, idx)) {
            acc += (this->tv[g][idx] + ap * dt) * (this->gv[g][idx] + ad * dg);
          }
        } else {
          dirs(g, idx, v, da, 0.f, ds, dl);
        }
        acc += mask(g, bnd[g][idx]) * (s[g][idx] + ap * ds)
               * (lam[g][idx] + ad * dl);
      }
    });
    return block_reduce(acc, sh.red, OpSum());
  }

  // corrector step of the iterate (stage-0 state pinned)
  __device__ void update(float ap, float ad) {
    for_rows([&](int gb, int idx, int vi) {
      float* V = gb ? du : dx;
      const float d = (gb ? ddu : ddx)[vi];
      const float da = (gb ? ddua : ddxa)[vi];
      const float v = V[vi];
      float ds[2], dl[2], dt[2], dg[2];
      for (int h = 0; h < 2; ++h) {
        const int g = gb + h;
        if constexpr (SOFT) {
          float Ts, Tt;
          stargets(true, g, idx, v, da, Ts, Tt);
          sdirs(g, idx, v, d, Ts, Tt, ds[h], dl[h], dt[h], dg[h]);
        } else {
          dirs(g, idx, v, d, target(true, g, idx, v, da), ds[h], dl[h]);
        }
      }
      for (int h = 0; h < 2; ++h) {
        const int g = gb + h;
        if constexpr (SOFT) {
          if (srow(g, idx)) {
            this->tv[g][idx] = nmax(this->tv[g][idx] + ap * dt[h], EPS_S);
            this->gv[g][idx] = clipf(this->gv[g][idx] + ad * dg[h], 0.f, LAM_MAX);
          }
        }
        s[g][idx] = nmax(s[g][idx] + ap * ds[h], EPS_S);
        lam[g][idx] = clipf(lam[g][idx] + ad * dl[h], 0.f, LAM_MAX);
      }
      V[vi] = v + ap * d;
    });
    __syncthreads();
  }

  __device__ void copy(float* dst_x, const float* src_x, float* dst_u,
                       const float* src_u) {
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
    if (t == 0) {
      diag[0] = st;
      diag[1] = eq;
      diag[2] = best;
      diag[3] = sx;
      diag[4] = su;
      diag[5] = vio;
    }
  }
};

template <int MODE, bool SOFT, int NX, int NU, int FAM>
__global__ void __launch_bounds__(THREADS)
box_qp_ipm_kernel(Inputs in, Outputs out, Model md, int N, int iters,
                  float mu0, float alpha_frac, float reg) {
  if (in.skip != nullptr && *in.skip) return;  // uniform across the grid
  __shared__ Shared<NX, NU> sh;
  Solver<MODE, SOFT, NX, NU, FAM> solver(in, out, sh, N, mu0, reg);
  solver.run(iters, alpha_frac, md);
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
  if (B <= 0 || N <= 0 || iters < 0) return (int)cudaErrorInvalidValue;
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
  box_qp_ipm_kernel<MODE, SOFT, NX, NU, FAM>
      <<<B, THREADS, 0, (cudaStream_t)stream>>>(in, out, md, N, iters, mu0,
                                                alpha_frac, reg);
  return (int)cudaGetLastError();
}

// The model dimensions the entries take: BLASTER's 17x6 or QUAD13's 13x4.
bool is_17x6(int nx, int nu) { return nx == 17 && nu == 6; }
bool is_13x4(int nx, int nu) { return nx == 13 && nu == 4; }

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

extern "C" const char* box_qp_ipm_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// PLAIN: one launch solves the whole batch: grid = B blocks of THREADS
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
  if (is_13x4(nx, nu) && !soft) {
    return launch<PLAIN, false, 13, 4>(in, out, Model{}, B, N, iters, mu0,
                                       alpha_frac, reg, stream);
  }
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
}

// FUSE_LIN (the one-launch RTI tick): dx/du receive deltas; `lin`, when not
// null, receives the A, B and c the prologue built (B, lin_floats(N)).
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
  if (family == BLASTER) {
    if (soft) {
      return launch<FUSE_LIN, true, 17, 6>(in, out, md, B, N, iters, mu0,
                                           alpha_frac, reg, stream);
    }
    return launch<FUSE_LIN, false, 17, 6>(in, out, md, B, N, iters, mu0,
                                          alpha_frac, reg, stream);
  }
  if (family == BLASTER_DIST && !soft) {
    return launch<FUSE_LIN, false, 17, 6, BLASTER_DIST>(
        in, out, md, B, N, iters, mu0, alpha_frac, reg, stream);
  }
  if (family == QUAD13 && !soft) {
    return launch<FUSE_LIN, false, 13, 4, QUAD13>(
        in, out, md, B, N, iters, mu0, alpha_frac, reg, stream);
  }
  return (int)cudaErrorInvalidValue;
}
