// Batched box-constrained OCP-QP interior-point solve for Hopper (sm_90a).
//
// Replaces mpc_blaster_tpu/ops/pallas_ipm.py::_ipm_kernel in three of its
// modes (cold start, hard bounds, resident), with the in-kernel algebra of
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
//   FUSE_LIN   FUSE_COST's assembly plus a linearization prologue: RK4 of the
//              rows-form BLASTER ODE on forward-mode dual numbers gives A, B
//              and c for every node inside the kernel; deltas out
//              (pallas_fused_rti_solve, the one-launch B=1 tick).
//
// The plain PyTorch twins are ops/box_qp_ipm.py::box_qp_solve_plain,
// batched_fused_tick_plain and fused_rti_solve_plain (the prologue's twin is
// dynamics/fastlin.py::fast_linearize); each follows the same operation
// order.
//
// What bounds it on this card: the solve is a chain of O(N * iters) small
// dependent steps (17x17 products, a 6x6 factorization) -- per problem it is
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
// thread one (node, tangent column) pair (N * 23 pairs), so it needs no jvp
// and no cross-thread traffic. Shared-memory staging, warp-level
// factorization and tensor-core products are later work.
//
// Interface: plain C (loaded with ctypes), float32, contiguous problem-major
// tensors; launches on the caller's stream and returns cudaGetLastError().
// Build without --use_fast_math: the guards rely on IEEE division, square
// root, sin/cos/tan and NaN behaviour.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int NX = 17;
constexpr int NU = 6;
constexpr int NXX = NX * NX;
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

enum Mode : int { PLAIN = 0, FUSE_COST = 1, FUSE_LIN = 2 };

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
__host__ __device__ size_t lin_floats(int N) {
  return (size_t)N * (NXX + NX * NU + NX);
}

__host__ __device__ size_t workspace_floats(int N, int mode) {
  const size_t n = N, n1 = N + 1;
  size_t w = n1 * (NXX + 4 * NX)                  // P, dx, ddx, ddxa, qr
             + n * (NU * NX + NU * NU + 5 * NU + NX);  // Z, Hinv, kff, du,
                                                       // ddu, ddua, rr, req
  if (mode != PLAIN) w += n1 * NX + 2 * n * NX + 3 * n * NU;  // q, r, bounds
  if (mode == FUSE_LIN) w += lin_floats(N);
  return w;
}

struct Inputs {  // problem-major float32
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
  float* work;  // (B, workspace_floats(N, mode))
  float* lin;   // FUSE_LIN, optional: (B, lin_floats(N)) A, B, c it built
};

struct Shared {
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

// Fail-safe, Jacobi-equilibrated inverse of the SPD 6x6 Huu (one thread).
// Returns the zero matrix when a diagonal entry is <= 0 or the minimum
// Cholesky pivot is <= 1e-10: the stage's gain collapses to 0 instead of
// blowing the recursion up to inf/NaN.
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

__device__ __forceinline__ float clamp_into(float v, float lb, float ub) {
  const bool ml = lb > -MTHR, mu = ub < MTHR;
  const float w = (ml && mu) ? ub - lb : 1.f;
  const float lo = ml ? lb + 0.1f * w : -BIG;
  const float hi = mu ? ub - 0.1f * w : BIG;
  return clipf(v, lo, nmax(hi, lo));
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

// Classic RK4 with md.nsteps substeps, in place on X:
// dynamics/fastlin.py::_rk4_rows, x + h/6 (((k1 + 2 k2) + 2 k3) + k4).
template <class T>
__device__ __forceinline__ void rk4_rows(T* X, const T* U, const float* P,
                                         const Model& md) {
  for (int s = 0; s < md.nsteps; ++s) {
    T k[NX], acc[NX], Xs[NX];
    ode_rows(X, U, P, md, k);
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      acc[i] = k[i];
      Xs[i] = X[i] + md.h2 * k[i];
    }
    ode_rows(Xs, U, P, md, k);
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      acc[i] = acc[i] + 2.f * k[i];
      Xs[i] = X[i] + md.h2 * k[i];
    }
    ode_rows(Xs, U, P, md, k);
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      acc[i] = acc[i] + 2.f * k[i];
      Xs[i] = X[i] + md.h * k[i];
    }
    ode_rows(Xs, U, P, md, k);
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      acc[i] = acc[i] + k[i];
      X[i] = X[i] + md.h6 * acc[i];
    }
  }
}

// The float instantiation: the same ODE without tangents.
template __device__ void rk4_rows<float>(float*, const float*, const float*,
                                         const Model&);

// One problem's solve, run by one thread block.
template <int MODE>
struct Solver {
  // inputs of this problem
  const float *A, *Bm, *c, *Qs, *Qt, *q, *R, *r, *dx0;
  const float* bnd[4];  // lbx, ubx, lbu, ubu (delta form)
  // fused modes: the iterate, spec rows, absolute boxes; the rows they fill
  const float *xbar, *ubar, *x0, *Rg, *yrx, *yru, *yre, *sp;
  const float* box[4];
  float *qf, *rf, *bd[4], *Aw, *Bw, *cw;
  int np;
  // outputs (slacks/duals double as the iterate's state)
  float *dxb, *dub, *diag;
  float *s[4], *lam[4];
  // workspace
  float *P, *Z, *Hinv, *kff, *dx, *du, *ddx, *ddu, *ddxa, *ddua, *qr, *rr,
      *req;
  Shared& sh;
  int N, t;
  float mu0, reg, n_ineq, mu_t;

  __device__ Solver(const Inputs& in, const Outputs& out, Shared& sh_, int N_,
                    float mu0_, float reg_)
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
    for (int g = 0; g < 4; ++g) {
      const size_t w = g < 2 ? NX : NU;
      s[g] = out.s[g] + b * n * w;
      lam[g] = out.lam[g] + b * n * w;
    }
    float* w = out.work + b * workspace_floats(N, MODE);
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
      float* L = out.lin ? out.lin + b * lin_floats(N) : w;
      Aw = L;
      Bw = L + n * NXX;
      cw = Bw + n * NX * NU;
      A = Aw;
      Bm = Bw;
      c = cw;
    }
  }

  // ---- fused assembly ----------------------------------------------------
  // FUSE_LIN prologue: thread e takes node k = e / 23 and tangent column
  // j = e % 23 (j < NX seeds x_j, else u_{j-NX}), runs RK4 on duals and
  // writes column j of A_k or B_k; column 0 also writes the shooting defect
  // c_k = x_next - xbar_{k+1}.
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
      rk4_rows(X, U, sp + (size_t)k * np, md);
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

  // ---- phases -------------------------------------------------------------
  // rollout (du = 0) with the 10%-inset clamp, centred slacks and duals
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
        dx[(k + 1) * NX + t] = clamp_into(a, bnd[0][idx], bnd[1][idx]);
      }
      __syncthreads();
    }
    float cnt = 0.f;
    for_rows([&](int gb, int idx, int vi) {
      float* V = gb ? du : dx;
      if (gb) V[vi] = clamp_into(0.f, bnd[2][idx], bnd[3][idx]);
      const float v = V[vi];
      for (int g = gb; g < gb + 2; ++g) {
        const float b = bnd[g][idx], m = mask(g, b);
        const float sv = m > 0.5f ? nmax(sgn(g) * (v - b), S_MIN) : BIG;
        s[g][idx] = sv;
        lam[g][idx] = m > 0.5f ? mu0 / sv : 0.f;
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

  __device__ float sig_pair(int gb, int idx) const {
    return nmin(sig(gb, idx) + sig(gb + 1, idx), SIGMA_MAX);
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
      if (t == 0) chol_inverse(sh.Huu, sh.Hi);
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
        const float T = target(cor, g, idx, v, DA[vi]);
        const float sv = s[g][idx];
        const float b = clipf(T / sv, -SIGMA_MAX, SIGMA_MAX)
                        + sig(g, idx) * rs(g, idx, v);
        const float gv = (-sgn(g) * mask(g, bnd[g][idx])) * b;
        bsum = (g == gb) ? gv : bsum + gv;
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
        dirs(g, idx, v, d, target(cor, g, idx, v, da), ds, dl);
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
        dirs(g, idx, v, da, 0.f, ds, dl);
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
      float ds[2], dl[2];
      for (int h = 0; h < 2; ++h) {
        const int g = gb + h;
        dirs(g, idx, v, d, target(true, g, idx, v, da), ds[h], dl[h]);
      }
      for (int h = 0; h < 2; ++h) {
        const int g = gb + h;
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
    float best = st + eq + comp_sum() / n_ineq;
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
      const float merit = st + eq + comp_sum() / n_ineq;
      if (merit < best) {  // uniform across the block
        copy(dxb, dx, dub, du);
        best = merit;
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

template <int MODE>
__global__ void __launch_bounds__(THREADS)
box_qp_ipm_kernel(Inputs in, Outputs out, Model md, int N, int iters,
                  float mu0, float alpha_frac, float reg) {
  __shared__ Shared sh;
  Solver<MODE> solver(in, out, sh, N, mu0, reg);
  solver.run(iters, alpha_frac, md);
}

template <int MODE>
int launch(const Inputs& in, const Outputs& out, const Model& md, int B,
           int N, int iters, float mu0, float alpha_frac, float reg,
           void* stream) {
  if (B <= 0 || N <= 0 || iters < 0) return (int)cudaErrorInvalidValue;
  box_qp_ipm_kernel<MODE><<<B, THREADS, 0, (cudaStream_t)stream>>>(
      in, out, md, N, iters, mu0, alpha_frac, reg);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" long long box_qp_ipm_workspace_floats(int N, int mode) {
  return (long long)workspace_floats(N, mode);
}

extern "C" long long box_qp_ipm_lin_floats(int N) {
  return (long long)lin_floats(N);
}

extern "C" const char* box_qp_ipm_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// PLAIN: one launch solves the whole batch: grid = B blocks of THREADS
// threads.
extern "C" int box_qp_ipm_solve(
    const float* A, const float* Bm, const float* c, const float* Qs,
    const float* Qt, const float* q, const float* R, const float* r,
    const float* lbx, const float* ubx, const float* lbu, const float* ubu,
    const float* dx0,
    float* dx, float* du, float* diag,
    float* slx, float* sux, float* llx, float* lux,
    float* slu, float* suu, float* llu, float* luu,
    float* work, int B, int N, int iters, float mu0, float alpha_frac,
    float reg, void* stream) {
  Inputs in{A, Bm, c, Qs, Qt, q, R, r, lbx, ubx, lbu, ubu, dx0};
  Outputs out{dx, du, diag, {slx, sux, slu, suu}, {llx, lux, llu, luu}, work};
  return launch<PLAIN>(in, out, Model{}, B, N, iters, mu0, alpha_frac, reg,
                       stream);
}

// FUSE_COST (the batched fused tick): xnew/unew receive the updated
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
    float* work, int B, int N, int iters, float mu0, float alpha_frac,
    float reg, void* stream) {
  Inputs in{};
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
  return launch<FUSE_COST>(in, out, Model{}, B, N, iters, mu0, alpha_frac,
                           reg, stream);
}

// FUSE_LIN (the one-launch RTI tick): dx/du receive deltas; `lin`, when not
// null, receives the A, B and c the prologue built (B, lin_floats(N)).
extern "C" int box_qp_ipm_fused_lin(
    const float* xbar, const float* ubar, const float* sp, const float* x0,
    const float* Qs, const float* Qt, const float* R, const float* Rg,
    const float* yrx, const float* yru, const float* yre,
    const float* lbx, const float* ubx, const float* lbu, const float* ubu,
    float* dx, float* du, float* diag,
    float* slx, float* sux, float* llx, float* lux,
    float* slu, float* suu, float* llu, float* luu,
    float* lin, float* work, int B, int N, int np, int iters, float mu0,
    float alpha_frac, float reg, float inv_m, float g, float lx, float ly,
    float cy, float j1, float j2, float j3, float h, float h2, float h6,
    int nsteps, void* stream) {
  if (np < 25 || nsteps < 1) return (int)cudaErrorInvalidValue;
  Inputs in{};
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
  Outputs out{dx, du, diag, {slx, sux, slu, suu}, {llx, lux, llu, luu},
              work, lin};
  const Model md{inv_m, g, lx, ly, cy, j1, j2, j3, h, h2, h6, nsteps};
  return launch<FUSE_LIN>(in, out, md, B, N, iters, mu0, alpha_frac, reg,
                          stream);
}
