// Batched box-constrained OCP-QP interior-point solve for Hopper (sm_90a).
//
// Replaces mpc_blaster_tpu/ops/pallas_ipm.py::_ipm_kernel in its plain mode
// (cold start, hard bounds, resident), with the in-kernel algebra of that
// file (_contractT, _contractT_vec, _matvec, _chol_inverse_lanes). One launch
// runs the whole Mehrotra predictor-corrector solve -- init, every IPM
// iteration, best-merit tracking and the final KKT sweep -- for a batch of
// problems. The plain PyTorch twin is ops/box_qp_ipm.py::box_qp_solve_plain;
// both follow the same operation order.
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
// B problems is B blocks, spread over the 132 SMs. Shared-memory staging,
// warp-level factorization and tensor-core products are later work.
//
// Interface: plain C (loaded with ctypes), float32, contiguous problem-major
// tensors; launches on the caller's stream and returns cudaGetLastError().
// Build without --use_fast_math: the guards rely on IEEE division, square
// root and NaN behaviour.

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

__host__ __device__ size_t workspace_floats(int N) {
  const size_t n = N, n1 = N + 1;
  return n1 * (NXX + 4 * NX)                  // P, dx, ddx, ddxa, qr
         + n * (NU * NX + NU * NU + 5 * NU + NX);  // Z, Hinv, kff, du,
                                                   // ddu, ddua, rr, req
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
};

struct Outputs {
  float* dx;    // (B, N+1, NX) best-merit iterate
  float* du;    // (B, N, NU)
  float* diag;  // (B, 6)
  float* s[4];  // last-iterate slacks: lx, ux (B, N, NX); lu, uu (B, N, NU)
  float* lam[4];  // last-iterate duals, same layout
  float* work;  // (B, workspace_floats(N))
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

// One problem's solve, run by one thread block.
struct Solver {
  // inputs of this problem
  const float *A, *Bm, *c, *Qs, *Qt, *q, *R, *r, *dx0;
  const float* bnd[4];  // lbx, ubx, lbu, ubu
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
    A = in.A + b * n * NXX;
    Bm = in.Bm + b * n * NX * NU;
    c = in.c + b * n * NX;
    Qs = in.Qs + b * NXX;
    Qt = in.Qt + b * NXX;
    q = in.q + b * n1 * NX;
    R = in.R + b * NU * NU;
    r = in.r + b * n * NU;
    dx0 = in.dx0 + b * NX;
    bnd[0] = in.lbx + b * n * NX;
    bnd[1] = in.ubx + b * n * NX;
    bnd[2] = in.lbu + b * n * NU;
    bnd[3] = in.ubu + b * n * NU;
    dxb = out.dx + b * n1 * NX;
    dub = out.du + b * n * NU;
    diag = out.diag + b * 6;
    for (int g = 0; g < 4; ++g) {
      const size_t w = g < 2 ? NX : NU;
      s[g] = out.s[g] + b * n * w;
      lam[g] = out.lam[g] + b * n * w;
    }
    float* w = out.work + b * workspace_floats(N);
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
    req = w;
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
    if (t < NX) dx[t] = dx0[t];
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

  __device__ void run(int iters, float alpha_frac) {
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
    if (t == 0) {
      diag[0] = st;
      diag[1] = eq;
      diag[2] = best;
      diag[3] = 0.f;
      diag[4] = 0.f;
      diag[5] = 0.f;
    }
  }
};

__global__ void __launch_bounds__(THREADS)
box_qp_ipm_kernel(Inputs in, Outputs out, int N, int iters, float mu0,
                  float alpha_frac, float reg) {
  __shared__ Shared sh;
  Solver solver(in, out, sh, N, mu0, reg);
  solver.run(iters, alpha_frac);
}

}  // namespace

extern "C" long long box_qp_ipm_workspace_floats(int N) {
  return (long long)workspace_floats(N);
}

extern "C" const char* box_qp_ipm_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// One launch solves the whole batch: grid = B blocks of THREADS threads.
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
  if (B <= 0 || N <= 0 || iters < 0) return (int)cudaErrorInvalidValue;
  Inputs in{A, Bm, c, Qs, Qt, q, R, r, lbx, ubx, lbu, ubu, dx0};
  Outputs out{dx, du, diag, {slx, sux, slu, suu}, {llx, lux, llu, luu}, work};
  box_qp_ipm_kernel<<<B, THREADS, 0, (cudaStream_t)stream>>>(
      in, out, N, iters, mu0, alpha_frac, reg);
  return (int)cudaGetLastError();
}
