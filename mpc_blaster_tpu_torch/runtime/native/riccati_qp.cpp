// riccati_qp.cpp — native C++ box-constrained OCP-QP solver.
//
// Role in the framework: the host-side real-time path. The reference's
// entire solver runtime is generated C (acados + HPIPM + BLASFEO, see
// SURVEY.md §2.2); the port's device path replaces it with PyTorch and a
// CUDA kernel, and THIS file is the native equivalent for the flight
// computer / CPU-only deployments: no Python dispatch, deterministic
// latency. It implements the same algorithm as qp/ipm.py (Mehrotra
// predictor-corrector over a Riccati factorization, Gondzio target
// clipping, best-KKT-iterate selection) so the two implementations
// cross-check each other in tests. A copy of the JAX package's source:
// the port builds nothing from that package.
//
// Build: runtime/bindings.py runs g++ -O3 -shared on first use. ABI:
// plain C, double precision, row-major contiguous arrays.

#include <algorithm>
#include <cmath>
#include <cstring>
#include <limits>
#include <vector>

namespace {

constexpr double kBig = 1e20;

// ----- tiny dense helpers (row-major) -----

inline void matvec(const double* M, const double* v, double* out, int m,
                   int n) {
  for (int i = 0; i < m; ++i) {
    double acc = 0.0;
    const double* row = M + i * n;
    for (int j = 0; j < n; ++j) acc += row[j] * v[j];
    out[i] = acc;
  }
}

// out += M^T v  (M is m x n, v is m, out is n)
inline void matTvec_acc(const double* M, const double* v, double* out, int m,
                        int n) {
  for (int i = 0; i < m; ++i) {
    const double* row = M + i * n;
    const double vi = v[i];
    for (int j = 0; j < n; ++j) out[j] += row[j] * vi;
  }
}

// C = A * B  (A: m x k, B: k x n)
inline void matmul(const double* A, const double* B, double* C, int m, int k,
                   int n) {
  for (int i = 0; i < m; ++i) {
    double* crow = C + i * n;
    std::fill(crow, crow + n, 0.0);
    const double* arow = A + i * k;
    for (int p = 0; p < k; ++p) {
      const double a = arow[p];
      const double* brow = B + p * n;
      for (int j = 0; j < n; ++j) crow[j] += a * brow[j];
    }
  }
}

// C = A^T * B  (A: k x m, B: k x n)
inline void matTmul(const double* A, const double* B, double* C, int k, int m,
                    int n) {
  for (int i = 0; i < m; ++i) {
    double* crow = C + i * n;
    std::fill(crow, crow + n, 0.0);
  }
  for (int p = 0; p < k; ++p) {
    const double* arow = A + p * m;
    const double* brow = B + p * n;
    for (int i = 0; i < m; ++i) {
      const double a = arow[i];
      double* crow = C + i * n;
      for (int j = 0; j < n; ++j) crow[j] += a * brow[j];
    }
  }
}

// In-place lower Cholesky of SPD n x n. Returns false if not PD.
inline bool cholesky(double* M, int n) {
  for (int i = 0; i < n; ++i) {
    for (int j = 0; j <= i; ++j) {
      double sum = M[i * n + j];
      for (int p = 0; p < j; ++p) sum -= M[i * n + p] * M[j * n + p];
      if (i == j) {
        if (sum <= 0.0) return false;
        M[i * n + i] = std::sqrt(sum);
      } else {
        M[i * n + j] = sum / M[j * n + j];
      }
    }
    for (int j = i + 1; j < n; ++j) M[i * n + j] = 0.0;
  }
  return true;
}

// Solve L L^T x = b (x may alias b), L lower from cholesky().
inline void cho_solve(const double* L, double* b, int n) {
  for (int i = 0; i < n; ++i) {
    double sum = b[i];
    for (int p = 0; p < i; ++p) sum -= L[i * n + p] * b[p];
    b[i] = sum / L[i * n + i];
  }
  for (int i = n - 1; i >= 0; --i) {
    double sum = b[i];
    for (int p = i + 1; p < n; ++p) sum -= L[p * n + i] * b[p];
    b[i] = sum / L[i * n + i];
  }
}

struct Workspace {
  int N, nx, nu;
  // Riccati factorization
  std::vector<double> P;      // (N+1) nx nx
  std::vector<double> K;      // N nu nx
  std::vector<double> L;      // N nu nu (chol factors)
  std::vector<double> kff;    // N nu
  // iterate
  std::vector<double> dx, du;                      // (N+1)nx, N nu
  std::vector<double> slx, sux, slu, suu;          // slacks
  std::vector<double> llx, lux, llu, luu;          // duals
  // best iterate
  std::vector<double> b_dx, b_du, b_llx, b_lux, b_llu, b_luu;
  // scratch
  std::vector<double> Qmod, Rmod, qrhs, rrhs, req;
  std::vector<double> ddx, ddu;
  std::vector<double> d_slx, d_sux, d_slu, d_suu;
  std::vector<double> d_llx, d_lux, d_llu, d_luu;
  std::vector<double> Tlx, Tux, Tlu, Tuu;
  std::vector<double> a_slx, a_sux, a_slu, a_suu;
  std::vector<double> a_llx, a_lux, a_llu, a_luu;
  std::vector<double> tmp_xx, tmp_xu, tmp_ux, tmp_uu, tmp_x, tmp_u, p_vec;
};

struct Problem {
  int N, nx, nu;
  const double *A, *B, *c, *Q, *q, *R, *r, *lbx, *ubx, *lbu, *ubu, *dx0;
};

inline bool is_bnd(double v) { return std::isfinite(v) && std::abs(v) < kBig; }

// Factorize: P_k, K_k, chol(Huu)_k for modified Q/R.
bool factorize(const Problem& pb, const double* Qmod, const double* Rmod,
               double reg, Workspace& w) {
  const int N = pb.N, nx = pb.nx, nu = pb.nu;
  std::copy(Qmod + N * nx * nx, Qmod + (N + 1) * nx * nx,
            w.P.data() + N * nx * nx);
  std::vector<double>& PA = w.tmp_xx;  // nx*nx
  std::vector<double>& PB = w.tmp_xu;  // nx*nu
  std::vector<double>& Hux = w.tmp_ux; // nu*nx
  std::vector<double>& Huu = w.tmp_uu; // nu*nu
  for (int k = N - 1; k >= 0; --k) {
    const double* Pn = w.P.data() + (k + 1) * nx * nx;
    const double* Ak = pb.A + k * nx * nx;
    const double* Bk = pb.B + k * nx * nu;
    matmul(Pn, Ak, PA.data(), nx, nx, nx);
    matmul(Pn, Bk, PB.data(), nx, nx, nu);
    // Huu = R + B^T PB + reg I
    matTmul(Bk, PB.data(), Huu.data(), nx, nu, nu);
    const double* Rk = Rmod + k * nu * nu;
    for (int i = 0; i < nu * nu; ++i) Huu[i] += Rk[i];
    for (int i = 0; i < nu; ++i) Huu[i * nu + i] += reg;
    // Hux = B^T PA
    matTmul(Bk, PA.data(), Hux.data(), nx, nu, nx);
    double* Lk = w.L.data() + k * nu * nu;
    std::copy(Huu.begin(), Huu.begin() + nu * nu, Lk);
    if (!cholesky(Lk, nu)) return false;
    // K = -Huu^-1 Hux (column-wise solves)
    double* Kk = w.K.data() + k * nu * nx;
    std::vector<double> col(nu);
    for (int j = 0; j < nx; ++j) {
      for (int i = 0; i < nu; ++i) col[i] = Hux[i * nx + j];
      cho_solve(Lk, col.data(), nu);
      for (int i = 0; i < nu; ++i) Kk[i * nx + j] = -col[i];
    }
    // P_k = Q + A^T PA + Hux^T K
    double* Pk = w.P.data() + k * nx * nx;
    matTmul(Ak, PA.data(), Pk, nx, nx, nx);
    const double* Qk = Qmod + k * nx * nx;
    for (int i = 0; i < nx * nx; ++i) Pk[i] += Qk[i];
    for (int i = 0; i < nx; ++i)
      for (int j = 0; j < nx; ++j) {
        double acc = 0.0;
        for (int p = 0; p < nu; ++p) acc += Hux[p * nx + i] * Kk[p * nx + j];
        Pk[i * nx + j] += acc;
      }
    // symmetrize
    for (int i = 0; i < nx; ++i)
      for (int j = 0; j < i; ++j) {
        double s = 0.5 * (Pk[i * nx + j] + Pk[j * nx + i]);
        Pk[i * nx + j] = s;
        Pk[j * nx + i] = s;
      }
  }
  return true;
}

// RHS solve for gradients (qrhs, rrhs) and equality residual req.
void solve_rhs(const Problem& pb, const Workspace& w, const double* qrhs,
               const double* rrhs, const double* req, double* ddx,
               double* ddu, Workspace& scratch) {
  const int N = pb.N, nx = pb.nx, nu = pb.nu;
  std::vector<double>& p = scratch.p_vec;  // nx
  std::vector<double>& Pcp = scratch.tmp_x;
  std::vector<double>& Gu = scratch.tmp_u;
  std::vector<double> kffs(N * nu);
  std::copy(qrhs + N * nx, qrhs + (N + 1) * nx, p.data());
  for (int k = N - 1; k >= 0; --k) {
    const double* Pn = w.P.data() + (k + 1) * nx * nx;
    const double* Ak = pb.A + k * nx * nx;
    const double* Bk = pb.B + k * nx * nu;
    const double* ck = req + k * nx;
    // Pcp = Pn c + p
    matvec(Pn, ck, Pcp.data(), nx, nx);
    for (int i = 0; i < nx; ++i) Pcp[i] += p[i];
    // Gu = r + B^T Pcp
    std::copy(rrhs + k * nu, rrhs + (k + 1) * nu, Gu.data());
    matTvec_acc(Bk, Pcp.data(), Gu.data(), nx, nu);
    // kff = -Huu^-1 Gu
    double* kf = kffs.data() + k * nu;
    std::copy(Gu.begin(), Gu.begin() + nu, kf);
    cho_solve(w.L.data() + k * nu * nu, kf, nu);
    for (int i = 0; i < nu; ++i) kf[i] = -kf[i];
    // p_k = q + A^T Pcp + K^T Gu
    std::vector<double> pk(nx);
    std::copy(qrhs + k * nx, qrhs + (k + 1) * nx, pk.data());
    matTvec_acc(Ak, Pcp.data(), pk.data(), nx, nx);
    const double* Kk = w.K.data() + k * nu * nx;
    matTvec_acc(Kk, Gu.data(), pk.data(), nu, nx);
    std::copy(pk.begin(), pk.end(), p.data());
  }
  // forward rollout, ddx_0 = 0
  std::fill(ddx, ddx + nx, 0.0);
  for (int k = 0; k < N; ++k) {
    const double* Kk = w.K.data() + k * nu * nx;
    double* du_k = ddu + k * nu;
    matvec(Kk, ddx + k * nx, du_k, nu, nx);
    for (int i = 0; i < nu; ++i) du_k[i] += kffs[k * nu + i];
    const double* Ak = pb.A + k * nx * nx;
    const double* Bk = pb.B + k * nx * nu;
    double* nxt = ddx + (k + 1) * nx;
    matvec(Ak, ddx + k * nx, nxt, nx, nx);
    for (int i = 0; i < nx; ++i) {
      double acc = 0.0;
      const double* brow = Bk + i * nu;
      for (int j = 0; j < nu; ++j) acc += brow[j] * du_k[j];
      nxt[i] += acc + req[k * nx + i];
    }
  }
}

// KKT residuals of an iterate (stationarity via adjoint recursion).
void kkt_residuals(const Problem& pb, const double* dx, const double* du,
                   const double* llx, const double* lux, const double* llu,
                   const double* luu, double* out_stat, double* out_eq) {
  const int N = pb.N, nx = pb.nx, nu = pb.nu;
  std::vector<double> lam(nx), stat_u(nu), lam_next(nx);
  // lam_N
  matvec(pb.Q + N * nx * nx, dx + N * nx, lam.data(), nx, nx);
  for (int i = 0; i < nx; ++i) {
    lam[i] += pb.q[N * nx + i];
    double lb = pb.lbx[N * nx + i], ub = pb.ubx[N * nx + i];
    double bnd = (is_bnd(lb) ? llx[(N - 1) * nx + i] : 0.0) -
                 (is_bnd(ub) ? lux[(N - 1) * nx + i] : 0.0);
    lam[i] -= bnd;
  }
  double stat = 0.0, eq = 0.0;
  for (int k = N - 1; k >= 0; --k) {
    const double* Ak = pb.A + k * nx * nx;
    const double* Bk = pb.B + k * nx * nu;
    // control stationarity
    matvec(pb.R + k * nu * nu, du + k * nu, stat_u.data(), nu, nu);
    for (int i = 0; i < nu; ++i) stat_u[i] += pb.r[k * nu + i];
    matTvec_acc(Bk, lam.data(), stat_u.data(), nx, nu);
    for (int i = 0; i < nu; ++i) {
      double lb = pb.lbu[k * nu + i], ub = pb.ubu[k * nu + i];
      double bnd = (is_bnd(lb) ? llu[k * nu + i] : 0.0) -
                   (is_bnd(ub) ? luu[k * nu + i] : 0.0);
      stat_u[i] -= bnd;
      stat = std::max(stat, std::abs(stat_u[i]));
    }
    // equality residual
    for (int i = 0; i < nx; ++i) {
      double pred = pb.c[k * nx + i];
      const double* arow = Ak + i * nx;
      for (int j = 0; j < nx; ++j) pred += arow[j] * dx[k * nx + j];
      const double* brow = Bk + i * nu;
      for (int j = 0; j < nu; ++j) pred += brow[j] * du[k * nu + j];
      eq = std::max(eq, std::abs(pred - dx[(k + 1) * nx + i]));
    }
    // lam_k
    matvec(pb.Q + k * nx * nx, dx + k * nx, lam_next.data(), nx, nx);
    for (int i = 0; i < nx; ++i) lam_next[i] += pb.q[k * nx + i];
    matTvec_acc(Ak, lam.data(), lam_next.data(), nx, nx);
    if (k >= 1) {
      for (int i = 0; i < nx; ++i) {
        double lb = pb.lbx[k * nx + i], ub = pb.ubx[k * nx + i];
        double bnd = (is_bnd(lb) ? llx[(k - 1) * nx + i] : 0.0) -
                     (is_bnd(ub) ? lux[(k - 1) * nx + i] : 0.0);
        lam_next[i] -= bnd;
      }
    }
    std::copy(lam_next.begin(), lam_next.end(), lam.data());
  }
  *out_stat = stat;
  *out_eq = eq;
}

}  // namespace

extern "C" {

// Returns 0 on success, 1 if a Cholesky failed (reg too small / bad data).
int blaster_qp_solve(int N, int nx, int nu, const double* A, const double* B,
                     const double* c, const double* Q, const double* q,
                     const double* R, const double* r, const double* lbx,
                     const double* ubx, const double* lbu, const double* ubu,
                     const double* dx0, int iters, double mu0,
                     double alpha_frac, double reg, double* out_dx,
                     double* out_du, double* out_kkt_stat, double* out_kkt_eq,
                     double* out_mu) {
  Problem pb{N, nx, nu, A, B, c, Q, q, R, r, lbx, ubx, lbu, ubu, dx0};
  Workspace w;
  w.N = N; w.nx = nx; w.nu = nu;
  const int nX = (N + 1) * nx, nU = N * nu, nSx = N * nx;
  w.P.assign((N + 1) * nx * nx, 0.0);
  w.K.assign(N * nu * nx, 0.0);
  w.L.assign(N * nu * nu, 0.0);
  w.dx.assign(nX, 0.0); w.du.assign(nU, 0.0);
  w.slx.assign(nSx, kBig); w.sux.assign(nSx, kBig);
  w.slu.assign(nU, kBig); w.suu.assign(nU, kBig);
  w.llx.assign(nSx, 0.0); w.lux.assign(nSx, 0.0);
  w.llu.assign(nU, 0.0); w.luu.assign(nU, 0.0);
  w.Qmod.assign((N + 1) * nx * nx, 0.0); w.Rmod.assign(N * nu * nu, 0.0);
  w.qrhs.assign(nX, 0.0); w.rrhs.assign(nU, 0.0); w.req.assign(nSx, 0.0);
  w.ddx.assign(nX, 0.0); w.ddu.assign(nU, 0.0);
  w.d_slx.assign(nSx, 0.0); w.d_sux.assign(nSx, 0.0);
  w.d_slu.assign(nU, 0.0); w.d_suu.assign(nU, 0.0);
  w.d_llx.assign(nSx, 0.0); w.d_lux.assign(nSx, 0.0);
  w.d_llu.assign(nU, 0.0); w.d_luu.assign(nU, 0.0);
  w.Tlx.assign(nSx, 0.0); w.Tux.assign(nSx, 0.0);
  w.Tlu.assign(nU, 0.0); w.Tuu.assign(nU, 0.0);
  w.a_slx.assign(nSx, 0.0); w.a_sux.assign(nSx, 0.0);
  w.a_slu.assign(nU, 0.0); w.a_suu.assign(nU, 0.0);
  w.a_llx.assign(nSx, 0.0); w.a_lux.assign(nSx, 0.0);
  w.a_llu.assign(nU, 0.0); w.a_luu.assign(nU, 0.0);
  w.tmp_xx.assign(nx * nx, 0.0); w.tmp_xu.assign(nx * nu, 0.0);
  w.tmp_ux.assign(nu * nx, 0.0); w.tmp_uu.assign(nu * nu, 0.0);
  w.tmp_x.assign(nx, 0.0); w.tmp_u.assign(nu, 0.0); w.p_vec.assign(nx, 0.0);

  const double mu_min = 1e-12, s_min = 1e-3;
  const double sigma_max = 1e14, lam_max = 1e14, eps_s = 1e-16;

  // ----- initial point: rollout + 10%-width inset clamp -----
  std::copy(dx0, dx0 + nx, w.dx.data());
  for (int k = 0; k < N; ++k) {
    double* nxt = w.dx.data() + (k + 1) * nx;
    matvec(A + k * nx * nx, w.dx.data() + k * nx, nxt, nx, nx);
    for (int i = 0; i < nx; ++i) nxt[i] += c[k * nx + i];
    // du0 = 0, so no B term; clamp into bounds with 10% inset
    for (int i = 0; i < nx; ++i) {
      double lb = lbx[(k + 1) * nx + i], ub = ubx[(k + 1) * nx + i];
      bool fl = is_bnd(lb), fu = is_bnd(ub);
      double width = (fl && fu) ? (ub - lb) : 1.0;
      double inset = 0.1 * width;
      double lo = fl ? lb + inset : -kBig, hi = fu ? ub - inset : kBig;
      nxt[i] = std::min(std::max(nxt[i], lo), std::max(hi, lo));
    }
  }
  for (int k = 0; k < N; ++k)
    for (int i = 0; i < nu; ++i) {
      double lb = lbu[k * nu + i], ub = ubu[k * nu + i];
      bool fl = is_bnd(lb), fu = is_bnd(ub);
      double width = (fl && fu) ? (ub - lb) : 1.0;
      double inset = 0.1 * width;
      double lo = fl ? lb + inset : -kBig, hi = fu ? ub - inset : kBig;
      w.du[k * nu + i] = std::min(std::max(0.0, lo), std::max(hi, lo));
    }

  auto init_pair = [&](double gap, bool fin, double* s, double* l) {
    if (fin) { *s = std::max(gap, s_min); *l = mu0 / *s; }
    else { *s = kBig; *l = 0.0; }
  };
  int n_ineq = 0;
  for (int k = 0; k < N; ++k)
    for (int i = 0; i < nx; ++i) {
      int idx = k * nx + i;
      double v = w.dx[(k + 1) * nx + i];
      bool fl = is_bnd(lbx[(k + 1) * nx + i]), fu = is_bnd(ubx[(k + 1) * nx + i]);
      init_pair(v - lbx[(k + 1) * nx + i], fl, &w.slx[idx], &w.llx[idx]);
      init_pair(ubx[(k + 1) * nx + i] - v, fu, &w.sux[idx], &w.lux[idx]);
      n_ineq += fl + fu;
    }
  for (int k = 0; k < N; ++k)
    for (int i = 0; i < nu; ++i) {
      int idx = k * nu + i;
      bool fl = is_bnd(lbu[idx]), fu = is_bnd(ubu[idx]);
      init_pair(w.du[idx] - lbu[idx], fl, &w.slu[idx], &w.llu[idx]);
      init_pair(ubu[idx] - w.du[idx], fu, &w.suu[idx], &w.luu[idx]);
      n_ineq += fl + fu;
    }
  if (n_ineq == 0) n_ineq = 1;

  auto comp_sum = [&]() {
    double s = 0.0;
    for (int i = 0; i < nSx; ++i) {
      if (w.slx[i] < kBig) s += w.slx[i] * w.llx[i];
      if (w.sux[i] < kBig) s += w.sux[i] * w.lux[i];
    }
    for (int i = 0; i < nU; ++i) {
      if (w.slu[i] < kBig) s += w.slu[i] * w.llu[i];
      if (w.suu[i] < kBig) s += w.suu[i] * w.luu[i];
    }
    return s;
  };

  auto merit = [&](const double* dx, const double* du, const double* llx,
                   const double* lux, const double* llu, const double* luu,
                   double comp, double* ks, double* ke) {
    kkt_residuals(pb, dx, du, llx, lux, llu, luu, ks, ke);
    return *ks + *ke + comp / n_ineq;
  };

  // best iterate
  w.b_dx = w.dx; w.b_du = w.du;
  w.b_llx = w.llx; w.b_lux = w.lux; w.b_llu = w.llu; w.b_luu = w.luu;
  double ks, ke;
  double best_m = merit(w.dx.data(), w.du.data(), w.llx.data(), w.lux.data(),
                        w.llu.data(), w.luu.data(), comp_sum(), &ks, &ke);

  std::vector<double> r_slx(nSx), r_sux(nSx), r_slu(nU), r_suu(nU);
  std::vector<double> sig_x(nSx), sig_u(nU), gx(nX), gu(nU);

  for (int it = 0; it < iters; ++it) {
    double mu_cur = comp_sum() / n_ineq;

    // residuals + sigma
    for (int k = 0; k < N; ++k)
      for (int i = 0; i < nx; ++i) {
        int idx = k * nx + i;
        double v = w.dx[(k + 1) * nx + i];
        double lb = lbx[(k + 1) * nx + i], ub = ubx[(k + 1) * nx + i];
        r_slx[idx] = is_bnd(lb) ? w.slx[idx] - (v - lb) : 0.0;
        r_sux[idx] = is_bnd(ub) ? w.sux[idx] - (ub - v) : 0.0;
        double s = 0.0;
        if (is_bnd(lb)) s += w.llx[idx] / w.slx[idx];
        if (is_bnd(ub)) s += w.lux[idx] / w.sux[idx];
        sig_x[idx] = std::min(s, sigma_max);
      }
    for (int i = 0; i < nU; ++i) {
      double lb = lbu[i], ub = ubu[i];
      r_slu[i] = is_bnd(lb) ? w.slu[i] - (w.du[i] - lb) : 0.0;
      r_suu[i] = is_bnd(ub) ? w.suu[i] - (ub - w.du[i]) : 0.0;
      double s = 0.0;
      if (is_bnd(lb)) s += w.llu[i] / w.slu[i];
      if (is_bnd(ub)) s += w.luu[i] / w.suu[i];
      sig_u[i] = std::min(s, sigma_max);
    }

    // modified Hessians
    std::copy(Q, Q + (N + 1) * nx * nx, w.Qmod.data());
    for (int k = 0; k < N; ++k)
      for (int i = 0; i < nx; ++i)
        w.Qmod[(k + 1) * nx * nx + i * nx + i] += sig_x[k * nx + i];
    std::copy(R, R + N * nu * nu, w.Rmod.data());
    for (int k = 0; k < N; ++k)
      for (int i = 0; i < nu; ++i)
        w.Rmod[k * nu * nu + i * nu + i] += sig_u[k * nu + i];
    if (!factorize(pb, w.Qmod.data(), w.Rmod.data(), reg, w)) return 1;

    // gradients Hz + g
    for (int k = 0; k <= N; ++k) {
      matvec(Q + k * nx * nx, w.dx.data() + k * nx, gx.data() + k * nx, nx,
             nx);
      for (int i = 0; i < nx; ++i) gx[k * nx + i] += q[k * nx + i];
    }
    for (int k = 0; k < N; ++k) {
      matvec(R + k * nu * nu, w.du.data() + k * nu, gu.data() + k * nu, nu,
             nu);
      for (int i = 0; i < nu; ++i) gu[k * nu + i] += r[k * nu + i];
    }
    // equality residual of iterate
    for (int k = 0; k < N; ++k)
      for (int i = 0; i < nx; ++i) {
        double pred = c[k * nx + i];
        const double* arow = A + k * nx * nx + i * nx;
        for (int j = 0; j < nx; ++j) pred += arow[j] * w.dx[k * nx + j];
        const double* brow = B + k * nx * nu + i * nu;
        for (int j = 0; j < nu; ++j) pred += brow[j] * w.du[k * nu + j];
        w.req[k * nx + i] = pred - w.dx[(k + 1) * nx + i];
      }

    auto build_rhs = [&](const double* Tlx, const double* Tux,
                         const double* Tlu, const double* Tuu) {
      std::copy(gx.begin(), gx.end(), w.qrhs.begin());
      std::copy(gu.begin(), gu.end(), w.rrhs.begin());
      for (int k = 0; k < N; ++k)
        for (int i = 0; i < nx; ++i) {
          int idx = k * nx + i;
          double lb = lbx[(k + 1) * nx + i], ub = ubx[(k + 1) * nx + i];
          double add = 0.0;
          if (is_bnd(lb))
            add += -Tlx[idx] / w.slx[idx] -
                   (w.llx[idx] / w.slx[idx]) * r_slx[idx];
          if (is_bnd(ub))
            add += Tux[idx] / w.sux[idx] +
                   (w.lux[idx] / w.sux[idx]) * r_sux[idx];
          w.qrhs[(k + 1) * nx + i] += add;
        }
      for (int i = 0; i < nU; ++i) {
        double lb = lbu[i], ub = ubu[i];
        double add = 0.0;
        if (is_bnd(lb))
          add += -Tlu[i] / w.slu[i] - (w.llu[i] / w.slu[i]) * r_slu[i];
        if (is_bnd(ub))
          add += Tuu[i] / w.suu[i] + (w.luu[i] / w.suu[i]) * r_suu[i];
        w.rrhs[i] += add;
      }
    };

    auto directions = [&](const double* Tlx, const double* Tux,
                          const double* Tlu, const double* Tuu, double* dsl_x,
                          double* dsu_x, double* dsl_u, double* dsu_u,
                          double* dll_x, double* dlu_x, double* dll_u,
                          double* dlu_u) {
      build_rhs(Tlx, Tux, Tlu, Tuu);
      solve_rhs(pb, w, w.qrhs.data(), w.rrhs.data(), w.req.data(),
                w.ddx.data(), w.ddu.data(), w);
      for (int k = 0; k < N; ++k)
        for (int i = 0; i < nx; ++i) {
          int idx = k * nx + i;
          double lb = lbx[(k + 1) * nx + i], ub = ubx[(k + 1) * nx + i];
          double dz = w.ddx[(k + 1) * nx + i];
          dsl_x[idx] = is_bnd(lb) ? dz - r_slx[idx] : 0.0;
          dsu_x[idx] = is_bnd(ub) ? -dz - r_sux[idx] : 0.0;
          dll_x[idx] = is_bnd(lb)
              ? (Tlx[idx] - w.slx[idx] * w.llx[idx] -
                 w.llx[idx] * dsl_x[idx]) / w.slx[idx] : 0.0;
          dlu_x[idx] = is_bnd(ub)
              ? (Tux[idx] - w.sux[idx] * w.lux[idx] -
                 w.lux[idx] * dsu_x[idx]) / w.sux[idx] : 0.0;
        }
      for (int i = 0; i < nU; ++i) {
        double lb = lbu[i], ub = ubu[i];
        double dz = w.ddu[i];
        dsl_u[i] = is_bnd(lb) ? dz - r_slu[i] : 0.0;
        dsu_u[i] = is_bnd(ub) ? -dz - r_suu[i] : 0.0;
        dll_u[i] = is_bnd(lb)
            ? (Tlu[i] - w.slu[i] * w.llu[i] - w.llu[i] * dsl_u[i]) / w.slu[i]
            : 0.0;
        dlu_u[i] = is_bnd(ub)
            ? (Tuu[i] - w.suu[i] * w.luu[i] - w.luu[i] * dsu_u[i]) / w.suu[i]
            : 0.0;
      }
    };

    auto alphas = [&](const double* dsl_x, const double* dsu_x,
                      const double* dsl_u, const double* dsu_u,
                      const double* dll_x, const double* dlu_x,
                      const double* dll_u, const double* dlu_u, double tau,
                      double* a_p, double* a_d) {
      double ap = 1.0, ad = 1.0;
      auto upd = [&](double v, double dv, bool fin, double* a) {
        if (fin && dv < 0.0) *a = std::min(*a, -tau * v / dv);
      };
      for (int k = 0; k < N; ++k)
        for (int i = 0; i < nx; ++i) {
          int idx = k * nx + i;
          bool fl = is_bnd(lbx[(k + 1) * nx + i]);
          bool fu = is_bnd(ubx[(k + 1) * nx + i]);
          upd(w.slx[idx], dsl_x[idx], fl, &ap);
          upd(w.sux[idx], dsu_x[idx], fu, &ap);
          upd(w.llx[idx], dll_x[idx], fl, &ad);
          upd(w.lux[idx], dlu_x[idx], fu, &ad);
        }
      for (int i = 0; i < nU; ++i) {
        bool fl = is_bnd(lbu[i]), fu = is_bnd(ubu[i]);
        upd(w.slu[i], dsl_u[i], fl, &ap);
        upd(w.suu[i], dsu_u[i], fu, &ap);
        upd(w.llu[i], dll_u[i], fl, &ad);
        upd(w.luu[i], dlu_u[i], fu, &ad);
      }
      *a_p = std::min(ap, 1.0);
      *a_d = std::min(ad, 1.0);
    };

    // ---- predictor ----
    std::fill(w.Tlx.begin(), w.Tlx.end(), 0.0);
    std::fill(w.Tux.begin(), w.Tux.end(), 0.0);
    std::fill(w.Tlu.begin(), w.Tlu.end(), 0.0);
    std::fill(w.Tuu.begin(), w.Tuu.end(), 0.0);
    directions(w.Tlx.data(), w.Tux.data(), w.Tlu.data(), w.Tuu.data(),
               w.a_slx.data(), w.a_sux.data(), w.a_slu.data(),
               w.a_suu.data(), w.a_llx.data(), w.a_lux.data(),
               w.a_llu.data(), w.a_luu.data());
    double ap_aff, ad_aff;
    alphas(w.a_slx.data(), w.a_sux.data(), w.a_slu.data(), w.a_suu.data(),
           w.a_llx.data(), w.a_lux.data(), w.a_llu.data(), w.a_luu.data(),
           1.0, &ap_aff, &ad_aff);
    double mu_aff = 0.0;
    for (int i = 0; i < nSx; ++i) {
      if (w.slx[i] < kBig)
        mu_aff += (w.slx[i] + ap_aff * w.a_slx[i]) *
                  (w.llx[i] + ad_aff * w.a_llx[i]);
      if (w.sux[i] < kBig)
        mu_aff += (w.sux[i] + ap_aff * w.a_sux[i]) *
                  (w.lux[i] + ad_aff * w.a_lux[i]);
    }
    for (int i = 0; i < nU; ++i) {
      if (w.slu[i] < kBig)
        mu_aff += (w.slu[i] + ap_aff * w.a_slu[i]) *
                  (w.llu[i] + ad_aff * w.a_llu[i]);
      if (w.suu[i] < kBig)
        mu_aff += (w.suu[i] + ap_aff * w.a_suu[i]) *
                  (w.luu[i] + ad_aff * w.a_luu[i]);
    }
    mu_aff /= n_ineq;
    double ratio = mu_aff / std::max(mu_cur, mu_min);
    double sigma = std::min(std::max(ratio * ratio * ratio, 0.0), 1.0);
    double mu_t = std::max(sigma * mu_cur, mu_min);

    // ---- corrector with Gondzio clip ----
    auto target = [&](double ds, double dl) {
      double t = mu_t - ds * dl;
      return std::min(std::max(t, 0.05 * mu_t), 20.0 * mu_t);
    };
    for (int i = 0; i < nSx; ++i) {
      w.Tlx[i] = (w.slx[i] < kBig) ? target(w.a_slx[i], w.a_llx[i]) : 0.0;
      w.Tux[i] = (w.sux[i] < kBig) ? target(w.a_sux[i], w.a_lux[i]) : 0.0;
    }
    for (int i = 0; i < nU; ++i) {
      w.Tlu[i] = (w.slu[i] < kBig) ? target(w.a_slu[i], w.a_llu[i]) : 0.0;
      w.Tuu[i] = (w.suu[i] < kBig) ? target(w.a_suu[i], w.a_luu[i]) : 0.0;
    }
    directions(w.Tlx.data(), w.Tux.data(), w.Tlu.data(), w.Tuu.data(),
               w.d_slx.data(), w.d_sux.data(), w.d_slu.data(),
               w.d_suu.data(), w.d_llx.data(), w.d_lux.data(),
               w.d_llu.data(), w.d_luu.data());
    double a_p, a_d;
    alphas(w.d_slx.data(), w.d_sux.data(), w.d_slu.data(), w.d_suu.data(),
           w.d_llx.data(), w.d_lux.data(), w.d_llu.data(), w.d_luu.data(),
           alpha_frac, &a_p, &a_d);

    // ---- update ----
    for (int i = 0; i < nX; ++i) w.dx[i] += a_p * w.ddx[i];
    for (int i = 0; i < nU; ++i) w.du[i] += a_p * w.ddu[i];
    auto upd_s = [&](double* s, const double* ds, int n) {
      for (int i = 0; i < n; ++i)
        if (s[i] < kBig) s[i] = std::max(s[i] + a_p * ds[i], eps_s);
    };
    auto upd_l = [&](double* l, const double* dl, int n) {
      for (int i = 0; i < n; ++i)
        l[i] = std::min(std::max(l[i] + a_d * dl[i], 0.0), lam_max);
    };
    upd_s(w.slx.data(), w.d_slx.data(), nSx);
    upd_s(w.sux.data(), w.d_sux.data(), nSx);
    upd_s(w.slu.data(), w.d_slu.data(), nU);
    upd_s(w.suu.data(), w.d_suu.data(), nU);
    upd_l(w.llx.data(), w.d_llx.data(), nSx);
    upd_l(w.lux.data(), w.d_lux.data(), nSx);
    upd_l(w.llu.data(), w.d_llu.data(), nU);
    upd_l(w.luu.data(), w.d_luu.data(), nU);

    double m = merit(w.dx.data(), w.du.data(), w.llx.data(), w.lux.data(),
                     w.llu.data(), w.luu.data(), comp_sum(), &ks, &ke);
    if (m < best_m) {
      best_m = m;
      w.b_dx = w.dx; w.b_du = w.du;
      w.b_llx = w.llx; w.b_lux = w.lux; w.b_llu = w.llu; w.b_luu = w.luu;
    }
  }

  std::copy(w.b_dx.begin(), w.b_dx.end(), out_dx);
  std::copy(w.b_du.begin(), w.b_du.end(), out_du);
  kkt_residuals(pb, w.b_dx.data(), w.b_du.data(), w.b_llx.data(),
                w.b_lux.data(), w.b_llu.data(), w.b_luu.data(), out_kkt_stat,
                out_kkt_eq);
  // recompute complementarity of best iterate for out_mu
  double comp = 0.0;
  // (approximate: use final slacks against best duals is not meaningful;
  // report best-merit residual instead)
  *out_mu = best_m - (*out_kkt_stat + *out_kkt_eq);
  (void)comp;
  return 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Batched multi-threaded entry: scenario parallelism on the host CPU
// (the deployment analog of the device batch axis).

#include <atomic>
#include <thread>

extern "C" {

int blaster_qp_solve_batch(int batch, int n_threads, int N, int nx, int nu,
                           const double* A, const double* B, const double* c,
                           const double* Q, const double* q, const double* R,
                           const double* r, const double* lbx,
                           const double* ubx, const double* lbu,
                           const double* ubu, const double* dx0, int iters,
                           double mu0, double alpha_frac, double reg,
                           double* out_dx, double* out_du,
                           double* out_kkt_stat, double* out_kkt_eq,
                           double* out_mu) {
  if (n_threads <= 0) n_threads = 1;
  const long sA = (long)N * nx * nx, sB = (long)N * nx * nu;
  const long sc = (long)N * nx, sQ = (long)(N + 1) * nx * nx;
  const long sq = (long)(N + 1) * nx, sR = (long)N * nu * nu;
  const long sr = (long)N * nu, sbx = (long)(N + 1) * nx;
  const long sbu = (long)N * nu, sx0 = nx;
  const long sdx = (long)(N + 1) * nx, sdu = (long)N * nu;
  std::atomic<int> status{0};
  std::atomic<long> next{0};
  auto worker = [&]() {
    for (;;) {
      long i = next.fetch_add(1);
      if (i >= batch) return;
      int st = blaster_qp_solve(
          N, nx, nu, A + i * sA, B + i * sB, c + i * sc, Q + i * sQ,
          q + i * sq, R + i * sR, r + i * sr, lbx + i * sbx, ubx + i * sbx,
          lbu + i * sbu, ubu + i * sbu, dx0 + i * sx0, iters, mu0,
          alpha_frac, reg, out_dx + i * sdx, out_du + i * sdu,
          out_kkt_stat + i, out_kkt_eq + i, out_mu + i);
      if (st != 0) status.store(st);
    }
  };
  std::vector<std::thread> threads;
  for (int t = 0; t < n_threads; ++t) threads.emplace_back(worker);
  for (auto& th : threads) th.join();
  return status.load();
}

}  // extern "C"
