// qct_native — host-side native kernels for quantumcollocation_tpu.
//
// The reference stack's only native component is Ipopt's sparse KKT
// factorization (/root/reference/README.md:93). The framework solves its
// KKT systems on-device (solver/kkt.py); this library provides the host-side
// native complement:
//
//   1. qct_kkt_solve: an independent f64 block-tridiagonal symmetric
//      quasi-definite KKT factorization (stage-wise elimination, LAPACK-free
//      dense Cholesky per block) used as a correctness oracle for the device
//      scan and as a fast CPU fallback.
//   2. qct_unitary_rollout_fidelity: batched f64 ground-truth rollout
//      validation — scaling-and-squaring Padé expm of iso generators,
//      sequential in t — used by bench.py to validate thousands of solved
//      pulses quickly without trusting device arithmetic.
//
// Exposed with a plain C ABI for ctypes binding (no pybind11 dependency).
// Build: see native/build.sh (g++ -O3 -march=native -shared -fPIC).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// ---------- small dense helpers (row-major) ----------

// Cholesky factorization in place (lower). Returns 0 on success.
int cholesky(double* A, int n) {
  for (int j = 0; j < n; ++j) {
    double d = A[j * n + j];
    for (int k = 0; k < j; ++k) d -= A[j * n + k] * A[j * n + k];
    if (d <= 0.0 || !std::isfinite(d)) return 1;
    const double ljj = std::sqrt(d);
    A[j * n + j] = ljj;
    for (int i = j + 1; i < n; ++i) {
      double s = A[i * n + j];
      for (int k = 0; k < j; ++k) s -= A[i * n + k] * A[j * n + k];
      A[i * n + j] = s / ljj;
    }
  }
  return 0;
}

// Solve L L^T x = b for nrhs right-hand sides (b is n x nrhs row-major).
void chol_solve(const double* L, int n, double* b, int nrhs) {
  // forward: L y = b
  for (int i = 0; i < n; ++i) {
    for (int r = 0; r < nrhs; ++r) {
      double s = b[i * nrhs + r];
      for (int k = 0; k < i; ++k) s -= L[i * n + k] * b[k * nrhs + r];
      b[i * nrhs + r] = s / L[i * n + i];
    }
  }
  // backward: L^T x = y
  for (int i = n - 1; i >= 0; --i) {
    for (int r = 0; r < nrhs; ++r) {
      double s = b[i * nrhs + r];
      for (int k = i + 1; k < n; ++k) s -= L[k * n + i] * b[k * nrhs + r];
      b[i * nrhs + r] = s / L[i * n + i];
    }
  }
}

// C = A(m x k) * B(k x n), row-major; beta*C + A*B
void matmul(const double* A, const double* B, double* C, int m, int k, int n,
            double beta) {
  for (int i = 0; i < m; ++i)
    for (int j = 0; j < n; ++j) {
      double s = beta * C[i * n + j];
      for (int p = 0; p < k; ++p) s += A[i * k + p] * B[p * n + j];
      C[i * n + j] = s;
    }
}

// C = A^T(m x k -> k x m) * B(m x n)
void matmul_tn(const double* A, const double* B, double* C, int m, int k,
               int n, double beta) {
  for (int i = 0; i < k; ++i)
    for (int j = 0; j < n; ++j) {
      double s = beta * C[i * n + j];
      for (int p = 0; p < m; ++p) s += A[p * k + i] * B[p * n + j];
      C[i * n + j] = s;
    }
}

}  // namespace

extern "C" {

// Block-tridiagonal symmetric quasi-definite KKT solve (single instance).
//
//   [ H_t    C_t       A_t^T ] [dz_t  ]   [rz_t ]
//   [ C_t^T  H_{t+1}   B_t^T ] [dz_t+1] = [rz_t1]
//   [ A_t    B_t      -dc I  ] [nu_t  ]   [rnu_t]
//
// H: (T,d,d)  C: (T-1,d,d)  A,B: (T-1,s,d)  rz: (T,d)  rnu: (T-1,s)
// out_dz: (T,d)  out_nu: (T-1,s).  Returns 0 on success, 1 on factorization
// failure (non-quasi-definite).
int qct_kkt_solve(const double* H, const double* C, const double* A,
                  const double* B, const double* rz, const double* rnu,
                  double delta_c, int T, int d, int s, double* out_dz,
                  double* out_nu) {
  const int dd = d * d, ds = d * s, ss = s * s;
  std::vector<double> P(H, H + dd);            // current Schur complement
  std::vector<double> q(rz, rz + d);           // current reduced rhs
  std::vector<double> LPs((size_t)(T - 1) * dd), LSs((size_t)(T - 1) * ss),
      XAs((size_t)(T - 1) * ds), qs((size_t)(T - 1) * d);
  std::vector<double> XA(ds), XC(dd), x(d), S(ss), G(ds), y(s), tmp(ds);

  for (int t = 0; t < T - 1; ++t) {
    std::vector<double> LP(P);
    if (cholesky(LP.data(), d)) return 1;
    // XA = P^-1 A^T : solve with rhs A^T (d x s)
    for (int i = 0; i < d; ++i)
      for (int j = 0; j < s; ++j) XA[i * s + j] = A[t * ds + j * d + i];
    chol_solve(LP.data(), d, XA.data(), s);
    // XC = P^-1 C
    std::memcpy(XC.data(), C + (size_t)t * dd, sizeof(double) * dd);
    chol_solve(LP.data(), d, XC.data(), d);
    // x = P^-1 q
    std::memcpy(x.data(), q.data(), sizeof(double) * d);
    chol_solve(LP.data(), d, x.data(), 1);
    // S = dc I + A XA
    std::fill(S.begin(), S.end(), 0.0);
    matmul(A + (size_t)t * ds, XA.data(), S.data(), s, d, s, 0.0);
    for (int i = 0; i < s; ++i) S[i * s + i] += delta_c;
    std::vector<double> LS(S);
    if (cholesky(LS.data(), s)) return 1;
    // G = A XC - B
    matmul(A + (size_t)t * ds, XC.data(), G.data(), s, d, d, 0.0);
    for (int i = 0; i < ds; ++i) G[i] -= B[(size_t)t * ds + i];
    // y = S^-1 (A x - rnu_t)
    for (int i = 0; i < s; ++i) {
      double acc = -rnu[(size_t)t * s + i];
      for (int p = 0; p < d; ++p) acc += A[(size_t)t * ds + i * d + p] * x[p];
      y[i] = acc;
    }
    chol_solve(LS.data(), s, y.data(), 1);
    // P_next = H_{t+1} - C^T XC + G^T S^-1 G
    std::vector<double> Pn(H + (size_t)(t + 1) * dd,
                           H + (size_t)(t + 2) * dd);
    std::vector<double> CtXC(dd, 0.0);
    matmul_tn(C + (size_t)t * dd, XC.data(), CtXC.data(), d, d, d, 0.0);
    for (int i = 0; i < dd; ++i) Pn[i] -= CtXC[i];
    // + G^T S^-1 G
    std::vector<double> SG(G);
    chol_solve(LS.data(), s, SG.data(), d);
    matmul_tn(G.data(), SG.data(), Pn.data(), s, d, d, 1.0);
    // symmetrize
    for (int i = 0; i < d; ++i)
      for (int j = i + 1; j < d; ++j) {
        double v = 0.5 * (Pn[i * d + j] + Pn[j * d + i]);
        Pn[i * d + j] = Pn[j * d + i] = v;
      }
    // q_next = rz_{t+1} - C^T x + G^T y
    std::vector<double> qn(rz + (size_t)(t + 1) * d,
                           rz + (size_t)(t + 2) * d);
    for (int i = 0; i < d; ++i) {
      double acc = 0.0;
      for (int p = 0; p < d; ++p)
        acc += C[(size_t)t * dd + p * d + i] * x[p];
      qn[i] -= acc;
      double accg = 0.0;
      for (int p = 0; p < s; ++p) accg += G[p * d + i] * y[p];
      qn[i] += accg;
    }
    // save factors for backward pass
    std::memcpy(LPs.data() + (size_t)t * dd, LP.data(), sizeof(double) * dd);
    std::memcpy(LSs.data() + (size_t)t * ss, LS.data(), sizeof(double) * ss);
    std::memcpy(XAs.data() + (size_t)t * ds, XA.data(), sizeof(double) * ds);
    std::memcpy(qs.data() + (size_t)t * d, q.data(), sizeof(double) * d);
    P.swap(Pn);
    q.assign(qn.begin(), qn.end());
  }

  // terminal solve
  std::vector<double> LF(P);
  if (cholesky(LF.data(), d)) return 1;
  std::vector<double> dz_next(q);
  chol_solve(LF.data(), d, dz_next.data(), 1);
  std::memcpy(out_dz + (size_t)(T - 1) * d, dz_next.data(),
              sizeof(double) * d);

  // backward substitution
  std::vector<double> u(d), v(s);
  for (int t = T - 2; t >= 0; --t) {
    // u = q_t - C_t dz_next ; v = rnu_t - B_t dz_next
    for (int i = 0; i < d; ++i) {
      double acc = qs[(size_t)t * d + i];
      for (int p = 0; p < d; ++p)
        acc -= C[(size_t)t * dd + i * d + p] * dz_next[p];
      u[i] = acc;
    }
    for (int i = 0; i < s; ++i) {
      double acc = rnu[(size_t)t * s + i];
      for (int p = 0; p < d; ++p)
        acc -= B[(size_t)t * ds + i * d + p] * dz_next[p];
      v[i] = acc;
    }
    // x = P^-1 u ; y = S^-1 (A x - v); dz = x - XA y
    std::memcpy(x.data(), u.data(), sizeof(double) * d);
    chol_solve(LPs.data() + (size_t)t * dd, d, x.data(), 1);
    for (int i = 0; i < s; ++i) {
      double acc = -v[i];
      for (int p = 0; p < d; ++p) acc += A[(size_t)t * ds + i * d + p] * x[p];
      y[i] = acc;
    }
    chol_solve(LSs.data() + (size_t)t * ss, s, y.data(), 1);
    for (int i = 0; i < d; ++i) {
      double acc = x[i];
      for (int p = 0; p < s; ++p)
        acc -= XAs[(size_t)t * ds + i * s + p] * y[p];
      dz_next[i] = acc;
    }
    std::memcpy(out_dz + (size_t)t * d, dz_next.data(), sizeof(double) * d);
    std::memcpy(out_nu + (size_t)t * s, y.data(), sizeof(double) * s);
  }
  return 0;
}

// Batched ground-truth unitary rollout fidelity.
//
// Gd: (2N,2N) iso drift generator; Gs: (m,2N,2N) iso drive generators;
// a: (B,T,m) controls; dts: (B,T) timesteps; Ugoal_iso: (2N,N) iso of goal;
// out_fid: (B,) |tr(U_goal^† U_T)|/N computed in f64.
// Uses order-8 Padé with adaptive squaring per step.
void qct_unitary_rollout_fidelity(const double* Gd, const double* Gs,
                                  const double* a, const double* dts,
                                  const double* Ugoal_iso, int B, int T,
                                  int m, int N, double* out_fid) {
  const int n = 2 * N;          // iso dimension
  const int nn = n * n;
  // Padé-8 coefficients of q_4(x)
  const double c[5] = {1.0, 0.5, 3.0 / 28.0, 1.0 / 84.0, 1.0 / 1680.0};

  std::vector<double> X(nn), X2(nn), X3(nn), X4(nn), Anum(nn), Bden(nn),
      P(nn), U(n * N), Unext(n * N);

  for (int b = 0; b < B; ++b) {
    // U = iso identity (2N x N): [I; 0]
    std::fill(U.begin(), U.end(), 0.0);
    for (int i = 0; i < N; ++i) U[i * N + i] = 1.0;

    for (int t = 0; t < T - 1; ++t) {
      const double dt = dts[(size_t)b * T + t];
      // X = (Gd + sum a_j Gs_j) * dt
      for (int i = 0; i < nn; ++i) X[i] = Gd[i];
      for (int j = 0; j < m; ++j) {
        const double aj = a[((size_t)b * T + t) * m + j];
        const double* Gj = Gs + (size_t)j * nn;
        for (int i = 0; i < nn; ++i) X[i] += aj * Gj[i];
      }
      // scaling: ||X*dt||_inf -> squarings
      double norm = 0.0;
      for (int i = 0; i < n; ++i) {
        double row = 0.0;
        for (int j2 = 0; j2 < n; ++j2) row += std::fabs(X[i * n + j2] * dt);
        if (row > norm) norm = row;
      }
      int sq = 0;
      double scaled = norm;
      while (scaled > 0.5 && sq < 30) {
        scaled *= 0.5;
        ++sq;
      }
      const double scale = dt * std::ldexp(1.0, -sq);
      for (int i = 0; i < nn; ++i) X[i] *= scale;
      // powers
      matmul(X.data(), X.data(), X2.data(), n, n, n, 0.0);
      matmul(X2.data(), X.data(), X3.data(), n, n, n, 0.0);
      matmul(X2.data(), X2.data(), X4.data(), n, n, n, 0.0);
      // A = c0 I + c1 X + c2 X2 + c3 X3 + c4 X4 ; B = alternating signs
      for (int i = 0; i < nn; ++i) {
        const double id = (i / n == i % n) ? 1.0 : 0.0;
        Anum[i] = c[0] * id + c[1] * X[i] + c[2] * X2[i] + c[3] * X3[i] +
                  c[4] * X4[i];
        Bden[i] = c[0] * id - c[1] * X[i] + c[2] * X2[i] - c[3] * X3[i] +
                  c[4] * X4[i];
      }
      // P = Bden^-1 Anum via Gaussian elimination with partial pivoting
      std::vector<double> M(Bden), R(Anum);
      std::vector<int> piv(n);
      for (int i = 0; i < n; ++i) piv[i] = i;
      for (int col = 0; col < n; ++col) {
        int p = col;
        for (int r = col + 1; r < n; ++r)
          if (std::fabs(M[r * n + col]) > std::fabs(M[p * n + col])) p = r;
        if (p != col) {
          for (int k = 0; k < n; ++k) {
            std::swap(M[col * n + k], M[p * n + k]);
            std::swap(R[col * n + k], R[p * n + k]);
          }
        }
        const double pivval = M[col * n + col];
        for (int r = 0; r < n; ++r) {
          if (r == col) continue;
          const double f = M[r * n + col] / pivval;
          if (f == 0.0) continue;
          for (int k = col; k < n; ++k) M[r * n + k] -= f * M[col * n + k];
          for (int k = 0; k < n; ++k) R[r * n + k] -= f * R[col * n + k];
        }
      }
      for (int r = 0; r < n; ++r) {
        const double f = M[r * n + r];
        for (int k = 0; k < n; ++k) P[r * n + k] = R[r * n + k] / f;
      }
      // squaring
      for (int sqi = 0; sqi < sq; ++sqi) {
        matmul(P.data(), P.data(), X2.data(), n, n, n, 0.0);
        P.swap(X2);
      }
      // U = P U
      matmul(P.data(), U.data(), Unext.data(), n, n, N, 0.0);
      U.swap(Unext);
    }

    // fidelity: complex trace of Ugoal^† U; iso layout rows [Re; Im]
    double re = 0.0, im = 0.0;
    for (int ccol = 0; ccol < N; ++ccol)
      for (int r = 0; r < N; ++r) {
        const double gr = Ugoal_iso[r * N + ccol];
        const double gi = Ugoal_iso[(N + r) * N + ccol];
        const double ur = U[r * N + ccol];
        const double ui = U[(N + r) * N + ccol];
        re += gr * ur + gi * ui;
        im += gr * ui - gi * ur;
      }
    out_fid[b] = std::sqrt(re * re + im * im) / N;
  }
}

}  // extern "C"
