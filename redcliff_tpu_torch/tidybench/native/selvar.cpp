// SELVAR — Selective auto-regressive model: native core.
//
// Copy of redcliff_tpu/tidybench/native/selvar.cpp for the PyTorch port
// (host C++, built with g++ into build/host_native/ and bound with ctypes by
// redcliff_tpu_torch/tidybench/native/__init__.py). It is the C++ equivalent
// of the reference's one in-repo native component, tidybench/selvarF.f (462
// lines of Fortran 77, f2py + LAPACK DGELS/DORGQR). Same algorithm, fresh
// implementation:
//
//   * per-target hill climb over (source, lag) edge assignments, scored by the
//     leave-one-out PRESS statistic  sum_t (e_t / (1 - h_t))^2  accumulated
//     over batches of consecutive time points;
//   * optional adaptive max-lag mode (maxlags < 0): the lag ceiling starts at
//     1 and grows by one per hill-climb iteration, capped at T/2;
//   * final scores are batch-averaged |OLS coefficients| of the selected model
//     (GTCOEF "ABS"), with optional variance normalization;
//   * per-edge likelihood-ratio / F / delta-RSS statistics (GTSTAT).
//
// Where the Fortran ran LAPACK DGELS (QR least squares) + DORGQR (explicit Q
// for leverages), this uses normal equations with a Cholesky factorization:
// beta = (D'D)^-1 D'y and leverage h_t = d_t' (D'D)^-1 d_t. Deliberate
// divergence: the Fortran called DORGQR with M=NV, forming only the first NV
// rows of Q, then read all BS rows of the workspace (selvarF.f:193-204) — so
// its h_t for rows beyond NV were Householder-workspace remnants, not
// leverages. This implementation computes the true PRESS leverage for every
// row; selected structures can therefore differ from the Fortran's on
// borderline candidates (in favor of the correct statistic). Singular designs
// score as -1 (infeasible) instead of returning a partial score.
//
// Matrix conventions: X is row-major (T, N); A and B are row-major (N, N) with
// A[i*N + j] = the lag of edge i -> j (0 = edge absent).

#include <cmath>
#include <cstring>
#include <vector>

namespace {

// Cholesky factorization G = L L' in place (lower triangle). Returns false if
// G is not positive definite (singular design).
bool cholesky(std::vector<double>& G, int p) {
  for (int c = 0; c < p; ++c) {
    double diag = G[c * p + c];
    for (int k = 0; k < c; ++k) diag -= G[c * p + k] * G[c * p + k];
    if (!(diag > 0.0)) return false;
    diag = std::sqrt(diag);
    G[c * p + c] = diag;
    for (int r = c + 1; r < p; ++r) {
      double v = G[r * p + c];
      for (int k = 0; k < c; ++k) v -= G[r * p + k] * G[c * p + k];
      G[r * p + c] = v / diag;
    }
  }
  return true;
}

// Solve L z = b in place (forward), then optionally L' x = z (backward).
void forward_solve(const std::vector<double>& L, int p, double* b) {
  for (int r = 0; r < p; ++r) {
    double v = b[r];
    for (int k = 0; k < r; ++k) v -= L[r * p + k] * b[k];
    b[r] = v / L[r * p + r];
  }
}

void backward_solve(const std::vector<double>& L, int p, double* b) {
  for (int r = p - 1; r >= 0; --r) {
    double v = b[r];
    for (int k = r + 1; k < p; ++k) v -= L[k * p + r] * b[k];
    b[r] = v / L[r * p + r];
  }
}

// Batched design for target j under edge/lag assignment column A[., j].
// Row t of D is [1, X[t0 - lag_i, i] for each i with lag_i > 0], where
// t0 = ML + k*BS + t ranges over batch k's target rows.
struct Design {
  int p = 0;                 // columns (1 + #active sources)
  std::vector<int> src;      // active source indices
  std::vector<int> lag;      // their lags
};

Design active_set(const int* A, int N, int j) {
  Design d;
  d.p = 1;
  for (int i = 0; i < N; ++i) {
    int l = A[i * N + j];
    if (l > 0) {
      d.src.push_back(i);
      d.lag.push_back(l);
      ++d.p;
    }
  }
  return d;
}

// Effective batch size: the Fortran clamps the caller's BS in place on every
// scoring call (pass-by-reference), so the clamp persists across calls as the
// adaptive max-lag grows. bs is therefore in-out here too.
int clamp_bs(int* bs, int T, int ML) {
  if (*bs < 0) *bs = (T - ML) / (-*bs);
  if (*bs == 0) *bs = T - ML;  // guard: the Fortran documented but never
                               // handled BS == 0 (integer division SIGFPE)
  if (*bs > T - ML) *bs = T - ML;
  return *bs;
}

int clamp_ml(int ML, int T) { return (ML >= T || ML < 1) ? 1 : ML; }

// Leave-one-out PRESS for target j. Returns -1 if infeasible/singular.
double press_score(int T, int N, const double* X, int ML, int* bs,
                   const int* A, int j) {
  ML = clamp_ml(ML, T);
  int BS = clamp_bs(bs, T, ML);
  Design d = active_set(A, N, j);
  if (d.p > BS) return -1.0;
  int NF = (T - ML) / BS;
  if (NF < 1) return -1.0;

  std::vector<double> D(BS * d.p), G(d.p * d.p), beta(d.p), col(d.p);
  double score = 0.0;
  for (int k = 0; k < NF; ++k) {
    int base = ML + k * BS;
    for (int t = 0; t < BS; ++t) {
      D[t * d.p] = 1.0;
      for (size_t s = 0; s < d.src.size(); ++s)
        D[t * d.p + 1 + s] = X[(base + t - d.lag[s]) * N + d.src[s]];
    }
    // G = D'D, rhs = D'y
    std::fill(G.begin(), G.end(), 0.0);
    std::fill(beta.begin(), beta.end(), 0.0);
    for (int t = 0; t < BS; ++t) {
      double y = X[(base + t) * N + j];
      for (int a = 0; a < d.p; ++a) {
        beta[a] += D[t * d.p + a] * y;
        for (int b = 0; b <= a; ++b) G[a * d.p + b] += D[t * d.p + a] * D[t * d.p + b];
      }
    }
    for (int a = 0; a < d.p; ++a)
      for (int b = a + 1; b < d.p; ++b) G[a * d.p + b] = G[b * d.p + a];
    if (!cholesky(G, d.p)) return -1.0;
    forward_solve(G, d.p, beta.data());
    backward_solve(G, d.p, beta.data());
    for (int t = 0; t < BS; ++t) {
      double y = X[(base + t) * N + j], pred = 0.0;
      for (int a = 0; a < d.p; ++a) {
        pred += D[t * d.p + a] * beta[a];
        col[a] = D[t * d.p + a];
      }
      forward_solve(G, d.p, col.data());  // z = L^-1 d_t ; h_t = |z|^2
      double h = 0.0;
      for (int a = 0; a < d.p; ++a) h += col[a] * col[a];
      double e = (y - pred) / (1.0 - h);
      score += e * e;
    }
  }
  return score;
}

// OLS fit of target j on one batch. Returns false on singularity.
bool batch_ols(int T, int N, const double* X, int base, int BS, int j,
               const Design& d, std::vector<double>& beta, double* rss) {
  std::vector<double> D(BS * d.p), G(d.p * d.p);
  beta.assign(d.p, 0.0);
  for (int t = 0; t < BS; ++t) {
    D[t * d.p] = 1.0;
    for (size_t s = 0; s < d.src.size(); ++s)
      D[t * d.p + 1 + s] = X[(base + t - d.lag[s]) * N + d.src[s]];
  }
  std::fill(G.begin(), G.end(), 0.0);
  for (int t = 0; t < BS; ++t) {
    double y = X[(base + t) * N + j];
    for (int a = 0; a < d.p; ++a) {
      beta[a] += D[t * d.p + a] * y;
      for (int b = 0; b <= a; ++b) G[a * d.p + b] += D[t * d.p + a] * D[t * d.p + b];
    }
  }
  for (int a = 0; a < d.p; ++a)
    for (int b = a + 1; b < d.p; ++b) G[a * d.p + b] = G[b * d.p + a];
  if (!cholesky(G, d.p)) return false;
  forward_solve(G, d.p, beta.data());
  backward_solve(G, d.p, beta.data());
  if (rss) {
    double acc = 0.0;
    for (int t = 0; t < BS; ++t) {
      double y = X[(base + t) * N + j], pred = 0.0;
      for (int a = 0; a < d.p; ++a) pred += D[t * d.p + a] * beta[a];
      acc += (y - pred) * (y - pred);
    }
    *rss = acc;
  }
  return true;
}

}  // namespace

extern "C" {

// Batch-averaged coefficients of the selected model (GTCOEF equivalent).
// job: 0 = raw, 1 = |coef|, 2 = coef^2. nrm > 0 normalizes by residual
// variances: B_ij / sqrt(B_ij^2 + V_j / V_i).
int selvar_gtcoef(int T, int N, const double* X, int ML, int BS, const int* A,
                  int job, int nrm, double* B) {
  // A lag larger than ML would index before the series start; infer/raise ML
  // from the lag matrix (the reference's GTCOEF read out of bounds here).
  for (int idx = 0; idx < N * N; ++idx) ML = std::max(ML, A[idx]);
  ML = clamp_ml(ML, T);
  clamp_bs(&BS, T, ML);
  int NF = (T - ML) / BS;
  std::vector<double> V(N, 0.0), beta;
  std::memset(B, 0, sizeof(double) * N * N);
  for (int j = 0; j < N; ++j) {
    Design d = active_set(A, N, j);
    for (int k = 0; k < NF; ++k) {
      double rss = 0.0;
      if (!batch_ols(T, N, X, ML + k * BS, BS, j, d, beta, &rss)) continue;
      V[j] += rss / (double(BS) * NF);
      for (size_t s = 0; s < d.src.size(); ++s) {
        double c = beta[1 + s];
        double v = (job == 1) ? std::fabs(c) : (job == 2) ? c * c : c;
        B[d.src[s] * N + j] += v / NF;
      }
    }
  }
  if (nrm > 0)
    for (int j = 0; j < N; ++j)
      for (int i = 0; i < N; ++i) {
        double b = B[i * N + j];
        B[i * N + j] = b / std::sqrt(b * b + V[j] / V[i]);
      }
  return 0;
}

// Mean residual sum of squares for target j (GTRSS equivalent).
double selvar_gtrss(int T, int N, const double* X, int ML, int BS,
                    const int* A, int j) {
  // guard for direct callers: a lag in A larger than ML would index before
  // the series start (no-op when the caller already raised ML, as gtstat does
  // before computing its NF/BS normalization)
  for (int idx = 0; idx < N * N; ++idx) ML = std::max(ML, A[idx]);
  ML = clamp_ml(ML, T);
  clamp_bs(&BS, T, ML);
  int NF = (T - ML) / BS;
  Design d = active_set(A, N, j);
  std::vector<double> beta;
  double score = 0.0;
  for (int k = 0; k < NF; ++k) {
    double rss = 0.0;
    if (batch_ols(T, N, X, ML + k * BS, BS, j, d, beta, &rss)) score += rss;
  }
  return score / (double(NF) * BS);
}

// Per-edge statistics (GTSTAT equivalent). job: 0 = delta-RSS, 1 = log
// likelihood ratio, 2 = F statistic. DF is (N, 2) row-major.
int selvar_gtstat(int T, int N, const double* X, int ML, int BS, int* A,
                  int job, double* B, int* DF) {
  // one consistent lag ceiling for the whole statistic: at least every lag in
  // A (a smaller explicit ML would index before the series start), inferred
  // entirely from A when ML < 1 as in the Fortran
  for (int idx = 0; idx < N * N; ++idx) ML = std::max(ML, A[idx]);
  ML = clamp_ml(ML, T);
  clamp_bs(&BS, T, ML);
  int NF = (T - ML) / BS;
  std::memset(B, 0, sizeof(double) * N * N);
  for (int j = 0; j < N; ++j) {
    DF[j * 2] = 0;
    double full = selvar_gtrss(T, N, X, ML, BS, A, j);
    for (int i = 0; i < N; ++i) {
      if (A[i * N + j] <= 0) continue;
      DF[j * 2] += NF;
      int saved = A[i * N + j];
      A[i * N + j] = 0;
      double reduced = selvar_gtrss(T, N, X, ML, BS, A, j);
      A[i * N + j] = saved;
      if (job == 2) B[i * N + j] = (reduced - full) / full;
      else if (job == 1) B[i * N + j] = (std::log(reduced) - std::log(full)) * NF * BS;
      else B[i * N + j] = reduced - full;
    }
    DF[j * 2 + 1] = DF[j * 2] - NF;
  }
  if (job == 2)
    for (int j = 0; j < N; ++j) {
      DF[j * 2 + 1] = BS * NF - DF[j * 2];
      DF[j * 2] = NF;
      for (int i = 0; i < N; ++i) B[i * N + j] *= DF[j * 2 + 1];
    }
  return 0;
}

// Full SELVAR: hill-climb structure/lag selection + ABS coefficient scores
// (SLVAR equivalent). Returns the number of hill-climb iterations of the last
// target; fills B (scores) and A (selected lags).
int selvar_slvar(int T, int N, const double* X, int BS, int ML, int MXITR,
                 double* B, int* A) {
  int adaptive = (ML < 1) ? 1 : 0;
  ML = clamp_ml(ML, T);
  clamp_bs(&BS, T, ML);
  std::memset(A, 0, sizeof(int) * N * N);
  int itr = 0;
  if (MXITR != 0) {
    for (int j = 0; j < N; ++j) {
      itr = 0;
      if (adaptive) ML = 1;
      double scr = press_score(T, N, X, ML, &BS, A, j);
      bool improved = true;
      while (improved && (MXITR < 0 || itr < MXITR)) {
        ++itr;
        improved = false;
        double best = scr;
        int ibst = -1, kbst = 0;
        for (int K = 0; K <= ML; ++K)
          for (int i = 0; i < N; ++i) {
            int cur = A[i * N + j];
            if (K == cur) continue;
            A[i * N + j] = K;
            double s = press_score(T, N, X, ML, &BS, A, j);
            A[i * N + j] = cur;
            if (s >= 0.0 && s < best) {
              best = s;
              ibst = i;
              kbst = K;
            }
          }
        if (ibst >= 0) {
          A[ibst * N + j] = kbst;
          scr = best;
          improved = true;
        }
        if (adaptive) ML = std::min(ML + 1, T / 2);
      }
    }
  }
  selvar_gtcoef(T, N, X, ML, BS, A, /*job=*/1, /*nrm=*/0, B);
  return itr;
}

}  // extern "C"
