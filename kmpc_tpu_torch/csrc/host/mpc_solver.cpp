// Batched host MPC solver (C ABI, OpenMP over problems): the package's
// independent host cross-check of its card solvers.
//
// The same Condat-Vu PDHG iteration as kmpc_tpu_torch/ops/mpc.py (same
// splitting, same Michelot projections) in double precision, parallelised
// over the problem batch with OpenMP. No solver entry of the package hands
// a solve to it: it is called only to hold the card's solutions against an
// implementation that shares no code with them.
//
// Build:  g++ -O3 -fopenmp -shared -fPIC -o libkmpc_native.so mpc_solver.cpp
// (kmpc_tpu_torch/native/__init__.py builds it at first use into
// kmpc_tpu_torch/_build/, named by a hash of this source and the flags)

#include <cmath>
#include <cstring>
#include <vector>
#include <algorithm>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

// Michelot threshold: sum(max(v - theta, 0)) == radius over n entries.
// Finite convergence; 16 sweeps cover any active-set path at these sizes.
double simplex_threshold(const double* v, int n, double radius) {
    double s = 0.0;
    for (int i = 0; i < n; ++i) s += v[i];
    double theta = (s - radius) / n;
    for (int it = 0; it < 16; ++it) {
        double acc = 0.0;
        int count = 0;
        for (int i = 0; i < n; ++i) {
            if (v[i] > theta) { acc += v[i]; ++count; }
        }
        if (count == 0) break;
        double next = (acc - radius) / count;
        if (next == theta) break;
        theta = next;
    }
    return theta;
}

void project_simplex(double* v, int n) {
    double theta = simplex_threshold(v, n, 1.0);
    for (int i = 0; i < n; ++i) v[i] = std::max(v[i] - theta, 0.0);
}

void project_hyperplane(double* v, int n) {
    double s = 0.0;
    for (int i = 0; i < n; ++i) s += v[i];
    double shift = (s - 1.0) / n;
    for (int i = 0; i < n; ++i) v[i] -= shift;
}

// prox of (c/sig)*||.||_1 + indicator(||.||_1 <= tau) applied to q/sig,
// then Moreau: q - sig * prox.
void prox_phi_conj_row(double* q, int n, double sig, double c, double tau,
                       bool use_ball, std::vector<double>& scratch) {
    scratch.resize(n);
    double l1 = 0.0;
    for (int i = 0; i < n; ++i) {
        double vi = q[i] / sig;
        double sh = std::copysign(std::max(std::abs(vi) - c / sig, 0.0), vi);
        scratch[i] = sh;
        l1 += std::abs(sh);
    }
    if (use_ball && l1 > tau) {
        std::vector<double> a(n);
        for (int i = 0; i < n; ++i) a[i] = std::abs(scratch[i]);
        double theta = std::max(simplex_threshold(a.data(), n, tau), 0.0);
        for (int i = 0; i < n; ++i) {
            scratch[i] = std::copysign(std::max(a[i] - theta, 0.0), scratch[i]);
        }
    }
    for (int i = 0; i < n; ++i) q[i] -= sig * scratch[i];
}

void solve_one(const float* cw, const float* y, int H, int N,
               double cost_coeff, double max_turnover, bool allow_short,
               int max_iters, double sigma_scale, double step_scale,
               double ridge, float* out) {
    const int n = H * N;
    std::vector<double> r(n), w(n), p(n), w_init(N), grad(n), wn(n), q(N);
    std::vector<double> scratch;

    for (int i = 0; i < n; ++i) r[i] = std::exp((double)y[i]);
    for (int j = 0; j < N; ++j) w_init[j] = (double)cw[j];

    // Lipschitz bound: max_t ||r_t||^2 / min_i(r_{t,i})^2.
    double L = 0.0;
    for (int t = 0; t < H; ++t) {
        double n2 = 0.0, mn = 1e300;
        for (int j = 0; j < N; ++j) {
            double v = r[t * N + j];
            n2 += v * v;
            mn = std::min(mn, v);
        }
        L = std::max(L, n2 / std::max(mn * mn, 1e-24));
    }
    L += ridge;
    const double sigma = sigma_scale * std::sqrt(L) / 2.0;
    const double tau_p = step_scale / (0.5 * L + sigma * 4.0);
    const bool use_ball = max_turnover > 0.0;

    // w0: projected current weights tiled over the horizon.
    for (int j = 0; j < N; ++j) q[j] = w_init[j];
    if (allow_short) project_hyperplane(q.data(), N);
    else project_simplex(q.data(), N);
    for (int t = 0; t < H; ++t)
        for (int j = 0; j < N; ++j) w[t * N + j] = q[j];
    std::fill(p.begin(), p.end(), 0.0);

    for (int it = 0; it < max_iters; ++it) {
        // grad g + D' p ; primal prox.
        for (int t = 0; t < H; ++t) {
            double port = 0.0;
            for (int j = 0; j < N; ++j) port += w[t * N + j] * r[t * N + j];
            port = std::max(port, 1e-12);
            for (int j = 0; j < N; ++j) {
                double dtp = p[t * N + j] -
                             (t + 1 < H ? p[(t + 1) * N + j] : 0.0);
                grad[t * N + j] =
                    -r[t * N + j] / port + ridge * w[t * N + j] + dtp;
            }
        }
        for (int t = 0; t < H; ++t) {
            double* row = &wn[t * N];
            for (int j = 0; j < N; ++j)
                row[j] = w[t * N + j] - tau_p * grad[t * N + j];
            if (allow_short) project_hyperplane(row, N);
            else project_simplex(row, N);
        }
        // dual update on u = D(2 w+ - w) - b.
        for (int t = 0; t < H; ++t) {
            for (int j = 0; j < N; ++j) {
                double wb = 2.0 * wn[t * N + j] - w[t * N + j];
                double wb_prev =
                    (t == 0) ? w_init[j]
                             : 2.0 * wn[(t - 1) * N + j] - w[(t - 1) * N + j];
                q[j] = p[t * N + j] + sigma * (wb - wb_prev);
            }
            prox_phi_conj_row(q.data(), N, sigma, cost_coeff, max_turnover,
                              use_ball, scratch);
            for (int j = 0; j < N; ++j) p[t * N + j] = q[j];
        }
        std::swap(w, wn);
    }

    for (int i = 0; i < n; ++i) out[i] = (float)w[i];
}

// Mean-variance program (the Markowitz baseline's per-date solve):
//   min_w  sum_t [gamma w_t' Sigma w_t - w_t.mu_t] + c sum_t ||u_t||_1
//   s.t.   w_t in simplex
// Same Condat-Vu splitting as kmpc_tpu_torch/ops/mpc.py's
// solve_mpc_mean_variance_batch (no turnover ball, so the dual prox is a
// plain clip to [-c, c]).
void solve_one_mv(const float* cw, const float* mu_in, const float* sig_in,
                  int H, int N, double gamma, double cost_coeff,
                  bool allow_short, int max_iters, double sigma_scale,
                  double step_scale, float* out) {
    const int n = H * N;
    std::vector<double> mu(n), Sig(N * N), w(n), p(n), w_init(N), grad(n),
        wn(n), q(N);

    for (int i = 0; i < n; ++i) mu[i] = (double)mu_in[i];
    for (int j = 0; j < N; ++j) w_init[j] = (double)cw[j];
    // Symmetrize Sigma (matches the JAX solver).
    for (int a = 0; a < N; ++a)
        for (int b = 0; b < N; ++b)
            Sig[a * N + b] =
                0.5 * ((double)sig_in[a * N + b] + (double)sig_in[b * N + a]);

    // L_g = 2 gamma ||Sigma||_2 <= 2 gamma ||Sigma||_F.
    double fro2 = 0.0;
    for (int i = 0; i < N * N; ++i) fro2 += Sig[i] * Sig[i];
    const double L = std::max(2.0 * gamma * std::sqrt(fro2), 1e-6);
    const double sigma = sigma_scale * std::sqrt(L + 1.0) / 2.0;
    const double tau_p = step_scale / (0.5 * L + sigma * 4.0);

    for (int j = 0; j < N; ++j) q[j] = w_init[j];
    if (allow_short) project_hyperplane(q.data(), N);
    else project_simplex(q.data(), N);
    for (int t = 0; t < H; ++t)
        for (int j = 0; j < N; ++j) w[t * N + j] = q[j];
    std::fill(p.begin(), p.end(), 0.0);

    for (int it = 0; it < max_iters; ++it) {
        for (int t = 0; t < H; ++t) {
            const double* wt = &w[t * N];
            for (int m = 0; m < N; ++m) {
                double quad = 0.0;
                for (int j = 0; j < N; ++j) quad += Sig[m * N + j] * wt[j];
                double dtp = p[t * N + m] -
                             (t + 1 < H ? p[(t + 1) * N + m] : 0.0);
                grad[t * N + m] = 2.0 * gamma * quad - mu[t * N + m] + dtp;
            }
        }
        for (int t = 0; t < H; ++t) {
            double* row = &wn[t * N];
            for (int j = 0; j < N; ++j)
                row[j] = w[t * N + j] - tau_p * grad[t * N + j];
            if (allow_short) project_hyperplane(row, N);
            else project_simplex(row, N);
        }
        for (int t = 0; t < H; ++t) {
            for (int j = 0; j < N; ++j) {
                double wb = 2.0 * wn[t * N + j] - w[t * N + j];
                double wb_prev =
                    (t == 0) ? w_init[j]
                             : 2.0 * wn[(t - 1) * N + j] - w[(t - 1) * N + j];
                double pj = p[t * N + j] + sigma * (wb - wb_prev);
                p[t * N + j] = std::min(std::max(pj, -cost_coeff), cost_coeff);
            }
        }
        std::swap(w, wn);
    }

    for (int i = 0; i < n; ++i) out[i] = (float)w[i];
}

}  // namespace

extern "C" {

int kmpc_solve_mean_variance(const float* current_weights, const float* mu,
                             const float* sigma_mats, int B, int H, int N,
                             float gamma, float cost_coeff, int allow_short,
                             int max_iters, float sigma_scale,
                             float step_scale, float* out_weights) {
    if (B <= 0 || H <= 0 || N <= 0 || max_iters < 0) return 1;
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic)
#endif
    for (int b = 0; b < B; ++b) {
        solve_one_mv(current_weights + (size_t)b * N,
                     mu + (size_t)b * H * N, sigma_mats + (size_t)b * N * N,
                     H, N, gamma, cost_coeff, allow_short != 0, max_iters,
                     sigma_scale, step_scale, out_weights + (size_t)b * H * N);
    }
    return 0;
}

int kmpc_solve_log_utility(const float* current_weights,
                           const float* pred_log_returns, int B, int H, int N,
                           float cost_coeff, float max_turnover,
                           int allow_short, int max_iters, float sigma_scale,
                           float step_scale, float ridge, float* out_weights) {
    if (B <= 0 || H <= 0 || N <= 0 || max_iters < 0) return 1;
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic)
#endif
    for (int b = 0; b < B; ++b) {
        solve_one(current_weights + (size_t)b * N,
                  pred_log_returns + (size_t)b * H * N, H, N, cost_coeff,
                  max_turnover, allow_short != 0, max_iters, sigma_scale,
                  step_scale, ridge, out_weights + (size_t)b * H * N);
    }
    return 0;
}

int kmpc_num_threads() {
#ifdef _OPENMP
    return omp_get_max_threads();
#else
    return 1;
#endif
}

}  // extern "C"
