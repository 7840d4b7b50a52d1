"""Host high-accuracy MPC oracle: scipy ``trust-constr`` on the split form.

Port of kmpc_tpu/ops/mpc_oracle.py (numpy in and out, on the host by
nature). The oracle solves the exact program of the solvers in
ops/mpc.py, reformulated with auxiliary absolute-value variables, with
scipy's trust-region interior-point method; the verification stack holds
the card's solves against it (parity_cdf.py, chip_smoke.py's
``verify_path``). No solver entry of the package hands a solve to it.

Log-utility program:

    max  sum_t log(w_t . exp(y_t)) - c * sum_t ||w_t - w_{t-1}||_1
    s.t. sum(w_t) = 1;  w_t >= 0 (no-short);  ||w_t - w_{t-1}||_1 <= tau
    (w_{-1} = current_weights; the turnover constraint holds for every t,
     t=0 included)

Split form: variables x = [w, s], s >= |D w - b| elementwise, giving a
smooth objective with linear constraints that trust-constr solves to
~1e-9 feasibility/optimality.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import scipy.optimize as spo
import scipy.sparse as sp


def _difference_operator(H: int, N: int) -> sp.csr_matrix:
    """D such that (D w)_t = w_t - w_{t-1} (w_{-1} handled via offset b)."""
    eye = sp.identity(H * N, format="csr")
    sub = sp.eye(H * N, k=-N, format="csr")
    return (eye - sub).tocsr()


def solve_mpc_log_utility_oracle(
    current_weights: np.ndarray,
    predicted_log_returns: np.ndarray,
    cost_coeff: float = 0.001,
    max_turnover: float = 0.2,
    allow_short: bool = False,
    tol: float = 1e-12,
    max_iter: int = 3000,
    ridge: float = 0.0,
) -> Tuple[np.ndarray, Dict]:
    """High-accuracy solve of the log-utility MPC. Returns ([H,N], info).

    ``ridge`` adds the same eps/2 ||w||^2 tie-breaker as
    ``MPCParams.ridge``: on the program's near-flat optimal faces the
    optimum is otherwise non-unique and any two solvers can disagree in
    weights while agreeing in objective; matching the ridge on both
    sides makes weight-level parity well-posed."""
    H, N = predicted_log_returns.shape
    r = np.exp(predicted_log_returns)  # gross returns
    n = H * N

    D = _difference_operator(H, N)
    b = np.zeros(n)
    b[:N] = current_weights

    def unpack(x):
        return x[:n].reshape(H, N), x[n:].reshape(H, N)

    def fun(x):
        w, s = unpack(x)
        port = np.einsum("tn,tn->t", w, r)
        return (
            -np.sum(np.log(np.maximum(port, 1e-300)))
            + cost_coeff * np.sum(s)
            + 0.5 * ridge * np.sum(w * w)
        )

    def jac(x):
        w, s = unpack(x)
        port = np.einsum("tn,tn->t", w, r)
        gw = -(r / np.maximum(port, 1e-300)[:, None]) + ridge * w
        return np.concatenate([gw.ravel(), np.full(n, cost_coeff)])

    def hess(x):
        # Exact Hessian: block-diagonal r_t r_t' / (w_t.r_t)^2 over t (plus
        # the ridge diagonal); zero in the s block. Quasi-Newton
        # approximations are unreliable on this nearly-linear objective,
        # so the exact Hessian is essential.
        w, s = unpack(x)
        port = np.maximum(np.einsum("tn,tn->t", w, r), 1e-300)
        blocks = [
            np.outer(r[t], r[t]) / port[t] ** 2 + ridge * np.eye(N)
            for t in range(H)
        ]
        Hw = sp.block_diag(blocks, format="csr")
        return sp.block_diag([Hw, sp.csr_matrix((n, n))], format="csr")

    # Equality: sum_i w_{t,i} = 1 for each t.
    A_eq = sp.kron(sp.identity(H), np.ones((1, N)), format="csr")
    A_eq = sp.hstack([A_eq, sp.csr_matrix((H, n))], format="csr")
    eq_con = spo.LinearConstraint(A_eq, np.ones(H), np.ones(H))

    # |D w - b| <= s  =>  D w - s <= b  and  -D w - s <= -b.
    I_s = sp.identity(n, format="csr")
    A_abs1 = sp.hstack([D, -I_s], format="csr")
    A_abs2 = sp.hstack([-D, -I_s], format="csr")
    abs_con1 = spo.LinearConstraint(A_abs1, -np.inf, b)
    abs_con2 = spo.LinearConstraint(A_abs2, -np.inf, -b)

    constraints = [eq_con, abs_con1, abs_con2]

    if max_turnover > 0:
        A_to = sp.kron(sp.identity(H), np.ones((1, N)), format="csr")
        A_to = sp.hstack([sp.csr_matrix((H, n)), A_to], format="csr")
        constraints.append(spo.LinearConstraint(A_to, -np.inf, np.full(H, max_turnover)))

    w_lo = -np.inf if allow_short else 0.0
    lb = np.concatenate([np.full(n, w_lo), np.zeros(n)])
    ub = np.full(2 * n, np.inf)
    bounds = spo.Bounds(lb, ub)

    # Feasible start: hold current weights (u = 0 feasible for any tau >= 0).
    w0 = np.tile(np.asarray(current_weights, dtype=float), (H, 1))
    if not allow_short:
        w0 = np.maximum(w0, 0.0)
        w0 = w0 / np.maximum(w0.sum(axis=1, keepdims=True), 1e-12)
    u0 = (D @ w0.ravel() - b).reshape(H, N)
    s0 = np.abs(u0) + 1e-6
    x0 = np.concatenate([w0.ravel(), s0.ravel()])

    res = spo.minimize(
        fun, x0, jac=jac, hess=hess, method="trust-constr",
        constraints=constraints, bounds=bounds,
        options={"gtol": tol, "xtol": tol, "maxiter": max_iter, "verbose": 0},
    )
    w_opt, _ = unpack(res.x)
    info = {
        "status": "optimal" if res.status in (1, 2) else f"status_{res.status}",
        "value": -res.fun,
        "niter": res.niter,
        "constr_violation": float(res.constr_violation),
    }
    if res.status not in (1, 2):
        # Not solved: hold the current weights, as the solvers do.
        return np.tile(current_weights, (H, 1)), info
    return w_opt, info


def solve_mpc_mean_variance_oracle(
    current_weights: np.ndarray,
    predicted_log_returns: np.ndarray,
    cov_matrix: np.ndarray,
    gamma: float = 1.0,
    cost_coeff: float = 0.001,
    allow_short: bool = False,
    tol: float = 1e-12,
    max_iter: int = 3000,
) -> Tuple[np.ndarray, Dict]:
    """High-accuracy mean-variance MPC.

    max sum_t w_t.mu_t - gamma w_t'Sigma w_t - c||w_t - w_{t-1}||_1
    s.t. sum(w_t)=1, w_t>=0 (no-short). No turnover-ball constraint in the
    reference MV program.
    """
    H, N = predicted_log_returns.shape
    mu = predicted_log_returns
    Sigma = 0.5 * (cov_matrix + cov_matrix.T)
    n = H * N

    D = _difference_operator(H, N)
    b = np.zeros(n)
    b[:N] = current_weights

    def unpack(x):
        return x[:n].reshape(H, N), x[n:].reshape(H, N)

    def fun(x):
        w, s = unpack(x)
        quad = gamma * np.einsum("tn,nm,tm->", w, Sigma, w)
        lin = np.einsum("tn,tn->", w, mu)
        return quad - lin + cost_coeff * np.sum(s)

    def jac(x):
        w, s = unpack(x)
        gw = 2.0 * gamma * w @ Sigma - mu
        return np.concatenate([gw.ravel(), np.full(n, cost_coeff)])

    def hess(x):
        Hw = sp.kron(sp.identity(H), 2.0 * gamma * Sigma, format="csr")
        return sp.block_diag([Hw, sp.csr_matrix((n, n))], format="csr")

    A_eq = sp.kron(sp.identity(H), np.ones((1, N)), format="csr")
    A_eq = sp.hstack([A_eq, sp.csr_matrix((H, n))], format="csr")
    eq_con = spo.LinearConstraint(A_eq, np.ones(H), np.ones(H))

    I_s = sp.identity(n, format="csr")
    abs_con1 = spo.LinearConstraint(sp.hstack([D, -I_s], format="csr"), -np.inf, b)
    abs_con2 = spo.LinearConstraint(sp.hstack([-D, -I_s], format="csr"), -np.inf, -b)

    w_lo = -np.inf if allow_short else 0.0
    bounds = spo.Bounds(
        np.concatenate([np.full(n, w_lo), np.zeros(n)]), np.full(2 * n, np.inf)
    )

    w0 = np.tile(np.asarray(current_weights, dtype=float), (H, 1))
    if not allow_short:
        w0 = np.maximum(w0, 0.0)
        w0 = w0 / np.maximum(w0.sum(axis=1, keepdims=True), 1e-12)
    u0 = (D @ w0.ravel() - b).reshape(H, N)
    x0 = np.concatenate([w0.ravel(), (np.abs(u0) + 1e-6).ravel()])

    res = spo.minimize(
        fun, x0, jac=jac, hess=hess, method="trust-constr",
        constraints=[eq_con, abs_con1, abs_con2], bounds=bounds,
        options={"gtol": tol, "xtol": tol, "maxiter": max_iter, "verbose": 0},
    )
    w_opt, _ = unpack(res.x)
    info = {
        "status": "optimal" if res.status in (1, 2) else f"status_{res.status}",
        "value": -res.fun,
        "niter": res.niter,
    }
    if res.status not in (1, 2):
        return np.tile(current_weights, (H, 1)), info
    return w_opt, info
