"""Batched first-order MPC solvers (log-utility and mean-variance) in
eager PyTorch, with their parameters, step sizes, restoration and status.

Port of kmpc_tpu/ops/mpc.py. The log-utility program, with r_t = exp(y_t):

    min_w  -sum_t log(w_t . r_t) + c * sum_t ||u_t||_1
    s.t.   w_t on the simplex,  ||u_t||_1 <= tau  for every t,
           u_t = w_t - w_{t-1},  w_{-1} = current weights,

solved by a Condat-Vu primal-dual iteration:

    w+ = prox_{tau h}(w - tau (grad g(w) + D' p))
    p+ = prox_{sigma phi*}(p + sigma (D (2 w+ - w) - b)),

with prox_{sigma phi*}(q) = q - sigma prox_{phi/sigma}(q/sigma). The eager
solvers here carry the whole parameter surface (``allow_short``,
``adaptive``, warm starts) and broadcast over any leading batch axes; the
fused CUDA solves are in ops/mpc_cuda.py and ops/mv_cuda.py.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from kmpc_tpu_torch.ops.projections import (
    project_hyperplane_sum,
    project_simplex,
    project_simplex_warm,
    prox_l1_in_ball,
    prox_l1_in_ball_warm,
    soft_threshold,
)


@dataclass(frozen=True)
class MPCParams:
    """Static solver configuration; fields and defaults are those of
    kmpc_tpu.ops.mpc.MPCParams."""

    horizon: int = 5
    gamma: float = 0.0
    cost_coeff: float = 0.001
    max_turnover: float = 0.2
    allow_short: bool = False
    max_iters: int = 2000
    step_scale: float = 1.0
    sigma_scale: float = 1.0
    feas_tol: float = 1e-5
    over_relax: float = 1.0       # rho in (0, 2); 1 = plain PDHG
    ridge: float = 0.0            # eps/2 ||w||^2 tie-breaker
    restore_feasibility: bool = True  # exact turnover-cap restoration
    proj_warm_iters: int = 3      # Michelot sweeps per projection from the
                                  # carried threshold; 0 = cold full-budget
                                  # projections every iteration
    polish: bool = False          # float64 verification path (ops/mpc_polish.py)
    polish_newton: int = 4
    adaptive: bool = False        # residual-balancing adaptive steps
    adapt_every: int = 1
    precond: bool = False         # per-horizon-row diagonal steps
    pipeline_reduces: bool = False  # one-iteration-stale ball reductions
    proj_refresh_every: int = 0   # >1: one warm sweep per iteration, the
                                  # full budget every k-th


def reject_unhonored_polish(params: MPCParams, entry: str) -> None:
    """Refuse ``params.polish``: the float64 polish is a verification path
    that a batched solve does not run; ``solve_mpc_log_utility`` and
    ``mpc_polish.solve_mpc_log_utility_batch_polished`` run it."""
    if params.polish:
        raise ValueError(
            f"MPCParams.polish is the float64 verification path, which "
            f"{entry} does not run: call solve_mpc_log_utility or "
            "mpc_polish.solve_mpc_log_utility_batch_polished, or unset "
            "cfg.MPC.SOLVER.POLISH for hot-path solves."
        )


# Status bands: residual <= feas_tol is optimal, a finite residual above it
# optimal_inaccurate (the iterate is returned), a non-finite one a failure
# (the current weights are held).
STATUS_OPTIMAL = 0
STATUS_OPTIMAL_INACCURATE = 1
STATUS_FAILURE = 2
STATUS_STRINGS = ("optimal", "optimal_inaccurate", "failure")


def _status_code(fp_res: torch.Tensor, feas_tol: float) -> torch.Tensor:
    """Per-problem status band (int32) from the fixed-point residual."""
    finite = torch.isfinite(fp_res)
    code = torch.where(fp_res <= feas_tol, STATUS_OPTIMAL,
                       STATUS_OPTIMAL_INACCURATE)
    return torch.where(finite, code, STATUS_FAILURE).to(torch.int32)


def _pdhg_steps(Lt: torch.Tensor, params: MPCParams) -> Tuple[torch.Tensor, torch.Tensor]:
    """Condat-Vu steps (tau, sigma) from per-row curvature bounds Lt [..., H].

    Uniform: L = max_t L_t, sigma = s0 = sigma_scale*sqrt(L)/2 and
    tau = step_scale/(L/2 + 4*s0), shapes [..., 1, 1]. ``precond``: per
    horizon row, sigma_t = 2*s0/rowdeg_t and
    tau_t = step_scale/(L_t/2 + 2*s0*coldeg_t), rowdeg 1 for t=0 (the
    difference against the constant current weights) and coldeg 1 for
    t=H-1, shapes [..., H, 1].
    """
    H = Lt.shape[-1]
    L = Lt.amax(dim=-1)[..., None, None]
    s0 = params.sigma_scale * torch.sqrt(L) / 2.0
    if not params.precond:
        return params.step_scale / (0.5 * L + s0 * 4.0), s0
    rowdeg = torch.full((H, 1), 2.0, dtype=Lt.dtype, device=Lt.device)
    rowdeg[0] = 1.0
    coldeg = torch.full((H, 1), 2.0, dtype=Lt.dtype, device=Lt.device)
    coldeg[H - 1] = 1.0
    sigma = 2.0 * s0 / rowdeg
    tau = params.step_scale / (0.5 * Lt[..., None] + 2.0 * s0 * coldeg)
    return tau, sigma


def mpc_params_from_config(cfg, **overrides) -> MPCParams:
    """MPCParams from a Config's MPC section (keyword overrides win)."""
    base = dict(
        horizon=cfg.MPC.HORIZON,
        gamma=cfg.MPC.GAMMA,
        cost_coeff=cfg.MPC.COST_COEFF,
        max_turnover=cfg.MPC.MAX_TURNOVER,
        allow_short=cfg.MPC.ALLOW_SHORT,
        max_iters=cfg.MPC.SOLVER.MAX_ITERS,
        step_scale=cfg.MPC.SOLVER.STEP_SCALE,
        over_relax=cfg.MPC.SOLVER.OVER_RELAX,
        adaptive=cfg.MPC.SOLVER.ADAPTIVE,
        adapt_every=cfg.MPC.SOLVER.ADAPT_EVERY,
        precond=cfg.MPC.SOLVER.PRECOND,
        pipeline_reduces=cfg.MPC.SOLVER.PIPELINE_REDUCES,
        proj_refresh_every=cfg.MPC.SOLVER.PROJ_REFRESH_EVERY,
        polish=cfg.MPC.SOLVER.POLISH,
        polish_newton=cfg.MPC.SOLVER.POLISH_NEWTON,
    )
    if cfg.MPC.SOLVER.TOL > 0:
        base["feas_tol"] = cfg.MPC.SOLVER.TOL
    base.update(overrides)
    return MPCParams(**base)


def _prev_rows(w: torch.Tensor, w_init: torch.Tensor) -> torch.Tensor:
    """[w_init, w_0, ..., w_{H-2}] along the horizon axis (-2)."""
    return torch.cat([w_init[..., None, :], w[..., :-1, :]], dim=-2)


def restore_turnover_feasibility(
    w: torch.Tensor, w_init: torch.Tensor, max_turnover: float
) -> torch.Tensor:
    """Pull each horizon step onto the turnover cap along the segment to
    the previous (restored) row; convex combinations of simplex points stay
    on the simplex, so every constraint then holds exactly."""
    prev = w_init
    rows = []
    for t in range(w.shape[-2]):
        ut = w[..., t, :] - prev
        l1 = ut.abs().sum(dim=-1, keepdim=True)
        scale = torch.clamp(max_turnover / torch.clamp(l1, min=1e-12), max=1.0)
        prev = prev + scale * ut
        rows.append(prev)
    return torch.stack(rows, dim=-2)


def _log_utility_objective(w, r, w_init, cost_coeff):
    """Objective in maximization form: sum_t log(w_t . r_t) - c sum |u|."""
    port = (w * r).sum(dim=-1)
    log_growth = torch.log(torch.clamp(port, min=1e-30)).sum(dim=-1)
    u = w - _prev_rows(w, w_init)
    return log_growth - cost_coeff * u.abs().sum(dim=(-2, -1))


# ---------------------------------------------------------------------------
# Eager solvers
# ---------------------------------------------------------------------------


def _apply_D(w: torch.Tensor, w_init: torch.Tensor) -> torch.Tensor:
    """u_t = w_t - w_{t-1} with w_{-1} = w_init."""
    return w - _prev_rows(w, w_init)


def _apply_Dt(p: torch.Tensor) -> torch.Tensor:
    """(D' p)_t = p_t - p_{t+1}."""
    nxt = torch.cat([p[..., 1:, :], torch.zeros_like(p[..., :1, :])], dim=-2)
    return p - nxt


def _balance_steps(pr, dr, tau_c, sig_c, alpha_c):
    """Residual-balancing step adaptation: when the primal residual
    exceeds the dual one by more than 1.5x, grow tau and shrink sigma by
    (1 - alpha), and the other way round; alpha decays by 0.95 on every
    adaptation, so the total adaptation is finite."""
    big_p = pr > 1.5 * dr
    big_d = dr > 1.5 * pr
    shrink_f = 1.0 - alpha_c
    tau_n = torch.where(big_p, tau_c / shrink_f,
                        torch.where(big_d, tau_c * shrink_f, tau_c))
    sig_n = torch.where(big_p, sig_c * shrink_f,
                        torch.where(big_d, sig_c / shrink_f, sig_c))
    alpha_n = torch.where(big_p | big_d, alpha_c * 0.95, alpha_c)
    return tau_n, sig_n, alpha_n


def _adaptive_update(i: int, params: MPCParams, w, w_new, p, p_new,
                     tau_c, sig_c, alpha_c):
    """Step update of the adaptive bodies. With ``adapt_every = k > 1`` the
    residuals are taken only on the last iteration of each k-block."""
    k = params.adapt_every
    if k > 1 and i % k != k - 1:
        return tau_c, sig_c, alpha_c
    dw = w - w_new
    dp = p - p_new
    pr = torch.sqrt(((dw / tau_c - _apply_Dt(dp)) ** 2)
                    .sum(dim=(-2, -1)))[..., None, None]
    dr = torch.sqrt(((dp / sig_c - _apply_D(dw, torch.zeros_like(dw[..., 0, :])))
                     ** 2).sum(dim=(-2, -1)))[..., None, None]
    return _balance_steps(pr, dr, tau_c, sig_c, alpha_c)


def _primal_projection(params: MPCParams):
    if params.allow_short:
        return lambda v: project_hyperplane_sum(v, 1.0)
    return lambda v: project_simplex(v, 1.0)


def _pdhg_loop(params: MPCParams, grad_g, w_init, w0, p0, tau_p, sigma,
               dual: str):
    """The Condat-Vu loop shared by the eager solvers: ``grad_g(w)`` is the
    smooth gradient; ``dual`` names the dual prox: ``"ball"`` (l1 cost and
    turnover ball, by Moreau), ``"soft"`` (l1 cost alone, by Moreau) or
    ``"clip"`` (the same as a clip of the dual to [-c, c]). Returns
    (w, p, tau_final). Warm Michelot thresholds start from zero."""
    c = params.cost_coeff
    tau_to = params.max_turnover
    rho = params.over_relax
    warm = params.proj_warm_iters > 0 and not params.allow_short
    proj_primal = _primal_projection(params)

    def step(i, w, p, th_w, th_p, tau_c, sig_c, alpha_c):
        v = w - tau_c * (grad_g(w) + _apply_Dt(p))
        if warm:
            w_new, th_w = project_simplex_warm(v, 1.0, th_w,
                                               params.proj_warm_iters)
        else:
            w_new = proj_primal(v)
        q = p + sig_c * _apply_D(2.0 * w_new - w, w_init)
        if dual == "clip":
            p_new = torch.clamp(q, -c, c)
        else:
            if dual == "soft":
                inner = soft_threshold(q / sig_c, c / sig_c)
            elif warm:
                inner, th_p = prox_l1_in_ball_warm(
                    q / sig_c, c / sig_c, tau_to, th_p,
                    params.proj_warm_iters)
            else:
                inner = prox_l1_in_ball(q / sig_c, c / sig_c, tau_to)
            p_new = q - sig_c * inner
        if params.adaptive:
            tau_c, sig_c, alpha_c = _adaptive_update(
                i, params, w, w_new, p, p_new, tau_c, sig_c, alpha_c)
        if rho != 1.0:
            w_new = w + rho * (w_new - w)
            p_new = p + rho * (p_new - p)
        return w_new, p_new, th_w, th_p, tau_c, sig_c, alpha_c

    th_w = torch.zeros(w0.shape[:-1] + (1,), dtype=w0.dtype, device=w0.device)
    sig_c = sigma.expand(tau_p.shape)
    state = (w0, p0, th_w, th_w, tau_p, sig_c, torch.full_like(tau_p, 0.5))
    w, p, _, _, tau_c, _, _ = _iterate(step, state, params.max_iters)
    return w, p, tau_c


def _iterate(step, state, n: int):
    """``state = step(i, *state)`` for i = 0 .. n - 1: the loop of
    ``_pdhg_loop``. It is looked up at each solve, so that a caller may run
    the same steps another way (``graph_replayed``)."""
    for i in range(n):
        state = step(i, *state)
    return state


def graph_replay(chunk: int, eager=_iterate):
    """An ``_iterate`` that runs the iterations on CUDA tensors as replays
    of one CUDA graph of ``chunk`` iterations, captured on the current
    stream of the tensors' card: the kernels of the eager loop in its order
    on the same values, without the host's cost per operation, and the
    remainder eagerly. ``chunk`` is a multiple of the solve's
    ``adapt_every``, so each replay follows the loop's schedule. CPU tensors
    and solves shorter than ``chunk`` run ``eager``."""

    def iterate(step, state, n):
        trips = n // chunk
        if trips == 0 or not state[0].is_cuda:
            return eager(step, state, n)
        with torch.cuda.device(state[0].device):
            static = [x.clone(memory_format=torch.contiguous_format)
                      for x in state]
            # A warm-up step on a side stream sets up the libraries'
            # handles and workspaces outside the capture.
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                step(0, *[x.clone() for x in static])
            torch.cuda.current_stream().wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                out = tuple(static)
                for j in range(chunk):
                    out = step(j, *out)
                for s, o in zip(static, out):
                    s.copy_(o)
            for _ in range(trips):
                graph.replay()
        state = tuple(static)
        for i in range(trips * chunk, n):
            state = step(i, *state)
        return state

    return iterate


@contextlib.contextmanager
def graph_replayed(chunk: int):
    """The eager solvers' loop replayed as CUDA graphs (``graph_replay``)
    within the block."""
    global _iterate
    eager = _iterate
    _iterate = graph_replay(chunk, eager)
    try:
        yield
    finally:
        _iterate = eager


def _log_utility_tail(params: MPCParams, w, w_last, w_init):
    """Residual, turnover restoration, convergence and hold-on-failure of
    the log-utility solvers: (w_out, fp_res, to_viol, converged)."""
    tau_to = params.max_turnover
    use_ball = tau_to > 0
    fp_res = (w_last - w).abs().amax(dim=(-2, -1))
    if use_ball:
        u = _apply_D(w_last, w_init)
        to_viol = torch.clamp(u.abs().sum(dim=-1) - tau_to, min=0.0).amax(dim=-1)
        if params.restore_feasibility:
            w_last = restore_turnover_feasibility(w_last, w_init, tau_to)
    else:
        to_viol = torch.zeros(w_last.shape[:-2], dtype=w.dtype, device=w.device)
    finite = torch.isfinite(fp_res)
    if use_ball and params.restore_feasibility:
        converged = finite
    else:
        converged = (to_viol <= params.feas_tol) & finite
    hold = w_init[..., None, :].expand_as(w_last)
    w_out = torch.where(finite[..., None, None], w_last, hold)
    return w_out, fp_res, to_viol, converged


def solve_mpc_log_utility_batch(
    current_weights: torch.Tensor,
    predicted_log_returns: torch.Tensor,
    params: MPCParams,
    w_warm: Optional[torch.Tensor] = None,
    p_warm: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Eager solve of a batch of log-utility programs, on the tensors'
    device: current_weights [..., N], predicted_log_returns [..., H, N],
    optional warm primal/dual iterates [..., H, N]. Returns
    (weights [..., H, N], info) with per-problem ``converged``,
    ``turnover_violation``, ``fixed_point_residual``, ``status_code``,
    ``objective`` and the final ``dual``."""
    reject_unhonored_polish(params, "solve_mpc_log_utility_batch")
    y = predicted_log_returns
    r = torch.exp(y)
    w_init = current_weights.to(y.dtype)
    r_norm2 = (r * r).sum(dim=-1)
    r_min = r.amin(dim=-1)
    Lt = r_norm2 / torch.clamp(r_min, min=1e-12) ** 2 + params.ridge
    tau_p, sigma = _pdhg_steps(Lt, params)
    proj_primal = _primal_projection(params)

    def grad_g(w):
        port = (w * r).sum(dim=-1, keepdim=True)
        return -r / torch.clamp(port, min=1e-12) + params.ridge * w

    if w_warm is None:
        w0 = proj_primal(w_init)[..., None, :].expand(y.shape).contiguous()
    else:
        w0 = w_warm
    p0 = torch.zeros_like(w0) if p_warm is None else p_warm
    w, p, tau_f = _pdhg_loop(params, grad_g, w_init, w0, p0, tau_p, sigma,
                             "ball" if params.max_turnover > 0 else "soft")
    w_last = proj_primal(w - tau_f * (grad_g(w) + _apply_Dt(p)))
    w_out, fp_res, to_viol, converged = _log_utility_tail(
        params, w, w_last, w_init)
    info = {
        "converged": converged,
        "turnover_violation": to_viol,
        "fixed_point_residual": fp_res,
        "status_code": _status_code(fp_res, params.feas_tol),
        "objective": _log_utility_objective(w_out, r, w_init,
                                            params.cost_coeff),
        "dual": p,
    }
    return w_out, info


def fp32_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in full float32 on any device (TF32 off for this product)."""
    prev = torch.backends.cuda.matmul.allow_tf32
    if not prev:
        return torch.matmul(a, b)
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return torch.matmul(a, b)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def mean_variance_objective(w, mu, Sigma, w_init, params: MPCParams):
    """sum_t w_t.mu_t - gamma sum_t w_t' Sigma w_t - c sum |u| (maximisation
    form); Sigma [..., N, N] or [N, N]."""
    quad = (fp32_matmul(w, Sigma) * w).sum(dim=(-2, -1))
    u = _apply_D(w, w_init)
    return ((w * mu).sum(dim=(-2, -1)) - params.gamma * quad
            - params.cost_coeff * u.abs().sum(dim=(-2, -1)))


def solve_mpc_mean_variance_batch(
    current_weights: torch.Tensor,
    predicted_log_returns: torch.Tensor,
    cov_matrix: torch.Tensor,
    params: MPCParams,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Eager batched mean-variance MPC:

        min_w  sum_t [gamma w_t' Sigma w_t - w_t.mu_t] + c sum_t ||u_t||_1
        s.t.   w_t on the simplex.

    No turnover ball, so the dual prox is a clip to [-c, c].
    current_weights [..., N], predicted_log_returns [..., H, N], cov_matrix
    [..., N, N] or [N, N] (broadcast over the batch)."""
    reject_unhonored_polish(params, "solve_mpc_mean_variance_batch")
    mu = predicted_log_returns
    w_init = current_weights.to(mu.dtype)
    Sigma = 0.5 * (cov_matrix + cov_matrix.transpose(-1, -2))
    fro = torch.sqrt((Sigma * Sigma).sum(dim=(-2, -1)))
    L = torch.clamp(2.0 * params.gamma * fro, min=1e-6)[..., None, None]
    sigma = params.sigma_scale * torch.sqrt(L + 1.0) / 2.0
    tau_p = params.step_scale / (0.5 * L + sigma * 4.0)
    proj_primal = _primal_projection(params)

    def grad_g(w):
        return 2.0 * params.gamma * fp32_matmul(w, Sigma) - mu

    w0 = proj_primal(w_init)[..., None, :].expand(mu.shape).contiguous()
    # The step carry is shaped to the batch: with an unbatched Sigma, L has
    # no batch axes while the adaptive residuals are per problem.
    steps_shape = w0.shape[:-2] + (1, 1)
    w, p, tau_f = _pdhg_loop(
        params, grad_g, w_init, w0, torch.zeros_like(w0),
        tau_p.expand(steps_shape), sigma.expand(steps_shape), "clip")
    w_last = proj_primal(w - tau_f * (grad_g(w) + _apply_Dt(p)))
    fp_res = (w_last - w).abs().amax(dim=(-2, -1))
    converged = torch.isfinite(fp_res)
    hold = w_init[..., None, :].expand_as(w_last)
    w_out = torch.where(converged[..., None, None], w_last, hold)
    info = {
        "converged": converged,
        "fixed_point_residual": fp_res,
        "status_code": _status_code(fp_res, params.feas_tol),
        "objective": mean_variance_objective(w_out, mu, Sigma, w_init, params),
    }
    return w_out, info


def _as_f32(x, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x), dtype=torch.float32, device=device)


def solve_mpc_log_utility(
    current_weights: np.ndarray,
    predicted_log_returns: np.ndarray,
    params: MPCParams,
    device="cuda",
) -> Tuple[np.ndarray, Dict]:
    """One log-utility problem, numpy in and out: (weights [H, N],
    {status, value, turnover_violation}). With ``params.polish``
    (cfg.MPC.SOLVER.POLISH=True) the solve is the float64 verification
    path (ops/mpc_polish.py), its status banded on the polish residual,
    and the info adds ``polish_residual_before``,
    ``polish_residual_after`` and ``polish_accepted``."""
    cw = _as_f32(current_weights, device)
    y = _as_f32(predicted_log_returns, device)
    if params.polish:
        from kmpc_tpu_torch.ops.mpc_polish import (
            solve_mpc_log_utility_batch_polished,
        )

        w, info = solve_mpc_log_utility_batch_polished(cw, y, params)
        code = int(_status_code(info["residual_after"], params.feas_tol))
        return w.cpu().numpy(), {
            "status": STATUS_STRINGS[code],
            "value": float(info["objective"]),
            "turnover_violation": float(info["turnover_violation"]),
            "polish_residual_before": float(info["residual_before"]),
            "polish_residual_after": float(info["residual_after"]),
            "polish_accepted": bool(info["accepted"]),
        }
    w, info = solve_mpc_log_utility_batch(cw, y, params)
    return w.cpu().numpy(), {
        "status": STATUS_STRINGS[int(info["status_code"])],
        "value": float(info["objective"]),
        "turnover_violation": float(info["turnover_violation"]),
    }


def solve_mpc_mean_variance(
    current_weights: np.ndarray,
    predicted_log_returns: np.ndarray,
    cov_matrix: np.ndarray,
    params: MPCParams,
    device="cuda",
) -> Tuple[np.ndarray, Dict]:
    """One mean-variance problem, numpy in and out: (weights [H, N],
    {status, value})."""
    w, info = solve_mpc_mean_variance_batch(
        _as_f32(current_weights, device),
        _as_f32(predicted_log_returns, device),
        _as_f32(cov_matrix, device), params)
    return w.cpu().numpy(), {
        "status": STATUS_STRINGS[int(info["status_code"])],
        "value": float(info["objective"]),
    }
