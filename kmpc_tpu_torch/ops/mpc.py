"""Log-utility MPC: parameters, step sizes, restoration, objective, status.

Port of the pieces of kmpc_tpu/ops/mpc.py that the fused solve uses. The
program, with r_t = exp(y_t):

    min_w  -sum_t log(w_t . r_t) + c * sum_t ||u_t||_1
    s.t.   w_t on the simplex,  ||u_t||_1 <= tau  for every t,
           u_t = w_t - w_{t-1},  w_{-1} = current weights,

solved by a Condat-Vu primal-dual iteration (see ops/mpc_cuda.py).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch


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
    polish: bool = False          # float64 host polish (not in this package)
    polish_newton: int = 4
    adaptive: bool = False        # residual-balancing adaptive steps
    adapt_every: int = 1
    precond: bool = False         # per-horizon-row diagonal steps
    pipeline_reduces: bool = False  # one-iteration-stale ball reductions
    proj_refresh_every: int = 0   # >1: one warm sweep per iteration, the
                                  # full budget every k-th


def reject_unhonored_polish(params: MPCParams, entry: str) -> None:
    """Refuse ``params.polish``: the float64 host polish is a verification
    path that a batched solve cannot run."""
    if params.polish:
        raise ValueError(
            f"MPCParams.polish is a float64 host verification path that "
            f"{entry} cannot run; unset cfg.MPC.SOLVER.POLISH for "
            "hot-path solves."
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
