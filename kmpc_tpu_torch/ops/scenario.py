"""Monte-Carlo scenario MPC: stochastic Kelly over sampled return paths.

Port of kmpc_tpu/ops/scenario.py.

- ``estimate_residual_std``: per-asset, per-lead-time scale of the Koopman
  forecast's residuals on validation windows, in one batched pass.
- ``generate_return_scenarios``: S Gaussian paths per problem around the
  point forecast, drawn on the forecast's device from a ``torch.Generator``.
- ``solve_mpc_log_utility_scenarios``: the eager solve of the
  scenario-averaged program, the PDHG loop of ops/mpc.py with the smooth
  gradient averaged over the scenario axis:

      max_w  (1/S) sum_s sum_t log(w_t . r^s_t) - c sum_t ||u_t||_1
      s.t.   simplex, turnover ball (as in the deterministic program).

The fused CUDA solve of the same program is in ops/mpc_cuda.py.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from kmpc_tpu_torch.models.koopman import KoopmanModel
from kmpc_tpu_torch.ops.mpc import (
    MPCParams,
    _apply_D,
    _apply_Dt,
    _log_utility_tail,
    _pdhg_loop,
    _pdhg_steps,
    _primal_projection,
    _status_code,
    reject_unhonored_polish,
)
from kmpc_tpu_torch.ops.rollout import predict_returns


def estimate_residual_std(
    model: KoopmanModel,
    val_data: torch.Tensor,
    horizon: int,
    n_assets: int,
    mean: torch.Tensor,
    std: torch.Tensor,
    max_windows: int = 512,
) -> torch.Tensor:
    """Population std of the forecast residuals over validation windows,
    per (lead, asset): [horizon, n_assets] on the raw log-return scale."""
    T = val_data.shape[0]
    if T <= horizon:
        raise ValueError(
            f"validation split has {T} rows but residual estimation needs "
            f"more than horizon={horizon} (each window reads truth at "
            "t+1..t+H); pass a longer split or a shorter horizon"
        )
    n = T - horizon
    take = min(n, max_windows)
    step = max(n // take, 1)
    starts = torch.arange(0, n, step, device=val_data.device)[:take]
    preds = predict_returns(model, val_data[starts], horizon, n_assets,
                            mean, std)
    idx = starts[:, None] + 1 + torch.arange(horizon,
                                             device=val_data.device)[None, :]
    truth = val_data[idx][..., :n_assets] * std + mean        # [W, H, N]
    return torch.std(preds - truth, dim=0, unbiased=False)


def generate_return_scenarios(
    point_forecast: torch.Tensor,
    residual_std: torch.Tensor,
    num_scenarios: int,
    generator: Optional[torch.Generator] = None,
    antithetic: bool = True,
) -> torch.Tensor:
    """Gaussian scenarios around the point forecast [..., H, N] with scale
    ``residual_std`` [H, N]: [..., S, H, N]. Antithetic pairing: scenario s
    and s + ceil(S/2) use plus and minus the same draw (with an odd S the
    last draw has no mirror). ``generator`` must live on the forecast's
    device."""
    batch_shape = point_forecast.shape[:-2]
    H, N = point_forecast.shape[-2:]
    kw = dict(generator=generator, dtype=point_forecast.dtype,
              device=point_forecast.device)
    if antithetic:
        half = (num_scenarios + 1) // 2
        eps = torch.randn((*batch_shape, half, H, N), **kw)
        eps = torch.cat([eps, -eps], dim=-3)[..., :num_scenarios, :, :]
    else:
        eps = torch.randn((*batch_shape, num_scenarios, H, N), **kw)
    return point_forecast[..., None, :, :] + eps * residual_std


def scenario_objective(w, r, w_init, cost_coeff):
    """Scenario mean of the log growth of w [..., H, N] under
    r [..., S, H, N], minus the l1 trading cost."""
    port = (w[..., None, :, :] * r).sum(dim=-1)                # [..., S, H]
    growth = torch.log(torch.clamp(port, min=1e-30)).sum(dim=-1).mean(dim=-1)
    u = _apply_D(w, w_init)
    return growth - cost_coeff * u.abs().sum(dim=(-2, -1))


def scenario_steps(r: torch.Tensor, params: MPCParams):
    """Condat-Vu steps (tau, sigma) of the scenario program from gross
    returns r [..., S, H, N]: the curvature bound is the scenario mean of
    the per-scenario bounds (mean of max over the horizon; under
    ``precond`` per row, the global scale from the max of the means)."""
    r_norm2 = (r * r).sum(dim=-1)
    r_min = r.amin(dim=-1)
    ratio = r_norm2 / torch.clamp(r_min, min=1e-12) ** 2       # [..., S, H]
    if params.precond:
        return _pdhg_steps(ratio.mean(dim=-2) + params.ridge, params)
    L = ratio.amax(dim=-1).mean(dim=-1)[..., None, None] + params.ridge
    sigma = params.sigma_scale * torch.sqrt(L) / 2.0
    return params.step_scale / (0.5 * L + sigma * 4.0), sigma


def solve_mpc_log_utility_scenarios(
    current_weights: torch.Tensor,
    scenario_log_returns: torch.Tensor,
    params: MPCParams,
    w_warm: Optional[torch.Tensor] = None,
    p_warm: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Eager scenario-averaged Kelly MPC: current_weights [..., N],
    scenario_log_returns [..., S, H, N], optional warm iterates
    [..., H, N]. Returns (weights [..., H, N], info): one weight path per
    problem, optimal in expectation over its S scenarios; ``info['dual']``
    is the final dual."""
    reject_unhonored_polish(params, "solve_mpc_log_utility_scenarios")
    y = scenario_log_returns
    r = torch.exp(y)
    S = r.shape[-3]
    w_init = current_weights.to(r.dtype)
    target_shape = (*y.shape[:-3], *y.shape[-2:])
    tau_p, sigma = scenario_steps(r, params)
    proj_primal = _primal_projection(params)

    def grad_g(w):
        port = (w[..., None, :, :] * r).sum(dim=-1, keepdim=True)
        g = -r / torch.clamp(port, min=1e-12)
        return g.mean(dim=-3) + params.ridge * w

    if w_warm is None:
        w0 = proj_primal(w_init)[..., None, :].expand(target_shape).contiguous()
    else:
        w0 = w_warm.to(r.dtype)
    p0 = torch.zeros_like(w0) if p_warm is None else p_warm.to(r.dtype)
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
        "objective": scenario_objective(w_out, r, w_init, params.cost_coeff),
        "num_scenarios": S,
        "dual": p,
    }
    return w_out, info
