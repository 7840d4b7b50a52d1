"""Jacobi (parallel) backtest and the strategies it compares.

Port of the parallel path of kmpc_tpu/backtest/engine.py. Each strategy
has a ``precompute`` pass that runs once, batched over every test date
(Koopman forecasts, DMD linear rollouts, scenario paths, Markowitz rolling
moments), and a ``rebalance_all`` that solves every rebalance date at once
from guessed pre-trade weights: one launch of a fused kernel on a CUDA
device with ``use_fused_kernel``, else the eager solver. Each sweep then
reruns the wealth/drift recursion over the dates to update the guesses.
The date coupling is weak (pre-trade weights enter only the cost term and
the first step's turnover cap), so a handful of sweeps converges; as many
sweeps as dates is exact. ``warm_sweeps_iters`` carries the (primal, dual)
iterates from sweep to sweep and cuts the later sweeps' iteration budget.
The recursion is a Python loop of [N]-sized tensor steps. Not here yet:
the per-date ``rebalance`` with the exact scan path, and the device mesh.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Dict, Optional

import numpy as np
import torch

from kmpc_tpu_torch.config import BacktestConfig
from kmpc_tpu_torch.data.finance import FinanceData
from kmpc_tpu_torch.models.koopman import KoopmanModel
from kmpc_tpu_torch.ops.mpc import (
    MPCParams,
    fp32_matmul,
    solve_mpc_log_utility_batch,
    solve_mpc_mean_variance_batch,
)
from kmpc_tpu_torch.ops.mpc_cuda import (
    solve_mpc_log_utility_packed,
    solve_mpc_log_utility_scenarios_packed,
)
from kmpc_tpu_torch.ops.mv_cuda import solve_mpc_mean_variance_packed
from kmpc_tpu_torch.ops.rollout import predict_returns
from kmpc_tpu_torch.ops.scenario import (
    estimate_residual_std,
    generate_return_scenarios,
    solve_mpc_log_utility_scenarios,
)


def _pinv_rtol(rows: int, cols: int) -> float:
    """Relative singular-value cutoff of the pseudo-inverse in
    ``DMDStrategy.fit``: jnp.linalg.pinv's default, 10 * max(rows, cols) *
    float32 epsilon, passed explicitly because torch.linalg.pinv's own
    default is ten times smaller and the delay-embedded train matrix is
    close to rank-deficient."""
    return 10.0 * max(rows, cols) * float(np.finfo(np.float32).eps)


@dataclass
class BuyAndHoldStrategy:
    """Equal weight at the first date, then drift."""

    def precompute(self, fd: FinanceData, horizon: int) -> Dict[str, Any]:
        return {"n_assets": fd.n_assets}

    def rebalance_all(self, aux, current_weights: torch.Tensor) -> torch.Tensor:
        # [T, N] guessed pre-trade weights -> [T, N] targets
        out = current_weights.clone()
        out[0] = 1.0 / current_weights.shape[-1]
        return out


def _warm_solve(fused_solve, eager_solve, use_fused_kernel, current_weights,
                log_returns, mpc: MPCParams, warm, max_iters):
    """All-dates solve that takes and returns (primal, dual) iterates."""
    if max_iters is not None:
        mpc = replace(mpc, max_iters=max_iters)
    w_warm, p_warm = warm if warm is not None else (None, None)
    if use_fused_kernel:
        w, info = fused_solve(
            current_weights, log_returns, mpc, device=current_weights.device,
            w_warm=w_warm, p_warm=p_warm, return_dual=True)
    else:
        w, info = eager_solve(current_weights, log_returns, mpc,
                              w_warm=w_warm, p_warm=p_warm)
    return w[:, 0, :], (w, info["dual"])


class LogUtilityMPCRebalanceMixin:
    """Rebalance logic of the strategies that forecast per-date log-returns
    (``aux['pred_log_returns']`` [T, H, N]) and solve the log-utility MPC:
    the Koopman strategy and the DMD baseline differ only in the forecast.
    Host classes provide ``mpc`` and ``use_fused_kernel``."""

    def rebalance_all(self, aux, current_weights: torch.Tensor) -> torch.Tensor:
        if self.use_fused_kernel:
            w, _ = solve_mpc_log_utility_packed(
                current_weights, aux["pred_log_returns"], self.mpc,
                device=current_weights.device)
        else:
            w, _ = solve_mpc_log_utility_batch(
                current_weights, aux["pred_log_returns"], self.mpc)
        return w[:, 0, :]

    def rebalance_all_warm(self, aux, current_weights, warm, max_iters=None):
        """All-dates solve carrying (primal, dual) iterates across Jacobi
        sweeps: between sweeps only the pre-trade weights move, and less
        each sweep, so warm sweeps need a fraction of the cold budget."""
        return _warm_solve(
            solve_mpc_log_utility_packed, solve_mpc_log_utility_batch,
            self.use_fused_kernel, current_weights, aux["pred_log_returns"],
            self.mpc, warm, max_iters)


@dataclass
class KoopmanMPCStrategy(LogUtilityMPCRebalanceMixin):
    """Koopman H-step forecast + log-utility MPC, every date solved in one
    batched call. ``use_fused_kernel`` routes the solve through the fused
    kernel (the CLI sets it unless asked for the eager solver); off, the
    eager solver runs on the tensors' device."""

    model: KoopmanModel
    mpc: MPCParams
    use_fused_kernel: bool = True

    def precompute(self, fd: FinanceData, horizon: int) -> Dict[str, Any]:
        """One batched H-step forecast for every test date: [T, H, N]."""
        preds = predict_returns(self.model, fd.test, horizon, fd.n_assets,
                                fd.mean, fd.std)
        return {"pred_log_returns": preds}


@dataclass
class ScenarioKoopmanMPCStrategy:
    """Stochastic-Kelly variant: each date solves the scenario-averaged MPC
    over ``num_scenarios`` Monte-Carlo return paths drawn around the
    Koopman point forecast (see ops/scenario.py)."""

    model: KoopmanModel
    mpc: MPCParams
    num_scenarios: int = 32
    seed: int = 0
    residual_std: Optional[torch.Tensor] = None  # [H, N]; estimated if None
    use_fused_kernel: bool = True

    def precompute(self, fd: FinanceData, horizon: int) -> Dict[str, Any]:
        preds = predict_returns(self.model, fd.test, horizon, fd.n_assets,
                                fd.mean, fd.std)
        rstd = self.residual_std
        if rstd is None:
            rstd = estimate_residual_std(self.model, fd.val, horizon,
                                         fd.n_assets, fd.mean, fd.std)
        gen = torch.Generator(device=preds.device).manual_seed(self.seed)
        scen = generate_return_scenarios(preds, rstd, self.num_scenarios, gen)
        return {"scenario_log_returns": scen}                # [T, S, H, N]

    def rebalance_all(self, aux, current_weights: torch.Tensor) -> torch.Tensor:
        if self.use_fused_kernel:
            w, _ = solve_mpc_log_utility_scenarios_packed(
                current_weights, aux["scenario_log_returns"], self.mpc,
                device=current_weights.device)
        else:
            w, _ = solve_mpc_log_utility_scenarios(
                current_weights, aux["scenario_log_returns"], self.mpc)
        return w[:, 0, :]

    def rebalance_all_warm(self, aux, current_weights, warm, max_iters=None):
        """As ``LogUtilityMPCRebalanceMixin.rebalance_all_warm``."""
        return _warm_solve(
            solve_mpc_log_utility_scenarios_packed,
            solve_mpc_log_utility_scenarios, self.use_fused_kernel,
            current_weights, aux["scenario_log_returns"], self.mpc, warm,
            max_iters)


@dataclass
class DMDStrategy(LogUtilityMPCRebalanceMixin):
    """Linear-Koopman baseline: K = X' pinv(X) on the train embeddings, a
    linear rollout, the same MPC."""

    mpc: MPCParams
    K: Optional[torch.Tensor] = None  # [obs, obs], x_{t+1} = K x_t
    use_fused_kernel: bool = True

    def fit(self, train_data: torch.Tensor) -> "DMDStrategy":
        X = train_data[:-1].T                                # [obs, T-1]
        Xp = train_data[1:].T
        self.K = fp32_matmul(
            Xp, torch.linalg.pinv(X, rtol=_pinv_rtol(*X.shape)))
        return self

    def precompute(self, fd: FinanceData, horizon: int) -> Dict[str, Any]:
        if self.K is None:
            self.fit(fd.train)
        x = fd.test
        rets = []
        for _ in range(horizon):
            x = fp32_matmul(x, self.K.T)                     # row form
            rets.append(x[..., : fd.n_assets] * fd.std + fd.mean)
        return {"pred_log_returns": torch.stack(rets, dim=1)}  # [T, H, N]


@dataclass
class MarkowitzStrategy:
    """Rolling mean-variance: mu and Sigma over the last
    ``lookback_window`` returns for every date in one masked batched pass
    (sample covariance, ddof 1, plus a 1e-6 ridge); dates with fewer than
    ``min_samples`` returns hold the current weights."""

    mpc: MPCParams
    lookback_window: int = 60
    min_samples: int = 5
    use_fused_kernel: bool = True

    def precompute(self, fd: FinanceData, horizon: int) -> Dict[str, Any]:
        rets = fd.destandardize_returns(fd.extract_current_returns(fd.test))
        T, N = rets.shape
        W = self.lookback_window
        dev = rets.device
        # Window of the last W returns ending at t (inclusive), masked.
        idx = torch.arange(T, device=dev)[:, None] \
            + (torch.arange(W, device=dev) - (W - 1))[None, :]   # [T, W]
        valid = idx >= 0
        win = rets[idx.clamp(0, T - 1)]                      # [T, W, N]
        m = valid[..., None].to(rets.dtype)
        count = m.sum(dim=1)                                 # [T, 1]
        mu = (win * m).sum(dim=1) / torch.clamp(count, min=1.0)
        centered = (win - mu[:, None, :]) * m
        denom = torch.clamp(count[..., None] - 1.0, min=1.0)
        sigma = fp32_matmul(centered.transpose(1, 2), centered) / denom
        sigma = sigma + 1e-6 * torch.eye(N, dtype=rets.dtype, device=dev)
        return {"mu": mu, "sigma": sigma,
                "has_data": count[:, 0] >= self.min_samples}

    def rebalance_all(self, aux, current_weights: torch.Tensor) -> torch.Tensor:
        if self.use_fused_kernel:
            w, _ = solve_mpc_mean_variance_packed(
                current_weights, aux["mu"][:, None, :], aux["sigma"],
                self.mpc, device=current_weights.device)
        else:
            w, _ = solve_mpc_mean_variance_batch(
                current_weights, aux["mu"][:, None, :], aux["sigma"],
                self.mpc)
        return torch.where(aux["has_data"][:, None], w[:, 0, :],
                           current_weights)


def _market_step(portfolio_value, current_weights, target_weights, gross,
                 has_next: bool, cost_coeff: float):
    """One date's cost + growth + drift; ``gross`` = exp(realized) - 1."""
    turnover = (target_weights - current_weights).abs().sum(dim=-1)
    cost = cost_coeff * turnover * portfolio_value
    value = portfolio_value - cost
    if has_next:
        port_ret = (target_weights * gross).sum(dim=-1)
    else:
        port_ret = torch.zeros_like(value)
    value = value * (1.0 + port_ret)
    if not has_next:
        return value, target_weights, port_ret, turnover, cost
    # Guard only the exactly-singular denominator, keeping its sign: a
    # ruin-day 1 + r_p in (-1e-8, 0) must not flip every drifted weight.
    denom = 1.0 + port_ret
    sign = torch.where(denom < 0.0, -1.0, 1.0)
    denom = torch.where(denom.abs() < 1e-8, sign * 1e-8, denom)
    drifted = target_weights * (1.0 + gross) / denom[..., None]
    return value, drifted, port_ret, turnover, cost


def make_parallel_backtester(
    strategy,
    fd: FinanceData,
    config: BacktestConfig,
    num_sweeps: int = 8,
    warm_sweeps_iters: Optional[int] = None,
):
    """Returns ``(run, ts)``: ``run()`` runs ``num_sweeps`` sweeps and
    returns the last one's history (a dict of tensors over the rebalance
    dates ``ts``). The forecasts are computed here, once.

    ``warm_sweeps_iters`` (for a strategy with ``rebalance_all_warm``):
    sweep 1 solves cold at the strategy's full iteration budget; every
    later sweep starts from the previous sweep's (primal, dual) iterates
    and runs only this many iterations."""
    n_steps = fd.test.shape[0] - fd.sequence_length - config.HORIZON
    ts = np.arange(0, n_steps, config.REBALANCE_FREQ)
    T = len(ts)
    aux = strategy.precompute(fd, config.HORIZON)
    dev = fd.device
    ts_t = torch.as_tensor(ts, device=dev)
    aux_t = {
        k: v[ts_t] if torch.is_tensor(v) and v.shape[:1] == (fd.test.shape[0],) else v
        for k, v in aux.items()
    }

    all_returns = fd.destandardize_returns(fd.extract_current_returns(fd.test))
    t_len = all_returns.shape[0]
    gross_all = torch.exp(all_returns) - 1.0
    n = fd.n_assets

    use_warm = warm_sweeps_iters is not None
    if use_warm and not hasattr(strategy, "rebalance_all_warm"):
        raise ValueError(
            "warm_sweeps_iters requires a strategy with rebalance_all_warm"
        )
    if use_warm and num_sweeps < 2:
        raise ValueError("warm_sweeps_iters needs num_sweeps >= 2")

    def recursion(targets: torch.Tensor) -> Dict[str, torch.Tensor]:
        value = torch.tensor(config.INITIAL_CAPITAL, dtype=torch.float32, device=dev)
        weights = torch.full((n,), 1.0 / n, dtype=torch.float32, device=dev)
        keys = ("pre_trade", "portfolio_value", "return", "turnover", "cost")
        hist = {k: [] for k in keys}
        for j, t in enumerate(ts.tolist()):
            has_next = t + 1 < t_len
            gross = gross_all[min(t + 1, t_len - 1)]
            hist["pre_trade"].append(weights)
            value, weights, port_ret, turnover, cost = _market_step(
                value, weights, targets[j], gross, has_next,
                config.COST_COEFF,
            )
            hist["portfolio_value"].append(value)
            hist["return"].append(port_ret)
            hist["turnover"].append(turnover)
            hist["cost"].append(cost)
        out = {k: torch.stack(v) for k, v in hist.items()}
        out["weights"] = targets
        return out

    def run() -> Dict[str, torch.Tensor]:
        guess = torch.full((T, n), 1.0 / n, dtype=torch.float32, device=dev)
        if use_warm:
            targets, warm = strategy.rebalance_all_warm(aux_t, guess, None)
            for _ in range(num_sweeps - 1):
                guess = recursion(targets)["pre_trade"]
                targets, warm = strategy.rebalance_all_warm(
                    aux_t, guess, warm, max_iters=warm_sweeps_iters)
            return recursion(targets)
        for _ in range(num_sweeps - 1):
            guess = recursion(strategy.rebalance_all(aux_t, guess))["pre_trade"]
        return recursion(strategy.rebalance_all(aux_t, guess))

    return run, ts


def run_backtest_parallel(
    strategy,
    fd: FinanceData,
    config: BacktestConfig,
    num_sweeps: int = 8,
    return_dataframe: bool = True,
    warm_sweeps_iters: Optional[int] = None,
):
    """Backtest by Jacobi sweeps; a DataFrame (date, portfolio_value,
    return, turnover, cost) or the history as numpy arrays."""
    run, ts = make_parallel_backtester(strategy, fd, config, num_sweeps,
                                       warm_sweeps_iters=warm_sweeps_iters)
    history = {k: v.detach().cpu().numpy() for k, v in run().items()}
    history["t"] = ts
    if not return_dataframe:
        return history
    return _history_to_dataframe(history, fd, ts)


def _history_to_dataframe(history, fd: FinanceData, ts):
    import pandas as pd

    return pd.DataFrame(
        {
            "date": [fd.test_dates[int(t)] for t in ts],
            "portfolio_value": history["portfolio_value"],
            "return": history["return"],
            "turnover": history["turnover"],
            "cost": history["cost"],
        }
    )


def calculate_metrics(df) -> Dict[str, float]:
    """Annualized Sharpe, max drawdown, average turnover, final value and
    total return."""
    if len(df) == 0:
        return {}
    returns = np.asarray(df["return"])
    mean_ret = np.mean(returns)
    std_ret = np.std(returns)
    sharpe = np.sqrt(252) * mean_ret / (std_ret + 1e-8)

    cum_returns = np.cumprod(1 + returns)
    peak = np.maximum.accumulate(cum_returns)
    drawdown = (cum_returns - peak) / peak
    max_dd = float(np.min(drawdown))

    values = np.asarray(df["portfolio_value"])
    return {
        "Sharpe Ratio": float(sharpe),
        "Max Drawdown": max_dd,
        "Avg Turnover": float(np.mean(np.asarray(df["turnover"]))),
        "Final Value": float(values[-1]),
        "Total Return": float(values[-1] / values[0] - 1.0),
    }
