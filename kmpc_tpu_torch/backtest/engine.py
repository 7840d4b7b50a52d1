"""Jacobi (parallel) backtest of the Koopman-MPC and buy-and-hold strategies.

Port of the parallel path of kmpc_tpu/backtest/engine.py. Each sweep
solves every rebalance date's MPC at once from guessed pre-trade weights
(one launch of the fused kernel on a CUDA device), then reruns the
wealth/drift recursion over the dates to update the guesses. The date
coupling is weak (pre-trade weights enter only the cost term and the
first step's turnover cap), so a handful of sweeps converges; as many
sweeps as dates is exact. The recursion is a Python loop of [N]-sized
tensor steps.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict

import numpy as np
import torch

from kmpc_tpu_torch.config import BacktestConfig
from kmpc_tpu_torch.data.finance import FinanceData
from kmpc_tpu_torch.models.koopman import KoopmanModel
from kmpc_tpu_torch.ops.mpc import MPCParams
from kmpc_tpu_torch.ops.mpc_cuda import solve_mpc_log_utility_packed
from kmpc_tpu_torch.ops.rollout import predict_returns


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


@dataclass
class KoopmanMPCStrategy:
    """Koopman H-step forecast + log-utility MPC, every date solved in one
    batched call."""

    model: KoopmanModel
    mpc: MPCParams

    def precompute(self, fd: FinanceData, horizon: int) -> Dict[str, Any]:
        """One batched H-step forecast for every test date: [T, H, N]."""
        preds = predict_returns(self.model, fd.test, horizon, fd.n_assets,
                                fd.mean, fd.std)
        return {"pred_log_returns": preds}

    def rebalance_all(self, aux, current_weights: torch.Tensor) -> torch.Tensor:
        w, _ = solve_mpc_log_utility_packed(
            current_weights, aux["pred_log_returns"], self.mpc,
            device=current_weights.device,
        )
        return w[:, 0, :]


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
):
    """Returns ``(run, ts)``: ``run()`` runs ``num_sweeps`` sweeps and
    returns the last one's history (a dict of tensors over the rebalance
    dates ``ts``). The forecasts are computed here, once."""
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
):
    """Backtest by Jacobi sweeps; a DataFrame (date, portfolio_value,
    return, turnover, cost) or the history as numpy arrays."""
    run, ts = make_parallel_backtester(strategy, fd, config, num_sweeps)
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
