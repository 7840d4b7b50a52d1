"""The backtests (exact scan over dates, Jacobi sweeps) and the strategies
they compare.

Port of kmpc_tpu/backtest/engine.py. Each strategy has a ``precompute``
pass that runs once, batched over every test date (Koopman forecasts, DMD
linear rollouts, scenario paths, Markowitz rolling moments), a per-date
``rebalance`` and a ``rebalance_all`` that solves every rebalance date at
once from guessed pre-trade weights. With ``use_fused_kernel`` a solve on a
CUDA device is one launch of a fused kernel (a batch of one problem per
date on the scan path), else the eager solver runs.

``run_backtest`` is the exact path: a loop over the dates, each date's
solve starting from the weights the previous date left (``lax.scan`` in the
JAX package). ``run_backtest_parallel`` solves all dates at once and reruns
the wealth/drift recursion over the dates to update the guessed pre-trade
weights, sweep after sweep. The date coupling is weak (pre-trade weights
enter only the cost term and the first step's turnover cap), so a handful
of sweeps converges; as many sweeps as dates is exact and equals the scan.
``warm_sweeps_iters`` carries the (primal, dual) iterates from sweep to
sweep and cuts the later sweeps' iteration budget. Both recursions are
Python loops of [N]-sized tensor steps. Not here yet: the device mesh.
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

    def rebalance(self, aux, t: int, current_weights: torch.Tensor, warm):
        if t == 0:
            return torch.full_like(current_weights,
                                   1.0 / current_weights.shape[-1]), warm
        return current_weights, warm

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
    Host classes provide ``mpc``, ``use_fused_kernel`` and
    ``use_warm_start``."""

    def rebalance(self, aux, t: int, current_weights: torch.Tensor, warm):
        """One date's solve from the pre-trade weights [N]: (target [N],
        warm). With ``use_warm_start`` the solve starts from the previous
        date's (primal, dual) [H, N] and hands its own on."""
        preds = aux["pred_log_returns"][t]                   # [H, N]
        warm_in = (warm[0][None], warm[1][None]) if self.use_warm_start \
            else None
        target, (w, dual) = _warm_solve(
            solve_mpc_log_utility_packed, solve_mpc_log_utility_batch,
            self.use_fused_kernel, current_weights[None], preds[None],
            self.mpc, warm_in, None)
        return target[0], ((w[0], dual[0]) if self.use_warm_start else warm)

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
    use_warm_start: bool = False  # scan path: start each date's solve from
    # the previous date's iterates. Warm and cold starts can land on
    # different, equally good points of the program's near-flat faces, so
    # the scan then no longer equals the cold Jacobi path exactly.

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

    def rebalance(self, aux, t: int, current_weights: torch.Tensor, warm):
        scen = aux["scenario_log_returns"][t][None]          # [1, S, H, N]
        return self.rebalance_all({"scenario_log_returns": scen},
                                  current_weights[None])[0], warm

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
    use_warm_start: bool = False      # as KoopmanMPCStrategy's

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

    def rebalance(self, aux, t: int, current_weights: torch.Tensor, warm):
        one = {k: aux[k][t][None] for k in ("mu", "sigma", "has_data")}
        return self.rebalance_all(one, current_weights[None])[0], warm

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


def _dated_returns(fd: FinanceData):
    """(gross returns exp(r) - 1 of every test row, their count)."""
    all_returns = fd.destandardize_returns(fd.extract_current_returns(fd.test))
    return torch.exp(all_returns) - 1.0, all_returns.shape[0]


def make_backtester(strategy, fd: FinanceData, config: BacktestConfig):
    """Returns ``(run, ts)``: ``run()`` walks the rebalance dates ``ts`` in
    order, solving each date from the weights the market left after the
    previous one, and returns the history (a dict of tensors over the
    dates). The forecasts are computed here, once.

    The number of dates is that of the parallel path; with
    ``REBALANCE_FREQ`` > 1 the loop advances by it and applies only the
    return at t + 1 (the returns of the days between are skipped, as in
    the JAX package)."""
    n_steps = fd.test.shape[0] - fd.sequence_length - config.HORIZON
    ts = np.arange(0, n_steps, config.REBALANCE_FREQ)
    aux = strategy.precompute(fd, config.HORIZON)
    gross_all, t_len = _dated_returns(fd)
    dev = fd.device
    n, H = fd.n_assets, config.HORIZON

    def run() -> Dict[str, torch.Tensor]:
        value = torch.tensor(config.INITIAL_CAPITAL, dtype=torch.float32,
                             device=dev)
        weights = torch.full((n,), 1.0 / n, dtype=torch.float32, device=dev)
        warm = (weights[None, :].repeat(H, 1),
                torch.zeros((H, n), dtype=torch.float32, device=dev))
        keys = ("portfolio_value", "return", "turnover", "cost", "weights")
        hist = {k: [] for k in keys}
        for t in ts.tolist():
            target, warm = strategy.rebalance(aux, t, weights, warm)
            has_next = t + 1 < t_len
            gross = gross_all[min(t + 1, t_len - 1)]
            value, weights, port_ret, turnover, cost = _market_step(
                value, weights, target, gross, has_next, config.COST_COEFF)
            for k, v in zip(keys, (value, port_ret, turnover, cost, target)):
                hist[k].append(v)
        return {k: torch.stack(v) for k, v in hist.items()}

    return run, ts


def run_backtest(strategy, fd: FinanceData, config: BacktestConfig,
                 return_dataframe: bool = True):
    """Backtest with exact sequential semantics, one solve per date; a
    DataFrame (date, portfolio_value, return, turnover, cost) or the
    history as numpy arrays."""
    run, ts = make_backtester(strategy, fd, config)
    history = {k: v.detach().cpu().numpy() for k, v in run().items()}
    history["t"] = ts
    if not return_dataframe:
        return history
    return _history_to_dataframe(history, fd, ts)


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

    gross_all, t_len = _dated_returns(fd)
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
