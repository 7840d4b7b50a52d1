"""Finance data pipeline: prices -> log-returns -> embedding -> splits.

Port of kmpc_tpu/data/finance.py. The transforms are the same numpy and
pandas code (seeded synthetic factor-model panel, log-returns, train-only
standardization, time-delay embedding, chronological splits); the splits
and the standardization stats end up as float32 torch tensors on a device
the caller names. Prices come from the parquet cache when one exists, else
from the synthetic panel; this package never downloads.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import pandas as pd
import torch

from kmpc_tpu_torch.config import Config, FinanceConfig


def generate_synthetic_prices(
    tickers: List[str],
    start_date: str,
    end_date: str,
    seed: int = 1234,
) -> pd.DataFrame:
    """Deterministic factor-model price panel on business days: per-asset
    log-returns are a market loading (GARCH-like volatility) plus a sector
    factor plus idiosyncratic noise."""
    dates = pd.bdate_range(start=start_date, end=end_date)
    T, N = len(dates), len(tickers)
    rng = np.random.default_rng(seed)

    market = rng.standard_normal(T) * 0.009
    vol_state = np.ones(T)
    for t in range(1, T):
        vol_state[t] = 0.94 * vol_state[t - 1] + 0.06 * (1.0 + 4.0 * market[t - 1] ** 2 / 0.009**2 / 4.0)
    market = market * np.sqrt(vol_state)

    n_sectors = 5
    sector_factors = rng.standard_normal((T, n_sectors)) * 0.005
    sector_of = rng.integers(0, n_sectors, size=N)

    beta = rng.uniform(0.6, 1.4, size=N)
    drift = rng.uniform(0.0001, 0.0006, size=N)
    idio_vol = rng.uniform(0.006, 0.018, size=N)

    idio = rng.standard_normal((T, N)) * idio_vol[None, :]
    log_ret = drift[None, :] + beta[None, :] * market[:, None] + sector_factors[:, sector_of] + idio

    log_prices = np.log(rng.uniform(20.0, 400.0, size=N))[None, :] + np.cumsum(log_ret, axis=0)
    prices = np.exp(log_prices).astype(np.float64)
    return pd.DataFrame(prices, index=dates, columns=list(tickers))


def load_price_data(
    tickers: List[str],
    start_date: str,
    end_date: str,
    cache_path: Optional[Path] = None,
    synthetic: bool = True,
    synthetic_seed: int = 1234,
) -> pd.DataFrame:
    """Prices from the parquet cache when it exists, else the synthetic
    panel (written to the cache when a cache path is given)."""
    if cache_path is not None and Path(cache_path).exists():
        return pd.read_parquet(cache_path)
    if not synthetic:
        raise FileNotFoundError(
            f"SYNTHETIC=False needs real prices at the cache path "
            f"{cache_path}; kmpc_tpu_torch does not download"
        )
    prices = generate_synthetic_prices(tickers, start_date, end_date,
                                       seed=synthetic_seed)
    if cache_path is not None:
        cache_path = Path(cache_path)
        cache_path.parent.mkdir(parents=True, exist_ok=True)
        prices.to_parquet(cache_path)
    return prices


def clean_price_data(
    prices: pd.DataFrame,
    max_missing_ratio: float = 0.1,
    max_gap_days: int = 5,
) -> pd.DataFrame:
    """Drop sparse assets, forward-fill short gaps, drop NaN rows."""
    missing_ratios = prices.isna().mean()
    good_assets = missing_ratios[missing_ratios <= max_missing_ratio].index
    prices = prices[good_assets].copy()
    prices = prices.ffill(limit=max_gap_days)
    return prices.dropna()


def compute_log_returns(prices: pd.DataFrame) -> pd.DataFrame:
    """y_t = log(p_t) - log(p_{t-1})."""
    log_prices = np.log(prices)
    return log_prices.diff().iloc[1:]


@dataclass
class FinanceStats:
    """Per-asset standardization stats from the training period only."""

    mean: np.ndarray
    std: np.ndarray
    tickers: List[str]


def compute_standardization_stats(log_returns: pd.DataFrame, train_end: str) -> FinanceStats:
    """Mean/std over the training period only."""
    train_data = log_returns[log_returns.index <= train_end]
    if len(train_data) == 0:
        raise ValueError(f"No training data before {train_end}")
    mean = train_data.mean().values
    std = np.maximum(train_data.std().values, 1e-8)
    return FinanceStats(mean=mean, std=std, tickers=list(log_returns.columns))


def standardize_returns(log_returns: pd.DataFrame, stats: FinanceStats) -> pd.DataFrame:
    """(y - mean) / std."""
    return (log_returns - stats.mean) / stats.std


def time_delay_embedding(data: np.ndarray, embedding_dim: int) -> np.ndarray:
    """Y_t = [y_t, y_{t-1}, ..., y_{t-d+1}] flattened: block j of output
    row i holds data[i + d - 1 - j]."""
    T, n_assets = data.shape
    d = embedding_dim
    if T < d:
        raise ValueError(f"Time series length {T} < embedding_dim {d}")
    n_embedded = T - d + 1
    idx = (np.arange(n_embedded)[:, None] + (d - 1) - np.arange(d)[None, :])
    return data[idx].reshape(n_embedded, d * n_assets)


def create_finance_splits(
    log_returns: pd.DataFrame,
    stats: FinanceStats,
    train_end: str,
    val_end: str,
    embedding_dim: int,
) -> Tuple[np.ndarray, pd.DatetimeIndex, np.ndarray, pd.DatetimeIndex, np.ndarray, pd.DatetimeIndex]:
    """Leak-free chronological train/val/test splits of the embedding."""
    standardized = standardize_returns(log_returns, stats)
    data = standardized.values.astype(np.float32)
    dates = standardized.index

    embedded = time_delay_embedding(data, embedding_dim)
    embedded_dates = dates[embedding_dim - 1:]

    train_mask = embedded_dates <= train_end
    val_mask = (embedded_dates > train_end) & (embedded_dates <= val_end)
    test_mask = embedded_dates > val_end

    return (
        embedded[train_mask], embedded_dates[train_mask],
        embedded[val_mask], embedded_dates[val_mask],
        embedded[test_mask], embedded_dates[test_mask],
    )


def verify_embedding_shift(embedded: np.ndarray, n_assets: int, embedding_dim: int) -> bool:
    """The shift property Y_{t+1}[1:] == Y_t[:-1] of the embedding."""
    a = embedded[:-1].reshape(-1, embedding_dim, n_assets)[:, :-1]
    b = embedded[1:].reshape(-1, embedding_dim, n_assets)[:, 1:]
    return bool(np.allclose(a, b))


def compute_return_stats(log_returns: pd.DataFrame) -> pd.DataFrame:
    """Summary statistics per asset."""
    return pd.DataFrame(
        {
            "mean": log_returns.mean(),
            "std": log_returns.std(),
            "min": log_returns.min(),
            "max": log_returns.max(),
            "skew": log_returns.skew(),
            "kurtosis": log_returns.kurtosis(),
            "missing_ratio": log_returns.isna().mean(),
        }
    )


def compute_autocorrelation(log_returns: pd.DataFrame, lag: int = 1) -> pd.Series:
    """Per-asset autocorrelation at ``lag``."""
    return log_returns.apply(lambda x: x.autocorr(lag=lag))


@dataclass
class FinanceData:
    """The splits as float32 tensors [n_samples, obs_size] on one device,
    with the standardization stats beside them as tensors."""

    train: torch.Tensor
    val: torch.Tensor
    test: torch.Tensor
    train_dates: pd.DatetimeIndex
    val_dates: pd.DatetimeIndex
    test_dates: pd.DatetimeIndex
    stats: FinanceStats
    metadata: Dict
    mean: torch.Tensor   # [n_assets]
    std: torch.Tensor    # [n_assets]
    sequence_length: int = 1

    @property
    def device(self) -> torch.device:
        return self.test.device

    @property
    def observation_size(self) -> int:
        return int(self.train.shape[1])

    @property
    def n_assets(self) -> int:
        return int(self.metadata["n_assets"])

    @property
    def embedding_dim(self) -> int:
        return int(self.metadata["embedding_dim"])

    def split(self, name: str) -> torch.Tensor:
        return {"train": self.train, "val": self.val, "test": self.test}[name]

    def num_examples(self, split: str, sequence_length: Optional[int] = None) -> int:
        """Number of start indices for windows of L+1 rows."""
        L = self.sequence_length if sequence_length is None else sequence_length
        return int(self.split(split).shape[0]) - L

    def sample_batch(
        self,
        generator: torch.Generator,
        split: str = "train",
        batch_size: int = 64,
        sequence_length: Optional[int] = None,
    ) -> torch.Tensor:
        """Random windows [B, L+1, obs] (L=1 gives pairs), their start
        indices uniform with replacement, drawn on the generator's device
        (which must be the data's)."""
        L = self.sequence_length if sequence_length is None else sequence_length
        n = self.num_examples(split, L)
        if n <= 0:
            raise ValueError(
                f"Split '{split}' has {n + L} rows: too short for "
                f"sequence_length {L}"
            )
        starts = torch.randint(0, n, (batch_size,), generator=generator,
                               device=generator.device)
        return self.batch_at(starts, split, L)

    def batch_at(self, start_indices: torch.Tensor, split: str,
                 sequence_length: int) -> torch.Tensor:
        """The windows [B, L+1, obs] that start at ``start_indices``."""
        data = self.split(split)
        steps = torch.arange(sequence_length + 1, device=data.device)
        return data[start_indices.to(data.device)[:, None] + steps[None, :]]

    def get_test_sequences(
        self, num_sequences: int = 100, max_length: int = 200
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Evenly spaced test windows: (init [B, obs], future [L, B, obs])."""
        n_samples = self.test.shape[0]
        actual_length = min(max_length, n_samples - 1)
        actual_num = min(num_sequences, n_samples - actual_length)
        if actual_num <= 0:
            raise ValueError(
                f"Not enough test data for {num_sequences} sequences of length {max_length}"
            )
        step = (n_samples - actual_length) // actual_num
        starts = torch.arange(actual_num, device=self.device) * step
        init = self.test[starts]
        idx = starts[:, None] + 1 + torch.arange(actual_length, device=self.device)[None, :]
        return init, self.test[idx].transpose(0, 1)

    def extract_current_returns(self, observations: torch.Tensor) -> torch.Tensor:
        """First n_assets block of the embedding = y_t."""
        return observations[..., : self.n_assets]

    def destandardize_returns(self, standardized: torch.Tensor) -> torch.Tensor:
        """Back to the raw log-return scale."""
        return standardized * self.std + self.mean


def load_finance_data(
    cfg_or_finance: Optional[Union[Config, FinanceConfig]] = None,
    sequence_length: Optional[int] = None,
    device: Union[str, torch.device] = "cuda",
) -> FinanceData:
    """Load (or synthesize) prices and build FinanceData on ``device``."""
    if cfg_or_finance is None:
        fin = FinanceConfig()
        seq_len = 1 if sequence_length is None else sequence_length
    elif isinstance(cfg_or_finance, Config):
        cfg = cfg_or_finance
        fin = cfg.ENV.FINANCE
        if sequence_length is None:
            seq_len = cfg.TRAIN.SEQUENCE_LENGTH if cfg.TRAIN.USE_SEQUENCE_LOSS else 1
        else:
            seq_len = sequence_length
    else:
        fin = cfg_or_finance
        seq_len = 1 if sequence_length is None else sequence_length

    cache_path = None
    if fin.CACHE_DIR is not None:
        ticker_hash = hashlib.md5(
            ",".join(sorted(fin.TICKERS)).encode()
        ).hexdigest()[:8]
        cache_path = Path(fin.CACHE_DIR) / (
            f"prices_{fin.START_DATE}_{fin.END_DATE}_{ticker_hash}.parquet"
        )

    prices = load_price_data(
        tickers=fin.TICKERS,
        start_date=fin.START_DATE,
        end_date=fin.END_DATE,
        cache_path=cache_path,
        synthetic=fin.SYNTHETIC,
        synthetic_seed=fin.SYNTHETIC_SEED,
    )
    prices = clean_price_data(prices)
    log_returns = compute_log_returns(prices)
    stats = compute_standardization_stats(log_returns, fin.TRAIN_END)
    train, train_dates, val, val_dates, test, test_dates = create_finance_splits(
        log_returns, stats, fin.TRAIN_END, fin.VAL_END, fin.EMBEDDING_DIM
    )

    metadata = {
        "tickers": list(log_returns.columns),
        "n_assets": len(log_returns.columns),
        "embedding_dim": fin.EMBEDDING_DIM,
        "observation_size": train.shape[1],
        "train_samples": max(len(train) - seq_len, 0),
        "val_samples": max(len(val) - seq_len, 0),
        "test_samples": max(len(test) - seq_len, 0),
        "train_date_range": (str(train_dates[0].date()), str(train_dates[-1].date())),
        "val_date_range": (str(val_dates[0].date()), str(val_dates[-1].date())),
        "test_date_range": (str(test_dates[0].date()), str(test_dates[-1].date())),
        "prices_shape": tuple(prices.shape),
        "log_returns_shape": tuple(log_returns.shape),
    }

    def dev(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    return FinanceData(
        train=dev(train),
        val=dev(val),
        test=dev(test),
        train_dates=train_dates,
        val_dates=val_dates,
        test_dates=test_dates,
        stats=stats,
        metadata=metadata,
        mean=dev(stats.mean),
        std=dev(stats.std),
        sequence_length=seq_len,
    )
