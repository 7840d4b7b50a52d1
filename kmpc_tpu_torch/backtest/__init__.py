"""Jacobi backtest and metrics."""

from kmpc_tpu_torch.backtest.engine import (
    BuyAndHoldStrategy,
    KoopmanMPCStrategy,
    calculate_metrics,
    make_parallel_backtester,
    run_backtest_parallel,
)

__all__ = [
    "BuyAndHoldStrategy",
    "KoopmanMPCStrategy",
    "calculate_metrics",
    "make_parallel_backtester",
    "run_backtest_parallel",
]
