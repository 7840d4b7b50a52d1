"""Jacobi backtest, its strategies and metrics."""

from kmpc_tpu_torch.backtest.engine import (
    BuyAndHoldStrategy,
    DMDStrategy,
    KoopmanMPCStrategy,
    MarkowitzStrategy,
    ScenarioKoopmanMPCStrategy,
    calculate_metrics,
    make_parallel_backtester,
    run_backtest_parallel,
)

__all__ = [
    "BuyAndHoldStrategy",
    "DMDStrategy",
    "KoopmanMPCStrategy",
    "MarkowitzStrategy",
    "ScenarioKoopmanMPCStrategy",
    "calculate_metrics",
    "make_parallel_backtester",
    "run_backtest_parallel",
]
