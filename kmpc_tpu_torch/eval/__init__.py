"""Evaluation protocol: rollout modes, horizon metrics, basins, plots."""

from kmpc_tpu_torch.eval.evaluation import (
    EvaluationSettings,
    compute_horizon_mse,
    cumulative_mse_curve,
    evaluate_model,
)

__all__ = [
    "EvaluationSettings",
    "compute_horizon_mse",
    "cumulative_mse_curve",
    "evaluate_model",
]
