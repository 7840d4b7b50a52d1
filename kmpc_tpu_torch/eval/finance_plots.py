"""Finance evaluation figures (port of kmpc_tpu/eval/finance_plots.py).

Four figures from ``train/loop.py`` ``evaluate_finance``'s results, drawn
on the host with matplotlib: MSE against horizon per rollout mode,
predicted against actual returns of sample assets, the one-step prediction
correlation, and the mean MSE of each mode. Best-effort: without
matplotlib no figure is written.
"""

from __future__ import annotations

import warnings
from pathlib import Path
from typing import Any, Dict

import numpy as np

from kmpc_tpu_torch.data.finance import FinanceData

_COLORS = {
    "every_step": "#2ecc71",
    "no_reencode": "#e74c3c",
    "periodic_5": "#3498db",
    "periodic_10": "#9b59b6",
    "periodic_25": "#f39c12",
}


def _mpl():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def save_finance_plots(
    eval_results: Dict[str, Any],
    finance_data: FinanceData,
    output_dir: Path,
) -> Dict[str, str]:
    """Write the four finance evaluation plots of ``evaluate_finance``'s
    results; returns {name: path}, empty (with a warning) without
    matplotlib."""
    try:
        plt = _mpl()
    except ImportError as e:
        warnings.warn(f"matplotlib is not available ({e}); no finance "
                      "evaluation figures", stacklevel=2)
        return {}
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    files: Dict[str, str] = {}

    mse_curves = eval_results["mse_curves"]

    # 1. MSE vs horizon.
    fig, ax = plt.subplots(figsize=(9, 5))
    for mode, curve in mse_curves.items():
        ax.plot(
            np.arange(1, len(curve) + 1), np.asarray(curve),
            label=mode, color=_COLORS.get(mode), lw=1.5,
        )
    ax.set_xlabel("horizon (days)")
    ax.set_ylabel("MSE")
    ax.set_yscale("log")
    ax.set_title("Forecast MSE vs horizon")
    ax.legend(fontsize=8)
    fig.tight_layout()
    p = output_dir / "forecast_mse_vs_horizon.png"
    fig.savefig(p, dpi=150)
    plt.close(fig)
    files["forecast_mse_vs_horizon"] = str(p)

    # 2. Predicted vs actual returns for sample assets (first sequence).
    n_assets = finance_data.n_assets
    true = np.asarray(eval_results["true"])               # [L, B, obs]
    preds = eval_results["predictions"]
    best_mode = eval_results.get("best_mode", "every_step")
    pred = np.asarray(preds[best_mode])
    n_show = min(4, n_assets)
    fig, axes = plt.subplots(n_show, 1, figsize=(10, 2.5 * n_show), sharex=True)
    axes = np.atleast_1d(axes)
    for i, ax in enumerate(axes):
        ax.plot(true[:, 0, i], label="actual", color="k", lw=1.0, alpha=0.7)
        ax.plot(pred[:, 0, i], label=f"pred ({best_mode})",
                color=_COLORS.get(best_mode, "#3498db"), lw=1.0)
        ax.set_ylabel(finance_data.stats.tickers[i] if i < len(finance_data.stats.tickers) else f"asset {i}")
        if i == 0:
            ax.legend(fontsize=8)
    axes[-1].set_xlabel("day")
    fig.suptitle("Predicted vs actual standardized returns")
    fig.tight_layout()
    p = output_dir / "predicted_vs_actual_returns.png"
    fig.savefig(p, dpi=150)
    plt.close(fig)
    files["predicted_vs_actual_returns"] = str(p)

    # 3. Correlation scatter (1-step-ahead across all sequences/assets).
    fig, ax = plt.subplots(figsize=(6, 6))
    t_flat = true[0, :, :n_assets].ravel()
    p_flat = pred[0, :, :n_assets].ravel()
    ok = np.isfinite(t_flat) & np.isfinite(p_flat)
    ax.scatter(t_flat[ok], p_flat[ok], s=6, alpha=0.4)
    if ok.sum() > 2 and np.std(p_flat[ok]) > 0:
        corr = np.corrcoef(t_flat[ok], p_flat[ok])[0, 1]
    else:
        corr = float("nan")
    lim = np.nanmax(np.abs(np.concatenate([t_flat[ok], p_flat[ok]]))) if ok.any() else 1.0
    ax.plot([-lim, lim], [-lim, lim], "k--", alpha=0.4)
    ax.set_xlabel("actual")
    ax.set_ylabel("predicted")
    ax.set_title(f"1-step prediction correlation (r={corr:.3f})")
    fig.tight_layout()
    p = output_dir / "prediction_correlation.png"
    fig.savefig(p, dpi=150)
    plt.close(fig)
    files["prediction_correlation"] = str(p)

    # 4. Mean-MSE bar chart across modes.
    fig, ax = plt.subplots(figsize=(7, 4))
    modes = list(eval_results["mean_mses"].keys())
    vals = [eval_results["mean_mses"][m] for m in modes]
    ax.bar(modes, vals, color=[_COLORS.get(m, "#95a5a6") for m in modes])
    ax.set_ylabel("mean MSE")
    ax.set_title("Mean forecast MSE by rollout mode")
    plt.setp(ax.get_xticklabels(), rotation=30, ha="right", fontsize=8)
    fig.tight_layout()
    p = output_dir / "mode_mse_comparison.png"
    fig.savefig(p, dpi=150)
    plt.close(fig)
    files["mode_mse_comparison"] = str(p)

    return files
