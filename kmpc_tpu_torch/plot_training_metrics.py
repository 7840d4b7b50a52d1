"""Training curves from a run's ``metrics_history.jsonl``: the counterpart
of the repository's ``plot_training_metrics.py``.

    python -m kmpc_tpu_torch.plot_training_metrics --log_dir RUN_DIR
        [--metrics NAME ...] [--save_path PNG] [--summary]

Draws a grid of the ``train/`` curves and one panel of the ``eval/`` and
``val/`` curves into ``training_metrics.png``. Best-effort: without
matplotlib it warns and draws nothing (``--summary`` still prints the
table). Runs on the host; no device is needed.
"""

from __future__ import annotations

import argparse
import json
import warnings
from pathlib import Path
from typing import Dict, List, Optional


def load_metrics(log_dir: Path) -> Dict[str, tuple]:
    """metrics_history.jsonl as {name: (steps, values)}."""
    metrics: Dict[str, tuple] = {}
    path = Path(log_dir) / "metrics_history.jsonl"
    if not path.exists():
        raise FileNotFoundError(f"No metrics_history.jsonl in {log_dir}")
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            entry = json.loads(line)
            metrics.setdefault(entry["name"], ([], []))
            metrics[entry["name"]][0].append(entry["step"])
            metrics[entry["name"]][1].append(entry["value"])
    return metrics


def plot_metrics(log_dir: Path, metrics_to_plot: Optional[List[str]] = None,
                 save_path: Optional[Path] = None) -> Optional[Path]:
    """The train curves in a grid of three columns and the eval / val
    curves on one panel below; the figure's path, or None (with a warning)
    without matplotlib."""
    metrics = load_metrics(log_dir)
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError as e:
        warnings.warn(f"matplotlib is not available ({e}); no training "
                      "curves drawn", stacklevel=2)
        return None
    names = metrics_to_plot or sorted(metrics.keys())
    train_names = [n for n in names if n.startswith("train/")]
    eval_names = [n for n in names if n.startswith(("eval/", "val/"))]

    n_train = len(train_names)
    cols = 3
    rows = max((n_train + cols - 1) // cols, 1) + (1 if eval_names else 0)
    fig, axes = plt.subplots(rows, cols, figsize=(5 * cols, 3.2 * rows))
    axes = axes.reshape(rows, cols) if rows > 1 else axes.reshape(1, -1)

    for i, name in enumerate(train_names):
        ax = axes[i // cols][i % cols]
        steps, values = metrics[name]
        ax.plot(steps, values, lw=1.0)
        ax.set_title(name, fontsize=9)
        ax.set_xlabel("step", fontsize=8)
    for i in range(n_train, (rows - (1 if eval_names else 0)) * cols):
        axes[i // cols][i % cols].axis("off")

    if eval_names:
        ax = axes[-1][0]
        for name in eval_names:
            steps, values = metrics[name]
            ax.plot(steps, values, lw=1.2, label=name)
        ax.set_title("evaluation", fontsize=9)
        ax.set_xlabel("step", fontsize=8)
        ax.legend(fontsize=7)
        for j in range(1, cols):
            axes[-1][j].axis("off")

    fig.tight_layout()
    out = save_path or (Path(log_dir) / "training_metrics.png")
    fig.savefig(out, dpi=150)
    plt.close(fig)
    return out


def print_summary(log_dir: Path) -> None:
    """Final, min, max and mean of every metric."""
    metrics = load_metrics(log_dir)
    print(f"{'metric':<40} {'final':>12} {'min':>12} {'max':>12} {'mean':>12}")
    for name in sorted(metrics):
        _, values = metrics[name]
        print(f"{name:<40} {values[-1]:>12.5f} {min(values):>12.5f} "
              f"{max(values):>12.5f} {sum(values) / len(values):>12.5f}")


def main(argv: Optional[List[str]] = None) -> Optional[Path]:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--log_dir", type=str, required=True)
    parser.add_argument("--metrics", type=str, nargs="*", default=None)
    parser.add_argument("--save_path", type=str, default=None)
    parser.add_argument("--summary", action="store_true")
    args = parser.parse_args(argv)

    log_dir = Path(args.log_dir)
    if args.summary:
        print_summary(log_dir)
    out = plot_metrics(log_dir, args.metrics,
                       Path(args.save_path) if args.save_path else None)
    if out is not None:
        print(f"Saved {out}")
    return out


if __name__ == "__main__":
    main()
