"""Buffered JSONL metrics logger (port of kmpc_tpu/utils/logger.py).

Writes ``metrics_history.jsonl``, one {step, name, value} row a scalar,
in buffered flushes, and on close ``metrics_summary.json`` with the final,
min, max and mean of each metric: the files kmpc_tpu's run directories
hold, so either package's tools read the other's runs.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List


class MetricsLogger:
    def __init__(self, log_dir: Path, flush_interval: int = 100):
        self.log_dir = Path(log_dir)
        self.log_dir.mkdir(parents=True, exist_ok=True)
        self.metrics_file = self.log_dir / "metrics_history.jsonl"
        self.metrics_history: List[Dict] = []
        self.buffer: List[str] = []
        self.flush_interval = flush_interval

    def log_scalar(self, name: str, value: float, step: int) -> None:
        entry = {"step": int(step), "name": name, "value": float(value)}
        self.buffer.append(json.dumps(entry) + "\n")
        self.metrics_history.append(entry)
        if len(self.buffer) >= self.flush_interval:
            self.flush()

    def log_dict(self, metrics: Dict[str, float], step: int, prefix: str = "") -> None:
        for key, value in metrics.items():
            name = f"{prefix}/{key}" if prefix else key
            self.log_scalar(name, value, step)

    def flush(self) -> None:
        if self.buffer:
            with open(self.metrics_file, "a") as f:
                f.writelines(self.buffer)
            self.buffer.clear()

    def close(self) -> None:
        self.flush()
        by_name: Dict[str, List[float]] = {}
        for entry in self.metrics_history:
            by_name.setdefault(entry["name"], []).append(entry["value"])
        summary = {
            name: {"final": values[-1], "min": min(values),
                   "max": max(values), "mean": sum(values) / len(values)}
            for name, values in by_name.items()
        }
        with open(self.log_dir / "metrics_summary.json", "w") as f:
            json.dump(summary, f, indent=2)
