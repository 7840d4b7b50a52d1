"""Profiling and timing utilities.

Port of kmpc_tpu/utils/profiler.py on ``torch.profiler`` and CUDA events:

- ``trace(log_dir)``: context manager around ``torch.profiler`` that writes
  a Chrome trace (viewable in Perfetto or chrome://tracing) into
  ``log_dir``.
- ``sync(tree)``: waits for the card(s) holding the tensors of ``tree`` and
  returns a float32 checksum of them, as the JAX package's ``sync``.
- ``benchmark(fn, *args)``: warm-up, then best-of-N timing, by CUDA events
  for CUDA work and by the host clock for CPU work.
- ``StageTimer``: named-stage accumulator for loop instrumentation.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Any, Callable, Dict, List, Optional

import torch


def _leaves(tree: Any) -> List[torch.Tensor]:
    """The tensors of a nest of dicts, lists and tuples, in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return []


@contextlib.contextmanager
def trace(log_dir: str, activities=None):
    """Device trace context: ``with trace('/tmp/trace'): step(...)`` writes
    ``trace_<pid>.json`` into ``log_dir`` (the CPU, and CUDA where
    available). Yields the profiler, whose ``key_averages()`` remain
    readable after the block."""
    if activities is None:
        activities = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(
            os.path.join(log_dir, f"trace_{os.getpid()}.json"))


def sync(tree: Any) -> float:
    """Force completion of all work producing ``tree``: synchronise every
    CUDA device that holds one of its tensors, then return the checksum
    (the sum of every floating or integer leaf, each summed in float32)."""
    leaves = _leaves(tree)
    for dev in {x.device for x in leaves if x.device.type == "cuda"}:
        torch.cuda.synchronize(dev)
    total = 0.0
    for leaf in leaves:
        if leaf.dtype != torch.bool and not leaf.dtype.is_complex:
            total += float(leaf.to(torch.float32).sum())
    return total


def _on_cuda(out: Any) -> bool:
    return any(x.device.type == "cuda" for x in _leaves(out))


def benchmark(
    fn: Callable,
    *args,
    reps: int = 5,
    warmup: int = 1,
    **kwargs,
) -> Dict[str, float]:
    """Time ``fn(*args)`` with full synchronisation.

    Returns {'best_s', 'mean_s', 'reps'}; fn is called ``warmup`` times
    first (builds, caches). Where the warm-up's output lies on a card (with
    no warm-up: where CUDA is available), each rep is timed by CUDA events
    on the current stream; otherwise by the host clock.
    """
    out = None
    for _ in range(warmup):
        out = fn(*args, **kwargs)
        sync(out)
    cuda = _on_cuda(out) if warmup else torch.cuda.is_available()
    times = []
    for _ in range(reps):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kwargs)
            end.record()
            sync(out)
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            sync(fn(*args, **kwargs))
            times.append(time.perf_counter() - t0)
    return {
        "best_s": min(times),
        "mean_s": sum(times) / len(times),
        "reps": reps,
    }


class StageTimer:
    """Accumulate wall time per named stage.

    with timer.stage("solve", tree): ...   (``tree`` synchronised at exit)
    timer.summary() -> {stage: {'total_s', 'count', 'mean_s'}}
    """

    def __init__(self):
        self._totals: Dict[str, float] = defaultdict(float)
        self._counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str, tree: Optional[Any] = None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if tree is not None:
                sync(tree)
            self._totals[name] += time.perf_counter() - t0
            self._counts[name] += 1

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            name: {
                "total_s": total,
                "count": self._counts[name],
                "mean_s": total / max(self._counts[name], 1),
            }
            for name, total in self._totals.items()
        }

    def report(self) -> str:
        lines = [f"{'stage':<24}{'count':>8}{'total_s':>12}{'mean_ms':>12}"]
        for name, s in sorted(self.summary().items()):
            lines.append(
                f"{name:<24}{s['count']:>8}{s['total_s']:>12.3f}"
                f"{s['mean_s'] * 1e3:>12.2f}"
            )
        return "\n".join(lines)
