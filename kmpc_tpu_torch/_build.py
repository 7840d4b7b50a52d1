"""Build the package's CUDA sources with nvcc and load them with ctypes.

Each source under ``csrc/`` becomes one shared library with a plain C
interface, built at first use into ``kmpc_tpu_torch/_build/`` and keyed by
a hash of the source, the headers beside it and the flags, so an edited
source rebuilds and an unchanged one loads at once. ``build_all`` starts
one nvcc per source, all at the same time. Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Optional

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

# sm_90a: Hopper. No --use_fast_math: the kernels keep IEEE division and
# square roots, as the reference arithmetic does. ptxas -v writes each
# kernel's registers and spills into the build log.
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]

SOURCES = {
    "pdhg_log_utility": "pdhg_log_utility.cu",
    "pdhg_log_utility_scenarios": "pdhg_log_utility_scenarios.cu",
    "pdhg_mean_variance": "pdhg_mean_variance.cu",
    "pdhg_log_utility_adaptive": "pdhg_log_utility_adaptive.cu",
    "pdhg_log_utility_scenarios_adaptive":
        "pdhg_log_utility_scenarios_adaptive.cu",
    "pdhg_mean_variance_adaptive": "pdhg_mean_variance_adaptive.cu",
    "mv_ladder": "mv_ladder.cu",
    "pdhg_log_utility_pipe": "pdhg_log_utility_pipe.cu",
    "pdhg_log_utility_scenarios_pipe": "pdhg_log_utility_scenarios_pipe.cu",
    "pdhg_log_utility_block": "pdhg_log_utility_block.cu",
    "pdhg_log_utility_scenarios_block": "pdhg_log_utility_scenarios_block.cu",
    "pdhg_log_utility_block_adaptive": "pdhg_log_utility_block_adaptive.cu",
    "pdhg_log_utility_scenarios_block_adaptive":
        "pdhg_log_utility_scenarios_block_adaptive.cu",
    "pdhg_mean_variance_block": "pdhg_mean_variance_block.cu",
    "pdhg_mean_variance_block_adaptive":
        "pdhg_mean_variance_block_adaptive.cu",
    "pdhg_log_utility_rows": "pdhg_log_utility_rows.cu",
    "pdhg_log_utility_rows_adaptive": "pdhg_log_utility_rows_adaptive.cu",
    "pdhg_log_utility_scenarios_rows": "pdhg_log_utility_scenarios_rows.cu",
    "pdhg_log_utility_scenarios_rows_adaptive":
        "pdhg_log_utility_scenarios_rows_adaptive.cu",
}


def find_nvcc() -> str:
    """nvcc from CUDA_HOME, PATH, or /usr/local/cuda; raises if none."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    which = shutil.which("nvcc")
    if which:
        candidates.append(Path(which))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.exists():
            return str(c)
    raise RuntimeError(
        "nvcc not found (CUDA_HOME, PATH, /usr/local/cuda/bin): the CUDA "
        "kernels of kmpc_tpu_torch are built from source at first use"
    )


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in [CSRC / SOURCES[name], *sorted(CSRC.glob("*.cuh"))]:
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start nvcc for ``name`` unless its library is already built;
    returns (process, temporary output) or None."""
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           str(CSRC / SOURCES[name])]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp


def _finish(name: str, proc: subprocess.Popen, tmp: Path) -> None:
    log, _ = proc.communicate()
    out = library_path(name)
    out.with_suffix(".log").write_text(log)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}:\n{log}")
    os.replace(tmp, out)


def build_all(names: Optional[List[str]] = None) -> Dict[str, float]:
    """Build every named source (default: all) in parallel; returns the
    wall seconds until each was ready (0.0 when it was already built)."""
    names = list(SOURCES) if names is None else names
    t0 = time.perf_counter()
    started = {n: _start(n) for n in names}
    secs = {}
    for n, job in started.items():
        if job is None:
            secs[n] = 0.0
            continue
        _finish(n, *job)
        secs[n] = time.perf_counter() - t0
    return secs


def build_log(name: str) -> str:
    """nvcc's output (with ptxas' register and spill report) for ``name``."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


class CudaKernel:
    """One CUDA source's library, loaded at first use, and the count of
    kernel launches made through it (reset it to 0 before a run whose
    launches are to be counted)."""

    def __init__(self, name: str, symbol: str, argtypes: list):
        self.name = name
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self._fn = None

    def function(self):
        if self._fn is None:
            build_all([self.name])
            lib = ctypes.CDLL(str(library_path(self.name)))
            fn = getattr(lib, self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn
