"""ctypes bindings for the package's batched host MPC solver.

Port of kmpc_tpu/native. ``csrc/host/mpc_solver.cpp`` (the same PDHG
iteration as ``ops/mpc.py`` in double precision, OpenMP over problems) is
built with g++ at first use into ``kmpc_tpu_torch/_build/``, the library
named by a hash of the source and the flags, so an edited source rebuilds
and an unchanged one loads at once. Where the toolchain has no OpenMP the
build is retried without ``-fopenmp`` (the same host code, one thread).

This is a host cross-check only: it shares no code with the card's solvers,
and no solver entry of the package hands a solve to it. Nothing here runs
at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "host" / "mpc_solver.cpp"
BUILD_DIR = _PKG / "_build"
GXX_FLAGS = ["-O3", "-fopenmp", "-shared", "-fPIC"]

_lib: Optional[ctypes.CDLL] = None


class NativeBuildError(RuntimeError):
    pass


def library_path(flags=GXX_FLAGS) -> Path:
    """Where the library built from SOURCE with ``flags`` lives."""
    h = hashlib.sha256(" ".join(flags).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libkmpc_native_{h.hexdigest()[:16]}.so"


def _compile(flags) -> Tuple[Path, subprocess.CompletedProcess]:
    out = library_path(flags)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        res = subprocess.run(["g++", *flags, "-o", str(tmp), str(SOURCE)],
                             capture_output=True, text=True, timeout=300)
    except FileNotFoundError as e:
        raise NativeBuildError("g++ not found") from e
    if res.returncode == 0:
        os.replace(tmp, out)
    else:
        tmp.unlink(missing_ok=True)
    return out, res


def build_native(force: bool = False) -> Path:
    """Build the library unless an up-to-date one exists; returns its path
    (the OpenMP build, else the one without ``-fopenmp``)."""
    no_omp = [f for f in GXX_FLAGS if f != "-fopenmp"]
    if not force:
        for flags in (GXX_FLAGS, no_omp):
            if library_path(flags).exists():
                return library_path(flags)
    out, res = _compile(GXX_FLAGS)
    if res.returncode != 0:
        # Retry without OpenMP (toolchains without libgomp).
        out, res = _compile(no_omp)
        if res.returncode != 0:
            raise NativeBuildError(f"native build failed:\n{res.stderr}")
    return out


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build_native()))
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.kmpc_solve_log_utility.restype = ctypes.c_int
    lib.kmpc_solve_log_utility.argtypes = [
        f32p,                                               # current_weights
        f32p,                                               # pred_log_returns
        ctypes.c_int, ctypes.c_int, ctypes.c_int,           # B, H, N
        ctypes.c_float, ctypes.c_float, ctypes.c_int,       # cost, turnover, short
        ctypes.c_int, ctypes.c_float, ctypes.c_float,       # iters, sigma, step
        ctypes.c_float,                                     # ridge
        f32p,                                               # out
    ]
    lib.kmpc_solve_mean_variance.restype = ctypes.c_int
    lib.kmpc_solve_mean_variance.argtypes = [
        f32p,                                               # current_weights
        f32p,                                               # mu
        f32p,                                               # sigma_mats
        ctypes.c_int, ctypes.c_int, ctypes.c_int,           # B, H, N
        ctypes.c_float, ctypes.c_float, ctypes.c_int,       # gamma, cost, short
        ctypes.c_int, ctypes.c_float, ctypes.c_float,       # iters, sigma, step
        f32p,                                               # out
    ]
    lib.kmpc_num_threads.restype = ctypes.c_int
    _lib = lib
    return lib


def native_available() -> bool:
    try:
        _load()
        return True
    except NativeBuildError:
        return False


def num_threads() -> int:
    return int(_load().kmpc_num_threads())


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def solve_mpc_log_utility_native(
    current_weights: np.ndarray,
    predicted_log_returns: np.ndarray,
    cost_coeff: float = 0.001,
    max_turnover: float = 0.2,
    allow_short: bool = False,
    max_iters: int = 2000,
    sigma_scale: float = 2.0,
    step_scale: float = 1.0,
    ridge: float = 0.0,
) -> Tuple[np.ndarray, Dict]:
    """Batched host solve. Accepts [N]/[H,N] or [B,N]/[B,H,N]; returns
    weights with the matching batch shape."""
    lib = _load()
    cw = np.ascontiguousarray(current_weights, dtype=np.float32)
    ys = np.ascontiguousarray(predicted_log_returns, dtype=np.float32)
    single = ys.ndim == 2
    if single:
        cw = cw[None]
        ys = ys[None]
    B, H, N = ys.shape
    out = np.empty((B, H, N), dtype=np.float32)
    ret = lib.kmpc_solve_log_utility(
        _ptr(cw), _ptr(ys), B, H, N,
        float(cost_coeff), float(max_turnover), int(allow_short),
        int(max_iters), float(sigma_scale), float(step_scale), float(ridge),
        _ptr(out),
    )
    if ret != 0:
        raise RuntimeError(f"native solver returned {ret}")
    return (out[0] if single else out), {"status": "optimal"}


def solve_mpc_mean_variance_native(
    current_weights: np.ndarray,
    mu: np.ndarray,
    sigma_mats: np.ndarray,
    gamma: float = 1.0,
    cost_coeff: float = 0.001,
    allow_short: bool = False,
    max_iters: int = 2000,
    sigma_scale: float = 2.0,
    step_scale: float = 1.0,
) -> Tuple[np.ndarray, Dict]:
    """Batched host mean-variance solve (the Markowitz baseline's program;
    the iteration of ``ops/mpc.py``'s ``solve_mpc_mean_variance_batch`` in
    double precision). Accepts [N]/[H,N]/[N,N] or batched
    [B,N]/[B,H,N]/[B,N,N]; a single [N,N] Sigma broadcasts over B."""
    lib = _load()
    cw = np.ascontiguousarray(current_weights, dtype=np.float32)
    m = np.ascontiguousarray(mu, dtype=np.float32)
    single = m.ndim == 2
    if single:
        cw = cw[None]
        m = m[None]
    B, H, N = m.shape
    sig = np.ascontiguousarray(
        np.broadcast_to(np.asarray(sigma_mats, dtype=np.float32), (B, N, N))
    )
    out = np.empty((B, H, N), dtype=np.float32)
    ret = lib.kmpc_solve_mean_variance(
        _ptr(cw), _ptr(m), _ptr(sig), B, H, N,
        float(gamma), float(cost_coeff), int(allow_short),
        int(max_iters), float(sigma_scale), float(step_scale), _ptr(out),
    )
    if ret != 0:
        raise RuntimeError(f"native MV solver returned {ret}")
    return (out[0] if single else out), {"status": "optimal"}
