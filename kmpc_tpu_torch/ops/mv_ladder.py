"""Attribution ladder of the mean-variance H=1 PDHG loop on the card.

Port of scripts/mv_ladder.py (its Pallas ``make_kernel`` / ``run``): stripped
H=1 bodies in the loop shape of the production mean-variance kernel
(``csrc/pdhg_mean_variance.cuh``), timed one against the other so that an
iteration's cost splits into

    carry   the loop's floor (one multiply-add per iterate, no reduction),
    sigma   + the quadratic gradient Sigma w (projection: a clamp at 0),
    proj    + one warm Michelot sweep per iteration (the production body
            without its refresh schedule),

each with ``unroll`` 1 or 4 iterations per loop trip (``iters // unroll``
trips; the remainder is dropped, as in the script) and ``chains`` 1, 2 or 4
independent problems interleaved per warp. The script's tile ladder (128,
256, 512 lanes per block) has no meaning on this card, where a problem owns
a warp; its counterpart here is the warps per block (1, 2, 4, 8). Constants
as in the script: gamma 5, c 0.001, ``sigma_scale`` 2, steps from
``sqrt(L + 1)``, ``w0`` the current weights, ``p0 = 0``, ``theta0 = 0``; the
output is the loop's last ``w``.

    python -m kmpc_tpu_torch.ops.mv_ladder [--batch 4096] [--iters 1000]
        [--N 30] [--cpu]

prints one line per rung: milliseconds, microseconds per iteration, solves
per second. ``carry``'s time is the card's floor for this loop shape. A
CUDA tensor launches ``csrc/mv_ladder.cu`` or raises; a CPU tensor (``--cpu``)
runs ``mv_ladder_plain``, whose times are the host's and say nothing about
the card.
"""

from __future__ import annotations

import argparse
import ctypes
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from kmpc_tpu_torch._build import CudaKernel
from kmpc_tpu_torch.ops.mpc_cuda import SMEM_PER_BLOCK, _require_cuda_f32
from kmpc_tpu_torch.ops.projections import michelot_sweep

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

MV_LADDER = CudaKernel(
    "mv_ladder", "kmpc_mv_ladder",
    [_P] * 4 + [_I] * 7 + [_F] * 3 + [_P],
)

VARIANTS = ("carry", "sigma", "proj")
UNROLLS = (1, 4)
CHAINS = (1, 2, 4)
MAX_WARPS = 8
GAMMA, COST, SIGMA_SCALE = 5.0, 0.001, 2.0

# (variant, unroll, chains, warps per block): scripts/mv_ladder.py's rungs,
# with its 128 / 256 / 512-lane tiles read as 2 / 4 / 8 warps per block, and
# one warp per block added.
RUNGS = (
    ("carry", 4, 1, 4), ("sigma", 4, 1, 4), ("proj", 4, 1, 4),
    ("proj", 1, 1, 4),
    ("proj", 4, 1, 1), ("proj", 4, 1, 2), ("proj", 4, 1, 8),
    ("proj", 4, 2, 2), ("proj", 4, 2, 4), ("proj", 4, 4, 2),
)


def ladder_inputs(B: int, N: int, seed: int = 0):
    """The script's inputs as numpy: current weights [B, N], forecasts
    [B, N] and covariances [B, N, N]."""
    rng = np.random.default_rng(seed)
    cw = rng.dirichlet(np.ones(N), size=B).astype(np.float32)
    mu = (rng.standard_normal((B, 1, N)) * 0.01).astype(np.float32)
    A = rng.standard_normal((B, N, N)) * 0.01
    sig = (np.einsum("bij,bkj->bik", A, A) + np.eye(N) * 1e-4) \
        .astype(np.float32)
    return cw, mu[:, 0], sig


def ladder_smem_bytes(N: int, chains: int, warps: int) -> int:
    """Shared memory of one block: a covariance (N columns of ceil32(N)
    floats) per chain and warp."""
    return warps * chains * N * 32 * (-(-N // 32)) * 4


def _check(variant, unroll, chains, warps, N):
    if variant not in VARIANTS or unroll not in UNROLLS \
            or chains not in CHAINS or not 1 <= warps <= MAX_WARPS:
        raise ValueError(
            f"expected variant in {VARIANTS}, unroll in {UNROLLS}, chains "
            f"in {CHAINS} and 1 <= warps <= {MAX_WARPS}, got {variant!r}, "
            f"{unroll}, {chains}, {warps}")
    if not 1 <= N <= 128:
        raise ValueError(f"N={N}: the ladder is compiled for 1 <= N <= 128")
    need = ladder_smem_bytes(N, chains, warps)
    if need > SMEM_PER_BLOCK:
        raise ValueError(
            f"N={N}, chains={chains}, warps={warps} need {need} bytes of a "
            f"block's {SMEM_PER_BLOCK} bytes of shared memory")


def mv_ladder_plain(cw: torch.Tensor, mu: torch.Tensor, Sigma: torch.Tensor,
                    variant: str, iters: int, unroll: int = 4) -> torch.Tensor:
    """A rung's computation in plain tensor code: cw, mu [B, N], Sigma
    [B, N, N] -> the loop's last w [B, N]. ``chains`` and the warps per
    block do not enter: the chains are independent problems."""
    _check(variant, unroll, 1, 1, cw.shape[-1])
    fro = torch.sqrt((Sigma * Sigma).sum(dim=(-2, -1)))[:, None]
    L = torch.clamp(2.0 * GAMMA * fro, min=1e-6)
    sg = SIGMA_SCALE * torch.sqrt(L + 1.0) / 2.0
    tau = 1.0 / (0.5 * L + sg * 4.0)
    w, p = cw, torch.zeros_like(cw)
    th = torch.zeros_like(cw[:, :1])
    for _ in range((iters // unroll) * unroll):
        if variant == "carry":
            w2 = w - tau * (p - mu)
            w, p = w2, p + sg * (w2 - w)
            continue
        quad = (Sigma * w[:, None, :]).sum(dim=-1)
        v = w - tau * ((2.0 * GAMMA * quad - mu) + p)
        if variant == "proj":
            th = michelot_sweep(v, 1.0, th)
            w_new = torch.clamp(v - th, min=0.0)
        else:
            w_new = torch.clamp(v, min=0.0)
        p = torch.clamp(p + sg * ((2.0 * w_new - w) - cw), -COST, COST)
        w = w_new
    return w


def mv_ladder_cuda(cw, mu, Sigma, variant: str, iters: int, unroll: int = 4,
                   chains: int = 1, warps: int = 4) -> torch.Tensor:
    """One launch of a rung's kernel on the current stream, for contiguous
    float32 CUDA tensors."""
    if cw.dim() != 2 or mu.shape != cw.shape \
            or Sigma.shape != (*cw.shape, cw.shape[1]):
        raise ValueError(
            f"expected cw, mu [B, N] and Sigma [B, N, N], got "
            f"{tuple(cw.shape)}, {tuple(mu.shape)}, {tuple(Sigma.shape)}")
    B, N = cw.shape
    _check(variant, unroll, chains, warps, N)
    _require_cuda_f32(cw=cw, mu=mu, Sigma=Sigma)
    w = torch.empty_like(cw)
    if B == 0:
        return w
    fn = MV_LADDER.function()
    with torch.cuda.device(cw.device):
        stream = torch.cuda.current_stream(cw.device).cuda_stream
        err = fn(cw.data_ptr(), mu.data_ptr(), Sigma.data_ptr(), w.data_ptr(),
                 B, N, iters, VARIANTS.index(variant), unroll, chains, warps,
                 GAMMA, COST, SIGMA_SCALE, stream)
    if err != 0:
        raise RuntimeError(f"mv_ladder kernel launch failed: CUDA error {err}")
    MV_LADDER.launches += 1
    return w


def mv_ladder(cw, mu, Sigma, variant: str, iters: int, unroll: int = 4,
              chains: int = 1, warps: int = 4) -> torch.Tensor:
    """The kernel for CUDA tensors, its plain version for CPU tensors."""
    if cw.is_cuda:
        return mv_ladder_cuda(cw, mu, Sigma, variant, iters, unroll, chains,
                              warps)
    _check(variant, unroll, chains, warps, cw.shape[-1])
    return mv_ladder_plain(cw, mu, Sigma, variant, iters, unroll)


def _time_ms(fn, reps: int, device: torch.device) -> float:
    """Median milliseconds of ``fn()`` after a warm-up: CUDA events on the
    card, the host clock on the CPU."""
    fn()
    times = []
    for _ in range(reps):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize(device)
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            times.append(1e3 * (time.perf_counter() - t0))
    return float(np.median(times))


def run_ladder(B: int = 4096, N: int = 30, iters: int = 1000, reps: int = 5,
               device="cuda") -> List[Dict]:
    """Time every rung of ``RUNGS`` on ``device`` (the median of ``reps``
    runs after a warm-up); one dict per rung with ``ms``,
    ``us_per_iter`` (the whole batch's loop, per iteration) and
    ``solves_per_s``."""
    dev = torch.device(device)
    cw, mu, sig = (torch.as_tensor(x, device=dev).contiguous()
                   for x in ladder_inputs(B, N))
    out = []
    for variant, unroll, chains, warps in RUNGS:
        ms = _time_ms(lambda: mv_ladder(cw, mu, sig, variant, iters, unroll,
                                        chains, warps), reps, dev)
        done = max((iters // unroll) * unroll, 1)
        out.append({"variant": variant, "unroll": unroll, "chains": chains,
                    "warps": warps, "ms": ms, "us_per_iter": 1e3 * ms / done,
                    "solves_per_s": B / (ms / 1e3)})
    return out


def main(argv: Optional[List[str]] = None) -> List[Dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--iters", type=int, default=1000)
    ap.add_argument("--N", type=int, default=30)
    ap.add_argument("--cpu", action="store_true",
                    help="run the plain versions on the CPU (host times)")
    args = ap.parse_args(argv)

    from kmpc_tpu_torch import default_device

    device = torch.device("cpu") if args.cpu else default_device()
    where = ("cpu, plain versions" if args.cpu
             else torch.cuda.get_device_name(device))
    print(f"B={args.batch} N={args.N} iters={args.iters} "
          f"(H=1 MV ladder, {where})", flush=True)
    rows = run_ladder(args.batch, args.N, args.iters, device=device)
    for r in rows:
        print(f"{r['variant']:6s} warps={r['warps']} chains={r['chains']} "
              f"unroll={r['unroll']}: {r['ms']:9.4f} ms  "
              f"{r['us_per_iter']:8.4f} us/iter  "
              f"({r['solves_per_s']:,.0f} solves/s)", flush=True)
    return rows


if __name__ == "__main__":
    main()
