"""Michelot simplex / l1-ball thresholds on the trailing (asset) axis.

Port of the thresholds in kmpc_tpu/ops/projections.py and of the fused
solver's schedule (kmpc_tpu/ops/mpc_pallas.py ``_packed_threshold``,
``_ball_l1_and_sweep``): theta with sum(max(v - theta, 0)) == radius by the
sort-free iteration

    theta_{k+1} = (sum_{v_i > theta_k} v_i - radius) / max(|S_k|, 1),

Newton's method on a convex piecewise-linear function, so it converges
from a cold start theta_0 = (sum v - radius) / n or from a warm theta
carried over from the previous solver iteration. Plain tensor code; the
reference version of the CUDA kernel uses it.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

_NEG = -1e30


def michelot_iters_for(n: int) -> int:
    """Cold iteration budget at dimension n."""
    if n <= 64:
        return 8
    if n <= 256:
        return 12
    return 16


def michelot_sweep(v: torch.Tensor, radius, theta: torch.Tensor) -> torch.Tensor:
    """One sweep over the last axis: theta [..., 1] -> theta [..., 1]."""
    active = v > theta
    count = active.sum(dim=-1, keepdim=True).to(v.dtype)
    s = torch.where(active, v, torch.zeros_like(v)).sum(dim=-1, keepdim=True)
    return (s - radius) / torch.clamp(count, min=1.0)


def cold_threshold(v: torch.Tensor, radius) -> torch.Tensor:
    """Cold start (sum v - radius) / n. Like the fused kernel, values at or
    below -5e29 (its padding mask) are left out of the sum."""
    n = v.shape[-1]
    v0 = torch.where(v > 0.5 * _NEG, v, torch.zeros_like(v))
    return (v0.sum(dim=-1, keepdim=True) - radius) / float(n)


def michelot_threshold(
    v: torch.Tensor,
    radius,
    num_iters: int,
    theta0: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``num_iters`` sweeps from ``theta0``, or from the cold start when
    ``theta0`` is None (the fused kernel's ``_packed_threshold``)."""
    theta = cold_threshold(v, radius) if theta0 is None else theta0
    for _ in range(num_iters):
        theta = michelot_sweep(v, radius, theta)
    return theta


def ball_l1_and_sweep(
    a: torch.Tensor, radius, theta0: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(l1 of ``a``, theta after one warm sweep): the ball-membership test
    and the first threshold sweep of the dual prox, taken together."""
    l1 = a.sum(dim=-1, keepdim=True)
    return l1, michelot_sweep(a, radius, theta0)


def simplex_threshold(
    v: torch.Tensor,
    radius: float,
    num_iters: Optional[int] = None,
    theta0: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Threshold with the row max subtracted first (theta(v - m) =
    theta(v) - m), for inputs far from the radius' scale."""
    n = v.shape[-1]
    if num_iters is None:
        num_iters = michelot_iters_for(n)
    vmax = v.amax(dim=-1, keepdim=True)
    vc = v - vmax
    if theta0 is None:
        theta = (vc.sum(dim=-1, keepdim=True) - radius) / n
    else:
        theta = theta0 - vmax
    for _ in range(num_iters):
        theta = michelot_sweep(vc, radius, theta)
    return theta + vmax

