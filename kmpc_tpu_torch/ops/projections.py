"""Michelot simplex / l1-ball thresholds on the trailing (asset) axis.

Port of the thresholds in kmpc_tpu/ops/projections.py and of the fused
solver's schedule (kmpc_tpu/ops/mpc_pallas.py ``_packed_threshold``,
``_ball_l1_and_sweep``): theta with sum(max(v - theta, 0)) == radius by the
sort-free iteration

    theta_{k+1} = (sum_{v_i > theta_k} v_i - radius) / max(|S_k|, 1),

Newton's method on a convex piecewise-linear function, so it converges
from a cold start theta_0 = (sum v - radius) / n or from a warm theta
carried over from the previous solver iteration. On top of the thresholds
stand the closed-form projections and proxes of the eager solvers
(simplex, l1 ball, soft threshold, box, hyperplane). Plain tensor code; the
plain versions of the CUDA kernels use the thresholds.
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


def project_simplex_warm(
    v: torch.Tensor, radius: float, theta0: torch.Tensor, num_iters: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Simplex projection from a carried threshold: (w, theta), so an outer
    loop can carry theta and run only a few sweeps per projection."""
    theta = simplex_threshold(v, radius, num_iters=num_iters, theta0=theta0)
    return torch.clamp(v - theta, min=0.0), theta


def soft_threshold(v: torch.Tensor, threshold) -> torch.Tensor:
    """prox of t*||.||_1: sign(v) * max(|v| - t, 0)."""
    return torch.sign(v) * torch.clamp(v.abs() - threshold, min=0.0)


def prox_l1_in_ball_warm(
    v: torch.Tensor, shrink_t, radius: float, theta0: torch.Tensor,
    num_iters: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """prox of t*c*||u||_1 + indicator(||u||_1 <= radius) from a carried
    ball threshold: (u, theta), theta unclamped for the next warm start."""
    s = soft_threshold(v, shrink_t)
    a = s.abs()
    l1 = a.sum(dim=-1, keepdim=True)
    theta = simplex_threshold(a, radius, num_iters=num_iters, theta0=theta0)
    projected = torch.sign(s) * torch.clamp(a - torch.clamp(theta, min=0.0),
                                            min=0.0)
    return torch.where(l1 <= radius, s, projected), theta


def project_simplex(v: torch.Tensor, radius: float = 1.0) -> torch.Tensor:
    """Projection onto {w >= 0, sum(w) = radius} over the last axis. A last
    exact-sum correction spreads the float32 cancellation residual over the
    active set, so the sum is exact to about one ulp for any input."""
    theta = simplex_threshold(v, radius)
    w = torch.clamp(v - theta, min=0.0)
    active = w > 0
    count = active.sum(dim=-1, keepdim=True).to(v.dtype)
    s = w.sum(dim=-1, keepdim=True)
    corr = (radius - s) / torch.clamp(count, min=1.0)
    return torch.clamp(torch.where(active, w + corr, torch.zeros_like(w)),
                       min=0.0)


def project_l1_ball(v: torch.Tensor, radius: float) -> torch.Tensor:
    """Projection onto {||u||_1 <= radius}: identity inside, else a soft
    threshold by the simplex threshold of |v| (Duchi et al. 2008), with a
    multiplicative exact-radius correction. radius <= 0 gives zeros."""
    if radius <= 0.0:
        return torch.zeros_like(v)
    a = v.abs()
    l1 = a.sum(dim=-1, keepdim=True)
    theta = torch.clamp(simplex_threshold(a, radius), min=0.0)
    projected = torch.sign(v) * torch.clamp(a - theta, min=0.0)
    s = projected.abs().sum(dim=-1, keepdim=True)
    projected = projected * torch.clamp(radius / torch.clamp(s, min=1e-30),
                                        max=1.0)
    return torch.where(l1 <= radius, v, projected)


def prox_l1_in_ball(v: torch.Tensor, shrink_t, radius: float) -> torch.Tensor:
    """prox of t*c*||u||_1 + indicator(||u||_1 <= radius): soft threshold,
    then the l1-ball projection (exact for this separable-sign pair)."""
    return project_l1_ball(soft_threshold(v, shrink_t), radius)


def project_box(v: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """Clip to [lo, hi]."""
    return torch.clamp(v, lo, hi)


def project_hyperplane_sum(v: torch.Tensor, total: float = 1.0) -> torch.Tensor:
    """Projection onto {sum(w) = total} (no sign constraint)."""
    n = v.shape[-1]
    return v - (v.sum(dim=-1, keepdim=True) - total) / n
