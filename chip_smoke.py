#!/usr/bin/env python3
"""Drive kmpc_tpu_torch on one CUDA card and check it end to end.

    python3 chip_smoke.py [--seed 0]

Phases (each prints JSON lines; any failure raises and exits non-zero):

1. ``build``: the card, torch and CUDA versions, the build of the nineteen
   kernel sources (one nvcc per source, started together, from the sources
   in this checkout) with each build's seconds, registers and spills (every
   instantiation but the ladder's), and the wrappers' copies of the block
   and row layouts' shared-memory plans against the built kernels';
2. ``kernels``: every CUDA kernel against its plain PyTorch version on the
   card: the log-utility kernel over the parametrised cases of the CPU
   tests, the edges of its register budget and the main-path and bench
   shapes; the same kernel with warm inputs and the dual output; the
   scenario kernel; the mean-variance kernel with a per-problem and a
   shared covariance; the adaptive body of all three (``adapt_every`` 1
   and 2, ``precond`` off and on, ridge, over-relaxation, no ball, cold
   projections, warm inputs, an odd iteration count, the budget's edges);
   the pipelined body of kernels A and B in the warp and the block layout
   (refresh 8 and 16, an odd iteration count, ball on and off, precond,
   ridge, warm inputs and the dual output); the block layout's fixed-step
   and adaptive bodies at H=20 N=30, H=5 N=500, H=3 N=150, N=129, H=17,
   N=600 (several columns a thread) and S=16 H=20 N=20; kernel C's block
   layout (C.2) at the edges of kmpc_tpu's envelope (per-problem
   covariances at H=17, H=340, N=65, N=112, H=16 N=88; a shared one at
   N=129, N=1112, N=480 at H=5, N=128 at H=20; adaptive at N=976 shared
   and H=20 N=64; over-relaxation, cold projections); every block case
   run twice and required to give the same bits; the row layout (one warp
   per horizon row) beside the warp and block layouts at every case
   whose shape it takes, run twice for the same bits and compared bit for
   bit with the warp kernel, and at cases of its own (H in {1, 5, 8, 17,
   20, 32}, one to four slots, scenario returns past its registers, warm
   inputs and the dual output); every rung of the MV ladder; then
   ``layouts``: every layout of kernels A and B that takes the shape, timed
   at the exact scan's (B=1), the comparison's (B=1028) and the headline's
   (B=65536) batch at H=5, at H=1, and at the long path's H=20 (B=1013,
   S=16 too) and bench.py's long shape, the routed layout required to be
   the fastest; and of kernel C at the Markowitz path's shape (H=1, N=20)
   and at H=5, N=30;
3. ``nan_row``, ``probe``, ``probe_accurate``: a NaN forecast holds the
   weights; accuracy on the 64 bench probe instances against the float64
   oracle objectives in bench_probe_cache.json, at the bench setting and
   at the accurate one (adaptive steps, 800 iterations);
4. ``main_path``: finance_sparse at full width (observation 400, latent
   1024) with seeded random weights on the synthetic panel, the H=5
   forecast for every test date, and the Jacobi backtest, 4 sweeps of the
   fused solve (the row kernel), for Koopman-MPC and buy-and-hold; the
   kernel's launch count must equal the number of sweeps;
5. ``comparison``: the full strategy comparison on the same data:
   buy-and-hold, Markowitz, DMD, Koopman-MPC and scenario Kelly (S=16), 8
   sweeps each, every batched solve through its kernel; then Koopman-MPC
   again with warm sweeps of 500 iterations. Launches per kernel must equal
   sweeps times the strategies that use it, every weight row must lie on
   the simplex and within the turnover cap, the warm-swept final value must
   agree with the same sweeps run through the eager solver, and in every
   warm sweep the warm solutions are held, in objective, against cold
   solves from the same pre-trade weights at the full budget and at the
   warm budget (the line also reports how far the sweeps are from
   converged: the last sweep's largest move of a pre-trade guess, and a
   cold run of twice the sweeps);
6. ``accurate_path``: the same comparison with the configuration's solver
   set to the accurate configuration (``ADAPTIVE``, ``ADAPT_EVERY=2``,
   ``PRECOND``, 800 iterations), 4 sweeps: every solve through an adaptive
   kernel, launches counted per kernel, every weight row feasible, the
   first sweep's solves held against the plain versions;
7. ``scan_path``: the exact backtest, one solve of one problem per date,
   at the accurate configuration: buy-and-hold and Koopman-MPC over all
   dates (as many launches as dates), Markowitz, DMD and scenario Kelly on
   a test split cut to 64 dates; on the cut split the Jacobi backtest with
   as many sweeps as dates must give the scan's portfolio values;
8. ``long_path``: the comparison at H=20 with the pipeline configuration
   (``PROJ_REFRESH_EVERY=16``, ``PIPELINE_REDUCES``, ``PRECOND``), 4
   sweeps: DMD and Koopman-MPC through kernel A's row layout, scenario
   Kelly through kernel B's, Markowitz through C; then Koopman-MPC and
   scenario Kelly at the accurate configuration at H=20 and with the
   pipeline configuration at H=5, 2 sweeps each; launches per kernel,
   feasibility and the first solves against the plain versions as in
   ``accurate_path``; then ``warp_path``: the warp layout's six kernels at
   the three configurations, kernel A's (which routing no longer picks)
   launched in that layout on the comparison's first-sweep problems, kernel
   B's through its packed entry point at a shape that routes to it (B=132,
   S=113, H=8, N=64), and ``block_path``: the block layout's four kernels at
   a shape past the row layout (B=1028, H=5, N=150, one forecast and
   S=16), each launch counted and each held against its plain version;
9. ``mv_long_wide``: the mean-variance solve past the warp layout (C.2)
   at bench.py's Markowitz settings (1000 iterations at refresh 16, and
   1000 adaptive) on bench.py's problems: per-problem covariances at
   B=4096, H=20 N=30 and H=5 N=100, one shared covariance at B=1028, H=1
   N=960, H=5 N=320, H=20 N=64; launches counted through the entry point,
   every row feasible, the block kernels against their plain version
   (twice for the same bits), times, bounds, registers, and the objective
   gap on the shape's 16 probe instances to a float64 adaptive-PDHG run of
   40000 iterations of the port's eager solver on the card;
10. ``mv_ladder``: the rungs of the MV ladder at B=4096, N=30, 1000
   iterations;
11. ``headline``, ``accurate_headline``: the solve at B=65536, H=5, N=30,
   at the bench setting (1000 iterations) and at the accurate one (800);
   ``large_headline``: bench.py's ``long`` shape (B=16384, H=20, N=30, 1000
   iterations, and 4000 adaptive) and ``assets500`` shape (B=4096, H=5,
   N=500, 1000 pipelined iterations, and 10000), with the gap on the
   shape's 16 probe instances to the float64 references cached in
   bench_probe_cache.json;
12. the ``kernels`` line, the card's name and power limit, and last
   ``{"ok": true, "device": {...}}``.

Adaptive steps and discrete decisions. The adaptive body grows or shrinks
its steps when one residual exceeds 1.5 times the other. The kernel sums
over assets by a warp butterfly and fuses multiply-adds, the plain version
uses ``torch.sum``, so their iterates differ in the last bits, and where a
decision falls within rounding of a tie the two take different branches:
from there on they are two valid runs of the same solver whose step
histories differ, and they end apart by about the solver's own accuracy at
that budget, not by rounding. So for an adaptive case both sides also
return the steps they ended on and the signed sum of the iterations that
moved them, which two equal step histories share. Every problem whose
histories are equal must meet the bars of the fixed-step kernels, or lie
as close to the plain version run in float64 as float32 itself does
(``adaptive_agreement``). The script bounds how many problems end apart
and their objective difference, and requires the objective difference
over all problems of a large batch to be unbiased. The mean-variance
adaptive body does not settle on a few problems in float32 at N=960 (two
float32 runs of it, or of kmpc_tpu's, can end 1e-2 apart in objective):
a problem whose objectives differ beyond the bar where either side's
fixed-point residual shows it unsettled is held against the float64 run
on that problem (a settled side within the bar of it, an unsettled kernel
not above it, and unsettled on no more problems than the plain version);
the others keep the bars above. That the partings are ties is shown by
``python -m kmpc_tpu_torch.ops.adaptive_parting``, which traces the
problems that end apart to their first differing decision; it is no part
of this script.

Exits non-zero, printing no result, when CUDA is unavailable.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

# Published H100 SXM peaks (NVIDIA data sheet): FP32 outside the tensor
# cores and HBM3 bandwidth.
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12

OBJ_TOL = 1e-5     # objective, kernel vs plain (log-utility)
W_TOL = 5e-4       # weights and duals, kernel vs plain (log-utility)
SCEN_OBJ_TOL = 5e-5  # objective, scenario kernel vs plain
MV_OBJ_TOL = 1e-6  # objective, mean-variance kernel vs plain
MV_W_TOL = 5e-5    # weights, mean-variance kernel vs plain
FEAS_TOL = 1e-5    # simplex sum and turnover cap after restoration
BAND = 0.1         # status codes may differ within 10% of feas_tol
# Adaptive cases (see the module docstring). On an H100 step histories
# parted in 5-11% of 1028 problems at 800 iterations, and in most problems
# of a case that converges early, where the residuals are rounding noise:
# that alone is no fault. Problems that end apart (beyond the weight, dual
# or objective bar of the fixed-step kernels) may be at most BEYOND_SHARE of
# a large mean-variance case (0-1.0% there) and two of a small one (a
# log-utility case counts against its float64 run instead, see
# ``adaptive_agreement``); their objectives may differ by FLIP_OBJ_TOL
# (2.5e-5 there; the accurate setting's own p90 gap to the oracle is
# 2.2e-4), and the mean signed objective difference of a large case by
# FLIP_MEAN_OBJ_TOL (6e-8 there).
BEYOND_SHARE = 0.05
FLIP_OBJ_TOL = 3e-4
FLIP_MEAN_OBJ_TOL = 2e-6
# With equal step histories, an adaptive log-utility problem beyond a bar
# (objective, weights or duals) whose float32 and float64 plain runs also
# share their step history is held against the float64 run as referee: in
# each of the three the kernel may be at most REFEREE_FACTOR times the
# case's float32 noise (the float32 plain version's largest distance to it
# on such problems) from it, plus the bar. At N=500 the adaptive steps
# grow until the projection input carries a common offset whose 500-term
# float32 sums are off by ~1e-5, and two float32 runs of the adaptive plain
# version (float32 against float64, or with the assets permuted) part by
# 1.5e-5 to 2.3e-5 in objective at 400 iterations with equal step
# histories (tests/test_torch_port_large.py::
# test_adaptive_body_at_500_assets_is_at_float32s_limit).
REFEREE_FACTOR = 3.0
# The adaptive mean-variance body at N=960 does not settle on a few
# problems in float32: once the residuals are rounding noise the balancing
# grows tau past what the covariance's spectrum allows, and a run leaves
# the fixed point (residual up to 8e-2 on an H100; tests/
# test_torch_port_mv_block.py::
# test_adaptive_mean_variance_body_at_960_assets_is_at_float32s_limit). A
# problem whose objectives differ beyond the bar where either side's
# fixed-point residual exceeds MV_UNSETTLED_FP is held against the float64
# run instead (``hold_unsettled_mv``).
MV_UNSETTLED_FP = 1e-4
# The adaptive log-utility body past the row layout (``block_path``, B=1028
# at N=150, 800 iterations; ``wide`` cases) is at float32's limit as at
# N=500 (REFEREE_FACTOR): a few problems leave both float32 runs unsettled
# (fixed-point residual 1.6e-4 to 4.9e-4) and, where their step histories
# part, 7.9e-4 to 1.3e-3 apart in objective, either one within 2.4e-6 of
# the float64 run; such a problem is held against the float64 run as
# ``hold_unsettled`` says. And with S=16 one problem with equal histories
# ends 1.9e-3 from the float64 run in weights, where the plain version
# with its assets permuted ends the same 1.9e-3 from it while the plain
# version as given stays within 2.4e-5 (the two share the float64 run's
# summation order): so in a wide case the referee holds each problem to
# the larger of the case's float32 noise and that problem's own distance
# of the permuted plain version, where the permuted run's step history is
# the float64 run's too (measured on an H100, PERF.md section 6). Every
# other case keeps its bars.
LOG_UNSETTLED_FP = 1e-4
ACCURATE_PROBE_GAP = 1.5e-4  # median gap to the oracle, accurate setting
# A warm sweep's solution (500 iterations) against a cold full-budget solve
# from the same pre-trade weights: the largest objective deficit over the
# dates relative to the median size of the objective (about 5e-3 on this
# path), the mean deficit, and both as shares of what a cold solve of the
# same 500 iterations loses. Each bar is about twice to four times what an
# H100 run of this script showed (0.14, 1.1e-4, 0.19 and 0.07).
WARM_DEFICIT_REL = 0.25
WARM_DEFICIT_MEAN = 2e-4
WARM_VS_COLD_MAX_SHARE = 0.5
WARM_VS_COLD_MEAN_SHARE = 0.25


# Where the row kernel parts from the warp kernel's bits: nvcc picks which
# product of an expression to fuse into an fma per warp-layout
# instantiation (pow2ceil(H), ceil(N/32)), and the row kernel writes out
# the warp kernel's choice at the paths' instantiation HM=8, K=1 (PERF.md
# section 6). The instantiations (scenarios, HM, K, body) at which the two
# parted on an H100 in the ``kernels`` phase, with the first differing
# operation as per-phase dumps of both kernels found it; every other
# instantiation must give the warp kernel's bits. ROWS_BITS_PARTED is how many of the ``kernels`` phase's
# shared-shape cases parted there (11 of 113).
_ADAPTIVE_PROX = ("the adaptive dual prox's c / sigma, which the warp "
                  "kernels fuse into |v| - c / sigma and c / sigma + excess "
                  "at HM=8 K=1 and into one or the other of them elsewhere")
ROWS_BITS_TRACED = {
    (False, 1, 1, "adaptive"): _ADAPTIVE_PROX,
    (False, 1, 4, "adaptive"): _ADAPTIVE_PROX,
    (False, 4, 3, "adaptive"): _ADAPTIVE_PROX,
    (False, 4, 4, "adaptive"): _ADAPTIVE_PROX,
    (False, 8, 2, "adaptive"): _ADAPTIVE_PROX,
    (True, 8, 2, "adaptive"): _ADAPTIVE_PROX,
    (False, 8, 1, "ridge"): (
        "the primal step c1 w + (g - tau (p - p_next)), three products: no "
        "fusing of them gave the warp kernel's iteration 0 at HM=8 K=1"),
}
ROWS_BITS_PARTED = 11


def rows_bits_part(H, N, params, S=None):
    """Why the row kernel may part from the warp kernel's bits on this case
    (ROWS_BITS_TRACED: the adaptive body at the traced instantiations, the
    fixed step with a ridge at HM=8 K=1), or None where it must give
    them."""
    hm, k = 1 << max(H - 1, 0).bit_length(), -(-N // 32)
    body = ("adaptive" if params.adaptive
            else "ridge" if params.ridge != 0.0 else None)
    return ROWS_BITS_TRACED.get((S is not None, hm, k, body))


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: bool = True) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn()`` after a warm-up
    (``warmup=False``: the caller has just run ``fn`` itself)."""
    if warmup:
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def instance(B, H, N, seed, drift=0.0005):
    rng = np.random.default_rng(seed)
    cw = rng.dirichlet(np.ones(N), size=B).astype(np.float32)
    ys = (rng.standard_normal((B, H, N)) * 0.01 + drift).astype(np.float32)
    return cw, ys


def scenario_instance(B, S, H, N, seed):
    rng = np.random.default_rng(seed)
    cw = rng.dirichlet(np.ones(N), size=B).astype(np.float32)
    scen = (rng.standard_normal((B, S, H, N)) * 0.01).astype(np.float32)
    return cw, scen


def mv_instance(B, H, N, seed, shared=False, scale=0.05):
    rng = np.random.default_rng(seed)
    cw = rng.dirichlet(np.ones(N), size=B).astype(np.float32)
    mu = (rng.standard_normal((B, H, N)) * 0.01).astype(np.float32)
    A = rng.standard_normal((N, N) if shared else (B, N, N)) * scale
    sig = A @ np.swapaxes(A, -1, -2) + np.eye(N) * 1e-4
    return cw, mu, sig.astype(np.float32)


def _sweeps(params, N):
    """Michelot sweeps per projection, per iteration of the schedule."""
    from kmpc_tpu_torch.ops.mpc_cuda import _pipelined, _sweep_budgets

    warm, warm_iters, cold = _sweep_budgets(params, N)
    # The adaptive body runs the full budget every iteration.
    refresh = 0 if params.adaptive else params.proj_refresh_every
    # The pipelined body: one sweep, the full budget on every min(k, 8)-th
    # iteration and on the remainder's.
    kp = min(refresh, 8)
    full = params.max_iters // kp * kp if _pipelined(params) else 0
    per_iter = []
    for i in range(params.max_iters):
        if not warm:
            per_iter.append(cold)
        elif _pipelined(params):
            per_iter.append(warm_iters if i >= full or i % kp == kp - 1
                            else 1)
        elif refresh > 1:
            per_iter.append(warm_iters if i % refresh == 0 else 1)
        else:
            per_iter.append(warm_iters)
    return per_iter, cold


def _balancings(params) -> int:
    """Iterations on which the adaptive body takes its residuals."""
    if not params.adaptive:
        return 0
    return params.max_iters // max(params.adapt_every, 1)


def pdhg_ops(B, H, N, params, S=None) -> float:
    """FP32 operations of one fused log-utility solve, counted per element
    from the iteration (each add, multiply, compare or max is one; a sum
    over assets is one add per element). Per iteration: 7 for the primal
    step (portfolio sum, gradient, D'p, step; 1 more with a ridge), 9 for
    the projection output, the extrapolation and the dual input, 3 for the
    dual magnitude and 2 for the clip; 4 per Michelot sweep (compare,
    select, count, sum) on the primal side and, with the turnover ball,
    1 + 4 per sweep on the dual side (l1 and the sweeps); 4 for
    over-relaxation. With S scenarios the primal step's portfolio sum and
    gradient are taken per scenario and averaged: 4 S + 5 instead of 7.
    Once: the initial cold projection 3 + 4 * cold, the final half-step
    12 + 4 * cold (4 S + 10 + 4 * cold with scenarios). The adaptive body
    runs the full sweep budget every iteration, takes the dual prox on the
    a-scale (5 more: the two scalings by 1 / sigma, the difference to the
    clip, the scaling back and the subtraction) and, on each balancing
    iteration, 14 for the two residuals (the moves of w and p, their
    neighbours' differences, two divisions, two squares and sums)."""
    per_iter, cold = _sweeps(params, N)
    ball = params.max_turnover > 0
    primal = 7 if S is None else 4 * S + 5
    base = primal + 14 + (1 if params.ridge else 0) \
        + (4 if params.over_relax != 1.0 else 0) \
        + (5 if params.adaptive else 0)
    total = sum(base + 4 * n + (1 + 4 * n if ball else 0) for n in per_iter)
    total += 14 * _balancings(params)
    total += (3 + 4 * cold) + (primal + 5 + 4 * cold)
    return float(B) * H * N * total


def pdhg_bound(B, H, N, params, S=None, warm=False, dual=False):
    """(bound_ms, bound_by): the larger of the bytes moved once (cw and r
    in, w and fp out; the warm primal and dual in, the dual out, where
    used) over HBM and the FP32 operations over the peak."""
    rows = B * H * N
    floats = B * N + (S or 1) * rows + rows + B \
        + (2 * rows if warm else 0) + (rows if dual else 0)
    byte_ms = 4.0 * floats / PEAK_HBM_BYTES * 1e3
    op_ms = pdhg_ops(B, H, N, params, S) / PEAK_FP32_FLOPS * 1e3
    return (op_ms, "operations") if op_ms >= byte_ms else (byte_ms, "bytes")


def mv_ops(B, H, N, params) -> float:
    """FP32 operations of one fused mean-variance solve, per element: the
    primal step 2 N (Sigma w: a multiply and an add per column) + 6
    (gradient, D'p, step), 2 for the projection output, 7 for the
    extrapolation, the dual input and the clip, 4 per Michelot sweep, 4 for
    over-relaxation. Once: the initial cold projection 3 + 4 * cold, the
    final half-step 2 N + 10 + 4 * cold, and the Frobenius norm 2 N. On
    each balancing iteration of the adaptive body 14 for the residuals."""
    per_iter, cold = _sweeps(params, N)
    base = 2 * N + 15 + (4 if params.over_relax != 1.0 else 0)
    total = sum(base + 4 * n for n in per_iter)
    total += 14 * _balancings(params)
    total += (3 + 4 * cold) + (2 * N + 10 + 4 * cold)
    return float(B) * H * N * total + 2.0 * B * N * N


def mv_bound(B, H, N, params, shared):
    """(bound_ms, bound_by) of the mean-variance solve: cw, mu and Sigma in
    (one Sigma when shared), w and fp out."""
    floats = B * N + 2 * B * H * N + B + (N * N if shared else B * N * N)
    byte_ms = 4.0 * floats / PEAK_HBM_BYTES * 1e3
    op_ms = mv_ops(B, H, N, params) / PEAK_FP32_FLOPS * 1e3
    return (op_ms, "operations") if op_ms >= byte_ms else (byte_ms, "bytes")


def simplex_error(w):
    """The largest distance of a row's sum from 1, in float64."""
    return (w.double().sum(-1) - 1.0).abs().max().item()


def check_feasible(w, cw, params, label, sum_tol=FEAS_TOL):
    w = w.double()
    s = w.sum(-1)
    assert torch.all((s - 1.0).abs() <= sum_tol), \
        f"{label}: simplex sum off by {(s - 1.0).abs().max().item()}"
    assert torch.all(w >= -FEAS_TOL), f"{label}: negative weight"
    if params.max_turnover > 0:
        prev = torch.cat([cw.double()[:, None], w[:, :-1]], dim=1)
        to = (w - prev).abs().sum(-1)
        assert torch.all(to <= params.max_turnover + FEAS_TOL), \
            f"{label}: turnover {to.max().item()}"


def compare_case(label, B, H, N, params, seed, S=None, warm=False,
                 dual=False, time_reps=3, time_plain=True, layouts=None):
    """A log-utility kernel and the plain version on the same card inputs,
    through the same finalisation; returns the case's JSON fields by
    layout (``compare_layouts``). With S the scenario kernel. ``dual``
    also compares the loop's last dual. ``warm`` compares a continuation of
    a quarter of the budget from the iterates of a cold plain solve (and
    its dual output)."""
    if S is None:
        cw_np, ys_np = instance(B, H, N, seed)
    else:
        cw_np, ys_np = scenario_instance(B, S, H, N, seed)
    cw = torch.as_tensor(cw_np, device="cuda")
    r = torch.exp(torch.as_tensor(ys_np, device="cuda")).contiguous()
    return compare_layouts(label, cw, r, params, warm, dual, time_reps,
                           time_plain, layouts)


def compare_tensors(label, cw, r, params, warm=False, dual=False,
                    time_reps=3, time_plain=True, wide=False):
    """``compare_layouts`` for the layout the wrapper routes the shape to;
    returns that layout's case."""
    from kmpc_tpu_torch.ops import mpc_cuda as M

    S = r.shape[1] if r.dim() == 4 else None
    layout = M.kernel_layout(S, r.shape[-2], r.shape[-1])
    return compare_layouts(label, cw, r, params, warm, dual, time_reps,
                           time_plain, [layout], wide)[layout]


def pinned_kernel(layout, r, params):
    """The kernel of ``layout`` for a solve of gross returns ``r`` [B, H, N]
    or [B, S, H, N] with these parameters' body; ``ValueError`` where the
    layout does not take the shape."""
    from kmpc_tpu_torch.ops import mpc_cuda as M

    S = r.shape[1] if r.dim() == 4 else None
    H, N = r.shape[-2], r.shape[-1]
    if layout not in M.LAYOUTS:
        raise ValueError(f"layout must be one of {M.LAYOUTS}, got {layout!r}")
    if not M.layout_supports(layout, S, H, N):
        raise ValueError(
            f"the {layout} layout does not take S={S}, H={H}, N={N}")
    return M._KERNELS[(S is not None, layout, M._body(params))]


def pinned(layout, cw, r, params, w_warm=None, p_warm=None,
           return_dual=False, return_steps=False):
    """``pdhg_log_utility_cuda`` in ``layout`` (which must take the shape)
    instead of the one routing gives: that layout's kernel for the
    parameters' body, launched and counted as the entry point launches it.
    For the phases that compare layouts, and for ``warp_path``, which drives
    the warp layout's kernel A at the paths' shapes, where routing takes the
    row layout."""
    from kmpc_tpu_torch.ops import mpc_cuda as M

    kernel = pinned_kernel(layout, r, params)
    warm = {k: v for k, v in (("w_warm", w_warm), ("p_warm", p_warm))
            if v is not None}
    M._require_cuda_f32(current_weights=cw, r=r, **warm)
    return M._launch(kernel, M._body(params), cw, r, params, w_warm, p_warm,
                     return_dual, return_steps)


def compare_layouts(label, cw, r, params, warm=False, dual=False,
                    time_reps=3, time_plain=True, layouts=None,
                    wide=False):
    """Each of ``layouts`` (default: the one the wrapper routes to) on given
    card tensors, launched in that layout (``pinned``), against one
    run of the plain version: current weights [B, N] and gross returns
    [B, H, N] or [B, S, H, N]. With ``params.adaptive`` the bars are
    applied as ``adaptive_agreement`` says. A row or block kernel runs
    twice and must give the same bits (its rows or its reduces meet in
    shared memory: a missing barrier shows as a run-to-run difference).
    Where the warp and the row layout both run, the row kernel's outputs
    (weights, fixed-point residual, dual, steps) must equal the warp
    kernel's bit for bit (``bits_equal_warp``, checked by ``check_bits``)
    unless ``rows_bits_part`` names the first operation at which the two
    may part; those cases are held to the bars alone. Returns {layout:
    case}."""
    from dataclasses import replace

    from kmpc_tpu_torch.ops import mpc_cuda as M

    S = r.shape[1] if r.dim() == 4 else None
    B, H, N = r.shape[0], r.shape[-2], r.shape[-1]
    if layouts is None:
        layouts = [M.kernel_layout(S, H, N)]
    kw = {}
    if warm:
        w0, _, p0 = M.pdhg_log_utility_plain(cw, r, params, return_dual=True)
        params = replace(params, max_iters=max(params.max_iters // 4, 1))
        kw = dict(w_warm=w0.contiguous(), p_warm=p0.contiguous())
    dual = dual or warm or params.adaptive
    steps = params.adaptive
    out_p = M.pdhg_log_utility_plain(cw, r, params, return_dual=dual,
                                     return_steps=steps, **kw)
    plain_ms = cuda_ms(lambda: M.pdhg_log_utility_plain(
        cw, r, params, return_dual=dual, **kw), 1) if time_plain else None
    bound = pdhg_bound(B, H, N, params, S, warm, dual)
    results, outs = {}, {}
    for layout in layouts:
        kernel = pinned_kernel(layout, r, params)
        out_k = pinned(layout, cw, r, params, return_dual=dual,
                       return_steps=steps, **kw)
        res = {"case": label, "layout": layout, "kernel": kernel.name,
               "B": B, "H": H, "N": N, "iters": params.max_iters}
        if layout != "warp":
            again = pinned(layout, cw, r, params, return_dual=dual,
                           return_steps=steps, **kw)
            torch.cuda.synchronize()
            assert all(torch.equal(x, y) for x, y in zip(out_k, again)), \
                f"{label}: two runs of the {layout} kernel differ"
            res["deterministic"] = True
        torch.cuda.synchronize()
        hold_to_plain(label, cw, r, params, kw, out_k, out_p, res, wide)
        res["bound_ms"], res["bound_by"] = bound
        if S is not None:
            res["S"] = S
        res["kernel_ms"] = cuda_ms(lambda: pinned(
            layout, cw, r, params, return_dual=dual, **kw), time_reps)
        if plain_ms is not None:
            res["plain_ms"] = plain_ms
        results[layout], outs[layout] = res, out_k
    if "warp" in outs and "rows" in outs:
        same = [torch.equal(x, y) for x, y in zip(outs["warp"], outs["rows"])]
        results["rows"]["bits_equal_warp"] = all(same)
        if not all(same):
            results["rows"]["bits_equal_outputs"] = same
            results["rows"]["bits_part"] = rows_bits_part(H, N, params, S)
    return results


def check_bits(results):
    """The row cases whose bits part from the warp kernel's with no
    reason from ``rows_bits_part`` must be none, and those with one no
    more than ROWS_BITS_PARTED; returns the tally."""
    rows = [r for r in results if "bits_equal_warp" in r]
    parted = [r for r in rows if not r["bits_equal_warp"]]
    unexcused = [(r["case"], r["bits_equal_outputs"]) for r in parted
                 if not r["bits_part"]]
    assert not unexcused, \
        f"the row kernel's bits differ from the warp kernel's (weights, " \
        f"fp, dual, steps equal) at {unexcused}"
    assert len(parted) <= ROWS_BITS_PARTED, \
        f"the row kernel's bits part from the warp kernel's at " \
        f"{len(parted)} cases, more than the {ROWS_BITS_PARTED} traced: " \
        f"{[r['case'] for r in parted]}"
    return {"cases": len(rows), "equal": len(rows) - len(parted),
            "parted": [r["case"] for r in parted]}


def hold_to_plain(label, cw, r, params, kw, out_k, out_p, res, wide=False):
    """The bars of a log-utility case, on any device: the kernel's outputs
    ``out_k`` against the plain version's ``out_p`` (weights, fixed-point
    residuals, the dual where returned, the steps with
    ``params.adaptive``) on current weights ``cw`` and gross returns ``r``,
    both continued from the warm iterates in ``kw`` if any, through the
    same finalisation. Adaptive cases as ``adaptive_agreement`` says; a
    ``wide`` case (LOG_UNSETTLED_FP) also holds a problem beyond FLIP_OBJ_TOL
    where either side's fixed-point residual exceeds LOG_UNSETTLED_FP as
    ``hold_unsettled`` says, and gives the referee, beside the plain
    version's distances, those of the plain version with its assets
    permuted, each problem's its own. Fills ``res``;
    raises ``AssertionError`` at the first bar missed."""
    from kmpc_tpu_torch.ops import mpc_cuda as M

    S = r.shape[1] if r.dim() == 4 else None
    dual, steps = len(out_k) > 2, params.adaptive
    wk_f, ik = M._finalize_packed(out_k[0], r, cw, params, out_k[1])
    wp_f, ip = M._finalize_packed(out_p[0], r, cw, params, out_p[1])
    dw = (wk_f - wp_f).abs().amax(dim=(1, 2))
    dobj = ik["objective"] - ip["objective"]
    dp = (out_k[2] - out_p[2]).abs().amax(dim=(1, 2)) if dual \
        else torch.zeros_like(dw)
    near = ((out_p[1] - params.feas_tol).abs() <= BAND * params.feas_tol)
    differ = ik["status_code"] != ip["status_code"]
    obj_tol = OBJ_TOL if S is None else SCEN_OBJ_TOL

    def referee():
        """The distances of the kernel and of the plain version to the plain
        version in float64 on the same inputs, per problem: (objective,
        weights, duals) for each, where the plain version's step history is
        the float64 run's, and for a ``wide`` case the distances of the
        plain version run with its assets permuted (0 where its step history
        is not the float64 run's), else None."""
        plain_kw = {k: v.double() for k, v in kw.items()}
        out64 = M.pdhg_log_utility_plain(cw.double(), r.double(), params,
                                         return_dual=True, return_steps=True,
                                         **plain_kw)
        w64, i64 = M._finalize_packed(out64[0], r.double(), cw.double(),
                                      params, out64[1])
        same = out_p[-1][:, -1].double() == out64[-1][:, -1]

        def distances(w, info, dual):
            return ((info["objective"].double() - i64["objective"]).abs(),
                    (w.double() - w64).abs().amax(dim=(1, 2)),
                    (dual.double() - out64[2]).abs().amax(dim=(1, 2)))

        d_perm = None
        if wide:
            # The plain version with its assets permuted (no warm inputs
            # on that path): another float32 summation order.
            perm = torch.randperm(r.shape[-1], generator=torch.Generator()
                                  .manual_seed(0)).to(r.device)
            inv = torch.argsort(perm)
            o = M.pdhg_log_utility_plain(cw[:, perm].contiguous(),
                                         r[..., perm].contiguous(), params,
                                         return_dual=True, return_steps=True)
            wq, iq = M._finalize_packed(o[0][..., inv], r, cw, params, o[1])
            also = o[3][:, -1].double() == out64[-1][:, -1]
            d_perm = tuple(torch.where(also, d, torch.zeros_like(d))
                           for d in distances(wq, iq, o[2][..., inv]))
        return (distances(wk_f, ik, out_k[2]),
                distances(wp_f, ip, out_p[2]), same, d_perm)

    if steps:
        astray = None
        if wide:
            astray = (dobj.abs() > FLIP_OBJ_TOL) & (
                (out_k[1] > LOG_UNSETTLED_FP) | (out_p[1] > LOG_UNSETTLED_FP))
            hold_unsettled(label, cw, r, params, astray, out_k[1], out_p[1],
                           ik["objective"], ip["objective"],
                           LOG_UNSETTLED_FP, res)
        held = adaptive_agreement(label, out_k[3], out_p[3], dw, dp, dobj,
                                  W_TOL, obj_tol, FLIP_OBJ_TOL, res, referee,
                                  astray)
    else:
        held = torch.ones_like(near)
    assert not (held & (dobj.abs() > obj_tol)).any().item(), \
        f"{label}: objectives differ by {dobj[held].abs().max().item()}"
    assert not (differ & ~near & held).any().item(), \
        f"{label}: status codes differ"
    if not steps:
        assert dw.max().item() <= W_TOL, \
            f"{label}: weights differ by {dw.max().item()}"
        assert dp.max().item() <= W_TOL, \
            f"{label}: duals differ by {dp.max().item()}"
    # The simplex sum to FEAS_TOL, or to twice the plain version's own
    # error where that is larger: the adaptive body's steps grow until the
    # projection input carries a common offset whose float32 sum over 500
    # assets is off by ~1e-5 (tests/test_torch_port_large.py::
    # test_adaptive_body_at_500_assets_is_at_float32s_limit).
    res["simplex_error"] = simplex_error(wk_f)
    res["plain_simplex_error"] = simplex_error(wp_f)
    check_feasible(wk_f, cw, params, label,
                   max(FEAS_TOL, 2.0 * res["plain_simplex_error"]))
    res.update({"max_abs_dw": dw.max().item(),
                "max_abs_dobj": dobj.abs().max().item(),
                "status_band_exempt": int((near & differ).sum().item())})
    if dual:
        res["max_abs_ddual"] = dp.max().item()


def adaptive_agreement(label, steps_k, steps_p, dw, dp, dobj, w_tol,
                       obj_tol, flip_obj_tol, res, referee=None, exempt=None):
    """The bars of an adaptive case (see the module docstring). Returns the
    mask of the problems that meet the fixed-step bars (weights, duals,
    objective). ``dw``, ``dp`` and ``dobj`` are per-problem differences,
    kernel minus plain; the steps' last column is the signed sum of the
    iterations that moved them.

    A problem whose step histories are equal must meet the bars, unless
    ``referee`` is given (a log-utility case: ``referee()`` gives the
    kernel's and the float32 plain version's distances to the float64
    plain version per problem, in objective, weights and duals, where the
    float32 and float64 histories are equal, and for a ``wide`` case the
    permuted plain version's distances, see ``hold_to_plain``). Then, where
    the float32 and float64 histories are equal, the kernel may instead lie
    within REFEREE_FACTOR times the float32 noise of the float64 run, plus
    the bar, in each of the three. The noise is the case's: the largest
    distance of the float32 plain version to it over those problems; in a
    ``wide`` case, on a problem where the permuted plain version lies
    farther, that problem's own permuted distance (one problem's distance
    never widens another's). Where the histories differ the float64 run is
    another trajectory, no referee: the problem counts as ended apart, like
    one whose kernel and plain histories parted.

    Every problem that ended apart has its objective within
    ``flip_obj_tol``, and over a large case the objective differences must
    be unbiased, except the problems of ``exempt``, which the caller holds
    otherwise (``hold_unsettled``). How many may end apart: with a referee,
    the kernel may be
    beyond the bars against the float64 run on no more problems than the
    float32 plain version is, plus 3 sqrt(n) + 2; without one, at most
    BEYOND_SHARE of a large case and two of a small one. Fills ``res`` with
    the counts and the differences over all problems and over the held
    ones."""
    B = dw.shape[0]
    parted = steps_k[:, -1] != steps_p[:, -1]
    beyond = (dw > w_tol) | (dp > w_tol)
    apart = beyond | (dobj.abs() > obj_tol)
    held = ~apart
    unexplained = apart & ~parted
    refereed = torch.zeros_like(apart)
    tie64 = torch.zeros_like(apart)
    if referee is not None:
        d_kernel, d_plain, same, d_perm = referee()
        refereed = unexplained & same
        tie64 = unexplained & ~same
        n_kernel = n_plain = torch.zeros_like(apart)
        for i, (what, dk, dpl, tol) in enumerate(zip(
                ("dobj", "dw", "ddual"), d_kernel, d_plain,
                (obj_tol, w_tol, w_tol))):
            noise = dpl[same].max().item() if same.any() else 0.0
            own = torch.full_like(dk, noise)
            if d_perm is not None:
                own = torch.maximum(own, d_perm[i])
                dpl = torch.maximum(dpl, d_perm[i])
            refereed &= dk <= REFEREE_FACTOR * own + tol
            n_kernel = n_kernel | (dk > tol)
            n_plain = n_plain | (dpl > tol)
            res[f"float32_noise_vs_float64_{what}"] = noise
            if unexplained.any():
                res.update({
                    f"max_abs_{what}_kernel_vs_float64":
                        dk[unexplained].max().item(),
                    f"max_abs_{what}_plain_vs_float64":
                        dpl[unexplained].max().item()})
                if d_perm is not None:
                    res[f"max_{what}_noise_of_unexplained"] = \
                        own[unexplained].max().item()
        n_kernel, n_plain = int(n_kernel.sum().item()), int(n_plain.sum().item())
        res.update({"held_by_float64_referee": int(refereed.sum().item()),
                    "float64_parted_at_equal_histories":
                        int(tie64.sum().item()),
                    "kernel_apart_from_float64": n_kernel,
                    "plain_apart_from_float64": n_plain})
    res.update({"decisions_parted": int(parted.sum().item()),
                "ended_apart": int(apart.sum().item()),
                "beyond_weight_bar": int(beyond.sum().item()),
                "max_abs_dw_held": dw[held].max().item() if held.any() else 0.0,
                "max_abs_dobj_held":
                    dobj[held].abs().max().item() if held.any() else 0.0,
                "mean_dobj_all": dobj.mean().item()})
    assert not (unexplained & ~refereed & ~tie64).any().item(), (
        f"{label}: with equal step histories weights differ by "
        f"{dw[~parted].max().item()}, duals by {dp[~parted].max().item()}, "
        f"objectives by {dobj[~parted].abs().max().item()}; to the float64 "
        "plain version: " + ", ".join(
            f"{k} {v}" for k, v in res.items() if "float64" in k))
    kept = dobj if exempt is None else dobj[~exempt]
    assert kept.numel() == 0 or kept.abs().max().item() <= flip_obj_tol, \
        f"{label}: objectives differ by {kept.abs().max().item()}"
    if B >= 100:
        assert abs(kept.mean().item()) <= FLIP_MEAN_OBJ_TOL, \
            f"{label}: objective differences are biased: {kept.mean().item()}"
    if referee is not None:
        assert n_kernel <= n_plain + 3.0 * n_plain ** 0.5 + 2, (
            f"{label}: the kernel is apart from the float64 run on "
            f"{n_kernel} of {B} problems, the float32 plain version on "
            f"{n_plain}")
    elif B >= 100:
        assert apart.float().mean().item() <= BEYOND_SHARE, \
            f"{label}: {res['ended_apart']} of {B} ended apart"
    else:
        assert int(apart.sum().item()) <= 2, \
            f"{label}: {res['ended_apart']} of {B} ended apart"
    return held


def compare_mv_case(label, B, H, N, params, seed, shared=False,
                    scale=0.05, time_reps=3, time_plain=True):
    """The mean-variance kernel and its plain version on the same card
    inputs, through the same finalisation."""
    cw_np, mu_np, sig_np = mv_instance(B, H, N, seed, shared, scale)
    cw = torch.as_tensor(cw_np, device="cuda")
    mu = torch.as_tensor(mu_np, device="cuda")
    sig = torch.as_tensor(sig_np, device="cuda")
    return compare_mv_tensors(label, cw, mu, sig, params, time_reps,
                              time_plain)


def compare_mv_tensors(label, cw, mu, sig, params, time_reps=3,
                       time_plain=True):
    """``compare_mv_case`` on given card tensors: current weights [B, N],
    mu [B, H, N] and a covariance [B, N, N] or [N, N]. A block-layout
    kernel runs twice and must give the same bits."""
    from kmpc_tpu_torch.ops import mv_cuda as V

    B, H, N = mu.shape
    shared = sig.dim() == 2
    sig = (0.5 * (sig + sig.transpose(-1, -2))).contiguous()
    steps = params.adaptive
    layout, kernel = V._mv_route(H, N, params)
    out_k = mv_kernel_twice(label, layout, cw, mu, sig, params)
    out_p = V.pdhg_mean_variance_plain(cw, mu, sig, params,
                                       return_steps=steps)
    torch.cuda.synchronize()
    res = {"case": label, "kernel": kernel.name, "B": B, "H": H, "N": N,
           "iters": params.max_iters, "shared_sigma": shared}
    hold_mv(label, cw, mu, sig, params, out_k, out_p, res)
    res["bound_ms"], res["bound_by"] = mv_bound(B, H, N, params, shared)
    res["kernel_ms"] = cuda_ms(lambda: V.pdhg_mean_variance_cuda(
        cw, mu, sig, params), time_reps)
    if time_plain:
        res["plain_ms"] = cuda_ms(lambda: V.pdhg_mean_variance_plain(
            cw, mu, sig, params), 1)
    return res


def mv_kernel_twice(label, layout, cw, mu, sig, params):
    """The mean-variance kernel's outputs on these card tensors (with the
    steps under ``params.adaptive``); a block-layout kernel runs a second
    time and must give the same bits (its reduces stage sums in shared
    memory: a missing barrier shows as a run-to-run difference)."""
    from kmpc_tpu_torch.ops import mv_cuda as V

    out = V.pdhg_mean_variance_cuda(cw, mu, sig, params,
                                    return_steps=params.adaptive)
    if layout == "block":
        again = V.pdhg_mean_variance_cuda(cw, mu, sig, params,
                                          return_steps=params.adaptive)
        torch.cuda.synchronize()
        assert all(torch.equal(x, y) for x, y in zip(out, again)), \
            f"{label}: two runs of the block kernel differ"
    return out


def hold_mv(label, cw, mu, sig, params, out_k, out_p, res):
    """The bars of a mean-variance case: the kernel's outputs ``out_k``
    against the plain version's ``out_p`` on current weights ``cw``, mu and
    the symmetrised covariance ``sig``, through the same finalisation;
    adaptive cases as ``adaptive_agreement`` says (without a referee), the
    problems that one side left unsettled as ``hold_unsettled_mv`` says.
    Fills ``res`` (``deterministic`` where the kernel is a block-layout
    one, which ``mv_kernel_twice`` has run twice); raises
    ``AssertionError`` at the first bar missed."""
    from kmpc_tpu_torch.ops import mv_cuda as V

    (wk, fpk), (wp, fpp) = out_k[:2], out_p[:2]
    wk_f, ik = V._finalize_mv(wk, fpk, mu, sig, cw, params)
    wp_f, ip = V._finalize_mv(wp, fpp, mu, sig, cw, params)
    dw_all = (wk_f - wp_f).abs().amax(dim=(1, 2))
    dobj_all = ik["objective"] - ip["objective"]
    if "block" in res.get("kernel", ""):
        res["deterministic"] = True
    rest = torch.ones_like(dw_all, dtype=torch.bool)
    held = rest.clone()
    if params.adaptive:
        # Where decisions part, the two runs of this program keep the same
        # objective and differ in the weights along directions in which the
        # covariance is nearly flat: the objective bar holds for every
        # problem, unless one side did not settle on it.
        astray = (dobj_all.abs() > MV_OBJ_TOL) & (
            (fpk > MV_UNSETTLED_FP) | (fpp > MV_UNSETTLED_FP))
        rest = ~astray
        held = torch.zeros_like(rest)
        held[rest] = adaptive_agreement(
            label, out_k[2][rest], out_p[2][rest], dw_all[rest],
            torch.zeros_like(dw_all[rest]), dobj_all[rest], MV_W_TOL,
            MV_OBJ_TOL, MV_OBJ_TOL, res)
        hold_unsettled_mv(label, cw, mu, sig, params, astray, fpk, fpp,
                          ik["objective"], ip["objective"], res)
    dw = dw_all[held].max().item() if held.any() else 0.0
    dobj = dobj_all[rest].abs().max().item() if rest.any() else 0.0
    res.update({"max_abs_dw": dw_all.max().item(),
                "max_abs_dobj": dobj_all.abs().max().item(),
                "max_fp": fpk.max().item()})
    assert dw <= MV_W_TOL, f"{label}: weights differ by {dw}"
    assert dobj <= MV_OBJ_TOL, f"{label}: objectives differ by {dobj}"
    assert bool(ik["converged"].all()), f"{label}: not converged"
    w64 = wk_f.double()
    assert torch.all((w64.sum(-1) - 1.0).abs() <= FEAS_TOL), label
    assert torch.all(w64 >= 0), label


def hold_unsettled(label, cw, r, params, astray, fpk, fpp, obj_k, obj_p,
                   unsettled_fp, res):
    """``hold_unsettled_mv`` for the log-utility program (no warm inputs):
    each problem of ``astray`` against the plain version run in float64 on
    it. A side that settled there (fixed-point residual at most
    ``unsettled_fp``) must lie within OBJ_TOL (scenarios: SCEN_OBJ_TOL) of
    the float64 run; an unsettled kernel may not lie above it (maximisation
    form), and the kernel may be unsettled on no more of them than the plain
    version is, plus 3 sqrt(n) + 2."""
    from kmpc_tpu_torch.ops import mpc_cuda as M

    idx = torch.nonzero(astray).flatten()
    res["unsettled_apart"] = int(idx.numel())
    if idx.numel() == 0:
        return
    tol = OBJ_TOL if r.dim() == 3 else SCEN_OBJ_TOL
    cw64, r64 = cw[idx].double(), r[idx].double()
    out64 = M.pdhg_log_utility_plain(cw64, r64, params)
    obj64 = M._finalize_packed(out64[0], r64, cw64, params,
                               out64[1])[1]["objective"]
    ok, uk = obj_k[idx].double() - obj64, fpk[idx] > unsettled_fp
    op, up = obj_p[idx].double() - obj64, fpp[idx] > unsettled_fp
    n_k, n_p = int(uk.sum().item()), int(up.sum().item())
    res.update({"kernel_unsettled_apart": n_k, "plain_unsettled_apart": n_p,
                "unsettled": [
                    {"fp_kernel": fpk[i].item(), "fp_plain": fpp[i].item(),
                     "fp_float64": out64[1][j].item(),
                     "dobj_kernel_vs_float64": ok[j].item(),
                     "dobj_plain_vs_float64": op[j].item()}
                    for j, i in enumerate(idx.tolist()[:8])]})
    assert not (~uk & (ok.abs() > tol)).any().item(), (
        f"{label}: the kernel settled where the plain version did not, "
        f"{ok[~uk].abs().max().item()} from the float64 run in objective")
    assert not (~up & (op.abs() > tol)).any().item(), (
        f"{label}: the plain version settled, "
        f"{op[~up].abs().max().item()} from the float64 run in objective")
    assert not (ok > tol).any().item(), (
        f"{label}: the unsettled kernel lies {ok.max().item()} above the "
        "float64 run in objective")
    assert n_k <= n_p + 3.0 * n_p ** 0.5 + 2, (
        f"{label}: the kernel is unsettled on {n_k} of the problems ended "
        f"apart, the float32 plain version on {n_p}")


def hold_unsettled_mv(label, cw, mu, sig, params, astray, fpk, fpp, obj_k,
                      obj_p, res):
    """The bars of the adaptive mean-variance problems whose objectives
    differ beyond the bar where the kernel's or the plain version's
    fixed-point residual (``fpk``, ``fpp``) exceeds MV_UNSETTLED_FP (the
    mask ``astray``): each is held against the plain version run in float64
    on that problem. A side that
    settled there must lie within the objective bar of the float64 run; an
    unsettled kernel, a feasible point, may not lie above it (the objective
    is in maximisation form), and the kernel may be unsettled on no more of
    them than the plain version is, plus 3 sqrt(n) + 2. Fills ``res`` with
    the counts and, for the first eight such problems, the three residuals
    and both distances to the float64 run."""
    from kmpc_tpu_torch.ops import mv_cuda as V

    idx = torch.nonzero(astray).flatten()
    res["unsettled_apart"] = int(idx.numel())
    if idx.numel() == 0:
        return
    sig_i = sig.double() if sig.dim() == 2 else sig[idx].double()
    w64, fp64 = V.pdhg_mean_variance_plain(cw[idx].double(), mu[idx].double(),
                                           sig_i, params)
    obj64 = V._finalize_mv(w64, fp64, mu[idx].double(), sig_i,
                           cw[idx].double(), params)[1]["objective"]
    ok, uk = obj_k[idx].double() - obj64, fpk[idx] > MV_UNSETTLED_FP
    op, up = obj_p[idx].double() - obj64, fpp[idx] > MV_UNSETTLED_FP
    n_k, n_p = int(uk.sum().item()), int(up.sum().item())
    res.update({"kernel_unsettled_apart": n_k, "plain_unsettled_apart": n_p,
                "unsettled": [
                    {"fp_kernel": fpk[i].item(), "fp_plain": fpp[i].item(),
                     "fp_float64": fp64[j].item(),
                     "dobj_kernel_vs_float64": ok[j].item(),
                     "dobj_plain_vs_float64": op[j].item()}
                    for j, i in enumerate(idx.tolist()[:8])]})
    assert not (~uk & (ok.abs() > MV_OBJ_TOL)).any().item(), (
        f"{label}: the kernel settled where the plain version did not, "
        f"{ok[~uk].abs().max().item()} from the float64 run in objective")
    assert not (~up & (op.abs() > MV_OBJ_TOL)).any().item(), (
        f"{label}: the plain version settled, "
        f"{op[~up].abs().max().item()} from the float64 run in objective")
    assert not (ok > MV_OBJ_TOL).any().item(), (
        f"{label}: the unsettled kernel lies {ok.max().item()} above the "
        "float64 run in objective")
    assert n_k <= n_p + 3.0 * n_p ** 0.5 + 2, (
        f"{label}: the kernel is unsettled on {n_k} of the problems ended "
        f"apart, the float32 plain version on {n_p}")


def _ptxas_report(name):
    """{instantiation: registers}, {instantiation: spill bytes} from the
    build log of ``name``; an instantiation is named by its template
    arguments (HM_K[_SCEN]_ADAPT, or K_VARIANT_UNROLL_CHAINS for the
    ladder)."""
    from kmpc_tpu_torch._build import build_log

    regs, spills = {}, {}
    inst = None
    for line in build_log(name).splitlines():
        m = re.search(r"kernelI((?:L[ib]\d+E)+)", line)
        if "Compiling entry function" in line and m:
            inst = "_".join(re.findall(r"L[ib](\d+)E", m.group(1)))
        elif inst and "spill stores" in line:
            spills[inst] = int(re.search(r"(\d+) bytes spill stores", line).group(1))
        elif inst and "registers" in line:
            regs[inst] = int(re.search(r"Used (\d+) registers", line).group(1))
    return regs, spills


def phase_build():
    from kmpc_tpu_torch._build import SOURCES, build_all

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit("device", smi=smi_line(), torch=torch.__version__,
         cuda=torch.version.cuda, python=sys.version.split()[0],
         device=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count())
    secs = build_all()
    for name in SOURCES:
        regs, spills = _ptxas_report(name)
        assert regs, f"{name}: no ptxas report in the build log"
        if name == "mv_ladder":     # its 72 rungs: the extremes only
            regs = {"instantiations": len(regs), "max": max(regs.values())}
        emit("build", kernel=name, seconds=secs[name], registers=regs,
             spill_store_bytes={k: v for k, v in spills.items() if v})
    check_mv_block_plan()
    check_rows_plan()


def check_rows_plan():
    """The wrapper's copy of the row layout's shared-memory plan
    (``rows_smem_bytes``, which decides whether the row layout takes a
    shape) against the plan the built kernel launches with, over the edges
    of its envelope: 1 to 32 rows, 1 to 4 slots, scenarios in registers
    and past them."""
    import ctypes

    from kmpc_tpu_torch._build import library_path
    from kmpc_tpu_torch.ops import mpc_cuda as M

    plan = ctypes.CDLL(str(library_path("pdhg_log_utility_rows")))
    plan = plan.kmpc_rows_smem_bytes
    plan.argtypes, plan.restype = [ctypes.c_int] * 4, ctypes.c_longlong
    shapes = [(S, H, N, a) for S in (None, 1, 4, 5, 16, 17, 64, 113)
              for H in (1, 5, 8, 9, 20, 21, 32) for N in (1, 20, 33, 70, 128)
              for a in (False, True)]
    wrong = [(S, H, N, a, M.rows_smem_bytes(S, H, N, a), plan(S or 0, H, N, a))
             for S, H, N, a in shapes
             if M.rows_smem_bytes(S, H, N, a) != plan(S or 0, H, N, a)]
    assert not wrong, \
        f"the wrapper's row plan differs from the kernel's: {wrong[:5]}"
    emit("rows_plan", shapes=len(shapes), agree=True)


def check_mv_block_plan():
    """The wrapper's copy of the block layout's shared-memory plan
    (``mv_block_smem_bytes``, which routes a shape to the block layout or
    refuses it) against the plan the built kernel launches with, as its
    library reports it, over the envelope's edges and the staging
    boundary."""
    import ctypes

    from kmpc_tpu_torch._build import library_path
    from kmpc_tpu_torch.ops import mv_cuda as V

    plan = ctypes.CDLL(str(library_path("pdhg_mean_variance_block")))
    plan = plan.kmpc_mv_block_smem_bytes
    plan.argtypes, plan.restype = [ctypes.c_int] * 2, ctypes.c_longlong
    shapes = [(H, N) for H in (1, 2, 5, 16, 17, 20, 340)
              for N in (8, 30, 64, 65, 120, 128, 129, 220, 238, 239, 320,
                        480, 960, 1112)]
    wrong = [(H, N, V.mv_block_smem_bytes(H, N), plan(H, N))
             for H, N in shapes if V.mv_block_smem_bytes(H, N) != plan(H, N)]
    assert not wrong, \
        f"the wrapper's block plan differs from the kernel's: {wrong}"
    emit("mv_block_plan", shapes=len(shapes), agree=True)


def _params(**kw):
    from kmpc_tpu_torch.ops.mpc import MPCParams

    return MPCParams(sigma_scale=2.0, **kw)


def phase_kernel_vs_plain():
    """Every kernel against its plain version; returns the cases by
    kernel name."""
    from kmpc_tpu_torch.ops import mpc_cuda as M
    from kmpc_tpu_torch.ops.mpc import MPCParams

    cases = []
    seed = 0
    quick = dict(time_plain=False)
    for H, N in ((1, 12), (1, 33), (5, 12), (5, 20), (5, 30), (5, 33)):
        for refresh in (0, 16):
            for precond in (False, True):
                seed += 1
                p = _params(max_iters=400, proj_refresh_every=refresh,
                            precond=precond)
                cases.append((f"H{H}N{N}r{refresh}p{int(precond)}",
                              7, H, N, p, seed, {}))
    # The edges of the register budget: pow2ceil(H) * ceil(N/32) = 16 with
    # one, two and four slots per lane, and three slots.
    for label, H, N, refresh, precond in (
            ("H12N20r0p0", 12, 20, 0, False), ("H16N32r16p1", 16, 32, 16, True),
            ("H8N64r16p1", 8, 64, 16, True), ("H3N90r0p0", 3, 90, 0, False),
            ("H4N128r16p1", 4, 128, 16, True)):
        seed += 1
        cases.append((label, 7, H, N, _params(
            max_iters=400, proj_refresh_every=refresh, precond=precond),
            seed, {}))
    cases += [
        ("no_ball", 8, 5, 20, _params(max_iters=400, max_turnover=0.0), 101, {}),
        ("over_relax", 8, 5, 30, _params(max_iters=400, over_relax=1.5), 102, {}),
        ("over_relax_cond", 7, 5, 30, _params(
            max_iters=400, over_relax=1.5, proj_refresh_every=16), 107, {}),
        ("cold", 8, 5, 33, _params(max_iters=400, proj_warm_iters=0), 103, {}),
        ("ridge_precond", 8, 5, 20, _params(
            max_iters=400, ridge=1e-3, precond=True, feas_tol=3e-4), 104, {}),
        ("main_path", 1028, 5, 20, _params(max_iters=2000), 105, {}),
        ("bench_backtest", 4096, 5, 30, _params(
            max_iters=500, proj_refresh_every=16, precond=True), 106, {}),
    ]
    # Warm inputs and the dual output of the same kernel.
    warm = dict(warm=True, time_plain=False)
    cases += [
        ("dual_H5N20", 6, 5, 20, _params(max_iters=400), 201,
         dict(dual=True, time_plain=False)),
        ("warm_H5N20", 6, 5, 20, _params(max_iters=400), 202, warm),
        ("warm_H5N30_cond_precond", 9, 5, 30, _params(
            max_iters=400, proj_refresh_every=16, precond=True), 203, warm),
        ("warm_H1N12", 8, 1, 12, _params(max_iters=400), 204, warm),
        ("warm_H5N33_over_relax", 7, 5, 33, _params(
            max_iters=400, over_relax=1.5), 205, warm),
        ("warm_H5N20_cold_proj", 6, 5, 20, _params(
            max_iters=400, proj_warm_iters=0), 206, warm),
        ("warm_no_ball", 6, 5, 20, _params(
            max_iters=400, max_turnover=0.0), 207, warm),
        ("warm_main_path", 1028, 5, 20, _params(max_iters=2000), 208,
         dict(warm=True)),
    ]
    # The adaptive body, in the kernel of its own.
    acc = dict(adaptive=True, adapt_every=2, precond=True)
    for H, N in ((1, 12), (5, 20), (5, 30), (5, 33)):
        for k in (1, 2):
            for precond in (False, True):
                seed += 1
                cases.append((f"adaptive_H{H}N{N}k{k}p{int(precond)}", 7, H, N,
                              _params(max_iters=400, adaptive=True,
                                      adapt_every=k, precond=precond),
                              seed, quick))
    for label, H, N in (("H12N20", 12, 20), ("H16N32", 16, 32),
                        ("H8N64", 8, 64), ("H3N90", 3, 90),
                        ("H4N128", 4, 128)):
        seed += 1
        cases.append((f"adaptive_{label}", 7, H, N,
                      _params(max_iters=400, **acc), seed, quick))
    cases += [
        ("adaptive_ridge", 8, 5, 20, _params(
            max_iters=400, ridge=1e-3, feas_tol=3e-4, **acc), 501, quick),
        ("adaptive_over_relax", 8, 5, 30, _params(
            max_iters=400, over_relax=1.5, **acc), 502, quick),
        ("adaptive_no_ball", 8, 5, 20, _params(
            max_iters=400, max_turnover=0.0, **acc), 503, quick),
        ("adaptive_cold", 8, 5, 33, _params(
            max_iters=400, proj_warm_iters=0, **acc), 504, quick),
        ("adaptive_warm_dual", 6, 5, 20, _params(max_iters=400, **acc), 505,
         warm),
        ("adaptive_odd_iters", 7, 5, 20, _params(max_iters=801, **acc), 506,
         quick),
        ("adaptive_path_shape", 1028, 5, 20, _params(max_iters=800, **acc),
         507, {}),
        # The scan's shape: one problem a launch.
        ("adaptive_scan_shape", 1, 5, 20, _params(max_iters=800, **acc),
         508, quick),
    ]
    # The pipelined body (make_trip_pipe) in both layouts, at H=5 (the warp
    # layout) and H=17 (past its registers: the block layout): refresh 8
    # and 16, an odd iteration count, ball on and off, precond, warm inputs
    # and the dual output; kernel B's too. A case whose label names the
    # block layout must route there, every other to the warp layout.
    pipe = dict(pipeline_reduces=True)
    for H, tag in ((5, ""), (17, "_block")):
        cases += [
            (f"pipe_r16{tag}", 7, H, 20, _params(
                max_iters=400, proj_refresh_every=16, **pipe), 801, quick),
            (f"pipe_r8_odd_precond{tag}", 7, H, 30, _params(
                max_iters=401, proj_refresh_every=8, precond=True, **pipe),
             802, quick),
            (f"pipe_no_ball{tag}", 7, H, 20, _params(
                max_iters=400, proj_refresh_every=16, max_turnover=0.0,
                **pipe), 803, quick),
            (f"pipe_warm_dual{tag}", 6, H, 20, _params(
                max_iters=400, proj_refresh_every=16, precond=True, **pipe),
             804, warm),
            (f"pipe_dual_ridge{tag}", 6, H, 33, _params(
                max_iters=400, proj_refresh_every=16, ridge=1e-3,
                feas_tol=3e-4, **pipe), 805,
             dict(dual=True, time_plain=False)),
        ]
    cases.append(("pipe_H5N30_bench", 4096, 5, 30, _params(
        max_iters=1000, proj_refresh_every=16, precond=True, **pipe), 806,
        {}))
    # The block layout: its fixed-step bodies (cold projections, ridge,
    # over-relaxation, no ball, warm inputs) at H=17, and the shapes past
    # the warp layout: H=20 N=30, H=5 N=500, H=3 N=150, the edges N=129 and
    # H=17, and one asset column per thread beyond 512 assets; the adaptive
    # body at those shapes.
    cases += [
        ("block_body", 7, 17, 20, _params(max_iters=400), 811, quick),
        ("block_cold", 6, 17, 33, _params(max_iters=300, proj_warm_iters=0),
         812, quick),
        ("block_ridge_precond", 6, 17, 20, _params(
            max_iters=400, ridge=1e-3, precond=True, feas_tol=3e-4), 813,
         quick),
        ("block_over_relax_no_ball", 6, 17, 20, _params(
            max_iters=400, over_relax=1.5, max_turnover=0.0), 814, quick),
        ("block_warm_dual", 6, 17, 20, _params(
            max_iters=400, proj_refresh_every=16), 815, warm),
    ]
    for label, H, N in (("H20N30", 20, 30), ("H5N500", 5, 500),
                        ("H3N150", 3, 150), ("H5N129", 5, 129),
                        ("H17N20", 17, 20), ("H1N600", 1, 600)):
        seed += 1
        cases.append((f"block_{label}_cond", 4, H, N, _params(
            max_iters=400, proj_refresh_every=16, precond=True), seed, quick))
        seed += 1
        cases.append((f"block_{label}_pipe", 4, H, N, _params(
            max_iters=401, proj_refresh_every=16, **pipe), seed, quick))
        seed += 1
        cases.append((f"adaptive_block_{label}", 4, H, N, _params(
            max_iters=400, **acc), seed, quick))
    cases += [
        ("adaptive_block_warm_dual", 6, 20, 20, _params(
            max_iters=400, **acc), 821, warm),
        ("adaptive_block_k1_cold_no_ball", 6, 20, 20, _params(
            max_iters=300, adaptive=True, proj_warm_iters=0,
            max_turnover=0.0), 822, quick),
        ("adaptive_block_odd_over_relax", 6, 17, 20, _params(
            max_iters=401, over_relax=1.5, **acc), 823, quick),
    ]
    # The row layout (one warp per horizon row) at H in {1, 5, 8, 17, 20,
    # 32} and one to four slots (N in {20, 33, 70, 128}), each body, warm
    # inputs with the dual output; where the warp layout also takes the
    # shape it runs beside, for the bits.
    for H, N in ((1, 128), (5, 70), (8, 33), (17, 20), (20, 70), (32, 128),
                 (32, 20), (20, 33)):
        seed += 1
        cases.append((f"rows_H{H}N{N}_cond", 4, H, N, _params(
            max_iters=200, proj_refresh_every=16, precond=True), seed, quick))
        seed += 1
        cases.append((f"rows_H{H}N{N}_pipe", 4, H, N, _params(
            max_iters=201, proj_refresh_every=16, **pipe), seed, quick))
        seed += 1
        cases.append((f"rows_H{H}N{N}_adaptive", 4, H, N, _params(
            max_iters=200, **acc), seed, quick))
    cases += [
        ("rows_warm_dual_H20N33", 5, 20, 33, _params(
            max_iters=300, proj_refresh_every=16, precond=True), 841, warm),
        ("rows_adaptive_warm_dual_H8N70", 5, 8, 70, _params(
            max_iters=300, **acc), 842, warm),
    ]
    out = {name: [] for name in kernel_counters()}

    def record(res, kernel=None):
        kernel = kernel or res["kernel"]
        emit("kernel_vs_plain", **dict(res, kernel=kernel))
        out[kernel].append(res)

    def routed(res):
        assert ("block" in res["case"]) == ("block" in res["kernel"]), \
            f"{res['case']} ran {res['kernel']}"
        return res

    def layouts_of(label, S, H, N):
        """The layout a case's label names (block, rows, else warp), and
        beside it the row layout (the warp layout beside a rows case)
        wherever that takes the shape."""
        main = ("block" if "block" in label
                else "rows" if label.startswith("rows_") else "warp")
        extra = "warp" if main == "rows" else "rows"
        return [main] + ([extra] if M.layout_supports(extra, S, H, N)
                         else [])

    def run(label, B, H, N, p, s, S=None, **kw):
        for layout, res in compare_case(
                label, B, H, N, p, s, S=S,
                layouts=layouts_of(label, S, H, N), **kw).items():
            k = res["kernel"]
            assert ("block" in k) == (layout == "block") \
                and ("rows" in k) == (layout == "rows"), (label, layout, k)
            record(res)

    for label, B, H, N, p, s, kw in cases:
        run(label, B, H, N, p, s, **kw)

    # The scenario kernel.
    scen_cases = [
        ("S4_H5N30", 6, 4, 5, 30, _params(max_iters=400), 301, quick),
        ("S4_H5N30_cond_precond", 6, 4, 5, 30, _params(
            max_iters=400, proj_refresh_every=16, precond=True), 302, quick),
        ("S4_H5N20_precond", 6, 4, 5, 20, _params(
            max_iters=400, precond=True), 303, quick),
        ("S3_H1N12", 7, 3, 1, 12, _params(max_iters=400), 304, quick),
        ("S4_H5N33_ridge", 5, 4, 5, 33, _params(
            max_iters=400, ridge=1e-3, feas_tol=3e-4), 305, quick),
        ("S4_no_ball", 6, 4, 5, 20, _params(
            max_iters=400, max_turnover=0.0), 306, quick),
        ("S4_over_relax", 6, 4, 5, 30, _params(
            max_iters=400, over_relax=1.5), 307, quick),
        ("S4_cold_proj", 6, 4, 5, 12, _params(
            max_iters=400, proj_warm_iters=0), 308, quick),
        ("S4_dual", 6, 4, 5, 30, _params(max_iters=400), 309,
         dict(dual=True, time_plain=False)),
        ("S4_warm", 6, 4, 5, 30, _params(max_iters=400), 310,
         dict(warm=True, time_plain=False)),
        ("S4_warm_cond_precond", 6, 4, 5, 30, _params(
            max_iters=400, proj_refresh_every=16, precond=True), 311,
         dict(warm=True, time_plain=False)),
        ("S32_H5N30", 5, 32, 5, 30, _params(max_iters=200), 312, quick),
        ("S16_H4N128", 4, 16, 4, 128, _params(max_iters=100), 313, quick),
        # 128 KB of returns per problem: one warp per block.
        ("S64_H8N64", 3, 64, 8, 64, _params(max_iters=50), 317, quick),
        ("comparison_path", 1028, 16, 5, 20, _params(max_iters=2000), 314,
         {}),
        ("warm_comparison_path", 1028, 16, 5, 20, _params(max_iters=2000),
         315, dict(warm=True)),
        ("bench_scenario", 4096, 16, 5, 30, _params(
            max_iters=1000, proj_refresh_every=16), 316, {}),
        ("adaptive_S16_H5N20", 7, 16, 5, 20, _params(max_iters=400, **acc),
         601, quick),
        ("adaptive_S16_H5N30_k1", 7, 16, 5, 30, _params(
            max_iters=400, adaptive=True), 602, quick),
        ("adaptive_S4_warm", 6, 4, 5, 30, _params(max_iters=400, **acc), 603,
         dict(warm=True, time_plain=False)),
        ("adaptive_S64_H8N64", 3, 64, 8, 64, _params(max_iters=50, **acc),
         604, quick),
        ("adaptive_path_shape", 1028, 16, 5, 20, _params(
            max_iters=800, **acc), 605, {}),
        ("adaptive_scan_shape", 1, 16, 5, 20, _params(
            max_iters=800, **acc), 606, quick),
        # The pipelined body in both layouts (H=5 and H=17), and the block
        # layout at S=16, H=20, N=20 (the long path's shape) and past the
        # warp layout's shared memory (S=120 at H=8, N=33: a warp's slice
        # pads the assets to 64).
        ("pipe_S4_r16", 6, 4, 5, 30, _params(
            max_iters=400, proj_refresh_every=16, **pipe), 901, quick),
        ("pipe_S4_r8_odd_no_ball", 6, 4, 5, 20, _params(
            max_iters=401, proj_refresh_every=8, max_turnover=0.0, **pipe),
         902, quick),
        ("pipe_S4_warm", 6, 4, 5, 30, _params(
            max_iters=400, proj_refresh_every=16, precond=True, **pipe), 903,
         dict(warm=True, time_plain=False)),
        ("pipe_S4_r16_block", 6, 4, 17, 30, _params(
            max_iters=400, proj_refresh_every=16, **pipe), 904, quick),
        ("pipe_S4_warm_block", 6, 4, 17, 30, _params(
            max_iters=400, proj_refresh_every=16, precond=True, **pipe), 905,
         warm),
        ("block_S4_body", 6, 4, 17, 20, _params(max_iters=400), 906, quick),
        ("block_S16_H20N20_pipe", 4, 16, 20, 20, _params(
            max_iters=401, proj_refresh_every=16, precond=True, **pipe), 907,
         quick),
        ("block_S16_H20N20_cond", 4, 16, 20, 20, _params(
            max_iters=400, proj_refresh_every=16), 908, quick),
        ("block_S120_H8N33", 2, 120, 8, 33, _params(max_iters=100), 909,
         quick),
        ("adaptive_block_S16_H20N20", 4, 16, 20, 20, _params(
            max_iters=400, **acc), 910, quick),
        ("adaptive_block_S4_warm", 6, 4, 17, 30, _params(
            max_iters=400, **acc), 911, warm),
        # The row layout's scenario returns past its registers (S * K > 16:
        # the CTA's shared memory), and 32 rows of 16 scenarios in registers
        # under the 64-register bound.
        ("rows_S17_H5N20", 4, 17, 5, 20, _params(max_iters=300), 921, quick),
        ("rows_S17_H5N20_adaptive", 4, 17, 5, 20, _params(
            max_iters=300, **acc), 922, quick),
        ("rows_S8_H8N128_pipe", 3, 8, 8, 128, _params(
            max_iters=201, proj_refresh_every=16, **pipe), 923, quick),
        ("rows_S16_H32N20_adaptive", 3, 16, 32, 20, _params(
            max_iters=200, **acc), 924, quick),
    ]
    for label, B, S, H, N, p, s, kw in scen_cases:
        run(label, B, H, N, p, s, S=S, **kw)
    emit("rows_vs_warp_bits", **check_bits(
        [r for rows in out.values() for r in rows]))

    # The mean-variance kernel (sigma_scale 1 on the comparison path, as
    # the experiment builds the Markowitz settings).
    mv_cases = [
        ("H4N10", 6, 4, 10, _params(max_iters=1200, gamma=5.0), 401, quick),
        ("H1N10_refresh", 6, 1, 10, _params(
            max_iters=1200, gamma=5.0, proj_refresh_every=16), 402, quick),
        ("H3N12_shared", 5, 3, 12, _params(max_iters=1200, gamma=5.0), 403,
         dict(shared=True, time_plain=False)),
        ("H1N33", 6, 1, 33, _params(max_iters=800, gamma=5.0), 404, quick),
        ("H2N64_shared", 5, 2, 64, _params(max_iters=600, gamma=5.0), 405,
         dict(shared=True, time_plain=False)),
        ("H4N128", 4, 4, 128, _params(max_iters=300, gamma=5.0), 406, quick),
        ("H4N10_over_relax", 6, 4, 10, _params(
            max_iters=800, gamma=5.0, over_relax=1.5), 407, quick),
        ("H4N10_cold_proj", 6, 4, 10, _params(
            max_iters=800, gamma=5.0, proj_warm_iters=0), 408, quick),
        ("H16N20", 4, 16, 20, _params(max_iters=400, gamma=5.0), 409, quick),
        ("comparison_path", 1028, 1, 20, MPCParams(
            max_iters=2000, gamma=1.0, horizon=1), 410, dict(scale=0.01)),
        ("comparison_path_shared", 1028, 1, 20, MPCParams(
            max_iters=2000, gamma=1.0, horizon=1), 411,
         dict(shared=True, scale=0.01)),
        ("bench_markowitz", 4096, 1, 30, _params(
            max_iters=1000, gamma=5.0, proj_refresh_every=16), 412,
         dict(scale=0.01)),
    ]
    seed = 700
    for H, N in ((1, 20), (4, 10)):
        for shared in (False, True):
            for k in (1, 2):
                seed += 1
                mv_cases.append((
                    f"adaptive_H{H}N{N}k{k}{'_shared' if shared else ''}", 6,
                    H, N, _params(max_iters=1200, gamma=5.0, adaptive=True,
                                  adapt_every=k), seed,
                    dict(shared=shared, time_plain=False)))
    mv_cases += [
        ("adaptive_H4N128", 4, 4, 128, _params(
            max_iters=300, gamma=5.0, adaptive=True, adapt_every=2), 721,
         quick),
        ("adaptive_H16N20_over_relax", 4, 16, 20, _params(
            max_iters=401, gamma=5.0, adaptive=True, adapt_every=2,
            over_relax=1.5), 722, quick),
        ("adaptive_path_shape", 1028, 1, 20, MPCParams(
            max_iters=800, gamma=1.0, horizon=1, adaptive=True,
            adapt_every=2, precond=True), 723, dict(scale=0.01)),
        ("adaptive_scan_shape", 1, 1, 20, MPCParams(
            max_iters=800, gamma=1.0, horizon=1, adaptive=True,
            adapt_every=2, precond=True), 724,
         dict(scale=0.01, time_plain=False)),
    ]
    # C.2: the block layout at the edges of kmpc_tpu's envelope (a
    # per-problem covariance past the warp layout's registers at H=17 and
    # H=340, N=65 and N=112 at H=5, N=88 at H=16; a shared one at N=129
    # and N=1112 at H=1, N=480 at H=5, N=128 at H=20; Sigma staged in
    # shared memory or read from global memory, by size), its adaptive
    # body, over-relaxation and cold projections; bench.py's covariance
    # scale.
    wide = dict(scale=0.01, time_plain=False)
    seed = 730
    for label, B, H, N, shared, kw in (
            ("block_H17N8", 5, 17, 8, False, {}),
            ("block_H340N8", 3, 340, 8, False, dict(max_iters=300)),
            ("block_H5N65_refresh", 5, 5, 65, False, dict(
                proj_refresh_every=16)),
            ("block_H5N112", 4, 5, 112, False, {}),
            ("block_H16N88_refresh", 4, 16, 88, False, dict(
                proj_refresh_every=16)),
            ("block_H1N129_shared", 5, 1, 129, True, {}),
            ("block_H1N1112_shared", 4, 1, 1112, True, {}),
            ("block_H5N480_shared_refresh", 4, 5, 480, True, dict(
                proj_refresh_every=16)),
            ("block_H20N128_shared", 4, 20, 128, True, {}),
            ("adaptive_block_H1N976_shared", 4, 1, 976, True, dict(
                adaptive=True, adapt_every=2)),
            ("adaptive_block_H20N64", 4, 20, 64, False, dict(
                adaptive=True, adapt_every=2)),
            ("block_H17N20_over_relax", 5, 17, 20, False, dict(
                over_relax=1.5)),
            ("adaptive_block_H17N20_over_relax", 5, 17, 20, False, dict(
                adaptive=True, adapt_every=2, over_relax=1.5)),
            ("block_H17N20_cold_proj", 5, 17, 20, False, dict(
                proj_warm_iters=0)),
    ):
        seed += 1
        mv_cases.append((label, B, H, N, _params(
            **{"max_iters": 600, "gamma": 5.0, **kw}), seed,
            dict(wide, shared=shared)))
    for label, B, H, N, p, s, kw in mv_cases:
        record(routed(compare_mv_case(label, B, H, N, p, s, **kw)))

    # The MV ladder: every variant, chains and unroll, on a batch that is no
    # multiple of the chains; two and four slots per lane.
    from kmpc_tpu_torch.ops import mv_ladder as D

    rungs = [(v, u, c, 4, 61, 30, 203) for v in D.VARIANTS
             for c in D.CHAINS for u in D.UNROLLS]
    rungs += [("proj", 4, 4, 1, 9, 33, 100), ("proj", 1, 2, 2, 7, 100, 60),
              ("sigma", 4, 1, 8, 70, 64, 60)]
    for variant, unroll, chains, warps, B, N, iters in rungs:
        cw, mu, sig = (torch.as_tensor(x, device="cuda").contiguous()
                       for x in D.ladder_inputs(B, N))
        wk = D.mv_ladder_cuda(cw, mu, sig, variant, iters, unroll, chains,
                              warps)
        wp = D.mv_ladder_plain(cw, mu, sig, variant, iters, unroll)
        torch.cuda.synchronize()
        dw = (wk - wp).abs().max().item()
        label = f"{variant}_u{unroll}c{chains}w{warps}_B{B}N{N}"
        assert dw <= MV_W_TOL, f"mv_ladder {label}: weights differ by {dw}"
        assert torch.isfinite(wk).all(), label
        res = {"case": label, "B": B, "N": N, "iters": iters,
               "max_abs_dw": dw}
        emit("kernel_vs_plain", kernel="mv_ladder", **res)
        out["mv_ladder"].append(res)
    return out


def alternating_ms(kernels, run):
    """{layout: [ms, ms]}: ``run(kernel)`` for each of ``kernels`` timed in
    two rounds of 3 (``cuda_ms``), the layouts alternating."""
    times = {name: [] for name in kernels}
    for _ in range(2):
        for name, kernel in kernels.items():
            times[name].append(cuda_ms(lambda: run(kernel), 3))
    return times


# The shapes ``layouts`` times every layout at: (S, B, H, N, seed). The
# exact scan (B=1) and the comparison path (B=1028) at H=5, N=20; the
# headline batch (B=65536, N=30); one horizon row; the long path (B=1013,
# H=20) and bench.py's ``long`` shape (B=16384, H=20, N=30).
LAYOUT_SHAPES = (
    (None, 1, 5, 20, 508), (16, 1, 5, 20, 606),
    (None, 1028, 5, 20, 105), (16, 1028, 5, 20, 314),
    (None, 65536, 5, 30, 0), (None, 1028, 1, 20, 7),
    (None, 1013, 20, 20, 9), (16, 1013, 20, 20, 10),
    (None, 16384, 20, 30, 0),
)


def layout_bodies(B):
    """The bodies ``layouts`` times: the paths' (2000 iterations fixed and
    pipelined at refresh 16 with precond, 800 adaptive), or bench.py's
    settings at B >= 16384 (1000 iterations at refresh 16 with precond,
    1000 pipelined, 800 adaptive)."""
    its = 1000 if B >= 16384 else 2000
    return {
        "fixed": (_params(max_iters=its) if its == 2000 else _params(
            max_iters=its, proj_refresh_every=16, precond=True)),
        "pipe": _params(max_iters=its, proj_refresh_every=16, precond=True,
                        pipeline_reduces=True),
        "adaptive": _params(max_iters=800, adaptive=True, adapt_every=2,
                            precond=True),
    }


def phase_layouts():
    """Every layout of kernels A and B that takes the shape, at each of
    LAYOUT_SHAPES and body, launched in it (``pinned``), each
    timed in two rounds of 3, the layouts alternating. The layouts'
    weights must agree within the fixed-step bar (the adaptive body's on
    all but BEYOND_SHARE of the problems: two runs that may part at a
    tie), and the layout the wrapper routes the shape to must be the
    fastest measured there (the routing rule is the measurement).
    ``mv_layouts`` does the same for kernel C."""
    from kmpc_tpu_torch.ops import mpc_cuda as M

    for S, B, H, N, seed in LAYOUT_SHAPES:
        cw_np, ys_np = (instance(B, H, N, seed) if S is None
                        else scenario_instance(B, S, H, N, seed))
        cw = torch.as_tensor(cw_np, device="cuda")
        r = torch.exp(torch.as_tensor(ys_np, device="cuda")).contiguous()
        taken = [lay for lay in M.LAYOUTS if M.layout_supports(lay, S, H, N)]
        for body, p in layout_bodies(B).items():
            routed, routed_body, _ = M._route(S, H, N, p)
            assert routed_body == body, (S, H, body, routed_body)

            def run(layout):
                return pinned(layout, cw, r, p)

            times = alternating_ms({lay: lay for lay in taken}, run)
            w = {lay: run(lay)[0] for lay in taken}
            torch.cuda.synchronize()
            medians = {lay: float(np.median(t)) for lay, t in times.items()}
            apart = {}
            for lay in taken:
                assert torch.isfinite(w[lay]).all(), (S, B, H, body, lay)
                dw = (w[lay] - w[routed]).abs().amax(dim=(1, 2))
                apart[lay] = (dw > W_TOL).float().mean().item()
                assert apart[lay] <= (BEYOND_SHARE if body == "adaptive"
                                      else 0.0), \
                    f"layouts S={S} B={B} H={H} {body} {lay}: " \
                    f"{apart[lay]} of the problems apart"
            fastest = min(medians, key=medians.get)
            emit("layouts", S=S, B=B, H=H, N=N, body=body,
                 iters=p.max_iters, routed=routed, fastest=fastest,
                 ms=times, over_routed={lay: m / medians[routed]
                                        for lay, m in medians.items()},
                 share_beyond_w_tol=apart)
            assert fastest == routed, \
                f"S={S} B={B} H={H} N={N} {body}: routed to {routed}, " \
                f"but {fastest} measured faster: {medians}"


def mv_layouts():
    """Both layouts of kernel C at B=1028 with per-problem covariances,
    which the warp layout takes: the Markowitz path's shape (H=1, N=20;
    2000 iterations at gamma 1, and its accurate configuration, 800
    adaptive) and H=5, N=30 (bench.py's Markowitz setting, 1000
    iterations at refresh 16, and 1000 adaptive); timed and held as
    ``phase_layouts`` holds kernels A and B, at the mean-variance weight
    bar."""
    from kmpc_tpu_torch.ops import mv_cuda as V
    from kmpc_tpu_torch.ops.mpc import MPCParams

    B = 1028
    shapes = {
        (1, 20, 410): {
            "fixed": MPCParams(max_iters=2000, gamma=1.0, horizon=1),
            "adaptive": MPCParams(max_iters=800, gamma=1.0, horizon=1,
                                  adaptive=True, adapt_every=2,
                                  precond=True)},
        (5, 30, 412): {
            "fixed": _params(max_iters=1000, gamma=5.0,
                             proj_refresh_every=16),
            "adaptive": _params(max_iters=1000, gamma=5.0, adaptive=True,
                                adapt_every=2)},
    }
    for (H, N, seed), bodies in shapes.items():
        cw, mu, sig = (torch.as_tensor(x, device="cuda")
                       for x in mv_instance(B, H, N, seed, scale=0.01))
        sig = (0.5 * (sig + sig.transpose(-1, -2))).contiguous()
        for body, p in bodies.items():
            layout, warp = V._mv_route(H, N, p)
            assert layout == "warp", (H, N, body, layout)
            kernels = {"warp": warp,
                       "block": V._MV_KERNELS[("block", p.adaptive)]}

            def run(kernel):
                return V._mv_launch(kernel, cw, mu, sig, p)

            times = alternating_ms(kernels, run)
            (w_warp, _), (w_block, _) = (run(k) for k in kernels.values())
            torch.cuda.synchronize()
            dw = (w_warp - w_block).abs().amax(dim=(1, 2))
            assert torch.isfinite(w_block).all(), (H, N, body)
            beyond = (dw > MV_W_TOL).float().mean().item()
            assert beyond <= (BEYOND_SHARE if p.adaptive else 0.0), \
                f"layouts C H={H} N={N} {body}: {beyond} of the problems apart"
            warp_ms, block_ms = (float(np.median(t)) for t in times.values())
            emit("layouts", program="mean_variance", B=B, H=H, N=N,
                 body=body, iters=p.max_iters, warp_kernel=warp.name,
                 block_kernel=kernels["block"].name, warp_ms=times["warp"],
                 block_ms=times["block"], block_over_warp=block_ms / warp_ms,
                 max_abs_dw=dw.max().item(), share_beyond_w_tol=beyond)


def phase_nan_row():
    """A NaN forecast row holds the current weights on both paths."""
    from kmpc_tpu_torch.ops.mpc import MPCParams, STATUS_FAILURE
    from kmpc_tpu_torch.ops.mpc_cuda import solve_mpc_log_utility_packed

    cw_np, ys_np = instance(6, 5, 20, 7)
    ys_np[2, 3, 4] = np.nan
    p = MPCParams(max_iters=300, sigma_scale=2.0)
    outs = [solve_mpc_log_utility_packed(torch.as_tensor(cw_np),
                                         torch.as_tensor(ys_np), p, device=d)
            for d in ("cuda", "cpu")]
    for w, info in outs:
        assert info["status_code"][2].item() == STATUS_FAILURE
        assert torch.equal(w[2].cpu(), torch.as_tensor(cw_np[2]).expand(5, 20))
        assert torch.isfinite(w).all()
    emit("nan_row", held=True)


def phase_probe():
    """Bench probe: 64 instances (seed 1234, H=5, N=30), min-form objective
    gap against the cached float64 oracle, at the bench setting (fixed
    steps, 1000 iterations) and at the accurate one (adaptive steps, 800
    iterations)."""
    from kmpc_tpu_torch.ops.mpc import MPCParams
    from kmpc_tpu_torch.ops.mpc_cuda import solve_mpc_log_utility_packed

    rng = np.random.default_rng(1234)
    cw = rng.dirichlet(np.ones(30), size=64).astype(np.float32)
    ys = (rng.standard_normal((64, 5, 30)) * 0.01 + 0.0005).astype(np.float32)
    oracle = np.asarray(json.loads((ROOT / "bench_probe_cache.json")
                                   .read_text())["log_H5_N30_n64_seed1234"])
    common = dict(sigma_scale=2.0, feas_tol=2e-4, precond=True)
    settings = {
        "probe": (MPCParams(max_iters=1000, proj_refresh_every=16, **common),
                  2e-3),
        "probe_accurate": (MPCParams(max_iters=800, adaptive=True,
                                     adapt_every=2, **common),
                           ACCURATE_PROBE_GAP),
    }

    def min_objective(w):
        return probe_objective(w, ys, cw)

    out = {}
    for phase, (p, bar) in settings.items():
        w_k, _ = solve_mpc_log_utility_packed(
            torch.as_tensor(cw), torch.as_tensor(ys), p, device="cuda")
        w_p, _ = _plain_solve(cw, ys, p)
        objs = {"cuda": min_objective(w_k.cpu().numpy()),
                "plain": min_objective(w_p.cpu().numpy())}
        gap = objs["cuda"] - oracle
        d = float(np.max(np.abs(objs["cuda"] - objs["plain"])))
        res = {"iters": p.max_iters, "adaptive": p.adaptive,
               "median_gap": float(np.median(gap)),
               "p90_gap": float(np.quantile(gap, 0.9)),
               "max_gap": float(np.max(gap)), "max_kernel_vs_plain": d,
               "median_gap_bar": bar}
        emit(phase, **res)
        assert res["median_gap"] <= bar, res
        assert d <= OBJ_TOL, res
        out[phase] = res
    return out


def probe_objective(w, ys, cw, cost_coeff=0.001):
    """The min-form log-utility objective in float64 on the host, as
    bench.py's probe takes it."""
    w = np.asarray(w, np.float64)
    r = np.exp(np.asarray(ys, np.float64))
    port = np.maximum((w * r).sum(-1), 1e-300)
    prev = np.concatenate([np.asarray(cw, np.float64)[:, None], w[:, :-1]], 1)
    return -np.log(port).sum(-1) + cost_coeff * np.abs(w - prev).sum((-2, -1))


def _plain_solve(cw, ys, p):
    """The fused solve with the plain version on the card."""
    from kmpc_tpu_torch.ops import mpc_cuda as M

    w0 = torch.as_tensor(cw, device="cuda")
    r = torch.exp(torch.as_tensor(ys, device="cuda")).contiguous()
    w, fp = M.pdhg_log_utility_plain(w0, r, p)
    return M._finalize_packed(w, r, w0, p, fp)


def buy_and_hold_jacobi_f64(rets, n_dates, sweeps, bt):
    """Final value of the buy-and-hold backtest in float64 numpy, with the
    wealth/drift recursion of the port: by Jacobi sweeps (targets = the
    guess, equal weights on the first date), or, with ``sweeps`` None, by
    the exact scan (each date holds what the market left)."""
    n = rets.shape[1]
    guess = np.full((n_dates, n), 1.0 / n)
    for _ in range(1 if sweeps is None else sweeps):
        targets = guess.copy()
        targets[0] = 1.0 / n
        v, w = bt.INITIAL_CAPITAL, np.full(n, 1.0 / n)
        for t in range(n_dates):
            guess[t] = w
            target = w if sweeps is None and t > 0 else targets[t]
            v -= bt.COST_COEFF * np.abs(target - w).sum() * v
            g = np.exp(rets[t + 1]) - 1.0
            pr = float(target @ g)
            v *= 1.0 + pr
            w = target * (1.0 + g) / (1.0 + pr)
    return v


def phase_main_path(seed: int):
    import pandas as pd

    from kmpc_tpu_torch.backtest.engine import (
        BuyAndHoldStrategy, KoopmanMPCStrategy, calculate_metrics,
        run_backtest_parallel,
    )
    from kmpc_tpu_torch.config import get_config
    from kmpc_tpu_torch.data.finance import load_finance_data
    from kmpc_tpu_torch.models.koopman import make_model
    from kmpc_tpu_torch.ops import mpc_cuda as M
    from kmpc_tpu_torch.ops.rollout import predict_returns
    from kmpc_tpu_torch.run_experiment import backtest_settings

    sweeps = 4
    dev = torch.device("cuda")
    cfg = get_config("finance_sparse")
    cfg.ENV.FINANCE.CACHE_DIR = None
    t0 = time.perf_counter()
    fd = load_finance_data(cfg, device=dev)
    model = make_model(cfg, fd.observation_size, device=dev)
    model.init_params(torch.Generator(device=dev).manual_seed(seed)).eval()
    load_s = time.perf_counter() - t0
    bt, mpc = backtest_settings(cfg)
    n_dates = fd.test.shape[0] - fd.sequence_length - bt.HORIZON
    assert fd.observation_size == 400 and model.target_size == 1024

    # The forecast alone, timed; and on the CPU for the first dates.
    fc_ms = cuda_ms(lambda: predict_returns(model, fd.test, bt.HORIZON,
                                            fd.n_assets, fd.mean, fd.std), 3)
    preds = predict_returns(model, fd.test, bt.HORIZON, fd.n_assets,
                            fd.mean, fd.std)
    assert preds.shape == (fd.test.shape[0], bt.HORIZON, fd.n_assets)
    assert torch.isfinite(preds).all()
    cpu_model = make_model(cfg, fd.observation_size, device="cpu")
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    ref = predict_returns(cpu_model, fd.test[:32].cpu(), bt.HORIZON,
                          fd.n_assets, fd.mean.cpu(), fd.std.cpu())
    fc_err = (preds[:32].cpu() - ref).abs().max().item()
    assert fc_err <= 1e-4, fc_err

    strat = KoopmanMPCStrategy(model=model, mpc=mpc)
    timed = Timed("KoopmanMPC", strat, mpc.max_turnover)
    kernel = M._route(None, bt.HORIZON, fd.n_assets, mpc)[2]
    assert kernel is M.PDHG_LOG_UTILITY_ROWS, kernel.name
    kernel.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    df = run_backtest_parallel(strat, fd, bt, num_sweeps=sweeps)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = kernel.launches
    assert launches == sweeps, f"kernel launched {launches} times, not {sweeps}"
    assert len(df) == n_dates
    assert np.all(np.isfinite(df[["portfolio_value", "return", "turnover",
                                  "cost"]].to_numpy()))

    t0 = time.perf_counter()
    df_bh = run_backtest_parallel(BuyAndHoldStrategy(), fd, bt,
                                  num_sweeps=sweeps)
    bh_s = time.perf_counter() - t0
    rets = (fd.destandardize_returns(fd.extract_current_returns(fd.test))
            .double().cpu().numpy())
    bh_ref = buy_and_hold_jacobi_f64(rets, n_dates, sweeps, bt)
    bh_err = abs(df_bh["portfolio_value"].iloc[-1] / bh_ref - 1.0)
    assert bh_err <= 1e-4, bh_err

    # The main path's first solve (pre-trade guess 1/N on every date) by
    # the kernel and by its plain version, on the same card inputs.
    aux = strat.precompute(fd, bt.HORIZON)
    r = torch.exp(aux["pred_log_returns"][:n_dates]).contiguous()
    cw = torch.full((n_dates, fd.n_assets), 1.0 / fd.n_assets, device=dev)
    first = compare_tensors("main_path", cw, r, mpc, time_reps=5)
    kernel_ms, plain_ms = first["kernel_ms"], first["plain_ms"]
    dw, dobj = first["max_abs_dw"], first["max_abs_dobj"]
    solve_ms = 1e3 * float(np.median(timed.solve_s))
    sweep_ms = 1e3 * total_s / sweeps
    table = pd.DataFrame({"KoopmanMPC": calculate_metrics(df),
                          "BuyAndHold": calculate_metrics(df_bh)}).T
    print(table.to_string(), flush=True)
    emit("main_path", config="finance_sparse", observation_size=400,
         latent=1024, dates=n_dates, sweeps=sweeps, mpc_iters=mpc.max_iters,
         kernel=kernel.name, kernel_launches=launches, load_s=load_s, forecast_ms=fc_ms,
         forecast_cpu_max_abs_err=fc_err, sweep_ms=sweep_ms,
         solve_ms=solve_ms, kernel_ms=kernel_ms,
         recursion_ms=sweep_ms - solve_ms, plain_ms=plain_ms,
         max_abs_dw=dw, max_abs_dobj=dobj, buy_and_hold_s=bh_s,
         buy_and_hold_rel_err_f64=bh_err,
         dates_per_s=n_dates / total_s,
         metrics={k: {m: float(x) for m, x in row.items()}
                  for k, row in table.iterrows()})
    return {"fd": fd, "model": model, "cfg": cfg, "n_dates": n_dates,
            "kernel": kernel.name, "first": first}


class Timed:
    """Wraps a strategy's all-dates solves: records each call's seconds
    (synchronised) and checks every returned weight row."""

    def __init__(self, name, strategy, max_turnover):
        self.name, self.strategy = name, strategy
        self.max_turnover = max_turnover
        self.solve_s = []
        self.guesses = []
        self.outs = []
        self._all = strategy.rebalance_all
        strategy.rebalance_all = self.rebalance_all
        if hasattr(strategy, "rebalance_all_warm"):
            self._warm = strategy.rebalance_all_warm
            strategy.rebalance_all_warm = self.rebalance_all_warm

    def _check(self, current, targets):
        t64 = targets.double()
        assert torch.isfinite(t64).all(), f"{self.name}: non-finite weights"
        assert torch.all((t64.sum(-1) - 1.0).abs() <= FEAS_TOL), \
            f"{self.name}: a weight row is off the simplex"
        assert torch.all(t64 >= -FEAS_TOL), f"{self.name}: negative weight"
        if self.max_turnover is not None:
            to = (t64 - current.double()).abs().sum(-1)
            assert torch.all(to <= self.max_turnover + FEAS_TOL), \
                f"{self.name}: turnover {to.max().item()} over the cap"

    def _timed(self, fn, aux, current, *args, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn(aux, current, *args, **kw)
        torch.cuda.synchronize()
        self.solve_s.append(time.perf_counter() - t)
        self._check(current, out[0] if isinstance(out, tuple) else out)
        self.guesses.append(current)
        self.outs.append(out)
        self.aux = aux
        return out

    def rebalance_all(self, aux, current):
        return self._timed(self._all, aux, current)

    def rebalance_all_warm(self, aux, current, warm, max_iters=None):
        return self._timed(self._warm, aux, current, warm,
                           max_iters=max_iters)


CAPPED = {"DMD", "KoopmanMPC", "ScenarioKelly"}
SCENARIOS = 16


# The kernel each strategy's batched solve must launch on a path (buy-and-
# hold launches none): the comparison (fixed steps, H=5) and the accurate
# path; the long path's runs name theirs in LONG_RUNS.
FIXED_REACH = {"Markowitz": "pdhg_mean_variance",
               "DMD": "pdhg_log_utility_rows",
               "KoopmanMPC": "pdhg_log_utility_rows",
               "ScenarioKelly": "pdhg_log_utility_scenarios_rows"}
ACCURATE_REACH = {k: v + "_adaptive" for k, v in FIXED_REACH.items()}


def strategy_kernel(name, mpc, mv_mpc, n_assets):
    """The kernel the wrapper routes a strategy's batched solve to under
    these settings (None for buy-and-hold): the mean-variance kernel for
    Markowitz, else the log-utility kernel of the shape and body."""
    from kmpc_tpu_torch.ops.mpc_cuda import _route
    from kmpc_tpu_torch.ops.mv_cuda import _mv_route

    if name == "BuyAndHold":
        return None
    if name == "Markowitz":    # one step ahead, per-date covariances
        return _mv_route(1, n_assets, mv_mpc)[1].name
    S = SCENARIOS if name == "ScenarioKelly" else None
    return _route(S, mpc.horizon, n_assets, mpc)[2].name


def expect_kernel(reach, name, mpc, mv_mpc, n_assets):
    """``reach[name]``, the kernel named for the strategy on its path, after
    asserting that the wrapper routes the strategy's solve there."""
    routed = strategy_kernel(name, mpc, mv_mpc, n_assets)
    assert routed == reach[name], f"{name}: routed to {routed}, not {reach[name]}"
    return reach[name]


def kernel_counters():
    """Every kernel's launch counter by name."""
    from kmpc_tpu_torch.ops import mpc_cuda as M
    from kmpc_tpu_torch.ops import mv_cuda as V
    from kmpc_tpu_torch.ops.mv_ladder import MV_LADDER

    return {k.name: k for k in M.KERNELS + V.MV_KERNELS + (MV_LADDER,)}


def run_strategies(ctx, cfg, sweeps, reach, horizon=None, names=None):
    """The five-strategy Jacobi comparison (or the ``names`` among them)
    under ``cfg``'s solver settings and ``horizon`` (default the config's),
    every batched solve through its kernel and every returned weight row
    checked. Counts are set to 0 just before and read just after; each
    strategy other than buy-and-hold must have launched the kernel
    ``reach`` names for it once a sweep, and no other. Returns
    (strategies, frames, timing, launches, KoopmanMPC's ``Timed``, (mpc,
    mv_mpc, bt))."""
    from kmpc_tpu_torch.backtest.engine import run_backtest_parallel
    from kmpc_tpu_torch.run_experiment import (
        backtest_settings, build_strategies, markowitz_settings,
    )

    fd, model = ctx["fd"], ctx["model"]
    bt, mpc = backtest_settings(cfg, horizon=horizon)
    mv_mpc = markowitz_settings(cfg)
    n_dates = fd.test.shape[0] - fd.sequence_length - bt.HORIZON
    strategies = build_strategies(model, mpc, mv_mpc, bt.LOOKBACK_WINDOW,
                                  scenarios=SCENARIOS, fused=True)
    if names is not None:
        strategies = {k: v for k, v in strategies.items() if k in names}
    kernels = kernel_counters()
    for k in kernels.values():
        k.launches = 0
    frames, timing, koopman = {}, {}, None
    for name, strat in strategies.items():
        timed = Timed(name, strat,
                      mpc.max_turnover if name in CAPPED else None)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        frames[name] = run_backtest_parallel(strat, fd, bt, num_sweeps=sweeps)
        torch.cuda.synchronize()
        total_s = time.perf_counter() - t0
        solve_ms = 1e3 * float(np.median(timed.solve_s))
        # The first sweep's share of the run holds the precompute pass.
        timing[name] = {
            "total_s": total_s, "solve_ms": solve_ms,
            "recursion_ms": 1e3 * (total_s - sum(timed.solve_s)) / sweeps,
        }
        if name == "KoopmanMPC":
            koopman = timed
        df = frames[name]
        assert len(df) == n_dates, name
        assert np.all(np.isfinite(df[["portfolio_value", "return",
                                      "turnover", "cost"]].to_numpy())), name
    launches = {k: v.launches for k, v in kernels.items()}
    want = {k: 0 for k in kernels}
    for name in strategies:
        if name != "BuyAndHold":
            want[expect_kernel(reach, name, mpc, mv_mpc, fd.n_assets)] += sweeps
    assert launches == want, f"launches {launches}, expected {want}"
    return strategies, frames, timing, launches, koopman, (mpc, mv_mpc, bt)


def first_solves(ctx, strategies, mpc, mv_mpc, bt, names, label, reach):
    """The path's first solves (pre-trade guess 1/N on every date) of the
    named strategies, by each kernel and by its plain version on the same
    card inputs: {kernel name (``reach``): the case}."""
    fd = ctx["fd"]
    n = fd.n_assets
    n_dates = fd.test.shape[0] - fd.sequence_length - bt.HORIZON
    cw = torch.full((n_dates, n), 1.0 / n, device=fd.device)
    first = {}
    for name in names:
        aux = strategies[name].precompute(fd, bt.HORIZON)
        if name == "Markowitz":
            mu = aux["mu"][:n_dates, None, :].contiguous()
            res = compare_mv_tensors(label, cw, mu, aux["sigma"][:n_dates],
                                     mv_mpc, time_reps=5)
        else:
            key = ("scenario_log_returns" if name == "ScenarioKelly"
                   else "pred_log_returns")
            r = torch.exp(aux[key][:n_dates]).contiguous()
            res = compare_tensors(label, cw, r, mpc, time_reps=5)
        first[expect_kernel(reach, name, mpc, mv_mpc, n)] = res
    return first


def phase_comparison(ctx):
    """The full strategy comparison at full width, every batched solve
    through its kernel; then Koopman-MPC with warm sweeps. Returns the
    launches per kernel on the comparison path, the first solves' cases
    and the final values."""
    import pandas as pd

    from kmpc_tpu_torch.backtest.engine import (
        calculate_metrics, run_backtest_parallel,
    )
    from kmpc_tpu_torch.ops.mpc_cuda import _route
    from kmpc_tpu_torch.run_experiment import build_strategies

    sweeps, warm_iters = 8, 500
    fd, model, cfg = ctx["fd"], ctx["model"], ctx["cfg"]
    strategies, frames, timing, launches, koopman, (mpc, mv_mpc, bt) = \
        run_strategies(ctx, cfg, sweeps, FIXED_REACH)
    n_dates = len(frames["KoopmanMPC"])
    # How far the pre-trade guesses still moved into the last sweep.
    guess_move = (koopman.guesses[-1] - koopman.guesses[-2]) \
        .abs().sum(-1).max().item()

    # Koopman-MPC again, later sweeps warm at a quarter of the budget: by
    # the kernel, and by the eager solver (an independent implementation of
    # the same sweeps, on the card). The two must agree on the final value.
    # Against the cold run the warm one is judged on objectives: 8 sweeps do
    # not converge the Jacobi iteration on random-weight forecasts (the
    # line reports how far the pre-trade guesses moved into the last sweep,
    # and how far a cold run of twice the sweeps lands from the cold run of
    # 8), so the two runs' wealth may differ by percents. In every warm
    # sweep the warm solution is held against cold solves from the same
    # pre-trade weights: its deficit to the full-budget solve is bounded
    # relative to the size of the objective, and it must lose several times
    # less than a cold solve of the same 500 iterations, which a wrong warm
    # start would not.
    from dataclasses import replace

    from kmpc_tpu_torch.ops.mpc import _log_utility_objective
    from kmpc_tpu_torch.ops.mpc_cuda import solve_mpc_log_utility_packed

    def warm_run(fused):
        strat = build_strategies(model, mpc, mv_mpc, bt.LOOKBACK_WINDOW,
                                 fused=fused)["KoopmanMPC"]
        timed = Timed("KoopmanMPC_warm", strat, mpc.max_turnover)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        df = run_backtest_parallel(strat, fd, bt, num_sweeps=sweeps,
                                   warm_sweeps_iters=warm_iters)
        torch.cuda.synchronize()
        return df, timed, time.perf_counter() - t0

    kernel = _route(None, mpc.horizon, fd.n_assets, mpc)[2]
    kernel.launches = 0
    df_warm, timed, warm_s = warm_run(fused=True)
    assert kernel.launches == sweeps, kernel.launches
    df_eager, _, _ = warm_run(fused=False)
    assert kernel.launches == sweeps, kernel.launches
    warm_v = df_warm["portfolio_value"].iloc[-1]
    eager_rel = abs(warm_v / df_eager["portfolio_value"].iloc[-1] - 1.0)
    assert eager_rel <= 1e-3, \
        f"warm sweeps: kernel and eager final values differ by {eager_rel}"
    y_w = timed.aux["pred_log_returns"]
    r_w = torch.exp(y_w)
    short = replace(mpc, max_iters=warm_iters)
    warm_checks = []
    for k in range(1, sweeps):
        guess, (_, (w_warm, _)) = timed.guesses[k], timed.outs[k]
        obj_warm = _log_utility_objective(w_warm, r_w, guess, mpc.cost_coeff)
        obj_full = solve_mpc_log_utility_packed(guess, y_w, mpc)[1]["objective"]
        obj_short = solve_mpc_log_utility_packed(guess, y_w, short)[1]["objective"]
        d_warm, d_short = obj_full - obj_warm, obj_full - obj_short
        warm_checks.append({
            "sweep": k, "objective_abs_median": obj_full.abs().median().item(),
            "warm_deficit_max": d_warm.max().item(),
            "warm_deficit_mean": d_warm.mean().item(),
            "cold_same_budget_deficit_max": d_short.max().item(),
            "cold_same_budget_deficit_mean": d_short.mean().item()})
    emit("warm_sweeps", checks=warm_checks)
    for c in warm_checks:
        assert c["warm_deficit_max"] <= WARM_DEFICIT_REL \
            * c["objective_abs_median"], f"warm solution too poor: {c}"
        assert c["warm_deficit_mean"] <= WARM_DEFICIT_MEAN, \
            f"warm solutions too poor on average: {c}"
        assert c["warm_deficit_max"] <= WARM_VS_COLD_MAX_SHARE \
            * c["cold_same_budget_deficit_max"] \
            and c["warm_deficit_mean"] <= WARM_VS_COLD_MEAN_SHARE \
            * c["cold_same_budget_deficit_mean"], \
            f"the warm start did not help: {c}"
    warm_obj_deficit = max(c["warm_deficit_max"] for c in warm_checks)
    cold_v = frames["KoopmanMPC"]["portfolio_value"].iloc[-1]
    warm_rel = abs(warm_v / cold_v - 1.0)
    df_cold2 = run_backtest_parallel(strategies["KoopmanMPC"], fd, bt,
                                     num_sweeps=2 * sweeps)
    cold2_rel = abs(df_cold2["portfolio_value"].iloc[-1] / cold_v - 1.0)

    first = first_solves(ctx, strategies, mpc, mv_mpc, bt,
                         ("ScenarioKelly", "Markowitz"), "comparison_path",
                         FIXED_REACH)
    for name, res in first.items():
        emit("comparison_first_solve", **dict(res, kernel=name))

    table = pd.DataFrame({k: calculate_metrics(v)
                          for k, v in frames.items()}).T
    print(table.to_string(), flush=True)
    assert len(table) == 5
    emit("comparison", config="finance_sparse", dates=n_dates, sweeps=sweeps,
         scenarios=SCENARIOS, mpc_iters=mpc.max_iters, launches=launches,
         per_strategy=timing,
         warm_sweeps_iters=warm_iters, warm_total_s=warm_s,
         warm_solve_ms=[1e3 * x for x in timed.solve_s],
         warm_kernel_vs_eager_final_value_rel_diff=float(eager_rel),
         warm_vs_cold_objective_deficit_max=warm_obj_deficit,
         warm_vs_cold_final_value_rel_diff=float(warm_rel),
         cold_twice_the_sweeps_final_value_rel_diff=float(cold2_rel),
         last_sweep_guess_move_l1_max=guess_move,
         total_s=sum(t["total_s"] for t in timing.values()),
         metrics={k: {m: float(x) for m, x in row.items()}
                  for k, row in table.iterrows()})
    return launches, first, {k: float(v["portfolio_value"].iloc[-1])
                             for k, v in frames.items()}


def accurate_config(cfg):
    """A copy of ``cfg`` with the solver at the accurate configuration."""
    import copy

    acc = copy.deepcopy(cfg)
    acc.MPC.SOLVER.ADAPTIVE = True
    acc.MPC.SOLVER.ADAPT_EVERY = 2
    acc.MPC.SOLVER.PRECOND = True
    acc.MPC.SOLVER.MAX_ITERS = 800
    return acc


def phase_accurate_path(ctx, fixed_values):
    """The comparison with the configuration's solver at the accurate
    configuration: every batched solve through an adaptive kernel. Returns
    the launches per kernel and the first solves' cases."""
    import pandas as pd

    from kmpc_tpu_torch.backtest.engine import calculate_metrics

    sweeps = 4
    cfg = accurate_config(ctx["cfg"])
    strategies, frames, timing, launches, _, (mpc, mv_mpc, bt) = \
        run_strategies(ctx, cfg, sweeps, ACCURATE_REACH)
    assert mpc.adaptive and mpc.adapt_every == 2 and mpc.precond \
        and mpc.max_iters == 800 and mv_mpc.adaptive
    first = first_solves(ctx, strategies, mpc, mv_mpc, bt,
                         ("KoopmanMPC", "ScenarioKelly", "Markowitz"),
                         "accurate_path", ACCURATE_REACH)
    for name, res in first.items():
        emit("accurate_first_solve", **dict(res, kernel=name))
    table = pd.DataFrame({k: calculate_metrics(v)
                          for k, v in frames.items()}).T
    print(table.to_string(), flush=True)
    assert len(table) == 5
    values = {k: float(v["portfolio_value"].iloc[-1])
              for k, v in frames.items()}
    emit("accurate_path", config="finance_sparse", dates=len(frames["DMD"]),
         sweeps=sweeps, scenarios=SCENARIOS, mpc_iters=mpc.max_iters,
         adapt_every=mpc.adapt_every, precond=mpc.precond, launches=launches,
         per_strategy=timing, final_values=values,
         fixed_step_final_values_8_sweeps=fixed_values,
         total_s=sum(t["total_s"] for t in timing.values()))
    return launches, first


class TimedScan:
    """Wraps a strategy's per-date solve: each call's seconds
    (synchronised), and each target checked."""

    def __init__(self, name, strategy, max_turnover):
        self.name, self.max_turnover = name, max_turnover
        self.solve_s = []
        self._rebalance = strategy.rebalance
        strategy.rebalance = self.rebalance

    def rebalance(self, aux, t, current, warm):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        target, warm = self._rebalance(aux, t, current, warm)
        torch.cuda.synchronize()
        self.solve_s.append(time.perf_counter() - t0)
        t64 = target.double()
        assert torch.isfinite(t64).all(), f"{self.name}: non-finite weights"
        assert abs(t64.sum().item() - 1.0) <= FEAS_TOL \
            and t64.min().item() >= -FEAS_TOL, \
            f"{self.name}: date {t} is off the simplex"
        if self.max_turnover is not None:
            to = (t64 - current.double()).abs().sum().item()
            assert to <= self.max_turnover + FEAS_TOL, \
                f"{self.name}: date {t} turns over {to}"
        return target, warm


def phase_scan_path(ctx):
    """The exact backtest at the accurate configuration, one solve of one
    problem per date: over all dates for buy-and-hold and Koopman-MPC, on a
    test split cut to 64 dates for all five, where the Jacobi backtest with
    as many sweeps as dates must give the same portfolio values."""
    from dataclasses import replace

    from kmpc_tpu_torch.backtest.engine import (
        run_backtest, run_backtest_parallel,
    )
    from kmpc_tpu_torch.run_experiment import (
        backtest_settings, build_strategies, markowitz_settings,
    )

    fd, model = ctx["fd"], ctx["model"]
    cfg = accurate_config(ctx["cfg"])
    bt, mpc = backtest_settings(cfg)
    mv_mpc = markowitz_settings(cfg)
    kernels = kernel_counters()
    n_dates = fd.test.shape[0] - fd.sequence_length - bt.HORIZON

    def scan(name, data):
        """(frame, launches by kernel, seconds, per-date solve seconds)."""
        strat = build_strategies(model, mpc, mv_mpc, bt.LOOKBACK_WINDOW,
                                 scenarios=SCENARIOS, fused=True)[name]
        timed = TimedScan(name, strat,
                          mpc.max_turnover if name in CAPPED else None)
        for k in kernels.values():
            k.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        df = run_backtest(strat, data, bt)
        torch.cuda.synchronize()
        total_s = time.perf_counter() - t0
        launched = {k: v.launches for k, v in kernels.items() if v.launches}
        assert np.all(np.isfinite(df[["portfolio_value", "return",
                                      "turnover", "cost"]].to_numpy())), name
        return df, launched, total_s, timed.solve_s

    full = {}
    for name in ("BuyAndHold", "KoopmanMPC"):
        df, launched, total_s, solve_s = scan(name, fd)
        assert len(df) == n_dates, name
        want = {} if name == "BuyAndHold" else {expect_kernel(
            ACCURATE_REACH, name, mpc, mv_mpc, fd.n_assets): n_dates}
        assert launched == want, f"{name}: launches {launched}, not {want}"
        full[name] = {
            "dates": n_dates, "total_s": total_s, "launches": launched,
            "solve_ms_per_date": 1e3 * float(np.median(solve_s)),
            "recursion_ms_per_date": 1e3 * (total_s - sum(solve_s)) / n_dates,
            "final_value": float(df["portfolio_value"].iloc[-1])}
    rets = (fd.destandardize_returns(fd.extract_current_returns(fd.test))
            .double().cpu().numpy())
    bh_ref = buy_and_hold_jacobi_f64(rets, n_dates, None, bt)
    bh_err = abs(full["BuyAndHold"]["final_value"] / bh_ref - 1.0)
    assert bh_err <= 1e-4, bh_err

    # The cut split: every strategy by the scan and by as many Jacobi
    # sweeps as dates, which is exact: the same kernel on the same problems.
    cut_dates = min(64, n_dates)
    rows = cut_dates + fd.sequence_length + bt.HORIZON
    cut = replace(fd, test=fd.test[:rows].contiguous(),
                  test_dates=fd.test_dates[:rows])
    per_strategy = {}
    for name in ("BuyAndHold", "Markowitz", "DMD", "KoopmanMPC",
                 "ScenarioKelly"):
        df, launched, total_s, solve_s = scan(name, cut)
        assert len(df) == cut_dates, name
        want = {} if name == "BuyAndHold" else {expect_kernel(
            ACCURATE_REACH, name, mpc, mv_mpc, fd.n_assets): cut_dates}
        assert launched == want, f"{name}: launches {launched}, not {want}"
        strat = build_strategies(model, mpc, mv_mpc, bt.LOOKBACK_WINDOW,
                                 scenarios=SCENARIOS, fused=True)[name]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        par = run_backtest_parallel(strat, cut, bt, num_sweeps=cut_dates)
        torch.cuda.synchronize()
        par_s = time.perf_counter() - t0
        a, b = (x["portfolio_value"].to_numpy() for x in (par, df))
        rel = float(np.max(np.abs(a / b - 1.0)))
        assert rel <= 1e-5, \
            f"{name}: scan and {cut_dates} Jacobi sweeps differ by {rel}"
        per_strategy[name] = {
            "scan_s": total_s, "launches": launched,
            "solve_ms_per_date": 1e3 * float(np.median(solve_s)),
            "recursion_ms_per_date":
                1e3 * (total_s - sum(solve_s)) / cut_dates,
            "jacobi_sweeps": cut_dates, "jacobi_s": par_s,
            "scan_vs_jacobi_value_rel_diff": rel,
            "final_value": float(b[-1])}
    emit("scan_path", config="finance_sparse", mpc_iters=mpc.max_iters,
         adaptive=mpc.adaptive, adapt_every=mpc.adapt_every, all_dates=full,
         buy_and_hold_rel_err_f64=bh_err, cut_dates=cut_dates,
         cut_split=per_strategy)
    return full["KoopmanMPC"]["launches"]


def pipeline_config(cfg):
    """A copy of ``cfg`` with the solver at the pipeline configuration:
    refresh every 16th iteration, pipelined reductions, precond."""
    import copy

    pipe = copy.deepcopy(cfg)
    pipe.MPC.SOLVER.PROJ_REFRESH_EVERY = 16
    pipe.MPC.SOLVER.PIPELINE_REDUCES = True
    pipe.MPC.SOLVER.PRECOND = True
    return pipe


# The long path's runs: (label, config, horizon, sweeps, strategies or None
# for all five, {strategy: the kernel its solve must reach}).
LONG_RUNS = (
    ("pipelined_H20", pipeline_config, 20, 4, None,
     {"DMD": "pdhg_log_utility_rows",
      "KoopmanMPC": "pdhg_log_utility_rows",
      "ScenarioKelly": "pdhg_log_utility_scenarios_rows",
      "Markowitz": "pdhg_mean_variance"}),
    ("accurate_H20", accurate_config, 20, 2, ("KoopmanMPC", "ScenarioKelly"),
     {"KoopmanMPC": "pdhg_log_utility_rows_adaptive",
      "ScenarioKelly": "pdhg_log_utility_scenarios_rows_adaptive"}),
    ("pipelined_H5", pipeline_config, 5, 2, ("KoopmanMPC", "ScenarioKelly"),
     {"KoopmanMPC": "pdhg_log_utility_rows",
      "ScenarioKelly": "pdhg_log_utility_scenarios_rows"}),
)


def phase_long_path(ctx):
    """The long-horizon comparison: the five strategies at H=20 with the
    pipeline configuration (DMD and Koopman-MPC through kernel A's block
    layout, scenario Kelly through kernel B's, Markowitz through C), then
    Koopman-MPC and scenario Kelly at the accurate configuration at H=20
    (the block layout's adaptive kernels) and with the pipeline
    configuration at H=5 (the warp layout's pipelined kernels). Launches
    per kernel asserted, every weight row feasible, each run's first
    solves held against the plain versions. Returns the launches of each
    kernel on its run and the first solves' cases by kernel."""
    import pandas as pd

    from kmpc_tpu_torch.backtest.engine import calculate_metrics

    launches, first, runs = {}, {}, {}
    for label, make_cfg, horizon, sweeps, names, reach in LONG_RUNS:
        cfg = make_cfg(ctx["cfg"])
        strategies, frames, timing, launched, _, (mpc, mv_mpc, bt) = \
            run_strategies(ctx, cfg, sweeps, reach, horizon=horizon,
                           names=names)
        assert mpc.horizon == horizon and bt.HORIZON == horizon
        for kernel in reach.values():
            assert launched[kernel] > 0, (label, kernel)
        solved = tuple(n for n in ("KoopmanMPC", "ScenarioKelly", "Markowitz")
                       if n in strategies)
        cases = first_solves(ctx, strategies, mpc, mv_mpc, bt, solved,
                             f"long_path_{label}", reach)
        for kernel, res in cases.items():
            emit("long_path_first_solve", run=label,
                 **dict(res, kernel=kernel))
            first.setdefault(kernel, res)
        for kernel, n in launched.items():
            if n:
                launches.setdefault(kernel, n)
        table = pd.DataFrame({k: calculate_metrics(v)
                              for k, v in frames.items()}).T
        print(table.to_string(), flush=True)
        runs[label] = {
            "horizon": horizon, "sweeps": sweeps, "dates": len(frames[
                next(iter(frames))]), "mpc_iters": mpc.max_iters,
            "pipeline_reduces": mpc.pipeline_reduces,
            "adaptive": mpc.adaptive, "precond": mpc.precond,
            "launches": {k: v for k, v in launched.items() if v},
            "per_strategy": timing,
            "final_values": {k: float(v["portfolio_value"].iloc[-1])
                             for k, v in frames.items()},
            "total_s": sum(t["total_s"] for t in timing.values())}
    emit("long_path", config="finance_sparse", scenarios=SCENARIOS,
         runs=runs, total_s=sum(r["total_s"] for r in runs.values()))
    return launches, first


# Kernel B's warp layout on a shape that routes to it: (B, S, H, N, seed).
# Each problem's 113 scenarios of 8 rows and 64 assets fill one warp's
# slice of shared memory (226 KB of the 227 KB), past the row layout's plan
# and the block layout's; B=132, one problem per SM of an H100 SXM.
WARP_B_PATH = (132, 113, 8, 64, 1160)


def phase_warp_path(ctx):
    """The warp layout's kernels. Kernel A's (fixed, adaptive, pipelined):
    routing takes the row layout at every shape they take, so they run
    pinned (``pinned``, the private launch) on the comparison path's
    first-sweep Koopman-MPC problems (full width, the pre-trade guess 1/N
    on every date) at the comparison's fixed steps, the accurate
    configuration and the pipeline configuration (H=5), through the packed
    solve's finalisation. Kernel B's: through
    ``solve_mpc_log_utility_scenarios_packed`` at WARP_B_PATH, a shape
    that routes to them, at the same three configurations. Counts set to 0
    before these six solves and read after; then each solve's kernel held
    against the plain version, every row of the weights feasible (the
    simplex sum to FEAS_TOL, or to twice the plain version's own error, as
    ``hold_to_plain`` holds it), and on the comparison's problems of both
    kernels (scenario Kelly at S=16 too) the warp kernel compared bit for
    bit with the row kernel. Returns the launches, the cases at the path's
    shapes by kernel, and the other cases (the row kernels', and kernel B's
    warp kernels' at S=16) by kernel."""
    from dataclasses import replace

    from kmpc_tpu_torch.ops import mpc_cuda as M
    from kmpc_tpu_torch.run_experiment import (
        backtest_settings, build_strategies, markowitz_settings,
    )

    fd, model = ctx["fd"], ctx["model"]
    B, S, H, N, seed = WARP_B_PATH
    cw_b, ys_b = scenario_instance(B, S, H, N, seed)
    cw_b = torch.as_tensor(cw_b, device="cuda")
    y_b = torch.as_tensor(ys_b, device="cuda")
    kernels = kernel_counters()
    solves, comparison = [], []
    for label, make_cfg in (("fixed", lambda c: c),
                            ("accurate", accurate_config),
                            ("pipelined", pipeline_config)):
        bt, mpc = backtest_settings(make_cfg(ctx["cfg"]))
        strategies = build_strategies(
            model, mpc, markowitz_settings(ctx["cfg"]), bt.LOOKBACK_WINDOW,
            scenarios=SCENARIOS, fused=True)
        n_dates = fd.test.shape[0] - fd.sequence_length - bt.HORIZON
        cw = torch.full((n_dates, fd.n_assets), 1.0 / fd.n_assets,
                        device=fd.device)
        for name, key in (("KoopmanMPC", "pred_log_returns"),
                          ("ScenarioKelly", "scenario_log_returns")):
            y = strategies[name].precompute(fd, bt.HORIZON)[key][:n_dates]
            comparison.append((f"{label}_{name}", cw, y.contiguous(), mpc))
        solves.append((f"{label}_KoopmanMPC", *comparison[-2][1:]))
        solves.append((f"{label}_S{S}_H{H}_N{N}", cw_b, y_b,
                       replace(mpc, horizon=H)))
    for k in kernels.values():
        k.launches = 0
    want, weights = {}, []
    for label, cw, y, mpc in solves:
        if y.dim() == 4:
            layout, _, kernel = M._route(S, H, N, mpc)
            assert layout == "warp", (label, layout)
            w = M.solve_mpc_log_utility_scenarios_packed(cw, y, mpc)[0]
        else:
            kernel = pinned_kernel("warp", y, mpc)
            r = torch.exp(y).contiguous()
            out = pinned("warp", cw, r, mpc)
            w = M._finalize_packed(out[0], r, cw, mpc, out[1])[0]
        weights.append(w)
        want[kernel.name] = want.get(kernel.name, 0) + 1
    launches = {k: v.launches for k, v in kernels.items() if v.launches}
    assert launches == want, f"launches {launches}, expected {want}"
    first, extra = {}, {}
    for (label, cw, y, mpc), w in zip(solves, weights):
        if y.dim() == 4:
            res = compare_tensors(f"warp_path_{label}", cw,
                                  torch.exp(y).contiguous(), mpc, time_reps=5)
            check_feasible(w, cw, mpc, f"warp_path {label}", max(
                FEAS_TOL, 2.0 * res["plain_simplex_error"]))
            emit("warp_path_solve", **res)
            first[res["kernel"]] = res
    for label, cw, y, mpc in comparison:
        cases = compare_layouts(f"warp_path_{label}", cw,
                                torch.exp(y).contiguous(), mpc, time_reps=5,
                                layouts=["warp", "rows"])
        if y.dim() == 3:
            w = weights[[s[0] for s in solves].index(label)]
            check_feasible(w, cw, mpc, f"warp_path {label}", max(
                FEAS_TOL, 2.0 * cases["warp"]["plain_simplex_error"]))
            first[cases["warp"]["kernel"]] = cases["warp"]
        else:
            extra.setdefault(cases["warp"]["kernel"], []).append(
                cases["warp"])
        for res in cases.values():
            emit("warp_path_solve", **res)
        extra.setdefault(cases["rows"]["kernel"], []).append(cases["rows"])
    emit("warp_path", dates=len(solves[0][1]), scenario_shape=WARP_B_PATH[:4],
         launches=launches, rows_vs_warp_bits=check_bits(
             [c for cases in extra.values() for c in cases]))
    return launches, first, extra


# The block layout's shapes on its path: past the row layout's four slots.
BLOCK_PATH = (1028, 5, 150)


def phase_block_path():
    """The block layout's kernels at shapes that still route to them, past
    the row layout's four slots: B=1028 problems of H=5 and N=150
    (kmpc_tpu's kernel takes up to N=2730), one forecast and S=16
    scenarios, at bench.py's settings (1000 iterations at refresh 16 with
    precond; 1000 pipelined; 800 adaptive), through the packed entry
    points. Counts set to 0 before these six solves and read after; then
    each held against its plain version (twice for the same bits; the
    adaptive body as a ``wide`` case, LOG_UNSETTLED_FP) and
    every row of the entry point's weights feasible, as in
    ``phase_warp_path``. Returns the launches and the cases by kernel."""
    from kmpc_tpu_torch.ops import mpc_cuda as M

    B, H, N = BLOCK_PATH
    bodies = {
        "fixed": _params(max_iters=1000, proj_refresh_every=16, precond=True),
        "pipe": _params(max_iters=1000, proj_refresh_every=16, precond=True,
                        pipeline_reduces=True),
        "adaptive": _params(max_iters=800, adaptive=True, adapt_every=2,
                            precond=True),
    }
    solves = []
    for S, seed in ((None, 1150), (SCENARIOS, 1151)):
        cw_np, ys_np = (instance(B, H, N, seed) if S is None
                        else scenario_instance(B, S, H, N, seed))
        cw = torch.as_tensor(cw_np, device="cuda")
        y = torch.as_tensor(ys_np, device="cuda")
        solves += [(S, body, cw, y, p) for body, p in bodies.items()]
    kernels = kernel_counters()
    for k in kernels.values():
        k.launches = 0
    want, weights = {}, []
    for S, body, cw, y, p in solves:
        layout, _, kernel = M._route(S, H, N, p)
        assert layout == "block", (S, body, layout)
        solve = (M.solve_mpc_log_utility_packed if S is None
                 else M.solve_mpc_log_utility_scenarios_packed)
        weights.append(solve(cw, y, p)[0])
        want[kernel.name] = want.get(kernel.name, 0) + 1
    launches = {k: v.launches for k, v in kernels.items() if v.launches}
    assert launches == want, f"launches {launches}, expected {want}"
    first = {}
    for (S, body, cw, y, p), w in zip(solves, weights):
        res = compare_tensors(f"block_path_S{S}_{body}", cw,
                              torch.exp(y).contiguous(), p, wide=True)
        check_feasible(w, cw, p, f"block_path S={S} {body}", max(
            FEAS_TOL, 2.0 * res["plain_simplex_error"]))
        emit("block_path_solve", body=body, **res)
        first.setdefault(res["kernel"], res)
    emit("block_path", B=B, H=H, N=N, S=[None, SCENARIOS], launches=launches)
    return launches, first


# The mean-variance solve past one warp's registers: (label, B, H, N,
# shared covariance). The Markowitz program at ``bench.py --mode long``'s
# horizon, past the warp layout's N <= 64 at H=5, and one covariance shared
# by the batch (as ``sharded_mpc_solver(program="mv")`` passes it) read
# from L2 at H=1 and H=5 and staged in shared memory at H=20.
MV_LONG_WIDE = (
    ("long_H20N30", 4096, 20, 30, False),
    ("H5N100", 4096, 5, 100, False),
    ("shared_H1N960", 1028, 1, 960, True),
    ("shared_H5N320", 1028, 5, 320, True),
    ("shared_H20N64", 1028, 20, 64, True),
)
# The plain version's broadcast temporary Sigma[i, j] * w_t[j] holds
# B H N^2 floats; its batch is cut to keep that within this many bytes.
PLAIN_TEMP_BYTES = 1 << 30
MV_PROBE_SEED = 1241   # bench.py's _small_probe_instances
MV_REF_GRAPH = 100     # iterations of the float64 reference per graph


def mv_settings():
    """bench.py's Markowitz settings: fixed steps (1000 iterations, refresh
    16, gamma 5, sigma_scale 2) and adaptive (1000, k=2)."""
    from kmpc_tpu_torch.ops.mpc import MPCParams

    common = dict(max_iters=1000, sigma_scale=2.0, gamma=5.0)
    return {"fixed": MPCParams(proj_refresh_every=16, **common),
            "adaptive": MPCParams(adaptive=True, adapt_every=2, **common)}


def mv_probe_instances(H, N, n=16):
    """bench.py's ``_small_probe_instances("mv", H, N)``: n problems with
    per-problem covariances, seed 1241."""
    r = np.random.default_rng(MV_PROBE_SEED)
    cw = r.dirichlet(np.ones(N), size=n).astype(np.float32)
    ys = (r.standard_normal((n, H, N)) * 0.01 + 0.0005).astype(np.float32)
    A = r.standard_normal((n, N, N)) * 0.01
    sig = (A @ np.swapaxes(A, -1, -2) + np.eye(N) * 1e-4).astype(np.float32)
    return cw, ys, sig


def mv_min_objective(w, mu, sig, cw, gamma=5.0, cost_coeff=0.001):
    """bench.py's min-form mean-variance objective, in float64 on the
    host."""
    w = np.asarray(w, np.float64)
    mu = np.asarray(mu, np.float64)
    sig = np.asarray(sig, np.float64)
    prev = np.concatenate([np.asarray(cw, np.float64)[:, None], w[:, :-1]], 1)
    quad = np.einsum("btn,bnm,btm->b", w, sig, w)
    return (gamma * quad - np.einsum("btn,btn->b", w, mu)
            + cost_coeff * np.abs(w - prev).sum((-2, -1)))


def graph_replay(chunk, eager):
    """An ``ops.mpc._iterate`` (the eager solvers' loop over ``step``) that
    runs the iterations on CUDA tensors as replays of one CUDA graph of
    ``chunk`` iterations, captured on the current stream: the kernels of
    the eager loop in its order on the same values, without the host's cost
    per operation, and the remainder eagerly. ``chunk`` is a multiple of
    the solve's ``adapt_every``, so each replay follows the loop's
    schedule. CPU tensors and solves shorter than ``chunk`` run ``eager``."""

    def iterate(step, state, n):
        trips = n // chunk
        if trips == 0 or not state[0].is_cuda:
            return eager(step, state, n)
        static = [x.clone(memory_format=torch.contiguous_format)
                  for x in state]
        # A warm-up step on a side stream sets up the libraries' handles
        # and workspaces outside the capture.
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            step(0, *[x.clone() for x in static])
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = tuple(static)
            for j in range(chunk):
                out = step(j, *out)
            for s, o in zip(static, out):
                s.copy_(o)
        for _ in range(trips):
            graph.replay()
        state = tuple(static)
        for i in range(trips * chunk, n):
            state = step(i, *state)
        return state

    return iterate


@contextlib.contextmanager
def graph_replayed(chunk):
    """The eager solvers' loop replayed as CUDA graphs (``graph_replay``)
    within the block."""
    from kmpc_tpu_torch.ops import mpc as M

    eager = M._iterate
    M._iterate = graph_replay(chunk, eager)
    try:
        yield
    finally:
        M._iterate = eager


def mv_references(shapes):
    """Float64 reference objectives of each (H, N)'s probe instances, as
    bench.py's ``_ref_objectives("mv", ...)`` builds them: adaptive PDHG
    (k=2, sigma_scale 2, gamma 5) at 40000 iterations, here the port's
    eager solver in float64 on the card. Its loop replays one CUDA graph of
    MV_REF_GRAPH iterations (``graph_replayed``), each shape on a stream of
    its own so that the shapes' small kernels overlap; nothing is timed
    meanwhile."""
    from dataclasses import replace

    from kmpc_tpu_torch.ops.mpc import MPCParams, solve_mpc_mean_variance_batch

    p = MPCParams(max_iters=40000, sigma_scale=2.0, gamma=5.0, adaptive=True,
                  adapt_every=2)
    # The replays are the eager loop: a short solve (two graphs and a
    # remainder) gives the same bits both ways.
    short = replace(p, max_iters=2 * MV_REF_GRAPH + 2)
    args = [torch.as_tensor(x, dtype=torch.float64, device="cuda")
            for x in mv_probe_instances(*shapes[0])]
    eager = solve_mpc_mean_variance_batch(*args, short)[0]
    pending = {}
    with graph_replayed(MV_REF_GRAPH):
        graphed = solve_mpc_mean_variance_batch(*args, short)[0]
        assert torch.equal(eager, graphed), \
            "graph replay differs from the loop"
        for H, N in shapes:
            cw, ys, sig = mv_probe_instances(H, N)
            with torch.cuda.stream(torch.cuda.Stream()):
                w, _ = solve_mpc_mean_variance_batch(
                    *(torch.as_tensor(x, dtype=torch.float64, device="cuda")
                      for x in (cw, ys, sig)), p)
            pending[(H, N)] = (w, cw, ys, sig)
        torch.cuda.synchronize()
    return {shape: mv_min_objective(w.cpu().numpy(), ys, sig, cw)
            for shape, (w, cw, ys, sig) in pending.items()}


def phase_mv_long_wide():
    """The mean-variance solve at the shapes of MV_LONG_WIDE, past the warp
    layout, at both of bench.py's settings: first the path, every shape and
    setting through ``solve_mpc_mean_variance_packed`` on bench.py's
    Markowitz problems (the full batch) and on the shape's 16 probe
    instances, launches counted from 0 and every row held feasible; then
    per shape and setting the block kernel against its plain version per
    problem (the plain version on a batch cut to PLAIN_TEMP_BYTES, timed
    once), run twice for the same bits, timed (CUDA-event median of 3 after
    those runs), its bound and registers, and on the probe instances the
    kernel held against the plain version by the same bars; last the
    probe's objective gap to the float64 references (median, p90).
    Returns (launches, the long_H20N30 case of each kernel, every case by
    kernel)."""
    from kmpc_tpu_torch.ops import mv_cuda as V

    t0 = time.perf_counter()
    settings = mv_settings()
    data, probe = {}, {}
    for seed, (label, B, H, N, shared) in enumerate(MV_LONG_WIDE):
        data[label] = [torch.as_tensor(x, device="cuda") for x in mv_instance(
            B, H, N, 900 + seed, shared, scale=0.01)]
        probe[label] = mv_probe_instances(H, N)

    counters = kernel_counters()
    for k in counters.values():
        k.launches = 0
    solved = {}
    for label, B, H, N, shared in MV_LONG_WIDE:
        for body, p in settings.items():
            w, info = V.solve_mpc_mean_variance_packed(*data[label], p)
            w_probe, _ = V.solve_mpc_mean_variance_packed(
                *(torch.as_tensor(x) for x in probe[label]), p)
            solved[(label, body)] = (w, info, w_probe)
    torch.cuda.synchronize()
    launches = {name: k.launches for name, k in counters.items()
                if k.launches}
    per_kernel = 2 * len(MV_LONG_WIDE)
    assert launches == {"pdhg_mean_variance_block": per_kernel,
                        "pdhg_mean_variance_block_adaptive": per_kernel}, \
        launches
    for (label, body), (w, info, _) in solved.items():
        assert simplex_error(w) <= FEAS_TOL and bool((w >= 0).all()), \
            (label, body, simplex_error(w))
        assert bool(info["converged"].all()), (label, body)

    regs = {name: _ptxas_report(name)[0] for name in launches}
    rows, cases, first = [], {name: [] for name in launches}, {}
    for label, B, H, N, shared in MV_LONG_WIDE:
        cw, mu, sig = data[label]
        sym = (0.5 * (sig + sig.transpose(-1, -2))).contiguous()
        for body, p in settings.items():
            case = f"mv_long_wide_{label}_{body}"
            layout, kernel = V._mv_route(H, N, p)
            assert layout == "block", (case, layout)
            out_k = mv_kernel_twice(case, layout, cw, mu, sym, p)
            bp = min(B, PLAIN_TEMP_BYTES // (4 * H * N * N))
            sig_p = sym if shared else sym[:bp]
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out_p = V.pdhg_mean_variance_plain(cw[:bp], mu[:bp], sig_p, p,
                                               return_steps=p.adaptive)
            end.record()
            torch.cuda.synchronize()
            res = {"case": case, "kernel": kernel.name, "B": B, "H": H,
                   "N": N, "iters": p.max_iters, "shared_sigma": shared,
                   "sigma_staged": V.mv_sigma_staged(H, N),
                   "plain_batch": bp, "plain_ms": start.elapsed_time(end)}
            hold_mv(case, cw[:bp], mu[:bp], sig_p, p,
                    tuple(x[:bp] for x in out_k), out_p, res)
            res["kernel_ms"] = cuda_ms(lambda: V.pdhg_mean_variance_cuda(
                cw, mu, sym, p), 3, warmup=False)
            res["bound_ms"], res["bound_by"] = mv_bound(B, H, N, p, shared)
            res["bound_share"] = res["bound_ms"] / res["kernel_ms"]
            res["registers"] = regs[kernel.name]

            # The probe: the kernel held against the plain version on the
            # same instances by the same bars (``hold_mv``, per instance).
            pcw, pys, psig = (torch.as_tensor(x, device="cuda")
                              for x in probe[label])
            psym = (0.5 * (psig + psig.transpose(-1, -2))).contiguous()
            out_pk = V.pdhg_mean_variance_cuda(pcw, pys, psym, p,
                                               return_steps=p.adaptive)
            out_pp = V.pdhg_mean_variance_plain(pcw, pys, psym, p,
                                                return_steps=p.adaptive)
            torch.cuda.synchronize()
            held = {}
            hold_mv(case + "_probe", pcw, pys, psym, p, out_pk, out_pp, held)
            res["probe_vs_plain"] = {k: v for k, v in held.items() if k in (
                "max_abs_dw", "max_abs_dobj", "decisions_parted",
                "ended_apart", "unsettled_apart", "kernel_unsettled_apart",
                "plain_unsettled_apart", "unsettled")}
            w_pp, _ = V._finalize_mv(*out_pp[:2], pys, psym, pcw, p)
            res["probe_plain"] = mv_min_objective(w_pp.cpu().numpy(),
                                                  *probe[label][1:],
                                                  probe[label][0])
            rows.append(res)
            cases[kernel.name].append(res)
            if label == MV_LONG_WIDE[0][0]:
                first[kernel.name] = res

    refs = mv_references([(H, N) for _, _, H, N, _ in MV_LONG_WIDE])
    for res in rows:
        label, body = res["case"][len("mv_long_wide_"):].rsplit("_", 1)
        cw_np, ys, sig_np = probe[label]
        obj_k = mv_min_objective(solved[(label, body)][2].cpu().numpy(), ys,
                                 sig_np, cw_np)
        gap = obj_k - refs[(res["H"], res["N"])]
        d = float(np.max(np.abs(obj_k - res.pop("probe_plain"))))
        res.update({"reference": "f64_adaptive_pdhg_40000",
                    "probe_instances": len(gap),
                    "median_gap": float(np.median(gap)),
                    "p90_gap": float(np.quantile(gap, 0.9)),
                    "max_gap": float(np.max(gap)),
                    "max_kernel_vs_plain": d})
        assert np.all(np.isfinite(gap)), res
        emit("mv_long_wide", **res)
    emit("mv_long_wide_path", launches=launches,
         seconds=time.perf_counter() - t0)
    return launches, first, cases


# The bench's long and assets500 shapes: (label, B, H, N, parameters,
# median probe gap bar or None, time the plain version and hold it against
# the kernel on the probe).
LARGE = (
    ("long", 16384, 20, 30, dict(max_iters=1000, proj_refresh_every=16),
     None, True),
    ("long_accurate", 16384, 20, 30, dict(
        max_iters=4000, adaptive=True, adapt_every=2, precond=True), 1e-4,
     False),
    ("assets500", 4096, 5, 500, dict(
        max_iters=1000, proj_refresh_every=16, pipeline_reduces=True), None,
     True),
    ("assets500_10k", 4096, 5, 500, dict(
        max_iters=10000, proj_refresh_every=16, pipeline_reduces=True), 1e-3,
     False),
)


def phase_large_headlines():
    """The batched solve at bench.py's ``long`` shape (B=16384, H=20,
    N=30: 1000 iterations at refresh 16, and the accurate co-row, 4000
    adaptive) and ``assets500`` shape (B=4096, H=5, N=500: 1000 iterations
    pipelined, and the 10000-iteration co-row), all in the block layout:
    time, solves/s and bound, and the objective gap on bench.py's 16 probe
    instances of the shape (seed 1241) against the float64 references
    cached in bench_probe_cache.json (an adaptive PDHG run in float64, as
    the keys say); at 1000 iterations the kernel's probe objectives are
    held against the plain version's."""
    from kmpc_tpu_torch.ops import mpc_cuda as M
    from kmpc_tpu_torch.ops.mpc import MPCParams

    cache = json.loads((ROOT / "bench_probe_cache.json").read_text())
    for label, B, H, N, kw, bar, with_plain in LARGE:
        p = MPCParams(sigma_scale=2.0, feas_tol=2e-4, **kw)
        layout, body, kernel = M._route(None, H, N, p)
        assert layout == ("block" if N > 128 else "rows"), (label, layout)
        cw_np, ys_np = instance(B, H, N, 0)
        cw = torch.as_tensor(cw_np, device="cuda")
        r = torch.exp(torch.as_tensor(ys_np, device="cuda")).contiguous()
        reps = 3 if with_plain else 1
        kernel.launches = 0
        ms = cuda_ms(lambda: M.pdhg_log_utility_cuda(cw, r, p), reps)
        assert kernel.launches == reps + 1, (label, kernel.launches)
        bound_ms, bound_by = pdhg_bound(B, H, N, p)
        res = {"shape": label, "kernel": kernel.name, "body": body, "B": B,
               "H": H, "N": N, "iters": p.max_iters, "kernel_ms": ms,
               "solves_per_s": B / (ms / 1e3), "bound_ms": bound_ms,
               "bound_by": bound_by, "bound_share": bound_ms / ms}
        if with_plain:
            res["plain_ms"] = cuda_ms(lambda: M.pdhg_log_utility_plain(
                cw, r, p), 1)

        # The probe: bench.py's 16 instances of the shape.
        rng = np.random.default_rng(1241)
        pcw = rng.dirichlet(np.ones(N), size=16).astype(np.float32)
        pys = (rng.standard_normal((16, H, N)) * 0.01 + 0.0005).astype(
            np.float32)
        ref = np.asarray(cache[f"log_H{H}_N{N}_n16_seed1241_f64pdhg"])
        w_k, info = M.solve_mpc_log_utility_packed(
            torch.as_tensor(pcw), torch.as_tensor(pys), p, device="cuda")
        obj_k = probe_objective(w_k.cpu().numpy(), pys, pcw)
        gap = obj_k - ref
        res.update({"reference": "f64_adaptive_pdhg", "probe_instances": 16,
                    "median_gap": float(np.median(gap)),
                    "p90_gap": float(np.quantile(gap, 0.9)),
                    "max_gap": float(np.max(gap)), "median_gap_bar": bar,
                    "probe_converged": float(info["converged"].float()
                                             .mean().item())})
        assert np.all(np.isfinite(gap)), res
        if bar is not None:
            assert res["median_gap"] <= bar, res
        if with_plain:
            w_p, _ = _plain_solve(pcw, pys, p)
            d = float(np.max(np.abs(
                obj_k - probe_objective(w_p.cpu().numpy(), pys, pcw))))
            res["max_kernel_vs_plain"] = d
            assert d <= OBJ_TOL, res
        emit("large_headline", **res)


def ladder_ops(B, N, iters, variant) -> float:
    """FP32 operations of one ladder rung: per element and iteration 4 for
    ``carry``; else 2 N for Sigma w, 5 for the step, 7 for the clamp, the
    extrapolation and the clipped dual, and 5 for ``proj``'s sweep and
    threshold; once 2 N per element for the Frobenius norm."""
    per = {"carry": 4, "sigma": 2 * N + 12, "proj": 2 * N + 17}[variant]
    return float(B) * N * (iters * per + 2 * N)


def phase_mv_ladder():
    """The MV ladder's rungs through its entry point; returns the launch
    count and the ``proj`` rung's case for the kernels line."""
    from kmpc_tpu_torch.ops import mv_ladder as D

    B, N, iters = 4096, 30, 1000
    D.MV_LADDER.launches = 0
    rows = D.run_ladder(B, N, iters, reps=5)
    launches = D.MV_LADDER.launches
    assert len(rows) == len(D.RUNGS) and launches == 6 * len(D.RUNGS)
    assert all(np.isfinite(r["ms"]) and r["ms"] > 0 for r in rows)
    for r in rows:
        bytes_ms = 4.0 * B * (3 * N + N * N) / PEAK_HBM_BYTES * 1e3
        ops_ms = ladder_ops(B, N, iters, r["variant"]) / PEAK_FP32_FLOPS * 1e3
        r["bound_ms"] = max(bytes_ms, ops_ms)
        r["bound_by"] = "operations" if ops_ms >= bytes_ms else "bytes"
    emit("mv_ladder", B=B, N=N, iters=iters, launches=launches, rungs=rows)

    rung = next(r for r in rows if (r["variant"], r["unroll"], r["chains"],
                                    r["warps"]) == ("proj", 4, 1, 4))
    cw, mu, sig = (torch.as_tensor(x, device="cuda").contiguous()
                   for x in D.ladder_inputs(B, N))
    wk = D.mv_ladder_cuda(cw, mu, sig, "proj", iters)
    wp = D.mv_ladder_plain(cw, mu, sig, "proj", iters)
    dw = (wk - wp).abs().max().item()
    assert dw <= MV_W_TOL, f"mv_ladder at the ladder's shape: {dw}"
    plain_ms = cuda_ms(lambda: D.mv_ladder_plain(cw, mu, sig, "proj", iters),
                       1)
    return launches, {"max_abs_dw": dw, "kernel_ms": rung["ms"],
                      "plain_ms": plain_ms, "bound_ms": rung["bound_ms"],
                      "bound_by": rung["bound_by"]}


def phase_headline():
    """The batched solve at B=65536, H=5, N=30: the bench setting (fixed
    steps, refresh 16, 1000 iterations) and the accurate one (adaptive
    steps, 800 iterations)."""
    from kmpc_tpu_torch.ops import mpc_cuda as M
    from kmpc_tpu_torch.ops.mpc import MPCParams

    B, H, N = 65536, 5, 30
    common = dict(sigma_scale=2.0, feas_tol=2e-4, precond=True)
    cw_np, ys_np = instance(B, H, N, 0)
    cw = torch.as_tensor(cw_np, device="cuda")
    r = torch.exp(torch.as_tensor(ys_np, device="cuda")).contiguous()
    for phase, p in (
            ("headline", MPCParams(max_iters=1000, proj_refresh_every=16,
                                   **common)),
            ("accurate_headline", MPCParams(max_iters=800, adaptive=True,
                                            adapt_every=2, **common))):
        ms = cuda_ms(lambda: M.pdhg_log_utility_cuda(cw, r, p), 5)
        plain_ms = cuda_ms(lambda: M.pdhg_log_utility_plain(cw, r, p), 1)
        bound_ms, bound_by = pdhg_bound(B, H, N, p)
        emit(phase, B=B, H=H, N=N, iters=p.max_iters, adaptive=p.adaptive,
             kernel=M._route(None, H, N, p)[2].name, kernel_ms=ms, solves_per_s=B / (ms / 1e3), plain_ms=plain_ms,
             bound_ms=bound_ms, bound_by=bound_by,
             fp32_ops=pdhg_ops(B, H, N, p), bound_share=bound_ms / ms)


_LOG, _MV = "kmpc_tpu_torch/csrc/pdhg_log_utility", \
    "kmpc_tpu_torch/csrc/pdhg_mean_variance"
_PALLAS = "kmpc_tpu/ops/mpc_pallas.py"
KERNELS = {
    "pdhg_log_utility": (_LOG + ".cu", _PALLAS + ":226"),
    "pdhg_log_utility_scenarios": (_LOG + "_scenarios.cu", _PALLAS + ":226"),
    "pdhg_mean_variance": (_MV + ".cu", _PALLAS + ":1089"),
    "pdhg_log_utility_adaptive": (_LOG + "_adaptive.cu", _PALLAS + ":593"),
    "pdhg_log_utility_scenarios_adaptive": (
        _LOG + "_scenarios_adaptive.cu", _PALLAS + ":593"),
    "pdhg_mean_variance_adaptive": (_MV + "_adaptive.cu", _PALLAS + ":1196"),
    "mv_ladder": ("kmpc_tpu_torch/csrc/mv_ladder.cu",
                  "scripts/mv_ladder.py:55"),
    "pdhg_log_utility_pipe": (_LOG + "_pipe.cu", _PALLAS + ":496"),
    "pdhg_log_utility_scenarios_pipe": (_LOG + "_scenarios_pipe.cu",
                                        _PALLAS + ":496"),
    "pdhg_log_utility_block": (_LOG + "_block.cu", _PALLAS + ":226"),
    "pdhg_log_utility_scenarios_block": (_LOG + "_scenarios_block.cu",
                                         _PALLAS + ":226"),
    "pdhg_log_utility_block_adaptive": (_LOG + "_block_adaptive.cu",
                                        _PALLAS + ":593"),
    "pdhg_log_utility_scenarios_block_adaptive": (
        _LOG + "_scenarios_block_adaptive.cu", _PALLAS + ":593"),
    "pdhg_mean_variance_block": (_MV + "_block.cu", _PALLAS + ":1089"),
    "pdhg_mean_variance_block_adaptive": (_MV + "_block_adaptive.cu",
                                          _PALLAS + ":1196"),
    "pdhg_log_utility_rows": (_LOG + "_rows.cu", _PALLAS + ":226"),
    "pdhg_log_utility_rows_adaptive": (_LOG + "_rows_adaptive.cu",
                                       _PALLAS + ":593"),
    "pdhg_log_utility_scenarios_rows": (_LOG + "_scenarios_rows.cu",
                                        _PALLAS + ":226"),
    "pdhg_log_utility_scenarios_rows_adaptive": (
        _LOG + "_scenarios_rows_adaptive.cu", _PALLAS + ":593"),
}


def main():
    parser = argparse.ArgumentParser(description="kmpc_tpu_torch chip smoke")
    parser.add_argument("--seed", type=int, default=0,
                        help="seed of the main path's random weights")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        sys.exit(1)

    t0 = time.perf_counter()
    marks = {}

    def done(phase):
        marks[phase] = time.perf_counter() - t0
        emit("elapsed_s", **marks)

    phase_build()
    done("build")
    cases = phase_kernel_vs_plain()
    done("kernels")
    phase_layouts()
    mv_layouts()
    done("layouts")
    phase_nan_row()
    phase_probe()
    ctx = phase_main_path(args.seed)
    done("main_path")
    comparison_launches, path, fixed_values = phase_comparison(ctx)
    path[ctx["kernel"]] = ctx["first"]
    accurate_launches, accurate_first = phase_accurate_path(ctx, fixed_values)
    scan_launches = phase_scan_path(ctx)
    long_launches, long_first = phase_long_path(ctx)
    done("paths")
    warp_launches, warp_first, warp_extra = phase_warp_path(ctx)
    for name, extra in warp_extra.items():
        cases[name] += extra
    block_launches, block_first = phase_block_path()
    done("warp_block_paths")
    mv_launches, mv_first, mv_cases = phase_mv_long_wide()
    for name, rows in mv_cases.items():
        cases[name] += [c for c in rows if c is not mv_first[name]]
    ladder_launches, ladder_case = phase_mv_ladder()
    done("mv")
    phase_headline()
    phase_large_headlines()
    done("headlines")

    # One entry per kernel: launches on the path that runs it (the
    # comparison path for the fixed-step kernels, A and B in the row
    # layout, the accurate path for the adaptive ones, the long path for the
    # row layout's pipelined body, ``warp_path`` for the warp layout's
    # kernels, ``block_path`` for the block layout's, ``mv_long_wide`` for
    # C's block kernels (its long_H20N30 case for the times), the ladder's
    # entry point for the ladder; each counted from 0
    # over that path alone), the largest kernel-vs-plain weight difference
    # over every problem of all of its cases (for an adaptive kernel the
    # problems that ended apart included, with their count, the count of
    # parted step histories and the largest objective difference beside
    # it), and its times and bound at the shape the path gives it.
    launches = {}
    for phase_launches, phase_first in (
            (comparison_launches, {}), (accurate_launches, accurate_first),
            (long_launches, long_first), (warp_launches, warp_first),
            (block_launches, block_first), (mv_launches, mv_first),
            ({"mv_ladder": ladder_launches}, {"mv_ladder": ladder_case})):
        for name, n in phase_launches.items():
            if n:
                launches.setdefault(name, n)
        for name, res in phase_first.items():
            path.setdefault(name, res)
    kernels = []
    for name, (source, replaces) in KERNELS.items():
        assert launches.get(name, 0) > 0, f"{name} was never launched"
        at_path = path[name]
        every = cases[name] + [at_path]
        entry = {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "cases": len(every),
            "max_abs_err": max(c["max_abs_dw"] for c in every),
            "ms": at_path["kernel_ms"],
            "plain_ms": at_path["plain_ms"], "bound_ms": at_path["bound_ms"],
            "bound_by": at_path["bound_by"], "library_ms": None,
        }
        if name.endswith("_adaptive"):
            entry.update({
                "problems": sum(c.get("plain_batch", c["B"])
                                for c in every),
                "ended_apart": sum(c["ended_apart"] for c in every),
                "decisions_parted": sum(c["decisions_parted"] for c in every),
                "max_abs_err_held": max(c["max_abs_dw_held"] for c in every),
                "max_abs_dobj_all": max(c["max_abs_dobj"] for c in every),
                **{k: sum(c.get(k, 0) for c in every) for k in (
                    "held_by_float64_referee",
                    "float64_parted_at_equal_histories",
                    "kernel_apart_from_float64",
                    "plain_apart_from_float64", "unsettled_apart",
                    "kernel_unsettled_apart", "plain_unsettled_apart")}})
        if "block" in name or "rows" in name:
            entry["deterministic_cases"] = sum(
                1 for c in every if c.get("deterministic"))
        if "rows" in name:
            entry["bits_equal_warp_cases"] = [
                sum(1 for c in every if c.get("bits_equal_warp")),
                sum(1 for c in every if "bits_equal_warp" in c)]
        kernels.append(entry)
    assert scan_launches == {"pdhg_log_utility_rows_adaptive":
                             ctx["n_dates"]}, scan_launches
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
