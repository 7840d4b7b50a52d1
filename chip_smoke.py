#!/usr/bin/env python3
"""Drive kmpc_tpu_torch on one CUDA card and check it end to end.

    python3 chip_smoke.py [--seed 0]

Phases (each prints JSON lines; any failure raises and exits non-zero):

1. ``build``: the card, torch and CUDA versions, the build of the
   twenty-seven kernel sources (one nvcc per source, started together, from
   the sources in this checkout) with each build's seconds, registers and
   spills (every instantiation but the ladder's), the wrappers' copies
   of the block, tile, lane, ladder, row and wide-row layouts' plans (the
   tile layout's problems a CTA, the row and wide-row layouts' scenario
   storages and rings) against the built kernels', and the one-forecast
   wide-row kernels' bits against WIDE_DIGESTS;
2. ``kernels``: every CUDA kernel against its plain PyTorch version on the
   card (untimed here and in ``layouts``: the plain versions replay their
   loop as CUDA graphs, ``mpc_cuda.plain_replayed``): the log-utility
   kernel over the parametrised cases of the CPU
   tests (each shape at two of the four refresh and precond pairs, each
   pair at three shapes), the edges of its register budget and the
   main-path and bench shapes; the same kernel with warm inputs and the
   dual output; the scenario kernel; the mean-variance kernel with a
   per-problem and a shared covariance; the adaptive body of all three
   (``adapt_every`` 1 and 2, ``precond`` off and on, each pair at one
   shape; ridge, over-relaxation, no ball, cold projections, warm inputs,
   an odd iteration count, the budget's edges at one, three and four
   slots);
   the pipelined body of kernels A and B in the warp and the block layout
   (refresh 8 and 16, an odd iteration count, ball on and off, precond,
   ridge, warm inputs and the dual output); the block layout's fixed-step
   and adaptive bodies at H=20 N=30, H=5 N=500, H=3 N=150, N=129, H=17,
   N=600 (several columns a thread) and S=16 H=20 N=20; kernel C's block
   layout (C.2) at the edges of kmpc_tpu's envelope (per-problem
   covariances at H=17, H=340, N=65, N=112, H=16 N=88; a shared one at
   N=129, N=1112, N=480 at H=5, N=128 at H=20; adaptive at N=976 shared
   and H=20 N=64; over-relaxation, cold projections) through its route
   (the tile layout, the block layout at H > 32) with the block kernel
   beside it; the tile layout at its plan's edges
   (P > 1 with a ragged last CTA, B=1, N off the multiples of 4 and 32,
   Sigma resident and streamed, shared and per problem, up to 32 warps,
   every body and option); every block and tile case run twice and
   required to give the same bits; kernel C at one horizon row in the lane
   layout (Sigma's rows in registers, w broadcast through shared memory,
   the sweeps in every lane or by the butterfly), every H=1 case through
   its route, and the lane layout at its plan's edges (N = 1, 20, 30, 31,
   32, 33, 64, 128; shared and per problem; B=1 and ragged last CTAs;
   every body and option) in each sweep compiled for N (both up to 32
   assets, the butterfly past), each run twice for the same bits; the
   row layout (one warp
   per horizon row) beside the warp and block layouts at every case
   whose shape it takes, run twice for the same bits and compared bit for
   bit with the warp kernel, and at cases of its own (H in {1, 5, 8, 17,
   20, 32}, one to four slots, scenario returns past its registers, warm
   inputs and the dual output); the wide-row layout (one forecast past
   four slots, one warp per horizon row, the row in shared memory) with
   the block layout beside it, every body and option (refresh 8 and 16,
   pipelined, adaptive at ``adapt_every`` 1 and 2, precond off and on,
   ridge, over-relaxation, no ball, cold projections of 12 and 16 sweeps,
   warm inputs with the dual output) and the edges of its envelope (N=129,
   32 rows, H=20 N=384, H=5 N=1600, one row of 2730), run twice for the
   same bits, with its largest weight difference from the block kernel,
   and its adaptive body past 1000 assets (H=3 N=1000, H=4 N=1600) held
   by its spread against the float64 run (``hold_spread``); kernel B past
   its registers in the row and wide-row layouts, every case in every
   storage of the returns that takes its shape (registers, resident,
   streamed: the same bits required of all) beside the warp or block
   layout, every body and option;
   every rung of the MV ladder (Sigma's rows in registers and in shared
   memory; ``proj`` in both sweeps up to 32 assets); then ``layouts``:
   every layout of kernels
   A and B that takes the shape, timed at the exact scan's (B=1) and the
   comparison's (B=1028) batch at H=5, at H=1, and at the long path's
   H=20 (B=1013, S=16 too), the wide-row layout against the block layout
   at N=150 and N=500
   (B = 1, 1028, 4096) and on each side of the switch where routing
   leaves it for the block layout, kernel B's storages on each side of
   their switch and against the block and warp layouts at the shapes
   those took before (SCEN_LAYOUT_SHAPES), the layouts' outputs held to one
   another (``hold_layouts``), the routed layout required to be the
   fastest or, where ROUTED_SLOWER names the shape and body, within its
   bound (the shapes where it won by 1.5x or more held, not timed:
   UNTIMED_LAYOUT_SHAPES); and of kernel C (the lane layout in each sweep compiled for N,
   warp, tile and block layouts) at the Markowitz path's shape (H=1, N=20) at B=1028 and
   B=1, bench.py's H=1, N=30 at B=4096 and 65536 (the sweep's switch; the
   lane layout's two sweeps alone at 65536), at
   H=5, N=30 at B=1028 and B=1, and at
   the five ``mv_long_wide`` shapes at 200 iterations, the routed layout
   required to be the fastest;
3. ``nan_row``, ``probe``, ``probe_accurate``: a NaN forecast holds the
   weights; accuracy on the 64 bench probe instances against the float64
   oracle objectives in bench_probe_cache.json, at the bench setting and
   at the accurate one (adaptive steps, 800 iterations);
4. ``main_path``: finance_sparse at full width (observation 400, latent
   1024) with seeded random weights on the synthetic panel, the H=5
   forecast for every test date, and the Jacobi backtest, 2 sweeps of the
   fused solve (the row kernel), for Koopman-MPC and buy-and-hold; the
   kernel's launch count must equal the number of sweeps; then
   ``train_path``: training at full width through ``python -m
   kmpc_tpu_torch.train``'s config function: ``finance_sparse`` (batch 64,
   the sequence loss at L=10, 25 steps a dispatch) and ``lista`` (2048
   codes, 10 loops) on duffing, each first held for 3 steps against the
   port on the CPU from the same weights and batches (step 1's six
   metrics within 1e-5 relative, its gradients within 1e-4 per tensor,
   each step's loss within 1e-4), then trained (1000 and 101 steps; the
   steps of a chunk under ``torch.cuda`` sync debugging at "error", so
   none may synchronise the host), every logged loss finite, the last
   checkpoint read back through ``load_jax_checkpoint`` with bit-equal
   forecasts, and one Jacobi sweep of Koopman-MPC from the finance run's
   checkpoint through kernel A's row layout; ``generic`` for 6 steps; ms
   a step (CUDA events over whole chunks) and the host's time to enqueue
   it, steps/s and the host's share (K's spectrum at every log,
   evaluations, checkpoint writes), and the card's busy share over a
   window of steps under ``torch.profiler``; then ``eval_path``
   (``phase_eval_path``): ``finance_sparse`` in bfloat16 (step 1 against
   the CPU, 100 steps beside float32's), the latent ODE against float64
   ``expm``, the evaluation suite after ``train_system(final_eval=True)``
   on duffing and lyapunov against the CPU, the sparsity sweep's members
   against single runs, a reference ``.pt`` checkpoint served by
   ``run_experiment --torch_ckpt`` (kernels A and C) and resumed, and
   ``examples/full_pipeline.py`` (kernels A, B and C), its launches joining
   the ``kernels`` line's entries as ``eval_path_launches``; then
   ``parallel_path`` (``phase_parallel_path``): a world of
   ``torch.cuda.device_count()`` ranks (at most four), one a card over
   NCCL, each a process of this script (``--parallel-rank``) calling the
   mesh code at full width (the headline solve through A, B at S=16, C at
   bench.py's markowitz shape with a per-problem and a shared covariance,
   the main path's date-sharded Koopman-MPC backtest cold and warm, 3
   data- and tensor-parallel train steps of finance_sparse), each held
   against the same call in one process on the card (the same bits where
   layout and sweep are the same), the ranks' launches summed into the
   ``kernels`` line as ``parallel_path_launches``;
5. ``comparison``: the full strategy comparison on the same data:
   buy-and-hold, Markowitz, DMD, Koopman-MPC and scenario Kelly (S=16), 3
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
   ``PRECOND``, 800 iterations), 2 sweeps: every solve through an adaptive
   kernel, launches counted per kernel, every weight row feasible, the
   first sweep's solves held against the plain versions;
7. ``scan_path``: the exact backtest, one solve of one problem per date,
   at the accurate configuration: buy-and-hold and Koopman-MPC over all
   dates (as many launches as dates), Markowitz, DMD and scenario Kelly on
   a test split cut to 64 dates; on the cut split the Jacobi backtest with
   as many sweeps as dates must give the scan's portfolio values;
8. ``long_path``: the comparison at H=20 with the pipeline configuration
   (``PROJ_REFRESH_EVERY=16``, ``PIPELINE_REDUCES``, ``PRECOND``), 2
   sweeps: DMD and Koopman-MPC through kernel A's row layout, scenario
   Kelly through kernel B's, Markowitz through C; then Koopman-MPC and
   scenario Kelly at the accurate configuration at H=20 and with the
   pipeline configuration at H=5, 2 sweeps each; launches per kernel,
   feasibility and the first solves against the plain versions as in
   ``accurate_path``; then ``warp_path``: the warp layout's six kernels at
   the three configurations (no shape routes to them), kernel A's launched
   in that layout on the comparison's first-sweep problems, kernel B's at
   B=132, S=113, H=8, N=64 beside the row kernels the packed entry point
   routes that shape to (the returns streamed), and ``block_path``: a
   shape past the row layout (B=1028, H=5, N=150), one forecast and S=16
   through their packed entry points to the wide-row layout's kernels (the
   scenario returns resident) and the same problems launched in the block
   layout, each launch counted and each held against its plain version;
   then ``scenarios_path``: scenario Kelly alone as ``run_experiment
   --scenarios 512`` builds it (H=5, the comparison's fixed steps) and at
   ``--horizon 20 --scenarios 128`` with the pipeline configuration, 2
   sweeps each at full width through the row layout's scenario kernel
   (S=512 streamed, S=128 resident), launches counted by kernel and
   storage, every weight row feasible, the first sweep's solves held
   against the plain version on the first 256 dates, solve and recursion
   ms a sweep;
9. ``mv_long_wide``: the mean-variance solve past the warp layout at
   bench.py's Markowitz settings (1000 iterations at refresh 16, and 1000
   adaptive) on bench.py's problems: per-problem covariances at B=4096,
   H=20 N=30 and H=5 N=100, one shared covariance at B=1028, H=1 N=960,
   H=5 N=320, H=20 N=64; through the entry point to the tile layout, the
   block layout's kernels beside it (launched privately), launches
   counted, every row feasible, both layouts against their plain version
   (twice for the same bits), times (the tile layout required to be the
   faster), bounds, registers, the L2 bytes of Sigma, and the objective
   gap on the shape's 16 probe instances to a float64 adaptive-PDHG run of
   40000 iterations of the port's eager solver on the card;
10. ``mv_ladder``: the rungs of the MV ladder at B=4096, N=30, 1000
   iterations and at the Markowitz path's B=1028, N=20, 2000; then
   ``markowitz_headline``: bench.py's ``--mode markowitz`` shape (B=65536,
   H=1, N=30, a covariance per problem; 1000 iterations at refresh 16, and
   the adaptive co-row) through the entry point to the lane layout, the
   warp layout's kernels beside it (launched privately, counted), solves/s,
   bound, every problem of both bodies held against the plain version (the
   adaptive one by its tie rules), the 16 probe instances held per
   instance in the headline's sweep and their objective gap to the float64
   references in bench_probe_cache.json;
11. ``headline``, ``accurate_headline``: the solve at B=65536, H=5, N=30,
   at the bench setting (1000 iterations) and at the accurate one (800);
   ``large_headline``: bench.py's ``long`` shape (B=16384, H=20, N=30, 1000
   iterations, and 4000 adaptive; the row layout) and ``assets500`` shape
   (B=4096, H=5, N=500, 1000 pipelined iterations, and 10000; the wide-row
   layout), with the gap on the shape's 16 probe instances to the float64
   references cached in bench_probe_cache.json;
12. ``verify_path``: the verification stack. The float64 polished path
   (``ops/mpc_polish.py``, its batched float64 stages on the card) on the
   first 32 cached instances of each family of parity_cache/, every
   certified record reproduced (certified, weights within 1e-7), the same
   path on the host CPU after it (the same certified set, weights within
   1e-7), the native host solver against
   kernel A, the scipy oracle against its records, and the stage times;
   then the one-forecast wide-row kernels' bits against WIDE_DIGESTS again;
13. the ``kernels`` line, the card's name and power limit, and last
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
not above it, and unsettled on no more problems than the plain version;
where the float64 adaptive run does not settle either, the float64 run
with fixed steps, which does, is the referee); the others keep the bars
above. That the partings are ties is shown by
``python -m kmpc_tpu_torch.ops.adaptive_parting``, which traces the
problems that end apart to their first differing decision; it is no part
of this script.

Exits non-zero, printing no result, when CUDA is unavailable.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
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
# run instead (``hold_unsettled_mv``). The float64 adaptive run can fail to
# settle too (one problem of the N=960 batch: residual 2.9e-3 at 1000, 4000
# and 20000 iterations); there the float64 run with fixed steps and the
# full warm budget, which settles within MV_REFEREE_ITERS iterations
# (residual 2e-19 at 4000 on that problem), is the referee.
MV_UNSETTLED_FP = 1e-4
MV_REFEREE_ITERS = 4000
# The adaptive log-utility body past the row layout (``block_path``, B=1028
# at N=150, 800 iterations; the wide-row layout's cold-started cases of the
# ``kernels`` phase; ``wide`` cases) is at float32's limit as at N=500
# (REFEREE_FACTOR): a few problems leave both float32 runs unsettled
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
# other case keeps its bars. At N=500 and 400 iterations (5 to 16 problems
# a seed, an H100) the float32 plain version itself took another step
# history than the float64 run on 1 of 5 problems of one seed (3.2e-3 from
# it in objective, fixed-point residual 1.1e-3, where the wide kernel kept
# the float64 run's history and lay within 2.4e-5 of it), and on 1 of 16 of
# another; the block kernel or the wide kernel did so on others (PERF.md
# section 6).
LOG_UNSETTLED_FP = 1e-4
# Past SPREAD_N assets the adaptive body has not settled after 800
# iterations at one to four rows (fixed-point residual 3e-4 at H=3 N=1000,
# 2.6e-3 at H=4 N=1600, in float64 as in float32), and float32 runs part at
# balancing ties on a third to all of the problems: the plain version as
# given and with its assets permuted, the wide and the block kernels each
# lie 1.6-1.7e-2 (median) from the float64 run in weights at H=4 N=1600,
# above it in objective on half the problems (PERF.md section 6).
# The float64 run is then one more trajectory, no referee: the bars of
# ``hold_to_plain`` refuse the block kernel there as they do the wide one
# (at 60 to 800 iterations). Such a case is held by its spread
# (``hold_spread``): at each of SPREAD_QUANTILES over the problems the
# kernel's weight distance to the float64 run at most REFEREE_FACTOR times
# the larger of the two plain runs' plus the bar, and with SPREAD_MIN_B
# problems or more its objectives unbiased against the plain version's
# (mean within SPREAD_SE standard errors).
SPREAD_N = 1000
SPREAD_QUANTILES = (0.5, 0.9)
SPREAD_SE = 4.0
SPREAD_MIN_B = 16
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
# shared-shape cases parted there (11 of 113 before 30 repeated cases were cut).
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


T0 = time.perf_counter()   # the run's start: every line's "t"


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields,
                      "t": round(time.perf_counter() - T0, 1)}), flush=True)


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


def timed_once(fn):
    """(fn(), its milliseconds by CUDA events): one run that both gives its
    output and is timed, as a plain version's run that a hold compares
    with (a Python loop of launches, so its first run is its time)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


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


def mv_instance_cuda(B, H, N, seed, scale=0.01):
    """``mv_instance``'s distribution (a covariance per problem) made on the
    card from a seeded torch generator, for batches where numpy's float64
    product takes seconds: current weights Dirichlet(1) (normalised
    exponentials), mu ~ 0.01 N(0, 1), Sigma = A A' + 1e-4 I with
    A ~ scale N(0, 1); float32, the product in full float32."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    e = torch.empty((B, N), device="cuda").exponential_(generator=g)
    cw = e / e.sum(-1, keepdim=True)
    mu = torch.randn((B, H, N), generator=g, device="cuda") * 0.01
    A = torch.randn((B, N, N), generator=g, device="cuda") * scale
    sig = A @ A.transpose(-1, -2) + 1e-4 * torch.eye(N, device="cuda")
    return cw, mu, sig


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
                 dual=False, time_reps=3, time_plain=True, layouts=None,
                 wide=False, spread=False):
    """A log-utility kernel and the plain version on the same card inputs,
    through the same finalisation; returns the case's JSON fields by
    layout (``compare_layouts``). With S the scenario kernel. ``dual``
    also compares the loop's last dual. ``warm`` compares a continuation of
    a quarter of the budget from the iterates of a cold plain solve (and
    its dual output). ``wide`` holds an adaptive case as ``hold_to_plain``
    says, ``spread`` as ``hold_spread`` says."""
    if S is None:
        cw_np, ys_np = instance(B, H, N, seed)
    else:
        cw_np, ys_np = scenario_instance(B, S, H, N, seed)
    cw = torch.as_tensor(cw_np, device="cuda")
    r = torch.exp(torch.as_tensor(ys_np, device="cuda")).contiguous()
    return compare_layouts(label, cw, r, params, warm, dual, time_reps,
                           time_plain, layouts, wide, spread)


def compare_tensors(label, cw, r, params, warm=False, dual=False,
                    time_reps=3, time_plain=True, wide=False):
    """``compare_layouts`` for the layout the wrapper routes the shape to;
    returns that layout's case."""
    from kmpc_tpu_torch.ops import mpc_cuda as M

    S = r.shape[1] if r.dim() == 4 else None
    layout = M.kernel_layout(S, r.shape[-2], r.shape[-1])
    return compare_layouts(label, cw, r, params, warm, dual, time_reps,
                           time_plain, [layout], wide)[layout]


def split_layout(layout):
    """(layout, storage or None) of a layout name, or of ``layout:storage``
    (the row or wide-row layout with the scenario returns in a storage
    other than the one routing gives the shape)."""
    name, _, storage = layout.partition(":")
    return name, storage or None


def pinned_kernel(layout, r, params):
    """The kernel of ``layout`` (or ``layout:storage``) for a solve of gross
    returns ``r`` [B, H, N] or [B, S, H, N] with these parameters' body;
    ``ValueError`` where the layout, or the storage, does not take the
    shape."""
    from kmpc_tpu_torch.ops import mpc_cuda as M

    S = r.shape[1] if r.dim() == 4 else None
    H, N = r.shape[-2], r.shape[-1]
    name, storage = split_layout(layout)
    if name not in M.LAYOUTS:
        raise ValueError(f"layout must be one of {M.LAYOUTS}, got {layout!r}")
    if not M.layout_supports(name, S, H, N) or (
            storage and not M.storage_supports(name, storage, S, H, N)):
        raise ValueError(
            f"the {layout} layout does not take S={S}, H={H}, N={N}")
    return M._KERNELS[(S is not None, name, M._body(params))]


def pinned(layout, cw, r, params, w_warm=None, p_warm=None,
           return_dual=False, return_steps=False):
    """``pdhg_log_utility_cuda`` in ``layout`` (which must take the shape;
    ``layout:storage`` also names where the scenario returns live) instead
    of the one routing gives: that layout's kernel for the parameters'
    body, launched and counted as the entry point launches it. For the
    phases that compare layouts and storages, and for ``warp_path``, which
    drives the warp layout's kernels A and B at the paths' shapes, where
    routing takes the row layout."""
    from kmpc_tpu_torch.ops import mpc_cuda as M

    kernel = pinned_kernel(layout, r, params)
    warm = {k: v for k, v in (("w_warm", w_warm), ("p_warm", p_warm))
            if v is not None}
    M._require_cuda_f32(current_weights=cw, r=r, **warm)
    return M._launch(kernel, M._body(params), cw, r, params, w_warm, p_warm,
                     return_dual, return_steps,
                     storage=split_layout(layout)[1])


def compare_layouts(label, cw, r, params, warm=False, dual=False,
                    time_reps=3, time_plain=True, layouts=None,
                    wide=False, spread=False):
    """Each of ``layouts`` (default: the one the wrapper routes to) on given
    card tensors, launched in that layout (``pinned``), against one
    run of the plain version: current weights [B, N] and gross returns
    [B, H, N] or [B, S, H, N]. With ``params.adaptive`` the bars are
    applied as ``adaptive_agreement`` says, or with ``spread`` (a cold
    case past SPREAD_N assets) as ``hold_spread`` says. A row, wide or
    block kernel runs twice and must give the same bits (its rows or its
    reduces meet in shared memory: a missing barrier shows as a run-to-run
    difference).
    Where the warp and the row layout both run, the row kernel's outputs
    (weights, fixed-point residual, dual, steps) must equal the warp
    kernel's bit for bit (``bits_equal_warp``, checked by ``check_bits``)
    unless ``rows_bits_part`` names the first operation at which the two
    may part; those cases are held to the bars alone. Where the wide and
    the block layout both run, the wide case reports the largest weight
    difference between the two (``max_abs_dw_block``). Where one layout
    runs in several storages of the scenario returns (``layout:storage``),
    every storage must give the first one's bits (``bits_equal_storage``).
    Returns {layout: case}."""
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
    out_p, plain_ms = timed_once(lambda: M.pdhg_log_utility_plain(
        cw, r, params, return_dual=dual, return_steps=steps, **kw))
    plain_ms = plain_ms if time_plain else None
    bound = pdhg_bound(B, H, N, params, S, warm, dual)
    results, outs, refs = {}, {}, None
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
        if spread:
            refs = refs or spread_refs(cw, r, params, out_p)
            hold_spread(label, cw, r, params, out_k, out_p, refs, res)
        else:
            hold_to_plain(label, cw, r, params, kw, out_k, out_p, res, wide)
        res["bound_ms"], res["bound_by"] = bound
        if S is not None:
            res["S"] = S
        if time_reps:
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
    if "wide" in outs and "block" in outs:
        # Other summation orders, so other bits: each layout meets the
        # bars against the plain version; how far apart the two are.
        results["wide"]["max_abs_dw_block"] = (
            outs["wide"][0] - outs["block"][0]).abs().max().item()
    for layout in outs:
        first = next(lay for lay in outs
                     if split_layout(lay)[0] == split_layout(layout)[0])
        if first != layout:
            same = [torch.equal(x, y)
                    for x, y in zip(outs[first], outs[layout])]
            assert all(same), \
                f"{label}: the {layout} storage's bits differ from " \
                f"{first}'s (weights, fp, dual, steps equal: {same})"
            results[layout]["bits_equal_storage"] = first
    return results


def storage_of(layout, S, H, N):
    """Where a case of ``layout`` (or ``layout:storage``) kept the scenario
    returns: the storage it names, else the one routing gives the row or
    wide-row layout; None for one forecast and the other layouts."""
    from kmpc_tpu_torch.ops import mpc_cuda as M

    name, storage = split_layout(layout)
    if S is None or name not in ("rows", "wide"):
        return None
    return storage or (M.rows_storage if name == "rows"
                       else M.wide_storage)(S, H, N)


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
                    scale=0.05, time_reps=3, time_plain=True, layout=None,
                    problems=None, sweep=None):
    """The mean-variance kernel and its plain version on the same card
    inputs, through the same finalisation."""
    cw_np, mu_np, sig_np = mv_instance(B, H, N, seed, shared, scale)
    cw = torch.as_tensor(cw_np, device="cuda")
    mu = torch.as_tensor(mu_np, device="cuda")
    sig = torch.as_tensor(sig_np, device="cuda")
    return compare_mv_tensors(label, cw, mu, sig, params, time_reps,
                              time_plain, layout, problems, sweep)


def compare_mv_tensors(label, cw, mu, sig, params, time_reps=3,
                       time_plain=True, layout=None, problems=None,
                       sweep=None):
    """``compare_mv_case`` on given card tensors: current weights [B, N],
    mu [B, H, N] and a covariance [B, N, N] or [N, N]. The kernel routing
    gives the shape, through the entry point; or, with ``layout``, that
    layout's kernel launched privately (``_mv_launch``: a layout routing
    does not give this shape, a tile plan's edge with ``problems``
    problems a CTA, or the lane layout with the sweep ``sweep``). A block-,
    tile- or lane-layout kernel runs twice and must give the same bits."""
    from kmpc_tpu_torch.ops import mv_cuda as V

    B, H, N = mu.shape
    shared = sig.dim() == 2
    sig = (0.5 * (sig + sig.transpose(-1, -2))).contiguous()
    steps = params.adaptive
    routed, kernel = V._mv_route(H, N, params, shared, B)
    if layout is None:
        layout = routed

        def run(ret=steps):
            return V.pdhg_mean_variance_cuda(cw, mu, sig, params,
                                             return_steps=ret)
    else:
        kernel = V._MV_KERNELS[(layout, params.adaptive)]

        def run(ret=steps):
            return V._mv_launch(kernel, cw, mu, sig, params,
                                return_steps=ret, problems=problems,
                                sweep=sweep)
    out_k = mv_kernel_twice(label, layout, run)
    out_p, plain_ms = timed_once(lambda: V.pdhg_mean_variance_plain(
        cw, mu, sig, params, return_steps=steps))
    res = {"case": label, "kernel": kernel.name, "B": B, "H": H, "N": N,
           "iters": params.max_iters, "shared_sigma": shared}
    if layout != routed:
        res["pinned"] = True
    if layout == "tile":
        res["problems_per_cta"] = problems or V.mv_tile_problems(
            B, H, N, shared, params.adaptive)
    if layout == "lanes":
        res["sweep"] = sweep or V.mv_lanes_sweep(B, N)
    hold_mv(label, cw, mu, sig, params, out_k, out_p, res)
    res["bound_ms"], res["bound_by"] = mv_bound(B, H, N, params, shared)
    if time_reps:
        res["kernel_ms"] = cuda_ms(lambda: run(False), time_reps)
    if time_plain:
        res["plain_ms"] = plain_ms
    return res


def mv_kernel_twice(label, layout, run):
    """The mean-variance kernel's outputs, ``run()``; a block-, tile- or
    lane-layout kernel runs a second time and must give the same bits (they
    stage sums, the rows' exchanges or the broadcast vectors in shared
    memory: a missing barrier shows as a run-to-run difference)."""
    out = run()
    if layout in ("block", "tile", "lanes"):
        again = run()
        torch.cuda.synchronize()
        assert all(torch.equal(x, y) for x, y in zip(out, again)), \
            f"{label}: two runs of the {layout} kernel differ"
    return out


def hold_mv(label, cw, mu, sig, params, out_k, out_p, res):
    """The bars of a mean-variance case: the kernel's outputs ``out_k``
    against the plain version's ``out_p`` on current weights ``cw``, mu and
    the symmetrised covariance ``sig``, through the same finalisation;
    adaptive cases as ``adaptive_agreement`` says (without a referee), the
    problems that one side left unsettled as ``hold_unsettled_mv`` says.
    Fills ``res`` (``deterministic`` where the kernel is a block- or
    tile-layout one, which ``mv_kernel_twice`` has run twice); raises
    ``AssertionError`` at the first bar missed."""
    from kmpc_tpu_torch.ops import mv_cuda as V

    (wk, fpk), (wp, fpp) = out_k[:2], out_p[:2]
    wk_f, ik = V._finalize_mv(wk, fpk, mu, sig, cw, params)
    wp_f, ip = V._finalize_mv(wp, fpp, mu, sig, cw, params)
    dw_all = (wk_f - wp_f).abs().amax(dim=(1, 2))
    dobj_all = ik["objective"] - ip["objective"]
    if any(x in res.get("kernel", "") for x in ("block", "tile", "lanes")):
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
    the case's batch, as ``hold_to_plain``'s referee runs it (run alone, a
    problem at a balancing tie took the other branch in float64 too, 3.2e-3
    below the batch's run in objective, where the wide kernel lay within
    2.4e-5 of the batch's run: PERF.md section 6). A side that
    settled there (fixed-point residual at most
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
    cw64, r64 = cw.double(), r.double()
    out64 = M.pdhg_log_utility_plain(cw64, r64, params)
    obj64 = M._finalize_packed(out64[0], r64, cw64, params,
                               out64[1])[1]["objective"][idx]
    fp64 = out64[1][idx]
    ok, uk = obj_k[idx].double() - obj64, fpk[idx] > unsettled_fp
    op, up = obj_p[idx].double() - obj64, fpp[idx] > unsettled_fp
    n_k, n_p = int(uk.sum().item()), int(up.sum().item())
    res.update({"kernel_unsettled_apart": n_k, "plain_unsettled_apart": n_p,
                "unsettled": [
                    {"fp_kernel": fpk[i].item(), "fp_plain": fpp[i].item(),
                     "fp_float64": fp64[j].item(),
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


def spread_refs(cw, r, params, out_p):
    """The runs a SPREAD_N case is held against: the plain version in
    float64 on the case's inputs, and ``distances(out)``, for a run's
    outputs (weights, fixed-point residual) after the same finalisation its
    per-problem weight distance to the float64 run (largest over rows and
    assets), its objective minus the float64 run's and its finalised
    weights; with those of the plain version as given (``out_p``) and with
    its assets permuted (another float32 summation order), in as many
    permutations as give SPREAD_MIN_B problems (one problem's two runs are
    no sample of a float32 run's spread), pooled."""
    from kmpc_tpu_torch.ops import mpc_cuda as M

    cw64, r64 = cw.double(), r.double()
    out64 = M.pdhg_log_utility_plain(cw64, r64, params)
    w64, i64 = M._finalize_packed(out64[0], r64, cw64, params, out64[1])

    def distances(out):
        w, info = M._finalize_packed(out[0], r, cw, params, out[1])
        return ((w.double() - w64).abs().amax(dim=(1, 2)),
                info["objective"].double() - i64["objective"], w)

    # The permuted copies of the batch in one plain run (the problems are
    # independent): one launch sequence, not one a permutation.
    B = r.shape[0]
    perms = [torch.randperm(r.shape[-1], generator=torch.Generator()
                            .manual_seed(seed)).to(r.device)
             for seed in range(-(-SPREAD_MIN_B // B))]
    o = M.pdhg_log_utility_plain(
        torch.cat([cw[:, perm] for perm in perms]).contiguous(),
        torch.cat([r[..., perm] for perm in perms]).contiguous(), params)
    permuted = [distances((o[0][i * B:(i + 1) * B][..., torch.argsort(perm)],
                           o[1][i * B:(i + 1) * B]))
                for i, perm in enumerate(perms)]
    return {"distances": distances, "plain": distances(out_p),
            "permuted": tuple(torch.cat(x) for x in zip(*permuted))}


def hold_spread(label, cw, r, params, out_k, out_p, refs, res):
    """The bars of a SPREAD_N case (see SPREAD_N), on any device: the
    kernel's outputs ``out_k`` against the float64 run as the float32 plain
    runs of ``refs`` (``spread_refs``) lie from it. At each of
    SPREAD_QUANTILES over the problems, its weight distance at most
    REFEREE_FACTOR times the larger of the plain runs' plus W_TOL; with
    SPREAD_MIN_B problems or more, the mean of its objective minus the
    plain version's within SPREAD_SE standard errors of 0 (plus
    FLIP_MEAN_OBJ_TOL); its weights feasible, the simplex sums within twice
    the plain runs' error where that exceeds FEAS_TOL. Fills ``res`` with
    those readings and the differences from the plain version (``out_p``)
    that ``hold_to_plain`` reports; raises ``AssertionError`` at the first
    bar missed."""
    dk, ek, wk = refs["distances"](out_k)
    dp, ep, wp = refs["plain"]
    dq, _, wq = refs["permuted"]
    for q in SPREAD_QUANTILES:
        kq = torch.quantile(dk, q).item()
        ref = max(torch.quantile(dp, q).item(), torch.quantile(dq, q).item())
        res[f"dw_float64_q{round(100 * q)}"] = kq
        res[f"plain_dw_float64_q{round(100 * q)}"] = ref
        assert kq <= REFEREE_FACTOR * ref + W_TOL, (
            f"{label}: at quantile {q} the kernel lies {kq} from the float64 "
            f"run in weights, the float32 plain runs {ref}")
    dobj = ek - ep
    B = dobj.numel()
    res["mean_dobj_all"] = dobj.mean().item()
    if B >= SPREAD_MIN_B:
        se = dobj.std().item() / B ** 0.5
        res["mean_dobj_se"] = se
        assert abs(res["mean_dobj_all"]) <= SPREAD_SE * se + \
            FLIP_MEAN_OBJ_TOL, (
                f"{label}: objectives biased against the plain version's: "
                f"mean {res['mean_dobj_all']}, standard error {se}")
    res["simplex_error"] = simplex_error(wk)
    res["plain_simplex_error"] = max(simplex_error(wp), simplex_error(wq))
    check_feasible(wk, cw, params, label,
                   max(FEAS_TOL, 2.0 * res["plain_simplex_error"]))
    dw = (wk - wp).abs().amax(dim=(1, 2))
    apart = (dw > W_TOL) | (dobj.abs() > OBJ_TOL)
    res.update({"max_abs_dw": dw.max().item(),
                "max_abs_dobj": dobj.abs().max().item(),
                "ended_apart": int(apart.sum().item()),
                "max_abs_dw_held":
                    dw[~apart].max().item() if (~apart).any() else 0.0,
                "held_by_spread": True})
    if len(out_k) > 3 and len(out_p) > 3:
        res["decisions_parted"] = int(
            (out_k[3][:, -1] != out_p[3][:, -1]).sum().item())


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
    them than the plain version is, plus 3 sqrt(n) + 2. Where the float64
    run does not settle either, it is no referee (its iterate is no optimum,
    and a settled side, a fixed point of the program, lies above it): the
    float64 run with fixed steps and the full warm budget for
    MV_REFEREE_ITERS iterations takes its place there, and must itself
    settle. Fills ``res`` with the counts and, for the first eight such
    problems, the three residuals and both distances to the referee."""
    from dataclasses import replace

    from kmpc_tpu_torch.ops import mv_cuda as V

    idx = torch.nonzero(astray).flatten()
    res["unsettled_apart"] = int(idx.numel())
    if idx.numel() == 0:
        return

    def float64_run(rows, p):
        sig_i = sig.double() if sig.dim() == 2 else sig[rows].double()
        w64, fp64 = V.pdhg_mean_variance_plain(
            cw[rows].double(), mu[rows].double(), sig_i, p)
        return fp64, V._finalize_mv(w64, fp64, mu[rows].double(), sig_i,
                                    cw[rows].double(), p)[1]["objective"]

    fp64, obj64 = float64_run(idx, params)
    loose = fp64 > MV_UNSETTLED_FP
    res["float64_fixed_step_referee"] = int(loose.sum().item())
    if loose.any():
        fixed = replace(params, adaptive=False, proj_refresh_every=0,
                        max_iters=MV_REFEREE_ITERS)
        fp_ref, obj_ref = float64_run(idx[loose], fixed)
        assert bool((fp_ref <= MV_UNSETTLED_FP).all()), (
            f"{label}: the fixed-step float64 referee did not settle "
            f"(fixed-point residual {fp_ref.max().item()})")
        fp64, obj64 = fp64.clone(), obj64.clone()
        fp64[loose], obj64[loose] = fp_ref, obj_ref
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
        if name == "mv_ladder":     # its 96 rungs: the extremes only
            regs = {"instantiations": len(regs), "max": max(regs.values())}
        emit("build", kernel=name, seconds=secs[name], registers=regs,
             spill_store_bytes={k: v for k, v in spills.items() if v})
    check_mv_block_plan()
    check_mv_tile_plan()
    check_mv_lanes_plan()
    check_rows_plan()
    check_wide_plan()
    check_wide_digests()


# The one-forecast wide-row kernels' outputs (``python -m
# kmpc_tpu_torch.ops.row_slots --digest``: the block path's N=150 in three
# bodies, bench.py's assets500 pipelined) as the wide kernel gave them
# before it took scenarios (NVIDIA H100 80GB HBM3, CUDA 12.8): its scenario
# paths sit behind ``if constexpr`` and must leave these bits alone.
WIDE_DIGESTS = {
    "block_path_N150_fixed":
        "692c3b3c4e19eb090d852c455efae0695899c3cf8e669f2be601ff4a79203bcc",
    "block_path_N150_pipe":
        "e64a7d5c5fffec598254873c16d5c8d648d0d5d6d1f488992ab30d18d4cec629",
    "block_path_N150_adaptive":
        "fe4503e8878e8d7d978a52e0f5bd4c998df1d1ced198910f439226b3a707899f",
    "assets500_pipe":
        "a4500398208b6e0e81221a1077adebbade0c9ea03f29b428d6ca322957e648a6",
}


def check_wide_digests():
    """The one-forecast wide-row kernels' bits against WIDE_DIGESTS."""
    from kmpc_tpu_torch.ops.row_slots import wide_digests

    got = wide_digests()
    differ = sorted(k for k in WIDE_DIGESTS if got.get(k) != WIDE_DIGESTS[k])
    assert not differ, f"the one-forecast wide kernels' bits changed: {differ}"
    emit("wide_digests", cases=len(got), same_bits=True)


def check_wide_plan():
    """The wrapper's copy of the wide-row layout's shared-memory plan
    (``wide_smem_bytes``, which decides whether the wide layout takes a
    shape) against the plan the built kernel launches with, over the edges
    of its envelope: 1 to 32 rows, 129 to 2730 assets, both bodies."""
    import ctypes

    from kmpc_tpu_torch._build import library_path
    from kmpc_tpu_torch.ops import mpc_cuda as M

    plan = ctypes.CDLL(str(library_path("pdhg_log_utility_wide")))
    plan = plan.kmpc_wide_smem_bytes
    plan.argtypes, plan.restype = [ctypes.c_int] * 3, ctypes.c_longlong
    shapes = [(H, N, a) for H in (1, 5, 8, 9, 20, 21, 32)
              for N in (129, 150, 160, 161, 500, 512, 513, 1600, 2730)
              for a in (False, True)]
    wrong = [(H, N, a, M.wide_smem_bytes(H, N, a), plan(H, N, a))
             for H, N, a in shapes
             if M.wide_smem_bytes(H, N, a) != plan(H, N, a)]
    # With scenarios: the bytes of both storages, the ring's stages and
    # scenarios a stage.
    lib = ctypes.CDLL(str(library_path("pdhg_log_utility_scenarios_wide")))
    smem, ring = lib.kmpc_wide_scen_smem_bytes, lib.kmpc_wide_scen_ring
    smem.argtypes, smem.restype = [ctypes.c_int] * 5, ctypes.c_longlong
    ring.argtypes, ring.restype = [ctypes.c_int] * 4, ctypes.c_int
    scen = [(S, H, N, a) for S in (1, 5, 16, 64, 512)
            for H in (1, 5, 8, 12, 20, 32)
            for N in (129, 150, 300, 384, 500, 2000) for a in (False, True)]
    for S, H, N, a in scen:
        for i, st in enumerate(M.STORAGES[1:], 1):
            want = M.wide_scen_plan(S, H, N, a, st)
            ring_ok = i != 2 or 10 * want[1] + want[2] == ring(S, H, N,
                                                               int(a))
            if want[0] != smem(S, H, N, int(a), i) or not ring_ok:
                wrong.append((S, H, N, a, st, want))
    assert not wrong, \
        f"the wrapper's wide plan differs from the kernel's: {wrong[:5]}"
    emit("wide_plan", shapes=len(shapes), scenario_shapes=len(scen),
         agree=True)


def check_rows_plan():
    """The wrapper's copy of the row layout's shared-memory plan
    (``rows_smem_bytes``, which decides whether the row layout takes a
    shape and where the scenario returns live) against the plan the built
    kernel launches with, over the edges of its envelope: 1 to 32 rows, 1
    to 4 slots, scenarios in registers, resident and streamed (and the
    ring's stages)."""
    import ctypes

    from kmpc_tpu_torch._build import library_path
    from kmpc_tpu_torch.ops import mpc_cuda as M

    lib = ctypes.CDLL(str(library_path("pdhg_log_utility_rows")))
    plan, ring = lib.kmpc_rows_smem_bytes, lib.kmpc_rows_ring_stages
    plan.argtypes, plan.restype = [ctypes.c_int] * 5, ctypes.c_longlong
    ring.argtypes, ring.restype = [ctypes.c_int] * 4, ctypes.c_int
    shapes = [(S, H, N, a, st)
              for S in (None, 1, 4, 5, 16, 17, 64, 113, 512, 4096)
              for H in (1, 5, 8, 9, 20, 21, 32) for N in (1, 20, 33, 70, 128)
              for a in (False, True) for st in M.STORAGES
              if S is not None or st == "registers"]
    wrong = [(S, H, N, a, st, M.rows_smem_bytes(S, H, N, a, st))
             for S, H, N, a, st in shapes
             if M.rows_smem_bytes(S, H, N, a, st)
             != plan(S or 0, H, N, a, M.STORAGES.index(st))
             or (st == "streamed" and M.rows_ring_stages(S, H, N, a)
                 != ring(S, H, N, a))]
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


def check_mv_tile_plan():
    """The wrapper's copy of the tile layout's plan (``mv_tile_plan``: the
    bytes of a CTA of P problems and the rows of a ring stage, which decide
    whether the tile layout takes a shape, and ``mv_tile_problems``: the
    problems a CTA for a batch) against the values the built kernel
    launches with, over the plan's edges: 1 to 32 rows, P = 1 to 32,
    Sigma resident and streamed (16, 8 and 4 rows a stage), N off the
    multiples of 4 and 32, both bodies, batches of 1 to 4096."""
    import ctypes

    from kmpc_tpu_torch._build import library_path
    from kmpc_tpu_torch.ops import mv_cuda as V

    lib = ctypes.CDLL(str(library_path("pdhg_mean_variance_tile")))
    smem, ring, probs = (lib.kmpc_mv_tile_smem_bytes,
                         lib.kmpc_mv_tile_ring_rows,
                         lib.kmpc_mv_tile_problems)
    smem.argtypes, smem.restype = [ctypes.c_int] * 4, ctypes.c_longlong
    ring.argtypes, ring.restype = [ctypes.c_int] * 4, ctypes.c_int
    probs.argtypes, probs.restype = [ctypes.c_int] * 5, ctypes.c_int
    shapes = [(P, H, N, a) for P in (1, 2, 3, 4, 8, 32)
              for H in (1, 2, 5, 16, 20, 32, 33)
              for N in (1, 20, 30, 33, 64, 100, 128, 129, 320, 600, 960,
                        1001, 1112)
              for a in (False, True)]
    wrong = []
    for P, H, N, a in shapes:
        plan = V.mv_tile_plan(P, H, N, a)
        want = (-1, None) if plan is None else plan
        got = (smem(P, H, N, int(a)), ring(P, H, N, int(a)))
        if got[0] != want[0] or (plan is not None and got[1] != want[1]):
            wrong.append((P, H, N, a, want, got))
    batches = [(B, H, N, sh, a) for B in (1, 7, 132, 264, 301, 1028, 4096)
               for H in (1, 2, 5, 20, 33) for N in (20, 64, 320, 960, 1112)
               for sh in (False, True) for a in (False, True)]
    wrong += [(B, H, N, sh, a, V.mv_tile_problems(B, H, N, sh, a),
               probs(B, H, N, int(sh), int(a)))
              for B, H, N, sh, a in batches
              if V.mv_tile_problems(B, H, N, sh, a)
              != probs(B, H, N, int(sh), int(a))]
    assert not wrong, \
        f"the wrapper's tile plan differs from the kernel's: {wrong[:5]}"
    emit("mv_tile_plan", shapes=len(shapes), batches=len(batches),
         agree=True)


# The lane layout's plan edges: one slot's row widths (8, 16, 24, 32 floats),
# two to four slots, the largest per-problem Sigma (three warps a CTA at
# 128 assets), and past the layout.
LANES_PLAN_N = (1, 7, 8, 9, 16, 17, 20, 24, 25, 30, 31, 32, 33, 63, 64, 65,
                96, 97, 100, 112, 113, 127, 128, 129, 200)


def check_mv_lanes_plan():
    """The wrappers' copies of the lane layout's plan (``mv_lanes_plan``:
    the warps a CTA and its shared memory, which decide whether the lane
    layout takes a shape) and of the ladder's (``ladder_rows``,
    ``ladder_block_bytes``: Sigma's rows in registers or its columns in
    shared memory, a block's bytes) against the values the built kernels
    launch with, over LANES_PLAN_N, shared and per problem, and the
    ladder's chains and warps."""
    import ctypes

    from kmpc_tpu_torch._build import library_path
    from kmpc_tpu_torch.ops import mv_cuda as V
    from kmpc_tpu_torch.ops import mv_ladder as D

    lib = ctypes.CDLL(str(library_path("pdhg_mean_variance_lanes")))
    warps, smem = lib.kmpc_mv_lanes_warps, lib.kmpc_mv_lanes_smem_bytes
    warps.argtypes, warps.restype = [ctypes.c_int] * 2, ctypes.c_int
    smem.argtypes, smem.restype = [ctypes.c_int] * 2, ctypes.c_longlong
    wrong = []
    for N in LANES_PLAN_N:
        for sh in (0, 1):
            plan = V.mv_lanes_plan(N, bool(sh))
            want = (0, -1) if plan is None else plan
            if (warps(N, sh), smem(N, sh)) != want:
                wrong.append((N, sh, want, (warps(N, sh), smem(N, sh))))
    lad = ctypes.CDLL(str(library_path("mv_ladder")))
    rows, lsmem = lad.kmpc_mv_ladder_rows, lad.kmpc_mv_ladder_smem_bytes
    rows.argtypes, rows.restype = [ctypes.c_int] * 2, ctypes.c_int
    lsmem.argtypes, lsmem.restype = [ctypes.c_int] * 3, ctypes.c_longlong
    ladder = [(N, c, w) for N in LANES_PLAN_N if N <= 128
              for c in (1, 2, 4) for w in (1, 2, 4, 8)]
    for N, c, w in ladder:
        want = (int(D.ladder_rows(N, c)), D.ladder_block_bytes(N, c, w))
        if (rows(N, c), lsmem(N, c, w)) != want:
            wrong.append(("ladder", N, c, w, want, (rows(N, c),
                                                     lsmem(N, c, w))))
    assert not wrong, \
        f"the wrappers' lane or ladder plans differ from the kernels': " \
        f"{wrong[:5]}"
    emit("mv_lanes_plan", shapes=2 * len(LANES_PLAN_N),
         ladder_shapes=len(ladder), agree=True)


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
    # Each shape at two of the four (refresh, precond) pairs, the pairs
    # alternating, so that every pair runs at three shapes. A case dropped
    # from a grid still takes its seed, so that every case keeps the inputs
    # it had before the grid was cut.
    for i, (H, N) in enumerate(((1, 12), (1, 33), (5, 12), (5, 20), (5, 30),
                                (5, 33))):
        for refresh in (0, 16):
            for precond in (False, True):
                seed += 1
                if (refresh == 16) != (precond == (i % 2 == 0)):
                    continue
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
    # Each shape at one (adapt_every, precond) pair, every pair at one
    # shape; the edges of the register budget at one, three and four slots.
    kept = {(1, 12, 1, False), (5, 20, 2, True), (5, 30, 1, True),
            (5, 33, 2, False)}
    for H, N in ((1, 12), (5, 20), (5, 30), (5, 33)):
        for k in (1, 2):
            for precond in (False, True):
                seed += 1
                if (H, N, k, precond) not in kept:
                    continue
                cases.append((f"adaptive_H{H}N{N}k{k}p{int(precond)}", 7,
                              H, N, _params(max_iters=400, adaptive=True,
                                            adapt_every=k, precond=precond),
                              seed, quick))
    for label, H, N in (("H12N20", 12, 20), ("H16N32", 16, 32),
                        ("H8N64", 8, 64), ("H3N90", 3, 90),
                        ("H4N128", 4, 128)):
        seed += 1
        if label in ("H12N20", "H8N64"):
            continue
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
    # adaptive_block_H5N500 at seed 30, where one problem parted beyond
    # FLIP_OBJ_TOL: float32's limit at N=500 (``python -m
    # kmpc_tpu_torch.ops.adaptive_parting --n500``: the problem stays
    # unsettled, fixed-point residual 6.0e-4 to 8.4e-4 in every run, and
    # the kernels' step history is the one the plain version takes with its
    # assets permuted), so held as the wide-row cases are (LOG_UNSETTLED_FP).
    cases.append(("adaptive_block_H5N500_seed30", 4, 5, 500, _params(
        max_iters=400, **acc), 30, dict(quick, wide=True)))
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
    # The wide-row layout (one forecast past four slots, one warp per
    # horizon row, the row in shared memory), the block layout beside it:
    # every body (warm and cold thresholds, the refresh schedule, the
    # pipelined body at refresh 8 and 16 with an odd iteration count, the
    # adaptive body at adapt_every 1 and 2, precond off and on), ridge,
    # over-relaxation, no ball, cold projections past 64 and 256 assets
    # (12 and 16 sweeps), warm inputs with the dual output, the steps; at
    # the edges of its envelope (N=129, 32 rows, one row of 2730 assets,
    # the largest plan at H=5 and at H=20).
    wide_cases = [
        ("wide_body_H5N150", 6, 5, 150, _params(max_iters=400)),
        ("wide_cond_precond_H5N500", 4, 5, 500, _params(
            max_iters=400, proj_refresh_every=16, precond=True)),
        ("wide_pipe_r16_H5N500", 4, 5, 500, _params(
            max_iters=401, proj_refresh_every=16, **pipe)),
        ("wide_pipe_r8_precond_H3N200", 5, 3, 200, _params(
            max_iters=403, proj_refresh_every=8, precond=True, **pipe)),
        ("wide_pipe_no_ball_H5N150", 5, 5, 150, _params(
            max_iters=400, proj_refresh_every=16, max_turnover=0.0,
            **pipe)),
        ("wide_ridge_precond_H5N160", 5, 5, 160, _params(
            max_iters=400, ridge=1e-3, precond=True, feas_tol=3e-4)),
        ("wide_over_relax_H5N200", 5, 5, 200, _params(
            max_iters=400, over_relax=1.5)),
        ("wide_no_ball_H5N150", 5, 5, 150, _params(
            max_iters=400, max_turnover=0.0)),
        ("wide_cold_H5N200", 4, 5, 200, _params(
            max_iters=300, proj_warm_iters=0)),
        ("wide_cold_H3N300", 4, 3, 300, _params(
            max_iters=300, proj_warm_iters=0)),
        ("wide_H5N129_cond", 5, 5, 129, _params(
            max_iters=400, proj_refresh_every=16)),
        ("wide_H32N200_cond", 3, 32, 200, _params(
            max_iters=300, proj_refresh_every=16, precond=True)),
        ("wide_H20N384_pipe", 3, 20, 384, _params(
            max_iters=301, proj_refresh_every=16, **pipe)),
        ("wide_H5N1600_cond", 3, 5, 1600, _params(
            max_iters=300, proj_refresh_every=16)),
        ("wide_H1N2730_cond", 3, 1, 2730, _params(
            max_iters=300, proj_refresh_every=16)),
    ]
    seed = 850
    # Each shape at two (adapt_every, precond) pairs, every pair at one.
    wide_dropped = {"wide_adaptive_H5N150k1p1", "wide_adaptive_H5N150k2p0",
                    "wide_adaptive_H5N500k1p0", "wide_adaptive_H5N500k2p1"}
    for H, N in ((5, 150), (5, 500)):
        for k in (1, 2):
            for precond in (False, True):
                wide_cases.append((
                    f"wide_adaptive_H{H}N{N}k{k}p{int(precond)}", 5, H, N,
                    _params(max_iters=400, adaptive=True, adapt_every=k,
                            precond=precond)))
    wide_cases += [
        ("wide_adaptive_ridge_H5N160", 5, 5, 160, _params(
            max_iters=400, ridge=1e-3, feas_tol=3e-4, **acc)),
        ("wide_adaptive_over_relax_odd_H5N200", 5, 5, 200, _params(
            max_iters=401, over_relax=1.5, **acc)),
        ("wide_adaptive_k1_cold_no_ball_H5N300", 4, 5, 300, _params(
            max_iters=300, adaptive=True, proj_warm_iters=0,
            max_turnover=0.0)),
        ("wide_adaptive_H32N200", 3, 32, 200, _params(max_iters=300, **acc)),
        ("wide_adaptive_H20N384", 3, 20, 384, _params(max_iters=300, **acc)),
        # Past SPREAD_N assets, routed to the wide layout: held by their
        # spread (``hold_spread``), at the paths' 800 iterations.
        ("wide_adaptive_H3N1000", 64, 3, 1000, _params(max_iters=800, **acc)),
        ("wide_adaptive_H4N1600", 64, 4, 1600, _params(max_iters=800, **acc)),
    ]
    for label, B, H, N, p in wide_cases:
        seed += 1
        if label not in wide_dropped:
            cases.append((label, B, H, N, p, seed, quick))
    cases += [
        ("wide_warm_dual_H5N200", 5, 5, 200, _params(
            max_iters=400, proj_refresh_every=16, precond=True), 881, warm),
        ("wide_pipe_warm_dual_H5N500", 4, 5, 500, _params(
            max_iters=400, proj_refresh_every=16, **pipe), 882, warm),
        ("wide_adaptive_warm_dual_H5N150", 5, 5, 150, _params(
            max_iters=400, **acc), 883, warm),
        ("wide_dual_H5N150", 5, 5, 150, _params(max_iters=400), 884,
         dict(dual=True, time_plain=False)),
    ]
    out = {name: [] for name in list(kernel_counters()) + [
        k for k in KERNELS if ":" in k]}

    def record(res, kernel=None, S=None):
        kernel = kernel or res["kernel"]
        emit("kernel_vs_plain", **dict(res, kernel=kernel))
        out[kernel].append(res)
        storage = storage_of(res.get("layout", ""), S, res.get("H"),
                             res.get("N"))
        if f"{kernel}:{storage}" in out:
            out[f"{kernel}:{storage}"].append(res)

    def routed(res):
        assert ("block" in res["case"]) == ("block" in res["kernel"]), \
            f"{res['case']} ran {res['kernel']}"
        return res

    def layouts_of(label, S, H, N):
        """The layout a case's label names (block, rows, wide, else warp),
        and beside it the row layout (the warp layout beside a rows case)
        and the wide layout (the block layout beside a wide case) wherever
        that takes the shape."""
        main = ("block" if "block" in label
                else "rows" if label.startswith("rows_")
                else "wide" if label.startswith("wide_") else "warp")
        extra = (("warp",) if main == "rows" else ("rows", "wide")) \
            + (("block",) if main == "wide" else ())
        return [main] + [x for x in extra if x != main
                         and M.layout_supports(x, S, H, N)]

    def run(label, B, H, N, p, s, S=None, layouts=None, **kw):
        # The kernel and the plain version are timed on the paths, whose
        # times the kernels line reports, not here. The wide-row layout's
        # adaptive cases (and
        # the block layout's beside them) are at float32's limit as
        # ``block_path``'s are (LOG_UNSETTLED_FP): held as ``wide`` cases
        # where they start cold, past SPREAD_N assets by their spread.
        kw["time_plain"], kw["time_reps"] = False, 0
        kw["wide"] = kw.get("wide", label.startswith("wide_")) \
            and not kw.get("warm")
        kw["spread"] = p.adaptive and N >= SPREAD_N and not kw.get("warm")
        for layout, res in compare_case(
                label, B, H, N, p, s, S=S,
                layouts=layouts or layouts_of(label, S, H, N),
                **kw).items():
            k = res["kernel"]
            base = split_layout(layout)[0]
            assert all((lay in k) == (base == lay)
                       for lay in ("block", "rows", "wide")), \
                (label, layout, k)
            record(res, S=S)

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
        [r for name, rows in out.items() if ":" not in name for r in rows]))

    # Kernel B past its registers: the row layout (up to 128 assets) and
    # the wide-row layout (past them) with the returns resident and
    # streamed, each case in every storage that takes its shape (the same
    # bits required of all). Every body and option at S=40 H=5 N=20
    # (refresh 8 and 16 with precond, pipelined with an odd iteration
    # count, adaptive at adapt_every 1 and 2, ridge, over-relaxation, no
    # ball, cold projections, warm inputs with the dual output), the three
    # bodies and warm inputs at S=16 H=5 N=150; the registers' chunk at
    # S=16; the warp path's S=113 H=8 N=64; three and four slots, 32 rows
    # with a ring of two stages; 600 scenarios, past the resident plan; the
    # wide ring's 2 and 1 scenarios a stage (H=8 and H=12 at N=500); one
    # row of 2000 assets. The warp and block layouts run beside them at the
    # shapes they took before (S=113 H=8 N=64, S=16 N=150).
    def storages(S, H, N):
        main = M.kernel_layout(S, H, N)
        out = [main]
        for lay in ("rows", "wide"):
            if M.layout_supports(lay, S, H, N):
                routed = storage_of(lay, S, H, N)
                out += [lay] * (lay != main) + [
                    f"{lay}:{st}" for st in M.STORAGES if st != routed
                    and M.storage_supports(lay, st, S, H, N)]
        before = {(113, 8, 64): "warp", (16, 5, 150): "block"}.get(
            (S, H, N))
        return out + [before] * (before is not None)

    options = {
        "": dict(max_iters=300),
        "_cond_precond": dict(max_iters=300, proj_refresh_every=16,
                              precond=True),
        "_pipe_r8_odd": dict(max_iters=301, proj_refresh_every=8,
                             precond=True, **pipe),
        "_ridge": dict(max_iters=300, ridge=1e-3, feas_tol=3e-4),
        "_over_relax_no_ball": dict(max_iters=300, over_relax=1.5,
                                    max_turnover=0.0),
        "_cold": dict(max_iters=300, proj_warm_iters=0),
        "_adaptive": dict(max_iters=300, **acc),
        "_adaptive_k1": dict(max_iters=300, adaptive=True),
    }
    storage_cases = []
    for B, S, H, N in ((5, 40, 5, 20), (5, 16, 5, 150)):
        storage_cases += [(f"storage_S{S}_H{H}N{N}{tag}", B, S, H, N,
                           _params(**kw), quick)
                          for tag, kw in options.items()
                          if N <= 128 or tag in ("", "_pipe_r8_odd",
                                                 "_adaptive")]
        storage_cases.append((
            f"storage_S{S}_H{H}N{N}_warm", B, S, H, N, _params(
                max_iters=300, proj_refresh_every=16, precond=True), warm))
    storage_cases.append(("storage_S40_H5N20_adaptive_warm", 5, 40, 5, 20,
                          _params(max_iters=300, **acc), warm))
    for B, S, H, N, its, adaptive in (
            (5, 16, 5, 20, 300, True), (4, 113, 8, 64, 200, True),
            (3, 37, 4, 90, 300, False),
            (2, 50, 32, 128, 150, False), (2, 600, 5, 20, 150, False),
            (3, 7, 3, 300, 300, False), (3, 64, 5, 150, 200, False),
            (2, 16, 8, 500, 200, True), (2, 16, 12, 500, 150, False),
            (2, 5, 1, 2000, 300, False)):
        storage_cases.append((f"storage_S{S}_H{H}N{N}", B, S, H, N,
                              _params(max_iters=its), quick))
        if adaptive:
            storage_cases.append((f"storage_S{S}_H{H}N{N}_adaptive", B, S,
                                  H, N, _params(max_iters=its, **acc),
                                  quick))
    seed = 950
    for label, B, S, H, N, p, kw in storage_cases:
        seed += 1
        run(label, B, H, N, p, seed, S=S, layouts=storages(S, H, N),
            **dict(kw, wide=N > 128))

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
    # Each case through its route.
    from kmpc_tpu_torch.ops import mv_cuda as V

    for label, B, H, N, p, s, kw in mv_cases:
        record(routed(compare_mv_case(
            label, B, H, N, p, s, **dict(kw, time_plain=False, time_reps=0))))

    # The lane layout at its plan's edges, pinned, in each sweep compiled
    # for N (both up to 32 assets, the butterfly past): one slot's row
    # widths (N = 1, 20, 30, 31, 32; the adaptive body at bench.py's N=30),
    # two to four slots (N = 33, 64, 128, three warps a CTA with a
    # per-problem Sigma at 128), shared and per problem, B=1 and ragged last
    # CTAs (B=7), every body and option (refresh 8 and 16, cold
    # projections, over-relaxation, adapt_every 1 and 2).
    seed = 760
    for name, B, N, shared, kw in (
            ("N1_B5", 5, 1, False, {}),
            ("N20_B1", 1, 20, False, {}),
            ("N20_B1_adaptive_k2", 1, 20, False, dict(
                adaptive=True, adapt_every=2)),
            ("N20_shared_B7_refresh16", 7, 20, True, dict(
                proj_refresh_every=16)),
            ("N30_B6_adaptive_k2", 6, 30, False, dict(
                adaptive=True, adapt_every=2)),
            ("N31_cold_proj", 6, 31, False, dict(proj_warm_iters=0)),
            ("N32_over_relax", 6, 32, False, dict(over_relax=1.5)),
            ("N33_shared_adaptive_k1", 5, 33, True, dict(
                adaptive=True, adapt_every=1)),
            ("N64_refresh8", 5, 64, False, dict(proj_refresh_every=8)),
            ("N128_B7", 7, 128, False, {}),
            ("N128_shared_adaptive_k2", 5, 128, True, dict(
                adaptive=True, adapt_every=2, over_relax=1.5)),
    ):
        seed += 1
        p = _params(**{"max_iters": 300, "gamma": 5.0, **kw})
        for sweep in V.mv_lanes_sweeps(N):
            record(routed(compare_mv_case(
                f"lanes_{name}_{sweep}", B, 1, N, p, seed, shared=shared,
                scale=0.01, time_plain=False, time_reps=0, layout="lanes",
                sweep=sweep)))

    # C.2: the shapes past the warp layout at the edges of kmpc_tpu's
    # envelope (a per-problem covariance past the warp layout's registers
    # at H=17 and H=340, N=65 and N=112 at H=5, N=88 at H=16; a shared one
    # at N=129 and N=1112 at H=1, N=480 at H=5, N=128 at H=20), the
    # adaptive body, over-relaxation and cold projections, bench.py's
    # covariance scale: each through its route (the tile layout; the block
    # layout at H > 32), and the block layout's kernel on the same inputs
    # (pinned: its Sigma staged in shared memory or read from global
    # memory, by size).
    seed = 730
    for name, B, H, N, shared, kw in (
            ("H17N8", 5, 17, 8, False, {}),
            ("H340N8", 3, 340, 8, False, dict(max_iters=300)),
            ("H5N65_refresh", 5, 5, 65, False, dict(proj_refresh_every=16)),
            ("H5N112", 4, 5, 112, False, {}),
            ("H16N88_refresh", 4, 16, 88, False, dict(
                proj_refresh_every=16)),
            ("H1N129_shared", 5, 1, 129, True, {}),
            ("H1N1112_shared", 4, 1, 1112, True, {}),
            ("H5N480_shared_refresh", 4, 5, 480, True, dict(
                proj_refresh_every=16)),
            ("H20N128_shared", 4, 20, 128, True, {}),
            ("adaptive_H1N976_shared", 4, 1, 976, True, dict(
                adaptive=True, adapt_every=2)),
            ("adaptive_H20N64", 4, 20, 64, False, dict(
                adaptive=True, adapt_every=2)),
            ("H17N20_over_relax", 5, 17, 20, False, dict(over_relax=1.5)),
            ("adaptive_H17N20_over_relax", 5, 17, 20, False, dict(
                adaptive=True, adapt_every=2, over_relax=1.5)),
            ("H17N20_cold_proj", 5, 17, 20, False, dict(
                proj_warm_iters=0)),
    ):
        seed += 1
        p = _params(**{"max_iters": 600, "gamma": 5.0, **kw})
        layout = V.mv_kernel_layout(H, N, shared, p.adaptive, B)
        record(routed(compare_mv_case(
            f"{layout}_{name}", B, H, N, p, seed, shared=shared, scale=0.01,
            time_plain=False, time_reps=0)))
        if layout != "block":
            record(routed(compare_mv_case(
                f"block_{name}", B, H, N, p, seed, shared=shared, scale=0.01,
                time_plain=False, time_reps=0, layout="block")))

    # The tile layout at its plan's edges, pinned: P > 1 with B not a
    # multiple of P (a ragged last CTA) and B=1; N off the multiples of 32
    # and of the ring's rows (4-byte copies where N % 4 != 0); Sigma
    # resident and streamed (16, 8 and 4 rows a stage), shared and per
    # problem (a per-problem Sigma streamed at N=250 and 300, each CTA's
    # ring reading its own); one to 32 warps (P H = 32, H = 21 and 32), one to four
    # register slots and shared slices; every body and option (refresh 8
    # and 16, cold projections, over-relaxation, adapt_every 1 and 2).
    mv_acc = dict(adaptive=True, adapt_every=2)
    for name, B, H, N, shared, P, kw in (
            ("H2N20_shared_P3_B7", 7, 2, 20, True, 3, {}),
            ("H1N20_B1", 1, 1, 20, False, None, {}),
            ("H5N30_B1_adaptive_k1", 1, 5, 30, False, None, dict(
                adaptive=True, adapt_every=1)),
            ("H1N960_shared_P8_B13_refresh8", 13, 1, 960, True, 8, dict(
                proj_refresh_every=8, max_iters=300)),
            ("H1N960_shared_P8_B13_adaptive", 13, 1, 960, True, 8, dict(
                max_iters=300, **mv_acc)),
            ("H1N1001_shared_P4_B5", 5, 1, 1001, True, 4, dict(
                max_iters=300)),
            ("H1N1001_shared_P4_B5_adaptive_k1", 5, 1, 1001, True, 4, dict(
                max_iters=300, adaptive=True, adapt_every=1)),
            ("H5N320_shared_P4_B6_refresh16", 6, 5, 320, True, 4, dict(
                proj_refresh_every=16, max_iters=300)),
            ("H16N320_shared_P2_B3", 3, 16, 320, True, 2, dict(
                max_iters=300)),
            ("H8N33_shared_P4_B9_cold_proj", 9, 8, 33, True, 4, dict(
                proj_warm_iters=0)),
            ("H21N100_over_relax", 3, 21, 100, False, None, dict(
                over_relax=1.5)),
            ("H32N128_adaptive_over_relax", 3, 32, 128, False, None, dict(
                over_relax=1.5, **mv_acc)),
            ("H3N129_shared_P5_B11", 11, 3, 129, True, 5, {}),
            ("H20N64_shared_adaptive_k1", 3, 20, 64, True, None, dict(
                adaptive=True, adapt_every=1)),
            ("H5N300_streamed_refresh16", 5, 5, 300, False, None, dict(
                proj_refresh_every=16, max_iters=300)),
            ("H5N300_streamed_adaptive", 5, 5, 300, False, None, dict(
                max_iters=300, **mv_acc)),
            ("H1N250_streamed", 5, 1, 250, False, None, dict(
                max_iters=300)),
            ("H1N250_streamed_adaptive_k1", 5, 1, 250, False, None, dict(
                max_iters=300, adaptive=True, adapt_every=1)),
    ):
        seed += 1
        p = _params(**{"max_iters": 600, "gamma": 5.0, **kw})
        record(routed(compare_mv_case(
            f"tile_{name}", B, H, N, p, seed, shared=shared, scale=0.01,
            time_plain=False, time_reps=0, layout="tile",
            problems=P)))

    # The MV ladder: every variant, chains and unroll, on a batch that is no
    # multiple of the chains; two and four slots per lane.
    from kmpc_tpu_torch.ops import mv_ladder as D

    # Sigma's rows in registers (one and two chains, 24 and 32 floats
    # wide) and in shared memory (four chains, every rung past 32 assets);
    # ``proj`` in both sweeps up to 32 assets.
    rungs = [(v, u, c, 4, 61, 30, 203) for v in D.VARIANTS
             for c in D.CHAINS for u in D.UNROLLS]
    rungs += [("proj", 4, 4, 1, 9, 33, 100), ("proj", 1, 2, 2, 7, 100, 60),
              ("sigma", 4, 1, 8, 70, 64, 60), ("proj", 4, 4, 2, 13, 16, 80),
              ("proj", 4, 2, 4, 11, 20, 80), ("sigma", 1, 4, 2, 9, 8, 80),
              ("proj", 4, 1, 1, 5, 128, 40)]
    rungs = [r + (sw,) for r in rungs for sw in (
        D.LANES_SWEEPS if r[0] == "proj" and r[5] <= 32 else (None,))]
    for variant, unroll, chains, warps, B, N, iters, sweep in rungs:
        cw, mu, sig = (torch.as_tensor(x, device="cuda").contiguous()
                       for x in D.ladder_inputs(B, N))
        wk = D.mv_ladder_cuda(cw, mu, sig, variant, iters, unroll, chains,
                              warps, sweep)
        wp = D.mv_ladder_plain(cw, mu, sig, variant, iters, unroll)
        torch.cuda.synchronize()
        dw = (wk - wp).abs().max().item()
        label = f"{variant}_u{unroll}c{chains}w{warps}_B{B}N{N}" + (
            f"_{sweep}" if sweep else "")
        assert dw <= MV_W_TOL, f"mv_ladder {label}: weights differ by {dw}"
        assert torch.isfinite(wk).all(), label
        res = {"case": label, "B": B, "N": N, "iters": iters,
               "max_abs_dw": dw}
        emit("kernel_vs_plain", kernel="mv_ladder", **res)
        out["mv_ladder"].append(res)
    return out


def alternating_ms(kernels, run, rounds=1):
    """{layout: [ms, ...]}: ``run(kernel)`` for each of ``kernels`` timed in
    ``rounds`` rounds of 3 (``cuda_ms``), the layouts alternating; each
    warmed up once, in the first round."""
    times = {name: [] for name in kernels}
    for i in range(rounds):
        for name, kernel in kernels.items():
            times[name].append(cuda_ms(lambda: run(kernel), 3,
                                       warmup=i == 0))
    return times


def confirmed_times(times, medians, routed, allowed, measure):
    """(times, medians) of a shape's layouts: as measured where the routed
    layout is within ``allowed`` of the fastest; else with a second
    measurement (``measure()``) joined to the first and the medians taken
    over both, so that one outlier among sub-millisecond launches does not
    decide the verdict (the bar ``allowed`` is unchanged)."""
    if medians[routed] <= allowed * min(medians.values()):
        return times, medians
    again = measure()
    times = {lay: t + again[lay] for lay, t in times.items()}
    return times, {lay: float(np.median(t)) for lay, t in times.items()}


# The shapes ``layouts`` times every layout at: (S, B, H, N, seed). The
# exact scan (B=1) and the comparison path (B=1028) at H=5, N=20; one
# horizon row; the long path (B=1013, H=20). Not the headline batches
# (B=65536, N=30; bench.py's ``long`` B=16384, H=20, N=30), whose
# layouts routing never picks (the row layout 2.6-2.8x faster than the
# next, PERF.md section 6; ``headline`` and ``large_headline`` time it
# there). The wide-row
# layout against the block layout: the block path's N=150 and bench.py's
# assets500 N=500 at B = 1, 1028 and 4096; one row of 500 assets, three
# rows of 1000 and four of 1600 (wide); one row of 1056 at B=1 and 1028
# and three at B=1 (wide, past the 32 slots a lane where an earlier rule
# stopped); each side of ``wide_preferred``'s switch at B=1028 (one row of
# 2368 and 2400 assets, two rows of 1888 and 1920); one row of 2730 and
# two (B=1, block), where the bodies split.
LAYOUT_SHAPES = (
    (None, 1, 5, 20, 508), (16, 1, 5, 20, 606),
    (None, 1028, 5, 20, 105), (16, 1028, 5, 20, 314),
    (None, 1028, 1, 20, 7),
    (None, 1013, 20, 20, 9), (16, 1013, 20, 20, 10),
    (None, 1, 5, 150, 1150), (None, 1028, 5, 150, 1150),
    (None, 4096, 5, 150, 1152), (None, 1, 5, 500, 0),
    (None, 1028, 5, 500, 0), (None, 4096, 5, 500, 0),
    (None, 1, 1, 500, 11), (None, 1028, 3, 1000, 12),
    (None, 1028, 4, 1600, 15), (None, 1, 1, 1056, 16),
    (None, 1028, 1, 1056, 17), (None, 1, 3, 1056, 18),
    (None, 1028, 1, 2368, 19), (None, 1028, 1, 2400, 20),
    (None, 1028, 2, 1888, 21), (None, 1028, 2, 1920, 22),
    (None, 1, 1, 2730, 13), (None, 1, 2, 2730, 14),
)
# Shapes where the routed layout beat every other layout by 1.5x or more
# in every body (2.4-12.3x, the narrowest three rows of 1000 assets at
# 1.62x; PERF.md section 6): their layouts' outputs are held to one
# another (``hold_layouts``), and not timed.
UNTIMED_LAYOUT_SHAPES = {
    (None, 1, 5, 20), (None, 1028, 5, 20), (None, 1013, 20, 20),
    (None, 1, 5, 150), (None, 1028, 5, 150), (None, 4096, 5, 150),
    (None, 1, 5, 500), (None, 1028, 5, 500), (None, 4096, 5, 500),
    (None, 1028, 3, 1000), (None, 1028, 1, 1056), (113, 132, 8, 64),
    (64, 1028, 5, 150),
}
# Kernel B past its registers: (S, B, H, N, seed, iterations). The row and
# wide-row layouts' returns resident and streamed on each side of the
# switch between them (``rows_storage``, ``wide_storage``: resident to S=84
# at H=5 N=20, to S=31 at H=8 N=64, to S=18 at H=5 N=150), at the
# scenarios path's S=512 and S=128 H=20 and the block path's S=16 N=150;
# against the block layout where it holds the problem (S=501 at H=5 N=20,
# S=16 and 64 at N=150, S=16 at N=500, which it took before) and the warp
# layout at the warp path's S=113 H=8 N=64. At a full batch, and at one
# problem past the switch at H=5 N=20, the iterations cut where a layout
# runs long.
SCEN_LAYOUT_SHAPES = (
    (84, 1028, 5, 20, 32, 200), (85, 1, 5, 20, 33, 200),
    (85, 1028, 5, 20, 34, 200), (32, 1028, 8, 64, 38, 200),
    (501, 1028, 5, 20, 42, 50), (512, 1028, 5, 20, 43, 50),
    (128, 1013, 20, 20, 44, 100), (113, 132, 8, 64, 46, 200),
    (16, 1028, 5, 150, 48, 200), (19, 1028, 5, 150, 50, 200),
    (64, 1028, 5, 150, 51, 100), (16, 1028, 5, 500, 53, 100),
)
# Where routing by shape alone is measured slower than another layout:
# (S, B, H, N, body) -> the largest routed-over-fastest ratio allowed.
# Routing takes the layout that is faster at B=1028 for most bodies; these
# are the bodies and batches that split from it (PERF.md section 6).
ROUTED_SLOWER = {
    # One row of 1056 assets alone (B=1): the block layout's pipelined
    # body 1.22x faster, the adaptive ones alike (1.002).
    (None, 1, 1, 1056, "pipe"): 1.35, (None, 1, 1, 1056, "adaptive"): 1.05,
    # Past the switch the fixed-step body stays faster in the wide layout
    # (its plan is the smaller: 1.65x and 1.77x); at two rows of 1888 and
    # 1920 the pipelined and adaptive bodies alike (within 2%).
    (None, 1028, 1, 2400, "fixed"): 1.8,
    (None, 1028, 2, 1888, "pipe"): 1.05,
    (None, 1028, 2, 1888, "adaptive"): 1.05,
    (None, 1028, 2, 1920, "fixed"): 1.95,
    (None, 1028, 2, 1920, "pipe"): 1.05,
    # Two rows of 2730 alone: the bodies split, the fixed one 1.13x
    # faster in the wide layout.
    (None, 1, 2, 2730, "fixed"): 1.25,
    # Kernel B's storages (``rows_storage``, ``wide_storage``), by shape
    # alone at the CTAs an SM each plan allows; as measured (PERF.md section 6):
    # one problem runs faster resident wherever that fits (its returns never
    # leave the SM; streamed 1.5-1.8x slower at H=5 N=20, 1.2-1.6x at N=150),
    # a full batch near the switch either way (streamed 1.2x faster at S=84
    # H=5 N=20, resident 1.07-1.29x at S=32 H=8 N=64 and 1.03-1.26x at S=19
    # N=150); at S=16 the registers 1.06x slower than resident, adaptive.
    (16, 1, 5, 20, "fixed"): 1.2, (16, 1, 5, 20, "pipe"): 1.2,
    (16, 1, 5, 20, "adaptive"): 1.2, (16, 1028, 5, 20, "adaptive"): 1.2,
    (84, 1028, 5, 20, "fixed"): 1.4, (84, 1028, 5, 20, "pipe"): 1.45,
    (84, 1028, 5, 20, "adaptive"): 1.15,
    (85, 1, 5, 20, "fixed"): 1.8, (85, 1, 5, 20, "pipe"): 1.95,
    (85, 1, 5, 20, "adaptive"): 2.1, (85, 1028, 5, 20, "adaptive"): 1.15,
    (32, 1028, 8, 64, "fixed"): 1.45, (32, 1028, 8, 64, "pipe"): 1.5,
    (32, 1028, 8, 64, "adaptive"): 1.25,
    (19, 1028, 5, 150, "fixed"): 1.4, (19, 1028, 5, 150, "pipe"): 1.45,
    (19, 1028, 5, 150, "adaptive"): 1.2,
}


def layout_bodies(B, iters=None):
    """The bodies ``layouts`` times: the paths' (2000 iterations fixed and
    pipelined at refresh 16 with precond, 800 adaptive), or bench.py's
    settings at B >= 4096 (1000 iterations at refresh 16 with precond,
    1000 pipelined, 800 adaptive); ``iters`` cuts the iterations (the
    adaptive body's to at most 800)."""
    if iters is not None:
        return {
            "fixed": _params(max_iters=iters),
            "pipe": _params(max_iters=iters, proj_refresh_every=16,
                            precond=True, pipeline_reduces=True),
            "adaptive": _params(max_iters=min(iters, 800), adaptive=True,
                                adapt_every=2, precond=True),
        }
    its = 1000 if B >= 4096 else 2000
    return {
        "fixed": (_params(max_iters=its) if its == 2000 else _params(
            max_iters=its, proj_refresh_every=16, precond=True)),
        "pipe": _params(max_iters=its, proj_refresh_every=16, precond=True,
                        pipeline_reduces=True),
        "adaptive": _params(max_iters=800, adaptive=True, adapt_every=2,
                            precond=True),
    }


def hold_layouts(label, cw, r, params, outs, routed, res):
    """The bar ``phase_layouts`` holds one shape and body to, on any
    device: the layouts' outputs ``outs`` {layout: (weights, fixed-point
    residual)}, and the layout the wrapper routes the shape to. Each
    layout's weights within W_TOL of the routed layout's on every problem,
    for the adaptive body on all but BEYOND_SHARE of them (two runs that may
    part at a tie). Past SPREAD_N assets the adaptive body's float32 runs
    part on most problems, and each layout, the routed one too, is held by
    its spread (``hold_spread``) instead. Fills ``res``; raises
    ``AssertionError``."""
    from kmpc_tpu_torch.ops import mpc_cuda as M

    share = {}
    for lay, out in outs.items():
        assert torch.isfinite(out[0]).all(), f"{label} {lay}: not finite"
        dw = (out[0] - outs[routed][0]).abs().amax(dim=(1, 2))
        share[lay] = (dw > W_TOL).float().mean().item()
    res["share_beyond_w_tol"] = share
    if params.adaptive and r.shape[-1] >= SPREAD_N:
        out_p = M.pdhg_log_utility_plain(cw, r, params)
        refs = spread_refs(cw, r, params, out_p)
        for lay, out in outs.items():
            res[lay] = {}
            hold_spread(f"{label} {lay}", cw, r, params, out, out_p, refs,
                        res[lay])
        return
    bar = BEYOND_SHARE if params.adaptive else 0.0
    far = {lay: x for lay, x in share.items() if x > bar}
    assert not far, \
        f"{label}: layouts whose weights part from the routed layout's " \
        f"on more than {bar} of the problems: {far}"


def phase_layouts():
    """Every layout of kernels A and B that takes the shape (the row and
    wide-row layouts in every storage of the scenario returns that takes
    it), at each of LAYOUT_SHAPES and SCEN_LAYOUT_SHAPES and body, launched
    in it (``pinned``), each timed in one round of 3, the layouts
    alternating (twice where the routed layout is measured slower,
    ``confirmed_times``; not at UNTIMED_LAYOUT_SHAPES). The layouts'
    outputs must meet ``hold_layouts``, and the layout the wrapper routes
    the shape to must be the fastest measured there (the routing rule is
    the measurement), or within its bound where ROUTED_SLOWER names the
    shape and body: every shape and body is timed before the phase fails
    on the list of those where the layouts disagreed or another layout was
    faster. ``mv_layouts`` does the same for kernel C."""
    from kmpc_tpu_torch.ops import mpc_cuda as M

    slower, disagree = [], []
    for S, B, H, N, seed, iters in [x + (None,) for x in LAYOUT_SHAPES] + \
            list(SCEN_LAYOUT_SHAPES):
        cw_np, ys_np = (instance(B, H, N, seed) if S is None
                        else scenario_instance(B, S, H, N, seed))
        cw = torch.as_tensor(cw_np, device="cuda")
        r = torch.exp(torch.as_tensor(ys_np, device="cuda")).contiguous()
        taken = [lay for lay in M.LAYOUTS if M.layout_supports(lay, S, H, N)]
        # The row and wide-row layouts in the storages routing does not
        # give the shape, too.
        taken += [f"{lay}:{st}" for lay in ("rows", "wide") if lay in taken
                  for st in M.STORAGES if S is not None
                  and st != storage_of(lay, S, H, N)
                  and M.storage_supports(lay, st, S, H, N)]
        for body, p in layout_bodies(B, iters).items():
            routed, routed_body, _ = M._route(S, H, N, p)
            assert routed_body == body, (S, H, body, routed_body)

            def run(layout):
                return pinned(layout, cw, r, p)

            timed = (S, B, H, N) not in UNTIMED_LAYOUT_SHAPES
            if timed:
                times = alternating_ms({lay: lay for lay in taken}, run)
            outs = {lay: run(lay) for lay in taken}
            torch.cuda.synchronize()
            held = {}
            try:
                hold_layouts(f"layouts S={S} B={B} H={H} N={N} {body}", cw,
                             r, p, outs, routed, held)
            except AssertionError as e:
                disagree.append(str(e))
            if not timed:
                emit("layouts", S=S, B=B, H=H, N=N, body=body,
                     iters=p.max_iters, routed=routed, timed=False, **held)
                continue
            medians = {lay: float(np.median(t)) for lay, t in times.items()}
            allowed = ROUTED_SLOWER.get((S, B, H, N, body), 1.0)
            times, medians = confirmed_times(
                times, medians, routed, allowed,
                lambda: alternating_ms({lay: lay for lay in taken}, run))
            fastest = min(medians, key=medians.get)
            over = medians[routed] / medians[fastest]
            emit("layouts", S=S, B=B, H=H, N=N, body=body,
                 iters=p.max_iters, routed=routed, fastest=fastest,
                 ms=times, over_routed={lay: m / medians[routed]
                                        for lay, m in medians.items()},
                 routed_over_fastest_allowed=allowed, **held)
            if over > allowed:
                slower.append((S, B, H, N, body, routed, medians))
    assert not disagree, f"layouts that disagree: {disagree}"
    assert not slower, \
        f"routed layouts measured slower than another (S, B, H, N, body, " \
        f"routed, medians): {slower}"


# Kernel C's switches between layouts (``mv_kernel_layout``), each timed at
# bench.py's settings (1000 iterations; 200 past 128 assets) on each side:
# (B, H, N, shared). The warp layout at one row of up to 128 assets (per
# problem at B=1028 and 1, shared at B=5 and 1028), the tile layout past
# it (two rows at N=30 and 128; one row shared at N=129, per problem at
# N=200, one-warp CTAs); the tile layout streaming Sigma per problem at
# H >= 3, the block layout below (N=250 and 300); a shared Sigma streamed
# at one row for more than 132 problems, the block layout up to 132 (N=960
# at B=1, 132 and 264), and at H >= 3 for any batch (N=320 at B=5).
MV_SWITCH_SHAPES = (
    (1028, 1, 128, False), (1, 1, 128, False), (5, 1, 20, True),
    (1028, 1, 128, True), (1028, 2, 30, False), (1, 2, 30, False),
    (1028, 2, 128, False), (1028, 2, 30, True), (5, 1, 129, True),
    (1028, 1, 200, False), (1, 1, 200, False), (528, 1, 250, False),
    (264, 2, 300, False), (264, 3, 300, False), (5, 5, 300, False),
    (1, 1, 960, True), (132, 1, 960, True), (264, 1, 960, True),
    (5, 5, 320, True))
# Where the routed layout is measured slower than another, the rule kept
# for its simplicity: (B, H, N, shared, body) -> the largest routed-over-
# fastest ratio allowed (PERF.md section 6, PR 8). Two rows per problem
# streamed at B=264: the tile layout's fixed-step body 1.04x faster. Small
# batches streamed at H=5: the block layout's adaptive body 1.05-1.08x
# faster.
MV_ROUTED_SLOWER = {
    # The lane layout's two sweeps within 1% of each other, either one
    # faster from run to run (PERF.md section 6): the Markowitz path's
    # fixed body (B=1028, N=20).
    (1028, 1, 20, False, "fixed"): 1.05,
    (264, 2, 300, False, "fixed"): 1.15,
    (5, 5, 300, False, "adaptive"): 1.2,
    (5, 5, 320, True, "adaptive"): 1.15,
}


def mv_layout_shapes():
    """Kernel C's shapes for ``mv_layouts``: (B, H, N, shared, seed,
    bodies, rounds): the Markowitz path's (H=1, N=20; 2000 iterations at
    gamma 1, and its accurate configuration, 800 adaptive) at B=1028 and at
    the exact scan's B=1; bench.py's Markowitz setting (1000 iterations at
    refresh 16, and 1000 adaptive) at H=1, N=30 at B=4096 and bench.py's
    65536 (the lane layout's sweep switch), and at H=5, N=30 at
    B=1028 and B=1; the
    switches (``MV_SWITCH_SHAPES``, "switch" up to 128 assets, else "wide");
    the five MV_LONG_WIDE shapes at 200 iterations of bench.py's settings
    (``mv_long_wide`` times them at 1000); each in one round of 3."""
    return ((1028, 1, 20, False, 410, "path", 1),
            (1, 1, 20, False, 724, "path", 1),
            (4096, 1, 30, False, 414, "bench", 1),
            (65536, 1, 30, False, 416, "bench", 1),
            (1028, 5, 30, False, 412, "bench", 1),
            (1, 5, 30, False, 413, "bench", 1)) + tuple(
        (B, H, N, shared, 940 + i, "switch" if N <= 128 else "wide", 1)
        for i, (B, H, N, shared) in enumerate(MV_SWITCH_SHAPES)) + tuple(
        (B, H, N, shared, 900 + i, "wide", 1)
        for i, (_, B, H, N, shared) in enumerate(MV_LONG_WIDE))


def mv_layout_bodies(which):
    """The bodies ``mv_layouts`` times a shape at: "path" (the Markowitz
    path's settings), "bench" and "switch" (bench.py's, 1000 iterations),
    "wide" (bench.py's at 200 iterations)."""
    from dataclasses import replace

    from kmpc_tpu_torch.ops.mpc import MPCParams

    if which == "path":
        return {"fixed": MPCParams(max_iters=2000, gamma=1.0, horizon=1),
                "adaptive": MPCParams(max_iters=800, gamma=1.0, horizon=1,
                                      adaptive=True, adapt_every=2,
                                      precond=True)}
    bodies = mv_settings()
    if which == "wide":
        bodies = {k: replace(p, max_iters=200) for k, p in bodies.items()}
    return bodies


def mv_layouts():
    """Every layout of kernel C that takes the shape (lanes in each sweep
    compiled for N, warp, tile, block), at each of ``mv_layout_shapes`` and body,
    launched in it (``_mv_launch``), timed in its rounds of 3, the layouts
    alternating (twice where the routed layout is measured slower,
    ``confirmed_times``); the layouts' weights
    held to the routed layout's at the mean-variance weight bar (every
    problem for fixed steps, all but BEYOND_SHARE of them for the adaptive
    body; at the switches and the wide shapes the adaptive body's share is
    reported), and
    the routed layout required to be the fastest (within MV_ROUTED_SLOWER
    where that names the shape and body): every shape and body is timed
    before the phase fails on the list of those where another layout was
    faster."""
    from kmpc_tpu_torch.ops import mv_cuda as V

    slower = []
    for B, H, N, shared, seed, which, rounds in mv_layout_shapes():
        cw, mu, sig = (torch.as_tensor(x, device="cuda") for x in mv_instance(
            B, H, N, seed, shared, scale=0.01))
        sig = (0.5 * (sig + sig.transpose(-1, -2))).contiguous()
        for body, p in mv_layout_bodies(which).items():
            routed, _ = V._mv_route(H, N, p, shared, B)
            if routed == "lanes":
                routed = f"lanes:{V.mv_lanes_sweep(B, N)}"
            # At bench.py's B=65536 only the lane layout's two sweeps: the
            # sweep is the choice there (the warp and tile layouts, which
            # routing never picks at one row, 1.26x and more behind).
            taken = {lay: (V._MV_KERNELS[(lay, p.adaptive)], None)
                     for lay in ("warp", "tile", "block")
                     if B < 65536
                     and (lay != "warp" or V.mv_kernel_supports(H, N))
                     and (lay != "tile"
                          or V.mv_tile_problems(B, H, N, shared, p.adaptive))}
            if V.mv_kernel_layout(H, N, shared, p.adaptive, B) == "lanes":
                taken.update({f"lanes:{sw}": (V._MV_KERNELS[(
                    "lanes", p.adaptive)], sw) for sw in V.mv_lanes_sweeps(N)})

            def run(kernel_sweep):
                kernel, sweep = kernel_sweep
                return V._mv_launch(kernel, cw, mu, sig, p, sweep=sweep)

            times = alternating_ms(taken, run, rounds)
            outs = {lay: run(k)[0] for lay, k in taken.items()}
            torch.cuda.synchronize()
            medians = {lay: float(np.median(t)) for lay, t in times.items()}
            beyond = {}
            for lay, w in outs.items():
                assert torch.isfinite(w).all(), (B, H, N, body, lay)
                dw = (w - outs[routed]).abs().amax(dim=(1, 2))
                beyond[lay] = (dw > MV_W_TOL).float().mean().item()
                # The adaptive body at the switches and the wide shapes is
                # reported (a tie may part two layouts on one problem of a
                # small batch): ``mv_long_wide`` and the ``kernels`` phase
                # hold each layout against the plain version, problem by
                # problem.
                if p.adaptive and which in ("switch", "wide"):
                    continue
                assert beyond[lay] <= (BEYOND_SHARE if p.adaptive else 0.0), \
                    f"layouts C B={B} H={H} N={N} {body}: {lay} apart from " \
                    f"{routed} on {beyond[lay]} of the problems"
            allowed = MV_ROUTED_SLOWER.get((B, H, N, shared, body), 1.0)
            times, medians = confirmed_times(
                times, medians, routed, allowed,
                lambda: alternating_ms(taken, run, rounds))
            fastest = min(medians, key=medians.get)
            emit("layouts", program="mean_variance", B=B, H=H, N=N,
                 shared_sigma=shared, body=body, iters=p.max_iters,
                 routed=routed, fastest=fastest, ms=times,
                 over_routed={lay: m / medians[routed]
                              for lay, m in medians.items()},
                 routed_slower_allowed=allowed, share_beyond_w_tol=beyond)
            if medians[routed] > allowed * medians[fastest]:
                slower.append((B, H, N, shared, body, routed, medians))
    assert not slower, \
        f"routed mean-variance layouts measured slower than another beyond " \
        f"MV_ROUTED_SLOWER (B, H, N, shared, body, routed, medians): {slower}"


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

    sweeps = 2
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
FIXED_REACH = {"Markowitz": "pdhg_mean_variance_lanes",
               "DMD": "pdhg_log_utility_rows",
               "KoopmanMPC": "pdhg_log_utility_rows",
               "ScenarioKelly": "pdhg_log_utility_scenarios_rows"}
ACCURATE_REACH = {k: v + "_adaptive" for k, v in FIXED_REACH.items()}


def strategy_kernel(name, mpc, mv_mpc, n_assets, scenarios=SCENARIOS):
    """The kernel the wrapper routes a strategy's batched solve to under
    these settings (None for buy-and-hold): the mean-variance kernel for
    Markowitz, else the log-utility kernel of the shape and body."""
    from kmpc_tpu_torch.ops.mpc_cuda import _route
    from kmpc_tpu_torch.ops.mv_cuda import _mv_route

    if name == "BuyAndHold":
        return None
    if name == "Markowitz":    # one step ahead, per-date covariances
        return _mv_route(1, n_assets, mv_mpc)[1].name
    S = scenarios if name == "ScenarioKelly" else None
    return _route(S, mpc.horizon, n_assets, mpc)[2].name


def expect_kernel(reach, name, mpc, mv_mpc, n_assets, scenarios=SCENARIOS):
    """``reach[name]``, the kernel named for the strategy on its path, after
    asserting that the wrapper routes the strategy's solve there."""
    routed = strategy_kernel(name, mpc, mv_mpc, n_assets, scenarios)
    assert routed == reach[name], f"{name}: routed to {routed}, not {reach[name]}"
    return reach[name]


def kernel_counters():
    """Every kernel's launch counter by name."""
    from kmpc_tpu_torch.ops import mpc_cuda as M
    from kmpc_tpu_torch.ops import mv_cuda as V
    from kmpc_tpu_torch.ops.mv_ladder import MV_LADDER

    return {k.name: k for k in M.KERNELS + V.MV_KERNELS + (MV_LADDER,)}


def reset_counts():
    """Every kernel's launch count, and the scenario kernels' counts by
    storage, set to 0; returns the counters by name."""
    from kmpc_tpu_torch.ops import mpc_cuda as M

    kernels = kernel_counters()
    for k in kernels.values():
        k.launches = 0
    M.STORAGE_LAUNCHES.clear()
    return kernels


def run_strategies(ctx, cfg, sweeps, reach, horizon=None, names=None,
                   scenarios=SCENARIOS):
    """The five-strategy Jacobi comparison (or the ``names`` among them)
    under ``cfg``'s solver settings and ``horizon`` (default the config's),
    scenario Kelly with ``scenarios`` scenarios, every batched solve through
    its kernel and every returned weight row checked. Counts are set to 0
    just before and read just after; each strategy other than buy-and-hold
    must have launched the kernel ``reach`` names for it once a sweep, and
    no other. Returns (strategies, frames, timing, launches, KoopmanMPC's
    ``Timed``, (mpc, mv_mpc, bt))."""
    from kmpc_tpu_torch.backtest.engine import run_backtest_parallel
    from kmpc_tpu_torch.run_experiment import (
        backtest_settings, build_strategies, markowitz_settings,
    )

    fd, model = ctx["fd"], ctx["model"]
    bt, mpc = backtest_settings(cfg, horizon=horizon)
    mv_mpc = markowitz_settings(cfg)
    n_dates = fd.test.shape[0] - fd.sequence_length - bt.HORIZON
    strategies = build_strategies(model, mpc, mv_mpc, bt.LOOKBACK_WINDOW,
                                  scenarios=scenarios, fused=True)
    if names is not None:
        strategies = {k: v for k, v in strategies.items() if k in names}
    kernels = reset_counts()
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
            want[expect_kernel(reach, name, mpc, mv_mpc, fd.n_assets,
                               scenarios)] += sweeps
    assert launches == want, f"launches {launches}, expected {want}"
    return strategies, frames, timing, launches, koopman, (mpc, mv_mpc, bt)


def first_solves(ctx, strategies, mpc, mv_mpc, bt, names, label, reach,
                 scenarios=SCENARIOS, dates=None):
    """The path's first solves (pre-trade guess 1/N on every date, or on
    the first ``dates``) of the named strategies, by each kernel and by its
    plain version on the same card inputs: {kernel name (``reach``): the
    case}."""
    fd = ctx["fd"]
    n = fd.n_assets
    n_dates = fd.test.shape[0] - fd.sequence_length - bt.HORIZON
    n_dates = min(n_dates, dates or n_dates)
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
        first[expect_kernel(reach, name, mpc, mv_mpc, n, scenarios)] = res
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

    sweeps, warm_iters = 3, 500
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
    # Against the cold run the warm one is judged on objectives: 3 sweeps do
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

    sweeps = 2
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
         fixed_step_final_values=fixed_values,
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
    ("pipelined_H20", pipeline_config, 20, 2, None,
     {"DMD": "pdhg_log_utility_rows",
      "KoopmanMPC": "pdhg_log_utility_rows",
      "ScenarioKelly": "pdhg_log_utility_scenarios_rows",
      "Markowitz": "pdhg_mean_variance_lanes"}),
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


# Kernel B's warp layout at the shape it was built for: (B, S, H, N, seed).
# Each problem's 113 scenarios of 8 rows and 64 assets fill one warp's
# slice of shared memory (226 KB of the 227 KB), past the row layout's
# resident plan and the block layout's; B=132, one problem per SM of an
# H100 SXM. Routing gives it to the row layout, its returns streamed.
WARP_B_PATH = (132, 113, 8, 64, 1160)


def phase_warp_path(ctx):
    """The warp layout's kernels. Kernel A's (fixed, adaptive, pipelined):
    routing takes the row layout at every shape they take, so they run
    pinned (``pinned``, the private launch) on the comparison path's
    first-sweep Koopman-MPC problems (full width, the pre-trade guess 1/N
    on every date) at the comparison's fixed steps, the accurate
    configuration and the pipeline configuration (H=5), through the packed
    solve's finalisation. Kernel B's at WARP_B_PATH: through
    ``solve_mpc_log_utility_scenarios_packed``, which routes the shape to
    the row layout with its returns streamed, and the same problems in the
    warp layout by the private launch, at the same three configurations.
    Counts set to 0 before these nine solves and read after; then each
    solve's kernel held against the plain version, every row of the
    weights feasible (the simplex sum to FEAS_TOL, or to twice the plain
    version's own error, as ``hold_to_plain`` holds it), the streamed row
    kernel's bits against the warp kernel's (parting only where
    ``rows_bits_part`` names the operation), and on the comparison's
    problems of both kernels (scenario Kelly at S=16 too) the warp kernel
    compared bit for bit with the row kernel. Returns the launches (and the
    row kernels' by storage), the cases at the path's shapes by kernel
    (the streamed row kernels' under ``kernel:streamed``), and the other
    cases (the row kernels', and kernel B's warp kernels' at S=16) by
    kernel."""
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
    kernels = reset_counts()
    want, weights = {}, {}
    for label, cw, y, mpc in solves:
        r = torch.exp(y).contiguous()
        if y.dim() == 4:
            layout, _, kernel = M._route(S, H, N, mpc)
            assert layout == "rows" and M.rows_storage(S, H, N) == \
                "streamed", (label, layout)
            weights[(label, "rows")] = \
                M.solve_mpc_log_utility_scenarios_packed(cw, y, mpc)[0]
            want[kernel.name] = want.get(kernel.name, 0) + 1
        kernel = pinned_kernel("warp", r, mpc)
        out = pinned("warp", cw, r, mpc)
        weights[(label, "warp")] = \
            M._finalize_packed(out[0], r, cw, mpc, out[1])[0]
        want[kernel.name] = want.get(kernel.name, 0) + 1
    launches = {k: v.launches for k, v in kernels.items() if v.launches}
    assert launches == want, f"launches {launches}, expected {want}"
    by_storage = {f"{k}:{st}": n for (k, st), n in M.STORAGE_LAUNCHES.items()}
    assert by_storage == {f"{k}:streamed": n for k, n in want.items()
                          if "scenarios_rows" in k}, by_storage
    first, extra = {}, {}
    for label, cw, y, mpc in solves:
        if y.dim() == 4:
            cases = compare_layouts(f"warp_path_{label}", cw,
                                    torch.exp(y).contiguous(), mpc,
                                    time_reps=5, layouts=["rows", "warp"])
            rows = cases["rows"]
            assert rows["bits_equal_warp"] or rows["bits_part"], \
                f"warp_path {label}: the streamed row kernel's bits part " \
                f"from the warp kernel's ({rows['bits_equal_outputs']})"
            for layout, res in cases.items():
                check_feasible(weights[(label, layout)], cw, mpc,
                               f"warp_path {label} {layout}", max(
                                   FEAS_TOL, 2.0 * res["plain_simplex_error"]))
                emit("warp_path_solve", **res)
            rows.update(storage="streamed", S=S,
                        returns_bytes_per_iter=4 * B * S * H * N)
            rows["returns_tb_per_s"] = (rows["returns_bytes_per_iter"]
                                        * mpc.max_iters
                                        / (rows["kernel_ms"] * 1e-3) / 1e12)
            first.setdefault(rows["kernel"] + ":streamed", rows)
            first[cases["warp"]["kernel"]] = cases["warp"]
    for label, cw, y, mpc in comparison:
        cases = compare_layouts(f"warp_path_{label}", cw,
                                torch.exp(y).contiguous(), mpc, time_reps=5,
                                layouts=["warp", "rows"])
        if y.dim() == 3:
            w = weights[(label, "warp")]
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
         launches=launches, launches_by_storage=by_storage,
         rows_vs_warp_bits=check_bits(
             [c for cases in extra.values() for c in cases]))
    return dict(launches, **by_storage), first, extra


# The block and wide-row layouts' shapes on their path: past the row
# layout's four slots.
BLOCK_PATH = (1028, 5, 150)


def phase_block_path():
    """The block and wide-row layouts' kernels past the row layout's four
    slots: B=1028 problems of H=5 and N=150 (kmpc_tpu's kernel takes up to
    N=2730) at bench.py's settings (1000 iterations at refresh 16 with
    precond; 1000 pipelined; 800 adaptive). One forecast through
    ``solve_mpc_log_utility_packed``, which routes the shape to the wide
    kernels, and the same problems in the block layout by the private
    launch (``pinned``, as ``warp_path`` drives kernel A's warp kernels)
    through the packed solve's finalisation; S=16 scenarios through
    ``solve_mpc_log_utility_scenarios_packed``, routed to kernel B's
    wide-row kernels with the returns resident, and the same problems in
    the block layout by the private launch. Counts set to 0 before these
    twelve solves and read after; then
    each held against its plain version (twice for the same bits; the
    adaptive body as a ``wide`` case, LOG_UNSETTLED_FP), the wide and block
    kernels on the same problems against one plain run, with their largest
    weight difference, and every row of the weights feasible, as in
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
    groups = []
    for S, seed in ((None, 1150), (SCENARIOS, 1151)):
        cw_np, ys_np = (instance(B, H, N, seed) if S is None
                        else scenario_instance(B, S, H, N, seed))
        cw = torch.as_tensor(cw_np, device="cuda")
        y = torch.as_tensor(ys_np, device="cuda")
        groups += [(S, body, ["wide", "block"], cw, y, p)
                   for body, p in bodies.items()]
    assert M.wide_storage(SCENARIOS, H, N) == "resident"
    kernels = reset_counts()
    want, weights = {}, {}
    for S, body, layouts, cw, y, p in groups:
        routed, _, kernel = M._route(S, H, N, p)
        assert routed == layouts[0], (S, body, routed)
        for layout in layouts:
            if layout == routed:
                solve = (M.solve_mpc_log_utility_packed if S is None
                         else M.solve_mpc_log_utility_scenarios_packed)
                w = solve(cw, y, p)[0]
            else:
                r = torch.exp(y).contiguous()
                kernel = pinned_kernel(layout, r, p)
                out = pinned(layout, cw, r, p)
                w = M._finalize_packed(out[0], r, cw, p, out[1])[0]
            weights[(S, body, layout)] = w
            want[kernel.name] = want.get(kernel.name, 0) + 1
    launches = {k: v.launches for k, v in kernels.items() if v.launches}
    assert launches == want, f"launches {launches}, expected {want}"
    by_storage = {f"{k}:{st}": n for (k, st), n in M.STORAGE_LAUNCHES.items()}
    assert by_storage == {f"{k}:resident": n for k, n in want.items()
                          if "scenarios_wide" in k}, by_storage
    first = {}
    for S, body, layouts, cw, y, p in groups:
        cases = compare_layouts(f"block_path_S{S}_{body}", cw,
                                torch.exp(y).contiguous(), p,
                                layouts=layouts, wide=True)
        for layout, res in cases.items():
            check_feasible(weights[(S, body, layout)], cw, p,
                           f"block_path S={S} {body} {layout}", max(
                               FEAS_TOL, 2.0 * res["plain_simplex_error"]))
            emit("block_path_solve", body=body, **res)
            first.setdefault(res["kernel"], res)
    emit("block_path", B=B, H=H, N=N, S=[None, SCENARIOS],
         layouts=["wide", "block"], launches=launches,
         launches_by_storage=by_storage)
    return launches, first


# Scenario Kelly alone, as ``python -m kmpc_tpu_torch.run_experiment
# --scenarios 512`` builds it, and with ``--horizon 20 --scenarios 128``
# and the pipeline configuration: (label, config, horizon, scenarios,
# sweeps). Shapes every layout refused before the row layout streamed its
# returns.
SCENARIO_RUNS = (
    ("S512_H5", lambda c: c, 5, 512, 2),
    ("S128_H20_pipelined", pipeline_config, 20, 128, 2),
)
# The first sweep's solves are held against the plain version on the first
# dates only: at S=512 and the full 1028 dates each of the plain version's
# [B, S, H, N] temporaries takes 210 MB, and it runs 2000 iterations.
SCENARIO_PLAIN_DATES = 256


def phase_scenarios_path(ctx):
    """Scenario Kelly alone at SCENARIO_RUNS' scenario counts, through the
    strategy and the Jacobi backtest at full width (finance_sparse, random
    weights from --seed, the synthetic panel). For each run: counts set to
    0 before and read after, one launch a sweep of the row layout's
    scenario kernel with the returns in the storage ``rows_storage`` gives
    the shape; every weight row feasible (``Timed``); the first sweep's
    solves held against the plain version on the first
    SCENARIO_PLAIN_DATES dates, twice for the same bits; the kernel timed on
    every date; solve and recursion ms a sweep. Returns the launches (by
    kernel and by ``kernel:storage``) and the cases by ``kernel:storage``."""
    import pandas as pd

    from kmpc_tpu_torch.backtest.engine import calculate_metrics
    from kmpc_tpu_torch.ops import mpc_cuda as M
    from kmpc_tpu_torch.run_experiment import backtest_settings

    fd = ctx["fd"]
    launches, first, runs = {}, {}, {}
    for label, make_cfg, horizon, S, sweeps in SCENARIO_RUNS:
        cfg = make_cfg(ctx["cfg"])
        mpc = backtest_settings(cfg, horizon=horizon)[1]
        layout, _, kernel = M._route(S, horizon, fd.n_assets, mpc)
        storage = M.rows_storage(S, horizon, fd.n_assets)
        assert layout == "rows" and storage != "registers", (label, layout)
        strategies, frames, timing, launched, _, (mpc, _, bt) = \
            run_strategies(ctx, cfg, sweeps, {"ScenarioKelly": kernel.name},
                           horizon=horizon, names=("ScenarioKelly",),
                           scenarios=S)
        key = f"{kernel.name}:{storage}"
        by_storage = {f"{k}:{st}": n
                      for (k, st), n in M.STORAGE_LAUNCHES.items()}
        assert by_storage == {key: sweeps}, by_storage
        launches.setdefault(key, sweeps)
        aux = strategies["ScenarioKelly"].precompute(fd, bt.HORIZON)
        n_dates = len(frames["ScenarioKelly"])
        cw = torch.full((n_dates, fd.n_assets), 1.0 / fd.n_assets,
                        device=fd.device)
        r = torch.exp(aux["scenario_log_returns"][:n_dates]).contiguous()
        cut = SCENARIO_PLAIN_DATES
        res = compare_tensors(f"scenarios_path_{label}", cw[:cut],
                              r[:cut].contiguous(), mpc, time_reps=3)
        assert res["kernel"] == kernel.name, res["kernel"]
        res.update(
            plain_batch=cut, B=n_dates, S=S, storage=storage,
            kernel_ms=cuda_ms(lambda: M.pdhg_log_utility_cuda(cw, r, mpc),
                              3),
            returns_bytes_per_iter=4 * n_dates * S * horizon * fd.n_assets)
        res["bound_ms"], res["bound_by"] = pdhg_bound(
            n_dates, horizon, fd.n_assets, mpc, S)
        res["returns_tb_per_s"] = (res["returns_bytes_per_iter"]
                                   * mpc.max_iters
                                   / (res["kernel_ms"] * 1e-3) / 1e12)
        emit("scenarios_path_first_solve", run=label, **res)
        first.setdefault(key, res)
        print(pd.DataFrame({k: calculate_metrics(v)
                            for k, v in frames.items()}).T.to_string(),
              flush=True)
        runs[label] = {
            "horizon": horizon, "scenarios": S, "sweeps": sweeps,
            "dates": n_dates, "mpc_iters": mpc.max_iters,
            "pipeline_reduces": mpc.pipeline_reduces, "storage": storage,
            "launches": by_storage,
            "per_strategy": timing,
            "final_value": float(
                frames["ScenarioKelly"]["portfolio_value"].iloc[-1])}
    emit("scenarios_path", config="finance_sparse", runs=runs)
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


def mv_references(shapes):
    """Float64 reference objectives of each (H, N)'s probe instances, as
    bench.py's ``_ref_objectives("mv", ...)`` builds them: adaptive PDHG
    (k=2, sigma_scale 2, gamma 5) at 40000 iterations, here the port's
    eager solver in float64 on the card. Its loop replays one CUDA graph of
    MV_REF_GRAPH iterations (``ops.mpc.graph_replayed``), each shape on a stream of
    its own so that the shapes' small kernels overlap; nothing is timed
    meanwhile."""
    from dataclasses import replace

    from kmpc_tpu_torch.ops.mpc import (
        MPCParams,
        graph_replayed,
        solve_mpc_mean_variance_batch,
    )

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
    Markowitz problems (the full batch, which routing gives to the tile
    layout at all five shapes) and on the shape's 16 probe instances (per
    problem covariances, to their route), and the block layout's kernel on
    each full batch (launched privately: no shape here routes to it),
    launches counted from 0 and every row held feasible; then per shape and
    setting the tile and block kernels against their plain version per
    problem (the plain version on a batch cut to PLAIN_TEMP_BYTES, timed
    once), each run twice for the same bits and timed (CUDA-event median
    of 3 after those runs), the tile layout required to be the faster;
    the bound and its share, registers, the L2 bytes of Sigma each layout
    reads (a resident Sigma once per CTA, a streamed or global one every
    iteration), the largest weight difference between the layouts, and on
    the probe instances the routed kernel held against the plain version
    by the same bars; last the probe's objective gap to the float64
    references (median, p90). Returns (launches, the shared_H1N960 case of
    each kernel, every case by kernel)."""
    from kmpc_tpu_torch.ops import mv_cuda as V

    t0 = time.perf_counter()
    settings = mv_settings()
    data, probe = {}, {}
    for seed, (label, B, H, N, shared) in enumerate(MV_LONG_WIDE):
        cw, mu, sig = (torch.as_tensor(x, device="cuda") for x in mv_instance(
            B, H, N, 900 + seed, shared, scale=0.01))
        data[label] = (cw, mu, sig,
                       (0.5 * (sig + sig.transpose(-1, -2))).contiguous())
        probe[label] = mv_probe_instances(H, N)

    counters = kernel_counters()
    for k in counters.values():
        k.launches = 0
    solved, expected = {}, {}
    for label, B, H, N, shared in MV_LONG_WIDE:
        cw, mu, sig, sym = data[label]
        for body, p in settings.items():
            assert V.mv_kernel_layout(H, N, shared, p.adaptive,
                                      B) == "tile", \
                (label, body)
            w, info = V.solve_mpc_mean_variance_packed(cw, mu, sig, p)
            w_probe, _ = V.solve_mpc_mean_variance_packed(
                *(torch.as_tensor(x) for x in probe[label]), p)
            block = V._MV_KERNELS[("block", p.adaptive)]
            w_block, _ = V._mv_launch(block, cw, mu, sym, p)
            solved[(label, body)] = (w, info, w_probe, w_block)
            for kernel in (V._MV_KERNELS[("tile", p.adaptive)], block,
                           V._mv_route(H, N, p, B=len(probe[label][0]))[1]):
                expected[kernel.name] = expected.get(kernel.name, 0) + 1
    torch.cuda.synchronize()
    launches = {name: k.launches for name, k in counters.items()
                if k.launches}
    assert launches == expected, (launches, expected)
    for (label, body), (w, info, _, w_block) in solved.items():
        for x in (w, w_block):
            assert simplex_error(x) <= FEAS_TOL and bool((x >= 0).all()), \
                (label, body, simplex_error(x))
        assert bool(info["converged"].all()), (label, body)

    regs = {name: _ptxas_report(name)[0] for name in launches}
    rows, cases, first = [], {name: [] for name in launches}, {}
    for label, B, H, N, shared in MV_LONG_WIDE:
        cw, mu, _, sym = data[label]
        for body, p in settings.items():
            case = f"mv_long_wide_{label}_{body}"
            layout, kernel = V._mv_route(H, N, p, shared, B)
            block = V._MV_KERNELS[("block", p.adaptive)]
            out_k = mv_kernel_twice(
                case, layout, lambda: V.pdhg_mean_variance_cuda(
                    cw, mu, sym, p, return_steps=p.adaptive))
            out_b = mv_kernel_twice(
                case + "_block", "block", lambda: V._mv_launch(
                    block, cw, mu, sym, p, return_steps=p.adaptive))
            bp = min(B, PLAIN_TEMP_BYTES // (4 * H * N * N))
            sig_p = sym if shared else sym[:bp]
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out_p = V.pdhg_mean_variance_plain(cw[:bp], mu[:bp], sig_p, p,
                                               return_steps=p.adaptive)
            end.record()
            torch.cuda.synchronize()
            P = V.mv_tile_problems(B, H, N, shared, p.adaptive)
            ring = V.mv_tile_plan(P, H, N, p.adaptive)[1]
            sigma_bytes = 4 * N * N
            res = {"case": case, "kernel": kernel.name, "B": B, "H": H,
                   "N": N, "iters": p.max_iters, "shared_sigma": shared,
                   "problems_per_cta": P, "ring_rows": ring,
                   "l2_sigma_bytes": -(-B // P) * sigma_bytes
                   * (p.max_iters if ring else 1),
                   "plain_batch": bp, "plain_ms": start.elapsed_time(end)}
            res_b = {"case": case + "_block", "kernel": block.name, "B": B,
                     "H": H, "N": N, "iters": p.max_iters,
                     "shared_sigma": shared,
                     "sigma_staged": V.mv_sigma_staged(H, N),
                     "l2_sigma_bytes": B * sigma_bytes * (
                         1 if V.mv_sigma_staged(H, N) else p.max_iters),
                     "plain_batch": bp, "plain_ms": res["plain_ms"]}
            for r, out in ((res, out_k), (res_b, out_b)):
                hold_mv(r["case"], cw[:bp], mu[:bp], sig_p, p,
                        tuple(x[:bp] for x in out), out_p, r)
            dw = (out_k[0] - out_b[0]).abs().max().item()
            for r, k in ((res, kernel), (res_b, block)):
                r["kernel_ms"] = cuda_ms(lambda: V._mv_launch(
                    k, cw, mu, sym, p), 3, warmup=False)
                r["bound_ms"], r["bound_by"] = mv_bound(B, H, N, p, shared)
                r["bound_share"] = r["bound_ms"] / r["kernel_ms"]
                r["registers"] = regs[k.name]
                r["max_abs_dw_block"] = dw
            res["block_ms"] = res_b["kernel_ms"]
            res["block_over_tile"] = res_b["kernel_ms"] / res["kernel_ms"]
            assert res["kernel_ms"] <= res_b["kernel_ms"], (
                f"{case}: routing gives the tile layout, "
                f"{res['kernel_ms']} ms, the block layout takes "
                f"{res_b['kernel_ms']} ms")

            # The probe: the routed kernel held against the plain version
            # on the same instances by the same bars (``hold_mv``).
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
            res["probe_kernel"] = V._mv_route(H, N, p, B=len(probe[label][0]))[1].name
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
            cases[block.name].append(res_b)
            emit("mv_long_wide_block", **res_b)
            if label == "shared_H1N960":
                first[kernel.name] = res
                first[block.name] = res_b

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
    adaptive; the row layout) and ``assets500`` shape (B=4096, H=5, N=500:
    1000 iterations pipelined, and the 10000-iteration co-row; the
    wide-row layout): time, solves/s and bound, and the objective gap on
    bench.py's 16 probe instances of the shape (seed 1241) against the
    float64 references cached in bench_probe_cache.json (an adaptive PDHG
    run in float64, as the keys say); at 1000 iterations the kernel's
    probe objectives are held against the plain version's."""
    from kmpc_tpu_torch.ops import mpc_cuda as M
    from kmpc_tpu_torch.ops.mpc import MPCParams

    cache = json.loads((ROOT / "bench_probe_cache.json").read_text())
    for label, B, H, N, kw, bar, with_plain in LARGE:
        p = MPCParams(sigma_scale=2.0, feas_tol=2e-4, **kw)
        layout, body, kernel = M._route(None, H, N, p)
        assert layout == ("wide" if N > 128 else "rows"), (label, layout)
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
            res["plain_ms"] = timed_once(
                lambda: M.pdhg_log_utility_plain(cw, r, p))[1]

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


# bench.py's ``--mode markowitz``: (B, H, N, probe cache key), per-problem
# covariances, bench.py's Markowitz settings (``mv_settings``).
MARKOWITZ = (65536, 1, 30, "mv_H1_N30_n16_seed1241_f64pdhg")


def phase_markowitz():
    """bench.py's ``--mode markowitz`` shape (B=65536, H=1, N=30, a
    covariance per problem) at both of its settings (1000 iterations at
    refresh 16, and the adaptive co-row at ``adapt_every=2``): first the
    path, through ``solve_mpc_mean_variance_packed`` (the lane layout) with
    the warp layout's kernel launched privately on the same inputs, counts
    from 0; then the entry point's, the routed kernel's and the warp
    kernel's times (CUDA-event median of 3), the plain version's (one
    run), solves/s, the bound and its share; the routed kernel held
    against the plain version on every problem by the mean-variance bars
    (``hold_mv``: the adaptive body by its tie rules), the warp kernel by
    the weight bar with fixed steps; on bench.py's 16 probe instances (seed
    1241) the lane kernel in the headline's sweep (``mv_lanes_sweep`` at
    B=65536) and the warp kernel held against the plain version per
    instance by the mean-variance bars, and the objective gap to the
    float64 references in
    bench_probe_cache.json (read only; a missing key raises). Returns
    (launches, the warp kernels' cases, every case by kernel)."""
    from kmpc_tpu_torch.ops import mv_cuda as V

    B, H, N, key = MARKOWITZ
    ref = np.asarray(json.loads((ROOT / "bench_probe_cache.json")
                                .read_text())[key])
    cw, mu, sig = mv_instance_cuda(B, H, N, 1240)
    sym = (0.5 * (sig + sig.transpose(-1, -2))).contiguous()
    pcw, pys, psig = mv_probe_instances(H, N)
    settings = mv_settings()

    counters = kernel_counters()
    for k in counters.values():
        k.launches = 0
    solved = {}
    for body, p in settings.items():
        layout, kernel = V._mv_route(H, N, p, False, B)
        assert layout == "lanes", (body, layout)
        warp = V._MV_KERNELS[("warp", p.adaptive)]
        w, info = V.solve_mpc_mean_variance_packed(cw, mu, sig, p)
        solved[body] = (w, info, V._mv_launch(warp, cw, mu, sym, p)[0])
    torch.cuda.synchronize()
    launches = {name: k.launches for name, k in counters.items()
                if k.launches}
    want = {V._MV_KERNELS[(lay, a)].name: 1 for lay in ("lanes", "warp")
            for a in (False, True)}
    assert launches == want, (launches, want)
    for body, (w, info, w_warp) in solved.items():
        for x in (w, w_warp):
            assert simplex_error(x) <= FEAS_TOL and bool((x >= 0).all()), \
                (body, simplex_error(x))
        assert bool(info["converged"].all()), body

    first, cases = {}, {}
    for body, p in settings.items():
        _, kernel = V._mv_route(H, N, p, False, B)
        warp = V._MV_KERNELS[("warp", p.adaptive)]
        bound_ms, bound_by = mv_bound(B, H, N, p, False)
        entry_ms = cuda_ms(lambda: V.solve_mpc_mean_variance_packed(
            cw, mu, sig, p), 3)
        kernel_ms = cuda_ms(lambda: V.pdhg_mean_variance_cuda(
            cw, mu, sym, p), 3)
        warp_ms = cuda_ms(lambda: V._mv_launch(warp, cw, mu, sym, p), 3)
        # The routed kernel, the instantiation timed above, held against
        # the plain version on every problem by the mean-variance bars (the
        # adaptive body by its tie rules, its step histories returned);
        # the warp kernel by the weight bar with fixed steps.
        out_p, plain_ms = timed_once(lambda: V.pdhg_mean_variance_plain(
            cw, mu, sym, p, return_steps=p.adaptive))
        held = {}
        hold_mv(f"markowitz_full_batch_{body}", cw, mu, sym, p,
                V._mv_launch(kernel, cw, mu, sym, p,
                             return_steps=p.adaptive), out_p, held)
        held.update(case=f"markowitz_full_batch_{body}", B=B, H=H, N=N,
                    iters=p.max_iters)
        full = {kernel.name: held["max_abs_dw"]}
        wp_f, _ = V._finalize_mv(*out_p[:2], mu, sym, cw, p)
        wk_f, _ = V._finalize_mv(*V._mv_launch(warp, cw, mu, sym, p),
                                 mu, sym, cw, p)
        full[warp.name] = (wk_f - wp_f).abs().max().item()
        if not p.adaptive:
            assert full[warp.name] <= MV_W_TOL, (body, full[warp.name])
        torch.cuda.synchronize()

        # The probe: bench.py's 16 instances, each kernel held against the
        # plain version per instance; the routed kernel's objective gap.
        t = [torch.as_tensor(x, device="cuda") for x in (pcw, pys, psig)]
        res = compare_mv_tensors(f"markowitz_probe_{body}", *t, p,
                                 time_reps=1, time_plain=False,
                                 layout="lanes", sweep=V.mv_lanes_sweep(B, N))
        res_w = compare_mv_tensors(f"warp_markowitz_probe_{body}", *t, p,
                                   time_reps=1, time_plain=False,
                                   layout="warp")
        w_probe, info_probe = V.solve_mpc_mean_variance_packed(
            *(torch.as_tensor(x) for x in (pcw, pys, psig)), p)
        gap = mv_min_objective(w_probe.cpu().numpy(), pys, psig, pcw) - ref
        assert np.all(np.isfinite(gap)), gap
        common = {"B": B, "H": H, "N": N, "iters": p.max_iters,
                  "plain_ms": plain_ms, "bound_ms": bound_ms,
                  "bound_by": bound_by, "plain_batch": len(pcw)}
        res["probe_sweep"] = res.pop("sweep")
        res.update(common, kernel_ms=kernel_ms, entry_ms=entry_ms,
                   solves_per_s=B / (entry_ms / 1e3),
                   kernel_solves_per_s=B / (kernel_ms / 1e3),
                   bound_share=bound_ms / kernel_ms, warp_ms=warp_ms,
                   warp_over_lanes=warp_ms / kernel_ms,
                   sweep=V.mv_lanes_sweep(B, N),
                   max_abs_dw_full_batch=full[kernel.name],
                   full_batch={k: v for k, v in held.items()
                               if k not in ("unsettled", "case")},
                   reference="f64_adaptive_pdhg", probe_instances=len(gap),
                   median_gap=float(np.median(gap)),
                   p90_gap=float(np.quantile(gap, 0.9)),
                   max_gap=float(np.max(gap)),
                   probe_converged=float(info_probe["converged"].float()
                                         .mean().item()))
        res_w.update(common, kernel_ms=warp_ms,
                     bound_share=bound_ms / warp_ms,
                     max_abs_dw_full_batch=full[warp.name])
        emit("markowitz_headline", body=body, **res)
        emit("markowitz_headline_warp", body=body, **res_w)
        cases.setdefault(kernel.name, []).extend((res, held))
        cases.setdefault(warp.name, []).append(res_w)
        first[warp.name] = res_w
    return launches, first, cases


def ladder_ops(B, N, iters, variant) -> float:
    """FP32 operations of one ladder rung: per element and iteration 4 for
    ``carry``; else 2 N for Sigma w, 5 for the step, 7 for the clamp, the
    extrapolation and the clipped dual, and 5 for ``proj``'s sweep and
    threshold; once 2 N per element for the Frobenius norm."""
    per = {"carry": 4, "sigma": 2 * N + 12, "proj": 2 * N + 17}[variant]
    return float(B) * N * (iters * per + 2 * N)


# The ladder's shapes: (B, N, iterations): its default, then the Markowitz
# path's (the comparison's B=1028, N=20, 2000 iterations). The first gives
# the kernels line its case.
LADDER_SHAPES = ((4096, 30, 1000), (1028, 20, 2000))


def phase_mv_ladder():
    """The MV ladder's rungs through its entry point at LADDER_SHAPES;
    returns the launch count and the first shape's ``proj`` rung's case for
    the kernels line."""
    from kmpc_tpu_torch.ops import mv_ladder as D

    D.MV_LADDER.launches = 0
    for B, N, iters in LADDER_SHAPES:
        rows = D.run_ladder(B, N, iters, reps=5)
        assert len(rows) == len(D.RUNGS)
        assert all(np.isfinite(r["ms"]) and r["ms"] > 0 for r in rows)
        for r in rows:
            bytes_ms = 4.0 * B * (3 * N + N * N) / PEAK_HBM_BYTES * 1e3
            ops_ms = ladder_ops(B, N, iters, r["variant"]) \
                / PEAK_FP32_FLOPS * 1e3
            r["bound_ms"] = max(bytes_ms, ops_ms)
            r["bound_by"] = "operations" if ops_ms >= bytes_ms else "bytes"
        emit("mv_ladder", B=B, N=N, iters=iters,
             sweep=D.mv_lanes_sweep(B, N),
             rows_in_registers={c: D.ladder_rows(N, c) for c in D.CHAINS},
             rungs=rows)
        if (B, N, iters) == LADDER_SHAPES[0]:
            first = rows
    launches = D.MV_LADDER.launches
    assert launches == 6 * len(D.RUNGS) * len(LADDER_SHAPES), launches
    B, N, iters = LADDER_SHAPES[0]
    rung = next(r for r in first if (r["variant"], r["unroll"], r["chains"],
                                     r["warps"]) == ("proj", 4, 1, 4))
    cw, mu, sig = (torch.as_tensor(x, device="cuda").contiguous()
                   for x in D.ladder_inputs(B, N))
    wk = D.mv_ladder_cuda(cw, mu, sig, "proj", iters)
    wp, plain_ms = timed_once(
        lambda: D.mv_ladder_plain(cw, mu, sig, "proj", iters))
    dw = (wk - wp).abs().max().item()
    assert dw <= MV_W_TOL, f"mv_ladder at the ladder's shape: {dw}"
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
        plain_ms = timed_once(lambda: M.pdhg_log_utility_plain(cw, r, p))[1]
        bound_ms, bound_by = pdhg_bound(B, H, N, p)
        emit(phase, B=B, H=H, N=N, iters=p.max_iters, adaptive=p.adaptive,
             kernel=M._route(None, H, N, p)[2].name, kernel_ms=ms, solves_per_s=B / (ms / 1e3), plain_ms=plain_ms,
             bound_ms=bound_ms, bound_by=bound_by,
             fp32_ops=pdhg_ops(B, H, N, p), bound_share=bound_ms / ms)


TRAIN_DIR = ROOT / "runs" / "chip_smoke_train"
TRAIN_HOLD_STEPS = 3
TRAIN_LOSS_REL = 1e-5   # step 1's six metrics, card vs CPU
TRAIN_GRAD_REL = 1e-4   # step 1's gradients per tensor, |d| / |g|
TRAIN_STEP_REL = 1e-4   # each held step's loss


def _rel_norm(a, b) -> float:
    a, b = a.double().cpu(), b.double().cpu()
    return float(torch.linalg.vector_norm(a - b)
                 / torch.linalg.vector_norm(b).clamp_min(1e-30))


def hold_train_steps(cfg, model, batches, dt=1.0):
    """The first train steps (``make_train_step``) on the card against the
    port on the CPU, from ``model``'s weights and the same ``batches``
    (tensors on the card, copied to the CPU), TF32 off: step 1's six
    metrics within TRAIN_LOSS_REL, its gradients within TRAIN_GRAD_REL per
    tensor, every step's loss within TRAIN_STEP_REL."""
    from kmpc_tpu_torch.models.koopman import make_model
    from kmpc_tpu_torch.train import loop as T

    assert not torch.backends.cuda.matmul.allow_tf32, "TF32 is on"
    cpu_model = make_model(cfg, model.observation_size, device="cpu")
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    sides = {}
    for name, m in (("cuda", model), ("cpu", cpu_model)):
        state = T.TrainState(m, T.build_optimizer(cfg, m))
        step = T.make_train_step(cfg, m, dt)
        first, grads, losses = None, None, []
        t0 = time.perf_counter()
        for i, b in enumerate(batches):
            b = (tuple(x.to(name) for x in b) if isinstance(b, tuple)
                 else b.to(name))
            _, metrics = step(state, b)
            if i == 0:
                first = {k: v.item() for k, v in metrics.items()}
                grads = {n: p.grad.detach().clone()
                         for n, p in m.named_parameters()}
            losses.append(metrics["loss"].item())
        sides[name] = (first, grads, losses, time.perf_counter() - t0)
    (fk, gk, lk, sk), (fc, gc, lc, sc) = sides["cuda"], sides["cpu"]
    metric_rel = {k: abs(fk[k] - fc[k]) / max(abs(fc[k]), 1e-12) for k in fc}
    grad_rel = {n: _rel_norm(gk[n], gc[n]) for n in gc}
    step_rel = [abs(a - b) / max(abs(b), 1e-12) for a, b in zip(lk, lc)]
    res = {"steps": len(batches), "loss_card": lk, "loss_cpu": lc,
           "max_metric_rel": max(metric_rel.values()),
           "max_grad_rel": max(grad_rel.values()),
           "max_step_loss_rel": max(step_rel), "cpu_s": sc}
    far = {k: v for k, v in metric_rel.items() if v > TRAIN_LOSS_REL}
    assert not far, f"step 1's metrics apart from the CPU's: {far}"
    far = {n: v for n, v in grad_rel.items() if v > TRAIN_GRAD_REL}
    assert not far, f"step 1's gradients apart from the CPU's: {far}"
    assert max(step_rel) <= TRAIN_STEP_REL, f"losses apart: {lk} vs {lc}"
    return res


@contextlib.contextmanager
def timed_training(stats):
    """Times ``train/loop.py``'s run as it goes, by wrapping its module
    globals: CUDA events around each chunk's steps and the host clock
    around their enqueueing (the steps run with ``torch.cuda`` sync
    debugging at "error", so a step that synchronises the host raises),
    the host clock around each boundary (logs, evals, checkpoints), split
    into K's spectrum, evaluations and checkpoint writes."""
    from kmpc_tpu_torch.train import loop as T

    parts = {"spectral_metrics": "spectrum_s", "evaluate_finance": "eval_s",
             "_val_loss": "eval_s", "evaluate_system": "eval_s",
             "save_checkpoint": "checkpoint_s"}
    originals = {name: getattr(T, name) for name in (*parts, "_run_chunks")}
    stats.update(spectrum_s=0.0, eval_s=0.0, checkpoint_s=0.0,
                 boundary_s=0.0, enqueue_s=0.0, chunks=[], loop_s=0.0,
                 in_boundary=False)

    def timed(name):
        fn = originals[name]

        def wrapper(*a, **kw):
            if not stats["in_boundary"]:   # the final evaluation
                return fn(*a, **kw)
            torch.cuda.synchronize()
            t = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                torch.cuda.synchronize()
                stats[parts[name]] += time.perf_counter() - t
        return wrapper

    def run_chunks(cfg, start_step, step_fn, on_boundary, **kw):
        chunk = {"start": None, "n": 0}

        def step(s):
            if chunk["start"] is None:
                chunk["t"] = time.perf_counter()
                chunk["start"] = torch.cuda.Event(enable_timing=True)
                chunk["start"].record()
                torch.cuda.set_sync_debug_mode("error")
            chunk["n"] += 1
            return step_fn(s)

        def boundary(step_no, metrics):
            stats["enqueue_s"] += time.perf_counter() - chunk["t"]
            torch.cuda.set_sync_debug_mode("default")
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            stats["chunks"].append((chunk["start"], end, chunk["n"]))
            chunk.update(start=None, n=0)
            tr = cfg.TRAIN
            if not (step_no % tr.LOG_INTERVAL == 0 or step_no
                    % tr.EVAL_INTERVAL == 0 or step_no == tr.NUM_STEPS - 1):
                # A chunk end that logs, evaluates and saves nothing (every
                # step at STEPS_PER_DISPATCH=1): no synchronisation, so the
                # next chunk queues behind this one as in an untimed run.
                on_boundary(step_no, metrics)
                return
            t = time.perf_counter()
            stats["in_boundary"] = True
            try:
                on_boundary(step_no, metrics)
                torch.cuda.synchronize()
            finally:
                stats["in_boundary"] = False
            stats["boundary_s"] += time.perf_counter() - t

        t = time.perf_counter()
        try:
            originals["_run_chunks"](cfg, start_step, step, boundary, **kw)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        stats["loop_s"] += time.perf_counter() - t

    for name in parts:
        setattr(T, name, timed(name))
    T._run_chunks = run_chunks
    try:
        yield
    finally:
        for name, fn in originals.items():
            setattr(T, name, fn)
        torch.cuda.set_sync_debug_mode("default")


def profiled_steps(cfg, model, batches, dt=1.0):
    """``make_train_step`` over ``batches`` (tensors on the card) under
    ``torch.profiler``, after one warm step: the window's host seconds and
    the card's kernel seconds (the sum of the kernels' self device time;
    one stream, so they do not overlap), and their ratio, the card's busy
    share. None where the profiler saw no device time."""
    from torch.profiler import ProfilerActivity, profile

    from kmpc_tpu_torch.train import loop as T

    state = T.TrainState(model, T.build_optimizer(cfg, model))
    step = T.make_train_step(cfg, model, dt)
    step(state, batches[0])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for b in batches:
            step(state, b)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    # The kernels' own entries (Kineto gives them the CUDA device type; the
    # operators that launched them carry the same time again).
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    device_us = sum(e.self_device_time_total for e in kernels)
    n = len(batches)
    return {"steps": n, "wall_ms_per_step": 1e3 * wall / n,
            "device_ms_per_step": device_us / 1e3 / n if device_us else None,
            "device_busy_share": device_us / 1e6 / wall if device_us else None,
            "kernels_per_step": sum(e.count for e in kernels) / n}


def train_run(flags, label, root=None):
    """``python -m kmpc_tpu_torch.train`` with ``flags`` (the CLI's config
    function, then ``train`` on the card), timed by ``timed_training``.
    Every logged training loss must be finite. Returns (config, state,
    run directory, the run's numbers)."""
    from kmpc_tpu_torch.train import loop as T
    from kmpc_tpu_torch.train.__main__ import config_from_args, parse_args

    cfg = config_from_args(parse_args(flags))
    stats = {}
    t0 = time.perf_counter()
    with timed_training(stats):
        state, _, run_dir = T.train(cfg, log_dir=str((root or TRAIN_DIR)
                                                     / label),
                                    verbose=False, device="cuda")
    wall = time.perf_counter() - t0
    steps = sum(n for _, _, n in stats["chunks"])
    assert steps == cfg.TRAIN.NUM_STEPS == state.step, (steps, state.step)
    chunk_ms = sum(a.elapsed_time(b) for a, b, _ in stats["chunks"])
    hist = [json.loads(line) for line in open(run_dir / "metrics_history.jsonl")]
    losses = [e["value"] for e in hist if e["name"] == "train/loss"]
    assert losses and np.all(np.isfinite(losses)), f"{label}: losses {losses}"
    last = {e["name"]: e["value"] for e in hist}
    res = {
        "steps": steps, "chunks": len(stats["chunks"]),
        "steps_per_dispatch": cfg.TRAIN.STEPS_PER_DISPATCH,
        "batch": cfg.TRAIN.BATCH_SIZE, "ms_per_step": chunk_ms / steps,
        "enqueue_ms_per_step": 1e3 * stats["enqueue_s"] / steps,
        "steps_per_s": steps / stats["loop_s"],
        "steps_per_s_chunks": steps / (chunk_ms / 1e3),
        "loop_s": stats["loop_s"], "train_s": wall,
        "host_s": stats["boundary_s"],
        "host_share": stats["boundary_s"] / stats["loop_s"],
        **{k: stats[k] for k in ("spectrum_s", "eval_s", "checkpoint_s")},
        "first_loss": losses[0], "final_loss": losses[-1],
        "final": {k: v for k, v in last.items()
                  if k.startswith(("train/", "eval/", "val/"))},
    }
    return cfg, state, run_dir, res


def served_from_last(run_dir, state, x):
    """The run's last checkpoint read back through ``load_jax_checkpoint``
    (a directory holding only the run's config.json and last/): its model's
    ``fn(x)`` must equal the model in memory's bit for bit."""
    import shutil

    from kmpc_tpu_torch.utils.params import load_jax_checkpoint

    view = run_dir.parent / (run_dir.name + "_last")
    view.mkdir()
    shutil.copy(run_dir / "config.json", view / "config.json")
    (view / "last").symlink_to(run_dir / "last")
    _, served, step = load_jax_checkpoint(view, device="cuda")
    assert step == state.step, (step, state.step)
    state.model.eval()
    with torch.no_grad():
        a, b = x(state.model), x(served)
    assert torch.equal(a, b), (a - b).abs().max().item()
    return step


def phase_train_path(seed: int):
    """The training path at full width on the card: ``finance_sparse``
    (observation 400, encoder 400-1024-1024-1024, K 1024 x 1024, batch 64,
    the sequence loss at L=10, 25 steps a dispatch) held for its first
    steps against the port on the CPU and profiled over 24 more, then 1000
    steps through the CLI's config function, its checkpoint served back
    bit for bit, and one
    Jacobi sweep of Koopman-MPC from the trained run through kernel A's
    row layout; ``lista`` (2048 codes, 10 loops, linear encoder) on
    duffing at its preset batch, held the same way and profiled over 9
    steps, then 101 steps; and
    ``generic`` on duffing for 6."""
    import shutil

    from kmpc_tpu_torch.backtest.engine import (
        KoopmanMPCStrategy, run_backtest_parallel,
    )
    from kmpc_tpu_torch.data.finance import load_finance_data
    from kmpc_tpu_torch.data.systems import make_system
    from kmpc_tpu_torch.models.koopman import make_model
    from kmpc_tpu_torch.ops import mpc_cuda as M
    from kmpc_tpu_torch.ops.rollout import predict_returns
    from kmpc_tpu_torch.run_experiment import backtest_settings
    from kmpc_tpu_torch.train import loop as T
    from kmpc_tpu_torch.train.__main__ import config_from_args, parse_args
    from kmpc_tpu_torch.utils.params import load_jax_checkpoint

    t_phase = time.perf_counter()
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    out = {}

    # finance_sparse: the hold, the run, the served checkpoint, a sweep.
    flags = ["--config", "finance_sparse", "--num_steps", "1000",
             "--seed", str(seed)]
    cfg = config_from_args(parse_args(flags))
    fd = load_finance_data(cfg, device=dev)
    assert fd.observation_size == 400 and cfg.MODEL.TARGET_SIZE == 1024
    model = make_model(cfg, fd.observation_size, device=dev).init_params(
        torch.Generator(device=dev).manual_seed(seed))
    L = cfg.TRAIN.SEQUENCE_LENGTH
    batches = [fd.batch_at(torch.tensor(
        rng.integers(0, fd.num_examples("train", L), cfg.TRAIN.BATCH_SIZE),
        device=dev), "train", L) for _ in range(TRAIN_HOLD_STEPS)]
    hold = hold_train_steps(cfg, model, batches)
    prof = profiled_steps(cfg, model, batches * 8)
    cfg, state, run_dir, res = train_run(flags, "finance_sparse")
    evals = json.loads((run_dir / "evaluation_results.json").read_text())
    for k in ("mean_mse_reencode", "mean_mse_no_reencode", "best_mse"):
        assert np.isfinite(evals[k]), (k, evals[k])
    bt, mpc = backtest_settings(cfg)
    served_step = served_from_last(run_dir, state, lambda m: predict_returns(
        m, fd.test, bt.HORIZON, fd.n_assets, fd.mean, fd.std))
    _, best, best_step = load_jax_checkpoint(run_dir, device=dev)
    strat = KoopmanMPCStrategy(model=best, mpc=mpc)
    timed = Timed("KoopmanMPC", strat, mpc.max_turnover)
    kernel = M._route(None, bt.HORIZON, fd.n_assets, mpc)[2]
    assert kernel is M.PDHG_LOG_UTILITY_ROWS, kernel.name
    kernel.launches = 0
    df = run_backtest_parallel(strat, fd, bt, num_sweeps=1)
    assert kernel.launches == 1, kernel.launches
    assert np.all(np.isfinite(df[["portfolio_value", "return", "turnover",
                                  "cost"]].to_numpy()))
    out["finance_sparse"] = {
        "model": "GenericKM 400-1024-1024-1024, K 1024, decoder linear",
        "sequence_length": L, "hold": hold, "profiled": prof, **res,
        "eval": {k: evals[k] for k in (
            "mean_mse_reencode", "mean_mse_no_reencode",
            "final_mse_reencode", "final_mse_no_reencode", "best_mode",
            "best_mse")},
        "served_step": served_step, "best_step": best_step,
        "sweep": {"kernel": kernel.name, "launches": 1, "dates": len(df),
                  "solve_ms": 1e3 * timed.solve_s[0],
                  "final_value": float(df["portfolio_value"].iloc[-1])}}

    # lista on duffing at full width: the hold, then 101 steps.
    flags = ["--config", "lista", "--env", "duffing", "--num_steps", "101",
             "--seed", str(seed), "--no_final_eval"]
    cfg = config_from_args(parse_args(flags))
    system = make_system(cfg)
    model = make_model(cfg, system.observation_size, device=dev).init_params(
        torch.Generator(device=dev).manual_seed(seed))
    assert model.target_size == 2048 and model.lista.num_loops == 10
    gen = torch.Generator().manual_seed(seed)
    batches = []
    for _ in range(TRAIN_HOLD_STEPS):
        x = system.reset(gen, cfg.TRAIN.BATCH_SIZE)
        batches.append((x.to(dev), system.step(x).to(dev)))
    hold = hold_train_steps(cfg, model, batches, dt=system.dt)
    prof = profiled_steps(cfg, model, batches * 3, dt=system.dt)
    cfg, state, run_dir, res = train_run(flags, "lista")
    probe = batches[0][0]
    served_step = served_from_last(run_dir, state, lambda m: m.step_env(probe))
    out["lista"] = {"model": "LISTAKM 2048 codes, 10 loops, linear encoder",
                    "env": "duffing", "hold": hold, "profiled": prof, **res,
                    "served_step": served_step}

    # generic on duffing, a few steps.
    _, _, _, res = train_run(["--config", "generic", "--env", "duffing",
                              "--num_steps", "6", "--seed", str(seed),
                              "--no_final_eval"], "generic")
    out["generic"] = res
    emit("train_path", card=smi_line(), **out,
         elapsed_s=time.perf_counter() - t_phase)
    return out


EVAL_DIR = ROOT / "runs" / "chip_smoke_eval"
# bfloat16, card vs CPU: step 1's metrics, |d| / max(|ref|, 1); the port
# against kmpc_tpu's bfloat16 on the CPU is 0 to 1.3e-7 apart, a model
# computing in float32 1.0e-3 to 5.1e-3 (tests/test_torch_port_bf16_ode.py).
BF16_REL = 1e-4
# Step 1's gradients card vs CPU per tensor, |d| / |ref| over the tensor:
# float32 compute reads 1.4e-2 and more from bfloat16 on some tensor of
# every case on the CPU, bfloat16 against kmpc_tpu's at most 4.3e-3.
BF16_GRAD_REL = 1e-2
BF16_F32_REL = 0.05    # bfloat16 loss against float32's
ODE_REL = 1e-4         # the latent ODE against float64 expm, relative
EVAL_MSE_REL = 1e-4    # an evaluation mode's horizon-100 MSE, card vs CPU
# A sweep member's loss against its single run, |d| / max(|ref|, 1). In
# bfloat16 vmap's batched product sums in another order than a single run's
# and the rounding to bfloat16 parts them: 6.4e-5 over 20 steps, 1.2e-7 in
# float32 (on the H100); ``nearest_other_single_rel`` reads how far a
# member is from the single run with another coefficient.
SWEEP_LOSS_TOL = {"float32": 1e-5, "bfloat16": 1e-3}


def _near(a, b, rel) -> bool:
    return abs(a - b) <= rel * max(abs(b), 1.0)


def uncounted(fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` with every kernel's launch count left as it
    was before: the launches a hold makes to compare a kernel with its
    plain version do not count as the path's."""
    from kmpc_tpu_torch.ops import mpc_cuda as M

    counters = kernel_counters()
    saved = {k: c.launches for k, c in counters.items()}
    storage = dict(M.STORAGE_LAUNCHES)
    try:
        return fn(*args, **kwargs)
    finally:
        for k, c in counters.items():
            c.launches = saved[k]
        M.STORAGE_LAUNCHES.clear()
        M.STORAGE_LAUNCHES.update(storage)


def _bf16_step1(cfg, model, batch):
    """Step 1 of ``model`` (bfloat16 compute) on ``batch``, on the card and
    on the CPU from the same weights: its six metrics {name: (card, cpu)};
    per parameter the gradient's distance card to CPU (norm of the
    difference over the CPU's norm); and beside it the distance of the
    float32-compute gradient on the card to the CPU's bfloat16 one (what a
    model that did not compute in bfloat16 reads)."""
    import copy

    from kmpc_tpu_torch.models.koopman import make_model

    cfg32 = copy.deepcopy(cfg)
    cfg32.TRAIN.DTYPE = "float32"
    weights = model.state_dict()
    sides = {}
    for label, c, dev in (("card", cfg, "cuda"), ("cpu", cfg, "cpu"),
                          ("float32", cfg32, "cuda")):
        m = model if label == "card" else make_model(
            c, model.observation_size, device=dev)
        m.load_state_dict({k: v.to(dev) for k, v in weights.items()})
        m.zero_grad(set_to_none=True)
        loss, metrics = m.loss_sequence(batch.to(dev))
        loss.backward()
        sides[label] = ({k: v.item() for k, v in metrics.items()},
                        {n: p.grad for n, p in m.named_parameters()})
        m.zero_grad(set_to_none=True)
    (mk, gk), (mc, gc), (_, g32) = sides["card"], sides["cpu"], \
        sides["float32"]
    return ({k: (mk[k], mc[k]) for k in mc},
            {n: _rel_norm(gk[n], gc[n]) for n in gc},
            {n: _rel_norm(g32[n], gc[n]) for n in gc})


class _OutDtypeMm(torch.autograd.Function):
    """a [M, k] @ b [k, n] of bfloat16 operands as one bfloat16 GEMM with a
    float32 output (``torch.mm(..., out_dtype=torch.float32)``, which has
    no derivative in torch 2.11), the gradients by the same GEMMs of the
    incoming gradient cast to bfloat16: the tensor-core route for the
    port's bfloat16 products, timed by ``_bf16_routes`` against the one the
    port takes."""

    @staticmethod
    def forward(a, b):
        return torch.mm(a, b, out_dtype=torch.float32)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = g.to(a.dtype)
        return (torch.mm(g, b.T, out_dtype=torch.float32).to(a.dtype),
                torch.mm(a.T, g, out_dtype=torch.float32).to(b.dtype))


def _out_dtype_matmul(a, b):
    out = _OutDtypeMm.apply(a.reshape(-1, a.shape[-1]), b)
    return out.reshape(*a.shape[:-1], b.shape[-1])


@contextlib.contextmanager
def _out_dtype_products():
    """While it lasts, the port's bfloat16 products are ``_OutDtypeMm``
    GEMMs instead of ``matmul_f32``'s float32 products of the operands cast
    up (the same sums)."""
    from kmpc_tpu_torch.models import koopman, lista, mlp

    saved = [(m, m.matmul_f32) for m in (koopman, lista, mlp)]
    for m, _ in saved:
        m.matmul_f32 = _out_dtype_matmul
    try:
        yield
    finally:
        for m, f in saved:
            m.matmul_f32 = f


def _bf16_routes(cfg, model, batch, steps=10):
    """The bfloat16 products of ``finance_sparse``'s training step two ways
    on the card: ``matmul_f32`` (the port's route: the float32 product of
    the operands cast up) against one bfloat16 GEMM with a float32 output
    (``_OutDtypeMm``). Forward and backward of each product shape (the
    encoder's and the decoder's layers on the batch's frames, z @ K on the
    batch), ms each; then the whole training step from copies of the
    model, ``steps`` steps a round in the order port, GEMM, GEMM, port, ms
    a step each."""
    import copy

    from kmpc_tpu_torch.models.mlp import matmul_f32
    from kmpc_tpu_torch.train import loop as T

    bf, dev = torch.bfloat16, batch.device
    frames = batch.shape[0] * batch.shape[1]
    shapes = [(frames, lin.in_features, lin.out_features) for lin in
              model.encoder.linears() + model.decoder.linears()]
    shapes.append((batch.shape[0], model.target_size, model.target_size))
    gemms = {}
    for M_, k, n in dict.fromkeys(shapes):
        a = torch.randn(M_, k, device=dev, dtype=bf, requires_grad=True)
        b = torch.randn(k, n, device=dev, dtype=bf, requires_grad=True)
        g = torch.randn(M_, n, device=dev)

        def run(f):
            f(a, b).backward(g)

        gemms[f"{M_}x{k}x{n}"] = {
            "cast_up_ms": cuda_ms(lambda: run(matmul_f32), 20),
            "out_dtype_ms": cuda_ms(lambda: run(_out_dtype_matmul), 20)}

    def timed_round(route):
        m = copy.deepcopy(model)
        state = T.TrainState(m, T.build_optimizer(cfg, m))
        step = T.make_train_step(cfg, m, 1.0)
        with route():
            step(state, batch)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(steps):
                step(state, batch)
            end.record()
            torch.cuda.synchronize()
        return start.elapsed_time(end) / steps

    rounds = {"cast_up": [], "out_dtype": []}
    for name in ("cast_up", "out_dtype", "out_dtype", "cast_up"):
        rounds[name].append(timed_round(
            _out_dtype_products if name == "out_dtype"
            else contextlib.nullcontext))
    return {"gemm_fwd_bwd": gemms,
            "gemm_total_ms": {r: sum(v[f"{r}_ms"] for v in gemms.values())
                              for r in ("cast_up", "out_dtype")},
            "step_ms": rounds}


def _ode_hold(seed, dev):
    """``rollout_sequence_ode`` at ``generic``'s width (64 latents, encoder
    2-64-64-64) on duffing with a random K (scaled to spectral radius about
    0.5), both methods, against the latents z0 expm(K t) in float64 on the
    CPU, and the decode of those."""
    import scipy.linalg

    from kmpc_tpu_torch.config import get_config
    from kmpc_tpu_torch.data.systems import make_system
    from kmpc_tpu_torch.models.koopman import make_model

    cfg = get_config("generic")
    system = make_system(cfg, "duffing")
    model = make_model(cfg, system.observation_size, device=dev).init_params(
        torch.Generator(device=dev).manual_seed(seed))
    z = cfg.MODEL.TARGET_SIZE
    rng = np.random.default_rng(seed)
    K = rng.standard_normal((z, z)) * 0.5 / np.sqrt(z)
    with torch.no_grad():
        model.kmat.copy_(torch.as_tensor(K, dtype=torch.float32))
        x0 = system.reset(torch.Generator(device=dev).manual_seed(seed), 64)
        z0 = model.encode(x0).double().cpu().numpy()
    steps, dt = 50, system.dt
    ref = np.stack([z0 @ scipy.linalg.expm(K.astype(np.float32).astype(
        np.float64) * (i * np.float32(dt))) for i in range(steps + 1)])
    out = {"latent": z, "steps": steps, "dt": dt}
    for method in ("dopri5", "rk4"):
        t0 = time.perf_counter()
        with torch.no_grad():
            t_span = torch.arange(steps + 1, dtype=torch.float32,
                                  device=dev) * dt
            zt = model.integrate_latent_ode(model.encode(x0), t_span, method)
            xt = model.rollout_sequence_ode(x0, steps, dt, method)
            xr = model.decode(torch.as_tensor(ref, dtype=torch.float32,
                                              device=dev))
        torch.cuda.synchronize()
        err = float(np.abs(zt.double().cpu().numpy() - ref).max()
                    / np.abs(ref).max())
        derr = float(((xt - xr).abs().max() / xr.abs().max()).item())
        out[method] = {"latent_rel_err": err, "decoded_rel_err": derr,
                       "s": time.perf_counter() - t0}
        assert zt.dtype == torch.float32 and xt.shape == (steps + 1, 64, 2)
        assert err <= ODE_REL and derr <= ODE_REL, (method, err, derr)
    return out


def _eval_hold(seed, env, dev):
    """``train_system(final_eval=True)`` for 4 steps of ``generic`` on
    ``env`` on the card (EvaluationSettings' defaults: horizons 100 and
    1000, batch 100, periods 10/25/50/100; the basin grid on lyapunov),
    then the best checkpoint's evaluation on the CPU from the same weights
    and initial states at horizon 100: each mode's ``num_valid`` equal and
    its MSE within EVAL_MSE_REL where both are finite."""
    from kmpc_tpu_torch.config import get_config
    from kmpc_tpu_torch.data.systems import make_system
    from kmpc_tpu_torch.eval.evaluation import (
        EvaluationSettings, _evaluate_system, initial_states,
    )
    from kmpc_tpu_torch.models.koopman import make_model
    from kmpc_tpu_torch.train import loop as T
    from kmpc_tpu_torch.utils.params import params_from_checkpoint

    cfg = get_config("generic")
    cfg.ENV.ENV_NAME, cfg.SEED = env, seed
    cfg.TRAIN.NUM_STEPS = 4
    t0 = time.perf_counter()
    _, _, run_dir = T.train_system(cfg, log_dir=str(EVAL_DIR / env),
                                   verbose=False, final_eval=True,
                                   device=dev)
    torch.cuda.synchronize()
    train_eval_s = time.perf_counter() - t0
    card = json.loads((run_dir / "evaluation_results_best.json")
                      .read_text())[env]
    assert json.loads((run_dir / "evaluation_results_last.json")
                      .read_text())[env]["modes"]
    settings = EvaluationSettings(systems=(env,))
    system = make_system(cfg, env)
    x0 = initial_states(system, cfg, settings, dev).cpu()
    model = make_model(cfg, system.observation_size, device="cpu")
    model.load_state_dict(params_from_checkpoint(run_dir / "checkpoint")[0])
    short = EvaluationSettings(systems=(env,), horizons=(100,))
    cpu = _evaluate_system(model.eval(), system, short, x0, None, False)
    held, worst = 0, 0.0
    for mode, m in cpu["modes"].items():
        a, b = card["modes"][mode]["horizons"]["100"], m["horizons"]["100"]
        assert a["num_valid"] == b["num_valid"], (env, mode, a, b)
        if np.isfinite(a["mean"]) and np.isfinite(b["mean"]):
            rel = abs(a["mean"] - b["mean"]) / max(abs(b["mean"]), 1e-30)
            worst = max(worst, rel)
            assert rel <= EVAL_MSE_REL, (env, mode, a["mean"], b["mean"])
            held += 1
    out = {"train_and_eval_s": train_eval_s, "modes_held": held,
           "max_mse_rel_vs_cpu": worst,
           "h100_mse": {k: v["horizons"]["100"]["mean"]
                        for k, v in card["modes"].items()},
           "h1000_mse": {k: v["horizons"]["1000"]["mean"]
                         for k, v in card["modes"].items()},
           "best_periodic": card["best_periodic"],
           "figures": len(card["files"])}
    if env == "lyapunov":
        basins = card["basins"]
        assert len(basins["true_assignment"]) == 225
        out["basins"] = {k: basins[k] for k in ("agreement", "grid_n",
                                                "steps")}
        out["basins"]["true_attractors"] = len(basins["true_attractors"])
    return out


def _sweep_hold(seed, dev, dtype, steps, coefficients=(0.0, 1e-3, 1e-2, 0.1)):
    """``generic_sparse`` on duffing in ``dtype``: the sweep's members (one
    stacked AdamW, vmap over the coefficients) against single runs with
    each coefficient from the same weights on the same batches, every
    step's loss within SWEEP_LOSS_TOL[dtype]."""
    import copy

    from kmpc_tpu_torch import stream_seed
    from kmpc_tpu_torch.config import get_config
    from kmpc_tpu_torch.data.systems import make_system
    from kmpc_tpu_torch.models.koopman import make_model
    from kmpc_tpu_torch.train import loop as T
    from kmpc_tpu_torch.train import sweep as W

    cfg = get_config("generic_sparse")
    cfg.ENV.ENV_NAME, cfg.SEED = "duffing", seed
    cfg.TRAIN.DTYPE = dtype
    system = make_system(cfg)
    model = make_model(cfg, system.observation_size, device=dev)
    state = W.stack_states(cfg, model, torch.Generator(device=dev)
                           .manual_seed(seed), len(coefficients))
    coeffs = torch.tensor(coefficients, dtype=torch.float32, device=dev)
    singles = []
    for c in coefficients:
        cc = copy.deepcopy(cfg)
        cc.MODEL.SPARSITY_COEFF = c
        m = make_model(cc, system.observation_size, device=dev)
        m.load_state_dict(W.member(state, 0))
        singles.append((T.TrainState(m, T.build_optimizer(cc, m)),
                        T.make_system_train_step(cc, m, system)))
    fused = W.make_fused_sweep_step(cfg, model, system)
    gen = torch.Generator(device=dev)
    sweep_losses, single_losses = [], []
    t0 = time.perf_counter()
    for s in range(steps):
        _, metrics = fused(state, s, coeffs)
        sweep_losses.append(metrics["loss"])
    torch.cuda.synchronize()
    sweep_s = time.perf_counter() - t0
    for s in range(steps):
        row = []
        for st, fn in singles:
            gen.manual_seed(stream_seed(cfg.SEED, T._DATA, s))
            row.append(fn(st, gen)[1]["loss"])
        single_losses.append(torch.stack(row))
    a = torch.stack(sweep_losses).double().cpu()
    b = torch.stack(single_losses).double().cpu()
    rel = ((a[:, :, None] - b[:, None, :]).abs()
           / b[:, None, :].abs().clamp_min(1.0)).amax(dim=0)  # [member, single]
    dev_rel = rel.diagonal().max().item()
    other = rel.masked_fill(torch.eye(len(coefficients), dtype=torch.bool),
                            float("inf"))
    assert dev_rel <= SWEEP_LOSS_TOL[dtype], (dtype, dev_rel)
    dparams = max((W.member(state, i)[k] - st.model.state_dict()[k])
                  .abs().max().item()
                  for i, (st, _) in enumerate(singles)
                  for k in state.params)
    return {"dtype": dtype, "coefficients": list(coefficients),
            "steps": steps, "max_loss_rel_vs_single": dev_rel,
            "nearest_other_single_rel": other.min().item(),
            "max_abs_param_diff_vs_single": dparams,
            "ms_per_sweep_step": 1e3 * sweep_s / steps}


def phase_eval_path(seed: int):
    """The training and evaluation entry points past ``train_path``, at the
    presets' full widths on the card (weights from ``seed``):

    - ``finance_sparse`` with ``--dtype bfloat16``: step 1's six metrics
      on the card within BF16_REL of the port's bfloat16 on the CPU, its
      gradients within BF16_GRAD_REL; the products' two routes timed
      (``_bf16_routes``); then 100 steps of it and of float32 through the
      CLI's config function, the bfloat16 run's first loss and final
      validation loss within BF16_F32_REL of float32's, ms a step of each;
    - the latent ODE (``_ode_hold``);
    - the evaluation suite after ``train_system(final_eval=True)`` on
      duffing and lyapunov (``_eval_hold``);
    - the sparsity sweep in float32 and in bfloat16 (``_sweep_hold``),
      then ``run_sparsity_sweep``;
    - a reference checkpoint: the float32 run's weights and AdamW written
      in the reference's layout, ``run_experiment --torch_ckpt`` on it
      in-process (every batched solve through its kernel; the served
      model's forecasts bit-equal to the trained one's; its Koopman-MPC
      first solve held against the plain version as ``main_path`` holds
      it), and ``train`` resumed from it for 10 steps;
    - ``examples/full_pipeline.py`` at 20 training steps and 2 sweeps,
      its two batches of 1024 problems and its backtest's first solves
      held against the plain version on the same inputs.

    Every kernel the phase launches is held at one of its shapes here;
    the holds' own launches are not counted (``uncounted``). Returns the
    phase's launches by kernel (counted from 0 here) and the held
    cases."""
    import shutil

    from kmpc_tpu_torch import run_experiment as RE
    from kmpc_tpu_torch.backtest.engine import KoopmanMPCStrategy
    from kmpc_tpu_torch.config import get_config
    from kmpc_tpu_torch.data.finance import load_finance_data
    from kmpc_tpu_torch.examples import full_pipeline
    from kmpc_tpu_torch.models.koopman import make_model
    from kmpc_tpu_torch.ops import mpc_cuda as M
    from kmpc_tpu_torch.ops.rollout import predict_returns
    from kmpc_tpu_torch.train import loop as T
    from kmpc_tpu_torch.train import sweep as W
    from kmpc_tpu_torch.train.__main__ import config_from_args, parse_args
    from kmpc_tpu_torch.utils.torch_import import (
        load_torch_checkpoint, save_reference_checkpoint,
    )

    t_phase = time.perf_counter()
    shutil.rmtree(EVAL_DIR, ignore_errors=True)
    EVAL_DIR.mkdir(parents=True)
    dev = torch.device("cuda")
    kernels = reset_counts()
    out = {}

    # bfloat16 at full width: step 1 against the CPU, then 100 steps of
    # each dtype.
    base = ["--config", "finance_sparse", "--num_steps", "100",
            "--seed", str(seed)]
    cfg16 = config_from_args(parse_args(base + ["--dtype", "bfloat16"]))
    fd = load_finance_data(cfg16, device=dev)
    model = make_model(cfg16, fd.observation_size, device=dev).init_params(
        torch.Generator(device=dev).manual_seed(seed))
    L = cfg16.TRAIN.SEQUENCE_LENGTH
    rng = np.random.default_rng(seed)
    batch = fd.batch_at(torch.tensor(rng.integers(
        0, fd.num_examples("train", L), cfg16.TRAIN.BATCH_SIZE), device=dev),
        "train", L)
    step1, grad_rel, grad_rel_f32 = _bf16_step1(cfg16, model, batch)
    far = {k: v for k, v in step1.items() if not _near(*v, BF16_REL)}
    assert not far, f"bfloat16 step 1 apart from the CPU's: {far}"
    far = {k: v for k, v in grad_rel.items() if v > BF16_GRAD_REL}
    assert not far, f"bfloat16 step 1's gradients apart from the CPU's: {far}"
    routes = _bf16_routes(cfg16, model, batch)
    runs = {}
    for label, flags in (("float32", base),
                         ("bfloat16", base + ["--dtype", "bfloat16"])):
        cfg, state, run_dir, res = train_run(flags, f"eval_{label}",
                                             root=EVAL_DIR)
        hist = [json.loads(x) for x in open(run_dir / "metrics_history.jsonl")]
        val = [e["value"] for e in hist if e["name"] == "val/loss"]
        runs[label] = (cfg, state, run_dir, res, val[-1])
    r16, r32 = runs["bfloat16"], runs["float32"]
    assert _near(r16[3]["first_loss"], r32[3]["first_loss"], BF16_F32_REL), \
        (r16[3]["first_loss"], r32[3]["first_loss"])
    assert _near(r16[4], r32[4], BF16_F32_REL), (r16[4], r32[4])
    out["bfloat16"] = {
        "step1_card_vs_cpu": step1,
        "max_step1_rel": max(abs(a - b) / max(abs(b), 1.0)
                             for a, b in step1.values()),
        "step1_grad_rel_card_vs_cpu": grad_rel,
        "step1_grad_rel_float32_compute_vs_cpu": grad_rel_f32,
        "products": routes,
        **{f"{k}_{label}": runs[label][3][k] for label in runs
           for k in ("ms_per_step", "enqueue_ms_per_step", "first_loss",
                     "steps_per_s")},
        "final_val_loss_float32": r32[4], "final_val_loss_bfloat16": r16[4],
        "card": smi_line()}

    out["ode"] = _ode_hold(seed, dev)
    out["evaluation"] = {env: _eval_hold(seed, env, dev)
                         for env in ("duffing", "lyapunov")}
    out["sweep"] = {dtype: _sweep_hold(seed, dev, dtype, steps)
                    for dtype, steps in (("float32", 50), ("bfloat16", 20))}
    sweep_cfg = get_config("generic_sparse")
    sweep_cfg.ENV.ENV_NAME, sweep_cfg.SEED = "duffing", seed
    sweep_cfg.TRAIN.NUM_STEPS = 50
    coefficients = out["sweep"]["float32"]["coefficients"]
    t0 = time.perf_counter()
    results, _ = W.run_sparsity_sweep(sweep_cfg, coefficients,
                                      log_dir=str(EVAL_DIR / "sweep"),
                                      verbose=False, device=dev)
    assert len(results["no_reencode_mse"]) == len(coefficients)
    assert all(0.0 <= r <= 1.0 for r in results["sparsity_ratio"])
    out["sweep"]["run_sparsity_sweep"] = {
        "s": time.perf_counter() - t0, "results": results}

    # The float32 run as a reference checkpoint, served and resumed.
    cfg, state, run_dir, _, _ = r32
    pt = EVAL_DIR / "reference" / "checkpoint.pt"
    pt.parent.mkdir()
    save_reference_checkpoint(pt, state.model, cfg, step=state.step,
                              optimizer=state.optimizer,
                              finance_metadata=fd.metadata)
    ckpt = load_torch_checkpoint(str(pt), device=dev)
    bt, mpc = RE.backtest_settings(cfg)
    state.model.eval()
    with torch.no_grad():
        served = predict_returns(ckpt["model"], fd.test, bt.HORIZON,
                                 fd.n_assets, fd.mean, fd.std)
        trained = predict_returns(state.model, fd.test, bt.HORIZON,
                                  fd.n_assets, fd.mean, fd.std)
    assert torch.equal(served, trained), (served - trained).abs().max().item()
    rows = M.PDHG_LOG_UTILITY_ROWS
    before = rows.launches
    t0 = time.perf_counter()
    table = RE.main(["--torch_ckpt", str(pt), "--sweeps", "1",
                     "--output", str(EVAL_DIR / "reference")])
    experiment_s = time.perf_counter() - t0
    assert rows.launches - before == 2, rows.launches - before  # DMD, KMPC
    assert all(np.isfinite(v) for row in table.values() for v in row.values())
    n_dates = fd.test.shape[0] - fd.sequence_length - bt.HORIZON
    aux = KoopmanMPCStrategy(model=ckpt["model"], mpc=mpc).precompute(
        fd, bt.HORIZON)
    r = torch.exp(aux["pred_log_returns"][:n_dates]).contiguous()
    cw = torch.full((n_dates, fd.n_assets), 1.0 / fd.n_assets, device=dev)
    first = uncounted(compare_tensors, "torch_ckpt_first_solve", cw, r, mpc,
                      time_reps=3, time_plain=False)
    held = [first]
    resume_cfg = config_from_args(parse_args(
        ["--config", "finance_sparse", "--num_steps", str(state.step + 10),
         "--seed", str(seed)]))
    resumed, _, _ = T.train(resume_cfg, log_dir=str(EVAL_DIR / "resumed"),
                            checkpoint_path=str(pt), verbose=False,
                            device="cuda")
    assert resumed.step == state.step + 10, resumed.step
    out["torch_ckpt"] = {
        "step": ckpt["step"], "forecasts_bit_equal": True,
        "experiment_s": experiment_s, "metrics": table,
        "first_solve": {k: first[k] for k in (
            "kernel", "B", "max_abs_dw", "max_abs_dobj", "kernel_ms")},
        "resumed_to": resumed.step}

    t0 = time.perf_counter()
    pipe = full_pipeline.main(["--steps", "20", "--sweeps", "2"])
    pipe_s = time.perf_counter() - t0
    launches = {k: c.launches for k, c in kernels.items() if c.launches}
    for k in ("deterministic", "scenario_kelly"):
        assert pipe[k]["finite"] and pipe[k]["sum_err"] <= FEAS_TOL, pipe[k]
    assert all(np.isfinite(v["Final Value"]) for v in pipe["metrics"].values())
    # Its solves held against the plain version on the same inputs: step
    # 4's two batches of 1024 problems, and the backtest's first solves.
    cw, ys, yss = pipe["problems"]
    for label, y in (("full_pipeline_deterministic", ys),
                     ("full_pipeline_scenarios", yss)):
        held.append(uncounted(compare_tensors, label, cw, torch.exp(y),
                              pipe["mpc"], time_reps=1, time_plain=False))
    strategies, pfd = pipe["strategies"], pipe["fd"]
    mv_mpc = strategies["Markowitz"].mpc
    names = ("DMD", "KoopmanMPC", "ScenarioKelly", "Markowitz")
    reach = {n: strategy_kernel(n, pipe["mpc"], mv_mpc, pfd.n_assets,
                                strategies["ScenarioKelly"].num_scenarios)
             for n in names}
    for name in names:
        held += uncounted(first_solves, {"fd": pfd}, strategies, pipe["mpc"],
                          mv_mpc, pipe["bt"], (name,),
                          f"full_pipeline_{name}", reach,
                          scenarios=strategies["ScenarioKelly"].num_scenarios
                          ).values()
    out["full_pipeline"] = {
        "s": pipe_s, "losses": pipe["losses"],
        "solves": {k: pipe[k] for k in ("deterministic", "scenario_kelly")},
        "final_values": {k: v["Final Value"]
                         for k, v in pipe["metrics"].items()}}
    out["held"] = [{k: c[k] for k in ("case", "kernel", "B", "max_abs_dw")}
                   for c in held]

    for name in ("pdhg_log_utility_rows", "pdhg_log_utility_scenarios_rows",
                 "pdhg_mean_variance_lanes"):
        assert launches.get(name, 0) > 0, f"{name} never launched"
    unheld = set(launches) - {c["kernel"] for c in held}
    assert not unheld, f"launched here, held at none of its shapes: {unheld}"
    emit("eval_path", **out, launches=launches,
         elapsed_s=time.perf_counter() - t_phase)
    return launches, held


# parallel_path: the world (one rank a card, at most four), the mesh of the
# solves and backtests (kmpc_tpu's factoring of the world) and of training
# (data x model where the world is even), the time limit of the world.
PARALLEL_MAX_RANKS = 4
PARALLEL_TIMEOUT = 420
PARALLEL_TAG = "PARALLEL_RANK_RESULT "
PARALLEL_LOSS_REL = 1e-4   # each train step's loss, sharded vs one process
PARALLEL_KMAT_ATOL = 1e-5  # K after the steps, sharded vs one process
PARALLEL_TRAIN_STEPS = 3


def train_mesh_sizes(world):
    """(data, scenario, model) of the sharded train steps: K and the
    latent products over two model ranks where the world is even."""
    return (world // 2, 1, 2) if world % 2 == 0 else (world, 1, 1)


def _held_pair(label, sharded, whole, program, same_route):
    """A sharded solve against the same call in one process: (w, info)
    each. Where both took the same layout and sweep, the same bits; else
    the packed-kernel bars (mean-variance's for 'mv')."""
    w_tol, obj_tol = ((MV_W_TOL, MV_OBJ_TOL) if program == "mv" else
                      (W_TOL, SCEN_OBJ_TOL if program == "scenario"
                       else OBJ_TOL))
    dw = (sharded[0] - whole[0]).abs().max().item()
    dobj = (sharded[1]["objective"] - whole[1]["objective"]).abs().max().item()
    bits = bool(torch.equal(sharded[0], whole[0])
                and torch.equal(sharded[1]["objective"],
                                whole[1]["objective"]))
    if same_route:
        assert bits, f"{label}: same layout and sweep, other bits ({dw})"
    assert dw <= w_tol and dobj <= obj_tol, (label, dw, dobj)
    return {"max_abs_dw": dw, "max_abs_dobj": dobj, "bits_equal": bits,
            "same_layout_and_sweep": same_route}


def parallel_rank(seed: int) -> None:
    """One rank of ``parallel_path``'s world (started by
    ``phase_parallel_path`` through ``kmpc_tpu_torch.parallel.launch``):
    the mesh code at full width on this rank's card, every launch counted
    from 0; then, on rank 0, the same calls in one process on its card,
    each sharded result held against them. Prints its results as one
    tagged JSON line."""
    import torch.distributed as dist

    from kmpc_tpu_torch.backtest.engine import (
        KoopmanMPCStrategy, run_backtest_parallel,
    )
    from kmpc_tpu_torch import stream_seed
    from kmpc_tpu_torch.config import get_config
    from kmpc_tpu_torch.data.finance import load_finance_data
    from kmpc_tpu_torch.models.koopman import make_model
    from kmpc_tpu_torch.ops import mpc_cuda as M
    from kmpc_tpu_torch.ops import mv_cuda as V
    from kmpc_tpu_torch.ops.mpc import MPCParams
    from kmpc_tpu_torch.parallel import (
        initialize_distributed, make_mesh, make_sharded_train_step,
        sharded_mpc_solver,
    )
    from kmpc_tpu_torch.parallel.dryrun import factor
    from kmpc_tpu_torch.parallel.mesh import full, same_on_every_rank
    from kmpc_tpu_torch.run_experiment import backtest_settings
    from kmpc_tpu_torch.train.loop import (
        _DATA, TrainState, build_optimizer, make_train_step,
    )

    t_rank = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False   # as phase_build sets it
    torch.backends.cudnn.allow_tf32 = False
    initialize_distributed()
    rank, world = dist.get_rank(), dist.get_world_size()
    dev = torch.device("cuda", torch.cuda.current_device())
    assert dev.index == int(__import__("os").environ["LOCAL_RANK"]), dev
    sizes = factor(world)
    mesh = make_mesh(dict(zip(("data", "scenario", "model"), sizes)))
    tsizes = train_mesh_sizes(world)
    tmesh = make_mesh(dict(zip(("data", "scenario", "model"), tsizes)))
    out = {"rank": rank, "world": world, "device": str(dev),
           "card": torch.cuda.get_device_name(dev), "mesh": sizes,
           "train_mesh": tsizes}

    def timed(fn, together=True):
        """(fn(), its milliseconds); ``together``: every rank starts it
        after a barrier (rank 0's one-process references run alone)."""
        if together:
            dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, 1e3 * (time.perf_counter() - t0)

    def on_card(*arrays):
        return [torch.as_tensor(a, device=dev) for a in arrays]

    # The three programs at full width.
    common = dict(sigma_scale=2.0, feas_tol=2e-4, precond=True)
    solves = {
        "log": ("log", MPCParams(max_iters=1000, proj_refresh_every=16,
                                 **common),
                on_card(*instance(65536, 5, 30, 0))),
        "scenario": ("scenario", MPCParams(max_iters=1000, sigma_scale=2.0,
                                           proj_refresh_every=16),
                     on_card(*scenario_instance(4096, 16, 5, 30, 1))),
        "mv": ("mv", mv_settings()["fixed"],
               list(mv_instance_cuda(65536, 1, 30, 1240))),
        "mv_shared": ("mv", mv_settings()["fixed"],
                      on_card(*mv_instance(65536, 1, 30, 1241, shared=True))),
    }
    kernels = reset_counts()
    sharded, ms = {}, {}
    for name, (program, p, args) in solves.items():
        solve = sharded_mpc_solver(mesh, p, use_fused_kernel=True,
                                   program=program)
        sharded[name] = solve(*args)           # also the warm-up
        ms[name] = timed(lambda: solve(*args))[1]

    # The main path's date-sharded Koopman-MPC Jacobi backtest.
    cfg = get_config("finance_sparse")
    cfg.ENV.FINANCE.CACHE_DIR = None
    fd = load_finance_data(cfg, device=dev)
    model = make_model(cfg, fd.observation_size, device=dev)
    model.init_params(torch.Generator(device=dev).manual_seed(seed)).eval()
    bt, mpc = backtest_settings(cfg)
    strat = KoopmanMPCStrategy(model=model, mpc=mpc)
    runs = {"cold": {}, "warm": {"warm_sweeps_iters": 500}}
    hist = {}
    for tag, kw in runs.items():
        hist[tag], ms[f"backtest_{tag}"] = timed(lambda: run_backtest_parallel(
            strat, fd, bt, num_sweeps=2, return_dataframe=False, mesh=mesh,
            **kw))

    # Data- (and tensor-) parallel train steps of finance_sparse.
    B, L = cfg.TRAIN.BATCH_SIZE, cfg.TRAIN.SEQUENCE_LENGTH
    gen = torch.Generator(device=dev)

    def batch(step):
        gen.manual_seed(stream_seed(cfg.SEED, _DATA, step))
        return fd.sample_batch(gen, "train", B, L)

    tmodel = make_model(cfg, fd.observation_size, device=dev)
    tmodel.init_params(torch.Generator(device=dev).manual_seed(seed))
    state = TrainState(tmodel, build_optimizer(cfg, tmodel))
    step = make_sharded_train_step(cfg, tmodel, tmesh)
    losses, step_ms = [], []
    for s in range(PARALLEL_TRAIN_STEPS):
        (state, metrics), t = timed(lambda: step(state, batch(s)))
        losses.append(float(metrics["loss"]))
        step_ms.append(t)
    launches = {k: c.launches for k, c in kernels.items() if c.launches}
    agree = same_on_every_rank(tmodel)
    kmat = full(tmodel.kmat.detach())
    out.update(launches=launches, ms=ms, train_losses=losses,
               train_step_ms=step_ms, params_same_on_every_rank=agree)
    assert agree, "ranks hold different parameters after the steps"
    digests = [hashlib.sha256(sharded[n][0].cpu().numpy().tobytes())
               .hexdigest() for n in solves]
    every = [None] * world
    dist.all_gather_object(every, digests)
    assert all(d == every[0] for d in every), "ranks read other results"

    if rank == 0:
        # The same calls in one process on this card.
        held = {}
        for name, (program, p, args) in solves.items():
            fn = {"log": M.solve_mpc_log_utility_packed,
                  "scenario": M.solve_mpc_log_utility_scenarios_packed,
                  "mv": V.solve_mpc_mean_variance_packed}[program]
            whole = fn(*args, p, device=dev)
            ms[f"{name}_one_process"] = timed(
                lambda: fn(*args, p, device=dev), together=False)[1]
            B_all, B_shard = args[0].shape[0], args[0].shape[0] // (
                sizes[0] * sizes[1])
            same = (program != "mv" or V.mv_lanes_sweep(B_all, 30)
                    == V.mv_lanes_sweep(B_shard, 30))
            held[name] = _held_pair(f"parallel_path {name}", sharded[name],
                                    whole, program, same)
        for tag, kw in runs.items():
            whole, ms[f"backtest_{tag}_one_process"] = timed(
                lambda: run_backtest_parallel(strat, fd, bt, num_sweeps=2,
                                              return_dataframe=False, **kw),
                together=False)
            same = all(np.array_equal(hist[tag][k], whole[k])
                       for k in ("portfolio_value", "weights"))
            assert same, f"parallel_path backtest {tag}: other bits"
            held[f"backtest_{tag}"] = {
                "dates": len(whole["t"]), "bits_equal": same,
                "final_value": float(whole["portfolio_value"][-1])}
        ref = make_model(cfg, fd.observation_size, device=dev)
        ref.init_params(torch.Generator(device=dev).manual_seed(seed))
        rstate = TrainState(ref, build_optimizer(cfg, ref))
        rstep = make_train_step(cfg, ref, 1.0)
        ref_losses = []
        for s in range(PARALLEL_TRAIN_STEPS):
            (_, metrics), t = timed(lambda: rstep(rstate, batch(s)),
                                    together=False)
            ref_losses.append(float(metrics["loss"]))
            ms.setdefault("train_step_one_process", []).append(t)
        dk = (kmat - ref.kmat.detach()).abs().max().item()
        for a, b in zip(losses, ref_losses):
            assert _near(a, b, PARALLEL_LOSS_REL), (losses, ref_losses)
        assert dk <= PARALLEL_KMAT_ATOL, dk
        held["train"] = {"losses_one_process": ref_losses,
                         "kmat_max_abs_diff": dk}
        out["held"] = held
    out["rank_s"] = time.perf_counter() - t_rank
    print(PARALLEL_TAG + json.dumps(out), flush=True)
    dist.barrier()
    dist.destroy_process_group()


def phase_parallel_path(seed: int):
    """The parallel layer on a world of ``torch.cuda.device_count()`` ranks
    (at most four), one a card over NCCL, each rank running
    ``parallel_rank`` (a process of this script): the mesh code called
    explicitly, so that it runs at one rank too (``make_mesh``,
    ``sharded_mpc_solver``, ``run_backtest_parallel(mesh=)``,
    ``make_sharded_train_step``), at full width: the headline solve
    (B=65536 H=5 N=30, 1000 iterations, refresh 16, precond) through kernel
    A, B at S=16 (B=4096, H=5, N=30) and bench.py's ``markowitz`` shape
    (B=65536, H=1, N=30) through C with a covariance per problem and a
    shared one, the main path's date-sharded Koopman-MPC Jacobi backtest
    on finance_sparse (2 sweeps, cold and with ``warm_sweeps_iters=500``),
    and 3 data-parallel steps of finance_sparse (tensor-parallel over
    'model' where the world is even). Rank 0 holds each against the same
    call in one process on its card: the same bits wherever both take the
    same layout and sweep, else the packed-kernel bars; the losses within
    PARALLEL_LOSS_REL and K within PARALLEL_KMAT_ATOL; every rank's
    parameters bit-equal. Returns the launches of every rank, summed."""
    from kmpc_tpu_torch.parallel.launch import launch

    world = min(torch.cuda.device_count(), PARALLEL_MAX_RANKS)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    outs = launch([sys.executable, str(Path(__file__).resolve()),
                   "--parallel-rank", "--seed", str(seed)],
                  world=world, timeout=PARALLEL_TIMEOUT)
    ranks = [json.loads(next(line for line in o.splitlines()
                             if line.startswith(PARALLEL_TAG))
                        [len(PARALLEL_TAG):]) for o in outs]
    launches = {}
    for r in ranks:
        for name, n in r["launches"].items():
            launches[name] = launches.get(name, 0) + n
    for name in ("pdhg_log_utility_rows", "pdhg_log_utility_scenarios_rows",
                 "pdhg_mean_variance_lanes"):
        assert launches.get(name, 0) > 0, f"{name} never launched"
    cards = {r["device"] for r in ranks}
    assert len(cards) == world, f"ranks share a card: {cards}"
    lead = ranks[0]
    emit("parallel_path", world=world, mesh=lead["mesh"],
         train_mesh=lead["train_mesh"], backend="nccl", cards=sorted(cards),
         launches=launches, launches_by_rank=[r["launches"] for r in ranks],
         ms=lead["ms"], train_losses=lead["train_losses"],
         train_step_ms=lead["train_step_ms"], held=lead["held"],
         rank_s=[r["rank_s"] for r in ranks],
         elapsed_s=time.perf_counter() - t0)
    return launches


# The verification stack (``phase_verify_path``). The polished path on
# the first VERIFY_N instances of ``polish_order`` of each family of the
# repository's parity_cache/, at the records' own settings: ridge 1e-3,
# sigma_scale 2, 3 cycles, 4 Newton steps a polish, and VERIFY_ITERS
# first-solve iterations (at 2000 the first polish certifies no instance,
# and every one reaches its certificate only in the deep float64
# continuation, 100k iterations a chunk and instance). A certified record
# (residual below VERIFY_CERT) is a KKT point of a program the ridge makes
# strongly convex, so its point is unique: the card must certify it too
# and land within VERIFY_W_TOL of it in every row. The card runs both
# families, then the host CPU runs VERIFY_HOST (positions in the order),
# torch on one thread there (the CPU tests' setting); in this process, one
# after the other (the forward-mode levels of torch.func, which the Newton
# steps' Jacobians use, are global to a process: two threads in them at
# once fail).
# Position 0, the equal-weight first rebalance, takes the deep
# continuation in the realistic family, whose eager loop takes a minute or
# more on a CPU for each of its 100k-iteration chunks: the host run takes
# the positions after it.
VERIFY_N = 32
VERIFY_HOST = range(1, 5)
VERIFY_ITERS = 30000
VERIFY_CERT = 1e-10
VERIFY_W_TOL = 1e-7
# The native host solver against kernel A (tests/test_native.py's case):
# B, H, N, iterations, seed, and its weight bar.
NATIVE_CASE = (6, 5, 15, 8000, 1)
NATIVE_W_TOL = 2e-3
ORACLE_OBJ_TOL = 1e-8     # the oracle's ridged objective against its record
VERIFY_STAGES = ("first_solve", "newton", "active_set", "svd", "continuation",
                 "tail", "boundary", "deep_continuation", "interior_point",
                 "extended")


def verify_run(family, positions, device):
    """The polished path on the instances at ``positions`` of
    ``polish_order`` of ``family`` on ``device``, with a StageTimer:
    {family, device, ids, w, res (residual_after), seconds, stage_s,
    stage_count}."""
    from kmpc_tpu_torch.ops.mpc import MPCParams
    from kmpc_tpu_torch.ops.mpc_polish import (
        solve_mpc_log_utility_batch_polished,
    )
    from kmpc_tpu_torch.parity_cdf import REPO_CACHE, polish_order
    from kmpc_tpu_torch.utils.profiler import StageTimer

    d = np.load(REPO_CACHE / f"instances_{family}_1000.npz")
    ids = [polish_order(d["cw"].shape[0])[k] for k in positions]
    params = MPCParams(max_iters=VERIFY_ITERS, sigma_scale=2.0, ridge=1e-3,
                       polish=True, polish_newton=4)
    timer = StageTimer()
    t0 = time.perf_counter()
    w, info = solve_mpc_log_utility_batch_polished(
        torch.as_tensor(d["cw"][ids], device=device),
        torch.as_tensor(d["ys"][ids], device=device), params, cycles=3,
        timer=timer)
    assert w.dtype == torch.float64 and w.device.type == \
        torch.device(device).type, (w.dtype, w.device)
    res = info["residual_after"].cpu().numpy()
    secs = time.perf_counter() - t0
    summary = timer.summary()
    return {"family": family, "device": device, "ids": ids,
            "w": w.cpu().numpy(), "res": res, "seconds": secs,
            "stage_s": {k: v["total_s"] for k, v in summary.items()},
            "stage_count": {k: v["count"] for k, v in summary.items()}}


def phase_verify_path():
    """The verification stack: ``solve_mpc_log_utility_batch_polished``
    (its float64 stages on the card) on VERIFY_N cached instances of each
    family, every instance whose record is certified required certified on
    the card and within VERIFY_W_TOL of its record (an uncertified record
    is reported with both residuals, not held); the same path on the host
    CPU (VERIFY_HOST), the same certified set and weights within
    VERIFY_W_TOL where both certify; the port's native host solver (built
    with g++ from the checkout) against kernel A on NATIVE_CASE, weights
    within NATIVE_W_TOL; the port's scipy oracle on one instance of each
    family, its ridged objective within ORACLE_OBJ_TOL of its record. One
    line of the card's stage times (``utils.profiler.StageTimer``) with
    instances a second on the card and on the host, and the card's name and
    power limit."""
    from kmpc_tpu_torch.native import (
        library_path,
        num_threads,
        solve_mpc_log_utility_native,
    )
    from kmpc_tpu_torch.ops.mpc import MPCParams
    from kmpc_tpu_torch.ops.mpc_cuda import solve_mpc_log_utility_packed
    from kmpc_tpu_torch.ops.mpc_oracle import solve_mpc_log_utility_oracle
    from kmpc_tpu_torch.ops.mpc_polish import SVD_STREAMS, _svd
    from kmpc_tpu_torch.parity_cdf import (
        REPO_CACHE,
        _read_jsonl,
        polish_order,
        ridged_objective,
    )

    t_phase = time.perf_counter()
    failures = []
    families = ("random", "realistic")
    card = {f: verify_run(f, range(VERIFY_N), "cuda") for f in families}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        host = [verify_run(f, VERIFY_HOST, "cpu") for f in families]
    finally:
        torch.set_num_threads(threads)

    # The native host solver against kernel A.
    B, H, N, iters, seed = NATIVE_CASE
    rng = np.random.default_rng(seed)
    cw = rng.dirichlet(np.ones(N), size=B).astype(np.float32)
    ys = (rng.standard_normal((B, H, N)) * 0.01).astype(np.float32)
    t0 = time.perf_counter()
    w_nat, _ = solve_mpc_log_utility_native(cw, ys, max_iters=iters)
    native_s = time.perf_counter() - t0
    assert library_path().parent == ROOT / "kmpc_tpu_torch" / "_build"
    w_a, _ = solve_mpc_log_utility_packed(
        torch.as_tensor(cw, device="cuda"), torch.as_tensor(ys, device="cuda"),
        MPCParams(max_iters=iters, sigma_scale=2.0), device="cuda")
    dw_native = float(np.abs(w_nat - w_a.cpu().numpy()).max())
    if not dw_native <= NATIVE_W_TOL:
        failures.append(f"native against kernel A: {dw_native:.3e}")

    # The oracle on one instance of each family against its record.
    oracle = {}
    for family in families:
        d = np.load(REPO_CACHE / f"instances_{family}_1000.npz")
        recs = _read_jsonl(REPO_CACHE / f"oracle_{family}.jsonl")
        i = polish_order(d["cw"].shape[0])[1]
        cw_i, ys_i = d["cw"][i], d["ys"][i]
        t0 = time.perf_counter()
        w_or, info = solve_mpc_log_utility_oracle(
            cw_i.astype(np.float64), ys_i.astype(np.float64), ridge=1e-3)
        secs = time.perf_counter() - t0
        w_rec = np.asarray(recs[i]["w"]).reshape(ys_i.shape)
        dobj = float(abs(
            ridged_objective(w_or[None], ys_i[None], cw_i[None], 1e-3)[0]
            - ridged_objective(w_rec[None], ys_i[None], cw_i[None], 1e-3)[0]))
        oracle[family] = {"idx": i, "status": info["status"],
                          "abs_dobj_record": dobj, "seconds": secs}
        if not (info["status"] == "optimal" and dobj <= ORACLE_OBJ_TOL):
            failures.append(f"oracle {family} idx {i}: {info['status']}, "
                            f"objective {dobj:.3e} from its record")

    stage_s, stage_count = {}, {}
    rate = {"card": {}, "host": {}}
    for family, run in card.items():
        ids, w, res = run["ids"], run["w"], run["res"]
        rate["card"][family] = len(ids) / run["seconds"]
        for k, v in run["stage_s"].items():
            stage_s[k] = stage_s.get(k, 0.0) + v
            stage_count[k] = stage_count.get(k, 0) + run["stage_count"][k]
        recs = _read_jsonl(REPO_CACHE / f"polish_{family}.jsonl")
        held, uncertified = 0, []
        max_dw = 0.0
        for k, i in enumerate(ids):
            rec = recs[i]
            dw = float(np.abs(w[k].ravel() - np.asarray(rec["w"])).max())
            if rec["residual_after"] >= VERIFY_CERT:
                uncertified.append({"idx": i, "record": rec["residual_after"],
                                    "card": float(res[k]), "max_abs_dw": dw})
                continue
            held += 1
            max_dw = max(max_dw, dw)
            if not (res[k] < VERIFY_CERT and dw <= VERIFY_W_TOL):
                failures.append(f"{family} idx {i}: residual {res[k]:.3e}, "
                                f"{dw:.3e} from its certified record")
        emit("verify_path", family=family, instances=len(ids),
             held_to_record=held,
             certified_on_card=int((res < VERIFY_CERT).sum()),
             max_residual_after=float(res.max()), max_abs_dw_record=max_dw,
             uncertified_records=uncertified, seconds=run["seconds"],
             stage_s=run["stage_s"])

    # The host run against the card's on the same instances.
    for run in host:
        family = run["family"]
        rate["host"][family] = len(run["ids"]) / run["seconds"]
        at = {i: k for k, i in enumerate(card[family]["ids"])}
        pick = [at[i] for i in run["ids"]]
        w_c, res_c = card[family]["w"][pick], card[family]["res"][pick]
        w_h, res_h = run["w"], run["res"]
        same = bool(np.array_equal(res_c < VERIFY_CERT, res_h < VERIFY_CERT))
        both = (res_c < VERIFY_CERT) & (res_h < VERIFY_CERT)
        dw = float(np.abs(w_c - w_h)[both].max()) if both.any() else 0.0
        if not same or dw > VERIFY_W_TOL:
            failures.append(f"{family}: card and host certify "
                            f"{res_c.tolist()} / {res_h.tolist()}, "
                            f"{dw:.3e} apart")
        emit("verify_host", family=family, ids=run["ids"],
             same_certified_set=same, max_abs_dw_card_host=dw,
             residual_card=res_c.tolist(), residual_host=res_h.tolist(),
             seconds=run["seconds"], host_stage_s=run["stage_s"])

    # cuSOLVER's SVD on a batch of the random family's size (32 matrices
    # of 2HN + 2H = 310 rows, float64), in one call and split over the
    # polished path's streams (``mpc_polish._svd``): ms each, and the bits.
    J = torch.randn(32, 310, 310, dtype=torch.float64, device="cuda",
                    generator=torch.Generator("cuda").manual_seed(0))
    _svd(J[:8])                    # the library's and the threads' set-up
    one, one_ms = timed_once(lambda: torch.linalg.svd(J, full_matrices=False))
    split, split_ms = timed_once(lambda: _svd(J))
    svd_batch = {"matrices": 32, "rows": 310, "one_call_ms": one_ms,
                 "split_ms": split_ms, "streams": SVD_STREAMS,
                 "bits_equal": all(torch.equal(a, b)
                                   for a, b in zip(one, split))}
    emit("verify_times", smi=smi_line(), svd_batch=svd_batch,
         stage_s={k: stage_s.get(k, 0.0) for k in VERIFY_STAGES},
         stage_count={k: stage_count.get(k, 0) for k in VERIFY_STAGES},
         instances_per_s_card=rate["card"], instances_per_s_host=rate["host"],
         native={"max_abs_dw_kernel_a": dw_native, "seconds": native_s,
                 "threads": num_threads()},
         oracle=oracle, seconds=time.perf_counter() - t_phase)
    assert not failures, f"verify_path: {failures}"


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
    "pdhg_log_utility_wide": (_LOG + "_wide.cu", _PALLAS + ":226"),
    "pdhg_log_utility_wide_adaptive": (_LOG + "_wide_adaptive.cu",
                                       _PALLAS + ":593"),
    "pdhg_mean_variance_tile": (_MV + "_tile.cu", _PALLAS + ":1089"),
    "pdhg_mean_variance_tile_adaptive": (_MV + "_tile_adaptive.cu",
                                         _PALLAS + ":1196"),
    "pdhg_mean_variance_lanes": (_MV + "_lanes.cu", _PALLAS + ":1089"),
    "pdhg_mean_variance_lanes_adaptive": (_MV + "_lanes_adaptive.cu",
                                          _PALLAS + ":1196"),
    "pdhg_log_utility_scenarios_wide": (_LOG + "_scenarios_wide.cu",
                                        _PALLAS + ":226"),
    "pdhg_log_utility_scenarios_wide_adaptive": (
        _LOG + "_scenarios_wide_adaptive.cu", _PALLAS + ":593"),
    # Kernel B's row layout with the returns past its registers, a line
    # each: streamed on ``warp_path`` (and the S=512 run of
    # ``scenarios_path``), resident on ``scenarios_path``'s S=128 H=20 run.
    "pdhg_log_utility_scenarios_rows:streamed": (
        _LOG + "_scenarios_rows.cu", _PALLAS + ":226"),
    "pdhg_log_utility_scenarios_rows_adaptive:streamed": (
        _LOG + "_scenarios_rows_adaptive.cu", _PALLAS + ":593"),
    "pdhg_log_utility_scenarios_rows:resident": (
        _LOG + "_scenarios_rows.cu", _PALLAS + ":226"),
}


def main():
    parser = argparse.ArgumentParser(description="kmpc_tpu_torch chip smoke")
    parser.add_argument("--seed", type=int, default=0,
                        help="seed of the main path's random weights")
    parser.add_argument("--parallel-rank", action="store_true",
                        help="run as one rank of parallel_path's world "
                             "(started by the phase itself)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        sys.exit(1)
    if args.parallel_rank:
        parallel_rank(args.seed)
        return
    from kmpc_tpu_torch.ops.mpc_cuda import plain_replayed

    t0 = time.perf_counter()
    marks = {}

    def done(phase):
        marks[phase] = time.perf_counter() - t0
        emit("elapsed_s", **marks)

    phase_build()
    done("build")
    # The holds' plain versions, untimed in these phases, replay their
    # loops as CUDA graphs (the same kernels on the same values).
    with plain_replayed():
        cases = phase_kernel_vs_plain()
        done("kernels")
        phase_layouts()
        mv_layouts()
        done("layouts")
    phase_nan_row()
    phase_probe()
    ctx = phase_main_path(args.seed)
    done("main_path")
    phase_train_path(args.seed)
    done("train_path")
    eval_launches, eval_held = phase_eval_path(args.seed)
    for case in eval_held:
        cases[case["kernel"]].append(case)
    done("eval_path")
    parallel_launches = phase_parallel_path(args.seed)
    done("parallel_path")
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
    scen_launches, scen_first = phase_scenarios_path(ctx)
    done("scenarios_path")
    mv_launches, mv_first, mv_cases = phase_mv_long_wide()
    for name, rows in mv_cases.items():
        cases[name] += [c for c in rows if c is not mv_first[name]]
    ladder_launches, ladder_case = phase_mv_ladder()
    done("mv")
    mk_launches, mk_first, mk_cases = phase_markowitz()
    for name, rows in mk_cases.items():
        cases[name] += [c for c in rows if c is not mk_first.get(name)]
    phase_headline()
    phase_large_headlines()
    done("headlines")
    phase_verify_path()
    # The wide kernels' bits again, after every phase and the verified
    # path's float64 work on the same card.
    check_wide_digests()
    done("verify_path")

    # One entry per kernel: launches on the path that runs it (the
    # comparison path for the fixed-step kernels, A and B in the row
    # layout, the accurate path for the adaptive ones, the long path for the
    # row layout's pipelined body, ``warp_path`` for the warp layout's
    # kernels, ``block_path`` for the block and wide-row layouts',
    # ``scenarios_path`` for B's row kernel with its returns resident,
    # ``mv_long_wide`` for
    # C's tile and block kernels (its shared_H1N960 case for the times),
    # the ladder's
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
            (block_launches, block_first), (scen_launches, scen_first),
            (mv_launches, mv_first),
            ({"mv_ladder": ladder_launches}, {"mv_ladder": ladder_case}),
            (mk_launches, mk_first)):
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
        if eval_launches.get(name):
            entry["eval_path_launches"] = eval_launches[name]
        if parallel_launches.get(name):
            entry["parallel_path_launches"] = parallel_launches[name]
        if name.split(":")[0].endswith("_adaptive"):
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
        if any(x in name for x in ("block", "rows", "wide", "tile",
                                   "lanes")):
            entry["deterministic_cases"] = sum(
                1 for c in every if c.get("deterministic"))
        if "wide" in name or "tile" in name:
            entry["max_abs_dw_block"] = max(
                c.get("max_abs_dw_block", 0.0) for c in every)
        if ":" in name:
            entry["storage_bits_cases"] = sum(
                1 for c in every if c.get("bits_equal_storage"))
        if "storage" in at_path:
            entry.update({k: at_path[k] for k in (
                "storage", "S", "returns_bytes_per_iter",
                "returns_tb_per_s", "plain_batch") if k in at_path})
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
