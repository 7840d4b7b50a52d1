"""Fused log-utility MPC solves: the hand-written CUDA kernels, their plain
PyTorch version, and the wrappers around them.

Port of kmpc_tpu/ops/mpc_pallas.py ``solve_mpc_log_utility_pallas_packed``
and ``solve_mpc_log_utility_scenarios_packed`` (the TPU kernel
``_make_packed_kernel`` with S=None and with S set). One launch of
``csrc/pdhg_log_utility.cu`` (deterministic forecast) or
``csrc/pdhg_log_utility_scenarios.cu`` (S Monte-Carlo scenarios, the smooth
gradient their mean) runs the whole Condat-Vu iteration for every problem
of the batch: the primal step with tau folded into the portfolio
reciprocal, the simplex projection with carried Michelot thresholds, the
clip-form dual prox against the l1 turnover ball on the sigma scale,
over-relaxation, and a final primal half-step that yields the returned
iterate and the fixed-point residual. Four loop bodies are ported:
``make_body`` (full warm budget, or cold thresholds when
``proj_warm_iters=0``), ``make_body_cond`` (``proj_refresh_every > 1``:
one warm sweep per iteration, the full budget every k-th),
``make_trip_pipe`` (``pipeline_reduces`` with a refresh schedule: the
dual's ball threshold and l1 one iteration stale, a synchronous iteration
every min(k, 8)-th) and ``body_adaptive`` (``adaptive``: residual-balancing
steps carried through the loop, the dual prox on the a-scale, the full
budget every iteration, balancing on every ``adapt_every``-th iteration),
the last two in kernels of their own (``..._pipe.cu``, ``..._adaptive.cu``)
so that the fixed-step instantiations keep their registers. All kernels
take warm primal/dual iterates (the simplex threshold then starts cold on
the warm primal, the ball threshold from zero) and can write the loop's
last dual.

Six layouts: one CTA per problem and one warp per horizon row
(``csrc/pdhg_log_utility_rows.cuh``, up to 32 rows of ceil(N/32) <= 4
slots, any number of scenarios), one warp per problem with the iterates in
registers (``csrc/pdhg_log_utility.cuh``, up to pow2ceil(H) * ceil(N/32) =
16), the wide-row layout past 128 assets, one warp per horizon row with the
row in shared memory (``csrc/pdhg_log_utility_wide.cuh``, up to 32 rows, as
many slots as the shared memory holds, one forecast or any number of
scenarios), one block per problem with the iterates in shared memory
(``csrc/pdhg_log_utility_block.cuh``, every shape whose problem fits a
block's shared memory: long horizons, hundreds of assets), the cluster
layout, the wide-row body with one problem's rows split over a
thread-block cluster of at most 8 CTAs, the rows that meet across CTAs
read through distributed shared memory
(``csrc/pdhg_log_utility_cluster.cuh``; one forecast at H=20 N=1000, S=16
there), and the global layout, the block layout's body with its iterates
in a global-memory workspace, one slot a CTA of a persistent grid (the
block header; every other shape: H=252 at N=1000, say). In the row,
wide-row and cluster layouts a problem's scenario returns sit in registers
(the row layout, S ceil(N/32) <= 16), resident in the CTA's shared memory,
or streamed through each warp's ring of chunk stages, by ``cp.async`` or,
in the cluster layout, TMA bulk copies (``STORAGES``; ``rows_storage``,
``wide_storage``, ``cluster_storage``): the plan of the streamed storage
does not grow with S. A CUDA tensor launches the row kernel where it fits
(the fastest layout at every shape measured), else the wide kernel where
it measured faster than the block kernel (``wide_preferred``), else the
block kernel, else the wide kernel where it takes the shape, else the
cluster kernel where a cluster holds it, else the global kernel; no shape
routes to the warp layout, which the row layout takes
wherever both fit (the private launch of chip_smoke.py still runs it). So
every input kmpc_tpu's packed wrappers answer runs on the card, where
kmpc_tpu hands some to its XLA solver; only a global workspace past the
card's free memory raises. ``allow_short`` (shorts: the primal projected on
the hyperplane sum(w) = 1, no threshold carried, as kmpc_tpu's XLA solver
does it) runs in the block layout where one problem fits a block's shared
memory, else in the global layout, by a flag of their kernels. A CPU tensor
runs ``pdhg_log_utility_plain``, the same iteration as plain tensor code,
the plain version of every layout.
"""

from __future__ import annotations

import contextlib
import ctypes
from typing import Dict, Optional, Tuple

import torch

from kmpc_tpu_torch._build import CudaKernel
from kmpc_tpu_torch.ops.mpc import (
    MPCParams,
    _balance_steps,
    _log_utility_objective,
    _pdhg_steps,
    _prev_rows,
    _status_code,
    graph_replay,
    reject_unhonored_polish,
    restore_turnover_feasibility,
)
from kmpc_tpu_torch.ops.projections import (
    ball_l1_and_sweep,
    michelot_iters_for,
    michelot_threshold,
)
from kmpc_tpu_torch.ops.scenario import scenario_objective, scenario_steps

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

# (cw, r, w_warm, p_warm, w_out, fp_out, p_out), the sizes and budgets, the
# scalars, the flags, the stream; the scenario kernels take S after B. The
# fourth int of the tail is ``proj_refresh_every`` for the fixed-step
# kernels and ``adapt_every`` for the adaptive ones.
_TAIL = [_I] * 6 + [_F] * 6 + [_I] * 3 + [_P]
PDHG_LOG_UTILITY = CudaKernel(
    "pdhg_log_utility", "kmpc_pdhg_log_utility", [_P] * 7 + [_I] + _TAIL,
)
PDHG_LOG_UTILITY_SCENARIOS = CudaKernel(
    "pdhg_log_utility_scenarios", "kmpc_pdhg_log_utility_scenarios",
    [_P] * 7 + [_I, _I] + _TAIL,
)
# The adaptive kernels take one more pointer after p_out: steps_out.
PDHG_LOG_UTILITY_ADAPTIVE = CudaKernel(
    "pdhg_log_utility_adaptive", "kmpc_pdhg_log_utility_adaptive",
    [_P] * 8 + [_I] + _TAIL,
)
PDHG_LOG_UTILITY_SCENARIOS_ADAPTIVE = CudaKernel(
    "pdhg_log_utility_scenarios_adaptive",
    "kmpc_pdhg_log_utility_scenarios_adaptive",
    [_P] * 8 + [_I, _I] + _TAIL,
)
# The pipelined body (make_trip_pipe) in the warp layout.
PDHG_LOG_UTILITY_PIPE = CudaKernel(
    "pdhg_log_utility_pipe", "kmpc_pdhg_log_utility_pipe",
    [_P] * 7 + [_I] + _TAIL,
)
PDHG_LOG_UTILITY_SCENARIOS_PIPE = CudaKernel(
    "pdhg_log_utility_scenarios_pipe", "kmpc_pdhg_log_utility_scenarios_pipe",
    [_P] * 7 + [_I, _I] + _TAIL,
)
# The row and wide-row layouts' fixed-step kernels take a last int before
# the stream, 1 for the pipelined body.
_TAIL_BLOCK = _TAIL[:-1] + [_I, _P]
# The block-per-problem layout: the fixed-step kernels take the pipelined
# body's int and then the ``allow_short`` int (1: the hyperplane
# projection) before the stream, the adaptive ones the adaptive kernels'
# arguments and then the ``allow_short`` int.
_TAIL_SHORT = _TAIL[:-1] + [_I, _I, _P]
_TAIL_SHORT_ADAPTIVE = _TAIL[:-1] + [_I, _P]
PDHG_LOG_UTILITY_BLOCK = CudaKernel(
    "pdhg_log_utility_block", "kmpc_pdhg_log_utility_block",
    [_P] * 7 + [_I] + _TAIL_SHORT,
)
PDHG_LOG_UTILITY_SCENARIOS_BLOCK = CudaKernel(
    "pdhg_log_utility_scenarios_block",
    "kmpc_pdhg_log_utility_scenarios_block",
    [_P] * 7 + [_I, _I] + _TAIL_SHORT,
)
PDHG_LOG_UTILITY_BLOCK_ADAPTIVE = CudaKernel(
    "pdhg_log_utility_block_adaptive", "kmpc_pdhg_log_utility_block_adaptive",
    [_P] * 8 + [_I] + _TAIL_SHORT_ADAPTIVE,
)
PDHG_LOG_UTILITY_SCENARIOS_BLOCK_ADAPTIVE = CudaKernel(
    "pdhg_log_utility_scenarios_block_adaptive",
    "kmpc_pdhg_log_utility_scenarios_block_adaptive",
    [_P] * 8 + [_I, _I] + _TAIL_SHORT_ADAPTIVE,
)
# The global layout: the block layout's arguments, then the workspace and
# the grid before the stream.
_TAIL_GLOBAL = _TAIL_SHORT[:-1] + [_P, _I, _P]
_TAIL_GLOBAL_ADAPTIVE = _TAIL_SHORT_ADAPTIVE[:-1] + [_P, _I, _P]
PDHG_LOG_UTILITY_GLOBAL = CudaKernel(
    "pdhg_log_utility_global", "kmpc_pdhg_log_utility_global",
    [_P] * 7 + [_I] + _TAIL_GLOBAL,
)
PDHG_LOG_UTILITY_SCENARIOS_GLOBAL = CudaKernel(
    "pdhg_log_utility_scenarios_global",
    "kmpc_pdhg_log_utility_scenarios_global",
    [_P] * 7 + [_I, _I] + _TAIL_GLOBAL,
)
PDHG_LOG_UTILITY_GLOBAL_ADAPTIVE = CudaKernel(
    "pdhg_log_utility_global_adaptive",
    "kmpc_pdhg_log_utility_global_adaptive",
    [_P] * 8 + [_I] + _TAIL_GLOBAL_ADAPTIVE,
)
PDHG_LOG_UTILITY_SCENARIOS_GLOBAL_ADAPTIVE = CudaKernel(
    "pdhg_log_utility_scenarios_global_adaptive",
    "kmpc_pdhg_log_utility_scenarios_global_adaptive",
    [_P] * 8 + [_I, _I] + _TAIL_GLOBAL_ADAPTIVE,
)
# The scenario kernels of the row and wide-row layouts take one more int
# before the stream: the storage of the returns (STORAGES' index).
_TAIL_STORE = _TAIL_BLOCK[:-1] + [_I, _P]
_TAIL_STORE_ADAPTIVE = _TAIL[:-1] + [_I, _P]
# The row-per-warp layout: the block layout's arguments.
PDHG_LOG_UTILITY_ROWS = CudaKernel(
    "pdhg_log_utility_rows", "kmpc_pdhg_log_utility_rows",
    [_P] * 7 + [_I] + _TAIL_BLOCK,
)
PDHG_LOG_UTILITY_SCENARIOS_ROWS = CudaKernel(
    "pdhg_log_utility_scenarios_rows",
    "kmpc_pdhg_log_utility_scenarios_rows",
    [_P] * 7 + [_I, _I] + _TAIL_STORE,
)
PDHG_LOG_UTILITY_ROWS_ADAPTIVE = CudaKernel(
    "pdhg_log_utility_rows_adaptive", "kmpc_pdhg_log_utility_rows_adaptive",
    [_P] * 8 + [_I] + _TAIL,
)
PDHG_LOG_UTILITY_SCENARIOS_ROWS_ADAPTIVE = CudaKernel(
    "pdhg_log_utility_scenarios_rows_adaptive",
    "kmpc_pdhg_log_utility_scenarios_rows_adaptive",
    [_P] * 8 + [_I, _I] + _TAIL_STORE_ADAPTIVE,
)
# The wide-row layout (one forecast): the block layout's arguments.
PDHG_LOG_UTILITY_WIDE = CudaKernel(
    "pdhg_log_utility_wide", "kmpc_pdhg_log_utility_wide",
    [_P] * 7 + [_I] + _TAIL_BLOCK,
)
PDHG_LOG_UTILITY_WIDE_ADAPTIVE = CudaKernel(
    "pdhg_log_utility_wide_adaptive", "kmpc_pdhg_log_utility_wide_adaptive",
    [_P] * 8 + [_I] + _TAIL,
)
# Kernel B in the wide-row layout: the row layout's scenario arguments.
PDHG_LOG_UTILITY_SCENARIOS_WIDE = CudaKernel(
    "pdhg_log_utility_scenarios_wide", "kmpc_pdhg_log_utility_scenarios_wide",
    [_P] * 7 + [_I, _I] + _TAIL_STORE,
)
PDHG_LOG_UTILITY_SCENARIOS_WIDE_ADAPTIVE = CudaKernel(
    "pdhg_log_utility_scenarios_wide_adaptive",
    "kmpc_pdhg_log_utility_scenarios_wide_adaptive",
    [_P] * 8 + [_I, _I] + _TAIL_STORE_ADAPTIVE,
)
# The cluster layout: the wide-row layout's arguments, then the cluster's
# CTAs before the stream; kernel B's also the streamed ring's stages and
# scenarios a stage and the returns' row stride.
_TAIL_CLUSTER = _TAIL_BLOCK[:-1] + [_I, _P]
_TAIL_CLUSTER_ADAPTIVE = _TAIL[:-1] + [_I, _P]
_TAIL_CLUSTER_STORE = _TAIL_STORE[:-1] + [_I] * 4 + [_P]
_TAIL_CLUSTER_STORE_ADAPTIVE = _TAIL_STORE_ADAPTIVE[:-1] + [_I] * 4 + [_P]
PDHG_LOG_UTILITY_CLUSTER = CudaKernel(
    "pdhg_log_utility_cluster", "kmpc_pdhg_log_utility_cluster",
    [_P] * 7 + [_I] + _TAIL_CLUSTER,
)
PDHG_LOG_UTILITY_CLUSTER_ADAPTIVE = CudaKernel(
    "pdhg_log_utility_cluster_adaptive",
    "kmpc_pdhg_log_utility_cluster_adaptive",
    [_P] * 8 + [_I] + _TAIL_CLUSTER_ADAPTIVE,
)
PDHG_LOG_UTILITY_SCENARIOS_CLUSTER = CudaKernel(
    "pdhg_log_utility_scenarios_cluster",
    "kmpc_pdhg_log_utility_scenarios_cluster",
    [_P] * 7 + [_I, _I] + _TAIL_CLUSTER_STORE,
)
PDHG_LOG_UTILITY_SCENARIOS_CLUSTER_ADAPTIVE = CudaKernel(
    "pdhg_log_utility_scenarios_cluster_adaptive",
    "kmpc_pdhg_log_utility_scenarios_cluster_adaptive",
    [_P] * 8 + [_I, _I] + _TAIL_CLUSTER_STORE_ADAPTIVE,
)
# (scenarios, layout, body) -> kernel
_KERNELS = {
    (False, "warp", "fixed"): PDHG_LOG_UTILITY,
    (True, "warp", "fixed"): PDHG_LOG_UTILITY_SCENARIOS,
    (False, "warp", "adaptive"): PDHG_LOG_UTILITY_ADAPTIVE,
    (True, "warp", "adaptive"): PDHG_LOG_UTILITY_SCENARIOS_ADAPTIVE,
    (False, "warp", "pipe"): PDHG_LOG_UTILITY_PIPE,
    (True, "warp", "pipe"): PDHG_LOG_UTILITY_SCENARIOS_PIPE,
    (False, "block", "fixed"): PDHG_LOG_UTILITY_BLOCK,
    (True, "block", "fixed"): PDHG_LOG_UTILITY_SCENARIOS_BLOCK,
    (False, "block", "pipe"): PDHG_LOG_UTILITY_BLOCK,
    (True, "block", "pipe"): PDHG_LOG_UTILITY_SCENARIOS_BLOCK,
    (False, "block", "adaptive"): PDHG_LOG_UTILITY_BLOCK_ADAPTIVE,
    (True, "block", "adaptive"): PDHG_LOG_UTILITY_SCENARIOS_BLOCK_ADAPTIVE,
    (False, "rows", "fixed"): PDHG_LOG_UTILITY_ROWS,
    (True, "rows", "fixed"): PDHG_LOG_UTILITY_SCENARIOS_ROWS,
    (False, "rows", "pipe"): PDHG_LOG_UTILITY_ROWS,
    (True, "rows", "pipe"): PDHG_LOG_UTILITY_SCENARIOS_ROWS,
    (False, "rows", "adaptive"): PDHG_LOG_UTILITY_ROWS_ADAPTIVE,
    (True, "rows", "adaptive"): PDHG_LOG_UTILITY_SCENARIOS_ROWS_ADAPTIVE,
    (False, "wide", "fixed"): PDHG_LOG_UTILITY_WIDE,
    (False, "wide", "pipe"): PDHG_LOG_UTILITY_WIDE,
    (False, "wide", "adaptive"): PDHG_LOG_UTILITY_WIDE_ADAPTIVE,
    (True, "wide", "fixed"): PDHG_LOG_UTILITY_SCENARIOS_WIDE,
    (True, "wide", "pipe"): PDHG_LOG_UTILITY_SCENARIOS_WIDE,
    (True, "wide", "adaptive"): PDHG_LOG_UTILITY_SCENARIOS_WIDE_ADAPTIVE,
    (False, "global", "fixed"): PDHG_LOG_UTILITY_GLOBAL,
    (False, "global", "pipe"): PDHG_LOG_UTILITY_GLOBAL,
    (False, "global", "adaptive"): PDHG_LOG_UTILITY_GLOBAL_ADAPTIVE,
    (True, "global", "fixed"): PDHG_LOG_UTILITY_SCENARIOS_GLOBAL,
    (True, "global", "pipe"): PDHG_LOG_UTILITY_SCENARIOS_GLOBAL,
    (True, "global", "adaptive"): PDHG_LOG_UTILITY_SCENARIOS_GLOBAL_ADAPTIVE,
    (False, "cluster", "fixed"): PDHG_LOG_UTILITY_CLUSTER,
    (False, "cluster", "pipe"): PDHG_LOG_UTILITY_CLUSTER,
    (False, "cluster", "adaptive"): PDHG_LOG_UTILITY_CLUSTER_ADAPTIVE,
    (True, "cluster", "fixed"): PDHG_LOG_UTILITY_SCENARIOS_CLUSTER,
    (True, "cluster", "pipe"): PDHG_LOG_UTILITY_SCENARIOS_CLUSTER,
    (True, "cluster", "adaptive"): PDHG_LOG_UTILITY_SCENARIOS_CLUSTER_ADAPTIVE,
}
KERNELS = tuple(dict.fromkeys(_KERNELS.values()))
# In the order routing prefers them (``kernel_layout``: the wide layout
# where preferred before the block layout, else where it fits after it);
# the global layout takes every shape.
LAYOUTS = ("rows", "warp", "wide", "block", "cluster", "global")
# The block, row, wide and global layouts' fixed-step kernels run the
# pipelined body by a flag.
_PIPE_FLAG = (PDHG_LOG_UTILITY_BLOCK, PDHG_LOG_UTILITY_SCENARIOS_BLOCK,
              PDHG_LOG_UTILITY_ROWS, PDHG_LOG_UTILITY_SCENARIOS_ROWS,
              PDHG_LOG_UTILITY_WIDE, PDHG_LOG_UTILITY_SCENARIOS_WIDE,
              PDHG_LOG_UTILITY_GLOBAL, PDHG_LOG_UTILITY_SCENARIOS_GLOBAL,
              PDHG_LOG_UTILITY_CLUSTER, PDHG_LOG_UTILITY_SCENARIOS_CLUSTER)
# The global layout's kernels, which take a workspace and a grid.
_GLOBAL = (PDHG_LOG_UTILITY_GLOBAL, PDHG_LOG_UTILITY_SCENARIOS_GLOBAL,
           PDHG_LOG_UTILITY_GLOBAL_ADAPTIVE,
           PDHG_LOG_UTILITY_SCENARIOS_GLOBAL_ADAPTIVE)
# The kernels that take the ``allow_short`` flag: the block and global
# layouts' (the layouts that ``allow_short`` routes to).
_SHORT_ARG = (PDHG_LOG_UTILITY_BLOCK, PDHG_LOG_UTILITY_SCENARIOS_BLOCK,
              PDHG_LOG_UTILITY_BLOCK_ADAPTIVE,
              PDHG_LOG_UTILITY_SCENARIOS_BLOCK_ADAPTIVE) + _GLOBAL
SHORT_LAYOUTS = ("block", "global")
# Launches with ``allow_short`` by kernel name, counted beside each
# kernel's ``launches``.
SHORT_LAUNCHES: Dict[str, int] = {}
# The kernels that take the storage of the scenario returns.
_STORAGE_ARG = (PDHG_LOG_UTILITY_SCENARIOS_ROWS,
                PDHG_LOG_UTILITY_SCENARIOS_ROWS_ADAPTIVE,
                PDHG_LOG_UTILITY_SCENARIOS_WIDE,
                PDHG_LOG_UTILITY_SCENARIOS_WIDE_ADAPTIVE,
                PDHG_LOG_UTILITY_SCENARIOS_CLUSTER,
                PDHG_LOG_UTILITY_SCENARIOS_CLUSTER_ADAPTIVE)
# The cluster layout's kernels, which take the cluster's CTAs.
_CLUSTER = (PDHG_LOG_UTILITY_CLUSTER, PDHG_LOG_UTILITY_CLUSTER_ADAPTIVE,
            PDHG_LOG_UTILITY_SCENARIOS_CLUSTER,
            PDHG_LOG_UTILITY_SCENARIOS_CLUSTER_ADAPTIVE)
# Where a problem's scenario returns live in the row and wide-row layouts
# (the kernels' ``storage``, by index): in registers (the row layout at
# S ceil(N/32) <= ROWS_REG_SLOTS, and every one-forecast launch), resident
# in the CTA's shared memory as [S][N] floats a row, or streamed through
# each warp's ring of chunk stages by cp.async.
STORAGES = ("registers", "resident", "streamed")
# Launches of the kernels in _STORAGE_ARG by (kernel name, storage),
# counted beside each kernel's ``launches``.
STORAGE_LAUNCHES: Dict[Tuple[str, str], int] = {}


# Register budget of the warp layout: one warp per problem keeps
# pow2ceil(H) * ceil(N/32) elements of each iterate per lane.
MAX_SLOTS = 4          # ceil(N / 32): N <= 128
MAX_ROW_ELEMENTS = 16  # pow2ceil(H) * ceil(N / 32)

# Shared memory one block can use on Hopper (above 48 KB by opt-in, which
# the launchers do). The warp layout's scenario kernel stages each
# problem's returns in its warp's slice: S * H * ceil32(N) floats; the
# block layout holds a whole problem (block_smem_bytes).
SMEM_PER_BLOCK = 232448
BLOCK_MAX_THREADS = 512


def kernel_supports(H: int, N: int) -> bool:
    """Whether the warp-layout kernels are compiled for horizon H and N
    assets."""
    k = -(-N // 32)
    hm = 1 << max(H - 1, 0).bit_length()
    return H >= 1 and 1 <= k <= MAX_SLOTS and hm * k <= MAX_ROW_ELEMENTS


def scenario_smem_bytes(S: int, H: int, N: int) -> int:
    """Shared memory per warp of the scenario kernel."""
    return S * H * 32 * (-(-N // 32)) * 4


def scenario_kernel_supports(S: int, H: int, N: int) -> bool:
    """Whether the scenario kernel takes S scenarios at horizon H and N
    assets: the register budget, and one problem's returns within a
    block's shared memory."""
    return (S >= 1 and kernel_supports(H, N)
            and scenario_smem_bytes(S, H, N) <= SMEM_PER_BLOCK)


def block_threads(N: int) -> int:
    """Threads of one problem's block in the block layout: a warp per 32
    assets, at most 512 (beyond, a thread walks several columns)."""
    return 32 * -(-min(N, BLOCK_MAX_THREADS) // 32)


def block_smem_bytes(S: Optional[int], H: int, N: int) -> int:
    """Shared memory of one problem in the block layout
    (``block_plan`` in csrc/pdhg_log_utility_block.cuh): r per scenario and
    w, p, the projection input and the dual input as [H][N]; the current
    weights; eight per-row values (steps, thresholds, the ball's l1); the
    portfolio reciprocals and curvature ratios per scenario and row; and
    each warp's staging of the largest stacked reduce (the portfolio values
    with the ball's count, sum and l1 of every row)."""
    s1 = S or 1
    floats = (s1 + 4) * H * N + N + 8 * H + 2 * s1 * H + 4 \
        + block_threads(N) // 32 * (s1 * H + 3 * H)
    return 4 * floats


def _small_floats(S: Optional[int], H: int, N: int) -> int:
    """Floats of ``small_plan`` in csrc/pdhg_log_utility_block.cuh: eight
    per-row values, the portfolio reciprocals and curvature ratios per
    scenario and row, four residual slots and each warp's staging of the
    largest stacked reduce."""
    s1 = S or 1
    return 8 * H + 2 * s1 * H + 4 + block_threads(N) // 32 * (s1 * H + 3 * H)


def global_smem_bytes(S: Optional[int], H: int, N: int) -> int:
    """Shared memory of one CTA in the global layout (``global_plan`` in
    csrc/pdhg_log_utility_block.cuh): the small plan where it fits a
    block's shared memory, else none."""
    small = 4 * _small_floats(S, H, N)
    return small if small <= SMEM_PER_BLOCK else 0


def global_workspace_bytes(S: Optional[int], H: int, N: int,
                           grid: int) -> int:
    """Bytes of the global layout's workspace for a grid of ``grid`` CTAs
    (``global_plan``): each CTA's slot holds w, p, the projection input and
    the dual input as [H][N] (the returns and the current weights are read
    in place), and the small plan where it does not fit shared memory."""
    floats = 4 * H * N
    if global_smem_bytes(S, H, N) == 0:
        floats += _small_floats(S, H, N)
    return 4 * floats * grid


def block_kernel_supports(S: Optional[int], H: int, N: int) -> bool:
    """Whether the block-layout kernels take a problem of S scenarios
    (None: one forecast) at horizon H and N assets: its arrays within a
    block's shared memory. Warm inputs, the dual output and the adaptive
    body add nothing there (the warm iterates are read into w and p, the
    dual written from p, the residuals summed on the fly)."""
    return (H >= 1 and N >= 1 and (S is None or S >= 1)
            and block_smem_bytes(S, H, N) <= SMEM_PER_BLOCK)


# The row-per-warp layout: one CTA per problem, one warp per horizon row
# (csrc/pdhg_log_utility_rows.cuh), compiled for ceil(N/32) <= 4 and at
# most 32 rows; a row's S ceil(N/32) scenario returns per lane sit in
# registers up to ROWS_REG_SLOTS, beyond that in the CTA's shared memory.
ROWS_MAX_H = 32
ROWS_REG_SLOTS = 16
# The kernels' bound on the warps of a CTA, and the registers a thread may
# take under it (65536 over the threads, as ptxas allots them).
ROWS_WARP_BOUNDS = (8, 20, 32)


def rows_warp_bound(H: int) -> int:
    """The instantiation's bound on the warps of a CTA for H rows."""
    return next(hb for hb in ROWS_WARP_BOUNDS if H <= hb)


def _rows_plan(S: Optional[int], H: int, N: int, adaptive: bool,
               storage: str) -> Tuple[int, int]:
    """(bytes, ring stages) of ``rows_plan`` in
    csrc/pdhg_log_utility_rows.cuh."""
    k = -(-N // 32)
    row = H * 32 * k
    chunk = ROWS_REG_SLOTS // k
    s = S or 0
    floats = (2 + (4 if adaptive else 0)) * row \
        + H * min(max(s, 1), chunk) + 2 * H
    stages = 0
    if storage == "resident":
        floats += H * s * N
    elif storage == "streamed":
        stage = row * chunk
        stages = 3 if 4 * (floats + 3 * stage) <= SMEM_PER_BLOCK else 2
        floats += stages * stage
    return 4 * floats, stages


def sm_ctas(smem_bytes: int) -> int:
    """CTAs of this much shared memory an SM holds at once (each reserves
    1 KB more)."""
    return SM_SMEM // (smem_bytes + 1024)


def rows_storage(S: Optional[int], H: int, N: int) -> str:
    """Where the row kernels keep a problem's scenario returns: in
    registers for one forecast and S ceil(N/32) <= ROWS_REG_SLOTS, else
    resident in the CTA's shared memory where the adaptive body's plan
    lets as many CTAs share an SM as streaming would, else streamed. By
    measurement (PERF.md section 6): at B=1028 a resident plan of one CTA
    an SM ran 1.5-1.6x slower than the streamed one at S=364 to 512, H=5
    N=20; one problem alone runs faster resident (chip_smoke.py's
    ``ROUTED_SLOWER`` names the shapes routing by shape alone loses)."""
    if S is None or S * -(-N // 32) <= ROWS_REG_SLOTS:
        return "registers"
    resident = _rows_plan(S, H, N, True, "resident")[0]
    streamed = _rows_plan(S, H, N, True, "streamed")[0]
    if resident <= SMEM_PER_BLOCK and sm_ctas(resident) >= sm_ctas(streamed):
        return "resident"
    return "streamed"


def rows_smem_bytes(S: Optional[int], H: int, N: int,
                    adaptive: bool = True,
                    storage: Optional[str] = None) -> int:
    """Shared memory of one problem's CTA in the row layout (``rows_plan``
    in csrc/pdhg_log_utility_rows.cuh): the dual and wbar of every row
    exchanged between neighbours, with ``adaptive`` the moves and residual
    terms of every row (four [H][K * 32] arrays), the curvature ratios of a
    chunk of min(S, 16 / K) scenarios a row, the rows' bounds and
    fixed-point residuals, and the scenario returns in ``storage`` (default
    ``rows_storage``'s): none in registers, [H][S][N] resident, or each
    warp's ring of ``rows_ring_stages`` stages of 16 / K scenarios x K * 32
    floats."""
    storage = storage or rows_storage(S, H, N)
    return _rows_plan(S, H, N, adaptive, storage)[0]


def rows_ring_stages(S: int, H: int, N: int, adaptive: bool = True) -> int:
    """The depth of each warp's ring where the returns are streamed: 3
    where the plan fits a block's shared memory, else 2."""
    return _rows_plan(S, H, N, adaptive, "streamed")[1]


def rows_kernel_supports(S: Optional[int], H: int, N: int) -> bool:
    """Whether the row-layout kernels take a problem of S scenarios (None:
    one forecast) at horizon H and N assets: at most ROWS_MAX_H rows of
    ceil(N/32) <= MAX_SLOTS slots, and the adaptive body's plan within a
    block's shared memory (the budget is the same for every body; streamed,
    it holds at any S)."""
    return (1 <= H <= ROWS_MAX_H and 1 <= N <= 32 * MAX_SLOTS
            and (S is None or S >= 1)
            and rows_smem_bytes(S, H, N) <= SMEM_PER_BLOCK)


# The wide-row layout: one CTA per problem, one warp per horizon row, the
# row in shared memory (csrc/pdhg_log_utility_wide.cuh); one forecast, past
# the row layout's slots.
WIDE_MAX_H = 32


WIDE_CHUNK = 4   # scenarios a chunk, at most
# A streamed ring's (stages, scenarios a stage), the first that fits.
WIDE_RINGS = ((3, 4), (2, 4), (2, 2), (2, 1))


def wide_scen_plan(S: int, H: int, N: int, adaptive: bool,
                   storage: str) -> Tuple[int, int, int]:
    """(bytes, ring stages, scenarios a chunk) of ``wide_scen_plan`` in
    csrc/pdhg_log_utility_wide.cuh: the one-forecast plan's arrays but the
    returns' slice (the gradient is summed in the projection input's),
    the curvature ratios of WIDE_CHUNK scenarios and the bounds of every
    row, and the returns: resident [H][S][N], or each warp's ring, the
    first of WIDE_RINGS that fits a block's shared memory."""
    kw = 32 * -(-N // 32)
    row = H * kw
    floats = 4 * row + kw + H * WIDE_CHUNK + 2 * H
    if adaptive:
        floats += 2 * row + 2 * H * 32
    if storage == "resident":
        return 4 * (floats + H * S * N), 0, WIDE_CHUNK
    for stages, chunk in WIDE_RINGS:
        total = 4 * (floats + stages * chunk * row)
        if total <= SMEM_PER_BLOCK:
            break
    return total, stages, chunk


def wide_storage(S: int, H: int, N: int) -> str:
    """Where the wide kernels keep a problem's scenario returns: resident
    where the adaptive body's plan lets as many CTAs share an SM as
    streaming would (as ``rows_storage``), else streamed."""
    resident = wide_scen_plan(S, H, N, True, "resident")[0]
    streamed = wide_scen_plan(S, H, N, True, "streamed")[0]
    if resident <= SMEM_PER_BLOCK and sm_ctas(resident) >= sm_ctas(streamed):
        return "resident"
    return "streamed"


def wide_smem_bytes(H: int, N: int, adaptive: bool = True,
                    S: Optional[int] = None,
                    storage: Optional[str] = None) -> int:
    """Shared memory of one problem's CTA in the wide-row layout
    (``wide_plan`` in csrc/pdhg_log_utility_wide.cuh): five [H][K * 32]
    arrays (returns, w, p, the projection and dual input, wbar) and one
    more [K * 32] row of wbar for the current weights; with ``adaptive``
    the moves dw and dp, [H][K * 32] each, and each lane's two residual
    partials of every row, [2][H][32]; the rows' curvature ratios and
    fixed-point residuals. With S scenarios, ``wide_scen_plan`` in
    ``storage`` (default ``wide_storage``'s)."""
    if S is not None:
        return wide_scen_plan(S, H, N, adaptive,
                              storage or wide_storage(S, H, N))[0]
    kw = 32 * -(-N // 32)
    row = H * kw
    floats = 5 * row + kw + 2 * H
    if adaptive:
        floats += 2 * row + 2 * H * 32
    return 4 * floats


def wide_kernel_supports(S: Optional[int], H: int, N: int) -> bool:
    """Whether the wide-row kernels take a problem of this shape: one
    forecast or S >= 1 scenarios, at most WIDE_MAX_H rows, past the row
    layout's 32 * MAX_SLOTS assets, and the adaptive body's plan within a
    block's shared memory (the budget is the same for every body)."""
    return ((S is None or S >= 1) and 1 <= H <= WIDE_MAX_H
            and N > 32 * MAX_SLOTS
            and wide_smem_bytes(H, N, True, S) <= SMEM_PER_BLOCK)


# The cluster layout: the wide-row body with one problem's rows split over
# a thread-block cluster of at most CLUSTER_MAX CTAs, their arrays in each
# CTA's shared memory, the rows that meet across CTAs read through
# distributed shared memory (csrc/pdhg_log_utility_cluster.cuh); kernel B's
# returns resident, or streamed through each warp's ring by TMA bulk copies.
CLUSTER_MAX = 8
# A streamed ring's (stages, scenarios a stage) in the order routing tries
# them, the first whose plan a cluster holds (CLUSTER_MAX CTAs): a deeper
# ring takes more CTAs a problem. By measurement (PERF.md section 6, kernel
# B at S=16 B=1013 H=20 N=1000): (2, 2) at four CTAs ran 1.02x faster than
# (2, 1) at three, 1.14x than (2, 4) at five, 1.66x than (3, 4) at seven;
# the kernels are built for these two (a ring of four scenarios a stage
# would be tried only where (2, 1), the smallest, does not fit).
CLUSTER_RINGS = ((2, 2), (2, 1))


def cluster_cta_bytes(S: Optional[int], span: int, N: int, adaptive: bool,
                      storage: str = "registers", stages: int = 0,
                      chunk: int = 1) -> int:
    """Shared memory of one CTA of ``span`` rows in the cluster layout
    (``cluster_plan`` in csrc/pdhg_log_utility_cluster.cuh): the returns
    first (one forecast [span][K * 32]; S scenarios resident [span][S][N],
    or each warp's ring of ``stages`` x ``chunk`` x K * 32 floats), rounded
    to 16 bytes; w, p, the projection and dual input and wbar (one more
    row); with ``adaptive`` the moves dw and dp and the residual partials
    [2][span][32]; the curvature ratios (of WIDE_CHUNK scenarios), fp and
    the rows' bounds, rounded to 8 bytes; the ring's mbarriers."""
    kw = 32 * -(-N // 32)
    sr = span * kw
    scen = bool(S)
    ring = scen and storage == "streamed"
    o = sr if not scen else (span * stages * chunk * kw if ring
                             else span * S * N)
    o = -(-o // 4) * 4 + 4 * sr + kw
    if adaptive:
        o += 2 * sr + 2 * span * 32
    o += span * (WIDE_CHUNK if scen else 1) + 2 * span
    o = -(-o // 2) * 2 + (2 * span * stages if ring else 0)
    return 4 * o


def cluster_size(S: Optional[int], H: int, N: int, adaptive: bool,
                 storage: str = "registers", stages: int = 0,
                 chunk: int = 1) -> int:
    """The fewest CTAs, at most CLUSTER_MAX, whose CTA of ceil(H / C) <=
    WIDE_MAX_H rows fits a block's shared memory, given as ceil(H / span)
    so that every CTA holds a row (``cluster_size`` in the header); 0 where
    none does."""
    for c in range(1, CLUSTER_MAX + 1):
        span = -(-H // c)
        if span <= WIDE_MAX_H and cluster_cta_bytes(
                S, span, N, adaptive, storage, stages, chunk) <= SMEM_PER_BLOCK:
            return -(-H // span)
    return 0


def cluster_ring(S: int, H: int, N: int, adaptive: bool) -> Tuple[int, int]:
    """The streamed ring's (stages, scenarios a stage) of a body: the first
    of CLUSTER_RINGS whose plan a cluster holds ((0, 0) where none)."""
    for stages, chunk in CLUSTER_RINGS:
        if cluster_size(S, H, N, adaptive, "streamed", stages, chunk):
            return stages, chunk
    return 0, 0


def cluster_storage(S: int, H: int, N: int) -> str:
    """Where the cluster kernels keep a problem's scenario returns: resident
    where the adaptive body's resident plan takes no more CTAs than its
    streamed one (as ``wide_storage``: no fewer problems in flight), else
    streamed."""
    res = cluster_size(S, H, N, True, "resident")
    ring = cluster_ring(S, H, N, True)
    streamed = cluster_size(S, H, N, True, "streamed", *ring) if ring[0] else 0
    return "resident" if res and (not streamed or res <= streamed) \
        else "streamed"


def cluster_plan(S: Optional[int], H: int, N: int, adaptive: bool,
                 storage: Optional[str] = None,
                 ring: Optional[Tuple[int, int]] = None,
                 ctas: Optional[int] = None) -> Tuple[int, int, int, int, int]:
    """(CTAs C, rows a CTA, bytes a CTA, ring stages, scenarios a stage) of
    a launch in the cluster layout: one forecast, or S scenarios in
    ``storage`` (default ``cluster_storage``'s) through ``ring`` (default
    ``cluster_ring``'s); C the fewest that hold the body's plan, or
    ``ctas`` (a private launch at more CTAs than needed). C is 0 where no
    cluster of at most CLUSTER_MAX CTAs holds it."""
    if S is None:
        storage, ring = "registers", (0, 1)
    else:
        storage = storage or cluster_storage(S, H, N)
        ring = ring or (cluster_ring(S, H, N, adaptive)
                        if storage == "streamed" else (0, WIDE_CHUNK))
        if storage == "streamed" and not ring[0]:
            return 0, 0, 0, 0, 0
    c = ctas or cluster_size(S, H, N, adaptive, storage, *ring)
    if not 1 <= c <= CLUSTER_MAX:
        return 0, 0, 0, ring[0], ring[1]
    span = -(-H // c)
    return (c, span, cluster_cta_bytes(S, span, N, adaptive, storage, *ring),
            ring[0], ring[1])


def cluster_kernel_supports(S: Optional[int], H: int, N: int) -> bool:
    """Whether the cluster kernels take a problem of this shape: the
    adaptive body's plan (the budget is the same for every body) in a
    cluster of at most CLUSTER_MAX CTAs of at most WIDE_MAX_H rows."""
    return (H >= 1 and N >= 1 and (S is None or S >= 1)
            and cluster_plan(S, H, N, True)[0] > 0)


def storage_supports(layout: str, storage: str, S: Optional[int], H: int,
                     N: int) -> bool:
    """Whether ``layout``'s kernels take this shape with the scenario
    returns in ``storage`` (chip_smoke.py launches a storage privately to
    compare storages): registers in the row layout for one forecast or
    S ceil(N/32) <= ROWS_REG_SLOTS; resident or streamed in the row and
    wide-row layouts for S scenarios where the adaptive plan fits."""
    if layout == "rows" and 1 <= H <= ROWS_MAX_H and 1 <= N <= 32 * MAX_SLOTS:
        if storage == "registers":
            return S is None or S * -(-N // 32) <= ROWS_REG_SLOTS
        return S is not None and storage in STORAGES and S >= 1 and \
            _rows_plan(S, H, N, True, storage)[0] <= SMEM_PER_BLOCK
    if layout == "wide" and storage in ("resident", "streamed"):
        return (S is not None and S >= 1 and 1 <= H <= WIDE_MAX_H
                and N > 32 * MAX_SLOTS
                and wide_scen_plan(S, H, N, True, storage)[0]
                <= SMEM_PER_BLOCK)
    if layout == "cluster" and storage in ("resident", "streamed"):
        return (S is not None and S >= 1 and H >= 1 and N >= 1
                and cluster_plan(S, H, N, True, storage)[0] > 0)
    return False


# Where the block layout is faster: the wide layout's warps hide one
# another's latency, so it wants WIDE_MIN_WARPS resident warps an SM (H a
# CTA, times the CTAs its adaptive plan lets share an SM's SM_SMEM bytes,
# each reserving 1 KB). By measurement (PERF.md section 6: the layouts at
# B=1028 over H 1..4 and N 1000..2730): one row past 2368 assets (two CTAs
# an SM) and two rows past 1888 (one) went faster in the block layout for
# the pipelined and adaptive bodies; wherever three or more warps share an
# SM, the wide layout for most bodies, 1.2-8x at B=1028.
SM_SMEM = 233472
WIDE_MIN_WARPS = 3


def wide_resident_warps(H: int, N: int, S: Optional[int] = None) -> int:
    """Warps of wide-layout CTAs an SM holds at once, by the adaptive
    plan's shared memory (threads and registers bind later at H <= 32)."""
    return H * sm_ctas(wide_smem_bytes(H, N, True, S))


def wide_preferred(H: int, N: int, S: Optional[int] = None) -> bool:
    """Whether routing takes the wide-row layout over the block layout at a
    shape the wide layout takes (for one forecast the block layout takes
    every such shape: its plan is the smaller). The same rule with the
    scenario plan for S scenarios, measured at N=150 and N=500
    (chip_smoke.py's ``layouts``)."""
    return wide_resident_warps(H, N, S) >= WIDE_MIN_WARPS


def layout_supports(layout: str, S: Optional[int], H: int, N: int,
                    allow_short: bool = False) -> bool:
    """Whether ``layout``'s kernels take a problem of this shape (with
    ``allow_short``: and project on the hyperplane, which only the block
    and global layouts do)."""
    if allow_short and layout not in SHORT_LAYOUTS:
        return False
    if layout == "global":
        return H >= 1 and N >= 1 and (S is None or S >= 1)
    if layout == "warp":
        return kernel_supports(H, N) and (
            S is None or scenario_kernel_supports(S, H, N))
    if layout == "rows":
        return rows_kernel_supports(S, H, N)
    if layout == "wide":
        return wide_kernel_supports(S, H, N)
    if layout == "cluster":
        return cluster_kernel_supports(S, H, N)
    return layout == "block" and block_kernel_supports(S, H, N)


def kernel_layout(S: Optional[int], H: int, N: int,
                  allow_short: bool = False) -> Optional[str]:
    """The layout a CUDA solve of this shape runs in: ``"rows"`` (one CTA
    per problem, one warp per horizon row) wherever it fits, which at
    H <= 32 and N <= 128 is every shape, any S (the warp layout, one warp
    per problem, is therefore never routed to), else ``"wide"`` (past 128
    assets: one CTA per problem, one warp per horizon row, the row in
    shared memory) where it fits and ``wide_preferred``, else ``"block"``
    (one block per problem, the iterates in shared memory), else
    ``"wide"`` where it fits (a scenario shape the block layout cannot
    hold), else ``"cluster"`` (the wide-row body with the rows split over a
    cluster of at most CLUSTER_MAX CTAs) where it fits, else ``"global"``
    (the block layout's body with its iterates in a global-memory
    workspace: every shape, whatever S, H and N; a workspace past the
    card's free memory raises at launch and names its bytes).
    With ``allow_short`` (the hyperplane projection, in the block and global
    layouts only) ``"block"`` where one problem fits a block's shared
    memory, else ``"global"``. None only for S, H or N below 1. By
    measurement: the row layout was faster than the
    warp and block layouts at every shape and batch chip_smoke.py's
    ``layouts`` phase times (B from 1 to 65536, H from 1 to 20, S up to
    501), the wide layout faster than the block layout at N=150 and N=500
    (B from 1 to 4096, S=16 and 64 too), and past 1000 assets for most
    bodies at B=1028 where ``wide_preferred`` holds (``layouts``; the grid
    of ``python -m kmpc_tpu_torch.ops.row_slots --wide``). By shape alone,
    so a batch of one problem at one or two rows past 1000 assets, where
    the block layout's pipelined and adaptive bodies are faster, runs wide
    (PERF.md section 6)."""
    if not layout_supports("global", S, H, N):
        return None
    if allow_short:
        return "block" if block_kernel_supports(S, H, N) else "global"
    for layout in ("rows", "warp", "wide", "block"):
        if layout_supports(layout, S, H, N) and (
                layout != "wide" or wide_preferred(H, N, S)):
            return layout
    for layout in ("wide", "cluster"):
        if layout_supports(layout, S, H, N):
            return layout
    return "global"


def _pipelined(params: MPCParams) -> bool:
    """Whether the solve runs ``make_trip_pipe``: pipelined reductions with
    a refresh schedule and warm thresholds, never under ``adaptive`` or
    ``allow_short`` (which carries no threshold)."""
    return (params.pipeline_reduces and not params.adaptive
            and _sweep_budgets(params, 1)[0]
            and params.proj_refresh_every > 1)


def _moved(pr: torch.Tensor, dr: torch.Tensor) -> torch.Tensor:
    """+1 where a balancing with these residuals grows tau, -1 where it
    shrinks it, 0 where the steps stay (``_balance_steps``' decisions)."""
    return (pr > 1.5 * dr).to(pr.dtype) - (dr > 1.5 * pr).to(pr.dtype)


def _plain_iterate(step, carry, n: int, period: int):
    """``carry = step(i, *carry)`` for i = 0 .. n - 1: the plain versions'
    loop, whose steps depend on i only through i mod ``period``. It is
    looked up at each call, so that a caller may run the same steps as
    replays of a CUDA graph (``plain_replayed``)."""
    for i in range(n):
        carry = step(i, *carry)
    return carry


# The fewest iterations a CUDA graph of ``plain_replayed`` holds.
PLAIN_GRAPH_CHUNK = 96


@contextlib.contextmanager
def plain_replayed():
    """Within the block, the plain versions (``pdhg_log_utility_plain``,
    ``mv_cuda.pdhg_mean_variance_plain``) on CUDA tensors run their loop as
    replays of one CUDA graph of at least PLAIN_GRAPH_CHUNK iterations, a
    multiple of the loop's period (``ops.mpc.graph_replay``): the kernels
    of the eager loop in its order on the same values, without the host's
    cost per operation."""
    global _plain_iterate
    eager = _plain_iterate

    def replayed(step, carry, n, period):
        chunk = period * max(1, -(-PLAIN_GRAPH_CHUNK // period))
        return graph_replay(chunk, lambda st, c, m: eager(st, c, m, period))(
            step, carry, n)

    _plain_iterate = replayed
    try:
        yield
    finally:
        _plain_iterate = eager


def _check_return_steps(params: MPCParams, return_steps: bool) -> None:
    if return_steps and not params.adaptive:
        raise ValueError("return_steps needs params.adaptive: the "
                         "fixed-step bodies carry no steps")


def _sweep_budgets(params: MPCParams, N: int) -> Tuple[bool, int, int]:
    """(warm, warm_iters, cold_iters): sweeps per projection from a carried
    threshold, and the cold budget (8 / 12 / 16 by N). ``allow_short``
    carries no threshold (kmpc_tpu's ``warm = ... and not allow_short``):
    the dual's ball threshold then starts cold every iteration."""
    cold_iters = michelot_iters_for(N)
    warm = params.proj_warm_iters >= 1 and not params.allow_short
    return warm, params.proj_warm_iters if warm else cold_iters, cold_iters


def pdhg_log_utility_plain(
    current_weights: torch.Tensor,
    r: torch.Tensor,
    params: MPCParams,
    w_warm: Optional[torch.Tensor] = None,
    p_warm: Optional[torch.Tensor] = None,
    return_dual: bool = False,
    return_steps: bool = False,
):
    """The kernels' computation in plain tensor code.

    current_weights [B, N] and gross returns r [B, H, N], or [B, S, H, N]
    for the scenario program; optional warm iterates [B, H, N] (``p_warm``
    alone is ignored). Returns (w_last [B, H, N], fixed-point residual
    [B]), with ``return_dual`` the loop's last dual [B, H, N], and with
    ``return_steps`` (the adaptive body only) the steps the loop ended on,
    [B, 2 H + 4]: tau and sigma of every horizon row, alpha, the primal and
    dual residual (pr, dr) of the last balancing, and the signed sum of the
    iterations that moved the steps (+(i + 1) where tau grew, -(i + 1) where
    it shrank). Two runs whose balancing decisions were the same end on the
    same steps and the same sum; where they part, the residuals show how
    close to a tie (pr = 1.5 dr or dr = 1.5 pr) the decision was. With
    ``allow_short`` the primal projection is onto the hyperplane sum(w) = 1
    (a cold threshold of no sweeps, unclipped) and no threshold is carried.
    """
    reject_unhonored_polish(params, "pdhg_log_utility_plain")
    _check_return_steps(params, return_steps)
    scen = r.dim() == 4
    B, H, N = r.shape[0], r.shape[-2], r.shape[-1]
    w_init = current_weights
    c = params.cost_coeff
    tau_to = params.max_turnover
    use_ball = tau_to > 0
    ridge = params.ridge
    rho = params.over_relax
    warm, warm_iters, cold_iters = _sweep_budgets(params, N)
    short = params.allow_short
    refresh = params.proj_refresh_every
    # Under ``adaptive`` the refresh schedule is off: every iteration runs
    # the full projection budget.
    cond = warm and refresh > 1 and not params.adaptive

    if scen:
        tau, sigma = scenario_steps(r, params)             # [B, 1 or H, 1]
    else:
        r_norm2 = (r * r).sum(dim=-1)
        r_min = r.amin(dim=-1)
        Lt = r_norm2 / torch.clamp(r_min, min=1e-12) ** 2 + ridge   # [B, H]
        tau, sigma = _pdhg_steps(Lt, params)
    sig_tau = sigma * tau_to
    c1 = 1.0 - tau * ridge

    def D(x):
        return x - _prev_rows(x, w_init)

    def Dt(p):
        nxt = torch.cat([p[:, 1:], torch.zeros_like(p[:, :1])], dim=1)
        return p - nxt

    def scaled_returns(w, scale):
        """r * scale / (w . r): the scale folded into the portfolio
        reciprocal, per scenario before the scenario mean."""
        if not scen:
            port = (w * r).sum(dim=-1, keepdim=True)
            return r * (scale / torch.clamp(port, min=1e-12))
        port = (w[:, None] * r).sum(dim=-1, keepdim=True)  # [B, S, H, 1]
        scale = scale[:, None] if torch.is_tensor(scale) else scale
        g = r * (scale / torch.clamp(port, min=1e-12))
        return g.sum(dim=1) / float(r.shape[1])

    def primal_pre(w, p):
        g = scaled_returns(w, tau)
        base = w if ridge == 0.0 else c1 * w
        return base + (g - tau * Dt(p))

    if w_warm is None:
        w, th_w = project_primal(
            w_init[:, None, :].expand(B, H, N), short, cold_iters)
        p = torch.zeros_like(w)
    else:
        # A cold threshold on the warm primal; the iterate itself is kept.
        w = w_warm
        p = torch.zeros_like(w) if p_warm is None else p_warm
        th_w = michelot_threshold(w, 1.0, cold_iters)
    th_p = torch.zeros_like(th_w)
    zero = torch.zeros_like(w_init)

    def adaptive_iteration(i, w, p, th_w, th_p, tau_c, sig_c, alpha_c, res,
                           count):
        """``body_adaptive``: the smooth gradient with the carried tau
        outside the portfolio reciprocal, the dual prox on the a-scale
        (v = q / sig_c, ball radius tau_to), and the residual balancing of
        the steps on every ``adapt_every``-th iteration, from the iterates'
        moves before over-relaxation. ``count`` carries i as a tensor (the
        signed sum of the iterations that moved the steps reads it)."""
        count = count + 1.0
        grad = scaled_returns(w, -1.0)
        if ridge != 0.0:
            grad = grad + ridge * w
        v = w - tau_c * (grad + Dt(p))
        w_new, th_w = project_primal(v, short, warm_iters,
                                     th_w if warm else None)
        q = p + sig_c * D(2.0 * w_new - w)
        inv_s = 1.0 / sig_c
        v = q * inv_s
        a = torch.clamp(v.abs() - c * inv_s, min=0.0)
        if use_ball:
            if warm:
                l1, th_p = ball_l1_and_sweep(a, tau_to, th_p)
                th_p = michelot_threshold(a, tau_to, warm_iters - 1, th_p)
            else:
                l1 = a.sum(dim=-1, keepdim=True)
                th_p = michelot_threshold(a, tau_to, warm_iters)
            bound = c * inv_s + torch.where(
                l1 <= tau_to, torch.zeros_like(th_p),
                torch.clamp(th_p, min=0.0))
        else:
            bound = c * inv_s
        inner = v - torch.minimum(torch.maximum(v, -bound), bound)
        p_new = q - sig_c * inner
        k = params.adapt_every
        if k <= 1 or i % k == k - 1:
            dw, dp = w - w_new, p - p_new
            pr = torch.sqrt(((dw / tau_c - Dt(dp)) ** 2).sum(dim=(1, 2)))
            dr = torch.sqrt(((dp / sig_c - (dw - _prev_rows(dw, zero))) ** 2)
                            .sum(dim=(1, 2)))
            tau_c, sig_c, alpha_c = _balance_steps(
                pr[:, None, None], dr[:, None, None], tau_c, sig_c, alpha_c)
            res = torch.stack([pr, dr, res[:, 2] + count * _moved(pr, dr)],
                              dim=1)
        if rho != 1.0:
            w_new = w + rho * (w_new - w)
            p_new = p + rho * (p_new - p)
        return w_new, p_new, th_w, th_p, tau_c, sig_c, alpha_c, res, count

    def ball_bound(l1, th_p):
        """c inside the turnover ball, c + max(theta, 0) outside."""
        return c + torch.where(l1 <= sig_tau, torch.zeros_like(th_p),
                               torch.clamp(th_p, min=0.0))

    def fixed_iteration(i, w, p, th_w, th_p, l1s, n_sw=None):
        """``make_body`` / ``make_body_cond`` (and the synchronous iteration
        of ``make_trip_pipe``, which passes its ``n_sw``): tau folded into
        the portfolio reciprocal, the dual prox on the q-scale. ``l1s`` is
        the ball's l1, carried for the pipelined body."""
        if n_sw is None:
            if not warm:
                n_sw = cold_iters
            elif cond:
                n_sw = warm_iters if i % refresh == 0 else 1
            else:
                n_sw = warm_iters
        v = primal_pre(w, p)
        w_new, th_w = project_primal(v, short, n_sw,
                                     th_w if warm else None)
        q = p + sigma * D(2.0 * w_new - w)
        aq = torch.clamp(q.abs() - c, min=0.0)
        if use_ball:
            if warm:
                l1s, th_p = ball_l1_and_sweep(aq, sig_tau, th_p)
                th_p = michelot_threshold(aq, sig_tau, n_sw - 1, th_p)
            else:
                l1s = aq.sum(dim=-1, keepdim=True)
                th_p = michelot_threshold(aq, sig_tau, n_sw)
            bound = ball_bound(l1s, th_p)
            p_new = torch.minimum(torch.maximum(q, -bound), bound)
        else:
            p_new = torch.clamp(q, -c, c)
        if rho != 1.0:
            w_new = w + rho * (w_new - w)
            p_new = p + rho * (p_new - p)
        return w_new, p_new, th_w, th_p, l1s

    def pipe_iteration(w, p, th_w, th_p, l1s):
        """``make_trip_pipe``'s pipelined iteration: one synchronous primal
        sweep from the carried threshold; the dual clipped against the
        carried ball threshold and l1 (both 0 at the start: the bound is
        then c); one sweep of this iteration's magnitudes against the
        carried threshold, with their l1, gives the next iteration's
        pair."""
        v = primal_pre(w, p)
        th_w = michelot_threshold(v, 1.0, 1, th_w)
        w_new = torch.clamp(v - th_w, min=0.0)
        q = p + sigma * D(2.0 * w_new - w)
        if use_ball:
            bound = ball_bound(l1s, th_p)
            p_new = torch.minimum(torch.maximum(q, -bound), bound)
        else:
            p_new = torch.clamp(q, -c, c)
        if rho != 1.0:
            w_new = w + rho * (w_new - w)
            p_new = p + rho * (p_new - p)
        if use_ball:
            l1s, th_p = ball_l1_and_sweep(
                torch.clamp(q.abs() - c, min=0.0), sig_tau, th_p)
        return w_new, p_new, th_w, th_p, l1s

    if params.adaptive:
        carry = (w, p, th_w, th_p, tau, sigma.expand_as(tau),
                 torch.full_like(tau[:, :1], 0.5), tau.new_zeros((B, 3)),
                 tau.new_zeros(()))
        carry = _plain_iterate(adaptive_iteration, carry, params.max_iters,
                               max(1, params.adapt_every))
        w, p, tau = carry[0], carry[1], carry[4]   # the tail steps by tau_f
        steps = torch.cat([x.expand(B, H, 1)[..., 0] for x in carry[4:6]]
                          + [carry[6][:, :, 0], carry[7]], dim=1)
    elif _pipelined(params):
        # Trips of k - 1 pipelined iterations and one synchronous iteration
        # with the full warm budget; the remainder of max_iters / k runs
        # synchronous iterations.
        k = min(refresh, 8)
        full = params.max_iters // k * k

        def pipe_step(i, *carry):
            if i >= full or i % k == k - 1:
                return fixed_iteration(i, *carry, n_sw=warm_iters)
            return pipe_iteration(*carry)

        carry = (w, p, th_w, th_p, torch.zeros_like(th_p))
        w, p = _plain_iterate(pipe_step, carry, params.max_iters, k)[:2]
    else:
        carry = (w, p, th_w, th_p, torch.zeros_like(th_p))
        w, p = _plain_iterate(fixed_iteration, carry, params.max_iters,
                              refresh if cond else 1)[:2]

    grad = scaled_returns(w, -1.0)
    if ridge != 0.0:
        grad = grad + ridge * w
    v = w - tau * (grad + Dt(p))
    w_last = project_primal(v, short, cold_iters)[0]
    fp = (w_last - w).abs().amax(dim=(1, 2))
    out = (w_last, fp) + ((p,) if return_dual else ())
    return out + ((steps,) if return_steps else ())


def project_primal(v: torch.Tensor, allow_short: bool, n_sw: int,
                   theta0: Optional[torch.Tensor] = None):
    """(the primal projection of v on each row, its threshold), as the
    kernels project: onto the simplex by ``n_sw`` Michelot sweeps from
    ``theta0`` or a cold start; with ``allow_short`` onto the hyperplane
    sum(w) = 1 (the cold threshold, (sum - 1) / N, unclipped)."""
    if allow_short:
        theta = michelot_threshold(v, 1.0, 0)
        return v - theta, theta
    theta = michelot_threshold(v, 1.0, n_sw, theta0)
    return torch.clamp(v - theta, min=0.0), theta


def _require_cuda_f32(**tensors) -> None:
    for name, t in tensors.items():
        if not t.is_cuda or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(
                f"{name} must be a contiguous float32 CUDA tensor, got "
                f"{t.dtype} on {t.device} (contiguous={t.is_contiguous()})"
            )
    devices = {t.device for t in tensors.values()}
    if len(devices) > 1:
        raise ValueError(f"{', '.join(tensors)} lie on different devices")


def _body(params: MPCParams) -> str:
    """The loop body the parameters select: ``"adaptive"``, ``"pipe"`` (the
    pipelined body) or ``"fixed"``."""
    return ("adaptive" if params.adaptive
            else "pipe" if _pipelined(params) else "fixed")


def _route(S: Optional[int], H: int, N: int,
           params: MPCParams) -> Tuple[str, str, CudaKernel]:
    """(layout, body, kernel) of a CUDA solve: the layout ``kernel_layout``
    gives the shape (and ``allow_short``) and the loop body the parameters
    select; raises ``ValueError`` only for S, H or N below 1."""
    layout = kernel_layout(S, H, N, params.allow_short)
    if layout is None:
        raise ValueError(f"S={S}, H={H}, N={N}: a problem needs S, H and N "
                         f"of at least 1")
    body = _body(params)
    return layout, body, _KERNELS[(S is not None, layout, body)]


def pdhg_log_utility_cuda(
    current_weights: torch.Tensor,
    r: torch.Tensor,
    params: MPCParams,
    w_warm: Optional[torch.Tensor] = None,
    p_warm: Optional[torch.Tensor] = None,
    return_dual: bool = False,
    return_steps: bool = False,
):
    """One launch of a CUDA kernel on the current stream: the same
    contract as ``pdhg_log_utility_plain``, for CUDA float32 tensors.
    r [B, H, N] launches kernel A, r [B, S, H, N] kernel B (the
    ``..._scenarios`` sources), in the layout ``kernel_layout`` gives the
    shape: ``pdhg_log_utility{,_scenarios}_rows`` where the row layout
    fits, else ``pdhg_log_utility{,_scenarios}_wide`` where preferred,
    else the ``..._block`` kernel, else the wide kernel where it fits, else
    the ``..._cluster`` kernel where a cluster holds the problem, else the
    ``..._global`` kernel; scenario returns in the storage
    ``rows_storage``, ``wide_storage`` or ``cluster_storage`` gives; with ``params.adaptive``
    the ``..._adaptive`` kernel of each, with the pipelined body
    (``pipeline_reduces``) their fixed-step kernel by a flag. With
    ``allow_short`` the block kernel where it fits, else the global one,
    by a flag. A global workspace past the card's free memory raises
    ``ValueError``."""
    reject_unhonored_polish(params, "pdhg_log_utility_cuda")
    _check_return_steps(params, return_steps)
    scen = r.dim() == 4
    if r.dim() not in (3, 4) or \
            current_weights.shape != (r.shape[0], r.shape[-1]):
        raise ValueError(
            f"expected current_weights [B, N] and r [B, H, N] or "
            f"[B, S, H, N], got {tuple(current_weights.shape)} and "
            f"{tuple(r.shape)}"
        )
    B, H, N = r.shape[0], r.shape[-2], r.shape[-1]
    tensors = {"current_weights": current_weights, "r": r}
    if w_warm is not None:
        tensors["w_warm"] = w_warm
        if p_warm is not None:
            tensors["p_warm"] = p_warm
    else:
        p_warm = None
    for name in ("w_warm", "p_warm"):
        if name in tensors and tensors[name].shape != (B, H, N):
            raise ValueError(f"expected {name} [B, H, N] = {(B, H, N)}, got "
                             f"{tuple(tensors[name].shape)}")
    _require_cuda_f32(**tensors)
    _, body, kernel = _route(r.shape[1] if scen else None, H, N, params)
    return _launch(kernel, body, current_weights, r, params, w_warm, p_warm,
                   return_dual, return_steps)


def _storage(kernel: CudaKernel, S: int, H: int, N: int) -> str:
    """The storage routing gives a scenario kernel of the row or wide-row
    layout."""
    if kernel in _CLUSTER:
        return cluster_storage(S, H, N)
    rows = kernel in (PDHG_LOG_UTILITY_SCENARIOS_ROWS,
                      PDHG_LOG_UTILITY_SCENARIOS_ROWS_ADAPTIVE)
    return (rows_storage if rows else wide_storage)(S, H, N)


def _library_function(name: str, symbol: str, argtypes, restype):
    """A function of the built library of source ``name`` other than its
    kernel's entry point (a plan's size, an occupancy), built at first
    use."""
    from kmpc_tpu_torch._build import build_all, library_path

    build_all([name])
    fn = getattr(ctypes.CDLL(str(library_path(name))), symbol)
    fn.argtypes, fn.restype = argtypes, restype
    return fn


# The most CTAs of the global layout an SM runs (the grid is at most this
# many a streaming multiprocessor, and at most what the SM holds at once).
# By measurement (``python -m kmpc_tpu_torch.ops.row_slots --global``, B=1013
# H=20 N=1000): two CTAs an SM ran B at S=16 1.46x and C 1.57x faster than
# one, though their workspace (84 MB) then spills the 50 MB L2; kernel A's
# SM holds one CTA (its registers), so both grids are one CTA an SM there.
GLOBAL_CTAS_PER_SM = 2
_OCCUPANCY: Dict[tuple, int] = {}


def global_grid(kernel: CudaKernel, B: int, shape: tuple, allow_short: bool,
                device) -> int:
    """The persistent grid of a global-layout kernel for B problems:
    min(B, SMs x the CTAs an SM holds at once, at most
    GLOBAL_CTAS_PER_SM). ``shape`` is the kernel's occupancy
    query's (S, H, N), or (H, N) for kernel C; the built library answers
    it."""
    key = (kernel.name, shape, allow_short)
    if key not in _OCCUPANCY:
        fn = _library_function(kernel.name, kernel.symbol + "_ctas",
                               [_I] * (len(shape) + 1), ctypes.c_int)
        with torch.cuda.device(device):
            _OCCUPANCY[key] = fn(*shape, int(allow_short))
    resident = _OCCUPANCY[key]
    if resident < 1:
        raise RuntimeError(f"{kernel.name}: no CTA of shape {shape} fits an "
                           f"SM (occupancy query gave {resident})")
    per_sm = min(resident, GLOBAL_CTAS_PER_SM)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(B, per_sm * sms))


def global_workspace(nbytes: int, device, entry: str) -> torch.Tensor:
    """The global layout's workspace of ``nbytes`` on ``device``, or
    ``ValueError`` naming the bytes asked for where the card's free memory
    (and what the caching allocator holds unused) is less."""
    free = torch.cuda.mem_get_info(device)[0] + (
        torch.cuda.memory_reserved(device)
        - torch.cuda.memory_allocated(device))
    if nbytes > free:
        raise ValueError(
            f"{entry}: the global layout's workspace needs {nbytes} bytes, "
            f"more than the {free} bytes free on {device}")
    return torch.empty(max(nbytes // 4, 1), dtype=torch.float32,
                       device=device)


def _cluster_args(kernel: CudaKernel, r: torch.Tensor, adaptive: bool,
                  storage: Optional[str], ctas: Optional[int],
                  ring: Optional[Tuple[int, int]]):
    """(returns, the cluster kernel's trailing ints) of a cluster launch:
    the CTAs of ``cluster_plan`` (or ``ctas``), and for kernel B the ring
    and the returns' row stride, a multiple of 4, the returns copied with
    zero columns past N where N is not one or their rows are not 16-byte
    aligned (a bulk copy's rows). ``ValueError`` where no cluster of at
    most CLUSTER_MAX CTAs holds the shape."""
    scen = r.dim() == 4
    S, H, N = (r.shape[1] if scen else None), r.shape[-2], r.shape[-1]
    c, span, _, stages, chunk = cluster_plan(S, H, N, adaptive, storage,
                                             ring, ctas)
    if c == 0 or (c - 1) * span >= H:
        raise ValueError(f"{kernel.name}: no cluster of at most "
                         f"{CLUSTER_MAX} CTAs ({ctas or 'fewest'}) holds "
                         f"S={S}, H={H}, N={N}")
    if not scen:
        return r, (c,)
    ldr = -(-N // 4) * 4
    if ldr != N or r.data_ptr() % 16:
        padded = r.new_zeros(r.shape[:-1] + (ldr,))
        padded[..., :N] = r
        r = padded
    return r, (c, stages, chunk, ldr)


def _launch(kernel: CudaKernel, body: str, current_weights, r, params,
            w_warm, p_warm, return_dual, return_steps, storage=None,
            cluster_ctas=None, ring=None):
    """Launch ``kernel`` (running ``body``) on checked CUDA tensors and
    count the launch; a scenario kernel of the row, wide-row or cluster
    layout keeps the returns in ``storage`` (default: the one routing gives
    the shape); a global-layout kernel runs its persistent grid
    (``global_grid``) over a workspace of ``global_workspace_bytes``; a
    cluster kernel runs B clusters of ``cluster_plan``'s CTAs (or
    ``cluster_ctas``) and kernel B's ring (or ``ring``), and a cluster the
    card refuses raises ``RuntimeError`` naming the shape.
    ``allow_short`` needs a kernel of the block or global layout."""
    scen = r.dim() == 4
    B, H, N = r.shape[0], r.shape[-2], r.shape[-1]
    S = r.shape[1] if scen else 0
    short = params.allow_short
    if short and kernel not in _SHORT_ARG:
        raise ValueError(f"{kernel.name} projects on the simplex only: "
                         f"allow_short runs in the {SHORT_LAYOUTS} layouts")
    if kernel in _STORAGE_ARG:
        storage = storage or _storage(kernel, S, H, N)
    elif storage not in (None, "registers"):
        raise ValueError(f"{kernel.name} keeps no returns in {storage}")
    schedule = (params.adapt_every if params.adaptive
                else params.proj_refresh_every)
    w = torch.empty((B, H, N), dtype=torch.float32, device=r.device)
    fp = torch.empty(B, dtype=torch.float32, device=r.device)
    dual = torch.empty_like(w) if return_dual else None
    steps = torch.empty((B, 2 * H + 4), dtype=torch.float32,
                        device=r.device) if return_steps else None
    if B > 0:
        warm, warm_iters, cold_iters = _sweep_budgets(params, N)

        def ptr(t):
            return None if t is None else t.data_ptr()

        gmem, cmem, rk = (), (), r
        if kernel in _CLUSTER:
            rk, cmem = _cluster_args(kernel, r, params.adaptive, storage,
                                     cluster_ctas, ring)
        if kernel in _GLOBAL:
            grid = global_grid(kernel, B, (S, H, N), short, r.device)
            ws = global_workspace(
                global_workspace_bytes(S or None, H, N, grid), r.device,
                kernel.name)
            gmem = (ws.data_ptr(), grid)
        args = (
            current_weights.data_ptr(), rk.data_ptr(), ptr(w_warm),
            ptr(p_warm), w.data_ptr(), fp.data_ptr(), ptr(dual),
            *((ptr(steps),) if params.adaptive else ()),
            *((B, S) if scen else (B,)), H, N, params.max_iters,
            schedule, warm_iters, cold_iters,
            params.cost_coeff, params.max_turnover, params.ridge,
            params.over_relax, params.step_scale, params.sigma_scale,
            int(params.precond), int(params.max_turnover > 0), int(warm),
            *((int(body == "pipe"),) if kernel in _PIPE_FLAG else ()),
            *((STORAGES.index(storage),) if kernel in _STORAGE_ARG
              else ()),
            *((int(short),) if kernel in _SHORT_ARG else ()),
            *gmem, *cmem,
        )
        try:
            kernel.launch(r.device, *args)
        except RuntimeError as e:
            if kernel not in _CLUSTER:
                raise
            raise RuntimeError(
                f"{kernel.name}: the card refused a cluster of {cmem[0]} "
                f"CTAs for S={S or None}, H={H}, N={N} ({e})") from e
        if kernel in _STORAGE_ARG:
            key = (kernel.name, storage)
            STORAGE_LAUNCHES[key] = STORAGE_LAUNCHES.get(key, 0) + 1
        if short:
            SHORT_LAUNCHES[kernel.name] = SHORT_LAUNCHES.get(kernel.name,
                                                             0) + 1
    out = (w, fp) + ((dual,) if return_dual else ())
    return out + ((steps,) if return_steps else ())


def pdhg_log_utility(
    current_weights: torch.Tensor,
    r: torch.Tensor,
    params: MPCParams,
    w_warm: Optional[torch.Tensor] = None,
    p_warm: Optional[torch.Tensor] = None,
    return_dual: bool = False,
):
    """The kernel for CUDA tensors, its plain version for CPU tensors."""
    if not r.is_cuda:
        return pdhg_log_utility_plain(current_weights, r, params, w_warm,
                                      p_warm, return_dual)
    return pdhg_log_utility_cuda(current_weights, r, params, w_warm, p_warm,
                                 return_dual)


def _finalize_packed(w, r, w_init, params: MPCParams, fp_res):
    """Turnover restoration, hold-current-weights for non-finite solves (a
    rule of the program) and the info dict, as kmpc_tpu's
    ``_finalize_packed``. ``turnover_violation`` is measured before the
    restoration. ``r`` may carry a scenario axis [B, S, H, N]: the
    objective is then the scenario mean of the log growth."""
    tau_to = params.max_turnover
    use_ball = tau_to > 0
    u_pre = w - _prev_rows(w, w_init)
    if use_ball:
        to_viol = torch.clamp(u_pre.abs().sum(dim=-1) - tau_to, min=0.0).amax(dim=-1)
        if params.restore_feasibility:
            w = restore_turnover_feasibility(w, w_init, tau_to)
    else:
        to_viol = torch.zeros(w.shape[:-2], dtype=w.dtype, device=w.device)

    finite = torch.isfinite(fp_res)
    if use_ball and params.restore_feasibility:
        converged = finite
    else:
        converged = finite & (to_viol <= params.feas_tol)

    hold = w_init[:, None, :].expand_as(w)
    w = torch.where(finite[:, None, None], w, hold)
    if r.dim() == 4:
        objective = scenario_objective(w, r, w_init, params.cost_coeff)
    else:
        objective = _log_utility_objective(w, r, w_init, params.cost_coeff)
    info = {
        "objective": objective,
        "converged": converged,
        "turnover_violation": to_viol,
        "fixed_point_residual": fp_res,
        "status_code": _status_code(fp_res, params.feas_tol),
    }
    return w, info


def _solve_packed(entry, current_weights, log_returns, params, device,
                  w_warm, p_warm, return_dual):
    reject_unhonored_polish(params, entry)
    dev = torch.device(device)

    def f32(t):
        return None if t is None else \
            t.to(device=dev, dtype=torch.float32).contiguous()

    y, w_init = f32(log_returns), f32(current_weights)
    w_warm, p_warm = f32(w_warm), f32(p_warm)
    r = torch.exp(y)
    out = pdhg_log_utility(w_init, r, params, w_warm, p_warm, return_dual)
    w, info = _finalize_packed(out[0], r, w_init, params, out[1])
    if y.dim() == 4:
        info["num_scenarios"] = y.shape[1]
    if return_dual:
        info["dual"] = out[2]
    return w, info


def solve_mpc_log_utility_packed(
    current_weights: torch.Tensor,
    predicted_log_returns: torch.Tensor,
    params: MPCParams,
    device="cuda",
    w_warm: Optional[torch.Tensor] = None,
    p_warm: Optional[torch.Tensor] = None,
    return_dual: bool = False,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Batched solve: [B, N] x [B, H, N] -> (w [B, H, N], info).

    ``device`` is where the solve runs: a CUDA device launches the kernel,
    ``"cpu"`` runs the plain version. info holds ``objective``,
    ``converged``, ``turnover_violation``, ``fixed_point_residual`` and
    ``status_code`` per problem and, with ``return_dual``, the final
    ``dual`` [B, H, N]. ``w_warm`` / ``p_warm`` [B, H, N] continue from an
    earlier solve's iterates (e.g. the previous Jacobi sweep's).
    """
    return _solve_packed(
        "solve_mpc_log_utility_packed", current_weights,
        predicted_log_returns, params, device, w_warm, p_warm, return_dual)


def solve_mpc_log_utility_scenarios_packed(
    current_weights: torch.Tensor,
    scenario_log_returns: torch.Tensor,
    params: MPCParams,
    device="cuda",
    w_warm: Optional[torch.Tensor] = None,
    p_warm: Optional[torch.Tensor] = None,
    return_dual: bool = False,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Batched scenario-averaged Kelly solve: [B, N] x [B, S, H, N] ->
    (w [B, H, N], info), the contract of ``solve_mpc_log_utility_packed``
    with ``info['num_scenarios']`` added."""
    if scenario_log_returns.dim() != 4:
        raise ValueError(
            "expected scenario_log_returns [B, S, H, N], got "
            f"{tuple(scenario_log_returns.shape)}")
    return _solve_packed(
        "solve_mpc_log_utility_scenarios_packed", current_weights,
        scenario_log_returns, params, device, w_warm, p_warm, return_dual)
