"""Fused mean-variance MPC solve (the Markowitz baseline's program): the
hand-written CUDA kernels, their plain PyTorch version, and the wrapper.

Port of kmpc_tpu/ops/mpc_pallas.py ``solve_mpc_mean_variance_pallas_packed``
(the TPU kernel ``_make_packed_mv_kernel``):

    min_w  sum_t [gamma w_t' Sigma w_t - w_t.mu_t] + c sum_t ||u_t||_1
    s.t.   w_t on the simplex.

One launch runs the whole Condat-Vu iteration: the quadratic gradient
Sigma w_t in plain float32, the simplex projection with a carried Michelot
threshold (full warm budget, the refresh schedule of
``proj_refresh_every``, or cold projections), the dual prox as a clip to
[-c, c] (the program has no turnover ball), and over-relaxation; a final
primal half-step gives the returned iterate and the fixed-point residual.
With ``adaptive`` the steps are carried per problem and balanced by the
primal and dual residuals on every ``adapt_every``-th iteration, and the
refresh schedule is off. The covariance is per problem ([B, N, N]) or one
matrix shared by the batch ([N, N] or [1, N, N]); it is symmetrised first.

Three layouts, chosen by the shape and, where the tile layout streams a
shared Sigma, the batch (``mv_kernel_layout``, as ``chip_smoke.py``'s
``mv_layouts`` measured them): the lane layout at H=1 up to 128 assets
(``csrc/pdhg_mean_variance_lanes.cu``, ``..._lanes_adaptive.cu``: one warp
per problem, Sigma's row in the lane's registers up to 32 assets, else
Sigma in shared memory, w broadcast through a per-warp shared vector, the
threshold's sweeps summed in every lane up to ``LANES_INLANE_MAX_B``
problems of at most 32 assets, else by the warp butterfly:
``mv_lanes_sweep``); the tile layout
(``csrc/pdhg_mean_variance_tile.cu``, ``..._tile_adaptive.cu``: one warp
per (problem, horizon row), P problems a CTA, the product Sigma W taken by
the whole CTA with one Sigma a CTA, resident or streamed through a ring of
shared-memory stages) where its plan fits (``mv_tile_smem_bytes``,
``mv_tile_problems``: H <= 32) and Sigma is resident, or streamed at H >= 3
or for more than 132 problems sharing it; else one block per problem with
the iterates in shared memory (``csrc/pdhg_mean_variance_block.cu``,
``..._block_adaptive.cu``) where they fit a block's 227 KB
(``mv_block_smem_bytes``: five [H, N] arrays and the reduce staging; Sigma
is staged beside them where it fits, else read from global memory); else
the tile layout where its plan fits; else the global layout, the block
layout's body with its iterates in a global-memory workspace, one slot a
CTA of a persistent grid (``csrc/pdhg_mean_variance_global.cu``,
``..._global_adaptive.cu``: H=20 N=1000, H >= 33 N >= 500, where kmpc_tpu's
wrapper hands the solve to its XLA solver). Together they take every shape:
only a global workspace past the card's free memory raises. The warp layout before the lane layout
(``csrc/pdhg_mean_variance.cu``, ``..._adaptive.cu``: one warp per problem,
Sigma in shared memory, w broadcast by shuffles, the sweeps by butterflies)
takes the same shapes and is launched only by ``_mv_launch``, to be
compared with it.

``allow_short`` (the primal projected on the hyperplane sum(w) = 1, no
threshold carried, as kmpc_tpu's XLA solver does it) runs in the block
layout where one problem's iterates fit a block's shared memory, else in
the global layout, by a flag of their kernels. A CUDA tensor launches a
kernel or raises; a CPU tensor runs ``pdhg_mean_variance_plain``.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from kmpc_tpu_torch._build import CudaKernel
from kmpc_tpu_torch.ops.mpc import (
    MPCParams,
    _balance_steps,
    _prev_rows,
    _status_code,
    mean_variance_objective,
    reject_unhonored_polish,
)
from kmpc_tpu_torch.ops import mpc_cuda
from kmpc_tpu_torch.ops.mpc_cuda import (
    MAX_SLOTS,
    SMEM_PER_BLOCK,
    _check_return_steps,
    _moved,
    _require_cuda_f32,
    _sweep_budgets,
    block_threads,
    kernel_supports,
    project_primal,
)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

# (cw, mu, sigma, w_out, fp_out), B, H, N, shared, max_iters, the schedule
# (``proj_refresh_every``; ``adapt_every`` for the adaptive kernel), the
# sweep budgets, the scalars, warm, the stream.
# The adaptive kernel takes one more pointer after fp_out: steps_out; the
# tile kernels one more int after shared: the problems a CTA.
_ARGTYPES = [_I] * 8 + [_F] * 5 + [_I, _P]
_TILE_ARGTYPES = [_I] * 9 + [_F] * 5 + [_I, _P]
PDHG_MEAN_VARIANCE = CudaKernel(
    "pdhg_mean_variance", "kmpc_pdhg_mean_variance", [_P] * 5 + _ARGTYPES)
PDHG_MEAN_VARIANCE_ADAPTIVE = CudaKernel(
    "pdhg_mean_variance_adaptive", "kmpc_pdhg_mean_variance_adaptive",
    [_P] * 6 + _ARGTYPES)
# The block-per-problem layout, with the same C interfaces and the
# ``allow_short`` int (1: the hyperplane projection) before the stream; the
# global layout, with the workspace and the grid after it.
_SHORT_ARGTYPES = _ARGTYPES[:-1] + [_I, _P]
_GLOBAL_ARGTYPES = _SHORT_ARGTYPES[:-1] + [_P, _I, _P]
PDHG_MEAN_VARIANCE_BLOCK = CudaKernel(
    "pdhg_mean_variance_block", "kmpc_pdhg_mean_variance_block",
    [_P] * 5 + _SHORT_ARGTYPES)
PDHG_MEAN_VARIANCE_BLOCK_ADAPTIVE = CudaKernel(
    "pdhg_mean_variance_block_adaptive",
    "kmpc_pdhg_mean_variance_block_adaptive", [_P] * 6 + _SHORT_ARGTYPES)
PDHG_MEAN_VARIANCE_GLOBAL = CudaKernel(
    "pdhg_mean_variance_global", "kmpc_pdhg_mean_variance_global",
    [_P] * 5 + _GLOBAL_ARGTYPES)
PDHG_MEAN_VARIANCE_GLOBAL_ADAPTIVE = CudaKernel(
    "pdhg_mean_variance_global_adaptive",
    "kmpc_pdhg_mean_variance_global_adaptive", [_P] * 6 + _GLOBAL_ARGTYPES)
# The tile layout.
PDHG_MEAN_VARIANCE_TILE = CudaKernel(
    "pdhg_mean_variance_tile", "kmpc_pdhg_mean_variance_tile",
    [_P] * 5 + _TILE_ARGTYPES)
PDHG_MEAN_VARIANCE_TILE_ADAPTIVE = CudaKernel(
    "pdhg_mean_variance_tile_adaptive",
    "kmpc_pdhg_mean_variance_tile_adaptive", [_P] * 6 + _TILE_ARGTYPES)
# The lane layout (one horizon row), with the tile kernels' C interface:
# the sweep (1 in every lane, 0 by the warp butterfly) after ``shared``.
PDHG_MEAN_VARIANCE_LANES = CudaKernel(
    "pdhg_mean_variance_lanes", "kmpc_pdhg_mean_variance_lanes",
    [_P] * 5 + _TILE_ARGTYPES)
PDHG_MEAN_VARIANCE_LANES_ADAPTIVE = CudaKernel(
    "pdhg_mean_variance_lanes_adaptive",
    "kmpc_pdhg_mean_variance_lanes_adaptive", [_P] * 6 + _TILE_ARGTYPES)
# The cluster layout, with the block kernels' C interfaces less
# ``allow_short``, and the cluster's CTAs before the stream.
_CLUSTER_ARGTYPES = _ARGTYPES[:-1] + [_I, _P]
PDHG_MEAN_VARIANCE_CLUSTER = CudaKernel(
    "pdhg_mean_variance_cluster", "kmpc_pdhg_mean_variance_cluster",
    [_P] * 5 + _CLUSTER_ARGTYPES)
PDHG_MEAN_VARIANCE_CLUSTER_ADAPTIVE = CudaKernel(
    "pdhg_mean_variance_cluster_adaptive",
    "kmpc_pdhg_mean_variance_cluster_adaptive",
    [_P] * 6 + _CLUSTER_ARGTYPES)
# (layout, adaptive) -> kernel
_MV_KERNELS = {
    ("warp", False): PDHG_MEAN_VARIANCE,
    ("warp", True): PDHG_MEAN_VARIANCE_ADAPTIVE,
    ("block", False): PDHG_MEAN_VARIANCE_BLOCK,
    ("block", True): PDHG_MEAN_VARIANCE_BLOCK_ADAPTIVE,
    ("tile", False): PDHG_MEAN_VARIANCE_TILE,
    ("tile", True): PDHG_MEAN_VARIANCE_TILE_ADAPTIVE,
    ("lanes", False): PDHG_MEAN_VARIANCE_LANES,
    ("lanes", True): PDHG_MEAN_VARIANCE_LANES_ADAPTIVE,
    ("global", False): PDHG_MEAN_VARIANCE_GLOBAL,
    ("global", True): PDHG_MEAN_VARIANCE_GLOBAL_ADAPTIVE,
    ("cluster", False): PDHG_MEAN_VARIANCE_CLUSTER,
    ("cluster", True): PDHG_MEAN_VARIANCE_CLUSTER_ADAPTIVE,
}
MV_KERNELS = tuple(_MV_KERNELS.values())
_MV_GLOBAL = (PDHG_MEAN_VARIANCE_GLOBAL, PDHG_MEAN_VARIANCE_GLOBAL_ADAPTIVE)
_MV_CLUSTER = (PDHG_MEAN_VARIANCE_CLUSTER,
               PDHG_MEAN_VARIANCE_CLUSTER_ADAPTIVE)
# The kernels that take the ``allow_short`` flag.
_MV_SHORT_ARG = (PDHG_MEAN_VARIANCE_BLOCK,
                 PDHG_MEAN_VARIANCE_BLOCK_ADAPTIVE) + _MV_GLOBAL


def mv_smem_bytes(N: int) -> int:
    """Shared memory of one covariance in the kernel: N columns of
    ceil32(N) floats (per warp with a per-problem covariance, per block
    with a shared one)."""
    return N * 32 * (-(-N // 32)) * 4


def mv_kernel_supports(H: int, N: int) -> bool:
    """Whether the warp-layout kernel takes horizon H and N assets: one
    horizon row (past it the tile layout measured faster), at most
    MAX_SLOTS register slots a lane, and one covariance within a block's
    shared memory."""
    return (H == 1 and kernel_supports(H, N)
            and mv_smem_bytes(N) <= SMEM_PER_BLOCK)


# The lane layout's plan (``mv_lanes_plan`` in
# csrc/pdhg_mean_variance_lanes.cuh, whose values the built library reports
# as ``kmpc_mv_lanes_warps`` and ``kmpc_mv_lanes_smem_bytes``).
LANES_MAX_WARPS = 4


def _lanes_vec(N: int) -> int:
    """Floats of a warp's broadcast vector: N rounded up to 8 within one
    slot, else the slots' 32 lanes each."""
    K = -(-N // 32)
    return -(-N // 8) * 8 if K == 1 else 32 * K


def mv_lanes_plan(N: int, shared: bool) -> Optional[Tuple[int, int]]:
    """(warps a CTA, bytes of shared memory a CTA) of the lane layout, or
    None where it does not take N: each warp's two vectors (w, and the
    in-lane sweep's staged values, ``_lanes_vec`` floats each); past 32 assets
    Sigma as N columns of 32 ceil(N/32) floats, per warp (as many
    warps, up to four, as fit a block) or once a CTA when shared. Up to 32
    assets Sigma's rows lie in the lanes' registers."""
    K = -(-N // 32)
    if N < 1 or K > MAX_SLOTS:
        return None
    vec = 2 * _lanes_vec(N)
    sig = 0 if K == 1 else N * 32 * K
    warps = LANES_MAX_WARPS
    if not shared and sig:
        warps = min(warps, SMEM_PER_BLOCK // 4 // (vec + sig))
    floats = warps * vec + (sig if shared else warps * sig)
    if warps < 1 or 4 * floats > SMEM_PER_BLOCK:
        return None
    return warps, 4 * floats


# The lane layout's two sweeps of the simplex threshold: in every lane
# (each lane sums the staged active values: no butterfly on the
# iteration's chain), or by the warp butterfly (the work spread over the
# lanes: a ballot count and a five-level sum). ``chip_smoke.py``'s
# ``mv_layouts`` measured the in-lane sweep faster at one slot up to
# B=1028 (where one warp's chain sets the pace) and the butterfly faster
# at B=4096 and past (where the issue slots do); no batch between was
# measured, and the switch sits at the last batch measured in-lane's
# (PERF.md section 6). Past one slot the staged vector is 32 K floats a
# sweep: the butterfly is taken, and the in-lane sweep is not compiled.
LANES_SWEEPS = ("inlane", "butterfly")
LANES_INLANE_MAX_B = 1028


def mv_lanes_sweeps(N: int) -> Tuple[str, ...]:
    """The sweeps the lane layout is compiled with at N assets."""
    return LANES_SWEEPS if N <= 32 else ("butterfly",)


def mv_lanes_sweep(B: int, N: int) -> str:
    """The sweep the lane layout runs for B problems of N assets."""
    return "inlane" if B <= LANES_INLANE_MAX_B and N <= 32 else "butterfly"


def _mv_block_iterate_floats(H: int, N: int) -> int:
    return 5 * H * N + N + H + 4 + block_threads(N) // 32 * 2 * H


def mv_sigma_staged(H: int, N: int) -> bool:
    """Whether the block layout stages the covariance in shared memory
    beside the iterates (else each iteration reads it from global
    memory)."""
    return 4 * (_mv_block_iterate_floats(H, N) + N * N) <= SMEM_PER_BLOCK


def mv_block_smem_bytes(H: int, N: int) -> int:
    """Shared memory of one problem in the block layout (``mv_block_plan``
    in csrc/pdhg_mean_variance_block.cuh, whose value the built library
    reports as ``kmpc_mv_block_smem_bytes``): w, p, mu, the projection
    input and the dual input as [H][N]; the current weights; the per-row
    thresholds; four residual slots; each warp's staging of the largest
    stacked reduce (a sweep's count and sum of every row); and the
    covariance [N][N] where all of it fits a block. A per-problem and a
    shared covariance take the same plan."""
    sigma = N * N if mv_sigma_staged(H, N) else 0
    return 4 * (_mv_block_iterate_floats(H, N) + sigma)


def _mv_small_floats(H: int, N: int) -> int:
    """Floats of the thresholds, residuals and reduce staging of one CTA
    (``mv_small_floats`` in csrc/pdhg_mean_variance_block.cuh)."""
    return H + 4 + block_threads(N) // 32 * 2 * H


def mv_global_smem_bytes(H: int, N: int) -> int:
    """Shared memory of one CTA in the global layout (``mv_global_plan``):
    the thresholds, residuals and reduce staging where they fit a block's
    shared memory, else none."""
    small = 4 * _mv_small_floats(H, N)
    return small if small <= SMEM_PER_BLOCK else 0


def mv_global_workspace_bytes(H: int, N: int, grid: int) -> int:
    """Bytes of kernel C's global-layout workspace for a grid of ``grid``
    CTAs (``mv_global_plan`` in csrc/pdhg_mean_variance_block.cuh): each
    CTA's slot holds w, p, the projection input and the dual input as
    [H][N] (mu, the current weights and Sigma are read in place), and the
    thresholds, residuals and reduce staging where they do not fit shared
    memory."""
    floats = 4 * H * N
    if mv_global_smem_bytes(H, N) == 0:
        floats += _mv_small_floats(H, N)
    return 4 * floats * grid


# The cluster layout (csrc/pdhg_mean_variance_cluster.cuh): the block
# layout's body with one problem's asset columns split over a thread-block
# cluster of C CTAs (C divides the block's warps, at most MV_CLUSTER_MAX, a
# non-portable size past 8), each CTA holding w whole, its own columns of
# the other iterates and the first rows of its own columns of Sigma.
MV_CLUSTER_MAX = 16


def mv_cluster_plan(
        H: int, N: int, C: int,
        adaptive: bool) -> Optional[Tuple[int, int, int, int, int]]:
    """(C, threads a CTA, local column slots a CTA, rows of Sigma staged,
    bytes of shared memory a CTA) of the cluster layout with C CTAs
    (``mv_cluster_plan`` in csrc/pdhg_mean_variance_cluster.cuh, whose
    values the built library reports as ``kmpc_mv_cluster_bytes`` and
    ``kmpc_mv_cluster_rows``), or None where C is below 2, does not divide
    the block's warps, passes MV_CLUSTER_MAX, or the iterates do not fit:
    w [H][ceil4(N)] (every column), the own columns of p, mu, the
    projection input and (adaptive) the dual input [H][LW] (LW = ceil(N /
    T) T / C, T = ``block_threads(N)``), the own current weights [LW], the
    thresholds [H], four residual slots and two reduce stagings [T / 32][2
    H], rounded up to four floats; then Sigma's own columns column-major,
    [LW][S]: every row where the rest of a block's shared memory holds them
    (S the least stride of at least N that is 4 mod 8), else as many rows
    as the largest such stride the rest holds."""
    T = block_threads(N)
    NW = T // 32
    if H < 1 or N < 1 or not 2 <= C <= MV_CLUSTER_MAX or NW % C:
        return None
    Tc = T // C
    LW = -(-N // T) * Tc
    floats = (H * (-(-N // 4) * 4) + (4 if adaptive else 3) * H * LW + LW
              + H + 4 + 2 * NW * 2 * H)
    floats = -(-floats // 4) * 4
    room = SMEM_PER_BLOCK // 4 - floats
    if room < 0:
        return None
    most = room // LW
    s4 = most - (most - 4) % 8 if most >= 4 else 0
    rows, stride = (N, N + (4 - N) % 8) if N <= s4 else (s4, s4)
    return C, Tc, LW, rows, 4 * (floats + stride * LW)


def mv_cluster_sizes(H: int, N: int, adaptive: bool) -> Tuple[int, ...]:
    """The cluster sizes (2 up to MV_CLUSTER_MAX) whose plan takes the
    shape."""
    return tuple(c for c in range(2, MV_CLUSTER_MAX + 1)
                 if mv_cluster_plan(H, N, c, adaptive) is not None)


# The cluster size routing asks for, as measured (``row_slots.py
# --mv-cluster``, 200 iterations at one row and 100 past it, 50 at B=1013;
# NVIDIA H100 80GB HBM3, 700 W; us an iteration, fixed body, a covariance
# per problem unless named). Two CTAs, the most problems in flight, nearly
# everywhere: one row N=1000 B=132 195 (4 CTAs 235, 8 215, 16 238), B=1013
# 1513 (1684, 1618, 1814), N=500 B=132 34 (40, 57, 52), B=1013 249 (270,
# 426, 353); H=20 N=1000 B=32 395 (585, 776, 909), shared 312 (470, 652,
# 906), B=1013 6894 (12125, 19710, 27039); H=33 N=500 B=132 476 (689, 589,
# 1311). Sixteen at one row past 512 assets for at most
# MV_CLUSTER_FEW_B problems, each problem's chain the shortest (N=1000
# B=32: 63 against 76 at two); four up to 256 assets (N=240 B=1013: 68
# against 91 at two and 72 at eight). The adaptive plan takes no two CTAs
# at H=20 N=1000, so four there.
MV_CLUSTER_FEW_B = 32


def mv_cluster_ctas(H: int, N: int, adaptive: bool, B: int = 1) -> int:
    """The cluster size routing launches for B problems: the size the
    measurements above name (16 at one row past 512 assets for at most
    MV_CLUSTER_FEW_B problems, 4 at one row up to 256 assets, else 2), or
    where the plan refuses it the largest size below it that the plan
    takes, else the least; 0 where no size takes the shape."""
    sizes = mv_cluster_sizes(H, N, adaptive)
    if not sizes:
        return 0
    want = 2
    if H == 1 and N > 512 and B <= MV_CLUSTER_FEW_B:
        want = 16
    elif H == 1 and N <= 256:
        want = 4
    below = [c for c in sizes if c <= want]
    return below[-1] if below else sizes[0]


def mv_cluster_supports(H: int, N: int) -> bool:
    """Whether the cluster kernels take this shape: a cluster of 2 to
    MV_CLUSTER_MAX CTAs holds the adaptive body's iterates (the larger
    plan)."""
    return bool(mv_cluster_sizes(H, N, True))


# The tile layout's plan (``mv_tile_layout`` and ``mv_tile_problems`` in
# csrc/pdhg_mean_variance_tile.cuh, whose values the built library reports
# as ``kmpc_mv_tile_smem_bytes``, ``kmpc_mv_tile_ring_rows`` and
# ``kmpc_mv_tile_problems``).
TILE_MAX_WARPS = 32
TILE_SMS = 132          # SMs of an H100 SXM: the plan's wave
TILE_STAGES = 3         # the ring of Sigma's row blocks
TILE_RING_ROWS = (16, 8, 4)


def _tile_hb(C: int) -> int:
    return 8 if C <= 8 else (20 if C <= 20 else 32)


def _tile_items(hb: int) -> int:
    """Register tiles (4 x 8 floats) of a streamed product a thread holds
    across a ring's stages, by the warps the kernel is compiled for."""
    return 2 if hb == 8 else 1


def _tile_floats(P: int, H: int, N: int, adaptive: bool, rc: int):
    """(floats of the tile plan before Sigma, CP) at product tile width
    ``rc``."""
    C = P * H
    CP = -(-C // rc) * rc
    KW = -(-N // 32) * 32
    rows = C * (2 + (1 if N > 128 else 0) + (1 if H > 1 else 0)
                + (2 if adaptive and H > 1 else 0))
    return (N * CP + rows * KW + (2 * C * 32 if adaptive else 0)
            + -(-C // 4) * 4), CP


def mv_tile_plan(P: int, H: int, N: int,
                 adaptive: bool) -> Optional[Tuple[int, int]]:
    """(bytes of shared memory, rows of Sigma a ring stage holds, 0 where
    Sigma is resident) of a tile-layout CTA of P problems, or None where the
    plan does not fit: W^T [N][CP] (C = P H warps, CP = C rounded up to the
    product's tile width, 4 with Sigma resident and 8 streamed), the rows'
    w [C][KW] past 128 assets (KW = ceil32(N)), G then the projection
    input and the dual [C][KW] each, wbar [C][KW] where H > 1, the moves
    dw and dp [C][KW] each where H > 1 and the lanes' residual partials
    [2][C][32] with the adaptive body, a reduce staging of C floats
    rounded up to four; then Sigma [N][ceil4(N)] resident where it fits a
    block's shared memory, else a ring of three stages of Tj rows (the
    largest of 16, 8, 4 that fits) where every thread's 4 x 8 tiles of G,
    ceil4(N) / 4 x CP / 8 of them over 32 C threads, fit its registers."""
    if P < 1 or H < 1 or N < 1 or P * H > TILE_MAX_WARPS:
        return None
    NP = -(-N // 4) * 4
    limit = SMEM_PER_BLOCK // 4
    floats, _ = _tile_floats(P, H, N, adaptive, 4)
    if floats + N * NP <= limit:
        return 4 * (floats + N * NP), 0
    floats, CP = _tile_floats(P, H, N, adaptive, 8)
    if (NP // 4) * (CP // 8) > _tile_items(_tile_hb(P * H)) * 32 * P * H:
        return None
    for tj in TILE_RING_ROWS:
        if floats + TILE_STAGES * tj * NP <= limit:
            return 4 * (floats + TILE_STAGES * tj * NP), tj
    return None


def mv_tile_smem_bytes(P: int, H: int, N: int,
                       adaptive: bool) -> Optional[int]:
    """Shared memory of a tile-layout CTA of P problems (``mv_tile_plan``),
    or None where the plan does not fit."""
    plan = mv_tile_plan(P, H, N, adaptive)
    return None if plan is None else plan[0]


def mv_tile_problems(B: int, H: int, N: int, shared: bool,
                     adaptive: bool) -> int:
    """Problems a CTA of the tile layout for B problems: 1 with a
    per-problem covariance (a CTA holds one Sigma); with a shared one the
    largest P whose plan fits (P H <= 32) among those whose waves times P,
    ceil(ceil(B / P) / 132) P, are least. 0 where the layout does not take
    the shape."""
    if B < 1 or H < 1 or N < 1 or H > TILE_MAX_WARPS:
        return 0
    if not shared:
        return 1 if mv_tile_plan(1, H, N, adaptive) else 0
    best, best_cost = 0, 0
    for P in range(1, TILE_MAX_WARPS // H + 1):
        if mv_tile_plan(P, H, N, adaptive) is None:
            continue
        ctas = -(-B // P)
        cost = -(-ctas // TILE_SMS) * P
        if best == 0 or cost <= best_cost:
            best, best_cost = P, cost
    return best


# Where the tile layout streams Sigma, it is taken at H >= TILE_STREAM_H
# (per problem: below it the CTA's few warps leave the product's tile
# mostly padding, and the block layout measured faster), or with a shared
# Sigma for more than TILE_SMS problems (below that the block layout's one
# CTA a problem measured faster at one row).
TILE_STREAM_H = 3
# Past BLOCK_FIRST_N assets the block layout, where one problem fits a
# block, is taken before the tile layout: by the fixed-step body unless more
# than TILE_SMS problems share Sigma or run H >= TILE_STREAM_H rows; by the
# adaptive body for at most TILE_SMS problems at H >= TILE_STREAM_H
# (``chip_smoke.py``'s ``mv_layouts``: the block body 1.05-1.2x ahead of
# the tile layout there, the tile layout 1.05-1.7x ahead at the other
# switch shapes).
BLOCK_FIRST_N = 128


def mv_tile_streams(H: int, N: int, adaptive: bool) -> bool:
    """Whether the tile layout streams Sigma at this shape: the plan of one
    problem a CTA does not hold it resident (or does not fit)."""
    plan = mv_tile_plan(1, H, N, adaptive)
    return plan is None or plan[1] > 0


def mv_cluster_first(H: int, N: int, shared: bool) -> bool:
    """Whether routing takes the cluster layout where another layout also
    takes the shape: one horizon row with a covariance per problem past
    the block layout's staging (``mv_sigma_staged``), where the block
    layout streams each problem's Sigma from device memory every
    iteration (measured, us an iteration, the cluster layout at
    ``mv_cluster_ctas``' size against the block layout, fixed / adaptive:
    N=1000 B=32 63 / 81 against 306 / 320, B=132 195 / 205 against 335 /
    349, B=1013 1513 / 1592 against 1725 / 1752; N=500 B=132 34 / 38
    against 86 / 89, B=1013 249 / 284 against 438 / 446; N=240 B=132 12 /
    14 against 22 / 25, B=1013 68 / 80 against 107 / 110). A shared Sigma
    stays in the block and tile layouts (the cluster layout at two CTAs
    measured 2-4x faster than the block layout up to 132 problems, and
    the tile layout 3-4x faster than it at B=1013: a routing change of
    its own)."""
    return (H == 1 and not shared and not mv_sigma_staged(H, N)
            and mv_cluster_supports(H, N))


def mv_kernel_layout(H: int, N: int, shared: bool = False,
                     adaptive: bool = False, B: int = 1,
                     allow_short: bool = False) -> Optional[str]:
    """The layout a CUDA mean-variance solve of B problems of this shape
    runs in, as measured fastest (``chip_smoke.py``'s ``mv_layouts``):
    ``"lanes"`` at one horizon row where its plan takes N (at most 128
    assets: ``mv_lanes_plan``; the warp layout, which takes the same
    shapes, measured slower); else ``"block"`` past BLOCK_FIRST_N assets
    where one problem's iterates fit a block's shared memory and the body
    and batch are those BLOCK_FIRST_N names; else ``"tile"`` where its plan
    takes the batch (``mv_tile_problems``) and holds Sigma resident, or
    streams it at H >= TILE_STREAM_H or with a shared Sigma for more than
    TILE_SMS problems; else ``"block"`` where one problem's iterates fit a
    block's shared memory; else ``"tile"`` where its plan takes the batch;
    else
    ``"global"`` (the block layout's body with its iterates in a
    global-memory workspace: every shape). With ``allow_short`` (the
    hyperplane projection, in the block and global layouts only)
    ``"block"`` where one problem's iterates fit a block's shared memory,
    else ``"global"``. ``"cluster"`` (``mv_cluster_first``) before the
    block and tile layouts at one row with a covariance per problem past
    the block layout's staging, and in place of the global layout wherever
    a cluster holds the shape (H=20 N=1000, us an iteration, fixed /
    adaptive: B=32 395 / 615 against 2194 / 2278, shared 312 / 500 against
    1398 / 1410; B=1013 6894 / 12710 against 9929 / 19003, shared 5020 /
    8827 against 8230 / 12948; H=33 N=500 B=132 476 / 560 against 1004 /
    1071, shared 414 / 468 against 679 / 717). None only for H or N below
    1."""
    if H < 1 or N < 1:
        return None
    block = mv_block_smem_bytes(H, N) <= SMEM_PER_BLOCK
    if allow_short:
        return "block" if block else "global"
    if H == 1 and mv_lanes_plan(N, shared) is not None:
        return "lanes"
    if mv_cluster_first(H, N, shared):
        return "cluster"
    few, rows = B <= TILE_SMS, H >= TILE_STREAM_H
    if block and N > BLOCK_FIRST_N and (
            few and rows if adaptive else few or not (shared or rows)):
        return "block"
    tile = mv_tile_problems(max(B, 1), H, N, shared, adaptive) > 0
    if tile and (not mv_tile_streams(H, N, adaptive) or H >= TILE_STREAM_H
                 or (shared and B > TILE_SMS)):
        return "tile"
    if block:
        return "block"
    if tile:
        return "tile"
    return "cluster" if mv_cluster_supports(H, N) else "global"


_CLUSTERS: Dict[tuple, int] = {}


def mv_cluster_clusters(kernel: CudaKernel, H: int, N: int, C: int,
                        device) -> int:
    """Clusters of C CTAs of ``kernel`` at this shape that the card runs at
    once (cudaOccupancyMaxActiveClusters, asked of the built library; 0
    where it runs none or refuses the size)."""
    key = (kernel.name, H, N, C, str(device))
    if key not in _CLUSTERS:
        fn = mpc_cuda._library_function(
            kernel.name, kernel.symbol + "_clusters", [_I] * 3, ctypes.c_int)
        with torch.cuda.device(device):
            _CLUSTERS[key] = max(fn(H, N, C), 0)
    return _CLUSTERS[key]


def mv_cluster_launch_ctas(kernel: CudaKernel, H: int, N: int,
                           adaptive: bool, device, B: int = 1) -> int:
    """The cluster size a routed launch of B problems takes:
    ``mv_cluster_ctas``' where the card runs it, else the largest other
    size of ``mv_cluster_sizes`` that it runs; 0 where it runs none
    (routing then takes the global layout, before any launch)."""
    first = mv_cluster_ctas(H, N, adaptive, B)
    if not first:
        return 0
    rest = sorted(set(mv_cluster_sizes(H, N, adaptive)) - {first},
                  reverse=True)
    for c in (first, *rest):
        if mv_cluster_clusters(kernel, H, N, c, device) >= 1:
            return c
    return 0


def _is_shared(cov: torch.Tensor) -> bool:
    return cov.dim() == 2 or (cov.dim() == 3 and cov.shape[0] == 1)


def pdhg_mean_variance_plain(
    current_weights: torch.Tensor,
    mu: torch.Tensor,
    Sigma: torch.Tensor,
    params: MPCParams,
    return_steps: bool = False,
):
    """The kernel's computation in plain tensor code: current_weights
    [B, N], mu [B, H, N], a symmetric Sigma [B, N, N] or [N, N]. Returns
    (w_last [B, H, N], fixed-point residual [B]) and, with ``return_steps``
    (the adaptive body only), the steps the loop ended on, [B, 6]: tau,
    sigma, alpha, the primal and dual residual of the last balancing and the
    signed sum of the iterations that moved the steps (as
    ``pdhg_log_utility_plain``'s). With ``allow_short`` the primal
    projection is onto the hyperplane sum(w) = 1 and no threshold is
    carried."""
    reject_unhonored_polish(params, "pdhg_mean_variance_plain")
    _check_return_steps(params, return_steps)
    B, H, N = mu.shape
    w_init = current_weights
    c = params.cost_coeff
    gamma = params.gamma
    rho = params.over_relax
    warm, warm_iters, cold_iters = _sweep_budgets(params, N)
    short = params.allow_short
    refresh = params.proj_refresh_every
    cond = warm and refresh > 1 and not params.adaptive

    fro = torch.sqrt((Sigma * Sigma).sum(dim=(-2, -1)))
    L = torch.clamp(2.0 * gamma * fro, min=1e-6)
    L = L[:, None, None] if Sigma.dim() == 3 else L
    sigma = params.sigma_scale * torch.sqrt(L + 1.0) / 2.0
    tau = params.step_scale / (0.5 * L + sigma * 4.0)

    def Dt(p):
        nxt = torch.cat([p[:, 1:], torch.zeros_like(p[:, :1])], dim=1)
        return p - nxt

    # The products of one horizon row, [B, N, N], reused row by row.
    prod = torch.empty((B, N, N), dtype=mu.dtype, device=mu.device)

    def grad_g(w):
        # (Sigma w_t)[i] = sum_j Sigma[i, j] w_t[j], as a multiply and a
        # sum over j (the kernel's order of operations, no matmul), one
        # horizon row at a time: the same sums as over [B, H, N, N] at once.
        quad = torch.stack([torch.mul(Sigma, w[:, t, None, :], out=prod)
                            .sum(dim=-1) for t in range(H)], dim=1)
        return 2.0 * gamma * quad - mu

    w, th_w = project_primal(w_init[:, None, :].expand(B, H, N), short,
                              cold_iters)
    p = torch.zeros_like(w)
    # The carried steps are per problem, also with a shared covariance.
    ones = torch.ones((B, 1, 1), dtype=mu.dtype, device=mu.device)
    tau, sigma, alpha = tau * ones, sigma * ones, 0.5 * ones
    k = params.adapt_every
    zero = torch.zeros_like(w_init)
    res = mu.new_zeros((B, 3))

    def iteration(i, w, p, th_w, tau, sigma, alpha, res, count):
        """One iteration; ``count`` carries i as a tensor (the signed sum
        of the iterations that moved the steps reads it)."""
        count = count + 1.0
        if not warm:
            n_sw = cold_iters
        elif cond:
            n_sw = warm_iters if i % refresh == 0 else 1
        else:
            n_sw = warm_iters
        v = w - tau * (grad_g(w) + Dt(p))
        w_new, th_w = project_primal(v, short, n_sw,
                                     th_w if warm else None)
        w_bar = 2.0 * w_new - w
        p_new = torch.clamp(p + sigma * (w_bar - _prev_rows(w_bar, w_init)),
                            -c, c)
        if params.adaptive and (k <= 1 or i % k == k - 1):
            # Residual balancing, from the moves before over-relaxation.
            dw, dp = w - w_new, p - p_new
            pr = torch.sqrt(((dw / tau - Dt(dp)) ** 2).sum(dim=(1, 2)))
            dr = torch.sqrt(((dp / sigma - (dw - _prev_rows(dw, zero))) ** 2)
                            .sum(dim=(1, 2)))
            tau, sigma, alpha = _balance_steps(
                pr[:, None, None], dr[:, None, None], tau, sigma, alpha)
            res = torch.stack([pr, dr, res[:, 2] + count * _moved(pr, dr)],
                              dim=1)
        if rho != 1.0:
            w_new = w + rho * (w_new - w)
            p_new = p + rho * (p_new - p)
        return w_new, p_new, th_w, tau, sigma, alpha, res, count

    period = refresh if cond else max(1, k) if params.adaptive else 1
    w, p, _, tau, sigma, alpha, res, _ = mpc_cuda._plain_iterate(
        iteration, (w, p, th_w, tau, sigma, alpha, res, mu.new_zeros(())),
        params.max_iters, period)
    v = w - tau * (grad_g(w) + Dt(p))
    w_last = project_primal(v, short, cold_iters)[0]
    fp = (w_last - w).abs().amax(dim=(1, 2))
    if not return_steps:
        return w_last, fp
    steps = torch.cat([x[:, :, 0] for x in (tau, sigma, alpha)] + [res], dim=1)
    return w_last, fp, steps


def _mv_route(H: int, N: int, params: MPCParams, shared: bool = False,
              B: int = 1) -> Tuple[str, CudaKernel]:
    """(layout, kernel) of a CUDA mean-variance solve of B problems: the
    layout ``mv_kernel_layout`` gives the shape (and ``allow_short``), the
    body the parameters select; raises ``ValueError`` only for H or N below
    1."""
    layout = mv_kernel_layout(H, N, shared, params.adaptive, B,
                              params.allow_short)
    if layout is None:
        raise ValueError(f"H={H}, N={N}: a problem needs H and N of at "
                         f"least 1")
    return layout, _MV_KERNELS[(layout, params.adaptive)]


def pdhg_mean_variance_cuda(
    current_weights: torch.Tensor,
    mu: torch.Tensor,
    Sigma: torch.Tensor,
    params: MPCParams,
    return_steps: bool = False,
):
    """One launch of a CUDA kernel on the current stream: the contract of
    ``pdhg_mean_variance_plain``, for CUDA float32 tensors.
    ``pdhg_mean_variance_lanes`` (``..._lanes_adaptive`` with
    ``params.adaptive``), ``..._tile``, ``..._block`` or ``..._global``
    (``..._tile_adaptive``, ``..._block_adaptive``, ``..._global_adaptive``)
    as ``mv_kernel_layout`` routes the batch; a global workspace past the
    card's free memory raises ``ValueError``. The warp layout's kernels (``pdhg_mean_variance``,
    ``..._adaptive``) take the lane layout's shapes and are launched only by
    ``_mv_launch``, to be compared with it."""
    reject_unhonored_polish(params, "pdhg_mean_variance_cuda")
    _check_return_steps(params, return_steps)
    if mu.dim() != 3 or current_weights.shape != (mu.shape[0], mu.shape[2]):
        raise ValueError(
            f"expected current_weights [B, N] and mu [B, H, N], got "
            f"{tuple(current_weights.shape)} and {tuple(mu.shape)}"
        )
    B, H, N = mu.shape
    shared = Sigma.dim() == 2
    if Sigma.shape != ((N, N) if shared else (B, N, N)):
        raise ValueError(
            f"expected Sigma [N, N] or [B, N, N] with B={B}, N={N}, got "
            f"{tuple(Sigma.shape)}")
    _require_cuda_f32(current_weights=current_weights, mu=mu, Sigma=Sigma)
    layout, kernel = _mv_route(H, N, params, shared, B)
    ctas = None
    if layout == "cluster":
        ctas = mv_cluster_launch_ctas(kernel, H, N, params.adaptive,
                                      mu.device, B)
        if not ctas:
            kernel = _MV_KERNELS[("global", params.adaptive)]
    return _mv_launch(kernel, current_weights, mu, Sigma, params,
                      return_steps, cluster_ctas=ctas)


def _mv_launch(kernel: CudaKernel, current_weights, mu, Sigma, params,
               return_steps=False, problems=None, sweep=None,
               cluster_ctas=None):
    """Launch ``kernel`` (any of ``MV_KERNELS`` whose body matches
    ``params.adaptive``) on checked CUDA tensors and count the launch; a
    tile kernel takes the problems a CTA its library chooses for the batch
    (``mv_tile_problems``), or ``problems`` where given (a plan's edge, for
    a check); a lane kernel the sweep ``mv_lanes_sweep`` gives the batch,
    or ``sweep`` (one of ``mv_lanes_sweeps(N)``) where given; a global
    kernel its persistent grid (``mpc_cuda.global_grid``) over a workspace
    of ``mv_global_workspace_bytes``; a cluster kernel B clusters of
    ``cluster_ctas`` CTAs (default ``mv_cluster_ctas``), where its plan
    takes that size (else ``ValueError``) and the card runs it (else
    ``RuntimeError``). ``allow_short`` needs a kernel of the block or global
    layout."""
    B, H, N = mu.shape
    shared = int(Sigma.dim() == 2)
    short = params.allow_short
    if short and kernel not in _MV_SHORT_ARG:
        raise ValueError(f"{kernel.name} projects on the simplex only: "
                         "allow_short runs in the block and global layouts")
    tile = kernel in (PDHG_MEAN_VARIANCE_TILE,
                      PDHG_MEAN_VARIANCE_TILE_ADAPTIVE)
    lanes = kernel in (PDHG_MEAN_VARIANCE_LANES,
                       PDHG_MEAN_VARIANCE_LANES_ADAPTIVE)
    extra = ()
    if tile:
        extra = (problems or 0,)
    elif lanes:
        sweep = sweep or mv_lanes_sweep(B, N)
        if sweep not in mv_lanes_sweeps(N):
            raise ValueError(f"sweep {sweep!r} not in {mv_lanes_sweeps(N)} "
                             f"at N={N}")
        extra = (int(sweep == "inlane"),)
    w = torch.empty_like(mu)
    fp = torch.empty(B, dtype=torch.float32, device=mu.device)
    steps = torch.empty((B, 6), dtype=torch.float32, device=mu.device) \
        if return_steps else None
    out = (w, fp, steps) if return_steps else (w, fp)
    if B == 0:
        return out
    warm, warm_iters, cold_iters = _sweep_budgets(params, N)
    schedule = (params.adapt_every if params.adaptive
                else params.proj_refresh_every)
    if kernel in _MV_GLOBAL:
        grid = mpc_cuda.global_grid(kernel, B, (H, N), short, mu.device)
        ws = mpc_cuda.global_workspace(mv_global_workspace_bytes(H, N, grid),
                                       mu.device, kernel.name)
        tail = (int(short), ws.data_ptr(), grid)
    elif kernel in _MV_CLUSTER:
        C = cluster_ctas or mv_cluster_ctas(H, N, params.adaptive, B)
        if mv_cluster_plan(H, N, C, params.adaptive) is None:
            raise ValueError(f"{kernel.name}: no plan of {C} CTAs a cluster "
                             f"holds H={H}, N={N}")
        if mv_cluster_clusters(kernel, H, N, C, mu.device) < 1:
            raise RuntimeError(f"{kernel.name}: the card runs no cluster of "
                               f"{C} CTAs at H={H}, N={N}")
        tail = (C,)
    else:
        tail = (int(short),) if kernel in _MV_SHORT_ARG else ()
    kernel.launch(
        mu.device,
        current_weights.data_ptr(), mu.data_ptr(), Sigma.data_ptr(),
        w.data_ptr(), fp.data_ptr(),
        *((None if steps is None else steps.data_ptr(),)
          if params.adaptive else ()),
        B, H, N, shared, *extra,
        params.max_iters, schedule, warm_iters,
        cold_iters, params.cost_coeff, params.gamma, params.over_relax,
        params.step_scale, params.sigma_scale, int(warm), *tail,
    )
    if short:
        mpc_cuda.SHORT_LAUNCHES[kernel.name] = \
            mpc_cuda.SHORT_LAUNCHES.get(kernel.name, 0) + 1
    return out


def pdhg_mean_variance(current_weights, mu, Sigma, params):
    """The kernel for CUDA tensors, its plain version for CPU tensors."""
    fn = pdhg_mean_variance_cuda if mu.is_cuda else pdhg_mean_variance_plain
    return fn(current_weights, mu, Sigma, params)


def _finalize_mv(w_last, fp_res, mu, Sigma, w_init, params: MPCParams):
    """Hold-current-weights for non-finite solves and the info dict, as the
    eager solver's tail."""
    converged = torch.isfinite(fp_res)
    hold = w_init[:, None, :].expand_as(w_last)
    w_out = torch.where(converged[:, None, None], w_last, hold)
    info = {
        "converged": converged,
        "fixed_point_residual": fp_res,
        "status_code": _status_code(fp_res, params.feas_tol),
        "objective": mean_variance_objective(w_out, mu, Sigma, w_init, params),
    }
    return w_out, info


def solve_mpc_mean_variance_packed(
    current_weights: torch.Tensor,
    predicted_log_returns: torch.Tensor,
    cov_matrix: torch.Tensor,
    params: MPCParams,
    device="cuda",
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Batched mean-variance solve: [B, N] x [B, H, N] x [B or none, N, N]
    -> (w [B, H, N], info) with ``converged``, ``fixed_point_residual``,
    ``status_code`` and ``objective`` per problem. A CUDA ``device``
    launches the kernel, ``"cpu"`` runs the plain version. An unbatched (or
    size-1-batched) covariance is not expanded to the batch."""
    reject_unhonored_polish(params, "solve_mpc_mean_variance_packed")
    dev = torch.device(device)
    mu = predicted_log_returns.to(device=dev, dtype=torch.float32).contiguous()
    w_init = current_weights.to(device=dev, dtype=torch.float32).contiguous()
    cov = cov_matrix.to(device=dev, dtype=torch.float32)
    Sigma = 0.5 * (cov + cov.transpose(-1, -2))
    N = mu.shape[-1]
    Sigma = (Sigma.reshape(N, N) if _is_shared(cov)
             else Sigma.expand(mu.shape[0], N, N)).contiguous()
    w_last, fp = pdhg_mean_variance(w_init, mu, Sigma, params)
    return _finalize_mv(w_last, fp, mu, Sigma, w_init, params)
