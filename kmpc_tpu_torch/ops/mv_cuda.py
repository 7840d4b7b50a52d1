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
the tile layout where its plan fits; else ``ValueError`` naming
``solve_mpc_mean_variance_batch``. Together they take every shape
kmpc_tpu's wrapper sends to its Pallas kernel (a working set within 8 MiB
at the 128-lane tile). The warp layout before the lane layout
(``csrc/pdhg_mean_variance.cu``, ``..._adaptive.cu``: one warp per problem,
Sigma in shared memory, w broadcast by shuffles, the sweeps by butterflies)
takes the same shapes and is launched only by ``_mv_launch``, to be
compared with it.

A CUDA tensor launches a kernel or raises; a CPU tensor runs
``pdhg_mean_variance_plain``. ``allow_short`` raises here: a caller who
wants shorts calls ``solve_mpc_mean_variance_batch`` by name.
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
)
from kmpc_tpu_torch.ops.projections import michelot_threshold

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
# The block-per-problem layout, with the same C interfaces.
PDHG_MEAN_VARIANCE_BLOCK = CudaKernel(
    "pdhg_mean_variance_block", "kmpc_pdhg_mean_variance_block",
    [_P] * 5 + _ARGTYPES)
PDHG_MEAN_VARIANCE_BLOCK_ADAPTIVE = CudaKernel(
    "pdhg_mean_variance_block_adaptive",
    "kmpc_pdhg_mean_variance_block_adaptive", [_P] * 6 + _ARGTYPES)
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
}
MV_KERNELS = tuple(_MV_KERNELS.values())


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


def mv_tile_streams(H: int, N: int, adaptive: bool) -> bool:
    """Whether the tile layout streams Sigma at this shape: the plan of one
    problem a CTA does not hold it resident (or does not fit)."""
    plan = mv_tile_plan(1, H, N, adaptive)
    return plan is None or plan[1] > 0


def mv_kernel_layout(H: int, N: int, shared: bool = False,
                     adaptive: bool = False, B: int = 1) -> Optional[str]:
    """The layout a CUDA mean-variance solve of B problems of this shape
    runs in, as measured fastest (``chip_smoke.py``'s ``mv_layouts``):
    ``"lanes"`` at one horizon row where its plan takes N (at most 128
    assets: ``mv_lanes_plan``; the warp layout, which takes the same
    shapes, measured slower); else ``"tile"`` where its plan takes the batch
    (``mv_tile_problems``) and holds Sigma resident, or streams it at
    H >= TILE_STREAM_H or with a shared Sigma for more than TILE_SMS
    problems; else ``"block"`` where one problem's iterates fit a block's
    shared memory; else ``"tile"`` where its plan takes the batch; else
    None."""
    if H == 1 and mv_lanes_plan(N, shared) is not None:
        return "lanes"
    tile = mv_tile_problems(max(B, 1), H, N, shared, adaptive) > 0
    if tile and (not mv_tile_streams(H, N, adaptive) or H >= TILE_STREAM_H
                 or (shared and B > TILE_SMS)):
        return "tile"
    if H >= 1 and N >= 1 and mv_block_smem_bytes(H, N) <= SMEM_PER_BLOCK:
        return "block"
    return "tile" if tile else None


def _check_params(params: MPCParams, entry: str) -> None:
    reject_unhonored_polish(params, entry)
    if params.allow_short:
        raise NotImplementedError(
            f"{entry}: the kernel projects on the simplex only; "
            "allow_short is solved by the eager solver "
            "(solve_mpc_mean_variance_batch)"
        )


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
    ``pdhg_log_utility_plain``'s)."""
    _check_params(params, "pdhg_mean_variance_plain")
    _check_return_steps(params, return_steps)
    B, H, N = mu.shape
    w_init = current_weights
    c = params.cost_coeff
    gamma = params.gamma
    rho = params.over_relax
    warm, warm_iters, cold_iters = _sweep_budgets(params, N)
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

    def grad_g(w):
        # (Sigma w_t)[i] = sum_j Sigma[i, j] w_t[j], as a multiply and a
        # sum over j (the kernel's order of operations, no matmul).
        quad = (Sigma[..., None, :, :] * w[:, :, None, :]).sum(dim=-1)
        return 2.0 * gamma * quad - mu

    v0 = w_init[:, None, :].expand(B, H, N)
    th_w = michelot_threshold(v0, 1.0, cold_iters)
    w = torch.clamp(v0 - th_w, min=0.0)
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
        th_w = michelot_threshold(v, 1.0, n_sw, th_w if warm else None)
        w_new = torch.clamp(v - th_w, min=0.0)
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
    w_last = torch.clamp(v - michelot_threshold(v, 1.0, cold_iters), min=0.0)
    fp = (w_last - w).abs().amax(dim=(1, 2))
    if not return_steps:
        return w_last, fp
    steps = torch.cat([x[:, :, 0] for x in (tau, sigma, alpha)] + [res], dim=1)
    return w_last, fp, steps


def _mv_route(H: int, N: int, params: MPCParams, shared: bool = False,
              B: int = 1) -> Tuple[str, CudaKernel]:
    """(layout, kernel) of a CUDA mean-variance solve of B problems: the
    layout ``mv_kernel_layout`` gives the shape, the body the parameters
    select; raises ``ValueError`` for a shape beyond every layout's budget,
    naming the eager solver."""
    layout = mv_kernel_layout(H, N, shared, params.adaptive, B)
    if layout is None:
        raise ValueError(
            f"H={H}, N={N} exceeds the mean-variance kernels' budgets: the "
            f"lane layout needs H = 1 and ceil(N/32) <= {MAX_SLOTS} (its "
            f"Sigma within {SMEM_PER_BLOCK} bytes of shared memory past 32 "
            f"assets), the tile layout H <= "
            f"{TILE_MAX_WARPS} and its plan within {SMEM_PER_BLOCK} bytes "
            "of shared memory, the block layout one problem's iterates "
            f"within them, here {mv_block_smem_bytes(H, N)}; the eager "
            "solver solve_mpc_mean_variance_batch takes any shape")
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
    ``params.adaptive``), ``..._tile`` or ``..._block`` (``..._tile_adaptive``,
    ``..._block_adaptive``) as ``mv_kernel_layout`` routes the batch, else
    ``ValueError``. The warp layout's kernels (``pdhg_mean_variance``,
    ``..._adaptive``) take the lane layout's shapes and are launched only by
    ``_mv_launch``, to be compared with it."""
    _check_params(params, "pdhg_mean_variance_cuda")
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
    _, kernel = _mv_route(H, N, params, shared, B)
    return _mv_launch(kernel, current_weights, mu, Sigma, params,
                      return_steps)


def _mv_launch(kernel: CudaKernel, current_weights, mu, Sigma, params,
               return_steps=False, problems=None, sweep=None):
    """Launch ``kernel`` (any of ``MV_KERNELS`` whose body matches
    ``params.adaptive``) on checked CUDA tensors and count the launch; a
    tile kernel takes the problems a CTA its library chooses for the batch
    (``mv_tile_problems``), or ``problems`` where given (a plan's edge, for
    a check); a lane kernel the sweep ``mv_lanes_sweep`` gives the batch,
    or ``sweep`` (one of ``mv_lanes_sweeps(N)``) where given."""
    B, H, N = mu.shape
    shared = int(Sigma.dim() == 2)
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
    kernel.launch(
        mu.device,
        current_weights.data_ptr(), mu.data_ptr(), Sigma.data_ptr(),
        w.data_ptr(), fp.data_ptr(),
        *((None if steps is None else steps.data_ptr(),)
          if params.adaptive else ()),
        B, H, N, shared, *extra,
        params.max_iters, schedule, warm_iters,
        cold_iters, params.cost_coeff, params.gamma, params.over_relax,
        params.step_scale, params.sigma_scale, int(warm),
    )
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
    _check_params(params, "solve_mpc_mean_variance_packed")
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
