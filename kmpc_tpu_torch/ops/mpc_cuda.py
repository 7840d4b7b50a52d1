"""Fused log-utility MPC solve: the hand-written CUDA kernel, its plain
PyTorch version, and the wrapper around them.

Port of kmpc_tpu/ops/mpc_pallas.py ``solve_mpc_log_utility_pallas_packed``
(the TPU kernel ``_make_packed_kernel`` with S=None). One launch of
``csrc/pdhg_log_utility.cu`` runs the whole Condat-Vu iteration for every
problem of the batch: the primal step with tau folded into the portfolio
reciprocal, the simplex projection with carried Michelot thresholds, the
clip-form dual prox against the l1 turnover ball on the sigma scale,
over-relaxation, and a final primal half-step that yields the returned
iterate and the fixed-point residual. Two loop bodies are ported:
``make_body`` (full warm budget, or cold thresholds when
``proj_warm_iters=0``) and ``make_body_cond`` (``proj_refresh_every > 1``:
one warm sweep per iteration, the full budget every k-th).

A CUDA tensor launches the kernel or raises; a CPU tensor runs
``pdhg_log_utility_plain``, the same iteration as plain tensor code. Not in
this package yet: ``allow_short``, the adaptive body, the pipelined
reductions, warm-start inputs and the dual output.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from kmpc_tpu_torch._build import CudaKernel
from kmpc_tpu_torch.ops.mpc import (
    MPCParams,
    _log_utility_objective,
    _pdhg_steps,
    _prev_rows,
    _status_code,
    reject_unhonored_polish,
    restore_turnover_feasibility,
)
from kmpc_tpu_torch.ops.projections import (
    ball_l1_and_sweep,
    michelot_iters_for,
    michelot_threshold,
)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

PDHG_LOG_UTILITY = CudaKernel(
    "pdhg_log_utility", "kmpc_pdhg_log_utility",
    [_P, _P, _P, _P] + [_I] * 7 + [_F] * 6 + [_I] * 3 + [_P],
)

# Register budget of the kernel: one warp per problem keeps
# pow2ceil(H) * ceil(N/32) elements of each iterate per lane.
MAX_SLOTS = 4          # ceil(N / 32): N <= 128
MAX_ROW_ELEMENTS = 16  # pow2ceil(H) * ceil(N / 32)


def kernel_supports(H: int, N: int) -> bool:
    """Whether the CUDA kernel is compiled for horizon H and N assets."""
    k = -(-N // 32)
    hm = 1 << max(H - 1, 0).bit_length()
    return H >= 1 and 1 <= k <= MAX_SLOTS and hm * k <= MAX_ROW_ELEMENTS


def _check_params(params: MPCParams, entry: str) -> None:
    reject_unhonored_polish(params, entry)
    if params.allow_short:
        raise NotImplementedError(
            f"{entry}: allow_short needs the hyperplane projection of the "
            "eager solver, which kmpc_tpu_torch does not have yet"
        )
    if params.adaptive:
        raise NotImplementedError(f"{entry}: the adaptive body is not ported yet")
    if params.pipeline_reduces and params.proj_warm_iters >= 1 \
            and params.proj_refresh_every > 1:
        raise NotImplementedError(
            f"{entry}: the pipelined-reductions body is not ported yet"
        )


def _sweep_budgets(params: MPCParams, N: int) -> Tuple[bool, int, int]:
    """(warm, warm_iters, cold_iters): sweeps per projection from a carried
    threshold, and the cold budget (8 / 12 / 16 by N)."""
    cold_iters = michelot_iters_for(N)
    warm = params.proj_warm_iters >= 1
    return warm, params.proj_warm_iters if warm else cold_iters, cold_iters


def pdhg_log_utility_plain(
    current_weights: torch.Tensor, r: torch.Tensor, params: MPCParams
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's computation in plain tensor code.

    current_weights [B, N] and gross returns r [B, H, N], float32. Returns
    (w_last [B, H, N], fixed-point residual [B]).
    """
    _check_params(params, "pdhg_log_utility_plain")
    B, H, N = r.shape
    w_init = current_weights
    c = params.cost_coeff
    tau_to = params.max_turnover
    use_ball = tau_to > 0
    ridge = params.ridge
    rho = params.over_relax
    warm, warm_iters, cold_iters = _sweep_budgets(params, N)
    refresh = params.proj_refresh_every
    cond = warm and refresh > 1

    r_norm2 = (r * r).sum(dim=-1)
    r_min = r.amin(dim=-1)
    Lt = r_norm2 / torch.clamp(r_min, min=1e-12) ** 2 + ridge   # [B, H]
    tau, sigma = _pdhg_steps(Lt, params)       # [B, 1 or H, 1]
    sig_tau = sigma * tau_to
    c1 = 1.0 - tau * ridge

    def D(x):
        return x - _prev_rows(x, w_init)

    def Dt(p):
        nxt = torch.cat([p[:, 1:], torch.zeros_like(p[:, :1])], dim=1)
        return p - nxt

    def primal_pre(w, p):
        port = (w * r).sum(dim=-1, keepdim=True)
        g = r * (tau / torch.clamp(port, min=1e-12))
        base = w if ridge == 0.0 else c1 * w
        return base + (g - tau * Dt(p))

    v0 = w_init[:, None, :].expand(B, H, N)
    th_w = michelot_threshold(v0, 1.0, cold_iters)
    w = torch.clamp(v0 - th_w, min=0.0)
    p = torch.zeros_like(w)
    th_p = torch.zeros_like(th_w)

    for i in range(params.max_iters):
        if not warm:
            n_sw = cold_iters
        elif cond:
            n_sw = warm_iters if i % refresh == 0 else 1
        else:
            n_sw = warm_iters
        v = primal_pre(w, p)
        th_w = michelot_threshold(v, 1.0, n_sw, th_w if warm else None)
        w_new = torch.clamp(v - th_w, min=0.0)
        q = p + sigma * D(2.0 * w_new - w)
        aq = torch.clamp(q.abs() - c, min=0.0)
        if use_ball:
            if warm:
                l1, th_p = ball_l1_and_sweep(aq, sig_tau, th_p)
                th_p = michelot_threshold(aq, sig_tau, n_sw - 1, th_p)
            else:
                l1 = aq.sum(dim=-1, keepdim=True)
                th_p = michelot_threshold(aq, sig_tau, n_sw)
            bound = c + torch.where(l1 <= sig_tau, torch.zeros_like(th_p),
                                    torch.clamp(th_p, min=0.0))
            p_new = torch.minimum(torch.maximum(q, -bound), bound)
        else:
            p_new = torch.clamp(q, -c, c)
        if rho != 1.0:
            w_new = w + rho * (w_new - w)
            p_new = p + rho * (p_new - p)
        w, p = w_new, p_new

    port = (w * r).sum(dim=-1, keepdim=True)
    grad = r * (-1.0 / torch.clamp(port, min=1e-12))
    if ridge != 0.0:
        grad = grad + ridge * w
    v = w - tau * (grad + Dt(p))
    w_last = torch.clamp(v - michelot_threshold(v, 1.0, cold_iters), min=0.0)
    fp = (w_last - w).abs().amax(dim=(1, 2))
    return w_last, fp


def pdhg_log_utility_cuda(
    current_weights: torch.Tensor, r: torch.Tensor, params: MPCParams
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch of the CUDA kernel on the current stream: the same
    contract as ``pdhg_log_utility_plain``, for CUDA float32 tensors."""
    _check_params(params, "pdhg_log_utility_cuda")
    if r.dim() != 3 or current_weights.shape != (r.shape[0], r.shape[2]):
        raise ValueError(
            f"expected current_weights [B, N] and r [B, H, N], got "
            f"{tuple(current_weights.shape)} and {tuple(r.shape)}"
        )
    for name, t in (("current_weights", current_weights), ("r", r)):
        if not t.is_cuda or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(
                f"{name} must be a contiguous float32 CUDA tensor, got "
                f"{t.dtype} on {t.device} (contiguous={t.is_contiguous()})"
            )
    if current_weights.device != r.device:
        raise ValueError("current_weights and r lie on different devices")
    B, H, N = r.shape
    if not kernel_supports(H, N):
        raise ValueError(
            f"H={H}, N={N} exceeds the kernel's register budget: it needs "
            f"ceil(N/32) <= {MAX_SLOTS} and pow2ceil(H) * ceil(N/32) <= "
            f"{MAX_ROW_ELEMENTS}"
        )
    w = torch.empty_like(r)
    fp = torch.empty(B, dtype=torch.float32, device=r.device)
    if B == 0:
        return w, fp
    warm, warm_iters, cold_iters = _sweep_budgets(params, N)
    fn = PDHG_LOG_UTILITY.function()
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        err = fn(
            current_weights.data_ptr(), r.data_ptr(), w.data_ptr(),
            fp.data_ptr(), B, H, N, params.max_iters,
            params.proj_refresh_every, warm_iters, cold_iters,
            params.cost_coeff, params.max_turnover, params.ridge,
            params.over_relax, params.step_scale, params.sigma_scale,
            int(params.precond), int(params.max_turnover > 0), int(warm),
            stream,
        )
    if err != 0:
        raise RuntimeError(f"pdhg_log_utility kernel launch failed: CUDA error {err}")
    PDHG_LOG_UTILITY.launches += 1
    return w, fp


def pdhg_log_utility(
    current_weights: torch.Tensor, r: torch.Tensor, params: MPCParams
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel for CUDA tensors, its plain version for CPU tensors."""
    if r.is_cuda:
        return pdhg_log_utility_cuda(current_weights, r, params)
    return pdhg_log_utility_plain(current_weights, r, params)


def _finalize_packed(w, r, w_init, params: MPCParams, fp_res):
    """Turnover restoration, hold-current-weights for non-finite solves (a
    rule of the program) and the info dict, as kmpc_tpu's
    ``_finalize_packed``. ``turnover_violation`` is measured before the
    restoration."""
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
    info = {
        "objective": _log_utility_objective(w, r, w_init, params.cost_coeff),
        "converged": converged,
        "turnover_violation": to_viol,
        "fixed_point_residual": fp_res,
        "status_code": _status_code(fp_res, params.feas_tol),
    }
    return w, info


def solve_mpc_log_utility_packed(
    current_weights: torch.Tensor,
    predicted_log_returns: torch.Tensor,
    params: MPCParams,
    device="cuda",
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Batched solve: [B, N] x [B, H, N] -> (w [B, H, N], info).

    ``device`` is where the solve runs: a CUDA device launches the kernel,
    ``"cpu"`` runs the plain version. info
    holds ``objective``, ``converged``, ``turnover_violation``,
    ``fixed_point_residual`` and ``status_code``, per problem.
    """
    dev = torch.device(device)
    y = predicted_log_returns.to(device=dev, dtype=torch.float32)
    w_init = current_weights.to(device=dev, dtype=torch.float32).contiguous()
    r = torch.exp(y).contiguous()
    w, fp = pdhg_log_utility(w_init, r, params)
    return _finalize_packed(w, r, w_init, params, fp)
