"""Fused mean-variance MPC solve (the Markowitz baseline's program): the
hand-written CUDA kernel, its plain PyTorch version, and the wrapper.

Port of kmpc_tpu/ops/mpc_pallas.py ``solve_mpc_mean_variance_pallas_packed``
(the TPU kernel ``_make_packed_mv_kernel``):

    min_w  sum_t [gamma w_t' Sigma w_t - w_t.mu_t] + c sum_t ||u_t||_1
    s.t.   w_t on the simplex.

One launch of ``csrc/pdhg_mean_variance.cu`` runs the whole Condat-Vu
iteration: the quadratic gradient Sigma w_t in plain float32, the simplex
projection with a carried Michelot threshold (full warm budget, the
refresh schedule of ``proj_refresh_every``, or cold projections), the dual
prox as a clip to [-c, c] (the program has no turnover ball), and
over-relaxation; a final primal half-step gives the returned iterate and
the fixed-point residual. With ``adaptive`` the steps are carried per
problem and balanced by the primal and dual residuals on every
``adapt_every``-th iteration, the refresh schedule is off, and the launch
goes to ``csrc/pdhg_mean_variance_adaptive.cu``. The covariance is per problem ([B, N, N]) or one
matrix shared by the batch ([N, N] or [1, N, N]); it is symmetrised first.

A CUDA tensor launches the kernel or raises; a CPU tensor runs
``pdhg_mean_variance_plain``. ``allow_short`` raises here: a caller who
wants shorts calls ``solve_mpc_mean_variance_batch`` by name.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

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
from kmpc_tpu_torch.ops.mpc_cuda import (
    MAX_ROW_ELEMENTS,
    MAX_SLOTS,
    SMEM_PER_BLOCK,
    _check_return_steps,
    _moved,
    _require_cuda_f32,
    _sweep_budgets,
    kernel_supports,
)
from kmpc_tpu_torch.ops.projections import michelot_threshold

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

# (cw, mu, sigma, w_out, fp_out), B, H, N, shared, max_iters, the schedule
# (``proj_refresh_every``; ``adapt_every`` for the adaptive kernel), the
# sweep budgets, the scalars, warm, the stream.
# The adaptive kernel takes one more pointer after fp_out: steps_out.
_ARGTYPES = [_I] * 8 + [_F] * 5 + [_I, _P]
PDHG_MEAN_VARIANCE = CudaKernel(
    "pdhg_mean_variance", "kmpc_pdhg_mean_variance", [_P] * 5 + _ARGTYPES)
PDHG_MEAN_VARIANCE_ADAPTIVE = CudaKernel(
    "pdhg_mean_variance_adaptive", "kmpc_pdhg_mean_variance_adaptive",
    [_P] * 6 + _ARGTYPES)


def mv_smem_bytes(N: int) -> int:
    """Shared memory of one covariance in the kernel: N columns of
    ceil32(N) floats (per warp with a per-problem covariance, per block
    with a shared one)."""
    return N * 32 * (-(-N // 32)) * 4


def mv_kernel_supports(H: int, N: int) -> bool:
    """Whether the mean-variance kernel takes horizon H and N assets: the
    register budget of the log-utility kernels, and one covariance within
    a block's shared memory."""
    return kernel_supports(H, N) and mv_smem_bytes(N) <= SMEM_PER_BLOCK


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
    for i in range(params.max_iters):
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
            res = torch.stack([pr, dr, res[:, 2] + (i + 1) * _moved(pr, dr)],
                              dim=1)
        if rho != 1.0:
            w_new = w + rho * (w_new - w)
            p_new = p + rho * (p_new - p)
        w, p = w_new, p_new
    v = w - tau * (grad_g(w) + Dt(p))
    w_last = torch.clamp(v - michelot_threshold(v, 1.0, cold_iters), min=0.0)
    fp = (w_last - w).abs().amax(dim=(1, 2))
    if not return_steps:
        return w_last, fp
    steps = torch.cat([x[:, :, 0] for x in (tau, sigma, alpha)] + [res], dim=1)
    return w_last, fp, steps


def pdhg_mean_variance_cuda(
    current_weights: torch.Tensor,
    mu: torch.Tensor,
    Sigma: torch.Tensor,
    params: MPCParams,
    return_steps: bool = False,
):
    """One launch of the CUDA kernel on the current stream
    (``pdhg_mean_variance``, or ``pdhg_mean_variance_adaptive`` with
    ``params.adaptive``): the contract of ``pdhg_mean_variance_plain``, for
    CUDA float32 tensors."""
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
    if not kernel_supports(H, N):
        raise ValueError(
            f"H={H}, N={N} exceeds the kernel's register budget: it needs "
            f"ceil(N/32) <= {MAX_SLOTS} and pow2ceil(H) * ceil(N/32) <= "
            f"{MAX_ROW_ELEMENTS}"
        )
    if not mv_kernel_supports(H, N):
        raise ValueError(
            f"N={N} exceeds the kernel's shared-memory budget: one "
            f"covariance takes {mv_smem_bytes(N)} bytes of a block's "
            f"{SMEM_PER_BLOCK}")
    w = torch.empty_like(mu)
    fp = torch.empty(B, dtype=torch.float32, device=mu.device)
    steps = torch.empty((B, 6), dtype=torch.float32, device=mu.device) \
        if return_steps else None
    out = (w, fp, steps) if return_steps else (w, fp)
    if B == 0:
        return out
    warm, warm_iters, cold_iters = _sweep_budgets(params, N)
    if params.adaptive:
        kernel, schedule = PDHG_MEAN_VARIANCE_ADAPTIVE, params.adapt_every
    else:
        kernel, schedule = PDHG_MEAN_VARIANCE, params.proj_refresh_every
    fn = kernel.function()
    with torch.cuda.device(mu.device):
        stream = torch.cuda.current_stream(mu.device).cuda_stream
        err = fn(
            current_weights.data_ptr(), mu.data_ptr(), Sigma.data_ptr(),
            w.data_ptr(), fp.data_ptr(),
            *((None if steps is None else steps.data_ptr(),)
              if params.adaptive else ()),
            B, H, N, int(shared),
            params.max_iters, schedule, warm_iters,
            cold_iters, params.cost_coeff, params.gamma, params.over_relax,
            params.step_scale, params.sigma_scale, int(warm), stream,
        )
    if err != 0:
        raise RuntimeError(
            f"{kernel.name} kernel launch failed: CUDA error {err}")
    kernel.launches += 1
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
