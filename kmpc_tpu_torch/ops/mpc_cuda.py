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
iterate and the fixed-point residual. Two loop bodies are ported:
``make_body`` (full warm budget, or cold thresholds when
``proj_warm_iters=0``) and ``make_body_cond`` (``proj_refresh_every > 1``:
one warm sweep per iteration, the full budget every k-th). Both kernels
take warm primal/dual iterates (the simplex threshold then starts cold on
the warm primal, the ball threshold from zero) and can write the loop's
last dual.

A CUDA tensor launches the kernel or raises; a CPU tensor runs
``pdhg_log_utility_plain``, the same iteration as plain tensor code.
``allow_short`` raises here (the kernels project on the simplex only): a
caller who wants shorts calls the eager solvers by name. Not in this
package yet: the adaptive body and the pipelined reductions.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

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
from kmpc_tpu_torch.ops.scenario import scenario_objective, scenario_steps

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

# (cw, r, w_warm, p_warm, w_out, fp_out, p_out), the sizes and budgets, the
# scalars, the flags, the stream; the scenario kernel takes S after B.
_TAIL = [_I] * 6 + [_F] * 6 + [_I] * 3 + [_P]
PDHG_LOG_UTILITY = CudaKernel(
    "pdhg_log_utility", "kmpc_pdhg_log_utility", [_P] * 7 + [_I] + _TAIL,
)
PDHG_LOG_UTILITY_SCENARIOS = CudaKernel(
    "pdhg_log_utility_scenarios", "kmpc_pdhg_log_utility_scenarios",
    [_P] * 7 + [_I, _I] + _TAIL,
)


# Register budget of the kernels: one warp per problem keeps
# pow2ceil(H) * ceil(N/32) elements of each iterate per lane.
MAX_SLOTS = 4          # ceil(N / 32): N <= 128
MAX_ROW_ELEMENTS = 16  # pow2ceil(H) * ceil(N / 32)

# Shared memory one block can use on Hopper (above 48 KB by opt-in, which
# the launchers do). The scenario kernel stages each problem's returns in
# its warp's slice: S * H * ceil32(N) floats.
SMEM_PER_BLOCK = 232448


def kernel_supports(H: int, N: int) -> bool:
    """Whether the CUDA kernels are compiled for horizon H and N assets."""
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


def _check_params(params: MPCParams, entry: str) -> None:
    reject_unhonored_polish(params, entry)
    if params.allow_short:
        raise NotImplementedError(
            f"{entry}: the kernel projects on the simplex only; "
            "allow_short is solved by the eager solvers "
            "(solve_mpc_log_utility_batch, solve_mpc_log_utility_scenarios)"
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
    current_weights: torch.Tensor,
    r: torch.Tensor,
    params: MPCParams,
    w_warm: Optional[torch.Tensor] = None,
    p_warm: Optional[torch.Tensor] = None,
    return_dual: bool = False,
):
    """The kernels' computation in plain tensor code.

    current_weights [B, N] and gross returns r [B, H, N], or [B, S, H, N]
    for the scenario program; optional warm iterates [B, H, N] (``p_warm``
    alone is ignored). Returns (w_last [B, H, N], fixed-point residual
    [B]) and, with ``return_dual``, the loop's last dual [B, H, N].
    """
    _check_params(params, "pdhg_log_utility_plain")
    scen = r.dim() == 4
    B, H, N = r.shape[0], r.shape[-2], r.shape[-1]
    w_init = current_weights
    c = params.cost_coeff
    tau_to = params.max_turnover
    use_ball = tau_to > 0
    ridge = params.ridge
    rho = params.over_relax
    warm, warm_iters, cold_iters = _sweep_budgets(params, N)
    refresh = params.proj_refresh_every
    cond = warm and refresh > 1

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
        v0 = w_init[:, None, :].expand(B, H, N)
        th_w = michelot_threshold(v0, 1.0, cold_iters)
        w = torch.clamp(v0 - th_w, min=0.0)
        p = torch.zeros_like(w)
    else:
        # A cold threshold on the warm primal; the iterate itself is kept.
        w = w_warm
        p = torch.zeros_like(w) if p_warm is None else p_warm
        th_w = michelot_threshold(w, 1.0, cold_iters)
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

    grad = scaled_returns(w, -1.0)
    if ridge != 0.0:
        grad = grad + ridge * w
    v = w - tau * (grad + Dt(p))
    w_last = torch.clamp(v - michelot_threshold(v, 1.0, cold_iters), min=0.0)
    fp = (w_last - w).abs().amax(dim=(1, 2))
    return (w_last, fp, p) if return_dual else (w_last, fp)


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


def pdhg_log_utility_cuda(
    current_weights: torch.Tensor,
    r: torch.Tensor,
    params: MPCParams,
    w_warm: Optional[torch.Tensor] = None,
    p_warm: Optional[torch.Tensor] = None,
    return_dual: bool = False,
):
    """One launch of a CUDA kernel on the current stream: the same
    contract as ``pdhg_log_utility_plain``, for CUDA float32 tensors.
    r [B, H, N] launches ``pdhg_log_utility``, r [B, S, H, N]
    ``pdhg_log_utility_scenarios``."""
    _check_params(params, "pdhg_log_utility_cuda")
    scen = r.dim() == 4
    if r.dim() not in (3, 4) or \
            current_weights.shape != (r.shape[0], r.shape[-1]):
        raise ValueError(
            f"expected current_weights [B, N] and r [B, H, N] or "
            f"[B, S, H, N], got {tuple(current_weights.shape)} and "
            f"{tuple(r.shape)}"
        )
    B, H, N = r.shape[0], r.shape[-2], r.shape[-1]
    S = r.shape[1] if scen else 0
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
    if not kernel_supports(H, N):
        raise ValueError(
            f"H={H}, N={N} exceeds the kernel's register budget: it needs "
            f"ceil(N/32) <= {MAX_SLOTS} and pow2ceil(H) * ceil(N/32) <= "
            f"{MAX_ROW_ELEMENTS}"
        )
    if scen and not scenario_kernel_supports(S, H, N):
        raise ValueError(
            f"S={S}, H={H}, N={N} exceeds the scenario kernel's shared-"
            f"memory budget: one problem's returns take "
            f"{scenario_smem_bytes(S, H, N)} bytes of a block's "
            f"{SMEM_PER_BLOCK}"
        )
    kernel = PDHG_LOG_UTILITY_SCENARIOS if scen else PDHG_LOG_UTILITY
    w = torch.empty((B, H, N), dtype=torch.float32, device=r.device)
    fp = torch.empty(B, dtype=torch.float32, device=r.device)
    dual = torch.empty_like(w) if return_dual else None
    if B > 0:
        warm, warm_iters, cold_iters = _sweep_budgets(params, N)
        fn = kernel.function()

        def ptr(t):
            return None if t is None else t.data_ptr()

        with torch.cuda.device(r.device):
            stream = torch.cuda.current_stream(r.device).cuda_stream
            err = fn(
                current_weights.data_ptr(), r.data_ptr(), ptr(w_warm),
                ptr(p_warm), w.data_ptr(), fp.data_ptr(), ptr(dual),
                *((B, S) if scen else (B,)), H, N, params.max_iters,
                params.proj_refresh_every, warm_iters, cold_iters,
                params.cost_coeff, params.max_turnover, params.ridge,
                params.over_relax, params.step_scale, params.sigma_scale,
                int(params.precond), int(params.max_turnover > 0), int(warm),
                stream,
            )
        if err != 0:
            raise RuntimeError(
                f"{kernel.name} kernel launch failed: CUDA error {err}")
        kernel.launches += 1
    return (w, fp, dual) if return_dual else (w, fp)


def pdhg_log_utility(
    current_weights: torch.Tensor,
    r: torch.Tensor,
    params: MPCParams,
    w_warm: Optional[torch.Tensor] = None,
    p_warm: Optional[torch.Tensor] = None,
    return_dual: bool = False,
):
    """The kernel for CUDA tensors, its plain version for CPU tensors."""
    fn = pdhg_log_utility_cuda if r.is_cuda else pdhg_log_utility_plain
    return fn(current_weights, r, params, w_warm, p_warm, return_dual)


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
    _check_params(params, entry)
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
