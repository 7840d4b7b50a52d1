#!/usr/bin/env python3
"""Drive kmpc_tpu_torch on one CUDA card and check it end to end.

    python3 chip_smoke.py [--seed 0]

Phases (each prints JSON lines; any failure raises and exits non-zero):

1. ``build``: the card, torch and CUDA versions, the build of the seven
   kernel sources (one nvcc per source, started together, from the sources
   in this checkout) with each build's seconds, registers and spills;
2. ``kernels``: every CUDA kernel against its plain PyTorch version on the
   card: the log-utility kernel over the parametrised cases of the CPU
   tests, the edges of its register budget and the main-path and bench
   shapes; the same kernel with warm inputs and the dual output; the
   scenario kernel; the mean-variance kernel with a per-problem and a
   shared covariance; the adaptive body of all three (``adapt_every`` 1
   and 2, ``precond`` off and on, ridge, over-relaxation, no ball, cold
   projections, warm inputs, an odd iteration count, the budget's edges);
   every rung of the MV ladder;
3. ``nan_row``, ``probe``, ``probe_accurate``: a NaN forecast holds the
   weights; accuracy on the 64 bench probe instances against the float64
   oracle objectives in bench_probe_cache.json, at the bench setting and
   at the accurate one (adaptive steps, 800 iterations);
4. ``main_path``: finance_sparse at full width (observation 400, latent
   1024) with seeded random weights on the synthetic panel, the H=5
   forecast for every test date, and the Jacobi backtest, 4 sweeps of the
   fused solve, for Koopman-MPC and buy-and-hold; the kernel's launch count
   must equal the number of sweeps;
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
8. ``mv_ladder``: the rungs of the MV ladder at B=4096, N=30, 1000
   iterations;
9. ``headline``, ``accurate_headline``: the solve at B=65536, H=5, N=30, at
   the bench setting (1000 iterations) and at the accurate one (800);
10. the ``kernels`` line, the card's name and power limit, and last
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
histories are equal must meet the bars of the fixed-step kernels. One that
ends apart must have parted histories; the script bounds the share of such
problems and their objective difference, and requires the objective
difference over all problems of a large batch to be unbiased. That the
partings are ties is shown by ``python -m kmpc_tpu_torch.ops.adaptive_parting``,
which traces the problems that end apart to their first differing decision;
it is no part of this script.

Exits non-zero, printing no result, when CUDA is unavailable.
"""

from __future__ import annotations

import argparse
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
# a large case (0-1.0% there) and two of a small one; their objectives may
# differ by FLIP_OBJ_TOL (2.5e-5 there; the accurate setting's own p90 gap
# to the oracle is 2.2e-4), and the mean signed objective difference of a
# large case by FLIP_MEAN_OBJ_TOL (6e-8 there).
BEYOND_SHARE = 0.05
FLIP_OBJ_TOL = 3e-4
FLIP_MEAN_OBJ_TOL = 2e-6
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


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn()`` after a warm-up."""
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
    from kmpc_tpu_torch.ops.mpc_cuda import _sweep_budgets

    warm, warm_iters, cold = _sweep_budgets(params, N)
    # The adaptive body runs the full budget every iteration.
    refresh = 0 if params.adaptive else params.proj_refresh_every
    per_iter = []
    for i in range(params.max_iters):
        if not warm:
            per_iter.append(cold)
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


def check_feasible(w, cw, params, label):
    w = w.double()
    s = w.sum(-1)
    assert torch.all((s - 1.0).abs() <= FEAS_TOL), f"{label}: simplex sum"
    assert torch.all(w >= -FEAS_TOL), f"{label}: negative weight"
    if params.max_turnover > 0:
        prev = torch.cat([cw.double()[:, None], w[:, :-1]], dim=1)
        to = (w - prev).abs().sum(-1)
        assert torch.all(to <= params.max_turnover + FEAS_TOL), \
            f"{label}: turnover {to.max().item()}"


def compare_case(label, B, H, N, params, seed, S=None, warm=False,
                 dual=False, time_reps=3, time_plain=True):
    """A log-utility kernel and the plain version on the same card inputs,
    through the same finalisation; returns the case's JSON fields. With S
    the scenario kernel. ``dual`` also compares the loop's last dual.
    ``warm`` compares a continuation of a quarter of the budget from the
    iterates of a cold plain solve (and its dual output)."""
    if S is None:
        cw_np, ys_np = instance(B, H, N, seed)
    else:
        cw_np, ys_np = scenario_instance(B, S, H, N, seed)
    cw = torch.as_tensor(cw_np, device="cuda")
    r = torch.exp(torch.as_tensor(ys_np, device="cuda")).contiguous()
    return compare_tensors(label, cw, r, params, warm, dual, time_reps,
                           time_plain)


def compare_tensors(label, cw, r, params, warm=False, dual=False,
                    time_reps=3, time_plain=True):
    """``compare_case`` on given card tensors: current weights [B, N] and
    gross returns [B, H, N] or [B, S, H, N]. With ``params.adaptive`` the
    bars are applied as ``adaptive_agreement`` says."""
    from dataclasses import replace

    from kmpc_tpu_torch.ops import mpc_cuda as M

    S = r.shape[1] if r.dim() == 4 else None
    B, H, N = r.shape[0], r.shape[-2], r.shape[-1]
    kw = {}
    if warm:
        w0, _, p0 = M.pdhg_log_utility_plain(cw, r, params, return_dual=True)
        params = replace(params, max_iters=max(params.max_iters // 4, 1))
        kw = dict(w_warm=w0.contiguous(), p_warm=p0.contiguous())
    dual = dual or warm or params.adaptive
    steps = params.adaptive
    out_k = M.pdhg_log_utility_cuda(cw, r, params, return_dual=dual,
                                    return_steps=steps, **kw)
    out_p = M.pdhg_log_utility_plain(cw, r, params, return_dual=dual,
                                     return_steps=steps, **kw)
    torch.cuda.synchronize()
    wk_f, ik = M._finalize_packed(out_k[0], r, cw, params, out_k[1])
    wp_f, ip = M._finalize_packed(out_p[0], r, cw, params, out_p[1])
    dw = (wk_f - wp_f).abs().amax(dim=(1, 2))
    dobj = ik["objective"] - ip["objective"]
    dp = (out_k[2] - out_p[2]).abs().amax(dim=(1, 2)) if dual \
        else torch.zeros_like(dw)
    near = ((out_p[1] - params.feas_tol).abs() <= BAND * params.feas_tol)
    differ = ik["status_code"] != ip["status_code"]
    obj_tol = OBJ_TOL if S is None else SCEN_OBJ_TOL
    res = {"case": label, "B": B, "H": H, "N": N, "iters": params.max_iters}
    if steps:
        held = adaptive_agreement(label, out_k[3], out_p[3], dw, dp, dobj,
                                  W_TOL, obj_tol, FLIP_OBJ_TOL, res)
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
    check_feasible(wk_f, cw, params, label)
    res.update({"max_abs_dw": dw.max().item(),
                "max_abs_dobj": dobj.abs().max().item(),
                "status_band_exempt": int((near & differ).sum().item())})
    res["bound_ms"], res["bound_by"] = pdhg_bound(B, H, N, params, S, warm,
                                                  dual)
    if S is not None:
        res["S"] = S
    if dual:
        res["max_abs_ddual"] = dp.max().item()
    res["kernel_ms"] = cuda_ms(lambda: M.pdhg_log_utility_cuda(
        cw, r, params, return_dual=dual, **kw), time_reps)
    if time_plain:
        res["plain_ms"] = cuda_ms(lambda: M.pdhg_log_utility_plain(
            cw, r, params, return_dual=dual, **kw), 1)
    return res


def adaptive_agreement(label, steps_k, steps_p, dw, dp, dobj, w_tol,
                       obj_tol, flip_obj_tol, res):
    """The bars of an adaptive case (see the module docstring). Returns the
    mask of the problems that meet the fixed-step bars (weights, duals,
    objective): every problem whose step histories are equal must. The
    others, which ended apart, must be few and within the solver's own
    accuracy in objective. ``dw``, ``dp`` and ``dobj`` are per-problem
    differences, kernel minus plain; the steps' last column is the signed
    sum of the iterations that moved them. Fills ``res`` with the counts
    and the differences over all problems and over the held ones."""
    B = dw.shape[0]
    parted = steps_k[:, -1] != steps_p[:, -1]
    beyond = (dw > w_tol) | (dp > w_tol)
    apart = beyond | (dobj.abs() > obj_tol)
    held = ~apart
    res.update({"decisions_parted": int(parted.sum().item()),
                "ended_apart": int(apart.sum().item()),
                "beyond_weight_bar": int(beyond.sum().item()),
                "max_abs_dw_held": dw[held].max().item() if held.any() else 0.0,
                "max_abs_dobj_held":
                    dobj[held].abs().max().item() if held.any() else 0.0,
                "mean_dobj_all": dobj.mean().item()})
    assert not (apart & ~parted).any().item(), \
        f"{label}: with equal step histories weights differ by " \
        f"{dw[~parted].max().item()}, duals by {dp[~parted].max().item()}, " \
        f"objectives by {dobj[~parted].abs().max().item()}"
    assert dobj.abs().max().item() <= flip_obj_tol, \
        f"{label}: objectives differ by {dobj.abs().max().item()}"
    if B >= 100:
        assert abs(dobj.mean().item()) <= FLIP_MEAN_OBJ_TOL, \
            f"{label}: objective differences are biased: {dobj.mean().item()}"
        assert apart.float().mean().item() <= BEYOND_SHARE, \
            f"{label}: {res['ended_apart']} of {B} ended apart"
    else:
        assert res["ended_apart"] <= 2, \
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
    mu [B, H, N] and a covariance [B, N, N] or [N, N]."""
    from kmpc_tpu_torch.ops import mv_cuda as V

    B, H, N = mu.shape
    shared = sig.dim() == 2
    sig = (0.5 * (sig + sig.transpose(-1, -2))).contiguous()
    steps = params.adaptive
    out_k = V.pdhg_mean_variance_cuda(cw, mu, sig, params, return_steps=steps)
    out_p = V.pdhg_mean_variance_plain(cw, mu, sig, params,
                                       return_steps=steps)
    (wk, fpk), (wp, fpp) = out_k[:2], out_p[:2]
    torch.cuda.synchronize()
    wk_f, ik = V._finalize_mv(wk, fpk, mu, sig, cw, params)
    wp_f, ip = V._finalize_mv(wp, fpp, mu, sig, cw, params)
    dw_all = (wk_f - wp_f).abs().amax(dim=(1, 2))
    dobj_all = ik["objective"] - ip["objective"]
    res = {"case": label, "B": B, "H": H, "N": N, "iters": params.max_iters,
           "shared_sigma": shared}
    if steps:
        # As the log-utility kernels' adaptive cases, but the objective bar
        # holds for every problem: where decisions part, the two runs of
        # this program keep the same objective and differ in the weights
        # along directions in which the covariance is nearly flat.
        held = adaptive_agreement(
            label, out_k[2], out_p[2], dw_all, torch.zeros_like(dw_all),
            dobj_all, MV_W_TOL, MV_OBJ_TOL, MV_OBJ_TOL, res)
    else:
        held = torch.ones_like(dw_all, dtype=torch.bool)
    dw = dw_all[held].max().item() if held.any() else 0.0
    dobj = dobj_all.abs().max().item()
    res.update({"max_abs_dw": dw_all.max().item(), "max_abs_dobj": dobj,
                "max_fp": fpk.max().item()})
    assert dw <= MV_W_TOL, f"{label}: weights differ by {dw}"
    assert dobj <= MV_OBJ_TOL, f"{label}: objectives differ by {dobj}"
    assert bool(ik["converged"].all()), f"{label}: not converged"
    w64 = wk_f.double()
    assert torch.all((w64.sum(-1) - 1.0).abs() <= FEAS_TOL), label
    assert torch.all(w64 >= 0), label
    res["bound_ms"], res["bound_by"] = mv_bound(B, H, N, params, shared)
    res["kernel_ms"] = cuda_ms(lambda: V.pdhg_mean_variance_cuda(
        cw, mu, sig, params), time_reps)
    if time_plain:
        res["plain_ms"] = cuda_ms(lambda: V.pdhg_mean_variance_plain(
            cw, mu, sig, params), 1)
    return res


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
        if len(regs) > 20:      # the ladder's 72 rungs: the extremes only
            regs = {"instantiations": len(regs), "max": max(regs.values())}
        emit("build", kernel=name, seconds=secs[name], registers=regs,
             spill_store_bytes={k: v for k, v in spills.items() if v})


def _params(**kw):
    from kmpc_tpu_torch.ops.mpc import MPCParams

    return MPCParams(sigma_scale=2.0, **kw)


def phase_kernel_vs_plain():
    """Every kernel against its plain version; returns the cases by
    kernel name."""
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
    names = ("pdhg_log_utility", "pdhg_log_utility_scenarios",
             "pdhg_mean_variance")
    out = {n + a: [] for n in names for a in ("", "_adaptive")}
    out["mv_ladder"] = []

    def record(kernel, res, params):
        kernel += "_adaptive" if params.adaptive else ""
        emit("kernel_vs_plain", kernel=kernel, **res)
        out[kernel].append(res)

    for label, B, H, N, p, s, kw in cases:
        record("pdhg_log_utility", compare_case(label, B, H, N, p, s, **kw), p)

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
    ]
    for label, B, S, H, N, p, s, kw in scen_cases:
        record("pdhg_log_utility_scenarios",
               compare_case(label, B, H, N, p, s, S=S, **kw), p)

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
    for label, B, H, N, p, s, kw in mv_cases:
        record("pdhg_mean_variance",
               compare_mv_case(label, B, H, N, p, s, **kw), p)

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
        w = np.asarray(w, np.float64)
        r = np.exp(ys.astype(np.float64))
        port = np.maximum((w * r).sum(-1), 1e-300)
        prev = np.concatenate([cw.astype(np.float64)[:, None], w[:, :-1]], 1)
        return -np.log(port).sum(-1) + 0.001 * np.abs(w - prev).sum((-2, -1))

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
    M.PDHG_LOG_UTILITY.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    df = run_backtest_parallel(strat, fd, bt, num_sweeps=sweeps)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = M.PDHG_LOG_UTILITY.launches
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
         kernel_launches=launches, load_s=load_s, forecast_ms=fc_ms,
         forecast_cpu_max_abs_err=fc_err, sweep_ms=sweep_ms,
         solve_ms=solve_ms, kernel_ms=kernel_ms,
         recursion_ms=sweep_ms - solve_ms, plain_ms=plain_ms,
         max_abs_dw=dw, max_abs_dobj=dobj, buy_and_hold_s=bh_s,
         buy_and_hold_rel_err_f64=bh_err,
         dates_per_s=n_dates / total_s,
         metrics={k: {m: float(x) for m, x in row.items()}
                  for k, row in table.iterrows()})
    return {"fd": fd, "model": model, "cfg": cfg, "n_dates": n_dates,
            "pdhg_log_utility": first}


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


USES = {"Markowitz": "pdhg_mean_variance", "DMD": "pdhg_log_utility",
        "KoopmanMPC": "pdhg_log_utility",
        "ScenarioKelly": "pdhg_log_utility_scenarios"}
CAPPED = {"DMD", "KoopmanMPC", "ScenarioKelly"}
SCENARIOS = 16


def kernel_counters():
    """Every kernel's launch counter by name."""
    from kmpc_tpu_torch.ops import mpc_cuda as M
    from kmpc_tpu_torch.ops import mv_cuda as V
    from kmpc_tpu_torch.ops.mv_ladder import MV_LADDER

    return {k.name: k for k in (
        M.PDHG_LOG_UTILITY, M.PDHG_LOG_UTILITY_SCENARIOS,
        V.PDHG_MEAN_VARIANCE, M.PDHG_LOG_UTILITY_ADAPTIVE,
        M.PDHG_LOG_UTILITY_SCENARIOS_ADAPTIVE,
        V.PDHG_MEAN_VARIANCE_ADAPTIVE, MV_LADDER)}


def run_strategies(ctx, cfg, sweeps):
    """The five-strategy Jacobi comparison under ``cfg``'s solver settings,
    every batched solve through its kernel and every returned weight row
    checked. Counts are set to 0 just before and read just after. Returns
    (strategies, frames, timing, launches, KoopmanMPC's ``Timed``, (mpc,
    mv_mpc, bt))."""
    from kmpc_tpu_torch.backtest.engine import run_backtest_parallel
    from kmpc_tpu_torch.run_experiment import (
        backtest_settings, build_strategies, markowitz_settings,
    )

    fd, model = ctx["fd"], ctx["model"]
    bt, mpc = backtest_settings(cfg)
    mv_mpc = markowitz_settings(cfg)
    n_dates = fd.test.shape[0] - fd.sequence_length - bt.HORIZON
    strategies = build_strategies(model, mpc, mv_mpc, bt.LOOKBACK_WINDOW,
                                  scenarios=SCENARIOS, fused=True)
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
    suffix = "_adaptive" if mpc.adaptive else ""
    want = {k: 0 for k in kernels}
    for kernel in USES.values():
        want[kernel + suffix] += sweeps
    assert launches == want, f"launches {launches}, expected {want}"
    return strategies, frames, timing, launches, koopman, (mpc, mv_mpc, bt)


def first_solves(ctx, strategies, mpc, mv_mpc, bt, names, label):
    """The path's first solves (pre-trade guess 1/N on every date) of the
    named strategies, by each kernel and by its plain version on the same
    card inputs: {kernel name: the case}."""
    fd = ctx["fd"]
    n = fd.n_assets
    n_dates = fd.test.shape[0] - fd.sequence_length - bt.HORIZON
    cw = torch.full((n_dates, n), 1.0 / n, device=fd.device)
    suffix = "_adaptive" if mpc.adaptive else ""
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
        first[USES[name] + suffix] = res
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
    from kmpc_tpu_torch.ops.mpc_cuda import PDHG_LOG_UTILITY
    from kmpc_tpu_torch.run_experiment import build_strategies

    sweeps, warm_iters = 8, 500
    fd, model, cfg = ctx["fd"], ctx["model"], ctx["cfg"]
    strategies, frames, timing, launches, koopman, (mpc, mv_mpc, bt) = \
        run_strategies(ctx, cfg, sweeps)
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

    PDHG_LOG_UTILITY.launches = 0
    df_warm, timed, warm_s = warm_run(fused=True)
    assert PDHG_LOG_UTILITY.launches == sweeps, PDHG_LOG_UTILITY.launches
    df_eager, _, _ = warm_run(fused=False)
    assert PDHG_LOG_UTILITY.launches == sweeps, PDHG_LOG_UTILITY.launches
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
                         ("ScenarioKelly", "Markowitz"), "comparison_path")
    for name, res in first.items():
        emit("comparison_first_solve", kernel=name, **res)

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
        run_strategies(ctx, cfg, sweeps)
    assert mpc.adaptive and mpc.adapt_every == 2 and mpc.precond \
        and mpc.max_iters == 800 and mv_mpc.adaptive
    first = first_solves(ctx, strategies, mpc, mv_mpc, bt,
                         ("KoopmanMPC", "ScenarioKelly", "Markowitz"),
                         "accurate_path")
    for name, res in first.items():
        emit("accurate_first_solve", kernel=name, **res)
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
        want = {} if name == "BuyAndHold" else \
            {"pdhg_log_utility_adaptive": n_dates}
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
        want = {} if name == "BuyAndHold" else \
            {USES[name] + "_adaptive": cut_dates}
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
             kernel_ms=ms, solves_per_s=B / (ms / 1e3), plain_ms=plain_ms,
             bound_ms=bound_ms, bound_by=bound_by,
             fp32_ops=pdhg_ops(B, H, N, p), bound_share=bound_ms / ms)


_LOG, _MV = "kmpc_tpu_torch/csrc/pdhg_log_utility", \
    "kmpc_tpu_torch/csrc/pdhg_mean_variance"
KERNELS = {
    "pdhg_log_utility": (_LOG + ".cu", "kmpc_tpu/ops/mpc_pallas.py:226"),
    "pdhg_log_utility_scenarios": (_LOG + "_scenarios.cu",
                                   "kmpc_tpu/ops/mpc_pallas.py:226"),
    "pdhg_mean_variance": (_MV + ".cu", "kmpc_tpu/ops/mpc_pallas.py:1089"),
    "pdhg_log_utility_adaptive": (_LOG + "_adaptive.cu",
                                  "kmpc_tpu/ops/mpc_pallas.py:593"),
    "pdhg_log_utility_scenarios_adaptive": (
        _LOG + "_scenarios_adaptive.cu", "kmpc_tpu/ops/mpc_pallas.py:593"),
    "pdhg_mean_variance_adaptive": (_MV + "_adaptive.cu",
                                    "kmpc_tpu/ops/mpc_pallas.py:1196"),
    "mv_ladder": ("kmpc_tpu_torch/csrc/mv_ladder.cu",
                  "scripts/mv_ladder.py:55"),
}


def main():
    parser = argparse.ArgumentParser(description="kmpc_tpu_torch chip smoke")
    parser.add_argument("--seed", type=int, default=0,
                        help="seed of the main path's random weights")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        sys.exit(1)

    phase_build()
    cases = phase_kernel_vs_plain()
    phase_nan_row()
    phase_probe()
    ctx = phase_main_path(args.seed)
    launches, path, fixed_values = phase_comparison(ctx)
    path["pdhg_log_utility"] = ctx["pdhg_log_utility"]
    accurate_launches, accurate_first = phase_accurate_path(ctx, fixed_values)
    path.update(accurate_first)
    scan_launches = phase_scan_path(ctx)
    ladder_launches, path["mv_ladder"] = phase_mv_ladder()
    phase_headline()

    # One entry per kernel: launches on the path that runs it (the
    # comparison path for the fixed-step kernels, the accurate path for the
    # adaptive ones, the ladder's entry point for the ladder; each counted
    # from 0 over that path alone), the largest kernel-vs-plain weight
    # difference over every problem of all of its cases (for an adaptive
    # kernel the problems that ended apart included, with their count, the
    # count of parted step histories and the largest objective difference
    # beside it), and its times and bound at the shape the path gives it.
    for name in KERNELS:
        if name.endswith("_adaptive"):
            launches[name] = accurate_launches[name]
    launches["mv_ladder"] = ladder_launches
    kernels = []
    for name, (source, replaces) in KERNELS.items():
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
                "problems": sum(c["B"] for c in every),
                "ended_apart": sum(c["ended_apart"] for c in every),
                "decisions_parted": sum(c["decisions_parted"] for c in every),
                "max_abs_err_held": max(c["max_abs_dw_held"] for c in every),
                "max_abs_dobj_all": max(c["max_abs_dobj"] for c in every)})
        kernels.append(entry)
        assert launches[name] > 0, f"{name} was never launched"
    assert scan_launches == {"pdhg_log_utility_adaptive":
                             ctx["n_dates"]}, scan_launches
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
