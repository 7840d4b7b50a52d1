#!/usr/bin/env python3
"""Drive kmpc_tpu_torch on one CUDA card and check it end to end.

    python3 chip_smoke.py [--seed 0]

Phases (each prints JSON lines; any failure raises and exits non-zero):

1. ``build``: the card, torch and CUDA versions, the build of the three
   kernels (one nvcc per source, started together, from the sources in
   this checkout) with each build's seconds, registers and spills;
2. ``kernels``: every CUDA kernel against its plain PyTorch version on the
   card: the log-utility kernel over the parametrised cases of the CPU
   tests, the edges of its register budget and the main-path and bench
   shapes; the same kernel with warm inputs and the dual output; the
   scenario kernel; the mean-variance kernel with a per-problem and a
   shared covariance;
3. ``nan_row``, ``probe``: a NaN forecast holds the weights; accuracy on
   the 64 bench probe instances against the float64 oracle objectives in
   bench_probe_cache.json;
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
6. ``headline``: the solve at B=65536, H=5, N=30 and 1000 iterations;
7. the ``kernels`` line, the card's name and power limit, and last
   ``{"ok": true, "device": {...}}``.

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
    refresh = params.proj_refresh_every
    per_iter = []
    for i in range(params.max_iters):
        if not warm:
            per_iter.append(cold)
        elif refresh > 1:
            per_iter.append(warm_iters if i % refresh == 0 else 1)
        else:
            per_iter.append(warm_iters)
    return per_iter, cold


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
    12 + 4 * cold (4 S + 10 + 4 * cold with scenarios)."""
    per_iter, cold = _sweeps(params, N)
    ball = params.max_turnover > 0
    primal = 7 if S is None else 4 * S + 5
    base = primal + 14 + (1 if params.ridge else 0) \
        + (4 if params.over_relax != 1.0 else 0)
    total = sum(base + 4 * n + (1 + 4 * n if ball else 0) for n in per_iter)
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
    final half-step 2 N + 10 + 4 * cold, and the Frobenius norm 2 N."""
    per_iter, cold = _sweeps(params, N)
    base = 2 * N + 15 + (4 if params.over_relax != 1.0 else 0)
    total = sum(base + 4 * n for n in per_iter)
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
    gross returns [B, H, N] or [B, S, H, N]."""
    from dataclasses import replace

    from kmpc_tpu_torch.ops import mpc_cuda as M

    S = r.shape[1] if r.dim() == 4 else None
    B, H, N = r.shape[0], r.shape[-2], r.shape[-1]
    kw = {}
    if warm:
        w0, _, p0 = M.pdhg_log_utility_plain(cw, r, params, return_dual=True)
        params = replace(params, max_iters=max(params.max_iters // 4, 1))
        kw = dict(w_warm=w0.contiguous(), p_warm=p0.contiguous())
    dual = dual or warm
    out_k = M.pdhg_log_utility_cuda(cw, r, params, return_dual=dual, **kw)
    out_p = M.pdhg_log_utility_plain(cw, r, params, return_dual=dual, **kw)
    torch.cuda.synchronize()
    wk_f, ik = M._finalize_packed(out_k[0], r, cw, params, out_k[1])
    wp_f, ip = M._finalize_packed(out_p[0], r, cw, params, out_p[1])
    dw = (wk_f - wp_f).abs().max().item()
    dobj = (ik["objective"] - ip["objective"]).abs().max().item()
    near = ((out_p[1] - params.feas_tol).abs() <= BAND * params.feas_tol)
    flips = (ik["status_code"] != ip["status_code"]) & ~near
    obj_tol = OBJ_TOL if S is None else SCEN_OBJ_TOL
    assert dw <= W_TOL, f"{label}: weights differ by {dw}"
    assert dobj <= obj_tol, f"{label}: objectives differ by {dobj}"
    assert not flips.any().item(), f"{label}: status codes differ"
    check_feasible(wk_f, cw, params, label)
    res = {"case": label, "B": B, "H": H, "N": N, "iters": params.max_iters,
           "max_abs_dw": dw, "max_abs_dobj": dobj,
           "status_band_exempt": int((near & (ik["status_code"]
                                      != ip["status_code"])).sum().item())}
    res["bound_ms"], res["bound_by"] = pdhg_bound(B, H, N, params, S, warm,
                                                  dual)
    if S is not None:
        res["S"] = S
    if dual:
        dp = (out_k[2] - out_p[2]).abs().max().item()
        assert dp <= W_TOL, f"{label}: duals differ by {dp}"
        res["max_abs_ddual"] = dp
    res["kernel_ms"] = cuda_ms(lambda: M.pdhg_log_utility_cuda(
        cw, r, params, return_dual=dual, **kw), time_reps)
    if time_plain:
        res["plain_ms"] = cuda_ms(lambda: M.pdhg_log_utility_plain(
            cw, r, params, return_dual=dual, **kw), 1)
    return res


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
    wk, fpk = V.pdhg_mean_variance_cuda(cw, mu, sig, params)
    wp, fpp = V.pdhg_mean_variance_plain(cw, mu, sig, params)
    torch.cuda.synchronize()
    wk_f, ik = V._finalize_mv(wk, fpk, mu, sig, cw, params)
    wp_f, ip = V._finalize_mv(wp, fpp, mu, sig, cw, params)
    dw = (wk_f - wp_f).abs().max().item()
    dobj = (ik["objective"] - ip["objective"]).abs().max().item()
    assert dw <= MV_W_TOL, f"{label}: weights differ by {dw}"
    assert dobj <= MV_OBJ_TOL, f"{label}: objectives differ by {dobj}"
    assert bool(ik["converged"].all()), f"{label}: not converged"
    w64 = wk_f.double()
    assert torch.all((w64.sum(-1) - 1.0).abs() <= FEAS_TOL), label
    assert torch.all(w64 >= 0), label
    res = {"case": label, "B": B, "H": H, "N": N, "iters": params.max_iters,
           "shared_sigma": shared, "max_abs_dw": dw, "max_abs_dobj": dobj,
           "max_fp": fpk.max().item()}
    res["bound_ms"], res["bound_by"] = mv_bound(B, H, N, params, shared)
    res["kernel_ms"] = cuda_ms(lambda: V.pdhg_mean_variance_cuda(
        cw, mu, sig, params), time_reps)
    if time_plain:
        res["plain_ms"] = cuda_ms(lambda: V.pdhg_mean_variance_plain(
            cw, mu, sig, params), 1)
    return res


def _ptxas_report(name):
    """{instantiation: registers}, {instantiation: spill bytes} from the
    build log of ``name``."""
    from kmpc_tpu_torch._build import build_log

    regs, spills = {}, {}
    inst = None
    for line in build_log(name).splitlines():
        m = re.search(r"kernelILi(\d+)ELi(\d+)E", line)
        if "Compiling entry function" in line and m:
            inst = f"HM{m.group(1)}_K{m.group(2)}"
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
    out = {"pdhg_log_utility": [], "pdhg_log_utility_scenarios": [],
           "pdhg_mean_variance": []}
    for label, B, H, N, p, s, kw in cases:
        res = compare_case(label, B, H, N, p, s, **kw)
        emit("kernel_vs_plain", kernel="pdhg_log_utility", **res)
        out["pdhg_log_utility"].append(res)

    # The scenario kernel.
    quick = dict(time_plain=False)
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
    ]
    for label, B, S, H, N, p, s, kw in scen_cases:
        res = compare_case(label, B, H, N, p, s, S=S, **kw)
        emit("kernel_vs_plain", kernel="pdhg_log_utility_scenarios", **res)
        out["pdhg_log_utility_scenarios"].append(res)

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
    for label, B, H, N, p, s, kw in mv_cases:
        res = compare_mv_case(label, B, H, N, p, s, **kw)
        emit("kernel_vs_plain", kernel="pdhg_mean_variance", **res)
        out["pdhg_mean_variance"].append(res)
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
    """Bench probe: 64 instances (seed 1234, H=5, N=30) at the bench
    setting, min-form objective gap against the cached float64 oracle."""
    from kmpc_tpu_torch.ops.mpc import MPCParams
    from kmpc_tpu_torch.ops.mpc_cuda import solve_mpc_log_utility_packed

    rng = np.random.default_rng(1234)
    cw = rng.dirichlet(np.ones(30), size=64).astype(np.float32)
    ys = (rng.standard_normal((64, 5, 30)) * 0.01 + 0.0005).astype(np.float32)
    oracle = np.asarray(json.loads((ROOT / "bench_probe_cache.json")
                                   .read_text())["log_H5_N30_n64_seed1234"])
    p = MPCParams(max_iters=1000, sigma_scale=2.0, feas_tol=2e-4,
                  proj_refresh_every=16, precond=True)

    def min_objective(w):
        w = np.asarray(w, np.float64)
        r = np.exp(ys.astype(np.float64))
        port = np.maximum((w * r).sum(-1), 1e-300)
        prev = np.concatenate([cw.astype(np.float64)[:, None], w[:, :-1]], 1)
        return -np.log(port).sum(-1) + 0.001 * np.abs(w - prev).sum((-2, -1))

    w_k, _ = solve_mpc_log_utility_packed(torch.as_tensor(cw),
                                          torch.as_tensor(ys), p, device="cuda")
    w_p, _ = _plain_solve(cw, ys, p)
    objs = {"cuda": min_objective(w_k.cpu().numpy()),
            "plain": min_objective(w_p.cpu().numpy())}
    gap = objs["cuda"] - oracle
    d = float(np.max(np.abs(objs["cuda"] - objs["plain"])))
    res = {"median_gap": float(np.median(gap)),
           "p90_gap": float(np.quantile(gap, 0.9)),
           "max_gap": float(np.max(gap)), "max_kernel_vs_plain": d}
    emit("probe", **res)
    assert res["median_gap"] <= 2e-3, res
    assert d <= OBJ_TOL, res


def _plain_solve(cw, ys, p):
    """The fused solve with the plain version on the card."""
    from kmpc_tpu_torch.ops import mpc_cuda as M

    w0 = torch.as_tensor(cw, device="cuda")
    r = torch.exp(torch.as_tensor(ys, device="cuda")).contiguous()
    w, fp = M.pdhg_log_utility_plain(w0, r, p)
    return M._finalize_packed(w, r, w0, p, fp)


def buy_and_hold_jacobi_f64(rets, n_dates, sweeps, bt):
    """Final value of the buy-and-hold Jacobi backtest in float64 numpy:
    the same sweeps (targets = the guess, equal weights on the first
    date) and the same wealth/drift recursion as the port."""
    n = rets.shape[1]
    guess = np.full((n_dates, n), 1.0 / n)
    for _ in range(sweeps):
        targets = guess.copy()
        targets[0] = 1.0 / n
        v, w = bt.INITIAL_CAPITAL, np.full(n, 1.0 / n)
        for t in range(n_dates):
            guess[t] = w
            v -= bt.COST_COEFF * np.abs(targets[t] - w).sum() * v
            g = np.exp(rets[t + 1]) - 1.0
            pr = float(targets[t] @ g)
            v *= 1.0 + pr
            w = targets[t] * (1.0 + g) / (1.0 + pr)
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
    return {"fd": fd, "model": model, "cfg": cfg, "pdhg_log_utility": first}


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


def phase_comparison(ctx):
    """The full strategy comparison at full width, every batched solve
    through its kernel; then Koopman-MPC with warm sweeps. Returns the
    launches per kernel on the comparison path."""
    import pandas as pd

    from kmpc_tpu_torch.backtest.engine import (
        calculate_metrics, run_backtest_parallel,
    )
    from kmpc_tpu_torch.ops.mpc_cuda import (
        PDHG_LOG_UTILITY, PDHG_LOG_UTILITY_SCENARIOS,
    )
    from kmpc_tpu_torch.ops.mv_cuda import PDHG_MEAN_VARIANCE
    from kmpc_tpu_torch.run_experiment import (
        backtest_settings, build_strategies, markowitz_settings,
    )

    sweeps, scenarios, warm_iters = 8, 16, 500
    fd, model, cfg = ctx["fd"], ctx["model"], ctx["cfg"]
    bt, mpc = backtest_settings(cfg)
    mv_mpc = markowitz_settings(cfg)
    n_dates = fd.test.shape[0] - fd.sequence_length - bt.HORIZON
    strategies = build_strategies(model, mpc, mv_mpc, bt.LOOKBACK_WINDOW,
                                  scenarios=scenarios, fused=True)
    uses = {"Markowitz": "pdhg_mean_variance", "DMD": "pdhg_log_utility",
            "KoopmanMPC": "pdhg_log_utility",
            "ScenarioKelly": "pdhg_log_utility_scenarios"}
    kernels = {"pdhg_log_utility": PDHG_LOG_UTILITY,
               "pdhg_log_utility_scenarios": PDHG_LOG_UTILITY_SCENARIOS,
               "pdhg_mean_variance": PDHG_MEAN_VARIANCE}
    capped = {"DMD", "KoopmanMPC", "ScenarioKelly"}

    for k in kernels.values():
        k.launches = 0
    frames, timing = {}, {}
    for name, strat in strategies.items():
        timed = Timed(name, strat,
                      mpc.max_turnover if name in capped else None)
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
            # How far the pre-trade guesses still moved into the last sweep.
            guess_move = (timed.guesses[-1] - timed.guesses[-2]) \
                .abs().sum(-1).max().item()
        df = frames[name]
        assert len(df) == n_dates, name
        assert np.all(np.isfinite(df[["portfolio_value", "return",
                                      "turnover", "cost"]].to_numpy())), name
    launches = {k: v.launches for k, v in kernels.items()}
    want = {k: sweeps * sum(1 for u in uses.values() if u == k)
            for k in kernels}
    assert launches == want, f"launches {launches}, expected {want}"

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

    # The comparison path's first solves (pre-trade guess 1/N on every
    # date) of the scenario and Markowitz strategies, by each kernel and by
    # its plain version on the same card inputs.
    n = fd.n_assets
    cw = torch.full((n_dates, n), 1.0 / n, device=fd.device)
    aux = strategies["ScenarioKelly"].precompute(fd, bt.HORIZON)
    r = torch.exp(aux["scenario_log_returns"][:n_dates]).contiguous()
    first = {"pdhg_log_utility_scenarios": compare_tensors(
        "comparison_path", cw, r, mpc, time_reps=5)}
    aux = strategies["Markowitz"].precompute(fd, bt.HORIZON)
    mu = aux["mu"][:n_dates, None, :].contiguous()
    first["pdhg_mean_variance"] = compare_mv_tensors(
        "comparison_path", cw, mu, aux["sigma"][:n_dates], mv_mpc,
        time_reps=5)
    for name, res in first.items():
        emit("comparison_first_solve", kernel=name, **res)

    table = pd.DataFrame({k: calculate_metrics(v)
                          for k, v in frames.items()}).T
    print(table.to_string(), flush=True)
    assert len(table) == 5
    emit("comparison", config="finance_sparse", dates=n_dates, sweeps=sweeps,
         scenarios=scenarios, mpc_iters=mpc.max_iters, launches=launches,
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
    return launches, first


def phase_headline():
    from kmpc_tpu_torch.ops import mpc_cuda as M
    from kmpc_tpu_torch.ops.mpc import MPCParams

    B, H, N = 65536, 5, 30
    p = MPCParams(max_iters=1000, sigma_scale=2.0, feas_tol=2e-4,
                  proj_refresh_every=16, precond=True)
    cw_np, ys_np = instance(B, H, N, 0)
    cw = torch.as_tensor(cw_np, device="cuda")
    r = torch.exp(torch.as_tensor(ys_np, device="cuda")).contiguous()
    ms = cuda_ms(lambda: M.pdhg_log_utility_cuda(cw, r, p), 5)
    plain_ms = cuda_ms(lambda: M.pdhg_log_utility_plain(cw, r, p), 1)
    bound_ms, bound_by = pdhg_bound(B, H, N, p)
    emit("headline", B=B, H=H, N=N, iters=p.max_iters, kernel_ms=ms,
         solves_per_s=B / (ms / 1e3), plain_ms=plain_ms, bound_ms=bound_ms,
         bound_by=bound_by, fp32_ops=pdhg_ops(B, H, N, p),
         bound_share=bound_ms / ms)


KERNELS = {
    "pdhg_log_utility": ("kmpc_tpu_torch/csrc/pdhg_log_utility.cu",
                         "kmpc_tpu/ops/mpc_pallas.py:226"),
    "pdhg_log_utility_scenarios": (
        "kmpc_tpu_torch/csrc/pdhg_log_utility_scenarios.cu",
        "kmpc_tpu/ops/mpc_pallas.py:226"),
    "pdhg_mean_variance": ("kmpc_tpu_torch/csrc/pdhg_mean_variance.cu",
                           "kmpc_tpu/ops/mpc_pallas.py:1089"),
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
    launches, path = phase_comparison(ctx)
    path["pdhg_log_utility"] = ctx["pdhg_log_utility"]
    phase_headline()

    # One entry per kernel: launches on the comparison path, the largest
    # kernel-vs-plain weight difference over all of its cases, and its
    # times and bound at the shape the path gives it.
    kernels = []
    for name, (source, replaces) in KERNELS.items():
        at_path = path[name]
        errs = [c["max_abs_dw"] for c in cases[name]] + [at_path["max_abs_dw"]]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max(errs), "ms": at_path["kernel_ms"],
            "plain_ms": at_path["plain_ms"], "bound_ms": at_path["bound_ms"],
            "bound_by": at_path["bound_by"], "library_ms": None,
        })
        assert launches[name] > 0, f"{name} was never launched"
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
