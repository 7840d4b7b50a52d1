#!/usr/bin/env python3
"""Drive kmpc_tpu_torch on one CUDA card and check it end to end.

    python3 chip_smoke.py [--seed 0]

Phases (each prints one JSON line; any failure raises and exits non-zero):

1. device and build: the card, torch and CUDA versions, the kernel build
   (nvcc from the sources in this checkout) and its register report;
2. the CUDA kernel against its plain PyTorch version on the card, over the
   parametrised cases of the CPU tests, the edges of the kernel's register
   budget, and the main-path and bench shapes;
3. accuracy on the 64 bench probe instances against the float64 oracle
   objectives in bench_probe_cache.json;
4. the main path: finance_sparse at full width (observation 400, latent
   1024) with seeded random weights on the synthetic panel, the H=5
   forecast for every test date, and the Jacobi backtest, 8 sweeps of the
   fused solve, for Koopman-MPC and buy-and-hold; the kernel's launch count
   must equal the number of sweeps;
5. the headline solve, B=65536, H=5, N=30 at 1000 iterations;
6. the ``kernels`` line, the card's name and power limit, and last
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

OBJ_TOL = 1e-5     # objective, kernel vs plain
W_TOL = 5e-4       # weights, kernel vs plain
FEAS_TOL = 1e-5    # simplex sum and turnover cap after restoration
BAND = 0.1         # status codes may differ within 10% of feas_tol


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


def pdhg_ops(B, H, N, params) -> float:
    """FP32 operations of one fused solve, counted per element from the
    iteration (each add, multiply, compare or max is one; a sum over assets
    is one add per element). Per iteration: 7 for the primal step (portfolio
    sum, gradient, D'p, step; 1 more with a ridge), 9 for the projection
    output, the extrapolation and the dual input, 3 for the dual magnitude
    and 2 for the clip; 4 per Michelot sweep (compare, select, count, sum)
    on the primal side and, with the turnover ball, 1 + 4 per sweep on the
    dual side (l1 and the sweeps); 4 for over-relaxation. Once: the initial
    cold projection 3 + 4 * cold, the final half-step 12 + 4 * cold."""
    from kmpc_tpu_torch.ops.mpc_cuda import _sweep_budgets

    warm, warm_iters, cold = _sweep_budgets(params, N)
    ball = params.max_turnover > 0
    refresh = params.proj_refresh_every
    base = 21 + (1 if params.ridge else 0) \
        + (4 if params.over_relax != 1.0 else 0)
    total = 0.0
    for i in range(params.max_iters):
        if not warm:
            n = cold
        elif refresh > 1:
            n = warm_iters if i % refresh == 0 else 1
        else:
            n = warm_iters
        total += base + 4 * n + (1 + 4 * n if ball else 0)
    total += (3 + 4 * cold) + (12 + 4 * cold)
    return float(B) * H * N * total


def pdhg_bound(B, H, N, params):
    """(bound_ms, bound_by): the larger of the bytes moved once (cw and r
    in, w and fp out) over HBM and the FP32 operations over the peak."""
    byte_ms = 4.0 * (B * N + 2 * B * H * N + B) / PEAK_HBM_BYTES * 1e3
    op_ms = pdhg_ops(B, H, N, params) / PEAK_FP32_FLOPS * 1e3
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


def compare_case(label, B, H, N, params, seed, time_reps=3):
    """Kernel and plain version on the same card inputs, through the same
    finalisation; returns the case's JSON fields."""
    from kmpc_tpu_torch.ops import mpc_cuda as M

    cw_np, ys_np = instance(B, H, N, seed)
    cw = torch.as_tensor(cw_np, device="cuda")
    y = torch.as_tensor(ys_np, device="cuda")
    r = torch.exp(y).contiguous()
    wk, fpk = M.pdhg_log_utility_cuda(cw, r, params)
    wp, fpp = M.pdhg_log_utility_plain(cw, r, params)
    torch.cuda.synchronize()
    wk_f, ik = M._finalize_packed(wk, r, cw, params, fpk)
    wp_f, ip = M._finalize_packed(wp, r, cw, params, fpp)
    dw = (wk_f - wp_f).abs().max().item()
    dobj = (ik["objective"] - ip["objective"]).abs().max().item()
    near = ((fpp - params.feas_tol).abs() <= BAND * params.feas_tol)
    flips = (ik["status_code"] != ip["status_code"]) & ~near
    assert dw <= W_TOL, f"{label}: weights differ by {dw}"
    assert dobj <= OBJ_TOL, f"{label}: objectives differ by {dobj}"
    assert not flips.any().item(), f"{label}: status codes differ"
    check_feasible(wk_f, cw, params, label)
    kernel_ms = cuda_ms(lambda: M.pdhg_log_utility_cuda(cw, r, params),
                        time_reps)
    plain_ms = cuda_ms(lambda: M.pdhg_log_utility_plain(cw, r, params), 1)
    return {"case": label, "B": B, "H": H, "N": N,
            "iters": params.max_iters, "kernel_ms": kernel_ms,
            "plain_ms": plain_ms, "max_abs_dw": dw, "max_abs_dobj": dobj,
            "status_band_exempt": int((near & (ik["status_code"]
                                       != ip["status_code"])).sum().item())}


def phase_build():
    from kmpc_tpu_torch._build import build_all, build_log

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    secs = build_all()
    regs, spills = {}, {}
    inst = None
    for line in build_log("pdhg_log_utility").splitlines():
        m = re.search(r"kernelILi(\d+)ELi(\d+)E", line)
        if "Compiling entry function" in line and m:
            inst = f"HM{m.group(1)}_K{m.group(2)}"
        elif inst and "spill stores" in line:
            spills[inst] = int(re.search(r"(\d+) bytes spill stores", line).group(1))
        elif inst and "registers" in line:
            regs[inst] = int(re.search(r"Used (\d+) registers", line).group(1))
    emit("device", smi=smi_line(), torch=torch.__version__,
         cuda=torch.version.cuda, python=sys.version.split()[0],
         device=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count())
    emit("build", seconds=secs, registers=regs, spill_store_bytes=spills)


def phase_kernel_vs_plain():
    from kmpc_tpu_torch.ops.mpc import MPCParams

    cases = []
    seed = 0
    for H, N in ((1, 12), (1, 33), (5, 12), (5, 20), (5, 30), (5, 33)):
        for refresh in (0, 16):
            for precond in (False, True):
                seed += 1
                p = MPCParams(max_iters=400, sigma_scale=2.0,
                              proj_refresh_every=refresh, precond=precond)
                cases.append((f"H{H}N{N}r{refresh}p{int(precond)}",
                              7, H, N, p, seed))
    # The edges of the register budget: pow2ceil(H) * ceil(N/32) = 16 with
    # one, two and four slots per lane, and three slots.
    for label, H, N, refresh, precond in (
            ("H12N20r0p0", 12, 20, 0, False), ("H16N32r16p1", 16, 32, 16, True),
            ("H8N64r16p1", 8, 64, 16, True), ("H3N90r0p0", 3, 90, 0, False),
            ("H4N128r16p1", 4, 128, 16, True)):
        seed += 1
        cases.append((label, 7, H, N, MPCParams(
            max_iters=400, sigma_scale=2.0, proj_refresh_every=refresh,
            precond=precond), seed))
    cases += [
        ("no_ball", 8, 5, 20, MPCParams(max_iters=400, sigma_scale=2.0,
                                        max_turnover=0.0), 101),
        ("over_relax", 8, 5, 30, MPCParams(max_iters=400, sigma_scale=2.0,
                                           over_relax=1.5), 102),
        ("over_relax_cond", 7, 5, 30, MPCParams(
            max_iters=400, sigma_scale=2.0, over_relax=1.5,
            proj_refresh_every=16), 107),
        ("cold", 8, 5, 33, MPCParams(max_iters=400, sigma_scale=2.0,
                                     proj_warm_iters=0), 103),
        ("ridge_precond", 8, 5, 20, MPCParams(max_iters=400, sigma_scale=2.0,
                                              ridge=1e-3, precond=True,
                                              feas_tol=3e-4), 104),
        ("main_path", 1028, 5, 20, MPCParams(max_iters=2000,
                                             sigma_scale=2.0), 105),
        ("bench_backtest", 4096, 5, 30,
         MPCParams(max_iters=500, sigma_scale=2.0, proj_refresh_every=16,
                   precond=True), 106),
    ]
    out = []
    for label, B, H, N, p, s in cases:
        res = compare_case(label, B, H, N, p, s)
        emit("kernel_vs_plain", **res)
        out.append(res)
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

    sweeps = 8
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

    class TimedKoopman(KoopmanMPCStrategy):
        """Records each sweep's solve time (kernel plus finalisation)."""

        def rebalance_all(self, aux, current_weights):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = super().rebalance_all(aux, current_weights)
            torch.cuda.synchronize()
            self.solve_s.append(time.perf_counter() - t)
            return out

    strat = TimedKoopman(model=model, mpc=mpc)
    strat.solve_s = []
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
    wk, fpk = M.pdhg_log_utility_cuda(cw, r, mpc)
    wp, fpp = M.pdhg_log_utility_plain(cw, r, mpc)
    wk, ik = M._finalize_packed(wk, r, cw, mpc, fpk)
    wp, ip = M._finalize_packed(wp, r, cw, mpc, fpp)
    dw = (wk - wp).abs().max().item()
    dobj = (ik["objective"] - ip["objective"]).abs().max().item()
    assert dw <= W_TOL and dobj <= OBJ_TOL, (dw, dobj)
    check_feasible(wk, cw, mpc, "main_path")
    kernel_ms = cuda_ms(lambda: M.pdhg_log_utility_cuda(cw, r, mpc), 5)
    plain_ms = cuda_ms(lambda: M.pdhg_log_utility_plain(cw, r, mpc), 1)
    solve_ms = 1e3 * float(np.median(strat.solve_s))
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
    return {"launches": launches, "B": n_dates, "params": mpc,
            "H": bt.HORIZON, "N": fd.n_assets, "kernel_ms": kernel_ms,
            "plain_ms": plain_ms, "max_abs_dw": dw}


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
    main_path = phase_main_path(args.seed)
    phase_headline()

    bound_ms, bound_by = pdhg_bound(main_path["B"], main_path["H"],
                                    main_path["N"], main_path["params"])
    kernels = [{
        "name": "pdhg_log_utility",
        "route": "cuda",
        "source": "kmpc_tpu_torch/csrc/pdhg_log_utility.cu",
        "replaces": "kmpc_tpu/ops/mpc_pallas.py:226",
        "launches": main_path["launches"],
        "max_abs_err": max([main_path["max_abs_dw"]]
                           + [c["max_abs_dw"] for c in cases]),
        "ms": main_path["kernel_ms"],
        "plain_ms": main_path["plain_ms"],
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
