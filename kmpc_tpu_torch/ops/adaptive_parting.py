"""Where an adaptive kernel and its plain version part, and why.

The adaptive bodies grow or shrink their steps when one residual exceeds
1.5 times the other. A kernel sums over assets by a warp butterfly and fuses
multiply-adds, its plain version uses ``torch.sum``, so their iterates differ
in the last bits, and over hundreds of iterations by more along directions
in which the objective is flat; where a decision then falls within that of a
tie the two take different branches, and from there on they are two valid
runs of one solver that end apart by the solver's own accuracy, not by
rounding. This script is the evidence for that reading, kept apart from
``chip_smoke.py``, which only bounds how many problems end apart and by how
much. Per case (seeded inputs at the path's and the scan's shapes, small
cases, and the first solves of the full-width ``finance_sparse`` comparison
at the accurate configuration) it shows two things.

1. The kernel is one more float32 realisation of the plain version. A
   third run, the plain version in float64, is the referee: the kernel may
   end apart from it (weights, duals or objective beyond the fixed-step
   kernels' bars) on no more problems than the float32 plain version does,
   up to ``REFEREE_SLACK``, and no problem may end apart from the plain
   version with an equal step history.
2. Every problem on which kernel and plain version end apart (at most
   ``SAMPLE`` per case) is traced: both sides return the signed sum of the
   iterations that moved their steps, which two equal step histories share,
   so a bisection over the iteration count finds the first decision on which
   they differ. A parting flips a decision only if the two sides' ratios
   pr / (1.5 dr) lie on either side of 1, so the margins |ratio - 1| say how
   far the two sides' residuals were from each other. Where the iterates
   going into that iteration agreed within ``AGREE_TOL`` the margins must be
   within ``TIE_TOL``: a tie. Where they had drifted further under equal
   step histories (as the fixed-step kernels' iterates do, within their
   bars) they must still be within those bars, ``W_TOL``, and the margins
   within ``DRIFT_TIE_TOL``.

    python -m kmpc_tpu_torch.ops.adaptive_parting

prints one JSON line per case and exits non-zero if a requirement failed.
It needs the card: the plain version alone has nothing to part from.
"""

from __future__ import annotations

import json
import sys
from dataclasses import replace
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from kmpc_tpu_torch._build import build_all
from kmpc_tpu_torch.ops import mpc_cuda as M
from kmpc_tpu_torch.ops import mv_cuda as V
from kmpc_tpu_torch.ops.mpc import MPCParams

TIE_TOL = 3e-3        # margins of a parting whose iterates agreed
AGREE_TOL = 1e-6      # ... to this going into the iteration
DRIFT_TIE_TOL = 5e-2  # margins of a parting after the iterates drifted
W_TOL, OBJ_TOL, SCEN_OBJ_TOL = 5e-4, 1e-5, 5e-5   # the fixed-step bars
MV_W_TOL, MV_OBJ_TOL = 5e-5, 1e-6
SCENARIOS = 16
SAMPLE = 12           # problems traced per case, of those that end apart
SEED = 0              # of the comparison model's random weights


def referee_slack(n: int) -> int:
    """How many problems the kernel may end apart from the float64 referee
    when the float32 plain version does on n: n + 3 sqrt(n) + 2 (two
    draws of one count)."""
    return n + int(3 * n ** 0.5) + 2


# One run of both implementations for n iterations: [(steps, iterate)] of
# the kernel and of the plain version, steps as ``return_steps`` gives them.
Run = Callable[[int], List[Tuple[torch.Tensor, torch.Tensor]]]


def histories_differ(steps_a: torch.Tensor, steps_b: torch.Tensor):
    """Per problem: the two step histories differ, that is the signed sums
    of the adapting iterations (the last column) do. A run that takes the
    same adaptation two iterations later ends on the same steps and another
    sum."""
    return steps_a[:, -1] != steps_b[:, -1]


def tie_margin(steps: torch.Tensor) -> torch.Tensor:
    """How far each problem's last balancing was from a tie: the smaller of
    |pr / (1.5 dr) - 1| and |dr / (1.5 pr) - 1|."""
    pr, dr = steps[:, -3].double(), steps[:, -2].double()
    return torch.minimum((pr / (1.5 * dr) - 1.0).abs(),
                         (dr / (1.5 * pr) - 1.0).abs())


def first_parting(run: Run, max_iters: int) -> Optional[Dict]:
    """The first balancing decision on which the two implementations of
    ``run`` differ (problem 0 of what it returns): None if their histories
    are equal after ``max_iters``, else the 0-based iteration, both sides'
    residuals and tie margins there, and the largest difference of the
    iterates going into that iteration."""
    def differ(n):
        (sa, _), (sb, _) = run(n)
        return bool(histories_differ(sa, sb)[0])

    if not differ(max_iters):
        return None
    lo, hi = 0, max_iters        # equal after lo iterations, differ after hi
    while hi - lo > 1:
        mid = (lo + hi) // 2
        if differ(mid):
            hi = mid
        else:
            lo = mid
    (sk, _), (sp, _) = run(hi)
    (_, xk), (_, xp) = run(hi - 1)
    return {
        "iteration": hi - 1,
        "kernel_pr_dr": sk[0, -3:-1].tolist(),
        "plain_pr_dr": sp[0, -3:-1].tolist(),
        "tie_margin_kernel": tie_margin(sk)[0].item(),
        "tie_margin_plain": tie_margin(sp)[0].item(),
        "max_abs_diff_before": (xk - xp).abs().max().item(),
    }


def _plain64(plain):
    """``plain`` run in float64 on float32 inputs, its outputs cast back."""
    def run(*tensors_and_params, **kw):
        args = [a.double() if torch.is_tensor(a) else a
                for a in tensors_and_params]
        return tuple(o.float() for o in plain(*args, **kw))
    return run


def _log_case(cw, r, params):
    """A log-utility case on card tensors: current weights [B, N], gross
    returns [B, H, N] or [B, S, H, N]. Returns (solve, the kernel, the
    plain version and the referee, weight bar, objective bar, iterations);
    ``solve(f, sel, n)`` gives (finalised weights, objective, dual, steps)
    of the problems ``sel`` after n iterations of ``f``."""
    def solve(f, sel, n):
        p = replace(params, max_iters=n)
        w, fp, dual, steps = f(cw[sel].contiguous(), r[sel].contiguous(), p,
                               return_dual=True, return_steps=True)
        w_f, info = M._finalize_packed(w, r[sel], cw[sel], p, fp)
        return w_f, info["objective"], dual, steps

    fns = (M.pdhg_log_utility_cuda, M.pdhg_log_utility_plain,
           _plain64(M.pdhg_log_utility_plain))
    obj_tol = OBJ_TOL if r.dim() == 3 else SCEN_OBJ_TOL
    return solve, fns, W_TOL, obj_tol, params.max_iters


def _mv_case(cw, mu, sig, params):
    """A mean-variance case: mu [B, H, N], Sigma [B, N, N] or [N, N]; as
    ``_log_case``, the loop's w in place of the dual."""
    shared = sig.dim() == 2
    sig = (0.5 * (sig + sig.transpose(-1, -2))).contiguous()

    def solve(f, sel, n):
        p = replace(params, max_iters=n)
        s = sig if shared else sig[sel].contiguous()
        w, fp, steps = f(cw[sel].contiguous(), mu[sel].contiguous(), s, p,
                         return_steps=True)
        w_f, info = V._finalize_mv(w, fp, mu[sel], s, cw[sel], p)
        return w_f, info["objective"], w, steps

    fns = (V.pdhg_mean_variance_cuda, V.pdhg_mean_variance_plain,
           _plain64(V.pdhg_mean_variance_plain))
    return solve, fns, MV_W_TOL, MV_OBJ_TOL, params.max_iters


def _seeded_log(B, H, N, seed, params, S=None):
    rng = np.random.default_rng(seed)
    cw = rng.dirichlet(np.ones(N), size=B).astype(np.float32)
    if S is None:
        ys = rng.standard_normal((B, H, N)) * 0.01 + 0.0005
    else:
        ys = rng.standard_normal((B, S, H, N)) * 0.01
    r = torch.exp(torch.as_tensor(ys.astype(np.float32), device="cuda"))
    return _log_case(torch.as_tensor(cw, device="cuda"), r.contiguous(),
                     params)


def _seeded_mv(B, H, N, seed, params, scale=0.05):
    rng = np.random.default_rng(seed)
    cw = rng.dirichlet(np.ones(N), size=B).astype(np.float32)
    mu = (rng.standard_normal((B, H, N)) * 0.01).astype(np.float32)
    A = rng.standard_normal((B, N, N)) * scale
    sig = (A @ np.swapaxes(A, -1, -2) + np.eye(N) * 1e-4).astype(np.float32)
    return _mv_case(*(torch.as_tensor(x, device="cuda")
                      for x in (cw, mu, sig)), params)


def comparison_cases():
    """The first solves (pre-trade guess 1/N on every date) of KoopmanMPC,
    ScenarioKelly and Markowitz in the full-width ``finance_sparse``
    comparison at the accurate configuration, random weights from ``SEED``
    on the synthetic panel: {case name: maker}."""
    from kmpc_tpu_torch.config import get_config
    from kmpc_tpu_torch.data.finance import load_finance_data
    from kmpc_tpu_torch.models.koopman import make_model
    from kmpc_tpu_torch.run_experiment import (
        backtest_settings, build_strategies, markowitz_settings,
    )

    dev = torch.device("cuda")
    cfg = get_config("finance_sparse")
    cfg.ENV.FINANCE.CACHE_DIR = None
    cfg.MPC.SOLVER.ADAPTIVE = True
    cfg.MPC.SOLVER.ADAPT_EVERY = 2
    cfg.MPC.SOLVER.PRECOND = True
    cfg.MPC.SOLVER.MAX_ITERS = 800
    fd = load_finance_data(cfg, device=dev)
    model = make_model(cfg, fd.observation_size, device=dev)
    model.init_params(torch.Generator(device=dev).manual_seed(SEED)).eval()
    bt, mpc = backtest_settings(cfg)
    mv_mpc = markowitz_settings(cfg)
    strategies = build_strategies(model, mpc, mv_mpc, bt.LOOKBACK_WINDOW,
                                  scenarios=SCENARIOS, fused=True)
    n = fd.n_assets
    n_dates = fd.test.shape[0] - fd.sequence_length - bt.HORIZON
    cw = torch.full((n_dates, n), 1.0 / n, device=dev)

    def log_returns(name, key):
        aux = strategies[name].precompute(fd, bt.HORIZON)
        return torch.exp(aux[key][:n_dates]).contiguous()

    def markowitz():
        aux = strategies["Markowitz"].precompute(fd, bt.HORIZON)
        return _mv_case(cw, aux["mu"][:n_dates, None, :].contiguous(),
                        aux["sigma"][:n_dates], mv_mpc)

    return {
        "A_comparison": lambda: _log_case(
            cw, log_returns("KoopmanMPC", "pred_log_returns"), mpc),
        "B_comparison": lambda: _log_case(
            cw, log_returns("ScenarioKelly", "scenario_log_returns"), mpc),
        "C_comparison": markowitz,
    }


def seeded_cases():
    """{case name: maker} on seeded random inputs: the comparison path's and
    the scan's shapes, and small cases."""
    acc = dict(sigma_scale=2.0, adaptive=True, adapt_every=2, precond=True)
    mv_path = MPCParams(max_iters=800, gamma=1.0, horizon=1, adaptive=True,
                        adapt_every=2, precond=True)
    return {
        "A_path_shape": lambda: _seeded_log(
            1028, 5, 20, 507, MPCParams(max_iters=800, **acc)),
        "B_path_shape": lambda: _seeded_log(
            1028, 5, 20, 605, MPCParams(max_iters=800, **acc), S=SCENARIOS),
        "C_path_shape": lambda: _seeded_mv(1028, 1, 20, 723, mv_path,
                                           scale=0.01),
        "A_scan_shape": lambda: _seeded_log(
            1, 5, 20, 508, MPCParams(max_iters=800, **acc)),
        "A_H1N12_k1": lambda: _seeded_log(7, 1, 12, 509, MPCParams(
            max_iters=400, sigma_scale=2.0, adaptive=True)),
        "A_H5N30_k2_precond": lambda: _seeded_log(
            7, 5, 30, 510, MPCParams(max_iters=400, **acc)),
        "B_S16_H5N30": lambda: _seeded_log(
            7, 5, 30, 511, MPCParams(max_iters=400, **acc), S=SCENARIOS),
        "C_H4N10_k2": lambda: _seeded_mv(6, 4, 10, 512, MPCParams(
            max_iters=1200, gamma=5.0, sigma_scale=2.0, adaptive=True,
            adapt_every=2)),
    }


def _pair(a, b, w_tol, obj_tol) -> Dict:
    """Two runs' outputs (weights, objective, iterate, steps) compared per
    problem: the masks and the differences."""
    dw = (a[0] - b[0]).abs().amax(dim=(1, 2))
    dx = (a[2] - b[2]).abs().amax(dim=(1, 2))
    dobj = a[1] - b[1]
    beyond = (dw > w_tol) | (dx > w_tol)
    return {"dw": dw, "dobj": dobj, "beyond": beyond,
            "apart": beyond | (dobj.abs() > obj_tol),
            "parted": histories_differ(a[3], b[3])}


def _summary(d: Dict) -> Dict:
    eq = ~d["parted"]
    return {"decisions_parted": int(d["parted"].sum()),
            "ended_apart": int(d["apart"].sum()),
            "beyond_weight_bar": int(d["beyond"].sum()),
            "ended_apart_with_equal_histories": int((d["apart"] & eq).sum()),
            "max_abs_dw": d["dw"].max().item(),
            "max_abs_dw_equal_histories":
                d["dw"][eq].max().item() if eq.any() else 0.0,
            "max_abs_dobj": d["dobj"].abs().max().item(),
            "mean_dobj": d["dobj"].mean().item()}


def trace_case(name: str, make, sample: int = SAMPLE
               ) -> Tuple[Dict, List[str]]:
    """One case's JSON fields and the requirements it failed."""
    solve, fns, w_tol, obj_tol, max_iters = make()
    kernel, plain, referee = (solve(f, slice(None), max_iters) for f in fns)
    kp = _pair(kernel, plain, w_tol, obj_tol)
    kr = _pair(kernel, referee, w_tol, obj_tol)
    pr = _pair(plain, referee, w_tol, obj_tol)
    res = {"case": name, "B": kernel[0].shape[0], "iters": max_iters,
           "kernel_vs_plain": _summary(kp),
           "kernel_vs_float64_plain": _summary(kr),
           "plain_vs_float64_plain": _summary(pr)}
    failed = []
    n = int((kp["apart"] & ~kp["parted"]).sum())
    if n:
        failed.append(f"{name}: {n} problems end apart with equal step "
                      "histories")
    n_k, n_p = int(kr["apart"].sum()), int(pr["apart"].sum())
    if n_k > referee_slack(n_p):
        failed.append(f"{name}: the kernel ends apart from the float64 "
                      f"plain version on {n_k} problems, the float32 plain "
                      f"version on {n_p}")

    # The problems that end apart, the worst first; of more than ``sample``
    # the worst and the others evenly over the rest.
    dw, dobj = kp["dw"], kp["dobj"]
    idx = torch.nonzero(kp["apart"] & kp["parted"])[:, 0].tolist()
    idx.sort(key=lambda b: -dw[b].item())
    if len(idx) > sample:
        rest = idx[1:]
        step = len(rest) / (sample - 1)
        idx = idx[:1] + [rest[int(i * step)] for i in range(sample - 1)]
    traces = []
    for b in idx:
        one = slice(b, b + 1)

        def run(n):
            return [(o[3], o[2])
                    for o in (solve(f, one, n) for f in fns[:2])]

        t = first_parting(run, max_iters)
        margin = max(t["tie_margin_kernel"], t["tie_margin_plain"])
        t.update(problem=b, max_abs_dw=dw[b].item(), dobj=dobj[b].item(),
                 drifted=t["max_abs_diff_before"] > AGREE_TOL)
        traces.append(t)
        if t["max_abs_diff_before"] > w_tol:
            failed.append(f"{name}, problem {b}: iterates differ by "
                          f"{t['max_abs_diff_before']} before they part")
        if margin > (DRIFT_TIE_TOL if t["drifted"] else TIE_TOL):
            failed.append(f"{name}, problem {b}: parted away from a tie: {t}")
    res["traced"] = traces
    ties = [t for t in traces if not t["drifted"]]
    drifted = [t for t in traces if t["drifted"]]
    for key, ts in (("ties", ties), ("drifted", drifted)):
        if ts:
            res[key] = {
                "count": len(ts),
                "max_tie_margin": max(max(t["tie_margin_kernel"],
                                          t["tie_margin_plain"]) for t in ts),
                "max_abs_diff_before": max(t["max_abs_diff_before"]
                                           for t in ts)}
    return res, failed


def main() -> int:
    if not torch.cuda.is_available():
        print("adaptive_parting: CUDA is not available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build_all([k.name for k in (M.PDHG_LOG_UTILITY_ADAPTIVE,
                                M.PDHG_LOG_UTILITY_SCENARIOS_ADAPTIVE,
                                V.PDHG_MEAN_VARIANCE_ADAPTIVE)])
    failures = []
    for name, make in {**seeded_cases(), **comparison_cases()}.items():
        res, failed = trace_case(name, make)
        failures += failed
        print(json.dumps(res), flush=True)
    print(json.dumps({"tie_tol": TIE_TOL, "agree_tol": AGREE_TOL,
                      "drift_tie_tol": DRIFT_TIE_TOL, "failed": failures}),
          flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
