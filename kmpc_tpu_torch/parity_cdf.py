"""Measured weight-parity CDF: the batched PDHG solve and the verified path
(``MPCParams.polish``) against the scipy oracle.

    python -m kmpc_tpu_torch.parity_cdf --families random --polish_n 32
    python -m kmpc_tpu_torch.parity_cdf --cpu --merge_only

Port of the repository's ``parity_cdf.py``. Instances:

- RANDOM: cw ~ Dirichlet(1), y ~ 0.01 N(0,1) + 5e-4 (the bench instance
  family, H=5, N=30).
- REALISTIC: per-date Koopman H-step forecasts on the synthetic finance
  test split (a briefly trained GenericKM, the backtest's
  ``predict_returns``) paired with drifted pre-trade weights from a
  Koopman-MPC backtest, on the native 20 assets.

Both sides solve the same program: the PDHG solver with the ridge
tie-breaker (``MPCParams.ridge``) and the trust-constr oracle with the
matching ridge term (ops/mpc_oracle.py). The ridge makes the optimum
unique, so weight-level disagreement measures solver error. Metric:
max-abs error of the FIRST weight row per instance; its CDF and the
fraction <= 1e-4 go to ``--out``.

Resumable: each expensive stage keeps per-instance records and skips work
already recorded. Records are read from ``--cache_dir`` (written there)
and, where missing there, from the repository's ``parity_cache/``, which
this module only reads:

- instances_{family}_{n}.npz          the instance set (deterministic seed)
- oracle_{family}.jsonl               one record per oracle solve
- pdhg_{family}_{iters}.npz           the batched PDHG solves
- polish_{family}.jsonl               one record per POLISHED instance

The polished row covers however many instances the polish records hold;
its order is a seeded permutation of the instance set with the
first-rebalance (equal-weight 1/N) instance first (``polish_order``).
``--polish_n`` extends the row; ``--merge_only`` recomputes the artifact
from the records without new solves. The PDHG and polish solves run on the
card unless ``--cpu`` is given; the oracle runs on the host.
"""

from __future__ import annotations

import argparse
import json
import time
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

import numpy as np
import torch

H, N = 5, 30
# The repository's records, read and never written.
REPO_CACHE = Path(__file__).resolve().parent.parent / "parity_cache"


def make_random_instances(n, seed=0):
    rng = np.random.default_rng(seed)
    cw = rng.dirichlet(np.ones(N), size=n).astype(np.float32)
    ys = (rng.standard_normal((n, H, N)) * 0.01 + 5e-4).astype(np.float32)
    return cw, ys


def make_realistic_instances(n, seed=0, train_steps=300, device="cuda"):
    """Koopman-forecast returns and drifted pre-trade weights from a
    backtest, on ``device``: the instance distribution the MPC solver sees
    in production."""
    from kmpc_tpu_torch import stream_seed
    from kmpc_tpu_torch.backtest.engine import KoopmanMPCStrategy, run_backtest
    from kmpc_tpu_torch.config import BacktestConfig, get_config
    from kmpc_tpu_torch.data.finance import load_finance_data
    from kmpc_tpu_torch.models.koopman import make_model
    from kmpc_tpu_torch.ops.mpc import MPCParams
    from kmpc_tpu_torch.train.loop import init_train_state, make_train_step

    cfg = get_config("finance_sparse")
    cfg.MODEL.TARGET_SIZE = 128          # small model: forecasts, not SOTA
    cfg.TRAIN.BATCH_SIZE = 32
    fd = load_finance_data(cfg, device=device)
    n_assets = fd.n_assets               # native 20-asset universe
    model = make_model(cfg, fd.observation_size, device=device)
    state = init_train_state(cfg, model, torch.Generator(device).manual_seed(
        stream_seed(seed, 0)))
    data_gen = torch.Generator(device).manual_seed(stream_seed(seed, 1))
    step_fn = make_train_step(cfg, model, dt=1.0)
    L = cfg.TRAIN.SEQUENCE_LENGTH if cfg.TRAIN.USE_SEQUENCE_LOSS else 1
    for _ in range(train_steps):
        win = fd.sample_batch(data_gen, "train", cfg.TRAIN.BATCH_SIZE, L)
        batch = win if cfg.TRAIN.USE_SEQUENCE_LOSS else (win[:, 0], win[:, 1])
        state, _ = step_fn(state, batch)

    strat = KoopmanMPCStrategy(
        model=model,
        mpc=MPCParams(max_iters=1000, sigma_scale=2.0, proj_refresh_every=16),
    )
    preds = strat.precompute(fd, H)["pred_log_returns"]        # [T, H, n]
    hist = run_backtest(strat, fd, BacktestConfig(HORIZON=H),
                        return_dataframe=False)
    targets = np.asarray(hist["weights"])                       # [T, N]
    rets = fd.destandardize_returns(
        fd.extract_current_returns(fd.test)).cpu().numpy()
    T = targets.shape[0]
    # Pre-trade weights for date t = date t-1's target drifted by the
    # realized return.
    cw = np.empty((T, n_assets), np.float32)
    cw[0] = 1.0 / n_assets
    simple = np.expm1(rets[1:T + 1] if rets.shape[0] > T else rets[:T])
    for t in range(1, T):
        gross = targets[t - 1] * (1.0 + simple[t - 1])
        cw[t] = gross / max(gross.sum(), 1e-12)
    ys = preds.cpu().numpy()[:T].astype(np.float32)
    idx = np.linspace(0, T - 1, n).astype(int) if T >= n else np.arange(T)
    return cw[idx], ys[idx]


# ---------------------------------------------------------------------------
# Cached stages
# ---------------------------------------------------------------------------


def _cached(name, cache_dir):
    """The record file ``name`` in ``cache_dir``, else in the repository's
    parity_cache/, else None."""
    for d in (Path(cache_dir), REPO_CACHE):
        if (d / name).exists():
            return d / name
    return None


def get_instances(family, n, cache_dir, device="cuda"):
    path = _cached(f"instances_{family}_{n}.npz", cache_dir)
    if path is not None:
        d = np.load(path)
        return d["cw"], d["ys"]
    print(f"[{family}] building {n} instances...", flush=True)
    if family == "random":
        cw, ys = make_random_instances(n)
    else:
        cw, ys = make_realistic_instances(n, device=device)
    np.savez(Path(cache_dir) / f"instances_{family}_{n}.npz", cw=cw, ys=ys)
    return cw, ys


def _read_jsonl(path):
    recs = {}
    if path is not None and path.exists():
        with open(path) as f:
            for line in f:
                line = line.strip()
                if line:
                    r = json.loads(line)
                    recs[r["idx"]] = r
    return recs


def _records(name, cache_dir):
    """The records of ``name`` in the repository's parity_cache/, updated
    by those in ``cache_dir``."""
    recs = _read_jsonl(REPO_CACHE / name)
    recs.update(_read_jsonl(Path(cache_dir) / name))
    return recs


def _append_jsonl(path, recs):
    with open(path, "a") as f:
        for r in recs:
            f.write(json.dumps(r) + "\n")


def _oracle_one(args):
    idx, cw, y, ridge = args
    from kmpc_tpu_torch.ops.mpc_oracle import solve_mpc_log_utility_oracle

    w, info = solve_mpc_log_utility_oracle(
        np.asarray(cw, np.float64), np.asarray(y, np.float64), ridge=ridge
    )
    return {"idx": idx, "w": np.asarray(w).ravel().tolist(),
            "optimal": bool(info["status"] == "optimal")}


def solve_oracle_cached(family, cw, ys, ridge, cache_dir, workers=2):
    """Full [n, H, N] oracle solutions + optimal flags, resumable."""
    name = f"oracle_{family}.jsonl"
    recs = _records(name, cache_dir)
    todo = [i for i in range(cw.shape[0]) if i not in recs]
    if todo:
        print(f"[{family}] oracle: {len(todo)} to solve "
              f"({len(recs)} cached)...", flush=True)
        path = Path(cache_dir) / name
        jobs = [(i, cw[i], ys[i], ridge) for i in todo]
        with ProcessPoolExecutor(max_workers=workers) as pool:
            batch = []
            for out in pool.map(_oracle_one, jobs, chunksize=4):
                batch.append(out)
                if len(batch) >= 16:
                    _append_jsonl(path, batch)
                    batch = []
            _append_jsonl(path, batch)
        recs = _records(name, cache_dir)
    h, n_ = ys.shape[1:]
    w = np.stack([np.asarray(recs[i]["w"]).reshape(h, n_)
                  for i in range(cw.shape[0])])
    ok = np.asarray([recs[i]["optimal"] for i in range(cw.shape[0])])
    return w, ok


def solve_pdhg_cached(family, cw, ys, ridge, iters, cache_dir, device="cuda"):
    """The batched PDHG solve (the eager solver, float32, on ``device``) of
    every instance, resumable."""
    name = f"pdhg_{family}_{iters}.npz"
    path = _cached(name, cache_dir)
    if path is not None:
        d = np.load(path)
        if d["w"].shape[0] == cw.shape[0]:
            return d["w"], d["conv"]
    from kmpc_tpu_torch.ops.mpc import MPCParams, solve_mpc_log_utility_batch

    print(f"[{family}] PDHG@{iters} on {cw.shape[0]} instances...",
          flush=True)
    params = MPCParams(max_iters=iters, sigma_scale=2.0, ridge=ridge)
    w, info = solve_mpc_log_utility_batch(
        torch.as_tensor(cw, device=device), torch.as_tensor(ys, device=device),
        params)
    w = w.cpu().numpy()
    conv = info["converged"].cpu().numpy()
    np.savez(Path(cache_dir) / name, w=w, conv=conv)
    return w, conv


def polish_order(n):
    """Deterministic processing order for the polished row: a seeded
    permutation with the first-rebalance (idx 0, equal-weight 1/N) instance
    first. Any prefix is an unbiased sample of the instance set but for
    the idx-0 inclusion (the hardest certification class, so it can only
    bias the certified fraction down)."""
    rng = np.random.default_rng(12345)
    perm = rng.permutation(n).tolist()
    perm.remove(0)
    return [0] + perm


def run_polish_chunks(family, cw, ys, ridge, iters, cycles, cache_dir,
                      polish_n, budget_s, chunk=16, device="cuda"):
    """Run the verified path on chunks of the polish order until
    ``polish_n`` instances are recorded or the time budget is spent."""
    from kmpc_tpu_torch.ops.mpc import MPCParams
    from kmpc_tpu_torch.ops.mpc_polish import (
        solve_mpc_log_utility_batch_polished,
    )

    name = f"polish_{family}.jsonl"
    recs = _records(name, cache_dir)
    order = [i for i in polish_order(cw.shape[0]) if i not in recs]
    order = order[:max(0, polish_n - len(recs))]
    if not order:
        return recs
    params = MPCParams(max_iters=iters, sigma_scale=2.0, ridge=ridge,
                       polish=True, polish_newton=4)
    t0 = time.monotonic()
    done = 0
    while order:
        if budget_s and time.monotonic() - t0 > budget_s:
            print(f"[{family}] polish budget exhausted after {done} "
                  f"instances this session", flush=True)
            break
        ids = order[:chunk]
        order = order[chunk:]
        w, info = solve_mpc_log_utility_batch_polished(
            torch.as_tensor(cw[ids], device=device),
            torch.as_tensor(ys[ids], device=device), params, cycles=cycles,
        )
        res = info["residual_after"].cpu().numpy()
        w = w.cpu().numpy()
        _append_jsonl(Path(cache_dir) / name, [
            {"idx": int(i), "w": w[k].ravel().tolist(),
             "residual_after": float(res[k])}
            for k, i in enumerate(ids)
        ])
        done += len(ids)
        ncert = int((res < 1e-10).sum())
        print(f"[{family}] polish chunk done ({done} this session, "
              f"{len(recs) + done} total): {ncert}/{len(ids)} certified, "
              f"max res {res.max():.2e}", flush=True)
    return _records(name, cache_dir)


# ---------------------------------------------------------------------------
# Stats / merge
# ---------------------------------------------------------------------------


def ridged_objective(w, ys, cw, ridge, cost_coeff=0.001):
    """Min-form ridged objective, float64, per instance [n]."""
    w = np.asarray(w, np.float64)
    r = np.exp(np.asarray(ys, np.float64))
    port = np.maximum((w * r).sum(-1), 1e-300)
    prev = np.concatenate([np.asarray(cw, np.float64)[:, None], w[:, :-1]], 1)
    u = w - prev
    return (
        -np.log(port).sum(-1)
        + cost_coeff * np.abs(u).sum((-2, -1))
        + 0.5 * ridge * (w * w).sum((-2, -1))
    )


def cdf_stats(err):
    err = np.asarray(err)

    def q(p):
        return float(np.quantile(err, p))

    return {
        "n": int(err.size),
        "median": q(0.5),
        "p90": q(0.9),
        "p99": q(0.99),
        "max": float(err.max()),
        "frac_le_1e-4": float(np.mean(err <= 1e-4)),
        "frac_le_1e-3": float(np.mean(err <= 1e-3)),
    }


def merge_family(family, cw, ys, ridge, iters_list, cache_dir,
                 device="cuda"):
    """Assemble one family's rows from the records."""
    h, n_ = ys.shape[1:]
    w_or, ok = solve_oracle_cached(family, cw, ys, ridge, cache_dir)
    obj_or = ridged_objective(w_or, ys, cw, ridge)
    fam = {"n": int(cw.shape[0]), "settings": {},
           "oracle_optimal_frac": float(ok.mean())}
    for iters in iters_list:
        w_pd, conv = solve_pdhg_cached(family, cw, ys, ridge, iters,
                                       cache_dir, device)
        err = np.max(np.abs(w_pd[:, 0, :] - w_or[:, 0, :]), axis=-1)
        gap = ridged_objective(w_pd, ys, cw, ridge) - obj_or
        fam["settings"][f"pdhg_{iters}"] = {
            **cdf_stats(err),
            "converged_frac": float(np.asarray(conv, float).mean()),
            "objective_gap_median": float(np.median(gap)),
            "objective_gap_p99": float(np.quantile(gap, 0.99)),
            "objective_gap_max": float(gap.max()),
        }
    recs = _records(f"polish_{family}.jsonl", cache_dir)
    if recs:
        ids = sorted(recs)
        w_pp = np.stack([np.asarray(recs[i]["w"]).reshape(h, n_)
                         for i in ids])
        res_after = np.asarray([recs[i]["residual_after"] for i in ids])
        err = np.max(np.abs(w_pp[:, 0, :] - w_or[ids][:, 0, :]), axis=-1)
        obj_pp = ridged_objective(w_pp, ys[ids], cw[ids], ridge)
        dom = obj_pp - obj_or[ids]          # < 0: we beat the oracle
        fam["settings"][f"pdhg_{max(iters_list)}_polished"] = {
            **cdf_stats(err),
            "kkt_certified_frac": float(np.mean(res_after < 1e-10)),
            "residual_after_max": float(res_after.max()),
            "objective_leq_oracle_frac": float(np.mean(dom <= 1e-12)),
            "objective_margin_median": float(np.median(dom)),
            "objective_margin_max": float(dom.max()),
            "uncertified_idx": [int(i) for i, r in
                                zip(ids, res_after) if r >= 1e-10],
        }
    return fam


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="weight-parity CDF of the port's solves against the "
                    "scipy oracle")
    ap.add_argument("--families", nargs="*",
                    default=["random", "realistic"])
    ap.add_argument("--n", type=int, default=1000)
    ap.add_argument("--ridge", type=float, default=1e-3)
    ap.add_argument("--iters", type=int, nargs="*", default=[1000, 30000])
    ap.add_argument("--polish_n", type=int, default=0,
                    help="target size of the POLISH=True verified row "
                         "(resumable; 0 = merge whatever is recorded)")
    ap.add_argument("--polish_cycles", type=int, default=3)
    ap.add_argument("--budget_s", type=float, default=0,
                    help="wall-clock budget for NEW polish work this "
                         "session (0 = unlimited)")
    ap.add_argument("--cache_dir", type=str, default="runs/parity_cache",
                    help="where new records go (missing ones are read from "
                         "the repository's parity_cache/)")
    ap.add_argument("--merge_only", action="store_true")
    ap.add_argument("--out", type=str, default="runs/parity_cdf.json")
    ap.add_argument("--cpu", action="store_true",
                    help="run the PDHG and polish solves on the CPU")
    args = ap.parse_args(argv)

    if args.cpu:
        device = torch.device("cpu")
    else:
        from kmpc_tpu_torch import default_device

        device = default_device()
    cache_dir = Path(args.cache_dir)
    cache_dir.mkdir(parents=True, exist_ok=True)

    results = {"ridge": args.ridge, "H": H, "N": N, "families": {},
               "provenance": {}}
    for family in args.families:
        cw, ys = get_instances(family, args.n, cache_dir, device)
        if not args.merge_only and args.polish_n:
            # Oracle and PDHG rows are built lazily by merge_family; the
            # budgeted polish runs first so that a killed session still
            # leaves complete per-instance records behind.
            solve_oracle_cached(family, cw, ys, args.ridge, cache_dir)
            run_polish_chunks(
                family, cw, ys, args.ridge, max(args.iters),
                args.polish_cycles, cache_dir, args.polish_n,
                args.budget_s, device=device,
            )
        results["families"][family] = merge_family(
            family, cw, ys, args.ridge, args.iters, cache_dir, device
        )
        npol = results["families"][family].get("settings", {}).get(
            f"pdhg_{max(args.iters)}_polished", {}).get("n", 0)
        results["provenance"][family] = (
            f"from the per-instance records in {args.cache_dir}/ and the "
            f"repository's parity_cache/ (oracle/pdhg n={cw.shape[0]}, "
            f"polished n={npol}; polish order: seeded permutation with the "
            f"equal-weight first-rebalance instance first)"
        )

    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    with open(out, "w") as f:
        json.dump(results, f, indent=1)
    print(json.dumps(results))


if __name__ == "__main__":
    main()
