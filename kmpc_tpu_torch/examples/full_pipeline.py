"""The whole pipeline at demo scale: the counterpart of the repository's
``examples/full_pipeline.py``.

    python -m kmpc_tpu_torch.examples.full_pipeline [--cpu] [--steps 300]
        [--sweeps 20]

1. the synthetic finance panel, embedded and split;
2. a Koopman autoencoder (GenericKM, z=128) trained for ``--steps`` steps;
3. the multi-mode forecast evaluation;
4. batched MPC solves of 1024 problems: deterministic (kernel A) and
   stochastic Kelly over 8 scenarios (kernel B);
5. the five-strategy Jacobi backtest (kernels A, B and C) and its metrics.

Runs on the CUDA device, every batched solve through its kernel, unless
``--cpu`` asks for the CPU, where the kernels' plain versions run.
``main`` returns the results beside what they came from: the data
(``fd``), the trained model, the step-4 problems (``problems``: current
weights, returns, scenario returns) and the backtest's strategies,
settings (``bt``) and solver parameters (``mpc``).
"""

from __future__ import annotations

import argparse
from typing import Dict, List, Optional


def main(argv: Optional[List[str]] = None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--sweeps", type=int, default=20,
                    help="Jacobi sweeps of the backtest")
    args = ap.parse_args(argv)

    import numpy as np
    import pandas as pd
    import torch

    from kmpc_tpu_torch import default_device, stream_seed
    from kmpc_tpu_torch.backtest import (
        BuyAndHoldStrategy, DMDStrategy, KoopmanMPCStrategy,
        MarkowitzStrategy, ScenarioKoopmanMPCStrategy, calculate_metrics,
        run_backtest_parallel,
    )
    from kmpc_tpu_torch.config import BacktestConfig, get_config
    from kmpc_tpu_torch.data.finance import load_finance_data
    from kmpc_tpu_torch.models.koopman import make_model
    from kmpc_tpu_torch.ops.mpc import MPCParams
    from kmpc_tpu_torch.ops.mpc_cuda import (
        solve_mpc_log_utility_packed, solve_mpc_log_utility_scenarios_packed,
    )
    from kmpc_tpu_torch.train.loop import (
        _DATA, _INIT, evaluate_finance, init_train_state, make_train_step,
    )

    device = torch.device("cpu") if args.cpu else default_device()
    out: Dict = {}

    print("== 1. Data: synthetic price panel -> embedding -> leak-free splits")
    cfg = get_config("finance_sparse")
    cfg.MODEL.TARGET_SIZE = 128
    cfg.MODEL.ENCODER.LAYERS = [128, 128]
    cfg.ENV.FINANCE.EMBEDDING_DIM = 8
    cfg.ENV.FINANCE.CACHE_DIR = None
    cfg.TRAIN.BATCH_SIZE = 32
    fd = load_finance_data(cfg, device=device)
    print(f"   {fd.n_assets} assets x d={fd.embedding_dim} -> obs "
          f"{fd.observation_size}; train/val/test = {fd.train.shape[0]}/"
          f"{fd.val.shape[0]}/{fd.test.shape[0]}")

    print(f"== 2. Train GenericKM (z={cfg.MODEL.TARGET_SIZE}) for "
          f"{args.steps} steps")
    model = make_model(cfg, fd.observation_size, device=device)
    state = init_train_state(cfg, model, torch.Generator(device=device)
                             .manual_seed(stream_seed(cfg.SEED, _INIT)))
    step_fn = make_train_step(cfg, model, dt=1.0)
    L = cfg.TRAIN.SEQUENCE_LENGTH
    gen = torch.Generator(device=device)
    report = max(args.steps // 5, 1)
    losses = []
    for s in range(args.steps):
        gen.manual_seed(stream_seed(cfg.SEED, _DATA, s))
        _, metrics = step_fn(state, fd.sample_batch(gen, "train",
                                                    cfg.TRAIN.BATCH_SIZE, L))
        if (s + 1) % report == 0 or s + 1 == args.steps:
            losses.append(float(metrics["loss"]))
            print(f"   step {s + 1}: loss {losses[-1]:.3f}")
    out["losses"] = losses
    model.eval()

    print("== 3. Multi-mode forecast evaluation")
    init, future = fd.get_test_sequences(num_sequences=50, max_length=50)
    ev = evaluate_finance(model, init, future, max_horizon=50)
    for mode, mse in sorted(ev["mean_mses"].items()):
        print(f"   {mode:<14} MSE {mse:.4f}")
    out["mean_mses"] = ev["mean_mses"]

    print("== 4. Batched MPC: 1024 problems in one solve, deterministic and "
          "stochastic Kelly (8 scenarios)")
    rng = np.random.default_rng(0)
    B, H, N, S = 1024, 5, fd.n_assets, 8
    cw = torch.as_tensor(rng.dirichlet(np.ones(N), size=B), dtype=torch.float32,
                         device=device)
    ys = torch.as_tensor(rng.standard_normal((B, H, N)) * 0.01,
                         dtype=torch.float32, device=device)
    yss = torch.as_tensor(rng.standard_normal((B, S, H, N)) * 0.01,
                          dtype=torch.float32, device=device)
    out["problems"] = (cw, ys, yss)
    for name, solve, y in (
            ("deterministic", solve_mpc_log_utility_packed, ys),
            ("scenario_kelly", solve_mpc_log_utility_scenarios_packed, yss)):
        w, info = solve(cw, y, MPCParams(max_iters=1000), device=device)
        sum_err = float((w.sum(-1) - 1).abs().max())
        converged = float(info["converged"].float().mean())
        print(f"   {name}: weights {tuple(w.shape)}, sum err {sum_err:.1e}, "
              f"converged {converged:.0%}")
        out[name] = {"sum_err": sum_err, "converged": converged,
                     "finite": bool(torch.isfinite(w).all())}

    print(f"== 5. 5-strategy backtest over the test split ({args.sweeps} "
          "Jacobi sweeps)")
    mpc = MPCParams(max_iters=1000)
    strategies = {
        "BuyAndHold": BuyAndHoldStrategy(),
        "Markowitz": MarkowitzStrategy(mpc=MPCParams(max_iters=1000,
                                                     gamma=1.0)),
        "DMD": DMDStrategy(mpc=mpc),
        "KoopmanMPC": KoopmanMPCStrategy(model=model, mpc=mpc),
        "ScenarioKelly": ScenarioKoopmanMPCStrategy(model=model, mpc=mpc,
                                                    num_scenarios=8),
    }
    bt = BacktestConfig(HORIZON=5)
    results = {}
    for name, strat in strategies.items():
        df = run_backtest_parallel(strat, fd, bt, num_sweeps=args.sweeps)
        results[name] = calculate_metrics(df)
    print(pd.DataFrame(results).T.to_string())
    out["metrics"] = results
    out.update(fd=fd, model=model, strategies=strategies, bt=bt, mpc=mpc)
    return out


if __name__ == "__main__":
    main()
