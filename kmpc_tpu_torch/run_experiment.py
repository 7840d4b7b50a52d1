"""Backtest experiment: Koopman-MPC against buy-and-hold, Markowitz and DMD
(and the scenario-Kelly variant), by Jacobi sweeps or the exact date scan.

Port of the repository's ``run_experiment.py``, with its modes: by default
the exact scan, one solve per date; ``--parallel`` the Jacobi backtest,
``--sweeps`` sweeps of it (0, the default: as many as dates, also exact).
The solver's configuration, the accurate one included
(``MPC.SOLVER.ADAPTIVE``, ``ADAPT_EVERY``, ``PRECOND``, ``MAX_ITERS``, and the
pipelined body's ``PROJ_REFRESH_EVERY`` and ``PIPELINE_REDUCES``), comes
from the run directory's ``config.json``. With ``--path``
it loads a kmpc_tpu run directory (config.json and its npz checkpoint);
with ``--torch_ckpt`` (or a ``--path`` ending in ``.pt``) a reference
PyTorch ``checkpoint.pt`` (``utils/torch_import.py``; ``--allow_pickle``
permits a full unpickle of a trusted file), whose ``finance_metadata`` must
match the loaded panel; without either, it builds ``finance_sparse`` at
full width with weights drawn from ``--init_seed``, or the model and settings of ``--config`` (a
``config.json``) with such weights. It prints the metrics table and writes
``full_comparison_metrics.csv`` and ``experiment_results.json``.

    python -m kmpc_tpu_torch.run_experiment
        [--path RUN_DIR | --torch_ckpt CHECKPOINT_PT | --init_seed S]
        [--config CONFIG_JSON] [--horizon 20] [--scenarios 16]
        [--risk_aversion 1.0] [--parallel [--sweeps 8]] [--mpc_iters N]
        [--eager] [--cpu] [--output DIR]

Runs on the CUDA device, every batched solve through its fused kernel
(``--eager`` takes the eager solvers instead), unless ``--cpu`` asks for
the CPU, where the kernels' plain PyTorch versions run.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import List, Optional

import torch

from kmpc_tpu_torch.config import BacktestConfig, Config, get_config
from kmpc_tpu_torch.ops.mpc import MPCParams, mpc_params_from_config


def backtest_settings(cfg: Config, horizon=None, cost_coeff=None,
                      max_turnover=None, mpc_iters=None):
    """(BacktestConfig, MPCParams) of the experiment: the run config's
    sections with the CLI's overrides, and sigma_scale 2."""
    horizon = cfg.MPC.HORIZON if horizon is None else horizon
    cost_coeff = cfg.MPC.COST_COEFF if cost_coeff is None else cost_coeff
    max_turnover = cfg.MPC.MAX_TURNOVER if max_turnover is None else max_turnover
    mpc_iters = cfg.MPC.SOLVER.MAX_ITERS if mpc_iters is None else mpc_iters
    bt = BacktestConfig(
        INITIAL_CAPITAL=cfg.BACKTEST.INITIAL_CAPITAL,
        HORIZON=horizon,
        REBALANCE_FREQ=cfg.BACKTEST.REBALANCE_FREQ,
        COST_COEFF=cost_coeff,
        ALLOW_SHORT=cfg.BACKTEST.ALLOW_SHORT,
        LOOKBACK_WINDOW=cfg.BACKTEST.LOOKBACK_WINDOW,
    )
    mpc: MPCParams = mpc_params_from_config(
        cfg, horizon=horizon, cost_coeff=cost_coeff,
        max_turnover=max_turnover, max_iters=mpc_iters, sigma_scale=2.0,
    )
    return bt, mpc


def markowitz_settings(cfg: Config, risk_aversion: float = 1.0,
                       cost_coeff=None, mpc_iters=None) -> MPCParams:
    """MPCParams of the Markowitz baseline: horizon 1, gamma the risk
    aversion, the experiment's cost and iteration budget."""
    cost_coeff = cfg.MPC.COST_COEFF if cost_coeff is None else cost_coeff
    mpc_iters = cfg.MPC.SOLVER.MAX_ITERS if mpc_iters is None else mpc_iters
    return mpc_params_from_config(
        cfg, horizon=1, gamma=risk_aversion, cost_coeff=cost_coeff,
        max_iters=mpc_iters,
    )


def build_strategies(model, mpc: MPCParams, mv_mpc: MPCParams,
                     lookback_window: int, scenarios: int = 0,
                     fused: bool = True) -> dict:
    """The comparison's strategies by name, in the order they are run."""
    from kmpc_tpu_torch.backtest.engine import (
        BuyAndHoldStrategy,
        DMDStrategy,
        KoopmanMPCStrategy,
        MarkowitzStrategy,
        ScenarioKoopmanMPCStrategy,
    )

    strategies = {
        "BuyAndHold": BuyAndHoldStrategy(),
        "Markowitz": MarkowitzStrategy(
            mpc=mv_mpc, lookback_window=lookback_window,
            use_fused_kernel=fused),
        "DMD": DMDStrategy(mpc=mpc, use_fused_kernel=fused),
        "KoopmanMPC": KoopmanMPCStrategy(model=model, mpc=mpc,
                                         use_fused_kernel=fused),
    }
    if scenarios > 0:
        strategies["ScenarioKelly"] = ScenarioKoopmanMPCStrategy(
            model=model, mpc=mpc, num_scenarios=scenarios,
            use_fused_kernel=fused)
    return strategies


def backtest_mode(args) -> tuple:
    """("scan" or "parallel", sweeps; 0: as many as dates) of parsed
    arguments: the exact scan unless ``--parallel``, as kmpc_tpu's CLI."""
    return ("parallel" if args.parallel else "scan"), args.sweeps


def parse_args(argv: Optional[List[str]] = None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    src = parser.add_mutually_exclusive_group()
    src.add_argument("--path", type=str, default=None,
                     help="kmpc_tpu run directory to load")
    src.add_argument("--torch_ckpt", type=str, default=None,
                     help="reference PyTorch checkpoint.pt to load")
    src.add_argument("--init_seed", type=int, default=0,
                     help="seed of fresh finance_sparse weights (no --path)")
    parser.add_argument("--allow_pickle", action="store_true",
                        help="permit a full unpickle of a .pt checkpoint "
                             "that fails the safe weights_only load (runs "
                             "code embedded in the file; trusted files "
                             "only)")
    parser.add_argument("--config", type=str, default=None,
                        help="config.json of the run (fresh weights; not "
                             "with --path, whose directory has its own)")
    parser.add_argument("--horizon", type=int, default=None)
    parser.add_argument("--cost_coeff", type=float, default=None)
    parser.add_argument("--max_turnover", type=float, default=None)
    parser.add_argument("--risk_aversion", type=float, default=1.0,
                        help="gamma of the Markowitz baseline")
    parser.add_argument("--mpc_iters", type=int, default=None,
                        help="default: the config's MPC.SOLVER.MAX_ITERS")
    parser.add_argument("--scenarios", type=int, default=0,
                        help="also run the stochastic-Kelly strategy with "
                             "this many Monte-Carlo scenarios")
    parser.add_argument("--eager", action="store_true",
                        help="solve with the eager solvers instead of the "
                             "fused kernels")
    parser.add_argument("--parallel", action="store_true",
                        help="the Jacobi backtest instead of the exact "
                             "scan over dates (one solve per date)")
    parser.add_argument("--sweeps", type=int, default=0,
                        help="Jacobi sweeps with --parallel (0: as many as "
                             "dates, which is exact)")
    parser.add_argument("--cpu", action="store_true",
                        help="run on the CPU (plain-PyTorch solver)")
    parser.add_argument("--output", type=str, default=None)
    args = parser.parse_args(argv)
    if (args.path or args.torch_ckpt) and args.config:
        parser.error("--config is for fresh weights; a --path run directory "
                     "or a checkpoint holds its own config")
    return args


def main(argv: Optional[List[str]] = None) -> dict:
    args = parse_args(argv)

    import pandas as pd

    from kmpc_tpu_torch import default_device
    from kmpc_tpu_torch.backtest.engine import (
        calculate_metrics,
        run_backtest,
        run_backtest_parallel,
    )
    from kmpc_tpu_torch.data.finance import load_finance_data
    from kmpc_tpu_torch.models.koopman import make_model
    from kmpc_tpu_torch.utils.params import load_jax_checkpoint

    torch_ckpt = args.torch_ckpt
    if args.path and args.path.endswith(".pt"):
        torch_ckpt, args.path = args.path, None
    device = torch.device("cpu") if args.cpu else default_device()
    if torch_ckpt:
        from kmpc_tpu_torch.utils.torch_import import (
            check_finance_compatibility, load_torch_checkpoint,
        )

        ckpt = load_torch_checkpoint(torch_ckpt, allow_pickle=args.allow_pickle,
                                     device=device)
        cfg, model = ckpt["config"], ckpt["model"]
        print(f"Loaded reference checkpoint {torch_ckpt} at step "
              f"{ckpt['step']}")
        out_dir = Path(args.output) if args.output else Path(torch_ckpt).parent
    elif args.path:
        cfg, model, step = load_jax_checkpoint(args.path, device=device)
        if cfg.ENV.ENV_NAME != "finance":
            raise SystemExit(f"{args.path} is not a finance run "
                             f"(ENV_NAME={cfg.ENV.ENV_NAME!r})")
        print(f"Loaded {args.path} at step {step}")
        out_dir = Path(args.output) if args.output else Path(args.path)
    else:
        cfg = (Config.from_json(args.config) if args.config
               else get_config("finance_sparse"))
        out_dir = Path(args.output) if args.output else Path("runs/kmpc_tpu_torch")
    fd = load_finance_data(cfg, device=device)
    if torch_ckpt:
        check_finance_compatibility(fd, ckpt)
    elif not args.path:
        gen = torch.Generator(device=device).manual_seed(args.init_seed)
        model = make_model(cfg, fd.observation_size, device=device)
        model.init_params(gen).eval()
        print(f"{args.config or 'finance_sparse'} with fresh weights from "
              f"seed {args.init_seed}")

    bt, mpc = backtest_settings(cfg, args.horizon, args.cost_coeff,
                                args.max_turnover, args.mpc_iters)
    mv_mpc = markowitz_settings(cfg, args.risk_aversion, args.cost_coeff,
                                args.mpc_iters)
    strategies = build_strategies(model, mpc, mv_mpc, bt.LOOKBACK_WINDOW,
                                  scenarios=args.scenarios,
                                  fused=not args.eager)
    n_dates = len(range(0, fd.test.shape[0] - fd.sequence_length - bt.HORIZON,
                        bt.REBALANCE_FREQ))
    mode, sweeps = backtest_mode(args)
    sweeps = sweeps if sweeps > 0 else n_dates
    results = {}
    for name, strat in strategies.items():
        if mode == "scan":
            print(f"Backtesting {name} (date scan on {device})...")
            df = run_backtest(strat, fd, bt)
        else:
            print(f"Backtesting {name} ({sweeps} sweeps on {device})...")
            df = run_backtest_parallel(strat, fd, bt, num_sweeps=sweeps)
        results[name] = calculate_metrics(df)

    table = pd.DataFrame(results).T
    print("\n" + table.to_string())
    out_dir.mkdir(parents=True, exist_ok=True)
    table.to_csv(out_dir / "full_comparison_metrics.csv")
    with open(out_dir / "experiment_results.json", "w") as f:
        json.dump(results, f, indent=2)
    print(f"\nResults saved to {out_dir}")
    return results


if __name__ == "__main__":
    main()
