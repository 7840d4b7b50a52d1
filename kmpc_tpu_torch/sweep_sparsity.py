"""The sparsity-coefficient sweep: the counterpart of the repository's
``sweep_sparsity.py``.

    python -m kmpc_tpu_torch.sweep_sparsity [--config generic_sparse]
        [--env duffing] [--num_steps 2000] [--batch_size 64]
        [--coefficients C ...] [--eval_horizon 100] [--log_dir DIR] [--cpu]

Every coefficient trains at once (``train/sweep.py``) on the CUDA device
unless ``--cpu``; writes ``sparsity_sweep_results.json`` (and its figure
where matplotlib imports) and prints the coefficient with the lowest
no-reencode MSE.
"""

from __future__ import annotations

import argparse
from typing import List, Optional

# The reference's sweep grid.
DEFAULT_COEFFS = [0.0, 1e-4, 5e-4, 1e-3, 5e-3, 0.01, 0.02, 0.05, 0.1, 0.2,
                  0.3, 0.4, 0.5]


def main(argv: Optional[List[str]] = None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--config", type=str, default="generic_sparse")
    parser.add_argument("--env", type=str, default="duffing")
    parser.add_argument("--num_steps", type=int, default=2000)
    parser.add_argument("--batch_size", type=int, default=64)
    parser.add_argument("--coefficients", type=float, nargs="*", default=None)
    parser.add_argument("--eval_horizon", type=int, default=100)
    parser.add_argument("--log_dir", type=str, default="./runs/sparsity_sweep")
    parser.add_argument("--cpu", action="store_true",
                        help="run on the CPU instead of the CUDA device")
    args = parser.parse_args(argv)

    import torch

    from kmpc_tpu_torch import default_device
    from kmpc_tpu_torch.config import get_config
    from kmpc_tpu_torch.train.sweep import run_sparsity_sweep

    cfg = get_config(args.config)
    cfg.ENV.ENV_NAME = args.env
    cfg.TRAIN.NUM_STEPS = args.num_steps
    cfg.TRAIN.BATCH_SIZE = args.batch_size
    device = torch.device("cpu") if args.cpu else default_device()
    results, run_dir = run_sparsity_sweep(
        cfg, args.coefficients or DEFAULT_COEFFS, log_dir=args.log_dir,
        eval_horizon=args.eval_horizon, device=device)
    print(f"Log directory: {run_dir}")
    best = min(zip(results["coefficients"], results["no_reencode_mse"]),
               key=lambda kv: kv[1])
    print(f"Best coefficient: {best[0]} (MSE {best[1]:.4e})")
    return results, run_dir


if __name__ == "__main__":
    main()
