"""Training CLI, the counterpart of the root ``train.py``:

    python -m kmpc_tpu_torch.train --config finance_sparse
    python -m kmpc_tpu_torch.train --config lista --env duffing --no_final_eval
    python -m kmpc_tpu_torch.train --cpu --config generic --env duffing \\
        --num_steps 6 --batch_size 8 --target_size 8 --no_final_eval

It runs on the CUDA device; ``--cpu`` is the only way onto the CPU.
``--dtype bfloat16`` computes the model in bfloat16 (float32 accumulation
and master weights); ``--checkpoint`` takes a run's checkpoint directory
or a reference ``.pt`` checkpoint; a systems run ends with the evaluation
suite on its last and best checkpoints unless ``--no_final_eval``.

Under ``torchrun --nproc_per_node=N -m kmpc_tpu_torch.train ...`` each rank
joins the world (NCCL, one rank a card; gloo with ``--cpu``), and the
config's ``PARALLEL`` mesh, where its product is N, shards the run.
"""

from __future__ import annotations

import argparse
from typing import List, Optional

from kmpc_tpu_torch.config import Config, get_config


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        description="Train a Koopman autoencoder (kmpc_tpu_torch)")
    parser.add_argument(
        "--config", type=str, default="generic",
        choices=["default", "generic", "generic_sparse", "generic_prediction",
                 "lista", "lista_nonlinear", "finance_sparse"],
    )
    parser.add_argument(
        "--env", type=str, default="duffing",
        choices=["duffing", "pendulum", "lotka_volterra", "lorenz63",
                 "parabolic", "lyapunov", "finance"],
    )
    parser.add_argument("--num_steps", type=int, default=None,
                        help="default: the preset's TRAIN.NUM_STEPS")
    parser.add_argument("--batch_size", type=int, default=None,
                        help="default: the preset's TRAIN.BATCH_SIZE")
    parser.add_argument("--lr", type=float, default=None)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--target_size", type=int, default=None)
    parser.add_argument("--sparsity_coeff", type=float, default=None)
    parser.add_argument("--reconst_coeff", type=float, default=None)
    parser.add_argument("--pred_coeff", type=float, default=None)
    parser.add_argument("--lista_alpha", type=float, default=None)
    parser.add_argument("--pairwise", action="store_true",
                        help="single-step loss instead of sequence loss")
    parser.add_argument("--sequence_length", type=int, default=None)
    parser.add_argument("--log_dir", type=str, default="./runs/kae")
    parser.add_argument("--checkpoint", type=str, default=None,
                        help="checkpoint directory, or reference .pt "
                             "checkpoint, to resume from")
    parser.add_argument("--cpu", action="store_true",
                        help="train on the CPU instead of the CUDA device")
    parser.add_argument("--no_final_eval", action="store_true",
                        help="skip the post-training evaluation suite")
    parser.add_argument("--steps_per_dispatch", type=int, default=None,
                        help="optimizer steps enqueued per host dispatch")
    parser.add_argument("--dtype", type=str, default=None,
                        choices=["float32", "bfloat16"],
                        help="model compute dtype")
    return parser.parse_args(argv)


def config_from_args(args: argparse.Namespace) -> Config:
    """The run's config: the preset with the flags applied."""
    cfg = get_config(args.config)
    # finance_sparse keeps its own ENV_NAME.
    if args.config != "finance_sparse":
        cfg.ENV.ENV_NAME = args.env
    if args.num_steps is not None:
        cfg.TRAIN.NUM_STEPS = args.num_steps
    if args.batch_size is not None:
        cfg.TRAIN.BATCH_SIZE = args.batch_size
    cfg.SEED = args.seed
    if args.steps_per_dispatch is not None:
        cfg.TRAIN.STEPS_PER_DISPATCH = args.steps_per_dispatch
    if args.dtype is not None:
        cfg.TRAIN.DTYPE = args.dtype
    if args.lr is not None:
        cfg.TRAIN.LR = args.lr
    if args.target_size is not None:
        cfg.MODEL.TARGET_SIZE = args.target_size
    if args.sparsity_coeff is not None:
        cfg.MODEL.SPARSITY_COEFF = args.sparsity_coeff
    if args.reconst_coeff is not None:
        cfg.MODEL.RECONST_COEFF = args.reconst_coeff
    if args.pred_coeff is not None:
        cfg.MODEL.PRED_COEFF = args.pred_coeff
    if args.lista_alpha is not None:
        cfg.MODEL.ENCODER.LISTA.ALPHA = args.lista_alpha
    if args.pairwise:
        cfg.TRAIN.USE_SEQUENCE_LOSS = False
    if args.sequence_length is not None:
        cfg.TRAIN.SEQUENCE_LENGTH = args.sequence_length
    return cfg


def main(argv: Optional[List[str]] = None):
    import torch

    from kmpc_tpu_torch import default_device
    from kmpc_tpu_torch.parallel.distributed import initialize_distributed
    from kmpc_tpu_torch.train.loop import train

    args = parse_args(argv)
    cfg = config_from_args(args)
    # Under torchrun, join the world (one rank a card; gloo with --cpu).
    initialize_distributed(device="cpu" if args.cpu else None)
    device = torch.device("cpu") if args.cpu else default_device()
    state, model, run_dir = train(
        cfg, log_dir=args.log_dir, checkpoint_path=args.checkpoint,
        final_eval=not args.no_final_eval, device=device,
    )
    print(f"Log directory: {run_dir}")
    return state, model, run_dir


if __name__ == "__main__":
    main()
