"""Evaluate a run's checkpoints: the counterpart of the repository's
``evaluate_checkpoints.py``.

    python -m kmpc_tpu_torch.evaluate_checkpoints --run_dir RUN_DIR
        [--system NAME] [--checkpoints checkpoint last] [--horizons 100 1000]
        [--batch_size 100] [--cpu] [--allow_pickle]

A systems run goes through the evaluation suite (``eval/evaluation.py``
``evaluate_model``) into ``evaluation_{name}/``; a finance run through
``train/loop.py`` ``evaluate_finance``. Each named checkpoint is a
directory of the run (``<name>/arrays.npz``, either package's) or a
reference PyTorch ``<name>.pt`` (``utils/torch_import.py``), evaluated
with the model its own embedded config describes; a run directory of
``.pt`` files alone takes its config from the first. Writes
``evaluation_results_{name}.json`` per checkpoint and
``evaluation_summary.json``. Runs on the CUDA device unless ``--cpu``.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Dict, List, Optional

import torch


def main(argv: Optional[List[str]] = None) -> Dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--run_dir", type=str, required=True)
    parser.add_argument("--system", type=str, default=None,
                        help="system to evaluate (default: the run's ENV_NAME)")
    parser.add_argument("--checkpoints", type=str, nargs="*",
                        default=["checkpoint", "last"],
                        help="checkpoint subdirectories (or NAME.pt files) "
                             "to evaluate")
    parser.add_argument("--horizons", type=int, nargs="*", default=[100, 1000])
    parser.add_argument("--batch_size", type=int, default=100)
    parser.add_argument("--cpu", action="store_true",
                        help="evaluate on the CPU instead of the CUDA device")
    parser.add_argument("--allow_pickle", action="store_true",
                        help="permit a full unpickle of .pt checkpoints that "
                             "fail the safe weights_only load (runs code "
                             "embedded in the file; trusted files only)")
    args = parser.parse_args(argv)

    from kmpc_tpu_torch import default_device
    from kmpc_tpu_torch.config import Config
    from kmpc_tpu_torch.eval.evaluation import EvaluationSettings, evaluate_model
    from kmpc_tpu_torch.models.koopman import make_model
    from kmpc_tpu_torch.train.loop import evaluate_finance
    from kmpc_tpu_torch.utils.params import params_from_checkpoint
    from kmpc_tpu_torch.utils.torch_import import (
        check_finance_compatibility, load_torch_checkpoint,
    )

    device = torch.device("cpu") if args.cpu else default_device()
    run_dir = Path(args.run_dir)
    loaded = {}   # .pt path -> its load, read once

    def load_pt(path: Path) -> Dict:
        if path not in loaded:
            loaded[path] = load_torch_checkpoint(
                str(path), allow_pickle=args.allow_pickle, device=device)
        return loaded[path]

    if (run_dir / "config.json").exists():
        cfg = Config.from_json(str(run_dir / "config.json"))
    else:
        pts = [run_dir / f"{n}.pt" for n in args.checkpoints
               if (run_dir / f"{n}.pt").exists()]
        if not pts:
            raise FileNotFoundError(
                f"No config.json or {args.checkpoints}.pt under {run_dir}")
        cfg = load_pt(pts[0])["config"]
    system_name = args.system or cfg.ENV.ENV_NAME
    is_finance = system_name.lower() == "finance"

    if is_finance:
        from kmpc_tpu_torch.data.finance import load_finance_data

        fd = load_finance_data(cfg, device=device)
        model = make_model(cfg, fd.observation_size, device=device)
        test_init, test_future = fd.get_test_sequences(
            num_sequences=min(args.batch_size, fd.test.shape[0] // 2),
            max_length=max(args.horizons))
    else:
        from kmpc_tpu_torch.data.systems import make_system

        model = make_model(cfg, make_system(cfg, system_name).observation_size,
                           device=device)
        settings = EvaluationSettings(systems=(system_name,),
                                      horizons=tuple(args.horizons),
                                      batch_size=args.batch_size)

    summary = {}
    for name in args.checkpoints:
        ckpt_dir, pt_file = run_dir / name, run_dir / f"{name}.pt"
        if (ckpt_dir / "arrays.npz").exists():
            weights, step = params_from_checkpoint(ckpt_dir)
            model.load_state_dict(weights)
            eval_model = model.eval()
        elif pt_file.exists():
            ckpt = load_pt(pt_file)
            # The checkpoint's own config builds its model: activation,
            # norm and LISTA settings live there, not in the weights.
            eval_model = ckpt["model"]
            step = ckpt.get("step")
            step = int(step) if step is not None else -1
            if is_finance:
                check_finance_compatibility(fd, ckpt)
        else:
            print(f"Skipping {name}: not found at {ckpt_dir} or {pt_file}")
            continue
        print(f"Evaluating '{name}' (step {step}) on {system_name}...")
        if is_finance:
            res = evaluate_finance(eval_model, test_init, test_future,
                                   max_horizon=max(args.horizons))
            results = {
                "mean_mses": res["mean_mses"],
                "best_mode": res["best_mode"],
                "best_mse": res["best_mse"],
                "mse_curves": {k: v.tolist()
                               for k, v in res["mse_curves"].items()},
            }
            print(f"  best mode: {res['best_mode']} "
                  f"(MSE {res['best_mse']:.4e})")
        else:
            results = evaluate_model(eval_model, cfg, settings,
                                     output_dir=run_dir / f"evaluation_{name}")
            modes = results.get(system_name, {}).get("modes", {})
            for horizon in args.horizons:
                hk = str(horizon)
                nr = modes.get("no_reencode", {}).get("horizons", {}).get(hk)
                es = modes.get("every_step", {}).get("horizons", {}).get(hk)
                if nr and es:
                    print(f"  H={horizon}: no-reencode={nr['mean']:.4e} "
                          f"every-step={es['mean']:.4e}")
        results_file = run_dir / f"evaluation_results_{name}.json"
        with open(results_file, "w") as f:
            json.dump(results, f, indent=2)
        summary[name] = {"step": step, "results_file": str(results_file)}

    with open(run_dir / "evaluation_summary.json", "w") as f:
        json.dump(summary, f, indent=2)
    print(f"Summary written to {run_dir / 'evaluation_summary.json'}")
    return summary


if __name__ == "__main__":
    main()
