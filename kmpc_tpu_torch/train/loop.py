"""Training loops (port of kmpc_tpu/train/loop.py): AdamW with a K group,
the finance and dynamical-system loops, evaluation and checkpoints.

- AdamW has two parameter groups: ``kmat`` at ``K_MATRIX_LR`` without
  weight decay, ``other`` (everything else) at ``LR`` with
  ``WEIGHT_DECAY``; betas and eps are optax's ``adamw`` defaults.
- Batches are drawn on the device: finance windows by start indices from
  a device ``torch.Generator``, system windows by RK4 from initial states
  drawn there. The generator is seeded from (``SEED``, step) before each
  step, so a resumed run sees the batches an uninterrupted one would.
- ``STEPS_PER_DISPATCH`` steps are enqueued per host dispatch: nothing
  inside a chunk synchronises the host, and the metrics stay tensors until
  the chunk ends. ``_dispatch_chunks`` ends a chunk at every step that
  logs, evaluates or checkpoints, as kmpc_tpu's fused dispatch does.
- The spectrum of K is computed on the host at log steps only.
- Checkpoints are kmpc_tpu's npz directories (``utils/checkpoint.py``),
  readable by either package; a ``checkpoint_path`` ending in ``.pt`` is a
  reference PyTorch checkpoint, resumed with its AdamW moments and step
  (``utils/torch_import.py``).
- After training, the training curves (``plot_training_metrics.py``) and
  the finance figures are drawn where matplotlib imports; a systems run
  with ``final_eval`` evaluates its last and best checkpoints
  (``eval/evaluation.py``) into ``evaluation_{last,best}/`` and
  ``evaluation_results_{last,best}.json``.
- A ``PARALLEL`` mesh other than 1 x 1 x 1 (its product the world's size:
  one rank a card, ``torchrun`` or ``parallel/launch.py``) places the
  parameters by ``parallel.mesh.param_specs`` over 'model' and shards each
  batch over ('data', 'scenario'): every rank draws the same global batch
  from the seeded streams and keeps its rows, so the run equals the
  one-process run on the same batches up to the order of the sums. It
  takes one step a dispatch. The logs, evaluations, checkpoints and
  figures are rank 0's, from the state gathered on every rank.
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass
from datetime import datetime
from pathlib import Path
from typing import Any, Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from kmpc_tpu_torch import default_device, stream_seed as _stream_seed
from kmpc_tpu_torch.config import Config
from kmpc_tpu_torch.data.finance import FinanceData, load_finance_data
from kmpc_tpu_torch.data.systems import DynamicalSystem, make_system
from kmpc_tpu_torch.models.koopman import (
    KoopmanModel, make_model, spectral_metrics,
)
from kmpc_tpu_torch.ops.rollout import rollout
from kmpc_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from kmpc_tpu_torch.utils.logger import MetricsLogger
from kmpc_tpu_torch.utils.params import load_jax_checkpoint

Device = Union[str, torch.device]

# Salts of the random streams drawn from SEED.
_INIT, _DATA, _EVAL = 0, 1, 2


def _parallel_mesh(cfg: Config, device: torch.device):
    """The ``PARALLEL`` mesh, None at 1 x 1 x 1; ValueError where its
    product is not the world's size (``parallel.mesh.make_mesh``)."""
    sizes = (cfg.PARALLEL.DATA, cfg.PARALLEL.SCENARIO, cfg.PARALLEL.MODEL)
    if all(s in (1, None) for s in sizes):
        return None
    from kmpc_tpu_torch.parallel.mesh import mesh_from_config

    return mesh_from_config(cfg, device=device)


def _maybe_shard(state: "TrainState", mesh) -> Tuple["TrainState", Callable]:
    """(state, batch placement): without a mesh the state as it is and the
    identity; with one the state placed on it (tensor-parallel parameters)
    and batches sharded over ('data', 'scenario')."""
    if mesh is None:
        return state, lambda batch: batch
    from kmpc_tpu_torch.parallel.mesh import (
        BATCH_AXES, shard_batch, shard_train_state,
    )

    return shard_train_state(state, mesh), \
        lambda batch: shard_batch(batch, mesh, BATCH_AXES)


def _is_lead() -> bool:
    """Whether this process writes the run's files: rank 0, or the only
    process."""
    return not dist.is_initialized() or dist.get_rank() == 0


def _whole(cfg: Config, state: "TrainState", mesh, device) -> Callable:
    """A function (metrics) -> (state, metrics) with every tensor whole:
    without a mesh, both as they are; with one, a plain copy of the state
    and the metrics' values, gathered on every rank (a collective, so
    every rank calls it at the same steps)."""
    if mesh is None:
        return lambda metrics: (state, metrics)
    from kmpc_tpu_torch.parallel.mesh import full, gather_train_state

    like = []

    def gather(metrics):
        if not like:
            model = make_model(cfg, state.model.observation_size, device=device)
            like.append(TrainState(model, build_optimizer(cfg, model)))
        return (gather_train_state(state, like[0]),
                {k: full(v) for k, v in metrics.items()})

    return gather


# ---------------------------------------------------------------------------
# Optimizer and train state
# ---------------------------------------------------------------------------


def build_optimizer(cfg: Config, model: KoopmanModel) -> torch.optim.AdamW:
    """AdamW with a group ``kmat`` at K_MATRIX_LR and no weight decay, and
    a group ``other`` at LR with WEIGHT_DECAY."""
    return adamw(cfg, list(model.named_parameters()))


def adamw(cfg: Config, named) -> torch.optim.AdamW:
    """``build_optimizer``'s AdamW over (name, tensor) pairs."""
    return torch.optim.AdamW(
        [{"params": [p for n, p in named if n != "kmat"], "name": "other",
          "lr": cfg.TRAIN.LR, "weight_decay": cfg.TRAIN.WEIGHT_DECAY},
         {"params": [p for n, p in named if n == "kmat"], "name": "kmat",
          "lr": cfg.TRAIN.K_MATRIX_LR, "weight_decay": 0.0}],
        betas=(0.9, 0.999), eps=1e-8)


@dataclass
class TrainState:
    """The model, its AdamW and the number of steps taken."""

    model: KoopmanModel
    optimizer: torch.optim.AdamW
    step: int = 0


def init_train_state(cfg: Config, model: KoopmanModel,
                     generator: torch.Generator) -> TrainState:
    """Fresh weights from ``generator`` and a fresh AdamW."""
    model.init_params(generator)
    return TrainState(model, build_optimizer(cfg, model))


def _update(state: TrainState, loss_fn: Callable, batch) -> Dict[str, torch.Tensor]:
    """One AdamW step on ``loss_fn(batch)``; the metrics as detached
    tensors (no host synchronisation)."""
    state.optimizer.zero_grad(set_to_none=True)
    total, metrics = loss_fn(batch)
    total.backward()
    state.optimizer.step()
    state.step += 1
    return {k: v.detach() for k, v in metrics.items()}


def _loss_fn(cfg: Config, model: KoopmanModel, dt: float) -> Callable:
    """The sequence loss on windows [B, T+1, obs], or the pairwise loss on
    (x, nx), as ``TRAIN.USE_SEQUENCE_LOSS`` says."""
    if cfg.TRAIN.USE_SEQUENCE_LOSS:
        return lambda batch: model.loss_sequence(batch, dt)
    return lambda batch: model.loss(*batch)


def make_train_step(cfg: Config, model: KoopmanModel, dt: float):
    """(state, batch) -> (state, metrics); batch is x_seq [B, T+1, obs] or
    (x, nx)."""
    loss_fn = _loss_fn(cfg, model, dt)

    def train_step(state: TrainState, batch):
        return state, _update(state, loss_fn, batch)

    return train_step


def make_system_train_step(cfg: Config, model: KoopmanModel,
                           system: DynamicalSystem,
                           shard: Optional[Callable] = None):
    """(state, generator) -> (state, metrics): the batch (sequence windows,
    or states and their RK4 successors) synthesised on the generator's
    device, placed by ``shard`` where given (a mesh's batch sharding), then
    the step."""
    loss_fn = _loss_fn(cfg, model, system.dt)
    B, T = cfg.TRAIN.BATCH_SIZE, cfg.TRAIN.SEQUENCE_LENGTH

    def batch_of(generator):
        if cfg.TRAIN.USE_SEQUENCE_LOSS:
            return system.sequence_batch(generator, B, T)
        x = system.reset(generator, B)
        return x, system.step(x)

    def train_step(state: TrainState, generator: torch.Generator):
        batch = batch_of(generator)
        return state, _update(state, loss_fn,
                              shard(batch) if shard is not None else batch)

    return train_step


def _dispatch_chunks(start: int, num_steps: int, spd: int, intervals):
    """Yield (step, chunk) so that every step where the loop logs,
    evaluates, or checkpoints (multiples of the intervals, and the final
    step) lands exactly at a chunk END — the fused program returns the
    last inner step's metrics, so boundary steps keep their per-step
    metrics identical to the unfused loop."""
    last = num_steps - 1
    step = start
    while step < num_steps:
        nb = last
        for k in intervals:
            nb = min(nb, ((step + k - 1) // k) * k)
        chunk = min(spd, nb - step + 1, num_steps - step)
        yield step, chunk
        step += chunk


def _run_chunks(cfg: Config, start_step: int,
                step_fn: Callable[[int], Dict[str, torch.Tensor]],
                on_boundary: Callable[[int, Dict[str, torch.Tensor]], None],
                intervals: Optional[Tuple[int, ...]] = None,
                steps_per_dispatch: Optional[int] = None) -> None:
    """Enqueue each chunk's steps with no host synchronisation, then hand
    the chunk's last metrics to ``on_boundary``; chunks end on the
    multiples of ``intervals`` (default: the log and eval intervals).
    ``steps_per_dispatch`` overrides ``STEPS_PER_DISPATCH``."""
    spd = max(1, int(steps_per_dispatch or cfg.TRAIN.STEPS_PER_DISPATCH))
    if intervals is None:
        intervals = (cfg.TRAIN.LOG_INTERVAL, cfg.TRAIN.EVAL_INTERVAL)
    for step0, chunk in _dispatch_chunks(start_step, cfg.TRAIN.NUM_STEPS,
                                         spd, intervals):
        for s in range(step0, step0 + chunk):
            metrics = step_fn(s)
        on_boundary(step0 + chunk - 1, metrics)


def _log_train(logger: MetricsLogger, state: TrainState, metrics, step: int,
               verbose: bool, line: str) -> None:
    host = {k: float(v) for k, v in metrics.items()}
    host.update(spectral_metrics(state.model.kmat))
    logger.log_dict(host, step, prefix="train")
    if verbose:
        print(line.format(step=step, **host))


# ---------------------------------------------------------------------------
# Evaluation
# ---------------------------------------------------------------------------


@torch.no_grad()
def evaluate_system(model: KoopmanModel, system: DynamicalSystem,
                    x0: torch.Tensor, num_steps: int = 50) -> Dict[str, Any]:
    """Rollout (re-encoding every step) against the RK4 trajectory from
    x0 [B, D]."""
    true_traj = system.trajectory(x0, num_steps)
    pred_traj = rollout(model, x0, num_steps, reencode_period=1)
    err = torch.linalg.vector_norm(pred_traj - true_traj, dim=-1)
    step_error = torch.nanmean(err, dim=1)
    return {
        "true_trajectory": true_traj,
        "pred_trajectory": pred_traj,
        "pred_error": step_error,
        "mean_error": float(torch.nanmean(step_error)),
        "final_error": float(step_error[-1]),
    }


@torch.no_grad()
def evaluate_finance(model: KoopmanModel, initial_states: torch.Tensor,
                     future_states: torch.Tensor, max_horizon: int = 50,
                     periodic_reencode_periods=(5, 10, 25)) -> Dict[str, Any]:
    """Rollout MSE and L2 curves against the test windows, for no
    re-encoding, re-encoding every step and every p steps."""
    horizon = min(max_horizon, future_states.shape[0])
    true = future_states[:horizon]
    modes = {"every_step": 1, "no_reencode": 0}
    for p in periodic_reencode_periods:
        modes[f"periodic_{p}"] = p

    mse_curves, l2_curves, predictions = {}, {}, {}
    for name, period in modes.items():
        pred = rollout(model, initial_states, horizon, period)
        pred = pred.float()
        predictions[name] = pred.cpu().numpy()
        mse_curves[name] = torch.mean((pred - true) ** 2, dim=(1, 2)).cpu().numpy()
        l2_curves[name] = torch.mean(
            torch.linalg.vector_norm(pred - true, dim=-1), dim=1).cpu().numpy()

    mean_mses = {k: float(np.mean(v)) for k, v in mse_curves.items()}
    best_mode = min(mean_mses, key=mean_mses.get)
    return {
        "mse_reencode": mse_curves["every_step"],
        "mse_no_reencode": mse_curves["no_reencode"],
        "l2_reencode": l2_curves["every_step"],
        "l2_no_reencode": l2_curves["no_reencode"],
        "mean_mse_reencode": mean_mses["every_step"],
        "mean_mse_no_reencode": mean_mses["no_reencode"],
        "final_mse_reencode": float(mse_curves["every_step"][-1]),
        "final_mse_no_reencode": float(mse_curves["no_reencode"][-1]),
        "mse_curves": mse_curves,
        "l2_curves": l2_curves,
        "mean_mses": mean_mses,
        "predictions": predictions,
        "true": true.cpu().numpy(),
        "best_mode": best_mode,
        "best_mse": mean_mses[best_mode],
    }


@torch.no_grad()
def _val_loss(model: KoopmanModel, fd: FinanceData, cfg: Config,
              max_batches: int = 10) -> float:
    """Mean loss over consecutive validation batches (at most
    ``max_batches``); one smaller batch when the split is shorter than a
    batch, NaN when it is shorter than a window."""
    use_seq = cfg.TRAIN.USE_SEQUENCE_LOSS
    L = cfg.TRAIN.SEQUENCE_LENGTH if use_seq else 1
    B = cfg.TRAIN.BATCH_SIZE
    n = fd.num_examples("val", L)
    if n <= 0:
        return float("nan")

    def one(start, size):
        win = fd.batch_at(torch.arange(start, start + size, device=fd.device),
                          "val", L)
        if use_seq:
            return float(model.loss_sequence(win)[0])
        return float(model.loss(win[:, 0], win[:, 1])[0])

    if n < B:
        return one(0, n)
    total, batches = 0.0, 0
    for start in range(0, n - B + 1, B):
        total += one(start, B)
        batches += 1
        if batches >= max_batches:
            break
    return total / max(batches, 1)


def _run_dir(log_dir: str) -> Path:
    """The run's directory, named by rank 0's clock and made by it."""
    name = [datetime.now().strftime("%Y%m%d-%H%M%S")]
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.broadcast_object_list(name, src=0)
    run_dir = Path(log_dir) / name[0]
    if _is_lead():
        run_dir.mkdir(parents=True, exist_ok=True)
    return run_dir


def _open_run(cfg: Config, log_dir: str) -> Tuple[Path, Optional[MetricsLogger]]:
    """The run's directory, and on rank 0 its config and logger."""
    run_dir = _run_dir(log_dir)
    if not _is_lead():
        return run_dir, None
    cfg.to_json(str(run_dir / "config.json"))
    return run_dir, MetricsLogger(run_dir)


def _start(cfg: Config, model: KoopmanModel, device: torch.device,
           checkpoint_path, verbose: bool) -> Tuple[TrainState, int]:
    """The train state from SEED, or resumed from a checkpoint directory
    or a reference ``.pt`` checkpoint; and the step to start from."""
    gen = torch.Generator(device=device).manual_seed(_stream_seed(cfg.SEED, _INIT))
    state = init_train_state(cfg, model, gen)
    if checkpoint_path is None:
        return state, 0
    if str(checkpoint_path).endswith(".pt"):
        from kmpc_tpu_torch.utils.torch_import import (
            resume_train_state_from_torch,
        )

        state = resume_train_state_from_torch(str(checkpoint_path), cfg, state)
    else:
        state, meta = load_checkpoint(checkpoint_path, state)
    if verbose:
        print(f"Resumed from checkpoint at step {state.step}")
    return state, state.step


# ---------------------------------------------------------------------------
# Finance training
# ---------------------------------------------------------------------------


def train_finance(
    cfg: Config,
    log_dir: Optional[str] = None,
    checkpoint_path: Optional[str] = None,
    finance_data: Optional[FinanceData] = None,
    verbose: bool = True,
    device: Optional[Device] = None,
) -> Tuple[TrainState, KoopmanModel, Path]:
    """Finance training loop on ``device`` (default: the CUDA device).
    Returns (state, model, run_dir); under a ``PARALLEL`` mesh the state and
    model are this rank's, placed on the mesh."""
    device = torch.device(device) if device is not None else default_device()
    mesh = _parallel_mesh(cfg, device)
    lead = _is_lead()
    verbose = verbose and lead
    run_dir, logger = _open_run(cfg, log_dir or "./runs/kae_finance")

    fd = (finance_data if finance_data is not None
          else load_finance_data(cfg, device=device))
    model = make_model(cfg, fd.observation_size, device=device)
    state, start_step = _start(cfg, model, device, checkpoint_path, verbose)
    state, shard = _maybe_shard(state, mesh)
    whole = _whole(cfg, state, mesh, device)
    train_step = make_train_step(cfg, model, dt=1.0)
    use_seq = cfg.TRAIN.USE_SEQUENCE_LOSS
    L = cfg.TRAIN.SEQUENCE_LENGTH if use_seq else 1
    B = cfg.TRAIN.BATCH_SIZE
    test_init, test_future = fd.get_test_sequences(
        num_sequences=min(100, fd.test.shape[0] // 2), max_length=100)

    if verbose:
        print(f"Training {cfg.MODEL.MODEL_NAME} on finance data ({device})")
        print(f"Observation size: {fd.observation_size} "
              f"({fd.n_assets} assets x {fd.embedding_dim} embedding)")
        print(f"Steps: {cfg.TRAIN.NUM_STEPS}  Batch: {B}")
        print(f"Run dir: {run_dir}")

    gen = torch.Generator(device=device)

    def step_fn(s):
        gen.manual_seed(_stream_seed(cfg.SEED, _DATA, s))
        win = fd.sample_batch(gen, "train", B, L)
        batch = win if use_seq else (win[:, 0], win[:, 1])
        return train_step(state, shard(batch))[1]

    best_val = float("inf")
    extra = {"finance_metadata": fd.metadata}

    def on_boundary(step, metrics):
        nonlocal best_val
        log = step % cfg.TRAIN.LOG_INTERVAL == 0
        evaluate = (step % cfg.TRAIN.EVAL_INTERVAL == 0
                    or step == cfg.TRAIN.NUM_STEPS - 1)
        if not (log or evaluate):
            return
        now, metrics = whole(metrics)
        if not lead:
            return
        if log:
            _log_train(logger, now, metrics, step, verbose,
                       f"Step {{step}}/{cfg.TRAIN.NUM_STEPS} | Loss: {{loss:.4f}} | "
                       "Res: {residual_loss:.4f} | Recon: {reconst_loss:.4f} | "
                       "Pred: {prediction_loss:.4f} | Sparsity: {sparsity_ratio:.3f}")
        if evaluate:
            ev = evaluate_finance(now.model, test_init, test_future,
                                  max_horizon=50)
            for key in ("mean_mse_reencode", "mean_mse_no_reencode",
                        "final_mse_reencode", "final_mse_no_reencode"):
                logger.log_scalar(f"eval/{key}", ev[key], step)
            val_loss = _val_loss(now.model, fd, cfg)
            logger.log_scalar("val/loss", val_loss, step)
            if verbose:
                print(f"  Eval | MSE (reencode): {ev['mean_mse_reencode']:.4f} | "
                      f"MSE (no reencode): {ev['mean_mse_no_reencode']:.4f} | "
                      f"Val: {val_loss:.4f}")
            save_checkpoint(run_dir / "last", now, now.step, cfg.to_dict(),
                            extra=extra)
            if val_loss < best_val:
                best_val = val_loss
                save_checkpoint(run_dir / "checkpoint", now, now.step,
                                cfg.to_dict(), extra=extra)

    t0 = time.time()
    _run_chunks(cfg, start_step, step_fn, on_boundary,
                steps_per_dispatch=1 if mesh is not None else None)
    if verbose:
        steps_done = max(cfg.TRAIN.NUM_STEPS - start_step, 1)
        print(f"Training done in {time.time() - t0:.1f}s "
              f"({steps_done / max(time.time() - t0, 1e-9):.1f} steps/s)")

    # The final evaluation uses the best checkpoint when there is one.
    eval_model = whole({})[0].model
    if not lead:
        return state, model, run_dir
    if (run_dir / "checkpoint" / "arrays.npz").exists():
        eval_model = load_jax_checkpoint(run_dir, device=device)[1]
    final = evaluate_finance(eval_model, test_init, test_future,
                             max_horizon=100, periodic_reencode_periods=[5, 10, 25])
    summary = {
        "mean_mse_reencode": final["mean_mse_reencode"],
        "mean_mse_no_reencode": final["mean_mse_no_reencode"],
        "final_mse_reencode": final["final_mse_reencode"],
        "final_mse_no_reencode": final["final_mse_no_reencode"],
        "mse_reencode_curve": final["mse_reencode"].tolist(),
        "mse_no_reencode_curve": final["mse_no_reencode"].tolist(),
        "all_modes_mean_mse": final["mean_mses"],
        "best_mode": final["best_mode"],
        "best_mse": final["best_mse"],
    }
    with open(run_dir / "evaluation_results.json", "w") as f:
        json.dump(summary, f, indent=2)
    try:
        from kmpc_tpu_torch.eval.finance_plots import save_finance_plots

        save_finance_plots(final, fd, run_dir)
    except Exception as e:  # plots are best-effort
        print(f"Warning: failed to generate finance plots: {e}")
    logger.close()
    _plot_training_metrics(run_dir, verbose)
    return state, model, run_dir


# ---------------------------------------------------------------------------
# Dynamical-systems training
# ---------------------------------------------------------------------------


def train_system(
    cfg: Config,
    log_dir: Optional[str] = None,
    checkpoint_path: Optional[str] = None,
    verbose: bool = True,
    final_eval: bool = False,
    device: Optional[Device] = None,
) -> Tuple[TrainState, KoopmanModel, Path]:
    """Dynamical-systems training loop on ``device`` (default: the CUDA
    device). Returns (state, model, run_dir). ``final_eval`` runs the
    evaluation suite on the last and best checkpoints after training. Under
    a ``PARALLEL`` mesh the state and model returned are this rank's."""
    device = torch.device(device) if device is not None else default_device()
    mesh = _parallel_mesh(cfg, device)
    lead = _is_lead()
    verbose = verbose and lead
    run_dir, logger = _open_run(cfg, log_dir or "./runs/kae")

    system = make_system(cfg)
    model = make_model(cfg, system.observation_size, device=device)
    state, start_step = _start(cfg, model, device, checkpoint_path, verbose)
    state, shard = _maybe_shard(state, mesh)
    whole = _whole(cfg, state, mesh, device)
    train_step = make_system_train_step(cfg, model, system, shard)

    if verbose:
        print(f"Training {cfg.MODEL.MODEL_NAME} on {cfg.ENV.ENV_NAME} ({device})")
        print(f"Steps: {cfg.TRAIN.NUM_STEPS}  Batch: {cfg.TRAIN.BATCH_SIZE}")
        print(f"Run dir: {run_dir}")

    eval_x0 = system.reset(torch.Generator(device=device).manual_seed(
        _stream_seed(cfg.SEED, _EVAL)), batch_size=4)
    gen = torch.Generator(device=device)

    def step_fn(s):
        gen.manual_seed(_stream_seed(cfg.SEED, _DATA, s))
        return train_step(state, gen)[1]

    best_final_error = float("inf")

    def on_boundary(step, metrics):
        nonlocal best_final_error
        log = step % cfg.TRAIN.LOG_INTERVAL == 0
        evaluate = (step % cfg.TRAIN.EVAL_INTERVAL == 0
                    or step == cfg.TRAIN.NUM_STEPS - 1)
        if not (log or evaluate):
            return
        now, metrics = whole(metrics)
        if not lead:
            return
        if log:
            _log_train(logger, now, metrics, step, verbose,
                       f"Step {{step}}/{cfg.TRAIN.NUM_STEPS} | Loss: {{loss:.4f}} | "
                       "Res: {residual_loss:.4f} | Recon: {reconst_loss:.4f} | "
                       "Sparsity: {sparsity_ratio:.3f}")
        if evaluate:
            ev = evaluate_system(now.model, system, eval_x0, num_steps=200)
            logger.log_scalar("eval/mean_error", ev["mean_error"], step)
            logger.log_scalar("eval/final_error", ev["final_error"], step)
            if verbose:
                print(f"  Eval | Mean error: {ev['mean_error']:.4f} | "
                      f"Final error: {ev['final_error']:.4f}")
            save_checkpoint(run_dir / "last", now, now.step, cfg.to_dict())
            if ev["final_error"] < best_final_error:
                best_final_error = ev["final_error"]
                save_checkpoint(run_dir / "checkpoint", now, now.step,
                                cfg.to_dict())

    _run_chunks(cfg, start_step, step_fn, on_boundary,
                steps_per_dispatch=1 if mesh is not None else None)
    last_model = whole({})[0].model
    if not lead:
        return state, model, run_dir
    logger.close()
    _plot_training_metrics(run_dir, verbose)
    if final_eval:
        _post_training_evaluation(cfg, last_model, run_dir, verbose)
    return state, model, run_dir


def _plot_training_metrics(run_dir: Path, verbose: bool = True) -> None:
    """The training curves of ``metrics_history.jsonl`` into
    ``training_metrics.png``; best-effort, nothing without matplotlib."""
    from kmpc_tpu_torch.plot_training_metrics import plot_metrics

    try:
        out = plot_metrics(log_dir=Path(run_dir),
                           save_path=Path(run_dir) / "training_metrics.png")
    except Exception as e:  # plots are best-effort
        print(f"Warning: failed to plot training metrics: {e}")
        return
    if verbose and out is not None:
        print(f"Training metrics plot saved to {out}")


def _post_training_evaluation(cfg: Config, model: KoopmanModel,
                              run_dir: Path, verbose: bool) -> None:
    """The evaluation suite on the run's system for the ``last`` and the
    best (``checkpoint``) weights, each into ``evaluation_{tag}/`` and
    ``evaluation_results_{tag}.json``; the trained model is left as it
    is."""
    import copy

    from kmpc_tpu_torch.eval.evaluation import EvaluationSettings, evaluate_model
    from kmpc_tpu_torch.utils.params import params_from_checkpoint

    settings = EvaluationSettings(systems=(cfg.ENV.ENV_NAME,))
    evaluated = copy.deepcopy(model).eval()
    for name in ("last", "checkpoint"):
        ckpt_dir = run_dir / name
        if not (ckpt_dir / "arrays.npz").exists():
            continue
        weights, step = params_from_checkpoint(ckpt_dir)
        evaluated.load_state_dict(weights)
        tag = "best" if name == "checkpoint" else "last"
        if verbose:
            print(f"Evaluating {tag} checkpoint (step {step})...")
        results = evaluate_model(evaluated, cfg, settings,
                                 output_dir=run_dir / f"evaluation_{tag}",
                                 verbose=verbose)
        with open(run_dir / f"evaluation_results_{tag}.json", "w") as f:
            json.dump(results, f, indent=2)


def train(
    cfg: Config,
    log_dir: Optional[str] = None,
    checkpoint_path: Optional[str] = None,
    verbose: bool = True,
    final_eval: bool = False,
    device: Optional[Device] = None,
) -> Tuple[TrainState, KoopmanModel, Path]:
    """Finance training for ``ENV_NAME`` finance, else system training."""
    if cfg.ENV.ENV_NAME.lower() == "finance":
        return train_finance(cfg, log_dir, checkpoint_path, verbose=verbose,
                             device=device)
    return train_system(cfg, log_dir, checkpoint_path, verbose=verbose,
                        final_eval=final_eval, device=device)
