"""The sparsity sweep: every coefficient trains at once (port of
kmpc_tpu/train/sweep.py).

The sweep's members share one model's architecture and start from one
set of weights. Their parameters are stacked on a leading axis; the loss
of every member is one ``torch.func.functional_call`` of the model under
``torch.func.vmap`` over the stacked parameters and the coefficients, so
one forward and one backward advance every run. One AdamW steps the
stacked ``other`` and ``kmat`` groups: its update is elementwise, so each
member moves as its own single run with its coefficient would. Batches are
drawn as ``train/loop.py`` draws them, from a device generator seeded from
(``SEED``, step), the same batch for every member.
"""

from __future__ import annotations

import copy
import json
import warnings
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple, Union

import torch
from torch.func import functional_call, vmap

from kmpc_tpu_torch import default_device, stream_seed
from kmpc_tpu_torch.config import Config
from kmpc_tpu_torch.data.systems import DynamicalSystem, make_system
from kmpc_tpu_torch.models.koopman import KoopmanModel, make_model
from kmpc_tpu_torch.ops.rollout import rollout
from kmpc_tpu_torch.train.loop import (
    _DATA, _EVAL, _INIT, _run_chunks, _run_dir, adamw,
)

Device = Union[str, torch.device]


@dataclass
class SweepState:
    """The members' parameters stacked on a leading axis ({name: [S,
    ...]}), one AdamW over them, and the steps taken."""

    params: Dict[str, torch.Tensor]
    optimizer: torch.optim.AdamW
    step: int = 0


class _Loss(torch.nn.Module):
    """The model's training loss (``loss_sequence`` on windows, or ``loss``
    on (x, nx)) as a module's forward, for ``functional_call``."""

    def __init__(self, model: KoopmanModel, cfg: Config, dt: float):
        super().__init__()
        self.model, self.dt = model, dt
        self.sequence = cfg.TRAIN.USE_SEQUENCE_LOSS

    def forward(self, batch):
        if self.sequence:
            return self.model.loss_sequence(batch, self.dt)
        return self.model.loss(*batch)


def make_sweep_train_step(cfg: Config, model: KoopmanModel, dt: float):
    """(state, batch, coeffs [S]) -> (state, metrics {name: [S]}): one
    AdamW step of every member on the same batch (x_seq [B, T+1, obs], or
    (x, nx)). A member's loss is the model's component losses with its own
    sparsity coefficient."""
    loss = _Loss(model, cfg, dt)

    def member_loss(params, coeff, batch):
        _, m = functional_call(loss, {f"model.{k}": v
                                      for k, v in params.items()}, (batch,))
        total = (model.res_coeff * m["residual_loss"]
                 + model.reconst_coeff * m["reconst_loss"]
                 + model.pred_coeff * m["prediction_loss"]
                 + coeff * m["sparsity_loss"])
        return total, dict(m, loss=total)

    def step(state: SweepState, batch, coeffs: torch.Tensor):
        state.optimizer.zero_grad(set_to_none=True)
        totals, metrics = vmap(member_loss, in_dims=(0, 0, None))(
            state.params, coeffs, batch)
        # The members are independent: d(sum)/d(member) is its gradient.
        totals.sum().backward()
        state.optimizer.step()
        state.step += 1
        return state, {k: v.detach() for k, v in metrics.items()}

    return step


def make_fused_sweep_step(cfg: Config, model: KoopmanModel,
                          system: DynamicalSystem):
    """(state, step, coeffs [S]) -> (state, metrics): one step of every
    member, on the batch a generator seeded from (``SEED``, step) draws on
    the state's device, with no host synchronisation (``_run_chunks``
    enqueues a chunk of these)."""
    step_fn = make_sweep_train_step(cfg, model, system.dt)
    B, T = cfg.TRAIN.BATCH_SIZE, cfg.TRAIN.SEQUENCE_LENGTH

    def fused(state: SweepState, step: int, coeffs: torch.Tensor):
        gen = torch.Generator(device=coeffs.device)
        gen.manual_seed(stream_seed(cfg.SEED, _DATA, step))
        if cfg.TRAIN.USE_SEQUENCE_LOSS:
            batch = system.sequence_batch(gen, B, T)
        else:
            x = system.reset(gen, B)
            batch = (x, system.step(x))
        return step_fn(state, batch, coeffs)

    return fused


def stack_states(cfg: Config, model: KoopmanModel,
                 generator: Optional[torch.Generator], n: int) -> SweepState:
    """``n`` members with one set of weights (fresh from ``generator``, or
    the model's own when it is None) and a fresh AdamW over them."""
    if generator is not None:
        model.init_params(generator)
    params = {k: v.detach().clone().expand(n, *v.shape).contiguous()
              .requires_grad_(True) for k, v in model.named_parameters()}
    return SweepState(params, adamw(cfg, list(params.items())))


def member(state: SweepState, i: int) -> Dict[str, torch.Tensor]:
    """Member ``i``'s parameters as a state dict."""
    return {k: v.detach()[i] for k, v in state.params.items()}


def run_sparsity_sweep(
    cfg: Config,
    coefficients: Sequence[float],
    log_dir: Optional[str] = None,
    eval_horizon: int = 100,
    eval_batch: int = 32,
    verbose: bool = True,
    device: Optional[Device] = None,
) -> Tuple[Dict, Path]:
    """Train one model per sparsity coefficient, all at once, on ``device``
    (default: the CUDA device); then each member's no-reencode rollout MSE
    at ``eval_horizon`` and its latent sparsity ratio. Returns (results,
    run_dir); the results are kmpc_tpu's ``sparsity_sweep_results.json``."""
    device = torch.device(device) if device is not None else default_device()
    run_dir = _run_dir(log_dir or "./runs/sparsity_sweep")
    cfg.to_json(str(run_dir / "config.json"))
    coeffs = torch.tensor(list(coefficients), dtype=torch.float32,
                          device=device)
    system = make_system(cfg)
    model = make_model(cfg, system.observation_size, device=device)
    state = stack_states(cfg, model, torch.Generator(device=device)
                         .manual_seed(stream_seed(cfg.SEED, _INIT)),
                         len(coefficients))
    step_fn = make_fused_sweep_step(cfg, model, system)
    log_every = max(cfg.TRAIN.LOG_INTERVAL, 1)

    def one(s):
        return step_fn(state, s, coeffs)[1]

    def on_boundary(step, metrics):
        if verbose and step % log_every == 0:
            losses = metrics["loss"]
            print(f"sweep step {step}/{cfg.TRAIN.NUM_STEPS} "
                  f"loss[min={losses.min().item():.4f} "
                  f"max={losses.max().item():.4f}]")

    _run_chunks(cfg, 0, one, on_boundary, intervals=(log_every,))

    x0 = system.reset(torch.Generator(device=device).manual_seed(
        stream_seed(cfg.SEED, _EVAL)), eval_batch)
    true = system.trajectory(x0, eval_horizon)
    evaluated = copy.deepcopy(model)
    mses, ratios = [], []
    with torch.no_grad():
        for i in range(len(coefficients)):
            evaluated.load_state_dict(member(state, i))
            pred = rollout(evaluated, x0, eval_horizon, reencode_period=0)
            sq = torch.sum((pred.float() - true) ** 2, dim=-1)
            sq = torch.where(torch.isfinite(sq), sq,
                             torch.full_like(sq, float("nan")))
            mses.append(float(torch.nanmean(sq)))
            z = evaluated.encode(x0).float()
            nonzero = torch.mean(torch.sum((z.abs() > 1e-6).float(), dim=-1))
            ratios.append(float(1.0 - nonzero / model.target_size))
    results = {
        "coefficients": [float(c) for c in coefficients],
        "no_reencode_mse": mses,
        "sparsity_ratio": ratios,
        "horizon": eval_horizon,
        "env": cfg.ENV.ENV_NAME,
        "num_steps": cfg.TRAIN.NUM_STEPS,
    }
    with open(run_dir / "sparsity_sweep_results.json", "w") as f:
        json.dump(results, f, indent=2)
    _plot_sweep(results, run_dir / "sparsity_sweep.png")
    return results, run_dir


def _plot_sweep(results: Dict, path: Path) -> None:
    """The no-reencode MSE and the sparsity ratio against the coefficient,
    on two axes; best-effort, nothing without matplotlib."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError as e:
        warnings.warn(f"matplotlib is not available ({e}); no sweep figure",
                      stacklevel=2)
        return
    coeffs = results["coefficients"]
    fig, ax1 = plt.subplots(figsize=(8, 5))
    ax1.plot(coeffs, results["no_reencode_mse"], "o-", color="#e74c3c")
    ax1.set_xlabel("sparsity coefficient")
    ax1.set_ylabel("no-reencode MSE", color="#e74c3c")
    ax1.set_xscale("symlog", linthresh=1e-4)
    ax1.set_yscale("log")
    ax2 = ax1.twinx()
    ax2.plot(coeffs, results["sparsity_ratio"], "s-", color="#3498db")
    ax2.set_ylabel("sparsity ratio", color="#3498db")
    fig.tight_layout()
    fig.savefig(path, dpi=150)
    plt.close(fig)
