"""Latent rollouts of the Koopman model (port of kmpc_tpu/ops/rollout.py)."""

from __future__ import annotations

import torch

from kmpc_tpu_torch.models.koopman import KoopmanModel


@torch.no_grad()
def rollout(model: KoopmanModel, x0: torch.Tensor, horizon: int,
            reencode_period: int = 0) -> torch.Tensor:
    """Predictions [horizon, batch, obs] from x0 [batch, obs] (x0 not
    included). ``reencode_period``: 0 = latent only, k = re-encode the
    prediction every k steps. A sample whose prediction turns non-finite
    emits NaN from then on and its latent stays frozen."""
    z = model.encode(x0)
    alive = torch.ones(x0.shape[:-1], dtype=torch.bool, device=x0.device)
    out = []
    for step in range(horizon):
        nz = model.step_latent(z)
        x_pred = model.decode(nz)
        finite = torch.isfinite(x_pred).all(dim=-1) & alive
        out.append(torch.where(finite[..., None], x_pred,
                               torch.full_like(x_pred, float("nan"))))
        if reencode_period > 0 and (step + 1) % reencode_period == 0:
            nz = model.encode(x_pred)
        z = torch.where(finite[..., None], nz, z)
        alive = finite
    return torch.stack(out)


@torch.no_grad()
def predict_returns(
    model: KoopmanModel,
    obs: torch.Tensor,
    horizon: int,
    n_assets: int,
    mean: torch.Tensor,
    std: torch.Tensor,
) -> torch.Tensor:
    """Koopman H-step forecast of raw-scale log-returns: encode, then H
    times (step_latent, decode, first n_assets block, destandardize).
    obs [..., obs_size] -> [..., horizon, n_assets]."""
    z = model.encode(obs)
    rets = []
    for _ in range(horizon):
        z = model.step_latent(z)
        pred_obs = model.decode(z)
        rets.append(pred_obs[..., :n_assets] * std + mean)
    return torch.stack(rets, dim=-2)
