"""Koopman autoencoders GenericKM / SparseKM and LISTAKM as an ``nn.Module``.

Port of kmpc_tpu/models/koopman.py without its continuous-time ODE path.
GenericKM: an MLP encoder, an MLP decoder and a learnable Koopman matrix K
applied as ``z @ K`` (identity at init), with the latent normalization
``id`` or ``ball``. LISTAKM: a LISTA sparse encoder, a dictionary decoder
(``dict`` [z, x], its rows normalised) and K without normalization.
Parameter names follow the original PyTorch KoopmanMachine state dict
(``encoder.network.*``, ``decoder.network.*``, ``dict``, ``lista.*``,
``kmat``). The losses and rollouts are the training objectives; the
Koopman spectrum is computed on the host (:func:`spectral_metrics`).
"""

from __future__ import annotations

from typing import Dict, Tuple, Union

import numpy as np
import torch
from torch import nn

from kmpc_tpu_torch.config import Config
from kmpc_tpu_torch.models.lista import LISTA
from kmpc_tpu_torch.models.mlp import MLP

MODEL_NAMES = ("GenericKM", "SparseKM", "LISTAKM")


def _safe_norm(v: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """L2 norm with a zero subgradient at v = 0. With sparse LISTA codes a
    residual row that is exactly zero is routine (a sample whose codes are
    all soft-thresholded on both sides), and the plain norm's v / ||v||
    there would make every gradient of the batch NaN."""
    sq = torch.sum(v * v, dim=dim)
    is_zero = sq == 0.0
    return torch.where(is_zero, torch.zeros_like(sq),
                       torch.sqrt(torch.where(is_zero, torch.ones_like(sq), sq)))


def _l1(z: torch.Tensor) -> torch.Tensor:
    """Mean over samples of the latent L1 norm."""
    return torch.mean(torch.sum(torch.abs(z), dim=-1))


class KoopmanModel(nn.Module):
    def __init__(
        self,
        observation_size: int,
        target_size: int,
        model_name: str = "GenericKM",
        norm_fn: str = "id",
        encoder_layers=(16, 16),
        encoder_activation: str = "relu",
        encoder_use_bias: bool = False,
        encoder_last_relu: bool = False,
        decoder_layers=(),
        decoder_activation: str = "relu",
        decoder_use_bias: bool = False,
        lista_num_loops: int = 10,
        lista_alpha: float = 0.1,
        lista_L: float = 1e3,
        lista_linear_encoder: bool = False,
        res_coeff: float = 1.0,
        reconst_coeff: float = 0.02,
        pred_coeff: float = 0.0,
        sparsity_coeff: float = 1e-3,
        rollout_impl: str = "scan",
    ):
        super().__init__()
        if model_name not in MODEL_NAMES:
            raise ValueError(f"Unknown model '{model_name}'. Available: "
                             f"{list(MODEL_NAMES)}")
        if norm_fn not in ("id", "ball"):
            raise ValueError(f"Unknown norm function '{norm_fn}'")
        if rollout_impl not in ("scan", "kpower"):
            raise ValueError(f"Unknown rollout '{rollout_impl}' (scan|kpower)")
        self.model_name = model_name
        self.observation_size = observation_size
        self.target_size = target_size
        self.norm_fn = norm_fn
        self.lista_alpha = lista_alpha
        self.res_coeff, self.reconst_coeff = res_coeff, reconst_coeff
        self.pred_coeff, self.sparsity_coeff = pred_coeff, sparsity_coeff
        self.rollout_impl = rollout_impl
        if model_name == "LISTAKM":
            self.dict = nn.Parameter(torch.zeros(target_size, observation_size))
            self.lista = LISTA(observation_size, target_size, lista_num_loops,
                               lista_alpha, lista_L, lista_linear_encoder,
                               encoder_layers, encoder_use_bias,
                               encoder_activation, encoder_last_relu)
        else:
            self.encoder = MLP(observation_size, target_size, encoder_layers,
                               encoder_use_bias, encoder_activation,
                               encoder_last_relu)
            self.decoder = MLP(target_size, observation_size, decoder_layers,
                               decoder_use_bias, decoder_activation, False)
        self.kmat = nn.Parameter(torch.eye(target_size))

    @property
    def is_lista(self) -> bool:
        return self.model_name == "LISTAKM"

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> "KoopmanModel":
        """Fresh weights from ``generator``: the MLPs uniform in
        +-1/sqrt(fan_in); LISTAKM's dictionary 0.01 randn and LISTA's
        initialisation from it; K the identity."""
        if self.is_lista:
            wd = 0.01 * torch.randn(self.observation_size, self.target_size,
                                    generator=generator,
                                    device=generator.device)
            self.dict.copy_(wd.T)
            self.lista.init_params(self.dict, generator)
        else:
            self.encoder.init_params(generator)
            self.decoder.init_params(generator)
        self.kmat.copy_(torch.eye(self.target_size))
        return self

    # ------------------------------------------------------------- core ops

    def _apply_norm(self, z: torch.Tensor) -> torch.Tensor:
        if self.norm_fn == "id":
            return z
        return z / torch.linalg.vector_norm(z, dim=-1, keepdim=True)

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """[..., obs] -> [..., z]."""
        if self.is_lista:
            return self.lista(x)
        return self._apply_norm(self.encoder(x))

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """[..., z] -> [..., obs]; LISTAKM through the dictionary's rows
        normalised, their norms clamped at 1e-4."""
        if self.is_lista:
            norms = torch.clamp(
                torch.linalg.vector_norm(self.dict, dim=1, keepdim=True),
                min=1e-4)
            return z @ (self.dict / norms)
        return self.decoder(z)

    def step_latent(self, z: torch.Tensor) -> torch.Tensor:
        """z @ K, then the latent normalization (none for LISTAKM)."""
        if self.is_lista:
            return z @ self.kmat
        return self._apply_norm(z @ self.kmat)

    def step_env(self, x: torch.Tensor) -> torch.Tensor:
        return self.decode(self.step_latent(self.encode(x)))

    # ----------------------------------------------------- losses & metrics

    def residual(self, x: torch.Tensor, nx: torch.Tensor) -> torch.Tensor:
        """||enc(x) K - enc(nx)|| per sample (the raw K product)."""
        return _safe_norm(self.encode(x) @ self.kmat - self.encode(nx))

    def reconstruction(self, x: torch.Tensor) -> torch.Tensor:
        return self.decode(self.encode(x))

    def sparsity_loss(self, x: torch.Tensor) -> torch.Tensor:
        """Mean L1 of the latents; LISTAKM's scaled by alpha."""
        l1 = _l1(self.encode(x))
        return self.lista_alpha * l1 if self.is_lista else l1

    def _total(self, residual, reconst, prediction, sparsity, zx):
        num_nonzero = torch.mean(torch.sum((zx != 0).float(), dim=-1))
        total = (self.res_coeff * residual + self.reconst_coeff * reconst
                 + self.pred_coeff * prediction
                 + self.sparsity_coeff * sparsity)
        return total, {
            "loss": total,
            "residual_loss": residual,
            "reconst_loss": reconst,
            "prediction_loss": prediction,
            "sparsity_loss": sparsity,
            "sparsity_ratio": 1.0 - num_nonzero / self.target_size,
        }

    def loss(self, x: torch.Tensor, nx: torch.Tensor
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Single-step loss and its metrics (x, nx: [B, obs])."""
        zx, znx = self.encode(x), self.encode(nx)
        kzx = zx @ self.kmat
        prediction = torch.mean(_safe_norm(self.decode(kzx) - nx))
        residual = torch.mean(_safe_norm(kzx - znx))
        reconst = (torch.mean(_safe_norm(x - self.decode(zx)))
                   + torch.mean(_safe_norm(nx - self.decode(znx))))
        alpha = self.lista_alpha if self.is_lista else 1.0
        sparsity = 0.5 * alpha * (_l1(zx) + _l1(znx))
        return self._total(residual, reconst, prediction, sparsity, zx)

    def rollout_latent_discrete(self, z0: torch.Tensor, num_steps: int
                                ) -> torch.Tensor:
        """z_{t+k} = z_t K^k (the raw K product); [B, num_steps+1, z]
        including z0. ``rollout_impl="kpower"`` forms K^1..K^T first and
        applies them in one batched product."""
        if self.rollout_impl == "kpower":
            return self.rollout_latent_discrete_kpower(z0, num_steps)
        traj = [z0]
        for _ in range(num_steps):
            traj.append(traj[-1] @ self.kmat)
        return torch.stack(traj, dim=1)

    def rollout_latent_discrete_kpower(self, z0: torch.Tensor,
                                       num_steps: int) -> torch.Tensor:
        if num_steps < 1:
            return z0[:, None, :]
        powers = [self.kmat]
        for _ in range(num_steps - 1):
            powers.append(powers[-1] @ self.kmat)
        traj = torch.einsum("bz,tzk->btk", z0, torch.stack(powers))
        return torch.cat([z0[:, None, :], traj], dim=1)

    def rollout_sequence(self, x0: torch.Tensor, num_steps: int
                         ) -> torch.Tensor:
        """Observation-space rollout [B, num_steps+1, obs]."""
        z0 = self.encode(x0)
        return self.decode(self.rollout_latent_discrete(z0, num_steps))

    def loss_sequence(self, x_seq: torch.Tensor, dt: float = 1.0
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Sequence loss with the discrete Koopman rollout; x_seq
        [B, T+1, obs] holds x_t..x_{t+T}. Alignment (named
        ``residual_loss``) sum_t ||zhat_t - z_t||^2 for t = 1..T,
        reconstruction sum_t ||x_t - dec(z_t)||^2 for t = 0..T, prediction
        sum_t ||x_t - dec(zhat_t)||^2 for t = 1..T, sparsity mean ||z||_1."""
        z_seq = self.encode(x_seq)
        z_hat = self.rollout_latent_discrete(z_seq[:, 0, :],
                                             x_seq.shape[1] - 1)
        x_tilde = self.decode(z_seq)
        x_hat = self.decode(z_hat)

        def sq_sum(d):
            return torch.mean(torch.sum(torch.sum(d ** 2, dim=-1), dim=1))

        alignment = sq_sum(z_hat[:, 1:, :] - z_seq[:, 1:, :])
        reconst = sq_sum(x_seq - x_tilde)
        prediction = sq_sum(x_seq[:, 1:, :] - x_hat[:, 1:, :])
        return self._total(alignment, reconst, prediction, _l1(z_seq), z_seq)


def spectral_metrics(kmat: torch.Tensor) -> Dict[str, float]:
    """Largest real part and largest modulus of K's spectrum, computed on
    the host in numpy; NaN for a K that is not finite."""
    k = kmat.detach().cpu().numpy()
    if not np.all(np.isfinite(k)):
        return {"A_max_eigenvalue_real": float("nan"),
                "A_max_eigenvalue": float("nan")}
    eig = np.linalg.eigvals(k)
    return {"A_max_eigenvalue_real": float(np.max(eig.real)),
            "A_max_eigenvalue": float(np.max(np.abs(eig)))}


def make_model(cfg: Config, observation_size: int,
               device: Union[str, torch.device] = "cuda") -> KoopmanModel:
    """Build the KoopmanModel that ``cfg.MODEL`` describes (float32), on
    ``device``."""
    if cfg.TRAIN.DTYPE != "float32":
        raise NotImplementedError(
            f"TRAIN.DTYPE={cfg.TRAIN.DTYPE!r}: kmpc_tpu_torch computes the "
            "model in float32 only (bfloat16 through autocast is queued in "
            "ROADMAP.md)"
        )
    m = cfg.MODEL
    lista = m.ENCODER.LISTA
    return KoopmanModel(
        observation_size=observation_size,
        target_size=m.TARGET_SIZE,
        model_name=m.MODEL_NAME,
        norm_fn=m.NORM_FN,
        encoder_layers=tuple(m.ENCODER.LAYERS),
        encoder_activation=m.ENCODER.ACTIVATION,
        encoder_use_bias=m.ENCODER.USE_BIAS,
        encoder_last_relu=m.ENCODER.LAST_RELU,
        decoder_layers=tuple(m.DECODER.LAYERS),
        decoder_activation=m.DECODER.ACTIVATION,
        decoder_use_bias=m.DECODER.USE_BIAS,
        lista_num_loops=lista.NUM_LOOPS,
        lista_alpha=lista.ALPHA,
        lista_L=lista.L,
        lista_linear_encoder=lista.LINEAR_ENCODER,
        res_coeff=m.RES_COEFF,
        reconst_coeff=m.RECONST_COEFF,
        pred_coeff=m.PRED_COEFF,
        sparsity_coeff=m.SPARSITY_COEFF,
        rollout_impl=cfg.TRAIN.ROLLOUT,
    ).to(device)
