"""Koopman autoencoder GenericKM / SparseKM as an ``nn.Module``.

Port of the GenericKM path of kmpc_tpu/models/koopman.py: an MLP encoder,
an MLP decoder and a learnable Koopman matrix K applied as ``z @ K``
(identity at init), with the latent normalization ``id`` or ``ball``.
Parameter names follow the original PyTorch KoopmanMachine state dict
(``encoder.network.*``, ``decoder.network.*``, ``kmat``).
"""

from __future__ import annotations

from typing import Union

import torch
from torch import nn

from kmpc_tpu_torch.config import Config
from kmpc_tpu_torch.models.mlp import MLP

MODEL_NAMES = ("GenericKM", "SparseKM")


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
    ):
        super().__init__()
        if model_name not in MODEL_NAMES:
            raise ValueError(
                f"kmpc_tpu_torch ports {MODEL_NAMES}, not '{model_name}'"
            )
        if norm_fn not in ("id", "ball"):
            raise ValueError(f"Unknown norm function '{norm_fn}'")
        self.model_name = model_name
        self.observation_size = observation_size
        self.target_size = target_size
        self.norm_fn = norm_fn
        self.encoder = MLP(observation_size, target_size, encoder_layers,
                           encoder_use_bias, encoder_activation,
                           encoder_last_relu)
        self.decoder = MLP(target_size, observation_size, decoder_layers,
                           decoder_use_bias, decoder_activation, False)
        self.kmat = nn.Parameter(torch.eye(target_size))

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> "KoopmanModel":
        """Fresh weights from ``generator``: the MLPs uniform in
        +-1/sqrt(fan_in), K the identity."""
        self.encoder.init_params(generator)
        self.decoder.init_params(generator)
        self.kmat.copy_(torch.eye(self.target_size))
        return self

    def _apply_norm(self, z: torch.Tensor) -> torch.Tensor:
        if self.norm_fn == "id":
            return z
        return z / torch.linalg.vector_norm(z, dim=-1, keepdim=True)

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """[..., obs] -> [..., z]."""
        return self._apply_norm(self.encoder(x))

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """[..., z] -> [..., obs]."""
        return self.decoder(z)

    def step_latent(self, z: torch.Tensor) -> torch.Tensor:
        """z @ K, then the latent normalization."""
        return self._apply_norm(z @ self.kmat)

    def step_env(self, x: torch.Tensor) -> torch.Tensor:
        return self.decode(self.step_latent(self.encode(x)))


def make_model(cfg: Config, observation_size: int,
               device: Union[str, torch.device] = "cuda") -> KoopmanModel:
    """Build the KoopmanModel that ``cfg.MODEL`` describes (float32), on
    ``device``."""
    if cfg.TRAIN.DTYPE != "float32":
        raise NotImplementedError(
            f"TRAIN.DTYPE={cfg.TRAIN.DTYPE!r}: kmpc_tpu_torch computes the "
            "model in float32 only"
        )
    m = cfg.MODEL
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
    ).to(device)
