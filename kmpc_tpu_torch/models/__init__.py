"""Koopman autoencoder models."""

from kmpc_tpu_torch.models.koopman import KoopmanModel, make_model
from kmpc_tpu_torch.models.mlp import MLP

__all__ = ["KoopmanModel", "MLP", "make_model"]
