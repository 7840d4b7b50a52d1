"""MLP encoder/decoder as an ``nn.Module`` (port of kmpc_tpu/models/mlp.py).

The layers sit in ``self.network``, an ``nn.Sequential`` with the
activations interleaved, so the Linear layers' state-dict keys are
``network.0``, ``network.2``, ... as in the original PyTorch MLPCoder.
Float32 only.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn


def get_activation(name: str) -> nn.Module:
    """Activation table: relu, tanh, gelu (tanh approximation, as
    jax.nn.gelu's default)."""
    activations = {
        "relu": lambda: nn.ReLU(),
        "tanh": lambda: nn.Tanh(),
        "gelu": lambda: nn.GELU(approximate="tanh"),
    }
    if name not in activations:
        raise ValueError(f"Unknown activation '{name}'. Available: {list(activations.keys())}")
    return activations[name]()


class MLP(nn.Module):
    """[..., input_size] -> [..., target_size]: Linear layers with the
    activation between them, and a final ReLU when ``last_relu``."""

    def __init__(
        self,
        input_size: int,
        target_size: int,
        hidden_layers: Sequence[int],
        use_bias: bool = False,
        activation: str = "relu",
        last_relu: bool = False,
    ):
        super().__init__()
        sizes = [input_size, *hidden_layers, target_size]
        mods = []
        for i in range(len(sizes) - 1):
            mods.append(nn.Linear(sizes[i], sizes[i + 1], bias=use_bias))
            if i < len(sizes) - 2:
                mods.append(get_activation(activation))
        if last_relu:
            mods.append(nn.ReLU())
        self.network = nn.Sequential(*mods)

    def linears(self):
        return [m for m in self.network if isinstance(m, nn.Linear)]

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> None:
        """uniform(-1/sqrt(fan_in), 1/sqrt(fan_in)) for weights and biases,
        the law of kmpc_tpu's ``_linear_init``."""
        for lin in self.linears():
            bound = 1.0 / max(lin.in_features, 1) ** 0.5
            for t in (lin.weight, lin.bias):
                if t is None:
                    continue
                u = torch.rand(t.shape, generator=generator,
                               device=generator.device, dtype=torch.float32)
                t.copy_(u * (2.0 * bound) - bound)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.network(x)
