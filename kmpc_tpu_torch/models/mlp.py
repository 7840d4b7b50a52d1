"""MLP encoder/decoder as an ``nn.Module`` (port of kmpc_tpu/models/mlp.py).

The layers sit in ``self.network``, an ``nn.Sequential`` with the
activations interleaved, so the Linear layers' state-dict keys are
``network.0``, ``network.2``, ... as in the original PyTorch MLPCoder.

``forward(x, compute_dtype)`` with ``torch.bfloat16`` is kmpc_tpu's mixed
precision: each Linear takes bfloat16 inputs and weights, accumulates its
products in float32 (:func:`matmul_f32`), adds the float32 bias and casts
the sum to bfloat16; the activations run in bfloat16. The parameters stay
float32.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [..., k] @ b [k, n] for bfloat16 operands, the products
    accumulated and returned in float32, as kmpc_tpu's matmuls with
    ``preferred_element_type=float32``: one float32 product of the operands
    cast up, which is that sum, since a product of two bfloat16 numbers is
    exact in float32. On the H100 it is faster, at ``finance_sparse``'s
    shapes, than one bfloat16 GEMM with a float32 output
    (``chip_smoke.py``'s ``_bf16_routes``, ``PERF.md`` section 5)."""
    return torch.matmul(a.float(), b.float())


def linear(x: torch.Tensor, layer: nn.Linear,
           compute_dtype: Optional[torch.dtype]) -> torch.Tensor:
    """``layer(x)``; with a ``compute_dtype`` its product by
    :func:`matmul_f32` in that dtype, the bias added in float32 and the sum
    cast to ``compute_dtype``."""
    if compute_dtype is None:
        return layer(x)
    y = matmul_f32(x.to(compute_dtype), layer.weight.to(compute_dtype).T)
    if layer.bias is not None:
        y = y + layer.bias
    return y.to(compute_dtype)


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

    def forward(self, x: torch.Tensor,
                compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        if compute_dtype is None:
            return self.network(x)
        for m in self.network:
            x = (linear(x, m, compute_dtype) if isinstance(m, nn.Linear)
                 else m(x))
        return x
