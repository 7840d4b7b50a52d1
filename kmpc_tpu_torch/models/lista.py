"""LISTA sparse encoder as an ``nn.Module`` (port of kmpc_tpu/models/lista.py).

Unrolled iterative soft-thresholding (Gregor & LeCun 2010):

    c      = W_e x
    z^(0)  = T_{alpha/L}(c)
    z^(k+1)= T_{alpha/L}(z^(k) S + c)

with W_e initialised to (1/L) W_d^T and S to I - (1/L) W_d^T W_d. The
encoder W_e is either linear (``We``, an ``nn.Linear`` whose weight is
stored [z, x]) or an MLP (``We.network.*``), so the state dict's keys are
the original PyTorch LISTA module's: ``S``, ``We.weight`` or
``We.network.{2 i}.weight``. With a ``compute_dtype`` (bfloat16) the
refinements run in it: each product z S accumulates in float32, the sum
with c casts back (kmpc_tpu's semantics).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from kmpc_tpu_torch.models.mlp import MLP, matmul_f32


def shrink(x: torch.Tensor, threshold: float) -> torch.Tensor:
    """Soft-thresholding T_t(x) = sign(x) max(|x| - t, 0). ``maximum``
    splits the gradient of a tie in halves, as ``jnp.maximum`` does."""
    return torch.sign(x) * torch.maximum(torch.abs(x) - threshold,
                                         x.new_zeros(()))


class LISTA(nn.Module):
    """[..., xdim] -> sparse codes [..., zdim] in ``num_loops`` refinements."""

    def __init__(
        self,
        xdim: int,
        zdim: int,
        num_loops: int,
        alpha: float,
        L: float,
        linear_encoder: bool,
        encoder_layers: Sequence[int] = (),
        encoder_use_bias: bool = False,
        activation: str = "relu",
        last_relu: bool = False,
    ):
        super().__init__()
        self.num_loops, self.alpha, self.L = num_loops, alpha, L
        self.linear_encoder = linear_encoder
        if linear_encoder:
            self.We = nn.Linear(xdim, zdim, bias=False)
        else:
            self.We = MLP(xdim, zdim, encoder_layers, encoder_use_bias,
                          activation, last_relu)
        self.S = nn.Parameter(torch.eye(zdim))

    @torch.no_grad()
    def init_params(self, dictionary: torch.Tensor,
                    generator: torch.Generator) -> None:
        """The LISTA initialisation from the dictionary ``dictionary``
        [z, x] (the decoder's atoms as rows): W_e = (1/L) dictionary
        (linear encoder) or an MLP drawn from ``generator``, and
        S = I - (1/L) dictionary dictionary^T."""
        zdim = dictionary.shape[0]
        if self.linear_encoder:
            self.We.weight.copy_(dictionary / self.L)
        else:
            self.We.init_params(generator)
        eye = torch.eye(zdim, device=dictionary.device)
        self.S.copy_(eye - (1.0 / self.L) * (dictionary @ dictionary.T))

    def forward(self, x: torch.Tensor,
                compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        threshold = self.alpha / self.L
        if compute_dtype is None:
            c = self.We(x)
            z = shrink(c, threshold)
            for _ in range(self.num_loops):
                z = shrink(z @ self.S + c, threshold)
            return z
        cd = compute_dtype
        if self.linear_encoder:
            c = matmul_f32(x.to(cd), self.We.weight.to(cd).T)
        else:
            c = self.We(x, cd)
        c = c.to(cd)
        S = self.S.to(cd)
        z = shrink(c, threshold)
        for _ in range(self.num_loops):
            z = shrink((matmul_f32(z, S) + c).to(cd), threshold)
        return z
