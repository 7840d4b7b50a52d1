"""kmpc_tpu_torch: the Koopman-MPC portfolio-rebalancing system in PyTorch,
with its hot kernel written in CUDA for NVIDIA Hopper (H100).

A port of the JAX package ``kmpc_tpu``; nothing here imports it or JAX.
Entry points run on a CUDA device unless the caller asks for the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

__version__ = "0.1.0"


def stream_seed(*words: int) -> int:
    """A ``torch.Generator`` seed from integers (``SEED``, a stream, a
    step): the random streams of training and evaluation."""
    return int(np.random.SeedSequence(list(words)).generate_state(1, np.uint64)[0]
               >> np.uint64(1))


def default_device() -> torch.device:
    """The first CUDA device; raises when CUDA is missing (the CPU is used
    only when a caller names it)."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "kmpc_tpu_torch runs on a CUDA device and none is available; "
            "pass device='cpu' explicitly to run the plain-PyTorch path"
        )
    return torch.device("cuda")
