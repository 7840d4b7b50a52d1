"""Train-state checkpoints in kmpc_tpu's directory layout (port of the npz
backend of kmpc_tpu/utils/checkpoint.py):

    <dir>/arrays.npz   every array of the train state, keyed by its
                       kmpc_tpu tree path (``utils/params.py``)
    <dir>/meta.json    step, config, extra metadata

so kmpc_tpu's ``load_checkpoint`` resumes a run this package trained, and
this package resumes one kmpc_tpu trained. ``state`` is any object with
``model``, ``optimizer`` (AdamW with the groups ``other`` and ``kmat``)
and ``step``.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np

from kmpc_tpu_torch.utils.params import train_state_from_jax, train_state_to_jax


def save_checkpoint(
    directory,
    state: Any,
    step: int,
    config_dict: Optional[dict] = None,
    extra: Optional[dict] = None,
) -> Path:
    """Save ``state`` plus metadata under ``directory``; returns it."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    flat = train_state_to_jax(state.model, state.optimizer, state.step)
    np.savez(directory / "arrays.npz", **flat)
    meta = {
        "step": int(step),
        "config": config_dict,
        "extra": extra or {},
        "treedef": f"kmpc_tpu train state of {state.model.model_name}, "
                   f"{len(flat)} leaves",
    }
    with open(directory / "meta.json", "w") as f:
        json.dump(meta, f, indent=2, default=str)
    return directory


def load_checkpoint(directory, like: Any) -> Tuple[Any, Dict]:
    """Load the checkpoint under ``directory`` into the state ``like`` (in
    place: its model's parameters, its AdamW's moments and counts, its
    step); returns (state, meta)."""
    directory = Path(directory)
    with np.load(directory / "arrays.npz") as npz:
        flat = {k: npz[k] for k in npz.files}
    with open(directory / "meta.json") as f:
        meta = json.load(f)
    like.step = train_state_from_jax(flat, like.model, like.optimizer)
    return like, meta
