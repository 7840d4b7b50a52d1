"""Carry kmpc_tpu (JAX) Koopman weights into kmpc_tpu_torch, with numpy only.

kmpc_tpu keeps GenericKM parameters as a tree
``{'encoder': [{'w': [in, out], 'b': [out]}, ...], 'decoder': [...],
'kmat': [z, z]}`` and checkpoints a run as ``<run>/config.json`` plus
``<run>/checkpoint/arrays.npz`` (or ``<run>/last/arrays.npz``) whose keys
are tree paths joined by ``//``, e.g. ``params//encoder//[0]//w``. A torch
``Linear`` weight is ``w.T``; K keeps its ``z @ K`` orientation.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Dict, Tuple, Union

import numpy as np
import torch

from kmpc_tpu_torch.config import Config
from kmpc_tpu_torch.models.koopman import KoopmanModel, make_model

_SEP = "//"


def params_from_jax(tree: Dict) -> Dict[str, torch.Tensor]:
    """A KoopmanModel state dict from a kmpc_tpu GenericKM parameter tree
    of numpy arrays. Linear layer i of an MLP sits at ``network.{2 i}``
    (activations interleave)."""
    state = {}
    for part in ("encoder", "decoder"):
        for i, layer in enumerate(tree[part]):
            state[f"{part}.network.{2 * i}.weight"] = torch.tensor(
                np.asarray(layer["w"], np.float32).T)
            if "b" in layer:
                state[f"{part}.network.{2 * i}.bias"] = torch.tensor(
                    np.asarray(layer["b"], np.float32))
    state["kmat"] = torch.tensor(np.asarray(tree["kmat"], np.float32))
    return state


def _unflatten_params(flat: Dict[str, np.ndarray]) -> Dict:
    """The ``params`` subtree of a flattened kmpc_tpu train state."""
    tree: Dict = {"encoder": {}, "decoder": {}}
    for key, arr in flat.items():
        parts = key.split(_SEP)
        if parts[0] != "params":
            continue
        if parts[1:] == ["kmat"]:
            tree["kmat"] = arr
            continue
        m = re.fullmatch(r"\[(\d+)\]", parts[2]) if len(parts) == 4 else None
        if parts[1] not in ("encoder", "decoder") or m is None:
            raise KeyError(f"unexpected GenericKM parameter '{key}'")
        tree[parts[1]].setdefault(int(m.group(1)), {})[parts[3]] = arr
    for part in ("encoder", "decoder"):
        tree[part] = [tree[part][i] for i in sorted(tree[part])]
    return tree


def load_jax_checkpoint(
    run_dir: Union[str, Path], device: Union[str, torch.device] = "cuda"
) -> Tuple[Config, KoopmanModel, int]:
    """(config, model with the run's weights on ``device``, step) from a
    kmpc_tpu run directory: its best checkpoint, else its last."""
    run_dir = Path(run_dir)
    ckpt = run_dir / "checkpoint"
    if not (ckpt / "arrays.npz").exists():
        ckpt = run_dir / "last"
    if not (ckpt / "arrays.npz").exists():
        raise FileNotFoundError(f"no checkpoint/arrays.npz or last/arrays.npz under {run_dir}")
    cfg = Config.from_json(str(run_dir / "config.json"))
    with np.load(ckpt / "arrays.npz") as npz:
        flat = {k: npz[k] for k in npz.files}
    tree = _unflatten_params(flat)
    obs = int(np.asarray(tree["encoder"][0]["w"]).shape[0])
    model = make_model(cfg, obs, device=device)
    model.load_state_dict(params_from_jax(tree))
    step = int(np.asarray(flat["step"])) if "step" in flat else -1
    return cfg, model.eval(), step
