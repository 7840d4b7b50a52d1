"""Carry kmpc_tpu (JAX) Koopman weights and AdamW state into kmpc_tpu_torch
and back, with numpy only.

kmpc_tpu keeps a model's parameters as a tree: GenericKM
``{'encoder': [{'w': [in, out], 'b': [out]}, ...], 'decoder': [...],
'kmat': [z, z]}``, LISTAKM ``{'dict': [z, x], 'lista': {'S': [z, z],
'We': [x, z]} or {'S', 'We_mlp': [...]}, 'kmat'}``. A run checkpoints its
train state as ``<run>/config.json`` plus ``<run>/checkpoint/arrays.npz``
(or ``<run>/last/arrays.npz``) whose keys are tree paths joined by ``//``:
``params//encoder//[0]//w``, ``params//lista//S``, the optax
``multi_transform`` AdamW state
``opt_state//inner_states//{other,kmat}//inner_state//[0]//{count,mu//...,nu//...}``
and ``step``. A torch ``Linear`` weight is ``w.T``; K, S and the dictionary
keep their orientation.
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
_MLP = re.compile(r"(encoder|decoder|lista\.We)\.network\.(\d+)\.(weight|bias)")
_JAX_MLP = re.compile(r"(encoder|decoder|lista//We_mlp)//\[(\d+)\]//(w|b)")
_PLAIN = {"kmat": "kmat", "dict": "dict", "lista.S": "lista//S"}


def jax_path(name: str) -> Tuple[str, bool]:
    """(path under kmpc_tpu's ``params`` tree, whether the array is the
    transpose) of the torch parameter ``name``. Linear layer i of an MLP
    sits at ``network.{2 i}`` (activations interleave)."""
    if name in _PLAIN:
        return _PLAIN[name], False
    if name == "lista.We.weight":
        return "lista//We", True
    m = _MLP.fullmatch(name)
    if m is None or int(m.group(2)) % 2:
        raise KeyError(f"no kmpc_tpu parameter for '{name}'")
    part = "lista//We_mlp" if m.group(1) == "lista.We" else m.group(1)
    leaf = "w" if m.group(3) == "weight" else "b"
    return f"{part}//[{int(m.group(2)) // 2}]//{leaf}", leaf == "w"


def torch_name(path: str) -> Tuple[str, bool]:
    """The inverse of :func:`jax_path`."""
    plain = {v: k for k, v in _PLAIN.items()}
    if path in plain:
        return plain[path], False
    if path == "lista//We":
        return "lista.We.weight", True
    m = _JAX_MLP.fullmatch(path)
    if m is None:
        raise KeyError(f"unexpected Koopman parameter '{path}'")
    part = "lista.We" if m.group(1) == "lista//We_mlp" else m.group(1)
    leaf = "weight" if m.group(3) == "w" else "bias"
    return f"{part}.network.{2 * int(m.group(2))}.{leaf}", leaf == "weight"


def _flatten(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    """A nested dict / list tree as {``//``-joined path: array}, list
    items as ``[i]``, the tokens of ``jax.tree_util``'s paths."""
    if isinstance(tree, dict):
        items = ((str(k), v) for k, v in tree.items())
    elif isinstance(tree, (list, tuple)):
        items = ((f"[{i}]", v) for i, v in enumerate(tree))
    else:
        return {prefix: np.asarray(tree)}
    flat = {}
    for token, sub in items:
        flat.update(_flatten(sub, f"{prefix}{_SEP}{token}" if prefix else token))
    return flat


def _unflatten_params(flat: Dict[str, np.ndarray]) -> Dict:
    """The ``params`` subtree of a flattened kmpc_tpu train state, lists
    where a level's tokens are ``[i]``."""
    tree: Dict = {}
    for key, arr in flat.items():
        parts = key.split(_SEP)
        if parts[0] != "params":
            continue
        torch_name(_SEP.join(parts[1:]))  # a Koopman parameter, or raise
        node = tree
        for token in parts[1:-1]:
            node = node.setdefault(token, {})
        node[parts[-1]] = arr

    def lists(node):
        if not isinstance(node, dict):
            return node
        if node and all(re.fullmatch(r"\[\d+\]", k) for k in node):
            return [lists(node[f"[{i}]"]) for i in range(len(node))]
        return {k: lists(v) for k, v in node.items()}

    return lists(tree)


def params_from_jax(tree: Dict) -> Dict[str, torch.Tensor]:
    """A KoopmanModel state dict from a kmpc_tpu parameter tree (GenericKM
    or LISTAKM) of numpy arrays. The same call carries a stacked tree
    (``kmpc_tpu.train.sweep.stack_states``' ``params``, each leaf with a
    leading sweep axis) into the port's stacked parameters: only the last
    two axes are transposed. kmpc_tpu's bfloat16 model keeps float32
    parameters, so its tree carries the same way."""
    state = {}
    for path, arr in _flatten(tree).items():
        name, transpose = torch_name(path)
        a = np.asarray(arr, np.float32)
        state[name] = torch.tensor(np.swapaxes(a, -1, -2) if transpose else a)
    return state


def params_from_checkpoint(ckpt_dir: Union[str, Path]
                           ) -> Tuple[Dict[str, torch.Tensor], int]:
    """(state dict, step) of the weights in one checkpoint directory
    (``<run>/checkpoint`` or ``<run>/last``) of either package."""
    with np.load(Path(ckpt_dir) / "arrays.npz") as npz:
        flat = {k: npz[k] for k in npz.files}
    step = int(np.asarray(flat["step"])) if "step" in flat else -1
    return params_from_jax(_unflatten_params(flat)), step


def params_to_jax(model: KoopmanModel) -> Dict[str, np.ndarray]:
    """{path under ``params``: float32 array} of a model's parameters."""
    out = {}
    for name, p in model.named_parameters():
        path, transpose = jax_path(name)
        a = p.detach().cpu().numpy()
        out[path] = np.ascontiguousarray(a.T if transpose else a)
    return out


def _group_prefix(group: Dict) -> str:
    return f"opt_state{_SEP}inner_states{_SEP}{group['name']}{_SEP}inner_state{_SEP}[0]"


def train_state_to_jax(model: KoopmanModel, optimizer: torch.optim.Optimizer,
                       step: int) -> Dict[str, np.ndarray]:
    """A train state (model, its AdamW with the groups ``other`` and
    ``kmat``, the step) flattened under kmpc_tpu's keys: AdamW's
    ``exp_avg``, ``exp_avg_sq`` and ``step`` of each group become optax's
    ``mu``, ``nu`` and ``count``."""
    flat = {f"params{_SEP}{k}": v for k, v in params_to_jax(model).items()}
    names = {p: n for n, p in model.named_parameters()}
    for group in optimizer.param_groups:
        prefix = _group_prefix(group)
        count = 0
        for p in group["params"]:
            path, transpose = jax_path(names[p])
            st = optimizer.state.get(p, {})
            for moment, key in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
                a = (st[key].detach().cpu().numpy() if key in st
                     else np.zeros(tuple(p.shape), np.float32))
                flat[f"{prefix}{_SEP}{moment}{_SEP}{path}"] = \
                    np.ascontiguousarray(a.T if transpose else a)
            if "step" in st:
                count = int(st["step"])
        flat[f"{prefix}{_SEP}count"] = np.asarray(count, np.int32)
    flat["step"] = np.asarray(step, np.int32)
    return flat


def _checked(flat: Dict[str, np.ndarray], key: str, shape) -> np.ndarray:
    if key not in flat:
        raise KeyError(f"Checkpoint missing leaf '{key}'")
    a = flat[key]
    if tuple(a.shape) != tuple(shape):
        raise ValueError(f"Shape mismatch for '{key}': checkpoint {a.shape} "
                         f"vs model {tuple(shape)}")
    return a


def train_state_from_jax(flat: Dict[str, np.ndarray], model: KoopmanModel,
                         optimizer: torch.optim.Optimizer) -> int:
    """Load a flattened kmpc_tpu train state into ``model`` and its AdamW
    (in place; the inverse of :func:`train_state_to_jax`); returns the
    step. Every leaf the model and optimizer need must be present with its
    shape."""
    names = {p: n for n, p in model.named_parameters()}
    with torch.no_grad():
        for group in optimizer.param_groups:
            prefix = _group_prefix(group)
            count = int(_checked(flat, f"{prefix}{_SEP}count", ()))
            for p in group["params"]:
                path, transpose = jax_path(names[p])
                shape = tuple(p.shape)[::-1] if transpose else tuple(p.shape)

                def get(key):
                    a = np.asarray(_checked(flat, key, shape), np.float32)
                    return torch.tensor(a.T if transpose else a,
                                        device=p.device)

                p.copy_(get(f"params{_SEP}{path}"))
                optimizer.state[p] = {
                    "step": torch.tensor(float(count)),
                    "exp_avg": get(f"{prefix}{_SEP}mu{_SEP}{path}"),
                    "exp_avg_sq": get(f"{prefix}{_SEP}nu{_SEP}{path}"),
                }
    return int(_checked(flat, "step", ()))


def load_jax_checkpoint(
    run_dir: Union[str, Path], device: Union[str, torch.device] = "cuda"
) -> Tuple[Config, KoopmanModel, int]:
    """(config, model with the run's weights on ``device``, step) from a
    kmpc_tpu or kmpc_tpu_torch run directory: its best checkpoint, else
    its last."""
    run_dir = Path(run_dir)
    ckpt = run_dir / "checkpoint"
    if not (ckpt / "arrays.npz").exists():
        ckpt = run_dir / "last"
    if not (ckpt / "arrays.npz").exists():
        raise FileNotFoundError(f"no checkpoint/arrays.npz or last/arrays.npz under {run_dir}")
    cfg = Config.from_json(str(run_dir / "config.json"))
    weights, step = params_from_checkpoint(ckpt)
    first = weights["dict"] if "dict" in weights \
        else weights["encoder.network.0.weight"]
    model = make_model(cfg, int(first.shape[1]), device=device)
    model.load_state_dict(weights)
    return cfg, model.eval(), step
