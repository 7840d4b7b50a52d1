"""The reference's PyTorch checkpoints (``checkpoint.pt``) in the port
(port of kmpc_tpu/utils/torch_import.py).

The reference saves ``torch.save`` dicts with the keys ``step``, ``epoch``
(finance), ``model_state_dict``, ``optimizer_state_dict``, ``config``,
``metrics`` and ``finance_metadata``:

    from kmpc_tpu_torch.utils.torch_import import load_torch_checkpoint
    ckpt = load_torch_checkpoint("runs/.../checkpoint.pt", device="cuda")
    model = ckpt["model"]

The port's modules keep the reference's parameter names and layouts
(``encoder.network.{2 i}.weight`` [out, in], ``lista.S``,
``lista.We.weight`` [z, x] or ``lista.We.network.*``, ``dict`` [z, x],
``kmat``), so a state dict loads as it is: the map only drops the
reference's ``dict_init`` buffer (initialisation state, not a parameter)
and checks every name. The reference's AdamW state (per-parameter
``exp_avg``, ``exp_avg_sq`` and ``step``, keyed by a global index in group
order: the ``other`` parameters, then ``kmat``) maps by parameter name
onto the port's ``torch.optim.AdamW``, whose groups are the same.
"""

from __future__ import annotations

import json
import pickle
import warnings
from typing import Dict, Optional, Union

import torch

from kmpc_tpu_torch.config import Config
from kmpc_tpu_torch.models.koopman import KoopmanModel, make_model

Device = Union[str, torch.device]

# state-dict keys that are buffers of the reference's modules, not
# parameters (they appear in model_state_dict, never in its optimizer).
_BUFFER_KEYS = ("dict_init",)


def convert_state_dict(state_dict: Dict, model_name: str
                       ) -> Dict[str, torch.Tensor]:
    """A reference ``model_state_dict`` as the port's state dict for
    ``model_name`` (float32 CPU tensors): the parameters under their own
    names, the buffers dropped. Raises ``KeyError`` for a name the port's
    model has no parameter for."""
    if model_name not in ("GenericKM", "SparseKM", "LISTAKM"):
        raise ValueError(f"Unknown model '{model_name}'")
    lista = model_name == "LISTAKM"
    out = {}
    for name, value in state_dict.items():
        if name in _BUFFER_KEYS:
            continue
        top = name.split(".")[0]
        if name != "kmat" and top not in (
                ("dict", "lista") if lista else ("encoder", "decoder")):
            raise KeyError(f"no {model_name} parameter for '{name}'")
        out[name] = torch.as_tensor(value).detach().to("cpu", torch.float32)
    return out


def _optimizer_index_to_name(optimizer_state_dict: Dict,
                             model_state_dict: Dict) -> Dict:
    """The reference optimizer's parameter indices -> parameter names. Its
    ``build_optimizer`` makes the groups [other..., kmat...], each in
    ``named_parameters`` order, which is the state dict's key order less
    the buffers."""
    names = [k for k in model_state_dict if k not in _BUFFER_KEYS]
    other = [n for n in names if "kmat" not in n]
    kmat = [n for n in names if "kmat" in n]
    groups = optimizer_state_dict["param_groups"]
    if len(groups) == 2:
        ordered_groups = [other, kmat]
    elif len(groups) == 1:
        ordered_groups = [other + kmat]
    else:
        raise ValueError(
            f"expected 1 or 2 AdamW param groups (reference layout), got "
            f"{len(groups)}")
    mapping = {}
    for group, group_names in zip(groups, ordered_groups):
        idxs = list(group["params"])
        if len(idxs) != len(group_names):
            raise ValueError(
                f"optimizer group has {len(idxs)} params but the model "
                f"state dict implies {len(group_names)} "
                f"({group_names[:3]}...) — not a reference-layout checkpoint")
        mapping.update(zip(idxs, group_names))
    return mapping


def convert_optimizer_state(optimizer_state_dict: Dict,
                            model_state_dict: Dict, model: KoopmanModel,
                            optimizer: torch.optim.Optimizer) -> int:
    """Load the reference AdamW's moments into ``optimizer`` (the port's
    AdamW over ``model``) by parameter name, in place; returns the step
    count (the largest per-parameter ``step``, 0 where none was taken).
    A parameter without recorded state keeps none, which AdamW reads as
    zero moments, as torch populates the state at the first update."""
    mapping = _optimizer_index_to_name(optimizer_state_dict, model_state_dict)
    state = optimizer_state_dict.get("state", {})
    params = dict(model.named_parameters())
    steps = []
    for idx, name in mapping.items():
        s = state.get(idx, state.get(str(idx)))
        if s is None:
            continue
        p = params[name]
        step = int(torch.as_tensor(s["step"]).item())
        steps.append(step)
        optimizer.state[p] = {
            "step": torch.tensor(float(step)),
            "exp_avg": torch.as_tensor(s["exp_avg"]).to(p.device,
                                                        torch.float32).clone(),
            "exp_avg_sq": torch.as_tensor(s["exp_avg_sq"]).to(
                p.device, torch.float32).clone(),
        }
    return max(steps, default=0)


def _load(path: str, allow_pickle: bool) -> Dict:
    """``torch.load(weights_only=True)``; a full unpickle, which runs code
    embedded in the file, only with ``allow_pickle``."""
    try:
        return torch.load(path, map_location="cpu", weights_only=True)
    except (pickle.UnpicklingError, RuntimeError) as e:
        if not allow_pickle:
            raise RuntimeError(
                f"{path} is not loadable with weights_only=True ({e}). "
                "Loading it requires a full unpickle, which runs code "
                "embedded in the file. If you trust this checkpoint, "
                "pass allow_pickle=True (CLI: --allow_pickle).") from e
        warnings.warn(
            f"{path} is not loadable with weights_only=True ({e}); "
            "retrying with weights_only=False (allow_pickle=True), which "
            "runs pickled code from the file.", stacklevel=3)
        return torch.load(path, map_location="cpu", weights_only=False)


def load_torch_checkpoint(path: str, observation_size: Optional[int] = None,
                          allow_pickle: bool = False,
                          device: Device = "cuda") -> Dict:
    """A reference ``checkpoint.pt`` as a dict: ``config`` (the port's
    Config from the saved dict, unknown reference-only fields ignored),
    ``model`` (the port's model with the checkpoint's weights, on
    ``device``, in eval mode), ``step`` / ``epoch`` / ``metrics`` /
    ``finance_metadata`` verbatim, and the raw ``model_state_dict`` and
    ``optimizer_state_dict``. ``observation_size`` is inferred from the
    encoder's input width when not given."""
    ckpt = _load(path, allow_pickle)
    cfg_dict = ckpt.get("config")
    if cfg_dict is None:
        raise KeyError(f"{path} has no 'config' entry")
    cfg = Config.from_dict(cfg_dict)
    sd = ckpt["model_state_dict"]
    name = cfg.MODEL.MODEL_NAME
    if observation_size is None:
        observation_size = _infer_observation_size(sd, name)
    model = make_model(cfg, observation_size, device=device)
    model.load_state_dict(convert_state_dict(sd, name))
    return {
        "config": cfg,
        "model": model.eval(),
        "step": ckpt.get("step"),
        "epoch": ckpt.get("epoch"),
        "metrics": ckpt.get("metrics"),
        "finance_metadata": ckpt.get("finance_metadata"),
        "model_state_dict": sd,
        "optimizer_state_dict": ckpt.get("optimizer_state_dict"),
    }


def resume_train_state_from_torch(path: str, cfg: Config, state,
                                  allow_pickle: bool = False):
    """Continue a reference run: ``state`` (``train/loop.py``'s TrainState
    for ``cfg``'s model) takes the checkpoint's weights, its AdamW moments
    and its step, in place; returns it. Every parameter's shape must be the
    configured model's."""
    ckpt = _load(path, allow_pickle)
    sd = ckpt["model_state_dict"]
    model = state.model
    weights = convert_state_dict(sd, model.model_name)
    ours = dict(model.named_parameters())
    for name, value in weights.items():
        if name not in ours or tuple(ours[name].shape) != tuple(value.shape):
            raise ValueError(
                f"checkpoint parameter '{name}' {tuple(value.shape)} does "
                "not match the configured model "
                f"{tuple(ours[name].shape) if name in ours else None}")
    model.load_state_dict(weights)
    state.optimizer.state.clear()
    osd = ckpt.get("optimizer_state_dict")
    if osd is not None:
        convert_optimizer_state(osd, sd, model, state.optimizer)
    state.step = int(ckpt.get("step") or 0)
    return state


def _infer_observation_size(state_dict: Dict, model_name: str) -> int:
    if model_name == "LISTAKM":
        if "lista.We.weight" in state_dict:
            return int(state_dict["lista.We.weight"].shape[1])
        return int(state_dict["dict"].shape[1])
    first = min((k for k in state_dict
                 if k.startswith("encoder.network.") and k.endswith(".weight")),
                key=lambda k: int(k.split(".")[2]))
    return int(state_dict[first].shape[1])


def export_params_to_state_dict(model: KoopmanModel
                                ) -> Dict[str, torch.Tensor]:
    """The model's weights as a reference-layout state dict (float32 CPU
    tensors, ready for ``torch.save`` under ``model_state_dict``)."""
    return {k: v.detach().to("cpu", torch.float32).clone()
            for k, v in model.state_dict().items()}


def check_finance_compatibility(fd, ckpt: Dict) -> None:
    """Refuse to evaluate a reference-trained model on a mismatched data
    panel: ``ValueError`` where the loaded FinanceData disagrees with the
    checkpoint's ``finance_metadata`` on asset count, embedding width or
    observation size. Warns when the panel is synthetic, whose
    standardization stats are not the ones the checkpoint trained on."""
    meta = ckpt.get("finance_metadata") or {}
    checks = {
        "n_assets": fd.n_assets,
        "embedding_dim": fd.metadata.get("embedding_dim"),
        "observation_size": fd.observation_size,
    }
    for key, ours in checks.items():
        theirs = meta.get(key)
        if theirs is not None and ours is not None and int(theirs) != int(ours):
            raise ValueError(
                f"checkpoint finance_metadata[{key!r}] = {theirs} does not "
                f"match the loaded data panel ({ours}); point "
                "ENV.FINANCE.CACHE_DIR at the checkpoint's original data "
                "or fix the config")
    cfg = ckpt.get("config")
    synthetic = getattr(getattr(getattr(cfg, "ENV", None), "FINANCE", None),
                        "SYNTHETIC", None)
    if synthetic:
        warnings.warn(
            "Evaluating a reference-trained checkpoint on the SYNTHETIC "
            "finance panel: its standardization stats differ from the "
            "data the model was trained on, so metrics exercise the "
            "machinery but are not meaningful. Set "
            "ENV.FINANCE.CACHE_DIR to the original parquet cache for "
            "real comparisons.", stacklevel=2)


def save_reference_checkpoint(path, model: KoopmanModel, cfg: Config,
                              step: int = 0,
                              optimizer: Optional[torch.optim.Optimizer] = None,
                              finance_metadata: Optional[Dict] = None) -> None:
    """``torch.save`` a checkpoint in the reference's layout: the weights
    (:func:`export_params_to_state_dict`), the config as a plain dict, the
    step, and with ``optimizer`` its state dict (the port's AdamW groups are
    the reference's)."""
    payload = {
        "step": int(step),
        "model_state_dict": export_params_to_state_dict(model),
        "config": cfg.to_dict(),
        "metrics": {},
    }
    if optimizer is not None:
        payload["optimizer_state_dict"] = optimizer.state_dict()
    if finance_metadata is not None:
        # Plain JSON types only, which a weights_only load accepts.
        payload["finance_metadata"] = json.loads(
            json.dumps(finance_metadata, default=str))
    torch.save(payload, path)
