"""Device mesh and sharding layer on torch.distributed (port of
kmpc_tpu/parallel/mesh.py).

Mesh axes, one rank a card:
    data     — data parallel: shards the training batch; the loss is the
               global mean, so the gradients are averaged over its ranks.
    scenario — the workload's dominant parallel axis: backtest dates and
               the problems of a batched MPC solve.
    model    — tensor parallel: shards the Koopman matrix [z, z] and the
               wide encoder/decoder products over their latent dimension.

A ``NamedSharding`` of kmpc_tpu becomes DTensor placements (``Shard``,
``Replicate``) over a ``DeviceMesh`` named ("data", "scenario", "model"):
parameters and batches are DTensors, and DTensor inserts the collectives of
the training step (the gradient all-reduce over data x scenario, the
activation collectives over model). Where DTensor carries no op, as for the
CUDA kernels of the solves, each rank works on its local shard and the
shards are gathered after (kmpc_tpu's ``jax.shard_map``).
"""

from __future__ import annotations

import hashlib
import math
from typing import Dict, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import (
    DTensor, Replicate, Shard, distribute_tensor,
)

from kmpc_tpu_torch.config import Config
from kmpc_tpu_torch.models.koopman import KoopmanModel

AXES = ("data", "scenario", "model")
BATCH_AXES = ("data", "scenario")
Device = Union[str, torch.device, None]


# ---------------------------------------------------------------------------
# Mesh construction
# ---------------------------------------------------------------------------


def mesh_sizes(shape: Optional[Dict[str, int]], n: int) -> Dict[str, int]:
    """The axis sizes of a mesh of ``n`` ranks: missing axes get 1, one
    axis of -1 absorbs the rest, an empty shape puts every rank on
    'data'; ValueError where the product is not ``n``."""
    shape = dict(shape or {})
    sizes = {name: int(shape.get(name, 1)) for name in AXES}
    wild = [k for k, v in sizes.items() if v == -1]
    fixed = math.prod(v for v in sizes.values() if v != -1)
    if wild:
        if len(wild) > 1:
            raise ValueError("Only one axis may be -1")
        if n % fixed != 0:
            raise ValueError(f"{n} devices not divisible by fixed axes {fixed}")
        sizes[wild[0]] = n // fixed
    if not shape:
        sizes["data"] = n
    total = sizes["data"] * sizes["scenario"] * sizes["model"]
    if total != n:
        raise ValueError(f"Mesh {sizes} needs {total} devices, have {n}")
    return sizes


def _ensure_world(device: Device) -> None:
    """A world of one rank where no process group exists (NCCL, or gloo
    when ``device`` is the CPU), so that a single process can build a mesh
    of one."""
    if dist.is_initialized():
        return
    cpu = device is not None and torch.device(device).type == "cpu"
    if not cpu and not torch.cuda.is_available():
        raise RuntimeError(
            "a mesh on the card needs CUDA and none is available; pass "
            "device='cpu' for a mesh of CPU ranks")
    dist.init_process_group("gloo" if cpu else "nccl", store=dist.HashStore(),
                            rank=0, world_size=1)
    if not cpu:
        torch.cuda.set_device(torch.cuda.current_device())


def make_mesh(shape: Optional[Dict[str, int]] = None,
              devices: Optional[Sequence[int]] = None,
              device: Device = None) -> DeviceMesh:
    """A ("data", "scenario", "model") mesh over the ranks ``devices``
    (default: every rank of the world), sized by :func:`mesh_sizes`. CUDA
    meshes where the world runs NCCL, CPU meshes where it runs gloo. With
    no process group, a world of one is made first (``device`` picks its
    backend: the card by default, gloo for ``"cpu"``)."""
    n = len(devices) if devices is not None else (
        dist.get_world_size() if dist.is_initialized() else 1)
    sizes = mesh_sizes(shape, n)
    _ensure_world(device)
    ranks = list(devices) if devices is not None \
        else list(range(dist.get_world_size()))
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    grid = torch.tensor(ranks, dtype=torch.int64).reshape(
        sizes["data"], sizes["scenario"], sizes["model"])
    return DeviceMesh(device_type, grid, mesh_dim_names=AXES)


def mesh_from_config(cfg: Config, devices: Optional[Sequence[int]] = None,
                     device: Device = None) -> DeviceMesh:
    return make_mesh(
        {
            "data": cfg.PARALLEL.DATA,
            "scenario": cfg.PARALLEL.SCENARIO,
            "model": cfg.PARALLEL.MODEL,
        },
        devices, device,
    )


def axis_size(mesh: DeviceMesh, name: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(name))


def placements_over(mesh: DeviceMesh,
                    axes: Union[str, Sequence[str]]) -> list:
    """Shard(0) on the mesh axes ``axes``, Replicate on the others."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    return [Shard(0) if name in axes else Replicate()
            for name in mesh.mesh_dim_names]


def shard_index(mesh: DeviceMesh, axes: Sequence[str] = BATCH_AXES
                ) -> Tuple[int, int]:
    """(this rank's shard, the number of shards) of an axis split over the
    mesh axes ``axes``, row-major in mesh order (DTensor's order of
    nested shards)."""
    coord = mesh.get_coordinate()
    i, n = 0, 1
    for d, name in enumerate(mesh.mesh_dim_names):
        if name in axes:
            i = i * mesh.size(d) + coord[d]
            n *= mesh.size(d)
    return i, n


def gather_rows(local: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """The whole tensor on every rank from each rank's rows (its shard of
    the leading axis over data x scenario)."""
    as_bytes = local.dtype == torch.bool
    t = local.to(torch.uint8) if as_bytes else local
    full = DTensor.from_local(t.contiguous(), mesh,
                              placements_over(mesh, BATCH_AXES),
                              run_check=False).full_tensor()
    return full.bool() if as_bytes else full


def full(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's whole value on every rank (a collective); any other
    tensor as it is."""
    return t.full_tensor() if isinstance(t, DTensor) else t


def same_on_every_rank(model: nn.Module) -> bool:
    """Whether every rank holds the same bits of every parameter (each
    rank's whole value of each, gathered from its own shards); a
    collective."""
    mine = [hashlib.sha256(full(p.detach()).contiguous().cpu().numpy()
                           .tobytes()).hexdigest()
            for _, p in model.named_parameters()]
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, mine)
    return all(d == every[0] for d in every)


# ---------------------------------------------------------------------------
# Sharding specs
# ---------------------------------------------------------------------------


def param_specs(model: KoopmanModel) -> Dict[str, Tuple[Optional[str], ...]]:
    """{parameter name: the mesh axis of each of its dimensions} for the
    tensor-parallel layout over 'model', in the port's orientation (a
    Linear weight is [out, in], the transpose of kmpc_tpu's ``w``):

      kmat [z, z]              -> (None, 'model')   column-sharded, z @ K
      encoder's last weight    -> ('model', None)   z-sharded latents
      decoder's first weight   -> (None, 'model')   consumes them (a sum of
                                                    partial products)
      LISTA lista.We.weight    -> ('model', None); lista.S -> (None, 'model')
      dict [z, x]              -> ('model', None)

    Everything else (biases, other layers, an MLP LISTA encoder) is
    replicated: ()."""
    fixed = {"kmat": (None, "model"), "dict": ("model", None),
             "lista.S": (None, "model"), "lista.We.weight": ("model", None)}
    if not model.is_lista:
        for part, pick, spec in (("encoder", -1, ("model", None)),
                                 ("decoder", 0, (None, "model"))):
            linears = [n for n, m in getattr(model, part).network.named_children()
                       if isinstance(m, nn.Linear)]
            fixed[f"{part}.network.{linears[pick]}.weight"] = spec
    return {name: fixed.get(name, ()) for name, _ in model.named_parameters()}


def _owner(model: nn.Module, name: str) -> Tuple[nn.Module, str]:
    path, _, leaf = name.rpartition(".")
    return (model.get_submodule(path) if path else model), leaf


def shard_params(model: KoopmanModel, mesh: DeviceMesh) -> KoopmanModel:
    """Place ``model``'s parameters on the mesh in place, as DTensors by
    :func:`param_specs` (a dimension 'model' does not divide is
    replicated), each rank's shard taken from rank 0's values; returns the
    model."""
    m = axis_size(mesh, "model")
    for name, spec in param_specs(model).items():
        owner, leaf = _owner(model, name)
        p = getattr(owner, leaf)
        placements = [Replicate()] * mesh.ndim
        if "model" in spec and p.shape[spec.index("model")] % m == 0:
            placements[mesh.mesh_dim_names.index("model")] = \
                Shard(spec.index("model"))
        setattr(owner, leaf, nn.Parameter(
            distribute_tensor(p.detach(), mesh, placements),
            requires_grad=p.requires_grad))
    return model


def is_sharded(model: nn.Module) -> bool:
    return any(isinstance(p, DTensor) for p in model.parameters())


def _tree_map(fn, tree):
    if torch.is_tensor(tree):
        return fn(tree)
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, t) for t in tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return tree


def shard_batch(batch, mesh: DeviceMesh, axes: Sequence[str] = ("data",)):
    """Each tensor of ``batch`` (a global batch every rank holds) as a
    DTensor whose leading axis is sharded over the mesh axes ``axes``, this
    rank keeping its rows; replicated where those axes do not divide it."""
    i, n = shard_index(mesh, axes)

    def place(x):
        if x.shape[0] % n:
            return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                                      run_check=False)
        b = x.shape[0] // n
        return DTensor.from_local(x[i * b:(i + 1) * b].contiguous(), mesh,
                                  placements_over(mesh, axes), run_check=False)

    return _tree_map(place, batch)


def replicate(tree, mesh: DeviceMesh):
    """Each tensor of ``tree`` (the same on every rank) as a replicated
    DTensor."""
    return _tree_map(lambda x: DTensor.from_local(
        x, mesh, [Replicate()] * mesh.ndim, run_check=False), tree)


# ---------------------------------------------------------------------------
# Train states on the mesh
# ---------------------------------------------------------------------------


def shard_train_state(state, mesh: DeviceMesh):
    """``state`` (a ``train.loop.TrainState``) placed on the mesh in place:
    its model's parameters by :func:`shard_params`, its AdamW rebuilt over
    them with the same groups and its moments placed as their parameters;
    returns it."""
    model, opt = state.model, state.optimizer
    names = {p: n for n, p in model.named_parameters()}
    groups = [({k: v for k, v in g.items() if k != "params"},
               [names[p] for p in g["params"]]) for g in opt.param_groups]
    moments = {names[p]: st for p, st in opt.state.items()}
    shard_params(model, mesh)
    new = dict(model.named_parameters())
    state.optimizer = type(opt)(
        [{**g, "params": [new[n] for n in ns]} for g, ns in groups])
    for n, st in moments.items():
        p = new[n]
        state.optimizer.state[p] = {
            k: (distribute_tensor(v.detach(), mesh, p.placements)
                if torch.is_tensor(v) and v.shape == p.shape else v)
            for k, v in st.items()}
    return state


def gather_train_state(state, like):
    """``state``'s weights, AdamW moments and step gathered into ``like``
    (a train state of plain tensors with the same architecture and AdamW
    groups) on every rank; a collective. Returns ``like``."""
    dst = dict(like.model.named_parameters())
    like.optimizer.state.clear()
    with torch.no_grad():
        for n, p in state.model.named_parameters():
            dst[n].copy_(full(p.detach()))
            st = state.optimizer.state.get(p)
            if st:
                like.optimizer.state[dst[n]] = {
                    k: (full(v.detach()).clone() if torch.is_tensor(v) else v)
                    for k, v in st.items()}
    like.step = state.step
    return like


# ---------------------------------------------------------------------------
# Sharded program builders
# ---------------------------------------------------------------------------


def make_sharded_train_step(cfg: Config, model: KoopmanModel,
                            mesh: DeviceMesh, dt: float = 1.0):
    """Data+tensor-parallel training step: (state, global batch) ->
    (state, metrics). The batch is sharded over ('data', 'scenario'), the
    parameters over 'model' (the state is placed on the mesh at its first
    step if it is not yet); the loss is the global batch's mean, so the
    gradients are averaged over the batch's ranks. Every rank passes the
    same global batch and gets the metrics of the whole batch."""
    from kmpc_tpu_torch.train.loop import make_train_step

    step = make_train_step(cfg, model, dt)

    def sharded_step(state, batch):
        if not is_sharded(state.model):
            shard_train_state(state, mesh)
        state, metrics = step(state, shard_batch(batch, mesh, BATCH_AXES))
        return state, {k: full(v) for k, v in metrics.items()}

    return sharded_step


# Info keys common to every solver path (the packed wrappers' contract);
# the sharded solve restricts its info to them on every path.
_SHARDED_INFO_KEYS = (
    "objective", "converged", "turnover_violation", "fixed_point_residual",
    "status_code",
)


def sharded_mpc_solver(mesh: DeviceMesh, mpc_params,
                       use_fused_kernel: bool = False, program: str = "log"):
    """Problem-sharded batched MPC solve for the three programs:

        'log'      — log-utility/Kelly:        solve(cw [B,N], ys [B,H,N])
        'scenario' — scenario-averaged Kelly:  solve(cw [B,N], scen [B,S,H,N])
        'mv'       — mean-variance:            solve(cw [B,N], mu [B,H,N],
                     sigma [B,N,N] per problem, sharded, or [N,N] shared,
                     replicated)

    Every rank passes the whole batch; the problems are split over
    ('data', 'scenario'), each rank solves its shard (ranks that differ
    only on 'model' solve the same one) and the shards are gathered, so
    every rank gets the whole (w, info). ``use_fused_kernel`` sends each
    shard through the packed wrappers (on a CUDA device the Hopper
    kernels, on the CPU their plain versions) and requires a batch the
    shards divide; the eager solvers solve a batch they do not divide
    whole on every rank (kmpc_tpu replicates it). The info holds
    ``_SHARDED_INFO_KEYS``; the mean-variance program has no turnover ball,
    so its ``turnover_violation`` is zero."""
    if program not in ("log", "scenario", "mv"):
        raise ValueError(f"unknown program {program!r}")

    if program == "log":
        if use_fused_kernel:
            from kmpc_tpu_torch.ops.mpc_cuda import (
                solve_mpc_log_utility_packed as _fused,
            )
        else:
            from kmpc_tpu_torch.ops.mpc import (
                solve_mpc_log_utility_batch as _eager,
            )
    elif program == "scenario":
        if use_fused_kernel:
            from kmpc_tpu_torch.ops.mpc_cuda import (
                solve_mpc_log_utility_scenarios_packed as _fused,
            )
        else:
            from kmpc_tpu_torch.ops.scenario import (
                solve_mpc_log_utility_scenarios as _eager,
            )
    else:
        if use_fused_kernel:
            from kmpc_tpu_torch.ops.mv_cuda import (
                solve_mpc_mean_variance_packed as _fused,
            )
        else:
            from kmpc_tpu_torch.ops.mpc import (
                solve_mpc_mean_variance_batch as _eager,
            )

    def local_solve(cw, *rest):
        if use_fused_kernel:
            w, info = _fused(cw, *rest, mpc_params, device=cw.device)
        else:
            w, info = _eager(cw, *rest, mpc_params)
        out = {}
        for k in _SHARDED_INFO_KEYS:
            out[k] = info[k] if k in info else \
                torch.zeros_like(info["fixed_point_residual"])
        return w, out

    def sharded_solve(current_weights, *rest):
        B = current_weights.shape[0]
        i, n = shard_index(mesh)
        if B % n:
            if use_fused_kernel:
                raise ValueError(
                    f"the fused sharded solve needs a batch its {n} shards "
                    f"divide, got {B}")
            return local_solve(current_weights, *rest)
        rows = slice(i * (B // n), (i + 1) * (B // n))

        def mine(a):  # a shared covariance [N, N] (or [1, N, N]) stays whole
            return a[rows] if a.dim() >= 3 and a.shape[0] == B else a

        w, info = local_solve(current_weights[rows], *map(mine, rest))
        return gather_rows(w, mesh), {k: gather_rows(v, mesh)
                                      for k, v in info.items()}

    return sharded_solve
