"""Multi-process SPMD orchestration on torch.distributed (port of
kmpc_tpu/parallel/distributed.py).

One process ("rank") runs per card; ``torchrun --nproc_per_node=N`` or
:func:`kmpc_tpu_torch.parallel.launch.launch` starts them, and each runs the
same program:

    from kmpc_tpu_torch.parallel import initialize_distributed, make_global_mesh
    initialize_distributed()                  # env-driven or explicit
    mesh = make_global_mesh({"data": -1})     # every rank of the world

    # Each rank materialises only its rows; the global tensor is a DTensor
    # whose leading axis is sharded over the named mesh axes:
    batch = host_local_to_global(mesh, ("data",), local_batch)

CUDA tensors go over NCCL, one rank a card (``LOCAL_RANK``), that card made
current before anything launches; gloo carries CPU tensors, and only when
the caller asks for the CPU. No rank ever shares a card with another.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence, Union

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor

from kmpc_tpu_torch.parallel.mesh import make_mesh, placements_over

Device = Union[str, torch.device, None]


def _is_cpu(device: Device) -> bool:
    return device is not None and torch.device(device).type == "cpu"


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device: Device = None,
) -> None:
    """Join this process to the world of ranks.

    With no arguments, reads ``torchrun``'s environment (``MASTER_ADDR`` /
    ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``);
    ``coordinator_address`` ("host:port"), ``num_processes`` and
    ``process_id`` override it. A no-op in a single process with no such
    environment, and once the world exists. ``device`` None (the default)
    is the card: NCCL, and the card ``LOCAL_RANK`` (or the index of a CUDA
    ``device``) made current after the process group exists; ``"cpu"``
    uses gloo. Nothing touches CUDA before the process group exists.
    """
    if dist.is_initialized():
        return
    env = os.environ
    address = coordinator_address
    if address is None and "MASTER_ADDR" in env:
        address = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
    world = num_processes
    if world is None and "WORLD_SIZE" in env:
        world = int(env["WORLD_SIZE"])
    if address is None and world is None:
        return  # one process, nothing to coordinate
    if address is None or world is None:
        raise ValueError("initialize_distributed needs both a coordinator "
                         "address and a world size (MASTER_ADDR / "
                         "MASTER_PORT and WORLD_SIZE, or the arguments)")
    rank = process_id if process_id is not None else int(env.get("RANK", 0))
    cpu = _is_cpu(device)
    dist.init_process_group("gloo" if cpu else "nccl",
                            init_method=f"tcp://{address}",
                            world_size=world, rank=rank)
    if cpu:
        return
    if not torch.cuda.is_available():
        dist.destroy_process_group()
        raise RuntimeError(
            "initialize_distributed: NCCL needs a CUDA device and none is "
            "available; pass device='cpu' for gloo on the CPU")
    index = torch.device(device).index if device is not None else None
    if index is None:
        index = int(env.get("LOCAL_RANK", rank))
    torch.cuda.set_device(index)


def make_global_mesh(shape: Optional[Dict[str, int]] = None,
                     device: Device = None) -> DeviceMesh:
    """A mesh over every rank of the world."""
    return make_mesh(shape, device=device)


def host_local_to_global(mesh: DeviceMesh, spec: Union[str, Sequence[str]],
                         local_array) -> DTensor:
    """The global tensor whose leading axis is sharded over the mesh axes
    ``spec`` (a name or names, in mesh order), from this rank's rows
    ``local_array`` (numpy or a tensor): the global shape is the local
    rows times the product of those axes' sizes. Ranks that differ only on
    other axes must pass the same rows. In a world of one it is a plain
    placement."""
    local = torch.as_tensor(local_array)
    device = (torch.device("cuda", torch.cuda.current_device())
              if mesh.device_type == "cuda" else torch.device("cpu"))
    return DTensor.from_local(local.to(device).contiguous(), mesh,
                              placements_over(mesh, spec), run_check=False)


def process_local_batch_size(global_batch: int) -> int:
    """Rows this rank should materialise for a data-sharded batch."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    if global_batch % n != 0:
        raise ValueError(f"global batch {global_batch} not divisible by {n} "
                         "ranks")
    return global_batch // n


def scaling_report(solves_per_s: float, num_chips: int,
                   per_chip_baseline: float) -> Dict:
    """Scaling-efficiency summary: solves/s against the ideal of
    ``num_chips`` times the one-card baseline."""
    ideal = per_chip_baseline * num_chips
    return {
        "num_chips": num_chips,
        "solves_per_s": solves_per_s,
        "ideal_solves_per_s": ideal,
        "scaling_efficiency": solves_per_s / ideal if ideal > 0 else float("nan"),
    }
