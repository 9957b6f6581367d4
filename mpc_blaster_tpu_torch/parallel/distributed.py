"""Multi-process glue: a `torch.distributed` process group and global
meshes.

Port of `mpc_blaster_tpu/parallel/distributed.py`. Multi-process runs are
the same sharded code as one process: `initialize()` joins the process
group (gloo for tensors on the CPU, NCCL on the card, through a `tcp://`
rendezvous at `coordinator_address`), and the sharded tick's reductions
(`parallel/mesh.py`) then run as `all_reduce` over the ranks. Per-scenario
solves stay on their rank's device. Nothing in the environment names a
cluster: the caller gives the address, the world size and the rank.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from mpc_blaster_tpu_torch.parallel.mesh import Mesh


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               device=None) -> bool:
    """Join (or create) the process group of `num_processes` ranks at
    `coordinator_address` ("host:port") as rank `process_id`; the backend
    is NCCL when `device` is a CUDA device (the default, as every entry
    point of the port), gloo for the CPU. Returns True when running with
    more than one rank.

    num_processes <= 1 returns False without a group; an already
    initialized group is reused. An argument left None is read from the
    environment as torchrun sets it (WORLD_SIZE and RANK, default 1 and 0;
    MASTER_ADDR and MASTER_PORT for the address), so a call with only an
    address makes a group of one. Any other failure raises: there is no
    quiet single-process fallback."""
    if num_processes is not None and num_processes <= 1:
        return False
    if dist.is_initialized():
        return dist.get_world_size() > 1
    if coordinator_address is None:
        if "MASTER_ADDR" not in os.environ:
            raise ValueError("initialize needs coordinator_address (or "
                             "MASTER_ADDR and MASTER_PORT)")
        coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                               f"{os.environ['MASTER_PORT']}")
    if num_processes is None:
        num_processes = int(os.environ.get("WORLD_SIZE", "1"))
    if process_id is None:
        process_id = int(os.environ.get("RANK", "0"))
    dev = torch.device("cuda") if device is None else torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev.index if dev.index is not None
                              else process_id % torch.cuda.device_count())
    dist.init_process_group(
        backend="nccl" if dev.type == "cuda" else "gloo",
        init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id)
    return dist.get_world_size() > 1


def _world() -> tuple:
    """(rank, world size): (0, 1) without a process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def global_mesh(axis: str = "dp", device=None) -> Mesh:
    """1-D mesh over this rank's devices: its CUDA card (the one
    `initialize` set) by default, or `device`. The global mesh of the JAX
    package spans every process's devices; here each rank holds its own
    shard of it and the ranks meet in the reductions."""
    if device is None:
        if not torch.cuda.is_available():
            from mpc_blaster_tpu_torch.device import resolve_device
            resolve_device()     # raises, naming device="cpu"
        device = torch.device("cuda", torch.cuda.current_device())
    return Mesh(devices=(torch.device(device),), axis_names=(axis,))


def host_local_batch(global_batch: int) -> int:
    """Scenario count this rank should generate for an even global
    shard."""
    n = _world()[1]
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} not divisible by "
                         f"{n} processes")
    return global_batch // n


def make_global_array(host_local_data, mesh: Mesh, axis: str = "dp"):
    """This rank's shard of a batch sharded over the ranks: the per-rank
    scenario data as a tensor on this rank's device (the mesh's first),
    and the global batch size the ranks hold together."""
    if axis not in mesh.axis_names:
        raise ValueError(f"axis {axis!r} not in the mesh's {mesh.axis_names}")
    local = torch.as_tensor(np.asarray(host_local_data),
                            device=mesh.devices[0])
    return local, local.shape[0] * _world()[1]
