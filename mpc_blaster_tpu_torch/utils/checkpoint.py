"""Checkpoint and resume for long batched sweeps.

Port of `mpc_blaster_tpu/utils/checkpoint.py`, on `torch.utils._pytree`
for the tree structure:

- `save_pytree` / `load_pytree`: any pytree of tensors (RTIState batches,
  closed-loop carries, sweep accumulators) round-trips through one .npz
  with the structure preserved (the single-host path);
- `save_pytree_orbax` / `load_pytree_orbax`: the multi-process path, on
  `torch.distributed.checkpoint` (where the JAX package uses orbax): each
  rank writes and reads its own shards into a checkpoint directory; in one
  process without a group it runs single-process. Restore takes the
  `like` tree for structure, dtypes and devices.
"""
from __future__ import annotations

import json
import os
from typing import Any

import numpy as np
import torch
import torch.utils._pytree as pytree

from mpc_blaster_tpu_torch.utils.metrics import _np


def save_pytree(path: str, tree: Any) -> None:
    """Serialize a pytree of tensors to one .npz (+ its structure as
    text)."""
    leaves, spec = pytree.tree_flatten(tree)
    arrays = {f"leaf_{i}": _np(leaf) for i, leaf in enumerate(leaves)}
    tmp = path + ".tmp"
    np.savez(tmp, __treedef__=json.dumps(str(spec)), **arrays)
    # np.savez appends .npz to the filename it is given
    os.replace(tmp + ".npz" if not tmp.endswith(".npz") else tmp, path)


def _like_leaf(arr: np.ndarray, ref, i: int) -> torch.Tensor:
    ref = torch.as_tensor(ref)
    if tuple(arr.shape) != tuple(ref.shape):
        raise ValueError(f"checkpoint leaf {i} shape {arr.shape} != "
                         f"expected {tuple(ref.shape)}")
    return torch.as_tensor(arr).to(dtype=ref.dtype, device=ref.device)


def load_pytree(path: str, like: Any) -> Any:
    """Restore into the structure of `like` (shape-checked; each leaf is a
    tensor of the dtype and device of its counterpart in `like`)."""
    with np.load(path, allow_pickle=False) as data:
        leaves_like, spec = pytree.tree_flatten(like)
        leaves = [_like_leaf(data[f"leaf_{i}"], ref, i)
                  for i, ref in enumerate(leaves_like)]
        return pytree.tree_unflatten(leaves, spec)


def _no_group() -> bool:
    import torch.distributed as dist
    return not (dist.is_available() and dist.is_initialized())


def save_pytree_orbax(path: str, tree: Any) -> None:
    """`torch.distributed.checkpoint` save of a pytree of tensors into the
    directory `path` (each rank writes its shards; one process without a
    group writes alone)."""
    import torch.distributed.checkpoint as dcp
    leaves, _ = pytree.tree_flatten(tree)
    state = {f"leaf_{i}": torch.as_tensor(leaf) for i, leaf in
             enumerate(leaves)}
    dcp.save(state, checkpoint_id=os.path.abspath(path), no_dist=_no_group())


def load_pytree_orbax(path: str, like: Any) -> Any:
    """Restore a `save_pytree_orbax` checkpoint into `like`'s structure,
    each leaf on the dtype and device of its counterpart in `like` (which
    is left as it is)."""
    import torch.distributed.checkpoint as dcp
    leaves_like, spec = pytree.tree_flatten(like)
    state = {f"leaf_{i}": torch.empty_like(torch.as_tensor(leaf))
             for i, leaf in enumerate(leaves_like)}
    dcp.load(state, checkpoint_id=os.path.abspath(path), no_dist=_no_group())
    return pytree.tree_unflatten([state[f"leaf_{i}"]
                                  for i in range(len(leaves_like))], spec)
