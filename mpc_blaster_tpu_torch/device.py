"""Where the port's tensors go: the card unless the caller asks otherwise.

Every entry point that builds tensors from a configuration or from numpy
takes `device=None` and resolves it here. A tensor the caller hands in (a
spec, an initial state, an iterate) carries its own device, which wins
over the default; an explicit `device` wins over both. With neither, the
port runs on the CUDA card. A machine without one gets an error that says
how to ask for the CPU: nothing falls back to it quietly.
"""
from __future__ import annotations

import torch


def resolve_device(device=None, *like) -> torch.device:
    """The device an entry point builds its tensors on.

    `device`, when given, is used as it is. Otherwise the first of `like`
    that is a tensor gives its device; otherwise the default, CUDA.
    Raises RuntimeError when the default is asked for on a machine
    without a CUDA device.
    """
    if device is not None:
        return torch.device(device)
    for t in like:
        if isinstance(t, torch.Tensor):
            return t.device
    if not torch.cuda.is_available():
        raise RuntimeError(
            "mpc_blaster_tpu_torch runs on the CUDA card by default and "
            "this machine has none; pass device=\"cpu\" to run on the CPU")
    return torch.device("cuda")
