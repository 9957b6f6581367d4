"""State carried across between the JAX package and the port, as numpy.

`*_from_numpy` turn the fields of a JAX container (an `OCPSpec`,
`RTIState`, `QPData`, `IpmWarmStart`, `WatchdogState`, `JacCache`,
`SoftBounds`, `OffsetFreeResult` or `TrackingResult`, as numpy arrays, or a mapping of
them) into the port's container on a device and dtype; `*_to_numpy` go
the other way, returning a dict of numpy arrays keyed by field name (for
`SoftBounds` a dict of such dicts, one per `SoftPenalty`). A
`Quad13Config` (a frozen dataclass of numbers) goes by its fields too. The parity tests use these so both sides compute from the
same numbers (and start a warm chain from the same warm state, a soft
tick from the same penalties).
"""
from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from mpc_blaster_tpu_torch.device import resolve_device
from mpc_blaster_tpu_torch.models.quad13 import Quad13Config
from mpc_blaster_tpu_torch.ocp.spec import OCPSpec
from mpc_blaster_tpu_torch.qp.data import QPData
from mpc_blaster_tpu_torch.qp.ipm import IpmWarmStart
from mpc_blaster_tpu_torch.qp.soft import SoftBounds, SoftPenalty
from mpc_blaster_tpu_torch.sim.scenarios import OffsetFreeResult
from mpc_blaster_tpu_torch.sim.tasks import TrackingResult
from mpc_blaster_tpu_torch.sqp.rti import JacCache, RTIState, WatchdogState


def _fields(d) -> Mapping:
    return d._asdict() if hasattr(d, "_asdict") else d


def _from_numpy(cls, d, device, dtype, dtypes=None):
    f = _fields(d)
    dtypes = dtypes or {}
    device = resolve_device(device)
    return cls(**{k: torch.as_tensor(np.array(f[k]),
                                     dtype=dtypes.get(k, dtype),
                                     device=device) for k in cls._fields})


def _to_numpy(x) -> dict:
    return {k: v.detach().cpu().numpy() for k, v in x._asdict().items()}


def spec_from_numpy(d, device=None, dtype=torch.float32) -> OCPSpec:
    return _from_numpy(OCPSpec, d, device, dtype)


def spec_to_numpy(spec: OCPSpec) -> dict:
    return _to_numpy(spec)


def rti_state_from_numpy(d, device=None, dtype=torch.float32) -> RTIState:
    return _from_numpy(RTIState, d, device, dtype)


def rti_state_to_numpy(state: RTIState) -> dict:
    return _to_numpy(state)


def qp_from_numpy(d, device=None, dtype=torch.float32) -> QPData:
    return _from_numpy(QPData, d, device, dtype)


def qp_to_numpy(qp: QPData) -> dict:
    return _to_numpy(qp)


def warm_from_numpy(d, device=None, dtype=torch.float32) -> IpmWarmStart:
    return _from_numpy(IpmWarmStart, d, device, dtype)


def warm_to_numpy(warm: IpmWarmStart) -> dict:
    return _to_numpy(warm)


def watchdog_from_numpy(d, device=None, dtype=torch.float32
                        ) -> WatchdogState:
    """`dtype` is the EMA's; the trip and hold counters are int32."""
    return _from_numpy(WatchdogState, d, device, dtype,
                       {"trips": torch.int32, "hold": torch.int32})


def watchdog_to_numpy(wd: WatchdogState) -> dict:
    return _to_numpy(wd)


def jac_cache_from_numpy(d, device=None, dtype=torch.float32) -> JacCache:
    return _from_numpy(JacCache, d, device, dtype)


def jac_cache_to_numpy(cache: JacCache) -> dict:
    return _to_numpy(cache)


def soft_from_numpy(d, device=None, dtype=torch.float32) -> SoftBounds:
    """`dtype` is the penalties'; the `soft` masks are bool."""
    f = _fields(d)
    return SoftBounds(**{g: _from_numpy(SoftPenalty, f[g], device, dtype,
                                        {"soft": torch.bool})
                         for g in SoftBounds._fields})


def soft_to_numpy(soft: SoftBounds) -> dict:
    return {g: _to_numpy(p) for g, p in soft._asdict().items()}


def offset_free_from_numpy(d, device=None, dtype=torch.float32
                           ) -> OffsetFreeResult:
    return _from_numpy(OffsetFreeResult, d, device, dtype)


def offset_free_to_numpy(res: OffsetFreeResult) -> dict:
    return _to_numpy(res)


def tracking_from_numpy(d, device=None, dtype=torch.float32
                        ) -> TrackingResult:
    return _from_numpy(TrackingResult, d, device, dtype)


def tracking_to_numpy(res: TrackingResult) -> dict:
    return _to_numpy(res)


def quad13_config_to_numpy(c) -> dict:
    """A `Quad13Config` of either package as numpy values by field."""
    return {f.name: np.asarray(getattr(c, f.name))
            for f in dataclasses.fields(c)}


def quad13_config_from_numpy(d) -> Quad13Config:
    """The port's `Quad13Config` from numpy values by field (tuples stay
    tuples of floats, N an int)."""
    out = {}
    for f in dataclasses.fields(Quad13Config):
        v = np.asarray(d[f.name])
        out[f.name] = (tuple(float(a) for a in v) if v.ndim
                       else int(v) if f.name == "N" else float(v))
    return Quad13Config(**out)
