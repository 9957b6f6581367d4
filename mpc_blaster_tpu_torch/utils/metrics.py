"""Solver observability: per-tick diagnostics turned into summary records
for logging and alerting.

The port's own copy of `mpc_blaster_tpu/utils/metrics.py` (numpy only);
tensors on any device are read through `np.asarray` of their host copy.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Optional

import numpy as np
import torch


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


@dataclasses.dataclass
class SolveStats:
    n_solves: int
    kkt_stat_p50: float
    kkt_stat_max: float
    kkt_eq_max: float
    cost_final: float
    nan_count: int
    bound_violation_max: float

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))

    @property
    def healthy(self) -> bool:
        return (self.nan_count == 0 and self.kkt_eq_max < 1e-2
                and np.isfinite(self.cost_final))


def summarize(result, lbx: Optional[np.ndarray] = None,
              ubx: Optional[np.ndarray] = None) -> SolveStats:
    """Summarize a sim.ClosedLoopResult (or anything with xs/us/kkt_*)."""
    xs = _np(result.xs)
    kkt_stat = _np(result.kkt_stat)
    kkt_eq = _np(result.kkt_eq)
    costs = _np(result.costs)
    viol = 0.0
    if lbx is not None:
        viol = max(viol, float(np.maximum(_np(lbx) - xs[1:], 0.0).max()))
    if ubx is not None:
        viol = max(viol, float(np.maximum(xs[1:] - _np(ubx), 0.0).max()))
    return SolveStats(
        n_solves=int(kkt_stat.shape[0]),
        kkt_stat_p50=float(np.percentile(kkt_stat, 50)),
        kkt_stat_max=float(kkt_stat.max()),
        kkt_eq_max=float(kkt_eq.max()),
        cost_final=float(costs[-1]),
        nan_count=int((~np.isfinite(xs)).sum()),
        bound_violation_max=viol,
    )
