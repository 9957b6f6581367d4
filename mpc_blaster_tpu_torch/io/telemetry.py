"""Pose telemetry probes — analogs of `src/scripts/getPose_scripts/`.

The reference ships two styles of MAVROS pose reader: a callback subscriber
that processes inside the callback (`getPose_int.py:8-23`) and a poller that
reads a module-global and admits it lags (`getPose_ext.py:20-28` with the
"Slow will have a substantial lag" comment — a latent race, SURVEY.md §5).
Here both styles are one thread-safe probe over a pluggable source; the
"lag" is surfaced as an explicit staleness stamp instead of a surprise.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Optional

import numpy as np


@dataclasses.dataclass
class PoseSample:
    position: np.ndarray      # (3,)
    orientation: np.ndarray   # (4,) quaternion wxyz
    stamp: float              # seconds (monotonic)

    def age(self, now: Optional[float] = None) -> float:
        return (now if now is not None else time.monotonic()) - self.stamp


class PoseProbe:
    """Thread-safe latest-pose holder with callback and polling access."""

    def __init__(self):
        self._lock = threading.Lock()
        self._latest: Optional[PoseSample] = None
        self._callbacks = []

    def on_pose(self, fn: Callable[[PoseSample], None]) -> None:
        """Callback style (`getPose_int.py`): fn runs on every update."""
        self._callbacks.append(fn)

    def update(self, position, orientation, stamp: Optional[float] = None):
        """Feed a new measurement (called by the transport adapter)."""
        sample = PoseSample(
            position=np.asarray(position, dtype=np.float64),
            orientation=np.asarray(orientation, dtype=np.float64),
            stamp=stamp if stamp is not None else time.monotonic(),
        )
        with self._lock:
            self._latest = sample
        for fn in self._callbacks:
            fn(sample)

    def latest(self) -> Optional[PoseSample]:
        """Polling style (`getPose_ext.py`) — but with explicit staleness."""
        with self._lock:
            return self._latest
