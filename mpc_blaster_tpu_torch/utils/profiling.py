"""Tracing and profiling: named wall-clock timers with percentile
summaries, and a device trace one context manager away.

Port of `mpc_blaster_tpu/utils/profiling.py`: `trace` runs
`torch.profiler` (the host's ops, and the card's kernels through CUPTI
when CUDA is available) and writes a Chrome trace, `trace.json`, into
`log_dir`, where the JAX package wrote a TensorBoard trace.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch


class Timer:
    """Named wall-clock timers with p50/p95/p99 summaries."""

    def __init__(self):
        self._samples: Dict[str, List[float]] = {}

    @contextlib.contextmanager
    def measure(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._samples.setdefault(name, []).append(
                time.perf_counter() - t0)

    def add(self, name: str, seconds: float) -> None:
        self._samples.setdefault(name, []).append(seconds)

    def summary(self, name: str) -> dict:
        s = np.asarray(self._samples.get(name, []), dtype=np.float64)
        if s.size == 0:
            return {"count": 0}
        return {
            "count": int(s.size),
            "mean_ms": float(s.mean() * 1e3),
            "p50_ms": float(np.percentile(s, 50) * 1e3),
            "p95_ms": float(np.percentile(s, 95) * 1e3),
            "p99_ms": float(np.percentile(s, 99) * 1e3),
            "max_ms": float(s.max() * 1e3),
        }

    def summaries(self) -> Dict[str, dict]:
        return {k: self.summary(k) for k in self._samples}


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """Profile the body with `torch.profiler` and write its Chrome trace to
    `log_dir`/trace.json (viewable in chrome://tracing or Perfetto); the
    profile object is yielded. No-op when `log_dir` is None."""
    if log_dir is None:
        yield None
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
