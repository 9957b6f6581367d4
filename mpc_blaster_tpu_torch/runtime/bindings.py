"""ctypes bindings for the native C++ runtime (`runtime/native/`).

Builds `libblaster_rt.so` on first use with g++ from the port's own copy
of the sources (`runtime/native/riccati_qp.cpp`, `executor.cpp`) into the
git-ignored `mpc_blaster_tpu_torch/build/`, under a name that hashes the
sources, the flags and the target `-march=native` resolves to, through
the CUDA sources' build functions (`ops/nvcc_build.py`), then exposes:

  - `NativeQPSolver` — the CPU real-time OCP-QP solver (acados/HPIPM role:
    flight-computer deployments and differential testing of the IPMs);
  - `RateLoop` — fixed-rate ticker with deadline/jitter accounting
    (replaces rospy.Rate, `mavros_blaster_sim.py:35`);
  - `PoseRingBuffer` — lock-free SPSC telemetry ring (replaces the laggy
    global-variable pose poller, `getPose_ext.py:20-28`).

The ABI is plain C + ctypes. This is host code: nothing here touches the
card, and `NativeQPSolver` copies the port's tensors to host float64.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

from mpc_blaster_tpu_torch.ops import nvcc_build

NATIVE_DIR = Path(__file__).resolve().parent / "native"
SOURCES = ("riccati_qp.cpp", "executor.cpp")
BUILD_DIR = Path(__file__).resolve().parents[1] / "build"
CXX = "g++"
CXXFLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall",
            "-shared")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_error: Optional[str] = None

_D = np.ctypeslib.ndpointer(dtype=np.float64, flags="C_CONTIGUOUS")


def _target() -> str:
    """The compiler and the target its -march=native resolves to on this
    host (part of the library's name: a checkout moved to another host
    rebuilds instead of loading code for the wrong CPU)."""
    res = subprocess.run([CXX, "-march=native", "-Q", "--help=target"],
                         capture_output=True, text=True, check=True)
    return " ".join([CXX] + [ln.split()[-1] for ln in res.stdout.splitlines()
                             if ln.strip().startswith(("-march=",
                                                       "-mtune="))])


def library_path() -> Path:
    """Path of the built library for the current sources, flags and host
    target."""
    return nvcc_build.library_path(_sources(), "libblaster_rt", CXXFLAGS,
                                   _target(), BUILD_DIR)


def _sources() -> tuple:
    return tuple(NATIVE_DIR / n for n in SOURCES)


def _build() -> Path:
    """`library_path()`, compiled first if it is not there (atomically: a
    concurrent build or load never sees half a file)."""
    return nvcc_build.build(_sources(), "libblaster_rt", CXX, CXXFLAGS,
                            _target(), BUILD_DIR)[0]


def load_native() -> ctypes.CDLL:
    """Load (building if needed) the native runtime library."""
    global _lib, _build_error
    with _lock:
        if _lib is not None:
            return _lib
        if _build_error is not None:
            raise RuntimeError(_build_error)
        try:
            lib = ctypes.CDLL(str(_build()))
        except (OSError, RuntimeError, subprocess.CalledProcessError) as e:
            _build_error = f"native runtime unavailable: {e}"
            raise RuntimeError(_build_error) from e

        lib.blaster_qp_solve.restype = ctypes.c_int
        lib.blaster_qp_solve.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            _D, _D, _D, _D, _D, _D, _D, _D, _D, _D, _D, _D,
            ctypes.c_int, ctypes.c_double, ctypes.c_double, ctypes.c_double,
            _D, _D,
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_double),
        ]
        lib.blaster_qp_solve_batch.restype = ctypes.c_int
        lib.blaster_qp_solve_batch.argtypes = [
            ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            _D, _D, _D, _D, _D, _D, _D, _D, _D, _D, _D, _D,
            ctypes.c_int, ctypes.c_double, ctypes.c_double, ctypes.c_double,
            _D, _D, _D, _D, _D,
        ]
        lib.rt_rate_create.restype = ctypes.c_void_p
        lib.rt_rate_create.argtypes = [ctypes.c_double]
        lib.rt_rate_destroy.restype = None
        lib.rt_rate_destroy.argtypes = [ctypes.c_void_p]
        lib.rt_rate_sleep.restype = ctypes.c_double
        lib.rt_rate_sleep.argtypes = [ctypes.c_void_p]
        lib.rt_rate_stats.restype = None
        lib.rt_rate_stats.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_double)]
        lib.rt_ring_create.restype = ctypes.c_void_p
        lib.rt_ring_create.argtypes = [ctypes.c_uint64]
        lib.rt_ring_destroy.restype = None
        lib.rt_ring_destroy.argtypes = [ctypes.c_void_p]
        lib.rt_ring_push.restype = None
        lib.rt_ring_push.argtypes = [ctypes.c_void_p, _D]
        lib.rt_ring_latest.restype = ctypes.c_uint64
        lib.rt_ring_latest.argtypes = [ctypes.c_void_p, _D]
        lib.rt_ring_drain.restype = ctypes.c_uint64
        lib.rt_ring_drain.argtypes = [ctypes.c_void_p, _D, ctypes.c_uint64]
        _lib = lib
        return _lib


def native_available() -> bool:
    try:
        load_native()
        return True
    except RuntimeError:
        return False


def _host_f64(x) -> np.ndarray:
    """A tensor (on any device) or array-like as contiguous host float64."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.ascontiguousarray(np.asarray(x, dtype=np.float64))


class NativeQPSolver:
    """CPU box-constrained OCP-QP solver (same algorithm as qp/ipm.py).

    The CPU solver by design: it takes the port's `QPData` on any device
    and solves a float64 copy on the host."""

    def __init__(self, iters: int = 12, mu0: float = 1e-1,
                 alpha_frac: float = 0.995, reg: float = 1e-9):
        self._lib = load_native()
        self.iters = iters
        self.mu0 = mu0
        self.alpha_frac = alpha_frac
        self.reg = reg

    def solve(self, data) -> Tuple[np.ndarray, np.ndarray, dict]:
        """data: a qp.data.QPData (tensors on any device, or array-likes).
        Returns (dx, du, stats) as host float64."""
        arr = _host_f64
        A, B, c = arr(data.A), arr(data.B), arr(data.c)
        N, nx, nu = A.shape[0], A.shape[1], B.shape[2]
        out_dx = np.zeros((N + 1, nx))
        out_du = np.zeros((N, nu))
        kkt_stat = ctypes.c_double()
        kkt_eq = ctypes.c_double()
        mu = ctypes.c_double()
        status = self._lib.blaster_qp_solve(
            N, nx, nu, A, B, c, arr(data.Q), arr(data.q), arr(data.R),
            arr(data.r), arr(data.lbx), arr(data.ubx), arr(data.lbu),
            arr(data.ubu), arr(data.dx0), self.iters, self.mu0,
            self.alpha_frac, self.reg, out_dx, out_du,
            ctypes.byref(kkt_stat), ctypes.byref(kkt_eq), ctypes.byref(mu))
        stats = {"status": status, "kkt_stat": kkt_stat.value,
                 "kkt_eq": kkt_eq.value, "merit_comp": mu.value}
        return out_dx, out_du, stats

    def solve_batch(self, data, n_threads: int = 0
                    ) -> Tuple[np.ndarray, np.ndarray, dict]:
        """Threaded batch solve: data fields carry a leading batch axis.

        n_threads=0 uses all hardware threads. The host-CPU analog of the
        device's scenario batch (flight computers simulating disturbance
        fans without an accelerator).
        """
        if n_threads <= 0:
            n_threads = os.cpu_count() or 1
        arr = _host_f64
        A, B, c = arr(data.A), arr(data.B), arr(data.c)
        Bn, N, nx, nu = A.shape[0], A.shape[1], A.shape[2], B.shape[3]
        out_dx = np.zeros((Bn, N + 1, nx))
        out_du = np.zeros((Bn, N, nu))
        kkt_stat = np.zeros(Bn)
        kkt_eq = np.zeros(Bn)
        mu = np.zeros(Bn)
        status = self._lib.blaster_qp_solve_batch(
            Bn, n_threads, N, nx, nu, A, B, c, arr(data.Q), arr(data.q),
            arr(data.R), arr(data.r), arr(data.lbx), arr(data.ubx),
            arr(data.lbu), arr(data.ubu), arr(data.dx0), self.iters,
            self.mu0, self.alpha_frac, self.reg, out_dx, out_du, kkt_stat,
            kkt_eq, mu)
        stats = {"status": status, "kkt_stat": kkt_stat, "kkt_eq": kkt_eq,
                 "merit_comp": mu}
        return out_dx, out_du, stats


class RateLoop:
    """Fixed-rate ticker with deadline accounting (rospy.Rate analog)."""

    def __init__(self, hz: float):
        self._lib = load_native()
        self._h = self._lib.rt_rate_create(float(hz))

    def sleep(self) -> float:
        """Block until the next tick; returns lateness in seconds."""
        return self._lib.rt_rate_sleep(self._h)

    def stats(self) -> dict:
        ticks = ctypes.c_uint64()
        misses = ctypes.c_uint64()
        worst = ctypes.c_double()
        mean = ctypes.c_double()
        self._lib.rt_rate_stats(self._h, ctypes.byref(ticks),
                                ctypes.byref(misses), ctypes.byref(worst),
                                ctypes.byref(mean))
        return {"ticks": ticks.value, "deadline_misses": misses.value,
                "worst_lateness_s": worst.value,
                "mean_lateness_s": mean.value}

    def __del__(self):
        h, self._h = getattr(self, "_h", None), None
        if h:
            self._lib.rt_rate_destroy(h)


class PoseRingBuffer:
    """Lock-free SPSC telemetry ring: [stamp, p(3), quat wxyz(4)] records."""

    RECORD = 8

    def __init__(self, capacity: int = 256):
        self._lib = load_native()
        self._h = self._lib.rt_ring_create(int(capacity))
        self.capacity = capacity

    def push(self, stamp: float, position, quat_wxyz) -> None:
        rec = np.empty(self.RECORD, dtype=np.float64)
        rec[0] = stamp
        rec[1:4] = position
        rec[4:8] = quat_wxyz
        self._lib.rt_ring_push(self._h, rec)

    def latest(self) -> Optional[np.ndarray]:
        rec = np.empty(self.RECORD, dtype=np.float64)
        seq = self._lib.rt_ring_latest(self._h, rec)
        return rec if seq else None

    def drain(self, max_records: int = 64) -> np.ndarray:
        out = np.empty((max_records, self.RECORD), dtype=np.float64)
        n = self._lib.rt_ring_drain(self._h, out.reshape(-1), max_records)
        return out[:n]

    def __del__(self):
        h, self._h = getattr(self, "_h", None), None
        if h:
            self._lib.rt_ring_destroy(h)
