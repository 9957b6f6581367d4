"""Build a CUDA source of `csrc/` into a shared library with nvcc.

The kernels have a plain C interface and are loaded with ctypes; each is
compiled at first use into the git-ignored `mpc_blaster_tpu_torch/build/`
for Hopper (`sm_90a`), under a name that hashes the source and the flags,
so a changed source is rebuilt and an unchanged one is not. The native
host runtime (`runtime/bindings.py`) builds its C++ sources with g++
through the same two functions.
"""
from __future__ import annotations

import hashlib
import os
import subprocess
import tempfile
import time
from pathlib import Path

BUILD_DIR = Path(__file__).resolve().parents[1] / "build"
# No --use_fast_math: the IPM kernel's f32 guards rely on IEEE division,
# square root and rounding (e.g. 1e18 + 1e7 rounds back to 1e18).
# -split-compile=0 runs the device compiler's optimizations on every CPU:
# the IPM library's 18 kernels took 225.6 s without it and 67.1 s with it
# (nvcc 12.9 on the 8 CPUs of an H100 host).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-split-compile=0", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")


def nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME); the "
                           "kernels are built with nvcc")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def library_path(sources, stem: str, flags=NVCC_FLAGS, target: str = "",
                 build_dir: Path = BUILD_DIR) -> Path:
    """Path of the built library for the current sources (one path or a
    sequence), flags and compile target."""
    h = hashlib.sha256()
    for src in _sources(sources):
        h.update(src.read_bytes())
    h.update(" ".join((*flags, target) if target else flags).encode())
    return build_dir / f"{stem}_{h.hexdigest()[:16]}.so"


def build(sources, stem: str, compiler: str | None = None, flags=NVCC_FLAGS,
          target: str = "", build_dir: Path = BUILD_DIR):
    """Compile `sources` with `compiler` (nvcc by default) into
    `build_dir` (rebuilt when a source, the flags or the target change).
    Returns (path, seconds, compiler log); seconds is 0.0 when an
    up-to-date build already existed. Raises RuntimeError with the
    compiler's output when it fails."""
    srcs = _sources(sources)
    so = library_path(srcs, stem, flags, target, build_dir)
    log = so.with_suffix(".log")
    if so.exists():
        return so, 0.0, log.read_text() if log.exists() else ""
    exe = compiler or nvcc()
    build_dir.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=build_dir)
    os.close(fd)
    try:
        t0 = time.perf_counter()
        res = subprocess.run([exe, *flags, "-o", tmp, *map(str, srcs)],
                             capture_output=True, text=True)
        secs = time.perf_counter() - t0
        text = res.stdout + res.stderr
        if res.returncode != 0:
            raise RuntimeError(
                f"{Path(exe).name} failed on "
                f"{', '.join(s.name for s in srcs)} ({res.returncode}):\n"
                f"{text}")
        log.write_text(text)
        os.replace(tmp, so)  # atomic: a concurrent build never sees half a file
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return so, secs, text


def _sources(sources) -> tuple:
    return (sources,) if isinstance(sources, Path) else tuple(sources)
