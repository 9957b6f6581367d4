"""Build a CUDA source of `csrc/` into a shared library with nvcc.

The kernels have a plain C interface and are loaded with ctypes; each is
compiled at first use into the git-ignored `mpc_blaster_tpu_torch/build/`
for Hopper (`sm_90a`), under a name that hashes the source and the flags,
so a changed source is rebuilt and an unchanged one is not.
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
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME); the "
                           "kernels are built with nvcc")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def library_path(source: Path, stem: str) -> Path:
    """Path of the built library for the current source and flags."""
    h = hashlib.sha256(source.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{stem}_{h.hexdigest()[:16]}.so"


def build(source: Path, stem: str):
    """Compile `source` with nvcc into `build/` (rebuilt when the source or
    flags change). Returns (path, seconds, compiler log); seconds is 0.0
    when an up-to-date build already existed. Raises RuntimeError with
    the compiler's output when nvcc fails."""
    so = library_path(source, stem)
    log = so.with_suffix(".log")
    if so.exists():
        return so, 0.0, log.read_text() if log.exists() else ""
    exe = nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        t0 = time.perf_counter()
        res = subprocess.run([exe, *NVCC_FLAGS, "-o", tmp, str(source)],
                             capture_output=True, text=True)
        secs = time.perf_counter() - t0
        text = res.stdout + res.stderr
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source.name} "
                               f"({res.returncode}):\n{text}")
        log.write_text(text)
        os.replace(tmp, so)  # atomic: a concurrent build never sees half a file
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return so, secs, text
