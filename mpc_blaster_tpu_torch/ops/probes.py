"""Hardware probes P1 and P2 on Hopper: the wrappers, their plain PyTorch
twins and the build of `csrc/probes.cu`.

  - P1, `smem_capacity` (twin `smem_capacity_plain`): the counterpart of
    `scripts/probe_vmem_ceiling.py::try_mb`. One block opts in to `nbytes`
    of dynamic shared memory, writes x to its first word and 2x to its
    last, and returns their sum (3x). `smem_optin_max` reads the card's
    ceiling (`cudaDevAttrMaxSharedMemoryPerBlockOptin`); a size above it
    raises RuntimeError.
  - P2, `fma_chain` (twin `fma_chain_plain`): the counterpart of
    `scripts/probe_r5_sublane.py::_chain_kernel` / `_sep_ref_kernel`.
    `steps` dependent steps of `acc = acc * x + x` from acc = y on
    (nchains, E) float32 chains, one element of every chain per thread;
    `chain_tiles` / `sep_tiles` lay the Pallas probe's tiles out so.

CUDA tensors run the kernels (each launch counted in the wrapper's
`launches`), CPU tensors the twins. Nothing falls back: a failed build or
launch raises. The library is built with nvcc at first use into the
git-ignored `build/` (`ops/nvcc_build.py`).
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from mpc_blaster_tpu_torch.ops import nvcc_build

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "probes.cu"
LANES = 128    # the Pallas probe's tile width
NCHAINS = (1, 4)


def build_library():
    """Compile `csrc/probes.cu` into `build/`. Returns (path, seconds,
    compiler log), as `ops/box_qp_ipm.py::build_library`."""
    return nvcc_build.build(SOURCE, "libprobes")


@functools.cache
def _library() -> ctypes.CDLL:
    so, _, _ = build_library()
    lib = ctypes.CDLL(str(so))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.probe_smem_optin_max.argtypes = [i32, ctypes.POINTER(i32)]
    lib.probe_smem_capacity.argtypes = [ptr, ptr, i32, ptr]
    lib.probe_fma_chain.argtypes = [ptr, ptr, ptr, i32, i32,
                                    ctypes.c_longlong, ptr]
    for fn in (lib.probe_smem_optin_max, lib.probe_smem_capacity,
               lib.probe_fma_chain):
        fn.restype = i32
    lib.probe_error_string.argtypes = [i32]
    lib.probe_error_string.restype = ctypes.c_char_p
    return lib


def _check(lib, rc: int, what: str):
    if rc != 0:
        raise RuntimeError(f"{what} failed: "
                           + lib.probe_error_string(rc).decode())


def _stream(dev: torch.device) -> int:
    with torch.cuda.device(dev):
        return torch.cuda.current_stream(dev).cuda_stream


def _device(t: torch.Tensor, name: str) -> str:
    if t.device.type not in ("cuda", "cpu"):
        raise ValueError(f"{name} runs on cuda or cpu tensors, "
                         f"not {t.device.type}")
    return t.device.type


# ------------------------------ P1 ------------------------------------------

def smem_optin_max(device=None) -> int:
    """The most dynamic shared memory one block may opt in to, in bytes
    (`cudaDevAttrMaxSharedMemoryPerBlockOptin` of a CUDA device)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        raise ValueError(f"smem_optin_max reads a CUDA device, not {dev}")
    lib = _library()
    out = ctypes.c_int(0)
    index = torch.cuda.current_device() if dev.index is None else dev.index
    _check(lib, lib.probe_smem_optin_max(index, ctypes.byref(out)),
           "cudaDeviceGetAttribute")
    return int(out.value)


def _check_nbytes(nbytes: int):
    if nbytes < 8 or nbytes % 4:
        raise ValueError(f"nbytes is a multiple of 4 of at least 8 "
                         f"(got {nbytes})")


def smem_capacity_plain(x: torch.Tensor, nbytes: int) -> torch.Tensor:
    """Twin of `smem_capacity`: the same writes and reads on a tensor of
    `nbytes`."""
    _check_nbytes(nbytes)
    big = torch.empty(nbytes // 4, dtype=torch.float32, device=x.device)
    big[0] = x[0]
    big[-1] = x[0] * 2.0
    return (big[-1] + big[0]).reshape(1)


def smem_capacity(x: torch.Tensor, nbytes: int) -> torch.Tensor:
    """P1: x (1,) float32 written to the first word of `nbytes` of shared
    memory and 2x to the last; returns their sum, (1,) float32. On a CUDA
    tensor one launch (counted in `smem_capacity.launches`); a size the
    card does not grant raises RuntimeError. On a CPU tensor the twin."""
    _check_nbytes(nbytes)
    if x.dtype != torch.float32 or tuple(x.shape) != (1,):
        raise ValueError(f"x: (1,) float32 (got {tuple(x.shape)} "
                         f"{x.dtype})")
    if _device(x, "smem_capacity") == "cpu":
        return smem_capacity_plain(x, nbytes)
    lib = _library()
    x = x.contiguous()
    out = torch.empty(1, dtype=torch.float32, device=x.device)
    _check(lib, lib.probe_smem_capacity(x.data_ptr(), out.data_ptr(),
                                        int(nbytes), _stream(x.device)),
           f"probe_smem_capacity at {nbytes} bytes")
    smem_capacity.launches += 1
    return out


smem_capacity.launches = 0


# ------------------------------ P2 ------------------------------------------

def chain_tiles(tile: torch.Tensor, nchains: int) -> torch.Tensor:
    """(rows, 128) tile -> (nchains, rows / nchains * 128): chain i is the
    i-th group of rows, as `_chain_kernel` splits them."""
    rows = tile.shape[0]
    if rows % nchains:
        raise ValueError(f"{rows} rows do not split into {nchains} chains")
    return tile.reshape(nchains, -1)


def sep_tiles(tiles) -> torch.Tensor:
    """`_sep_ref_kernel`'s separate (rows, 128) tiles, one per chain ->
    (nchains, rows * 128)."""
    return torch.stack([t.reshape(-1) for t in tiles])


def _check_chain(x, y, steps):
    if x.ndim != 2 or x.shape != y.shape or x.shape[0] not in NCHAINS:
        raise ValueError(f"x, y: (nchains in {NCHAINS}, E), equal shapes "
                         f"(got {tuple(x.shape)}, {tuple(y.shape)})")
    if steps < 0:
        raise ValueError(f"steps >= 0 (got {steps})")


def fma_chain_plain(x: torch.Tensor, y: torch.Tensor,
                    steps: int) -> torch.Tensor:
    """Twin of `fma_chain`: the recurrence one step at a time."""
    _check_chain(x, y, steps)
    acc = y.clone()
    for _ in range(steps):
        acc = acc * x + x
    return acc


def fma_chain(x: torch.Tensor, y: torch.Tensor, steps: int) -> torch.Tensor:
    """P2: `steps` dependent steps of acc = acc * x + x from acc = y, on
    x, y of shape (nchains, E), nchains 1 or 4, float32. On CUDA tensors
    one launch, one thread per element e running its nchains chains
    (counted in `fma_chain.launches`); on CPU tensors the twin."""
    _check_chain(x, y, steps)
    if x.dtype != torch.float32 or y.dtype != torch.float32 \
            or x.device != y.device:
        raise ValueError("x, y: float32 on one device")
    if _device(x, "fma_chain") == "cpu":
        return fma_chain_plain(x, y, steps)
    lib = _library()
    x, y = x.contiguous(), y.contiguous()
    out = torch.empty_like(x)
    _check(lib, lib.probe_fma_chain(x.data_ptr(), y.data_ptr(),
                                    out.data_ptr(), x.shape[0], x.shape[1],
                                    int(steps), _stream(x.device)),
           "probe_fma_chain")
    fma_chain.launches += 1
    return out


fma_chain.launches = 0
