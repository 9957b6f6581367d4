"""What a captured tick must not do, watched on the CPU.

CUDA graph capture (`mpc_blaster_tpu_torch/utils/capture.py`) refuses a
tick that makes a tensor from host data (a pageable, synchronous copy to
the card) or that waits for the card (a value read on the host, a
data-dependent shape, a linear solve that checks its result). The card
is not here, so `HostGuard` records each such call that a tick body makes
on the CPU, by name:

- through `__torch_function__`: `torch.tensor`, `torch.as_tensor` of
  anything but a tensor, `Tensor.new_tensor`, `torch.from_numpy`; the
  reads `item`, `tolist`, `numpy`, `cpu` and the conversions to bool,
  float and int; `nonzero`, `masked_select`, `unique`, `argwhere`, and
  indexing with a bool tensor;
- through `__torch_dispatch__`, the same below the Python surface:
  `aten.lift_fresh` (a tensor from data), `aten._local_scalar_dense` (a
  value read on the host), `aten._linalg_check_errors`, `aten.nonzero`,
  `aten.is_nonzero`, `aten.equal`.
"""
import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode

_FUNCTIONS = {"tensor", "new_tensor", "from_numpy", "item", "tolist",
              "numpy", "cpu", "__bool__", "__float__", "__int__",
              "__index__", "nonzero", "masked_select", "unique",
              "argwhere"}
_OPS = {"aten.lift_fresh.default", "aten.lift_fresh_copy.default",
        "aten._local_scalar_dense.default",
        "aten._linalg_check_errors.default", "aten.nonzero.default",
        "aten.is_nonzero.default", "aten.equal.default"}


def _bool_index(idx) -> bool:
    items = idx if isinstance(idx, tuple) else (idx,)
    return any(isinstance(i, torch.Tensor) and i.dtype == torch.bool
               for i in items)


class _Functions(TorchFunctionMode):
    def __init__(self, seen):
        super().__init__()
        self.seen = seen

    def __torch_function__(self, func, types, args=(), kwargs=None):
        name = getattr(func, "__name__", str(func))
        if name in _FUNCTIONS or (
                name == "as_tensor" and args
                and not isinstance(args[0], torch.Tensor)) or (
                name in ("__getitem__", "__setitem__") and len(args) > 1
                and _bool_index(args[1])):
            self.seen.append(name)
        return func(*args, **(kwargs or {}))


class _Ops(TorchDispatchMode):
    def __init__(self, seen):
        super().__init__()
        self.seen = seen

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if str(func) in _OPS:
            self.seen.append(str(func))
        return func(*args, **(kwargs or {}))


class HostGuard:
    """`with HostGuard() as seen:` runs the block and lists in `seen` the
    calls a captured tick cannot make (the module docstring)."""

    def __enter__(self):
        self.seen = []
        self._modes = (_Functions(self.seen), _Ops(self.seen))
        for m in self._modes:
            m.__enter__()
        return self.seen

    def __exit__(self, *exc):
        for m in reversed(self._modes):
            m.__exit__(*exc)
        return False
