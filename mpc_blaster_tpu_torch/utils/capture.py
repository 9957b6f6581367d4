"""CUDA graph capture of fixed-shape ticks: the port's `jax.jit`.

The JAX package compiles its ticks (`jax.jit(step) if jit else step`) and
runs a closed loop as one jitted `lax.scan`. Here a tick is eager PyTorch
around the hand-written kernels, and `jit` captures it as a CUDA graph:

- `jit(fn)` returns a runner. Its first call with a new key (the tensors'
  shapes, dtypes, strides and devices, and the values of the other
  arguments, which are static as `static_argnums` are in JAX) copies the
  arguments into static buffers and runs `fn` once eagerly on a side
  stream: that call does every first-use piece of host work (the nvcc
  build, the shared-memory opt-in, the launch plan) under
  `torch.cuda.set_sync_debug_mode("error")`, so a host sync anywhere in
  the tick raises; its result is the call's result. Then `fn` is
  captured into a graph in the runner's memory pool. Each later call
  copies the arguments into the static buffers, replays the graph and
  returns copies of its outputs, which the caller owns (a later call
  never overwrites them, as with `jax.jit`'s results).
- `Scan` runs `tick(consts, carry, key) -> (carry, out)` over a list of
  step keys, the counterpart of the jitted `lax.scan`: one graph per key
  (a Jacobian-reuse loop has a refresh graph and a reuse graph, chosen by
  the host's tick counter), the carry copied back into its static buffers
  inside the graph and each step's outputs written into preallocated
  `(n_steps, ...)` histories at a step counter held on the device, so the
  loop is graph replays alone, with no host sync until the end.

On CPU tensors the same buffer handling runs `fn` without a graph: that
is the caller's device, not a fallback. On CUDA tensors a capture or a
replay that fails raises; nothing falls back to eager. A replay makes no
Python call, so the kernel wrappers' launch counts are kept through
`launched`: what a capture counted is recorded and added on each replay.
`disable_jit()` runs every runner eagerly for its duration, as
`jax.disable_jit()` does (the hooks of a kernel wrapper that inspect each
call need the eager chain).
"""
from __future__ import annotations

import contextlib
import ctypes
import time
from typing import Callable, Optional

import torch
import torch.utils._pytree as pytree

# Runners run eagerly while this is above 0 (`disable_jit`).
_DISABLED = [0]
# The launch-count updates of the capture in progress (None: none is).
_RECORDING: list = [None]


@contextlib.contextmanager
def disable_jit():
    """Run every runner eagerly inside the block (`jax.disable_jit`)."""
    _DISABLED[0] += 1
    try:
        yield
    finally:
        _DISABLED[0] -= 1


def filled(values, dtype, device) -> torch.Tensor:
    """The vector of Python numbers `values`, each filled on the device: a
    captured tick makes no tensor from host data (that is a pageable copy
    to the card, which capture refuses)."""
    return torch.stack([torch.full((), v, dtype=dtype, device=device)
                        for v in values])


def launched(apply: Callable[[], None]) -> None:
    """A kernel wrapper's launch-count update: applied now, or, while a
    graph is being captured (nothing is launched), recorded and applied
    on each replay of that graph."""
    if _RECORDING[0] is not None:
        _RECORDING[0].append(apply)
    else:
        apply()


@contextlib.contextmanager
def _recording(into: list):
    prev, _RECORDING[0] = _RECORDING[0], into
    try:
        yield
    finally:
        _RECORDING[0] = prev


@contextlib.contextmanager
def _no_sync(device: torch.device):
    """A side stream that waits for the current one, under the sync debug
    mode "error"; the current stream waits for it afterwards."""
    prev = torch.cuda.get_sync_debug_mode()
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.cuda.stream(side):
            yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)
        torch.cuda.current_stream(device).wait_stream(side)


def _disjoint(t: torch.Tensor) -> bool:
    """Whether no two of t's elements share memory: a buffer can then
    take t's strides (gaps included), so a tick reads it as it would
    read t."""
    reach = 1
    for stride, size in sorted((s, n) for s, n in zip(t.stride(), t.shape)
                               if n != 1):
        if stride < reach:
            return False
        reach = stride * size
    return True


def _sig(leaf):
    if isinstance(leaf, torch.Tensor):
        return ("T", tuple(leaf.shape), leaf.dtype, leaf.device,
                tuple(leaf.stride()) if _disjoint(leaf) else None)
    return ("S", type(leaf), leaf)


def _buffer(t: torch.Tensor) -> torch.Tensor:
    """A static buffer shaped as t, with its strides where its elements
    are disjoint (else contiguous: an expanded view)."""
    if _disjoint(t):
        return torch.empty_strided(t.shape, t.stride(), dtype=t.dtype,
                                   device=t.device)
    return torch.empty(t.shape, dtype=t.dtype, device=t.device)


def _cuda_device(leaves) -> Optional[torch.device]:
    devs = {t.device for t in leaves
            if isinstance(t, torch.Tensor) and t.device.type == "cuda"}
    if len(devs) > 1:
        raise ValueError(f"a captured tick runs on one card (got {devs})")
    return devs.pop() if devs else None


def _owned(leaves):
    """Copies of the tensor leaves, the other leaves as they are."""
    return [v.clone() if isinstance(v, torch.Tensor) else v for v in leaves]


def _owned_tree(tree):
    leaves, spec = pytree.tree_flatten(tree)
    return pytree.tree_unflatten(_owned(leaves), spec)


def _graph_nodes(graph) -> Optional[int]:
    """The node count of a captured graph (None where the runtime does
    not expose it)."""
    try:
        raw = graph.raw_cuda_graph()
        cuda = ctypes.CDLL("libcuda.so.1")
    except (AttributeError, RuntimeError, OSError):
        return None
    n = ctypes.c_size_t(0)
    rc = cuda.cuGraphGetNodes(ctypes.c_void_p(raw), None, ctypes.byref(n))
    return int(n.value) if rc == 0 else None


class _Graphs:
    """The graphs of one runner: one memory pool, and what each capture
    cost (`stats`)."""

    def __init__(self):
        self.pool = None
        self.stats: list = []

    def capture(self, body: Callable, device: torch.device):
        """Capture body() into a graph (nothing runs). Returns (graph, the
        launch-count updates to apply per replay, body's result: tensors
        that each replay rewrites)."""
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        try:
            graph, kept = torch.cuda.CUDAGraph(keep_graph=True), True
        except TypeError:
            graph, kept = torch.cuda.CUDAGraph(), False
        rec: list = []
        t0 = time.perf_counter()
        with torch.cuda.device(device), _recording(rec), torch.cuda.graph(
                graph, pool=self.pool, capture_error_mode="thread_local"):
            out = body()
        capture_ms = 1e3 * (time.perf_counter() - t0)
        nodes = _graph_nodes(graph) if kept else None
        if kept and hasattr(graph, "instantiate"):
            graph.instantiate()
        self.stats.append({"capture_ms": capture_ms, "nodes": nodes,
                           "launches": len(rec)})
        return graph, rec, out

    def pool_bytes(self) -> Optional[int]:
        """Bytes the pool holds on the card (None before a capture)."""
        if self.pool is None:
            return None
        segs = torch.cuda.memory_snapshot()
        return sum(s["total_size"] for s in segs
                   if tuple(s.get("segment_pool_id", ())) ==
                   tuple(self.pool))


def _replay(graph, rec):
    graph.replay()
    for apply in rec:
        apply()


class _Captures:
    """What a runner's or a scan's captures cost: per capture its host
    ms (the capture alone; the graph's instantiation follows it), the
    graph's node count and the kernel launches it holds (`stats`), and
    the bytes of their memory pool (`pool_bytes`)."""

    def __init__(self):
        self._graphs = _Graphs()

    @property
    def stats(self) -> list:
        return self._graphs.stats

    def pool_bytes(self) -> Optional[int]:
        return self._graphs.pool_bytes()


class _Entry:
    def __init__(self, static, args, graph=None, rec=(), out=None):
        self.static, self.args = static, args
        self.graph, self.rec, self.out = graph, rec, out


class Runner(_Captures):
    """`jit(fn)`'s runner: call it as fn. `__wrapped__` is fn itself."""

    def __init__(self, fn: Callable):
        super().__init__()
        self.__wrapped__ = fn
        self._entries: dict = {}

    def __call__(self, *args):
        fn = self.__wrapped__
        if _DISABLED[0]:
            return fn(*args)
        leaves, spec = pytree.tree_flatten(args)
        key = (spec, tuple(_sig(v) for v in leaves))
        entry = self._entries.get(key)
        if entry is not None:
            for buf, v in zip(entry.static, leaves):
                if buf is not None:
                    buf.copy_(v)
            if entry.graph is None:
                return _owned_tree(fn(*entry.args))
            _replay(entry.graph, entry.rec)
            out, out_spec = entry.out
            return pytree.tree_unflatten(_owned(out), out_spec)
        static = [_buffer(v) if isinstance(v, torch.Tensor) else None
                  for v in leaves]
        for buf, v in zip(static, leaves):
            if buf is not None:
                buf.copy_(v)
        sargs = pytree.tree_unflatten(
            [v if buf is None else buf for buf, v in zip(static, leaves)],
            spec)
        device = _cuda_device(leaves)
        if device is None:
            self._entries[key] = _Entry(static, sargs)
            return _owned_tree(fn(*sargs))
        with _no_sync(device):
            first = fn(*sargs)
        result = _owned_tree(first)
        del first
        graph, rec, out = self._graphs.capture(lambda: fn(*sargs), device)
        self._entries[key] = _Entry(static, sargs, graph, rec,
                                    pytree.tree_flatten(out))
        return result


def jit(fn: Callable) -> Runner:
    """The runner of a fixed-shape tick (the module docstring)."""
    return Runner(fn)


class Scan(_Captures):
    """`lax.scan` of a tick on captured graphs (the module docstring).

    Call `scan(tick, consts, carry, keys)`: tick(consts, carry, key) ->
    (carry, out), a pytree `out` of tensors per step; `key` a hashable
    static value per step (one graph per distinct key). Returns the
    stacked outputs (each tensor leaf of `out` with a leading axis of
    len(keys)) and the last carry, both copies the caller owns. The first
    step runs eagerly on the caller's carry; the carry buffers take the
    layout of its new carry, which every later step reads, as the eager
    loop's ticks read their predecessor's outputs. A later call with the
    same shapes reuses the first call's `tick` (its closure's tensors are
    what the graphs read) and graphs."""

    def __init__(self):
        super().__init__()
        self._entries: dict = {}

    def __call__(self, tick: Callable, consts, carry, keys: list):
        if _DISABLED[0]:
            return _eager_scan(tick, consts, carry, keys)
        c_leaves, c_spec = pytree.tree_flatten(consts)
        s_leaves, s_spec = pytree.tree_flatten(carry)
        key = (len(keys), c_spec, s_spec,
               tuple(_sig(v) for v in c_leaves + s_leaves))
        st = self._entries.get(key)
        if st is None:
            st = self._entries[key] = _ScanState(tick, c_leaves, c_spec,
                                                 s_spec, len(keys))
        device = _cuda_device(c_leaves + s_leaves)
        st.load(c_leaves, device)
        for k, step_key in enumerate(keys):
            if k > 0 and step_key in st.graphs:
                _replay(*st.graphs[step_key])
                continue
            src = s_leaves if k == 0 else st.carry
            if device is None:
                st.body(step_key, src)
                continue
            with _no_sync(device):
                st.body(step_key, src)
            if step_key in keys[k + 1:] and step_key not in st.graphs:
                graph, rec, _ = self._graphs.capture(
                    lambda: st.body(step_key, st.carry), device)
                st.graphs[step_key] = (graph, rec)
        return st.results()


def _eager_scan(tick, consts, carry, keys):
    outs = []
    for step_key in keys:
        carry, out = tick(consts, carry, step_key)
        outs.append(out)
    leaves = [pytree.tree_flatten(o)[0] for o in outs]
    spec = pytree.tree_flatten(outs[0])[1]
    stacked = [torch.stack(col) for col in zip(*leaves)]
    return pytree.tree_unflatten(stacked, spec), carry


class _ScanState:
    """The static buffers of one Scan key: the constants, the carry (made
    from the first step's new carry), the histories and the device step
    counter, and the graphs per step key."""

    def __init__(self, tick, c_leaves, c_spec, s_spec, n):
        self.tick, self.n = tick, n
        self.consts = [_buffer(v) if isinstance(v, torch.Tensor) else v
                       for v in c_leaves]
        self.c_spec, self.s_spec = c_spec, s_spec
        self.carry = None
        self.hist = None
        self.out_spec = None
        self.step = None
        self.main = None     # the caller's stream (CUDA)
        self.graphs: dict = {}

    def load(self, c_leaves, device):
        for buf, v in zip(self.consts, c_leaves):
            if isinstance(buf, torch.Tensor):
                buf.copy_(v)
        if self.step is None:
            self.step = torch.zeros(1, dtype=torch.int64,
                                    device=device or "cpu")
        self.step.zero_()
        if device is not None:
            self.main = torch.cuda.current_stream(device)

    def _alloc(self, leaves, make):
        """Buffers made on the first step's (side) stream, read on the
        caller's."""
        bufs = [make(v) if isinstance(v, torch.Tensor) else v
                for v in leaves]
        if self.main is not None:
            for b in bufs:
                if isinstance(b, torch.Tensor):
                    b.record_stream(self.main)
        return bufs

    def body(self, step_key, carry_leaves):
        """One step: the tick on the static constants and `carry_leaves`,
        its outputs into the histories at the step counter, the new carry
        into the carry buffers, the counter advanced."""
        consts = pytree.tree_unflatten(self.consts, self.c_spec)
        carry = pytree.tree_unflatten(carry_leaves, self.s_spec)
        new, out = self.tick(consts, carry, step_key)
        out_leaves, out_spec = pytree.tree_flatten(out)
        new_leaves = pytree.tree_flatten(new)[0]
        if self.hist is None:
            self.hist = self._alloc(out_leaves, lambda v: torch.empty(
                (self.n,) + tuple(v.shape), dtype=v.dtype, device=v.device))
            self.out_spec = out_spec
        if self.carry is None:
            self.carry = self._alloc(new_leaves, _buffer)
        for h, v in zip(self.hist, out_leaves):
            h.index_copy_(0, self.step, v.unsqueeze(0))
        bases = {b.untyped_storage().data_ptr() for b in self.carry
                 if isinstance(b, torch.Tensor)}
        pending = []
        for buf, v in zip(self.carry, new_leaves):
            if not isinstance(buf, torch.Tensor) or v is buf:
                continue
            # a view of a carry buffer is copied out before the buffers
            # are written
            in_carry = v.untyped_storage().data_ptr() in bases
            pending.append((buf, v.clone() if in_carry else v))
        for buf, v in pending:
            buf.copy_(v)
        self.step.add_(1)

    def results(self):
        hist = pytree.tree_unflatten(_owned(self.hist), self.out_spec)
        carry = pytree.tree_unflatten(_owned(self.carry), self.s_spec)
        return hist, carry
