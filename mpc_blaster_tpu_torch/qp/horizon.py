"""Horizon ("hp") sharding of the stage axis: the port of the JAX package's
sequence parallelism over a mesh (`mpc_blaster_tpu/qp/pscan.py:1-11`,
docs/DESIGN.md's "hp" axis).

The JAX package shards the stage axis of its inputs over a mesh and lets
GSPMD partition the log-depth scans. Here the caller names the mesh (the
`mesh=` of `qp/pscan.py`'s solves and of `qp/ipm.py::box_qp_solve`), whose
axis must be "hp" (`parallel/mesh.py::make_mesh(n, axis="hp")`; a device
may repeat). The stage axis is split into contiguous chunks in stage
order, one per mesh entry and, under a `torch.distributed` process group,
in rank order across the ranks. Every chunk runs the same program on its
stages (a generator, so that the chunks of one process run in lockstep
in one thread); where stages meet, the program yields a payload and a
function, and `Horizon.run` gathers that payload from every chunk in
stage order (to the mesh's first device, then over the ranks by
`dist.all_gather`: NCCL on the card, gloo on the CPU), calls the function
on the list once per process, and hands the result back to every chunk.
Every rank computes the same function on the same list, so every value
derived from it is the same on every rank.

What crosses chunks: the totals of the sharded scans (`Chunk.scan`), the
first stage of the next chunk (`Chunk.next_first`), reductions over the
stage axis (`Chunk.reduce`), pinned quantities of the first stage
(`Chunk.bcast_first`), and whole stage arrays where a mode runs its
recursion on the whole horizon (`Chunk.whole`).

Layout. A chunk holds its stages k = s..e-1 of every per-stage array
("stage": A, B, c, R, r, lbu, ubu, du, control slacks) and of every
per-state array ("state": Q, q, lbx, ubx, dx, P); the last chunk also
holds the terminal state N. The IPM's state slacks and duals are indexed
by states 1..N in the port's QPSolution ("xs"); a chunk holds those of
its own states, and the first chunk holds a masked row for state 0 in
their place. In one process the inputs carry the whole stage axis and the
results come back on the mesh's first device with the whole stage axis;
under a process group every rank passes its own contiguous range of
stages (the last rank the terminal state, rank 0 dx0) and gets back that
range.
"""
from __future__ import annotations

from typing import Callable, List, NamedTuple, Sequence

import torch
import torch.distributed as dist

HP_AXIS = "hp"
STAGE, STATE, XS, REP = "stage", "state", "xs", "rep"


def _pack(kind, xs):
    xs = list(xs)
    return kind(*xs) if hasattr(kind, "_fields") else kind(xs)


def _tree_map(fn, tree):
    """fn on every tensor of nested tuples / lists / NamedTuples."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, (tuple, list)):
        return _pack(type(tree), (_tree_map(fn, t) for t in tree))
    return tree


def _leaves(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in _leaves(t)]
    return []


def _rebuild(tree, it):
    if isinstance(tree, torch.Tensor):
        return next(it)
    if isinstance(tree, (tuple, list)):
        return _pack(type(tree), (_rebuild(t, it) for t in tree))
    return tree


def _in_group() -> bool:
    return dist.is_available() and dist.is_initialized()


def _split_sizes(n: int, k: int) -> List[int]:
    """n stages over k chunks, as even as possible, the larger first."""
    return [n // k + (i < n % k) for i in range(k)]


class _Layout(NamedTuple):
    """Every chunk's first stage and stage count, over all ranks."""

    starts: tuple
    sizes: tuple

    @property
    def count(self) -> int:
        return len(self.sizes)

    @property
    def max_rows(self) -> int:
        return max(self.sizes) + 1


class Chunk:
    """One chunk's program context: where it lies on the stage axis and
    the exchanges with the other chunks (generators: `x = yield from
    ch.reduce(...)`). `d` is the stage axis (the number of batch axes)."""

    def __init__(self, layout: _Layout, index: int, device, d: int):
        self.layout, self.index, self.device, self.d = layout, index, device, d
        self.start, self.n = layout.starts[index], layout.sizes[index]
        self.first = index == 0
        self.last = index == layout.count - 1

    def exchange(self, payload, fn: Callable):
        """fn(every chunk's payload, in stage order), computed once per
        process."""
        return (yield payload, fn)

    def bcast_first(self, x):
        """The first chunk's x (dx0)."""
        return (yield from self.exchange(x, lambda xs: xs[0]))

    def reduce(self, xs: tuple, ops: tuple):
        """Each xs[i] reduced over the chunks by ops[i] ("sum", "min" or
        "max"): the same values on every chunk and rank."""
        def fn(parts):
            return tuple(_REDUCE[op](torch.stack(col)) for op, col in
                         zip(ops, zip(*parts)))
        return (yield from self.exchange(tuple(xs), fn))

    def next_first(self, xs: tuple):
        """The first stage row of each xs[i] on the next chunk (None on the
        last chunk), for state arrays whose row e the chunk lacks."""
        d = self.d
        firsts = tuple(x.narrow(d, 0, 1) for x in xs)
        got = yield from self.exchange(firsts, lambda fs: fs)
        return None if self.last else got[self.index + 1]

    def succ(self, x, halo):
        """Rows s+1..e of a state array x (its rows 1..n here, the next
        chunk's first row `halo` for row e)."""
        if self.last:
            return x.narrow(self.d, 1, self.n)
        return torch.cat([x.narrow(self.d, 1, self.n - 1), halo], self.d)

    def pad_terminal(self, x):
        """x (stage rows) with a zero row for the terminal state on the
        last chunk."""
        if not self.last:
            return x
        z = torch.zeros_like(x.narrow(self.d, 0, 1))
        return torch.cat([x, z], self.d)

    def scan(self, fn: Callable, elems: Sequence[torch.Tensor],
             reverse: bool = False):
        """`pscan.associative_scan(fn, elems, reverse, dim=d)` over every
        chunk's elements together: each chunk scans its own, the chunk
        totals are scanned once per process, and each chunk combines its
        elements once with the total of the chunks before it (after it,
        reversed; fn(earlier, later) in scan order, as the local scan
        calls it). Returns (this chunk's part of the scan, that carry or
        None on the chunk that has none)."""
        from mpc_blaster_tpu_torch.qp.pscan import associative_scan
        d = self.d
        kind = type(elems)
        local = associative_scan(fn, elems, reverse=reverse, dim=d)
        n = local[0].shape[d]
        total = _pack(kind, (x.narrow(d, 0 if reverse else n - 1, 1)
                             for x in local))

        def totals_scan(ts):
            cat = _pack(kind, (torch.cat(col, d) for col in zip(*ts)))
            return associative_scan(fn, cat, reverse=reverse, dim=d)
        incl = yield from self.exchange(total, totals_scan)
        j = self.index + 1 if reverse else self.index - 1
        if not 0 <= j < self.layout.count:
            return local, None
        carry = _pack(kind, (x.narrow(d, j, 1) for x in incl))
        return _pack(kind, fn(carry, local)), carry

    def rows(self, kind: str, index: int) -> int:
        n = self.layout.sizes[index]
        return n + (kind == STATE and index == self.layout.count - 1)

    def whole(self, xs: tuple, kinds: tuple, fn: Callable):
        """fn(*whole) once per process, whole[i] the concatenation of every
        chunk's xs[i] ("stage" or "state" rows) along the stage axis."""
        d, L = self.d, self.layout.max_rows

        def pad(x):
            extra = L - x.shape[d]
            shape = list(x.shape)
            shape[d] = extra
            return torch.cat([x, x.new_zeros(shape)], d)

        def gathered(parts):
            return fn(*(torch.cat([p[i].narrow(d, 0, self.rows(k, c))
                                   for c, p in enumerate(parts)], d)
                        for i, k in enumerate(kinds)))
        return (yield from self.exchange(tuple(pad(x) for x in xs),
                                         gathered))

    def stage_rows(self, x):
        """This chunk's rows of a whole stage array."""
        return x.narrow(self.d, self.start, self.n)

    def state_rows(self, x):
        return x.narrow(self.d, self.start, self.n + self.last)

    def next_rows(self, x):
        """Rows s+1..e of a whole state array."""
        return x.narrow(self.d, self.start + 1, self.n)


_REDUCE = {"sum": lambda v: v.sum(0), "min": lambda v: v.amin(0),
           "max": lambda v: v.amax(0)}


class Horizon:
    """The stage axis of one call split over `mesh` (and the ranks).

    `stages` is the number of stages this process holds, `terminal`
    whether it holds the terminal state too (None: the call has no
    per-state arrays), `d` the stage axis of its
    per-stage arrays, `like` a tensor of the call (its batch axes and
    dtype must agree over the ranks)."""

    def __init__(self, mesh, stages: int, terminal, d: int,
                 like: torch.Tensor):
        if HP_AXIS not in mesh.axis_names:
            raise ValueError(f"axis {HP_AXIS!r} not in the mesh's "
                             f"{mesh.axis_names}")
        self.devices = tuple(torch.device(x) for x in mesh.devices)
        self.d = d
        k = len(self.devices)
        if stages < k:
            raise ValueError(f"{stages} stage(s) cannot be split over the "
                             f"mesh's {k} chunks")
        self.group = _in_group()
        self.rank, world = ((dist.get_rank(), dist.get_world_size())
                            if self.group else (0, 1))
        me = (k, stages, terminal, tuple(like.shape[:d]), str(like.dtype))
        if self.group:
            infos = [None] * world
            dist.all_gather_object(infos, me)
        else:
            infos = [me]
        if any(i[3:] != me[3:] for i in infos):
            raise ValueError("the ranks' batch axes or dtypes differ: "
                             f"{[i[3:] for i in infos]}")
        if terminal is not None and [i[2] for i in infos] != [
                r == world - 1 for r in range(world)]:
            where = ("on the last rank only" if self.group else
                     "given (there is no process group)")
            raise ValueError("the terminal state (Q, q, lbx, ubx with one "
                             f"row more than A) must be {where}")
        sizes = [s for i in infos for s in _split_sizes(i[1], i[0])]
        starts = [sum(sizes[:c]) for c in range(len(sizes))]
        self.layout = _Layout(tuple(starts), tuple(sizes))
        self.offset = sum(i[0] for i in infos[:self.rank])
        self.chunk_counts = [i[0] for i in infos]
        self.chunks = [Chunk(self.layout, self.offset + i, dev, d)
                       for i, dev in enumerate(self.devices)]

    # ---- inputs and outputs ----

    def split(self, x, kind: str) -> list:
        """This process's x as one part per local chunk, on its device."""
        if x is None:
            return [None] * len(self.chunks)
        if kind == REP:
            return [x.to(ch.device) if isinstance(x, torch.Tensor) else x
                    for ch in self.chunks]
        d = self.d
        if kind == XS and self.offset == 0:
            x = torch.cat([torch.zeros_like(x.narrow(d, 0, 1)), x], d)
        out, at = [], 0
        for ch in self.chunks:
            rows = ch.n + (kind != STAGE and ch.last)
            out.append(x.narrow(d, at, rows).to(ch.device))
            at += rows
        if at != x.shape[d]:
            raise ValueError(f"a {kind} array of {x.shape[d]} rows along "
                             f"axis {d} does not match the {at} this "
                             "process's stages take")
        return out

    def join(self, parts: list, kind: str):
        """The local chunks' parts of one output, on the first device."""
        if parts[0] is None:
            return None
        out_dev = self.devices[0]
        if kind == REP:
            return parts[0]
        x = torch.cat([p.to(out_dev) for p in parts], self.d)
        if kind == XS and self.offset == 0:
            x = x.narrow(self.d, 1, x.shape[self.d] - 1)
        return x

    # ---- the lockstep run ----

    def run(self, body: Callable) -> list:
        """Run body(chunk, i) (a generator; i the local chunk's index) for
        every local chunk in lockstep; returns their results."""
        gens = [body(ch, i) for i, ch in enumerate(self.chunks)]
        sends = [None] * len(gens)
        results = [None] * len(gens)
        while True:
            reqs, done = [], 0
            for i, g in enumerate(gens):
                try:
                    reqs.append(g.send(sends[i]))
                except StopIteration as stop:
                    results[i] = stop.value
                    reqs.append(None)
                    done += 1
            if done == len(gens):
                return results
            if done:
                raise RuntimeError("the chunks of a horizon-sharded call "
                                   "left their lockstep")
            res = reqs[0][1](self._gather([r[0] for r in reqs]))
            by_dev = {self.devices[0]: res}
            for dev in self.devices:
                if dev not in by_dev:
                    by_dev[dev] = _tree_map(lambda t, dev=dev: t.to(dev), res)
            sends = [by_dev[ch.device] for ch in self.chunks]

    def _gather(self, payloads: list) -> list:
        """Every chunk's payload in stage order, on the first device."""
        dev0 = self.devices[0]
        local = [_tree_map(lambda t: t.to(dev0), p) for p in payloads]
        if not self.group:
            return local
        # NCCL gathers on the card, gloo on the host
        on = (torch.device("cuda", torch.cuda.current_device())
              if dist.get_backend() == "nccl" else torch.device("cpu"))
        leaves = [_leaves(p) for p in local]
        dtype = leaves[0][0].dtype
        flat = [torch.cat([t.reshape(-1).to(dtype) for t in ls])
                for ls in leaves]
        size = flat[0].numel()
        kmax = max(self.chunk_counts)
        buf = torch.zeros(kmax * size, dtype=dtype, device=on)
        buf[:len(flat) * size] = torch.cat(flat).to(on)
        bufs = [torch.empty_like(buf) for _ in self.chunk_counts]
        dist.all_gather(bufs, buf)
        template = leaves[0]
        out = []
        for b, k in zip(bufs, self.chunk_counts):
            b = b.to(dev0)
            for c in range(k):
                at, parts = c * size, []
                for t in template:
                    parts.append(b[at:at + t.numel()].reshape(t.shape)
                                 .to(t.dtype))
                    at += t.numel()
                out.append(_rebuild(local[0], iter(parts)))
        return out


def shard_map(mesh, body: Callable, args: tuple, kinds: tuple,
              out_kinds, d: int):
    """body(chunk, *its parts of args) on every chunk of `mesh`; args[i]
    is split by kinds[i] (a kind, or a NamedTuple / tuple of kinds for a
    NamedTuple / tuple argument, or None), and the chunks' results joined
    by `out_kinds` (the same form). The stage count and the terminal
    state are read from the first "stage" and "state" arguments. With
    mesh=None the whole stage axis is one chunk on the arguments' device
    and body(chunk, *args) runs alone: each exchange is its function on
    this chunk's payload, so no carry applies and the halos are None."""
    stage, state = _first_of(args, kinds, STAGE), _first_of(args, kinds,
                                                            STATE)
    n = stage.shape[d]
    if mesh is None:
        gen = body(Chunk(_Layout((0,), (n,)), 0, stage.device, d), *args)
        reply = None
        try:
            while True:
                payload, fn = gen.send(reply)
                reply = fn([payload])
        except StopIteration as stop:
            return stop.value
    flat = list(zip(args, kinds))
    terminal = None if state is None else state.shape[d] == n + 1
    if state is not None and state.shape[d] not in (n, n + 1):
        raise ValueError(f"state arrays of {state.shape[d]} rows against "
                         f"{n} stages")
    hz = Horizon(mesh, n, terminal, d, stage)
    parts = [_split_tree(hz, a, k) for a, k in flat]
    results = hz.run(lambda ch, i: body(ch, *(p[i] for p in parts)))
    return _join_tree(hz, results, out_kinds)


def _first_of(arg, kind, want):
    """The first tensor of `arg` whose kind is `want`, or None."""
    if arg is None or kind is None:
        return None
    if isinstance(kind, str):
        return arg if kind == want else None
    for a, k in zip(arg, kind):
        found = _first_of(a, k, want)
        if found is not None:
            return found
    return None


def _split_tree(hz: Horizon, arg, kind) -> list:
    if arg is None or kind is None:
        return [arg] * len(hz.chunks)
    if isinstance(kind, str):
        return hz.split(arg, kind)
    cols = [_split_tree(hz, a, k) for a, k in zip(arg, kind)]
    return [_pack(type(arg), (c[i] for c in cols))
            for i in range(len(hz.chunks))]


def _join_tree(hz: Horizon, results: list, kind):
    if isinstance(kind, str):
        return hz.join(results, kind)
    return _pack(type(kind), (_join_tree(hz, [r[i] for r in results], k)
                              for i, k in enumerate(kind)))


def hp_associative_scan(fn: Callable, elems: Sequence[torch.Tensor], mesh,
                        reverse: bool = False, dim: int = 0):
    """`pscan.associative_scan` with axis `dim` split over the mesh's "hp"
    chunks (and the ranks' ranges, under a process group); the result has
    the axis whole (this rank's range)."""
    kinds = (STAGE,) * len(elems)

    def body(ch, *xs):
        out, _ = yield from ch.scan(fn, _pack(type(elems), xs), reverse)
        return tuple(out)
    out = shard_map(mesh, body, tuple(elems), kinds, kinds, dim)
    return _pack(type(elems), out)
