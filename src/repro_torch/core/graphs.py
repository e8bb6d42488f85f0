"""Region programs replayed as CUDA graphs — the port's counterpart of the
reference running each region program under one ``jax.jit`` with its
cache inputs donated (``_positional_jit``) and replaying that executable
from ``_PROGRAMS``.

``core.lowering.emit`` turns a region into a Python program that
dispatches every torch op from the host.  Where the schedule predicts
that dispatch, not the card, bounds the region
(``core.schedule.dispatch_bound``), :class:`GraphCache` records the
program once as a ``torch.cuda.CUDAGraph`` and replays it.  Only a
program that writes one of its inputs in place (a KV pool, a state slab)
is captured: every graph is then keyed by the cache it writes, and dies
with it.  The policy:

* **first sighting** of a program at a given set of inputs: the program
  runs eagerly (which also warms the allocator and the kernels' one-time
  attribute setters) and the inputs are remembered by weak reference;
* **second sighting**: the inputs are sorted.  An input that is the same
  tensor as at an earlier sighting (same base tensor, still alive, same
  view) is **persistent**: weights, KV pools, the page table, positions,
  RoPE tables.  One whose earlier tensor is gone is **transient**: the
  activation.  An earlier sighting whose tensor at some position is a
  DIFFERENT live tensor belongs to another call site (another layer) and
  is not a match, and neither is one where an input the program writes
  in place (a KV pool) was another tensor: that is another cache.  The
  graph is captured with a static buffer per
  transient input and keyed by the program key plus the addresses of the
  persistent inputs;
* **later calls** copy their transient inputs into the buffers and
  replay.

The contract is the reference's: a region returns tensors its caller owns.
An output that IS one of the inputs (a donated KV pool written in place)
comes back as the caller's own tensor; every other output is cloned out
of the graph's pool, so it stays valid across later replays.

A graph whose persistent input dies is evicted (a finished serving run
drops its cache, and the graphs keyed on its pools or slabs go with it,
whatever its prompt lengths were).
Each replay adds to the kernel wrappers' launch counts what the capture's
Python added to them, so the counts stay true; the replay right after a
capture adds nothing, since the capture itself counted.

Under grad mode a program whose inputs require grad always runs eagerly:
autograd records the eager run, and a replay would record nothing (the
training step never replays a graph).

A capture or a replay that fails raises: nothing falls back to the eager
walk.  The capture and replay themselves live behind a small backend
(:class:`CudaGraphs`) so the policy can be tested on the CPU with a fake.
"""
from __future__ import annotations

import collections
import functools
import time
import weakref
from typing import Any, Callable, Optional, Sequence

import torch

from ..kernels.flash_attention import ops as fa_ops
from ..kernels.fused_matmul import ops as fm_ops
from ..kernels.linear_scan import ops as ls_ops

#: the kernel wrappers whose launch counts a replay advances
KERNEL_COUNTERS = (fm_ops, fa_ops, ls_ops)
#: the counts a wrapper may keep (an int or a Counter each): its forward
#: launches, its backward's (a captured training step replays those too)
#: and its autograd Function's calls
COUNTS = ("launches", "launches_by_shape", "bwd_launches",
          "bwd_launches_by_shape", "function_calls")


def _snapshot(m) -> dict:
    out = {}
    for a in COUNTS:
        v = getattr(m, a, None)
        if v is not None:
            out[a] = collections.Counter(v) \
                if isinstance(v, collections.Counter) else v
    return out


def _advance(m, delta: dict) -> None:
    for a, d in delta.items():
        if isinstance(d, collections.Counter):
            getattr(m, a).update(d)
        else:
            setattr(m, a, getattr(m, a) + d)

#: earlier sightings kept per program key (enough for every layer of a
#: model that shares one block program, and then some)
MAX_SIGHTINGS = 256


def _base(t: torch.Tensor) -> torch.Tensor:
    return t._base if t._base is not None else t


def _view(t: torch.Tensor) -> tuple:
    """Where and how a tensor lies: what a captured graph reads."""
    return (t.data_ptr(), tuple(t.shape), t.stride(), t.dtype, t.device)


class _Sighting:
    """One eager run's inputs, held weakly."""
    __slots__ = ("refs", "views")

    def __init__(self, vals: Sequence[torch.Tensor]):
        self.refs = [weakref.ref(_base(v)) for v in vals]
        self.views = [_view(v) for v in vals]

    def persistent(self, vals: Sequence[torch.Tensor],
                   written: frozenset) -> Optional[tuple]:
        """The positions where ``vals`` repeat this sighting's tensors, or
        None when a position holds a different LIVE tensor (another call
        site) or a written position holds another tensor (another
        cache)."""
        same = []
        for j, v in enumerate(vals):
            old = self.refs[j]()
            if old is _base(v) and self.views[j] == _view(v):
                same.append(j)
            elif old is not None or j in written:
                return None
        return tuple(same)


class _Graph:
    """One captured program: the graph, a static buffer per transient
    input, where each output comes from, and the launch counts the
    capture added."""

    def __init__(self, handle, static: list, outs: list, counts: list):
        self.handle = handle
        self.static = static          # per input: buffer, or None if persistent
        self.outs = outs              # per output: ("in", j) or ("pool", tensor)
        self.counts = counts          # per counter: what the capture added
        self.refs: list = []          # weakrefs (with eviction callbacks)


class CudaGraphs:
    """Capture and replay with ``torch.cuda.CUDAGraph``, captured on a side
    stream per device (a stream under capture must not be the legacy
    default stream), replayed on the current stream.

    The live graphs of a device share one memory pool: a capture reuses
    the blocks that earlier captures freed (their intermediates), so the
    pool holds one program's working set plus every graph's outputs, not
    a working set per graph (a qwen2.5-3b decode block's includes the
    90 MB weight concat of its fused gate|up GEMM).  Sharing is sound here
    because graphs never run concurrently (one stream) and every graph's
    outputs stay allocated for its life and are cloned right after its
    replay, before any other graph runs.  A pool whose graphs are all
    released cannot take another capture: the next capture opens a new
    one."""

    def __init__(self):
        self._streams: dict = {}
        self._pools: dict = {}      # device -> (pool handle, live graphs)
        self._bytes = 0             # graph-pool segments after the last capture

    @property
    def pool_bytes(self) -> int:
        """Bytes of the allocator's segments in the live graph pools (read
        at the last capture: replays allocate nothing)."""
        return self._bytes if self._pools else 0

    def accepts(self, vals: Sequence[torch.Tensor]) -> bool:
        return bool(vals) and all(v.device.type == "cuda" for v in vals)

    def _stream(self, device: torch.device) -> torch.cuda.Stream:
        s = self._streams.get(device)
        if s is None:
            s = self._streams[device] = torch.cuda.Stream(device)
            # cuBLAS makes its handle's workspace for a stream at the
            # stream's first product: make it here, not inside a capture
            with torch.cuda.stream(s):
                for dt in (torch.float32, torch.bfloat16):
                    a = torch.ones((2, 8, 8), dtype=dt, device=device)
                    torch.bmm(a, a)
                    torch.mm(a[0], a[0])
            s.synchronize()
        return s

    def capture(self, fn: Callable[[dict], tuple], inputs: dict,
                device: torch.device):
        """(handle, outputs) of ``fn(inputs)`` captured; nothing runs on
        the card."""
        with torch.cuda.device(device):
            stream = self._stream(device)
            torch.cuda.synchronize()
            pool, live = self._pools.get(device) or (
                torch.cuda.graph_pool_handle(), 0)
            graph = torch.cuda.CUDAGraph()
            stream.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(stream):
                graph.capture_begin(pool=pool)
                try:
                    outs = fn(inputs)
                except BaseException:
                    try:
                        graph.capture_end()
                    except RuntimeError:
                        pass   # the capture is void: the first error stands
                    raise
                graph.capture_end()
            torch.cuda.current_stream().wait_stream(stream)
            self._pools[device] = (pool, live + 1)
            # a released pool's segments stay cached until the allocator
            # needs them back: count the live pools' alone
            live_ids = {tuple(p) for p, _ in self._pools.values()}
            self._bytes = sum(
                seg["total_size"] for seg in torch.cuda.memory_snapshot()
                if tuple(seg["segment_pool_id"]) in live_ids)
            return (graph, device), outs

    def replay(self, handle) -> None:
        handle[0].replay()

    def release(self, handle) -> None:
        """The graph is dropped: the last of a pool takes the pool along."""
        pool, live = self._pools[handle[1]]
        if live > 1:
            self._pools[handle[1]] = (pool, live - 1)
        else:
            del self._pools[handle[1]]


class GraphCache:
    """Captured region programs by program key and persistent-input
    addresses (see the module docstring for the policy)."""

    def __init__(self, backend=None, counters: Sequence = KERNEL_COUNTERS):
        self.backend = backend if backend is not None else CudaGraphs()
        self.counters = counters
        self._graphs: dict[Any, dict[tuple, dict[tuple, _Graph]]] = {}
        self._seen: dict[Any, collections.deque] = {}
        self.stats = collections.Counter()

    # -- the one entry point ------------------------------------------------
    def run(self, key, fn: Callable[[dict], tuple], inputs: dict,
            capture: bool, written: frozenset = frozenset()) -> tuple:
        """``fn(inputs)``'s outputs: eagerly, or through a graph of ``fn``.
        ``capture``: the schedule's verdict for this program (dispatch-
        bound); ``written``: the input names the program writes in place
        (a program that writes none runs eagerly)."""
        names = list(inputs)
        vals = [inputs[n] for n in names]
        if not (capture and written) or not self.backend.accepts(vals):
            return fn(inputs)
        if torch.is_grad_enabled() and any(v.requires_grad for v in vals):
            # autograd records the eager run; a replay would record nothing
            return fn(inputs)
        for mask, table in list(self._graphs.get(key, {}).items()):
            g = table.get(tuple(_view(vals[j]) for j in mask))
            if g is not None:
                return self._replay(g, vals, count=True)
        seen = self._seen.setdefault(key, collections.deque())
        wpos = frozenset(j for j, n in enumerate(names) if n in written)
        best, best_i = None, -1
        for i, s in enumerate(seen):
            mask = s.persistent(vals, wpos)
            if mask is not None and (best is None or len(mask) >= len(best)):
                best, best_i = mask, i
        if best is None:
            self.stats["eager"] += 1
            seen.append(_Sighting(vals))
            if len(seen) > MAX_SIGHTINGS:
                seen.popleft()
            return fn(inputs)
        del seen[best_i]
        g = self._capture(key, fn, names, vals, best)
        return self._replay(g, vals, count=False)

    # -- capture / replay -----------------------------------------------------
    def _capture(self, key, fn, names, vals, mask) -> _Graph:
        keep = set(mask)
        static = [None if j in keep else v.clone()
                  for j, v in enumerate(vals)]
        args = [v if s is None else s for v, s in zip(vals, static)]
        before = [_snapshot(m) for m in self.counters]
        t0 = time.perf_counter()
        handle, outs = self.backend.capture(fn, dict(zip(names, args)),
                                            vals[0].device)
        self.stats["capture_s"] += time.perf_counter() - t0
        counts = [{a: _snapshot(m)[a] - v for a, v in b.items()}
                  for m, b in zip(self.counters, before)]
        where = []
        for o in outs:
            j = next((j for j, a in enumerate(args) if o is a), None)
            where.append(("in", j) if j is not None else ("pool", o))
        g = _Graph(handle, static, where, counts)
        gkey = tuple(_view(vals[j]) for j in mask)
        evict = functools.partial(self._evict, key, mask, gkey, g)
        g.refs = [weakref.ref(_base(vals[j]), evict) for j in mask]
        self._graphs.setdefault(key, {}).setdefault(mask, {})[gkey] = g
        self.stats["captures"] += 1
        return g

    def _replay(self, g: _Graph, vals, count: bool) -> tuple:
        for s, v in zip(g.static, vals):
            if s is not None:
                s.copy_(v)
        self.backend.replay(g.handle)
        if count:
            for m, delta in zip(self.counters, g.counts):
                _advance(m, delta)
        self.stats["replays"] += 1
        return tuple(vals[x] if kind == "in" else x.clone()
                     for kind, x in g.outs)

    def _evict(self, key, mask, gkey, g, _ref=None) -> None:
        table = self._graphs.get(key, {}).get(mask)
        if table is not None and table.get(gkey) is g:
            del table[gkey]
            g.refs = []    # the callbacks hold the graph: let it go now
            self.backend.release(g.handle)
            self.stats["evictions"] += 1

    # -- introspection ------------------------------------------------------
    def graphs(self) -> list[_Graph]:
        return [g for masks in list(self._graphs.values())
                for table in list(masks.values()) for g in table.values()]

    def summary(self) -> dict:
        return {"graphs": len(self.graphs()),
                "graph_pool_bytes": self.backend.pool_bytes,
                "graph_captures": self.stats["captures"],
                "graph_replays": self.stats["replays"],
                "graph_evictions": self.stats["evictions"],
                "graph_capture_s": float(self.stats["capture_s"])}

    def drop(self, pred: Callable[[Any], bool]) -> int:
        """Release every graph (and sighting) of the program keys ``pred``
        accepts; returns the number of graphs released."""
        n = 0
        for key in [k for k in self._graphs if pred(k)]:
            for table in self._graphs.pop(key).values():
                for g in table.values():
                    g.refs = []
                    self.backend.release(g.handle)
                    n += 1
        for key in [k for k in self._seen if pred(k)]:
            del self._seen[key]
        return n

    def clear(self) -> None:
        for g in self.graphs():
            g.refs = []
            self.backend.release(g.handle)
        self._graphs.clear()
        self._seen.clear()
        self.stats.clear()


#: the process's graph cache (``tapir.clear_cache`` empties it)
CACHE = GraphCache()
