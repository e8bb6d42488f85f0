"""Task IR: fork-join parallelism embedded in a tensor task graph.

The PyTorch/CUDA port of the task IR (the same graph the JAX package
builds): Tapir's detach/reattach/sync embedding
(Schardl et al., PPoPP'17; TapirXLA, HPEC'19).  Instead of inserting runtime
calls early (XLA's historical strategy), every node in the graph records its
*logical* parallel iteration space.  ``pdims`` are detach-able dimensions
(every index may execute concurrently — the fork); ``rdims`` are reduction
dimensions (the join carries a combiner).  A node is therefore a
``ParallelFor(pdims) { body; reduce(rdims) }`` in Tapir terms, and graph edges
are ``sync`` dependencies.

No scheduling decision (kernel choice, serialization, tiling) is
made at construction time; the pass pipeline optimizes the *parallel* graph
first, and `core.schedule` binds schedules late — the paper's central claim.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Any, Callable, Iterable, Optional

import numpy as np

# ---------------------------------------------------------------------------
# Types
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class TensorType:
    shape: tuple[int, ...]
    dtype: str  # canonical dtype string, e.g. "bfloat16", "float32", "int32"

    @property
    def size(self) -> int:
        return int(np.prod(self.shape)) if self.shape else 1

    @property
    def bytesize(self) -> int:
        return self.size * dtype_bytes(self.dtype)


def dtype_bytes(dtype: str) -> int:
    return {
        "bfloat16": 2, "float16": 2, "float32": 4, "float64": 8,
        "int8": 1, "uint8": 1, "int16": 2, "int32": 4, "int64": 8, "bool": 1,
    }[dtype]


# ---------------------------------------------------------------------------
# Nodes
# ---------------------------------------------------------------------------

#: Op vocabulary.  "Primitive" ops have plain torch lowerings.  "Library"
#: ops (matmul, attention, linear_scan, conv2d) additionally have *exposed*
#: implementations in ``repro_torch.kernels`` whose epilogues the fusion pass may
#: extend — the analogue of TapirXLA linking Tapir bitcode for Eigen routines.
PRIMITIVE_OPS = frozenset({
    "input", "const", "ew", "reduce", "reshape", "transpose", "broadcast",
    "slice", "concat", "split", "select", "iota", "convert", "softmax",
    # opaque python composite (region tracer escape hatch): lowers by calling
    # ``attrs["fn"]`` on its lowered inputs.  Keeps norms/RoPE/etc. inside a
    # single region graph without reimplementing their numerics in the IR.
    "pyfunc",
    # a value moved between mesh layouts (attrs ``src`` / ``dst`` spec
    # tuples): the lowering's rank-order all-gather and / or this rank's
    # slice (``dist.sharding.reshard_tensor``)
    "reshard",
    # stateful-buffer ops (KV cache / SSM state).  ``dynamic_slice`` reads a
    # window at a (possibly data-dependent) offset; ``dynamic_update_slice``
    # writes one and may *donate* its buffer input (``Node.donates``) so the
    # lowered program updates the cache in place; ``index`` is static basic
    # indexing (integers + slices) on a traced tensor.
    "dynamic_slice", "dynamic_update_slice", "index",
    # data-dependent indexing: the index operands are GRAPH VALUES (input
    # nids), not static attrs — per-slot cache writes and MoE top-k routing
    # stay inside the region graph instead of flushing it.  ``gather`` is
    # integer-array indexing over the leading ``n_idx`` axes
    # (``src[i0, i1, ...]``); ``scatter`` writes ``upd`` at those positions
    # (mode "set"/"add", out-of-bounds dropped) and follows the same
    # aliasing discipline as ``dynamic_update_slice``: never CSE'd, and
    # when it donates its buffer it orders after every read of the
    # pre-write buffer via anti edges (a non-donating scatter is pure
    # dataflow — its readers order through the value edge alone).
    "gather", "scatter",
})
LIBRARY_OPS = frozenset({"matmul", "attention", "linear_scan", "conv2d"})


@dataclass
class Schedule:
    """Late-bound execution decisions attached by core.schedule (never at
    graph construction)."""
    # per parallel dim: "mesh:<axis>", "grid", "serial", or "vector"
    dim_binding: dict[int, str] = field(default_factory=dict)
    tile: dict[str, int] = field(default_factory=dict)  # e.g. {"bm":128,"bn":128,"bk":512}
    serialized: bool = False          # whole node serialized (small-task)
    # Implementation choice for library ops: a candidate name from
    # ``core.schedule``'s per-op impl registry (e.g. attention ->
    # "flash_kernel" | "blockwise" | "materialized_repeat" |
    # "materialized_grouped" | "ref"), bound by ``assign_schedules`` as the
    # roofline-cost argmin over the candidates available on the target.
    # ``core.lowering`` dispatches on this field alone — no backend or
    # shape test re-derives the choice at lowering time.  "" = primitive
    # node or a graph that never went through scheduling; "opaque" = the
    # sealed per-op lowering (``assign_early_heuristics``).
    impl: str = ""
    # candidate -> estimated per-shard seconds (float), or a "n/a (...)"
    # string for candidates unavailable on the target.  Recorded by the
    # same pass for observability (``TaskGraph.dump_schedule`` /
    # ``tapir.explain``) — the argmin over the float entries is ``impl``.
    impl_costs: dict[str, Any] = field(default_factory=dict)
    # Recompute-vs-store decision for a forward node whose value the
    # backward needs: "store" (keep the activation live across the fwd/bwd
    # boundary) or "recompute" (rematerialize it in the backward).  Bound
    # by ``core.autodiff`` from the roofline arm in ``core.schedule.
    # pick_remat`` (or forced by the TrainConfig.remat policy hint).  ""
    # on nodes the backward never consumes.  Both choices are bitwise-
    # identical — the field only changes which HLO the joint graph emits,
    # so it participates in ``signature()``.
    remat: str = ""
    notes: list[str] = field(default_factory=list)


@dataclass
class Node:
    nid: int
    op: str
    inputs: tuple[int, ...]
    ttype: TensorType
    attrs: dict[str, Any] = field(default_factory=dict)
    # Fork-join structure: indices into ttype.shape (output dims) that are
    # logically parallel, and named reduction extents joined by a combiner.
    pdims: tuple[int, ...] = ()
    rdims: tuple[tuple[str, int], ...] = ()   # (name, extent)
    # Epilogue: fused elementwise tail (filled by the fusion pass on library
    # ops).  Each entry: (fn_name, extra_input_nids, attrs).
    epilogue: list[tuple[str, tuple[int, ...], dict]] = field(default_factory=list)
    # Aliasing: nid of the input buffer this node's output aliases (in-place
    # update intent).  When the aliased buffer is a graph input, the emitted
    # lowering writes it in place (``index_put_``) so the update happens without a
    # copy.  Alias-carrying nodes are never CSE'd, and ``anti`` records
    # write-after-read edges: nodes that must execute BEFORE this write
    # because they read the pre-write buffer (enforced by topo_order).
    donates: Optional[int] = None
    anti: tuple[int, ...] = ()
    # Sharding: a logical PartitionSpec-like tuple over the output dims —
    # each entry a mesh axis name, a tuple of names, or None (replicated).
    # Recorded by the tracer when model code constrains a traced value
    # (``shard_act``/``with_sharding_constraint``); every pass can see it
    # (CSE only unifies equal shardings, fusion propagates it to the node
    # that takes over producing the value) and lowering replays it as a
    # constraint under a mesh (the one-device port records none; kept so
    # graphs stay comparable with the reference).  Participates in
    # ``key()``/``signature()``.
    sharding: Optional[tuple] = None
    schedule: Schedule = field(default_factory=Schedule)

    def flops(self) -> float:
        """Logical work of this node (the cost model's W in work/span terms)."""
        if self.op == "matmul":
            # leading output dims are a batch (a 3-D weight's E among them)
            m, n = self.ttype.shape[-2], self.ttype.shape[-1]
            k = self.attrs["k"]
            batch = int(np.prod(self.ttype.shape[:-2])) if len(self.ttype.shape) > 2 else 1
            return 2.0 * batch * m * n * k
        if self.op == "conv2d":
            return 2.0 * self.ttype.size * self.attrs["k_elems"]
        if self.op == "attention":
            b, s, h, d = self.attrs["q_shape"]
            skv = self.attrs["kv_len"]
            return 4.0 * b * h * s * skv * d
        if self.op == "linear_scan":
            return 8.0 * self.ttype.size
        if self.op in ("ew", "select", "convert", "softmax"):
            return float(self.ttype.size) * (4.0 if self.op == "softmax" else 1.0)
        if self.op == "reduce":
            return float(np.prod([e for _, e in self.rdims]) * self.ttype.size)
        return 0.0

    def bytes_moved(self, update_ttype: Optional[TensorType] = None) -> float:
        """HBM traffic of a cache op (the cost model's bandwidth term).

        ``dynamic_update_slice``/``scatter``: the update's bytes when the
        buffer is donated (in-place write), else update + a full copy of
        the buffer (the lowering materializes a copy; a ``zero_init``
        scatter writes its fresh zeros buffer once, the same bytes).  ``dynamic_slice``/
        ``slice``/``index``/``gather``: the bytes of the window read."""
        if self.op in ("dynamic_update_slice", "scatter"):
            upd = update_ttype.bytesize if update_ttype is not None else 0
            if self.donates is not None:
                return float(upd)
            return float(upd + self.ttype.bytesize)
        return float(self.ttype.bytesize)   # reads: the window's bytes

    def key(self) -> tuple:
        """Structural hash key for CSE.  ``donates`` is part of the key (two
        writes with different aliasing intent are never the same value for
        buffer-reuse purposes), and so is ``sharding`` (two structurally
        identical nodes constrained to different layouts are different
        values — unifying them would silently drop one constraint);
        ``anti`` is ordering-only and excluded."""
        frozen_attrs = tuple(sorted((k, _freeze(v)) for k, v in self.attrs.items()))
        return (self.op, self.inputs, self.ttype, frozen_attrs, self.pdims,
                self.rdims, self.donates, self.sharding)


def _freeze(v):
    if isinstance(v, (list, tuple)):
        return tuple(_freeze(x) for x in v)
    if isinstance(v, dict):
        return tuple(sorted((k, _freeze(x)) for k, x in v.items()))
    if isinstance(v, np.ndarray):
        return (v.shape, str(v.dtype), v.tobytes())
    return v


# ---------------------------------------------------------------------------
# Graph
# ---------------------------------------------------------------------------


class TaskGraph:
    """A DAG of Nodes.  ``inputs`` name the graph parameters; ``outputs``
    are node ids.  Construction is pure bookkeeping — all optimization and
    scheduling happens in the pass pipeline."""

    def __init__(self, name: str = "g"):
        self.name = name
        self.nodes: dict[int, Node] = {}
        self.inputs: list[tuple[str, int]] = []   # (param name, nid)
        self.outputs: list[int] = []
        self._counter = itertools.count()
        # consumer index: nid -> set of nids that read it (inputs or epilogue
        # extras).  Built lazily, maintained incrementally by add /
        # replace_uses / add_epilogue / remove_node so fusion passes are
        # O(consumers) per rewrite instead of O(V·E).
        self._cons: Optional[dict[int, set[int]]] = None
        # the inlined ``parallel_region`` call a node was traced in (a
        # region captured inside another, as the captured training step's
        # layers are): ``scope`` while tracing, ``scopes[nid]`` after.  The
        # per-op step runs each such call as its own program, so the
        # passes must not merge work across two calls where that would
        # change a sum (``fusion.fuse_shared_input``).
        self.scope: Optional[int] = None
        self.scopes: dict[int, int] = {}

    # -- construction -------------------------------------------------------
    def add(self, op: str, inputs: Iterable[int], ttype: TensorType,
            pdims: tuple[int, ...] = (), rdims: tuple[tuple[str, int], ...] = (),
            donates: Optional[int] = None, sharding: Optional[tuple] = None,
            **attrs) -> int:
        assert op in PRIMITIVE_OPS or op in LIBRARY_OPS, f"unknown op {op}"
        nid = next(self._counter)
        inputs = tuple(inputs)
        anti: tuple[int, ...] = ()
        if donates is not None:
            # write-after-read: every existing reader of the aliased buffer
            # must execute before this in-place write.  Captured here (the
            # tracer appends nodes in program order, so "existing readers"
            # is exactly the reads that precede the write).
            anti = tuple(c for c in self._ensure_cons().get(donates, ()))
        if self.scope is not None:
            self.scopes[nid] = self.scope
        self.nodes[nid] = Node(nid, op, inputs, ttype, attrs,
                               tuple(pdims), tuple(rdims),
                               donates=donates, anti=anti,
                               sharding=tuple(sharding) if sharding else None)
        if self._cons is not None:
            self._cons[nid] = set()
            for i in inputs:
                self._cons.setdefault(i, set()).add(nid)
            for i in anti:
                self._cons.setdefault(i, set()).add(nid)
        return nid

    def add_input(self, name: str, ttype: TensorType) -> int:
        nid = self.add("input", (), ttype,
                       pdims=tuple(range(len(ttype.shape))), name=name)
        self.inputs.append((name, nid))
        return nid

    def set_outputs(self, nids: Iterable[int]) -> None:
        self.outputs = list(nids)

    # -- traversal ----------------------------------------------------------
    def _deps(self, node: Node) -> list[int]:
        deps = list(node.inputs)
        for _, extra, _ in node.epilogue:
            deps.extend(extra)
        # anti-deps: an in-place write orders after every read of its buffer
        deps.extend(node.anti)
        return deps

    def topo_order(self) -> list[int]:
        """Iterative post-order DFS from the outputs.  Region graphs can be
        thousands of nodes deep (64+ stacked blocks), so recursion would
        blow the Python stack; an explicit stack keeps the exact visit
        order of the old recursive walk."""
        seen: set[int] = set()
        order: list[int] = []
        for out in self.outputs:
            if out in seen:
                continue
            stack: list[tuple[int, bool]] = [(out, False)]
            while stack:
                nid, expanded = stack.pop()
                if expanded:
                    order.append(nid)
                    continue
                if nid in seen:
                    continue
                seen.add(nid)
                stack.append((nid, True))
                for i in reversed(self._deps(self.nodes[nid])):
                    if i not in seen:
                        stack.append((i, False))
        return order

    # -- consumer index -----------------------------------------------------
    def _ensure_cons(self) -> dict[int, set[int]]:
        if self._cons is None:
            cons: dict[int, set[int]] = {nid: set() for nid in self.nodes}
            for nid, node in self.nodes.items():
                for i in self._deps(node):
                    cons[i].add(nid)
            self._cons = cons
        return self._cons

    def consumers(self) -> dict[int, list[int]]:
        """nid -> consumer nids (one entry per consuming node, as before)."""
        cons = self._ensure_cons()
        return {nid: sorted(cons.get(nid, ())) for nid in self.nodes}

    def consumers_of(self, nid: int) -> list[int]:
        return sorted(self._ensure_cons().get(nid, ()))

    def replace_uses(self, old: int, new: int) -> None:
        cons = self._ensure_cons()
        for cid in list(cons.get(old, ())):
            node = self.nodes[cid]
            if old in node.inputs:
                node.inputs = tuple(new if i == old else i for i in node.inputs)
            if node.epilogue:
                node.epilogue = [
                    (fn, tuple(new if i == old else i for i in extra), a)
                    for fn, extra, a in node.epilogue
                ]
            if old in node.anti:
                node.anti = tuple(new if i == old else i for i in node.anti)
            if node.donates == old:
                node.donates = new
            cons.setdefault(new, set()).add(cid)
        cons[old] = set()
        self.outputs = [new if o == old else o for o in self.outputs]

    def add_epilogue(self, nid: int, fn: str, extras: tuple[int, ...],
                     attrs: dict) -> None:
        """Append an epilogue entry to ``nid``, keeping the consumer index
        consistent (the extras gain ``nid`` as a consumer)."""
        self.nodes[nid].epilogue.append((fn, tuple(extras), attrs))
        if self._cons is not None:
            for e in extras:
                self._cons.setdefault(e, set()).add(nid)

    def remove_node(self, nid: int) -> None:
        """Remove a node that no longer has consumers (cheap point removal;
        ``prune`` remains the full sweep)."""
        node = self.nodes.pop(nid)
        if self._cons is not None:
            for i in self._deps(node):
                self._cons.get(i, set()).discard(nid)
            self._cons.pop(nid, None)

    def prune(self) -> int:
        """Dead-node elimination; returns number removed."""
        live = set(self.topo_order())
        dead = [nid for nid in self.nodes if nid not in live]
        for nid in dead:
            del self.nodes[nid]
        self.inputs = [(n, i) for (n, i) in self.inputs if i in live]
        if dead:
            self._cons = None   # rebuild lazily
        return len(dead)

    def _signature_order(self) -> list[int]:
        """Deterministic node order for ``signature``: the same DFS as
        ``topo_order`` but with anti deps visited in sorted order.  ``anti``
        tuples come from set iteration, whose order can differ between two
        structurally identical graphs whose nids were merely renumbered —
        sorting makes the canonical numbering (and therefore the signature)
        invariant under monotonic renumbering and insertion order."""
        seen: set[int] = set()
        order: list[int] = []
        for out in self.outputs:
            if out in seen:
                continue
            stack: list[tuple[int, bool]] = [(out, False)]
            while stack:
                nid, expanded = stack.pop()
                if expanded:
                    order.append(nid)
                    continue
                if nid in seen:
                    continue
                seen.add(nid)
                stack.append((nid, True))
                node = self.nodes[nid]
                deps = list(node.inputs)
                for _, extra, _ in node.epilogue:
                    deps.extend(extra)
                deps.extend(sorted(node.anti))
                for i in reversed(deps):
                    if i not in seen:
                        stack.append((i, False))
        return order

    def signature(self) -> tuple:
        """Hashable structural signature (for the lowering cache and the
        on-disk program cache).  The bound ``schedule.impl`` participates:
        two graphs that scheduled the same node to different
        implementations lower differently and must not share a cache entry
        (raw pre-schedule graphs carry "" and are unaffected).  Node ids
        are CANONICALIZED to positions in a deterministic traversal, so the
        signature is a pure function of graph *structure*: renumbering the
        nids or inserting (then pruning) unrelated nodes cannot change it,
        while any change to an op, attr, sharding, aliasing, epilogue or
        impl choice must."""
        order = self._signature_order()
        pos = {nid: i for i, nid in enumerate(order)}
        parts = []
        for nid in order:
            n = self.nodes[nid]
            frozen_attrs = tuple(sorted((k, _freeze(v))
                                        for k, v in n.attrs.items()))
            parts.append((
                n.op,
                tuple(pos[i] for i in n.inputs),
                n.ttype,
                frozen_attrs,
                n.pdims,
                n.rdims,
                None if n.donates is None else pos[n.donates],
                n.sharding,
                tuple(sorted(pos[i] for i in n.anti)),
                n.schedule.impl,
                n.schedule.remat,
                tuple((fn, tuple(pos[i] for i in extra), _freeze(a))
                      for fn, extra, a in n.epilogue),
            ))
        return (self.name, tuple(parts), tuple(pos[o] for o in self.outputs),
                tuple(n for n, _ in self.inputs))

    def dump_schedule(self) -> str:
        """Human-readable schedule report: one block per library node with
        the chosen implementation, the full candidate cost table the
        impl registry evaluated (``n/a`` entries were unavailable on the
        target), and the schedule notes.  Surfaced as ``tapir.explain`` —
        the observability hook for "why did this node lower that way"."""

        def fmt(v):
            if not isinstance(v, float):
                return str(v)
            return f"{v*1e6:.1f}us" if v < 1e-3 else f"{v*1e3:.2f}ms"

        lines = [f"schedule[{self.name}]:"]
        n_lib = 0
        for nid in self.topo_order():
            n = self.nodes[nid]
            if n.op not in LIBRARY_OPS:
                continue
            n_lib += 1
            lines.append(f"  %{nid} {n.op} {n.ttype.dtype}"
                         f"{list(n.ttype.shape)} impl={n.schedule.impl or '?'}")
            if n.schedule.impl_costs:
                ranked = sorted(
                    n.schedule.impl_costs.items(),
                    key=lambda kv: (not isinstance(kv[1], float),
                                    kv[1] if isinstance(kv[1], float) else 0.0))
                lines.append("      costs: " + "  ".join(
                    f"{name}={fmt(v)}" for name, v in ranked))
            if n.schedule.tile:
                lines.append(f"      tile: {n.schedule.tile}")
            for note in n.schedule.notes:
                lines.append(f"      note: {note}")
        if n_lib == 0:
            lines.append("  (no library ops)")
        return "\n".join(lines)

    def __repr__(self) -> str:
        lines = [f"TaskGraph({self.name})"]
        for nid in self.topo_order():
            n = self.nodes[nid]
            epi = f" +epi[{','.join(fn for fn, _, _ in n.epilogue)}]" if n.epilogue else ""
            sch = f" sched={n.schedule.dim_binding}" if n.schedule.dim_binding else ""
            ali = f" donates=%{n.donates}" if n.donates is not None else ""
            ali += f" anti={list(n.anti)}" if n.anti else ""
            ali += f" sharding={list(n.sharding)}" if n.sharding else ""
            lines.append(
                f"  %{nid} = {n.op}{list(n.inputs)} :: {n.ttype.dtype}{list(n.ttype.shape)}"
                f" pdims={list(n.pdims)} rdims={list(n.rdims)}{epi}{sch}{ali}")
        lines.append(f"  outputs: {self.outputs}")
        return "\n".join(lines)
