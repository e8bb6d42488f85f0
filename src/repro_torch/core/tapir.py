"""Public op layer: models call these; each call builds a Task IR graph,
runs the pass pipeline (cached), and executes the lowered program.

The port of the JAX package's ``core/tapir.py`` (the part slot serving
needs).  Two execution regimes, as there:

* **Per-op** — each public op builds, optimizes, caches and runs its own
  TaskGraph; no pass ever sees more than one op.
* **Region capture** — under ``@parallel_region`` the same public ops
  *trace*: they return lazy :class:`TracedTensor` handles and append nodes
  to one region-wide TaskGraph.  At region exit the merged graph runs the
  full pass pipeline (CSE, added-GEMM fusion, shared-input fusion, epilogue
  fusion, late scheduling) across every op in the region, is emitted once
  as a Python callable over torch ops, cached by structural signature, and
  executed.  Structurally repeated calls replay through ``_PROGRAMS``
  without re-tracing.

"Compile" here means emitting that callable: PyTorch runs eagerly, so a
region program is one Python function that launches the region's kernels
in topological order.  Donation becomes an in-place write into the
region-input tensor (see ``core.lowering``): a KV pool passed into a slot
body comes back as the SAME tensor object, updated.  A region program the
schedule finds dispatch-bound (``core.schedule.dispatch_bound``) that
writes an input in place replays on CUDA inputs as one CUDA graph
(``core.graphs``), the counterpart of the reference's one ``jax.jit`` per
region; the per-op control (``mode="opaque"``) always runs eagerly.

Training, per op: the region programs run eagerly under autograd (a
program whose inputs require grad is never replayed as a CUDA graph and
never writes an input in place), and ``scan_layers`` takes the config's
``remat``: ``"full"`` recomputes each layer in the backward
(``torch.utils.checkpoint``), as the reference's ``jax.checkpoint`` does.
Training, captured (``train/region_step.py``): the whole step is one
region; ``core.autodiff`` derives the backward as nodes of it, and the
remat policy (``"auto"``, ``"none"``, ``"full"``, ``"dots"``) becomes a
per-node schedule decision (``core.schedule.pick_remat``), reported by
``explain()``'s "== gradient programs ==" section.

The paper's ops: ``lstm_step`` builds the cell the way stock XLA emitted
it (eight slice-fed GEMMs), which tapir mode's fusions collapse into one;
``conv2d`` is an NHWC / HWIO library op with an open epilogue, lowered to
im2col and the GEMM kernel; ``elemwise`` is one unary ``ew`` node.

The on-disk program cache (L2, ``repro_torch.cache``): with
``TapirConfig.program_cache_dir`` set, a region program that misses the
in-memory cache probes the store before the pass pipeline runs.  A
verified hit rebuilds the stored optimized graph, its callables rebound to
the live traced graph's, and emits from it: the pipeline is skipped, and
the program, its CUDA-graph verdict and its in-place writes are those a
compile gives.  A miss compiles and publishes.  A store fault costs a
compile, never an answer: it is quarantined and counted
(``l2_quarantined``, ``l2_fallbacks``).

The MoE ops: ``scatter_new`` is the dispatch (a scatter into a fresh zeros
buffer, ``zero_init``), ``expert_mlp`` the expert FFN over ``[E, C, d]``
with 3-D weights, whose GEMMs lower to the kernel's grouped route in tapir
mode and to one 2-D launch per expert in opaque mode.

Meshes: every cache key ends with the ambient mesh's fingerprint
(``passes.mesh_fingerprint``), and ``invalidate_mesh`` purges one
fingerprint's programs from memory and from every attached store.  Under
explicit SPMD a region traces the rank's blocks; ``annotate_sharding`` /
``reshard`` (through ``dist.shard_act``) record the layout of a value, or
a ``reshard`` node the lowering runs as a slice or a rank-order
all-gather; a GEMM whose activation holds a block of the weight's K rows
(the column-sharded gate|up before a replicated down projection) gathers
it first.  Concrete tensors carry their layout as an attribute
(``SPEC_ATTR``): a region input's node takes it, a region output gets its
node's.
"""
from __future__ import annotations

import functools
import itertools
import threading
import time
import weakref
from dataclasses import dataclass
from typing import Any, Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.utils.checkpoint

from ..cache.disk import check_cache_mode
from . import graphs
from .dtypes import dtype_name, to_torch_dtype
from .ir import TaskGraph, TensorType
from .lowering import (_EW, conv2d_out_hw, dynamic_slice_clamped,
                       dynamic_update_slice_clamped, emit, gather_clamped,
                       holds_collective, scatter_drop, written_inputs)
from .passes import mesh_fingerprint, mesh_has_model_axis, run_pipeline
from .schedule import (CPU_COST_MODEL, H100_COST_MODEL, CostModel,
                       dispatch_bound)

#: the attribute a concrete tensor carries its mesh layout (a spec tuple)
#: under: set by ``shard_act``, the engine's placement and region outputs
SPEC_ATTR = "_mesh_spec"

# ---------------------------------------------------------------------------
# Config
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class TapirConfig:
    mode: str = "tapir"                  # "tapir" | "opaque"
    #: None: the H100 model when a card is present, else the CPU model
    cost_model: Optional[CostModel] = None
    #: region capture; False runs every op in the per-op regime (the A/B
    #: control)
    regions: bool = True
    #: the remat policy: eagerly under grad ``scan_layers`` keeps every
    #: layer's activations ("none") or recomputes each layer in the
    #: backward ("full"); "auto" and "dots" are policies of the captured
    #: step's ``pick_remat`` only
    remat: str = "none"
    #: tapir mode schedules with no small-task serialization (grain 0):
    #: the paper's ablation of that pass
    ablate_serialization: bool = False
    #: on-disk program store (L2, ``repro_torch.cache``); None keeps
    #: programs in memory only (every process compiles its own)
    program_cache_dir: Optional[str] = None
    #: "off" | "read" (probe, never publish nor quarantine) | "readwrite"
    cache_mode: str = "readwrite"

    def __post_init__(self):
        if self.remat not in ("none", "full", "dots", "auto"):
            raise ValueError(f"remat must be 'none', 'full', 'dots' or "
                             f"'auto', got {self.remat!r}")
        check_cache_mode(self.cache_mode)

    def resolved_cost_model(self) -> CostModel:
        if self.cost_model is not None:
            return self.cost_model
        return H100_COST_MODEL if torch.cuda.is_available() \
            else CPU_COST_MODEL


_tls = threading.local()


def get_config() -> TapirConfig:
    return getattr(_tls, "cfg", TapirConfig())


class use:
    """``with tapir.use(cfg):`` — the active config for ops on this thread."""

    def __init__(self, cfg: TapirConfig):
        self.cfg = cfg

    def __enter__(self):
        self._prev = getattr(_tls, "cfg", None)
        _tls.cfg = self.cfg
        return self.cfg

    def __exit__(self, *exc):
        if self._prev is None:
            del _tls.cfg
        else:
            _tls.cfg = self._prev
        return False


# ---------------------------------------------------------------------------
# Graph build/execute machinery
# ---------------------------------------------------------------------------

class _Program(NamedTuple):
    """An emitted program and, for a region's, whether it replays as a CUDA
    graph on CUDA inputs and the input names it may write in place."""
    fn: Callable[[dict], tuple]
    graphed: bool = False
    written: frozenset = frozenset()


_CACHE: dict[tuple, _Program] = {}
_CACHE_STATS = {
    "hits": 0, "misses": 0, "compiled_programs": 0,
    # seconds: tracing region bodies; building programs (the pipeline and
    # emit, or an L2 load); of those, the L2 tier's own (probe, rebuild,
    # emit on a hit; encode and publish after a compile)
    "trace_s": 0.0, "pipeline_s": 0.0, "l2_s": 0.0,
    # L2 (on-disk) tier outcomes, summed over every active store
    "l2_hits": 0, "l2_misses": 0, "l2_quarantined": 0, "l2_writes": 0,
    # programs loaded from L2 whose emit or first call raised and that were
    # replaced by a fresh compile (a store fault cost a compile, not an
    # answer)
    "l2_fallbacks": 0,
}
#: optimized graphs by cache key — introspection for tests and explain()
_GRAPHS: dict[tuple, TaskGraph] = {}
#: where each L1 entry came from (compiled, published, or the disk), keyed
#: like ``_CACHE`` — surfaced by ``explain``
_PROVENANCE: dict[tuple, dict] = {}
#: ProgramDiskCache instances by (dir, mode), shared so stats accumulate
_L2_INSTANCES: dict[tuple, Any] = {}


def _tt(x) -> TensorType:
    return TensorType(tuple(x.shape), dtype_name(x.dtype))


def _cfg_key(cfg: TapirConfig) -> tuple:
    # the last three stay (mode, cost model, mesh): introspection reads
    # them from the end of a key
    return (cfg.ablate_serialization, cfg.mode,
            cfg.resolved_cost_model().name, mesh_fingerprint())


def _layout_context() -> tuple:
    """Under a mesh, the logical sizes ``dist.shard_act`` reads layouts
    off: the same block shapes mean other layouts (a batch of 1 whole, or
    one rank's row of 2), so a replay key carries them.  ``()`` with no
    mesh."""
    if not mesh_fingerprint():
        return ()
    from ..dist.sharding import current_sizes
    return tuple(sorted(current_sizes().items()))


def _graphed(g: TaskGraph, cfg: TapirConfig) -> bool:
    """A region program's CUDA-graph verdict (``core.graphs``): never one
    that holds a collective (gloo runs it on the host, outside any
    stream a graph could capture)."""
    return (cfg.mode == "tapir" and not holds_collective(g)
            and dispatch_bound(g, cfg.resolved_cost_model()))


def _build(g: TaskGraph, cfg: TapirConfig, key: tuple,
           region: bool) -> _Program:
    """Run the pipeline on ``g`` (in place) and emit it."""
    g = run_pipeline(g, cfg.mode, cfg.resolved_cost_model(),
                     ablate_serialization=cfg.ablate_serialization)
    prog = _Program(emit(g))
    if region:
        _CACHE_STATS["compiled_programs"] += 1
        prog = prog._replace(graphed=_graphed(g, cfg),
                             written=written_inputs(g))
    _GRAPHS[key] = g
    return prog


def _compile(g: TaskGraph, cfg: TapirConfig, key: tuple,
             region: bool = False) -> _Program:
    """Pipeline + emit with cache bookkeeping (shared by per-op + region).

    For a region program this is also the L2 integration point: with a
    store configured, probe it BEFORE the pipeline runs (a verified hit
    skips the pipeline), and publish a fresh compile."""
    t0 = time.perf_counter()
    l2 = _l2_for(cfg) if region else None
    if l2 is not None:
        digest = _l2_digest(key, cfg)
        prog = _l2_load(l2, digest, g, cfg, key)
        if prog is not None:
            _CACHE_STATS["pipeline_s"] += time.perf_counter() - t0
            _CACHE_STATS["l2_s"] += time.perf_counter() - t0
            _CACHE[key] = prog
            return prog
        # the pipeline rewrites g in place: take its objects first
        from ..cache.disk import object_refs
        refs = object_refs(g)
        _CACHE_STATS["l2_s"] += time.perf_counter() - t0
    prog = _build(g, cfg, key, region)
    if l2 is not None:
        t_l2 = time.perf_counter()
        published = _l2_publish(l2, digest, _GRAPHS[key], refs, prog)
        _PROVENANCE[key] = {
            "name": _GRAPHS[key].name, "digest": digest,
            "source": "compiled+published" if published else "compiled"}
        _CACHE_STATS["l2_s"] += time.perf_counter() - t_l2
    _CACHE_STATS["pipeline_s"] += time.perf_counter() - t0
    _CACHE[key] = prog
    return prog


# ---------------------------------------------------------------------------
# The on-disk tier (L2)
# ---------------------------------------------------------------------------


def _l2_for(cfg: TapirConfig):
    """The active on-disk store for ``cfg``, or None when disabled."""
    if not cfg.program_cache_dir or cfg.cache_mode == "off":
        return None
    from ..cache import ProgramDiskCache
    k = (cfg.program_cache_dir, cfg.cache_mode)
    l2 = _L2_INSTANCES.get(k)
    if l2 is None:
        l2 = _L2_INSTANCES[k] = ProgramDiskCache(cfg.program_cache_dir,
                                                 cfg.cache_mode)
    return l2


def _l2_digest(key: tuple, cfg: TapirConfig) -> str:
    """Cross-process content digest of an L1 key: the canonical graph
    signature and config the key carries, the cost model's every field,
    salted with torch, CUDA, the device kind, the kernels' sources, the
    pipeline salt and the format (``cache.disk._versions``): a graph
    optimized by another compiler, for another device or other kernels
    must never hit."""
    from ..cache import FORMAT_VERSION, PIPELINE_VERSION, stable_digest
    from ..cache.disk import _versions
    return stable_digest(("tapir-program", FORMAT_VERSION, PIPELINE_VERSION,
                          _versions(), cfg.resolved_cost_model(), key))


def _quarantine(l2, digest: str, reason: str) -> None:
    q0 = l2.stats["quarantined"]
    l2.quarantine(digest, reason)       # a no-op in read mode
    _CACHE_STATS["l2_quarantined"] += l2.stats["quarantined"] - q0


def _l2_load(l2, digest: str, g: TaskGraph, cfg: TapirConfig,
             key: tuple) -> Optional[_Program]:
    """Verified L2 probe: rebuild the stored graph against the objects of
    the raw graph ``g`` (untouched: the pipeline has not run on it), check
    its signature and verdicts against the sidecar and this process's own
    reading of them, and emit it.  A graph that fails is quarantined (in
    readwrite mode) and None returned: the caller compiles."""
    from ..cache import stable_digest
    from ..cache.disk import object_refs, rebuild_graph
    q0 = l2.stats["quarantined"]
    got = l2.get(digest)
    _CACHE_STATS["l2_quarantined"] += l2.stats["quarantined"] - q0
    if got is None:
        _CACHE_STATS["l2_misses"] += 1
        return None
    payload, meta = got
    try:
        lg, graphed, written = rebuild_graph(payload, object_refs(g))
        if (stable_digest(lg.signature()) != meta.get("graph_signature")
                or written != written_inputs(lg)
                or graphed != _graphed(lg, cfg)):
            raise ValueError("the stored graph does not match its sidecar")
    except Exception:
        _quarantine(l2, digest, "graph-mismatch")
        _CACHE_STATS["l2_misses"] += 1
        return None
    try:
        fn = emit(lg)
    except Exception:
        _quarantine(l2, digest, "emit-failed")
        _CACHE_STATS["l2_fallbacks"] += 1
        return None
    _CACHE_STATS["l2_hits"] += 1
    _GRAPHS[key] = lg
    _PROVENANCE[key] = {"name": lg.name, "digest": digest, "source": "disk"}
    return _Program(_guarded(fn, l2, digest, g, cfg, key, written),
                    graphed, written)


def _version_of(t) -> Optional[int]:
    try:
        return t._version
    except (AttributeError, RuntimeError):
        return None


def _guarded(fn: Callable, l2, digest: str, raw: TaskGraph,
             cfg: TapirConfig, key: tuple, written: frozenset) -> Callable:
    """A loaded program with a one-shot degrade path: if its first call
    raises before writing any input in place, the raw graph is compiled
    afresh and run in its place (for every later call too).  If the fresh
    program succeeds the entry was at fault: it is quarantined and counted
    (``l2_fallbacks``); if it raises too, the error is the caller's and
    propagates."""
    cell: dict[str, Any] = {"raw": raw}

    def call(inputs: dict):
        f = cell.get("fn")
        if f is not None:
            return f(inputs)
        before = {n: _version_of(inputs[n]) for n in written if n in inputs}
        try:
            out = fn(inputs)
        except Exception:
            if any(v is None or _version_of(inputs[n]) != v
                   for n, v in before.items()):
                raise           # an input was written: no safe retry
            fresh = _build(cell.pop("raw"), cfg, key, region=True)
            cell["fn"] = fresh.fn
            out = fresh.fn(inputs)
            _quarantine(l2, digest, "call-failed")
            _CACHE_STATS["l2_fallbacks"] += 1
            _PROVENANCE[key] = dict(_PROVENANCE.get(key, {}),
                                    source="disk, recompiled")
            return out
        cell["fn"] = fn
        cell.pop("raw", None)
        return out

    return call


def _l2_publish(l2, digest: str, g: TaskGraph, refs: list,
                prog: _Program) -> bool:
    """Encode and publish a fresh compile with its provenance sidecar,
    after checking that the entry loads back to the same graph (a graph
    that cannot would poison every later process).  Publish failures are
    not fatal: the process serves uncached."""
    from ..cache import stable_digest
    from ..cache.disk import (decode_program_payload, encode_program_payload,
                              rebuild_graph)
    try:
        raw = encode_program_payload(g, refs, prog.graphed, prog.written)
        sig = stable_digest(g.signature())
        back, graphed, written = rebuild_graph(decode_program_payload(raw),
                                               refs)
        if (stable_digest(back.signature()) != sig
                or (graphed, written) != (prog.graphed, prog.written)):
            return False
        meta = {"graph_name": g.name,
                "mesh_fingerprint": [list(p) for p in mesh_fingerprint()],
                "input_names": [n for n, _ in g.inputs],
                "graph_signature": sig, "graphed": prog.graphed,
                "written": sorted(prog.written), "n_nodes": len(g.nodes),
                "impls": sorted({n.schedule.impl for n in g.nodes.values()
                                 if n.schedule.impl}),
                "created_at": time.time()}
        ok = l2.put(digest, raw, meta)
    except Exception:
        return False
    if ok:
        _CACHE_STATS["l2_writes"] += 1
    return ok


def _execute(op_key: tuple, build: Callable[[TaskGraph], None],
             inputs: dict[str, Any]) -> tuple:
    cfg = get_config()
    key = (op_key,) + _cfg_key(cfg)
    prog = _CACHE.get(key)
    if prog is None:
        _CACHE_STATS["misses"] += 1
        g = TaskGraph(op_key[0])
        build(g)
        prog = _compile(g, cfg, key)
    else:
        _CACHE_STATS["hits"] += 1
    return prog.fn(inputs)


# ---------------------------------------------------------------------------
# Containers (the port's pytree): tuples, lists and dicts; all else a leaf
# ---------------------------------------------------------------------------


def _flatten(tree) -> tuple[list, tuple]:
    """(leaves, hashable structure).  Dict keys are visited sorted."""
    leaves: list = []
    return leaves, _flatten_into(tree, leaves)


def _flatten_into(v, leaves: list):
    # module-level (not a recursive closure, whose reference cycle would
    # keep every leaf -- a step's activations -- alive until the next
    # garbage collection)
    if isinstance(v, (list, tuple)):
        return (type(v) is tuple, tuple(_flatten_into(e, leaves) for e in v))
    if isinstance(v, dict):
        keys = tuple(sorted(v))
        return ("dict", keys, tuple(_flatten_into(v[k], leaves) for k in keys))
    leaves.append(v)
    return None


def _unflatten(spec: tuple, leaves: Sequence) -> Any:
    return _unflatten_from(spec, iter(leaves))


def _unflatten_from(s, it) -> Any:
    if s is None:
        return next(it)
    if s[0] == "dict":
        return {k: _unflatten_from(c, it) for k, c in zip(s[1], s[2])}
    items = [_unflatten_from(c, it) for c in s[1]]
    return tuple(items) if s[0] else items


# ---------------------------------------------------------------------------
# Region capture: TracedTensor + _Region
# ---------------------------------------------------------------------------


class TracedTensor:
    """Lazy handle to a node in an open region graph.

    Supports the tensor surface model code uses between op calls
    (arithmetic, ``reshape``, ``to``, indexing).  ``materialize()`` flushes
    the pending segment and returns the concrete tensor."""

    __slots__ = ("_region", "nid", "ttype", "_concrete", "__weakref__")

    def __init__(self, region: "_Region", nid: Optional[int],
                 ttype: TensorType, concrete=None):
        self._region = region
        self.nid = nid
        self.ttype = ttype
        self._concrete = concrete

    @property
    def shape(self) -> tuple[int, ...]:
        return tuple(self.ttype.shape)

    @property
    def dtype(self) -> torch.dtype:
        return to_torch_dtype(self.ttype.dtype)

    @property
    def ndim(self) -> int:
        return len(self.ttype.shape)

    def __repr__(self) -> str:
        state = "concrete" if self._concrete is not None else "lazy"
        return (f"TracedTensor({self.ttype.dtype}{list(self.ttype.shape)}, "
                f"{state})")

    def materialize(self) -> torch.Tensor:
        """Concrete value; flushes the region segment if still pending."""
        if self._concrete is None:
            if self._region.closed:
                raise RuntimeError("TracedTensor from an abandoned region")
            self._region.flush()
        return self._concrete

    def _bin(self, other, fn: str, swap: bool = False):
        reg = self._region
        if reg.closed:
            a = self.materialize()
            b = other.materialize() if isinstance(other, TracedTensor) \
                else other
            return _EW[fn](b, a) if swap else _EW[fn](a, b)
        a = reg.nid_of(self)
        b = reg.operand_nid(other, like=self)
        o_shape = np.broadcast_shapes(self.shape, tuple(getattr(other, "shape", ())))
        out_t = TensorType(tuple(int(s) for s in o_shape),
                           _promote(self.ttype.dtype, other))
        ins = (b, a) if swap else (a, b)
        nid = reg.g.add("ew", ins, out_t,
                        pdims=tuple(range(len(out_t.shape))), fn=fn)
        return reg.handle(nid)

    def __add__(self, other):
        return self._bin(other, "add")

    def __radd__(self, other):
        return self._bin(other, "add", swap=True)

    def __sub__(self, other):
        return self._bin(other, "sub")

    def __rsub__(self, other):
        return self._bin(other, "sub", swap=True)

    def __mul__(self, other):
        return self._bin(other, "mul")

    def __rmul__(self, other):
        return self._bin(other, "mul", swap=True)

    def __truediv__(self, other):
        return self._bin(other, "div")

    def __rtruediv__(self, other):
        return self._bin(other, "div", swap=True)

    def __neg__(self):
        reg = self._region
        if reg.closed:
            return -self.materialize()
        nid = reg.g.add("ew", (reg.nid_of(self),), self.ttype,
                        pdims=tuple(range(self.ndim)), fn="neg")
        return reg.handle(nid)

    def reshape(self, *shape):
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        shape = _resolve_reshape(self.shape, shape)
        reg = self._region
        if reg.closed:
            return self.materialize().reshape(shape)
        nid = reg.g.add("reshape", (reg.nid_of(self),),
                        TensorType(shape, self.ttype.dtype),
                        pdims=tuple(range(len(shape))))
        return reg.handle(nid)

    def to(self, dtype):
        dt = dtype_name(dtype)
        if dt == self.ttype.dtype:
            return self
        reg = self._region
        if reg.closed:
            return self.materialize().to(to_torch_dtype(dt))
        nid = reg.g.add("convert", (reg.nid_of(self),),
                        TensorType(self.shape, dt),
                        pdims=tuple(range(self.ndim)))
        return reg.handle(nid)

    @property
    def T(self):
        return self.permute(*reversed(range(self.ndim)))

    def permute(self, *perm):
        if len(perm) == 1 and isinstance(perm[0], (tuple, list)):
            perm = tuple(perm[0])
        perm = tuple(int(p) % max(self.ndim, 1) for p in perm)
        reg = self._region
        if reg.closed:
            return self.materialize().permute(perm)
        shape = tuple(self.shape[p] for p in perm)
        nid = reg.g.add("transpose", (reg.nid_of(self),),
                        TensorType(shape, self.ttype.dtype),
                        pdims=tuple(range(len(shape))), perm=perm)
        return reg.handle(nid)

    def __getitem__(self, item):
        """Integer-array indexing stays lazy as a ``gather`` node; basic
        static indexing (ints/slices/Ellipsis/None) as an ``index`` node."""
        reg = self._region
        items = item if isinstance(item, tuple) else (item,)
        if not reg.closed and items and all(_is_int_array(s) for s in items):
            return gather(self, items)
        enc = _encode_index(item)
        if reg.closed or enc is None:
            raise TypeError(f"unsupported index on a traced tensor: {item!r}")
        out = torch.empty(self.shape, dtype=self.dtype, device="meta")[item]
        out_t = TensorType(tuple(out.shape), self.ttype.dtype)
        nid = reg.g.add("index", (reg.nid_of(self),), out_t,
                        pdims=tuple(range(len(out_t.shape))), idx=enc)
        return reg.handle(nid)


def _is_int_array(v) -> bool:
    """An integer index ARRAY operand (traced or concrete)."""
    if isinstance(v, TracedTensor):
        return v.ndim >= 1 and not v.dtype.is_floating_point \
            and v.dtype != torch.bool
    if isinstance(v, np.ndarray):
        return v.ndim >= 1 and np.issubdtype(v.dtype, np.integer)
    if isinstance(v, torch.Tensor):
        return v.ndim >= 1 and not v.dtype.is_floating_point \
            and v.dtype != torch.bool
    return False


def _encode_index(item) -> Optional[tuple]:
    """Hashable encoding of a basic index expression (None if unsupported)."""
    items = item if isinstance(item, tuple) else (item,)
    enc = []
    for s in items:
        if isinstance(s, (bool, np.bool_)):
            return None
        if isinstance(s, (int, np.integer)):
            enc.append(("i", int(s)))
        elif isinstance(s, slice):
            if not all(x is None or isinstance(x, (int, np.integer))
                       for x in (s.start, s.stop, s.step)):
                return None
            enc.append(("s", s.start, s.stop, s.step))
        elif s is Ellipsis:
            enc.append(("e",))
        elif s is None:
            enc.append(("n",))
        else:
            return None
    return tuple(enc)


def _promote(dtype: str, other) -> str:
    if isinstance(other, (int, float, bool)):
        return dtype   # python scalars are weakly typed: keep tensor dtype
    return dtype_name(torch.promote_types(to_torch_dtype(dtype),
                                          to_torch_dtype(other.dtype)
                                          if isinstance(other, TracedTensor)
                                          else other.dtype))


def _resolve_reshape(cur: tuple, shape: tuple) -> tuple[int, ...]:
    shape = tuple(int(s) for s in shape)
    if -1 in shape:
        known = int(np.prod([s for s in shape if s != -1])) or 1
        total = int(np.prod(cur)) if cur else 1
        shape = tuple(total // known if s == -1 else s for s in shape)
    return shape


def is_traced(x) -> bool:
    return isinstance(x, TracedTensor)


def layout_of(x) -> Optional[tuple]:
    """The recorded layout of ``x`` (a spec tuple), or None: a traced
    value's node annotation, a concrete tensor's ``SPEC_ATTR``."""
    if isinstance(x, TracedTensor):
        if not x._region.closed:
            return x._region.g.nodes[x._region.nid_of(x)].sharding
        x = x.materialize()
    return getattr(x, SPEC_ATTR, None)


def annotate_sharding(x, spec):
    """Record ``spec`` (a spec tuple, already resolved against the ambient
    mesh by ``dist.shard_act``) as the layout of ``x``: on a traced value
    the ``sharding`` annotation of its producing node, which rides through
    every pass (CSE unifies only equal ones, fusion moves it to the node
    that takes over the value); on a concrete tensor its ``SPEC_ATTR``."""
    spec = tuple(spec)
    if isinstance(x, TracedTensor) and not x._region.closed:
        reg = x._region
        nid = reg.nid_of(x)
        reg.g.nodes[nid].sharding = spec
        return x if x.nid == nid else reg.handle(nid)
    if isinstance(x, TracedTensor):
        x = x.materialize()
    setattr(x, SPEC_ATTR, spec)
    return x


def reshard(x, src: Optional[tuple], dst: Optional[tuple], spec: tuple):
    """``x``, a rank's block held under ``src``, as its block under
    ``dst`` (both without size-1 axes; ``spec`` is the annotation to
    record).  Equal layouts only annotate.  Otherwise, in a region, a
    ``reshard`` node (the lowering's slice / rank-order all-gather); on a
    concrete tensor, the same now."""
    from ..dist.sharding import current_mesh, global_shape, local_shape
    if src == dst:
        return annotate_sharding(x, spec)
    mesh = current_mesh()
    if isinstance(x, TracedTensor) and not x._region.closed:
        reg = x._region
        xi = reg.nid_of(x)
        shape = local_shape(global_shape(x.shape, src, mesh), dst, mesh)
        nid = reg.g.add("reshard", (xi,), TensorType(shape, x.ttype.dtype),
                        pdims=tuple(range(len(shape))), src=src, dst=dst,
                        sharding=tuple(spec))
        return reg.handle(nid)
    from ..dist.sharding import reshard_tensor
    t = x.materialize() if isinstance(x, TracedTensor) else x
    out = reshard_tensor(t, src, dst, mesh)
    setattr(out, SPEC_ATTR, tuple(spec))
    return out


def _gather_k(g: TaskGraph, xi: int, k_full: int) -> int:
    """The activation ``xi`` whose last dim holds this rank's block of a
    contraction of ``k_full`` over the model axis (a column-sharded
    projection feeding a replicated one): all-gather it in rank order, so
    the consumer's sum stays whole on every rank."""
    x_t = g.nodes[xi].ttype
    nd = len(x_t.shape)
    src = (None,) * (nd - 1) + ("model",)
    return g.add("reshard", (xi,),
                 TensorType(tuple(x_t.shape[:-1]) + (k_full,), x_t.dtype),
                 pdims=tuple(range(nd)), src=src, dst=None,
                 sharding=(None,) * nd)


def _k_operand(g: TaskGraph, xi: int, wi: int) -> int:
    """``xi`` ready to contract with ``wi``'s rows: gathered where it holds
    a block of them under a model axis."""
    k_x, k_w = g.nodes[xi].ttype.shape[-1], g.nodes[wi].ttype.shape[-2]
    if k_x != k_w and mesh_has_model_axis():
        return _gather_k(g, xi, k_w)
    return xi


def in_region() -> bool:
    """True while a region capture is open on this thread."""
    return _active_region() is not None


class _Region:
    """One open capture: a growing TaskGraph plus the concrete tensors
    bound to its input nodes.  A region lives on one device: consts the
    tracer creates (index patterns, scalars) are placed there."""

    def __init__(self, name: str, cfg: TapirConfig):
        self.name = name
        self.cfg = cfg
        self.closed = False
        self.segments = 0
        self.device: Optional[str] = None
        self.g = TaskGraph(name)
        self._inp_by_id: dict[int, int] = {}
        self._inp_name: dict[int, str] = {}
        self._inp_vals: list[Any] = []
        self._handles: list[weakref.ref] = []
        #: seconds this region spent building and running programs (a
        #: flush inside the traced body is not tracing)
        self.run_s = 0.0

    def nid_of(self, x) -> int:
        if isinstance(x, TracedTensor):
            if x._concrete is not None:
                x = x._concrete
            elif x._region is self:
                if x.nid is None:
                    raise RuntimeError(
                        "TracedTensor retired: the in-place optimization "
                        "of autodiff.grad removed its node (pass it in "
                        "keep= to carry it through)")
                return x.nid
            else:
                raise ValueError(
                    "TracedTensor used outside the region that created it")
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"region input must be a tensor, got {type(x)}")
        key = id(x)
        nid = self._inp_by_id.get(key)
        if nid is None or nid not in self.g.nodes:
            # new, or pruned by an in-place optimization: (re)bind it
            if self.device is None:
                self.device = str(x.device)
            name = self._inp_name.get(key)
            if name is None:
                name = self._inp_name[key] = f"a{len(self._inp_vals)}"
                self._inp_vals.append(x)     # also pins id(x)
            nid = self.g.add_input(name, _tt(x))
            spec = getattr(x, SPEC_ATTR, None)
            if spec is not None:
                self.g.nodes[nid].sharding = spec
            self._inp_by_id[key] = nid
        return nid

    def retire_stale_handles(self) -> None:
        """After an in-place optimization: a pending handle whose node was
        removed can no longer be used (``nid_of`` raises on it) and is not
        an output."""
        for r in self._handles:
            h = r()
            if h is not None and h.nid is not None \
                    and h.nid not in self.g.nodes:
                h.nid = None

    def const(self, value, dtype: str) -> int:
        value = np.asarray(value)
        return self.g.add("const", (), TensorType(tuple(value.shape), dtype),
                          value=value, device=self.device or "cpu")

    def operand_nid(self, v, like: TracedTensor) -> int:
        if isinstance(v, (int, float, bool)):
            return self.const(v, like.ttype.dtype)
        return self.nid_of(v)

    def handle(self, nid: int) -> TracedTensor:
        h = TracedTensor(self, nid, self.g.nodes[nid].ttype)
        self._handles.append(weakref.ref(h))
        return h

    def wrap(self, val) -> TracedTensor:
        """Wrap a concrete tensor as a passthrough handle (region arg)."""
        return TracedTensor(self, None, _tt(val), concrete=val)

    def _pending(self) -> list[TracedTensor]:
        out, live = [], []
        for r in self._handles:
            h = r()
            if h is None:
                continue
            live.append(r)
            if h._concrete is None and h.nid is not None:
                out.append(h)
        self._handles = live
        return out

    def _run(self, outs: list[TracedTensor]) -> None:
        t0 = time.perf_counter()
        self.g.set_outputs([h.nid for h in outs])
        key = ("region", self.g.signature()) + _cfg_key(self.cfg)
        inputs = {f"a{i}": v for i, v in enumerate(self._inp_vals)}
        prog = _CACHE.get(key)
        if prog is None:
            _CACHE_STATS["misses"] += 1
            prog = _compile(self.g, self.cfg, key, region=True)
        else:
            _CACHE_STATS["hits"] += 1
        self._last_prog, self._last_key = prog, key
        for h, r in zip(outs, _run_program(key, prog, inputs)):
            h._concrete = r
        self.run_s += time.perf_counter() - t0

    def flush(self) -> None:
        """Materialize the current segment; capture continues afresh."""
        pending = self._pending()
        if pending:
            self._run(pending)
        self.segments += 1
        self.g = TaskGraph(f"{self.name}#{self.segments}")
        self._inp_by_id = {}
        self._inp_name = {}
        self._inp_vals = []

    def abandon(self) -> None:
        self.closed = True


def _run_program(key: tuple, prog: _Program, inputs: dict) -> tuple:
    """One call of a compiled region program: through the graph cache,
    which replays it as a CUDA graph where ``prog.graphed`` says so."""
    return graphs.CACHE.run(key, prog.fn, inputs, prog.graphed, prog.written)


def _region_stack() -> list:
    if not hasattr(_tls, "regions"):
        _tls.regions = []
    return _tls.regions


def _active_region() -> Optional[_Region]:
    stack = _region_stack()
    return stack[-1] if stack else None


#: call-site program cache: (body identity, arg structure, leaf shapes /
#: dtypes / devices, aliasing, config) -> a replay closure.  A hit skips
#: tracing: one dict probe plus one call of the emitted program.  Values
#: hold strong refs to the body so ids in the key cannot be recycled.
_PROGRAMS: dict[tuple, tuple] = {}


def _leaf_key(v):
    if isinstance(v, torch.Tensor):
        spec = getattr(v, SPEC_ATTR, None)
        key = ("arr", tuple(v.shape), dtype_name(v.dtype), str(v.device))
        return key if spec is None else key + (spec,)
    try:
        hash(v)
    except TypeError:
        return None
    return ("obj", v)


#: ids of inlined ``parallel_region`` calls
_SCOPES = itertools.count()


def parallel_region(fn=None, *, name: Optional[str] = None):
    """Decorator form of region capture: tensor arguments enter the region
    as lazy handles, the returned structure is materialized (one pipeline
    run + one emitted program for the whole body) and returned as concrete
    tensors.  Structurally repeated calls replay through ``_PROGRAMS``."""
    def deco(f):
        f_id = (id(getattr(f, "__func__", f)), id(getattr(f, "__self__", None)))

        @functools.wraps(f)
        def wrapper(*args, **kwargs):
            outer = _active_region()
            if outer is not None:
                # inlined into the open region: its nodes carry this call's
                # scope (see ``TaskGraph.scopes``)
                prev, outer.g.scope = outer.g.scope, next(_SCOPES)
                try:
                    return f(*args, **kwargs)
                finally:
                    outer.g.scope = prev
            if not get_config().regions:
                return f(*args, **kwargs)
            cfg = get_config()
            leaves, spec = _flatten((args, kwargs))
            lks = [_leaf_key(v) for v in leaves]
            # aliasing pattern: which leaves are the SAME tensor object (the
            # region dedups them into one input; a replay is valid only for
            # calls with the identical aliasing)
            first_seen: dict[int, int] = {}
            alias = tuple(first_seen.setdefault(id(v), i)
                          if isinstance(v, torch.Tensor) else -1
                          for i, v in enumerate(leaves))
            key = None
            if all(k is not None for k in lks):
                key = (f_id, spec, tuple(lks), alias,
                       _layout_context()) + _cfg_key(cfg)
                hit = _PROGRAMS.get(key)
                if hit is not None and hit[0] is getattr(f, "__func__", f):
                    _CACHE_STATS["hits"] += 1
                    return hit[2](leaves)

            r = _Region(name or getattr(f, "__name__", "region"), cfg)
            argpos: dict[int, int] = {}
            for i, v in enumerate(leaves):
                if isinstance(v, torch.Tensor):
                    argpos.setdefault(id(v), i)
            handles = [r.wrap(v) if isinstance(v, torch.Tensor) else v
                       for v in leaves]
            targs, tkwargs = _unflatten(spec, handles)
            stack = _region_stack()
            stack.append(r)
            t0 = time.perf_counter()
            try:
                out = f(*targs, **tkwargs)
            except BaseException:
                r.abandon()
                raise
            finally:
                stack.pop()
                _CACHE_STATS["trace_s"] += time.perf_counter() - t0 - r.run_s
            out_leaves, out_spec = _flatten(out)
            pending = r._pending()
            # each output's layout, read before the pipeline rewrites g
            lay = [_pending_layout(r, h) for h in pending]
            if pending:
                r._run(pending)
            r.closed = True
            _set_layouts([h._concrete for h in pending], lay)
            _maybe_cache_program(key, f, r, pending, out_leaves, out_spec,
                                 argpos, lay)
            return _unflatten(out_spec, [
                v._concrete if isinstance(v, TracedTensor) else v
                for v in out_leaves])
        return wrapper
    return deco(fn) if fn is not None else deco


def _pending_layout(r: _Region, h: TracedTensor):
    return r.g.nodes[h.nid].sharding if h.nid in r.g.nodes else None


def _set_layouts(vals, lay) -> None:
    for v, spec in zip(vals, lay):
        if spec is not None:
            setattr(v, SPEC_ATTR, spec)


def _maybe_cache_program(key, f, r: _Region, pending, out_leaves,
                         out_spec, argpos, lay=()) -> None:
    """Record a replay closure for this call site if the capture was clean:
    no mid-region flush, every region input came from an argument leaf, and
    the output is reconstructible from (results, arg leaves, constants)."""
    if key is None or r.segments > 0 or not pending:
        return
    binding = []
    for v in r._inp_vals:
        j = argpos.get(id(v))
        if j is None:
            return          # closure-captured tensor: can't rebind safely
        binding.append(j)
    pend_idx = {id(h): i for i, h in enumerate(pending)}
    spec = []
    for lv in out_leaves:
        if isinstance(lv, TracedTensor):
            if id(lv) in pend_idx:
                spec.append(("res", pend_idx[id(lv)]))
            elif lv._concrete is not None and id(lv._concrete) in argpos:
                spec.append(("arg", argpos[id(lv._concrete)]))
            else:
                return
        elif isinstance(lv, torch.Tensor):
            return          # stray tensor output: don't capture it
        else:
            spec.append(("const", lv))
    prog_c, key_c = r._last_prog, r._last_key
    binding, spec = tuple(binding), tuple(spec)
    lay = tuple(lay) if any(x is not None for x in lay) else ()

    def replay(leaves, prog_c=prog_c, key_c=key_c, binding=binding,
               spec=spec, out_spec=out_spec, lay=lay):
        results = _run_program(
            key_c, prog_c,
            {f"a{i}": leaves[j] for i, j in enumerate(binding)})
        if lay:
            _set_layouts(results, lay)
        outs = [results[i] if tag == "res"
                else leaves[i] if tag == "arg" else i
                for tag, i in spec]
        return _unflatten(out_spec, outs)

    _PROGRAMS[key] = (getattr(f, "__func__", f),
                      getattr(f, "__self__", None), replay)


# ---------------------------------------------------------------------------
# Data-dependent indexing
# ---------------------------------------------------------------------------


def _index_operand(reg: _Region, ix) -> int:
    """Graph value for one gather/scatter index operand: traced tensors are
    graph values already; numpy integer arrays become ``const`` nodes (a
    static pattern like ``np.arange(slots)`` must not become a fresh
    region input per call — that would disable program replay); tensors
    become region inputs."""
    if isinstance(ix, TracedTensor):
        return reg.nid_of(ix)
    if isinstance(ix, (int, np.integer)):
        ix = np.asarray(ix, np.int32)
    if isinstance(ix, np.ndarray):
        return reg.const(np.ascontiguousarray(ix, dtype=np.int32), "int32")
    return reg.nid_of(ix)


def _concrete(v):
    if isinstance(v, TracedTensor):
        return v.materialize()
    if isinstance(v, np.ndarray):
        return torch.as_tensor(v)
    return v


def gather(src, indices):
    """Integer-array indexing with graph-value indices over the leading
    axes: ``src[i0, i1, ...]``; out-of-range indices clamp (the
    reference's semantics).  Inside a region it records ONE ``gather``
    node."""
    indices = tuple(indices) if isinstance(indices, (tuple, list)) \
        else (indices,)
    reg = _active_region()
    if reg is None:
        src = _concrete(src)
        return gather_clamped(src, tuple(_concrete(i).to(src.device)
                                         for i in indices))
    si = reg.nid_of(src)
    s_t = reg.g.nodes[si].ttype
    idx_nids = tuple(_index_operand(reg, i) for i in indices)
    ishape = np.broadcast_shapes(*[reg.g.nodes[n].ttype.shape
                                   for n in idx_nids])
    out_t = TensorType(tuple(int(s) for s in ishape)
                       + tuple(s_t.shape[len(idx_nids):]), s_t.dtype)
    nid = reg.g.add("gather", (si,) + idx_nids, out_t,
                    pdims=tuple(range(len(out_t.shape))),
                    n_idx=len(idx_nids))
    return reg.handle(nid)


def scatter(buf, indices, upd, mode: str = "set", donate: bool = True):
    """Write ``upd`` into ``buf`` at integer-array indices over the leading
    axes; out-of-range updates are dropped (the reference's semantics).

    Inside a region the ``scatter`` node is never CSE'd and, with
    ``donate=True``, writes a region-input ``buf`` in place (after every
    read of the pre-write buffer).  Outside a region the write is
    functional: ``buf`` is left as it was."""
    indices = tuple(indices) if isinstance(indices, (tuple, list)) \
        else (indices,)
    reg = _active_region()
    if reg is None:
        b = _concrete(buf)
        return scatter_drop(b, tuple(_concrete(i).to(b.device)
                                     for i in indices),
                            _concrete(upd), mode, in_place=False)
    bi = reg.nid_of(buf)
    b_t = reg.g.nodes[bi].ttype
    idx_nids = tuple(_index_operand(reg, i) for i in indices)
    ui = reg.nid_of(upd)
    nid = reg.g.add("scatter", (bi,) + idx_nids + (ui,), b_t,
                    pdims=tuple(range(len(b_t.shape))),
                    donates=bi if donate else None,
                    n_idx=len(idx_nids), mode=mode)
    return reg.handle(nid)


def scatter_new(shape, dtype, indices, upd, mode: str = "add"):
    """Scatter into a FRESH zeros buffer of ``shape`` / ``dtype`` (the MoE
    dispatch: tokens scattered into ``[E, cap, d]``); out-of-range updates
    are dropped.  Inside a region the zeros are made inside the node
    (``zero_init``, no buffer input): zeros made in model code would be a
    fresh region input every call and defeat program replay."""
    indices = tuple(indices) if isinstance(indices, (tuple, list)) \
        else (indices,)
    dt = dtype_name(dtype)
    reg = _active_region()
    if reg is None:
        u = _concrete(upd)
        buf = torch.zeros(tuple(int(s) for s in shape),
                          dtype=to_torch_dtype(dt), device=u.device)
        return scatter_drop(buf, tuple(_concrete(i).to(u.device)
                                       for i in indices),
                            u, mode, in_place=True)
    idx_nids = tuple(_index_operand(reg, i) for i in indices)
    ui = reg.nid_of(upd)
    out_t = TensorType(tuple(int(s) for s in shape), dt)
    nid = reg.g.add("scatter", idx_nids + (ui,), out_t,
                    pdims=tuple(range(len(out_t.shape))),
                    n_idx=len(idx_nids), mode=mode, zero_init=True)
    return reg.handle(nid)


# ---------------------------------------------------------------------------
# Stateful buffer ops (KV cache)
# ---------------------------------------------------------------------------


def _start_operands(reg: _Region, starts) -> tuple[tuple, tuple]:
    """Split window starts into static ints and dynamic scalar operands.
    Returns (static_starts with None holes, nids of the dynamic holes)."""
    static, nids = [], []
    for s in starts:
        if isinstance(s, (int, np.integer)):
            static.append(int(s))
        else:
            static.append(None)
            nids.append(reg.nid_of(s))
    return tuple(static), tuple(nids)


def cache_write(buf, update, starts):
    """Window write with in-place intent: ``buf[starts:starts+update.shape]
    = update``, a negative start wrapped once and each start clamped to
    ``[0, dim - update.shape]``, as ``lax.dynamic_update_slice`` does.

    Outside a region the write is functional: ``buf`` is left as it was and
    a new tensor returned.  Inside a region it records a
    ``dynamic_update_slice`` node whose buffer input is *donated*: the
    region program writes the input tensor in place and returns it, so the
    caller must treat ``buf`` as consumed and use the returned tensor.
    ``starts`` entries are python ints or integer scalar tensors (traced or
    concrete)."""
    reg = _active_region()
    if reg is None:
        return dynamic_update_slice_clamped(
            buf, _concrete(update), tuple(_concrete(s) for s in starts),
            in_place=False)
    bi = reg.nid_of(buf)
    ui = reg.nid_of(update)
    b_t = reg.g.nodes[bi].ttype
    if len(update.shape) != len(b_t.shape):
        raise ValueError(f"cache_write update rank {len(update.shape)} != "
                         f"buffer rank {len(b_t.shape)}")
    static, dyn = _start_operands(reg, starts)
    nid = reg.g.add("dynamic_update_slice", (bi, ui) + dyn, b_t,
                    pdims=tuple(range(len(b_t.shape))), donates=bi,
                    static_starts=static)
    return reg.handle(nid)


def cache_read(buf, starts, sizes):
    """Window read ``buf[starts : starts+sizes]`` (``lax.dynamic_slice``:
    a negative start wrapped once, then every start clamped).  Inside a
    region it stays lazy as a ``dynamic_slice`` node, ordered before any
    later in-place write of the same buffer."""
    reg = _active_region()
    if reg is None:
        return dynamic_slice_clamped(_concrete(buf),
                                     tuple(_concrete(s) for s in starts),
                                     tuple(sizes))
    bi = reg.nid_of(buf)
    b_t = reg.g.nodes[bi].ttype
    static, dyn = _start_operands(reg, starts)
    out_t = TensorType(tuple(int(s) for s in sizes), b_t.dtype)
    nid = reg.g.add("dynamic_slice", (bi,) + dyn, out_t,
                    pdims=tuple(range(len(out_t.shape))),
                    static_starts=static, sizes=tuple(int(s) for s in sizes))
    return reg.handle(nid)


def lift(fn: Callable, *args, **static):
    """Record a python composite as ONE region node (``pyfunc``), or one
    node per output for tuple-returning fns.

    ``fn(*tensors, **static)`` must be a pure torch function of its tensor
    arguments that creates any tensor of its own on its inputs' device (it
    runs once on ``meta`` tensors to infer output shapes).  Outside a region
    this just calls ``fn``.  ``fn`` must be a module-level function (its
    identity is part of the graph signature)."""
    reg = _active_region()
    if reg is None:
        return fn(*args, **static)
    nids = [reg.nid_of(a) for a in args]
    metas = [torch.empty(reg.g.nodes[n].ttype.shape,
                         dtype=to_torch_dtype(reg.g.nodes[n].ttype.dtype),
                         device="meta") for n in nids]
    out = fn(*metas, **static)
    st = tuple(sorted(static.items()))
    if isinstance(out, torch.Tensor):
        nid = reg.g.add("pyfunc", tuple(nids), _tt(out), fn=fn, static=st)
        return reg.handle(nid)
    if isinstance(out, (tuple, list)) and all(
            isinstance(o, torch.Tensor) for o in out):
        return tuple(
            reg.handle(reg.g.add("pyfunc", tuple(nids), _tt(o), fn=fn,
                                 static=st, out=i))
            for i, o in enumerate(out))
    raise TypeError(f"lift({fn.__name__}) must return a tensor or a flat "
                    f"tuple of tensors, got {type(out)}")


def capture_region(fn: Callable, *args, **kwargs) -> TaskGraph:
    """Trace ``fn`` under a region and return the RAW merged graph (outputs
    set, pipeline NOT run, nothing executed)."""
    r = _Region(getattr(fn, "__name__", "region"), get_config())
    leaves, spec = _flatten((args, kwargs))
    targs, tkwargs = _unflatten(spec, [
        r.wrap(v) if isinstance(v, torch.Tensor) else v for v in leaves])
    stack = _region_stack()
    stack.append(r)
    try:
        out = fn(*targs, **tkwargs)
    finally:
        stack.pop()
    outs = [v for v in _flatten(out)[0]
            if isinstance(v, TracedTensor) and v.nid is not None]
    r.g.set_outputs([h.nid for h in outs])
    r.abandon()
    return r.g


# ---------------------------------------------------------------------------
# Shared graph builders (the per-op path and the region tracer)
# ---------------------------------------------------------------------------


def _pd(t: TensorType) -> tuple[int, ...]:
    return tuple(range(len(t.shape)))


def _build_linear(g: TaskGraph, xi: int, wi: int, bi: Optional[int],
                  ri: Optional[int], activation: Optional[str]) -> int:
    xi = _k_operand(g, xi, wi)
    x_t, w_t = g.nodes[xi].ttype, g.nodes[wi].ttype
    out_t = TensorType(tuple(x_t.shape[:-1]) + (w_t.shape[-1],), x_t.dtype)
    k = x_t.shape[-1]
    head = g.add("matmul", (xi, wi), out_t, pdims=_pd(out_t),
                 rdims=(("k", k),), k=k)
    if bi is not None:
        head = g.add("ew", (head, bi), out_t, pdims=_pd(out_t), fn="add")
    if activation is not None:
        head = g.add("ew", (head,), out_t, pdims=_pd(out_t), fn=activation)
    if ri is not None:
        head = g.add("ew", (head, ri), out_t, pdims=_pd(out_t), fn="add")
    return head


def _build_multi_linear(g: TaskGraph, xi: int, wis: Sequence[int],
                        bis: Sequence[Optional[int]]) -> list[int]:
    x_t = g.nodes[xi].ttype
    k = x_t.shape[-1]
    outs = []
    for wi, bi in zip(wis, bis):
        w_t = g.nodes[wi].ttype
        out_t = TensorType(tuple(x_t.shape[:-1]) + (w_t.shape[-1],), x_t.dtype)
        mm = g.add("matmul", (xi, wi), out_t, pdims=_pd(out_t),
                   rdims=(("k", k),), k=k)
        if bi is not None:
            mm = g.add("ew", (mm, bi), out_t, pdims=_pd(out_t), fn="add")
        outs.append(mm)
    return outs


def _build_gated_mlp(g: TaskGraph, xi: int, wgi: int, wui: int, wdi: int,
                     activation: str) -> int:
    x_t = g.nodes[xi].ttype
    f = g.nodes[wgi].ttype.shape[-1]
    hid_t = TensorType(tuple(x_t.shape[:-1]) + (f,), x_t.dtype)
    k = x_t.shape[-1]
    mg = g.add("matmul", (xi, wgi), hid_t, pdims=_pd(hid_t),
               rdims=(("k", k),), k=k)
    mu = g.add("matmul", (xi, wui), hid_t, pdims=_pd(hid_t),
               rdims=(("k", k),), k=k)
    act = g.add("ew", (mg,), hid_t, pdims=_pd(hid_t), fn=activation)
    prod = g.add("ew", (act, mu), hid_t, pdims=_pd(hid_t), fn="mul")
    prod = _k_operand(g, prod, wdi)
    f = g.nodes[prod].ttype.shape[-1]
    out_t = TensorType(tuple(x_t.shape[:-1]) +
                       (g.nodes[wdi].ttype.shape[-1],), x_t.dtype)
    return g.add("matmul", (prod, wdi), out_t, pdims=_pd(out_t),
                 rdims=(("k", f),), k=f)


def _build_expert_mlp(g: TaskGraph, xi: int, wgi: int, wui: int, wdi: int,
                      activation: str) -> int:
    """The expert FFN over ``x [E, C, d]`` with ``w [E, d, f]`` / ``[E, f,
    d]``: three 3-D matmuls (E a batch of each) and the gate's activation
    and product, which tapir mode's epilogue fusion folds into the gate
    GEMM.  Where ``x`` is a rank's block of the experts (its annotation
    shards dim 0), every node is that block and is annotated so
    (``schedule.shard_factor``)."""
    E, C, d = g.nodes[xi].ttype.shape
    dt = g.nodes[xi].ttype.dtype
    f = g.nodes[wgi].ttype.shape[-1]
    spec = g.nodes[xi].sharding
    ex = (spec[0], None, None) if spec and spec[0] is not None else None
    hid_t = TensorType((E, C, f), dt)
    mg = g.add("matmul", (xi, wgi), hid_t, pdims=(0, 1, 2),
               rdims=(("k", d),), sharding=ex, k=d)
    mu = g.add("matmul", (xi, wui), hid_t, pdims=(0, 1, 2),
               rdims=(("k", d),), sharding=ex, k=d)
    act = g.add("ew", (mg,), hid_t, pdims=(0, 1, 2), sharding=ex,
                fn=activation)
    prod = g.add("ew", (act, mu), hid_t, pdims=(0, 1, 2), sharding=ex,
                 fn="mul")
    out_t = TensorType((E, C, d), dt)
    return g.add("matmul", (prod, wdi), out_t, pdims=(0, 1, 2),
                 rdims=(("k", f),), sharding=ex, k=f)


def _build_attention(g: TaskGraph, qi: int, ki: int, vi: int,
                     biasi: Optional[int], causal: bool) -> int:
    q_t, k_t = g.nodes[qi].ttype, g.nodes[ki].ttype
    ins = [qi, ki, vi] + ([biasi] if biasi is not None else [])
    out_t = TensorType(tuple(q_t.shape), q_t.dtype)
    b, s, h, d = q_t.shape
    return g.add("attention", tuple(ins), out_t, pdims=(0, 1, 2),
                 rdims=(("kv", k_t.shape[1]),),
                 causal=causal, q_shape=(b, s, h, d), kv_len=k_t.shape[1],
                 kv_heads=k_t.shape[2])


def _build_wkv_scan(g: TaskGraph, qi: int, ki: int, vi: int, wi: int,
                    ui: Optional[int]) -> int:
    q_t, v_t = g.nodes[qi].ttype, g.nodes[vi].ttype
    ins = [qi, ki, vi, wi] + ([ui] if ui is not None else [])
    out_t = TensorType(tuple(v_t.shape), v_t.dtype)
    return g.add("linear_scan", tuple(ins), out_t, pdims=(0, 2),
                 rdims=(("seq", q_t.shape[1]),), seq=q_t.shape[1],
                 variant="rwkv6" if ui is not None else "gla")


def _build_lstm_step(g: TaskGraph, xi: int, hi: int, ci: int, Wi: int,
                     bi: int) -> tuple[int, int]:
    """The cell as stock XLA emitted it: per gate (i, f, g, o) two GEMMs on
    slices of W (the x rows and the h rows), their sum plus the gate's
    bias slice; then the sigmoids, the tanh and the state update."""
    x_t, h_t = g.nodes[xi].ttype, g.nodes[hi].ttype
    W_t, b_t0 = g.nodes[Wi].ttype, g.nodes[bi].ttype
    xd, hd = x_t.shape[-1], h_t.shape[-1]
    B = x_t.shape[0]
    gate_t = TensorType((B, hd), x_t.dtype)
    Wx_t = TensorType((xd, hd), W_t.dtype)
    Wh_t = TensorType((hd, hd), W_t.dtype)
    bg_t = TensorType((hd,), b_t0.dtype)
    gates = []
    for gi in range(4):
        wx = g.add("slice", (Wi,), TensorType((xd, 4 * hd), W_t.dtype),
                   pdims=(0, 1), axis=0, start=0, limit=xd)
        wx = g.add("slice", (wx,), Wx_t, pdims=(0, 1), axis=1,
                   start=gi * hd, limit=(gi + 1) * hd)
        wh = g.add("slice", (Wi,), TensorType((hd, 4 * hd), W_t.dtype),
                   pdims=(0, 1), axis=0, start=xd, limit=xd + hd)
        wh = g.add("slice", (wh,), Wh_t, pdims=(0, 1), axis=1,
                   start=gi * hd, limit=(gi + 1) * hd)
        bg = g.add("slice", (bi,), bg_t, pdims=(0,), axis=0,
                   start=gi * hd, limit=(gi + 1) * hd)
        mx = g.add("matmul", (xi, wx), gate_t, pdims=(0, 1),
                   rdims=(("k", xd),), k=xd)
        mh = g.add("matmul", (hi, wh), gate_t, pdims=(0, 1),
                   rdims=(("k", hd),), k=hd)
        s = g.add("ew", (mx, mh), gate_t, pdims=(0, 1), fn="add")
        s = g.add("ew", (s, bg), gate_t, pdims=(0, 1), fn="add")
        gates.append(s)
    i_g = g.add("ew", (gates[0],), gate_t, pdims=(0, 1), fn="sigmoid")
    f_g = g.add("ew", (gates[1],), gate_t, pdims=(0, 1), fn="sigmoid")
    g_g = g.add("ew", (gates[2],), gate_t, pdims=(0, 1), fn="tanh")
    o_g = g.add("ew", (gates[3],), gate_t, pdims=(0, 1), fn="sigmoid")
    fc = g.add("ew", (f_g, ci), gate_t, pdims=(0, 1), fn="mul")
    ig = g.add("ew", (i_g, g_g), gate_t, pdims=(0, 1), fn="mul")
    c2 = g.add("ew", (fc, ig), gate_t, pdims=(0, 1), fn="add")
    tc = g.add("ew", (c2,), gate_t, pdims=(0, 1), fn="tanh")
    h2 = g.add("ew", (o_g, tc), gate_t, pdims=(0, 1), fn="mul")
    return h2, c2


def _build_conv2d(g: TaskGraph, xi: int, ki: int, bi: Optional[int],
                  strides: tuple, padding: str,
                  activation: Optional[str]) -> int:
    x_t, k_t = g.nodes[xi].ttype, g.nodes[ki].ttype
    B, H, Wd, _ = x_t.shape
    kh, kw, cin, co = k_t.shape
    ho, wo = conv2d_out_hw(H, Wd, kh, kw, strides, padding)
    out_t = TensorType((B, ho, wo, co), x_t.dtype)
    head = g.add("conv2d", (xi, ki), out_t, pdims=(0, 1, 2, 3),
                 rdims=(("k", kh * kw * cin),),
                 strides=strides, padding=padding, k_elems=kh * kw * cin)
    if bi is not None:
        head = g.add("ew", (head, bi), out_t, pdims=(0, 1, 2, 3), fn="add")
    if activation:
        head = g.add("ew", (head,), out_t, pdims=(0, 1, 2, 3), fn=activation)
    return head


# ---------------------------------------------------------------------------
# Ops
# ---------------------------------------------------------------------------


def _sig(t) -> tuple:
    return (tuple(t.shape), dtype_name(t.dtype))


def linear(x, w, b=None, activation: Optional[str] = None, residual=None):
    """y = act(x @ w + b) (+ residual).  Library GEMM with open epilogue."""
    reg = _active_region()
    if reg is not None:
        head = _build_linear(reg.g, reg.nid_of(x), reg.nid_of(w),
                             None if b is None else reg.nid_of(b),
                             None if residual is None else reg.nid_of(residual),
                             activation)
        return reg.handle(head)
    sig = ("linear", _sig(x), _sig(w), None if b is None else _sig(b),
           activation, None if residual is None else _sig(residual))
    inputs = {"x": x, "w": w}
    if b is not None:
        inputs["b"] = b
    if residual is not None:
        inputs["res"] = residual

    def build(g: TaskGraph):
        xi = g.add_input("x", _tt(x))
        wi = g.add_input("w", _tt(w))
        bi = g.add_input("b", _tt(b)) if b is not None else None
        ri = g.add_input("res", _tt(residual)) if residual is not None else None
        g.set_outputs([_build_linear(g, xi, wi, bi, ri, activation)])

    return _execute(sig, build, inputs)[0]


def multi_linear(x, ws: Sequence, bs: Optional[Sequence] = None):
    """k projections of the same activation (Q,K,V).  In tapir mode the
    shared-input fusion pass turns these into ONE wide GEMM + slices."""
    bs = list(bs) if bs is not None else [None] * len(ws)
    reg = _active_region()
    if reg is not None:
        outs = _build_multi_linear(
            reg.g, reg.nid_of(x), [reg.nid_of(w) for w in ws],
            [None if b is None else reg.nid_of(b) for b in bs])
        return tuple(reg.handle(o) for o in outs)
    sig = ("multi_linear", _sig(x), tuple(_sig(w) for w in ws),
           tuple(None if b is None else _sig(b) for b in bs))
    inputs = {"x": x}
    for i, w in enumerate(ws):
        inputs[f"w{i}"] = w
    for i, b in enumerate(bs):
        if b is not None:
            inputs[f"b{i}"] = b

    def build(g: TaskGraph):
        xi = g.add_input("x", _tt(x))
        wis = [g.add_input(f"w{i}", _tt(w)) for i, w in enumerate(ws)]
        bis = [g.add_input(f"b{i}", _tt(b)) if b is not None else None
               for i, b in enumerate(bs)]
        g.set_outputs(_build_multi_linear(g, xi, wis, bis))

    return _execute(sig, build, inputs)


def gated_mlp(x, w_gate, w_up, w_down, activation: str = "silu"):
    """SwiGLU MLP: down( act(x@w_gate) * (x@w_up) ).  Gate/up share input ->
    fused into one GEMM; the mul and the down-proj epilogue fuse too."""
    reg = _active_region()
    if reg is not None:
        out = _build_gated_mlp(reg.g, reg.nid_of(x), reg.nid_of(w_gate),
                               reg.nid_of(w_up), reg.nid_of(w_down),
                               activation)
        return reg.handle(out)
    sig = ("gated_mlp", _sig(x), _sig(w_gate), _sig(w_up), _sig(w_down),
           activation)
    inputs = {"x": x, "wg": w_gate, "wu": w_up, "wd": w_down}

    def build(g: TaskGraph):
        xi = g.add_input("x", _tt(x))
        wg = g.add_input("wg", _tt(w_gate))
        wu = g.add_input("wu", _tt(w_up))
        wd = g.add_input("wd", _tt(w_down))
        g.set_outputs([_build_gated_mlp(g, xi, wg, wu, wd, activation)])

    return _execute(sig, build, inputs)[0]


def expert_mlp(xe, w_gate, w_up, w_down, activation: str = "silu"):
    """The batched expert FFN: ``xe [E, C, d]``, ``w_gate`` / ``w_up [E, d,
    f]``, ``w_down [E, f, d]``.  In tapir mode each GEMM is ONE launch of
    the kernel's grouped route, the gate's with its activation and product
    fused; in opaque mode each is E isolated 2-D launches, one per
    expert.  Under grad the one-off program runs under autograd (each
    GEMM through ``FusedMatmulFn``, the grouped ones with the grouped dX /
    dW as their backward); it is never graphed and donates nothing."""
    reg = _active_region()
    if reg is not None:
        out = _build_expert_mlp(reg.g, reg.nid_of(xe), reg.nid_of(w_gate),
                                reg.nid_of(w_up), reg.nid_of(w_down),
                                activation)
        return reg.handle(out)
    sig = ("expert_mlp", _sig(xe), _sig(w_gate), _sig(w_up), _sig(w_down),
           activation)
    inputs = {"x": xe, "wg": w_gate, "wu": w_up, "wd": w_down}

    def build(g: TaskGraph):
        xi = g.add_input("x", _tt(xe))
        g.nodes[xi].sharding = getattr(xe, SPEC_ATTR, None)
        wg = g.add_input("wg", _tt(w_gate))
        wu = g.add_input("wu", _tt(w_up))
        wd = g.add_input("wd", _tt(w_down))
        g.set_outputs([_build_expert_mlp(g, xi, wg, wu, wd, activation)])

    return _execute(sig, build, inputs)[0]


def attention(q, k, v, causal: bool = False, bias=None):
    """Multi-head attention library op.  q: [B,Sq,Hq,D], k/v:
    [B,Skv,Hkv,D]; GQA is implicit (Hq a multiple of Hkv); causal queries
    align to the end of the keys."""
    reg = _active_region()
    if reg is not None:
        out = _build_attention(reg.g, reg.nid_of(q), reg.nid_of(k),
                               reg.nid_of(v),
                               None if bias is None else reg.nid_of(bias),
                               causal)
        return reg.handle(out)
    sig = ("attention", _sig(q), _sig(k), _sig(v), causal,
           None if bias is None else _sig(bias))
    inputs = {"q": q, "k": k, "v": v}
    if bias is not None:
        inputs["bias"] = bias

    def build(g: TaskGraph):
        qi = g.add_input("q", _tt(q))
        ki = g.add_input("k", _tt(k))
        vi = g.add_input("v", _tt(v))
        bi = g.add_input("bias", _tt(bias)) if bias is not None else None
        g.set_outputs([_build_attention(g, qi, ki, vi, bi, causal)])

    return _execute(sig, build, inputs)[0]


def wkv_scan(q, k, v, w, u=None):
    """Gated linear-attention scan:  S_t = diag(w_t) S_{t-1} + k_t^T v_t,
    o_t = q_t S_t (+ u * (q_t . k_t) v_t bonus when u given — RWKV6).
    q/k/w: [B,S,H,Dk], v: [B,S,H,Dv], u: [H,Dk] or None."""
    reg = _active_region()
    if reg is not None:
        out = _build_wkv_scan(reg.g, reg.nid_of(q), reg.nid_of(k),
                              reg.nid_of(v), reg.nid_of(w),
                              None if u is None else reg.nid_of(u))
        return reg.handle(out)
    sig = ("wkv_scan", _sig(q), _sig(k), _sig(v), _sig(w),
           None if u is None else _sig(u))
    inputs = {"q": q, "k": k, "v": v, "w": w}
    if u is not None:
        inputs["u"] = u

    def build(g: TaskGraph):
        ins = [g.add_input(n, _tt(t)) for n, t in
               (("q", q), ("k", k), ("v", v), ("w", w))]
        ui = g.add_input("u", _tt(u)) if u is not None else None
        g.set_outputs([_build_wkv_scan(g, *ins, ui)])

    return _execute(sig, build, inputs)[0]


def elemwise(x, fn: str):
    """Unary elementwise op by registry name ("silu", "tanh", ...): one
    ``ew`` node on a traced tensor (fusable into an epilogue), eager
    otherwise."""
    if not isinstance(x, TracedTensor):
        return _EW[fn](x)
    reg = x._region
    if reg.closed:
        return _EW[fn](x.materialize())
    nid = reg.g.add("ew", (reg.nid_of(x),), x.ttype,
                    pdims=tuple(range(x.ndim)), fn=fn)
    return reg.handle(nid)


def lstm_step(x, h, c, W, b):
    """One LSTM cell step.  x: [B, xd], h / c: [B, hd], W: [xd+hd, 4*hd]
    (gates i, f, g, o), b: [4*hd].  Returns (h', c').

    The graph is the one stock XLA emitted, EIGHT GEMMs on slices of W plus
    adds, so it exposes all the logical parallelism.  In tapir mode CSE,
    the added-GEMM fusion and the shared-input fusion collapse them into ONE
    GEMM over ``concat(x, h)``; in opaque mode they stay eight sealed
    library calls."""
    reg = _active_region()
    if reg is not None:
        h2, c2 = _build_lstm_step(reg.g, reg.nid_of(x), reg.nid_of(h),
                                  reg.nid_of(c), reg.nid_of(W), reg.nid_of(b))
        return reg.handle(h2), reg.handle(c2)
    sig = ("lstm_step", _sig(x), _sig(h), _sig(c), _sig(W), _sig(b))
    inputs = {"x": x, "h": h, "c": c, "W": W, "b": b}

    def build(g: TaskGraph):
        ins = [g.add_input(n, _tt(inputs[n])) for n in ("x", "h", "c", "W",
                                                        "b")]
        g.set_outputs(list(_build_lstm_step(g, *ins)))

    return tuple(_execute(sig, build, inputs))


def conv2d(x, kern, b=None, strides=(1, 1), padding="SAME",
           activation: Optional[str] = None):
    """NHWC convolution with an HWIO kernel: the library op with an open
    epilogue (``b`` [co], ``activation``).  ``padding``: "SAME" (XLA's
    split, the odd pixel at the bottom / right) or "VALID"."""
    strides = tuple(int(s) for s in strides)
    reg = _active_region()
    if reg is not None:
        out = _build_conv2d(reg.g, reg.nid_of(x), reg.nid_of(kern),
                            None if b is None else reg.nid_of(b),
                            strides, padding, activation)
        return reg.handle(out)
    sig = ("conv2d", _sig(x), _sig(kern), None if b is None else _sig(b),
           strides, padding, activation)
    inputs = {"x": x, "k": kern}
    if b is not None:
        inputs["b"] = b

    def build(g: TaskGraph):
        xi = g.add_input("x", _tt(x))
        ki = g.add_input("k", _tt(kern))
        bi = g.add_input("b", _tt(b)) if b is not None else None
        g.set_outputs([_build_conv2d(g, xi, ki, bi, strides, padding,
                                     activation)])

    return _execute(sig, build, inputs)[0]


# ---------------------------------------------------------------------------
# Structured control flow
# ---------------------------------------------------------------------------


def _run_under(cfg: TapirConfig, body: Callable, *args):
    with use(cfg):
        return body(*args)


def scan_layers(body: Callable, stacked_params, x):
    """Run ``x = body(params_i, x)`` over a stacked layer tree (every leaf
    ``[L, ...]``), layer by layer in order.

    One Python loop serves both regimes.  Eagerly the per-layer params are
    the views ``unbind(0)`` makes of each stacked leaf, once: the same
    storage (and ``data_ptr``) as ``a[i]``, but under autograd one
    ``UnbindBackward`` stacks the L gradients once, where L ``a[i]`` would
    each zero-fill a whole stacked gradient.  Under region capture ``a[i]``
    is an ``index`` node, so the stack unrolls into the region graph and
    the passes see across layers.  The reference's ``lax.scan`` / unroll
    choice has no counterpart here (PyTorch runs eagerly).

    The config's ``remat`` wraps each layer as the reference's
    ``jax.checkpoint`` does: under ``"full"``, when grad is enabled, a
    layer keeps only its inputs and is recomputed in the backward
    (``torch.utils.checkpoint``, non-reentrant).  ``"dots"`` and
    ``"auto"`` are per-node decisions of the captured step (the stack
    unrolls into its region and ``pick_remat`` decides); eagerly they
    raise: ``torch.utils.checkpoint`` has no policy that keeps only the
    outputs of the GEMM's custom ``Function``."""
    cfg = get_config()
    leaves, spec = _flatten(stacked_params)
    traced = any(isinstance(a, TracedTensor) for a in leaves) \
        or isinstance(x, TracedTensor)
    if cfg.remat in ("dots", "auto") and not traced:
        raise NotImplementedError(
            f"remat={cfg.remat!r} is a policy of the captured training step "
            f"(--capture-step): torch.utils.checkpoint has no policy that "
            f"keeps only the outputs of the GEMM's custom autograd Function, "
            f"so eagerly only 'none' and 'full' exist")
    n = int(leaves[0].shape[0])
    if any(isinstance(a, TracedTensor) for a in leaves):
        layers = [[a[i] for a in leaves] for i in range(n)]
    else:
        per_leaf = [a.unbind(0) for a in leaves]
        layers = [[u[i] for u in per_leaf] for i in range(n)]
    fn = body
    if (cfg.remat == "full" and torch.is_grad_enabled()
            and not isinstance(x, TracedTensor)):
        # the recompute may run on autograd's device thread: it takes this
        # thread's config along
        def fn(p, h):
            return torch.utils.checkpoint.checkpoint(
                _run_under, cfg, body, p, h, use_reentrant=False)
    for p_i in layers:
        x = fn(_unflatten(spec, p_i), x)
    return x


# ---------------------------------------------------------------------------
# Introspection
# ---------------------------------------------------------------------------


def cache_stats() -> dict:
    """Program-cache counters (the L2 tier's among them), and the graph
    cache's: ``graphs`` live, ``graph_pool_bytes`` their pools hold,
    ``graph_captures``, ``graph_replays`` and ``graph_capture_s`` so
    far."""
    return dict(_CACHE_STATS, size=len(_CACHE), programs=len(_PROGRAMS),
                **graphs.CACHE.summary())


def replay_rules() -> dict[str, set]:
    """For each region name, the capture verdicts of its compiled
    programs (True: replayed as a CUDA graph on CUDA inputs)."""
    out: dict[str, set] = {}
    for key, prog in _CACHE.items():
        if key[0] == "region":
            out.setdefault(key[1][0], set()).add(prog.graphed)
    return out


def cached_graphs() -> dict[tuple, TaskGraph]:
    """Optimized TaskGraphs by cache key."""
    return dict(_GRAPHS)


def explain(g: Optional[TaskGraph] = None) -> str:
    """Per library node: the impl the registry chose, the candidate cost
    table, tiles and schedule notes — for ``g``, or for every graph
    compiled so far in this process."""
    if g is not None:
        return g.dump_schedule()
    if not _GRAPHS:
        return "(no compiled graphs yet — run something under tapir first)"
    parts = [gr.dump_schedule() for gr in _GRAPHS.values()]
    grad_graphs = [gr for gr in _GRAPHS.values()
                   if getattr(gr, "grad_meta", None)]
    if grad_graphs:
        lines = ["== gradient programs =="]
        for gr in grad_graphs:
            m = gr.grad_meta
            lines.append(
                f"  {gr.name}: {m['n_fwd']} fwd nodes, {m['n_bwd']} bwd "
                f"nodes; remat {m['remat']['store']} stored / "
                f"{m['remat']['recompute']} recomputed "
                f"({m['bytes_stored']} B stored vs "
                f"{m['bytes_recomputed']} B recomputed)")
            for nid in sorted(gr.nodes):
                node = gr.nodes[nid]
                if node.schedule.remat:
                    lines.append(f"    %{nid} {node.op}: "
                                 f"{node.schedule.remat}")
        parts.append("\n".join(lines))
    if _PROVENANCE:
        lines = ["== program cache provenance =="]
        for info in _PROVENANCE.values():
            lines.append(f"  {info['name']}: {info['source']} "
                         f"digest={info['digest'][:12]}")
        parts.append("\n".join(lines))
    return "\n".join(parts)


def program_cache(cfg: Optional[TapirConfig] = None):
    """The active on-disk ``ProgramDiskCache`` for ``cfg`` (default: the
    current config), or None when disabled.  Its ``clear()`` and
    ``invalidate(fingerprint)`` are the store-wide maintenance that the
    in-memory ``clear_cache()`` deliberately does not do."""
    return _l2_for(cfg or get_config())


def invalidate_mesh(fingerprint: tuple) -> int:
    """Drop every cached program, graph and replay entry compiled under
    mesh ``fingerprint`` (the last element of every key), its CUDA
    graphs, and its entries in every attached on-disk store, so a mesh
    that left the job cannot replay, from memory or from disk.  Returns
    the number of entries evicted (memory + disk)."""
    fingerprint = tuple(tuple(p) for p in fingerprint)
    n = 0
    for cache in (_CACHE, _GRAPHS, _PROGRAMS, _PROVENANCE):
        dead = [k for k in cache if k and k[-1] == fingerprint]
        for k in dead:
            del cache[k]
        n += len(dead)
    graphs.CACHE.drop(lambda k: bool(k) and k[-1] == fingerprint)
    for l2 in _L2_INSTANCES.values():
        n += l2.invalidate(fingerprint)
    return n


def clear_cache() -> None:
    """Drop the in-memory (L1) tier only: every program, graph, replay
    entry and CUDA graph.  The on-disk store is untouched (use
    ``program_cache().clear()``)."""
    _CACHE.clear()
    _GRAPHS.clear()
    _PROGRAMS.clear()
    _PROVENANCE.clear()
    graphs.CACHE.clear()
    _CACHE_STATS.update({k: 0.0 if k.endswith("_s") else 0
                         for k in _CACHE_STATS})
