"""Serving: slot-paged KV cache with mid-wave continuous batching — the port
of the JAX package's ``serve/engine.py`` slot path.

``ServingEngine`` schedules requests over a fixed pool of ``slots``:

* **admit** — a request enters any free slot *mid-decode* through
  ``model.prefill_into_slot``: its prompt (right-padded to a power-of-two
  bucket) prefills in one shot; a resident shared prefix is bound first so
  only the divergent suffix runs (an exact-cover prompt copies its boundary
  page on write).
* **decode** — every step runs ALL slots through
  ``model.decode_step_slots``: each block is ONE region program replayed
  from ``_PROGRAMS`` whichever slots are live; pools update in place.
* **free** — a finished request releases its slot at once.  A strictly
  higher-priority arrival may preempt the lowest-priority slot, parked
  (pages copied aside) or dropped for replay, by the ``preempt_cost``
  roofline.

``run_wave`` is the A/B baseline: the same slot primitives with wave
admission.  Per-request outputs are bitwise identical between the two,
between prefix sharing on and off, and between regions on and off.

The host reads each step's argmax tokens (the reference's behaviour); the
loop adds no other device synchronization.

``make_prefill_step`` / ``make_decode_step`` drive the padded cache of
``model.init_cache``.  A family without slots (RWKV6, Zamba2) is served
by the reference's padded-wave loop over them (``_run_padded_waves``):
``run`` and ``run_wave`` both take it.

The step-time statistics (``last_stats``' ``step_p50`` / ``step_p95``,
the SLO shed's estimate, ``preempt_cost``'s step time) come from the
decode steps' ``StragglerWatchdog`` (``dist/fault.py``, a rolling window
of 256), as the reference takes them.

**Faults** (``_run_slots``): the slot session runs under a supervised
recovery loop.  ``ServeConfig.fault_injector`` is consulted before every
pool-wide decode step: a ``crash`` or ``host`` fault aborts the session,
and the next attempt restores the latest slot checkpoint (or, with none,
replays from scratch) and goes on; greedy decode is deterministic, so
every request's tokens equal a clean run's.  On one device a ``host``
fault is a same-device restore, as the reference's is without a mesh.
A ``straggle`` fault slows the step; the watchdog flags it, and
``straggle_patience`` flagged steps in a row pause admission for a
bounded, doubling number of ticks (``shed_base`` .. ``shed_cap``), after
``straggle_escalate`` such rounds the engine checkpoints and raises a
``host`` fault.  Past ``max_failures`` recoveries the run gives up.

**Slot checkpoints** (``ckpt_dir``, every ``ckpt_every`` decode steps
and on demand): the pools, ``ptab``, ``pos`` and the ``rng`` leaf through
``checkpoint/ckpt.py`` in the reference's format (a checkpoint written by
either engine restores in the other), the scheduler's host state
(queue, slots, feed tokens, every request's tokens, ``PagePool.to_meta``,
the stats) as its JSON meta.  A save copies the device state to the host
before it returns (the pools are updated in place, so a snapshot that
aliased them would move on with them); a restore copies the checkpoint
into the session's own pools, so every decode step's inputs stay the same
tensors (no CUDA graph is captured anew).

``ServeConfig.program_cache_dir`` points the engine's region programs at
the on-disk program store (``repro_torch.cache``): a warm replica compiles
none of them, and ``last_stats`` carries each run's cache counters
(``compiled_programs``, ``l2_hits``, ...) and where its cold-start seconds
went (tracing, building programs, the store, CUDA-graph capture).

**Meshes** (``ServingEngine(mesh=...)``; tensor parallel, and expert
parallel for the MoE family): one engine per rank, every rank running the
same host loop.  The slot parameters are pinned to their blocks
(``pin_slot_params``: only N dims split, K dims replicated, an expert
leaf split into whole experts), the page pools to theirs
(``slot_cache_shardings``: kv heads over ``model``, replicated over
``data``), and the slot programs capture and key under the ambient mesh,
whose lowering gathers in rank order where a value must be whole: every
rank's tokens are the one-device engine's bit for bit.  A ``host`` fault
that blames a rank shrinks the mesh without that rank's data row
(``launch.mesh.shrink_mesh``; every rank helps form the new groups, then
the evicted ones leave the run), purges the old fingerprint's programs
(``tapir.invalidate_mesh``, both tiers), re-pins the parameters and
restores the latest slot checkpoint through ``shardings=``.  A slot
checkpoint holds whole leaves (gathered, written by the mesh's first
rank), so it restores onto any mesh.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np
import torch

from ..cache.disk import check_cache_mode
from ..checkpoint.ckpt import restore_checkpoint, save_checkpoint
from ..core.schedule import CPU_COST_MODEL, H100_COST_MODEL
from ..core.tapir import (SPEC_ATTR, TapirConfig, cache_stats,
                          invalidate_mesh, use)
from ..dist.fault import Fault, FaultInjector, StragglerWatchdog
from ..dist.sharding import (NamedSharding, gather_full, local_shape,
                             logical_to_pspec, place, tree_map_axes,
                             use_mesh, weight_spec)
from ..models.base import placement_axes, resolve_device
from ..models.layers import bucket_pow2
from .pages import (PagePool, copy_cache_pages, identity_row, preempt_cost,
                    private_page)


@dataclass(frozen=True)
class ServeConfig:
    mode: str = "tapir"
    #: schedule cost model: "gpu" (the H100 profile) | "cpu"
    target: str = "gpu"
    #: region capture (False = the per-op control)
    regions: bool = True
    #: "strict" raises on a request whose prompt + max_new overflows the
    #: slot page; "reject" counts it and serves the rest; "slo" also sheds
    #: requests whose ``deadline_s`` the observed step p50 cannot meet
    admit_policy: str = "strict"
    #: bind resident shared-prefix pages on admit (prefill only the suffix)
    prefix_sharing: bool = True
    #: KV page length (None: 64 when it divides max_len, else max_len)
    page_len: Optional[int] = None
    #: shared-region size in pages (None: one slot's worth per slot)
    shared_pages: Optional[int] = None
    #: eviction arm for priority preemption: "auto" | "park" | "replay"
    preempt_mode: str = "auto"
    # -- fault tolerance (slot path; see ``_run_slots``) ------------------
    #: deterministic fault source, consulted before every pool decode step
    fault_injector: Optional[FaultInjector] = None
    #: slot-state checkpoints (pools, per-slot pos, queue, rng) land here;
    #: None disables durability — recovery replays from scratch
    ckpt_dir: Optional[str] = None
    #: decode steps between periodic checkpoints (0 = on-demand only)
    ckpt_every: int = 0
    #: recoveries before the run gives up
    max_failures: int = 8
    #: watchdog: a step slower than threshold x rolling median is flagged
    straggler_threshold: float = 4.0
    #: consecutive flagged steps before admission sheds load
    straggle_patience: int = 3
    #: the shed pause starts at shed_base decode ticks and doubles per
    #: round (bounded exponential backoff) up to shed_cap
    shed_base: int = 2
    shed_cap: int = 16
    #: shed rounds with straggle persisting before the suspect host is
    #: evicted (checkpoint -> restore)
    straggle_escalate: int = 3
    # -- persistent program cache (L2; see ``repro_torch.cache``) ---------
    #: on-disk program store; None serves memory-only (every process
    #: compiles its own region programs)
    program_cache_dir: Optional[str] = None
    #: "off" | "read" (probe, never publish — replicas behind a shared
    #: read-only store) | "readwrite"
    cache_mode: str = "readwrite"

    def __post_init__(self):
        check_cache_mode(self.cache_mode)
        if self.target not in ("gpu", "cpu"):
            raise ValueError(f"target must be 'gpu' or 'cpu', got "
                             f"{self.target!r}")
        if self.admit_policy not in ("strict", "reject", "slo"):
            raise ValueError(
                f"admit_policy must be 'strict', 'reject' or 'slo', "
                f"got {self.admit_policy!r}")
        if self.preempt_mode not in ("auto", "park", "replay"):
            raise ValueError(
                f"preempt_mode must be 'auto', 'park' or 'replay', "
                f"got {self.preempt_mode!r}")
        if self.shed_base < 0 or self.shed_cap < 0:
            raise ValueError(
                f"shed_base/shed_cap must be >= 0, got "
                f"{self.shed_base}/{self.shed_cap}")
        if self.page_len is not None and self.page_len <= 0:
            raise ValueError(f"page_len must be positive, got "
                             f"{self.page_len}")
        if self.shared_pages is not None and self.shared_pages < 0:
            raise ValueError(f"shared_pages must be >= 0, got "
                             f"{self.shared_pages}")

    def cost_model(self):
        return H100_COST_MODEL if self.target == "gpu" else CPU_COST_MODEL

    def tapir_config(self) -> TapirConfig:
        return TapirConfig(mode=self.mode, cost_model=self.cost_model(),
                           regions=self.regions,
                           program_cache_dir=self.program_cache_dir,
                           cache_mode=self.cache_mode)


def _shardings(tree, axes, mesh):
    """``NamedSharding`` tree from parallel (tensor or shape, logical-axes)
    trees: the one rule for every serving cache layout (a ``batch`` dim
    over the data axes, the rest by ``logical_to_pspec``)."""
    def one(ax, t):
        shape = tuple(getattr(t, "shape", t))
        return NamedSharding(mesh, logical_to_pspec(ax, mesh, shape=shape)
                             if ax else ())
    return tree_map_axes(one, axes, tree)


def _placed_axes(model, axes, mesh):
    return tree_map_axes(lambda ax: placement_axes(model.cfg, ax, mesh),
                         axes)


def cache_shardings(model, mesh, batch: int, max_len: int):
    """``NamedSharding`` tree of the padded cache of ``model.init_cache``."""
    return _shardings(model.cache_shapes(batch, max_len),
                      _placed_axes(model, model.cache_axes(), mesh), mesh)


def slot_cache_shardings(model, mesh, slots: int, max_len: int,
                         page_len: Optional[int] = None,
                         shared_pages: Optional[int] = None):
    """``NamedSharding`` tree of the slot-paged cache: per-layer
    ``[P, page_len, Hkv, hd]`` pools with kv heads over ``model`` (when
    they divide), replicated over ``data``; the page dims stay whole
    (per-slot writes land at data-dependent pages)."""
    return _shardings(model.slot_cache_shapes(slots, max_len, page_len,
                                              shared_pages),
                      _placed_axes(model, model.slot_cache_axes(), mesh),
                      mesh)


def place_tree(tree, shardings):
    """Each leaf of ``tree`` (whole) as this rank's block of its
    ``NamedSharding``, carrying its layout."""
    def one(sh, t):
        return place(t, sh.spec, sh.mesh) if sh.spec else t
    if isinstance(shardings, NamedSharding):
        return one(shardings, tree)
    if isinstance(shardings, dict):
        return {k: place_tree(tree[k], shardings[k]) for k in shardings}
    return type(shardings)(place_tree(t, sh) for t, sh in zip(tree,
                                                              shardings))


def pin_slot_params(model, sp, mesh):
    """The ``slot_params`` tree with its decode layout, the forward's
    placement (``dist.sharding.weight_spec``): a dense leaf shards only
    its LAST dim, and only when its logical axis maps to ``model`` and
    divides.  The GEMM N dims (wq / wk / wv / wg / wu / the head: column
    sharding, every output element summed on one rank) split over
    ``model``; the K-dim weights (wo, wd) stay replicated — a K split
    would add partial sums across ranks and break the bitwise serving
    guarantee.  An expert leaf (``ewg`` / ``ewu`` / ``ewd``) shards its
    expert dim over ``model`` where that divides ``E``: a rank holds
    whole experts.  A whole leaf is cut to this rank's block; a leaf that
    already is that block (a model built on the mesh) is checked and
    kept."""
    if mesh is None or mesh.size <= 1:
        return sp
    if getattr(model, "mesh_layout", None) is not None:
        model.check_mesh(mesh)
    axes = _placed_axes(model, model.slot_param_axes(), mesh)

    def one(ax, shape, v):
        if not hasattr(v, "shape"):
            return v                     # ("dense" / "moe") kind markers
        spec = weight_spec(ax, shape, mesh)
        if tuple(v.shape) == tuple(shape):
            return place(v, spec, mesh)
        if tuple(v.shape) != local_shape(shape, spec, mesh):
            raise ValueError(f"slot param {tuple(v.shape)} is neither "
                             f"{tuple(shape)} nor its block under {spec}")
        setattr(v, SPEC_ATTR, spec)
        return v

    return tree_map_axes(one, axes, model.slot_param_shapes(), sp)


def _check_mesh(mesh) -> None:
    """A mesh is ``launch.mesh.Mesh`` (or None): anything else is refused
    before it reaches a program key."""
    from ..launch.mesh import Mesh
    if mesh is not None and not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a launch.mesh.Mesh or None, got "
                        f"{type(mesh).__name__}")


def make_prefill_step(model, mesh=None, cfg: ServeConfig = ServeConfig()):
    """``prefill(tokens [B, S], cache) -> (logits [B, vocab], cache)``: the
    padded-cache prefill of ``model.init_cache``'s cache under ``cfg``, on
    the model's device.  The cache's K/V tensors are written in place (the
    reference donates the cache).  On a ``mesh`` the step runs under it;
    a whole cache is first cut to this rank's blocks (``cache_shardings``,
    the returned cache), and the logits come back whole."""
    _check_mesh(mesh)
    tap = cfg.tapir_config()

    def prefill(tokens, cache):
        with use_mesh(mesh), use(tap):
            if mesh is not None and mesh.size > 1 and \
                    getattr(cache["k"], SPEC_ATTR, None) is None:
                cache = place_tree(cache, cache_shardings(
                    model, mesh, int(cache["k"].shape[1]),
                    int(cache["k"].shape[2])))
            return model.prefill(torch.as_tensor(tokens, device=model.device),
                                 cache)

    return prefill


def make_decode_step(model, mesh=None, cfg: ServeConfig = ServeConfig()):
    """``decode(tokens [B, 1], cache) -> (next_token [B] int32, cache)``:
    one greedy step (argmax, the first index on a tie), under ``mesh``
    when given (the cache as ``make_prefill_step`` returned it)."""
    _check_mesh(mesh)
    tap = cfg.tapir_config()

    def decode(tokens, cache):
        with use_mesh(mesh), use(tap):
            logits, cache = model.decode_step(
                torch.as_tensor(tokens, device=model.device), cache)
        return torch.argmax(logits, dim=-1).to(torch.int32), cache

    return decode


@dataclass
class Request:
    rid: int
    prompt: np.ndarray           # [S] int32
    max_new: int = 32
    #: scheduling priority, 0 (lowest) .. 9 (highest)
    priority: int = 0
    #: SLO deadline in seconds from run start (admit_policy="slo")
    deadline_s: Optional[float] = None
    #: earliest pool decode step at which the request is schedulable
    arrival_step: int = 0
    out: list = field(default_factory=list)
    done: bool = False

    def __post_init__(self):
        if not 0 <= int(self.priority) <= 9:
            raise ValueError(
                f"request {self.rid}: priority must be in 0..9, got "
                f"{self.priority}")
        if self.arrival_step < 0:
            raise ValueError(
                f"request {self.rid}: arrival_step must be >= 0, got "
                f"{self.arrival_step}")


class _EngineFault(Exception):
    """Aborts the slot session; carries the injected Fault."""

    def __init__(self, fault: Fault):
        super().__init__(f"injected fault: {fault}")
        self.fault = fault


@dataclass
class _SlotRunState:
    """Everything a slot session needs to resume: the device state
    (``cache`` pools + page table + ``rng``) checkpoints as one tree, the
    host-side scheduler and page-policy fields as the checkpoint's JSON
    meta; all of it rolls back together on a restore."""
    cache: Any
    rng: Any
    slot_idx: list               # per-slot index into ``requests``, -1 free
    slot_steps: list             # per-slot decode-step budget used
    tokens: np.ndarray           # [slots, 1] next feed token per slot
    tokens_dev: Any              # its device copy, one buffer for the run
    pool: PagePool
    ptab_host: np.ndarray        # [slots, pps] mirror of cache["ptab"]
    pending: list = field(default_factory=list)
    fed: list = field(default_factory=list)      # per-slot out tokens fed
    slot_seq: list = field(default_factory=list)  # admission order stamp
    seq: int = 0
    parked: dict = field(default_factory=dict)   # rid -> feed-state record
    step: int = 0                # completed pool-wide scheduler ticks
    occ_sum: float = 0.0
    st: dict = field(default_factory=dict)
    backoff: int = 0             # admission pause ticks remaining (shed)
    shed_rounds: int = 0
    straggle_run: int = 0        # consecutive flagged steps
    suspect: Optional[int] = None  # device id blamed for the straggle


def _pct(xs, q) -> float:
    return float(np.percentile(xs, q)) if xs else 0.0


#: cache counters surfaced per run as deltas in ``last_stats`` (the
#: reference's ``_CACHE_KEYS``): a warm replica shows
#: ``compiled_programs=0, l2_hits>0``
CACHE_KEYS = ("compiled_programs", "l2_hits", "l2_misses", "l2_quarantined",
              "l2_writes", "l2_fallbacks")
#: and where a run's host seconds outside its kernels went: tracing region
#: bodies, building programs (pipeline + emit, or an L2 load), of which
#: the store's own share, and capturing CUDA graphs
COST_KEYS = ("graph_captures", "trace_s", "pipeline_s", "l2_s",
             "graph_capture_s")


def _cache_snap() -> dict:
    st = cache_stats()
    return {k: st[k] for k in CACHE_KEYS + COST_KEYS}


def _cache_deltas(snap: dict) -> dict:
    now = _cache_snap()
    return {k: now[k] - snap[k] for k in snap}


class ServingEngine:
    """Host-side serving loop: a slot allocator over a paged KV cache
    (continuous batching, greedy sampling)."""

    def __init__(self, model, batch: int = 8, max_len: int = 2048,
                 cfg: ServeConfig = ServeConfig(), device="cuda", mesh=None):
        _check_mesh(mesh)
        self.device = resolve_device(device)
        if model.device.type != self.device.type:
            raise ValueError(f"model lives on {model.device}, engine on "
                             f"{self.device}")
        self.model = model
        self.batch, self.max_len = batch, max_len
        self.slots = batch
        self.cfg = cfg
        #: scheduling stats of the most recent ``run``/``run_wave`` call
        self.last_stats: dict = {}
        self._sp = None            # the run's params (compute_params)
        #: the mesh this rank serves on (None: one device); a host fault
        #: shrinks it, and a rank it evicts stops serving (``evicted``)
        self.mesh = mesh
        self.evicted = False

    def run(self, requests: list[Request],
            max_steps: int = 256) -> list[Request]:
        """Continuous batching: requests admit into free slots mid-decode,
        finished slots free immediately.  ``max_steps`` caps each request's
        decode-step budget (exhausted: freed with ``done=False``).  A
        family without slots (RWKV6, Zamba2) is served by padded waves."""
        if not self.model.supports_slots():
            return self._run_padded_waves(requests, max_steps)
        return self._run_slots(requests, max_steps, continuous=True)

    def run_wave(self, requests: list[Request],
                 max_steps: int = 256) -> list[Request]:
        """A/B baseline: the same slot primitives with WAVE scheduling —
        admit a full batch, decode until every member finishes, repeat."""
        if not self.model.supports_slots():
            return self._run_padded_waves(requests, max_steps)
        return self._run_slots(requests, max_steps, continuous=False)

    # -- padded-wave loop (families without slots) -------------------------
    def _run_padded_waves(self, requests: list[Request],
                          max_steps: int = 256) -> list[Request]:
        """Padded-batch waves over ``model.prefill`` / ``decode_step``:
        prompts left-PADDED to the wave's longest (pad tokens sit at the
        sequence start and are processed), one prefill, then greedy decode
        until every member is done or ``max_steps`` is reached; the wave
        blocks until its slowest member finishes."""
        prefill = make_prefill_step(self.model, self.mesh, cfg=self.cfg)
        decode = make_decode_step(self.model, self.mesh, cfg=self.cfg)
        for r in requests:
            r.out, r.done = [], False
        st = {"tokens": 0, "admitted": 0, "rejected": 0, "preempted": 0,
              "decode_steps": 0}
        occ_sum = 0.0
        ttft = []
        snap = _cache_snap()
        t0 = time.perf_counter()
        for wave_start in range(0, len(requests), self.batch):
            wave = requests[wave_start: wave_start + self.batch]
            B = len(wave)
            st["admitted"] += B
            S = max(len(r.prompt) for r in wave)
            toks = np.zeros((B, S), np.int32)
            for i, r in enumerate(wave):
                toks[i, S - len(r.prompt):] = r.prompt    # left-pad
            cache = self.model.init_cache(B, self.max_len)
            logits, cache = prefill(toks, cache)
            nxt = torch.argmax(logits, dim=-1).to(torch.int32)
            steps = 0
            while not all(r.done for r in wave) and steps < max_steps:
                occ_sum += sum(not r.done for r in wave) / self.batch
                st["decode_steps"] += 1
                nxt_np = nxt.cpu().numpy()
                for i, r in enumerate(wave):
                    if not r.done:
                        if not r.out:
                            ttft.append(time.perf_counter() - t0)
                        r.out.append(int(nxt_np[i]))
                        st["tokens"] += 1
                        if len(r.out) >= r.max_new:
                            r.done = True
                nxt, cache = decode(nxt[:, None], cache)
                steps += 1
            st["preempted"] += sum(not r.done for r in wave)
        wall = time.perf_counter() - t0
        st.update(wall_s=wall, ttft_p50=_pct(ttft, 50),
                  ttft_p95=_pct(ttft, 95),
                  tok_per_s=st["tokens"] / wall if wall > 0 else 0.0,
                  mean_occupancy=(occ_sum / st["decode_steps"]
                                  if st["decode_steps"] else 0.0),
                  **_cache_deltas(snap))
        self.last_stats = st
        return requests

    def _fresh_slot_state(self, requests, tokens_dev=None) -> _SlotRunState:
        """A new session from scratch: a fresh slot cache, every request
        queued.  ``tokens_dev`` (the run's feed buffer) is reused when
        given, so a replay keeps the decode step's input tensor."""
        for r in requests:
            r.out, r.done = [], False
        cfg = self.cfg
        pool = PagePool(self.slots, self.max_len, cfg.page_len,
                        cfg.shared_pages)
        if tokens_dev is None:
            tokens_dev = torch.zeros((self.slots, 1), dtype=torch.int32,
                                     device=self.device)
        return _SlotRunState(
            cache=self._init_slot_cache(),
            # greedy today; checkpointed as the reference's PRNGKey(0), so
            # a sampler fits the same recovery protocol and state schema
            rng=torch.zeros((2,), dtype=torch.uint32, device=self.device),
            slot_idx=[-1] * self.slots,
            slot_steps=[0] * self.slots,
            tokens=np.zeros((self.slots, 1), np.int32),
            tokens_dev=tokens_dev,
            pool=pool,
            ptab_host=np.stack([identity_row(s, pool.pps)
                                for s in range(self.slots)]),
            pending=list(range(len(requests))),
            fed=[0] * self.slots,
            slot_seq=[0] * self.slots,
            st={"tokens": 0, "admitted": 0, "rejected": 0, "preempted": 0,
                "decode_steps": 0, "prefix_hits": 0,
                "prefix_tokens_saved": 0, "preemptions": 0, "parked": 0,
                "replayed": 0, "slo_shed": 0})

    def _multi(self) -> bool:
        return self.mesh is not None and self.mesh.size > 1

    def _init_slot_cache(self):
        """A fresh slot cache; on a mesh each pool is this rank's block
        (``slot_cache_shardings``)."""
        cfg = self.cfg
        cache = self.model.init_slot_cache(self.slots, self.max_len,
                                           cfg.page_len, cfg.shared_pages)
        if self._multi():
            cache = place_tree(cache, self._cache_shardings())
        return cache

    def _cache_shardings(self):
        cfg = self.cfg
        return slot_cache_shardings(self.model, self.mesh, self.slots,
                                    self.max_len, cfg.page_len,
                                    cfg.shared_pages)

    def _mesh_fp(self) -> tuple:
        """The fingerprint of ``self.mesh`` (``passes.mesh_fingerprint``'s
        form, of this explicit mesh)."""
        return () if self.mesh is None else self.mesh.fingerprint

    def _build_slot_params(self):
        return pin_slot_params(self.model, self.model.slot_params(),
                               self.mesh)

    def _save_slot_ckpt(self, rs: _SlotRunState, requests, ft: dict) -> None:
        """One atomic snapshot: the pools, ``ptab``, per-slot ``pos`` and
        ``rng`` as the device tree (copied to the host before the write:
        the pools move on in place), the queue, slot assignments, feed
        tokens, every admitted request's progress and the stats as JSON
        meta, in the reference's layout.  A restore rewinds all of it."""
        if self.cfg.ckpt_dir is None:
            return
        meta = {"step": rs.step,
                "pending": [int(i) for i in rs.pending],
                "slot_idx": [int(i) for i in rs.slot_idx],
                "slot_steps": [int(s) for s in rs.slot_steps],
                "tokens": [int(t) for t in rs.tokens[:, 0]],
                "fed": [int(f) for f in rs.fed],
                "slot_seq": [int(q) for q in rs.slot_seq],
                "seq": int(rs.seq),
                "outs": {str(i): [int(t) for t in requests[i].out]
                         for i in range(len(requests)) if requests[i].out},
                "done": [i for i, r in enumerate(requests) if r.done],
                "parked": {str(r): {"tok": int(v["tok"]),
                                    "steps": int(v["steps"]),
                                    "fed": int(v["fed"])}
                           for r, v in rs.parked.items()},
                "pool": rs.pool.to_meta(),
                "st": {k: int(v) for k, v in rs.st.items()},
                "occ_sum": float(rs.occ_sum)}
        state = {"cache": rs.cache, "rng": rs.rng}
        if not self._multi():
            save_checkpoint(self.cfg.ckpt_dir, rs.step, state, keep_n=2,
                            blocking=True, meta=meta)
        else:
            # whole leaves (every rank gathers: a collective), written by
            # the mesh's first rank; the others wait for the commit
            full = {"cache": {k: ([gather_full(t, self.mesh) for t in v]
                                  if isinstance(v, list)
                                  else gather_full(v, self.mesh))
                              for k, v in rs.cache.items()},
                    "rng": rs.rng}
            if self.mesh.rank == self.mesh.leader():
                save_checkpoint(self.cfg.ckpt_dir, rs.step, full, keep_n=2,
                                blocking=True, meta=meta)
            self.mesh.barrier()
        ft["checkpoints"] += 1

    def _restore_slot_state(self, requests, ft: dict,
                            rs: _SlotRunState) -> _SlotRunState:
        """The latest slot checkpoint copied into the failed session's own
        pools, ``ptab``, ``pos`` and ``rng`` (``rs``: each tensor keeps its
        storage), with the host state from its meta.  No checkpoint: a
        fresh session; greedy decode is deterministic, so a replay from
        scratch still ends in the clean run's tokens."""
        ft["restores"] += 1
        if self.cfg.ckpt_dir is None:
            return self._fresh_slot_state(requests, rs.tokens_dev)
        shardings = None
        if self._multi():
            # the CURRENT mesh's layout: after a shrink, the new one's
            shardings = {"cache": self._cache_shardings(),
                         "rng": NamedSharding(self.mesh, ())}
        try:
            state, _, manifest = restore_checkpoint(
                self.cfg.ckpt_dir, {"cache": rs.cache, "rng": rs.rng},
                shardings=shardings)
        except FileNotFoundError:
            return self._fresh_slot_state(requests, rs.tokens_dev)
        meta = manifest["meta"]
        done = set(meta["done"])
        for i, r in enumerate(requests):
            out = meta["outs"].get(str(i))
            r.out = list(out) if out is not None else []
            r.done = i in done
        return _SlotRunState(
            cache=state["cache"], rng=state["rng"],
            slot_idx=list(meta["slot_idx"]),
            slot_steps=list(meta["slot_steps"]),
            tokens=np.asarray(meta["tokens"], np.int32).reshape(-1, 1),
            tokens_dev=rs.tokens_dev,
            pool=PagePool.from_meta(meta["pool"], self.slots, self.max_len,
                                    self.cfg.page_len,
                                    self.cfg.shared_pages),
            ptab_host=state["cache"]["ptab"].cpu().numpy().copy(),
            pending=list(meta["pending"]),
            fed=list(meta["fed"]),
            slot_seq=list(meta["slot_seq"]), seq=int(meta["seq"]),
            parked={int(r): dict(v) for r, v in meta["parked"].items()},
            step=int(meta["step"]),
            occ_sum=float(meta["occ_sum"]), st=dict(meta["st"]))

    def _handle_fault(self, fault: Fault, ft: dict) -> None:
        """Post-mortem reconfiguration: a fault blaming a mesh rank evicts
        its data row (shrunk mesh -> new fingerprint -> a clean compile);
        the dead fingerprint's programs are purged from memory and disk
        so nothing stale can replay, and the parameters are re-pinned.  A
        crash without a blamed rank (or on one device) restores on the
        same mesh: programs and params survive, so the replay hits the
        program cache."""
        old_fp = self._mesh_fp()
        if fault.host is not None and self.mesh is not None:
            from ..launch.mesh import shrink_mesh
            try:
                new_mesh = shrink_mesh(self.mesh, fault.host)
            except ValueError:
                new_mesh = None     # not in the mesh / pure TP: same mesh
            if new_mesh is not None:
                self.mesh = new_mesh
                ft["mesh_shrinks"] += 1
                self.evicted = not new_mesh.member
        if self._mesh_fp() != old_fp:
            invalidate_mesh(old_fp)
            self._sp = None         # re-pin params on the new mesh

    def _run_slots(self, requests, max_steps: int, continuous: bool):
        """The recovery loop around the slot session: a session runs until
        an injected (or escalated) fault aborts it; the next attempt
        restores the latest checkpoint and replays.  Every request's
        tokens equal a fault-free run's: everything the session reads
        (pools, pos, queue, feed tokens, request progress) rolls back to
        one snapshot, and greedy decode is deterministic."""
        cfg = self.cfg
        wd = StragglerWatchdog(threshold=cfg.straggler_threshold)
        ft = {"failures": 0, "restores": 0, "mesh_shrinks": 0,
              "checkpoints": 0, "shed_steps": 0, "shed_rounds": 0}
        snap = _cache_snap()
        t0 = time.perf_counter()
        # wall-clock observability rides outside the checkpointed stats
        ft["_t0"] = t0
        ft["_ttft"] = []
        ft["_qwait"] = []
        rs = None
        self._sp = None
        while True:
            try:
                with use_mesh(self.mesh), use(cfg.tapir_config()):
                    if self._sp is None:
                        self._sp = self._build_slot_params()
                    rs = self._fresh_slot_state(requests) if rs is None \
                        else self._restore_slot_state(requests, ft, rs)
                    self._slot_session(requests, max_steps, continuous, rs,
                                       ft, wd)
                break
            except _EngineFault as ef:
                ft["failures"] += 1
                if ft["failures"] > cfg.max_failures:
                    raise RuntimeError(
                        f"slot serving failed {ft['failures']} times; "
                        "giving up") from ef
                with use(cfg.tapir_config()):
                    self._handle_fault(ef.fault, ft)
                if self.evicted:
                    break           # this rank left the mesh
        wall = time.perf_counter() - t0
        ttft, qwait = ft.pop("_ttft"), ft.pop("_qwait")
        ft.pop("_t0")
        st = rs.st
        st.update(ft, straggler_steps=len(wd.flagged),
                  step_p50=wd.p50, step_p95=wd.p95,
                  ttft_p50=_pct(ttft, 50), ttft_p95=_pct(ttft, 95),
                  queue_wait_p50=_pct(qwait, 50),
                  queue_wait_p95=_pct(qwait, 95),
                  wall_s=wall,
                  tok_per_s=st["tokens"] / wall if wall > 0 else 0.0,
                  mean_occupancy=(rs.occ_sum / st["decode_steps"]
                                  if st["decode_steps"] else 0.0),
                  **_cache_deltas(snap))
        self.last_stats = st
        return requests

    # -- page-policy helpers ---------------------------------------------
    def _push_ptab(self, rs: _SlotRunState) -> None:
        """Mirror the host page table to the device, in place: page
        indirection is DATA, so this is the only thing a rebinding ever
        changes, and the table stays the tensor the step's programs read."""
        rs.cache["ptab"].copy_(torch.from_numpy(rs.ptab_host))

    def _reset_slot(self, s: int, rs: _SlotRunState) -> None:
        rs.ptab_host[s] = identity_row(s, rs.pool.pps)
        self._push_ptab(rs)
        rs.cache["pos"][s] = 0

    def _release(self, s: int, rs: _SlotRunState, slot_req) -> None:
        """Free slot ``s``: drop its shared-prefix binding and reset its
        page-table row to the private identity run."""
        rs.pool.unbind(s)
        slot_req[s] = None
        rs.slot_idx[s] = -1
        self._reset_slot(s, rs)

    def _flops_per_tok(self) -> float:
        return 2.0 * sum(p.numel() for p in self.model.parameters())

    def _page_bytes(self, rs: _SlotRunState) -> int:
        """Bytes one page copy moves (K+V, all layers)."""
        k0 = rs.cache["k"][0]
        return k0[0].numel() * k0.element_size() * len(rs.cache["k"]) * 2

    def _admit_into(self, requests, idx: int, s: int, rs: _SlotRunState,
                    slot_req, ft: dict) -> None:
        """Admit ``requests[idx]`` into free slot ``s``: resume it from
        parked pages, replay it from its recorded tokens, or prefill it
        fresh — binding any resident shared prefix first."""
        model, cfg, pool, sp = self.model, self.cfg, rs.pool, self._sp
        r = requests[idx]
        plen = len(r.prompt)
        # the slot's page run must hold every position a decode step will
        # write: past capacity the write would be DROPPED while sampling
        # went on — corrupt output, so refuse at admission instead
        if plen + r.max_new - 1 > self.max_len:
            if cfg.admit_policy in ("reject", "slo"):
                rs.pending.remove(idx)
                rs.st["rejected"] += 1
                return
            raise ValueError(
                f"request {r.rid}: prompt ({plen}) + "
                f"max_new ({r.max_new}) overflows the "
                f"slot page (max_len={self.max_len})")
        rs.pending.remove(idx)
        if r.rid in pool.parked:
            rec = pool.resume(rs.cache, r.rid, s)
            row = identity_row(s, pool.pps)
            ent = pool.entries.get(rec["entry"]) if rec["entry"] else None
            if ent is not None:
                row[:rec["bound"]] = ent.pages[:rec["bound"]]
            rs.ptab_host[s] = row
            self._push_ptab(rs)
            rs.cache["pos"][s] = rec["length"]
            hp = rs.parked.pop(r.rid)
            rs.tokens[s, 0] = hp["tok"]
            rs.slot_steps[s] = hp["steps"]
            rs.fed[s] = hp["fed"]
            slot_req[s] = r
            rs.slot_idx[s] = idx
            rs.seq += 1
            rs.slot_seq[s] = rs.seq
            return
        replaying = bool(r.out)
        prompt = np.asarray(r.prompt, np.int32)
        k, pages = pool.lookup(prompt) if cfg.prefix_sharing else (0, [])
        row = identity_row(s, pool.pps)
        start = 0
        if k > 0:
            pool.bind(s, prompt, k)
            if plen == k * pool.page_len:
                # exact cover: the last token must re-run for its logits and
                # its K/V write would land in the boundary shared page —
                # copy that page into the private run first
                copy_cache_pages(rs.cache, [pages[k - 1]],
                                 [private_page(s, k - 1, pool.pps)])
                pool.slot_bound[s] = k - 1
                row[:k - 1] = pages[:k - 1]
                start = plen - 1
            else:
                row[:k] = pages[:k]
                start = k * pool.page_len
            rs.st["prefix_hits"] += 1
            rs.st["prefix_tokens_saved"] += start
        rs.ptab_host[s] = row
        self._push_ptab(rs)
        suf = prompt[start:]
        padded = np.zeros((1, min(bucket_pow2(len(suf)), self.max_len)),
                          np.int32)
        padded[0, :len(suf)] = suf
        logits, rs.cache = model.prefill_into_slot(
            sp, torch.as_tensor(padded, device=self.device), rs.cache, s,
            plen, start=start)
        tok = int(torch.argmax(logits, -1)[0])
        if not replaying:
            r.out.append(tok)
            rs.st["admitted"] += 1
            rs.st["tokens"] += 1
            now = time.perf_counter() - ft["_t0"]
            ft["_qwait"].append(now)
            ft["_ttft"].append(now)
        if cfg.prefix_sharing and k == 0:
            # total miss: publish the prompt-covering pages so the NEXT
            # request sharing this prefix prefills only its suffix
            pool.publish(rs.cache, s, prompt)
        rs.fed[s] = 1
        rs.tokens[s, 0] = r.out[0]
        if not replaying and len(r.out) >= r.max_new:
            r.done = True
            rs.pool.unbind(s)
            self._reset_slot(s, rs)
            return
        slot_req[s] = r
        rs.slot_idx[s] = idx
        rs.slot_steps[s] = len(r.out) - 1 if replaying else 0
        rs.seq += 1
        rs.slot_seq[s] = rs.seq

    def _slo_shed(self, requests, elig: list, rs: _SlotRunState,
                  ft: dict, wd: StragglerWatchdog) -> list:
        """admit_policy="slo": drop eligible requests whose deadline the
        observed p50 step time says can no longer be met."""
        if self.cfg.admit_policy != "slo":
            return elig
        now = time.perf_counter() - ft["_t0"]
        p50 = wd.p50
        keep = []
        for i in elig:
            r = requests[i]
            if r.deadline_s is not None:
                est = (r.max_new - len(r.out)) * p50
                if now + est > r.deadline_s:
                    rs.pending.remove(i)
                    rs.st["rejected"] += 1
                    rs.st["slo_shed"] += 1
                    continue
            keep.append(i)
        return keep

    def _preempt_for(self, requests, idx: int, rs: _SlotRunState,
                     slot_req, wd: StragglerWatchdog) -> Optional[int]:
        """Evict the lowest-priority running slot (ties: most recently
        admitted) iff ``requests[idx]`` outranks it STRICTLY; the victim is
        parked or dropped for replay, whichever ``preempt_cost`` prices
        cheaper, and re-enters the queue.  Returns the freed slot, or None."""
        cfg, pool = self.cfg, rs.pool
        occ = [(requests[rs.slot_idx[s]].priority, -rs.slot_seq[s], s)
               for s in range(self.slots) if slot_req[s] is not None]
        if not occ:
            return None
        vprio, _, s = min(occ)
        if requests[idx].priority <= vprio:
            return None
        victim = slot_req[s]
        length = int(rs.cache["pos"][s])
        arm = cfg.preempt_mode
        if arm == "auto":
            arm = preempt_cost(
                cfg.cost_model(), length=length,
                prefix_len=pool.slot_bound[s] * pool.page_len,
                n_out=len(victim.out), page_bytes=self._page_bytes(rs),
                pps=pool.pps, page_len=pool.page_len,
                model_flops_per_tok=self._flops_per_tok(),
                step_s=(wd.p50 or 1e-3)).arm
        if arm == "park":
            if pool.park(rs.cache, victim.rid, s, length):
                rs.parked[victim.rid] = {"tok": int(rs.tokens[s, 0]),
                                         "steps": rs.slot_steps[s],
                                         "fed": rs.fed[s]}
                rs.st["parked"] += 1
            else:
                arm = "replay"     # shared region full: drop the pages
        if arm == "replay":
            pool.unbind(s)
            rs.st["replayed"] += 1
        rs.st["preemptions"] += 1
        rs.pending.append(rs.slot_idx[s])
        slot_req[s] = None
        rs.slot_idx[s] = -1
        self._reset_slot(s, rs)
        return s

    def _slot_session(self, requests, max_steps: int, continuous: bool,
                      rs: _SlotRunState, ft: dict,
                      wd: StragglerWatchdog) -> None:
        model, cfg, sp = self.model, self.cfg, self._sp
        injector = cfg.fault_injector

        def eligible():
            # highest priority first; FIFO (submission index) within one
            return sorted((i for i in rs.pending
                           if requests[i].arrival_step <= rs.step),
                          key=lambda i: (-requests[i].priority, i))

        slot_req: list[Optional[Request]] = [
            requests[i] if i >= 0 else None for i in rs.slot_idx]
        while rs.pending or any(r is not None for r in slot_req):
            if rs.backoff > 0:
                # shedding: admission paused, running slots keep draining
                rs.backoff -= 1
                ft["shed_steps"] += 1
            # admission: continuous fills ANY free slot every tick; wave
            # only refills once the whole pool has drained
            elif continuous or all(r is None for r in slot_req):
                for idx in self._slo_shed(requests, eligible(), rs, ft, wd):
                    s = next((t for t in range(self.slots)
                              if slot_req[t] is None), None)
                    if s is None:
                        break
                    self._admit_into(requests, idx, s, rs, slot_req, ft)
                if continuous:
                    elig = eligible()
                    if elig and all(r is not None for r in slot_req):
                        s = self._preempt_for(requests, elig[0], rs,
                                              slot_req, wd)
                        if s is not None:
                            self._admit_into(requests, elig[0], s, rs,
                                             slot_req, ft)
            if not any(r is not None for r in slot_req):
                if rs.pending:
                    rs.step += 1    # nothing runnable yet: advance the clock
                continue
            # injected faults for the coming step: a hard fault aborts the
            # session (the recovery loop restores); a straggle slows THIS
            # step, so the watchdog sees it as a real one
            delay = 0.0
            if injector is not None:
                f = injector.on_decode_step(rs.step)
                if f is not None and f.kind in ("host", "crash"):
                    raise _EngineFault(f)
                if f is not None and f.kind == "straggle":
                    delay = f.delay_s
                    if f.host is not None:
                        rs.suspect = f.host
            # one decode step for the WHOLE pool (free slots carry
            # don't-care tokens; their writes land in their own pages)
            rs.occ_sum += sum(r is not None for r in slot_req) / self.slots
            rs.st["decode_steps"] += 1
            t_step = time.perf_counter()
            if delay:
                time.sleep(delay)
            rs.tokens_dev.copy_(torch.from_numpy(rs.tokens))
            logits, rs.cache = model.decode_step_slots(sp, rs.tokens_dev,
                                                       rs.cache)
            nxt = torch.argmax(logits, -1).to(torch.int32).cpu().numpy()
            dt = time.perf_counter() - t_step
            for s, r in enumerate(slot_req):
                if r is None:
                    continue
                tok = int(nxt[s])
                if rs.fed[s] < len(r.out):
                    # replaying a preempted request: feed the record forward
                    rs.tokens[s, 0] = r.out[rs.fed[s]]
                    rs.fed[s] += 1
                    continue
                r.out.append(tok)
                rs.fed[s] += 1
                rs.st["tokens"] += 1
                rs.tokens[s, 0] = tok
                rs.slot_steps[s] += 1
                if len(r.out) >= r.max_new:
                    r.done = True
                if r.done or rs.slot_steps[s] >= max_steps:
                    if not r.done:
                        rs.st["preempted"] += 1
                    self._release(s, rs, slot_req)
            rs.step += 1
            # straggler policy: sustained straggle sheds admission with a
            # bounded exponential backoff; past the budget it escalates to
            # evicting the suspect host (checkpoint first)
            if wd.observe(rs.step - 1, dt):
                rs.straggle_run += 1
            else:
                rs.straggle_run = 0
            if rs.straggle_run >= cfg.straggle_patience and rs.backoff == 0:
                if rs.shed_rounds >= cfg.straggle_escalate:
                    self._save_slot_ckpt(rs, requests, ft)
                    raise _EngineFault(Fault("host", host=rs.suspect))
                rs.shed_rounds += 1
                ft["shed_rounds"] += 1
                rs.backoff = min(cfg.shed_cap,
                                 cfg.shed_base * 2 ** (rs.shed_rounds - 1))
                rs.straggle_run = 0
                self._save_slot_ckpt(rs, requests, ft)     # on demand
            elif cfg.ckpt_every > 0 and rs.step % cfg.ckpt_every == 0:
                self._save_slot_ckpt(rs, requests, ft)
