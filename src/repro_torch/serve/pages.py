"""Page-pool policy layer for slot serving: shared prefix pages,
refcounts, copy-on-write, and the park-vs-replay eviction cost model.

The port of the JAX package's ``serve/pages.py``.  The slot substrate
stores KV state as per-layer pools of fixed-size pages plus a per-slot
page table:

* **pool**  — ``[P, page_len, Hkv, hd]`` per layer, where
  ``P = 1 (trash) + slots * pps + shared_pages`` and
  ``pps = max_len // page_len``.  Page 0 is the *trash* page: host-side
  index vectors route any out-of-capacity write there, so garbage can
  never clobber live rows.  Pages ``1 .. slots*pps`` are each slot's
  *private* run (slot ``s``, logical page ``j`` owns physical page
  ``1 + s*pps + j`` — no allocator needed), and the tail is the
  *shared region* this module manages.
* **ptab** — ``[slots, pps]`` int32 device tensor mapping each slot's
  logical page to a physical page.  Decode/prefill read the KV view by
  gathering ``pool[ptab[s]]``; page indirection is DATA, not shape, so
  every region program replays from ``_PROGRAMS`` at any binding.

Invariants (carried to ROADMAP):

* Shared pages are READ-ONLY.  Bindings are capped so decode never
  scatters into a bound shared page; the one structural exception — a
  prompt that exactly covers its matched prefix, whose last token must
  re-run to produce logits — triggers COPY-ON-WRITE: the boundary page
  is copied into the slot's private run before the suffix prefill.
* Prefix pages checkpoint ONCE: they live in the pool (part of the
  device tree the engine checkpoints), never per-referencing-slot; this
  module's host state travels as JSON meta next to it (``to_meta`` /
  ``from_meta``, the reference's layout).

``PrefixIndex`` hashes prompt prefixes at page granularity (chained
sha256, token-exact verified — a hash collision can cost a miss, never
wrong tokens) and owns the shared free list.  ``preempt_cost`` is the
``core/schedule``-style roofline comparison between parking a victim's
pages in the pool (bytes over HBM, twice) and dropping them to re-prefill
from the shared prefix + replay recorded tokens (FLOPs + decode steps).
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

TRASH_PAGE = 0


def page_geometry(max_len: int, page_len: Optional[int] = None):
    """(page_len, pages_per_slot) for a slot of ``max_len`` positions.

    The page length must divide ``max_len`` exactly — the gathered KV
    view ``pool[ptab[s]]`` reshapes to ``[max_len, Hkv, hd]`` and a
    ragged tail would change the attention key length (and with it the
    reduction order, breaking bitwise equality with the unpaged layout).
    Default: 64, falling back to one whole-slot page when 64 ∤ max_len.
    """
    if page_len is None:
        page_len = min(64, max_len)
        if max_len % page_len:
            page_len = max_len
    if max_len % page_len:
        raise ValueError(f"page_len {page_len} must divide max_len "
                         f"{max_len}")
    return page_len, max_len // page_len


def private_page(slot: int, j: int, pps: int) -> int:
    """Physical id of slot ``slot``'s logical page ``j``."""
    return 1 + slot * pps + j


def identity_row(slot: int, pps: int) -> np.ndarray:
    return np.arange(1 + slot * pps, 1 + (slot + 1) * pps, dtype=np.int32)


# -- device-side page copies -------------------------------------------------


def copy_pages(pool: torch.Tensor, src_ids, dst_ids) -> torch.Tensor:
    """pool[dst_ids] <- pool[src_ids], in place (``index_copy_`` of the
    gathered source rows: O(copied bytes), never O(pool)).  The rows are
    read BEFORE the write, so overlapping source and destination ids copy
    the pre-write pages."""
    dev = pool.device
    src = torch.as_tensor(np.asarray(src_ids, np.int64), device=dev)
    dst = torch.as_tensor(np.asarray(dst_ids, np.int64), device=dev)
    return pool.index_copy_(0, dst, pool.index_select(0, src))


def copy_cache_pages(cache, src_ids, dst_ids) -> None:
    """Copy pages across every per-layer k/v pool, in place."""
    if not len(src_ids):
        return
    for key in ("k", "v"):
        for pool in cache[key]:
            copy_pages(pool, src_ids, dst_ids)


# -- prefix index ------------------------------------------------------------


def _chain_hashes(tokens: np.ndarray, page_len: int, n_pages: int) -> list:
    """h_j = sha256(h_{j-1} || tokens[j*pl:(j+1)*pl]) for j < n_pages."""
    out, h = [], b""
    t = np.ascontiguousarray(np.asarray(tokens, np.int32))
    for j in range(n_pages):
        h = hashlib.sha256(h + t[j * page_len:(j + 1) * page_len]
                           .tobytes()).hexdigest().encode()
        out.append(h.decode())
    return out


@dataclass
class _Entry:
    """One published prefix: ``n_pages`` shared pages holding the K/V of
    ``tokens`` (token-exact match source), refcounted by binders."""
    pages: list                      # physical page ids, in position order
    tokens: np.ndarray               # [n_pages * page_len] int32
    refs: int = 0
    last_use: int = 0


class PagePool:
    """Host-side bookkeeping for the shared region + per-slot bindings.

    Pure host state: every mutation is mirrored into the device ``ptab``
    by the engine.
    """

    def __init__(self, slots: int, max_len: int,
                 page_len: Optional[int] = None,
                 shared_pages: Optional[int] = None):
        self.page_len, self.pps = page_geometry(max_len, page_len)
        self.slots, self.max_len = slots, max_len
        if shared_pages is None:
            shared_pages = slots * self.pps
        self.shared_start = 1 + slots * self.pps
        self.n_shared = shared_pages
        self.free = list(range(self.shared_start,
                               self.shared_start + shared_pages))
        self.entries: dict[str, _Entry] = {}
        self.clock = 0                      # LRU tick
        # per-slot binding: entry hash (or None) + #shared pages bound
        self.slot_entry: list = [None] * slots
        self.slot_bound: list = [0] * slots
        # parked evictees: rid -> {pages, length, entry, bound}
        self.parked: dict[int, dict] = {}

    # -- allocation ------------------------------------------------------
    def _alloc(self, n: int) -> Optional[list]:
        if len(self.free) < n:
            self._evict_lru(n - len(self.free))
        if len(self.free) < n:
            return None
        got, self.free = self.free[:n], self.free[n:]
        return got

    def _evict_lru(self, need: int) -> None:
        """Drop unreferenced prefix entries, oldest-use first, until
        ``need`` pages are free (or nothing evictable remains)."""
        victims = sorted((e.last_use, h) for h, e in self.entries.items()
                         if e.refs == 0)
        for _, h in victims:
            if need <= 0:
                break
            e = self.entries.pop(h)
            self.free.extend(e.pages)
            need -= len(e.pages)

    # -- prefix lookup / bind / publish ---------------------------------
    def lookup(self, prompt: np.ndarray) -> tuple[int, list]:
        """Longest resident token-exact prefix of ``prompt``: returns
        (n_pages, page_ids).  Only whole pages match, and never the page
        holding the prompt's last token (it must re-run for logits) —
        except the exact-cover case, which the engine COWs."""
        pl = self.page_len
        k_max = len(prompt) // pl
        if k_max == 0:
            return 0, []
        hashes = _chain_hashes(prompt, pl, k_max)
        for k in range(k_max, 0, -1):
            e = self.entries.get(hashes[k - 1])
            if e is not None and np.array_equal(
                    e.tokens, np.asarray(prompt[:k * pl], np.int32)):
                return k, list(e.pages)
        return 0, []

    def bind(self, slot: int, prompt: np.ndarray, k: int) -> str:
        """Record slot -> entry binding (refcount +1); returns the hash."""
        h = _chain_hashes(prompt, self.page_len, k)[-1]
        e = self.entries[h]
        e.refs += 1
        self.clock += 1
        e.last_use = self.clock
        self.slot_entry[slot] = h
        self.slot_bound[slot] = k
        return h

    def unbind(self, slot: int) -> None:
        h = self.slot_entry[slot]
        if h is not None and h in self.entries:
            self.entries[h].refs -= 1
        self.slot_entry[slot] = None
        self.slot_bound[slot] = 0

    def publishable_pages(self, plen: int) -> int:
        """Pages of a ``plen``-token prompt that hold ONLY prompt-token
        K/V (garbage bucket rows land strictly later)."""
        return min(plen // self.page_len, self.pps)

    def publish(self, cache, slot: int, prompt: np.ndarray) -> int:
        """Copy the prompt-covering pages of ``slot``'s private run into
        freshly allocated shared pages and index them.  Returns the
        number of pages published (0 = nothing to share / no room)."""
        k = self.publishable_pages(len(prompt))
        if k == 0:
            return 0
        h = _chain_hashes(prompt, self.page_len, k)[-1]
        if h in self.entries:
            return 0
        pages = self._alloc(k)
        if pages is None:
            return 0
        src = [private_page(slot, j, self.pps) for j in range(k)]
        copy_cache_pages(cache, src, pages)
        self.clock += 1
        self.entries[h] = _Entry(
            pages=pages,
            tokens=np.asarray(prompt[:k * self.page_len], np.int32).copy(),
            refs=0, last_use=self.clock)
        return k

    # -- parking (priority eviction, state kept in-pool) ----------------
    def park(self, cache, rid: int, slot: int, length: int) -> bool:
        """Copy the victim's written PRIVATE pages into shared-region
        pages (its shared prefix stays bound — refcount held while
        parked).  False = no room; caller falls back to replay."""
        k = self.slot_bound[slot]
        n_used = -(-length // self.page_len)         # ceil
        priv = list(range(k, n_used))
        pages = self._alloc(len(priv)) if priv else []
        if pages is None:
            return False
        if priv:
            src = [private_page(slot, j, self.pps) for j in priv]
            copy_cache_pages(cache, src, pages)
        self.parked[rid] = {"pages": pages, "first": k, "length": length,
                            "entry": self.slot_entry[slot],
                            "bound": k}
        # keep the entry refcount: the parked request still binds it
        self.slot_entry[slot] = None
        self.slot_bound[slot] = 0
        return True

    def resume(self, cache, rid: int, slot: int) -> dict:
        """Copy a parked request's pages back into ``slot``'s private run
        and free them; rebind its shared prefix.  Returns the park record
        (caller rebuilds the ptab row and pos)."""
        rec = self.parked.pop(rid)
        if rec["pages"]:
            dst = [private_page(slot, rec["first"] + i, self.pps)
                   for i in range(len(rec["pages"]))]
            copy_cache_pages(cache, rec["pages"], dst)
            self.free.extend(rec["pages"])
        self.slot_entry[slot] = rec["entry"]
        self.slot_bound[slot] = rec["bound"]
        return rec

    def drop_parked(self, rid: int) -> None:
        rec = self.parked.pop(rid, None)
        if rec is None:
            return
        self.free.extend(rec["pages"])
        if rec["entry"] is not None and rec["entry"] in self.entries:
            self.entries[rec["entry"]].refs -= 1

    # -- ptab rows -------------------------------------------------------
    def bound_row(self, slot: int, shared: list) -> np.ndarray:
        row = identity_row(slot, self.pps)
        row[:len(shared)] = shared
        return row

    # -- checkpoint meta -------------------------------------------------
    def to_meta(self) -> dict:
        """The pool's host state as JSON-able meta."""
        return {
            "free": [int(p) for p in self.free],
            "clock": int(self.clock),
            "slot_entry": list(self.slot_entry),
            "slot_bound": [int(b) for b in self.slot_bound],
            "entries": {h: {"pages": [int(p) for p in e.pages],
                            "tokens": [int(t) for t in e.tokens],
                            "refs": int(e.refs),
                            "last_use": int(e.last_use)}
                        for h, e in self.entries.items()},
            "parked": {str(r): {"pages": [int(p) for p in v["pages"]],
                                "first": int(v["first"]),
                                "length": int(v["length"]),
                                "entry": v["entry"],
                                "bound": int(v["bound"])}
                       for r, v in self.parked.items()},
        }

    @classmethod
    def from_meta(cls, meta: dict, slots: int, max_len: int,
                  page_len: Optional[int] = None,
                  shared_pages: Optional[int] = None) -> "PagePool":
        """The pool ``to_meta`` described (its own or the reference's)."""
        pool = cls(slots, max_len, page_len, shared_pages)
        pool.free = list(meta["free"])
        pool.clock = int(meta["clock"])
        pool.slot_entry = list(meta["slot_entry"])
        pool.slot_bound = list(meta["slot_bound"])
        pool.entries = {
            h: _Entry(pages=list(v["pages"]),
                      tokens=np.asarray(v["tokens"], np.int32),
                      refs=int(v["refs"]), last_use=int(v["last_use"]))
            for h, v in meta["entries"].items()}
        pool.parked = {int(r): {"pages": list(v["pages"]),
                                "first": int(v["first"]),
                                "length": int(v["length"]),
                                "entry": v["entry"],
                                "bound": int(v["bound"])}
                       for r, v in meta["parked"].items()}
        return pool


# -- eviction cost model -----------------------------------------------------


@dataclass
class PreemptCost:
    park_s: float
    replay_s: float
    arm: str = field(init=False)

    def __post_init__(self):
        self.arm = "park" if self.park_s <= self.replay_s else "replay"


def preempt_cost(cost_model, *, length: int, prefix_len: int,
                 n_out: int, page_bytes: int, pps: int, page_len: int,
                 model_flops_per_tok: float, step_s: float) -> PreemptCost:
    """Roofline comparison of the two eviction arms for one victim.

    * **park**: copy the written private pages out now and back on
      resume — ``2 * bytes / hbm_bw`` (plus a spawn per copy call).
    * **replay**: drop the pages; on re-admission re-prefill the
      non-shared part of the prompt (``length - n_out - prefix_len``
      tokens of FLOPs) and replay the ``n_out - 1`` recorded tokens
      through ordinary pool decode steps at the observed step time.
    """
    n_pages = -(-length // page_len) - prefix_len // page_len
    n_pages = max(0, min(n_pages, pps))
    park_bytes = 2.0 * n_pages * page_bytes
    park_s = park_bytes / cost_model.hbm_bw + 2 * cost_model.spawn_s
    re_prefill_tok = max(0, length - (n_out - 1) - prefix_len)
    replay_s = (re_prefill_tok * model_flops_per_tok
                / cost_model.peak_flops
                + max(0, n_out - 1) * step_s)
    return PreemptCost(park_s=park_s, replay_s=replay_s)
