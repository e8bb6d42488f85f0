"""Sharded, resumable token data pipeline -- the port of the JAX package's
``data/pipeline.py``, in numpy as the reference is, so a batch is the same
bytes in both packages.

Every batch is a pure function of (seed, step, shard) -- no iterator state
beyond the step counter.  That single integer makes the pipeline:
  * resumable: a checkpoint stores {step}; restore and continue byte-exact;
  * elastic: a restarted job with a different host count re-shards by
    recomputing shard = host_id/n_hosts -- no data server handoff;
  * deterministic under failure injection.

Sources: ``SyntheticSource`` (zipf-ish token stream, CPU-cheap) and
``FileSource`` (memmapped flat binary of token ids -- the production path;
one file per corpus shard).  ``Prefetcher`` overlaps host batch assembly
with device compute via a background thread.  ``to_device`` makes the
int32 token and label tensors of a batch on the device the step runs on.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np
import torch


@dataclass(frozen=True)
class DataConfig:
    seq_len: int = 1024
    global_batch: int = 8
    vocab: int = 32000
    seed: int = 0
    source: str = "synthetic"          # synthetic | file
    path: Optional[str] = None         # for file source
    prefetch: int = 2


class SyntheticSource:
    """Deterministic pseudo-corpus: tokens ~ zipf over the vocab, mixed with
    position-dependent structure so models actually learn something."""

    def __init__(self, vocab: int, seed: int):
        self.vocab = vocab
        self.seed = seed

    def batch(self, step: int, shard: int, rows: int, seq: int) -> np.ndarray:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, shard]))
        base = rng.zipf(1.5, size=(rows, seq + 1)).astype(np.int64)
        toks = (base % (self.vocab - 2)) + 1
        # inject copy structure: second half repeats the first half shifted
        half = (seq + 1) // 2
        toks[:, half: 2 * half] = toks[:, :half]
        return toks.astype(np.int32)


class FileSource:
    """Flat binary token file (uint16/uint32).  Batches are gathered at
    deterministic offsets derived from (seed, step, shard)."""

    def __init__(self, path: str, vocab: int, seed: int,
                 dtype: str = "uint16"):
        self.arr = np.memmap(path, dtype=np.dtype(dtype), mode="r")
        self.vocab = vocab
        self.seed = seed

    def batch(self, step: int, shard: int, rows: int, seq: int) -> np.ndarray:
        n = len(self.arr) - (seq + 1)
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, shard]))
        offs = rng.integers(0, n, size=rows)
        out = np.stack([self.arr[o: o + seq + 1] for o in offs])
        return (out.astype(np.int64) % self.vocab).astype(np.int32)


class TokenPipeline:
    """step -> {"tokens": [B,S], "labels": [B,S]} for this host's shard."""

    def __init__(self, cfg: DataConfig, host_id: int = 0, n_hosts: int = 1):
        self.cfg = cfg
        self.host_id, self.n_hosts = host_id, n_hosts
        assert cfg.global_batch % n_hosts == 0
        self.rows = cfg.global_batch // n_hosts
        if cfg.source == "file":
            assert cfg.path, "file source needs a path"
            self.src = FileSource(cfg.path, cfg.vocab, cfg.seed)
        else:
            self.src = SyntheticSource(cfg.vocab, cfg.seed)

    def batch_at(self, step: int) -> dict:
        raw = self.src.batch(step, self.host_id, self.rows, self.cfg.seq_len)
        return {"tokens": raw[:, :-1], "labels": raw[:, 1:]}

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class Prefetcher:
    """Background-thread prefetch of ``pipeline.batch_at(step)``; the
    training loop pops ready batches so input never blocks the device."""

    def __init__(self, pipeline: TokenPipeline, start_step: int = 0,
                 depth: int = 2):
        self.pipeline = pipeline
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._step = start_step
        self._thread = threading.Thread(target=self._work, daemon=True)
        self._thread.start()

    def _work(self):
        s = self._step
        while not self._stop.is_set():
            try:
                self.q.put((s, self.pipeline.batch_at(s)), timeout=0.2)
                s += 1
            except queue.Full:
                continue

    def next(self) -> tuple[int, dict]:
        return self.q.get()

    def close(self):
        self._stop.set()
        self._thread.join(timeout=2.0)


def to_device(batch: dict, device) -> dict:
    """The batch's arrays as int32 tensors on ``device`` (a float array,
    such as a loss mask, keeps its dtype)."""
    out = {}
    for k, v in batch.items():
        a = np.asarray(v)
        t = torch.from_numpy(np.ascontiguousarray(a))
        if a.dtype.kind in "iu":
            t = t.to(torch.int32)
        out[k] = t.to(device, non_blocking=True)
    return out
