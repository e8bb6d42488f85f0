"""Fault tolerance: the checkpoint-replay training loop, straggler
detection and deterministic fault injection for the serving engine — the
port of the JAX package's ``dist/fault.py``.

``FaultTolerantLoop`` wraps a step function with the restore-and-replay
protocol: on an injected failure it restores the latest checkpoint and
replays forward; the data pipeline is deterministic in the step index
(``batch_at(step)``), so replay reproduces the clean trajectory bit for
bit.  A failure persisting at one step gives up after ``max_retries``
attempts.

Where the port differs: the reference keeps ``init_state = state``, safe
because jax arrays are immutable.  The port's steps update the state in
place (``optim.adamw_update``, the captured step's donated buffers), so
that alias would hold the latest values, not the first.  The loop keeps a
host copy of the initial state instead, taken when a failure can be
injected (only then can it replay), and a replay from scratch copies it
back into the live tensors; a restore from a checkpoint loads into the
live tensors too (``checkpoint/ckpt.py`` restores in place), so the
step's buffers, and any program bound to them, survive both.

``StragglerWatchdog`` keeps a rolling window of step durations and flags
a step slower than ``threshold`` x the median.  It runs in the training
loop and in the serving engine's decode loop, whose ``last_stats`` step
p50 / p95 are its window's.

``Fault`` / ``FaultInjector`` / ``ScriptedFaultInjector`` make each
serving failure mode a reproducible test: a fault fires at a
deterministic decode step, and the engine's recovery loop (checkpoint,
restore, re-admission) replays identically run over run.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch


# ---------------------------------------------------------------------------
# Deterministic fault injection (serving)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Fault:
    """One injected failure event.

    kind:
      "host"     — a mesh host died: on a mesh, ``host`` is the global
                   rank to blame; the run evicts its data row
                   (``launch.mesh.shrink_mesh``) and restores the latest
                   slot checkpoint on the shrunk mesh.  On one device
                   there is no mesh to shrink: a same-device restore, as
                   the reference does with no mesh.
      "crash"    — the decode step failed without losing a device:
                   restore and replay on the same device.
      "straggle" — the step completes ``delay_s`` slower: feeds the
                   watchdog / admission-shedding path instead of raising.

    ``host`` attributes the fault to a rank (a device id on one device;
    straggle escalation blames it); ``slot`` optionally attributes it to
    a slot (stats only)."""
    kind: str                    # "host" | "crash" | "straggle"
    host: Optional[int] = None
    slot: Optional[int] = None
    delay_s: float = 0.0


class FaultInjector:
    """Protocol: the engine calls ``on_decode_step(step)`` before every
    pool-wide decode step and acts on the returned :class:`Fault` (or
    None).  Implementations must be deterministic in ``step``."""

    def on_decode_step(self, step: int) -> Optional[Fault]:
        raise NotImplementedError


class ScriptedFaultInjector(FaultInjector):
    """``faults`` maps a decode-step index to the :class:`Fault` that
    fires there.  "host" / "crash" faults fire ONCE (the replayed step
    succeeds); "straggle" faults fire at every step in ``[step, step +
    repeat)``."""

    def __init__(self, faults: dict, repeat: int = 1):
        self.faults = dict(faults)
        self.repeat = repeat
        self.fired: list = []

    def on_decode_step(self, step: int) -> Optional[Fault]:
        f = self.faults.get(step)
        if f is not None and f.kind != "straggle":
            del self.faults[step]          # one-shot
            self.fired.append((step, f))
            return f
        for start, g in self.faults.items():
            if g.kind == "straggle" and start <= step < start + self.repeat:
                self.fired.append((step, g))
                return g
        return None


@dataclass
class LoopStats:
    steps_run: int = 0
    failures: int = 0
    restores: int = 0
    losses: list = field(default_factory=list)
    straggler_steps: list = field(default_factory=list)
    #: step index -> position in ``losses`` (replay dedupe)
    _loss_index: dict = field(default_factory=dict, repr=False)

    def record_loss(self, step: int, value: float) -> None:
        """Record ``value`` as THE loss of ``step``: a step replayed after
        a restore overwrites its entry, so ``losses`` holds one entry a
        step."""
        i = self._loss_index.get(step)
        if i is None:
            self._loss_index[step] = len(self.losses)
            self.losses.append(value)
        else:
            self.losses[i] = value


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _host_copy(state):
    """A host copy of every tensor leaf of ``state``."""
    return _tree_map(lambda t: t.detach().to("cpu", copy=True)
                     if isinstance(t, torch.Tensor) else t, state)


@torch.no_grad()
def _copy_into(dst, src) -> None:
    """``dst``'s tensor leaves take ``src``'s values, in place."""
    if isinstance(dst, dict):
        for k in dst:
            _copy_into(dst[k], src[k])
    elif isinstance(dst, (list, tuple)):
        for d, s in zip(dst, src):
            _copy_into(d, s)
    elif isinstance(dst, torch.Tensor):
        dst.copy_(src)


class FaultTolerantLoop:
    """``run(state, start_step, end_step)`` steps ``step_fn(state,
    batch_at(step))`` with checkpoints through ``ckpt`` (a
    ``CheckpointManager``), and on an injected failure restores and
    replays.  The reference's ``state_shardings`` (the restore's placement
    on a mesh) waits for the mesh port (ROADMAP queue 1, item 8)."""

    def __init__(self, step_fn: Callable, ckpt, batch_at: Callable,
                 inject_failure: Optional[Callable[[int], bool]] = None,
                 max_retries: int = 3, straggler_threshold: float = 4.0):
        self.step_fn = step_fn
        self.ckpt = ckpt
        self.batch_at = batch_at
        self.inject_failure = inject_failure
        self.max_retries = max_retries
        self.watchdog = StragglerWatchdog(threshold=straggler_threshold)

    def run(self, state, start_step: int, end_step: int):
        stats = LoopStats()
        # the step updates ``state`` in place: keep a real copy to replay
        # from (only a failure can need it)
        init_state = _host_copy(state) \
            if self.inject_failure is not None else None
        fail_count: dict = {}
        step = start_step
        while step < end_step:
            if self.inject_failure is not None and self.inject_failure(step):
                stats.failures += 1
                fail_count[step] = fail_count.get(step, 0) + 1
                if fail_count[step] >= self.max_retries:
                    raise RuntimeError(
                        f"step {step} failed {fail_count[step]} times; "
                        "giving up")
                state, step = self._restore(state, init_state, start_step,
                                            stats)
                continue
            batch = self.batch_at(step)
            t0 = time.perf_counter()
            state, metrics = self.step_fn(state, batch)
            if "loss" in metrics:
                stats.record_loss(step, float(metrics["loss"]))
            if self.watchdog.observe(step, time.perf_counter() - t0):
                stats.straggler_steps.append(step)
            stats.steps_run += 1
            step += 1
            self.ckpt.maybe_save(step, state)
        self.ckpt.wait()
        return state, stats

    def _restore(self, state, init_state, start_step: int, stats: LoopStats):
        """The latest checkpoint loaded into ``state``'s own tensors, or,
        with none written yet, the initial state copied back into them."""
        self.ckpt.wait()                # a pending write is the latest
        try:
            state, ck_step, _ = self.ckpt.restore_latest(state)
            stats.restores += 1
            return state, ck_step
        except FileNotFoundError:
            _copy_into(state, init_state)
            return state, start_step


class StragglerWatchdog:
    """Flags steps slower than ``threshold`` x the rolling median."""

    def __init__(self, threshold: float = 2.0, window: int = 256):
        self.threshold = threshold
        self.window = window
        self._durations: list = []
        self.flagged: list = []

    def observe(self, step: int, duration_s: float) -> bool:
        hist = self._durations[-self.window:]
        slow = bool(hist) and duration_s > self.threshold * float(
            np.median(hist))
        self._durations.append(duration_s)
        self._durations = self._durations[-self.window:]
        if slow:
            self.flagged.append(step)
        return slow

    @property
    def p50(self) -> float:
        return float(np.median(self._durations)) if self._durations else 0.0

    @property
    def p95(self) -> float:
        return float(np.percentile(self._durations, 95)) \
            if self._durations else 0.0
