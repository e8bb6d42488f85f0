"""Atomic, keep-N checkpoints of a tree of tensors — the port of the JAX
package's ``checkpoint/ckpt.py``, in its on-disk format, so a checkpoint
written by either package restores in the other.

Layout (one directory per step)::

    ckpt_dir/step_000123/
        manifest.json      # step, time, n_hosts, meta, leaves {shape, dtype}
        host_00000.npz     # this host's leaves (flattened key -> array)

A leaf's key is its path in the tree, the dict keys (sorted, as
``tree_leaves`` walks them) or sequence indices joined by ``/``:
``params/blocks/w_in``, ``opt/mu/embed``, ``opt/step``, ``ef/...``.  The
port's parameter trees carry the reference's names (``models/convert.py``
maps the reference's tree onto them unchanged), so the keys match.  fp32
and int32 leaves are stored as themselves; a bf16 leaf as the 2-byte void
``np.savez`` writes for the reference's ``bfloat16`` arrays, with the
manifest dtype ``"bfloat16"``, and read back by its bits: neither side
needs ``ml_dtypes``.

Write protocol: every host stages its shard into the one shared
``step_..._tmp`` directory and drops a ``done_<host>`` barrier file; host
0, once all barriers are present, writes the manifest and renames the
directory into place (atomic on POSIX), then garbage-collects all but the
newest ``keep_n``.  ``all_steps`` / ``latest_step`` see only directories
that hold a manifest, so a reader never observes a partial checkpoint.

Restore copies each leaf into the template's own tensor (``copy_``) on
that tensor's device: every ``data_ptr`` survives, so the in-place AdamW
and the captured step's donated state stay bound to the same storage.  A
missing or extra key, or a leaf of another shape or dtype, raises.
``shardings=`` (the reference's elastic re-shard on load) is a tree of
``dist.sharding.NamedSharding`` parallel to the template: each stored
(whole) leaf is cut to this rank's block of that layout on that mesh,
whatever mesh wrote it, and copied into the template's block.

An async save copies every leaf to host memory before it returns (the
training step updates params and moments in place, so a writer thread
that read device tensors later would write the next step's values) and
writes the files from a background thread.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
import time
from typing import Optional

import numpy as np
import torch

from ..cache.disk import atomic_write_json


__all__ = ["save_checkpoint", "restore_checkpoint", "CheckpointManager",
           "all_steps", "latest_step", "flatten", "atomic_write_json"]


def flatten(tree, prefix: str = "") -> dict:
    """``{key: leaf}`` in ``tree_leaves`` order, each key the leaf's path
    (dict keys sorted, sequence indices) joined by ``/``."""
    if tree is None:
        return {}
    if isinstance(tree, dict):
        items = ((str(k), tree[k]) for k in sorted(tree))
    elif isinstance(tree, (list, tuple)):
        items = ((str(i), t) for i, t in enumerate(tree))
    else:
        return {prefix[:-1]: tree}
    out = {}
    for k, t in items:
        out.update(flatten(t, f"{prefix}{k}/"))
    return out


def _to_host(t: torch.Tensor) -> np.ndarray:
    """A host copy of ``t`` as numpy; bf16 as its 2-byte void bits."""
    h = t.detach().to("cpu", copy=True)
    if h.dtype == torch.bfloat16:
        return h.view(torch.int16).numpy().view(np.dtype("V2"))
    return h.numpy()


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


def _from_host(arr: np.ndarray, dtype: str) -> torch.Tensor:
    arr = np.require(arr, requirements="C")    # 0-d stays 0-d
    if dtype == "bfloat16":
        if arr.dtype.itemsize != 2:
            raise ValueError(f"a bfloat16 leaf stored as {arr.dtype}")
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    if arr.dtype.kind == "V":
        raise ValueError(f"a {dtype} leaf stored as raw bytes {arr.dtype}")
    return torch.from_numpy(arr)


def save_checkpoint(ckpt_dir: str, step: int, state, *, host_id: int = 0,
                    n_hosts: int = 1, keep_n: int = 3, blocking: bool = True,
                    meta: Optional[dict] = None,
                    barrier_timeout_s: float = 120.0
                    ) -> Optional[threading.Thread]:
    """Write ``state`` (a tree of tensors) for ``step``; with ``blocking``
    False the files are written by a thread this returns, after the
    leaves have been copied to host memory."""
    flat = flatten(state)
    host_flat = {k: _to_host(v) for k, v in flat.items()}
    dtypes = {k: _dtype_name(v) for k, v in flat.items()}

    def write():
        final = os.path.join(ckpt_dir, f"step_{step:08d}")
        tmp = final + "_tmp"                    # shared staging dir
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, f"host_{host_id:05d}.npz"), **host_flat)
        with open(os.path.join(tmp, f"done_{host_id:05d}"), "w") as f:
            f.write("ok")
        if host_id != 0:
            return                              # host 0 commits
        deadline = time.monotonic() + barrier_timeout_s
        while True:
            present = [h for h in range(n_hosts) if os.path.exists(
                os.path.join(tmp, f"done_{h:05d}"))]
            if len(present) == n_hosts:
                break
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"checkpoint step {step}: {len(present)}/{n_hosts} "
                    "hosts reached the commit barrier")
            time.sleep(0.01)
        manifest = {
            "step": step,
            "time": time.time(),
            "n_hosts": n_hosts,
            "meta": meta or {},
            "leaves": {k: {"shape": list(v.shape), "dtype": dtypes[k]}
                       for k, v in host_flat.items()},
        }
        for h in range(n_hosts):
            os.remove(os.path.join(tmp, f"done_{h:05d}"))
        atomic_write_json(os.path.join(tmp, "manifest.json"), manifest)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        _gc(ckpt_dir, keep_n)

    if blocking:
        write()
        return None
    t = threading.Thread(target=write, daemon=True,
                         name=f"checkpoint-write-{step}")
    t.start()
    return t


def _gc(ckpt_dir: str, keep_n: int) -> None:
    steps = all_steps(ckpt_dir)
    for s in steps[:-keep_n] if keep_n > 0 else []:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"),
                      ignore_errors=True)


def all_steps(ckpt_dir: str) -> list[int]:
    """The committed steps under ``ckpt_dir`` (a directory with a
    manifest), ascending."""
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        m = re.fullmatch(r"step_(\d+)", name)
        if m and os.path.exists(os.path.join(ckpt_dir, name,
                                             "manifest.json")):
            out.append(int(m.group(1)))
    return sorted(out)


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = all_steps(ckpt_dir)
    return steps[-1] if steps else None


def restore_checkpoint(ckpt_dir: str, template, step: Optional[int] = None,
                       *, shardings=None, host_id: int = 0):
    """Load ``step`` (default: the latest) into ``template``'s own tensors
    in place; returns ``(template, step, manifest)``.  With ``shardings``
    each template leaf is this rank's block of its ``NamedSharding``."""
    from ..dist.sharding import global_shape, local_block
    flat_sh = flatten(shardings) if shardings is not None else {}
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    flat = flatten(template)
    with np.load(os.path.join(d, f"host_{host_id:05d}.npz")) as data:
        stored = set(data.files)
        if stored != set(flat):
            raise KeyError(f"checkpoint step {step}: missing "
                           f"{sorted(set(flat) - stored)}, extra "
                           f"{sorted(stored - set(flat))}")
        for k, dst in flat.items():
            want = manifest["leaves"][k]
            sh = flat_sh.get(k)
            full = tuple(dst.shape) if sh is None else \
                global_shape(tuple(dst.shape), sh.spec, sh.mesh)
            if want["dtype"] != _dtype_name(dst) or \
                    tuple(want["shape"]) != full:
                raise ValueError(
                    f"checkpoint step {step}: {k} is {want['dtype']} "
                    f"{tuple(want['shape'])}, the template's "
                    f"{_dtype_name(dst)} {full}")
            src = _from_host(data[k], want["dtype"])
            if sh is not None:
                src = local_block(src, sh.spec, sh.mesh)
            if tuple(src.shape) != tuple(dst.shape) or \
                    src.dtype != dst.dtype:
                raise ValueError(f"checkpoint step {step}: {k} stored as "
                                 f"{src.dtype} {tuple(src.shape)}")
            with torch.no_grad():
                dst.copy_(src)
    return template, step, manifest


class CheckpointManager:
    """keep-N manager with async save and restore-latest."""

    def __init__(self, ckpt_dir: str, keep_n: int = 3, every: int = 100,
                 async_save: bool = True, host_id: int = 0,
                 n_hosts: int = 1):
        self.dir = ckpt_dir
        self.keep_n, self.every = keep_n, every
        self.async_save = async_save
        self.host_id = host_id
        self.n_hosts = n_hosts
        self._pending: Optional[threading.Thread] = None
        os.makedirs(ckpt_dir, exist_ok=True)

    def maybe_save(self, step: int, state, meta: Optional[dict] = None,
                   force: bool = False) -> bool:
        if not force and (step == 0 or step % self.every != 0):
            return False
        self.wait()
        self._pending = save_checkpoint(
            self.dir, step, state, host_id=self.host_id,
            n_hosts=self.n_hosts, keep_n=self.keep_n,
            blocking=not self.async_save, meta=meta)
        return True

    def wait(self):
        if self._pending is not None:
            self._pending.join()
            self._pending = None

    def restore_latest(self, template, shardings=None):
        return restore_checkpoint(self.dir, template, shardings=shardings,
                                  host_id=self.host_id)
