"""Cross-process stable digests for compiled-program cache keys — the
port's own copy of the JAX package's ``cache/digest.py``, with the same
encoding (plain data digests to the same hex string in both packages).

The in-memory caches in ``core.tapir`` key on python tuples — graph
signatures, config tuples, the mesh fingerprint.  Those tuples hash fine
inside one process but are NOT portable: ``hash()`` is salted per process,
and a few signature components (``pyfunc`` callables) repr with memory
addresses.  ``stable_digest`` maps a key tuple to a sha256 hex string by
type-tagged canonical encoding, so two processes that build structurally
identical programs under identical configs land on the same on-disk entry.

Encoding rules:

* scalars encode as ``<tag>:<canonical text>`` — floats via ``repr`` (exact
  shortest round-trip in py3), bytes raw.
* containers encode recursively with length framing; dicts sort by encoded
  key so insertion order never leaks into the digest.
* numpy arrays encode shape + dtype + raw bytes.
* torch keys: a ``torch.dtype`` or ``torch.device`` encodes as its
  canonical string (``torch.float32``, ``cuda:0``); a ``torch.Size`` is a
  tuple and encodes as one.  A tensor is never keyed by its values: one that a
  closure captures encodes as its shape, dtype and device alone.  A
  program loaded from the store rebinds its callables to the live ones of
  the graph it was keyed by (``core.tapir._l2_load``), so the closure
  reads this process's tensor, and a key that held the values would only
  make two processes with other weights miss each other's programs.
* callables (``pyfunc`` nodes, lifted composites) encode as
  ``module.qualname`` **plus a hash of their full code identity** — the
  qualname is the cross-process identity; the code hash covers bytecode,
  constants (recursing into nested code objects), referenced names,
  defaults, and captured closure-cell values, so editing the function in
  ANY way that changes its behavior (same name, different program — e.g.
  flipping ``x*0.5`` to ``x*0.25``, which changes ``co_consts`` but not
  ``co_code``) changes the digest: must miss.  Bound methods digest via
  ``__func__``; ``functools.partial`` digests func + bound args.
* callables with NO introspectable code (builtins, C extensions, callable
  instances) are salted with a per-process nonce: stable within the
  process (L1 self-hits still work), a guaranteed cross-process MISS —
  we cannot fingerprint their behavior, so they must never false-hit.
* dataclass-ish leaves (``TensorType``, ``CostModel``) encode via their
  fields.

Anything unrecognized falls back to ``repr`` — if that repr embeds a
memory address the digest differs per process, which degrades to a cache
MISS, never a false hit.
"""
from __future__ import annotations

import dataclasses
import functools
import hashlib
import os
import types
from typing import Any

import numpy as np
import torch

#: Per-process salt for callables whose behavior cannot be fingerprinted
#: (no ``__code__``).  A digest containing it is stable inside one process
#: and never matches another process's — forced miss, never a false hit.
_OPAQUE_CALLABLE_NONCE = os.urandom(16)


def _hash_code_identity(code: types.CodeType, h, seen: set) -> None:
    """Full behavioral identity of a code object: bytecode + constants
    (recursing into nested code objects — inline lambdas, comprehensions)
    + the global/attribute names the bytecode references."""
    h.update(b"C:")
    h.update(code.co_code)
    h.update(f":{len(code.co_consts)}:".encode())
    for c in code.co_consts:
        if isinstance(c, types.CodeType):
            _hash_code_identity(c, h, seen)
        else:
            _encode(c, h, seen)
    _encode(code.co_names, h, seen)
    h.update(b";")


def _encode_callable(obj: Any, h, seen: set) -> None:
    if id(obj) in seen:          # recursive closure (fn captured in its
        h.update(b"c:cycle;")    # own cell): structure already hashed
        return
    seen = seen | {id(obj)}
    if isinstance(obj, functools.partial):
        h.update(b"cp:")
        _encode(obj.func, h, seen)
        _encode(tuple(obj.args), h, seen)
        _encode(dict(obj.keywords or {}), h, seen)
        h.update(b";")
        return
    fn = getattr(obj, "__func__", obj)          # bound method -> function
    mod = getattr(fn, "__module__", "?")
    qual = getattr(fn, "__qualname__", getattr(fn, "__name__", "?"))
    code = getattr(fn, "__code__", None)
    if not isinstance(code, types.CodeType):
        # builtin / C extension / callable instance: behavior is not
        # introspectable, so a stable digest could false-hit after the
        # callable changes.  Per-process nonce => forced cross-process miss.
        h.update(f"c!:{mod}.{qual}:".encode())
        h.update(_OPAQUE_CALLABLE_NONCE)
        h.update(b";")
        return
    hc = hashlib.sha256()
    _hash_code_identity(code, hc, seen)
    for cell in getattr(fn, "__closure__", None) or ():
        try:
            _encode(cell.cell_contents, hc, seen)
        except ValueError:                      # not-yet-filled cell
            hc.update(b"cell:empty;")
    _encode(getattr(fn, "__defaults__", None), hc, seen)
    _encode(getattr(fn, "__kwdefaults__", None), hc, seen)
    h.update(f"c:{mod}.{qual}:".encode())
    h.update(hc.digest())
    h.update(b";")


def _encode(obj: Any, h, seen: set) -> None:
    if obj is None:
        h.update(b"N;")
    elif isinstance(obj, bool):
        h.update(b"b:1;" if obj else b"b:0;")
    elif isinstance(obj, int):
        h.update(f"i:{obj};".encode())
    elif isinstance(obj, float):
        h.update(f"f:{obj!r};".encode())
    elif isinstance(obj, str):
        b = obj.encode()
        h.update(f"s:{len(b)}:".encode())
        h.update(b)
        h.update(b";")
    elif isinstance(obj, bytes):
        h.update(f"y:{len(obj)}:".encode())
        h.update(obj)
        h.update(b";")
    elif isinstance(obj, (tuple, list)):
        h.update(f"t:{len(obj)}:".encode())
        for v in obj:
            _encode(v, h, seen)
        h.update(b";")
    elif isinstance(obj, dict):
        items = []
        for k, v in obj.items():
            hk = hashlib.sha256()
            _encode(k, hk, seen)
            items.append((hk.digest(), k, v))
        h.update(f"d:{len(items)}:".encode())
        for _, k, v in sorted(items, key=lambda e: e[0]):
            _encode(k, h, seen)
            _encode(v, h, seen)
        h.update(b";")
    elif isinstance(obj, np.ndarray):
        h.update(f"a:{obj.shape}:{obj.dtype.str}:".encode())
        h.update(np.ascontiguousarray(obj).tobytes())
        h.update(b";")
    elif isinstance(obj, (np.integer, np.floating, np.bool_)):
        _encode(obj.item(), h, seen)
    elif isinstance(obj, (torch.dtype, torch.device)):
        h.update(f"P:{type(obj).__name__}:{obj};".encode())
    elif isinstance(obj, torch.Tensor):
        # never its values (see the module docstring)
        h.update(f"P:Tensor:{tuple(obj.shape)}:{obj.dtype}:"
                 f"{obj.device};".encode())
    elif isinstance(obj, type):
        # a class used as a key marker: identity is its qualname (method
        # bodies are not part of graph keys — instances digest by fields)
        h.update(f"T:{getattr(obj, '__module__', '?')}"
                 f".{getattr(obj, '__qualname__', '?')};".encode())
    elif callable(obj):
        _encode_callable(obj, h, seen)
    elif dataclasses.is_dataclass(obj):
        h.update(f"D:{type(obj).__name__}:".encode())
        for f in dataclasses.fields(obj):
            _encode(f.name, h, seen)
            _encode(getattr(obj, f.name), h, seen)
        h.update(b";")
    else:
        # last resort: repr.  A repr embedding a memory address digests
        # differently per process — a guaranteed miss, never a false hit.
        _encode(f"r:{type(obj).__name__}:{obj!r}", h, seen)


def stable_digest(obj: Any) -> str:
    """sha256 hex digest of ``obj`` under the canonical encoding above."""
    h = hashlib.sha256()
    _encode(obj, h, set())
    return h.hexdigest()
