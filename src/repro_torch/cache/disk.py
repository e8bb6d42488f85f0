"""On-disk L2 tier of the compiled-program cache — the port of the JAX
package's ``cache/disk.py``, with its layout and protocol.

What an entry holds differs: the reference stores a serialized XLA
executable; the port has none.  Its compiled program is the optimized,
scheduled ``TaskGraph`` that ``core.lowering.emit`` turns into a callable,
plus the two verdicts ``core.tapir`` draws from it (``graphed``: replayed
as a CUDA graph, ``written``: the inputs it writes in place).  A hit
skips the pass pipeline and emits from the stored graph.  The port's other
persistent tier is ``kernels/build.py``'s ``build/lib<stem>_<digest>.so``,
already keyed by its source's digest; there is no counterpart of the
reference's ``enable_xla_disk_cache`` (torch has no compile cache to point
at the store).

Layout (one pair of files per program, content-addressed by key digest)::

    <root>/v1/<dd>/<digest>.bin     # framed header JSON + raw array bytes
    <root>/v1/<dd>/<digest>.json    # sidecar: provenance + integrity
    <root>/quarantine/              # entries that failed verification

``<dd>`` is the first two hex chars of the digest.

Write protocol (stage + atomic rename, readers never observe a torn
entry): the payload is staged to ``<digest>.bin.tmp-<pid>-<nonce>`` and
``os.replace``d to its name, then the sidecar the same way.  Two
processes racing to publish one key both succeed and the last rename
wins; both wrote the same program, so exactly one durable winner remains.
A reader requires the sidecar, so a visible sidecar implies a visible
payload.

Read protocol (**quarantine-and-recompile**: a cache problem may cost a
compile, never correctness):

* sidecar missing                       -> miss (in-progress write)
* sidecar unparsable                    -> quarantine, miss
* format / torch / CUDA / device kind /
  kernel sources / pipeline-salt
  mismatch                              -> version skew: quarantine, miss
* payload missing, short, or sha256
  mismatch vs the sidecar               -> corruption: quarantine, miss
* payload frame malformed               -> corruption: quarantine, miss

and, in ``core.tapir._l2_load``, a graph that cannot be rebuilt (an
object reference that does not resolve) or whose signature differs from
the sidecar's is corruption too.  A failed verification is retried ONCE
before quarantining (a reader racing two same-key writers can observe
writer A's payload next to writer B's sidecar; the re-read separates that
transient observation from durable corruption).  Quarantine only runs in
``readwrite`` mode: a ``read``-mode instance reports a miss and never
mutates the store.  Quarantined entries are RENAMED into ``quarantine/``
(kept for a post-mortem) and never probed again: ``get`` looks only under
``v1/``.

Trust model: the payload is framed JSON plus raw array bytes — NO pickle,
and decoding constructs nothing but numbers, strings, containers and
numpy arrays, so a crafted ``.bin`` cannot execute code at decode time.
Every object a graph needs beyond plain data (a lifted function, a
dataclass of static arguments) is not stored: the entry refers to it by
its position among the objects of the live traced graph whose key found
the entry, and the load rebinds it there.  The sha256 sidecar is an
*integrity* check (bit rot, torn writes), not *authentication*: a stored
graph decides which of the process's own kernels and functions run on
which inputs, so ``program_cache_dir`` must only be writable by
principals you would let choose that.  Directories this module creates
are made mode 0o700.
"""
from __future__ import annotations

import hashlib
import itertools
import json
import os
import shutil
import uuid
from typing import Any, Optional

import numpy as np
import torch

#: 1: the port's first layout (an optimized TaskGraph, framed JSON + raw
#: bytes)
FORMAT_VERSION = 1

#: Pipeline semantics salt.  Part of every L2 key: any change to what the
#: pass pipeline or the scheduler makes of the same raw graph MUST bump
#: it, or old entries would replay stale graphs.  (torch, CUDA, the device
#: kind and the kernels' sources are keyed separately.)  2: shared-input
#: fusion stays within one inlined region call.
PIPELINE_VERSION = "repro-torch-pipeline-2"

#: the store's modes: "off" (every call a no-op), "read" (probe, never
#: publish nor quarantine), "readwrite"
CACHE_MODES = ("off", "read", "readwrite")


def check_cache_mode(mode: str) -> None:
    """Raise ValueError unless ``mode`` is one of ``CACHE_MODES``."""
    if mode not in CACHE_MODES:
        raise ValueError(f"cache_mode must be 'off', 'read' or "
                         f"'readwrite', got {mode!r}")


def device_kind() -> str:
    """``sm_<major><minor>`` of the process's card, or ``cpu``: the CPU and
    the card schedule differently and never share an entry."""
    if not torch.cuda.is_available():
        return "cpu"
    major, minor = torch.cuda.get_device_capability()
    return f"sm_{major}{minor}"


def _versions() -> dict:
    from ..kernels.build import source_digest
    return {"torch": torch.__version__, "cuda": torch.version.cuda,
            "device": device_kind(), "kernels": source_digest(),
            "pipeline": PIPELINE_VERSION, "format": FORMAT_VERSION}


def atomic_write_bytes(path: str, data: bytes) -> None:
    """Stage-and-rename write: concurrent readers see the old file or the
    new file, never a prefix."""
    tmp = f"{path}.tmp-{os.getpid()}-{uuid.uuid4().hex[:8]}"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _json_default(o: Any):
    """numpy scalars/arrays serialize as NUMBERS, not their str() — a
    checkpoint meta carrying an np.int64 must round-trip as an int."""
    if isinstance(o, np.integer):
        return int(o)
    if isinstance(o, np.floating):
        return float(o)
    if isinstance(o, np.ndarray):
        return o.tolist()
    return str(o)


def atomic_write_json(path: str, obj: Any) -> None:
    """Stage-and-rename JSON write (``indent=1``, sorted keys)."""
    atomic_write_bytes(path, json.dumps(obj, indent=1, sort_keys=True,
                                        default=_json_default).encode())


def _makedirs_private(path: str) -> None:
    """``mkdir -p`` that chmods every component THIS process creates to
    0o700 (chmod, not mode=, so the umask can't widen it).  Pre-existing
    directories are left alone."""
    created = []
    p = os.path.abspath(path)
    while p and not os.path.isdir(p):
        created.append(p)
        parent = os.path.dirname(p)
        if parent == p:
            break
        p = parent
    os.makedirs(path, exist_ok=True)
    for q in created:
        try:
            os.chmod(q, 0o700)
        except OSError:
            pass


# -- payload codec (deliberately NOT pickle: see the trust model) -----------
#
# Frame::
#
#     b"RTG1" | u32 header length | header JSON | raw array bytes
#
# A value encodes as itself where JSON keeps it exactly (str, bool, int,
# float, None) and as a tagged object otherwise: {"t": "tu"|"l", "v": [..]}
# for tuples and lists, {"t": "d", "v": [[k, v], ..]} for dicts (keys of
# any encodable type, insertion order kept), {"t": "nd", ...} for an array
# (its bytes in the raw section), {"t": "ns", ...} for a numpy scalar,
# {"t": "dt", "v": name} for a torch dtype and {"t": "ref", "i": n, "q":
# qualname} for the n-th object of the live raw graph (``object_refs``).

_PAYLOAD_MAGIC = b"RTG1"
_PLAIN = (str, bool, int, float, type(None))


def _is_plain(v) -> bool:
    return isinstance(v, _PLAIN) or isinstance(
        v, (tuple, list, dict, np.ndarray, np.generic, torch.dtype))


def _qualname(obj) -> str:
    fn = getattr(obj, "__func__", obj)
    t = fn if callable(fn) else type(fn)
    return (f"{getattr(t, '__module__', '?')}."
            f"{getattr(t, '__qualname__', type(t).__name__)}")


def object_refs(g) -> list:
    """The objects of graph ``g`` beyond plain data (lifted functions,
    dataclasses of static arguments), once each, in a canonical order: the
    nodes in ``g``'s signature order, each node's attrs by sorted key and
    then its epilogue's, containers depth first.  Two processes whose raw
    graphs have one signature list objects of the same code identity at
    the same positions, so a stored graph can name an object by its
    position and rebind to the live one."""
    out, seen = [], set()

    def walk(v):
        if isinstance(v, (tuple, list)):
            for e in v:
                walk(e)
        elif isinstance(v, dict):
            for k, e in v.items():
                walk(k)
                walk(e)
        elif not _is_plain(v) and id(v) not in seen:
            seen.add(id(v))
            out.append(v)

    for nid in g._signature_order():
        n = g.nodes[nid]
        for k in sorted(n.attrs):
            walk(n.attrs[k])
        for _, _, at in n.epilogue:
            walk(at)
    return out


class _Encoder:
    def __init__(self, refs: list):
        self.pos = {id(o): i for i, o in enumerate(refs)}
        self.blobs: list[bytes] = []
        self.offset = 0

    def __call__(self, v):
        if isinstance(v, np.generic):       # before float: np.float64 is one
            return {"t": "ns", "dtype": v.dtype.str, "v": v.item()}
        if isinstance(v, _PLAIN):
            return v
        if isinstance(v, (tuple, list)):
            return {"t": "tu" if isinstance(v, tuple) else "l",
                    "v": [self(e) for e in v]}
        if isinstance(v, dict):
            return {"t": "d", "v": [[self(k), self(e)] for k, e in v.items()]}
        if isinstance(v, np.ndarray):
            data = np.ascontiguousarray(v).tobytes()
            enc = {"t": "nd", "dtype": v.dtype.str, "shape": list(v.shape),
                   "off": self.offset, "len": len(data)}
            self.blobs.append(data)
            self.offset += len(data)
            return enc
        if isinstance(v, torch.dtype):
            return {"t": "dt", "v": str(v).split(".")[-1]}
        i = self.pos.get(id(v))
        if i is None:
            raise ValueError(f"{type(v).__name__} is not plain data and not "
                             f"an object of the raw graph")
        return {"t": "ref", "i": i, "q": _qualname(v)}


class _Decoder:
    def __init__(self, blob: bytes, refs: list):
        self.blob, self.refs = blob, refs

    def __call__(self, e):
        if isinstance(e, _PLAIN):
            return e
        if not isinstance(e, dict):
            raise ValueError(f"bad value {e!r}")
        t = e["t"]
        if t in ("tu", "l"):
            seq = [self(x) for x in e["v"]]
            return tuple(seq) if t == "tu" else seq
        if t == "d":
            return {_hashable(self(k)): self(x) for k, x in e["v"]}
        if t == "nd":
            off, n = int(e["off"]), int(e["len"])
            if off < 0 or off + n > len(self.blob):
                raise ValueError("array bytes out of range")
            dt = np.dtype(e["dtype"])
            if dt.hasobject:
                raise ValueError("object arrays are not plain data")
            return np.frombuffer(self.blob[off:off + n], dtype=dt).reshape(
                [int(s) for s in e["shape"]]).copy()
        if t == "ns":
            dt = np.dtype(e["dtype"])
            if dt.hasobject:
                raise ValueError("object scalars are not plain data")
            return dt.type(e["v"])
        if t == "dt":
            dt = getattr(torch, str(e["v"]), None)
            if not isinstance(dt, torch.dtype):
                raise ValueError(f"unknown dtype {e['v']!r}")
            return dt
        if t == "ref":
            i = int(e["i"])
            if not 0 <= i < len(self.refs):
                raise ValueError(f"object reference {i} out of range")
            obj = self.refs[i]
            if _qualname(obj) != e["q"]:
                raise ValueError(f"object reference {i} is {_qualname(obj)},"
                                 f" stored {e['q']}")
            return obj
        raise ValueError(f"unknown tag {t!r}")


def _hashable(k):
    if isinstance(k, (dict, list)):
        raise ValueError(f"unhashable dict key {k!r}")
    return k


def encode_program_payload(g, refs: list, graphed: bool,
                           written) -> bytes:
    """The frame of an optimized, scheduled graph ``g`` (every node field
    the lowering reads, in the graph's own node order and ids, so a graph
    rebuilt from it emits the same program) and its verdicts.  Raises
    ValueError on a value that is neither plain data nor in ``refs``
    (publish is then skipped: the process serves uncached)."""
    enc = _Encoder(refs)
    nodes = []
    for n in g.nodes.values():
        s = n.schedule
        nodes.append({
            "nid": n.nid, "op": n.op, "in": list(n.inputs),
            "tt": [list(n.ttype.shape), n.ttype.dtype],
            "at": enc(n.attrs), "pd": list(n.pdims), "rd": enc(n.rdims),
            "ep": enc(n.epilogue), "do": n.donates, "an": list(n.anti),
            "sh": enc(n.sharding),
            "sc": {"db": enc(s.dim_binding), "ti": enc(s.tile),
                   "se": s.serialized, "im": s.impl,
                   "ic": enc(s.impl_costs), "re": s.remat,
                   "no": list(s.notes)}})
    header = json.dumps({"name": g.name, "inputs": enc(g.inputs),
                         "outputs": list(g.outputs), "nodes": nodes,
                         "graphed": bool(graphed),
                         "written": sorted(written)}).encode()
    return (_PAYLOAD_MAGIC + len(header).to_bytes(4, "big") + header
            + b"".join(enc.blobs))


def decode_program_payload(raw: bytes) -> tuple[dict, bytes]:
    """(header, raw array bytes) of a frame; ValueError on a malformed one.
    Builds nothing: the graph is rebuilt by ``rebuild_graph`` against the
    live raw graph's objects."""
    if raw[:4] != _PAYLOAD_MAGIC:
        raise ValueError("bad payload magic")
    n = int.from_bytes(raw[4:8], "big")
    if len(raw) < 8 + n:
        raise ValueError("truncated payload header")
    header = json.loads(raw[8:8 + n].decode())
    if not isinstance(header, dict) or not isinstance(
            header.get("nodes"), list):
        raise ValueError("payload header is not a graph")
    return header, raw[8 + n:]


def rebuild_graph(payload: tuple[dict, bytes], refs: list):
    """(graph, graphed, written) from a decoded payload, its object
    references bound to ``refs`` (``object_refs`` of the live raw graph).
    ValueError / KeyError / TypeError on anything that does not fit."""
    from ..core.ir import Node, Schedule, TaskGraph, TensorType
    header, blob = payload
    dec = _Decoder(blob, refs)

    def ints(v) -> tuple:
        if not all(isinstance(i, int) and not isinstance(i, bool)
                   for i in v):
            raise ValueError(f"expected ints, got {v!r}")
        return tuple(v)

    g = TaskGraph(str(header["name"]))
    for e in header["nodes"]:
        sc = e["sc"]
        shape, dtype = e["tt"]
        nid = ints([e["nid"]])[0]
        donates = None if e["do"] is None else ints([e["do"]])[0]
        sharding = dec(e["sh"])
        node = Node(nid, str(e["op"]), ints(e["in"]),
                    TensorType(ints(shape), str(dtype)), dec(e["at"]),
                    ints(e["pd"]), tuple(tuple(r) for r in dec(e["rd"])),
                    [(str(fn), ints(extras), dict(at))
                     for fn, extras, at in dec(e["ep"])],
                    donates=donates, anti=ints(e["an"]),
                    sharding=sharding,
                    schedule=Schedule(
                        dim_binding=dict(dec(sc["db"])),
                        tile=dict(dec(sc["ti"])),
                        serialized=bool(sc["se"]), impl=str(sc["im"]),
                        impl_costs=dict(dec(sc["ic"])), remat=str(sc["re"]),
                        notes=[str(x) for x in sc["no"]]))
        if not isinstance(node.attrs, dict) or nid in g.nodes:
            raise ValueError(f"bad node {nid}")
        g.nodes[nid] = node
    g.inputs = [(str(name), ints([nid])[0]) for name, nid in
                dec(header["inputs"])]
    g.outputs = list(ints(header["outputs"]))
    known = set(g.nodes)
    for n in g.nodes.values():
        refs_ = list(n.inputs) + list(n.anti) + [
            x for _, extras, _ in n.epilogue for x in extras]
        if n.donates is not None:
            refs_.append(n.donates)
        if not set(refs_) <= known:
            raise ValueError(f"node {n.nid} reads a node the graph lacks")
    if not (set(g.outputs) | {nid for _, nid in g.inputs}) <= known:
        raise ValueError("an input or output is not a node of the graph")
    g._counter = itertools.count(max(known, default=-1) + 1)
    written = header["written"]
    if not all(isinstance(w, str) for w in written):
        raise ValueError("bad written inputs")
    return g, bool(header["graphed"]), frozenset(written)


class ProgramDiskCache:
    """Content-addressed store of optimized program graphs.

    ``mode``: ``"off"`` (every call a no-op), ``"read"`` (probe but never
    publish NOR quarantine — the store is immutable to this instance),
    ``"readwrite"``.  In readwrite mode verification failures increment
    ``stats["quarantined"]`` and move the entry aside; ``get`` then reports
    a miss so the caller recompiles.
    """

    def __init__(self, root: str, mode: str = "readwrite"):
        check_cache_mode(mode)
        self.root = root
        self.mode = mode
        self.stats = {"hits": 0, "misses": 0, "quarantined": 0, "writes": 0}

    # -- paths ------------------------------------------------------------
    @property
    def store_dir(self) -> str:
        return os.path.join(self.root, "v1")

    @property
    def quarantine_dir(self) -> str:
        return os.path.join(self.root, "quarantine")

    def entry_paths(self, digest: str) -> tuple[str, str]:
        d = os.path.join(self.store_dir, digest[:2])
        return (os.path.join(d, f"{digest}.bin"),
                os.path.join(d, f"{digest}.json"))

    # -- quarantine -------------------------------------------------------
    def quarantine(self, digest: str, reason: str) -> None:
        """Move a bad entry aside (never deleted, never re-read).  No-op
        outside ``readwrite``: a probe-only instance never mutates the
        shared store."""
        if self.mode != "readwrite":
            return
        _makedirs_private(self.quarantine_dir)
        nonce = uuid.uuid4().hex[:8]
        for path in self.entry_paths(digest):
            if os.path.exists(path):
                dst = os.path.join(
                    self.quarantine_dir,
                    f"{os.path.basename(path)}.{reason}.{nonce}")
                try:
                    os.replace(path, dst)
                except OSError:
                    pass
        self.stats["quarantined"] += 1

    # -- read -------------------------------------------------------------
    def _read_verified(self, digest: str):
        """One verification attempt: ``((payload, meta), None)`` on success
        or ``(None, reason)`` — reason ``"absent"`` is a plain miss, any
        other reason is a verification failure."""
        bin_path, json_path = self.entry_paths(digest)
        if not os.path.exists(json_path):
            return None, "absent"
        try:
            with open(json_path, "rb") as f:
                meta = json.loads(f.read().decode())
        except (OSError, ValueError, UnicodeDecodeError):
            return None, "sidecar-unreadable"
        if not isinstance(meta, dict):
            return None, "sidecar-unreadable"
        want = _versions()
        got = {k: meta.get(k) for k in want}
        if got != want or meta.get("key_digest") != digest:
            return None, "version-skew"
        try:
            with open(bin_path, "rb") as f:
                raw = f.read()
        except OSError:
            return None, "payload-missing"
        if (len(raw) != meta.get("payload_bytes")
                or hashlib.sha256(raw).hexdigest()
                != meta.get("payload_sha256")):
            return None, "payload-corrupt"
        try:
            payload = decode_program_payload(raw)
        except Exception:
            return None, "payload-decode-failed"
        return (payload, meta), None

    def get(self, digest: str) -> Optional[tuple[Any, dict]]:
        """Verified read: ``((header, array bytes), sidecar meta)`` or None.
        Any integrity or version failure is retried once, then quarantines
        the entry (readwrite mode only) and returns None: the caller's
        fallback is a clean recompile, which in readwrite mode republishes
        and heals the slot."""
        if self.mode == "off":
            return None
        got, reason = self._read_verified(digest)
        if got is None and reason != "absent":
            got, reason = self._read_verified(digest)
        if got is not None:
            self.stats["hits"] += 1
            return got
        if reason != "absent":
            self.quarantine(digest, reason)
        self.stats["misses"] += 1
        return None

    # -- write ------------------------------------------------------------
    def put(self, digest: str, raw: bytes,
            meta: Optional[dict] = None) -> bool:
        """Transactional publish of an encoded payload (``raw``); returns
        False in read/off modes."""
        if self.mode != "readwrite":
            return False
        bin_path, json_path = self.entry_paths(digest)
        _makedirs_private(os.path.dirname(bin_path))
        sidecar = dict(meta or {})
        sidecar.update(_versions(), key_digest=digest,
                       payload_sha256=hashlib.sha256(raw).hexdigest(),
                       payload_bytes=len(raw))
        atomic_write_bytes(bin_path, raw)        # payload first,
        atomic_write_json(json_path, sidecar)    # sidecar commits the entry
        self.stats["writes"] += 1
        return True

    # -- maintenance ------------------------------------------------------
    def entries(self) -> list[tuple[str, dict]]:
        """(digest, sidecar meta) for every committed entry."""
        out = []
        if not os.path.isdir(self.store_dir):
            return out
        for dd in sorted(os.listdir(self.store_dir)):
            d = os.path.join(self.store_dir, dd)
            if not os.path.isdir(d):
                continue
            for name in sorted(os.listdir(d)):
                if not name.endswith(".json"):
                    continue
                try:
                    with open(os.path.join(d, name)) as f:
                        meta = json.load(f)
                except (OSError, ValueError):
                    continue
                out.append((name[:-len(".json")], meta))
        return out

    def invalidate(self, fingerprint: tuple) -> int:
        """Purge every entry compiled under mesh ``fingerprint`` (recorded
        in the sidecar); both files are removed, not quarantined.  With no
        mesh the fingerprint is ``()``."""
        fp = [list(p) for p in fingerprint]     # JSON round-trip form
        n = 0
        for digest, meta in self.entries():
            if meta.get("mesh_fingerprint") == fp:
                for path in self.entry_paths(digest):
                    try:
                        os.remove(path)
                    except OSError:
                        pass
                n += 1
        return n

    def clear(self) -> int:
        """Drop every committed entry (quarantine is kept for post-mortem).
        Returns the number of entries removed."""
        n = len(self.entries())
        shutil.rmtree(self.store_dir, ignore_errors=True)
        return n
