"""The port's two-tier program cache (``repro_torch.cache``, the L2 wiring of
``core.tapir``) on the CPU: every non-mesh case of the reference's
``tests/test_program_cache.py`` against the port's store, and what the
port's own design needs.

Attack surfaces, as there:

1. **Key stability** (hypothesis): the canonical graph signature is
   invariant under node-id renumbering and insertion order, and sensitive
   to ``Schedule.impl`` and sharding; ``stable_digest`` gives the
   reference's hex digest on plain data, keys torch objects canonically
   and never by a tensor's values.
2. **Corruption / version skew**: truncated payloads, flipped bits and a
   torch upgrade each quarantine and recompile to bitwise-equal outputs; a
   CPU entry is never probed under a card's versions; an edited kernel
   source misses.
3. **Processes**: racing writers leave one durable winner; a warm process
   compiles zero region programs (for SMOKE serving of every family too,
   through ``launch/serve.py``); two processes with different weights
   share a store and each gets the outputs a compile gives.
4. **L1/L2 coherence**: ``clear_cache`` is L1-only; ``program_cache()
   .clear()`` empties the store; a pipeline-salt bump misses cleanly.
5. **What an entry is**: the optimized graph, every node field the
   lowering reads, its callables rebound to the live traced graph's; the
   loaded graph's signature equals a fresh compile's for every SMOKE
   serving region of qwen2.5-3b, ChatGLM3-6B, RWKV6-7B, Zamba2-7B and
   Moonlight-16B-A3B (dense and MoE layers), and
   a loaded program whose first call raises falls back to one compile.

Subprocesses run with ``tmp_path`` as their working directory and the
checkout's ``src`` (or a copy of it under ``tmp_path``) on their path.
"""
import functools
import hashlib
import itertools
import json
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.cache import stable_digest as ref_stable_digest
from repro_torch.cache import ProgramDiskCache, stable_digest
from repro_torch.cache import disk as disk_mod
from repro_torch.configs import get_smoke
from repro_torch.core import tapir
from repro_torch.core.ir import TaskGraph, TensorType
from repro_torch.core.schedule import CPU_COST_MODEL
from repro_torch.core.tapir import TapirConfig, clear_cache, use
from repro_torch.launch import serve as serve_cli
from repro_torch.models import layers as L
from repro_torch.models.base import get_model
from repro_torch.serve import Request, ServeConfig, ServingEngine

ROOT = pathlib.Path(__file__).resolve().parents[1]
SRC = ROOT / "src"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _random_graph(rng: np.random.Generator, n_ops: int) -> TaskGraph:
    """Random chain of matmul/ew ops over a [m, k] input (the reference
    test's ``_random_graph`` on the port's IR)."""
    g = TaskGraph("prop")
    m = int(rng.integers(2, 9))
    k = int(rng.integers(2, 17))
    x = g.add_input("x", TensorType((m, k), "float32"))
    vals = [(x, k)]
    for i in range(n_ops):
        src, width = vals[rng.integers(0, len(vals))]
        if rng.random() < 0.5:
            w_width = int(rng.integers(2, 17))
            wid = g.add_input(f"w{i}", TensorType((width, w_width),
                                                  "float32"))
            nid = g.add("matmul", (src, wid),
                        TensorType((m, w_width), "float32"),
                        pdims=(0, 1), rdims=(("k", width),), k=width)
            vals.append((nid, w_width))
        else:
            fn = ["relu", "tanh", "gelu", "silu"][int(rng.integers(0, 4))]
            nid = g.add("ew", (src,), TensorType((m, width), "float32"),
                        pdims=(0, 1), fn=fn)
            vals.append((nid, width))
    g.set_outputs([vals[-1][0]])
    return g


def _graph_with_offset(seed: int, n_ops: int, offset: int = 0,
                       dead_every: int = 0) -> TaskGraph:
    """The same random graph with perturbed node ids: ``offset`` shifts the
    id space, ``dead_every`` interleaves dead nodes (then prunes them)."""
    g = _random_graph(np.random.default_rng(seed), n_ops)
    g.prune()
    if offset == 0 and dead_every == 0:
        return g
    g2 = TaskGraph("prop")
    g2._counter = itertools.count(offset)
    remap = {}
    for i, nid in enumerate(sorted(g.nodes)):
        n = g.nodes[nid]
        if dead_every and i % dead_every == 0 and n.op != "input":
            src = remap[n.inputs[0]]
            g2.add("ew", (src,), g.nodes[n.inputs[0]].ttype,
                   pdims=g.nodes[n.inputs[0]].pdims, fn="relu")
        if n.op == "input":
            remap[nid] = g2.add_input(n.attrs["name"], n.ttype)
        else:
            remap[nid] = g2.add(n.op, tuple(remap[i] for i in n.inputs),
                                n.ttype, pdims=n.pdims, rdims=n.rdims,
                                **n.attrs)
    g2.set_outputs([remap[o] for o in g.outputs])
    g2.prune()
    return g2


def _adv_inputs():
    rng = np.random.default_rng(7)
    return [torch.from_numpy(rng.normal(size=s).astype(np.float32))
            for s in ((4, 16), (16, 32), (32,), (32, 8))]


def _adv_body(x, w1, s, w2):
    h = tapir.linear(x, w1, activation="silu")
    return tapir.linear(L.rmsnorm(h, s), w2)


def _region_program(cache_dir: str, mode: str = "readwrite"):
    """One small region program (two GEMMs and a lifted norm) under an
    L2-backed config: (output ndarray, cache_stats snapshot)."""
    cfg = TapirConfig(mode="tapir", cost_model=CPU_COST_MODEL,
                      program_cache_dir=cache_dir, cache_mode=mode)
    with use(cfg):
        out = tapir.parallel_region(_adv_body, name="adv")(*_adv_inputs())
    return out.numpy(), dict(tapir.cache_stats())


def _only_entry(cache_dir: str) -> tuple[str, str]:
    """(bin_path, json_path) of the single committed entry."""
    l2 = ProgramDiskCache(cache_dir, "read")
    entries = l2.entries()
    assert len(entries) == 1, f"expected 1 entry, got {len(entries)}"
    return l2.entry_paths(entries[0][0])


_SUBPROC_BODY = """
import json, numpy as np, torch
torch.set_num_threads(1)
from repro_torch.core import tapir
from repro_torch.core.schedule import CPU_COST_MODEL
from repro_torch.core.tapir import TapirConfig, use
from repro_torch.models import layers as L

def adv(x, w1, s, w2):
    h = tapir.linear(x, w1, activation="silu")
    return tapir.linear(L.rmsnorm(h, s), w2)

rng = np.random.default_rng({seed})
args = [torch.from_numpy(rng.normal(size=s).astype(np.float32))
        for s in ((4, 16), (16, 32), (32,), (32, 8))]
cfg = TapirConfig(mode="tapir", cost_model=CPU_COST_MODEL,
                  program_cache_dir={d!r}, cache_mode="readwrite")
with use(cfg):
    o = tapir.parallel_region(adv)(*args)
s = tapir.cache_stats()
res = dict(compiled=s["compiled_programs"], hits=s["l2_hits"],
           writes=s["l2_writes"], out=o.numpy().tobytes().hex())
if {check}:
    # the same inputs compiled afresh in this process, store off
    tapir.clear_cache()
    with use(TapirConfig(mode="tapir", cost_model=CPU_COST_MODEL)):
        res["fresh"] = tapir.parallel_region(adv)(*args).numpy().tobytes().hex()
print("STATS::" + json.dumps(res))
"""


def _env(src: pathlib.Path = SRC) -> dict:
    return dict(os.environ, PYTHONPATH=str(src), OMP_NUM_THREADS="1",
                JAX_PLATFORMS="cpu")


def _spawn(d: str, cwd, seed: int = 7, check: bool = False,
           src: pathlib.Path = SRC) -> subprocess.Popen:
    script = _SUBPROC_BODY.format(d=d, seed=seed, check=check)
    return subprocess.Popen([sys.executable, "-c", script], env=_env(src),
                            cwd=str(cwd), stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _stats_of(p: subprocess.Popen) -> dict:
    out, err = p.communicate(timeout=300)
    assert p.returncode == 0, f"stderr:\n{err[-2000:]}"
    for line in out.splitlines():
        if line.startswith("STATS::"):
            return json.loads(line[len("STATS::"):])
    raise AssertionError(f"no STATS:: in\n{out[-1000:]}")


# ---------------------------------------------------------------------------
# 1. key stability
# ---------------------------------------------------------------------------

@settings(max_examples=20, deadline=None)
@given(seed=st.integers(0, 10_000), n_ops=st.integers(1, 8),
       offset=st.integers(1, 500))
def test_signature_invariant_under_renumbering(seed, n_ops, offset):
    base = _graph_with_offset(seed, n_ops).signature()
    shifted = _graph_with_offset(seed, n_ops, offset=offset).signature()
    assert base == shifted
    assert stable_digest(base) == stable_digest(shifted)


@settings(max_examples=20, deadline=None)
@given(seed=st.integers(0, 10_000), n_ops=st.integers(2, 8),
       dead_every=st.integers(1, 3))
def test_signature_invariant_under_insertion_order(seed, n_ops, dead_every):
    base = _graph_with_offset(seed, n_ops).signature()
    perturbed = _graph_with_offset(seed, n_ops,
                                   dead_every=dead_every).signature()
    assert base == perturbed


@settings(max_examples=15, deadline=None)
@given(seed=st.integers(0, 10_000), n_ops=st.integers(1, 6))
def test_signature_sensitive_to_impl_and_sharding(seed, n_ops):
    g = _graph_with_offset(seed, n_ops)
    base = g.signature()
    nid = g.outputs[0]
    g.nodes[nid].schedule.impl = "flash_kernel"
    assert g.signature() != base, "Schedule.impl must be part of the key"
    g.nodes[nid].schedule.impl = ""
    assert g.signature() == base
    g.nodes[nid].sharding = ("model", None)
    assert g.signature() != base, "sharding must be part of the key"


def _plain_value(rng: np.random.Generator, depth: int = 0):
    kind = int(rng.integers(0, 9 if depth < 3 else 6))
    if kind == 0:
        return int(rng.integers(-2**40, 2**40))
    if kind == 1:
        return float(rng.normal() * 10 ** int(rng.integers(-8, 8)))
    if kind == 2:
        return "".join(chr(int(c)) for c in rng.integers(32, 0x2FF, 5))
    if kind == 3:
        return bytes(rng.integers(0, 256, int(rng.integers(0, 6))).tolist())
    if kind == 4:
        return [None, True, False][int(rng.integers(0, 3))]
    if kind == 5:
        dt = ["float32", "int32", "uint8", "float64"][int(rng.integers(0, 4))]
        return (rng.normal(size=tuple(rng.integers(1, 4, 2))) * 9).astype(dt)
    n = int(rng.integers(0, 4))
    items = [_plain_value(rng, depth + 1) for _ in range(n)]
    if kind == 6:
        return tuple(items)
    if kind == 7:
        return items
    return {f"k{int(rng.integers(0, 99))}": v for v in items}


@settings(max_examples=40, deadline=None)
@given(seed=st.integers(0, 100_000))
def test_stable_digest_matches_reference_on_plain_data(seed):
    """The port's copy keeps the reference's encoding: ints, floats, str,
    bytes, None/bools, tuples, lists, dicts, numpy arrays and scalars and
    dataclasses digest to the reference's hex string."""
    rng = np.random.default_rng(seed)
    key = ("tapir-program", _plain_value(rng), _plain_value(rng),
           np.float32(rng.normal()), np.int64(rng.integers(0, 9)),
           TensorType((int(rng.integers(1, 9)), 3), "bfloat16"))
    from repro.core.ir import TensorType as JTensorType
    jkey = key[:-1] + (JTensorType(key[-1].shape, key[-1].dtype),)
    assert stable_digest(key) == ref_stable_digest(jkey)


def test_stable_digest_canonicalization():
    assert (stable_digest({"a": 1, "b": 2})
            == stable_digest({"b": 2, "a": 1}))
    assert stable_digest({"a": 1}) != stable_digest({"a": 2})
    assert stable_digest(1) != stable_digest(1.0)
    assert stable_digest("1") != stable_digest(1)
    assert stable_digest((1, 2)) == stable_digest([1, 2])
    a = np.arange(6, dtype=np.float32).reshape(2, 3)
    assert stable_digest(a) == stable_digest(a.copy())
    assert stable_digest(a) != stable_digest(a.T)

    def f(v):
        return v + 1

    def g(v):
        return v + 1
    assert stable_digest(f) == stable_digest(f)
    assert stable_digest(f) != stable_digest(g)  # different qualname


def test_torch_keys_digest_canonically_and_never_by_value():
    """A ``torch.dtype`` or ``torch.device`` keys by its canonical string, a
    ``torch.Size`` as the tuple it is; a tensor that a closure captures
    keys by shape, dtype and device, never its values (a loaded program
    rebinds the live closure, which reads this process's tensor)."""
    assert stable_digest(torch.float32) == stable_digest(torch.float32)
    assert stable_digest(torch.float32) != stable_digest(torch.bfloat16)
    assert stable_digest(torch.device("cpu")) != stable_digest(
        torch.device("cuda", 0))
    assert stable_digest(torch.device("cuda", 0)) == stable_digest(
        torch.device("cuda:0"))
    assert stable_digest(torch.Size([2, 3])) == stable_digest((2, 3))
    assert stable_digest(torch.float32) != stable_digest("torch.float32")

    def make(w):
        def scaled(v):
            return v * w
        return scaled
    a, b = torch.ones(3), torch.full((3,), 2.0)
    assert stable_digest(make(a)) == stable_digest(make(b))
    assert stable_digest(make(a)) != stable_digest(make(torch.ones(4)))
    assert stable_digest(make(a)) != stable_digest(make(a.double()))


def test_callable_digest_covers_full_code_identity():
    assert (stable_digest(eval("lambda v: v * 0.5"))
            != stable_digest(eval("lambda v: v * 0.25")))
    assert (stable_digest(eval("lambda v: v * 0.5"))
            == stable_digest(eval("lambda v: v * 0.5")))

    def make(c):
        def scaled(v):
            return v * c
        return scaled
    assert stable_digest(make(0.5)) != stable_digest(make(0.25))
    assert stable_digest(make(0.5)) == stable_digest(make(0.5))
    assert (stable_digest(eval("lambda v: np.sin(v)", {"np": np}))
            != stable_digest(eval("lambda v: np.cos(v)", {"np": np})))
    assert (stable_digest(eval("lambda v, s=0.5: v * s"))
            != stable_digest(eval("lambda v, s=0.25: v * s")))
    assert (stable_digest(eval("lambda v: (lambda u: u + 1)(v)"))
            != stable_digest(eval("lambda v: (lambda u: u + 2)(v)")))
    base = eval("lambda v, s: v * s")
    assert (stable_digest(functools.partial(base, s=0.5))
            != stable_digest(functools.partial(base, s=0.25)))


def test_opaque_callable_digest_never_crosses_processes(tmp_path):
    """A callable with no introspectable code is salted per process: stable
    inside one, a guaranteed MISS from any other."""
    assert stable_digest(np.tanh) == stable_digest(np.tanh)
    code = ("import numpy as np\n"
            "from repro_torch.cache import stable_digest\n"
            "print(stable_digest(np.tanh))\n")
    out = subprocess.check_output([sys.executable, "-c", code], env=_env(),
                                  cwd=str(tmp_path), text=True)
    assert out.strip() != stable_digest(np.tanh)


def test_l2_digest_sees_every_cost_model_field_and_version(monkeypatch):
    """Two cost models of one name but other constants schedule otherwise:
    the L2 digest holds every field (the L1 key holds the name).  And it
    holds the versions: torch, CUDA, the device kind, the kernel sources."""
    import dataclasses
    key = ("region", ("g",))
    cfg = TapirConfig(cost_model=CPU_COST_MODEL)
    other = TapirConfig(cost_model=dataclasses.replace(CPU_COST_MODEL,
                                                       grain_flops=1.0))
    assert tapir._l2_digest(key, cfg) != tapir._l2_digest(key, other)
    base = tapir._l2_digest(key, cfg)
    for field, value in (("torch", "99.0"), ("cuda", "99.9"),
                         ("device", "sm_90"), ("kernels", "0" * 64)):
        vers = dict(disk_mod._versions(), **{field: value})
        monkeypatch.setattr(disk_mod, "_versions", lambda v=vers: v)
        assert tapir._l2_digest(key, cfg) != base, field
        monkeypatch.undo()
    assert tapir._l2_digest(key, cfg) == base


# ---------------------------------------------------------------------------
# 2. corruption / version skew -> quarantine-and-recompile
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("attack", ["truncate", "bitflip", "torch-skew"])
def test_corrupt_entry_recompiles_cleanly(tmp_path, attack):
    d = str(tmp_path / "store")
    clear_cache()
    out_cold, st_cold = _region_program(d)
    assert st_cold["compiled_programs"] == 1 and st_cold["l2_writes"] == 1

    bin_path, json_path = _only_entry(d)
    if attack == "truncate":
        raw = open(bin_path, "rb").read()
        with open(bin_path, "wb") as f:
            f.write(raw[: len(raw) // 2])
    elif attack == "bitflip":
        raw = bytearray(open(bin_path, "rb").read())
        raw[len(raw) // 3] ^= 0x40
        with open(bin_path, "wb") as f:
            f.write(raw)
    else:
        meta = json.load(open(json_path))
        meta["torch"] = "99.99.99"
        with open(json_path, "w") as f:
            json.dump(meta, f)

    clear_cache()
    out_warm, st_warm = _region_program(d)
    assert st_warm["l2_quarantined"] >= 1, "bad entry must quarantine"
    assert st_warm["l2_hits"] == 0
    assert st_warm["compiled_programs"] == 1, "must recompile cleanly"
    assert out_warm.tobytes() == out_cold.tobytes()
    q = os.path.join(d, "quarantine")
    assert os.path.isdir(q) and len(os.listdir(q)) >= 1
    assert st_warm["l2_writes"] == 1


def test_quarantined_entries_never_probed_again(tmp_path):
    d = str(tmp_path / "store")
    clear_cache()
    _region_program(d)
    bin_path, _ = _only_entry(d)
    with open(bin_path, "wb") as f:
        f.write(b"garbage")
    clear_cache()
    _region_program(d)                          # quarantines + republishes
    q = os.path.join(d, "quarantine")
    before = sorted(os.listdir(q))
    mtimes = {n: os.path.getmtime(os.path.join(q, n)) for n in before}
    clear_cache()
    _, st3 = _region_program(d)                 # hits the fresh entry
    assert st3["l2_hits"] == 1 and st3["l2_quarantined"] == 0
    assert sorted(os.listdir(q)) == before, "quarantine must be untouched"
    for n in before:
        assert os.path.getmtime(os.path.join(q, n)) == mtimes[n]


def test_cpu_entry_is_never_probed_under_a_cards_versions(tmp_path,
                                                          monkeypatch):
    """The device kind is in the key: a process on a card computes another
    digest and never reads the CPU's entry (a plain miss, nothing
    quarantined); a CPU sidecar found under a card's digest is version
    skew."""
    d = str(tmp_path / "store")
    clear_cache()
    out_cpu, _ = _region_program(d)
    (cpu_digest, cpu_meta), = ProgramDiskCache(d, "read").entries()
    assert cpu_meta["device"] == "cpu"
    monkeypatch.setattr(disk_mod, "device_kind", lambda: "sm_90")
    clear_cache()
    out, st = _region_program(d)
    assert st["l2_hits"] == 0 and st["l2_quarantined"] == 0
    assert st["compiled_programs"] == 1 and st["l2_writes"] == 1
    assert out.tobytes() == out_cpu.tobytes()
    entries = dict(ProgramDiskCache(d, "read").entries())
    assert len(entries) == 2 and entries[cpu_digest]["device"] == "cpu"
    # a hand-copied store: the CPU's files under the card's digest
    (card_digest,) = set(entries) - {cpu_digest}
    l2 = ProgramDiskCache(d, "readwrite")
    for src, dst in zip(l2.entry_paths(cpu_digest),
                        l2.entry_paths(card_digest)):
        shutil.copyfile(src, dst)
    meta = json.load(open(l2.entry_paths(card_digest)[1]))
    meta["key_digest"] = card_digest
    with open(l2.entry_paths(card_digest)[1], "w") as f:
        json.dump(meta, f)
    clear_cache()
    _, st = _region_program(d)
    assert st["l2_hits"] == 0 and st["l2_quarantined"] == 1


def test_read_mode_never_publishes(tmp_path):
    d = str(tmp_path / "store")
    clear_cache()
    _, st1 = _region_program(d, mode="read")
    assert st1["compiled_programs"] == 1 and st1["l2_writes"] == 0
    assert ProgramDiskCache(d, "read").entries() == []


def test_read_mode_never_quarantines_shared_store(tmp_path):
    d = str(tmp_path / "store")
    clear_cache()
    out_cold, _ = _region_program(d)
    bin_path, json_path = _only_entry(d)
    raw = bytearray(open(bin_path, "rb").read())
    raw[len(raw) // 2] ^= 0x01
    with open(bin_path, "wb") as f:
        f.write(raw)
    clear_cache()
    out, st = _region_program(d, mode="read")
    assert st["compiled_programs"] == 1 and st["l2_hits"] == 0
    assert st["l2_quarantined"] == 0 and st["l2_writes"] == 0
    assert out.tobytes() == out_cold.tobytes()
    assert os.path.exists(bin_path) and os.path.exists(json_path)
    assert not os.path.isdir(os.path.join(d, "quarantine"))
    meta = json.load(open(json_path))
    meta["torch"] = "99.99.99"
    with open(json_path, "w") as f:
        json.dump(meta, f)
    ro = ProgramDiskCache(d, "read")
    digest = ro.entries()[0][0]
    assert ro.get(digest) is None
    assert ro.stats["quarantined"] == 0
    assert os.path.exists(bin_path) and os.path.exists(json_path)


def test_payload_container_is_not_pickle(tmp_path):
    """The frame is JSON plus raw array bytes and decodes to plain data
    only; a pickle planted in the store fails closed as a decode error
    (quarantined, recompiled), never an unpickle."""
    import pickle
    from repro_torch.cache.disk import decode_program_payload
    d = str(tmp_path / "store")
    clear_cache()
    out_cold, _ = _region_program(d)
    bin_path, json_path = _only_entry(d)
    raw = open(bin_path, "rb").read()
    header, blob = decode_program_payload(raw)
    assert raw[:4] == b"RTG1" and isinstance(header, dict)
    text = json.dumps(header)
    # the lifted norm is a reference into the live graph, not its code
    assert '"t": "ref"' in text and "_rmsnorm_impl" in text
    assert "co_code" not in text and b"\x80\x04" not in raw[:8]

    class Boom:
        def __reduce__(self):
            return (os.system, ("false",))

    bomb = pickle.dumps(Boom())
    with pytest.raises(ValueError):
        decode_program_payload(bomb)
    with open(bin_path, "wb") as f:
        f.write(bomb)
    meta = json.load(open(json_path))
    meta["payload_sha256"] = hashlib.sha256(bomb).hexdigest()
    meta["payload_bytes"] = len(bomb)
    with open(json_path, "w") as f:
        json.dump(meta, f)
    clear_cache()
    out_warm, st = _region_program(d)
    assert st["l2_hits"] == 0 and st["compiled_programs"] == 1
    assert st["l2_quarantined"] >= 1
    assert out_warm.tobytes() == out_cold.tobytes()


def test_kernel_source_edit_misses(tmp_path):
    """The kernels' source digest is in the key: a process running from a
    copy of the tree whose ``.cu`` was edited misses the entry the
    original tree wrote (and writes its own)."""
    d = str(tmp_path / "store")
    clear_cache()
    out_cold, _ = _region_program(d)
    copy = tmp_path / "tree" / "src"
    shutil.copytree(SRC / "repro_torch", copy / "repro_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    cu = copy / "repro_torch/kernels/fused_matmul/csrc/fused_matmul.cu"
    cu.write_text(cu.read_text() + "\n// edited\n")
    res = _stats_of(_spawn(d, tmp_path, src=copy))
    assert res["compiled"] == 1 and res["hits"] == 0 and res["writes"] == 1
    assert bytes.fromhex(res["out"]) == out_cold.tobytes()
    assert len(ProgramDiskCache(d, "read").entries()) == 2


# ---------------------------------------------------------------------------
# 3. processes
# ---------------------------------------------------------------------------

def test_concurrent_writers_one_durable_winner(tmp_path):
    d = str(tmp_path / "store")
    p1, p2 = _spawn(d, tmp_path), _spawn(d, tmp_path)
    r1, r2 = _stats_of(p1), _stats_of(p2)
    assert r1["out"] == r2["out"], "racing processes must agree"
    assert r1["compiled"] + r2["compiled"] >= 1
    l2 = ProgramDiskCache(d, "read")
    entries = l2.entries()
    assert len(entries) == 1, "same key => one durable entry"
    assert l2.get(entries[0][0]) is not None, "winner must verify"
    r3 = _stats_of(_spawn(d, tmp_path))
    assert r3["compiled"] == 0 and r3["hits"] == 1 and r3["out"] == r1["out"]


def test_warm_process_compiles_zero_programs(tmp_path):
    d = str(tmp_path / "store")
    r1 = _stats_of(_spawn(d, tmp_path))
    assert r1["compiled"] == 1 and r1["writes"] == 1
    r2 = _stats_of(_spawn(d, tmp_path))
    assert r2["compiled"] == 0, "warm start must compile zero programs"
    assert r2["hits"] == 1 and r2["writes"] == 0
    assert r2["out"] == r1["out"]


def test_processes_with_other_weights_share_a_store(tmp_path):
    """The key holds no weight: a process with other weights hits the
    first one's entry and gives, bitwise, what a compile gives it."""
    d = str(tmp_path / "store")
    r0 = _stats_of(_spawn(d, tmp_path, seed=0, check=True))
    r1 = _stats_of(_spawn(d, tmp_path, seed=1, check=True))
    assert r0["compiled"] == 1 and r0["writes"] == 1
    assert r1["compiled"] == 0 and r1["hits"] == 1
    assert r0["out"] == r0["fresh"] and r1["out"] == r1["fresh"]
    assert r0["out"] != r1["out"]


FAMILIES = ["qwen2_5_3b", "chatglm3_6b", "rwkv6_7b", "zamba2_7b"]


@pytest.mark.parametrize("arch", FAMILIES)
def test_launch_serve_warm_process_compiles_nothing(tmp_path, arch):
    """``launch/serve.py --smoke --device cpu --program-cache-dir D``: the
    first process (this one) compiles and publishes every region program;
    a second process on the store compiles none, hits them all and
    serves the same tokens."""
    d = str(tmp_path / "store")
    argv = ["--arch", arch, "--smoke", "--device", "cpu", "--requests", "3",
            "--batch", "2", "--prompt-len", "12", "--prefix-len", "8",
            "--max-new", "3", "--max-len", "64", "--program-cache-dir", d]
    clear_cache()
    cold_out = serve_cli.main(argv)
    cold = tapir.cache_stats()
    assert cold["compiled_programs"] > 0
    assert cold["l2_writes"] == cold["compiled_programs"]
    code = ("import json, sys, torch\ntorch.set_num_threads(1)\n"
            "from repro_torch.launch import serve\n"
            f"serve.main({argv!r})\n")
    out = subprocess.check_output([sys.executable, "-c", code], env=_env(),
                                  cwd=str(tmp_path), text=True)
    warm = json.loads(out.strip().splitlines()[-1])
    assert warm["cache"]["compiled_programs"] == 0
    assert warm["cache"]["l2_hits"] == cold["compiled_programs"]
    assert warm["cache"]["l2_quarantined"] == 0
    outs = [list(map(int, r.out)) for r in cold_out]
    assert warm["out_sha256"] == hashlib.sha256(
        json.dumps(outs).encode()).hexdigest()


# ---------------------------------------------------------------------------
# 4. L1/L2 coherence
# ---------------------------------------------------------------------------

def test_clear_cache_is_l1_only(tmp_path):
    d = str(tmp_path / "store")
    clear_cache()
    _region_program(d)
    clear_cache()
    assert tapir.cache_stats()["size"] == 0
    assert len(ProgramDiskCache(d, "read").entries()) == 1
    _, st = _region_program(d)
    assert st["compiled_programs"] == 0 and st["l2_hits"] == 1


def test_program_cache_clear_empties_store(tmp_path):
    d = str(tmp_path / "store")
    clear_cache()
    cfg = TapirConfig(cost_model=CPU_COST_MODEL, program_cache_dir=d)
    _region_program(d)
    l2 = tapir.program_cache(cfg)
    assert len(l2.entries()) == 1
    assert l2.invalidate((("model", 8),)) == 0     # another mesh's
    assert l2.clear() == 1
    assert l2.entries() == []
    clear_cache()
    _, st = _region_program(d)
    assert st["compiled_programs"] == 1, "cleared store must recompile"
    assert tapir.program_cache(TapirConfig()) is None
    assert tapir.program_cache(TapirConfig(program_cache_dir=d,
                                           cache_mode="off")) is None


def test_pre_bump_pipeline_entry_misses_cleanly(tmp_path, monkeypatch):
    """An entry of the previous pipeline salt is unreachable (its key
    differs: not even probed, nothing quarantined); a same-digest sidecar
    claiming the old salt is version skew."""
    import repro_torch.cache as cache_pkg
    d = str(tmp_path / "store")
    old = "repro-torch-pipeline-0"
    assert cache_pkg.PIPELINE_VERSION != old
    clear_cache()
    monkeypatch.setattr(cache_pkg, "PIPELINE_VERSION", old)
    monkeypatch.setattr(disk_mod, "PIPELINE_VERSION", old)
    out_old, st_old = _region_program(d)
    assert st_old["l2_writes"] == 1
    monkeypatch.undo()
    clear_cache()
    out_new, st_new = _region_program(d)
    assert st_new["l2_hits"] == 0 and st_new["compiled_programs"] == 1
    assert st_new["l2_quarantined"] == 0
    assert len(ProgramDiskCache(d, "read").entries()) == 2
    assert out_new.tobytes() == out_old.tobytes()
    l2 = ProgramDiskCache(d, "readwrite")
    for digest, _ in l2.entries():
        _, json_path = l2.entry_paths(digest)
        meta = json.load(open(json_path))
        meta["pipeline"] = old
        with open(json_path, "w") as f:
            json.dump(meta, f)
    clear_cache()
    _, st3 = _region_program(d)
    assert st3["l2_hits"] == 0 and st3["compiled_programs"] == 1
    assert st3["l2_quarantined"] >= 1


# ---------------------------------------------------------------------------
# 5. what an entry is
# ---------------------------------------------------------------------------

def test_payload_round_trips_every_node_field():
    """An optimized graph encoded and rebuilt against its objects keeps
    every field the lowering and the scheduler's readers use: node order
    and ids, attrs (consts' arrays, static tuples), epilogues, donation and
    anti edges, the schedule's impl, tiles, costs and notes."""
    from repro_torch.cache.disk import (decode_program_payload,
                                        encode_program_payload,
                                        object_refs, rebuild_graph)
    model = get_model(get_smoke("qwen2_5_3b"), device="cpu")
    sp = model.compute_params()
    cache = model.init_slot_cache(2, 32, 8)
    toks = torch.ones((2, 1), dtype=torch.int32)
    clear_cache()
    with use(ServeConfig(target="gpu").tapir_config()):
        model.decode_step_slots(sp, toks, cache)
    graphs = [g for k, g in tapir.cached_graphs().items()
              if k[0] == "region"]
    assert graphs
    for g in graphs:
        refs = object_refs(g)
        raw = encode_program_payload(g, refs, True, frozenset({"a1"}))
        back, graphed, written = rebuild_graph(decode_program_payload(raw),
                                               refs)
        assert (graphed, written) == (True, frozenset({"a1"}))
        assert back.signature() == g.signature()
        assert list(back.nodes) == list(g.nodes)
        assert back.topo_order() == g.topo_order()
        for nid, n in g.nodes.items():
            b = back.nodes[nid]
            assert b.anti == n.anti and b.donates == n.donates
            assert b.epilogue == n.epilogue
            assert b.schedule == n.schedule
            for k, v in n.attrs.items():
                if isinstance(v, np.ndarray):
                    assert v.dtype == b.attrs[k].dtype
                    assert np.array_equal(v, b.attrs[k])
                else:
                    assert b.attrs[k] == v and type(b.attrs[k]) is type(v)
        assert back.inputs == g.inputs and back.outputs == g.outputs
        # a reference that does not resolve to the same object fails
        bad = list(refs)
        if bad:
            bad[0] = _adv_body
            with pytest.raises(ValueError):
                rebuild_graph(decode_program_payload(raw), bad)


@pytest.mark.parametrize("arch", FAMILIES + ["moonshot_v1_16b_a3b"])
def test_loaded_graph_equals_a_fresh_compile(tmp_path, arch):
    """SMOKE serving of each family (the MoE family's graphs: a
    ``zero_init`` scatter, 3-D matmuls, a lifted router returning int and
    bool outputs), cold (compiled and published), then
    warm from the store after ``clear_cache``: every region program is
    loaded (none compiled), its graph's signature equals the fresh
    compile's, its CUDA-graph verdict and written inputs are the same,
    and every request's tokens are bitwise the same."""
    d = str(tmp_path / "store")
    model = get_model(get_smoke(arch), device="cpu")
    rng = np.random.default_rng(3)
    prefix = rng.integers(1, 500, 8).astype(np.int32)
    prompts = [np.concatenate([prefix, rng.integers(1, 500, n)
                               .astype(np.int32)]) for n in (4, 7, 2)]
    cfg = ServeConfig(target="gpu", program_cache_dir=d, page_len=8)

    def serve():
        eng = ServingEngine(model, batch=2, max_len=32, cfg=cfg,
                            device="cpu")
        out = eng.run([Request(i, p.copy(), max_new=4)
                       for i, p in enumerate(prompts)])
        regions = {k: g for k, g in tapir.cached_graphs().items()
                   if k[0] == "region"}
        progs = {k: (tapir._CACHE[k].graphed, tapir._CACHE[k].written)
                 for k in regions}
        return [r.out for r in out], eng.last_stats, regions, progs

    clear_cache()
    toks_c, st_c, graphs_c, progs_c = serve()
    assert st_c["compiled_programs"] == st_c["l2_writes"] > 0
    sigs_c = {k: g.signature() for k, g in graphs_c.items()}
    clear_cache()
    toks_w, st_w, graphs_w, progs_w = serve()
    assert st_w["compiled_programs"] == 0
    assert st_w["l2_hits"] == st_c["compiled_programs"]
    assert {k: g.signature() for k, g in graphs_w.items()} == sigs_c
    assert progs_w == progs_c
    assert all(p["source"] == "disk" for p in tapir._PROVENANCE.values())
    assert "program cache provenance" in tapir.explain()
    assert toks_w == toks_c


def test_a_loaded_program_that_raises_falls_back_once(tmp_path,
                                                      monkeypatch):
    """A program emitted from a stored graph whose first call raises
    (before writing any input) is replaced by a fresh compile, once: the
    caller gets the compile's answer, the entry is quarantined and the
    fallback counted; the store then heals on the next miss."""
    d = str(tmp_path / "store")
    clear_cache()
    out_cold, _ = _region_program(d)
    real_emit = tapir.emit
    calls = {"n": 0}

    def flaky_emit(g):
        fn = real_emit(g)
        if calls["n"] == 0:
            calls["n"] += 1

            def broken(inputs):
                raise RuntimeError("injected launch failure")
            return broken
        return fn

    monkeypatch.setattr(tapir, "emit", flaky_emit)
    clear_cache()
    out, st = _region_program(d)
    assert out.tobytes() == out_cold.tobytes()
    assert st["l2_hits"] == 1 and st["l2_fallbacks"] == 1
    assert st["l2_quarantined"] == 1 and st["compiled_programs"] == 1
    assert "recompiled" in next(iter(tapir._PROVENANCE.values()))["source"]
    # the same process keeps the fresh program: no second fallback
    out2, st2 = _region_program(d)
    assert out2.tobytes() == out_cold.tobytes()
    assert st2["l2_fallbacks"] == 1 and st2["compiled_programs"] == 1
    monkeypatch.undo()
    clear_cache()
    _, st3 = _region_program(d)     # quarantined: a miss, then republished
    assert st3["l2_hits"] == 0 and st3["l2_writes"] == 1


def test_a_loaded_program_that_wrote_an_input_is_not_retried(tmp_path,
                                                             monkeypatch):
    """A first call that raised after writing an input in place propagates:
    a retry would write it twice."""
    d = str(tmp_path / "store")
    cfg = TapirConfig(cost_model=CPU_COST_MODEL, program_cache_dir=d)

    def step(buf, upd):
        return tapir.cache_write(buf, upd, (0, 1))

    region = tapir.parallel_region(step, name="write_step")
    buf, upd = torch.zeros(2, 6), torch.ones(2, 2)
    clear_cache()
    with use(cfg):
        region(buf, upd)
    real_emit = tapir.emit

    def writes_then_raises(g):
        fn = real_emit(g)

        def run(inputs):
            fn(inputs)
            raise RuntimeError("injected failure after the write")
        return run

    monkeypatch.setattr(tapir, "emit", writes_then_raises)
    clear_cache()
    with use(cfg), pytest.raises(RuntimeError, match="after the write"):
        region(torch.zeros(2, 6), upd)
    assert tapir.cache_stats()["l2_fallbacks"] == 0
