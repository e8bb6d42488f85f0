"""The port's mesh on the CPU: qwen2.5-3b SMOKE at fp32 on (data, model)
meshes of gloo rank processes (``repro_torch.testing.run_ranks``), held
bit for bit to the port on one device, which the reference's own mesh
tests hold to the reference (``tests/test_mesh_sharding.py``,
``tests/test_fault_serving.py``; on this image's jax they cannot run).

* the forward and slot serving on (2, 2) and (2, 4) equal one device's;
* the slot parameters: ``wq`` column-sharded, ``wo`` replicated; the
  replicated leaves (the page pools across ``data``, ``ptab``, ``pos``)
  hold equal bits on every rank that replicates them; the slot programs
  carry sharding annotations;
* the padded cache's prefill / decode steps on a mesh equal one device's;
* a killed host shrinks (2, 2) to (1, 2) with the clean run's tokens, the
  dead fingerprint purged from memory and disk and the new one present;
* a slot checkpoint written on 4 ranks restores onto 2 with equal leaves;
* preemption and prefix sharing on a mesh are bitwise;
* ``shrink_mesh`` drops the failed rank's data (or pod) row and refuses a
  pure tensor-parallel mesh.

The one-device run each is held to runs once, in a process of its own
with one CPU thread, as each rank does."""
import concurrent.futures

import numpy as np
import pytest

from repro_torch.testing import run_ranks

_SETUP = """
import repro_torch.configs as C
from repro_torch.core import tapir
from repro_torch.core.tapir import SPEC_ATTR, cached_graphs, clear_cache
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models.base import get_model
from repro_torch.serve.engine import Request, ServeConfig, ServingEngine
cfg = dataclasses.replace(C.get_smoke("qwen2_5_3b"),
                          compute_dtype="float32")
CPU = ServeConfig(target="cpu")
def digest(t):
    return float(t.double().sum()) + float((t.double() ** 2).sum())
"""

_SLOT_REQUESTS = """
rng = np.random.default_rng(0)
lens, news = [6, 4, 7, 5, 6], [4, 8, 6, 5, 7]
prompts = [rng.integers(1, 100, size=n).astype(np.int32) for n in lens]
def mk():
    return [Request(rid=i, prompt=p.copy(), max_new=m)
            for i, (p, m) in enumerate(zip(prompts, news))]
"""

_FAULT_REQUESTS = """
def mk():
    rng = np.random.default_rng(0)
    plens, news = [6, 4, 7, 5, 6, 3], [4, 12, 6, 10, 8, 14]
    return [Request(rid=i, prompt=rng.integers(1, 100, size=p).astype(
                np.int32), max_new=n)
            for i, (p, n) in enumerate(zip(plens, news))]
"""

_PREEMPT_REQUESTS = """
rng = np.random.default_rng(0)
low_p = rng.integers(1, 100, size=6).astype(np.int32)
high_p = rng.integers(1, 100, size=5).astype(np.int32)
prefix = rng.integers(1, 100, size=64).astype(np.int32)
sufs = [rng.integers(1, 100, size=4).astype(np.int32) for _ in range(3)]
def preempt_reqs(with_prio):
    return [Request(rid=0, prompt=low_p.copy(), max_new=12, priority=0),
            Request(rid=1, prompt=high_p.copy(), max_new=3,
                    priority=5 if with_prio else 0,
                    arrival_step=3 if with_prio else 0)]
def prefix_reqs():
    return [Request(rid=i, prompt=np.concatenate([prefix, s]), max_new=4)
            for i, s in enumerate(sufs)]
"""


def _run(body, world, timeout=60):
    return run_ranks(_SETUP + body, world, timeout=timeout)


def _with_one_device(ref_body, body, world):
    """(the one-device run's result: ``ref_body`` in one process with no
    mesh, the ranks' results), the two started together."""
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ref = pool.submit(_run, ref_body, 1)
        res = _run(body, world)
        return ref.result()[0], res


@pytest.mark.parametrize("data,model", [(2, 2), (2, 4)])
def test_forward_on_mesh_matches_one_device(data, model):
    tok = """
tok = torch.as_tensor(np.random.default_rng(0).integers(1, 100, (4, 16)),
                      dtype=torch.int32)
"""
    ref_body = (tok + """
with tapir.use(CPU.tapir_config()):
    result["logits"] = get_model(cfg, device="cpu").forward(
        {"tokens": tok}).tolist()
""")
    ref, res = _with_one_device(ref_body, tok + f"""
from repro_torch.dist import use_mesh
mesh = make_test_mesh({data}, {model})
model = get_model(cfg, device="cpu", mesh=mesh)
with use_mesh(mesh), tapir.use(CPU.tapir_config()):
    got = model.forward({{"tokens": tok}})
result["spec"] = list(getattr(got, SPEC_ATTR))
result["coord"] = [mesh.coord("data"), mesh.coord("model")]
result["block"] = got.tolist()
""", data * model)
    whole = np.asarray(ref["logits"], np.float32)
    for r in res:
        assert r["spec"] == ["data", None, "model"], r["spec"]
        d, m = r["coord"]
        rows, cols = 4 // data, 512 // model
        want = whole[d * rows:(d + 1) * rows, :, m * cols:(m + 1) * cols]
        got = np.asarray(r["block"], np.float32)
        assert got.shape == want.shape == (2, 16, cols)
        assert np.array_equal(got, want), r["coord"]


@pytest.mark.parametrize("data,model", [(2, 2), (2, 4)])
def test_slot_serving_on_mesh_matches_one_device(data, model):
    ref_body = (_SLOT_REQUESTS + """
out = ServingEngine(get_model(cfg, device="cpu"), batch=4, max_len=32,
                    cfg=CPU, device="cpu").run(mk())
result["outs"] = [r.out for r in out]
""")
    ref, res = _with_one_device(ref_body, _SLOT_REQUESTS + f"""
mesh = make_test_mesh({data}, {model})
model = get_model(cfg, device="cpu", mesh=mesh)
eng = ServingEngine(model, batch=4, max_len=32, cfg=CPU, device="cpu",
                    mesh=mesh)
eng._run_padded_waves = None      # the slot path, never padded waves
seen = dict()
decode = model.decode_step_slots
def spy(sp, tokens, cache):
    seen["cache"] = cache
    return decode(sp, tokens, cache)
model.decode_step_slots = spy
out = eng.run(mk())
result["outs"] = [r.out for r in out]
result["done"] = all(r.done for r in out)
result["stats"] = {{k: eng.last_stats[k] for k in ("admitted", "tokens")}}
result["annotated"] = sum(1 for g in cached_graphs().values()
                          for n in g.nodes.values() if n.sharding)
layer = eng._sp["layers"][0][1]
result["wq"] = [list(layer["wq"].shape),
                getattr(layer["wq"], SPEC_ATTR, None)]
result["wo"] = [list(layer["wo"].shape),
                getattr(layer["wo"], SPEC_ATTR, None)]
result["coord"] = [mesh.coord("data"), mesh.coord("model")]
# the device state after the last decode step: pools, ptab, pos
cache = seen["cache"]
result["pools"] = [digest(t) for t in cache["k"] + cache["v"]]
result["pool_spec"] = getattr(cache["k"][0], SPEC_ATTR, None)
result["ptab_pos"] = [digest(cache["ptab"]), digest(cache["pos"])]
""", data * model)
    kv_split = 2 % model == 0          # Hkv = 2 shards only when it divides
    for r in res:
        assert r["outs"] == ref["outs"] and r["done"], r["coord"]
        assert r["stats"] == {"admitted": 5, "tokens": 30}, r
        assert r["annotated"] > 0, r
        # wq column-sharded with its kv heads; wo replicated
        assert r["wq"] == ([[96, 96 // model], [None, "model"]] if kv_split
                           else [[96, 96], None]), r
        assert r["wo"] == [[96, 96], None], r
        assert (r["pool_spec"] == [None, None, "model", None] if kv_split
                else not any(r["pool_spec"] or ())), r
    # replicated leaves hold the same bits on every rank replicating them
    for r in res:
        peers = [q for q in res if q["coord"][1] == r["coord"][1]
                 or not kv_split]
        for q in peers:
            assert q["pools"] == r["pools"], (q["coord"], r["coord"])
        assert r["ptab_pos"] == res[0]["ptab_pos"]


def test_padded_cache_steps_on_mesh_match_one_device():
    serve = """
from repro_torch.serve.engine import make_decode_step, make_prefill_step
tok = np.random.default_rng(1).integers(1, 100, (4, 8)).astype(np.int32)
def serve(model, mesh):
    pre = make_prefill_step(model, mesh, CPU)
    dec = make_decode_step(model, mesh, CPU)
    cache = model.init_cache(4, 32)
    logits, cache = pre(tok, cache)
    nxt = torch.argmax(logits, -1).to(torch.int32)
    toks = [nxt.tolist()]
    for _ in range(5):
        nxt, cache = dec(nxt[:, None], cache)
        toks.append(nxt.tolist())
    return toks, cache
"""
    ref_body = (serve + """
result["toks"] = serve(get_model(cfg, device="cpu"), None)[0]
""")
    ref, res = _with_one_device(ref_body, serve + """
mesh = make_test_mesh(2, 2)
result["toks"], cache = serve(get_model(cfg, device="cpu", mesh=mesh), mesh)
result["cache_block"] = list(cache["k"].shape)
""", 4)
    for r in res:
        assert r["toks"] == ref["toks"], r
        assert r["cache_block"] == [2, 2, 32, 1, 24], r


def test_killed_host_shrinks_the_mesh_and_matches_the_clean_run():
    ref_body = (_FAULT_REQUESTS + """
eng0 = ServingEngine(get_model(cfg, device="cpu"), batch=4, max_len=64,
                     cfg=CPU, device="cpu")
clean = eng0.run(mk())
result["outs"] = [[r.out, r.done] for r in clean]
result["decode_steps"] = eng0.last_stats["decode_steps"]
""")
    ref, res = _with_one_device(ref_body, _FAULT_REQUESTS + """
from repro_torch.dist.fault import Fault, ScriptedFaultInjector
mesh = make_test_mesh(2, 2)
victim = int(mesh.devices[1, 0])
tmp = os.path.dirname(store)
scfg = ServeConfig(target="cpu",
                   fault_injector=ScriptedFaultInjector(
                       {9: Fault("host", host=victim)}),
                   ckpt_dir=os.path.join(tmp, "ck"), ckpt_every=4,
                   program_cache_dir=os.path.join(tmp, f"pc{rank}"))
eng = ServingEngine(get_model(cfg, device="cpu", mesh=mesh), batch=4,
                    max_len=64, cfg=scfg, device="cpu", mesh=mesh)
faulted = eng.run(mk())
result["evicted"] = eng.evicted
if not eng.evicted:
    progs = {k[-1] for k in tapir._PROGRAMS}
    disk = {tuple(tuple(p) for p in m["mesh_fingerprint"])
            for _, m in tapir.program_cache(scfg.tapir_config()).entries()}
    layer = eng._sp["layers"][0][1]
    result.update(
        outs=[[r.out, r.done] for r in faulted],
        mesh_shape=list(eng.mesh.devices.shape),
        victim_gone=victim not in eng.mesh.devices.ravel().tolist(),
        old_purged=(("data", 2), ("model", 2)) not in progs
        and (("data", 2), ("model", 2)) not in disk,
        new_present=(("data", 1), ("model", 2)) in progs
        and (("data", 1), ("model", 2)) in disk,
        decode_steps=eng.last_stats["decode_steps"],
        wq=getattr(layer["wq"], SPEC_ATTR, None),
        wo=getattr(layer["wo"], SPEC_ATTR, None),
        stats={k: eng.last_stats[k] for k in
               ("failures", "restores", "mesh_shrinks", "checkpoints")})
""", 4)
    assert [r["evicted"] for r in res] == [False, False, True, True]
    for r in res[:2]:
        assert r["outs"] == ref["outs"], r
        assert r["decode_steps"] == ref["decode_steps"], r
        assert r["mesh_shape"] == [1, 2] and r["victim_gone"], r
        assert r["old_purged"] and r["new_present"], r
        assert r["wq"] == [None, "model"] and r["wo"] is None, r
        assert r["stats"] == {"failures": 1, "restores": 1,
                              "mesh_shrinks": 1, "checkpoints": 4}, r


def test_slot_checkpoint_restores_elastically_from_4_ranks_to_2():
    res = _run("""
from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.dist.sharding import gather_full
from repro_torch.launch.mesh import Mesh
from repro_torch.serve.engine import place_tree, slot_cache_shardings
model = get_model(cfg, device="cpu")
slots, max_len = 4, 32
mesh_a = make_test_mesh(2, 2)
mesh_b = Mesh(np.arange(2).reshape(1, 2), ("data", "model"))
whole = model.init_slot_cache(slots, max_len)
g = torch.Generator().manual_seed(0)
for t in whole["k"] + whole["v"]:
    t.copy_(torch.randn(t.shape, generator=g) * 100)
mine = place_tree(whole, slot_cache_shardings(model, mesh_a, slots, max_len))
d = os.path.join(os.path.dirname(store), "ck")
full = {"cache": {k: ([gather_full(t, mesh_a) for t in v]
                      if isinstance(v, list) else v)
                  for k, v in mine.items()}}
if rank == 0:
    save_checkpoint(d, 3, full)
mesh_a.barrier()
if mesh_b.member:
    sh_b = slot_cache_shardings(model, mesh_b, slots, max_len)
    template = place_tree(model.init_slot_cache(slots, max_len), sh_b)
    state, step, _ = restore_checkpoint(d, {"cache": template},
                                        shardings={"cache": sh_b})
    want = place_tree(whole, sh_b)
    result["step"] = step
    result["equal"] = all(torch.equal(a, b) for a, b in zip(
        state["cache"]["k"] + state["cache"]["v"], want["k"] + want["v"]))
    result["block"] = list(state["cache"]["k"][0].shape)
""", 4)
    for r in res[:2]:
        assert r["step"] == 3 and r["equal"], r
        assert r["block"] == [9, 32, 1, 24], r


def test_preemption_and_prefix_sharing_on_mesh_are_bitwise():
    ref_body = (_PREEMPT_REQUESTS + """
one = get_model(cfg, device="cpu")
pre = ServingEngine(one, batch=1, max_len=64, cfg=CPU,
                    device="cpu").run(preempt_reqs(False))
pfx = ServingEngine(one, batch=2, max_len=128, device="cpu",
                    cfg=ServeConfig(target="cpu",
                                    prefix_sharing=False)).run(prefix_reqs())
result["pre"] = [r.out for r in pre]
result["pfx"] = [r.out for r in pfx]
""")
    ref, res = _with_one_device(ref_body, _PREEMPT_REQUESTS + """
mesh = make_test_mesh(2, 2)
model = get_model(cfg, device="cpu", mesh=mesh)
eng = ServingEngine(model, batch=1, max_len=64, device="cpu", mesh=mesh,
                    cfg=ServeConfig(target="cpu", preempt_mode="park"))
got_pre = eng.run(preempt_reqs(True))
result["parked"] = eng.last_stats["parked"]
eng2 = ServingEngine(model, batch=2, max_len=128, cfg=CPU, device="cpu",
                     mesh=mesh)
got_pfx = eng2.run(prefix_reqs())
result["prefix_hits"] = eng2.last_stats["prefix_hits"]
result["pre"] = [r.out for r in got_pre]
result["pfx"] = [r.out for r in got_pfx]
result["done"] = all(r.done for r in got_pre + got_pfx)
""", 4)
    for r in res:
        assert r["parked"] >= 1 and r["prefix_hits"] >= 1, r
        assert r["pre"] == ref["pre"] and r["pfx"] == ref["pfx"], r
        assert r["done"], r


def test_shrink_mesh_drops_the_failed_row_and_keeps_the_model_axis():
    res = _run("""
from repro_torch.launch.mesh import shrink_mesh
m = make_test_mesh(2, 2)
s = shrink_mesh(m, 2)
result["shrunk"] = [list(s.devices.shape), s.devices.tolist(),
                    list(s.fingerprint), s.member]
p = make_test_mesh(1, 2, pod=2)
result["pod"] = shrink_mesh(p, 3).devices.tolist()
for bad in [(make_test_mesh(1, 4), 1), (m, 7)]:
    try:
        shrink_mesh(*bad)
        result.setdefault("raised", []).append(False)
    except ValueError:
        result.setdefault("raised", []).append(True)
""", 4)
    for rank, r in enumerate(res):
        assert r["shrunk"][:3] == [[1, 2], [[0, 1]],
                                   [["data", 1], ["model", 2]]], r
        assert r["shrunk"][3] == (rank < 2), r
        assert r["pod"] == [[[0, 1]]], r
        assert r["raised"] == [True, True], r
