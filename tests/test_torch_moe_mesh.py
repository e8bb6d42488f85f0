"""The MoE family on the port's mesh, on the CPU: Granite-3.0-1B-A400M and
Moonlight-16B-A3B SMOKE at fp32 on (data, model) meshes of gloo rank
processes (``repro_torch.testing.run_ranks``, one CPU thread each).

A rank routes its data shard's rows (the capacity counted per shard, as
the reference's expert-parallel ``_moe_ffn_ep`` counts it), runs the
expert FFN on its ``E / model`` experts and all-gathers their outputs in
rank order before the combine; the expert leaves are placed by whole
experts (``dist.sharding.weight_spec``).  Held here:

* the mesh forward against the JAX package's one-device forward on each
  data shard's rows, and the mesh loss (the whole batch's mean, the same
  on every rank) against the mean of its per-shard losses (rtol = atol =
  1e-4, as ``tests/test_torch_moe.py``), on (2, 2) and (2, 4);
* that forward bitwise the port's one-device forward of the shard's rows
  (capacity 1.25, where routes drop), and of the whole batch where
  nothing drops (``capacity_factor`` 64), its loss bitwise the one-device
  loss over those logits; opaque mode's = tapir mode's;
* Moonlight slot serving on (2, 4) with the reference test's requests
  (``tests/test_mesh_sharding.py``) bitwise the one-device tokens, on the
  slot path, its programs annotated on the expert dim;
* Granite on (2, 2): preemption and prefix sharing, the padded cache's
  steps (the prefill's capacity over the whole batch) and the host
  fault's shrink to (1, 2), each bitwise the one-device run;
* the expert placement, and ``grouped_matmul_ref`` on a rank's experts =
  those experts' rows of the whole.

The one-device runs each rank is held to run inside the rank, on the
same weights, outside the mesh."""
import dataclasses
import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as RC
from repro.models.base import get_model as j_get_model
from repro_torch.configs import get_smoke
from repro_torch.dist import sharding as PS
from repro_torch.kernels.fused_matmul.ref import grouped_matmul_ref
from repro_torch.models.base import get_model
from repro_torch.testing import run_ranks

GRANITE, MOONLIGHT = "granite_moe_1b_a400m", "moonshot_v1_16b_a3b"
REF_TOL = dict(rtol=1e-4, atol=1e-4)
B, S = 4, 16          # the forward's batch: 2 rows a data shard

_SETUP = """
import repro_torch.configs as C
from repro_torch.core import tapir
from repro_torch.core.tapir import SPEC_ATTR, cached_graphs
from repro_torch.dist import use_mesh
from repro_torch.dist.sharding import gather_full
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import moe
from repro_torch.models.base import get_model
from repro_torch.serve.engine import (Request, ServeConfig, ServingEngine,
                                      make_decode_step, make_prefill_step)
A = json.loads(os.environ["MOE_MESH_ARGS"])
CPU = ServeConfig(target="cpu")
def smoke(arch, **kw):
    return dataclasses.replace(C.get_smoke(arch), compute_dtype="float32",
                               **kw)
"""


def _run(body: str, world: int, timeout: float = 90, **args):
    return run_ranks(_SETUP + body, world, timeout=timeout,
                     env={"MOE_MESH_ARGS": json.dumps(args)})


# -- the forward ---------------------------------------------------------

_FORWARD = """
from repro_torch.models.base import _ce_loss_unmasked
w = np.load(A["npz"])
def tree():
    out = {}
    for key in w.files:
        if key.startswith("_"):
            continue
        *path, leaf = key.split("/")
        node = out
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = torch.from_numpy(w[key].copy())
    return out
tok, lab = torch.from_numpy(w["_tokens"]), torch.from_numpy(w["_labels"])
mesh = make_test_mesh(A["data"], A["model"])
d = mesh.coord("data")
rows = tok.shape[0] // A["data"]
mine = slice(d * rows, (d + 1) * rows)
drops = []
route = moe._route_topk
def spy(*a, **k):
    out = route(*a, **k)
    if not out[3].is_meta:      # not a region's shape inference
        drops.append(int((~out[3]).sum()))
    return out
moe._route_topk = spy
for cf in (1.25, 64.0):
    cfg = smoke(A["arch"], capacity_factor=cf)
    model = get_model(cfg, device="cpu", params=tree(), mesh=mesh)
    one = get_model(cfg, device="cpu", params=tree())
    got = {}
    for mode in ("tapir", "opaque"):
        tc = ServeConfig(target="cpu", mode=mode).tapir_config()
        with use_mesh(mesh), tapir.use(tc):
            drops.clear()
            logits = model.forward({"tokens": tok})
            n_drop = sum(drops)
            loss = model.loss({"tokens": tok, "labels": lab})
            got[mode] = gather_full(logits, mesh)[mine]
        with tapir.use(tc):
            shards = [one.forward({"tokens": tok[i * rows:(i + 1) * rows]})
                      for i in range(A["data"])]
            shard = shards[d]
            # the mesh loss: the whole batch's mean over every data
            # shard's own forward (each shard's capacity its own)
            shard_loss = _ce_loss_unmasked(torch.cat(shards), lab)
            whole = one.forward({"tokens": tok})
            # = one.loss of the whole batch (outside a region ``loss`` is
            # this call on the forward's logits)
            whole_loss = _ce_loss_unmasked(whole, lab)
            whole = whole[mine]
        result[f"{cf}/{mode}"] = {
            "spec": list(getattr(logits, SPEC_ATTR)),
            "block": list(logits.shape), "drops": n_drop,
            "shard_bitwise": bool(torch.equal(got[mode], shard)),
            "whole_bitwise": bool(torch.equal(got[mode], whole)),
            "loss_bitwise": bool(torch.equal(loss, shard_loss)),
            "whole_loss_bitwise": bool(torch.equal(loss, whole_loss)),
            "loss": float(loss)}
    result[f"{cf}/opaque_is_tapir"] = bool(torch.equal(got["opaque"],
                                                       got["tapir"]))
    if cf == 1.25:
        result["logits"] = got["tapir"].tolist()
result["rows"] = [mine.start, mine.stop]
blk = model.blocks["moe"]
result["leaves"] = {k: list(blk[k].shape) for k in ("ewg", "ewu", "ewd",
                                                    "router")}
"""


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """arch -> (the npz of the reference's SMOKE weights, tokens and
    labels, the reference model, its params)."""
    out = {}
    rng = np.random.default_rng(11)
    for arch in (GRANITE, MOONLIGHT):
        jcfg = dataclasses.replace(RC.get_smoke(arch),
                                   compute_dtype="float32")
        jm = j_get_model(jcfg)
        jp = jm.init_params(jax.random.PRNGKey(0))
        flat = {}
        for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]:
            key = "/".join(str(p.key) for p in path)
            flat[key] = np.asarray(leaf, np.float32)
        flat["_tokens"] = rng.integers(1, jcfg.vocab, (B, S)).astype(np.int32)
        flat["_labels"] = rng.integers(0, jcfg.vocab, (B, S)).astype(np.int32)
        path = str(tmp_path_factory.mktemp("w") / f"{arch}.npz")
        np.savez(path, **flat)
        out[arch] = (path, jm, jp, flat)
    return out


@pytest.mark.parametrize("arch,data,model", [
    (GRANITE, 2, 2), (GRANITE, 2, 4), (MOONLIGHT, 2, 2), (MOONLIGHT, 2, 4)])
def test_forward_on_mesh_matches_the_reference_per_data_shard(
        weights, arch, data, model):
    npz, jm, jp, flat = weights[arch]
    res = _run(_FORWARD, data * model, npz=npz, arch=arch, data=data,
               model=model)
    cfg = get_smoke(arch)
    E = cfg.n_experts
    # the loss is the whole batch's mean; the shards are of equal size, so
    # it is the mean of the reference's per-shard losses
    rows = B // data
    want_loss = np.mean([float(jm.loss(jp, {
        "tokens": jnp.asarray(flat["_tokens"][i * rows:(i + 1) * rows]),
        "labels": jnp.asarray(flat["_labels"][i * rows:(i + 1) * rows])}))
        for i in range(data)])
    for rank, r in enumerate(res):
        lo, hi = r["rows"]
        tok = jnp.asarray(flat["_tokens"][lo:hi])
        want = np.asarray(jm.forward(jp, {"tokens": tok}))
        np.testing.assert_allclose(np.asarray(r["logits"], np.float32), want,
                                   **REF_TOL)
        np.testing.assert_allclose(r["1.25/tapir"]["loss"], want_loss,
                                   **REF_TOL)
        for mode in ("tapir", "opaque"):
            dropping, no_drop = r[f"1.25/{mode}"], r[f"64.0/{mode}"]
            assert dropping["spec"] == ["data", None, "model"], rank
            assert dropping["block"] == [B // data, S, cfg.vocab // model]
            # capacity 1.25 drops routes: the shard's own batch, not the
            # whole's; at 64 nothing drops and both agree
            assert dropping["drops"] > 0 and no_drop["drops"] == 0, rank
            assert dropping["shard_bitwise"] and dropping["loss_bitwise"]
            assert no_drop["shard_bitwise"] and no_drop["whole_bitwise"]
            assert no_drop["loss_bitwise"] and no_drop["whole_loss_bitwise"]
        assert r["1.25/opaque_is_tapir"] and r["64.0/opaque_is_tapir"]
        # a rank holds whole experts, E / model of them; the router whole
        assert r["leaves"]["ewg"] == [cfg.n_layers - cfg.first_dense_layers,
                                      E // model, cfg.d_model, cfg.d_ff]
        assert r["leaves"]["ewd"][1:] == [E // model, cfg.d_ff, cfg.d_model]
        assert r["leaves"]["router"][1:] == [cfg.d_model, E]


# -- slot serving ----------------------------------------------------------

_SLOTS = """
rng = np.random.default_rng(0)
lens, news = [6, 4, 7, 5, 6], [4, 8, 6, 5, 7]
prompts = [rng.integers(1, 100, size=n).astype(np.int32) for n in lens]
def mk():
    return [Request(rid=i, prompt=p.copy(), max_new=m)
            for i, (p, m) in enumerate(zip(prompts, news))]
cfg = smoke(A["arch"])
ref = ServingEngine(get_model(cfg, device="cpu"), batch=2, max_len=32,
                    cfg=CPU, device="cpu").run(mk())
mesh = make_test_mesh(A["data"], A["model"])
model = get_model(cfg, device="cpu", mesh=mesh)
eng = ServingEngine(model, batch=2, max_len=32, cfg=CPU, device="cpu",
                    mesh=mesh)
eng._run_padded_waves = None      # the slot path, never padded waves
out = eng.run(mk())
result["bitwise"] = [r.out for r in out] == [r.out for r in ref]
result["done"] = all(r.done for r in out)
graphs = [g for k, g in cached_graphs().items() if k[-1] == mesh.fingerprint]
result["expert_nodes"] = sum(
    1 for g in graphs for n in g.nodes.values()
    if n.op == "matmul" and len(n.ttype.shape) == 3
    and (n.sharding or (None,))[0] == "model")
result["gathers"] = sum(1 for g in graphs for n in g.nodes.values()
                        if n.op == "reshard" and n.attrs["src"]
                        and n.attrs["src"][0] == "model"
                        and len(n.ttype.shape) == 3)
kind, layer = eng._sp["layers"][-1]
result["kind"] = kind
result["pinned"] = {k: [list(layer[k].shape), getattr(layer[k], SPEC_ATTR,
                                                      None)]
                    for k in ("ewg", "ewd", "router")}
"""


def test_moonlight_slot_serving_on_2x4_is_bitwise_one_device():
    cfg = get_smoke(MOONLIGHT)
    E = cfg.n_experts
    for r in _run(_SLOTS, 8, arch=MOONLIGHT, data=2, model=4):
        assert r["bitwise"] and r["done"], r
        # the expert FFN's GEMMs on the rank's block, its outputs gathered
        assert r["expert_nodes"] > 0 and r["gathers"] > 0, r
        assert r["kind"] == "moe"
        assert r["pinned"]["ewg"] == [[E // 4, cfg.d_model, cfg.d_ff],
                                      ["model", None, None]], r
        assert r["pinned"]["ewd"] == [[E // 4, cfg.d_ff, cfg.d_model],
                                      ["model", None, None]], r
        assert r["pinned"]["router"] == [[cfg.d_model, E], None], r


_GRANITE_SERVING = """
cfg = smoke(A["arch"])
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
def fault_reqs():
    rng = np.random.default_rng(0)
    plens, news = [6, 4, 7, 5, 6, 3], [4, 12, 6, 10, 8, 14]
    return [Request(rid=i, prompt=rng.integers(1, 100, size=p).astype(
                np.int32), max_new=n)
            for i, (p, n) in enumerate(zip(plens, news))]
tok = np.random.default_rng(1).integers(1, 100, (4, 8)).astype(np.int32)
def padded(model, mesh):
    pre = make_prefill_step(model, mesh, CPU)
    dec = make_decode_step(model, mesh, CPU)
    cache = model.init_cache(4, 32)
    logits, cache = pre(tok, cache)
    nxt = torch.argmax(logits, -1).to(torch.int32)
    toks = [nxt.tolist()]
    for _ in range(5):
        nxt, cache = dec(nxt[:, None], cache)
        toks.append(nxt.tolist())
    return toks
drops = []
route = moe._route_topk
def spy(*a, **k):
    out = route(*a, **k)
    if not out[3].is_meta:      # not a region's shape inference
        drops.append(int((~out[3]).sum()))
    return out
moe._route_topk = spy
# the one-device runs
one = get_model(cfg, device="cpu")
ref = {"pre": [r.out for r in ServingEngine(
           one, batch=1, max_len=64, cfg=CPU, device="cpu").run(
           preempt_reqs(False))],
       "pfx": [r.out for r in ServingEngine(
           one, batch=2, max_len=128, device="cpu",
           cfg=ServeConfig(target="cpu", prefix_sharing=False)).run(
           prefix_reqs())],
       "padded": padded(one, None)}
ref_fault = ServingEngine(one, batch=4, max_len=64, cfg=CPU,
                          device="cpu").run(fault_reqs())
ref["fault"] = [[r.out, r.done] for r in ref_fault]
# the mesh
mesh = make_test_mesh(2, 2)
model = get_model(cfg, device="cpu", mesh=mesh)
eng = ServingEngine(model, batch=1, max_len=64, device="cpu", mesh=mesh,
                    cfg=ServeConfig(target="cpu", preempt_mode="park"))
pre = eng.run(preempt_reqs(True))
result["parked"] = eng.last_stats["parked"]
eng2 = ServingEngine(model, batch=2, max_len=128, cfg=CPU, device="cpu",
                     mesh=mesh)
pfx = eng2.run(prefix_reqs())
result["prefix_hits"] = eng2.last_stats["prefix_hits"]
drops.clear()
got_padded = padded(model, mesh)
result["padded_drops"] = drops[:cfg.n_layers]
result["pre"] = [r.out for r in pre] == ref["pre"]
result["pfx"] = [r.out for r in pfx] == ref["pfx"]
result["padded"] = got_padded == ref["padded"]
from repro_torch.dist.fault import Fault, ScriptedFaultInjector
from repro_torch.launch.mesh import rank_of
victim = rank_of(mesh, 1, 0)
scfg = ServeConfig(target="cpu", fault_injector=ScriptedFaultInjector(
                       {9: Fault("host", host=victim)}),
                   ckpt_dir=os.path.join(os.path.dirname(store), "ck"),
                   ckpt_every=4)
eng3 = ServingEngine(model, batch=4, max_len=64, cfg=scfg, device="cpu",
                     mesh=mesh)
faulted = eng3.run(fault_reqs())
result["evicted"] = eng3.evicted
if not eng3.evicted:
    result["fault"] = [[r.out, r.done] for r in faulted] == ref["fault"]
    result["mesh_shape"] = list(eng3.mesh.devices.shape)
    result["stats"] = {k: eng3.last_stats[k] for k in
                       ("failures", "restores", "mesh_shrinks")}
    result["ewg"] = getattr(eng3._sp["layers"][0][1]["ewg"], SPEC_ATTR, None)
"""


def test_granite_serving_on_2x2_preempts_shares_pads_and_shrinks_bitwise():
    res = _run(_GRANITE_SERVING, 4, timeout=150, arch=GRANITE)
    assert [r["evicted"] for r in res] == [False, False, True, True]
    for r in res:
        assert r["parked"] >= 1 and r["prefix_hits"] >= 1, r
        assert r["pre"] and r["pfx"], r
        # the padded prefill drops routes, over the whole batch as one
        # device counts them
        assert r["padded"] and r["padded_drops"][0] > 0, r
    for r in res[:2]:
        assert r["fault"] and r["mesh_shape"] == [1, 2], r
        assert r["stats"] == {"failures": 1, "restores": 1,
                              "mesh_shrinks": 1}, r
        # a survivor keeps its model coordinate and so its experts
        assert r["ewg"] == ["model", None, None], r


# -- placement and the grouped product's blocks ----------------------------


def _mesh(coord=0, **axes):
    """A stand-in mesh: the attributes the rules read, at model
    coordinate ``coord``."""
    return types.SimpleNamespace(
        axis_names=tuple(axes), shape=dict(axes),
        size=int(np.prod(list(axes.values()))),
        fingerprint=tuple(axes.items()),
        coord=lambda a: coord if a == "model" else 0)


@pytest.mark.parametrize("E,model,split", [(8, 2, True), (8, 4, True),
                                           (6, 4, False), (64, 4, True)])
def test_expert_leaves_shard_by_whole_experts_where_e_divides(E, model,
                                                              split):
    mesh = _mesh(data=2, model=model)
    want = "model" if split else None
    stacked = ("layers", "expert", "embed", "mlp")
    assert PS.weight_spec(stacked, (2, E, 64, 96), mesh) == \
        (None, want, None, None)
    assert PS.weight_spec(("expert", "mlp", "embed"), (E, 96, 64),
                          mesh) == (want, None, None)
    # the router stays whole; a dense leaf keeps its column rule
    assert PS.weight_spec(("embed", None), (64, E), mesh) == (None, None)
    assert PS.weight_spec(("embed", "mlp"), (64, 96), mesh) == \
        PS.tp_last_dim_spec(("embed", "mlp"), (64, 96), mesh)


@pytest.mark.parametrize("arch", [GRANITE, MOONLIGHT])
def test_a_model_on_a_mesh_holds_its_expert_block(arch):
    """The expert stacks a rank holds are rows of the one-device model's
    (the same draws, cut as drawn); a model placed for one coordinate is
    refused on another."""
    cfg = dataclasses.replace(get_smoke(arch), compute_dtype="float32")
    one = get_model(cfg, device="cpu")
    E = cfg.n_experts
    for c in range(2):
        mesh = _mesh(c, data=2, model=2)
        m = get_model(cfg, device="cpu", mesh=mesh)
        for k in ("ewg", "ewu", "ewd"):
            got, whole = m.blocks["moe"][k], one.blocks["moe"][k]
            assert got.shape[1] == E // 2
            assert torch.equal(got, whole[:, c * E // 2:(c + 1) * E // 2])
        assert torch.equal(m.blocks["moe"]["router"],
                           one.blocks["moe"]["router"])
        assert m.logical_sizes(4)["expert"] == E
        with pytest.raises(ValueError):
            m.check_mesh(_mesh(1 - c, data=2, model=2))
    odd = dataclasses.replace(cfg, n_experts=6)
    m = get_model(odd, device="cpu", mesh=_mesh(data=1, model=4))
    assert m.blocks["moe"]["ewg"].shape[1] == 6


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C", [2, 80])
def test_grouped_ref_on_a_rank_s_experts_is_the_whole_s_rows(C, dtype):
    """The gate's product with its ``silu, mul`` chain over a rank's half
    of the experts = those experts' rows of the whole call."""
    rng = np.random.default_rng(5)
    E, k, n = 8, 64, 48

    def t(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(
            np.float32)).to(dtype)
    x, w, up = t(E, C, k), t(E, k, n), t(E, C, n)

    def call(lo, hi):
        return grouped_matmul_ref(
            x[lo:hi], w[lo:hi],
            epilogue=[("silu", [], {}), ("mul", [up[lo:hi]], {})])
    whole = call(0, E)
    for lo in (0, E // 2):
        assert torch.equal(call(lo, lo + E // 2), whole[lo:lo + E // 2])
