"""The MoE family (``models/moe.py``: Granite-3.0-1B-A400M, Moonlight-16B-A3B)
on the port, at SMOKE shapes on the CPU, against the JAX package's.

The weights are the reference's ``init_params(PRNGKey(0))`` carried across
as numpy (``params_from_numpy``: ``blocks.dense`` / ``blocks.moe``);
tokens and activations are made with numpy from a seed.  Tolerances:
port vs reference at fp32 compute rtol/atol 1e-4 on logits and loss
(``tests/test_torch_forward.py``'s), the router's gates 1e-6 (one fp32
softmax and renormalisation, in another summation order), its ids,
positions and keep mask exactly; the scatter bitwise; greedy tokens
exactly.  The port's own guarantees are bitwise: region = per-op, tapir =
opaque.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as RC
from repro.core import tapir as jtapir
from repro.models import moe as jmoe
from repro.models.base import get_model as j_get_model
from repro.serve import Request as JRequest
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServingEngine as JServingEngine
from repro_torch.configs import ARCH_IDS, get_config, get_smoke
from repro_torch.core import tapir
from repro_torch.core.ir import LIBRARY_OPS
from repro_torch.core.tapir import TapirConfig, clear_cache, use
from repro_torch.launch import serve as serve_cli
from repro_torch.models import layers as L
from repro_torch.models import moe
from repro_torch.models.convert import params_from_numpy
from repro_torch.serve import Request, ServeConfig, ServingEngine

ARCHS = ["granite_moe_1b_a400m", "moonshot_v1_16b_a3b"]
REF_TOL = dict(rtol=1e-4, atol=1e-4)
CPU = ServeConfig(target="cpu")
B, S, NEW = 2, 12, 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """(arch, reference model, its params, the port's model on the same
    weights) at fp32 compute."""
    arch = request.param
    jcfg = dataclasses.replace(RC.get_smoke(arch), compute_dtype="float32")
    jm = j_get_model(jcfg)
    jp = jm.init_params(jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, jp)
    tcfg = dataclasses.replace(get_smoke(arch), compute_dtype="float32")
    return arch, jm, jp, params_from_numpy(tree, tcfg, device="cpu")


def _tokens(vocab: int):
    rng = np.random.default_rng(1)
    return rng.integers(1, vocab, size=(B, S + NEW)).astype(np.int32)


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_are_the_references(arch):
    """Every field of the port's ``ModelConfig`` (the MoE ones among them)
    is the reference's; the reference's other fields are at their
    defaults; the parameter counts are the reference's."""
    assert arch in ARCH_IDS
    for port, ref in ((get_config(arch), RC.get_config(arch)),
                      (get_smoke(arch), RC.get_smoke(arch))):
        mine = dataclasses.asdict(port)
        assert mine == {k: getattr(ref, k) for k in mine}
        for f in dataclasses.fields(ref):
            if f.name not in mine:
                assert getattr(ref, f.name) == f.default, f.name
        assert port.n_params() == ref.n_params()
        assert port.n_active_params() == ref.n_active_params()


def test_weights_carry_across_as_the_two_block_trees(pair):
    arch, jm, jp, tm = pair
    tree = tm.param_tree()["blocks"]
    assert set(tree) == set(jp["blocks"])
    assert ("dense" in tree) == (get_smoke(arch).first_dense_layers > 0)
    for kind, leaves in jp["blocks"].items():
        assert set(tree[kind]) == set(leaves)
        for k, v in leaves.items():
            np.testing.assert_array_equal(tree[kind][k].numpy(),
                                          np.asarray(v))


@pytest.mark.parametrize("cf", [0.5, 4.0])
def test_route_topk_matches_reference(cf):
    """Gates within 1e-6, expert ids, capacity positions and the keep mask
    exactly, with a capacity low enough that tokens drop (cf 0.5) and one
    of T, where none does (cf 4)."""
    rng = np.random.default_rng(7)
    T, d, E, K = 24, 32, 8, 2
    xt = rng.normal(size=(T, d)).astype(np.float32)
    router = (rng.normal(size=(d, E)) / np.sqrt(d)).astype(np.float32)
    cap = max(1, int(np.ceil(T * K / E * cf)))
    want = jmoe._route_topk(jnp.asarray(xt), jnp.asarray(router), k=K, e=E,
                            cap=cap)
    got = moe._route_topk(torch.from_numpy(xt), torch.from_numpy(router),
                          k=K, e=E, cap=cap)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=1e-6, atol=1e-6)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[1].dtype == got[2].dtype == torch.int32
    assert (cf < 1) == (not bool(got[3].all()))


@pytest.mark.parametrize("regions", [False, True])
def test_scatter_new_matches_at_add_drop_bitwise(regions):
    """``scatter_new`` = ``zeros.at[e, p].add(src, mode="drop")``, bitwise,
    with duplicate targets and out-of-range rows; per op and as a
    ``zero_init`` node of a region."""
    rng = np.random.default_rng(2)
    E, cap, d, n = 4, 5, 3, 30
    e = rng.integers(-1, E + 1, n).astype(np.int32)
    p = rng.integers(0, cap + 2, n).astype(np.int32)
    src = rng.normal(size=(n, d)).astype(np.float32)
    want = np.asarray(jnp.zeros((E, cap, d), jnp.float32).at[
        jnp.asarray(e), jnp.asarray(p)].add(jnp.asarray(src), mode="drop"))

    def body(ei, pi, u):
        return tapir.scatter_new((E, cap, d), "float32", (ei, pi), u)

    args = [torch.from_numpy(a) for a in (e, p, src)]
    with use(TapirConfig(regions=regions)):
        got = (tapir.parallel_region(body, name="scatter_new")(*args)
               if regions else body(*args))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("mode", ["tapir", "opaque"])
def test_expert_mlp_matches_reference(mode):
    rng = np.random.default_rng(3)
    E, C, d, f = 4, 6, 16, 24
    x = rng.normal(size=(E, C, d)).astype(np.float32)
    ws = [(rng.normal(size=s) / np.sqrt(s[1])).astype(np.float32)
          for s in ((E, d, f), (E, d, f), (E, f, d))]
    with jtapir.use(jtapir.TapirConfig(mode=mode)):
        want = np.asarray(jtapir.expert_mlp(jnp.asarray(x),
                                            *map(jnp.asarray, ws), "silu"))
    with use(TapirConfig(mode=mode)):
        got = tapir.expert_mlp(torch.from_numpy(x),
                               *map(torch.from_numpy, ws), "silu")
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_forward_and_loss_match_reference(pair):
    arch, jm, jp, tm = pair
    cfg = get_smoke(arch)
    tokens = _tokens(cfg.vocab)
    rng = np.random.default_rng(2)
    labels = rng.integers(0, cfg.vocab, size=tokens.shape).astype(np.int32)
    want = np.asarray(jm.forward(jp, {"tokens": jnp.asarray(tokens)}))
    want_loss = float(jm.loss(jp, {"tokens": jnp.asarray(tokens),
                                   "labels": jnp.asarray(labels)}))
    with tapir.use(CPU.tapir_config()):
        got = tm.forward({"tokens": torch.as_tensor(tokens)})
        loss = tm.loss({"tokens": torch.as_tensor(tokens),
                        "labels": torch.as_tensor(labels)})
    assert got.shape == (B, S + NEW, cfg.vocab)
    np.testing.assert_allclose(got.numpy(), want, **REF_TOL)
    np.testing.assert_allclose(float(loss), want_loss, **REF_TOL)


def test_padded_prefill_and_decode_match_reference(pair):
    """The padded cache's prefill (capacity drops at S > 1, as there) and
    dropless greedy decode: logits within REF_TOL of the reference's at
    every step, and the same greedy tokens."""
    arch, jm, jp, tm = pair
    tokens = _tokens(get_smoke(arch).vocab)
    with jtapir.use(JServeConfig(target="cpu").tapir_config()):
        cache = jm.init_cache(B, S + NEW + 4)
        lg, cache = jm.prefill(jp, jnp.asarray(tokens[:, :S]), cache)
        want, jtoks = [np.asarray(lg)], []
        for _ in range(NEW - 1):
            nxt = np.argmax(want[-1], -1).astype(np.int32)[:, None]
            jtoks.append(nxt)
            lg, cache = jm.decode_step(jp, jnp.asarray(nxt), cache)
            want.append(np.asarray(lg))
    with tapir.use(CPU.tapir_config()):
        cache = tm.init_cache(B, S + NEW + 4)
        lg, cache = tm.prefill(torch.as_tensor(tokens[:, :S]), cache)
        got, ttoks = [lg.numpy()], []
        for _ in range(NEW - 1):
            nxt = np.argmax(got[-1], -1).astype(np.int32)[:, None]
            ttoks.append(nxt)
            lg, cache = tm.decode_step(torch.as_tensor(nxt), cache)
            got.append(lg.numpy())
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g, w, **REF_TOL, err_msg=f"step {i}")
    assert [t.tolist() for t in ttoks] == [t.tolist() for t in jtoks]


def _prompts(vocab):
    rng = np.random.default_rng(9)
    prefix = rng.integers(1, vocab, 16).astype(np.int32)
    prompts = [rng.integers(1, vocab, n).astype(np.int32) for n in (6, 3)]
    prompts += [np.concatenate([prefix, rng.integers(1, vocab, n)
                                .astype(np.int32)]) for n in (2, 5, 1)]
    return prompts, [7, 2, 5, 9, 3]


def _serve(tm, **cfg):
    prompts, news = _prompts(tm.cfg.vocab)
    te = ServingEngine(tm, cfg=ServeConfig(target="cpu", page_len=8, **cfg),
                       device="cpu", batch=2, max_len=32)
    out = te.run([Request(rid=i, prompt=p.copy(), max_new=m)
                  for i, (p, m) in enumerate(zip(prompts, news))])
    assert all(r.done for r in out)
    return [r.out for r in out], te.last_stats


def test_slot_serving_tokens_match_reference_engine(pair):
    """Continuous batching over 2 slots, 5 requests of which 3 share a
    16-token prefix (page_len 8): the reference engine's greedy tokens per
    request, and its scheduling counts."""
    arch, jm, jp, tm = pair
    prompts, news = _prompts(get_smoke(arch).vocab)
    je = JServingEngine(jm, jp, cfg=JServeConfig(target="cpu", page_len=8),
                        batch=2, max_len=32)
    jout = je.run([JRequest(rid=i, prompt=p.copy(), max_new=m)
                   for i, (p, m) in enumerate(zip(prompts, news))])
    tout, st = _serve(tm)
    assert tout == [r.out for r in jout]
    for key in ("tokens", "decode_steps", "admitted", "prefix_hits",
                "prefix_tokens_saved"):
        assert st[key] == je.last_stats[key], key
    assert st["prefix_hits"] == 2


@pytest.mark.parametrize("what", ["regions", "mode"])
def test_region_equals_per_op_and_tapir_equals_opaque(pair, what):
    """Slot serving with every MoE block ONE region (router captured) =
    the per-op control, token for token (the counterpart of the
    reference's ``test_moe_slot_decode_matches_per_op``); tapir (grouped
    GEMMs, fused epilogue) = opaque (per-expert GEMMs)."""
    arch, jm, jp, tm = pair
    clear_cache()
    base, _ = _serve(tm)
    other, _ = _serve(tm, **({"regions": False} if what == "regions"
                             else {"mode": "opaque"}))
    assert other == base


def _decode_block_graph(tm, mode="tapir"):
    """The raw (or, through the pipeline, optimized) region graph of one
    MoE slot decode block."""
    cfg = tm.cfg
    sp = tm.slot_params()
    kind, p = sp["layers"][-1]
    assert kind == "moe"
    cache = tm.init_slot_cache(2, 16, 8)
    x = torch.from_numpy(np.random.default_rng(3).normal(
        size=(2, 1, cfg.d_model)).astype(np.float32))
    cos, sin = L.full_rope_table(16, cfg.hd)
    args = (p, x, cos, sin, cache["k"][-1], cache["v"][-1], cache["pos"],
            cache["ptab"])
    with use(TapirConfig(mode=mode)):
        return tapir.capture_region(tm._slot_moe_block_body, *args)


def test_moe_decode_block_is_one_region_with_router_captured(pair):
    """The counterpart of the reference's test of the same name: the
    router is a lifted node of the block's ONE graph, the dispatch a
    ``zero_init`` scatter and the combine a gather, beside the attention's
    and the experts' library ops."""
    arch, jm, jp, tm = pair
    g = _decode_block_graph(tm)
    ops_ = [n.op for n in g.nodes.values()]
    assert ops_.count("gather") >= 1
    assert sum(1 for o in ops_ if o in LIBRARY_OPS) >= 5
    scat = [n for n in g.nodes.values()
            if n.op == "scatter" and n.attrs.get("zero_init")]
    assert len(scat) == 1 and scat[0].donates is None
    assert any(n.op == "pyfunc" and n.attrs["fn"] is moe._route_topk
               for n in g.nodes.values())


def test_pipeline_folds_silu_mul_into_the_gate_gemm(pair):
    """After the pass pipeline the expert FFN is three 3-D GEMMs, the
    gate's with ``silu, mul`` in its epilogue; the 3-D GEMMs stay out of
    added-GEMM and shared-input fusion (gate and up read the same
    dispatch buffer and stay two), and the schedule costs each with E as a
    batch."""
    from repro_torch.core.passes import run_pipeline
    from repro_torch.core.schedule import H100_COST_MODEL
    arch, jm, jp, tm = pair
    g = run_pipeline(_decode_block_graph(tm), "tapir", H100_COST_MODEL)
    expert = [n for n in g.nodes.values() if n.op == "matmul"
              and len(g.nodes[n.inputs[1]].ttype.shape) == 3]
    assert len(expert) == 3
    chains = sorted(tuple(fn for fn, _, _ in n.epilogue) for n in expert)
    assert chains == [(), (), ("silu", "mul")]
    E = get_smoke(arch).n_experts
    assert all(n.schedule.impl == "fused_kernel" for n in expert)
    assert all(n.ttype.shape[0] == E for n in expert)


@pytest.mark.parametrize("arch", ARCHS)
def test_launch_serve_takes_the_arch(arch, capsys):
    out = serve_cli.main(["--arch", arch, "--smoke", "--device", "cpu",
                          "--requests", "3", "--batch", "2",
                          "--prompt-len", "70", "--prefix-len", "64",
                          "--max-new", "3", "--max-len", "128"])
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rep["device"] == "cpu" and rep["requests"] == 3
    assert rep["new_tokens"] == 9 == sum(len(r.out) for r in out)
    assert rep["prefix_hits"] == 2
