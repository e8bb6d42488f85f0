"""Structural parity of the ported region compiler: the slot decode and
prefill blocks captured in both packages (``capture_region``) and run
through the pass pipeline under the CPU cost model give the same graph —
node kinds, shapes, dtypes, epilogue chains, fused-GEMM shapes.  Impl names
are excluded (they are bound per target)."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import configs as RC
from repro.core import tapir as jtapir
from repro.core.passes import run_pipeline as j_run_pipeline
from repro.core.schedule import CPU_COST_MODEL as J_CPU
from repro.models.base import get_model as j_get_model
from repro_torch.configs import get_smoke
from repro_torch.core import tapir
from repro_torch.core.ir import TaskGraph, TensorType
from repro_torch.core.passes import run_pipeline
from repro_torch.core.schedule import (CPU_COST_MODEL, H100_COST_MODEL,
                                      PORTED_KERNELS)
from repro_torch.models.base import get_model

SLOTS, MAX_LEN = 3, 32


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny CPU tensors: one intra-op thread per test process, so parallel
    test workers do not oversubscribe the cores (bitwise comparisons stay
    within one process)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    jcfg = dataclasses.replace(RC.get_smoke("qwen2_5_3b"),
                               compute_dtype="float32")
    jm = j_get_model(jcfg)
    jp = jm.init_params(jax.random.PRNGKey(0))
    tcfg = dataclasses.replace(get_smoke("qwen2_5_3b"),
                               compute_dtype="float32")
    tm = get_model(tcfg, device="cpu")
    return jm, jp, tm


def _describe(g) -> list:
    """Per node in topological order: everything but ids and impl names."""
    out = []
    for nid in g.topo_order():
        n = g.nodes[nid]
        attrs = {}
        for k in ("fn", "k", "axis", "start", "limit", "n_idx", "mode",
                  "idx", "out"):
            if k in n.attrs:
                v = n.attrs[k]
                attrs[k] = v.__name__ if callable(v) else v
        epi = [(fn, len(extra), at.get("head_pos", 0), at.get("dtype"))
               for fn, extra, at in n.epilogue]
        out.append((n.op, tuple(n.ttype.shape), n.ttype.dtype,
                    tuple(sorted(attrs.items())), tuple(epi),
                    n.donates is not None))
    return out


def _decode_args_jax(jm, jp):
    import jax.numpy as jnp
    sp = jm.slot_params(jp)
    cache = jm.init_slot_cache(SLOTS, MAX_LEN)
    cos, sin = __import__("repro.models.layers", fromlist=["x"]) \
        .full_rope_table(MAX_LEN, jm.cfg.hd)
    x = jnp.zeros((SLOTS, 1, jm.cfg.d_model), jnp.float32)
    return (sp["layers"][0][1], x, cos, sin, cache["k"][0], cache["v"][0],
            cache["pos"], cache["ptab"])


def _decode_args_torch(tm):
    from repro_torch.models import layers as L
    sp = tm.compute_params()
    cache = tm.init_slot_cache(SLOTS, MAX_LEN)
    cos, sin = L.full_rope_table(MAX_LEN, tm.cfg.hd)
    x = torch.zeros((SLOTS, 1, tm.cfg.d_model))
    return (sp["layers"][0], x, cos, sin, cache["k"][0], cache["v"][0],
            cache["pos"], cache["ptab"])


def _prefill_args(S, jax_side, model, params=None):
    rng = np.random.default_rng(0)
    pos = np.arange(S).astype(np.int32)
    phys = (1 + pos // 8).astype(np.int32)
    off = (pos % 8).astype(np.int32)
    prow = np.arange(1, 5).astype(np.int32)
    x = rng.standard_normal((1, S, model.cfg.d_model)).astype(np.float32)
    if jax_side:
        import jax.numpy as jnp
        from repro.models import layers as JL
        sp = model.slot_params(params)
        cache = model.init_slot_cache(SLOTS, MAX_LEN, page_len=8)
        cos, sin = JL.full_rope_table(MAX_LEN, model.cfg.hd)
        return (sp["layers"][0][1], jnp.asarray(x), cos, sin, cache["k"][0],
                cache["v"][0], jnp.asarray(pos), jnp.asarray(phys),
                jnp.asarray(off), jnp.asarray(prow), jnp.asarray(S, jnp.int32))
    from repro_torch.models import layers as L
    sp = model.compute_params()
    cache = model.init_slot_cache(SLOTS, MAX_LEN, page_len=8)
    cos, sin = L.full_rope_table(MAX_LEN, model.cfg.hd)
    t = torch.as_tensor
    return (sp["layers"][0], t(x), cos, sin, cache["k"][0], cache["v"][0],
            t(pos), t(phys), t(off), t(prow), torch.tensor(S, dtype=torch.int32))


def _optimized_pair(jm, jp, tm, which: str):
    with jtapir.use(jtapir.TapirConfig(cost_model=J_CPU)):
        if which == "decode":
            jg = jtapir.capture_region(jm._slot_block_body,
                                       *_decode_args_jax(jm, jp))
        else:
            jg = jtapir.capture_region(jm._slot_prefill_block_body,
                                       *_prefill_args(8, True, jm, jp))
        j_run_pipeline(jg, "tapir", J_CPU, "cpu")
    with tapir.use(tapir.TapirConfig(cost_model=CPU_COST_MODEL)):
        if which == "decode":
            tg = tapir.capture_region(tm._slot_block_body,
                                      *_decode_args_torch(tm))
        else:
            tg = tapir.capture_region(tm._slot_prefill_block_body,
                                      *_prefill_args(8, False, tm))
        run_pipeline(tg, "tapir", CPU_COST_MODEL)
    return jg, tg


@pytest.mark.parametrize("which", ["decode", "prefill"])
def test_slot_block_graph_matches_reference(models, which):
    jm, jp, tm = models
    jg, tg = _optimized_pair(jm, jp, tm, which)
    assert _describe(tg) == _describe(jg)
    # the fused GEMMs of one block: QKV concat, wo (+residual), gate|up
    # concat, wd (+residual)
    mm = [(n.ttype.shape, n.attrs["k"], [e[0] for e in n.epilogue])
          for n in (tg.nodes[i] for i in tg.topo_order())
          if n.op == "matmul"]
    d, hd, H, Hkv, ff = 96, 24, 4, 2, 192
    lead = (SLOTS, 1) if which == "decode" else (1, 8)
    assert mm == [(lead + ((H + 2 * Hkv) * hd,), d, []),
                  (lead + (d,), H * hd, ["add"]),
                  (lead + (2 * ff,), d, []),
                  (lead + (d,), ff, ["add"])]


def test_every_matmul_binds_the_hopper_kernel_under_both_profiles(models):
    """The kernel is the one GEMM candidate under every profile, so the CPU
    tests run the very impl and lowering the card runs."""
    _, _, tm = models
    for cm in (CPU_COST_MODEL, H100_COST_MODEL):
        with tapir.use(tapir.TapirConfig(cost_model=cm)):
            g = tapir.capture_region(tm._slot_block_body,
                                     *_decode_args_torch(tm))
            run_pipeline(g, "tapir", cm)
        impls = [n.schedule.impl for n in g.nodes.values()
                 if n.op == "matmul"]
        assert impls == ["fused_kernel"] * 4, (cm.name, impls)


def test_unported_impls_say_so(models, monkeypatch):
    g = TaskGraph("attn")
    q = g.add_input("q", TensorType((1, 4, 4, 8), "float32"))
    k = g.add_input("k", g.nodes[q].ttype)
    v = g.add_input("v", g.nodes[q].ttype)
    a = g.add("attention", (q, k, v), TensorType((1, 4, 4, 8), "float32"),
              pdims=(0, 1, 2), causal=True, q_shape=(1, 4, 4, 8), kv_len=4,
              kv_heads=4)
    g.set_outputs([a])
    run_pipeline(g, "tapir", H100_COST_MODEL)
    costs = g.nodes[a].schedule.impl_costs
    assert costs["blockwise"] == "n/a (not ported yet)"
    assert isinstance(costs["flash_kernel"], float)
    assert g.nodes[a].schedule.impl == "flash_kernel"
    # the kernel has no bias operand: a biased node binds a composite
    gb = TaskGraph("attn_bias")
    ins = [gb.add_input(n, TensorType((1, 4, 4, 8), "float32"))
           for n in "qkv"]
    bias = gb.add_input("bias", TensorType((1, 4, 4, 4), "float32"))
    ab = gb.add("attention", tuple(ins) + (bias,),
                TensorType((1, 4, 4, 8), "float32"), pdims=(0, 1, 2),
                causal=False, q_shape=(1, 4, 4, 8), kv_len=4, kv_heads=4)
    gb.set_outputs([ab])
    run_pipeline(gb, "tapir", H100_COST_MODEL)
    assert gb.nodes[ab].schedule.impl_costs["flash_kernel"] == \
        "n/a (kernel has no bias operand)"
    assert gb.nodes[ab].schedule.impl in ("materialized_grouped", "ref")
    # conv2d binds its one lowering, im2col onto the GEMM kernel; a
    # library op none of whose impls is ported refuses at schedule time
    def conv_graph():
        g2 = TaskGraph("conv")
        x = g2.add_input("x", TensorType((1, 8, 8, 4), "float32"))
        kw = g2.add_input("kw", TensorType((3, 3, 4, 4), "float32"))
        c = g2.add("conv2d", (x, kw), TensorType((1, 8, 8, 4), "float32"),
                   pdims=(0, 1, 2, 3), k_elems=36, strides=(1, 1),
                   padding="SAME")
        g2.set_outputs([c])
        return g2, c
    g2, c = conv_graph()
    run_pipeline(g2, "tapir", H100_COST_MODEL)
    assert g2.nodes[c].schedule.impl == "im2col_gemm"
    monkeypatch.delitem(PORTED_KERNELS, "conv2d")
    with pytest.raises(NotImplementedError, match="not ported yet"):
        run_pipeline(conv_graph()[0], "tapir", H100_COST_MODEL)
    # the linear scan's kernel is ported: a scan node binds it, and the
    # plain composites keep their costs
    g3 = TaskGraph("scan")
    t = TensorType((1, 8, 2, 4), "float32")
    ins = [g3.add_input(n, t) for n in "qkvw"]
    s = g3.add("linear_scan", tuple(ins), t, pdims=(0, 2),
               rdims=(("seq", 8),), seq=8, variant="gla")
    g3.set_outputs([s])
    run_pipeline(g3, "tapir", H100_COST_MODEL)
    costs = g3.nodes[s].schedule.impl_costs
    assert g3.nodes[s].schedule.impl == "kernel"
    assert all(isinstance(costs[i], float) for i in ("kernel", "chunked",
                                                     "ref"))


def test_signature_is_stable_and_sees_the_impl(models):
    _, _, tm = models
    with tapir.use(tapir.TapirConfig(cost_model=CPU_COST_MODEL)):
        g1 = tapir.capture_region(tm._slot_block_body, *_decode_args_torch(tm))
        g2 = tapir.capture_region(tm._slot_block_body, *_decode_args_torch(tm))
    assert g1.signature() == g2.signature()
    run_pipeline(g1, "tapir", CPU_COST_MODEL)
    run_pipeline(g2, "tapir", H100_COST_MODEL)
    # both profiles bind the same impls, and tiles are not structure
    assert g1.signature() == g2.signature()
    # rebinding one GEMM's impl is a different program
    mm = next(n for n in g2.nodes.values() if n.op == "matmul")
    mm.schedule.impl = "opaque"
    assert g1.signature() != g2.signature()


def test_explain_reports_the_bound_impl_and_in_region_tracks_capture(models):
    _, _, tm = models
    seen = []

    def body(*args):
        seen.append(tapir.in_region())
        return tm._slot_block_body(*args)

    assert not tapir.in_region()
    with tapir.use(tapir.TapirConfig(cost_model=H100_COST_MODEL)):
        g = tapir.capture_region(body, *_decode_args_torch(tm))
        run_pipeline(g, "tapir", H100_COST_MODEL)
    assert seen == [True] and not tapir.in_region()
    text = tapir.explain(g)
    assert text.count("matmul float32") == 4
    assert text.count("impl=fused_kernel") == 4
    assert "argmin of 1/1 candidates" in text
