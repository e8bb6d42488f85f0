"""The port's dense forward pass (``forward``, ``loss``) and padded-cache
serving steps (``init_cache``, ``prefill``, ``decode_step``,
``make_prefill_step`` / ``make_decode_step``) against the JAX package's, and
the port's own guarantees, at the SMOKE shapes of qwen2.5-3b on the CPU.

The weights are the reference's ``init_params(PRNGKey(0))`` carried across
as numpy (``params_from_numpy``); tokens are made with numpy from a seed.
Tolerances:

* port vs reference at fp32 compute: rtol/atol 1e-4 on logits and loss
  (GEMMs, softmax and attention sum in other orders);
* prefill and decode vs the full-sequence forward: rtol/atol 3e-3, the
  reference's own tolerance (``tests/test_serving.py``);
* inside the port (regions vs per-op): bitwise.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as RC
from repro.core import tapir as jtapir
from repro.models.base import get_model as j_get_model
from repro.serve import ServeConfig as JServeConfig
from repro_torch.configs import get_smoke
from repro_torch.core import lowering, tapir
from repro_torch.core.ir import TaskGraph, TensorType
from repro_torch.core.passes import run_pipeline
from repro_torch.core.passes.cse import cse
from repro_torch.core.schedule import H100_COST_MODEL
from repro_torch.models import layers as L
from repro_torch.models.base import get_model
from repro_torch.models.convert import params_from_numpy
from repro_torch.serve import ServeConfig, make_decode_step, make_prefill_step

REF_TOL = dict(rtol=1e-4, atol=1e-4)
SERVE_TOL = dict(rtol=3e-3, atol=3e-3)
CPU = ServeConfig(target="cpu")
B, S, NEW = 2, 12, 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny CPU tensors: one intra-op thread per test process, so parallel
    test workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    """(reference model, its params, the port's model on the same weights)
    at fp32 compute."""
    jcfg = dataclasses.replace(RC.get_smoke("qwen2_5_3b"),
                               compute_dtype="float32")
    jm = j_get_model(jcfg)
    jp = jm.init_params(jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, jp)
    tcfg = dataclasses.replace(get_smoke("qwen2_5_3b"),
                               compute_dtype="float32")
    return jm, jp, params_from_numpy(tree, tcfg, device="cpu")


@pytest.fixture(scope="module")
def tokens():
    rng = np.random.default_rng(1)
    return rng.integers(1, 500, size=(B, S + NEW)).astype(np.int32)


@pytest.fixture(scope="module")
def full_logits(pair, tokens):
    """The port's full-sequence forward logits over every token."""
    with tapir.use(CPU.tapir_config()):
        return pair[2].forward({"tokens": torch.as_tensor(tokens)})


def test_forward_matches_reference(pair, tokens, full_logits):
    jm, jp, _ = pair
    want = np.asarray(jm.forward(jp, {"tokens": jnp.asarray(tokens)}))
    assert full_logits.shape == (B, S + NEW, 512)
    np.testing.assert_allclose(full_logits.numpy(), want, **REF_TOL)


@pytest.mark.parametrize("masked", [False, True])
def test_loss_matches_reference(pair, tokens, masked):
    jm, jp, tm = pair
    rng = np.random.default_rng(2)
    labels = rng.integers(0, 512, size=tokens.shape).astype(np.int32)
    batch = {"tokens": tokens, "labels": labels}
    if masked:
        batch["mask"] = (rng.random(tokens.shape) < 0.6).astype(np.float32)
    want = float(jm.loss(jp, {k: jnp.asarray(v) for k, v in batch.items()}))
    with tapir.use(CPU.tapir_config()):
        got = tm.loss({k: torch.as_tensor(v) for k, v in batch.items()})
    assert got.dtype == torch.float32 and got.ndim == 0
    np.testing.assert_allclose(float(got), want, **REF_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_region_forward_equals_per_op_bitwise(pair, tokens, dtype):
    """The reference's ``_block`` promise: one region program per block
    (fused QKV, epilogue-folded residuals) gives the per-op logits
    bitwise."""
    _, _, tm = pair
    if dtype == "bfloat16":
        tm = get_model(get_smoke("qwen2_5_3b"), device="cpu")
    batch = {"tokens": torch.as_tensor(tokens)}
    with tapir.use(tapir.TapirConfig()):
        region = tm.forward(batch)
    with tapir.use(tapir.TapirConfig(regions=False)):
        per_op = tm.forward(batch)
    assert region.dtype == getattr(torch, dtype)
    assert torch.equal(region, per_op)


def test_every_attention_node_binds_the_flash_kernel_on_h100(pair, tokens):
    """At the H100 profile the registry's argmin for every attention node
    of the forward and of the prefill is ``flash_kernel`` (CPU tensors run
    its plain version)."""
    _, _, tm = pair
    tapir.clear_cache()
    with tapir.use(tapir.TapirConfig(cost_model=H100_COST_MODEL)):
        tm.forward({"tokens": torch.as_tensor(tokens)})
        cache = tm.init_cache(B, 32)
        tm.prefill(torch.as_tensor(tokens[:, :S]), cache)
    attn = [(n.schedule.impl, n.attrs["q_shape"])
            for key, g in tapir.cached_graphs().items()
            if key[-2] == H100_COST_MODEL.name
            for n in g.nodes.values() if n.op == "attention"]
    shapes = {s for _, s in attn}
    assert (B, S + NEW, 4, 24) in shapes and (B, S, 4, 24) in shapes
    assert {impl for impl, _ in attn} == {"flash_kernel"}


def test_opaque_forward_matches_tapir(pair, tokens, full_logits):
    """The per-op control (sealed library calls, no fusion) also runs
    attention through the flash wrapper."""
    _, _, tm = pair
    with tapir.use(ServeConfig(target="cpu", mode="opaque").tapir_config()):
        got = tm.forward({"tokens": torch.as_tensor(tokens)})
    torch.testing.assert_close(got, full_logits, rtol=1e-5, atol=1e-5)


def _ref_serve(jm, jp, tokens):
    with jtapir.use(JServeConfig(target="cpu").tapir_config()):
        cache = jm.init_cache(B, S + NEW + 4)
        lg, cache = jm.prefill(jp, jnp.asarray(tokens[:, :S]), cache)
        out = [np.asarray(lg)]
        for t in range(NEW - 1):
            lg, cache = jm.decode_step(
                jp, jnp.asarray(tokens[:, S + t:S + t + 1]), cache)
            out.append(np.asarray(lg))
    return out


def _port_serve(tm, tokens):
    with tapir.use(CPU.tapir_config()):
        cache = tm.init_cache(B, S + NEW + 4)
        lg, cache = tm.prefill(torch.as_tensor(tokens[:, :S]), cache)
        out = [lg]
        for t in range(NEW - 1):
            lg, cache = tm.decode_step(
                torch.as_tensor(tokens[:, S + t:S + t + 1]), cache)
            out.append(lg)
    return out, cache


def test_prefill_and_decode_match_reference(pair, tokens):
    jm, jp, tm = pair
    want = _ref_serve(jm, jp, tokens)
    got, cache = _port_serve(tm, tokens)
    assert int(cache["pos"]) == S + NEW - 1
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.numpy(), w, **REF_TOL,
                                   err_msg=f"step {i}")


def test_prefill_and_decode_match_full_forward(pair, tokens, full_logits):
    _, _, tm = pair
    got, _ = _port_serve(tm, tokens)
    for i, g in enumerate(got):
        np.testing.assert_allclose(g.numpy(), full_logits[:, S - 1 + i],
                                   **SERVE_TOL, err_msg=f"step {i}")


@pytest.mark.parametrize("regions", [True, False])
def test_serve_steps_write_the_cache_in_place(pair, tokens, regions):
    """``make_prefill_step`` / ``make_decode_step`` update the cache's K/V
    tensors in place (their ``data_ptr`` stays; under regions each layer's
    program writes its slab itself, or the step raises, as the next test
    shows), write exactly the prompt's and the fed tokens' rows, and
    decode greedily."""
    _, _, tm = pair
    cfg = ServeConfig(target="cpu", regions=regions)
    prefill, decode = make_prefill_step(tm, cfg=cfg), make_decode_step(
        tm, cfg=cfg)
    cache = tm.init_cache(B, S + NEW)
    ptrs = (cache["k"].data_ptr(), cache["v"].data_ptr())
    logits, cache = prefill(tokens[:, :S], cache)
    assert (cache["k"].data_ptr(), cache["v"].data_ptr()) == ptrs
    assert bool((cache["k"][:, :, :S] != 0).any(-1).all())
    assert bool((cache["k"][:, :, S:] == 0).all())
    nxt, cache = decode(tokens[:, S:S + 1], cache)
    assert (cache["k"].data_ptr(), cache["v"].data_ptr()) == ptrs
    assert int(cache["pos"]) == S + 1
    assert bool((cache["v"][:, :, S] != 0).any(-1).all())
    assert bool((cache["v"][:, :, S + 1:] == 0).all())
    assert nxt.dtype == torch.int32 and nxt.shape == (B,)
    with tapir.use(cfg.tapir_config()):
        c2 = tm.init_cache(B, S + NEW)
        _, c2 = tm.prefill(torch.as_tensor(tokens[:, :S]), c2)
        lg, _ = tm.decode_step(torch.as_tensor(tokens[:, S:S + 1]), c2)
    assert torch.equal(nxt, torch.argmax(lg, -1).to(torch.int32))


def test_a_region_that_copies_its_cache_slab_raises(pair, tokens,
                                                    monkeypatch):
    """Under regions each layer's program must hand back the slab it wrote
    in place: with the donation lost (every window write goes to a copy),
    ``prefill`` refuses instead of copying the slab back."""
    _, _, tm = pair
    monkeypatch.setattr(lowering, "_donated_in_place", lambda *a: False)
    cache = tm.init_cache(B, S + NEW)
    with pytest.raises(RuntimeError, match="in place"):
        make_prefill_step(tm, cfg=CPU)(tokens[:, :S], cache)


def test_decode_argmax_takes_the_first_index_on_a_tie(pair):
    """Greedy decode breaks ties at the first index, as ``jnp.argmax``
    does: a model whose head is all zeros emits token 0."""
    _, _, tm = pair
    zero = get_model(tm.cfg, device="cpu", params={
        "embed": tm.embed.data, "ln_f": tm.ln_f.data,
        "lm_head": torch.zeros_like(tm.lm_head.data),
        "blocks": {k: v.data for k, v in tm.blocks.items()}})
    cache = zero.init_cache(B, 16)
    _, cache = make_prefill_step(zero, cfg=CPU)(
        np.ones((B, 4), np.int32), cache)
    nxt, _ = make_decode_step(zero, cfg=CPU)(np.ones((B, 1), np.int32), cache)
    assert nxt.tolist() == [0] * B


def test_serve_steps_refuse_a_mesh(pair):
    """The steps take a ``launch.mesh.Mesh`` (``tests/
    test_torch_mesh_serving.py`` runs them on one); anything else that
    claims to be a mesh is refused."""
    _, _, tm = pair
    for make in (make_prefill_step, make_decode_step):
        with pytest.raises(TypeError, match="Mesh"):
            make(tm, mesh=object())


# -- cache_write / cache_read: lax.dynamic_update_slice / dynamic_slice ----

BUF = np.arange(5 * 10 * 3, dtype=np.float32).reshape(5, 10, 3)
UPD = -np.arange(5 * 4 * 3, dtype=np.float32).reshape(5, 4, 3) - 1.0


@pytest.mark.parametrize("in_region", [False, True])
@pytest.mark.parametrize("start", [0, 3, 6, 7, 12, -2, -30])
def test_cache_write_and_read_clamp_like_lax(start, in_region):
    """As ``lax.dynamic_update_slice`` / ``lax.dynamic_slice`` do, a
    negative start wraps once and every start then clamps to
    ``[0, dim - window]``, for a python int start and for a tensor start
    (with no host sync)."""
    want_w = np.asarray(jax.lax.dynamic_update_slice(
        jnp.asarray(BUF), jnp.asarray(UPD), (0, start, 0)))
    want_r = np.asarray(jax.lax.dynamic_slice(
        jnp.asarray(want_w), (0, start, 0), (5, 4, 3)))
    for pos in (start, torch.tensor(start, dtype=torch.int32)):
        buf = torch.from_numpy(BUF.copy())

        def step(buf, upd, pos):
            new = tapir.cache_write(buf, upd, (0, pos, 0))
            return new, tapir.cache_read(new, (0, pos, 0), (5, 4, 3))

        if in_region:
            step = tapir.parallel_region(step, name="clamp_test")
        with tapir.use(CPU.tapir_config()):
            new, read = step(buf, torch.from_numpy(UPD), pos)
        np.testing.assert_array_equal(new.numpy(), want_w)
        np.testing.assert_array_equal(read.numpy(), want_r)
        # a region input donated to the write is written in place; the
        # eager write is functional and leaves ``buf`` as it was
        assert (new is buf) == in_region
        if not in_region:
            np.testing.assert_array_equal(buf.numpy(), BUF)


def test_read_before_write_sees_the_old_buffer():
    """A read ordered before a donated write of the same buffer sees the
    pre-write value."""
    @tapir.parallel_region
    def step(buf, upd, pos):
        before = tapir.cache_read(buf, (0, pos, 0), (5, 4, 3))
        new = tapir.cache_write(buf, upd, (0, pos, 0))
        return before * 1.0, new, tapir.cache_read(new, (0, pos, 0),
                                                   (5, 4, 3))

    buf = torch.from_numpy(BUF.copy())
    with tapir.use(CPU.tapir_config()):
        before, new, after = step(buf, torch.from_numpy(UPD),
                                  torch.tensor(3))
    np.testing.assert_array_equal(before.numpy(), BUF[:, 3:7])
    np.testing.assert_array_equal(after.numpy(), UPD)
    np.testing.assert_array_equal(new.numpy()[:, 3:7], UPD)


@pytest.mark.parametrize("start", ["int", "tensor"])
def test_a_write_after_a_view_read_goes_to_a_copy(start):
    """A donated write runs after every read of its buffer; it writes the
    region input in place where those reads made values of their own (a
    tensor start gathers the window), and a copy where a read is a view
    of the buffer (an int start narrows it), whose consumers must still
    see the pre-write values."""
    @tapir.parallel_region
    def step(buf, upd, pos):
        before = tapir.cache_read(buf, (0, pos, 0), (5, 4, 3))
        return before * 1.0, tapir.cache_write(buf, upd, (0, pos, 0))

    buf = torch.from_numpy(BUF.copy())
    pos = 3 if start == "int" else torch.tensor(3)
    with tapir.use(CPU.tapir_config()):
        before, new = step(buf, torch.from_numpy(UPD), pos)
    np.testing.assert_array_equal(before.numpy(), BUF[:, 3:7])
    np.testing.assert_array_equal(new.numpy()[:, 3:7], UPD)
    assert (new is buf) == (start == "tensor")


def test_cse_never_merges_writes_and_distinguishes_reads():
    """The reference's ``test_stateful_region`` check on the port's CSE."""
    g = TaskGraph("cse_alias")
    buf_t = TensorType((4, 8), "float32")
    win_t = TensorType((4, 1), "float32")
    buf = g.add_input("buf", buf_t)
    upd = g.add_input("upd", win_t)
    w1 = g.add("dynamic_update_slice", (buf, upd), buf_t, pdims=(0, 1),
               donates=buf, static_starts=(0, 3))
    w2 = g.add("dynamic_update_slice", (buf, upd), buf_t, pdims=(0, 1),
               donates=buf, static_starts=(0, 3))
    r1 = g.add("dynamic_slice", (w1,), win_t, pdims=(0, 1),
               static_starts=(0, 3), sizes=(4, 1))
    r2 = g.add("dynamic_slice", (w2,), win_t, pdims=(0, 1),
               static_starts=(0, 3), sizes=(4, 1))
    g.set_outputs([r1, r2])
    cse(g)
    assert w1 in g.nodes and w2 in g.nodes, "writes must never be CSE'd"
    assert r1 in g.nodes and r2 in g.nodes


def test_fusion_folds_an_epilogue_onto_attention():
    """An elementwise tail of an attention node folds into its epilogue
    (the reference's ``fuse_epilogues`` over ``_FUSABLE``), and the fused
    program gives the unfused values bitwise."""
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((2, 9, 4, 16), (2, 9, 2, 16), (2, 9, 2, 16)))
    res = torch.from_numpy(rng.standard_normal((2, 9, 4, 16)).astype(
        np.float32))

    def body(q, k, v, res):
        return tapir.attention(q, k, v, causal=True) * 2.0 + res

    g = tapir.capture_region(body, q, k, v, res)
    run_pipeline(g, "tapir", H100_COST_MODEL)
    (attn,) = [n for n in g.nodes.values() if n.op == "attention"]
    assert [fn for fn, _, _ in attn.epilogue] == ["mul", "add"]
    assert attn.schedule.impl == "flash_kernel"
    with tapir.use(CPU.tapir_config()):
        fused = tapir.parallel_region(body, name="attn_epi")(q, k, v, res)
    with tapir.use(dataclasses.replace(CPU.tapir_config(), regions=False)):
        unfused = body(q, k, v, res)
    assert torch.equal(fused, unfused)


def test_scan_layers_unrolls_into_a_region():
    """Under capture each layer's ``a[i]`` is an index node, so the whole
    stack lands in one region graph; eagerly it is a loop over views."""
    rng = np.random.default_rng(6)
    w = torch.from_numpy(rng.standard_normal((3, 8, 8)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((4, 8)).astype(np.float32))

    def stack(w, x):
        return tapir.scan_layers(lambda p, h: tapir.linear(h, p["w"]),
                                 {"w": w}, x)

    g = tapir.capture_region(stack, w, x)
    assert sum(n.op == "matmul" for n in g.nodes.values()) == 3
    with tapir.use(CPU.tapir_config()):
        eager = stack(w, x)
        captured = tapir.parallel_region(stack, name="stack")(w, x)
    want = x
    for i in range(3):
        want = want @ w[i]
    torch.testing.assert_close(eager, want, rtol=1e-5, atol=1e-5)
    assert torch.equal(captured, eager)


def test_arange_rope_table_is_memoized_and_exact(pair):
    """Identity-stable tables (a region binding them replays), equal to
    ``rope_table(arange(S))``; ``capture_aux`` hands out the same ones the
    forward binds."""
    a = L.arange_rope_table(40, 24)
    b = L.arange_rope_table(40, 24)
    assert a[0] is b[0] and a[1] is b[1]
    want = L.rope_table(torch.arange(40), 24)
    assert torch.equal(a[0], want[0]) and torch.equal(a[1], want[1])
    assert L.arange_rope_table(41, 24)[0] is not a[0]
    aux = pair[2].capture_aux({"tokens": torch.zeros(2, 40)})
    assert aux[0] is a[0] and aux[1] is a[1]
