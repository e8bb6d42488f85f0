"""The three remaining dense configs — ChatGLM3-6B (half RoPE, QKV bias, 2
KV heads), Command R+ 104B (no QKV bias) and Qwen1.5-110B — on the port,
at their SMOKE shapes on the CPU, against the JAX package's.

The weights are the reference's ``init_params(PRNGKey(0))`` carried across
as numpy (``params_from_numpy``, QKV biases included); tokens are made
with numpy from a seed.  Tolerances are ``tests/test_torch_forward.py``'s:
port vs reference at fp32 compute rtol/atol 1e-4 on logits and loss; the
greedy tokens of padded prefill + decode and of slot serving equal the
reference engine's exactly.
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
from repro.models import layers as JL
from repro.models.base import get_model as j_get_model
from repro.serve import Request as JRequest
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServingEngine as JServingEngine
from repro_torch.configs import ARCH_IDS, get_config, get_smoke
from repro_torch.core import tapir
from repro_torch.launch import serve as serve_cli
from repro_torch.models import layers as L
from repro_torch.models.convert import params_from_numpy
from repro_torch.serve import Request, ServeConfig, ServingEngine

ARCHS = ["chatglm3_6b", "command_r_plus_104b", "qwen1_5_110b"]
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
    """Every field the port's ``ModelConfig`` has is the reference's (its
    MoE / encoder fields wait for their families); the rest are at their
    defaults there."""
    assert arch in ARCH_IDS
    for port, ref in ((get_config(arch), RC.get_config(arch)),
                      (get_smoke(arch), RC.get_smoke(arch))):
        mine = dataclasses.asdict(port)
        assert mine == {k: getattr(ref, k) for k in mine}
        for f in dataclasses.fields(ref):
            if f.name not in mine:
                assert getattr(ref, f.name) == f.default, f.name


def test_weights_carry_across_with_the_qkv_biases(pair):
    arch, jm, jp, tm = pair
    np.testing.assert_array_equal(tm.embed.numpy(), np.asarray(jp["embed"]))
    for k, v in jp["blocks"].items():
        np.testing.assert_array_equal(tm.blocks[k].numpy(), np.asarray(v))
    assert ("bq" in tm.blocks) == get_smoke(arch).qkv_bias


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
    """The padded cache's prefill and greedy decode: logits within REF_TOL
    of the reference's at every step, and the same greedy tokens."""
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


def test_slot_serving_tokens_match_reference_engine(pair):
    """Continuous batching over 2 slots, 5 requests of which 3 share a
    16-token prefix (page_len 8): the reference engine's greedy tokens per
    request, and its scheduling counts."""
    arch, jm, jp, tm = pair
    rng = np.random.default_rng(9)
    vocab = get_smoke(arch).vocab
    prefix = rng.integers(1, vocab, 16).astype(np.int32)
    prompts = [rng.integers(1, vocab, n).astype(np.int32) for n in (6, 3)]
    prompts += [np.concatenate([prefix, rng.integers(1, vocab, n)
                                .astype(np.int32)]) for n in (2, 5, 1)]
    news = [7, 2, 5, 9, 3]
    kw = dict(batch=2, max_len=32)
    je = JServingEngine(jm, jp, cfg=JServeConfig(target="cpu", page_len=8),
                        **kw)
    jout = je.run([JRequest(rid=i, prompt=p.copy(), max_new=m)
                   for i, (p, m) in enumerate(zip(prompts, news))])
    te = ServingEngine(tm, cfg=ServeConfig(target="cpu", page_len=8),
                       device="cpu", **kw)
    tout = te.run([Request(rid=i, prompt=p.copy(), max_new=m)
                   for i, (p, m) in enumerate(zip(prompts, news))])
    assert [r.out for r in tout] == [r.out for r in jout]
    assert all(r.done for r in tout)
    for key in ("tokens", "decode_steps", "admitted", "prefix_hits",
                "prefix_tokens_saved"):
        assert te.last_stats[key] == je.last_stats[key], key
    assert te.last_stats["prefix_hits"] == 2


@pytest.mark.parametrize("fraction", [0.5, 1.0])
def test_half_rope_matches_reference(fraction):
    """ChatGLM's 2d/half RoPE: only the first half of each head's dims
    rotates (``fraction`` 0.5), against the reference's ``apply_rope`` on
    the same inputs, with the tables the padded cache's decode gathers
    (``full_rope_table``) and the forward's (``arange_rope_table``)."""
    hd = get_smoke("chatglm3_6b").hd
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 11, 4, hd)).astype(np.float32)
    jcos, jsin = JL.arange_rope_table(11, hd, fraction=fraction)
    want = np.asarray(JL.apply_rope(jnp.asarray(x), jcos, jsin, fraction))
    cos, sin = L.arange_rope_table(11, hd, fraction=fraction)
    got = L.apply_rope(torch.from_numpy(x), cos, sin, fraction)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    rot = int(hd * fraction) // 2 * 2
    np.testing.assert_array_equal(got.numpy()[..., rot:], x[..., rot:])
    fcos, fsin = L.full_rope_table(40, hd, fraction=fraction)
    jfcos, _ = JL.full_rope_table(40, hd, fraction=fraction)
    assert tuple(fcos.shape) == tuple(np.asarray(jfcos).shape)
    np.testing.assert_allclose(fcos[:11].numpy(), np.asarray(jcos),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(fsin[:11].numpy(), np.asarray(jsin),
                               rtol=1e-6, atol=1e-6)


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
