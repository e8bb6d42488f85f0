"""The port's InternVL2 VLM (``models/vlm.py``: the dense backbone behind an
image prefix) against the JAX package's at the SMOKE shapes of
internvl2-76b on the CPU (2 layers, 4 / 2 heads of 32, 8 image tokens),
and the dense family's non-gated MLP branch (``gated_mlp=False``, which
Whisper's config also sets) against the reference's ``DenseLM``.

The weights are the reference's ``init_params(PRNGKey(0))`` carried across
as numpy (``params_from_numpy``); tokens and the stub image embeddings
(scale 0.1, as the reference's serving test draws them) are made with
numpy from a seed.  Tolerances:

* port vs reference at fp32 compute: rtol/atol 1e-4 on logits and loss
  (forward, the image prefill and the decode steps after it);
* the image prefill vs the port's own forward: rtol/atol 3e-3, the
  reference's own tolerance (``tests/test_serving.py``);
* the slot engine's greedy tokens: equal to the reference engine's;
* inside the port (regions vs per-op): bitwise.
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
from repro.models.base import get_model as j_get_model
from repro.serve import Request as JRequest
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServingEngine as JServingEngine
from repro_torch.configs import get_config, get_smoke
from repro_torch.core import tapir
from repro_torch.core.passes import run_pipeline
from repro_torch.core.schedule import H100_COST_MODEL
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import train as train_cli
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.vlm import InternVLM
from repro_torch.serve import Request, ServeConfig, ServingEngine

REF_TOL = dict(rtol=1e-4, atol=1e-4)
SERVE_TOL = dict(rtol=3e-3, atol=3e-3)
CPU = ServeConfig(target="cpu")
B, S, NEW = 2, 8, 3
ARCH = "internvl2_76b"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(jcfg, tcfg):
    jm = j_get_model(jcfg)
    jp = jm.init_params(jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, jp)
    return jm, jp, params_from_numpy(tree, tcfg, device="cpu")


@pytest.fixture(scope="module")
def pair():
    """(reference model, its params, the port's model on the same weights)
    at fp32 compute."""
    return _pair(
        dataclasses.replace(RC.get_smoke(ARCH), compute_dtype="float32"),
        dataclasses.replace(get_smoke(ARCH), compute_dtype="float32"))


@pytest.fixture(scope="module")
def data():
    """(tokens [B, S + NEW], labels, image embeddings [B, n_img, d])."""
    cfg = get_smoke(ARCH)
    rng = np.random.default_rng(3)
    toks = rng.integers(1, 100, size=(B, S + NEW)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab, size=toks.shape).astype(np.int32)
    img = (rng.normal(size=(B, cfg.n_img_tokens, cfg.d_model)) * .1
           ).astype(np.float32)
    return toks, labels, img


def _batch(toks, img, labels=None):
    b = {"tokens": torch.as_tensor(toks),
         "image_embeds": torch.as_tensor(img)}
    if labels is not None:
        b["labels"] = torch.as_tensor(labels)
    return b


@pytest.mark.parametrize("smoke", [False, True])
def test_config_is_the_references(smoke):
    port = get_smoke(ARCH) if smoke else get_config(ARCH)
    ref = RC.get_smoke(ARCH) if smoke else RC.get_config(ARCH)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.n_params() == ref.n_params()


def test_forward_with_image_and_loss_match_reference(pair, data):
    """Text positions' logits after the image prefix, and the loss over
    them."""
    jm, jp, tm = pair
    toks, labels, img = data
    assert isinstance(tm, InternVLM)
    jb = {"tokens": jnp.asarray(toks), "image_embeds": jnp.asarray(img)}
    want = np.asarray(jm.forward(jp, jb))
    want_loss = float(jm.loss(jp, dict(jb, labels=jnp.asarray(labels))))
    with tapir.use(CPU.tapir_config()):
        got = tm.forward(_batch(toks, img))
        loss = tm.loss(_batch(toks, img, labels))
    assert got.shape == (B, S + NEW, get_smoke(ARCH).vocab)
    np.testing.assert_allclose(got.numpy(), want, **REF_TOL)
    np.testing.assert_allclose(float(loss), want_loss, **REF_TOL)


def _ref_serve(jm, jp, toks, img):
    with jtapir.use(JServeConfig(target="cpu").tapir_config()):
        cache = jm.init_cache(B, img.shape[1] + S + NEW + 4)
        lg, cache = jm.prefill(jp, jnp.asarray(toks[:, :S]), cache,
                               image_embeds=jnp.asarray(img))
        out = [np.asarray(lg)]
        for t in range(NEW):
            lg, cache = jm.decode_step(
                jp, jnp.asarray(toks[:, S + t:S + t + 1]), cache)
            out.append(np.asarray(lg))
    return out


def _port_serve(tm, toks, img, cfg=CPU):
    with tapir.use(cfg.tapir_config()):
        cache = tm.init_cache(B, img.shape[1] + S + NEW + 4)
        ptrs = (cache["k"].data_ptr(), cache["v"].data_ptr())
        lg, cache = tm.prefill(torch.as_tensor(toks[:, :S]), cache,
                               image_embeds=torch.as_tensor(img))
        assert int(cache["pos"]) == img.shape[1] + S
        out = [lg]
        for t in range(NEW):
            lg, cache = tm.decode_step(
                torch.as_tensor(toks[:, S + t:S + t + 1]), cache)
            out.append(lg)
        assert (cache["k"].data_ptr(), cache["v"].data_ptr()) == ptrs
    return out


def test_image_prefill_and_decode_match_reference(pair, data):
    """``prefill(tokens, cache, image_embeds)`` over ``[image; prompt]``
    and 3 decode steps after it, against the reference's, logits within
    REF_TOL at every call; the cache is written in place."""
    jm, jp, tm = pair
    toks, _, img = data
    want = _ref_serve(jm, jp, toks, img)
    got = _port_serve(tm, toks, img)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.numpy(), w, **REF_TOL,
                                   err_msg=f"call {i}")


def test_image_prefill_and_decode_match_full_forward(pair, data):
    """The reference serving test's check, and the decode steps after it:
    each call's logits within 3e-3 of the forward's at its position."""
    _, _, tm = pair
    toks, _, img = data
    with tapir.use(CPU.tapir_config()):
        full = tm.forward(_batch(toks, img))
    for i, g in enumerate(_port_serve(tm, toks, img)):
        torch.testing.assert_close(g, full[:, S - 1 + i], **SERVE_TOL)


def test_text_prefill_is_the_dense_familys(pair, data):
    """Without an image the prefill is the dense family's, against the
    reference's text prefill."""
    jm, jp, tm = pair
    toks, _, _ = data
    with jtapir.use(JServeConfig(target="cpu").tapir_config()):
        want, _ = jm.prefill(jp, jnp.asarray(toks), jm.init_cache(B, 16))
    with tapir.use(CPU.tapir_config()):
        got, cache = tm.prefill(torch.as_tensor(toks), tm.init_cache(B, 16))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **REF_TOL)
    assert int(cache["pos"]) == S + NEW


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_region_equals_per_op_bitwise(pair, data, dtype):
    """The forward with the image and the image prefill + decode steps:
    regions = per-op, bitwise."""
    _, _, tm = pair
    toks, _, img = data
    if dtype == "bfloat16":
        from repro_torch.models.base import get_model
        tm = get_model(get_smoke(ARCH), device="cpu")
    outs = {}
    for regions in (True, False):
        cfg = ServeConfig(target="cpu", regions=regions)
        with tapir.use(cfg.tapir_config()):
            fwd = tm.forward(_batch(toks, img))
        assert fwd.dtype == getattr(torch, dtype)
        outs[regions] = [fwd] + _port_serve(tm, toks, img, cfg)
    assert all(torch.equal(a, b) for a, b in zip(outs[True], outs[False]))


def test_slot_engine_text_tokens_match_reference_engine(pair):
    """Text-only continuous batching (2 slots, 4 requests, 2 sharing a
    16-token prefix, page_len 8): the reference engine's greedy tokens per
    request and its scheduling counts."""
    jm, jp, tm = pair
    rng = np.random.default_rng(9)
    vocab = get_smoke(ARCH).vocab
    prefix = rng.integers(1, vocab, 16).astype(np.int32)
    prompts = [rng.integers(1, vocab, n).astype(np.int32) for n in (6, 3)]
    prompts += [np.concatenate([prefix, rng.integers(1, vocab, n)
                                .astype(np.int32)]) for n in (2, 5)]
    news = [5, 2, 4, 3]
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
    for key in ("tokens", "decode_steps", "admitted", "prefix_hits"):
        assert te.last_stats[key] == je.last_stats[key], key


def test_non_gated_dense_lm_matches_reference():
    """``DenseLM`` with the non-gated MLP (``wu`` with its activation, then
    ``wd``; no ``wg`` leaf), the reference's branch, forward and padded
    prefill + one decode step at fp32 compute; after the pipeline the MLP
    is two GEMMs, the activation in ``wu``'s epilogue."""
    base = RC.get_smoke("qwen2_5_3b")
    jcfg = dataclasses.replace(base, gated_mlp=False, act="gelu",
                               compute_dtype="float32")
    tcfg = dataclasses.replace(get_smoke("qwen2_5_3b"), gated_mlp=False,
                               act="gelu", compute_dtype="float32")
    jm, jp, tm = _pair(jcfg, tcfg)
    assert "wg" not in tm.blocks and set(tm.blocks) == set(jp["blocks"])
    toks = np.random.default_rng(5).integers(1, 500, (B, 10)).astype(
        np.int32)
    want = np.asarray(jm.forward(jp, {"tokens": jnp.asarray(toks)}))
    with tapir.use(CPU.tapir_config()):
        got = tm.forward({"tokens": torch.as_tensor(toks)})
        cache = tm.init_cache(B, 16)
        lg, cache = tm.prefill(torch.as_tensor(toks[:, :9]), cache)
        lg2, _ = tm.decode_step(torch.as_tensor(toks[:, 9:]), cache)
    np.testing.assert_allclose(got.numpy(), want, **REF_TOL)
    torch.testing.assert_close(lg, got[:, 8], **SERVE_TOL)
    torch.testing.assert_close(lg2, got[:, 9], **SERVE_TOL)
    p = {k: v[0] for k, v in tm.blocks.items()}
    x = torch.zeros((B, 5, tcfg.d_model))
    with tapir.use(tapir.TapirConfig(cost_model=H100_COST_MODEL)):
        g = tapir.capture_region(tm._mlp, p, x)
    run_pipeline(g, "tapir", H100_COST_MODEL)
    chains = sorted(tuple(fn for fn, _, _ in n.epilogue)
                    for n in g.nodes.values() if n.op == "matmul")
    assert chains == [(), ("gelu",)]


def test_launchers(capsys, tmp_path):
    """``launch/serve.py --arch internvl2_76b`` serves text-only slots, as
    the reference's launcher does; ``launch/train.py`` trains the family on
    zero image embeddings, as the reference's does
    (``tests/test_torch_encdec_vlm_train.py`` holds its steps to the
    reference's)."""
    out = serve_cli.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                          "--requests", "3", "--batch", "2",
                          "--prompt-len", "20", "--prefix-len", "16",
                          "--max-new", "3", "--max-len", "64"])
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rep["requests"] == 3 and rep["new_tokens"] == 9 == sum(
        len(r.out) for r in out)
    train_cli.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                    "--steps", "1", "--batch", "2", "--seq", "8",
                    "--ckpt-dir", str(tmp_path)])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["steps"] == 1 and np.isfinite(line["first_loss"])
