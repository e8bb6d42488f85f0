"""The port's Whisper encoder-decoder (``models/whisper.py``: ``encode``,
``forward``, ``loss``, the padded cache's ``prefill(frames)`` /
``decode_step``) against the JAX package's, and the port's own
guarantees, at the SMOKE shapes of whisper-small on the CPU (2 + 2
layers, 4 heads of 16, 32 frames).

The weights are the reference's ``init_params(PRNGKey(0))`` carried across
as numpy (``params_from_numpy``); tokens and the stub frames (scale 0.1,
as the reference's serving test draws them) are made with numpy from a
seed.  Tolerances:

* port vs reference at fp32 compute: rtol/atol 1e-4 on the encoder
  output, the logits and the loss, and on prefill / decode logits (GEMMs
  and attention sum in other orders); the caches' K/V (un-normalized
  projections, entries up to ~20) within 1e-5 of each one's largest
  entry, rtol 1e-4;
* prefill and decode vs the port's own full-sequence forward: rtol/atol
  3e-3, the reference's own tolerance (``tests/test_serving.py``);
* the opaque per-op control against tapir: rtol/atol 1e-5;
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
from repro.serve import ServeConfig as JServeConfig
from repro_torch.configs import ARCH_IDS, get_config, get_smoke
from repro_torch.core import tapir
from repro_torch.core.ir import LIBRARY_OPS
from repro_torch.core.passes import run_pipeline
from repro_torch.core.schedule import H100_COST_MODEL
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import train as train_cli
from repro_torch.models import whisper as W
from repro_torch.models.base import get_model
from repro_torch.models.convert import params_from_numpy
from repro_torch.serve import ServeConfig, ServingEngine, Request

REF_TOL = dict(rtol=1e-4, atol=1e-4)
SERVE_TOL = dict(rtol=3e-3, atol=3e-3)
CPU = ServeConfig(target="cpu")
B, S, NEW = 2, 8, 3
ARCH = "whisper_small"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    """(reference model, its params, the port's model on the same weights)
    at fp32 compute."""
    jcfg = dataclasses.replace(RC.get_smoke(ARCH), compute_dtype="float32")
    jm = j_get_model(jcfg)
    jp = jm.init_params(jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, jp)
    tcfg = dataclasses.replace(get_smoke(ARCH), compute_dtype="float32")
    return jm, jp, params_from_numpy(tree, tcfg, device="cpu")


@pytest.fixture(scope="module")
def data():
    """(tokens [B, S + NEW], labels, frames [B, n_frames, d])."""
    cfg = get_smoke(ARCH)
    rng = np.random.default_rng(2)
    toks = rng.integers(1, 100, size=(B, S + NEW)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab, size=toks.shape).astype(np.int32)
    frames = (rng.normal(size=(B, cfg.n_frames, cfg.d_model)) * .1
              ).astype(np.float32)
    return toks, labels, frames


def _batch(toks, frames, labels=None):
    b = {"tokens": torch.as_tensor(toks), "frames": torch.as_tensor(frames)}
    if labels is not None:
        b["labels"] = torch.as_tensor(labels)
    return b


@pytest.fixture(scope="module")
def full_logits(pair, data):
    toks, _, frames = data
    with tapir.use(CPU.tapir_config()):
        return pair[2].forward(_batch(toks, frames))


def _port_serve(tm, toks, frames, cfg=CPU, steps=NEW):
    """Prefill on the first S tokens, then ``steps`` decode steps fed the
    next tokens: the logits of each call."""
    with tapir.use(cfg.tapir_config()):
        cache = tm.init_cache(B, S + NEW + 2)
        lg, cache = tm.prefill(torch.as_tensor(toks[:, :S]), cache,
                               frames=torch.as_tensor(frames))
        out = [lg]
        for t in range(steps):
            lg, cache = tm.decode_step(
                torch.as_tensor(toks[:, S + t:S + t + 1]), cache)
            out.append(lg)
    return out, cache


@pytest.mark.parametrize("smoke", [False, True])
def test_config_is_the_references(smoke):
    """Every field of the port's config is the reference's, the encoder's
    ``n_enc_layers`` / ``n_frames`` among them; the registry holds the
    reference's ten architectures."""
    assert ARCH_IDS == RC.ARCH_IDS
    port = get_smoke(ARCH) if smoke else get_config(ARCH)
    ref = RC.get_smoke(ARCH) if smoke else RC.get_config(ARCH)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.n_params() == ref.n_params()


def test_weights_carry_across(pair):
    jm, jp, tm = pair
    tree = tm.param_tree()
    assert set(tree) == set(jp)
    for top in ("enc", "dec"):
        assert set(tree[top]) == set(jp[top])
        for k, v in jp[top].items():
            np.testing.assert_array_equal(tree[top][k].numpy(),
                                          np.asarray(v))
    for k in W._LEAVES:
        np.testing.assert_array_equal(tree[k].numpy(), np.asarray(jp[k]))


def test_init_follows_the_reference_rule():
    """The port's own draw has the reference's shapes, zeros / ones where
    the reference puts them, and the ``small`` position tables at
    0.02 / sqrt(rows)."""
    tm = get_model(get_smoke(ARCH), device="cpu")
    tree = tm.param_tree()
    specs = W.abstract_params(get_smoke(ARCH))
    assert tree["enc"]["sa_bq"].abs().max() == 0
    assert torch.equal(tree["dec"]["ca_ln"], torch.ones_like(
        tree["dec"]["ca_ln"]))
    assert tuple(tree["dec"]["ca_wk"].shape) == specs["dec"]["ca_wk"].shape
    std = float(tree["dec_pos"].std())
    assert 0.5 * 0.02 / 128 ** .5 < std < 2 * 0.02 / 128 ** .5


def test_encode_matches_reference(pair, data):
    jm, jp, tm = pair
    _, _, frames = data
    want = np.asarray(jm.encode(jp, jnp.asarray(frames)))
    with tapir.use(CPU.tapir_config()):
        got = tm.encode(torch.as_tensor(frames))
    assert got.shape == (B, 32, 64)
    np.testing.assert_allclose(got.numpy(), want, **REF_TOL)


def test_forward_and_loss_match_reference(pair, data, full_logits):
    jm, jp, tm = pair
    toks, labels, frames = data
    jb = {"tokens": jnp.asarray(toks), "frames": jnp.asarray(frames)}
    want = np.asarray(jm.forward(jp, jb))
    want_loss = float(jm.loss(jp, dict(jb, labels=jnp.asarray(labels))))
    with tapir.use(CPU.tapir_config()):
        loss = tm.loss(_batch(toks, frames, labels))
    assert full_logits.shape == (B, S + NEW, 512)
    np.testing.assert_allclose(full_logits.numpy(), want, **REF_TOL)
    np.testing.assert_allclose(float(loss), want_loss, **REF_TOL)


def test_prefill_and_decode_match_reference(pair, data):
    """``prefill(tokens, cache, frames)`` and 3 ``decode_step``s against the
    reference's, logits within REF_TOL at every call."""
    jm, jp, tm = pair
    toks, _, frames = data
    with jtapir.use(JServeConfig(target="cpu").tapir_config()):
        cache = jm.init_cache(B, S + NEW + 2)
        lg, cache = jm.prefill(jp, jnp.asarray(toks[:, :S]), cache,
                               frames=jnp.asarray(frames))
        want = [np.asarray(lg)]
        for t in range(NEW):
            lg, cache = jm.decode_step(jp, jnp.asarray(toks[:, S + t:S + t + 1]),
                                       cache)
            want.append(np.asarray(lg))
    got, tcache = _port_serve(tm, toks, frames)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.numpy(), w, **REF_TOL,
                                   err_msg=f"call {i}")
    for k in ("k", "v", "ck", "cv"):
        want = np.asarray(cache[k])
        np.testing.assert_allclose(tcache[k].numpy(), want, rtol=1e-4,
                                   atol=1e-5 * np.abs(want).max(),
                                   err_msg=k)
    assert int(tcache["pos"]) == int(cache["pos"]) == S + NEW


def test_prefill_and_decode_match_full_forward(pair, data, full_logits):
    """The reference serving test's check on the port: prefill's logits at
    position S-1 and each decode step's at its position, within 3e-3 of
    the full-sequence forward."""
    _, _, tm = pair
    toks, _, frames = data
    got, _ = _port_serve(tm, toks, frames)
    for i, g in enumerate(got):
        torch.testing.assert_close(g, full_logits[:, S - 1 + i], **SERVE_TOL)


@pytest.mark.parametrize("regions", [True, False])
def test_serve_steps_write_the_cache_in_place(pair, data, regions):
    """Prefill writes every layer's self and cross K/V into the slabs of
    the cache tensors (their ``data_ptr`` stays; under regions
    ``keep_in_place`` raises on a copy) and advances ``pos`` in place;
    the cross K/V are the encoder output's projections; a decode step
    leaves them as they were."""
    _, _, tm = pair
    toks, _, frames = data
    cfg = ServeConfig(target="cpu", regions=regions)
    with tapir.use(cfg.tapir_config()):
        cache = tm.init_cache(B, S + NEW)
        keys = ("k", "v", "ck", "cv", "pos")
        ptrs = [cache[k].data_ptr() for k in keys]
        tm.prefill(torch.as_tensor(toks[:, :S]), cache,
                   frames=torch.as_tensor(frames))
        assert [cache[k].data_ptr() for k in keys] == ptrs
        enc = tm.encode(torch.as_tensor(frames))
        p = tm.compute_params()["dec"][1]
        want_k = (enc @ p["ca_wk"]).reshape(B, 32, 4, 16)
        torch.testing.assert_close(cache["ck"][1], want_k, rtol=1e-5,
                                   atol=1e-5)
        cross = cache["ck"].clone(), cache["cv"].clone()
        tm.decode_step(torch.as_tensor(toks[:, S:S + 1]), cache)
        assert [cache[k].data_ptr() for k in keys] == ptrs
    assert torch.equal(cache["ck"], cross[0])
    assert torch.equal(cache["cv"], cross[1])
    assert int(cache["pos"]) == S + 1
    assert bool((cache["k"][:, :, :S + 1] != 0).any())
    assert not bool((cache["k"][:, :, S + 1:] != 0).any())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_region_equals_per_op_bitwise(pair, data, dtype):
    """One region program per block gives the per-op (``regions=False``)
    logits bitwise, for the forward, the prefill and the decode steps."""
    _, _, tm = pair
    toks, _, frames = data
    if dtype == "bfloat16":
        tm = get_model(get_smoke(ARCH), device="cpu")
    batch = _batch(toks, frames)
    outs = {}
    for regions in (True, False):
        cfg = ServeConfig(target="cpu", regions=regions)
        with tapir.use(cfg.tapir_config()):
            fwd = tm.forward(batch)
        assert fwd.dtype == getattr(torch, dtype)
        outs[regions] = (fwd, _port_serve(tm, toks, frames, cfg)[0])
    assert torch.equal(outs[True][0], outs[False][0])
    assert all(torch.equal(a, b) for a, b in zip(outs[True][1],
                                                  outs[False][1]))


def test_opaque_matches_tapir(pair, data, full_logits):
    """The per-op control (sealed library calls, no fusion)."""
    _, _, tm = pair
    toks, _, frames = data
    opq = ServeConfig(target="cpu", mode="opaque")
    with tapir.use(opq.tapir_config()):
        got = tm.forward(_batch(toks, frames))
    torch.testing.assert_close(got, full_logits, rtol=1e-5, atol=1e-5)
    a, _ = _port_serve(tm, toks, frames)
    b, _ = _port_serve(tm, toks, frames, opq)
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-5)


def test_cached_block_is_one_region(pair):
    """A decode step's decoder block traces into ONE graph: the self K/V
    writes donating their slabs, the masked self-attention composite, a
    non-causal attention node over the cross slabs (one query row, every
    frame), and the block's GEMMs; at the H100 profile the attention node
    binds ``flash_kernel`` and every matmul ``fused_kernel``.  At prefill
    the same region also writes the two cross slabs."""
    _, _, tm = pair
    cfg = tm.cfg
    p = tm.compute_params()["dec"][0]
    cache = tm.init_cache(B, 16)
    x = torch.from_numpy(np.random.default_rng(3).normal(
        size=(B, 1, cfg.d_model)).astype(np.float32))
    slabs = [cache[k][0] for k in ("k", "v", "ck", "cv")]
    with tapir.use(tapir.TapirConfig(cost_model=H100_COST_MODEL)):
        g = tapir.capture_region(tm._cached_dec_block_body, p, x, None,
                                 *slabs, cache["pos"], False)
    run_pipeline(g, "tapir", H100_COST_MODEL)
    nodes = list(g.nodes.values())
    writes = [n for n in nodes if n.op == "dynamic_update_slice"]
    assert len(writes) == 2 and all(n.donates is not None for n in writes)
    attn = [n for n in nodes if n.op == "attention"]
    assert len(attn) == 1 and not attn[0].attrs["causal"]
    assert attn[0].attrs["kv_len"] == cfg.n_frames
    assert attn[0].attrs["q_shape"][1] == 1
    assert attn[0].schedule.impl == "flash_kernel"
    assert {n.schedule.impl for n in nodes if n.op == "matmul"} == {
        "fused_kernel"}
    assert sum(1 for n in nodes if n.op in LIBRARY_OPS) >= 6
    enc = torch.zeros((B, cfg.n_frames, cfg.d_model))
    xs = torch.zeros((B, 4, cfg.d_model))
    with tapir.use(tapir.TapirConfig(cost_model=H100_COST_MODEL)):
        g = tapir.capture_region(tm._cached_dec_block_body, p, xs, enc,
                                 *slabs, cache["pos"], True)
    assert sum(1 for n in g.nodes.values()
               if n.op == "dynamic_update_slice") == 4


def test_mlp_is_two_gemms_with_bias_gelu_and_bias_residual(pair):
    """After the pipeline the MLP sub-block is two GEMMs: ``wu`` with its
    bias and the tanh GELU in its epilogue, ``wd`` with its bias and the
    residual add."""
    _, _, tm = pair
    p = tm.compute_params()["dec"][0]
    x = torch.zeros((B, 5, tm.cfg.d_model))
    with tapir.use(tapir.TapirConfig(cost_model=H100_COST_MODEL)):
        g = tapir.capture_region(tm._mlp, p, x)
    run_pipeline(g, "tapir", H100_COST_MODEL)
    mms = [n for n in g.nodes.values() if n.op == "matmul"]
    assert len(mms) == 2
    chains = sorted(tuple(fn for fn, _, _ in n.epilogue) for n in mms)
    assert chains == [("add", "add"), ("add", "gelu")]


@pytest.mark.parametrize("pos", [0, 5, 126, 127, 200])
def test_decode_position_rows_clamp_as_dynamic_slice(pair, pos):
    """The decode step's position rows, gathered on the device from
    ``pos``, are ``lax.dynamic_slice_in_dim``'s rows of ``dec_pos``: the
    start clamped to ``[0, max_seq - S]``."""
    _, jp, tm = pair
    table = tm.compute_params()["dec_pos"]
    for n in (1, 3):
        got = tm._pos_rows(torch.tensor(pos, dtype=torch.int32), n, table)
        want = jax.lax.dynamic_slice_in_dim(jnp.asarray(jp["dec_pos"]),
                                            pos, n, 0)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_prefill_without_frames_raises(pair):
    """The reference's prefill fails on ``frames.astype`` without frames;
    the port says why."""
    _, _, tm = pair
    cache = tm.init_cache(B, 16)
    with pytest.raises(ValueError, match="frames"):
        tm.prefill(torch.ones((B, 4), dtype=torch.int32), cache)
    eng = ServingEngine(tm, batch=2, max_len=32, cfg=CPU, device="cpu")
    with pytest.raises(ValueError, match="frames"):
        eng.run([Request(rid=0, prompt=np.arange(1, 5, dtype=np.int32),
                         max_new=2)])


def test_launchers_refuse_whisper(capsys, tmp_path):
    """``launch/serve.py --arch whisper_small`` refuses (no request
    carries frames); ``launch/train.py`` trains it on zero frames, as the
    reference's launcher does (``tests/test_torch_encdec_vlm_train.py``
    holds its steps to the reference's)."""
    with pytest.raises(ValueError, match="frames"):
        serve_cli.main(["--arch", ARCH, "--smoke", "--device", "cpu"])
    train_cli.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                    "--steps", "1", "--batch", "2", "--seq", "8",
                    "--ckpt-dir", str(tmp_path)])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["steps"] == 1 and np.isfinite(line["first_loss"])
