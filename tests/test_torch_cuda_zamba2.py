"""Zamba2 on the card at full width cut to 2 Mamba2 layers and one
application of the shared block (``n_layers=2``, ``shared_attn_every=2``;
d_model 3584, 112 SSD heads of 64 x 64 state, 32 attention heads of 112,
vocab 32000, the head tied to the embedding): the card against the CPU,
prefill and decode against the forward, the graphed decode step against
the eager walk, the state written in place, the padded-wave engine's
guarantees; the GLA scan's carried state split on a chunk boundary; the
tied head read in place, in the forward and in its two gradient
products; a train step, the captured one against the per-op one and
remat none against full, bitwise.

The 2 layers are drawn as the 81-layer model draws its layers: the
reference's init divides a stacked leaf's normal draw by the square root
of its leading dim, the layer count, so drawn at ``n_layers=2`` the
in-projection's std would be 1/sqrt(2) where the served model's is
1/sqrt(81), dt would be ~N(0, 42^2), and decays would underflow to 0 in
fp32, where the factored chunk scan is NaN in the port and in the
reference alike (ROADMAP queue 3;
``tests/test_torch_zamba2.py::test_factored_scan_is_nan_where_a_decay_underflows``).
The weights are otherwise random from seed 0.

Tolerances: the card against the CPU in fp32, max |card - cpu| within
1e-3 of the logits' largest (sums of up to 14336 terms in other orders,
through 2 layers); prefill and decode against the forward in fp32,
rtol/atol 3e-3 (the reference's serving tolerance); everything else
bitwise.  Needs an NVIDIA card; run with
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_zamba2.py``.
"""
import dataclasses
import math

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core import tapir
from repro_torch.kernels.fused_matmul import kernel as fm_kernel
from repro_torch.kernels.fused_matmul import ops as fm_ops
from repro_torch.kernels.fused_matmul import ref as fm_ref
from repro_torch.kernels.linear_scan import ops as ls_ops
from repro_torch.models import mamba as M
from repro_torch.models.base import get_model, materialize
from repro_torch.serve import Request, ServeConfig, ServingEngine

pytestmark = pytest.mark.cuda

GPU = ServeConfig(target="gpu")
#: the tied head's gradients: the largest error over the plain result's
#: largest (``chip_smoke.py``'s LS_RTOL); dX's entries spread by a few
#: hundredths, so an absolute 0.1 would pass a product short of a quarter
#: of its contraction
GEMM_RTOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
STEPS = 20
PROMPT = 48


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    tapir.clear_cache()
    yield torch.device("cuda")
    tapir.clear_cache()


def _params(cfg, full_layers: int, device):
    """A tree for ``cfg`` drawn by the reference's rule as the
    ``full_layers``-layer model draws it (see the module docstring)."""
    gen = torch.Generator(device=device).manual_seed(0)
    specs = M.abstract_params(cfg)
    f = math.sqrt(cfg.n_layers / full_layers)
    blocks = {}
    for k in sorted(specs["blocks"]):
        s = specs["blocks"][k]
        if s.init not in ("zeros", "ones"):
            s = dataclasses.replace(s, scale=s.scale * f)
        blocks[k] = materialize(s, gen, device)
    return {"embed": materialize(specs["embed"], gen, device),
            "blocks": blocks,
            "ln_f": materialize(specs["ln_f"], gen, device),
            "shared": {k: materialize(specs["shared"][k], gen, device)
                       for k in sorted(specs["shared"])}}


def _model(dtype: str = "bfloat16", device="cuda", params=None):
    full = get_config("zamba2_7b")
    cfg = dataclasses.replace(full, n_layers=2, shared_attn_every=2,
                              compute_dtype=dtype)
    if params is None:
        params = _params(cfg, full.n_layers, device)
    return get_model(cfg, device=device, params=params)


def _tokens(vocab: int, b: int, s: int, device="cuda"):
    rng = np.random.default_rng(0)
    return torch.as_tensor(rng.integers(1, vocab, (b, s)), dtype=torch.int32,
                           device=device)


def _serve(model, toks, prompt: int, steps: int, cfg=GPU):
    """Logits of a prefill of ``prompt`` tokens and ``steps`` decode steps
    fed the next tokens of ``toks``, and the cache."""
    with tapir.use(cfg.tapir_config()):
        cache = model.init_cache(toks.shape[0], prompt + steps + 8)
        lg, cache = model.prefill(toks[:, :prompt], cache)
        out = [lg]
        for t in range(steps):
            lg, cache = model.decode_step(
                toks[:, prompt + t:prompt + t + 1].contiguous(), cache)
            out.append(lg)
    return out, cache


def test_card_matches_cpu_in_fp32(cuda):
    card = _model("float32")
    cpu = _model("float32", device="cpu", params={
        k: ({kk: vv.cpu() for kk, vv in v.items()} if isinstance(v, dict)
            else v.cpu()) for k, v in card.param_tree().items()})
    toks = _tokens(card.cfg.vocab, 2, 40)
    with tapir.use(GPU.tapir_config()):
        f_card = card.forward({"tokens": toks}).cpu()
    with tapir.use(ServeConfig(target="cpu").tapir_config()):
        f_cpu = cpu.forward({"tokens": toks.cpu()})
    assert torch.isfinite(f_card).all()
    assert (f_card - f_cpu).abs().max() <= 1e-3 * f_cpu.abs().max()
    s_card, _ = _serve(card, toks, 32, 4)
    s_cpu, _ = _serve(cpu, toks.cpu(), 32, 4,
                      cfg=ServeConfig(target="cpu"))
    for i, (a, b) in enumerate(zip(s_card, s_cpu)):
        assert (a.cpu() - b).abs().max() <= 1e-3 * b.abs().max(), i


def test_prefill_and_decode_match_the_forward(cuda):
    model = _model("float32")
    toks = _tokens(model.cfg.vocab, 2, 40)
    with tapir.use(GPU.tapir_config()):
        full = model.forward({"tokens": toks})
    got, cache = _serve(model, toks, 32, 7)
    for i, g in enumerate(got):
        torch.testing.assert_close(g, full[:, 31 + i], rtol=3e-3, atol=3e-3,
                                   msg=f"step {i}")
    assert int(cache["pos"]) == 39


def _decode(model, toks):
    """(logits of STEPS decode steps after a prefill, graph captures and
    replays per step, launches by shape of the steps)."""
    out, captures, replays = [], [], []
    with tapir.use(GPU.tapir_config()):
        cache = model.init_cache(4, PROMPT + STEPS + 8)
        keys = ("conv", "ssm", "shared_k", "shared_v", "pos")
        ptrs = [cache[k].data_ptr() for k in keys]
        _, cache = model.prefill(toks[:, :PROMPT], cache)
        fm_ops.reset_counts()
        ls_ops.reset_counts()
        for t in range(STEPS):
            before = tapir.cache_stats()
            lg, cache = model.decode_step(
                toks[:, PROMPT + t:PROMPT + t + 1].contiguous(), cache)
            after = tapir.cache_stats()
            captures.append(after["graph_captures"] - before["graph_captures"])
            replays.append(after["graph_replays"] - before["graph_replays"])
            out.append(lg)
        assert [cache[k].data_ptr() for k in keys] == ptrs
    torch.cuda.synchronize()
    counts = dict(fm_ops.launches_by_shape)
    counts.update(ls_ops.launches_by_shape)
    return out, captures, replays, counts


def test_graphed_decode_equals_the_eager_walk(cuda, monkeypatch):
    """Every Mamba2 block of a decode step replays one CUDA graph from the
    third step on (the shared block and the head are device-bound and run
    eagerly), the state stays in its buffers, and the logits equal the
    eager walk's bitwise, with the same launches."""
    model = _model()
    toks = _tokens(model.cfg.vocab, 4, PROMPT + STEPS)
    got, captures, replays, counts = _decode(model, toks)
    rules = tapir.replay_rules()
    assert rules["mamba_stateful_block"] == {True}
    graphed = sum(captures[:2])
    assert graphed >= model.cfg.n_layers and sum(captures[2:]) == 0
    assert replays[2:] == [graphed] * (STEPS - 2)
    assert all(k[6] == "gla+state" for k in counts if len(k) == 8)
    monkeypatch.setattr(tapir, "dispatch_bound", lambda g, cm: False)
    tapir.clear_cache()
    want, captures, _, eager_counts = _decode(model, toks)
    assert sum(captures) == 0 and tapir.cache_stats()["graphs"] == 0
    for i, (a, b) in enumerate(zip(got, want)):
        assert torch.equal(a, b), f"step {i}"
    assert counts == eager_counts


def test_padded_waves_keep_their_guarantees_on_the_card(cuda):
    """``run`` equals ``run_wave`` and the per-op walk, request by request,
    with graphs in play."""
    model = _model()
    rng = np.random.default_rng(1)
    reqs = [Request(rid=i, prompt=rng.integers(1, model.cfg.vocab, n)
                    .astype(np.int32), max_new=6)
            for i, n in enumerate([20, 41, 33, 12, 27])]

    def serve(wave=False, **kw):
        eng = ServingEngine(model, batch=4, max_len=64,
                            cfg=ServeConfig(target="gpu", **kw),
                            device="cuda")
        fresh = [dataclasses.replace(r, out=[]) for r in reqs]
        out = eng.run_wave(fresh) if wave else eng.run(fresh)
        return [r.out for r in out]

    run = serve()
    assert all(len(o) == 6 for o in run)
    assert serve(wave=True) == run
    assert serve(regions=False) == run
    assert tapir.cache_stats()["graphs"] == 0


@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32])
def test_gla_state_split_on_a_chunk_boundary_is_one_call(cuda, dt):
    """The GLA scan at Zamba2's heads (112 of 64 x 64, q a stride-0 view
    over the heads as ``_ssd_gates`` makes it) with a carried state: two
    calls split on a chunk boundary give one call's rows and final carry
    bitwise."""
    g = torch.Generator(device="cuda").manual_seed(3)
    b, s, h, n = 2, 96, 112, 64
    c = torch.randn(b, s, n, generator=g, device="cuda")
    q = c[:, :, None].expand(b, s, h, n).to(dt)
    k = torch.randn(b, s, h, n, generator=g, device="cuda").to(dt)
    v = torch.randn(b, s, h, n, generator=g, device="cuda").to(dt)
    sp = torch.rand(b, s, h, generator=g, device="cuda") * 2.0
    w = torch.exp(-sp)[..., None].expand(b, s, h, n)
    s0 = torch.randn(b, h, n, n, generator=g, device="cuda")
    whole, st = ls_ops.linear_scan(q, k, v, w, init_state=s0,
                                   return_state=True)
    cut = 48                      # three chunks of SAFE_CHUNK
    o1, st1 = ls_ops.linear_scan(q[:, :cut], k[:, :cut], v[:, :cut],
                                 w[:, :cut], init_state=s0,
                                 return_state=True)
    o2, st2 = ls_ops.linear_scan(q[:, cut:], k[:, cut:], v[:, cut:],
                                 w[:, cut:], init_state=st1,
                                 return_state=True)
    assert torch.equal(torch.cat([o1, o2], dim=1), whole)
    assert torch.equal(st2, st)


@pytest.mark.parametrize("chain", ["bare", "add+gelu", "residual"])
@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m", [1, 4, 300])
def test_tied_head_reads_embed_transposed_in_place(cuda, dt, m, chain,
                                                   monkeypatch):
    """``x @ embed.T`` launches the K-major layout on ``embed`` itself
    (no copy of the vocabulary matrix) and gives the bits of the product
    with ``embed.T`` copied contiguous: bare, and with an epilogue chain
    (a row bias then gelu; an ``[m, n]`` residual add), since the wrapper
    takes any transposed contiguous ``w`` this way, not only the head."""
    g = torch.Generator(device="cuda").manual_seed(4)
    e = (torch.randn(32000, 3584, generator=g, device="cuda") / 60).to(dt)
    x = torch.randn(m, 3584, generator=g, device="cuda").to(dt)
    epi = None
    if chain == "add+gelu":
        row = torch.randn(32000, generator=g, device="cuda")
        epi = [("add", [row], {"dtype": "float32"}), ("gelu", [], {})]
    elif chain == "residual":
        res = torch.randn(m, 32000, generator=g, device="cuda").to(dt)
        epi = [("add", [res], {})]
    seen = []
    launch = fm_kernel.launch

    def spy(xx, ww, *a, **kw):
        seen.append((ww.data_ptr(), kw.get("tb", False)))
        return launch(xx, ww, *a, **kw)

    monkeypatch.setattr(fm_kernel, "launch", spy)
    got = fm_ops.fused_matmul(x, e.T, epilogue=epi)
    want = fm_ops.fused_matmul(x, e.T.contiguous(), epilogue=epi)
    assert seen[0] == (e.data_ptr(), True) and seen[1][1] is False
    assert torch.equal(got, want)


@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m", [4, 4096])
def test_tied_head_gradients_match_plain(cuda, dt, m, monkeypatch):
    """The tied head's two gradient products, as ``FusedMatmulFn``'s
    backward runs them for ``w = embed.T``: dX = dY embed reads ``embed``
    in place in the forward's layout (no copy of the vocabulary matrix),
    with the bits of the product on ``embed.T`` copied contiguous; dW =
    X^T dY ``[3584, 32000]``.  Each against its plain version within
    GEMM_RTOL of the plain result's largest, finite."""
    g = torch.Generator(device="cuda").manual_seed(5)
    e = (torch.randn(32000, 3584, generator=g, device="cuda") / 60).to(dt)
    x = torch.randn(m, 3584, generator=g, device="cuda").to(dt)
    dy = (torch.randn(m, 32000, generator=g, device="cuda") / 100).to(dt)
    seen = []
    launch = fm_kernel.launch

    def spy(a, b, *args, **kw):
        seen.append((b.data_ptr(), kw.get("ta", False), kw.get("tb", False)))
        return launch(a, b, *args, **kw)

    monkeypatch.setattr(fm_kernel, "launch", spy)
    dx = fm_ops.matmul_dx(dy, e.T)
    assert seen[-1] == (e.data_ptr(), False, False)
    dx_copy = fm_ops.matmul_dx(dy, e.T.contiguous())
    assert seen[-1][2] is True
    dw = fm_ops.matmul_dw(x, dy)
    assert dx.shape == (m, 3584) and dw.shape == (3584, 32000)
    for got, want in ((dx, fm_ref.matmul_dx_ref(dy, e.T)),
                      (dw, fm_ref.matmul_dw_ref(x, dy))):
        assert bool(torch.isfinite(got).all())
        err = float((got.float() - want.float()).abs().max())
        top = float(want.float().abs().max())
        assert err <= GEMM_RTOL[dt] * top, (err, top)
    assert torch.equal(dx, dx_copy)


def _train(kind: str, dtype: str, steps: int, remat: str = "full"):
    """``steps`` train steps of the 2-layer model on 2 x 256 tokens of
    ``TokenPipeline``: the per-op step (``make_train_step``, ``remat``) or
    the captured one (``make_region_train_step``, policy auto).  Returns
    (losses, state)."""
    from repro_torch.data import DataConfig, TokenPipeline, to_device
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import (TrainConfig, init_state,
                                   make_region_train_step, make_train_step)
    tapir.clear_cache()
    model = _model(dtype)
    opt = AdamWConfig(lr=1e-3, total_steps=steps, warmup_steps=1)
    if kind == "per_op":
        step = make_train_step(model, opt, TrainConfig(target="gpu",
                                                       remat=remat))
    else:
        step = make_region_train_step(model, opt, TrainConfig(
            target="gpu", remat="auto"))
    pipe = TokenPipeline(DataConfig(seq_len=256, global_batch=2,
                                    vocab=model.cfg.vocab))
    state = init_state(model, opt)
    losses = []
    for s in range(steps):
        state, m = step(state, to_device(pipe.batch_at(s), "cuda"))
        losses.append(m["loss"].clone())
    return losses, state


def _state_leaves(state):
    from repro_torch.optim import tree_leaves
    return tree_leaves(state["params"]) + tree_leaves(state["opt"])


def test_captured_train_step_equals_per_op_bitwise(cuda):
    """fp32 compute: the captured step gives the per-op step's loss at
    every step and its params, moments and step counter after 2 steps,
    bit for bit (the GLA scan's backward, flash's at head dim 112, the
    tied head's two gradients and the shared block's two gradient sums
    on the card)."""
    lo, so = _train("per_op", "float32", 2)
    lc, sc = _train("captured", "float32", 2)
    assert all(torch.equal(a, b) for a, b in zip(lo, lc))
    assert all(torch.isfinite(x).all() for x in lo)
    assert all(torch.equal(a, b) for a, b in zip(_state_leaves(so),
                                                 _state_leaves(sc)))


def test_train_remat_none_equals_full_bitwise(cuda):
    """bf16 compute, the per-op step: remat none and full give the same
    losses and state after 2 steps, bit for bit (the recomputed layers'
    casts, convs and scans included)."""
    ln, sn = _train("per_op", "bfloat16", 2, remat="none")
    lf, sf = _train("per_op", "bfloat16", 2, remat="full")
    assert all(torch.equal(a, b) for a, b in zip(ln, lf))
    assert all(torch.equal(a, b) for a, b in zip(_state_leaves(sn),
                                                 _state_leaves(sf)))
