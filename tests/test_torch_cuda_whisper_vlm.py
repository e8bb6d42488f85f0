"""The encoder-decoder and VLM families on the card: the launch shapes their
paths bring to the GEMM and flash kernels (Whisper-small's biased GEMMs
with their bias, gelu and residual epilogues and its tied 51865-column
head; flash non-causal over 1500 frames with one K/V head a query head;
InternVL2-76B's gate|up, down, head and causal flash shapes) against the
plain versions, and Whisper at full width on two layers of each stack.
Every test here needs an NVIDIA card and skips without one; run them there
with
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_whisper_vlm.py``.

Tolerances: GEMM as ``tests/test_torch_cuda_kernels.py`` (fp32 atol/rtol
1e-4, bf16 atol 0.125, rtol 2e-2); flash as ``chip_smoke.py``'s FA_TOL
(the JAX package's own flash tolerances: bf16 2e-2, fp32 2e-4 absolute)
and FA_RTOL (each row within 2e-2 / 1e-4 of its own largest value).
The 2-layer Whisper at fp32 compute, card against CPU:

* at the reference's init (the 2 layers of the 12-layer draw: a stacked
  leaf at 1 / sqrt(12), so attention scores in the tens to hundreds and
  activations in the thousands), within 3e-2 of the CPU logits' largest:
  the model amplifies the last bits of a sum, so two fp32 summation
  orders land apart (the card's kernels against the CPU's plain
  versions: 1.06e-2 on the H100; ``chip_smoke.py``'s ``whisper_serve``
  measures the same amplification at full depth);
* with every weight matrix drawn at 1 / sqrt(fan-in) instead (the scale
  under which the model is well conditioned), within 1e-4 of the
  largest: the check of the wiring (layouts, strides, masks, caches).

Everything the guarantees rest on is bitwise, in bf16 (the compute dtype
served, whose GEMM plan sums a column's k in an order fixed by k alone):
region = per-op, opaque = tapir, graphed = eager.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core import tapir
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.fused_matmul import ops, ref
from repro_torch.models.base import get_model
from repro_torch.serve import ServeConfig

FA_TOL = {torch.bfloat16: 2e-2, torch.float32: 2e-4}
FA_RTOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def _tol(dt):
    return (1e-4, 1e-4) if dt == torch.float32 else (0.125, 2e-2)


def _gemm_shapes():
    """(name, m, k, n, chain) of the new GEMM launch shapes: Whisper's (the
    encoder's m = 4 x 1500 rows, a decode step's 4) and InternVL2-76B's
    (the forward's 256 + 2048 rows, a decode step's 4).  ``chain``: the
    epilogue as (fn, operand kind) stages."""
    w, v = get_config("whisper_small"), get_config("internvl2_76b")
    d, ff = w.d_model, w.d_ff
    out = []
    for m in (4, 6000):
        out += [("whisper_wu", m, d, ff, (("add", "row"), ("gelu", None))),
                ("whisper_wd", m, ff, d, (("add", "row"), ("add", "full"))),
                ("whisper_q", m, d, d, (("add", "row"),)),
                ("whisper_wo", m, d, d, (("add", "full"),)),
                ("whisper_qkv", m, d, 3 * d, ())]
    for m in (4, 2304):
        out += [("internvl_gate_up", m, v.d_model, 2 * v.d_ff, ()),
                ("internvl_down", m, v.d_ff, v.d_model, (("add", "full"),))]
    return out


def _operands(cuda, m, k, n, chain, dt, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn(m, k, generator=g, device=cuda).to(dt)
    w = (torch.randn(k, n, generator=g, device=cuda) / k ** 0.5).to(dt)
    name = str(dt).split(".")[-1]
    epi = []
    for fn, kind in chain:
        vals = [] if kind is None else [torch.randn(
            (n,) if kind == "row" else (m, n), generator=g,
            device=cuda).to(dt)]
        epi.append((fn, vals, {"dtype": name}))
    return x, w, epi


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name,m,k,n,chain", _gemm_shapes())
def test_gemm_shapes_match_plain(cuda, dt, name, m, k, n, chain):
    """One launch at each new shape and epilogue (the tanh GELU as the
    reference's), within the GEMM tolerance of the plain version, and
    bitwise on a second call."""
    x, w, epi = _operands(cuda, m, k, n, chain, dt, m + k + n)
    before = ops.launches
    y = ops.fused_matmul(x, w, epilogue=epi, out_dtype=dt)
    torch.cuda.synchronize()
    assert ops.launches == before + 1
    want = ref.fused_matmul_ref(x, w, epilogue=epi, out_dtype=dt)
    atol, rtol = _tol(dt)
    torch.testing.assert_close(y.float(), want.float(), atol=atol, rtol=rtol)
    assert torch.equal(y, ops.fused_matmul(x, w, epilogue=epi, out_dtype=dt))


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("arch,m", [("whisper_small", 4),
                                    ("whisper_small", 1792),
                                    ("internvl2_76b", 4)])
def test_tied_head_matches_plain_in_place(cuda, dt, arch, m):
    """The head ``embed.T`` (Whisper's 51865 columns, not a multiple of 8;
    InternVL's untied 128256-column head taken the same way here) read
    K-major in place: no copy of the weight, within the tolerance of the
    plain version."""
    c = get_config(arch)
    g = torch.Generator(device=cuda).manual_seed(m)
    emb = (torch.randn(c.vocab, c.d_model, generator=g, device=cuda)
           / c.d_model ** 0.5).to(dt)
    x = torch.randn(m, c.d_model, generator=g, device=cuda).to(dt)
    b, tb = ops.weight_operand(emb.T)
    assert tb and b.data_ptr() == emb.data_ptr()
    y = ops.fused_matmul(x, emb.T, out_dtype=dt)
    want = ref.fused_matmul_ref(x, emb.T, out_dtype=dt)
    atol, rtol = _tol(dt)
    torch.testing.assert_close(y.float(), want.float(), atol=atol, rtol=rtol)


def _flash_shapes():
    """(B, Sq, Skv, Hq, Hkv, D, causal): Whisper's encoder (1500 keys: the
    last 128-key tile holds 92), its cross-attention at a 4-token prefill
    and at a decode step, its decoder's causal self-attention, and
    InternVL2-76B's causal forward over 256 + 2048 rows."""
    return [(2, 1500, 1500, 12, 12, 64, False), (4, 4, 1500, 12, 12, 64, False),
            (4, 1, 1500, 12, 12, 64, False), (4, 448, 1500, 12, 12, 64, False),
            (4, 448, 448, 12, 12, 64, True),
            (1, 2304, 2304, 64, 8, 128, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", _flash_shapes())
def test_flash_shapes_match_plain(cuda, dt, shape):
    """One launch, within FA_TOL of the kernel's plain version and of the
    fp32 oracle, each row within FA_RTOL of its own largest value against
    the plain version, and bitwise on a second call."""
    b, sq, skv, hq, hkv, d, causal = shape
    g = torch.Generator(device=cuda).manual_seed(sq + skv)
    q = torch.randn(b, sq, hq, d, generator=g, device=cuda).to(dt)
    k = torch.randn(b, skv, hkv, d, generator=g, device=cuda).to(dt)
    v = torch.randn(b, skv, hkv, d, generator=g, device=cuda).to(dt)
    before = fa_ops.launches
    o = fa_ops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa_ops.launches == before + 1
    plain = fa_ref.flash_attention_ref(q, k, v, causal=causal)
    for want in (plain, fa_ref.attention_ref(q, k, v, causal=causal)):
        err = float((o.float() - want.float()).abs().max())
        assert err <= FA_TOL[dt], err
    diff = (o.float() - plain.float()).abs()
    rel = float((diff.amax(-1) / plain.float().abs().amax(-1)).max())
    assert rel <= FA_RTOL[dt], rel
    assert torch.equal(o, fa_ops.flash_attention(q, k, v, causal=causal))


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sq,skv", [(448, 448), (1, 1500)])
def test_flash_reads_fused_projection_views(cuda, dt, sq, skv):
    """q, k and v as the region passes them: views into one fused
    projection's output (``[B, S, 3 H D]`` sliced per member, a row stride
    of 3 H D), against the same values made contiguous, bitwise."""
    g = torch.Generator(device=cuda).manual_seed(sq)
    qkv = torch.randn(2, skv, 3 * 768, generator=g, device=cuda).to(dt)
    q, k, v = (qkv[:, -sq:, i * 768:(i + 1) * 768].reshape(2, -1, 12, 64)
               for i in range(3))
    o = fa_ops.flash_attention(q, k, v, causal=sq == skv)
    want = fa_ops.flash_attention(q.contiguous(), k.contiguous(),
                                  v.contiguous(), causal=sq == skv)
    assert torch.equal(o, want)


def _whisper2(fan_in: bool):
    """Whisper-small at full width on the first 2 layers of each stack of
    the 12 + 12-layer draw (seed 0 on the CPU): the init scales a stacked
    leaf by its layer count, so these are the served model's weights; with
    ``fan_in`` every weight matrix is drawn again at 1 / sqrt(its rows).
    (cfg at fp32 compute, the CPU model, the card model) on the same
    weights."""
    full = get_config("whisper_small")
    tree = get_model(full, device="cpu",
                     generator=torch.Generator().manual_seed(0)).param_tree()
    tree = {k: ({n: t[:2].clone() for n, t in v.items()}
                if isinstance(v, dict) else v.detach().clone())
            for k, v in tree.items()}
    if fan_in:
        g = torch.Generator().manual_seed(1)
        for stack in ("enc", "dec"):
            for n, t in tree[stack].items():
                if t.ndim == 3:
                    tree[stack][n] = torch.randn(t.shape, generator=g) \
                        / t.shape[1] ** 0.5
    cfg = dataclasses.replace(full, n_layers=2, n_enc_layers=2,
                              compute_dtype="float32")
    cpu = get_model(cfg, device="cpu", params=tree)
    return cfg, cpu, get_model(cfg, device="cuda", params=tree)


@pytest.fixture(scope="module", params=["reference_init", "fan_in"])
def whisper2(request):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return request.param, _whisper2(request.param == "fan_in")


def _whisper_inputs(cfg, device, seed=3):
    rng = np.random.default_rng(seed)
    toks = torch.as_tensor(rng.integers(1, cfg.vocab, (2, 24)),
                           dtype=torch.int32, device=device)
    frames = torch.as_tensor(
        (rng.normal(size=(2, cfg.n_frames, cfg.d_model)) * .1
         ).astype(np.float32), device=device)
    return toks, frames


def _serve(model, toks, frames, scfg, steps=6):
    """Prefill on the first 16 tokens, then ``steps`` decode steps fed the
    next tokens: every call's logits."""
    with tapir.use(scfg.tapir_config()):
        cache = model.init_cache(2, 32)
        lg, cache = model.prefill(toks[:, :16], cache, frames)
        out = [lg]
        for i in range(steps):
            lg, cache = model.decode_step(toks[:, 16 + i:17 + i], cache)
            out.append(lg)
    return out


#: card vs CPU at fp32 compute, of the CPU logits' largest (see above)
CARD_VS_CPU = {"reference_init": 3e-2, "fan_in": 1e-4}


@pytest.mark.cuda
def test_whisper_card_matches_cpu(cuda, whisper2):
    """The forward and the padded cache's prefill + decode on the card
    against the CPU (the plain versions), within CARD_VS_CPU of the CPU
    logits' largest, at fp32 compute."""
    init, (cfg, cpu, card) = whisper2
    outs = {}
    for dev, model, target in (("cpu", cpu, "cpu"), ("cuda", card, "gpu")):
        toks, frames = _whisper_inputs(cfg, dev)
        scfg = ServeConfig(target=target)
        with tapir.use(scfg.tapir_config()):
            fwd = model.forward({"tokens": toks, "frames": frames})
        outs[dev] = [fwd] + _serve(model, toks, frames, scfg)
    for a, b in zip(outs["cpu"], outs["cuda"]):
        scale = float(a.abs().max())
        assert float((a - b.cpu()).abs().max()) <= CARD_VS_CPU[init] * scale


@pytest.mark.cuda
def test_whisper_guarantees_bitwise(cuda, whisper2):
    """Region = per-op walk, opaque = tapir, for the forward and 6 decode
    steps after the prefill (the decode blocks replay CUDA graphs from the
    third step where the schedule finds them dispatch-bound: graphed =
    eager), at bf16 compute."""
    init, (cfg, cpu, _) = whisper2
    card = get_model(dataclasses.replace(cfg, compute_dtype="bfloat16"),
                     device="cuda", params=cpu.param_tree())
    toks, frames = _whisper_inputs(cfg, "cuda")
    runs = {}
    for tag, scfg in (("region", ServeConfig(target="gpu")),
                      ("per_op", ServeConfig(target="gpu", regions=False)),
                      ("opaque", ServeConfig(target="gpu", mode="opaque"))):
        with tapir.use(scfg.tapir_config()):
            fwd = card.forward({"tokens": toks, "frames": frames})
        runs[tag] = [fwd] + _serve(card, toks, frames, scfg)
    for tag in ("per_op", "opaque"):
        assert all(torch.equal(a, b)
                   for a, b in zip(runs["region"], runs[tag])), tag


# ---------------------------------------------------------------------------
# Training: the backward shapes the encoder-decoder and VLM train steps
# bring (chip_smoke.py's BWD_RTOL: each gradient within 2e-2 / 1e-4 of its
# largest entry, bf16 / fp32)
# ---------------------------------------------------------------------------

BWD_RTOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}


def _rel(got, want) -> float:
    return max(float((g.float() - w.float()).abs().max())
               / max(float(w.float().abs().max()), 1e-30)
               for g, w in zip(got, want))


def _train_flash_shapes():
    """(B, Sq, Skv, Hq, Hkv, D, causal) of the train steps' attention:
    Whisper's encoder (non-causal 1500 x 1500: ragged query and key tiles,
    the last key tile 92 wide), cross-attention (non-causal, 448 queries
    over 1500 frames) and decoder (causal 448); InternVL's causal 256 +
    2048 positions, GQA 8."""
    w, v = get_config("whisper_small"), get_config("internvl2_76b")
    h, d = w.n_heads, w.hd
    return [(4, 1500, 1500, h, h, d, False), (4, 448, 1500, h, h, d, False),
            (4, 448, 448, h, h, d, True),
            (1, 2304, 2304, v.n_heads, v.n_kv_heads, v.hd, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", _train_flash_shapes())
def test_flash_backward_at_train_shapes_matches_plain(cuda, dt, shape):
    """The flash backward (one launch) against
    ``flash_attention_bwd_ref``, each of dQ, dK, dV within BWD_RTOL of its
    largest entry, and bitwise on a second call."""
    b, sq, skv, hq, hkv, d, causal = shape
    g = torch.Generator(device=cuda).manual_seed(sq + skv)
    q = torch.randn(b, sq, hq, d, generator=g, device=cuda).to(dt)
    k = torch.randn(b, skv, hkv, d, generator=g, device=cuda).to(dt)
    v = torch.randn(b, skv, hkv, d, generator=g, device=cuda).to(dt)
    o, lse = fa_ops.flash_attention(q, k, v, causal=causal, return_lse=True)
    do = torch.randn(o.shape, generator=g, device=cuda).to(dt)
    before = fa_ops.bwd_launches
    got = fa_ops.flash_attention_bwd(q, k, v, o, lse, do, causal)
    assert fa_ops.bwd_launches == before + 1
    want = fa_ref.flash_attention_bwd_ref(q, k, v, o, lse, do, causal)
    assert _rel(got, want) <= BWD_RTOL[dt]
    again = fa_ops.flash_attention_bwd(q, k, v, o, lse, do, causal)
    assert all(torch.equal(a, b_) for a, b_ in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name,m,k,n,chain", [
    s_ for s_ in _gemm_shapes() if s_[0].startswith("whisper") and s_[4]])
def test_gemm_backward_through_whisper_epilogues(cuda, dt, name, m, k, n,
                                                 chain):
    """``FusedMatmulFn``'s gradients of x, w and every epilogue operand
    against autograd through ``fused_matmul_ref`` (BWD_RTOL): a chain of
    adds (a row bias, a residual) takes the add-only walk, bias + tanh GELU
    recomputes its product in fp32, one more forward launch."""
    x, w, epi = _operands(cuda, m, k, n, chain, dt, m + n)
    leaves = [x, w] + [t for _, vals, _ in epi for t in vals]
    for t in leaves:
        t.requires_grad_(True)
    g = torch.Generator(device=cuda).manual_seed(7)
    dy = torch.randn(m, n, generator=g, device=cuda).to(dt)
    y = ops.fused_matmul(x, w, epilogue=epi, out_dtype=dt)
    before = ops.launches
    got = torch.autograd.grad(y, leaves, dy)
    torch.cuda.synchronize()
    recompute = any(fn != "add" for fn, _ in chain)
    assert ops.launches == before + int(recompute)
    want = torch.autograd.grad(
        ref.fused_matmul_ref(x, w, epilogue=epi, out_dtype=dt), leaves, dy)
    assert _rel(got, want) <= BWD_RTOL[dt]


@pytest.mark.cuda
def test_whisper_tied_head_backward_pads_and_matches_plain(cuda):
    """The 51865-column tied head's dX (``embed`` read in place) and dW at
    the train step's 4 x 448 rows, bf16, through the padded rows
    ``kernel.pad_cols`` copies: within BWD_RTOL of the plain versions."""
    c = get_config("whisper_small")
    g = torch.Generator(device=cuda).manual_seed(3)
    dt = torch.bfloat16
    emb = (torch.randn(c.vocab, c.d_model, generator=g, device=cuda)
           / 60).to(dt)
    x = torch.randn(1792, c.d_model, generator=g, device=cuda).to(dt)
    dy = (torch.randn(1792, c.vocab, generator=g, device=cuda) / 100).to(dt)
    assert c.vocab % 8 == 1
    dx = ops.matmul_dx(dy, emb.T, dt)
    dw = ops.matmul_dw(x, dy, dt)
    assert _rel([dx, dw], [ref.matmul_dx_ref(dy, emb.T, dt),
                           ref.matmul_dw_ref(x, dy, dt)]) <= BWD_RTOL[dt]
    assert torch.equal(dx, ops.matmul_dx(dy, emb.T.contiguous(), dt))


@pytest.mark.cuda
def test_whisper_captured_step_equals_per_op_bitwise(cuda):
    """Whisper-small at full width on 2 + 2 layers of the 12 + 12 draw,
    bf16 compute, 2 x 64 tokens over zero frames: 2 captured steps (policy
    auto) against 2 per-op steps (remat full) from the same weights, every
    loss, parameter and AdamW moment bitwise."""
    from repro_torch.data import DataConfig, TokenPipeline, to_device
    from repro_torch.optim import AdamWConfig, tree_leaves
    from repro_torch.train import (TrainConfig, init_state,
                                   make_region_train_step, make_train_step)
    cfg, cpu, _ = _whisper2(False)
    cfg = dataclasses.replace(cfg, compute_dtype="bfloat16")
    pipe = TokenPipeline(DataConfig(seq_len=64, global_batch=2,
                                    vocab=cfg.vocab))
    runs = []
    for make, remat in ((make_train_step, "full"),
                        (make_region_train_step, "auto")):
        tapir.clear_cache()
        model = get_model(cfg, device="cuda", params={
            k: ({n: t.clone() for n, t in v.items()} if isinstance(v, dict)
                else v.clone()) for k, v in cpu.param_tree().items()})
        opt = AdamWConfig(total_steps=4, warmup_steps=1)
        step = make(model, opt, TrainConfig(remat=remat, target="gpu"))
        state = init_state(model, opt)
        losses = []
        for s_ in range(2):
            batch = to_device(pipe.batch_at(s_), "cuda")
            for k, spec in model.input_specs(64, 2, "train").items():
                batch.setdefault(k, torch.zeros(spec.shape, dtype=spec.dtype,
                                                device="cuda"))
            state, m = step(state, batch)
            losses.append(m["loss"].clone())
        runs.append((losses, [t.clone() for t in tree_leaves(state)]))
    (la, sa), (lb, sb) = runs
    assert all(torch.equal(a, b) for a, b in zip(la, lb))
    assert all(torch.equal(a, b) for a, b in zip(sa, sb))
