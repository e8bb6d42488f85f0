"""The MoE family on the card: the GEMM kernel's grouped route (the expert
FFN) and its grouped dX / dW against their plain versions and against the
per-expert 2-D launches, the router's fp32 product, and
Granite-3.0-1B-A400M at full width on two layers, served and trained.  Every test here needs an NVIDIA card and skips without one; run
them there with
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_moe.py``.

GEMM tolerances are ``tests/test_torch_cuda_kernels.py``'s: fp32 atol/rtol
1e-4, bf16 atol 0.125, rtol 2e-2 (one bf16 rounding of values of order
10).  Everything the serving guarantees rest on is bitwise: grouped =
per-expert, a row's bits at every capacity C, the router's logits at every
row count, graphed = eager, suffix = full prefill, tapir = opaque.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core import tapir
from repro_torch.kernels.fused_matmul import ops, ref
from repro_torch.models import moe
from repro_torch.models.base import get_model
from repro_torch.models.moe import route_logits
from repro_torch.serve import Request, ServeConfig, ServingEngine

ARCHS = ("granite_moe_1b_a400m", "moonshot_v1_16b_a3b")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def _tol(dt):
    return (1e-4, 1e-4) if dt == torch.float32 else (0.125, 2e-2)


def _expert_shapes():
    """(arch, name, E, k, n) of the expert FFN's three products."""
    out = []
    for arch in ARCHS:
        c = get_config(arch)
        out += [(arch, "gate", c.n_experts, c.d_model, c.d_ff),
                (arch, "down", c.n_experts, c.d_ff, c.d_model)]
    return out


def _operands(cuda, E, C, k, n, dt, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn(E, C, k, generator=g, device=cuda).to(dt)
    w = (torch.randn(E, k, n, generator=g, device=cuda) / k ** 0.5).to(dt)
    up = torch.randn(E, C, n, generator=g, device=cuda).to(dt)
    return x, w, up


def _gate_chain(up, dt):
    name = str(dt).split(".")[-1]
    return [("silu", [], {"dtype": name}), ("mul", [up], {"dtype": name})]


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("C", [4, 240])
@pytest.mark.parametrize("arch,name,E,k,n", _expert_shapes())
def test_grouped_matches_plain_and_per_expert(cuda, dt, C, arch, name, E, k,
                                              n):
    """One grouped launch: within the GEMM tolerance of the plain version,
    and bitwise the E per-expert 2-D launches (the gate with its silu, mul
    epilogue on the full [E, C, n] operand)."""
    x, w, up = _operands(cuda, E, C, k, n, dt, C + k + n)
    epi = _gate_chain(up, dt) if name == "gate" else []
    before = ops.launches
    y = ops.fused_matmul(x, w, epilogue=epi, out_dtype=dt)
    torch.cuda.synchronize()
    assert ops.launches == before + 1 and y.shape == (E, C, n)
    want = ref.grouped_matmul_ref(x, w, epilogue=epi, out_dtype=dt)
    atol, rtol = _tol(dt)
    torch.testing.assert_close(y.float(), want.float(), atol=atol, rtol=rtol)
    each = torch.stack([
        ops.fused_matmul(x[e], w[e], out_dtype=dt,
                         epilogue=[(f, [v[e] for v in vs], a)
                                   for f, vs, a in epi])
        for e in range(E)])
    torch.cuda.synchronize()
    assert torch.equal(y, each)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("arch,name,E,k,n", _expert_shapes())
def test_grouped_row_bits_do_not_depend_on_capacity(cuda, dt, arch, name, E,
                                                    k, n):
    """Expert e's row i gives the same bits at C = 1 and at C = 1280 (the
    row at 0 and at 777 of its buffer): what makes dropless decode over 1,
    2 or 4 live slots, and a suffix prefill, equal their baselines."""
    x, w, _ = _operands(cuda, E, 1280, k, n, dt, k + n)
    full = ops.fused_matmul(x, w, out_dtype=dt)
    one = ops.fused_matmul(x[:, 777:778].contiguous(), w, out_dtype=dt)
    moved = ops.fused_matmul(x[:, 777:778].expand(E, 3, k).contiguous(), w,
                             out_dtype=dt)
    torch.cuda.synchronize()
    assert torch.equal(one[:, 0], full[:, 777])
    assert torch.equal(moved[:, 2], full[:, 777])


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("C", [2, 80])
@pytest.mark.parametrize("name", ["gate", "up", "down"])
def test_a_launch_over_an_expert_block_is_the_whole_launch_s_rows(
        cuda, dt, C, name):
    """Granite's expert products on a model rank's block: the launch over
    experts [8:16) (and [0:8)) of a 16-expert buffer equals those rows of
    the 16-expert launch, bitwise, at a mesh rank's decode (C 2) and
    forward (C 80) shapes; the gate with its silu, mul chain."""
    c = get_config("granite_moe_1b_a400m")
    E = c.n_experts // 2
    k, n = (c.d_ff, c.d_model) if name == "down" else (c.d_model, c.d_ff)
    x, w, up = _operands(cuda, E, C, k, n, dt, C + k + n + E)

    def launch(lo, hi):
        epi = _gate_chain(up[lo:hi], dt) if name == "gate" else []
        return ops.fused_matmul(x[lo:hi], w[lo:hi], epilogue=epi,
                                out_dtype=dt)
    whole = launch(0, E)
    for lo in (0, E // 2):
        part = launch(lo, lo + E // 2)
        torch.cuda.synchronize()
        assert torch.equal(part, whole[lo:lo + E // 2]), lo


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCHS)
def test_router_logits_do_not_depend_on_rows(cuda, arch):
    """The router's fp32 product goes through the GEMM's fp32 route, whose
    plan is a function of (n, k) alone: a row's logits are the same bits at
    m = 1, 4, 37 and 2048."""
    c = get_config(arch)
    g = torch.Generator(device=cuda).manual_seed(5)
    x = torch.randn(2048, c.d_model, generator=g, device=cuda).to(
        torch.bfloat16)
    r = torch.randn(c.d_model, c.n_experts, generator=g, device=cuda) \
        / c.d_model ** 0.5
    full = route_logits(x, r)
    for m in (1, 4, 37):
        part = route_logits(x[:m], r)
        torch.cuda.synchronize()
        assert torch.equal(part, full[:m]), m
    torch.testing.assert_close(full, x.float() @ r, atol=1e-4, rtol=1e-4)


def _bwd_shapes():
    """(arch, name, E, C, k, n) of the expert FFN's products on the train
    paths: Granite's 2 x 2048 tokens (C 1280 at capacity factor 1.25),
    Moonlight's 1 x 2048 (C 240); the gate / up product (k = d_model, n =
    d_ff) and the down product (k = d_ff, n = d_model)."""
    out = []
    for arch, C in zip(ARCHS, (1280, 240)):
        c = get_config(arch)
        out += [(arch, "gate", c.n_experts, C, c.d_model, c.d_ff),
                (arch, "down", c.n_experts, C, c.d_ff, c.d_model)]
    return out


def _bwd_operands(cuda, E, C, k, n, dt, seed):
    """x [E, C, k], w [E, k, n] (scaled by 1 / sqrt(k)) and a cotangent
    dy [E, C, n] of the product."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn(E, C, k, generator=g, device=cuda).to(dt)
    w = (torch.randn(E, k, n, generator=g, device=cuda) / k ** 0.5).to(dt)
    dy = torch.randn(E, C, n, generator=g, device=cuda).to(dt)
    return x, w, dy


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("arch,name,E,C,k,n", _bwd_shapes())
def test_grouped_dx_dw_match_plain_and_per_expert(cuda, dt, arch, name, E, C,
                                                  k, n):
    """The grouped dX (dY W^T, W read K-major) and dW (X^T dY, X read
    MN-major, the contraction C): one launch each, within the GEMM
    tolerance of the plain versions, and bitwise the E per-expert 2-D
    ``matmul_dx`` / ``matmul_dw`` launches."""
    x, w, dy = _bwd_operands(cuda, E, C, k, n, dt, C + k + n)
    before = dict(ops.bwd_launches)
    dx = ops.matmul_dx_grouped(dy, w, dt)
    dw = ops.matmul_dw_grouped(x, dy, dt)
    torch.cuda.synchronize()
    for route in ("grouped_dx", "grouped_dw"):
        assert ops.bwd_launches[route] == before.get(route, 0) + 1
    assert dx.shape == (E, C, k) and dw.shape == (E, k, n)
    atol, rtol = _tol(dt)
    torch.testing.assert_close(dx.float(),
                               ref.grouped_matmul_dx_ref(dy, w, dt).float(),
                               atol=atol, rtol=rtol)
    torch.testing.assert_close(dw.float(),
                               ref.grouped_matmul_dw_ref(x, dy, dt).float(),
                               atol=atol, rtol=rtol)
    each_dx = torch.stack([ops.matmul_dx(dy[e], w[e], dt) for e in range(E)])
    each_dw = torch.stack([ops.matmul_dw(x[e], dy[e], dt) for e in range(E)])
    torch.cuda.synchronize()
    assert torch.equal(dx, each_dx)
    assert torch.equal(dw, each_dw)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32])
def test_grouped_dw_reads_no_neighbouring_expert(cuda, dt):
    """dW's contraction is C: a tile past C must read zeros, never the next
    expert's rows, which follow in the same buffer.  With C = 65 (one row
    past a 64-deep k tile) and the last expert's rows all NaN, every other
    expert's dW is finite and equals its own 2-D launch."""
    E, C, k, n = 4, 65, 192, 128
    x, w, dy = _bwd_operands(cuda, E, C, k, n, dt, 11)
    x[-1], dy[-1] = float("nan"), float("nan")
    dw = ops.matmul_dw_grouped(x, dy, dt)
    each = torch.stack([ops.matmul_dw(x[e], dy[e], dt)
                        for e in range(E - 1)])
    torch.cuda.synchronize()
    assert bool(torch.isfinite(dw[:-1]).all())
    assert torch.equal(dw[:-1], each)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("arch,name,E,C,k,n", _bwd_shapes()[::2])
def test_grouped_dx_row_bits_do_not_depend_on_capacity(cuda, dt, arch, name,
                                                       E, C, k, n):
    """A row of the grouped dX is the same bits at C = 1 as at the path's
    C (the last row of every expert's buffer run alone)."""
    _, w, dy = _bwd_operands(cuda, E, C, k, n, dt, 7)
    full = ops.matmul_dx_grouped(dy, w, dt)
    one = ops.matmul_dx_grouped(dy[:, -1:].contiguous(), w, dt)
    torch.cuda.synchronize()
    assert torch.equal(one[:, 0], full[:, -1])


# ---------------------------------------------------------------------------
# Granite-3.0-1B-A400M at full width, two layers
# ---------------------------------------------------------------------------


def _granite(device, layers=2):
    """Granite-3.0-1B-A400M at full width cut to ``layers``: the first
    layers of the 24-layer model drawn from seed 0, so the weights have the
    served model's statistics (the init scales a stacked leaf by its layer
    count: a model built 2 deep would draw them 3.5x larger)."""
    full = get_config("granite_moe_1b_a400m")
    gen = torch.Generator(device=device).manual_seed(0)
    tree = get_model(full, device=device, generator=gen).param_tree()
    tree["blocks"] = {kind: {k: v[:layers].clone() for k, v in leaves.items()}
                      for kind, leaves in tree["blocks"].items()}
    cfg = dataclasses.replace(full, n_layers=layers)
    return cfg, get_model(cfg, device=device, params=tree)


def _requests(vocab, seed=3):
    rng = np.random.default_rng(seed)
    prefix = rng.integers(1, vocab, 40).astype(np.int32)
    prompts = [rng.integers(1, vocab, n).astype(np.int32) for n in (30, 7)]
    prompts += [np.concatenate([prefix, rng.integers(1, vocab, n)
                                .astype(np.int32)]) for n in (5, 12, 1)]
    return [Request(rid=i, prompt=p, max_new=m)
            for i, (p, m) in enumerate(zip(prompts, (6, 3, 8, 5, 4)))]


def _serve(model, device, continuous=True, **cfg):
    reqs = _requests(model.cfg.vocab)
    eng = ServingEngine(model, batch=4, max_len=128, device=device,
                        cfg=ServeConfig(page_len=16, **cfg))
    out = eng.run(reqs) if continuous else eng.run_wave(reqs)
    return [list(r.out) for r in out], eng.last_stats


@pytest.mark.cuda
def test_granite_card_matches_cpu(cuda, monkeypatch):
    """Two layers at full width (``_granite``), the same weights, fp32
    compute and no capacity drops on both (capacity factor E / K, as the
    reference's serving test sets it: a drop moves with every earlier
    token's route):
    every token routed to the same experts on the card as on the CPU has
    its logits within 1e-3 of the logits' largest (the plain versions'
    sums in another order; ``tests/test_torch_cuda_zamba2.py``'s bound).
    A token whose top-k differs must sit at a near-tie of the router (the
    CPU's k-th and (k+1)-th probabilities within 1e-4: fp32 logits a few
    ulps apart pick either), and such tokens are at most 2 % of the
    routes; their rows, and the later rows of their sequence (causal
    attention reads their keys), are left out of the logits check."""
    cfg, m = _granite(cuda)
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32",
                                capacity_factor=cfg.n_experts / cfg.top_k)
    tree = m.param_tree()
    cpu_tree = {k: ({kk: {kkk: t.cpu() for kkk, t in vv.items()}
                     for kk, vv in v.items()} if k == "blocks"
                    else v.cpu()) for k, v in tree.items()}
    mc = get_model(cfg32, device="cuda", params=tree)
    mh = get_model(cfg32, device="cpu", params=cpu_tree)
    routes = {"cuda": [], "cpu": []}
    route = moe._route_topk

    def spy(xt, router, *, k, e, cap):
        out = route(xt, router, k=k, e=e, cap=cap)
        probs = torch.softmax(moe.route_logits(xt, router), dim=-1)
        top = torch.topk(probs, k + 1, dim=-1).values
        routes[xt.device.type].append(
            (torch.sort(out[1], dim=-1).values.cpu(),
             (top[:, k - 1] - top[:, k]).cpu()))
        return out

    monkeypatch.setattr(moe, "_route_topk", spy)
    B, S = 2, 64
    toks = np.random.default_rng(1).integers(1, cfg.vocab, (B, S))
    got = mc.forward({"tokens": torch.as_tensor(toks, device=cuda)}).cpu()
    want = mh.forward({"tokens": torch.as_tensor(toks)})
    assert len(routes["cuda"]) == len(routes["cpu"]) == cfg.n_layers
    flipped = torch.zeros(B * S, dtype=torch.bool)
    for (ids_c, _), (ids_h, margin) in zip(routes["cuda"], routes["cpu"]):
        diff = (ids_c != ids_h).any(-1)
        assert bool((margin[diff] < 1e-4).all()), margin[diff]
        flipped |= diff
    assert int(flipped.sum()) <= 0.02 * B * S
    ok = ~torch.cummax(flipped.reshape(B, S).int(), dim=1).values.bool()
    assert bool(torch.isfinite(got).all())
    err = (got - want).abs().amax(-1).reshape(B, S)
    assert err[ok].max() <= 1e-3 * want.abs().max(), (
        err.max(), divmod(int(err.argmax()), S), want.abs().max())


@pytest.mark.cuda
def test_granite_graphed_equals_eager_and_continuous_equals_wave(cuda):
    """Slot serving with the decode blocks replayed as CUDA graphs gives the
    tokens of the eager run (``TapirConfig`` with graphs off is the per-op
    control here: ``regions=False``), and continuous batching the tokens of
    the wave baseline."""
    _, m = _granite(cuda)
    tapir.clear_cache()
    graphed, st = _serve(m, cuda)
    assert tapir.cache_stats()["graph_replays"] > 0
    eager, _ = _serve(m, cuda, regions=False)
    wave, _ = _serve(m, cuda, continuous=False)
    assert graphed == eager == wave
    assert st["prefix_hits"] == 2


@pytest.mark.cuda
def test_granite_suffix_prefill_equals_full(cuda):
    """Prefix sharing on (suffix prefills over resident pages) and off
    (every prompt prefilled whole): the same tokens."""
    _, m = _granite(cuda)
    shared, st = _serve(m, cuda)
    whole, st2 = _serve(m, cuda, prefix_sharing=False)
    assert st["prefix_hits"] == 2 and st2["prefix_hits"] == 0
    assert shared == whole


@pytest.mark.cuda
def test_granite_tapir_tokens_equal_opaque(cuda):
    """tapir (3 grouped launches a MoE layer) and opaque (3 x E per-expert
    launches): the same tokens, from the same kernel."""
    cfg, m = _granite(cuda)
    ops.reset_counts()
    tap, _ = _serve(m, cuda)
    n_tap = ops.launches
    ops.reset_counts()
    opq, _ = _serve(m, cuda, mode="opaque")
    n_opq = ops.launches
    assert tap == opq
    assert n_opq > n_tap


# ---------------------------------------------------------------------------
# Granite-3.0-1B-A400M training at full width, two layers
# ---------------------------------------------------------------------------


def _train_batches(cfg, device, n, batch=2, seq=256):
    from repro_torch.data import DataConfig, TokenPipeline, to_device
    pipe = TokenPipeline(DataConfig(seq_len=seq, global_batch=batch,
                                    vocab=cfg.vocab))
    return [to_device(pipe.batch_at(s), device) for s in range(n)]


def _first_grads(model, batch, target):
    from repro_torch.optim import tree_leaves
    from repro_torch.train import TrainConfig
    with tapir.use(TrainConfig(target=target).tapir_config()), \
            model.trainable():
        loss = model.loss(batch)
        return loss.detach(), torch.autograd.grad(
            loss, tree_leaves(model.param_tree()))


@pytest.mark.cuda
def test_granite_train_gradients_card_match_cpu(cuda, monkeypatch):
    """The 2-layer cut at fp32 compute on 1 x 64 tokens, capacity factor
    1.25 (routes dropped, as in training): the card (grouped dX / dW, the
    fp32 router's dX / dW, flash's backward) against the CPU (the plain
    versions) on the same weights.  Every token must be routed to the same
    experts on both (a flip is a near-tie of the router's fp32 logits and
    fails the test rather than being hidden); then the loss within rtol
    1e-5 and each leaf's gradient within 1e-3 of its largest entry (fp32
    sums in other orders, through two layers and the 49155-column
    head)."""
    cfg, m = _granite(cuda)
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    tree = m.param_tree()
    cpu_tree = {k: ({kk: {kkk: t.cpu() for kkk, t in vv.items()}
                     for kk, vv in v.items()} if k == "blocks"
                    else v.cpu()) for k, v in tree.items()}
    mc = get_model(cfg32, device="cuda", params=tree)
    mh = get_model(cfg32, device="cpu", params=cpu_tree)
    routes = {"cuda": [], "cpu": []}
    route = moe._route_topk

    def spy(xt, router, *, k, e, cap):
        out = route(xt, router, k=k, e=e, cap=cap)
        routes[xt.device.type].append(tuple(t.detach().cpu()
                                            for t in out[1:]))
        return out

    monkeypatch.setattr(moe, "_route_topk", spy)
    batch = _train_batches(cfg, "cpu", 1, batch=1, seq=64)[0]
    lc, gc = _first_grads(mc, {k: v.to(cuda) for k, v in batch.items()},
                          "gpu")
    lh, gh = _first_grads(mh, batch, "gpu")
    for rc, rh in zip(routes["cuda"], routes["cpu"]):
        for a, b in zip(rc, rh):
            assert torch.equal(a, b), "a route differs between card and cpu"
    assert any(bool((~rh[2]).any()) for rh in routes["cpu"])
    torch.testing.assert_close(lc.cpu(), lh, rtol=1e-5, atol=0)
    for a, b in zip(gc, gh):
        assert bool(torch.isfinite(a).all())
        assert float((a.cpu() - b).abs().max()) <= 1e-3 * float(
            b.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_granite_captured_step_equals_per_op_bitwise(cuda, dtype):
    """The 2-layer cut, 2 x 256 tokens, 2 steps: the captured step (policy
    auto: the grouped GEMMs, the router lift, the ``zero_init`` scatter
    and the gather differentiated by ``core/autodiff.py``) gives the
    per-op step's loss at every step and its params and AdamW state, bit
    for bit."""
    from repro_torch.optim import AdamWConfig, tree_leaves
    from repro_torch.train import (TrainConfig, init_state,
                                   make_region_train_step, make_train_step)
    cfg, m = _granite(cuda)
    cfg = dataclasses.replace(cfg, compute_dtype=dtype)
    tree = m.param_tree()
    opt = AdamWConfig(lr=1e-3, total_steps=2, warmup_steps=1)
    batches = _train_batches(cfg, cuda, 2)
    out = {}
    for kind in ("per_op", "captured"):
        model = get_model(cfg, device=cuda, params={
            k: ({kk: {kkk: t.clone() for kkk, t in vv.items()}
                 for kk, vv in v.items()} if k == "blocks" else v.clone())
            for k, v in tree.items()})
        make = make_train_step if kind == "per_op" else (
            lambda mm, o, c: make_region_train_step(
                mm, o, dataclasses.replace(c, remat="auto")))
        step = make(model, opt, TrainConfig(target="gpu"))
        state = init_state(model, opt)
        losses = []
        for b in batches:
            state, met = step(state, b)
            losses.append(met["loss"].clone())
        out[kind] = (losses, tree_leaves(state["params"])
                     + tree_leaves(state["opt"]))
        tapir.clear_cache()
    assert all(torch.equal(a, b) for a, b in zip(out["per_op"][0],
                                                 out["captured"][0]))
    assert all(torch.equal(a, b) for a, b in zip(out["per_op"][1],
                                                 out["captured"][1]))
