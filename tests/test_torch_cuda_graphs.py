"""Region programs replayed as CUDA graphs, on the card: the graphed decode
steps equal the eager walk bitwise, capture nothing after their second
step, and count the same kernel launches; and the serving guarantees
(``run`` = ``run_wave``, prefix sharing on = off, regions = per-op) hold
with the graphs in play.

The models run their configs' full widths cut to 2 layers (qwen2.5-3b:
d_model 2048, 16 / 2 heads of 128, d_ff 11008; RWKV6-7B: d_model 4096, 64
heads of 64, d_ff 14336), bf16 compute, random weights from seed 0.  The
eager side of a comparison judges every region device-bound
(``tapir.dispatch_bound`` patched to False), which the product never does.
Needs an NVIDIA card; run with
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_graphs.py``.
"""
import collections
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core import tapir
from repro_torch.kernels.fused_matmul import ops as fm_ops
from repro_torch.kernels.linear_scan import ops as ls_ops
from repro_torch.models.base import get_model
from repro_torch.serve import Request, ServeConfig, ServingEngine

STEPS = 20
GPU = ServeConfig(target="gpu")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    tapir.clear_cache()
    yield torch.device("cuda")
    tapir.clear_cache()


def _model(arch: str):
    cfg = dataclasses.replace(get_config(arch), n_layers=2)
    return get_model(cfg, device="cuda",
                     generator=torch.Generator(device="cuda").manual_seed(0))


def _decode(model, path: str):
    """(logits of STEPS decode steps after a prefill, launches by shape of
    the steps, graph captures per step, graph replays per step)."""
    rng = np.random.default_rng(0)
    toks = torch.as_tensor(rng.integers(1, model.cfg.vocab, (4, 64 + STEPS)),
                           dtype=torch.int32, device="cuda")
    out, captures, replays = [], [], []
    with tapir.use(GPU.tapir_config()):
        if path == "slot":
            sp = model.compute_params()
            cache = model.init_slot_cache(4, 128)
            for s in range(4):
                padded = torch.zeros((1, 64), dtype=torch.int32,
                                     device="cuda")
                padded[0, :40 + s] = toks[s, :40 + s]
                _, cache = model.prefill_into_slot(sp, padded, cache, s,
                                                   40 + s)
        else:
            cache = model.init_cache(4, 128)
            _, cache = model.prefill(toks[:, :64], cache)
        fm_ops.reset_counts()
        ls_ops.reset_counts()
        for t in range(STEPS):
            before = tapir.cache_stats()
            feed = toks[:, 64 + t:65 + t].contiguous()
            if path == "slot":
                lg, cache = model.decode_step_slots(sp, feed, cache)
            else:
                lg, cache = model.decode_step(feed, cache)
            after = tapir.cache_stats()
            captures.append(after["graph_captures"] - before["graph_captures"])
            replays.append(after["graph_replays"] - before["graph_replays"])
            out.append(lg)
    torch.cuda.synchronize()
    counts = collections.Counter(fm_ops.launches_by_shape)
    counts.update(ls_ops.launches_by_shape)
    return out, counts, captures, replays


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["slot", "padded", "rwkv"])
def test_graphed_decode_equals_the_eager_walk(cuda, path, monkeypatch):
    model = _model("rwkv6_7b" if path == "rwkv" else "qwen2_5_3b")
    got, counts, captures, replays = _decode(model, path)
    # the blocks are dispatch-bound at decode, the head is not
    blocks = model.cfg.n_layers
    assert sum(captures[:2]) == blocks and sum(captures[2:]) == 0
    assert replays[2:] == [blocks] * (STEPS - 2)
    monkeypatch.setattr(tapir, "dispatch_bound", lambda g, cm: False)
    tapir.clear_cache()
    want, eager_counts, captures, _ = _decode(model, path)
    assert sum(captures) == 0 and tapir.cache_stats()["graphs"] == 0
    for i, (a, b) in enumerate(zip(got, want)):
        assert torch.equal(a, b), f"step {i}"
    assert counts == eager_counts


def _requests(vocab: int):
    rng = np.random.default_rng(0)
    prefix = rng.integers(1, vocab, 32).astype(np.int32)
    out = []
    for i, n in enumerate([20, 70, 48, 40, 56, 30]):
        tail = rng.integers(1, vocab, n).astype(np.int32)
        prompt = np.concatenate([prefix, tail]) if i in (2, 3, 4) else tail
        out.append(Request(rid=i, prompt=prompt, max_new=8))
    return out


@pytest.mark.cuda
def test_serving_guarantees_hold_with_graphs(cuda):
    model = _model("qwen2_5_3b")
    reqs = _requests(model.cfg.vocab)

    def serve(wave=False, **kw):
        eng = ServingEngine(model, batch=4, max_len=128,
                            cfg=ServeConfig(target="gpu", **kw),
                            device="cuda")
        fresh = [dataclasses.replace(r, out=[]) for r in reqs]
        before = tapir.cache_stats()["graph_replays"]
        out = eng.run_wave(fresh) if wave else eng.run(fresh)
        return ([r.out for r in out],
                tapir.cache_stats()["graph_replays"] - before)

    cont, replayed = serve()
    assert replayed > 0
    assert serve(wave=True)[0] == cont
    assert serve(prefix_sharing=False)[0] == cont
    per_op, replayed = serve(regions=False)
    assert per_op == cont and replayed == 0
    opaque, replayed = serve(mode="opaque")
    assert opaque == cont and replayed == 0


@pytest.mark.cuda
def test_rwkv_padded_waves_equal_with_graphs(cuda):
    model = _model("rwkv6_7b")
    reqs = _requests(model.cfg.vocab)
    eng = ServingEngine(model, batch=4, max_len=128, cfg=GPU, device="cuda")
    run = [r.out for r in eng.run([dataclasses.replace(r, out=[])
                                   for r in reqs])]
    wave = [r.out for r in eng.run_wave([dataclasses.replace(r, out=[])
                                         for r in reqs])]
    per_op = ServingEngine(model, batch=4, max_len=128,
                           cfg=ServeConfig(target="gpu", regions=False),
                           device="cuda")
    assert run == wave
    assert [r.out for r in per_op.run([dataclasses.replace(r, out=[])
                                       for r in reqs])] == run
    assert tapir.cache_stats()["graph_replays"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen2_5_3b", "rwkv6_7b"])
def test_finished_runs_leave_no_graphs_on_the_card(cuda, arch):
    """Runs with other prompt lengths each capture their decode blocks and
    leave no graph and no graph pool behind."""
    model = _model(arch)
    eng = ServingEngine(model, batch=4, max_len=128, cfg=GPU, device="cuda")
    reqs = _requests(model.cfg.vocab)
    for cut in (0, 0, 3):
        before = tapir.cache_stats()["graph_captures"]
        eng.run([dataclasses.replace(r, prompt=r.prompt[cut:], out=[])
                 for r in reqs])
        st = tapir.cache_stats()
        assert st["graph_captures"] - before >= model.cfg.n_layers
        assert st["graphs"] == 0 and st["graph_pool_bytes"] == 0
