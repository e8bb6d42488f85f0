"""The captured training step on the card (``train/region_step.py``)
against the per-op step (``train/step.py``, remat ``full``).

qwen2.5-3b's and RWKV6-7B's full widths cut to 2 layers, random weights
from seed 0, 2 x 256 tokens of ``TokenPipeline``, 3 steps:

* in fp32 compute the captured step equals the per-op step bitwise: the
  loss at every step, the params and the AdamW state after the last;
* the state keeps its buffers from the first step on, and later steps
  replay the compiled program;
* every product and attention goes through the port's kernels, from the
  VJP nodes too: the launches a step are those the joint graph implies
  (each product once forward, once more where ``pick_remat`` recomputes
  it or its epilogue chain is not adds alone; dX and dW once each), and
  under policy ``none`` no forward is replayed; no cuBLAS, SDPA or cuDNN
  kernel shows in a profiled step;
* in bf16 compute the loss is bitwise and the params within atol 2e-3
  after a step (the JAX package's bound; whether they are bitwise too is
  printed);
* at SMOKE size the step is dispatch-bound and replays as a CUDA graph:
  graphed equals the eager walk bitwise over 3 steps, with the same
  launches a step.

Needs an NVIDIA card; run with
``PYTHONPATH=src python -m pytest -q -s -m cuda
tests/test_torch_cuda_region_step.py``.
"""
import dataclasses
import re

import pytest
import torch

from repro_torch.configs import get_config, get_smoke
from repro_torch.core import graphs, tapir
from repro_torch.data import DataConfig, TokenPipeline, to_device
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.fused_matmul import ops as fm_ops
from repro_torch.kernels.linear_scan import ops as ls_ops
from repro_torch.models.base import get_model
from repro_torch.optim import AdamWConfig, tree_leaves
from repro_torch.train import (TrainConfig, init_state,
                               make_region_train_step, make_train_step)

pytestmark = pytest.mark.cuda
ARCHS = ("qwen2_5_3b", "rwkv6_7b")
STEPS = 3
LIBRARY = re.compile(r"gemm|gemv|xmma|nvjet|cutlass|cublas|flash_fwd|"
                     r"flash_bwd|fmha|efficient_attention|mem_eff|cudnn|sdpa",
                     re.IGNORECASE)
PORT = re.compile(r"(?<![A-Za-z_])((flash|gemm|scan|dkdv|dq)_(bf16|f32)"
                  r"_kernel|dkdv_sum_kernel|delta_kernel|scan_bwd_)")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    tapir.clear_cache()
    yield torch.device("cuda")
    tapir.clear_cache()
    torch.cuda.empty_cache()


def _model(arch, dtype="float32"):
    cfg = dataclasses.replace(get_config(arch), n_layers=2,
                              compute_dtype=dtype)
    return get_model(cfg, device="cuda",
                     generator=torch.Generator(device="cuda").manual_seed(0))


def _batches(vocab, n=STEPS):
    pipe = TokenPipeline(DataConfig(seq_len=256, global_batch=2,
                                    vocab=vocab))
    return [to_device(pipe.batch_at(s), "cuda") for s in range(n)]


def _opt():
    return AdamWConfig(lr=1e-3, total_steps=STEPS, warmup_steps=1)


def _reset():
    for m in (fm_ops, fa_ops, ls_ops):
        m.reset_counts()


def _counts() -> dict:
    return {"gemm_forward": fm_ops.launches,
            "gemm_dx": fm_ops.bwd_launches["dx"],
            "gemm_dw": fm_ops.bwd_launches["dw"],
            "flash_forward": fa_ops.launches,
            "flash_backward": fa_ops.bwd_launches,
            "scan_forward": ls_ops.launches,
            "scan_backward": ls_ops.bwd_launches}


def joint_graph_launches(g) -> dict:
    """The launches a captured step makes, from its joint graph: each
    library node once forward and once more where its VJP replays it
    (``recompute``); each GEMM's dX and dW once, and its product once more
    where its epilogue chain is not adds alone (``epilogue_vjp``)."""
    out = dict.fromkeys(("gemm_forward", "gemm_dx", "gemm_dw",
                         "flash_forward", "flash_backward", "scan_forward",
                         "scan_backward"), 0)
    kind = {"matmul": "gemm", "attention": "flash", "linear_scan": "scan"}
    for n in g.nodes.values():
        if n.op not in kind:
            continue
        k = kind[n.op]
        out[f"{k}_forward"] += 1 + (n.schedule.remat == "recompute")
        if k == "gemm":
            out["gemm_dx"] += 1
            out["gemm_dw"] += 1
            out["gemm_forward"] += any(fn != "add" for fn, _, _ in n.epilogue)
        else:
            out[f"{k}_backward"] += 1
    return out


def _graph():
    return next(g for g in tapir.cached_graphs().values()
                if getattr(g, "grad_meta", None))


def _state_leaves(state):
    return tree_leaves(state["params"]) + tree_leaves(state["opt"])


def _run(step, state, batches, counts=None):
    losses = []
    for b in batches:
        _reset()
        state, m = step(state, b)
        losses.append(m["loss"].clone())
        if counts is not None:
            counts.append(_counts())
    return state, losses


@pytest.mark.parametrize("arch", ARCHS)
def test_captured_equals_per_op_bitwise_fp32(cuda, arch):
    ref_m = _model(arch)
    batches = _batches(ref_m.cfg.vocab)
    ref_step = make_train_step(ref_m, _opt(), TrainConfig(target="gpu"))
    ref, ref_losses = _run(ref_step, init_state(ref_m, _opt()), batches)
    cap_m = _model(arch)
    cap_step = make_region_train_step(cap_m, _opt(), TrainConfig(
        target="gpu", remat="auto"))
    cap = init_state(cap_m, _opt())
    counts, ptrs, compiled = [], None, None
    losses = []
    for s, b in enumerate(batches):
        _reset()
        cap, m = cap_step(cap, b)
        losses.append(m["loss"])
        counts.append(_counts())
        if s == 0:
            ptrs = [t.data_ptr() for t in _state_leaves(cap)]
            compiled = tapir.cache_stats()["compiled_programs"]
    assert all(torch.equal(a, b) for a, b in zip(ref_losses, losses))
    assert all(torch.equal(a, b) for a, b in
               zip(_state_leaves(ref), _state_leaves(cap)))
    assert [t.data_ptr() for t in _state_leaves(cap)] == ptrs
    assert tapir.cache_stats()["compiled_programs"] == compiled
    want = joint_graph_launches(_graph())
    assert counts == [want] * STEPS, (counts, want)
    verdict = tapir.replay_rules()["train_step"]
    print(f"{arch}: launches a step {want}; graphed {verdict}; "
          f"grad_meta {_graph().grad_meta}")
    assert verdict == {False}


@pytest.mark.parametrize("arch", ARCHS)
def test_policy_none_replays_no_forward(cuda, arch):
    model = _model(arch)
    step = make_region_train_step(model, _opt(), TrainConfig(
        target="gpu", remat="none"))
    counts = []
    _run(step, init_state(model, _opt()), _batches(model.cfg.vocab, 2),
         counts)
    g = _graph()
    prods = sum(1 for n in g.nodes.values() if n.op == "matmul")
    epi = sum(1 for n in g.nodes.values() if n.op == "matmul"
              and any(fn != "add" for fn, _, _ in n.epilogue))
    n_l = model.cfg.n_layers
    assert prods == (4 * n_l + 1 if arch == "qwen2_5_3b" else 10 * n_l + 1)
    for c in counts:
        assert c["gemm_forward"] == prods + epi
        assert c["gemm_dx"] == c["gemm_dw"] == prods
        assert c["flash_forward"] + c["scan_forward"] == n_l
        assert c["flash_backward"] + c["scan_backward"] == n_l
    if arch == "qwen2_5_3b":
        assert counts[0]["gemm_forward"] == 9


@pytest.mark.parametrize("arch", ARCHS)
def test_no_library_kernel_in_a_profiled_step(cuda, arch):
    from torch.profiler import ProfilerActivity, profile
    model = _model(arch, "bfloat16")
    step = make_region_train_step(model, _opt(), TrainConfig(
        target="gpu", remat="auto"))
    state = init_state(model, _opt())
    batches = _batches(model.cfg.vocab, 2)
    state, _ = step(state, batches[0])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        state, m = step(state, batches[1])
        torch.cuda.synchronize()
    names = {e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA}
    library = sorted(n for n in names
                     if LIBRARY.search(n) and not PORT.search(n))
    assert not library, library
    assert any(PORT.search(n) for n in names)
    assert torch.isfinite(m["loss"])


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_loss_bitwise_params_close(cuda, arch):
    ref_m = _model(arch, "bfloat16")
    b = _batches(ref_m.cfg.vocab, 1)
    ref, ref_losses = _run(make_train_step(ref_m, _opt(), TrainConfig(
        target="gpu")), init_state(ref_m, _opt()), b)
    cap_m = _model(arch, "bfloat16")
    cap, losses = _run(make_region_train_step(cap_m, _opt(), TrainConfig(
        target="gpu", remat="auto")), init_state(cap_m, _opt()), b)
    assert torch.equal(ref_losses[0], losses[0])
    diffs = [float((a.double() - c.double()).abs().max())
             for a, c in zip(tree_leaves(ref["params"]),
                             tree_leaves(cap["params"]))]
    print(f"{arch} bf16: params bitwise {max(diffs) == 0.0}, max |diff| "
          f"{max(diffs)}")
    assert max(diffs) <= 2e-3


class _NoGraphs:
    pool_bytes = 0

    @staticmethod
    def accepts(vals):
        return False


@pytest.mark.parametrize("arch", ARCHS)
def test_graphed_smoke_step_equals_eager(cuda, arch, monkeypatch):
    cfg = dataclasses.replace(get_smoke(arch), compute_dtype="float32")
    pipe = TokenPipeline(DataConfig(seq_len=32, global_batch=2,
                                    vocab=cfg.vocab))
    out = {}
    for run in ("graphed", "eager"):
        tapir.clear_cache()
        if run == "eager":
            monkeypatch.setattr(graphs.CACHE, "backend", _NoGraphs())
        model = get_model(cfg, device="cuda", generator=torch.Generator(
            device="cuda").manual_seed(0))
        step = make_region_train_step(model, _opt(), TrainConfig(
            target="gpu", remat="auto"))
        counts = []
        # each batch made at its step and dropped after it, as a training
        # loop does: a batch still alive at the next step is another live
        # input, and the graph cache stays eager
        state, losses = _run(step, init_state(model, _opt()),
                             (to_device(pipe.batch_at(s), "cuda")
                              for s in range(STEPS)), counts)
        out[run] = (state, losses, counts, tapir.replay_rules()["train_step"],
                    tapir.cache_stats()["graph_replays"],
                    joint_graph_launches(_graph()))
    (gs, gl, gc, gv, gr, want), (es, el, ec, ev, er, _) = \
        out["graphed"], out["eager"]
    assert gv == {True} and gr >= 1 and er == 0
    assert all(torch.equal(a, b) for a, b in zip(gl, el))
    assert all(torch.equal(a, b) for a, b in
               zip(_state_leaves(gs), _state_leaves(es)))
    assert gc == ec == [want] * STEPS
