"""Training on the card: the per-op step's gradients reach every
parameter (no kernel output loses its ``grad_fn``), qwen2.5-3b's and
RWKV6-7B's (through the scan's backward kernel), and two runs give the
same bits (the embedding's scatter-add included).

The models are qwen2.5-3b's and RWKV6-7B's full widths cut to 2 layers
(d_model 2048, 16 / 2 heads of 128, d_ff 11008, vocab 151936; d_model
4096, 64 heads of 64, d_ff 14336, vocab 65536), bf16 compute over fp32
master weights, random weights from seed 0, 2 x 512 tokens of
``TokenPipeline``.
Needs an NVIDIA card; run with
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_train.py``.
"""
import dataclasses

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core import tapir
from repro_torch.data import DataConfig, TokenPipeline, to_device
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.fused_matmul import ops as fm_ops
from repro_torch.kernels.linear_scan import ops as ls_ops
from repro_torch.models.base import get_model
from repro_torch.optim import AdamWConfig, tree_leaves
from repro_torch.train import TrainConfig, init_state, make_train_step

pytestmark = pytest.mark.cuda
GPU = TrainConfig(target="gpu")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    tapir.clear_cache()
    yield torch.device("cuda")
    tapir.clear_cache()


def _model(arch: str = "qwen2_5_3b"):
    cfg = dataclasses.replace(get_config(arch), n_layers=2)
    return get_model(cfg, device="cuda",
                     generator=torch.Generator(device="cuda").manual_seed(0))


def _batch(step: int, vocab: int) -> dict:
    pipe = TokenPipeline(DataConfig(seq_len=512, global_batch=2,
                                    vocab=vocab))
    return to_device(pipe.batch_at(step), "cuda")


def test_every_parameter_gets_a_finite_gradient(cuda):
    """The fault this slice repaired: a wrapper that filled its output
    through ctypes returned a tensor with no ``grad_fn``, so nothing behind
    a GEMM or an attention got a gradient.  Every leaf must get one, finite
    and not all zero, through the kernels' own backward routes."""
    model = _model()
    fm_ops.reset_counts()
    fa_ops.reset_counts()
    with tapir.use(GPU.tapir_config()), model.trainable():
        loss = model.loss(_batch(0, model.cfg.vocab))
        assert loss.grad_fn is not None
        grads = torch.autograd.grad(loss, tree_leaves(model.param_tree()))
    for g in grads:
        assert g is not None and bool(torch.isfinite(g).all())
        assert float(g.abs().max()) > 0
    n_l = model.cfg.n_layers
    assert fm_ops.bwd_launches["dx"] == fm_ops.bwd_launches["dw"] == \
        4 * n_l + 1
    assert fa_ops.bwd_launches == n_l


def test_two_runs_of_two_steps_are_bitwise_equal(cuda):
    """Deterministic end to end: the GEMM's fixed-order split-K, the flash
    backward's fixed walk with no atomics and the embedding's sorted
    scatter-add give the same bits twice, gradients and updated weights."""
    runs = []
    for _ in range(2):
        tapir.clear_cache()
        model = _model()
        opt = AdamWConfig(total_steps=4, warmup_steps=1)
        with tapir.use(GPU.tapir_config()), model.trainable():
            loss = model.loss(_batch(0, model.cfg.vocab))
            grads = [g.clone() for g in torch.autograd.grad(
                loss, tree_leaves(model.param_tree()))]
        step = make_train_step(model, opt, GPU)
        state = init_state(model, opt)
        losses = []
        for s in range(2):
            state, m = step(state, _batch(s, model.cfg.vocab))
            losses.append(float(m["loss"]))
        runs.append((grads, losses, [p.detach().clone() for p in
                                     tree_leaves(model.param_tree())]))
        del model, state, step
    (g0, l0, p0), (g1, l1, p1) = runs
    assert l0 == l1 and l0[1] < l0[0]
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))
    assert all(torch.equal(a, b) for a, b in zip(p0, p1))


def test_rwkv_every_parameter_gets_a_finite_gradient(cuda):
    """RWKV6's loss under grad on the card: one scan backward launch a
    layer (and two forward), one dX and one dW launch a GEMM, and every leaf (the decay's
    LoRA and the bonus u through the scan's backward among them) a finite,
    non-zero gradient."""
    model = _model("rwkv6_7b")
    fm_ops.reset_counts()
    ls_ops.reset_counts()
    with tapir.use(GPU.tapir_config()), model.trainable():
        loss = model.loss(_batch(0, model.cfg.vocab))
        grads = torch.autograd.grad(loss, tree_leaves(model.param_tree()))
    for g in grads:
        assert g is not None and bool(torch.isfinite(g).all())
        assert float(g.abs().max()) > 0
    n_l = model.cfg.n_layers
    assert fm_ops.bwd_launches["dx"] == fm_ops.bwd_launches["dw"] == \
        10 * n_l + 1
    # remat full: each layer's scan runs forward again in the backward
    assert (ls_ops.launches, ls_ops.bwd_launches) == (2 * n_l, n_l)
