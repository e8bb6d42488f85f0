"""The port's plain attention versions (``attention_ref``, the JAX package's
oracle, and ``flash_attention_ref``, the Hopper kernel's own tiled
arithmetic) against the JAX package's flash attention on the CPU: its
Pallas kernel in interpret mode through ``ops.flash_attention`` and its
oracle ``ref.attention_ref``.

Inputs are made with numpy from a seed and handed to both packages.
Tolerances are the JAX package's own kernel tolerances
(``tests/test_kernels.py``): max abs 2e-4 in fp32 (exponentials and sums
in another order), 2e-2 in bf16 (probabilities and output round to bf16).
"""
import inspect
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ops as j_ops
from repro.kernels.flash_attention import ref as j_ref
from repro_torch.core.ir import TaskGraph, TensorType
from repro_torch.core.lowering import emit
from repro_torch.kernels.flash_attention import kernel, ops, ref

TOL = {"float32": 2e-4, "bfloat16": 2e-2}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small CPU tensors: one intra-op thread per test process, so parallel
    test workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

#: (B, Sq, Skv, Hq, Hkv, D, causal): Sq == Skv, Sq < Skv (causal queries at
#: the end of the keys), ragged lengths off every tile, GQA groups 1, 2, 8;
#: the last three span two 128-key tiles (a ragged second tile, causal and
#: not, a causal offset of 190 keys)
SHAPES = [
    (2, 64, 64, 4, 4, 32, True),
    (2, 64, 64, 4, 2, 32, False),
    (1, 100, 100, 8, 1, 24, True),
    (2, 40, 130, 4, 2, 16, True),
    (1, 77, 150, 8, 1, 32, False),
    (2, 1, 70, 4, 2, 24, True),
    (1, 130, 130, 2, 1, 48, False),
    (1, 200, 200, 4, 2, 32, True),
    (2, 60, 250, 4, 1, 24, True),
    (1, 60, 250, 4, 2, 32, False),
]


def _inputs(shape, dtype, seed):
    b, sq, skv, hq, hkv, d, _ = shape
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((b, sq, hq, d), (b, skv, hkv, d), (b, skv, hkv, d))]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    t = [torch.from_numpy(a).to(tdt) for a in arrs]
    # the bf16 values both packages see are the same: round once in torch
    j = [jnp.asarray(x.float().numpy()).astype(dtype) for x in t]
    return t, j


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_versions_match_the_reference(shape, dtype):
    """Both plain versions against the JAX package's Pallas kernel
    (interpret mode) at the tiles of the route the call takes
    (``kernel.plan``: 128 x 128 in bf16, 64 x 64 in fp32) and its oracle."""
    causal = shape[-1]
    (q, k, v), (jq, jk, jv) = _inputs(shape, dtype, seed=sum(shape[:-1]))
    tiles = kernel.plan(q.dtype, shape[5])
    want_kernel = _np(j_ops.flash_attention(jq, jk, jv, causal=causal,
                                            block_q=tiles.block_q,
                                            block_kv=tiles.block_kv,
                                            interpret=True))
    want_oracle = _np(j_ref.attention_ref(jq, jk, jv, causal=causal))
    flash = ref.flash_attention_ref(q, k, v, causal=causal)
    oracle = ref.attention_ref(q, k, v, causal=causal)
    assert flash.dtype == q.dtype and oracle.dtype == q.dtype
    assert flash.shape == q.shape
    tol = TOL[dtype]
    for got in (flash, oracle):
        for want in (want_kernel, want_oracle):
            np.testing.assert_allclose(_np(got), want, atol=tol, rtol=0)


def test_wrapper_on_cpu_is_the_plain_version_and_counts_nothing():
    """A CPU tensor takes ``flash_attention_ref``; the launch count moves
    only where the kernel launches."""
    (q, k, v), _ = _inputs((2, 33, 90, 4, 2, 24, True), "float32", seed=1)
    before = ops.launches
    out = ops.flash_attention(q, k, v, causal=True)
    assert ops.launches == before
    assert torch.equal(out, ref.flash_attention_ref(q, k, v, causal=True))


def test_bias_on_cpu_takes_the_oracle_as_the_reference_does():
    shape = (1, 16, 16, 4, 2, 16, False)
    (q, k, v), (jq, jk, jv) = _inputs(shape, "float32", seed=2)
    bias = np.random.default_rng(3).standard_normal((1, 4, 16, 16)).astype(
        np.float32)
    got = ops.flash_attention(q, k, v, bias=torch.from_numpy(bias))
    want = _np(j_ops.flash_attention(jq, jk, jv, bias=jnp.asarray(bias),
                                     interpret=True))
    np.testing.assert_allclose(_np(got), want, atol=2e-4, rtol=0)


@pytest.mark.parametrize("impl", ["materialized_repeat",
                                  "materialized_grouped", "ref"])
def test_plain_attention_impls_lower_to_the_oracle_on_cpu(impl):
    """A biased attention node (the kernel has no bias operand) bound to any
    plain composite lowers, on a CPU tensor, to the JAX package's oracle
    (2e-4 in fp32)."""
    shape = (1, 16, 16, 4, 2, 16, True)
    (q, k, v), (jq, jk, jv) = _inputs(shape, "float32", seed=4)
    bias = np.random.default_rng(5).standard_normal((1, 4, 16, 16)).astype(
        np.float32)
    g = TaskGraph("attn_bias")
    ins = [g.add_input(n, TensorType(tuple(t.shape), "float32"))
           for n, t in zip("qkv", (q, k, v))]
    ins.append(g.add_input("bias", TensorType(bias.shape, "float32")))
    a = g.add("attention", tuple(ins), TensorType(tuple(q.shape), "float32"),
              pdims=(0, 1, 2), causal=True, q_shape=tuple(q.shape),
              kv_len=16, kv_heads=2)
    g.set_outputs([a])
    g.nodes[a].schedule.impl = impl
    (got,) = emit(g)({"q": q, "k": k, "v": v,
                      "bias": torch.from_numpy(bias)})
    want = _np(j_ref.attention_ref(jq, jk, jv, causal=True,
                                   bias=jnp.asarray(bias)))
    np.testing.assert_allclose(_np(got), want, atol=2e-4, rtol=0)


# -- the route and tile plan ---------------------------------------------------


def test_plan_reads_dtype_and_head_dim_only():
    """The route and tiles are a function of (dtype, D) (alignment is
    ``tma_operand``'s, below), never of B, Sq or Skv: a query row's K/V
    tiles are the same set in the same order however many rows run."""
    assert list(inspect.signature(kernel.plan).parameters) == ["dtype", "d"]
    for d in range(1, kernel.MAX_HEAD_DIM + 1):
        bf = kernel.plan(torch.bfloat16, d)
        assert bf == ("wgmma", 128, 128, 64 if d <= 64 else 128, True)
        f32 = kernel.plan(torch.float32, d)
        assert f32 == ("fma", 64, 64, 32 if d <= 32 else 64 if d <= 64
                       else 128, False)
        assert kernel.score_scale(torch.bfloat16, d) == (
            1.0 / math.sqrt(d) * math.log2(math.e))
        assert kernel.score_scale(torch.float32, d) == 1.0 / math.sqrt(d)


@pytest.mark.parametrize("d", [24, 64, 128])
def test_tma_operand_keeps_an_addressable_layout(d):
    """A contiguous tensor, a head slice of a wider one (strides a multiple
    of 8 elements, base 16-byte aligned) and a size-1 batch with an odd
    stride are read in place."""
    t = torch.zeros(2, 5, 6, d, dtype=torch.bfloat16)
    assert kernel.tma_operand(t) is t
    wide = torch.zeros(2, 5, 6, d, dtype=torch.bfloat16)[:, :, 2:]
    assert kernel.tma_operand(wide) is wide
    one = torch.zeros(7, 5, 6, d, dtype=torch.bfloat16).as_strided(
        (1, 5, 6, d), (3, 6 * d, d, 1))
    assert kernel.tma_operand(one) is one
    assert kernel.strides(one) == (5 * 6 * d, 6 * d, d)


def test_tma_operand_copies_what_tma_cannot_address():
    """D % 8 != 0 is zero-padded to a multiple of 8; a misaligned base or
    stride is copied.  The values and the zero padding are exact, so the
    kernel's scores do not change."""
    rng = np.random.default_rng(6)
    t = torch.from_numpy(rng.standard_normal((2, 5, 3, 20)).astype(
        np.float32)).bfloat16()
    out = kernel.tma_operand(t)
    assert out.shape == (2, 5, 3, 24)
    assert torch.equal(out[..., :20], t)
    assert not out[..., 20:].any()
    base = torch.from_numpy(rng.standard_normal(2 * 5 * 3 * 64 + 1).astype(
        np.float32)).bfloat16()
    shifted = base[1:].view(2, 5, 3, 64)          # base off by 2 bytes
    out = kernel.tma_operand(shifted)
    assert out is not shifted and torch.equal(out, shifted)
    assert out.data_ptr() % 16 == 0
    odd = torch.zeros(2, 5, 3, 68, dtype=torch.bfloat16)[..., :64]
    out = kernel.tma_operand(odd)                 # rows of 68 elements
    assert out is not odd and torch.equal(out, odd)
    assert all(s % kernel.ALIGN == 0 for s in kernel.strides(out))
