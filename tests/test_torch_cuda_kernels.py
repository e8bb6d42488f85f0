"""The Hopper kernels (the fused-epilogue GEMM and flash attention) against
their plain PyTorch versions, on the card.  Every test here needs an NVIDIA
card and skips without one; run them there with
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_kernels.py``.

GEMM tolerances: fp32 runs plain FMAs in another summation order than the
plain matmul (atol/rtol 1e-4 at k <= 2048); bf16 outputs differ by at most
one bf16 rounding of values of order 10 (atol 0.125, rtol 2e-2).

Flash-attention tolerances are the JAX package's own kernel tolerances
(``tests/test_kernels.py``): max abs 2e-4 in fp32 (the exponentials and
sums run in another order than the plain version's), 2e-2 in bf16 (the
output and the probabilities round to bf16)."""
import numpy as np
import pytest
import torch

from repro_torch.core.ir import TaskGraph, TensorType
from repro_torch.core.lowering import emit
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.fused_matmul import kernel, ops, ref


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def _tol(dt):
    return (1e-4, 1e-4) if dt == torch.float32 else (0.125, 2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n", [(1, 64, 64), (4, 2048, 2560),
                                   (37, 100, 300), (128, 96, 200),
                                   (200, 1000, 1003), (5, 8, 8)])
def test_kernel_matches_plain(cuda, dt, m, k, n):
    g = torch.Generator(device=cuda).manual_seed(m * 131 + k * 7 + n)
    x = torch.randn(m, k, generator=g, device=cuda).to(dt)
    w = (torch.randn(k, n, generator=g, device=cuda) / k ** 0.5).to(dt)
    before = ops.launches
    y = ops.fused_matmul(x, w, out_dtype=dt)
    torch.cuda.synchronize()
    assert ops.launches == before + 1
    want = ref.fused_matmul_ref(x, w, out_dtype=dt)
    atol, rtol = _tol(dt)
    torch.testing.assert_close(y.float(), want.float(), atol=atol, rtol=rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_every_epilogue_fn_and_kind(cuda, dt):
    g = torch.Generator(device=cuda).manual_seed(0)
    m, k, n = 70, 96, 136
    x = torch.randn(m, k, generator=g, device=cuda).to(dt)
    w = (torch.randn(k, n, generator=g, device=cuda) / k ** 0.5).to(dt)
    row = torch.rand(n, generator=g, device=cuda).to(dt) + 0.5
    full = torch.rand(m, n, generator=g, device=cuda).to(dt) + 0.5
    shift = torch.full((n,), 8.0, device=cuda, dtype=dt)
    atol, rtol = _tol(dt)
    for fn in kernel.FN:
        for kind, vals in (("none", []), ("row", [row]), ("full", [full])):
            unary = fn in ("neg", "exp", "square", "tanh", "sigmoid", "relu",
                           "gelu", "silu")
            if unary != (kind == "none"):
                continue
            for hp in ((0,) if unary else (0, 1)):
                epi = [(fn, vals, {"head_pos": hp})]
                if fn == "div" and hp == 1:
                    # keep the divisor away from 0, where the two sum
                    # orders' last-bit difference is amplified without bound
                    epi.insert(0, ("add", [shift], {}))
                y = ops.fused_matmul(x, w, epilogue=epi, out_dtype=dt)
                want = ref.fused_matmul_ref(x, w, epilogue=epi, out_dtype=dt)
                torch.cuda.synchronize()
                torch.testing.assert_close(
                    y.float(), want.float(), atol=atol, rtol=rtol,
                    msg=lambda s: f"{fn}/{kind}/head_pos={hp}: {s}")


@pytest.mark.cuda
def test_chain_with_stage_casts_and_mixed_operands(cuda):
    """unary, row and full stages, head_pos=1 and a bf16 stage cast after an
    fp32 stage, fp32 operands on a bf16 GEMM."""
    g = torch.Generator(device=cuda).manual_seed(1)
    m, k, n = 33, 200, 72
    x = torch.randn(m, k, generator=g, device=cuda).bfloat16()
    w = (torch.randn(k, n, generator=g, device=cuda) / k ** 0.5).bfloat16()
    bias = torch.randn(n, generator=g, device=cuda)
    res = torch.randn(m, n, generator=g, device=cuda).bfloat16()
    epi = [("add", [bias], {"dtype": "float32"}),
           ("silu", [], {}),
           ("add", [res], {"head_pos": 1, "dtype": "bfloat16"}),
           ("mul", [bias], {})]
    for out in (torch.bfloat16, torch.float32):
        y = ops.fused_matmul(x, w, epilogue=epi, out_dtype=out)
        want = ref.fused_matmul_ref(x, w, epilogue=epi, out_dtype=out)
        torch.cuda.synchronize()
        torch.testing.assert_close(y.float(), want.float(), atol=0.125,
                                   rtol=2e-2)


@pytest.mark.cuda
def test_row_result_does_not_depend_on_m(cuda):
    """The k-reduction order of a row is fixed: the first rows of a
    512-row product are bitwise those of a 1-, 4- or 37-row product."""
    g = torch.Generator(device=cuda).manual_seed(2)
    for dt in (torch.bfloat16, torch.float32):
        x = torch.randn(512, 2048, generator=g, device=cuda).to(dt)
        w = torch.randn(2048, 512, generator=g, device=cuda).to(dt)
        full = ops.fused_matmul(x, w)
        for m in (1, 4, 37, 256):
            assert torch.equal(ops.fused_matmul(x[:m], w), full[:m]), (dt, m)


@pytest.mark.cuda
def test_wrapper_raises_instead_of_falling_back(cuda):
    x = torch.randn(4, 8, device=cuda, dtype=torch.float16)
    with pytest.raises(ValueError):
        ops.fused_matmul(x, x.new_zeros(8, 8))
    x = torch.randn(4, 8, device=cuda)
    with pytest.raises(ValueError):
        ops.fused_matmul(x, torch.zeros(8, 8, device=cuda).bfloat16())
    stages = [("relu", [], {})] * (kernel.MAX_STAGES + 1)
    with pytest.raises(ValueError):
        ops.fused_matmul(x, torch.zeros(8, 8, device=cuda), epilogue=stages)
    assert np.isfinite(ops.fused_matmul(x, torch.zeros(8, 8, device=cuda))
                       .cpu().numpy()).all()


# -- flash attention ----------------------------------------------------------

FA_TOL = {torch.float32: 2e-4, torch.bfloat16: 2e-2}
#: each (batch, query, head) row's max |kernel - plain| over its own max
#: |plain|: late causal rows are about as small as the bf16 bound above
FA_RTOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
#: (B, Sq, Skv, Hq, Hkv, D, causal): the full-width forward and padded
#: prefill of qwen2.5-3b, SMOKE, a causal query offset, ragged non-causal
#: and causal key lengths, one K/V head per query head and a long sequence
FA_SHAPES = [(2, 2048, 2048, 16, 2, 128, True), (4, 512, 512, 16, 2, 128, True),
             (2, 24, 24, 4, 2, 24, True), (2, 100, 300, 8, 2, 128, True),
             (2, 77, 1000, 8, 1, 128, False), (1, 1000, 1000, 4, 4, 64, True),
             (1, 8192, 8192, 16, 2, 128, True)]


def _qkv(cuda, b, sq, skv, hq, hkv, d, dt, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    q = torch.randn(b, sq, hq, d, generator=g, device=cuda).to(dt)
    k = torch.randn(b, skv, hkv, d, generator=g, device=cuda).to(dt)
    v = torch.randn(b, skv, hkv, d, generator=g, device=cuda).to(dt)
    return q, k, v


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", FA_SHAPES)
def test_flash_kernel_matches_plain(cuda, dt, shape):
    *dims, causal = shape
    q, k, v = _qkv(cuda, *dims, dt, seed=sum(dims))
    before = fa_ops.launches
    o = fa_ops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa_ops.launches == before + 1
    want = fa_ref.flash_attention_ref(q, k, v, causal=causal)
    assert o.shape == q.shape and o.dtype == dt
    diff = (o.float() - want.float()).abs()
    err = float(diff.max())
    assert err <= FA_TOL[dt], err
    rel = float((diff.amax(-1) / want.float().abs().amax(-1)).max())
    assert rel <= FA_RTOL[dt], rel


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
def test_flash_row_result_does_not_depend_on_sq(cuda, causal):
    """The K/V tile is fixed: a query row's output is bitwise the same when
    16 more query rows run over the same keys (causal: the 16 new keys sit
    after every old row's position, so they are masked for it)."""
    for dt in (torch.bfloat16, torch.float32):
        # 500 is not a multiple of the 64-row query tile: the query tile
        # holding rows 448-499 also holds rows 500-511 in the longer run
        q, k, v = _qkv(cuda, 2, 516, 516, 16, 2, 128, dt, seed=3)
        s = 500
        full = fa_ops.flash_attention(q, k, v, causal=causal)
        if causal:
            part = fa_ops.flash_attention(q[:, :s], k[:, :s], v[:, :s],
                                          causal=True)
        else:
            part = fa_ops.flash_attention(q[:, :s], k, v, causal=False)
        assert torch.equal(part, full[:, :s]), dt


@pytest.mark.cuda
def test_flash_wrapper_raises_instead_of_falling_back(cuda):
    q, k, v = _qkv(cuda, 1, 8, 8, 4, 2, 64, torch.float32, seed=4)
    with pytest.raises(ValueError):
        fa_ops.flash_attention(q, k, v, bias=torch.zeros(1, 4, 8, 8,
                                                         device=cuda))
    with pytest.raises(ValueError):
        fa_ops.flash_attention(q, k[:, :4], v[:, :4], causal=True)
    with pytest.raises(ValueError):
        fa_ops.flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError):
        fa_ops.flash_attention(torch.zeros(1, 8, 4, 256, device=cuda),
                               torch.zeros(1, 8, 2, 256, device=cuda),
                               torch.zeros(1, 8, 2, 256, device=cuda))
    before = fa_ops.launches
    assert torch.isfinite(fa_ops.flash_attention(q, k, v, causal=True)).all()
    assert fa_ops.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("impl", ["materialized_repeat",
                                  "materialized_grouped", "ref"])
def test_plain_attention_impls_raise_on_the_card(cuda, impl):
    """Lowering an attention node bound to a plain composite raises on a
    CUDA tensor: on the card attention runs only in the kernel."""
    g = TaskGraph("attn")
    ins = [g.add_input(n, TensorType((1, 8, 4 if n == "q" else 2, 64),
                                     "float32")) for n in "qkv"]
    a = g.add("attention", tuple(ins), TensorType((1, 8, 4, 64), "float32"),
              pdims=(0, 1, 2), causal=True, q_shape=(1, 8, 4, 64), kv_len=8,
              kv_heads=2)
    g.set_outputs([a])
    g.nodes[a].schedule.impl = impl
    q, k, v = _qkv(cuda, 1, 8, 8, 4, 2, 64, torch.float32, seed=5)
    with pytest.raises(NotImplementedError):
        emit(g)({"q": q, "k": k, "v": v})
    for ok in ("flash_kernel", "opaque"):
        g.nodes[a].schedule.impl = ok
        before = fa_ops.launches
        (o,) = emit(g)({"q": q, "k": k, "v": v})
        assert fa_ops.launches == before + 1
        torch.testing.assert_close(
            o, fa_ref.flash_attention_ref(q, k, v, causal=True),
            atol=2e-4, rtol=0)
