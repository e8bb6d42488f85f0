"""The Hopper fused-epilogue GEMM against its plain PyTorch version, on the
card.  Every test here needs an NVIDIA card and skips without one; run them
there with ``python -m pytest -q -m cuda tests/test_torch_cuda_kernels.py``.

Tolerances: fp32 runs plain FMAs in another summation order than the
plain matmul (atol/rtol 1e-4 at k <= 2048); bf16 outputs differ by at most
one bf16 rounding of values of order 10 (atol 0.125, rtol 2e-2)."""
import numpy as np
import pytest
import torch

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
