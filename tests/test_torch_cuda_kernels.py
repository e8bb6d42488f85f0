"""The Hopper kernels (the fused-epilogue GEMM, flash attention and the
chunked linear scan) against their plain PyTorch versions, on the card.  Every test here needs an NVIDIA
card and skips without one; run them there with
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_kernels.py``.

GEMM tolerances: fp32 runs plain FMAs in another summation order than the
plain matmul (atol/rtol 1e-4; the weights are scaled by 1/sqrt(k), so the
outputs stay of order 1 up to k = 14336); bf16 outputs differ by at most
one bf16 rounding of values of order 10 (atol 0.125, rtol 2e-2).

Flash-attention tolerances are the JAX package's own kernel tolerances
(``tests/test_kernels.py``): max abs 2e-4 in fp32 (the exponentials and
sums run in another order than the plain version's), 2e-2 in bf16 (the
output and the probabilities round to bf16).

Linear-scan tolerances are per output row (batch, position, head), each
against its own scale: the row's max of the same scan over |q|, |k|, |v|,
|u| (the sum of the magnitudes of the terms that make each output, which
bounds a sum's rounding error; a row whose terms nearly cancel has a max
|plain| far below it).  max |kernel - plain| / scale at most 1e-4 in fp32
(the prefix sums and products sum in another order) and 2e-2 in bf16 (the
output rounds once to bf16, 2^-8 of its size)."""
import numpy as np
import pytest
import torch

from repro_torch.core.ir import TaskGraph, TensorType
from repro_torch.core.lowering import emit
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.fused_matmul import kernel, ops, ref
from repro_torch.kernels.linear_scan import ops as ls_ops
from repro_torch.kernels.linear_scan import ref as ls_ref


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
                                   (200, 1000, 1003), (5, 8, 8),
                                   # the paths' narrow and split shapes
                                   (4, 4096, 64), (4096, 64, 4096),
                                   (4, 11008, 2048), (4096, 4096, 14336)])
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


#: (dtype, k, n): unsplit (256- and 128-column tiles), split (n = 64 and
#: n = 2048, deep k), padded unsplit, padded in n and k and split; fp32 split over
#: k (the LSTM cell, conv1's, conv2's and the LSTM2 head's dW, the CNN
#: head) and not (ragged k = 295; k = 64 across all three column tiles):
#: the fp32 tile follows m, so the rows cross its row-tile choices
M_STABLE = [(torch.bfloat16, 1024, 16384), (torch.bfloat16, 2048, 2560),
            (torch.bfloat16, 16384, 64), (torch.bfloat16, 11008, 2048),
            (torch.bfloat16, 1000, 1003), (torch.bfloat16, 8193, 1003),
            (torch.float32, 2048, 512), (torch.float32, 1024, 2048),
            (torch.float32, 50176, 32), (torch.float32, 12544, 64),
            (torch.float32, 9600, 61), (torch.float32, 3136, 128),
            (torch.float32, 295, 1024), (torch.float32, 64, 300)]


@pytest.mark.cuda
@pytest.mark.parametrize("dt,k,n", M_STABLE)
def test_row_result_does_not_depend_on_m(cuda, dt, k, n):
    """The plan reads (n, k, dtype), never m, and a split adds its partial
    tiles in rank order: the first rows of a 4096-row product are bitwise
    those of every smaller product, across the 64-row warpgroup and
    128-row block boundaries."""
    g = torch.Generator(device=cuda).manual_seed(2)
    x = torch.randn(4096, k, generator=g, device=cuda).to(dt)
    w = (torch.randn(k, n, generator=g, device=cuda) / k ** 0.5).to(dt)
    full = ops.fused_matmul(x, w)
    for m in (1, 4, 8, 9, 37, 63, 64, 65, 128, 129, 512, 4096):
        assert torch.equal(ops.fused_matmul(x[:m], w), full[:m]), (dt, k, n,
                                                                   m)


#: (k, n) of a fused bf16 product and the column slices [lo, hi) run
#: alone: ChatGLM3-6B's QKV and its K / V (256- beside 256-column tiles),
#: qwen2.5-3b's QKV and its K (128 beside 128), a 64-column slice (64
#: beside 256), and a deep k that splits
N_STABLE = [(4096, 4608, ((4096, 4352), (4352, 4608), (0, 64))),
            (2048, 2560, ((2048, 2304), (0, 2048))),
            (11008, 4096, ((0, 64), (1024, 1280)))]


@pytest.mark.cuda
@pytest.mark.parametrize("m", [4, 2048])
@pytest.mark.parametrize("k,n,cols", N_STABLE)
def test_column_result_does_not_depend_on_n(cuda, m, k, n, cols):
    """The bf16 split is a function of k alone (``kernel.plan``) and each
    column's sum does not depend on the tile width: a slice of the weight's
    columns run alone, with its bias, gives bitwise the fused product's
    columns, so the per-op control equals the fused path."""
    g = torch.Generator(device=cuda).manual_seed(k + n + m)
    x = torch.randn(m, k, generator=g, device=cuda).bfloat16()
    w = (torch.randn(k, n, generator=g, device=cuda) / k ** 0.5).bfloat16()
    bias = torch.randn(n, generator=g, device=cuda).bfloat16()
    fused = ops.fused_matmul(x, w, epilogue=[("add", [bias], {})])
    for lo, hi in cols:
        alone = ops.fused_matmul(x, w[:, lo:hi].contiguous(),
                                 epilogue=[("add", [bias[lo:hi]], {})])
        assert torch.equal(alone, fused[:, lo:hi]), (k, n, lo, hi)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [4, 4096])
@pytest.mark.parametrize("k,n", [(16384, 64), (11008, 2048), (8193, 1003)])
def test_split_k_result_repeats(cuda, m, k, n):
    """A split sums through distributed shared memory in a fixed order, no
    atomics: the same call twice gives the same bits."""
    assert kernel.plan(n, k, torch.bfloat16).split > 1
    g = torch.Generator(device=cuda).manual_seed(k + n)
    x = torch.randn(m, k, generator=g, device=cuda).bfloat16()
    w = (torch.randn(k, n, generator=g, device=cuda) / k ** 0.5).bfloat16()
    row = torch.randn(n, generator=g, device=cuda)
    epi = [("add", [row], {"dtype": "float32"}), ("silu", [], {})]
    first = ops.fused_matmul(x, w, epilogue=epi)
    again = ops.fused_matmul(x, w, epilogue=epi)
    torch.cuda.synchronize()
    assert torch.equal(first, again)
    want = ref.fused_matmul_ref(x, w, epilogue=epi)
    torch.testing.assert_close(first.float(), want.float(), atol=0.125,
                               rtol=2e-2)


#: fp32 (m, n, k) that split over k: the nets' single-tile long
#: contractions, the LSTM cells, and m past one row tile
F32_SPLIT = [(9, 32, 50176), (288, 64, 12544), (512, 61, 9600),
             (64, 128, 3136), (64, 2048, 1024), (64, 512, 512),
             (1000, 300, 2000)]


def _f32_operands(cuda, m, n, k, seed):
    """(generator, x [m, k], w [k, n], and the same product x @ w in the
    three layouts: the forward, dX (w stored [n, k]) and dW (x stored
    [k, m]))."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn(m, k, generator=g, device=cuda)
    w = torch.randn(k, n, generator=g, device=cuda) / k ** 0.5
    xt, wt = x.T.contiguous(), w.T.contiguous()
    layouts = [(lambda epi=None: ops.fused_matmul(x, w, epilogue=epi)),
               (lambda: ops.matmul_dx(x, wt)),
               (lambda: ops.matmul_dw(xt, w))]
    return g, x, w, layouts


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,k", F32_SPLIT)
def test_fp32_split_result_repeats(cuda, m, n, k):
    """The fp32 route's partials are added in rank order by whichever
    block arrives last: the forward with an epilogue, dX and dW give the
    same bits on two calls, and match their plain versions."""
    assert kernel.plan(n, k, torch.float32).split > 1
    g, x, w, (fwd, dx, dw) = _f32_operands(cuda, m, n, k, m + n + k)
    row = torch.randn(n, generator=g, device=cuda)
    epi = [("add", [row], {"dtype": "float32"}), ("silu", [], {})]
    bare = ref.fused_matmul_ref(x, w)
    calls = [(lambda: fwd(epi), ref.fused_matmul_ref(x, w, epilogue=epi)),
             (dx, bare), (dw, bare)]
    for fn, want in calls:
        first, again = fn(), fn()
        torch.cuda.synchronize()
        assert torch.equal(first, again)
        atol, rtol = _tol(torch.float32)
        torch.testing.assert_close(first, want, atol=atol, rtol=rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,k", [(64, 128, 3136), (9, 32, 50176),
                                   (300, 200, 1000)])
def test_fp32_fused_epilogue_equals_unfused_at_a_split(cuda, m, n, k):
    """bias + gelu fused onto the summed partials equals the bare product
    with the same chain applied after it (``apply_epilogue``) bitwise: the
    epilogue runs once, on the rank-ordered sum."""
    assert kernel.plan(n, k, torch.float32).split > 1
    g, x, w, _ = _f32_operands(cuda, m, n, k, 3 * k + n)
    bias = torch.randn(n, generator=g, device=cuda)
    epi = [("add", [bias], {"dtype": "float32"}), ("gelu", [], {})]
    fused = ops.fused_matmul(x, w, epilogue=epi)
    unfused = ref.apply_epilogue(ops.fused_matmul(x, w), epi)
    torch.cuda.synchronize()
    assert torch.equal(fused, unfused)


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,k", [(64, 2048, 1024), (9, 32, 50176),
                                   (300, 200, 1000), (512, 64, 64),
                                   (50, 70, 295)])
def test_fp32_every_tile_gives_the_same_bits(cuda, m, n, k, monkeypatch):
    """The tile decides which thread computes an element, never the order
    of its sum: every tile the library has gives the plan's bits, in all
    three layouts."""
    assert kernel.kernel_f32_tiles() == kernel.F32_TILES
    _, _, _, calls = _f32_operands(cuda, m, n, k, m * n + k)
    want = [fn() for fn in calls]
    for tile in range(len(kernel.F32_TILES)):
        monkeypatch.setattr(kernel, "f32_tile", lambda m, n, s: tile)
        for fn, ref_bits in zip(calls, want):
            assert torch.equal(fn(), ref_bits), tile


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_empty_k_gives_the_epilogue_of_zeros(cuda, dt):
    """k = 0 launches on both routes (bf16 walks one tile of zeros) and
    gives the plain version's bits: the epilogue of a zero product."""
    g = torch.Generator(device=cuda).manual_seed(5)
    x = torch.zeros(5, 0, device=cuda, dtype=dt)
    w = torch.zeros(0, 300, device=cuda, dtype=dt)
    row = torch.randn(300, generator=g, device=cuda)
    epi = [("add", [row], {"dtype": "float32"}), ("relu", [], {})]
    before = ops.launches
    got = ops.fused_matmul(x, w, epilogue=epi)
    assert ops.launches == before + 1
    assert torch.equal(got, ref.fused_matmul_ref(x, w, epilogue=epi))


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
#: and causal key lengths, one K/V head per query head and a long sequence;
#: then every 128-row / 128-key tile edge (1, 127, 128, 129 and 2112 rows
#: and keys), causal offsets that are not a multiple of 128 (1983, 128, 173)
#: and D = 24, 64, 128 on both sides of them
FA_SHAPES = [(2, 2048, 2048, 16, 2, 128, True), (4, 512, 512, 16, 2, 128, True),
             (2, 24, 24, 4, 2, 24, True), (2, 100, 300, 8, 2, 128, True),
             (2, 77, 1000, 8, 1, 128, False), (1, 1000, 1000, 4, 4, 64, True),
             (1, 8192, 8192, 16, 2, 128, True),
             (1, 1, 1, 4, 2, 64, True), (2, 127, 127, 8, 2, 64, True),
             (2, 128, 128, 8, 2, 128, False), (2, 129, 129, 8, 2, 24, True),
             (1, 129, 2112, 16, 2, 128, True),
             (1, 2112, 2112, 8, 1, 128, False), (2, 1, 129, 4, 2, 128, True),
             (1, 127, 300, 4, 1, 24, True), (2, 129, 127, 4, 2, 64, False)]


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
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_flash_plan_is_the_kernels_tiles(cuda, dt):
    """``kernel.plan``, whose tile the plain version steps over, states the
    tiles the built kernel launches, at every head dim."""
    for d in range(1, fa_kernel.MAX_HEAD_DIM + 1):
        assert fa_kernel.kernel_tiles(dt, d) == fa_kernel.plan(dt, d), d


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
def test_flash_row_result_does_not_depend_on_sq(cuda, causal):
    """The K/V tile is fixed: a query row's output is bitwise the same when
    more query rows run over the same keys.  The first s rows (causal: over
    the first s keys, so the keys the longer run adds sit after every old
    row's position and are masked for it) and, causal, the last s rows over
    all 516 keys (a causal offset of 516 - s), for s across the 64-row and
    128-row query-tile edges: a row's query tile holds other rows in the
    longer run than in the shorter."""
    for dt in (torch.bfloat16, torch.float32):
        q, k, v = _qkv(cuda, 2, 516, 516, 16, 2, 128, dt, seed=3)
        full = fa_ops.flash_attention(q, k, v, causal=causal)
        for s in (1, 127, 128, 129, 500):
            if causal:
                part = fa_ops.flash_attention(q[:, :s], k[:, :s], v[:, :s],
                                              causal=True)
                tail = fa_ops.flash_attention(q[:, -s:], k, v, causal=True)
                assert torch.equal(tail, full[:, -s:]), (dt, s, "offset")
            else:
                part = fa_ops.flash_attention(q[:, :s], k, v, causal=False)
            assert torch.equal(part, full[:, :s]), (dt, s)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 2048, 2048, 16, 2, 128, True),
                                   (1, 129, 2112, 16, 2, 128, True),
                                   (2, 77, 1000, 8, 1, 24, False)])
def test_flash_result_repeats(cuda, dt, shape):
    """No atomics and a fixed reduction order: the same call twice gives
    the same bits."""
    *dims, causal = shape
    q, k, v = _qkv(cuda, *dims, dt, seed=6)
    first = fa_ops.flash_attention(q, k, v, causal=causal)
    again = fa_ops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert torch.equal(first, again)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["head_dim_20", "misaligned_base",
                                    "odd_row_stride"])
def test_flash_copies_a_layout_tma_cannot_address(cuda, layout):
    """bf16 inputs that TMA cannot read in place (D % 8 != 0, a base off
    16 bytes, rows of an odd number of elements) are copied into a layout
    it can, then take the same kernel: one launch, within tolerance of the
    plain version on the original tensors."""
    g = torch.Generator(device=cuda).manual_seed(9)
    d = 20 if layout == "head_dim_20" else 64
    pad = 3 if layout == "odd_row_stride" else 0   # elements past D a row

    def make(s, h):
        n = 2 * s * h * (d + pad)
        t = torch.randn(n + 1, generator=g, device=cuda).bfloat16()
        if layout == "misaligned_base":
            return t[1:].view(2, s, h, d)
        return t[:n].view(2, s, h, d + pad)[..., :d]
    q, k, v = make(100, 8), make(150, 2), make(150, 2)
    before = fa_ops.launches
    o = fa_ops.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert fa_ops.launches == before + 1
    want = fa_ref.flash_attention_ref(q, k, v, causal=True)
    assert o.shape == q.shape and o.is_contiguous()
    assert float((o.float() - want.float()).abs().max()) <= FA_TOL[
        torch.bfloat16]


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


# -- chunked linear scan -----------------------------------------------------

LS_RTOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
#: RWKV6's decay clip: log w >= -exp(2)
CLIP_W = float(np.exp(-np.exp(2.0)))
#: (B, S, H, Dk, Dv, chunk, decay): the RWKV6-7B forward and prefill, SMOKE,
#: the reference sweep's shapes, S < C, ragged S, and the decay clip in
#: every position ("clip") at short and long S
LS_SHAPES = [(2, 2048, 64, 64, 64, 16, "model"), (4, 512, 64, 64, 64, 16,
                                                   "model"),
             (2, 25, 4, 16, 16, 16, "model"), (2, 37, 2, 16, 48, 16, "uniform"),
             (2, 128, 2, 64, 64, 8, "uniform"), (2, 16, 2, 8, 8, 16,
                                                 "uniform"),
             (2, 3, 4, 64, 64, 16, "model"), (1, 100, 8, 64, 64, 16, "model"),
             (1, 1000, 8, 64, 64, 16, "model"), (2, 37, 4, 64, 64, 16, "clip"),
             (1, 2048, 8, 64, 64, 16, "clip")]


def _scan_inputs(cuda, b, s, h, dk, dv, decay, dt, seed):
    """q/k/v in ``dt``, w and u in fp32.  ``model``: the RWKV6 decay of a
    clipped log-log weight in [-8, 2]; ``uniform``: the reference sweep's
    exp(U(-7.3, 0)); ``clip``: exp(-e^2) everywhere."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    q, k = (torch.randn(b, s, h, dk, generator=g, device=cuda).to(dt)
            for _ in range(2))
    v = torch.randn(b, s, h, dv, generator=g, device=cuda).to(dt)
    r = torch.rand(b, s, h, dk, generator=g, device=cuda)
    if decay == "model":
        w = torch.exp(-torch.exp(-8.0 + 10.0 * r))
    elif decay == "uniform":
        w = torch.exp(-7.3 * r - 1e-3)
    else:
        w = torch.full((b, s, h, dk), CLIP_W, device=cuda)
    u = torch.randn(h, dk, generator=g, device=cuda)
    return q, k, v, w, u


def _row_rel(o, want, q, k, v, w, u, chunk=16):
    """max over rows of max |o - want| / the row's magnitude scale."""
    scale = ls_ref.linear_scan_chunked(
        q.float().abs(), k.float().abs(), v.float().abs(), w,
        u=None if u is None else u.abs(), chunk=chunk).amax(-1)
    diff = (o.float() - want.float()).abs().amax(-1)
    return float((diff / scale.clamp_min(1e-30)).max())


@pytest.mark.cuda
@pytest.mark.parametrize("rwkv", [True, False])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", LS_SHAPES)
def test_scan_kernel_matches_plain(cuda, dt, rwkv, shape):
    b, s, h, dk, dv, chunk, decay = shape
    q, k, v, w, u = _scan_inputs(cuda, b, s, h, dk, dv, decay, dt,
                                 seed=s + dk + dv)
    u = u if rwkv else None
    before = ls_ops.launches
    o = ls_ops.linear_scan(q, k, v, w, u=u, chunk=chunk)
    torch.cuda.synchronize()
    assert ls_ops.launches == before + 1
    want = ls_ref.linear_scan_chunked(q, k, v, w, u=u, chunk=chunk)
    assert o.shape == v.shape and o.dtype == dt
    assert bool(torch.isfinite(o).all())
    rel = _row_rel(o, want, q, k, v, w, u, chunk)
    assert rel <= LS_RTOL[dt], rel


@pytest.mark.cuda
def test_scan_row_result_does_not_depend_on_the_batch(cuda):
    """Rows of different batch entries never interact and every reduction
    runs in a fixed order: a batch entry's output is bitwise the same alone
    and inside a batch of three."""
    for dt in (torch.bfloat16, torch.float32):
        q, k, v, w, u = _scan_inputs(cuda, 3, 300, 4, 64, 64, "model", dt,
                                     seed=7)
        full = ls_ops.linear_scan(q, k, v, w, u=u)
        one = ls_ops.linear_scan(q[1:2], k[1:2], v[1:2], w[1:2], u=u)
        assert torch.equal(one, full[1:2]), dt


def _state_row_rel(st, want, q, k, v, w, u, s0, chunk=16):
    """max over (batch, head, key) rows of the final carry of max |st -
    want| / the row's magnitude scale (the same scan over |k|, |v| and
    |init_state|)."""
    _, scale = ls_ref.linear_scan_chunked(
        q.float().abs(), k.float().abs(), v.float().abs(), w,
        u=None if u is None else u.abs(), chunk=chunk,
        init_state=s0.abs(), return_state=True)
    diff = (st - want).abs().amax(-1)
    return float((diff / scale.amax(-1).clamp_min(1e-30)).max())


#: (B, S, H, Dk, Dv, decay) of the carried-state variant: the RWKV6-7B
#: stateful prefill and decode step, ragged S, small Dk/Dv and the clip
LS_STATE_SHAPES = [(4, 512, 64, 64, 64, "model"), (4, 1, 64, 64, 64, "model"),
                   (2, 37, 4, 64, 64, "model"), (2, 25, 4, 16, 48, "uniform"),
                   (2, 100, 4, 64, 64, "clip")]


@pytest.mark.cuda
@pytest.mark.parametrize("rwkv", [True, False])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", LS_STATE_SHAPES)
def test_scan_state_variant_matches_plain(cuda, dt, rwkv, shape):
    """``init_state`` (non-zero) in, the final carry out: the outputs and
    the carry against the plain chunked form under ``LS_RTOL``."""
    b, s, h, dk, dv, decay = shape
    q, k, v, w, u = _scan_inputs(cuda, b, s, h, dk, dv, decay, dt,
                                 seed=3 * s + dv)
    u = u if rwkv else None
    g = torch.Generator(device=cuda).manual_seed(s)
    s0 = torch.randn(b, h, dk, dv, generator=g, device=cuda)
    before = ls_ops.launches
    o, st = ls_ops.linear_scan(q, k, v, w, u=u, init_state=s0,
                               return_state=True)
    torch.cuda.synchronize()
    assert ls_ops.launches == before + 1
    want, want_st = ls_ref.linear_scan_chunked(q, k, v, w, u=u,
                                               init_state=s0,
                                               return_state=True)
    assert o.shape == v.shape and o.dtype == dt
    assert st.shape == s0.shape and st.dtype == torch.float32
    assert bool(torch.isfinite(o).all()) and bool(torch.isfinite(st).all())
    scale = ls_ref.linear_scan_chunked(
        q.float().abs(), k.float().abs(), v.float().abs(), w,
        u=None if u is None else u.abs(), init_state=s0.abs()).amax(-1)
    diff = (o.float() - want.float()).abs().amax(-1)
    assert float((diff / scale.clamp_min(1e-30)).max()) <= LS_RTOL[dt]
    assert _state_row_rel(st, want_st, q, k, v, w, u, s0) <= LS_RTOL[dt]


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_scan_chained_calls_match_one_long_call(cuda, dt):
    """A prefill of 512 rows then 16 single-row steps, the carry handed
    from call to call, against one call over all 528 rows (``LS_RTOL``);
    split on a chunk boundary instead (512 + 16 rows), the two calls run
    the one call's chunks in its order and agree bitwise."""
    q, k, v, w, u = _scan_inputs(cuda, 2, 528, 8, 64, 64, "model", dt,
                                 seed=12)
    whole, st_whole = ls_ops.linear_scan(q, k, v, w, u=u, return_state=True)
    outs = []
    o, st = ls_ops.linear_scan(q[:, :512], k[:, :512], v[:, :512],
                               w[:, :512], u=u, return_state=True)
    outs.append(o)
    for t in range(512, 528):
        o, st = ls_ops.linear_scan(q[:, t:t + 1], k[:, t:t + 1],
                                   v[:, t:t + 1], w[:, t:t + 1], u=u,
                                   init_state=st, return_state=True)
        outs.append(o)
    got = torch.cat(outs, dim=1)
    assert _row_rel(got, whole, q, k, v, w, u) <= LS_RTOL[dt]
    zero = torch.zeros_like(st)
    assert _state_row_rel(st, st_whole, q, k, v, w, u, zero) <= LS_RTOL[dt]
    o1, st1 = ls_ops.linear_scan(q[:, :512], k[:, :512], v[:, :512],
                                 w[:, :512], u=u, return_state=True)
    o2, st2 = ls_ops.linear_scan(q[:, 512:], k[:, 512:], v[:, 512:],
                                 w[:, 512:], u=u, init_state=st1,
                                 return_state=True)
    assert torch.equal(torch.cat([o1, o2], dim=1), whole)
    assert torch.equal(st2, st_whole)


@pytest.mark.cuda
def test_scan_state_row_result_does_not_depend_on_the_batch(cuda):
    """The state variant's outputs and final carry of one batch entry are
    bitwise the same alone and inside a batch of three."""
    for dt in (torch.bfloat16, torch.float32):
        q, k, v, w, u = _scan_inputs(cuda, 3, 300, 4, 64, 64, "model", dt,
                                     seed=17)
        g = torch.Generator(device=cuda).manual_seed(4)
        s0 = torch.randn(3, 4, 64, 64, generator=g, device=cuda)
        full, st_full = ls_ops.linear_scan(q, k, v, w, u=u, init_state=s0,
                                           return_state=True)
        one, st_one = ls_ops.linear_scan(q[1:2], k[1:2], v[1:2], w[1:2], u=u,
                                         init_state=s0[1:2],
                                         return_state=True)
        assert torch.equal(one, full[1:2]), dt
        assert torch.equal(st_one, st_full[1:2]), dt


@pytest.mark.cuda
def test_scan_wrapper_raises_instead_of_falling_back(cuda):
    q, k, v, w, u = _scan_inputs(cuda, 1, 40, 2, 64, 64, "model",
                                 torch.bfloat16, seed=8)
    with pytest.raises(ValueError, match="chunk"):
        ls_ops.linear_scan(q, k, v, w, u=u, chunk=17)
    with pytest.raises(ValueError):
        ls_ops.linear_scan(q, k, v, w.bfloat16(), u=u)
    with pytest.raises(ValueError):
        ls_ops.linear_scan(q, k, v, w, u=u.bfloat16())
    with pytest.raises(ValueError):
        ls_ops.linear_scan(q.half(), k.half(), v.half(), w, u=u)
    with pytest.raises(ValueError):
        ls_ops.linear_scan(q, k.float(), v, w, u=u)
    big = torch.zeros(1, 8, 2, 128, device=cuda)
    with pytest.raises(ValueError, match="Dk"):
        ls_ops.linear_scan(big, big, big, big + 0.5)
    s0 = torch.zeros(1, 2, 64, 64, device=cuda)
    with pytest.raises(ValueError, match="init_state"):
        ls_ops.linear_scan(q, k, v, w, u=u, init_state=s0[..., :32])
    with pytest.raises(ValueError, match="init_state"):
        ls_ops.linear_scan(q, k, v, w, u=u, init_state=s0.bfloat16())
    before = ls_ops.launches
    assert torch.isfinite(ls_ops.linear_scan(q, k, v, w, u=u)).all()
    assert ls_ops.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("impl", ["chunked", "ref"])
def test_plain_scan_impls_raise_on_the_card(cuda, impl):
    """Lowering a scan node bound to a plain composite raises on a CUDA
    tensor: on the card the scan runs only in the kernel."""
    g = TaskGraph("scan")
    t = TensorType((1, 40, 2, 64), "float32")
    ins = [g.add_input(n, t) for n in "qkvw"]
    ins.append(g.add_input("u", TensorType((2, 64), "float32")))
    s_ = g.add("linear_scan", tuple(ins), t, pdims=(0, 2),
               rdims=(("seq", 40),), seq=40, variant="rwkv6")
    g.set_outputs([s_])
    g.nodes[s_].schedule.impl = impl
    q, k, v, w, u = _scan_inputs(cuda, 1, 40, 2, 64, 64, "model",
                                 torch.float32, seed=9)
    feed = {"q": q, "k": k, "v": v, "w": w, "u": u}
    with pytest.raises(NotImplementedError):
        emit(g)(feed)
    for ok in ("kernel", "opaque"):
        g.nodes[s_].schedule.impl = ok
        before = ls_ops.launches
        (o,) = emit(g)(feed)
        assert ls_ops.launches == before + 1
        want = ls_ref.linear_scan_chunked(q, k, v, w, u=u)
        assert _row_rel(o, want, q, k, v, w, u) <= LS_RTOL[torch.float32]
