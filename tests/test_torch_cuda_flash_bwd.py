"""The flash backward's kernels (``csrc/flash_attention_bwd.cu``) against
their plain version ``ref.flash_attention_bwd_ref`` on the card.  Every
test here needs an NVIDIA card and skips without one; run them there with
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_flash_bwd.py``.

Tolerance (``chip_smoke.py``'s BWD_RTOL): each gradient's max |kernel -
plain| over its own max |plain|, 2e-2 in bf16 (the kernels round P and dS
to bf16 for their products and each gradient to bf16 once, a few bf16
ulps of the largest entry) and 1e-4 in fp32 (sums in another order than
the plain version's).
"""
import pytest
import torch

from repro_torch.kernels.flash_attention import kernel, ops, ref

pytestmark = pytest.mark.cuda

RTOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
#: (B, Sq, Skv, Hq, Hkv, D, causal): qwen2.5-3b's train shape, SMOKE, then
#: ragged lengths one past every tile and unit edge (129 and 257 rows and
#: keys), causal Skv > Sq off every edge, GQA groups 1, 3 and 8, D = 24,
#: 64 and 128, and a single query row over 70 keys (with one key, dQ and
#: dK would be zero but for rounding: nothing to hold them to); then
#: Zamba2-7B's shared block, head dim 112 (held in a 128-column tile) at
#: Hq = Hkv = 32: its train shape and the 4 x 512 prefill shape
SHAPES = [(2, 2048, 2048, 16, 2, 128, True), (2, 28, 28, 4, 2, 24, True),
          (1, 129, 129, 16, 2, 128, True), (2, 64, 257, 8, 1, 64, True),
          (1, 257, 257, 4, 2, 128, False), (2, 100, 129, 8, 1, 24, True),
          (1, 300, 300, 3, 1, 128, True), (1, 77, 150, 8, 1, 32, False),
          (1, 200, 200, 8, 8, 128, False), (2, 1, 70, 4, 2, 64, True),
          (2, 2048, 2048, 32, 32, 112, True),
          (4, 512, 512, 32, 32, 112, True)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def _inputs(cuda, shape, dt, seed):
    b, sq, skv, hq, hkv, d, causal = shape
    g = torch.Generator(device=cuda).manual_seed(seed)
    q = torch.randn(b, sq, hq, d, generator=g, device=cuda).to(dt)
    k = torch.randn(b, skv, hkv, d, generator=g, device=cuda).to(dt)
    v = torch.randn(b, skv, hkv, d, generator=g, device=cuda).to(dt)
    o, lse = ops.flash_attention(q, k, v, causal=causal, return_lse=True)
    do = torch.randn(o.shape, generator=g, device=cuda).to(dt)
    return q, k, v, o, lse, do


@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", SHAPES)
def test_flash_bwd_matches_plain(cuda, dt, shape):
    """dq, dk, dv against the plain version, each in its operand's dtype
    and shape; one count per call."""
    causal = shape[-1]
    q, k, v, o, lse, do = _inputs(cuda, shape, dt, seed=sum(shape[:-1]))
    before = ops.bwd_launches
    got = ops.flash_attention_bwd(q, k, v, o, lse, do, causal)
    torch.cuda.synchronize()
    assert ops.bwd_launches == before + 1
    want = ref.flash_attention_bwd_ref(q, k, v, o, lse, do, causal)
    for g, w, t in zip(got, want, (q, k, v)):
        assert g.shape == t.shape and g.dtype == dt
        assert torch.isfinite(g).all()
        err = float((g.float() - w.float()).abs().max())
        assert err <= RTOL[dt] * float(w.float().abs().max()), err


@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [SHAPES[0], SHAPES[6]])
def test_flash_bwd_repeats_bitwise(cuda, dt, shape):
    """Every gradient element is summed in one fixed order: two calls give
    the same bits."""
    causal = shape[-1]
    args = _inputs(cuda, shape, dt, seed=7)
    first = ops.flash_attention_bwd(*args, causal)
    again = ops.flash_attention_bwd(*args, causal)
    assert all(torch.equal(a, b) for a, b in zip(first, again))


def test_flash_bwd_on_two_streams_after_other_work_is_bitwise(cuda):
    """The same call on a side stream, queued behind a long kernel, and on
    the default stream: the kernels launch on the caller's current stream
    and share no state across calls, so the results are bitwise equal."""
    shape = (2, 300, 300, 16, 2, 128, True)
    args = _inputs(cuda, shape, torch.bfloat16, seed=11)
    want = ops.flash_attention_bwd(*args, True)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        torch.cuda._sleep(1_000_000)
        x = torch.randn(2048, 2048, device=cuda)
        x = x @ x
        got = ops.flash_attention_bwd(*args, True)
    mine = ops.flash_attention_bwd(*args, True)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert all(torch.equal(a, b) for a, b in zip(mine, want))


@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32])
def test_flash_bwd_plan_is_the_kernels_tiles(cuda, dt):
    """``kernel.plan_bwd``, from which the wrapper sizes the dK/dV scratch,
    states the tiles the built kernels launch, at every head dim."""
    for d in range(1, kernel.MAX_HEAD_DIM + 1):
        assert kernel.kernel_tiles_bwd(dt, d) == kernel.plan_bwd(dt, d), d
