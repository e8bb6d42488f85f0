"""The port's fused GEMM wrapper (on CPU tensors: its plain version) against
the JAX package's Pallas kernel in interpret mode and its jnp oracle.

Same inputs from one numpy seed on both sides.  Tolerances: fp32 atol/rtol
1e-5 (the two packages sum k in different orders); bf16 atol 2e-2 and rtol
1e-2 (at most one bf16 rounding apart, outputs kept below ~2 in magnitude).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.fused_matmul import ops as j_ops, ref as j_ref
from repro_torch.core.dtypes import to_torch_dtype
from repro_torch.kernels.fused_matmul import ops, ref

TOL = {"float32": dict(atol=1e-5, rtol=1e-5),
       "bfloat16": dict(atol=2e-2, rtol=1e-2)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny CPU tensors: one intra-op thread per test process, so parallel
    test workers do not oversubscribe the cores (bitwise comparisons stay
    within one process)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(m, k, n, dtype, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = (0.5 * rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32)
    jx, jw = jnp.asarray(x).astype(dtype), jnp.asarray(w).astype(dtype)
    tx = torch.from_numpy(x).to(to_torch_dtype(dtype))
    tw = torch.from_numpy(w).to(to_torch_dtype(dtype))
    return jx, jw, tx, tw


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m", [1, 4, 37, 128])
@pytest.mark.parametrize("k,n", [(64, 128), (100, 72)])
def test_plain_matches_pallas_interpret_and_oracle(m, k, n, dtype):
    jx, jw, tx, tw = _inputs(m, k, n, dtype, seed=m * 10 + k + n)
    got = ops.fused_matmul(tx, tw, out_dtype=dtype)
    assert got.dtype == to_torch_dtype(dtype) and got.shape == (m, n)
    kern = j_ops.fused_matmul(jx, jw, epilogue=[],
                              tile={"bm": 64, "bn": 128, "bk": 128},
                              out_dtype=dtype, interpret=True)
    oracle = j_ref.fused_matmul_ref(jx, jw, out_dtype=dtype)
    np.testing.assert_allclose(_np(got), _np(kern), **TOL[dtype])
    np.testing.assert_allclose(_np(got), _np(oracle), **TOL[dtype])


EPILOGUES = [
    [("add", "bias", {})],
    [("add", "bias", {}), ("relu", None, {})],
    [("add", "bias", {}), ("silu", None, {}), ("add", "res", {})],
    # the serving path's residual: head second, cast to the stage dtype
    [("add", "res", {"head_pos": 1, "dtype": "float32"})],
    [("mul", "bias", {}), ("gelu", None, {}), ("sub", "res", {"head_pos": 1})],
]


@pytest.mark.parametrize("epi", EPILOGUES)
def test_epilogue_chains_match(epi):
    m, k, n = 40, 64, 72
    jx, jw, tx, tw = _inputs(m, k, n, "float32", seed=3)
    rng = np.random.default_rng(4)
    bias = rng.standard_normal(n).astype(np.float32)
    res = rng.standard_normal((m, n)).astype(np.float32)
    j_epi, t_epi = [], []
    for fn, arg, at in epi:
        v = {"bias": bias, "res": res, None: None}[arg]
        j_epi.append((fn, [jnp.asarray(v)] if v is not None else [], at))
        t_epi.append((fn, [torch.from_numpy(v)] if v is not None else [], at))
    got = ops.fused_matmul(tx, tw, epilogue=t_epi, out_dtype="float32")
    kern = j_ops.fused_matmul(jx, jw, epilogue=j_epi,
                              tile={"bm": 64, "bn": 128, "bk": 64},
                              out_dtype="float32", interpret=True)
    np.testing.assert_allclose(_np(got), _np(kern), atol=1e-5, rtol=1e-5)


def test_bf16_stage_cast_chain_matches_oracle():
    """A bf16 GEMM whose residual stage runs in bf16 (the slot block's
    wo/wd epilogue at compute_dtype=bfloat16)."""
    m, k, n = 4, 96, 64
    jx, jw, tx, tw = _inputs(m, k, n, "bfloat16", seed=5)
    res = np.random.default_rng(6).standard_normal((m, n)).astype(np.float32)
    at = {"head_pos": 1, "dtype": "bfloat16"}
    got = ops.fused_matmul(tx, tw, out_dtype="bfloat16", epilogue=[
        ("add", [torch.from_numpy(res).bfloat16()], at)])
    want = j_ref.fused_matmul_ref(jx, jw, out_dtype="bfloat16", epilogue=[
        ("add", [jnp.asarray(res).astype(jnp.bfloat16)], at)])
    np.testing.assert_allclose(_np(got), _np(want), **TOL["bfloat16"])


def test_leading_dims_flatten_and_classify():
    x = torch.randn(2, 3, 8)
    w = torch.randn(8, 5)
    row = torch.randn(5)
    full = torch.randn(2, 3, 5)
    y = ops.fused_matmul(x, w, epilogue=[("add", [row], {}),
                                         ("mul", [full], {})])
    assert y.shape == (2, 3, 5)
    torch.testing.assert_close(y, (x @ w + row) * full, atol=1e-5, rtol=1e-5)
    spec, operands = ops._classify([("add", [row], {}), ("relu", [], {}),
                                    ("mul", [full], {"head_pos": 1})], 6, 5)
    assert spec == (("add", "row", 0, None), ("relu", "none", 0, None),
                    ("mul", "full", 1, None))
    assert [tuple(o.shape) for o in operands] == [(5,), (6, 5)]


def test_cpu_tensor_takes_the_plain_version_and_counts_no_launch():
    before = ops.launches
    x, w = torch.randn(3, 4), torch.randn(4, 2)
    torch.testing.assert_close(ops.fused_matmul(x, w),
                               ref.fused_matmul_ref(x, w))
    assert ops.launches == before
    with pytest.raises(ValueError, match="runs on cpu or cuda"):
        ops.fused_matmul(x.to("meta"), w.to("meta"))


def test_gelu_is_the_tanh_approximation():
    x = torch.linspace(-4, 4, 33)
    y = ref.apply_epilogue(x, [("gelu", [], {})])
    want = np.asarray(j_ref.apply_epilogue(jnp.asarray(x.numpy()),
                                           [("gelu", [], {})]))
    np.testing.assert_allclose(y.numpy(), want, atol=1e-6, rtol=1e-6)


# -- the Hopper kernel's tile plan and TMA padding (plain code, on the CPU) --

from repro_torch.kernels.fused_matmul import kernel  # noqa: E402

#: (n, k) of the full-width paths' GEMMs that split k (k > 8192):
#: qwen2.5-3b wd, RWKV6-7B wcv, ChatGLM3-6B wd, Command R+ wd, gate|up and
#: head, Qwen1.5-110B wd; and one output tile over a deep k
SPLIT = [(2048, 11008), (4096, 14336), (4096, 13696), (12288, 33792),
         (67584, 12288), (256000, 12288), (8192, 49152), (64, 16384)]
#: the others: qwen qkv, wo, gate|up, head; RWKV's 4096² weights, wck, wA,
#: wB, head; ChatGLM3's fused QKV and unfused K / V; Qwen1.5-110B's
#: gate|up and head (k = 8192)
UNSPLIT = [(2560, 2048), (2048, 2048), (22016, 2048), (151936, 2048),
           (4096, 4096), (14336, 4096), (64, 4096), (4096, 64),
           (65536, 4096), (4608, 4096), (256, 4096), (98304, 8192),
           (152064, 8192)]


def test_plan_takes_no_m():
    import inspect
    assert list(inspect.signature(kernel.plan).parameters) == ["n", "k",
                                                               "dtype"]
    assert kernel.plan(1003, 1000, torch.bfloat16) == \
        kernel.plan(1003, 1000, torch.bfloat16)


@pytest.mark.parametrize("n,k", SPLIT + UNSPLIT + [(1003, 1000), (1003, 100),
                                                   (1003, 8193), (8, 8),
                                                   (300, 37)])
def test_split_cuts_k_into_whole_k_tiles(n, k):
    p = kernel.plan(n, k, torch.bfloat16)
    assert 1 <= p.split <= kernel.MAX_SPLIT and p.bn in (64, 128, 256)
    assert (p.bn // 8) % p.split == 0   # a rank sums whole 8-column groups
    assert 2 <= p.stages <= 8
    if p.split > 1:   # every rank, the last too, walks >= 16 whole k tiles
        k_tiles = -(-k // kernel.BK)
        per = -(-k_tiles // p.split)
        assert per >= 16 and k_tiles - (p.split - 1) * per >= 16


@pytest.mark.parametrize("n,k", SPLIT)
def test_deep_and_single_tile_path_shapes_are_split(n, k):
    """A k of more than ``SPLIT_K_TILES`` k tiles, over many output tiles
    or one: the k range is split in two."""
    assert -(-k // kernel.BK) > kernel.SPLIT_K_TILES
    assert kernel.plan(n, k, torch.bfloat16).split == 2


@pytest.mark.parametrize("k", [64, 2048, 4096, 8192, 8193, 11008, 13696,
                               33792, 49152])
def test_split_is_a_function_of_k_alone(k):
    """Every output width at one k gets one split, so the columns of a
    fused product (ChatGLM3's QKV, n = 4608) sum their k ranges as its
    unfused parts (K, V: n = 256) do: the fusion pass is bitwise
    invisible."""
    splits = {kernel.plan(n, k, torch.bfloat16).split
              for n in (1, 8, 64, 65, 256, 2048, 2560, 4096, 4608, 27392,
                        65024, 256000)}
    assert len(splits) == 1, splits


@pytest.mark.parametrize("n,k", UNSPLIT)
def test_other_path_shapes_are_not_split(n, k):
    assert kernel.plan(n, k, torch.bfloat16).split == 1


#: fp32 (n, k): the paper nets' single-tile long contractions (conv1's,
#: conv2's and the LSTM2 head's dW, the CNN head's forward)
F32_SPLIT = [(32, 50176), (64, 12544), (61, 9600), (128, 3136)]
#: fp32 (n, k) across the nets' forward, dX and dW launches, ragged k, and
#: an empty k
F32_SHAPES = F32_SPLIT + [
    (10, 128), (10, 256), (256, 39), (256, 256), (512, 123), (512, 512),
    (1024, 295), (1024, 512), (2048, 635), (2048, 1024), (1, 24), (8, 16),
    (16, 32), (32, 64), (64, 64), (61, 512), (64, 288), (32, 9), (295, 1024),
    (635, 2048), (3136, 128), (512, 61), (24, 1), (1003, 8193), (300, 0)]


@pytest.mark.parametrize("n,k", F32_SHAPES)
def test_fp32_k_ranges_tile_k_in_whole_steps(n, k):
    """The ranks' ranges, in rank order, are ``[0, k)`` cut at whole
    ``F32_STEP`` steps, which every tile's k depth divides."""
    p = kernel.plan(n, k, torch.float32)
    assert p.bn == 0 and p.stages == kernel.F32_STAGES
    r = kernel.k_ranges(k, p.split)
    assert len(r) == p.split
    assert r[0][0] == 0 and r[-1][1] == k
    assert all(a[1] == b[0] for a, b in zip(r, r[1:]))
    per = kernel.k_per_rank(k, p.split)
    assert per % kernel.F32_STEP == 0
    assert all(hi - lo == per for lo, hi in r[:-1])
    assert all(kernel.F32_STEP % bk == 0 for _, _, bk, _, _ in
               kernel.F32_TILES)


@pytest.mark.parametrize("n,k", F32_SHAPES)
def test_fp32_every_rank_keeps_the_minimum_k(n, k):
    p = kernel.plan(n, k, torch.float32)
    if p.split > 1:
        assert all(hi - lo >= kernel.F32_MIN_K
                   for lo, hi in kernel.k_ranges(k, p.split))


@pytest.mark.parametrize("n,k", F32_SPLIT)
def test_fp32_single_tile_long_contractions_are_split(n, k):
    assert kernel.plan(n, k, torch.float32).split > 1


@pytest.mark.parametrize("n,k", [(n, k) for n, k in F32_SHAPES if k <= 64])
def test_fp32_shallow_k_is_not_split(n, k):
    assert kernel.plan(n, k, torch.float32).split == 1


def test_plan_refuses_float16():
    with pytest.raises(ValueError):
        kernel.plan(64, 64, torch.float16)


@pytest.mark.parametrize("m,n,k", [(64, 2048, 1024), (9, 32, 50176),
                                   (50176, 32, 9), (9600, 512, 61),
                                   (512, 1, 24), (64, 128, 3136),
                                   (1, 300, 4096)])
def test_fp32_tile_and_workspace(m, n, k):
    """An unsplit launch takes the 64 x 64 tile; the 32 x 32 one only where
    it gives a split of more than 32 columns more blocks than 64 x 64
    tiles, which leave a tenth of the SMs or more idle.
    A split's workspace holds one [m, n4] partial per rank (n4: n rounded
    up to 4)."""
    p = kernel.plan(n, k, torch.float32)
    tile = kernel.f32_tile(m, n, p.split)
    blocks = [-(-m // bm) * -(-n // bn) * p.split
              for bm, bn, *_ in kernel.F32_TILES]
    assert tile == (1 if p.split > 1 and n > 32
                    and blocks[0] < 0.9 * kernel.SMS
                    and blocks[1] > blocks[0] else 0)
    ws = kernel.workspace(m, n, p, "cpu")
    if p.split == 1:
        assert ws is None
    else:
        assert ws.shape == (p.split, m, -(-n // 4) * 4)
        assert ws.dtype == torch.float32


@pytest.mark.parametrize("shape", [(3, 1003), (5, 100), (1, 7)])
def test_pad_cols_zero_pads_and_slices_back_exactly(shape):
    t = torch.randn(*shape).bfloat16()
    p = kernel.pad_cols(t)
    assert p.shape == (shape[0], -(-shape[1] // 8) * 8)
    assert p.data_ptr() % 16 == 0 and p.is_contiguous()
    assert torch.equal(p[:, :shape[1]], t)
    assert not p[:, shape[1]:].any()


def test_pad_cols_keeps_aligned_rows_and_copies_a_misaligned_base():
    t = torch.randn(4, 64).bfloat16()
    assert kernel.pad_cols(t) is t
    flat = torch.randn(1 + 4 * 64).bfloat16()
    view = flat[1:].view(4, 64)          # base 2 bytes past an aligned one
    assert view.data_ptr() % 16 != 0
    p = kernel.pad_cols(view)
    assert p.shape == (4, 64) and p.data_ptr() % 16 == 0
    assert torch.equal(p, view)


@pytest.mark.parametrize("k", [0, 100, 64])
def test_zero_k_padding_adds_nothing(k):
    """The operands the bf16 route launches: the padded k columns of x
    meet w rows that TMA fills with zeros (an empty k: one slice of zeros).
    Small integers, so every sum is exact."""
    rng = np.random.default_rng(8 + k)
    x = torch.from_numpy(rng.integers(-3, 4, (5, k)).astype(np.float32))
    w = torch.from_numpy(rng.integers(-3, 4, (k, 37)).astype(np.float32))
    xp, wp, kp = kernel.tma_operands(x, w)
    assert kp == max(k, kernel.ALIGN) and xp.shape == (5, -(-kp // 8) * 8)
    assert wp.shape == (kp, 40)   # TMA rows: multiples of 16 bytes
    wz = torch.cat([wp, wp.new_zeros(xp.shape[1] - wp.shape[0], wp.shape[1])])
    assert torch.equal(xp @ wz[:, :37], x @ w)


def test_cpu_bf16_padded_shape_takes_the_plain_version_and_counts_no_launch():
    before, by_shape = ops.launches, dict(ops.launches_by_shape)
    x = torch.randn(7, 100).bfloat16()
    w = torch.randn(100, 1003).bfloat16()
    row = torch.randn(1003)
    epi = [("add", [row], {"dtype": "float32"}), ("relu", [], {})]
    assert torch.equal(ops.fused_matmul(x, w, epilogue=epi),
                       ref.fused_matmul_ref(x, w, epilogue=epi))
    assert ops.launches == before
    assert dict(ops.launches_by_shape) == by_shape
