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
