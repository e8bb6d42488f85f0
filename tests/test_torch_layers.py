"""The port's layer primitives and slot-attention composites against the JAX
package's, on the same numpy inputs.

Tolerances: fp32 atol/rtol 1e-5 for the norms and RoPE (one rsqrt / sin-cos
apart), 1e-5 for the attention composites (fp32 scores and softmax summed
in another order); bf16 atol 2e-2 (one bf16 rounding of values below ~2).
Index semantics (clamping gathers, dropping scatters) are compared exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch.core import tapir
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

F32 = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny CPU tensors: one intra-op thread per test process, so parallel
    test workers do not oversubscribe the cores (bitwise comparisons stay
    within one process)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_and_layernorm_match(dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 40)).astype(np.float32) * 3
    s = rng.standard_normal(40).astype(np.float32)
    b = rng.standard_normal(40).astype(np.float32)
    tol = F32 if dtype == "float32" else dict(atol=2e-2, rtol=1e-2)
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    got = L.rmsnorm(tx, torch.from_numpy(s))
    assert got.dtype == tx.dtype
    np.testing.assert_allclose(_np(got), _np(JL.rmsnorm(jx, jnp.asarray(s))),
                               **tol)
    got = L.layernorm(tx, torch.from_numpy(s), torch.from_numpy(b))
    want = JL.layernorm(jx, jnp.asarray(s), jnp.asarray(b))
    np.testing.assert_allclose(_np(got), _np(want), **tol)


@pytest.mark.parametrize("fraction", [1.0, 0.5])
def test_rope_tables_and_apply_rope_match(fraction):
    hd = 24
    pos = np.arange(37).astype(np.int32)
    jc, js = JL.rope_table(jnp.asarray(pos), hd, fraction=fraction)
    tc, ts = L.rope_table(torch.from_numpy(pos), hd, fraction=fraction)
    assert tc.dtype == torch.float32 and tuple(tc.shape) == jc.shape
    np.testing.assert_allclose(_np(tc), _np(jc), **F32)
    np.testing.assert_allclose(_np(ts), _np(js), **F32)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 37, 3, hd)).astype(np.float32)
    # [S, rot/2] tables and per-row [B, S, rot/2] tables
    got = L.apply_rope(torch.from_numpy(x), tc, ts, fraction)
    want = JL.apply_rope(jnp.asarray(x), jc, js, fraction)
    np.testing.assert_allclose(_np(got), _np(want), **F32)
    rows = np.stack([pos[:5], pos[10:15]])
    got = L.apply_rope(torch.from_numpy(x[:, :5]), tc[rows], ts[rows],
                       fraction)
    want = JL.apply_rope(jnp.asarray(x[:, :5]), jc[rows], js[rows], fraction)
    np.testing.assert_allclose(_np(got), _np(want), **F32)
    # bf16 activations against the fp32 table: fp32 arithmetic, cast back
    xb = torch.from_numpy(x).bfloat16()
    got = L.apply_rope(xb, tc, ts, fraction)
    want = JL.apply_rope(jnp.asarray(x).astype(jnp.bfloat16), jc, js,
                         fraction)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-2, rtol=1e-2)


def test_full_rope_table_is_bucketed_and_identity_stable():
    assert [L.bucket_pow2(n) for n in (1, 8, 9, 100, 128, 129)] == \
        [JL.bucket_pow2(n) for n in (1, 8, 9, 100, 128, 129)]
    c1, s1 = L.full_rope_table(100, 24)
    c2, s2 = L.full_rope_table(128, 24)
    assert c1 is c2 and s1 is s2          # same bucket: same tensors
    assert tuple(c1.shape) == (128, 12)
    c3, _ = L.full_rope_table(129, 24)
    assert c3 is not c1 and tuple(c3.shape) == (256, 12)
    jc, js = JL.full_rope_table(100, 24)
    np.testing.assert_allclose(_np(c1), _np(jc), **F32)
    np.testing.assert_allclose(_np(s1), _np(js), **F32)
    # the table lives on the device it is asked for, keyed by it
    m, _ = L.full_rope_table(100, 24, device="meta")
    assert m.device.type == "meta" and m is not c1


def _pools(rng, P, pl, Hkv, hd):
    ck = rng.standard_normal((P, pl, Hkv, hd)).astype(np.float32)
    cv = rng.standard_normal((P, pl, Hkv, hd)).astype(np.float32)
    return ck, cv


@pytest.mark.parametrize("vector_len", [True, False])
def test_masked_decode_attention_matches(vector_len):
    rng = np.random.default_rng(2)
    B, S, H, Hkv, hd, maxlen = 3, 2, 4, 2, 8, 16
    q = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    ck = rng.standard_normal((B, maxlen, Hkv, hd)).astype(np.float32)
    cv = rng.standard_normal((B, maxlen, Hkv, hd)).astype(np.float32)
    vl = np.asarray([5, 16, 2], np.int32) if vector_len \
        else np.asarray(9, np.int32)
    got = T._masked_decode_attention(*map(torch.from_numpy, (q, ck, cv, vl)))
    want = JT._masked_decode_attention(*map(jnp.asarray, (q, ck, cv, vl)))
    np.testing.assert_allclose(_np(got), _np(want), **F32)


def test_paged_decode_and_prefill_attention_match():
    rng = np.random.default_rng(3)
    P, pl, Hkv, hd, H = 11, 4, 2, 8, 4
    ck, cv = _pools(rng, P, pl, Hkv, hd)
    # slot 0 shares pages 9, 10 as its prefix; slot 1 its private run
    ptab = np.asarray([[9, 10, 3, 4], [5, 6, 7, 8]], np.int32)
    q = rng.standard_normal((2, 1, H, hd)).astype(np.float32)
    vl = np.asarray([11, 6], np.int32)
    got = T._paged_decode_attention(
        *map(torch.from_numpy, (q, ck, cv, ptab, vl)))
    want = JT._paged_decode_attention(*map(jnp.asarray,
                                           (q, ck, cv, ptab, vl)))
    np.testing.assert_allclose(_np(got), _np(want), **F32)
    qp = rng.standard_normal((1, 8, H, hd)).astype(np.float32)
    vlen = np.asarray(13, np.int32)
    got = T._paged_prefill_attention(
        *map(torch.from_numpy, (qp, ck, cv, ptab[0], vlen)))
    want = JT._paged_prefill_attention(*map(jnp.asarray,
                                            (qp, ck, cv, ptab[0], vlen)))
    np.testing.assert_allclose(_np(got), _np(want), **F32)
    # bf16 pools: fp32 scores and PV products on both sides
    got = T._paged_decode_attention(
        torch.from_numpy(q).bfloat16(), torch.from_numpy(ck).bfloat16(),
        torch.from_numpy(cv).bfloat16(), torch.from_numpy(ptab),
        torch.from_numpy(vl))
    want = JT._paged_decode_attention(
        jnp.asarray(q).astype(jnp.bfloat16), jnp.asarray(ck).astype(
            jnp.bfloat16), jnp.asarray(cv).astype(jnp.bfloat16),
        jnp.asarray(ptab), jnp.asarray(vl))
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-2, rtol=1e-2)


def test_page_coords_match():
    pos = np.asarray([0, 7, 8, 63, 64, 200], np.int32)
    got = T._page_coords(torch.from_numpy(pos), page_len=8)
    want = JT._page_coords(jnp.asarray(pos), page_len=8)
    for a, b in zip(got, want):
        assert a.dtype == torch.int32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("regioned", [False, True])
def test_out_of_range_gather_clamps_and_scatter_drops(regioned):
    """The reference's index semantics, which torch does not share: a
    gather clamps an out-of-range index, a scatter drops its update, and
    negative indices wrap first.  Also through a region program."""
    buf = np.arange(40, dtype=np.float32).reshape(8, 5)
    rows = np.asarray([0, 7, 9, -1, 12], np.int32)
    cols = np.asarray([4, 5, 1, 0, 2], np.int32)
    upd = np.full((5,), -1.0, np.float32)
    jb = jnp.asarray(buf)
    want_g = np.asarray(jnp.asarray(buf)[jnp.asarray(rows)])
    want_s = np.asarray(jb.at[rows, cols].set(upd, mode="drop"))
    want_a = np.asarray(jb.at[rows].add(2.0, mode="drop"))
    if regioned:
        @tapir.parallel_region
        def f(b, r, c, u):
            return (tapir.gather(b, (r,)),
                    tapir.scatter(b, (r, c), u, donate=False),
                    tapir.scatter(b, (r,), u[:, None] * 0 + 2.0, mode="add",
                                  donate=False),
                    b[r])      # integer-array indexing records a gather too
        g, s, a, g2 = f(torch.from_numpy(buf), torch.from_numpy(rows),
                        torch.from_numpy(cols), torch.from_numpy(upd))
        np.testing.assert_array_equal(g2.numpy(), want_g)
    else:
        tb = torch.from_numpy(buf)
        g = tapir.gather(tb, (torch.from_numpy(rows),))
        s = tapir.scatter(tb, (torch.from_numpy(rows),
                               torch.from_numpy(cols)), torch.from_numpy(upd))
        a = tapir.scatter(tb, (torch.from_numpy(rows),), 2.0, mode="add")
    np.testing.assert_array_equal(g.numpy(), want_g)
    np.testing.assert_array_equal(s.numpy(), want_s)
    np.testing.assert_array_equal(a.numpy(), want_a)
    assert np.array_equal(buf, np.arange(40, dtype=np.float32).reshape(8, 5))


def test_scatter_set_with_duplicate_targets_keeps_the_last_in_range_row():
    buf = np.zeros((4, 3), np.float32)
    rows = np.asarray([1, 1, 9, 2, 1], np.int32)
    upd = np.arange(15, dtype=np.float32).reshape(5, 3)
    got = tapir.scatter(torch.from_numpy(buf), (torch.from_numpy(rows),),
                        torch.from_numpy(upd))
    want = jnp.asarray(buf).at[rows].set(upd, mode="drop")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_lift_infers_shapes_on_meta_and_runs_in_the_region():
    """``lift`` shape inference runs the composite on ``meta`` tensors (the
    counterpart of the reference's ``jax.eval_shape``)."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((2, 3, 16)).astype(np.float32))
    s = torch.from_numpy(rng.standard_normal(16).astype(np.float32))
    g = tapir.capture_region(lambda a, b: L.rmsnorm(a, b) * 2.0, x, s)
    kinds = sorted(n.op for n in g.nodes.values())
    assert kinds == ["const", "ew", "input", "input", "pyfunc"]
    out = tapir.parallel_region(lambda a, b: L.rmsnorm(a, b) * 2.0)(x, s)
    jout = JL.rmsnorm(jnp.asarray(x.numpy()), jnp.asarray(s.numpy())) * 2.0
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **F32)
