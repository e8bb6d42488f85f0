"""The port's plain linear scans (``kernels/linear_scan/ref.py``) and their
wrapper (``ops.linear_scan``) against the JAX package's oracle, its chunked
form and its Pallas kernel in interpret mode, on the CPU.

Inputs are made with numpy from a seed.  Tolerances:

* the port's chunked form against the JAX chunked form and the Pallas
  kernel (the same factored arithmetic, sums in other orders), and the
  port's oracle against the JAX oracle: max |got - want| within 1e-5 of
  max |want|.  The scale is the output's, not each element's: a prefix sum
  of log-decays rounded in another order moves the exponent of a factor,
  so a small output element beside large ones carries an absolute error of
  the large ones' size (measured: at most 2.4e-6 of the scale);
* a chunked form against an oracle: rtol/atol 5e-3, the reference's own
  sweep tolerance (``tests/test_kernels.py``: the factored exponentials
  round differently from the step-by-step products).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.linear_scan import ops as j_ops
from repro.kernels.linear_scan import ref as j_ref
from repro_torch.kernels.costs import SAFE_CHUNK
from repro_torch.kernels.linear_scan import ops, ref

SAME = 1e-5
CHUNKED_VS_ORACLE = dict(rtol=5e-3, atol=5e-3)
#: RWKV6's decay clip: log w >= -exp(2)
CLIP_W = float(np.exp(-np.exp(2.0)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny CPU tensors: one intra-op thread per test process, so parallel
    test workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(s, dk, dv, rwkv, seed, b=2, h=2, clip=False):
    rng = np.random.default_rng(seed)
    q, k = (rng.standard_normal((b, s, h, dk)).astype(np.float32)
            for _ in range(2))
    v = rng.standard_normal((b, s, h, dv)).astype(np.float32)
    if clip:
        w = np.full((b, s, h, dk), CLIP_W, np.float32)
    else:
        w = np.exp(rng.uniform(-7.3, -1e-3, (b, s, h, dk))).astype(np.float32)
    u = rng.standard_normal((h, dk)).astype(np.float32) if rwkv else None
    return q, k, v, w, u


def _close(got, want, tol=SAME):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max()) if got.size else 0.0
    scale = float(np.abs(want).max()) if want.size else 0.0
    assert err <= tol * scale, f"max err {err} > {tol} * {scale}"


def _t(*arrays):
    return [None if a is None else torch.from_numpy(a) for a in arrays]


def _j(*arrays):
    return [None if a is None else jnp.asarray(a) for a in arrays]


# the reference sweep's (s, dk, dv, chunk), S < C, and a chunk of 1
SWEEP = [(64, 32, 32, 16), (37, 16, 48, 16), (128, 64, 64, 8),
         (16, 8, 8, 16), (5, 16, 16, 16), (9, 8, 12, 1)]


@pytest.mark.parametrize("rwkv", [False, True])
@pytest.mark.parametrize("s,dk,dv,chunk", SWEEP)
def test_plain_scans_match_the_reference(s, dk, dv, chunk, rwkv):
    arrs = _inputs(s, dk, dv, rwkv, seed=s * 10 + dk)
    q, k, v, w, u = _t(*arrs)
    jq, jk, jv, jw, ju = _j(*arrs)
    got = ref.linear_scan_chunked(q, k, v, w, u=u, chunk=chunk).numpy()
    oracle = ref.linear_scan_ref(q, k, v, w, u=u).numpy()
    j_oracle = np.asarray(j_ref.linear_scan_ref(jq, jk, jv, jw, u=ju))
    _close(got, j_ops.linear_scan_chunked(jq, jk, jv, jw, u=ju, chunk=chunk))
    _close(got, j_ops.linear_scan(jq, jk, jv, jw, u=ju, chunk=chunk,
                                  interpret=True))
    _close(oracle, j_oracle)
    np.testing.assert_allclose(got, j_oracle, **CHUNKED_VS_ORACLE)


@pytest.mark.parametrize("rwkv", [False, True])
@pytest.mark.parametrize("s", [37, 300])
def test_exact_at_the_decay_clip(s, rwkv):
    """Every position at the strongest decay the model allows: the factored
    form stays exact at SAFE_CHUNK (masked factors saturate at exp(80) and
    must never meet v), so the chunked scan matches the recurrence and the
    Pallas kernel, with no inf or NaN."""
    arrs = _inputs(s, 64, 64, rwkv, seed=s, clip=True)
    q, k, v, w, u = _t(*arrs)
    got = ref.linear_scan_chunked(q, k, v, w, u=u, chunk=SAFE_CHUNK).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref.linear_scan_ref(q, k, v, w, u=u),
                               **CHUNKED_VS_ORACLE)
    jq, jk, jv, jw, ju = _j(*arrs)
    _close(got, j_ops.linear_scan(jq, jk, jv, jw, u=ju, chunk=SAFE_CHUNK,
                                  interpret=True))


def test_state_carry_chains_like_one_long_scan():
    """``init_state`` / ``return_state``: two halves chained equal one long
    scan (``tests/test_kernels.py::test_linear_scan_state_carry``), and the
    carried state equals the reference's."""
    q, k, v, w, u = _inputs(64, 16, 16, True, seed=5, b=1)
    w = np.exp(np.log(w) * (2.0 / 7.3)).astype(np.float32)   # milder decay
    u = np.abs(u)
    tq, tk, tv, tw, tu = _t(q, k, v, w, u)
    full = ref.linear_scan_ref(tq, tk, tv, tw, u=tu).numpy()
    half = 32
    o1, st = ref.linear_scan_chunked(tq[:, :half], tk[:, :half],
                                     tv[:, :half], tw[:, :half], u=tu,
                                     return_state=True)
    o2, st2 = ref.linear_scan_chunked(tq[:, half:], tk[:, half:],
                                      tv[:, half:], tw[:, half:], u=tu,
                                      init_state=st, return_state=True)
    got = torch.cat([o1, o2], dim=1).numpy()
    np.testing.assert_allclose(got, full, rtol=2e-3, atol=2e-3)
    jq, jk, jv, jw, ju = _j(q, k, v, w, u)
    _, jst = j_ops.linear_scan_chunked(jq, jk, jv, jw, u=ju,
                                       return_state=True)
    _close(st2.numpy(), jst)
    assert st.dtype == torch.float32 and st.shape == (1, 2, 16, 16)


def test_mixed_dtypes_round_once_to_v():
    """bf16 q/k/v beside fp32 w and u (the RWKV6 forward's case): fp32
    arithmetic, one rounding to bf16 at the end."""
    q, k, v, w, u = _t(*_inputs(40, 16, 16, True, seed=9))
    bf = [t.to(torch.bfloat16) for t in (q, k, v)]
    got = ref.linear_scan_chunked(*bf, w, u=u)
    want = ref.linear_scan_chunked(*(t.float() for t in bf), w, u=u)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want.to(torch.bfloat16))


@pytest.mark.parametrize("chunk", [1, 5, SAFE_CHUNK])
def test_wrapper_on_a_cpu_tensor_takes_the_plain_version(chunk):
    """On a CPU tensor ``ops.linear_scan`` is ``linear_scan_chunked`` at the
    given chunk, bitwise, and launches nothing: the count moves only where
    the kernel launches."""
    q, k, v, w, u = _t(*_inputs(33, 16, 24, True, seed=chunk))
    before = (ops.launches, dict(ops.launches_by_shape))
    for uu in (u, None):
        got = ops.linear_scan(q, k, v, w, u=uu, chunk=chunk)
        want = ref.linear_scan_chunked(q, k, v, w, u=uu, chunk=chunk)
        assert torch.equal(got, want)
    assert (ops.launches, dict(ops.launches_by_shape)) == before


@pytest.mark.parametrize("chunk", [0, SAFE_CHUNK + 1, 64, 128])
def test_wrapper_refuses_a_chunk_past_the_exact_bound(chunk):
    q, k, v, w, u = _t(*_inputs(40, 16, 16, True, seed=1))
    with pytest.raises(ValueError, match="chunk"):
        ops.linear_scan(q, k, v, w, u=u, chunk=chunk)


def test_wrapper_checks_shapes():
    q, k, v, w, u = _t(*_inputs(8, 16, 16, True, seed=2))
    with pytest.raises(ValueError, match="u must be"):
        ops.linear_scan(q, k, v, w, u=u[:, :8])
    with pytest.raises(ValueError, match="expected"):
        ops.linear_scan(q, k[:, :4], v, w, u=u)


def _state(b, h, dk, dv, seed):
    return np.random.default_rng(seed).standard_normal(
        (b, h, dk, dv)).astype(np.float32)


# (s, dk, dv, chunk): the chunk, ragged S, S < C, a chunk of 1 and S = 1
# (a decode step)
STATE_CASES = [(64, 16, 16, 16), (37, 16, 24, 16), (5, 8, 8, 16),
               (9, 8, 12, 1), (1, 16, 16, 16)]


@pytest.mark.parametrize("rwkv", [False, True])
@pytest.mark.parametrize("s,dk,dv,chunk", STATE_CASES)
def test_wrapper_carries_the_state_like_the_reference(s, dk, dv, chunk,
                                                      rwkv):
    """``ops.linear_scan(init_state=..., return_state=True)`` on CPU
    tensors is the plain chunked form with the same arguments (bitwise),
    and matches the JAX ``linear_scan_chunked`` with the same state in and
    out (``SAME`` of scale)."""
    arrs = _inputs(s, dk, dv, rwkv, seed=3 * s + dk)
    st0 = _state(2, 2, dk, dv, seed=s)
    q, k, v, w, u = _t(*arrs)
    ts0 = torch.from_numpy(st0)
    o, st = ops.linear_scan(q, k, v, w, u=u, chunk=chunk, init_state=ts0,
                            return_state=True)
    o_p, st_p = ref.linear_scan_chunked(q, k, v, w, u=u, chunk=chunk,
                                        init_state=ts0, return_state=True)
    assert torch.equal(o, o_p) and torch.equal(st, st_p)
    assert st.dtype == torch.float32 and st.shape == (2, 2, dk, dv)
    jq, jk, jv, jw, ju = _j(*arrs)
    jo, jst = j_ops.linear_scan_chunked(jq, jk, jv, jw, u=ju, chunk=chunk,
                                        init_state=jnp.asarray(st0),
                                        return_state=True)
    _close(o.numpy(), jo)
    _close(st.numpy(), jst)


@pytest.mark.parametrize("rwkv", [False, True])
@pytest.mark.parametrize("split", [16, 21])
def test_wrapper_chained_calls_match_one_long_call(split, rwkv):
    """A prefill then its continuation, the state carried between two
    wrapper calls, give one long call's outputs and final state: bitwise
    where the split falls on a chunk boundary (the same chunks in the
    same order), within ``SAME`` of scale elsewhere (the chunks regroup)."""
    q, k, v, w, u = _t(*_inputs(48, 16, 16, rwkv, seed=11 + split))
    st0 = torch.from_numpy(_state(2, 2, 16, 16, seed=split))
    whole, st_whole = ops.linear_scan(q, k, v, w, u=u, init_state=st0,
                                      return_state=True)
    o1, st1 = ops.linear_scan(q[:, :split], k[:, :split], v[:, :split],
                              w[:, :split], u=u, init_state=st0,
                              return_state=True)
    o2, st2 = ops.linear_scan(q[:, split:], k[:, split:], v[:, split:],
                              w[:, split:], u=u, init_state=st1,
                              return_state=True)
    got = torch.cat([o1, o2], dim=1)
    if split % SAFE_CHUNK == 0:
        assert torch.equal(got, whole) and torch.equal(st2, st_whole)
    _close(got.numpy(), whole.numpy())
    _close(st2.numpy(), st_whole.numpy())


def test_wrapper_on_meta_tensors_gives_shapes_only():
    """The region tracer infers a lifted composite's outputs on ``meta``
    tensors: the wrapper answers with shapes and dtypes, launching
    nothing."""
    q = torch.empty((2, 7, 3, 16), device="meta", dtype=torch.bfloat16)
    v = torch.empty((2, 7, 3, 24), device="meta", dtype=torch.bfloat16)
    w = torch.empty((2, 7, 3, 16), device="meta")
    u = torch.empty((3, 16), device="meta")
    st = torch.empty((2, 3, 16, 24), device="meta")
    before = ops.launches
    o, st1 = ops.linear_scan(q, q, v, w, u=u, init_state=st,
                             return_state=True)
    assert o.device.type == "meta" and o.shape == v.shape
    assert o.dtype == torch.bfloat16
    assert st1.shape == st.shape and st1.dtype == torch.float32
    assert ops.linear_scan(q, q, v, w).shape == v.shape
    assert ops.launches == before


def test_wrapper_checks_the_state_shape():
    q, k, v, w, u = _t(*_inputs(8, 16, 24, True, seed=4))
    with pytest.raises(ValueError, match="init_state"):
        ops.linear_scan(q, k, v, w, u=u,
                        init_state=torch.zeros(2, 2, 24, 16))
