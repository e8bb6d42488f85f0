"""The port's backward routes on the CPU against the JAX package's VJPs:
``FusedMatmulFn`` (``kernels/fused_matmul/ops.py``) against ``jax.vjp`` of
the reference's ``fused_matmul_vjp``, and ``FlashAttentionFn`` with its
plain backward ``flash_attention_bwd_ref`` against ``jax.vjp`` of
``flash_attention_vjp`` (the Pallas kernel in interpret mode forward, the
oracle's VJP backward).  On a CPU tensor the Functions run the same
``backward`` code the card runs, with the plain versions in place of the
kernels; counters show that the CPU route goes through each Function.

Inputs are made with numpy from a seed and handed to both packages.
Tolerances: fp32 max abs 2e-5 relative to the largest gradient (sums in
another order); bf16 2e-2 of it (the reference rounds its bf16 cotangents
at other places than the port; the point there is the dtype plumbing).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.fused_matmul import ops as j_fm
from repro.kernels.flash_attention import ops as j_fa
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.fused_matmul import ops as fm_ops
from repro_torch.kernels.linear_scan import ops as ls_ops

RTOL = {"float32": 2e-5, "bfloat16": 2e-2}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Attrs(dict):
    """An epilogue stage's attrs, hashable: the reference's VJP takes its
    chain as a static (nondiff) argument."""

    def __hash__(self):
        return hash(tuple(sorted(self.items())))


def _rel(got, want) -> float:
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _both(a: np.ndarray, dtype: str):
    """The same values in both packages: rounded once in torch."""
    t = torch.from_numpy(a).to(TDT[dtype])
    return t, jnp.asarray(t.float().numpy()).astype(dtype)


#: the qwen block's chains (the O-projection's and the down projection's
#: residual add, head first and cast to the compute dtype; the gate|up,
#: QKV and head GEMMs have none), a bias add on a row operand, and a chain
#: that is not all adds (the recompute route: a gate times its up)
CHAINS = {
    "none": [],
    "residual": [("add", "full", {"head_pos": 1, "dtype": "{cdt}"})],
    "bias": [("add", "row", {})],
    "product": [("mul", "full", {}), ("add", "row", {})],
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("chain", sorted(CHAINS))
def test_fused_matmul_function_matches_the_reference_vjp(chain, dtype):
    m_lead, k, n = (2, 5), 24, 40
    rng = np.random.default_rng(len(chain) + 7 * len(dtype))
    x, jx = _both(rng.standard_normal(m_lead + (k,)).astype(np.float32),
                  dtype)
    w, jw = _both((rng.standard_normal((k, n)) / k ** 0.5)
                  .astype(np.float32), dtype)
    epi, fns, vals, jvals = [], [], [], []
    for fn, kind, at in CHAINS[chain]:
        at = {a: (v.format(cdt=dtype) if isinstance(v, str) else v)
              for a, v in at.items()}
        shape = (n,) if kind == "row" else m_lead + (n,)
        t, jt = _both(rng.standard_normal(shape).astype(np.float32), dtype)
        t.requires_grad_(True)
        vals.append(t)
        jvals.append(jt)
        epi.append((fn, [t], at))
        fns.append((fn, _Attrs(at)))
    x.requires_grad_(True)
    w.requires_grad_(True)
    fm_ops.reset_counts()
    y = fm_ops.fused_matmul(x, w, epilogue=epi)
    assert fm_ops.function_calls["forward"] == 1
    dy_np = rng.standard_normal(tuple(y.shape)).astype(np.float32)
    dy, jdy = _both(dy_np, dtype)
    got = torch.autograd.grad(y, [x, w] + vals, dy)
    assert fm_ops.function_calls["backward"] == 1
    want_y, vjp = jax.vjp(
        lambda a, b, v: j_fm.fused_matmul_vjp(a, b, v, tuple(fns),
                                              jnp.dtype(dtype)),
        jx, jw, tuple(jvals))
    assert _rel(y.detach().float().numpy(), want_y) <= RTOL[dtype]
    jgx, jgw, jgv = vjp(jdy)
    for g, wnt in zip(got, [jgx, jgw, *jgv]):
        assert g.dtype == TDT[dtype]
        assert _rel(g.float().numpy(), wnt) <= RTOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_matmul_unary_chain_recomputes_and_matches_autograd(dtype):
    """A chain that is not all adds (here silu then a full mul) takes the
    recompute route: one product without the epilogue in fp32, then the
    plain chain's autograd.  Held to autograd through the plain version
    (``fused_matmul_ref``), whose fp32 arithmetic it repeats."""
    from repro_torch.kernels.fused_matmul import ref
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((6, 16)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((16, 20)).astype(np.float32))
    u = torch.from_numpy(rng.standard_normal((6, 20)).astype(np.float32))
    x, w, u = (t.to(TDT[dtype]).requires_grad_(True) for t in (x, w, u))
    epi = [("silu", [], {}), ("mul", [u], {})]
    dy = torch.from_numpy(rng.standard_normal((6, 20)).astype(np.float32)) \
        .to(TDT[dtype])
    got = torch.autograd.grad(fm_ops.fused_matmul(x, w, epilogue=epi),
                              [x, w, u], dy)
    want = torch.autograd.grad(ref.fused_matmul_ref(x, w, epilogue=epi),
                               [x, w, u], dy)
    for g, wnt in zip(got, want):
        assert _rel(g.float().numpy(), wnt.float().numpy()) <= RTOL[dtype]


#: (B, Sq, Skv, Hq, Hkv, D, causal): groups 1, 2 and 8, Sq off every tile,
#: Skv > Sq (causal queries at the end of the keys), causal and not
FLASH_SHAPES = [
    (2, 40, 40, 4, 4, 16, True),
    (1, 100, 100, 8, 1, 24, True),
    (2, 37, 130, 4, 2, 16, True),
    (1, 77, 150, 8, 1, 32, False),
    (2, 60, 60, 4, 2, 24, False),
]


def _flash_inputs(shape, dtype, seed):
    b, sq, skv, hq, hkv, d, _ = shape
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((b, sq, hq, d), (b, skv, hkv, d), (b, skv, hkv, d),
                      (b, sq, hq, d))]
    return [_both(a, dtype) for a in arrs]


@pytest.mark.parametrize("shape", FLASH_SHAPES)
def test_flash_backward_plain_version_matches_the_reference_vjp(shape):
    """``flash_attention_bwd_ref`` from the plain forward's lse, fp32."""
    causal = shape[-1]
    (q, jq), (k, jk), (v, jv), (do, jdo) = _flash_inputs(shape, "float32",
                                                          sum(shape[:-1]))
    o, lse = fa_ref.flash_attention_ref(q, k, v, causal=causal,
                                        return_lse=True)
    assert lse.shape == (shape[0], shape[3], shape[1])
    got = fa_ref.flash_attention_bwd_ref(q, k, v, o, lse, do, causal)
    _, vjp = jax.vjp(lambda a, b, c: j_fa.flash_attention_vjp(
        a, b, c, causal, 128, 128), jq, jk, jv)
    for g, wnt in zip(got, vjp(jdo)):
        assert _rel(g.numpy(), wnt) <= RTOL["float32"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", FLASH_SHAPES)
def test_flash_function_matches_the_reference_vjp(shape, dtype):
    """``FlashAttentionFn`` end to end (forward through the wrapper, the
    backward through ``flash_attention_bwd``), counted."""
    causal = shape[-1]
    (q, jq), (k, jk), (v, jv), (do, jdo) = _flash_inputs(shape, dtype,
                                                          3 + sum(shape[:-1]))
    for t in (q, k, v):
        t.requires_grad_(True)
    fa_ops.reset_counts()
    o = fa_ops.flash_attention(q, k, v, causal=causal)
    got = torch.autograd.grad(o, [q, k, v], do)
    assert dict(fa_ops.function_calls) == {"forward": 1, "backward": 1}
    assert fa_ops.launches == fa_ops.bwd_launches == 0   # the CPU route
    want_o, vjp = jax.vjp(lambda a, b, c: j_fa.flash_attention_vjp(
        a, b, c, causal, 128, 128), jq, jk, jv)
    assert _rel(o.detach().float().numpy(), want_o) <= RTOL[dtype]
    for g, wnt in zip(got, vjp(jdo)):
        assert g.dtype == TDT[dtype]
        assert _rel(g.float().numpy(), wnt) <= RTOL[dtype]


def test_flash_lse_is_the_rows_log_sum_exp():
    """Both routes' lse (the bf16 route keeps m in base 2) against the
    materialised scores' logsumexp."""
    shape = (1, 50, 70, 4, 2, 24, True)
    for dtype in ("float32", "bfloat16"):
        (q, _), (k, _), (v, _), _ = _flash_inputs(shape, dtype, 9)
        _, lse = fa_ref.flash_attention_ref(q, k, v, causal=True,
                                            return_lse=True)
        qf, kf = q.float(), k.float().repeat_interleave(2, dim=2)
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) / 24 ** 0.5
        mask = torch.ones(50, 70, dtype=torch.bool).tril(20)
        want = torch.logsumexp(s.masked_fill(~mask, -torch.inf), dim=-1)
        torch.testing.assert_close(lse, want, rtol=0, atol=2e-5)


def test_flash_backward_refuses_what_the_forward_refuses():
    q = torch.zeros(1, 8, 2, 16)
    k = torch.zeros(1, 4, 2, 16)
    lse = torch.zeros(1, 2, 8)
    with pytest.raises(ValueError, match="causal"):
        fa_ref.flash_attention_bwd_ref(q, k, k, q, lse, q, causal=True)


def test_no_grad_and_frozen_inputs_skip_the_functions():
    """Serving and the forwards (no grad needed) never enter a Function."""
    x, w = torch.ones(3, 4), torch.ones(4, 5)
    q = torch.ones(1, 4, 2, 8)
    fm_ops.reset_counts()
    fa_ops.reset_counts()
    fm_ops.fused_matmul(x, w)
    fa_ops.flash_attention(q, q, q, causal=True)
    with torch.no_grad():
        fm_ops.fused_matmul(x, w.requires_grad_(True))
    assert not fm_ops.function_calls and not fa_ops.function_calls


def test_scan_grad_reaches_the_backward_kernel_on_a_cuda_tensor(monkeypatch):
    """Under grad a scan on a CUDA tensor (a stand-in device) goes through
    ``LinearScanFn`` to one ``kernel.launch_bwd`` with no refusal, and its
    gradients are what that launch writes; a CPU tensor runs
    ``linear_scan_bwd_ref`` instead and launches nothing."""
    from repro_torch.kernels.linear_scan import kernel as ls_kernel
    from repro_torch.kernels.linear_scan import ref as ls_ref
    g = torch.Generator().manual_seed(0)
    q, k = (torch.randn(1, 6, 2, 8, generator=g) for _ in range(2))
    v, do = (torch.randn(1, 6, 2, 4, generator=g) for _ in range(2))
    w = torch.rand(1, 6, 2, 8, generator=g) * 0.5 + 0.4
    u = torch.randn(2, 8, generator=g)
    want = ls_ref.linear_scan_bwd_ref(q, k, v, w, u, do, chunk=4)
    o_want = ls_ref.linear_scan_chunked(q, k, v, w, u=u, chunk=4)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v, w, u)]

    cpu_calls = []
    real = ls_ref.linear_scan_bwd_ref
    monkeypatch.setattr(ls_ref, "linear_scan_bwd_ref", lambda *a, **kw: (
        cpu_calls.append(1), real(*a, **kw))[1])
    ls_ops.reset_counts()
    y = ls_ops.linear_scan(*leaves[:4], u=leaves[4], chunk=4)
    got = torch.autograd.grad(y, leaves, do)
    assert cpu_calls == [1] and ls_ops.bwd_launches == 0
    for a, b in zip(got, want):
        assert torch.equal(a, b)

    launched = []

    def launch(q_, k_, v_, w_, u_, o, c, s0=None, s1=None):
        o.copy_(o_want)

    def launch_bwd(q_, k_, v_, w_, u_, do_, c, s0, ds1, ws, dup, *outs):
        launched.append((c, tuple(ws.shape), tuple(dup.shape)))
        for out, val in zip(outs, want):
            if out is not None:
                out.copy_(val)

    class FakeDevice:
        type = "cuda"
    fake = FakeDevice()
    monkeypatch.setattr(ls_kernel, "launch", launch)
    monkeypatch.setattr(ls_kernel, "launch_bwd", launch_bwd)
    monkeypatch.setattr(torch.Tensor, "device", property(lambda self: fake))
    ls_ops.reset_counts()
    y = ls_ops.linear_scan(*leaves[:4], u=leaves[4], chunk=4)
    got = torch.autograd.grad(y, leaves, do)
    monkeypatch.undo()
    assert launched == [(4, (2, 1, 2, 2, 8, 4), (1, 2, 2, 8))]
    assert ls_ops.launches == 1 and ls_ops.bwd_launches == 1
    assert ls_ops.bwd_launches_by_shape == {
        (1, 6, 2, 8, 4, "torch.float32", "rwkv6", 4): 1}
    assert ls_ops.function_calls == {"forward": 1, "backward": 1}
    assert cpu_calls == [1]
    for a, b in zip(got, want):
        assert torch.equal(a, b)
