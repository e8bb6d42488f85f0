"""The port's hand-written scan backward (``kernels/linear_scan/ref.py::
linear_scan_bwd_ref``) and the autograd Function that routes every scan
through it under grad (``ops.LinearScanFn``) against the JAX package's
gradients, on the CPU.

Inputs are made with numpy from a seed: RWKV6's decay (a log-log weight
uniform in its clip [-8, 2]) or the clip itself, exp(-e^2), in every
position; Dk != Dv.  Tolerances, each as max |got - want| over the
gradient's largest magnitude:

* 1e-4 against ``jax.vjp`` of the reference's ``linear_scan_chunked`` and
  of its oracle ``linear_scan_ref`` (fp32 both sides; the sums run in other
  orders), for dq, dk, dv, du, dS0, and dw against the oracle's;
* dw against the chunked form's VJP: ``DW_VS_CHUNKED``.  XLA's VJP of the
  factored form reaches log w through the difference ``q dq - k dk`` of
  neighbouring rows, whose leading terms cancel (at the clip to 1 part in
  ~1e3), so its own dw carries fp32 rounding of the cancelled terms' size,
  magnified again by ``1 / w`` at strong decays.  The port's backward
  takes each pair's two halves together and cancels nothing: against an
  fp64 evaluation of the sequential recurrence (``_truth``) every one of
  its gradients is held to ``TRUTH``;
* chained calls against one call: bitwise (the split lies on a chunk
  boundary, so each chunk sees the same rows and the same carries), du
  excepted (its per-chunk partials are summed per call, then the two
  calls' sums added): 1e-6 of its largest.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.linear_scan import ops as j_ops
from repro.kernels.linear_scan import ref as j_ref
from repro_torch.kernels.linear_scan import ops, ref

TOL = 1e-4
#: dw against XLA's VJP of the chunked form (see the module docstring);
#: measured at most 5.2e-4 over these cases (the port's
#: dw is within 5e-6 of the fp64 truth in every one)
DW_VS_CHUNKED = 1e-3
#: the port's backward against the fp64 recurrence
TRUTH = 2e-5
CLIP_W = float(np.exp(-np.exp(2.0)))
B, H, DK, DV = 2, 2, 8, 12
NAMES = ("dq", "dk", "dv", "dw", "du", "dS0")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny CPU tensors: one intra-op thread per test process, so parallel
    test workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(s, rwkv, state, clip, seed):
    rng = np.random.default_rng(seed)
    q, k = (rng.standard_normal((B, s, H, DK)).astype(np.float32)
            for _ in range(2))
    v = rng.standard_normal((B, s, H, DV)).astype(np.float32)
    if clip:
        w = np.full((B, s, H, DK), CLIP_W, np.float32)
    else:
        w = np.exp(-np.exp(rng.uniform(-8.0, 2.0, (B, s, H, DK))))
        w = w.astype(np.float32)
    u = rng.standard_normal((H, DK)).astype(np.float32) if rwkv else None
    s0 = (rng.standard_normal((B, H, DK, DV)).astype(np.float32)
          if state else None)
    do = rng.standard_normal((B, s, H, DV)).astype(np.float32)
    ds = (rng.standard_normal((B, H, DK, DV)).astype(np.float32)
          if state else None)
    return q, k, v, w, u, s0, do, ds


def _t(*arrays):
    return [None if a is None else torch.from_numpy(a) for a in arrays]


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    if not got.size:
        return 0.0
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-30)


def _jax_vjp(q, k, v, w, u, s0, do, ds, chunk):
    """The reference's gradients: ``jax.vjp`` of its chunked form (with
    the state arguments) and, without state, of its oracle."""
    jq, jk, jv, jw, ju, js0 = (None if a is None else jnp.asarray(a)
                               for a in (q, k, v, w, u, s0))
    args = [jq, jk, jv, jw] + ([ju] if ju is not None else []) \
        + ([js0] if js0 is not None else [])

    def chunked(*a):
        it = iter(a[4:])
        uu = next(it) if ju is not None else None
        ss = next(it) if js0 is not None else None
        return j_ops.linear_scan_chunked(*a[:4], u=uu, chunk=chunk,
                                         init_state=ss,
                                         return_state=ss is not None)
    def oracle(*a):
        return j_ref.linear_scan_ref(*a[:4], u=a[4] if ju is not None
                                     else None)

    def grads(fn, cot, *a):
        return jax.vjp(fn, *a)[1](cot)
    cot = (jnp.asarray(do), jnp.asarray(ds)) if s0 is not None \
        else jnp.asarray(do)
    out = {"chunked": jax.jit(lambda c, *a: grads(chunked, c, *a))(
        cot, *args)}
    if s0 is None:
        out["oracle"] = jax.jit(lambda c, *a: grads(oracle, c, *a))(
            cot, *args)
    return {kind: [np.asarray(g) for g in gs] for kind, gs in out.items()}


def _truth(q, k, v, w, u, s0, do, ds):
    """An fp64 evaluation: the sequential recurrence, differentiated by
    torch's autograd."""
    leaves = [torch.from_numpy(a).double().requires_grad_(True)
              for a in (q, k, v, w, u, s0) if a is not None]
    it = iter(leaves)
    tq, tk, tv, tw = (next(it) for _ in range(4))
    tu = next(it) if u is not None else None
    st = next(it) if s0 is not None else torch.zeros(
        (B, H, DK, DV), dtype=torch.float64)
    outs = []
    for t in range(q.shape[1]):
        kv = tk[:, t, :, :, None] * tv[:, t, :, None, :]
        if tu is not None:
            att = st + tu[None, :, :, None] * kv
            outs.append(torch.einsum("bhk,bhkv->bhv", tq[:, t], att))
            st = tw[:, t, :, :, None] * st + kv
        else:
            st = tw[:, t, :, :, None] * st + kv
            outs.append(torch.einsum("bhk,bhkv->bhv", tq[:, t], st))
    o = torch.stack(outs, dim=1)
    loss = (o * torch.from_numpy(do).double()).sum()
    if ds is not None:
        loss = loss + (st * torch.from_numpy(ds).double()).sum()
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return [np.zeros(t.shape) if g is None else g.numpy()
            for t, g in zip(leaves, grads)]


# (s, chunk, state, clip): S off and on chunk edges, S < C, a chunk of 1;
# the carried state (init_state in, the final carry's cotangent) and the
# decay clip in every position
CASES = ([(s, c, False, False) for s in (1, 7, 16, 37, 64) for c in (1, 4, 16)]
         + [(s, c, True, False) for s in (7, 37, 64) for c in (4, 16)]
         + [(s, 16, st, True) for s in (37, 64) for st in (False, True)])


@pytest.mark.parametrize("rwkv", [False, True])
@pytest.mark.parametrize("s,chunk,state,clip", CASES)
def test_bwd_ref_matches_the_reference_vjp(s, chunk, state, clip, rwkv):
    arrs = _inputs(s, rwkv, state, clip, seed=100 * s + 10 * chunk + state)
    q, k, v, w, u, s0, do, ds = arrs
    got = ref.linear_scan_bwd_ref(*_t(q, k, v, w, u), torch.from_numpy(do),
                                  chunk=chunk, init_state=_t(s0)[0],
                                  d_state=_t(ds)[0])
    assert (got[4] is None) == (not rwkv) and (got[5] is None) == (not state)
    assert all(g is None or g.dtype == torch.float32 for g in got)
    got = [g.numpy() for g in got if g is not None]
    names = [n for n, g in zip(NAMES, (1, 1, 1, 1, u, s0)) if g is not None]
    assert all(np.isfinite(g).all() for g in got)
    for kind, want in _jax_vjp(*arrs, chunk).items():
        for name, g, wt in zip(names, got, want):
            tol = DW_VS_CHUNKED if (name, kind) == ("dw", "chunked") else TOL
            assert _rel(g, wt) <= tol, (kind, name, _rel(g, wt))
    for name, g, wt in zip(names, got, _truth(*arrs)):
        assert _rel(g, wt) <= TRUTH, ("truth", name, _rel(g, wt))


def test_bwd_ref_in_bf16_rounds_each_gradient_once():
    """bf16 q/k/v/do beside fp32 w and u (the RWKV6 train step's case):
    the arithmetic is the fp32 one on the rounded inputs, each of dq, dk,
    dv rounded once to bf16; dw and du stay fp32."""
    q, k, v, w, u, _, do, _ = _inputs(37, True, False, False, seed=3)
    tq, tk, tv, tdo = (torch.from_numpy(a).to(torch.bfloat16)
                       for a in (q, k, v, do))
    tw, tu = _t(w, u)
    got = ref.linear_scan_bwd_ref(tq, tk, tv, tw, tu, tdo)
    want = ref.linear_scan_bwd_ref(tq.float(), tk.float(), tv.float(), tw,
                                   tu, tdo.float())
    assert [g.dtype for g in got[:5]] == [torch.bfloat16] * 3 \
        + [torch.float32] * 2
    for g, wt in zip(got[:3], want[:3]):
        assert torch.equal(g, wt.to(torch.bfloat16))
    for g, wt in zip(got[3:5], want[3:5]):
        assert torch.equal(g, wt)


def _leaves(arrs, rwkv, state):
    q, k, v, w, u, s0, _, _ = arrs
    out = [t.clone().requires_grad_(True) for t in _t(q, k, v, w)]
    out.append(torch.from_numpy(u).requires_grad_(True) if rwkv else None)
    out.append(torch.from_numpy(s0).requires_grad_(True) if state else None)
    return out


@pytest.mark.parametrize("rwkv", [False, True])
@pytest.mark.parametrize("state", [False, True])
def test_function_on_cpu_tensors_runs_the_plain_backward(rwkv, state,
                                                         monkeypatch):
    """Under grad ``linear_scan`` goes through ``LinearScanFn`` on a CPU
    tensor too: its forward is the plain chunked form, its backward one
    call of ``linear_scan_bwd_ref`` with the output's and the returned
    carry's cotangents, and the gradients are that function's."""
    arrs = _inputs(37, rwkv, state, False, seed=7)
    do, ds = _t(arrs[6], arrs[7])
    calls = []
    real = ref.linear_scan_bwd_ref
    monkeypatch.setattr(ref, "linear_scan_bwd_ref",
                        lambda *a, **kw: calls.append(kw) or real(*a, **kw))
    ops.reset_counts()
    leaves = _leaves(arrs, rwkv, state)
    out = ops.linear_scan(*leaves[:4], u=leaves[4], chunk=16,
                          init_state=leaves[5], return_state=state)
    o, st = out if state else (out, None)
    assert type(o.grad_fn).__name__ == "LinearScanFnBackward"
    q, k, v, w, u, s0 = (None if t is None else t.detach() for t in leaves)
    assert torch.equal(o.detach(), ref.linear_scan_chunked(
        q, k, v, w, u=u, chunk=16, init_state=s0))
    got = torch.autograd.grad((o, st) if state else o,
                              [t for t in leaves if t is not None],
                              (do, ds) if state else do)
    assert ops.function_calls == {"forward": 1, "backward": 1}
    assert ops.launches == 0 and ops.bwd_launches == 0
    assert len(calls) == 1 and calls[0]["chunk"] == 16
    assert (calls[0]["d_state"] is None) == (not state)
    direct = real(q, k, v, w, u, do, chunk=16, init_state=s0, d_state=ds)
    for g, wt in zip(got, [g for g in direct if g is not None]):
        assert torch.equal(g, wt)


def test_function_gradient_of_the_carry_alone():
    """A loss that reads only the returned carry: the output's cotangent
    is None and the backward takes zeros for it."""
    arrs = _inputs(20, True, True, False, seed=8)
    leaves = _leaves(arrs, True, True)
    _, st = ops.linear_scan(*leaves[:4], u=leaves[4], chunk=4,
                            init_state=leaves[5], return_state=True)
    ds = torch.from_numpy(arrs[7])
    got = torch.autograd.grad((st * ds).sum(), leaves)
    want = ref.linear_scan_bwd_ref(*[t.detach() for t in leaves[:5]],
                                   torch.zeros_like(leaves[2]), chunk=4,
                                   init_state=leaves[5].detach(), d_state=ds)
    for g, wt in zip(got, want):
        assert torch.equal(g, wt)


@pytest.mark.parametrize("rwkv", [False, True])
@pytest.mark.parametrize("split", [16, 48])
def test_chained_calls_split_on_a_chunk_boundary_match_one_call(split,
                                                                rwkv):
    """Two calls chained through the carry, split on a chunk boundary,
    give the gradients of one call over all rows, through ``LinearScanFn``
    both ways: bitwise for q, k, v, w and the initial carry (each chunk
    sees the same rows and carries, and the second call's dS0 is the
    first's final cotangent), du within 1e-6 of its largest."""
    arrs = _inputs(64, rwkv, True, False, seed=9)
    do, ds = _t(arrs[6], arrs[7])
    one = _leaves(arrs, rwkv, True)
    o, st = ops.linear_scan(*one[:4], u=one[4], chunk=16, init_state=one[5],
                            return_state=True)
    want = torch.autograd.grad((o, st), [t for t in one if t is not None],
                               (do, ds))
    two = _leaves(arrs, rwkv, True)
    q, k, v, w = two[:4]
    o1, s1 = ops.linear_scan(q[:, :split], k[:, :split], v[:, :split],
                             w[:, :split], u=two[4], chunk=16,
                             init_state=two[5], return_state=True)
    o2, s2 = ops.linear_scan(q[:, split:], k[:, split:], v[:, split:],
                             w[:, split:], u=two[4], chunk=16,
                             init_state=s1, return_state=True)
    assert torch.equal(torch.cat([o1, o2], 1), o) and torch.equal(s2, st)
    got = torch.autograd.grad((torch.cat([o1, o2], 1), s2),
                              [t for t in two if t is not None], (do, ds))
    names = [n for n, t in zip(NAMES, two) if t is not None]
    for name, g, wt in zip(names, got, want):
        if name == "du":
            assert _rel(g.numpy(), wt.numpy()) <= 1e-6
        else:
            assert torch.equal(g, wt), name


def test_backward_refuses_what_the_forward_refuses():
    q = torch.zeros(1, 8, 2, 4)
    v = torch.zeros(1, 8, 2, 6)
    w = torch.ones(1, 8, 2, 4)
    with pytest.raises(ValueError, match="chunk"):
        ops.linear_scan_bwd(q, q, v, w, None, v, chunk=17)
    with pytest.raises(ValueError, match="do"):
        ops.linear_scan_bwd(q, q, v, w, None, q, chunk=4)
    with pytest.raises(ValueError, match="d_state"):
        ops.linear_scan_bwd(q, q, v, w, None, v, chunk=4,
                            d_state=torch.zeros(1, 2, 4, 4))
