"""The scan's backward (``csrc/linear_scan_bwd.cu``) against its plain
version ``ref.linear_scan_bwd_ref``, and ``LinearScanFn`` against autograd
through the plain chunked form, on the card: ``chip_smoke.py``'s phase
``scan_bwd_vs_plain`` at smaller sizes.  Every test here needs an NVIDIA
card and skips without one; run them there with
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_scan_bwd.py``.

Tolerances (``chip_smoke.py``'s LS_RTOL and LS_BWD_AUTOGRAD_RTOL): each
gradient's max |kernel - plain| over its own max |plain|, 2e-2 in bf16
(one rounding of dq, dk, dv to bf16) and 1e-4 in fp32 (sums in another
order than the plain version's); against autograd through the chunked
form the same, but for dw in fp32, 1e-3: XLA's and autograd's VJP of the
factored form reach log w through a difference of neighbouring rows'
terms that cancel (``tests/test_torch_scan_bwd.py``).
"""
import math

import pytest
import torch

from repro_torch.core.ir import TaskGraph, TensorType
from repro_torch.core.lowering import emit
from repro_torch.kernels.linear_scan import kernel, ops, ref

pytestmark = pytest.mark.cuda

RTOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
DW_AUTOGRAD_RTOL = {torch.bfloat16: 2e-2, torch.float32: 1e-3}
CLIP_W = math.exp(-math.exp(2.0))
#: (B, S, H, Dk, Dv, chunk, decay): RWKV6's widths at 256 rows, SMOKE,
#: ragged S (37, 1000), S below the chunk, chunks of 1 and 4, Dk != Dv,
#: Dv past one 64-column tile and off every 32-column slice, the decay
#: clip in every position, and a chunk count that is no multiple of the
#: bf16 route's checkpoint interval (16 G 3 + 16 + 5 rows: 14 chunks, the
#: last group of 2)
SHAPES = [(2, 256, 8, 64, 64, 16, "model"), (2, 28, 4, 16, 16, 16, "model"),
          (2, 37, 4, 64, 64, 16, "model"), (1, 1000, 2, 64, 64, 16, "model"),
          (2, 5, 3, 8, 12, 16, "model"), (2, 40, 3, 8, 12, 1, "model"),
          (2, 50, 3, 32, 100, 4, "model"), (1, 300, 2, 24, 40, 16, "clip"),
          (2, 256, 4, 64, 64, 16, "clip"),
          (2, 16 * kernel.BWD_GROUP * 3 + 16 + 5, 4, 64, 64, 16, "model")]
NAMES = ("dq", "dk", "dv", "dw", "du", "dS0")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def _inputs(cuda, shape, dt, rwkv, state, seed):
    b, s, h, dk, dv, _, decay = shape
    g = torch.Generator(device=cuda).manual_seed(seed)
    q, k = (torch.randn(b, s, h, dk, generator=g, device=cuda).to(dt)
            for _ in range(2))
    v, do = (torch.randn(b, s, h, dv, generator=g, device=cuda).to(dt)
             for _ in range(2))
    if decay == "clip":
        w = torch.full((b, s, h, dk), CLIP_W, device=cuda)
    else:
        r = torch.rand(b, s, h, dk, generator=g, device=cuda)
        w = torch.exp(-torch.exp(-8.0 + 10.0 * r))
    u = torch.randn(h, dk, generator=g, device=cuda) if rwkv else None
    s0, ds = ((torch.randn(b, h, dk, dv, generator=g, device=cuda)
               for _ in range(2)) if state else (None, None))
    return q, k, v, w, u, do, s0, ds


def _rel(got, want) -> float:
    return float((got.float() - want.float()).abs().max()) / max(
        float(want.float().abs().max()), 1e-30)


@pytest.mark.parametrize("state", [False, True])
@pytest.mark.parametrize("rwkv", [False, True])
@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", SHAPES)
def test_scan_bwd_matches_plain(cuda, shape, dt, rwkv, state):
    """The six gradients against the plain version, each in its dtype and
    shape, finite; one count per call; a second call bitwise equal."""
    q, k, v, w, u, do, s0, ds = _inputs(cuda, shape, dt, rwkv, state,
                                        seed=sum(shape[:6]))
    chunk = shape[5]
    before = ops.bwd_launches
    got = ops.linear_scan_bwd(q, k, v, w, u, do, chunk, init_state=s0,
                              d_state=ds)
    torch.cuda.synchronize()
    assert ops.bwd_launches == before + 1
    want = ref.linear_scan_bwd_ref(q, k, v, w, u, do, chunk, init_state=s0,
                                   d_state=ds)
    again = ops.linear_scan_bwd(q, k, v, w, u, do, chunk, init_state=s0,
                                d_state=ds)
    for name, g, wt, a in zip(NAMES, got, want, again):
        if wt is None:
            assert g is None and a is None
            continue
        assert g.dtype == wt.dtype and g.shape == wt.shape, name
        assert bool(torch.isfinite(g).all()), name
        assert _rel(g, wt) <= RTOL[dt], (name, _rel(g, wt))
        assert torch.equal(g, a), name


@pytest.mark.parametrize("rwkv", [False, True])
@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", SHAPES[:4])
def test_function_matches_autograd_through_the_plain_form(cuda, shape, dt,
                                                          rwkv):
    """``linear_scan`` under grad on the card (``LinearScanFn``: the
    forward kernel, the backward kernels) against autograd through
    ``ref.linear_scan_chunked`` on the same inputs, with a carried state."""
    q, k, v, w, u, do, s0, ds = _inputs(cuda, shape, dt, rwkv, True,
                                        seed=7 + sum(shape[:6]))
    chunk = shape[5]

    def grads(fn):
        leaves = [t.detach().requires_grad_(True)
                  for t in (q, k, v, w, u, s0) if t is not None]
        it = iter(leaves)
        a = [next(it) for _ in range(4)]
        uu = next(it) if rwkv else None
        o, st = fn(*a, u=uu, chunk=chunk, init_state=next(it),
                   return_state=True)
        return torch.autograd.grad((o, st), leaves, (do, ds))

    before = ops.bwd_launches
    got = grads(ops.linear_scan)
    assert ops.bwd_launches == before + 1
    want = grads(ref.linear_scan_chunked)
    names = [n for n, t in zip(NAMES, (q, k, v, w, u, s0)) if t is not None]
    for name, g, wt in zip(names, got, want):
        tol = DW_AUTOGRAD_RTOL[dt] if name == "dw" else RTOL[dt]
        assert _rel(g, wt) <= tol, (name, _rel(g, wt))


@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32])
def test_scan_bwd_rows_do_not_depend_on_the_batch(cuda, dt):
    """A batch row's dq, dk, dv, dw and dS0 are the same bits alone as
    among other rows (du, the sum over rows, excepted)."""
    shape = (4, 100, 4, 64, 64, 16, "model")
    q, k, v, w, u, do, s0, ds = _inputs(cuda, shape, dt, True, True, seed=3)
    full = ops.linear_scan_bwd(q, k, v, w, u, do, 16, init_state=s0,
                               d_state=ds)
    one = ops.linear_scan_bwd(*(t[2:3] for t in (q, k, v, w)), u,
                              do[2:3], 16, init_state=s0[2:3],
                              d_state=ds[2:3])
    for name, a, b in zip(NAMES, full, one):
        if name != "du":
            assert torch.equal(a[2:3], b), name


def _split_matches_one_call(cuda, dt, split):
    """Two calls chained through the carry, split at row ``split`` (a chunk
    boundary), against one call of 96 rows through ``LinearScanFn``: the
    first call's rows and dS0 bitwise, everything within RTOL."""
    shape = (2, 96, 4, 64, 64, 16, "model")
    q, k, v, w, u, do, s0, ds = _inputs(cuda, shape, dt, True, True, seed=4)

    def leaves():
        return [t.detach().requires_grad_(True) for t in (q, k, v, w, u, s0)]
    one = leaves()
    o, st = ops.linear_scan(*one[:4], u=one[4], init_state=one[5],
                            return_state=True)
    want = torch.autograd.grad((o, st), one, (do, ds))
    two = leaves()
    o1, s1 = ops.linear_scan(*(t[:, :split] for t in two[:4]), u=two[4],
                             init_state=two[5], return_state=True)
    o2, s2 = ops.linear_scan(*(t[:, split:] for t in two[:4]), u=two[4],
                             init_state=s1, return_state=True)
    got = torch.autograd.grad((torch.cat([o1, o2], 1), s2), two, (do, ds))
    for name, a, b in zip(NAMES, got, want):
        if name in ("dq", "dk", "dv", "dw"):
            assert torch.equal(a[:, :split], b[:, :split]), name
        if name == "dS0":
            assert torch.equal(a, b), name
        assert _rel(a, b) <= RTOL[dt], (name, _rel(a, b))


@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32])
def test_split_on_a_chunk_boundary_matches_one_call(cuda, dt):
    """Two calls chained through the carry, split on a chunk boundary (48
    rows: 3 chunks, inside the one call's first checkpoint group), against
    one call through ``LinearScanFn``.  The first call's rows and the
    initial carry's gradient come out bitwise: the second call's dS0 is
    the one call's dS at the boundary, by the same arithmetic.  The second
    call's rows and du within RTOL: that call starts from the forward
    kernel's final carry, where the one call recomputes it in the
    backward's own arithmetic."""
    _split_matches_one_call(cuda, dt, 48)


@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32])
def test_split_inside_a_later_group_matches_one_call(cuda, dt):
    """The same at 80 rows: 5 chunks, one past the one call's first
    checkpoint group, so the first call ends inside the one call's second
    group (its last group holds 1 chunk where the one call's holds 2)."""
    _split_matches_one_call(cuda, dt, 80)


@pytest.mark.parametrize("rwkv", [False, True])
@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32])
def test_clip_decay_dw_at_the_train_width(cuda, dt, rwkv):
    """dw alone at the decay clip at RWKV6-7B's head widths (64 heads of
    64): within RTOL of the plain version's largest, finite."""
    shape = (1, 512, 64, 64, 64, 16, "clip")
    q, k, v, w, u, do, _, _ = _inputs(cuda, shape, dt, rwkv, False, seed=5)
    got = ops.linear_scan_bwd(q, k, v, w, u, do, 16)[3]
    want = ref.linear_scan_bwd_ref(q, k, v, w, u, do, 16)[3]
    assert bool(torch.isfinite(got).all())
    assert _rel(got, want) <= RTOL[dt], _rel(got, want)


def _mamba2_operands(cuda, dt, b=2, s=2048, h=112, n=64, seed=11):
    """The GLA scan's operands as Zamba2's ``_ssd_gates`` gives them: q = C
    a stride-0 view over the heads, k = dt B, v the x heads, w one decay a
    head broadcast over the state dim (a stride-0 fp32 view), at the
    model's decays: A_log = 0 and dt ~ N(0, 6.6^2), the spread the
    81-layer init gives at d_model 3584."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    c = torch.randn(b, s, n, generator=g, device=cuda).to(dt)
    q = c[:, :, None].expand(b, s, h, n)
    k, v, do = (torch.randn(b, s, h, n, generator=g, device=cuda).to(dt)
                for _ in range(3))
    sp = torch.nn.functional.softplus(
        6.6 * torch.randn(b, s, h, generator=g, device=cuda))
    a = torch.exp(-sp)
    return c, q, k, v, a, a[..., None].expand(b, s, h, n), do


@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32])
def test_gla_bwd_at_mamba2_operands(cuda, dt):
    """The GLA backward at Zamba2-7B's train shape (2 x 2048, 112 heads of
    64 x 64) on Mamba2's operands: q read in place through its stride-0
    head dim and w through its stride-0 state dim, each gradient against
    the plain version on the same views within RTOL; then through
    ``LinearScanFn`` the gradients autograd reduces to C's and the decay's
    shapes (a sum over the 112 heads, one over the 64 state columns)
    against the same reductions of the plain version's."""
    c, q, k, v, a, w, do = _mamba2_operands(cuda, dt)
    assert q.stride(2) == 0 and w.stride(3) == 0
    got = ops.linear_scan_bwd(q, k, v, w, None, do, 16)
    want = ref.linear_scan_bwd_ref(q, k, v, w, None, do, 16)
    for name, g, wt in zip(NAMES[:4], got, want):
        assert g.shape == wt.shape and g.dtype == wt.dtype, name
        assert bool(torch.isfinite(g).all()), name
        assert _rel(g, wt) <= RTOL[dt], (name, _rel(g, wt))
    leaves = [t.detach().requires_grad_() for t in (c, k, v, a)]
    b, s, h, n = q.shape
    with torch.enable_grad():
        o = ops.linear_scan(leaves[0][:, :, None].expand(b, s, h, n),
                            leaves[1], leaves[2],
                            leaves[3][..., None].expand(b, s, h, n))
        dc, dk_, dv_, da = torch.autograd.grad(o, leaves, do)
    for name, g, wt in (("dC", dc, want[0].float().sum(2)),
                        ("dk", dk_, want[1]), ("dv", dv_, want[2]),
                        ("da", da, want[3].sum(3))):
        assert g.shape == wt.shape, name
        assert _rel(g, wt) <= RTOL[dt], (name, _rel(g, wt))


@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32])
def test_launch_gets_the_planned_workspace(cuda, dt, monkeypatch):
    """The wrapper hands ``kernel.launch_bwd`` the workspace of
    ``kernel.bwd_scratch``'s shape (one checkpoint per ``plan_bwd`` group)
    and the launch fills the gradients."""
    shape = (2, 213, 4, 64, 64, 16, "model")
    q, k, v, w, u, do, s0, ds = _inputs(cuda, shape, dt, True, True, seed=6)
    seen = []
    real = kernel.launch_bwd

    def spy(*args):
        seen.append(tuple(args[9].shape))
        real(*args)
    monkeypatch.setattr(kernel, "launch_bwd", spy)
    got = ops.linear_scan_bwd(q, k, v, w, u, do, 16, init_state=s0,
                              d_state=ds)
    want = ref.linear_scan_bwd_ref(q, k, v, w, u, do, 16, init_state=s0,
                                   d_state=ds)
    group = kernel.plan_bwd(dt).group
    assert seen == [(2, 2, 4, -(-14 // group), 64, 64)]
    assert seen[0] == kernel.bwd_scratch(dt, 2, 213, 4, 64, 64, 16)
    for name, g, wt in zip(NAMES, got, want):
        assert _rel(g, wt) <= RTOL[dt], (name, _rel(g, wt))


@pytest.mark.parametrize("impl", ["kernel", "opaque", "chunked", "ref"])
def test_scan_node_under_grad_on_the_card(cuda, impl):
    """Lowering a scan node under grad on the card: ``kernel`` and
    ``opaque`` go through ``LinearScanFn`` (one forward launch, one
    backward launch, the gradients the backward's), the plain composites
    raise as they do without grad."""
    g = TaskGraph("scan")
    t = TensorType((1, 40, 2, 64), "float32")
    ins = [g.add_input(n, t) for n in "qkvw"]
    ins.append(g.add_input("u", TensorType((2, 64), "float32")))
    s_ = g.add("linear_scan", tuple(ins), t, pdims=(0, 2),
               rdims=(("seq", 40),), seq=40, variant="rwkv6")
    g.set_outputs([s_])
    g.nodes[s_].schedule.impl = impl
    q, k, v, w, u, do, _, _ = _inputs(cuda, (1, 40, 2, 64, 64, 16, "model"),
                                      torch.float32, True, False, seed=11)
    leaves = [x.requires_grad_(True) for x in (q, k, v, w, u)]
    feed = dict(zip("qkvwu", leaves))
    if impl in ("chunked", "ref"):
        with pytest.raises(NotImplementedError):
            emit(g)(feed)
        return
    before = (ops.launches, ops.bwd_launches)
    (o,) = emit(g)(feed)
    got = torch.autograd.grad(o, leaves, do)
    assert (ops.launches, ops.bwd_launches) == (before[0] + 1,
                                                before[1] + 1)
    want = ops.linear_scan_bwd(*(x.detach() for x in leaves[:4]),
                               leaves[4].detach(), do)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
