"""The port's region autodiff (``core/autodiff.py``), its remat arm
(``core/schedule.py::pick_remat``), the int8 compression
(``optim/compress.py``) and ``emit``'s liveness, on the CPU.

Small regions (inputs from a numpy seed, fp32) are differentiated three
ways: ``autodiff.grad`` inside a captured region, ``torch.autograd.grad``
of the same body run as a region program under autograd (what the per-op
training step does), and ``jax.grad`` through the JAX package's
``autodiff.grad`` on the same inputs.  Tolerances:

* captured against autograd: bitwise (``torch.equal``) under remat
  ``none`` (every node stored) and ``full`` (every node recomputed);
* the stacked-``index`` rule against the generic rule: bitwise;
* against the JAX package: every entry within 1e-5 of its gradient's
  largest magnitude (rtol 1e-5 on the gradient's scale; XLA and torch sum
  in other orders, and an entry where terms cancel keeps the absolute
  error of its terms);
* ``pick_remat``: the same decision and the same note as the reference's
  on the same node shapes and cost-model constants;
* ``compress_int8`` / ``decompress_int8``: bitwise against the
  reference's.
"""
import dataclasses
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import autodiff as jad
from repro.core import ir as jir
from repro.core import schedule as jsched
from repro.core import tapir as jt
from repro.optim import compress as jcompress
from repro_torch.core import autodiff, lowering, schedule, tapir
from repro_torch.core.ir import TaskGraph, TensorType
from repro_torch.optim import compress

CPU = tapir.TapirConfig(cost_model=schedule.CPU_COST_MODEL)
GPU = tapir.TapirConfig(cost_model=schedule.H100_COST_MODEL)
J_CPU = jt.TapirConfig(cost_model=jsched.CPU_COST_MODEL)


# -- the bodies, one per region; ``ops`` is either package's tapir ---------

def _t_loss(y, t):
    return torch.sum(torch.square(y.to(torch.float32) - t))


def _j_loss(y, t):
    return jnp.sum(jnp.square(y.astype(jnp.float32) - t))


def _t_norm(x, s):
    # x is read twice (its mean square and the product): fan-in inside
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + 1e-6) * s


def _j_norm(x, s):
    return x * jax.lax.rsqrt(jnp.mean(x * x, axis=-1, keepdims=True)
                             + 1e-6) * s


def _matmul_residual(ops, lift, x, w, b, r, t):
    y = ops.linear(x, w, b, activation="silu", residual=r)
    return lift(y, t)


def _attention(ops, lift, q, k, v, t):
    return lift(ops.attention(q, k, v, causal=True), t)


def _scan(ops, lift, q, k, v, w, u, t):
    return lift(ops.wkv_scan(q, k, v, w, u), t)


def _composite(ops, lift, norm, x, s, t):
    y = ops.lift(norm, x, s) + x * 2.0
    return lift(y, t)


def _structural(ops, lift, x, t):
    y = x.reshape(2, 12)
    y = y.to(torch.bfloat16) if ops is tapir else y.astype(jnp.bfloat16)
    return lift(y.reshape(4, 6), t)


def _transpose(ops, lift, x, t):
    return lift(x.T.reshape(6, 4).T, t)


def _add_sub_neg(ops, lift, a, b, t):
    y = (a + b) - (-(a - b)) + a
    return lift(y, t)


def _unused(ops, lift, x, w, t):
    return lift(x * 2.0, t)


REGIONS = {
    # name: (body, input shapes, cost model, in the JAX comparison)
    "matmul_residual": (_matmul_residual, [(6, 8), (8, 5), (5,), (6, 5),
                                           (6, 5)], CPU, True),
    "attention_cpu": (_attention, [(2, 8, 4, 8), (2, 8, 2, 8), (2, 8, 2, 8),
                                   (2, 8, 4, 8)], CPU, True),
    "attention_flash": (_attention, [(2, 8, 4, 8), (2, 8, 2, 8),
                                     (2, 8, 2, 8), (2, 8, 4, 8)], GPU, True),
    "linear_scan": (_scan, [(1, 8, 2, 4)] * 4 + [(2, 4), (1, 8, 2, 4)], GPU,
                    True),
    "composite": (_composite, [(4, 6), (6,), (4, 6)], CPU, True),
    "structural": (_structural, [(4, 6), (4, 6)], CPU, True),
    "transpose": (_transpose, [(4, 6), (4, 6)], CPU, False),
    "add_sub_neg": (_add_sub_neg, [(5, 3), (5, 3), (5, 3)], CPU, True),
    "unused_leaf": (_unused, [(3, 4), (2, 2), (3, 4)], CPU, True),
}


def _inputs(name):
    rng = np.random.default_rng(0)
    shapes = REGIONS[name][1]
    out = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    if name == "linear_scan":     # the decay in (0, 1)
        out[3] = (0.5 + 0.4 * rng.random(shapes[3])).astype(np.float32)
    return out


def _torch_body(name):
    body = REGIONS[name][0]
    lift = lambda y, t: tapir.lift(_t_loss, y, t)   # noqa: E731
    if body is _composite:
        return lambda *a: body(tapir, lift, _t_norm, *a)
    return lambda *a: body(tapir, lift, *a)


def _jax_body(name):
    body = REGIONS[name][0]
    lift = lambda y, t: jt.lift(_j_loss, y, t)   # noqa: E731
    if body is _composite:
        return lambda *a: body(jt, lift, _j_norm, *a)
    return lambda *a: body(jt, lift, *a)


def _eager_grads(name, arrays):
    """torch.autograd.grad of the body run as a region program."""
    body = _torch_body(name)
    leaves = [torch.from_numpy(a).requires_grad_() for a in arrays]
    with tapir.use(REGIONS[name][2]):
        loss = tapir.parallel_region(body, name=f"eager_{name}")(*leaves)
        grads = torch.autograd.grad(loss, leaves[:-1], allow_unused=True,
                                    materialize_grads=True)
    return loss.detach(), grads


def _captured_grads(name, arrays, policy):
    body = _torch_body(name)

    def cap(*args):
        loss, grads = autodiff.grad(body(*args), list(args[:-1]),
                                    policy=policy)
        return loss, grads
    cap.__name__ = f"cap_{name}_{policy}"
    tens = [torch.from_numpy(a) for a in arrays]
    cfg = dataclasses.replace(REGIONS[name][2], remat=policy)
    with tapir.use(cfg), torch.no_grad():
        return tapir.parallel_region(cap)(*tens)


@pytest.fixture(autouse=True)
def _fresh_cache():
    tapir.clear_cache()
    yield
    tapir.clear_cache()


@pytest.mark.parametrize("policy", ["none", "full"])
@pytest.mark.parametrize("name", sorted(REGIONS))
def test_grad_equals_autograd_bitwise(name, policy):
    arrays = _inputs(name)
    want_loss, want = _eager_grads(name, arrays)
    loss, got = _captured_grads(name, arrays, policy)
    assert torch.equal(loss, want_loss)
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        assert torch.equal(a, b), (name, i, float((a - b).abs().max()))
    if name == "unused_leaf":
        assert not got[1].any()
    g = next(g for g in tapir.cached_graphs().values()
             if getattr(g, "grad_meta", None))
    kind = "store" if policy == "none" else "recompute"
    assert g.grad_meta["remat"][kind] > 0
    assert g.grad_meta["remat"][{"store": "recompute",
                                 "recompute": "store"}[kind]] == 0


@pytest.mark.parametrize("name", sorted(n for n in REGIONS if REGIONS[n][3]))
def test_grad_matches_the_reference_autodiff(name):
    arrays = _inputs(name)
    _, got = _captured_grads(name, arrays, "auto")
    body = _jax_body(name)

    def cap(*args):
        return jad.grad(body(*args), list(args[:-1]), policy="auto")
    with jt.use(J_CPU):
        loss, want = jt.parallel_region(cap, name=f"j_{name}")(
            *[jnp.asarray(a) for a in arrays])
    for i, (a, b) in enumerate(zip(got, want)):
        b = np.asarray(b)
        err = np.abs(a.numpy() - b).max()
        assert err <= 1e-5 * max(np.abs(b).max(), 1e-30), (name, i, err)


def _stack_body(W, x, t):
    for i in (0, 2):           # slab 1 is never read: its gradient is zero
        x = tapir.linear(x, W[i], activation="tanh")
    return tapir.lift(_t_loss, x, t)


@pytest.mark.parametrize("policy", ["none", "full"])
def test_stacked_index_rule_equals_the_generic_rule(policy, monkeypatch):
    rng = np.random.default_rng(1)
    W = torch.from_numpy(rng.standard_normal((3, 4, 4)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((2, 4)).astype(np.float32))
    t = torch.zeros(2, 4)

    def cap(W, x, t):
        return autodiff.grad(_stack_body(W, x, t), [W, x], policy=policy)

    def run(tag):
        cap.__name__ = f"stack_{tag}_{policy}"
        with tapir.use(dataclasses.replace(CPU, remat=policy)), \
                torch.no_grad():
            return tapir.parallel_region(cap)(W, x, t)[1]
    native = run("native")
    g = next(g for g in tapir.cached_graphs().values()
             if getattr(g, "grad_meta", None))
    stacks = [n for n in g.nodes.values() if n.op == "pyfunc"
              and n.attrs["fn"] is autodiff._stack_slabs]
    assert len(stacks) == 1 and dict(stacks[0].attrs["static"])[
        "present"] == (0, 2)
    tapir.clear_cache()
    monkeypatch.setattr(autodiff, "_leading_index", lambda g, n: None)
    generic = run("generic")
    for a, b in zip(native, generic):
        assert torch.equal(a, b)
    assert not native[0][1].any() and native[0][0].any()
    with torch.enable_grad():
        Wl, xl = W.clone().requires_grad_(), x.clone().requires_grad_()
        with tapir.use(CPU):
            loss = tapir.parallel_region(_stack_body)(Wl, xl, t)
        want = torch.autograd.grad(loss, [Wl, xl])
    for a, b in zip(native, want):
        assert torch.equal(a, b)


# -- pick_remat against the reference's -------------------------------------

def _remat_graph(IR):
    g = IR.TaskGraph("remat")
    TT = IR.TensorType
    x = g.add_input("x", TT((256, 512), "bfloat16"))
    w = g.add_input("w", TT((512, 1024), "bfloat16"))
    mm = g.add("matmul", (x, w), TT((256, 1024), "bfloat16"), pdims=(0, 1),
               rdims=(("k", 512),), k=512)
    ew = g.add("ew", (mm,), TT((256, 1024), "bfloat16"), pdims=(0, 1),
               fn="silu")
    red = g.add("pyfunc", (mm,), TT((256, 1), "float32"), fn=len)
    q = g.add_input("q", TT((2, 128, 8, 64), "bfloat16"))
    kv = g.add_input("kv", TT((2, 128, 2, 64), "bfloat16"))
    at = g.add("attention", (q, kv, kv), TT((2, 128, 8, 64), "bfloat16"),
               pdims=(0, 1, 2), rdims=(("kv", 128),), causal=True,
               q_shape=(2, 128, 8, 64), kv_len=128, kv_heads=2)
    return g, (mm, ew, red, at)


def _h100_like(cm):
    return dataclasses.replace(cm, name="h100_sxm", peak_flops=989e12,
                               hbm_bw=3.35e12)


@pytest.mark.parametrize("policy", ["auto", "none", "full", "dots"])
@pytest.mark.parametrize("target", ["cpu", "h100"])
def test_pick_remat_matches_the_reference(policy, target):
    cm = schedule.CPU_COST_MODEL
    jcm = jsched.CPU_COST_MODEL
    if target == "h100":
        cm, jcm = schedule.H100_COST_MODEL, _h100_like(jcm)
    assert (cm.remat_store_roundtrips, cm.remat_bias) == (
        jcm.remat_store_roundtrips, jcm.remat_bias) == (2.0, 1.0)
    g, nids = _remat_graph(__import__("repro_torch.core.ir",
                                      fromlist=["TaskGraph"]))
    jg, jnids = _remat_graph(jir)
    for n, jn in zip(nids, jnids):
        got = schedule.pick_remat(g, g.nodes[n], cm, policy)
        want = jsched.pick_remat(jg, jg.nodes[jn], jcm, policy)
        assert got == want, (g.nodes[n].op, policy)
        assert g.nodes[n].schedule.notes == jg.nodes[jn].schedule.notes
    if policy == "auto" and target == "h100":
        picks = [schedule.pick_remat(g, g.nodes[n], cm, policy)
                 for n in nids]
        assert picks == ["store", "recompute", "store", "store"]


# -- int8 compression against the reference's ------------------------------

@pytest.mark.parametrize("shape", [(256,), (3, 100), (7, 300), (2, 2, 64)])
def test_compress_int8_matches_the_reference_bitwise(shape):
    rng = np.random.default_rng(2)
    a = rng.standard_normal(shape).astype(np.float32) * 3.0
    a.reshape(-1)[:min(a.size, 256)] = 0.0      # an all-zero block
    q, s = compress.compress_int8(torch.from_numpy(a))
    jq, js = jcompress.compress_int8(jnp.asarray(a))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    d = compress.decompress_int8(q, s, shape)
    np.testing.assert_array_equal(
        d.numpy(), np.asarray(jcompress.decompress_int8(jq, js, shape)))
    with pytest.raises(NotImplementedError, match="item 8"):
        compress.compressed_allreduce([], None, "pod", 2)


# -- emit's liveness ---------------------------------------------------------

_ALIVE: list = []
_PEAK = [0]


def _chain_step(x):
    y = x + 1.0
    _PEAK[0] = max(_PEAK[0], sum(r() is not None for r in _ALIVE))
    _ALIVE.append(weakref.ref(y))
    return y


def test_emit_drops_values_after_their_last_reader():
    """A chain of 40 nodes holds O(1) values at a time; an output taken
    early in the chain, the inputs and a donated buffer stay intact."""
    g = TaskGraph("chain")
    tt = TensorType((4,), "float32")
    x = g.add_input("x", tt)
    buf = g.add_input("buf", TensorType((8,), "float32"))
    h = x
    early = None
    for i in range(40):
        h = g.add("pyfunc", (h,), tt, fn=_chain_step)
        if i == 5:
            early = h
    w = g.add("dynamic_update_slice", (buf, h), TensorType((8,), "float32"),
              donates=buf, static_starts=(2,))
    g.set_outputs([h, early, w])
    run = lowering.emit(g)
    _ALIVE.clear()
    _PEAK[0] = 0
    xv, bv = torch.zeros(4), torch.zeros(8)
    with torch.no_grad():
        out, early_v, wv = run({"x": xv, "buf": bv})
    assert _PEAK[0] <= 3          # without liveness: 39 of 40 alive
    assert torch.equal(out, torch.full((4,), 40.0))
    assert torch.equal(early_v, torch.full((4,), 6.0))
    assert wv is bv and torch.equal(bv[2:6], out) and not bv[:2].any()
    assert not xv.any()
