"""MoE training in the port (``train/step.py::make_train_step`` and the
captured ``train/region_step.py::make_region_train_step`` on
``models/moe.py``) against the JAX package's, and the port's own
guarantees, at the SMOKE shapes of Granite-3.0-1B-A400M and
Moonlight-16B-A3B (its dense first layer) on the CPU in fp32 compute.

The weights are the reference's ``init_params(PRNGKey(0))`` carried across
as numpy; the batches are ``TokenPipeline``'s (the same bytes in both
packages), B x S = 4 x 16 tokens: capacity ceil(64 x 2 / 8 x 1.25) = 20
rows an expert, so routes are dropped (asserted).  The reference step is
its launcher's ``raw_step`` (no mesh: ``jax.value_and_grad`` of
``model.loss``, then ``adamw_update``).  On CPU tensors the grouped GEMM's
backward runs its plain versions (``ref.grouped_matmul_dx_ref`` /
``grouped_matmul_dw_ref``, a loop of the 2-D ones), which the card's
launches equal (``tests/test_torch_cuda_moe.py``).  Tolerances, those of
the dense steps' tests (XLA and torch sum in other orders):

* the grouped VJP against ``jax.vjp`` of the reference's grouped einsum:
  1e-5 of each gradient's largest entry;
* the first step's routing (expert ids, capacity positions, keep mask):
  exactly, every layer;
* loss rtol 1e-5 and lr rtol 1e-6 every step; the grad norm rtol 1e-4 at
  the first step and 1e-3 after it; each leaf's first gradient within
  2e-4 of its largest entry, against the reference and against an fp64
  evaluation of both packages (which agree within 1e-9);
* inside the port: remat full = none bitwise; opaque against tapir rtol
  1e-5 on the loss and 1e-4 relative on each gradient.  Captured = per-op
  (plain, 2 microbatches, int8 + error feedback) and a resumed run = the
  uninterrupted one, bitwise, are the MoE cases of
  ``tests/test_torch_region_step.py`` and ``tests/test_torch_checkpoint.py``.
"""
import collections
import dataclasses
import importlib.util
import json
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as RC
from repro import optim as jopt
from repro.core import tapir as jtapir
from repro.core.schedule import CPU_COST_MODEL as J_CPU
from repro.core.tapir import TapirConfig as JTapirConfig
from repro.core.tapir import use as j_use
from repro.data import DataConfig as JDataConfig
from repro.data import TokenPipeline as JTokenPipeline
from repro.models import moe as jmoe
from repro.models.base import get_model as j_get_model
from repro_torch import optim
from repro_torch.configs import get_config, get_smoke
from repro_torch.core import tapir
from repro_torch.data import DataConfig, TokenPipeline, to_device
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.fused_matmul import ops as fm_ops
from repro_torch.kernels.fused_matmul import ref as fm_ref
from repro_torch.launch import train as launch_train
from repro_torch.models import layers as L
from repro_torch.models import moe
from repro_torch.models.convert import params_from_numpy
from repro_torch.train import (TrainConfig, init_state,
                               make_region_train_step, make_train_step)

ARCHS = ["granite_moe_1b_a400m", "moonshot_v1_16b_a3b"]
B, S, STEPS = 4, 16, 3
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=STEPS)
CPU = TrainConfig(target="cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _fresh_cache():
    tapir.clear_cache()
    yield
    tapir.clear_cache()


_REFS: dict = {}


def _reference(arch):
    """(reference model, its params as numpy) at fp32 compute, made once
    a process."""
    if arch not in _REFS:
        cfg = dataclasses.replace(RC.get_smoke(arch),
                                  compute_dtype="float32")
        jm = j_get_model(cfg)
        jp = jm.init_params(jax.random.PRNGKey(0))
        _REFS[arch] = jm, jax.tree_util.tree_map(np.asarray, jp)
    return _REFS[arch]


def _port(arch):
    cfg = dataclasses.replace(get_smoke(arch), compute_dtype="float32")
    return params_from_numpy(_reference(arch)[1], cfg, device="cpu")


def _batches(n=STEPS, batch=B):
    pipe = TokenPipeline(DataConfig(seq_len=S, global_batch=batch,
                                    vocab=512))
    want = JTokenPipeline(JDataConfig(seq_len=S, global_batch=batch,
                                      vocab=512))
    out = [pipe.batch_at(s) for s in range(n)]
    for s, b in enumerate(out):
        np.testing.assert_array_equal(b["tokens"], want.batch_at(s)["tokens"])
    return out


def _raw_step(jm):
    """The reference launcher's per-op step (``launch/train.py``, no
    mesh), also returning the gradients."""
    tap = JTapirConfig(mode="tapir", remat="none", cost_model=J_CPU)
    cfg = jopt.AdamWConfig(**OPT)

    def step(state, batch):
        def loss_fn(p):
            with j_use(tap):
                return jm.loss(p, batch)
        loss, grads = jax.value_and_grad(loss_fn)(state["params"])
        p2, o2, m = jopt.adamw_update(state["params"], grads, state["opt"],
                                      cfg)
        return {"params": p2, "opt": o2}, {"loss": loss, **m}, grads
    return jax.jit(step)


def _grads(model, batch, tcfg=CPU):
    with tapir.use(tcfg.tapir_config()), model.trainable():
        loss = model.loss(to_device(batch, "cpu"))
        return loss.detach(), torch.autograd.grad(
            loss, optim.tree_leaves(model.param_tree()))


def _bitwise(a, b) -> bool:
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


# ---------------------------------------------------------------------------
# The grouped GEMM's backward
# ---------------------------------------------------------------------------


def _expert_shapes():
    """(E, C, k, n) of each SMOKE config's gate / up and down products."""
    out = []
    for arch in ARCHS:
        c = get_smoke(arch)
        out += [(c.n_experts, 20, c.d_model, c.d_ff),
                (c.n_experts, 20, c.d_ff, c.d_model)]
    return out


@pytest.mark.parametrize("E,C,k,n", _expert_shapes())
def test_grouped_plain_backward_matches_per_expert_and_jax_vjp(E, C, k, n):
    """``grouped_matmul_dx_ref`` / ``grouped_matmul_dw_ref`` equal a loop
    of the 2-D plain versions bitwise, and ``jax.vjp`` of the reference's
    grouped einsum (``core/lowering.py``: ``e...mk,ekn->e...mn``, fp32
    accumulation) within 1e-5 of each gradient's largest entry."""
    rng = np.random.default_rng(E + C + k + n)
    x = rng.normal(size=(E, C, k)).astype(np.float32)
    w = (rng.normal(size=(E, k, n)) / np.sqrt(k)).astype(np.float32)
    dy = rng.normal(size=(E, C, n)).astype(np.float32)
    tx, tw, tdy = map(torch.from_numpy, (x, w, dy))
    dx = fm_ref.grouped_matmul_dx_ref(tdy, tw)
    dw = fm_ref.grouped_matmul_dw_ref(tx, tdy)
    assert torch.equal(dx, torch.stack([fm_ref.matmul_dx_ref(tdy[e], tw[e])
                                        for e in range(E)]))
    assert torch.equal(dw, torch.stack([fm_ref.matmul_dw_ref(tx[e], tdy[e])
                                        for e in range(E)]))

    def einsum(a, b):
        return jnp.einsum("e...mk,ekn->e...mn", a, b,
                          preferred_element_type=jnp.float32)
    _, vjp = jax.vjp(einsum, jnp.asarray(x), jnp.asarray(w))
    want_dx, want_dw = (np.asarray(g) for g in vjp(jnp.asarray(dy)))
    for got, want in ((dx, want_dx), (dw, want_dw)):
        assert np.abs(got.numpy() - want).max() <= \
            1e-5 * np.abs(want).max()


@pytest.mark.parametrize("E,C,k,n", _expert_shapes()[::2])
def test_grouped_function_gate_chain_matches_jax_vjp(E, C, k, n):
    """``FusedMatmulFn`` on a 3-D weight with the gate's fused ``silu,
    mul`` chain (the up product a full operand): its backward (the chain's
    VJP on the recomputed fp32 product, then the grouped dX / dW) against
    ``jax.vjp`` of the reference's einsum followed by ``silu(.) * up``:
    every gradient within 1e-5 of its largest entry."""
    rng = np.random.default_rng(C + k)
    x = rng.normal(size=(E, C, k)).astype(np.float32)
    w = (rng.normal(size=(E, k, n)) / np.sqrt(k)).astype(np.float32)
    up = rng.normal(size=(E, C, n)).astype(np.float32)
    dy = rng.normal(size=(E, C, n)).astype(np.float32)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (x, w, up)]
    fm_ops.reset_counts()
    y = fm_ops.fused_matmul(
        leaves[0], leaves[1],
        epilogue=[("silu", [], {"dtype": "float32"}),
                  ("mul", [leaves[2]], {"dtype": "float32"})])
    got = torch.autograd.grad(y, leaves, torch.from_numpy(dy))
    assert fm_ops.function_calls == collections.Counter(forward=1,
                                                        backward=1)

    def ref(a, b, u):
        h = jnp.einsum("e...mk,ekn->e...mn", a, b,
                       preferred_element_type=jnp.float32)
        return jax.nn.silu(h) * u
    _, vjp = jax.vjp(ref, *map(jnp.asarray, (x, w, up)))
    for g, want in zip(got, vjp(jnp.asarray(dy))):
        want = np.asarray(want)
        assert np.abs(g.numpy() - want).max() <= 1e-5 * np.abs(want).max()


# ---------------------------------------------------------------------------
# The step against the reference's
# ---------------------------------------------------------------------------


def _spy_routes(monkeypatch):
    """Record (expert ids, capacity positions, keep mask) of every routing
    call in both packages, in call order (the reference's through a
    host callback: its layers run inside ``lax.scan``)."""
    got = {"port": [], "ref": []}
    port_route, ref_route = moe._route_topk, jmoe._route_topk

    def port(xt, router, **kw):
        out = port_route(xt, router, **kw)
        got["port"].append(tuple(t.detach().numpy().copy()
                                 for t in out[1:]))
        return out

    def ref(xt, router, **kw):
        out = ref_route(xt, router, **kw)
        jax.debug.callback(
            lambda *a: got["ref"].append(tuple(np.asarray(t) for t in a)),
            *out[1:])
        return out
    monkeypatch.setattr(moe, "_route_topk", port)
    monkeypatch.setattr(jmoe, "_route_topk", ref)
    return got


def _ref_first(arch, batch, dtype=None):
    """The reference's loss and gradients (``tree_leaves`` order, numpy) on
    ``batch`` per op in tapir mode; with ``dtype`` "float64" every fp32
    evaluation promoted (under ``enable_x64``, ``jnp.float32`` read as
    ``jnp.float64``)."""
    tap = JTapirConfig(mode="tapir", remat="none", cost_model=J_CPU)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    if dtype is None:
        jm, tree = _reference(arch)

        def loss_fn(p):
            with j_use(tap):
                return jm.loss(p, jb)
        loss, grads = jax.value_and_grad(loss_fn)(
            jax.tree_util.tree_map(jnp.asarray, tree))
        return float(loss), jax.tree_util.tree_leaves(grads), grads
    tree = _reference(arch)[1]
    jtapir.clear_cache()      # programs traced at fp32 must not be reused
    with jax.enable_x64(True), pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnp, "float32", jnp.float64)
        jm = j_get_model(dataclasses.replace(RC.get_smoke(arch),
                                             compute_dtype="float64"))

        def loss_fn(p):
            with j_use(tap):
                return jm.loss(p, jb)
        loss, grads = jax.value_and_grad(loss_fn)(jax.tree_util.tree_map(
            lambda a: jnp.asarray(a, jnp.float64), tree))
        grads = [np.asarray(g) for g in jax.tree_util.tree_leaves(grads)]
    jtapir.clear_cache()
    assert all(g.dtype == np.float64 for g in grads)
    return float(loss), grads, None


def _port_fp64_first(arch, batch):
    """The port's loss and gradients with every fp32 evaluation promoted
    (``torch.float32`` read as ``torch.float64`` while it runs, fp64
    compute and params, the RoPE tables made anew), per op, remat
    none."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch, "float32", torch.float64)
        # RoPE tables memoized by an fp32 run must not be reused
        mp.setattr(L, "_ARANGE_ROPE", {})
        cfg = dataclasses.replace(get_smoke(arch), compute_dtype="float64")
        tm = params_from_numpy(_reference(arch)[1], cfg, device="cpu")
        for p in optim.tree_leaves(tm.param_tree()):
            p.data = p.data.double()
        loss, grads = _grads(tm, batch, TrainConfig(target="cpu",
                                                    remat="none"))
    assert all(g.dtype == torch.float64 for g in grads)
    return float(loss), [g.numpy() for g in grads]


def _rel(got, want) -> list:
    """max |got - want| / max |want|, leaf by leaf."""
    return [float(np.abs(np.asarray(g, np.float64) - w).max()
                  / np.abs(w).max()) for g, w in zip(got, want)]


@pytest.mark.parametrize("arch", ARCHS)
def test_first_step_routing_and_gradients_match_reference(arch,
                                                          monkeypatch):
    """The first batch: every layer routes each token to the same experts
    at the same capacity positions with the same keep mask in both
    packages, and drops routes; the loss within rtol 1e-5 of
    ``jax.value_and_grad`` of the reference's ``loss``, each leaf's
    gradient within 2e-4 of its largest entry (the dense family's bound;
    the two fp32 gradients differ by up to 1.4e-4 in the norms' leaves,
    each sitting up to 1e-4 / 2.1e-4 from the fp64 evaluation in its own
    direction: ``test_first_gradients_against_an_fp64_evaluation``)."""
    routes = _spy_routes(monkeypatch)
    batch = _batches(1)[0]
    jloss, jgrads, jtree = _ref_first(arch, batch)
    jax.effects_barrier()
    loss, grads = _grads(_port(arch), batch,
                         TrainConfig(target="cpu", remat="none"))
    cfg = get_smoke(arch)
    n_moe = cfg.n_layers - cfg.first_dense_layers
    assert len(routes["port"]) == len(routes["ref"]) == n_moe
    for got, want in zip(routes["port"], routes["ref"]):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    assert any(not keep.all() for _, _, keep in routes["port"])
    np.testing.assert_allclose(float(loss), jloss, rtol=1e-5)
    paths = [jax.tree_util.keystr(k) for k, _ in
             jax.tree_util.tree_leaves_with_path(jtree)]
    assert "['blocks']['moe']['ewg']" in paths
    want = [np.asarray(g) for g in jgrads]
    assert [tuple(g.shape) for g in grads] == [w.shape for w in want]
    for path, e in zip(paths, _rel([g.numpy() for g in grads], want)):
        assert e <= 2e-4, (path, e)


@pytest.mark.parametrize("arch", ARCHS)
def test_first_gradients_against_an_fp64_evaluation(arch):
    """The witness for the gradient bound: evaluated with every fp32 step
    promoted to fp64, the two packages agree (loss rtol 1e-12, each leaf
    within 1e-9 of its largest: the same routing, drops, dispatch and
    combine), and the port's fp32 gradient lies within 2e-4 of each
    leaf's largest from that evaluation (the bound the dense family's
    step is held to against the reference; 9.9e-5 / 8.3e-5 on the CPU);
    the reference's own fp32 gradient lies up to 2.1e-4 from it
    (Moonlight's SMOKE)."""
    batch = _batches(1)[0]
    loss64, exact = _port_fp64_first(arch, batch)
    jloss64, jexact, _ = _ref_first(arch, batch, "float64")
    np.testing.assert_allclose(loss64, jloss64, rtol=1e-12)
    assert max(_rel(exact, jexact)) <= 1e-9
    _, grads = _grads(_port(arch), batch,
                      TrainConfig(target="cpu", remat="none"))
    assert max(_rel([g.numpy() for g in grads], exact)) <= 2e-4


@pytest.mark.parametrize("arch", ARCHS)
def test_three_steps_match_the_reference_raw_step(arch):
    jm, tree = _reference(arch)
    tm = _port(arch)
    jstep = _raw_step(jm)
    jstate = {"params": jax.tree_util.tree_map(jnp.asarray, tree)}
    jstate["opt"] = jopt.adamw_init(jstate["params"], jopt.AdamWConfig(**OPT))
    step = make_train_step(tm, optim.AdamWConfig(**OPT), CPU)
    state = init_state(tm, optim.AdamWConfig(**OPT))
    for s, batch in enumerate(_batches()):
        jstate, jm_, _ = jstep(jstate, {k: jnp.asarray(v)
                                        for k, v in batch.items()})
        state, m = step(state, to_device(batch, "cpu"))
        np.testing.assert_allclose(float(m["loss"]), float(jm_["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(m["lr"]), float(jm_["lr"]),
                                   rtol=1e-6)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm_["grad_norm"]),
                                   rtol=1e-4 if s == 0 else 1e-3)
    assert int(state["opt"]["step"]) == STEPS


# ---------------------------------------------------------------------------
# The port's own guarantees
# ---------------------------------------------------------------------------


def _chip_smoke():
    """``chip_smoke.py`` at the root of the checkout, as a module (it
    imports nothing at module level but the standard library)."""
    if "chip_smoke" not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            "chip_smoke", pathlib.Path(__file__).resolve().parents[1]
            / "chip_smoke.py")
        mod = importlib.util.module_from_spec(spec)
        sys.modules["chip_smoke"] = mod     # its dataclasses look it up
        spec.loader.exec_module(mod)
    return sys.modules["chip_smoke"]


@pytest.mark.parametrize("arch", ARCHS)
def test_the_step_goes_through_the_functions_and_updates_in_place(
        arch, monkeypatch):
    """Every product of a step goes through ``FusedMatmulFn`` (the 3-D
    ones on the grouped route both ways) and every attention through
    ``FlashAttentionFn``, as many times as ``chip_smoke.py``'s
    ``moe_train_launches`` counts the card's launches (on CPU tensors the
    plain versions: no launch); every leaf gets a finite gradient and is
    updated in its own storage."""
    tm = _port(arch)
    calls = collections.Counter()
    real_product = fm_ops._product

    def product(x, w, *a):
        calls["grouped_forward" if w.ndim == 3 else "gemm_forward"] += 1
        return real_product(x, w, *a)
    monkeypatch.setattr(fm_ops, "_product", product)
    for route, key in (("matmul_dx", "gemm_dx"), ("matmul_dw", "gemm_dw"),
                       ("matmul_dx_grouped", "grouped_dx"),
                       ("matmul_dw_grouped", "grouped_dw")):
        def counted(*a, _real=getattr(fm_ops, route), _key=key, **kw):
            calls[_key] += 1
            return _real(*a, **kw)
        monkeypatch.setattr(fm_ops, route, counted)
    fa_ops.reset_counts()
    leaves = optim.tree_leaves(tm.param_tree())
    before = [t.clone() for t in leaves]
    ptrs = [t.data_ptr() for t in leaves]
    step = make_train_step(tm, optim.AdamWConfig(**OPT),
                           TrainConfig(target="gpu"))
    step(init_state(tm, optim.AdamWConfig(**OPT)),
         to_device(_batches(1)[0], "cpu"))
    want = _chip_smoke().moe_train_launches(tm.cfg)
    calls["flash_forward"] = fa_ops.function_calls["forward"]
    calls["flash_backward"] = fa_ops.function_calls["backward"]
    assert dict(calls) == want
    assert fm_ops.launches == 0 and fa_ops.launches == 0
    assert [t.data_ptr() for t in leaves] == ptrs
    assert all(not torch.equal(a, b) for a, b in zip(before, leaves))
    _, grads = _grads(tm, _batches(1)[0])
    assert all(bool(torch.isfinite(g).all()) for g in grads)


@pytest.mark.parametrize("name,route", [
    ("void gemm_bf16_kernel<256, 0, 1, 0>(CUtensorMap, CUtensorMap, void*, "
     "int, int, int, int, int, int, int, Epilogue)", "forward"),
    ("gemm_bf16_kernel<128, 0, 0, 0>", "dx"),
    ("gemm_bf16_kernel<64, 1, 1, 0>", "dw"),
    ("void gemm_bf16_kernel<128, 0, 1, 1>(CUtensorMap, ...)",
     "grouped_forward"),
    ("gemm_bf16_kernel<256, 0, 0, 1>", "grouped_dx"),
    ("gemm_bf16_kernel<128, 1, 1, 1>", "grouped_dw"),
    ("gemm_bf16_kernel<256, 0, 1>", "forward"),
    ("gemm_bf16_kernel<256, 1, 0, 0>", "other"),
    ("void gemm_f32_kernel<64, 64, 32, 4, 4, 1, 0>(float const*, ...)",
     "fp32"),
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64", None),
    ("dkdv_bf16_kernel<128>", None)])
def test_chip_smoke_reads_the_gemm_route_from_a_profile_name(name, route):
    """The train phases sum the GEMM's device time by route from the
    kernels' profile names: the template arguments <BN, TA, TB, G> carry
    the layout and the grouped route (a name with three arguments read as
    a 2-D launch's); the fp32 kernel is one route; a library's kernel and
    the flash backward's are none."""
    assert _chip_smoke().gemm_route_of(name) == route


def test_chip_smoke_splits_the_router_from_the_bf16_products():
    """``launches_by_shape`` keys carry the operand dtype as torch names
    it ("torch.float32"): the router's fp32 products go to their fp32
    entries, the bf16 products (one at the router's own shape included)
    to the 2-D entries, the grouped launches by (E, C, n, k, chain)."""
    cs = _chip_smoke()
    paths = collections.Counter({
        (4, 64, 2048, "torch.float32", ()): 19,
        (4, 64, 2048, "torch.bfloat16", ()): 1,
        (4, 6144, 2048, "torch.bfloat16", ()): 20,
        ("grouped", 64, 4, 1408, 2048, "torch.bfloat16", ()): 19})
    grouped, router, flat = cs.moe_path_shapes(paths)
    assert grouped == {(64, 4, 1408, 2048, ()): 19}
    assert router == {(4, 64, 2048, "torch.float32", ()): 19}
    assert set(flat) == {(4, 64, 2048, "torch.bfloat16", ()),
                         (4, 6144, 2048, "torch.bfloat16", ())}
    granite = get_config("granite_moe_1b_a400m")
    assert cs.label(1024, 1024, granite) == "wo"
    assert cs.label(32, 1024, granite) == "router"


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_full_equals_none_bitwise(arch):
    """Remat recomputes each layer's routing, dispatch and expert FFN: the
    same loss and gradients, bit for bit."""
    tm = _port(arch)
    batch = _batches(1)[0]
    out = {r: _grads(tm, batch, TrainConfig(target="cpu", remat=r))
           for r in ("none", "full")}
    assert torch.equal(out["none"][0], out["full"][0])
    assert _bitwise(out["none"][1], out["full"][1])


@pytest.mark.parametrize("arch", ARCHS)
def test_opaque_mode_matches_tapir(arch):
    """opaque (E 2-D products an expert GEMM, no fused chain) against
    tapir (one grouped launch, the gate's chain fused)."""
    tm = _port(arch)
    batch = _batches(1)[0]
    lt, gt = _grads(tm, batch)
    lo, go = _grads(tm, batch, TrainConfig(target="cpu", mode="opaque"))
    np.testing.assert_allclose(float(lo), float(lt), rtol=1e-5)
    for a, b in zip(go, gt):
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())


@pytest.mark.parametrize("arch", ARCHS)
def test_the_captured_step_differentiates_the_dispatch_as_nodes(arch):
    """The captured step's joint graph holds the whole routed FFN as
    nodes (its bits against the per-op step's are
    ``tests/test_torch_region_step.py``'s): the router one lifted tuple
    call, the dispatch a ``zero_init`` scatter, the combine a gather, the
    expert GEMMs 3-D ``matmul`` nodes bound to the kernel, and their
    VJPs."""
    model = _port(arch)
    opt_cfg = optim.AdamWConfig(**OPT)
    step = make_region_train_step(model, opt_cfg,
                                  TrainConfig(remat="auto", target="cpu"))
    state, _ = step(init_state(model, opt_cfg),
                    to_device(_batches(1)[0], "cpu"))
    g = next(g for g in tapir.cached_graphs().values()
             if getattr(g, "grad_meta", None))
    nodes = list(g.nodes.values())
    grouped = [n for n in nodes if n.op == "matmul"
               and len(g.nodes[n.inputs[1]].ttype.shape) == 3]
    n_moe = model.cfg.n_layers - model.cfg.first_dense_layers
    assert len(grouped) == 3 * n_moe
    assert {n.schedule.impl for n in grouped} == {"fused_kernel"}
    assert sum(n.op == "scatter" and bool(n.attrs.get("zero_init"))
               for n in nodes) >= n_moe
    assert sum(n.op == "gather" for n in nodes) >= n_moe
    assert sum(n.op == "pyfunc" and n.attrs.get("fn") is moe._route_topk
               for n in nodes) == 4 * n_moe
    assert g.grad_meta["n_bwd"] > 0


# ---------------------------------------------------------------------------
# The launcher and checkpoints
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("extra", [[], ["--capture-step"]],
                         ids=["per_op", "captured"])
def test_launcher_trains_granite_as_the_reference_launcher(extra, capsys,
                                                           monkeypatch):
    """``launch/train.py --arch granite_moe_1b_a400m --smoke --device
    cpu``, per op and ``--capture-step``, on the reference's initial
    weights: its losses are the reference launcher's ``raw_step``'s
    within the step tolerances (loss rtol 1e-5), and fall."""
    arch = "granite_moe_1b_a400m"
    jm, tree = _reference(arch)
    built = []

    def get_model(cfg, device, generator=None):
        built.append(cfg.name)
        return params_from_numpy(
            tree, dataclasses.replace(cfg, compute_dtype="float32"),
            device=device)
    monkeypatch.setattr(launch_train, "get_model", get_model)
    steps = STEPS
    launch_train.main(["--arch", arch, "--smoke", "--device", "cpu",
                       "--steps", str(steps), "--batch", str(B),
                       "--seq", str(S), "--lr", "1e-3", "--remat", "none"]
                      + extra)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert built and line["steps"] == steps
    assert line["last_loss"] < line["first_loss"]
    if extra:
        assert line["grad_meta"]["n_bwd"] > 0
    # the reference's step at the launcher's schedule
    tap = JTapirConfig(mode="tapir", remat="none", cost_model=J_CPU)
    cfg = jopt.AdamWConfig(lr=1e-3, total_steps=steps, warmup_steps=1)

    @jax.jit
    def step(state, batch):
        def loss_fn(p):
            with j_use(tap):
                return jm.loss(p, batch)
        loss, grads = jax.value_and_grad(loss_fn)(state["params"])
        p2, o2, _ = jopt.adamw_update(state["params"], grads, state["opt"],
                                      cfg)
        return {"params": p2, "opt": o2}, loss
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    state = {"params": params, "opt": jopt.adamw_init(params, cfg)}
    pipe = JTokenPipeline(JDataConfig(seq_len=S, global_batch=B, vocab=512))
    for s in range(steps):
        state, loss = step(state, {k: jnp.asarray(v) for k, v in
                                   pipe.batch_at(s).items()})
        np.testing.assert_allclose(line["losses"][s], float(loss),
                                   rtol=1e-5)
