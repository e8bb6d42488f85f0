"""Zamba2 training in the port (``train/step.py::make_train_step`` and the
captured ``train/region_step.py::make_region_train_step`` on
``models/mamba.py``) against the JAX package's per-op step, and the
port's own guarantees, at the SMOKE shapes of zamba2-7b on the CPU (7
Mamba2 layers, the shared block after layers 3 and 6, one plain tail
layer) in fp32 compute.

The weights are the reference's ``init_params(PRNGKey(0))`` carried across
as numpy; the batches are ``TokenPipeline``'s (the same bytes in both
packages).  The reference step is its launcher's ``raw_step`` (no mesh:
``jax.value_and_grad`` of ``model.loss``, then ``adamw_update``) with
``--mode opaque``, its scans the sequential recurrence.  The first
gradient is ill-conditioned in fp32: evaluated with every fp32 step
promoted to fp64, the two packages agree within 1e-6 of each leaf's
largest, and each fp32 evaluation, the port's and the reference's in
either mode, lies some 1e-4 of the largest from that, each in its own
direction.  Against the launcher's default (tapir) mode the port's first
grad norm misses rtol 1e-4 for that reason, so the test holds the port to
the opaque step and, leaf by leaf, to the fp64 evaluation
(``test_first_gradients_against_an_fp64_evaluation``).  The port's step
runs at the H100 cost model, so every scan node binds ``kernel`` and goes
through ``LinearScanFn`` in its GLA form (on CPU tensors its forward and
backward are the plain versions), every GEMM through ``FusedMatmulFn``
and every attention through ``FlashAttentionFn``.  Tolerances, those of
the RWKV6 and qwen steps' tests (XLA and torch sum in other orders):

* loss rtol 1e-5 and lr rtol 1e-6 every step; the grad norm rtol 1e-4
  at the first step and 1e-3 after it;
* each leaf's first-step gradient: max |diff| <= 2e-4 x max |grad| (the
  shared block's leaves sum two applications, ``embed`` the lookup's and
  the tied head's), against the reference and against the fp64
  evaluation, except ``blocks.dt_bias`` at 1e-3: the fp32 roundoff of
  the scan's factored forward (about 1e-6 of a call's largest output,
  as in the JAX package's chunked form) moves it by more than 2e-4 of
  its largest; with that forward alone in fp64 it is within 2e-4 of the
  fp64 evaluation;
* inside the port (remat full = none): bitwise;
* ``mode="opaque"`` against tapir: rtol 1e-5 on the loss and on each
  gradient relative to its largest entry.
"""
import collections
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as RC
from repro import optim as jopt
from repro.core.schedule import CPU_COST_MODEL as J_CPU
from repro.core.tapir import TapirConfig as JTapirConfig
from repro.core.tapir import use as j_use
from repro.data import DataConfig as JDataConfig
from repro.data import TokenPipeline as JTokenPipeline
from repro.models.base import get_model as j_get_model
from repro_torch import optim
from repro_torch.configs import get_smoke
from repro_torch.core import tapir
from repro_torch.data import DataConfig, TokenPipeline, to_device
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.fused_matmul import ops as fm_ops
from repro_torch.kernels.linear_scan import ops as ls_ops
from repro_torch.kernels.linear_scan import ref as ls_ref
from repro_torch.launch import train as launch_train
from repro_torch.models import layers as L
from repro_torch.models.convert import params_from_numpy
from repro_torch.train import TrainConfig, init_state, make_train_step

ARCH = "zamba2_7b"
B, S, STEPS = 2, 24, 3
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=STEPS)
GPU = TrainConfig(target="gpu")
MODE = "opaque"           # the reference launcher's --mode


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def reference():
    """(reference model, its params as numpy) at fp32 compute."""
    cfg = dataclasses.replace(RC.get_smoke(ARCH), compute_dtype="float32")
    jm = j_get_model(cfg)
    jp = jm.init_params(jax.random.PRNGKey(0))
    return jm, jax.tree_util.tree_map(np.asarray, jp)


def _port(tree):
    cfg = dataclasses.replace(get_smoke(ARCH), compute_dtype="float32")
    return params_from_numpy(tree, cfg, device="cpu")


def _batches(n=STEPS):
    pipe = TokenPipeline(DataConfig(seq_len=S, global_batch=B, vocab=512))
    want = JTokenPipeline(JDataConfig(seq_len=S, global_batch=B, vocab=512))
    out = [pipe.batch_at(s) for s in range(n)]
    for s, b in enumerate(out):
        np.testing.assert_array_equal(b["tokens"], want.batch_at(s)["tokens"])
    return out


def _raw_step(jm):
    """The reference launcher's per-op step (``launch/train.py``, no
    mesh), also returning the gradients."""
    tap = JTapirConfig(mode=MODE, remat="none", cost_model=J_CPU)
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


def _grads(model, batch, tcfg=GPU):
    with tapir.use(tcfg.tapir_config()), model.trainable():
        loss = model.loss(to_device(batch, "cpu"))
        return loss.detach(), torch.autograd.grad(
            loss, optim.tree_leaves(model.param_tree()))


def test_three_steps_match_the_reference_raw_step(reference):
    jm, tree = reference
    tm = _port(tree)
    jstep = _raw_step(jm)
    jstate = {"params": jax.tree_util.tree_map(jnp.asarray, tree)}
    jstate["opt"] = jopt.adamw_init(jstate["params"], jopt.AdamWConfig(**OPT))
    step = make_train_step(tm, optim.AdamWConfig(**OPT), GPU)
    state = init_state(tm, optim.AdamWConfig(**OPT))
    for s, batch in enumerate(_batches()):
        if s == 0:
            _, grads = _grads(tm, batch)
        jstate, jm_, jgrads = jstep(jstate, {k: jnp.asarray(v)
                                             for k, v in batch.items()})
        state, m = step(state, to_device(batch, "cpu"))
        np.testing.assert_allclose(float(m["loss"]), float(jm_["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(m["lr"]), float(jm_["lr"]),
                                   rtol=1e-6)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm_["grad_norm"]),
                                   rtol=1e-4 if s == 0 else 1e-3)
        if s == 0:
            paths = [jax.tree_util.keystr(k) for k, _ in
                     jax.tree_util.tree_leaves_with_path(jgrads)]
            assert "['embed']" in paths and "['shared']['wq']" in paths
            for path, g, want in zip(paths, grads,
                                     jax.tree_util.tree_leaves(jgrads)):
                want = np.asarray(want)
                assert g.shape == want.shape, path
                err = np.abs(g.numpy() - want).max()
                tol = 1e-3 if path == "['blocks']['dt_bias']" else 2e-4
                assert err <= tol * np.abs(want).max(), path
    assert int(state["opt"]["step"]) == STEPS


def test_the_reference_modes_disagree_on_dt_bias(reference):
    """The spread of fp32 evaluations of ``blocks.dt_bias``'s first
    gradient: the JAX package's own tapir and opaque modes differ there by
    more than 2e-4 of the largest entry (the bound the port meets against
    the fp64 evaluation only with its scan forward in fp64)."""
    jm, tree = reference
    batch = {k: jnp.asarray(v) for k, v in _batches(1)[0].items()}

    def grads(mode):
        tap = JTapirConfig(mode=mode, remat="none", cost_model=J_CPU)

        def loss_fn(p):
            with j_use(tap):
                return jm.loss(p, batch)
        g = jax.jit(jax.grad(loss_fn))(
            jax.tree_util.tree_map(jnp.asarray, tree))
        return np.asarray(g["blocks"]["dt_bias"])
    t, o = grads("tapir"), grads("opaque")
    assert np.abs(t - o).max() > 2e-4 * np.abs(o).max()


def _fp64_first_grads(tree, monkeypatch, package: str):
    """The first batch's loss and gradients (``optim.tree_leaves`` order,
    as numpy) with every fp32 evaluation promoted to fp64: in the port,
    ``torch.float32`` reads as ``torch.float64`` while it runs, at fp64
    compute and fp64 params; in the JAX package, under ``enable_x64``
    with ``jnp.float32`` read as ``jnp.float64``.  Both per op."""
    batch = _batches(1)[0]
    if package == "port":
        with monkeypatch.context() as mp:
            mp.setattr(torch, "float32", torch.float64)
            cfg = dataclasses.replace(get_smoke(ARCH),
                                      compute_dtype="float64")
            tm = params_from_numpy(tree, cfg, device="cpu")
            for p in optim.tree_leaves(tm.param_tree()):
                p.data = p.data.double()
            loss, grads = _grads(tm, batch,
                                 TrainConfig(target="gpu", mode="opaque"))
        assert all(g.dtype == torch.float64 for g in grads)
        return float(loss), [g.numpy() for g in grads]
    with jax.enable_x64(True), monkeypatch.context() as mp:
        mp.setattr(jnp, "float32", jnp.float64)
        cfg = dataclasses.replace(RC.get_smoke(ARCH), compute_dtype="float64")
        jm = j_get_model(cfg)
        tap = JTapirConfig(mode="opaque", remat="none", cost_model=J_CPU)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}

        def loss_fn(p):
            with j_use(tap):
                return jm.loss(p, jb)
        loss, grads = jax.value_and_grad(loss_fn)(jax.tree_util.tree_map(
            lambda a: jnp.asarray(a, jnp.float64), tree))
        grads = [np.asarray(g) for g in jax.tree_util.tree_leaves(grads)]
    assert all(g.dtype == np.float64 for g in grads)
    return float(loss), grads


def _fp64_scan_forward(monkeypatch):
    """Run the port's plain scan forward (``linear_scan_chunked``, what
    ``LinearScanFn`` calls on a CPU tensor) in fp64, its result cast back
    to its operands' dtype."""
    real = ls_ref.linear_scan_chunked

    def fp64(q, k, v, w, **kw):
        kw = {n: t.double() if torch.is_tensor(t) else t
              for n, t in kw.items()}
        with monkeypatch.context() as mp:
            mp.setattr(torch, "float32", torch.float64)
            out = real(*(t.double() for t in (q, k, v, w)), **kw)
        if isinstance(out, tuple):
            return out[0].to(v.dtype), out[1].float()
        return out.to(v.dtype)
    monkeypatch.setattr(ls_ref, "linear_scan_chunked", fp64)


def test_first_gradients_against_an_fp64_evaluation(reference, monkeypatch):
    """The witness for the first-step bounds: the port's step and the JAX
    package's, each with every fp32 evaluation promoted to fp64, agree
    within 1e-6 of each leaf's largest.  Against that evaluation the
    port's fp32 gradient is within 2e-4 of each leaf's largest, except
    ``blocks.dt_bias``, within 1e-3.  With the port's scan forward alone
    in fp64, ``dt_bias`` too is within 2e-4: its error is the fp32
    roundoff of the factored chunk form's forward (about 1e-6 of a call's
    largest output, as in the JAX package's chunked form), amplified in
    the backward; the scan's backward adds nothing measurable
    (``test_gla_scan_dw_against_an_fp64_recurrence``)."""
    _, tree = reference
    loss64, exact = _fp64_first_grads(tree, monkeypatch, "port")
    jloss64, jexact = _fp64_first_grads(tree, monkeypatch, "reference")
    np.testing.assert_allclose(loss64, jloss64, rtol=1e-9)
    for g, want in zip(exact, jexact):
        assert np.abs(g - want).max() <= 1e-6 * np.abs(want).max()
    paths = [".".join(k.key for k in path) for path, _ in
             jax.tree_util.tree_leaves_with_path(tree)]

    def rel(grads):
        return {p: float(np.abs(g.numpy() - want).max()
                         / np.abs(want).max())
                for p, g, want in zip(paths, grads, exact)}
    port = rel(_grads(_port(tree), _batches(1)[0])[1])
    for p, e in port.items():
        assert e <= (1e-3 if p == "blocks.dt_bias" else 2e-4), (p, e)
    _fp64_scan_forward(monkeypatch)
    fwd64 = rel(_grads(_port(tree), _batches(1)[0])[1])
    assert fwd64["blocks.dt_bias"] <= 2e-4, fwd64
    assert fwd64["blocks.dt_bias"] < port["blocks.dt_bias"]


def test_gla_scan_dw_against_an_fp64_recurrence(reference, monkeypatch):
    """The backward of the step's GLA scans (Mamba2's operands: q a
    stride-0 view over the heads, one decay a head broadcast over the
    state) against autograd of the sequential recurrence in fp64: every
    gradient within 2e-6 of its largest.  Autograd of the fp32 chunk form
    (what XLA differentiates in the reference's tapir mode) is 10x
    farther off in dw, the difference-form cancellation the hand-written
    backward avoids; dq, dk and dv it matches.

    The RoPE tables are made here, in fp32: the memo may hold tables an
    earlier test of the file made with ``torch.float32`` read as fp64
    (``test_first_gradients_against_an_fp64_evaluation``), which would
    move this forward's scan operands."""
    _, tree = reference
    monkeypatch.setattr(L, "_ARANGE_ROPE", {})
    monkeypatch.setattr(L, "_FULL_ROPE", {})
    tm = _port(tree)
    calls = []
    real = ls_ref.linear_scan_bwd_ref

    def spy(q, k, v, w, u, do, **kw):
        calls.append(tuple(t.detach() for t in (q, k, v, w, do)))
        return real(q, k, v, w, u, do, **kw)
    monkeypatch.setattr(ls_ref, "linear_scan_bwd_ref", spy)
    _grads(tm, _batches(1)[0])
    assert len(calls) == tm.cfg.n_layers
    for q, k, v, w, do in calls[:2]:
        assert q.stride(2) == 0 and w.stride(3) == 0
        port = real(q, k, v, w, None, do)

        def vjp(fn, dt):
            ts = [t.to(dt).detach().requires_grad_() for t in (q, k, v, w)]
            return torch.autograd.grad(fn(*ts), ts, do.to(dt))
        exact = vjp(ls_ref.linear_scan_ref, torch.float64)
        chunked = vjp(ls_ref.linear_scan_chunked, torch.float32)
        for i in range(4):
            scale = float(exact[i].abs().max())
            err = float((port[i].double() - exact[i]).abs().max())
            assert err <= 2e-6 * scale, ("dq", "dk", "dv", "dw")[i]
        err_dw = float((port[3].double() - exact[3]).abs().max())
        assert float((chunked[3].double() - exact[3]).abs().max()) \
            >= 10 * err_dw


def test_every_scan_gemm_and_flash_call_goes_through_its_function(
        reference, monkeypatch):
    """At the H100 profile every scan node binds ``kernel``.  Under remat
    full each Mamba2 layer runs its scan and its two GEMMs (w_in, w_out +
    residual) twice (the forward and the recompute) and their backward
    once; the shared block is applied outside the layer stack, so each of
    its two applications runs its four GEMMs (fused QKV, wo + residual,
    fused gate|up with silu * gate, wd + residual) and its attention once,
    forward and backward; the tied head one GEMM.  All go through their
    autograd ``Function``s, on CPU tensors the plain versions (no
    launch): the counts ``chip_smoke.py``'s Zamba2 train phase holds the
    card's launches to, with one dX and one dW product a GEMM."""
    _, tree = reference
    tm = _port(tree)
    chains = collections.Counter()
    real = fm_ops.epilogue_vjp

    def spy(x2, w, chain, *a):
        chains[tuple(fn for fn, _, _ in chain)] += 1
        return real(x2, w, chain, *a)
    monkeypatch.setattr(fm_ops, "epilogue_vjp", spy)
    routes = collections.Counter()
    for route in ("matmul_dx", "matmul_dw"):
        def counted(*a, _real=getattr(fm_ops, route), _route=route, **kw):
            routes[_route] += 1
            return _real(*a, **kw)
        monkeypatch.setattr(fm_ops, route, counted)
    step = make_train_step(tm, optim.AdamWConfig(**OPT), GPU)
    state = init_state(tm, optim.AdamWConfig(**OPT))
    for ops in (fm_ops, ls_ops, fa_ops):
        ops.reset_counts()
    tapir.clear_cache()
    step(state, to_device(_batches(1)[0], "cpu"))
    n_l, n_g = tm.cfg.n_layers, tm.n_groups
    assert n_g == 2
    assert ls_ops.function_calls == collections.Counter(
        forward=2 * n_l, backward=n_l)
    assert ls_ops.launches == 0 and ls_ops.bwd_launches == 0
    assert fm_ops.function_calls == collections.Counter(
        forward=4 * n_l + 4 * n_g + 1, backward=2 * n_l + 4 * n_g + 1)
    assert routes == {"matmul_dx": 2 * n_l + 4 * n_g + 1,
                      "matmul_dw": 2 * n_l + 4 * n_g + 1}
    # every chain is adds alone: no product is recomputed in the backward
    assert sum(chains.values()) == 2 * n_l + 4 * n_g + 1
    assert all(fn == "add" for ch in chains for fn in ch)
    assert fa_ops.function_calls == collections.Counter(
        forward=n_g, backward=n_g)
    assert fm_ops.launches == 0 and fa_ops.launches == 0
    nodes = [n for g in tapir.cached_graphs().values()
             for n in g.nodes.values()]
    scans = [n for n in nodes if n.op == "linear_scan"]
    assert scans and {n.schedule.impl for n in scans} == {"kernel"}
    assert {n.attrs["variant"] for n in scans} == {"gla"}


def test_remat_full_equals_none_bitwise(reference):
    """Remat is a schedule decision, never a numerics one: the recomputed
    layers (their casts, convs and scans included) give the same loss and
    gradients, bit for bit."""
    _, tree = reference
    tm = _port(tree)
    batch = _batches(1)[0]
    out = {}
    for remat in ("none", "full"):
        ls_ops.reset_counts()
        out[remat] = _grads(tm, batch, TrainConfig(target="gpu",
                                                   remat=remat))
        out[remat + "_fwd"] = ls_ops.function_calls["forward"]
    assert out["none_fwd"] == tm.cfg.n_layers
    assert out["full_fwd"] == 2 * tm.cfg.n_layers
    assert torch.equal(out["none"][0], out["full"][0])
    for a, b in zip(out["none"][1], out["full"][1]):
        assert torch.equal(a, b)


def test_opaque_mode_matches_tapir(reference):
    _, tree = reference
    tm = _port(tree)
    batch = _batches(1)[0]
    lt, gt = _grads(tm, batch)
    lo, go = _grads(tm, batch, TrainConfig(target="gpu", mode="opaque"))
    np.testing.assert_allclose(float(lo), float(lt), rtol=1e-5)
    for a, b in zip(go, gt):
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())


def test_the_step_updates_every_leaf_in_place(reference):
    """Every Zamba2 leaf (A_log and dt_bias through the GLA scan's
    backward, the conv, the shared block's nine, the tied embedding)
    gets a finite, non-zero gradient and is updated in its own
    storage."""
    _, tree = reference
    tm = _port(tree)
    leaves = optim.tree_leaves(tm.param_tree())
    before = [t.clone() for t in leaves]
    ptrs = [t.data_ptr() for t in leaves]
    _, grads = _grads(tm, _batches(1)[0])
    assert all(bool(torch.isfinite(g).all()) and bool(g.abs().max() > 0)
               for g in grads)
    step = make_train_step(tm, optim.AdamWConfig(**OPT), GPU)
    step(init_state(tm, optim.AdamWConfig(**OPT)),
         to_device(_batches(1)[0], "cpu"))
    assert [t.data_ptr() for t in leaves] == ptrs
    assert all(not torch.equal(a, b) for a, b in zip(before, leaves))


@pytest.mark.parametrize("extra", [[], ["--capture-step"]])
def test_launcher_trains_zamba2_on_the_cpu(extra, capsys):
    launch_train.main(["--arch", ARCH, "--device", "cpu", "--smoke",
                       "--steps", "4", "--batch", "2", "--seq", "32",
                       "--lr", "1e-2"] + extra)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["steps"] == 4 and line["tok_per_s"] > 0
    assert np.isfinite(line["losses"]).all()
    assert line["last_loss"] < line["first_loss"]
    if extra:
        assert line["grad_meta"]["n_bwd"] > 0
