"""RWKV6 training in the port (``train/step.py::make_train_step`` on
``models/rwkv.py``) against the JAX package's per-op step, and the port's
own guarantees, at the SMOKE shapes of rwkv6-7b on the CPU in fp32
compute.

The weights are the reference's ``init_params(PRNGKey(0))`` carried across
as numpy; the batches are ``TokenPipeline``'s (the same bytes in both
packages).  The reference step is its launcher's ``raw_step`` (no mesh:
``jax.value_and_grad`` of ``model.loss``, whose scans XLA differentiates
through the chunked composite, then ``adamw_update``).  The port's step
runs at the H100 cost model, so every scan node binds ``kernel`` and
goes through ``LinearScanFn`` (on CPU tensors its forward and backward
are the plain versions), and every GEMM through ``FusedMatmulFn``.
Tolerances, those of the qwen step's test (``tests/test_torch_train.py``;
XLA and torch sum in other orders):

* loss rtol 1e-5 and lr rtol 1e-6 every step; the grad norm rtol 1e-4
  at the first step and 1e-3 after it;
* each leaf's first-step gradient: max |diff| <= 2e-4 x max |grad|;
* inside the port (remat full = none): bitwise;
* ``mode="opaque"`` against tapir: rtol 1e-5 on the loss, 1e-4 relative
  on the gradients.
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
from repro_torch.kernels.fused_matmul import ops as fm_ops
from repro_torch.kernels.linear_scan import ops as ls_ops
from repro_torch.launch import train as launch_train
from repro_torch.models.convert import params_from_numpy
from repro_torch.train import TrainConfig, init_state, make_train_step

B, S, STEPS = 2, 24, 3
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=STEPS)
GPU = TrainConfig(target="gpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def reference():
    """(reference model, its params as numpy) at fp32 compute."""
    cfg = dataclasses.replace(RC.get_smoke("rwkv6_7b"),
                              compute_dtype="float32")
    jm = j_get_model(cfg)
    jp = jm.init_params(jax.random.PRNGKey(0))
    return jm, jax.tree_util.tree_map(np.asarray, jp)


def _port(tree):
    cfg = dataclasses.replace(get_smoke("rwkv6_7b"), compute_dtype="float32")
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
            for path, g, want in zip(paths, grads,
                                     jax.tree_util.tree_leaves(jgrads)):
                want = np.asarray(want)
                err = np.abs(g.numpy() - want).max()
                assert err <= 2e-4 * np.abs(want).max(), path
    assert int(state["opt"]["step"]) == STEPS


def test_every_scan_and_gemm_of_a_step_goes_through_its_function(
        reference, monkeypatch):
    """At the H100 profile every scan node binds ``kernel``: under remat
    full each layer's scan runs its forward twice (the forward and the
    recompute) and its backward once, all through ``LinearScanFn``, on
    CPU tensors the plain versions (no launch); each layer's ten GEMMs and
    the head go through ``FusedMatmulFn`` the same way, and five of a
    layer's epilogue chains need their product again in the backward (wA
    tanh, wg silu * gate, wck relu, wcr sigmoid, wcv * rgate + residual):
    the recompute launches ``chip_smoke.py``'s ``rwkv_train_launches``
    counts on the card, beside one dX and one dW product a GEMM."""
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
    fm_ops.reset_counts()
    ls_ops.reset_counts()
    tapir.clear_cache()
    step(state, to_device(_batches(1)[0], "cpu"))
    n_l = tm.cfg.n_layers
    assert ls_ops.function_calls == collections.Counter(
        forward=2 * n_l, backward=n_l)
    assert ls_ops.launches == 0 and ls_ops.bwd_launches == 0
    assert fm_ops.function_calls == collections.Counter(
        forward=20 * n_l + 1, backward=10 * n_l + 1)
    assert sum(chains.values()) == 10 * n_l + 1
    assert routes == {"matmul_dx": 10 * n_l + 1, "matmul_dw": 10 * n_l + 1}
    assert sum(c for ch, c in chains.items()
               if any(fn != "add" for fn in ch)) == 5 * n_l
    scans = [n for g in tapir.cached_graphs().values()
             for n in g.nodes.values() if n.op == "linear_scan"]
    assert scans and {n.schedule.impl for n in scans} == {"kernel"}


def test_remat_full_equals_none_bitwise(reference):
    """Remat is a schedule decision, never a numerics one: the recomputed
    layers (their scans included) give the same loss and gradients, bit
    for bit."""
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
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())


def test_the_step_updates_every_leaf_in_place(reference):
    """Every RWKV6 leaf (the decay's w0 / wA / wB and the bonus u through
    the scan's backward among them) gets a finite, non-zero gradient and
    is updated in its own storage."""
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


def test_launcher_trains_rwkv6_on_the_cpu(capsys):
    launch_train.main(["--arch", "rwkv6_7b", "--device", "cpu", "--smoke",
                       "--steps", "4", "--batch", "2", "--seq", "32",
                       "--lr", "1e-2"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["steps"] == 4 and line["tok_per_s"] > 0
    assert np.isfinite(line["losses"]).all()
    assert line["last_loss"] < line["first_loss"]
