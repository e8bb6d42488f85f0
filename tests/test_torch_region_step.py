"""The port's captured training step (``train/region_step.py``) against its
per-op step (``train/step.py``, remat ``full``) and against the JAX
package's captured step, at the SMOKE shapes of qwen2.5-3b, RWKV6-7B,
Zamba2-7B and the two MoE configs on the CPU.

The weights are the reference's ``init_params(PRNGKey(0))`` carried across
as numpy (``models/convert.py``); the batches are ``TokenPipeline``'s.
qwen's steps run at the CPU cost model, RWKV6's and Zamba2's at the H100
one (every scan through ``LinearScanFn``), as their per-op tests do.
Zamba2's SSD gates are one tuple-returning composite (q, k, w) whose
outputs share ``dtv``: the captured step must differentiate it as one
call, as autograd does, to give the per-op step's bits; so is the MoE
router (gates, ids, positions, keep), whose dispatch is a ``zero_init``
scatter and whose combine a gather, around 3-D expert GEMMs.  Tolerances:

* captured against per-op in fp32 compute: bitwise (``torch.equal``) in
  the loss at every step and in the params and the AdamW state after 3
  steps — plain, with 2 microbatches, and with int8 + error feedback
  (against the per-op step plus ``_ef_quantize`` leaf by leaf: the JAX
  package's own test of that path fails on this image, so the port is
  held to itself);
* remat policy ``none`` against ``full``: bitwise;
* in bf16 compute: the loss bitwise, the params within atol 2e-3 after a
  step (the reference's bound: an AdamW step moves a weight by about lr);
* against the JAX package's ``make_region_train_step`` over 2 steps: the
  tolerances ``tests/test_torch_train.py`` holds the per-op step to
  (loss rtol 1e-5, lr rtol 1e-6, grad norm rtol 1e-4 then 1e-3).
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as RC
from repro import optim as jopt
from repro import train as jtrain
from repro.models.base import get_model as j_get_model
from repro_torch import optim
from repro_torch.configs import get_smoke
from repro_torch.core import tapir
from repro_torch.data import DataConfig, TokenPipeline, to_device
from repro_torch.launch import train as launch_train
from repro_torch.models.convert import params_from_numpy
from repro_torch.train import (TrainConfig, init_ef_state, init_state,
                               make_region_train_step, make_train_step)
from repro_torch.train.region_step import _ef_quantize

B, S, STEPS = 2, 16, 3
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=STEPS)
TARGET = {"qwen2_5_3b": "cpu", "rwkv6_7b": "gpu", "zamba2_7b": "gpu",
          "granite_moe_1b_a400m": "cpu", "moonshot_v1_16b_a3b": "cpu"}


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


_TREES: dict = {}


def _tree(arch):
    """The reference's initial params as numpy (made once a process)."""
    if arch not in _TREES:
        jm = j_get_model(dataclasses.replace(RC.get_smoke(arch),
                                             compute_dtype="float32"))
        _TREES[arch] = jax.tree_util.tree_map(
            np.asarray, jm.init_params(jax.random.PRNGKey(0)))
    return _TREES[arch]


def _model(arch, dtype="float32"):
    cfg = dataclasses.replace(get_smoke(arch), compute_dtype=dtype)
    return params_from_numpy(_tree(arch), cfg, device="cpu")


def _batches(n=STEPS, batch=B, vocab=512):
    pipe = TokenPipeline(DataConfig(seq_len=S, global_batch=batch,
                                    vocab=vocab))
    return [to_device(pipe.batch_at(s), "cpu") for s in range(n)]


def _leaves(state, *keys):
    out = []
    for k in keys:
        node = state
        for part in k.split("."):
            node = node[part]
        out += optim.tree_leaves(node)
    return out


def _bitwise(a, b) -> bool:
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def _per_op_ef_step(model, opt_cfg, tcfg):
    """The per-op step (remat full) with ``_ef_quantize`` leaf by leaf
    between the gradients and AdamW."""
    tap = tcfg.tapir_config()

    def step(state, batch):
        leaves = optim.tree_leaves(state["params"])
        with tapir.use(tap), model.trainable():
            loss = model.loss(batch)
            grads = torch.autograd.grad(loss, leaves)
        deq = []
        for g, r in zip(grads, optim.tree_leaves(state["ef"])):
            d, r2 = _ef_quantize(g, r)
            r.copy_(r2)
            deq.append(d)
        om = optim.adamw_update(state["params"], deq, state["opt"], opt_cfg)
        return state, {"loss": loss.detach(), **om}
    return step


@pytest.mark.parametrize("variant", ["plain", "microbatches", "int8_ef"])
@pytest.mark.parametrize("arch", list(TARGET))
def test_captured_step_equals_per_op_bitwise(arch, variant):
    opt_cfg = optim.AdamWConfig(**OPT)
    kw = {"target": TARGET[arch]}
    batch = B
    if variant == "microbatches":
        kw["microbatches"] = 2
        batch = 2 * B
    ref_m, cap_m = _model(arch), _model(arch)
    if variant == "int8_ef":
        ref_step = _per_op_ef_step(ref_m, opt_cfg, TrainConfig(**kw))
        kw["compress_pod_grads"] = True
    else:
        ref_step = make_train_step(ref_m, opt_cfg, TrainConfig(**kw))
    cap_step = make_region_train_step(cap_m, opt_cfg,
                                      TrainConfig(remat="auto", **kw))
    ref, cap = init_state(ref_m, opt_cfg), init_state(cap_m, opt_cfg)
    if variant == "int8_ef":
        ref["ef"] = init_ef_state(ref["params"])
        cap["ef"] = init_ef_state(cap["params"])
    ef_ptr = None
    for s, b in enumerate(_batches(batch=batch,
                                   vocab=ref_m.cfg.vocab)):
        ref, mr = ref_step(ref, b)
        if variant == "int8_ef" and s == 1:
            ef_ptr = [t.data_ptr() for t in _leaves(cap, "ef")]
        cap, mc = cap_step(cap, b)
        assert torch.equal(mr["loss"], mc["loss"]), f"loss at step {s}"
    keys = ("params", "opt.mu", "opt.nu", "opt.step")
    assert _bitwise(_leaves(ref, *keys), _leaves(cap, *keys))
    if variant == "int8_ef":
        assert _bitwise(_leaves(ref, "ef"), _leaves(cap, "ef"))
        assert any(t.abs().max() > 0 for t in _leaves(cap, "ef"))
        assert ef_ptr == [t.data_ptr() for t in _leaves(cap, "ef")]


def test_policy_none_equals_full_bitwise():
    """Remat is a schedule decision: every node stored or every node
    recomputed gives the same loss and params, bit for bit."""
    out = {}
    for policy in ("none", "full"):
        tapir.clear_cache()
        m = _model("qwen2_5_3b")
        opt_cfg = optim.AdamWConfig(**OPT)
        step = make_region_train_step(m, opt_cfg, TrainConfig(
            target="cpu", remat=policy))
        state = init_state(m, opt_cfg)
        losses = [step(state, b)[1]["loss"] for b in _batches(2)]
        meta = next(g.grad_meta for g in tapir.cached_graphs().values()
                    if getattr(g, "grad_meta", None))
        out[policy] = losses, _leaves(state, "params"), meta["remat"]
    assert _bitwise(out["none"][0], out["full"][0])
    assert _bitwise(out["none"][1], out["full"][1])
    assert out["none"][2]["recompute"] == 0 < out["none"][2]["store"]
    assert out["full"][2]["store"] == 0 < out["full"][2]["recompute"]


def test_state_is_donated_and_the_program_replays():
    """From the first step on the params, moments and step counter keep
    their buffers; later steps replay the compiled program; ``explain()``
    reports the gradient program and ``grad_meta`` its counts."""
    m = _model("qwen2_5_3b")
    opt_cfg = optim.AdamWConfig(**OPT)
    step = make_region_train_step(m, opt_cfg, TrainConfig(target="cpu",
                                                          remat="auto"))
    state = init_state(m, opt_cfg)
    keys = ("params", "opt.mu", "opt.nu", "opt.step")
    ptrs = [t.data_ptr() for t in _leaves(state, *keys)]
    batches = _batches()
    state, _ = step(state, batches[0])
    compiled = tapir.cache_stats()["compiled_programs"]
    assert compiled == 1
    for b in batches[1:]:
        state, _ = step(state, b)
    assert tapir.cache_stats()["compiled_programs"] == compiled
    assert [t.data_ptr() for t in _leaves(state, *keys)] == ptrs
    assert state["params"]["embed"] is m.embed
    assert int(state["opt"]["step"]) == STEPS
    assert not any(t.requires_grad for t in _leaves(state, *keys))
    report = tapir.explain()
    assert "== gradient programs ==" in report
    assert "fwd nodes" in report and "bwd nodes" in report
    assert "note: remat: store" in report
    assert ": recompute" in report.split("== gradient programs ==")[1]
    meta = next(g.grad_meta for g in tapir.cached_graphs().values()
                if getattr(g, "grad_meta", None))
    assert meta["n_fwd"] > 0 and meta["n_bwd"] > 0
    assert meta["remat"]["store"] > 0 and meta["remat"]["recompute"] > 0
    assert meta["bytes_stored"] > 0 and meta["bytes_recomputed"] > 0


def test_matches_the_reference_captured_step():
    arch = "qwen2_5_3b"
    tree = _tree(arch)
    jm = j_get_model(dataclasses.replace(RC.get_smoke(arch),
                                         compute_dtype="float32"))
    jcfg = jopt.AdamWConfig(**OPT)
    jstep, _ = jtrain.make_region_train_step(
        jm, jcfg, mesh=None, cfg=jtrain.TrainConfig(remat="auto",
                                                    target="cpu"))
    jstate = {"params": jax.tree_util.tree_map(jnp.asarray, tree)}
    jstate["opt"] = jopt.adamw_init(jstate["params"], jcfg)
    m = _model(arch)
    opt_cfg = optim.AdamWConfig(**OPT)
    step = make_region_train_step(m, opt_cfg, TrainConfig(target="cpu",
                                                          remat="auto"))
    state = init_state(m, opt_cfg)
    for s, b in enumerate(_batches(2)):
        jstate, jm_ = jstep(jstate, {k: jnp.asarray(v.numpy())
                                     for k, v in b.items()})
        state, mc = step(state, b)
        np.testing.assert_allclose(float(mc["loss"]), float(jm_["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(mc["lr"]), float(jm_["lr"]),
                                   rtol=1e-6)
        np.testing.assert_allclose(float(mc["grad_norm"]),
                                   float(jm_["grad_norm"]),
                                   rtol=1e-4 if s == 0 else 1e-3)


def test_bf16_loss_bitwise_params_close():
    arch = "qwen2_5_3b"
    opt_cfg = optim.AdamWConfig(**dict(OPT, total_steps=1))
    ref_m, cap_m = _model(arch, "bfloat16"), _model(arch, "bfloat16")
    ref_step = make_train_step(ref_m, opt_cfg, TrainConfig(target="cpu"))
    cap_step = make_region_train_step(cap_m, opt_cfg,
                                      TrainConfig(target="cpu", remat="auto"))
    ref, cap = init_state(ref_m, opt_cfg), init_state(cap_m, opt_cfg)
    b = _batches(1)[0]
    ref, mr = ref_step(ref, b)
    cap, mc = cap_step(cap, b)
    assert torch.equal(mr["loss"], mc["loss"])
    for a, c in zip(_leaves(ref, "params"), _leaves(cap, "params")):
        assert float((a.double() - c.double()).abs().max()) <= 2e-3


@pytest.mark.parametrize("extra", [[], ["--microbatches", "2"]])
def test_launcher_capture_step_trains_on_the_cpu(extra, capsys):
    launch_train.main(["--device", "cpu", "--smoke", "--steps", "6",
                       "--batch", "4", "--seq", "32", "--lr", "1e-2",
                       "--capture-step"] + extra)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["steps"] == 6 and line["tok_per_s"] > 0
    assert np.isfinite(line["losses"]).all()
    assert line["last_loss"] < line["first_loss"]
    assert line["grad_meta"]["n_bwd"] > 0
    assert sum(line["grad_meta"]["remat"].values()) > 0
