"""The port's per-op training step (``repro_torch.train``) against the JAX
package's, and the port's own guarantees, at the SMOKE shapes of
qwen2.5-3b on the CPU in fp32 compute.

The weights are the reference's ``init_params(PRNGKey(0))`` carried across
as numpy; the batches are ``TokenPipeline``'s (the same bytes in both
packages).  The reference step is its launcher's ``raw_step`` (no mesh:
``jax.value_and_grad`` of ``model.loss`` under the config, then
``adamw_update``), and for microbatches its ``make_train_step`` on a
one-device mesh.  Tolerances (XLA and torch sum in other orders; the
attention's softmax derivative and the embedding's scatter-add differ in
the last places):

* loss rtol 1e-5 and lr rtol 1e-6 every step; the grad norm rtol 1e-4
  at the first step and 1e-3 after it: Adam's first update moves every
  weight by about +-lr whatever its gradient's size, so an entry whose
  gradient is near zero and differs in its last places between the
  packages can move the other way, and the next gradients differ by more
  (the reference's microbatched and plain steps differ by 1.5e-4 there);
* each leaf's first-step gradient: max |diff| <= 2e-4 x max |grad|;
* inside the port (remat full = none): bitwise;
* ``mode="opaque"`` against tapir: rtol 1e-5 on the loss, 1e-4 relative
  on the gradients (the per-op control does not fuse: other GEMM shapes).
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
from repro import train as jtrain
from repro.core.schedule import CPU_COST_MODEL as J_CPU
from repro.core.tapir import TapirConfig as JTapirConfig
from repro.core.tapir import use as j_use
from repro.data import DataConfig as JDataConfig
from repro.data import TokenPipeline as JTokenPipeline
from repro.models.base import get_model as j_get_model
from repro_torch import optim
from repro_torch.configs import get_smoke
from repro_torch.core import graphs, tapir
from repro_torch.data import DataConfig, TokenPipeline, to_device
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.fused_matmul import ops as fm_ops
from repro_torch.launch import train as launch_train
from repro_torch.models.convert import params_from_numpy
from repro_torch.train import TrainConfig, init_state, make_train_step

B, S, STEPS = 2, 16, 3
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=STEPS)
CPU = TrainConfig(target="cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def reference():
    """(reference model, its params as numpy) at fp32 compute."""
    cfg = dataclasses.replace(RC.get_smoke("qwen2_5_3b"),
                              compute_dtype="float32")
    jm = j_get_model(cfg)
    jp = jm.init_params(jax.random.PRNGKey(0))
    return jm, jax.tree_util.tree_map(np.asarray, jp)


def _port(tree, **cfg_kw):
    cfg = dataclasses.replace(get_smoke("qwen2_5_3b"),
                              compute_dtype="float32", **cfg_kw)
    return params_from_numpy(tree, cfg, device="cpu")


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


def _check_metrics(step: int, got: dict, want: dict) -> None:
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(got["lr"]), float(want["lr"]),
                               rtol=1e-6)
    np.testing.assert_allclose(float(got["grad_norm"]),
                               float(want["grad_norm"]),
                               rtol=1e-4 if step == 0 else 1e-3)


def _grads(model, batch, tcfg=CPU):
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
    step = make_train_step(tm, optim.AdamWConfig(**OPT), CPU)
    state = init_state(tm, optim.AdamWConfig(**OPT))
    for s, batch in enumerate(_batches()):
        if s == 0:   # every leaf's first-step gradient
            _, grads = _grads(tm, batch)
        jstate, jm_, jgrads = jstep(jstate, {k: jnp.asarray(v)
                                             for k, v in batch.items()})
        state, m = step(state, to_device(batch, "cpu"))
        _check_metrics(s, m, jm_)
        if s == 0:
            paths = [jax.tree_util.keystr(k) for k, _ in
                     jax.tree_util.tree_leaves_with_path(jgrads)]
            for path, g, want in zip(paths, grads,
                                     jax.tree_util.tree_leaves(jgrads)):
                want = np.asarray(want)
                err = np.abs(g.numpy() - want).max()
                assert err <= 2e-4 * np.abs(want).max(), path
    assert int(state["opt"]["step"]) == STEPS


def test_microbatches_match_the_reference(reference):
    """Two microbatches: fp32 gradient sums in microbatch order, loss and
    gradients divided by 2, against the reference's ``make_train_step``
    (its ``lax.scan`` accumulation) on a one-device mesh."""
    jm, tree = reference
    tm = _port(tree)
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    jcfg = jtrain.TrainConfig(strategy="tp", remat="none", microbatches=2,
                              target="cpu")
    jstep, _, _ = jtrain.make_train_step(jm, jopt.AdamWConfig(**OPT), mesh,
                                         jcfg)
    jstate = {"params": jax.tree_util.tree_map(jnp.asarray, tree)}
    jstate["opt"] = jopt.adamw_init(jstate["params"], jopt.AdamWConfig(**OPT))
    step = make_train_step(tm, optim.AdamWConfig(**OPT),
                           TrainConfig(target="cpu", microbatches=2))
    state = init_state(tm, optim.AdamWConfig(**OPT))
    for s, batch in enumerate(_batches(STEPS, batch=4)):
        jstate, jm_ = jstep(jstate, {k: jnp.asarray(v)
                                     for k, v in batch.items()})
        state, m = step(state, to_device(batch, "cpu"))
        _check_metrics(s, m, jm_)


def test_remat_full_equals_none_bitwise(reference):
    """Remat is a schedule decision, never a numerics one: the recomputed
    layers give the same loss and gradients, bit for bit."""
    _, tree = reference
    tm = _port(tree)
    batch = _batches(1)[0]
    out = {}
    for remat in ("none", "full"):
        fa_ops.reset_counts()
        out[remat] = _grads(tm, batch, TrainConfig(target="cpu",
                                                   remat=remat))
        out[remat + "_fwd"] = fa_ops.function_calls["forward"]
    assert out["none_fwd"] == tm.cfg.n_layers        # one forward a layer
    assert out["full_fwd"] == 2 * tm.cfg.n_layers    # and its recompute
    assert torch.equal(out["none"][0], out["full"][0])
    for a, b in zip(out["none"][1], out["full"][1]):
        assert torch.equal(a, b)


def test_opaque_mode_matches_tapir(reference):
    _, tree = reference
    tm = _port(tree)
    batch = _batches(1)[0]
    lt, gt = _grads(tm, batch)
    lo, go = _grads(tm, batch, TrainConfig(target="cpu", mode="opaque"))
    np.testing.assert_allclose(float(lo), float(lt), rtol=1e-5)
    for a, b in zip(go, gt):
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())


def test_the_step_goes_through_the_functions_and_updates_in_place(reference):
    """Every GEMM and attention of a step goes through its autograd
    Function (the CPU runs their backward too); the model's own tensors are
    updated, keep their storage, and are frozen again after the step."""
    _, tree = reference
    tm = _port(tree)
    leaves = optim.tree_leaves(tm.param_tree())
    before = [t.clone() for t in leaves]
    ptrs = [t.data_ptr() for t in leaves]
    step = make_train_step(tm, optim.AdamWConfig(**OPT), CPU)
    state = init_state(tm, optim.AdamWConfig(**OPT))
    fm_ops.reset_counts()
    fa_ops.reset_counts()
    step(state, to_device(_batches(1)[0], "cpu"))
    n_l = tm.cfg.n_layers
    # remat full: each layer's 4 GEMMs and its attention run twice
    assert fm_ops.function_calls == collections.Counter(
        forward=8 * n_l + 1, backward=4 * n_l + 1)
    assert fa_ops.function_calls == collections.Counter(
        forward=2 * n_l, backward=n_l)
    assert [t.data_ptr() for t in leaves] == ptrs
    assert all(not torch.equal(a, b) for a, b in zip(before, leaves))
    assert not any(t.requires_grad for t in leaves)
    assert tm._compute is None


def test_stacked_weights_are_unbound_once(reference):
    """``scan_layers`` takes the per-layer views with one ``unbind``: the
    same storage as ``a[i]``, and one ``UnbindBackward`` per stacked
    leaf, not a ``SelectBackward`` per layer."""
    _, tree = reference
    tm = _port(tree)
    seen = []

    def body(p, x):
        seen.append(p["wq"])
        return x + p["ln1"].sum()
    with tm.trainable():
        y = tapir.scan_layers(body, dict(tm.blocks), torch.zeros(()))
        assert [v.data_ptr() for v in seen] == [
            tm.blocks["wq"][i].data_ptr() for i in range(tm.cfg.n_layers)]
        assert {type(v.grad_fn).__name__ for v in seen} == {
            "UnbindBackward0"}
        y.backward()
    # eagerly "dots" has no checkpoint policy: it is the captured step's
    with pytest.raises(NotImplementedError, match="capture-step"):
        with tapir.use(tapir.TapirConfig(remat="dots")):
            tapir.scan_layers(body, dict(tm.blocks), torch.zeros(()))


class _FakeGraphs:
    def __init__(self):
        self.calls = []

    def accepts(self, vals):
        return True

    def capture(self, fn, inputs, device):
        self.calls.append("capture")
        return None, fn(inputs)

    def replay(self, handle):
        self.calls.append("replay")


def test_programs_that_require_grad_are_never_graphed_nor_donate():
    """Under grad mode a region program whose inputs require grad runs
    eagerly at every call (autograd records it), and a donated write into
    such an input raises."""
    fake = _FakeGraphs()
    gc = graphs.GraphCache(backend=fake)
    w = torch.ones(3, 3, requires_grad=True)
    acc = torch.zeros(())

    def fn(inputs):
        return (inputs["x"] @ inputs["w"],)
    for _ in range(3):
        (y,) = gc.run("k", fn, {"x": torch.ones(2, 3), "w": w, "acc": acc},
                      capture=True, written=frozenset({"acc"}))
        assert y.grad_fn is not None
    assert fake.calls == []
    from repro_torch.core import lowering
    from repro_torch.core.ir import Node, TensorType
    tt = TensorType((2,), "float32")
    nodes = {0: Node(0, "input", (), tt, attrs={"name": "a0"}),
             1: Node(1, "input", (), tt, attrs={"name": "a1"}),
             2: Node(2, "dynamic_update_slice", (0, 1), tt, donates=0)}
    env = {0: torch.zeros(2, requires_grad=True), 1: torch.ones(2)}
    with pytest.raises(RuntimeError, match="in place"):
        lowering._donated_in_place(nodes[2], nodes, env)
    with torch.no_grad():
        assert lowering._donated_in_place(nodes[2], nodes, env)


def test_launcher_trains_on_the_cpu(capsys):
    launch_train.main(["--device", "cpu", "--smoke", "--steps", "6",
                       "--batch", "4", "--seq", "32", "--lr", "1e-2"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["steps"] == 6 and line["tok_per_s"] > 0
    assert np.isfinite(line["losses"]).all()
    assert line["last_loss"] < line["first_loss"]


@pytest.mark.parametrize("flag", [["--remat", "dots"], ["--remat", "auto"],
                                  ["--remat", "dots", "--resume"]])
def test_launcher_refuses_what_is_not_ported(flag):
    """``--remat dots`` or ``auto`` without ``--capture-step``: the per-op
    step has no such policy (the captured step is tested in
    ``test_torch_region_step.py``), and ``--resume`` does not get past
    it.  ``--resume`` and ``--ckpt-dir`` themselves work since checkpoints
    were ported (``test_torch_checkpoint.py``)."""
    with pytest.raises(NotImplementedError):
        launch_train.main(["--device", "cpu", "--smoke", "--steps", "1"]
                          + flag)


@pytest.mark.parametrize("kw", [{"compress_pod_grads": True},
                                {"bf16_partials": True},
                                {"bf16_params_in_loss": True},
                                {"strategy": "fsdp_tp"}])
def test_train_config_refuses_what_is_not_ported(kw):
    """The per-op step refuses each; ``compress_pod_grads`` is the
    captured step's (no pod axis per op)."""
    with pytest.raises(NotImplementedError):
        make_train_step(None, optim.AdamWConfig(**OPT), TrainConfig(**kw))
