"""Training the encoder-decoder and VLM families in the port
(``train/step.py::make_train_step``, the captured
``train/region_step.py::make_region_train_step`` and ``launch/train.py``
on ``models/whisper.py`` and ``models/vlm.py``) against the JAX
package's, at the SMOKE shapes of whisper-small (2 + 2 layers, 32
frames) and internvl2-76b (2 layers, 8 image tokens) on the CPU in fp32
compute.

The weights are the reference's ``init_params(PRNGKey(0))`` carried across
as numpy; the batches are ``TokenPipeline``'s (the same bytes in both
packages) plus the inputs the pipeline lacks, filled with zeros from
``input_specs`` as the reference's launcher fills them.  The reference
step is its launcher's ``raw_step`` (no mesh: ``jax.value_and_grad`` of
``model.loss``, then ``adamw_update``).  Tolerances, ``chip_smoke.py``'s
``TRAIN_PAR_TOL`` (XLA and torch sum in other orders): loss rtol 1e-5, lr
rtol 1e-6, each leaf's first gradient within 2e-4 of its largest entry;
the grad norm rtol 1e-4 at the first step and 1e-3 after it.  Inside the
port: captured = per op, bitwise.
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
from repro.models.base import get_model as j_get_model
from repro_torch import optim
from repro_torch.configs import get_config, get_smoke
from repro_torch.core import tapir
from repro_torch.core.dtypes import dtype_name
from repro_torch.data import DataConfig, TokenPipeline, to_device
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.fused_matmul import ops as fm_ops
from repro_torch.launch import train as launch_train
from repro_torch.models import mamba, moe, rwkv, transformer, vlm, whisper  # noqa: F401,E501
from repro_torch.models.base import _REGISTRY
from repro_torch.models.convert import params_from_numpy
from repro_torch.train import (TrainConfig, init_state,
                               make_region_train_step, make_train_step)

ARCHS = ["whisper_small", "internvl2_76b"]
B, S, STEPS = 2, 16, 3
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=STEPS)
CPU = TrainConfig(target="cpu")
#: chip_smoke.py's TRAIN_PAR_TOL
GRAD_TOL, LOSS_RTOL, LR_RTOL = 2e-4, 1e-5, 1e-6


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


def _port(arch, tree=None):
    cfg = dataclasses.replace(get_smoke(arch), compute_dtype="float32")
    return params_from_numpy(_reference(arch)[1] if tree is None else tree,
                             cfg, device="cpu")


def _step_tree(arch):
    """The weights the multi-step comparisons start from: the reference's
    init, but Whisper's at fan-in (``_fan_in``): at the reference's init
    its first gradients already sit 2.2e-3 / 2.8e-3 (port / reference)
    from the exact ones (``test_first_gradients_match_the_reference``),
    and the trajectories part further with every step (the grad norm
    1085.9 against 1082.6 by the third step)."""
    tree = _reference(arch)[1]
    return _fan_in(tree) if arch == "whisper_small" else tree


def _batches(arch, n=STEPS):
    """The reference launcher's batches: ``TokenPipeline``'s, then every
    other input of ``input_specs(S, B, "train")`` as zeros."""
    jm, _ = _reference(arch)
    pipe = TokenPipeline(DataConfig(seq_len=S, global_batch=B, vocab=512))
    want = JTokenPipeline(JDataConfig(seq_len=S, global_batch=B, vocab=512))
    out = []
    for s in range(n):
        b = dict(pipe.batch_at(s))
        np.testing.assert_array_equal(b["tokens"], want.batch_at(s)["tokens"])
        for k, spec in jm.input_specs(S, B, "train").items():
            if k not in b:
                b[k] = np.zeros(spec.shape, spec.dtype)
        out.append(b)
    return out


def _raw_step(jm):
    """The reference launcher's per-op step, also returning the
    gradients."""
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


# ---------------------------------------------------------------------------
# Inputs
# ---------------------------------------------------------------------------


def _unbuilt(cfg):
    """The family's model object with ``cfg`` and no weights (the specs
    read the config alone; InternVL2-76B's weights would not fit)."""
    cls = _REGISTRY[cfg.family]
    obj = cls.__new__(cls)
    torch.nn.Module.__init__(obj)
    obj.cfg = cfg
    return obj


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
@pytest.mark.parametrize("arch", ARCHS + ["qwen2_5_3b"])
def test_input_specs_are_the_references(arch, smoke, kind):
    """Every input's name, shape and dtype as the reference's
    ``input_specs`` gives them (the full configs are built abstractly on
    the reference's side, with no weights here)."""
    jcfg = (RC.get_smoke if smoke else RC.get_config)(arch)
    tcfg = (get_smoke if smoke else get_config)(arch)
    want = j_get_model(jcfg).input_specs(448, 3, kind)
    got = _unbuilt(tcfg).input_specs(448, 3, kind)
    assert sorted(got) == sorted(want)
    for k, spec in want.items():
        assert tuple(got[k].shape) == tuple(spec.shape), k
        assert dtype_name(got[k].dtype) == str(np.dtype(spec.dtype)), k


@pytest.mark.parametrize("arch", ARCHS)
def test_the_launcher_fills_what_the_pipeline_lacks_with_zeros(
        arch, monkeypatch, tmp_path):
    """``launch/train.py``'s batches: the pipeline's tokens and labels,
    and every other input of ``input_specs(seq, batch, "train")`` as
    zeros of its shape and dtype on the device (no draw from the seed)."""
    seen = []
    real = launch_train.make_train_step

    def make(*a, **kw):
        step = real(*a, **kw)

        def spy(state, batch):
            seen.append(batch)
            return step(state, batch)
        return spy
    monkeypatch.setattr(launch_train, "make_train_step", make)
    launch_train.main(["--arch", arch, "--smoke", "--device", "cpu",
                       "--steps", "2", "--batch", str(B), "--seq", str(S),
                       "--ckpt-dir", str(tmp_path)])
    cfg = get_smoke(arch)
    extra, shape = (("frames", (B, cfg.n_frames, cfg.d_model))
                    if arch == "whisper_small" else
                    ("image_embeds", (B, cfg.n_img_tokens, cfg.d_model)))
    pipe = TokenPipeline(DataConfig(seq_len=S, global_batch=B,
                                    vocab=cfg.vocab))
    assert len(seen) == 2
    for s, b in enumerate(seen):
        assert sorted(b) == sorted(["tokens", "labels", extra])
        assert tuple(b[extra].shape) == shape
        assert b[extra].dtype == torch.bfloat16      # the compute dtype
        assert not b[extra].any()
        np.testing.assert_array_equal(b["tokens"].numpy(),
                                      pipe.batch_at(s)["tokens"])


# ---------------------------------------------------------------------------
# Steps against the reference
# ---------------------------------------------------------------------------


def _fan_in(tree):
    """``tree`` with every stacked weight matrix drawn again at 1 /
    sqrt(its rows) (seed 1): the init under which Whisper is well
    conditioned (``tests/test_torch_cuda_whisper_vlm.py``'s ``fan_in``)."""
    rng = np.random.default_rng(1)
    out = jax.tree_util.tree_map(lambda a: a, tree)
    for stack in ("enc", "dec", "blocks"):
        for n, t in out.get(stack, {}).items():
            if t.ndim == 3:
                out[stack][n] = (rng.standard_normal(t.shape)
                                 / np.sqrt(t.shape[1])).astype(np.float32)
    return out


def _first(arch, tree, batch, fp64=False):
    """(loss, gradients in ``tree_leaves`` order as numpy) of the
    reference and of the port on ``tree``'s weights, per op, remat none;
    with ``fp64`` every fp32 evaluation promoted to fp64 in both packages
    (``float32`` read as ``float64`` while they run)."""
    tap = JTapirConfig(mode="tapir", remat="none", cost_model=J_CPU)
    cast = (lambda a: a.astype(np.float64) if a.dtype.kind == "f" else a) \
        if fp64 else (lambda a: a)
    jtapir.clear_cache()
    with jax.enable_x64(fp64), pytest.MonkeyPatch.context() as mp:
        if fp64:
            mp.setattr(jnp, "float32", jnp.float64)
        cdt = "float64" if fp64 else "float32"
        jm = j_get_model(dataclasses.replace(RC.get_smoke(arch),
                                             compute_dtype=cdt))
        jb = {k: jnp.asarray(cast(v)) for k, v in batch.items()}

        def loss_fn(p):
            with j_use(tap):
                return jm.loss(p, jb)
        jl, jg = jax.value_and_grad(loss_fn)(jax.tree_util.tree_map(
            lambda a: jnp.asarray(cast(a)), tree))
        jg = [np.asarray(g) for g in jax.tree_util.tree_leaves(jg)]
    jtapir.clear_cache()
    with pytest.MonkeyPatch.context() as mp:
        if fp64:
            mp.setattr(torch, "float32", torch.float64)
        cfg = dataclasses.replace(get_smoke(arch), compute_dtype=(
            "float64" if fp64 else "float32"))
        tm = params_from_numpy(tree, cfg, device="cpu")
        if fp64:
            for p in optim.tree_leaves(tm.param_tree()):
                p.data = p.data.double()
        loss, grads = _grads(tm, {k: cast(v) for k, v in batch.items()},
                             TrainConfig(target="cpu", remat="none"))
    return (float(jl), jg), (float(loss), [g.numpy() for g in grads])


def _rel(got, want) -> list:
    """max |got - want| / max |want|, leaf by leaf."""
    return [float(np.abs(np.asarray(g, np.float64) - w).max()
                  / max(float(np.abs(w).max()), 1e-30))
            for g, w in zip(got, want)]


@pytest.mark.parametrize("init", ["fan_in", "reference"])
@pytest.mark.parametrize("arch", ARCHS)
def test_first_gradients_match_the_reference(arch, init):
    """The first batch's loss (rtol 1e-5) and every leaf's gradient
    against ``jax.value_and_grad`` of the reference's loss on the same
    weights, within 2e-4 of the leaf's largest entry.

    Whisper at the reference's init is the exception (ROADMAP queue 3: a
    stacked leaf at 1 / sqrt(its layer count) leaves it badly
    conditioned): there neither package's fp32 gradient lies within 2e-4
    of the exact one (an fp64 evaluation, on which both packages agree
    within 1e-9): the port's within 2.2e-3, the reference's within
    2.8e-3.  So there the port is held to the fp64 evaluation no further
    than the reference's own fp32 gradient lies from it, and the 2e-4
    bound to the reference is held at the fan-in init, where Whisper is
    well conditioned."""
    _, tree = _reference(arch)
    if init == "fan_in":
        tree = _fan_in(tree)
    batch = _batches(arch, 1)[0]
    (jloss, jg), (loss, grads) = _first(arch, tree, batch)
    np.testing.assert_allclose(loss, jloss, rtol=LOSS_RTOL)
    assert [g.shape for g in grads] == [g.shape for g in jg]
    if arch == "whisper_small" and init == "reference":
        (jl64, jexact), (l64, exact) = _first(arch, tree, batch, fp64=True)
        np.testing.assert_allclose(l64, jl64, rtol=1e-12)
        assert max(_rel(exact, jexact)) <= 1e-9
        assert max(_rel(grads, exact)) <= max(_rel(jg, exact))
        return
    assert max(_rel(grads, jg)) <= GRAD_TOL


@pytest.mark.parametrize("arch", ARCHS)
def test_three_steps_match_the_reference_raw_step(arch):
    jm, _ = _reference(arch)
    tree = _step_tree(arch)
    tm = _port(arch, tree)
    jstep = _raw_step(jm)
    jstate = {"params": jax.tree_util.tree_map(jnp.asarray, tree)}
    jstate["opt"] = jopt.adamw_init(jstate["params"], jopt.AdamWConfig(**OPT))
    step = make_train_step(tm, optim.AdamWConfig(**OPT), CPU)
    state = init_state(tm, optim.AdamWConfig(**OPT))
    for s, batch in enumerate(_batches(arch)):
        jstate, jm_, _ = jstep(jstate, {k: jnp.asarray(v)
                                        for k, v in batch.items()})
        state, m = step(state, to_device(batch, "cpu"))
        np.testing.assert_allclose(float(m["loss"]), float(jm_["loss"]),
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(float(m["lr"]), float(jm_["lr"]),
                                   rtol=LR_RTOL)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm_["grad_norm"]),
                                   rtol=1e-4 if s == 0 else 1e-3)
    assert int(state["opt"]["step"]) == STEPS


def _run(arch, make_step, tcfg):
    tm = _port(arch)
    step = make_step(tm, optim.AdamWConfig(**OPT), tcfg)
    state = init_state(tm, optim.AdamWConfig(**OPT))
    losses = []
    for batch in _batches(arch):
        state, m = step(state, to_device(batch, "cpu"))
        losses.append(m["loss"].clone())
    return losses, [t.clone() for t in optim.tree_leaves(state)]


@pytest.mark.parametrize("arch", ARCHS)
def test_captured_step_equals_per_op_bitwise(arch):
    """The captured step (the whole update one region program, its
    backward derived by ``core/autodiff.py``) against the per-op step
    under the same remat: every loss, parameter and AdamW moment after 3
    steps, bitwise."""
    tcfg = TrainConfig(target="cpu", remat="full")
    a_losses, a_state = _run(arch, make_train_step, tcfg)
    b_losses, b_state = _run(arch, make_region_train_step, tcfg)
    assert all(torch.equal(a, b) for a, b in zip(a_losses, b_losses))
    assert len(a_state) == len(b_state)
    assert all(torch.equal(a, b) for a, b in zip(a_state, b_state))


@pytest.mark.parametrize("arch", ARCHS)
def test_the_step_goes_through_the_functions_and_updates_in_place(
        arch, monkeypatch):
    """Every product of a step goes through ``FusedMatmulFn`` and every
    attention through ``FlashAttentionFn``, as many times as
    ``chip_smoke.py``'s ``whisper_train_launches`` /
    ``vlm_train_launches`` count the card's launches (on CPU tensors the
    plain versions: no launch); every leaf gets a finite gradient and is
    updated in its own storage."""
    tm = _port(arch)
    calls = collections.Counter()
    real_product = fm_ops._product

    def product(x, w, *a):
        calls["gemm_forward"] += 1
        return real_product(x, w, *a)
    monkeypatch.setattr(fm_ops, "_product", product)
    for route, key in (("matmul_dx", "gemm_dx"), ("matmul_dw", "gemm_dw")):
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
         to_device(_batches(arch, 1)[0], "cpu"))
    cs = _chip_smoke()
    want = (cs.whisper_train_launches if arch == "whisper_small"
            else cs.vlm_train_launches)(tm.cfg)
    calls["flash_forward"] = fa_ops.function_calls["forward"]
    calls["flash_backward"] = fa_ops.function_calls["backward"]
    assert dict(calls) == want
    assert fm_ops.launches == 0 and fa_ops.launches == 0
    assert [t.data_ptr() for t in leaves] == ptrs
    changed = [not torch.equal(a, b) for a, b in zip(before, leaves)]
    assert sum(changed) >= len(leaves) - 1
    _, grads = _grads(tm, _batches(arch, 1)[0])
    assert all(bool(torch.isfinite(g).all()) for g in grads)


@pytest.mark.parametrize("extra", [[], ["--capture-step"]],
                         ids=["per_op", "captured"])
@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_trains_as_the_reference_launcher(arch, extra, capsys,
                                                   monkeypatch, tmp_path):
    """``launch/train.py --arch whisper_small | internvl2_76b --smoke
    --device cpu``, per op and ``--capture-step``, on the reference's
    initial weights: its losses are the reference launcher's step's (on
    its zero-filled batches) within loss rtol 1e-5 (Whisper from the
    fan-in init, ``_step_tree``)."""
    jm, _ = _reference(arch)
    tree = _step_tree(arch)

    def get(cfg, device, generator=None):
        return params_from_numpy(
            tree, dataclasses.replace(cfg, compute_dtype="float32"),
            device=device)
    monkeypatch.setattr(launch_train, "get_model", get)
    launch_train.main(["--arch", arch, "--smoke", "--device", "cpu",
                       "--steps", str(STEPS), "--batch", str(B),
                       "--seq", str(S), "--lr", "1e-3", "--remat", "none",
                       "--ckpt-dir", str(tmp_path)] + extra)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["steps"] == STEPS and line["failures"] == 0
    if extra:
        assert line["grad_meta"]["n_bwd"] > 0
    tap = JTapirConfig(mode="tapir", remat="none", cost_model=J_CPU)
    cfg = jopt.AdamWConfig(lr=1e-3, total_steps=STEPS, warmup_steps=1)

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
    for s, batch in enumerate(_batches(arch)):
        state, loss = step(state, {k: jnp.asarray(v)
                                   for k, v in batch.items()})
        np.testing.assert_allclose(line["losses"][s], float(loss),
                                   rtol=LOSS_RTOL)


def test_chip_smoke_counts_whisper_small_at_full_depth():
    """The card's counts at 12 + 12 layers: 133 forward products (4 an
    encoder layer, 7 a decoder layer, the head), 132 recomputed, 24 gelu
    recomputes; 36 flash calls a forward."""
    cs = _chip_smoke()
    cfg = get_config("whisper_small")
    assert cs.whisper_train_launches(cfg) == {
        "gemm_forward": 289, "gemm_dx": 133, "gemm_dw": 133,
        "flash_forward": 72, "flash_backward": 36}
    assert cs.vlm_train_launches(dataclasses.replace(
        get_config("internvl2_76b"), n_layers=2)) == {
        "gemm_forward": 17, "gemm_dx": 9, "gemm_dw": 9,
        "flash_forward": 4, "flash_backward": 2}


def test_chip_smoke_stamps_phase_lines_and_leaves_the_last_lines(capsys):
    """Every phase line carries the seconds since the script started
    (``at_s``: the time budget by phase); the kernels line and the
    result line are printed as given."""
    cs = _chip_smoke()
    cs.emit({"phase": "whisper_train", "x": 1})
    cs.emit({"kernels": []})
    cs.emit({"ok": True, "device": {"platform": "gpu", "kind": "k",
                                    "count": 1}})
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert lines[0]["x"] == 1 and lines[0]["at_s"] >= 0.0
    assert lines[1] == {"kernels": []}
    assert lines[2] == {"ok": True, "device": {"platform": "gpu",
                                               "kind": "k", "count": 1}}


@pytest.mark.parametrize("argv", [["--encdec-train"],
                                  ["--vlm-train-depths", "3,2,1"],
                                  ["--encdec-train-lrs", "3e-4,1e-4"]])
def test_chip_smoke_takes_the_new_modes_and_refuses_without_a_card(
        argv, monkeypatch, capsys):
    """The new modes parse (an unknown flag would exit through argparse)
    and, with no card, the script returns 2 and prints no result."""
    cs = _chip_smoke()
    monkeypatch.setattr(sys, "argv", ["chip_smoke.py"] + argv)
    assert not torch.cuda.is_available()
    assert cs.main() == 2
    out = capsys.readouterr()
    assert out.out == "" and "no CUDA card" in out.err
