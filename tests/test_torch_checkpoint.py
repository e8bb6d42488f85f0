"""The port's checkpoints (``checkpoint/ckpt.py``) against the JAX
package's (``repro.checkpoint``), and ``launch/train.py``'s ``--ckpt-dir``
/ ``--ckpt-every`` / ``--resume``, on the CPU.

* Across the packages, both ways: the reference's train state of
  zamba2-7b SMOKE after one step of its launcher's step, with a bf16 leaf
  beside the fp32 params and moments and the int32 step counter, saved by
  the reference restores in the port bit for bit, and the port's save of
  the same state restores in the reference's ``restore_checkpoint`` bit
  for bit; the two manifests agree in keys, shapes, dtypes and meta.
* The port's own guarantees: a ``_tmp`` directory or one without a
  manifest is invisible, ``keep_n``, an async save holds the values of
  the moment it was called, restore writes the template's own tensors and
  raises on a mismatched key, shape or dtype.
* A resumed run equals the uninterrupted one bit for bit (losses and the
  final state), for each ported family, per op and captured.  The run is
  interrupted, not cut short: a ``--steps 2`` run is another run, since
  the launcher's cosine schedule spans ``--steps`` (in both packages), so
  a ``--steps 4 --ckpt-every 2`` run dies in its third step and
  ``--resume --steps 4`` takes it on from the checkpoint of step 2.
"""
import dataclasses
import json
import os
import threading
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as RC
from repro import optim as jopt
from repro.checkpoint import restore_checkpoint as j_restore
from repro.checkpoint import save_checkpoint as j_save
from repro.core.schedule import CPU_COST_MODEL as J_CPU
from repro.core.tapir import TapirConfig as JTapirConfig
from repro.core.tapir import use as j_use
from repro.data import DataConfig as JDataConfig
from repro.data import TokenPipeline as JTokenPipeline
from repro.models.base import get_model as j_get_model
from repro_torch import optim
from repro_torch.checkpoint import (CheckpointManager, all_steps,
                                    latest_step, restore_checkpoint,
                                    save_checkpoint)
from repro_torch.checkpoint.ckpt import flatten
from repro_torch.configs import get_smoke
from repro_torch.dist.sharding import NamedSharding
from repro_torch.launch import train as launch_train
from repro_torch.models.convert import params_from_numpy
from repro_torch.train import init_state

ARCH = "zamba2_7b"
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=3)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref_state():
    """The reference's SMOKE train state after one step of its launcher's
    step (no mesh), plus a bf16 leaf."""
    cfg = dataclasses.replace(RC.get_smoke(ARCH), compute_dtype="float32")
    jm = j_get_model(cfg)
    ocfg = jopt.AdamWConfig(**OPT)
    params = jm.init_params(jax.random.PRNGKey(0))
    state = {"params": params, "opt": jopt.adamw_init(params, ocfg)}
    tap = JTapirConfig(mode="tapir", remat="none", cost_model=J_CPU)
    batch = {k: jnp.asarray(v) for k, v in JTokenPipeline(JDataConfig(
        seq_len=16, global_batch=2, vocab=cfg.vocab)).batch_at(0).items()}

    def loss_fn(p):
        with j_use(tap):
            return jm.loss(p, batch)
    grads = jax.grad(loss_fn)(params)
    p2, o2, _ = jopt.adamw_update(params, grads, state["opt"], ocfg)
    return {"params": p2, "opt": o2,
            "cast": {"embed": p2["embed"].astype(jnp.bfloat16)}}


def _port_template():
    """The port's state of the same structure (zeros of the same shapes
    and dtypes where it has no counterpart)."""
    cfg = dataclasses.replace(get_smoke(ARCH), compute_dtype="float32")
    tree = jax.tree_util.tree_map(
        np.asarray, j_get_model(dataclasses.replace(
            RC.get_smoke(ARCH), compute_dtype="float32")).init_params(
            jax.random.PRNGKey(1)))
    m = params_from_numpy(tree, cfg, device="cpu")
    state = init_state(m, optim.AdamWConfig(**OPT))
    state["cast"] = {"embed": torch.zeros(m.embed.shape,
                                          dtype=torch.bfloat16)}
    return state


def _bits(x) -> np.ndarray:
    """A leaf's bytes as unsigned integers (bf16 by its bits)."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy().view(f"u{x.element_size()}")
    a = np.asarray(x)
    return a.view(f"u{a.dtype.itemsize}")


def _leaf_keys(jtree) -> dict:
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(jtree)[0]}


def test_the_keys_are_the_reference_paths(ref_state):
    port = flatten(_port_template())
    ref = _leaf_keys(ref_state)
    assert list(port) == list(ref)
    assert "params/blocks/w_in" in port and "opt/step" in port
    assert "opt/mu/shared/wq" in port and "cast/embed" in port


def test_a_reference_checkpoint_restores_in_the_port(ref_state, tmp_path):
    j_save(str(tmp_path), 1, ref_state, meta={"arch": ARCH})
    tmpl = _port_template()
    ptrs = {k: t.data_ptr() for k, t in flatten(tmpl).items()}
    out, step, manifest = restore_checkpoint(str(tmp_path), tmpl)
    assert step == 1 and out is tmpl and manifest["meta"] == {"arch": ARCH}
    ref = _leaf_keys(ref_state)
    for k, t in flatten(out).items():
        assert t.data_ptr() == ptrs[k], k
        assert np.array_equal(_bits(t), _bits(ref[k])), k
    assert flatten(out)["cast/embed"].dtype == torch.bfloat16


def test_a_port_checkpoint_restores_in_the_reference(ref_state, tmp_path):
    tmpl = _port_template()
    j_save(str(tmp_path / "ref"), 1, ref_state, meta={"arch": ARCH})
    restore_checkpoint(str(tmp_path / "ref"), tmpl)
    save_checkpoint(str(tmp_path / "port"), 1, tmpl, meta={"arch": ARCH})
    jtmpl = jax.tree_util.tree_map(jnp.zeros_like, ref_state)
    got, step, manifest = j_restore(str(tmp_path / "port"), jtmpl)
    assert step == 1
    want = _leaf_keys(ref_state)
    for k, leaf in _leaf_keys(got).items():
        assert np.asarray(leaf).dtype == np.asarray(want[k]).dtype, k
        assert np.array_equal(_bits(leaf), _bits(want[k])), k
    with open(tmp_path / "ref" / "step_00000001" / "manifest.json") as f:
        jman = json.load(f)
    assert manifest["leaves"] == jman["leaves"]
    assert manifest["meta"] == jman["meta"]
    assert manifest["step"] == jman["step"] == 1
    assert set(manifest) == set(jman)
    assert jman["leaves"]["cast/embed"]["dtype"] == "bfloat16"
    assert jman["leaves"]["opt/step"]["dtype"] == "int32"


def _small_state():
    return {"w": torch.arange(12, dtype=torch.float32).reshape(3, 4),
            "h": [torch.ones(5, dtype=torch.bfloat16),
                  torch.tensor(7, dtype=torch.int32)]}


def test_staged_and_unfinished_directories_are_invisible(tmp_path):
    d = str(tmp_path)
    save_checkpoint(d, 3, _small_state())
    os.makedirs(tmp_path / "step_00000009_tmp")
    os.makedirs(tmp_path / "step_00000007")
    (tmp_path / "step_00000007" / "host_00000.npz").write_bytes(b"")
    assert all_steps(d) == [3] and latest_step(d) == 3
    assert latest_step(str(tmp_path / "absent")) is None
    _, step, _ = restore_checkpoint(d, _small_state())
    assert step == 3
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path / "empty"), _small_state())


def test_keep_n_collects_the_oldest(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_n=2, every=2,
                            async_save=False)
    state = _small_state()
    saved = [s for s in range(1, 9) if mgr.maybe_save(s, state)]
    assert saved == [2, 4, 6, 8]
    assert all_steps(str(tmp_path)) == [6, 8]
    assert not mgr.maybe_save(0, state) and not mgr.maybe_save(9, state)
    assert mgr.maybe_save(9, state, force=True)
    assert all_steps(str(tmp_path)) == [8, 9]


def test_an_async_save_holds_the_values_it_was_called_with(tmp_path):
    big = {"p": torch.randn(512, 1024, generator=torch.Generator()
                            .manual_seed(0)),
           "b": torch.randn(64, generator=torch.Generator().manual_seed(1)
                            ).to(torch.bfloat16)}
    want = {k: v.clone() for k, v in big.items()}
    mgr = CheckpointManager(str(tmp_path), keep_n=3, every=1)
    assert mgr.maybe_save(1, big)
    for v in big.values():        # the next step, in place
        v.add_(1)
    mgr.wait()
    got = {k: torch.zeros_like(v) for k, v in big.items()}
    restore_checkpoint(str(tmp_path), got)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_restore_writes_in_place_and_refuses_a_mismatch(tmp_path):
    d = str(tmp_path)
    save_checkpoint(d, 1, _small_state())
    tmpl = {"w": torch.zeros(3, 4), "h": [torch.zeros(5, dtype=torch.bfloat16),
                                          torch.zeros((), dtype=torch.int32)]}
    ptrs = [t.data_ptr() for t in optim.tree_leaves(tmpl)]
    out, _, _ = restore_checkpoint(d, tmpl)
    assert [t.data_ptr() for t in optim.tree_leaves(out)] == ptrs
    assert all(torch.equal(a, b) for a, b in zip(
        optim.tree_leaves(out), optim.tree_leaves(_small_state())))
    bad = [
        {"w": torch.zeros(3, 4), "h": [torch.zeros(5, dtype=torch.bfloat16)]},
        {"w": torch.zeros(3, 4), "x": torch.zeros(1),
         "h": [torch.zeros(5, dtype=torch.bfloat16),
               torch.zeros((), dtype=torch.int32)]},
        {"w": torch.zeros(4, 3), "h": [torch.zeros(5, dtype=torch.bfloat16),
                                       torch.zeros((), dtype=torch.int32)]},
        {"w": torch.zeros(3, 4), "h": [torch.zeros(5),
                                       torch.zeros((), dtype=torch.int32)]},
    ]
    for t in bad:
        with pytest.raises((KeyError, ValueError)):
            restore_checkpoint(d, t)
    # shardings (the elastic restore, tests/test_torch_mesh_serving.py):
    # none named restores whole leaves; a block that does not tile the
    # stored leaf is refused
    out, _, _ = restore_checkpoint(d, tmpl, shardings={})
    assert torch.equal(out["w"], _small_state()["w"])
    half = types.SimpleNamespace(axis_names=("model",), shape={"model": 2},
                                 coord=lambda a: 0)
    with pytest.raises(ValueError):
        restore_checkpoint(d, tmpl, shardings={
            "w": NamedSharding(half, (None, "model"))})


def _run(argv):
    return launch_train.main(["--device", "cpu", "--smoke", "--batch", "2",
                              "--seq", "16", "--lr", "1e-2"] + argv)


class _Killed(Exception):
    pass


def _dies_in_step(n: int, monkeypatch):
    """Make the launcher's steps raise in their ``n``-th call, as a run
    killed there."""
    for name in ("make_train_step", "make_region_train_step"):
        def make(*a, _real=getattr(launch_train, name), **kw):
            step, calls = _real(*a, **kw), [0]

            def dying(state, batch):
                calls[0] += 1
                if calls[0] == n:
                    raise _Killed
                return step(state, batch)
            return dying
        monkeypatch.setattr(launch_train, name, make)


@pytest.mark.parametrize("capture", [False, True],
                         ids=["per_op", "captured"])
@pytest.mark.parametrize("arch", ["qwen2_5_3b", "rwkv6_7b", "zamba2_7b",
                                  "granite_moe_1b_a400m",
                                  "moonshot_v1_16b_a3b"])
def test_a_resumed_run_equals_the_uninterrupted_one(arch, capture, tmp_path,
                                                    capsys, monkeypatch):
    argv = ["--arch", arch, "--steps", "4", "--ckpt-every", "2"] + (
        ["--capture-step"] if capture else [])
    whole, losses = _run(argv + ["--ckpt-dir", str(tmp_path / "whole")])
    assert all_steps(str(tmp_path / "whole")) == [2, 4]
    d = str(tmp_path / "run")
    with monkeypatch.context() as mp:
        _dies_in_step(3, mp)
        with pytest.raises(_Killed):
            _run(argv + ["--ckpt-dir", d])
    for t in threading.enumerate():      # the step-2 save's writer
        if t.name.startswith("checkpoint-write-"):
            t.join()
    assert all_steps(d) == [2]
    resumed, rest = _run(argv + ["--ckpt-dir", d, "--resume"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["start_step"] == 2 and line["steps"] == 2
    assert all_steps(d) == [2, 4]
    assert rest == losses[2:]
    for a, b in zip(optim.tree_leaves(whole), optim.tree_leaves(resumed)):
        assert torch.equal(a, b)


def test_resume_without_a_checkpoint_starts_cold(tmp_path, caplog, capsys):
    with caplog.at_level("INFO", logger="repro_torch.train"):
        _run(["--steps", "2", "--resume", "--ckpt-dir", str(tmp_path)])
    assert "no checkpoint found; cold start" in caplog.text
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["start_step"] == 0 and line["steps"] == 2
