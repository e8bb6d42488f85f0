"""Fault tolerance in the port on one device (``dist/fault.py``, the
engine's supervised slot recovery and slot checkpoints, the train
launcher's ``FaultTolerantLoop``) against the JAX package's, at the
SMOKE shapes of qwen2.5-3b (2 layers, d_model 96) and whisper-small on
the CPU, fp32 compute, on the reference's ``init_params(PRNGKey(0))``
weights (``params_from_numpy``).

The single-device counterparts of ``tests/test_fault_serving.py`` (crash
with and without a checkpoint, straggle shedding, escalation, giving up)
and of ``tests/test_train_substrate.py``'s loop tests, each held to the
same guarantee: every request's tokens equal a clean run's (and the
reference engine's) exactly, and a replayed training run's parameters
equal the uninterrupted run's bitwise.  Across the packages: a slot
checkpoint the reference's engine wrote restores in the port's, which
finishes with the reference's tokens; ``PagePool.to_meta`` is the
reference's; the loop's stats match the reference's on the same
schedule of failures.
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
from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro.dist.fault import Fault as JFault
from repro.dist.fault import FaultTolerantLoop as JFaultTolerantLoop
from repro.models.base import get_model as j_get_model
from repro.serve import Request as JRequest
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServingEngine as JServingEngine
from repro.serve.pages import PagePool as JPagePool
from repro_torch import optim
from repro_torch.checkpoint import CheckpointManager, all_steps
from repro_torch.configs import get_smoke
from repro_torch.core import tapir
from repro_torch.dist import (Fault, FaultInjector, FaultTolerantLoop,
                              LoopStats, ScriptedFaultInjector,
                              StragglerWatchdog)
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import train as launch_train
from repro_torch.models.convert import params_from_numpy
from repro_torch.serve import Request, ServeConfig, ServingEngine
from repro_torch.serve import engine as engine_mod
from repro_torch.serve.pages import PagePool

PLENS = [6, 4, 7, 5, 6, 3]
NEWS = [4, 12, 6, 10, 8, 14]


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


def _prompts():
    rng = np.random.default_rng(0)
    return [(rng.integers(1, 100, size=p).astype(np.int32), n)
            for p, n in zip(PLENS, NEWS)]


def _requests():
    return [Request(rid=i, prompt=p, max_new=n)
            for i, (p, n) in enumerate(_prompts())]


def _outs(reqs):
    return [(list(map(int, r.out)), r.done) for r in reqs]


@pytest.fixture(scope="module")
def qwen():
    """(reference model, its params, the port's model on the same
    weights, the reference engine's clean outputs and stats)."""
    jcfg = dataclasses.replace(RC.get_smoke("qwen2_5_3b"),
                               compute_dtype="float32")
    jm = j_get_model(jcfg)
    jp = jm.init_params(jax.random.PRNGKey(0))
    tcfg = dataclasses.replace(get_smoke("qwen2_5_3b"),
                               compute_dtype="float32")
    tm = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), tcfg,
                           device="cpu")
    jeng = JServingEngine(jm, jp, batch=2, max_len=64,
                          cfg=JServeConfig(target="cpu"))
    jreqs = jeng.run([JRequest(rid=i, prompt=p, max_new=n)
                      for i, (p, n) in enumerate(_prompts())])
    return jm, jp, tm, _outs(jreqs), dict(jeng.last_stats)


def _engine(tm, **cfg):
    return ServingEngine(tm, batch=2, max_len=64,
                         cfg=ServeConfig(target="cpu", **cfg), device="cpu")


def _clean(tm):
    eng = _engine(tm)
    reqs = eng.run(_requests())
    return _outs(reqs), dict(eng.last_stats)


# ---------------------------------------------------------------------------
# Slot serving
# ---------------------------------------------------------------------------


def test_clean_port_run_equals_the_reference_engine(qwen):
    _, _, tm, jouts, jst = qwen
    outs, st = _clean(tm)
    assert outs == jouts
    assert st["failures"] == st["restores"] == st["checkpoints"] == 0
    assert st["decode_steps"] == jst["decode_steps"]


def test_crash_recovery_from_checkpoint_bitwise(tmp_path, qwen):
    _, _, tm, jouts, jst = qwen
    clean, clean_st = _clean(tm)
    inj = ScriptedFaultInjector({7: Fault("crash")})
    eng = _engine(tm, fault_injector=inj, ckpt_dir=str(tmp_path / "ck"),
                  ckpt_every=4)
    faulted = eng.run(_requests())
    assert _outs(faulted) == clean == jouts
    st = eng.last_stats
    assert st["failures"] == 1 and st["restores"] == 1
    assert st["checkpoints"] >= 1
    # the stats roll back with the state: replayed steps count once
    assert st["decode_steps"] == clean_st["decode_steps"] \
        == jst["decode_steps"]
    assert st["tokens"] == clean_st["tokens"]
    assert [s for s, _ in inj.fired] == [7]


def test_crash_without_checkpoint_replays_from_scratch(qwen):
    _, _, tm, jouts, _ = qwen
    inj = ScriptedFaultInjector({9: Fault("crash")})
    eng = _engine(tm, fault_injector=inj)
    faulted = eng.run(_requests())
    assert _outs(faulted) == jouts
    st = eng.last_stats
    assert st["failures"] == 1 and st["restores"] == 1
    assert st["checkpoints"] == 0


def test_host_fault_on_one_device_is_a_same_device_restore(tmp_path, qwen):
    """A ``host`` fault has no mesh to shrink on one device: the next
    attempt restores on the same device, as the reference's engine does
    without a mesh."""
    _, _, tm, jouts, _ = qwen
    inj = ScriptedFaultInjector({6: Fault("host", host=0)})
    eng = _engine(tm, fault_injector=inj, ckpt_dir=str(tmp_path / "ck"),
                  ckpt_every=3)
    assert _outs(eng.run(_requests())) == jouts
    st = eng.last_stats
    assert st["failures"] == 1 and st["restores"] == 1
    assert st["mesh_shrinks"] == 0


def test_straggle_sheds_admission_and_stays_bitwise(tmp_path, qwen):
    _, _, tm, jouts, _ = qwen
    # sustained straggle over steps [6, 14): flagged, admission sheds with
    # a bounded backoff, never escalates
    inj = ScriptedFaultInjector({6: Fault("straggle", delay_s=0.05,
                                          host=3)}, repeat=8)
    eng = _engine(tm, fault_injector=inj, ckpt_dir=str(tmp_path / "ck"),
                  straggle_patience=2, shed_base=2, shed_cap=8,
                  straggle_escalate=3)
    assert _outs(eng.run(_requests())) == jouts
    st = eng.last_stats
    assert st["shed_rounds"] >= 1 and st["shed_steps"] >= 1
    assert st["straggler_steps"] >= 1
    assert st["failures"] == 0
    assert st["step_p95"] > st["step_p50"] > 0.0


def test_straggle_escalates_to_eviction(tmp_path, qwen):
    _, _, tm, jouts, _ = qwen
    # patience 1 and no shed budget: the first flagged straggle escalates
    # (checkpoint -> a host fault -> a same-device restore)
    inj = ScriptedFaultInjector({5: Fault("straggle", delay_s=0.05)},
                                repeat=3)
    eng = _engine(tm, fault_injector=inj, ckpt_dir=str(tmp_path / "ck"),
                  straggle_patience=1, straggle_escalate=0)
    assert _outs(eng.run(_requests())) == jouts
    st = eng.last_stats
    assert st["failures"] >= 1 and st["restores"] >= 1
    assert st["checkpoints"] >= 1


def test_gives_up_after_max_failures(tmp_path, qwen):
    _, _, tm, _, _ = qwen

    class Persistent(FaultInjector):
        def on_decode_step(self, step):
            return Fault("crash") if step == 3 else None

    eng = _engine(tm, fault_injector=Persistent(),
                  ckpt_dir=str(tmp_path / "ck"), ckpt_every=8,
                  max_failures=2)
    with pytest.raises(RuntimeError, match="giving up"):
        eng.run(_requests())


def test_config_checks_follow_the_reference():
    with pytest.raises(ValueError, match="shed_base"):
        ServeConfig(shed_base=-1)
    with pytest.raises(ValueError, match="shed_base"):
        ServeConfig(shed_cap=-1)
    ref = JServeConfig()
    for name in ("ckpt_every", "max_failures", "straggler_threshold",
                 "straggle_patience", "shed_base", "shed_cap",
                 "straggle_escalate", "fault_injector", "ckpt_dir"):
        assert getattr(ServeConfig(), name) == getattr(ref, name), name


def test_a_checkpoint_is_a_copy_and_a_restore_writes_in_place(tmp_path,
                                                              qwen):
    """The pools are updated in place, so a checkpoint must not alias
    them: after a save, later writes to the live pools do not reach it;
    the restore copies it back into the same tensors (``data_ptr``
    unchanged), and ``ptab`` / ``pos`` / ``rng`` with them."""
    _, _, tm, _, _ = qwen
    eng = _engine(tm, ckpt_dir=str(tmp_path / "ck"))
    reqs = _requests()
    rs = eng._fresh_slot_state(reqs)
    gen = torch.Generator().manual_seed(0)
    for t in rs.cache["k"] + rs.cache["v"]:
        t.copy_(torch.randn(t.shape, generator=gen))
    rs.cache["pos"].copy_(torch.tensor([5, 9], dtype=torch.int32))
    rs.step = 4
    ft = {"checkpoints": 0, "restores": 0}
    eng._save_slot_ckpt(rs, reqs, ft)
    want = {k: [t.clone() for t in rs.cache[k]] for k in ("k", "v")}
    ptrs = [t.data_ptr() for t in rs.cache["k"] + rs.cache["v"]]
    for t in rs.cache["k"] + rs.cache["v"]:
        t.fill_(7.0)
    rs.cache["pos"].zero_()
    back = eng._restore_slot_state(reqs, ft, rs)
    assert [t.data_ptr() for t in back.cache["k"] + back.cache["v"]] == ptrs
    for k in ("k", "v"):
        assert all(torch.equal(a, b) for a, b in zip(back.cache[k], want[k]))
    assert back.cache["pos"].tolist() == [5, 9]
    assert back.rng.dtype == torch.uint32 and back.step == 4
    assert ft == {"checkpoints": 1, "restores": 1}


def test_a_reference_slot_checkpoint_restores_in_the_port(tmp_path, qwen):
    """The reference's engine writes slot checkpoints (its format: the
    pools, ``ptab``, ``pos``, the ``rng`` key and the JSON meta); the
    port's engine, crashing before its first decode step, restores the
    latest of them and finishes with the reference's tokens."""
    jm, jp, tm, jouts, _ = qwen
    d = str(tmp_path / "ref")
    jeng = JServingEngine(jm, jp, batch=2, max_len=64,
                          cfg=JServeConfig(target="cpu", ckpt_dir=d,
                                           ckpt_every=4))
    jeng.run([JRequest(rid=i, prompt=p, max_new=n)
              for i, (p, n) in enumerate(_prompts())])
    steps = all_steps(d)
    assert steps and steps[-1] > 0
    with open(f"{d}/step_{steps[-1]:08d}/manifest.json") as f:
        leaves = json.load(f)["leaves"]
    assert leaves["rng"] == {"shape": [2], "dtype": "uint32"}
    inj = ScriptedFaultInjector({0: Fault("crash")})
    eng = _engine(tm, fault_injector=inj, ckpt_dir=d)
    out = eng.run(_requests())
    assert _outs(out) == jouts
    st = eng.last_stats
    assert st["failures"] == 1 and st["restores"] == 1


def test_page_pool_meta_is_the_references():
    """The same bindings, publishes and parks give the reference's meta,
    and ``from_meta`` of either rebuilds it."""
    rng = np.random.default_rng(3)
    prompt = rng.integers(1, 100, size=40).astype(np.int32)
    ours, ref = PagePool(3, 64, 8, 12), JPagePool(3, 64, 8, 12)
    for pool, zeros, copy in (
            (ours, torch.zeros, lambda t: t),
            (ref, lambda s: jnp.zeros(s), lambda t: t)):
        cache = {"k": [zeros((1 + 3 * 8 + 12, 8, 1, 2))],
                 "v": [zeros((1 + 3 * 8 + 12, 8, 1, 2))]}
        assert pool.publish(cache, 0, prompt) == 5
        k, _ = pool.lookup(prompt)
        pool.bind(1, prompt, k)
        assert pool.park(cache, 9, 2, 20)
    meta = ours.to_meta()
    assert meta == ref.to_meta()
    assert json.loads(json.dumps(meta)) == meta
    for src in (meta, ref.to_meta()):
        back = PagePool.from_meta(src, 3, 64, 8, 12)
        assert back.to_meta() == meta


def test_serve_launcher_takes_the_fault_flags(tmp_path, capsys):
    out = serve_cli.main(["--smoke", "--device", "cpu", "--requests", "3",
                          "--batch", "2", "--prompt-len", "6",
                          "--max-new", "6", "--max-len", "32",
                          "--ckpt-dir", str(tmp_path / "ck"),
                          "--ckpt-every", "2", "--inject-crash", "3"])
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rep["fault"]["failures"] == 1 and rep["fault"]["restores"] == 1
    assert rep["fault"]["checkpoints"] >= 1
    clean = serve_cli.main(["--smoke", "--device", "cpu", "--requests", "3",
                            "--batch", "2", "--prompt-len", "6",
                            "--max-new", "6", "--max-len", "32"])
    assert _outs(out) == _outs(clean)
    assert "fault" not in json.loads(
        capsys.readouterr().out.strip().splitlines()[-1])


# ---------------------------------------------------------------------------
# The training loop
# ---------------------------------------------------------------------------


TARGET = [1.0, -1.0, 0.5, 2.0]
QUAD = dict(lr=0.05, weight_decay=0.0, warmup_steps=1, total_steps=100)


def _quadratic_setup(tmp_path, inject=None):
    """The reference test's quadratic problem on the port's AdamW: the
    step updates its state in place."""
    cfg = optim.AdamWConfig(**QUAD)
    target = torch.tensor(TARGET)

    def step_fn(state, batch):
        w = state["params"]["w"]
        with torch.enable_grad():
            p = w.detach().requires_grad_()
            loss = torch.sum((p - target) ** 2) + 0.0 * torch.sum(
                batch["x"])
            g = torch.autograd.grad(loss, p)[0]
        optim.adamw_update(state["params"], {"w": g}, state["opt"], cfg)
        return state, {"loss": loss.detach()}

    def batch_at(s):
        return {"x": torch.ones((2,)) * s}

    params = {"w": torch.zeros((4,))}
    state = {"params": params, "opt": optim.adamw_init(params, cfg)}
    ckpt = CheckpointManager(str(tmp_path / "ck"), keep_n=2, every=5,
                             async_save=False)
    loop = FaultTolerantLoop(step_fn, ckpt, batch_at, inject_failure=inject)
    return loop, state


def _once(*steps):
    seen = set()

    def inject(step):
        if step in steps and step not in seen:
            seen.add(step)
            return True
        return False
    return inject


def test_fault_loop_clean_run(tmp_path):
    loop, state = _quadratic_setup(tmp_path)
    state, stats = loop.run(state, 0, 30)
    assert stats.steps_run == 30 and stats.failures == 0
    assert stats.losses[-1] < stats.losses[0]


@pytest.mark.parametrize("fails", [(12, 23), (3,)],
                         ids=["from_checkpoints", "from_scratch"])
def test_fault_loop_recovers_and_matches_clean_run(tmp_path, fails):
    """Failures after a checkpoint restore it; a failure before any
    (step 3, every 5) replays from the initial state, which the loop
    copied (the step updates its state in place): both end on the
    uninterrupted run's parameters, bitwise."""
    loop_a, state_a = _quadratic_setup(tmp_path / "a")
    state_a, _ = loop_a.run(state_a, 0, 30)
    loop_b, state_b = _quadratic_setup(tmp_path / "b", inject=_once(*fails))
    state_b, stats = loop_b.run(state_b, 0, 30)
    assert stats.failures == len(fails)
    assert stats.restores == (len(fails) if fails[0] >= 5 else 0)
    for a, b in zip(optim.tree_leaves(state_a), optim.tree_leaves(state_b)):
        assert torch.equal(a, b)


def test_fault_loop_gives_up_after_retries(tmp_path):
    loop, state = _quadratic_setup(tmp_path, inject=lambda s: s == 3)
    with pytest.raises(RuntimeError, match="giving up"):
        loop.run(state, 0, 10)


def test_loop_stats_record_loss_dedupes_replays():
    st = LoopStats()
    for s in (0, 1, 2):
        st.record_loss(s, float(s))
    st.record_loss(1, 10.0)
    st.record_loss(2, 20.0)
    assert st.losses == [0.0, 10.0, 20.0]


def test_fault_loop_losses_one_entry_per_step(tmp_path):
    loop_a, state_a = _quadratic_setup(tmp_path / "a")
    _, stats_a = loop_a.run(state_a, 0, 30)
    loop_b, state_b = _quadratic_setup(tmp_path / "b", inject=_once(12, 23))
    _, stats_b = loop_b.run(state_b, 0, 30)
    assert len(stats_b.losses) == 30 == len(stats_a.losses)
    assert stats_a.losses == stats_b.losses


def test_straggler_watchdog():
    wd = StragglerWatchdog(threshold=2.0)
    for i in range(20):
        wd.observe(i, 0.1)
    assert wd.observe(20, 0.5)
    assert not wd.observe(21, 0.11)
    assert wd.flagged == [20] and wd.p95 > 0


def test_fault_loop_follows_the_reference_loop(tmp_path):
    """The reference's loop and the port's, on the same quadratic problem
    and the same failures: the same steps run, failures, restores and
    losses (rtol 1e-6: XLA and torch round the AdamW update apart)."""
    jcfg = jopt.AdamWConfig(**QUAD)
    target = jnp.asarray(TARGET)

    def jstep(state, batch):
        def loss_fn(p):
            return jnp.sum((p["w"] - target) ** 2) + 0.0 * jnp.sum(
                batch["x"])
        loss, g = jax.value_and_grad(loss_fn)(state["params"])
        p2, o2, _ = jopt.adamw_update(state["params"], g, state["opt"], jcfg)
        return {"params": p2, "opt": o2}, {"loss": loss}

    params = {"w": jnp.zeros((4,))}
    jstate = {"params": params, "opt": jopt.adamw_init(params, jcfg)}
    jloop = JFaultTolerantLoop(
        jax.jit(jstep), JCheckpointManager(str(tmp_path / "j"), keep_n=2,
                                           every=5, async_save=False),
        lambda s: {"x": jnp.ones((2,)) * s}, inject_failure=_once(3, 12, 23))
    _, jstats = jloop.run(jstate, 0, 30)
    loop, state = _quadratic_setup(tmp_path / "t", inject=_once(3, 12, 23))
    _, stats = loop.run(state, 0, 30)
    assert (stats.steps_run, stats.failures, stats.restores) == (
        jstats.steps_run, jstats.failures, jstats.restores)
    np.testing.assert_allclose(stats.losses, jstats.losses, rtol=1e-6)


def test_fault_kinds_and_injector_follow_the_reference():
    faults = {2: ("crash", {}), 5: ("straggle", {"delay_s": 0.1, "host": 1})}
    ours = ScriptedFaultInjector(
        {s: Fault(k, **kw) for s, (k, kw) in faults.items()}, repeat=3)
    from repro.dist.fault import ScriptedFaultInjector as JInjector
    ref = JInjector({s: JFault(k, **kw) for s, (k, kw) in faults.items()},
                    repeat=3)
    for step in list(range(10)) + [2]:
        a, b = ours.on_decode_step(step), ref.on_decode_step(step)
        assert (a is None) == (b is None)
        if a is not None:
            assert dataclasses.astuple(a) == dataclasses.astuple(b)


def test_launcher_replays_whisper_bitwise_through_the_loop(tmp_path,
                                                          capsys,
                                                          monkeypatch):
    """``launch/train.py --arch whisper_small`` runs its steps through
    ``FaultTolerantLoop``: a failure injected at step 3 restores the step-2
    checkpoint and replays; every parameter equals the uninterrupted
    run's bitwise, and the line reports the failure."""
    argv = ["--arch", "whisper_small", "--smoke", "--device", "cpu",
            "--steps", "4", "--batch", "2", "--seq", "16", "--lr", "1e-3",
            "--ckpt-every", "2"]
    whole, losses = launch_train.main(argv + ["--ckpt-dir",
                                              str(tmp_path / "a")])
    capsys.readouterr()

    class Failing(FaultTolerantLoop):
        def __init__(self, *a, **kw):
            super().__init__(*a, inject_failure=_once(3), **kw)
    monkeypatch.setattr(launch_train, "FaultTolerantLoop", Failing)
    faulted, losses_b = launch_train.main(argv + ["--ckpt-dir",
                                                  str(tmp_path / "b")])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["failures"] == 1 and line["steps"] == 5
    assert line["straggler_steps"] == [] or isinstance(
        line["straggler_steps"], list)
    assert losses_b == losses
    for a, b in zip(optim.tree_leaves(whole), optim.tree_leaves(faulted)):
        assert torch.equal(a, b)


def test_engine_has_no_step_window_of_its_own():
    """The engine's step statistics are the watchdog's (the reference's
    ``StragglerWatchdog``), not a window of its own."""
    assert not hasattr(engine_mod, "StepWindow")
    assert engine_mod.StragglerWatchdog is StragglerWatchdog
