"""The port's admission paths and step-time statistics against the JAX
package's, at the SMOKE shapes of qwen2.5-3b (2 layers, d_model 96) on the
CPU, on the reference's ``init_params(PRNGKey(0))`` weights at fp32
compute (``params_from_numpy``).

* admission: ``admit_policy="reject"``, the per-request ``max_steps``
  budget, the prompt bucket clamped to the page length and the SLO shed,
  each run through both engines on the same requests: the same requests
  finish, with the same greedy tokens, and the same counts
  (``tests/test_continuous_batching.py`` holds the reference to the same
  behaviours);
* the step-time window: the port's ``StragglerWatchdog`` (which the
  engine takes its step statistics from) gives the reference's p50, p95
  and flags on the same durations, past its 256 steps, and the engine's
  ``last_stats`` read that window.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import configs as RC
from repro.dist.fault import StragglerWatchdog
from repro.models.base import get_model as j_get_model
from repro.serve import Request as JRequest
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServingEngine as JServingEngine
from repro_torch.configs import get_smoke
from repro_torch.models.convert import params_from_numpy
from repro_torch.serve import Request, ServeConfig, ServingEngine
from repro_torch.dist import fault as fault_mod


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny CPU tensors: one intra-op thread per test process, so parallel
    test workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    """(reference model, its params, the port's model on the same
    weights) at fp32 compute."""
    jcfg = dataclasses.replace(RC.get_smoke("qwen2_5_3b"),
                               compute_dtype="float32")
    jm = j_get_model(jcfg)
    jp = jm.init_params(jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, jp)
    tcfg = dataclasses.replace(get_smoke("qwen2_5_3b"),
                               compute_dtype="float32")
    return jm, jp, params_from_numpy(tree, tcfg, device="cpu")


def _run_both(pair, reqs, batch, max_len, run_kw=None, **cfg):
    """Run copies of ``reqs`` ([(prompt, max_new, extra kwargs)]) through
    the reference engine and the port's; returns ((outputs, stats) of the
    reference, (outputs, stats) of the port)."""
    jm, jp, tm = pair
    run_kw = run_kw or {}
    jeng = JServingEngine(jm, jp, batch=batch, max_len=max_len,
                          cfg=JServeConfig(target="cpu", **cfg))
    teng = ServingEngine(tm, batch=batch, max_len=max_len,
                         cfg=ServeConfig(target="cpu", **cfg), device="cpu")
    jout = jeng.run([JRequest(rid=i, prompt=p.copy(), max_new=m, **e)
                     for i, (p, m, e) in enumerate(reqs)], **run_kw)
    tout = teng.run([Request(rid=i, prompt=p.copy(), max_new=m, **e)
                     for i, (p, m, e) in enumerate(reqs)], **run_kw)
    return (jout, jeng.last_stats), (tout, teng.last_stats)


def _same_streams(jout, tout):
    assert [r.done for r in tout] == [r.done for r in jout]
    assert [list(r.out) for r in tout] == [list(r.out) for r in jout]


COUNTS = ("tokens", "admitted", "rejected", "preempted", "decode_steps",
          "slo_shed")


def _same_counts(jst, tst):
    assert {k: tst[k] for k in COUNTS} == {k: jst[k] for k in COUNTS}


def test_admit_policy_reject_counts_and_serves_rest(pair):
    """An overflowing request is counted as rejected and never admitted;
    the rest are served (``admit_policy="reject"``)."""
    rng = np.random.default_rng(4)
    bad = (rng.integers(1, 100, size=8).astype(np.int32), 30, {})
    ok = (rng.integers(1, 100, size=5).astype(np.int32), 4, {})
    (jout, jst), (tout, tst) = _run_both(pair, [bad, ok], batch=1,
                                         max_len=32, admit_policy="reject")
    assert not tout[0].done and tout[0].out == []
    assert tout[1].done and len(tout[1].out) == 4
    assert tst["rejected"] == 1 and tst["admitted"] == 1
    _same_streams(jout, tout)
    _same_counts(jst, tst)


def test_max_steps_budget_is_per_request_not_global(pair):
    """``max_steps`` caps each request's decode steps, not the run's: six
    requests of 7 tokens on one slot all finish under max_steps=8, and an
    over-budget request frees its slot unfinished while the next one is
    still served."""
    rng = np.random.default_rng(6)
    reqs = [(rng.integers(1, 100, size=5).astype(np.int32), 7, {})
            for _ in range(6)]
    (jout, jst), (tout, tst) = _run_both(pair, reqs, batch=1, max_len=32,
                                         run_kw={"max_steps": 8})
    assert all(r.done and len(r.out) == 7 for r in tout)
    _same_streams(jout, tout)
    _same_counts(jst, tst)
    reqs = [(rng.integers(1, 100, size=5).astype(np.int32), 20, {}),
            (rng.integers(1, 100, size=5).astype(np.int32), 3, {})]
    (jout, jst), (tout, tst) = _run_both(pair, reqs, batch=1, max_len=32,
                                         run_kw={"max_steps": 4})
    assert not tout[0].done and len(tout[0].out) == 5   # prefill + 4 steps
    assert tout[1].done and len(tout[1].out) == 3
    assert tst["preempted"] == 1
    _same_streams(jout, tout)
    _same_counts(jst, tst)


def test_prompt_bucket_clamped_to_page_length(pair):
    """A prompt whose power-of-two bucket (32) exceeds max_len (24) still
    admits: the pad is clamped to the page, the prompt itself fits."""
    rng = np.random.default_rng(5)
    reqs = [(rng.integers(1, 100, size=20).astype(np.int32), 3, {})]
    (jout, jst), (tout, tst) = _run_both(pair, reqs, batch=2, max_len=24)
    assert tout[0].done and len(tout[0].out) == 3
    _same_streams(jout, tout)
    _same_counts(jst, tst)


def test_slo_shed_drops_requests_past_their_deadline(pair):
    """``admit_policy="slo"``: a request whose deadline has passed when it
    would be admitted is shed (counted as rejected and as ``slo_shed``);
    the others are served as without it."""
    rng = np.random.default_rng(7)
    reqs = [(rng.integers(1, 100, size=5).astype(np.int32), 4, {}),
            (rng.integers(1, 100, size=6).astype(np.int32), 4,
             {"deadline_s": 0.0}),
            (rng.integers(1, 100, size=4).astype(np.int32), 3,
             {"deadline_s": 1e6})]
    (jout, jst), (tout, tst) = _run_both(pair, reqs, batch=1, max_len=32,
                                         admit_policy="slo")
    assert [r.done for r in tout] == [True, False, True]
    assert tout[1].out == []
    assert tst["slo_shed"] == 1 and tst["rejected"] == 1
    _same_streams(jout, tout)
    _same_counts(jst, tst)


def _synthetic_steps(monkeypatch, durations):
    """Make the engine's window observe ``durations`` (in order) in place
    of the measured step times; returns the list of what it observed."""
    seen = []
    observe = fault_mod.StragglerWatchdog.observe

    def fake(self, step, _measured):
        d = durations[len(seen)]
        seen.append(d)
        return observe(self, step, d)

    monkeypatch.setattr(fault_mod.StragglerWatchdog, "observe", fake)
    return seen


def test_slo_shed_estimates_with_the_window_p50(pair, monkeypatch):
    """The shed's estimate is the remaining tokens times the window's p50:
    with every step observed at 1 s, a late arrival that needs 200 more
    steps misses a 100 s deadline and is shed, one that needs 4 is
    admitted."""
    _synthetic_steps(monkeypatch, [1.0] * 1000)
    _, _, tm = pair
    rng = np.random.default_rng(8)
    eng = ServingEngine(tm, batch=1, max_len=256,
                        cfg=ServeConfig(target="cpu", admit_policy="slo"),
                        device="cpu")
    out = eng.run([
        Request(rid=0, prompt=rng.integers(1, 100, 5).astype(np.int32),
                max_new=4),
        Request(rid=1, prompt=rng.integers(1, 100, 5).astype(np.int32),
                max_new=200, deadline_s=100.0, arrival_step=2),
        Request(rid=2, prompt=rng.integers(1, 100, 5).astype(np.int32),
                max_new=4, deadline_s=100.0, arrival_step=2)])
    assert [r.done for r in out] == [True, False, True]
    assert eng.last_stats["slo_shed"] == 1
    assert eng.last_stats["step_p50"] == 1.0


def test_step_window_matches_straggler_watchdog():
    """The same durations into the port's watchdog and the reference's
    give equal p50 and p95, before, at and past 256 steps, and flag the
    same steps."""
    rng = np.random.default_rng(0)
    durations = rng.lognormal(-4.0, 0.6, 1000).tolist()
    win, wd = fault_mod.StragglerWatchdog(), StragglerWatchdog()
    assert win.p50 == wd.p50 == 0.0 and win.p95 == wd.p95 == 0.0
    for i, d in enumerate(durations, 1):
        assert win.observe(i, d) == wd.observe(i, d)
        if i in (1, 10, 255, 256, 257, 400, 1000):
            assert win.p50 == wd.p50 and win.p95 == wd.p95, i
    assert win.flagged == wd.flagged
    assert win.p50 != float(np.median(durations))


def test_engine_step_stats_come_from_the_last_256_steps(pair, monkeypatch):
    """One request decoding 299 steps: ``last_stats``' step p50 and p95
    are the watchdog's over the last 256 observed steps, not over all."""
    durations = [1e-3 * (i + 1) for i in range(1000)]
    seen = _synthetic_steps(monkeypatch, durations)
    _, _, tm = pair
    eng = ServingEngine(tm, batch=1, max_len=320,
                        cfg=ServeConfig(target="cpu"), device="cpu")
    prompt = np.random.default_rng(9).integers(1, 100, 5).astype(np.int32)
    out = eng.run([Request(rid=0, prompt=prompt, max_new=300)],
                  max_steps=400)
    st = eng.last_stats
    assert out[0].done and st["decode_steps"] == len(seen) == 299
    wd = StragglerWatchdog()
    for i, d in enumerate(seen):
        wd.observe(i, d)
    assert st["step_p50"] == wd.p50 and st["step_p95"] == wd.p95
    assert st["step_p50"] != float(np.median(seen))
