"""The port's slot-paged serving path against the JAX package's, and the
port's own bitwise guarantees, at the SMOKE shapes of qwen2.5-3b (2 layers,
d_model 96) on the CPU.

The weights are the reference's ``init_params(PRNGKey(0))`` carried across
as numpy (``params_from_numpy``).  Parity with the reference runs at
``compute_dtype="float32"``, where the point is the algorithm: logits agree
to rtol/atol 1e-4 (GEMMs and attention sum in other orders) and greedy
token streams agree exactly.  The port-internal guarantees (continuous =
wave, prefix sharing = baseline, regions = per-op) are bitwise at the
config's own bf16 compute dtype.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as RC
from repro.core import tapir as jtapir
from repro.models.base import get_model as j_get_model
from repro.serve import Request as JRequest
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServingEngine as JServingEngine
from repro_torch.configs import get_smoke
from repro_torch.core import tapir
from repro_torch.launch import serve as serve_cli
from repro_torch.models.base import get_model
from repro_torch.models.convert import params_from_numpy
from repro_torch.serve import Request, ServeConfig, ServingEngine

LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
CPU = ServeConfig(target="cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny CPU tensors: one intra-op thread per test process, so parallel
    test workers do not oversubscribe the cores (bitwise comparisons stay
    within one process)."""
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


@pytest.fixture(scope="module")
def bf16_model():
    return get_model(get_smoke("qwen2_5_3b"), device="cpu")


def _prompts(seed, lens, vocab=500, prefix=None):
    rng = np.random.default_rng(seed)
    out = []
    for n in lens:
        p = rng.integers(1, vocab, size=n).astype(np.int32)
        if prefix is not None:
            p = np.concatenate([prefix, p])
        out.append(p)
    return out


def _reqs(cls, prompts, news, **kw):
    extra = kw.pop("extra", [{}] * len(prompts))
    return [cls(rid=i, prompt=p.copy(), max_new=m, **e, **kw)
            for i, (p, m, e) in enumerate(zip(prompts, news, extra))]


def test_params_carry_across_exactly(pair):
    jm, jp, tm = pair
    np.testing.assert_array_equal(tm.embed.numpy(), np.asarray(jp["embed"]))
    for k, v in jp["blocks"].items():
        np.testing.assert_array_equal(tm.blocks[k].numpy(), np.asarray(v))
    assert tm.blocks["wq"].shape == (2, 96, 96)
    assert tm.blocks["bk"].shape == (2, 48)


def test_slot_prefill_and_decode_logits_match_reference(pair):
    jm, jp, tm = pair
    slots, max_len, pl = 2, 32, 8
    prompt = _prompts(0, [6])[0]
    padded = np.zeros((1, 8), np.int32)
    padded[0, :6] = prompt
    with jtapir.use(JServeConfig(target="cpu").tapir_config()):
        jsp = jm.slot_params(jp)
        jc = jm.init_slot_cache(slots, max_len, page_len=pl)
        jl, jc = jm.prefill_into_slot(jsp, jnp.asarray(padded), jc, 1, 6)
        jlogits = [np.asarray(jl)]
        tok = np.asarray([[3], [int(np.argmax(jlogits[0][0]))]], np.int32)
        for _ in range(4):
            jl, jc = jm.decode_step_slots(jsp, jnp.asarray(tok), jc)
            jlogits.append(np.asarray(jl))
            tok = np.argmax(jlogits[-1], -1).astype(np.int32)[:, None]
    with tapir.use(CPU.tapir_config()):
        tsp = tm.compute_params()
        tc = tm.init_slot_cache(slots, max_len, page_len=pl)
        tl, tc = tm.prefill_into_slot(tsp, torch.as_tensor(padded), tc, 1, 6)
        tlogits = [tl.numpy()]
        tok = np.asarray([[3], [int(np.argmax(jlogits[0][0]))]], np.int32)
        for i in range(4):
            tl, tc = tm.decode_step_slots(tsp, torch.as_tensor(tok), tc)
            tlogits.append(tl.numpy())
            tok = np.argmax(jlogits[i + 1], -1).astype(np.int32)[:, None]
    assert [t.shape for t in tlogits] == [(1, 512)] + [(2, 512)] * 4
    for a, b in zip(tlogits, jlogits):
        np.testing.assert_allclose(a, b, **LOGIT_TOL)
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
    for a, b in zip(tc["k"], jc["k"]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **LOGIT_TOL)


def test_engine_streams_and_stats_match_reference(pair):
    """Continuous batching over 2 slots, 6 requests of which 3 share a
    16-token prefix (page_len 8): the same greedy tokens per request, and
    the same scheduling counts."""
    jm, jp, tm = pair
    prefix = _prompts(9, [16])[0]
    prompts = _prompts(1, [6, 3, 7]) + _prompts(2, [2, 5, 1], prefix=prefix)
    news = [7, 2, 5, 9, 3, 6]
    kw = dict(batch=2, max_len=32)
    je = JServingEngine(jm, jp, cfg=JServeConfig(target="cpu", page_len=8),
                        **kw)
    jout = je.run(_reqs(JRequest, prompts, news))
    te = ServingEngine(tm, cfg=ServeConfig(target="cpu", page_len=8),
                       device="cpu", **kw)
    tout = te.run(_reqs(Request, prompts, news))
    assert [r.out for r in tout] == [r.out for r in jout]
    assert all(r.done for r in tout)
    for key in ("tokens", "decode_steps", "admitted", "prefix_hits",
                "prefix_tokens_saved", "mean_occupancy"):
        assert te.last_stats[key] == je.last_stats[key], key
    assert te.last_stats["prefix_hits"] == 2


def test_free_slot_runs_past_max_len_like_reference(pair):
    """Free slots keep advancing ``pos``: here slot 1 stays free for 85
    decode steps of a 64-position slot, so its RoPE-row and page-table
    gathers go past their bounds (clamped) while every request runs
    through slot 0.  Torch would raise on the CPU and device-assert on the
    card; the port must instead match the reference token for token."""
    jm, jp, tm = pair
    prompts = _prompts(3, [6, 5, 4])
    news = [34, 34, 20]
    extra = [{"arrival_step": 0}, {"arrival_step": 40},
             {"arrival_step": 80}]
    kw = dict(batch=2, max_len=64)
    je = JServingEngine(jm, jp, cfg=JServeConfig(target="cpu"), **kw)
    jout = je.run(_reqs(JRequest, prompts, news, extra=extra))
    te = ServingEngine(tm, cfg=CPU, device="cpu", **kw)
    tout = te.run(_reqs(Request, prompts, news, extra=extra))
    assert te.last_stats["decode_steps"] == 33 + 33 + 19 > 64
    assert te.last_stats["mean_occupancy"] == 0.5     # slot 1 never used
    assert [r.out for r in tout] == [r.out for r in jout]
    assert all(r.done for r in tout)


def test_opaque_mode_runs_every_gemm_through_the_kernel_wrapper(
        pair, monkeypatch):
    """The per-op control (``mode="opaque"``: sealed library calls, no
    fusion) emits the reference's greedy tokens in its own opaque mode, and
    every one of its GEMMs goes through ``fused_matmul``, unfused: per
    decode step 7 per layer (q, k, v, wo, gate, up, down) and the head."""
    jm, jp, tm = pair
    prompts = _prompts(4, [6, 3, 7])
    news = [5, 4, 6]
    kw = dict(batch=2, max_len=32)
    je = JServingEngine(jm, jp, cfg=JServeConfig(target="cpu", mode="opaque"),
                        **kw)
    jout = je.run(_reqs(JRequest, prompts, news))
    from repro_torch.kernels.fused_matmul import ops as fm_ops
    calls = []
    real = fm_ops.fused_matmul

    def counted(x, w, epilogue=None, **k):
        calls.append((tuple(x.shape[:-1]), len(epilogue or ())))
        return real(x, w, epilogue=epilogue, **k)

    monkeypatch.setattr(fm_ops, "fused_matmul", counted)
    te = ServingEngine(tm, cfg=ServeConfig(target="cpu", mode="opaque"),
                       device="cpu", **kw)
    tout = te.run(_reqs(Request, prompts, news))
    assert [r.out for r in tout] == [r.out for r in jout]
    decode = [c for c in calls if c[0] == (2, 1)]
    assert len(decode) == (7 * tm.cfg.n_layers + 1) \
        * te.last_stats["decode_steps"]
    assert all(n_epi == 0 for _, n_epi in calls)
    impls = {n.schedule.impl for key, g in tapir.cached_graphs().items()
             if key[-3] == "opaque"
             for n in g.nodes.values() if n.op == "matmul"}
    assert impls == {"opaque"}


def _shared_prefix_workload(vocab):
    prefix = _prompts(5, [16], vocab=vocab)[0]
    prompts = (_prompts(6, [3, 9], vocab=vocab)
               + _prompts(7, [1, 4, 0, 8], vocab=vocab, prefix=prefix))
    return prompts, [5, 8, 4, 6, 3, 7]


def test_port_guarantees_are_bitwise(bf16_model):
    """At bf16: continuous == wave, prefix sharing == baseline, regions ==
    per-op, per request, token for token."""
    prompts, news = _shared_prefix_workload(bf16_model.cfg.vocab)
    kw = dict(batch=3, max_len=32, device="cpu")

    def run(wave=False, **cfg):
        eng = ServingEngine(bf16_model, cfg=ServeConfig(
            target="cpu", page_len=8, **cfg), **kw)
        reqs = _reqs(Request, prompts, news)
        out = eng.run_wave(reqs) if wave else eng.run(reqs)
        assert all(r.done for r in out)
        return [r.out for r in out], eng.last_stats

    base, st = run()
    assert st["prefix_hits"] >= 2 and st["prefix_tokens_saved"] >= 16
    assert run(wave=True)[0] == base
    assert run(prefix_sharing=False)[0] == base
    assert run(regions=False)[0] == base


def test_preemption_park_and_replay_are_bitwise(bf16_model):
    """A strictly higher-priority arrival evicts the lowest-priority slot;
    the victim, parked or replayed, finishes with the tokens it would have
    produced undisturbed."""
    prompts, news = _shared_prefix_workload(bf16_model.cfg.vocab)
    kw = dict(batch=2, max_len=32, device="cpu")
    base = ServingEngine(bf16_model, cfg=ServeConfig(target="cpu",
                                                     page_len=8), **kw)
    want = [r.out for r in base.run(_reqs(Request, prompts, news))]
    extra = [{"priority": 0}, {"priority": 0}, {"priority": 5,
                                                "arrival_step": 2},
             {"priority": 9, "arrival_step": 3}, {}, {}]
    for mode in ("park", "replay"):
        eng = ServingEngine(bf16_model, cfg=ServeConfig(
            target="cpu", page_len=8, preempt_mode=mode), **kw)
        out = eng.run(_reqs(Request, prompts, news, extra=extra))
        assert eng.last_stats["preemptions"] >= 1, mode
        assert eng.last_stats["parked" if mode == "park" else "replayed"] \
            >= 1
        assert [r.out for r in out] == want, mode


def test_pools_update_in_place_and_programs_replay(bf16_model):
    """Donation is an in-place write: each layer's pool keeps its object
    and storage across prefills and decode steps, through every
    ``_PROGRAMS`` replay; after the first step a decode step compiles
    nothing and hits the program cache once per block and head."""
    m = bf16_model
    with tapir.use(CPU.tapir_config()):
        sp = m.compute_params()
        cache = m.init_slot_cache(2, 32, page_len=8)
        pools = [(id(t), t.data_ptr()) for t in cache["k"] + cache["v"]]
        tok = torch.as_tensor(_prompts(8, [8])[0][None])
        _, cache = m.prefill_into_slot(sp, tok, cache, 0, 8)
        _, cache = m.prefill_into_slot(sp, tok, cache, 1, 5)
        feed = torch.ones((2, 1), dtype=torch.int32)
        _, cache = m.decode_step_slots(sp, feed, cache)
        before = tapir.cache_stats()
        for _ in range(3):
            _, cache = m.decode_step_slots(sp, feed, cache)
        after = tapir.cache_stats()
    assert [(id(t), t.data_ptr()) for t in cache["k"] + cache["v"]] == pools
    assert after["compiled_programs"] == before["compiled_programs"]
    assert after["hits"] - before["hits"] == 3 * (m.cfg.n_layers + 1)
    assert cache["pos"].tolist() == [12, 9]
    assert float(cache["k"][0].abs().sum()) > 0


def test_unported_serving_features_raise(bf16_model):
    # fault injection and slot checkpoints are ported
    # (tests/test_torch_fault.py): their fields construct and are checked
    # as the reference's are
    from repro_torch.dist import ScriptedFaultInjector
    scfg = ServeConfig(fault_injector=ScriptedFaultInjector({}),
                       ckpt_dir="ck", ckpt_every=4)
    assert (scfg.ckpt_dir, scfg.ckpt_every) == ("ck", 4)
    with pytest.raises(ValueError, match="shed_base"):
        ServeConfig(shed_base=-1)
    # the program cache is ported: it reaches the engine's tapir config
    tap = ServeConfig(program_cache_dir="pc", cache_mode="read").tapir_config()
    assert (tap.program_cache_dir, tap.cache_mode) == ("pc", "read")
    with pytest.raises(ValueError, match="cache_mode"):
        ServeConfig(cache_mode="sometimes")
    # meshes are ported (tests/test_torch_mesh_serving.py): a thing that
    # is not a launch.mesh.Mesh is refused
    with pytest.raises(TypeError, match="Mesh"):
        ServingEngine(bf16_model, batch=2, max_len=32, device="cpu",
                      mesh=object())
    with pytest.raises(ValueError, match="overflows"):
        ServingEngine(bf16_model, batch=1, max_len=16, cfg=CPU,
                      device="cpu").run([Request(0, np.ones(10, np.int32),
                                                 max_new=8)])


def test_launch_serve_reports_on_cpu(capsys):
    out = serve_cli.main(["--smoke", "--device", "cpu", "--requests", "3",
                          "--batch", "2", "--prompt-len", "70",
                          "--prefix-len", "64", "--max-new", "4",
                          "--max-len", "128"])
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rep["device"] == "cpu" and rep["requests"] == 3
    assert rep["new_tokens"] == 12 == sum(len(r.out) for r in out)
    assert rep["prefix_hits"] == 2
