"""The graph cache's policy (``repro_torch.core.graphs``) on the CPU, with
the CUDA capture and replay stubbed by a fake that records its calls, and
the pointer stability of the three decode paths that the cache relies on.

A CUDA graph records a program's kernels at capture and replays them on
the same addresses; the fake stands in for it faithfully enough to test
what the policy decides: its "capture" runs the program once (as a
capture runs the Python) and undoes its writes to the inputs (as a
capture runs nothing on the device), and its "replay" runs it again over the
captured buffers without counting, writing the results into the captured
outputs, as a replay writes the graph's pool.  The capture rule itself is
checked on full-width graphs built from meta tensors (nothing runs).
"""
import collections
import dataclasses
import weakref

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, get_smoke
from repro_torch.core import graphs, tapir
from repro_torch.core.passes import run_pipeline
from repro_torch.core.schedule import (H100_COST_MODEL, dispatch_bound,
                                       lowered_ops, region_roofline_s)
from repro_torch.models import rwkv, transformer
from repro_torch.models.base import get_model
from repro_torch.serve import Request, ServeConfig, ServingEngine

CPU = ServeConfig(target="cpu")


class Counter:
    """A kernel wrapper's launch counts."""

    def __init__(self):
        self.launches = 0
        self.launches_by_shape = collections.Counter()


class FakeGraphs:
    """Records ``capture`` / ``replay`` calls; see the module docstring."""

    pool_bytes = 0

    def __init__(self, counters=()):
        self.calls = []
        self.counters = counters

    def accepts(self, vals):
        return True

    def capture(self, fn, inputs, device):
        self.calls.append("capture")
        # the Python runs, the device does not: undo the program's writes
        saved = [v.clone() for v in inputs.values()]
        outs = fn(inputs)
        for v, s in zip(inputs.values(), saved):
            v.copy_(s)
        # a graph holds addresses, not tensors: hold each input's base
        # weakly, and where the input lies in it; of the outputs, hold only
        # those the graph's pool owns (an input it writes is written in
        # place by the replay)
        refs = {k: (weakref.ref(graphs._base(v)), v.storage_offset(),
                    tuple(v.shape), v.stride())
                for k, v in inputs.items()}
        ins = {id(v) for v in inputs.values()}
        pool = [None if id(o) in ins else o for o in outs]
        return (fn, refs, pool), outs

    def release(self, handle):
        self.calls.append("release")

    def replay(self, handle):
        self.calls.append("replay")
        fn, refs, outs = handle
        saved = [(c.launches, collections.Counter(c.launches_by_shape))
                 for c in self.counters]
        new = fn({k: torch.as_strided(r(), shape, stride, off)
                  for k, (r, off, shape, stride) in refs.items()})
        for c, (n, by) in zip(self.counters, saved):
            c.launches, c.launches_by_shape = n, by
        for o, n in zip(outs, new):
            if o is not None:
                o.copy_(n)


@pytest.fixture
def counter():
    return Counter()


@pytest.fixture
def cache(counter):
    fake = FakeGraphs((counter,))
    return graphs.GraphCache(backend=fake, counters=(counter,)), fake


def _program(counter, calls):
    """A toy region program: y = x @ w + 1, z = x * 2, and ``acc`` += 1
    in place (``acc`` stands for the cache a decode block writes; a
    program that writes no input is never captured); ``counter`` counts
    one "launch" per run, as a kernel wrapper would."""
    def fn(inputs):
        calls.append(1)
        counter.launches += 1
        counter.launches_by_shape[("mm", tuple(inputs["x"].shape))] += 1
        x, w, acc = inputs["x"], inputs["w"], inputs["acc"]
        acc.add_(1)
        return (x @ w + 1, x * 2, acc)
    return fn


WRITES = frozenset({"acc"})


def _call(gc, fn, x, w, acc, capture=True):
    return gc.run("k", fn, {"x": x, "w": w, "acc": acc}, capture=capture,
                  written=WRITES)


def test_first_sighting_eager_second_captures_later_replay(cache, counter):
    gc, fake = cache
    calls = []
    fn = _program(counter, calls)
    w, acc = torch.randn(3, 4), torch.zeros(())
    for step in range(4):
        x = torch.randn(2, 3)
        y, z, a = _call(gc, fn, x, w, acc)
        torch.testing.assert_close(y, x @ w + 1, rtol=0, atol=0)
        torch.testing.assert_close(z, x * 2, rtol=0, atol=0)
        # the written input comes back as the caller's tensor, written once
        assert a is acc and float(acc) == step + 1
    # eager, capture + its replay, replay, replay
    assert fake.calls == ["capture", "replay", "replay", "replay"]
    assert gc.stats["eager"] == 1 and gc.stats["captures"] == 1
    assert gc.stats["replays"] == 3
    assert gc.summary()["graphs"] == 1


def test_no_capture_where_the_rule_says_eager(cache, counter):
    gc, fake = cache
    fn = _program(counter, [])
    w, acc = torch.randn(3, 4), torch.zeros(())
    for _ in range(3):
        _call(gc, fn, torch.randn(2, 3), w, acc, capture=False)
    assert fake.calls == [] and gc.summary()["graphs"] == 0


def test_a_program_that_writes_no_input_runs_eagerly(cache, counter):
    """A graph is keyed by the cache it writes and dies with it; a program
    that writes nothing would be keyed by its weights alone and outlive
    every run, so it is not captured."""
    gc, fake = cache
    fn = _program(counter, [])
    w = torch.randn(3, 4)
    for _ in range(3):
        x = torch.randn(2, 3)
        y, _, _ = gc.run("k", fn, {"x": x, "w": w, "acc": torch.zeros(())},
                         capture=True)
        torch.testing.assert_close(y, x @ w + 1, rtol=0, atol=0)
    assert fake.calls == [] and gc.summary()["graphs"] == 0


def test_persistent_and_transient_inputs_are_sorted(cache, counter):
    gc, _ = cache
    fn = _program(counter, [])
    w, acc = torch.randn(3, 4), torch.zeros(())
    for _ in range(2):
        _call(gc, fn, torch.randn(2, 3), w, acc)
    (g,) = gc.graphs()
    # x (a fresh tensor each call) has a static buffer; w and acc are read
    # in place
    assert g.static[0] is not None and tuple(g.static[0].shape) == (2, 3)
    assert g.static[1] is None and g.static[2] is None
    ((mask, table),) = gc._graphs["k"].items()
    assert mask == (1, 2)
    assert list(table) == [(graphs._view(w), graphs._view(acc))]


def test_another_live_tensor_is_another_call_site(cache, counter):
    """Two layers share one program: each layer's weight and cache slab
    stay alive, so layer 1's first call does not match layer 0's
    sighting."""
    gc, fake = cache
    fn = _program(counter, [])
    ws = [torch.randn(3, 4), torch.randn(3, 4)]
    accs = [torch.zeros(()), torch.zeros(())]
    for step in range(3):
        for w, acc in zip(ws, accs):
            x = torch.randn(2, 3)
            y, _, _ = _call(gc, fn, x, w, acc)
            torch.testing.assert_close(y, x @ w + 1, rtol=0, atol=0)
        if step == 0:
            assert fake.calls == []
    assert fake.calls.count("capture") == 2
    assert gc.summary()["graphs"] == 2
    assert [float(a) for a in accs] == [3.0, 3.0]


def test_changed_persistent_address_captures_anew_and_dead_input_evicts(
        cache, counter):
    gc, fake = cache
    fn = _program(counter, [])
    w1, acc = torch.randn(3, 4), torch.zeros(())
    for _ in range(3):
        _call(gc, fn, torch.randn(2, 3), w1, acc)
    w2 = torch.randn(3, 4)
    for _ in range(3):
        x = torch.randn(2, 3)
        y, _, _ = _call(gc, fn, x, w2, acc)
        torch.testing.assert_close(y, x @ w2 + 1, rtol=0, atol=0)
    assert fake.calls.count("capture") == 2
    assert gc.summary()["graphs"] == 2
    del w1
    assert gc.summary()["graphs"] == 1 and gc.stats["evictions"] == 1
    assert fake.calls.count("release") == 1
    gc.clear()
    assert gc.summary()["graphs"] == 0
    assert fake.calls.count("release") == 2


def test_written_input_must_be_the_same_tensor(cache, counter):
    """A program that writes an input in place (a donated pool) matches
    an earlier sighting only where that input is the same tensor: a
    new pool (a new serving run) is another cache."""
    gc, fake = cache

    def fn(inputs):
        inputs["pool"][0] += inputs["x"]
        return (inputs["pool"], inputs["x"] * 3)

    pool = torch.zeros(2, 3)
    x = torch.ones(3)
    for _ in range(3):
        out, _ = gc.run("k", fn, {"pool": pool, "x": x.clone()},
                        capture=True, written=frozenset({"pool"}))
        assert out is pool
    assert fake.calls.count("capture") == 1
    assert torch.equal(pool[0], torch.full((3,), 3.0))
    del pool
    pool2 = torch.zeros(2, 3)
    gc.run("k", fn, {"pool": pool2, "x": x.clone()}, capture=True,
           written=frozenset({"pool"}))
    assert fake.calls.count("capture") == 1    # eager: a first sighting


def test_non_donated_outputs_are_fresh_across_replays(cache, counter):
    gc, _ = cache
    fn = _program(counter, [])
    w, acc = torch.randn(3, 4), torch.zeros(())
    xs = [torch.randn(2, 3) for _ in range(4)]
    outs = [_call(gc, fn, x.clone(), w, acc) for x in xs]
    for x, (y, z, _) in zip(xs, outs):
        torch.testing.assert_close(y, x @ w + 1, rtol=0, atol=0)
        torch.testing.assert_close(z, x * 2, rtol=0, atol=0)
    ptrs = [t.data_ptr() for y, z, _ in outs for t in (y, z)]
    assert len(set(ptrs)) == len(ptrs)


def test_launch_counts_are_added_once_per_replay(cache, counter):
    gc, _ = cache
    calls = []
    fn = _program(counter, calls)
    w, acc = torch.randn(3, 4), torch.zeros(())
    for step in range(5):
        _call(gc, fn, torch.randn(2, 3), w, acc)
        # one launch per step, as the eager walk counts them
        assert counter.launches == step + 1
        assert counter.launches_by_shape[("mm", (2, 3))] == step + 1
    # the Python ran at the eager call, the capture and (in the fake
    # only) each replay; the counts came from the eager call, the capture
    # and the cache's additions
    assert len(calls) == 1 + 1 + 4


def _meta(shape, dt=torch.bfloat16):
    return torch.empty(shape, dtype=dt, device="meta")


def _scheduled(fn, *args):
    with tapir.use(tapir.TapirConfig(cost_model=H100_COST_MODEL)):
        g = tapir.capture_region(fn, *args)
    return run_pipeline(g, "tapir", H100_COST_MODEL)


def _bare(cls, cfg):
    m = cls.__new__(cls)
    torch.nn.Module.__init__(m)
    m.cfg = cfg
    return m


def test_capture_rule_picks_decode_blocks_and_rejects_forward_blocks():
    """A pure function of the scheduled graph and the cost model: at full
    width, qwen2.5-3b's slot decode block (4 slots) and RWKV6-7B's
    stateful decode block (4 rows) are dispatch-bound; their 2 x 2048
    forward blocks are not."""
    cfg = get_config("qwen2_5_3b")
    m = _bare(transformer.DenseLM, cfg)
    d, hd, hkv = cfg.d_model, cfg.hd, cfg.n_kv_heads
    p = {k: _meta(s.shape[1:])
         for k, s in transformer._block_specs(cfg, 1).items()}
    rope = _meta((512, hd // 2), torch.float32)
    pool = _meta((65, 64, hkv, hd))
    slot = _scheduled(m._slot_block_body, p, _meta((4, 1, d)), rope, rope,
                      pool, pool, _meta((4,), torch.int32),
                      _meta((4, 8), torch.int32))
    rope = _meta((2048, hd // 2), torch.float32)
    fwd = _scheduled(m._block_body, p, _meta((2, 2048, d)), rope, rope)
    assert dispatch_bound(slot, H100_COST_MODEL)
    assert not dispatch_bound(fwd, H100_COST_MODEL)
    assert region_roofline_s(fwd, H100_COST_MODEL) > \
        10 * region_roofline_s(slot, H100_COST_MODEL)
    assert lowered_ops(slot) > lowered_ops(fwd)

    rc = get_config("rwkv6_7b")
    r = _bare(rwkv.RWKV6, rc)
    p = {k: _meta(s.shape[1:])
         for k, s in rwkv._rwkv_block_specs(rc, 1).items()}
    d, h, hd = rc.d_model, rc.n_heads, rc.hd
    row = _meta((4, 1, d))
    step = _scheduled(r._stateful_block_body, p, _meta((4, 1, d)), row, row,
                      _meta((4, h, hd, hd), torch.float32))
    fwd = _scheduled(r._block_body, p, _meta((2, 2048, d)))
    assert dispatch_bound(step, H100_COST_MODEL)
    assert not dispatch_bound(fwd, H100_COST_MODEL)


# -- through tapir: the SMOKE decode paths with the fake ---------------------


@pytest.fixture
def fake_graphs(monkeypatch):
    """The process's graph cache on the fake backend, with every region
    program judged dispatch-bound (the SMOKE shapes are tiny, and the
    CPU cost model is not the card's)."""
    fake = FakeGraphs()
    gc = graphs.GraphCache(backend=fake)
    monkeypatch.setattr(graphs, "CACHE", gc)
    monkeypatch.setattr(tapir, "dispatch_bound", lambda g, cm: True)
    tapir.clear_cache()
    yield gc, fake
    tapir.clear_cache()


@pytest.fixture(scope="module")
def qwen():
    return get_model(get_smoke("qwen2_5_3b"), device="cpu",
                     generator=torch.Generator().manual_seed(0))


@pytest.fixture(scope="module")
def rwkv6():
    return get_model(get_smoke("rwkv6_7b"), device="cpu",
                     generator=torch.Generator().manual_seed(0))


def _steps(model, path: str, n: int, after_prefill=lambda: None):
    """Logits of ``n`` decode steps on ``path`` after a prefill."""
    rng = np.random.default_rng(0)
    toks = torch.as_tensor(rng.integers(1, model.cfg.vocab, (2, 40)),
                           dtype=torch.int32)
    out = []
    with tapir.use(CPU.tapir_config()):
        if path == "slot":
            sp = model.compute_params()
            cache = model.init_slot_cache(2, 32, page_len=8)
            for s, n_tok in ((0, 8), (1, 5)):
                padded = torch.zeros((1, 8), dtype=torch.int32)
                padded[0, :n_tok] = toks[s, :n_tok]
                _, cache = model.prefill_into_slot(sp, padded, cache, s,
                                                   n_tok)
            after_prefill()
            for t in range(n):
                lg, cache = model.decode_step_slots(
                    sp, toks[:, 8 + t:9 + t].contiguous(), cache)
                out.append(lg)
        else:
            cache = model.init_cache(2, 32)
            _, cache = model.prefill(toks[:, :8], cache)
            after_prefill()
            for t in range(n):
                lg, cache = model.decode_step(toks[:, 8 + t:9 + t], cache)
                out.append(lg)
    return out, cache


@pytest.mark.parametrize("path", ["slot", "padded", "rwkv"])
def test_graphed_decode_equals_the_eager_walk(path, fake_graphs, qwen,
                                              rwkv6, monkeypatch):
    """Over 5 steps the graphed decode gives the eager walk's logits
    bitwise; steps 1 and 2 capture one graph per block (the head writes no
    input and stays eager), later steps capture nothing and replay one
    graph per block."""
    gc, fake = fake_graphs
    model = rwkv6 if path == "rwkv" else qwen
    per_step = model.cfg.n_layers + 1           # region calls a step
    blocks = model.cfg.n_layers
    captures, replays = [], []
    run_program = tapir._run_program

    def counted(key, fn, inputs):
        c, r = gc.stats["captures"], gc.stats["replays"]
        out = run_program(key, fn, inputs)
        captures.append(gc.stats["captures"] - c)
        replays.append(gc.stats["replays"] - r)
        return out

    monkeypatch.setattr(tapir, "_run_program", counted)
    got, cache = _steps(model, path, 5)
    regions = len(captures) - 5 * per_step      # the prefill's calls
    steps = [(sum(captures[regions + i * per_step:
                           regions + (i + 1) * per_step]),
              sum(replays[regions + i * per_step:
                          regions + (i + 1) * per_step])) for i in range(5)]
    assert steps[0][0] + steps[1][0] == blocks
    assert steps[2:] == [(0, blocks)] * 3
    monkeypatch.setattr(tapir, "_run_program", run_program)
    monkeypatch.setattr(tapir, "dispatch_bound", lambda g, cm: False)
    tapir.clear_cache()
    want, _ = _steps(model, path, 5)
    assert gc.summary()["graphs"] == 0
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert int(cache["pos"].max()) == 13


@pytest.mark.parametrize("path", ["slot", "padded", "rwkv"])
def test_decode_inputs_are_pointer_stable(path, fake_graphs, qwen, rwkv6):
    """Every block call of a decode step binds the same tensors as the
    step before, the activation alone excepted: each captured graph has
    exactly one transient input."""
    gc, _ = fake_graphs
    model = rwkv6 if path == "rwkv" else qwen
    before = []
    _, cache = _steps(model, path, 3,
                      after_prefill=lambda: before.extend(
                          map(id, gc.graphs())))
    decode = [g for g in gc.graphs() if id(g) not in before]
    assert len(decode) == model.cfg.n_layers
    for g in decode:
        assert sum(s is not None for s in g.static) == 1
    # a finished run's cache takes every graph with it
    del cache, decode
    assert gc.summary()["graphs"] == 0


def test_slot_serving_captures_nothing_after_warm_up(fake_graphs, qwen,
                                                     monkeypatch):
    """Through admissions and releases the page table is updated in place:
    after the first decode steps, no decode step captures a graph; and
    the graphed run's tokens equal the eager run's."""
    gc, fake = fake_graphs
    rng = np.random.default_rng(1)
    reqs = [Request(rid=i, prompt=rng.integers(1, qwen.cfg.vocab, n)
                    .astype(np.int32), max_new=m)
            for i, (n, m) in enumerate([(5, 6), (9, 3), (7, 8), (4, 5),
                                        (6, 2), (8, 7)])]
    eng = ServingEngine(qwen, batch=2, max_len=32, cfg=CPU, device="cpu")
    step_captures = []
    decode = qwen.decode_step_slots

    def counted(sp, tokens, cache):
        c = gc.stats["captures"]
        out = decode(sp, tokens, cache)
        step_captures.append(gc.stats["captures"] - c)
        return out

    monkeypatch.setattr(qwen, "decode_step_slots", counted)
    out = eng.run([dataclasses.replace(r, out=[]) for r in reqs])
    got = [r.out for r in out]
    monkeypatch.undo()
    assert eng.last_stats["admitted"] == len(reqs) > eng.slots
    assert step_captures[1] == qwen.cfg.n_layers
    assert sum(step_captures[2:]) == 0
    assert fake.calls.count("replay") > 10 * qwen.cfg.n_layers
    tapir.clear_cache()
    eager = ServingEngine(qwen, batch=2, max_len=32, cfg=CPU, device="cpu")
    want = [r.out for r in eager.run([dataclasses.replace(r, out=[])
                                      for r in reqs])]
    assert got == want


@pytest.mark.parametrize("arch", ["qwen", "rwkv"])
def test_finished_runs_leave_no_graphs_behind(arch, fake_graphs, qwen,
                                              rwkv6):
    """Serving runs with ragged prompt lengths, some shapes seen in two
    runs: every graph is keyed by the run's cache (pools, state slabs) and
    goes with it, so none outlives its run, and each run captures its
    decode blocks anew."""
    gc, _ = fake_graphs
    model = rwkv6 if arch == "rwkv" else qwen
    rng = np.random.default_rng(2)
    eng = ServingEngine(model, batch=2, max_len=32, cfg=CPU, device="cpu")
    for lens in ((5, 9, 7), (5, 9, 7), (6, 11, 4)):
        reqs = [Request(rid=i, prompt=rng.integers(1, model.cfg.vocab, n)
                        .astype(np.int32), max_new=4)
                for i, n in enumerate(lens)]
        c = gc.stats["captures"]
        eng.run(reqs)
        assert gc.stats["captures"] - c >= model.cfg.n_layers
        assert gc.summary()["graphs"] == 0


def test_compute_params_follow_an_in_place_weight_update():
    """The kept compute-dtype cast is the same tensors step after step, and
    is made anew once a weight is updated in place: the padded decode step
    then gives a fresh model's logits on the updated weights, bitwise."""
    cfg = get_smoke("qwen2_5_3b")
    m = get_model(cfg, device="cpu",
                  generator=torch.Generator().manual_seed(0))
    toks = torch.as_tensor(np.random.default_rng(3).integers(
        1, cfg.vocab, (2, 9)), dtype=torch.int32)

    def decode(model):
        with tapir.use(CPU.tapir_config()):
            cache = model.init_cache(2, 16)
            _, cache = model.prefill(toks[:, :8], cache)
            return model.decode_step(toks[:, 8:], cache)[0]

    first = decode(m)
    cp = m.compute_params()
    assert m.compute_params() is cp
    with torch.no_grad():
        m.blocks["wd"].mul_(0.5)
        m.lm_head.add_(0.01)
    assert m.compute_params() is not cp
    got = decode(m)
    fresh = get_model(cfg, device="cpu", params={
        "embed": m.embed.data, "ln_f": m.ln_f.data,
        "lm_head": m.lm_head.data.clone(),
        "blocks": {k: v.data.clone() for k, v in m.blocks.items()}})
    assert torch.equal(got, decode(fresh))
    assert not torch.equal(got, first)
