"""The port's RWKV6 (``models/rwkv.py``: ``forward``, ``loss``, the
stateful ``prefill`` / ``decode_step``) and the engine's padded-wave loop
against the JAX package's, and the port's own guarantees, at the SMOKE
shapes of rwkv6-7b on the CPU.

The weights are the reference's ``init_params(PRNGKey(0))`` carried across
as numpy (``params_from_numpy``); tokens are made with numpy from a seed.
Tolerances:

* port vs reference at fp32 compute: rtol/atol 1e-4 on logits, loss and
  the token-shift rows (GEMMs and the scan sum in other orders); the WKV
  carry within 1e-4 of its largest entry (a small entry beside large ones
  carries their rounding: the carry's scale here is ~200);
* prefill and decode vs the full-sequence forward: rtol/atol 3e-3, the
  reference's own tolerance (``tests/test_serving.py``);
* inside the port (regions vs per-op): bitwise.
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
from repro.models import layers as JL
from repro.models.base import get_model as j_get_model
from repro.serve import Request as JRequest
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServingEngine as JServingEngine
from repro_torch.configs import ARCH_IDS, get_config, get_smoke
from repro_torch.core import tapir
from repro_torch.core.ir import LIBRARY_OPS
from repro_torch.core.passes import run_pipeline
from repro_torch.core.schedule import H100_COST_MODEL
from repro_torch.launch import serve as serve_cli
from repro_torch.models import layers as L
from repro_torch.models.base import get_model
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.rwkv import RWKV6
from repro_torch.serve import (Request, ServeConfig, ServingEngine,
                               make_decode_step, make_prefill_step)

REF_TOL = dict(rtol=1e-4, atol=1e-4)
SERVE_TOL = dict(rtol=3e-3, atol=3e-3)
CPU = ServeConfig(target="cpu")
B, S, NEW = 2, 21, 4


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
    """(reference model, its params, the port's model on the same weights)
    at fp32 compute."""
    jcfg = dataclasses.replace(RC.get_smoke("rwkv6_7b"),
                               compute_dtype="float32")
    jm = j_get_model(jcfg)
    jp = jm.init_params(jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, jp)
    tcfg = dataclasses.replace(get_smoke("rwkv6_7b"),
                               compute_dtype="float32")
    return jm, jp, params_from_numpy(tree, tcfg, device="cpu")


@pytest.fixture(scope="module")
def tokens():
    rng = np.random.default_rng(1)
    return rng.integers(1, 500, size=(B, S + NEW)).astype(np.int32)


@pytest.fixture(scope="module")
def full_logits(pair, tokens):
    """The port's full-sequence forward logits over every token."""
    with tapir.use(CPU.tapir_config()):
        return pair[2].forward({"tokens": torch.as_tensor(tokens)})


def test_config_and_params_carry_across(pair):
    jm, jp, tm = pair
    assert "rwkv6_7b" in ARCH_IDS
    full, jfull = get_config("rwkv6_7b"), RC.get_config("rwkv6_7b")
    for f in ("n_layers", "d_model", "n_heads", "d_ff", "vocab", "head_dim",
              "family", "param_dtype", "compute_dtype"):
        assert getattr(full, f) == getattr(jfull, f), f
    assert isinstance(tm, RWKV6) and not tm.supports_slots()
    np.testing.assert_array_equal(tm.embed.numpy(), np.asarray(jp["embed"]))
    assert set(tm.blocks) == set(jp["blocks"])
    for k, v in jp["blocks"].items():
        np.testing.assert_array_equal(tm.blocks[k].numpy(), np.asarray(v))
    assert tm.blocks["wA"].shape == (2, 64, 64)
    assert tm.blocks["u"].shape == (2, 4, 16)


def test_forward_matches_reference(pair, tokens, full_logits):
    jm, jp, _ = pair
    want = np.asarray(jm.forward(jp, {"tokens": jnp.asarray(tokens)}))
    assert full_logits.shape == (B, S + NEW, 512)
    np.testing.assert_allclose(full_logits.numpy(), want, **REF_TOL)


@pytest.mark.parametrize("masked", [False, True])
def test_loss_matches_reference(pair, tokens, masked):
    jm, jp, tm = pair
    rng = np.random.default_rng(2)
    labels = rng.integers(0, 512, size=tokens.shape).astype(np.int32)
    batch = {"tokens": tokens, "labels": labels}
    if masked:
        batch["mask"] = (rng.random(tokens.shape) < 0.6).astype(np.float32)
    want = float(jm.loss(jp, {k: jnp.asarray(v) for k, v in batch.items()}))
    with tapir.use(CPU.tapir_config()):
        got = tm.loss({k: torch.as_tensor(v) for k, v in batch.items()})
    assert got.dtype == torch.float32 and got.ndim == 0
    np.testing.assert_allclose(float(got), want, **REF_TOL)


def _ref_serve(jm, jp, tokens):
    with jtapir.use(JServeConfig(target="cpu").tapir_config()):
        cache = jm.init_cache(B, S + NEW)
        lg, cache = jm.prefill(jp, jnp.asarray(tokens[:, :S]), cache)
        out = [np.asarray(lg)]
        for t in range(NEW - 1):
            lg, cache = jm.decode_step(
                jp, jnp.asarray(tokens[:, S + t:S + t + 1]), cache)
            out.append(np.asarray(lg))
    return out, cache


def _port_serve(tm, tokens, cfg=CPU):
    with tapir.use(cfg.tapir_config()):
        cache = tm.init_cache(B, S + NEW)
        lg, cache = tm.prefill(torch.as_tensor(tokens[:, :S]), cache)
        out = [lg]
        for t in range(NEW - 1):
            lg, cache = tm.decode_step(
                torch.as_tensor(tokens[:, S + t:S + t + 1]), cache)
            out.append(lg)
    return out, cache


def test_prefill_and_decode_match_reference(pair, tokens):
    """Logits of every step and the whole carried state: the token-shift
    rows, the WKV carry and the position."""
    jm, jp, tm = pair
    want, jcache = _ref_serve(jm, jp, tokens)
    got, cache = _port_serve(tm, tokens)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.numpy(), w, **REF_TOL,
                                   err_msg=f"step {i}")
    assert int(cache["pos"]) == int(jcache["pos"]) == S + NEW - 1
    for key in ("tm_shift", "cm_shift"):
        np.testing.assert_allclose(cache[key].numpy(),
                                   np.asarray(jcache[key]), **REF_TOL,
                                   err_msg=key)
    wkv, jwkv = cache["wkv"].numpy(), np.asarray(jcache["wkv"])
    assert wkv.shape == jwkv.shape == (2, B, 4, 16, 16)
    assert np.abs(wkv - jwkv).max() <= 1e-4 * np.abs(jwkv).max()


def test_prefill_and_decode_match_full_forward(pair, tokens, full_logits):
    _, _, tm = pair
    got, _ = _port_serve(tm, tokens)
    for i, g in enumerate(got):
        np.testing.assert_allclose(g.numpy(), full_logits[:, S - 1 + i],
                                   **SERVE_TOL, err_msg=f"step {i}")


@pytest.mark.parametrize("regions", [True, False])
def test_serve_steps_update_the_state_in_place(pair, tokens, regions):
    """``make_prefill_step`` / ``make_decode_step`` write every layer's new
    state into its slab of the cache tensors (their ``data_ptr`` stays),
    regions or per-op alike, with the same logits."""
    _, _, tm = pair
    cfg = ServeConfig(target="cpu", regions=regions)
    prefill, decode = make_prefill_step(tm, cfg=cfg), make_decode_step(
        tm, cfg=cfg)
    cache = tm.init_cache(B, S + NEW)
    keys = ("tm_shift", "cm_shift", "wkv")
    ptrs = [cache[k].data_ptr() for k in keys]
    logits, cache = prefill(tokens[:, :S], cache)
    assert [cache[k].data_ptr() for k in keys] == ptrs
    assert all(bool((cache[k] != 0).any()) for k in keys)
    nxt, cache = decode(tokens[:, S:S + 1], cache)
    assert [cache[k].data_ptr() for k in keys] == ptrs
    assert int(cache["pos"]) == S + 1
    assert nxt.dtype == torch.int32 and nxt.shape == (B,)
    got, _ = _port_serve(tm, tokens)
    assert torch.equal(logits, got[0])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_region_forward_equals_per_op_bitwise(pair, tokens, dtype):
    """The reference ``_block``'s promise: one region program per block
    gives the per-op logits bitwise, and so does the stateful step."""
    _, _, tm = pair
    if dtype == "bfloat16":
        tm = get_model(get_smoke("rwkv6_7b"), device="cpu")
    batch = {"tokens": torch.as_tensor(tokens)}
    with tapir.use(tapir.TapirConfig()):
        region = tm.forward(batch)
    with tapir.use(tapir.TapirConfig(regions=False)):
        per_op = tm.forward(batch)
    assert region.dtype == getattr(torch, dtype)
    assert torch.equal(region, per_op)
    steps = [_port_serve(tm, tokens, ServeConfig(target="cpu",
                                                 regions=r))[0]
             for r in (True, False)]
    assert all(torch.equal(a, b) for a, b in zip(*steps))


def test_block_captures_as_one_region(pair):
    """The block (r/k/v/g projections, decay LoRA, WKV scan, groupnorm,
    channel mix) traces into ONE multi-library-op graph: ten GEMMs and one
    scan, which no fusion merges (every GEMM reads its own input)."""
    _, _, tm = pair
    p = {k: v[0] for k, v in tm.blocks.items()}
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (2, 8, 64)).astype(np.float32))
    with tapir.use(tapir.TapirConfig(cost_model=H100_COST_MODEL)):
        g = tapir.capture_region(tm._block_body, p, x)
    libs = [n.op for n in g.nodes.values() if n.op in LIBRARY_OPS]
    assert len(libs) >= 5 and libs.count("linear_scan") == 1
    run_pipeline(g, "tapir", H100_COST_MODEL)
    ops = [n.op for n in g.nodes.values() if n.op in LIBRARY_OPS]
    assert ops.count("matmul") == 10 and ops.count("linear_scan") == 1


def test_every_scan_binds_the_kernel_on_h100(pair, tokens):
    """At the H100 profile the registry's argmin for every scan node of the
    forward is ``kernel`` (CPU tensors run its plain version at the
    scheduled chunk); ``chunked`` and ``ref`` keep their costs; every
    matmul binds the GEMM kernel."""
    _, _, tm = pair
    tapir.clear_cache()
    with tapir.use(tapir.TapirConfig(cost_model=H100_COST_MODEL)):
        tm.forward({"tokens": torch.as_tensor(tokens)})
    nodes = [n for key, g in tapir.cached_graphs().items()
             if key[-2] == H100_COST_MODEL.name for n in g.nodes.values()]
    scans = [n for n in nodes if n.op == "linear_scan"]
    assert scans and {n.schedule.impl for n in scans} == {"kernel"}
    for n in scans:
        costs = n.schedule.impl_costs
        assert all(isinstance(costs[i], float) for i in ("chunked", "ref"))
        assert costs["kernel"] < min(costs["chunked"], costs["ref"])
        assert n.schedule.tile["chunk"] == 16 and n.attrs["variant"] == "rwkv6"
    assert {n.schedule.impl for n in nodes if n.op == "matmul"} == {
        "fused_kernel"}


def test_opaque_forward_matches_tapir(pair, tokens, full_logits):
    """The per-op control (sealed library calls, no fusion) runs every scan
    through the same wrapper at SAFE_CHUNK."""
    _, _, tm = pair
    with tapir.use(ServeConfig(target="cpu", mode="opaque").tapir_config()):
        got = tm.forward({"tokens": torch.as_tensor(tokens)})
    torch.testing.assert_close(got, full_logits, rtol=1e-5, atol=1e-5)


def _reqs(cls, lens, news, seed=3):
    rng = np.random.default_rng(seed)
    return [cls(rid=i, prompt=rng.integers(1, 500, size=n).astype(np.int32),
                max_new=m) for i, (n, m) in enumerate(zip(lens, news))]


def test_padded_wave_engine_matches_reference(pair):
    """``ServingEngine.run`` on a slot-less family takes the padded-wave
    loop (prompts left-padded to the wave's longest): request by request
    the tokens of the reference engine, and ``run`` equals ``run_wave``."""
    jm, jp, tm = pair
    lens, news = [5, 9, 7, 12, 3], [4, 6, 3, 5, 4]
    jeng = JServingEngine(jm, jp, batch=2, max_len=32,
                          cfg=JServeConfig(target="cpu"))
    want = jeng.run(_reqs(JRequest, lens, news))
    eng = ServingEngine(tm, batch=2, max_len=32, cfg=CPU, device="cpu")
    got = eng.run(_reqs(Request, lens, news))
    assert [r.out for r in got] == [r.out for r in want]
    assert all(r.done for r in got)
    st, jst = eng.last_stats, jeng.last_stats
    for k in ("tokens", "admitted", "rejected", "preempted", "decode_steps"):
        assert st[k] == jst[k], k
    np.testing.assert_allclose(st["mean_occupancy"], jst["mean_occupancy"])
    wave = eng.run_wave(_reqs(Request, lens, news))
    assert [r.out for r in wave] == [r.out for r in got]
    # a wave that hits max_steps leaves its unfinished members not done
    cut = eng.run(_reqs(Request, [4, 6], [9, 2]), max_steps=3)
    assert [len(r.out) for r in cut] == [3, 2]
    assert [r.done for r in cut] == [False, True]
    assert eng.last_stats["preempted"] == 1


def test_token_shift_and_groupnorm_match_reference():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 7, 4, 16)).astype(np.float32)
    scale = rng.standard_normal((4, 16)).astype(np.float32)
    np.testing.assert_allclose(
        L.groupnorm_heads(torch.from_numpy(x), torch.from_numpy(scale)),
        np.asarray(JL.groupnorm_heads(jnp.asarray(x), jnp.asarray(scale))),
        rtol=1e-5, atol=1e-5)
    xs = x.reshape(2, 7, 64)
    state = rng.standard_normal((2, 1, 64)).astype(np.float32)
    for st in (None, state):
        got = L.token_shift(torch.from_numpy(xs),
                            None if st is None else torch.from_numpy(st))
        want = JL.token_shift(jnp.asarray(xs),
                              None if st is None else jnp.asarray(st))
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_token_shift_zero_state_stays_inside_the_lifted_node():
    """Under capture the zero state is made inside the lifted function, so
    the region has no fresh-tensor input and replays from the program
    cache."""
    x = torch.ones(2, 5, 8)

    def body(x):
        return L.token_shift(x)[0] * 2.0

    g = tapir.capture_region(body, x)
    assert sum(n.op == "input" for n in g.nodes.values()) == 1
    fn = tapir.parallel_region(body, name="shift_replay")
    with tapir.use(CPU.tapir_config()):
        fn(x)
        before = tapir.cache_stats()["compiled_programs"]
        out = fn(torch.zeros(2, 5, 8))
    assert tapir.cache_stats()["compiled_programs"] == before
    assert torch.equal(out, torch.zeros(2, 5, 8))


def test_launch_serve_runs_rwkv_on_cpu(capsys):
    out = serve_cli.main(["--arch", "rwkv6_7b", "--smoke", "--device", "cpu",
                          "--requests", "3", "--batch", "2",
                          "--prompt-len", "6", "--max-new", "3"])
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rep["device"] == "cpu" and rep["requests"] == 3
    assert rep["new_tokens"] == 9 == sum(len(r.out) for r in out)
