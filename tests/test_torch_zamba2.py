"""The port's Zamba2 (``models/mamba.py``: ``forward``, ``loss``, the
stateful ``prefill`` / ``decode_step``), its pieces (``causal_conv1d``,
``_ssd_gates``) and the engine's padded-wave loop against the JAX
package's, and the port's own guarantees, at the SMOKE shapes of
zamba2-7b on the CPU (7 Mamba2 layers, the shared block after layers 3
and 6, one plain tail layer).

The weights are the reference's ``init_params(PRNGKey(0))`` carried across
as numpy (``params_from_numpy``); tokens are made with numpy from a seed.
Tolerances:

* port vs reference at fp32 compute: rtol/atol 1e-4 on logits, loss, the
  conv carry and the shared K/V caches (GEMMs and the scan sum in other
  orders); the SSM carry within 1e-4 of its largest entry (a small entry
  beside large ones carries their rounding); ``causal_conv1d`` bitwise and
  ``_ssd_gates`` within 1e-6 (elementwise, the same formulas);
* prefill and decode vs the JAX package's and vs the port's own
  full-sequence forward: rtol/atol 3e-3, the reference's own tolerance
  (``tests/test_serving.py``);
* the GLA scan at Mamba2's decay bound (log-decay down to -e^4 x
  softplus(dt) a step): the port's plain version against the reference's
  ``linear_scan_chunked`` at the same chunk, 16, within 1e-5 of the
  output's largest (parity; both clamp the same factors, and torch
  flushes fp32 subnormals there as XLA's CPU does); its distance to
  the sequential oracle is computed and reported, not bounded: it is the
  factored form's, shared with the reference;
* the opaque per-op control against tapir: rtol/atol 1e-5;
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
from repro.kernels.linear_scan import ops as j_ls_ops
from repro.models import layers as JL
from repro.models import mamba as JM
from repro.models.base import get_model as j_get_model
from repro.serve import Request as JRequest
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServingEngine as JServingEngine
from repro_torch.configs import ARCH_IDS, get_config, get_smoke
from repro_torch.core import tapir
from repro_torch.core.ir import LIBRARY_OPS
from repro_torch.core.passes import run_pipeline
from repro_torch.core.schedule import H100_COST_MODEL
from repro_torch.kernels.costs import SAFE_CHUNK
from repro_torch.kernels.fused_matmul import ops as fm_ops
from repro_torch.kernels.linear_scan import ref as ls_ref
from repro_torch.launch import serve as serve_cli
from repro_torch.models import layers as L
from repro_torch.models import mamba as M
from repro_torch.models.base import get_model
from repro_torch.models.convert import params_from_numpy
from repro_torch.serve import (Request, ServeConfig, ServingEngine,
                               make_decode_step, make_prefill_step)

REF_TOL = dict(rtol=1e-4, atol=1e-4)
SERVE_TOL = dict(rtol=3e-3, atol=3e-3)
CPU = ServeConfig(target="cpu")
B, S, NEW = 2, 21, 4
STATE_KEYS = ("conv", "ssm", "shared_k", "shared_v")


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
    jcfg = dataclasses.replace(RC.get_smoke("zamba2_7b"),
                               compute_dtype="float32")
    jm = j_get_model(jcfg)
    jp = jm.init_params(jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, jp)
    tcfg = dataclasses.replace(get_smoke("zamba2_7b"),
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
    assert "zamba2_7b" in ARCH_IDS
    full, jfull = get_config("zamba2_7b"), RC.get_config("zamba2_7b")
    for f in ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff",
              "vocab", "head_dim", "ssm_state", "ssm_head_dim",
              "ssm_expand", "shared_attn_every", "tie_embeddings",
              "family", "param_dtype", "compute_dtype"):
        for ours, theirs in ((full, jfull), (get_smoke("zamba2_7b"),
                                             RC.get_smoke("zamba2_7b"))):
            assert getattr(ours, f) == getattr(theirs, f), f
    assert full.n_params() == jfull.n_params()
    assert isinstance(tm, M.Zamba2) and not tm.supports_slots()
    assert tm.lm_head is None and tm.n_groups == 2
    np.testing.assert_array_equal(tm.embed.numpy(), np.asarray(jp["embed"]))
    for sub in ("blocks", "shared"):
        got = getattr(tm, sub)
        assert set(got) == set(jp[sub])
        for k, v in jp[sub].items():
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(v))
    assert tm.blocks["w_in"].shape == (7, 64, 2 * 128 + 2 * 16 + 8)
    assert tm.shared["wq"].shape == (64, 64)
    assert set(tm.param_tree()) == {"embed", "blocks", "ln_f", "shared"}


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv1d_matches_reference(with_state):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 7, 24)).astype(np.float32)
    w = rng.standard_normal((M.CONV_K, 24)).astype(np.float32)
    st = rng.standard_normal((2, M.CONV_K - 1, 24)).astype(np.float32) \
        if with_state else None
    got = L.causal_conv1d(torch.from_numpy(x), torch.from_numpy(w),
                          None if st is None else torch.from_numpy(st))
    want = JL.causal_conv1d(jnp.asarray(x), jnp.asarray(w),
                            None if st is None else jnp.asarray(st))
    for a, b in zip(got, want):
        assert a.shape == b.shape
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_causal_conv1d_zero_state_stays_inside_the_lifted_node():
    """Under capture the zero state is made inside the lifted functions, so
    the region has no fresh-tensor input and replays from the program
    cache."""
    x, w = torch.ones(2, 5, 8), torch.ones(M.CONV_K, 8)

    def body(x, w):
        y, st = L.causal_conv1d(x, w)
        return y * 2.0, st

    g = tapir.capture_region(body, x, w)
    assert sum(n.op == "input" for n in g.nodes.values()) == 2
    fn = tapir.parallel_region(body, name="conv_replay")
    with tapir.use(CPU.tapir_config()):
        fn(x, w)
        before = tapir.cache_stats()["compiled_programs"]
        y, st = fn(torch.zeros(2, 5, 8), w)
    assert tapir.cache_stats()["compiled_programs"] == before
    assert torch.equal(y, torch.zeros(2, 5, 8))
    assert st.shape == (2, M.CONV_K - 1, 8)


def test_ssd_gates_match_reference():
    rng = np.random.default_rng(5)
    din, N, H = 32, 8, 4
    xBC = rng.standard_normal((2, 6, din + 2 * N)).astype(np.float32)
    dt = (3.0 * rng.standard_normal((2, 6, H))).astype(np.float32)
    dt_bias = rng.standard_normal(H).astype(np.float32)
    A_log = np.array([-7.0, 0.0, 2.5, 5.0], np.float32)   # both clip ends
    got = M._ssd_gates(*(torch.from_numpy(a) for a in
                         (xBC, dt, dt_bias, A_log)),
                       din=din, N=N, H=H, dtype="float32")
    want = JM._ssd_gates(*(jnp.asarray(a) for a in
                           (xBC, dt, dt_bias, A_log)),
                         din=din, N=N, H=H, dtype="float32")
    for a, b in zip(got, want):
        assert a.shape == b.shape == (2, 6, H, N)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-6)
    q, k, w = got
    # q and w are broadcast views (the kernel reads q in place)
    assert q.stride(2) == 0 and w.stride(3) == 0


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
    """Logits of every step and the whole carried state: the conv rows,
    the SSM carry, the shared block's K/V caches and the position."""
    jm, jp, tm = pair
    want, jcache = _ref_serve(jm, jp, tokens)
    got, cache = _port_serve(tm, tokens)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.numpy(), w, **SERVE_TOL,
                                   err_msg=f"step {i}")
    assert int(cache["pos"]) == int(jcache["pos"]) == S + NEW - 1
    for key in ("conv", "shared_k", "shared_v"):
        assert cache[key].shape == jcache[key].shape, key
        np.testing.assert_allclose(cache[key].numpy(),
                                   np.asarray(jcache[key]), **REF_TOL,
                                   err_msg=key)
    ssm, jssm = cache["ssm"].numpy(), np.asarray(jcache["ssm"])
    assert ssm.shape == jssm.shape == (7, B, 8, 16, 16)
    assert np.abs(ssm - jssm).max() <= 1e-4 * np.abs(jssm).max()


def test_prefill_and_decode_match_full_forward(pair, tokens, full_logits):
    _, _, tm = pair
    got, _ = _port_serve(tm, tokens)
    for i, g in enumerate(got):
        np.testing.assert_allclose(g.numpy(), full_logits[:, S - 1 + i],
                                   **SERVE_TOL, err_msg=f"step {i}")


@pytest.mark.parametrize("regions", [True, False])
def test_serve_steps_update_the_state_in_place(pair, tokens, regions):
    """``make_prefill_step`` / ``make_decode_step`` write every layer's
    conv and SSM carry and every application's K/V into their slabs of the
    cache tensors (their ``data_ptr`` stays), and ``pos`` in place,
    regions or per-op alike, with the same logits."""
    _, _, tm = pair
    cfg = ServeConfig(target="cpu", regions=regions)
    prefill, decode = make_prefill_step(tm, cfg=cfg), make_decode_step(
        tm, cfg=cfg)
    cache = tm.init_cache(B, S + NEW)
    keys = STATE_KEYS + ("pos",)
    ptrs = [cache[k].data_ptr() for k in keys]
    logits, cache = prefill(tokens[:, :S], cache)
    assert [cache[k].data_ptr() for k in keys] == ptrs
    assert all(bool((cache[k] != 0).any()) for k in STATE_KEYS)
    nxt, cache = decode(tokens[:, S:S + 1], cache)
    assert [cache[k].data_ptr() for k in keys] == ptrs
    assert int(cache["pos"]) == S + 1
    assert nxt.dtype == torch.int32 and nxt.shape == (B,)
    got, _ = _port_serve(tm, tokens)
    assert torch.equal(logits, got[0])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_region_forward_equals_per_op_bitwise(pair, tokens, dtype):
    """The reference ``_mamba_body``'s promise: one region program per
    block gives the per-op logits bitwise, and so do the stateful steps."""
    _, _, tm = pair
    if dtype == "bfloat16":
        tm = get_model(get_smoke("zamba2_7b"), device="cpu")
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


def test_mamba_block_captures_as_one_region(pair):
    """The block (in-projection, causal conv, SSD gates, scan, gated
    rmsnorm, out-projection) traces into ONE graph holding both GEMMs and
    the scan node in its GLA form."""
    _, _, tm = pair
    p = {k: v[0] for k, v in tm.blocks.items()}
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (2, 8, 64)).astype(np.float32))
    with tapir.use(tapir.TapirConfig(cost_model=H100_COST_MODEL)):
        g = tapir.capture_region(tm._mamba_block_body, p, x)
    run_pipeline(g, "tapir", H100_COST_MODEL)
    ops = [n.op for n in g.nodes.values() if n.op in LIBRARY_OPS]
    assert ops.count("matmul") == 2 and ops.count("linear_scan") == 1
    scan = next(n for n in g.nodes.values() if n.op == "linear_scan")
    assert scan.attrs["variant"] == "gla" and len(scan.inputs) == 4
    assert scan.schedule.impl == "kernel"


def test_every_library_node_binds_its_kernel_on_h100(pair, tokens):
    """At the H100 profile every scan node of the forward binds ``kernel``
    at SAFE_CHUNK in the GLA form, every attention node ``flash_kernel``
    and every matmul ``fused_kernel`` (CPU tensors run their plain
    versions)."""
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
        assert costs["kernel"] < min(costs["chunked"], costs["ref"])
        assert n.schedule.tile["chunk"] == SAFE_CHUNK
        assert n.attrs["variant"] == "gla"
    attn = [n for n in nodes if n.op == "attention"]
    assert attn and {n.schedule.impl for n in attn} == {"flash_kernel"}
    assert {n.schedule.impl for n in nodes if n.op == "matmul"} == {
        "fused_kernel"}


def test_opaque_forward_matches_tapir(pair, tokens, full_logits):
    """The per-op control (sealed library calls, no fusion) runs every scan
    through the same wrapper at SAFE_CHUNK."""
    _, _, tm = pair
    with tapir.use(ServeConfig(target="cpu", mode="opaque").tapir_config()):
        got = tm.forward({"tokens": torch.as_tensor(tokens)})
    torch.testing.assert_close(got, full_logits, rtol=1e-5, atol=1e-5)


def test_tied_head_is_embed_transposed_in_place(pair):
    """The served head reads ``embed.T`` cast once with its strides kept:
    no contiguous copy of the vocabulary matrix (the GEMM's wrapper reads
    it as its K-major operand)."""
    _, _, tm = pair
    w = tm.compute_params()["head"]["w"]
    assert w.shape == (64, 512) and not w.is_contiguous()
    assert w.T.is_contiguous()
    assert torch.equal(w, tm.embed.T)


@pytest.mark.parametrize("layout", ["tied", "contiguous", "strided"])
def test_the_gemm_reads_a_tied_head_in_place(layout):
    """``fused_matmul``'s operand choice: ``embed.T`` (the transpose of a
    contiguous ``[n, k]``) is launched K-major on ``embed`` itself (no
    copy); a contiguous ``w`` as it is; any other strided ``w`` is copied
    contiguous."""
    e = torch.randn(40, 24)
    w = {"tied": e.T, "contiguous": e.T.contiguous(),
         "strided": torch.randn(24, 80)[:, ::2]}[layout]
    b, tb = fm_ops.weight_operand(w)
    assert tb == (layout == "tied")
    if layout == "tied":
        assert b.data_ptr() == e.data_ptr() and torch.equal(b.T, w)
    else:
        assert b.is_contiguous() and torch.equal(b, w)
        assert (b.data_ptr() == w.data_ptr()) == (layout == "contiguous")


def _reqs(cls, lens, news, seed=3):
    rng = np.random.default_rng(seed)
    return [cls(rid=i, prompt=rng.integers(1, 500, size=n).astype(np.int32),
                max_new=m) for i, (n, m) in enumerate(zip(lens, news))]


def test_padded_wave_engine_matches_reference(pair):
    """``ServingEngine.run`` on the hybrid family takes the padded-wave loop
    (prompts left-padded to the wave's longest; the pad tokens go through
    the conv and the SSM, as in the reference's engine): request by
    request the tokens of the reference engine, and ``run`` equals
    ``run_wave``."""
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
    wave = eng.run_wave(_reqs(Request, lens, news))
    assert [r.out for r in wave] == [r.out for r in got]


@pytest.fixture
def _flush_subnormals():
    """XLA's CPU flushes fp32 subnormals to zero, torch's keeps them: at
    the decay bound a chunk factor of e^-90 is a subnormal, so for the
    comparison torch flushes them too (the same arithmetic on both
    sides)."""
    torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)


def test_gla_scan_at_the_mamba2_decay_bound(_flush_subnormals):
    """Decays at the end of Mamba2's clip (A_log = 4: log a = -e^4
    softplus(dt), softplus(dt) in 0.1-1, down to -54 a step), where the
    factored chunk's clamped factors stop being exact: the port's plain
    version (the kernel's yardstick on the card) equals the reference's
    chunked form at the same chunk within 1e-5 of the output's largest,
    with and without a carried state.  The distance of both to the
    sequential oracle is the factored form's own (printed, not bounded:
    the diagonal terms the clamp drops)."""
    rng = np.random.default_rng(11)
    b, s, h, n, hd = 2, 40, 4, 16, 16
    q, k = (rng.standard_normal((b, s, h, n)).astype(np.float32)
            for _ in range(2))
    v = rng.standard_normal((b, s, h, hd)).astype(np.float32)
    sp = rng.uniform(0.1, 1.0, size=(b, s, h)).astype(np.float32)
    a = np.exp(-np.exp(np.float32(4.0)) * sp).astype(np.float32)
    w = np.ascontiguousarray(np.broadcast_to(a[..., None], (b, s, h, n)))
    s0 = rng.standard_normal((b, h, n, hd)).astype(np.float32)
    t = [torch.from_numpy(x) for x in (q, k, v, w)]
    oracle = ls_ref.linear_scan_ref(*t).numpy()
    for st in (None, s0):
        got = ls_ref.linear_scan_chunked(
            *t, chunk=SAFE_CHUNK,
            init_state=None if st is None else torch.from_numpy(st),
            return_state=st is not None)
        want = j_ls_ops.linear_scan_chunked(
            *(jnp.asarray(x) for x in (q, k, v, w)), chunk=SAFE_CHUNK,
            init_state=None if st is None else jnp.asarray(st),
            return_state=st is not None)
        if st is None:
            got, want = (got,), (want,)
        for g, wv in zip(got, want):
            wv = np.asarray(wv)
            assert np.isfinite(g.numpy()).all()
            assert np.abs(g.numpy() - wv).max() <= 1e-5 * np.abs(wv).max()
        if st is None:
            err = float(np.abs(got[0].numpy() - oracle).max())
            print(f"GLA scan at the decay bound vs the oracle: max abs err "
                  f"{err} (output max {float(np.abs(oracle).max())})")


def test_factored_scan_is_nan_where_a_decay_underflows():
    """A decay that underflows to 0 in fp32 (log a below -103.9 a step:
    Mamba2's softplus(dt) has no upper clip) makes the factored chunk form
    NaN from that row on (log 0 = -inf, and the mid-chunk normalizer
    subtracts -inf from -inf, which the carry takes on), in the port's
    plain version and in the reference's alike, while the sequential
    oracle stays finite: a caveat the two share (ROADMAP queue 3)."""
    rng = np.random.default_rng(12)
    q, k, v = (rng.standard_normal((1, 40, 2, 8)).astype(np.float32)
               for _ in range(3))
    w = np.full((1, 40, 2, 8), 0.5, np.float32)
    w[:, 5, 0] = np.exp(np.float32(-110.0))
    assert (w[:, 5, 0] == 0).all()
    t = [torch.from_numpy(x) for x in (q, k, v, w)]
    got = ls_ref.linear_scan_chunked(*t, chunk=SAFE_CHUNK).numpy()
    want = np.asarray(j_ls_ops.linear_scan_chunked(
        *(jnp.asarray(x) for x in (q, k, v, w)), chunk=SAFE_CHUNK))
    assert np.array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got[:, 5:, 0]).all() and not np.isnan(got[:, :5]).any()
    assert np.isfinite(ls_ref.linear_scan_ref(*t).numpy()).all()


def test_launch_serve_runs_zamba2_on_cpu(capsys):
    out = serve_cli.main(["--arch", "zamba2_7b", "--smoke", "--device",
                          "cpu", "--requests", "3", "--batch", "2",
                          "--prompt-len", "6", "--max-new", "3"])
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rep["device"] == "cpu" and rep["requests"] == 3
    assert rep["new_tokens"] == 9 == sum(len(r.out) for r in out)
