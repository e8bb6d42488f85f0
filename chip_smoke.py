#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and check it.

    python3 chip_smoke.py
    python3 chip_smoke.py --gemm-times OUT [--src DIR] [--plan BN,SPLIT,STAGES]

The second form times the GEMM again at the path shapes that a full run
(its output in OUT) counted, and does nothing else: ``--src`` times
another checkout's wrapper (its ``src``), so two trees compare under one
timing method in one call; ``--plan`` launches one plan at every shape.

Phases, each printing one JSON line; any failure exits non-zero.  Every
main-path run zeroes the three kernels' launch counts just before it and
reads them just after:

1. device and build — the card's name and power limit, then the three
   kernel libraries (fused_matmul, flash_attention, linear_scan) built by
   nvcc from the checkout's CUDA sources, in parallel; the GEMM's ptxas
   report (registers, stack, spills per kernel; a spill in the bf16
   kernel fails the run);
2. serve — qwen2.5-3b at full width (all 36 layers, random weights from a
   seed) through ``ServingEngine.run``: 4 slots, max_len 512, 6 requests of
   48-200 prompt tokens (3 sharing a 128-token prefix), 16 new tokens each;
3. forward — ``forward`` and ``loss`` of the same model on 2 x 2048 tokens:
   36 ``flash_attention`` launches per call, every attention node bound to
   ``flash_kernel``, finite logits and loss, wall time, peak memory and a
   profile of the device time by kernel;
4. forward guarantees — the region forward equals the per-op forward
   (``TapirConfig(regions=False)``) bitwise; the per-op control's
   (``mode="opaque"``) largest difference from it;
5. padded prefill/decode — ``make_prefill_step`` / ``make_decode_step`` on
   4 prompts of 512 tokens (max_len 1024), then 16 greedy decode steps: 36
   flash launches per prefill, the K/V caches written in place, the
   prefill's logits against ``forward``'s at position 511;
6. kernel vs plain — ``fused_matmul`` against ``fused_matmul_ref`` at every
   (m, n, k, epilogue) the paths launched, in bf16 and fp32, plus a chain
   with unary, row and full stages; ``flash_attention`` against
   ``flash_attention_ref`` at every path shape, SMOKE, a causal query
   offset, ragged 1000-key causal and non-causal calls and 8192 tokens;
7. small parity — at the SMOKE config in fp32, the slot path and the
   forward/prefill/decode path on the card against the same code on the
   CPU (the kernels' plain versions);
8. port-internal guarantees on the card — ``run`` equals ``run_wave``,
   prefix sharing on equals off, and the per-op control equals the fused
   path, per request, token for token, each run with its counts checked;
9. profile — full-occupancy slot decode steps under ``torch.profiler``;
10. times — per path shape: each kernel, its plain version, the library
   yardstick (``torch.matmul`` / ``torch.addmm``,
   ``scaled_dot_product_attention``; never called by the port) and the
   roofline bound; for the GEMM also its plan (``kernel.plan(n, k)``: BN,
   the cluster split, the TMA ring depth), its achieved TFLOP/s, and the
   wrapper's host time per call at two decode shapes.

The qwen model is then released, and RWKV6-7B at full width (32 layers,
d_model 4096; random weights from seed 0) takes its place:

11. rwkv_forward — ``forward`` and ``loss`` on 2 x 2048 tokens: 32
   ``linear_scan`` and 321 ``fused_matmul`` launches per call, every scan
   node bound to ``kernel`` and every matmul to ``fused_kernel``, finite
   logits and loss, wall time, peak memory, device time by kernel;
12. rwkv_guarantees — region forward = per-op forward bitwise; the per-op
   control's largest difference; the stateful prefill of 4 x 512 tokens
   and 16 greedy decode steps (state written in place), the prefill's last
   logits against the forward's at position 511;
13. rwkv_serve — ``ServingEngine.run`` through the padded-wave loop (the
   serve phase's requests), every request finished, ``run`` = ``run_wave``;
14. scan_vs_plain — ``linear_scan`` against ``linear_scan_chunked`` in
   bf16 and fp32, both variants: the forward's shape, SMOKE, ragged S
   (37, 1000) and the decay clip in every position (S = 37, 2048, 8192);
15. rwkv_gemm_vs_plain — ``fused_matmul`` at every RWKV path shape;
16. small_rwkv_parity — SMOKE in fp32, the forward and the stateful steps
   on the card against the CPU;
17. scan_times — per path shape the scan kernel, its plain version and the
   bound (no PyTorch call computes the scan: no library time), and the
   RWKV forward and decode GEMM shapes as in phase 10 (plan, TFLOP/s,
   the wrapper's host time at the 4096² and wA decode shapes).

Then the kernels line, the card line, and the result line last.  Exits
non-zero without printing a result when no card is present or the
repository is not beside this file.
"""
from __future__ import annotations

import collections
import dataclasses
import json
import math
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}   # H100 SXM, dense
HBM_BW = 3.35e12
SLOTS, MAX_LEN, MAX_NEW = 4, 512, 16
SOURCE = "src/repro_torch/kernels/fused_matmul/csrc/fused_matmul.cu"
REPLACES = "src/repro/kernels/fused_matmul/kernel.py:64"
TOL = {"bfloat16": 0.1, "float32": 2e-3}   # max |kernel - plain|
FA_SOURCE = "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu"
FA_REPLACES = "src/repro/kernels/flash_attention/kernel.py:77"
#: max |kernel - plain|: the JAX package's own flash tolerances
#: (tests/test_kernels.py)
FA_TOL = {"bfloat16": 2e-2, "float32": 2e-4}
#: max over (batch, query, head) rows of max |kernel - plain| / max |plain|:
#: a late causal row's values are about the size of FA_TOL's bf16 bound, so
#: each row is also held to a few bf16 ulps of its own largest value
FA_RTOL = {"bfloat16": 2e-2, "float32": 1e-4}
FWD_B, FWD_S = 2, 2048                     # the forward's tokens
PF_B, PF_S, PF_MAX, PF_NEW = 4, 512, 1024, 16   # padded prefill/decode


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def requests(vocab: int, seed: int):
    import numpy as np
    from repro_torch.serve import Request
    rng = np.random.default_rng(seed)
    prefix = rng.integers(1, vocab, size=128).astype(np.int32)
    lens = [48, 200, 160, 144, 176, 96]
    shared = {2, 3, 4}
    out = []
    for i, n in enumerate(lens):
        if i in shared:
            tail = rng.integers(1, vocab, size=n - 128).astype(np.int32)
            prompt = np.concatenate([prefix, tail])
        else:
            prompt = rng.integers(1, vocab, size=n).astype(np.int32)
        out.append(Request(rid=i, prompt=prompt, max_new=MAX_NEW))
    return out


def label(n: int, k: int, cfg) -> str:
    d, hd = cfg.d_model, cfg.hd
    names = {((cfg.n_heads + 2 * cfg.n_kv_heads) * hd, d): "qkv",
             (d, cfg.n_heads * hd): "wo", (2 * cfg.d_ff, d): "gate_up",
             (d, cfg.d_ff): "wd", (cfg.vocab, d): "head"}
    return names.get((n, k), f"n{n}_k{k}")


def make_inputs(m, n, k, spec, dt, gen):
    """Random operands for one launch shape of the serve phase, in ``dt``.
    A stage that cast to the compute dtype casts to ``dt`` here, as the
    same chain does when the model computes in ``dt``."""
    import torch
    x = torch.randn(m, k, generator=gen, device="cuda").to(dt)
    w = (torch.randn(k, n, generator=gen, device="cuda") / k ** 0.5).to(dt)
    epi = []
    for fn, kind, hp, edt in spec:
        at = {"head_pos": hp,
              "dtype": None if edt is None else str(dt).split(".")[-1]}
        if kind == "none":
            epi.append((fn, [], at))
        else:
            shape = (n,) if kind == "row" else (m, n)
            epi.append((fn, [torch.randn(shape, generator=gen,
                                         device="cuda").to(dt)], at))
    return x, w, epi


def time_ms(fn, iters: int = 10, hold: bool = True) -> float:
    """Median time of one call in ms, each launch measured alone with L2
    flushed before it (the serving path finds its weights cold: a model's
    layers stream through the 50 MB L2 between two uses of one).  The
    flush READS 64 MB, so it leaves no dirty lines whose write-back the
    timed call would pay for.  With ``hold`` the card is kept busy for
    about 1 ms (``torch.cuda._sleep``) while the host enqueues the call,
    so the events bracket the call's device time alone; without it they
    also hold the host's time to issue the call (``ms_with_issue`` of
    ``--gemm-times``)."""
    import torch
    flush = torch.zeros(64 << 20, dtype=torch.uint8, device="cuda")
    fn()
    times = []
    for _ in range(iters):
        flush.max()
        if hold:
            torch.cuda._sleep(2_000_000)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def host_us(fn, calls: int = 200) -> float:
    """Host µs per call over ``calls`` calls issued back to back with no
    synchronisation between them (at decode shapes the card finishes each
    call before the host issues the next, so this is the host's cost)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    return host / calls * 1e6


def small_parity() -> dict:
    """The whole slot path on the card against the same path on the CPU
    (the plain kernel versions, which the CPU tests hold against the JAX
    package): the SMOKE config at fp32 compute on the same weights, one
    slot prefill and three decode steps, logits compared."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get_smoke
    from repro_torch.core import tapir
    from repro_torch.models.base import get_model
    from repro_torch.serve import ServeConfig
    cfg = dataclasses.replace(get_smoke("qwen2_5_3b"), compute_dtype="float32")
    cpu = get_model(cfg, device="cpu",
                    generator=torch.Generator().manual_seed(0))
    params = {"embed": cpu.embed.data, "ln_f": cpu.ln_f.data,
              "lm_head": cpu.lm_head.data,
              "blocks": {k: v.data for k, v in cpu.blocks.items()}}
    prompt = np.zeros((1, 16), np.int32)
    prompt[0, :11] = np.random.default_rng(0).integers(1, cfg.vocab, 11)
    feed = np.asarray([[5], [7]], np.int32)
    logits = {}
    for dev, target in (("cpu", "cpu"), ("cuda", "gpu")):
        model = cpu if dev == "cpu" else get_model(cfg, device=dev,
                                                   params=params)
        with tapir.use(ServeConfig(target=target).tapir_config()):
            sp = model.slot_params()
            cache = model.init_slot_cache(2, 32, page_len=8)
            out, cache = model.prefill_into_slot(
                sp, torch.as_tensor(prompt, device=dev), cache, 1, 11)
            outs = [out]
            for _ in range(3):
                out, cache = model.decode_step_slots(
                    sp, torch.as_tensor(feed, device=dev), cache)
                outs.append(out)
        logits[dev] = [o.float().cpu() for o in outs]
    err = max(float((a - b).abs().max())
              for a, b in zip(logits["cpu"], logits["cuda"]))
    finite = all(bool(torch.isfinite(o).all()) for o in logits["cuda"])
    return {"phase": "small_parity", "config": cfg.name,
            "compute_dtype": cfg.compute_dtype, "max_abs_err": err,
            "tolerance": 1e-3, "finite": finite}


def kernel_ops():
    """The three kernel wrappers' modules (each keeps a launch count)."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.fused_matmul import ops as fm_ops
    from repro_torch.kernels.linear_scan import ops as ls_ops
    return fm_ops, fa_ops, ls_ops


def reset_counts() -> None:
    for mod in kernel_ops():
        mod.reset_counts()


def counted(tag: str, fn, flash: int, gemm: int, scan: int = 0):
    """Run ``fn``, one call of a main path, with every kernel's launch
    count zeroed just before it and read just after; fail unless
    ``flash_attention`` launched ``flash`` times, ``fused_matmul`` ``gemm``
    times and ``linear_scan`` ``scan`` times.  Returns (result, host wall
    seconds to the end of its device work, and the launches by shape of
    fused_matmul, flash_attention and linear_scan)."""
    import torch
    fm_ops, fa_ops, ls_ops = kernel_ops()
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = (fa_ops.launches, fm_ops.launches, ls_ops.launches)
    if got != (flash, gemm, scan):
        raise SystemExit(f"{tag}: {got[0]} flash_attention, {got[1]} "
                         f"fused_matmul and {got[2]} linear_scan launches "
                         f"(expected {flash}, {gemm} and {scan})")
    return (out, wall, collections.Counter(fm_ops.launches_by_shape),
            collections.Counter(fa_ops.launches_by_shape),
            collections.Counter(ls_ops.launches_by_shape))


def bound_impls(op: str, mode: str) -> set:
    """The impls bound to every ``op`` node of the card's programs."""
    from repro_torch.core import tapir
    return {n.schedule.impl for key, g in tapir.cached_graphs().items()
            if key[-3] == mode and key[-2] == "h100_sxm"
            for n in g.nodes.values() if n.op == op}


def device_time_by_kernel(prof, steps: int) -> dict:
    """(ms, launches) per step by kernel name, from the device's own
    events (kernels, copies), not the host ops that launched them:
    counting both would count each kernel twice."""
    import torch
    return {ev.key: (ev.self_device_time_total / steps / 1e3,
                     ev.count // steps)
            for ev in prof.key_averages()
            if ev.device_type == torch.autograd.DeviceType.CUDA}


def top_kernels(by_name: dict, n: int = 8) -> list:
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:n]
    return [{"name": k[:60], "ms_per_step": ms, "calls_per_step": c}
            for k, (ms, c) in top]


def forward_phase(model, cfg):
    """``forward`` and ``loss`` at full width on FWD_B x FWD_S tokens: a
    first call (region programs built), a timed call, the loss, and one
    profiled forward.  Each zeroes and checks the counts: one flash launch
    per layer, 4 GEMMs per layer (QKV, wo, gate|up, wd) plus the head."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import tapir
    from repro_torch.serve import ServeConfig
    rng = np.random.default_rng(2)
    batch = {name: torch.as_tensor(rng.integers(lo, cfg.vocab,
                                                (FWD_B, FWD_S)),
                                   dtype=torch.int32, device="cuda")
             for name, lo in (("tokens", 1), ("labels", 0))}
    n_l = cfg.n_layers
    torch.cuda.reset_peak_memory_stats()
    with tapir.use(ServeConfig(target="gpu").tapir_config()):
        _, cold_s, *_ = counted("forward (first call)",
                                  lambda: model.forward(batch), n_l,
                                  4 * n_l + 1)
        logits, wall_s, fm, fa, _ = counted(
            "forward", lambda: model.forward(batch), n_l, 4 * n_l + 1)
        peak = torch.cuda.max_memory_allocated()
        loss, loss_s, *_ = counted("loss", lambda: model.loss(batch), n_l,
                                     4 * n_l + 1)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            model.forward(batch)
            torch.cuda.synchronize()
            prof_s = time.perf_counter() - t0
    impls = bound_impls("attention", "tapir")
    finite = bool(torch.isfinite(logits).all()) and bool(
        torch.isfinite(loss))
    by_name = device_time_by_kernel(prof, 1)
    busy = sum(ms for ms, _ in by_name.values())
    flash_ms = sum(ms for k, (ms, _) in by_name.items() if "flash" in k)
    gemm_ms = sum(ms for k, (ms, _) in by_name.items() if "gemm" in k)
    line = {"phase": "forward", "batch": FWD_B, "seq": FWD_S,
            "layers": n_l, "logits_shape": list(logits.shape),
            "finite": finite, "loss": float(loss),
            "attention_impls": sorted(impls),
            "flash_launches_per_forward": sum(fa.values()),
            "gemm_launches_per_forward": sum(fm.values()),
            "first_call_s": cold_s, "wall_s": wall_s, "loss_wall_s": loss_s,
            "tok_per_s": FWD_B * FWD_S / wall_s,
            "peak_mem_gb": peak / 1e9,
            "profiled_wall_s": prof_s, "device_ms": busy,
            "device_busy_share": busy / (wall_s * 1e3),
            "flash_device_ms": flash_ms, "gemm_device_ms": gemm_ms,
            "top": top_kernels(by_name)}
    if impls != {"flash_kernel"}:
        raise SystemExit(f"forward: attention nodes bound to {impls}")
    if not finite or tuple(logits.shape) != (FWD_B, FWD_S, cfg.vocab):
        raise SystemExit(f"forward: {line}")
    return line, batch, logits, fm, fa


def forward_guarantees(model, cfg, batch, logits) -> dict:
    """The region forward against the per-op forward (bitwise, the
    reference ``_block``'s promise) and against the per-op control
    (``mode="opaque"``: no fusion, 7 GEMM launches per layer)."""
    import torch
    from repro_torch.core import tapir
    from repro_torch.serve import ServeConfig
    n_l = cfg.n_layers
    with tapir.use(ServeConfig(target="gpu", regions=False).tapir_config()):
        per_op, per_op_s, *_ = counted(
            "forward per-op", lambda: model.forward(batch), n_l, 4 * n_l + 1)
    bitwise = torch.equal(per_op, logits)
    del per_op
    with tapir.use(ServeConfig(target="gpu", mode="opaque").tapir_config()):
        opaque, opaque_s, *_ = counted(
            "forward opaque", lambda: model.forward(batch), n_l, 7 * n_l + 1)
    err = float((opaque.float() - logits.float()).abs().max())
    impls = bound_impls("attention", "opaque")
    line = {"phase": "forward_guarantees", "region_eq_per_op": bitwise,
            "per_op_wall_s": per_op_s, "opaque_max_abs_diff": err,
            "opaque_wall_s": opaque_s,
            "opaque_attention_impls": sorted(impls)}
    if not bitwise or impls != {"opaque"}:
        raise SystemExit(f"forward guarantees: {line}")
    return line


def padded_phase(model, cfg):
    """``make_prefill_step`` / ``make_decode_step`` at full width: PF_B
    prompts of PF_S tokens into a PF_MAX cache (a first call, then a timed
    one into a fresh cache), then PF_NEW greedy decode steps.  A prefill
    launches flash once per layer; a decode step attends over the cache
    with the masked composite (no flash launch); both run 4 GEMMs per
    layer plus the head over one row per prompt.  The steps run under
    regions, where ``_run_with_cache`` raises unless every layer's program
    hands back the cache slab it wrote in place."""
    import numpy as np
    import torch
    from repro_torch.core import tapir
    from repro_torch.serve import ServeConfig, make_decode_step, \
        make_prefill_step
    rng = np.random.default_rng(3)
    prompts = rng.integers(1, cfg.vocab, (PF_B, PF_S)).astype(np.int32)
    scfg = ServeConfig(target="gpu")
    if not scfg.tapir_config().regions:
        raise SystemExit("padded serve: the steps must run under regions")
    prefill = make_prefill_step(model, cfg=scfg)
    decode = make_decode_step(model, cfg=scfg)
    n_l = cfg.n_layers
    walls = []
    for tag in ("prefill (first call)", "prefill"):
        cache = model.init_cache(PF_B, PF_MAX)
        ptrs = (cache["k"].data_ptr(), cache["v"].data_ptr())
        (logits, cache), wall, fm_pf, fa_pf, _ = counted(
            tag, lambda: prefill(prompts, cache), n_l, 4 * n_l + 1)
        walls.append(wall)
        if (cache["k"].data_ptr(), cache["v"].data_ptr()) != ptrs:
            raise SystemExit(f"{tag}: the K/V caches were not written in "
                             f"place")
    tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
    fm_dec = collections.Counter()
    steps, out = [], []
    for i in range(PF_NEW):
        (nxt, cache), wall, fm, *_ = counted(
            f"decode step {i}", lambda: decode(tok, cache), 0, 4 * n_l + 1)
        fm_dec += fm
        steps.append(wall)
        tok = nxt[:, None]
        out.append(nxt)
    toks = torch.stack(out, dim=1).cpu().numpy()
    in_place = (cache["k"].data_ptr(), cache["v"].data_ptr()) == ptrs
    with tapir.use(scfg.tapir_config()):
        full = model.forward({"tokens": torch.as_tensor(prompts,
                                                        device="cuda")})
    err = float((logits.float() - full[:, -1].float()).abs().max())
    same_top = bool(torch.equal(torch.argmax(logits, -1),
                                torch.argmax(full[:, -1], -1)))
    steps.sort()
    line = {"phase": "padded_serve", "batch": PF_B, "prompt": PF_S,
            "max_len": PF_MAX, "decode_steps": PF_NEW,
            "flash_launches_per_prefill": sum(fa_pf.values()),
            "gemm_launches_per_prefill": sum(fm_pf.values()),
            "gemm_launches_per_decode_step": sum(fm_dec.values()) // PF_NEW,
            "prefill_first_call_s": walls[0], "prefill_s": walls[1],
            "decode_step_p50_ms": steps[len(steps) // 2] * 1e3,
            "decode_step_max_ms": steps[-1] * 1e3,
            "pos": int(cache["pos"]), "kv_in_place": in_place,
            "prefill_vs_forward_max_abs_diff": err,
            "prefill_vs_forward_same_argmax": same_top,
            "finite": bool(torch.isfinite(logits).all()),
            "sample_out": toks[0, :8].tolist()}
    if not (in_place and line["finite"] and line["pos"] == PF_S + PF_NEW
            and ((toks >= 0) & (toks < cfg.vocab)).all()):
        raise SystemExit(f"padded serve: {line}")
    return line, fm_pf, fa_pf, fm_dec


def small_forward_parity() -> dict:
    """The forward and the padded prefill/decode on the card against the
    same code on the CPU (the kernels' plain versions, which the CPU tests
    hold against the JAX package): SMOKE in fp32 on the same weights.
    Forward logits within 1e-4; prefill plus 4 decode steps against the
    full-sequence forward within 3e-3, the reference's own serving
    tolerance (tests/test_serving.py)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_smoke
    from repro_torch.core import tapir
    from repro_torch.models.base import get_model
    from repro_torch.serve import ServeConfig
    cfg = dataclasses.replace(get_smoke("qwen2_5_3b"), compute_dtype="float32")
    cpu = get_model(cfg, device="cpu",
                    generator=torch.Generator().manual_seed(0))
    params = {"embed": cpu.embed.data, "ln_f": cpu.ln_f.data,
              "lm_head": cpu.lm_head.data,
              "blocks": {k: v.data for k, v in cpu.blocks.items()}}
    s, new = 24, 4
    toks = np.random.default_rng(4).integers(1, cfg.vocab, (2, s + new))
    toks = toks.astype(np.int32)
    res = {}
    for dev, target in (("cpu", "cpu"), ("cuda", "gpu")):
        model = cpu if dev == "cpu" else get_model(cfg, device=dev,
                                                   params=params)
        with tapir.use(ServeConfig(target=target).tapir_config()):
            full = model.forward({"tokens": torch.as_tensor(toks,
                                                            device=dev)})
            cache = model.init_cache(2, s + new + 4)
            lg, cache = model.prefill(torch.as_tensor(toks[:, :s],
                                                      device=dev), cache)
            outs = [lg]
            for t in range(new):
                lg, cache = model.decode_step(
                    torch.as_tensor(toks[:, s + t:s + t + 1], device=dev),
                    cache)
                outs.append(lg)
        res[dev] = (full.float().cpu(), [o.float().cpu() for o in outs])
    (f_cpu, o_cpu), (f_gpu, o_gpu) = res["cpu"], res["cuda"]
    return {"phase": "small_forward_parity", "config": cfg.name,
            "compute_dtype": cfg.compute_dtype,
            "forward_max_abs_err": float((f_cpu - f_gpu).abs().max()),
            "forward_tolerance": 1e-4,
            "serve_vs_forward_max_abs_err": max(
                float((o - f_gpu[:, s - 1 + i]).abs().max())
                for i, o in enumerate(o_gpu)),
            "serve_tolerance": 3e-3,
            "serve_card_vs_cpu_max_abs_err": max(
                float((a - b).abs().max()) for a, b in zip(o_cpu, o_gpu)),
            "finite": bool(torch.isfinite(f_gpu).all())}


def flash_inputs(shape, dt, seed: int):
    import torch
    b, sq, skv, hq, hkv, d, _ = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return tuple(torch.randn(s, generator=gen, device="cuda").to(dt)
                 for s in ((b, sq, hq, d), (b, skv, hkv, d),
                           (b, skv, hkv, d)))


def flash_vs_plain(path_shapes) -> tuple:
    """``flash_attention`` against ``flash_attention_ref`` in bf16 and fp32
    at every path shape, the SMOKE shapes, a causal query offset
    (Sq < Skv), ragged 1000-key calls (causal and not) and 8192 tokens.
    Returns max |kernel - plain| and its largest row-relative size (see
    FA_RTOL), each by (shape, dtype)."""
    import torch
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    extra = [(2, 28, 28, 4, 2, 24, True), (2, 24, 24, 4, 2, 24, True),
             (2, 100, 300, 16, 2, 128, True),
             (2, 1000, 1000, 16, 2, 128, False),
             (2, 1000, 1000, 16, 2, 128, True),
             (1, 8192, 8192, 16, 2, 128, True)]
    errs, rels = {}, {}
    for i, shape in enumerate(sorted(set(path_shapes) | set(extra))):
        for dname, dt in (("bfloat16", torch.bfloat16),
                          ("float32", torch.float32)):
            q, k, v = flash_inputs(shape, dt, seed=10 + i)
            o = fa_ops.flash_attention(q, k, v, causal=shape[-1])
            want = fa_ref.flash_attention_ref(q, k, v, causal=shape[-1])
            diff = (o.float() - want.float()).abs()
            err = float(diff.max())
            rel = float((diff.amax(-1) / want.float().abs().amax(-1)).max())
            if not (err <= FA_TOL[dname] and rel <= FA_RTOL[dname]):
                raise SystemExit(f"flash vs plain: {shape} {dname} max err "
                                 f"{err} (<= {FA_TOL[dname]}), row-relative "
                                 f"{rel} (<= {FA_RTOL[dname]})")
            errs[(shape, dname)] = err
            rels[(shape, dname)] = rel
            del q, k, v, o, want, diff
    return errs, rels


def flash_bound(shape, eb: int, peak: float):
    """(bound ms, what bounds it): q, k, v read once and o written once
    over the memory rate; 4 * D FLOPs per visible (query, key) pair (QK^T
    and PV), counting the keys this call's causal mask leaves visible,
    over the peak rate."""
    b, sq, skv, hq, hkv, d, causal = shape
    off = skv - sq
    pairs = (sum(min(skv, off + i + 1) for i in range(sq)) if causal
             else sq * skv)
    t_bytes = eb * (2 * b * sq * hq * d + 2 * b * skv * hkv * d) / HBM_BW
    t_ops = 4.0 * d * pairs * b * hq / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def flash_times(paths, errs) -> list:
    """Per path shape, bf16: the kernel, its plain version and
    ``scaled_dot_product_attention`` (is_causal, enable_gqa; the yardstick,
    which the port never calls), each timed alone with L2 flushed, and the
    roofline bound.  ``paths``: (phase, shape, launches in that path's
    counted run)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    out = []
    for phase, shape, launches in paths:
        b, sq, skv, hq, hkv, d, causal = shape
        q, k, v = flash_inputs(shape, torch.bfloat16, seed=1)
        ms = time_ms(lambda: fa_ops.flash_attention(q, k, v, causal=causal))
        plain = time_ms(lambda: fa_ref.flash_attention_ref(q, k, v,
                                                           causal=causal))
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        lib = time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, enable_gqa=True))
        bound, by = flash_bound(shape, 2, PEAK_FLOPS["bfloat16"])
        out.append({
            "name": f"flash_attention[{phase} B={b} Sq={sq} Skv={skv} "
                    f"Hq={hq} Hkv={hkv} D={d}{' causal' if causal else ''}]",
            "route": "cuda", "source": FA_SOURCE, "replaces": FA_REPLACES,
            "launches": launches,
            "max_abs_err": errs[(shape, "bfloat16")],
            "ms": ms, "plain_ms": plain, "bound_ms": bound, "bound_by": by,
            "library_ms": lib})
        del q, k, v, qt, kt, vt
    return out


def profile_decode(model, eng, steps: int = 3) -> dict:
    """Full-occupancy decode steps, timed bare and then under
    ``torch.profiler``: host wall time per step, device time per step by
    kernel, and the device's busy share of a bare step (the rest is the
    card waiting on the host)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import tapir
    with tapir.use(eng.cfg.tapir_config()):
        cache = model.init_slot_cache(SLOTS, MAX_LEN)
        cache["pos"].fill_(MAX_LEN // 2)
        tok = torch.ones((SLOTS, 1), dtype=torch.int32, device="cuda")
        for _ in range(2):
            model.decode_step_slots(eng._sp, tok, cache)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            model.decode_step_slots(eng._sp, tok, cache)
        torch.cuda.synchronize()
        bare = (time.perf_counter() - t0) / steps
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                logits, cache = model.decode_step_slots(eng._sp, tok, cache)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) / steps
    by_name = device_time_by_kernel(prof, steps)
    busy = sum(ms for ms, _ in by_name.values())
    return {"phase": "profile_decode", "slots": SLOTS,
            "finite": bool(torch.isfinite(logits).all()),
            "logits_shape": list(logits.shape),
            "kv_len": MAX_LEN // 2, "steps": steps,
            "wall_ms_per_step": bare * 1e3,
            "wall_ms_per_step_profiled": wall * 1e3,
            "device_ms_per_step": busy,
            "device_busy_share": busy / (bare * 1e3),
            "kernels_per_step": sum(c for _, c in by_name.values()),
            "top": top_kernels(by_name, 10)}


# -- RWKV6-7B ----------------------------------------------------------------

LS_SOURCE = "src/repro_torch/kernels/linear_scan/csrc/linear_scan.cu"
LS_REPLACES = "src/repro/kernels/linear_scan/kernel.py:70"
#: per output row (batch, position, head): max |kernel - plain| over the
#: row's own scale, its max of the same scan over |q|, |k|, |v|, |u| (the
#: magnitudes of the terms each output sums, which bound the rounding
#: error of a signed sum; a row whose terms nearly cancel has a max |plain|
#: far below it).  bf16: one rounding of the output, 2^-8 of its size;
#: fp32: prefix sums and products summed in another order
LS_RTOL = {"bfloat16": 2e-2, "float32": 1e-4}
#: the stateful prefill's last logits against the forward's at the same
#: position, per row over the row's max |logit|: the composite (prefill)
#: and the kernel (forward) round differently in bf16, over 32 layers
RW_PF_RTOL = 5e-2
#: RWKV6's decay clip: log w >= -exp(2)
CLIP_W = math.exp(-math.exp(2.0))


def rwkv_label(n: int, k: int, spec, cfg) -> str:
    from repro_torch.models.rwkv import LORA_RANK
    d, ff, r = cfg.d_model, cfg.d_ff, LORA_RANK
    names = {(d, d): "wr|wk|wv|wg|wo|wcr", (r, d): "wA", (d, r): "wB",
             (ff, d): "wck", (d, ff): "wcv", (cfg.vocab, d): "head"}
    name = names.get((n, k), f"n{n}_k{k}")
    return name + "".join(f"+{fn}" for fn, *_ in spec)


def rwkv_forward_phase(model, cfg):
    """``forward`` and ``loss`` of RWKV6-7B at full width on FWD_B x FWD_S
    tokens: a first call, a timed call, the loss and one profiled forward,
    each with the counts checked: one scan per layer, ten GEMMs per layer
    (wr, wk, wv, wg, wA, wB, wo, wck, wcr, wcv: every one reads its own
    input, so no fusion merges two) plus the head, no flash."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import tapir
    from repro_torch.serve import ServeConfig
    rng = np.random.default_rng(5)
    batch = {name: torch.as_tensor(rng.integers(lo, cfg.vocab,
                                                (FWD_B, FWD_S)),
                                   dtype=torch.int32, device="cuda")
             for name, lo in (("tokens", 1), ("labels", 0))}
    n_l = cfg.n_layers
    gemm = 10 * n_l + 1
    torch.cuda.reset_peak_memory_stats()
    with tapir.use(ServeConfig(target="gpu").tapir_config()):
        _, cold_s, *_ = counted("rwkv forward (first call)",
                                lambda: model.forward(batch), 0, gemm, n_l)
        logits, wall_s, fm, _, ls = counted(
            "rwkv forward", lambda: model.forward(batch), 0, gemm, n_l)
        peak = torch.cuda.max_memory_allocated()
        loss, loss_s, *_ = counted("rwkv loss", lambda: model.loss(batch),
                                   0, gemm, n_l)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            model.forward(batch)
            torch.cuda.synchronize()
            prof_s = time.perf_counter() - t0
    scan_impls = bound_impls("linear_scan", "tapir")
    mm_impls = bound_impls("matmul", "tapir")
    finite = bool(torch.isfinite(logits).all()) and bool(
        torch.isfinite(loss))
    by_name = device_time_by_kernel(prof, 1)
    busy = sum(ms for ms, _ in by_name.values())
    line = {"phase": "rwkv_forward", "batch": FWD_B, "seq": FWD_S,
            "layers": n_l, "d_model": cfg.d_model,
            "logits_shape": list(logits.shape), "finite": finite,
            "loss": float(loss), "scan_impls": sorted(scan_impls),
            "matmul_impls": sorted(mm_impls),
            "scan_launches_per_forward": sum(ls.values()),
            "gemm_launches_per_forward": sum(fm.values()),
            "first_call_s": cold_s, "wall_s": wall_s, "loss_wall_s": loss_s,
            "tok_per_s": FWD_B * FWD_S / wall_s,
            "peak_mem_gb": peak / 1e9,
            "profiled_wall_s": prof_s, "device_ms": busy,
            "device_busy_share": busy / (wall_s * 1e3),
            "scan_device_ms": sum(ms for k, (ms, _) in by_name.items()
                                  if "linear_scan" in k),
            "gemm_device_ms": sum(ms for k, (ms, _) in by_name.items()
                                  if "gemm" in k),
            "top": top_kernels(by_name)}
    if scan_impls != {"kernel"} or mm_impls != {"fused_kernel"}:
        raise SystemExit(f"rwkv forward: impls {scan_impls}, {mm_impls}")
    if not finite or tuple(logits.shape) != (FWD_B, FWD_S, cfg.vocab):
        raise SystemExit(f"rwkv forward: {line}")
    return line, batch, logits, fm, ls


def rwkv_guarantees(model, cfg, batch, logits):
    """Region forward = per-op forward bitwise; the per-op control's
    largest difference; the stateful prefill of PF_B x PF_S tokens (the
    lifted chunked composite, no scan launch) then PF_NEW greedy decode
    steps, its state written in place, its last logits against the
    forward's at position PF_S - 1."""
    import numpy as np
    import torch
    from repro_torch.core import tapir
    from repro_torch.serve import ServeConfig, make_decode_step, \
        make_prefill_step
    n_l = cfg.n_layers
    gemm = 10 * n_l + 1
    torch.cuda.reset_peak_memory_stats()
    with tapir.use(ServeConfig(target="gpu", regions=False).tapir_config()):
        per_op, per_op_s, *_ = counted(
            "rwkv forward per-op", lambda: model.forward(batch), 0, gemm, n_l)
    bitwise = torch.equal(per_op, logits)
    del per_op
    with tapir.use(ServeConfig(target="gpu", mode="opaque").tapir_config()):
        opaque, opaque_s, *_ = counted(
            "rwkv forward opaque", lambda: model.forward(batch), 0, gemm,
            n_l)
    err = float((opaque.float() - logits.float()).abs().max())
    del opaque
    opaque_impls = bound_impls("linear_scan", "opaque")

    rng = np.random.default_rng(6)
    prompts = rng.integers(1, cfg.vocab, (PF_B, PF_S)).astype(np.int32)
    scfg = ServeConfig(target="gpu")
    prefill = make_prefill_step(model, cfg=scfg)
    decode = make_decode_step(model, cfg=scfg)
    keys = ("tm_shift", "cm_shift", "wkv")
    walls = []
    for tag in ("rwkv prefill (first call)", "rwkv prefill"):
        cache = model.init_cache(PF_B, PF_MAX)
        ptrs = [cache[k].data_ptr() for k in keys]
        (lg, cache), wall, fm_pf, *_ = counted(
            tag, lambda: prefill(prompts, cache), 0, gemm, 0)
        walls.append(wall)
    tok = torch.argmax(lg, dim=-1).to(torch.int32)[:, None]
    fm_dec = collections.Counter()
    steps, out = [], []
    for i in range(PF_NEW):
        (nxt, cache), wall, fm, *_ = counted(
            f"rwkv decode step {i}", lambda: decode(tok, cache), 0, gemm, 0)
        fm_dec += fm
        steps.append(wall)
        tok = nxt[:, None]
        out.append(nxt)
    toks = torch.stack(out, dim=1).cpu().numpy()
    in_place = [cache[k].data_ptr() for k in keys] == ptrs
    with tapir.use(scfg.tapir_config()):
        full = model.forward({"tokens": torch.as_tensor(prompts,
                                                        device="cuda")})
    last = full[:, -1].float()
    diff = (lg.float() - last).abs()
    rel = float((diff.amax(-1) / last.abs().amax(-1)).max())
    steps.sort()
    line = {"phase": "rwkv_guarantees", "region_eq_per_op": bitwise,
            "per_op_wall_s": per_op_s, "opaque_max_abs_diff": err,
            "opaque_wall_s": opaque_s,
            "opaque_scan_impls": sorted(opaque_impls),
            "batch": PF_B, "prompt": PF_S, "decode_steps": PF_NEW,
            "gemm_launches_per_prefill": sum(fm_pf.values()),
            "gemm_launches_per_decode_step": sum(fm_dec.values()) // PF_NEW,
            "prefill_first_call_s": walls[0], "prefill_s": walls[1],
            "decode_step_p50_ms": steps[len(steps) // 2] * 1e3,
            "decode_step_max_ms": steps[-1] * 1e3,
            "pos": int(cache["pos"]), "state_in_place": in_place,
            "prefill_vs_forward_max_abs_diff": float(diff.max()),
            "prefill_vs_forward_row_rel": rel,
            "prefill_vs_forward_row_rtol": RW_PF_RTOL,
            "prefill_vs_forward_same_argmax": bool(torch.equal(
                torch.argmax(lg, -1), torch.argmax(full[:, -1], -1))),
            "finite": bool(torch.isfinite(lg).all()),
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "sample_out": toks[0, :8].tolist()}
    if not (bitwise and opaque_impls == {"opaque"} and in_place
            and line["finite"] and rel <= RW_PF_RTOL
            and line["pos"] == PF_S + PF_NEW
            and ((toks >= 0) & (toks < cfg.vocab)).all()):
        raise SystemExit(f"rwkv guarantees: {line}")
    return line, fm_pf, fm_dec


def rwkv_serve(model, cfg):
    """``ServingEngine.run`` on a family without slots: the padded-wave
    loop, SLOTS rows, the serve phase's 6 requests (48-200 prompt tokens),
    MAX_NEW new tokens each.  Every prefill and decode step runs 10 GEMMs
    per layer plus the head and no scan kernel (the stateful step is the
    lifted composite).  ``run`` equals ``run_wave`` token for token."""
    import numpy as np
    import torch
    from repro_torch.serve import Request, ServeConfig, ServingEngine
    fm_ops, fa_ops, ls_ops = kernel_ops()
    eng = ServingEngine(model, batch=SLOTS, max_len=MAX_LEN,
                        cfg=ServeConfig(target="gpu"), device="cuda")
    reqs = requests(cfg.vocab, seed=0)
    per_call = 10 * cfg.n_layers + 1
    waves = -(-len(reqs) // SLOTS)
    torch.cuda.reset_peak_memory_stats()
    runs, stats, fm = {}, {}, collections.Counter()
    for name in ("run", "run_wave"):
        fresh = [Request(rid=r.rid, prompt=r.prompt.copy(),
                         max_new=r.max_new) for r in reqs]
        torch.cuda.synchronize()
        reset_counts()
        out = getattr(eng, name)(fresh)
        torch.cuda.synchronize()
        st = dict(eng.last_stats)
        want = (waves + st["decode_steps"]) * per_call
        if (fm_ops.launches, fa_ops.launches, ls_ops.launches) != (want, 0,
                                                                    0):
            raise SystemExit(
                f"rwkv {name}: {fm_ops.launches} fused_matmul, "
                f"{fa_ops.launches} flash and {ls_ops.launches} scan "
                f"launches (expected {want}, 0 and 0)")
        if not all(r.done and len(r.out) == MAX_NEW for r in out):
            raise SystemExit(f"rwkv {name}: not every request finished")
        for r in out:
            toks = np.asarray(r.out)
            if not ((toks >= 0) & (toks < cfg.vocab)).all():
                raise SystemExit(f"rwkv {name}: request {r.rid} emitted "
                                 f"{r.out}")
        fm.update(fm_ops.launches_by_shape)
        runs[name], stats[name] = out, st
    same = [r.out for r in runs["run"]] == [r.out for r in runs["run_wave"]]
    st = stats["run"]
    line = {"phase": "rwkv_serve", "slots": SLOTS, "requests": len(reqs),
            "waves": waves, "tokens": st["tokens"],
            "decode_steps": st["decode_steps"], "wall_s": st["wall_s"],
            "tok_per_s": st["tok_per_s"],
            "mean_occupancy": st["mean_occupancy"],
            "run_wave_wall_s": stats["run_wave"]["wall_s"],
            "gemm_launches_per_call": per_call, "run_eq_run_wave": same,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "sample_out": runs["run"][0].out[:8]}
    if not same:
        raise SystemExit(f"rwkv serve: {line}")
    return line, fm


def scan_inputs(shape, dt, seed: int):
    """q/k/v in ``dt``, w and u in fp32.  decay ``model``: the RWKV6 decay
    of a log-log weight uniform in its clip [-8, 2]; ``clip``: exp(-e^2),
    the strongest decay the model allows, in every position."""
    import torch
    b, s, h, dk, dv, decay = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k = (torch.randn(b, s, h, dk, generator=gen, device="cuda").to(dt)
            for _ in range(2))
    v = torch.randn(b, s, h, dv, generator=gen, device="cuda").to(dt)
    if decay == "clip":
        w = torch.full((b, s, h, dk), CLIP_W, device="cuda")
    else:
        r = torch.rand(b, s, h, dk, generator=gen, device="cuda")
        w = torch.exp(-torch.exp(-8.0 + 10.0 * r))
    u = torch.randn(h, dk, generator=gen, device="cuda")
    return q, k, v, w, u


def scan_vs_plain(path_shapes, smoke_shape) -> dict:
    """``linear_scan`` against ``linear_scan_chunked`` at the same chunk
    (SAFE_CHUNK), in bf16 and fp32, both variants: the forward's path
    shapes, SMOKE, ragged S (37, 1000) and the decay clip in every position
    at S = 37, 2048 and 8192.  Stops on the first miss (LS_RTOL).  Returns
    {(shape, variant, dtype): (max abs err, max row-relative err)}."""
    import torch
    from repro_torch.kernels.costs import SAFE_CHUNK
    from repro_torch.kernels.linear_scan import ops as ls_ops
    from repro_torch.kernels.linear_scan import ref as ls_ref
    shapes = list(path_shapes) + [
        smoke_shape, (2, 37, 64, 64, 64, "model"),
        (2, 1000, 64, 64, 64, "model"), (2, 37, 64, 64, 64, "clip"),
        (2, 2048, 64, 64, 64, "clip"), (1, 8192, 64, 64, 64, "clip")]
    out = {}
    for i, shape in enumerate(shapes):
        for variant in ("rwkv6", "gla"):
            for dname, dt in (("bfloat16", torch.bfloat16),
                              ("float32", torch.float32)):
                q, k, v, w, u = scan_inputs(shape, dt, seed=20 + i)
                u = u if variant == "rwkv6" else None
                o = ls_ops.linear_scan(q, k, v, w, u=u, chunk=SAFE_CHUNK)
                want = ls_ref.linear_scan_chunked(q, k, v, w, u=u,
                                                  chunk=SAFE_CHUNK)
                scale = ls_ref.linear_scan_chunked(
                    q.float().abs(), k.float().abs(), v.float().abs(), w,
                    u=None if u is None else u.abs(),
                    chunk=SAFE_CHUNK).amax(-1)
                diff = (o.float() - want.float()).abs()
                err = float(diff.max())
                rel = float((diff.amax(-1) / scale.clamp_min(1e-30)).max())
                finite = bool(torch.isfinite(o).all())
                if not (finite and rel <= LS_RTOL[dname]):
                    raise SystemExit(
                        f"scan vs plain: {shape} {variant} {dname}: max err "
                        f"{err}, row-relative {rel} (<= {LS_RTOL[dname]}), "
                        f"finite {finite}")
                out[(shape, variant, dname)] = (err, rel)
                del q, k, v, w, u, o, want, scale, diff
    return out


def gemm_vs_plain(shapes, gen, name_of) -> dict:
    """``fused_matmul`` against ``fused_matmul_ref`` at every (m, n, k,
    x dtype, epilogue) of ``shapes`` in bf16 and fp32 (TOL); max err by
    (m, n, k, epilogue, dtype).  ``name_of(shape)`` labels a miss."""
    import torch
    from repro_torch.kernels.fused_matmul import ops, ref
    errs = {}
    for shape in shapes:
        m, n, k, _, spec = shape
        for dname, dt in (("bfloat16", torch.bfloat16),
                          ("float32", torch.float32)):
            x, w, epi = make_inputs(m, n, k, spec, dt, gen)
            y = ops.fused_matmul(x, w, epilogue=epi, out_dtype=dt)
            want = ref.fused_matmul_ref(x, w, epilogue=epi, out_dtype=dt)
            err = float((y.float() - want.float()).abs().max())
            if not err <= TOL[dname]:
                raise SystemExit(f"kernel vs plain: {name_of(shape)} {dname} "
                                 f"max err {err} > {TOL[dname]}")
            errs[(m, n, k, spec, dname)] = err
            del x, w, epi, y, want
    return errs


def small_rwkv_parity() -> dict:
    """RWKV6 SMOKE in fp32 on the same weights: the forward and the
    stateful prefill + 4 decode steps on the card against the same code on
    the CPU (the kernels' plain versions, which the CPU tests hold against
    the JAX package).  Forward within 1e-4; the steps against the
    full-sequence forward within 3e-3, the reference's serving tolerance."""
    import numpy as np
    import torch
    from repro_torch.configs import get_smoke
    from repro_torch.core import tapir
    from repro_torch.models.base import get_model
    from repro_torch.serve import ServeConfig
    cfg = dataclasses.replace(get_smoke("rwkv6_7b"), compute_dtype="float32")
    cpu = get_model(cfg, device="cpu",
                    generator=torch.Generator().manual_seed(0))
    params = {"embed": cpu.embed.data, "ln_f": cpu.ln_f.data,
              "lm_head": cpu.lm_head.data,
              "blocks": {k: v.data for k, v in cpu.blocks.items()}}
    s, new = 24, 4
    toks = np.random.default_rng(7).integers(1, cfg.vocab, (2, s + new))
    toks = toks.astype(np.int32)
    res = {}
    for dev, target in (("cpu", "cpu"), ("cuda", "gpu")):
        model = cpu if dev == "cpu" else get_model(cfg, device=dev,
                                                   params=params)
        with tapir.use(ServeConfig(target=target).tapir_config()):
            full = model.forward({"tokens": torch.as_tensor(toks,
                                                            device=dev)})
            cache = model.init_cache(2, s + new)
            lg, cache = model.prefill(torch.as_tensor(toks[:, :s],
                                                      device=dev), cache)
            outs = [lg]
            for t in range(new):
                lg, cache = model.decode_step(
                    torch.as_tensor(toks[:, s + t:s + t + 1], device=dev),
                    cache)
                outs.append(lg)
        res[dev] = (full.float().cpu(), [o.float().cpu() for o in outs])
    (f_cpu, o_cpu), (f_gpu, o_gpu) = res["cpu"], res["cuda"]
    return {"phase": "small_rwkv_parity", "config": cfg.name,
            "compute_dtype": cfg.compute_dtype,
            "forward_max_abs_err": float((f_cpu - f_gpu).abs().max()),
            "forward_tolerance": 1e-4,
            "serve_vs_forward_max_abs_err": max(
                float((o - f_gpu[:, s - 1 + i]).abs().max())
                for i, o in enumerate(o_gpu)),
            "serve_tolerance": 3e-3,
            "serve_card_vs_cpu_max_abs_err": max(
                float((a - b).abs().max()) for a, b in zip(o_cpu, o_gpu)),
            "finite": bool(torch.isfinite(f_gpu).all())}


def scan_bound(key) -> tuple:
    """(bound ms, what bounds it) of one scan launch: q/k/v/o in their
    dtype and w in fp32, each moved once, over the memory rate; the
    chunked FLOPs of ``scan_cost`` over the fp32 rate (the kernel computes
    in fp32 FMAs)."""
    from repro_torch.kernels.costs import scan_cost
    b, s, h, dk, dv, dname, _, chunk = key
    eb = 2 if "bfloat16" in dname else 4
    nbytes = eb * b * s * h * (2 * dk + 2 * dv) + 4 * b * s * h * dk
    flops = scan_cost(b, s, h, dk, dv, eb, "kernel", chunk=chunk)["flops"]
    t_bytes, t_ops = nbytes / HBM_BW, flops / PEAK_FLOPS["float32"]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def scan_times(ls_fwd, errs) -> list:
    """Per path shape of the scan (bf16, as the forward runs it): the
    kernel and its plain version, each one launch timed alone with L2
    flushed, median of 10, and the roofline bound.  No single PyTorch call
    computes this function (no library op runs a gated linear-attention
    scan), so ``library_ms`` is None."""
    import torch
    from repro_torch.kernels.linear_scan import ops as ls_ops
    from repro_torch.kernels.linear_scan import ref as ls_ref
    out = []
    for key, launches in sorted(ls_fwd.items()):
        b, s, h, dk, dv, dname, variant, chunk = key
        shape = (b, s, h, dk, dv, "model")
        q, k, v, w, u = scan_inputs(shape, torch.bfloat16, seed=1)
        u = u if variant == "rwkv6" else None
        ms = time_ms(lambda: ls_ops.linear_scan(q, k, v, w, u=u,
                                                chunk=chunk))
        plain = time_ms(lambda: ls_ref.linear_scan_chunked(
            q, k, v, w, u=u, chunk=chunk))
        bound, by = scan_bound(key)
        out.append({
            "name": f"linear_scan[forward B={b} S={s} H={h} Dk={dk} "
                    f"Dv={dv} {variant} chunk={chunk}]",
            "route": "cuda", "source": LS_SOURCE, "replaces": LS_REPLACES,
            "launches": launches,
            "max_abs_err": errs[(shape, variant, "bfloat16")][0],
            "ms": ms, "plain_ms": plain, "bound_ms": bound, "bound_by": by,
            "library_ms": None})
        del q, k, v, w, u
    return out


def library_fn(x, w, epi, spec):
    """One PyTorch call computing the same function: ``torch.matmul`` for
    a bare product, ``torch.addmm`` for one added full operand, else
    None.  A yardstick only; the port never calls it."""
    import torch
    if not spec:
        return lambda: torch.matmul(x, w)
    if len(spec) == 1 and spec[0][0] == "add" and spec[0][1] == "full":
        res = epi[0][1][0]
        return lambda: torch.addmm(res, x, w)
    return None


def gemm_times(shapes, launches, errs, gen, name_of) -> list:
    """Per GEMM path shape, bf16: the kernel, its plain version and the
    library yardstick (``torch.matmul`` for a bare product, ``torch.addmm``
    for one added full operand, else none; never called by the port), each
    timed alone with L2 flushed, and the roofline bound: x, w, the output
    and the epilogue operands moved once, 2mnk bf16 FLOPs."""
    import torch
    from repro_torch.kernels.fused_matmul import kernel, ops, ref
    out = []
    for shape in shapes:
        m, n, k, _, spec = shape
        dt = torch.bfloat16
        p = kernel.plan(n, k, dt)
        x, w, epi = make_inputs(m, n, k, spec, dt, gen)
        ms = time_ms(lambda: ops.fused_matmul(x, w, epilogue=epi,
                                              out_dtype=dt))
        plain = time_ms(lambda: ref.fused_matmul_ref(x, w, epilogue=epi,
                                                     out_dtype=dt))
        lib_fn = library_fn(x, w, epi, spec)
        lib_ms = time_ms(lib_fn) if lib_fn is not None else None
        nbytes = (x.numel() + w.numel() + m * n) * x.element_size() + sum(
            v.numel() * v.element_size() for _, vals, _ in epi for v in vals)
        t_bytes = nbytes / HBM_BW
        t_ops = 2.0 * m * n * k / PEAK_FLOPS["bfloat16"]
        out.append({
            "name": name_of(shape),
            "route": "cuda", "source": SOURCE, "replaces": REPLACES,
            "launches": launches[shape],
            "max_abs_err": errs[(m, n, k, spec, "bfloat16")],
            "ms": ms, "plain_ms": plain,
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": lib_ms,
            "design": f"TMA ring + wgmma m64n{p.bn}k16, 128x{p.bn} tile, "
                      + (f"{p.split}-way fixed-order cluster split-K, "
                         if p.split > 1 else "no split-K, ")
                      + f"{p.stages} stages",
            "plan": p._asdict(),
            "tflops": 2.0 * m * n * k / (ms * 1e-3) / 1e12,
            "shape": [m, n, k, spec]})
        del x, w, epi
    return out


def forward_tflops(entries) -> float:
    """Achieved TFLOP/s over the forward's GEMM shapes, each weighted by
    its launches."""
    fwd = [e for e in entries if "forward " in e["name"]]
    flops = sum(e["tflops"] * e["ms"] * e["launches"] for e in fwd)
    return flops / max(sum(e["ms"] * e["launches"] for e in fwd), 1e-30)


def gemm_tflops(entries) -> dict:
    """Achieved TFLOP/s of each timed GEMM shape (2mnk over its time)."""
    return {e["name"]: e["tflops"] for e in entries}


def wrapper_host_us(shapes, gen) -> dict:
    """Host µs of one ``fused_matmul`` call (shape checks, the plan,
    padding, two tensor maps encoded, the ctypes launch) and of one
    ``torch.matmul`` beside it, at decode shapes (``host_us``)."""
    import torch
    from repro_torch.kernels.fused_matmul import ops
    out = {}
    for m, n, k in shapes:
        x = torch.randn(m, k, generator=gen, device="cuda").bfloat16()
        w = torch.randn(k, n, generator=gen, device="cuda").bfloat16()
        out[f"fused_matmul m={m} n={n} k={k}"] = host_us(
            lambda: ops.fused_matmul(x, w))
        out[f"torch.matmul m={m} n={n} k={k}"] = host_us(
            lambda: torch.matmul(x, w))
        del x, w
    return out


def ptxas_summary(report: str) -> dict:
    """Registers, stack frame, spills and static shared memory of every
    kernel in nvcc's ``-Xptxas -v`` report."""
    import re
    out, name = {}, None
    for line in report.splitlines():
        hit = re.search(r"Function properties for _Z(\d+)(\w+)", line)
        if hit:   # the mangled name: its length, then the name
            size, rest = int(hit[1]), hit[2]
            arg = re.match(r"ILi(\d+)E", rest[size:])
            name = rest[:size] + (f"<{arg[1]}>" if arg else "")
            out[name] = {}
            continue
        if name is None:
            continue
        hit = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores,"
                        r" (\d+) bytes spill loads", line)
        if hit:
            out[name].update(stack=int(hit[1]), spill_stores=int(hit[2]),
                             spill_loads=int(hit[3]))
        hit = re.search(r"Used (\d+) registers", line)
        if hit:
            out[name]["registers"] = int(hit[1])
        hit = re.search(r"(\d+) bytes smem", line)
        if hit:
            out[name]["static_smem"] = int(hit[1])
    return out


def rwkv_phases() -> list:
    """Phases 11-17 on RWKV6-7B at full width (all 32 layers, random
    weights from seed 0); returns their entries of the kernels line."""
    import torch
    from repro_torch.configs import get_config, get_smoke
    from repro_torch.models.base import get_model
    cfg = get_config("rwkv6_7b")
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    model = get_model(cfg, device="cuda",
                      generator=torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())

    # -- 11. forward and loss ----------------------------------------------
    fwd, batch, logits, fm_fwd, ls_fwd = rwkv_forward_phase(model, cfg)
    fwd.update(init_s=init_s, params=n_params)
    emit(fwd)
    # -- 12. guarantees: region = per-op, stateful prefill / decode ---------
    gua, fm_pf, fm_dec = rwkv_guarantees(model, cfg, batch, logits)
    emit(gua)
    del batch, logits
    # -- 13. padded-wave serving --------------------------------------------
    srv, fm_srv = rwkv_serve(model, cfg)
    emit(srv)

    # -- 14. the scan kernel against its plain version ----------------------
    smoke = get_smoke("rwkv6_7b")
    path = sorted({(k[0], k[1], k[2], k[3], k[4], "model") for k in ls_fwd})
    ls_errs = scan_vs_plain(path, (2, 28, smoke.n_heads, smoke.hd,
                                   smoke.hd, "model"))
    emit({"phase": "scan_vs_plain", "cases": len(ls_errs),
          "row_relative_tolerance": LS_RTOL,
          "max_abs_err": {f"{k[0]}/{k[1]}/{k[2]}": e[0]
                          for k, e in ls_errs.items()},
          "row_relative_err": {f"{k[0]}/{k[1]}/{k[2]}": e[1]
                               for k, e in ls_errs.items()}})

    # -- 15. the GEMM kernel at every RWKV path shape ------------------------
    launches, phase_of = collections.Counter(), {}
    for tag, cnt in (("forward", fm_fwd), ("prefill", fm_pf),
                     ("decode", fm_dec), ("serve", fm_srv)):
        launches.update(cnt)
        for s_ in cnt:
            phase_of.setdefault(s_, tag)
    shapes = sorted(launches, key=lambda s_: (s_[0], s_[1], s_[2]))
    gen = torch.Generator(device="cuda").manual_seed(3)
    def name_of(s_):
        return (f"fused_matmul[rwkv {phase_of[s_]} "
                f"{rwkv_label(s_[1], s_[2], s_[4], cfg)} "
                f"m={s_[0]} n={s_[1]} k={s_[2]}]")

    gemm_errs = gemm_vs_plain(shapes, gen, name_of)
    emit({"phase": "rwkv_gemm_vs_plain", "shapes": len(shapes),
          "tolerance": TOL,
          "max_err_bf16": max(v for k, v in gemm_errs.items()
                              if k[-1] == "bfloat16"),
          "max_err_fp32": max(v for k, v in gemm_errs.items()
                              if k[-1] == "float32")})

    # -- 16. SMOKE on the card against the CPU ------------------------------
    par = small_rwkv_parity()
    emit(par)
    if not (par["finite"]
            and par["forward_max_abs_err"] <= par["forward_tolerance"]
            and par["serve_vs_forward_max_abs_err"] <= par["serve_tolerance"]):
        raise SystemExit(f"small rwkv parity: {par}")

    # -- 17. times at the path shapes ----------------------------------------
    del model
    torch.cuda.empty_cache()
    ls_entries = scan_times(ls_fwd, ls_errs)
    timed = [s_ for s_ in shapes if phase_of[s_] in ("forward", "decode")]
    gemm_entries = gemm_times(timed, launches, gemm_errs, gen, name_of)
    fwd_gemm = [e for e in gemm_entries if "rwkv forward" in e["name"]]
    emit({"phase": "scan_times", "launches_per_forward": sum(ls_fwd.values()),
          "forward_scan_ms": sum(e["ms"] * e["launches"]
                                 for e in ls_entries),
          "forward_scan_bound_ms": sum(e["bound_ms"] * e["launches"]
                                       for e in ls_entries),
          "forward_gemm_ms": sum(e["ms"] * e["launches"] for e in fwd_gemm),
          "forward_gemm_bound_ms": sum(e["bound_ms"] * e["launches"]
                                       for e in fwd_gemm),
          "forward_gemm_tflops": forward_tflops(fwd_gemm),
          "gemm_tflops": gemm_tflops(gemm_entries),
          "wrapper_host_us": wrapper_host_us(
              [(4, cfg.d_model, cfg.d_model), (4, 64, cfg.d_model)], gen)})
    return gemm_entries + ls_entries


def qwen_phases() -> list:
    """Phases 2-10 on qwen2.5-3b; returns their entries of the kernels
    line.  Everything they allocate is local, so it is freed on return."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import tapir
    from repro_torch.kernels.fused_matmul import ops, ref
    from repro_torch.models.base import get_model
    from repro_torch.serve import Request, ServeConfig, ServingEngine

    # -- 2. serve at full width ------------------------------------------
    cfg = get_config("qwen2_5_3b")
    t0 = time.perf_counter()
    model = get_model(cfg, device="cuda",
                      generator=torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    eng = ServingEngine(model, batch=SLOTS, max_len=MAX_LEN,
                        cfg=ServeConfig(target="gpu"), device="cuda")
    reqs = requests(cfg.vocab, seed=0)

    def check_launches(tag: str, run_out, st: dict, mode: str = "tapir"):
        """Launch counts of the run just made (the counts were zeroed just
        before it): every decode step launched the kernel once per GEMM of
        the step, and every matmul node of ``mode``'s programs is bound to
        the kernel's impl.  A decode step runs every slot (m = SLOTS); a
        prefill runs a bucket of at least 8 rows and its head one row, so
        m = SLOTS marks decode.  The per-op control does not fuse: QKV and
        gate|up are 3 and 2 launches there."""
        if not all(r.done and len(r.out) == MAX_NEW for r in run_out):
            raise SystemExit(f"{tag}: not every request finished")
        by_shape = dict(ops.launches_by_shape)
        per_step = (4 if mode == "tapir" else 7) * cfg.n_layers + 1
        decode = sum(c for s, c in by_shape.items() if s[0] == SLOTS)
        if decode != per_step * st["decode_steps"]:
            raise SystemExit(f"{tag}: {decode} decode kernel launches for "
                             f"{st['decode_steps']} decode steps (expected "
                             f"{per_step} per step)")
        impls = {n.schedule.impl for key, g in tapir.cached_graphs().items()
                 if key[-3] == mode
                 for n in g.nodes.values() if n.op == "matmul"}
        want = {"fused_kernel" if mode == "tapir" else "opaque"}
        if impls != want:
            raise SystemExit(f"{tag}: matmul nodes bound to {impls}")
        return by_shape, decode, per_step, impls

    reset_counts()
    out = eng.run(reqs)
    launches = ops.launches
    st = dict(eng.last_stats)
    by_shape, decode_launches, per_step, impls = check_launches(
        "serve", out, st)
    for r in out:
        toks = np.asarray(r.out)
        if not ((toks >= 0) & (toks < cfg.vocab)).all():
            raise SystemExit(f"serve: request {r.rid} emitted {r.out}")
    emit({"phase": "serve", "layers": cfg.n_layers, "d_model": cfg.d_model,
          "init_s": init_s, "tokens": st["tokens"],
          "decode_steps": st["decode_steps"], "tok_per_s": st["tok_per_s"],
          "step_p50_ms": st["step_p50"] * 1e3,
          "step_p95_ms": st["step_p95"] * 1e3,
          "ttft_p50_ms": st["ttft_p50"] * 1e3, "wall_s": st["wall_s"],
          "prefix_hits": st["prefix_hits"],
          "prefix_tokens_saved": st["prefix_tokens_saved"],
          "mean_occupancy": st["mean_occupancy"],
          "kernel_launches": launches,
          "decode_kernel_launches": decode_launches,
          "launches_per_decode_step": per_step,
          "matmul_impls": sorted(impls),
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
          "sample_out": out[0].out[:8]})
    # fused_matmul launches of every main-path run by shape, and the path
    # that first launched each shape
    fm_paths = collections.Counter(by_shape)
    phase_of = {s: "decode" if s[0] == SLOTS else "prefill" for s in by_shape}

    # -- 3. the dense forward at full width --------------------------------
    fwd, batch, logits, fm_fwd, fa_fwd = forward_phase(model, cfg)
    emit(fwd)

    # -- 4. its guarantees -------------------------------------------------
    emit(forward_guarantees(model, cfg, batch, logits))
    del logits, batch

    # -- 5. padded-cache prefill and decode --------------------------------
    pad, fm_pf, fa_pf, fm_dec = padded_phase(model, cfg)
    emit(pad)
    for tag, cnt in (("forward", fm_fwd), ("padded prefill", fm_pf),
                     ("padded decode", fm_dec)):
        fm_paths.update(cnt)
        for s_ in cnt:
            phase_of.setdefault(s_, tag)
    flash_paths = [("forward", s_, c) for s_, c in fa_fwd.items()] + [
        ("padded prefill", s_, c) for s_, c in fa_pf.items()]
    flash_paths = [(ph, s_[:6] + (s_[7],), c) for ph, s_, c in flash_paths]

    # -- 6. kernel vs plain at every path shape ----------------------------
    gen = torch.Generator(device="cuda").manual_seed(1)
    shapes = sorted(fm_paths, key=lambda s: (s[0], s[1], s[2]))
    errs = gemm_vs_plain(shapes, gen,
                         lambda s_: f"{label(s_[1], s_[2], cfg)} m={s_[0]}")
    x, w, _ = make_inputs(SLOTS, cfg.d_model, cfg.d_model, (), torch.bfloat16,
                          gen)
    row = torch.randn(cfg.d_model, generator=gen, device="cuda")
    full = torch.randn(SLOTS, cfg.d_model, generator=gen,
                       device="cuda").bfloat16()
    chain = [("add", [row], {"dtype": "float32"}), ("gelu", [], {}),
             ("sub", [full], {"head_pos": 1, "dtype": "bfloat16"}),
             ("mul", [row], {})]
    y = ops.fused_matmul(x, w, epilogue=chain, out_dtype=torch.bfloat16)
    want = ref.fused_matmul_ref(x, w, epilogue=chain, out_dtype=torch.bfloat16)
    chain_err = float((y.float() - want.float()).abs().max())
    if not chain_err <= TOL["bfloat16"]:
        raise SystemExit(f"kernel vs plain: chain max err {chain_err}")
    emit({"phase": "kernel_vs_plain", "shapes": len(shapes),
          "tolerance": TOL, "max_err_bf16": max(
              v for kk, v in errs.items() if kk[-1] == "bfloat16"),
          "max_err_fp32": max(
              v for kk, v in errs.items() if kk[-1] == "float32"),
          "chain_max_err": chain_err})
    fa_errs, fa_rels = flash_vs_plain([s_ for _, s_, _ in flash_paths])
    emit({"phase": "flash_vs_plain", "shapes": len(fa_errs) // 2,
          "tolerance": FA_TOL, "row_relative_tolerance": FA_RTOL,
          "max_err": {f"{s_}/{d}": e for (s_, d), e in fa_errs.items()},
          "row_relative_err": {f"{s_}/{d}": e
                               for (s_, d), e in fa_rels.items()}})

    # -- 7. the paths on the card against the CPU, at SMOKE size ----------
    par = small_parity()
    emit(par)
    if not (par["finite"] and par["max_abs_err"] <= par["tolerance"]):
        raise SystemExit(f"small parity: {par}")
    fpar = small_forward_parity()
    emit(fpar)
    if not (fpar["finite"]
            and fpar["forward_max_abs_err"] <= fpar["forward_tolerance"]
            and fpar["serve_vs_forward_max_abs_err"]
            <= fpar["serve_tolerance"]):
        raise SystemExit(f"small forward parity: {fpar}")

    # -- 8. port-internal guarantees on the card --------------------------
    def fresh():
        return [Request(rid=r.rid, prompt=r.prompt.copy(), max_new=r.max_new)
                for r in reqs]

    def counted_run(tag: str, engine, wave: bool = False,
                    mode: str = "tapir"):
        reset_counts()
        res = engine.run_wave(fresh()) if wave else engine.run(fresh())
        st_ = dict(engine.last_stats)
        _, decode, per, _ = check_launches(tag, res, st_, mode)
        return res, st_, {"decode_steps": st_["decode_steps"],
                          "decode_launches": decode,
                          "launches_per_decode_step": per,
                          "step_p50_ms": st_["step_p50"] * 1e3}

    def engine(**kw):
        return ServingEngine(model, batch=SLOTS, max_len=MAX_LEN,
                             cfg=ServeConfig(target="gpu", **kw),
                             device="cuda")

    cont, warm, cont_n = counted_run("rerun", eng)
    wave, _, wave_n = counted_run("run_wave", eng, wave=True)
    noprefix, _, noprefix_n = counted_run(
        "no_prefix", engine(prefix_sharing=False))
    opaque, _, opaque_n = counted_run("opaque", engine(mode="opaque"),
                                      mode="opaque")
    same_wave = [a.out for a in cont] == [b.out for b in wave]
    same_prefix = [a.out for a in cont] == [b.out for b in noprefix]
    same_opaque = [a.out for a in cont] == [b.out for b in opaque]
    same_first = [a.out for a in cont] == [b.out for b in out]
    emit({"phase": "guarantees", "run_eq_run_wave": same_wave,
          "prefix_eq_no_prefix": same_prefix,
          "opaque_eq_tapir": same_opaque, "rerun_eq_first": same_first,
          "launches": {"rerun": cont_n, "run_wave": wave_n,
                       "no_prefix": noprefix_n, "opaque": opaque_n},
          "warm_tok_per_s": warm["tok_per_s"],
          "warm_step_p50_ms": warm["step_p50"] * 1e3,
          "warm_step_p95_ms": warm["step_p95"] * 1e3,
          "warm_ttft_p50_ms": warm["ttft_p50"] * 1e3,
          "warm_prefix_hits": warm["prefix_hits"]})
    if not (same_wave and same_prefix and same_opaque and same_first):
        raise SystemExit("guarantees: outputs differ")

    # -- 9. where a slot decode step's time goes ---------------------------
    prof = profile_decode(model, eng)
    emit(prof)
    if not prof["finite"]:
        raise SystemExit("profile: non-finite logits at full width")

    # -- 10. times at the path shapes -------------------------------------
    entries = gemm_times(
        shapes, fm_paths, errs, gen,
        lambda s_: f"fused_matmul[{phase_of[s_]} {label(s_[1], s_[2], cfg)} "
                   f"m={s_[0]} n={s_[1]} k={s_[2]}]")
    step = [e for e in entries if e["name"].startswith("fused_matmul[decode")]
    emit({"phase": "times", "decode_step_gemm_ms": sum(
        e["ms"] * (cfg.n_layers if "head" not in e["name"] else 1)
        for e in step), "decode_step_gemm_bound_ms": sum(
        e["bound_ms"] * (cfg.n_layers if "head" not in e["name"] else 1)
        for e in step), "decode_step_library_ms": sum(
        (e["library_ms"] or 0.0)
        * (cfg.n_layers if "head" not in e["name"] else 1) for e in step),
        "forward_gemm_tflops": forward_tflops(entries),
        "gemm_tflops": gemm_tflops(entries),
        "wrapper_host_us": wrapper_host_us(
            [(SLOTS, cfg.d_model, cfg.d_model),
             (SLOTS, cfg.d_model, cfg.d_ff)], gen)})

    fa_entries = flash_times(flash_paths, fa_errs)
    emit({"phase": "flash_times",
          "launches_per_forward": sum(fa_fwd.values()),
          "launches_per_prefill": sum(fa_pf.values()),
          "forward_flash_ms": sum(e["ms"] * e["launches"] for e in fa_entries
                                  if "[forward" in e["name"]),
          "forward_flash_bound_ms": sum(
              e["bound_ms"] * e["launches"] for e in fa_entries
              if "[forward" in e["name"]),
          "forward_sdpa_ms": sum(e["library_ms"] * e["launches"]
                                 for e in fa_entries
                                 if "[forward" in e["name"])})

    return entries + fa_entries


def gemm_times_again(out_path: str, plan) -> int:
    """The ``--gemm-times`` mode: time the GEMM again at every bf16 path
    shape that a full run counted (the ``shape`` of each GEMM entry of
    the kernels line in its output ``out_path``), without building a
    model.  One JSON line per shape: the device time (``ms``), the time
    with the host's issue time inside (``ms_with_issue``), the library
    yardstick, max |kernel - plain|; then the card line.  ``plan``
    (``Plan``) replaces ``kernel.plan`` at every shape (a plan sweep;
    only ``ms`` and the error are measured then)."""
    import torch
    from repro_torch.kernels.fused_matmul import kernel, ops, ref
    with open(out_path) as f:
        entries = next(json.loads(line)["kernels"] for line in f
                       if line.startswith('{"kernels"'))
    if plan is not None:
        kernel.plan = lambda n, k, dtype: plan
    dt = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(3)
    for e in entries:
        if "shape" not in e:
            continue
        m, n, k, spec = e["shape"]
        spec = tuple(tuple(st) for st in spec)
        x, w, epi = make_inputs(m, n, k, spec, dt, gen)
        fn = lambda: ops.fused_matmul(x, w, epilogue=epi,  # noqa: E731
                                      out_dtype=dt)
        row = {"name": e["name"], "launches": e["launches"],
               "bound_ms": e["bound_ms"],
               "plan": getattr(kernel, "plan", lambda *a: None)(n, k, dt)}
        try:
            want = ref.fused_matmul_ref(x, w, epilogue=epi, out_dtype=dt)
            row["max_abs_err"] = float((fn().float() - want.float())
                                       .abs().max())
        except RuntimeError as exc:   # a plan the kernel refuses
            emit({**row, "error": str(exc)})
            continue
        row["ms"] = time_ms(fn)
        if plan is None:
            row["ms_with_issue"] = time_ms(fn, hold=False)
            lib_fn = library_fn(x, w, epi, spec)
            row["library_ms"] = time_ms(lib_fn) if lib_fn else None
        row["tflops"] = 2.0 * m * n * k / (row["ms"] * 1e-3) / 1e12
        emit(row)
        del x, w, epi, want
    print(card_line(), flush=True)
    return 0


def main() -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--gemm-times", metavar="OUT",
                    help="time the GEMM again at the path shapes of the "
                         "full run whose output is OUT, and stop")
    ap.add_argument("--src", help="with --gemm-times: another checkout's "
                                  "src directory, whose wrapper is timed")
    ap.add_argument("--plan", metavar="BN,SPLIT,STAGES",
                    help="with --gemm-times: launch this plan at every "
                         "shape in place of kernel.plan")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card", file=sys.stderr)
        return 2
    if args.gemm_times:
        if args.src:
            sys.path.insert(0, os.path.abspath(args.src))
        plan = None
        if args.plan:
            from repro_torch.kernels.fused_matmul.kernel import Plan
            plan = Plan(*(int(v) for v in args.plan.split(",")))
        return gemm_times_again(args.gemm_times, plan)
    from repro_torch.core import tapir
    from repro_torch.kernels.build import REPORTS
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.fused_matmul import kernel
    from repro_torch.kernels.linear_scan import kernel as ls_kernel

    # fp32 products in full fp32 on both sides (state it, don't inherit it)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    # -- 1. device and build ---------------------------------------------
    card = card_line()
    t0 = time.perf_counter()
    # one nvcc per source, all started together; ptxas reports on stderr
    with ThreadPoolExecutor(3) as pool:
        libs = list(pool.map(lambda mod: mod.build(verbose=True),
                             (kernel, fa_kernel, ls_kernel)))
    gemm_ptxas = ptxas_summary(REPORTS["fused_matmul"])
    emit({"phase": "build", "card": card,
          "kind": torch.cuda.get_device_name(0),
          "build_s": time.perf_counter() - t0,
          "libraries": [lib.name for lib in libs],
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "gemm_ptxas": gemm_ptxas})
    spills = {k: v for k, v in gemm_ptxas.items()
              if k.startswith("gemm_bf16") and v.get("spill_stores", 0)}
    if spills or not any(k.startswith("gemm_bf16") for k in gemm_ptxas):
        raise SystemExit(f"build: the bf16 GEMM spills or is missing: "
                         f"{gemm_ptxas}")

    # -- 2-10. qwen2.5-3b ----------------------------------------------------
    entries = qwen_phases()
    # the region programs hold their models (bound methods): drop them
    # before the next model is built
    tapir.clear_cache()
    torch.cuda.empty_cache()
    emit({"phase": "release", "elapsed_s": time.perf_counter() - t_start,
          "allocated_gb": torch.cuda.memory_allocated() / 1e9})

    # -- 11-17. RWKV6-7B ---------------------------------------------------
    entries += rwkv_phases()

    emit({"kernels": entries})
    emit({"phase": "done", "elapsed_s": time.perf_counter() - t_start})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
