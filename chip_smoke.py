#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure exits non-zero:

1. device and build — the card's name and power limit, then the kernel
   library built by nvcc from the checkout's CUDA source;
2. serve — qwen2.5-3b at full width (all 36 layers, random weights from a
   seed) through ``ServingEngine.run``: 4 slots, max_len 512, 6 requests of
   48-200 prompt tokens (3 sharing a 128-token prefix), 16 new tokens each.
   The kernel launch counts are zeroed just before and read just after;
3. kernel vs plain — ``fused_matmul`` against ``fused_matmul_ref`` on the
   card at every (m, n, k, epilogue) the serve phase launched, in bf16 and
   fp32, plus a chain with unary, row and full stages, ``head_pos=1`` and a
   bf16 stage cast;
4. small parity — the slot path on the card against the same path on the
   CPU (the kernels' plain versions) at the SMOKE config in fp32: logits
   of a prefill and three decode steps within 1e-3;
5. port-internal guarantees on the card — ``run`` equals ``run_wave``,
   prefix sharing on equals off, and the per-op control
   (``mode="opaque"``: no fusion, every GEMM its own launch) equals the
   fused path, per request, token for token; each of these runs has its
   launch counts zeroed before it and checked after it;
6. profile — full-occupancy decode steps under ``torch.profiler``: host
   wall time, device time by kernel, device busy share, finite logits;
7. times — per path shape: the kernel, its plain version, ``torch.matmul``
   / ``torch.addmm`` (the library yardstick, never called by the port) and
   the roofline bound.

Then the kernels line, the card line, and the result line last.  Exits
non-zero without printing a result when no card is present or the
repository is not beside this file.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}   # H100 SXM, dense
HBM_BW = 3.35e12
SLOTS, MAX_LEN, MAX_NEW = 4, 512, 16
SOURCE = "src/repro_torch/kernels/fused_matmul/csrc/fused_matmul.cu"
REPLACES = "src/repro/kernels/fused_matmul/kernel.py:64"
TOL = {"bfloat16": 0.1, "float32": 2e-3}   # max |kernel - plain|


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


def time_ms(fn, iters: int = 10) -> float:
    """Median device time of one call, each launch measured alone with L2
    flushed before it (the serving path finds its weights cold: 36 layers
    of weights stream through the 50 MB L2 between two uses of one).  The
    flush READS 64 MB, so it leaves no dirty lines whose write-back the
    timed call would pay for."""
    import torch
    flush = torch.zeros(64 << 20, dtype=torch.uint8, device="cuda")
    fn()
    times = []
    for _ in range(iters):
        flush.max()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


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
    by_name = {}
    for ev in prof.key_averages():
        # the device's own events (kernels, copies), not the host ops that
        # launched them: counting both would count each kernel twice
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            by_name[ev.key] = (ev.self_device_time_total / steps / 1e3,
                               ev.count // steps)
    busy = sum(ms for ms, _ in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    return {"phase": "profile_decode", "slots": SLOTS,
            "finite": bool(torch.isfinite(logits).all()),
            "logits_shape": list(logits.shape),
            "kv_len": MAX_LEN // 2, "steps": steps,
            "wall_ms_per_step": bare * 1e3,
            "wall_ms_per_step_profiled": wall * 1e3,
            "device_ms_per_step": busy,
            "device_busy_share": busy / (bare * 1e3),
            "kernels_per_step": sum(c for _, c in by_name.values()),
            "top": [{"name": k[:60], "ms_per_step": ms, "calls_per_step": c}
                    for k, (ms, c) in top]}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card", file=sys.stderr)
        return 2
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.core import tapir
    from repro_torch.kernels.fused_matmul import kernel, ops, ref
    from repro_torch.models.base import get_model
    from repro_torch.serve import Request, ServeConfig, ServingEngine

    # fp32 products in full fp32 on both sides (state it, don't inherit it)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- 1. device and build ---------------------------------------------
    card = card_line()
    t0 = time.perf_counter()
    lib = kernel.build(verbose=True)   # ptxas report on stderr
    emit({"phase": "build", "card": card,
          "kind": torch.cuda.get_device_name(0),
          "build_s": time.perf_counter() - t0, "library": lib.name,
          "torch": torch.__version__, "cuda": torch.version.cuda})

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

    ops.reset_counts()
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

    # -- 3. kernel vs plain at every path shape ----------------------------
    gen = torch.Generator(device="cuda").manual_seed(1)
    shapes = sorted(by_shape, key=lambda s: (s[0], s[1], s[2]))
    errs = {}
    for (m, n, k, _, spec) in shapes:
        for dname, dt in (("bfloat16", torch.bfloat16),
                          ("float32", torch.float32)):
            x, w, epi = make_inputs(m, n, k, spec, dt, gen)
            y = ops.fused_matmul(x, w, epilogue=epi, out_dtype=dt)
            want = ref.fused_matmul_ref(x, w, epilogue=epi, out_dtype=dt)
            err = float((y.float() - want.float()).abs().max())
            if not err <= TOL[dname]:
                raise SystemExit(f"kernel vs plain: {label(n, k, cfg)} m={m} "
                                 f"{dname} max err {err} > {TOL[dname]}")
            errs[(m, n, k, spec, dname)] = err
            del x, w, epi, y, want
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

    # -- 4. the slot path on the card against the CPU, at SMOKE size -------
    par = small_parity()
    emit(par)
    if not (par["finite"] and par["max_abs_err"] <= par["tolerance"]):
        raise SystemExit(f"small parity: {par}")

    # -- 5. port-internal guarantees on the card --------------------------
    def fresh():
        return [Request(rid=r.rid, prompt=r.prompt.copy(), max_new=r.max_new)
                for r in reqs]

    def counted_run(tag: str, engine, wave: bool = False,
                    mode: str = "tapir"):
        ops.reset_counts()
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

    # -- 6. where a decode step's time goes --------------------------------
    prof = profile_decode(model, eng)
    emit(prof)
    if not prof["finite"]:
        raise SystemExit("profile: non-finite logits at full width")

    # -- 7. times at the path shapes --------------------------------------
    entries = []
    for (m, n, k, xdt, spec) in shapes:
        dt = torch.bfloat16
        x, w, epi = make_inputs(m, n, k, spec, dt, gen)
        ms = time_ms(lambda: ops.fused_matmul(x, w, epilogue=epi,
                                              out_dtype=dt))
        plain = time_ms(lambda: ref.fused_matmul_ref(x, w, epilogue=epi,
                                                     out_dtype=dt))
        if not spec:
            lib_fn = lambda: torch.matmul(x, w)   # noqa: E731
        elif len(spec) == 1 and spec[0][0] == "add" and spec[0][1] == "full":
            res = epi[0][1][0]
            lib_fn = lambda: torch.addmm(res, x, w)   # noqa: E731
        else:
            lib_fn = None
        lib_ms = time_ms(lib_fn) if lib_fn is not None else None
        nbytes = (x.numel() + w.numel() + m * n) * x.element_size() + sum(
            v.numel() * v.element_size() for _, vals, _ in epi for v in vals)
        flops = 2.0 * m * n * k
        t_bytes, t_ops = nbytes / HBM_BW, flops / PEAK_FLOPS["bfloat16"]
        phase = "decode" if m == SLOTS else "prefill"
        entries.append({
            "name": f"fused_matmul[{phase} {label(n, k, cfg)} m={m} n={n} "
                    f"k={k}]",
            "route": "cuda", "source": SOURCE, "replaces": REPLACES,
            "launches": by_shape[(m, n, k, xdt, spec)],
            "max_abs_err": errs[(m, n, k, spec, "bfloat16")],
            "ms": ms, "plain_ms": plain,
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": lib_ms})
        del x, w, epi
    step = [e for e in entries if e["name"].startswith("fused_matmul[decode")]
    emit({"phase": "times", "decode_step_gemm_ms": sum(
        e["ms"] * (cfg.n_layers if "head" not in e["name"] else 1)
        for e in step), "decode_step_gemm_bound_ms": sum(
        e["bound_ms"] * (cfg.n_layers if "head" not in e["name"] else 1)
        for e in step), "decode_step_library_ms": sum(
        (e["library_ms"] or 0.0)
        * (cfg.n_layers if "head" not in e["name"] else 1) for e in step)})

    emit({"kernels": entries})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
