"""Serving CLI: batched greedy generation with the port's ServingEngine.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2_5_3b \
        --device cuda --requests 8 --prompt-len 32 --max-new 16

Runs on the card unless ``--device cpu``; weights are random, drawn from
``--seed``.  Prints one JSON report line.  ``--arch internvl2_76b`` serves
text-only prompts through the dense family's slots, as the reference's
launcher does; ``--arch whisper_small`` raises: its prefill needs audio
frames, which no request carries.

``--program-cache-dir DIR`` keeps the region programs in an on-disk store
(``repro_torch.cache``; ``--cache-mode read`` probes it without writing):
a second process on a warm store compiles none (the report's ``cache``
block).  ``--runs N``, for measurement, serves the same requests N times
on one engine; the report's ``runs`` gives each run's time to first
token, wall time and where its host seconds went (``cold``: tracing,
building programs, the store's share of that, CUDA-graph capture, and
the rest), so the first run's cold start stands beside a warm run of the
same process.

Faults, with the reference's flags: ``--ckpt-dir DIR`` keeps slot
checkpoints (every ``--ckpt-every`` decode steps, and on demand), from
which a recovery restores; ``--inject-crash STEP`` fails that decode step
once; ``--inject-straggle STEP`` slows ``--straggle-repeat`` steps from
there by ``--straggle-delay`` seconds each.  With any of them the report
adds a ``fault`` block (failures, restores, checkpoints, shed rounds,
flagged steps) and the step p95.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import time

import numpy as np
import torch

from repro_torch.cache.disk import CACHE_MODES
from repro_torch.configs import ARCH_IDS, get_config, get_smoke
from repro_torch.dist.fault import Fault, ScriptedFaultInjector
from repro_torch.models.base import get_model, resolve_device
from repro_torch.serve import Request, ServeConfig, ServingEngine
from repro_torch.serve.engine import CACHE_KEYS


def _costs(st: dict) -> dict:
    """Where a run's wall seconds went outside its kernels' own time."""
    out = {k: st.get(k, 0.0) for k in ("trace_s", "pipeline_s", "l2_s",
                                       "graph_capture_s")}
    out["graph_captures"] = st.get("graph_captures", 0)
    out["rest_s"] = st["wall_s"] - (out["trace_s"] + out["pipeline_s"]
                                    + out["graph_capture_s"])
    return out


def main(argv=None):
    t_main = time.perf_counter()
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="qwen2_5_3b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--mode", default="tapir", choices=["tapir", "opaque"])
    ap.add_argument("--ckpt-dir", default=None,
                    help="slot-state checkpoint directory (enables restore)")
    ap.add_argument("--ckpt-every", type=int, default=0,
                    help="decode steps between periodic slot checkpoints")
    ap.add_argument("--inject-crash", type=int, default=None, metavar="STEP",
                    help="fail the decode step at this index once")
    ap.add_argument("--inject-straggle", type=int, default=None,
                    metavar="STEP", help="start straggling at this step")
    ap.add_argument("--straggle-delay", type=float, default=0.05)
    ap.add_argument("--straggle-repeat", type=int, default=8)
    ap.add_argument("--prefix-len", type=int, default=0,
                    help="tokens of system-prompt prefix shared by every "
                         "request (0 = fully distinct prompts)")
    ap.add_argument("--no-prefix-sharing", action="store_true",
                    help="disable the shared-prefix page index (baseline)")
    ap.add_argument("--priorities", default=None,
                    help="comma-separated per-request priorities 0..9 "
                         "(cycled)")
    ap.add_argument("--deadline-s", type=float, default=None,
                    help="per-request SLO deadline (seconds from start); "
                         "implies --admit-policy slo")
    ap.add_argument("--admit-policy", default=None,
                    choices=["strict", "reject", "slo"])
    ap.add_argument("--program-cache-dir", default=None,
                    help="persistent program store (L2); a warm dir makes "
                         "restarts compile zero region programs")
    ap.add_argument("--cache-mode", default="readwrite", choices=CACHE_MODES)
    ap.add_argument("--runs", type=int, default=1,
                    help="for measurement: serve the requests this many "
                         "times on one engine, so that the first run's cold "
                         "start stands beside a warm run of the same "
                         "process (the report's first fields are the first "
                         "run's)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    if cfg.family == "encdec":
        raise ValueError(
            f"--arch {args.arch}: the encoder-decoder family is not served "
            f"from token prompts: its prefill needs the audio frames "
            f"(WhisperED.prefill(tokens, cache, frames)), which no request "
            f"carries, as in the reference, whose engine calls prefill "
            f"without them")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    t0 = time.perf_counter()
    model = get_model(cfg, device=dev, generator=gen)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    init_s = time.perf_counter() - t0

    rng = np.random.default_rng(args.seed)
    prios = ([int(p) for p in args.priorities.split(",")]
             if args.priorities else [0])
    prefix = rng.integers(1, cfg.vocab, size=args.prefix_len).astype(np.int32)
    suffix_len = max(1, args.prompt_len - args.prefix_len)
    reqs = [Request(rid=i,
                    prompt=np.concatenate(
                        [prefix, rng.integers(1, cfg.vocab, size=suffix_len)
                         .astype(np.int32)]),
                    max_new=args.max_new,
                    priority=prios[i % len(prios)],
                    deadline_s=args.deadline_s)
            for i in range(args.requests)]

    faults = {}
    if args.inject_crash is not None:
        faults[args.inject_crash] = Fault("crash")
    if args.inject_straggle is not None:
        faults[args.inject_straggle] = Fault("straggle",
                                             delay_s=args.straggle_delay)
    injector = ScriptedFaultInjector(faults, repeat=args.straggle_repeat) \
        if faults else None

    admit = args.admit_policy or ("slo" if args.deadline_s else "strict")
    eng = ServingEngine(model, batch=args.batch, max_len=args.max_len,
                        device=dev,
                        cfg=ServeConfig(mode=args.mode,
                                        target="gpu" if dev.type == "cuda"
                                        else "cpu",
                                        fault_injector=injector,
                                        admit_policy=admit,
                                        prefix_sharing=not args.no_prefix_sharing,
                                        ckpt_dir=args.ckpt_dir,
                                        ckpt_every=args.ckpt_every,
                                        program_cache_dir=args.program_cache_dir,
                                        cache_mode=args.cache_mode))
    runs = []
    for i in range(max(1, args.runs)):
        batch = reqs if i == 0 else [
            Request(rid=r.rid, prompt=r.prompt.copy(), max_new=r.max_new,
                    priority=r.priority, deadline_s=r.deadline_s)
            for r in reqs]
        t0 = time.time()
        res = eng.run(batch)
        dt_i = time.time() - t0
        st_i = dict(eng.last_stats)
        outs = [list(map(int, r.out)) for r in res]
        runs.append((res, dt_i, st_i, hashlib.sha256(
            json.dumps(outs).encode()).hexdigest()))
    out, dt, st, out_sha = runs[0]
    total_new = sum(len(r.out) for r in out)
    report = {
        "device": (torch.cuda.get_device_name(0) if dev.type == "cuda"
                   else "cpu"),
        "requests": len(out),
        "new_tokens": total_new,
        "tok_per_s": total_new / max(dt, 1e-9),
        "sample_out": out[0].out[:8],
        "ttft_p50_ms": round(st.get("ttft_p50", 0.0) * 1e3, 3),
        "ttft_p95_ms": round(st.get("ttft_p95", 0.0) * 1e3, 3),
        "queue_wait_p50_ms": round(st.get("queue_wait_p50", 0.0) * 1e3, 3),
        "queue_wait_p95_ms": round(st.get("queue_wait_p95", 0.0) * 1e3, 3),
        "step_p50_ms": round(st.get("step_p50", 0.0) * 1e3, 3),
        "step_p95_ms": round(st.get("step_p95", 0.0) * 1e3, 3),
        "prefix_hits": st.get("prefix_hits", 0),
        "prefix_tokens_saved": st.get("prefix_tokens_saved", 0),
        "preemptions": st.get("preemptions", 0),
        "rejected": st.get("rejected", 0),
        "out_sha256": out_sha,
        "init_s": init_s,
        "wall_s": st["wall_s"],
        "cold": _costs(st),
    }
    if args.program_cache_dir:
        report["cache"] = {k: st.get(k, 0) for k in CACHE_KEYS}
    if injector is not None or args.ckpt_dir:
        report["fault"] = {k: st.get(k, 0) for k in
                           ("failures", "restores", "checkpoints",
                            "shed_rounds", "straggler_steps")}
        report["fault"]["l2_quarantined"] = st.get("l2_quarantined", 0)
    if len(runs) > 1:
        report["runs"] = [
            {"ttft_p50_ms": round(s_.get("ttft_p50", 0.0) * 1e3, 3),
             "wall_s": s_["wall_s"], "out_sha256": h, "cold": _costs(s_),
             **{k: s_.get(k, 0) for k in CACHE_KEYS}}
            for _, _, s_, h in runs]
    report["process_s"] = time.perf_counter() - t_main
    print(json.dumps(report))
    return out


if __name__ == "__main__":
    main()
