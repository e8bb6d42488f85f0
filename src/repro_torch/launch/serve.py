"""Serving CLI: batched greedy generation with the port's ServingEngine.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2_5_3b \
        --device cuda --requests 8 --prompt-len 32 --max-new 16

Runs on the card unless ``--device cpu``; weights are random, drawn from
``--seed``.  Prints one JSON report line.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_config, get_smoke
from repro_torch.models.base import get_model, resolve_device
from repro_torch.serve import Request, ServeConfig, ServingEngine


def main(argv=None):
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
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    model = get_model(cfg, device=dev, generator=gen)

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

    admit = args.admit_policy or ("slo" if args.deadline_s else "strict")
    eng = ServingEngine(model, batch=args.batch, max_len=args.max_len,
                        device=dev,
                        cfg=ServeConfig(mode=args.mode,
                                        target="gpu" if dev.type == "cuda"
                                        else "cpu",
                                        admit_policy=admit,
                                        prefix_sharing=not args.no_prefix_sharing))
    t0 = time.time()
    out = eng.run(reqs)
    dt = time.time() - t0
    total_new = sum(len(r.out) for r in out)
    st = eng.last_stats
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
    }
    print(json.dumps(report))
    return out


if __name__ == "__main__":
    main()
