"""Training CLI: the per-op training step of the port on one device.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2_5_3b \
        --device cuda --steps 3 --batch 2 --seq 2048

The port of the JAX package's ``launch/train.py`` on its path without a
mesh: model (random weights from ``--seed``) -> ``TokenPipeline`` (the
synthetic source, the same bytes as the reference's) -> ``make_train_step``
-> a loop over the steps.  Runs on the card unless ``--device cpu``; the
default remat is ``full``, since at 2 x 2048 tokens of qwen2.5-3b nothing
else fits one 80 GB card.  ``--arch rwkv6_7b`` trains RWKV6 the same way
(its scans' backward is the hand-written backward kernel on the card),
at the config's full 32 layers: its fp32 parameters, gradients and AdamW
moments alone (120 GB) exceed one 80 GB card, so on one card it runs out
of memory; ``chip_smoke.py``'s ``rwkv_train`` phase trains it at full
width and 12 layers.  The reference's launcher has no depth option, and
neither has this one.  Prints one JSON line: ``steps``, ``tok_per_s``
(after the first step, which builds the kernels and traces the regions),
``first_loss``, ``last_loss`` and ``losses``.

``--arch zamba2_7b`` trains Zamba2 (the GLA scan's backward, flash's at
head dim 112, the tied head's two gradients); at the full 81 layers its
fp32 state (106 GB) does not fit one card either, and ``chip_smoke.py``'s
Zamba2 train phase trains it at a probed depth.

``--arch granite_moe_1b_a400m`` trains the MoE family (the expert FFN's
backward on the GEMM kernel's grouped dX / dW routes) at its full 24
layers; ``--arch moonshot_v1_16b_a3b`` is accepted, but its full 48
layers (28.05 B parameters, ~450 GB of fp32 weights, gradients and AdamW
moments) do not fit one card, and ``chip_smoke.py``'s ``moonlight_train``
phase trains it at full width and a probed depth.

``--capture-step`` trains with the captured step
(``train/region_step.py``: the whole update one region program, the
backward derived by ``core/autodiff.py``, the state donated); its default
remat is ``auto`` (the roofline per node), as in the reference, and the
JSON line adds ``grad_meta``'s counts (``n_fwd``, ``n_bwd``, ``remat``).

Checkpoints (``checkpoint/ckpt.py``, the reference's format), with the
reference's flags and defaults: after each step the state is saved when
the count of steps done is a multiple of ``--ckpt-every`` (25), keeping the
newest 3, asynchronously (the leaves are copied to host memory first), and
the loop waits for the last write at the end.  ``--ckpt-dir`` defaults to
``repro_ckpt`` under the temp directory (the reference's
``/tmp/repro_ckpt``).  ``--resume`` restores the latest checkpoint into
the freshly built state in place, or cold-starts with the reference's log
line, then runs from that step to ``--steps``; the JSON line's ``steps``
counts the steps run and ``start_step`` where they began.  The steps run
through ``dist/fault.py``'s ``FaultTolerantLoop``, as the reference's do:
the line adds its ``failures`` and ``straggler_steps``.

``--arch whisper_small`` and ``--arch internvl2_76b`` train the
encoder-decoder and VLM families: ``batch_at`` adds every input of
``model.input_specs(seq, batch, "train")`` that the token pipeline lacks
(Whisper's ``frames``, InternVL's ``image_embeds``) as zeros of the
spec's shape and dtype on the device, as the reference's launcher does.
InternVL2-76B's 80 layers do not fit one card (~274 GB of fp32 weights
alone); ``chip_smoke.py``'s VLM train phase trains it at a probed depth.
"""
from __future__ import annotations

import argparse
import json
import logging
import os
import tempfile
import time

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import ARCH_IDS, get_config, get_smoke
from repro_torch.data import DataConfig, TokenPipeline, to_device
from repro_torch.dist.fault import FaultTolerantLoop
from repro_torch.models.base import get_model, resolve_device
from repro_torch.optim import AdamWConfig
from repro_torch.core import tapir
from repro_torch.train import (TrainConfig, init_state,
                               make_region_train_step, make_train_step)

log = logging.getLogger("repro_torch.train")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="qwen2_5_3b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--mode", default="tapir", choices=["tapir", "opaque"])
    ap.add_argument("--target", default=None, choices=["cpu", "gpu"],
                    help="the schedule's cost profile (default: the "
                         "device's)")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--remat", default=None,
                    choices=["none", "dots", "full", "auto"],
                    help="default: full per op, auto with --capture-step")
    ap.add_argument("--capture-step", action="store_true",
                    help="the region-captured training step")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (default: repro_ckpt under "
                         "the temp directory)")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--resume", action="store_true",
                    help="restore the latest checkpoint, then run on to "
                         "--steps")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    remat = args.remat or ("auto" if args.capture_step else "full")
    dev = resolve_device(args.device)
    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    model = get_model(cfg, device=dev, generator=gen)

    opt_cfg = AdamWConfig(lr=args.lr, total_steps=args.steps,
                          warmup_steps=max(args.steps // 10, 1))
    tcfg = TrainConfig(mode=args.mode, remat=remat,
                       microbatches=args.microbatches, target=args.target)
    make_step = make_region_train_step if args.capture_step \
        else make_train_step
    step_fn = make_step(model, opt_cfg, tcfg)
    state = init_state(model, opt_cfg)
    pipe = TokenPipeline(DataConfig(seq_len=args.seq,
                                    global_batch=args.batch,
                                    vocab=cfg.vocab, seed=args.seed))

    ckpt = CheckpointManager(
        args.ckpt_dir or os.path.join(tempfile.gettempdir(), "repro_ckpt"),
        keep_n=3, every=args.ckpt_every)
    start_step = 0
    if args.resume:
        try:
            state, start_step, _ = ckpt.restore_latest(state)
            log.info("resumed from step %d", start_step)
        except FileNotFoundError:
            log.info("no checkpoint found; cold start")

    def batch_at(step: int) -> dict:
        b = to_device(pipe.batch_at(step), dev)
        for k, spec in model.input_specs(args.seq, args.batch,
                                         "train").items():
            if k not in b:       # the stub modality frontends: zeros
                b[k] = torch.zeros(spec.shape, dtype=spec.dtype, device=dev)
        return b

    starts = []

    def timed_step(state, batch):
        starts.append(time.perf_counter())
        return step_fn(state, batch)

    loop = FaultTolerantLoop(timed_step, ckpt, batch_at)
    state, stats = loop.run(state, start_step, args.steps)
    losses = stats.losses
    # the first step builds the kernels and traces the regions: untimed
    timed = stats.steps_run - 1
    dt = time.perf_counter() - starts[1] if timed > 0 else float("nan")
    tok_s = timed * args.batch * args.seq / dt if timed > 0 else None
    line = {"steps": stats.steps_run, "start_step": start_step,
            "tok_per_s": tok_s,
            "first_loss": losses[0] if losses else None,
            "last_loss": losses[-1] if losses else None, "losses": losses,
            "failures": stats.failures,
            "straggler_steps": stats.straggler_steps}
    if args.capture_step:
        metas = [g.grad_meta for g in tapir.cached_graphs().values()
                 if getattr(g, "grad_meta", None)]
        if metas:
            line["grad_meta"] = {k: metas[-1][k]
                                 for k in ("n_fwd", "n_bwd", "remat")}
    print(json.dumps(line))
    return state, losses


if __name__ == "__main__":
    main()
