"""The paper's Fig. 3 on the port: the four benchmark networks trained under
stock-XLA-style lowering (``mode="opaque"``) and TapirXLA-style lowering
(``mode="tapir"``), step time measured on ``--device``.

    PYTHONPATH=src python -m repro_torch.launch.fig3 --device cuda
    PYTHONPATH=src python -m repro_torch.launch.fig3 --device cpu --batch 2 --iters 1

The port of the JAX package's ``benchmarks/fig3.py``, with the same
protocol: the same inputs (``make_benches``: batch 64 by default, NCF at
8x the batch, LSTM2 with per-frame labels), made from ``--seed`` with
numpy; weights drawn from ``--seed`` too; a step is SGD, ``p -= 1e-3 *
g`` (torch autograd, then an in-place update under ``no_grad``); opaque
first, then tapir, for each net.  Each net and mode is timed from a clean
program cache: one first step (it traces and compiles), ``WARMUP``
steps, then ``--iters`` steps, each ended by a synchronise; the step time
is their median.  ratio = opaque / tapir; the last row is their geometric
mean.  ``--ablate-serialization`` runs tapir mode without small-task
serialization.

The reference times one ``jax.jit`` program per step; here the step runs
eagerly (region programs are never replayed as CUDA graphs under grad), so
the ratio compares the two modes' launch streams as well as their kernels.
Prints the table, and writes every row as JSON to ``--json``.
"""
from __future__ import annotations

import argparse
import json
import math
import time

import numpy as np
import torch

from repro_torch.core import tapir
from repro_torch.core.schedule import CPU_COST_MODEL, H100_COST_MODEL
from repro_torch.models.base import resolve_device
from repro_torch.models.paper_nets import (LSTM1, LSTM2, NCFConfig,
                                          get_paper_net)
from repro_torch.optim import tree_leaves

LR = 1e-3
WARMUP = 2   #: untimed steps after the first, as the reference's _timeit


def make_benches(batch: int, seed: int = 42, device="cuda") -> list:
    """``[(label, net name, model, batch dict), ...]`` in the table's
    order, with the reference's shapes and value ranges."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def normal(*shape):
        return t(rng.standard_normal(shape, dtype=np.float32))

    def ints(shape, hi):
        return t(rng.integers(0, hi, shape).astype(np.int64))

    ncf = NCFConfig()
    nb = batch * 8   # NCF rows are tiny; the paper uses large batches
    cnn_b = {"x": normal(batch, 28, 28, 1), "y": ints((batch,), 10)}
    l1_b = {"x": normal(batch, LSTM1.seq_len, LSTM1.input_dim),
            "y": ints((batch,), LSTM1.n_classes)}
    l2_b = {"x": normal(batch, LSTM2.seq_len, LSTM2.input_dim),
            "y": ints((batch, LSTM2.seq_len), LSTM2.n_classes)}
    ncf_b = {"users": ints((nb,), ncf.n_users),
             "items": ints((nb,), ncf.n_items), "y": ints((nb,), 2)}
    return [("CNN", "cnn", get_paper_net("cnn"), cnn_b),
            ("LSTM1", "lstm1", get_paper_net("lstm1"), l1_b),
            ("LSTM2", "lstm2", get_paper_net("lstm2"), l2_b),
            ("NCF", "ncf", get_paper_net("ncf"), ncf_b)]


def tapir_config(mode: str, device, ablate_serialization: bool = False
                 ) -> tapir.TapirConfig:
    """The step's config: the cost model of the device it runs on."""
    cm = H100_COST_MODEL if torch.device(device).type == "cuda" \
        else CPU_COST_MODEL
    return tapir.TapirConfig(mode=mode, cost_model=cm,
                             ablate_serialization=ablate_serialization)


def init_params(model, seed: int, device):
    """The net's parameters from ``seed``, as leaves that require grad."""
    dev = resolve_device(device)
    params = model.init(torch.Generator(device=dev).manual_seed(seed), dev)
    for p in tree_leaves(params):
        p.requires_grad_(True)
    return params


def value_and_grad(model, params, batch, cfg: tapir.TapirConfig):
    """(loss, the gradient of every leaf of ``params`` in
    ``tree_leaves`` order) by autograd, under ``cfg``."""
    with tapir.use(cfg):
        loss = model.loss(params, batch)
        grads = torch.autograd.grad(loss, tree_leaves(params))
    return loss.detach(), grads


def make_step(model, params, batch, cfg: tapir.TapirConfig, lr: float = LR):
    """One SGD step of ``model`` on ``batch``: ``value_and_grad``, then
    ``p -= lr * g`` in place.  Returns the loss (not synchronised)."""
    leaves = tree_leaves(params)

    def step():
        loss, grads = value_and_grad(model, params, batch, cfg)
        with torch.no_grad():
            for p, g in zip(leaves, grads):
                p.sub_(lr * g)
        return loss
    return step


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def bench_network(label: str, model, batch, mode: str,
                  ablate_serialization: bool = False, iters: int = 5,
                  seed: int = 0, device="cuda") -> dict:
    """Time one net in one mode from a clean program cache (see the module
    docstring)."""
    tapir.clear_cache()
    params = init_params(model, seed, device)
    step = make_step(model, params, batch,
                     tapir_config(mode, device, ablate_serialization))
    _sync(device)
    t0 = time.perf_counter()
    loss = float(step())
    t_first = time.perf_counter() - t0
    for _ in range(WARMUP):
        step()
    _sync(device)
    times, losses = [], []
    for _ in range(iters):
        t0 = time.perf_counter()
        loss_t = step()
        _sync(device)
        times.append(time.perf_counter() - t0)
        losses.append(float(loss_t))
    srt = sorted(times)
    return {"net": label, "mode": mode,
            "ablate_serialization": ablate_serialization,
            "t_step_s": srt[len(srt) // 2], "step_s": times,
            "t_first_call_s": t_first, "first_loss": loss,
            "loss": losses[-1] if losses else loss}


def geomean(ratios) -> float:
    return float(math.exp(sum(math.log(r) for r in ratios) / len(ratios)))


def run(batch: int = 64, iters: int = 5, seed: int = 42,
        ablate_serialization: bool = False, device="cuda") -> dict:
    """Print the table: opaque then tapir for each net.  Returns
    ``{"rows", "ratios", "geomean_ratio", ...}``."""
    rows, ratios = [], {}
    print(f"{'net':8s} {'opaque(s)':>12s} {'tapir(s)':>12s} {'ratio':>7s}")
    for label, _, model, b in make_benches(batch, seed, device):
        r_op = bench_network(label, model, b, "opaque", iters=iters,
                             seed=seed, device=device)
        r_tp = bench_network(label, model, b, "tapir", ablate_serialization,
                             iters=iters, seed=seed, device=device)
        ratios[label] = r_op["t_step_s"] / r_tp["t_step_s"]
        rows += [r_op, r_tp]
        print(f"{label:8s} {r_op['t_step_s']:12.4f} "
              f"{r_tp['t_step_s']:12.4f} {ratios[label]:7.2f}")
    geo = geomean(ratios.values())
    print(f"{'geomean':8s} {'':12s} {'':12s} {geo:7.2f}")
    return {"rows": rows, "ratios": ratios, "geomean_ratio": geo,
            "batch": batch, "iters": iters, "warmup": WARMUP,
            "ablate_serialization": ablate_serialization,
            "device": str(device)}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--ablate-serialization", action="store_true")
    ap.add_argument("--json", default=None, help="write the rows here")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    res = run(args.batch, args.iters, args.seed, args.ablate_serialization,
              args.device)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(res, f, indent=1)
    return res


if __name__ == "__main__":
    main()
