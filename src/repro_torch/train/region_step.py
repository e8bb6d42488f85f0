"""The captured training step: the whole update (loss -> gradients ->
AdamW) as ONE region program, compiled once and replayed every step — the
port of the JAX package's ``train/region_step.py``.

Against the per-op step (``train/step.py``) it differs in where the
computation is seen, never in what is computed:

* the forward traces through ``tapir.parallel_region`` (the layer stack
  unrolled by ``scan_layers``, every weight read from the parameter
  handles the step passes in), the backward is derived node by node by
  ``core.autodiff`` over the optimized forward, and the pass pipeline then
  runs over the JOINT forward + backward graph;
* recompute versus store is the cost model's remat arm per node
  (``TrainConfig.remat``: ``auto`` is the roofline), not a checkpoint
  wrapped around each layer;
* the parameters, the AdamW moments, the step counter and the error-
  feedback residuals are DONATED: the program writes them in place
  (three ``leaf_update`` nodes a leaf sharing one call, which updates
  ``p``, ``mu`` and ``nu`` in place), so they keep their storage from step
  to step;
* microbatches are unrolled into the program with the per-op step's
  accumulation order (the first microbatch's fp32 gradients, then each
  later one added in order, then divided by their count);
* ``compress_pod_grads`` folds int8 quantize-dequantize with error
  feedback (``optim/compress.py``) into the program, two nodes a leaf, the
  fp32 residual donated.  On one card nothing is sent over a pod axis:
  the gradients that AdamW reads are the dequantized ones.

``step(state, batch)`` runs at top level under ``torch.no_grad()``; the
parameters stay frozen and nothing outside the VJP nodes records autograd.
The state passed in is CONSUMED (written in place), as in the reference.
"""
from __future__ import annotations

import torch

from ..core import autodiff, tapir
from ..core.ir import TensorType
from ..core.tapir import _flatten, _unflatten, use
from ..optim import AdamWConfig
from ..optim.adamw import (clip_scale, global_norm_leaves, leaf_update,
                           step_factors, tree_map)
from ..optim.compress import compress_int8, decompress_int8
from .step import TrainConfig

__all__ = ["make_region_train_step", "init_ef_state"]


def _bump_step(s):
    return s + 1


def _ef_quantize(g, r):
    """int8 quantize-dequantize with error feedback: (the dequantized
    gradient in ``g``'s dtype, the new fp32 residual)."""
    gf = g.to(torch.float32) + r
    q, scale = compress_int8(gf)
    deq = decompress_int8(q, scale, gf.shape)
    return deq.to(g.dtype), gf - deq


def _acc_mean_losses(*ls, m):
    """The microbatch losses summed in order and divided by ``m`` — the
    per-op step's accumulation."""
    acc = ls[0]
    for l in ls[1:]:
        acc = acc + l
    return acc / m


def _acc_mean_grads(*gs, m):
    """A leaf's microbatch gradients summed in fp32 in order, divided by
    ``m`` — the per-op step's accumulation."""
    acc = gs[0].to(torch.float32)
    for g in gs[1:]:
        acc = acc + g.to(torch.float32)
    return acc / m


def _leaf_update(p, g, mu, nu, scale, lr, bc1, bc2, *, b1, b2, eps,
                 weight_decay, decay, scratch):
    """``optim.leaf_update`` as a node function: ``p``, ``mu`` and ``nu``
    updated in place and returned.  ``scratch``: the gradient is this
    call's own buffer (a fresh value nothing reads after), which AdamW may
    use as its scratch; else a copy is."""
    if not scratch and g.dtype == torch.float32:
        g = g.clone()
    leaf_update(p, g, mu, nu, scale, lr, bc1, bc2, b1, b2, eps,
                weight_decay, decay)
    return p, mu, nu


def init_ef_state(params) -> dict:
    """fp32 error-feedback residuals, one per parameter leaf, all zero."""
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def _donating_update(reg, p_h, g_h, mu_h, nu_h, scale_h, lr_h, bc1_h, bc2_h,
                     opt_cfg: AdamWConfig, scratch: bool):
    """The three in-place AdamW nodes of one leaf, (p2, mu2, nu2): one
    shared ``_leaf_update`` call, each node donating its own buffer."""
    g = reg.g
    nids = tuple(reg.nid_of(h) for h in
                 (p_h, g_h, mu_h, nu_h, scale_h, lr_h, bc1_h, bc2_h))
    static = (("b1", opt_cfg.b1), ("b2", opt_cfg.b2), ("eps", opt_cfg.eps),
              ("weight_decay", opt_cfg.weight_decay),
              ("decay", p_h.ndim >= 2), ("scratch", scratch))
    outs = []
    # output i writes over its OWN source: p2 over p, mu2 over mu, nu2
    # over nu; the gradient is read by all three and never donated
    for i, (src, don) in enumerate(zip((p_h, mu_h, nu_h),
                                       (nids[0], nids[2], nids[3]))):
        t = TensorType(tuple(src.shape), src.ttype.dtype)
        nid = g.add("pyfunc", nids, t, pdims=tuple(range(len(t.shape))),
                    fn=_leaf_update, static=static, out=i, donates=don)
        outs.append(reg.handle(nid))
    return tuple(outs)


def _microbatch(batch: dict, i: int, k: int) -> dict:
    """Rows ``[i b/k, (i+1) b/k)`` of every batch entry, the per-op step's
    split.  Made when its microbatch is traced: a handle made earlier would
    not survive the previous microbatch's in-place optimization."""
    mb = {}
    for key, x in batch.items():
        b = x.shape[0]
        if b % k:
            raise ValueError(f"batch {b} % microbatches {k} != 0")
        mb[key] = x[i * (b // k):(i + 1) * (b // k)]
    return mb


def make_region_train_step(model, opt_cfg: AdamWConfig,
                           cfg: TrainConfig = TrainConfig()):
    """``step(state, batch) -> (state, metrics)`` with ``state =
    {"params", "opt"}`` (plus ``"ef"``, from ``init_ef_state``, when
    ``cfg.compress_pod_grads``) and ``metrics = {"loss", "lr",
    "grad_norm"}``.  The first call captures and compiles the joint
    forward + backward program; every later call with the same shapes
    replays it (one dict probe and one call of the emitted program)."""
    tap = cfg.tapir_config()
    policy = cfg.remat
    compress = bool(cfg.compress_pod_grads)

    @tapir.parallel_region(name="train_step")
    def _captured(state, batch, aux):
        # ``aux`` (the memoized RoPE tables) is bound as argument leaves
        # so that every region input comes from an argument, which the
        # replay needs; the model fetches the same objects itself
        del aux
        reg = tapir._active_region()
        params = state["params"]
        leaves, spec = _flatten(params)

        if cfg.microbatches > 1:
            k = cfg.microbatches
            losses, per_mb = [], []
            for i in range(k):
                mb = _microbatch(batch, i, k)
                # the earlier microbatches' handles must survive this
                # call's in-place optimization: kept, then rebound
                live = losses + [h for row in per_mb for h in row]
                if live:
                    li, gi, live = autodiff.grad(
                        model.loss(mb, params), leaves, policy=policy,
                        keep=live)
                    it = iter(live)
                    losses = [next(it) for _ in losses]
                    per_mb = [[next(it) for _ in row] for row in per_mb]
                else:
                    li, gi = autodiff.grad(model.loss(mb, params), leaves,
                                           policy=policy)
                losses.append(li)
                per_mb.append(gi)
            loss = tapir.lift(_acc_mean_losses, *losses, m=k)
            grads = [tapir.lift(_acc_mean_grads, *(row[j] for row in per_mb),
                                m=k)
                     for j in range(len(leaves))]
        else:
            loss, grads = autodiff.grad(model.loss(batch, params), leaves,
                                        policy=policy)

        new_ef = None
        if compress:
            deq, new_ef = [], []
            for g_h, r_h in zip(grads, _flatten(state["ef"])[0]):
                ins = (reg.nid_of(g_h), reg.nid_of(r_h))
                t_g = TensorType(tuple(g_h.shape), g_h.ttype.dtype)
                t_r = TensorType(tuple(r_h.shape), r_h.ttype.dtype)
                pd = tuple(range(len(t_g.shape)))
                deq.append(reg.handle(reg.g.add(
                    "pyfunc", ins, t_g, pdims=pd, fn=_ef_quantize, out=0)))
                # the residual is written over its input (donated), after
                # the dequantized gradient's node read it
                new_ef.append(reg.handle(reg.g.add(
                    "pyfunc", ins, t_r, pdims=pd, fn=_ef_quantize, out=1,
                    donates=ins[1])))
            grads = deq

        gnorm = tapir.lift(global_norm_leaves, *grads)
        scale = tapir.lift(clip_scale, gnorm, max_norm=opt_cfg.grad_clip)
        step_in = state["opt"]["step"]
        step2 = reg.handle(reg.g.add(
            "pyfunc", (reg.nid_of(step_in),), TensorType((), "int32"),
            fn=_bump_step, donates=reg.nid_of(step_in)))
        lr, bc1, bc2 = tapir.lift(step_factors, step2, cfg=opt_cfg)

        g_nids = [reg.nid_of(h) for h in grads]
        p2, mu2, nu2 = [], [], []
        for p_h, g_h, g_nid, mu_h, nu_h in zip(
                leaves, grads, g_nids, _flatten(state["opt"]["mu"])[0],
                _flatten(state["opt"]["nu"])[0]):
            # AdamW may use the gradient as its scratch when it is a fresh
            # value of its own: a node function's result read by no other
            # leaf's update
            scratch = (reg.g.nodes[g_nid].op == "pyfunc"
                       and g_nids.count(g_nid) == 1)
            a, b, c = _donating_update(reg, p_h, g_h, mu_h, nu_h, scale, lr,
                                       bc1, bc2, opt_cfg, scratch)
            p2.append(a)
            mu2.append(b)
            nu2.append(c)

        new_state = {"params": _unflatten(spec, p2),
                     "opt": {"mu": _unflatten(spec, mu2),
                             "nu": _unflatten(spec, nu2), "step": step2}}
        if new_ef is not None:
            new_state["ef"] = _unflatten(spec, new_ef)
        return new_state, {"loss": loss, "lr": lr, "grad_norm": gnorm}

    def step(state, batch):
        if compress and "ef" not in state:
            raise ValueError("compress_pod_grads: the state needs its "
                             "error-feedback residuals (init_ef_state)")
        model.release_compute()
        with use(tap), torch.no_grad():
            return _captured(state, batch, model.capture_aux(batch))

    return step
