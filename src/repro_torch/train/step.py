"""The per-op training step on one device — the port of the JAX package's
``train/step.py`` in the form its launcher runs without a mesh
(``launch/train.py``'s ``raw_step``): loss -> gradients -> AdamW.

``make_train_step(model, opt_cfg, cfg)`` returns ``step(state, batch) ->
(state, metrics)``.  The state is ``{"params", "opt": {"mu", "nu",
"step"}}`` with the model's own parameter tensors as ``params``: the step
updates them and the moments in place, leaf by leaf, and frees each
gradient once it has been applied (``optim.adamw_update``), so at full
width the peak is the four fp32 copies (params, gradients, mu, nu) plus one
temporary leaf and the backward's working set.

The gradients are ``torch.autograd.grad`` of ``model.loss`` under the
step's ``TapirConfig`` (its ``mode``, ``remat`` and cost model) with the
model's parameters made trainable for the call.  Any family with a
``loss`` trains: qwen2.5-3b (GEMMs and attention through their autograd
``Function``s), RWKV6 (GEMMs and the WKV scans, whose ``LinearScanFn``
runs the hand-written scan backward on the card), Zamba2, the MoE family
(its tree ``blocks.dense`` / ``blocks.moe`` with the 3-D expert leaves;
the expert GEMMs' backward on the grouped route) and the paper's nets
through ``launch/fig3.py``.  With ``microbatches`` k
the batch splits into k slices along its rows; their gradients are summed
in fp32 in microbatch order and the loss and gradients divided by k, as the
reference's ``lax.scan`` accumulation does.

``TrainConfig.remat`` ``"auto"`` and ``"dots"`` and ``compress_pod_grads``
are the captured step's (``train/region_step.py``, ``--capture-step``):
``make_train_step`` raises on them.  Not ported (each raises
``NotImplementedError``; ROADMAP names the item that brings it):
``strategy`` (a mesh), ``bf16_partials`` and ``bf16_params_in_loss``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from ..core.schedule import CPU_COST_MODEL, H100_COST_MODEL
from ..core.tapir import TapirConfig, use
from ..optim import AdamWConfig, adamw_init, adamw_update, tree_leaves


@dataclass(frozen=True)
class TrainConfig:
    mode: str = "tapir"               # tapir | opaque  (the paper's A/B)
    #: none | full (both steps); auto | dots (the captured step's
    #: per-node ``pick_remat`` policies)
    remat: str = "full"
    microbatches: int = 1             # grad-accumulation factor
    #: the hardware the schedule's costs describe: "gpu" (the H100
    #: profile), "cpu", or None for the device the step runs on
    target: Optional[str] = None
    strategy: Optional[str] = None    # a mesh strategy: not ported
    #: int8 + error feedback on the gradients: the captured step's
    compress_pod_grads: bool = False
    bf16_partials: bool = False       # bf16 TP all-reduce: not ported
    bf16_params_in_loss: bool = False  # not ported

    def __post_init__(self):
        for name in ("bf16_partials", "bf16_params_in_loss"):
            if getattr(self, name):
                raise NotImplementedError(
                    f"TrainConfig.{name} is not ported (ROADMAP queue 1, "
                    f"item 8: the mesh port)")
        if self.strategy is not None:
            raise NotImplementedError("TrainConfig.strategy needs a mesh, "
                                      "which is not ported (ROADMAP queue 1)")
        if self.remat not in ("none", "full", "auto", "dots"):
            raise ValueError(f"remat must be 'none', 'full', 'auto' or "
                             f"'dots', got {self.remat!r}")
        if self.mode not in ("tapir", "opaque"):
            raise ValueError(f"mode must be 'tapir' or 'opaque', got "
                             f"{self.mode!r}")
        if self.target not in (None, "gpu", "cpu"):
            raise ValueError(f"target must be 'gpu', 'cpu' or None, got "
                             f"{self.target!r}")
        if self.microbatches < 1:
            raise ValueError("microbatches must be >= 1")

    def tapir_config(self) -> TapirConfig:
        cm = {None: None, "gpu": H100_COST_MODEL,
              "cpu": CPU_COST_MODEL}[self.target]
        return TapirConfig(mode=self.mode, cost_model=cm, remat=self.remat)


def init_state(model, opt_cfg: AdamWConfig) -> dict:
    """``{"params": the model's parameter tree, "opt": adamw_init}``; the
    moments in ``opt_cfg.moment_dtype`` on the params' device."""
    params = model.param_tree()
    return {"params": params, "opt": adamw_init(params, opt_cfg)}


def _split_microbatches(batch: dict, k: int) -> list:
    out = []
    for i in range(k):
        mb = {}
        for key, x in batch.items():
            b = x.shape[0]
            if b % k:
                raise ValueError(f"batch {b} % microbatches {k} != 0")
            mb[key] = x[i * (b // k):(i + 1) * (b // k)]
        out.append(mb)
    return out


def make_train_step(model, opt_cfg: AdamWConfig,
                    cfg: TrainConfig = TrainConfig()):
    """``step(state, batch) -> (state, metrics)`` on the device the model
    lives on.  ``batch`` is ``{"tokens", "labels"[, "mask"]}`` of tensors
    on that device; ``metrics`` holds ``loss``, ``lr`` and ``grad_norm``
    as fp32 0-dim tensors.  Remat ``auto`` / ``dots`` and
    ``compress_pod_grads`` raise: they are the captured step's."""
    if cfg.remat in ("auto", "dots"):
        raise NotImplementedError(
            f"remat={cfg.remat!r} is a per-node policy of the captured step "
            f"(make_region_train_step, --capture-step); the per-op step "
            f"takes 'none' or 'full'")
    if cfg.compress_pod_grads:
        raise NotImplementedError(
            "compress_pod_grads: the per-op step has no pod axis to reduce "
            "over (the mesh port, ROADMAP queue 1 item 8); the captured "
            "step (--capture-step) folds int8 + error feedback in")
    tap = cfg.tapir_config()

    def grads_of(params, mb):
        leaves = tree_leaves(params)
        with use(tap), model.trainable():
            loss = model.loss(mb)
            grads = list(torch.autograd.grad(loss, leaves))
        return loss.detach(), grads

    def step(state, batch):
        params = state["params"]
        model.release_compute()
        if cfg.microbatches > 1:
            loss, grads = None, None
            for mb in _split_microbatches(batch, cfg.microbatches):
                l, g = grads_of(params, mb)
                if grads is None:
                    loss = l
                    grads = [x.to(torch.float32) for x in g]
                else:
                    loss = loss + l
                    for acc, x in zip(grads, g):
                        acc.add_(x.to(torch.float32))
                del g
            loss = loss / cfg.microbatches
            for g in grads:
                g.div_(cfg.microbatches)
        else:
            loss, grads = grads_of(params, batch)
        om = adamw_update(params, grads, state["opt"], opt_cfg)
        return state, {"loss": loss, **om}

    return step
