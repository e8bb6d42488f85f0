"""RWKV6 "Finch" (attention-free, data-dependent decay) — the port of the
JAX package's ``models/rwkv.py``.

Time-mix: token-shift interpolation, r/k/v/g projections, a LoRA-produced
*data-dependent* per-channel decay ``w_t``, the WKV recurrence as one
``linear_scan`` library node (``tapir.wkv_scan``), per-head groupnorm and
an output gate.  Channel-mix: a squared-ReLU FFN with a receptance gate.
The reference's simplifications against the released checkpoints stay as
they are: static token-shift mix coefficients (RWKV5-style) for r/k/v/g;
the decay keeps the full RWKV6 form ``w = exp(-exp(w0 + tanh(x@A)@B))``.

``RWKV6`` is an ``nn.Module`` owning its parameters under the reference
tree's names (``embed``, ``blocks.{ln1, ln2, mu_*, wr, wk, wv, wg, wo, w0,
wA, wB, u, ln_x, wck, wcv, wcr}`` stacked ``[L, ...]``, ``ln_f``,
``lm_head``), kept in ``param_dtype`` (fp32) and cast to the compute dtype
layer by layer, as there.

Forward: embed, then ``scan_layers`` over ``rwkv_block`` regions (each
block ONE region program: ten GEMMs, the scan node and the lifted
composites), then the head.  ``loss`` adds the cross-entropy.  Both
train as they are (``train/step.py``): under grad every GEMM goes through
``FusedMatmulFn`` and every scan through ``LinearScanFn`` (the
hand-written scan backward on the card); the lifted decay, the token
shift, the groupnorm and the squared ReLU are torch composites autograd
differentiates; under remat full ``scan_layers`` reruns each block, its
scan included, in the backward.

Stateful serving (``init_cache`` / ``prefill`` / ``decode_step``): no KV
cache, O(1) state per token — per layer the time-mix and channel-mix
token-shift rows ``[B, 1, d]`` and the WKV carry ``[B, H, hd, hd]`` in
fp32, stacked ``[L, ...]``.  The reference's ``lax.scan`` over layers is a
Python loop over one ``rwkv_stateful_block`` region per layer, which
writes its new state over that layer's slabs of the cache tensors in
place (donated, as the dense cache's K/V slabs are; no host sync); the
params are cast once (``compute_params``), the head is a
``rwkv_stateful_head`` region and ``pos`` advances in place, so a decode
step's region inputs are the same tensors at every step and its programs
replay as CUDA graphs, which live as long as the cache they write.  The
stateful WKV step is one lifted node, as in the reference, whose body is
the scan kernel's wrapper with a carried state
(``ops.linear_scan(init_state=..., return_state=True)``): on the card it
launches the same kernel as the forward's scans, on the CPU it runs the
reference's chunked composite.
The reference's ``shard_act`` calls are dropped: one chip has nothing to
constrain.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..core import tapir
from ..core.dtypes import to_torch_dtype
from ..kernels.linear_scan import ops as ls_ops
from . import layers as L
from .base import (BaseModel, ModelConfig, ParamSpec, keep_in_place,
                   register_family)

LORA_RANK = 64


def _decay_from_lora(lora, w0):
    logw = w0.to(torch.float32) + lora.to(torch.float32)
    # jnp.clip is max then min: slope 0.5 at either bound (torch.clamp's
    # is 1)
    lo, hi = logw.new_full((), -8.0), logw.new_full((), 2.0)
    return torch.exp(-torch.exp(torch.minimum(torch.maximum(logw, lo), hi)))


def _wkv_step(r, k, v, w, u, state):
    """Stateful WKV step: one chunked scan carrying the ``[B,H,Dk,Dv]``
    state in and out — the SSM-state analogue of a KV-cache write."""
    return ls_ops.linear_scan(r, k, v, w, u=u, init_state=state,
                              return_state=True)


def _rwkv_block_specs(cfg: ModelConfig, n_layers: int) -> dict:
    d, ff = cfg.d_model, cfg.d_ff
    H, hd = cfg.n_heads, cfg.hd
    pdt = cfg.param_dtype
    Lx = (n_layers,)

    def mu():
        return ParamSpec(Lx + (d,), pdt, ("layers", "embed"), "zeros")

    def proj():
        return ParamSpec(Lx + (d, d), pdt, ("layers", "embed", "heads"))

    return {
        "ln1": ParamSpec(Lx + (d,), pdt, ("layers", "embed"), "ones"),
        "ln2": ParamSpec(Lx + (d,), pdt, ("layers", "embed"), "ones"),
        # time-mix
        "mu_r": mu(), "mu_k": mu(), "mu_v": mu(), "mu_g": mu(), "mu_w": mu(),
        "wr": proj(), "wk": proj(), "wv": proj(), "wg": proj(),
        "wo": ParamSpec(Lx + (d, d), pdt, ("layers", "heads", "embed")),
        "w0": ParamSpec(Lx + (d,), pdt, ("layers", "embed"), "zeros"),
        "wA": ParamSpec(Lx + (d, LORA_RANK), pdt, ("layers", "embed", None)),
        "wB": ParamSpec(Lx + (LORA_RANK, d), pdt, ("layers", None, "embed")),
        "u": ParamSpec(Lx + (H, hd), pdt, ("layers", "heads", None), "zeros"),
        "ln_x": ParamSpec(Lx + (d,), pdt, ("layers", "embed"), "ones"),
        # channel-mix
        "mu_ck": mu(), "mu_cr": mu(),
        "wck": ParamSpec(Lx + (d, ff), pdt, ("layers", "embed", "mlp")),
        "wcv": ParamSpec(Lx + (ff, d), pdt, ("layers", "mlp", "embed")),
        "wcr": ParamSpec(Lx + (d, d), pdt, ("layers", "embed", "embed2")),
    }


def abstract_params(cfg: ModelConfig) -> dict:
    """ParamSpec tree with the reference's structure and names."""
    pdt = cfg.param_dtype
    return {
        "embed": ParamSpec((cfg.vocab, cfg.d_model), pdt, ("vocab", "embed")),
        "blocks": _rwkv_block_specs(cfg, cfg.n_layers),
        "ln_f": ParamSpec((cfg.d_model,), pdt, ("embed",), "ones"),
        "lm_head": ParamSpec((cfg.d_model, cfg.vocab), pdt,
                             ("embed", "vocab")),
    }


@register_family("ssm")
class RWKV6(BaseModel):
    """RWKV6.  ``params`` (a tree like ``abstract_params`` of tensors)
    supplies the weights; otherwise they are drawn from ``generator``
    (default: seed 0 on ``device``) by the reference's init rule.
    ``device`` defaults to ``cuda`` and raises without a card."""

    def __init__(self, cfg: ModelConfig, device="cuda",
                 params: Optional[dict] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if cfg.family != "ssm":
            raise ValueError(f"RWKV6 needs the ssm family, got {cfg.family}")
        self.cfg = cfg
        self._set_params(abstract_params(cfg), device, params, generator)

    def _head(self, x, params: dict):
        x = L.rmsnorm(x, params["ln_f"])
        return tapir.linear(x, params["lm_head"].to(x.dtype))

    def _stateful_head_body(self, hp, x):
        """The last position's logits from the params cast once."""
        return tapir.linear(L.rmsnorm(x, hp["ln_f"]), hp["w"])[:, -1]

    # -- block ------------------------------------------------------------
    def _decay(self, p, xw):
        """w_t = exp(-exp(w0 + tanh(xw @ A) @ B))  in (0, 1), in fp32."""
        lora = tapir.linear(tapir.linear(xw, p["wA"], activation="tanh"),
                            p["wB"])
        if tapir.is_traced(lora):
            return tapir.lift(_decay_from_lora, lora, p["w0"])
        return _decay_from_lora(lora, p["w0"])

    def _time_mix(self, p, x, shift_state=None, wkv_state=None):
        cfg = self.cfg
        B, S, d = x.shape
        H, hd = cfg.n_heads, cfg.hd
        xs, new_shift = L.token_shift(x, shift_state)

        def mix(mu):
            return x + mu.to(x.dtype) * (xs - x)

        xr, xk, xv, xg, xw = (mix(p[m]) for m in
                              ("mu_r", "mu_k", "mu_v", "mu_g", "mu_w"))
        r = tapir.linear(xr, p["wr"]).reshape(B, S, H, hd)
        k = tapir.linear(xk, p["wk"]).reshape(B, S, H, hd)
        v = tapir.linear(xv, p["wv"]).reshape(B, S, H, hd)
        g = tapir.linear(xg, p["wg"], activation="silu")
        w = self._decay(p, xw).reshape(B, S, H, hd)
        u = p["u"].to(torch.float32)
        if wkv_state is None:
            o = tapir.wkv_scan(r, k, v, w.to(torch.float32), u)
            new_wkv = None
        elif any(tapir.is_traced(t) for t in (r, k, v, w, wkv_state)):
            o, new_wkv = tapir.lift(_wkv_step, r, k, v, w, u, wkv_state)
        else:
            o, new_wkv = _wkv_step(r, k, v, w, u, wkv_state)
        o = L.groupnorm_heads(o, p["ln_x"].reshape(H, hd)).reshape(B, S, d)
        out = tapir.linear(o * g, p["wo"])
        return out, new_shift, new_wkv

    def _channel_mix(self, p, x, shift_state=None):
        xs, new_shift = L.token_shift(x, shift_state)

        def mix(mu):
            return x + mu.to(x.dtype) * (xs - x)

        k = tapir.linear(mix(p["mu_ck"]), p["wck"], activation="relu")
        k = k * k
        rgate = tapir.linear(mix(p["mu_cr"]), p["wcr"], activation="sigmoid")
        return tapir.linear(k, p["wcv"]) * rgate, new_shift

    def _block_body(self, p, x):
        a, _, _ = self._time_mix(p, L.rmsnorm(x, p["ln1"]))
        x = x + a
        c, _ = self._channel_mix(p, L.rmsnorm(x, p["ln2"]))
        return x + c

    def _block(self, p, x):
        """One block as ONE region program: time-mix (r/k/v/g projections,
        decay LoRA, WKV scan, groupnorm, gate) and channel-mix.  With
        ``TapirConfig(regions=False)`` the same body runs op by op,
        bitwise-equal."""
        blk = tapir.parallel_region(self._block_body, name="rwkv_block")
        return blk(p, x)

    def _stateful_block_body(self, p, x, tm, cm, wkv):
        """One block threading its (token-shift, WKV) state through — the
        wkv state update is the same stateful-capture problem as a KV
        cache, traced here as a single region.  The new state is written
        over the old (``cache_write``): under region capture the program
        writes the donated slabs in place, after every read of them."""
        a, new_tm, new_wkv = self._time_mix(p, L.rmsnorm(x, p["ln1"]),
                                            shift_state=tm, wkv_state=wkv)
        x = x + a
        c, new_cm = self._channel_mix(p, L.rmsnorm(x, p["ln2"]),
                                      shift_state=cm)
        return (x + c, tapir.cache_write(tm, new_tm, (0, 0, 0)),
                tapir.cache_write(cm, new_cm, (0, 0, 0)),
                tapir.cache_write(wkv, new_wkv, (0, 0, 0, 0)))

    # -- forward ----------------------------------------------------------
    def forward(self, batch: dict, params: Optional[dict] = None):
        """Logits ``[B, S, vocab]`` of ``batch["tokens"] [B, S]``, every
        weight read from ``params`` (default: ``param_tree()``)."""
        if params is None:
            params = self.param_tree()
        h = self._embed(params["embed"], batch["tokens"])
        cdt = h.dtype

        def body(p, x):
            p = {k: v.to(cdt) for k, v in p.items()}
            return self._block(p, x)

        h = tapir.scan_layers(body, params["blocks"], h)
        return self._head(h, params)

    # -- stateful serving (no KV cache, O(1) state per token) -------------
    def init_cache(self, batch: int, max_len: int) -> dict:
        """Per layer the token-shift rows and the WKV carry; ``max_len``
        is unused (the state does not grow)."""
        cfg = self.cfg
        Ln, d = cfg.n_layers, cfg.d_model
        H, hd = cfg.n_heads, cfg.hd
        cdt = to_torch_dtype(cfg.compute_dtype)
        dev = self.device
        return {
            "tm_shift": torch.zeros((Ln, batch, 1, d), dtype=cdt, device=dev),
            "cm_shift": torch.zeros((Ln, batch, 1, d), dtype=cdt, device=dev),
            "wkv": torch.zeros((Ln, batch, H, hd, hd), dtype=torch.float32,
                               device=dev),
            "pos": torch.zeros((), dtype=torch.int32, device=dev),
        }

    def _run_stateful(self, tokens, cache):
        cp = self.compute_params()
        h = self._embed(self.embed, tokens)
        blk = tapir.parallel_region(self._stateful_block_body,
                                    name="rwkv_stateful_block")
        regions = tapir.get_config().regions
        for i in range(self.cfg.n_layers):
            slabs = (cache["tm_shift"][i], cache["cm_shift"][i],
                     cache["wkv"][i])
            h, *new = blk(cp["layers"][i], h, *slabs)
            keep_in_place(slabs, new, regions, f"layer {i}")
        head = tapir.parallel_region(self._stateful_head_body,
                                     name="rwkv_stateful_head")
        logits = head(cp["head"], h[:, -1:])
        cache["pos"].add_(tokens.shape[1])
        return logits, cache

    def prefill(self, tokens, cache):
        """Prompts ``tokens [B, S]`` into ``cache``; returns (logits
        ``[B, vocab]`` at position S-1, cache).  The state tensors and
        ``pos`` are updated in place."""
        return self._run_stateful(tokens, cache)

    def decode_step(self, tokens, cache):
        """``tokens [B, S]`` after the cached state; returns (logits
        ``[B, vocab]`` of the last, cache)."""
        return self._run_stateful(tokens, cache)
