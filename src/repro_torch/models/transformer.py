"""Dense GQA transformer LM — the port of the JAX package's
``models/transformer.py``: the full-sequence forward, the padded-cache
prefill/decode and the slot-paged serving path.

``DenseLM`` is an ``nn.Module`` owning its parameters under the reference
tree's names (``embed``, ``blocks.{wq,wk,wv,bq,bk,bv,wo,wg,wu,wd,ln1,ln2}``
stacked ``[L, ...]``, ``ln_f``, ``lm_head``), kept in ``param_dtype``
(fp32).  As in the reference, every layer's params are cast to the compute
dtype just before its block runs.

Forward: embed, then ``scan_layers`` over ``dense_block`` regions (each
block ONE region program: norms, the fused QKV GEMM, RoPE, the causal
flash-attention node, the O-projection with its residual epilogue and the
MLP: gated, or with ``gated_mlp=False`` the reference's ``wu`` with its
activation then ``wd``), then the head.  ``loss`` adds the cross-entropy.

Padded cache (``init_cache`` / ``prefill`` / ``decode_step``): one
``[L, B, max_len, Hkv, hd]`` tensor for K and one for V plus a scalar
``pos``.  Each layer's block region writes its slab view ``cache["k"][i]``
in place (a donated ``dynamic_update_slice`` at ``pos``); prefill attends
over the fresh K/V with the flash node, decode over the cache with the
masked composite, its RoPE rows gathered at ``pos`` from the memoized
full table into buffers kept per row count.  The layer loop takes
embeddings (``_run_embeds_with_cache``), so the VLM (``models/vlm.py``)
prefills ``[image; prompt]`` through it.  Both read the params cast once
(``compute_params``), end in a ``slot_head`` region, and advance ``pos``
in place, so a decode step's region inputs are the same tensors at every
step and its programs replay as CUDA graphs.

Slot serving: the cache is per-layer page pools ``[P, page_len, Hkv, hd]``
plus a per-slot page table ``ptab [slots, pps]`` and length vector ``pos``.
Occupancy and page binding are DATA, not shape: each block of a decode step
is ONE region program (per-slot RoPE rows gathered at ``pos``, K/V
scattered in place at ``(ptab[s, pos // page_len], pos % page_len)``,
masked attention over the gathered per-slot view ``pool[ptab[s]]``),
replayed from ``_PROGRAMS`` whichever slots are live.  The params come
cast once from ``compute_params``, and ``pos`` advances in place, so every
region input rebinds to the same tensors each step.

Every per-layer loop picks the layer's block body by its kind
(``_cached_bodies``, ``_slot_bodies``, ``_slot_prefill_bodies``): the slot
parameters (``slot_params``) carry a ``("dense" | "moe", params)`` marker
per layer, as the reference's do.  ``DenseLM``'s layers are all dense; the
MoE family (``models/moe.py``) subclasses it.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core import tapir
from ..core.dtypes import to_torch_dtype
from ..dist import logical_sizes, shard_act
from ..dist.sharding import current_sizes
from ..serve.pages import identity_row, page_geometry
from . import layers as L
from .base import (BaseModel, ModelConfig, ParamSpec, head_axes,
                   keep_in_place, register_family)


def _block_specs(cfg: ModelConfig, n_layers: int) -> dict:
    d, hd = cfg.d_model, cfg.hd
    H, Hkv, ff = cfg.n_heads, cfg.n_kv_heads, cfg.d_ff
    pdt = cfg.param_dtype
    Lx = (n_layers,)
    spec = {
        "ln1": ParamSpec(Lx + (d,), pdt, ("layers", "embed"), "ones"),
        "ln2": ParamSpec(Lx + (d,), pdt, ("layers", "embed"), "ones"),
        "wq": ParamSpec(Lx + (d, H * hd), pdt, ("layers", "embed", "heads")),
        "wk": ParamSpec(Lx + (d, Hkv * hd), pdt, ("layers", "embed", "kv")),
        "wv": ParamSpec(Lx + (d, Hkv * hd), pdt, ("layers", "embed", "kv")),
        "wo": ParamSpec(Lx + (H * hd, d), pdt, ("layers", "heads", "embed")),
    }
    if cfg.qkv_bias:
        spec["bq"] = ParamSpec(Lx + (H * hd,), pdt, ("layers", "heads"), "zeros")
        spec["bk"] = ParamSpec(Lx + (Hkv * hd,), pdt, ("layers", "kv"), "zeros")
        spec["bv"] = ParamSpec(Lx + (Hkv * hd,), pdt, ("layers", "kv"), "zeros")
    if cfg.gated_mlp:
        spec["wg"] = ParamSpec(Lx + (d, ff), pdt, ("layers", "embed", "mlp"))
    spec["wu"] = ParamSpec(Lx + (d, ff), pdt, ("layers", "embed", "mlp"))
    spec["wd"] = ParamSpec(Lx + (ff, d), pdt, ("layers", "mlp", "embed"))
    return spec


def abstract_params(cfg: ModelConfig) -> dict:
    """ParamSpec tree with the reference's structure and names."""
    p = {
        "embed": ParamSpec((cfg.vocab, cfg.d_model), cfg.param_dtype,
                           ("vocab", "embed"), scale=1.0),
        "blocks": _block_specs(cfg, cfg.n_layers),
        "ln_f": ParamSpec((cfg.d_model,), cfg.param_dtype, ("embed",), "ones"),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = ParamSpec((cfg.d_model, cfg.vocab), cfg.param_dtype,
                                 ("embed", "vocab"))
    return p


class DenseBlocks:
    """The dense block's math over ``self.cfg`` and nothing else: norms,
    the attention sub-block (forward and padded cache), the gated MLP, the
    block bodies and the decode RoPE rows.  ``DenseLM`` is one; Zamba2's
    shared attention + MLP block applies another (``models/mamba.py``),
    as the reference's ``Zamba2`` borrows a ``DenseLM`` helper.  A subclass
    sets ``cfg`` and ``_rope_bufs`` (a dict)."""

    def _rope_frac(self) -> float:
        return 0.5 if self.cfg.rope == "half" else 1.0

    def _norm(self, x, scale):
        return L.rmsnorm(x, scale) if self.cfg.norm == "rmsnorm" \
            else L.layernorm(x, scale)

    def _mlp(self, p, x):
        cfg = self.cfg
        if cfg.gated_mlp:
            return tapir.gated_mlp(x, p["wg"], p["wu"], p["wd"], cfg.act)
        return tapir.linear(tapir.linear(x, p["wu"], activation=cfg.act),
                            p["wd"])

    def _attn(self, p, x, cos, sin, causal=True, kv_cache=None):
        cfg = self.cfg
        B, S, _ = x.shape
        H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
        bs = [p["bq"], p["bk"], p["bv"]] if cfg.qkv_bias else None
        q, k, v = tapir.multi_linear(x, [p["wq"], p["wk"], p["wv"]], bs)
        # on a mesh a rank holds its heads: -1 is its share of H / Hkv
        q = q.reshape(B, S, -1, hd)
        k = k.reshape(B, S, -1, hd)
        v = v.reshape(B, S, -1, hd)
        frac = self._rope_frac()
        q = L.apply_rope(q, cos, sin, frac)
        k = L.apply_rope(k, cos, sin, frac)
        hq, hkv = head_axes(self.cfg)
        q = shard_act(q, "batch", None, hq, None)
        k = shard_act(k, "batch", None, hkv, None)
        v = shard_act(v, "batch", None, hkv, None)
        if kv_cache is None:
            o = tapir.attention(q, k, v, causal=causal)
        else:
            ck, cv, cpos, is_prefill = kv_cache
            # inside a region these are dynamic_update_slice nodes that
            # donate the cache slabs: the program writes them in place
            ck = tapir.cache_write(ck, k, (0, cpos, 0, 0))
            cv = tapir.cache_write(cv, v, (0, cpos, 0, 0))
            if is_prefill:
                # the flash node over the fresh K/V (the cache only written)
                o = tapir.attention(q, k, v, causal=True)
            else:
                o = _decode_attention(q, ck, cv, cpos + S)
            kv_cache = (ck, cv)
        # heads over model on the attention's value, then gathered in rank
        # order before wo: a K-split wo would add partial sums across ranks
        o = shard_act(o, "batch", None, hq, None)
        o = shard_act(o, "batch", None, None, None)
        out = tapir.linear(o.reshape(B, S, H * hd), p["wo"])
        return out, kv_cache

    def _attn_body(self, p, x, cos, sin):
        """Attention sub-block: norm, attention, residual."""
        a, _ = self._attn(p, self._norm(x, p["ln1"]), cos, sin)
        return x + a

    def _block_body(self, p, x, cos, sin):
        x = self._attn_body(p, x, cos, sin)
        return x + self._mlp(p, self._norm(x, p["ln2"]))

    def _block(self, p, x, cos, sin):
        """One block as ONE region program: the pass pipeline fuses across
        op boundaries (Q/K/V into one GEMM, each residual add into a GEMM
        epilogue).  With ``TapirConfig(regions=False)`` the same body runs
        op by op, bitwise-equal."""
        blk = tapir.parallel_region(self._block_body, name="dense_block")
        return shard_act(blk(p, x, cos, sin), "batch", "seq", None)

    def _cached_attn_body(self, p, x, cos, sin, ck, cv, pos0,
                          is_prefill: bool):
        """Attention sub-block against its KV-cache slab (stateful)."""
        a, (ck, cv) = self._attn(p, self._norm(x, p["ln1"]), cos, sin,
                                 kv_cache=(ck, cv, pos0, is_prefill))
        return x + a, ck, cv

    def _cached_block_body(self, p, x, cos, sin, ck, cv, pos0,
                           is_prefill: bool):
        """One block against its cache slab; under region capture the cache
        writes donate the slab, which the program updates in place."""
        x, ck, cv = self._cached_attn_body(p, x, cos, sin, ck, cv, pos0,
                                           is_prefill)
        x = x + self._mlp(p, self._norm(x, p["ln2"]))
        return x, ck, cv

    def _rope_rows(self, pos, n: int, max_len: int) -> tuple:
        """cos / sin rows of the ``n`` positions from ``pos`` on, gathered
        (clamped) from the memoized full table into buffers kept per
        ``n``: the decode step's regions bind the same two tensors at
        every step.  The rows equal ``rope_table`` of those positions (the
        table is elementwise in the position)."""
        cos_t, sin_t = L.full_rope_table(max_len, self.cfg.hd,
                                         fraction=self._rope_frac(),
                                         device=pos.device)
        key = (n, cos_t.shape, str(pos.device))
        bufs = self._rope_bufs.get(key)
        if bufs is None:
            bufs = self._rope_bufs[key] = tuple(
                torch.empty((n, cos_t.shape[-1]), dtype=cos_t.dtype,
                            device=pos.device) for _ in range(2))
        rows = (pos + torch.arange(n, dtype=pos.dtype, device=pos.device)
                ).clamp(0, cos_t.shape[0] - 1)
        for tab, buf in zip((cos_t, sin_t), bufs):
            torch.index_select(tab, 0, rows, out=buf)
        return bufs


def _kinded(layer) -> tuple:
    """A slot layer as ``(kind, params)``: a bare params dict is a dense
    layer (``compute_params`` of a dense model)."""
    return layer if isinstance(layer, tuple) else ("dense", layer)


@register_family("dense")
class DenseLM(DenseBlocks, BaseModel):
    """Dense GQA transformer.  ``params`` (a tree like ``abstract_params``
    of tensors) supplies the weights; otherwise they are drawn from
    ``generator`` (default: seed 0 on ``device``) by the reference's init
    rule.  ``device`` defaults to ``cuda`` and raises without a card."""

    #: the config family this class builds (a subclass names its own)
    FAMILY = "dense"

    def __init__(self, cfg: ModelConfig, device="cuda",
                 params: Optional[dict] = None,
                 generator: Optional[torch.Generator] = None, mesh=None):
        super().__init__()
        if cfg.family != self.FAMILY:
            raise NotImplementedError(f"{type(self).__name__} builds the "
                                      f"{self.FAMILY!r} family, not "
                                      f"{cfg.family!r}")
        self.cfg = cfg
        self._set_params(self._param_specs(), device, params, generator,
                         mesh)
        self._rope_bufs: dict = {}      # decode RoPE rows (``_rope_rows``)

    def _param_specs(self) -> dict:
        return abstract_params(self.cfg)

    def param_axes(self) -> dict:
        """The logical axes of every weight, in ``param_tree()``'s
        structure (the reference's ``param_axes``)."""
        def axes(t):
            return {k: axes(v) for k, v in t.items()} \
                if isinstance(t, dict) else tuple(t.axes)
        return axes(self._param_specs())

    def slot_param_axes(self) -> dict:
        """The logical axes of ``slot_params()``' leaves (a layer's leaves
        lose the stacked ``layers`` axis; the head is ``(embed, vocab)``)."""
        blocks = {k: tuple(s.axes[1:])
                  for k, s in _block_specs(self.cfg, 1).items()}
        return {"layers": [("dense", dict(blocks))
                           for _ in range(self.cfg.n_layers)],
                "head": {"ln_f": ("embed",), "w": ("embed", "vocab")},
                "embed": ("vocab", "embed")}

    def slot_cache_axes(self) -> dict:
        """Logical axes of the page pools ``[P, page_len, Hkv, hd]``: kv
        heads over ``model`` when they divide; the page dims stay whole
        (page ids are data, so a split would make every write a
        collective), and so do ``ptab`` / ``pos``."""
        a = (None, None, "kv", None)
        n = self.cfg.n_layers
        return {"k": [a] * n, "v": [a] * n, "ptab": (), "pos": ()}

    def slot_param_shapes(self) -> dict:
        """The whole shapes of ``slot_params()``' leaves, in its tree."""
        cfg = self.cfg
        blocks = {k: tuple(s.shape[1:])
                  for k, s in _block_specs(cfg, 1).items()}
        return {"layers": [("dense", dict(blocks))
                           for _ in range(cfg.n_layers)],
                "head": {"ln_f": (cfg.d_model,),
                         "w": (cfg.d_model, cfg.vocab)},
                "embed": (cfg.vocab, cfg.d_model)}

    def slot_cache_shapes(self, slots: int, max_len: int,
                          page_len: Optional[int] = None,
                          shared_pages: Optional[int] = None) -> dict:
        """The whole shapes of ``init_slot_cache``'s leaves."""
        cfg = self.cfg
        pl, pps = page_geometry(max_len, page_len)
        if shared_pages is None:
            shared_pages = slots * pps
        pool = (1 + slots * pps + shared_pages, pl, cfg.n_kv_heads, cfg.hd)
        n = cfg.n_layers
        return {"k": [pool] * n, "v": [pool] * n, "ptab": (slots, pps),
                "pos": (slots,)}

    def cache_shapes(self, batch: int, max_len: int) -> dict:
        """The whole shapes of ``init_cache``'s leaves."""
        cfg = self.cfg
        kv = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.hd)
        return {"k": kv, "v": kv, "pos": ()}

    def cache_axes(self) -> dict:
        """Logical axes of the padded cache ``[L, B, max_len, Hkv, hd]``."""
        a = ("layers", "batch", None, "kv", None)
        return {"k": a, "v": a, "pos": ()}

    def slot_params(self) -> dict:
        """``compute_params`` with every layer marked by its kind
        (``("dense", p)``): what the serving engine hands the slot paths."""
        cp = self.compute_params()
        return {**cp, "layers": [_kinded(p) for p in cp["layers"]]}

    def supports_slots(self) -> bool:
        return True

    # -- forward ----------------------------------------------------------
    def backbone(self, h, blocks: Optional[dict] = None):
        """The block stack over ``h [B, S, d]`` at positions ``arange(S)``,
        with the stacked ``blocks`` (default: the model's own)."""
        cos, sin = L.arange_rope_table(int(h.shape[1]), self.cfg.hd,
                                       fraction=self._rope_frac(),
                                       device=self.device)
        cdt = h.dtype

        def body(p, x):
            p = {k: v.to(cdt) for k, v in p.items()}
            return self._block(p, x, cos, sin)

        if blocks is None:
            blocks = dict(self.blocks)
        return tapir.scan_layers(body, blocks, h)

    def capture_aux(self, batch: dict) -> tuple:
        # the same memoized tensors ``backbone`` binds
        return L.arange_rope_table(int(batch["tokens"].shape[1]),
                                   self.cfg.hd, fraction=self._rope_frac(),
                                   device=self.device)

    def _head(self, x, params: dict):
        x = self._norm(x, params["ln_f"])
        w = params.get("lm_head")
        if w is None:
            w = self.tied_head(params["embed"])
        return shard_act(tapir.linear(x, w.to(x.dtype)), "batch", None,
                         "vocab")

    def forward(self, batch: dict, params: Optional[dict] = None):
        """Logits ``[B, S, vocab]`` of ``batch["tokens"] [B, S]``, every
        weight read from ``params`` (default: ``param_tree()``)."""
        if params is None:
            params = self.param_tree()
        tokens = batch["tokens"]
        with logical_sizes(**self.logical_sizes(int(tokens.shape[0]))):
            h = shard_act(self._embed(params["embed"], tokens),
                          "batch", "seq", None)
            return self._head(self.backbone(h, params["blocks"]), params)

    # -- padded-cache serving ----------------------------------------------
    def init_cache(self, batch: int, max_len: int) -> dict:
        """``k`` / ``v``: ``[L, batch, max_len, Hkv, hd]`` in the compute
        dtype; ``pos``: the shared length, a scalar int32."""
        kv = to_torch_dtype(self.cfg.compute_dtype)
        shape = self.cache_shapes(batch, max_len)["k"]
        dev = self.device
        return {"k": torch.zeros(shape, dtype=kv, device=dev),
                "v": torch.zeros(shape, dtype=kv, device=dev),
                "pos": torch.zeros((), dtype=torch.int32, device=dev)}

    def _run_with_cache(self, tokens, cache, is_prefill: bool):
        """Logits ``[B, vocab]`` of the last position; ``cache["pos"]``
        advances in place."""
        return self._run_embeds_with_cache(self._embed(self.embed, tokens),
                                           cache, is_prefill)

    def _run_embeds_with_cache(self, h, cache, is_prefill: bool):
        """The padded cache's layer loop over embeddings ``h [B, S, d]``
        (the token path's, or the VLM's ``[image; prompt]``): logits
        ``[B, vocab]`` of the last position; ``cache["pos"]`` advances in
        place."""
        with logical_sizes(**self.logical_sizes(int(h.shape[0]))):
            return self._embeds_with_cache(
                shard_act(h, "batch", None, None), cache, is_prefill)

    def _embeds_with_cache(self, h, cache, is_prefill: bool):
        cfg = self.cfg
        cp = self.compute_params()
        pos0 = cache["pos"]
        S = int(h.shape[1])
        if is_prefill:
            # positions arange(S): the forward's own table
            cos, sin = L.arange_rope_table(S, cfg.hd,
                                           fraction=self._rope_frac(),
                                           device=h.device)
        else:
            cos, sin = self._rope_rows(pos0, S, int(cache["k"].shape[2]))
        blks = {kind: tapir.parallel_region(fn, name=f"{kind}_cached_block")
                for kind, fn in self._cached_bodies().items()}
        regions = tapir.get_config().regions
        for i in range(cfg.n_layers):
            slab_k, slab_v = cache["k"][i], cache["v"][i]
            kind, p = _kinded(cp["layers"][i])
            h, ck, cv = blks[kind](p, h, cos, sin, slab_k, slab_v, pos0,
                                   is_prefill)
            keep_in_place((slab_k, slab_v), (ck, cv), regions,
                          f"layer {i}")
        head = tapir.parallel_region(self._slot_head_body, name="slot_head")
        # only the last position's logits are served
        logits = head(cp["head"], h[:, -1:])
        pos0.add_(S)
        return logits, cache

    def _cached_bodies(self) -> dict:
        """The padded cache's block body of each layer kind."""
        return {"dense": self._cached_block_body}

    def prefill(self, tokens, cache):
        """Prompts ``tokens [B, S]`` into an empty ``cache``; returns
        (logits ``[B, vocab]`` at position S-1, cache).  The cache's K/V
        tensors and ``pos`` are updated in place."""
        return self._run_with_cache(tokens, cache, is_prefill=True)

    def decode_step(self, tokens, cache):
        """``tokens [B, S]`` at positions ``pos ..``; returns (logits
        ``[B, vocab]`` of the last, cache)."""
        return self._run_with_cache(tokens, cache, is_prefill=False)

    # -- slot-paged serving ----------------------------------------------
    def init_slot_cache(self, slots: int, max_len: int,
                        page_len: Optional[int] = None,
                        shared_pages: Optional[int] = None) -> dict:
        """Per-layer pools ``[P, page_len, Hkv, hd]`` (a python list: each
        layer's pool is written in place on its own), the page table and
        the per-slot lengths.  ``P = 1 (trash) + slots*pps + shared_pages``
        (see ``serve.pages``)."""
        cfg = self.cfg
        kv = to_torch_dtype(cfg.compute_dtype)
        shapes = self.slot_cache_shapes(slots, max_len, page_len,
                                        shared_pages)
        pps = shapes["ptab"][1]
        dev = self.device
        ptab = np.stack([identity_row(s, pps) for s in range(slots)])
        return {"k": [torch.zeros(s, dtype=kv, device=dev)
                      for s in shapes["k"]],
                "v": [torch.zeros(s, dtype=kv, device=dev)
                      for s in shapes["v"]],
                "ptab": torch.as_tensor(ptab, device=dev),
                "pos": torch.zeros((slots,), dtype=torch.int32, device=dev)}

    def _slot_attn_body(self, p, x, rope_cos, rope_sin, ck, cv, pos, ptab):
        """Attention sub-block over the paged pool; every data-dependent
        piece (RoPE rows, page targets, per-slot lengths) is a graph value."""
        cfg = self.cfg
        hd = cfg.hd
        hq, hkv = head_axes(self.cfg)
        # on a mesh a rank decodes its block of the slots (over data) and
        # its heads (over model); ``pos`` / ``ptab`` stay whole for the
        # writes below
        x = shard_act(x, "batch", None, None)
        pos_b = shard_act(pos, "batch")
        ptab_b = shard_act(ptab, "batch", None)
        B = x.shape[0]
        xn = self._norm(x, p["ln1"])
        bs = [p["bq"], p["bk"], p["bv"]] if cfg.qkv_bias else None
        q, k, v = tapir.multi_linear(xn, [p["wq"], p["wk"], p["wv"]], bs)
        q = q.reshape(B, 1, -1, hd)
        k = k.reshape(B, 1, -1, hd)
        v = v.reshape(B, 1, -1, hd)
        q = shard_act(q, "batch", None, hq, None)
        k = shard_act(k, "batch", None, hkv, None)
        v = shard_act(v, "batch", None, hkv, None)
        rot2 = rope_cos.shape[-1]
        cos = tapir.gather(rope_cos, (pos_b,)).reshape(B, 1, rot2)
        sin = tapir.gather(rope_sin, (pos_b,)).reshape(B, 1, rot2)
        frac = self._rope_frac()
        q = L.apply_rope(q, cos, sin, frac)
        k = L.apply_rope(k, cos, sin, frac)
        # the pools are replicated over data: every rank writes every
        # slot's row (its block's rows gathered in rank order)
        k = shard_act(shard_act(k, "batch", None, hkv, None),
                      None, None, hkv, None)
        v = shard_act(shard_act(v, "batch", None, hkv, None),
                      None, None, hkv, None)
        n_all = pos.shape[0]
        pidx, off = _page_coords_t(pos, page_len=int(ck.shape[1]))
        phys = tapir.gather(ptab, (np.arange(n_all), pidx))
        ck = tapir.scatter(ck, (phys, off), k.reshape(n_all, -1, hd))
        cv = tapir.scatter(cv, (phys, off), v.reshape(n_all, -1, hd))
        ck = shard_act(ck, None, None, hkv, None)
        cv = shard_act(cv, None, None, hkv, None)
        o = _paged_attention(q, ck, cv, ptab_b, pos_b + 1)
        o = shard_act(o, "batch", None, hq, None)
        o = shard_act(o, "batch", None, None, None)
        x = x + tapir.linear(o.reshape(B, 1, -1), p["wo"])
        return shard_act(x, "batch", None, None), ck, cv

    def _slot_block_body(self, p, x, rope_cos, rope_sin, ck, cv, pos, ptab):
        x, ck, cv = self._slot_attn_body(p, x, rope_cos, rope_sin, ck, cv,
                                         pos, ptab)
        x = x + self._mlp(p, self._norm(x, p["ln2"]))
        return shard_act(x, "batch", None, None), ck, cv

    def _slot_prefill_attn_body(self, p, x, rope_cos, rope_sin, ck, cv,
                                pos_vec, phys_vec, off_vec, prow, vlen):
        """Prefill one request's rows into its page run (B == 1): K/V land
        at ``(phys_vec[i], off_vec[i])`` (bucket padding past capacity
        targets the trash page) and attention runs the masked composite
        over the slot's gathered page view, so a suffix prefill computes
        each row exactly as a full prefill does."""
        cfg = self.cfg
        B, S, _ = x.shape
        hd = cfg.hd
        hq, hkv = head_axes(self.cfg)
        xn = self._norm(x, p["ln1"])
        bs = [p["bq"], p["bk"], p["bv"]] if cfg.qkv_bias else None
        q, k, v = tapir.multi_linear(xn, [p["wq"], p["wk"], p["wv"]], bs)
        q = shard_act(q.reshape(B, S, -1, hd), None, None, hq, None)
        k = shard_act(k.reshape(B, S, -1, hd), None, None, hkv, None)
        v = shard_act(v.reshape(B, S, -1, hd), None, None, hkv, None)
        cos = tapir.gather(rope_cos, (pos_vec,))
        sin = tapir.gather(rope_sin, (pos_vec,))
        frac = self._rope_frac()
        q = L.apply_rope(q, cos, sin, frac)
        k = L.apply_rope(k, cos, sin, frac)
        ck = tapir.scatter(ck, (phys_vec, off_vec), k.reshape(S, -1, hd))
        cv = tapir.scatter(cv, (phys_vec, off_vec), v.reshape(S, -1, hd))
        ck = shard_act(ck, None, None, hkv, None)
        cv = shard_act(cv, None, None, hkv, None)
        o = _paged_prefill_attn(q, ck, cv, prow, vlen)
        o = shard_act(o, None, None, hq, None)
        o = shard_act(o, None, None, None, None)
        x = x + tapir.linear(o.reshape(B, S, -1), p["wo"])
        return x, ck, cv

    def _slot_prefill_block_body(self, p, x, rope_cos, rope_sin, ck, cv,
                                 pos_vec, phys_vec, off_vec, prow, vlen):
        x, ck, cv = self._slot_prefill_attn_body(
            p, x, rope_cos, rope_sin, ck, cv, pos_vec, phys_vec, off_vec,
            prow, vlen)
        x = x + self._mlp(p, self._norm(x, p["ln2"]))
        return x, ck, cv

    def _slot_head_body(self, hp, x):
        """The head's logits of the last row, whole on every rank: the
        vocab columns (and the slots' rows) gathered in rank order, so
        the host's argmax reads the same row everywhere."""
        x = self._norm(x, hp["ln_f"])
        logits = shard_act(tapir.linear(x, hp["w"])[:, -1], "batch", "vocab")
        return shard_act(logits, None, None)

    def _slot_bodies(self) -> dict:
        """The slot decode step's block body of each layer kind."""
        return {"dense": self._slot_block_body}

    def _slot_prefill_bodies(self) -> dict:
        """The slot prefill's block body of each layer kind."""
        return {"dense": self._slot_prefill_block_body}

    def decode_step_slots(self, sp, tokens, cache):
        """One decode step for EVERY slot.  tokens: [slots, 1] int32 (free
        slots carry don't-care tokens).  Returns (logits [slots, vocab],
        cache); per-slot positions advance by one and the pools update in
        place."""
        with logical_sizes(**self.logical_sizes(int(tokens.shape[0]))):
            return self._decode_slots(sp, tokens, cache)

    def _decode_slots(self, sp, tokens, cache):
        cfg = self.cfg
        h = self._embed(sp["embed"], tokens)
        pl = cache["k"][0].shape[1]
        ptab = cache["ptab"]
        cos_t, sin_t = L.full_rope_table(ptab.shape[1] * pl, cfg.hd,
                                         fraction=self._rope_frac(),
                                         device=tokens.device)
        pos = cache["pos"]
        blks = {kind: tapir.parallel_region(fn, name=f"slot_{kind}_block")
                for kind, fn in self._slot_bodies().items()}
        for i, layer in enumerate(sp["layers"]):
            kind, p = _kinded(layer)
            h, ck, cv = blks[kind](p, h, cos_t, sin_t, cache["k"][i],
                                   cache["v"][i], pos, ptab)
            cache["k"][i], cache["v"][i] = ck, cv
        head = tapir.parallel_region(self._slot_head_body, name="slot_head")
        logits = head(sp["head"], h)
        pos.add_(1)
        return logits, cache

    def prefill_into_slot(self, sp, tokens, cache, slot: int, plen: int,
                          start: int = 0):
        """Insert one request into slot ``slot``.  tokens: [1, Sb] rows
        ``[start, start + Sb)`` of the prompt, right-padded to a bucket;
        ``start > 0`` is a suffix prefill over resident shared-prefix
        pages.  Returns (logits [1, vocab] at prompt row plen-1, cache)."""
        with logical_sizes(**self.logical_sizes(int(tokens.shape[0]))):
            return self._prefill_slot(sp, tokens, cache, slot, plen, start)

    def _prefill_slot(self, sp, tokens, cache, slot: int, plen: int,
                      start: int):
        cfg = self.cfg
        dev = tokens.device
        Sb = tokens.shape[1]
        pl = int(cache["k"][0].shape[1])
        row = cache["ptab"][slot].cpu().numpy()
        pps = row.shape[0]
        max_len = pps * pl
        h = self._embed(sp["embed"], tokens)
        cos_t, sin_t = L.full_rope_table(max(max_len, Sb), cfg.hd,
                                         fraction=self._rope_frac(),
                                         device=dev)
        p_abs = start + np.arange(Sb)
        ok = p_abs < max_len
        pidx = np.minimum(p_abs // pl, pps - 1)
        phys = np.where(ok, row[pidx], 0).astype(np.int32)
        off = np.where(ok, p_abs % pl, 0).astype(np.int32)
        pos_clip = np.minimum(p_abs, cos_t.shape[0] - 1).astype(np.int32)
        # device tensors: rebindable region inputs, not baked-in consts
        pos_vec = torch.as_tensor(pos_clip, device=dev)
        phys_vec = torch.as_tensor(phys, device=dev)
        off_vec = torch.as_tensor(off, device=dev)
        prow = torch.as_tensor(row, device=dev)
        vlen = torch.tensor(start + Sb, dtype=torch.int32, device=dev)
        blks = {kind: tapir.parallel_region(fn, name=f"slot_{kind}_prefill")
                for kind, fn in self._slot_prefill_bodies().items()}
        for i, layer in enumerate(sp["layers"]):
            kind, p = _kinded(layer)
            h, ck, cv = blks[kind](p, h, cos_t, sin_t, cache["k"][i],
                                   cache["v"][i], pos_vec, phys_vec, off_vec,
                                   prow, vlen)
            cache["k"][i], cache["v"][i] = ck, cv
        r = plen - 1 - start
        head = tapir.parallel_region(self._slot_head_body, name="slot_head")
        logits = head(sp["head"], h[:, r:r + 1])
        cache["pos"][slot] = plen
        return logits, cache


def _decode_attention(q, ck, cv, valid_len):
    """Masked attention over the padded cache: inside a region ONE
    ``pyfunc`` node (ordered after the cache writes it reads), outside a
    direct call of the same composite."""
    kw = _pairs_kw(q, ck)
    if any(tapir.is_traced(t) for t in (q, ck, cv, valid_len)):
        return tapir.lift(_masked_decode_attention, q, ck, cv, valid_len,
                          **kw)
    return _masked_decode_attention(q, ck, cv, valid_len, **kw)


def _pairs_kw(q, ck) -> dict:
    """``{"pairs": (rows, kv heads)}`` of the whole call where this rank
    holds a share of the masked composite's (row, kv head) pairs (read
    off ``dist.logical_sizes``), else ``{}``: one device keeps its call."""
    rows, kv_heads = q.shape[0], ck.shape[2]
    sizes = current_sizes()
    whole = (sizes.get("batch", rows), sizes.get("kv", kv_heads))
    return {} if whole == (rows, kv_heads) else {"pairs": whole}


def _masked_decode_attention(q, ck, cv, valid_len, pairs=None):
    """Masked attention over a static-length KV view.  q: [B,S,H,hd],
    ck/cv: [B,maxlen,Hkv,hd]; key positions >= the query's position are
    masked; ``valid_len`` is a scalar or a per-slot [B] vector.  Scores and
    the PV product accumulate in fp32 (the reference's
    ``preferred_element_type``), and masked scores take fp32's most
    negative finite value, as there.

    ``pairs`` (a mesh rank's call, ``_pairs_kw``): the whole call's
    (rows, kv heads).  The rank's share is zero-padded up to it, so the
    einsums run at the one-device call's shape and cuBLAS takes the same
    kernels: each pair keeps its bits, and only the mesh pays for the
    padding."""
    if pairs is not None:
        return _on_whole_pairs(q, ck, cv, valid_len, pairs)
    B, S, H, hd = q.shape
    maxlen, Hkv = ck.shape[1], ck.shape[2]
    grp = H // Hkv
    f32 = torch.float32
    qg = q.reshape(B, S, Hkv, grp, hd).to(f32)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, ck.to(f32)) / np.sqrt(hd)
    kpos = torch.arange(maxlen, device=q.device)
    qpos = valid_len[..., None] - S + torch.arange(S, device=q.device)
    mask = kpos <= qpos[..., None]
    if mask.ndim == 2:
        mask = mask[None]
    s = torch.where(mask[:, None, None], s, torch.finfo(f32).min)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p.to(cv.dtype).to(f32),
                     cv.to(f32))
    return o.reshape(B, S, H, hd).to(q.dtype)


def _on_whole_pairs(q, ck, cv, valid_len, pairs):
    """``_masked_decode_attention`` of a share of the pairs, run at the
    whole call's shape: the share in the corner of zeros (padded rows
    have no valid key, so their softmax is uniform, never NaN)."""
    B, S, H, hd = q.shape
    Hkv = ck.shape[2]
    grp = H // Hkv
    Bw, Hw = pairs
    qw = q.new_zeros((Bw, S, Hw, grp, hd))
    qw[:B, :, :Hkv] = q.reshape(B, S, Hkv, grp, hd)
    kw = ck.new_zeros((Bw, ck.shape[1], Hw, hd))
    kw[:B, :, :Hkv] = ck
    vw = cv.new_zeros((Bw, cv.shape[1], Hw, hd))
    vw[:B, :, :Hkv] = cv
    vl = valid_len
    if vl.ndim:
        vl = valid_len.new_zeros((Bw,))
        vl[:B] = valid_len
    o = _masked_decode_attention(qw.reshape(Bw, S, Hw * grp, hd), kw, vw,
                                 vl)
    return o.reshape(Bw, S, Hw, grp, hd)[:B, :, :Hkv].reshape(B, S, H, hd)


def _page_coords(pos, *, page_len):
    """Split absolute positions into (page index, in-page offset)."""
    return ((pos // page_len).to(torch.int32),
            (pos % page_len).to(torch.int32))


def _page_coords_t(pos, *, page_len):
    if tapir.is_traced(pos):
        return tapir.lift(_page_coords, pos, page_len=page_len)
    return _page_coords(pos, page_len=page_len)


def _paged_decode_attention(q, ck, cv, ptab, valid_len, pairs=None):
    """Masked attention over each slot's view ``pool[ptab[s]]`` of the page
    pool: each query row depends only on its own keys, never on which
    pages back them."""
    B = q.shape[0]
    pl, Hkv, hd = ck.shape[1], ck.shape[2], ck.shape[3]
    pps = ptab.shape[-1]
    idx = ptab.to(torch.int64)
    vk = ck[idx].reshape(B, pps * pl, Hkv, hd)
    vv = cv[idx].reshape(B, pps * pl, Hkv, hd)
    return _masked_decode_attention(q, vk, vv, valid_len, pairs)


def _paged_attention(q, ck, cv, ptab, valid_len):
    kw = _pairs_kw(q, ck)
    if any(tapir.is_traced(t) for t in (q, ck, cv, ptab, valid_len)):
        return tapir.lift(_paged_decode_attention, q, ck, cv, ptab,
                          valid_len, **kw)
    return _paged_decode_attention(q, ck, cv, ptab, valid_len, **kw)


def _paged_prefill_attention(q, ck, cv, prow, valid_len, pairs=None):
    """Prefill attention for one slot through its page row (q: [1,S,H,hd],
    prow: [pps]); the masked decode composite, so a suffix prefill is
    row-for-row equal to a full one."""
    pl, Hkv, hd = ck.shape[1], ck.shape[2], ck.shape[3]
    pps = prow.shape[-1]
    idx = prow.to(torch.int64)
    vk = ck[idx].reshape(1, pps * pl, Hkv, hd)
    vv = cv[idx].reshape(1, pps * pl, Hkv, hd)
    return _masked_decode_attention(q, vk, vv, valid_len, pairs)


def _paged_prefill_attn(q, ck, cv, prow, valid_len):
    kw = _pairs_kw(q, ck)
    if any(tapir.is_traced(t) for t in (q, ck, cv, prow, valid_len)):
        return tapir.lift(_paged_prefill_attention, q, ck, cv, prow,
                          valid_len, **kw)
    return _paged_prefill_attention(q, ck, cv, prow, valid_len, **kw)
