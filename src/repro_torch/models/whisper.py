"""Whisper-style encoder-decoder (the whisper-small backbone) — the port of
the JAX package's ``models/whisper.py``.

The conv frontend is a stub, as there: the caller passes the frame
embeddings ``frames [B, n_frames, d_model]`` the two conv layers would
emit.  Encoder: bidirectional self-attention and a GELU MLP over learned
positions.  Decoder: causal self-attention, cross-attention to the encoder
output, the GELU MLP, and the head tied to ``embed``.  Every block is
pre-LayerNorm (scale only); Q and V are biased, K is not; the MLP is
``linear + bias + gelu`` then ``linear + bias``.

``WhisperED`` is an ``nn.Module`` owning its parameters under the
reference tree's names (``embed``, ``enc_pos``, ``dec_pos``, ``enc`` and
``dec`` — flat dicts of ``[L, ...]`` leaves, ``sa_`` / ``ca_`` prefixed —
``enc_ln_f``, ``dec_ln_f``), kept in ``param_dtype`` (fp32) and cast to
the compute dtype before use.

Forward: the encoder's blocks, each ONE ``whisper_enc_block`` region
(norm, the Q/K/V GEMMs with their biases, the non-causal flash node, the
O-projection with its residual, the MLP), then the decoder's, each ONE
``whisper_dec_block`` region (self-attention, cross-attention whose K/V
are the encoder output's projections, the MLP), then the tied head,
``embed.T``, which the GEMM reads K-major in place.

Padded cache (``init_cache`` / ``prefill`` / ``decode_step``): ``k`` /
``v [L, B, max_len, H, hd]``, the cross ``ck`` / ``cv [L, B, n_frames, H,
hd]`` and a scalar ``pos``.  Each decoder layer is ONE
``whisper_cached_block`` region that writes its slabs in place (donated
``dynamic_update_slice``): at prefill the self K/V at ``pos`` and the
cross K/V, computed once from the encoder output; at decode the self K/V
only, with the cross-attention a flash launch of one query row over the
cached ``n_frames`` keys.  The params are cast once
(``compute_params``), the decoder position rows are gathered on the device
from ``pos`` into a kept buffer, the head is a ``whisper_head`` region and
``pos`` advances in place, so a decode step's region inputs are the same
tensors at every step.

``prefill`` needs ``frames``: without them it raises, where the reference
fails on ``frames.astype``.  So no serving engine serves this family: the
reference's engine calls ``prefill(params, tokens, cache)`` with no frames.
Left out for the mesh (ROADMAP queue 1, item 8): ``cache_axes`` and every
``shard_act``.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..core import tapir
from ..core.dtypes import to_torch_dtype
from . import layers as L
from .base import (BaseModel, InputSpec, ModelConfig, ParamSpec,
                   _check_shapes,
                   _frozen, _frozen_tree, _materialize_tree, _plain_tree,
                   embed_lookup, keep_in_place, register_family,
                   resolve_device)
from .transformer import _decode_attention


def _attn_specs(cfg: ModelConfig, n_layers: int, prefix: str) -> dict:
    d, H, hd = cfg.d_model, cfg.n_heads, cfg.hd
    pdt = cfg.param_dtype
    Lx = (n_layers,)
    return {
        f"{prefix}wq": ParamSpec(Lx + (d, H * hd), pdt,
                                 ("layers", "embed", "heads")),
        f"{prefix}wk": ParamSpec(Lx + (d, H * hd), pdt,
                                 ("layers", "embed", "kv")),
        f"{prefix}wv": ParamSpec(Lx + (d, H * hd), pdt,
                                 ("layers", "embed", "kv")),
        f"{prefix}wo": ParamSpec(Lx + (H * hd, d), pdt,
                                 ("layers", "heads", "embed")),
        f"{prefix}bq": ParamSpec(Lx + (H * hd,), pdt, ("layers", "heads"),
                                 "zeros"),
        f"{prefix}bv": ParamSpec(Lx + (H * hd,), pdt, ("layers", "kv"),
                                 "zeros"),
        f"{prefix}ln": ParamSpec(Lx + (d,), pdt, ("layers", "embed"), "ones"),
    }


def _mlp_specs(cfg: ModelConfig, n_layers: int) -> dict:
    d, ff = cfg.d_model, cfg.d_ff
    pdt = cfg.param_dtype
    Lx = (n_layers,)
    return {
        "wu": ParamSpec(Lx + (d, ff), pdt, ("layers", "embed", "mlp")),
        "bu": ParamSpec(Lx + (ff,), pdt, ("layers", "mlp"), "zeros"),
        "wd": ParamSpec(Lx + (ff, d), pdt, ("layers", "mlp", "embed")),
        "bd": ParamSpec(Lx + (d,), pdt, ("layers", "embed"), "zeros"),
        "ln_mlp": ParamSpec(Lx + (d,), pdt, ("layers", "embed"), "ones"),
    }


def abstract_params(cfg: ModelConfig) -> dict:
    """ParamSpec tree with the reference's structure and names."""
    pdt = cfg.param_dtype
    d = cfg.d_model
    return {
        "embed": ParamSpec((cfg.vocab, d), pdt, ("vocab", "embed")),
        "enc_pos": ParamSpec((cfg.n_frames, d), pdt, ("frames", "embed"),
                             "small", scale=0.02),
        "dec_pos": ParamSpec((cfg.max_seq, d), pdt, ("pos", "embed"),
                             "small", scale=0.02),
        "enc": {**_attn_specs(cfg, cfg.n_enc_layers, "sa_"),
                **_mlp_specs(cfg, cfg.n_enc_layers)},
        "dec": {**_attn_specs(cfg, cfg.n_layers, "sa_"),
                **_attn_specs(cfg, cfg.n_layers, "ca_"),
                **_mlp_specs(cfg, cfg.n_layers)},
        "enc_ln_f": ParamSpec((d,), pdt, ("embed",), "ones"),
        "dec_ln_f": ParamSpec((d,), pdt, ("embed",), "ones"),
    }


def _embed_at(embed, tokens, pos_rows, cdt: str):
    """Token rows of ``embed`` plus the position rows ``pos_rows [S, d]``,
    both in the compute dtype ``cdt`` (the reference's ``take(...).astype
    + posemb.astype``) — module-level so a region captures it as one
    node."""
    dt = to_torch_dtype(cdt)
    return embed_lookup(embed, tokens, cdt) + pos_rows.to(dt)[None]


#: the top-level leaves of the tree (``enc`` / ``dec`` are the stacks)
_LEAVES = ("embed", "enc_pos", "dec_pos", "enc_ln_f", "dec_ln_f")


@register_family("encdec")
class WhisperED(BaseModel):
    """``params`` (a tree like ``abstract_params`` of tensors) supplies the
    weights; otherwise they are drawn from ``generator`` (default: seed 0
    on ``device``) by the reference's init rule, leaf by leaf in sorted
    key order.  ``device`` defaults to ``cuda`` and raises without a
    card."""

    def __init__(self, cfg: ModelConfig, device="cuda",
                 params: Optional[dict] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if cfg.family != "encdec":
            raise NotImplementedError(f"WhisperED builds the 'encdec' "
                                      f"family, not {cfg.family!r}")
        self.cfg = cfg
        dev = resolve_device(device)
        specs = abstract_params(cfg)
        if params is None:
            if generator is None:
                generator = torch.Generator(device=dev).manual_seed(0)
            params = _materialize_tree(specs, generator, dev)
        _check_shapes(specs, params, "params")
        for k in _LEAVES:
            setattr(self, k, _frozen(params[k].to(dev)))
        self.enc = _frozen_tree(params["enc"], dev)
        self.dec = _frozen_tree(params["dec"], dev)
        self._compute = None
        self._pos_bufs: dict = {}       # decode position rows, per S

    def param_tree(self) -> dict:
        """The reference's tree of the model's own tensors."""
        tree = {k: getattr(self, k) for k in _LEAVES}
        tree["enc"] = _plain_tree(self.enc)
        tree["dec"] = _plain_tree(self.dec)
        return tree

    def compute_params(self) -> dict:
        """The decoder layers' weights and ``dec_pos`` in the compute dtype,
        the head's ``dec_ln_f`` and tied ``embed.T`` (cast with its strides
        kept: the GEMM reads it K-major in place), cast once and kept until
        a weight changes (``BaseModel.compute_params``' rule): a decode
        step's region inputs are then the same tensors at every step.
        ``embed`` stays in the param dtype."""
        leaves = (*self.dec.parameters(), self.dec_pos, self.dec_ln_f,
                  self.embed)
        stamp = tuple((t._version, t.data_ptr()) for t in leaves)
        if self._compute is None or self._compute[0] != stamp:
            cdt = to_torch_dtype(self.cfg.compute_dtype)
            cp = {"dec": [{k: v[i].to(cdt) for k, v in self.dec.items()}
                          for i in range(self.cfg.n_layers)],
                  "dec_pos": self.dec_pos.data.to(cdt),
                  "head": {"ln_f": self.dec_ln_f.data,
                           "w": self.embed.data.T.to(cdt)},
                  "embed": self.embed.data}
            self._compute = stamp, cp
        return self._compute[1]

    # -- attention and MLP --------------------------------------------------
    def _attn(self, p, prefix, x, kv_src, causal, kv_cache=None):
        """Pre-norm attention with its residual: Q from ``x``, K / V from
        ``kv_src`` (the encoder output: cross-attention) or from ``x``.
        With ``kv_cache`` ``(ck, cv, pos0, is_prefill)`` the self K/V are
        written at ``pos0`` (in place under a region) and decode attends
        over the cache with the masked composite."""
        cfg = self.cfg
        B, S, _ = x.shape
        H, hd = cfg.n_heads, cfg.hd
        xn = L.layernorm(x, p[f"{prefix}ln"])
        src = xn if kv_src is None else kv_src
        q = tapir.linear(xn, p[f"{prefix}wq"], p[f"{prefix}bq"])
        k = tapir.linear(src, p[f"{prefix}wk"])
        v = tapir.linear(src, p[f"{prefix}wv"], p[f"{prefix}bv"])
        Skv = src.shape[1]
        q = q.reshape(B, S, H, hd)
        k = k.reshape(B, Skv, H, hd)
        v = v.reshape(B, Skv, H, hd)
        if kv_cache is None:
            o = tapir.attention(q, k, v, causal=causal)
        else:
            ck, cv, cpos, is_prefill = kv_cache
            ck = tapir.cache_write(ck, k, (0, cpos, 0, 0))
            cv = tapir.cache_write(cv, v, (0, cpos, 0, 0))
            if is_prefill:
                o = tapir.attention(q, k, v, causal=True)
            else:
                o = _decode_attention(q, ck, cv, cpos + S)
            kv_cache = (ck, cv)
        out = x + tapir.linear(o.reshape(B, S, H * hd), p[f"{prefix}wo"])
        return out, kv_cache

    def _mlp(self, p, x):
        xn = L.layernorm(x, p["ln_mlp"])
        h = tapir.linear(xn, p["wu"], p["bu"], activation="gelu")
        return x + tapir.linear(h, p["wd"], p["bd"])

    # -- encoder ------------------------------------------------------------
    def _enc_block_body(self, p, x):
        x, _ = self._attn(p, "sa_", x, None, causal=False)
        return self._mlp(p, x)

    def encode(self, frames, params: Optional[dict] = None):
        """The encoder output ``[B, n_frames, d]`` of ``frames``, every
        weight read from ``params`` (default: ``param_tree()``) and cast
        per layer, as the reference's ``encode`` (the prefill calls it
        too)."""
        if params is None:
            params = self.param_tree()
        cdt = to_torch_dtype(self.cfg.compute_dtype)
        h = frames.to(cdt) + params["enc_pos"][:frames.shape[1]].to(cdt)[None]
        blk = tapir.parallel_region(self._enc_block_body,
                                    name="whisper_enc_block")
        cdt = h.dtype

        def body(p, x):
            return blk({k: v.to(cdt) for k, v in p.items()}, x)

        h = tapir.scan_layers(body, params["enc"], h)
        return L.layernorm(h, params["enc_ln_f"])

    # -- decoder ------------------------------------------------------------
    def _dec_block_body(self, p, x, enc_out):
        x, _ = self._attn(p, "sa_", x, None, causal=True)
        x, _ = self._attn(p, "ca_", x, enc_out, causal=False)
        return self._mlp(p, x)

    def forward(self, batch: dict, params: Optional[dict] = None):
        """Logits ``[B, S, vocab]`` of ``batch["tokens"] [B, S]`` given
        ``batch["frames"] [B, n_frames, d]``, every weight read from
        ``params`` (default: ``param_tree()``)."""
        if params is None:
            params = self.param_tree()
        enc_out = self.encode(batch["frames"], params)
        tokens = batch["tokens"]
        h = tapir.lift(_embed_at, params["embed"], tokens,
                       params["dec_pos"][:tokens.shape[1]],
                       cdt=self.cfg.compute_dtype)
        blk = tapir.parallel_region(self._dec_block_body,
                                    name="whisper_dec_block")
        cdt = h.dtype

        def body(p, x):
            return blk({k: v.to(cdt) for k, v in p.items()}, x, enc_out)

        h = tapir.scan_layers(body, params["dec"], h)
        h = L.layernorm(h, params["dec_ln_f"])
        return tapir.linear(h, params["embed"].T.to(cdt))

    # -- padded-cache serving -------------------------------------------------
    def init_cache(self, batch: int, max_len: int) -> dict:
        """``k`` / ``v [L, batch, max_len, H, hd]`` and the cross ``ck`` /
        ``cv [L, batch, n_frames, H, hd]`` in the compute dtype; ``pos``:
        the shared length, a scalar int32."""
        cfg = self.cfg
        cdt = to_torch_dtype(cfg.compute_dtype)
        Ln, H, hd, dev = cfg.n_layers, cfg.n_heads, cfg.hd, self.device
        self_shape = (Ln, batch, max_len, H, hd)
        cross_shape = (Ln, batch, cfg.n_frames, H, hd)
        return {"k": torch.zeros(self_shape, dtype=cdt, device=dev),
                "v": torch.zeros(self_shape, dtype=cdt, device=dev),
                "ck": torch.zeros(cross_shape, dtype=cdt, device=dev),
                "cv": torch.zeros(cross_shape, dtype=cdt, device=dev),
                "pos": torch.zeros((), dtype=torch.int32, device=dev)}

    def _cached_dec_block_body(self, p, x, enc_out, ck, cv, cck, ccv, pos0,
                               is_prefill: bool):
        """One decoder block against its cache slabs: self-attention with
        its K/V written at ``pos0``; at prefill the cross K/V computed from
        ``enc_out`` and written over their slabs (once); cross-attention
        over the cross slabs; the MLP.  Under region capture every write
        donates its slab, which the program updates in place.  Returns
        ``(x, ck, cv, cck, ccv)`` at prefill, ``(x, ck, cv)`` at decode
        (the cross slabs are only read)."""
        cfg = self.cfg
        B, S = x.shape[0], x.shape[1]
        H, hd = cfg.n_heads, cfg.hd
        x, (ck, cv) = self._attn(p, "sa_", x, None, causal=True,
                                 kv_cache=(ck, cv, pos0, is_prefill))
        if is_prefill:
            nf = enc_out.shape[1]
            kx = tapir.linear(enc_out, p["ca_wk"]).reshape(B, nf, H, hd)
            vx = tapir.linear(enc_out, p["ca_wv"], p["ca_bv"]
                              ).reshape(B, nf, H, hd)
            cck = tapir.cache_write(cck, kx, (0, 0, 0, 0))
            ccv = tapir.cache_write(ccv, vx, (0, 0, 0, 0))
        qn = L.layernorm(x, p["ca_ln"])
        q = tapir.linear(qn, p["ca_wq"], p["ca_bq"]).reshape(B, S, H, hd)
        o = tapir.attention(q, cck, ccv, causal=False)
        x = x + tapir.linear(o.reshape(B, S, H * hd), p["ca_wo"])
        x = self._mlp(p, x)
        return (x, ck, cv, cck, ccv) if is_prefill else (x, ck, cv)

    def _head_body(self, hp, x):
        """The last position's logits from the params cast once."""
        x = L.layernorm(x, hp["ln_f"])
        return tapir.linear(x, hp["w"])[:, -1]

    def _pos_rows(self, pos, n: int, table) -> torch.Tensor:
        """Rows ``[start, start + n)`` of ``table`` (the compute-dtype
        ``dec_pos``) with ``start = pos`` clamped to ``[0, rows - n]``
        (``dynamic_slice_in_dim``'s clamp), gathered on the device into a
        buffer kept per ``n``: no host sync, and the same tensor at every
        step."""
        key = (n, str(pos.device))
        buf = self._pos_bufs.get(key)
        if buf is None or buf.dtype != table.dtype:
            buf = self._pos_bufs[key] = torch.empty(
                (n, table.shape[-1]), dtype=table.dtype, device=pos.device)
        start = pos.clamp(0, table.shape[0] - n)
        rows = start + torch.arange(n, dtype=pos.dtype, device=pos.device)
        torch.index_select(table, 0, rows, out=buf)
        return buf

    def _run_with_cache(self, tokens, cache, frames, is_prefill: bool):
        """Logits ``[B, vocab]`` of the last position; the cache's slabs and
        ``pos`` are updated in place."""
        cfg = self.cfg
        cp = self.compute_params()
        pos0 = cache["pos"]
        S = int(tokens.shape[1])
        if is_prefill:
            rows = cp["dec_pos"][:S]
            enc_out = self.encode(frames)
        else:
            rows = self._pos_rows(pos0, S, cp["dec_pos"])
            enc_out = None
        h = _embed_at(cp["embed"], tokens, rows, cdt=cfg.compute_dtype)
        blk = tapir.parallel_region(self._cached_dec_block_body,
                                    name="whisper_cached_block")
        regions = tapir.get_config().regions
        for i in range(cfg.n_layers):
            slabs = (cache["k"][i], cache["v"][i], cache["ck"][i],
                     cache["cv"][i])
            h, *new = blk(cp["dec"][i], h, enc_out, *slabs, pos0,
                          is_prefill)
            keep_in_place(slabs[:len(new)], new, regions, f"layer {i}")
        head = tapir.parallel_region(self._head_body, name="whisper_head")
        logits = head(cp["head"], h[:, -1:])
        pos0.add_(S)
        return logits, cache

    def prefill(self, tokens, cache, frames=None):
        """Prompts ``tokens [B, S]`` into an empty ``cache`` after encoding
        ``frames [B, n_frames, d]``; returns (logits ``[B, vocab]`` at
        position S-1, cache).  The cache's tensors are updated in place.
        Without ``frames`` it raises: there is nothing to attend to."""
        if frames is None:
            raise ValueError(
                "WhisperED.prefill needs the audio frames "
                "(prefill(tokens, cache, frames)): the decoder's "
                "cross-attention reads the encoder output, so the family "
                "cannot be served from token prompts alone")
        return self._run_with_cache(tokens, cache, frames, is_prefill=True)

    def decode_step(self, tokens, cache):
        """``tokens [B, S]`` at positions ``pos ..``; returns (logits
        ``[B, vocab]`` of the last, cache)."""
        return self._run_with_cache(tokens, cache, None, is_prefill=False)

    # -- inputs -----------------------------------------------------------
    def input_specs(self, seq_len: int, batch: int, kind: str) -> dict:
        """The base specs plus the stub frontend's ``frames [batch,
        n_frames, d_model]`` in the compute dtype for train and prefill."""
        cfg = self.cfg
        specs = super().input_specs(seq_len, batch, kind)
        if kind in ("train", "prefill"):
            specs["frames"] = InputSpec(
                (batch, cfg.n_frames, cfg.d_model),
                to_torch_dtype(cfg.compute_dtype))
        return specs
