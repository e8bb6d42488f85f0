"""Mamba2 (SSD) blocks and the Zamba2 hybrid (a Mamba2 stack plus one
*shared* attention + MLP block applied after every ``shared_attn_every``
layers) — the port of the JAX package's ``models/mamba.py``.

The SSD recurrence  h_t = a_t h_{t-1} + (dt_t B_t) x_t,  y_t = C_t h_t +
D x_t  is the scalar-decay case of the gated linear-attention scan, so it
runs as the same ``linear_scan`` library node as RWKV6's, in its GLA form
(the inclusive triangle, no ``u``): q = C and k = dt·B broadcast over the
heads, v = the x heads, w = a broadcast over the state dim.  The
reference's Zamba2 simplifications stay as they are: the shared block
reads LN(x) directly (no concat with the embedding, no per-application
LoRA); the layers after the last full group are plain Mamba2.

``Zamba2`` is an ``nn.Module`` owning its parameters under the reference
tree's names (``embed``, ``blocks.{ln, w_in, conv_w, A_log, D, dt_bias,
norm, w_out}`` stacked ``[L, ...]``, ``ln_f``, and ``shared.{ln1, ln2,
wq, wk, wv, wo, wg, wu, wd}`` un-stacked; the head is tied to
``embed``), kept in ``param_dtype`` (fp32) and cast to the compute dtype
before use, as there.  The shared block's weights are cast once per call
where the reference casts them at each application (the same values).

Forward: embed, then per group ``scan_layers`` over ``mamba_block``
regions (each block ONE region program: the in-projection GEMM, the
causal conv, the SSD gates, the scan node, the gated rmsnorm and the
out-projection) and the shared block (``DenseBlocks._block``, a
``dense_block`` region: fused QKV GEMM, RoPE, the flash node, the
O-projection and the gated MLP), then the tied head, ``embed.T``, which
the GEMM reads K-major in place.

Stateful serving (``init_cache`` / ``prefill`` / ``decode_step``): per
Mamba2 layer the conv carry ``[B, K-1, din + 2N]`` in the compute dtype
and the SSM carry ``[B, H, N, hd]`` in fp32, and per shared application a
K/V cache ``[B, max_len, Hkv, hd]``, stacked.  The reference's
``lax.scan`` over layers and its ``concatenate`` / ``stack`` of fresh
state are a Python loop over one ``mamba_stateful_block`` region per layer
and one ``zamba_shared_cached_block`` region per application, each of
which writes its state over its own slabs in place (donated); the params
are cast once (``compute_params``), the head is a ``zamba_stateful_head``
region and ``pos`` advances in place, so a decode step's region inputs
are the same tensors at every step and its programs replay as CUDA
graphs.  The stateful SSD step is one lifted node whose body is the scan
kernel's wrapper with a carried state at ``SAFE_CHUNK`` (the reference
passes chunk 64, past the factored form's exact chunk: ROADMAP queue 3).

Left out for the mesh (ROADMAP queue 1, item 8): ``slot_param_axes``,
``cache_axes`` and every ``shard_act``.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..core import tapir
from ..core.dtypes import dtype_name, to_torch_dtype
from ..kernels.linear_scan import ops as ls_ops
from . import layers as L
from .base import (BaseModel, ModelConfig, ParamSpec, keep_in_place,
                   register_family)
from .transformer import DenseBlocks, _block_specs

CONV_K = 4


def _softplus(x):
    # jax.nn.softplus is logaddexp(x, 0)
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-torch.abs(x)))


def _ssd_gates(xBC, dt, dt_bias, A_log, din, N, H, dtype):
    """SSD gate prep (dt softplus, decay, B/C broadcast to heads) — one
    liftable composite, so the whole Mamba block stays a single region.
    q is a stride-0 view over the heads (the scan kernel reads it in
    place); w is one over the state dim (the kernel's wrapper copies it:
    its last dim must be contiguous)."""
    B_, S = dt.shape[0], dt.shape[1]
    f32 = torch.float32
    Bm = xBC[..., din:din + N]
    Cm = xBC[..., din + N:]
    dtv = _softplus(dt.to(f32) + dt_bias.to(f32))                 # [B,S,H]
    # jnp.clip is max then min (slope 0.5 at either bound)
    lo, hi = dtv.new_full((), -6.0), dtv.new_full((), 4.0)
    la = torch.minimum(torch.maximum(A_log.to(f32), lo), hi)
    a = torch.exp(-torch.exp(la) * dtv)                            # [B,S,H]
    w = a[..., None].expand(B_, S, H, N)
    q = Cm[:, :, None].expand(B_, S, H, N).to(to_torch_dtype(dtype))
    k = (Bm[:, :, None].expand(B_, S, H, N)
         * dtv[..., None]).to(to_torch_dtype(dtype))
    return q, k, w


def _ssm_step(q, k, xc, w, state):
    """Stateful SSD step: one chunked scan carrying the ``[B,H,N,hd]`` SSM
    state in and out — the same stateful-capture problem as a KV-cache
    write."""
    return ls_ops.linear_scan(q, k, xc, w, init_state=state,
                              return_state=True)


def _mamba_dims(cfg: ModelConfig):
    din = cfg.ssm_expand * cfg.d_model
    hd = cfg.ssm_head_dim
    H = din // hd
    N = cfg.ssm_state
    return din, H, hd, N


def _mamba_block_specs(cfg: ModelConfig, n_layers: int) -> dict:
    d = cfg.d_model
    din, H, hd, N = _mamba_dims(cfg)
    pdt = cfg.param_dtype
    Lx = (n_layers,)
    width = 2 * din + 2 * N + H          # z, xc, B, C, dt
    return {
        "ln": ParamSpec(Lx + (d,), pdt, ("layers", "embed"), "ones"),
        "w_in": ParamSpec(Lx + (d, width), pdt, ("layers", "embed", "heads")),
        "conv_w": ParamSpec(Lx + (CONV_K, din + 2 * N), pdt,
                            ("layers", "conv", None), "small"),
        "A_log": ParamSpec(Lx + (H,), pdt, ("layers", "heads"), "zeros"),
        "D": ParamSpec(Lx + (H,), pdt, ("layers", "heads"), "ones"),
        "dt_bias": ParamSpec(Lx + (H,), pdt, ("layers", "heads"), "zeros"),
        "norm": ParamSpec(Lx + (din,), pdt, ("layers", "mlp"), "ones"),
        "w_out": ParamSpec(Lx + (din, d), pdt, ("layers", "heads", "embed")),
    }


def _n_groups(cfg: ModelConfig) -> int:
    if cfg.shared_attn_every <= 0:
        return 0
    return cfg.n_layers // cfg.shared_attn_every


def abstract_params(cfg: ModelConfig) -> dict:
    """ParamSpec tree with the reference's structure and names."""
    pdt = cfg.param_dtype
    p = {
        "embed": ParamSpec((cfg.vocab, cfg.d_model), pdt, ("vocab", "embed")),
        "blocks": _mamba_block_specs(cfg, cfg.n_layers),
        "ln_f": ParamSpec((cfg.d_model,), pdt, ("embed",), "ones"),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = ParamSpec((cfg.d_model, cfg.vocab), pdt,
                                 ("embed", "vocab"))
    if _n_groups(cfg) > 0:
        p["shared"] = {k: ParamSpec(s.shape[1:], s.dtype, s.axes[1:], s.init)
                       for k, s in _block_specs(cfg, 1).items()}
    return p


class _SharedBlock(DenseBlocks):
    """The attention machinery of the shared block (the reference reuses a
    ``DenseLM`` for it): the dense block bodies over ``cfg``, no
    weights of its own."""

    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        self._rope_bufs: dict = {}


@register_family("hybrid")
class Zamba2(BaseModel):
    """n_layers Mamba2 blocks; one shared attention + MLP block (one weight
    set) applied after every ``shared_attn_every`` Mamba layers
    (``shared_attn_every == 0``: a pure Mamba2 LM).  ``params`` (a tree
    like ``abstract_params`` of tensors) supplies the weights; otherwise
    they are drawn from ``generator`` (default: seed 0 on ``device``) by
    the reference's init rule.  ``device`` defaults to ``cuda`` and raises
    without a card."""

    def __init__(self, cfg: ModelConfig, device="cuda",
                 params: Optional[dict] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if cfg.family != "hybrid":
            raise ValueError(f"Zamba2 needs the hybrid family, got "
                             f"{cfg.family}")
        self.cfg = cfg
        self._attn_helper = _SharedBlock(cfg)
        self._set_params(abstract_params(cfg), device, params, generator)

    @property
    def n_groups(self) -> int:
        return _n_groups(self.cfg)

    def _layout(self) -> list:
        """``(lo, hi, g)`` in order: the Mamba2 layers ``[lo, hi)``, then
        the shared block's application ``g`` (None for the plain tail)."""
        cfg = self.cfg
        per, G = cfg.shared_attn_every, self.n_groups
        out = [(g * per, (g + 1) * per, g) for g in range(G)]
        if cfg.n_layers > G * per:
            out.append((G * per, cfg.n_layers, None))
        return out

    # -- mamba2 block -----------------------------------------------------
    def _ssd(self, p, x, conv_state=None, ssm_state=None):
        cfg = self.cfg
        B, S, d = x.shape
        din, H, hd, N = _mamba_dims(cfg)
        zxbcdt = tapir.linear(x, p["w_in"])
        z = zxbcdt[..., :din]
        xBC = zxbcdt[..., din:2 * din + 2 * N]
        dt = zxbcdt[..., 2 * din + 2 * N:]
        xBC, new_conv = L.causal_conv1d(xBC, p["conv_w"], conv_state)
        xBC = tapir.elemwise(xBC, "silu")
        xc = xBC[..., :din].reshape(B, S, H, hd)
        dtype = dtype_name(x.dtype)
        if tapir.is_traced(xBC):
            q, k, w = tapir.lift(_ssd_gates, xBC, dt, p["dt_bias"],
                                 p["A_log"], din=din, N=N, H=H, dtype=dtype)
        else:
            q, k, w = _ssd_gates(xBC, dt, p["dt_bias"], p["A_log"],
                                 din=din, N=N, H=H, dtype=dtype)
        if ssm_state is None:
            y = tapir.wkv_scan(q, k, xc, w)
            new_ssm = None
        elif tapir.is_traced(xBC) or tapir.is_traced(ssm_state):
            y, new_ssm = tapir.lift(_ssm_step, q, k, xc, w, ssm_state)
        else:
            y, new_ssm = _ssm_step(q, k, xc, w, ssm_state)
        # y in xc's dtype; + D xc in fp32, then back to x's dtype
        f32 = torch.float32
        y = y + p["D"].to(f32)[None, None, :, None] * xc.to(f32)
        y = y.reshape(B, S, din).to(x.dtype)
        y = L.rmsnorm(y * tapir.elemwise(z, "silu"), p["norm"])
        out = tapir.linear(y, p["w_out"])
        return out, new_conv, new_ssm

    def _mamba_block_body(self, p, x):
        y, _, _ = self._ssd(p, L.rmsnorm(x, p["ln"]))
        return x + y

    def _mamba_step_body(self, p, x, conv, ssm):
        """One Mamba2 block threading its (conv, ssm) state: the new state
        is written over the old (``cache_write``), so under region capture
        the program writes the donated slabs in place, after every read of
        them."""
        y, new_conv, new_ssm = self._ssd(p, L.rmsnorm(x, p["ln"]),
                                         conv_state=conv, ssm_state=ssm)
        return (x + y, tapir.cache_write(conv, new_conv, (0, 0, 0)),
                tapir.cache_write(ssm, new_ssm, (0, 0, 0, 0)))

    def _mamba_body(self, cdt):
        # whole-region capture: in-proj, causal conv, SSD gates, the scan,
        # gated rmsnorm and out-proj trace into ONE TaskGraph per block
        blk = tapir.parallel_region(self._mamba_block_body,
                                    name="mamba_block")

        def body(p, x):
            p = {k: v.to(cdt) for k, v in p.items()}
            return blk(p, x)
        return body

    def _shared_block(self, sp, x, cos, sin, kv_cache=None):
        """The shared block on the compute-dtype weights ``sp``: forward, the
        dense helper's region-wrapped block; with ``kv_cache`` ``(ck, cv,
        pos0, is_prefill)``, its cached body as one region that writes the
        K/V slabs in place."""
        hp = self._attn_helper
        if kv_cache is None:
            return hp._block(sp, x, cos, sin), None
        ck, cv, pos0, is_prefill = kv_cache
        blk = tapir.parallel_region(hp._cached_block_body,
                                    name="zamba_shared_cached_block")
        x, ck, cv = blk(sp, x, cos, sin, ck, cv, pos0, is_prefill)
        return x, (ck, cv)

    # -- forward ----------------------------------------------------------
    def _stack(self, params, h, cdt):
        body = self._mamba_body(cdt)
        if self.n_groups:
            # positions arange(S), memoized: the regions bind the same
            # tables
            cos, sin = L.arange_rope_table(int(h.shape[1]), self.cfg.hd,
                                           device=self.device)
            sp = {k: v.to(cdt) for k, v in params["shared"].items()}
        for lo, hi, g in self._layout():
            grp = {k: a[lo:hi] for k, a in params["blocks"].items()}
            h = tapir.scan_layers(body, grp, h)
            if g is not None:
                h, _ = self._shared_block(sp, h, cos, sin)
        return h

    def _head(self, x, params: dict):
        x = L.rmsnorm(x, params["ln_f"])
        w = params.get("lm_head")
        if w is None:
            w = params["embed"].T
        return tapir.linear(x, w.to(x.dtype))

    def forward(self, batch: dict, params: Optional[dict] = None):
        """Logits ``[B, S, vocab]`` of ``batch["tokens"] [B, S]``, every
        weight read from ``params`` (default: ``param_tree()``)."""
        if params is None:
            params = self.param_tree()
        h = self._embed(params["embed"], batch["tokens"])
        h = self._stack(params, h, h.dtype)
        return self._head(h, params)

    # -- stateful serving -------------------------------------------------
    def init_cache(self, batch: int, max_len: int) -> dict:
        """``conv`` ``[L, B, K-1, din + 2N]`` and the shared block's
        ``shared_k`` / ``shared_v`` ``[G, B, max_len, Hkv, hd]`` in the
        compute dtype, ``ssm`` ``[L, B, H, N, hd]`` in fp32, and ``pos``,
        the shared length, a scalar int32."""
        cfg = self.cfg
        din, H, hd, N = _mamba_dims(cfg)
        cdt = to_torch_dtype(cfg.compute_dtype)
        Ln, dev = cfg.n_layers, self.device
        c = {
            "conv": torch.zeros((Ln, batch, CONV_K - 1, din + 2 * N),
                                dtype=cdt, device=dev),
            "ssm": torch.zeros((Ln, batch, H, N, hd), dtype=torch.float32,
                               device=dev),
            "pos": torch.zeros((), dtype=torch.int32, device=dev),
        }
        if self.n_groups > 0:
            shape = (self.n_groups, batch, max_len, cfg.n_kv_heads, cfg.hd)
            c["shared_k"] = torch.zeros(shape, dtype=cdt, device=dev)
            c["shared_v"] = torch.zeros(shape, dtype=cdt, device=dev)
        return c

    def _stateful_head_body(self, hp, x):
        """The last position's logits from the params cast once."""
        return tapir.linear(L.rmsnorm(x, hp["ln_f"]), hp["w"])[:, -1]

    def _run_with_cache(self, tokens, cache, is_prefill: bool):
        """Logits ``[B, vocab]`` of the last position; every state tensor
        and ``pos`` are updated in place."""
        cfg = self.cfg
        cp = self.compute_params()
        h = self._embed(self.embed, tokens)
        pos0 = cache["pos"]
        S = int(tokens.shape[1])
        if self.n_groups and is_prefill:
            # positions arange(S) of an empty cache: the forward's table
            cos, sin = L.arange_rope_table(S, cfg.hd, device=tokens.device)
        elif self.n_groups:
            cos, sin = self._attn_helper._rope_rows(
                pos0, S, int(cache["shared_k"].shape[2]))
        blk = tapir.parallel_region(self._mamba_step_body,
                                    name="mamba_stateful_block")
        regions = tapir.get_config().regions
        for lo, hi, g in self._layout():
            for i in range(lo, hi):
                slabs = (cache["conv"][i], cache["ssm"][i])
                h, *new = blk(cp["layers"][i], h, *slabs)
                keep_in_place(slabs, new, regions, f"layer {i}")
            if g is not None:
                slabs = (cache["shared_k"][g], cache["shared_v"][g])
                h, new = self._shared_block(
                    cp["shared"], h, cos, sin,
                    kv_cache=(*slabs, pos0, is_prefill))
                keep_in_place(slabs, new, regions,
                              f"shared application {g}")
        head = tapir.parallel_region(self._stateful_head_body,
                                     name="zamba_stateful_head")
        logits = head(cp["head"], h[:, -1:])
        pos0.add_(S)
        return logits, cache

    def prefill(self, tokens, cache):
        """Prompts ``tokens [B, S]`` into an empty ``cache``; returns
        (logits ``[B, vocab]`` at position S-1, cache).  The state
        tensors and ``pos`` are updated in place."""
        return self._run_with_cache(tokens, cache, is_prefill=True)

    def decode_step(self, tokens, cache):
        """``tokens [B, S]`` after the cached state; returns (logits
        ``[B, vocab]`` of the last, cache)."""
        return self._run_with_cache(tokens, cache, is_prefill=False)
