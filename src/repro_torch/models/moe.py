"""Mixture-of-Experts LM (Moonlight-16B-A3B, Granite-3.0-1B-A400M) — the
port of the JAX package's ``models/moe.py``.

Routing is capacity-based top-k with renormalized gates.  The expert FFN
goes through ``tapir.expert_mlp``: in opaque mode its three GEMMs lower to
one isolated launch of the 2-D GEMM kernel per expert; in tapir mode each
is ONE launch of the kernel's grouped route, the gate's with its ``silu,
mul`` epilogue fused — the MoE instance of the paper's exposed-library
claim.

The router's product ``x @ router`` is taken in fp32 through the GEMM
kernel's fp32 route (``route_logits``), whose plan is a function of (n, k)
alone: a token's logits, and so its experts and gates, never depend on
which other rows run.  The grouped GEMM is M-stable in the same way and a
row's result does not depend on where the dispatch put it in its expert's
buffer, so a dropless decode step over 1, 2 or 4 live slots, and a suffix
prefill, give each row the bits of their baselines.

Dropless where ``S == 1`` (decode) and in slot prefill; the forward, the
padded prefill and the training forward drop past ``capacity_factor`` as
the reference does.

On a mesh (explicit SPMD, ``launch/mesh.py``) the expert leaves are
placed by whole experts: ``E / model`` of them a rank
(``dist.sharding.weight_spec``), the router replicated.  The routed FFN
is one mechanism per op and in regions: a rank routes its data shard's
rows (so the forward's capacity is counted per data shard, the
reference's expert-parallel ``_moe_ffn_ep``), scatters them into the
whole ``[E, cap, d]``, keeps its experts' block (``shard_act`` on
``"expert"``), runs ``expert_mlp`` on it with its expert blocks, and
all-gathers the outputs on the expert dim in rank order before the
gather and combine, which run as on one device.  Where the reference
adds the ranks' partial combines (``psum`` over ``model``), the port
never splits a sum: each token's k routes are added in the one-device
order.  The padded prefill gathers the batch first, so its capacity is
the whole batch's, as on one device.

Training: the loss differentiates through the router's fp32 product (the
fp32 route's dX / dW), the softmax and the top-k values, the dispatch
scatter (``index_put_(accumulate=True)`` on fresh zeros), the expert FFN
(the grouped route's dX / dW, the gate's ``silu, mul`` chain through its
recomputed product), the combine's gather and the fp32 sum over the k
routes.  A dropped route aims at row ``cap - 1`` with a zero update, and
its cotangent is zeroed by the ``where`` before the gather, so duplicate
targets only ever add exact zeros: the backward is deterministic.  No
auxiliary load-balancing loss: the reference has none.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from ..core import tapir
from ..core.dtypes import to_torch_dtype
from ..dist import shard_act
from ..kernels.fused_matmul import ops as fm_ops
from . import layers as L
from .base import ModelConfig, ParamSpec, register_family
from .transformer import DenseLM, _block_specs, abstract_params


def _moe_block_specs(cfg: ModelConfig, n_layers: int) -> dict:
    spec = _block_specs(cfg, n_layers)
    for key in ("wg", "wu", "wd"):
        spec.pop(key, None)
    d, ff, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    pdt = cfg.param_dtype
    Lx = (n_layers,)
    spec["router"] = ParamSpec(Lx + (d, E), pdt, ("layers", "embed", None))
    spec["ewg"] = ParamSpec(Lx + (E, d, ff), pdt,
                            ("layers", "expert", "embed", "mlp"))
    spec["ewu"] = ParamSpec(Lx + (E, d, ff), pdt,
                            ("layers", "expert", "embed", "mlp"))
    spec["ewd"] = ParamSpec(Lx + (E, ff, d), pdt,
                            ("layers", "expert", "mlp", "embed"))
    return spec


def moe_abstract_params(cfg: ModelConfig) -> dict:
    """The reference's tree: ``blocks.dense`` (the first
    ``first_dense_layers`` layers, where there are any) and ``blocks.moe``,
    each stacked ``[L, ...]``."""
    p = abstract_params(cfg)
    F = cfg.first_dense_layers
    blocks = {}
    if F > 0:
        blocks["dense"] = _block_specs(cfg, F)
    blocks["moe"] = _moe_block_specs(cfg, cfg.n_layers - F)
    p["blocks"] = blocks
    return p


def route_logits(xt, router):
    """``xt [T, d] @ router [d, E]`` in fp32 through the GEMM kernel's fp32
    route (the plain version on a CPU tensor): its plan is a function of
    (E, d) alone, so a row's logits are the same bits at every T, where
    ``torch.matmul`` may pick another algorithm for another row count."""
    f32 = torch.float32
    if xt.is_meta:   # ``tapir.lift``'s shape inference: no values
        return xt.new_empty((xt.shape[0], router.shape[-1]), dtype=f32)
    return fm_ops.fused_matmul(xt.to(f32), router.to(f32), out_dtype=f32)


def _route_topk(xt, router, *, k: int, e: int, cap: int):
    """Top-k routing: (renormalized gates, expert ids, capacity positions,
    keep mask).  ONE composite shared by the per-op path (called directly)
    and the region path (captured through ``tapir.lift``): the router's
    data-dependent control stays a graph value feeding the dispatch's
    scatter and the combine's gather."""
    T = xt.shape[0]
    probs = torch.softmax(route_logits(xt, router), dim=-1)    # [T, E]
    gate, eidx = torch.topk(probs, k, dim=-1)                  # [T, K]
    gate = gate / torch.sum(gate, dim=-1, keepdim=True)
    # capacity assignment: the position of each (token, k) in its expert
    onehot = (eidx[..., None] == torch.arange(e, device=xt.device)
              ).to(torch.int32)                                # [T, K, E]
    flat = onehot.reshape(T * k, e)
    # the running count down the T*K rows, scanned along the last dim of
    # the transpose: torch's scan over an outer dim only E columns wide
    # walks the rows nearly serially (5.6 ms a layer at T*K = 32768 on the
    # H100); integer sums, so the same values either way
    csum = torch.cumsum(flat.t().contiguous(), dim=1, dtype=torch.int32)
    pos = csum.t() - flat                                      # pre-count
    pos = torch.sum(pos * flat, dim=-1, dtype=torch.int32).reshape(T, k)
    keep = pos < cap
    pos = torch.where(keep, pos, cap - 1)
    return gate, eidx.to(torch.int32), pos, keep


def _dispatch_src(xt, keep, *, k: int, cdt: str):
    """Token rows replicated per routed copy, zeroed where dropped — the
    scatter-add update ``[T*K, d]``."""
    T, d = xt.shape
    src = torch.where(keep[..., None], xt[:, None].expand(T, k, d), 0)
    return src.reshape(T * k, d).to(to_torch_dtype(cdt))


def _combine_expert_out(fetched, keep, gate, *, k: int, cdt: str):
    """Weighted sum of the gathered expert outputs over the k routes: each
    route's product in the compute dtype, the routes added in order in
    fp32 and rounded once (a row's sum never depends on how many rows
    run)."""
    T = keep.shape[0]
    d = fetched.shape[-1]
    dt = to_torch_dtype(cdt)
    f = torch.where(keep[..., None], fetched.reshape(T, k, d), 0)
    prod = f * gate[..., None].to(dt)
    acc = prod[:, 0].to(torch.float32)
    for j in range(1, k):
        acc = acc + prod[:, j].to(torch.float32)
    return acc.to(dt)


@register_family("moe")
class MoELM(DenseLM):
    """A ``DenseLM`` whose FFN is the routed expert FFN; the first
    ``first_dense_layers`` layers stay dense.  ``blocks`` holds ``dense``
    (where there are such layers) and ``moe``, each stacked."""

    FAMILY = "moe"

    def _param_specs(self) -> dict:
        return moe_abstract_params(self.cfg)

    def _compute_layers(self, cdt) -> list:
        """``compute_params``' layers with their kind markers: ``("dense",
        p)`` for each first dense layer, then ``("moe", p)``."""
        out = []
        for kind in ("dense", "moe"):
            if kind not in self.blocks:
                continue
            blk = self.blocks[kind]
            n = next(iter(blk.values())).shape[0]
            out += [(kind, {k: v[i].to(cdt) for k, v in blk.items()})
                    for i in range(n)]
        return out

    def logical_sizes(self, batch: int) -> dict:
        return {**super().logical_sizes(batch),
                "expert": self.cfg.n_experts}

    def _slot_layers(self, field: str) -> list:
        """``slot_params()``' layers of one ``ParamSpec`` field (``axes``
        or ``shape``, the stacked dim dropped), each under its kind
        marker: the router and expert leaves under ``"moe"``."""
        cfg = self.cfg
        per = {kind: {k: tuple(getattr(s, field)[1:])
                      for k, s in specs(cfg, 1).items()}
               for kind, specs in (("dense", _block_specs),
                                   ("moe", _moe_block_specs))}
        F = cfg.first_dense_layers
        kinds = ["dense"] * F + ["moe"] * (cfg.n_layers - F)
        return [(k, dict(per[k])) for k in kinds]

    def slot_param_axes(self) -> dict:
        return {**super().slot_param_axes(),
                "layers": self._slot_layers("axes")}

    def slot_param_shapes(self) -> dict:
        return {**super().slot_param_shapes(),
                "layers": self._slot_layers("shape")}

    # -- the routed FFN ------------------------------------------------------
    def _moe_cap(self, T: int, S: int, dropless: bool) -> int:
        cfg = self.cfg
        cap = max(1, int(math.ceil(T * cfg.top_k / cfg.n_experts
                                   * cfg.capacity_factor)))
        cap = min(cap, T)
        if S == 1 or dropless:
            # decode and slot prefill: dropless (capacity is a training
            # construct; a dropped token would corrupt generation, and
            # bucket padding would evict real tokens)
            cap = T
        return cap

    def _moe_ffn(self, p, x, dropless: bool = False,
                 whole_batch: bool = False):
        """The routed FFN over ``x [B, S, d]``: route, scatter the tokens
        into ``[E, cap, d]`` (past capacity dropped unless dropless),
        the expert FFN, gather back, combine.  Inside a region the WHOLE
        dispatch is region nodes: the router one lifted composite whose
        outputs (gate / eidx / pos / keep) are graph values, the dispatch a
        ``zero_init`` scatter and the combine a gather indexed by them, so
        a MoE decode step's block is ONE region program, router included.
        Outside a region the same calls run op by op (the reference's
        ``_moe_ffn_global``).

        On a mesh ``x`` is this rank's data shard, so ``T`` (and the
        capacity) is its own: the reference's expert-parallel dispatch.
        The dispatch buffer is cut to this rank's experts, the expert FFN
        runs on them, and the outputs are all-gathered on the expert dim
        in rank order (no sum across ranks).  ``whole_batch`` (the padded
        prefill) first gathers every data rank's rows, so the capacity is
        counted over the whole batch as one device counts it, and returns
        this rank's rows."""
        cfg = self.cfg
        if whole_batch:
            x = shard_act(shard_act(x, "batch", None, None), None, None, None)
        B, S, d = x.shape
        T = B * S
        E, K = cfg.n_experts, cfg.top_k
        cap = self._moe_cap(T, S, dropless)
        cdt = str(x.dtype).split(".")[-1]
        xt = x.reshape(T, d)
        gate, eidx, pos, keep = tapir.lift(_route_topk, xt, p["router"],
                                           k=K, e=E, cap=cap)
        src = tapir.lift(_dispatch_src, xt, keep, k=K, cdt=cdt)
        ef, pf = eidx.reshape(T * K), pos.reshape(T * K)
        xe = tapir.scatter_new((E, cap, d), cdt, (ef, pf), src, mode="add")
        # on a mesh: this rank's experts, then every rank's outputs
        xe = shard_act(xe, "expert", None, None)
        ye = tapir.expert_mlp(xe, p["ewg"], p["ewu"], p["ewd"], cfg.act)
        ye = shard_act(shard_act(ye, "expert", None, None), None, None, None)
        fetched = tapir.gather(ye, (ef, pf))
        out = tapir.lift(_combine_expert_out, fetched, keep, gate, k=K,
                         cdt=cdt).reshape(B, S, d)
        return shard_act(out, "batch", None, None) if whole_batch else out

    # -- forward ---------------------------------------------------------
    def backbone(self, h, blocks: Optional[dict] = None):
        """The dense layers (each ONE region, as ``DenseLM``'s), then the
        MoE layers: the attention sub-block a region, the routed FFN per
        op."""
        cos, sin = L.arange_rope_table(int(h.shape[1]), self.cfg.hd,
                                       fraction=self._rope_frac(),
                                       device=self.device)
        cdt = h.dtype
        if blocks is None:
            blocks = self.param_tree()["blocks"]
        attn_blk = tapir.parallel_region(self._attn_body, name="moe_attn")

        def dense_body(p, x):
            p = {k: v.to(cdt) for k, v in p.items()}
            return self._block(p, x, cos, sin)

        def moe_body(p, x):
            p = {k: v.to(cdt) for k, v in p.items()}
            x = attn_blk(p, x, cos, sin)
            return x + self._moe_ffn(p, self._norm(x, p["ln2"]))

        if "dense" in blocks:
            h = tapir.scan_layers(dense_body, blocks["dense"], h)
        return tapir.scan_layers(moe_body, blocks["moe"], h)

    # -- serving ---------------------------------------------------------
    def _cached_moe_block_body(self, p, x, cos, sin, ck, cv, pos0,
                               is_prefill: bool):
        """One MoE block against its cache slab: attention, cache writes
        AND the routed FFN in ONE region (the padded prefill is not
        dropless: S > 1; on a mesh its capacity is the whole batch's)."""
        x, ck, cv = self._cached_attn_body(p, x, cos, sin, ck, cv, pos0,
                                           is_prefill)
        x = x + self._moe_ffn(p, self._norm(x, p["ln2"]),
                              whole_batch=is_prefill)
        return x, ck, cv

    def _cached_bodies(self) -> dict:
        return {"dense": self._cached_block_body,
                "moe": self._cached_moe_block_body}

    def _slot_moe_block_body(self, p, x, rope_cos, rope_sin, ck, cv, pos,
                             ptab):
        """MoE decode block over the paged pool: attention, the page-table
        cache scatter AND the routed FFN in ONE region."""
        x, ck, cv = self._slot_attn_body(p, x, rope_cos, rope_sin, ck, cv,
                                         pos, ptab)
        x = x + self._moe_ffn(p, self._norm(x, p["ln2"]))
        return x, ck, cv

    def _slot_prefill_moe_block_body(self, p, x, rope_cos, rope_sin, ck, cv,
                                     pos_vec, phys_vec, off_vec, prow, vlen):
        # dropless: serving prefill pads prompts to a bucket, and capacity
        # drops there would let padding evict real tokens
        x, ck, cv = self._slot_prefill_attn_body(
            p, x, rope_cos, rope_sin, ck, cv, pos_vec, phys_vec, off_vec,
            prow, vlen)
        x = x + self._moe_ffn(p, self._norm(x, p["ln2"]), dropless=True)
        return x, ck, cv

    def _slot_bodies(self) -> dict:
        return {"dense": self._slot_block_body,
                "moe": self._slot_moe_block_body}

    def _slot_prefill_bodies(self) -> dict:
        return {"dense": self._slot_prefill_block_body,
                "moe": self._slot_prefill_moe_block_body}
