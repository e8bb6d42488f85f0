"""Model base: config, parameter specs (shape, logical axes, init rule) and
the family registry — the port of the JAX package's ``models/base.py``."""
from __future__ import annotations

import contextlib
import dataclasses
import math
from dataclasses import dataclass
from typing import Callable, Optional

import torch
from torch import nn

from ..core import tapir
from ..core.dtypes import to_torch_dtype
from ..dist import shard_act


def embed_lookup(embed, tokens, cdt: str):
    """Rows of ``embed`` at ``tokens`` in the compute dtype ``cdt`` —
    module-level so a region captures it as one ``pyfunc`` node.  Its
    gradient (autograd's ``index_put_(accumulate=True)`` into zeros) sorts
    the token ids and sums each row's duplicates in order, on the card
    too: two runs give the same bits."""
    return embed[tokens.to(torch.int64)].to(to_torch_dtype(cdt))


def _ce_loss(logits, labels, mask):
    """Masked mean cross-entropy in fp32 — module-level so its identity is
    stable in region graph signatures (one ``pyfunc`` node under capture)."""
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1,
                        labels.to(torch.int64)[..., None])[..., 0]
    return torch.sum((lse - gold) * mask) / torch.clamp(torch.sum(mask),
                                                         min=1.0)


def _ce_loss_unmasked(logits, labels):
    # the all-ones mask is built inside the lifted fn, so a region capture
    # needs no concrete mask input
    return _ce_loss(logits, labels,
                    torch.ones(labels.shape, dtype=torch.float32,
                               device=labels.device))


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str = "dense"
    n_layers: int = 2
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    d_ff: int = 1024
    vocab: int = 1024
    head_dim: Optional[int] = None
    qkv_bias: bool = False
    rope: str = "full"             # "full" | "half" (chatglm 2d rope)
    norm: str = "rmsnorm"          # "rmsnorm" | "layernorm"
    act: str = "silu"
    gated_mlp: bool = True
    tie_embeddings: bool = False
    max_seq: int = 8192
    # --- moe ---
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    first_dense_layers: int = 0
    # --- ssm / hybrid ---
    ssm_state: int = 64
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    shared_attn_every: int = 0     # zamba2: shared block period
    # --- enc-dec / vlm ---
    n_enc_layers: int = 0
    n_frames: int = 1500           # whisper stub frontend length
    n_img_tokens: int = 256        # vlm stub frontend length
    # params live in param_dtype; the slot path computes in compute_dtype
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def n_params(self) -> float:
        """Approximate parameter count, the reference's formula: its
        encoder-decoder branch counts the encoder's layers and one
        cross-attention a decoder layer (no bias, norm or position
        table); its hybrid branch counts ``2 * n_heads *
        ssm_state`` where ``w_in`` holds ``2 * ssm_state`` columns, so a
        rate over the real tree counts the tree's own leaves; its MoE
        branch counts every layer's experts (a first dense layer as E
        FFNs too) and no router."""
        d, L, ff, V = self.d_model, self.n_layers, self.d_ff, self.vocab
        hd = self.hd
        attn = d * hd * self.n_heads + 2 * d * hd * self.n_kv_heads \
            + hd * self.n_heads * d
        mlp = (3 if self.gated_mlp else 2) * d * ff
        if self.family == "moe":
            mlp *= self.n_experts
        emb = V * d * (1 if self.tie_embeddings else 2)
        body = L * (attn + mlp)
        if self.family == "encdec":
            body += self.n_enc_layers * (attn + mlp) + L * attn  # cross attn
        if self.family == "hybrid":
            din = self.ssm_expand * d
            mamba = d * (2 * din + 2 * self.n_heads * self.ssm_state) + din * d
            body = L * mamba + (attn + mlp)  # one shared block
        return body + emb

    def n_active_params(self) -> float:
        """The parameters one token's forward reads (the MFU lines' count):
        for MoE the reference's dense equivalent with ``top_k`` experts'
        FFNs; elsewhere ``n_params``."""
        if self.family != "moe":
            return self.n_params()
        return dataclasses.replace(
            self, family="dense",
            d_ff=self.d_ff * max(self.top_k, 1)).n_params()


@dataclass(frozen=True)
class InputSpec:
    """A model input's shape and dtype (the reference's
    ``jax.ShapeDtypeStruct`` stand-in of ``input_specs``)."""
    shape: tuple[int, ...]
    dtype: torch.dtype


@dataclass(frozen=True)
class ParamSpec:
    shape: tuple[int, ...]
    dtype: str
    axes: tuple[Optional[str], ...]     # logical axis names per dim
    init: str = "normal"                # normal|zeros|ones
    scale: float = 1.0


def materialize(spec: ParamSpec, generator: torch.Generator,
                device) -> torch.Tensor:
    """The reference's init rule: zeros, ones, or normal * scale /
    sqrt(shape[0]) drawn from ``generator`` (its own stream: the numbers
    differ from ``jax.random``'s for the same seed)."""
    dt = to_torch_dtype(spec.dtype)
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dt, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dt, device=device)
    fan_in = spec.shape[0] if spec.shape else 1
    std = spec.scale / math.sqrt(max(fan_in, 1))
    x = torch.randn(spec.shape, generator=generator, dtype=torch.float32,
                    device=device)
    return x.mul_(std).to(dt)


def _materialize_tree(specs: dict, generator, device,
                      place: Optional[Callable] = None) -> dict:
    """``materialize`` over a (possibly nested) dict of specs, leaf by leaf
    in sorted key order; ``place(spec, leaf)`` (a rank's block on a mesh)
    is applied to each leaf as it is drawn, so no more than one full leaf
    exists at a time."""
    place = place or (lambda spec, t: t)
    return {k: (_materialize_tree(specs[k], generator, device, place)
                if isinstance(specs[k], dict)
                else place(specs[k], materialize(specs[k], generator,
                                                 device)))
            for k in sorted(specs)}


def _place_tree(specs: dict, params: dict, place: Callable) -> dict:
    return {k: (_place_tree(specs[k], params[k], place)
                if isinstance(specs[k], dict) else place(specs[k], params[k]))
            for k in params}


def _check_shapes(specs: dict, params: dict, where: str) -> None:
    for k, s in specs.items():
        if isinstance(s, dict):
            _check_shapes(s, params[k], f"{where}.{k}")
            continue
        got = tuple(params[k].shape)
        if got != s.shape:
            raise ValueError(f"{where}.{k}: expected {s.shape}, got {got}")


def _frozen_tree(params: dict, device) -> nn.Module:
    """A flat dict of tensors as a ``ParameterDict`` of frozen parameters;
    a dict of such dicts (the MoE family's ``blocks.dense`` /
    ``blocks.moe``) as a ``ModuleDict`` of them."""
    if any(isinstance(v, dict) for v in params.values()):
        return nn.ModuleDict({k: _frozen_tree(v, device)
                              for k, v in params.items()})
    return nn.ParameterDict({k: _frozen(v.to(device))
                             for k, v in params.items()})


def _plain_tree(mod: nn.Module) -> dict:
    """The parameters of a ``_frozen_tree`` as plain (nested) dicts."""
    if isinstance(mod, nn.ModuleDict):
        return {k: _plain_tree(v) for k, v in mod.items()}
    return dict(mod)


def keep_in_place(slabs, new, regions: bool, where: str) -> None:
    """A stateful region's new state goes to its own slabs (a cache's K/V,
    an SSM carry): under region capture the program wrote the donated
    slabs in place and returned them, and a copy would cost a slab clone
    a call (and a CUDA graph its stable addresses), so it raises; the
    per-op write is functional, so its value is copied into the slab."""
    for slab, val in zip(slabs, new):
        if regions:
            if val is not slab:
                raise RuntimeError(f"{where}: the region returned a copy of "
                                   f"its state slab instead of writing it "
                                   f"in place")
        else:
            slab.copy_(val)


def resolve_device(device) -> torch.device:
    """The device an entry point runs on.  ``cuda`` (the default of every
    entry point) raises when no card is present: the port never runs on
    the CPU unless the caller asks for it."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but torch.cuda is not "
                           "available; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


def _frozen(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


def placement_axes(cfg, axes: tuple, mesh) -> tuple:
    """A weight's (or activation's) logical axes as a model of ``cfg``
    places it on ``mesh``: a GQA group is never split across ranks, so
    where the kv heads do not divide the model axis, neither the q nor the
    kv heads shard (their projections and the attention stay whole on
    every rank)."""
    if "model" in mesh.axis_names and cfg.n_kv_heads % mesh.shape["model"]:
        return tuple(None if a in ("heads", "kv") else a for a in axes)
    return tuple(axes)


def head_axes(cfg) -> tuple:
    """The logical axes of the q and kv head dims under the ambient mesh
    (``placement_axes``' rule): ``("heads", "kv")`` or ``(None, None)``."""
    from ..dist.sharding import current_mesh
    mesh = current_mesh()
    if mesh is None:
        return "heads", "kv"
    return placement_axes(cfg, ("heads", "kv"), mesh)


class BaseModel(nn.Module):
    """The train/serve entry points every family implements, and the
    weights they share: ``embed``, ``blocks`` (stacked ``[L, ...]``),
    ``ln_f``, ``lm_head`` and ``shared`` (a block's un-stacked weights,
    where the family applies one block at several depths) under the
    reference tree's names."""

    cfg: "ModelConfig"

    def _set_params(self, specs: dict, device, params: Optional[dict],
                    generator: Optional[torch.Generator], mesh=None) -> None:
        """Own the weights as frozen parameters: ``params`` (a tree like
        ``specs`` of tensors, block shapes checked), or drawn from
        ``generator`` (default: seed 0 on ``device``) by the reference's
        init rule, leaf by leaf in a fixed order.  ``device`` defaults to
        ``cuda`` at every entry point and raises without a card.

        On a ``mesh`` of more than one rank each leaf is kept as this
        rank's block (``dist.sharding.weight_spec`` of its placement
        axes: an N-dim column block, or an expert leaf's block of whole
        experts), cut as soon as it is drawn: the same values as the
        one-device model's, and never the whole model in memory."""
        dev = resolve_device(device)
        self.mesh_layout = None
        place = lambda spec, t: t                       # noqa: E731
        if mesh is not None and mesh.size > 1:
            from ..dist.sharding import place as place_block
            from ..dist.sharding import weight_spec
            self.mesh_layout = self._mesh_layout(mesh)

            def place(spec, t):
                axes = placement_axes(self.cfg, spec.axes, mesh)
                return place_block(t, weight_spec(axes, t.shape, mesh), mesh)
        if params is None:
            if generator is None:
                generator = torch.Generator(device=dev).manual_seed(0)
            params = {
                "embed": place(specs["embed"], materialize(
                    specs["embed"], generator, dev)),
                "blocks": _materialize_tree(specs["blocks"], generator, dev,
                                            place),
                "ln_f": place(specs["ln_f"], materialize(
                    specs["ln_f"], generator, dev)),
            }
            if "lm_head" in specs:
                params["lm_head"] = place(specs["lm_head"], materialize(
                    specs["lm_head"], generator, dev))
            if "shared" in specs:
                params["shared"] = {
                    k: place(specs["shared"][k],
                             materialize(specs["shared"][k], generator, dev))
                    for k in sorted(specs["shared"])}
        else:
            for sub in ("blocks", "shared"):
                _check_shapes(specs.get(sub, {}), params.get(sub, {}), sub)
            params = {k: (place(specs[k], v) if not isinstance(v, dict)
                          else _place_tree(specs[k], v, place))
                      for k, v in params.items()}
        self.embed = _frozen(params["embed"].to(dev))
        self.blocks = _frozen_tree(params["blocks"], dev)
        self.ln_f = _frozen(params["ln_f"].to(dev))
        self.lm_head = _frozen(params["lm_head"].to(dev)) \
            if "lm_head" in params else None
        # the un-stacked sub-tree of a block applied at several depths
        # (Zamba2's shared attention + MLP block); None elsewhere
        self.shared = nn.ParameterDict(
            {k: _frozen(v.to(dev)) for k, v in params["shared"].items()}) \
            if "shared" in specs else None
        self._compute = None

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def _mesh_layout(self, mesh) -> tuple:
        """What a rank's blocks depend on: the model axis's size and this
        rank's coordinate on it."""
        if "model" not in mesh.axis_names:
            return (1, 0)
        return (mesh.shape["model"], mesh.coord("model"))

    def check_mesh(self, mesh) -> None:
        """Raise unless this model's weights are the blocks ``mesh`` asks
        of this rank (a shrunk mesh keeps each survivor's model
        coordinate, so its blocks stay valid)."""
        want = self._mesh_layout(mesh) if mesh is not None \
            and mesh.size > 1 else None
        if want != self.mesh_layout and not (
                want is None and self.mesh_layout is None):
            raise ValueError(f"model weights are placed for (model size, "
                             f"coord) {self.mesh_layout}, the mesh asks "
                             f"for {want}")

    def logical_sizes(self, batch: int) -> dict:
        """The global sizes of the logical axes ``shard_act`` reads an
        activation's layout off (``dist.logical_sizes``)."""
        cfg = self.cfg
        return {"batch": batch, "heads": cfg.n_heads, "kv": cfg.n_kv_heads,
                "mlp": cfg.d_ff, "vocab": cfg.vocab}

    def param_tree(self) -> dict:
        """The parameters as the reference's tree (``embed``, ``blocks``,
        ``ln_f``, ``lm_head`` when untied, ``shared`` where the family has
        it): the model's own tensors, so an update of a leaf in place
        updates the model."""
        tree = {"embed": self.embed, "blocks": _plain_tree(self.blocks),
                "ln_f": self.ln_f}
        if self.lm_head is not None:
            tree["lm_head"] = self.lm_head
        if self.shared is not None:
            tree["shared"] = dict(self.shared)
        return tree

    @contextlib.contextmanager
    def trainable(self):
        """Inside, every parameter is a leaf that requires grad (the
        per-layer casts of the forward stay inside autograd, so each fp32
        master weight gets an fp32 gradient, as JAX's ``astype`` transpose
        gives it); outside, they are frozen again."""
        params = list(self.parameters())
        for p in params:
            p.requires_grad_(True)
        try:
            yield self
        finally:
            for p in params:
                p.requires_grad_(False)

    def release_compute(self) -> None:
        """Drop the compute-dtype copy of the weights that
        ``compute_params`` keeps (6.8 GB for qwen2.5-3b): training never
        reads it, and the next serving call makes it anew from the updated
        weights."""
        self._compute = None

    def _embed(self, embed, tokens):
        return tapir.lift(embed_lookup, embed, tokens,
                          cdt=self.cfg.compute_dtype)

    def compute_params(self) -> dict:
        """Per-layer param dicts and the head's params in the compute
        dtype, cast once and kept (the same cast as the reference's
        per-layer ``astype``, so the same values): the serving paths read
        them, so no step re-casts a weight and every region input is the
        same tensor at every step.  The cast is made anew when a weight
        changed since (an in-place update bumps its version; a write
        through ``.data`` does not, and is not seen).  It stays resident
        while the model lives: a second copy of the weights in the compute
        dtype.  The forward casts per call, as the reference does.
        ``embed`` stays in the param dtype (``embed_lookup`` casts the rows
        it reads)."""
        w = self.lm_head if self.lm_head is not None else self.embed
        shared = dict(self.shared) if self.shared is not None else {}
        stamp = tuple((t._version, t.data_ptr())
                      for t in (*self.blocks.parameters(), *shared.values(),
                                self.ln_f, w))
        if self._compute is None or self._compute[0] != stamp:
            cdt = to_torch_dtype(self.cfg.compute_dtype)
            # a tied head is ``embed.T`` cast with its strides kept: the
            # GEMM reads it K-major in place (``fused_matmul``'s tb route)
            w = self.lm_head.data if self.lm_head is not None \
                else self.tied_head(self.embed.data)
            cp = {"layers": self._compute_layers(cdt),
                  "head": {"ln_f": self.ln_f.data, "w": w.to(cdt)},
                  "embed": self.embed.data}
            if self.shared is not None:
                cp["shared"] = {k: v.data.to(cdt) for k, v in shared.items()}
            self._compute = stamp, cp
        return self._compute[1]

    def tied_head(self, embed):
        """``embed.T``, the tied head; on a mesh this rank's vocab columns
        of it (the rows of ``embed`` it selects, transposed: the same
        K-major layout)."""
        from ..dist.sharding import (current_mesh, local_block,
                                     tp_last_dim_spec)
        mesh = current_mesh()
        if mesh is None or mesh.size <= 1 or \
                getattr(self, "mesh_layout", None) is None:
            return embed.T
        spec = tp_last_dim_spec(("embed", "vocab"), embed.T.shape, mesh)
        return local_block(embed, (spec[1], None), mesh).T

    def _compute_layers(self, cdt) -> list:
        """``compute_params``' per-layer dicts, each layer's slices of the
        stacked ``blocks`` cast to ``cdt``."""
        return [{k: v[i].to(cdt) for k, v in self.blocks.items()}
                for i in range(self.cfg.n_layers)]

    def forward(self, batch: dict, params: Optional[dict] = None):
        """Returns logits [B, S, vocab].  Every weight is read from
        ``params`` (a tree like ``param_tree()``; default: the model's
        own), so a captured step can pass its parameter handles in."""
        raise NotImplementedError

    def loss(self, batch: dict, params: Optional[dict] = None):
        """Mean cross-entropy of ``forward(batch, params)`` against
        ``batch["labels"]`` (over ``batch["mask"]`` when given), a scalar
        fp32 tensor.  Through ``lift``, so a region capture keeps it as
        one node; outside a region it is a direct call.  On a mesh, where
        ``batch`` is the whole batch as the forward takes it, every rank
        takes the whole batch's mean in the one-device order: the logits
        are gathered in rank order first, so no sum is split across ranks
        (the reference's loss under a mesh is the whole batch's mean
        too)."""
        logits = shard_act(self.forward(batch, params), None, None, None)
        labels = batch["labels"]
        mask = batch.get("mask")
        if mask is None:
            return tapir.lift(_ce_loss_unmasked, logits, labels)
        return tapir.lift(_ce_loss, logits, labels, mask)

    def capture_aux(self, batch: dict) -> tuple:
        """Concrete auxiliary leaves the forward binds under region capture
        (identity-stable memoized tables); families with none return ()."""
        return ()

    def supports_slots(self) -> bool:
        return False

    def input_specs(self, seq_len: int, batch: int, kind: str) -> dict:
        """``InputSpec`` stand-ins for every model input; ``kind``: train
        | prefill | decode.  The launcher fills the keys its token pipeline
        lacks with zeros of these shapes and dtypes, as the reference's
        does."""
        tok = InputSpec((batch, seq_len), torch.int32)
        if kind == "train":
            return {"tokens": tok, "labels": tok}
        if kind == "prefill":
            return {"tokens": tok}
        if kind == "decode":
            return {"tokens": InputSpec((batch, 1), torch.int32)}
        raise ValueError(kind)


_REGISTRY: dict[str, Callable] = {}


def register_family(name: str):
    def deco(cls):
        _REGISTRY[name] = cls
        return cls
    return deco


def get_model(cfg: ModelConfig, **kwargs):
    """Build the registered family's model (``kwargs``: device, params,
    generator)."""
    # register "ssm", "dense", "moe", "hybrid", "vlm" and "encdec"
    from . import mamba, moe, rwkv, transformer, vlm, whisper  # noqa: F401
    if cfg.family not in _REGISTRY:
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet")
    return _REGISTRY[cfg.family](cfg, **kwargs)
