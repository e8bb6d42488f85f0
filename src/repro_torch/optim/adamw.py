"""AdamW + cosine schedule + global-norm clipping on torch tensors — the
port of the JAX package's ``optim/adamw.py``.

The functions keep the reference's names, arithmetic and float32 scalars
(``lr``, the bias corrections and the clip factor are 0-dim float32
tensors, as the reference's are jnp float32 scalars), so a step computes
what the reference's step computes.  Two things differ, both for memory at
full width (qwen2.5-3b's largest leaf is 3.2 GB in fp32):

* ``leaf_update`` updates ``p``, ``mu`` and ``nu`` in place and takes the
  gradient as its scratch buffer, with one temporary of the leaf's size:
  the same operations in the same order as the reference's, each rounded
  where the reference rounds it;
* ``adamw_update`` walks the leaves one by one and drops each gradient
  once it has been applied.

Leaf order is the reference's ``jax.tree_util.tree_leaves`` order (dict
keys sorted, sequences in order): ``tree_leaves`` here.  The global norm
sums the leaves in that order.  Weight decay is judged on the leaf as
stored, ``p.ndim >= 2``: the stacked ``[L, d]`` norm scales and biases
decay too, as in the reference.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

F32 = torch.float32


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    # moments dtype; fp32 is the safe default, bf16 halves optimizer memory
    moment_dtype: str = "float32"


def tree_leaves(tree) -> list:
    """The leaves of a tree of dicts, lists and tuples in the reference's
    ``tree_leaves`` order: dict keys sorted, sequences in order.  ``None``
    is an empty subtree, as in JAX."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in tree_leaves(t)]
    return [tree]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the same leaves of
    ``rest``), keeping the structure."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)


def _f32(x, device=None) -> torch.Tensor:
    if device is not None and not isinstance(x, torch.Tensor):
        # a fill on the device, not a host copy: a CUDA graph can hold it
        return torch.full((), x, dtype=F32, device=device)
    return torch.as_tensor(x, dtype=F32, device=device)


def cosine_schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """The learning rate at ``step``, in float32 arithmetic as the
    reference's (every Python constant rounded to float32 where it meets
    the step)."""
    step = _f32(step)
    warm = torch.minimum(step / max(cfg.warmup_steps, 1), _f32(1.0))
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def global_norm_leaves(*leaves) -> torch.Tensor:
    """Global norm over explicit leaves (``tree_leaves`` order), the sum of
    each leaf's fp32 sum of squares taken in that order."""
    total = 0
    for g in leaves:
        total = total + torch.sum(torch.square(g.to(F32)))
    return torch.sqrt(_f32(total))


def global_norm(tree) -> torch.Tensor:
    return global_norm_leaves(*tree_leaves(tree))


def clip_scale(gnorm, max_norm: float) -> torch.Tensor:
    """Clip factor ``min(1, max_norm / gnorm)``, guarded: an all-zero (or
    denormal) gradient tree yields 1.0, not the inf/NaN of the unguarded
    division."""
    gnorm = _f32(gnorm)
    tiny = torch.finfo(F32).tiny
    safe = torch.minimum(_f32(1.0, gnorm.device),
                         max_norm / torch.clamp(gnorm, min=tiny))
    return torch.where(gnorm > tiny, safe, _f32(1.0, gnorm.device))


def clip_by_global_norm(tree, max_norm: float):
    g = global_norm(tree)
    scale = clip_scale(g, max_norm)
    return tree_map(lambda t: t * scale.to(t.dtype), tree), g


def adamw_init(params, cfg: AdamWConfig) -> dict:
    mdt = getattr(torch, cfg.moment_dtype)

    def zeros(p):
        return torch.zeros(p.shape, dtype=mdt, device=p.device)

    dev = tree_leaves(params)[0].device
    return {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def step_factors(step, cfg: AdamWConfig):
    """(lr, bias-correction-1, bias-correction-2) for this step, float32."""
    step_f = _f32(step)
    lr = cosine_schedule(cfg, step)
    bc1 = 1 - torch.pow(cfg.b1, step_f)
    bc2 = 1 - torch.pow(cfg.b2, step_f)
    return lr, bc1, bc2


@torch.no_grad()
def leaf_update(p, g, mu, nu, scale, lr, bc1, bc2, b1, b2, eps,
                weight_decay, decay) -> None:
    """One AdamW leaf, in place: ``p``, ``mu`` and ``nu`` take their new
    values; ``g`` is consumed (its buffer is the scratch when it is fp32).

    The reference's arithmetic, step for step: g * scale; mu2 = b1 mu +
    (1 - b1) g; nu2 = b2 nu + (1 - b2) g^2; delta = (mu2 / bc1) /
    (sqrt(nu2 / bc2) + eps) (+ weight_decay p when ``decay``); p2 = p -
    lr delta.  ``scale`` is the global-norm clip factor; ``decay`` the
    static matrix-vs-vector switch (``p.ndim >= 2``)."""
    dev = p.device
    scale, lr, bc1, bc2 = (_f32(t, dev) for t in (scale, lr, bc1, bc2))
    g = g.mul_(scale.to(g.dtype)) if g.dtype == F32 else \
        (g * scale.to(g.dtype)).to(F32)
    mu_f = mu if mu.dtype == F32 else mu.to(F32)
    nu_f = nu if nu.dtype == F32 else nu.to(F32)
    tmp = torch.square(g).mul_(1 - b2)
    nu_f.mul_(b2).add_(tmp)                     # nu2
    mu_f.mul_(b1).add_(g.mul_(1 - b1))          # mu2
    torch.div(mu_f, bc1, out=g)                 # mhat
    torch.div(nu_f, bc2, out=tmp).sqrt_().add_(eps)
    g.div_(tmp)                                 # delta
    p_f = p if p.dtype == F32 else p.to(F32)
    if decay:
        g.add_(torch.mul(p_f, weight_decay, out=tmp))
    p_f.sub_(g.mul_(lr))                        # p2
    for dst, src in ((p, p_f), (mu, mu_f), (nu, nu_f)):
        if dst is not src:
            dst.copy_(src)


@torch.no_grad()
def adamw_update(params, grads, opt_state, cfg: AdamWConfig) -> dict:
    """One AdamW step, in place on ``params`` and ``opt_state``.

    ``grads`` is a tree like ``params``, or a list of its leaves in
    ``tree_leaves`` order; the list is emptied as the leaves are applied,
    so each gradient is freed once it has been used (pass a list to keep
    the peak at one temporary leaf).  Returns the metrics ``{"lr",
    "grad_norm"}`` as float32 0-dim tensors."""
    step = opt_state["step"] + 1
    lr, bc1, bc2 = step_factors(step, cfg)
    p_leaves = tree_leaves(params)
    g_leaves = grads if isinstance(grads, list) else tree_leaves(grads)
    if len(g_leaves) != len(p_leaves):
        raise ValueError(f"{len(g_leaves)} gradients for {len(p_leaves)} "
                         f"parameters")
    gnorm = global_norm_leaves(*g_leaves)
    scale = clip_scale(gnorm, cfg.grad_clip)
    mus = tree_leaves(opt_state["mu"])
    nus = tree_leaves(opt_state["nu"])
    for i, (p, mu, nu) in enumerate(zip(p_leaves, mus, nus)):
        g = g_leaves[i]
        g_leaves[i] = None
        leaf_update(p, g, mu, nu, scale, lr, bc1, bc2, cfg.b1, cfg.b2,
                    cfg.eps, cfg.weight_decay, decay=p.ndim >= 2)
        del g
    opt_state["step"].copy_(step)
    return {"lr": lr, "grad_norm": gnorm}
