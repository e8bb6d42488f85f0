"""The port's AdamW (``repro_torch.optim``) against the JAX package's
``repro.optim`` on the same trees, made with numpy from a seed, and the
counterparts of ``tests/test_train_substrate.py``'s optimizer tests.

Tolerances: rtol 1e-6 (atol 1e-9) for one update and for the schedule's
float32 values (the same float32 operations; XLA and torch may round a
transcendental or a fused sum in another last place), exact where the
reference's own test is exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as jopt
from repro.optim import adamw as jadamw
from repro_torch import optim
from repro_torch.optim import adamw

TOL = dict(rtol=1e-6, atol=1e-9)


def _tree(seed: int, scale: float = 1.0) -> dict:
    """A params-like tree: stacked [L, ...] matrices and norm scales, a
    vector, an embedding — dict keys out of sorted order on purpose."""
    rng = np.random.default_rng(seed)
    shapes = {"ln_f": (6,), "embed": (11, 6),
              "blocks": {"wq": (2, 6, 6), "ln1": (2, 6), "bq": (2, 6)},
              "lm_head": (6, 11)}

    def make(s):
        if isinstance(s, dict):
            return {k: make(v) for k, v in s.items()}
        return (rng.standard_normal(s) * scale).astype(np.float32)
    return make(shapes)


def _to_torch(tree):
    return adamw.tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _to_jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def test_adamw_minimizes_quadratic():
    cfg = optim.AdamWConfig(lr=0.1, weight_decay=0.0, warmup_steps=1,
                            total_steps=200)
    target = torch.tensor([[1.0, -2.0], [3.0, 0.5]])
    params = {"w": torch.zeros((2, 2))}
    opt = optim.adamw_init(params, cfg)
    for _ in range(150):
        w = params["w"].detach().requires_grad_(True)
        loss = torch.sum((w - target) ** 2)
        (g,) = torch.autograd.grad(loss, [w])
        optim.adamw_update(params, [g], opt, cfg)
    assert float(loss.detach()) < 1e-2


def test_cosine_schedule_shape():
    cfg = optim.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100,
                            min_lr_frac=0.1)
    lrs = [float(optim.cosine_schedule(cfg, s))
           for s in [0, 5, 10, 55, 100, 200]]
    assert lrs[0] == 0.0
    assert abs(lrs[1] - 0.5) < 1e-6          # mid-warmup
    assert abs(lrs[2] - 1.0) < 1e-6          # peak
    assert 0.1 < lrs[3] < 1.0                # decaying
    assert abs(lrs[4] - 0.1) < 1e-6          # floor
    assert lrs[5] <= 0.1 + 1e-6


@pytest.mark.parametrize("step", [0, 1, 3, 50, 99, 100, 101, 5000])
def test_schedule_and_factors_match_reference(step):
    """lr and both bias corrections in float32, as the reference's."""
    cfg = optim.AdamWConfig(lr=3e-4, warmup_steps=7, total_steps=120)
    jcfg = jopt.AdamWConfig(lr=3e-4, warmup_steps=7, total_steps=120)
    got = optim.step_factors(step, cfg)
    want = jadamw.step_factors(jnp.asarray(step, jnp.int32), jcfg)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(float(g), float(w), **TOL)


def test_clip_by_global_norm():
    tree = {"a": torch.ones((10,)) * 3.0, "b": torch.ones((5,)) * 4.0}
    clipped, norm = optim.clip_by_global_norm(tree, 1.0)
    assert abs(float(optim.global_norm(clipped)) - 1.0) < 1e-5
    assert float(norm) > 1.0


def test_clip_by_global_norm_zero_and_denormal_guard():
    """An all-zero or denormal gradient tree gets scale 1.0, not the
    inf/NaN of ``max_norm / gnorm``; an ordinary norm is untouched."""
    zeros = {"a": torch.zeros((7,)), "b": torch.zeros((3, 2))}
    clipped, norm = optim.clip_by_global_norm(zeros, 1.0)
    assert float(norm) == 0.0
    for k in zeros:
        assert torch.equal(clipped[k], zeros[k])
    denorm = {"a": torch.full((4,), 1e-42, dtype=torch.float32)}
    clipped, norm = optim.clip_by_global_norm(denorm, 1.0)
    assert torch.isfinite(clipped["a"]).all()
    assert float(optim.clip_scale(norm, 1.0)) == 1.0
    assert float(optim.clip_scale(torch.tensor(1e-40), 1.0)) == 1.0
    assert float(optim.clip_scale(torch.tensor(0.0), 0.0)) == 1.0
    big = {"a": torch.ones((16,)) * 2.0}
    clipped, norm = optim.clip_by_global_norm(big, 1.0)
    assert abs(float(optim.global_norm(clipped)) - 1.0) < 1e-5


def test_global_norm_sums_leaves_in_the_references_order():
    """``tree_leaves`` is ``jax.tree_util.tree_leaves``' order (dict keys
    sorted at every level), and the norm sums the leaves in it."""
    tree = _tree(0)
    names = [jax.tree_util.keystr(k) for k, _ in
             jax.tree_util.tree_leaves_with_path(tree)]
    assert names == ["['blocks']['bq']", "['blocks']['ln1']",
                     "['blocks']['wq']", "['embed']", "['lm_head']",
                     "['ln_f']"]
    for a, b in zip(optim.tree_leaves(tree),
                    jax.tree_util.tree_leaves(tree)):
        assert a is b
    got = optim.global_norm(_to_torch(tree))
    want = jopt.global_norm(_to_jax(tree))
    np.testing.assert_allclose(float(got), float(want), **TOL)


@pytest.mark.parametrize("decay", [False, True])
@pytest.mark.parametrize("scale", [1.0, 0.37])
def test_leaf_update_matches_reference(decay, scale):
    """One leaf, in place, against the reference's functional update."""
    rng = np.random.default_rng(3)
    p, g, mu = (rng.standard_normal((5, 7)).astype(np.float32)
                for _ in range(3))
    nu = np.abs(rng.standard_normal((5, 7))).astype(np.float32)
    args = (np.float32(scale), np.float32(2e-3), np.float32(0.19),
            np.float32(0.0975), 0.9, 0.95, 1e-8, 0.1)
    want = jadamw.leaf_update(*(jnp.asarray(a) for a in (p, g, mu, nu)),
                              *(jnp.asarray(a) if isinstance(a, np.ndarray)
                                or isinstance(a, np.float32) else a
                                for a in args), decay=decay)
    tp, tg, tmu, tnu = (torch.from_numpy(a.copy()) for a in (p, g, mu, nu))
    optim.leaf_update(tp, tg, tmu, tnu, *(
        torch.tensor(a) if isinstance(a, np.float32) else a for a in args),
        decay=decay)
    for got, w in zip((tp, tmu, tnu), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("steps", [1, 3])
def test_adamw_update_matches_reference(steps):
    """Whole trees over a few steps: params, moments, lr and grad norm;
    the norm-scale leaves ``[L, d]`` decay as the reference decays them."""
    cfg = optim.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=10,
                            grad_clip=0.5)
    jcfg = jopt.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=10,
                            grad_clip=0.5)
    params = _tree(1)
    tp, jp = _to_torch(params), _to_jax(params)
    to, jo = optim.adamw_init(tp, cfg), jopt.adamw_init(jp, jcfg)
    for s in range(steps):
        grads = _tree(10 + s, scale=0.3)
        m = optim.adamw_update(tp, _to_torch(grads), to, cfg)
        jp, jo, jm = jopt.adamw_update(jp, _to_jax(grads), jo, jcfg)
        for k in ("lr", "grad_norm"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), **TOL)
    assert int(to["step"]) == int(jo["step"]) == steps
    for got, want in ((tp, jp), (to["mu"], jo["mu"]), (to["nu"], jo["nu"])):
        for a, b in zip(optim.tree_leaves(got),
                        jax.tree_util.tree_leaves(want)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                       atol=1e-7)


def test_adamw_update_frees_each_gradient_it_applied():
    """A list of gradients is emptied leaf by leaf (the full-width step's
    memory rests on it), and the params and moments keep their storage."""
    tree = _to_torch(_tree(2))
    cfg = optim.AdamWConfig()
    opt = optim.adamw_init(tree, cfg)
    ptrs = [t.data_ptr() for t in optim.tree_leaves((tree, opt["mu"],
                                                     opt["nu"]))]
    grads = [torch.ones_like(p) for p in optim.tree_leaves(tree)]
    optim.adamw_update(tree, grads, opt, cfg)
    assert grads == [None] * len(grads)
    assert ptrs == [t.data_ptr() for t in optim.tree_leaves(
        (tree, opt["mu"], opt["nu"]))]
