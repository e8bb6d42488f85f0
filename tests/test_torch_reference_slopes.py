"""Where the port's elementwise ops meet a kink (|x| at 0, max at a tie, a
clip at its bounds) their gradients are the JAX package's, held against
``jax.grad`` of the reference's own functions on the same numpy inputs.

jax differentiates ``jnp.abs`` with slope +1 at 0, ``jnp.maximum`` at a tie
with 0.5 to each side and ``jnp.clip`` (a max then a min) with 0.5 at
either bound; torch's ``abs``, ``clamp_min`` and ``clamp`` give 0, 1 and 1.
Tolerances: values and gradients within 1e-6 (the same fp32 arithmetic,
one rounding apart), the slopes at the kinks exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import tapir as jtapir
from repro.models import paper_nets as jnets
from repro.models import rwkv as jrwkv
from repro_torch.core import tapir
from repro_torch.launch import fig3
from repro_torch.models import paper_nets as nets
from repro_torch.models import rwkv
from repro_torch.models.convert import paper_params_from_numpy
from repro_torch.optim import tree_leaves

#: the four names the elementwise table gained, each at points of its
#: domain (|x| at 0 and -0 too)
NEW_EW = {"log": [0.25, 1.0, 3.5], "rsqrt": [0.25, 1.0, 3.5],
          "sqrt": [0.25, 1.0, 3.5], "abs": [-2.0, -0.0, 0.0, 1.5]}


@pytest.fixture(autouse=True)
def _clean_caches():
    tapir.clear_cache()
    jtapir.clear_cache()
    yield
    tapir.clear_cache()
    jtapir.clear_cache()


def _j_elemwise_value_and_grad(x, fn, c):
    f = lambda v: jnp.sum(jtapir.elemwise(v, fn) * c)  # noqa: E731
    y = np.asarray(jtapir.elemwise(jnp.asarray(x), fn))
    return y, np.asarray(jax.grad(f)(jnp.asarray(x)))


@pytest.mark.parametrize("fn", sorted(NEW_EW))
def test_new_elemwise_names_match_reference_eagerly(fn):
    x = np.asarray(NEW_EW[fn], np.float32)
    c = np.linspace(0.5, 2.0, x.size).astype(np.float32)
    want_y, want_g = _j_elemwise_value_and_grad(x, fn, c)
    t = torch.from_numpy(x).requires_grad_(True)
    y = tapir.elemwise(t, fn)
    (g,) = torch.autograd.grad((y * torch.from_numpy(c)).sum(), [t])
    np.testing.assert_allclose(y.detach().numpy(), want_y, rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(g.numpy(), want_g, rtol=1e-6, atol=1e-6)
    if fn == "abs":   # jax's slope at 0 is +1, and |-0| is +0
        assert g.numpy()[2] == c[2] and g.numpy()[1] == c[1]
        assert not np.signbit(y.detach().numpy()).any()


@pytest.mark.parametrize("fn", sorted(NEW_EW))
def test_new_elemwise_names_match_reference_in_a_region(fn):
    """Inside a region each is one ``ew`` node, left unfused (the kernel's
    epilogue takes none of the four, as the reference's fusion pass does
    not); values and gradients through the region program."""
    pts = np.asarray(NEW_EW[fn], np.float32)
    x = np.tile(pts, (3, 1))
    c = np.linspace(0.5, 2.0, x.size).astype(np.float32).reshape(x.shape)
    want_y, want_g = _j_elemwise_value_and_grad(x * 2.0, fn, c)
    want_g = want_g * 2.0

    @tapir.parallel_region
    def body(v):
        return tapir.elemwise(v * 2.0, fn)

    t = torch.from_numpy(x).requires_grad_(True)
    with tapir.use(fig3.tapir_config("tapir", "cpu")):
        y = body(t)
    (g,) = torch.autograd.grad((y * torch.from_numpy(c)).sum(), [t])
    (graph,) = tapir.cached_graphs().values()
    assert [n.attrs["fn"] for n in graph.nodes.values()
            if n.op == "ew" and n.attrs.get("fn") == fn] == [fn]
    np.testing.assert_allclose(y.detach().numpy(), want_y, rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(g.numpy(), want_g, rtol=1e-6, atol=1e-6)


def test_ncf_loss_gradient_at_zero_logits_is_the_references():
    """Zeroed output weights and bias make every logit exactly 0: the
    loss's slope there is -y (the max's tie 0.5, |x|'s slope +1), so
    out_b's gradient is mean(-y), and every other gradient follows it."""
    jm = jnets.PaperNCF(jnets.NCFConfig())
    jp = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    jp["out_w"] = np.zeros_like(jp["out_w"])
    jp["out_b"] = np.zeros_like(jp["out_b"])
    rng = np.random.default_rng(1)
    batch = {"users": rng.integers(0, 6040, (64,)).astype(np.int32),
             "items": rng.integers(0, 3706, (64,)).astype(np.int32),
             "y": rng.integers(0, 2, (64,)).astype(np.int32)}
    jloss, jgrads = jax.value_and_grad(jm.loss)(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    model = nets.get_paper_net("ncf")
    params = paper_params_from_numpy("ncf", jp, device="cpu")
    for p in tree_leaves(params):
        p.requires_grad_(True)
    loss, grads = fig3.value_and_grad(
        model, params, {k: torch.from_numpy(v.astype(np.int64))
                        for k, v in batch.items()},
        fig3.tapir_config("tapir", "cpu"))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-6)
    want_b = -batch["y"].astype(np.float32).mean()
    paths = [jax.tree_util.keystr(k) for k, _ in
             jax.tree_util.tree_flatten_with_path(jgrads)[0]]
    np.testing.assert_allclose(grads[paths.index("['out_b']")].numpy(),
                               [want_b], rtol=1e-6)
    np.testing.assert_allclose(np.asarray(jgrads["out_b"]), [want_b],
                               rtol=1e-6)
    jleaves = jax.tree_util.tree_leaves(jgrads)
    assert len(jleaves) == len(grads)
    for got, want in zip(grads, jleaves):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-6)


def test_rwkv_decay_clip_has_the_references_slope_at_its_bounds():
    """logw = w0 + lora exactly at -8.0 and 2.0 (and inside and outside
    the range): the decay and its gradients w.r.t. both inputs."""
    w0 = np.asarray([-8.0, 2.0, -9.0, 3.0, 0.5, -8.0, 2.0], np.float32)
    lora = np.asarray([0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0], np.float32)
    c = np.linspace(0.5, 2.0, w0.size).astype(np.float32)

    def jf(lo, w):
        return jnp.sum(jrwkv._decay_from_lora(lo, w) * c)

    want = np.asarray(jrwkv._decay_from_lora(jnp.asarray(lora),
                                             jnp.asarray(w0)))
    jg_lora, jg_w0 = (np.asarray(g) for g in jax.grad(jf, argnums=(0, 1))(
        jnp.asarray(lora), jnp.asarray(w0)))
    tl = torch.from_numpy(lora).requires_grad_(True)
    tw = torch.from_numpy(w0).requires_grad_(True)
    y = rwkv._decay_from_lora(tl, tw)
    g_lora, g_w0 = torch.autograd.grad((y * torch.from_numpy(c)).sum(),
                                       [tl, tw])
    np.testing.assert_allclose(y.detach().numpy(), want, rtol=1e-6)
    for got, ref in ((g_lora, jg_lora), (g_w0, jg_w0)):
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-12)
    # at either bound the slope of the clip is 0.5: half the unclipped one
    inner = -np.exp(w0) * np.exp(-np.exp(w0)) * c
    np.testing.assert_allclose(g_lora.numpy()[[0, 1, 5, 6]],
                               0.5 * inner[[0, 1, 5, 6]], rtol=1e-6)
    assert not g_lora.numpy()[[2, 3]].any()
