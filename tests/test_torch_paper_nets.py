"""The paper's four networks and their ops on the port, against the JAX
package on the CPU: ``lstm_step`` and ``conv2d`` in both modes, the
pipeline's GEMM counts, each net's loss and gradients on bridged weights,
training, mode equivalence, the serialization ablation and the Fig. 3
driver.

Inputs are made with numpy from a seed; the reference's weights come from
its own ``init`` and cross through ``paper_params_from_numpy``.  Sizes are
the reference test's (``tests/test_paper_nets.py::_batches``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import tapir as jtapir
from repro.core.ir import TaskGraph as JTaskGraph
from repro.core.ir import TensorType as JTensorType
from repro.core.passes import run_pipeline as j_run_pipeline
from repro.core.schedule import CPU_COST_MODEL as J_CPU
from repro.models import paper_nets as jnets
from repro_torch.core import tapir
from repro_torch.core.ir import TaskGraph, TensorType
from repro_torch.core.passes import run_pipeline
from repro_torch.core.schedule import CPU_COST_MODEL
from repro_torch.launch import fig3
from repro_torch.models import paper_nets as nets
from repro_torch.models.convert import paper_params_from_numpy
from repro_torch.optim import tree_leaves

NETS = ["cnn", "lstm1", "lstm2", "ncf"]
#: the reference test's batch sizes
SIZES = {"cnn": 16, "lstm1": (8, 20), "lstm2": (4, 12), "ncf": 64}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small CPU tensors: one intra-op thread per test process, so
    parallel test workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _clean_caches():
    tapir.clear_cache()
    jtapir.clear_cache()
    yield
    tapir.clear_cache()
    jtapir.clear_cache()


def _cfg(mode: str, ablate: bool = False) -> tapir.TapirConfig:
    return fig3.tapir_config(mode, "cpu", ablate)


def _np_batch(name: str, seed: int = 1) -> dict:
    rng = np.random.default_rng(seed)
    if name == "cnn":
        b = SIZES[name]
        return {"x": rng.standard_normal((b, 28, 28, 1), np.float32),
                "y": rng.integers(0, 10, (b,)).astype(np.int32)}
    if name in ("lstm1", "lstm2"):
        cfg = nets.LSTM1 if name == "lstm1" else nets.LSTM2
        b, t = SIZES[name]
        y_shape = (b, t) if cfg.per_step_output else (b,)
        return {"x": rng.standard_normal((b, t, cfg.input_dim), np.float32),
                "y": rng.integers(0, cfg.n_classes, y_shape).astype(np.int32)}
    n = SIZES[name]
    return {"users": rng.integers(0, 6040, (n,)).astype(np.int32),
            "items": rng.integers(0, 3706, (n,)).astype(np.int32),
            "y": rng.integers(0, 2, (n,)).astype(np.int32)}


def _j_model(name: str):
    return {"cnn": lambda: jnets.PaperCNN(jnets.CNNConfig()),
            "lstm1": lambda: jnets.PaperLSTM(jnets.LSTM1),
            "lstm2": lambda: jnets.PaperLSTM(jnets.LSTM2),
            "ncf": lambda: jnets.PaperNCF(jnets.NCFConfig())}[name]()


def _t_batch(b: dict) -> dict:
    return {k: torch.from_numpy(v.astype(np.int64) if v.dtype == np.int32
                                else v) for k, v in b.items()}


def _both(name: str):
    """(reference model, numpy params, port model, port params, numpy
    batch) on the same weights."""
    jm = _j_model(name)
    jp = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    tp = paper_params_from_numpy(name, jp, device="cpu")
    return jm, jp, nets.get_paper_net(name), tp, _np_batch(name)


def _j_value_and_grad(jm, jp, batch, mode: str = "tapir"):
    cfg = jtapir.TapirConfig(mode=mode)

    @jax.jit
    def f(p, b):
        with jtapir.use(cfg):
            return jax.value_and_grad(jm.loss)(p, b)

    return f(jp, {k: jnp.asarray(v) for k, v in batch.items()})


def _t_value_and_grad(model, params, batch, mode: str = "tapir"):
    for p in tree_leaves(params):
        p.requires_grad_(True)
    loss, grads = fig3.value_and_grad(model, params, _t_batch(batch),
                                      _cfg(mode))
    return float(loss), grads


# ---------------------------------------------------------------------------
# lstm_step
# ---------------------------------------------------------------------------


def _lstm_inputs(seed=3, b=4, xd=16, hd=32):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s, np.float32) * sc for s, sc in
            (((b, xd), 1.0), ((b, hd), 1.0), ((b, hd), 1.0),
             ((xd + hd, 4 * hd), 0.1), ((4 * hd,), 0.1))]


@pytest.mark.parametrize("mode", ["tapir", "opaque"])
def test_lstm_step_matches_reference(mode):
    args = _lstm_inputs()
    with jtapir.use(jtapir.TapirConfig(mode=mode)):
        jh, jc = jtapir.lstm_step(*[jnp.asarray(a) for a in args])
    with tapir.use(_cfg(mode)):
        th, tc = tapir.lstm_step(*[torch.from_numpy(a) for a in args])
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=2e-5,
                               atol=2e-5)


def _lstm_graph(T, TT, build, b=4, xd=16, hd=32):
    g = T("lstm_step")
    ins = [g.add_input(n, TT(s, "float32")) for n, s in
           (("x", (b, xd)), ("h", (b, hd)), ("c", (b, hd)),
            ("W", (xd + hd, 4 * hd)), ("b", (4 * hd,)))]
    g.set_outputs(list(build(g, *ins)))
    return g


@pytest.mark.parametrize("mode,gemms", [("tapir", 1), ("opaque", 8)])
def test_lstm_step_gemm_count_equals_the_reference_pipeline(mode, gemms):
    """The paper's point: per cell step tapir mode's optimized graph holds
    ONE GEMM and opaque mode's eight, as the reference's pipeline gives on
    the same graph (also at LSTM1's and LSTM2's widths)."""
    for b, xd, hd in ((4, 16, 32), (64, 39, 256), (64, 512, 512)):
        g = run_pipeline(_lstm_graph(TaskGraph, TensorType,
                                     tapir._build_lstm_step, b, xd, hd),
                         mode, CPU_COST_MODEL)
        jg = j_run_pipeline(_lstm_graph(JTaskGraph, JTensorType,
                                        jtapir._build_lstm_step, b, xd, hd),
                            mode, J_CPU, "cpu")
        got = sum(n.op == "matmul" for n in g.nodes.values())
        want = sum(n.op == "matmul" for n in jg.nodes.values())
        assert got == want == gemms, (b, xd, hd, got, want)
        ks = sorted(n.attrs["k"] for n in g.nodes.values()
                    if n.op == "matmul")
        assert ks == ([xd + hd] if mode == "tapir"
                      else sorted([xd] * 4 + [hd] * 4))


@pytest.mark.parametrize("fn", ["silu", "tanh", "sigmoid", "gelu"])
def test_elemwise_matches_reference_and_fuses_in_a_region(fn):
    """Eager ``elemwise`` against the reference's; inside a region it is
    one ``ew`` node, which tapir mode folds into the GEMM's epilogue."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((4, 16), np.float32)
    w = rng.standard_normal((16, 8), np.float32)
    want = np.asarray(jtapir.elemwise(jnp.asarray(x @ w), fn))
    got = tapir.elemwise(torch.from_numpy(x @ w), fn)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)

    @tapir.parallel_region
    def body(x, w):
        return tapir.elemwise(tapir.linear(x, w), fn)

    with tapir.use(_cfg("tapir")):
        y = body(torch.from_numpy(x), torch.from_numpy(w))
    (g,) = tapir.cached_graphs().values()
    (mm,) = [n for n in g.nodes.values() if n.op == "matmul"]
    assert [f for f, _, _ in mm.epilogue] == [fn]
    np.testing.assert_allclose(y.numpy(), want, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# conv2d
# ---------------------------------------------------------------------------

CONV_CASES = [(pad, st, epi) for pad in ("SAME", "VALID")
              for st in ((1, 1), (2, 2)) for epi in (True, False)]


@pytest.mark.parametrize("padding,strides,epilogue", CONV_CASES)
def test_conv2d_matches_reference(padding, strides, epilogue):
    """Forward and gradients (x, kernel, bias) against the reference's
    ``tapir.conv2d`` (``lax.conv_general_dilated``) at odd and even H, W,
    in both modes."""
    rng = np.random.default_rng(7)
    for (H, W) in ((9, 7), (8, 10)):
        x = rng.standard_normal((2, H, W, 3), np.float32)
        k = rng.standard_normal((3, 3, 3, 5), np.float32) * 0.3
        b = rng.standard_normal((5,), np.float32)
        act = "relu" if epilogue else None
        for mode in ("tapir", "opaque"):
            def jf(x, k, b):
                with jtapir.use(jtapir.TapirConfig(mode=mode)):
                    return jtapir.conv2d(x, k, b if epilogue else None,
                                         strides=strides, padding=padding,
                                         activation=act)
            jy = jf(x, k, b)
            cot = rng.standard_normal(jy.shape, np.float32)
            jg = jax.grad(lambda *a: jnp.sum(jf(*a) * cot),
                          argnums=(0, 1, 2))(x, k, b)
            tx, tk, tb = (torch.tensor(a, requires_grad=True)
                          for a in (x, k, b))
            with tapir.use(_cfg(mode)):
                ty = tapir.conv2d(tx, tk, tb if epilogue else None,
                                  strides=strides, padding=padding,
                                  activation=act)
            assert tuple(ty.shape) == jy.shape
            np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy),
                                       rtol=1e-5, atol=1e-5)
            tg = torch.autograd.grad((ty * torch.from_numpy(cot)).sum(),
                                     (tx, tk, tb), allow_unused=True)
            for got, want in zip(tg[:2 + epilogue], jg):
                np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                           rtol=1e-4, atol=1e-4)


def test_conv2d_epilogue_folds_into_the_gemm_in_tapir_mode():
    x = torch.randn(2, 9, 7, 3)
    k, b = torch.randn(3, 3, 3, 5), torch.randn(5)
    for mode, folded in (("tapir", ["add", "relu"]), ("opaque", [])):
        tapir.clear_cache()
        with tapir.use(_cfg(mode)):
            tapir.conv2d(x, k, b, strides=(2, 2), activation="relu")
        (g,) = tapir.cached_graphs().values()
        (conv,) = [n for n in g.nodes.values() if n.op == "conv2d"]
        assert [fn for fn, _, _ in conv.epilogue] == folded
        assert conv.schedule.impl == ("im2col_gemm" if mode == "tapir"
                                      else "opaque")


def test_max_pool_gradient_goes_to_the_first_tied_maximum():
    """Windows of zeros (after a ReLU) and ties between two entries: the
    port's gradient equals ``jax.grad`` of the reference's
    ``reduce_window`` max, an odd H / W dropping its last row / column."""
    rng = np.random.default_rng(0)
    x = np.maximum(rng.integers(-2, 2, (2, 7, 9, 3)), 0).astype(np.float32)
    cot = rng.standard_normal((2, 3, 4, 3), np.float32)

    def jpool(x):
        return jax.lax.reduce_window(x, -jnp.inf, jax.lax.max, (1, 2, 2, 1),
                                     (1, 2, 2, 1), "VALID")
    want = jax.grad(lambda x: jnp.sum(jpool(x) * cot))(x)
    tx = torch.tensor(x, requires_grad=True)
    y = nets.max_pool_2x2(tx)
    np.testing.assert_array_equal(y.detach().numpy(), np.asarray(jpool(x)))
    (got,) = torch.autograd.grad((y * torch.from_numpy(cot)).sum(), tx)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# the four nets
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", NETS)
def test_paper_net_loss_and_grads_match_reference(name):
    """Loss (rtol 2e-4) and every parameter's gradient (within 1e-4 of
    that parameter's largest reference gradient) against
    ``jax.value_and_grad(model.loss)`` on the same weights and batch."""
    jm, jp, model, tp, batch = _both(name)
    jloss, jgrads = _j_value_and_grad(jm, jp, batch)
    loss, grads = _t_value_and_grad(model, tp, batch)
    np.testing.assert_allclose(loss, float(jloss), rtol=2e-4)
    jleaves = jax.tree_util.tree_leaves(jgrads)
    assert len(jleaves) == len(grads)
    for got, want in zip(grads, jleaves):
        want = np.asarray(want)
        assert got.shape == want.shape
        err = float(np.abs(got.numpy() - want).max())
        assert err <= 1e-4 * float(np.abs(want).max()), (name, want.shape,
                                                          err)


@pytest.mark.parametrize("name", NETS)
def test_paper_net_opaque_loss_matches_reference(name):
    """The per-op control: opaque mode's loss and gradients against the
    reference's opaque mode, as above."""
    jm, jp, model, tp, batch = _both(name)
    jloss, jgrads = _j_value_and_grad(jm, jp, batch, "opaque")
    loss, grads = _t_value_and_grad(model, tp, batch, "opaque")
    np.testing.assert_allclose(loss, float(jloss), rtol=2e-4)
    for got, want in zip(grads, jax.tree_util.tree_leaves(jgrads)):
        want = np.asarray(want)
        err = float(np.abs(got.numpy() - want).max())
        assert err <= 1e-4 * float(np.abs(want).max()), (name, want.shape,
                                                          err)


def _train(name: str, mode: str, steps: int, lr: float = 1e-2) -> list:
    """The reference test's ``_train``: SGD at ``lr`` from the reference's
    initial weights."""
    tapir.clear_cache()
    _, _, model, params, batch = _both(name)
    for p in tree_leaves(params):
        p.requires_grad_(True)
    step = fig3.make_step(model, params, _t_batch(batch), _cfg(mode), lr)
    return [float(step()) for _ in range(steps)]


@pytest.mark.parametrize("name", NETS)
def test_paper_net_trains(name):
    losses = _train(name, "tapir", steps=8)
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0], losses


@pytest.mark.parametrize("name", NETS)
def test_paper_net_mode_equivalence(name):
    lt = _train(name, "tapir", steps=3)
    lo = _train(name, "opaque", steps=3)
    np.testing.assert_allclose(lt, lo, rtol=2e-3, atol=2e-4)


def test_paper_net_step_matches_reference_training():
    """Three SGD steps of LSTM1 against the reference's jitted steps on the
    same weights: the update ``p - lr * g`` and its loss trajectory."""
    jm, jp, model, tp, batch = _both("lstm1")
    cfg = jtapir.TapirConfig(mode="tapir")
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    @jax.jit
    def jstep(p):
        with jtapir.use(cfg):
            loss, g = jax.value_and_grad(jm.loss)(p, jb)
        return loss, jax.tree_util.tree_map(lambda a, b: a - 1e-2 * b, p, g)

    want = []
    for _ in range(3):
        loss, jp = jstep(jp)
        want.append(float(loss))
    for p in tree_leaves(tp):
        p.requires_grad_(True)
    step = fig3.make_step(model, tp, _t_batch(batch), _cfg("tapir"), 1e-2)
    got = [float(step()) for _ in range(3)]
    np.testing.assert_allclose(got, want, rtol=2e-4)


# ---------------------------------------------------------------------------
# the serialization ablation, the bridge, the driver
# ---------------------------------------------------------------------------

_BY_BYTES = ("dynamic_update_slice", "dynamic_slice", "index", "slice",
             "gather", "scatter")


def test_ablate_serialization_schedules_no_small_task_serially():
    """With the ablation no dim of a node the grain in FLOPs decides is
    bound serial (window and view ops keep their byte grain, as in the
    reference), where without it the cell's small elementwise tasks have
    such dims; the losses do not change."""
    name = "lstm1"
    _, _, model, tp, batch = _both(name)
    serial = {}
    losses = {}
    for ablate in (False, True):
        tapir.clear_cache()
        with tapir.use(_cfg("tapir", ablate)), torch.no_grad():
            losses[ablate] = float(model.loss(tp, _t_batch(batch)))
        graphs = tapir.cached_graphs()
        assert graphs and all(key[-4] is ablate for key in graphs)
        serial[ablate] = sum(b == "serial"
                             for g in graphs.values()
                             for n in g.nodes.values()
                             if n.op not in _BY_BYTES
                             for b in n.schedule.dim_binding.values())
    assert serial[False] > 0 and serial[True] == 0, serial
    assert losses[True] == losses[False]


def test_ablate_serialization_is_part_of_the_program_key():
    x = torch.randn(4, 16)
    w = torch.randn(16, 8)
    for ablate in (False, True):
        with tapir.use(_cfg("tapir", ablate)):
            tapir.linear(x, w, activation="relu")
    assert tapir.cache_stats()["size"] == 2


def test_paper_params_from_numpy_checks_structure_and_shapes():
    jp = jax.tree_util.tree_map(
        np.asarray, _j_model("ncf").init(jax.random.PRNGKey(0)))
    tp = paper_params_from_numpy("ncf", jp, device="cpu")
    assert [t.shape for t in tree_leaves(tp)] == [
        a.shape for a in jax.tree_util.tree_leaves(jp)]
    bad = dict(jp, out_w=np.zeros((3, 1), np.float32))
    with pytest.raises(ValueError, match="shape"):
        paper_params_from_numpy("ncf", bad, device="cpu")
    with pytest.raises(ValueError, match="expected"):
        paper_params_from_numpy("ncf", {k: v for k, v in jp.items()
                                        if k != "mlp"}, device="cpu")


def test_paper_nets_need_a_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        nets.get_paper_net("cnn").init()
    with pytest.raises(RuntimeError, match="cuda"):
        fig3.main(["--batch", "1"])


def test_fig3_driver_on_the_cpu(tmp_path, monkeypatch):
    """``python -m repro_torch.launch.fig3 --device cpu`` at a small
    batch, on the CNN and NCF (the LSTMs' full 80 / 150 cell steps take
    tens of seconds on the CPU; their step is tested above): both modes,
    finite losses, the geomean of the ratios, the rows in the JSON
    file."""
    benches = fig3.make_benches
    monkeypatch.setattr(fig3, "make_benches", lambda *a: [
        b for b in benches(*a) if b[1] in ("cnn", "ncf")])
    out = tmp_path / "fig3.json"
    res = fig3.main(["--device", "cpu", "--batch", "2", "--iters", "2",
                     "--json", str(out)])
    assert [(r["net"], r["mode"]) for r in res["rows"]] == [
        (n, m) for n in ("CNN", "NCF") for m in ("opaque", "tapir")]
    assert all(np.isfinite(r["loss"]) and r["t_step_s"] > 0
               for r in res["rows"])
    assert res["geomean_ratio"] == pytest.approx(
        fig3.geomean(res["ratios"].values()))
    assert out.exists()


def test_fig3_inputs_have_the_reference_shapes():
    benches = fig3.make_benches(4, seed=0, device="cpu")
    shapes = {label: {k: tuple(v.shape) for k, v in b.items()}
              for label, _, _, b in benches}
    assert shapes == {
        "CNN": {"x": (4, 28, 28, 1), "y": (4,)},
        "LSTM1": {"x": (4, 80, 39), "y": (4,)},
        "LSTM2": {"x": (4, 150, 123), "y": (4, 150)},
        "NCF": {"users": (32,), "items": (32,), "y": (32,)}}
