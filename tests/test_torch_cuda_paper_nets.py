"""The paper's four networks on the card: one SGD step against the same
step on the CPU (the kernels' plain versions, which the CPU tests hold
against the JAX package), tapir mode against opaque mode, two runs bitwise
equal, the GEMM's fp32 route against its plain version at the nets' odd
shapes, and no cuDNN or cuBLAS kernel in a profiled step.

Sizes are the reference test's (``tests/test_paper_nets.py::_batches``);
weights from seed 0, inputs from numpy seed 1.  Needs an NVIDIA card; run
with ``PYTHONPATH=src python -m pytest -q -m cuda
tests/test_torch_cuda_paper_nets.py``.
"""
import re

import numpy as np
import pytest
import torch

from repro_torch.core import tapir
from repro_torch.kernels.fused_matmul import ops, ref
from repro_torch.launch import fig3
from repro_torch.models.paper_nets import LSTM1, LSTM2, get_paper_net
from repro_torch.optim.adamw import tree_leaves, tree_map

pytestmark = pytest.mark.cuda
NETS = ["cnn", "lstm1", "lstm2", "ncf"]
#: a library product or convolution kernel in a profile (the port's own
#: kernels are named ``gemm_f32_kernel`` / ``gemm_bf16_kernel``)
LIBRARY = re.compile(r"gemm|gemv|xmma|nvjet|cutlass|cublas|cudnn",
                     re.IGNORECASE)
PORT = re.compile(r"gemm_(?:bf16|f32)_kernel")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    tapir.clear_cache()
    yield torch.device("cuda")
    tapir.clear_cache()


def _batch(name: str, device) -> dict:
    rng = np.random.default_rng(1)
    if name == "cnn":
        b = {"x": rng.standard_normal((16, 28, 28, 1), np.float32),
             "y": rng.integers(0, 10, (16,))}
    elif name in ("lstm1", "lstm2"):
        cfg = LSTM1 if name == "lstm1" else LSTM2
        bt = (8, 20) if name == "lstm1" else (4, 12)
        y = bt if cfg.per_step_output else bt[:1]
        b = {"x": rng.standard_normal(bt + (cfg.input_dim,), np.float32),
             "y": rng.integers(0, cfg.n_classes, y)}
    else:
        b = {"users": rng.integers(0, 6040, (64,)),
             "items": rng.integers(0, 3706, (64,)),
             "y": rng.integers(0, 2, (64,))}
    return {k: torch.from_numpy(v).to(device) for k, v in b.items()}


def _params(name: str, device):
    """Seed-0 weights drawn on the CPU, the same values on ``device``."""
    cpu = get_paper_net(name).init(torch.Generator().manual_seed(0), "cpu")
    return tree_map(lambda t: t.to(device).requires_grad_(True), cpu)


def _run(name: str, mode: str, device, steps: int = 3, lr: float = 1e-2):
    model = get_paper_net(name)
    params = _params(name, device)
    step = fig3.make_step(model, params, _batch(name, device),
                          fig3.tapir_config(mode, device), lr)
    losses = [step() for _ in range(steps)]
    return torch.stack(losses).cpu(), [p.detach() for p in
                                       tree_leaves(params)]


@pytest.mark.parametrize("name", NETS)
def test_one_step_matches_the_cpu(cuda, name):
    """Loss (rtol 2e-4) and every gradient (within 1e-4 of that
    parameter's largest CPU gradient) of one step, tapir mode."""
    model = get_paper_net(name)
    got = fig3.value_and_grad(model, _params(name, cuda), _batch(name, cuda),
                              fig3.tapir_config("tapir", cuda))
    want = fig3.value_and_grad(model, _params(name, "cpu"),
                               _batch(name, "cpu"),
                               fig3.tapir_config("tapir", "cpu"))
    torch.testing.assert_close(got[0].cpu(), want[0], rtol=2e-4, atol=0)
    for g, w in zip(got[1], want[1]):
        err = float((g.cpu() - w).abs().max())
        assert err <= 1e-4 * float(w.abs().max()), (name, tuple(w.shape),
                                                    err)


@pytest.mark.parametrize("name", NETS)
def test_tapir_matches_opaque_on_the_card(cuda, name):
    lt, _ = _run(name, "tapir", cuda)
    lo, _ = _run(name, "opaque", cuda)
    np.testing.assert_allclose(lt.numpy(), lo.numpy(), rtol=2e-3, atol=2e-4)


@pytest.mark.parametrize("name", NETS)
def test_two_runs_are_bitwise_equal(cuda, name):
    """Three steps twice from the same weights: the losses and every
    updated parameter bit for bit (the GEMM's fixed k order, the
    embeddings' sorted backward, the max-pool's one-winner gather)."""
    la, pa = _run(name, "tapir", cuda)
    lb, pb = _run(name, "tapir", cuda)
    assert torch.equal(la, lb)
    assert all(torch.equal(a, b) for a, b in zip(pa, pb))


#: the fp32 route's odd shapes on the nets' paths: NCF's n = 1 output, the
#: heads' n = 10, conv1's k = 9 at m = 50176, LSTM1's k = 295, conv2's
#: k = 288; conv1's dW shape as a forward (9 x 32 over 50176, split over
#: k) and the LSTM2 head (9600 x 61 over 512, whose dW is 512 x 61 over
#: 9600)
ODD = [(512, 1, 24), (64, 10, 128), (50176, 32, 9), (64, 1024, 295),
       (12544, 64, 288), (64, 2048, 635), (64, 128, 3136), (9, 32, 50176),
       (9600, 61, 512)]


@pytest.mark.parametrize("m,n,k", ODD)
def test_fp32_route_matches_plain_at_odd_shapes(cuda, m, n, k):
    """The forward with a bias + relu epilogue, dX and dW against the
    plain versions (fp32 accumulation both sides; within 1e-5 of the
    largest output)."""
    gen = torch.Generator(device="cuda").manual_seed(m + n + k)
    x = torch.randn(m, k, generator=gen, device="cuda")
    w = torch.randn(k, n, generator=gen, device="cuda") / k ** 0.5
    b = torch.randn(n, generator=gen, device="cuda")
    dy = torch.randn(m, n, generator=gen, device="cuda")
    epi = [("add", [b], {"head_pos": 0, "dtype": "float32"}),
           ("relu", [], {"head_pos": 0, "dtype": "float32"})]
    pairs = [(ops.fused_matmul(x, w, epilogue=epi),
              ref.fused_matmul_ref(x, w, epilogue=epi)),
             (ops.matmul_dx(dy, w), ref.matmul_dx_ref(dy, w)),
             (ops.matmul_dw(x, dy), ref.matmul_dw_ref(x, dy))]
    for got, want in pairs:
        assert got.shape == want.shape
        err = float((got - want).abs().max())
        assert err <= 1e-5 * float(want.abs().max()) + 1e-6, (m, n, k, err)


@pytest.mark.parametrize("name", NETS)
def test_no_library_kernel_in_a_profiled_step(cuda, name):
    from torch.profiler import ProfilerActivity, profile
    model = get_paper_net(name)
    params = _params(name, cuda)
    step = fig3.make_step(model, params, _batch(name, cuda),
                          fig3.tapir_config("tapir", cuda))
    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    names = [ev.key for ev in prof.key_averages()
             if ev.device_type == torch.autograd.DeviceType.CUDA]
    assert any(PORT.search(k) for k in names), names
    library = [k for k in names if LIBRARY.search(k) and not PORT.search(k)]
    assert not library, library
