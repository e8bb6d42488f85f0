"""The scan backward's host-side plan, on the CPU: the route and checkpoint
interval (``kernel.plan_bwd``), the fp32 workspace the wrapper allocates
for the checkpointed carries (``kernel.bwd_scratch``), and that
``ops.linear_scan_bwd`` hands a launch on a CUDA tensor exactly that
workspace while a CPU tensor still runs the plain version.  Pure functions
of the shapes; the kernels themselves are held to the plain version on
the card (``tests/test_torch_cuda_scan_bwd.py``).
"""
import inspect

import pytest
import torch

from repro_torch.kernels.linear_scan import kernel, ops, ref

BF16, F32 = torch.bfloat16, torch.float32
G = kernel.BWD_GROUP

#: (B, S, H, Dk, Dv, chunk, chunks N): RWKV6-7B's train shape, SMOKE,
#: ragged S (37, 1000), a chunk count that is no multiple of the interval
#: (16 G 3 + 16 + 5 rows), S below the chunk, chunks of 1 and 4
SHAPES = [(2, 2048, 64, 64, 64, 16, 128), (2, 28, 4, 16, 16, 16, 2),
          (2, 37, 4, 64, 64, 16, 3), (1, 1000, 2, 64, 64, 16, 63),
          (2, 16 * G * 3 + 16 + 5, 4, 64, 64, 16, 3 * G + 2),
          (2, 5, 3, 8, 12, 16, 1), (2, 40, 3, 8, 12, 1, 40),
          (2, 50, 3, 32, 100, 4, 13)]


def test_plan_reads_the_dtype_alone():
    """bf16 takes the tensor-core kernels with a checkpoint every
    BWD_GROUP chunks; fp32 the FMA kernels, every chunk's carries.  Never
    a function of B or S, so a row's sums are the same in any batch."""
    assert list(inspect.signature(kernel.plan_bwd).parameters) == ["dtype"]
    assert kernel.plan_bwd(BF16) == ("mma", G)
    assert kernel.plan_bwd(F32) == ("fma", 1)
    assert 1 <= G <= 4   # the chunk kernel has room for G - 1 neighbours


@pytest.mark.parametrize("shape", SHAPES)
def test_scratch_holds_one_checkpoint_per_group(shape):
    """``(2, B, H, ceil(N / G), Dk, Dv)``: the carry entering each group
    and the gradient of the one leaving it; fp32 keeps all N."""
    b, s, h, dk, dv, chunk, n = shape
    assert -(-s // min(chunk, s)) == n
    assert kernel.bwd_scratch(BF16, b, s, h, dk, dv, chunk) == (
        2, b, h, -(-n // G), dk, dv)
    assert kernel.bwd_scratch(F32, b, s, h, dk, dv, chunk) == (
        2, b, h, n, dk, dv)


def test_train_shape_workspace_is_a_quarter():
    """At RWKV6-7B's train shape the two workspaces take 2 x 67 MB, a
    G-th of the 2 x 268 MB that every chunk's carries would."""
    bf = kernel.bwd_scratch(BF16, 2, 2048, 64, 64, 64, 16)
    full = kernel.bwd_scratch(F32, 2, 2048, 64, 64, 64, 16)
    assert bf == (2, 2, 64, 128 // G, 64, 64)
    assert 4 * torch.Size(full).numel() == 2 * 268435456
    assert torch.Size(full).numel() == G * torch.Size(bf).numel()


def _inputs(shape, dt, seed=0):
    b, s, h, dk, dv, _, _ = shape
    g = torch.Generator().manual_seed(seed)
    q, k = (torch.randn(b, s, h, dk, generator=g).to(dt) for _ in range(2))
    v, do = (torch.randn(b, s, h, dv, generator=g).to(dt) for _ in range(2))
    w = torch.rand(b, s, h, dk, generator=g) * 0.5 + 0.4
    u = torch.randn(h, dk, generator=g)
    s0, ds = (torch.randn(b, h, dk, dv, generator=g) for _ in range(2))
    return q, k, v, w, u, do, s0, ds


class _FakeCuda:
    type = "cuda"


_FAKE = _FakeCuda()


@pytest.mark.parametrize("dt", [BF16, F32])
@pytest.mark.parametrize("shape", SHAPES[1:])
def test_a_cuda_tensor_gets_the_planned_workspace(shape, dt, monkeypatch):
    """On a CUDA tensor (a stand-in device) the wrapper launches once with
    the chunk, a contiguous fp32 workspace of ``bwd_scratch``'s shape, du's
    per-chunk partials and the six outputs, and counts one launch."""
    b, s, h, dk, dv, chunk, n = shape
    q, k, v, w, u, do, s0, ds = _inputs(shape, dt)
    seen = []

    def launch_bwd(q_, k_, v_, w_, u_, do_, c, s0_, ds1, ws, dup, *outs):
        seen.append((c, tuple(ws.shape), ws.dtype, ws.is_contiguous(),
                     tuple(dup.shape), [None if o is None else o.dtype
                                        for o in outs]))
        for o in outs:
            if o is not None:
                o.zero_()
    monkeypatch.setattr(kernel, "launch_bwd", launch_bwd)
    monkeypatch.setattr(torch.Tensor, "device",
                        property(lambda self: _FAKE))
    ops.reset_counts()
    out = ops.linear_scan_bwd(q, k, v, w, u, do, chunk, init_state=s0,
                              d_state=ds)
    monkeypatch.undo()
    assert seen == [(min(chunk, s),
                     kernel.bwd_scratch(dt, b, s, h, dk, dv, chunk),
                     F32, True, (b, h, n, dk),
                     [dt, dt, dt, F32, F32, F32])]
    assert ops.bwd_launches == 1
    assert [tuple(t.shape) for t in out] == [
        (b, s, h, dk), (b, s, h, dk), (b, s, h, dv), (b, s, h, dk), (h, dk),
        (b, h, dk, dv)]


@pytest.mark.parametrize("dt", [BF16, F32])
def test_a_cpu_tensor_runs_the_plain_version(dt, monkeypatch):
    """On the CPU the wrapper calls ``linear_scan_bwd_ref`` with the same
    arguments and launches nothing."""
    shape = SHAPES[4]
    q, k, v, w, u, do, s0, ds = _inputs(shape, dt, seed=1)
    calls = []
    real = ref.linear_scan_bwd_ref

    def spy(*a, **kw):
        calls.append(kw)
        return real(*a, **kw)

    def no_launch(*a, **kw):
        raise AssertionError("a CPU tensor launched the kernel")
    monkeypatch.setattr(ref, "linear_scan_bwd_ref", spy)
    monkeypatch.setattr(kernel, "launch_bwd", no_launch)
    ops.reset_counts()
    got = ops.linear_scan_bwd(q, k, v, w, u, do, 16, init_state=s0,
                              d_state=ds)
    want = real(q, k, v, w, u, do, chunk=16, init_state=s0, d_state=ds)
    assert len(calls) == 1 and calls[0]["chunk"] == 16
    assert ops.bwd_launches == 0
    for a, b in zip(got, want):
        assert torch.equal(a, b)
