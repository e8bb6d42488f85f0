"""The port's mesh layer without rank processes: the sharding rules held to
the reference's functions (its ``logical_to_pspec`` / ``batch_pspec`` read
only a mesh's ``axis_names`` and ``shape``, so a stand-in serves; its
``param_shardings`` with ``NamedSharding`` read back as the spec), the
one-device guarantees of ``shard_act``, the plain GEMM's blocks, the
shared-input fusion of a rank's blocks, and the program caches keyed on the mesh
fingerprint and purged by ``invalidate_mesh`` in both tiers."""
import dataclasses
import types

import jax
import numpy as np
import pytest
import torch

import repro.dist.sharding as RS
from repro_torch.configs import get_smoke
from repro_torch.core import tapir
from repro_torch.core.ir import TaskGraph, TensorType
from repro_torch.core.lowering import emit
from repro_torch.core.passes import mesh_fingerprint, run_pipeline
from repro_torch.core.schedule import CPU_COST_MODEL
from repro_torch.dist import shard_act, sharding as PS, use_mesh
from repro_torch.kernels.fused_matmul.ref import matmul_f32
from repro_torch.models.base import get_model


def _mesh(**axes):
    """A stand-in mesh: the attributes the rules read, and coordinates 0."""
    return types.SimpleNamespace(
        axis_names=tuple(axes), shape=dict(axes),
        size=int(np.prod(list(axes.values()))),
        fingerprint=tuple(axes.items()), coord=lambda a: 0)


MESHES = [_mesh(data=2, model=2), _mesh(data=2, model=4),
          _mesh(pod=2, data=2, model=2), _mesh(data=4, model=1)]
AXES = [("batch", "seq", None), ("batch", None, "heads", None),
        ("batch", None, "kv", None), (None, None, "kv", None),
        ("vocab", "embed"), ("embed", "vocab"), ("batch", "vocab"),
        ("layers", "embed", "mlp"), ("heads", "kv"), ("batch",),
        ("expert", "embed", "mlp"), ("batch", None, "kvseq", None)]
SHAPES = [(4, 16, 96), (2, 1, 4, 24), (2, 1, 2, 24), (9, 32, 2, 24),
          (512, 96), (96, 512), (3, 512), (2, 96, 192), (4, 2), (1,),
          (8, 96, 192), (4, 1, 6, 24)]


def test_the_rules_table_is_the_reference_s():
    assert PS._RULES == RS._RULES


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: str(m.shape))
def test_logical_to_pspec_is_the_reference_s(mesh):
    for axes in AXES:
        want = RS.logical_to_pspec(axes, mesh)
        assert PS.logical_to_pspec(axes, mesh) == tuple(want), axes
    for axes, shape in zip(AXES, SHAPES):
        shape = shape[:len(axes)] + (1,) * (len(axes) - len(shape))
        want = RS.logical_to_pspec(axes, mesh, shape=shape)
        assert PS.logical_to_pspec(axes, mesh, shape=shape) == \
            tuple(want), (axes, shape)


@pytest.mark.parametrize("seq", [None, "model"])
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: str(m.shape))
def test_batch_pspec_is_the_reference_s(mesh, seq):
    prev_p, prev_r = PS.configure_rules(seq=seq), RS.configure_rules(seq=seq)
    try:
        for ndim in (1, 2, 3):
            for b in (None, 1, 2, 3, 4, 8):
                assert PS.batch_pspec(mesh, ndim, b) == \
                    tuple(RS.batch_pspec(mesh, ndim, b)), (ndim, b)
    finally:
        PS.configure_rules(**prev_p)
        RS.configure_rules(**prev_r)


@pytest.mark.parametrize("strategy", ["tp", "fsdp_tp"])
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: str(m.shape))
def test_param_shardings_are_the_reference_s(mesh, strategy, monkeypatch):
    """qwen2.5-3b SMOKE's parameter tree: the reference's NamedSharding
    tree read back as specs."""
    cfg = dataclasses.replace(get_smoke("qwen2_5_3b"),
                              compute_dtype="float32")
    model = get_model(cfg, device="cpu")
    axes = model.param_axes()
    shapes = jax.tree_util.tree_map(
        lambda t: jax.ShapeDtypeStruct(tuple(t.shape), np.float32),
        model.param_tree())
    monkeypatch.setattr(RS, "NamedSharding", lambda m, p: tuple(p))
    want = RS.param_shardings(axes, shapes, mesh, strategy)
    got = PS.param_shardings(axes, model.param_tree(), mesh, strategy)
    flat_w = jax.tree_util.tree_leaves(want, is_leaf=lambda x:
                                       isinstance(x, tuple))
    flat_g = jax.tree_util.tree_leaves(got, is_leaf=lambda x:
                                       isinstance(x, tuple))
    assert flat_g == flat_w
    if strategy == "tp" and mesh.shape.get("model") == 2:
        assert got["blocks"]["wq"] == (None, None, "model")
        assert got["blocks"]["wo"] == (None, "model", None)


def test_shard_act_without_a_mesh_or_on_one_rank_is_the_identity():
    x = torch.randn(4, 3, 8)
    assert shard_act(x, "batch", None, "heads") is x
    one = _mesh(data=1, model=1)
    with use_mesh(one):
        assert shard_act(x, "batch", None, "heads") is x
    assert mesh_fingerprint() == ()


def test_a_mesh_keys_every_program_on_its_fingerprint():
    m = _mesh(data=2, model=2)
    assert tapir._cfg_key(tapir.TapirConfig())[-1] == ()
    with use_mesh(m):
        assert mesh_fingerprint() == (("data", 2), ("model", 2))
        assert tapir._cfg_key(tapir.TapirConfig())[-1] == m.fingerprint


def test_tensor_blocks_slice_by_coordinates():
    t = torch.arange(48.).reshape(4, 12)
    m = _mesh(data=2, model=2)
    m.coord = {"data": 1, "model": 0}.get
    assert torch.equal(PS.local_block(t, ("data", "model"), m), t[2:, :6])
    assert torch.equal(PS.reshard_tensor(t, None, (None, "model"), m),
                       t[:, :6])
    assert PS.global_shape((2, 6), ("data", "model"), m) == (4, 12)
    assert PS.local_shape((4, 12), (None, "model"), m) == (4, 6)
    assert PS.effective((None, "data"), _mesh(data=1, model=2)) is None
    assert PS.tp_last_dim_spec(("embed", "heads"), (96, 96), m) == \
        (None, "model")
    assert PS.tp_last_dim_spec(("heads", "embed"), (96, 96), m) == \
        (None, None)


@pytest.mark.parametrize("m,k,n", [(1, 96, 144), (2, 96, 144), (4, 96, 48),
                                   (3, 192, 512), (8, 96, 96),
                                   (16, 24, 1024)])
def test_plain_gemm_blocks_equal_the_whole(m, k, n):
    """A rank's row or column block of the plain GEMM is that block of the
    whole product, bit for bit: a one-row product takes BLAS's gemm, not
    its gemv."""
    g = torch.Generator().manual_seed(m * n)
    x = torch.randn(m, k, generator=g)
    w = torch.randn(k, n, generator=g)
    whole = matmul_f32(x, w)
    for parts in (2, 4):
        c = n // parts
        for r in range(parts):
            blk = matmul_f32(x, w[:, r * c:(r + 1) * c].contiguous())
            assert torch.equal(blk, whole[:, r * c:(r + 1) * c])
        if m % parts == 0:
            h = m // parts
            for r in range(parts):
                assert torch.equal(matmul_f32(x[r * h:(r + 1) * h], w),
                                   whole[r * h:(r + 1) * h])
    assert torch.equal(matmul_f32(x[:1], w), whole[:1])


def _qkv_graph(hq=4, hkv=2, hd=24, d=96, m=3):
    g = TaskGraph("qkv")
    x = g.add_input("x", TensorType((m, d), "float32"))
    outs = []
    for name, h in (("wq", hq), ("wk", hkv), ("wv", hkv)):
        w = g.add_input(name, TensorType((d, h * hd), "float32"))
        t = TensorType((m, h * hd), "float32")
        outs.append(g.add("matmul", (x, w), t, pdims=(0, 1),
                          rdims=(("k", d),), k=d, exposed=True))
    g.set_outputs(outs)
    return g


def test_a_rank_s_fused_qkv_columns_are_the_whole_s():
    """Under a model axis the shared-input fusion keeps its concat form: a
    rank's q | k | v blocks ``[wq_r | wk_r | wv_r]`` are ONE GEMM, whose
    columns are the whole fused GEMM's columns of those heads, bit for bit
    (the split is a function of k alone)."""
    gen = torch.Generator().manual_seed(0)
    hd, parts = 24, 2
    ins = {"x": torch.randn(3, 96, generator=gen),
           "wq": torch.randn(96, 96, generator=gen),
           "wk": torch.randn(96, 48, generator=gen),
           "wv": torch.randn(96, 48, generator=gen)}
    flat = run_pipeline(_qkv_graph(), "tapir", CPU_COST_MODEL)
    assert sum(n.op == "matmul" for n in flat.nodes.values()) == 1
    whole = emit(flat)(ins)
    for r in range(parts):
        blk = {"x": ins["x"]}
        for name in ("wq", "wk", "wv"):
            c = ins[name].shape[1] // parts
            blk[name] = ins[name][:, r * c:(r + 1) * c].contiguous()
        with use_mesh(_mesh(data=1, model=parts)):
            g = run_pipeline(_qkv_graph(hq=2, hkv=1, hd=hd), "tapir",
                             CPU_COST_MODEL)
        assert sum(n.op == "matmul" for n in g.nodes.values()) == 1
        for got, w in zip(emit(g)(blk), whole):
            c = w.shape[1] // parts
            assert torch.equal(got, w[:, r * c:(r + 1) * c])


@pytest.mark.parametrize("fn", ["exp", "log", "rsqrt", "tanh", "sigmoid",
                                "gelu", "silu"])
def test_plain_transcendentals_do_not_depend_on_layout(fn):
    """A transcendental element-wise op of the plain versions gives each
    element the same bits in a strided column slice (a fused GEMM's
    member, a rank's 48 of 192 gate columns) as in a contiguous block or
    in the whole: no element takes ATen's scalar tail path."""
    from repro_torch.kernels.fused_matmul.ref import _EW
    y = torch.randn(32, 384, generator=torch.Generator().manual_seed(1))
    y = y.abs() + 0.5 if fn in ("log", "rsqrt") else 3 * y
    f = _EW[fn]
    whole = f(y[:, :192])
    for c0, c1 in ((0, 48), (48, 96), (100, 117)):
        assert torch.equal(f(y[:, c0:c1]), whole[:, c0:c1])
        assert torch.equal(f(y[:, c0:c1].contiguous()), whole[:, c0:c1])
    assert torch.equal(f(y[0, :5]), whole[0, :5])


def test_invalidate_mesh_purges_memory_and_disk(tmp_path):
    """Programs compiled under two meshes: invalidating one fingerprint
    drops its programs, replay entries and store entries and keeps the
    other's."""
    tapir.clear_cache()
    cfg = tapir.TapirConfig(cost_model=CPU_COST_MODEL,
                            program_cache_dir=str(tmp_path))

    @tapir.parallel_region
    def body(x, w):
        return tapir.linear(x, w) * 2.0

    x, w = torch.randn(2, 8), torch.randn(8, 8)
    fps = []
    for m in (_mesh(data=2, model=2), _mesh(data=1, model=2)):
        with use_mesh(m), tapir.use(cfg):
            body(x, w)
        fps.append(m.fingerprint)
    store = tapir.program_cache(cfg)

    def disk():
        return sorted(tuple(tuple(p) for p in meta["mesh_fingerprint"])
                      for _, meta in store.entries())
    assert disk() == sorted(fps)
    assert {k[-1] for k in tapir._PROGRAMS} == set(fps)
    n = tapir.invalidate_mesh(fps[0])
    assert n >= 3
    assert {k[-1] for k in tapir._PROGRAMS} == {fps[1]}
    assert {k[-1] for k in tapir._CACHE} == {fps[1]}
    assert disk() == [fps[1]]
    tapir.clear_cache()


@pytest.mark.parametrize("S", [1, 5])
def test_masked_composite_shards_equal_the_whole(S):
    """The masked attention composite (slot decode, slot prefill, padded
    decode): a rank's rows and kv-head group, run at the whole call's
    (rows, kv heads), give that block of the whole call bit for bit, and
    the whole equals the grouped einsum form."""
    from repro_torch.models import transformer as T
    g = torch.Generator().manual_seed(S)
    B, H, Hkv, hd, K = 4, 8, 2, 24, 40
    q = torch.randn(B, S, H, hd, generator=g)
    ck, cv = (torch.randn(B, K, Hkv, hd, generator=g) for _ in range(2))
    vl = torch.tensor([S + 3, K, S + 10, S])
    whole = T._masked_decode_attention(q, ck, cv, vl)
    for rows in (slice(0, 2), slice(2, 4)):
        for j in range(Hkv):
            heads = slice(j * H // Hkv, (j + 1) * H // Hkv)
            blk = T._masked_decode_attention(
                q[rows, :, heads], ck[rows, :, j:j + 1],
                cv[rows, :, j:j + 1], vl[rows], pairs=(B, Hkv))
            assert torch.equal(blk, whole[rows, :, heads])
    s = torch.einsum("bqhgd,bkhd->bhgqk",
                     q.reshape(B, S, Hkv, H // Hkv, hd), ck) / np.sqrt(hd)
    qpos = vl[:, None] - S + torch.arange(S)
    mask = torch.arange(K) <= qpos[..., None]
    p = torch.softmax(torch.where(mask[:, None, None], s,
                                  torch.finfo(torch.float32).min), dim=-1)
    want = torch.einsum("bhgqk,bkhd->bqhgd", p, cv).reshape(B, S, H, hd)
    torch.testing.assert_close(whole, want, rtol=1e-6, atol=1e-6)


def test_schedules_note_each_annotated_node_s_shard():
    """A library node annotated over the model axis is noted as a 1/2
    shard of the whole (``schedule.shard_factor``)."""
    from repro_torch.core.schedule import shard_factor
    g = _qkv_graph()
    mm = next(n for n in g.nodes.values() if n.op == "matmul")
    mm.sharding = (None, "model")
    assert shard_factor(mm, {"data": 2, "model": 2}) == 2.0
    assert shard_factor(mm, None) == 1.0
    # one GEMM alone: fused with others it would become a member of a wider
    # product, its annotation kept on its slice
    g2 = TaskGraph("one")
    x = g2.add_input("x", TensorType((3, 96), "float32"))
    w = g2.add_input("w", TensorType((96, 48), "float32"))
    g2.set_outputs([g2.add("matmul", (x, w), TensorType((3, 48), "float32"),
                           pdims=(0, 1), rdims=(("k", 96),), k=96,
                           exposed=True, sharding=(None, "model"))])
    with use_mesh(_mesh(data=2, model=2)):
        run_pipeline(g, "opaque", CPU_COST_MODEL)
        run_pipeline(g2, "tapir", CPU_COST_MODEL)
    notes = [note for n in g2.nodes.values() for note in n.schedule.notes]
    assert any("per shard: 1/2" in note for note in notes), notes
