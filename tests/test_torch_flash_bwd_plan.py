"""The flash backward's host-side plan, on the CPU: its tiles
(``kernel.plan_bwd``), the order and size of its work units
(``kernel.bwd_units``, the order the bf16 kernels number their blocks in)
and the fp32 scratch the wrapper allocates for dK/dV's partial sums
(``kernel.bwd_scratch``).  Pure functions of the shapes; the kernels
themselves are held to the same tiles on the card
(``tests/test_torch_cuda_flash_bwd.py``).

Each unit's step count is checked against a brute-force count of the
tiles that hold a visible (query, key) pair: a unit must skip no tile with
one and visit none without.
"""
import functools
import inspect

import pytest
import torch

from repro_torch.kernels.flash_attention import kernel

BF16 = torch.bfloat16

#: (B, Sq, Skv, Hq, Hkv, D, causal): the qwen2.5-3b train shape, SMOKE,
#: ragged lengths one past a 64 / 128 edge, causal Skv > Sq off every edge,
#: GQA groups 1, 3 and 8, non-causal
SHAPES = [(2, 2048, 2048, 16, 2, 128, True), (2, 28, 28, 4, 2, 24, True),
          (1, 129, 129, 16, 2, 128, True), (2, 64, 257, 8, 1, 64, True),
          (1, 257, 257, 4, 2, 128, False), (2, 100, 129, 8, 1, 24, True),
          (1, 300, 300, 3, 1, 128, True), (1, 77, 150, 8, 1, 32, False),
          (1, 200, 200, 8, 8, 128, False), (2, 100, 300, 16, 2, 128, True)]


@functools.lru_cache(maxsize=None)
def _visible(q_lo, q_hi, k_lo, k_hi, sq, skv, causal):
    """Whether query rows [q_lo, q_hi) and keys [k_lo, k_hi) (cut at Sq
    and Skv) hold a pair the mask leaves visible, over every pair."""
    off = skv - sq if causal else 0
    q = torch.arange(q_lo, min(q_hi, sq))[:, None]
    k = torch.arange(k_lo, min(k_hi, skv))[None, :]
    seen = k <= q + off if causal else (k >= 0) & (q >= 0)
    return bool(seen.any())


def test_plan_bwd_reads_dtype_and_head_dim_only():
    """The route and tiles are a function of (dtype, D), never of B, Sq
    or Skv, so every output element is summed in one order whatever the
    batch."""
    assert list(inspect.signature(kernel.plan_bwd).parameters) == [
        "dtype", "d"]
    for d in range(1, kernel.MAX_HEAD_DIM + 1):
        pad = 64 if d <= 64 else 128
        assert kernel.plan_bwd(BF16, d) == ("wgmma", 128, 64, 128, 64, 2,
                                            pad)
        assert kernel.plan_bwd(torch.float32, d) == ("fma", 64, 64, 64, 64,
                                                     0, pad)


@pytest.mark.parametrize("shape", SHAPES)
def test_every_key_tile_and_head_is_one_unit_longest_first(shape):
    """dK/dV: each (key tile, query head, batch) belongs to exactly one
    unit, a unit holds query heads of one K/V group, units come key tile
    by key tile with the most query tiles first (longest first, unless the
    group is odd: then a tile's one-head unit may be shorter than the next
    tile's two-head ones), and a unit's steps are the query tiles that see
    its keys."""
    b, sq, skv, hq, hkv, d, causal = shape
    p = kernel.plan_bwd(BF16, d)
    grp = hq // hkv
    dkdv, _ = kernel.bwd_units(BF16, d, b, sq, skv, hq, hkv, causal)
    seen, per_head = [], []
    for kt, split, hk, bi, steps in dkdv:
        heads = [hk * grp + split * p.heads + i for i in range(p.heads)
                 if split * p.heads + i < grp]
        assert heads and all(h // grp == hk for h in heads)
        seen += [(kt, h, bi) for h in heads]
        tiles = sum(_visible(qt * p.block_q, (qt + 1) * p.block_q,
                             kt * p.block_kv, (kt + 1) * p.block_kv, sq, skv,
                             causal)
                    for qt in range(-(-sq // p.block_q)))
        assert steps == len(heads) * tiles
        per_head.append(tiles)
    n_kt = -(-skv // p.block_kv)
    assert sorted(seen) == [(kt, h, bi) for kt in range(n_kt)
                            for h in range(hq) for bi in range(b)]
    # the key tile with the most query tiles first; with a group that is a
    # multiple of the unit's heads, every unit is longest first
    assert per_head == sorted(per_head, reverse=True)
    steps = [u[-1] for u in dkdv]
    if grp % p.heads == 0:
        assert steps == sorted(steps, reverse=True)


@pytest.mark.parametrize("shape", SHAPES)
def test_every_query_tile_and_head_is_one_dq_unit_longest_first(shape):
    """dQ: each (query tile, head, batch) is exactly one unit, units come
    longest first, and a unit's steps are the key tiles its rows see."""
    b, sq, skv, hq, hkv, d, causal = shape
    p = kernel.plan_bwd(BF16, d)
    _, dq = kernel.bwd_units(BF16, d, b, sq, skv, hq, hkv, causal)
    n_qt = -(-sq // p.dq_block_q)
    assert sorted(u[:3] for u in dq) == [(qt, h, bi) for qt in range(n_qt)
                                         for h in range(hq)
                                         for bi in range(b)]
    for qt, _, _, steps in dq:
        assert steps == sum(
            _visible(qt * p.dq_block_q, (qt + 1) * p.dq_block_q,
                     t * p.dq_block_kv, (t + 1) * p.dq_block_kv, sq, skv,
                     causal)
            for t in range(-(-skv // p.dq_block_kv)))
    steps = [u[-1] for u in dq]
    assert steps == sorted(steps, reverse=True)


def test_train_shape_units_fill_the_card():
    """The counts the source's header states for qwen2.5-3b's train shape:
    256 dK/dV units (64 with one unit per K/V head and key tile) of 64, 60,
    .., 4 steps, 8704 in all; 512 dQ units."""
    dkdv, dq = kernel.bwd_units(BF16, 128, 2, 2048, 2048, 16, 2, True)
    assert len(dkdv) == 256 and len(dq) == 512
    assert sum(u[-1] for u in dkdv) == 8704
    assert sorted({u[-1] for u in dkdv}) == list(range(4, 65, 4))
    assert sorted({u[-1] for u in dq}) == list(range(2, 33, 2))


@pytest.mark.parametrize("hq,hkv,splits", [(16, 2, 4), (3, 1, 2), (4, 4, 1),
                                           (8, 1, 4), (2, 1, 1)])
def test_scratch_holds_each_split_of_dk_and_dv(hq, hkv, splits):
    """bf16: fp32 partials of dK and dV for each run of ``heads`` query
    heads of a group; fp32 needs none."""
    assert kernel.bwd_splits(kernel.plan_bwd(BF16, 64), hq, hkv) == splits
    assert kernel.bwd_scratch(BF16, 64, 2, 300, hq, hkv) == (
        2, splits, 2, 300, hkv, 64)
    assert kernel.bwd_scratch(torch.float32, 64, 2, 300, hq, hkv) is None
    assert kernel.bwd_splits(kernel.plan_bwd(torch.float32, 64), hq,
                             hkv) == 1


def test_train_shape_scratch_is_33_5_mb():
    shape = kernel.bwd_scratch(BF16, 128, 2, 2048, 16, 2)
    assert shape == (2, 4, 2, 2048, 2, 128)
    assert 4 * torch.Size(shape).numel() == 33554432
