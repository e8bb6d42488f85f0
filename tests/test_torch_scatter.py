"""The port's drop-mode scatter (``core.lowering.scatter_drop``) against the
JAX package's semantics, ``buf.at[i0, i1, ...].set/add(upd, mode="drop")``,
bitwise on the same numpy inputs: a negative index wraps once, a row out
of range after that writes nothing, and among duplicates of one target the
last row wins for "set" (every row adds for "add").  Also the number of
aten ops one KV-pool write dispatches at the slot path's shape, and that
the K and V writes of a block share one index preparation.
"""
import collections

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.core.ir import TaskGraph, TensorType
from repro_torch.core.lowering import emit, scatter_drop
from repro_torch.core.passes import run_pipeline
from repro_torch.core.schedule import CPU_COST_MODEL

DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}

#: (buffer lead dims, index rows per axis): duplicates, negatives that
#: wrap, negatives past -n, rows past n, and a row that is in range on one
#: axis only
CASES = {
    "1d": ((6,), [[0, 2, 2, -1, 6, -7, 9, 2, -6]]),
    "2d": ((4, 5), [[1, 1, -1, 4, 0, -5, 3, 1, 2],
                    [2, 2, 0, 1, 5, 1, -5, 2, -6]]),
    "2d_bcast": ((3, 4), [[2], [0, 3, 3, -1, 4, -9]]),
}


def _inputs(lead, idx, dt, seed: int = 0):
    rng = np.random.default_rng(seed)
    tail = (3,)
    rows = np.broadcast_shapes(*[np.shape(i) for i in idx])
    buf = rng.standard_normal(lead + tail).astype(np.float32)
    upd = rng.standard_normal(rows + tail).astype(np.float32)
    tdt, jdt = DTYPES[dt]
    return ((torch.as_tensor(buf).to(tdt), torch.as_tensor(upd).to(tdt)),
            (jnp.asarray(buf).astype(jdt), jnp.asarray(upd).astype(jdt)))


def _reference(jbuf, idx, jupd, mode):
    ji = tuple(jnp.asarray(np.asarray(i, np.int32)) for i in idx)
    out = getattr(jbuf.at[ji], mode)(jupd, mode="drop")
    return np.asarray(out.astype(jnp.float32))


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("mode", ["set", "add"])
def test_scatter_drop_matches_jax_bitwise(case, dt, mode):
    lead, idx = CASES[case]
    (buf, upd), (jbuf, jupd) = _inputs(lead, idx, dt)
    want = _reference(jbuf, idx, jupd, mode)
    ti = tuple(torch.as_tensor(np.asarray(i, np.int32)) for i in idx)
    got = scatter_drop(buf, ti, upd, mode, in_place=False)
    np.testing.assert_array_equal(got.float().numpy(), want)
    # the functional write leaves the buffer; the donated one writes it
    (buf0, _), _ = _inputs(lead, idx, dt)
    assert torch.equal(buf, buf0)
    same = scatter_drop(buf, ti, upd, mode, in_place=True)
    assert same is buf
    np.testing.assert_array_equal(buf.float().numpy(), want)


@pytest.mark.parametrize("mode", ["set", "add"])
def test_scatter_drop_matches_jax_on_random_indices(mode):
    rng = np.random.default_rng(1)
    for trial in range(120):
        lead = tuple(int(n) for n in rng.integers(1, 6, rng.integers(1, 3)))
        r = int(rng.integers(1, 9))
        idx = [rng.integers(-2 * n - 1, 2 * n + 1, r) for n in lead]
        dt = ("float32", "bfloat16")[trial % 2]
        (buf, upd), (jbuf, jupd) = _inputs(lead, idx, dt, seed=trial)
        want = _reference(jbuf, idx, jupd, mode)
        got = scatter_drop(buf, tuple(torch.as_tensor(np.asarray(i, np.int32))
                                      for i in idx), upd, mode,
                           in_place=False)
        np.testing.assert_array_equal(got.float().numpy(), want,
                                      err_msg=f"{lead} {idx}")


class _AtenOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[str(func)] += 1
        return func(*args, **(kwargs or {}))


def _slot_write_args():
    """One decode step's K write at qwen2.5-3b's slot shape: 4 slots, a
    pool of 65 pages of 64 rows, 2 KV heads of 128, bf16."""
    pool = torch.zeros((65, 64, 2, 128), dtype=torch.bfloat16)
    phys = torch.tensor([1, 9, 17, 25], dtype=torch.int32)
    off = torch.tensor([3, 4, 5, 6], dtype=torch.int32)
    upd = torch.ones((4, 2, 128), dtype=torch.bfloat16)
    return pool, (phys, off), upd


def test_aten_ops_per_slot_write():
    """32 aten ops (9 of them views) per write, where the R x R duplicate
    matrix form dispatched 45 (and a pool-sized buffer of winners, 31):
    last-wins is a stable sort and a search over the R written rows."""
    pool, idx, upd = _slot_write_args()
    with _AtenOps() as mode:
        scatter_drop(pool, idx, upd, "set", in_place=True)
    assert sum(mode.ops.values()) == 32
    assert mode.ops["aten.index_put_.default"] == 1


def test_k_and_v_writes_share_the_index_preparation():
    """A region program that writes K and V through the same index nodes
    prepares them once: the pair dispatches 9 aten ops more than one
    write (the second write's two gathers, its select and its
    ``index_put_``, and five views), not 32."""
    pool, (phys, off), upd = _slot_write_args()

    def program(n_writes):
        g = TaskGraph("kv")
        ins = [g.add_input(f"p{i}", TensorType(tuple(pool.shape), "bfloat16"))
               for i in range(n_writes)]
        pi = g.add_input("phys", TensorType((4,), "int32"))
        oi = g.add_input("off", TensorType((4,), "int32"))
        ui = g.add_input("upd", TensorType((4, 2, 128), "bfloat16"))
        outs = [g.add("scatter", (b, pi, oi, ui), g.nodes[b].ttype,
                      pdims=(0, 1, 2, 3), donates=b, n_idx=2, mode="set")
                for b in ins]
        g.set_outputs(outs)
        fn = emit(run_pipeline(g, "tapir", CPU_COST_MODEL))
        inputs = {f"p{i}": pool.clone() for i in range(n_writes)}
        inputs.update(phys=phys, off=off, upd=upd)
        with _AtenOps() as mode:
            fn(inputs)
        return sum(mode.ops.values())

    one, two = program(1), program(2)
    assert two - one == 9
    assert one == 32
