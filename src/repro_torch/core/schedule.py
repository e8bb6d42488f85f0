"""Late scheduling: bind fork-join parallelism to hardware AFTER optimization.

The port of the JAX package's ``core/schedule.py``.  ``CostModel`` carries
the target's constants; ``assign_schedules`` walks the *fused* graph, binds
each parallel dim (``grid`` / ``vector`` / ``serial``), records tiles, and
binds each library node's IMPLEMENTATION as the roofline argmin over the
candidates in ``IMPL_REGISTRY``.  ``core.lowering`` dispatches on
``node.schedule.impl`` alone.

Where the reference asked ``backend != "tpu"`` to rule a Pallas kernel out,
the port asks a capability question instead: is the op's Hopper kernel
ported (``PORTED_KERNELS``), and does the node have the shape the kernel
takes?  A kernel candidate never depends on the device: its wrapper runs
the kernel on a CUDA tensor and the kernel's plain version on a CPU tensor,
so the CPU tests run the very graph, impl and lowering the card runs.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np

from ..kernels.costs import SAFE_CHUNK, attention_cost, scan_cost
from ..kernels.fused_matmul.ops import matmul_cost
from ..kernels.linear_scan.kernel import MAX_DK as SCAN_MAX_DK
from .ir import LIBRARY_OPS, Node, TaskGraph, dtype_bytes


@dataclass(frozen=True)
class CostModel:
    """Target-hardware constants.  The hardware fields have no defaults:
    every target names its own (``H100_COST_MODEL``, ``CPU_COST_MODEL``)."""
    name: str
    peak_flops: float                   # bf16 FLOP/s per device
    hbm_bw: float                       # bytes/s per device
    vmem_bytes: int                     # on-chip scratch a kernel block may use
    mxu: int                            # matrix-unit tile edge
    # small-task serialization thresholds (the spawn-overhead analogue)
    grain_flops: float = 2.0 * 128 * 128 * 128
    grain_bytes: float = 1 << 20
    # GQA materialized attention: repeat K/V while the copy costs under this
    # fraction of the attention's compute
    gqa_repeat_frac: float = 0.25
    # per-serial-step dispatch overhead charged to blockwise/chunked impls
    spawn_s: float = 1e-6
    # host seconds to dispatch one lowered op from eager Python: a region
    # whose roofline is below its op count times this is dispatch-bound
    # (``dispatch_bound``) and replays as a CUDA graph
    dispatch_s: float = 5e-6
    # round-trips over the fp32 score matrix of impls that materialize it
    score_passes_materialized: float = 4.0
    score_passes_fused: float = 1.0
    # --- remat arm (the training step's forward/backward boundary) -------
    # storing a value across the boundary costs one write at the end of the
    # forward and one read in the backward (2 round trips); recomputing it
    # costs the node's operations plus re-reading its inputs, scaled by
    # ``remat_bias`` (> 1 biases toward storing: a recompute serializes
    # the backward, which a pure roofline undercounts)
    remat_store_roundtrips: float = 2.0
    remat_bias: float = 1.0


CPU_COST_MODEL = CostModel(name="cpu_host", peak_flops=5e10, hbm_bw=2e10,
                           vmem_bytes=1 << 21, mxu=8,
                           grain_flops=1 << 14, grain_bytes=1 << 16,
                           spawn_s=2e-5, score_passes_fused=4.0)

#: NVIDIA H100 SXM (data sheet, dense bf16; 227 KB of shared memory a
#: block may use).  A kernel launch from eager PyTorch costs a few
#: microseconds, and eager composites materialize their score matrices
#: like the CPU's do.  ``dispatch_s``: the host time of one small torch op
#: issued back to back from Python on an H100 SXM machine, read at 4.9 to
#: 15.3 us across runs (``chip_smoke.py``'s ``dispatch_host_us``, torch
#: 2.11, CUDA 12.8).  Between 5 and 15.3 us the rule moves three of the
#: full-width paths' regions only: qwen2.5-3b's 256-row slot prefill
#: (graphed above 5.4 us) and RWKV6-7B's padded-wave prefills of 2 x 176
#: (above 8.4) and 4 x 200 rows (above 15.3).
H100_COST_MODEL = CostModel(name="h100_sxm", peak_flops=989e12,
                            hbm_bw=3.35e12, vmem_bytes=232_448, mxu=16,
                            spawn_s=5e-6, score_passes_fused=4.0,
                            dispatch_s=9e-6)

#: library op -> the impl name of its lowering onto a hand-written Hopper
#: kernel (a convolution's is im2col and the GEMM kernel)
PORTED_KERNELS = {"matmul": "fused_kernel", "attention": "flash_kernel",
                  "linear_scan": "kernel", "conv2d": "im2col_gemm"}


def _align(x: int, m: int) -> int:
    return max(m, (x // m) * m) if x >= m else x


def pick_matmul_tiles(m: int, n: int, k: int, dtype: str, cm: CostModel) -> dict[str, int]:
    """Strip-mining for a GEMM: aligned (bm, bn, bk) whose working set
    (A-tile + B-tile + fp32 C-tile) fits a third of ``vmem_bytes``."""
    eb = dtype_bytes(dtype)
    budget = cm.vmem_bytes // 3
    bm = min(_align(m, cm.mxu), 512)
    bn = min(_align(n, cm.mxu), 512)
    bk = min(_align(k, cm.mxu), 2048)

    def footprint(bm, bn, bk):
        return eb * (bm * bk + bk * bn) + 4 * bm * bn

    while footprint(bm, bn, bk) > budget and bk > cm.mxu:
        bk //= 2
    while footprint(bm, bn, bk) > budget and (bm > cm.mxu or bn > cm.mxu):
        if bm >= bn and bm > cm.mxu:
            bm //= 2
        elif bn > cm.mxu:
            bn //= 2
        else:
            break
    return {"bm": min(bm, max(m, 1)), "bn": min(bn, max(n, 1)),
            "bk": min(bk, max(k, 1))}


def pick_attention_tiles(s_q: int, s_kv: int, d: int, dtype: str, cm: CostModel) -> dict[str, int]:
    """Flash-attention blocking: (block_q, block_kv) whose q/k/v tiles and
    running stats fit a quarter of ``vmem_bytes``.  Recorded in the
    schedule for ``explain()``; the Hopper kernel's tiles are fixed (64
    query rows by 64 keys), so a row's result never depends on them."""
    eb = dtype_bytes(dtype)
    budget = cm.vmem_bytes // 4
    bq = min(_align(s_q, cm.mxu), 512)
    bkv = min(_align(s_kv, cm.mxu), 1024)
    while eb * (bq * d + 2 * bkv * d) + 4 * bq * (bkv + d) > budget and bkv > cm.mxu:
        bkv //= 2
    while eb * (bq * d + 2 * bkv * d) + 4 * bq * (bkv + d) > budget and bq > cm.mxu:
        bq //= 2
    return {"bq": min(bq, max(s_q, 1)), "bkv": min(bkv, max(s_kv, 1))}


def pick_scan_chunk(seq: int, d_k: int, d_v: int, dtype: str,
                    cm: CostModel) -> int:
    """Linear-scan chunk: the largest chunk whose working set fits a
    quarter of ``vmem_bytes``, capped at ``SAFE_CHUNK``."""
    eb = dtype_bytes(dtype)
    budget = max(cm.vmem_bytes // 4 - 4 * d_k * d_v, cm.vmem_bytes // 32)
    c = SAFE_CHUNK
    while c > 1 and eb * c * (3 * d_k + d_v) + 4 * c * c > budget:
        c //= 2
    return max(1, min(c, max(seq, 1)))


def _dim_shard(node: Node, d: int, mesh_axes: Optional[dict]) -> int:
    """Mesh-axis product output dim ``d`` is split over (1 if unsharded)."""
    if not mesh_axes or node.sharding is None or d >= len(node.sharding):
        return 1
    entry = node.sharding[d]
    if entry is None:
        return 1
    f = 1
    for ax in (entry if isinstance(entry, tuple) else (entry,)):
        f *= mesh_axes.get(ax, 1)
    return f


def shard_factor(node: Node, mesh_axes: Optional[dict] = None) -> float:
    """How many blocks the whole of this node's value is split into: the
    product of the mesh-axis sizes its ``sharding`` annotation names.
    The reference divides a node's logical cost by it; under the port's
    explicit SPMD a rank traces its own block, so the node's shapes, and
    every cost computed from them (``pick_gqa_impl``, the registry), are
    per shard already, and this factor only relates them to the whole
    (``assign_schedules`` notes it).  The MoE expert FFN on a mesh is such
    a node: its GEMMs hold a rank's ``E / model`` experts (annotated on
    the expert dim by ``tapir._build_expert_mlp``), so they are costed at
    that block and noted as 1/model of the whole ``E``."""
    if not mesh_axes or node.sharding is None:
        return 1.0
    f = 1.0
    for d in range(len(node.sharding)):
        f *= _dim_shard(node, d, mesh_axes)
    return max(f, 1.0)


def pick_gqa_impl(node: Node, cm: CostModel) -> str:
    """GQA materialized attention: grouped einsum (no K/V copy) vs a K/V
    repeat to the full head count, by the same inequality the registry's
    repeat/grouped costs reduce to.  Per shard: on a mesh the node is the
    rank's block (its heads and rows), so the copy and the compute both
    count what this rank does (``shard_factor``)."""
    b, s, h, d = node.attrs["q_shape"]
    hkv = node.attrs.get("kv_heads", h)
    if not hkv or hkv >= h:
        return "grouped"
    grp = h // hkv
    eb = dtype_bytes(node.ttype.dtype)
    skv = node.attrs["kv_len"]
    copy_s = 2.0 * (grp - 1) * b * skv * hkv * d * eb / cm.hbm_bw
    compute_s = node.flops() / cm.peak_flops
    return "repeat" if copy_s <= cm.gqa_repeat_frac * compute_s else "grouped"


# ---------------------------------------------------------------------------
# Implementation registry
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ImplCandidate:
    """One candidate lowering of a library op: its roofline time, or
    ``None`` with a reason when it is unavailable for this node."""
    name: str
    cost_s: Optional[float]
    why: str = ""


def _fmt_s(t: float) -> str:
    return f"{t * 1e6:.1f}us" if t < 1e-3 else f"{t * 1e3:.2f}ms"


def _not_ported(op: str, impl: str) -> Optional[ImplCandidate]:
    if PORTED_KERNELS.get(op) != impl:
        return ImplCandidate(impl, None, "not ported yet")
    return None


def attention_candidates(g: TaskGraph, node: Node, cm: CostModel
                         ) -> list[ImplCandidate]:
    """``flash_kernel`` (the hand-written Hopper kernel: no score matrix in
    device memory, any ``Sq`` including decode's 1, no bias operand),
    ``blockwise`` (not ported yet), ``materialized_repeat`` /
    ``materialized_grouped`` (fp32 score matrix, K/V repeated or grouped)
    and ``ref`` (one composite expression).  The last three are plain
    composites: their lowering runs them on a CPU tensor and raises on a
    CUDA one."""
    b, sq, h, d = node.attrs["q_shape"]
    skv = node.attrs["kv_len"]
    hkv = node.attrs.get("kv_heads", h) or h
    grp = h // hkv
    eb = dtype_bytes(node.ttype.dtype)
    compute_s = node.flops() / cm.peak_flops

    def base(impl: str):
        c = attention_cost(b, sq, skv, h, hkv, d, eb, impl)
        return c, c["flops"] / cm.peak_flops + c["io_bytes"] / cm.hbm_bw

    flash = _not_ported("attention", "flash_kernel")
    if flash is None:
        if len(node.inputs) > 3:
            flash = ImplCandidate("flash_kernel", None,
                                  "kernel has no bias operand")
        else:
            flash = ImplCandidate("flash_kernel", base("flash_kernel")[1])
    out = [flash, ImplCandidate("blockwise", None, "not ported yet")]
    if grp <= 1:
        out.append(ImplCandidate("materialized_repeat", None,
                                 "no K/V head group to repeat"))
    else:
        c, t = base("materialized_repeat")
        t += c["score_bytes"] * cm.score_passes_materialized / cm.hbm_bw
        t += c["copy_bytes"] / cm.hbm_bw
        out.append(ImplCandidate("materialized_repeat", t))
    c, t = base("materialized_grouped")
    t += c["score_bytes"] * cm.score_passes_materialized / cm.hbm_bw
    if grp > 1:
        t += cm.gqa_repeat_frac * compute_s
    out.append(ImplCandidate("materialized_grouped", t))
    c, t = base("ref")
    t += c["score_bytes"] * cm.score_passes_fused / cm.hbm_bw
    if grp > 1:
        t += cm.gqa_repeat_frac * compute_s
    out.append(ImplCandidate("ref", t))
    return out


def matmul_candidates(g: TaskGraph, node: Node, cm: CostModel
                      ) -> list[ImplCandidate]:
    """``fused_kernel``, the hand-written GEMM with the epilogue applied on
    the resident output tile: the port's one route for a GEMM.  A 3-D
    weight ``[E, k, n]`` (the MoE expert FFN) is costed with E as a batch:
    E products of ``[m / E, k] @ [k, n]``, each expert's weight read once
    (the kernel's grouped route)."""
    shape = node.ttype.shape
    w_t = g.nodes[node.inputs[1]].ttype
    groups = w_t.shape[0] if len(w_t.shape) == 3 else 1
    m = int(np.prod(shape[:-1])) // groups
    c = matmul_cost(m, shape[-1], node.attrs["k"],
                    dtype_bytes(node.ttype.dtype), groups=groups)
    return [_not_ported("matmul", "fused_kernel")
            or ImplCandidate("fused_kernel", c["flops"] / cm.peak_flops
                             + c["io_bytes"] / cm.hbm_bw)]


def linear_scan_candidates(g: TaskGraph, node: Node, cm: CostModel
                           ) -> list[ImplCandidate]:
    """``kernel`` (the hand-written Hopper chunked scan: the chunk loop runs
    inside the kernel, no per-chunk dispatch) vs ``chunked`` (a Python loop
    over chunks: the factored-score FLOPs plus ``spawn_s`` per chunk) vs
    ``ref`` (the element recurrence: ``spawn_s`` per *timestep*).  The last
    two are plain composites: their lowering runs them on a CPU tensor and
    raises on a CUDA one."""
    seq = node.attrs["seq"]
    q_t = g.nodes[node.inputs[0]].ttype
    b, _, h, d_k = q_t.shape
    d_v = g.nodes[node.inputs[2]].ttype.shape[-1]
    eb = dtype_bytes(node.ttype.dtype)
    chunk = node.schedule.tile.get("chunk") or pick_scan_chunk(
        seq, d_k, d_v, node.ttype.dtype, cm)

    def roof(impl: str) -> float:
        c = scan_cost(b, seq, h, d_k, d_v, eb, impl, chunk=chunk)
        return (c["flops"] / cm.peak_flops + c["io_bytes"] / cm.hbm_bw
                + c["steps"] * cm.spawn_s)

    kern = _not_ported("linear_scan", "kernel")
    if kern is None:
        kern = (ImplCandidate("kernel", roof("kernel")) if d_k <= SCAN_MAX_DK
                else ImplCandidate("kernel", None,
                                   f"kernel takes Dk <= {SCAN_MAX_DK}"))
    return [kern, ImplCandidate("chunked", roof("chunked")),
            ImplCandidate("ref", roof("ref"))]


def conv2d_candidates(g: TaskGraph, node: Node, cm: CostModel
                      ) -> list[ImplCandidate]:
    """``im2col_gemm``, the one lowering: the ``[B*Ho*Wo, kh*kw*cin]``
    patch matrix built from the padded input (the input read once, the
    patches written and read once), then one launch of the GEMM kernel
    against the reshaped kernel with the node's epilogue.  The reference
    registers its one lowering (XLA's convolution) the same way."""
    x_t, k_t = (g.nodes[i].ttype for i in node.inputs[:2])
    kh, kw, cin, co = k_t.shape
    b, ho, wo, _ = node.ttype.shape
    m, k = b * ho * wo, kh * kw * cin
    eb = dtype_bytes(node.ttype.dtype)
    c = matmul_cost(m, co, k, eb)
    io = c["io_bytes"] + eb * (x_t.size + m * k)   # + input, patches
    return [_not_ported("conv2d", "im2col_gemm")
            or ImplCandidate("im2col_gemm", c["flops"] / cm.peak_flops
                             + io / cm.hbm_bw)]


# Candidate order is the tie-break: the argmin takes a strict ``<``, so on an
# exact tie the EARLIER candidate wins (kernel over plain).
IMPL_REGISTRY: dict[str, Callable] = {
    "matmul": matmul_candidates,
    "attention": attention_candidates,
    "linear_scan": linear_scan_candidates,
    "conv2d": conv2d_candidates,
}


def pick_impl(g: TaskGraph, node: Node, cm: CostModel) -> None:
    """Cost every registered candidate for this library node, record the
    table in ``schedule.impl_costs``, and bind the argmin to
    ``schedule.impl``."""
    if node.op not in IMPL_REGISTRY:
        raise NotImplementedError(f"no lowering of {node.op!r} is ported yet")
    cands = IMPL_REGISTRY[node.op](g, node, cm)
    node.schedule.impl_costs = {
        c.name: (c.cost_s if c.cost_s is not None else f"n/a ({c.why})")
        for c in cands}
    best = None
    for c in cands:
        if c.cost_s is not None and (best is None or c.cost_s < best.cost_s):
            best = c
    if best is None:
        raise NotImplementedError(
            f"no available impl for {node.op} node %{node.nid}: "
            f"{node.schedule.impl_costs}")
    node.schedule.impl = best.name
    n_avail = sum(1 for c in cands if c.cost_s is not None)
    note = (f"impl: {best.name} ({_fmt_s(best.cost_s)} roofline, argmin of "
            f"{n_avail}/{len(cands)} candidates)")
    if note not in node.schedule.notes:   # bound again on a joint graph
        node.schedule.notes.append(note)


def pick_remat(g: TaskGraph, node: Node, cm: CostModel,
               policy: str = "auto") -> str:
    """Recompute-vs-store for a forward node whose VJP the backward runs —
    the remat arm of the cost model.  ``policy`` is ``TrainConfig.remat``:

    * ``"auto"``: the roofline.  Storing costs ``remat_store_roundtrips``
      passes over the node's output bytes; recomputing costs its
      operations at peak plus re-reading its input bytes, times
      ``remat_bias``.  Elementwise composites (norms, RoPE, residual adds)
      recompute nearly for free; GEMM and attention outputs are cheaper
      to store.  The decision and both costs go in ``schedule.notes``;
    * ``"none"``: store everything; ``"full"``: recompute everything;
    * ``"dots"``: store library-op (GEMM-shaped) outputs only.

    Either choice gives the same bits (both run the same kernels); the
    decision moves memory and time, never numerics."""
    if policy == "none":
        return "store"
    if policy == "full":
        return "recompute"
    if policy == "dots":
        return "store" if node.op in LIBRARY_OPS else "recompute"
    if policy != "auto":
        raise ValueError(f"remat policy must be 'auto', 'none', 'full' or "
                         f"'dots', got {policy!r}")
    store_s = cm.remat_store_roundtrips * node.ttype.bytesize / cm.hbm_bw
    in_bytes = sum(g.nodes[i].ttype.bytesize for i in node.inputs
                   if i in g.nodes)
    recompute_s = cm.remat_bias * (node.flops() / cm.peak_flops
                                   + in_bytes / cm.hbm_bw)
    choice = "recompute" if recompute_s < store_s else "store"
    node.schedule.notes.append(
        f"remat: {choice} (store {store_s*1e6:.1f}us vs recompute "
        f"{recompute_s*1e6:.1f}us)")
    return choice


# ---------------------------------------------------------------------------
# Late scheduling (tapir mode)
# ---------------------------------------------------------------------------


def assign_schedules(g: TaskGraph, cm: CostModel) -> TaskGraph:
    """Bind schedules on the optimized graph: per parallel dim ``grid`` when
    the per-task work clears the grain, ``vector`` for a wide trailing dim,
    else ``serial``; library ops get tiles and their impl (``pick_impl``)."""
    cache_ops = ("dynamic_update_slice", "dynamic_slice", "index", "slice",
                 "gather", "scatter")
    from .passes import ambient_mesh
    mesh = ambient_mesh()
    mesh_axes = dict(mesh.shape) if mesh is not None else None
    for nid in g.topo_order():
        node = g.nodes[nid]
        if node.op in ("input", "const"):
            continue
        work = node.flops() + 1.0
        shape = node.ttype.shape
        moved = None
        if node.op in cache_ops:
            if node.op == "dynamic_update_slice":
                upd_t = g.nodes[node.inputs[1]].ttype
            elif node.op == "scatter":
                upd_t = g.nodes[node.inputs[-1]].ttype
            else:
                upd_t = None
            moved = node.bytes_moved(upd_t)
            node.schedule.notes.append(
                f"cache-op {moved:.0f}B moved"
                + (" in-place (buffer donated)" if node.donates is not None
                   else ""))
        grain = cm.grain_bytes if moved is not None else cm.grain_flops
        work = moved if moved is not None else work
        for d in node.pdims:
            if d in node.schedule.dim_binding:
                continue
            extent = shape[d] if d < len(shape) else 1
            per_task = work / max(extent, 1)
            if per_task >= grain:
                node.schedule.dim_binding[d] = "grid"
            elif d == len(shape) - 1 and extent >= 8:
                node.schedule.dim_binding[d] = "vector"
            else:
                node.schedule.dim_binding[d] = "serial"
                node.schedule.notes.append(
                    f"small-task serialized dim{d} (per-task {per_task:.0f} "
                    + ("bytes)" if moved is not None else "flops)"))
        if node.op == "matmul":
            m, n = shape[-2], shape[-1]
            node.schedule.tile = pick_matmul_tiles(m, n, node.attrs["k"],
                                                   node.ttype.dtype, cm)
        elif node.op == "attention":
            b, s, h, d_ = node.attrs["q_shape"]
            node.schedule.tile = pick_attention_tiles(
                s, node.attrs["kv_len"], d_, node.ttype.dtype, cm)
            node.attrs["gqa_impl"] = pick_gqa_impl(node, cm)
        elif node.op == "linear_scan":
            q_t = g.nodes[node.inputs[0]].ttype
            d_v = g.nodes[node.inputs[2]].ttype.shape[-1]
            node.schedule.tile = {"chunk": pick_scan_chunk(
                node.attrs["seq"], q_t.shape[-1], d_v, node.ttype.dtype, cm)}
        if node.op in LIBRARY_OPS:
            if node.attrs.get("exposed", False):
                pick_impl(g, node, cm)
            else:
                node.schedule.impl = "opaque"
            f = shard_factor(node, mesh_axes)
            if f > 1:
                node.schedule.notes.append(
                    f"per shard: 1/{f:g} of the whole ({node.sharding})")
        node.schedule.serialized = all(
            b == "serial" for b in node.schedule.dim_binding.values()) and bool(
            node.schedule.dim_binding)
    return g


_VIEW_OPS = ("reshape", "index", "slice")


def region_roofline_s(g: TaskGraph, cm: CostModel) -> float:
    """The least time the card could take for a scheduled region: per
    node, its bound impl's roofline cost where the registry costed one,
    else operations over peak plus bytes over bandwidth (a view moves
    nothing; a cache op moves its window)."""
    total = 0.0
    for node in g.nodes.values():
        if node.op in ("input", "const"):
            continue
        cost = node.schedule.impl_costs.get(node.schedule.impl)
        if isinstance(cost, float):
            total += cost
            continue
        if node.op in _VIEW_OPS:
            moved = 0.0
        elif node.op in ("dynamic_update_slice", "scatter"):
            upd = node.inputs[1] if node.op == "dynamic_update_slice" \
                else node.inputs[-1]
            moved = node.bytes_moved(g.nodes[upd].ttype)
        elif node.op in ("dynamic_slice", "gather"):
            moved = node.bytes_moved()
        else:
            moved = node.ttype.bytesize + sum(
                g.nodes[i].ttype.bytesize for i in set(node.inputs))
        total += node.flops() / cm.peak_flops + moved / cm.hbm_bw
    return total


def lowered_ops(g: TaskGraph) -> int:
    """The ops a region's emitted program dispatches: every node but its
    inputs and constants (constants are built once per program)."""
    return sum(1 for n in g.nodes.values() if n.op not in ("input", "const"))


def dispatch_bound(g: TaskGraph, cm: CostModel) -> bool:
    """Whether dispatching a scheduled region from the host takes longer
    than the card needs for it: its roofline time below its lowered op
    count times ``cm.dispatch_s``.  Such a region replays as one CUDA
    graph (``core.graphs``); a device-bound one runs eagerly, and keeps
    no graph pool of its activations."""
    return region_roofline_s(g, cm) < lowered_ops(g) * cm.dispatch_s


def assign_early_heuristics(g: TaskGraph, cm: CostModel) -> TaskGraph:
    """The per-op control: each op partitioned in isolation before
    optimization, outermost dim parallel, no epilogue awareness, no kernel."""
    for node in g.nodes.values():
        if node.op in ("input", "const"):
            continue
        for d in node.pdims:
            node.schedule.dim_binding[d] = "grid" if d == 0 else "serial"
        if node.op in ("matmul", "attention", "conv2d"):
            node.schedule.tile = {"bm": 256, "bn": 256, "bk": 256}
        if node.op in LIBRARY_OPS:
            node.schedule.impl = "opaque"
        node.schedule.notes.append("early-heuristic (opaque mode)")
    return g
