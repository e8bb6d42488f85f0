"""Parallel-loop fusion on the task graph.

Three rewrites, all classic fork-join loop transforms that stock XLA cannot
perform across its opaque library-call boundaries:

* ``fuse_added_gemms``   — ``x@W1 + h@W2  ->  concat(x,h) @ concat(W1;W2)``
  (two parallel loops over the same output space joined by an add: fuse the
  reduction dimension).  This is what turns an 8-GEMM LSTM cell into one GEMM.
* ``fuse_shared_input``  — k GEMMs reading the same activation ->
  one GEMM over column-concatenated weights + slices (QKV fusion).
* ``fuse_epilogues``     — fold single-consumer elementwise chains into the
  open epilogue slot of an *exposed* library op (bias/activation/residual
  folded into the GEMM/attention/scan kernel).
"""
from __future__ import annotations

from ..ir import TaskGraph, TensorType

EPILOGUE_FNS = frozenset({
    "add", "sub", "mul", "div", "gelu", "relu", "silu", "sigmoid", "tanh",
    "exp", "maximum", "minimum", "square", "neg",
})

_FUSABLE = ("matmul", "conv2d", "attention", "linear_scan")


def _depends_on(g: TaskGraph, src: int, target: int) -> bool:
    """True if ``src`` transitively reads ``target``."""
    stack, seen = [src], set()
    while stack:
        nid = stack.pop()
        if nid == target:
            return True
        if nid in seen:
            continue
        seen.add(nid)
        n = g.nodes[nid]
        stack.extend(n.inputs)
        stack.extend(n.anti)
        for _, extra, _ in n.epilogue:
            stack.extend(extra)
    return False


def _is_plain_gemm(g: TaskGraph, nid: int) -> bool:
    n = g.nodes[nid]
    return (n.op == "matmul" and not n.epilogue and n.attrs.get("exposed", False)
            and len(g.nodes[n.inputs[1]].ttype.shape) == 2)


def fuse_added_gemms(g: TaskGraph) -> int:
    """add(matmul(x,W1), matmul(h,W2)) -> matmul(concat(x,h), concat(W1;W2)),
    rewriting until no target is left (a stack unrolled into one region,
    as the captured training step's is, has one in every layer)."""
    fused = 0
    while True:
        cons = g.consumers()
        target = None
        for nid in g.topo_order():
            n = g.nodes[nid]
            if (n.op == "ew" and n.attrs.get("fn") == "add" and len(n.inputs) == 2
                    and all(_is_plain_gemm(g, i) for i in n.inputs)
                    and all(len(cons[i]) == 1 and i not in g.outputs for i in n.inputs)
                    # a constrained member GEMM would VANISH into the fused
                    # node and its sharding with it — refuse, like CSE, rather
                    # than silently drop a constraint (the add's own
                    # constraint is propagated below; the members' have no
                    # corresponding value after the rewrite)
                    and all(g.nodes[i].sharding is None for i in n.inputs)):
                a, b = (g.nodes[i] for i in n.inputs)
                xa, wa = a.inputs
                xb, wb = b.inputs
                if (a.ttype == b.ttype == n.ttype
                        and g.nodes[xa].ttype.shape[:-1] == g.nodes[xb].ttype.shape[:-1]
                        and g.nodes[xa].ttype.dtype == g.nodes[xb].ttype.dtype):
                    target = (nid, a, b, xa, wa, xb, wb)
                    break
        if target is None:
            return fused
        nid, a, b, xa, wa, xb, wb = target
        add_sharding = g.nodes[nid].sharding
        ka, kb = a.attrs["k"], b.attrs["k"]
        x_t = g.nodes[xa].ttype
        xc_t = TensorType(x_t.shape[:-1] + (ka + kb,), x_t.dtype)
        xc = g.add("concat", (xa, xb), xc_t, pdims=tuple(range(len(xc_t.shape))),
                   axis=-1)
        w_t = g.nodes[wa].ttype
        wc_t = TensorType((ka + kb, w_t.shape[1]), w_t.dtype)
        wc = g.add("concat", (wa, wb), wc_t, pdims=(0, 1), axis=0)
        # the fused GEMM takes over producing the add's value, so it
        # inherits the add's sharding constraint (same output space)
        mm = g.add("matmul", (xc, wc), a.ttype,
                   pdims=tuple(range(len(a.ttype.shape))),
                   rdims=(("k", ka + kb),), k=ka + kb, exposed=True,
                   sharding=add_sharding)
        g.replace_uses(nid, mm)
        g.prune()
        fused += 1


def fuse_shared_input(g: TaskGraph) -> int:
    """k exposed GEMMs on the same input -> ONE fused GEMM (QKV fusion):
    the weights column-concat to one wide 2-D ``[k, sum_w]`` GEMM, whose
    output is sliced back into the members' values.

    Members come from one scope: GEMMs of two inlined region calls (the
    cross-attention K|V of every decoder layer on one encoder output,
    when the captured training step unrolls the stack) stay apart, as the
    per-op step runs them, each call its own program.  Fused, one dX would
    sum every layer's contribution inside the kernel, where the per-op
    step adds the layers' dX in autograd's order: other bits.

    Fixpoint iteration: groups are recomputed after every rewrite so nids
    never go stale."""
    fused = 0
    while True:
        groups: dict[tuple, list[int]] = {}
        for nid in g.topo_order():
            n = g.nodes[nid]
            if _is_plain_gemm(g, nid):
                key = (n.inputs[0], n.attrs["k"], n.ttype.dtype,
                       n.ttype.shape[:-1], g.scopes.get(nid))
                groups.setdefault(key, []).append(nid)
        target = next(((k, v) for k, v in groups.items() if len(v) >= 2), None)
        if target is None:
            return fused
        (x, k, dtype, lead, scope), members = target
        w_nodes = [g.nodes[m].inputs[1] for m in members]
        wdt = g.nodes[w_nodes[0]].ttype.dtype
        widths = [g.nodes[m].ttype.shape[-1] for m in members]
        wc_t = TensorType((k, sum(widths)), wdt)
        wc = g.add("concat", tuple(w_nodes), wc_t, pdims=(0, 1), axis=1)
        out_t = TensorType(lead + (sum(widths),), dtype)
        mm = g.add("matmul", (x, wc), out_t,
                   pdims=tuple(range(len(out_t.shape))),
                   rdims=(("k", k),), k=k, exposed=True)
        if scope is not None:
            g.scopes[mm] = scope
        off = 0
        for m, w in zip(members, widths):
            sl = g.add("slice", (mm,), g.nodes[m].ttype,
                       pdims=tuple(range(len(out_t.shape))),
                       axis=-1, start=off, limit=off + w,
                       sharding=g.nodes[m].sharding)
            g.replace_uses(m, sl)
            off += w
        g.prune()
        fused += 1


def fuse_epilogues(g: TaskGraph) -> int:
    """Fold elementwise tails into exposed library ops' epilogue slots.

    Worklist formulation: each exposed library op greedily swallows its
    single-consumer elementwise chain, with the consumer index updated
    incrementally — no full graph rescan per fold.  This is what lets the
    pass scale to 500+-node region graphs (the old version restarted a
    topo scan after every fold, O(V) per fold → O(V²) per region)."""
    folded = 0
    work = [nid for nid in g.topo_order()
            if g.nodes[nid].op in _FUSABLE
            and g.nodes[nid].attrs.get("exposed", False)]
    for nid in work:
        if nid not in g.nodes:
            continue
        n = g.nodes[nid]
        while True:
            if nid in g.outputs:
                break
            users = g.consumers_of(nid)
            if len(users) != 1:
                break
            c = g.nodes[users[0]]
            if c.op != "ew" or c.attrs.get("fn") not in EPILOGUE_FNS:
                break
            if c.ttype.shape != n.ttype.shape:
                break
            head_pos = c.inputs.index(nid)
            extras = tuple(i for j, i in enumerate(c.inputs) if j != head_pos)
            if nid in extras:  # op used twice by the same consumer
                break
            if any(_depends_on(g, e, nid) for e in extras):
                break  # folding would create a cycle through the epilogue
            g.add_epilogue(nid, c.attrs["fn"], extras,
                           {"head_pos": head_pos, "dtype": c.ttype.dtype})
            g.replace_uses(c.nid, nid)
            n.ttype = TensorType(n.ttype.shape, c.ttype.dtype)
            # the library op now produces the consumer's value: its
            # constraint (if any) propagates to the fused node; the head's
            # own pre-epilogue constraint no longer names a materialized
            # value and is superseded
            if c.sharding is not None:
                n.sharding = c.sharding
            g.remove_node(c.nid)
            folded += 1
    if folded:
        g.prune()
    return folded
