"""Common-subexpression elimination over the task graph.

Because parallelism is *structural* (pdims/rdims on nodes) rather than
opaque runtime calls, CSE applies to parallel ops exactly as to serial ones —
the property TapirXLA gets from Tapir and stock XLA loses at the LLVM level."""
from __future__ import annotations

from ..ir import TaskGraph


def cse(g: TaskGraph) -> int:
    """Hash-cons nodes in topological order; returns #nodes eliminated.

    Sharding-aware: ``Node.key()`` includes the ``sharding`` annotation,
    so two structurally identical nodes unify only when their constraints
    are compatible (equal, including both-unconstrained).  Merging a
    ``("model",)``-constrained value with a replicated or differently-
    constrained twin would silently drop one layout and force GSPMD to
    pick — the constraint exists precisely to stop that."""
    seen: dict[tuple, int] = {}
    eliminated = 0
    for nid in g.topo_order():
        node = g.nodes[nid]
        if node.op == "input" or node.epilogue:
            continue
        if node.donates is not None or node.op == "scatter":
            # in-place buffer write: hash-consing two writes would collapse
            # distinct buffer states (and double-donate one input) — each
            # write is its own event, never CSE'd.  Scatter is skipped even
            # when non-donating (data-dependent write: keep every event
            # distinct rather than reason about index-operand equality).
            continue
        key = node.key()
        if key in seen and seen[key] != nid:
            g.replace_uses(nid, seen[key])
            eliminated += 1
        else:
            seen[key] = nid
    if eliminated:
        g.prune()
    return eliminated
