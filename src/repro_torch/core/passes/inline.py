"""Library exposure — the analogue of linking Tapir bitcode for Eigen routines.

A *sealed* library op is an opaque call: the optimizer may not change its
implementation or fold surrounding computation into it (stock XLA's Eigen
calls).  An *exposed* op's implementation (tiling structure + open epilogue
slots) is visible, so ``fusion.fuse_epilogues`` may extend it and
``schedule`` may re-tile it in context.

Exposure flips only the ``exposed`` attr in place — the node keeps
producing the same value, so its ``sharding`` annotation (and every other
field) rides along untouched; the merge/propagation rules live in the
passes that actually rewrite nodes (``cse``, ``fusion``)."""
from __future__ import annotations

from ..ir import LIBRARY_OPS, TaskGraph


def expose_libraries(g: TaskGraph) -> int:
    n = 0
    for node in g.nodes.values():
        if node.op in LIBRARY_OPS:
            node.attrs["exposed"] = True
            n += 1
    return n


def seal_libraries(g: TaskGraph) -> int:
    n = 0
    for node in g.nodes.values():
        if node.op in LIBRARY_OPS:
            node.attrs["exposed"] = False
            n += 1
    return n
