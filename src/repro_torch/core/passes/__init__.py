"""Optimization pipeline over the Task IR.

Mirrors TapirXLA's split:

* ``mode="tapir"``   — expose library internals (inline), optimize the
  parallel graph (cse, fusion), then schedule *late* (strip-mining +
  small-task serialization in ``core.schedule``).
* ``mode="opaque"``  — the per-op control: early per-op heuristics, library
  calls sealed, no cross-op fusion.

The port runs on one device, so there is no ambient mesh: the mesh
fingerprint that keys every compiled program is the constant ``()`` and no
pass ever sees a model axis.
"""
from __future__ import annotations

import dataclasses

from ..ir import TaskGraph
from ..schedule import CostModel, assign_early_heuristics, assign_schedules
from .cse import cse
from .fusion import fuse_added_gemms, fuse_epilogues, fuse_shared_input
from .inline import expose_libraries, seal_libraries

#: structural identity of the (absent) mesh — part of every cache key
MESH_FINGERPRINT: tuple = ()


def optimize_graph(g: TaskGraph) -> TaskGraph:
    """The optimization half of the tapir pipeline (expose + CSE + fusion),
    without pruning or scheduling."""
    expose_libraries(g)
    cse(g)
    fuse_added_gemms(g)
    cse(g)
    # the concat form: one wide 2-D GEMM, which the hand-written kernel takes
    fuse_shared_input(g)
    fuse_epilogues(g)
    return g


def run_pipeline(g: TaskGraph, mode: str, cm: CostModel,
                 ablate_serialization: bool = False) -> TaskGraph:
    """Optimize and schedule ``g`` in place for ``mode``.  With
    ``ablate_serialization`` tapir mode schedules under a grain of 0 FLOPs
    (no small-task serialization; a cost model of its own name); opaque
    mode ignores it."""
    if mode == "opaque":
        seal_libraries(g)
        assign_early_heuristics(g, cm)
        g.prune()
        return g
    if mode != "tapir":
        raise ValueError(f"mode must be 'tapir' or 'opaque', got {mode!r}")
    optimize_graph(g)
    g.prune()
    if ablate_serialization:
        cm = dataclasses.replace(cm, name=cm.name + "+noserial",
                                 grain_flops=0.0)
    assign_schedules(g, cm)
    return g
