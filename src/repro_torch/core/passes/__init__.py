"""Optimization pipeline over the Task IR.

Mirrors TapirXLA's split:

* ``mode="tapir"``   — expose library internals (inline), optimize the
  parallel graph (cse, fusion), then schedule *late* (strip-mining +
  small-task serialization in ``core.schedule``).
* ``mode="opaque"``  — the per-op control: early per-op heuristics, library
  calls sealed, no cross-op fusion.

The ambient mesh (``dist.sharding.use_mesh``) keys every compiled program
through ``mesh_fingerprint()``.  No pass changes under a mesh: a rank
traces its own blocks, so the shared-input fusion concatenates the rank's
column blocks (``[wq_r | wk_r | wv_r]``), and the GEMM's split is a
function of k alone, so each column keeps the bits it has on one device.
"""
from __future__ import annotations

import dataclasses

from ...dist.sharding import current_mesh
from ..ir import TaskGraph
from ..schedule import CostModel, assign_early_heuristics, assign_schedules
from .cse import cse
from .fusion import fuse_added_gemms, fuse_epilogues, fuse_shared_input
from .inline import expose_libraries, seal_libraries

#: the ambient mesh, or None (``dist.sharding.use_mesh``)
ambient_mesh = current_mesh


def mesh_has_model_axis() -> bool:
    """True when an ambient mesh with a "model" axis is active: a rank may
    hold a block of a contraction, which a GEMM then gathers
    (``tapir._k_operand``)."""
    m = ambient_mesh()
    return m is not None and "model" in m.axis_names


def mesh_fingerprint() -> tuple:
    """Structural identity of the ambient mesh: ``((axis, size), ...)``, or
    ``()`` with none.  Part of every compile-cache key: a program lowered
    for one mesh holds collectives and block shapes of that mesh, and must
    never replay under another."""
    m = ambient_mesh()
    return () if m is None else m.fingerprint


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
