"""Distribution layer of the port: logical-axis sharding rules
(``sharding.py``), activation layouts (``shard_act``), and the
fault-tolerant training loop, the straggler watchdog and deterministic
fault injection (``fault.py``).

The mesh is explicit SPMD: one process per mesh position, each holding
its blocks of the tensors (``launch/mesh.py``).  Everything here is
one-device safe: with no mesh active, or a one-rank mesh, every function
is the identity, so the single-device paths keep every bit.

``shard_act(x, *logical_axes)`` is the model-side entry point: it states
the layout of activation ``x`` by logical axis names ("batch", "heads",
...), mapped to mesh axes by the rules in :mod:`.sharding`.  Inside an
open region the layout is recorded as the ``sharding`` annotation of the
producing node (``tapir.annotate_sharding``) — or, where ``x`` is held in
another layout, a ``reshard`` node the lowering runs as this rank's slice
or a rank-order all-gather; on a concrete tensor it is applied now.
"""
from .fault import (Fault, FaultInjector, FaultTolerantLoop, LoopStats,
                    ScriptedFaultInjector, StragglerWatchdog)
from .sharding import (batch_pspec, configure_rules, current_mesh,
                       logical_sizes, logical_to_pspec, param_shardings,
                       use_mesh)

__all__ = ["Fault", "FaultInjector", "FaultTolerantLoop", "LoopStats",
           "ScriptedFaultInjector", "StragglerWatchdog", "batch_pspec",
           "configure_rules", "current_mesh", "logical_sizes",
           "logical_to_pspec", "param_shardings", "shard_act", "use_mesh"]


def shard_act(x, *logical_axes):
    """Hold activation ``x`` in the layout its logical axes give under the
    ambient mesh.

    Identity with no mesh or a one-rank mesh.  ``x``'s current layout is
    its recorded one (a previous ``shard_act``, a region output, a pinned
    or placed tensor), else read off the sizes of ``logical_sizes``: a dim
    smaller than its logical axis's global size is this rank's block of
    it.  Where the two layouts agree the spec is only recorded; where they
    differ, ``x`` is resharded (a slice, or an all-gather in rank order —
    never a sum)."""
    from .sharding import (effective, global_shape, current_sizes,
                           block_index)
    mesh = current_mesh()
    if mesh is None or mesh.size <= 1:
        return x
    from ..core import tapir
    shape = tuple(x.shape)
    if len(logical_axes) != len(shape):
        raise ValueError(f"shard_act: {len(logical_axes)} axes for a "
                         f"{len(shape)}-D value")
    src = tapir.layout_of(x)
    if src is not None:
        dst = logical_to_pspec(logical_axes, mesh,
                               shape=global_shape(shape, src, mesh))
    else:
        sizes = current_sizes()
        gshape = tuple(sizes.get(ax, s) if ax is not None else s
                       for ax, s in zip(logical_axes, shape))
        dst = logical_to_pspec(logical_axes, mesh, shape=gshape)
        src = []
        for d, (s, g) in enumerate(zip(shape, gshape)):
            if s == g:
                src.append(None)
            elif dst[d] is not None and s * block_index(mesh, dst[d])[1] == g:
                src.append(dst[d])
            else:
                raise ValueError(
                    f"shard_act: dim {d} holds {s} of {logical_axes[d]!r} "
                    f"(global {g}) under mesh {mesh.shape}")
        src = tuple(src)
    return tapir.reshard(x, effective(src, mesh), effective(dst, mesh), dst)
