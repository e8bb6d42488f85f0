"""Logical-axis -> mesh-axis sharding rules — the port of the JAX
package's ``dist/sharding.py``, for explicit SPMD over process groups.

Models annotate parameters and activations with *logical* axis names
("vocab", "heads", "batch", ...).  This module owns the single mapping
from those names to mesh axes, so a strategy (TP vs FSDP+TP) is a rule
change, not a model change.  Every lookup is divisibility-checked against
the dim's size and each mesh axis is used at most once per tensor: an
unshardable dim stays replicated, which keeps all of it one-device safe.

The specs are plain tuples (a mesh axis name, a tuple of names, or None
per dim), the reference's ``PartitionSpec`` contents.  Under explicit
SPMD a rank holds the block of each sharded dim its mesh coordinates
select: ``local_block`` cuts that block out of a full tensor, the same
slice for every rank of a replicated axis.

The ambient mesh (``use_mesh``) is the one the region compiler keys its
programs on (``core.passes.mesh_fingerprint``) and the one ``shard_act``
and the lowering's collectives resolve against.
"""
from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass
from typing import Any, Optional, Sequence

import torch

# logical axis -> mesh axis (None = replicated).  "batch" is special-cased:
# it shards over the data-parallel axes (pod, data).
_RULES: dict[str, Optional[str]] = {
    "vocab": "model",
    "heads": "model",
    "kv": "model",
    "mlp": "model",
    "expert": "model",
    "kvseq": "model",   # decode KV-cache sequence dim (flash-decode split)
    "embed": None,      # fsdp strategies override to "data" per-param
    "layers": None,
    "seq": None,        # sequence parallelism: configure_rules(seq="model")
}


def configure_rules(**kwargs) -> dict:
    """Update rules; returns the previous values of the touched keys so
    callers can restore with ``configure_rules(**prev)``."""
    prev = {k: _RULES.get(k) for k in kwargs}
    _RULES.update(kwargs)
    return prev


_ambient = threading.local()


def current_mesh():
    """The ambient mesh (``use_mesh``), else None."""
    return getattr(_ambient, "mesh", None)


@contextlib.contextmanager
def use_mesh(mesh):
    """Make ``mesh`` ambient for the block (None: no mesh)."""
    prev = getattr(_ambient, "mesh", None)
    _ambient.mesh = mesh
    try:
        yield mesh
    finally:
        _ambient.mesh = prev


def _axes_size(mesh, axes: Sequence[str]) -> int:
    n = 1
    for a in axes:
        n *= int(mesh.shape[a])
    return n


def logical_to_pspec(axes: Sequence[Optional[str]], mesh,
                     shape: Optional[tuple] = None) -> tuple:
    """Map logical axis names to a spec tuple for ``mesh``.

    Guards: a mesh axis is used at most once per tensor (first logical axis
    wins, later ones stay replicated), and when ``shape`` is given a dim is
    only sharded if its size divides evenly."""
    used: set[str] = set()
    spec: list = []
    for i, ax in enumerate(axes):
        entry = None
        if ax == "batch":
            data_axes = [a for a in ("pod", "data")
                         if a in mesh.axis_names and a not in used]
            if shape is not None:
                while data_axes and shape[i] % _axes_size(mesh, data_axes) != 0:
                    data_axes.pop(0)   # drop pod first, then data
            if len(data_axes) == 1:
                entry = data_axes[0]
            elif data_axes:
                entry = tuple(data_axes)
        elif ax is not None:
            phys = _RULES.get(ax)
            if (phys and phys in mesh.axis_names and phys not in used
                    and (shape is None or shape[i] % mesh.shape[phys] == 0)):
                entry = phys
        if entry is not None:
            used.update(entry if isinstance(entry, tuple) else (entry,))
        spec.append(entry)
    return tuple(spec)


def batch_pspec(mesh, ndim: int = 2, batch_size: Optional[int] = None) -> tuple:
    """Spec for a batch-leading tensor: dim 0 over every data axis whose
    product divides ``batch_size`` (pod dropped first), dim 1 over the
    sequence-parallel axis when ``configure_rules(seq=...)`` is on."""
    data_axes = [a for a in ("pod", "data") if a in mesh.axis_names]
    if batch_size is not None:
        while data_axes and batch_size % _axes_size(mesh, data_axes) != 0:
            data_axes.pop(0)
    if not data_axes:
        first = None
    elif len(data_axes) == 1:
        first = data_axes[0]
    else:
        first = tuple(data_axes)
    spec: list = [first] + [None] * (max(ndim, 1) - 1)
    seq_ax = _RULES.get("seq")
    if ndim >= 2 and seq_ax and seq_ax in mesh.axis_names:
        in_first = first == seq_ax or (isinstance(first, tuple) and seq_ax in first)
        if not in_first:
            spec[1] = seq_ax
    return tuple(spec)


@dataclass(frozen=True)
class NamedSharding:
    """A spec tuple on a mesh: the layout a tensor is (to be) held in,
    as the reference's ``jax.sharding.NamedSharding`` names it."""
    mesh: Any
    spec: tuple


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(e is None or isinstance(e, str)
                                        for e in x)


def tree_map_axes(fn, axes_tree, *trees):
    """``fn(axes, *leaves)`` over parallel trees whose axes leaves are
    tuples of logical names (dicts, lists and ``("dense", p)`` markers
    recurse; a non-tensor leaf passes through ``fn`` too)."""
    if _is_axes(axes_tree):
        return fn(axes_tree, *trees)
    if isinstance(axes_tree, dict):
        return {k: tree_map_axes(fn, axes_tree[k], *[t[k] for t in trees])
                for k in axes_tree}
    if isinstance(axes_tree, (list, tuple)):
        return type(axes_tree)(tree_map_axes(fn, a, *[t[i] for t in trees])
                               for i, a in enumerate(axes_tree))
    return trees[-1] if trees else axes_tree


def param_shardings(axes_tree, shape_tree, mesh, strategy: str = "fsdp_tp"):
    """Spec tree for parameters (``shape_tree``: a tree of shapes or
    tensors parallel to ``axes_tree``).

    ``strategy="tp"``: tensor-parallel axes only (heads/kv/mlp/vocab/expert
    -> model).  ``strategy="fsdp_tp"``: additionally shard the "embed"
    (d_model) axis over the data axis, FSDP-style."""
    fsdp = "fsdp" in strategy

    def one(axes, sds):
        shape = tuple(getattr(sds, "shape", sds))
        used: set[str] = set()
        spec: list = []
        for i, ax in enumerate(axes):
            entry = None
            if ax is not None and ax != "batch":
                phys = _RULES.get(ax)
                if fsdp and ax == "embed":
                    phys = "data"
                if (phys and phys in mesh.axis_names and phys not in used
                        and shape[i] % mesh.shape[phys] == 0):
                    entry = phys
                    used.add(phys)
            spec.append(entry)
        return tuple(spec)

    return tree_map_axes(one, axes_tree, shape_tree)


def spec_axes(entry) -> tuple:
    """The mesh axes one spec entry names, outermost first."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def block_index(mesh, entry) -> tuple[int, int]:
    """(this rank's block index, number of blocks) of a dim sharded by
    ``entry`` (a row-major index over the named axes)."""
    idx, n = 0, 1
    for a in spec_axes(entry):
        size = int(mesh.shape[a])
        idx = idx * size + mesh.coord(a)
        n *= size
    return idx, n


def local_block(t: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """This rank's block of the full tensor ``t`` under ``spec`` (a view;
    replicated dims whole)."""
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        i, n = block_index(mesh, entry)
        if t.shape[d] % n:
            raise ValueError(f"dim {d} of {tuple(t.shape)} does not split "
                             f"into {n} blocks")
        size = t.shape[d] // n
        t = t.narrow(d, i * size, size)
    return t


def global_shape(shape: tuple, spec: Optional[tuple], mesh) -> tuple:
    """The full shape of a block of ``shape`` held under ``spec``."""
    if not spec:
        return tuple(shape)
    return tuple(s * block_index(mesh, e)[1] if e is not None else s
                 for s, e in zip(shape, tuple(spec) + (None,) * len(shape)))



def effective(spec: Optional[tuple], mesh) -> Optional[tuple]:
    """``spec`` without the axes of size 1 (they split nothing); None when
    nothing is left."""
    if spec is None:
        return None
    out = []
    for e in spec:
        axes = tuple(a for a in spec_axes(e) if int(mesh.shape[a]) > 1)
        out.append(None if not axes else axes[0] if len(axes) == 1 else axes)
    return tuple(out) if any(e is not None for e in out) else None


def local_shape(gshape: tuple, spec: Optional[tuple], mesh) -> tuple:
    """The block shape a rank holds of ``gshape`` under ``spec``."""
    if not spec:
        return tuple(gshape)
    return tuple(s // block_index(mesh, e)[1] if e is not None else s
                 for s, e in zip(gshape, tuple(spec) + (None,) * len(gshape)))


def reshard_tensor(t: torch.Tensor, src: Optional[tuple],
                   dst: Optional[tuple], mesh) -> torch.Tensor:
    """Move a rank's block ``t`` (held under ``src``) to its block under
    ``dst``: per dim, an all-gather in rank order over the axes ``src``
    names and ``dst`` does not, then this rank's slice where ``dst`` names
    an axis.  No sum is ever taken across ranks, so every element keeps
    its bits."""
    if mesh is None:
        raise RuntimeError("a resharded value needs the ambient mesh")
    nd = t.ndim
    src = tuple(src or ()) + (None,) * (nd - len(src or ()))
    dst = tuple(dst or ()) + (None,) * (nd - len(dst or ()))
    for d in range(nd):
        if src[d] == dst[d]:
            continue
        # innermost axis first: the row-major block order over the axes
        for a in reversed(spec_axes(src[d])):
            t = mesh.all_gather(t, a, d)
    for d in range(nd):
        if src[d] != dst[d] and dst[d] is not None:
            i, n = block_index(mesh, dst[d])
            size = t.shape[d] // n
            t = t.narrow(d, i * size, size)
    return t


_sizes = threading.local()


@contextlib.contextmanager
def logical_sizes(**sizes):
    """The global sizes of logical axes ("batch", "heads", "kv", "mlp",
    "vocab") for the block: ``shard_act`` reads a value's layout off them
    where no annotation recorded it (a rank's activations are its blocks,
    so their shapes alone cannot tell a block from a whole)."""
    prev = getattr(_sizes, "d", {})
    _sizes.d = {**prev, **sizes}
    try:
        yield
    finally:
        _sizes.d = prev


def current_sizes() -> dict:
    return getattr(_sizes, "d", {})


def tp_last_dim_spec(axes: Sequence[Optional[str]], shape: tuple,
                     mesh) -> tuple:
    """The serving placement of a weight (the reference's
    ``pin_slot_params`` rule): only its LAST dim shards, and only over
    ``model``, when its logical axis maps there and divides.  The GEMM N
    dims (wq / wk / wv / wg / wu / the head: column sharding, every output
    element summed on one rank) shard; K-dim weights (wo, wd) and the rest
    stay replicated: a K split would add partial sums across ranks."""
    if not axes:
        return ()
    last = (None,) * (len(axes) - 1) + (axes[-1],)
    spec = logical_to_pspec(last, mesh, shape=tuple(shape))
    return tuple(s if s == "model" else None for s in spec)


def weight_spec(axes: Sequence[Optional[str]], shape: tuple, mesh) -> tuple:
    """The placement of a weight on ``mesh``, one rule for the forward and
    slot serving.  An expert leaf (a dim with logical axis ``"expert"``:
    ``ewg`` / ``ewu [E, d, ff]``, ``ewd [E, ff, d]``, stacked ``[L, E,
    ...]``) shards that dim over ``model`` when it divides ``E`` and
    nothing else, so every expert stays whole on one rank and no product
    is split over K; where ``E`` does not divide, it stays whole on every
    rank.  Any other leaf takes ``tp_last_dim_spec``.  (The reference's
    serving rule column-shards the expert leaves over ``d_ff`` instead;
    the port follows its expert-parallel dispatch, whose activations
    shard on ``"expert"``, and keeps one copy.)"""
    if "expert" not in axes:
        return tp_last_dim_spec(axes, shape, mesh)
    only = tuple(a if a == "expert" else None for a in axes)
    spec = logical_to_pspec(only, mesh, shape=tuple(shape))
    return tuple(s if s == "model" else None for s in spec)


def gather_full(t: torch.Tensor, mesh) -> torch.Tensor:
    """The whole tensor of a rank's block ``t`` (its recorded layout,
    all-gathered in rank order); ``t`` itself when it is whole."""
    from ..core.tapir import SPEC_ATTR
    spec = getattr(t, SPEC_ATTR, None)
    if mesh is None or spec is None:
        return t
    return reshard_tensor(t, spec, None, mesh)


def place(t: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """This rank's block of ``t`` under ``spec`` as a tensor of its own
    (the full one can be freed), carrying its layout."""
    from ..core.tapir import SPEC_ATTR
    out = local_block(t, spec, mesh)
    if out.data_ptr() == t.data_ptr() and out.shape == t.shape:
        out = t
    else:
        out = out.clone(memory_format=torch.contiguous_format)
    spec = effective(spec, mesh)
    if spec is not None:
        setattr(out, SPEC_ATTR, spec)
    return out
