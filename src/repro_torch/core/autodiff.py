"""Reverse-mode autodiff over a captured region graph — the port of the JAX
package's ``core/autodiff.py``.

The backward is not handed to ``torch.autograd`` as one opaque call: it is
derived *as a TaskGraph*, one VJP node (or a native transpose node) per
forward node, so the joint forward + backward graph goes through the same
CSE, fusion and late-scheduling passes as any region, and recompute versus
store is a schedule decision (``core.schedule.pick_remat``).

Bitwise contract with the per-op step (``train/step.py``, which runs
``torch.autograd.grad`` over the same region programs):

* the backward is derived over the graph AFTER ``passes.optimize_graph``
  (tapir mode), the fused forms the per-op step's region programs run
  (the fused QKV GEMM, the residual epilogues);
* the generic rule IS ``torch.autograd.grad`` of the node's own lowering
  (``lowering.node_callable``) with respect to the float operands that
  need a gradient: the same backward autograd runs for that node — the
  GEMM's dX / dW routes (``FusedMatmulFn``), the flash backward
  (``FlashAttentionFn``), the scan backward (``LinearScanFn``), or the
  torch ops of a lifted composite.  Library schedules are resolved at
  derivation time by the argmin the pipeline binds, so a replay runs the
  impl the forward ran;
* cotangent fan-in accumulates pairwise in reverse topological order, the
  order autograd's engine (highest sequence number first) adds a value's
  contributions in.  Autograd adds every use of a value into one buffer:
  a node that reads an operand twice inside (a norm reads ``x`` for its
  mean and its scale) adds each use to the sum of the later consumers',
  not one pre-summed contribution.  So a VJP node takes the operand's
  running cotangent and seeds its autograd call with it (``_Seed``, run
  first), and returns the new running sum;
* a tuple-returning composite (``tapir.lift`` records one node per
  element of ONE call) gets ONE VJP, over every element's cotangent at
  once, as autograd differentiates the call's graph once: a value inside
  the call read by two elements (Mamba2's ``dtv`` feeds both the decay
  and the scaled B) sums its cotangents before the ops that made it.
  A VJP per element would run those ops once per element and add the
  results after them, a different rounding.

Remat: under ``store`` the forward node runs under grad and keeps its own
autograd graph, which its VJP node differentiates (``retain_graph`` only
while another VJP call of the same node is to come); under ``recompute``
the VJP node replays the forward from its operands.  Both run the same
deterministic kernels and give the same bits; the GEMM's forward launch
count tells them apart.

Native rules (all bitwise-equal to autograd's backward of the same op):
``reshape`` / ``transpose`` / ``convert``; ``add`` / ``sub`` / ``neg`` on
equal shapes; and ``index`` by a constant on the leading axis, whose
cotangents are stacked in index order into one buffer with zeros where an
index got none — autograd's ``UnbindBackward``, which the per-op step's
``scan_layers`` runs, where the generic rule would zero-fill a whole
stacked leaf per layer and add them up.
"""
from __future__ import annotations

from typing import Callable

import torch

from .ir import LIBRARY_OPS, Node, TaskGraph, TensorType, _freeze
from .lowering import _shared_key, node_callable, node_operands
from .passes import optimize_graph
from .schedule import (pick_attention_tiles, pick_gqa_impl, pick_impl,
                       pick_matmul_tiles, pick_remat, pick_scan_chunk)

__all__ = ["grad"]

_FLOAT = ("float16", "bfloat16", "float32", "float64")


def _is_float(ttype: TensorType) -> bool:
    return ttype.dtype in _FLOAT


class _Seed(torch.autograd.Function):
    """A root whose backward hands each leaf the gradient it was given.
    Made after the node's own graph, it has the highest sequence number,
    so autograd adds its gradients into the leaves' buffers first."""

    @staticmethod
    def forward(ctx, n, *args):
        ctx.prevs = args[n:]
        return args[0].new_zeros(())

    @staticmethod
    def backward(ctx, _):
        return (None, *ctx.prevs, *(None,) * len(ctx.prevs))


def _autograd(ys, leaves, cts_in, prevs: tuple, seeded: tuple,
              retain: bool) -> tuple:
    """The gradients of ``ys`` (cotangents ``cts_in``) with respect to
    ``leaves``, ``leaves[seeded[i]]``'s added onto ``prevs[i]`` inside
    autograd's own buffer."""
    outs, cts = [], []
    for y, ct in zip(ys, cts_in):
        if y.requires_grad:
            outs.append(y)
            cts.append(ct)
    if seeded:
        outs.append(_Seed.apply(len(seeded), *(leaves[j] for j in seeded),
                                *prevs))
        cts.append(torch.ones((), dtype=outs[-1].dtype,
                              device=outs[-1].device))
    if not outs:
        return tuple(torch.zeros_like(t) for t in leaves)
    return tuple(torch.autograd.grad(outs, leaves, cts, retain_graph=retain,
                                     allow_unused=True,
                                     materialize_grads=True))


# ---------------------------------------------------------------------------
# Generic rule: torch.autograd.grad of the node's own lowering
# ---------------------------------------------------------------------------

#: structural key -> VJP callable.  Identity-stable: the callable is part
#: of the VJP ``pyfunc`` node's signature, so the same step captured twice
#: (or a second microbatch) builds the same program.
_VJP_FNS: dict[tuple, Callable] = {}


def _outputs(y, outs) -> list:
    """The differentiated outputs of a node's value: ``y`` itself, or the
    elements ``outs`` of a tuple-returning call's result."""
    return [y] if outs is None else [y[i] for i in outs]


def _make_vjp_fn(call: Callable, diff: tuple[int, ...]) -> Callable:
    n = len(call.operands)

    def _node_vjp(*vals, seeded, outs, **_static):
        # recompute: replay the forward under grad, then differentiate it;
        # ``vals`` is the cotangents, the operands, then the running
        # cotangents to seed
        m = 1 if outs is None else len(outs)
        with torch.enable_grad():
            leaves = [v.detach().requires_grad_() if i in diff else v
                      for i, v in enumerate(vals[m:m + n])]
            y = call(*leaves)
            return _autograd(_outputs(y, outs), [leaves[i] for i in diff],
                             vals[:m], vals[m + n:], seeded, False)

    return _node_vjp


def _stored_vjp(saved, *vals, seeded, outs, **_static):
    """A stored node's VJP: its forward's own autograd graph
    (``lowering.Saved``), freed by the last VJP call that reads it;
    ``vals`` is the cotangents, then the running cotangents to seed."""
    m = 1 if outs is None else len(outs)
    saved.calls_left -= 1
    retain = saved.calls_left > 0
    with torch.enable_grad():
        grads = _autograd(_outputs(saved.y, outs), saved.leaves, vals[:m],
                          vals[m:], seeded, retain)
    if not retain:
        saved.y = saved.leaves = None
    return grads


def _vjp_fn_for(g: TaskGraph, node: Node, diff: tuple[int, ...],
                whole: bool) -> Callable:
    frozen_attrs = tuple(sorted((k, _freeze(v)) for k, v in node.attrs.items()))
    key = (node.op, node.ttype, frozen_attrs, node.pdims, node.rdims,
           tuple((fn, len(extras), _freeze(at))
                 for fn, extras, at in node.epilogue),
           node.schedule.impl, tuple(sorted(node.schedule.tile.items())),
           tuple(g.nodes[o].ttype for o in node_operands(node)), diff, whole)
    fn = _VJP_FNS.get(key)
    if fn is None:
        fn = _VJP_FNS[key] = _make_vjp_fn(node_callable(node, whole=whole),
                                          diff)
    return fn


def _resolve_library_schedule(g: TaskGraph, node: Node, cm) -> None:
    """Bind tile + impl on a library node at derivation time, by the same
    argmin ``assign_schedules`` binds on the joint graph: a VJP must replay
    the forward through the impl that actually runs.  A sealed node
    (opaque mode) keeps the per-op control's lowering."""
    if not node.attrs.get("exposed", False):
        node.schedule.impl = "opaque"
        return
    shape = node.ttype.shape
    if node.op == "matmul":
        node.schedule.tile = pick_matmul_tiles(
            shape[-2], shape[-1], node.attrs["k"], node.ttype.dtype, cm)
    elif node.op == "attention":
        _, s, _, d_ = node.attrs["q_shape"]
        node.schedule.tile = pick_attention_tiles(
            s, node.attrs["kv_len"], d_, node.ttype.dtype, cm)
        node.attrs["gqa_impl"] = pick_gqa_impl(node, cm)
    elif node.op == "linear_scan":
        q_t = g.nodes[node.inputs[0]].ttype
        d_v = g.nodes[node.inputs[2]].ttype.shape[-1]
        node.schedule.tile = {"chunk": pick_scan_chunk(
            node.attrs["seq"], q_t.shape[-1], d_v, node.ttype.dtype, cm)}
    pick_impl(g, node, cm)


# ---------------------------------------------------------------------------
# Native rules
# ---------------------------------------------------------------------------

def _pd(t: TensorType) -> tuple[int, ...]:
    return tuple(range(len(t.shape)))


def _rule_reshape(g, node, ct, in_t):
    return g.add("reshape", (ct,), in_t, pdims=_pd(in_t))


def _rule_transpose(g, node, ct, in_t):
    perm = node.attrs["perm"]
    inv = tuple(sorted(range(len(perm)), key=lambda i: perm[i]))
    return g.add("transpose", (ct,), in_t, pdims=_pd(in_t), perm=inv)


def _rule_convert(g, node, ct, in_t):
    return g.add("convert", (ct,), in_t, pdims=_pd(in_t))


_STRUCTURAL = {"reshape": _rule_reshape, "transpose": _rule_transpose,
               "convert": _rule_convert}


def _leading_index(g: TaskGraph, node: Node):
    """The constant leading-axis index of an ``index`` node that takes one
    whole slab of its source (``a[i]``, ``a[i, :, ...]``), else None."""
    if node.op != "index" or node.epilogue:
        return None
    enc = node.attrs["idx"]
    if not enc or enc[0][0] != "i" or any(
            e not in (("s", None, None, None), ("e",)) for e in enc[1:]):
        return None
    n = g.nodes[node.inputs[0]].ttype.shape[0]
    return enc[0][1] % n


def _stack_slabs(*cts, n: int, present: tuple):
    """The leading-axis cotangent of ``n`` slab reads: the read slabs'
    cotangents (``present``, ascending) stacked in index order, zeros for
    the slabs nobody read — ``UnbindBackward``'s stack."""
    it = iter(cts)
    zero = None
    rows = []
    for i in range(n):
        if i in present:
            rows.append(next(it))
        else:
            if zero is None:
                zero = torch.zeros_like(cts[0])
            rows.append(zero)
    return torch.stack(rows)


# ---------------------------------------------------------------------------
# The derivation
# ---------------------------------------------------------------------------

def grad(loss, wrt, policy: str = "auto", keep=()):
    """Derive the backward of ``loss`` with respect to ``wrt`` inside the
    open region.

    ``loss`` / ``wrt`` are region handles: the scalar loss and the
    parameter leaves.  Call it while the only other live handles are region
    inputs or listed in ``keep``: the forward is optimized in place (CSE
    and fusion may retire interior nodes) before the backward is grown.
    ``keep`` handles (an earlier microbatch's loss and gradients) are
    threaded through the optimization as extra outputs so they survive it.

    Returns ``(loss_handle, grad_handles)``, fresh handles valid after the
    optimization, and with a non-empty ``keep`` also the kept handles
    rebound.  Attaches ``grad_meta`` to the graph for ``tapir.explain()``:
    ``n_fwd`` (forward nodes of the last call), ``n_bwd``, the ``remat``
    counts and the bytes stored / recomputed (summed over calls)."""
    reg = loss._region
    g: TaskGraph = reg.g
    cfg = reg.cfg
    cm = cfg.resolved_cost_model()

    wrt_nids = [reg.nid_of(h) for h in wrt]
    # ttypes up front: a leaf the loss never touches is pruned by the
    # optimization below, but still owes a zeros cotangent
    wrt_ts = [g.nodes[w].ttype for w in wrt_nids]
    keep = tuple(keep)
    g.set_outputs([reg.nid_of(loss)] + [reg.nid_of(h) for h in keep])
    if cfg.mode == "tapir":
        optimize_graph(g)          # differentiate the FUSED forms
    reg.retire_stale_handles()
    loss_nid = g.outputs[0]
    keep_nids = list(g.outputs[1:])

    order = g.topo_order()         # the forward reachable from the outputs
    n_fwd = len(order)

    # needs-grad: float nodes forward-reachable from a wrt leaf
    need: set[int] = set(wrt_nids)
    for nid in order:
        node = g.nodes[nid]
        if nid in need or not _is_float(node.ttype):
            continue
        if any(o in need for o in node_operands(node)):
            need.add(nid)

    meta = {"n_fwd": n_fwd, "n_bwd": 0, "remat": {"store": 0, "recompute": 0},
            "bytes_stored": 0, "bytes_recomputed": 0}
    loss_t = g.nodes[loss_nid].ttype
    ct: dict[int, int] = {loss_nid: reg.const(1.0, loss_t.dtype)}
    slabs: dict[int, dict[int, int]] = {}   # source -> {index: cotangent}

    def _accumulate(operand: int, contrib: int) -> None:
        prev = ct.get(operand)
        if prev is None:
            ct[operand] = contrib
        else:
            t = g.nodes[operand].ttype
            ct[operand] = g.add("ew", (prev, contrib), t, fn="add",
                                pdims=_pd(t))

    # the elements of each tuple-returning call in topological order: the
    # call's one VJP is derived at its first element, after the consumers
    # of every element
    elems: dict = {}
    for nid in order:
        if g.nodes[nid].op == "pyfunc" and "out" in g.nodes[nid].attrs:
            elems.setdefault(_shared_key(g.nodes[nid]), []).append(nid)

    def _flush_slabs(src: int) -> None:
        got = slabs.pop(src)
        present = tuple(sorted(got))
        t = g.nodes[src].ttype
        stacked = g.add("pyfunc", tuple(got[i] for i in present), t,
                        pdims=_pd(t), fn=_stack_slabs,
                        static=(("n", t.shape[0]), ("present", present)))
        _accumulate(src, stacked)
        meta["n_bwd"] += 1

    for nid in reversed(order):
        if nid in slabs:
            _flush_slabs(nid)
        node = g.nodes[nid]
        outs, group = None, (nid,)
        if node.op == "pyfunc" and "out" in node.attrs:
            group = elems[_shared_key(node)]
            if nid != group[0]:
                continue
            group = tuple(e for e in group if e in ct)
            outs = tuple(g.nodes[e].attrs["out"] for e in group)
        if not group or group[0] not in ct or node.op in ("input", "const"):
            continue
        cs = tuple(ct[e] for e in group)
        c = cs[0]
        operands = node_operands(node)
        if node.op in _STRUCTURAL and not node.epilogue:
            src = operands[0]
            if src in need:
                _accumulate(src, _STRUCTURAL[node.op](g, node, c,
                                                      g.nodes[src].ttype))
                meta["n_bwd"] += 1
            continue
        if node.op == "ew" and not node.epilogue and node.attrs["fn"] in (
                "add", "sub", "neg") and all(
                g.nodes[o].ttype == node.ttype for o in operands):
            fn = node.attrs["fn"]
            if fn in ("add", "sub") and operands[0] in need:
                _accumulate(operands[0], c)
                meta["n_bwd"] += 1
            if fn in ("sub", "neg"):
                tgt = operands[0] if fn == "neg" else operands[1]
                if tgt in need:
                    t = g.nodes[tgt].ttype
                    _accumulate(tgt, g.add("ew", (c,), t, fn="neg",
                                           pdims=_pd(t)))
                    meta["n_bwd"] += 1
            elif fn == "add" and operands[1] in need:
                _accumulate(operands[1], c)
                meta["n_bwd"] += 1
            continue
        k = _leading_index(g, node)
        if k is not None:
            src = operands[0]
            if src in need:
                got = slabs.setdefault(src, {})
                if k in got:     # two reads of one slab (not CSE'd)
                    t = node.ttype
                    c = g.add("ew", (got[k], c), t, fn="add", pdims=_pd(t))
                got[k] = c
            continue
        # generic rule: torch.autograd.grad of this node's own lowering
        diff = tuple(i for i, o in enumerate(operands)
                     if o in need and _is_float(g.nodes[o].ttype))
        if not diff:
            continue
        if node.donates is not None:
            raise NotImplementedError(
                f"autodiff: {node.op} node %{nid} writes its input in "
                f"place and has no VJP")
        if node.op in LIBRARY_OPS:
            _resolve_library_schedule(g, node, cm)
        remat = node.schedule.remat
        if not remat:
            remat = node.schedule.remat = pick_remat(g, node, cm,
                                                     policy=policy)
            meta["remat"][remat] += 1
            meta["bytes_stored" if remat == "store"
                 else "bytes_recomputed"] += sum(
                int(g.nodes[e].ttype.bytesize) for e in group)
        # an operand's running cotangent seeds the first position it holds
        seeds, firsts = [], set()
        for j, i in enumerate(diff):
            o = operands[i]
            if o not in firsts and o in ct:
                seeds.append((j, ct[o]))
            firsts.add(o)
        seeded = tuple(j for j, _ in seeds)
        static = (("diff", diff), ("grad_of", node.op), ("outs", outs),
                  ("remat", remat), ("seeded", seeded))
        if remat == "store":
            ins, fn, extra = (nid,) + cs, _stored_vjp, {"saved": True}
        else:
            ins, fn, extra = cs + operands, _vjp_fn_for(
                g, node, diff, whole=outs is not None), {}
        ins += tuple(p for _, p in seeds)
        for j, i in enumerate(diff):
            o = operands[i]
            o_t = g.nodes[o].ttype
            contrib = g.add("pyfunc", ins, o_t, pdims=_pd(o_t), fn=fn,
                            out=j, static=static, **extra)
            if j in seeded:
                ct[o] = contrib        # the running sum, this node's added
            else:
                _accumulate(o, contrib)
            meta["n_bwd"] += 1

    grads = []
    for w, t in zip(wrt_nids, wrt_ts):
        cn = ct.get(w)
        if cn is None:             # unused leaf: a zero gradient
            z = reg.const(0.0, t.dtype)
            cn = g.add("broadcast", (z,), t, pdims=_pd(t))
        grads.append(reg.handle(cn))

    prev = getattr(g, "grad_meta", None)
    if prev:
        meta["n_bwd"] += prev["n_bwd"]
        for k in ("store", "recompute"):
            meta["remat"][k] += prev["remat"][k]
        for k in ("bytes_stored", "bytes_recomputed"):
            meta[k] += prev[k]
    g.grad_meta = meta
    if keep:
        return (reg.handle(loss_nid), grads,
                [reg.handle(n) for n in keep_nids])
    return reg.handle(loss_nid), grads
