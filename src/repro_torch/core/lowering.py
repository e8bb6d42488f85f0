"""Lowering: scheduled Task IR -> a Python callable over torch ops.

``emit`` walks the graph once in topological order and returns
``run(inputs) -> outputs``.  Each library node dispatches on
``node.schedule.impl`` alone — the name the scheduler's impl registry bound
as the roofline argmin; no route is chosen by the device a tensor is on:

* a matmul, ``fused_kernel`` or ``"opaque"`` (a sealed node, the per-op
  control), calls ``kernels.fused_matmul.ops.fused_matmul``, the
  hand-written Hopper GEMM with its epilogue chain applied in the kernel
  (its wrapper takes the plain version for a CPU tensor): no GEMM of the
  port has another route.  A matmul with a 3-D weight (the MoE expert
  FFN) is one launch of the kernel's grouped route under ``fused_kernel``
  and one 2-D launch per expert under ``opaque`` (the reference's "one
  isolated library call per expert");
* an attention node, ``flash_kernel`` or ``"opaque"``, calls
  ``kernels.flash_attention.ops.flash_attention``, the hand-written Hopper
  flash kernel, with any fused epilogue applied after it;
  ``materialized_*`` and ``ref`` (which differ only in cost) all lower to
  ``attention_ref``, the plain fp32-score oracle, on a CPU tensor and
  raise on a CUDA one: on the card no attention runs outside the kernel;
* a linear-scan node, ``kernel`` or ``"opaque"``, calls
  ``kernels.linear_scan.ops.linear_scan``, the hand-written Hopper chunked
  scan, at the scheduled chunk (``SAFE_CHUNK`` where none was set: never a
  chunk past it, where the factored form stops being exact), with any
  fused epilogue applied after it (under grad the wrapper's
  ``LinearScanFn``, whose backward on the card is the hand-written
  backward kernel); ``chunked`` and ``ref`` lower to the plain versions
  on a CPU tensor and raise on a CUDA one, with or without grad;
* a conv2d node, ``im2col_gemm`` or ``"opaque"``, builds the patch matrix
  of the padded NHWC input (``im2col``: kh*kw shifted, strided slices
  concatenated on the channel axis in HWIO order) and calls
  ``fused_matmul`` against the kernel reshaped to ``[kh*kw*cin, co]``
  with the node's epilogue: no library convolution runs.  Autograd
  through the slices and the concatenation gives the input's gradient;
  the GEMM's backward routes give the kernel's.

A lifted composite that returns a tuple is one ``pyfunc`` node per output;
a program runs the function once and hands each node its element.

Indexing keeps the JAX package's semantics, which torch does not share:
gathers wrap negative indices and then CLAMP out-of-range ones, scatters
wrap negative indices and then DROP out-of-range updates, and the window
ops (``dynamic_slice`` / ``dynamic_update_slice``) wrap a negative start
once and then CLAMP each start to ``[0, dim - window]``.  All are computed with tensor ops and no host
synchronization; an unchecked out-of-range index would raise on the CPU
and device-assert on the card.

Liveness: ``emit`` drops each value after its last consumer (its last
reader, an anti edge included), so a program holds only the values still
to be read; program inputs and outputs are never dropped.

Training (``core.autodiff``): a VJP node is a ``pyfunc`` over the
node's cotangent.  Under remat ``recompute`` it replays the forward node
(``node_callable``) under grad and differentiates it; under ``store`` the
forward node itself runs under grad on detached operands
(``_lower_stored``) and keeps its own autograd graph, which its VJP node
(``attrs["saved"]``) differentiates.  The value that flows on is
detached, so no autograd chain spans two nodes.

Donation: a scatter or window write that donates a region INPUT writes
that tensor in place (``index_put_``) and returns it, so a KV pool or
cache slab keeps its storage (and ``data_ptr``) across steps.  The
anti edges run every earlier reader of the buffer (``Node.anti``) before
the write; a write still goes to a copy where one of those readers
returned a view of the buffer (its value would change under it), or
where the buffer is not a region input.  Under grad mode a donated write
whose buffer or update requires grad raises: autograd keeps the values a
program read, and an in-place write would change them.  A ``pyfunc`` that
donates an input leaves its value in that input: its function either wrote
the input in place and returned it (AdamW's ``leaf_update``), or returned
a new value, which is copied over the input.
"""
from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

from ..kernels.costs import SAFE_CHUNK
from ..kernels.flash_attention import ops as fa_ops
from ..kernels.flash_attention import ref as fa_ref
from ..kernels.fused_matmul import ops as fm_ops
from ..kernels.fused_matmul.ref import _EW
from ..kernels.linear_scan import ops as ls_ops
from ..kernels.linear_scan import ref as ls_ref
from .dtypes import to_torch_dtype
from .ir import Node, TaskGraph


def _apply_epilogue(y, node: Node, env: dict) -> Any:
    for fn, extras, at in node.epilogue:
        # replay the un-fused chain bitwise: the head materialized in the
        # consumer's dtype before the ew op ran
        edt = at.get("dtype")
        if edt is not None:
            y = y.to(to_torch_dtype(edt))
        vals = [env[e].to(y.dtype) for e in extras]
        f = _EW[fn]
        if at.get("head_pos", 0) == 0:
            y = f(y, *vals)
        else:
            y = f(vals[0], y, *vals[1:])
    return y


# -- library lowerings --------------------------------------------------------


def _lower_matmul(node: Node, env: dict) -> Any:
    """Every GEMM goes through the kernel's wrapper: ``fused_kernel`` with
    the epilogue chain fusion folded in, ``opaque`` (a sealed node, which
    fusion never touched) with none.  A 3-D weight ``[E, k, n]`` is the
    grouped route's one launch under ``fused_kernel``; under ``opaque`` it
    is E launches of the 2-D route, one per expert, stacked."""
    impl = node.schedule.impl
    if impl not in ("fused_kernel", "opaque"):
        raise NotImplementedError(f"matmul impl {impl!r} is not ported")
    x, w = env[node.inputs[0]], env[node.inputs[1]]
    out_dt = to_torch_dtype(node.ttype.dtype)
    epi = [(fn, [env[e] for e in extras], at)
           for fn, extras, at in node.epilogue]
    if w.ndim == 3 and impl == "opaque":
        # sealed: fusion never gave it an epilogue
        return torch.stack([fm_ops.fused_matmul(x[e], w[e],
                                                out_dtype=out_dt)
                            for e in range(w.shape[0])])
    return fm_ops.fused_matmul(x, w, epilogue=epi, tile=node.schedule.tile,
                               out_dtype=out_dt)


def _lower_attention(node: Node, env: dict) -> Any:
    q, k, v = (env[i] for i in node.inputs[:3])
    bias = env[node.inputs[3]] if len(node.inputs) > 3 else None
    causal = node.attrs.get("causal", False)
    impl = node.schedule.impl
    if impl in ("flash_kernel", "opaque"):
        y = fa_ops.flash_attention(q, k, v, causal=causal, bias=bias)
    elif impl in ("materialized_repeat", "materialized_grouped", "ref"):
        # the three differ only in what the cost model charges them
        if q.device.type != "cpu":
            raise NotImplementedError(
                f"attention impl {impl!r} is a plain composite: it runs on "
                f"the CPU only (on {q.device} attention is the kernel's)")
        y = fa_ref.attention_ref(q, k, v, causal=causal, bias=bias)
    else:
        raise NotImplementedError(f"attention impl {impl!r} is not ported")
    return _apply_epilogue(y, node, env).to(to_torch_dtype(node.ttype.dtype))


def _lower_linear_scan(node: Node, env: dict) -> Any:
    q, k, v, w = (env[i] for i in node.inputs[:4])
    u = env[node.inputs[4]] if len(node.inputs) > 4 else None
    impl = node.schedule.impl
    chunk = node.schedule.tile.get("chunk") or SAFE_CHUNK
    if impl in ("kernel", "opaque"):
        y = ls_ops.linear_scan(q, k, v, w, u=u, chunk=chunk)
    elif impl in ("chunked", "ref"):
        if q.device.type != "cpu":
            raise NotImplementedError(
                f"linear_scan impl {impl!r} is a plain composite: it runs on "
                f"the CPU only (on {q.device} the scan is the kernel's)")
        y = (ls_ref.linear_scan_chunked(q, k, v, w, u=u, chunk=chunk)
             if impl == "chunked" else ls_ref.linear_scan_ref(q, k, v, w, u=u))
    else:
        raise NotImplementedError(f"linear_scan impl {impl!r} is not ported")
    return _apply_epilogue(y, node, env).to(to_torch_dtype(node.ttype.dtype))


def conv2d_out_hw(h: int, w: int, kh: int, kw: int, strides: tuple,
                  padding: str) -> tuple[int, int]:
    """The output's spatial size, as XLA computes it for SAME / VALID."""
    if padding == "SAME":
        return -(-h // strides[0]), -(-w // strides[1])
    if padding == "VALID":
        return (h - kh) // strides[0] + 1, (w - kw) // strides[1] + 1
    raise ValueError(f"padding must be 'SAME' or 'VALID', got {padding!r}")


def im2col(x: torch.Tensor, kh: int, kw: int, strides: tuple,
           padding: str) -> torch.Tensor:
    """The patch matrix ``[B*Ho*Wo, kh*kw*C]`` of an NHWC ``x``: row
    ``(b, i, j)`` holds the window at output pixel ``(i, j)``, taps in
    (row, column, channel) order, the order of an HWIO kernel's rows.
    "SAME" pads as XLA does: ``total = max((Ho-1)*s + k - H, 0)``, half
    (rounded down) before, the rest after."""
    B, H, W, C = x.shape
    sh, sw = strides
    ho, wo = conv2d_out_hw(H, W, kh, kw, strides, padding)
    if padding == "SAME":
        ph = max((ho - 1) * sh + kh - H, 0)
        pw = max((wo - 1) * sw + kw - W, 0)
        x = torch.nn.functional.pad(
            x, (0, 0, pw // 2, pw - pw // 2, ph // 2, ph - ph // 2))
    taps = [x[:, i:i + (ho - 1) * sh + 1:sh, j:j + (wo - 1) * sw + 1:sw, :]
            for i in range(kh) for j in range(kw)]
    return torch.cat(taps, dim=-1).reshape(B * ho * wo, kh * kw * C)


def _lower_conv2d(node: Node, env: dict) -> Any:
    """im2col, then the GEMM kernel's wrapper with the node's epilogue
    (``im2col_gemm``; a sealed ``opaque`` node has none)."""
    impl = node.schedule.impl
    if impl not in ("im2col_gemm", "opaque"):
        raise NotImplementedError(f"conv2d impl {impl!r} is not ported")
    x, kern = env[node.inputs[0]], env[node.inputs[1]]
    kh, kw, cin, co = kern.shape
    cols = im2col(x, kh, kw, node.attrs["strides"], node.attrs["padding"])
    epi = [(fn, [env[e] for e in extras], at)
           for fn, extras, at in node.epilogue]
    y = fm_ops.fused_matmul(cols, kern.reshape(kh * kw * cin, co),
                            epilogue=epi,
                            out_dtype=to_torch_dtype(node.ttype.dtype))
    return y.reshape(node.ttype.shape)


# -- indexing with the reference's semantics ---------------------------------


def _norm_indices(idx: tuple, lead: tuple) -> tuple:
    """Wrap negative indices, broadcast to one shape, as int64."""
    out = []
    for i, n in zip(idx, lead):
        i = torch.as_tensor(i).to(torch.int64)
        out.append(torch.where(i < 0, i + n, i))
    return tuple(torch.broadcast_tensors(*out))


def gather_clamped(src: torch.Tensor, idx: tuple) -> torch.Tensor:
    """``src[i0, i1, ...]`` with the reference's clamping of out-of-range
    indices (after negative wrap)."""
    lead = tuple(src.shape[:len(idx)])
    idx = _norm_indices(idx, lead)
    return src[tuple(i.clamp(0, n - 1) for i, n in zip(idx, lead))]


def scatter_prep(idx: tuple, lead: tuple, mode: str, device) -> tuple:
    """The index preparation of ``scatter_drop``, a function of the
    indices alone (two writes through the same indices share it): per
    axis the target index, in range for every row (a negative index
    wrapped once; an out-of-range row aims at some in-range target and
    will write that target's final value), and the row-validity mask.
    For "set" also, per row, whether any valid row aims at the same
    target and the LAST such row (duplicates: last wins, as the
    reference's sequential scatter does): a stable sort of the valid rows'
    linear targets keeps each target's rows in row order, and a search
    finds the end of each row's run.  The work grows with the rows
    written, not with the buffer.  No host sync."""
    idx = [torch.as_tensor(i, device=device) for i in idx]
    total = int(np.prod(lead)) if lead else 1
    if total >= 2 ** 31:
        idx = [i.to(torch.int64) for i in idx]
    valid = lin = None
    tgt = []
    for i, n in zip(idx, lead):
        ok = (i >= -n) & (i < n)
        valid = ok if valid is None else valid & ok
        r = i.remainder(n)
        tgt.append(r)
        lin = r if lin is None else torch.add(r, lin, alpha=n)
    tgt = tuple(torch.broadcast_tensors(*tgt))
    valid = valid.expand(tgt[0].shape).reshape(-1)
    if mode == "add":
        return tgt, valid
    lin = lin.expand(tgt[0].shape).reshape(-1).to(torch.int64)
    keys, order = torch.sort(torch.where(valid, lin, -1), stable=True)
    last = torch.searchsorted(keys, lin, right=True) - 1
    # a row no valid row aims with may find row -1 (torch wraps it) or
    # another target's row; its ``has`` is False and the row is discarded
    return tgt, keys[last] == lin, order[last]


def scatter_drop(buf: torch.Tensor, idx: tuple, upd, mode: str,
                 in_place: bool, prep: tuple = None) -> torch.Tensor:
    """``buf.at[i0, i1, ...].set/add(upd, mode="drop")``.

    Out-of-range rows must write nothing.  Every row writes an in-range
    target (``scatter_prep``) and writes the FINAL value of that target:
    for "add" the dropped rows add zero; for "set" each row writes the
    update of the last valid row aimed at the same target, or the
    target's old value when no valid row aims there.  Rows sharing a
    target then write identical values, so the write order cannot matter
    — and no host sync is needed to find the valid rows.  ``prep``: this
    write's ``scatter_prep``, when another write through the same
    indices already made it (``idx`` is then not read)."""
    if prep is None:
        prep = scatter_prep(idx, tuple(buf.shape[:len(idx)]), mode,
                            buf.device)
    tgt = prep[0]
    tail = tuple(buf.shape[len(tgt):])
    ishape = tuple(tgt[0].shape)
    upd = torch.as_tensor(upd).to(buf.dtype).expand(ishape + tail)
    out = buf if in_place else buf.clone()
    if mode == "add":
        keep = prep[1].reshape(ishape + (1,) * len(tail))
        out.index_put_(tgt, torch.where(keep, upd, 0), accumulate=True)
        return out
    has, win = prep[1], prep[2]
    rows = upd.reshape((-1,) + tail)
    vals = torch.where(has.reshape((-1,) + (1,) * len(tail)), rows[win],
                       buf[tgt].reshape(rows.shape))
    out.index_put_(tgt, vals.reshape(upd.shape))
    return out


def _window(buf: torch.Tensor, starts: tuple, window: tuple):
    """(view, index): ``buf`` narrowed on its static-start dims, and, when a
    start is a tensor, the broadcast index tuple of the window inside that
    view (else None).  As ``lax.dynamic_slice`` / ``dynamic_update_slice``
    do, a negative start wraps once (``start + dim``) and every start then
    clamps to ``[0, dim - window]``; a tensor start does so on its own
    device, with no host synchronization."""
    view = buf
    dyn = []
    for d, (s, w) in enumerate(zip(starts, window)):
        n = buf.shape[d]
        if isinstance(s, torch.Tensor):
            s = s.to(torch.int64)
            dyn.append((d, torch.where(s < 0, s + n, s).clamp(0, n - w)))
        else:
            s = int(s)
            s = s + n if s < 0 else s
            view = view.narrow(d, min(max(s, 0), n - w), w)
    if not dyn:
        return view, None
    idx = []
    for d, w in enumerate(window):
        shape = [1] * len(window)
        shape[d] = w
        ar = torch.arange(w, device=buf.device)
        start = next((s for dd, s in dyn if dd == d), None)
        idx.append((ar if start is None else start + ar).reshape(shape))
    return view, tuple(idx)


def dynamic_slice_clamped(buf: torch.Tensor, starts: tuple,
                          sizes: tuple) -> torch.Tensor:
    """``lax.dynamic_slice(buf, starts, sizes)``."""
    view, idx = _window(buf, starts, tuple(sizes))
    return view if idx is None else view[idx]


def dynamic_update_slice_clamped(buf: torch.Tensor, upd, starts: tuple,
                                 in_place: bool) -> torch.Tensor:
    """``lax.dynamic_update_slice(buf, upd, starts)``: ``upd`` (cast to
    ``buf``'s dtype) written at the clamped window; in place when
    ``in_place`` (the donated case), else into a copy."""
    upd = torch.as_tensor(upd).to(buf.dtype)
    out = buf if in_place else buf.clone()
    view, idx = _window(out, starts, tuple(upd.shape))
    if idx is None:
        view.copy_(upd)
    else:
        view.index_put_(idx, upd)
    return out


def _resolve_starts(node: Node, env: dict, dyn_inputs: tuple) -> tuple:
    """Interleave static int starts with dynamic scalar operands (the None
    holes of ``static_starts`` consume ``dyn_inputs`` in order)."""
    it = iter(dyn_inputs)
    return tuple(s if s is not None else env[next(it)]
                 for s in node.attrs["static_starts"])


def _decode_index(enc: tuple) -> tuple:
    out = []
    for e in enc:
        if e[0] == "i":
            out.append(e[1])
        elif e[0] == "s":
            out.append(slice(e[1], e[2], e[3]))
        elif e[0] == "e":
            out.append(Ellipsis)
        else:
            out.append(None)
    return tuple(out)


# -- primitive lowerings -------------------------------------------------------


def _donates_input(node: Node, nodes: dict) -> bool:
    return node.donates is not None and nodes[node.donates].op == "input"


def _donated_in_place(node: Node, nodes: dict, env: dict) -> bool:
    """Whether this donating write goes to its region input in place: no
    earlier reader of the buffer (all of which ran before it) returned a
    view of the buffer — a value made from the pre-write buffer must not
    change under its consumers.  A host-side check, no sync."""
    if not _donates_input(node, nodes):
        return False
    if torch.is_grad_enabled() and any(
            isinstance(env.get(i), torch.Tensor) and env[i].requires_grad
            for i in (node.donates, *node.inputs)):
        raise RuntimeError(
            "a region program that requires grad cannot write its input in "
            "place (autograd keeps the value it read): run the cache "
            "writes under torch.no_grad()")
    store = env[node.donates].untyped_storage().data_ptr()
    return not any(isinstance(v, torch.Tensor)
                   and v.untyped_storage().data_ptr() == store
                   for v in (env.get(r) for r in node.anti))


def written_inputs(g: TaskGraph) -> frozenset:
    """The names of the inputs the emitted program may write in place
    (those its donating writes target)."""
    return frozenset(g.nodes[n.donates].attrs["name"]
                     for n in g.nodes.values() if _donates_input(n, g.nodes))


def holds_collective(g: TaskGraph) -> bool:
    """Whether a program runs a collective: a ``reshard`` that gathers."""
    return any(n.op == "reshard" and any(e is not None
                                         for e in (n.attrs["src"] or ()))
               for n in g.nodes.values())


def _lower_node(node: Node, env: dict, inputs: dict, nodes: dict) -> Any:
    op = node.op
    if op == "input":
        return inputs[node.attrs["name"]]
    if op == "const":
        return _const(node)
    if op == "ew":
        return _EW[node.attrs["fn"]](*[env[i] for i in node.inputs])
    if op == "reshape":
        return env[node.inputs[0]].reshape(node.ttype.shape)
    if op == "transpose":
        return env[node.inputs[0]].permute(node.attrs["perm"])
    if op == "broadcast":
        # a new tensor, not a stride-0 view: a consumer may write it
        return torch.broadcast_to(env[node.inputs[0]],
                                  node.ttype.shape).contiguous()
    if op == "slice":
        x = env[node.inputs[0]]
        ax = node.attrs["axis"] % x.ndim
        return x.narrow(ax, node.attrs["start"],
                        node.attrs["limit"] - node.attrs["start"])
    if op == "concat":
        return torch.cat([env[i] for i in node.inputs], dim=node.attrs["axis"])
    if op == "convert":
        return env[node.inputs[0]].to(to_torch_dtype(node.ttype.dtype))
    if op == "pyfunc":
        val = _lower_pyfunc(node, env)
        if _donates_input(node, nodes):
            buf = env[node.donates]
            if val is not buf:
                buf.copy_(val)
            return buf
        return val
    if op == "index":
        return env[node.inputs[0]][_decode_index(node.attrs["idx"])]
    if op == "dynamic_slice":
        return dynamic_slice_clamped(
            env[node.inputs[0]], _resolve_starts(node, env, node.inputs[1:]),
            node.attrs["sizes"])
    if op == "dynamic_update_slice":
        return dynamic_update_slice_clamped(
            env[node.inputs[0]], env[node.inputs[1]],
            _resolve_starts(node, env, node.inputs[2:]),
            _donated_in_place(node, nodes, env))
    if op == "gather":
        return gather_clamped(env[node.inputs[0]],
                              tuple(env[i] for i in node.inputs[1:]))
    if op == "scatter":
        n_idx = node.attrs["n_idx"]
        mode = node.attrs.get("mode", "set")
        rest = _scatter_operands(node)
        upd = env[rest[n_idx]]
        if node.attrs.get("zero_init"):
            # a fresh zeros buffer, made here and written in place
            buf = torch.zeros(node.ttype.shape,
                              dtype=to_torch_dtype(node.ttype.dtype),
                              device=upd.device)
            in_place = True
        else:
            buf = env[node.inputs[0]]
            in_place = _donated_in_place(node, nodes, env)
        lead = tuple(buf.shape[:n_idx])
        pkey = _shared_key(node)
        prep = env.get(pkey)
        if prep is None:
            prep = env[pkey] = scatter_prep(
                tuple(env[i] for i in rest[:n_idx]), lead, mode, buf.device)
        return scatter_drop(buf, None, upd, mode, in_place, prep=prep)
    if op == "reshard":
        from ..dist.sharding import current_mesh, reshard_tensor
        return reshard_tensor(env[node.inputs[0]], node.attrs["src"],
                              node.attrs["dst"], current_mesh())
    if op == "matmul":
        return _lower_matmul(node, env)
    if op == "attention":
        return _lower_attention(node, env)
    if op == "linear_scan":
        return _lower_linear_scan(node, env)
    if op == "conv2d":
        return _lower_conv2d(node, env)
    raise NotImplementedError(f"lowering of {op!r} is not ported yet")


def _pyfunc_args(node: Node, env: dict) -> list:
    args = [env[i] for i in node.inputs]
    if node.attrs.get("saved"):
        # a stored node's VJP: its forward's autograd record, not its value
        args[0] = env[("saved", node.inputs[0])]
    return args


def _scatter_operands(node: Node) -> tuple:
    """A scatter's index operands then its update: every input but the
    buffer (a ``zero_init`` scatter has none)."""
    return node.inputs if node.attrs.get("zero_init") else node.inputs[1:]


def _shared_key(node: Node):
    """The env key of a value several nodes share: the result tuple of a
    tuple-returning ``pyfunc`` (one call, one node per element) and a
    scatter's index preparation (the K and V writes of a block go through
    the same index nodes)."""
    if node.op == "pyfunc" and node.attrs.get("out") is not None:
        return ("pyfunc", node.attrs["fn"], node.attrs.get("static", ()),
                node.inputs)
    if node.op == "scatter":
        n_idx = node.attrs["n_idx"]
        return ("scatter_prep", _scatter_operands(node)[:n_idx],
                tuple(node.ttype.shape[:n_idx]), node.attrs.get("mode", "set"))
    return None


def _lower_pyfunc(node: Node, env: dict) -> Any:
    static = dict(node.attrs.get("static", ()))
    out_i = node.attrs.get("out")
    if out_i is None:
        return node.attrs["fn"](*_pyfunc_args(node, env), **static)
    key = _shared_key(node)
    res = env.get(key)
    if res is None:
        res = env[key] = node.attrs["fn"](*_pyfunc_args(node, env), **static)
    return res[out_i]


def node_operands(node: Node) -> tuple[int, ...]:
    """A node's data operands in lowering order: ``inputs``, then every
    epilogue extra in epilogue order (duplicates kept)."""
    return tuple(node.inputs) + tuple(
        e for _, extras, _ in node.epilogue for e in extras)


def node_callable(node: Node, whole: bool = False) -> Callable:
    """A callable computing ``node``'s value from its operands, positional
    in ``node_operands`` order: the node's own lowering (same impl, tile and
    epilogue chain as ``emit`` runs), on a copy of the node with dense
    operand ids, so it never reads the graph.  ``core.autodiff``
    differentiates it; ``.operands`` carries the operand nids.  ``whole``:
    an element of a tuple-returning ``pyfunc`` gives the call's tuple."""
    k = len(node.inputs)
    attrs = dict(node.attrs)
    if whole:
        del attrs["out"]
    repl = Node(nid=-1, op=node.op, inputs=tuple(range(k)),
                ttype=node.ttype, attrs=attrs, pdims=node.pdims,
                rdims=node.rdims)
    repl.schedule.impl = node.schedule.impl
    repl.schedule.tile = dict(node.schedule.tile)
    pos = k
    for fn, extras, at in node.epilogue:
        ids = tuple(range(pos, pos + len(extras)))
        pos += len(extras)
        repl.epilogue.append((fn, ids, dict(at)))
    arity = pos

    def call(*vals):
        if len(vals) != arity:
            raise TypeError(f"{node.op}: {arity} operands, got {len(vals)}")
        return _lower_node(repl, dict(enumerate(vals)), {}, {})

    call.operands = node_operands(node)
    return call


class Saved:
    """A stored node's autograd record: its output under grad, the leaves
    its VJP differentiates, and how many VJP calls still read it (the last
    one frees the graph)."""

    __slots__ = ("y", "leaves", "calls_left")

    def __init__(self, y, leaves, calls: int):
        self.y, self.leaves, self.calls_left = y, leaves, calls


def _lower_stored(call: Callable, vals: list, diff: tuple,
                  calls: int) -> tuple:
    """(value, record) of a forward node marked ``store``: its lowering
    run under grad on detached operands, the ``diff`` ones requiring grad.
    The value that flows on is detached (a tuple's elements each)."""
    with torch.enable_grad():
        leaves = [v.detach().requires_grad_() if i in diff else v
                  for i, v in enumerate(vals)]
        y = call(*leaves)
    val = y.detach() if isinstance(y, torch.Tensor) else tuple(
        t.detach() for t in y)
    return val, Saved(y, [leaves[i] for i in diff], calls)


def _const(node: Node) -> torch.Tensor:
    """A const node's tensor, on the device the tracer recorded for it."""
    return torch.as_tensor(np.asarray(node.attrs["value"]),
                           dtype=to_torch_dtype(node.ttype.dtype),
                           device=node.attrs.get("device", "cpu"))


def emit(g: TaskGraph) -> Callable[[dict], tuple]:
    """Compile the scheduled graph into ``run(inputs dict) -> outputs``.

    Each value is dropped from the program's environment after its last
    reader, so a program holds O(live values), not O(nodes); inputs and
    outputs stay.  Nodes whose VJP is stored (``attrs["saved"]`` on a
    ``pyfunc`` reading them) run through ``_lower_stored``."""
    order = g.topo_order()
    nodes = [g.nodes[nid] for nid in order]
    by_id = dict(g.nodes)
    outputs = list(g.outputs)

    # stored forward nodes: the union of their VJPs' operand positions, and
    # the number of VJP calls that read the record
    diffs: dict[int, set] = {}
    vjp_calls: dict[int, set] = {}
    for node in nodes:
        if node.op == "pyfunc" and node.attrs.get("saved"):
            fwd = node.inputs[0]
            diffs.setdefault(fwd, set()).update(
                dict(node.attrs["static"])["diff"])
            vjp_calls.setdefault(fwd, set()).add(_shared_key(node))
    # an element of a tuple-returning call keeps the whole call's record
    stored = {nid: (node_callable(by_id[nid],
                                  whole="out" in by_id[nid].attrs),
                    tuple(sorted(d)), len(vjp_calls[nid]))
              for nid, d in diffs.items()}

    # liveness: the position of each value's last reader
    keep = set(outputs) | {nid for _, nid in g.inputs}
    last: dict = {}
    for pos, node in enumerate(nodes):
        last[node.nid] = pos
        for d in g._deps(node):
            last[d] = pos
        key = _shared_key(node)
        if key is not None:
            last[key] = pos
        if node.op == "pyfunc" and node.attrs.get("saved"):
            last[("saved", node.inputs[0])] = pos
    drops: list[list] = [[] for _ in nodes]
    for k, pos in last.items():
        if k not in keep:
            drops[pos].append(k)

    # consts are built once per program, not per call: a host->device copy
    # inside the decode loop would stall the host on the stream
    consts: dict[int, torch.Tensor] = {}

    def run(inputs: dict) -> tuple:
        env: dict[Any, Any] = {}
        for node, drop in zip(nodes, drops):
            nid = node.nid
            if node.op == "const":
                val = consts.get(nid)
                if val is None:
                    val = consts[nid] = _const(node)
                env[nid] = val
            elif nid in stored:
                call, diff, calls = stored[nid]
                val, env[("saved", nid)] = _lower_stored(
                    call, [env[o] for o in call.operands], diff, calls)
                if "out" in node.attrs:
                    # the call's other elements read its result
                    env.setdefault(_shared_key(node), val)
                    val = val[node.attrs["out"]]
                env[nid] = val
            else:
                env[nid] = _lower_node(node, env, inputs, by_id)
            for k in drop:
                env.pop(k, None)
        return tuple(env[o] for o in outputs)

    return run
