"""Graph evaluation and shape inference (port of the evaluation half of
``mxnet_tpu/executor.py``).

:class:`GraphProgram` evaluates a Symbol's DAG op by op on torch tensors;
autograd records it, so the backward of a training step is
``torch.autograd.grad`` over its outputs.  A ``needs_rng`` node (Dropout,
rrelu) draws from the ``torch.Generator`` the caller hands
:meth:`GraphProgram.evaluate`, the nodes in topological order, as the JAX
program hands out its keys; the :class:`Executor` and the trainer own one
on their device, seeded from ``mx.random.seed``.  A mode-dependent node
(BatchNorm, Dropout) sees ``_train``.  Shape inference
(:func:`infer_shapes`) runs the same ops on ``meta`` tensors, which carry
shapes and dtypes but no data, after the ``infer_params`` hooks
(:mod:`.ops.shape_hints`) have filled in the parameter shapes the caller
did not give; type inference (:func:`infer_types`) propagates dtypes
forward as the JAX package does.

:class:`Executor` is a Symbol bound to arrays on one device
(``simple_bind`` allocates them from the inferred shapes): a train-mode
forward records the graph with autograd, and ``backward`` runs
``torch.autograd.grad`` over its outputs and writes the gradients into
the bound gradient arrays; ``run_fwd_bwd`` does both at once (the Module
path).  Monitor taps (``set_monitor_callback``, ROADMAP queue A item 9,
observability) raise ``NotPortedYet``.  ``group2ctx`` (``ctx_group``
placement) runs each grouped node on its group's device through
:class:`~mxnet_tpu_torch.placement.SegmentedProgram`; an op node's
``__shard__`` goes through :func:`~mxnet_tpu_torch.placement.
activation_constraint` (checked against the current mesh, the value
unchanged).

Remat (the reference's ``MXNET_BACKWARD_DO_MIRROR``): a policy chosen by
:func:`set_backward_mirror`, else ``MXNET_TPU_REMAT_POLICY``, else
``MXNET_BACKWARD_DO_MIRROR`` (which means ``dots``), as the JAX package
resolves it.  A recording forward then evaluates the graph in segments
of its topological order, about the square root of its node count each
(the sublinear schedule of MXNet's mirror), every segment under
``torch.utils.checkpoint.checkpoint(use_reentrant=False)``: ``full``
keeps only what crosses a segment's edge, ``dots`` also the outputs of
every matmul and convolution, ``dots_no_batch`` those of the matmuls
without batch dimensions (selective checkpointing; the dispatcher ops
that JAX's ``dots_saveable`` and ``dots_with_no_batch_dims_saveable``
name).  The backward recomputes one segment at a time with the same ops
and kernels.  One checkpoint over the whole forward would recompute it
all at once and keep every activation again, so its peak would not
fall.  A segment's random nodes redraw the same values: the executor's
generator is rewound to the segment's start for the recompute.
"""
from __future__ import annotations

import ast
import functools
import math
import os
import warnings
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from . import rng as _rng
from .base import (MXNetError, NotPortedYet, dtype_name,
                   dtype_np, dtype_torch)
from .context import Context, as_torch_device, context_of
from .ndarray.ndarray import NDArray, zeros
from .ops import shape_hints  # noqa: F401  (installs infer_params hooks)
from .symbol.symbol import Symbol, _topo_order

__all__ = ["GraphProgram", "Executor", "infer_shapes", "infer_types",
           "node_attrs", "batch_hint_from", "set_backward_mirror",
           "backward_mirror_policy", "apply_backward_mirror"]


# ---------------------------------------------------------------------------
# Remat (port of mxnet_tpu/executor.py:37-115)
# ---------------------------------------------------------------------------

_mirror_override: Optional[str] = None

# the dispatcher ops whose outputs a policy keeps: JAX's dots_saveable
# keeps dot_general and conv_general_dilated, dots_with_no_batch_dims_
# saveable the dot_generals without batch dimensions
_DOT_OPS = ("mm", "addmm", "mv", "addmv", "dot")
_BATCH_DOT_OPS = ("bmm", "baddbmm")
_CONV_OPS = ("convolution",)
_REMAT_POLICIES = {"none": None, "full": (),
                   "dots": _DOT_OPS + _BATCH_DOT_OPS + _CONV_OPS,
                   "dots_no_batch": _DOT_OPS}


def set_backward_mirror(policy: Optional[str]):
    """Select the remat policy: 'none' | 'dots' | 'dots_no_batch' |
    'full', or None to defer to ``MXNET_TPU_REMAT_POLICY`` /
    ``MXNET_BACKWARD_DO_MIRROR``."""
    global _mirror_override
    if policy is not None and policy not in _REMAT_POLICIES:
        raise ValueError("unknown remat policy %r (choose from %s)"
                         % (policy, sorted(_REMAT_POLICIES)))
    _mirror_override = policy


def backward_mirror_policy() -> str:
    """The active remat policy: the override, then
    ``MXNET_TPU_REMAT_POLICY`` (an unknown name warns and leaves remat
    off), then ``MXNET_BACKWARD_DO_MIRROR`` (any value but "0" or ""
    means 'dots')."""
    if _mirror_override is not None:
        return _mirror_override
    env = os.environ.get("MXNET_TPU_REMAT_POLICY")
    if env:
        if env not in _REMAT_POLICIES:
            warnings.warn("MXNET_TPU_REMAT_POLICY=%r is not one of %s; "
                          "remat stays off" % (env, sorted(_REMAT_POLICIES)))
            return "none"
        return env
    if os.environ.get("MXNET_BACKWARD_DO_MIRROR", "0") not in ("0", ""):
        return "dots"
    return "none"


def apply_backward_mirror(fn, policy: Optional[str] = None):
    """Wrap a forward (or loss) function of tensors so that its
    activations are recomputed in the backward per ``policy`` (None: the
    active one)."""
    return _remat_wrap(fn, policy if policy is not None
                       else backward_mirror_policy())


def _save_policy(names):
    """The selective-checkpoint policy that keeps the outputs of the
    aten ops ``names`` and recomputes every other op."""
    from torch.utils.checkpoint import CheckpointPolicy
    keep = {getattr(torch.ops.aten, n) for n in names}

    def policy(ctx, op, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE
                if getattr(op, "overloadpacket", op) in keep
                else CheckpointPolicy.PREFER_RECOMPUTE)
    return policy


def _remat_wrap(fn, policy: str, generator=None):
    """``fn`` under ``torch.utils.checkpoint.checkpoint(use_reentrant=
    False)`` per the named policy ('none' returns it unchanged; 'full'
    saves nothing; 'dots' and 'dots_no_batch' save their ops' outputs
    through selective checkpointing).  ``generator``: a
    ``torch.Generator`` that ``fn``'s random ops draw from; its state at
    the call is restored for the recompute (and its state after the
    recompute put back), so the recompute draws what the forward drew.
    ``preserve_rng_state`` covers only the default generators."""
    if policy == "none":
        return fn
    from torch.utils.checkpoint import (checkpoint,
                                        create_selective_checkpoint_contexts)
    keep = _REMAT_POLICIES[policy]
    kwargs = {}
    if keep:
        kwargs["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _save_policy(keep))

    def wrapped(*args):
        start = generator.get_state() if generator is not None else None
        ran = []

        def body(*a):
            if start is None or not ran:
                ran.append(True)
                return fn(*a)
            now = generator.get_state()
            generator.set_state(start)
            try:
                return fn(*a)
            finally:
                generator.set_state(now)
        return checkpoint(body, *args, use_reentrant=False, **kwargs)
    return wrapped


def batch_hint_from(arg_map: Dict[str, Any], arg_names: Sequence[str]):
    """Leading-dim hint used to resolve 0-dims in creation-op shapes (the
    reference begin_state convention): the 'data' arg if present, else the
    first argument that has a shape."""
    if "data" in arg_map and hasattr(arg_map["data"], "shape"):
        return arg_map["data"].shape[0]
    for n in arg_names:
        v = arg_map.get(n)
        if hasattr(v, "shape") and len(v.shape):
            return v.shape[0]
    return None


def node_attrs(node, train: bool, batch_hint, device=None):
    """Attrs for evaluating one graph node: 0-dims of a creation op's
    ``shape`` resolved against the batch hint, a creation op without a
    ``ctx`` attr made on ``device`` (the graph's), and ``_train`` set for
    a mode-dependent op."""
    attrs = node.parsed_attrs()
    if not node.inputs and device is not None and \
            attrs.get("ctx") is None:
        attrs = type(attrs)(attrs)
        attrs["_device"] = device
    if not node.inputs and 0 in (attrs.get("shape") or ()):
        if not batch_hint:
            raise ValueError(
                "creation op %r has 0-dim shape %r but no batch hint is "
                "available to resolve it (bind with a 'data' input or a "
                "shaped argument)" % (node.op.name, attrs.get("shape")))
        attrs = type(attrs)(attrs)
        attrs["shape"] = tuple(batch_hint if d == 0 else d
                               for d in attrs["shape"])
    if node.op.mode_dependent:
        attrs = type(attrs)(attrs)
        attrs["_train"] = train
    return attrs


class GraphProgram:
    """A Symbol as a function of its argument and auxiliary tensors."""

    def __init__(self, symbol: Symbol):
        self.symbol = symbol
        self.nodes = _topo_order(symbol._entries)
        self.arg_names = symbol.list_arguments()
        self.aux_names = symbol.list_auxiliary_states()
        aux_ids = symbol._aux_var_ids()
        self.var_kind: Dict[int, str] = {}
        for n in self.nodes:
            if n.is_var:
                self.var_kind[id(n)] = "aux" if id(n) in aux_ids else "arg"
        self.num_rng = sum(1 for n in self.nodes
                           if not n.is_var and n.op.needs_rng)
        # aux writeback plan: (aux_name, node, out_idx)
        self.aux_updates = []
        for n in self.nodes:
            if n.is_var or not n.op.writeback:
                continue
            for i_in, i_out in n.op.writeback_map(n.parsed_attrs()).items():
                if i_in < len(n.inputs):
                    src = n.inputs[i_in].node
                    if src.is_var and id(src) in aux_ids:
                        self.aux_updates.append((src.name, n, i_out))
        self._segs = None

    def evaluate(self, arg_arrays: Sequence, aux_arrays: Sequence,
                 train: bool = False, generator=None, remat: str = "none",
                 node_hook=None):
        """Evaluate the DAG; returns ``(outputs, new_aux)`` as tuples.
        Each ``needs_rng`` node draws from ``generator`` in topological
        order (without one, from its device's generator of
        :mod:`mxnet_tpu_torch.rng`).  ``remat`` other than "none" runs
        the nodes in checkpointed segments (the module docstring).
        ``node_hook(node, attrs, inputs)``, where given, computes each op
        node's outputs in place of ``node.op.fn`` (the ``ctx_group``
        placement, the tp trainer's sharded layers)."""
        arg_map = dict(zip(self.arg_names, arg_arrays))
        aux_map = dict(zip(self.aux_names, aux_arrays))
        batch_hint = batch_hint_from(arg_map, self.arg_names)
        device = next((a.device for a in arg_arrays
                       if isinstance(a, torch.Tensor)), None)
        val: Dict[tuple, Any] = {}
        for node in self.nodes:
            if node.is_var:
                val[(id(node), 0)] = (arg_map[node.name]
                                      if self.var_kind[id(node)] == "arg"
                                      else aux_map[node.name])
        if remat == "none":
            for node in self.nodes:
                if not node.is_var:
                    self._eval_node(node, val, train, batch_hint, generator,
                                    device, node_hook)
        else:
            for nodes, live_in, live_out, draws in self._segments():
                seg = functools.partial(self._eval_segment, nodes, live_in,
                                        live_out, train, batch_hint,
                                        generator, device, node_hook)
                outs = _remat_wrap(seg, remat,
                                   generator if draws else None)(
                    *[val[k] for k in live_in])
                val.update(zip(live_out, outs))
        outputs = tuple(val[(id(e.node), e.index)]
                        for e in self.symbol._entries)
        new_aux = list(aux_arrays)
        aux_pos = {n: i for i, n in enumerate(self.aux_names)}
        for aux_name, node, i_out in self.aux_updates:
            new_aux[aux_pos[aux_name]] = val[(id(node), i_out)]
        return outputs, tuple(new_aux)

    @staticmethod
    def _eval_node(node, val, train, batch_hint, generator, device,
                   node_hook=None):
        attrs = node_attrs(node, train, batch_hint, device)
        ins = [val[(id(e.node), e.index)] for e in node.inputs]
        if node.op.needs_rng:
            ins = [generator] + ins
        out = node.op.fn(attrs, *ins) if node_hook is None else \
            node_hook(node, attrs, ins)
        out = out if isinstance(out, tuple) else (out,)
        ann = node.attrs.get("__shard__") if node.attrs else None
        if ann is not None:
            from .placement import activation_constraint
            out = activation_constraint(out, ann, node.name)
        for i, o in enumerate(out):
            val[(id(node), i)] = o

    def _eval_segment(self, nodes, live_in, live_out, train, batch_hint,
                      generator, device, node_hook, *ins):
        val = dict(zip(live_in, ins))
        for node in nodes:
            self._eval_node(node, val, train, batch_hint, generator,
                            device, node_hook)
        return tuple(val[k] for k in live_out)

    def _segments(self):
        """The op nodes in topological order, cut into about sqrt(n)
        segments of equal length; per segment ``(nodes, live_in,
        live_out, draws)``: the (node id, output) values it reads from
        outside, those it makes that a later segment, the outputs or the
        aux writeback read, and whether it holds a random node."""
        if self._segs is not None:
            return self._segs
        ops = [n for n in self.nodes if not n.is_var]
        size = max(1, math.ceil(len(ops) / max(1, math.isqrt(len(ops)))))
        chunks = [ops[i:i + size] for i in range(0, len(ops), size)]
        owner = {id(n): c for c, chunk in enumerate(chunks) for n in chunk}
        wanted = {(id(e.node), e.index) for e in self.symbol._entries}
        wanted |= {(id(node), i) for _, node, i in self.aux_updates}
        reads = [[] for _ in chunks]
        for c, chunk in enumerate(chunks):
            for n in chunk:
                for e in n.inputs:
                    key = (id(e.node), e.index)
                    if owner.get(key[0]) != c and key not in reads[c]:
                        reads[c].append(key)
        later = set()
        segs = []
        for c in range(len(chunks) - 1, -1, -1):
            made = [(id(n), i) for n in chunks[c]
                    for i in range(n.num_outputs())]
            out = [k for k in made if k in later or k in wanted]
            segs.append((chunks[c], reads[c], out,
                         any(n.op.needs_rng for n in chunks[c])))
            later.update(reads[c])
        self._segs = segs[::-1]
        return self._segs


def _meta(shape, dtype="float32"):
    return torch.empty(tuple(shape), dtype=dtype_torch(dtype),
                       device="meta")


def _resolve_structs(symbol: Symbol, kwargs: Dict[str, Any],
                     partial=False):
    """Shape inference: walk the graph forward, filling unknown parameter
    shapes with the ``infer_params`` hooks, then each node's output
    shapes by running its op on ``meta`` tensors.  Returns ``(prog,
    known, shapes)``: ``known`` maps variable names to meta tensors,
    ``shapes`` node ids to a tuple of meta tensors (None where unknown
    under ``partial``)."""
    prog = GraphProgram(symbol)
    known: Dict[str, torch.Tensor] = {}
    for k, v in (kwargs or {}).items():
        if v is None:
            continue
        if isinstance(v, (tuple, list)):
            known[k] = _meta(v)
        elif hasattr(v, "shape") and hasattr(v, "dtype"):
            known[k] = _meta(v.shape, v.dtype)
    batch_hint = None
    for cand in ("data", "data0"):
        if cand in known:
            batch_hint = known[cand].shape[0] if known[cand].dim() else None
            break
    if batch_hint is None and known:
        first = next(iter(known.values()))
        batch_hint = first.shape[0] if first.dim() else None
    shapes: Dict[int, tuple] = {}
    with torch.no_grad():
        for node in prog.nodes:
            if node.is_var:
                if node.name in known:
                    shapes[id(node)] = (known[node.name],)
                elif "__shape__" in node.attrs:
                    shp = ast.literal_eval(str(node.attrs["__shape__"]))
                    if shp is None or any((d is None or d <= 0)
                                          for d in shp):
                        shapes[id(node)] = (None,)
                    else:
                        known[node.name] = _meta(shp, node.attrs.get(
                            "__dtype__", "float32"))
                        shapes[id(node)] = (known[node.name],)
                else:
                    shapes[id(node)] = (None,)
                continue
            # same 0-dim policy as evaluation: fail here, not at the
            # first forward, when a 0-dim cannot be resolved
            try:
                attrs = node_attrs(node, train=False, batch_hint=batch_hint,
                                   device=torch.device("meta"))
            except ValueError:
                if partial:
                    shapes[id(node)] = (None,) * node.num_outputs()
                    continue
                raise
            ins = [shapes[id(e.node)][e.index] for e in node.inputs]
            hook = getattr(node.op, "infer_params", None)
            if hook is not None and any(s is None for s in ins):
                in_shapes = [tuple(s.shape) if s is not None else None
                             for s in ins]
                try:
                    hints = hook(attrs, in_shapes)
                except (TypeError, IndexError, KeyError):
                    hints = {}     # not enough known to give the shapes
                for idx, shp in hints.items():
                    if idx < len(ins) and ins[idx] is None:
                        var_node = node.inputs[idx].node
                        dt = ins[0].dtype if ins[0] is not None \
                            else "float32"
                        ins[idx] = _meta(shp, dt)
                        if var_node.is_var:
                            known[var_node.name] = ins[idx]
                            shapes[id(var_node)] = (ins[idx],)
            if any(s is None for s in ins):
                if partial:
                    shapes[id(node)] = (None,) * node.num_outputs()
                    continue
                missing = [node.inputs[i].node.name
                           for i, s in enumerate(ins) if s is None]
                raise MXNetError(
                    "infer_shape: cannot determine shape of %s (inputs of "
                    "node %s); provide it explicitly" % (missing, node.name))
            if node.op.needs_rng:
                ins = [None] + ins    # predict mode: no draw
            out = node.op.fn(attrs, *ins)
            shapes[id(node)] = out if isinstance(out, tuple) else (out,)
    return prog, known, shapes


def infer_shapes(symbol: Symbol, kwargs, partial=False):
    """``(arg_shapes, out_shapes, aux_shapes)`` as lists of tuples (None
    where unknown under ``partial``)."""
    prog, known, shapes = _resolve_structs(symbol, kwargs, partial=partial)
    arg_shapes = [tuple(known[n].shape) if n in known else None
                  for n in prog.arg_names]
    out_shapes = []
    for e in symbol._entries:
        s = shapes[id(e.node)][e.index]
        out_shapes.append(tuple(s.shape) if s is not None else None)
    aux_shapes = [tuple(known[n].shape) if n in known else None
                  for n in prog.aux_names]
    return arg_shapes, out_shapes, aux_shapes


# ops whose output dtype follows a specific (non-first) input: lookup ops
# emit the dtype of their table, not of their integer indices
_DTYPE_FOLLOWS_INPUT = {"Embedding": 1, "take": 0, "gather_nd": 0}

# inputs pinned to a fixed dtype whatever the data's: BatchNorm keeps
# gamma/beta and the moving statistics float32 under fp16/bf16 data
_DTYPE_PINNED_INPUTS = {"BatchNorm": {1: "float32", 2: "float32",
                                      3: "float32", 4: "float32"}}


def infer_types(symbol: Symbol, kwargs):
    """``(arg_types, out_types, aux_types)`` as numpy dtypes, from the
    dtypes given by name (port of the JAX package's ``infer_types``).

    Forward propagation: a node's output dtype is its own ``dtype`` attr
    where the user set one (Cast), a creation op's ``dtype`` param, the
    table's dtype for a lookup op, else its first typed input's; an
    untyped variable input takes the node's dtype (BatchNorm's parameters
    and statistics stay float32)."""
    prog = GraphProgram(symbol)
    type_dict = {k: dtype_name(v) for k, v in (kwargs or {}).items()
                 if v is not None}
    default_dt = next(iter(type_dict.values()), "float32")
    dts: Dict[int, tuple] = {}
    for node in prog.nodes:
        if node.is_var:
            d = type_dict.get(node.name) or node.attrs.get("__dtype__")
            dts[id(node)] = (dtype_name(d) if d else None,)
            continue
        attrs = node.parsed_attrs()
        declared = node.attrs.get("dtype")
        in_dts = [dts[id(e.node)][e.index] for e in node.inputs]
        if not node.inputs:
            anchor = dtype_name(attrs.get("dtype") or default_dt)
        elif node.op.name in _DTYPE_FOLLOWS_INPUT:
            f = _DTYPE_FOLLOWS_INPUT[node.op.name]
            anchor = in_dts[f] if f < len(in_dts) and in_dts[f] is not None \
                else dtype_name(attrs.get("dtype") or "float32")
        else:
            anchor = next((d for d in in_dts if d is not None), default_dt)
        pinned = _DTYPE_PINNED_INPUTS.get(node.op.name, {})
        for i, (e, d) in enumerate(zip(node.inputs, in_dts)):
            if d is None and e.node.is_var:
                dts[id(e.node)] = (pinned.get(i, anchor),)
        out_dt = dtype_name(declared) if declared else anchor
        dts[id(node)] = (out_dt,) * node.op.num_outputs(attrs)

    def final(d, fallback):
        return np.dtype(dtype_np(d or fallback))

    by_name = {n.name: n for n in prog.nodes if n.is_var}
    return ([final(dts[id(by_name[n])][0], default_dt)
             for n in prog.arg_names],
            [final(dts[id(e.node)][e.index], default_dt)
             for e in symbol._entries],
            [final(dts[id(by_name[n])][0], "float32")
             for n in prog.aux_names])



def infer_storage_types(symbol: Symbol, kwargs):
    """``(arg_stypes, out_stypes, aux_stypes)`` as strings (port of the
    JAX package's ``infer_storage_types``; reference
    Symbol.infer_storage_type over FInferStorageType).

    Forward propagation of "default" / "row_sparse" / "csr" tags: an op
    with a ``stype_rule`` (``ops/sparse_storage.py``) declares its
    outputs' storage; any other op is a dense producer, its sparse inputs
    densified at its edge (the reference's dense fallback).  A variable
    is "default" unless given in ``kwargs`` or tagged with a
    ``__storage_type__`` attr (``Variable(stype=)``).  A sparse feed is
    densified at the executor's edge: the graph computes on dense
    tensors."""
    prog = GraphProgram(symbol)
    given = {k: v for k, v in (kwargs or {}).items() if v}
    sts: Dict[int, tuple] = {}
    for node in prog.nodes:
        if node.is_var:
            sts[id(node)] = (given.get(node.name) or
                             node.attrs.get("__storage_type__", "default"),)
            continue
        in_sts = tuple(sts[id(e.node)][e.index] for e in node.inputs)
        rule = getattr(node.op, "stype_rule", None)
        attrs = node.parsed_attrs()
        n_out = node.op.num_outputs(attrs)
        out = tuple(rule(attrs, in_sts)) if rule is not None else ()
        sts[id(node)] = out + ("default",) * (n_out - len(out))
    by_name = {n.name: n for n in prog.nodes if n.is_var}
    return ([sts[id(by_name[n])][0] for n in prog.arg_names],
            [sts[id(e.node)][e.index] for e in symbol._entries],
            [sts[id(by_name[n])][0] for n in prog.aux_names])

class Executor:
    """A Symbol bound to argument, gradient and auxiliary arrays on one
    device (reference python/mxnet/executor.py).

    ``args`` / ``args_grad`` / ``aux_states`` are NDArrays (a list in
    ``list_arguments()`` order or a dict by name).  Gradients are written
    into the bound gradient arrays in place, as ``grad_req`` says per
    argument: ``"write"`` overwrites, ``"add"`` accumulates, ``"null"``
    computes none."""

    def __init__(self, symbol, ctx, args, args_grad=None, grad_req="write",
                 aux_states=None, shared_exec=None, program=None,
                 group2ctx=None):
        self._symbol = symbol
        self._ctx = ctx if isinstance(ctx, Context) else \
            context_of(as_torch_device(ctx))
        if program is not None:
            self._prog = program
        elif shared_exec is not None and shared_exec._symbol is symbol:
            self._prog = shared_exec._prog
        else:
            self._prog = GraphProgram(symbol)
        arg_names, aux_names = self._prog.arg_names, self._prog.aux_names
        self.arg_arrays = ([args[n] for n in arg_names]
                           if isinstance(args, dict) else list(args))
        self.arg_dict = dict(zip(arg_names, self.arg_arrays))
        aux_states = aux_states or []
        self.aux_arrays = ([aux_states[n] for n in aux_names]
                           if isinstance(aux_states, dict)
                           else list(aux_states))
        self.aux_dict = dict(zip(aux_names, self.aux_arrays))
        if isinstance(grad_req, str):
            self.grad_req = {n: grad_req for n in arg_names}
        elif isinstance(grad_req, (list, tuple)):
            self.grad_req = dict(zip(arg_names, grad_req))
        else:
            self.grad_req = {n: grad_req.get(n, "null") for n in arg_names}
        if args_grad is None:
            self.grad_arrays = [None] * len(arg_names)
        elif isinstance(args_grad, dict):
            self.grad_arrays = [args_grad.get(n) for n in arg_names]
        else:
            self.grad_arrays = list(args_grad) + [None] * (
                len(arg_names) - len(args_grad))
        self.grad_dict = dict(zip(arg_names, self.grad_arrays))
        self.outputs: List = []
        self._graph = None     # (outputs, leaf names, leaves) to backward
        self._generator = None  # the needs_rng nodes' draws, made lazily
        # ctx_group placement: the graph runs segmented where a grouped
        # node maps to a context of group2ctx
        self._seg = None
        self._group2ctx = group2ctx
        if group2ctx:
            from .placement import SegmentedProgram, group_devices
            if group_devices(symbol, group2ctx):
                self._seg = SegmentedProgram(self._prog, group2ctx,
                                             self._ctx)

    # -- binding ----------------------------------------------------------
    @staticmethod
    def simple_bind(symbol, ctx, grad_req="write", type_dict=None,
                    shared_exec=None, group2ctx=None,
                    shared_arg_names=None, **kwargs):
        """Infer every argument's shape from the given input shapes and
        allocate zeroed argument, auxiliary and gradient arrays on
        ``ctx``'s device.  With ``shared_exec``, the arguments named in
        ``shared_arg_names`` (with their gradient arrays) and every
        auxiliary state are ``shared_exec``'s own NDArrays, by name, as
        the reference's ``bind_exec`` shares a bucket's parameters; its
        program is reused when the symbol is the same object."""
        if type_dict:
            kwargs = {n: (torch.empty(tuple(v), dtype=dtype_torch(
                type_dict[n]), device="meta") if n in type_dict else v)
                for n, v in kwargs.items()}
        prog, known, _ = _resolve_structs(symbol, kwargs)
        missing = [n for n in prog.arg_names if n not in known]
        if missing:
            raise MXNetError("simple_bind: could not infer shapes for %s"
                             % missing)
        if shared_exec is not None and shared_exec._symbol is symbol:
            prog = shared_exec._prog
        greq = grad_req if isinstance(grad_req, dict) else \
            {n: grad_req for n in prog.arg_names}
        shared = {}
        if shared_exec is not None:
            names = set(shared_arg_names or ())
            shared = {"argument": {n: shared_exec.arg_dict[n]
                                   for n in names
                                   if n in shared_exec.arg_dict},
                      "gradient": {n: shared_exec.grad_dict.get(n)
                                   for n in names},
                      "aux": shared_exec.aux_dict}

        def take(n, what):
            """``shared_exec``'s ``what`` array of ``n``, or a new zeroed
            one."""
            src = shared.get(what, {}).get(n)
            want = (tuple(known[n].shape), known[n].dtype)
            if src is None:
                return zeros(want[0], ctx=ctx, dtype=want[1])
            if (tuple(src.shape), src._handle.dtype) != want:
                raise MXNetError(
                    "simple_bind: shared %s %r is %s %s here and %s %s in "
                    "the shared executor" % (what, n, want[0], want[1],
                                             tuple(src.shape),
                                             src._handle.dtype))
            return src

        return Executor(
            symbol, ctx, {n: take(n, "argument") for n in prog.arg_names},
            args_grad={n: take(n, "gradient") for n in prog.arg_names
                       if greq.get(n, "null") != "null"},
            grad_req=greq,
            aux_states={n: take(n, "aux") for n in prog.aux_names},
            program=prog, group2ctx=group2ctx)

    # -- execution --------------------------------------------------------
    def _mask(self):
        return [n for n in self._prog.arg_names
                if self.grad_req.get(n, "null") != "null"]

    def _run(self, is_train, record):
        """Evaluate the graph; with ``record`` under autograd, keeping
        what :meth:`backward` needs.  Train mode rebinds each auxiliary
        array to its new state."""
        names = self._mask() if record else []
        leaves = {n: self.arg_dict[n]._handle.detach().requires_grad_()
                  for n in names}
        args = [leaves[n] if n in leaves else a._handle
                for n, a in zip(self._prog.arg_names, self.arg_arrays)]
        aux = [a._handle for a in self.aux_arrays]
        if self._prog.num_rng and self._generator is None:
            self._generator = _rng.new_generator(self._ctx.torch_device)
        with torch.set_grad_enabled(record):
            outs, new_aux = (self._seg or self._prog).evaluate(
                args, aux, train=bool(is_train), generator=self._generator,
                remat=backward_mirror_policy() if record else "none")
        self._graph = (outs, names, [leaves[n] for n in names]) \
            if record else None
        if is_train:
            # each aux array takes the op's new statistic itself, dtype
            # included (f32 moving statistics under f16 data), as the
            # reference rebinds its handle; the NDArray objects stay
            for nd_, na in zip(self.aux_arrays, new_aux):
                nd_._handle = na.detach()
        self.outputs = [NDArray(o.detach()) for o in outs]
        return self.outputs

    def forward(self, is_train=False, **kwargs):
        """Copy any ``name=array`` keyword into the bound argument, then
        evaluate; a train-mode forward records the graph for
        :meth:`backward`."""
        for k, v in kwargs.items():
            if k in self.arg_dict:
                src = v._handle if hasattr(v, "_handle") else \
                    torch.as_tensor(v)
                self.arg_dict[k]._handle.copy_(src)
        return self._run(is_train, bool(is_train) and bool(self._mask()))

    def _write_grads(self, names, grads):
        with torch.no_grad():
            for name, g in zip(names, grads):
                tgt = self.grad_dict.get(name)
                if tgt is None:
                    continue
                if self.grad_req[name] == "add":
                    if g is not None:
                        tgt._handle.add_(g)
                elif g is None:
                    tgt._handle.zero_()    # not connected to the outputs
                else:
                    tgt._handle.copy_(g)

    def backward(self, out_grads=None, is_train=True):
        """Gradients of the outputs (weighted by ``out_grads``, default
        ones) with respect to every argument whose ``grad_req`` is not
        "null", written into the gradient arrays.  Uses the graph of the
        preceding train-mode forward, else runs one."""
        if not self._mask():
            return
        if self._graph is None:
            self._run(is_train, True)
        outs, names, leaves = self._graph
        self._graph = None
        if out_grads is None:
            # a loss head ignores its incoming gradient; an expanded scalar
            # costs no memory where the output is (N*T, vocab)
            cots = [o.new_ones(()).expand_as(o) for o in outs]
        else:
            if not isinstance(out_grads, (list, tuple)):
                out_grads = [out_grads]
            cots = [g._handle.to(o.device) if hasattr(g, "_handle") else
                    torch.as_tensor(g, device=o.device)
                    for g, o in zip(out_grads, outs)]
        # an output behind BlockGrad (SSD's det_out and cls_label) has no
        # graph: it adds nothing, as its zero gradient in the reference
        live = [(o, c) for o, c in zip(outs, cots) if o.requires_grad]
        grads = torch.autograd.grad(
            [o for o, _ in live], leaves, grad_outputs=[c for _, c in live],
            allow_unused=True) if live else [None] * len(leaves)
        self._write_grads(names, grads)

    def run_fwd_bwd(self, out_cots=None, is_train=True):
        """Forward and backward in one call (the Module's step); returns
        the outputs."""
        outputs = self._run(is_train, bool(self._mask()))
        if self._graph is not None:
            self.backward(out_grads=out_cots, is_train=is_train)
        return outputs

    # -- misc -------------------------------------------------------------
    def copy_params_from(self, arg_params, aux_params=None,
                         allow_extra_params=False):
        """Copy values into the bound arrays (in place, cast to their
        dtype)."""
        with torch.no_grad():
            for src, dst, what in ((arg_params, self.arg_dict, "arguments"),
                                   (aux_params or {}, self.aux_dict, "aux")):
                for name, arr in src.items():
                    if name in dst:
                        dst[name]._handle.copy_(arr._handle)
                    elif not allow_extra_params:
                        raise MXNetError("Found name \"%s\" not in %s"
                                         % (name, what))

    def reshape(self, partial_shaping=False, allow_up_sizing=False,
                **kwargs):
        """A new executor for new input shapes.  Arrays whose shape does
        not change (the parameters, their gradients, the aux states) are
        shared with this one; the reshaped inputs get new arrays."""
        args, grads = {}, {}
        for n, arr in self.arg_dict.items():
            g = self.grad_dict.get(n)
            if n in kwargs and tuple(kwargs[n]) != arr.shape:
                args[n] = zeros(kwargs[n], ctx=self._ctx, dtype=arr.dtype)
                if g is not None:
                    grads[n] = zeros(kwargs[n], ctx=self._ctx,
                                     dtype=g.dtype)
            else:
                args[n] = arr
                if g is not None:
                    grads[n] = g
        return Executor(self._symbol, self._ctx, args, args_grad=grads,
                        grad_req=self.grad_req, aux_states=self.aux_dict,
                        program=self._prog, group2ctx=self._group2ctx)

    @property
    def ctx_group_devices(self):
        """The devices of the ``ctx_group`` segments, in order, or None
        for an executor without them."""
        if self._seg is None:
            return None
        return [seg.device for seg in self._seg.segments]

    @property
    def output_dict(self):
        """The outputs of the last forward by output name."""
        return dict(zip(self._symbol.list_outputs(), self.outputs))

    def debug_str(self):
        return self._symbol.debug_str()

    def set_monitor_callback(self, callback, monitor_all=False):
        raise NotPortedYet("executor monitor taps are not ported yet "
                           "(ROADMAP queue A item 9, observability)")
