"""Graph evaluation and shape inference (port of the evaluation half of
``mxnet_tpu/executor.py``).

:class:`GraphProgram` evaluates a Symbol's DAG op by op on torch tensors;
autograd records it, so the backward of a training step is
``torch.autograd.grad`` over its outputs.  Shape inference
(:func:`infer_shapes`) runs the same ops on ``meta`` tensors, which carry
shapes and dtypes but no data, after the ``infer_params`` hooks
(:mod:`.ops.shape_hints`) have filled in the parameter shapes the caller
did not give.  The ``Executor`` class and ``simple_bind`` come with the
Module slice (ROADMAP).
"""
from __future__ import annotations

import ast
from typing import Any, Dict, Sequence

import torch

from .base import MXNetError, dtype_torch
from .ops import shape_hints  # noqa: F401  (installs infer_params hooks)
from .symbol.symbol import Symbol, _topo_order

__all__ = ["GraphProgram", "infer_shapes", "node_attrs", "batch_hint_from"]


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


def node_attrs(node, train: bool, batch_hint):
    """Attrs for evaluating one graph node, with 0-dims of a creation op's
    ``shape`` resolved against the batch hint.  No op of the port is
    mode-dependent yet, so ``train`` changes nothing here."""
    attrs = node.parsed_attrs()
    if not node.inputs and 0 in (attrs.get("shape") or ()):
        if not batch_hint:
            raise ValueError(
                "creation op %r has 0-dim shape %r but no batch hint is "
                "available to resolve it (bind with a 'data' input or a "
                "shaped argument)" % (node.op.name, attrs.get("shape")))
        attrs = type(attrs)(attrs)
        attrs["shape"] = tuple(batch_hint if d == 0 else d
                               for d in attrs["shape"])
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

    def evaluate(self, arg_arrays: Sequence, aux_arrays: Sequence,
                 train: bool = False):
        """Evaluate the DAG; returns ``(outputs, new_aux)`` as tuples."""
        arg_map = dict(zip(self.arg_names, arg_arrays))
        aux_map = dict(zip(self.aux_names, aux_arrays))
        batch_hint = batch_hint_from(arg_map, self.arg_names)
        raw: Dict[int, tuple] = {}
        for node in self.nodes:
            if node.is_var:
                kind = self.var_kind[id(node)]
                raw[id(node)] = (arg_map[node.name] if kind == "arg"
                                 else aux_map[node.name],)
                continue
            attrs = node_attrs(node, train, batch_hint)
            ins = [raw[id(e.node)][e.index] for e in node.inputs]
            out = node.op.fn(attrs, *ins)
            raw[id(node)] = out if isinstance(out, tuple) else (out,)
        outputs = tuple(raw[id(e.node)][e.index]
                        for e in self.symbol._entries)
        new_aux = list(aux_arrays)
        aux_pos = {n: i for i, n in enumerate(self.aux_names)}
        for aux_name, node, i_out in self.aux_updates:
            new_aux[aux_pos[aux_name]] = raw[id(node)][i_out]
        return outputs, tuple(new_aux)


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
                attrs = node_attrs(node, train=False, batch_hint=batch_hint)
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
