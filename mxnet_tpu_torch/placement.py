"""The placement layer: graph annotations -> device and mesh placement
(port of ``mxnet_tpu/placement.py``).

Two placement regimes share this module, as in the JAX package:

* **SPMD** -- ``__shard__`` attrs on variables and ops resolve over the
  one named-axis mesh through :mod:`mxnet_tpu_torch.parallel.placement`
  (re-exported here: ``resolve_spec`` / ``param_sharding`` /
  ``state_sharding``).  :func:`shard_annotations` collects a graph's
  annotations; the parameter ones place the tp trainer's shards.
  :func:`activation_constraint` is the executor's hook for an op-level
  ``__shard__``: in the JAX package a ``with_sharding_constraint``, which
  changes no value; in the port, where every rank holds an activation
  whole, it checks the annotation against the current mesh with the same
  errors (unknown axis, too many dims) and leaves the activation
  replicated.  Without a current mesh it is the identity.

* **MPMD (ctx_group)** -- the reference's model parallelism by graph
  segmentation (``group2ctx`` of ``Symbol.bind``; graph_executor.cc's
  AssignContext and ``_CrossDeviceCopy``).  The port runs it in one
  process: each op node runs on its group's device (else the device of
  its first placed input, else the bind device), its inputs move there
  with ``.to(device)`` where they live elsewhere, and autograd carries the
  gradients back across the same boundaries by itself.  A
  :class:`SegmentedProgram` keeps the JAX class's ``segments`` (maximal
  topologically contiguous runs of one context, each with its
  ``.device``).  ``cpu(0)`` and ``cpu(1)`` are both the host in the port,
  as in its ``context``: they make two segments on one device.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

from .parallel.placement import (as_mesh, param_sharding, resolve_spec,
                                 state_sharding)

__all__ = ["SegmentedProgram", "group_devices", "shard_annotations",
           "activation_constraint", "resolve_spec", "param_sharding",
           "state_sharding", "as_mesh"]

_GROUP_KEYS = ("ctx_group", "__ctx_group__")


def shard_annotations(nodes) -> Tuple[Dict[str, str], Dict[str, str]]:
    """``__shard__`` annotations of a node list (e.g.
    ``GraphProgram.nodes``): ``(variables, ops)`` name -> annotation maps;
    variables place parameters, ops place activations."""
    var_anns, op_anns = {}, {}
    for node in nodes:
        ann = node.attrs.get("__shard__") if node.attrs else None
        if ann is None:
            continue
        (var_anns if node.is_var else op_anns)[node.name] = str(ann)
    return var_anns, op_anns


def activation_constraint(out, ann, name: str = ""):
    """Executor hook for an op's ``__shard__``: checked against the
    current mesh, the outputs unchanged; ``out`` itself when no mesh is
    active."""
    from .parallel import placement as _pl
    from .parallel.mesh import current_mesh
    spec = current_mesh()
    if spec is None:
        return out
    _pl.constrain_outputs(out, ann, spec.mesh, name)
    return out


def _node_group(node) -> Optional[str]:
    for k in _GROUP_KEYS:
        g = node.attrs.get(k) if node.attrs else None
        if g is not None:
            return str(g)
    return None


def group_devices(symbol, group2ctx) -> set:
    """The distinct contexts the symbol's grouped nodes map to (empty if
    no node's group is in ``group2ctx``)."""
    from .symbol.symbol import _topo_order
    out = set()
    for n in _topo_order(symbol._entries):
        g = _node_group(n)
        if g is not None and g in group2ctx:
            out.add(group2ctx[g])
    return out


class _Segment:
    __slots__ = ("ctx", "device", "nodes")

    def __init__(self, ctx):
        self.ctx = ctx
        self.device = ctx.torch_device
        self.nodes = []


class SegmentedProgram:
    """A :class:`~mxnet_tpu_torch.executor.GraphProgram` whose op nodes
    run on their ``ctx_group``'s device."""

    def __init__(self, prog, group2ctx, default_ctx):
        self.prog = prog
        g2c = dict(group2ctx or {})
        # op nodes: their group's context, else that of their first placed
        # input (propagation), else the bind context (the PlaceDevice pass)
        ctx_of: Dict[int, object] = {}
        for node in prog.nodes:
            if node.is_var:
                continue
            g = _node_group(node)
            if g is not None and g in g2c:
                ctx_of[id(node)] = g2c[g]
                continue
            ctx_of[id(node)] = next(
                (ctx_of[id(e.node)] for e in node.inputs
                 if id(e.node) in ctx_of), default_ctx)
        self.ctx_of = ctx_of
        self.segments = []
        for node in prog.nodes:
            if node.is_var:
                continue
            c = ctx_of[id(node)]
            if not self.segments or self.segments[-1].ctx != c:
                self.segments.append(_Segment(c))
            self.segments[-1].nodes.append(node)
        self._device_of = {id(n): s.device for s in self.segments
                           for n in s.nodes}

    def _hook(self, node, attrs, ins):
        """Run ``node`` on its segment's device, its inputs moved there."""
        import torch
        dev = self._device_of[id(node)]
        ins = [x.to(dev) if isinstance(x, torch.Tensor) and x.device != dev
               else x for x in ins]
        if not node.inputs and attrs.get("ctx") is None:
            attrs = type(attrs)(attrs)
            attrs["_device"] = dev
        return node.op.fn(attrs, *ins)

    def evaluate(self, arg_arrays, aux_arrays, train=False, generator=None,
                 remat="none"):
        """:meth:`GraphProgram.evaluate`, each node on its device; the
        outputs and the new aux states stay where their nodes ran."""
        return self.prog.evaluate(arg_arrays, aux_arrays, train=train,
                                  generator=generator, remat=remat,
                                  node_hook=self._hook)
