"""Symbol — the declarative graph IR (port of
``mxnet_tpu/symbol/symbol.py``; reference python/mxnet/symbol/symbol.py
over nnvm::Symbol/Graph).

The graph is a DAG of ``Node{op, inputs: [NodeEntry], attrs, name}``; a
Symbol is a list of NodeEntry (multi-output).  The executor
(:mod:`mxnet_tpu_torch.executor`) evaluates the DAG op by op on torch
tensors: shape inference runs the ops on ``meta`` tensors, and gradients
are autograd over the evaluation.  The JSON format is shared with the JAX
package: :meth:`Symbol.tojson` writes the same text, byte for byte, and
:func:`load_json` reads either package's output.
"""
from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Sequence

from ..base import AttrScope, MXNetError, NotPortedYet, _Null, dtype_name
from ..name import NameManager
from ..ops.registry import AttrDict, Operator, get_op

__all__ = ["Symbol", "Variable", "var", "Group", "create", "load",
           "load_json"]


class Node:
    __slots__ = ("op", "inputs", "attrs", "name", "_parsed")

    def __init__(self, op: Optional[Operator], inputs: List["NodeEntry"],
                 attrs: Dict[str, Any], name: str):
        self.op = op            # None for variables
        self.inputs = inputs
        self.attrs = attrs      # raw attrs (strings or python values)
        self.name = name
        self._parsed: Optional[AttrDict] = None

    @property
    def is_var(self) -> bool:
        return self.op is None

    def parsed_attrs(self) -> AttrDict:
        if self._parsed is None:
            kwargs = {k: v for k, v in self.attrs.items()
                      if not k.startswith("__")}
            self._parsed = self.op.parse_attrs(kwargs)
        return self._parsed

    def num_outputs(self) -> int:
        if self.is_var:
            return 1
        return self.op.num_outputs(self.parsed_attrs())

    def num_visible_outputs(self) -> int:
        if self.is_var:
            return 1
        return self.op.num_visible_outputs(self.parsed_attrs())


class NodeEntry(tuple):
    """(node, output_index)"""

    def __new__(cls, node, index=0):
        return super().__new__(cls, (node, index))

    @property
    def node(self) -> Node:
        return self[0]

    @property
    def index(self) -> int:
        return self[1]


def _topo_order(entries: Sequence[NodeEntry]) -> List[Node]:
    order: List[Node] = []
    seen = set()

    def visit(node: Node):
        if id(node) in seen:
            return
        seen.add(id(node))
        for e in node.inputs:
            visit(e.node)
        order.append(node)

    for e in entries:
        visit(e.node)
    return order


class Symbol:
    __slots__ = ("_entries",)

    def __init__(self, entries: Sequence[NodeEntry]):
        self._entries = list(entries)

    # -- graph structure -------------------------------------------------
    @property
    def name(self) -> Optional[str]:
        if len(self._entries) == 1:
            return self._entries[0].node.name
        return None

    def __iter__(self):
        for i in range(len(self.list_outputs())):
            yield self[i]

    def __len__(self):
        return len(self.list_outputs())

    def __getitem__(self, index):
        if isinstance(index, str):
            outputs = self.list_outputs()
            if index not in outputs:
                raise MXNetError("Cannot find output %s" % index)
            index = outputs.index(index)
        return Symbol([self._entries[index]])

    def __repr__(self):
        return "<Symbol %s>" % (self.name or "Grouped")

    def list_arguments(self) -> List[str]:
        aux = self._aux_var_ids()
        return [n.name for n in _topo_order(self._entries)
                if n.is_var and id(n) not in aux]

    def list_auxiliary_states(self) -> List[str]:
        aux = self._aux_var_ids()
        return [n.name for n in _topo_order(self._entries)
                if n.is_var and id(n) in aux]

    def _aux_var_ids(self) -> set:
        aux = set()
        for node in _topo_order(self._entries):
            if node.is_var:
                continue
            for i in node.op.aux_input_indices(node.parsed_attrs()):
                if i < len(node.inputs) and node.inputs[i].node.is_var:
                    aux.add(id(node.inputs[i].node))
        return aux

    def list_outputs(self) -> List[str]:
        names = []
        for e in self._entries:
            node = e.node
            if node.is_var:
                names.append(node.name)
            elif node.num_visible_outputs() == 1:
                names.append(node.name + "_output")
            else:
                names.append("%s_output%d" % (node.name, e.index))
        return names

    def get_internals(self) -> "Symbol":
        entries = []
        for node in _topo_order(self._entries):
            for i in range(node.num_visible_outputs()):
                entries.append(NodeEntry(node, i))
        return Symbol(entries)

    # -- attrs -----------------------------------------------------------
    def attr(self, key: str) -> Optional[str]:
        v = self._entries[0].node.attrs.get(key)
        return str(v) if v is not None else None

    # -- composition: the arithmetic the ported graphs use ---------------
    def attr_dict(self) -> Dict[str, Dict[str, str]]:
        """``{node name: {attr: value}}`` for every node that has attrs
        (the ``__lr_mult__`` / ``__wd_mult__`` / ``__init__`` the
        optimizer and the initializer read)."""
        return {node.name: {k: str(v) for k, v in node.attrs.items()}
                for node in _topo_order(self._entries) if node.attrs}

    def __add__(self, other):
        if not isinstance(other, Symbol):
            raise MXNetError("Symbol + %r: only Symbol + Symbol "
                             "(broadcast_add) is ported" % (other,))
        return create("broadcast_add", [self, other], {})

    def __radd__(self, other):
        if not isinstance(other, Symbol):
            raise MXNetError("%r + Symbol: only Symbol + Symbol "
                             "(broadcast_add) is ported" % (other,))
        return create("broadcast_add", [other, self], {})

    def __hash__(self):
        return id(self)

    # -- inference -------------------------------------------------------
    def infer_shape(self, *args, **kwargs):
        """(arg_shapes, out_shapes, aux_shapes) from the shapes given by
        position (argument order) or by name."""
        return self._infer_shape_impl(False, *args, **kwargs)

    def infer_shape_partial(self, *args, **kwargs):
        return self._infer_shape_impl(True, *args, **kwargs)

    def _infer_shape_impl(self, partial, *args, **kwargs):
        from ..executor import infer_shapes
        if args:
            kwargs = dict(zip(self.list_arguments(), args))
            kwargs = {k: v for k, v in kwargs.items() if v is not None}
        return infer_shapes(self, kwargs, partial=partial)

    # -- serialization ---------------------------------------------------
    def tojson(self) -> str:
        nodes_list = _topo_order(self._entries)
        node_id = {id(n): i for i, n in enumerate(nodes_list)}
        nodes = []
        arg_nodes = []
        for i, n in enumerate(nodes_list):
            if n.is_var:
                arg_nodes.append(i)
            nodes.append({
                "op": "null" if n.is_var else n.op.name,
                "name": n.name,
                "attrs": {k: str(v) for k, v in n.attrs.items()},
                "inputs": [[node_id[id(e.node)], e.index, 0]
                           for e in n.inputs],
            })
        heads = [[node_id[id(e.node)], e.index, 0] for e in self._entries]
        return json.dumps({"nodes": nodes, "arg_nodes": arg_nodes,
                           "node_row_ptr": [], "heads": heads,
                           "attrs": {"mxnet_version": ["int", 10100]}},
                          indent=2)

    def save(self, fname: str):
        with open(fname, "w") as f:
            f.write(self.tojson())


def load_json(json_str: str) -> Symbol:
    data = json.loads(json_str)
    nodes: List[Node] = []
    for spec in data["nodes"]:
        attrs = dict(spec.get("attrs", spec.get("param", {})) or {})
        inputs = [NodeEntry(nodes[nid], idx)
                  for nid, idx, *_ in spec["inputs"]]
        if spec["op"] == "null":
            nodes.append(Node(None, [], attrs, spec["name"]))
        else:
            nodes.append(Node(get_op(spec["op"]), inputs, attrs,
                              spec["name"]))
    heads = [NodeEntry(nodes[nid], idx) for nid, idx, *_ in data["heads"]]
    return Symbol(heads)


def load(fname: str) -> Symbol:
    with open(fname) as f:
        return load_json(f.read())


def Variable(name: str, attr=None, shape=None, lr_mult=None, wd_mult=None,
             dtype=None, init=None, stype=None, **kwargs) -> Symbol:
    if not isinstance(name, str):
        raise TypeError("Expect a string for variable name")
    attrs = AttrScope.current().get(attr)
    if shape is not None:
        attrs["__shape__"] = str(tuple(shape))
    if dtype is not None:
        attrs["__dtype__"] = dtype_name(dtype)
    if lr_mult is not None:
        attrs["__lr_mult__"] = str(lr_mult)
    if wd_mult is not None:
        attrs["__wd_mult__"] = str(wd_mult)
    if init is not None:
        attrs["__init__"] = init if isinstance(init, str) else init.dumps()
    if stype is not None:
        attrs["__storage_type__"] = str(stype)
    attrs.update({k: str(v) for k, v in kwargs.items()})
    return Symbol([NodeEntry(Node(None, [], attrs, name), 0)])


var = Variable


def Group(symbols: Sequence[Symbol]) -> Symbol:
    entries = []
    for s in symbols:
        entries.extend(s._entries)
    return Symbol(entries)


def create(op_name: str, input_syms: Sequence[Symbol],
           kwargs: Dict[str, Any], name: Optional[str] = None) -> Symbol:
    """Build a graph node applying ``op_name`` (the symbol-side
    ``invoke``): positional Symbols fill the op's inputs in order, Symbol
    kwargs by name, and a missing input becomes a variable named
    ``<node name>_<input name>``."""
    op = get_op(op_name)
    if op.needs_rng:
        raise NotPortedYet("%s: random ops inside a Symbol graph are not "
                           "ported yet (ROADMAP A3); use mx.nd.random"
                           % op_name)
    kwargs = {k: v for k, v in kwargs.items()
              if v is not None and v is not _Null}
    attr = kwargs.pop("attr", None)
    name = kwargs.pop("name", name)

    sym_kwargs = {}
    for k in list(kwargs):
        if isinstance(kwargs[k], Symbol):
            sym_kwargs[k] = kwargs.pop(k)
    # a variadic op (add_n, Concat, stack, khatri_rao) counts its inputs
    if op.variadic and "num_args" not in kwargs:
        kwargs["num_args"] = len(input_syms) + len(sym_kwargs)

    name = NameManager.current().get(name, op.name.lower().lstrip("_"))
    attrs = dict(kwargs)
    input_names = op.list_inputs(op.parse_attrs(attrs))

    entries: List[NodeEntry] = []
    pos_list = [e for s in input_syms for e in s._entries]
    pos_i = 0
    for in_name in input_names:
        if in_name in sym_kwargs:
            entries.append(sym_kwargs[in_name]._entries[0])
        elif pos_i < len(pos_list):
            entries.append(pos_list[pos_i])
            pos_i += 1
        else:
            entries.append(Variable("%s_%s" % (name, in_name))._entries[0])
    entries.extend(pos_list[pos_i:])

    attrs.update(AttrScope.current().get(attr))
    node = Node(op, entries, attrs, name)
    return Symbol([NodeEntry(node, i)
                   for i in range(node.num_visible_outputs())])
