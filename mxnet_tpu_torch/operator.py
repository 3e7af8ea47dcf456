"""CustomOp: operators written in Python, usable from ``mx.nd``, Symbol
graphs, ``Module`` and Gluon (port of ``mxnet_tpu/operator.py``;
reference python/mxnet/operator.py: CustomOp :422, CustomOpProp :468,
register :602, over src/operator/custom/custom.cc).

The JAX package calls back to the host from its traced program
(``jax.pure_callback``) and wires the user's ``backward`` in with
``jax.custom_vjp`` (``mxnet_tpu/operator.py:218-262``).  Here the
``Custom`` op is a ``torch.autograd.Function``: its forward runs the
user's ``CustomOp.forward`` on NDArrays over the op's tensors, on their
device (inside ``with`` their context, recording paused), and its
backward runs the user's ``backward`` on NDArrays over the incoming
gradients.  The same node serves the imperative path (``mx.nd.Custom``
under ``autograd.record``) and a graph (``Executor``, ``Module``), whose
backward is torch's over the graph.

As in the reference, ``register`` stores the prop class, each distinct
set of attrs makes one ``CustomOpProp`` (every attr reaches the prop's
constructor as a string) and each input signature one ``CustomOp``
(``create_operator``), which serves every forward and backward at that
signature, so a user op may keep state on ``self`` between them.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from .base import MXNetError, dtype_name, dtype_np, dtype_torch
from .ops.registry import AttrDict, Operator, _REGISTRY

__all__ = ["CustomOp", "CustomOpProp", "register",
           "get_all_registered_operators"]


class CustomOp(object):
    """Base class of a user operator (reference operator.py:422):
    override ``forward`` and ``backward``, which take and write NDArrays;
    write results with :meth:`assign`."""

    def forward(self, is_train, req, in_data, out_data, aux):
        """Compute ``out_data``; ``req`` is 'null', 'write' or 'add' per
        output."""
        raise NotImplementedError()

    def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
        """Compute ``in_grad`` (honouring ``req``)."""
        raise NotImplementedError()

    def assign(self, dst, req, src):
        """Write ``src`` into ``dst`` as ``req`` says."""
        if req == "null":
            return
        if req in ("write", "inplace"):
            dst[:] = src
        elif req == "add":
            dst[:] = dst + src
        else:
            raise MXNetError("invalid req %r" % (req,))


class CustomOpProp(object):
    """A user operator's metadata (reference operator.py:468): its
    argument, output and aux names, shape and type inference, and the
    factory of its :class:`CustomOp`."""

    def __init__(self, need_top_grad=True):
        self.need_top_grad_ = need_top_grad

    def infer_shape(self, in_shape):
        """Default: every output and aux shaped like the first input."""
        return in_shape, [in_shape[0]] * len(self.list_outputs()), \
            [in_shape[0]] * len(self.list_auxiliary_states())

    def infer_type(self, in_type):
        """Default: every output and aux of the first input's dtype."""
        return in_type, [in_type[0]] * len(self.list_outputs()), \
            [in_type[0]] * len(self.list_auxiliary_states())

    def list_outputs(self):
        return ["output"]

    def list_arguments(self):
        return ["data"]

    def list_auxiliary_states(self):
        return []

    def need_top_grad(self):
        return self.need_top_grad_

    def declare_backward_dependency(self, out_grad, in_data, out_data):
        """Kept for the API: the backward always receives the inputs, the
        outputs and (with ``need_top_grad``) the output gradients."""
        deps = []
        if self.need_top_grad_:
            deps.extend(out_grad)
        deps.extend(in_data)
        deps.extend(out_data)
        return deps

    def create_operator(self, ctx, in_shapes, in_dtypes):
        return CustomOp()


_PROP_CLASSES: Dict[str, type] = {}

# attrs that are plumbing, not the user's kwargs for the prop
_RESERVED = ("op_type", "num_args", "_train", "_device")


def register(reg_name):
    """Decorator registering a :class:`CustomOpProp` subclass as
    ``reg_name``, reachable as ``mx.nd.Custom(..., op_type=reg_name)`` and
    ``mx.sym.Custom(..., op_type=reg_name)`` (reference operator.py:602)."""

    def do_register(prop_cls):
        if not issubclass(prop_cls, CustomOpProp):
            raise MXNetError(
                "register('%s') expects a CustomOpProp subclass" % reg_name)
        _PROP_CLASSES[reg_name] = prop_cls
        return prop_cls

    return do_register


def get_all_registered_operators() -> List[str]:
    return sorted(_PROP_CLASSES)


class _CustomState(object):
    """One prop per set of attrs, and one CustomOp per input signature."""

    __slots__ = ("prop", "ops", "arg_names", "aux_names", "out_names")

    def __init__(self, attrs: AttrDict):
        op_type = attrs.get("op_type")
        try:
            prop_cls = _PROP_CLASSES[op_type]
        except KeyError:
            raise MXNetError(
                "Custom op type %r is not registered (known: %s)"
                % (op_type, get_all_registered_operators())) from None
        self.prop = prop_cls(**_user_kwargs(attrs))
        self.ops: Dict[Tuple, CustomOp] = {}
        self.arg_names = list(self.prop.list_arguments())
        self.aux_names = list(self.prop.list_auxiliary_states())
        self.out_names = list(self.prop.list_outputs())

    def operator_for(self, ctx, in_shapes, in_dtypes) -> CustomOp:
        key = (tuple(map(tuple, in_shapes)), tuple(map(str, in_dtypes)),
               ctx)
        if key not in self.ops:
            self.ops[key] = self.prop.create_operator(
                ctx, [list(s) for s in in_shapes], list(in_dtypes))
        return self.ops[key]

    def out_structs(self, in_shapes, in_dtypes):
        """``[(shape, torch dtype)]`` of the outputs, from the prop."""
        n = len(self.arg_names)
        _, shapes, _ = self.prop.infer_shape([list(s)
                                              for s in in_shapes[:n]])
        _, types, _ = self.prop.infer_type(list(in_dtypes[:n]))
        return [(tuple(int(d) for d in s), dtype_torch(dtype_name(t)))
                for s, t in zip(shapes, types)]


def _user_kwargs(attrs):
    return {k: v for k, v in attrs.items()
            if k not in _RESERVED and not k.startswith("__")}


_STATE_CACHE: Dict[Tuple, _CustomState] = {}


def _state_for(attrs: AttrDict) -> _CustomState:
    if attrs.get("op_type") is None:
        raise MXNetError("Custom op requires an op_type= attribute")
    key = (attrs["op_type"],) + tuple(sorted(
        (k, str(v)) for k, v in _user_kwargs(attrs).items()))
    if key not in _STATE_CACHE:
        _STATE_CACHE[key] = _CustomState(attrs)
    return _STATE_CACHE[key]


class _CustomFunction(torch.autograd.Function):
    """The Custom node: the user's forward and backward on NDArrays over
    the node's tensors, in their device's context, recording paused."""

    @staticmethod
    def forward(ctx, state, is_train, *tensors):
        from . import autograd as _ag
        from .context import context_of
        from .ndarray.ndarray import NDArray
        n_args = len(state.arg_names)
        in_shapes = [tuple(t.shape) for t in tensors]
        in_dtypes = [dtype_np(dtype_name(t.dtype)) for t in tensors]
        device = tensors[0].device if tensors else torch.device("cpu")
        mx_ctx = context_of(device)
        cop = state.operator_for(mx_ctx, in_shapes, in_dtypes)
        outs = [torch.zeros(s, dtype=dt, device=device)
                for s, dt in state.out_structs(in_shapes, in_dtypes)]
        with mx_ctx, _ag.pause(train_mode=is_train):
            in_data = [NDArray(t) for t in tensors[:n_args]]
            aux = [NDArray(t) for t in tensors[n_args:]]
            out_data = [NDArray(o) for o in outs]
            cop.forward(is_train, ["write"] * len(outs), in_data, out_data,
                        aux)
        outs = [o._handle for o in out_data]
        ctx.state, ctx.cop, ctx.mx_ctx, ctx.n_args = (state, cop, mx_ctx,
                                                      n_args)
        ctx.save_for_backward(*tensors, *outs)
        ctx.n_in = len(tensors)
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        from . import autograd as _ag
        from .ndarray.ndarray import NDArray
        saved = ctx.saved_tensors
        tensors, outs = saved[:ctx.n_in], saved[ctx.n_in:]
        n_args = ctx.n_args
        with ctx.mx_ctx, _ag.pause():
            in_data = [NDArray(t.detach()) for t in tensors[:n_args]]
            aux = [NDArray(t.detach()) for t in tensors[n_args:]]
            out_data = [NDArray(o.detach()) for o in outs]
            out_grad = [NDArray(g.contiguous()) for g in grads] \
                if ctx.state.prop.need_top_grad() else []
            in_grad = [NDArray(torch.zeros_like(t._handle)) for t in in_data]
            ctx.cop.backward(["write"] * n_args, out_grad, in_data,
                             out_data, in_grad, aux)
        res = []
        for i, t in enumerate(tensors):
            if i < n_args and ctx.needs_input_grad[i + 2] \
                    and (t.is_floating_point() or t.is_complex()):
                res.append(in_grad[i]._handle.to(t.dtype))
            else:
                res.append(None)  # aux states and integer inputs
        return (None, None) + tuple(res)


def _custom_fn(attrs: AttrDict, *tensors):
    state = _state_for(attrs)
    n_in = len(state.arg_names) + len(state.aux_names)
    if len(tensors) != n_in:
        raise MXNetError(
            "Custom op %s expects %d inputs (%s) + %d aux (%s), got %d"
            % (attrs.get("op_type"), len(state.arg_names), state.arg_names,
               len(state.aux_names), state.aux_names, len(tensors)))
    if any(t.is_meta for t in tensors):
        # shape inference: the prop's shapes and types, no call
        outs = tuple(torch.empty(s, dtype=dt, device="meta")
                     for s, dt in state.out_structs(
                         [tuple(t.shape) for t in tensors],
                         [dtype_np(dtype_name(t.dtype)) for t in tensors]))
    else:
        outs = _CustomFunction.apply(state, bool(attrs.get("_train", False)),
                                     *tensors)
    return outs if len(outs) > 1 else outs[0]


def _custom_infer_params(attrs, in_shapes):
    """The argument and aux shapes the prop infers from the known ones
    (the label's from the data's)."""
    state = _state_for(attrs)
    n = len(state.arg_names)
    try:
        args, _, aux = state.prop.infer_shape([list(s) if s is not None
                                               else None
                                               for s in in_shapes[:n]])
    except (TypeError, IndexError, KeyError, ValueError):
        return {}         # the prop needs shapes that are not known yet
    return {i: tuple(s) for i, s in enumerate(list(args) + list(aux))
            if s is not None and i < len(in_shapes)
            and in_shapes[i] is None}


class _CustomOperator(Operator):
    """A registry operator with an open attribute schema: every kwarg
    reaches the user's prop constructor as a string (the reference's
    key/value marshalling, custom.cc CustomOpParam)."""

    def aux_input_indices(self, attrs: Optional[AttrDict] = None):
        if attrs is None or "op_type" not in attrs:
            return ()
        st = _state_for(attrs)
        n = len(st.arg_names)
        return tuple(range(n, n + len(st.aux_names)))

    def parse_attrs(self, kwargs: Dict[str, Any]) -> AttrDict:
        out = AttrDict()
        for k, v in kwargs.items():
            if k in ("name", "ctx", "dtype_out", "ctx_group") \
                    or k.startswith("__"):
                continue
            out[k] = v if k in ("num_args", "_train", "_device") \
                or isinstance(v, str) else str(v)
        if "op_type" not in out:
            raise MXNetError("Custom op requires op_type=")
        return out


def _custom_inputs(attrs: Optional[AttrDict]) -> List[str]:
    if attrs is None or "op_type" not in attrs:
        return ["data"]
    st = _state_for(attrs)
    return st.arg_names + st.aux_names


def _custom_num_outputs(attrs: Optional[AttrDict]) -> int:
    if attrs is None or "op_type" not in attrs:
        return 1
    return len(_state_for(attrs).out_names)


_REGISTRY["Custom"] = _CustomOperator(
    "Custom", _custom_fn, params={}, inputs=_custom_inputs,
    num_outputs=_custom_num_outputs, mode_dependent=True,
    doc="Apply a registered CustomOp (reference src/operator/custom/).")
_REGISTRY["Custom"].infer_params = _custom_infer_params
_REGISTRY["_Custom"] = _REGISTRY["Custom"]
