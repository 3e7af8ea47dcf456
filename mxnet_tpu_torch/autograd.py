"""Imperative autograd (port of ``mxnet_tpu/autograd.py``; reference
include/mxnet/imperative.h, python/mxnet/autograd.py).

The JAX package keeps a tape of (jitted op, inputs, outputs) and walks it
backward with ``jax.vjp``.  Here torch's own autograd is the tape: while
:func:`record` is on, :func:`~mxnet_tpu_torch.ndarray.ndarray.
imperative_invoke` runs each op with grad enabled, and a marked
variable (``attach_grad``, :func:`mark_variables`) enters an op as its
leaf tensor, a ``requires_grad`` alias of its storage made the first
time it is recorded and kept while its handle is the same tensor.  So the
optimizer's in-place updates of a parameter reach its leaf, and the
leaf's gradient is the parameter's.

:func:`backward` runs ``torch.autograd.grad`` from the heads to the
leaves of every live marked variable and writes each gradient into the
variable's ``.grad`` buffer, cast to its dtype, by its ``grad_req``
("write" copies, "add" accumulates), as the JAX package's
``_flush_grads`` does (``mxnet_tpu/autograd.py:194-210``).  Where torch's
defaults differ from the JAX package, the JAX package's semantics hold:

* the graph is kept (``retain_graph=True``), so a second ``backward``
  over the same recording gives the same gradients; it is freed when the
  NDArrays that hold it die;
* a write into an array that a recording used (``x[:] = v``, ``x += v``)
  rebinds the array to a written copy, so the recorded graph keeps the
  old values; the old leaf's gradient still reaches the variable's
  buffer (:meth:`~mxnet_tpu_torch.ndarray.ndarray.NDArray.__setitem__`);
* ``backward`` on a head that was not recorded raises nothing and
  leaves every buffer as it was.

Recording and training are flags of the calling thread, as in the
reference.
"""
from __future__ import annotations

import threading
import weakref
from typing import Dict, List

import torch

from .base import MXNetError

__all__ = ["record", "pause", "train_mode", "predict_mode", "is_recording",
           "is_training", "set_recording", "set_training", "mark_variables",
           "backward", "grad", "get_symbol", "Function"]


class _State(threading.local):
    def __init__(self):
        self.recording = False
        self.training = False


_state = _State()


def is_recording() -> bool:
    return _state.recording


def is_training() -> bool:
    return _state.training


def set_recording(is_record: bool) -> bool:
    prev, _state.recording = _state.recording, bool(is_record)
    return prev


def set_training(train_mode_: bool) -> bool:
    prev, _state.training = _state.training, bool(train_mode_)
    return prev


class _RecordingStateScope:
    """Sets the thread's recording and training flags for a ``with``
    block and puts the old ones back after it (None leaves a flag)."""

    def __init__(self, is_record, train_mode_):
        self._enter_is_record = is_record
        self._enter_train_mode = train_mode_
        self._prev_is_record = None
        self._prev_train_mode = None

    def __enter__(self):
        if self._enter_is_record is not None:
            self._prev_is_record = set_recording(self._enter_is_record)
        if self._enter_train_mode is not None:
            self._prev_train_mode = set_training(self._enter_train_mode)
        return self

    def __exit__(self, *args):
        if self._enter_is_record is not None:
            set_recording(self._prev_is_record)
        if self._enter_train_mode is not None:
            set_training(self._prev_train_mode)


def record(train_mode: bool = True):
    """``with autograd.record():`` records the ops for :func:`backward`
    (train mode by default)."""
    return _RecordingStateScope(True, train_mode)


def pause(train_mode: bool = False):
    return _RecordingStateScope(False, train_mode)


def train_mode():
    return _RecordingStateScope(None, True)


def predict_mode():
    return _RecordingStateScope(None, False)


# ---------------------------------------------------------------------------
# marked variables
# ---------------------------------------------------------------------------

class _AGInfo:
    """A marked variable's gradient buffer and request, its current leaf
    (made from ``leaf_src``, the handle it aliases) and weak references to
    the leaves of its earlier handles, which recorded graphs may still
    hold."""

    __slots__ = ("grad", "grad_req", "leaf", "leaf_src", "old_leaves")

    def __init__(self, grad, grad_req):
        self.grad = grad
        self.grad_req = grad_req
        self.leaf = None
        self.leaf_src = None
        self.old_leaves: List[weakref.ref] = []


# id(NDArray) -> weakref: every live marked variable.  Re-entrant: a
# collection that runs while the lock is held (any allocation may start
# one) calls ``_forget``'s callbacks on the same thread.
_marked: Dict[int, weakref.ref] = {}
_marked_lock = threading.RLock()


def _forget(key):
    def drop(_ref):
        with _marked_lock:
            _marked.pop(key, None)
    return drop


def _differentiable(t) -> bool:
    return t.is_floating_point() or t.is_complex()


def mark_variables(variables, gradients, grad_reqs="write"):
    """Mark NDArrays as variables to differentiate, with ``gradients`` as
    their buffers (reference autograd.py:216)."""
    from .ndarray.ndarray import NDArray
    if isinstance(variables, NDArray):
        variables, gradients = [variables], [gradients]
    if isinstance(grad_reqs, str):
        grad_reqs = [grad_reqs] * len(variables)
    for var, g, req in zip(variables, gradients, grad_reqs):
        if req not in ("write", "add", "null"):
            raise MXNetError("grad_req must be 'write', 'add' or 'null', "
                             "got %r" % (req,))
        if req == "null":
            var._ag = None
            continue
        var._ag = _AGInfo(g, req)
        key = id(var)
        ref = weakref.ref(var, _forget(key))
        with _marked_lock:
            _marked[key] = ref


def _leaf_of(nd):
    """The tensor a recording op reads for ``nd``: a marked variable's
    leaf (a new one when its handle was rebound since the last), else its
    handle."""
    info = nd._ag
    t = nd._handle
    if info is None or not _differentiable(t):
        return t
    if info.leaf is None or info.leaf_src is not t:
        if info.leaf is not None:
            info.old_leaves = [r for r in info.old_leaves
                               if r() is not None]
            info.old_leaves.append(weakref.ref(info.leaf))
        info.leaf = t.detach().requires_grad_(True)
        info.leaf_src = t
    return info.leaf


def _variable_leaves(nd):
    info = nd._ag
    leaves = [r() for r in info.old_leaves]
    if info.leaf is not None:
        leaves.append(info.leaf)
    return [t for t in leaves if t is not None]


def _head_tensor(h):
    return _leaf_of(h) if h._ag is not None else h._handle


def _cotangent(g, like):
    from .ndarray.ndarray import NDArray
    if g is None:
        return torch.ones_like(like)
    t = g._handle if isinstance(g, NDArray) else torch.as_tensor(g)
    return t.detach().to(like.device, like.dtype)


def _as_lists(heads, head_grads):
    from .ndarray.ndarray import NDArray
    if isinstance(heads, NDArray):
        heads = [heads]
        if head_grads is not None and not isinstance(head_grads,
                                                     (list, tuple)):
            head_grads = [head_grads]
    heads = list(heads)
    if head_grads is None:
        head_grads = [None] * len(heads)
    return heads, list(head_grads)


def _run_grad(heads, head_grads, inputs, create_graph=False):
    """``torch.autograd.grad`` of the recorded heads w.r.t. ``inputs``
    (None where a head is not recorded or an input is not reached), with
    the graph kept."""
    outs, cots = [], []
    for h, g in zip(heads, head_grads):
        t = _head_tensor(h)
        if t.requires_grad:
            outs.append(t)
            cots.append(_cotangent(g, t))
    if not outs or not inputs:
        return [None] * len(inputs)
    return list(torch.autograd.grad(outs, inputs, grad_outputs=cots,
                                    retain_graph=True,
                                    create_graph=create_graph,
                                    allow_unused=True))


def backward(heads, head_grads=None, retain_graph=False, train_mode=True):
    """Gradients of ``heads`` (weighted by ``head_grads``, default ones)
    w.r.t. every marked variable they were recorded from, written into
    the variables' buffers (reference autograd.py:243).  The graph is
    kept whatever ``retain_graph`` says, as in the JAX package."""
    heads, head_grads = _as_lists(heads, head_grads)
    with _marked_lock:
        variables = [r() for r in list(_marked.values())]
    variables = [v for v in variables if v is not None and v._ag is not None]
    per_var = [_variable_leaves(v) for v in variables]
    flat = [t for leaves in per_var for t in leaves]
    grads = _run_grad(heads, head_grads, flat)
    pos = 0
    with torch.no_grad():
        for v, leaves in zip(variables, per_var):
            got = [g for g in grads[pos:pos + len(leaves)] if g is not None]
            pos += len(leaves)
            if not got:
                continue
            total = got[0]
            for g in got[1:]:
                total = total + g
            _flush(v._ag, total)


def _flush(info, g):
    buf = info.grad
    if buf is None:
        return
    g = g.to(buf._handle.dtype)
    if info.grad_req == "add":
        buf._handle.add_(g)
    else:
        buf._handle.copy_(g)


def grad(heads, variables, head_grads=None, retain_graph=None,
         create_graph=False, train_mode=True):
    """The gradients of ``heads`` w.r.t. ``variables`` as new NDArrays
    (zeros where a variable is not reached), leaving every buffer as it
    is (reference autograd.py:270)."""
    from .ndarray.ndarray import NDArray
    single = isinstance(variables, NDArray)
    if single:
        variables = [variables]
    heads, head_grads = _as_lists(heads, head_grads)
    for v in variables:
        if v._ag is None:
            raise MXNetError("grad: a variable was not marked "
                             "(attach_grad or mark_variables)")
    per_var = [_variable_leaves(v) for v in variables]
    flat = [t for leaves in per_var for t in leaves]
    grads = _run_grad(heads, head_grads, flat, create_graph=create_graph)
    out, pos = [], 0
    for v, leaves in zip(variables, per_var):
        got = [g for g in grads[pos:pos + len(leaves)] if g is not None]
        pos += len(leaves)
        total = sum(got[1:], got[0]) if got else \
            torch.zeros_like(v._handle)
        if not create_graph:
            total = total.detach()
        out.append(NDArray(total.to(v._handle.dtype)))
    return out[0] if single else out


def get_symbol(x):
    """Trace the recording that produced ``x`` into a Symbol: not
    available, as in the JAX package (``mxnet_tpu/autograd.py:234``)."""
    raise NotImplementedError(
        "get_symbol: use gluon.HybridBlock/hybridize for graph capture")


# ---------------------------------------------------------------------------
# custom differentiable functions
# ---------------------------------------------------------------------------

class _FunctionBridge(torch.autograd.Function):
    """A :class:`Function` as a node of torch's graph: the forward runs
    the user's ``forward`` on the NDArrays it was called with (recording
    paused), the backward the user's ``backward`` on NDArrays over the
    incoming gradients, on their device."""

    @staticmethod
    def forward(ctx, func, inputs, *tensors):
        from .ndarray.ndarray import NDArray
        with pause():
            outputs = func.forward(*inputs)
        single = isinstance(outputs, NDArray)
        outs = [outputs] if single else list(outputs)
        ctx.func = func
        func._single = single
        ctx.in_meta = [(t.dtype, t.shape) for t in tensors]
        # an output that is one of the inputs leaves as a copy
        ins = {id(t) for t in tensors}
        return tuple(o._handle.clone() if id(o._handle) in ins
                     else o._handle for o in outs)

    @staticmethod
    def backward(ctx, *grads):
        from .ndarray.ndarray import NDArray
        with pause():
            got = ctx.func.backward(*[NDArray(g.contiguous())
                                      for g in grads])
        if isinstance(got, NDArray):
            got = [got]
        out = []
        for i, g in enumerate(got):
            if g is None or not ctx.needs_input_grad[i + 2]:
                out.append(None)
            else:
                dt, shape = ctx.in_meta[i]
                out.append(g._handle.to(dt).reshape(shape))
        return (None, None) + tuple(out)


class Function:
    """A differentiable function with a user-written backward (reference
    autograd.py:364): subclass, override ``forward`` and ``backward``
    (both on NDArrays), and call the instance.  Under :func:`record` the
    call is one node of the graph; outside it only ``forward`` runs."""

    def __init__(self):
        self._saved = ()

    def save_for_backward(self, *args):
        self._saved = args

    @property
    def saved_tensors(self):
        return self._saved

    def forward(self, *inputs):
        raise NotImplementedError

    def backward(self, *output_grads):
        raise NotImplementedError

    def __call__(self, *inputs):
        from .ndarray.ndarray import NDArray
        if not is_recording():
            with pause():
                return self.forward(*inputs)
        tensors = [_leaf_of(x) for x in inputs]
        with torch.enable_grad():
            outs = _FunctionBridge.apply(self, inputs, *tensors)
        wrapped = [NDArray(o) for o in outs]
        return wrapped[0] if self._single else wrapped
