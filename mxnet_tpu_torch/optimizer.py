"""Optimizers (port of the SGD part of ``mxnet_tpu/optimizer.py``;
reference python/mxnet/optimizer.py).

:class:`Optimizer` keeps the reference's bookkeeping: the registry,
``lr_mult`` / ``wd_mult`` from the symbol's ``__lr_mult__`` /
``__wd_mult__`` attrs and the parameter names (a name that is neither a
``_weight`` nor a ``_gamma`` gets no weight decay), the per-index update
counts and the common op kwargs.  :class:`SGD` updates one parameter
through the registered ``sgd_update`` / ``sgd_mom_update`` ops.

:class:`Updater` is the closure the kvstore calls as ``updater(key,
grad, weight)``.  Its :meth:`Updater.update_batch` is the Module's local
update path: for plain dense SGD it applies every parameter of a step as
one chain of ``torch._foreach_*`` kernels (the JAX package's one jitted
program, the reference's ``multi_sgd_mom_update``) with the same formula.

``multi_precision=True`` keeps an f32 master copy of each float16 weight
(MXNet's mixed-precision recipe; bf16 and f32 weights take the plain
path, as in the reference): the state is ``(weight32, base state)``, the
update runs in f32 on the master and the weight is written as its
rounding.  :class:`SGD` does that through the ``mp_sgd_update`` /
``mp_sgd_mom_update`` ops with the state ``(weight32, mom)``; the
:class:`Updater` applies such updates key by key (grouping them is not
done yet).

Ported: ``Optimizer``, ``SGD`` (dense; a row_sparse gradient raises
``NotPortedYet``), ``create`` / ``register``, ``Updater`` and
``get_updater``.  The JAX package's other optimizers raise
``NotPortedYet`` from :func:`create`.
"""
from __future__ import annotations

import pickle
from typing import Dict

import numpy as np
import torch

from .base import NotPortedYet
from .ndarray.ndarray import NDArray, array, invoke_with_arrays, zeros
from .telemetry import memory as _memory

__all__ = ["Optimizer", "SGD", "Updater", "get_updater", "create",
           "register"]

# optimizers of the JAX package that a later slice ports (ROADMAP queue A
# item 2)
_NOT_PORTED = ("lbsgd", "signum", "ftml", "dcasgd", "nag", "sgld", "adam",
               "adagrad", "rmsprop", "adadelta", "ftrl", "adamax", "nadam",
               "test")


class Optimizer:
    """Base optimizer with the registry and the lr/wd multiplier logic."""

    opt_registry: Dict[str, type] = {}

    def __init__(self, rescale_grad=1.0, param_idx2name=None, wd=0.0,
                 clip_gradient=None, learning_rate=0.01, lr_scheduler=None,
                 sym=None, begin_num_update=0, multi_precision=False,
                 param_dict=None):
        self.rescale_grad = rescale_grad
        self.lr = learning_rate
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is not None:
            self.lr_scheduler.base_lr = learning_rate
        self.wd = wd
        self.lr_mult = {}
        self.wd_mult = {}
        self.begin_num_update = begin_num_update
        self.num_update = begin_num_update
        self._index_update_count = {}
        self.clip_gradient = clip_gradient
        self.multi_precision = multi_precision
        self.idx2name = dict(param_idx2name or {})
        self.sym_info = ((sym.attr_dict(), sym.list_arguments())
                         if sym is not None else ({}, []))
        self.param_dict = param_dict or {}
        self.set_lr_mult({})
        self.set_wd_mult({})

    @staticmethod
    def register(klass):
        Optimizer.opt_registry[klass.__name__.lower()] = klass
        return klass

    @staticmethod
    def create_optimizer(name, **kwargs):
        key = name.lower()
        if key in Optimizer.opt_registry:
            return Optimizer.opt_registry[key](**kwargs)
        if key in _NOT_PORTED:
            raise NotPortedYet("optimizer %r is not ported yet (ROADMAP "
                               "queue A item 2)" % name)
        raise ValueError("Cannot find optimizer %s" % name)

    def create_state(self, index, weight):
        return None

    def _mixed(self, weight):
        """Whether ``weight`` gets an f32 master copy: float16 weights
        under ``multi_precision``."""
        return self.multi_precision and \
            weight._handle.dtype == torch.float16

    def create_state_multi_precision(self, index, weight):
        if self._mixed(weight):
            w32 = weight.astype("float32")
            return (w32, self.create_state(index, w32))
        return self.create_state(index, weight)

    def update(self, index, weight, grad, state):
        raise NotImplementedError()

    def update_multi_precision(self, index, weight, grad, state):
        if self._mixed(weight):
            w32, base_state = state
            self.update(index, w32, grad.astype("float32"), base_state)
            weight._handle.copy_(w32._handle)
        else:
            self.update(index, weight, grad, state)

    def set_learning_rate(self, lr):
        if self.lr_scheduler is not None:
            raise UserWarning("LRScheduler of the optimizer has already been "
                              "defined.")
        self.lr = lr

    def set_lr_mult(self, args_lr_mult):
        self.lr_mult = {}
        attr, arg_names = self.sym_info
        for name in arg_names:
            if name in attr and "__lr_mult__" in attr[name]:
                self.lr_mult[name] = float(attr[name]["__lr_mult__"])
        self.lr_mult.update(args_lr_mult)

    def set_wd_mult(self, args_wd_mult):
        self.wd_mult = {}
        for n in self.idx2name.values():
            if not (n.endswith("_weight") or n.endswith("_gamma")):
                self.wd_mult[n] = 0.0
        attr, arg_names = self.sym_info
        for name in arg_names:
            if name in attr and "__wd_mult__" in attr[name]:
                self.wd_mult[name] = float(attr[name]["__wd_mult__"])
        self.wd_mult.update(args_wd_mult)

    def _update_count(self, index):
        if index not in self._index_update_count:
            self._index_update_count[index] = self.begin_num_update
        self._index_update_count[index] += 1
        self.num_update = max(self._index_update_count[index],
                              self.num_update)

    def _get_lr(self, index):
        lr = (self.lr_scheduler(self.num_update)
              if self.lr_scheduler is not None else self.lr)
        if index in self.param_dict:
            lr *= self.param_dict[index].lr_mult
        elif index in self.lr_mult:
            lr *= self.lr_mult[index]
        elif index in self.idx2name:
            lr *= self.lr_mult.get(self.idx2name[index], 1.0)
        return lr

    def _get_wd(self, index):
        wd = self.wd
        if index in self.param_dict:
            wd *= self.param_dict[index].wd_mult
        elif index in self.wd_mult:
            wd *= self.wd_mult[index]
        elif index in self.idx2name:
            wd *= self.wd_mult.get(self.idx2name[index], 1.0)
        return wd

    def _common_kwargs(self, index):
        kw = dict(lr=self._get_lr(index), wd=self._get_wd(index),
                  rescale_grad=self.rescale_grad)
        if self.clip_gradient is not None:
            kw["clip_gradient"] = self.clip_gradient
        return kw


register = Optimizer.register


@register
class SGD(Optimizer):
    """SGD with momentum through the ``sgd(_mom)_update`` ops (reference
    optimizer.py:435).  Dense gradients only."""

    def __init__(self, momentum=0.0, lazy_update=True, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.lazy_update = lazy_update

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return None
        return zeros(weight.shape, dtype=weight._handle.dtype,
                     ctx=weight.context)

    def update(self, index, weight, grad, state):
        if grad.stype != "default":
            raise NotPortedYet("SGD on a %s gradient: sparse NDArrays are "
                               "not ported yet (ROADMAP queue A item 5)"
                               % grad.stype)
        self._update_count(index)
        kw = self._common_kwargs(index)
        if state is not None:
            invoke_with_arrays("sgd_mom_update", [weight, grad, state],
                               dict(momentum=self.momentum, **kw))
        else:
            invoke_with_arrays("sgd_update", [weight, grad], kw)

    def create_state_multi_precision(self, index, weight):
        if self._mixed(weight):
            mom = None
            if self.momentum != 0.0:
                mom = zeros(weight.shape, dtype="float32",
                            ctx=weight.context)
            return (weight.astype("float32"), mom)
        return self.create_state(index, weight)

    def update_multi_precision(self, index, weight, grad, state):
        """``mp_sgd(_mom)_update`` on a float16 weight and its state
        ``(weight32, mom)``; the lr and wd are read before the update
        count moves, as in the reference."""
        if not self._mixed(weight):
            self.update(index, weight, grad, state)
            return
        if grad.stype != "default":
            raise NotPortedYet("SGD on a %s gradient: sparse NDArrays are "
                               "not ported yet (ROADMAP queue A item 5)"
                               % grad.stype)
        kw = self._common_kwargs(index)
        w32, mom = state if isinstance(state, tuple) else (state, None)
        if mom is not None:
            invoke_with_arrays("mp_sgd_mom_update", [weight, grad, mom, w32],
                               dict(momentum=self.momentum, **kw))
        else:
            invoke_with_arrays("mp_sgd_update", [weight, grad, w32], kw)
        self._update_count(index)


create = Optimizer.create_optimizer


def _sgd_foreach(ws, gs, ms, lrs, wds, rescale, momentum, clip):
    """Every parameter's SGD step as one chain of ``torch._foreach_*``
    kernels, in place on ``ws`` and ``ms``; ``gs`` is only read.  The
    formula of ``sgd_update`` / ``sgd_mom_update``: ``g = clip(grad *
    rescale)``, ``m' = momentum m - lr (g + wd w)``, ``w' = w + m'``
    (without momentum ``w' = w - lr (g + wd w)``)."""
    g = torch._foreach_mul(gs, rescale)
    if clip > 0:
        torch._foreach_clamp_min_(g, -clip)
        torch._foreach_clamp_max_(g, clip)
    if any(wds):
        torch._foreach_add_(g, torch._foreach_mul(ws, wds))
    torch._foreach_mul_(g, [-lr for lr in lrs])
    if ms is None:
        torch._foreach_add_(ws, g)
        return
    torch._foreach_mul_(ms, momentum)
    torch._foreach_add_(ms, g)
    torch._foreach_add_(ws, ms)


def _to_host(state):
    if isinstance(state, NDArray):
        return state.asnumpy()
    if isinstance(state, (tuple, list)):
        return type(state)(_to_host(s) for s in state)
    return state


def _to_context(state, ctx):
    if isinstance(state, np.ndarray):
        return array(state, ctx=ctx, dtype=state.dtype)
    if isinstance(state, NDArray):
        return state.as_in_context(ctx)
    if isinstance(state, (tuple, list)):
        return type(state)(_to_context(s, ctx) for s in state)
    return state


class Updater:
    """Applies an optimizer to (index, grad, weight); the kvstore's
    updater (reference optimizer.py get_updater).  States are created
    beside their weight at its first update; states loaded by
    :meth:`set_states` move to their weight's context at its next
    update."""

    def __init__(self, optimizer: Optimizer):
        self.optimizer = optimizer
        self.states = {}
        self.states_synced = {}

    def _state(self, index, weight, create):
        if index not in self.states:
            self.states[index] = create(index, weight)
            self.states_synced[index] = True
            parts = self.states[index]
            for part in (parts if isinstance(parts, tuple) else (parts,)):
                if isinstance(part, NDArray):
                    _memory.tag(part._handle, "optimizer",
                                label="Updater[%s]" % index)
        elif not self.states_synced[index]:
            self.states[index] = _to_context(self.states[index],
                                             weight.context)
            self.states_synced[index] = True
        return self.states[index]

    def __call__(self, index, grad, weight):
        state = self._state(index, weight,
                            self.optimizer.create_state_multi_precision)
        self.optimizer.update_multi_precision(index, weight, grad, state)

    def _fusable(self, triples):
        """Plain dense SGD: one ``torch._foreach_*`` chain.  A
        ``multi_precision`` optimizer goes key by key, as the reference's
        (``mxnet_tpu/optimizer.py:699``)."""
        opt = self.optimizer
        return (type(opt) is SGD and not opt.multi_precision
                and all(g.stype == "default" for _, g, _ in triples))

    def update_batch(self, triples):
        """Apply the optimizer to every ``(index, grad, weight)`` triple:
        for plain dense SGD as one ``torch._foreach_*`` chain over all of
        them (a handful of kernels per step instead of several per
        parameter), else one :meth:`__call__` each."""
        if not triples:
            return
        if not self._fusable(triples):
            for index, g, w in triples:
                self(index, g, w)
            return
        opt = self.optimizer
        states = [self._state(i, w, opt.create_state) for i, _, w in triples]
        for index, _, _ in triples:
            opt._update_count(index)
        _sgd_foreach([w._handle for _, _, w in triples],
                     [g._handle for _, g, _ in triples],
                     None if opt.momentum == 0.0
                     else [s._handle for s in states],
                     [float(opt._get_lr(i)) for i, _, _ in triples],
                     [float(opt._get_wd(i)) for i, _, _ in triples],
                     float(opt.rescale_grad), float(opt.momentum),
                     float(opt.clip_gradient or 0.0))

    def set_states(self, states):
        self.states = pickle.loads(states) if isinstance(states, bytes) \
            else states
        self.states_synced = {k: False for k in self.states}

    def get_states(self, dump_optimizer=False):
        """Pickled states as host numpy arrays (device-neutral)."""
        host = {k: _to_host(v) for k, v in self.states.items()}
        return pickle.dumps((host, self.optimizer) if dump_optimizer
                            else host)


def get_updater(optimizer: Optimizer) -> Updater:
    return Updater(optimizer)
