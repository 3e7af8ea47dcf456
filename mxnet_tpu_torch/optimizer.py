"""Optimizers (port of ``mxnet_tpu/optimizer.py``; reference
python/mxnet/optimizer.py).

:class:`Optimizer` keeps the reference's bookkeeping: the registry,
``lr_mult`` / ``wd_mult`` from the symbol's ``__lr_mult__`` /
``__wd_mult__`` attrs and the parameter names (a name that is neither a
``_weight`` nor a ``_gamma`` gets no weight decay), the per-index update
counts and the common op kwargs.  :class:`SGD` updates one parameter
through the registered ``sgd_update`` / ``sgd_mom_update`` ops; the other
optimizers are the JAX package's, over their ops (``adam_update``,
``rmsprop_update``, ``rmspropalex_update``, ``ftrl_update``,
``signsgd_update``, ``signum_update``) or NDArray arithmetic (FTML, DCASGD,
NAG, SGLD, AdaGrad, AdaDelta, Adamax, Nadam, Test, LBSGD's lr).  Where the
JAX package rebinds a weight's or a state's handle to a new array, the
port writes the new values into it (:func:`_assign`): a Module's weight
is the executor's bound array.

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

Stated differences: SGLD's noise comes from the port's generators
(``mx.random.seed``), not JAX's, so it agrees with the JAX package in
distribution only; LBSGD reads two norms back to the host per update, as
the JAX package does.  :class:`SGD` and :class:`Adam` with
``lazy_update`` (the default) take a row_sparse gradient lazily: only its
rows of the weight and of the states are read and written
(``ndarray.sparse.sgd_row_sparse_update`` / ``adam_row_sparse_update``,
over the embedding kernels B5 and B6 on the card); every other optimizer,
and these two without ``lazy_update``, update with its dense form, as in
the JAX package.
"""
from __future__ import annotations

import math
import pickle
from typing import Dict

import numpy as np
import torch

from .ndarray.ndarray import NDArray, array, invoke_with_arrays, zeros
from .telemetry import memory as _memory

__all__ = ["Optimizer", "SGD", "LBSGD", "Signum", "FTML", "DCASGD", "NAG",
           "SGLD", "Adam", "AdaGrad", "RMSProp", "AdaDelta", "Ftrl",
           "Adamax", "Nadam", "Test", "Updater", "get_updater", "create",
           "register"]


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


def _assign(dst, src):
    """Write ``src``'s values into ``dst`` in place (the JAX package
    rebinds ``dst._handle``)."""
    dst._handle.copy_(src._handle)


def _zeros_like(weight):
    return zeros(weight.shape, dtype=weight._handle.dtype,
                 ctx=weight.context)


@register
class SGD(Optimizer):
    """SGD with momentum through the ``sgd(_mom)_update`` ops (reference
    optimizer.py:435); a row_sparse gradient with ``lazy_update`` touches
    only its rows (reference optimizer_op.cc:208)."""

    def __init__(self, momentum=0.0, lazy_update=True, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.lazy_update = lazy_update

    def create_state(self, index, weight):
        return None if self.momentum == 0.0 else _zeros_like(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        kw = self._common_kwargs(index)
        if grad.stype == "row_sparse" and self.lazy_update:
            from .ndarray.sparse import sgd_row_sparse_update
            sgd_row_sparse_update(
                weight, grad, state, lr=kw["lr"], wd=kw["wd"],
                momentum=self.momentum, rescale_grad=kw["rescale_grad"],
                clip_gradient=kw.get("clip_gradient"))
        elif state is not None:
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
        kw = self._common_kwargs(index)
        w32, mom = state if isinstance(state, tuple) else (state, None)
        if mom is not None:
            invoke_with_arrays("mp_sgd_mom_update", [weight, grad, mom, w32],
                               dict(momentum=self.momentum, **kw))
        else:
            invoke_with_arrays("mp_sgd_update", [weight, grad, w32], kw)
        self._update_count(index)


@register
class LBSGD(Optimizer):
    """Large-batch SGD: a warm-up of the lr toward ``batch_scale`` over
    ``warmup_epochs`` (linear / power2 / sqrt), or LARS's layer-wise trust
    ratio ``||w|| / (||g|| + wd ||w|| + eps)`` (reference
    optimizer.py:650)."""

    def __init__(self, momentum=0.0, multi_precision=False,
                 warmup_strategy="linear", warmup_epochs=5, batch_scale=1,
                 updates_per_epoch=32, begin_epoch=0, num_epochs=60,
                 **kwargs):
        super().__init__(multi_precision=multi_precision, **kwargs)
        self.momentum = momentum
        self.warmup_strategy = warmup_strategy
        self.warmup_epochs = warmup_epochs
        self.batch_scale = batch_scale
        self.updates_per_epoch = updates_per_epoch
        self.init_updates = begin_epoch * updates_per_epoch
        self.num_epochs = num_epochs
        self.lbmult = 1.0

    def create_state(self, index, weight):
        return None if self.momentum == 0.0 else _zeros_like(weight)

    def _warmup_mult(self, nup):
        nwup = self.warmup_epochs * self.updates_per_epoch
        maxmult = float(self.batch_scale)
        if nwup <= 0 or maxmult < 1 or nup >= nwup:
            return maxmult if maxmult >= 1 else 1.0
        frac = nup / nwup
        if self.warmup_strategy == "power2":
            frac = frac * frac
        elif self.warmup_strategy == "sqrt":
            frac = math.sqrt(frac)
        return 1.0 + (maxmult - 1.0) * frac

    def _lars_mult(self, weight, grad, wd):
        # the norms reduce on the device; two scalars cross to the host
        wnorm = float(invoke_with_arrays("norm", [weight], {}).asscalar())
        gnorm = float(invoke_with_arrays("norm", [grad], {}).asscalar()) \
            * self.rescale_grad
        if wnorm > 0.0 and gnorm > 0.0:
            return wnorm / (gnorm + wd * wnorm + 1e-9)
        return 1.0

    def update(self, index, weight, grad, state):
        self._update_count(index)
        kw = self._common_kwargs(index)
        nup = self.num_update + self.init_updates
        if self.warmup_strategy == "lars":
            mult = self._lars_mult(weight, grad, kw["wd"])
        else:
            mult = self._warmup_mult(nup)
        self.lbmult = mult
        kw["lr"] = kw["lr"] * mult
        if state is not None:
            invoke_with_arrays("sgd_mom_update", [weight, grad, state],
                               dict(momentum=self.momentum, **kw))
        else:
            invoke_with_arrays("sgd_update", [weight, grad], kw)


@register
class Signum(Optimizer):
    """Sign-SGD with momentum (reference optimizer.py:540)."""

    def __init__(self, learning_rate=0.01, momentum=0.9, wd_lh=0.0,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum
        self.wd_lh = wd_lh

    def create_state(self, index, weight):
        return None if self.momentum == 0.0 else _zeros_like(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        kw = self._common_kwargs(index)
        if state is not None:
            invoke_with_arrays("signum_update", [weight, grad, state],
                               dict(momentum=self.momentum, wd_lh=self.wd_lh,
                                    **kw))
        else:
            invoke_with_arrays("signsgd_update", [weight, grad], kw)


@register
class FTML(Optimizer):
    """Follow the moving leader (reference optimizer.py:602), in NDArray
    arithmetic as the JAX package writes it."""

    def __init__(self, beta1=0.6, beta2=0.999, epsilon=1e-8, **kwargs):
        super().__init__(**kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight),
                _zeros_like(weight))                      # d, v, z

    def update(self, index, weight, grad, state):
        self._update_count(index)
        t = self._index_update_count[index]
        lr, wd = self._get_lr(index), self._get_wd(index)
        d, v, z = state
        g = grad * self.rescale_grad + wd * weight
        if self.clip_gradient is not None:
            g = g.clip(-self.clip_gradient, self.clip_gradient)
        v_t = self.beta2 * v + (1 - self.beta2) * g * g
        b2c = 1 - self.beta2 ** t
        b1c = 1 - self.beta1 ** t
        d_t = (b1c / lr) * ((v_t / b2c).sqrt() + self.epsilon)
        sigma = d_t - self.beta1 * d
        z_t = self.beta1 * z + (1 - self.beta1) * g - sigma * weight
        w_t = -1.0 * z_t / d_t
        for dst, src in ((d, d_t), (v, v_t), (z, z_t), (weight, w_t)):
            _assign(dst, src)


@register
class DCASGD(Optimizer):
    """Delay-compensated asynchronous SGD (reference optimizer.py:840)."""

    def __init__(self, momentum=0.0, lamda=0.04, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.weight_previous = {}
        self.lamda = lamda

    def create_state(self, index, weight):
        mom = None if self.momentum == 0.0 else _zeros_like(weight)
        return (mom, weight.copy())

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        g = grad * self.rescale_grad
        if self.clip_gradient is not None:
            g = g.clip(-self.clip_gradient, self.clip_gradient)
        mom, prev = state
        comp = g + self.lamda * g * g * (weight - prev)
        if mom is not None:
            step = self.momentum * mom - lr * (comp + wd * weight)
            _assign(mom, step)
        else:
            step = -lr * (comp + wd * weight)
        new_w = weight + step
        _assign(prev, weight)
        _assign(weight, new_w)


@register
class NAG(Optimizer):
    """Nesterov accelerated SGD (reference optimizer.py:897)."""

    def __init__(self, momentum=0.0, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        return None if self.momentum == 0.0 else _zeros_like(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        g = grad * self.rescale_grad + wd * weight
        if self.clip_gradient is not None:
            g = g.clip(-self.clip_gradient, self.clip_gradient)
        if state is not None:
            m = self.momentum * state + g
            _assign(state, m)
            _assign(weight, weight - lr * (g + self.momentum * m))
        else:
            _assign(weight, weight - lr * g)


@register
class SGLD(Optimizer):
    """Stochastic gradient Langevin dynamics (reference optimizer.py:949):
    ``w - lr/2 g + N(0, lr)``.  The noise is drawn on the weight's device
    from the port's generator (``mx.random.seed``), not JAX's."""

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        g = grad * self.rescale_grad + wd * weight
        if self.clip_gradient is not None:
            g = g.clip(-self.clip_gradient, self.clip_gradient)
        from .ndarray import random as _rand
        noise = _rand.normal(0, math.sqrt(lr), shape=weight.shape,
                             dtype=weight._handle.dtype, ctx=weight.context)
        _assign(weight, weight - lr / 2 * g + noise)


@register
class Adam(Optimizer):
    """Adam through ``adam_update``, the bias correction folded into the
    lr (reference optimizer.py:985, optimizer_op.cc:354); a row_sparse
    gradient with ``lazy_update`` touches only its rows."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, lazy_update=True, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.lazy_update = lazy_update

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight))   # mean, var

    def update(self, index, weight, grad, state):
        self._update_count(index)
        t = self._index_update_count[index]
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        coef1 = 1. - self.beta1 ** t
        coef2 = 1. - self.beta2 ** t
        lr *= math.sqrt(coef2) / coef1
        mean, var = state
        if grad.stype == "row_sparse" and self.lazy_update:
            from .ndarray.sparse import adam_row_sparse_update
            adam_row_sparse_update(
                weight, grad, mean, var, lr=lr, beta1=self.beta1,
                beta2=self.beta2, epsilon=self.epsilon, wd=wd,
                rescale_grad=self.rescale_grad,
                clip_gradient=self.clip_gradient)
            return
        kw = dict(lr=lr, wd=wd, rescale_grad=self.rescale_grad,
                  beta1=self.beta1, beta2=self.beta2, epsilon=self.epsilon)
        if self.clip_gradient is not None:
            kw["clip_gradient"] = self.clip_gradient
        invoke_with_arrays("adam_update", [weight, grad, mean, var], kw)


@register
class AdaGrad(Optimizer):
    """reference optimizer.py:1067."""

    def __init__(self, eps=1e-7, **kwargs):
        super().__init__(**kwargs)
        self.float_stable_eps = eps

    def create_state(self, index, weight):
        return _zeros_like(weight)                          # history

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        g = grad * self.rescale_grad
        if self.clip_gradient is not None:
            g = g.clip(-self.clip_gradient, self.clip_gradient)
        _assign(state, state + g * g)
        step = lr * (g / (state + self.float_stable_eps).sqrt() + wd * weight)
        _assign(weight, weight - step)


@register
class RMSProp(Optimizer):
    """RMSProp through ``rmsprop_update``, or Graves's centered form
    through ``rmspropalex_update`` (reference optimizer.py:1135)."""

    def __init__(self, learning_rate=0.001, gamma1=0.9, gamma2=0.9,
                 epsilon=1e-8, centered=False, clip_weights=None, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.gamma1, self.gamma2 = gamma1, gamma2
        self.centered = centered
        self.epsilon = epsilon
        self.clip_weights = clip_weights

    def create_state(self, index, weight):
        if self.centered:                                  # n, g, delta
            return (_zeros_like(weight), _zeros_like(weight),
                    _zeros_like(weight))
        return (_zeros_like(weight),)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        kw = self._common_kwargs(index)
        kw.update(gamma1=self.gamma1, epsilon=self.epsilon)
        if self.clip_weights:
            kw["clip_weights"] = self.clip_weights
        if self.centered:
            kw["gamma2"] = self.gamma2
            invoke_with_arrays("rmspropalex_update", [weight, grad, *state],
                               kw)
        else:
            invoke_with_arrays("rmsprop_update", [weight, grad, state[0]],
                               kw)


@register
class AdaDelta(Optimizer):
    """reference optimizer.py:1211."""

    def __init__(self, rho=0.90, epsilon=1e-5, **kwargs):
        super().__init__(**kwargs)
        self.rho, self.epsilon = rho, epsilon

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight))  # acc_g, acc_dx

    def update(self, index, weight, grad, state):
        self._update_count(index)
        wd = self._get_wd(index)
        g = grad * self.rescale_grad
        if self.clip_gradient is not None:
            g = g.clip(-self.clip_gradient, self.clip_gradient)
        acc_g, acc_delta = state
        ag = self.rho * acc_g + (1. - self.rho) * g * g
        delta = ((acc_delta + self.epsilon).sqrt() /
                 (ag + self.epsilon).sqrt()) * g
        ad = self.rho * acc_delta + (1. - self.rho) * delta * delta
        new_w = weight - delta - wd * weight
        for dst, src in ((acc_g, ag), (acc_delta, ad), (weight, new_w)):
            _assign(dst, src)


@register
class Ftrl(Optimizer):
    """FTRL-proximal through ``ftrl_update``."""

    def __init__(self, lamda1=0.01, learning_rate=0.1, beta=1, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.lamda1 = lamda1
        self.beta = beta

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight))   # z, n

    def update(self, index, weight, grad, state):
        self._update_count(index)
        kw = self._common_kwargs(index)
        z, n = state
        invoke_with_arrays("ftrl_update", [weight, grad, z, n],
                           dict(lamda1=self.lamda1, beta=self.beta, **kw))


@register
class Adamax(Optimizer):
    """Adam under the infinity norm."""

    def __init__(self, learning_rate=0.002, beta1=0.9, beta2=0.999,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2 = beta1, beta2

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight))   # m, u

    def update(self, index, weight, grad, state):
        self._update_count(index)
        t = self._index_update_count[index]
        lr = self._get_lr(index) / (1. - self.beta1 ** t)
        wd = self._get_wd(index)
        g = grad * self.rescale_grad + wd * weight
        if self.clip_gradient is not None:
            g = g.clip(-self.clip_gradient, self.clip_gradient)
        m, u = state
        from .ndarray import maximum as nd_max
        m_t = self.beta1 * m + (1. - self.beta1) * g
        u_t = nd_max(self.beta2 * u, g.abs())
        new_w = weight - lr * m_t / (u_t + 1e-8)
        for dst, src in ((m, m_t), (u, u_t), (weight, new_w)):
            _assign(dst, src)


@register
class Nadam(Optimizer):
    """Nesterov Adam; the momentum schedule is the optimizer's, as in the
    JAX package."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, schedule_decay=0.004, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2 = beta1, beta2
        self.epsilon = epsilon
        self.schedule_decay = schedule_decay
        self.m_schedule = 1.0

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight))   # m, v

    def update(self, index, weight, grad, state):
        self._update_count(index)
        t = self._index_update_count[index]
        lr, wd = self._get_lr(index), self._get_wd(index)
        g = grad * self.rescale_grad + wd * weight
        if self.clip_gradient is not None:
            g = g.clip(-self.clip_gradient, self.clip_gradient)
        momentum_t = self.beta1 * (1. - 0.5 * 0.96 **
                                   (t * self.schedule_decay))
        momentum_t_1 = self.beta1 * (1. - 0.5 * 0.96 **
                                     ((t + 1) * self.schedule_decay))
        self.m_schedule = self.m_schedule * momentum_t
        m_schedule_next = self.m_schedule * momentum_t_1
        m, v = state
        g_prime = g / (1. - self.m_schedule)
        m_t = self.beta1 * m + (1. - self.beta1) * g
        m_t_prime = m_t / (1. - m_schedule_next)
        v_t = self.beta2 * v + (1. - self.beta2) * g * g
        v_t_prime = v_t / (1. - self.beta2 ** t)
        m_t_bar = (1. - momentum_t) * g_prime + momentum_t_1 * m_t_prime
        new_w = weight - lr * m_t_bar / (v_t_prime.sqrt() + self.epsilon)
        for dst, src in ((m, m_t), (v, v_t), (weight, new_w)):
            _assign(dst, src)


@register
class Test(Optimizer):
    """The reference's test optimizer: ``w += rescale_grad * g``, and the
    state holds the new weight."""

    def create_state(self, index, weight):
        return _zeros_like(weight)

    def update(self, index, weight, grad, state):
        _assign(weight, weight + grad * self.rescale_grad)
        _assign(state, weight)


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
        ``multi_precision`` optimizer, and a sparse gradient or weight, go
        key by key, as the reference's (``mxnet_tpu/optimizer.py:699``)."""
        opt = self.optimizer
        return (type(opt) is SGD and not opt.multi_precision
                and all(g.stype == "default" and w.stype == "default"
                        for _, g, w in triples))

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
        """Take the states :meth:`get_states` wrote; with
        ``dump_optimizer`` that is the pair ``(states, optimizer)``, whose
        optimizer replaces this updater's (as MXNet's
        ``Updater.set_states`` does; the JAX package's takes only the
        states)."""
        states = pickle.loads(states) if isinstance(states, bytes) \
            else states
        if isinstance(states, tuple) and len(states) == 2:
            states, self.optimizer = states
        self.states = states
        self.states_synced = {k: False for k in self.states}

    def get_states(self, dump_optimizer=False):
        """Pickled states as host numpy arrays (device-neutral)."""
        host = {k: _to_host(v) for k, v in self.states.items()}
        return pickle.dumps((host, self.optimizer) if dump_optimizer
                            else host)


def get_updater(optimizer: Optimizer) -> Updater:
    return Updater(optimizer)
