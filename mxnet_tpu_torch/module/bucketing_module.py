"""BucketingModule: one Module per input shape over one set of parameters
(port of ``mxnet_tpu/module/bucketing_module.py``; reference
python/mxnet/module/bucketing_module.py).

``sym_gen(bucket_key)`` gives ``(symbol, data_names, label_names)``.  The
default bucket's Module (the anchor, bound first) owns the parameter,
gradient and auxiliary arrays; every other bucket's Module binds over
them with ``bind(shared_module=anchor)`` and adopts the anchor's
optimizer, store and updater with ``borrow_optimizer``, so an update
through any bucket moves the one set of weights and the one optimizer
state per parameter.  A batch's ``bucket_key`` selects the Module that
runs it.

Stated difference from the JAX package: its default context is
``[cpu()]``; here, as for :class:`~mxnet_tpu_torch.module.Module`, it is
the card (``current_context()``), and without one the constructor raises
:class:`~mxnet_tpu_torch.base.DeviceUnavailable`.  ``install_monitor``
raises :class:`~mxnet_tpu_torch.base.NotPortedYet` (ROADMAP queue A item
9, observability).
"""
from __future__ import annotations

import logging
import warnings

from ..base import NotPortedYet
from ..context import Context, current_context
from .base_module import BaseModule
from .module import Module

__all__ = ["BucketingModule"]


def _via_active(attr):
    """A property read from the active bucket's module (bind first)."""
    def fget(self):
        self._require()
        return getattr(self._active, attr)
    return property(fget, doc="The active bucket's %s." % attr)


class BucketingModule(BaseModule):
    """Modules of ``sym_gen(bucket_key)`` over shared parameters; the
    ``default_bucket_key`` (by convention the largest bucket) is bound
    first and owns them."""

    def __init__(self, sym_gen, default_bucket_key=None, logger=logging,
                 context=None, work_load_list=None, fixed_param_names=None,
                 state_names=None, group2ctxs=None,
                 compression_params=None):
        super().__init__(logger=logger)
        if default_bucket_key is None:
            raise ValueError("BucketingModule requires default_bucket_key")
        ctx = context if context is not None else current_context()
        for c in ([ctx] if isinstance(ctx, Context) else ctx):
            c.torch_device            # a missing card raises here
        self._sym_gen, self._default_bucket_key = sym_gen, default_bucket_key
        # the constructor's arguments, replayed for every bucket's module
        self._child_kwargs = dict(
            logger=logger, context=ctx, work_load_list=work_load_list,
            fixed_param_names=fixed_param_names, state_names=state_names,
            group2ctxs=group2ctxs, compression_params=compression_params)
        self._pool = {}               # bucket_key -> bound Module
        self._active_key = self._grad_req = None
        self._params_dirty = False

    @property
    def _active(self):
        return self._pool.get(self._active_key)

    @property
    def _anchor(self):
        """The default bucket's module, which owns the shared arrays."""
        return self._pool[self._default_bucket_key]

    def _require(self, params=False, optimizer=False, in_grads=False):
        if not self.binded:
            raise RuntimeError("this BucketingModule is not bound yet: "
                               "call bind()")
        if params and not self.params_initialized:
            raise RuntimeError("parameters not initialized: call "
                               "init_params()")
        if optimizer and not self.optimizer_initialized:
            raise RuntimeError("optimizer not initialized: call "
                               "init_optimizer()")
        if in_grads and not self.inputs_need_grad:
            raise RuntimeError("bind(inputs_need_grad=True) required")

    def _spawn(self, bucket_key, data_shapes, label_shapes,
               share_with=None):
        """Make and bind the module of one bucket (over ``share_with``'s
        arrays)."""
        symbol, data_names, label_names = self._sym_gen(bucket_key)
        child = Module(symbol, data_names, label_names,
                       **self._child_kwargs)
        child.bind(data_shapes, label_shapes,
                   for_training=self.for_training,
                   inputs_need_grad=self.inputs_need_grad,
                   force_rebind=False, shared_module=share_with,
                   grad_req=self._grad_req)
        if share_with is not None and self.optimizer_initialized:
            child.borrow_optimizer(self._anchor)
        self._pool[bucket_key] = child
        return child

    def _reset_bind(self):
        self.binded, self._pool, self._active_key = False, {}, None

    # -- introspection ----------------------------------------------------
    @property
    def data_names(self):
        if not self.binded:
            return self._sym_gen(self._default_bucket_key)[1]
        return self._active.data_names

    @property
    def output_names(self):
        if not self.binded:
            return self._sym_gen(self._default_bucket_key)[0].list_outputs()
        return self._active.output_names

    data_shapes = _via_active("data_shapes")
    label_shapes = _via_active("label_shapes")
    output_shapes = _via_active("output_shapes")
    symbol = _via_active("symbol")

    # -- parameters -------------------------------------------------------
    def get_params(self):
        self._require(params=True)
        self._active._params_dirty = self._params_dirty
        out = self._active.get_params()
        self._params_dirty = False
        return out

    def init_params(self, initializer=None, arg_params=None,
                    aux_params=None, allow_missing=False, force_init=False,
                    allow_extra=False):
        if self.params_initialized and not force_init:
            return
        self._require()
        if initializer is None:
            from ..initializer import Uniform
            initializer = Uniform(0.01)
        self._active.init_params(initializer=initializer,
                                 arg_params=arg_params,
                                 aux_params=aux_params,
                                 allow_missing=allow_missing,
                                 force_init=force_init,
                                 allow_extra=allow_extra)
        self._params_dirty, self.params_initialized = False, True

    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True, allow_extra=False):
        if not allow_missing:
            self.init_params(initializer=None, arg_params=arg_params,
                             aux_params=aux_params, allow_missing=False,
                             force_init=force_init, allow_extra=allow_extra)
        elif self.params_initialized and not force_init:
            warnings.warn("parameters already set; set_params is a no-op "
                          "without force_init", stacklevel=2)
        else:
            self._active.set_params(arg_params, aux_params,
                                    allow_missing=True,
                                    force_init=force_init,
                                    allow_extra=allow_extra)
            self._params_dirty = self.params_initialized = True

    # -- binding and switching buckets -----------------------------------
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False,
             shared_module=None, grad_req="write"):
        """Bind the default bucket's module for these shapes."""
        if shared_module is not None:
            raise ValueError("a BucketingModule cannot itself be shared")
        if force_rebind:
            self._reset_bind()
        if self.binded:
            self.logger.warning("Already bound, ignoring bind()")
            return
        self.for_training, self.inputs_need_grad = (for_training,
                                                    inputs_need_grad)
        self._grad_req, self.binded = grad_req, True
        self._spawn(self._default_bucket_key, data_shapes, label_shapes)
        self._active_key = self._default_bucket_key

    def switch_bucket(self, bucket_key, data_shapes, label_shapes=None):
        """Make ``bucket_key`` the active bucket, binding its module over
        the anchor's arrays on first use."""
        self._require()
        if bucket_key not in self._pool:
            self._spawn(bucket_key, data_shapes, label_shapes,
                        share_with=self._anchor)
        self._active_key = bucket_key

    def _switch_for(self, batch):
        self.switch_bucket(batch.bucket_key, batch.provide_data,
                           batch.provide_label)

    # -- optimizer and the train step -------------------------------------
    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        self._require(params=True)
        if self.optimizer_initialized and not force_init:
            self.logger.warning("optimizer already initialized, ignoring.")
            return
        self._active.init_optimizer(kvstore, optimizer, optimizer_params,
                                    force_init=force_init)
        for child in self._pool.values():
            if child is not self._active:
                child.borrow_optimizer(self._active)
        self.optimizer_initialized = True

    def forward(self, data_batch, is_train=None):
        self._require(params=True)
        self._switch_for(data_batch)
        self._active.forward(data_batch, is_train=is_train)

    def forward_backward(self, data_batch):
        self._require(params=True)
        self._switch_for(data_batch)
        self._active.forward_backward(data_batch)

    def backward(self, out_grads=None):
        self._require(params=True)
        self._active.backward(out_grads=out_grads)

    def update(self):
        self._require(params=True, optimizer=True)
        self._params_dirty = True
        self._active.update()

    # -- results ----------------------------------------------------------
    def get_outputs(self, merge_multi_context=True):
        self._require(params=True)
        return self._active.get_outputs(merge_multi_context)

    def get_input_grads(self, merge_multi_context=True):
        self._require(params=True, in_grads=True)
        return self._active.get_input_grads(merge_multi_context)

    def update_metric(self, eval_metric, labels):
        self._require(params=True)
        self._active.update_metric(eval_metric, labels)

    def install_monitor(self, mon):
        raise NotPortedYet("BucketingModule.install_monitor: executor "
                           "monitors are not ported yet (ROADMAP queue A "
                           "item 9, observability)")

    # the reference's names for the active bucket's key and the modules
    _curr_bucket_key = property(lambda self: self._active_key)
    _buckets = property(lambda self: self._pool)
