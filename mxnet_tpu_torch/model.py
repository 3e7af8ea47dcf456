"""The kvstore helpers and checkpoints of the legacy model API (port of
``mxnet_tpu/model.py:25-129``; reference python/mxnet/model.py
``_create_kvstore`` :58, ``_update_params_on_kvstore`` :126,
``_update_params`` :138, ``save_checkpoint`` :366, ``load_checkpoint``
:396).

Both update paths are ported: with a store that updates
(``update_on_kvstore``), every gradient is pushed and the new weight
pulled back; otherwise the gradients are reduced through the store (if
any) and the local updater applies them.  One device with a string
kvstore gets no store at all, as in the reference, so a ``KVStore``
object is how a one-card run reaches the store (and its gradient
compression).

A checkpoint is ``prefix-symbol.json`` and ``prefix-NNNN.params`` (the
reference's binary NDArray container, ``arg:`` / ``aux:`` keys), the same
files as the JAX package's: either package loads the other's.
``load_checkpoint`` reads the parameters onto the CPU, as the host copies
a Module keeps.

``FeedForward`` is the legacy training facade over
:class:`~mxnet_tpu_torch.module.Module` (reference model.py:434).  Its
default context is the card, as the Module's (the JAX package's is the
CPU); ``ctx=mx.cpu()`` asks for the host.
"""
from __future__ import annotations

import logging
from collections import namedtuple

import numpy as np

from . import kvstore as kvs

__all__ = ["BatchEndParam", "FeedForward", "save_checkpoint",
           "load_checkpoint"]

BatchEndParam = namedtuple("BatchEndParams",
                           ["epoch", "nbatch", "eval_metric", "locals"])


def _create_kvstore(kvstore, num_device, arg_params, device=None):
    """``(store or None, update_on_kvstore)`` (reference model.py:58); a
    store made here lives on ``device`` (None: the card, or in a gang the
    rank's device)."""
    update_on_kvstore = True
    if kvstore is None:
        kv = None
    elif isinstance(kvstore, kvs.KVStore):
        kv = kvstore
    elif isinstance(kvstore, str):
        if num_device == 1 and "dist" not in kvstore:
            kv = None
        else:
            kv = kvs.create(kvstore, device=device)
            if kvstore == "local":
                max_size = max(np.prod(param.shape)
                               for param in arg_params.values())
                if max_size > 1024 * 1024 * 16:
                    update_on_kvstore = False
    else:
        raise TypeError("kvstore must be KVStore, str or None")
    if kv is None:
        update_on_kvstore = False
    return (kv, update_on_kvstore)


def _initialize_kvstore(kvstore, param_arrays, arg_params, param_names,
                        update_on_kvstore):
    """Seed the store from the executors' copies of the parameters (the
    values of ``arg_params`` after ``set_params``), and pull them back
    when the store does the updates (reference model.py:87)."""
    for idx, param_on_devs in enumerate(param_arrays):
        name = param_names[idx]
        kvstore.init(name, param_on_devs[0] if param_on_devs
                     else arg_params[name])
        if update_on_kvstore:
            kvstore.pull(name, param_on_devs, priority=-idx)


def _pushed(param_arrays, grad_arrays, param_names):
    """``(names, arg_lists, grad_lists)`` of the parameters that have a
    gradient, in parameter order."""
    got = [(param_names[i], args, grads) for i, (args, grads)
           in enumerate(zip(param_arrays, grad_arrays))
           if grads[0] is not None]
    return tuple(map(list, zip(*got))) if got else ([], [], [])


def _update_params_on_kvstore(param_arrays, grad_arrays, kvstore,
                              param_names):
    """Push every gradient, pull the new weight (reference model.py:126).

    The reference pushes and pulls key by key; here every key goes in one
    list push and one list pull (the list form of the same API), so the
    store compresses all of a step's gradients in one grouped kernel
    launch.  The weights are the same: a push of key k reads only k's
    gradients and writes only k's stored value, residual and optimizer
    state, the updater runs in key order either way, and a pull of k
    reads only k's stored value."""
    names, arg_lists, grad_lists = _pushed(param_arrays, grad_arrays,
                                           param_names)
    if names:
        kvstore.push(names, grad_lists)
        kvstore.pull(names, arg_lists)


def _update_params(param_arrays, grad_arrays, updater, num_device,
                   kvstore=None, param_names=None):
    """Reduce the gradients through the store (if any), then update
    locally (reference model.py:138): one ``Updater.update_batch`` per
    device, a ``torch._foreach_*`` chain for plain SGD.  The store
    reduces every gradient in one list push and one list pull (see
    :func:`_update_params_on_kvstore` for why that equals the reference's
    push and pull per key)."""
    if kvstore:
        names, _, grad_lists = _pushed(param_arrays, grad_arrays,
                                       param_names)
        if names:
            kvstore.push(names, grad_lists)
            kvstore.pull(names, grad_lists)
    updates = [[] for _ in range(num_device)]
    for index, (arg_list, grad_list) in enumerate(zip(param_arrays,
                                                      grad_arrays)):
        if grad_list[0] is None:
            continue
        for k, (w, g) in enumerate(zip(arg_list, grad_list)):
            updates[k].append((index * num_device + k, g, w))
    for dev_updates in updates:
        updater.update_batch(dev_updates)


def save_checkpoint(prefix, epoch, symbol, arg_params, aux_params):
    """``prefix-symbol.json`` (if ``symbol``) and ``prefix-%04d.params``
    of ``arg:``/``aux:`` keys (reference model.py:366)."""
    from .ndarray.ndarray import save as nd_save
    if symbol is not None:
        symbol.save("%s-symbol.json" % prefix)
    save_dict = {("arg:%s" % k): v for k, v in arg_params.items()}
    save_dict.update({("aux:%s" % k): v for k, v in aux_params.items()})
    param_name = "%s-%04d.params" % (prefix, epoch)
    nd_save(param_name, save_dict)
    logging.info("Saved checkpoint to \"%s\"", param_name)


def load_checkpoint(prefix, epoch):
    """``(symbol, arg_params, aux_params)`` of a checkpoint, the
    parameters as NDArrays on the CPU (reference model.py:396)."""
    from .ndarray.ndarray import load as nd_load
    from .symbol import load as sym_load
    symbol = sym_load("%s-symbol.json" % prefix)
    save_dict = nd_load("%s-%04d.params" % (prefix, epoch), ctx="cpu")
    arg_params, aux_params = {}, {}
    for k, v in save_dict.items():
        tp, name = k.split(":", 1)
        if tp == "arg":
            arg_params[name] = v
        if tp == "aux":
            aux_params[name] = v
    return symbol, arg_params, aux_params


class FeedForward:
    """The legacy training facade over ``Module`` (reference
    model.py:434): ``fit``, ``predict``, ``save``, ``load`` and
    ``create``."""

    def __init__(self, symbol, ctx=None, num_epoch=None, epoch_size=None,
                 optimizer="sgd", initializer=None, numpy_batch_size=128,
                 arg_params=None, aux_params=None, allow_extra_params=False,
                 begin_epoch=0, **kwargs):
        from .context import Context, current_context
        from .initializer import Uniform
        self.symbol = symbol
        self.ctx = ctx if ctx is not None else current_context()
        if isinstance(self.ctx, Context):
            self.ctx = [self.ctx]
        self.num_epoch = num_epoch
        self.epoch_size = epoch_size
        self.optimizer = optimizer
        self.initializer = initializer or Uniform(0.01)
        self.numpy_batch_size = numpy_batch_size
        self.arg_params = arg_params
        self.aux_params = aux_params
        self.allow_extra_params = allow_extra_params
        self.begin_epoch = begin_epoch
        self.kwargs = kwargs.copy()
        self._module = None

    def _get_module(self):
        from .module.module import Module
        if self._module is None:
            self._module = Module(self.symbol, context=self.ctx)
        return self._module

    def fit(self, X, y=None, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None,
            kvstore="local", logger=None, work_load_list=None, monitor=None,
            eval_end_callback=None, eval_batch_end_callback=None):
        from .io.io import NDArrayIter
        if not hasattr(X, "provide_data"):
            X = NDArrayIter(X, y, batch_size=self.numpy_batch_size,
                            shuffle=True)
        mod = self._get_module()
        mod.fit(X, eval_data=eval_data, eval_metric=eval_metric,
                epoch_end_callback=epoch_end_callback,
                batch_end_callback=batch_end_callback, kvstore=kvstore,
                optimizer=self.optimizer, optimizer_params=self.kwargs,
                initializer=self.initializer, arg_params=self.arg_params,
                aux_params=self.aux_params, begin_epoch=self.begin_epoch,
                num_epoch=self.num_epoch)
        self.arg_params, self.aux_params = mod.get_params()
        return self

    def predict(self, X, num_batch=None, return_data=False, reset=True):
        """The outputs over ``X`` (an iterator or an array) as numpy."""
        from .io.io import NDArrayIter
        from .ndarray.ndarray import NDArray
        if not hasattr(X, "provide_data"):
            X = NDArrayIter(X, batch_size=self.numpy_batch_size)
        mod = self._get_module()
        if not mod.binded:
            mod.bind(data_shapes=X.provide_data, for_training=False)
            mod.set_params(self.arg_params or {}, self.aux_params or {},
                           allow_missing=True)
        out = mod.predict(X, num_batch=num_batch, reset=reset)
        return out.asnumpy() if isinstance(out, NDArray) else out

    def save(self, prefix, epoch=None):
        if epoch is None:
            epoch = self.num_epoch
        save_checkpoint(prefix, epoch, self.symbol, self.arg_params or {},
                        self.aux_params or {})

    @staticmethod
    def load(prefix, epoch, ctx=None, **kwargs):
        symbol, arg_params, aux_params = load_checkpoint(prefix, epoch)
        return FeedForward(symbol, ctx=ctx, arg_params=arg_params,
                           aux_params=aux_params, begin_epoch=epoch,
                           **kwargs)

    @staticmethod
    def create(symbol, X, y=None, ctx=None, num_epoch=None, epoch_size=None,
               optimizer="sgd", initializer=None, eval_data=None,
               eval_metric="acc", epoch_end_callback=None,
               batch_end_callback=None, kvstore="local", logger=None,
               work_load_list=None, eval_end_callback=None,
               eval_batch_end_callback=None, **kwargs):
        model = FeedForward(symbol, ctx=ctx, num_epoch=num_epoch,
                            epoch_size=epoch_size, optimizer=optimizer,
                            initializer=initializer, **kwargs)
        model.fit(X, y, eval_data=eval_data, eval_metric=eval_metric,
                  epoch_end_callback=epoch_end_callback,
                  batch_end_callback=batch_end_callback, kvstore=kvstore,
                  logger=logger, work_load_list=work_load_list,
                  eval_end_callback=eval_end_callback,
                  eval_batch_end_callback=eval_batch_end_callback)
        return model
