"""Modules computed in Python rather than from a bound Symbol (port of
``mxnet_tpu/module/python_module.py``; reference
python/mxnet/module/python_module.py).

:class:`PythonModule` has no learned state: its parameter and optimizer
calls do nothing.  :class:`PythonLossModule` is a loss stage for a
``SequentialModule`` whose gradient is the user's
``grad_func(scores, labels)``.
"""
from __future__ import annotations

import logging

from ..context import context_of
from ..io.io import DataDesc
from ..ndarray.ndarray import NDArray, array as nd_array
from .base_module import BaseModule

__all__ = ["PythonModule", "PythonLossModule"]


def _as_descs(shapes):
    """(name, shape) pairs or DataDescs -> DataDescs; empty -> None."""
    if not shapes:
        return None
    return [entry if isinstance(entry, DataDesc) else DataDesc(*entry)
            for entry in shapes]


class PythonModule(BaseModule):
    """A stage without learned state.  Subclasses implement forward,
    backward and ``_compute_output_shapes``."""

    def __init__(self, data_names, label_names, output_names,
                 logger=logging):
        super().__init__(logger=logger)
        self._data_names = list(data_names)
        self._label_names = list(label_names) if label_names \
            else label_names
        self._output_names = output_names
        self._data_shapes = None
        self._label_shapes = None
        self._output_shapes = None

    data_names = property(lambda self: self._data_names)
    output_names = property(lambda self: self._output_names)
    data_shapes = property(lambda self: self._data_shapes)
    label_shapes = property(lambda self: self._label_shapes)
    output_shapes = property(lambda self: self._output_shapes)

    # -- nothing to learn -------------------------------------------------
    def get_params(self):
        return {}, {}

    def init_params(self, initializer=None, arg_params=None,
                    aux_params=None, allow_missing=False, force_init=False,
                    allow_extra=False):
        self.params_initialized = True

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        self.optimizer_initialized = True

    def update(self):
        pass

    def install_monitor(self, mon):
        pass

    # -- binding and metrics ----------------------------------------------
    def update_metric(self, eval_metric, labels):
        if self._label_shapes is not None:
            eval_metric.update(labels, self.get_outputs())

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        if self.binded and not force_rebind:
            self.logger.warning("Already bound, ignoring bind()")
            return
        if grad_req != "write":
            raise ValueError("python modules only support grad_req='write'")
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self._data_shapes = _as_descs(data_shapes)
        self._label_shapes = _as_descs(label_shapes)
        self._output_shapes = self._compute_output_shapes()
        self.binded = True

    def _compute_output_shapes(self):
        raise NotImplementedError


class PythonLossModule(PythonModule):
    """A loss head in Python: forward keeps the scores, backward calls
    ``grad_func(scores, labels)`` for their gradient (an NDArray, or an
    array put on the scores' device)."""

    def __init__(self, name="pyloss", data_names=("data",),
                 label_names=("softmax_label",), logger=logging,
                 grad_func=None):
        if len(data_names) != 1 or len(label_names) != 1:
            raise ValueError("PythonLossModule takes one data + one label")
        if grad_func is not None and not callable(grad_func):
            raise TypeError("grad_func must be callable")
        super().__init__(data_names, label_names, [name + "_output"],
                         logger=logger)
        self._name = name
        self._grad_func = grad_func
        self._scores = None
        self._labels = None
        self._scores_grad = None

    def _compute_output_shapes(self):
        return [(self._name + "_output", self._data_shapes[0].shape)]

    def forward(self, data_batch, is_train=None):
        self._scores = data_batch.data[0]
        training = self.for_training if is_train is None else is_train
        if training and data_batch.label:
            self._labels = data_batch.label[0]

    def get_outputs(self, merge_multi_context=True):
        return [self._scores]

    def backward(self, out_grads=None):
        if out_grads is not None:
            raise ValueError("For a loss module, out_grads should be None")
        if not self.for_training:
            raise RuntimeError("re-bind with for_training=True")
        if self._grad_func is None:
            raise NotImplementedError(
                "PythonLossModule needs grad_func to backprop")
        grad = self._grad_func(self._scores, self._labels)
        self._scores_grad = grad if isinstance(grad, NDArray) else \
            nd_array(grad, ctx=context_of(self._scores._handle))

    def get_input_grads(self, merge_multi_context=True):
        return [self._scores_grad]
