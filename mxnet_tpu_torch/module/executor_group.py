"""DataParallelExecutorGroup for one context (port of
``mxnet_tpu/module/executor_group.py``; reference
python/mxnet/module/executor_group.py:129).

One :class:`~mxnet_tpu_torch.executor.Executor` bound on the context's
device.  A batch is fed by copying each host array into the input array
the executor bound (``copy_``, ``non_blocking`` from pinned host memory
when the executor is on the card): nothing is rebound, so the step reads
the same device buffers every time.

A ``shared_group`` (a bucket of a ``BucketingModule``) binds its
executor over the shared group's parameter, gradient and auxiliary
NDArrays, by name (reference ``bind_exec``): every bucket reads and
writes the same tensors, so an update through any bucket is the update
of all.

A context list longer than one raises
:class:`~mxnet_tpu_torch.base.NotPortedYet`: data parallelism over cards
waits for NCCL (ROADMAP queue A item 7, distribution); so does
``group2ctxs``.
"""
from __future__ import annotations

import logging
from typing import List

import torch

from ..base import NotPortedYet
from ..executor import Executor
from ..io.io import DataDesc
from ..ndarray.ndarray import NDArray

__all__ = ["DataParallelExecutorGroup"]


def _descs(shapes):
    return [x if isinstance(x, DataDesc) else DataDesc(*x)
            for x in (shapes or [])]


class DataParallelExecutorGroup:
    def __init__(self, symbol, contexts, workload, data_shapes, label_shapes,
                 param_names, for_training, inputs_need_grad,
                 shared_group=None, logger=logging, fixed_param_names=None,
                 grad_req="write", state_names=None, group2ctxs=None):
        if len(contexts) != 1:
            raise NotPortedYet("a Module over %d contexts: data parallelism "
                               "over cards needs NCCL (ROADMAP queue A "
                               "item 7, distribution)" % len(contexts))
        if group2ctxs:
            raise NotPortedYet("group2ctxs is not ported yet (ROADMAP "
                               "queue A item 7, distribution)")
        self.param_names = param_names
        self.arg_names = symbol.list_arguments()
        self.aux_names = symbol.list_auxiliary_states()
        self.symbol = symbol
        self.contexts = contexts
        self.workload = workload or [1]
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self.logger = logger
        self.fixed_param_names = set(fixed_param_names or [])
        self.state_names = set(state_names or [])
        self.execs: List[Executor] = []
        self.batch_size = None

        data_names = [x.name for x in _descs(data_shapes)]
        self.grad_req = {}
        for name in self.arg_names:
            if name in self.param_names:
                self.grad_req[name] = ("null" if name in
                                       self.fixed_param_names else grad_req)
            elif name in data_names:
                self.grad_req[name] = grad_req if inputs_need_grad \
                    else "null"
            else:
                self.grad_req[name] = "null"
        if not for_training:
            self.grad_req = {k: "null" for k in self.grad_req}
        self.bind_exec(data_shapes, label_shapes, shared_group)

    def bind_exec(self, data_shapes, label_shapes, shared_group=None,
                  reshape=False):
        self.data_shapes = _descs(data_shapes)
        self.label_shapes = _descs(label_shapes)
        self.batch_size = self.data_shapes[0].shape[0]
        shapes = {d.name: d.shape for d in self.data_shapes
                  + self.label_shapes}
        types = {d.name: d.dtype for d in self.data_shapes
                 + self.label_shapes}
        if reshape and self.execs:
            self.execs = [self.execs[0].reshape(**shapes)]
        else:
            shared = shared_group.execs[0] if shared_group is not None \
                and shared_group.execs else None
            self.execs = [Executor.simple_bind(
                self.symbol, self.contexts[0], grad_req=self.grad_req,
                type_dict=types, shared_exec=shared,
                shared_arg_names=self.param_names, **shapes)]

    def reshape(self, data_shapes, label_shapes):
        self.bind_exec(data_shapes, label_shapes, reshape=True)

    def set_params(self, arg_params, aux_params, allow_extra=False):
        for ex in self.execs:
            ex.copy_params_from(arg_params, aux_params,
                                allow_extra_params=allow_extra)

    def get_params(self, arg_params, aux_params):
        """Put host copies of the executor's parameters into the dicts
        (new NDArrays: an array a caller took from an earlier call keeps
        its values; reference executor_group.py:376)."""
        ex = self.execs[0]
        for names, src, dst in ((self.param_names, ex.arg_dict, arg_params),
                                (self.aux_names, ex.aux_dict, aux_params)):
            for name in names:
                if name in src:
                    dst[name] = NDArray(src[name]._handle.to("cpu",
                                                             copy=True))

    def _slice_batch(self, arrays, names):
        """Copy host batch arrays into the executor's bound inputs."""
        ex = self.execs[0]
        for name, arr in zip(names, arrays):
            tgt = ex.arg_dict.get(name)
            if tgt is None:
                continue
            src = arr._handle if isinstance(arr, NDArray) else \
                torch.as_tensor(arr)
            if tgt._handle.device.type == "cuda" and \
                    src.device.type == "cpu":
                src = src.pin_memory()
            tgt._handle.copy_(src, non_blocking=True)

    def _load_batch(self, data_batch):
        self._slice_batch(data_batch.data,
                          [d.name for d in self.data_shapes])
        if self.label_shapes and data_batch.label:
            self._slice_batch(data_batch.label,
                              [d.name for d in self.label_shapes])

    def forward(self, data_batch, is_train=None):
        """reference executor_group.py:422"""
        self._load_batch(data_batch)
        self.execs[0].forward(is_train=self.for_training
                              if is_train is None else is_train)

    def forward_backward(self, data_batch):
        """Forward and backward of one batch on the executor."""
        self._load_batch(data_batch)
        self.execs[0].run_fwd_bwd(is_train=True)

    def backward(self, out_grads=None):
        """reference executor_group.py:554"""
        if not self.for_training:
            raise RuntimeError("re-bind with for_training=True")
        self.execs[0].backward(out_grads=out_grads)

    def get_outputs(self, merge_multi_context=True):
        return self.execs[0].outputs

    def get_input_grads(self, merge_multi_context=True):
        return [self.execs[0].grad_dict[d.name] for d in self.data_shapes]

    def update_metric(self, eval_metric, labels):
        """Through ``update_dict`` with the outputs' and labels' names
        (reference executor_group.py:583)."""
        out_names = self.symbol.list_outputs()
        outputs = self.get_outputs()[:len(out_names)]
        if not self.label_shapes and labels:
            eval_metric.update(labels, outputs)
            return
        label_names = [d.name for d in self.label_shapes]
        eval_metric.update_dict(dict(zip(label_names, labels or [])),
                                dict(zip(out_names, outputs)))

    def install_monitor(self, mon):
        raise NotPortedYet("executor monitors are not ported yet "
                           "(ROADMAP queue A item 9, observability)")
