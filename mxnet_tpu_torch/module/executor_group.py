"""DataParallelExecutorGroup: one executor per context, the batch split
between them (port of ``mxnet_tpu/module/executor_group.py``; reference
python/mxnet/module/executor_group.py:129, decide_slices :267).

One :class:`~mxnet_tpu_torch.executor.Executor` is bound on each
context's device for its slice of the batch, cut by ``work_load_list``
(``_split_input_slice``, the reference's rounding).  A batch is fed by
copying each host array's slice into the input array that executor bound
(``copy_``, ``non_blocking`` from pinned host memory when the executor is
on the card): nothing is rebound, so each step reads the same device
buffers every time.  The same context may come twice (two executors on
one card).  ``get_outputs(merge_multi_context=True)`` concatenates the
executors' outputs on the first one's device; ``get_params`` averages the
executors' copies, as the reference does.  Each executor keeps its own
BatchNorm statistics (MXNet's per-device statistics, as the JAX
package's executor group).

A ``shared_group`` (a bucket of a ``BucketingModule``) binds each
executor over the shared group's parameter, gradient and auxiliary
NDArrays of the same position, by name (reference ``bind_exec``): every
bucket reads and writes the same tensors.

``group2ctxs`` (ctx_group placement) binds each executor with its own
``group2ctx`` (:meth:`DataParallelExecutorGroup._prepare_group2ctxs`,
the reference's rule), so its grouped nodes run on their groups' devices
(:class:`~mxnet_tpu_torch.placement.SegmentedProgram`).
"""
from __future__ import annotations

import logging
from typing import List

import torch

from ..context import Context
from ..executor import Executor
from ..io.io import DataDesc
from ..ndarray.ndarray import NDArray

__all__ = ["DataParallelExecutorGroup"]


def _descs(shapes):
    return [x if isinstance(x, DataDesc) else DataDesc(*x)
            for x in (shapes or [])]


def _split_input_slice(batch_size: int, work_load_list) -> List[slice]:
    """The reference's ``executor_manager._split_input_slice``: each
    context's rows, by ``round(batch * w / total)``, the last taking the
    rest."""
    total = sum(work_load_list)
    if batch_size < len(work_load_list):
        raise ValueError("Too many slices. Some splits are empty.")
    slices, start = [], 0
    for i, w in enumerate(work_load_list):
        end = batch_size if i == len(work_load_list) - 1 else \
            start + int(round(batch_size * w / total))
        slices.append(slice(start, end))
        start = end
    return slices


class DataParallelExecutorGroup:
    def __init__(self, symbol, contexts, workload, data_shapes, label_shapes,
                 param_names, for_training, inputs_need_grad,
                 shared_group=None, logger=logging, fixed_param_names=None,
                 grad_req="write", state_names=None, group2ctxs=None):
        self.group2ctxs = self._prepare_group2ctxs(group2ctxs,
                                                   len(contexts))
        self.param_names = param_names
        self.arg_names = symbol.list_arguments()
        self.aux_names = symbol.list_auxiliary_states()
        self.symbol = symbol
        self.contexts = contexts
        self.workload = list(workload or [1] * len(contexts))
        self.slices: List[slice] = []
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

    @staticmethod
    def _prepare_group2ctxs(group2ctxs, ctx_len):
        """``group2ctxs`` as one ``{group: Context}`` dict per executor
        (reference executor_group.py:58): a list must hold one dict per
        context; in a dict, a single Context (or a list of one) is shared
        by every executor, a list of ``ctx_len`` contexts gives one to
        each."""
        if group2ctxs is None:
            return [None] * ctx_len
        if isinstance(group2ctxs, list):
            if len(group2ctxs) != ctx_len:
                raise ValueError(
                    "group2ctxs list must have one dict per context "
                    "(%d != %d)" % (len(group2ctxs), ctx_len))
            return group2ctxs
        if isinstance(group2ctxs, dict):
            per_replica = [dict() for _ in range(ctx_len)]
            for group, val in group2ctxs.items():
                if isinstance(val, Context):
                    spread = [val] * ctx_len
                elif len(val) == 1:
                    spread = list(val) * ctx_len
                elif len(val) == ctx_len:
                    spread = list(val)
                else:
                    raise ValueError(
                        "group2ctxs[%r] must hold 1 or %d contexts, got %d"
                        % (group, ctx_len, len(val)))
                for i in range(ctx_len):
                    per_replica[i][group] = spread[i]
            return per_replica
        raise TypeError(
            "group2ctxs must be None, a dict of str->Context(s), or a list "
            "of such dicts; got %r" % type(group2ctxs))

    def bind_exec(self, data_shapes, label_shapes, shared_group=None,
                  reshape=False):
        self.data_shapes = _descs(data_shapes)
        self.label_shapes = _descs(label_shapes)
        self.batch_size = self.data_shapes[0].shape[0]
        self.slices = _split_input_slice(self.batch_size, self.workload)
        types = {d.name: d.dtype for d in self.data_shapes
                 + self.label_shapes}
        execs = []
        for i, (ctx, sl) in enumerate(zip(self.contexts, self.slices)):
            shapes = {d.name: (sl.stop - sl.start,) + tuple(d.shape[1:])
                      for d in self.data_shapes + self.label_shapes}
            if reshape and len(self.execs) == len(self.contexts):
                execs.append(self.execs[i].reshape(**shapes))
                continue
            shared = shared_group.execs[i] if shared_group is not None \
                and i < len(shared_group.execs) else None
            execs.append(Executor.simple_bind(
                self.symbol, ctx, grad_req=self.grad_req, type_dict=types,
                shared_exec=shared, shared_arg_names=self.param_names,
                group2ctx=self.group2ctxs[i], **shapes))
        self.execs = execs

    def reshape(self, data_shapes, label_shapes):
        self.bind_exec(data_shapes, label_shapes, reshape=True)

    def set_params(self, arg_params, aux_params, allow_extra=False):
        for ex in self.execs:
            ex.copy_params_from(arg_params, aux_params,
                                allow_extra_params=allow_extra)

    def get_params(self, arg_params, aux_params):
        """Put host copies of the executors' parameters into the dicts,
        averaged over the executors (new NDArrays: an array a caller took
        from an earlier call keeps its values; reference
        executor_group.py:376)."""
        for names, attr, dst in ((self.param_names, "arg_dict", arg_params),
                                 (self.aux_names, "aux_dict", aux_params)):
            for name in names:
                arrs = [getattr(ex, attr)[name]._handle for ex in self.execs
                        if name in getattr(ex, attr)]
                if not arrs:
                    continue
                host = arrs[0].to("cpu", copy=True)
                if len(arrs) > 1:
                    host = torch.stack([a.to("cpu") for a in arrs]).mean(
                        0).to(host.dtype)
                dst[name] = NDArray(host)

    def _slice_batch(self, arrays, names):
        """Copy each executor's rows of the host batch arrays into its
        bound inputs without blocking: a batch already in pinned memory (a
        data-IO iterator's) is copied as it is, any other host batch is
        pinned first."""
        for name, arr in zip(names, arrays):
            src = arr._handle if isinstance(arr, NDArray) else \
                torch.as_tensor(arr)
            for ex, sl in zip(self.execs, self.slices):
                tgt = ex.arg_dict.get(name)
                if tgt is None:
                    continue
                part = src if len(self.execs) == 1 else src[sl]
                if tgt._handle.device.type == "cuda" and \
                        part.device.type == "cpu" and not part.is_pinned():
                    part = part.pin_memory()
                tgt._handle.copy_(part, non_blocking=True)

    def _load_batch(self, data_batch):
        self._slice_batch(data_batch.data,
                          [d.name for d in self.data_shapes])
        if self.label_shapes and data_batch.label:
            self._slice_batch(data_batch.label,
                              [d.name for d in self.label_shapes])

    def forward(self, data_batch, is_train=None):
        """reference executor_group.py:422"""
        self._load_batch(data_batch)
        for ex in self.execs:
            ex.forward(is_train=self.for_training
                       if is_train is None else is_train)

    def forward_backward(self, data_batch):
        """Forward and backward of one batch on every executor."""
        self._load_batch(data_batch)
        for ex in self.execs:
            ex.run_fwd_bwd(is_train=True)

    def backward(self, out_grads=None):
        """reference executor_group.py:554: each executor takes its rows
        of ``out_grads``."""
        if not self.for_training:
            raise RuntimeError("re-bind with for_training=True")
        for ex, sl in zip(self.execs, self.slices):
            og = out_grads
            if out_grads is not None and len(self.execs) > 1:
                og = [NDArray(g._handle[sl].to(ex._ctx.torch_device))
                      if isinstance(g, NDArray) else g[sl]
                      for g in out_grads]
            ex.backward(out_grads=og)

    def _merge(self, per_exec):
        """Per output, the executors' arrays concatenated along the batch
        on the first executor's device."""
        out = []
        for parts in zip(*per_exec):
            dev = parts[0]._handle.device
            out.append(NDArray(torch.cat([p._handle.to(dev)
                                          for p in parts])))
        return out

    def get_outputs(self, merge_multi_context=True):
        if len(self.execs) == 1:
            return self.execs[0].outputs
        per = [ex.outputs for ex in self.execs]
        if merge_multi_context:
            return self._merge(per)
        return [list(parts) for parts in zip(*per)]

    def get_input_grads(self, merge_multi_context=True):
        per = [[ex.grad_dict[d.name] for d in self.data_shapes]
               for ex in self.execs]
        if len(self.execs) == 1:
            return per[0]
        if merge_multi_context:
            return self._merge(per)
        return [list(parts) for parts in zip(*per)]

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
