"""DataParallelExecutorManager, the legacy executor manager (port of
``mxnet_tpu/executor_manager.py``; reference
python/mxnet/executor_manager.py:295): a thin wrapper over the module
layer's executor group, one executor per context, the batch split by
``work_load_list``.

The default context is the card, as for ``Module``.
"""
from __future__ import annotations

import logging

from .context import Context, current_context
from .module.executor_group import (DataParallelExecutorGroup,
                                    _split_input_slice)

__all__ = ["DataParallelExecutorManager", "_split_input_slice"]


class DataParallelExecutorManager:
    def __init__(self, symbol, ctx, train_data, arg_names=None,
                 param_names=None, aux_names=None, work_load_list=None,
                 logger=None, sym_gen=None):
        ctx = current_context() if ctx is None else ctx
        ctx = [ctx] if isinstance(ctx, Context) else list(ctx)
        for c in ctx:
            c.torch_device             # a missing card raises here
        self.symbol = symbol
        self.ctx = ctx
        self.arg_names = symbol.list_arguments()
        input_names = [x[0] for x in train_data.provide_data +
                       (train_data.provide_label or [])]
        self.param_names = [n for n in self.arg_names
                            if n not in input_names]
        self.aux_names = symbol.list_auxiliary_states()
        self.execgrp = DataParallelExecutorGroup(
            symbol, ctx, work_load_list, train_data.provide_data,
            train_data.provide_label, self.param_names, for_training=True,
            inputs_need_grad=False, logger=logger or logging)
        self.slices = self.execgrp.slices

    def install_monitor(self, monitor):
        self.execgrp.install_monitor(monitor)

    def set_params(self, arg_params, aux_params):
        self.execgrp.set_params(arg_params, aux_params)

    def copy_to(self, arg_params, aux_params):
        self.execgrp.get_params(arg_params, aux_params)

    @property
    def param_arrays(self):
        return [[ex.arg_dict[n] for ex in self.execgrp.execs]
                for n in self.param_names]

    @property
    def grad_arrays(self):
        return [[ex.grad_dict.get(n) for ex in self.execgrp.execs]
                for n in self.param_names]

    @property
    def aux_arrays(self):
        return [[ex.aux_dict[n] for ex in self.execgrp.execs]
                for n in self.aux_names]

    def forward(self, is_train=False):
        for ex in self.execgrp.execs:
            ex.forward(is_train=is_train)

    def backward(self):
        for ex in self.execgrp.execs:
            ex.backward()

    def load_data_batch(self, data_batch):
        self.execgrp._load_batch(data_batch)

    def update_metric(self, metric, labels):
        self.execgrp.update_metric(metric, labels)
