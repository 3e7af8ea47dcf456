"""SequentialModule: modules chained so that each one's outputs feed the
next one's inputs (port of ``mxnet_tpu/module/sequential_module.py``;
reference python/mxnet/module/sequential_module.py).

Per-link metadata says which links take the labels (``take_labels``) and
whether a link's input names are rewired to the previous outputs
(``auto_wiring``).  Forward passes a shallow copy of the batch down the
chain; backward passes the input gradients back up.
"""
from __future__ import annotations

import copy
import logging

from ..initializer import Uniform
from .base_module import BaseModule

__all__ = ["SequentialModule"]


class SequentialModule(BaseModule):
    META_TAKE_LABELS = "take_labels"
    META_AUTO_WIRING = "auto_wiring"
    _KNOWN_META = frozenset((META_TAKE_LABELS, META_AUTO_WIRING))

    def __init__(self, logger=logging):
        super().__init__(logger=logger)
        self._chain = []          # [(module, meta dict)]
        self._label_shapes = None

    def _links(self):
        return [mod for mod, _ in self._chain]

    def _wants_labels(self, meta):
        return bool(meta.get(self.META_TAKE_LABELS))

    def _require(self, params=False, optimizer=False):
        if not self.binded:
            raise RuntimeError("this SequentialModule is not bound yet")
        if params and not self.params_initialized:
            raise RuntimeError("parameters not initialized")
        if optimizer and not self.optimizer_initialized:
            raise RuntimeError("optimizer not initialized")

    def add(self, module, **meta):
        """Append a module; the chain must be bound and initialised
        again."""
        unknown = set(meta) - self._KNOWN_META
        if unknown:
            raise ValueError('Unknown meta "%s"' % unknown.pop())
        self._chain.append((module, meta))
        self.binded = False
        self.params_initialized = False
        self.optimizer_initialized = False
        return self

    # -- introspection ----------------------------------------------------
    @property
    def data_names(self):
        return self._chain[0][0].data_names if self._chain else []

    @property
    def output_names(self):
        return self._chain[-1][0].output_names if self._chain else []

    @property
    def data_shapes(self):
        self._require()
        return self._chain[0][0].data_shapes

    @property
    def label_shapes(self):
        self._require()
        return self._label_shapes

    @property
    def output_shapes(self):
        self._require()
        return self._chain[-1][0].output_shapes

    # -- parameters -------------------------------------------------------
    def get_params(self):
        self._require(params=True)
        merged_args, merged_auxs = {}, {}
        for link in self._links():
            args, auxs = link.get_params()
            merged_args.update(args)
            merged_auxs.update(auxs)
        return merged_args, merged_auxs

    def init_params(self, initializer=Uniform(0.01), arg_params=None,
                    aux_params=None, allow_missing=False, force_init=False,
                    allow_extra=False):
        if self.params_initialized and not force_init:
            return
        self._require()
        for link in self._links():
            link.init_params(initializer=initializer, arg_params=arg_params,
                             aux_params=aux_params,
                             allow_missing=allow_missing,
                             force_init=force_init, allow_extra=allow_extra)
        self._assert_unique_param_names()
        self.params_initialized = True

    def _assert_unique_param_names(self):
        """A name in two links would alias two parameters: refused."""
        owner = {}
        for pos, link in enumerate(self._links()):
            args, auxs = link.get_params()
            for name in list(args) + list(auxs):
                if name in owner:
                    raise ValueError(
                        'Duplicated parameter names: name "%s" in layer %d '
                        "(%s) is already used in layer %d (%s)."
                        % (name, pos, type(link), owner[name],
                           type(self._chain[owner[name]][0])))
                owner[name] = pos

    # -- binding ----------------------------------------------------------
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        if self.binded and not force_rebind:
            self.logger.warning("Already bound, ignoring bind()")
            return
        if shared_module is not None:
            raise ValueError("Shared module is not supported")
        if not self._chain:
            raise ValueError("add() at least one module before bind()")
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self.binded = True
        self._label_shapes = label_shapes

        feed = data_shapes
        labels_used = False
        for pos, (link, meta) in enumerate(self._chain):
            takes_labels = self._wants_labels(meta)
            labels_used |= takes_labels
            if meta.get(self.META_AUTO_WIRING):
                names = link.data_names
                if len(names) != len(feed):
                    raise ValueError("auto_wiring: %d inputs for %d names"
                                     % (len(feed), len(names)))
                feed = [(name, shape)
                        for name, (_, shape) in zip(names, feed)]
            link.bind(data_shapes=feed,
                      label_shapes=label_shapes if takes_labels else None,
                      for_training=for_training,
                      # the links after the first pass gradients back
                      inputs_need_grad=bool(
                          inputs_need_grad or (for_training and pos > 0)),
                      force_rebind=force_rebind, shared_module=None,
                      grad_req=grad_req)
            feed = link.output_shapes

        if not labels_used:
            self._label_shapes = None

    # -- optimizer and the train step -------------------------------------
    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        self._require(params=True)
        if self.optimizer_initialized and not force_init:
            self.logger.warning("optimizer already initialized, ignoring.")
            return
        for link in self._links():
            link.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                                optimizer_params=optimizer_params,
                                force_init=force_init)
        self.optimizer_initialized = True

    def forward(self, data_batch, is_train=None):
        self._require(params=True)
        relay = copy.copy(data_batch)
        tail = len(self._chain) - 1
        for pos, (link, _) in enumerate(self._chain):
            link.forward(relay, is_train=is_train)
            if pos == tail:
                return
            relay.data = link.get_outputs()
            if hasattr(relay, "provide_data"):
                names = [spec[0] for spec in link.output_shapes]
                relay.provide_data = [(name, out.shape) for name, out
                                      in zip(names, relay.data)]

    def backward(self, out_grads=None):
        self._require(params=True)
        for pos in range(len(self._chain) - 1, -1, -1):
            link = self._chain[pos][0]
            link.backward(out_grads=out_grads)
            if pos == 0:
                return
            out_grads = link.get_input_grads()

    def update(self):
        self._require(params=True, optimizer=True)
        for link in self._links():
            link.update()

    # -- results ----------------------------------------------------------
    def get_outputs(self, merge_multi_context=True):
        self._require(params=True)
        return self._chain[-1][0].get_outputs(merge_multi_context)

    def get_input_grads(self, merge_multi_context=True):
        self._require(params=True)
        if not self.inputs_need_grad:
            raise RuntimeError("bind(inputs_need_grad=True) required")
        return self._chain[0][0].get_input_grads(merge_multi_context)

    def update_metric(self, eval_metric, labels):
        self._require(params=True)
        for link, meta in self._chain:
            if self._wants_labels(meta):
                link.update_metric(eval_metric, labels)

    def install_monitor(self, mon):
        self._require()
        for link in self._links():
            link.install_monitor(mon)
