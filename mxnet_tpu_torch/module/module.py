"""Module: one Symbol, an executor group that runs it on its contexts,
and an optimizer loop (port of ``mxnet_tpu/module/module.py``; reference
python/mxnet/module/module.py: bind :363, init_optimizer :472, forward
:570, backward :612, update :629).

The default context is the card (``current_context()``, in a gang the
rank's device; a typed ``DeviceUnavailable`` without one); tests pass
``context=mx.cpu()``.  A list of contexts binds one executor per context,
the batch split by ``work_load_list`` (MXNet's ``context=[mx.gpu(i) for
i in range(n)]``); the store then sums the executors' gradients.  The
module keeps host copies of the parameters (``get_params``) and the
executors the device ones.  ``init_optimizer`` creates or adopts the
store (a local one on the first context's device, or a ``dist_*`` one
across the gang, which scales ``rescale_grad`` by the global batch: the
rank's batch times ``num_workers``), hands it ``compression_params`` and
seeds it; every ``update()`` then pushes each gradient and pulls the new
weight, or updates locally.

Stated difference from the JAX package: ``reshape`` (a batch of another
size) shares the bound parameter arrays with the new executor, as the
reference's does, instead of re-copying the host parameters into fresh
ones.

Checkpoints are the JAX package's files (``save_checkpoint`` /
``Module.load``; an optimizer-state file is a pickle of the updater's
states as host arrays, so it resumes in the package that wrote it).

``bind(shared_module=)`` binds over another bound Module's parameter,
gradient and auxiliary arrays and shares its host parameter dicts, and
``borrow_optimizer`` adopts its optimizer, store and updater (so the
optimizer state of a parameter is one, whichever module updates it):
the two halves of ``BucketingModule``.

``group2ctxs`` places each ``ctx_group`` on its context, in every
executor (``DataParallelExecutorGroup._prepare_group2ctxs``).

Not ported yet, each raising :class:`~mxnet_tpu_torch.base.NotPortedYet`
and naming its ROADMAP queue A item: monitors, ``MXNET_TPU_PREFLIGHT`` and
``MXNET_TPU_ATTRIBUTION`` (observability), the ``grad_guard`` of
``init_optimizer`` (resilience).

``prepare(data_batch, sparse_row_id_fn)`` pulls, before a batch, only
the rows ``sparse_row_id_fn(batch)`` names of each parameter from a
store that updates (``KVStore.row_sparse_pull``: the other rows of the
bound array become zero, as in the reference); ``fit`` calls it for the
next batch, and the step's full pull after ``update()`` writes every row
back.
"""
from __future__ import annotations

import logging
import warnings

import numpy as np

from .. import optimizer as opt_mod
from .. import telemetry
from ..base import NotPortedYet, armed_env
from ..context import Context, current_context
from ..initializer import InitDesc, Uniform
from ..io.io import DataDesc
from ..model import (_create_kvstore, _initialize_kvstore, _update_params,
                     _update_params_on_kvstore, load_checkpoint,
                     save_checkpoint)
from ..ndarray.ndarray import zeros as nd_zeros
from .base_module import BaseModule, _check_input_names
from .executor_group import DataParallelExecutorGroup

__all__ = ["Module"]

_BIND_KNOBS = ("MXNET_TPU_PREFLIGHT", "MXNET_TPU_ATTRIBUTION")


def _to_descs(shapes):
    """(name, shape) pairs or DataDescs -> DataDescs; empty -> None."""
    if not shapes:
        return None
    return [s if isinstance(s, DataDesc) else DataDesc(*s) for s in shapes]


class Module(BaseModule):
    """Symbol + executor group + optimizer (reference module.py:71)."""

    def _require(self, bound=False, params=False, optimizer=False):
        if bound and not self.binded:
            raise RuntimeError("this Module is not bound yet: call bind()")
        if params and not self.params_initialized:
            raise RuntimeError("parameters not initialized: call "
                               "init_params()")
        if optimizer and not self.optimizer_initialized:
            raise RuntimeError("optimizer not initialized: call "
                               "init_optimizer()")

    def __init__(self, symbol, data_names=("data",),
                 label_names=("softmax_label",), logger=logging,
                 context=None, work_load_list=None, fixed_param_names=None,
                 state_names=None, group2ctxs=None, compression_params=None):
        super().__init__(logger=logger)
        ctxs = context if context is not None else current_context()
        self._context = [ctxs] if isinstance(ctxs, Context) else list(ctxs)
        for c in self._context:
            c.torch_device                # a missing card raises here
        self._work_load_list = (work_load_list if work_load_list is not None
                                else [1] * len(self._context))
        if len(self._work_load_list) != len(self._context):
            raise ValueError("work_load_list has %d entries for %d contexts"
                             % (len(self._work_load_list),
                                len(self._context)))
        self._symbol = symbol
        self._data_names = list(data_names or [])
        self._label_names = list(label_names or [])
        self._state_names = list(state_names or [])
        self._fixed_param_names = list(fixed_param_names or [])
        self._output_names = symbol.list_outputs()
        self._aux_names = symbol.list_auxiliary_states()
        inputs = set(self._data_names) | set(self._label_names)
        self._param_names = [a for a in symbol.list_arguments()
                             if a not in inputs]
        self._group2ctxs = group2ctxs
        self._compression_params = compression_params
        for names, role, required in (
                (self._data_names, "data", True),
                (self._label_names, "label", False),
                (self._state_names, "state", True),
                (self._fixed_param_names, "fixed_param", True)):
            _check_input_names(symbol, names, role, required)
        self._arg_params = self._aux_params = None
        self._optimizer = self._kvstore = self._updater = None
        self._update_on_kvstore = None
        self._exec_group = self._data_shapes = self._label_shapes = None
        self._preload_opt_states = None
        self._params_dirty = False

    # -- introspection ----------------------------------------------------
    @property
    def data_names(self):
        return self._data_names

    @property
    def label_names(self):
        return self._label_names

    @property
    def output_names(self):
        return self._output_names

    @property
    def data_shapes(self):
        self._require(bound=True)
        return self._data_shapes

    @property
    def label_shapes(self):
        self._require(bound=True)
        return self._label_shapes

    @property
    def output_shapes(self):
        """(name, shape) of each output: the last forward's, else
        inferred from the bound input shapes (so that a module chained
        after this one can bind before any forward)."""
        self._require(bound=True)
        outs = self._exec_group.get_outputs() \
            if self._exec_group.execs[0].outputs else None
        if not outs:
            shapes = {d.name: d.shape for d in self._data_shapes
                      + (self._label_shapes or [])}
            return list(zip(self._output_names,
                            self._symbol.infer_shape(**shapes)[1]))
        return [(name, out.shape) for name, out
                in zip(self._output_names, outs)]

    # -- parameters -------------------------------------------------------
    def get_params(self):
        """Host copies of the parameters, refreshed from the card when an
        update has run since."""
        self._require(bound=True, params=True)
        if self._params_dirty:
            self._sync_params_from_devices()
        return self._arg_params, self._aux_params

    def init_params(self, initializer=Uniform(0.01), arg_params=None,
                    aux_params=None, allow_missing=False, force_init=False,
                    allow_extra=False):
        """Fill host copies of every parameter from the given dicts or the
        initializer, then copy them into the executor (reference
        module.py:233).  The initializer draws on the host from the
        ``mx.random.seed`` stream, as the JAX package's does."""
        if self.params_initialized and not force_init:
            warnings.warn("parameters already set; init_params is a no-op "
                          "without force_init", stacklevel=2)
            return
        self._require(bound=True)
        ex0 = self._exec_group.execs[0]

        def materialize(names, device_dict, current):
            if current is not None:
                return current
            return {n: nd_zeros(device_dict[n].shape, ctx="cpu",
                                dtype=device_dict[n].dtype)
                    for n in names if n in device_dict}

        self._arg_params = materialize(self._param_names, ex0.arg_dict,
                                       self._arg_params)
        self._aux_params = materialize(self._aux_names, ex0.aux_dict,
                                       self._aux_params)
        attrs = self._symbol.attr_dict()

        def fill(host, source):
            for name in sorted(host):
                arr = host[name]
                given = None if source is None else source.get(name)
                if given is not None:
                    if given is not arr:
                        given.copyto(arr)
                elif source is not None and not allow_missing:
                    raise RuntimeError("parameter %r missing from the "
                                       "provided dict (allow_missing=False)"
                                       % name)
                elif initializer is not None:
                    initializer(InitDesc(name, attrs.get(name)), arr)

        fill(self._arg_params, arg_params)
        fill(self._aux_params, aux_params)
        self.params_initialized = True
        self._params_dirty = False
        self._exec_group.set_params(self._arg_params, self._aux_params,
                                    allow_extra=allow_extra)

    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True, allow_extra=False):
        if not allow_missing:
            self.init_params(initializer=None, arg_params=arg_params,
                             aux_params=aux_params, allow_missing=False,
                             force_init=force_init, allow_extra=allow_extra)
            return
        if self.params_initialized and not force_init:
            warnings.warn("parameters already set; set_params is a no-op "
                          "without force_init", stacklevel=2)
            return
        self._exec_group.set_params(arg_params, aux_params,
                                    allow_extra=allow_extra)
        self._params_dirty = True
        self.params_initialized = True

    # -- binding ----------------------------------------------------------
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        """Allocate the executor's arrays on the card for the given input
        shapes (reference module.py:363).  With ``shared_module`` (a
        bound Module with parameters), its parameter, gradient and aux
        arrays are this module's too, by name, and so are its host
        parameter dicts (reference module.py:221-280)."""
        armed = armed_env(_BIND_KNOBS)
        if armed:
            raise NotPortedYet("not ported to Module.bind: %s (ROADMAP "
                               "queue A item 9, observability)"
                               % ", ".join(armed))
        if shared_module is not None and not (
                isinstance(shared_module, Module) and shared_module.binded
                and shared_module.params_initialized):
            raise ValueError("shared_module must be a bound Module with "
                             "initialized parameters")
        if force_rebind:
            self.binded = False
            self._exec_group = self._data_shapes = self._label_shapes = None
        if self.binded:
            self.logger.warning("Already bound, ignoring bind()")
            return
        if not for_training and inputs_need_grad:
            raise ValueError("inputs_need_grad needs for_training")
        self.for_training, self.inputs_need_grad = (for_training,
                                                    inputs_need_grad)
        self._data_shapes = _to_descs(data_shapes)
        self._label_shapes = _to_descs(label_shapes)
        self._exec_group = DataParallelExecutorGroup(
            self._symbol, self._context, self._work_load_list,
            self._data_shapes, self._label_shapes, self._param_names,
            for_training, inputs_need_grad,
            None if shared_module is None else shared_module._exec_group,
            logger=self.logger, fixed_param_names=self._fixed_param_names,
            grad_req=grad_req, state_names=self._state_names,
            group2ctxs=self._group2ctxs)
        self.binded = True
        from ..telemetry import memory as _memory
        for ex in self._exec_group.execs:
            _memory.tag([a._handle for a in ex.arg_arrays + ex.aux_arrays],
                        "params", label="Module.arg")
            _memory.tag([g._handle for g in ex.grad_arrays if g is not None],
                        "activations", label="Module.grad")
        if shared_module is not None:
            self._arg_params = shared_module._arg_params
            self._aux_params = shared_module._aux_params
            self.params_initialized = True
        elif self.params_initialized:
            self._exec_group.set_params(self._arg_params, self._aux_params)

    def reshape(self, data_shapes, label_shapes=None):
        """New input shapes; the parameter arrays stay shared."""
        self._require(bound=True)
        self._data_shapes = _to_descs(data_shapes)
        self._label_shapes = _to_descs(label_shapes)
        self._exec_group.reshape(self._data_shapes, self._label_shapes)

    # -- optimizer --------------------------------------------------------
    def _param_index_names(self, update_on_kvstore):
        names = self._exec_group.param_names
        if update_on_kvstore:
            return dict(enumerate(names))
        n_dev = len(self._context)
        return {i * n_dev + k: name
                for i, name in enumerate(names) for k in range(n_dev)}

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False, grad_guard=None):
        """Create or adopt the store, set its gradient compression, seed
        it from the executor and install the optimizer (reference
        module.py:472)."""
        self._require(bound=True, params=True)
        if grad_guard is not None:
            raise NotPortedYet("init_optimizer(grad_guard=): GradientGuard "
                               "is not ported yet (ROADMAP queue A item 8, "
                               "resilience)")
        if self.optimizer_initialized and not force_init:
            self.logger.warning("optimizer already initialized, ignoring...")
            return
        if self._params_dirty:
            self._sync_params_from_devices()
        kvstore, update_on_kvstore = _create_kvstore(
            kvstore, len(self._context), self._arg_params,
            device=self._context[0].torch_device)
        batch = self._exec_group.batch_size
        if kvstore and "dist" in kvstore.type and "_sync" in kvstore.type:
            batch *= kvstore.num_workers
        rescale = 1.0 / batch
        idx2name = self._param_index_names(update_on_kvstore)
        if isinstance(optimizer, str):
            kwargs = dict(optimizer_params)
            kwargs.setdefault("rescale_grad", rescale)
            optimizer = opt_mod.create(optimizer, sym=self.symbol,
                                       param_idx2name=idx2name, **kwargs)
        else:
            if not isinstance(optimizer, opt_mod.Optimizer):
                raise TypeError("optimizer must be a name or an Optimizer")
            if optimizer.rescale_grad != rescale:
                warnings.warn(
                    "externally created optimizer has rescale_grad=%s; the "
                    "global batch implies %s" % (optimizer.rescale_grad,
                                                 rescale))
            if not optimizer.idx2name:
                optimizer.idx2name = idx2name.copy()
        self._optimizer, self._kvstore = optimizer, kvstore
        self._update_on_kvstore, self._updater = update_on_kvstore, None
        if kvstore:
            if self._compression_params:
                kvstore.set_gradient_compression(self._compression_params)
            _initialize_kvstore(
                kvstore=kvstore, arg_params=self._arg_params,
                param_arrays=self._exec_group_param_arrays(),
                param_names=self._exec_group.param_names,
                update_on_kvstore=update_on_kvstore)
        if update_on_kvstore:
            kvstore.set_optimizer(self._optimizer)
        else:
            self._updater = opt_mod.get_updater(optimizer)
        self.optimizer_initialized = True
        if self._preload_opt_states is not None:
            self.load_optimizer_states(self._preload_opt_states)
            self._preload_opt_states = None

    def borrow_optimizer(self, shared_module):
        """Adopt another Module's optimizer, store and updater (reference
        module.py:375), so that modules over shared arrays keep one
        optimizer state per parameter."""
        if not shared_module.optimizer_initialized:
            raise RuntimeError("the shared module's optimizer is not "
                               "initialized")
        for attr in ("_optimizer", "_kvstore", "_update_on_kvstore",
                     "_updater"):
            setattr(self, attr, getattr(shared_module, attr))
        self.optimizer_initialized = True

    def _exec_group_param_arrays(self):
        """Per parameter, the list of its per-device arrays."""
        return [[ex.arg_dict[name] for ex in self._exec_group.execs]
                for name in self._exec_group.param_names]

    def _exec_group_grad_arrays(self):
        return [[ex.grad_dict.get(name) for ex in self._exec_group.execs]
                for name in self._exec_group.param_names]

    # -- the train step ---------------------------------------------------
    def forward(self, data_batch, is_train=None):
        self._require(bound=True, params=True)
        self._rebind_for(data_batch)
        with telemetry.span("module/forward", cat="module"):
            self._exec_group.forward(data_batch, is_train)

    def _rebind_for(self, data_batch):
        """A batch of another shape (e.g. a last partial batch): reshape
        the executor group to it."""
        incoming = tuple(a.shape for a in data_batch.data)
        if tuple(d.shape for d in self._data_shapes) == incoming:
            return
        new_data = [DataDesc(d.name, shp, d.dtype, d.layout)
                    for d, shp in zip(self._data_shapes, incoming)]
        if getattr(data_batch, "provide_label", None):
            new_label = data_batch.provide_label
        elif getattr(data_batch, "label", None):
            new_label = [DataDesc(d.name, a.shape, d.dtype, d.layout)
                         for d, a in zip(self._label_shapes or [],
                                         data_batch.label)]
        else:
            new_label = None
        self.reshape(new_data, new_label)

    def forward_backward(self, data_batch):
        """Forward and backward of one batch."""
        self._require(bound=True, params=True)
        self._rebind_for(data_batch)
        with telemetry.span("module/forward_backward", cat="module"):
            self._exec_group.forward_backward(data_batch)

    def backward(self, out_grads=None):
        self._require(bound=True, params=True)
        with telemetry.span("module/backward", cat="module"):
            self._exec_group.backward(out_grads=out_grads)

    def update(self):
        """One optimizer step for every parameter (reference
        module.py:629): through the store, or locally."""
        self._require(bound=True, params=True, optimizer=True)
        with telemetry.span("module/update", cat="module"):
            self._params_dirty = True
            if self._update_on_kvstore:
                _update_params_on_kvstore(self._exec_group_param_arrays(),
                                          self._exec_group_grad_arrays(),
                                          self._kvstore,
                                          self._exec_group.param_names)
            else:
                _update_params(self._exec_group_param_arrays(),
                               self._exec_group_grad_arrays(),
                               updater=self._updater, kvstore=self._kvstore,
                               num_device=len(self._context),
                               param_names=self._exec_group.param_names)

    def get_outputs(self, merge_multi_context=True):
        self._require(bound=True, params=True)
        return self._exec_group.get_outputs(merge_multi_context)

    def get_input_grads(self, merge_multi_context=True):
        self._require(bound=True, params=True)
        if not self.inputs_need_grad:
            raise RuntimeError("bind(inputs_need_grad=True) required")
        return self._exec_group.get_input_grads(merge_multi_context)

    def update_metric(self, eval_metric, labels):
        self._exec_group.update_metric(eval_metric, labels)

    def _sync_params_from_devices(self):
        """The bound arrays' values into the host parameter dicts; a
        row_sparse parameter of a store that updates is pulled whole
        (every row id, as the reference's ``arange``; the JAX package
        passes ``zeros`` here, which pulls row 0 alone)."""
        self._exec_group.get_params(self._arg_params, self._aux_params)
        if self._kvstore and self._update_on_kvstore:
            for name, val in sorted(self._arg_params.items()):
                if val.stype == "row_sparse":
                    self._kvstore.row_sparse_pull(
                        name, val, row_ids=np.arange(val.shape[0]))
        self._params_dirty = False

    # -- checkpoints ------------------------------------------------------
    @classmethod
    def load(cls, prefix, epoch, load_optimizer_states=False, **kwargs):
        """A Module of ``prefix-symbol.json`` with the parameters of
        ``epoch`` (reference module.py:164); the optimizer states
        (``prefix-%04d.states``) are loaded when the optimizer is
        initialized."""
        sym, args, auxs = load_checkpoint(prefix, epoch)
        mod = cls(symbol=sym, **kwargs)
        mod._arg_params, mod._aux_params = args, auxs
        mod.params_initialized = True
        if load_optimizer_states:
            mod._preload_opt_states = "%s-%04d.states" % (prefix, epoch)
        return mod

    def save_checkpoint(self, prefix, epoch, save_optimizer_states=False):
        """``prefix-symbol.json``, ``prefix-%04d.params`` and, with
        ``save_optimizer_states``, ``prefix-%04d.states`` (reference
        module.py:126)."""
        self._sync_params_from_devices()
        save_checkpoint(prefix, epoch, self.symbol, self._arg_params,
                        self._aux_params)
        if save_optimizer_states:
            self.save_optimizer_states("%s-%04d.states" % (prefix, epoch))

    def save_optimizer_states(self, fname):
        """Pickle the optimizer states (the store's when it updates)."""
        self._require(optimizer=True)
        if self._update_on_kvstore:
            self._kvstore.save_optimizer_states(fname)
            return
        with open(fname, "wb") as f:
            f.write(self._updater.get_states())

    def load_optimizer_states(self, fname):
        self._require(optimizer=True)
        if self._update_on_kvstore:
            self._kvstore.load_optimizer_states(fname)
            return
        with open(fname, "rb") as f:
            self._updater.set_states(f.read())

    def install_monitor(self, mon):
        raise NotPortedYet("Module.install_monitor: executor monitors are "
                           "not ported yet (ROADMAP queue A item 9, "
                           "observability)")

    def prepare(self, data_batch, sparse_row_id_fn=None):
        """Pull the rows ``sparse_row_id_fn(data_batch)`` (``{param name:
        row ids}``) of each named parameter into its bound arrays
        (reference module.py:478); a warning, and nothing pulled, unless
        the store does the updates."""
        self._require(bound=True)
        if sparse_row_id_fn is None:
            return
        if not (self._kvstore and self._update_on_kvstore):
            warnings.warn(UserWarning(
                "sparse_row_id_fn does nothing without a kvstore doing "
                "the updates"))
            return
        names = self._exec_group.param_names
        for name, row_id in sparse_row_id_fn(data_batch).items():
            if name not in names:
                continue
            arrays = self._exec_group_param_arrays()[names.index(name)]
            self._kvstore.row_sparse_pull(name, arrays,
                                          row_ids=[row_id] * len(arrays))
