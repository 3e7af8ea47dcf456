"""Gluon ``Trainer``: an Optimizer over a Block's Parameters (port of
``mxnet_tpu/gluon/trainer.py:35-167``; reference python/mxnet/gluon/
trainer.py).

The kvstore is made lazily at the first ``step`` through the port's
``model._create_kvstore``, with the reference's rule: a local store name
for parameters on one context makes no store, so the optimizer runs
locally key by key; parameters on several contexts (``initialize(ctx=
[...])``) or a ``dist_*`` name make one, on the first context's device;
a :class:`~mxnet_tpu_torch.kvstore.KVStore` object is used as given, with
``compression_params`` (two-bit compression on the card's kernel) and
``update_on_kvstore`` (push the copies' gradients and pull the weight
into every copy, per key, or reduce through the store and update each
copy locally, one updater per context as the reference keeps).  Each
parameter is one key, pushed and pulled in turn as the reference does.
"""
from __future__ import annotations

from .. import optimizer as opt
from ..base import NotPortedYet
from ..model import _create_kvstore
from .parameter import Parameter

__all__ = ["Trainer"]


def _as_param_list(params):
    """A ParameterDict, dict, list or tuple of Parameters as a list."""
    if hasattr(params, "values"):
        params = list(params.values())
    if not isinstance(params, (list, tuple)):
        raise ValueError("Trainer needs a list or dict of Parameters to "
                         "manage; got a %s" % type(params))
    for p in params:
        if not isinstance(p, Parameter):
            raise ValueError("Trainer needs Parameters to manage; the "
                             "collection contains a %s" % type(p))
    return list(params)


class Trainer:
    """Applies ``optimizer`` to ``params`` at each ``step(batch_size)``."""

    def __init__(self, params, optimizer, optimizer_params=None,
                 kvstore="device", compression_params=None,
                 update_on_kvstore=None, grad_guard=None):
        if grad_guard is not None:
            raise NotPortedYet("Trainer(grad_guard=) is not ported yet "
                               "(ROADMAP queue A item 8, resilience)")
        self._params = _as_param_list(params)
        self._compression_params = compression_params
        kwargs = dict(optimizer_params or {})
        self._scale = float(kwargs.get("rescale_grad", 1.0))
        if isinstance(optimizer, opt.Optimizer):
            if kwargs:
                raise ValueError("pass optimizer_params only with a "
                                 "string optimizer name, not an instance")
            self._optimizer = optimizer
        else:
            self._optimizer = opt.create(optimizer, **kwargs)
        self._optimizer.param_dict = dict(enumerate(self._params))
        self._updaters = [opt.get_updater(self._optimizer)]
        self._kv_request = (kvstore, update_on_kvstore)
        self._sync = None    # (store or None, update on the store)

    def _resolve_sync(self):
        want, on_kv_override = self._kv_request
        ctxs = self._params[0].list_ctx() if self._params else [None]
        self._updaters += [opt.get_updater(self._optimizer)
                           for _ in ctxs[len(self._updaters):]]
        store, on_kv = _create_kvstore(
            want, len(ctxs), {p.name: p.data() for p in self._params},
            device=ctxs[0].torch_device if ctxs[0] is not None else None)
        if on_kv_override is not None:
            on_kv = on_kv_override
        if store is not None:
            if self._compression_params:
                store.set_gradient_compression(self._compression_params)
            if on_kv:
                store.set_optimizer(self._optimizer)
            for idx, p in enumerate(self._params):
                store.init(idx, p.data())
        self._sync = (store, bool(store) and on_kv)
        return self._sync

    @property
    def _ready(self):
        return self._sync if self._sync is not None else \
            self._resolve_sync()

    @property
    def learning_rate(self):
        return self._optimizer.lr

    def set_learning_rate(self, lr):
        self._optimizer.set_learning_rate(lr)

    def step(self, batch_size, ignore_stale_grad=False):
        """Reduce the gradients through the store (when there is one),
        then update, with the gradients scaled by ``1 / batch_size``."""
        store, on_kv = self._ready
        self._optimizer.rescale_grad = self._scale / batch_size
        if not on_kv:
            self._reduce(store)
        self._apply(store, on_kv)

    def allreduce_grads(self):
        store, on_kv = self._ready
        if not on_kv:
            self._reduce(store)

    def update(self, batch_size, ignore_stale_grad=False):
        store, on_kv = self._ready
        if on_kv:
            raise RuntimeError(
                "update() is only meaningful when the optimizer runs "
                "locally; this Trainer updates on the kvstore - pass "
                "update_on_kvstore=False to split reduce from update")
        self._optimizer.rescale_grad = self._scale / batch_size
        self._apply(store, on_kv)

    def _reduce(self, store):
        if store is None:
            return
        for idx, p in enumerate(self._params):
            if p.grad_req != "null":
                store.push(idx, p.list_grad(), priority=-idx)
                store.pull(idx, p.list_grad(), priority=-idx)

    def _apply(self, store, on_kv):
        for idx, p in enumerate(self._params):
            if p.grad_req == "null":
                continue
            if on_kv:
                store.push(idx, p.list_grad(), priority=-idx)
                store.pull(idx, p.list_data(), priority=-idx)
            else:
                for upd, g, w in zip(self._updaters, p.list_grad(),
                                     p.list_data()):
                    upd(idx, g, w)

    def save_states(self, fname):
        store, on_kv = self._ready
        if on_kv:
            store.save_optimizer_states(fname, dump_optimizer=True)
        else:
            with open(fname, "wb") as f:
                f.write(self._updaters[0].get_states(dump_optimizer=True))

    def load_states(self, fname):
        store, on_kv = self._ready
        if on_kv:
            store.load_optimizer_states(fname)
            self._optimizer = store._updater.optimizer
        else:
            with open(fname, "rb") as f:
                states = f.read()
            for upd in self._updaters:
                upd.set_states(states)
                upd.optimizer = self._optimizer
