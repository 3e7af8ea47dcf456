"""``mx.contrib.autograd``, the legacy autograd API (port of
``mxnet_tpu/contrib/autograd.py``; reference python/mxnet/contrib/
autograd.py): ``train_section`` / ``test_section`` scopes,
``mark_variables``, ``compute_gradient``, ``grad_and_loss`` and ``grad``,
over :mod:`mxnet_tpu_torch.autograd`::

    with autograd.train_section():
        y = net(x)
        autograd.compute_gradient([y])
"""
import functools

from .. import autograd as _ag
from ..autograd import mark_variables  # noqa: F401  (same contract)

__all__ = ["set_is_training", "train_section", "test_section",
           "mark_variables", "backward", "compute_gradient",
           "grad_and_loss", "grad"]


def set_is_training(state):
    """The legacy flag sets both recording and training; returns the
    previous ``(recording, training)`` pair, which restores both when
    passed back."""
    rec, train = state if isinstance(state, tuple) else (state, state)
    return (_ag.set_recording(bool(rec)), _ag.set_training(bool(train)))


def train_section():
    """Record, with train-mode ops (Dropout active)."""
    return _ag.record(train_mode=True)


def test_section():
    """Neither record nor train."""
    return _ag.pause(train_mode=False)


def backward(outputs, out_grads=None, retain_graph=False):
    _ag.backward(outputs, head_grads=out_grads, retain_graph=retain_graph)


def compute_gradient(outputs):
    backward(outputs)


def grad_and_loss(func, argnum=None):
    """``func`` -> a function returning ``(gradients of the inputs,
    func's outputs)``; ``argnum`` picks the inputs (default: all)."""
    @functools.wraps(func)
    def wrapped(*args):
        from ..ndarray.ndarray import NDArray, zeros as nd_zeros
        picks = [argnum] if isinstance(argnum, int) else argnum
        inputs = list(args) if argnum is None else [args[i] for i in picks]
        grads = [nd_zeros(x.shape, dtype=x.dtype, ctx=x.context)
                 for x in inputs]
        mark_variables(inputs, grads)
        with train_section():
            outputs = func(*args)
            compute_gradient([outputs] if isinstance(outputs, NDArray)
                             else outputs)
        return grads, outputs
    return wrapped


def grad(func, argnum=None):
    """``func`` -> a function returning the gradients of its inputs."""
    wrapped = grad_and_loss(func, argnum)

    @functools.wraps(func)
    def only_grads(*args):
        return wrapped(*args)[0]
    return only_grads
