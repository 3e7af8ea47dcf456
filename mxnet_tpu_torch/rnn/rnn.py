"""Fused-weight-aware checkpoint helpers for RNN training (port of
``mxnet_tpu/rnn/rnn.py``; reference python/mxnet/rnn/rnn.py).

Checkpoints always store the *unpacked* per-gate weights, so they stay
portable between fused and unfused cell stacks, and between the
packages.
"""
from __future__ import annotations

from ..model import load_checkpoint, save_checkpoint

__all__ = ["save_rnn_checkpoint", "load_rnn_checkpoint", "do_rnn_checkpoint"]


def _each_cell(cells):
    return cells if isinstance(cells, (list, tuple)) else (cells,)


def save_rnn_checkpoint(cells, prefix, epoch, symbol, arg_params, aux_params):
    """Save with fused blobs expanded to per-gate weights."""
    for cell in _each_cell(cells):
        arg_params = cell.unpack_weights(arg_params)
    save_checkpoint(prefix, epoch, symbol, arg_params, aux_params)


def load_rnn_checkpoint(cells, prefix, epoch):
    """Load and re-fuse per-gate weights for the given cell stack."""
    sym, arg_params, aux_params = load_checkpoint(prefix, epoch)
    for cell in _each_cell(cells):
        arg_params = cell.pack_weights(arg_params)
    return sym, arg_params, aux_params


def do_rnn_checkpoint(cells, prefix, period=1):
    """Epoch-end callback that checkpoints every ``period`` epochs."""
    every = max(1, int(period))

    def _callback(iter_no, sym=None, arg=None, aux=None):
        if (iter_no + 1) % every == 0:
            save_rnn_checkpoint(cells, prefix, iter_no + 1, sym, arg, aux)

    return _callback
