"""Fused recurrent layers (port of ``mxnet_tpu/gluon/rnn/rnn_layer.py``;
reference python/mxnet/gluon/rnn/rnn_layer.py).

``RNN``, ``LSTM`` and ``GRU`` run the fused ``RNN`` op (cuDNN's RNN on
the card, its plain time loop on the CPU) over the cuDNN canonical
packed blob, with the blob's pieces as per-gate-group Parameters named as
the reference names them (``l0_i2h_weight`` ... ``r1_h2h_bias``), so
checkpoints and initializers match.  Each forward concatenates the
Parameters into the blob, as the JAX package does; on the card cuDNN then
copies the blob's weights into its own layout (``ops/rnn.py``).
"""
from __future__ import annotations

import numpy as np

from ...ndarray.ndarray import NDArray, concatenate
from ..block import HybridBlock
from ..parameter import Parameter


class _RNNLayer(HybridBlock):
    def __init__(self, hidden_size, num_layers, layout, dropout,
                 bidirectional, input_size, i2h_weight_initializer,
                 h2h_weight_initializer, i2h_bias_initializer,
                 h2h_bias_initializer, mode, **kwargs):
        self._mode = mode  # needed by _alias() during Block.__init__
        super().__init__(**kwargs)
        assert layout in ("TNC", "NTC"), \
            "Invalid layout %s; must be one of ['TNC' or 'NTC']" % layout
        self._hidden_size = hidden_size
        self._num_layers = num_layers
        self._layout = layout
        self._dropout = dropout
        self._dir = 2 if bidirectional else 1
        self._input_size = input_size
        self._i2h_weight_initializer = i2h_weight_initializer
        self._h2h_weight_initializer = h2h_weight_initializer
        self._i2h_bias_initializer = i2h_bias_initializer
        self._h2h_bias_initializer = h2h_bias_initializer

        self._gates = {"rnn_relu": 1, "rnn_tanh": 1, "lstm": 4, "gru": 3}[mode]

        ng, ni, nh = self._gates, input_size, hidden_size
        for i in range(num_layers):
            for j in (["l", "r"] if self._dir == 2 else ["l"]):
                self._register_param("{}{}_i2h_weight".format(j, i),
                                     shape=(ng * nh, ni),
                                     init=i2h_weight_initializer)
                self._register_param("{}{}_h2h_weight".format(j, i),
                                     shape=(ng * nh, nh),
                                     init=h2h_weight_initializer)
                self._register_param("{}{}_i2h_bias".format(j, i),
                                     shape=(ng * nh,),
                                     init=i2h_bias_initializer)
                self._register_param("{}{}_h2h_bias".format(j, i),
                                     shape=(ng * nh,),
                                     init=h2h_bias_initializer)
            ni = nh * self._dir

    def _register_param(self, name, shape, init):
        from ..nn.basic_layers import _init_or
        p = self.params.get(name, shape=shape, init=_init_or(init),
                            allow_deferred_init=True)
        setattr(self, name, p)

    def _alias(self):
        return self._mode

    def state_info(self, batch_size=0):
        raise NotImplementedError

    def begin_state(self, batch_size=0, func=None, **kwargs):
        from ... import ndarray as ndm
        states = []
        for i, info in enumerate(self.state_info(batch_size)):
            if func is None:
                func = ndm.zeros
            states.append(func(shape=info["shape"], **kwargs))
        return states

    def _unfuse(self):
        """Return an unfused SequentialRNNCell (reference _unfuse)."""
        from .rnn_cell import (GRUCell, LSTMCell, RNNCell, SequentialRNNCell,
                               BidirectionalCell)
        get_cell = {
            "rnn_relu": lambda **kw: RNNCell(self._hidden_size,
                                             activation="relu", **kw),
            "rnn_tanh": lambda **kw: RNNCell(self._hidden_size,
                                             activation="tanh", **kw),
            "lstm": lambda **kw: LSTMCell(self._hidden_size, **kw),
            "gru": lambda **kw: GRUCell(self._hidden_size, **kw),
        }[self._mode]
        stack = SequentialRNNCell(prefix=self.prefix, params=self.params)
        with stack.name_scope():
            ni = self._input_size
            for i in range(self._num_layers):
                kwargs = {"input_size": ni,
                          "i2h_weight_initializer": self._i2h_weight_initializer,
                          "h2h_weight_initializer": self._h2h_weight_initializer,
                          "i2h_bias_initializer": self._i2h_bias_initializer,
                          "h2h_bias_initializer": self._h2h_bias_initializer}
                if self._dir == 2:
                    stack.add(BidirectionalCell(
                        get_cell(prefix="l%d_" % i, **kwargs),
                        get_cell(prefix="r%d_" % i, **kwargs)))
                else:
                    stack.add(get_cell(prefix="l%d_" % i, **kwargs))
                if self._dropout > 0 and i != self._num_layers - 1:
                    from .rnn_cell import DropoutCell
                    stack.add(DropoutCell(self._dropout))
                ni = self._hidden_size * self._dir
        return stack

    def _pack_params(self, F):
        """Concatenate per-gate params into the cuDNN canonical blob."""
        flat = []
        dirs = ["l", "r"] if self._dir == 2 else ["l"]
        for i in range(self._num_layers):
            for j in dirs:
                flat.append(getattr(self, "{}{}_i2h_weight".format(j, i))
                            .data().reshape((-1,)))
                flat.append(getattr(self, "{}{}_h2h_weight".format(j, i))
                            .data().reshape((-1,)))
        for i in range(self._num_layers):
            for j in dirs:
                flat.append(getattr(self, "{}{}_i2h_bias".format(j, i))
                            .data())
                flat.append(getattr(self, "{}{}_h2h_bias".format(j, i))
                            .data())
        return concatenate(flat, axis=0)

    def forward(self, inputs, states=None):
        from ... import ndarray as ndm
        batch_size = inputs.shape[self._layout.find("N")]
        skip_states = states is None
        if skip_states:
            states = self.begin_state(batch_size, ctx=inputs.context)
        if isinstance(states, NDArray):
            states = [states]
        for state, info in zip(states, self.state_info(batch_size)):
            if state.shape != info["shape"]:
                raise ValueError(
                    "Invalid recurrent state shape. Expecting %s, got %s."
                    % (str(info["shape"]), str(state.shape)))
        if self._input_size == 0:
            for i in (["l", "r"] if self._dir == 2 else ["l"]):
                p = getattr(self, "{}0_i2h_weight".format(i))
                p.shape = (self._gates * self._hidden_size,
                           inputs.shape[2] if self._layout == "TNC"
                           else inputs.shape[2])
            self._input_size = inputs.shape[2]
            # re-register remaining deferred params via infer
        out = self._forward_kernel(inputs, states)
        return out[0] if skip_states else out

    def _forward_kernel(self, inputs, states):
        from ... import ndarray as ndm
        if self._layout == "NTC":
            inputs = ndm.swapaxes(inputs, dim1=0, dim2=1)
        for _, p in self.collect_params().items():
            p._finish_deferred_init()
        params = self._pack_params(ndm)
        rnn_args = [inputs, params] + list(states)
        outputs = ndm.RNN(*rnn_args, state_size=self._hidden_size,
                          num_layers=self._num_layers,
                          bidirectional=self._dir == 2,
                          p=self._dropout, state_outputs=True,
                          mode=self._mode)
        if self._mode == "lstm":
            outputs, states = outputs[0], [outputs[1], outputs[2]]
        else:
            outputs, states = outputs[0], [outputs[1]]
        if self._layout == "NTC":
            outputs = ndm.swapaxes(outputs, dim1=0, dim2=1)
        return outputs, states


class RNN(_RNNLayer):
    """Elman RNN (reference rnn_layer.py RNN)."""

    def __init__(self, hidden_size, num_layers=1, activation="relu",
                 layout="TNC", dropout=0, bidirectional=False,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 input_size=0, **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, "rnn_" + activation, **kwargs)

    def state_info(self, batch_size=0):
        return [{"shape": (self._num_layers * self._dir, batch_size,
                           self._hidden_size), "__layout__": "LNC"}]


class LSTM(_RNNLayer):
    """reference rnn_layer.py LSTM."""

    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, "lstm", **kwargs)

    def state_info(self, batch_size=0):
        return [{"shape": (self._num_layers * self._dir, batch_size,
                           self._hidden_size), "__layout__": "LNC"},
                {"shape": (self._num_layers * self._dir, batch_size,
                           self._hidden_size), "__layout__": "LNC"}]


class GRU(_RNNLayer):
    """reference rnn_layer.py GRU."""

    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, "gru", **kwargs)

    def state_info(self, batch_size=0):
        return [{"shape": (self._num_layers * self._dir, batch_size,
                           self._hidden_size), "__layout__": "LNC"}]
