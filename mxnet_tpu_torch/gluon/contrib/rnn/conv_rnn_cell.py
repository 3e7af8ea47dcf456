"""Convolutional LSTM cell (port of
``mxnet_tpu/gluon/contrib/rnn/conv_rnn_cell.py``; reference
gluon/contrib/rnn/conv_rnn_cell.py, the symbolic ConvLSTM of
python/mxnet/rnn/rnn_cell.py:1253)."""
from __future__ import annotations

from ...rnn.rnn_cell import HybridRecurrentCell
from ...nn.basic_layers import _init_or


class Conv2DLSTMCell(HybridRecurrentCell):
    """2-D convolutional LSTM (xLSTM gates computed by convolutions)."""

    def __init__(self, input_shape, hidden_channels, i2h_kernel, h2h_kernel,
                 i2h_pad=(0, 0), activation="tanh", prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._input_shape = tuple(input_shape)  # (C, H, W)
        self._hidden_channels = hidden_channels
        self._i2h_kernel = (i2h_kernel,) * 2 if isinstance(i2h_kernel, int) \
            else tuple(i2h_kernel)
        self._h2h_kernel = (h2h_kernel,) * 2 if isinstance(h2h_kernel, int) \
            else tuple(h2h_kernel)
        self._i2h_pad = (i2h_pad,) * 2 if isinstance(i2h_pad, int) \
            else tuple(i2h_pad)
        self._h2h_pad = (self._h2h_kernel[0] // 2, self._h2h_kernel[1] // 2)
        self._activation = activation
        cin = self._input_shape[0]
        self.i2h_weight = self.params.get(
            "i2h_weight", shape=(4 * hidden_channels, cin) + self._i2h_kernel,
            allow_deferred_init=True)
        self.h2h_weight = self.params.get(
            "h2h_weight",
            shape=(4 * hidden_channels, hidden_channels) + self._h2h_kernel,
            allow_deferred_init=True)
        self.i2h_bias = self.params.get(
            "i2h_bias", shape=(4 * hidden_channels,), init=_init_or("zeros"),
            allow_deferred_init=True)
        self.h2h_bias = self.params.get(
            "h2h_bias", shape=(4 * hidden_channels,), init=_init_or("zeros"),
            allow_deferred_init=True)

    def state_info(self, batch_size=0):
        c, h, w = self._input_shape
        oh = h + 2 * self._i2h_pad[0] - self._i2h_kernel[0] + 1
        ow = w + 2 * self._i2h_pad[1] - self._i2h_kernel[1] + 1
        shape = (batch_size, self._hidden_channels, oh, ow)
        return [{"shape": shape, "__layout__": "NCHW"},
                {"shape": shape, "__layout__": "NCHW"}]

    def _alias(self):
        return "conv_lstm"

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        i2h = F.Convolution(inputs, i2h_weight, i2h_bias,
                            kernel=self._i2h_kernel, pad=self._i2h_pad,
                            num_filter=4 * self._hidden_channels)
        h2h = F.Convolution(states[0], h2h_weight, h2h_bias,
                            kernel=self._h2h_kernel, pad=self._h2h_pad,
                            num_filter=4 * self._hidden_channels)
        gates = i2h + h2h
        slices = F.SliceChannel(gates, num_outputs=4, axis=1)
        in_gate = F.Activation(slices[0], act_type="sigmoid")
        forget_gate = F.Activation(slices[1], act_type="sigmoid")
        in_transform = F.Activation(slices[2], act_type=self._activation)
        out_gate = F.Activation(slices[3], act_type="sigmoid")
        next_c = forget_gate * states[1] + in_gate * in_transform
        next_h = out_gate * F.Activation(next_c, act_type=self._activation)
        return next_h, [next_h, next_c]
