"""The fused multi-layer ``RNN`` op (port of ``mxnet_tpu/ops/rnn.py``;
reference src/operator/cudnn_rnn-inl.h:41, native fallback rnn-inl.h:89).

One op runs a whole stacked, optionally bidirectional RNN over a sequence
with one packed parameter blob in cuDNN's canonical order, so that
checkpoints cross between the packages:

  for layer in layers: for direction: [Wx (G*H x in), Wh (G*H x H)]
  then for layer: for direction: [bx (G*H), bh (G*H)]

Gate order: LSTM i,f,g,o; GRU r,z,n.  data: (T, N, C) (layout TNC);
state: (L*D, N, H).

On a CUDA tensor the op runs cuDNN's RNN (``torch._VF.lstm`` / ``gru`` /
``rnn_tanh`` / ``rnn_relu``), the weights handed over as views of the
blob in torch's per-layer order ``[w_ih, w_hh, b_ih, b_hh]``.  The blob
puts every weight before every bias, which is not cuDNN's flat buffer, so
cuDNN copies the weights into its own layout on each call (torch warns
once that they are "not part of single contiguous chunk of memory"); the
blob stays, since checkpoints depend on it.  On a CPU tensor the op runs
its plain version, the JAX op's time loop (the input projection hoisted,
then one step per time index), which on the card is the oracle the tests
hold cuDNN against.  A CUDA tensor never runs the plain loop:
:data:`CALLS` counts the cuDNN calls and the plain runs.

* cuDNN's backward needs its forward in training mode, so the op passes
  ``train=True`` to cuDNN whenever a gradient is wanted (grad mode on and
  an input that requires one), whatever ``_train`` says; ``_train`` gates
  only the dropout, as in the JAX op.
* Dropout falls between layers, never after the last, as ``mask / keep``
  with the mask drawn from the op's generator (``mx.random.seed``), as
  ``Dropout`` draws it.  cuDNN's own dropout, seeded from torch's default
  generator, is never used: when the mask applies, cuDNN runs one call
  per layer with the mask in between.
* f32 runs at full precision: the op turns cuDNN's TF32 off itself.
* ``lstm_state_clip_min`` / ``_max`` are accepted and ignored, as the JAX
  op ignores them.
* cuDNN's RNN takes float16, float32 and float64; bfloat16 data runs
  cuDNN in float32 (the weights and states cast up) and its outputs round
  to bfloat16.  Any other tensor that cuDNN refuses (cuDNN disabled)
  raises.
"""
from __future__ import annotations

import numpy as np
import torch

from ..base import MXNetError, attr_bool, attr_float, attr_int, attr_str
from .nn import _generator
from .registry import register

__all__ = ["rnn_param_size", "rnn_plain", "CALLS"]

_GATES = {"rnn_relu": 1, "rnn_tanh": 1, "lstm": 4, "gru": 3}

#: the op's runs on the card through cuDNN ("cudnn") and of its plain
#: version on the CPU ("plain"; shape inference's runs on meta tensors
#: are not counted); a caller resets them with ``CALLS.update(...)``
CALLS = {"cudnn": 0, "plain": 0}


def rnn_param_size(num_layers, input_size, state_size, bidirectional, mode):
    """Total packed parameter count (matches cuDNN GetRNNParamsSize)."""
    g = _GATES[mode]
    d = 2 if bidirectional else 1
    size = 0
    for layer in range(num_layers):
        in_sz = input_size if layer == 0 else state_size * d
        size += d * g * state_size * (in_sz + state_size)  # Wx + Wh
    size += num_layers * d * 2 * g * state_size  # biases
    return size


def _unpack(params, num_layers, input_size, state_size, bidirectional,
            mode):
    """Views of the blob: ``[[wx, wh, bx, bh] per direction] per layer``.
    One ``split``, so that the views' gradients meet in the blob's in one
    concatenation (a slice each would fill a blob-sized zero tensor per
    view)."""
    g = _GATES[mode]
    d = 2 if bidirectional else 1
    h = state_size
    want = rnn_param_size(num_layers, input_size, h, bidirectional, mode)
    if params.dim() != 1 or params.shape[0] != want:
        raise MXNetError("RNN: the parameter blob has shape %s, want (%d,)"
                         % (tuple(params.shape), want))
    shapes = []
    for layer in range(num_layers):
        in_sz = input_size if layer == 0 else h * d
        shapes += [(g * h, in_sz), (g * h, h)] * d
    shapes += [(g * h,)] * (2 * num_layers * d)
    pieces = [p.view(s) for p, s in zip(
        params.split([int(np.prod(s)) for s in shapes]), shapes)]
    n_w = 2 * num_layers * d
    ws = [pieces[2 * i:2 * i + 2] + pieces[n_w + 2 * i:n_w + 2 * i + 2]
          for i in range(num_layers * d)]
    return [ws[layer * d:(layer + 1) * d] for layer in range(num_layers)]


# ---------------------------------------------------------------------------
# the plain version: the JAX op's time loop
# ---------------------------------------------------------------------------

def _step(mode, xw, h, c, wh, bh):
    """One time step from the hoisted input projection ``xw``."""
    if mode == "lstm":
        i, f, gg, o = torch.split(xw + h @ wh.T + bh, h.shape[-1], dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(gg)
        return torch.sigmoid(o) * torch.tanh(c), c
    if mode == "gru":
        xr, xz, xn = torch.split(xw, h.shape[-1], dim=-1)
        hr, hz, hn = torch.split(h @ wh.T + bh, h.shape[-1], dim=-1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * hn)
        return (1 - z) * n + z * h, None
    pre = xw + h @ wh.T + bh
    if mode == "rnn_relu":
        # maximum, not relu: a tie at 0 takes half the gradient, as JAX's
        return torch.maximum(pre, torch.zeros_like(pre)), None
    return torch.tanh(pre), None


def _plain_layer(mode, x, wx, wh, bx, bh, h0, c0, reverse):
    """x: (T, N, in); returns (out (T, N, H), hT, cT)."""
    xw = torch.einsum("tni,gi->tng", x, wx) + bx
    h, c = h0, c0
    outs = [None] * x.shape[0]
    steps = range(x.shape[0] - 1, -1, -1) if reverse else range(x.shape[0])
    for t in steps:
        h, c = _step(mode, xw[t], h, c, wh, bh)
        outs[t] = h
    return torch.stack(outs), h, c


def _layer_dropout(x, p, gen):
    keep = 1.0 - p
    u = torch.rand(x.shape, generator=_generator(gen, x), device=x.device)
    return x * ((u < keep).to(x.dtype) / keep)


def rnn_plain(mode, x, weights, state, state_cell, p=0.0, train=False,
              gen=None):
    """The plain version on any device: ``weights`` as :func:`_unpack`
    gives them; returns ``(out, hN, cN or None)``."""
    d = len(weights[0])
    hTs, cTs = [], []
    for layer, per_dir in enumerate(weights):
        outs = []
        for di, (wx, wh, bx, bh) in enumerate(per_dir):
            s = layer * d + di
            out, hT, cT = _plain_layer(
                mode, x, wx, wh, bx, bh, state[s],
                state_cell[s] if mode == "lstm" else None, reverse=di == 1)
            outs.append(out)
            hTs.append(hT)
            cTs.append(cT)
        x = outs[0] if d == 1 else torch.cat(outs, dim=-1)
        if train and p > 0 and layer < len(weights) - 1:
            x = _layer_dropout(x, p, gen)
    return (x, torch.stack(hTs),
            torch.stack(cTs) if mode == "lstm" else None)


# ---------------------------------------------------------------------------
# cuDNN
# ---------------------------------------------------------------------------

def _fused(mode, x, weights, h0, c0, train):
    """One ``torch._VF`` call over ``weights`` (a run of layers); on a
    CUDA tensor that is cuDNN's RNN.  Returns ``(out, hN, cN or None)``."""
    flat = [w for per_dir in weights for ws in per_dir for w in ws]
    num_layers, bidir = len(weights), len(weights[0]) == 2
    fn = {"lstm": torch._VF.lstm, "gru": torch._VF.gru,
          "rnn_tanh": torch._VF.rnn_tanh,
          "rnn_relu": torch._VF.rnn_relu}[mode]
    if mode == "lstm":
        out, hN, cN = fn(x, (h0, c0), flat, True, num_layers, 0.0, train,
                         bidir, False)
        return out, hN, cN
    out, hN = fn(x, h0, flat, True, num_layers, 0.0, train, bidir, False)
    return out, hN, None


def rnn_cudnn(mode, x, weights, state, state_cell, p=0.0, train=False,
              gen=None):
    """:func:`rnn_plain`'s function through cuDNN: one call over every
    layer, or one per layer with the dropout mask between them."""
    want_grad = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad
        for t in [x, state, state_cell] + [w for per_dir in weights
                                           for ws in per_dir for w in ws])
    out_dtype = x.dtype
    if x.dtype == torch.bfloat16:
        def up(t):
            return None if t is None else t.float()
        x, state, state_cell = up(x), up(state), up(state_cell)
        weights = [[[w.float() for w in ws] for ws in per_dir]
                   for per_dir in weights]
    if not torch.backends.cudnn.is_acceptable(x):
        raise MXNetError("RNN: cuDNN refuses a %s tensor on %s (is cuDNN "
                         "enabled?)" % (x.dtype, x.device))
    if x.dtype == torch.float32:
        torch.backends.cudnn.allow_tf32 = False
    x = x.contiguous()
    state = state.contiguous()
    state_cell = None if state_cell is None else state_cell.contiguous()
    CALLS["cudnn"] += 1
    d = len(weights[0])
    if not (train and p > 0 and len(weights) > 1):
        out, hN, cN = _fused(mode, x, weights, state, state_cell, want_grad)
    else:
        hs, cs = [], []
        for layer, per_dir in enumerate(weights):
            sl = slice(layer * d, (layer + 1) * d)
            x, h, c = _fused(mode, x, [per_dir], state[sl],
                             None if state_cell is None else state_cell[sl],
                             want_grad)
            hs.append(h)
            cs.append(c)
            if layer < len(weights) - 1:
                x = _layer_dropout(x, p, gen)
        out, hN = x, torch.cat(hs)
        cN = torch.cat(cs) if mode == "lstm" else None
    if out_dtype != out.dtype:
        out, hN = out.to(out_dtype), hN.to(out_dtype)
        cN = None if cN is None else cN.to(out_dtype)
    return out, hN, cN


# ---------------------------------------------------------------------------
# the op
# ---------------------------------------------------------------------------

def _rnn_inputs(attrs, num_args=None):
    if attrs is not None and attrs.get("mode") == "lstm":
        return ["data", "parameters", "state", "state_cell"]
    return ["data", "parameters", "state"]


def _rnn_nout(attrs):
    if attrs is None:
        return 1
    if not attrs.get("state_outputs", False):
        return 1
    return 3 if attrs.get("mode") == "lstm" else 2


@register("RNN", inputs=_rnn_inputs,
          params=dict(state_size=attr_int(required=True),
                      num_layers=attr_int(required=True),
                      bidirectional=attr_bool(False),
                      mode=attr_str(required=True),
                      p=attr_float(0.0), state_outputs=attr_bool(False),
                      lstm_state_clip_min=attr_float(None),
                      lstm_state_clip_max=attr_float(None)),
          num_outputs=_rnn_nout, needs_rng=True, mode_dependent=True)
def _rnn(attrs, gen, data, parameters, state, state_cell=None):
    """The stacked RNN over ``data`` (T, N, C): cuDNN on the card, the
    plain time loop on the CPU (the module docstring)."""
    mode = attrs.mode
    if mode not in _GATES:
        raise MXNetError("RNN: unknown mode %r" % (mode,))
    weights = _unpack(parameters, attrs.num_layers, data.shape[2],
                      attrs.state_size, attrs.bidirectional, mode)
    run = rnn_cudnn if data.device.type == "cuda" else rnn_plain
    if data.device.type == "cpu":       # not shape inference's meta run
        CALLS["plain"] += 1
    x, hN, cN = run(mode, data, weights, state, state_cell, p=attrs.p,
                    train=attrs.get("_train", False), gen=gen)
    if not attrs.state_outputs:
        return x
    return (x, hN, cN) if mode == "lstm" else (x, hN)
