"""Symbolic RNN cells (port of ``mxnet_tpu/rnn/rnn_cell.py``; reference
python/mxnet/rnn/rnn_cell.py: RNNCell/LSTMCell/GRUCell :362/:408/:469,
FusedRNNCell :536, SequentialRNNCell, BidirectionalCell :998, the
modifier cells), organised around two shared helpers: ``_gated_linear``
(the i2h/h2h projection pair every gated cell starts from) and
``_split_states`` (the state-list carving Sequential/Bidirectional both
need).

Cells emit Symbols of the port; ``unroll`` lays the per-step graph out
statically and the executor evaluates the unrolled graph.
``FusedRNNCell`` rides the ``RNN`` op, which runs cuDNN's RNN on the
card, over one packed blob in cuDNN's canonical order;
``unpack_weights`` / ``pack_weights`` convert between that blob and the
per-gate weights of the unfused cells, so checkpoints cross both ways and
between the packages.
"""
from __future__ import annotations

from .. import symbol as symbol_mod
from ..symbol.symbol import Symbol, Variable


class RNNParams:
    """Lazily-created, prefix-scoped weight variables shared across steps."""

    def __init__(self, prefix=""):
        self._prefix = prefix
        self._params = {}

    def get(self, name, **kwargs):
        full = self._prefix + name
        try:
            return self._params[full]
        except KeyError:
            var = self._params[full] = Variable(full, **kwargs)
            return var


def _split_states(states, cells):
    """Carve a flat state list into per-cell chunks (by state_info arity)."""
    chunks, at = [], 0
    for cell in cells:
        width = len(cell.state_info)
        chunks.append(states[at:at + width])
        at += width
    return chunks


def _normalize_sequence(length, inputs, layout, merge, in_layout=None):
    """Convert between merged (one tensor) and per-step (list) forms.

    Returns (inputs, time_axis of ``layout``).
    """
    if inputs is None:
        raise ValueError("unroll(inputs=None) is not allowed")
    axis = layout.find("T")
    in_axis = axis if in_layout is None else in_layout.find("T")
    if isinstance(inputs, Symbol):
        if merge is False:
            if len(inputs.list_outputs()) != 1:
                raise ValueError("cannot split a multi-output symbol")
            inputs = list(symbol_mod.SliceChannel(
                inputs, axis=in_axis, num_outputs=length, squeeze_axis=1))
    else:
        if length is not None and len(inputs) != length:
            raise ValueError("len(inputs)=%d but length=%d"
                             % (len(inputs), length))
        if merge is True:
            stacked = [symbol_mod.expand_dims(step, axis=axis)
                       for step in inputs]
            inputs = symbol_mod.Concat(*stacked, dim=axis)
            in_axis = axis
    if isinstance(inputs, Symbol) and axis != in_axis:
        inputs = symbol_mod.swapaxes(inputs, dim1=axis, dim2=in_axis)
    return inputs, axis


class BaseRNNCell:
    """Stepable cell contract + the step-loop unroll shared by all cells."""

    def __init__(self, prefix="", params=None):
        self._own_params = params is None
        self._prefix = prefix
        self._params = RNNParams(prefix) if params is None else params
        self._modified = False
        self.reset()

    def reset(self):
        self._init_counter = -1
        self._counter = -1

    def __call__(self, inputs, states):
        raise NotImplementedError

    @property
    def params(self):
        self._own_params = False
        return self._params

    @property
    def state_info(self):
        raise NotImplementedError

    @property
    def state_shape(self):
        return [info["shape"] for info in self.state_info]

    @property
    def _gate_names(self):
        return ()

    def _step_prefix(self):
        """Advance the step counter and return this step's name prefix."""
        self._counter += 1
        return "%st%d_" % (self._prefix, self._counter)

    def _gated_linear(self, name, inputs, state_h, n_gates):
        """The i2h/h2h projection pair feeding a cell's gate block."""
        width = self._num_hidden * n_gates
        i2h = symbol_mod.FullyConnected(inputs, self._iW, self._iB,
                                        num_hidden=width,
                                        name="%si2h" % name)
        h2h = symbol_mod.FullyConnected(state_h, self._hW, self._hB,
                                        num_hidden=width,
                                        name="%sh2h" % name)
        return i2h, h2h

    def begin_state(self, func=symbol_mod.zeros, **kwargs):
        if self._modified:
            raise RuntimeError(
                "After applying modifier cells the base cell cannot be "
                "called directly. Call the modifier cell instead.")
        states = []
        for info in self.state_info:
            self._init_counter += 1
            state_kwargs = dict(kwargs)
            if info is not None:
                state_kwargs.update(
                    (k, v) for k, v in info.items() if k != "__layout__")
            states.append(func(
                name="%sbegin_state_%d" % (self._prefix, self._init_counter),
                **state_kwargs))
        return states

    # -- fused-blob <-> per-gate weight conversion ----------------------

    def _gate_slices(self, group):
        """(per-gate param name, row slice) pairs within one fused group."""
        h = self._num_hidden
        for j, gate in enumerate(self._gate_names):
            yield ("%s%s%s" % (self._prefix, group, gate),
                   slice(j * h, (j + 1) * h))

    def unpack_weights(self, args):
        """Split fused i2h/h2h blobs into per-gate entries."""
        args = dict(args)
        if self._gate_names:
            for group in ("i2h", "h2h"):
                fused_w = args.pop("%s%s_weight" % (self._prefix, group))
                fused_b = args.pop("%s%s_bias" % (self._prefix, group))
                for stem, rows in self._gate_slices(group):
                    args[stem + "_weight"] = fused_w[rows].copy()
                    args[stem + "_bias"] = fused_b[rows].copy()
        return args

    def pack_weights(self, args):
        """Inverse of unpack_weights: per-gate entries -> fused blobs."""
        from ..ndarray.ndarray import concatenate
        args = dict(args)
        if self._gate_names:
            for group in ("i2h", "h2h"):
                ws, bs = [], []
                for stem, _ in self._gate_slices(group):
                    ws.append(args.pop(stem + "_weight"))
                    bs.append(args.pop(stem + "_bias"))
                args["%s%s_weight" % (self._prefix, group)] = concatenate(ws)
                args["%s%s_bias" % (self._prefix, group)] = concatenate(bs)
        return args

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        """Step the cell ``length`` times over a static graph."""
        self.reset()
        inputs, _ = _normalize_sequence(length, inputs, layout, False)
        states = self.begin_state() if begin_state is None else begin_state
        outputs = []
        for step in range(length):
            out, states = self(inputs[step], states)
            outputs.append(out)
        outputs, _ = _normalize_sequence(length, outputs, layout,
                                         merge_outputs)
        return outputs, states

    def _get_activation(self, inputs, activation, **kwargs):
        if isinstance(activation, str):
            return symbol_mod.Activation(inputs, act_type=activation,
                                         **kwargs)
        return activation(inputs, **kwargs)


class RNNCell(BaseRNNCell):
    """Elman cell: act(W_i x + W_h h) (reference rnn_cell.py:362)."""

    def __init__(self, num_hidden, activation="tanh", prefix="rnn_",
                 params=None):
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._activation = activation
        hold = self.params
        self._iW, self._iB = hold.get("i2h_weight"), hold.get("i2h_bias")
        self._hW, self._hB = hold.get("h2h_weight"), hold.get("h2h_bias")

    @property
    def state_info(self):
        return [{"shape": (0, self._num_hidden), "__layout__": "NC"}]

    @property
    def _gate_names(self):
        return ("",)

    def __call__(self, inputs, states):
        name = self._step_prefix()
        i2h, h2h = self._gated_linear(name, inputs, states[0], 1)
        out = self._get_activation(i2h + h2h, self._activation,
                                   name="%sout" % name)
        return out, [out]


class LSTMCell(BaseRNNCell):
    """LSTM with i/f/c/o gate packing (reference rnn_cell.py:408)."""

    def __init__(self, num_hidden, prefix="lstm_", params=None,
                 forget_bias=1.0):
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        hold = self.params
        self._iW, self._hW = hold.get("i2h_weight"), hold.get("h2h_weight")
        from ..initializer import LSTMBias
        self._iB = hold.get("i2h_bias", init=LSTMBias(forget_bias=forget_bias))
        self._hB = hold.get("h2h_bias")

    @property
    def state_info(self):
        spec = {"shape": (0, self._num_hidden), "__layout__": "NC"}
        return [dict(spec), dict(spec)]

    @property
    def _gate_names(self):
        return ["_i", "_f", "_c", "_o"]

    def __call__(self, inputs, states):
        name = self._step_prefix()
        prev_h, prev_c = states
        i2h, h2h = self._gated_linear(name, inputs, prev_h, 4)
        pre = symbol_mod.SliceChannel(i2h + h2h, num_outputs=4,
                                      name="%sslice" % name)
        act = symbol_mod.Activation
        gate_i = act(pre[0], act_type="sigmoid", name="%si" % name)
        gate_f = act(pre[1], act_type="sigmoid", name="%sf" % name)
        cand = act(pre[2], act_type="tanh", name="%sc" % name)
        gate_o = act(pre[3], act_type="sigmoid", name="%so" % name)
        next_c = gate_f * prev_c + gate_i * cand
        next_h = gate_o * act(next_c, act_type="tanh")
        return next_h, [next_h, next_c]


class GRUCell(BaseRNNCell):
    """GRU with r/z/o gate packing (reference rnn_cell.py:469)."""

    def __init__(self, num_hidden, prefix="gru_", params=None):
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        hold = self.params
        self._iW, self._iB = hold.get("i2h_weight"), hold.get("i2h_bias")
        self._hW, self._hB = hold.get("h2h_weight"), hold.get("h2h_bias")

    @property
    def state_info(self):
        return [{"shape": (0, self._num_hidden), "__layout__": "NC"}]

    @property
    def _gate_names(self):
        return ["_r", "_z", "_o"]

    def __call__(self, inputs, states):
        name = self._step_prefix()
        prev_h = states[0]
        i2h, h2h = self._gated_linear(name, inputs, prev_h, 3)
        xr, xz, xn = symbol_mod.SliceChannel(i2h, num_outputs=3,
                                             name="%si2h_slice" % name)
        hr, hz, hn = symbol_mod.SliceChannel(h2h, num_outputs=3,
                                             name="%sh2h_slice" % name)
        act = symbol_mod.Activation
        reset = act(xr + hr, act_type="sigmoid", name="%sr_act" % name)
        update = act(xz + hz, act_type="sigmoid", name="%sz_act" % name)
        cand = act(xn + reset * hn, act_type="tanh", name="%sh_act" % name)
        next_h = update * prev_h + (1. - update) * cand
        return next_h, [next_h]


class FusedRNNCell(BaseRNNCell):
    """Whole-sequence fused cell over the ``RNN`` op, cuDNN's RNN on the
    card (reference rnn_cell.py:536 FusedRNNCell)."""

    _MODE_GATES = {"rnn_relu": [""], "rnn_tanh": [""],
                   "lstm": ["_i", "_f", "_c", "_o"],
                   "gru": ["_r", "_z", "_o"]}

    def __init__(self, num_hidden, num_layers=1, mode="lstm",
                 bidirectional=False, dropout=0., get_next_state=False,
                 forget_bias=1.0, prefix=None, params=None):
        super().__init__(prefix="%s_" % mode if prefix is None else prefix,
                         params=params)
        self._num_hidden = num_hidden
        self._num_layers = num_layers
        self._mode = mode
        self._bidirectional = bidirectional
        self._dropout = dropout
        self._get_next_state = get_next_state
        self._directions = ["l", "r"] if bidirectional else ["l"]
        self._parameter = self.params.get("parameters")

    @property
    def state_info(self):
        dirs = len(self._directions)
        n_states = 2 if self._mode == "lstm" else 1
        return [{"shape": (dirs * self._num_layers, 0, self._num_hidden),
                 "__layout__": "LNC"} for _ in range(n_states)]

    @property
    def _gate_names(self):
        return self._MODE_GATES[self._mode]

    @property
    def _num_gates(self):
        return len(self._gate_names)

    def _weight_layout(self, li):
        """[(name, offset, shape)] for the packed blob (the cuDNN canonical
        layout of ``ops/rnn.py``): per layer/direction Wx then Wh, then all
        biases bx, bh.  Gates are packed inside Wx/Wh, so the per-gate
        names slice rows of the gate-stacked matrices."""
        lh = self._num_hidden
        m = self._num_gates
        b = len(self._directions)
        layout = []
        p = 0
        for layer in range(self._num_layers):
            in_size = li if layer == 0 else lh * b
            for direction in self._directions:
                stem = "%s%s%d_" % (self._prefix, direction, layer)
                layout.append((stem + "i2h_weight", p, (m * lh, in_size)))
                p += m * lh * in_size
                layout.append((stem + "h2h_weight", p, (m * lh, lh)))
                p += m * lh * lh
        for layer in range(self._num_layers):
            for direction in self._directions:
                stem = "%s%s%d_" % (self._prefix, direction, layer)
                layout.append((stem + "i2h_bias", p, (m * lh,)))
                p += m * lh
                layout.append((stem + "h2h_bias", p, (m * lh,)))
                p += m * lh
        return layout, p

    def _infer_input_size(self, total_size):
        """Back out layer-0 input width from the packed blob's element count."""
        lh, m, b, layers = (self._num_hidden, self._num_gates,
                            len(self._directions), self._num_layers)
        rest = total_size - layers * b * 2 * m * lh          # all biases
        for layer in range(1, layers):
            rest -= b * m * lh * (lh * b + lh)               # upper layers
        # remaining = b * m*lh*(li + lh)
        return int(rest // (b * m * lh) - lh)

    def unpack_weights(self, args):
        import numpy as _np
        from ..ndarray.ndarray import array as nd_array
        args = dict(args)
        blob = args.pop(self._parameter.name)
        flat = blob.asnumpy().reshape(-1)
        layout, total = self._weight_layout(self._infer_input_size(flat.size))
        assert total == flat.size, (total, flat.size)
        for name, off, shape in layout:
            args[name] = nd_array(
                flat[off:off + int(_np.prod(shape))].reshape(shape),
                ctx=blob.context)
        return args

    def pack_weights(self, args):
        import numpy as _np
        from ..ndarray.ndarray import array as nd_array
        args = dict(args)
        first = args["%sl0_i2h_weight" % self._prefix]
        layout, total = self._weight_layout(first.shape[1])
        flat = _np.zeros(total, _np.float32)
        for name, off, shape in layout:
            flat[off:off + int(_np.prod(shape))] = \
                args.pop(name).asnumpy().reshape(-1)
        args[self._parameter.name] = nd_array(flat, ctx=first.context)
        return args

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        self.reset()
        inputs, axis = _normalize_sequence(length, inputs, layout, True)
        if axis == 1:
            inputs = symbol_mod.swapaxes(inputs, dim1=0, dim2=1)
        states = self.begin_state() if begin_state is None else begin_state
        rnn = symbol_mod.RNN(inputs, self._parameter, *states,
                             state_size=self._num_hidden,
                             num_layers=self._num_layers,
                             bidirectional=self._bidirectional,
                             p=self._dropout,
                             state_outputs=self._get_next_state,
                             mode=self._mode, name=self._prefix + "rnn")
        if not self._get_next_state:
            outputs, states = rnn, []
        elif self._mode == "lstm":
            outputs, states = rnn[0], [rnn[1], rnn[2]]
        else:
            outputs, states = rnn[0], [rnn[1]]
        if axis == 1:
            outputs = symbol_mod.swapaxes(outputs, dim1=0, dim2=1)
        if merge_outputs is False:
            outputs = list(symbol_mod.SliceChannel(
                outputs, axis=0 if axis == 0 else 1, num_outputs=length,
                squeeze_axis=1))
        return outputs, states

    def __call__(self, inputs, states):
        raise NotImplementedError("FusedRNNCell cannot be stepped. Please "
                                  "use unroll")

    def unfuse(self):
        """Expand into a SequentialRNNCell of equivalent base cells."""
        builders = {
            "rnn_relu": lambda pfx: RNNCell(self._num_hidden,
                                            activation="relu", prefix=pfx),
            "rnn_tanh": lambda pfx: RNNCell(self._num_hidden,
                                            activation="tanh", prefix=pfx),
            "lstm": lambda pfx: LSTMCell(self._num_hidden, prefix=pfx),
            "gru": lambda pfx: GRUCell(self._num_hidden, prefix=pfx),
        }
        build = builders[self._mode]
        stack = SequentialRNNCell()
        for layer in range(self._num_layers):
            if self._bidirectional:
                stack.add(BidirectionalCell(
                    build("%sl%d_" % (self._prefix, layer)),
                    build("%sr%d_" % (self._prefix, layer)),
                    output_prefix="%sbi_l%d_" % (self._prefix, layer)))
            else:
                stack.add(build("%sl%d_" % (self._prefix, layer)))
            if self._dropout > 0 and layer != self._num_layers - 1:
                stack.add(DropoutCell(
                    self._dropout,
                    prefix="%s_dropout%d_" % (self._prefix, layer)))
        return stack


class SequentialRNNCell(BaseRNNCell):
    """Stack cells; each consumes the previous one's outputs."""

    def __init__(self, params=None):
        super().__init__(prefix="", params=params)
        self._override_cell_params = params is not None
        self._cells = []

    def add(self, cell):
        self._cells.append(cell)
        if self._override_cell_params:
            assert cell._own_params
            cell.params._params.update(self.params._params)
        self.params._params.update(cell.params._params)

    @property
    def state_info(self):
        return [info for c in self._cells for info in c.state_info]

    def begin_state(self, **kwargs):
        assert not self._modified
        return [s for c in self._cells for s in c.begin_state(**kwargs)]

    def unpack_weights(self, args):
        for cell in self._cells:
            args = cell.unpack_weights(args)
        return args

    def pack_weights(self, args):
        for cell in self._cells:
            args = cell.pack_weights(args)
        return args

    def __call__(self, inputs, states):
        self._counter += 1
        carried = []
        for cell, chunk in zip(self._cells, _split_states(states,
                                                          self._cells)):
            assert not isinstance(cell, BidirectionalCell)
            inputs, chunk = cell(inputs, chunk)
            carried.extend(chunk)
        return inputs, carried

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        self.reset()
        if begin_state is None:
            begin_state = self.begin_state()
        carried = []
        last = len(self._cells) - 1
        chunks = _split_states(begin_state, self._cells)
        for i, (cell, chunk) in enumerate(zip(self._cells, chunks)):
            inputs, chunk = cell.unroll(
                length, inputs=inputs, begin_state=chunk, layout=layout,
                merge_outputs=merge_outputs if i == last else None)
            carried.extend(chunk)
        return inputs, carried


class DropoutCell(BaseRNNCell):
    """Stateless dropout-on-outputs pseudo-cell."""

    def __init__(self, dropout, prefix="dropout_", params=None):
        super().__init__(prefix, params)
        if not isinstance(dropout, (int, float)):
            raise TypeError("dropout probability must be a number")
        self.dropout = dropout

    @property
    def state_info(self):
        return []

    def __call__(self, inputs, states):
        if self.dropout > 0:
            inputs = symbol_mod.Dropout(inputs, p=self.dropout)
        return inputs, states

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        self.reset()
        inputs, _ = _normalize_sequence(length, inputs, layout, merge_outputs)
        if isinstance(inputs, Symbol):
            return self.__call__(inputs, [])
        return [self.__call__(step, [])[0] for step in inputs], []


class ModifierCell(BaseRNNCell):
    """Wraps a cell, borrowing its params and state schema."""

    def __init__(self, base_cell):
        base_cell._modified = True
        super().__init__()
        self.base_cell = base_cell

    @property
    def params(self):
        self._own_params = False
        return self.base_cell.params

    @property
    def state_info(self):
        return self.base_cell.state_info

    def begin_state(self, func=symbol_mod.zeros, **kwargs):
        assert not self._modified
        self.base_cell._modified = False
        try:
            return self.base_cell.begin_state(func=func, **kwargs)
        finally:
            self.base_cell._modified = True

    def unpack_weights(self, args):
        return self.base_cell.unpack_weights(args)

    def pack_weights(self, args):
        return self.base_cell.pack_weights(args)


class ZoneoutCell(ModifierCell):
    """Zoneout: randomly hold previous outputs/states in place."""

    def __init__(self, base_cell, zoneout_outputs=0., zoneout_states=0.):
        if isinstance(base_cell, FusedRNNCell):
            raise TypeError(
                "FusedRNNCell doesn't support zoneout. Unfuse first.")
        super().__init__(base_cell)
        self.zoneout_outputs = zoneout_outputs
        self.zoneout_states = zoneout_states
        self.prev_output = None

    def reset(self):
        super().reset()
        self.prev_output = None

    def __call__(self, inputs, states):
        new_out, new_states = self.base_cell(inputs, states)

        def keep_mask(rate, like):
            return symbol_mod.Dropout(symbol_mod.ones_like(like), p=rate)

        held = (self.prev_output if self.prev_output is not None
                else symbol_mod.zeros_like(new_out))
        out = new_out
        if self.zoneout_outputs != 0.:
            out = symbol_mod.where(keep_mask(self.zoneout_outputs, new_out),
                                   new_out, held)
        if self.zoneout_states != 0.:
            new_states = [
                symbol_mod.where(keep_mask(self.zoneout_states, fresh),
                                 fresh, stale)
                for fresh, stale in zip(new_states, states)]
        self.prev_output = out
        return out, new_states


class ResidualCell(ModifierCell):
    """Adds the cell input back onto its output."""

    def __call__(self, inputs, states):
        output, states = self.base_cell(inputs, states)
        return output + inputs, states

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        self.reset()
        self.base_cell._modified = False
        try:
            outputs, states = self.base_cell.unroll(
                length, inputs=inputs, begin_state=begin_state, layout=layout,
                merge_outputs=merge_outputs)
        finally:
            self.base_cell._modified = True
        if merge_outputs is None:
            merge_outputs = isinstance(outputs, Symbol)
        inputs, _ = _normalize_sequence(length, inputs, layout, merge_outputs)
        if merge_outputs:
            return outputs + inputs, states
        return [out + inp for out, inp in zip(outputs, inputs)], states


class BidirectionalCell(BaseRNNCell):
    """Run a forward and a reversed cell, concatenating per-step outputs.

    Reference parity: rnn_cell.py:998.
    """

    def __init__(self, l_cell, r_cell, params=None, output_prefix="bi_"):
        super().__init__("", params=params)
        self.params._params.update(l_cell.params._params)
        self.params._params.update(r_cell.params._params)
        self._cells = [l_cell, r_cell]
        self._output_prefix = output_prefix

    def unpack_weights(self, args):
        for cell in self._cells:
            args = cell.unpack_weights(args)
        return args

    def pack_weights(self, args):
        for cell in self._cells:
            args = cell.pack_weights(args)
        return args

    def __call__(self, inputs, states):
        raise NotImplementedError("Bidirectional cannot be stepped. "
                                  "Please use unroll")

    @property
    def state_info(self):
        return [info for c in self._cells for info in c.state_info]

    def begin_state(self, **kwargs):
        assert not self._modified
        return [s for c in self._cells for s in c.begin_state(**kwargs)]

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        self.reset()
        inputs, axis = _normalize_sequence(length, inputs, layout, False)
        if begin_state is None:
            begin_state = self.begin_state()
        fwd_cell, bwd_cell = self._cells
        fwd_states, bwd_states = _split_states(begin_state, self._cells)
        fwd_out, fwd_states = fwd_cell.unroll(
            length, inputs=inputs, begin_state=fwd_states,
            layout=layout, merge_outputs=False)
        bwd_out, bwd_states = bwd_cell.unroll(
            length, inputs=list(reversed(inputs)), begin_state=bwd_states,
            layout=layout, merge_outputs=False)
        outputs = [
            symbol_mod.Concat(f, b, dim=1,
                              name="%st%d" % (self._output_prefix, step))
            for step, (f, b) in enumerate(zip(fwd_out, reversed(bwd_out)))]
        if merge_outputs:
            outputs, _ = _normalize_sequence(length, outputs, layout, True)
        return outputs, fwd_states + bwd_states
