"""The port's Gluon recurrent layers and cells (``mx.gluon.rnn``,
``mx.gluon.contrib.rnn``) against the JAX package's, on the CPU.

Each block is built in both packages inside a fresh ``NameManager`` (so
the parameter names are compared too), initialized in the JAX package,
run once to finish deferred initialization, and its parameters carried
into the port with ``convert.gluon_params_from_numpy``.  The same numpy
inputs (from a seed) then go through both under ``autograd.record``,
``backward`` takes one numpy cotangent per output, and the outputs, the
input's gradient and every parameter's gradient are compared (float32 in
both, other summation orders: rtol 1e-4, atol 1e-5).

* ``rnn.RNN`` (relu, tanh), ``rnn.LSTM`` and ``rnn.GRU``: two layers,
  one and two directions, layouts TNC and NTC, with the states given and
  begun by the layer, and an input size left to the first forward.
* The cells ``RNNCell``, ``LSTMCell``, ``GRUCell``,
  ``SequentialRNNCell`` with a ``DropoutCell``, ``ResidualCell``,
  ``BidirectionalCell`` and ``ZoneoutCell`` (in inference, where it is
  deterministic) through ``unroll``, hybridized and not; the contrib
  ``Conv2DLSTMCell`` stepped and unrolled.
* The LSTM layer's ``_unfuse()`` stack gives the layer's output.
* A ``.params`` file of ``rnn.LSTM`` written by either package loads in
  the other, bit for bit.
* The tied word LM of MXNet's ``example/gluon/word_language_model``
  (``Embedding`` -> ``Dropout`` -> ``rnn.LSTM`` -> ``Dropout`` -> a
  ``Dense`` decoder on the encoder's weight) at vocab 50, 2 x 16, bptt 5,
  batch 4, dropout 0: three steps of ``SoftmaxCrossEntropyLoss``,
  ``backward``, ``clip_global_norm`` and ``Trainer("sgd").step`` with the
  hidden state detached between batches, in both packages: the losses
  within 1e-5 of the reference's and every parameter within 1e-5 of its
  largest magnitude.
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.convert import gluon_params_from_numpy

RTOL, ATOL = 1e-4, 1e-5
T, N, C, H = 5, 3, 4, 6


def _x(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _build(mx, make):
    with mx.name.NameManager():
        return make(mx)


def _flat(out):
    if isinstance(out, (list, tuple)):
        return [a for o in out for a in _flat(o)]
    return [out]


def _run(mx, net, inputs, cots, call):
    xs = [mx.nd.array(a) for a in inputs]
    for x in xs:
        x.attach_grad()
    with mx.autograd.record():
        outs = _flat(call(net, xs))
    mx.autograd.backward(outs, [mx.nd.array(c) for c in cots])
    grads = {k: p.grad().asnumpy() for k, p in net.collect_params().items()
             if p.grad_req != "null"}
    return ([o.asnumpy() for o in outs], [x.grad.asnumpy() for x in xs],
            grads)


def _compare(make, inputs, call=lambda net, xs: net(*xs), hybridize=False,
             rtol=RTOL, atol=ATOL, init=None):
    jnet = _build(jmx, make)
    jnet.initialize(init or jmx.init.Xavier())
    outs = _flat(call(jnet, [jmx.nd.array(a) for a in inputs]))
    arrays = {k: p.data().asnumpy()
              for k, p in jnet.collect_params().items()}
    cots = [_x(7 + i, *o.shape) for i, o in enumerate(outs)]
    with tmx.cpu():
        tnet = _build(tmx, make)
        tnet.initialize()
        if hybridize:
            tnet.hybridize()
        call(tnet, [tmx.nd.array(a) for a in inputs])
        gluon_params_from_numpy(tnet.collect_params(), arrays)
        assert list(tnet.collect_params().keys()) == list(arrays)
        got = _run(tmx, tnet, inputs, cots, call)
    if hybridize:
        jnet.hybridize()
    want = _run(jmx, jnet, inputs, cots, call)
    assert len(got[0]) == len(want[0])
    for g, w in zip(got[0], want[0]):
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol)
    for g, w in zip(got[1], want[1]):
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol)
    assert sorted(got[2]) == sorted(want[2])
    for k in want[2]:
        np.testing.assert_allclose(got[2][k], want[2][k], rtol=rtol,
                                   atol=atol, err_msg=k)
    return jnet, tnet


def _layer(kind, **kw):
    def make(mx):
        r = mx.gluon.rnn
        if kind == "lstm":
            return r.LSTM(H, **kw)
        if kind == "gru":
            return r.GRU(H, **kw)
        return r.RNN(H, activation=kind[4:], **kw)
    return make


@pytest.mark.parametrize("bidir", [False, True], ids=["uni", "bi"])
@pytest.mark.parametrize("layout", ["TNC", "NTC"])
@pytest.mark.parametrize("kind", ["rnn_relu", "rnn_tanh", "lstm", "gru"])
def test_rnn_layer_matches_jax(kind, layout, bidir):
    make = _layer(kind, num_layers=2, layout=layout, bidirectional=bidir,
                  input_size=C)
    shape = (T, N, C) if layout == "TNC" else (N, T, C)
    d = 2 if bidir else 1
    n_states = 2 if kind == "lstm" else 1
    inputs = [_x(1, *shape)] + [_x(2 + i, 2 * d, N, H)
                                for i in range(n_states)]

    def call(net, xs):
        return net(xs[0], xs[1:])
    _compare(make, inputs, call)


@pytest.mark.parametrize("kind", ["lstm", "gru"])
def test_rnn_layer_begins_its_states_and_defers_its_input_size(kind):
    _compare(_layer(kind, num_layers=2), [_x(3, T, N, C)],
             lambda net, xs: net(xs[0]))


def test_rnn_layer_parameter_names_match_jax():
    for make in (_layer("lstm", num_layers=2, bidirectional=True,
                        input_size=C), _layer("gru", input_size=C)):
        j, t = _build(jmx, make), _build(tmx, make)
        assert list(t.collect_params().keys()) == \
            list(j.collect_params().keys())
        assert [p.shape for p in t.collect_params().values()] == \
            [p.shape for p in j.collect_params().values()]


def _cell(kind):
    def make(mx):
        r = mx.gluon.rnn
        if kind == "rnn":
            return r.RNNCell(H, input_size=C)
        if kind == "lstm":
            return r.LSTMCell(H, input_size=C)
        if kind == "gru":
            return r.GRUCell(H, input_size=C)
        if kind == "sequential":
            s = r.SequentialRNNCell()
            with s.name_scope():
                s.add(r.LSTMCell(H, input_size=C))
                s.add(r.DropoutCell(0.0))
                s.add(r.GRUCell(H, input_size=H))
            return s
        if kind == "residual":
            return r.ResidualCell(r.GRUCell(C, input_size=C))
        if kind == "bidirectional":
            return r.BidirectionalCell(r.LSTMCell(H, input_size=C),
                                       r.LSTMCell(H, input_size=C))
        if kind == "zoneout":
            return r.ZoneoutCell(r.LSTMCell(H, input_size=C),
                                 zoneout_outputs=0.3, zoneout_states=0.2)
        raise ValueError(kind)
    return make


@pytest.mark.parametrize("hybridize", [False, True], ids=["eager", "hybrid"])
@pytest.mark.parametrize("kind", ["rnn", "lstm", "gru", "sequential",
                                  "residual", "bidirectional"])
def test_cell_unroll_matches_jax(kind, hybridize):
    def call(net, xs):
        return net.unroll(T, xs[0], layout="NTC", merge_outputs=True)
    _compare(_cell(kind), [_x(4, N, T, C)], call, hybridize=hybridize)


def test_zoneout_cell_in_inference_matches_jax():
    make = _cell("zoneout")
    x = _x(5, N, T, C)
    jnet = _build(jmx, make)
    jnet.initialize(jmx.init.Xavier())
    want = _flat(jnet.unroll(T, jmx.nd.array(x), merge_outputs=True))
    arrays = {k: p.data().asnumpy()
              for k, p in jnet.collect_params().items()}
    with tmx.cpu():
        tnet = _build(tmx, make)
        tnet.initialize()
        tnet.unroll(T, tmx.nd.array(x), merge_outputs=True)
        gluon_params_from_numpy(tnet.collect_params(), arrays)
        got = _flat(tnet.unroll(T, tmx.nd.array(x), merge_outputs=True))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.asnumpy(), w.asnumpy(), rtol=RTOL,
                                   atol=ATOL)


def _conv_lstm(mx):
    return mx.gluon.contrib.rnn.Conv2DLSTMCell(
        (2, 6, 6), 3, i2h_kernel=3, h2h_kernel=3, i2h_pad=1)


def test_conv2d_lstm_cell_matches_jax():
    x = _x(6, N, 2, 6, 6)
    states = [_x(7, N, 3, 6, 6), _x(8, N, 3, 6, 6)]
    _compare(_conv_lstm, [x] + states,
             lambda net, xs: net(xs[0], xs[1:]))
    seq = _x(9, N, T, 2, 6, 6)
    _compare(_conv_lstm, [seq], lambda net, xs: net.unroll(
        T, xs[0], layout="NTC", merge_outputs=True))


def test_lstm_layer_equals_its_unfused_cells():
    x = _x(10, T, N, C)
    with tmx.cpu():
        net = _build(tmx, _layer("lstm", num_layers=2, input_size=C))
        net.initialize(tmx.init.Xavier())
        want = net(tmx.nd.array(x)).asnumpy()
        stack = net._unfuse()
        got, _ = stack.unroll(T, tmx.nd.array(x), layout="TNC",
                              merge_outputs=True)
    np.testing.assert_allclose(got.asnumpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_lstm_params_file_crosses_the_packages(tmp_path, writer):
    make = _layer("lstm", num_layers=2, input_size=C)
    path = str(tmp_path / "lstm.params")
    jnet = _build(jmx, make)
    with tmx.cpu():
        tnet = _build(tmx, make)
        if writer == "jax":
            jnet.initialize(jmx.init.Xavier())
            jnet.save_params(path)
            tnet.load_params(path, ctx=tmx.cpu())
        else:
            tnet.initialize(tmx.init.Xavier())
            tnet.save_params(path)
            jnet.load_params(path)
    for (k, jp), (tk, tp) in zip(jnet.collect_params().items(),
                                 tnet.collect_params().items()):
        assert k == tk
        np.testing.assert_array_equal(tp.data().asnumpy(),
                                      jp.data().asnumpy())


VOCAB, HID, BPTT, BATCH = 50, 16, 5, 4


def word_lm(mx, vocab=VOCAB, hidden=HID, layers=2, dropout=0.0):
    """MXNet's example/gluon/word_language_model RNNModel, tied."""
    gluon = mx.gluon

    class RNNModel(gluon.Block):
        def __init__(self, **kwargs):
            super().__init__(**kwargs)
            with self.name_scope():
                self.drop = gluon.nn.Dropout(dropout)
                self.encoder = gluon.nn.Embedding(
                    vocab, hidden, weight_initializer=mx.init.Uniform(0.1))
                self.rnn = gluon.rnn.LSTM(hidden, layers, dropout=dropout,
                                          input_size=hidden)
                self.decoder = gluon.nn.Dense(vocab, in_units=hidden,
                                              params=self.encoder.params)

        def forward(self, inputs, hidden):
            emb = self.drop(self.encoder(inputs))
            output, hidden = self.rnn(emb, hidden)
            output = self.drop(output)
            return self.decoder(output.reshape((-1, hidden_size))), hidden

    hidden_size = hidden
    return RNNModel()


def _lm_steps(mx, model, batches, steps=3, clip=0.2):
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    trainer = mx.gluon.Trainer(model.collect_params(), "sgd",
                               {"learning_rate": 1.0, "momentum": 0,
                                "wd": 0})
    hidden = model.rnn.begin_state(batch_size=BATCH,
                                   func=mx.nd.zeros)
    losses = []
    for data, target in batches[:steps]:
        hidden = [h.detach() for h in hidden]
        with mx.autograd.record():
            out, hidden = model(mx.nd.array(data), hidden)
            L = loss_fn(out, mx.nd.array(target).reshape((-1,)))
        L.backward()
        grads = [p.grad() for p in model.collect_params().values()]
        mx.gluon.utils.clip_global_norm(grads, clip * BPTT * BATCH)
        trainer.step(BATCH)
        losses.append(float(L.mean().asscalar()))
    return losses, {k: p.data().asnumpy()
                    for k, p in model.collect_params().items()}


def test_tied_word_lm_trains_as_the_jax_package():
    rs = np.random.RandomState(11)
    ids = rs.randint(0, VOCAB, (3 * BPTT + 1, BATCH)).astype(np.float32)
    batches = [(ids[i * BPTT:(i + 1) * BPTT],
                ids[i * BPTT + 1:(i + 1) * BPTT + 1]) for i in range(3)]
    jnet = _build(jmx, word_lm)
    assert sorted(jnet.collect_params().keys()) == sorted(
        ["rnnmodel0_embedding0_weight", "rnnmodel0_embedding0_bias"]
        + ["rnnmodel0_lstm0_l%d_%s_%s" % (i, g, p) for i in range(2)
           for g in ("i2h", "h2h") for p in ("weight", "bias")])
    jnet.initialize(jmx.init.Xavier())
    jnet(jmx.nd.array(batches[0][0]),
         jnet.rnn.begin_state(batch_size=BATCH, func=jmx.nd.zeros))
    arrays = {k: p.data().asnumpy()
              for k, p in jnet.collect_params().items()}
    with tmx.cpu():
        tnet = _build(tmx, word_lm)
        gluon_params_from_numpy(tnet.collect_params(), arrays)
        assert tnet.decoder.weight is tnet.encoder.weight
        t_losses, t_params = _lm_steps(tmx, tnet, batches)
    j_losses, j_params = _lm_steps(jmx, jnet, batches)
    np.testing.assert_allclose(t_losses, j_losses, rtol=1e-5)
    for name, ref in j_params.items():
        err = np.abs(t_params[name] - ref).max()
        assert err <= 1e-5 * np.abs(ref).max(), (name, err)
