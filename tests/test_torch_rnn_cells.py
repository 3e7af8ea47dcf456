"""The symbolic RNN API of the port (``mxnet_tpu_torch/rnn``: the cells,
``FusedRNNCell`` over the ``RNN`` op, the checkpoint helpers) against the
JAX package's (``mxnet_tpu/rnn``), on the CPU.

* Each cell (``RNNCell`` tanh and relu, ``LSTMCell``, ``GRUCell``,
  ``SequentialRNNCell``, ``DropoutCell``, ``ResidualCell``,
  ``BidirectionalCell``, ``ZoneoutCell``, ``FusedRNNCell``) unrolled over
  a Symbol in both packages, inside a fresh ``NameManager``: the same
  argument names and shapes, then bound with the same numpy weights:
  the outputs and final states, and every argument's gradient for one
  numpy cotangent per output (rtol 1e-5, atol 1e-5 in float32; the
  zoneout cell in inference, where it is deterministic).
* ``FusedRNNCell`` equals its ``unfuse()`` stack (lstm and gru, one and
  two directions) from the blob's ``unpack_weights``, within 1e-5.
* ``unpack_weights`` / ``pack_weights`` give the JAX package's arrays,
  and round-trip the blob exactly.
* ``save_rnn_checkpoint`` of a fused cell loads through
  ``load_rnn_checkpoint`` into the other package's fused cell, both
  ways, bit for bit, and through ``load_checkpoint`` into an unfused
  stack (its file holds the stack's own argument names);
  ``do_rnn_checkpoint`` saves every ``period`` epochs.
* A tiny bucketed LM over ``FusedRNNCell`` (vocab 20, embed 8, 2 x 8
  LSTM, buckets 4 and 8, batch 2) through ``BucketingModule.fit`` for
  two epochs in both packages from the same initializer draws: every
  parameter within 1e-5 of its largest magnitude in the reference.
"""
import os
import random

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

T, N, C, H = 4, 3, 5, 6
RTOL = ATOL = 1e-5


def _cell(pkg, kind):
    r = pkg.rnn
    if kind == "rnn_tanh":
        return r.RNNCell(H, prefix="rnn_")
    if kind == "rnn_relu":
        return r.RNNCell(H, activation="relu", prefix="rnn_")
    if kind == "lstm":
        return r.LSTMCell(H, prefix="lstm_")
    if kind == "gru":
        return r.GRUCell(H, prefix="gru_")
    if kind == "sequential":
        s = r.SequentialRNNCell()
        s.add(r.LSTMCell(H, prefix="l0_"))
        s.add(r.DropoutCell(0.0, prefix="d0_"))
        s.add(r.GRUCell(H, prefix="l1_"))
        return s
    if kind == "residual":
        return r.ResidualCell(r.GRUCell(C, prefix="gru_"))
    if kind == "bidirectional":
        return r.BidirectionalCell(r.LSTMCell(H, prefix="l_"),
                                   r.LSTMCell(H, prefix="r_"))
    if kind == "zoneout":
        return r.ZoneoutCell(r.LSTMCell(H, prefix="lstm_"),
                             zoneout_outputs=0.3, zoneout_states=0.2)
    if kind == "fused":
        return r.FusedRNNCell(H, num_layers=2, mode="lstm",
                              bidirectional=True, prefix="f_")
    raise ValueError(kind)


def _graph(pkg, kind, merge=True):
    with pkg.name.NameManager():
        cell = _cell(pkg, kind)
        outs, states = cell.unroll(T, inputs=pkg.sym.Variable("data"),
                                   layout="NTC", merge_outputs=merge)
        outs = outs if isinstance(outs, list) else [outs]
        return pkg.sym.Group(outs + list(states)), cell


def _bind(pkg, sym, values, train):
    with pkg.cpu():
        exe = sym.simple_bind(pkg.cpu(), data=values["data"].shape)
        for name, arr in exe.arg_dict.items():
            arr[:] = values[name]
        outs = exe.forward(is_train=train)
    return exe, [o.asnumpy() for o in outs]


def _values(sym, seed):
    shapes, _, _ = sym.infer_shape(data=(N, T, C))
    rs = np.random.RandomState(seed)
    return {n: (rs.randn(*s) * 0.5).astype(np.float32)
            for n, s in zip(sym.list_arguments(), shapes)}


@pytest.mark.parametrize("kind", ["rnn_tanh", "rnn_relu", "lstm", "gru",
                                  "sequential", "residual", "bidirectional",
                                  "zoneout", "fused"])
def test_cell_unroll_matches_jax(kind):
    j_sym, _ = _graph(jmx, kind)
    t_sym, _ = _graph(tmx, kind)
    assert t_sym.list_arguments() == j_sym.list_arguments()
    assert t_sym.list_outputs() == j_sym.list_outputs()
    values = _values(j_sym, 0)
    train = kind != "zoneout"
    j_exe, j_out = _bind(jmx, j_sym, values, train)
    t_exe, t_out = _bind(tmx, t_sym, values, train)
    for a, b in zip(t_out, j_out):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
    if not train:
        return
    rs = np.random.RandomState(1)
    cots = [rs.randn(*o.shape).astype(np.float32) for o in j_out]
    j_exe.backward([jmx.nd.array(c) for c in cots])
    with tmx.cpu():
        t_exe.backward([tmx.nd.array(c) for c in cots])
    for name, g in j_exe.grad_dict.items():
        if g is None:
            continue
        np.testing.assert_allclose(t_exe.grad_dict[name].asnumpy(),
                                   g.asnumpy(), rtol=RTOL, atol=ATOL,
                                   err_msg=name)


def test_cell_unroll_per_step_outputs_match_jax():
    j_sym, _ = _graph(jmx, "bidirectional", merge=False)
    t_sym, _ = _graph(tmx, "bidirectional", merge=False)
    assert t_sym.list_outputs() == j_sym.list_outputs()
    values = _values(j_sym, 2)
    _, j_out = _bind(jmx, j_sym, values, False)
    _, t_out = _bind(tmx, t_sym, values, False)
    assert len(t_out) == T + 4
    for a, b in zip(t_out, j_out):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("mode,bidir", [("lstm", False), ("lstm", True),
                                        ("gru", True), ("rnn_tanh", False)])
def test_fused_cell_equals_its_unfused_stack(mode, bidir):
    with tmx.name.NameManager():
        fused = tmx.rnn.FusedRNNCell(H, num_layers=2, mode=mode,
                                     bidirectional=bidir, prefix="f_",
                                     get_next_state=True)
        f_out, _ = fused.unroll(T, inputs=tmx.sym.Variable("data"),
                                layout="NTC", merge_outputs=True)
        stack = fused.unfuse()
        u_out, _ = stack.unroll(T, inputs=tmx.sym.Variable("data"),
                                layout="NTC", merge_outputs=True)
    values = _values(f_out, 3)
    _, got_f = _bind(tmx, f_out, values, False)
    unfused = fused.unpack_weights({k: tmx.nd.array(v, ctx=tmx.cpu())
                                    for k, v in values.items()})
    assert sorted(unfused) == sorted(u_out.list_arguments())
    _, got_u = _bind(tmx, u_out, {k: v.asnumpy()
                                  for k, v in unfused.items()}, False)
    np.testing.assert_allclose(got_f[0], got_u[0], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("kind", ["fused", "lstm", "bidirectional"])
def test_pack_and_unpack_weights_match_jax(kind):
    j_sym, j_cell = _graph(jmx, kind)
    t_sym, t_cell = _graph(tmx, kind)
    values = _values(j_sym, 4)
    values.pop("data")
    j_un = j_cell.unpack_weights({k: jmx.nd.array(v)
                                  for k, v in values.items()})
    t_un = t_cell.unpack_weights({k: tmx.nd.array(v, ctx=tmx.cpu())
                                  for k, v in values.items()})
    assert sorted(t_un) == sorted(j_un)
    for k in j_un:
        np.testing.assert_array_equal(t_un[k].asnumpy(), j_un[k].asnumpy())
    back = t_cell.pack_weights(t_un)
    assert sorted(back) == sorted(values)
    for k, v in values.items():
        np.testing.assert_array_equal(back[k].asnumpy(), v)


def _fused_net(pkg):
    with pkg.name.NameManager():
        cell = pkg.rnn.FusedRNNCell(H, num_layers=2, mode="lstm",
                                    prefix="lstm_")
        out, _ = cell.unroll(T, inputs=pkg.sym.Variable("data"),
                             layout="NTC", merge_outputs=True)
    return cell, out


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_rnn_checkpoint_crosses_the_packages(tmp_path, writer):
    pkgs = {"jax": jmx, "port": tmx}
    w, r = pkgs[writer], pkgs["port" if writer == "jax" else "jax"]
    w_cell, w_sym = _fused_net(w)
    values = _values(w_sym, 5)
    arg = {k: (w.nd.array(v, ctx=w.cpu()) if w is tmx else w.nd.array(v))
           for k, v in values.items() if k != "data"}
    prefix = str(tmp_path / "lm")
    w.rnn.save_rnn_checkpoint(w_cell, prefix, 3, w_sym, arg, {})
    r_cell, _ = _fused_net(r)
    with r.cpu():
        _, r_arg, r_aux = r.rnn.load_rnn_checkpoint(r_cell, prefix, 3)
    assert r_aux == {} and sorted(r_arg) == ["lstm_parameters"]
    np.testing.assert_array_equal(r_arg["lstm_parameters"].asnumpy(),
                                  values["lstm_parameters"])
    # the file holds the unfused stack's own arguments (one gate-stacked
    # i2h/h2h pair per layer), which load_checkpoint reads as they are;
    # load_rnn_checkpoint(stack) asks for per-gate names and raises
    # KeyError in both packages
    with r.name.NameManager():
        stack = r_cell.unfuse()
        s_out, _ = stack.unroll(T, inputs=r.sym.Variable("data"),
                                layout="NTC", merge_outputs=True)
    with r.cpu():
        _, u_arg, _ = r.model.load_checkpoint(prefix, 3)
        with pytest.raises(KeyError):
            r.rnn.load_rnn_checkpoint(stack, prefix, 3)
    assert sorted(u_arg) == sorted(n for n in s_out.list_arguments()
                                   if n != "data")
    repacked = r_cell.pack_weights(u_arg)
    np.testing.assert_array_equal(repacked["lstm_parameters"].asnumpy(),
                                  values["lstm_parameters"])


def test_do_rnn_checkpoint_saves_every_period(tmp_path):
    cell, sym = _fused_net(tmx)
    values = _values(sym, 6)
    arg = {"lstm_parameters": tmx.nd.array(values["lstm_parameters"],
                                           ctx=tmx.cpu())}
    prefix = str(tmp_path / "cb")
    cb = tmx.rnn.do_rnn_checkpoint(cell, prefix, period=2)
    for epoch in range(4):
        cb(epoch, sym, arg, {})
    saved = sorted(f for f in os.listdir(tmp_path) if f.endswith(".params"))
    assert saved == ["cb-0002.params", "cb-0004.params"]
    loaded = jmx.nd.load(prefix + "-0002.params")
    assert sorted(loaded) == sorted(
        "arg:lstm_l%d_%s_%s" % (i, g, p) for i in range(2)
        for g in ("i2h", "h2h") for p in ("weight", "bias"))


VOCAB, EMBED, BUCKETS = 20, 8, [4, 8]


def _lm_sym_gen(pkg):
    cell = pkg.rnn.FusedRNNCell(H, num_layers=2, mode="lstm",
                                prefix="lstm_")

    def sym_gen(seq_len):
        sym = pkg.sym
        data = sym.Variable("data")
        label = sym.Variable("softmax_label")
        embed = sym.Embedding(data, input_dim=VOCAB, output_dim=EMBED,
                              name="embed")
        out, _ = cell.unroll(seq_len, inputs=embed, merge_outputs=True)
        pred = sym.FullyConnected(sym.Reshape(out, shape=(-1, H)),
                                  num_hidden=VOCAB, name="pred")
        pred = sym.SoftmaxOutput(pred, sym.Reshape(label, shape=(-1,)),
                                 name="softmax")
        return pred, ("data",), ("softmax_label",)
    return sym_gen


def _lm_fit(pkg, kv):
    rs = np.random.RandomState(8)
    sents = [list(rs.randint(1, VOCAB, rs.randint(2, 9))) for _ in range(8)]
    random.seed(8)
    np.random.seed(8)
    it = pkg.rnn.BucketSentenceIter(sents, 2, buckets=BUCKETS,
                                    invalid_label=0)
    mod = pkg.mod.BucketingModule(_lm_sym_gen(pkg),
                                  default_bucket_key=it.default_bucket_key,
                                  context=pkg.cpu())
    pkg.random.seed(0)
    init = pkg.init.Mixed([".*parameters", ".*"],
                          [pkg.init.Uniform(0.1), pkg.init.Xavier()])
    mod.fit(it, kvstore=kv, optimizer="sgd",
            optimizer_params={"learning_rate": 0.1, "wd": 1e-5},
            initializer=init, num_epoch=2,
            eval_metric=pkg.metric.Perplexity(ignore_label=0))
    return {k: v.asnumpy() for k, v in mod.get_params()[0].items()}


def test_bucketed_fused_lstm_lm_fit_matches_jax():
    t = _lm_fit(tmx, tmx.kv.create("device", device="cpu"))
    j = _lm_fit(jmx, jmx.kv.create("device"))
    assert sorted(t) == sorted(j) == ["embed_weight", "lstm_parameters",
                                      "pred_bias", "pred_weight"]
    for name, ref in j.items():
        err = np.abs(t[name] - ref).max()
        assert err <= 1e-5 * np.abs(ref).max(), (name, err)
