"""The classic API's other modules against the JAX package's, on the CPU
(mxnet_tpu_torch/{module/sequential_module,module/python_module,
executor_manager,model} vs the same files of mxnet_tpu).

* ``SequentialModule``: two Modules chained with ``auto_wiring`` and
  ``take_labels``, and a Module followed by a ``PythonLossModule`` whose
  gradient is a numpy softmax cross-entropy, each through ``fit`` for two
  epochs from the same initializer draws: every parameter within 1e-5 of
  its tensor's largest magnitude, the metric within 1e-6.
* ``DataParallelExecutorManager``: one forward and backward of a batch,
  the gradients and ``copy_to`` against the reference, on one context
  and on two (the batch split 4/4); a Module with ``group2ctxs`` binds
  (its placement is tests/test_torch_placement.py's).
* ``FeedForward``: ``fit``, ``predict``, ``save``, ``load`` (each
  package loads the other's checkpoint) and ``create``.

Reference caveat: the JAX package's ``Module.output_shapes`` is empty
until the module's first forward, so its ``SequentialModule`` cannot bind
a chain with ``auto_wiring``.  The port infers the shapes from the bound
inputs; the chain tests give the JAX Module the same inferred property
(``monkeypatch``, this file only) to compare the rest.
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx


def _data(n=48, dim=8, nclass=3, seed=0):
    rs = np.random.RandomState(seed)
    X = rs.normal(size=(n, dim)).astype(np.float32)
    w = rs.normal(size=(dim, nclass))
    return X, (X @ w).argmax(1).astype(np.float32)


def _close(got, want, rel=1e-5):
    assert sorted(got) == sorted(want)
    for name, ref in want.items():
        ref = ref.asnumpy() if hasattr(ref, "asnumpy") else ref
        val = got[name].asnumpy() if hasattr(got[name], "asnumpy") \
            else got[name]
        assert np.abs(val - ref).max() <= rel * np.abs(ref).max(), name


def _seq_chain(pkg):
    sym = pkg.sym
    net1 = sym.Activation(sym.FullyConnected(sym.Variable("data"),
                                             num_hidden=16, name="fc1"),
                          act_type="relu", name="relu1")
    net2 = sym.SoftmaxOutput(sym.FullyConnected(sym.Variable("data"),
                                                num_hidden=3, name="fc2"),
                             name="softmax")
    seq = pkg.mod.SequentialModule()
    seq.add(pkg.mod.Module(net1, label_names=None, context=pkg.cpu()))
    seq.add(pkg.mod.Module(net2, context=pkg.cpu()), take_labels=True,
            auto_wiring=True)
    return seq


def _softmax_ce_grad(scores, labels):
    s = scores.asnumpy().astype(np.float64)
    p = np.exp(s - s.max(1, keepdims=True))
    p /= p.sum(1, keepdims=True)
    p[np.arange(len(p)), labels.asnumpy().astype(int)] -= 1
    return p.astype(np.float32)


def _loss_chain(pkg):
    sym = pkg.sym
    net = sym.FullyConnected(sym.Variable("data"), num_hidden=3, name="fc")
    seq = pkg.mod.SequentialModule()
    seq.add(pkg.mod.Module(net, label_names=None, context=pkg.cpu()))
    seq.add(pkg.mod.PythonLossModule(grad_func=_softmax_ce_grad),
            take_labels=True, auto_wiring=True)
    return seq


def _inferred_output_shapes(self):
    shapes = {d.name: d.shape for d in self._data_shapes
              + (self._label_shapes or [])}
    return list(zip(self._output_names,
                    self._symbol.infer_shape(**shapes)[1]))


@pytest.mark.parametrize("chain", [_seq_chain, _loss_chain],
                         ids=["two-modules", "python-loss"])
def test_sequential_module_fit_matches_jax(chain, monkeypatch):
    monkeypatch.setattr(jmx.mod.Module, "output_shapes",
                        property(_inferred_output_shapes))
    X, y = _data()
    out = {}
    for pkg in (tmx, jmx):
        seq = chain(pkg)
        it = pkg.io.NDArrayIter(X, y, batch_size=8,
                                label_name="softmax_label")
        pkg.random.seed(0)
        metric = pkg.metric.Accuracy()
        seq.fit(it, num_epoch=2, initializer=pkg.init.Xavier(),
                optimizer_params={"learning_rate": 0.1},
                eval_metric=metric)
        out[pkg] = (seq.get_params()[0], metric.get()[1],
                    seq.output_shapes, seq.data_names)
        assert seq.binded and seq.params_initialized
    _close(out[tmx][0], out[jmx][0])
    assert abs(out[tmx][1] - out[jmx][1]) <= 1e-6
    assert [tuple(s) for s in out[tmx][2]] == \
        [tuple(s) for s in out[jmx][2]]
    assert out[tmx][3] == out[jmx][3] == ["data"]


def test_sequential_module_refuses_duplicate_names_and_meta():
    sym = tmx.sym
    net = sym.FullyConnected(sym.Variable("data"), num_hidden=4, name="fc")
    seq = tmx.mod.SequentialModule()
    with pytest.raises(ValueError):
        seq.add(tmx.mod.Module(net, label_names=None, context=tmx.cpu()),
                bogus=True)
    seq.add(tmx.mod.Module(net, label_names=None, context=tmx.cpu()))
    seq.add(tmx.mod.Module(net, label_names=None, context=tmx.cpu()),
            auto_wiring=True)
    seq.bind([("data", (2, 4))])
    with pytest.raises(ValueError, match="Duplicated"):
        seq.init_params()


def test_python_loss_module_checks():
    with pytest.raises(ValueError):
        tmx.mod.PythonLossModule(data_names=("a", "b"))
    with pytest.raises(TypeError):
        tmx.mod.PythonLossModule(grad_func=3)
    m = tmx.mod.PythonLossModule()
    m.bind([("data", (2, 3))], [("softmax_label", (2,))])
    assert m.output_shapes == [("pyloss_output", (2, 3))]
    assert m.get_params() == ({}, {})
    with pytest.raises(ValueError):
        m.bind([("data", (2, 3))], force_rebind=True, grad_req="add")


def test_executor_manager_matches_jax():
    X, y = _data(16)
    res = {}
    for pkg in (tmx, jmx):
        sym = pkg.sym
        net = sym.SoftmaxOutput(sym.FullyConnected(
            sym.Activation(sym.FullyConnected(sym.Variable("data"),
                                              num_hidden=8, name="fc1"),
                           act_type="tanh"), num_hidden=3, name="fc2"),
            name="softmax")
        it = pkg.io.NDArrayIter(X, y, batch_size=8)
        man = pkg.DataParallelExecutorManager(net, [pkg.cpu()], it)
        rs = np.random.RandomState(3)
        kw = {"ctx": "cpu"} if pkg is tmx else {}
        params = {n: pkg.nd.array(rs.normal(0, 0.3, a[0].shape).astype(
            np.float32), **kw) for n, a in zip(man.param_names,
                                               man.param_arrays)}
        man.set_params(params, {})
        man.load_data_batch(next(it))
        man.forward(is_train=True)
        man.backward()
        metric = pkg.metric.Accuracy()
        man.update_metric(metric, next(iter([it.getlabel()])))
        got_args, got_aux = {}, {}
        man.copy_to(got_args, got_aux)
        res[pkg] = ({n: g[0].asnumpy() for n, g in
                     zip(man.param_names, man.grad_arrays)}, got_args,
                    man.param_names, [s.stop - s.start for s in man.slices])
    _close(res[tmx][0], res[jmx][0])
    _close(res[tmx][1], res[jmx][1])
    assert res[tmx][2] == res[jmx][2]
    assert res[tmx][3] == res[jmx][3] == [8]


def test_executor_manager_refuses_several_contexts():
    """Several contexts are ported: the manager over [cpu(0), cpu(1)]
    splits the batch 4/4, and its summed gradients and metric equal the
    JAX package's manager over the same two contexts; a Module with
    ``group2ctxs`` binds and predicts what the Module without it does
    (ctx_group placement: tests/test_torch_placement.py)."""
    X, y = _data(16)
    res = {}
    for pkg in (tmx, jmx):
        sym = pkg.sym
        net = sym.SoftmaxOutput(sym.FullyConnected(
            sym.Variable("data"), num_hidden=3, name="fc"), name="softmax")
        it = pkg.io.NDArrayIter(X, y, batch_size=8)
        man = pkg.DataParallelExecutorManager(net, [pkg.cpu(0), pkg.cpu(1)],
                                              it)
        rs = np.random.RandomState(3)
        kw = {"ctx": "cpu"} if pkg is tmx else {}
        params = {n: pkg.nd.array(rs.normal(0, 0.3, a[0].shape).astype(
            np.float32), **kw) for n, a in zip(man.param_names,
                                               man.param_arrays)}
        man.set_params(params, {})
        if pkg is tmx:
            tparams = params
        man.load_data_batch(next(it))
        man.forward(is_train=True)
        man.backward()
        metric = pkg.metric.Accuracy()
        man.update_metric(metric, next(iter([it.getlabel()])))
        res[pkg] = ({n: sum(x.asnumpy() for x in g) for n, g in
                     zip(man.param_names, man.grad_arrays)},
                    [s.stop - s.start for s in man.slices], metric.get())
    _close(res[tmx][0], res[jmx][0])
    assert res[tmx][1] == res[jmx][1] == [4, 4]
    assert res[tmx][2] == res[jmx][2]
    outs = []
    for g2c in ({"dev1": tmx.cpu()}, None):
        with tmx.AttrScope(ctx_group="dev1"):
            fc = tmx.sym.FullyConnected(tmx.sym.Variable("data"),
                                        num_hidden=3, name="fc")
        mod = tmx.mod.Module(tmx.sym.SoftmaxOutput(fc, name="softmax"),
                             context=tmx.cpu(), group2ctxs=g2c)
        mod.bind([("data", (8, X.shape[1]))], [("softmax_label", (8,))])
        mod.init_params(arg_params={"fc_weight": tparams["fc_weight"],
                                    "fc_bias": tparams["fc_bias"]})
        mod.forward(tmx.io.DataBatch([tmx.nd.array(X[:8], ctx="cpu")], []),
                    is_train=False)
        outs.append(mod.get_outputs()[0].asnumpy())
    np.testing.assert_array_equal(outs[0], outs[1])
def _ff_net(pkg):
    sym = pkg.sym
    net = sym.Activation(sym.FullyConnected(sym.Variable("data"),
                                            num_hidden=16, name="fc1"),
                         act_type="relu")
    return sym.SoftmaxOutput(sym.FullyConnected(net, num_hidden=3,
                                                name="fc2"),
                             name="softmax")


def test_feedforward_fit_predict_save_load_match_jax(tmp_path):
    X, y = _data(64)
    res = {}
    for pkg in (tmx, jmx):
        np.random.seed(4)               # NDArrayIter's shuffle
        pkg.random.seed(0)
        model = pkg.model.FeedForward(
            _ff_net(pkg), ctx=pkg.cpu(), num_epoch=3,
            initializer=pkg.init.Xavier(), learning_rate=0.1,
            numpy_batch_size=16)
        model.fit(X, y)
        model.save(str(tmp_path / pkg.__name__))
        res[pkg] = (model.arg_params, model.predict(X))
    _close(res[tmx][0], res[jmx][0])
    np.testing.assert_allclose(res[tmx][1], res[jmx][1], rtol=1e-5,
                               atol=1e-6)
    # each package loads the other's checkpoint and predicts the same
    t = tmx.model.FeedForward.load(str(tmp_path / "mxnet_tpu"), 3,
                                   ctx=tmx.cpu(), numpy_batch_size=16)
    j = jmx.model.FeedForward.load(str(tmp_path / "mxnet_tpu_torch"), 3,
                                   ctx=jmx.cpu(), numpy_batch_size=16)
    assert t.begin_epoch == j.begin_epoch == 3
    np.testing.assert_allclose(t.predict(X), res[jmx][1], rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(j.predict(X), res[tmx][1], rtol=1e-5,
                               atol=1e-6)


def test_feedforward_create_matches_jax():
    X, y = _data(32, seed=2)
    res = {}
    for pkg in (tmx, jmx):
        np.random.seed(1)
        pkg.random.seed(0)
        it = pkg.io.NDArrayIter(X, y, batch_size=8)
        model = pkg.model.FeedForward.create(
            _ff_net(pkg), it, ctx=pkg.cpu(), num_epoch=2,
            initializer=pkg.init.Xavier(), learning_rate=0.2)
        res[pkg] = model.predict(it)
    np.testing.assert_allclose(res[tmx], res[jmx], rtol=1e-5, atol=1e-6)
    assert tmx.FeedForward is tmx.model.FeedForward
