"""The port's Gluon (``mx.gluon``: blocks and ``hybridize``, parameters,
the ``nn`` layers, the losses, ``Trainer``, ``utils``, the vision model
zoo, ``contrib.nn``) against the JAX package's, on the CPU.

Each block is built in both packages inside a fresh ``NameManager``
(so the names are compared too), initialized in the JAX package, run once
to finish deferred initialization, and its parameters carried into the
port with ``convert.gluon_params_from_numpy``.  Then the same numpy
inputs (made from a seed) go through both under ``autograd.record``, the
output is weighted by a fixed cotangent, and the outputs, the input's
gradient and every parameter's gradient are compared (f32 on both sides
in another summation order: rtol 1e-4 / atol 1e-5 unless a case states
its own), hybridized and not.  BatchNorm also compares its moving
statistics after the training forward.

Trainer: three steps (SGD with momentum and Adam; a store name on one
device, which makes no store; a ``KVStore`` object with
``update_on_kvstore`` on and off; 2-bit compression), every weight after
each step within 1e-5 of the JAX package's.  The tiny LM (L2, hidden 64,
T 64, vocab 1000, batch 4) trains two steps through ``SymbolBlock`` and
``Trainer`` in both packages: losses within 1e-5, weights within 1e-5.
"""
import json

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.base import DeviceUnavailable, NotPortedYet
from mxnet_tpu_torch.convert import gluon_params_from_numpy

RTOL, ATOL = 1e-4, 1e-5


def _close(got, want, rtol=RTOL, atol=ATOL, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                               err_msg=what)


def _build(mx, make):
    with mx.name.NameManager():
        return make(mx)


def _jax_params(net):
    return {k: p.data().asnumpy() for k, p in net.collect_params().items()}


def _run(mx, net, inputs, cot, hybridize, train=True):
    """Forward under record, ``backward`` with ``cot``; returns the output,
    the inputs' gradients and the parameters' gradients by name."""
    if hybridize:
        net.hybridize()
    xs = [mx.nd.array(a) for a in inputs]
    for x in xs:
        if x.dtype == np.float32:
            x.attach_grad()
    with mx.autograd.record(train_mode=train):
        out = net(*xs)
    out.backward(mx.nd.array(cot))
    grads = {k: p.grad().asnumpy() for k, p in net.collect_params().items()
             if p.grad_req != "null"}
    return (out.asnumpy(), [x.grad.asnumpy() for x in xs
                            if x.grad is not None], grads)


def _compare_block(make, inputs, hybridize, rtol=RTOL, atol=ATOL,
                   train=True):
    jnet = _build(jmx, make)
    jnet.initialize(jmx.init.Xavier())
    jnet(*[jmx.nd.array(a) for a in inputs])
    arrays = _jax_params(jnet)
    with tmx.cpu():
        tnet = _build(tmx, make)
        tnet.initialize()
        tnet(*[tmx.nd.array(a) for a in inputs])
        gluon_params_from_numpy(tnet.collect_params(), arrays)
        assert list(tnet.collect_params().keys()) == list(arrays)
        out_shape = tnet(*[tmx.nd.array(a) for a in inputs]).shape
        cot = np.random.RandomState(7).randn(*out_shape).astype(np.float32)
        got = _run(tmx, tnet, inputs, cot, hybridize, train)
    want = _run(jmx, jnet, inputs, cot, hybridize, train)
    _close(got[0], want[0], rtol, atol, "output")
    for g, w in zip(got[1], want[1]):
        _close(g, w, rtol, atol, "input grad")
    assert sorted(got[2]) == sorted(want[2])
    for k in want[2]:
        _close(got[2][k], want[2][k], rtol, atol, k)
    return jnet, tnet


def _x(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _seq(mx, layers):
    net = mx.gluon.nn.HybridSequential()
    with net.name_scope():
        net.add(*layers(mx))
    return net


LAYERS = {
    "Dense": (lambda mx: mx.gluon.nn.Dense(5, activation="tanh"),
              [_x(0, 3, 4)]),
    "Dense-no-flatten": (lambda mx: mx.gluon.nn.Dense(
        6, flatten=False, use_bias=False, in_units=4), [_x(1, 2, 3, 4)]),
    "Activation": (lambda mx: mx.gluon.nn.Activation("softrelu"),
                   [_x(2, 3, 5)]),
    "LeakyReLU": (lambda mx: mx.gluon.nn.LeakyReLU(0.1), [_x(3, 3, 5)]),
    "BatchNorm": (lambda mx: mx.gluon.nn.BatchNorm(), [_x(4, 4, 3, 5, 5)]),
    "InstanceNorm": (lambda mx: mx.gluon.nn.InstanceNorm(scale=True),
                     [_x(5, 2, 3, 6)]),
    "LayerNorm": (lambda mx: mx.gluon.nn.LayerNorm(), [_x(6, 3, 8)]),
    "Embedding": (lambda mx: mx.gluon.nn.Embedding(10, 4),
                  [np.array([[1, 4, 9], [0, 4, 2]], np.float32)]),
    "Flatten": (lambda mx: mx.gluon.nn.Flatten(), [_x(7, 2, 3, 4)]),
    "Conv1D": (lambda mx: mx.gluon.nn.Conv1D(4, 3, strides=2, padding=1),
               [_x(8, 2, 3, 9)]),
    "Conv2D": (lambda mx: mx.gluon.nn.Conv2D(4, 3, padding=1, groups=1,
                                             activation="relu"),
               [_x(9, 2, 3, 6, 6)]),
    "Conv3D": (lambda mx: mx.gluon.nn.Conv3D(2, 2, in_channels=3),
               [_x(10, 1, 3, 4, 4, 4)]),
    "Conv1DTranspose": (lambda mx: mx.gluon.nn.Conv1DTranspose(
        3, 3, strides=2, in_channels=2), [_x(11, 2, 2, 5)]),
    "Conv2DTranspose": (lambda mx: mx.gluon.nn.Conv2DTranspose(
        4, 2, strides=2, in_channels=3), [_x(12, 2, 3, 4, 4)]),
    "Conv3DTranspose": (lambda mx: mx.gluon.nn.Conv3DTranspose(
        2, 2, in_channels=2), [_x(13, 1, 2, 3, 3, 3)]),
    "MaxPool1D": (lambda mx: mx.gluon.nn.MaxPool1D(2), [_x(14, 2, 3, 8)]),
    "MaxPool2D": (lambda mx: mx.gluon.nn.MaxPool2D(3, 2, 1,
                                                   ceil_mode=True),
                  [_x(15, 2, 3, 7, 7)]),
    "MaxPool3D": (lambda mx: mx.gluon.nn.MaxPool3D(2),
                  [_x(16, 1, 2, 4, 4, 4)]),
    "AvgPool1D": (lambda mx: mx.gluon.nn.AvgPool1D(2), [_x(17, 2, 3, 8)]),
    "AvgPool2D": (lambda mx: mx.gluon.nn.AvgPool2D(2, padding=1),
                  [_x(18, 2, 3, 6, 6)]),
    "AvgPool3D": (lambda mx: mx.gluon.nn.AvgPool3D(2),
                  [_x(19, 1, 2, 4, 4, 4)]),
    "GlobalMaxPool1D": (lambda mx: mx.gluon.nn.GlobalMaxPool1D(),
                        [_x(20, 2, 3, 8)]),
    "GlobalMaxPool2D": (lambda mx: mx.gluon.nn.GlobalMaxPool2D(),
                        [_x(21, 2, 3, 5, 5)]),
    "GlobalMaxPool3D": (lambda mx: mx.gluon.nn.GlobalMaxPool3D(),
                        [_x(22, 1, 2, 3, 3, 3)]),
    "GlobalAvgPool1D": (lambda mx: mx.gluon.nn.GlobalAvgPool1D(),
                        [_x(23, 2, 3, 8)]),
    "GlobalAvgPool2D": (lambda mx: mx.gluon.nn.GlobalAvgPool2D(),
                        [_x(24, 2, 3, 5, 5)]),
    "GlobalAvgPool3D": (lambda mx: mx.gluon.nn.GlobalAvgPool3D(),
                        [_x(25, 1, 2, 3, 3, 3)]),
    "HybridLambda": (lambda mx: mx.gluon.nn.HybridLambda(
        lambda F, x: F.tanh(x) * 2), [_x(26, 3, 4)]),
    "HybridSequential": (lambda mx: _seq(mx, lambda mx: [
        mx.gluon.nn.Conv2D(4, 3), mx.gluon.nn.BatchNorm(),
        mx.gluon.nn.Activation("relu"), mx.gluon.nn.MaxPool2D(2),
        mx.gluon.nn.Flatten(), mx.gluon.nn.Dense(3)]),
        [_x(27, 2, 3, 8, 8)]),
    "HybridConcurrent": (lambda mx: _concurrent(mx), [_x(28, 4, 5)]),
}


def _concurrent(mx):
    cat = mx.gluon.contrib.nn.HybridConcurrent(axis=1)
    with cat.name_scope():
        cat.add(mx.gluon.nn.Dense(3), mx.gluon.contrib.nn.Identity(),
                mx.gluon.nn.Dense(2))
    return cat


@pytest.mark.parametrize("hybridize", [False, True], ids=["eager", "hybrid"])
@pytest.mark.parametrize("name", sorted(LAYERS))
def test_layer_forward_and_gradients_match_jax(name, hybridize):
    make, inputs = LAYERS[name]
    jnet, tnet = _compare_block(make, inputs, hybridize)
    if name in ("BatchNorm", "HybridSequential"):
        # the training forward moved the statistics once, as in JAX
        want = _jax_params(jnet)
        for k, p in tnet.collect_params().items():
            if "running" in k:
                _close(p.data().asnumpy(), want[k], what=k)


def test_imperative_sequential_and_lambda_match_jax():
    def make(mx):
        net = mx.gluon.nn.Sequential()
        with net.name_scope():
            net.add(mx.gluon.nn.Dense(4, activation="relu"),
                    mx.gluon.nn.Lambda(lambda x: x * 3),
                    mx.gluon.nn.Dense(2))
        return net
    _compare_block(make, [_x(30, 3, 5)], hybridize=False)


def test_dropout_masks_in_training_only():
    with tmx.cpu():
        do = tmx.gluon.nn.Dropout(0.5)
        x = tmx.nd.ones((32, 32))
        assert (do(x).asnumpy() == 1).all()
        do.hybridize()
        assert (do(x).asnumpy() == 1).all()
        with tmx.autograd.record():
            y = do(x).asnumpy()
        assert set(np.unique(y)) == {0.0, 2.0}
        assert 0.35 < (y == 0).mean() < 0.65


# -- names and files --------------------------------------------------------

def _two_dense(mx):
    net = mx.gluon.nn.HybridSequential()
    with net.name_scope():
        net.add(mx.gluon.nn.Dense(4, in_units=3, activation="relu"),
                mx.gluon.nn.Dense(2, in_units=4))
    return net


def test_parameter_names_equal_jax():
    for make in (_two_dense,
                 lambda mx: mx.gluon.model_zoo.vision.resnet18_v1(
                     classes=10),
                 lambda mx: mx.gluon.model_zoo.vision.mobilenet0_25(),
                 lambda mx: _concurrent(mx)):
        want = list(_build(jmx, make).collect_params().keys())
        got = list(_build(tmx, make).collect_params().keys())
        assert got == want
    assert list(_build(tmx, _two_dense).collect_params())[0] == \
        "hybridsequential0_dense0_weight"


def test_params_files_cross_both_ways(tmp_path):
    jnet = _build(jmx, _two_dense)
    jnet.initialize(jmx.init.Xavier())
    jnet.save_params(str(tmp_path / "j.params"))
    x = _x(31, 2, 3)
    with tmx.cpu():
        tnet = _build(tmx, _two_dense)
        tnet.load_params(str(tmp_path / "j.params"))
        _close(tnet(tmx.nd.array(x)).asnumpy(),
               jnet(jmx.nd.array(x)).asnumpy())
        # the port's file into the JAX package
        for p in tnet.collect_params().values():
            p.set_data(p.data() * 2)
        tnet.save_params(str(tmp_path / "t.params"))
        tnet.hybridize()
        out = tnet(tmx.nd.array(x)).asnumpy()
        tnet.export(str(tmp_path / "t"))
    jnet2 = _build(jmx, _two_dense)
    jnet2.load_params(str(tmp_path / "t.params"))
    _close(jnet2(jmx.nd.array(x)).asnumpy(), out)
    # the exported graph and its arg:/aux: params into a JAX SymbolBlock
    sym = jmx.sym.load(str(tmp_path / "t-symbol.json"))
    blk = jmx.gluon.SymbolBlock(sym, jmx.sym.var("data"))
    blk.collect_params().load(str(tmp_path / "t-0000.params"))
    _close(blk(jmx.nd.array(x)).asnumpy(), out)


def test_parameter_and_dict_api():
    with tmx.cpu():
        p = tmx.gluon.Parameter("w", shape=(0, 3), allow_deferred_init=True)
        p.initialize()
        with pytest.raises(tmx.gluon.parameter.DeferredInitializationError):
            p.data()
        p.set_data(tmx.nd.ones((2, 3)))
        assert p.data().shape == (2, 3) and p.grad().shape == (2, 3)
        p.grad()[:] = 5
        p.zero_grad()
        assert (p.grad().asnumpy() == 0).all()
        p.grad_req = "null"
        with pytest.raises(RuntimeError):
            p.grad()
        p.grad_req = "add"
        p.cast("float64")
        assert p.data().dtype == np.float64 and p.grad().dtype == np.float64
        p.reset_ctx(tmx.cpu())
        assert p.list_ctx() == [tmx.cpu()]
        c = tmx.gluon.Constant("c", [[1, 2], [3, 4]])
        c.initialize()
        assert c.grad_req == "null"
        np.testing.assert_array_equal(c.data().asnumpy(), [[1, 2], [3, 4]])
        d1 = tmx.gluon.ParameterDict("net1_")
        d2 = tmx.gluon.ParameterDict(d1.prefix, shared=d1)
        d1.get("w0", shape=(10, 10))
        assert d2.get("w0") is d1.get("w0")
        # several contexts are ported: one copy (and gradient) each
        w = tmx.gluon.Parameter("w", shape=(2,))
        w.initialize(ctx=[tmx.cpu(0), tmx.cpu(1)])
        assert w.list_ctx() == [tmx.cpu(0), tmx.cpu(1)]
        a, b = w.list_data()
        assert a is not b and np.array_equal(a.asnumpy(), b.asnumpy())
        assert len(w.list_grad()) == 2 and w.data(tmx.cpu(1)) is b


def test_block_apply_summary_and_infer_shape(capsys):
    with tmx.cpu():
        net = _build(tmx, lambda mx: _seq(mx, lambda mx: [
            mx.gluon.nn.Dense(4), mx.gluon.nn.Dense(2)]))
        net.infer_shape(tmx.nd.ones((3, 5)))
        assert [p.shape for p in net.collect_params().values()] == \
            [(4, 5), (4,), (2, 4), (2,)]
        seen = []
        net.apply(lambda b: seen.append(type(b).__name__))
        assert seen == ["Dense", "Dense", "HybridSequential"]
        net.initialize()
        out = net.summary(tmx.nd.ones((3, 5)))
        assert out.shape == (3, 2)
        assert "Parameters: 34" in capsys.readouterr().out


def test_gluon_needs_the_card_unless_asked_for_the_cpu():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    net = tmx.gluon.nn.Dense(2, in_units=3)
    with pytest.raises(DeviceUnavailable):
        net.initialize()
    with pytest.raises(DeviceUnavailable):
        tmx.gluon.rnn.LSTM(4, input_size=3).initialize()
    # data IO is ported: the loader resolves (its batches are host arrays)
    assert tmx.gluon.data.DataLoader.__module__ == \
        "mxnet_tpu_torch.gluon.data.dataloader"


# -- losses -----------------------------------------------------------------

def _labels(seed, n, k):
    return np.random.RandomState(seed).randint(0, k, n).astype(np.float32)


def _ctc_inputs():
    pred = _x(40, 2, 6, 4)
    label = np.array([[1, 2], [3, 1]], np.float32)
    return pred, [label]


LOSSES = {
    "L2Loss": (lambda g: g.loss.L2Loss(), _x(41, 4, 5), [_x(42, 4, 5)]),
    "L1Loss": (lambda g: g.loss.L1Loss(), _x(43, 4, 5), [_x(44, 4, 5)]),
    "SigmoidBCELoss": (lambda g: g.loss.SigmoidBCELoss(), _x(45, 4, 5),
                       [(_x(46, 4, 5) > 0).astype(np.float32)]),
    "SigmoidBCELoss-from-sigmoid": (
        lambda g: g.loss.SigmoidBinaryCrossEntropyLoss(from_sigmoid=True),
        1 / (1 + np.exp(-_x(47, 4, 5))),
        [(_x(48, 4, 5) > 0).astype(np.float32)]),
    "SoftmaxCELoss": (lambda g: g.loss.SoftmaxCrossEntropyLoss(),
                      _x(49, 4, 5), [_labels(50, 4, 5)]),
    "SoftmaxCELoss-dense": (
        lambda g: g.loss.SoftmaxCELoss(sparse_label=False, weight=0.5),
        _x(51, 4, 5), [np.abs(_x(52, 4, 5))]),
    "SoftmaxCELoss-3d": (lambda g: g.loss.SoftmaxCrossEntropyLoss(),
                         _x(53, 2, 6, 7), [_labels(54, 12, 7)
                                           .reshape(2, 6)]),
    "KLDivLoss": (lambda g: g.loss.KLDivLoss(from_logits=False),
                  _x(55, 4, 5), [np.abs(_x(56, 4, 5)) / 5]),
    "KLDivLoss-logits": (lambda g: g.loss.KLDivLoss(), _x(57, 4, 5) - 2,
                         [np.abs(_x(58, 4, 5)) / 5]),
    "HuberLoss": (lambda g: g.loss.HuberLoss(rho=0.5), _x(59, 4, 5),
                  [_x(60, 4, 5)]),
    "HingeLoss": (lambda g: g.loss.HingeLoss(), _x(61, 4, 5),
                  [np.sign(_x(62, 4, 5))]),
    "SquaredHingeLoss": (lambda g: g.loss.SquaredHingeLoss(margin=2),
                         _x(63, 4, 5), [np.sign(_x(64, 4, 5))]),
    "LogisticLoss": (lambda g: g.loss.LogisticLoss(), _x(65, 4, 5),
                     [np.sign(_x(66, 4, 5))]),
    "LogisticLoss-binary": (
        lambda g: g.loss.LogisticLoss(label_format="binary"),
        _x(67, 4, 5), [(_x(68, 4, 5) > 0).astype(np.float32)]),
    "TripletLoss": (lambda g: g.loss.TripletLoss(), _x(69, 4, 5),
                    [_x(70, 4, 5), _x(71, 4, 5)]),
    "CTCLoss": (lambda g: g.loss.CTCLoss(), *_ctc_inputs()),
    "L2Loss-sample-weight": (lambda g: g.loss.L2Loss(weight=2.0),
                             _x(72, 4, 5), [_x(73, 4, 5),
                                            np.abs(_x(74, 4, 1))]),
}


@pytest.mark.parametrize("name", sorted(LOSSES))
def test_loss_and_gradient_match_jax(name):
    make, pred, rest = LOSSES[name]

    def run(mx):
        p = mx.nd.array(pred)
        p.attach_grad()
        others = [mx.nd.array(a) for a in rest]
        with mx.autograd.record():
            loss = make(mx.gluon)(p, *others)
        loss.backward()
        return loss.asnumpy(), p.grad.asnumpy()

    want = run(jmx)
    with tmx.cpu():
        got = run(tmx)
    _close(got[0], want[0], what="loss")
    _close(got[1], want[1], what="grad")


# -- Trainer ----------------------------------------------------------------

TRAINERS = {
    "sgd-momentum": ("sgd", {"learning_rate": 0.1, "momentum": 0.9,
                             "wd": 1e-3}, "device", None, None),
    "adam": ("adam", {"learning_rate": 0.01}, "device", None, None),
    "sgd-store-update-on-kvstore": ("sgd", {"learning_rate": 0.1,
                                            "momentum": 0.9},
                                    "store", None, True),
    "adam-store-local-update": ("adam", {"learning_rate": 0.01}, "store",
                                None, False),
    "sgd-2bit": ("sgd", {"learning_rate": 0.1, "momentum": 0.9}, "store",
                 {"type": "2bit", "threshold": 0.05}, None),
}


def _mlp(mx):
    net = mx.gluon.nn.HybridSequential()
    with net.name_scope():
        net.add(mx.gluon.nn.Dense(8, in_units=6, activation="tanh"),
                mx.gluon.nn.Dense(3, in_units=8))
    return net


def _train(mx, net, spec, X, Y, steps=3):
    opt, params, kv, comp, on_kv = spec
    if kv == "store":
        kv = mx.kv.create("device") if mx is jmx else \
            mx.kv.create("device", device="cpu")
    tr = mx.gluon.Trainer(net.collect_params(), opt, dict(params),
                          kvstore=kv, compression_params=comp,
                          update_on_kvstore=on_kv)
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    weights = []
    for _ in range(steps):
        with mx.autograd.record():
            loss = loss_fn(net(mx.nd.array(X)), mx.nd.array(Y))
        loss.backward()
        tr.step(X.shape[0])
        weights.append({k: p.data().asnumpy()
                        for k, p in net.collect_params().items()})
    return weights, tr


@pytest.mark.parametrize("name", sorted(TRAINERS))
def test_trainer_steps_match_jax(name, tmp_path):
    spec = TRAINERS[name]
    X = _x(80, 8, 6)
    Y = _labels(81, 8, 3)
    jnet = _build(jmx, _mlp)
    jnet.initialize(jmx.init.Xavier())
    arrays = _jax_params(jnet)
    want, _ = _train(jmx, jnet, spec, X, Y)
    with tmx.cpu():
        tnet = _build(tmx, _mlp)
        gluon_params_from_numpy(tnet.collect_params(), arrays,
                                ctx=tmx.cpu())
        got, tr = _train(tmx, tnet, spec, X, Y)
        tr.save_states(str(tmp_path / "t.states"))
        tr.load_states(str(tmp_path / "t.states"))
        tr.set_learning_rate(0.05)
        assert tr.learning_rate == 0.05
    for step, (g, w) in enumerate(zip(got, want)):
        for k in w:
            _close(g[k], w[k], rtol=1e-5, atol=1e-5,
                   what="step %d %s" % (step, k))


def test_trainer_refuses_grad_guard():
    with tmx.cpu():
        net = _build(tmx, _mlp)
        net.initialize()
        with pytest.raises(NotPortedYet, match="item 8, resilience"):
            tmx.gluon.Trainer(net.collect_params(), "sgd",
                              grad_guard=object())


def test_utils_match_jax():
    arrays = [_x(90, 2, 2) * 3, _x(91, 3) * 4]
    jarr = [jmx.nd.array(a) for a in arrays]
    jnorm = jmx.gluon.utils.clip_global_norm(jarr, 1.0)
    with tmx.cpu():
        tarr = [tmx.nd.array(a) for a in arrays]
        tnorm = tmx.gluon.utils.clip_global_norm(tarr, 1.0)
        for g, w in zip(tarr, jarr):
            _close(g.asnumpy(), w.asnumpy(), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(tnorm, jnorm, rtol=1e-6)
        data = tmx.nd.arange(0, 16).reshape((8, 2))
        parts = tmx.gluon.utils.split_data(data, 4)
        assert [p.shape for p in parts] == [(2, 2)] * 4
        (part,) = tmx.gluon.utils.split_and_load(np.ones((4, 2)),
                                                 [tmx.cpu()])
        assert part.shape == (4, 2) and part.context == tmx.cpu()
        with pytest.raises(RuntimeError):
            tmx.gluon.utils.download("http://localhost/x")


# -- model zoo --------------------------------------------------------------

ZOO = [n for n in jmx.gluon.model_zoo.vision.__all__
       if n[0].islower() and n not in ("get_model", "get_resnet", "get_vgg",
                                       "get_mobilenet")]


# one factory per family is also held to the JAX package's shape
# inference; every factory's graph is compared whole (its JSON)
ZOO_INFER = ("resnet18_v1", "resnet50_v2", "vgg11_bn", "alexnet",
             "squeezenet1_1", "densenet121", "mobilenet0_25",
             "inception_v3")


@pytest.mark.parametrize("name", ZOO)
def test_model_zoo_factory_shapes_match_jax(name):
    """Every factory's traced graph equals the JAX package's (nodes, names,
    attrs: the ``-symbol.json``), and the port's shape inference gives
    the output (1, 7) at a small input; for one factory per family the
    output, parameter and aux shapes equal the JAX package's inference.
    No weights are made."""
    size = 299 if "inception" in name else (
        224 if name == "alexnet" else 32)
    shape = (1, 3, size, size)

    def trace(mx):
        with mx.name.NameManager():
            net = getattr(mx.gluon.model_zoo.vision, name)(classes=7)
        return net(mx.sym.var("data"))

    def infer(out):
        args, outs, aux = out.infer_shape(data=shape)
        return (outs[0], dict(zip(out.list_arguments(), args)),
                dict(zip(out.list_auxiliary_states(), aux)))

    jout, tout = trace(jmx), trace(tmx)
    assert json.loads(tout.tojson()) == json.loads(jout.tojson())
    got = infer(tout)
    assert got[0] == (1, 7)
    if name in ZOO_INFER:
        assert got == infer(jout)
    with pytest.raises(RuntimeError):
        tmx.gluon.model_zoo.get_model(name.replace("_", ".")
                                      if "mobilenet" in name
                                      or "squeezenet" in name
                                      else name, pretrained=True)


def test_resnet18_v1_forward_and_gradient_match_jax():
    """In predict mode (BatchNorm on its moving statistics: a training
    BatchNorm of the last stage would normalize two values per channel,
    1x1 maps at batch 2, and magnify rounding into the gradients).  ReLU
    and max-pool ties make conv nets' f32 gradients differ by rounding
    between the packages (ROADMAP C "Float32 discreteness"): the output
    and each gradient are held to 2e-3 of their largest magnitude."""
    def make(mx):
        return mx.gluon.model_zoo.vision.resnet18_v1(classes=10)
    x = _x(95, 2, 3, 32, 32)
    jnet = _build(jmx, make)
    jnet.initialize(jmx.init.Xavier())
    jnet(jmx.nd.array(x))
    arrays = _jax_params(jnet)
    cot = _x(96, 2, 10)
    with tmx.cpu():
        tnet = _build(tmx, make)
        gluon_params_from_numpy(tnet.collect_params(), arrays,
                                ctx=tmx.cpu())
        got = _run(tmx, tnet, [x], cot, hybridize=True, train=False)
    want = _run(jmx, jnet, [x], cot, hybridize=True, train=False)
    assert np.abs(got[0] - want[0]).max() <= 2e-3 * np.abs(want[0]).max()
    for k, w in want[2].items():
        scale = max(np.abs(w).max(), 1e-6)
        assert np.abs(got[2][k] - w).max() <= 2e-3 * scale, k


# -- the tiny LM through SymbolBlock and Trainer ----------------------------

def _lm_block(mx, pkg):
    get_symbol = pkg.get_symbol
    net = get_symbol(vocab_size=1000, seq_len=64, num_layers=2, hidden=64,
                     heads=2)
    logits = net.get_internals()["head_output"]
    return mx.gluon.SymbolBlock(logits, mx.sym.var("data"))


def test_lm_two_steps_through_symbolblock_and_trainer_match_jax():
    from mxnet_tpu.models import transformer as jt
    from mxnet_tpu_torch.models import transformer as tt
    rs = np.random.RandomState(97)
    X = rs.randint(0, 1000, (4, 64)).astype(np.float32)
    Y = rs.randint(0, 1000, (4, 64)).astype(np.float32)

    def steps(mx, net):
        tr = mx.gluon.Trainer(net.collect_params(), "sgd",
                              {"learning_rate": 0.05, "momentum": 0.9})
        loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
        losses = []
        for _ in range(2):
            with mx.autograd.record():
                loss = loss_fn(net(mx.nd.array(X)), mx.nd.array(Y))
            loss.backward()
            tr.step(4)
            losses.append(loss.asnumpy())
        return losses, {k: p.data().asnumpy()
                        for k, p in net.collect_params().items()}

    jnet = _lm_block(jmx, jt)
    jnet.collect_params().initialize(jmx.init.Xavier())
    jnet(jmx.nd.array(X))
    arrays = _jax_params(jnet)
    want = steps(jmx, jnet)
    with tmx.cpu():
        tnet = _lm_block(tmx, tt)
        tnet.hybridize()
        gluon_params_from_numpy(tnet.collect_params(), arrays,
                                ctx=tmx.cpu())
        got = steps(tmx, tnet)
    for g, w in zip(got[0], want[0]):
        _close(g, w, rtol=1e-5, atol=1e-5, what="loss")
    assert sorted(got[1]) == sorted(want[1])
    for k, w in want[1].items():
        _close(got[1][k], w, rtol=1e-5, atol=1e-5, what=k)


@pytest.mark.parametrize("policy", ["dots", "full"])
def test_remat_policy_leaves_hybridized_gradients_unchanged(policy):
    """``set_backward_mirror`` reaches a hybridized block's program (a
    recording forward runs in checkpointed segments); its gradients equal
    those without remat within 1e-6 of each tensor's largest (the same
    ops, recomputed), and BatchNorm's statistics move once per forward."""
    from mxnet_tpu_torch.executor import set_backward_mirror
    from mxnet_tpu_torch.models import transformer as tt
    rs = np.random.RandomState(98)
    X = rs.randint(0, 50, (2, 16)).astype(np.float32)
    Y = rs.randint(0, 50, (2, 16)).astype(np.float32)
    got = {}
    with tmx.cpu():
        net = tmx.gluon.SymbolBlock(
            tt.get_symbol(vocab_size=50, seq_len=16, num_layers=2,
                          hidden=16, heads=2).get_internals()["head_output"],
            tmx.sym.var("data"))
        tmx.random.seed(0)
        net.collect_params().initialize(tmx.init.Xavier())
        net.hybridize()
        loss_fn = tmx.gluon.loss.SoftmaxCrossEntropyLoss()
        bn = _build(tmx, lambda mx: _seq(mx, lambda mx: [
            mx.gluon.nn.Dense(8), mx.gluon.nn.BatchNorm(),
            mx.gluon.nn.Dense(3)]))
        bn.initialize()
        bn.hybridize()
        try:
            for p in ("none", policy):
                set_backward_mirror(p)
                with tmx.autograd.record():
                    loss = loss_fn(net(tmx.nd.array(X)), tmx.nd.array(Y))
                    out = bn(tmx.nd.array(_x(99, 4, 5)))
                loss.backward()
                out.backward()
                got[p] = {k: v.grad().asnumpy().copy() for k, v in
                          list(net.collect_params().items()) +
                          list(bn.collect_params().items())
                          if v.grad_req != "null"}
                got[p]["mean"] = [v.data().asnumpy().copy() for k, v in
                                  bn.collect_params().items()
                                  if "running_mean" in k][0]
        finally:
            set_backward_mirror(None)
    for k, w in got["none"].items():
        if k == "mean":
            continue
        assert np.abs(got[policy][k] - w).max() <= \
            1e-6 * max(np.abs(w).max(), 1e-30), k
    # two training forwards: 0.9 * (0.9 * 0 + 0.1 m) + 0.1 m = 0.19 m
    np.testing.assert_allclose(got[policy]["mean"],
                               got["none"]["mean"] * 1.9, rtol=1e-5,
                               atol=1e-7)
