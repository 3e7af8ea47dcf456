"""The port's initializers, checkpoints and checkpoint callbacks against
the JAX package's, on the CPU.

* Initializers: after the same ``mx.random.seed``, the same sequence of
  initializer calls gives the same values in both packages, bit for bit
  (both draw on the host with numpy, seeded from the same threefry key
  stream): every scheme, the name routes, ``Mixed``, ``Load`` and a
  Variable's ``init=`` (the ``__init__`` attr).
* Files: ``model.save_checkpoint`` / ``Module.save_checkpoint`` of either
  package load in the other (``load_checkpoint``, ``Module.load``,
  ``load_params``), parameters bit for bit and the same graph.
* Resuming: ``fit`` for two epochs with ``module_checkpoint(...,
  save_optimizer_states=True)``, then ``Module.load(prefix, 1,
  load_optimizer_states=True)`` and ``fit(begin_epoch=1)``, gives the
  uninterrupted run's weights bit for bit in each package (Adam resumes
  its step count through ``begin_num_update``); the two packages' runs
  from the same start agree within 1e-5 of each tensor's largest
  magnitude (float32 sums in another order over 8 updates).  An
  optimizer-state file is a pickle of each package's own arrays, so it
  resumes in the package that wrote it.
"""
import logging

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx


def _arr(pkg, shape):
    if pkg is tmx:
        return tmx.nd.zeros(shape, ctx=tmx.cpu())
    return jmx.nd.zeros(shape)


# (initializer factory, [(name, shape)]): each name goes through the
# initializer's routes
INIT_CASES = {
    "uniform": (lambda m: m.init.Uniform(0.3),
                [("fc_weight", (6, 5)), ("fc_bias", (6,)),
                 ("odd_name", (3, 4))]),
    "normal": (lambda m: m.init.Normal(0.2),
               [("fc_weight", (7, 3)), ("bn_gamma", (4,)),
                ("bn_moving_var", (4,)), ("bn_moving_mean", (4,))]),
    "xavier": (lambda m: m.init.Xavier(),
               [("conv_weight", (8, 3, 3, 3)), ("fc_weight", (10, 8))]),
    "xavier-gaussian-in": (lambda m: m.init.Xavier(rnd_type="gaussian",
                                                   factor_type="in",
                                                   magnitude=2),
                           [("conv_weight", (4, 2, 5, 5))]),
    "msraprelu": (lambda m: m.init.MSRAPrelu(slope=0.1),
                  [("fc_weight", (9, 4)), ("fc2_weight", (3, 9))]),
    "orthogonal": (lambda m: m.init.Orthogonal(),
                   [("fc_weight", (6, 10)), ("fc2_weight", (10, 6))]),
    "orthogonal-normal": (lambda m: m.init.Orthogonal(scale=0.5,
                                                      rand_type="normal"),
                          [("conv_weight", (4, 3, 2, 2))]),
    "zero": (lambda m: m.init.Zero(), [("fc_weight", (3, 3))]),
    "one": (lambda m: m.init.One(), [("fc_weight", (3, 3)),
                                     ("x_beta", (2,))]),
    "constant": (lambda m: m.init.Constant(0.25), [("fc_weight", (2, 5))]),
    "bilinear": (lambda m: m.init.Bilinear(),
                 [("up_weight", (2, 1, 4, 4)), ("up2_weight", (1, 1, 3, 5))]),
    "lstmbias": (lambda m: m.init.LSTMBias(forget_bias=2.0),
                 [("lstm_bias", (16,)), ("lstm_weight", (8,))]),
    "mixed": (lambda m: m.init.Mixed([".*bias", ".*"],
                                     [m.init.Constant(0.5),
                                      m.init.Uniform(0.1)]),
              [("fc_bias", (4,)), ("fc_weight", (4, 3))]),
}


@pytest.mark.parametrize("case", list(INIT_CASES))
def test_initializers_bit_equal_jax(case):
    make, names = INIT_CASES[case]
    out = {}
    for pkg in (jmx, tmx):
        pkg.random.seed(42)
        init = make(pkg)
        vals = []
        for name, shape in names:
            arr = _arr(pkg, shape)
            init(pkg.init.InitDesc(name), arr)
            vals.append(arr.asnumpy())
        out[pkg.__name__] = vals
    for (name, _), a, b in zip(names, out["mxnet_tpu_torch"],
                               out["mxnet_tpu"]):
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg="%s %s" % (case, name))
    if case != "mixed":                  # Mixed is no Initializer
        assert make(tmx).dumps() == make(jmx).dumps()


def test_variable_init_attr_and_load_bit_equal_jax(tmp_path):
    """A Variable's ``init=`` trumps the global initializer through the
    symbol's ``__init__`` attr; ``Load`` replays a ``.params`` file and
    falls back to its default."""
    out = {}
    fname = str(tmp_path / "w.params")
    rs = np.random.RandomState(0)
    saved = rs.randn(5, 3).astype(np.float32)
    jmx.nd.save(fname, {"arg:fc_weight": jmx.nd.array(saved)})
    for pkg in (jmx, tmx):
        pkg.random.seed(3)
        w = pkg.sym.Variable("w", init=pkg.init.Orthogonal(scale=2.0))
        net = pkg.sym.FullyConnected(pkg.sym.Variable("data"), weight=w,
                                     num_hidden=4, name="fc")
        attrs = net.attr_dict()
        arr = _arr(pkg, (4, 6))
        pkg.init.Uniform(0.5)(pkg.init.InitDesc("w", attrs.get("w")), arr)
        load = pkg.init.Load(fname, default_init=pkg.init.Normal(0.3))
        a1, a2 = _arr(pkg, (5, 3)), _arr(pkg, (2, 2))
        load("fc_weight", a1)
        load("fc_bias", a2)
        out[pkg.__name__] = [arr.asnumpy(), a1.asnumpy(), a2.asnumpy()]
    for a, b in zip(out["mxnet_tpu_torch"], out["mxnet_tpu"]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(out["mxnet_tpu_torch"][1], saved)
    with pytest.raises(tmx.base.MXNetError):
        tmx.init.Load({"a": tmx.nd.zeros((2,), ctx=tmx.cpu())})(
            "b", tmx.nd.zeros((2,), ctx=tmx.cpu()))


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def _mlp(sym):
    data = sym.Variable("data")
    h = sym.Activation(sym.FullyConnected(data, num_hidden=16, name="fc1"),
                       act_type="relu", name="relu1")
    out = sym.FullyConnected(h, num_hidden=4, name="fc2")
    return sym.SoftmaxOutput(out, name="softmax")


def _data(n=64, seed=0):
    rs = np.random.RandomState(seed)
    X = rs.randn(n, 10).astype(np.float32)
    y = (X[:, :4].argmax(1)).astype(np.float32)
    return X, y


def _start(seed=1):
    rs = np.random.RandomState(seed)
    return {"fc1_weight": rs.randn(16, 10).astype(np.float32) * 0.3,
            "fc1_bias": np.zeros(16, np.float32),
            "fc2_weight": rs.randn(4, 16).astype(np.float32) * 0.3,
            "fc2_bias": np.zeros(4, np.float32)}


def _module(pkg, sym=None):
    net = sym if sym is not None else _mlp(pkg.sym)
    if pkg is tmx:
        return tmx.mod.Module(net, context=tmx.cpu())
    return jmx.mod.Module(net)


def _nd(pkg, host):
    return {k: (tmx.nd.array(v, ctx=tmx.cpu()) if pkg is tmx
                else jmx.nd.array(v)) for k, v in host.items()}


def _iter(pkg, X, y):
    return pkg.io.NDArrayIter(X, y, batch_size=16, shuffle=False,
                              label_name="softmax_label")


OPTS = {"sgd": ("sgd", {"learning_rate": 0.1, "momentum": 0.9,
                        "wd": 1e-4}),
        "adam": ("adam", {"learning_rate": 0.01, "wd": 1e-4})}


def _params(mod):
    args, auxs = mod.get_params()
    return {k: v.asnumpy() for k, v in args.items()}


def _fit_uninterrupted(pkg, opt, prefix):
    X, y = _data()
    mod = _module(pkg)
    name, kw = OPTS[opt]
    mod.fit(_iter(pkg, X, y), num_epoch=2, optimizer=name,
            optimizer_params=dict(kw), arg_params=_nd(pkg, _start()),
            kvstore="local", eval_metric="acc",
            epoch_end_callback=pkg.callback.module_checkpoint(
                mod, prefix, save_optimizer_states=True),
            batch_end_callback=pkg.callback.log_train_metric(2))
    return _params(mod)


def _fit_resumed(pkg, opt, prefix):
    X, y = _data()
    mod = pkg.mod.Module.load(prefix, 1, load_optimizer_states=True,
                              **({"context": tmx.cpu()} if pkg is tmx
                                 else {}))
    name, kw = OPTS[opt]
    kw = dict(kw)
    if name == "adam":          # the step count resumes with the states
        kw["begin_num_update"] = len(X) // 16
    mod.fit(_iter(pkg, X, y), begin_epoch=1, num_epoch=2, optimizer=name,
            optimizer_params=kw, kvstore="local", eval_metric="acc")
    return _params(mod)


@pytest.mark.parametrize("opt", list(OPTS))
def test_resumed_fit_equals_uninterrupted_in_both_packages(tmp_path, opt):
    got = {}
    for pkg in (jmx, tmx):
        prefix = str(tmp_path / pkg.__name__)
        whole = _fit_uninterrupted(pkg, opt, prefix)
        resumed = _fit_resumed(pkg, opt, prefix)
        for k in whole:
            np.testing.assert_array_equal(resumed[k], whole[k],
                                          err_msg="%s %s" % (pkg.__name__,
                                                             k))
        got[pkg.__name__] = whole
    for k, want in got["mxnet_tpu"].items():
        err = np.abs(got["mxnet_tpu_torch"][k] - want).max()
        assert err <= 1e-5 * np.abs(want).max(), (k, err)


def test_checkpoints_cross_packages(tmp_path):
    """A checkpoint written by either package loads in the other: the
    same graph (JSON) and parameters bit for bit, through
    ``load_checkpoint``, ``Module.load`` and ``load_params``."""
    X, y = _data()
    mods = {}
    for pkg in (jmx, tmx):
        mod = _module(pkg)
        mod.fit(_iter(pkg, X, y), num_epoch=1, optimizer="sgd",
                optimizer_params={"learning_rate": 0.1},
                arg_params=_nd(pkg, _start(2)), kvstore="local",
                epoch_end_callback=pkg.callback.do_checkpoint(
                    str(tmp_path / ("do-" + pkg.__name__))))
        mod.save_checkpoint(str(tmp_path / pkg.__name__), 3)
        mod.save_params(str(tmp_path / (pkg.__name__ + ".params")))
        mods[pkg] = mod
    for writer, reader in ((jmx, tmx), (tmx, jmx)):
        prefix = str(tmp_path / writer.__name__)
        want = _params(mods[writer])
        sym, args, auxs = reader.model.load_checkpoint(prefix, 3)
        assert sym.tojson() == mods[writer].symbol.tojson()
        assert sorted(args) == sorted(want) and not auxs
        for k, v in args.items():
            np.testing.assert_array_equal(v.asnumpy(), want[k])
        # the do_checkpoint hook's epoch-1 file
        _s, args1, _a = reader.model.load_checkpoint(
            str(tmp_path / ("do-" + writer.__name__)), 1)
        for k, v in args1.items():
            np.testing.assert_array_equal(v.asnumpy(), want[k])
        mod = reader.mod.Module.load(prefix, 3, **(
            {"context": tmx.cpu()} if reader is tmx else {}))
        mod.bind(data_shapes=[("data", (16, 10))],
                 label_shapes=[("softmax_label", (16,))])
        for k, v in _params(mod).items():
            np.testing.assert_array_equal(v, want[k])
        other = _module(reader)
        other.bind(data_shapes=[("data", (16, 10))],
                   label_shapes=[("softmax_label", (16,))])
        other.init_params()
        other.load_params(str(tmp_path / (writer.__name__ + ".params")))
        for k, v in _params(other).items():
            np.testing.assert_array_equal(v, want[k])


def test_batch_hooks_log_as_the_reference(caplog):
    """``log_train_metric``, ``ProgressBar`` and
    ``LogValidationMetricsCallback`` log the lines the JAX package's
    do."""
    lines = {}
    for pkg in (jmx, tmx):
        metric = pkg.metric.Accuracy()
        metric.sum_metric, metric.num_inst = 3.0, 4
        param = pkg.model.BatchEndParam(epoch=2, nbatch=4,
                                        eval_metric=metric, locals=None)
        caplog.clear()
        with caplog.at_level(logging.INFO):
            pkg.callback.log_train_metric(2, auto_reset=True)(param)
            pkg.callback.ProgressBar(8, length=10)(param)
            pkg.callback.LogValidationMetricsCallback()(param)
        lines[pkg.__name__] = [r.getMessage() for r in caplog.records]
        assert metric.num_inst == 0          # auto_reset
    assert lines["mxnet_tpu_torch"] == lines["mxnet_tpu"]
    assert len(lines["mxnet_tpu_torch"]) == 3
