"""The port's CustomOp (``mx.operator``: ``CustomOp``, ``CustomOpProp``,
``register``, the ``Custom`` op) against the JAX package's, on the CPU:
the cases of ``tests/test_custom_op.py``, run in both packages on the
same numpy inputs (the port inside ``with mx.cpu():``).

The same user op classes are registered in each package (under names of
their own, so that ``tests/test_custom_op.py``'s registrations stand).
Outputs and gradients agree within rtol 1e-5 / atol 1e-6 (f32 on both
sides; the user code runs in numpy in both); the ``Module`` case trains
the same start for 3 epochs in both packages and compares every weight
within 1e-5 (the same numpy softmax gradient, SGD in f32).
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

RTOL, ATOL = 1e-5, 1e-6


def _register(mx):
    op_mod = mx.operator

    @op_mod.register("t_pysoftmax")
    class PySoftmaxProp(op_mod.CustomOpProp):
        def __init__(self):
            super().__init__(need_top_grad=False)

        def list_arguments(self):
            return ["data", "label"]

        def list_outputs(self):
            return ["output"]

        def infer_shape(self, in_shape):
            return [in_shape[0], (in_shape[0][0],)], [in_shape[0]], []

        def create_operator(self, ctx, shapes, dtypes):
            return PySoftmax()

    class PySoftmax(op_mod.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            x = in_data[0].asnumpy()
            y = np.exp(x - x.max(axis=1, keepdims=True))
            y /= y.sum(axis=1, keepdims=True)
            self.assign(out_data[0], req[0], mx.nd.array(y))

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            lbl = in_data[1].asnumpy().ravel().astype(np.int64)
            y = out_data[0].asnumpy()
            y[np.arange(lbl.shape[0]), lbl] -= 1.0
            self.assign(in_grad[0], req[0], mx.nd.array(y))

    @op_mod.register("t_scalemul")
    class ScaleMulProp(op_mod.CustomOpProp):
        def __init__(self, scale="1.0"):
            super().__init__(need_top_grad=True)
            self.scale = float(scale)

        def create_operator(self, ctx, shapes, dtypes):
            s = self.scale

            class _Op(op_mod.CustomOp):
                def forward(self, is_train, req, in_data, out_data, aux):
                    self.assign(out_data[0], req[0], in_data[0] * s)

                def backward(self, req, out_grad, in_data, out_data,
                             in_grad, aux):
                    self.assign(in_grad[0], req[0], out_grad[0] * s)

            return _Op()

    @op_mod.register("t_intgather")
    class IntGatherProp(op_mod.CustomOpProp):
        def __init__(self):
            super().__init__(need_top_grad=True)

        def list_arguments(self):
            return ["data", "idx"]

        def infer_shape(self, in_shape):
            return in_shape, [(in_shape[1][0], in_shape[0][1])], []

        def create_operator(self, ctx, shapes, dtypes):
            class _Op(op_mod.CustomOp):
                def forward(self, is_train, req, in_data, out_data, aux):
                    x = in_data[0].asnumpy()
                    i = in_data[1].asnumpy().astype(np.int64)
                    self.assign(out_data[0], req[0], mx.nd.array(x[i]))

                def backward(self, req, out_grad, in_data, out_data,
                             in_grad, aux):
                    g = np.zeros(in_data[0].shape, np.float32)
                    i = in_data[1].asnumpy().astype(np.int64)
                    np.add.at(g, i, out_grad[0].asnumpy())
                    self.assign(in_grad[0], req[0], mx.nd.array(g))
                    self.assign(in_grad[1], req[1],
                                mx.nd.zeros(in_data[1].shape))

            return _Op()


_register(jmx)
_register(tmx)


def _both(scenario, rtol=RTOL, atol=ATOL):
    want = scenario(jmx)
    with tmx.cpu():
        got = scenario(tmx)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=rtol,
                                   atol=atol)
    return got


def _nd_forward(mx):
    rs = np.random.RandomState(0)
    x = mx.nd.array(rs.rand(4, 10).astype(np.float32))
    lbl = mx.nd.array(np.zeros(4, np.float32))
    return [mx.nd.Custom(x, lbl, op_type="t_pysoftmax").asnumpy()]


def _kwargs_and_grad(mx):
    x = mx.nd.array(np.arange(6, dtype=np.float32).reshape(2, 3))
    x.attach_grad()
    with mx.autograd.record():
        y = mx.nd.Custom(x, op_type="t_scalemul", scale=3.0)
        loss = (y * y).sum()
    loss.backward()
    return [y.asnumpy(), x.grad.asnumpy()]


def _integer_input_grad(mx):
    x = mx.nd.array(np.arange(12, dtype=np.float32).reshape(4, 3))
    idx = mx.nd.array(np.array([1, 3, 1], dtype=np.int64), dtype="int64")
    x.attach_grad()
    with mx.autograd.record():
        y = mx.nd.Custom(x, idx, op_type="t_intgather")
        loss = (y * mx.nd.array(np.arange(9, dtype=np.float32)
                               .reshape(3, 3))).sum()
    loss.backward()
    return [y.asnumpy(), x.grad.asnumpy()]


def _infer_shape(mx):
    net = mx.sym.Custom(mx.sym.Variable("data"), mx.sym.Variable("label"),
                        op_type="t_pysoftmax")
    arg_shapes, out_shapes, _ = net.infer_shape(data=(5, 7), label=(5,))
    return [np.array(out_shapes[0]), np.array(arg_shapes[1]),
            np.array(net.list_arguments() == ["data", "label"])]


def _bound_symbol(mx):
    sym = mx.sym.Custom(mx.sym.Variable("data"), op_type="t_scalemul",
                        scale="3.0")
    ex = sym.bind(mx.cpu(0), args={"data": mx.nd.ones((2, 2))})
    return [ex.forward()[0].asnumpy()]


CASES = {"nd_forward": _nd_forward, "kwargs_and_grad": _kwargs_and_grad,
         "integer_input_grad": _integer_input_grad,
         "infer_shape": _infer_shape, "bound_symbol": _bound_symbol}


@pytest.mark.parametrize("name", sorted(CASES))
def test_custom_op_matches_jax(name):
    _both(CASES[name])


def _module(mx):
    rs = np.random.RandomState(0)
    X = rs.rand(64, 8).astype(np.float32)
    y = (X @ rs.rand(8, 3).astype(np.float32)).argmax(axis=1) \
        .astype(np.float32)
    w0 = (rs.rand(3, 8).astype(np.float32) - 0.5)
    data = mx.sym.Variable("data")
    label = mx.sym.Variable("softmax_label")
    fc = mx.sym.FullyConnected(data, num_hidden=3, name="fc")
    net = mx.sym.MakeLoss(mx.sym.Custom(fc, label, op_type="t_pysoftmax",
                                        name="pysm"), name="out")
    mod = mx.mod.Module(net, data_names=["data"],
                        label_names=["softmax_label"], context=mx.cpu())
    it = mx.io.NDArrayIter(X, y, batch_size=16, label_name="softmax_label")
    mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    mod.init_params(arg_params={"fc_weight": mx.nd.array(w0),
                                "fc_bias": mx.nd.zeros((3,))})
    mod.init_optimizer(optimizer="sgd",
                       optimizer_params={"learning_rate": 0.5})
    errs = []
    for _ in range(3):
        it.reset()
        for batch in it:
            mod.forward(batch, is_train=True)
            probs = mod.get_outputs()[0].asnumpy()
            errs.append((probs.argmax(1) != batch.label[0].asnumpy())
                        .mean())
            mod.backward()
            mod.update()
    args, _ = mod.get_params()
    return [args["fc_weight"].asnumpy(), args["fc_bias"].asnumpy(),
            np.array(errs)]


def test_custom_op_trains_inside_a_module_as_in_jax():
    got = _both(_module, rtol=1e-5, atol=1e-5)
    assert got[2][-1] < got[2][0]


def test_unregistered_custom_op_raises():
    with tmx.cpu():
        x = tmx.nd.array(np.ones((2, 2), np.float32))
        with pytest.raises(tmx.MXNetError):
            tmx.nd.Custom(x, op_type="no_such_op")
    assert "t_pysoftmax" in tmx.operator.get_all_registered_operators()
