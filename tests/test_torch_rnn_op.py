"""The fused ``RNN`` op of the port (``mxnet_tpu_torch/ops/rnn.py``)
against the JAX package's (``mxnet_tpu/ops/rnn.py``), on the CPU.

* Every mode (``lstm``, ``gru``, ``rnn_tanh``, ``rnn_relu``), one and two
  layers, one and two directions, with and without ``state_outputs``, in
  float32 and float64: the outputs through ``mx.nd.RNN``, and the
  gradients of every input (data, the packed blob, the states) for one
  numpy cotangent per output, torch autograd against ``jax.vjp``.
  Tolerances: float64 1e-10 absolute; float32 rtol 1e-5, atol 1e-5 (the
  packages sum in other orders).  float16 and bfloat16 forwards within
  2e-2 and 6e-2 of the largest magnitude: both packages round op by op
  in the dtype, in other places.
* The registry entry: inputs, outputs, params, ``needs_rng`` and
  ``mode_dependent`` as the JAX op's.
* The ``simple_bind`` shape hook: the blob and the states from the data's
  shape, as the JAX package infers them.
* ``lstm_state_clip_min`` / ``_max`` are accepted and ignored, in both
  packages.
* The cuDNN path's arguments (the blob's views in torch's per-layer order
  ``[w_ih, w_hh, b_ih, b_hh]``, the states, the directions) run through
  ``torch._VF`` on the CPU, ATen's kernels with cuDNN's gate conventions,
  and agree with the plain loop within 1e-12 in float64.
* Dropout, on the port alone (its draws are torch's): between the layers
  only, never after the last, in training only, ``mask / keep`` with the
  keep share within 5 standard deviations of its binomial mean, the same
  mask after the same ``mx.random.seed`` and another one after another.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu.ops.registry import get_op as jax_get_op
from mxnet_tpu.ops.rnn import rnn_param_size as jax_param_size
from mxnet_tpu_torch.ops import rnn as trnn
from mxnet_tpu_torch.ops.registry import get_op

MODES = ("lstm", "gru", "rnn_tanh", "rnn_relu")
T, N, C, H = 5, 3, 4, 6
TOL = {"float64": (0.0, 1e-10), "float32": (1e-5, 1e-5)}


def _inputs(mode, layers, bidir, dtype, seed=0):
    rs = np.random.RandomState(seed)
    d = 2 if bidir else 1
    n = jax_param_size(layers, C, H, bidir, mode)
    arrs = [rs.randn(T, N, C), rs.randn(n) * 0.3, rs.randn(layers * d, N, H)]
    if mode == "lstm":
        arrs.append(rs.randn(layers * d, N, H))
    return [a.astype(dtype) for a in arrs]


def _attrs(mode, layers, bidir, state_outputs, **kw):
    return dict(state_size=H, num_layers=layers, bidirectional=bidir,
                mode=mode, state_outputs=state_outputs, **kw)


def _jax_run(kw, arrs, cots):
    op = jax_get_op("RNN")
    attrs = op.parse_attrs(kw)
    key = jax.random.PRNGKey(0)

    def f(*xs):
        out = op.fn(attrs, key, *xs)
        return out if isinstance(out, tuple) else (out,)

    outs, vjp = jax.vjp(f, *[jnp.asarray(a) for a in arrs])
    grads = vjp(tuple(jnp.asarray(c) for c in cots))
    return [np.asarray(o) for o in outs], [np.asarray(g) for g in grads]


def _port_run(kw, arrs, cots):
    leaves = [torch.from_numpy(a.copy()).requires_grad_() for a in arrs]
    op = get_op("RNN")
    out = op.fn(op.parse_attrs(kw), torch.Generator().manual_seed(0),
                *leaves)
    outs = out if isinstance(out, tuple) else (out,)
    torch.autograd.backward(outs, [torch.from_numpy(c) for c in cots])
    return ([o.detach().numpy() for o in outs],
            [x.grad.numpy() for x in leaves])


def _close(got, want, dtype, what):
    rtol, atol = TOL[dtype]
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                               err_msg=what)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("state_outputs", [False, True],
                         ids=["out", "states"])
@pytest.mark.parametrize("bidir", [False, True], ids=["uni", "bi"])
@pytest.mark.parametrize("layers", [1, 2])
@pytest.mark.parametrize("mode", MODES)
def test_rnn_op_matches_jax(mode, layers, bidir, state_outputs, dtype):
    arrs = _inputs(mode, layers, bidir, dtype)
    kw = _attrs(mode, layers, bidir, state_outputs)
    with tmx.cpu():
        t_nd = tmx.nd.RNN(*[tmx.nd.array(a, dtype=dtype) for a in arrs],
                          **kw)
    t_nd = t_nd if isinstance(t_nd, list) else [t_nd]
    assert len(t_nd) == ((3 if mode == "lstm" else 2) if state_outputs
                         else 1)
    rs = np.random.RandomState(1)
    cots = [rs.randn(*o.shape).astype(dtype) for o in t_nd]
    j_out, j_grads = _jax_run(kw, arrs, cots)
    for i, (a, b) in enumerate(zip(t_nd, j_out)):
        _close(a.asnumpy(), b, dtype, "nd output %d" % i)
    t_out, t_grads = _port_run(kw, arrs, cots)
    for i, (a, b) in enumerate(zip(t_out, j_out)):
        _close(a, b, dtype, "output %d" % i)
    for name, a, b in zip(("data", "parameters", "state", "state_cell"),
                          t_grads, j_grads):
        _close(a, b, dtype, "d" + name)


@pytest.mark.parametrize("dtype,tol", [("float16", 2e-2),
                                       ("bfloat16", 6e-2)])
def test_rnn_op_16_bit_forward_matches_jax(dtype, tol):
    arrs = _inputs("lstm", 2, True, np.float32, seed=3)
    kw = _attrs("lstm", 2, True, True)
    j_out = jmx.nd.RNN(*[jmx.nd.array(a, dtype=dtype) for a in arrs], **kw)
    with tmx.cpu():
        t_out = tmx.nd.RNN(*[tmx.nd.array(a, dtype=dtype) for a in arrs],
                           **kw)
    for a, b in zip(t_out, j_out):
        assert a._handle.dtype == getattr(torch, dtype)
        got = a.astype("float32").asnumpy()
        want = np.asarray(b.asnumpy(), np.float32)
        assert np.abs(got - want).max() <= tol * np.abs(want).max()


def test_rnn_registry_entry_matches_jax():
    op, jop = get_op("RNN"), jax_get_op("RNN")
    assert op.needs_rng and jop.needs_rng
    assert op.mode_dependent and jop.mode_dependent
    assert sorted(op.params) == sorted(jop.params)
    for name, spec in op.params.items():
        assert repr(spec.default) == repr(jop.params[name].default), name
        assert spec.required == jop.params[name].required, name
    for mode in MODES:
        for so in (False, True):
            kw = _attrs(mode, 1, False, so)
            a, ja = op.parse_attrs(kw), jop.parse_attrs(kw)
            assert op.list_inputs(a) == jop.list_inputs(ja)
            assert op.num_outputs(a) == jop.num_outputs(ja)
            assert op.num_visible_outputs(a) == jop.num_visible_outputs(ja)
    for L, in_sz, bi, mode in ((1, 4, False, "lstm"), (2, 7, True, "gru"),
                               (3, 5, True, "rnn_relu")):
        assert trnn.rnn_param_size(L, in_sz, 9, bi, mode) == \
            jax_param_size(L, in_sz, 9, bi, mode)


@pytest.mark.parametrize("mode,bidir", [("lstm", True), ("gru", False)])
def test_rnn_shape_hook_infers_the_blob_and_states(mode, bidir):
    def infer(pkg):
        data = pkg.sym.Variable("data")
        out = pkg.sym.RNN(data, state_size=H, num_layers=2,
                          bidirectional=bidir, mode=mode, name="rnn")
        args, outs, _ = out.infer_shape(data=(T, N, C))
        return dict(zip(out.list_arguments(), args)), outs

    t_args, t_outs = infer(tmx)
    j_args, j_outs = infer(jmx)
    assert t_args == j_args and t_outs == j_outs
    d = 2 if bidir else 1
    assert t_args["rnn_parameters"] == (
        trnn.rnn_param_size(2, C, H, bidir, mode),)
    assert t_args["rnn_state"] == (2 * d, N, H)
    assert t_outs == [(T, N, d * H)]
    with tmx.cpu():
        exe = tmx.sym.RNN(tmx.sym.Variable("data"), state_size=H,
                          num_layers=2, bidirectional=bidir, mode=mode,
                          name="rnn").simple_bind(tmx.cpu(),
                                                  data=(T, N, C))
    assert exe.arg_dict["rnn_parameters"].shape == \
        t_args["rnn_parameters"]


def test_rnn_clip_attributes_are_accepted_and_ignored():
    arrs = _inputs("lstm", 2, False, "float64", seed=5)
    plain = _attrs("lstm", 2, False, True)
    clip = _attrs("lstm", 2, False, True, lstm_state_clip_min=-0.01,
                  lstm_state_clip_max=0.01)
    for pkg in (jmx, tmx):
        with pkg.cpu():
            a = pkg.nd.RNN(*[pkg.nd.array(x, dtype="float64")
                             for x in arrs], **plain)
            b = pkg.nd.RNN(*[pkg.nd.array(x, dtype="float64")
                             for x in arrs], **clip)
        assert np.abs(b[2].asnumpy()).max() > 0.01   # cN is not clipped
        for u, v in zip(a, b):
            np.testing.assert_array_equal(u.asnumpy(), v.asnumpy())


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("layers,bidir", [(1, False), (2, True)])
def test_cudnn_call_layout_matches_the_plain_loop(mode, layers, bidir):
    arrs = [torch.from_numpy(a) for a in
            _inputs(mode, layers, bidir, "float64", seed=7)]
    weights = trnn._unpack(arrs[1], layers, C, H, bidir, mode)
    cell = arrs[3] if mode == "lstm" else None
    want = trnn.rnn_plain(mode, arrs[0], weights, arrs[2], cell)
    got = trnn._fused(mode, arrs[0], weights, arrs[2], cell, False)
    for a, b in zip(got, want):
        if b is not None:
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                       atol=1e-12)


def _dropout_probe(p, layers, train, seed):
    """An ``rnn_relu`` stack whose layers past the first pass their input
    through unchanged (Wx = I, Wh = 0, no bias): the last layer's output
    is the first layer's, times the masks between the layers."""
    hid = 64
    rs = np.random.RandomState(0)
    x = np.abs(rs.randn(4, 8, hid)) + 0.5
    blob = []
    for layer in range(layers):
        blob += [np.eye(hid).ravel(), np.zeros(hid * hid)]
    blob += [np.zeros(hid)] * (2 * layers)
    blob = np.concatenate(blob)
    state = np.zeros((layers, 8, hid))
    kw = dict(state_size=hid, num_layers=layers, mode="rnn_relu", p=p)
    tmx.random.seed(seed)
    with tmx.cpu():
        args = [tmx.nd.array(a, dtype="float64") for a in (x, blob, state)]
        with tmx.autograd.record(train_mode=train):
            out = tmx.nd.RNN(*args, **kw)
    return x, out.asnumpy()


def test_rnn_dropout_falls_between_layers_in_training_only():
    p = 0.3
    keep = 1.0 - p
    x, out = _dropout_probe(p, 3, True, seed=11)
    kept = out != 0
    # two masks (after layers 0 and 1), none after the last layer
    share = kept.mean()
    n = kept.size
    want = keep * keep
    assert abs(share - want) <= 5 * np.sqrt(want * (1 - want) / n), share
    np.testing.assert_allclose(out[kept], (x / keep / keep)[kept],
                               rtol=1e-12)
    _, again = _dropout_probe(p, 3, True, seed=11)
    np.testing.assert_array_equal(out, again)
    _, other = _dropout_probe(p, 3, True, seed=12)
    assert (other != out).any()
    for layers, train in ((3, False), (1, True)):
        _, out = _dropout_probe(p, layers, train, seed=11)
        np.testing.assert_allclose(out, x, rtol=1e-12)
