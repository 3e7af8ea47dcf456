"""The port's KVStore, Optimizer and Updater against the JAX package's
(mxnet_tpu_torch/{kvstore/__init__,optimizer}.py vs
mxnet_tpu/{kvstore/__init__,optimizer}.py), on the CPU.

Inputs are made with numpy from a seed and handed to both packages.
Tolerance: every value within 1e-6 of its tensor's largest magnitude.
Both compute in f32, but XLA:CPU fuses an update and may contract
``a*b + c`` into one FMA where PyTorch rounds twice (ROADMAP C), so the
two differ by about an ulp, not by nothing.  The two-bit residuals are
compared the same way; a quantized value lies in {-t, 0, t} and is
compared exactly.
"""
import numpy as np
import pytest

from mxnet_tpu import kvstore as jkv
from mxnet_tpu import optimizer as jopt
from mxnet_tpu.ndarray import ndarray as jnd
from mxnet_tpu_torch import convert
from mxnet_tpu_torch import kvstore as tkv
from mxnet_tpu_torch import optimizer as topt
from mxnet_tpu_torch.base import MXNetError, NotPortedYet
from mxnet_tpu_torch.ndarray import ndarray as tnd

SHAPES = {"w": (6, 5), 3: (7,), "bias": (4,)}


def _close(port, ref, rel=1e-6):
    port, ref = np.asarray(port), np.asarray(ref)
    assert port.shape == ref.shape
    scale = max(float(np.abs(ref).max()), 1e-30)
    err = float(np.abs(port - ref).max())
    assert err <= rel * scale, (err, scale)


def _pair(value):
    return (tnd.array(value, ctx="cpu"), jnd.array(value))


def _stores(compression, optimizer):
    stores = []
    for mod, opt, kw in ((tkv, topt, {"device": "cpu"}), (jkv, jopt, {})):
        kv = mod.create("device", **kw)
        if compression:
            kv.set_gradient_compression({"type": "2bit",
                                         "threshold": 0.5})
        if optimizer:
            kv.set_optimizer(opt.SGD(learning_rate=0.1, momentum=0.9,
                                     wd=0.01, rescale_grad=0.5))
        stores.append(kv)
    return stores


@pytest.mark.parametrize("optimizer", [True, False],
                         ids=["sgd-momentum", "no-updater"])
@pytest.mark.parametrize("compression", [False, True],
                         ids=["dense", "2bit"])
def test_push_pull_matches_jax(compression, optimizer):
    rs = np.random.RandomState(int(compression) * 2 + int(optimizer))
    tk, jk = _stores(compression, optimizer)
    init = {k: rs.normal(0, 1, s).astype(np.float32)
            for k, s in SHAPES.items()}
    held = {}
    for k, v in init.items():
        t, j = _pair(v)
        held[k] = t
        tk.init(k, t)
        jk.init(k, j)
    for step in range(4):
        for k, s in SHAPES.items():
            # a list push: two per-device gradients summed by the store
            gs = [rs.normal(0, 0.4, s).astype(np.float32) for _ in range(2)]
            tk.push(k, [tnd.array(g, ctx="cpu") for g in gs])
            jk.push(k, [jnd.array(g) for g in gs])
            t_out, j_out = _pair(np.zeros(s, np.float32))
            tk.pull(k, out=t_out)
            jk.pull(k, out=j_out)
            _close(t_out.asnumpy(), j_out.asnumpy())
    for k, v in init.items():               # the caller's arrays untouched
        np.testing.assert_array_equal(held[k].asnumpy(), v)
    state = convert.kvstore_state_to_numpy(tk)
    if compression:
        assert sorted(state["residual"]) == sorted(map(str, SHAPES))
        for k, r in state["residual"].items():
            _close(r, np.asarray(jk._compressor.residual[k]))
    else:
        assert state["residual"] == {}
    if optimizer:
        for k in SHAPES:
            key = k if isinstance(k, int) else str(k)
            _close(state["states"][key],
                   jk._updater.states[key].asnumpy())


@pytest.mark.parametrize("repeat", [False, True],
                         ids=["distinct-keys", "a-key-twice"])
@pytest.mark.parametrize("optimizer", [True, False],
                         ids=["sgd-momentum", "no-updater"])
def test_list_push_equals_per_key_pushes(optimizer, repeat):
    """A compressing push of a key list (one ``compress_many`` over all
    its keys) against the port pushing the same keys one at a time and
    against the JAX store pushing key by key: stored values and residuals
    bit-equal to the per-key port, within 1e-6 of the JAX store.  With a
    key twice in the list, its second value is compressed against the
    residual its first left, as two pushes in turn do."""
    rs = np.random.RandomState(10 + 2 * int(optimizer) + int(repeat))
    many, jk = _stores(True, optimizer)
    one, _ = _stores(True, optimizer)
    keys = list(SHAPES) + (["w"] if repeat else [])
    for k, s in SHAPES.items():
        v = rs.normal(0, 1, s).astype(np.float32)
        for kv in (many, one):
            kv.init(k, tnd.array(v, ctx="cpu"))
        jk.init(k, jnd.array(v))
    calls = []
    orig = tkv._TwoBitCompressor.compress_many

    def counted(self, ks, grads):
        calls.append(len(ks))
        return orig(self, ks, grads)

    tkv._TwoBitCompressor.compress_many = counted
    try:
        for step in range(3):
            gs = [rs.normal(0, 0.4, SHAPES[k]).astype(np.float32)
                  for k in keys]
            n = len(calls)
            many.push(keys, [tnd.array(g, ctx="cpu") for g in gs])
            assert calls[n:] == [len(keys)]        # one call for the list
            for k, g in zip(keys, gs):
                one.push(k, tnd.array(g, ctx="cpu"))
                jk.push(k, jnd.array(g))
    finally:
        tkv._TwoBitCompressor.compress_many = orig
    outs = {k: tnd.zeros(s, ctx="cpu") for k, s in SHAPES.items()}
    many.pull(list(outs), out=list(outs.values()))
    for k, s in SHAPES.items():
        o, j = tnd.zeros(s, ctx="cpu"), jnd.zeros(s)
        one.pull(k, out=o)
        jk.pull(k, out=j)
        np.testing.assert_array_equal(outs[k].asnumpy(), o.asnumpy())
        _close(outs[k].asnumpy(), j.asnumpy())
        key = str(k)
        np.testing.assert_array_equal(
            many._compressor.residual[key].numpy(),
            one._compressor.residual[key].numpy())
        _close(many._compressor.residual[key].numpy(),
               np.asarray(jk._compressor.residual[key]))


def test_compressed_push_sends_only_quantized_values():
    tk, _ = _stores(True, False)
    tk.init("g", tnd.zeros((5,), ctx="cpu"))
    grad = tnd.array(np.array([0.7, 0.2, -0.6, 0.49, -2.0], np.float32),
                     ctx="cpu")
    keep = grad.asnumpy()
    tk.push("g", grad)
    out = tnd.zeros((5,), ctx="cpu")
    tk.pull("g", out=out)
    np.testing.assert_array_equal(out.asnumpy(),
                                  [0.5, 0.0, -0.5, 0.0, -0.5])
    np.testing.assert_array_equal(grad.asnumpy(), keep)   # q never written
    np.testing.assert_allclose(tk._compressor.residual["g"].numpy(),
                               [0.2, 0.2, -0.1, 0.49, -1.5], atol=1e-7)


def test_store_refuses_what_is_not_ported(monkeypatch):
    # the dist stores are ported (tests/test_torch_dist.py); outside a
    # gang they are one-process stores, as the JAX package's
    for name in ("dist_sync", "dist_device_sync", "dist_async"):
        kv = tkv.create(name, device="cpu")
        assert (kv.type, kv.rank, kv.num_workers) == (name, 0, 1)
        assert kv.num_dead_node(0) == 0
    # dist_async's parameter-server lane is item 7's second half
    monkeypatch.setenv("MXNET_TPU_KV_DIR", "/nonexistent")
    with pytest.raises(NotPortedYet, match="item 7's second half"):
        tkv.create("dist_async", device="cpu")
    kv = tkv.create("local", device="cpu")
    # row_sparse_pull is ported (test_torch_sparse_storage.py); it needs
    # its out and row ids
    with pytest.raises(MXNetError):
        kv.row_sparse_pull("w", out=None, row_ids=None)
    with pytest.raises(Exception):
        kv.set_gradient_compression({"type": "1bit"})


@pytest.mark.parametrize("momentum,clip", [(0.9, None), (0.0, 0.3),
                                           (0.9, 0.3)],
                         ids=["momentum", "plain-clip", "momentum-clip"])
@pytest.mark.parametrize("batched", [False, True],
                         ids=["per-key", "update_batch"])
def test_updater_matches_jax(momentum, clip, batched):
    """Three steps of ``Updater.__call__`` (the sgd ops) or
    ``update_batch`` (the foreach chain) against the JAX Updater, with a
    weight (weight decay) and a bias (none)."""
    rs = np.random.RandomState(7)
    names = {0: "fc_weight", 1: "fc_bias"}
    shapes = [(8, 3), (8,)]
    ws = [rs.normal(0, 1, s).astype(np.float32) for s in shapes]
    kw = dict(learning_rate=0.2, momentum=momentum, wd=0.05,
              rescale_grad=0.25, clip_gradient=clip, param_idx2name=names)
    tu = topt.get_updater(topt.create("sgd", **kw))
    ju = jopt.get_updater(jopt.create("sgd", **kw))
    t_w = [tnd.array(w, ctx="cpu") for w in ws]
    j_w = [jnd.array(w) for w in ws]
    for step in range(3):
        gs = [rs.normal(0, 2, s).astype(np.float32) for s in shapes]
        t_tr = [(i, tnd.array(g, ctx="cpu"), w)
                for i, (g, w) in enumerate(zip(gs, t_w))]
        j_tr = [(i, jnd.array(g), w) for i, (g, w) in enumerate(zip(gs,
                                                                    j_w))]
        if batched:
            tu.update_batch(t_tr)
            ju.update_batch(j_tr)
        else:
            for (i, g, w), (_, jg, jw) in zip(t_tr, j_tr):
                tu(i, g, w)
                ju(i, jg, jw)
        for (_, g, _), src in zip(t_tr, gs):      # grads are only read
            np.testing.assert_array_equal(g.asnumpy(), src)
        for a, b in zip(t_w, j_w):
            _close(a.asnumpy(), b.asnumpy())
    if momentum:
        for i in range(2):
            _close(tu.states[i].asnumpy(), ju.states[i].asnumpy())
    assert tu.optimizer.num_update == ju.optimizer.num_update == 3
    assert tu.optimizer._get_wd(1) == 0.0        # a bias gets no decay


def test_updater_states_round_trip():
    opt = topt.SGD(learning_rate=0.1, momentum=0.9)
    up = topt.get_updater(opt)
    w = tnd.array(np.ones(4, np.float32), ctx="cpu")
    up(0, tnd.array(np.full(4, 2.0, np.float32), ctx="cpu"), w)
    blob = up.get_states()
    again = topt.get_updater(topt.SGD(learning_rate=0.1, momentum=0.9))
    again.set_states(blob)
    w2 = tnd.array(w.asnumpy(), ctx="cpu")
    up(0, tnd.array(np.ones(4, np.float32), ctx="cpu"), w)
    again(0, tnd.array(np.ones(4, np.float32), ctx="cpu"), w2)
    np.testing.assert_array_equal(w.asnumpy(), w2.asnumpy())


def test_optimizers_not_ported_raise():
    """Every optimizer of the JAX package is ported now: each name
    creates its class; an unknown name raises as in the reference."""
    for name in ("adam", "nag", "rmsprop", "ftml", "lbsgd", "test"):
        assert type(topt.create(name)).__name__.lower() == name
    with pytest.raises(ValueError):
        topt.create("no-such-optimizer")


def test_optimizer_op_attrs_parse_strings_like_values():
    """A Symbol hands the update ops their attrs as strings; they must
    update exactly as from Python floats, and ``lr`` is required."""
    rng = np.random.RandomState(5)
    w0, g, m0 = (rng.randn(6, 5).astype(np.float32) for _ in range(3))
    kw = dict(lr=0.1, wd=0.01, momentum=0.9, rescale_grad=0.5,
              clip_gradient=0.3)
    outs = []
    for attrs in (kw, {k: str(v) for k, v in kw.items()}):
        w, m = tnd.array(w0, ctx="cpu"), tnd.array(m0, ctx="cpu")
        tnd.invoke_with_arrays("sgd_mom_update",
                               [w, tnd.array(g, ctx="cpu"), m], attrs)
        outs.append((w.asnumpy(), m.asnumpy()))
    np.testing.assert_array_equal(outs[0][0], outs[1][0])
    np.testing.assert_array_equal(outs[0][1], outs[1][1])
    assert not np.array_equal(outs[0][0], w0)
    with pytest.raises(MXNetError):
        tnd.invoke_with_arrays("sgd_update",
                               [tnd.array(w0, ctx="cpu"),
                                tnd.array(g, ctx="cpu")], dict(wd=0.0))
