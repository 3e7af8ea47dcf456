"""The port's Module path against the JAX package's, on the CPU:
``NDArrayIter``, the ``Accuracy`` / ``Perplexity`` / ``CrossEntropy``
metrics, and ``Module.fit`` (mxnet_tpu_torch/{io,metric,module,model}
vs mxnet_tpu/{io,metric,module,model}).

* The MLP of tests/test_module.py trained one epoch with kvstore None,
  "local" (one device: no store) and a ``KVStore`` object (the store
  runs the optimizer), from the same start (``convert.
  module_params_from_numpy`` of the JAX module's initial parameters):
  every weight within 1e-5 of its tensor's largest magnitude.
* A 2-layer LM (hidden 32, T 16) trained three steps by ``Module.fit``
  through a ``KVStore("device")`` with two-bit compression.  Gradients
  of the two packages differ by about an ulp, so an element whose
  ``g + r`` lies within that of ``+-t`` may quantize to ``t`` in one and
  to 0 in the other.  Every push is recorded on both sides and
  compared: ``q + new_residual`` (which is ``g + r`` on either side)
  within 1e-5 of its magnitude or of ``t``, whichever is larger (a key
  with no gradient, such as a key bias, pushes rounding noise), and
  ``q`` exactly except at such near-threshold elements, which are
  counted and printed.  The weights
  are held within 1e-5 of their magnitude except where ``q`` differed.

Metric values: 1e-6 relative (f32 predictions, sums in another order).
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import kvstore as jkv
from mxnet_tpu.models.transformer import get_symbol as jax_get_symbol
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import convert
from mxnet_tpu_torch import kvstore as tkv
from mxnet_tpu_torch.base import NotPortedYet
from mxnet_tpu_torch.models.transformer import get_symbol

THRESHOLD = 0.5


def _close(port, ref, rel, floor=1e-30):
    """Max error within ``rel`` of the reference's largest magnitude (or
    of ``floor``, when that is larger)."""
    port, ref = np.asarray(port), np.asarray(ref)
    assert port.shape == ref.shape
    scale = max(float(np.abs(ref).max()), floor)
    err = float(np.abs(port - ref).max())
    assert err <= rel * scale, (err, scale)


# ---------------------------------------------------------------------------
# NDArrayIter and the metrics
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("handle,shuffle", [("pad", False), ("pad", True),
                                            ("discard", False),
                                            ("roll_over", False)])
def test_ndarray_iter_matches_jax(handle, shuffle):
    rs = np.random.RandomState(1)
    X = rs.normal(0, 1, (10, 3)).astype(np.float32)
    y = np.arange(10).astype(np.float32)
    kw = dict(batch_size=4, last_batch_handle=handle, shuffle=shuffle,
              seed=5 if shuffle else None)
    t_it = tmx.io.NDArrayIter(X, y, **kw)
    j_it = jmx.io.NDArrayIter(X, y, **kw)
    assert [tuple(d) for d in t_it.provide_data] == \
        [tuple(d) for d in j_it.provide_data]
    for epoch in range(3):
        t_b, j_b = list(t_it), list(j_it)
        assert len(t_b) == len(j_b)
        for a, b in zip(t_b, j_b):
            assert a.pad == b.pad
            assert a.data[0].context == tmx.cpu()      # host memory
            np.testing.assert_array_equal(a.data[0].asnumpy(),
                                          b.data[0].asnumpy())
            np.testing.assert_array_equal(a.label[0].asnumpy(),
                                          b.label[0].asnumpy())
        t_it.reset()
        j_it.reset()


def test_ndarray_iter_sharding_is_not_ported():
    """``num_parts`` sharding is ported (the name is the refusal's it
    replaces): each rank's batches equal the JAX package's, exactly."""
    X = np.arange(44, dtype=np.float32).reshape(22, 2)
    y = np.arange(22, dtype=np.float32)
    for part in range(2):
        kw = dict(batch_size=3, num_parts=2, part_index=part, shuffle=True,
                  seed=5, last_batch_handle="pad")
        t_b = list(tmx.io.NDArrayIter(X, y, **kw))
        j_b = list(jmx.io.NDArrayIter(X, y, **kw))
        assert len(t_b) == len(j_b) == 4
        for a, b in zip(t_b, j_b):
            assert a.pad == b.pad
            np.testing.assert_array_equal(a.data[0].asnumpy(),
                                          b.data[0].asnumpy())
            np.testing.assert_array_equal(a.label[0].asnumpy(),
                                          b.label[0].asnumpy())


def _metric_inputs(seed, n=12, vocab=7):
    rs = np.random.RandomState(seed)
    logits = rs.normal(0, 2, (n, vocab))
    probs = (np.exp(logits) / np.exp(logits).sum(1, keepdims=True)) \
        .astype(np.float32)
    labels = rs.randint(0, vocab, n).astype(np.float32)
    return probs, labels


@pytest.mark.parametrize("name,kwargs", [
    ("acc", {}), ("ce", {}), ("perplexity", {"ignore_label": None}),
    ("perplexity", {"ignore_label": 3})],
    ids=["accuracy", "cross-entropy", "perplexity", "perplexity-ignore"])
def test_metrics_match_jax(name, kwargs):
    tm = tmx.metric.create(name, **kwargs)
    jm = jmx.metric.create(name, **kwargs)
    for seed in range(3):
        probs, labels = _metric_inputs(seed)
        tm.update([tmx.nd.array(labels, ctx="cpu")],
                  [tmx.nd.array(probs, ctx="cpu")])
        jm.update([jmx.nd.array(labels)], [jmx.nd.array(probs)])
    (tn, tv), (jn, jv) = tm.get(), jm.get()
    assert tn == jn and tm.num_inst == jm.num_inst
    assert abs(tv - jv) <= 1e-6 * abs(jv)


def test_composite_metric_and_unported_names():
    m = tmx.metric.create(["acc", "ce"])
    probs, labels = _metric_inputs(0)
    m.update([tmx.nd.array(labels, ctx="cpu")],
             [tmx.nd.array(probs, ctx="cpu")])
    assert [n for n, _ in m.get_name_value()] == ["accuracy",
                                                  "cross-entropy"]
    # the names of the JAX package's other metrics are ported: F1 of a
    # binary problem against the reference
    rs = np.random.RandomState(4)
    probs = rs.uniform(0, 1, (12, 2)).astype(np.float32)
    labels = rs.randint(0, 2, 12).astype(np.float32)
    tm, jm = tmx.metric.create("f1"), jmx.metric.create("f1")
    tm.update([tmx.nd.array(labels, ctx="cpu")],
              [tmx.nd.array(probs, ctx="cpu")])
    jm.update([jmx.nd.array(labels)], [jmx.nd.array(probs)])
    assert tm.get() == jm.get()


# ---------------------------------------------------------------------------
# Module.fit: the MLP of tests/test_module.py
# ---------------------------------------------------------------------------

def _mlp(sym):
    net = sym.FullyConnected(sym.Variable("data"), num_hidden=32,
                             name="fc1")
    net = sym.Activation(net, act_type="relu")
    net = sym.FullyConnected(net, num_hidden=4, name="fc2")
    return sym.SoftmaxOutput(net, name="softmax")


def _toy_data(n=256, dim=16, nclass=4, seed=0):
    rs = np.random.RandomState(seed)
    labels = rs.randint(0, nclass, n)
    X = rs.rand(n, dim).astype(np.float32) * 0.1
    for i in range(n):
        X[i, labels[i] * (dim // nclass):(labels[i] + 1) * (dim // nclass)] \
            += 1
    return X, labels.astype(np.float32)


def _jax_start(net, shapes):
    """The JAX module's initial parameters, as host arrays."""
    mod = jmx.mod.Module(net, context=jmx.cpu())
    mod.bind(data_shapes=shapes[0], label_shapes=shapes[1])
    mod.init_params(initializer=jmx.init.Xavier())
    args, auxs = mod.get_params()
    return ({k: v.asnumpy() for k, v in args.items()},
            {k: v.asnumpy() for k, v in auxs.items()})


def _fit_both(t_net, j_net, X, y, batch, kv_t, kv_j, args, auxs,
              compression=None, **fit_kw):
    t_args, t_auxs = convert.module_params_from_numpy(args, auxs)
    t_mod = tmx.mod.Module(t_net, context=tmx.cpu(),
                           compression_params=compression)
    t_mod.fit(tmx.io.NDArrayIter(X, y, batch_size=batch), kvstore=kv_t,
              arg_params=t_args, aux_params=t_auxs, **fit_kw)
    j_mod = jmx.mod.Module(j_net, context=jmx.cpu(),
                           compression_params=compression)
    j_mod.fit(jmx.io.NDArrayIter(X, y, batch_size=batch), kvstore=kv_j,
              arg_params={k: jmx.nd.array(v) for k, v in args.items()},
              aux_params={k: jmx.nd.array(v) for k, v in auxs.items()},
              **fit_kw)
    return t_mod, j_mod


@pytest.mark.parametrize("kv", [None, "local", "object"])
def test_module_fit_mlp_matches_jax(kv):
    X, y = _toy_data()
    it = jmx.io.NDArrayIter(X, y, batch_size=32)
    args, auxs = _jax_start(_mlp(jmx.sym), (it.provide_data,
                                            it.provide_label))
    kv_t = tkv.create("device", device="cpu") if kv == "object" else kv
    kv_j = jkv.create("device") if kv == "object" else kv
    t_mod, j_mod = _fit_both(
        _mlp(tmx.sym), _mlp(jmx.sym), X, y, 32, kv_t, kv_j, args, auxs,
        optimizer="sgd", optimizer_params={"learning_rate": 0.5,
                                           "momentum": 0.9},
        num_epoch=1)
    assert (t_mod._kvstore is None) == (kv != "object")
    t_args, _ = t_mod.get_params()
    j_args, _ = j_mod.get_params()
    assert sorted(t_args) == sorted(j_args)
    for name in j_args:
        _close(t_args[name].asnumpy(), j_args[name].asnumpy(), 1e-5)
    t_acc = t_mod.score(tmx.io.NDArrayIter(X, y, batch_size=32), "acc")
    j_acc = j_mod.score(jmx.io.NDArrayIter(X, y, batch_size=32), "acc")
    assert t_acc[0][1] == j_acc[0][1]


# ---------------------------------------------------------------------------
# Module.fit: the LM through a compressing store
# ---------------------------------------------------------------------------

LM = dict(vocab_size=40, seq_len=16, num_layers=2, hidden=32, heads=2,
          flash_min_seq=10000)


def _record_pushes(monkeypatch, cls, to_np, many=False):
    """Wrap ``cls.compress`` to log (key, g, r before, q, r after), or
    with ``many`` ``cls.compress_many`` (the port's store compresses all
    the keys of a push in one call) to log the same tuple per key, in
    key order."""
    log = []

    def before(self, key, grad):
        r = self.residual.get(key)
        return np.zeros(grad.shape, np.float32) if r is None \
            else to_np(r).copy()

    def after(self, key, grad, r0, q):
        log.append((key, to_np(grad).copy(), r0, to_np(q).copy(),
                    to_np(self.residual[key]).copy()))

    if many:
        orig_many = cls.compress_many

        def compress_many(self, keys, grads):
            r0 = [before(self, k, g) for k, g in zip(keys, grads)]
            qs = orig_many(self, keys, grads)
            for k, g, r, q in zip(keys, grads, r0, qs):
                after(self, k, g, r, q)
            return qs

        monkeypatch.setattr(cls, "compress_many", compress_many)
        return log
    orig = cls.compress

    def compress(self, key, grad):
        r0 = before(self, key, grad)
        q = orig(self, key, grad)
        after(self, key, grad, r0, q)
        return q

    monkeypatch.setattr(cls, "compress", compress)
    return log


def test_module_fit_lm_two_bit_matches_jax(monkeypatch, capsys):
    rs = np.random.RandomState(4)
    B, T, V = 4, LM["seq_len"], LM["vocab_size"]
    X = rs.randint(0, V, (3 * B, T)).astype(np.float32)
    Y = rs.randint(0, V, (3 * B, T)).astype(np.float32)
    it = jmx.io.NDArrayIter(X, Y, batch_size=B)
    j_net = jax_get_symbol(**LM)
    args, auxs = _jax_start(j_net, (it.provide_data, it.provide_label))
    t_log = _record_pushes(monkeypatch, tkv._TwoBitCompressor,
                           lambda a: a.detach().numpy(), many=True)
    j_log = _record_pushes(monkeypatch, jkv._TwoBitCompressor, np.asarray)
    kv_t = tkv.create("device", device="cpu")
    lr, momentum = 0.1, 0.9
    fit_kw = dict(optimizer="sgd",
                  optimizer_params={"learning_rate": lr,
                                    "momentum": momentum},
                  num_epoch=1, compression={"type": "2bit",
                                            "threshold": THRESHOLD})
    t_mod, j_mod = _fit_both(get_symbol(**LM), j_net, X, Y, B, kv_t,
                             jkv.create("device"), args, auxs,
                             eval_metric="perplexity", **fit_kw)
    n_keys = len(args)
    assert len(t_log) == len(j_log) == 3 * n_keys
    near_total = flipped_total = 0
    flipped = {}
    for (tk, tg, tr, tq, tnr), (jk, jg, jr, jq, jnr) in zip(t_log, j_log):
        assert tk == jk
        # = g + r on either side; a key whose gradient is zero (the key
        # biases: the softmax ignores a per-row shift) pushes rounding
        # noise, so the scale is at least the quantization step t
        _close(tq + tnr, jq + jnr, 1e-5, floor=THRESHOLD)
        comp = jg + jr
        tol = 1e-5 * max(float(np.abs(comp).max()), THRESHOLD)
        near = np.abs(np.abs(comp) - np.float32(THRESHOLD)) <= tol
        differ = tq != jq
        assert not (differ & ~near).any(), tk
        near_total += int(near.sum())
        flipped_total += int(differ.sum())
        flipped[tk] = flipped.get(tk, np.zeros(tq.shape, bool)) | differ
        assert set(np.unique(tq)) <= {-THRESHOLD, 0.0, THRESHOLD}
    fired = sum(int((e[3] != 0).sum()) for e in t_log)
    with capsys.disabled():
        print("\nLM Module.fit, 3 steps x %d keys: %d quantized values "
              "fired, %d elements within the tolerance of +-t, %d of them "
              "quantized differently" % (n_keys, fired, near_total,
                                         flipped_total))
    assert fired > 0
    # weights: 1e-5 of the tensor's magnitude, except where q differed;
    # there by at most that step's update of the flipped value
    bound = lr * (1.0 / B) * 2 * THRESHOLD * 3 / (1 - momentum)
    t_args, _ = t_mod.get_params()
    j_args, _ = j_mod.get_params()
    for name, jv in j_args.items():
        tv, jv = t_args[name].asnumpy(), jv.asnumpy()
        mask = flipped.get(name, np.zeros(jv.shape, bool))
        _close(np.where(mask, jv, tv), jv, 1e-5)
        assert (np.abs(tv - jv)[mask] <= bound).all()
    state = convert.kvstore_state_to_numpy(kv_t)
    assert sorted(state["residual"]) == sorted(args)
    for name, r in state["residual"].items():
        jr_ = np.asarray(j_mod._kvstore._compressor.residual[name])
        mask = flipped.get(name)
        _close(np.where(mask, jr_, r), jr_, 1e-5, floor=THRESHOLD)


def test_module_fit_lm_perplexity_matches_jax():
    """The Perplexity metric of three LM steps (no compression), as the
    fit loop reports it batch by batch."""
    rs = np.random.RandomState(9)
    B, T, V = 4, LM["seq_len"], LM["vocab_size"]
    X = rs.randint(0, V, (3 * B, T)).astype(np.float32)
    Y = rs.randint(0, V, (3 * B, T)).astype(np.float32)
    it = jmx.io.NDArrayIter(X, Y, batch_size=B)
    j_net = jax_get_symbol(**LM)
    args, auxs = _jax_start(j_net, (it.provide_data, it.provide_label))
    seen = {"port": [], "jax": []}
    for side, pkg, net in (("port", tmx, get_symbol(**LM)),
                           ("jax", jmx, j_net)):
        if side == "port":
            a, x = convert.module_params_from_numpy(args, auxs)
        else:
            a = {k: jmx.nd.array(v) for k, v in args.items()}
            x = {k: jmx.nd.array(v) for k, v in auxs.items()}
        mod = pkg.mod.Module(net, context=pkg.cpu())
        mod.fit(pkg.io.NDArrayIter(X, Y, batch_size=B), kvstore=None,
                optimizer="sgd", optimizer_params={"learning_rate": 0.1},
                eval_metric=pkg.metric.Perplexity(ignore_label=None),
                arg_params=a, aux_params=x, num_epoch=1,
                batch_end_callback=lambda p, s=side: seen[s].append(
                    p.eval_metric.get()[1]))
    assert len(seen["port"]) == 3
    for a, b in zip(seen["port"], seen["jax"]):
        assert abs(a - b) <= 1e-5 * b


def _remat_env_parity(var, value):
    """Under ``var=value`` both packages resolve the same remat policy,
    and one forward and backward of the MLP gives the same gradients
    (1e-5 of each tensor's largest magnitude)."""
    from mxnet_tpu import executor as jexec
    from mxnet_tpu_torch import executor as texec
    assert texec.backward_mirror_policy() == jexec.backward_mirror_policy()
    assert texec.backward_mirror_policy() == "dots"
    X, y = _toy_data(8)
    grads = {}
    for pkg in (tmx, jmx):
        ex = _mlp(pkg.sym).simple_bind(pkg.cpu(), data=(8, 16))
        rs = np.random.RandomState(2)
        kw = {"ctx": "cpu"} if pkg is tmx else {}
        for name, arr in ex.arg_dict.items():
            val = X if name == "data" else y if name == "softmax_label" \
                else rs.normal(0, 0.1, arr.shape).astype(np.float32)
            arr[:] = pkg.nd.array(val, **kw)
        ex.forward(is_train=True)
        ex.backward()
        grads[pkg] = {n: g.asnumpy() for n, g in ex.grad_dict.items()
                      if g is not None}
    for n, want in grads[jmx].items():
        assert np.abs(grads[tmx][n] - want).max() <= \
            1e-5 * np.abs(want).max(), n


@pytest.mark.parametrize("var,value,where", [
    ("MXNET_TPU_WATCHDOG_STEP_TIMEOUT", "30", "fit"),
    ("MXNET_TPU_CHAOS", "hang@2", "fit"),
    ("MXNET_TPU_PREFLIGHT", "1", "bind"),
    ("MXNET_TPU_ATTRIBUTION", "1", "bind"),
    ("MXNET_TPU_REMAT_POLICY", "dots", "bind"),
    ("MXNET_BACKWARD_DO_MIRROR", "false", "bind"),
    ("MXNET_TPU_ATTRIBUTION", "no", "bind"),
    ("MXNET_TPU_WATCHDOG", "1", "fit"),
])
def test_armed_env_features_of_the_jax_module_raise(monkeypatch, var, value,
                                                     where):
    from mxnet_tpu_torch.resilience import chaos
    X, y = _toy_data(64)
    mod = tmx.mod.Module(_mlp(tmx.sym), context=tmx.cpu())
    monkeypatch.setenv(var, value)
    chaos.reset()
    if var in ("MXNET_TPU_REMAT_POLICY", "MXNET_BACKWARD_DO_MIRROR"):
        # remat is ported: these rows now hold the policy and a bound
        # Module's gradients under it to the JAX package's
        _remat_env_parity(var, value)
        monkeypatch.delenv(var)
        return
    try:
        with pytest.raises(NotPortedYet):
            if where == "bind":
                mod.bind(data_shapes=[("data", (8, 16))],
                         label_shapes=[("softmax_label", (8,))])
            else:
                mod.fit(tmx.io.NDArrayIter(X, y, batch_size=32),
                        num_epoch=1)
    finally:
        monkeypatch.delenv(var)
        chaos.reset()


@pytest.mark.parametrize("value", ["", "0", "1", "false", "FALSE", "off",
                                   "no", "disabled", "none", " 0", "dots",
                                   "/tmp/cache"])
def test_armed_env_reads_each_knob_as_the_jax_package_does(monkeypatch,
                                                          value):
    """A knob is refused exactly when the JAX package would act on it
    (remat policies aside: an unknown name warns there and is refused
    here)."""
    from mxnet_tpu import executor as jexec
    from mxnet_tpu.analysis import preflight
    from mxnet_tpu.compile import cache
    from mxnet_tpu.resilience import watchdog
    from mxnet_tpu.telemetry import perf
    from mxnet_tpu_torch.base import armed_env
    from mxnet_tpu_torch.module.base_module import _watchdog_knobs
    jax_on = {
        "MXNET_BACKWARD_DO_MIRROR": lambda: (
            jexec.backward_mirror_policy() != "none"),
        "MXNET_TPU_PREFLIGHT": preflight.enabled,
        "MXNET_TPU_ATTRIBUTION": perf.enabled,
        "MXNET_TPU_COMPILE_CACHE": cache.enabled,
    }
    for var, on in jax_on.items():
        monkeypatch.setenv(var, value)
        assert bool(armed_env((var,))) == on(), (var, value)
        monkeypatch.delenv(var)
    monkeypatch.setenv("MXNET_TPU_REMAT_POLICY", value)
    assert bool(armed_env(("MXNET_TPU_REMAT_POLICY",))) == (
        value not in ("", "none"))
    monkeypatch.delenv("MXNET_TPU_REMAT_POLICY")
    for env in ({"MXNET_TPU_WATCHDOG": value},
                {"MXNET_TPU_WATCHDOG": value,
                 "MXNET_TPU_WATCHDOG_STEP_TIMEOUT": "30"},
                {"MXNET_TPU_WATCHDOG_COLLECTIVE_TIMEOUT": value}):
        for var, v in env.items():
            monkeypatch.setenv(var, v)
        watchdog.reset()
        try:
            assert bool(_watchdog_knobs()) == watchdog.enabled(), env
        finally:
            for var in env:
                monkeypatch.delenv(var)
            watchdog.reset()


def test_optimizer_states_round_trip_through_the_module(tmp_path):
    """``save_optimizer_states`` / ``load_optimizer_states`` of the local
    updater and of a store's."""
    import pickle
    X, y = _toy_data(64)
    for kv in (None, tkv.create("device", device="cpu")):
        mod = tmx.mod.Module(_mlp(tmx.sym), context=tmx.cpu())
        torch.manual_seed(0)
        mod.fit(tmx.io.NDArrayIter(X, y, batch_size=32), kvstore=kv,
                optimizer_params={"learning_rate": 0.1, "momentum": 0.9},
                num_epoch=1)
        up = kv._updater if kv else mod._updater
        fname = str(tmp_path / "states")
        mod.save_optimizer_states(fname)
        before = pickle.loads(up.get_states())
        up.states = {}
        mod.load_optimizer_states(fname)
        after = pickle.loads(up.get_states())
        assert sorted(before) == sorted(after) and before
        for k in before:
            np.testing.assert_array_equal(after[k], before[k])


def test_module_reshape_keeps_the_trained_parameters():
    """A batch of another size rebinds the inputs and keeps the bound
    parameter arrays (the reference's reshape)."""
    X, y = _toy_data(64)
    mod = tmx.mod.Module(_mlp(tmx.sym), context=tmx.cpu())
    torch.manual_seed(0)
    mod.fit(tmx.io.NDArrayIter(X, y, batch_size=32), num_epoch=1,
            optimizer_params={"learning_rate": 0.5})
    w = mod._exec_group.execs[0].arg_dict["fc1_weight"]
    full = mod.predict(tmx.io.NDArrayIter(X, y, batch_size=32)).asnumpy()
    part = tmx.io.DataBatch([tmx.nd.array(X[:5], ctx="cpu")],
                            [tmx.nd.array(y[:5], ctx="cpu")])
    mod.forward(part, is_train=False)
    assert mod.get_outputs()[0].shape == (5, 4)
    assert mod._exec_group.execs[0].arg_dict["fc1_weight"] is w
    np.testing.assert_allclose(mod.get_outputs()[0].asnumpy(), full[:5],
                               rtol=1e-6, atol=1e-7)


def test_module_without_a_context_needs_the_card_and_refuses_more():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    from mxnet_tpu_torch.base import DeviceUnavailable
    net = _mlp(tmx.sym)
    with pytest.raises(DeviceUnavailable):
        tmx.mod.Module(net)
    # several contexts are ported (tests/test_torch_parallel_mesh.py),
    # and so is group2ctxs (tests/test_torch_placement.py): a group no
    # node belongs to leaves the graph unsegmented
    assert tmx.mod.Module(net, context=[tmx.cpu(0), tmx.cpu(1)])
    mod = tmx.mod.Module(net, context=tmx.cpu(), group2ctxs={
        "dev1": tmx.cpu()})
    mod.bind([("data", (4, 10))], [("softmax_label", (4,))])
    assert mod._exec_group.execs[0]._seg is None


@pytest.mark.parametrize("devtype", ["tpu", "cpu_pinned", "cpu_shared", 6])
def test_context_refuses_device_types_the_port_has_no_device_for(devtype):
    """'tpu' (id 6) names no device of the port.  The host types
    'cpu_pinned' and 'cpu_shared' are accepted since C18 was repaired:
    they name the host, with the JAX package's type ids."""
    from mxnet_tpu_torch.context import Context
    assert Context("gpu", 1) == tmx.gpu(1) and Context(1) == tmx.cpu()
    if devtype in ("cpu_pinned", "cpu_shared"):
        ctx = Context(devtype)
        assert ctx.device_typeid == jmx.Context(devtype).device_typeid
        assert ctx.torch_device == torch.device("cpu")
        return
    with pytest.raises(ValueError):
        Context(devtype)
