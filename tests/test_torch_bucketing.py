"""BucketingModule over length buckets against the JAX package's, on the
CPU (mxnet_tpu_torch/{rnn/io,module/bucketing_module} vs
mxnet_tpu/{rnn/io,module/bucketing_module}).

* ``encode_sentences`` and ``BucketSentenceIter``: the same ids, and the
  same batches in the same order for the same seed of ``random`` and
  ``np.random`` (the iterator shuffles with both), exactly.
* A tiny bucketed LM (2 layers, hidden 16; buckets 4, 8 and 16, the last
  on the flash path) through ``BucketingModule.fit`` for 2 epochs, from
  the same initializer draws: each parameter within 1e-5 of its largest
  magnitude in the reference.  The key biases get no gradient (the
  softmax over keys ignores a shift common to all keys), so both
  packages move them by rounding noise only: they are held to 1e-5 of
  the key weight's largest magnitude instead.
* Every bucket binds over the default bucket's parameter, gradient and
  aux tensors (one storage), and ``borrow_optimizer`` gives every bucket
  the anchor's optimizer, store and updater: one momentum state per
  parameter, whichever bucket updated it.
"""
import random

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu.models import transformer as jtr
from mxnet_tpu_torch.base import DeviceUnavailable, NotPortedYet
from mxnet_tpu_torch.models import transformer as ttr

VOCAB, HIDDEN, HEADS, LAYERS = 40, 16, 2, 2
BUCKETS = [4, 8, 16]


def sym_gen_for(pkg, block, flash_min_seq=16):
    """A user's sym_gen: the LM of ``models.transformer.get_symbol`` with
    its positions declared at 1024 and sliced to the bucket's length."""
    sym = pkg.sym

    def sym_gen(T):
        data = sym.Variable("data")
        label = sym.Variable("softmax_label")
        pos = sym.Variable("pos_embed", shape=(1024, HIDDEN))
        tok = sym.Embedding(data, input_dim=VOCAB, output_dim=HIDDEN,
                            name="tok_embed")
        x = sym.broadcast_add(tok, sym.expand_dims(
            sym.slice_axis(pos, axis=0, begin=0, end=T), axis=0))
        for i in range(LAYERS):
            x = block(x, HIDDEN, HEADS, T, i, flash_min_seq=flash_min_seq)
        x = sym.LayerNorm(x, name="ln_f")
        logits = sym.FullyConnected(x, num_hidden=VOCAB, flatten=False,
                                    name="head")
        logits = sym.Reshape(logits, shape=(-1, VOCAB))
        out = sym.SoftmaxOutput(logits, sym.Reshape(label, shape=(-1,)),
                                name="softmax")
        return out, ("data",), ("softmax_label",)
    return sym_gen


def sentences(seed, per_bucket=4):
    rs = np.random.RandomState(seed)
    out = []
    for lo, hi in zip([1] + BUCKETS[:-1], BUCKETS):
        for _ in range(per_bucket):
            out.append(list(rs.randint(1, VOCAB, rs.randint(lo + 1,
                                                            hi + 1))))
    return out


def bucket_iter(pkg, sents, seed, batch=2):
    random.seed(seed)
    np.random.seed(seed)
    return pkg.rnn.BucketSentenceIter(sents, batch, buckets=BUCKETS,
                                      invalid_label=0)


def test_encode_sentences_matches_jax():
    words = [["a", "b", "c"], ["b", "d"], ["e", "a", "a", "f"]]
    for kw in ({}, {"invalid_label": 0, "start_label": 1},
               {"invalid_label": 1, "start_label": 1}):
        assert tmx.rnn.encode_sentences(words, **kw) == \
            jmx.rnn.encode_sentences(words, **kw)
    vocab = {"a": 1, "b": 2, "<unk>": 3}
    t = tmx.rnn.encode_sentences(words, vocab=dict(vocab),
                                 unknown_token="<unk>")
    j = jmx.rnn.encode_sentences(words, vocab=dict(vocab),
                                 unknown_token="<unk>")
    assert t == j
    with pytest.raises(KeyError):
        tmx.rnn.encode_sentences(words, vocab={"a": 1})


@pytest.mark.parametrize("layout", ["NT", "TN"])
def test_bucket_sentence_iter_matches_jax(layout):
    sents = sentences(1, per_bucket=5)
    for epoch in range(2):
        if epoch == 0:
            random.seed(3)
            np.random.seed(3)
            t_it = tmx.rnn.BucketSentenceIter(sents, 2, buckets=BUCKETS,
                                              invalid_label=0, layout=layout)
            random.seed(3)
            np.random.seed(3)
            j_it = jmx.rnn.BucketSentenceIter(sents, 2, buckets=BUCKETS,
                                              invalid_label=0, layout=layout)
        else:
            state = (random.getstate(), np.random.get_state())
            t_it.reset()
            random.setstate(state[0])
            np.random.set_state(state[1])
            j_it.reset()
        assert t_it.default_bucket_key == j_it.default_bucket_key == 16
        assert t_it.provide_data == j_it.provide_data
        t_b, j_b = list(t_it), list(j_it)
        assert len(t_b) == len(j_b) == 6
        for a, b in zip(t_b, j_b):
            assert a.bucket_key == b.bucket_key and a.pad == b.pad == 0
            assert a.provide_data == b.provide_data
            assert a.provide_label == b.provide_label
            assert a.data[0].context == tmx.cpu()      # host memory
            np.testing.assert_array_equal(a.data[0].asnumpy(),
                                          b.data[0].asnumpy())
            np.testing.assert_array_equal(a.label[0].asnumpy(),
                                          b.label[0].asnumpy())


def _fit(pkg, tr, kvstore, seed=7, epochs=2):
    it = bucket_iter(pkg, sentences(seed), seed)
    ctx = pkg.cpu()
    mod = pkg.mod.BucketingModule(sym_gen_for(pkg, tr._block),
                                  default_bucket_key=it.default_bucket_key,
                                  context=ctx)
    pkg.random.seed(0)
    seen = []
    mod.fit(it, kvstore=kvstore, optimizer="sgd",
            optimizer_params={"learning_rate": 0.01, "momentum": 0.9},
            initializer=pkg.init.Xavier(),
            eval_metric=pkg.metric.Perplexity(ignore_label=0),
            num_epoch=epochs,
            batch_end_callback=lambda p: seen.append(
                (p.nbatch, mod._curr_bucket_key, p.eval_metric.get()[1])))
    return mod, {k: v.asnumpy() for k, v in mod.get_params()[0].items()}, \
        seen


def _close(got, want, what):
    for name, ref in want.items():
        base = want[name[:-4] + "weight"] if name.endswith("_k_bias") \
            else ref
        err = np.abs(got[name] - ref).max()
        assert err <= 1e-5 * np.abs(base).max(), (what, name, err)


@pytest.mark.parametrize("store", ["device", "local"])
def test_bucketed_lm_fit_matches_jax(store):
    t_kv = tmx.kv.create("device", device="cpu") if store == "device" \
        else "local"
    j_kv = jmx.kv.create("device") if store == "device" else "local"
    t_mod, t_params, t_seen = _fit(tmx, ttr, t_kv)
    j_mod, j_params, j_seen = _fit(jmx, jtr, j_kv)
    assert sorted(t_params) == sorted(j_params)
    assert sorted(t_mod._buckets) == sorted(j_mod._buckets) == BUCKETS
    assert [s[:2] for s in t_seen] == [s[:2] for s in j_seen]
    for (_, _, a), (_, _, b) in zip(t_seen, j_seen):
        assert abs(a - b) <= 1e-5 * b
    _close(t_params, j_params, store)
    # the epochs learn: the second epoch's perplexity is below the first's
    per_epoch = [s[2] for s in t_seen if s[0] == len(t_seen) // 2 - 1]
    assert per_epoch[1] < per_epoch[0]


def test_buckets_share_the_anchor_storage_and_optimizer():
    mod, _, _ = _fit(tmx, ttr, tmx.kv.create("device", device="cpu"),
                     epochs=1)
    anchor = mod._buckets[16]
    a_ex = anchor._exec_group.execs[0]
    assert len(mod._buckets) == 3
    for key, child in mod._buckets.items():
        ex = child._exec_group.execs[0]
        for name in child._exec_group.param_names:
            for table in ("arg_dict", "grad_dict"):
                mine = getattr(ex, table)[name]
                assert mine is getattr(a_ex, table)[name]
                assert mine._handle.data_ptr() == \
                    getattr(a_ex, table)[name]._handle.data_ptr()
            i = ex._prog.arg_names.index(name)
            assert ex.arg_arrays[i] is a_ex.arg_dict[name]
            assert ex.grad_arrays[i] is a_ex.grad_dict[name]
        for attr in ("_optimizer", "_kvstore", "_updater",
                     "_update_on_kvstore"):
            assert getattr(child, attr) is getattr(anchor, attr)
        assert child._arg_params is anchor._arg_params
    # one momentum state per parameter, in the one store
    states = anchor._kvstore._updater.states
    assert len(states) == len(anchor._exec_group.param_names)


def test_borrow_optimizer_shares_momentum_per_key():
    """Two buckets updated in turn move one momentum: after bucket 8's
    step and bucket 16's step the store holds one state per key, equal to
    the JAX package's after the same two steps."""
    res = {}
    for pkg, tr in ((tmx, ttr), (jmx, jtr)):
        it = bucket_iter(pkg, sentences(11), 11)
        batches = {b.bucket_key: b for b in it}
        mod = pkg.mod.BucketingModule(sym_gen_for(pkg, tr._block),
                                      default_bucket_key=16,
                                      context=pkg.cpu())
        mod.bind(it.provide_data, it.provide_label)
        pkg.random.seed(0)
        mod.init_params(initializer=pkg.init.Xavier())
        mod.init_optimizer(kvstore=None, optimizer="sgd",
                           optimizer_params={"learning_rate": 0.01,
                                             "momentum": 0.9})
        for key in (8, 16, 8):
            mod.forward_backward(batches[key])
            mod.update()
        upd = mod._buckets[16]._updater
        assert mod._buckets[8]._updater is upd
        names = mod._buckets[16]._exec_group.param_names
        res[pkg.__name__] = {names[i]: np.asarray(
            (s.asnumpy() if hasattr(s, "asnumpy") else s))
            for i, s in upd.states.items()}
    t, j = res["mxnet_tpu_torch"], res["mxnet_tpu"]
    assert sorted(t) == sorted(j)
    _close(t, j, "momentum")


def test_shared_bind_refuses_another_shape():
    """A parameter declared at the bucket's length cannot be shared: the
    bind says which."""
    mod = tmx.mod.BucketingModule(
        lambda T: (ttr.get_symbol(vocab_size=VOCAB, seq_len=T,
                                  num_layers=1, hidden=HIDDEN, heads=HEADS),
                   ("data",), ("softmax_label",)),
        default_bucket_key=8, context=tmx.cpu())
    mod.bind([("data", (2, 8))], [("softmax_label", (2, 8))])
    mod.init_params()
    with pytest.raises(tmx.MXNetError, match="pos_embed"):
        mod.switch_bucket(4, [("data", (2, 4))],
                          [("softmax_label", (2, 4))])


def test_unported_parts_name_their_queue_item():
    mod = tmx.mod.BucketingModule(sym_gen_for(tmx, ttr._block),
                                  default_bucket_key=16, context=tmx.cpu())
    mod.bind([("data", (2, 16))], [("softmax_label", (2, 16))])
    with pytest.raises(NotPortedYet, match="item 9, observability"):
        mod.install_monitor(object())
    # sparse storage (item 5) is ported: SparseEmbedding agrees with JAX
    ids = np.array([[1, 3], [0, 3]], np.float32)
    w = np.arange(12, dtype=np.float32).reshape(4, 3)
    got = tmx.nd.contrib.SparseEmbedding(
        tmx.nd.array(ids, ctx=tmx.cpu()), tmx.nd.array(w, ctx=tmx.cpu()),
        input_dim=4, output_dim=3)
    want = jmx.nd.contrib.SparseEmbedding(jmx.nd.array(ids),
                                          jmx.nd.array(w), input_dim=4,
                                          output_dim=3)
    np.testing.assert_array_equal(got.asnumpy(), want.asnumpy())
    with pytest.raises(ValueError):
        mod.bind([("data", (2, 16))], shared_module=mod)


@pytest.mark.skipif(tmx.context.num_gpus() > 0, reason="a card is present")
def test_default_context_is_the_card():
    with pytest.raises(DeviceUnavailable):
        tmx.mod.BucketingModule(sym_gen_for(tmx, ttr._block),
                                default_bucket_key=16)
