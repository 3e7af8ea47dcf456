"""``mx.contrib.text`` of the port against the JAX package's, on
``tests/test_contrib_text.py``'s cases: token counting, the vocabulary's
indexing rules, embeddings loaded from local files (custom, GloVe and
fastText formats), the registry, and composite embeddings.  Vectors are
host arrays and equal bit for bit."""
import collections

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu.contrib import text as jtext
from mxnet_tpu_torch.contrib import text as ttext


def _vec(x):
    return x.asnumpy()


@pytest.mark.parametrize("kw", [dict(), dict(to_lower=True),
                                dict(token_delim="|", seq_delim=";")])
def test_count_tokens_matches(kw):
    s = " Life is great! \n life is good .\n" if "token_delim" not in kw \
        else "a|b;c|a;;b|B"
    assert ttext.utils.count_tokens_from_str(s, **kw) == \
        jtext.utils.count_tokens_from_str(s, **kw)
    base_t = collections.Counter({"is": 10})
    got = ttext.utils.count_tokens_from_str("is it", counter_to_update=base_t)
    assert got is base_t and got["is"] == 11 and got["it"] == 1


@pytest.mark.parametrize("kw", [
    dict(most_freq_count=None, min_freq=2, reserved_tokens=["<pad>"]),
    dict(most_freq_count=3, min_freq=1, reserved_tokens=["<pad>"]),
    dict(unknown_token="<UNK>"),
    dict(most_freq_count=0),
])
def test_vocabulary_matches(kw):
    counter = collections.Counter(
        {"a": 5, "b": 5, "c": 3, "d": 2, "rare": 1, "<pad>": 9})
    j = jtext.Vocabulary(counter, **kw)
    t = ttext.Vocabulary(counter, **kw)
    assert t.idx_to_token == j.idx_to_token
    assert t.token_to_idx == j.token_to_idx
    assert len(t) == len(j)
    assert t.reserved_tokens == j.reserved_tokens
    assert t.unknown_token == j.unknown_token
    toks = ["zzz", "b", "a", "<pad>"]
    assert t.to_indices(toks) == j.to_indices(toks)
    assert t.to_indices("c") == j.to_indices("c")
    idx = list(range(len(t)))
    assert t.to_tokens(idx) == j.to_tokens(idx)
    assert t.to_tokens(np.int64(0)) == j.to_tokens(np.int64(0))
    with pytest.raises(ValueError):
        t.to_tokens(len(t) + 3)


def test_vocabulary_refuses_what_the_jax_refuses():
    counter = collections.Counter({"a": 1})
    for kw in (dict(reserved_tokens=["<unk>"]), dict(min_freq=0),
               dict(reserved_tokens=["x", "x"])):
        with pytest.raises(ValueError):
            jtext.Vocabulary(counter, **kw)
        with pytest.raises(ValueError):
            ttext.Vocabulary(counter, **kw)


@pytest.fixture()
def emb_file(tmp_path):
    p = tmp_path / "emb.txt"
    rs = np.random.RandomState(0)
    lines = ["hello 1 2 3", "world 4 5 6", "hello 9 9 9"]
    for i in range(20):
        lines.append("w%d %s" % (i, " ".join("%.6f" % v
                                             for v in rs.randn(3))))
    lines.append("<unk> 0.5 0.5 0.5")
    p.write_text("\n".join(lines) + "\n")
    return str(p)


def test_custom_embedding_matches(emb_file):
    j = jtext.embedding.CustomEmbedding(emb_file)
    t = ttext.embedding.CustomEmbedding(emb_file)
    assert t.vec_len == j.vec_len == 3 and len(t) == len(j)
    assert t.idx_to_token == j.idx_to_token
    assert t.idx_to_vec.context == tmx.cpu()
    np.testing.assert_array_equal(_vec(t.idx_to_vec), _vec(j.idx_to_vec))
    for toks, kw in ((["world", "nope", "Hello", "w3"], {}),
                     (["Hello", "W7"], dict(lower_case_backup=True)),
                     ("hello", {})):
        np.testing.assert_array_equal(
            _vec(t.get_vecs_by_tokens(toks, **kw)),
            _vec(j.get_vecs_by_tokens(toks, **kw)))
    j.update_token_vectors(["world", "w0"],
                           jmx.nd.array([[7.0, 7, 7], [1, 2, 3]]))
    t.update_token_vectors(["world", "w0"],
                           tmx.nd.array([[7.0, 7, 7], [1, 2, 3]],
                                        ctx=tmx.cpu()))
    np.testing.assert_array_equal(_vec(t.idx_to_vec), _vec(j.idx_to_vec))
    with pytest.raises(ValueError):
        t.update_token_vectors("nope", tmx.nd.array([1.0, 1, 1],
                                                    ctx=tmx.cpu()))


def test_embedding_delimiters_and_unknown_init(tmp_path):
    p = tmp_path / "tab.txt"
    p.write_text("x\t1\t2\ny\t3\t4\n")
    kw = dict(elem_delim="\t", init_unknown_vec=lambda d: np.full(d, -1.0))
    j = jtext.embedding.CustomEmbedding(str(p), **kw)
    t = ttext.embedding.CustomEmbedding(str(p), **kw)
    np.testing.assert_array_equal(_vec(t.idx_to_vec), _vec(j.idx_to_vec))
    bad = tmp_path / "bad.txt"
    bad.write_text("x 1 2\ny 3\n")
    with pytest.raises(ValueError):
        ttext.embedding.CustomEmbedding(str(bad))


def test_registry_matches(emb_file):
    t = ttext.embedding.create("customembedding",
                               pretrained_file_path=emb_file)
    j = jtext.embedding.create("customembedding",
                               pretrained_file_path=emb_file)
    np.testing.assert_array_equal(_vec(t.idx_to_vec), _vec(j.idx_to_vec))
    assert ttext.embedding.get_pretrained_file_names() == \
        jtext.embedding.get_pretrained_file_names()
    assert ttext.embedding.get_pretrained_file_names("GloVe") == \
        jtext.embedding.get_pretrained_file_names("GloVe")
    with pytest.raises(RuntimeError):
        ttext.embedding.GloVe()          # local files only
    with pytest.raises(RuntimeError):
        ttext.embedding.FastText()
    with pytest.raises(KeyError):
        ttext.embedding.create("nosuch")


def test_glove_and_fasttext_files_match(tmp_path):
    g = tmp_path / "glove.txt"
    g.write_text("the 0.1 0.2\nof -0.3 0.4\n")
    f = tmp_path / "ft.vec"
    f.write_text("2 3\ncat 1 2 3\ndog 4 5 6\n")
    for cls, path in (("GloVe", g), ("FastText", f)):
        j = getattr(jtext.embedding, cls)(pretrained_file_path=str(path))
        t = getattr(ttext.embedding, cls)(pretrained_file_path=str(path))
        assert t.idx_to_token == j.idx_to_token
        np.testing.assert_array_equal(_vec(t.idx_to_vec),
                                      _vec(j.idx_to_vec))


def test_composite_embedding_matches(tmp_path):
    p1 = tmp_path / "a.txt"
    p1.write_text("x 1 1\ny 2 2\n")
    p2 = tmp_path / "b.txt"
    p2.write_text("x 3\nz 4\n")
    out = []
    for text in (jtext, ttext):
        e1 = text.embedding.CustomEmbedding(str(p1))
        e2 = text.embedding.CustomEmbedding(str(p2))
        vocab = text.Vocabulary(collections.Counter({"x": 2, "y": 1,
                                                     "z": 1}))
        comp = text.embedding.CompositeEmbedding(vocab, [e1, e2])
        single = text.embedding.CompositeEmbedding(vocab, e1)
        out.append((comp, single))
    (jc, js), (tc, ts) = out
    assert tc.vec_len == jc.vec_len == 3
    assert tc.idx_to_token == jc.idx_to_token
    np.testing.assert_array_equal(_vec(tc.idx_to_vec), _vec(jc.idx_to_vec))
    np.testing.assert_array_equal(_vec(ts.idx_to_vec), _vec(js.idx_to_vec))
    np.testing.assert_array_equal(_vec(tc.get_vecs_by_tokens(["z", "q"])),
                                  _vec(jc.get_vecs_by_tokens(["z", "q"])))
