"""Token embeddings (port of ``mxnet_tpu/contrib/text/embedding.py``;
reference contrib/text/embedding.py).

The reference downloads GloVe/FastText files; this environment has no
network, so the pretrained registry exists for API parity but loading is
from LOCAL files only: `CustomEmbedding(path)` for any
`token<delim>val...` file, and `GloVe`/`FastText` accept a local file via
`pretrained_file_path=`.  Vector storage is an NDArray table indexed by a
Vocabulary, so `get_vecs_by_tokens` batches into one gather.  The table
(`idx_to_vec`) and the vectors it gives are host arrays, as in MXNet.
"""
from __future__ import annotations

import numpy as np

from ...context import cpu
from ...ndarray.ndarray import NDArray, array as _array
from . import vocab as _vocab


def nd_array(source, dtype=None):
    """A host NDArray (the embedding tables live on the host)."""
    return _array(source, ctx=cpu(), dtype=dtype)

__all__ = ["register", "create", "get_pretrained_file_names",
           "TokenEmbedding", "GloVe", "FastText", "CustomEmbedding",
           "CompositeEmbedding"]

_REGISTRY = {}


def register(embedding_cls):
    """Class decorator registering an embedding under its lowercase name."""
    _REGISTRY[embedding_cls.__name__.lower()] = embedding_cls
    return embedding_cls


def create(embedding_name, **kwargs):
    name = embedding_name.lower()
    if name not in _REGISTRY:
        raise KeyError("unknown embedding %r; registered: %s"
                       % (embedding_name, sorted(_REGISTRY)))
    return _REGISTRY[name](**kwargs)


def get_pretrained_file_names(embedding_name=None):
    """Names of known pretrained files (reference keeps a static list; no
    network here, so these are documentation — load local files)."""
    table = {cls.__name__.lower(): sorted(cls.pretrained_file_names)
             for cls in _REGISTRY.values()}
    if embedding_name is None:
        return table
    return table[embedding_name.lower()]


class TokenEmbedding(_vocab.Vocabulary):
    """Base: a Vocabulary whose indices also key a vector table."""

    pretrained_file_names = ()

    def __init__(self, unknown_token="<unk>", init_unknown_vec=None):
        super().__init__(counter=None, unknown_token=unknown_token)
        self._init_unknown_vec = init_unknown_vec or (lambda d: np.zeros(d))
        self._vec_len = 0
        self._idx_to_vec = None

    # -- loading -----------------------------------------------------------
    def _load_file(self, path, elem_delim=" ", encoding="utf-8",
                   skip_header=False):
        tokens, vecs = [], []
        loaded_unknown = None
        with open(path, encoding=encoding) as f:
            for lineno, line in enumerate(f):
                parts = line.rstrip("\n").split(elem_delim)
                if skip_header and lineno == 0 and len(parts) == 2 and \
                        all(p.isdigit() for p in parts):
                    continue   # fastText "count dim" header line
                if len(parts) < 2:
                    continue   # blank/garbage line
                token, elems = parts[0], parts[1:]
                try:
                    v = np.asarray([float(x) for x in elems], np.float32)
                except ValueError:
                    raise ValueError("bad embedding line %d in %s"
                                     % (lineno + 1, path))
                if self._vec_len == 0:
                    self._vec_len = len(v)
                elif len(v) != self._vec_len:
                    raise ValueError(
                        "inconsistent vector length at line %d (%d != %d)"
                        % (lineno + 1, len(v), self._vec_len))
                if token == self._unknown_token:
                    # a trained unknown vector in the file wins over the
                    # init_unknown_vec default (reference behavior)
                    loaded_unknown = v
                    continue
                if token in self._token_to_idx:
                    continue   # first occurrence wins (reference behavior)
                self._token_to_idx[token] = len(self._idx_to_token)
                self._idx_to_token.append(token)
                tokens.append(token)
                vecs.append(v)
        table = np.zeros((len(self._idx_to_token), self._vec_len),
                         np.float32)
        table[0] = loaded_unknown if loaded_unknown is not None \
            else self._init_unknown_vec(self._vec_len)
        if vecs:
            table[len(table) - len(vecs):] = np.stack(vecs)
        self._idx_to_vec = nd_array(table)

    # -- API ---------------------------------------------------------------
    @property
    def vec_len(self):
        return self._vec_len

    @property
    def idx_to_vec(self) -> NDArray:
        return self._idx_to_vec

    def get_vecs_by_tokens(self, tokens, lower_case_backup=False):
        """Vectors for token(s); unknown tokens get the unknown vector.
        One gather over the table, not a per-token loop."""
        single = isinstance(tokens, str)
        toks = [tokens] if single else tokens
        if lower_case_backup:
            idxs = [self._token_to_idx.get(
                t, self._token_to_idx.get(t.lower(), 0)) for t in toks]
        else:
            idxs = [self._token_to_idx.get(t, 0) for t in toks]
        # NDArray-key indexing dispatches the registered `take` op — one
        # gather through the supported op layer
        out = self._idx_to_vec[nd_array(np.asarray(idxs, np.int32))]
        return out[0] if single else out

    def update_token_vectors(self, tokens, new_vectors):
        toks = [tokens] if isinstance(tokens, str) else tokens
        vecs = new_vectors.asnumpy().reshape(len(toks), -1)
        table = self._idx_to_vec.asnumpy()
        for t, v in zip(toks, vecs):
            if t not in self._token_to_idx:
                raise ValueError("token %r not in the embedding" % t)
            table[self._token_to_idx[t]] = v
        self._idx_to_vec = nd_array(table)


@register
class GloVe(TokenEmbedding):
    """GloVe vectors from a LOCAL file (no network in this environment)."""

    pretrained_file_names = (
        "glove.42B.300d.txt", "glove.6B.50d.txt", "glove.6B.100d.txt",
        "glove.6B.200d.txt", "glove.6B.300d.txt", "glove.840B.300d.txt",
        "glove.twitter.27B.25d.txt", "glove.twitter.27B.50d.txt",
        "glove.twitter.27B.100d.txt", "glove.twitter.27B.200d.txt")

    def __init__(self, pretrained_file_name="glove.840B.300d.txt",
                 pretrained_file_path=None, **kwargs):
        super().__init__(**kwargs)
        if pretrained_file_path is None:
            raise RuntimeError(
                "downloading %r is unavailable (no network); pass "
                "pretrained_file_path= to a local copy" % pretrained_file_name)
        self._load_file(pretrained_file_path)


@register
class FastText(TokenEmbedding):
    """fastText vectors from a LOCAL file (header line skipped)."""

    pretrained_file_names = ("wiki.simple.vec", "wiki.en.vec", "wiki.zh.vec")

    def __init__(self, pretrained_file_name="wiki.simple.vec",
                 pretrained_file_path=None, **kwargs):
        super().__init__(**kwargs)
        if pretrained_file_path is None:
            raise RuntimeError(
                "downloading %r is unavailable (no network); pass "
                "pretrained_file_path= to a local copy" % pretrained_file_name)
        self._load_file(pretrained_file_path, skip_header=True)


@register
class CustomEmbedding(TokenEmbedding):
    """Any 'token<delim>v1<delim>v2...' file."""

    def __init__(self, pretrained_file_path, elem_delim=" ",
                 encoding="utf-8", **kwargs):
        super().__init__(**kwargs)
        self._load_file(pretrained_file_path, elem_delim, encoding)


class CompositeEmbedding(TokenEmbedding):
    """Concatenate several embeddings' vectors over one vocabulary
    (reference CompositeEmbedding)."""

    def __init__(self, vocabulary, token_embeddings):
        if not isinstance(token_embeddings, list):
            token_embeddings = [token_embeddings]
        super().__init__(unknown_token=vocabulary.unknown_token)
        self._idx_to_token = list(vocabulary.idx_to_token)
        self._token_to_idx = dict(vocabulary.token_to_idx)
        self._reserved_tokens = vocabulary.reserved_tokens
        parts = [emb.get_vecs_by_tokens(self._idx_to_token).asnumpy()
                 for emb in token_embeddings]
        table = np.concatenate(parts, axis=1)
        self._vec_len = table.shape[1]
        self._idx_to_vec = nd_array(table.astype(np.float32))
