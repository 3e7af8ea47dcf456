"""Token-index vocabulary (port of ``mxnet_tpu/contrib/text/vocab.py``;
reference contrib/text/vocab.py Vocabulary).

Indexing rules (reference :79-139): the unknown token takes index 0,
reserved tokens follow, then counter keys by descending frequency with
ties broken lexically; `most_freq_count` caps how many COUNTER tokens are
kept (specials are on top of it); tokens under `min_freq` are dropped.
"""
from __future__ import annotations

__all__ = ["Vocabulary"]


class Vocabulary:
    def __init__(self, counter=None, most_freq_count=None, min_freq=1,
                 unknown_token="<unk>", reserved_tokens=None):
        if min_freq < 1:
            raise ValueError("min_freq must be >= 1")
        if reserved_tokens:
            if unknown_token in reserved_tokens:
                raise ValueError("unknown_token must not be reserved")
            if len(set(reserved_tokens)) != len(reserved_tokens):
                raise ValueError("reserved_tokens must be unique")
        self._unknown_token = unknown_token
        self._reserved_tokens = list(reserved_tokens) if reserved_tokens \
            else None
        self._idx_to_token = [unknown_token] + (self._reserved_tokens or [])
        if counter is not None:
            special = set(self._idx_to_token)
            budget = most_freq_count
            # stable order: frequency desc, then token asc
            ranked = sorted(counter.items(), key=lambda kv: (-kv[1], kv[0]))
            for token, freq in ranked:
                if freq < min_freq or token in special:
                    continue
                if budget is not None and budget <= 0:
                    break
                self._idx_to_token.append(token)
                if budget is not None:
                    budget -= 1
        self._token_to_idx = {t: i for i, t in enumerate(self._idx_to_token)}

    def __len__(self):
        return len(self._idx_to_token)

    @property
    def token_to_idx(self):
        return self._token_to_idx

    @property
    def idx_to_token(self):
        return self._idx_to_token

    @property
    def unknown_token(self):
        return self._unknown_token

    @property
    def reserved_tokens(self):
        return self._reserved_tokens

    def to_indices(self, tokens):
        """Token(s) -> index(es); unknown tokens map to index 0."""
        single = isinstance(tokens, str)
        toks = [tokens] if single else tokens
        out = [self._token_to_idx.get(t, 0) for t in toks]
        return out[0] if single else out

    def to_tokens(self, indices):
        """Index(es) -> token(s); out-of-range raises.  Any non-sequence
        (python int, numpy scalar) counts as a single index."""
        single = not isinstance(indices, (list, tuple))
        idxs = [indices] if single else indices
        out = []
        for i in idxs:
            i = int(i)
            if not 0 <= i < len(self._idx_to_token):
                raise ValueError("index %d out of vocabulary range" % i)
            out.append(self._idx_to_token[i])
        return out[0] if single else out
