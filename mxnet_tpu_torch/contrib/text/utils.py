"""Text pre-processing helpers (port of ``mxnet_tpu/contrib/text/utils.py``;
reference contrib/text/utils.py)."""
import collections
import re

__all__ = ["count_tokens_from_str"]


def count_tokens_from_str(source_str, token_delim=" ", seq_delim="\n",
                          to_lower=False, counter_to_update=None):
    """Count tokens of a delimited string into a Counter.

    Tokens are produced by splitting `source_str` on both delimiters;
    empty tokens are dropped.  When `counter_to_update` is given it is
    updated in place and returned, matching the reference semantics."""
    source_str = re.split(re.escape(token_delim) + "|" + re.escape(seq_delim),
                          source_str)
    tokens = [t for t in source_str if t]
    if to_lower:
        tokens = [t.lower() for t in tokens]
    counter = counter_to_update if counter_to_update is not None \
        else collections.Counter()
    counter.update(tokens)
    return counter
