"""Decoder-only transformer language model (port of
``mxnet_tpu/models/transformer.py``): the training graph
(:func:`get_symbol`) and the serving entry point (:func:`get_decode_step`).

Layout: tokens (N, T) -> Embedding (N, T, D) + learned positions ->
L x [pre-LN causal self-attention + pre-LN GELU FFN, residuals] ->
LN -> vocab head -> per-token SoftmaxOutput against labels (N, T).

Both share the parameter names (``tok_embed_weight``, ``pos_embed``,
``l0_q_weight``, ``l0_ln1_gamma``, ...), so a state trained by
:class:`~mxnet_tpu_torch.parallel.trainer.ShardedTrainer` feeds
:func:`get_decode_step` as it is.
"""
from __future__ import annotations

from .. import symbol as sym

__all__ = ["get_symbol", "get_decode_step"]


def _block(x, hidden, heads, seq_len, idx, flash_min_seq=0):
    p = "l%d_" % idx
    head_dim = hidden // heads
    # attention (pre-norm)
    a = sym.LayerNorm(x, name=p + "ln1")
    q = sym.FullyConnected(a, num_hidden=hidden, flatten=False,
                           name=p + "q")
    k = sym.FullyConnected(a, num_hidden=hidden, flatten=False,
                           name=p + "k")
    v = sym.FullyConnected(a, num_hidden=hidden, flatten=False,
                           name=p + "v")
    shape4 = (-1, seq_len, heads, head_dim)
    att = sym.contrib.fused_attention(
        sym.Reshape(q, shape=shape4), sym.Reshape(k, shape=shape4),
        sym.Reshape(v, shape=shape4), causal=True,
        flash_min_seq=flash_min_seq, name=p + "attn")
    att = sym.Reshape(att, shape=(-1, seq_len, hidden))
    att = sym.FullyConnected(att, num_hidden=hidden, flatten=False,
                             name=p + "proj")
    x = x + att
    # FFN (pre-norm)
    f = sym.LayerNorm(x, name=p + "ln2")
    f = sym.FullyConnected(f, num_hidden=hidden * 4, flatten=False,
                           name=p + "ff1")
    f = sym.Activation(f, act_type="gelu", name=p + "act")
    f = sym.FullyConnected(f, num_hidden=hidden, flatten=False,
                           name=p + "ff2")
    return x + f


def get_symbol(vocab_size=1000, seq_len=32, num_layers=2, hidden=64,
               heads=4, flash_min_seq=0, **kwargs):
    """Returns a SoftmaxOutput-headed LM symbol.

    data: (N, T) token ids; softmax_label: (N, T) next-token ids.  The
    head flattens to (N*T, vocab) so the standard per-row softmax head
    applies.  ``flash_min_seq`` rides through to every attention op (0 =
    the MXNET_FLASH_MIN_SEQ default): at and above it the attention runs
    the flash kernels in both directions."""
    data = sym.Variable("data")
    label = sym.Variable("softmax_label")
    pos = sym.Variable("pos_embed", shape=(seq_len, hidden))
    tok = sym.Embedding(data, input_dim=vocab_size, output_dim=hidden,
                        name="tok_embed")
    x = sym.broadcast_add(tok, sym.expand_dims(pos, axis=0))
    for i in range(num_layers):
        x = _block(x, hidden, heads, seq_len, i,
                   flash_min_seq=flash_min_seq)
    x = sym.LayerNorm(x, name="ln_f")
    logits = sym.FullyConnected(x, num_hidden=vocab_size, flatten=False,
                                name="head")
    logits = sym.Reshape(logits, shape=(-1, vocab_size))
    label_f = sym.Reshape(label, shape=(-1,))
    return sym.SoftmaxOutput(logits, label_f, name="softmax")


def get_decode_step(arg_params, vocab_size=1000, seq_len=32, num_layers=2,
                    hidden=64, heads=4, *, page_size=None, max_seqs=None,
                    quantize=None, mesh=None, eos_id=None, name="decode",
                    device=None):
    """Incremental-decode entry point sharing weights with the training
    graph.

    ``arg_params`` is a parameter dict under the training names
    (``l0_q_weight`` etc.; host arrays or the port's tensors); the
    returned :class:`~mxnet_tpu_torch.serving.decode.DecodeProgram` runs
    one token per occupied slot per call against a paged KV cache on
    ``device`` (None = the card; a typed error without one).
    ``seq_len`` bounds prompt+generation; ``quantize`` (``"int8"`` /
    ``"int4"``) selects weight-only quantized matmuls; ``mesh`` (a
    ``MeshSpec`` or ``{"tp": k}``) serves it tensor-parallel over a
    gang's tp group, each rank holding its blocks.  Feed the program to
    :class:`~mxnet_tpu_torch.serving.decode.DecodeEngine` for continuous
    token-level batching."""
    from ..serving.decode import DecodeConfig, DecodeProgram
    config = DecodeConfig(vocab_size, num_layers, hidden, heads, seq_len,
                          page_size=page_size, max_seqs=max_seqs,
                          quantize=quantize, eos_id=eos_id)
    params = {k: v for k, v in dict(arg_params).items()
              if k not in ("data", "softmax_label")}
    return DecodeProgram(params, config, mesh=mesh, name=name,
                         device=device)
