"""Decoder-only transformer language model: the serving entry point
(port of ``get_decode_step`` in ``mxnet_tpu/models/transformer.py``).

The training graph (``get_symbol``) comes with the Symbol/Module slice
(ROADMAP queue A4/A5); decode shares its parameter names, so a trained
module's ``arg_params`` feed :func:`get_decode_step` as they are.
"""
from __future__ import annotations

__all__ = ["get_decode_step"]


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
    ``"int4"``) selects weight-only quantized matmuls; ``mesh`` is not
    ported yet (typed error).  Feed the program to
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
