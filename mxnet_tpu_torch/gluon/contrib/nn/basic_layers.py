"""Contrib layers (port of ``mxnet_tpu/gluon/contrib/nn/basic_layers.py``;
reference gluon/contrib/nn/basic_layers.py: Concurrent :27,
HybridConcurrent :60, Identity :93)."""
from ...block import HybridBlock

__all__ = ["Concurrent", "HybridConcurrent", "Identity"]


class HybridConcurrent(HybridBlock):
    """Parallel branches over the same input, outputs concatenated on
    `axis` (the Inception-style branch combinator)."""

    def __init__(self, axis=1, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self.axis = axis

    def add(self, *blocks):
        for block in blocks:
            self.register_child(block)

    def hybrid_forward(self, F, x):
        outs = [block(x) for block in self._children.values()]
        return F.concat(*outs, dim=self.axis)


class Concurrent(HybridConcurrent):
    """Imperative-friendly alias (reference derives it from Sequential;
    functionally identical here — the forward is the same concat)."""


class Identity(HybridBlock):
    """Pass-through block (reference :93) — useful as a no-op branch in
    Concurrent layers."""

    def hybrid_forward(self, F, x):
        return x
