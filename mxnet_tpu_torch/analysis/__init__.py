"""Analytic cost models (port of ``mxnet_tpu/analysis``; so far
:func:`~.costmodel.decode_step_model` and
:func:`~.costmodel.transformer_flops_per_step`)."""
from .costmodel import decode_step_model, transformer_flops_per_step

__all__ = ["decode_step_model", "transformer_flops_per_step"]
