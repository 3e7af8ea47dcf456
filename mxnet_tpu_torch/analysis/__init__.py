"""Analytic cost models (port of ``mxnet_tpu/analysis``; this slice
carries only :func:`~.costmodel.decode_step_model`)."""
from .costmodel import decode_step_model

__all__ = ["decode_step_model"]
