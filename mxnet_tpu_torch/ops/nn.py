"""Neural-network ops of the LM graph (port of ``FullyConnected``,
``Activation``, ``LayerNorm``, ``SoftmaxOutput`` and
``_contrib_fused_attention`` from ``mxnet_tpu/ops/nn.py``; reference
src/operator/nn/, softmax_output-inl.h).

The loss head keeps the reference's defining quirk: its backward IGNORES
the incoming gradient and emits ``softmax - one_hot(label)`` directly
(unless ``out_grad``), so it is a ``torch.autograd.Function``.  The
attention op keeps the reference's dispatch: below ``flash_min_seq`` the
plain einsum formulation and autograd, at and above it the hand-written
flash kernels of :mod:`.kernels` in both directions.
"""
from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F

from ..base import (MXNetError, NotPortedYet, Param, attr_bool, attr_float,
                    attr_int, attr_str)
from . import kernels
from .registry import register

__all__ = ["FLASH_MIN_SEQ"]


# ---------------------------------------------------------------------------
# FullyConnected
# ---------------------------------------------------------------------------

def _fc_inputs(attrs):
    if attrs is not None and not attrs.get("no_bias", False):
        return ["data", "weight", "bias"]
    return ["data", "weight"]


@register("FullyConnected", inputs=_fc_inputs,
          params=dict(num_hidden=attr_int(required=True),
                      no_bias=attr_bool(False), flatten=attr_bool(True)))
def _fully_connected(attrs, data, weight, bias=None):
    x = data.reshape(data.shape[0], -1) if attrs.flatten else data
    return F.linear(x, weight, bias)


# ---------------------------------------------------------------------------
# Activations
# ---------------------------------------------------------------------------

def _act(name):
    return {
        "relu": torch.relu,
        "sigmoid": torch.sigmoid,
        "tanh": torch.tanh,
        "softrelu": F.softplus,
        "softsign": F.softsign,
        # exact erf formulation, as the reference GELU
        "gelu": lambda v: F.gelu(v, approximate="none"),
    }[name]


@register("Activation", inputs=("data",),
          params=dict(act_type=attr_str(required=True)))
def _activation(attrs, x):
    return _act(attrs.act_type)(x)


# ---------------------------------------------------------------------------
# LayerNorm
# ---------------------------------------------------------------------------

@register("LayerNorm", inputs=("data", "gamma", "beta"),
          params=dict(axis=Param(int, -1), eps=attr_float(1e-5),
                      output_mean_var=attr_bool(False)),
          num_outputs=3, num_visible_outputs=1)
def _layer_norm(attrs, x, gamma, beta):
    """Statistics in f32, the result back in the input dtype; returns
    (out, mean, var) with the population variance."""
    ax = attrs.axis % x.dim()
    x32 = x.float()
    var, mean = torch.var_mean(x32, dim=ax, unbiased=False, keepdim=True)
    inv = torch.rsqrt(var + attrs.eps)
    shape = [1] * x.dim()
    shape[ax] = x.shape[ax]
    out = (x32 - mean) * inv * gamma.reshape(shape) + beta.reshape(shape)
    return (out.to(x.dtype), mean.squeeze(ax).to(x.dtype),
            var.squeeze(ax).to(x.dtype))


# ---------------------------------------------------------------------------
# SoftmaxOutput: the loss head with the reference's own backward
# ---------------------------------------------------------------------------

def _softmax_fwd(attrs, d):
    if attrs.multi_output and d.dim() > 2:
        return torch.softmax(d, dim=1)
    if attrs.preserve_shape:
        return torch.softmax(d, dim=-1)
    return torch.softmax(d.reshape(d.shape[0], -1), dim=-1).reshape(d.shape)


def _one_hot(li, nclass, dim, dtype):
    """``jax.nn.one_hot``: an index outside [0, nclass) gives a zero row
    (``torch.nn.functional.one_hot`` would raise)."""
    valid = (li >= 0) & (li < nclass)
    shape = list(li.shape)
    dim = dim % (li.dim() + 1)
    shape.insert(dim, nclass)
    oh = torch.zeros(shape, dtype=dtype, device=li.device)
    return oh.scatter_(dim, li.clamp(0, nclass - 1).unsqueeze(dim),
                       valid.unsqueeze(dim).to(dtype))


def _softmax_output_grad(attrs, dshape, prob, lab, g):
    """``(softmax - one_hot(label)) * grad_scale / normalizer`` (times
    the incoming ``g`` only under ``out_grad``)."""
    if attrs.multi_output and len(dshape) > 2:
        # label (N, spatial...), prob (N, C, spatial...)
        li = lab.long()
        grad = prob - _one_hot(li, dshape[1], 1, prob.dtype)
        if attrs.use_ignore:
            keep = lab != attrs.ignore_label
            grad = grad * keep.unsqueeze(1).to(grad.dtype)
            valid = torch.clamp(keep.sum(), min=1).to(grad.dtype)
        else:
            valid = float(np.prod(tuple(lab.shape)))
    else:
        if attrs.preserve_shape:
            probf = prob
            li = lab.long()
        else:
            probf = prob.reshape(dshape[0], -1)
            li = lab.reshape(-1).long()
        nclass = probf.shape[-1]
        oh = _one_hot(li, nclass, -1, probf.dtype)
        if attrs.smooth_alpha:
            a = attrs.smooth_alpha
            oh = oh * (1 - a) + a / (nclass - 1) * (1 - oh)
        grad = probf - oh.reshape(probf.shape)
        if attrs.use_ignore:
            keep = li != attrs.ignore_label
            grad = grad * keep.unsqueeze(-1).to(grad.dtype)
            valid = torch.clamp(keep.sum(), min=1).to(grad.dtype)
        else:
            valid = float(np.prod(tuple(li.shape)))
        grad = grad.reshape(dshape)
    if attrs.normalization == "batch":
        grad = grad / dshape[0]
    elif attrs.normalization == "valid":
        grad = grad / valid
    grad = grad * attrs.grad_scale
    if attrs.out_grad:
        grad = grad * g
    return grad.to(prob.dtype)


class SoftmaxOutputFn(torch.autograd.Function):
    """Forward ``softmax(data)``; backward the loss gradient, ignoring the
    incoming cotangent unless ``out_grad``.  The label gets no gradient.
    The probabilities are saved rather than recomputed (the reference
    recomputes them from ``data``; the values are the same)."""

    @staticmethod
    def forward(ctx, data, label, attrs):
        prob = _softmax_fwd(attrs, data)
        ctx.attrs = attrs
        ctx.data_shape = tuple(data.shape)
        ctx.save_for_backward(prob, label)
        return prob

    @staticmethod
    def backward(ctx, g):
        prob, label = ctx.saved_tensors
        return (_softmax_output_grad(ctx.attrs, ctx.data_shape, prob, label,
                                     g), None, None)


@register("SoftmaxOutput", inputs=("data", "label"),
          params=dict(grad_scale=attr_float(1.0),
                      ignore_label=attr_float(-1.0),
                      multi_output=attr_bool(False),
                      use_ignore=attr_bool(False),
                      preserve_shape=attr_bool(False),
                      normalization=attr_str("null"),
                      out_grad=attr_bool(False),
                      smooth_alpha=attr_float(0.0)),
          aliases=("Softmax",))
def _softmax_output(attrs, data, label):
    """Forward = softmax(data); backward(data) = (softmax - one_hot(label))
    * grad_scale / normalizer, ignoring the incoming gradient — the exact
    semantics of softmax_output-inl.h."""
    return SoftmaxOutputFn.apply(data, label, attrs)


# ---------------------------------------------------------------------------
# Fused attention
# ---------------------------------------------------------------------------

# The flash-vs-einsum dispatch threshold and the backward choice are read
# once at import, as in the reference (where they are frozen for its jit
# cache); the per-op ``flash_min_seq`` attr overrides the threshold.
FLASH_MIN_SEQ = int(os.environ.get("MXNET_FLASH_MIN_SEQ", "1024"))
_FLASH_BWD = os.environ.get("MXNET_TPU_FLASH_BWD", "pallas")


def _attention_einsum(q, k, v, causal, scale):
    """The plain formulation (reference nn.py naive): (B, T, H, D)."""
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if causal:
        Tq, Tk = q.shape[1], k.shape[1]
        mask = torch.ones((Tq, Tk), dtype=torch.bool,
                          device=q.device).tril()
        s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


@register("_contrib_fused_attention", inputs=("query", "key", "value"),
          params=dict(causal=attr_bool(False), scale=attr_float(0.0),
                      block_q=attr_int(0), flash_min_seq=attr_int(0)),
          aliases=("fused_attention",))
def _contrib_fused_attention(attrs, q, k, v):
    """Attention over (B, T, H, D); dispatches by sequence length.

    T < flash_min_seq (default 1024, env MXNET_FLASH_MIN_SEQ) runs the
    plain einsum formulation and autograd.  At and above the threshold
    both directions run the flash kernels (:class:`kernels.FlashAttention`):
    the forward saves the row logsumexp and the backward rebuilds the
    probabilities from it, so no (T, T) tensor is stored.  ``block_q`` is
    validated (0 = the kernel's own tile); the CUDA kernels pick their
    tile themselves.  ``MXNET_TPU_FLASH_BWD=remat`` (the reference's
    rematerialising einsum backward) is not ported."""
    scale = attrs.scale if attrs.scale > 0 else \
        1.0 / float(q.shape[-1]) ** 0.5
    if attrs.block_q < 0:
        raise MXNetError("fused_attention: block_q must be >= 0 "
                         "(0 = autotuned), got %d" % attrs.block_q)
    flash_min = attrs.flash_min_seq or FLASH_MIN_SEQ
    if q.shape[1] < flash_min:
        return _attention_einsum(q, k, v, attrs.causal, scale)
    if _FLASH_BWD != "pallas":
        raise NotPortedYet("MXNET_TPU_FLASH_BWD=%s: the rematerialising "
                           "einsum backward is not ported (ROADMAP)"
                           % _FLASH_BWD)
    return kernels.flash_attention(q, k, v, causal=attrs.causal,
                                   scale=scale)
