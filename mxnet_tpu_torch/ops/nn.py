"""Neural-network ops (port of ``mxnet_tpu/ops/nn.py``; reference
src/operator/nn/, softmax_output-inl.h, the loss heads and legacy root
ops).

Convolution, pooling and batch norm are library calls (cuDNN on the
card, ATen on the CPU), as the JAX package leaves them to XLA; no
hand-written kernel is on their path.  On a CUDA tensor the convolutions
turn cuDNN's TF32 off themselves (the reference computes f32 convolutions
at full precision), whatever the caller set.  Where the obvious PyTorch
call gives another answer than the reference, the op follows the
reference: max pooling pads with -inf for any ``pad``, avg pooling
divides by the whole kernel (the extra right padding of
``pooling_convention="full"`` included), ``Deconvolution`` pads
``k-1-p`` per side whatever ``dilate`` is, ``BatchNorm`` moves its
statistics with the biased batch variance, ``UpSampling`` repeats
nearest neighbours whatever ``sample_type`` says, and ``CTCLoss`` runs
the reference's alpha recursion with its blank and padding conventions.

The loss heads keep the reference's defining quirk: their backward
IGNORES the incoming gradient and emits the loss gradient directly
(``SoftmaxOutput`` unless ``out_grad``; the regression outputs,
``MakeLoss``, ``SVMOutput``), so each is a ``torch.autograd.Function``,
as is ``IdentityAttachKLSparseReg``.  The attention op keeps the
reference's dispatch: below ``flash_min_seq`` the plain einsum
formulation and autograd, at and above it the hand-written flash
kernels of :mod:`.kernels` in both directions.

``Dropout`` and ``LeakyReLU`` (rrelu) are ``needs_rng``: they draw from
the ``torch.Generator`` the caller hands them (the graph program's, or
the device generator of :mod:`mxnet_tpu_torch.rng`).  The
mode-dependent ops read ``_train``, which the executor sets.
"""
from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F

from ..base import (MXNetError, Param, attr_bool, attr_float, attr_int,
                    attr_shape, attr_str)
from . import kernels
from .elemwise import _int_to_f64
from .matrix import _fill, _in_range, promoted
from .registry import register

__all__ = ["FLASH_MIN_SEQ"]


def _int_to_f32(x):
    """``x``, or float32 for an integer or boolean tensor: the dtype the
    JAX package's softmax, gelu and normalisation give integer input
    (ATen's kernels take no integers)."""
    return x if x.is_floating_point() or x.is_complex() else x.float()


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
    """Data and weight of different dtypes meet in their promoted dtype
    (float64 data with a float32 weight gives float64, int32 data
    float32), as the JAX package's ``dot_general`` and ``+ bias`` give
    them (C20)."""
    x = data.reshape(data.shape[0], -1) if attrs.flatten else data
    if x.dtype == weight.dtype and (bias is None or bias.dtype == x.dtype):
        return F.linear(x, weight, bias)
    out = F.linear(*promoted(x, weight))
    return out if bias is None else out + bias


# ---------------------------------------------------------------------------
# Convolution / Deconvolution
# ---------------------------------------------------------------------------

_conv_inputs = _fc_inputs

_CONV_PARAMS = dict(
    kernel=attr_shape(required=True), stride=attr_shape(()),
    dilate=attr_shape(()), pad=attr_shape(()),
    num_filter=attr_int(required=True), num_group=attr_int(1),
    workspace=attr_int(1024), no_bias=attr_bool(False),
    cudnn_tune=attr_str(None), cudnn_off=attr_bool(False),
    layout=attr_str(None))

_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}
_CONV_T = {1: F.conv_transpose1d, 2: F.conv_transpose2d,
           3: F.conv_transpose3d}


def _conv_geometry(attrs):
    nd = len(attrs.kernel)
    return (nd, tuple(attrs.stride or (1,) * nd),
            tuple(attrs.dilate or (1,) * nd), tuple(attrs.pad or (0,) * nd))


def _no_cudnn_tf32(x):
    """f32 convolutions at full precision on the card, as the reference
    computes them: cuDNN's TF32 defaults to on, so the op turns it off
    itself rather than trust the caller."""
    if x.device.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False


@register("Convolution", inputs=_conv_inputs, params=dict(_CONV_PARAMS),
          aliases=("Convolution_v1",))
def _convolution(attrs, x, w, bias=None):
    """NC(D)HW activations with OI(D)HW weights, or ``layout="NHWC"``
    (2-d only) with OHWI weights.  An NHWC tensor permuted to NCHW is a
    ``channels_last`` tensor, which cuDNN runs without a copy; the result
    is permuted back."""
    nd, stride, dilate, pad = _conv_geometry(attrs)
    _no_cudnn_tf32(x)
    if attrs.layout == "NHWC":
        if nd != 2:
            raise MXNetError("Convolution: NHWC layout is 2-d only")
        out = F.conv2d(x.permute(0, 3, 1, 2), w.permute(0, 3, 1, 2), bias,
                       stride, pad, dilate, attrs.num_group)
        return out.permute(0, 2, 3, 1)
    return _CONV[nd](x, w, bias, stride, pad, dilate, attrs.num_group)


@register("Deconvolution", inputs=_conv_inputs,
          params=dict(_CONV_PARAMS, adj=attr_shape(()),
                      target_shape=attr_shape(())))
def _deconvolution(attrs, x, w, bias=None):
    """Transposed convolution with the reference's ``(C_in, C_out/g,
    k...)`` weights, which are ``conv_transpose``'s own.  The reference
    computes it as a convolution of the stride-dilated input with the
    flipped kernel, padded ``k-1-p`` on each side (``+adj`` on the
    right) whatever ``dilate`` is, so its output has
    ``(i-1)*s + 1 + 2*(k-1-p) - dilate*(k-1) + adj`` elements per axis.
    Here the full transposed convolution (no padding, extent
    ``(i-1)*s + dilate*(k-1) + 1``) is cropped, or zero-padded on the
    right where ``adj`` reaches past it, to that window.
    ``target_shape`` is parsed and ignored, as in the reference."""
    nd, stride, dilate, pad = _conv_geometry(attrs)
    adj = tuple(attrs.adj or (0,) * nd)
    _no_cudnn_tf32(x)
    if not x.is_floating_point():
        # integer data keeps its dtype, as in the reference; ATen's
        # transposed convolution takes no integers, and float64 holds
        # every sum of these products exactly
        out = _deconvolution(attrs, x.double(), w.double(),
                             None if bias is None else bias.double())
        return out.to(x.dtype)
    full = _CONV_T[nd](x, w, None, stride, 0, 0, attrs.num_group, dilate)
    crop = []
    for i in range(nd):
        k, size = attrs.kernel[i], full.shape[2 + i]
        start = (dilate[i] - 1) * (k - 1) + pad[i]
        end = (x.shape[2 + i] - 1) * stride[i] + k - pad[i] + adj[i]
        crop.append((-start, end - size))
    out = F.pad(full, [p for lo_hi in reversed(crop) for p in lo_hi])
    if bias is not None:
        out = out + bias.reshape((1, -1) + (1,) * nd)
    return out


# ---------------------------------------------------------------------------
# Pooling / UpSampling
# ---------------------------------------------------------------------------

_MAX_POOL = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}
# avg_pool1d has no divisor_override: 1-d windows are summed as 2-d ones
_SUM_POOL = {2: F.avg_pool2d, 3: F.avg_pool3d}


def _pool_window(x, kind, kernel, stride, pads):
    """Window ``max`` or ``sum`` over the trailing ``len(kernel)`` axes of
    ``x`` (N, C, spatial...), padded ``pads[i] = (lo, hi)`` with the
    reduction's identity (-inf, or ``iinfo.min`` for an integer max, and
    0) before ATen's pooling sees it, so no ``pad > kernel/2`` limit
    applies.  Integer windows, which ATen's pooling does not take, are an
    ``unfold`` and a reduction."""
    nd = len(kernel)
    if x.is_floating_point():
        fill = float("-inf") if kind == "max" else 0.0
    else:
        fill = torch.iinfo(x.dtype).min if kind == "max" else 0
    flat = [p for lo_hi in reversed(pads) for p in lo_hi]
    if any(flat):
        x = F.pad(x, flat, value=fill)
    if not x.is_floating_point():
        for i, (k, s) in enumerate(zip(kernel, stride)):
            x = x.unfold(2 + i, k, s)
        dims = tuple(range(-nd, 0))
        return x.amax(dims) if kind == "max" else x.sum(dims, dtype=x.dtype)
    if kind == "max":
        return _MAX_POOL[nd](x, kernel, stride)
    if nd == 1:
        return _pool_window(x.unsqueeze(-1), kind, kernel + (1,),
                            stride + (1,), [(0, 0)] * 2).squeeze(-1)
    return _SUM_POOL[nd](x, kernel, stride, divisor_override=1)


@register("Pooling", inputs=("data",),
          params=dict(kernel=attr_shape(()), pool_type=attr_str("max"),
                      global_pool=attr_bool(False),
                      cudnn_off=attr_bool(False),
                      pooling_convention=attr_str("valid"),
                      stride=attr_shape(()), pad=attr_shape(()),
                      layout=attr_str(None)),
          aliases=("Pooling_v1",))
def _pooling(attrs, x):
    """Max, avg or sum pooling over 1-3 spatial axes (NCHW, or NHWC).
    Max pads with -inf (``iinfo.min`` for integers) for any ``pad``; avg
    divides every window by ``prod(kernel)``, padding included, also
    where ``pooling_convention="full"`` extends the right padding so that
    the output size rounds up.  Integer data: the sum keeps its dtype
    (and wraps, as in the reference), avg is that sum divided in
    float64."""
    nd = x.dim() - 2
    nhwc = attrs.layout == "NHWC"
    if nhwc:
        x = x.movedim(-1, 1)
    if attrs.global_pool:
        kernel = tuple(x.shape[2:])
        stride, pad = (1,) * nd, (0,) * nd
    else:
        kernel = tuple(attrs.kernel)
        stride = tuple(attrs.stride or (1,) * nd)
        pad = tuple(attrs.pad or (0,) * nd)
    pads = [(p, p) for p in pad]
    if attrs.pooling_convention == "full" and not attrs.global_pool:
        for i in range(nd):
            size = x.shape[2 + i] + 2 * pad[i]
            out = -(-(size - kernel[i]) // stride[i]) + 1
            need = (out - 1) * stride[i] + kernel[i] - size
            pads[i] = (pad[i], pad[i] + max(0, need))
    if attrs.pool_type == "max":
        out = _pool_window(x, "max", kernel, stride, pads)
    else:
        out = _pool_window(x, "sum", kernel, stride, pads)
        if attrs.pool_type != "sum":
            out = _int_to_f64(out) / float(np.prod(kernel))
    return out.movedim(1, -1) if nhwc else out


@register("UpSampling", variadic=True,
          params=dict(num_args=attr_int(1), scale=attr_int(required=True),
                      sample_type=attr_str("nearest"),
                      num_filter=attr_int(0),
                      multi_input_mode=attr_str("concat"),
                      workspace=attr_int(512)))
def _upsampling(attrs, *xs):
    """Nearest-neighbour repeat by ``scale`` along axes 2 and 3, whatever
    ``sample_type`` says (the reference's own behaviour); several inputs
    are summed or concatenated along the channels."""
    s = attrs.scale
    outs = []
    for x in xs:
        n, c, h, w = x.shape[:4]
        big = x.reshape(n, c, h, 1, w, 1, *x.shape[4:]).expand(
            n, c, h, s, w, s, *x.shape[4:])
        outs.append(big.reshape(n, c, h * s, w * s, *x.shape[4:]))
    if len(outs) == 1:
        return outs[0]
    if attrs.multi_input_mode == "sum":
        return sum(outs)
    return torch.cat(outs, dim=1)


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
        "gelu": lambda v: F.gelu(_int_to_f32(v), approximate="none"),
    }[name]


@register("Activation", inputs=("data",),
          params=dict(act_type=attr_str(required=True)))
def _activation(attrs, x):
    return _act(attrs.act_type)(x)


def _lrelu_inputs(attrs):
    if attrs is not None and attrs.get("act_type", "leaky") == "prelu":
        return ["data", "gamma"]
    return ["data"]


@register("LeakyReLU", inputs=_lrelu_inputs,
          params=dict(act_type=attr_str("leaky"), slope=attr_float(0.25),
                      lower_bound=attr_float(0.125),
                      upper_bound=attr_float(0.334)),
          needs_rng=True, mode_dependent=True)
def _leaky_relu(attrs, gen, x, gamma=None):
    """leaky, elu, prelu (a learnt slope per channel), rrelu (a uniform
    slope per element in training, the mean slope otherwise) and gelu.
    Integer data: leaky and rrelu give float64 (a float slope times an
    integer, as in the reference), gelu float32."""
    t = attrs.act_type
    if t in ("leaky", "rrelu"):
        x = _int_to_f64(x)
    if t == "leaky":
        return torch.where(x >= 0, x, attrs.slope * x)
    if t == "elu":
        return torch.where(x >= 0, x, attrs.slope * torch.expm1(x))
    if t == "prelu":
        g = gamma.reshape((1, -1) + (1,) * (x.dim() - 2)) \
            if x.dim() > 1 else gamma
        return torch.where(x >= 0, x, g * x)
    if t == "rrelu":
        lo, hi = attrs.lower_bound, attrs.upper_bound
        if attrs.get("_train", False):
            slope = torch.rand(x.shape, generator=_generator(gen, x),
                               device=x.device, dtype=x.dtype) \
                * (hi - lo) + lo
        else:
            slope = (lo + hi) / 2.0
        return torch.where(x >= 0, x, slope * x)
    if t == "gelu":
        return F.gelu(_int_to_f32(x), approximate="none")
    raise ValueError("unknown act_type %s" % t)


def _temperature(attrs, x):
    """``x / temperature``; integer data is float64 divided by a
    temperature (a float scalar's promotion in the reference), float32
    without one."""
    if attrs.temperature is not None:
        return _int_to_f64(x) / attrs.temperature
    return _int_to_f32(x)


@register("softmax", inputs=("data",),
          params=dict(axis=Param(int, -1), temperature=attr_float(None)))
def _softmax(attrs, x):
    return torch.softmax(_temperature(attrs, x), dim=attrs.axis)


@register("log_softmax", inputs=("data",),
          params=dict(axis=Param(int, -1), temperature=attr_float(None)))
def _log_softmax(attrs, x):
    return torch.log_softmax(_temperature(attrs, x), dim=attrs.axis)


@register("SoftmaxActivation", inputs=("data",),
          params=dict(mode=attr_str("instance")))
def _softmax_activation(attrs, x):
    x = _int_to_f32(x)
    if attrs.mode == "channel":
        return torch.softmax(x, dim=1)
    return torch.softmax(x.reshape(x.shape[0], -1), dim=-1).reshape(x.shape)


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
# BatchNorm, with the moving statistics written back: inputs data, gamma,
# beta, moving_mean, moving_var; outputs out, mean, var, new_moving_mean,
# new_moving_var (the first visible; the last two the new aux values)
# ---------------------------------------------------------------------------

@register("BatchNorm",
          inputs=("data", "gamma", "beta", "moving_mean", "moving_var"),
          params=dict(eps=attr_float(1e-3), momentum=attr_float(0.9),
                      fix_gamma=attr_bool(True),
                      use_global_stats=attr_bool(False),
                      output_mean_var=attr_bool(False), axis=attr_int(1),
                      cudnn_off=attr_bool(False)),
          num_outputs=5, num_visible_outputs=1,
          writeback={3: 3, 4: 4}, aux_inputs=(3, 4), mode_dependent=True,
          aliases=("BatchNorm_v1",))
def _batch_norm(attrs, x, gamma, beta, mov_mean, mov_var):
    """Statistics and affine parameters in f32, the result back in the
    input dtype.  In training (``_train`` and not ``use_global_stats``)
    the batch's mean and biased variance normalise and move the statistics
    (``m*old + (1-m)*batch``); otherwise the moving ones normalise.
    ``fix_gamma`` takes gamma as ones, so its gradient is 0.  The
    normalisation is ``F.batch_norm`` (cuDNN on the card) with the
    channel axis moved to 1, and no running statistics handed to it: it
    would move them with the unbiased variance.  Under a dp trainer the
    statistics are the global batch's (:func:`_batch_norm_global`)."""
    ax = attrs.axis % x.dim()
    train = attrs.get("_train", False) and not attrs.use_global_stats
    xf = x.float().movedim(ax, 1)
    # f32 affine parameters whatever their own dtype (a graph that casts
    # its data to f16 or bf16 infers them in that dtype), as the
    # reference promotes them against its f32 statistics
    g = torch.ones_like(gamma, dtype=torch.float32) if attrs.fix_gamma \
        else gamma.float()
    beta = beta.float()
    if train and _dp_global_batch():
        # data parallelism: the statistics of the global batch
        out, mean, var = _batch_norm_global(xf, g, beta, attrs.eps)
        m = attrs.momentum
        new_mm = mov_mean * m + mean * (1 - m)
        new_mv = mov_var * m + var * (1 - m)
    elif train:
        red = [i for i in range(xf.dim()) if i != 1]
        with torch.no_grad():
            var, mean = torch.var_mean(xf, dim=red, correction=0)
        m = attrs.momentum
        new_mm = mov_mean * m + mean * (1 - m)
        new_mv = mov_var * m + var * (1 - m)
        if xf.numel() == xf.shape[1]:
            # one value per channel: the reference normalises by a zero
            # variance, where ATen's batch norm refuses to train
            bshape = (1, -1) + (1,) * (xf.dim() - 2)
            mu = xf.mean(dim=red, keepdim=True)
            out = (xf - mu) * torch.rsqrt(
                ((xf - mu) ** 2).mean(dim=red, keepdim=True) + attrs.eps) \
                * g.reshape(bshape) + beta.reshape(bshape)
        else:
            out = F.batch_norm(xf, None, None, g, beta, True, 0.0,
                               attrs.eps)
    else:
        mean, var, new_mm, new_mv = mov_mean, mov_var, mov_mean, mov_var
        if mean.dtype == var.dtype == torch.float32:
            out = F.batch_norm(xf, mean, var, g, beta, False, 0.0,
                               attrs.eps)
        else:
            # statistics of another dtype: the reference's own formula,
            # rsqrt in their dtype
            bshape = (1, -1) + (1,) * (xf.dim() - 2)
            inv = torch.rsqrt(var + attrs.eps)
            out = (xf - mean.reshape(bshape)) * (inv * g).reshape(bshape) \
                + beta.reshape(bshape)
    return out.movedim(1, ax).to(x.dtype), mean, var, new_mm, new_mv


def _dp_global_batch():
    """Whether a dp trainer asks BatchNorm and the loss heads for the
    global batch (:func:`mxnet_tpu_torch.parallel.global_batch_stats`)."""
    import sys
    par = sys.modules.get("mxnet_tpu_torch.parallel")
    return par is not None and par.batch_stats_global()


def _batch_norm_global(xf, g, beta, eps):
    """Training BatchNorm over the batch of every rank (channels on
    dim 1): the per-channel sum and then the centred sum of
    squares are all-reduced, differentiably, so each rank's gradient sees
    every rank's outputs.  Returns ``(out, mean, var)``, the statistics
    detached."""
    from ..parallel import allreduce_sum_grad, batch_stats_ranks
    red = [i for i in range(xf.dim()) if i != 1]
    bshape = (1, -1) + (1,) * (xf.dim() - 2)
    n = xf.numel() // xf.shape[1] * batch_stats_ranks()
    mean = allreduce_sum_grad(xf.sum(dim=red), "BatchNorm global mean")
    mean = mean / n
    d = xf - mean.reshape(bshape)
    var = allreduce_sum_grad((d * d).sum(dim=red), "BatchNorm global var")
    var = var / n
    out = d * torch.rsqrt(var + eps).reshape(bshape) * g.reshape(bshape) \
        + beta.reshape(bshape)
    return out, mean.detach(), var.detach()


@register("InstanceNorm", inputs=("data", "gamma", "beta"),
          params=dict(eps=attr_float(1e-3)))
def _instance_norm(attrs, x, gamma, beta):
    x = _int_to_f32(x)
    red = tuple(range(2, x.dim()))
    var, mean = torch.var_mean(x, dim=red, correction=0, keepdim=True)
    bshape = (1, -1) + (1,) * (x.dim() - 2)
    return (x - mean) * torch.rsqrt(var + attrs.eps) * \
        gamma.reshape(bshape) + beta.reshape(bshape)


@register("LRN", inputs=("data",),
          params=dict(alpha=attr_float(1e-4), beta=attr_float(0.75),
                      knorm=attr_float(2.0), nsize=attr_int(required=True)))
def _lrn(attrs, x):
    """Local response norm across channels: ``x * (knorm + alpha/n *
    sum of x^2 over n neighbouring channels)^-beta``."""
    x = _int_to_f64(x)     # integer data: float64, as in the reference
    n = attrs.nsize
    half = n // 2
    sq = F.pad((x * x).movedim(1, -1), (half, half))
    ssum = sq.unfold(-1, n, 1).sum(-1).movedim(-1, 1)
    return x * torch.pow(attrs.knorm + attrs.alpha / n * ssum, -attrs.beta)


# ---------------------------------------------------------------------------
# Dropout
# ---------------------------------------------------------------------------

def _generator(gen, x):
    """The generator a random op draws from: the one its caller handed
    it, else the device generator of ``x``'s device."""
    if gen is not None:
        return gen
    from ..rng import next_generator
    return next_generator(x.device)


@register("Dropout", inputs=("data",),
          params=dict(p=attr_float(0.5), mode=attr_str("training"),
                      axes=attr_shape(())),
          needs_rng=True, mode_dependent=True,
          num_outputs=2, num_visible_outputs=1)
def _dropout(attrs, gen, x):
    """In training (or ``mode="always"``) keep each element with
    probability ``1-p`` and scale the kept ones by ``1/(1-p)``; the mask
    is drawn once along each axis of ``axes`` and broadcast.  Returns
    the output and the (scaled) mask."""
    train = attrs.get("_train", False) or attrs.mode == "always"
    if not train or attrs.p <= 0:
        return x, torch.ones_like(x)
    x = _int_to_f64(x)     # integer data: float64, as in the reference
    shape = list(x.shape)
    for ax in (attrs.axes or ()):
        shape[ax] = 1
    keep = 1.0 - attrs.p
    u = torch.rand(shape, generator=_generator(gen, x), device=x.device)
    mask = (u < keep).to(x.dtype) / keep
    return x * mask, mask.expand(x.shape)


# ---------------------------------------------------------------------------
# SoftmaxOutput: the loss head with the reference's own backward
# ---------------------------------------------------------------------------

def _softmax_fwd(attrs, d):
    d = _int_to_f32(d)
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


def _global_count(n, dp, device):
    """A batch or valid count ``n`` (a number or a 0-d tensor) of this
    rank, or, under a dp trainer (``dp``: :func:`_dp_global_batch`), summed
    over the ranks on ``device`` (the gradient's: NCCL takes no host
    tensor): the JAX package's partitioned step normalises a loss head by
    the global batch."""
    if not dp:
        return n
    from ..parallel import allreduce_sum_grad
    t = torch.as_tensor(n, dtype=torch.float32, device=device).reshape(1)
    return allreduce_sum_grad(t, "loss head normaliser")[0]


def _softmax_output_grad(attrs, dshape, prob, lab, g, dp=False):
    """``(softmax - one_hot(label)) * grad_scale / normalizer`` (times
    the incoming ``g`` only under ``out_grad``); under a dp trainer the
    normalizer counts the global batch."""
    if attrs.multi_output and len(dshape) > 2:
        # label (N, spatial...), prob (N, C, spatial...)
        li = lab.long()
        grad = prob - _one_hot(li, dshape[1], 1, prob.dtype)
        if attrs.use_ignore:
            keep = lab != attrs.ignore_label
            grad = grad * keep.unsqueeze(1).to(grad.dtype)
            valid = keep.sum().to(grad.dtype)
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
            valid = keep.sum().to(grad.dtype)
        else:
            valid = float(np.prod(tuple(li.shape)))
        grad = grad.reshape(dshape)
    if attrs.normalization == "batch":
        grad = grad / _global_count(dshape[0], dp, grad.device)
    elif attrs.normalization == "valid":
        if dp:
            valid = _global_count(valid, dp, grad.device).to(grad.dtype)
        grad = grad / (torch.clamp(valid, min=1) if torch.is_tensor(valid)
                       else valid)
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
        ctx.dp = _dp_global_batch()
        ctx.data_shape = tuple(data.shape)
        ctx.save_for_backward(prob, label)
        return prob

    @staticmethod
    def backward(ctx, g):
        prob, label = ctx.saved_tensors
        return (_softmax_output_grad(ctx.attrs, ctx.data_shape, prob, label,
                                     g, ctx.dp), None, None)


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
# The other loss heads
# ---------------------------------------------------------------------------

class _HeadFn(torch.autograd.Function):
    """A loss head: forward ``fwd(data)``, backward ``grad(data, label)``
    in place of the incoming gradient (the reference's heads ignore it);
    the label gets no gradient."""

    @staticmethod
    def forward(ctx, data, label, fwd, grad):
        ctx.grad = grad
        ctx.save_for_backward(data, label)
        return fwd(data)

    @staticmethod
    def backward(ctx, g):
        data, label = ctx.saved_tensors
        return ctx.grad(data, label).to(data.dtype), None, None, None


def _make_regression(name, fwd, grad):
    """``*RegressionOutput``: ``grad(fwd(d), label) * grad_scale`` over the
    elements of one example (``prod(shape) / shape[0]``)."""

    @register(name, inputs=("data", "label"),
              params=dict(grad_scale=attr_float(1.0)))
    def _op(attrs, data, label):
        def _grad(d, lab):
            num = float(np.prod(tuple(d.shape)) / d.shape[0])
            return grad(fwd(d), lab.reshape(d.shape)) * attrs.grad_scale \
                / num
        return _HeadFn.apply(data, label, fwd, _grad)
    return _op


_make_regression("LinearRegressionOutput", lambda d: d, lambda o, l: o - l)
_make_regression("MAERegressionOutput", lambda d: d,
                 lambda o, l: torch.sign(o - l))
_make_regression("LogisticRegressionOutput", torch.sigmoid,
                 lambda o, l: o - l)


class _MakeLossFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, attrs):
        ctx.attrs = attrs
        ctx.dp = _dp_global_batch()
        ctx.save_for_backward(data)
        return data.view_as(data)

    @staticmethod
    def backward(ctx, g):
        (d,) = ctx.saved_tensors
        attrs = ctx.attrs
        scale = attrs.grad_scale
        if attrs.normalization == "batch":
            scale = scale / _global_count(d.shape[0], ctx.dp, d.device)
        elif attrs.normalization == "valid":
            valid = (d > attrs.valid_thresh).sum()
            if ctx.dp:
                valid = _global_count(valid, ctx.dp, d.device)
            scale = scale / torch.clamp(valid, min=1).to(d.dtype)
        return torch.ones_like(d) * scale, None


@register("MakeLoss", inputs=("data",),
          params=dict(grad_scale=attr_float(1.0),
                      valid_thresh=attr_float(0.0),
                      normalization=attr_str("null")))
def _make_loss(attrs, data):
    """Forward identity; backward ``grad_scale``, divided by the batch
    (``normalization="batch"``) or by the count of elements above
    ``valid_thresh`` (``"valid"``)."""
    return _MakeLossFn.apply(data, attrs)


@register("SVMOutput", inputs=("data", "label"),
          params=dict(margin=attr_float(1.0),
                      regularization_coefficient=attr_float(1.0),
                      use_linear=attr_bool(False)))
def _svm_output(attrs, data, label):
    """Forward identity; backward the linear (``use_linear``) or squared
    hinge gradient of the one-vs-rest margin (reference svm_output-inl.h)."""

    def grad(d, lab):
        # a label past the axis reads NaN, a negative one counts from the
        # end (the reference's take_along_axis); its one-hot row is zero
        li = lab.long()
        oh = _one_hot(li, d.shape[1], -1, d.dtype)
        i, ok = _in_range(li[:, None], d.shape[1])
        correct = _fill(d.gather(1, i), ok)
        c = attrs.regularization_coefficient
        if attrs.use_linear:
            g = ((d - correct + attrs.margin) > 0).to(d.dtype) * c * (1 - oh)
        else:
            g = 2 * c * torch.clamp(d - correct + attrs.margin, min=0) \
                * (1 - oh)
        return g - oh * g.sum(dim=1, keepdim=True)

    return _HeadFn.apply(data, label, lambda d: d.view_as(d), grad)


_NEG_INF = -1e30


@register("CTCLoss", inputs=("data", "label"),
          params=dict(use_data_lengths=attr_bool(False),
                      use_label_lengths=attr_bool(False),
                      blank_label=attr_str("first")),
          aliases=("ctc_loss", "_contrib_CTCLoss", "_contrib_ctc_loss"))
def _ctc_loss(attrs, data, label):
    """The loss of each example, from ``data`` (T, N, C) of unnormalised
    activations and ``label`` (N, L): the reference's alpha recursion in
    log space over the blank-extended labels, with -1e30 for an
    impossible state (so an impossible alignment costs about 1e30, not
    inf).  ``blank_label="first"``: channel 0 is the blank and label 0
    pads; ``"last"``: channel C-1 is the blank and a negative label pads.
    A row of padding only is the empty label; a label at or past the
    alphabet's size emits NaN, so its example's loss is NaN, as the
    reference's take_along_axis gives.  The gradient is autograd's
    through the recursion."""
    T, N, C = data.shape
    logp = torch.log_softmax(_int_to_f32(data), dim=-1)
    first = attrs.blank_label == "first"
    blank = 0 if first else C - 1
    lab = label.long()
    lab = torch.where(lab == 0 if first else lab < 0, -1, lab)
    L = lab.shape[1]
    S = 2 * L + 1
    ext = torch.full((N, S), blank, dtype=torch.long, device=data.device)
    ext[:, 1::2] = torch.where(lab >= 0, lab, blank)
    lab_len = (lab >= 0).sum(dim=1)
    ext_len = 2 * lab_len + 1
    ext_m2 = F.pad(ext[:, :-2], (2, 0), value=-2)
    allow2 = (ext != blank) & (ext != ext_m2)
    neg = torch.full((N, S), _NEG_INF, dtype=logp.dtype, device=data.device)
    ext_i, ext_ok = _in_range(ext, C)

    def emit(lp):
        return _fill(lp.gather(1, ext_i), ext_ok)

    emit0 = emit(logp[0])
    alpha = torch.where(torch.arange(S, device=data.device) == 0, emit0, neg)
    alpha = torch.where((torch.arange(S, device=data.device) == 1)
                        & (lab_len > 0)[:, None], emit0, alpha)
    for t in range(1, T):
        a1 = F.pad(alpha[:, :-1], (1, 0), value=_NEG_INF)
        a2 = F.pad(alpha[:, :-2], (2, 0), value=_NEG_INF)
        merged = torch.logaddexp(alpha, a1)
        merged = torch.where(allow2, torch.logaddexp(merged, a2), merged)
        alpha = merged + emit(logp[t])
    last = alpha.gather(1, (ext_len - 1)[:, None])[:, 0]
    last2 = torch.where(
        lab_len > 0,
        alpha.gather(1, torch.clamp(ext_len - 2, min=0)[:, None])[:, 0],
        torch.full_like(last, _NEG_INF))
    return -torch.logaddexp(last, last2)


@register("softmax_cross_entropy", inputs=("data", "label"))
def _softmax_cross_entropy(attrs, data, label):
    """The total softmax cross-entropy as a length-1 array.  A label past
    the class axis picks NaN and a negative one counts from the end, as
    the reference's take_along_axis (no host sync, no device assert)."""
    logp = torch.log_softmax(_int_to_f32(data), dim=-1)
    i, ok = _in_range(label.long()[:, None], logp.shape[-1])
    picked = _fill(logp.gather(-1, i), ok)[:, 0]
    return -picked.sum()[None]


class _KLSparseRegFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, rho, penalty):
        ctx.rho, ctx.penalty = rho, penalty
        ctx.save_for_backward(x)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        rho = ctx.rho
        rho_hat = torch.clamp(x.mean(dim=0, keepdim=True), 1e-6, 1 - 1e-6)
        reg = ctx.penalty * (-rho / rho_hat + (1 - rho) / (1 - rho_hat))
        return g + reg.to(g.dtype), None, None


@register("IdentityAttachKLSparseReg", inputs=("data",),
          params=dict(sparseness_target=attr_float(0.1),
                      penalty=attr_float(0.001), momentum=attr_float(0.9)))
def _identity_attach_kl_sparse_reg(attrs, x):
    """Identity forward; the backward adds ``penalty * (-rho/rho_hat +
    (1-rho)/(1-rho_hat))``, with ``rho_hat`` the current batch's mean
    activation (the reference keeps a momentum-smoothed copy only for
    logging)."""
    return _KLSparseRegFn.apply(x, attrs.sparseness_target, attrs.penalty)


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


class _FlashRematFn(torch.autograd.Function):
    """``MXNET_TPU_FLASH_BWD=remat``: the forward is the flash kernel
    (without the logsumexp), the backward the einsum formulation's own
    autograd backward over the saved q, k and v (the reference's
    rematerialising vjp of ``naive``)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        out, _ = kernels.flash_attention_fwd(q, k, v, causal, scale,
                                             with_lse=False)
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v = (t.detach().requires_grad_() for t in ctx.saved_tensors)
        with torch.enable_grad():
            out = _attention_einsum(q, k, v, ctx.causal, ctx.scale)
        return torch.autograd.grad(out, (q, k, v), g) + (None, None)


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
    tile themselves.  ``MXNET_TPU_FLASH_BWD`` other than "pallas" keeps
    the flash forward and takes the einsum formulation's backward, as
    the reference's ``remat`` fallback (:class:`_FlashRematFn`)."""
    scale = attrs.scale if attrs.scale > 0 else \
        1.0 / float(q.shape[-1]) ** 0.5
    if attrs.block_q < 0:
        raise MXNetError("fused_attention: block_q must be >= 0 "
                         "(0 = autotuned), got %d" % attrs.block_q)
    flash_min = attrs.flash_min_seq or FLASH_MIN_SEQ
    if q.shape[1] < flash_min:
        return _attention_einsum(q, k, v, attrs.causal, scale)
    if _FLASH_BWD != "pallas":
        return _FlashRematFn.apply(q, k, v, bool(attrs.causal), scale)
    return kernels.flash_attention(q, k, v, causal=attrs.causal,
                                   scale=scale)
