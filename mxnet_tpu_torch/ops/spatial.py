"""Spatial sampling, warping and correlation ops (port of
``mxnet_tpu/ops/spatial.py``; reference src/operator/
spatial_transformer-inl.h, bilinear_sampler-inl.h, grid_generator-inl.h,
correlation-inl.h, crop-inl.h, image/image_random.cc).

Each op is PyTorch tensor code, as the JAX package's is jnp code; no
hand-written kernel is on their path, and autograd gives the gradients
for the data and the grid.  The JAX op's numerics are kept: the grids
and the sampler compute in float32 and the sampler's and correlation's
outputs come back in the data's dtype.  The sampler's normalised
coordinates are ``grid_sample``'s with ``align_corners=True``, zero
outside the image.  ``Correlation`` reads the second map shifted with
wrap-around (the JAX op's ``roll``), sums the ``k x k`` window of the
channel products (or absolute differences) from the displacement border
on, and divides by ``k * k * c``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..base import (MXNetError, attr_bool, attr_float_tuple, attr_int,
                    attr_shape, attr_str)
from .registry import register


# ---------------------------------------------------------------------------
# grid generation + bilinear sampling
# ---------------------------------------------------------------------------

def _affine_grid(theta, th, tw):
    """theta (n, 6) -> sampling grid (n, 2, th, tw), coords in [-1, 1]."""
    n = theta.shape[0]
    dev = theta.device
    xt = torch.linspace(-1.0, 1.0, tw, dtype=torch.float64, device=dev)
    yt = torch.linspace(-1.0, 1.0, th, dtype=torch.float64, device=dev)
    yy, xx = torch.meshgrid(yt, xt, indexing="ij")
    base = torch.stack([xx, yy, torch.ones_like(xx)]).reshape(3, th * tw)
    grid = torch.einsum("nij,jk->nik", theta.reshape(n, 2, 3).float(),
                        base.float())
    return grid.reshape(n, 2, th, tw)


def _warp_grid(flow):
    """flow (n, 2, h, w) pixel offsets -> normalized grid (n, 2, h, w)."""
    _, _, h, w = flow.shape
    xs = torch.arange(w, dtype=torch.float32, device=flow.device)
    ys = torch.arange(h, dtype=torch.float32, device=flow.device)
    yy, xx = torch.meshgrid(ys, xs, indexing="ij")
    gx = (xx + flow[:, 0]) * (2.0 / max(w - 1, 1)) - 1.0
    gy = (yy + flow[:, 1]) * (2.0 / max(h - 1, 1)) - 1.0
    return torch.stack([gx, gy], dim=1)


def _bilinear_sample(data, grid):
    """data (n, c, h, w), grid (n, 2, th, tw) normalized -> (n, c, th,
    tw), zero outside the image."""
    out = F.grid_sample(data.float(), grid.float().permute(0, 2, 3, 1),
                        mode="bilinear", padding_mode="zeros",
                        align_corners=True)
    return out.to(data.dtype)


@register("GridGenerator", inputs=("data",),
          params=dict(transform_type=attr_str(required=True),
                      target_shape=attr_shape((0, 0))))
def _grid_generator(attrs, data):
    """reference: src/operator/grid_generator-inl.h"""
    if attrs.transform_type == "affine":
        th, tw = attrs.target_shape
        if th <= 0 or tw <= 0:
            raise MXNetError("GridGenerator(affine) needs target_shape")
        return _affine_grid(data, th, tw)
    if attrs.transform_type == "warp":
        return _warp_grid(data)
    raise MXNetError("unknown transform_type %r" % (attrs.transform_type,))


@register("BilinearSampler", inputs=("data", "grid"))
def _bilinear_sampler(attrs, data, grid):
    """reference: src/operator/bilinear_sampler-inl.h"""
    return _bilinear_sample(data, grid)


@register("SpatialTransformer", inputs=("data", "loc"),
          params=dict(target_shape=attr_shape(required=True),
                      transform_type=attr_str("affine"),
                      sampler_type=attr_str("bilinear")))
def _spatial_transformer(attrs, data, loc):
    """reference: src/operator/spatial_transformer-inl.h: an affine grid
    from the localisation net's output, then bilinear sampling."""
    if attrs.transform_type != "affine" or attrs.sampler_type != "bilinear":
        raise MXNetError("SpatialTransformer supports affine/bilinear")
    th, tw = attrs.target_shape
    return _bilinear_sample(data, _affine_grid(loc, th, tw))


# ---------------------------------------------------------------------------
# Correlation (FlowNet-style cost volume)
# ---------------------------------------------------------------------------

@register("Correlation", inputs=("data1", "data2"),
          params=dict(kernel_size=attr_int(1), max_displacement=attr_int(1),
                      stride1=attr_int(1), stride2=attr_int(1),
                      pad_size=attr_int(0), is_multiply=attr_bool(True)))
def _correlation(attrs, data1, data2):
    """reference: src/operator/correlation-inl.h: patch correlation of
    two feature maps over a displacement neighbourhood, (n, (2 md / s2 +
    1)^2, out_h, out_w).  Output pixel (y, x) and window tap (a, b) read
    the first map at (md + y s1 + a, md + x s1 + b) and the second there
    shifted by the displacement, modulo the padded size."""
    k, md = attrs.kernel_size, attrs.max_displacement
    s1, s2, p = attrs.stride1, attrs.stride2, attrs.pad_size
    border = md + (k - 1) // 2
    n, c, h, w = data1.shape
    pads = (p, p, p, p)
    f1 = F.pad(data1.float(), pads)
    f2 = F.pad(data2.float(), pads)
    hp, wp = h + 2 * p, w + 2 * p
    out_h = (hp - 2 * border - 1) // s1 + 1
    out_w = (wp - 2 * border - 1) // s1 + 1
    if out_h <= 0 or out_w <= 0:
        raise MXNetError("Correlation: output would be empty")
    dev = data1.device
    rows = md + s1 * torch.arange(out_h, device=dev)
    cols = md + s1 * torch.arange(out_w, device=dev)
    taps = [(a, b, f1.index_select(2, rows + a).index_select(3, cols + b))
            for a in range(k) for b in range(k)]
    ngr = md // s2
    planes = []
    for dy in range(-ngr, ngr + 1):
        for dx in range(-ngr, ngr + 1):
            plane = 0
            for a, b, t1 in taps:
                t2 = f2.index_select(2, (rows + a + dy * s2) % hp) \
                       .index_select(3, (cols + b + dx * s2) % wp)
                plane = plane + ((t1 * t2).sum(1) if attrs.is_multiply
                                 else (t1 - t2).abs().sum(1))
            planes.append(plane / (k * k * c))
    return torch.stack(planes, dim=1).to(data1.dtype)


# ---------------------------------------------------------------------------
# legacy Crop
# ---------------------------------------------------------------------------

def _crop_inputs(attrs, num_args=None):
    n = (attrs.get("num_args") if attrs else None) or num_args or 1
    return ["data"] if n == 1 else ["data", "crop_like"]


@register("Crop", inputs=_crop_inputs,
          params=dict(num_args=attr_int(1), offset=attr_shape((0, 0)),
                      h_w=attr_shape((0, 0)), center_crop=attr_bool(False)))
def _crop(attrs, data, *rest):
    """reference: src/operator/crop-inl.h: crop data to h_w (or to the
    spatial size of crop_like when num_args=2)."""
    _, _, h, w = data.shape
    if rest:
        th, tw = rest[0].shape[2], rest[0].shape[3]
    else:
        th, tw = attrs.h_w
    if th <= 0 or tw <= 0 or th > h or tw > w:
        raise MXNetError("Crop: invalid target size (%d, %d)" % (th, tw))
    if attrs.center_crop:
        y0, x0 = (h - th) // 2, (w - tw) // 2
    else:
        y0, x0 = attrs.offset
    if y0 + th > h or x0 + tw > w:
        raise MXNetError("Crop: offset out of range")
    return data[:, :, y0:y0 + th, x0:x0 + tw]


# ---------------------------------------------------------------------------
# Image transform ops (reference src/operator/image/image_random.cc
# _image_to_tensor / _image_normalize, the gluon transforms' backend)
# ---------------------------------------------------------------------------

@register("_image_to_tensor", inputs=("data",),
          aliases=("image_to_tensor",))
def _image_to_tensor(attrs, x):
    """HWC (or NHWC) uint8 [0,255] -> CHW (NCHW) float32 [0,1]."""
    out = x.float() / 255.0
    if out.dim() == 3:
        return out.permute(2, 0, 1)
    return out.permute(0, 3, 1, 2)


@register("_image_normalize", inputs=("data",),
          params=dict(mean=attr_float_tuple(None),
                      std=attr_float_tuple(None)),
          aliases=("image_normalize",))
def _image_normalize(attrs, x):
    """Per-channel (x - mean) / std on CHW (or NCHW) float input."""
    shape = [1] * x.dim()
    shape[0 if x.dim() == 3 else 1] = -1
    out = x
    if attrs.mean is not None:
        out = out - torch.tensor(attrs.mean, dtype=x.dtype,
                                 device=x.device).reshape(shape)
    if attrs.std is not None:
        out = out / torch.tensor(attrs.std, dtype=x.dtype,
                                 device=x.device).reshape(shape)
    return out
