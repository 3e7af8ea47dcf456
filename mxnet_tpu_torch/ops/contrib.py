"""Contrib and detection operators (port of ``mxnet_tpu/ops/contrib.py``;
reference src/operator/contrib/: multibox_prior/target/detection (SSD),
roi_pooling-inl.h, proposal and multi_proposal (R-CNN), psroi_pooling and
the deformable ops (R-FCN), bounding_box.cc (box_iou,
bipartite_matching, box_nms), fft/ifft, count_sketch,
quantize/dequantize).

Each op is PyTorch tensor code over the batch, as the JAX package's is
``vmap``-ed jnp code, with one exception: the greedy suppression of
MultiBoxDetection, Proposal, MultiProposal and box_nms, which the JAX
package runs as a ``lax.fori_loop`` over every box, is the hand-written
kernel :func:`~mxnet_tpu_torch.ops.kernels.greedy_nms` (``csrc/nms.cu``;
its plain version on the CPU).  Gradients are torch autograd's.

The JAX op's numerics are kept where they decide a result:

* the reference runs with x64 on, so the box decoders and anchor
  generators compute in float64 where the JAX op promotes to it (the
  variances are a float64 array; Proposal's anchors are float64, and so
  are its rois); MultiBoxDetection's and Proposal's NMS run on float64
  boxes, box_nms's on the data's dtype;
* sorts are stable and ``top_k`` takes the lower index first among
  ties, as ``jnp.argsort`` and ``lax.top_k`` do (``torch.topk`` on CUDA
  does not promise it);
* MultiBoxTarget's forced matches write per anchor the highest gt index
  that chose it, as XLA's scatter keeps the last write; CUDA's
  ``index_put_`` would leave the winner undefined;
* ROIPooling takes its max over index windows, first along the columns
  and then along the rows of each bin, and PSROIPooling its averages
  from a float64 integral image, so neither builds the JAX op's H x W
  mask per ROI bin (300 ROIs x 7 x 7 x 512 channels x 38 x 63 at Faster
  R-CNN's size).  The max's gradient splits among tied elements row by
  row, where the JAX op splits it evenly over the bin.

The reference's own quirks are kept, not fixed: MultiBoxDetection
ignores ``nms_topk`` and ``force_suppress`` (one class-agnostic NMS),
MultiBoxTarget ignores ``negative_mining_ratio`` and
``minimum_negative_samples``, DeformableConvolution reads the first
deformable group only and ignores ``num_group``, and Proposal reads
image 0 only.
"""
from __future__ import annotations

import ast

import numpy as np
import torch

from ..base import (Param, attr_bool, attr_float, attr_int, attr_shape,
                    attr_str, dtype_torch)
from . import kernels
from .elemwise import _saturating_cast
from .registry import register

_F64 = torch.float64


def _parse_floats(v, default):
    if v is None:
        return default
    if isinstance(v, str):
        v = ast.literal_eval(v)
    if isinstance(v, (int, float)):
        return (float(v),)
    return tuple(float(x) for x in v)


def _floats(default):
    return Param(lambda v: _parse_floats(v, default), default,
                 kind="tuple of floats")


def _meta(t):
    """Shape inference runs the ops on ``meta`` tensors; the ops that
    read values to size their work answer it with an empty tensor."""
    return t.device.type == "meta"


def _gather_rows(x, idx):
    """``x[b, idx[b]]`` for every image b: x (B, n, ...), idx (B, m)."""
    shape = idx.shape + x.shape[2:]
    flat = idx.reshape(idx.shape + (1,) * (x.dim() - 2)).expand(shape)
    return torch.gather(x, 1, flat)


def _sort(keys, descending=False):
    """Stable sort along dim 1: ties keep their index order, as
    ``jnp.argsort`` and ``lax.top_k`` (lower index first) do."""
    return torch.sort(keys, dim=1, descending=descending, stable=True)


# ---------------------------------------------------------------------------
# SSD multibox family
# ---------------------------------------------------------------------------

@register("_contrib_MultiBoxPrior", inputs=("data",),
          params=dict(sizes=_floats((1.0,)), ratios=_floats((1.0,)),
                      clip=attr_bool(False), steps=_floats((-1.0, -1.0)),
                      offsets=_floats((0.5, 0.5))),
          aliases=("MultiBoxPrior", "_contrib_multibox_prior"))
def _multibox_prior(attrs, data):
    """Anchor generation (reference contrib/multibox_prior-inl.h): per pixel
    num_sizes + num_ratios - 1 boxes, corner format, normalised; computed
    in float64 (the JAX op's x64 arange) and returned in data's dtype."""
    h, w = data.shape[2], data.shape[3]
    dev = data.device
    step_y = attrs.steps[0] if attrs.steps[0] > 0 else 1.0 / h
    step_x = attrs.steps[1] if attrs.steps[1] > 0 else 1.0 / w
    cy = (torch.arange(h, dtype=_F64, device=dev) + attrs.offsets[0]) \
        * step_y
    cx = (torch.arange(w, dtype=_F64, device=dev) + attrs.offsets[1]) \
        * step_x
    # anchor sizes: sizes with ratio[0], then ratios[1:] with size[0]
    whs = [(s * np.sqrt(attrs.ratios[0]), s / np.sqrt(attrs.ratios[0]))
           for s in attrs.sizes]
    whs += [(attrs.sizes[0] * np.sqrt(r), attrs.sizes[0] / np.sqrt(r))
            for r in attrs.ratios[1:]]
    whs = torch.tensor(whs, dtype=_F64, device=dev)       # (A, 2) of (w, h)
    half_w, half_h = whs[:, 0] / 2, whs[:, 1] / 2
    cy, cx = cy[:, None, None], cx[None, :, None]
    out = torch.stack(torch.broadcast_tensors(
        cx - half_w, cy - half_h, cx + half_w, cy + half_h), dim=-1)
    out = out.reshape(-1, 4)
    if attrs.clip:
        out = out.clamp(0.0, 1.0)
    return out[None].to(data.dtype)


def _box_iou(a, b):
    """a: (N, 4), b: (M, 4) corner boxes -> (N, M) IoU, in the JAX op's
    order of operations."""
    zero = torch.zeros((), dtype=a.dtype, device=a.device)
    ix0 = torch.maximum(a[:, None, 0], b[None, :, 0])
    iy0 = torch.maximum(a[:, None, 1], b[None, :, 1])
    ix1 = torch.minimum(a[:, None, 2], b[None, :, 2])
    iy1 = torch.minimum(a[:, None, 3], b[None, :, 3])
    iw = torch.maximum(ix1 - ix0, zero)
    ih = torch.maximum(iy1 - iy0, zero)
    inter = iw * ih
    area_a = torch.maximum((a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1]), zero)
    area_b = torch.maximum((b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1]), zero)
    union = area_a[:, None] + area_b[None, :] - inter
    return inter / torch.maximum(union, torch.full_like(zero, 1e-12))


def _anchor_geometry(anchors):
    """Widths, heights and centres of corner anchors (N, 4)."""
    aw = anchors[:, 2] - anchors[:, 0]
    ah = anchors[:, 3] - anchors[:, 1]
    acx = (anchors[:, 0] + anchors[:, 2]) / 2
    acy = (anchors[:, 1] + anchors[:, 3]) / 2
    return aw, ah, acx, acy


@register("_contrib_MultiBoxTarget",
          inputs=("anchor", "label", "cls_pred"),
          params=dict(overlap_threshold=attr_float(0.5),
                      ignore_label=attr_float(-1.0),
                      negative_mining_ratio=attr_float(-1.0),
                      negative_mining_thresh=attr_float(0.5),
                      minimum_negative_samples=attr_int(0),
                      variances=_floats((0.1, 0.1, 0.2, 0.2))),
          num_outputs=3,
          aliases=("MultiBoxTarget", "_contrib_multibox_target"))
def _multibox_target(attrs, anchor, label, cls_pred):
    """Anchor matching + target encoding (reference multibox_target-inl.h).
    anchor (1,N,4); label (B,M,5) padded -1; cls_pred (B,C,N).
    Returns loc_target (B,N*4), loc_mask (B,N*4), cls_target (B,N).
    Each valid gt's best anchor is matched to it (when two gts share one,
    the higher gt index wins, as the JAX op's scatter leaves it), every
    other anchor to its best gt when the IoU reaches the threshold."""
    anchors = anchor[0]
    N = anchors.shape[0]
    B, M = label.shape[0], label.shape[1]
    var = attrs.variances
    valid = label[:, :, 0] >= 0                                   # (B, M)
    gt = label[:, :, 1:5]
    iou = _box_iou(anchors, gt.reshape(-1, 4)).reshape(N, B, M) \
        .permute(1, 0, 2)                                         # (B, N, M)
    iou = torch.where(valid[:, None, :], iou, torch.full_like(iou, -1.0))
    best_gt = iou.argmax(2)                                       # (B, N)
    best_iou = iou.amax(2)
    best_anchor = iou.argmax(1)                                   # (B, M)
    gidx = torch.arange(M, device=label.device).expand(B, M)
    slot = torch.where(valid, best_anchor, torch.full_like(best_anchor, N))
    forced_gt = torch.full((B, N + 1), -1, dtype=torch.long,
                           device=label.device).scatter_reduce(
        1, slot, gidx, "amax")[:, :N]
    forced = forced_gt >= 0
    pos = forced | (best_iou >= attrs.overlap_threshold)
    match = torch.where(forced, forced_gt, best_gt)
    g = _gather_rows(gt, match)                                   # (B, N, 4)
    aw, ah, acx, acy = _anchor_geometry(anchors)
    gw = torch.clamp_min(g[..., 2] - g[..., 0], 1e-12)
    gh = torch.clamp_min(g[..., 3] - g[..., 1], 1e-12)
    gcx = (g[..., 0] + g[..., 2]) / 2
    gcy = (g[..., 1] + g[..., 3]) / 2
    aw_, ah_ = torch.clamp_min(aw, 1e-12), torch.clamp_min(ah, 1e-12)
    # the JAX op divides by its float64 variances array: f32 -> f64 there
    loc_t = torch.stack([((gcx - acx) / aw_).double() / var[0],
                         ((gcy - acy) / ah_).double() / var[1],
                         torch.log(gw / aw_).double() / var[2],
                         torch.log(gh / ah_).double() / var[3]], dim=-1)
    mask = pos[..., None].to(anchors.dtype)                       # (B, N, 1)
    cls_t = torch.where(pos, torch.gather(label[:, :, 0], 1, match) + 1,
                        torch.zeros((), dtype=label.dtype,
                                    device=label.device))
    dt = cls_pred.dtype
    return ((loc_t * mask).reshape(B, -1).to(dt),
            mask.expand(B, N, 4).reshape(B, -1).to(dt), cls_t.to(dt))


@register("_contrib_MultiBoxDetection",
          inputs=("cls_prob", "loc_pred", "anchor"),
          params=dict(clip=attr_bool(True), threshold=attr_float(0.01),
                      background_id=attr_int(0), nms_threshold=attr_float(0.5),
                      force_suppress=attr_bool(False),
                      variances=_floats((0.1, 0.1, 0.2, 0.2)),
                      nms_topk=attr_int(-1)),
          aliases=("MultiBoxDetection", "_contrib_multibox_detection"))
def _multibox_detection(attrs, cls_prob, loc_pred, anchor):
    """Decode + NMS (reference multibox_detection-inl.h).  cls_prob (B,C,N),
    loc_pred (B,N*4), anchor (1,N,4) -> (B, N, 6) rows [cls_id, score,
    xmin, ymin, xmax, ymax], cls_id=-1 pad.  The boxes decode in float64
    (the JAX op's variances) and are suppressed class-agnostically by one
    launch of the NMS kernel over the batch."""
    anchors = anchor[0]
    N = anchors.shape[0]
    B, C = cls_prob.shape[0], cls_prob.shape[1]
    var = attrs.variances
    aw, ah, acx, acy = (t.double() for t in _anchor_geometry(anchors))
    loc = loc_pred.reshape(B, N, 4).double()
    cx = loc[..., 0] * var[0] * aw + acx
    cy = loc[..., 1] * var[1] * ah + acy
    w = torch.exp(loc[..., 2] * var[2]) * aw
    h = torch.exp(loc[..., 3] * var[3]) * ah
    boxes = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2],
                        dim=-1)
    if attrs.clip:
        boxes = boxes.clamp(0.0, 1.0)
    # best non-background class per anchor
    bg = torch.tensor([attrs.background_id % C], device=cls_prob.device)
    cls_scores = cls_prob.index_fill(1, bg, -1.0)
    best_cls = cls_scores.argmax(1)                               # (B, N)
    best_score = cls_scores.amax(1)
    keep = best_score > attrs.threshold
    neg_inf = torch.full_like(best_score, float("-inf"))
    order = _sort(-torch.where(keep, best_score, neg_inf)).indices
    sboxes = _gather_rows(boxes, order)
    sscores = torch.gather(torch.where(keep, best_score,
                                       torch.full_like(best_score, -1.0)),
                           1, order)
    scls = torch.gather(best_cls, 1, order)
    # the kept boxes sort first, so a suppressor outside them would only
    # touch boxes the threshold drops below
    nms_keep = kernels.greedy_nms(sboxes, attrs.nms_threshold,
                                  valid=torch.gather(keep, 1, order))
    final = nms_keep & (sscores > attrs.threshold)
    cls_out = torch.where(final, scls.to(cls_prob.dtype),
                          torch.full_like(sscores, -1.0))
    score_out = torch.where(final, sscores, torch.zeros_like(sscores))
    out = torch.cat([cls_out[..., None].double(),
                     score_out[..., None].double(), sboxes], dim=-1)
    return out.to(cls_prob.dtype)


# ---------------------------------------------------------------------------
# ROI pooling (reference src/operator/roi_pooling-inl.h)
# ---------------------------------------------------------------------------

def _window_max(slabs, n, group, first, end):
    """Max over index windows along a cut axis: ``slabs`` (G*n, ...) holds
    n slabs per group g; window w of output row r covers group
    ``group[r]``'s slabs ``[first[r, w], end[r, w])``.  Returns (R, W,
    ...), -inf where a window is empty."""
    span = max(int((end - first).max()), 1) if first.numel() else 1
    idx = first[..., None] + torch.arange(span, device=first.device)
    inside = idx < end[..., None]                            # (R, W, span)
    flat = group[:, None, None] * n + idx.clamp(max=n - 1)
    got = slabs.index_select(0, flat.reshape(-1)) \
        .reshape(flat.shape + slabs.shape[1:])
    mask = inside.reshape(inside.shape + (1,) * (slabs.dim() - 1))
    return got.masked_fill(~mask, float("-inf")).amax(2)


@register("ROIPooling", inputs=("data", "rois"),
          params=dict(pooled_size=attr_shape(required=True),
                      spatial_scale=attr_float(required=True)),
          aliases=("_contrib_ROIPooling",))
def _roi_pooling(attrs, data, rois):
    """data (B,C,H,W), rois (R,5) [batch_idx,x1,y1,x2,y2] image coords ->
    (R, C, ph, pw), the max over each bin (0 where a bin is empty).  The
    bins' integer bounds are the JAX op's; the max runs over index windows,
    along the columns of each bin's column range for every row, then
    along its rows."""
    ph, pw = attrs.pooled_size
    B, C, H, W = data.shape
    R = rois.shape[0]
    if _meta(data):
        return torch.empty((R, C, ph, pw), dtype=data.dtype,
                           device=data.device)
    scale = attrs.spatial_scale
    dev = data.device
    bidx = rois[:, 0].long()
    x1, y1, x2, y2 = (torch.round(rois[:, i] * scale).long()
                      for i in (1, 2, 3, 4))
    rh = torch.clamp_min(y2 - y1 + 1, 1)[:, None]
    rw = torch.clamp_min(x2 - x1 + 1, 1)[:, None]
    py = torch.arange(ph, device=dev)
    px = torch.arange(pw, device=dev)
    hstart = (y1[:, None] + (py * rh) // ph).clamp(0, H)
    hend = (y1[:, None] + torch.clamp_min(((py + 1) * rh + ph - 1) // ph,
                                          1)).clamp(0, H)
    wstart = (x1[:, None] + (px * rw) // pw).clamp(0, W)
    wend = (x1[:, None] + torch.clamp_min(((px + 1) * rw + pw - 1) // pw,
                                          1)).clamp(0, W)
    # columns: slabs of (C, H) per (image, x) -> (R, pw, C, H)
    by_col = data.permute(0, 3, 1, 2).reshape(B * W, C, H)
    cols = _window_max(by_col, W, bidx, wstart, wend)
    # rows: slabs of (pw, C) per (roi, y) -> (R, ph, pw, C)
    by_row = cols.permute(0, 3, 1, 2).reshape(R * H, pw, C)
    out = _window_max(by_row, H, torch.arange(R, device=dev), hstart, hend)
    out = out.permute(0, 3, 1, 2)
    return torch.where(torch.isfinite(out), out,
                       torch.zeros_like(out)).to(data.dtype)


# ---------------------------------------------------------------------------
# R-CNN proposals (reference contrib/proposal-inl.h, multi_proposal-inl.h)
# ---------------------------------------------------------------------------

def _rpn_anchors(attrs, A, H, W, device):
    """All shifted base anchors for an (H, W) feature map, float64."""
    stride = attrs.feature_stride
    base = []
    for r in attrs.ratios:
        for s in attrs.scales:
            size = stride * stride
            ws = np.sqrt(size / r) * s / stride
            hs = ws * r
            base.append([-ws * stride / 2, -hs * stride / 2,
                         ws * stride / 2, hs * stride / 2])
    base = torch.tensor(base[:A], dtype=_F64, device=device)      # (A, 4)
    shift_x = torch.arange(W, dtype=_F64, device=device) * stride
    shift_y = torch.arange(H, dtype=_F64, device=device) * stride
    sy, sx = torch.meshgrid(shift_y, shift_x, indexing="ij")
    shifts = torch.stack([sx, sy, sx, sy], dim=-1).reshape(-1, 4)
    return (shifts[:, None, :] + base[None]).reshape(-1, 4)       # (HW*A, 4)


def _propose(attrs, anchors, fg_scores, deltas, info):
    """RPN proposals of a batch: decode, clip, size-filter, the top
    ``rpn_pre_nms_top_n``, one NMS launch over the batch, the top
    ``rpn_post_nms_top_n``.  fg_scores (B,A,H,W); deltas (B,A*4,H,W);
    info (B,3).  Returns (rois (B,post_n,4) float64, scores (B,post_n))."""
    B = fg_scores.shape[0]
    scores = fg_scores.permute(0, 2, 3, 1).reshape(B, -1)
    deltas = deltas.permute(0, 2, 3, 1).reshape(B, -1, 4)
    aw = anchors[:, 2] - anchors[:, 0] + 1
    ah = anchors[:, 3] - anchors[:, 1] + 1
    acx = anchors[:, 0] + aw / 2
    acy = anchors[:, 1] + ah / 2
    cx = deltas[..., 0] * aw + acx
    cy = deltas[..., 1] * ah + acy
    w = torch.exp(deltas[..., 2].clamp(-10, 10)) * aw
    h = torch.exp(deltas[..., 3].clamp(-10, 10)) * ah
    zero = torch.zeros((), dtype=_F64, device=cx.device)
    imh = (info[:, 0:1] - 1).double()
    imw = (info[:, 1:2] - 1).double()
    boxes = torch.stack([
        torch.minimum(torch.maximum(cx - w / 2, zero), imw),
        torch.minimum(torch.maximum(cy - h / 2, zero), imh),
        torch.minimum(torch.maximum(cx + w / 2, zero), imw),
        torch.minimum(torch.maximum(cy + h / 2, zero), imh)], dim=-1)
    keep_size = ((boxes[..., 2] - boxes[..., 0]) >= attrs.rpn_min_size) & \
        ((boxes[..., 3] - boxes[..., 1]) >= attrs.rpn_min_size)
    scores = torch.where(keep_size, scores, torch.full_like(scores, -1.0))
    pre_n = min(attrs.rpn_pre_nms_top_n, scores.shape[1])
    top = _sort(scores, descending=True)
    top_scores, top_idx = top.values[:, :pre_n], top.indices[:, :pre_n]
    top_boxes = _gather_rows(boxes, top_idx)
    keep = kernels.greedy_nms(top_boxes, attrs.threshold)
    final = torch.where(keep, top_scores,
                        torch.full_like(top_scores, float("-inf")))
    post_n = min(attrs.rpn_post_nms_top_n, pre_n)
    sel = _sort(final, descending=True)
    rois = _gather_rows(top_boxes, sel.indices[:, :post_n])
    sel_score = sel.values[:, :post_n]
    return rois, torch.maximum(sel_score, torch.zeros_like(sel_score))


_PROPOSAL_PARAMS = dict(rpn_pre_nms_top_n=attr_int(6000),
                        rpn_post_nms_top_n=attr_int(300),
                        threshold=attr_float(0.7),
                        rpn_min_size=attr_int(16),
                        scales=_floats((4.0, 8.0, 16.0, 32.0)),
                        ratios=_floats((0.5, 1.0, 2.0)),
                        feature_stride=attr_int(16),
                        output_score=attr_bool(False),
                        iou_loss=attr_bool(False))


def _proposal_outputs(attrs):
    return 2 if attrs.output_score else 1


@register("_contrib_Proposal",
          inputs=("cls_prob", "bbox_pred", "im_info"),
          params=dict(_PROPOSAL_PARAMS), num_outputs=_proposal_outputs,
          aliases=("Proposal", "_contrib_proposal"))
def _proposal(attrs, cls_prob, bbox_pred, im_info):
    """RPN proposal layer (reference contrib/proposal-inl.h), fixed-shape,
    image 0 only: (post_nms_top_n, 5) float64 rois [0, x1,y1,x2,y2]; with
    output_score also the (post_nms_top_n, 1) scores."""
    A = cls_prob.shape[1] // 2
    H, W = cls_prob.shape[2], cls_prob.shape[3]
    anchors = _rpn_anchors(attrs, A, H, W, cls_prob.device)
    rois, scores = _propose(attrs, anchors, cls_prob[:1, A:], bbox_pred[:1],
                            im_info[:1])
    rois, scores = rois[0], scores[0]
    out = torch.cat([torch.zeros((rois.shape[0], 1), dtype=rois.dtype,
                                 device=rois.device), rois], dim=1)
    if attrs.output_score:
        return out, scores[:, None]
    return out


@register("_contrib_MultiProposal",
          inputs=("cls_prob", "bbox_pred", "im_info"),
          params=dict(_PROPOSAL_PARAMS), num_outputs=_proposal_outputs,
          aliases=("MultiProposal", "_contrib_multi_proposal"))
def _multi_proposal(attrs, cls_prob, bbox_pred, im_info):
    """Batched RPN proposals (reference contrib/multi_proposal-inl.h:121):
    the whole batch in one call, output (B*post_nms_top_n, 5) float64
    with the image index in column 0 (+ scores with output_score); the
    images' NMS runs as one kernel launch."""
    B, A2, H, W = cls_prob.shape
    A = A2 // 2
    anchors = _rpn_anchors(attrs, A, H, W, cls_prob.device)
    rois, scores = _propose(attrs, anchors, cls_prob[:, A:], bbox_pred,
                            im_info)
    post_n = rois.shape[1]
    bidx = torch.arange(B, dtype=rois.dtype, device=rois.device) \
        .repeat_interleave(post_n)[:, None]
    out = torch.cat([bidx, rois.reshape(B * post_n, 4)], dim=1)
    if attrs.output_score:
        return out, scores.reshape(B * post_n, 1)
    return out


# ---------------------------------------------------------------------------
# fft / count_sketch / quantization (reference contrib/)
# ---------------------------------------------------------------------------

@register("_contrib_fft", inputs=("data",),
          params=dict(compute_size=attr_int(128)), aliases=("fft",))
def _fft(attrs, x):
    """reference contrib/fft-inl.h: complex64 FFT of the last axis,
    interleaved re/im, out last dim 2n."""
    out = torch.fft.fft(x.to(torch.complex64), dim=-1)
    inter = torch.stack([out.real, out.imag], dim=-1)
    # back to x's dtype as the JAX op's astype does: saturating for
    # integer data (C27), where ``.to`` would wrap
    return _saturating_cast(
        inter.reshape(x.shape[:-1] + (2 * x.shape[-1],)), x.dtype)


@register("_contrib_ifft", inputs=("data",),
          params=dict(compute_size=attr_int(128)), aliases=("ifft",))
def _ifft(attrs, x):
    """Interleaved re/im -> the real part of the inverse FFT times n;
    complex128 for float64 data, as the JAX op's ``re + 1j * im`` gives."""
    n = x.shape[-1] // 2
    pairs = x.reshape(x.shape[:-1] + (n, 2))
    real = _F64 if x.dtype == _F64 else torch.float32
    comp = torch.complex(pairs[..., 0].to(real), pairs[..., 1].to(real))
    out = torch.fft.ifft(comp, dim=-1).real * n
    return _saturating_cast(out, x.dtype)


@register("_contrib_count_sketch", inputs=("data", "h", "s"),
          params=dict(out_dim=attr_int(required=True),
                      processing_batch_size=attr_int(32)),
          aliases=("count_sketch",))
def _count_sketch(attrs, data, h, s):
    """reference contrib/count_sketch-inl.h: y[h[i]] += s[i]*x[i]."""
    hi = h.reshape(-1).long()
    src = (data * s.reshape(-1)).to(data.dtype)
    out = torch.zeros(data.shape[:-1] + (attrs.out_dim,), dtype=data.dtype,
                      device=data.device)
    return out.index_add(-1, hi, src)


@register("_contrib_quantize", inputs=("data", "min_range", "max_range"),
          params=dict(out_type=attr_str("uint8")),
          num_outputs=3, aliases=("quantize",))
def _quantize(attrs, data, min_range, max_range):
    """Affine quantization (reference contrib/quantize-inl.h)."""
    if attrs.out_type == "uint8":
        qmin, qmax, dt = 0.0, 255.0, torch.uint8
    else:
        qmin, qmax, dt = -127.0, 127.0, torch.int8
    scale = (qmax - qmin) / torch.clamp_min(max_range - min_range, 1e-12)
    q = torch.clamp(torch.round((data - min_range) * scale + qmin), qmin,
                    qmax)
    return q.to(dt), min_range.clone(), max_range.clone()


@register("_contrib_dequantize", inputs=("data", "min_range", "max_range"),
          params=dict(out_type=attr_str("float32")),
          aliases=("dequantize",))
def _dequantize(attrs, data, min_range, max_range):
    if data.dtype == torch.uint8:
        qmin, qmax = 0.0, 255.0
    else:
        qmin, qmax = -127.0, 127.0
    scale = torch.clamp_min(max_range - min_range, 1e-12) / (qmax - qmin)
    return ((data.float() - qmin) * scale + min_range).to(
        dtype_torch(attrs.out_type))


# ---------------------------------------------------------------------------
# deformable convolution and position-sensitive ROI pooling (R-FCN)
# ---------------------------------------------------------------------------

@register("_contrib_DeformableConvolution",
          inputs=("data", "offset", "weight", "bias"),
          params=dict(kernel=attr_shape(required=True), stride=attr_shape(()),
                      dilate=attr_shape(()), pad=attr_shape(()),
                      num_filter=attr_int(required=True),
                      num_group=attr_int(1), num_deformable_group=attr_int(1),
                      workspace=attr_int(1024), no_bias=attr_bool(False)),
          aliases=("DeformableConvolution",))
def _deformable_conv(attrs, data, offset, weight, bias=None):
    """Deformable conv v1 (reference contrib/deformable_convolution-inl.h):
    bilinear sampling of every channel at the offset positions (zero
    outside the image), then the convolution's contraction as one
    einsum over the batch."""
    B, C, H, W = data.shape
    kh, kw = attrs.kernel
    stride = attrs.stride or (1, 1)
    pad = attrs.pad or (0, 0)
    dil = attrs.dilate or (1, 1)
    OH = (H + 2 * pad[0] - dil[0] * (kh - 1) - 1) // stride[0] + 1
    OW = (W + 2 * pad[1] - dil[1] * (kw - 1) - 1) // stride[1] + 1
    dev = data.device
    ys = torch.arange(OH, device=dev) * stride[0] - pad[0]
    xs = torch.arange(OW, device=dev) * stride[1] - pad[1]
    ky = torch.arange(kh, device=dev) * dil[0]
    kx = torch.arange(kw, device=dev) * dil[1]
    base_y = ys[:, None, None, None] + ky[None, None, :, None]  # OH,1,kh,1
    base_x = xs[None, :, None, None] + kx[None, None, None, :]  # 1,OW,1,kw
    # offsets (2*kh*kw*G, OH, OW): the first deformable group only
    off = offset.reshape(B, -1, 2, kh, kw, OH, OW)[:, 0]
    py = base_y + off[:, 0].permute(0, 3, 4, 1, 2)   # (B, OH, OW, kh, kw)
    px = base_x + off[:, 1].permute(0, 3, 4, 1, 2)
    y0, x0 = torch.floor(py).long(), torch.floor(px).long()
    y1, x1 = y0 + 1, x0 + 1
    wy1, wx1 = py - y0, px - x0
    wy0, wx0 = 1 - wy1, 1 - wx1
    imgs = data.reshape(B, C, H * W)
    L = OH * OW * kh * kw

    def at(yy, xx):
        ok = (yy >= 0) & (yy < H) & (xx >= 0) & (xx < W)
        idx = yy.clamp(0, H - 1) * W + xx.clamp(0, W - 1)
        got = torch.gather(imgs, 2, idx.reshape(B, 1, L).expand(B, C, L))
        got = got.reshape(B, C, OH, OW, kh, kw)
        return torch.where(ok[:, None], got, torch.zeros_like(got))

    patches = ((wy0 * wx0)[:, None] * at(y0, x0)
               + (wy0 * wx1)[:, None] * at(y0, x1)
               + (wy1 * wx0)[:, None] * at(y1, x0)
               + (wy1 * wx1)[:, None] * at(y1, x1))
    out = torch.einsum("bcijhw,ochw->boij", patches,
                       weight.reshape(weight.shape[0], C, kh, kw))
    if bias is not None:
        out = out + bias.reshape(1, -1, 1, 1)
    return out.to(data.dtype)


@register("_contrib_PSROIPooling",
          inputs=("data", "rois"),
          params=dict(spatial_scale=attr_float(required=True),
                      output_dim=attr_int(required=True),
                      pooled_size=attr_int(required=True),
                      group_size=attr_int(0)),
          aliases=("PSROIPooling",))
def _psroi_pooling(attrs, data, rois):
    """Position-sensitive ROI pooling (reference contrib/psroi_pooling).
    data (B, output_dim*k*k, H, W); rois (R,5) -> (R, output_dim, k, k):
    bin (py, px) of output channel o averages channel o*k*k + py*k + px
    over the bin's pixels inside the image, its sum read from a float64
    integral image at the bin's four corners."""
    k = attrs.pooled_size
    od = attrs.output_dim
    B, C, H, W = data.shape
    R = rois.shape[0]
    if _meta(data):
        return torch.empty((R, od, k, k), dtype=data.dtype,
                           device=data.device)
    scale = attrs.spatial_scale
    dev = data.device
    bidx = rois[:, 0].long()
    x1, y1, x2, y2 = (rois[:, i] * scale for i in (1, 2, 3, 4))
    bin_w = (torch.clamp_min(x2 - x1, 0.1) / k)[:, None]
    bin_h = (torch.clamp_min(y2 - y1, 0.1) / k)[:, None]
    p = torch.arange(k, device=dev)
    hs = torch.floor(y1[:, None] + p * bin_h).long().clamp(0, H)  # (R, k)
    he = torch.ceil(y1[:, None] + (p + 1) * bin_h).long().clamp(0, H)
    ws = torch.floor(x1[:, None] + p * bin_w).long().clamp(0, W)
    we = torch.ceil(x1[:, None] + (p + 1) * bin_w).long().clamp(0, W)
    cnt = torch.clamp_min((he - hs).clamp_min(0)[:, :, None]
                          * (we - ws).clamp_min(0)[:, None, :], 1)
    integral = torch.nn.functional.pad(
        data.double().cumsum(2).cumsum(3), (1, 0, 1, 0)).reshape(-1)
    chan = (torch.arange(od, device=dev)[:, None, None] * k * k
            + p[:, None] * k + p[None, :])                        # (od, k, k)
    plane = ((bidx[:, None, None, None] * C + chan) * (H + 1)
             * (W + 1))                                           # R,od,k,k

    def corner(y, x):        # y (R, k) by py, x (R, k) by px
        at = y[:, None, :, None] * (W + 1) + x[:, None, None, :]
        return integral.take(plane + at)

    total = corner(he, we) - corner(hs, we) - corner(he, ws) + corner(hs, ws)
    return (total / cnt[:, None]).to(data.dtype)


@register("_contrib_DeformablePSROIPooling",
          inputs=("data", "rois", "trans"),
          params=dict(spatial_scale=attr_float(required=True),
                      output_dim=attr_int(required=True),
                      group_size=attr_int(required=True),
                      pooled_size=attr_int(required=True),
                      part_size=attr_int(0),
                      sample_per_part=attr_int(1),
                      trans_std=attr_float(0.0),
                      no_trans=attr_bool(False)),
          num_outputs=2, aliases=("DeformablePSROIPooling",))
def _deformable_psroi_pooling(attrs, data, rois, trans=None):
    """Deformable position-sensitive ROI pooling (reference
    contrib/deformable_psroi_pooling.cu ForwardKernel; R-FCN deformable
    head).  data (B, output_dim*group_size^2, H, W); rois (R,5) image
    coords; trans (R, 2*num_classes, part_size, part_size) learned bin
    offsets, scaled by trans_std.  Outputs (output, top_count), both
    (R, output_dim, k, k): each bin the mean of its sample_per_part^2
    bilinear samples inside the image."""
    k = attrs.pooled_size
    od = attrs.output_dim
    gs = attrs.group_size
    part = attrs.part_size or k
    spp = attrs.sample_per_part
    B, C, H, W = data.shape
    R = rois.shape[0]
    dev = data.device
    no_trans = attrs.no_trans or trans is None
    n_cls = 1 if no_trans else trans.shape[1] // 2
    ch_per_cls = max(od // n_cls, 1)
    sc = attrs.spatial_scale
    r4 = lambda t: t[:, None, None, None]                  # noqa: E731
    # [start, end) sampling window on the -0.5-centered pixel grid
    x0 = r4(torch.round(rois[:, 1]) * sc - 0.5)
    y0 = r4(torch.round(rois[:, 2]) * sc - 0.5)
    x1 = r4((torch.round(rois[:, 3]) + 1.0) * sc - 0.5)
    y1 = r4((torch.round(rois[:, 4]) + 1.0) * sc - 0.5)
    rw = torch.clamp_min(x1 - x0, 0.1)
    rh = torch.clamp_min(y1 - y0, 0.1)
    bin_w, bin_h = rw / k, rh / k
    sub_w, sub_h = bin_w / spp, bin_h / spp
    ctop = torch.arange(od, device=dev)[:, None, None]         # (od, k, k)
    py = torch.arange(k, device=dev)[None, :, None]
    px = torch.arange(k, device=dev)[None, None, :]
    if no_trans:
        tx = ty = torch.zeros((), dtype=data.dtype, device=dev)
    else:
        part_h = torch.floor(py.float() / k * part).long()
        part_w = torch.floor(px.float() / k * part).long()
        cls = ctop // ch_per_cls
        last = trans.shape[1] - 1          # jnp indexing clamps
        rr = torch.arange(R, device=dev)[:, None, None, None]
        tx = trans[rr, (2 * cls).clamp(max=last), part_h, part_w] \
            * attrs.trans_std
        ty = trans[rr, (2 * cls + 1).clamp(max=last), part_h, part_w] \
            * attrs.trans_std
    wstart = px * bin_w + x0 + tx * rw                          # (R,od,k,k)
    hstart = py * bin_h + y0 + ty * rh
    gw = torch.floor(px.float() * gs / k).long().clamp(0, gs - 1)
    gh = torch.floor(py.float() * gs / k).long().clamp(0, gs - 1)
    c = (ctop * gs + gh) * gs + gw                              # (od, k, k)
    s = torch.arange(spp, device=dev)
    iw, ih = s[None, :], s[:, None]              # meshgrid "xy": (spp, spp)
    cell = lambda t: t[..., None, None]                    # noqa: E731
    wsm = cell(wstart) + iw * cell(sub_w)
    hsm = cell(hstart) + ih * cell(sub_h)
    # the reference kernel SKIPS strictly-outside samples
    inside = ((wsm >= -0.5) & (wsm <= W - 0.5) &
              (hsm >= -0.5) & (hsm <= H - 0.5))
    wc = wsm.clamp(0.0, W - 1.0)
    hc = hsm.clamp(0.0, H - 1.0)
    wl, hl = torch.floor(wc).long(), torch.floor(hc).long()
    wr = torch.clamp_max(wl + 1, W - 1)
    hr = torch.clamp_max(hl + 1, H - 1)
    fw, fh = wc - wl, hc - hl
    base = cell((r4(rois[:, 0].long()) * C + c) * (H * W))
    flat = data.reshape(-1)
    at = lambda y, x: flat.take(base + y * W + x)           # noqa: E731
    val = ((1 - fh) * (1 - fw) * at(hl, wl) +
           (1 - fh) * fw * at(hl, wr) +
           fh * (1 - fw) * at(hr, wl) +
           fh * fw * at(hr, wr))
    inside = inside.expand(val.shape)
    cnt = inside.sum((-2, -1))
    total = torch.where(inside, val, torch.zeros_like(val)).sum((-2, -1))
    out = torch.where(cnt > 0, total / torch.clamp_min(cnt, 1),
                      torch.zeros_like(total))
    return out.to(data.dtype), cnt.to(data.dtype)


# ---------------------------------------------------------------------------
# Box utility ops (reference src/operator/contrib/bounding_box.cc)
# ---------------------------------------------------------------------------

def _to_corner(b):
    """center (x, y, w, h) -> corner (xmin, ymin, xmax, ymax)."""
    x, y, w, h = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack([x - w / 2, y - h / 2, x + w / 2, y + h / 2], dim=-1)


def _to_center(b):
    """corner (xmin, ymin, xmax, ymax) -> center (x, y, w, h)."""
    x0, y0, x1, y1 = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack([(x0 + x1) / 2, (y0 + y1) / 2, x1 - x0, y1 - y0],
                       dim=-1)


@register("_contrib_box_iou", inputs=("lhs", "rhs"),
          params=dict(format=attr_str("corner")),
          aliases=("box_iou",))
def _contrib_box_iou(attrs, lhs, rhs):
    """Pairwise IoU with OUTER batch semantics: lhs (..., 4) x rhs
    (..., 4) -> lhs.shape[:-1] + rhs.shape[:-1] — every lhs box against
    every rhs box (reference bounding_box.cc box_iou)."""
    if attrs.format == "center":
        lhs, rhs = _to_corner(lhs), _to_corner(rhs)
    out = _box_iou(lhs.reshape(-1, 4), rhs.reshape(-1, 4))
    return out.reshape(lhs.shape[:-1] + rhs.shape[:-1])


@register("_contrib_bipartite_matching", inputs=("data",),
          params=dict(is_ascend=attr_bool(False),
                      threshold=attr_float(required=True),
                      topk=attr_int(-1)),
          num_outputs=2, aliases=("bipartite_matching",))
def _contrib_bipartite_matching(attrs, data):
    """Greedy bipartite matching on a (..., N, M) score matrix: repeatedly
    take the globally best remaining pair (reference bounding_box.cc
    BipartiteMatching).  Outputs: row->col assignment (N,), col->row
    assignment (M,); -1 = unmatched.  The k steps run in order, each over
    every matrix of the batch at once."""
    sign = -1.0 if attrs.is_ascend else 1.0
    thr = attrs.threshold
    flat = data.reshape((-1,) + tuple(data.shape[-2:]))
    G, N, M = flat.shape
    k = min(N, M) if attrs.topk <= 0 else min(attrs.topk, min(N, M))
    dev = data.device
    s = flat * sign
    rows = torch.full((G, N), -1.0, dtype=data.dtype, device=dev)
    cols = torch.full((G, M), -1.0, dtype=data.dtype, device=dev)
    avail = torch.ones((G, N, M), dtype=torch.bool, device=dev)
    g = torch.arange(G, device=dev)
    rn = torch.arange(N, device=dev)
    cm = torch.arange(M, device=dev)
    neg_inf = torch.full_like(s, float("-inf"))
    for _ in range(k):
        masked = torch.where(avail, s, neg_inf)
        best = masked.reshape(G, -1).argmax(1)
        i, j = best // M, best % M
        mij = flat[g, i, j]
        # threshold applies in the ORIGINAL ordering sense, strictly
        # (reference bounding_box-inl.h:636)
        ok = (mij > thr if sign > 0 else mij < thr) & \
            torch.isfinite(masked[g, i, j])
        rows = torch.where(ok[:, None] & (rn == i[:, None]),
                           j[:, None].to(data.dtype), rows)
        cols = torch.where(ok[:, None] & (cm == j[:, None]),
                           i[:, None].to(data.dtype), cols)
        taken = (rn[None, :, None] == i[:, None, None]) | \
            (cm[None, None, :] == j[:, None, None])
        avail = avail & ~(ok[:, None, None] & taken)
    return (rows.reshape(data.shape[:-1]),
            cols.reshape(tuple(data.shape[:-2]) + (M,)))


@register("_contrib_box_nms", inputs=("data",),
          params=dict(overlap_thresh=attr_float(0.5),
                      valid_thresh=attr_float(0.0), topk=attr_int(-1),
                      coord_start=attr_int(2), score_index=attr_int(1),
                      id_index=attr_int(-1), background_id=attr_int(-1),
                      force_suppress=attr_bool(False),
                      in_format=attr_str("corner"),
                      out_format=attr_str("corner")),
          aliases=("box_nms",))
def _contrib_box_nms(attrs, data):
    """Non-maximum suppression over (..., N, K) detections (reference
    bounding_box.cc box_nms): descending-score stable sort, greedy
    suppression at overlap_thresh (per class unless force_suppress;
    background_id rows ignored) by one NMS launch over the batch,
    suppressed rows set to -1, surviving coordinates emitted in
    out_format.  Boxes of a dtype other than float32 and float64 are
    suppressed in float32."""
    cs, si, ii = attrs.coord_start, attrs.score_index, attrs.id_index
    flat = data.reshape((-1,) + tuple(data.shape[-2:]))
    n = flat.shape[1]
    order = _sort(-flat[..., si]).indices
    mat_s = _gather_rows(flat, order)
    boxes = mat_s[..., cs:cs + 4]
    if attrs.in_format == "center":
        boxes = _to_corner(boxes)
    valid = mat_s[..., si] > attrs.valid_thresh
    if ii >= 0 and attrs.background_id >= 0:
        valid = valid & (mat_s[..., ii] != attrs.background_id)
    if attrs.topk > 0:
        valid = valid & (torch.arange(n, device=data.device) < attrs.topk)
    ids = mat_s[..., ii] if not attrs.force_suppress and ii >= 0 else None
    nms_boxes = boxes if boxes.dtype in (torch.float32, _F64) \
        else boxes.float()
    keep = kernels.greedy_nms(nms_boxes, attrs.overlap_thresh, ids=ids,
                              valid=valid) & valid
    if attrs.in_format != attrs.out_format:
        out_boxes = boxes if attrs.out_format == "corner" else \
            _to_center(mat_s[..., cs:cs + 4])
        out = torch.cat([mat_s[..., :cs], out_boxes, mat_s[..., cs + 4:]],
                        dim=-1)
    else:
        out = mat_s
    out = torch.where(keep[..., None], out, torch.full_like(out, -1))
    return out.reshape(data.shape)
