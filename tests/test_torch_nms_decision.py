"""The greedy-NMS kernel's decision, emulated on the CPU, and the plain NMS
against the JAX loops, on adversarial boxes.

* ``kernel_decision`` repeats, in torch float32 and float64, the comparison
  ``csrc/nms.cu`` makes for a pair: for t >= 0 (or NaN) and two boxes of
  finite coordinates within 2^500 (f32: 2^60), nothing where either box
  has a width or height <= 0 or they do not overlap (four comparisons),
  else ``suppressed_fast`` (compare-and-select min / max, no clamps);
  otherwise
  ``suppressed_exact`` (an fmin / fmax filter for t >= 0 (or NaN), then
  the exact IoU's terms in ``_box_iou``'s order).  Both decide a pair
  whose width or height is not > 0 at once, then, for a normal t > 0,
  compare inter with p = t * den bracketed by 1 +- 8u, and divide only
  inside the bracket.  Every pair of an adversarial set (touching,
  nested, duplicate, zero-area, inverted boxes, NaN and +-inf coordinates,
  subnormal extents, overflowing areas, IoUs within a few ulps of t) must
  get the decision of ``_nms_iou_row(...) > _nms_threshold(...)``, the
  plain version's, at t in {-0.1, 0, 0.45, 0.5, 0.7, 1, NaN}; each path
  of the rule is taken somewhere.
* ``greedy_nms_plain`` (the kernel's oracle) against the JAX package's
  ``_greedy_nms`` and ``_contrib_box_nms`` (class ids, background rows as
  the valid mask) on shuffled adversarial sets: equal keep masks, or where
  they first differ the deciding IoU lies within 4 ulps of the threshold
  (``tests/test_torch_contrib_ops.py``'s rule: XLA:CPU may contract
  ``area_a + area_b - iw * ih`` into an FMA; the port never does).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu  # noqa: F401  (x64: the JAX loops run float64 boxes)
from mxnet_tpu.ops import contrib as jax_contrib
from mxnet_tpu.ops.registry import get_op as jax_get_op
from mxnet_tpu_torch.ops import kernels

from torch_cases import (nms_adversarial_boxes, nms_adversarial_sets,
                         nms_near_pairs)

THRESHOLDS = [-0.1, 0.0, 0.45, 1.0, float("nan")]
# and the near pairs' other thresholds (Proposal's 0.7, box_nms's 0.5)
DECISION_THRESHOLDS = THRESHOLDS + [0.5, 0.7]
DTYPES = [torch.float32, torch.float64]
# csrc/nms.cu Lim<T>: 1 + 8u, 1 - 8u, the range of p that takes them and
# the largest coordinate of a finite_pair_safe box
LIM = {torch.float32: dict(up=1 + 2.0 ** -21, down=1 - 2.0 ** -21,
                           p_lo=2.0 ** -124, p_hi=2.0 ** 124, safe=2.0 ** 60),
       torch.float64: dict(up=1 + 2.0 ** -50, down=1 - 2.0 ** -50,
                           p_lo=2.0 ** -1020, p_hi=2.0 ** 1020,
                           safe=2.0 ** 500)}
# which step of the rule decided a pair
FILTER, ABOVE, BELOW, DIVIDE = range(4)


def _decide(inter, den, tt, bracket, lim):
    """csrc/nms.cu ``decide``: (decision, step) of inter / den > t."""
    c = lambda v: torch.tensor(v, dtype=inter.dtype)  # noqa: E731
    p = tt * den
    if bracket:
        inside = (p >= c(lim["p_lo"])) & (p <= c(lim["p_hi"]))
    else:
        inside = torch.zeros_like(inter, dtype=torch.bool)
    above = inside & (inter > p * c(lim["up"]))
    below = inside & ~above & (inter < p * c(lim["down"]))
    divided = (inter / den) > tt
    return (torch.where(above, True, torch.where(below, False, divided)),
            torch.where(above, ABOVE, torch.where(below, BELOW, DIVIDE)))


def kernel_decision(a, b, thresh):
    """csrc/nms.cu's decision for each row pair of ``a`` (the kept box),
    ``b`` (N, 4) at ``thresh``: (decision (N,) bool, deciding step (N,),
    whether ``suppressed_fast`` (N,) or ``suppressed_exact`` took it)."""
    dtype = a.dtype
    lim = LIM[dtype]
    t = kernels._nms_threshold(dtype, thresh)

    def c(v):
        return torch.tensor(v, dtype=dtype)

    zero, tt = c(0.0), c(t)
    cheap = not (0.0 > t)
    fi = torch.finfo(dtype)
    bracket = fi.tiny <= t <= fi.max

    def area(x):
        return torch.maximum((x[:, 2] - x[:, 0]) * (x[:, 3] - x[:, 1]), zero)

    def safe(x):
        return (x.abs() <= c(lim["safe"])).all(1)

    def solid(x):
        return (x[:, 2] > x[:, 0]) & (x[:, 3] > x[:, 1])

    area_a = area(a)
    # the finite pairs: only boxes of width and height > 0 that overlap
    # (four comparisons) take suppressed_fast: compare-and-select min /
    # max, no clamps
    passed = solid(a) & solid(b) & (a[:, 2] > b[:, 0]) \
        & (b[:, 2] > a[:, 0]) & (a[:, 3] > b[:, 1]) & (b[:, 3] > a[:, 1])
    iw = torch.where(a[:, 2] < b[:, 2], a[:, 2], b[:, 2]) \
        - torch.where(a[:, 0] > b[:, 0], a[:, 0], b[:, 0])
    ih = torch.where(a[:, 3] < b[:, 3], a[:, 3], b[:, 3]) \
        - torch.where(a[:, 1] > b[:, 1], a[:, 1], b[:, 1])
    inter = iw * ih
    uni = (area_a + (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])) - inter
    den = torch.where(uni > c(1e-12), uni, c(1e-12))
    dec, step = _decide(inter, den, tt, bracket, lim)
    fast_dec = torch.where(passed, dec, False)
    fast_step = torch.where(passed, step, FILTER)
    # suppressed_exact: fmin / fmax filter for t >= 0, then the plain terms
    if cheap:
        fw = torch.fmin(a[:, 2], b[:, 2]) - torch.fmax(a[:, 0], b[:, 0])
        fh = torch.fmin(a[:, 3], b[:, 3]) - torch.fmax(a[:, 1], b[:, 1])
        filt = ~(fw > 0) | ~(fh > 0)
    else:
        filt = torch.zeros(len(a), dtype=torch.bool)
    iw = torch.maximum(torch.minimum(a[:, 2], b[:, 2])
                       - torch.maximum(a[:, 0], b[:, 0]), zero)
    ih = torch.maximum(torch.minimum(a[:, 3], b[:, 3])
                       - torch.maximum(a[:, 1], b[:, 1]), zero)
    inter = iw * ih
    den = torch.maximum((area_a + area(b)) - inter, c(1e-12))
    dec, step = _decide(inter, den, tt, bracket, lim)
    exact_dec = torch.where(filt, False, dec)
    exact_step = torch.where(filt, FILTER, step)
    fast = safe(a) & safe(b) if cheap else torch.zeros(len(a), dtype=bool)
    return (torch.where(fast, fast_dec, exact_dec),
            torch.where(fast, fast_step, exact_step), fast)


def plain_decision(a, b, thresh):
    t = kernels._nms_threshold(a.dtype, thresh)
    return kernels._nms_iou_row(a, b[:, None, :])[:, 0] > t


def _pairs(dtype):
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    boxes = torch.from_numpy(nms_adversarial_boxes(np_dtype))
    n = len(boxes)
    ia, ib = torch.meshgrid(torch.arange(n), torch.arange(n), indexing="ij")
    na, nb = nms_near_pairs(np_dtype)
    return (torch.cat([boxes[ia.reshape(-1)], torch.from_numpy(na)]),
            torch.cat([boxes[ib.reshape(-1)], torch.from_numpy(nb)]))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("thresh", DECISION_THRESHOLDS)
def test_kernel_decision_equals_the_plain_comparison(dtype, thresh):
    a, b = _pairs(dtype)
    got, _, _ = kernel_decision(a, b, thresh)
    want = plain_decision(a, b, thresh)
    bad = torch.nonzero(got != want).ravel()
    assert len(bad) == 0, [(a[k].tolist(), b[k].tolist()) for k in bad[:5]]
    if thresh < 1.0:
        assert 0 < int(want.sum()) < len(want)   # it suppresses, and keeps


@pytest.mark.parametrize("dtype", DTYPES)
def test_every_step_of_the_rule_is_taken(dtype):
    """At 0.45 the adversarial pairs reach both tests (finite pairs the
    fast one, NaN / infinite / huge ones the exact one) and in each the
    filter, both sides of the bracket and the division (pairs within the
    bracket of t, both verdicts there); at -0.1 only the exact test's
    division decides, at NaN and 0 the filter and the division."""
    a, b = _pairs(dtype)
    want = plain_decision(a, b, 0.45)
    _, step, fast = kernel_decision(a, b, 0.45)
    for path in (fast, ~fast):
        assert set(step[path].unique().tolist()) == {FILTER, ABOVE, BELOW,
                                                     DIVIDE}
    at = step == DIVIDE
    assert bool(want[at].any()) and bool((~want[at]).any())
    for t, steps in ((-0.1, {DIVIDE}), (float("nan"), {FILTER, DIVIDE}),
                     (0.0, {FILTER, DIVIDE})):
        _, step, fast = kernel_decision(a, b, t)
        assert set(step.unique().tolist()) == steps, t
        assert bool(fast.any()) == (not 0.0 > t), t


def _same_or_near(got, want, boxes, np_dtype, thresh):
    """Equal keep masks, or the first difference decided at an IoU within
    4 ulps of the threshold."""
    if np.array_equal(got, want):
        return
    j = int(np.flatnonzero(got != want)[0])
    kept = torch.from_numpy(np.flatnonzero(want[:j]))
    t = torch.from_numpy(boxes)
    ious = kernels._nms_iou_row(t[kept], t[j].expand(len(kept), 1, 4))
    gap = np.nanmin(np.abs(ious.numpy().ravel() - np_dtype(thresh)))
    assert gap <= 4 * np.spacing(np_dtype(thresh)), (j, gap)


@pytest.mark.parametrize("np_dtype", [np.float32, np.float64])
@pytest.mark.parametrize("thresh", THRESHOLDS)
def test_plain_nms_matches_jax_greedy_nms_on_adversarial_boxes(np_dtype,
                                                              thresh):
    boxes = nms_adversarial_sets(np_dtype, 7, 2)
    got = kernels.greedy_nms_plain(torch.from_numpy(boxes), thresh).numpy()
    for b in range(len(boxes)):
        want = np.asarray(jax_contrib._greedy_nms(
            jnp.asarray(boxes[b]), None, thresh, boxes.shape[1]))
        _same_or_near(got[b], want, boxes[b], np_dtype, thresh)


@pytest.mark.parametrize("np_dtype", [np.float32, np.float64])
@pytest.mark.parametrize("thresh", [0.0, 0.45, 1.0])
def test_plain_nms_matches_jax_box_nms_with_ids_and_valid(np_dtype, thresh):
    """box_nms's loop: rows (id, score, x0, y0, x1, y1) with descending
    scores (the sort keeps their order), ids 0-2 with 0 the background
    (invalid: never suppresses, suppressed all the same)."""
    rs = np.random.RandomState(11)
    boxes = nms_adversarial_sets(np_dtype, 13, 1)[0]
    n = len(boxes)
    ids = rs.randint(0, 3, n).astype(np_dtype)
    scores = np.linspace(1.0, 0.01, n).astype(np_dtype)
    data = np.concatenate([ids[:, None], scores[:, None], boxes], 1)
    op = jax_get_op("_contrib_box_nms")
    attrs = op.parse_attrs(dict(overlap_thresh=thresh, valid_thresh=0.0,
                                coord_start=2, score_index=1, id_index=0,
                                background_id=0))
    out = np.asarray(jax_contrib._contrib_box_nms(attrs, jnp.asarray(data)))
    want = out[:, 1] != -1
    valid = torch.from_numpy(ids != 0)
    got = (kernels.greedy_nms_plain(
        torch.from_numpy(boxes)[None], thresh,
        ids=torch.from_numpy(ids)[None], valid=valid[None])[0]
        & valid).numpy()
    assert 0 < want.sum() < n
    if np.array_equal(got, want):
        return
    # the first difference: an IoU with a kept box of its class within
    # 4 ulps of the threshold
    j = int(np.flatnonzero(got != want)[0])
    kept = np.flatnonzero(want[:j] & (ids[:j] == ids[j]))
    t = torch.from_numpy(boxes)
    ious = kernels._nms_iou_row(t[kept], t[j].expand(len(kept), 1, 4))
    gap = np.nanmin(np.abs(ious.numpy().ravel() - np_dtype(thresh)))
    assert gap <= 4 * np.spacing(np_dtype(thresh)), (j, gap)


@pytest.mark.parametrize("with_ids", [False, True])
def test_plain_nms_counts_pairs_and_overlaps(with_ids):
    """``greedy_nms_plain``'s counters, which size the kernel's bound:
    ``pairs`` the pairs the rule decides (a kept, valid box against each
    later box still kept at its turn, of its class), ``overlaps`` those of
    them with an IoU > 0, against a loop over the pairs."""
    rs = np.random.RandomState(5)
    boxes = torch.from_numpy(nms_adversarial_sets(np.float64, 9, 2))
    B, n, _ = boxes.shape
    ids = torch.from_numpy(rs.randint(0, 3, (B, n)).astype(np.float64)) \
        if with_ids else None
    valid = torch.from_numpy(rs.rand(B, n) > 0.2)
    pairs = torch.zeros(1, dtype=torch.int64)
    overlaps = torch.zeros(1, dtype=torch.int64)
    keep = kernels.greedy_nms_plain(boxes, 0.45, ids=ids, valid=valid,
                                    pairs=pairs, overlaps=overlaps)
    t = kernels._nms_threshold(boxes.dtype, 0.45)
    want_pairs = want_overlaps = 0
    for b in range(B):
        live = np.ones(n, bool)
        for i in range(n):
            if not (live[i] and valid[b, i]):
                continue
            iou = kernels._nms_iou_row(boxes[b, i][None],
                                       boxes[b][None])[0].numpy()
            for j in range(i + 1, n):
                if live[j] and (ids is None or ids[b, j] == ids[b, i]):
                    want_pairs += 1
                    want_overlaps += bool(iou[j] > 0)
                    live[j] = not iou[j] > t
        assert np.array_equal(live, keep[b].numpy())
    assert (int(pairs), int(overlaps)) == (want_pairs, want_overlaps)
    assert 0 < want_overlaps < want_pairs
