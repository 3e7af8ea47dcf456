"""The port's contrib and detection ops (``mxnet_tpu_torch/ops/contrib.py``)
against the JAX package's, on the CPU: the SSD family and the NMS here;
the box ops, fft, count_sketch and quantization in
``test_torch_contrib_boxes.py``, ROI pooling and the proposals in
``test_torch_contrib_rcnn.py``, the deformable ops in
``test_torch_contrib_deformable.py`` (``torch_parity.CONTRIB_GROUPS``).

* Every case of ``torch_cases.py``'s ``"contrib"`` module through
  ``mx.nd`` against the JAX op (forward, output by output, with the same
  dtype; the differentiable ones' gradients for one numpy cotangent):
  here score ties, two ground truths that share their best anchor (the
  higher gt index wins, as XLA's scatter leaves it), degenerate and
  clipped boxes.  Tolerances are the cases' (``torch_cases.py``): exact
  for indices, assignments and quantized values, 1e-6 of the largest
  magnitude for f32 arithmetic in another order (and the box decoders'
  float64 ``exp``), 1e-5 for the FFTs and the sampled and pooled sums.
* The plain NMS (the kernel's oracle and CPU path) against the JAX
  package's ``_greedy_nms`` on random clustered boxes in float32 and
  float64: the keep masks are equal, or where they first differ the
  deciding IoU lies within 4 ulps of the threshold (XLA:CPU may contract
  ``area_a + area_b - iw * ih`` into an FMA; the port never does).
* Each of the 39 names has a case, the JAX package's aliases, flags,
  params and output counts; ``mx.nd.contrib``, ``mx.sym.contrib`` and
  ``mx.contrib.{ndarray,symbol}`` carry them.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu.ops import contrib as jax_contrib
from mxnet_tpu.ops.registry import get_op as jax_get_op
from mxnet_tpu_torch.ops import kernels
from mxnet_tpu_torch.ops.registry import get_op

from torch_cases import OP_MODULES
from torch_parity import (CONTRIB_GROUPS, case_keys, check_op,
                          contrib_keys, jax_module_names)


@pytest.mark.parametrize("key", contrib_keys("ssd"))
def test_op_matches_jax(key):
    check_op(key)


def test_every_contrib_case_runs_in_one_file():
    keys = [k for g in CONTRIB_GROUPS for k in contrib_keys(g)]
    assert sorted(keys) == case_keys("contrib")


def _clustered(rs, B, n, dtype):
    centre = rs.uniform(0.3, 0.7, (B, n, 2))
    half = rs.uniform(0.02, 0.25, (B, n, 2))
    return np.concatenate([centre - half, centre + half], -1).astype(dtype)


@pytest.mark.parametrize("dtype,thresh,seed", [(np.float32, 0.45, 0),
                                               (np.float32, 0.7, 1),
                                               (np.float64, 0.5, 2)])
def test_plain_nms_matches_the_jax_loop(dtype, thresh, seed):
    rs = np.random.RandomState(seed)
    B, n = 3, 160
    boxes = _clustered(rs, B, n, dtype)
    got = kernels.greedy_nms_plain(torch.from_numpy(boxes), thresh).numpy()
    assert 0 < got.sum() < got.size          # it suppresses, and keeps
    for b in range(B):
        want = np.asarray(jax_contrib._greedy_nms(jnp.asarray(boxes[b]),
                                                  None, thresh, n))
        if np.array_equal(got[b], want):
            continue
        # before the first difference both kept the same boxes; one of
        # them decides j, at an IoU within rounding of the threshold
        j = int(np.flatnonzero(got[b] != want)[0])
        kept = torch.from_numpy(np.flatnonzero(want[:j]))
        t = torch.from_numpy(boxes[b])
        ious = kernels._nms_iou_row(t[kept], t[j].expand(len(kept), 1, 4))
        gap = np.abs(ious.numpy().ravel() - dtype(thresh)).min()
        assert gap <= 4 * np.spacing(dtype(thresh)), (b, j, gap)


def test_nms_ids_valid_and_pairs():
    """Class ids and the valid mask follow the JAX box_nms loop's rule,
    the CPU wrapper is the plain version (no launch), and the plain
    version's ``pairs`` (the bound's count in chip_smoke.py) counts the
    IoUs the rule needs: each kept, valid box against each later box of
    its class still kept at its turn."""
    rs = np.random.RandomState(3)
    boxes = torch.from_numpy(_clustered(rs, 2, 40, np.float32))
    ids = torch.from_numpy(rs.randint(0, 3, (2, 40)).astype(np.float32))
    valid = torch.from_numpy(rs.rand(2, 40) > 0.2)
    before = dict(kernels.LAUNCHES)
    keep = kernels.greedy_nms(boxes, 0.3, ids=ids, valid=valid)
    assert kernels.LAUNCHES == before
    pairs = torch.zeros(1, dtype=torch.int64)
    assert torch.equal(kernels.greedy_nms_plain(boxes, 0.3, ids=ids,
                                                valid=valid, pairs=pairs),
                       keep)
    want_pairs = 0
    for b in range(2):
        live = np.ones(40, bool)
        for i in range(40):
            if not (live[i] and valid[b, i]):
                continue
            for j in range(i + 1, 40):
                if live[j] and ids[b, j] == ids[b, i]:
                    want_pairs += 1
                    iou = kernels._nms_iou_row(boxes[b, i][None],
                                               boxes[b, j][None, None])
                    live[j] &= not bool(iou > np.float32(0.3))
        np.testing.assert_array_equal(keep[b].numpy(), live)
    assert int(pairs) == want_pairs
    assert 0 < int(keep.sum()) < keep.numel()
    meta = kernels.greedy_nms(boxes.to("meta"), 0.3)
    assert meta.device.type == "meta" and meta.shape == (2, 40)


# the required params of the ops that have some
REQUIRED = {
    "ROIPooling": dict(pooled_size=(2, 2), spatial_scale=1.0),
    "_contrib_DeformableConvolution": dict(kernel=(3, 3), num_filter=2),
    "_contrib_PSROIPooling": dict(spatial_scale=1.0, output_dim=2,
                                  pooled_size=2),
    "_contrib_DeformablePSROIPooling": dict(spatial_scale=1.0, output_dim=2,
                                            group_size=2, pooled_size=2),
    "_contrib_count_sketch": dict(out_dim=3),
    "_contrib_bipartite_matching": dict(threshold=0.1)}


def test_the_39_names_have_cases_aliases_and_flags():
    names = jax_module_names("contrib")
    assert len(names) == 39
    keys = {k.split(":")[0] for k in OP_MODULES["contrib"]}
    assert not set(names) - keys, sorted(set(names) - keys)
    for n in names:
        for m in names:
            assert (get_op(n) is get_op(m)) == \
                (jax_get_op(n) is jax_get_op(m)), (n, m)
        op, jop = get_op(n), jax_get_op(n)
        assert op.name == jop.name
        assert sorted(op.params) == sorted(jop.params), n
        for pname, spec in op.params.items():
            assert repr(spec.default) == repr(jop.params[pname].default), \
                (n, pname)
            assert spec.required == jop.params[pname].required, (n, pname)
        assert op.list_inputs() == jop.list_inputs(), n
        for extra in ({}, {"output_score": True}):
            attrs = dict(REQUIRED.get(op.name, {}),
                         **(extra if "output_score" in op.params else {}))
            a, ja = op.parse_attrs(attrs), jop.parse_attrs(attrs)
            assert op.num_outputs(a) == jop.num_outputs(ja), n


def test_namespaces_carry_the_contrib_names():
    for short in ("MultiBoxPrior", "MultiBoxTarget", "MultiBoxDetection",
                  "box_nms", "box_iou", "bipartite_matching", "Proposal",
                  "MultiProposal", "PSROIPooling", "DeformableConvolution",
                  "DeformablePSROIPooling", "fft", "ifft", "count_sketch",
                  "quantize", "dequantize", "ROIPooling"):
        assert hasattr(jmx.nd.contrib, short) == \
            hasattr(tmx.nd.contrib, short), short
        assert hasattr(jmx.sym.contrib, short) == \
            hasattr(tmx.sym.contrib, short), short
    for name in jax_module_names("contrib"):
        assert hasattr(tmx.contrib.ndarray, name), name
        assert hasattr(tmx.contrib.symbol, name), name
    x = tmx.nd.array(np.array([[[0, 0.9, 0, 0, 1, 1], [0, 0.8, 0, 0, 1, 1]]],
                              np.float32), ctx=tmx.cpu())
    out = tmx.nd.contrib.box_nms(x, overlap_thresh=0.5).asnumpy()
    np.testing.assert_array_equal(out[0, 1], -np.ones(6, np.float32))
    # SparseEmbedding (sparse storage) is in both contrib namespaces now
    for pkg in (tmx, jmx):
        assert hasattr(pkg.nd.contrib, "SparseEmbedding")
        assert hasattr(pkg.sym.contrib, "SparseEmbedding")
    w = np.arange(10, dtype=np.float32).reshape(5, 2)
    got = tmx.nd.contrib.SparseEmbedding(
        tmx.nd.array([4.0, 0.0, 4.0], ctx=tmx.cpu()),
        tmx.nd.array(w, ctx=tmx.cpu()), input_dim=5, output_dim=2)
    np.testing.assert_array_equal(got.asnumpy(), w[[4, 0, 4]])
