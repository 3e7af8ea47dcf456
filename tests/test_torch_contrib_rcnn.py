"""The port's R-CNN ops against the JAX package's on the CPU: ROIPooling
(a ROI past the image, bins of uneven size), Proposal and MultiProposal
(one NMS launch over the batch; tied scores, with and without the
scores output) and PSROIPooling: the ``"contrib"`` cases of
``torch_cases.py`` in this group of ``torch_parity.CONTRIB_GROUPS``,
forward and (pooling) gradients, with the cases' tolerances."""
import pytest

from torch_parity import check_op, contrib_keys


@pytest.mark.parametrize("key", contrib_keys("rcnn"))
def test_op_matches_jax(key):
    check_op(key)
