"""The port's box ops (``box_iou`` with both formats, degenerate and
disjoint boxes; ``bipartite_matching`` ascending, with ``topk`` and tied
scores; ``box_nms`` class-aware with a background id, forced, with
``topk``, ``valid_thresh``, tied scores and center formats), fft/ifft,
count_sketch and quantize/dequantize against the JAX package's on the
CPU: the ``"contrib"`` cases of ``torch_cases.py`` in this group of
``torch_parity.CONTRIB_GROUPS``, forward and gradients, with the cases'
tolerances."""
import pytest

from torch_parity import check_op, contrib_keys


@pytest.mark.parametrize("key", contrib_keys("boxes"))
def test_op_matches_jax(key):
    check_op(key)
