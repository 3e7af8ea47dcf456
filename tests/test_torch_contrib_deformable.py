"""The port's deformable ops against the JAX package's on the CPU:
DeformableConvolution (samples past the image; stride, dilation,
padding, a second deformable group that the reference ignores) and
DeformablePSROIPooling (with learned offsets and without): the
``"contrib"`` cases of ``torch_cases.py`` in this group of
``torch_parity.CONTRIB_GROUPS``, forward and gradients (data, offsets,
weights, bias), with the cases' tolerances."""
import pytest

from torch_parity import check_op, contrib_keys


@pytest.mark.parametrize("key", contrib_keys("deformable"))
def test_op_matches_jax(key):
    check_op(key)
