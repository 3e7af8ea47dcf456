"""Inception-v4 (``models/inception_v4``) against the JAX package's
builder on the CPU, as ``test_torch_models_more.py`` holds MobileNet: at
75x75 (the least its valid convolutions and reductions take), batch 4,
up to the classifier's Dropout (whose masks are each package's own
draws), the predict forward and gradient and the training forward with
its new moving statistics, each within a fixed tolerance of the JAX
package's (``torch_parity.check_more_net``).  The training forward is
compared up to reduction B: past it the 1x1 maps leave BatchNorm 4
values per channel, and float32 rounding decides the outputs
(``torch_cases.MORE_NETS_TRAIN_CUT``).
"""
import pytest

from torch_parity import check_more_net


@pytest.mark.parametrize("family", ["inception_v4"])
def test_forward_and_gradient_match_jax(family):
    check_more_net(family)
