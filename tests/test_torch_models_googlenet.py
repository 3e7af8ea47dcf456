"""GoogLeNet (``models/googlenet``) against the JAX package's builder on
the CPU, as ``test_torch_models_more.py`` holds MobileNet: at 64x64,
batch 4, up to the classifier's Dropout (whose masks are each package's
own draws), the predict forward and gradient and the training forward
with its new moving statistics, each within a fixed tolerance of the JAX
package's (``torch_parity.check_more_net``).
"""
import pytest

from torch_parity import check_more_net


@pytest.mark.parametrize("family", ["googlenet"])
def test_forward_and_gradient_match_jax(family):
    check_more_net(family)
