"""ResNet v1 and ResNeXt (``models/{resnet_v1,resnext}``) against the
JAX package's builders on the CPU, as ``test_torch_models_more.py``
holds MobileNet: at the smallest input ``tests/test_model_symbols.py``
runs (64x64), batch 4, the predict forward and gradient and the
training forward with its new moving statistics, each within a fixed
tolerance of the JAX package's (``torch_parity.check_more_net``).
"""
import pytest

from torch_parity import check_more_net


@pytest.mark.parametrize("family", ["resnet_v1", "resnext"])
def test_forward_and_gradient_match_jax(family):
    check_more_net(family)
