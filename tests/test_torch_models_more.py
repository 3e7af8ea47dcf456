"""The port's other conv nets (``models/{resnet_v1,resnext,mobilenet,
googlenet,inception_v4}``) against the JAX package's builders, on the
CPU.

* Each builder's ``tojson()`` equals the JAX package's, character for
  character, at ``tests/test_model_symbols.py``'s configurations and at
  the full ones (ResNet-50 v1, ResNeXt-50 32x4d, MobileNet 1.0), with
  the same arguments, auxiliary states and ``infer_shape`` at 224x224
  (Inception-v4 at its canonical 299x299).

* MobileNet at the smallest input ``test_model_symbols.py`` runs
  (64x64), batch 4, through both packages' ``GraphProgram`` from one
  state: the predict forward and gradient, and the training forward
  with its new moving statistics, each within a fixed tolerance of the
  JAX package's (``torch_parity.check_more_net``).  The other four nets
  are held so in ``test_torch_models_{resnet,googlenet,inception}.py``
  (one file each of the longer JAX compiles).
"""
import pytest

import mxnet_tpu.models as jmodels
from mxnet_tpu.name import NameManager as JaxNameManager
from mxnet_tpu_torch import models
from mxnet_tpu_torch.name import NameManager

from torch_cases import MORE_NETS_SMALL
from torch_parity import check_more_net

# test_model_symbols.py's configurations, and the full ones
FULL = {"resnet_v1-50": ("resnet_v1", dict(num_layers=50)),
        "resnext-50": ("resnext", dict(num_layers=50)),
        "mobilenet-1.0": ("mobilenet", {})}
BUILDERS = dict({k: (k, kw) for k, kw in MORE_NETS_SMALL.items()}, **FULL)


def _build(family, kw):
    with JaxNameManager():
        j = getattr(jmodels, family).get_symbol(num_classes=13, **kw)
    with NameManager():
        t = getattr(models, family).get_symbol(num_classes=13, **kw)
    return j, t


@pytest.mark.parametrize("key", sorted(BUILDERS))
def test_builder_json_and_shapes_match_jax(key):
    family, kw = BUILDERS[key]
    j, t = _build(family, kw)
    assert t.tojson() == j.tojson()
    assert t.list_arguments() == j.list_arguments()
    assert t.list_auxiliary_states() == j.list_auxiliary_states()
    hw = 299 if family == "inception_v4" else 224
    shapes = dict(data=(2, 3, hw, hw), softmax_label=(2,))
    got = t.infer_shape(**shapes)
    assert got == j.infer_shape(**shapes)
    assert got[1] == [(2, 13)]


@pytest.mark.parametrize("family", ["mobilenet"])
def test_forward_and_gradient_match_jax(family):
    check_more_net(family)
