"""The port's SSD (``mxnet_tpu_torch/models/ssd.py``) against the JAX
package's, on the CPU.

* The training symbol (``get_symbol_train``) and the deploy symbol
  (``get_symbol``): ``tojson()`` character for character, the argument,
  auxiliary and output names, and the shapes ``infer_shape`` gives at
  300x300 (the reference's data shape: 30,120 anchors) and at 64x64.
* One ``Module`` step at 64x64, batch 4, 2 classes, on seeded scenes
  (``torch_cases.ssd_scenes``) from the JAX Module's Xavier parameters
  carried across by ``convert``: SGD lr 0.1, momentum 0.9, wd 5e-4 (the
  toy example's).  The forward's class probabilities and its smooth-L1
  location loss within 1e-5 of their largest magnitude, each
  parameter's update within 1e-4 norm-wise and every element within
  1e-3 of the tensor's largest change (the heads and extra layers at
  4x4 and 2x2 sum few products: cls_pred3's weight update stands 2.5e-4
  of its largest change apart, 2.5e-5 norm-wise; the biases of the
  convolutions that BatchNorm follows have a gradient of 0 up to
  rounding, and their updates stay under 1e-5 of the model's largest) and
  the new BatchNorm statistics within 1e-5; the training forward's
  detections (``det_out``, the NMS kernel's path) have the JAX shape, finite
  values, and rows that are valid exactly where their class id is.
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu.models import ssd as jssd
from mxnet_tpu.name import NameManager as JaxNameManager
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import convert
from mxnet_tpu_torch.models import ssd
from mxnet_tpu_torch.name import NameManager

from torch_cases import ssd_scenes

KW = dict(num_classes=20, nms_thresh=0.45, nms_topk=400)


def _pair(builder, **kw):
    with JaxNameManager():
        j = getattr(jssd, builder)(**kw)
    with NameManager():
        t = getattr(ssd, builder)(**kw)
    return j, t


@pytest.mark.parametrize("builder", ["get_symbol_train", "get_symbol"])
def test_symbols_match_jax(builder):
    j, t = _pair(builder, **KW)
    assert t.tojson() == j.tojson()
    assert t.list_arguments() == j.list_arguments()
    assert t.list_auxiliary_states() == j.list_auxiliary_states()
    assert t.list_outputs() == j.list_outputs()
    for hw in (300, 64):
        shapes = dict(data=(2, 3, hw, hw))
        if builder == "get_symbol_train":
            shapes["label"] = (2, 50, 5)
        got, want = t.infer_shape(**shapes), j.infer_shape(**shapes)
        assert got == want
        if builder == "get_symbol":      # 4 x (75^2 + 38^2 + 19^2 + 10^2)
            assert got[1] == [(2, {300: 30120, 64: 1360}[hw], 6)]


def _batch(pkg, X, Y):
    return pkg.io.DataBatch(data=[pkg.nd.array(X, ctx=pkg.cpu())],
                            label=[pkg.nd.array(Y, ctx=pkg.cpu())])


def test_module_step_matches_jax():
    X, Y = ssd_scenes(4, 64, 3, 2, seed=0)
    j_net, t_net = _pair("get_symbol_train", num_classes=2)
    shapes = dict(data_shapes=[("data", X.shape)],
                  label_shapes=[("label", Y.shape)])
    opt = dict(optimizer="sgd", optimizer_params={
        "learning_rate": 0.1, "momentum": 0.9, "wd": 5e-4})
    j_mod = jmx.mod.Module(j_net, data_names=("data",),
                           label_names=("label",), context=jmx.cpu())
    j_mod.bind(**shapes)
    jmx.random.seed(0)
    j_mod.init_params(initializer=jmx.init.Xavier())
    args, auxs = ({k: v.asnumpy() for k, v in part.items()}
                  for part in j_mod.get_params())
    t_mod = tmx.mod.Module(t_net, data_names=("data",),
                           label_names=("label",), context=tmx.cpu())
    t_mod.bind(**shapes)
    t_args, t_auxs = convert.module_params_from_numpy(args, auxs)
    t_mod.init_params(arg_params=t_args, aux_params=t_auxs)
    for mod, pkg in ((j_mod, jmx), (t_mod, tmx)):
        mod.init_optimizer(**opt)
        mod.forward_backward(_batch(pkg, X, Y))
        mod.update()
    j_out = [o.asnumpy() for o in j_mod.get_outputs()]
    t_out = [o.asnumpy() for o in t_mod.get_outputs()]
    assert [o.shape for o in t_out] == [o.shape for o in j_out]
    for k in (0, 1, 2):                  # cls_prob, loc_loss, cls_label
        scale = max(1.0, np.abs(j_out[k]).max())
        assert np.abs(t_out[k] - j_out[k]).max() <= 1e-5 * scale, k
    det = t_out[3]
    assert np.isfinite(det).all()
    assert ((det[..., 0] >= 0) == (det[..., 1] > 0)).all()
    assert (det[..., 0] >= 0).any()
    (j_args, j_auxs), (t_args, t_auxs) = j_mod.get_params(), \
        t_mod.get_params()
    upd = {name: (t_args[name].asnumpy() - args[name],
                  j_args[name].asnumpy() - args[name]) for name in args}
    largest = max(np.abs(want).max() for _, want in upd.values())
    for name, (got, want) in upd.items():
        if name.endswith("_bias") and name[:-5] + "_bn_gamma" in args:
            # a bias that BatchNorm subtracts again: its gradient is 0 up
            # to rounding in both packages, so is its update
            assert max(np.abs(got).max(), np.abs(want).max()) <= \
                1e-5 * largest, name
            continue
        assert np.abs(want).max() > 0, name
        assert np.linalg.norm(got - want) <= 1e-4 * np.linalg.norm(want), \
            name
        assert np.abs(got - want).max() <= 1e-3 * np.abs(want).max(), name
    for name in auxs:
        want = j_auxs[name].asnumpy()
        assert np.abs(t_auxs[name].asnumpy() - want).max() <= \
            1e-5 * max(1.0, np.abs(want).max()), name
