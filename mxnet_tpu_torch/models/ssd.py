"""SSD detector symbol (port of ``mxnet_tpu/models/ssd.py``: the same
graphs and ``tojson()``; reference example/ssd/symbol/symbol_builder.py —
architecture rebuilt: multi-scale feature maps + MultiBox heads).

``get_symbol_train`` returns the training symbol (softmax cls loss +
smooth-L1 loc loss via MakeLoss heads, with the MultiBoxDetection output
``det_out`` behind BlockGrad, so every training forward runs the NMS
kernel); ``get_symbol`` the deploy symbol ending in MultiBoxDetection.
"""
from __future__ import annotations

from .. import symbol as sym


def _conv_act(data, name, num_filter, kernel=(3, 3), pad=(1, 1),
              stride=(1, 1)):
    c = sym.Convolution(data, kernel=kernel, pad=pad, stride=stride,
                        num_filter=num_filter, name=name)
    b = sym.BatchNorm(c, name=name + "_bn")
    return sym.Activation(b, act_type="relu", name=name + "_relu")


def _backbone(data):
    """Small VGG-style backbone producing the first feature map."""
    body = _conv_act(data, "conv1_1", 32)
    body = _conv_act(body, "conv1_2", 32)
    body = sym.Pooling(body, kernel=(2, 2), stride=(2, 2), pool_type="max")
    body = _conv_act(body, "conv2_1", 64)
    body = _conv_act(body, "conv2_2", 64)
    body = sym.Pooling(body, kernel=(2, 2), stride=(2, 2), pool_type="max")
    body = _conv_act(body, "conv3_1", 128)
    body = _conv_act(body, "conv3_2", 128)
    return body


def multi_layer_feature(data, num_extra=3):
    """Feature pyramid: backbone output + stride-2 extra layers
    (reference symbol_builder multi_layer_feature)."""
    layers = [_backbone(data)]
    num_filters = [128, 128, 128, 128]
    for i in range(num_extra):
        prev = layers[-1]
        f = num_filters[min(i, len(num_filters) - 1)]
        body = _conv_act(prev, "extra%d_1" % i, f // 2, kernel=(1, 1),
                         pad=(0, 0))
        body = _conv_act(body, "extra%d_2" % i, f, kernel=(3, 3), pad=(1, 1),
                         stride=(2, 2))
        layers.append(body)
    return layers


def multibox_layer(from_layers, num_classes, sizes, ratios, clip=False):
    """Per-scale cls/loc heads + anchors (reference multibox_layer)."""
    cls_preds = []
    loc_preds = []
    anchors = []
    for i, layer in enumerate(from_layers):
        size = sizes[i]
        ratio = ratios[i]
        num_anchors = len(size) + len(ratio) - 1
        num_cls_ch = num_anchors * (num_classes + 1)
        cls = sym.Convolution(layer, kernel=(3, 3), pad=(1, 1),
                              num_filter=num_cls_ch,
                              name="cls_pred%d" % i)
        # (B, A*(C+1), H, W) -> (B, (C+1), A*H*W)
        cls = sym.transpose(cls, axes=(0, 2, 3, 1))
        cls = sym.Reshape(cls, shape=(0, -1, num_classes + 1))
        cls = sym.transpose(cls, axes=(0, 2, 1))
        cls_preds.append(cls)
        loc = sym.Convolution(layer, kernel=(3, 3), pad=(1, 1),
                              num_filter=num_anchors * 4,
                              name="loc_pred%d" % i)
        loc = sym.transpose(loc, axes=(0, 2, 3, 1))
        loc = sym.Reshape(loc, shape=(0, -1))
        loc_preds.append(loc)
        anchor = sym.create("_contrib_MultiBoxPrior", [layer],
                            dict(sizes=size, ratios=ratio, clip=clip),
                            name="anchor%d" % i)
        anchors.append(anchor)
    cls_preds_c = sym.Concat(*cls_preds, dim=2, name="cls_preds")
    loc_preds_c = sym.Concat(*loc_preds, dim=1, name="loc_preds")
    anchors_c = sym.Concat(*anchors, dim=1, name="anchors")
    return [loc_preds_c, cls_preds_c, anchors_c]


_DEFAULT_SIZES = [(0.2, 0.272), (0.37, 0.447), (0.54, 0.619), (0.71, 0.79)]
_DEFAULT_RATIOS = [(1.0, 2.0, 0.5)] * 4


def get_symbol_train(num_classes=20, nms_thresh=0.5, force_suppress=False,
                     nms_topk=400, **kwargs):
    """Training symbol (reference symbol_builder.get_symbol_train)."""
    data = sym.Variable("data")
    label = sym.Variable("label")
    layers = multi_layer_feature(data)
    loc_preds, cls_preds, anchors = multibox_layer(
        layers, num_classes, _DEFAULT_SIZES, _DEFAULT_RATIOS, clip=True)
    tmp = sym.create("_contrib_MultiBoxTarget",
                     [anchors, label, cls_preds],
                     dict(overlap_threshold=0.5, ignore_label=-1,
                          negative_mining_ratio=3),
                     name="multibox_target")
    loc_target = tmp[0]
    loc_target_mask = tmp[1]
    cls_target = tmp[2]
    cls_prob = sym.SoftmaxOutput(cls_preds, cls_target,
                                 ignore_label=-1, use_ignore=True,
                                 multi_output=True,
                                 normalization="valid", name="cls_prob")
    loc_diff = loc_target_mask * (loc_preds - loc_target)
    loc_loss_ = sym.smooth_l1(loc_diff, scalar=1.0)
    loc_loss = sym.MakeLoss(loc_loss_, grad_scale=1.0,
                            normalization="valid", name="loc_loss")
    cls_label = sym.BlockGrad(cls_target, name="cls_label")
    det = sym.create("_contrib_MultiBoxDetection",
                     [cls_prob, loc_preds, anchors],
                     dict(nms_threshold=nms_thresh,
                          force_suppress=force_suppress,
                          variances=(0.1, 0.1, 0.2, 0.2),
                          nms_topk=nms_topk),
                     name="detection")
    det = sym.BlockGrad(det, name="det_out")
    return sym.Group([cls_prob, loc_loss, cls_label, det])


def get_symbol(num_classes=20, nms_thresh=0.5, force_suppress=False,
               nms_topk=400, **kwargs):
    """Deploy symbol ending in detections (reference get_symbol)."""
    data = sym.Variable("data")
    layers = multi_layer_feature(data)
    loc_preds, cls_preds, anchors = multibox_layer(
        layers, num_classes, _DEFAULT_SIZES, _DEFAULT_RATIOS, clip=True)
    cls_prob = sym.softmax(cls_preds, axis=1, name="cls_prob")
    return sym.create("_contrib_MultiBoxDetection",
                      [cls_prob, loc_preds, anchors],
                      dict(nms_threshold=nms_thresh,
                           force_suppress=force_suppress,
                           variances=(0.1, 0.1, 0.2, 0.2),
                           nms_topk=nms_topk),
                      name="detection")
