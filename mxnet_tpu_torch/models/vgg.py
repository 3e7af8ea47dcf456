"""VGG (port of ``mxnet_tpu/models/vgg.py``; reference
example/image-classification/symbols/vgg.py), with and without batch
norm."""
from .. import symbol as sym

vgg_spec = {
    11: ([1, 1, 2, 2, 2], [64, 128, 256, 512, 512]),
    13: ([2, 2, 2, 2, 2], [64, 128, 256, 512, 512]),
    16: ([2, 2, 3, 3, 3], [64, 128, 256, 512, 512]),
    19: ([2, 2, 4, 4, 4], [64, 128, 256, 512, 512]),
}


def get_feature(internal_layer, layers, filters, batch_norm=False):
    for i, num in enumerate(layers):
        for j in range(num):
            internal_layer = sym.Convolution(
                internal_layer, kernel=(3, 3), pad=(1, 1),
                num_filter=filters[i], name="conv%s_%s" % (i + 1, j + 1))
            if batch_norm:
                internal_layer = sym.BatchNorm(
                    internal_layer, name="bn%s_%s" % (i + 1, j + 1))
            internal_layer = sym.Activation(
                internal_layer, act_type="relu",
                name="relu%s_%s" % (i + 1, j + 1))
        internal_layer = sym.Pooling(
            internal_layer, pool_type="max", kernel=(2, 2), stride=(2, 2),
            name="pool%s" % (i + 1))
    return internal_layer


def get_classifier(input_data, num_classes):
    flatten = sym.Flatten(input_data, name="flatten")
    fc6 = sym.FullyConnected(flatten, num_hidden=4096, name="fc6")
    relu6 = sym.Activation(fc6, act_type="relu", name="relu6")
    drop6 = sym.Dropout(relu6, p=0.5, name="drop6")
    fc7 = sym.FullyConnected(drop6, num_hidden=4096, name="fc7")
    relu7 = sym.Activation(fc7, act_type="relu", name="relu7")
    drop7 = sym.Dropout(relu7, p=0.5, name="drop7")
    return sym.FullyConnected(drop7, num_hidden=num_classes, name="fc8")


def get_symbol(num_classes=1000, num_layers=16, batch_norm=False,
               dtype="float32", **kwargs):
    if num_layers not in vgg_spec:
        raise ValueError("no spec for VGG-%d" % num_layers)
    layers, filters = vgg_spec[num_layers]
    data = sym.Variable(name="data")
    if dtype != "float32":
        data = sym.Cast(data, dtype=dtype)
    feature = get_feature(data, layers, filters, batch_norm)
    classifier = get_classifier(feature, num_classes)
    if dtype != "float32":
        classifier = sym.Cast(classifier, dtype="float32")
    return sym.SoftmaxOutput(classifier, name="softmax")
