"""Model entry points of the port: the transformer LM (its training
graph and its decode step), the image classifiers of the reference's
model zoo (ResNet v2 and v1, ResNeXt, LeNet, MLP, AlexNet, VGG,
MobileNet, GoogLeNet, Inception-v4) and the SSD detector, each building
the same graph as the JAX package's builder of the same name."""
from . import (alexnet, googlenet, inception_v4, lenet, mlp, mobilenet,
               resnet, resnet_v1, resnext, ssd, transformer, vgg)

get_resnet = resnet.get_symbol
get_lenet = lenet.get_symbol
get_mlp = mlp.get_symbol
get_transformer = transformer.get_symbol

__all__ = ["alexnet", "googlenet", "inception_v4", "lenet", "mlp",
           "mobilenet", "resnet", "resnet_v1", "resnext", "ssd",
           "transformer", "vgg",
           "get_resnet", "get_lenet", "get_mlp", "get_transformer"]
