"""Model entry points of the port: the transformer LM (its training
graph and its decode step) and the image classifiers of the reference's
model zoo (ResNet, LeNet, MLP, AlexNet, VGG), each building the same
graph as the JAX package's builder of the same name."""
from . import alexnet, lenet, mlp, resnet, transformer, vgg

get_resnet = resnet.get_symbol
get_lenet = lenet.get_symbol
get_mlp = mlp.get_symbol
get_transformer = transformer.get_symbol

__all__ = ["alexnet", "lenet", "mlp", "resnet", "transformer", "vgg",
           "get_resnet", "get_lenet", "get_mlp", "get_transformer"]
