from .lenet import LeNet
from .mobilenetv1 import MobileNetV1, mobilenet_v1
from .mobilenetv2 import InvertedResidual, MobileNetV2, mobilenet_v2
from .resnet import (BasicBlock, BottleneckBlock, ResNet, resnet18,
                     resnet34, resnet50, resnet101, resnet152,
                     space_to_depth_stem_weight)
from .vgg import VGG, make_layers, vgg11, vgg13, vgg16, vgg19

__all__ = ['LeNet', 'ResNet', 'BasicBlock', 'BottleneckBlock', 'resnet18',
           'resnet34', 'resnet50', 'resnet101', 'resnet152',
           'space_to_depth_stem_weight', 'VGG', 'vgg11', 'vgg13', 'vgg16',
           'vgg19', 'make_layers', 'MobileNetV1', 'mobilenet_v1',
           'MobileNetV2', 'mobilenet_v2', 'InvertedResidual']
