from .lenet import LeNet
from .resnet import (BasicBlock, BottleneckBlock, ResNet, resnet18,
                     resnet34, resnet50, resnet101, resnet152,
                     space_to_depth_stem_weight)

__all__ = ['LeNet', 'ResNet', 'BasicBlock', 'BottleneckBlock', 'resnet18',
           'resnet34', 'resnet50', 'resnet101', 'resnet152',
           'space_to_depth_stem_weight']
