from .activation import ReLU, ReLU6
from .common import Dropout, Embedding, Linear
from .container import LayerList, Sequential
from .conv import Conv1D, Conv2D, Conv3D
from .layers import create_parameter
from .loss import BCEWithLogitsLoss, CrossEntropyLoss
from .norm import (BatchNorm, BatchNorm1D, BatchNorm2D, BatchNorm3D,
                   LayerNorm, SyncBatchNorm)
from .pooling import (AdaptiveAvgPool1D, AdaptiveAvgPool2D,
                      AdaptiveAvgPool3D, AdaptiveMaxPool1D,
                      AdaptiveMaxPool2D, AdaptiveMaxPool3D, AvgPool1D,
                      AvgPool2D, AvgPool3D, MaxPool1D, MaxPool2D, MaxPool3D)

__all__ = ['Dropout', 'Embedding', 'Linear', 'LayerNorm', 'ReLU', 'ReLU6',
           'Sequential', 'LayerList', 'create_parameter', 'Conv1D',
           'Conv2D', 'Conv3D', 'CrossEntropyLoss', 'BCEWithLogitsLoss',
           'BatchNorm', 'BatchNorm1D', 'BatchNorm2D', 'BatchNorm3D',
           'SyncBatchNorm', 'AvgPool1D', 'AvgPool2D', 'AvgPool3D',
           'MaxPool1D', 'MaxPool2D', 'MaxPool3D', 'AdaptiveAvgPool1D',
           'AdaptiveAvgPool2D', 'AdaptiveAvgPool3D', 'AdaptiveMaxPool1D',
           'AdaptiveMaxPool2D', 'AdaptiveMaxPool3D']
