"""Layers, functionals, initializers and gradient clipping of the port
(counterpart of ``paddle_tpu/nn``)."""
from . import clip, functional, initializer
from .clip import ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue
from .layer import (AdaptiveAvgPool1D, AdaptiveAvgPool2D, AdaptiveAvgPool3D,
                    AdaptiveMaxPool1D, AdaptiveMaxPool2D, AdaptiveMaxPool3D,
                    AvgPool1D, AvgPool2D, AvgPool3D, BatchNorm, BatchNorm1D,
                    BatchNorm2D, BatchNorm3D, BCEWithLogitsLoss, Conv1D,
                    Conv2D, Conv3D, CrossEntropyLoss, Dropout, Embedding,
                    LayerList, LayerNorm, Linear,
                    MaxPool1D, MaxPool2D, MaxPool3D, ReLU, ReLU6, Sequential,
                    SyncBatchNorm)

__all__ = ['clip', 'functional', 'initializer', 'Dropout', 'Embedding',
           'LayerNorm', 'Linear', 'ReLU', 'ReLU6', 'Sequential', 'LayerList',
           'Conv1D', 'Conv2D', 'Conv3D', 'CrossEntropyLoss',
           'BCEWithLogitsLoss', 'BatchNorm',
           'BatchNorm1D', 'BatchNorm2D', 'BatchNorm3D', 'SyncBatchNorm',
           'AvgPool1D', 'AvgPool2D', 'AvgPool3D', 'MaxPool1D', 'MaxPool2D',
           'MaxPool3D', 'AdaptiveAvgPool1D', 'AdaptiveAvgPool2D',
           'AdaptiveAvgPool3D', 'AdaptiveMaxPool1D', 'AdaptiveMaxPool2D',
           'AdaptiveMaxPool3D', 'ClipGradByValue', 'ClipGradByNorm',
           'ClipGradByGlobalNorm']
