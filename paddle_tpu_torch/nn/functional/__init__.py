from .activation import gelu, relu, relu6, softmax, tanh
from .common import dropout, embedding, embedding_prefix, linear
from .conv import (conv1d, conv1d_transpose, conv2d, conv2d_transpose,
                   conv3d, conv3d_transpose)
from .loss import binary_cross_entropy_with_logits, cross_entropy
from .norm import batch_norm, layer_norm
from .pooling import (adaptive_avg_pool1d, adaptive_avg_pool2d,
                      adaptive_avg_pool3d, adaptive_max_pool1d,
                      adaptive_max_pool2d, adaptive_max_pool3d, avg_pool1d,
                      avg_pool2d, avg_pool3d, max_pool1d, max_pool2d,
                      max_pool3d)

__all__ = ['gelu', 'relu', 'relu6', 'softmax', 'tanh', 'dropout',
           'embedding', 'embedding_prefix', 'linear', 'cross_entropy',
           'binary_cross_entropy_with_logits',
           'layer_norm', 'batch_norm', 'conv1d', 'conv2d', 'conv3d',
           'conv1d_transpose', 'conv2d_transpose', 'conv3d_transpose',
           'avg_pool1d', 'avg_pool2d', 'avg_pool3d', 'max_pool1d',
           'max_pool2d', 'max_pool3d', 'adaptive_avg_pool1d',
           'adaptive_avg_pool2d', 'adaptive_avg_pool3d',
           'adaptive_max_pool1d', 'adaptive_max_pool2d',
           'adaptive_max_pool3d']
