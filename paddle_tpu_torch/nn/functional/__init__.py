from . import activation, common, conv, loss, norm, pooling
from .activation import *   # noqa: F401,F403
from .common import *       # noqa: F401,F403
from .conv import (conv1d, conv1d_transpose, conv2d, conv2d_transpose,
                   conv3d, conv3d_transpose)
from .loss import *         # noqa: F401,F403
from .norm import batch_norm, layer_norm
from .pooling import (adaptive_avg_pool1d, adaptive_avg_pool2d,
                      adaptive_avg_pool3d, adaptive_max_pool1d,
                      adaptive_max_pool2d, adaptive_max_pool3d, avg_pool1d,
                      avg_pool2d, avg_pool3d, max_pool1d, max_pool2d,
                      max_pool3d)

__all__ = (activation.__all__ + common.__all__ + loss.__all__
           + ['layer_norm', 'batch_norm', 'conv1d', 'conv2d', 'conv3d',
              'conv1d_transpose', 'conv2d_transpose', 'conv3d_transpose',
              'avg_pool1d', 'avg_pool2d', 'avg_pool3d', 'max_pool1d',
              'max_pool2d', 'max_pool3d', 'adaptive_avg_pool1d',
              'adaptive_avg_pool2d', 'adaptive_avg_pool3d',
              'adaptive_max_pool1d', 'adaptive_max_pool2d',
              'adaptive_max_pool3d'])
