from . import activation, common, conv, loss, norm, pooling, vision
from .activation import *   # noqa: F401,F403
from .common import *       # noqa: F401,F403
from .conv import (conv1d, conv1d_transpose, conv2d, conv2d_transpose,
                   conv3d, conv3d_transpose)
from .loss import *         # noqa: F401,F403
from .norm import (batch_norm, group_norm, instance_norm, layer_norm,
                   local_response_norm)
from .pooling import (adaptive_avg_pool1d, adaptive_avg_pool2d,
                      adaptive_avg_pool3d, adaptive_max_pool1d,
                      adaptive_max_pool2d, adaptive_max_pool3d, avg_pool1d,
                      avg_pool2d, avg_pool3d, max_pool1d, max_pool2d,
                      max_pool3d)
from .vision import affine_grid, grid_sample
from ...tensor.math import tanh_  # noqa: F401  (the in-place alias)

__all__ = (activation.__all__ + common.__all__ + conv.__all__
           + norm.__all__ + pooling.__all__ + loss.__all__
           + vision.__all__ + ['tanh_'])
