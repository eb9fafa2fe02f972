"""Image transforms (counterpart of ``paddle_tpu/vision/transforms``;
host numpy, Paddle's python/paddle/vision/transforms)."""
from .transforms import *  # noqa: F401,F403
from .transforms import __all__ as _t_all
from . import functional  # noqa: F401
from .functional import (  # noqa: F401
    to_tensor, resize, crop, center_crop, hflip, vflip, pad, rotate,
    to_grayscale, normalize, adjust_brightness, adjust_contrast,
    adjust_saturation, adjust_hue)

__all__ = list(_t_all) + [
    'to_tensor', 'resize', 'crop', 'center_crop', 'hflip', 'vflip', 'pad',
    'rotate', 'to_grayscale', 'normalize', 'adjust_brightness',
    'adjust_contrast', 'adjust_saturation', 'adjust_hue']
