"""Vision layers (counterpart of ``paddle_tpu/nn/layer/vision.py``)."""
from .. import functional as F
from .layers import Layer

__all__ = ['PixelShuffle']


class PixelShuffle(Layer):
    def __init__(self, upscale_factor, data_format='NCHW', name=None):
        super().__init__()
        self.upscale_factor = upscale_factor
        self.data_format = data_format

    def forward(self, x):
        return F.pixel_shuffle(x, self.upscale_factor, self.data_format)
