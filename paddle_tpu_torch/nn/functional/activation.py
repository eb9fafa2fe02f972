"""Activation functionals (counterpart of
``paddle_tpu/nn/functional/activation.py``; the port has ``gelu``)."""
import torch.nn.functional as TF

from ...amp import amp_cast

__all__ = ['gelu']


def gelu(x, approximate=False):
    """GELU; ``approximate=True`` is the tanh form
    ``0.5 x (1 + tanh(sqrt(2/pi) (x + 0.044715 x^3)))`` that the
    reference's ``mlp_gelu`` uses."""
    x, = amp_cast('gelu', x)
    return TF.gelu(x, approximate='tanh' if approximate else 'none')
