"""Activation functionals (counterpart of
``paddle_tpu/nn/functional/activation.py``; the port has ``relu``,
``relu6``, ``gelu``, ``softmax`` and ``tanh``).  Each casts its input
through the AMP policy under the reference's op name."""
import torch
import torch.nn.functional as TF

from ...amp import amp_cast
from ...ops.fused_softmax import fused_softmax

__all__ = ['relu', 'relu6', 'gelu', 'softmax', 'tanh']


def relu(x, name=None):
    x, = amp_cast('relu', x)
    return torch.relu(x)


def relu6(x, name=None):
    """``min(max(x, 0), 6)``; its gradient is 0 at 0 and at 6, as
    ``jax.nn.relu6``'s."""
    x, = amp_cast('relu6', x)
    return TF.relu6(x)


def gelu(x, approximate=False):
    """GELU; ``approximate=True`` is the tanh form
    ``0.5 x (1 + tanh(sqrt(2/pi) (x + 0.044715 x^3)))`` that the
    reference's ``mlp_gelu`` uses."""
    x, = amp_cast('gelu', x)
    return TF.gelu(x, approximate='tanh' if approximate else 'none')


def softmax(x, axis=-1, dtype=None):
    """Softmax along ``axis``: the last axis goes through
    ``fused_softmax`` (the hand-written kernel on a CUDA tensor), any
    other through ``torch.softmax``, as in the reference.  ``softmax``
    is black-listed under AMP, so the kernel sees f32 scores; ``dtype``
    casts the input first."""
    x, = amp_cast('softmax', x)
    if dtype is not None:
        x = x.to(dtype)
    if axis in (-1, x.dim() - 1):
        return fused_softmax(x)
    return torch.softmax(x, dim=axis)


def tanh(x):
    x, = amp_cast('tanh', x)
    return torch.tanh(x)
