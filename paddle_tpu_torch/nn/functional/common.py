"""Common functionals (counterpart of
``paddle_tpu/nn/functional/common.py``; the port has ``linear``,
``dropout``, ``embedding`` and ``embedding_prefix``).  Each casts its
inputs through the AMP policy under the reference's op name."""
import torch
import torch.nn.functional as TF

from ...amp import amp_cast
from ...core import rng

__all__ = ['linear', 'dropout', 'embedding', 'embedding_prefix']

_DROPOUT_MODES = ('upscale_in_train', 'downscale_in_infer')


def linear(x, weight, bias=None):
    """``x @ weight + bias`` with paddle's ``weight [in, out]``."""
    x, weight, bias = amp_cast('linear', x, weight, bias)
    return TF.linear(x, weight.t(), bias)


def dropout(x, p=0.5, axis=None, training=True, mode='upscale_in_train'):
    """Zero each element with probability ``p``, as the reference does.

    ``upscale_in_train`` scales the kept elements by ``1 / (1 - p)`` in
    training and is the identity otherwise; ``downscale_in_infer``
    keeps them as they are in training and scales by ``1 - p`` in
    eval.  ``p == 0`` (and eval in the first mode) returns ``x``,
    ``p == 1`` zeros.  ``axis`` (an int or a list) draws one keep
    decision per index of those axes, shared along the others.  The
    keep mask is ``uniform < 1 - p`` drawn from the device's generator
    (``core.rng``); in f32 a ``p`` below 2^-25 keeps every element and
    scales by exactly 1."""
    if mode not in _DROPOUT_MODES:
        raise ValueError(f'mode must be one of {_DROPOUT_MODES}, got '
                         f'{mode!r}')
    if not 0.0 <= p <= 1.0:
        raise ValueError(f'dropout probability must be in [0, 1], got {p}')
    x, = amp_cast('dropout', x)
    if not training or p == 0.0:
        if mode == 'downscale_in_infer' and not training:
            return x * (1.0 - p)
        return x
    if p == 1.0:
        return x * 0.0
    shape = list(x.shape)
    if axis is not None:
        axes = axis if isinstance(axis, (list, tuple)) else [axis]
        shape = [s if i in axes else 1 for i, s in enumerate(shape)]
    keep = torch.rand(shape, generator=rng.generator(x.device),
                      device=x.device) < (1.0 - p)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    if mode == 'upscale_in_train':
        return torch.where(keep, x / (1.0 - p), zero)
    return torch.where(keep, x, zero)


def embedding(x, weight):
    """Row lookup ``weight[x]``."""
    x, weight = amp_cast('embedding', x, weight)
    return TF.embedding(x, weight)


def embedding_prefix(weight, length):
    """The first ``length`` rows of an embedding table: the training
    path's position embedding, ``weight[:length]``."""
    weight, = amp_cast('embedding_prefix', weight)
    return weight[:length]
