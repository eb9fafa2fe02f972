"""Pooling functionals (counterpart of
``paddle_tpu/nn/functional/pooling.py``, which reduces windows with
``lax.reduce_window``).

The reference's semantics, in PyTorch's pooling calls:
- max pooling pads with ``-inf``: PyTorch's own padding where it is
  symmetric and at most half the window (the same windows), an explicit
  ``-inf`` ``F.pad`` otherwise; the gradient goes to the first maximum
  of a window in row-major order, as XLA's select-and-scatter sends it;
- average pooling sums each window over zero padding
  (``divisor_override=1``) and divides by the number of input elements
  in it (``exclusive``) or by the window's size;
- ``ceil_mode`` extends only the high padding, so a partial last window
  is kept (a window wholly in that padding gives ``-inf`` for max and
  NaN for exclusive average, as in the reference); ``'SAME'`` is XLA's
  split and takes no ``ceil_mode``;
- a window larger than the padded input gives the reference's empty
  result without a launch; of a padding list the first ``n`` pairs are
  read, as the reference reads them;
- adaptive pooling reduces one spatial axis after another: the whole
  axis at output 1, equal bins by a reshape where the size divides,
  otherwise ``floor(j*size/out) .. ceil((j+1)*size/out)`` bins; its max
  is ``amax``, whose gradient splits evenly between ties, as
  ``jnp.max``'s does.
Channels-last inputs are permuted to a ``channels_last`` view, as in
``conv.py``.  The max pools take ``return_mask`` and, as the reference,
never read it: the pooled tensor alone comes back.
"""
import math

import torch
import torch.nn.functional as TF

from ...amp import amp_cast
from .conv import (CHANNEL_LAST, _padding, _tuple, empty_result, out_sizes,
                   pad_pairs, same_pads, to_channel_first, to_channel_last)

__all__ = [
    'avg_pool1d', 'avg_pool2d', 'avg_pool3d', 'max_pool1d', 'max_pool2d',
    'max_pool3d', 'adaptive_avg_pool1d', 'adaptive_avg_pool2d',
    'adaptive_avg_pool3d', 'adaptive_max_pool1d', 'adaptive_max_pool2d',
    'adaptive_max_pool3d',
]

_MAX = {1: TF.max_pool1d, 2: TF.max_pool2d, 3: TF.max_pool3d}


def _window_sum(x, ksize, stride, n):
    """Sum of each window of an unpadded NC-first ``x``."""
    if n == 1:
        return TF.avg_pool2d(x.unsqueeze(2), (1,) + ksize, (1,) + stride,
                             divisor_override=1).squeeze(2)
    pool = TF.avg_pool2d if n == 2 else TF.avg_pool3d
    return pool(x, ksize, stride, divisor_override=1)


def _lowest(dtype):
    if dtype.is_floating_point:
        return -math.inf
    return torch.iinfo(dtype).min


def _pool(x, ksize, stride, padding, n, data_format, kind, exclusive=True,
          ceil_mode=False):
    channel_last = data_format in CHANNEL_LAST
    x, = amp_cast(f'{kind}_pool{n}d', x)
    ksize = _tuple(ksize, n)
    stride = _tuple(stride if stride is not None else ksize, n)
    pad = _padding(padding, n)
    xf = to_channel_first(x, n) if channel_last else x
    sizes = tuple(xf.shape[2:])
    if pad == 'SAME':
        pad = same_pads(sizes, ksize, stride, (1,) * n)
    else:
        if pad == 'VALID':
            pad = [(0, 0)] * n
        elif len(pad) < n:
            raise ValueError(f'{kind}_pool{n}d: {len(pad)} padding pairs '
                             f'for {n} spatial axes')
        pad = pad[:n]       # the reference reads the first n pairs
        if ceil_mode:
            pad = list(pad)
            for i in range(n):
                size = sizes[i] + pad[i][0] + pad[i][1]
                rem = (size - ksize[i]) % stride[i]
                if rem:
                    pad[i] = (pad[i][0], pad[i][1] + stride[i] - rem)
    spatial = out_sizes(sizes, ksize, stride, (1,) * n, pad)
    if 0 in spatial:
        # the window is larger than the padded input: the reference's
        # empty result, without a launch
        y = empty_result(list(xf.shape[:2]) + spatial, x)
        return to_channel_last(y, n) if channel_last else y
    if kind == 'max':
        if all(lo == hi and 2 * lo <= k for (lo, hi), k in zip(pad, ksize)):
            y = _MAX[n](xf, ksize, stride, [lo for lo, _ in pad])
        else:
            y = _MAX[n](pad_pairs(xf, pad, _lowest(xf.dtype)), ksize, stride)
    else:
        padded = any(lo or hi for lo, hi in pad)
        s = _window_sum(pad_pairs(xf, pad) if padded else xf, ksize, stride,
                        n)
        if exclusive:
            ones = torch.ones((1, 1) + sizes, dtype=xf.dtype,
                              device=xf.device)
            cnt = _window_sum(pad_pairs(ones, pad) if padded else ones,
                              ksize, stride, n)
            y = s / cnt
        else:
            y = s / float(math.prod(ksize))
    return to_channel_last(y, n) if channel_last else y


def avg_pool1d(x, kernel_size, stride=None, padding=0, exclusive=True,
               ceil_mode=False, name=None):
    return _pool(x, kernel_size, stride, padding, 1, 'NCL', 'avg', exclusive,
                 ceil_mode)


def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format='NCHW',
               name=None):
    return _pool(x, kernel_size, stride, padding, 2, data_format, 'avg',
                 exclusive, ceil_mode)


def avg_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format='NCDHW',
               name=None):
    return _pool(x, kernel_size, stride, padding, 3, data_format, 'avg',
                 exclusive, ceil_mode)


def max_pool1d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, name=None):
    return _pool(x, kernel_size, stride, padding, 1, 'NCL', 'max',
                 ceil_mode=ceil_mode)


def max_pool2d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format='NCHW', name=None):
    return _pool(x, kernel_size, stride, padding, 2, data_format, 'max',
                 ceil_mode=ceil_mode)


def max_pool3d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format='NCDHW', name=None):
    return _pool(x, kernel_size, stride, padding, 3, data_format, 'max',
                 ceil_mode=ceil_mode)


def _adaptive(x, output_size, n, kind, data_format):
    channel_last = data_format in CHANNEL_LAST
    x, = amp_cast(f'adaptive_{kind}_pool{n}d', x)
    out = _tuple(output_size, n)
    sp_axes = range(1, 1 + n) if channel_last else range(2, 2 + n)

    def reduce(t, ax, keepdim):
        if kind == 'max':
            return torch.amax(t, dim=ax, keepdim=keepdim)
        return torch.mean(t, dim=ax, keepdim=keepdim)

    res = x
    for i, ax in enumerate(sp_axes):
        size = res.shape[ax]
        if out[i] == 1:
            res = reduce(res, ax, True)
        elif size % out[i] == 0:
            shape = res.shape[:ax] + (out[i], size // out[i]) \
                + res.shape[ax + 1:]
            res = reduce(res.reshape(shape), ax + 1, False)
        else:
            starts = [j * size // out[i] for j in range(out[i])]
            ends = [-(-(j + 1) * size // out[i]) for j in range(out[i])]
            res = torch.cat([reduce(res.narrow(ax, s, e - s), ax, True)
                             for s, e in zip(starts, ends)], dim=ax)
    return res


def adaptive_avg_pool1d(x, output_size, name=None):
    return _adaptive(x, output_size, 1, 'avg', 'NCL')


def adaptive_avg_pool2d(x, output_size, data_format='NCHW', name=None):
    return _adaptive(x, output_size, 2, 'avg', data_format)


def adaptive_avg_pool3d(x, output_size, data_format='NCDHW', name=None):
    return _adaptive(x, output_size, 3, 'avg', data_format)


def adaptive_max_pool1d(x, output_size, return_mask=False, name=None):
    return _adaptive(x, output_size, 1, 'max', 'NCL')


def adaptive_max_pool2d(x, output_size, return_mask=False, name=None):
    return _adaptive(x, output_size, 2, 'max', 'NCHW')


def adaptive_max_pool3d(x, output_size, return_mask=False, name=None):
    return _adaptive(x, output_size, 3, 'max', 'NCDHW')
