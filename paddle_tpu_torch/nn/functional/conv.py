"""Convolution functionals (counterpart of
``paddle_tpu/nn/functional/conv.py``).

The reference's convolution is one ``lax.conv_general_dilated`` call,
outside any Pallas kernel; the port's is one cuDNN convolution
(``aten.convolution`` forward, ``aten.convolution_backward`` for both
gradients), its counterpart as ``torch.matmul`` is a plain product's.
Weights are OIHW (``[out, in/groups, *k]``) whatever ``data_format``
is.  A channels-last input (``NLC``/``NHWC``/``NDHWC``) is permuted to
an NC-first view without a copy: in PyTorch's terms a ``channels_last``
tensor, which cuDNN takes directly; the output is permuted back.

Padding takes the reference's forms: an int, one int per axis, ``2n``
ints, ``n`` (low, high) pairs, ``'SAME'`` (XLA's split: the odd pixel
on the high side) or ``'VALID'``.  Symmetric padding goes to the
convolution; asymmetric padding is an explicit zero ``F.pad`` first.
The bias is added after the convolution, as the reference adds it (a
separate rounding in a 16-bit dtype).  A list of another number of
pairs than spatial axes raises, as ``lax`` does there.  A window larger
than the padded input gives the reference's empty result, and zero
gradients, without a launch.

An f32 convolution computes in f32 on the card whatever the process's
``torch.backends.cudnn.allow_tf32`` says: forward and backward run with
the flag off (the rest of the port keeps TF32 off too), as XLA's f32
convolution does.

The transposed convolutions take the reference's signature and
semantics (its ``lax`` convolution over the stride-dilated input with
the flipped, swapped kernel): the weight is ``[in, out/groups, *k]``
(PyTorch's layout too), ``'SAME'`` pads ``(k - 1) // 2`` on both sides,
``'VALID'`` nothing, and ``output_size`` becomes one-sided extra
padding, a ``ValueError`` when no such padding reaches it.  The product
is one cuDNN transposed convolution under the same TF32 guard: with the
reference's padding where it is symmetric and ``output_padding`` is
below the stride or the dilation (what PyTorch can express), otherwise
unpadded and then cropped (or extended with zeros) to the reference's
window.
"""
import contextlib

import torch
import torch.nn.functional as TF

from ...amp import amp_cast

__all__ = ['conv1d', 'conv2d', 'conv3d', 'conv1d_transpose',
           'conv2d_transpose', 'conv3d_transpose']

CHANNEL_LAST = ('NLC', 'NHWC', 'NDHWC')


def _tuple(v, n):
    if isinstance(v, (list, tuple)):
        return tuple(int(x) for x in (v if len(v) == n else list(v) * n))
    return (int(v),) * n


def _padding(padding, n):
    """The reference's padding forms: ``'SAME'``/``'VALID'`` or a list
    of (low, high) pairs, ``n`` of them unless the caller gave another
    number (the convolutions and the pools decide what that means)."""
    if isinstance(padding, str):
        pad = padding.upper()
        if pad not in ('SAME', 'VALID'):
            raise ValueError(f"padding must be 'SAME' or 'VALID', got "
                             f'{padding!r}')
        return pad
    if isinstance(padding, int):
        return [(padding, padding)] * n
    padding = list(padding)
    if len(padding) == n and not isinstance(padding[0], (list, tuple)):
        return [(int(p), int(p)) for p in padding]
    if len(padding) == 2 * n:
        return [(int(padding[2 * i]), int(padding[2 * i + 1]))
                for i in range(n)]
    return [tuple(int(q) for q in p) for p in padding]


def out_sizes(sizes, ksize, stride, dilation, pad):
    """Windows along each axis of an input padded by ``pad``, 0 where
    the dilated window is larger than the padded input (XLA's empty
    result)."""
    return [max((size + lo + hi - (k - 1) * d - 1) // s + 1, 0)
            for size, k, s, d, (lo, hi) in zip(sizes, ksize, stride,
                                                dilation, pad)]


def empty_result(shape, *tensors):
    """A result of ``shape`` with no elements that depends on
    ``tensors``: its dtype is theirs, promoted, and each of them gets a
    zero gradient, as ``jax.grad`` gives them through XLA's empty
    convolution or window reduction."""
    zero = sum(t.reshape(-1)[:0].sum() for t in tensors if t is not None)
    return zero.expand(shape)


def same_pads(sizes, ksize, stride, dilation):
    """XLA's ``'SAME'``: ``ceil(size / stride)`` outputs, the padding
    they need split with the odd pixel on the high side."""
    pairs = []
    for size, k, s, d in zip(sizes, ksize, stride, dilation):
        out = -(-size // s)
        total = max((out - 1) * s + (k - 1) * d + 1 - size, 0)
        pairs.append((total // 2, total - total // 2))
    return pairs


def pad_pairs(x, pairs, value=0.0):
    """``F.pad`` of the trailing ``len(pairs)`` axes by (low, high)
    pairs given in axis order."""
    flat = []
    for lo, hi in reversed(pairs):
        flat += [lo, hi]
    return TF.pad(x, flat, value=value)


def to_channel_first(x, n):
    """[N, *spatial, C] -> an [N, C, *spatial] view (no copy)."""
    return x.permute(0, n + 1, *range(1, n + 1))


def to_channel_last(x, n):
    """[N, C, *spatial] -> an [N, *spatial, C] view (no copy)."""
    return x.permute(0, *range(2, n + 2), 1)


@contextlib.contextmanager
def _ieee_f32():
    """cuDNN with TF32 off: an f32 convolution computes in f32."""
    prev = torch.backends.cudnn.allow_tf32
    if prev:
        torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        if prev:
            torch.backends.cudnn.allow_tf32 = True


def _convolution(x, w, stride, padding, dilation, groups, opad=None):
    """``aten.convolution``; transposed when ``opad`` (its
    ``output_padding``) is given."""
    n = x.dim() - 2
    return torch.ops.aten.convolution(
        x, w, None, stride, padding, dilation, opad is not None,
        [0] * n if opad is None else opad, groups)


def _convolution_backward(gy, x, w, stride, padding, dilation, groups,
                          opad, mask):
    n = x.dim() - 2
    return torch.ops.aten.convolution_backward(
        gy, x, w, None, stride, padding, dilation, opad is not None,
        [0] * n if opad is None else opad, groups, mask)


class _Conv(torch.autograd.Function):
    """Convolution without bias (transposed when ``opad`` is not None),
    forward and backward under ``_ieee_f32``."""

    @staticmethod
    def forward(ctx, x, w, stride, padding, dilation, groups, opad=None):
        ctx.conf = (stride, padding, dilation, groups, opad)
        ctx.save_for_backward(x, w)
        with _ieee_f32():
            return _convolution(x, w, stride, padding, dilation, groups,
                                opad)

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        mask = [ctx.needs_input_grad[0], ctx.needs_input_grad[1], False]
        with _ieee_f32():
            gx, gw, _ = _convolution_backward(gy, x, w, *ctx.conf, mask)
        return gx, gw, None, None, None, None, None


def _add_bias(y, bias, channel_last):
    if bias is None:
        return y
    shape = [1] * y.dim()
    shape[-1 if channel_last else 1] = bias.shape[0]
    return y + bias.reshape(shape)


def _conv(x, w, bias, stride, padding, dilation, groups, n, data_format):
    if x.dim() != n + 2:
        raise ValueError(f'conv{n}d takes a {n + 2}-D input, got shape '
                         f'{tuple(x.shape)}')
    channel_last = data_format in CHANNEL_LAST
    x, w, bias = amp_cast(f'conv{n}d', x, w, bias)
    stride = _tuple(stride, n)
    dilation = _tuple(dilation, n)
    pad = _padding(padding, n)
    xf = to_channel_first(x, n) if channel_last else x
    if not isinstance(pad, str) and len(pad) != n:
        # lax.conv_general_dilated refuses it in the reference
        raise ValueError(f'conv{n}d: {len(pad)} padding pairs for {n} '
                         f'spatial axes')
    if pad == 'VALID':
        pad = [(0, 0)] * n
    elif pad == 'SAME':
        pad = same_pads(xf.shape[2:], w.shape[2:], stride, dilation)
    spatial = out_sizes(xf.shape[2:], w.shape[2:], stride, dilation, pad)
    if 0 in spatial:
        # the window is larger than the padded input: the reference's
        # empty result, without a launch
        y = empty_result([xf.shape[0], w.shape[0]] + spatial, x, w, bias)
        return to_channel_last(y, n) if channel_last else y
    if all(lo == hi for lo, hi in pad):
        sym = [lo for lo, _ in pad]
    else:
        xf, sym = pad_pairs(xf, pad), [0] * n
    y = _Conv.apply(xf, w, list(stride), sym, list(dilation), int(groups))
    if channel_last:
        y = to_channel_last(y, n)
    return _add_bias(y, bias, channel_last)


def conv1d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format='NCL', name=None):
    return _conv(x, weight, bias, stride, padding, dilation, groups, 1,
                 data_format)


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format='NCHW', name=None):
    return _conv(x, weight, bias, stride, padding, dilation, groups, 2,
                 data_format)


def conv3d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format='NCDHW', name=None):
    return _conv(x, weight, bias, stride, padding, dilation, groups, 3,
                 data_format)


def _output_padding(output_size, sizes, ksize, stride, dilation, pad):
    """The one-sided extra padding that takes each axis to
    ``output_size``: ``ValueError`` when it is not in ``[0, stride)``,
    as in the reference."""
    if isinstance(pad, str):
        raise TypeError('output_size takes an explicit padding, as in '
                        'the reference')
    opad = []
    for i, (size, k, s, d, (lo, hi)) in enumerate(zip(
            sizes, ksize, stride, dilation, pad)):
        base = (size - 1) * s - lo - hi + (k - 1) * d + 1
        extra = int(output_size[i]) - base
        if not 0 <= extra < max(s, 1):
            raise ValueError(f'output_size[{i}]={output_size[i]} not '
                             f'reachable from input size {size} (minimal '
                             f'{base})')
        opad.append(extra)
    return opad


def _conv_transpose(x, w, bias, stride, padding, output_padding, groups,
                    dilation, n, data_format, output_size=None):
    if x.dim() != n + 2:
        raise ValueError(f'conv{n}d_transpose takes a {n + 2}-D input, got '
                         f'shape {tuple(x.shape)}')
    channel_last = data_format in CHANNEL_LAST
    x, w, bias = amp_cast(f'conv{n}d_transpose', x, w, bias)
    stride = _tuple(stride, n)
    dilation = _tuple(dilation, n)
    pad = _padding(padding, n)
    xf = to_channel_first(x, n) if channel_last else x
    ksize = list(w.shape[2:])
    opad = list(_tuple(output_padding, n)) if output_padding else [0] * n
    if output_size is not None:
        opad = _output_padding(_tuple(output_size, n), xf.shape[2:], ksize,
                               stride, dilation, pad)
    if pad == 'VALID':
        pad = [(0, 0)] * n
    elif pad == 'SAME':
        pad = [((k - 1) // 2, (k - 1) // 2) for k in ksize]
    elif len(pad) != n:
        raise ValueError(f'conv{n}d_transpose: {len(pad)} padding pairs '
                         f'for {n} spatial axes')
    conf = (list(stride), list(dilation), int(groups))
    if all(lo == hi and o < max(s, d) for (lo, hi), o, s, d in zip(
            pad, opad, stride, dilation)):
        y = _Conv.apply(xf, w, conf[0], [lo for lo, _ in pad], conf[1],
                        conf[2], opad)
    else:
        # what PyTorch cannot express: the whole transpose, then the
        # reference's window (a negative pad crops)
        y = _Conv.apply(xf, w, conf[0], [0] * n, conf[1], conf[2], [0] * n)
        y = pad_pairs(y, [(-lo, o - hi) for (lo, hi), o in zip(pad, opad)])
    if channel_last:
        y = to_channel_last(y, n)
    return _add_bias(y, bias, channel_last)


def conv1d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format='NCL', name=None):
    return _conv_transpose(x, weight, bias, stride, padding, output_padding,
                           groups, dilation, 1, data_format, output_size)


def conv2d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format='NCHW', name=None):
    return _conv_transpose(x, weight, bias, stride, padding, output_padding,
                           groups, dilation, 2, data_format, output_size)


def conv3d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format='NCDHW', name=None):
    return _conv_transpose(x, weight, bias, stride, padding, output_padding,
                           groups, dilation, 3, data_format, output_size)
