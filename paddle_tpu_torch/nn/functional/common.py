"""Common functionals (counterpart of
``paddle_tpu/nn/functional/common.py``; the port has ``linear``, the
dropouts, ``embedding`` and ``embedding_prefix``, ``one_hot``, ``pad``,
``label_smooth``, ``cosine_similarity``, ``normalize``,
``sequence_mask`` and ``gather_tree``; the vision half, ``interpolate``,
``unfold`` and the rest, waits for its slice).  Each casts its inputs
through the AMP policy under the reference's op name."""
import numpy as np
import torch
import torch.nn.functional as TF

from ...amp import amp_cast
from ...core import rng
from .norm import _scalar

__all__ = ['linear', 'dropout', 'dropout2d', 'dropout3d', 'alpha_dropout',
           'embedding', 'embedding_prefix', 'one_hot', 'pad',
           'cosine_similarity', 'normalize', 'label_smooth',
           'sequence_mask', 'gather_tree']

_DROPOUT_MODES = ('upscale_in_train', 'downscale_in_infer')


def linear(x, weight, bias=None, name=None):
    """``x @ weight + bias`` with paddle's ``weight [in, out]``."""
    x, weight, bias = amp_cast('linear', x, weight, bias)
    return TF.linear(x, weight.t(), bias)


def dropout(x, p=0.5, axis=None, training=True, mode='upscale_in_train',
            name=None):
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


def dropout2d(x, p=0.5, training=True, data_format='NCHW', name=None):
    """One keep decision per (sample, channel)."""
    ax = [0, 1] if data_format == 'NCHW' else [0, 3]
    return dropout(x, p, axis=ax, training=training)


def dropout3d(x, p=0.5, training=True, data_format='NCDHW', name=None):
    ax = [0, 1] if data_format == 'NCDHW' else [0, 4]
    return dropout(x, p, axis=ax, training=training)


def alpha_dropout(x, p=0.5, training=True, name=None):
    """SELU's dropout: a dropped element takes ``-alpha * scale``, then
    ``a * x + b`` restores the mean and variance, as the reference
    computes it."""
    if not training or p == 0.0:
        return x
    x, = amp_cast('alpha_dropout', x)
    alpha_p = -1.6732632423543772 * 1.0507009873554805
    a = 1.0 / np.sqrt((1.0 - p) * (1.0 + p * alpha_p ** 2))
    b = -a * alpha_p * p
    keep = torch.rand(x.shape, generator=rng.generator(x.device),
                      device=x.device) < (1.0 - p)
    y = torch.where(keep, x, torch.full((), alpha_p, dtype=x.dtype,
                                        device=x.device))
    return (a * y + b).to(x.dtype)


def embedding(x, weight, padding_idx=None, sparse=False, name=None):
    """Row lookup ``weight[x]``; lookups of ``padding_idx`` give zeros
    (masked, so the row gets no gradient), as the reference's.
    ``sparse`` is read as dense, as the reference reads it."""
    x, weight = amp_cast('embedding', x, weight)
    out = TF.embedding(x, weight)
    if padding_idx is not None:
        out = out.masked_fill((x == padding_idx)[..., None], 0.0)
    return out


def embedding_prefix(weight, length):
    """The first ``length`` rows of an embedding table: the training
    path's position embedding, ``weight[:length]``."""
    weight, = amp_cast('embedding_prefix', weight)
    return weight[:length]


def one_hot(x, num_classes, name=None):
    """f32 one-hot rows; an id outside ``[0, num_classes)`` gives a row
    of zeros, as ``jax.nn.one_hot``'s."""
    x, = amp_cast('one_hot', x)
    classes = torch.arange(num_classes, device=x.device)
    return (x.long()[..., None] == classes).to(torch.float32)


def _pad_index(n, lo, hi, mode, device):
    i = torch.arange(-lo, n + hi, device=device)
    if mode == 'reflect':
        i = i.abs()
        return torch.where(i >= n, 2 * (n - 1) - i, i)
    if mode == 'replicate':
        return i.clamp(0, n - 1)
    return i.remainder(n)                       # circular


def pad(x, pad, mode='constant', value=0.0, data_format='NCHW', name=None):
    """The reference's ``pad``: an int pads every axis; ``2 * ndim``
    entries are ``[d0_lo, d0_hi, d1_lo, ...]``; fewer pad the spatial
    axes, last first (torch's order).  Modes ``constant``, ``reflect``,
    ``replicate`` and ``circular``."""
    x, = amp_cast('pad', x)
    nd = x.dim()
    if not isinstance(pad, int):
        pad = [int(p) for p in pad]
    if isinstance(pad, int):
        cfg = [(pad, pad)] * nd
    elif len(pad) == 2 * nd:
        cfg = [(pad[2 * i], pad[2 * i + 1]) for i in range(nd)]
    else:
        cfg = [(0, 0)] * nd
        spatial = list(range(nd - 1, 1, -1)) if data_format[1] == 'C' \
            else list(range(nd - 2, 0, -1))
        for i in range(len(pad) // 2):
            cfg[spatial[i]] = (pad[2 * i], pad[2 * i + 1])
    if mode == 'constant':
        flat = [p for lo_hi in reversed(cfg) for p in lo_hi]
        return TF.pad(x, flat, value=value)
    if mode not in ('reflect', 'replicate', 'circular'):
        raise ValueError(f'pad mode {mode!r}')
    for d, (lo, hi) in enumerate(cfg):
        if lo or hi:
            x = x.index_select(d, _pad_index(x.shape[d], lo, hi, mode,
                                             x.device))
    return x


def cosine_similarity(x1, x2, axis=1, eps=1e-8):
    """``sum(a * b) / max(|a| |b|, eps)`` along ``axis``."""
    a, b = amp_cast('cosine_similarity', x1, x2)
    num = (a * b).sum(dim=axis)
    den = torch.linalg.vector_norm(a, dim=axis) * \
        torch.linalg.vector_norm(b, dim=axis)
    return num / torch.clamp_min(den, eps)


def normalize(x, p=2, axis=1, epsilon=1e-12, name=None):
    """``x / max(||x||_p, epsilon)`` along ``axis``."""
    v, = amp_cast('normalize', x)
    if p == 2:
        n = torch.linalg.vector_norm(v, dim=axis, keepdim=True)
    else:
        n = (v.abs() ** p).sum(dim=axis, keepdim=True) ** (1.0 / p)
    return v / torch.clamp_min(n, epsilon)


def label_smooth(label, prior_dist=None, epsilon=0.1, name=None):
    """``(1 - epsilon) * label + epsilon / K`` over the last axis of K
    classes, or ``+ epsilon * prior_dist``."""
    v, = amp_cast('label_smooth', label)
    keep = v * _scalar(1 - epsilon, v.dtype)
    if prior_dist is not None:
        return keep + epsilon * prior_dist
    return keep + _scalar(epsilon / v.shape[-1], v.dtype)


def sequence_mask(x, maxlen=None, dtype='int64', name=None):
    """``y[..., j] = j < x[...]``; ``maxlen`` None reads ``max(x)`` back
    from the device."""
    if maxlen is None:
        maxlen = int(x.max())
    dt = getattr(torch, dtype) if isinstance(dtype, str) else dtype
    j = torch.arange(int(maxlen), device=x.device)
    return (j < x[..., None]).to(dt)


def gather_tree(ids, parents):
    """The beams' token ids traced back along ``parents`` (both ``[T,
    B, K]``): from the last step to the first, each step's token is
    re-selected by the beam that survives."""
    T, B, K = ids.shape
    beams = torch.arange(K, dtype=parents.dtype,
                         device=parents.device).expand(B, K)
    out = [None] * T
    for t in range(T - 1, -1, -1):
        out[t] = ids[t].gather(-1, beams)
        beams = parents[t].gather(-1, beams)
    return torch.stack(out, 0)
