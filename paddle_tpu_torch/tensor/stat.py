"""Statistics (counterpart of ``paddle_tpu/tensor/stat.py``).

``median`` averages the two middle values of an even count, as
``jnp.median`` does (``torch.median`` returns the lower one);
``quantile`` interpolates linearly.  ``mean`` lives in ``math``.
"""
import torch

from ..amp import amp_cast
from ._helpers import as_tensor, axes_of, narrow_int
from .math import mean

__all__ = ['mean', 'std', 'var', 'median', 'quantile', 'nanmean', 'nansum']


def _float(x):
    return x if x.is_floating_point() or x.is_complex() else x.float()


def _dims(x, axis):
    return axes_of(axis, x.dim()) if x.dim() else None


def std(x, axis=None, unbiased=True, keepdim=False, name=None):
    x, = amp_cast('std', as_tensor(x))
    return torch.std(_float(x), dim=_dims(x, axis),
                     correction=1 if unbiased else 0, keepdim=keepdim)


def var(x, axis=None, unbiased=True, keepdim=False, name=None):
    x, = amp_cast('var', as_tensor(x))
    return torch.var(_float(x), dim=_dims(x, axis),
                     correction=1 if unbiased else 0, keepdim=keepdim)


def _quantile(x, q, axis, keepdim, interpolation):
    """``torch.quantile`` over several axes: they are moved to the end
    and merged, and put back as size 1 under ``keepdim``."""
    x = _float(x)
    axes = axes_of(axis, x.dim())
    rest = [d for d in range(x.dim()) if d not in axes]
    v = x.permute(rest + list(axes)).reshape(
        [x.shape[d] for d in rest] + [-1])
    out = torch.quantile(v, q, dim=-1, interpolation=interpolation)
    if keepdim:
        qdims = out.dim() - len(rest)
        shape = list(out.shape[:qdims]) + [
            1 if d in axes else x.shape[d] for d in range(x.dim())]
        out = out.reshape(shape)
    return out


def median(x, axis=None, keepdim=False, name=None):
    x, = amp_cast('median', as_tensor(x))
    return _quantile(x, 0.5, axis, keepdim, 'midpoint')


def quantile(x, q, axis=None, keepdim=False, name=None):
    x, = amp_cast('quantile', as_tensor(x))
    qt = torch.as_tensor(q, dtype=_float(x).dtype, device=x.device)
    return _quantile(x, qt, axis, keepdim, 'linear')


def nanmean(x, axis=None, keepdim=False, name=None):
    x, = amp_cast('nanmean', as_tensor(x))
    return torch.nanmean(_float(x), dim=_dims(x, axis), keepdim=keepdim)


def nansum(x, axis=None, dtype=None, keepdim=False, name=None):
    """``dtype`` is taken and ignored, as in the reference."""
    x, = amp_cast('nansum', as_tensor(x))
    return narrow_int(torch.nansum(x, dim=_dims(x, axis), keepdim=keepdim),
                      x)
