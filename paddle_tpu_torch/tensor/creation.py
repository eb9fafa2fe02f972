"""Tensor creation (counterpart of ``paddle_tpu/tensor/creation.py``).

A new tensor lands on the default device (``core.device.resolve_device``:
the card, or ``set_device``'s choice) unless ``place`` names one; a
``*_like`` one on its model's device.  Float results take the default
dtype (``core.dtype.get_default_dtype``, f32 unless set), also for an
int fill, as in the reference; ``to_tensor`` keeps a numpy array's
dtype except float64, which becomes the default dtype.
"""
import numpy as np
import torch

from ..amp import amp_cast
from ..core.device import resolve_device
from ..core.dtype import convert_dtype, get_default_dtype
from ._helpers import as_tensor, float_dtype, raw, shape_of as _shape

__all__ = [
    'to_tensor', 'zeros', 'ones', 'full', 'empty', 'zeros_like', 'ones_like',
    'full_like', 'empty_like', 'arange', 'linspace', 'logspace', 'eye',
    'diag', 'diagflat', 'tril', 'triu', 'meshgrid', 'assign', 'clone',
    'create_parameter',
]


def to_tensor(data, dtype=None, place=None, stop_gradient=True):
    """``data`` (numpy, a list, a scalar or a tensor) as a tensor on
    ``place`` (the default device when None); ``stop_gradient=False``
    makes it require a gradient."""
    device = resolve_device(place)
    if torch.is_tensor(data):
        t = data.detach().to(device)
    else:
        arr = np.asarray(data)
        if arr.dtype == np.float64 and dtype is None:
            dtype = get_default_dtype()
        t = torch.from_numpy(np.array(arr, copy=True)).to(device)
    t = t.to(convert_dtype(dtype) or t.dtype)
    if not stop_gradient:
        t.requires_grad_(True)
    return t


def zeros(shape, dtype=None, name=None):
    return torch.zeros(_shape(shape), dtype=float_dtype(dtype),
                       device=resolve_device())


def ones(shape, dtype=None, name=None):
    return torch.ones(_shape(shape), dtype=float_dtype(dtype),
                      device=resolve_device())


def full(shape, fill_value, dtype=None, name=None):
    return torch.full(_shape(shape), raw(fill_value), dtype=float_dtype(dtype),
                      device=resolve_device())


def empty(shape, dtype=None, name=None):
    """Zeros, as in the reference."""
    return zeros(shape, dtype)


def zeros_like(x, dtype=None, name=None):
    return torch.zeros_like(x, dtype=convert_dtype(dtype))


def ones_like(x, dtype=None, name=None):
    return torch.ones_like(x, dtype=convert_dtype(dtype))


def full_like(x, fill_value, dtype=None, name=None):
    return torch.full_like(x, raw(fill_value), dtype=convert_dtype(dtype))


def empty_like(x, dtype=None, name=None):
    return zeros_like(x, dtype)


def arange(start=0, end=None, step=1, dtype=None, name=None):
    """``[start, end)`` by ``step``; integers keep an integer dtype
    (int64: the port's true width), floats the default dtype."""
    start, end, step = raw(start), raw(end), raw(step)
    if end is None:
        start, end = 0, start
    d = convert_dtype(dtype)
    if d is None and any(isinstance(v, float) for v in (start, end, step)):
        d = get_default_dtype()
    return torch.arange(start, end, step, dtype=d, device=resolve_device())


def linspace(start, stop, num, dtype=None, name=None):
    return torch.linspace(raw(start), raw(stop), int(raw(num)),
                          dtype=float_dtype(dtype), device=resolve_device())


def logspace(start, stop, num, base=10.0, dtype=None, name=None):
    return torch.logspace(raw(start), raw(stop), int(raw(num)),
                          base=raw(base), dtype=float_dtype(dtype),
                          device=resolve_device())


def eye(num_rows, num_columns=None, dtype=None, name=None):
    cols = num_rows if num_columns is None else num_columns
    return torch.eye(int(num_rows), int(cols), dtype=float_dtype(dtype),
                     device=resolve_device())


def diag(x, offset=0, padding_value=0, name=None):
    """A 1-D ``x`` on the ``offset`` diagonal of a square matrix (the
    rest ``padding_value``), or the ``offset`` diagonal of a 2-D ``x``."""
    x, = amp_cast('diag', as_tensor(x))
    out = torch.diag(x, offset)
    if x.dim() == 1 and padding_value != 0:
        keep = torch.diag(torch.ones_like(x, dtype=torch.bool), offset)
        out = torch.where(keep, out, torch.full_like(out, padding_value))
    return out


def diagflat(x, offset=0, name=None):
    x, = amp_cast('diagflat', as_tensor(x))
    return torch.diagflat(x, offset)


def tril(x, diagonal=0, name=None):
    x, = amp_cast('tril', as_tensor(x))
    return torch.tril(x, diagonal)


def triu(x, diagonal=0, name=None):
    x, = amp_cast('triu', as_tensor(x))
    return torch.triu(x, diagonal)


def meshgrid(*args, **kwargs):
    """Grids of the 1-D inputs (a list of them, or each an argument),
    ``'ij'`` indexing, as a list."""
    ts = args[0] if len(args) == 1 and isinstance(args[0], (list, tuple)) \
        else args
    ts = amp_cast('meshgrid', *[as_tensor(t) for t in ts])
    return list(torch.meshgrid(*ts, indexing='ij'))


def assign(x, output=None):
    """A copy of ``x`` (a tensor, numpy array or list), or ``x`` written
    into ``output`` in place."""
    src = as_tensor(x, like=output)
    if output is None:
        return src.clone()
    with torch.no_grad():
        output.copy_(src)
    return output


def clone(x, name=None):
    return as_tensor(x).clone()


def create_parameter(shape, dtype='float32', name=None, attr=None,
                     is_bias=False, default_initializer=None, **kwargs):
    """``nn``'s ``create_parameter`` (``device=`` and ``generator=`` as
    keywords): a parameter of ``shape`` drawn by ``attr``'s or
    ``default_initializer`` (zeros for a bias, XavierNormal otherwise)."""
    from ..nn.layer.layers import create_parameter as _create
    return _create(_shape(shape), dtype, name=name, attr=attr,
                   is_bias=is_bias, default_initializer=default_initializer,
                   **kwargs)
