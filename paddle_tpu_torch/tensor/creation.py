"""Tensor creation (counterpart of ``paddle_tpu/tensor/creation.py``; the
port has ``to_tensor``, ``zeros``, ``ones``, ``full``, ``arange`` and
their ``*_like`` forms).  A new tensor lands on the default device
(``core.device.resolve_device``: the card, or ``set_device``'s choice)
unless ``place`` names one; a ``*_like`` one on its model's device.
The default dtype is f32, as the reference's, also for an int fill;
``to_tensor`` keeps a numpy array's dtype."""
import numpy as np
import torch

from ..core.device import resolve_device

__all__ = ['to_tensor', 'zeros', 'ones', 'full', 'arange', 'zeros_like',
           'ones_like', 'full_like']

_NAMES = {'float32': torch.float32, 'float64': torch.float64,
          'float16': torch.float16, 'bfloat16': torch.bfloat16,
          'int32': torch.int32, 'int64': torch.int64, 'int8': torch.int8,
          'uint8': torch.uint8, 'bool': torch.bool}


def convert_dtype(dtype, default=None):
    """A torch dtype for a name, a numpy dtype or a torch dtype."""
    if dtype is None:
        return default
    if isinstance(dtype, torch.dtype):
        return dtype
    return _NAMES[np.dtype(dtype).name if not isinstance(dtype, str)
                  else dtype]


def _shape(shape):
    if isinstance(shape, int):
        return (shape,)
    return tuple(int(s) for s in shape)


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
            arr = arr.astype(np.float32)
        t = torch.from_numpy(np.array(arr, copy=True)).to(device)
    t = t.to(convert_dtype(dtype, t.dtype))
    if not stop_gradient:
        t.requires_grad_(True)
    return t


def zeros(shape, dtype=None, name=None):
    return torch.zeros(_shape(shape), dtype=convert_dtype(dtype,
                                                          torch.float32),
                       device=resolve_device())


def ones(shape, dtype=None, name=None):
    return torch.ones(_shape(shape), dtype=convert_dtype(dtype,
                                                         torch.float32),
                      device=resolve_device())


def full(shape, fill_value, dtype=None, name=None):
    return torch.full(_shape(shape), fill_value,
                      dtype=convert_dtype(dtype, torch.float32),
                      device=resolve_device())


def arange(start=0, end=None, step=1, dtype=None, name=None):
    if end is None:
        start, end = 0, start
    return torch.arange(start, end, step, dtype=convert_dtype(dtype),
                        device=resolve_device())


def zeros_like(x, dtype=None, name=None):
    return torch.zeros_like(x, dtype=convert_dtype(dtype))


def ones_like(x, dtype=None, name=None):
    return torch.ones_like(x, dtype=convert_dtype(dtype))


def full_like(x, fill_value, dtype=None, name=None):
    return torch.full_like(x, fill_value, dtype=convert_dtype(dtype))
