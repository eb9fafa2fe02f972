"""Shared helpers of the tensor ops (counterpart of
``paddle_tpu/tensor/_helpers.py``)."""
import numpy as np
import torch

from ..core.device import resolve_device
from ..core.dtype import convert_dtype, get_default_dtype

# integer dtypes the reference's 32-bit integers cover: a sum, a
# product or a cumulative sum over them comes back int32, as in the
# reference (PyTorch would widen them to int64)
_NARROW_INTS = (torch.bool, torch.int8, torch.uint8, torch.int16,
                torch.int32)


def as_tensor(x, like=None):
    """``x`` (a tensor, numpy array, list or scalar) as a tensor, on
    ``like``'s device when given, else the default device; a Python or
    numpy float64 becomes the default dtype, as the reference's
    ``Tensor`` makes it."""
    if isinstance(x, torch.Tensor):
        return x
    device = like.device if isinstance(like, torch.Tensor) \
        else resolve_device()
    arr = np.asarray(x)
    t = torch.as_tensor(np.array(arr, copy=True), device=device)
    return t.to(get_default_dtype()) if arr.dtype == np.float64 else t


def raw(v):
    """A 0-d tensor argument (a bound, a fill value) as a Python number;
    anything else as it is."""
    if isinstance(v, torch.Tensor) and v.numel() == 1:
        return v.item()
    return v


def shape_of(shape):
    """A shape argument (an int, a list that may hold 0-d tensors, or a
    1-D int tensor) as a tuple of ints."""
    if isinstance(shape, torch.Tensor):
        return tuple(int(s) for s in shape.reshape(-1).tolist())
    if isinstance(shape, (int, np.integer)):
        return (int(shape),)
    return tuple(int(raw(s)) for s in shape)


def axes_of(axis, ndim):
    """``axis`` (None, an int or a list) as a tuple of non-negative
    axes; None is every axis."""
    if axis is None:
        return tuple(range(ndim))
    if isinstance(axis, (list, tuple)):
        return tuple(int(a) % max(ndim, 1) for a in axis)
    return (int(raw(axis)) % max(ndim, 1),)


def narrow_int(out, x):
    """``out`` as int32 where ``x`` is one of the reference's 32-bit
    integer dtypes."""
    if x.dtype in _NARROW_INTS and not out.is_floating_point():
        return out.to(torch.int32)
    return out


def float_dtype(dtype):
    """``dtype`` as a torch dtype, the default dtype when None."""
    return convert_dtype(dtype) or get_default_dtype()
