"""Dtype names (counterpart of ``paddle_tpu/core/dtype.py``).

The names are torch dtypes.  The reference aliases ``int64`` to int32,
``float64`` to float32 and ``complex128`` to complex64 unless JAX's x64
mode is on (``paddle_tpu/core/dtype.py:24-29``), so its
``set_default_dtype('float64')`` gives float32.  The port keeps the
true widths, as its ``to_tensor`` and ``InputSpec`` do: values agree
where both packages represent them (ROADMAP Queue 3).

The default dtype is the port's own (PyTorch's global default is left
alone); ``to_tensor`` of Python floats, ``zeros``, ``full``, ``rand``
and the other creation functions read it.
"""
import numpy as np
import torch

__all__ = ['float16', 'bfloat16', 'float32', 'float64', 'int8', 'int16',
           'int32', 'int64', 'uint8', 'bool_', 'complex64', 'complex128',
           'dtype', 'convert_dtype', 'dtype_name', 'set_default_dtype',
           'get_default_dtype', 'is_floating', 'is_integer']

float16 = torch.float16
bfloat16 = torch.bfloat16
float32 = torch.float32
float64 = torch.float64
int8 = torch.int8
int16 = torch.int16
int32 = torch.int32
int64 = torch.int64
uint8 = torch.uint8
bool_ = torch.bool
complex64 = torch.complex64
complex128 = torch.complex128

# ``paddle.dtype``: the class every dtype name is an instance of
dtype = torch.dtype

_STR2DTYPE = {
    'float16': float16, 'bfloat16': bfloat16, 'float32': float32,
    'float64': float64, 'int8': int8, 'int16': int16, 'int32': int32,
    'int64': int64, 'uint8': uint8, 'bool': bool_,
    'complex64': complex64, 'complex128': complex128,
}

_default_dtype = torch.float32


def convert_dtype(dtype):
    """A name (``'float32'``), a numpy dtype or a torch dtype as a torch
    dtype; None stays None."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, str):
        if dtype not in _STR2DTYPE:
            raise ValueError(f'unknown dtype {dtype!r}')
        return _STR2DTYPE[dtype]
    name = np.dtype(dtype).name
    if name not in _STR2DTYPE:
        raise ValueError(f'unknown dtype {dtype!r}')
    return _STR2DTYPE[name]


def dtype_name(dtype):
    return str(convert_dtype(dtype)).replace('torch.', '')


def set_default_dtype(dtype):
    """The dtype of new float tensors; a floating dtype only."""
    global _default_dtype
    d = convert_dtype(dtype)
    if not is_floating(d):
        raise TypeError(f'default dtype must be floating, got {d}')
    _default_dtype = d


def get_default_dtype():
    return _default_dtype


def is_floating(dtype):
    return convert_dtype(dtype).is_floating_point


def is_integer(dtype):
    d = convert_dtype(dtype)
    return not (d.is_floating_point or d.is_complex or d == torch.bool)
