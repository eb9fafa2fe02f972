"""TensorArray ops (counterpart of ``paddle_tpu/tensor/array.py``):
the array is a Python list of tensors.  An index is a Python int or a
tensor, read back to the host."""
import torch

from ._helpers import as_tensor

__all__ = ['create_array', 'array_read', 'array_write', 'array_length']


def _idx(i):
    return int(i.item()) if isinstance(i, torch.Tensor) else int(i)


def create_array(dtype='float32', initialized_list=None):
    return [as_tensor(v) for v in (initialized_list or [])]


def array_write(x, i, array=None):
    """``x`` at position ``i`` of ``array``: appended at its length,
    written over below it; an index past the end raises."""
    if array is None:
        array = []
    i = _idx(i)
    x = as_tensor(x)
    if i > len(array):
        raise IndexError(
            f'array_write index {i} past the array length {len(array)}: '
            'a TensorArray grows by appending (i == length) or '
            'overwriting (i < length)')
    if i == len(array):
        array.append(x)
    else:
        array[i] = x
    return array


def array_read(array, i):
    return array[_idx(i)]


def array_length(array):
    return len(array)
