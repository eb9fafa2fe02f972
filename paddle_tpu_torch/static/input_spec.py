"""``InputSpec`` — a symbolic input signature (counterpart of
``paddle_tpu/static/input_spec.py``; Paddle's python/paddle/static/
input.py): shape (None/-1 = a dynamic dimension), dtype and name.
``hapi.Model(inputs=, labels=)`` reads how many there are."""
import numpy as np

__all__ = ['InputSpec']


def _numpy_dtype(dtype):
    if dtype is None:
        return None
    name = str(dtype)
    if name.startswith('torch.'):
        name = name[len('torch.'):]
    if name == 'bfloat16':
        return None             # numpy has no bfloat16
    return np.dtype(name)


class InputSpec:
    def __init__(self, shape, dtype='float32', name=None):
        self.shape = tuple(-1 if d is None else int(d) for d in shape)
        self.dtype = dtype
        self.name = name

    def numpy_dtype(self):
        return _numpy_dtype(self.dtype)

    @classmethod
    def from_tensor(cls, tensor, name=None):
        dtype = str(tensor.dtype)
        if dtype.startswith('torch.'):
            dtype = dtype[len('torch.'):]
        return cls(tensor.shape, dtype, name or getattr(tensor, 'name',
                                                        None))

    @classmethod
    def from_numpy(cls, ndarray, name=None):
        return cls(ndarray.shape, str(ndarray.dtype), name)

    def batch(self, batch_size):
        return InputSpec((batch_size,) + self.shape, self.dtype, self.name)

    def unbatch(self):
        return InputSpec(self.shape[1:], self.dtype, self.name)

    def __repr__(self):
        return (f"InputSpec(shape={self.shape}, dtype={self.dtype}, "
                f"name={self.name})")
