"""paddle_tpu_torch.framework — ``save``/``load``, the seed and the
generator states, ``grad``/``set_grad_enabled`` and ``ComplexTensor``
(counterpart of ``paddle_tpu/framework``; the port has ``io.py``)."""
import numpy as np
import torch

from .io import save, load  # noqa: F401
from ..core.autograd import grad, set_grad_enabled  # noqa: F401
from ..core.rng import (get_cuda_rng_state, get_seed, seed,  # noqa: F401
                        set_cuda_rng_state)

__all__ = ['save', 'load', 'seed', 'get_seed', 'grad', 'set_grad_enabled',
           'get_cuda_rng_state', 'set_cuda_rng_state', 'ComplexTensor']


def _f32(value):
    if torch.is_tensor(value):
        return value.detach().to('cpu', torch.float32).numpy()
    return np.asarray(value, dtype=np.float32)


def ComplexTensor(real, imag=None):
    """A complex64 tensor from its real and imaginary parts (the
    reference's legacy constructor; ``imag`` None is zeros), on the
    default device (``set_device``; the card unless the CPU was
    asked for)."""
    from ..core.device import resolve_device
    r = _f32(real)
    i = np.zeros_like(r) if imag is None else _f32(imag)
    if i.shape != r.shape:
        raise ValueError(f'real/imag shape mismatch: {r.shape} vs {i.shape}')
    return torch.from_numpy((r + 1j * i).astype(np.complex64)).to(
        resolve_device(None))
