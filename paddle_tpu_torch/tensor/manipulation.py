"""Shape ops (counterpart of ``paddle_tpu/tensor/manipulation.py``; the
port has ``reshape``, ``flatten``, ``concat`` and ``stack``)."""
import torch

from ..amp import amp_cast

__all__ = ['reshape', 'flatten', 'concat', 'stack']


def reshape(x, shape, name=None):
    """``x`` in ``shape`` (one entry may be -1)."""
    x, = amp_cast('reshape', x)
    return x.reshape([int(s) for s in shape])


def flatten(x, start_axis=0, stop_axis=-1, name=None):
    """Axes ``start_axis .. stop_axis`` (inclusive, negative from the
    end) merged into one; a 0-d ``x`` becomes ``[1]``, as
    ``jnp.reshape(v, (-1,))`` makes it."""
    x, = amp_cast('flatten', x)
    nd = x.dim()
    if nd == 0:
        return x.reshape(-1)
    sa, so = start_axis % nd, stop_axis % nd
    return x.reshape(tuple(x.shape[:sa]) + (-1,) + tuple(x.shape[so + 1:]))


def concat(x, axis=0, name=None):
    """The tensors of the list ``x`` joined along ``axis``."""
    x = amp_cast('concat', *x)
    return torch.cat(x, dim=int(axis))


def stack(x, axis=0, name=None):
    """The tensors of the list ``x`` stacked along a new ``axis``."""
    x = amp_cast('stack', *x)
    return torch.stack(x, dim=int(axis))
