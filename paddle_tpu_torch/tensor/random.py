"""Random sampling (counterpart of ``paddle_tpu/tensor/random.py``).

Every draw comes from ``core.rng.generator(device)``, so ``seed`` makes
it repeatable and a CUDA graph of a step that draws (``jit.to_static``,
``step_fused``) gets fresh bits on each replay through
``core.rng.register_generators``, as dropout does.  The bits cannot
match ``jax.random``'s: the same seed gives other draws in the two
packages, so the tests hold them by determinism and by their laws.
``multinomial`` without replacement is the reference's Gumbel top-k.
The ``*_`` ops fill their argument in place.  Float draws take the
default dtype.
"""
import torch

from ..core import rng
from ..core.device import resolve_device
from ..core.dtype import convert_dtype, get_default_dtype
from ._helpers import as_tensor, float_dtype, shape_of as _shape
from .search import stable_topk

__all__ = [
    'rand', 'randn', 'randint', 'randint_like', 'uniform', 'normal',
    'standard_normal', 'randperm', 'bernoulli', 'multinomial', 'poisson',
    'shuffle', 'seed', 'uniform_', 'normal_', 'exponential_',
    'check_shape', 'gaussian',
]

seed = rng.seed


def check_shape(shape, op_name='check_shape'):
    """A shape argument (an int, a list of ints or 0-d tensors, or a 1-D
    int tensor) as a tuple; a TypeError for anything else."""
    try:
        return _shape(shape)
    except (TypeError, ValueError) as e:
        raise TypeError(
            f'{op_name}: invalid shape {shape!r}: expected an int, a '
            f'sequence of ints, or a 1-D integer Tensor') from e


def _gen(device):
    return rng.generator(device)


def rand(shape, dtype=None, name=None):
    device = resolve_device()
    return torch.rand(_shape(shape), generator=_gen(device),
                      dtype=float_dtype(dtype),
                      device=device)


def randn(shape, dtype=None, name=None):
    device = resolve_device()
    return torch.randn(_shape(shape), generator=_gen(device),
                       dtype=float_dtype(dtype),
                       device=device)


standard_normal = randn


def randint(low=0, high=None, shape=(1,), dtype='int64', name=None):
    if high is None:
        low, high = 0, low
    device = resolve_device()
    return torch.randint(int(low), int(high), _shape(shape),
                         generator=_gen(device),
                         dtype=convert_dtype(dtype) or torch.int64,
                         device=device)


def randint_like(x, low=0, high=None, dtype=None, name=None):
    x = as_tensor(x)
    if high is None:
        low, high = 0, low
    return torch.randint(int(low), int(high), x.shape,
                         generator=_gen(x.device), device=x.device).to(
        convert_dtype(dtype) or x.dtype)


def uniform(shape, dtype=None, min=-1.0, max=1.0, seed=0, name=None):
    """Uniform on ``[min, max)``; ``seed`` is taken and ignored, as in
    the reference."""
    device = resolve_device()
    out = torch.empty(_shape(shape),
                      dtype=float_dtype(dtype),
                      device=device)
    return out.uniform_(min, max, generator=_gen(device))


def normal(mean=0.0, std=1.0, shape=None, name=None):
    """``mean + std * z``; tensor ``mean``/``std`` broadcast and set the
    shape."""
    if isinstance(mean, torch.Tensor) or isinstance(std, torch.Tensor):
        like = mean if isinstance(mean, torch.Tensor) else std
        m, s = as_tensor(mean, like=like), as_tensor(std, like=like)
        shp = torch.broadcast_shapes(m.shape, s.shape)
        z = torch.randn(shp, generator=_gen(like.device),
                        dtype=get_default_dtype(), device=like.device)
        return m + s * z
    device = resolve_device()
    z = torch.randn(_shape(shape), generator=_gen(device),
                    dtype=get_default_dtype(), device=device)
    return mean + std * z


def gaussian(shape, mean=0.0, std=1.0, dtype='float32', name=None):
    device = resolve_device()
    z = torch.randn(_shape(shape), generator=_gen(device),
                    dtype=float_dtype(dtype),
                    device=device)
    return mean + std * z


def randperm(n, dtype='int64', name=None):
    device = resolve_device()
    return torch.randperm(int(n), generator=_gen(device),
                          dtype=convert_dtype(dtype) or torch.int64,
                         device=device)


def bernoulli(x, name=None):
    x = as_tensor(x)
    return torch.bernoulli(x, generator=_gen(x.device))


def multinomial(x, num_samples=1, replacement=False, name=None):
    """``num_samples`` category draws per row of the probabilities
    ``x`` (1-D or 2-D), int64; without replacement by Gumbel top-k over
    ``log(max(x, 1e-30))``, as the reference draws them."""
    x = as_tensor(x)
    if replacement:
        return torch.multinomial(x, num_samples, replacement=True,
                                 generator=_gen(x.device))
    logits = torch.log(torch.clamp_min(x.float(), 1e-30))
    u = torch.rand(logits.shape, generator=_gen(x.device),
                   device=x.device)
    u = torch.clamp_min(u, torch.finfo(torch.float32).tiny)
    g = -torch.log(-torch.log(u))
    return stable_topk(logits + g, int(num_samples), dim=-1)[1]


def poisson(x, name=None):
    x = as_tensor(x)
    return torch.poisson(x, generator=_gen(x.device))


def shuffle(x, axis=0):
    """``x`` with its slices along ``axis`` in a random order."""
    x = as_tensor(x)
    perm = torch.randperm(x.shape[axis], generator=_gen(x.device),
                          device=x.device)
    return torch.index_select(x, axis, perm)


def uniform_(x, min=-1.0, max=1.0):
    with torch.no_grad():
        return x.uniform_(min, max, generator=_gen(x.device))


def normal_(x, mean=0.0, std=1.0):
    with torch.no_grad():
        return x.normal_(mean, std, generator=_gen(x.device))


def exponential_(x, lam=1.0):
    with torch.no_grad():
        return x.exponential_(lam, generator=_gen(x.device))
