"""Weight initializers (counterpart of ``paddle_tpu/nn/initializer``):
``Constant``, ``Normal``, ``TruncatedNormal`` (N(0, 1) cut at +-2, then
scaled), ``Uniform``, the Xavier and Kaiming pairs, ``Assign``,
``Bilinear`` (the transposed convolution's upsampling kernel, exact),
``calculate_gain``, and ``set_global_initializer`` with
``get_default_init``, which ``Layer.create_parameter`` reads for a
parameter with neither an attr's initializer nor a layer default, as
the reference does.

An initializer is called as ``init(shape, dtype, generator)`` and
returns a tensor drawn from the explicit ``torch.Generator`` on that
generator's device (``None`` takes torch's default CPU one): the
models draw from a seeded CPU generator, so one seed gives the same
weights on every device, and ``Layer.create_parameter`` from the
device's generator (``core.rng``), as the reference draws from its
global key; ``init.fill_(param, generator)`` copies the draw into a
parameter in place.  The laws are the reference's; the
draws are torch's, so parity tests carry weights across.
"""
import math

import numpy as np
import torch

from ..core.dtype import convert_dtype, get_default_dtype

__all__ = ['Initializer', 'Constant', 'Normal', 'TruncatedNormal',
           'Uniform', 'XavierNormal', 'XavierUniform', 'KaimingNormal',
           'KaimingUniform', 'Assign', 'Bilinear', 'calculate_gain',
           'set_global_initializer', 'get_default_init']


def _fans(shape):
    """(fan_in, fan_out) as the reference counts them; conv kernels are
    ``[out, in, *spatial]``, so a 3-D expert stack ``[E, H, F]`` counts
    ``H * F`` in and ``E * F`` out."""
    shape = tuple(shape)
    if len(shape) == 0:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    receptive = math.prod(shape[2:])
    return shape[1] * receptive, shape[0] * receptive


def calculate_gain(nonlinearity, param=None):
    gains = {'sigmoid': 1.0, 'linear': 1.0, 'conv1d': 1.0, 'conv2d': 1.0,
             'conv3d': 1.0, 'tanh': 5.0 / 3.0, 'relu': math.sqrt(2.0),
             'leaky_relu': math.sqrt(2.0 / (1 + (param or 0.01) ** 2)),
             'selu': 3.0 / 4.0}
    return gains[nonlinearity]


def _dev(generator):
    return None if generator is None else generator.device


class Initializer:
    def __call__(self, shape, dtype=None, generator=None):
        """A draw of ``shape`` in ``dtype`` (a torch dtype, one of the
        reference's names or a numpy dtype; None takes
        ``get_default_dtype()``, as the reference's)."""
        dtype = convert_dtype(dtype) or get_default_dtype()
        return self._generate(tuple(int(s) for s in shape), dtype,
                              generator)

    def _generate(self, shape, dtype, generator):
        raise NotImplementedError

    def fill_(self, param, generator=None):
        """Draw for ``param``'s shape and dtype and copy it in place."""
        with torch.no_grad():
            param.copy_(self(param.shape, param.dtype, generator))
        return param


class Constant(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def _generate(self, shape, dtype, generator):
        return torch.full(shape, self.value, dtype=dtype,
                          device=_dev(generator))


class Normal(Initializer):
    """N(mean, std^2)."""

    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = mean, std

    def _generate(self, shape, dtype, generator):
        z = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=_dev(generator))
        return (self.mean + self.std * z).to(dtype)


class TruncatedNormal(Initializer):
    """``mean + std * z`` with ``z`` N(0, 1) cut to [-2, 2] (drawn by
    the inverse CDF of a uniform between the cut's probabilities, as
    ``jax.random.truncated_normal`` draws it)."""

    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = mean, std

    def _generate(self, shape, dtype, generator):
        lo, hi = math.erf(-2.0 / math.sqrt(2.0)), math.erf(2.0 /
                                                           math.sqrt(2.0))
        u = torch.rand(shape, generator=generator, dtype=torch.float32,
                       device=_dev(generator))
        z = math.sqrt(2.0) * torch.erfinv(lo + u * (hi - lo))
        return (self.mean + self.std * z.clamp(-2.0, 2.0)).to(dtype)


class XavierNormal(Initializer):
    """N(0, gain^2 * 2 / (fan_in + fan_out)), the fans counted as the
    reference counts them (``_fans``)."""

    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def _generate(self, shape, dtype, generator):
        fi, fo = _fans(shape)
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        std = self.gain * math.sqrt(2.0 / (fi + fo))
        z = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=_dev(generator))
        return (z * std).to(dtype)


class XavierUniform(Initializer):
    """U[-limit, limit) with ``limit = gain * sqrt(6 / (fan_in +
    fan_out))``, the fans as ``_fans`` counts them."""

    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def _generate(self, shape, dtype, generator):
        fi, fo = _fans(shape)
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        limit = self.gain * math.sqrt(6.0 / (fi + fo))
        return Uniform(-limit, limit)._generate(shape, dtype, generator)


class Uniform(Initializer):
    """U[low, high)."""

    def __init__(self, low=-1.0, high=1.0):
        self.low, self.high = low, high

    def _generate(self, shape, dtype, generator):
        u = torch.rand(shape, generator=generator, dtype=torch.float32,
                       device=_dev(generator))
        return (u * (self.high - self.low) + self.low).to(dtype)


class KaimingNormal(Initializer):
    """N(0, gain^2 / fan_in)."""

    def __init__(self, fan_in=None, negative_slope=0.0,
                 nonlinearity='relu'):
        self.fan_in = fan_in
        self.negative_slope = negative_slope
        self.nonlinearity = nonlinearity

    def _generate(self, shape, dtype, generator):
        fi = self.fan_in if self.fan_in is not None else _fans(shape)[0]
        gain = calculate_gain(self.nonlinearity, self.negative_slope)
        z = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=_dev(generator))
        return (z * (gain / math.sqrt(fi))).to(dtype)


class KaimingUniform(Initializer):
    """U[-limit, limit) with ``limit = gain * sqrt(3 / fan_in)``."""

    def __init__(self, fan_in=None, negative_slope=0.0,
                 nonlinearity='relu'):
        self.fan_in = fan_in
        self.negative_slope = negative_slope
        self.nonlinearity = nonlinearity

    def _generate(self, shape, dtype, generator):
        fi = self.fan_in if self.fan_in is not None else _fans(shape)[0]
        gain = calculate_gain(self.nonlinearity, self.negative_slope)
        limit = gain * math.sqrt(3.0 / fi)
        return Uniform(-limit, limit)._generate(shape, dtype, generator)


class Assign(Initializer):
    """The given value (a tensor, array or nested list), reshaped to the
    parameter's shape and cast to its dtype."""

    def __init__(self, value):
        self.assigned = value

    def _generate(self, shape, dtype, generator):
        v = self.assigned
        v = v.detach() if torch.is_tensor(v) else torch.as_tensor(
            np.asarray(v))
        return v.to(device=_dev(generator), dtype=dtype).reshape(shape)


class Bilinear(Initializer):
    """The bilinear-upsampling kernel of a transposed convolution:
    ``weight[..., y, x] = (1 - |x/f - c|)(1 - |y/f - c|)`` with
    ``f = ceil(W / 2)`` and ``c = (2f - 1 - f % 2) / (2f)``, so a
    transposed convolution of stride ``f`` interpolates bilinearly."""

    def _generate(self, shape, dtype, generator):
        if len(shape) != 4:
            raise ValueError('Bilinear initializer expects a 4-D weight '
                             f'shape, got {shape}')
        H, W = shape[-2], shape[-1]
        f = int(math.ceil(W / 2.0))
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        x = torch.arange(W, dtype=torch.float32, device=_dev(generator))
        y = torch.arange(H, dtype=torch.float32, device=_dev(generator))
        k = (1.0 - (y / f - c).abs())[:, None] * (1.0 - (x / f - c).abs())
        return k.expand(shape).to(dtype).contiguous()


_global_weight_init = None
_global_bias_init = None


def set_global_initializer(weight_init, bias_init=None):
    """The initializers ``get_default_init`` hands out from now on
    (None restores the reference's defaults)."""
    global _global_weight_init, _global_bias_init
    _global_weight_init, _global_bias_init = weight_init, bias_init


def get_default_init(is_bias):
    """A bias's or a weight's initializer when neither its attr nor its
    layer names one: the global one if set, else zeros for a bias and
    XavierNormal for a weight."""
    if is_bias:
        return _global_bias_init or Constant(0.0)
    return _global_weight_init or XavierNormal()
