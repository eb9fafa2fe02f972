"""Weight initializers (counterpart of ``paddle_tpu/nn/initializer``; the
port has ``Constant``, ``Normal``, ``Uniform``, ``XavierNormal``,
``XavierUniform``, ``KaimingUniform`` and ``calculate_gain``, what the
ported layers and models use).

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

import torch

__all__ = ['Initializer', 'Constant', 'Normal', 'Uniform', 'XavierNormal',
           'XavierUniform', 'KaimingUniform', 'calculate_gain']


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
    def __call__(self, shape, dtype=torch.float32, generator=None):
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
