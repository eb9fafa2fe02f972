"""Tensor ops of the port (counterpart of ``paddle_tpu/tensor``): the
ones its models use, each casting its inputs through the AMP policy
under the reference's op name."""
from .manipulation import concat, flatten, reshape, stack
from .math import add, multiply, subtract, sum

__all__ = ['concat', 'flatten', 'reshape', 'stack', 'add', 'multiply',
           'subtract', 'sum']
