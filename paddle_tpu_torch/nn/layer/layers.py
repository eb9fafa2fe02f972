"""``create_parameter``, the port's form of the reference's
``Layer.create_parameter`` (``paddle_tpu/nn/layer/layers.py``)."""
from torch import nn

from ...core.device import resolve_device
from ..initializer import Constant, XavierNormal

__all__ = ['create_parameter']


def create_parameter(shape, is_bias=False, generator=None, device=None):
    """A trainable f32 parameter of ``shape`` with the reference's
    default init: zeros for a bias (``is_bias=True``), XavierNormal
    otherwise, drawn from the explicit CPU ``generator`` (None is
    torch's default one)."""
    init = Constant(0.0) if is_bias else XavierNormal()
    value = init([int(s) for s in shape], generator=generator)
    return nn.Parameter(value.to(resolve_device(device)))
