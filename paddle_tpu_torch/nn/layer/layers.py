"""``create_parameter``, the port's form of the reference's
``Layer.create_parameter`` (``paddle_tpu/nn/layer/layers.py``)."""
from torch import nn

from ...core.device import resolve_device
from ..initializer import Constant, XavierNormal

__all__ = ['create_parameter']


def create_parameter(shape, is_bias=False, generator=None, device=None,
                     default_initializer=None):
    """A trainable f32 parameter of ``shape``, drawn from the explicit
    CPU ``generator`` (None is torch's default one) by
    ``default_initializer``, or by the reference's default init where
    it is None: zeros for a bias (``is_bias=True``), XavierNormal
    otherwise."""
    init = default_initializer
    if init is None:
        init = Constant(0.0) if is_bias else XavierNormal()
    value = init([int(s) for s in shape], generator=generator)
    return nn.Parameter(value.to(resolve_device(device)))
