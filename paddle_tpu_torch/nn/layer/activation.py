"""Activation layers (counterpart of ``paddle_tpu/nn/layer/activation.py``):
each calls its functional with the layer's settings; ``PReLU`` owns its
weight (``Constant(init)``, ``num_parameters`` of them)."""
from .. import functional as F
from ..initializer import Constant
from .layers import Layer

__all__ = ['ReLU', 'ReLU6', 'GELU', 'Sigmoid', 'Softmax', 'LogSoftmax',
           'Tanh', 'LeakyReLU', 'ELU', 'SELU', 'CELU', 'Hardswish',
           'Hardsigmoid', 'Swish', 'Silu', 'Mish', 'Softplus', 'Softsign',
           'Hardtanh', 'Hardshrink', 'Softshrink', 'Tanhshrink', 'PReLU',
           'LogSigmoid', 'Maxout', 'ThresholdedReLU', 'GLU']


def _layer(cls_name, fn_name, *arg_names, **defaults):
    """A layer class whose ``__init__`` takes ``arg_names`` (with
    ``defaults``) and whose ``forward(x)`` calls ``F.<fn_name>`` with
    them."""
    def __init__(self, *args, name=None, **kw):
        Layer.__init__(self)
        vals = dict(defaults)
        vals.update(zip(arg_names, args))
        vals.update(kw)
        for k in arg_names:
            setattr(self, k, vals[k])

    def forward(self, x):
        return getattr(F, fn_name)(
            x, **{k: getattr(self, k) for k in arg_names})

    return type(cls_name, (Layer,), {'__init__': __init__,
                                      'forward': forward})


ReLU = _layer('ReLU', 'relu')
ReLU6 = _layer('ReLU6', 'relu6')
Sigmoid = _layer('Sigmoid', 'sigmoid')
Tanh = _layer('Tanh', 'tanh')
LogSigmoid = _layer('LogSigmoid', 'log_sigmoid')
Hardswish = _layer('Hardswish', 'hardswish')
Hardsigmoid = _layer('Hardsigmoid', 'hardsigmoid')
Swish = _layer('Swish', 'swish')
Silu = _layer('Silu', 'silu')
Mish = _layer('Mish', 'mish')
Softsign = _layer('Softsign', 'softsign')
Tanhshrink = _layer('Tanhshrink', 'tanhshrink')
GELU = _layer('GELU', 'gelu', 'approximate', approximate=False)
Softmax = _layer('Softmax', 'softmax', 'axis', axis=-1)
LogSoftmax = _layer('LogSoftmax', 'log_softmax', 'axis', axis=-1)
LeakyReLU = _layer('LeakyReLU', 'leaky_relu', 'negative_slope',
                   negative_slope=0.01)
ELU = _layer('ELU', 'elu', 'alpha', alpha=1.0)
CELU = _layer('CELU', 'celu', 'alpha', alpha=1.0)
SELU = _layer('SELU', 'selu', 'scale', 'alpha',
              scale=1.0507009873554804934193349852946,
              alpha=1.6732632423543772848170429916717)
Softplus = _layer('Softplus', 'softplus', 'beta', 'threshold', beta=1.0,
                  threshold=20.0)
Hardtanh = _layer('Hardtanh', 'hardtanh', 'min', 'max', min=-1.0, max=1.0)
Hardshrink = _layer('Hardshrink', 'hardshrink', 'threshold', threshold=0.5)
Softshrink = _layer('Softshrink', 'softshrink', 'threshold', threshold=0.5)
ThresholdedReLU = _layer('ThresholdedReLU', 'thresholded_relu', 'threshold',
                         threshold=1.0)
Maxout = _layer('Maxout', 'maxout', 'groups', 'axis', axis=1)
GLU = _layer('GLU', 'glu', 'axis', axis=-1)


class PReLU(Layer):
    def __init__(self, num_parameters=1, init=0.25, weight_attr=None,
                 data_format='NCHW', name=None):
        super().__init__()
        self.data_format = data_format
        self.weight = self.create_parameter(
            [num_parameters], attr=weight_attr,
            default_initializer=Constant(init))

    def forward(self, x):
        return F.prelu(x, self.weight, self.data_format)
