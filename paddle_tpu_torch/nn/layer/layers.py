"""``ParamAttr``, ``Layer`` and ``create_parameter`` (counterpart of
``paddle_tpu/nn/layer/layers.py``).

``Layer`` is a ``torch.nn.Module`` that also answers to the reference's
method names (``create_parameter``, ``add_parameter``,
``add_sublayer``, ``register_buffer(persistable=)``,
``named_sublayers``, ``set_state_dict``, ``clear_gradients``, ...), so
a Paddle model definition runs unchanged; its ``state_dict`` is
torch's, whose keys are the reference's.

A parameter is drawn at construction from its device's generator
(``core.rng``, reseeded by ``paddle_tpu_torch.seed``), by the
``ParamAttr``'s initializer, else the layer's default, else
``initializer.get_default_init`` (the global initializer if one was
set, else zeros for a bias and XavierNormal otherwise), as in the
reference.  The attr's
``learning_rate`` lands in ``param.optimize_attr`` (the eager
``optimizer.step()`` scales the parameter's rate by it, as the
reference's does), ``need_clip`` and ``regularizer`` on the parameter,
and ``trainable=False`` makes it ``requires_grad=False``.
``attr=False`` creates no parameter (None), as the reference's
``bias_attr=False``.  Inside ``deferred_init()`` parameters are left
uninitialized, for a model that draws every one of them itself right
after (the port's GPT and BERT, from a seeded CPU generator).
"""
import contextlib
import threading

import numpy as np
import torch
from torch import nn

from ...core import rng
from ...core.device import resolve_device
from ..initializer import Initializer, get_default_init

__all__ = ['ParamAttr', 'Layer', 'create_parameter', 'deferred_init']

_deferred = threading.local()

_DTYPES = {'float32': torch.float32, 'float64': torch.float64,
           'float16': torch.float16, 'bfloat16': torch.bfloat16}


def _dtype(dtype):
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype or torch.float32
    return _DTYPES[str(dtype)]


class ParamAttr:
    """A parameter's name, initializer, learning-rate multiplier,
    regularizer, trainability and clipping."""

    def __init__(self, name=None, initializer=None, learning_rate=1.0,
                 regularizer=None, trainable=True, need_clip=True):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.need_clip = need_clip

    @staticmethod
    def _to_attr(attr):
        """None, False and ParamAttr pass; a string names the
        parameter; anything else is an initializer."""
        if attr is None or attr is False or isinstance(attr, ParamAttr):
            return attr
        if isinstance(attr, str):
            return ParamAttr(name=attr)
        return ParamAttr(initializer=attr)


@contextlib.contextmanager
def deferred_init():
    """Parameters created in this block (this thread) are allocated and
    not drawn: the caller draws each one itself before use."""
    prev = getattr(_deferred, 'on', False)
    _deferred.on = True
    try:
        yield
    finally:
        _deferred.on = prev


def create_parameter(shape, dtype=None, name=None, attr=None, is_bias=False,
                     default_initializer=None, *, generator=None,
                     device=None):
    """A parameter of ``shape`` on ``device``, drawn from ``generator``
    (the device's ``core.rng`` generator when None) by ``attr``'s
    initializer, else ``default_initializer``, else
    ``get_default_init(is_bias)``; None when ``attr`` is False."""
    attr = ParamAttr._to_attr(attr)
    if attr is False:
        return None
    device = resolve_device(device)
    init = attr.initializer if attr is not None and \
        attr.initializer is not None else default_initializer
    if init is None:
        init = get_default_init(is_bias)
    if not isinstance(init, Initializer):
        raise TypeError(f'initializer {init!r} is not one of '
                        'paddle_tpu_torch.nn.initializer')
    shape = [int(s) for s in shape]
    if getattr(_deferred, 'on', False):
        value = torch.empty(shape, dtype=_dtype(dtype), device=device)
    else:
        gen = generator if generator is not None else rng.generator(device)
        value = init(shape, _dtype(dtype), gen)
    p = nn.Parameter(value.to(device),
                     requires_grad=attr is None or bool(attr.trainable))
    if attr is not None:
        p.optimize_attr = {'learning_rate': attr.learning_rate}
        p.regularizer = attr.regularizer
        p.need_clip = attr.need_clip
    return p


class Layer(nn.Module):
    """``torch.nn.Module`` with the reference ``Layer``'s names."""

    _name_counters = {}

    def __init__(self, name_scope=None, dtype='float32'):
        super().__init__()
        self._dtype = _dtype(dtype)
        self._name_scope = name_scope or type(self).__name__.lower()
        n = Layer._name_counters.get(self._name_scope, 0)
        Layer._name_counters[self._name_scope] = n + 1
        self._full_name = f'{self._name_scope}_{n}'

    def full_name(self):
        return self._full_name

    def create_parameter(self, shape, attr=None, dtype=None, is_bias=False,
                         default_initializer=None, *, device=None):
        """``create_parameter`` in the layer's dtype (on the default
        device unless ``device`` is given)."""
        return create_parameter(shape, dtype or self._dtype, attr=attr,
                                is_bias=is_bias,
                                default_initializer=default_initializer,
                                device=device)

    def add_parameter(self, name, parameter):
        self.register_parameter(name, parameter)
        return parameter

    def add_sublayer(self, name, sublayer):
        self.add_module(str(name), sublayer)
        return sublayer

    def register_buffer(self, name, tensor, persistable=True,
                        persistent=None):
        """The reference's ``persistable`` (torch's ``persistent``): a
        non-persistable buffer stays out of the ``state_dict``."""
        super().register_buffer(
            name, tensor, persistable if persistent is None else persistent)
        return tensor

    def named_sublayers(self, prefix='', include_self=False):
        for name, layer in self.named_modules(prefix=prefix):
            if layer is self and not include_self:
                continue
            yield name, layer

    def sublayers(self, include_self=False):
        return [m for _, m in self.named_sublayers(include_self=include_self)]

    def clear_gradients(self):
        for p in self.parameters():
            p.grad = None

    def set_state_dict(self, state_dict, use_structured_name=True):
        """Copy the values of ``state_dict`` (tensors or numpy, the
        ``state_dict`` keys) into the parameters and buffers in place;
        returns ``(missing, unexpected)`` key lists.  Raises on a shape
        mismatch."""
        own = self.state_dict(keep_vars=True)
        missing = [k for k in own if k not in state_dict]
        unexpected = [k for k in state_dict if k not in own]
        with torch.no_grad():
            for name, dst in own.items():
                if name not in state_dict:
                    continue
                src = state_dict[name]
                if not torch.is_tensor(src):
                    src = torch.from_numpy(np.array(src, copy=True))
                if tuple(src.shape) != tuple(dst.shape):
                    raise ValueError(f'shape mismatch for {name}: '
                                     f'{tuple(src.shape)} vs '
                                     f'{tuple(dst.shape)}')
                dst.copy_(src)
        return missing, unexpected

    load_dict = set_state_dict
    set_dict = set_state_dict

    def register_forward_post_hook(self, hook):
        return self.register_forward_hook(hook)
