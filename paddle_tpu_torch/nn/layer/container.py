"""``Sequential``, ``LayerList``, ``ParameterList`` and ``LayerDict``
(counterpart of ``paddle_tpu/nn/layer/container.py``): sublayers under
``'0'``, ``'1'``, ... (or, for ``Sequential``, the names of an
``OrderedDict`` or of ``(name, layer)`` pairs; for ``LayerDict`` its
keys), parameters of a ``ParameterList`` under ``'0'``, ``'1'``, ...,
so their state-dict keys are the reference's (``0.weight``,
``tables.1.weight``, ``params.0``, ...)."""
import collections

from torch import nn

__all__ = ['Sequential', 'LayerList', 'ParameterList', 'LayerDict']


class Sequential(nn.Sequential):
    def __init__(self, *layers):
        if len(layers) == 1 and isinstance(layers[0],
                                           collections.OrderedDict):
            super().__init__(layers[0])
            return
        super().__init__()
        for i, item in enumerate(layers):
            if isinstance(item, (list, tuple)):
                self.add_module(str(item[0]), item[1])
            else:
                self.add_module(str(i), item)


class LayerList(nn.ModuleList):
    """A list of sublayers under ``'0'``, ``'1'``, ...: indexing,
    slicing (a new ``LayerList`` of the same layers), ``append``,
    ``insert`` and ``extend`` renumber the keys as the reference's
    do."""

    def __init__(self, sublayers=None):
        super().__init__(sublayers)


class ParameterList(nn.ParameterList):
    """Parameters under ``'0'``, ``'1'``, ...; ``append`` adds one."""

    def __init__(self, parameters=None):
        super().__init__(parameters)


class LayerDict(nn.ModuleDict):
    """Sublayers under their keys, in insertion order; ``update``
    takes a dict or ``(key, layer)`` pairs, ``pop`` and ``clear`` as a
    dict's."""

    def __init__(self, sublayers=None):
        super().__init__(sublayers)
