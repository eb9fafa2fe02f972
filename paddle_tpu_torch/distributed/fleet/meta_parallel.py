"""Tensor-parallel layers, the pipeline structure and the RNG tracker,
single-device behaviour (counterpart of
``paddle_tpu/distributed/fleet/meta_parallel.py``).

There the layers hold full logical parameters and a PartitionSpec each;
on one device they are plain layers.  ``ParallelCrossEntropy`` is the
per-token cross entropy.  ``PipelineLayer`` builds its ``LayerDesc``s,
runs them in order and splits them into contiguous stages
(``stage_bounds``); the pipeline schedule over several cards is ROADMAP
item 9d.  ``RNGStatesTracker`` keeps named random streams: inside
``rng_state(name)`` every draw of the port (``core.rng.generator``)
comes from that stream's own ``torch.Generator`` on the device, seeded
by ``add`` (or from the name), and the global generators are left
where they stood.  Sharding over ``torch.distributed`` is item 9b.
"""
import contextlib
import math
import zlib

import torch

from ...core import rng as rng_mod
from ...nn import functional as F
from ...nn.initializer import XavierNormal
from ...nn.layer.common import Embedding, Linear
from ...nn.layer.layers import Layer

__all__ = ['ColumnParallelLinear', 'RowParallelLinear',
           'VocabParallelEmbedding', 'ParallelCrossEntropy',
           'PipelineLayer', 'LayerDesc', 'SharedLayerDesc',
           'get_rng_state_tracker', 'RNGStatesTracker']


class ColumnParallelLinear(Linear):
    """``Y = XW + b``; W would be column-split over tensor parallel."""

    def __init__(self, in_features, out_features, gather_output=True,
                 device=None):
        super().__init__(in_features, out_features, device=device)
        self.gather_output = gather_output


class RowParallelLinear(Linear):
    """``Y = XW + b``; W would be row-split over tensor parallel."""

    def __init__(self, in_features, out_features, input_is_parallel=False,
                 device=None):
        super().__init__(in_features, out_features, device=device)
        self.input_is_parallel = input_is_parallel


class VocabParallelEmbedding(Embedding):
    """Embedding whose vocab axis would be split over tensor parallel;
    its default init is XavierNormal, as the reference's (``nn.Embedding``
    draws N(0, 1))."""

    def reset_parameters(self, generator):
        XavierNormal().fill_(self.weight, generator)


class ParallelCrossEntropy(Layer):
    """Cross entropy over logits that would be split over tensor
    parallel: per token, no reduction."""

    def __init__(self, mp_group=None, name=None, ignore_index=-100):
        super().__init__()
        self.ignore_index = ignore_index

    def forward(self, input, label):
        return F.cross_entropy(input, label, reduction='none',
                               ignore_index=self.ignore_index)


# -- pipeline structure ------------------------------------------------------

class LayerDesc:
    """A deferred layer constructor: ``PipelineLayer`` builds it."""

    def __init__(self, layer_func, *inputs, **kwargs):
        self.layer_func = layer_func
        self.inputs = inputs
        self.kwargs = kwargs

    def build_layer(self):
        return self.layer_func(*self.inputs, **self.kwargs)


class SharedLayerDesc(LayerDesc):
    def __init__(self, key, layer_func, forward_func=None,
                 shared_weight_attr='weight', *inputs, **kwargs):
        super().__init__(layer_func, *inputs, **kwargs)
        self.layer_name = key
        self.forward_func = forward_func
        self.shared_weight_attr = shared_weight_attr


class PipelineLayer(Layer):
    """The full layer list, split into ``num_stages`` contiguous stages
    of ``ceil(n / num_stages)`` layers (the reference's uniform
    segmentation); on one device the forward runs them in order."""

    def __init__(self, layers, num_stages=1, loss_fn=None, topology=None,
                 seg_method='uniform', recompute_interval=0, **kwargs):
        super().__init__()
        self.descs = list(layers)
        self.num_stages = num_stages
        self.loss_fn = loss_fn
        self.recompute_interval = recompute_interval
        built = []
        for i, d in enumerate(self.descs):
            layer = d.build_layer() if isinstance(d, LayerDesc) else d
            built.append(layer)
            if isinstance(layer, torch.nn.Module):
                self.add_sublayer(str(i), layer)
        self.run_function = built
        n = len(built)
        per = int(math.ceil(n / num_stages))
        self.stage_bounds = [(s * per, min(n, (s + 1) * per))
                             for s in range(num_stages)]

    def stage_layers(self, stage_id):
        lo, hi = self.stage_bounds[stage_id]
        return self.run_function[lo:hi]

    def forward(self, x):
        for fn in self.run_function:
            x = fn(x)
        return x


# -- rng tracker -------------------------------------------------------------

class RNGStatesTracker:
    """Named random streams (module docstring)."""

    def __init__(self):
        self.states = {}        # name -> seed
        self._gens = {}         # (name, device) -> torch.Generator

    def add(self, name, seed):
        self.states[name] = int(seed)
        for key in [k for k in self._gens if k[0] == name]:
            del self._gens[key]

    def _generator(self, name, device):
        key = (name, rng_mod._key(device))
        gen = self._gens.get(key)
        if gen is None:
            gen = torch.Generator(device=key[1])
            gen.manual_seed(self.states[name])
            self._gens[key] = gen
        return gen

    @contextlib.contextmanager
    def rng_state(self, name='model_parallel'):
        if name not in self.states:
            self.add(name, zlib.crc32(name.encode()) & 0x7fffffff)
        with rng_mod.scoped(lambda device: self._generator(name, device)):
            yield


_tracker = RNGStatesTracker()


def get_rng_state_tracker():
    return _tracker
