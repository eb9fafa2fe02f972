"""Weight-only post-training quantization for serving.

Counterpart of the dynamic-PTQ half of ``paddle_tpu/quantization``:
``Int8DynamicLinear`` and ``Int4DynamicLinear`` (a Linear's weight
quantized per output channel, held as int8 or as packed int4, the
activation quantized per call, an int8 x int8 -> int32 product:
``ops/int8_matmul.py``), the in-place swap (``quantize_dynamic_int8``,
``quantize_dynamic_int4``), ``quantize_for_serving`` (the
``ServeConfig(quantize=...)`` entry point, which marks the model with
``_ptq_mode``) and ``quant_post_dynamic`` (the per-tensor int8
artifact of the reference's ``PostTrainingQuantization`` without
calibration).  The buffers are named ``qweight`` and ``wscale`` and the
bias stays, so state-dict keys equal the reference's.

The QAT half (``fake_quant``, the ``FakeQuant*`` layers,
``QuantedLayer``, ``ImperativeQuantAware``,
``PostTrainingQuantization`` with a calibration loader, the ``.quant``
artifact's save and load) ports with the training side.
"""
import numpy as np
import torch
from torch import nn

from ..amp import amp_cast
from ..distributed.fleet.meta_parallel import (ColumnParallelLinear,
                                               RowParallelLinear)
from ..nn.layer.common import Linear
from ..ops.int8_matmul import (dynamic_int4_matmul, dynamic_int8_matmul,
                               quantize_weight_int4_packed,
                               quantize_weight_int8)

__all__ = ['quant_post_dynamic', 'Int8DynamicLinear', 'Int4DynamicLinear',
           'quantize_dynamic_int8', 'quantize_dynamic_int4',
           'quantize_for_serving']

# the layer types the reference's PostTrainingQuantization quantizes
_DEFAULT_QUANTIZABLE = ('Conv2D', 'Linear')


def _named_sublayers(model):
    """Dotted (name, layer) pairs, the root left out (the reference's
    ``named_sublayers``)."""
    return [(n, m) for n, m in model.named_modules() if n]


def quant_post_dynamic(model):
    """Weight-only dynamic quantization without calibration: for every
    ``Linear`` and ``Conv2D`` (by exact type name, as the reference
    matches them), ``{name}.qweight`` (int8, one per-tensor abs-max
    scale) and ``{name}.scale``, as numpy, computed on the host with
    the reference's numpy arithmetic."""
    out = {}
    for name, layer in _named_sublayers(model):
        if type(layer).__name__ in _DEFAULT_QUANTIZABLE \
                and getattr(layer, 'weight', None) is not None:
            w = layer.weight.detach().cpu().numpy()
            scale = float(np.abs(w).max()) or 1e-8
            out[f'{name}.qweight'] = np.clip(
                np.round(w / scale * 127), -127, 127).astype(np.int8)
            out[f'{name}.scale'] = np.float32(scale)
    return out


def _out_dtype(x):
    return x.dtype if torch.is_floating_point(x) else torch.bfloat16


class Int8DynamicLinear(nn.Module):
    """A serving Linear on int8 weights: ``qweight`` int8 ``[in, out]``
    and ``wscale`` f32 ``[out]`` (per output channel), the bias kept;
    the activation quantizes per call and the product accumulates in
    int32 (``ops.int8_matmul.dynamic_int8_matmul``).  Inference only."""

    def __init__(self, linear):
        super().__init__()
        w = linear.weight                   # [in, out] in every variant
        self.in_features = int(w.shape[0])
        self.out_features = int(w.shape[1])
        with torch.no_grad():
            q, scale = quantize_weight_int8(w.detach())
        self.register_buffer('qweight', q)
        self.register_buffer('wscale', scale)
        self.bias = linear.bias

    def forward(self, x):
        x, q, s, b = amp_cast('int8_linear', x, self.qweight, self.wscale,
                              self.bias)
        return dynamic_int8_matmul(x, q, s, b, out_dtype=_out_dtype(x))

    def extra_repr(self):
        return f'in={self.in_features}, out={self.out_features}, int8'


class Int4DynamicLinear(nn.Module):
    """A serving Linear on packed int4 weights: ``qweight`` uint8
    ``[ceil(in/2), out]`` (two ``in`` rows a byte), ``wscale`` f32
    ``[out]`` on the int4 grid (qmax 7), the bias kept; the nibbles
    unpack to int8 per call and go through the int8 product.
    Inference only."""

    def __init__(self, linear):
        super().__init__()
        w = linear.weight
        self.in_features = int(w.shape[0])
        self.out_features = int(w.shape[1])
        with torch.no_grad():
            packed, scale = quantize_weight_int4_packed(w.detach())
        self.register_buffer('qweight', packed)
        self.register_buffer('wscale', scale)
        self.bias = linear.bias

    def forward(self, x):
        x, q, s, b = amp_cast('int4_linear', x, self.qweight, self.wscale,
                              self.bias)
        return dynamic_int4_matmul(x, q, s, rows=self.in_features, bias=b,
                                   out_dtype=_out_dtype(x))

    def extra_repr(self):
        return f'in={self.in_features}, out={self.out_features}, int4'


def _quantize_dynamic(model, make_layer, layer_filter=None):
    """Swap every exact ``Linear``, ``ColumnParallelLinear`` and
    ``RowParallelLinear`` sublayer of ``model`` for ``make_layer(sub)``,
    in place.  On one device no tensor-parallel axis is live, so the
    parallel linears are plain ones, as the reference swaps them when
    no tp axis is live; subclasses keep their own math.
    ``layer_filter(full_name, layer) -> bool`` opts layers out.
    Returns ``model``."""
    swappable = (Linear, ColumnParallelLinear, RowParallelLinear)

    def walk(layer, prefix=''):
        n = 0
        for name, sub in list(layer.named_children()):
            full = f'{prefix}.{name}' if prefix else name
            if type(sub) in swappable and (layer_filter is None
                                           or layer_filter(full, sub)):
                layer._modules[name] = make_layer(sub)
                n += 1
            else:
                n += walk(sub, full)
        return n

    if walk(model) == 0:
        hint = ''
        if type(model) in swappable:
            hint = (' — the ROOT layer is itself a quantizable '
                    'Linear, but an in-place swap needs a parent: '
                    'wrap it (e.g. nn.Sequential(model)) and '
                    'quantize that')
        raise ValueError('no quantizable Linear sublayers found' + hint)
    # a captured module (generate's graphs) reads the old weights
    cache = getattr(model, '_gen_cache', None)
    if cache is not None:
        cache.clear()
    return model


def quantize_dynamic_int8(model, layer_filter=None):
    """Swap every plain Linear sublayer of ``model`` for an
    ``Int8DynamicLinear``, in place::

        model.eval()
        quantize_dynamic_int8(model)
        model.generate(ids, max_new_tokens=128)
    """
    return _quantize_dynamic(model, Int8DynamicLinear, layer_filter)


def quantize_dynamic_int4(model, layer_filter=None):
    """int4 twin of :func:`quantize_dynamic_int8`: packed nibbles,
    unpacked per call; a coarser grid, so measure quality first."""
    return _quantize_dynamic(model, Int4DynamicLinear, layer_filter)


_SERVING_MODES = {'int8': quantize_dynamic_int8,
                  'int4': quantize_dynamic_int4}


def quantize_for_serving(model, mode='int8', layer_filter=None):
    """Weight-only PTQ of a serving model, in place: ``mode`` 'int8'
    (``Int8DynamicLinear``) or 'int4' (packed ``Int4DynamicLinear``).
    Activations stay dynamic per call; the KV cache, the embeddings and
    the tied head keep their dtype.  The swap drops the float weights,
    so the model is marked (``_ptq_mode``) and a ``ServingEngine``
    declaring another mode refuses it.  Returns ``model``."""
    fn = _SERVING_MODES.get(mode)
    if fn is None:
        raise ValueError(
            f'quantize_for_serving mode {mode!r}: expected one of '
            f'{sorted(_SERVING_MODES)}')
    model.eval()
    fn(model, layer_filter)
    model._ptq_mode = mode
    return model
