"""Quantization: QAT, calibrated PTQ and weight-only serving PTQ
(counterpart of ``paddle_tpu/quantization``).

QAT (the reference's ``imperative/qat.py``): ``fake_quant`` rounds to
the ``bits``-bit grid of ``[-scale, scale]`` and back, in the input's
dtype, with a straight-through gradient (``g * (|x| <= scale)``, none
to the scale).  ``FakeQuantAbsMax`` takes the scale from the tensor
itself (per tensor, or per channel through ``_channel_scale``),
``FakeQuantMovingAverageAbsMax`` keeps a moving-average scale buffer
that training updates in place and eval freezes.  ``QuantedLayer``
wraps a ``Linear`` or ``Conv2D``: its input and weight go through fake
quant for the call (``functional_call``), while the optimizer trains
the float master weight.  ``ImperativeQuantAware`` wraps a model's
layers in place and saves the ``.quant`` artifact (int8 ``qweight``,
``scale``, ``qmax``, ``act_scale``, as numpy, pickled);
``PostTrainingQuantization`` records each layer's input abs-max over
calibration batches and emits the same kind of artifact;
``load_quantized_model`` dequantizes an artifact into a model's live
float weights.  Keys, dtypes and values are the reference's, so an
artifact of either package loads into the other.

Serving PTQ: ``Int8DynamicLinear`` and ``Int4DynamicLinear`` (a
Linear's weight quantized per output channel, held as int8 or as packed
int4, the activation quantized per call, an int8 x int8 -> int32
product: ``ops/int8_matmul.py``), the in-place swap
(``quantize_dynamic_int8``, ``quantize_dynamic_int4``, which leave
``QuantedLayer``s alone), ``quantize_for_serving`` (the
``ServeConfig(quantize=...)`` entry point, which marks the model with
``_ptq_mode``) and ``quant_post_dynamic`` (``PostTrainingQuantization``
without calibration).  The buffers are named ``qweight`` and ``wscale``
and the bias stays, so state-dict keys equal the reference's.
"""
import pickle

import numpy as np
import torch
from torch import nn
from torch.func import functional_call

from ..amp import amp_cast
from ..core.recompute import forward_value, recomputing
from ..distributed.fleet.meta_parallel import (ColumnParallelLinear,
                                               RowParallelLinear)
from ..nn.layer.common import Linear
from ..ops.int8_matmul import (dynamic_int4_matmul, dynamic_int8_matmul,
                               quantize_weight_int4_packed,
                               quantize_weight_int8)

__all__ = ['fake_quant', 'FakeQuantAbsMax', 'FakeQuantMovingAverageAbsMax',
           'QuantedLayer', 'ImperativeQuantAware',
           'PostTrainingQuantization', 'quant_post_dynamic',
           'load_quantized_model', 'Int8DynamicLinear', 'Int4DynamicLinear',
           'quantize_dynamic_int8', 'quantize_dynamic_int4',
           'quantize_for_serving']

# the layer types QAT and PTQ quantize, matched by exact type name
_DEFAULT_QUANTIZABLE = ('Conv2D', 'Linear')


def _named_sublayers(model):
    """Dotted (name, layer) pairs, the root left out (the reference's
    ``named_sublayers``)."""
    return [(n, m) for n, m in model.named_modules() if n]


class _FakeQuant(torch.autograd.Function):
    """``clip(round(x / s * qmax), -qmax, qmax) * s / qmax`` with ``s =
    max(scale, 1e-8)``; the gradient passes where ``|x| <= s`` and
    nowhere else, and none reaches ``scale`` or ``qmax``.  Every
    division is by a tensor: PyTorch's CUDA division by a Python number
    multiplies by a rounded reciprocal, off the CPU's grid."""

    @staticmethod
    def forward(ctx, x, scale, qmax):
        s = torch.clamp_min(scale, 1e-8)
        q = torch.clamp(torch.round(x / s * qmax), -qmax, qmax)
        ctx.save_for_backward(x.abs() <= s)
        return q * s / qmax

    @staticmethod
    def backward(ctx, g):
        inside, = ctx.saved_tensors
        return g * inside.to(g.dtype), None, None


def _fq(x, scale, qmax):
    """The reference's ``_fq(x, scale, jnp.asarray(qmax, x.dtype))``:
    ``qmax`` in x's dtype, x and scale promoted together as JAX
    promotes two arrays."""
    dt = torch.promote_types(x.dtype, scale.dtype)
    q = torch.full((), qmax, dtype=x.dtype, device=x.device).to(dt)
    return _FakeQuant.apply(x.to(dt), scale.to(dt), q)


def _qmax(bits):
    return float(2 ** (bits - 1) - 1)


def _channel_scale(w, axis):
    """Per-channel abs-max scale of ``w`` along ``axis``, shaped to
    broadcast against it: the one definition of the channel-wise grid,
    which QAT's fake quant simulates and the artifact stores (on the
    host, from a CPU tensor)."""
    red = tuple(d for d in range(w.dim()) if d != axis)
    shape = [1] * w.dim()
    shape[axis] = w.shape[axis]
    return torch.clamp_min(w.abs().amax(dim=red), 1e-8).reshape(shape)


def fake_quant(x, scale, bits=8):
    """Quantize ``x`` to ``bits`` against ``scale`` and dequantize, with
    the straight-through gradient (the reference's
    ``fake_quantize_dequantize_abs_max``)."""
    x, scale = amp_cast('fake_quant', x, torch.as_tensor(scale))
    return _fq(x, scale.to(x.device), _qmax(bits))


class FakeQuantAbsMax(nn.Module):
    """Fake quant against the tensor's own abs-max, per tensor or per
    channel along ``axis``."""

    def __init__(self, bits=8, channel_wise=False, axis=0):
        super().__init__()
        self.bits = bits
        self.channel_wise = channel_wise
        self.axis = axis

    def forward(self, x):
        x, = amp_cast('fake_quant_abs_max', x)
        v = x.detach()
        s = _channel_scale(v, self.axis) if self.channel_wise \
            else v.abs().amax()
        return _fq(x, s, _qmax(self.bits))


class FakeQuantMovingAverageAbsMax(nn.Module):
    """Activation fake quant against a moving-average abs-max: the
    ``scale`` buffer ``[1]`` f32 starts at the first batch's abs-max,
    then moves by ``moving_rate`` each training call, in place (so a
    captured step replays the update); eval reads it frozen."""

    def __init__(self, bits=8, moving_rate=0.9, device=None):
        super().__init__()
        self.bits = bits
        self.moving_rate = moving_rate
        self.register_buffer('scale', torch.zeros(1, dtype=torch.float32,
                                                  device=device))

    def forward(self, x):
        x, scale = amp_cast('fake_quant_moving_avg', x, self.scale)
        old = scale[0]
        cur = x.detach().abs().amax().float()
        if self.training:
            def moved():
                # JAX's weak-typed scalars: r meets old in old's dtype
                # (bf16 under O2), 1 - r meets cur in f32
                r = self.moving_rate
                m = torch.full((), r, dtype=old.dtype, device=old.device) \
                    * old + torch.full((), 1 - r, device=cur.device) * cur
                return torch.where(old > 0, m, cur)
            # a recomputation (core.recompute) takes the forward's scale,
            # not one moved from the scale the forward wrote
            new = forward_value(moved)
        else:
            new = torch.where(old > 0, old, cur)
        out = _fq(x, new.to(x.dtype), _qmax(self.bits))
        if self.training and not recomputing():
            with torch.no_grad():
                self.scale.copy_(new.reshape(1))
        return out


class QuantedLayer(nn.Module):
    """``layer`` with fake quant on its input (``act_fq``) and on its
    weight (``weight_fq``; channel axis 1 for a Linear's ``[in, out]``
    weight, 0 for a conv's ``[out, in, kh, kw]``) for each call; the
    optimizer keeps training ``inner.weight`` in float."""

    def __init__(self, layer, weight_bits=8, act_bits=8,
                 weight_quantize_type='abs_max',
                 activation_quantize_type='moving_average_abs_max',
                 moving_rate=0.9):
        super().__init__()
        self.inner = layer
        w = layer.weight
        self.weight_fq = FakeQuantAbsMax(
            weight_bits,
            channel_wise=weight_quantize_type == 'channel_wise_abs_max',
            axis=1 if w.dim() == 2 else 0)
        if activation_quantize_type == 'moving_average_abs_max':
            self.act_fq = FakeQuantMovingAverageAbsMax(
                act_bits, moving_rate, device=w.device)
        else:
            self.act_fq = FakeQuantAbsMax(act_bits)

    def forward(self, x):
        x = self.act_fq(x)
        w = self.weight_fq(self.inner.weight)
        return functional_call(self.inner, {'weight': w}, (x,))


class ImperativeQuantAware:
    """Rewrites a model's quantizable sublayers for QAT, in place (the
    reference's ``imperative/qat.py:40``)."""

    def __init__(self, quantizable_layer_type=_DEFAULT_QUANTIZABLE,
                 weight_quantize_type='abs_max',
                 activation_quantize_type='moving_average_abs_max',
                 weight_bits=8, activation_bits=8, moving_rate=0.9,
                 **unused):
        self.types = tuple(t if isinstance(t, str) else t.__name__
                           for t in quantizable_layer_type)
        self.wq = weight_quantize_type
        self.aq = activation_quantize_type
        self.wbits = weight_bits
        self.abits = activation_bits
        self.moving_rate = moving_rate

    def quantize(self, model):
        """Swap every sublayer whose type name is quantizable (and that
        has a weight) for its ``QuantedLayer``, in place."""
        self._quantize_tree(model)
        return model

    def _quantize_tree(self, layer):
        for name, child in list(layer.named_children()):
            if type(child).__name__ in self.types \
                    and getattr(child, 'weight', None) is not None:
                layer._modules[name] = QuantedLayer(
                    child, self.wbits, self.abits, self.wq, self.aq,
                    self.moving_rate)
            else:
                self._quantize_tree(child)

    def save_quantized_model(self, model, path, input_spec=None):
        """Write ``path + '.quant'``: for each ``QuantedLayer`` its int8
        ``qweight`` on the grid QAT simulated (per tensor, or per
        channel through ``_channel_scale``; qmax from its weight bits),
        ``scale``, ``qmax`` and the activation scale, as numpy, with the
        reference's host arithmetic.  Returns the dict."""
        state = {}
        for name, layer in _named_sublayers(model):
            if not isinstance(layer, QuantedLayer):
                continue
            wt = layer.inner.weight.detach().float().cpu()
            w = wt.numpy()
            if layer.weight_fq.channel_wise:
                scale = _channel_scale(wt, layer.weight_fq.axis).numpy()
            else:
                scale = np.float32(float(np.abs(w).max()) or 1e-8)
            bits = layer.weight_fq.bits
            if bits > 8:
                raise ValueError(f'cannot store {bits}-bit weights in the '
                                 'int8 artifact')
            qmax = _qmax(bits)
            state[f'{name}.qweight'] = np.clip(
                np.round(w / scale * qmax), -qmax, qmax).astype(np.int8)
            state[f'{name}.scale'] = scale
            state[f'{name}.qmax'] = np.float32(qmax)
            act_scale = getattr(layer.act_fq, 'scale', None)
            if act_scale is not None:
                state[f'{name}.act_scale'] = act_scale.detach().cpu().numpy()
        with open(path + '.quant', 'wb') as f:
            pickle.dump(state, f)
        return state


class PostTrainingQuantization:
    """Calibrated PTQ, abs_max: forward pre-hooks record each
    quantizable layer's input abs-max over up to ``batch_nums`` batches
    of ``data_loader`` (any iterable; a batch is an array or tensor, or
    a tuple whose first item is), then each layer's weight quantizes to
    int8 against its per-tensor abs-max (the reference's
    ``post_training_quantization.py``)."""

    def __init__(self, model, data_loader=None, batch_nums=10,
                 algo='abs_max', quantizable_op_type=_DEFAULT_QUANTIZABLE):
        if algo not in ('abs_max',):
            raise NotImplementedError(f'PTQ algo {algo!r}; abs_max only')
        self.model = model
        self.loader = data_loader
        self.batch_nums = batch_nums
        self.types = tuple(t if isinstance(t, str) else t.__name__
                           for t in quantizable_op_type)
        self._act_scales = {}

    def _layers(self):
        return [(name, layer) for name, layer in _named_sublayers(self.model)
                if type(layer).__name__ in self.types
                and getattr(layer, 'weight', None) is not None]

    def quantize(self):
        """Calibrate, then return the artifact's dict: ``qweight``,
        ``scale`` and, for a layer that saw a batch, ``act_scale``."""
        def make_hook(name):
            def hook(layer, inputs):
                v = float(inputs[0].detach().abs().max())
                self._act_scales[name] = max(
                    self._act_scales.get(name, 0.0), v)
            return hook

        hooks = [layer.register_forward_pre_hook(make_hook(name))
                 for name, layer in self._layers()]
        try:
            if self.loader is not None:
                device = next(self.model.parameters()).device
                for i, batch in enumerate(self.loader):
                    if i >= self.batch_nums:
                        break
                    xs = batch[0] if isinstance(batch, (list, tuple)) \
                        else batch
                    if not torch.is_tensor(xs):
                        xs = torch.from_numpy(np.asarray(xs))
                    with torch.no_grad():
                        self.model(xs.to(device))
        finally:
            for h in hooks:
                h.remove()
        out = {}
        for name, layer in self._layers():
            w = layer.weight.detach().float().cpu().numpy()
            scale = float(np.abs(w).max()) or 1e-8
            out[f'{name}.qweight'] = np.clip(
                np.round(w / scale * 127), -127, 127).astype(np.int8)
            out[f'{name}.scale'] = np.float32(scale)
            if name in self._act_scales:
                out[f'{name}.act_scale'] = np.float32(
                    self._act_scales[name])
        return out

    def save_quantized_model(self, save_model_path, **kw):
        state = self.quantize()
        with open(save_model_path + '.quant', 'wb') as f:
            pickle.dump(state, f)
        return state


def quant_post_dynamic(model):
    """Weight-only quantization without calibration: for every
    ``Linear`` and ``Conv2D`` (by exact type name), ``{name}.qweight``
    (int8, one per-tensor abs-max scale) and ``{name}.scale``, as
    numpy."""
    return PostTrainingQuantization(model).quantize()


def load_quantized_model(model, path):
    """Load ``path + '.quant'`` onto ``model``: each int8 weight,
    dequantized through its scale (and qmax, 127 where the artifact has
    none), is copied into the live float weight of the layer of that
    name (a ``QuantedLayer``'s ``inner``).  Raises ``KeyError`` for a
    name the model lacks and ``ValueError`` for an artifact without
    weights.  Returns ``model``."""
    with open(path + '.quant', 'rb') as f:
        state = pickle.load(f)
    layers = dict(_named_sublayers(model))
    n = 0
    for key, q in state.items():
        if not key.endswith('.qweight'):
            continue
        name = key[:-len('.qweight')]
        scale = state[name + '.scale']
        target = layers.get(name)
        if target is None:
            raise KeyError(f'{name!r} not found in model')
        if isinstance(target, QuantedLayer):
            target = target.inner
        qmax = float(state.get(name + '.qmax', 127.0))
        w = np.asarray(q, np.float32) * np.asarray(scale, np.float32) / qmax
        with torch.no_grad():
            target.weight.copy_(torch.from_numpy(w))
        n += 1
    if n == 0:
        raise ValueError(f'no quantized weights in {path}.quant')
    return model


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
    in place, leaving ``QuantedLayer``s alone.  On one device no
    tensor-parallel axis is live, so the parallel linears are plain ones,
    as the reference swaps them when no tp axis is live; subclasses keep
    their own math.
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
            elif isinstance(sub, QuantedLayer):
                # its forward reads inner.weight for the fake quant; a
                # QAT model deploys through the .quant artifact
                continue
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
