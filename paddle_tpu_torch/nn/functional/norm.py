"""Normalization functionals (counterpart of
``paddle_tpu/nn/functional/norm.py``; the port has ``layer_norm``)."""
from ...amp import amp_cast
from ...ops.fused_norm import fused_layer_norm

__all__ = ['layer_norm']


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-5):
    """LayerNorm over the last axis, through ``fused_layer_norm`` (the
    kernel on a CUDA tensor, with or without weight/bias).  It is on
    the AMP keep list: a bf16 ``x`` keeps f32 gamma/beta and f32
    statistics.  The reference's multi-axis plain path has no caller in
    the port yet."""
    if isinstance(normalized_shape, int):
        normalized_shape = [normalized_shape]
    if len(tuple(normalized_shape)) != 1:
        raise NotImplementedError(
            'layer_norm over more than one axis is not ported yet')
    x, weight, bias = amp_cast('layer_norm', x, weight, bias)
    return fused_layer_norm(x, weight, bias, eps=epsilon)
