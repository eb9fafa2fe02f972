"""Analytic FLOPs counter (counterpart of ``paddle_tpu/hapi/flops.py``;
Paddle's python/paddle/hapi/dynamic_flops.py).

Counts multiply-accumulates as 1 FLOP each (the reference's convention)
for the common layer types via forward hooks
(``register_forward_post_hook``) on a dummy forward of zeros on the
network's device.
"""
import numpy as np
import torch

from .. import nn
from .summary import _device, _post_hook

__all__ = ['flops']


def _prod(s):
    return int(np.prod(s)) if len(s) else 1


def _count(layer, inp, out):
    in_shape = inp[0].shape if inp else []
    out_shape = out.shape if isinstance(out, torch.Tensor) else \
        (out[0].shape if isinstance(out, (list, tuple)) and out else [])
    if isinstance(layer, (nn.Conv1D, nn.Conv2D, nn.Conv3D,
                          nn.Conv1DTranspose, nn.Conv2DTranspose,
                          nn.Conv3DTranspose)):
        kernel_ops = _prod(layer.kernel_size) * \
            (layer.in_channels // layer.groups)
        bias_ops = 1 if layer.bias is not None else 0
        return _prod(out_shape) * (kernel_ops + bias_ops)
    if isinstance(layer, nn.Linear):
        batch = _prod(in_shape[:-1])
        out_f = layer.weight.shape[-1]
        bias_ops = out_f if layer.bias is not None else 0
        return batch * (in_shape[-1] * out_f + bias_ops)
    if isinstance(layer, (nn.BatchNorm, nn.BatchNorm1D, nn.BatchNorm2D,
                          nn.BatchNorm3D, nn.LayerNorm, nn.GroupNorm)):
        return 2 * _prod(in_shape)
    if isinstance(layer, (nn.ReLU, nn.ReLU6, nn.Sigmoid, nn.Softmax,
                          nn.GELU, nn.Tanh)):
        return _prod(in_shape)
    if isinstance(layer, (nn.AvgPool1D, nn.AvgPool2D, nn.AvgPool3D,
                          nn.MaxPool1D, nn.MaxPool2D, nn.MaxPool3D,
                          nn.AdaptiveAvgPool1D, nn.AdaptiveAvgPool2D,
                          nn.AdaptiveAvgPool3D)):
        return _prod(out_shape)
    return 0


def flops(net, input_size, custom_ops=None, print_detail=False):
    """Total forward FLOPs for `net` on `input_size` (list incl. batch)."""
    custom_ops = custom_ops or {}
    total = [0]
    rows = []
    hooks = []

    def add_hooks(layer, prefix=''):
        subs = list(layer.named_children())
        if not subs:
            def hook(l, inp, out, name=prefix):
                fn = custom_ops.get(type(l))
                n = fn(l, inp, out) if fn else _count(l, inp, out)
                total[0] += n
                rows.append((name or l.__class__.__name__, n))
            hooks.append(_post_hook(layer, hook))
        for name, sub in subs:
            add_hooks(sub, f'{prefix}.{name}' if prefix else name)

    add_hooks(net)
    x = torch.zeros(input_size, dtype=torch.float32, device=_device(net))
    was_training = net.training
    net.eval()
    try:
        with torch.no_grad():
            net(x)
    finally:
        for h in hooks:
            h.remove()
        if was_training:
            net.train()
    if print_detail:
        for name, n in rows:
            print(f'{name:<50}{n:>16,}')
        print(f"{'Total FLOPs':<50}{total[0]:>16,}")
    return total[0]
