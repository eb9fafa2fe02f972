"""Model summary (counterpart of ``paddle_tpu/hapi/summary.py``; Paddle's
python/paddle/hapi/model_summary.py).

Walks the Layer tree with forward hooks (``register_forward_post_hook``)
on a dummy forward of zeros on the network's device, reporting per-layer
output shapes and parameter counts, in the reference's table.
"""
import numpy as np
import torch

__all__ = ['summary']


def _post_hook(layer, hook):
    """``Layer.register_forward_post_hook``, or torch's forward hook on
    a plain module (the zoo's models and containers)."""
    reg = getattr(layer, 'register_forward_post_hook', None) or \
        layer.register_forward_hook
    return reg(hook)


def _dtype(dt):
    if isinstance(dt, torch.dtype):
        return dt
    return getattr(torch, str(dt))


def _num_params(layer):
    own = [p for _, p in layer.named_parameters(recurse=False)]
    return sum(int(np.prod(p.shape)) for p in own), \
        sum(int(np.prod(p.shape)) for p in own if p.requires_grad)


def _shape_of(out):
    if isinstance(out, torch.Tensor):
        return list(out.shape)
    if isinstance(out, (list, tuple)) and out:
        return _shape_of(out[0])
    return []


def _device(net):
    for t in list(net.parameters()) + list(net.buffers()):
        return t.device
    return torch.device('cpu')


def summary(net, input_size=None, dtypes=None, input=None):
    """Print a per-layer table; returns {'total_params', 'trainable_params'}."""
    assert isinstance(net, torch.nn.Module)
    if input is None:
        assert input_size is not None, 'need input_size or input'
        sizes = input_size if isinstance(input_size, list) and \
            isinstance(input_size[0], (list, tuple)) else [input_size]
        dtypes = dtypes or ['float32'] * len(sizes)
        if isinstance(dtypes, str):
            dtypes = [dtypes] * len(sizes)
        dev = _device(net)
        inputs = [torch.zeros([s if s is not None else 1 for s in size],
                              dtype=_dtype(dt), device=dev)
                  for size, dt in zip(sizes, dtypes)]
    else:
        inputs = input if isinstance(input, (list, tuple)) else [input]

    rows = []
    hooks = []

    def register(layer, prefix):
        subs = list(layer.named_children())
        if not subs:
            def hook(l, inp, out, name=prefix,
                     cls=layer.__class__.__name__):
                tot, train = _num_params(l)
                rows.append((f'{cls}-{len(rows) + 1}', name,
                             _shape_of(out), tot))
            hooks.append(_post_hook(layer, hook))
        for name, sub in subs:
            register(sub, f'{prefix}.{name}' if prefix else name)

    register(net, '')
    was_training = net.training
    net.eval()
    try:
        with torch.no_grad():
            net(*inputs)
    finally:
        for h in hooks:
            h.remove()
        if was_training:
            net.train()

    total = sum(int(np.prod(p.shape)) for p in net.parameters())
    trainable = sum(int(np.prod(p.shape)) for p in net.parameters()
                    if p.requires_grad)

    name_w = max([len(r[0]) for r in rows] + [12]) + 2
    shape_w = max([len(str(r[2])) for r in rows] + [14]) + 2
    line = '-' * (name_w + shape_w + 14)
    print(line)
    print(f"{'Layer (type)':<{name_w}}{'Output Shape':<{shape_w}}"
          f"{'Param #':>12}")
    print('=' * (name_w + shape_w + 14))
    for cls_name, _, shape, n in rows:
        print(f'{cls_name:<{name_w}}{str(shape):<{shape_w}}{n:>12,}')
    print('=' * (name_w + shape_w + 14))
    print(f'Total params: {total:,}')
    print(f'Trainable params: {trainable:,}')
    print(f'Non-trainable params: {total - trainable:,}')
    print(line)
    return {'total_params': total, 'trainable_params': trainable}
