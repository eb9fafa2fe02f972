"""Tensor printing (counterpart of ``paddle_tpu/tensor/to_string.py``):
``set_printoptions`` and ``to_string``, which gives the reference's
string for the same values.  The port has no ``stop_gradient``: the
string shows ``not requires_grad`` in its place."""
import numpy as np
import torch

__all__ = ['set_printoptions', 'to_string']

_options = {
    'precision': 8,
    'threshold': 1000,
    'edgeitems': 3,
    'linewidth': 80,
    'sci_mode': None,
}


def set_printoptions(precision=None, threshold=None, edgeitems=None,
                     sci_mode=None, linewidth=None):
    """The global print format (numpy's knobs, which back it)."""
    if precision is not None:
        _options['precision'] = int(precision)
    if threshold is not None:
        _options['threshold'] = int(threshold)
    if edgeitems is not None:
        _options['edgeitems'] = int(edgeitems)
    if linewidth is not None:
        _options['linewidth'] = int(linewidth)
    if sci_mode is not None:
        _options['sci_mode'] = bool(sci_mode)


def _host(var):
    """``(numpy array, dtype name)``; bfloat16 prints through float32."""
    if not isinstance(var, torch.Tensor):
        arr = np.asarray(var)
        return arr, arr.dtype.name
    t = var.detach().cpu()
    name = str(t.dtype).replace('torch.', '')
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy(), name


def to_string(var, prefix='Tensor'):
    arr, dtype = _host(var)
    kw = dict(precision=_options['precision'],
              threshold=_options['threshold'],
              edgeitems=_options['edgeitems'],
              linewidth=_options['linewidth'])
    if _options['sci_mode']:
        prec = _options['precision']
        kw['formatter'] = {
            'float_kind': lambda v: np.format_float_scientific(
                v, precision=prec)}
    elif _options['sci_mode'] is not None:
        kw['suppress'] = True
    with np.printoptions(**kw):
        body = np.array2string(arr, separator=', ')
    sg = not getattr(var, 'requires_grad', False)
    return (f'{prefix}(shape={list(arr.shape)}, dtype={dtype}, '
            f'stop_gradient={sg},\n       {body})')
