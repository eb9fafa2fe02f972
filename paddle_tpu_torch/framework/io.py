"""``paddle.save`` / ``paddle.load`` (counterpart of
``paddle_tpu/framework/io.py``; Paddle's python/paddle/framework/io.py).

The wire format is the reference's: a pickle (protocol 4) of the object
with every tensor converted to host numpy, so a ``.pdparams`` or
``.pdopt`` file written by either package loads in the other.  ``load``
returns numpy arrays; ``set_state_dict`` copies them onto the device.
"""
import os
import pickle

import torch

__all__ = ['save', 'load']

_PROTO = 4


def _to_host(obj):
    if isinstance(obj, torch.Tensor):
        t = obj.detach().cpu()
        if t.dtype == torch.bfloat16:
            # numpy has no bfloat16; the reference pickles ml_dtypes'
            # bfloat16, which the port reads back through f32
            t = t.float()
        return t.numpy()
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def save(obj, path, protocol=_PROTO, **configs):
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, 'wb') as f:
        pickle.dump(_to_host(obj), f, protocol=protocol)


def load(path, **configs):
    with open(path, 'rb') as f:
        return pickle.load(f)
