"""Adam and AdamW (counterpart of ``paddle_tpu/optimizer/adam.py``).

The reference's formula and rounding, not ``torch.optim``'s: AdamW's
decoupled decay ``p * (1 - lr * wd)`` comes before the Adam step, the
bias corrections ``1 - beta ** t`` are taken in f32, and ``eps`` is
added outside the square root.  Python-float constants act in the
parameters' dtype, as the reference's weakly typed scalars do.
"""
import numpy as np
import torch

from .optimizer import Optimizer

__all__ = ['Adam', 'AdamW']


def _f32_correction(beta, t):
    """``1 - beta ** t`` computed in f32, returned as a float."""
    return float(np.float32(1.0) - np.float32(beta) ** np.float32(t))


class Adam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon

    def _create_state(self, p):
        return {'moment1': torch.zeros_like(p),
                'moment2': torch.zeros_like(p)}

    def _rule(self, p, g, state, lr, t):
        b1, b2, eps = self._beta1, self._beta2, self._epsilon
        m = b1 * state['moment1'] + (1 - b1) * g
        v = b2 * state['moment2'] + (1 - b2) * g.square()
        mhat = m / _f32_correction(b1, t)
        vhat = v / _f32_correction(b2, t)
        new_p = p - (lr * mhat / (torch.sqrt(vhat) + eps)).to(p.dtype)
        return new_p, {'moment1': m, 'moment2': v}


class AdamW(Adam):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False, name=None):
        if lr_ratio is not None:
            raise NotImplementedError('AdamW lr_ratio is not ported yet')
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         None, grad_clip)
        self._wd = weight_decay
        self._apply_decay_param_fun = apply_decay_param_fun

    def _rule(self, p, g, state, lr, t):
        # decoupled decay before the Adam step; apply_decay_param_fun
        # (name) == False exempts a parameter
        fn = self._apply_decay_param_fun
        if fn is None or fn(self._ctx_param_name):
            p = p * (1 - lr * self._wd)
        return super()._rule(p, g, state, lr, t)
