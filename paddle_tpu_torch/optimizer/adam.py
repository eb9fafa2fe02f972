"""Adam, AdamW, Adamax and Lamb (counterpart of
``paddle_tpu/optimizer/adam.py``).

The reference's formula and rounding, not ``torch.optim``'s: AdamW's
decoupled decay ``p * (1 - lr * wd)`` comes before the Adam step, the
bias corrections ``1 - beta ** t`` are taken in f32, and ``eps`` is
added outside the square root.  Python-float constants act in the
parameters' dtype, as the reference's weakly typed scalars do; the
per-step ones (the learning rate, the decay factor, the corrections,
Adamax's ``lr / (1 - beta1 ** t)``) are 0-d f32 tensors on the device
(``optimizer.py``) and act the same way.  Lamb's trust ratio is a
device reduction per parameter, read by nothing on the host.

Two arguments are accepted and never read, as in the reference:
``AdamW(lr_ratio=)`` and ``Lamb(exclude_from_weight_decay_fn=)``.
"""
import numpy as np
import torch

from .optimizer import Optimizer

__all__ = ['Adam', 'AdamW', 'Adamax', 'Lamb']


def _by(op, x, s):
    """``op(x, s)`` for a 0-d f32 tensor ``s``, as a Python float acts:
    a 16-bit ``x`` computes in f32 and rounds back to its dtype."""
    if x.dtype in (torch.bfloat16, torch.float16):
        return op(x.float(), s).to(x.dtype)
    return op(x, s)


def _f32_correction(beta, t):
    """``1 - beta ** t`` computed in f32."""
    return np.float32(1.0) - np.float32(beta) ** np.float32(t)


def _f32_norm(x):
    """``sqrt(sum(square(x)))`` in f32, a 0-d device tensor."""
    return torch.sqrt(x.float().square().sum())


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

    def _step_scalars(self, t, lr=None):
        return {**super()._step_scalars(t, lr),
                'c1': _f32_correction(self._beta1, t),
                'c2': _f32_correction(self._beta2, t)}

    def _rule(self, p, g, state, s):
        b1, b2, eps = self._beta1, self._beta2, self._epsilon
        m, v = state['moment1'], state['moment2']
        self._put(m, b1 * m + (1 - b1) * g)
        self._put(v, b2 * v + (1 - b2) * g.square())
        mhat = _by(torch.div, m, s['c1'])
        vhat = _by(torch.div, v, s['c2'])
        step = _by(torch.mul, mhat, s['lr']) / (torch.sqrt(vhat) + eps)
        return p - step.to(p.dtype)


class AdamW(Adam):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False, name=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         None, grad_clip)
        self._wd = weight_decay
        self._lr_ratio = lr_ratio       # unread, as in the reference
        self._apply_decay_param_fun = apply_decay_param_fun

    def _step_scalars(self, t, lr=None):
        if lr is None:
            lr = self._lr_value(t)
        # a scheduler's f32 LR gives an f32 product, a float's a double
        if isinstance(lr, np.float32):
            decay = np.float32(1) - lr * np.float32(self._wd)
        else:
            decay = np.float32(1 - lr * self._wd)
        return {**super()._step_scalars(t, lr), 'decay': decay}

    def _rule(self, p, g, state, s):
        # decoupled decay before the Adam step; apply_decay_param_fun
        # (name) == False exempts a parameter
        fn = self._apply_decay_param_fun
        if fn is None or fn(self._ctx_param_name):
            p = _by(torch.mul, p, s['decay'])
        return super()._rule(p, g, state, s)


class Adamax(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon

    def _create_state(self, p):
        return {'moment': torch.zeros_like(p),
                'inf_norm': torch.zeros_like(p)}

    def _step_scalars(self, t, lr=None):
        row = super()._step_scalars(t, lr)
        return {**row,
                'lr_c1': row['lr'] / _f32_correction(self._beta1, t)}

    def _rule(self, p, g, state, s):
        b1, b2, eps = self._beta1, self._beta2, self._epsilon
        m, u = state['moment'], state['inf_norm']
        self._put(m, b1 * m + (1 - b1) * g)
        self._put(u, torch.maximum(b2 * u, g.abs()))
        step = _by(torch.mul, m, s['lr_c1']) / (u + eps)
        return p - step.to(p.dtype)


class Lamb(Optimizer):
    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6, parameters=None,
                 grad_clip=None, exclude_from_weight_decay_fn=None,
                 name=None):
        super().__init__(learning_rate, parameters, None, grad_clip)
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon
        self._lamb_wd = lamb_weight_decay
        self._exclude_fn = exclude_from_weight_decay_fn  # unread, as there

    def _create_state(self, p):
        return {'moment1': torch.zeros_like(p),
                'moment2': torch.zeros_like(p)}

    def _step_scalars(self, t, lr=None):
        return {**super()._step_scalars(t, lr),
                'c1': _f32_correction(self._beta1, t),
                'c2': _f32_correction(self._beta2, t)}

    def _rule(self, p, g, state, s):
        b1, b2, eps = self._beta1, self._beta2, self._epsilon
        m, v = state['moment1'], state['moment2']
        self._put(m, b1 * m + (1 - b1) * g)
        self._put(v, b2 * v + (1 - b2) * g.square())
        mhat = _by(torch.div, m, s['c1'])
        vhat = _by(torch.div, v, s['c2'])
        r = mhat / (torch.sqrt(vhat) + eps) + self._lamb_wd * p
        w_norm, r_norm = _f32_norm(p), _f32_norm(r)
        trust = torch.where((w_norm > 0) & (r_norm > 0), w_norm / r_norm,
                            torch.ones_like(w_norm))
        return p - (s['lr'] * trust * r).to(p.dtype)
