"""SGD, Momentum, Adagrad, Adadelta, RMSProp and Lars (counterpart of
``paddle_tpu/optimizer/sgd_family.py``).

The reference's update rules in its order of operations; each writes
its state in place through ``_put`` (``optimizer.py``), so one rule
serves ``step()``, a replayed CUDA graph and the NaN guard.  Lars's
trust ratio takes f32 norms of the parameter and its gradient, device
reductions that nothing reads back on the host.
"""
import torch

from .optimizer import Optimizer

__all__ = ['SGD', 'Momentum', 'Adagrad', 'Adadelta', 'RMSProp', 'Lars']


class SGD(Optimizer):
    def _rule(self, p, g, state, s):
        return p - (s['lr'] * g).to(p.dtype)


class Momentum(Optimizer):
    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._momentum = momentum
        self._nesterov = use_nesterov

    def _create_state(self, p):
        return {'velocity': torch.zeros_like(p)}

    def _rule(self, p, g, state, s):
        mu, v = self._momentum, state['velocity']
        self._put(v, mu * v + g)
        upd = g + mu * v if self._nesterov else v
        return p - (s['lr'] * upd).to(p.dtype)


class Adagrad(Optimizer):
    def __init__(self, learning_rate, epsilon=1e-6, parameters=None,
                 weight_decay=None, grad_clip=None,
                 initial_accumulator_value=0.0, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._epsilon = epsilon
        self._init_acc = initial_accumulator_value

    def _create_state(self, p):
        return {'moment': torch.full_like(p, self._init_acc)}

    def _rule(self, p, g, state, s):
        acc = state['moment']
        self._put(acc, acc + g.square())
        return p - (s['lr'] * g / (torch.sqrt(acc) + self._epsilon)).to(
            p.dtype)


class Adadelta(Optimizer):
    def __init__(self, learning_rate=0.001, epsilon=1e-6, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._epsilon = epsilon
        self._rho = rho

    def _create_state(self, p):
        return {'avg_squared_grad': torch.zeros_like(p),
                'avg_squared_update': torch.zeros_like(p)}

    def _rule(self, p, g, state, s):
        rho, eps = self._rho, self._epsilon
        asg, asu = state['avg_squared_grad'], state['avg_squared_update']
        self._put(asg, rho * asg + (1 - rho) * g.square())
        upd = (torch.sqrt(asu + eps) / torch.sqrt(asg + eps)) * g
        self._put(asu, rho * asu + (1 - rho) * upd.square())
        return p - (s['lr'] * upd).to(p.dtype)


class RMSProp(Optimizer):
    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._rho = rho
        self._epsilon = epsilon
        self._momentum = momentum
        self._centered = centered

    def _create_state(self, p):
        st = {'mean_square': torch.zeros_like(p),
              'momentum': torch.zeros_like(p)}
        if self._centered:
            st['mean_grad'] = torch.zeros_like(p)
        return st

    def _rule(self, p, g, state, s):
        rho, eps, mu = self._rho, self._epsilon, self._momentum
        ms, mom = state['mean_square'], state['momentum']
        self._put(ms, rho * ms + (1 - rho) * g.square())
        if self._centered:
            mg = state['mean_grad']
            self._put(mg, rho * mg + (1 - rho) * g)
            denom = torch.sqrt(ms - mg.square() + eps)
        else:
            denom = torch.sqrt(ms + eps)
        self._put(mom, mu * mom + s['lr'] * g / denom)
        return p - mom.to(p.dtype)


class Lars(Momentum):
    """LARS: a layer-wise trust ratio on top of momentum."""

    def __init__(self, learning_rate=0.001, momentum=0.9,
                 lars_coeff=0.001, lars_weight_decay=0.0005,
                 parameters=None, grad_clip=None, name=None):
        super().__init__(learning_rate, momentum, parameters, False, None,
                         grad_clip)
        self._lars_coeff = lars_coeff
        self._lars_wd = lars_weight_decay

    def _rule(self, p, g, state, s):
        from .adam import _f32_norm
        group = getattr(p, '_tp_group', None)
        w_norm, g_norm = _f32_norm(p, group), _f32_norm(g, group)
        local_lr = torch.where(
            (w_norm > 0) & (g_norm > 0),
            self._lars_coeff * w_norm /
            (g_norm + self._lars_wd * w_norm + 1e-12),
            torch.ones_like(w_norm))
        g = g + self._lars_wd * p
        v = state['velocity']
        self._put(v, self._momentum * v + (s['lr'] * local_lr) * g)
        return p - v.to(p.dtype)
