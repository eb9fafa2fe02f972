"""DGCMomentum, Deep Gradient Compression's momentum (counterpart of
``paddle_tpu/optimizer/dgc.py``).

The reference's convergence semantics (Lin et al. 2018): per parameter,
after ``rampup_begin_step``,

    u <- m * u + g          (momentum correction)
    v <- v + u              (error feedback)
    thr = quantile(|v|, s(t)), linearly interpolated
    mask = |v| >= thr
    p <- p - lr * (v * mask)
    v <- v * !mask ; u <- u * !mask

and before it plain heavy-ball momentum that zeroes ``v``.  The sparsity
``s(t)`` walks the ``sparsity`` list over ``rampup_step`` steps.

The threshold is ``jnp.quantile``'s linear interpolation between two
order statistics of a sort (``torch.quantile`` refuses more than 2^24
elements, and GPT's ``wte`` has 38.6 M), with its f32 position
arithmetic; a NaN in ``|v|`` makes it NaN, as there.  The step's gate
(``t > rampup_begin``) and sparsity are per-step scalars.  While the
host knows the step (``Optimizer._t``) the gate is a host branch, so the
dense steps never sort; in a captured step, where the step number lives
on the device, both branches run and the gate selects.
"""
import numpy as np
import torch

from .optimizer import Optimizer

__all__ = ['DGCMomentum']


def quantile_linear(flat, q):
    """``jnp.quantile(flat, q)`` (method 'linear') of a 1-D f32 tensor
    at a 0-d f32 tensor ``q``, on the device: position ``q * (n - 1)``
    in f32, the two order statistics around it from a sort (on the CPU
    from ``kthvalue``: the same two numbers), weighted ``1 - frac`` and
    ``frac``."""
    n = flat.numel()
    pos = q * float(np.float32(n) - np.float32(1))
    low, high = torch.floor(pos), torch.ceil(pos)
    hw = pos - low
    lw = 1 - hw
    low, high = low.clamp(0, n - 1).long(), high.clamp(0, n - 1).long()
    if not flat.is_cuda:
        # the host reads the positions for free: the two order
        # statistics by selection, the sort's numbers in linear time
        lo, hi = int(low), int(high)
        a_lo = torch.kthvalue(flat, lo + 1).values
        a_hi = a_lo if hi == lo else torch.kthvalue(flat, hi + 1).values
        nan = torch.isnan(flat).any()
        return torch.where(nan, torch.full_like(a_lo, float('nan')),
                           a_lo * lw + a_hi * hw)
    a = torch.sort(flat).values
    thr = (torch.index_select(a, 0, low.view(1))[0] * lw
           + torch.index_select(a, 0, high.view(1))[0] * hw)
    return torch.where(torch.isnan(a[-1]), a[-1], thr)


class DGCMomentum(Optimizer):
    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 rampup_begin_step=0, rampup_step=1,
                 sparsity=(0.999,), use_nesterov=False, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._momentum = momentum
        self._nesterov = bool(use_nesterov)
        self._rampup_begin = int(rampup_begin_step)
        self._rampup_step = max(int(rampup_step), 1)
        seq = sparsity if isinstance(sparsity, (tuple, list)) else [sparsity]
        self._sparsity_seq = tuple(float(s) for s in seq)

    def _create_state(self, p):
        return {'u': torch.zeros_like(p), 'v': torch.zeros_like(p)}

    def _sparsity_at(self, t):
        """The ramp's sparsity at step ``t`` (f32): entry i of the list
        holds for ``rampup_step / len`` steps from the first sparse step
        ``rampup_begin + 1``, then the last stays."""
        n = len(self._sparsity_seq)
        since = max(t - self._rampup_begin - 1, 0)
        idx = min(max(since * n // self._rampup_step, 0), n - 1)
        return np.float32(self._sparsity_seq[idx])

    def _step_scalars(self, t, lr=None):
        return {**super()._step_scalars(t, lr),
                'sparse': np.float32(t > self._rampup_begin),
                'sparsity': self._sparsity_at(t)}

    def _sparse(self, p, g, u, v, s):
        m = self._momentum
        flat = v.abs().reshape(-1)
        thr = quantile_linear(flat, s['sparsity']) if flat.numel() > 1 \
            else torch.zeros((), dtype=flat.dtype, device=flat.device)
        mask = (v.abs() >= thr).to(v.dtype)
        step = v * mask
        if self._nesterov:
            step = m * step + g * mask
        return p - s['lr'] * step, u * (1 - mask), v * (1 - mask)

    def _dense(self, p, g, u, v, s):
        step = self._momentum * u + g if self._nesterov else u
        return p - s['lr'] * step, u, torch.zeros_like(v)

    def _rule(self, p, g, state, s):
        u = self._momentum * state['u'] + g
        v = state['v'] + u
        t = self._t
        if t is not None:
            new = (self._sparse if t > self._rampup_begin else
                   self._dense)(p, g, u, v, s)
        else:
            gate = s['sparse'] > 0
            new = [torch.where(gate, a, b) for a, b in
                   zip(self._sparse(p, g, u, v, s),
                       self._dense(p, g, u, v, s))]
        self._put(state['u'], new[1])
        self._put(state['v'], new[2])
        return new[0]
