"""NanSentinel, the divergence policy of a training loop (counterpart
of ``paddle_tpu/resilience/sentinel.py``).

    finite step          -> 'ok'        (the strike counter resets)
    non-finite step      -> 'skip'      (the update was dropped)
    K consecutive skips  -> 'rollback'  (reload the last committed
                                         checkpoint; the counter
                                         resets)

and after ``max_rollbacks`` rollbacks a ``FloatingPointError``.  The
finiteness flag is formed on the device (``finite_step``) and the
update selected by it there (``guard_update``); only the flag crosses
to the host, where this policy lives.  The reference's telemetry events
wait for the telemetry port.
"""
import math

import torch

__all__ = ['NanSentinel', 'finite_step', 'guard_update']


def finite_step(loss, grads):
    """``isfinite(loss) & isfinite(sum of g**2)``, one 0-d bool on the
    device: the squares summed in f32 per tensor and the tensors' sums
    added in order, so an inf or NaN gradient trips it, and so does a
    finite one whose square overflows f32 (a gradient of 1e20)."""
    total = None
    for g in grads:
        s = g.float().square().sum()
        total = s if total is None else total + s
    ok = torch.isfinite(loss)
    return ok if total is None else ok & torch.isfinite(total)


def guard_update(ok, new, old):
    """``[where(ok, n, o)]`` over the tensors of ``new`` and ``old``: the
    device-side skip of a non-finite step, which keeps the old values
    (``ok`` a 0-d bool tensor)."""
    return [torch.where(ok, a, b) for a, b in zip(new, old)]


class NanSentinel:
    def __init__(self, patience=3, max_rollbacks=2, on_event=None):
        """``patience``: consecutive non-finite steps before a rollback
        is requested.  ``max_rollbacks``: past this many rollbacks the
        sentinel raises ``FloatingPointError`` instead.
        ``on_event(kind, info)`` observes the 'skip', 'rollback' and
        'fatal' transitions."""
        if patience < 1:
            raise ValueError('patience must be >= 1')
        self.patience = patience
        self.max_rollbacks = max_rollbacks
        self.on_event = on_event
        self.strikes = 0
        self.rollbacks = 0
        self.total_skipped = 0

    @staticmethod
    def _finite(v):
        if v is None:
            return True
        try:
            return math.isfinite(float(v))
        except (TypeError, ValueError):
            return False

    def observe(self, loss=None, grad_norm=None, finite=None):
        """Record one step's health: 'ok', 'skip' or 'rollback'.
        Callers with the device's finiteness flag pass ``finite=``,
        others host scalars for ``loss``/``grad_norm``."""
        if finite is None:
            finite = self._finite(loss) and self._finite(grad_norm)
        if finite:
            self.strikes = 0
            return 'ok'
        self.strikes += 1
        self.total_skipped += 1
        if self.strikes < self.patience:
            if self.on_event:
                self.on_event('skip', {'strikes': self.strikes,
                                       'loss': loss})
            return 'skip'
        self.strikes = 0
        self.rollbacks += 1
        if self.rollbacks > self.max_rollbacks:
            if self.on_event:
                self.on_event('fatal', {'rollbacks': self.rollbacks})
            raise FloatingPointError(
                f'training diverged: {self.patience} consecutive '
                f'non-finite steps after {self.rollbacks - 1} '
                'rollback(s) — refusing to loop; check LR/data/loss '
                'scaling')
        if self.on_event:
            self.on_event('rollback', {'rollbacks': self.rollbacks})
        return 'rollback'

    def state_dict(self):
        return {'strikes': self.strikes, 'rollbacks': self.rollbacks,
                'total_skipped': self.total_skipped}

    def load_state_dict(self, state):
        self.strikes = int(state.get('strikes', 0))
        self.rollbacks = int(state.get('rollbacks', 0))
        self.total_skipped = int(state.get('total_skipped', 0))
