"""LR schedulers (counterpart of ``paddle_tpu/optimizer/lr.py``).

The stateful API is the reference's, in the same host float arithmetic:
``step()`` advances ``last_epoch`` and sets ``last_lr = get_lr()``, and
the optimizer's eager ``step()`` reads ``scheduler()``, the value at
``last_epoch``.

``value_at(t)`` is the schedule as a function of the optimizer's step
count, which the trainer evaluates at every step (1-based) and never
through ``last_epoch``.  The reference traces it inside its compiled
step with an int32 step, so its value is f32 arithmetic on the device;
the port forms the per-step scalars on the host, so ``value_at`` here
is a host function of an int that repeats that f32 arithmetic in
``np.float32`` and returns an ``np.float32``.  It repeats it as XLA
compiles it: a division by a constant becomes a product by the
constant's f32 reciprocal, constant factors fold into one f32 constant,
a product and a sum contract into one fused multiply-add (``_fma``), and
``cos`` is libm's (``math.cos``, rounded to f32) rather than numpy's
vectorised one, so each value agrees with the JAX trainer's to the last
bit or one ulp.  The optimizer derives its other per-step scalars from
it in f32 as well.
``ReduceOnPlateau.value_at`` is the live ``last_lr`` as a Python float,
as the reference returns it (which the reference's ``jax.jit`` then
bakes in at trace time, where the port reads it at every step).
"""
import math

import numpy as np

__all__ = [
    'LRScheduler', 'NoamDecay', 'ExponentialDecay', 'NaturalExpDecay',
    'InverseTimeDecay', 'PolynomialDecay', 'PiecewiseDecay',
    'CosineAnnealingDecay', 'MultiStepDecay', 'StepDecay', 'LambdaDecay',
    'ReduceOnPlateau', 'LinearWarmup',
]

_f32 = np.float32


def _fma(a, b, c):
    """``a * b + c`` of f32 values rounded once to f32: the product of
    two f32 values is exact in double."""
    return _f32(np.float64(a) * np.float64(b) + np.float64(c))


class LRScheduler:
    def __init__(self, learning_rate=0.1, last_epoch=-1, verbose=False):
        self.base_lr = float(learning_rate)
        self.last_epoch = last_epoch
        self.last_lr = float(learning_rate)
        self.verbose = verbose
        self.step()

    def __call__(self):
        return self.last_lr

    def step(self, epoch=None):
        if epoch is None:
            self.last_epoch += 1
        else:
            self.last_epoch = epoch
        self.last_lr = self.get_lr()

    def get_lr(self):
        return self.value_at(self.last_epoch)

    def value_at(self, step):
        """The LR at optimizer step ``step`` (an int), in the f32
        arithmetic of the reference's traced schedule."""
        raise NotImplementedError

    def state_dict(self):
        return {'last_epoch': self.last_epoch, 'last_lr': self.last_lr}

    def set_state_dict(self, state):
        self.last_epoch = state['last_epoch']
        self.last_lr = state['last_lr']

    set_dict = set_state_dict


class NoamDecay(LRScheduler):
    def __init__(self, d_model, warmup_steps, learning_rate=1.0,
                 last_epoch=-1, verbose=False):
        self.d_model = d_model
        self.warmup_steps = warmup_steps
        super().__init__(learning_rate, last_epoch, verbose)

    def value_at(self, step):
        s = max(_f32(step), _f32(1.0))
        a = s ** _f32(-0.5)
        b = s * _f32(self.warmup_steps ** -1.5)
        return _f32(self.base_lr * (self.d_model ** -0.5)) * min(a, b)

    def get_lr(self):
        step = max(self.last_epoch, 1)
        a = step ** -0.5
        b = step * (self.warmup_steps ** -1.5)
        return self.base_lr * (self.d_model ** -0.5) * min(a, b)


class ExponentialDecay(LRScheduler):
    def __init__(self, learning_rate, gamma, last_epoch=-1, verbose=False):
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def value_at(self, step):
        return _f32(self.base_lr) * _f32(self.gamma) ** _f32(step)

    def get_lr(self):
        return self.base_lr * self.gamma ** self.last_epoch


class NaturalExpDecay(LRScheduler):
    def __init__(self, learning_rate, gamma, last_epoch=-1, verbose=False):
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def value_at(self, step):
        return _f32(self.base_lr) * np.exp(_f32(-self.gamma) * _f32(step))

    def get_lr(self):
        return self.base_lr * math.exp(-self.gamma * self.last_epoch)


class InverseTimeDecay(LRScheduler):
    def __init__(self, learning_rate, gamma, last_epoch=-1, verbose=False):
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def value_at(self, step):
        return _f32(self.base_lr) / _fma(_f32(self.gamma), _f32(step),
                                         _f32(1))

    def get_lr(self):
        return self.base_lr / (1 + self.gamma * self.last_epoch)


class PolynomialDecay(LRScheduler):
    """``value_at`` clamps at ``decay_steps`` and ignores ``cycle``, as
    the reference's does; ``get_lr`` honours it."""

    def __init__(self, learning_rate, decay_steps, end_lr=0.0001, power=1.0,
                 cycle=False, last_epoch=-1, verbose=False):
        self.decay_steps = decay_steps
        self.end_lr = end_lr
        self.power = power
        self.cycle = cycle
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        step = self.last_epoch
        if self.cycle:
            div = math.ceil(max(step, 1) / self.decay_steps)
            decay_steps = self.decay_steps * max(div, 1)
        else:
            decay_steps = self.decay_steps
            step = min(step, decay_steps)
        return ((self.base_lr - self.end_lr) *
                (1 - step / decay_steps) ** self.power + self.end_lr)

    def value_at(self, step):
        s = min(_f32(step), _f32(self.decay_steps))
        frac = _fma(-s, _f32(1 / self.decay_steps), _f32(1))
        return _fma(frac ** _f32(self.power),
                    _f32(self.base_lr - self.end_lr), _f32(self.end_lr))


class PiecewiseDecay(LRScheduler):
    def __init__(self, boundaries, values, last_epoch=-1, verbose=False):
        self.boundaries = list(boundaries)
        self.values = list(values)
        super().__init__(values[0], last_epoch, verbose)

    def get_lr(self):
        for b, v in zip(self.boundaries, self.values):
            if self.last_epoch < b:
                return v
        return self.values[len(self.boundaries)]

    def value_at(self, step):
        for b, v in zip(self.boundaries, self.values):
            if step < b:
                return _f32(v)
        return _f32(self.values[len(self.boundaries)])


class CosineAnnealingDecay(LRScheduler):
    def __init__(self, learning_rate, T_max, eta_min=0, last_epoch=-1,
                 verbose=False):
        self.T_max = T_max
        self.eta_min = eta_min
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return (self.eta_min + (self.base_lr - self.eta_min) *
                (1 + math.cos(math.pi * self.last_epoch / self.T_max)) / 2)

    def value_at(self, step):
        angle = _f32(step) * (_f32(math.pi) * _f32(1 / self.T_max))
        c = _f32(math.cos(angle))
        half = _f32(self.base_lr - self.eta_min) * _f32(0.5)
        return _fma(_f32(1) + c, half, _f32(self.eta_min))


class MultiStepDecay(LRScheduler):
    def __init__(self, learning_rate, milestones, gamma=0.1, last_epoch=-1,
                 verbose=False):
        self.milestones = list(milestones)
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        n = sum(1 for m in self.milestones if self.last_epoch >= m)
        return self.base_lr * self.gamma ** n

    def value_at(self, step):
        n = sum(1 for m in self.milestones if step >= m)
        return _f32(self.base_lr) * _f32(self.gamma) ** _f32(n)


class StepDecay(LRScheduler):
    def __init__(self, learning_rate, step_size, gamma=0.1, last_epoch=-1,
                 verbose=False):
        self.step_size = step_size
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr * self.gamma ** (self.last_epoch //
                                             self.step_size)

    def value_at(self, step):
        return _f32(self.base_lr) * _f32(self.gamma) ** _f32(
            step // self.step_size)


class LambdaDecay(LRScheduler):
    """``value_at`` calls ``lr_lambda`` on the step as an ``np.float32``
    (the reference calls it on the traced int32 step, whose arithmetic
    with Python floats is f32) and rounds its value to f32."""

    def __init__(self, learning_rate, lr_lambda, last_epoch=-1,
                 verbose=False):
        self.lr_lambda = lr_lambda
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr * self.lr_lambda(self.last_epoch)

    def value_at(self, step):
        return _f32(self.base_lr) * _f32(self.lr_lambda(_f32(step)))


class ReduceOnPlateau(LRScheduler):
    def __init__(self, learning_rate, mode='min', factor=0.1, patience=10,
                 threshold=1e-4, threshold_mode='rel', cooldown=0, min_lr=0,
                 epsilon=1e-8, verbose=False):
        self.mode = mode
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.threshold_mode = threshold_mode
        self.cooldown = cooldown
        self.min_lr = min_lr
        self.epsilon = epsilon
        self.best = None
        self.cooldown_counter = 0
        self.num_bad_epochs = 0
        self.base_lr = float(learning_rate)
        self.last_lr = float(learning_rate)
        self.last_epoch = 0
        self.verbose = verbose

    def step(self, metrics=None, epoch=None):
        self.last_epoch += 1
        if metrics is None:
            return
        current = float(metrics.item() if hasattr(metrics, 'item')
                        else metrics)
        if self.best is None or self._better(current, self.best):
            self.best = current
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.num_bad_epochs = 0
        if self.num_bad_epochs > self.patience:
            new_lr = max(self.last_lr * self.factor, self.min_lr)
            if self.last_lr - new_lr > self.epsilon:
                self.last_lr = new_lr
            self.cooldown_counter = self.cooldown
            self.num_bad_epochs = 0

    def _better(self, a, best):
        if self.mode == 'min':
            if self.threshold_mode == 'rel':
                return a < best * (1 - self.threshold)
            return a < best - self.threshold
        if self.threshold_mode == 'rel':
            return a > best * (1 + self.threshold)
        return a > best + self.threshold

    def get_lr(self):
        return self.last_lr

    def value_at(self, step):
        return self.last_lr


class LinearWarmup(LRScheduler):
    def __init__(self, learning_rate, warmup_steps, start_lr, end_lr,
                 last_epoch=-1, verbose=False):
        self.lr_sched = learning_rate if isinstance(learning_rate,
                                                    LRScheduler) else None
        self.after_lr = (learning_rate if not self.lr_sched else None)
        self.warmup_steps = warmup_steps
        self.start_lr = start_lr
        self.end_lr = end_lr
        super().__init__(end_lr if self.lr_sched is None else
                         self.lr_sched.base_lr, last_epoch, verbose)

    def get_lr(self):
        if self.last_epoch < self.warmup_steps:
            return (self.start_lr + (self.end_lr - self.start_lr) *
                    self.last_epoch / self.warmup_steps)
        if self.lr_sched is not None:
            self.lr_sched.last_epoch = self.last_epoch - self.warmup_steps
            return self.lr_sched.get_lr()
        return self.after_lr

    def value_at(self, step):
        if step < self.warmup_steps:
            slope = _f32(self.end_lr - self.start_lr) * _f32(
                1 / self.warmup_steps)
            return _fma(_f32(step), slope, _f32(self.start_lr))
        if self.lr_sched is not None:
            return _f32(self.lr_sched.value_at(
                max(step - self.warmup_steps, 0)))
        return _f32(self.after_lr)
