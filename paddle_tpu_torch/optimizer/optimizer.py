"""Optimizer base (counterpart of ``paddle_tpu/optimizer/optimizer.py``).

Each optimizer is an update rule ``_rule(p, g, state, lr, t) -> (p',
state')`` over plain tensors, as in the reference; ``step()`` applies it
to every parameter that has a gradient and writes ``p'`` into the
parameter in place.  The learning rate is a float (``set_lr``); the
``lr.py`` schedulers, gradient clipping and regularizer objects are not
ported yet and raise.
"""
import torch

__all__ = ['Optimizer']


class Optimizer:
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None,
                 multi_precision=False):
        if isinstance(learning_rate, bool) or not isinstance(
                learning_rate, (int, float)):
            raise NotImplementedError(
                'learning-rate schedulers (lr.py) are not ported yet; '
                'pass a float')
        if grad_clip is not None:
            raise NotImplementedError('grad_clip is not ported yet')
        if weight_decay is not None and not isinstance(weight_decay, float):
            raise NotImplementedError(
                'regularizer objects are not ported yet; pass a float')
        self._parameter_list = list(parameters) if parameters is not None \
            else None
        self._learning_rate = float(learning_rate)
        self._coupled_wd = weight_decay or 0.0
        self._accumulators = {}     # id(param) -> state dict
        self._param_names = {}      # id(param) -> name (set by callers)
        self._global_step = 0
        self._ctx_param_name = None  # name of the param in _rule

    # -- lr ------------------------------------------------------------------
    def get_lr(self):
        return self._learning_rate

    def set_lr(self, value):
        self._learning_rate = float(value)

    # -- state ---------------------------------------------------------------
    def _create_state(self, p):
        """Per-parameter slots (subclass)."""
        return {}

    def _rule(self, p, g, state, lr, t):
        """Pure update: ``(new_p, new_state)`` (subclass)."""
        raise NotImplementedError

    def _apply_weight_decay_grad(self, p, g):
        """Coupled (L2-to-grad) decay like the reference's regularizer."""
        return g + self._coupled_wd * p if self._coupled_wd else g

    @property
    def _params(self):
        if self._parameter_list is None:
            raise ValueError('optimizer constructed without parameters')
        return self._parameter_list

    def _name(self, i, p):
        return self._param_names.get(id(p), str(i))

    # -- eager API -----------------------------------------------------------
    @torch.no_grad()
    def _apply(self, t):
        """One update at step number ``t`` (1-based) from the
        parameters' ``.grad``."""
        lr = self.get_lr()
        for i, p in enumerate(self._params):
            if not p.requires_grad or p.grad is None:
                continue
            key = id(p)
            if key not in self._accumulators:
                self._accumulators[key] = self._create_state(p)
            g = self._apply_weight_decay_grad(p, p.grad.to(p.dtype))
            self._ctx_param_name = self._name(i, p)
            new_p, new_state = self._rule(p, g, self._accumulators[key],
                                          lr, t)
            p.copy_(new_p)
            self._accumulators[key] = new_state
        self._global_step = t

    def step(self):
        self._apply(self._global_step + 1)

    def clear_grad(self):
        for p in self._params:
            p.grad = None

    # -- checkpointing -------------------------------------------------------
    def state_dict(self):
        """``{'global_step': n, '<name>_<slot>': tensor}``, the
        reference's flat layout."""
        sd = {'global_step': self._global_step}
        for i, p in enumerate(self._params):
            for k, v in self._accumulators.get(id(p), {}).items():
                sd[f'{self._name(i, p)}_{k}'] = v
        return sd
