"""Optimizer base (counterpart of ``paddle_tpu/optimizer/optimizer.py``).

Each optimizer is an update rule ``_rule(p, g, state, s) -> p'`` over
plain tensors, as in the reference; ``step()`` applies it to every
parameter that has a gradient and writes ``p'`` into the parameter in
place.  The rule updates its state (Adam's moments) in place too, so a
CUDA graph that captured a step (``ParallelTrainer.step_fused``) goes
on reading and writing the same tensors.

The per-step scalars (the learning rate, and Adam's bias corrections
and decoupled decay) are not Python floats baked into the kernels but
0-d f32 tensors on the parameters' device, ``s[name]``, views of one
buffer: ``_load_step(t)`` computes them on the host in f32 and copies
them in before each step, so one ``_rule`` serves ``step()`` and a
replayed graph, which agree bit for bit.  (On the card a division by
such a tensor divides, where one by a Python float multiplies by its
reciprocal.)  The learning rate is a float (``set_lr``); the ``lr.py``
schedulers, gradient clipping and regularizer objects are not ported
yet and raise.
"""
import numpy as np
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
        self._scalar_buf = None      # the per-step scalars, on the device
        self._scalars = {}           # name -> 0-d view of _scalar_buf

    # -- lr ------------------------------------------------------------------
    def get_lr(self):
        return self._learning_rate

    def set_lr(self, value):
        self._learning_rate = float(value)

    # -- state ---------------------------------------------------------------
    def _create_state(self, p):
        """Per-parameter slots (subclass)."""
        return {}

    def _step_scalars(self, t):
        """``{name: value}`` of the per-step scalars of step ``t``
        (1-based), each rounded to f32 as the kernels would round a
        Python float (subclasses add theirs)."""
        return {'lr': np.float32(self.get_lr())}

    def _rule(self, p, g, state, s):
        """The update: returns ``new_p`` and updates ``state`` in place;
        ``s`` maps the names of ``_step_scalars`` to 0-d f32 tensors
        (subclass)."""
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
    def _scalar_rows(self, t0, k):
        """The per-step scalars of steps ``t0 .. t0 + k - 1``: ``[k, n]``
        f32 on the host, one row a step."""
        rows = [self._step_scalars(t) for t in range(t0, t0 + k)]
        return torch.tensor(np.array([list(r.values()) for r in rows],
                                     np.float32))

    def _load_step(self, row):
        """Copy one row of ``_scalar_rows`` (host or device) into the
        device buffer the rule reads, on the current stream; a host row
        goes through pinned memory, so the copy waits for no queued
        work."""
        buf = self._scalar_buf
        if buf is None:
            names = list(self._step_scalars(1))
            buf = torch.zeros(len(names), dtype=torch.float32,
                              device=self._params[0].device)
            self._scalar_buf = buf
            self._scalars = {n: buf[i] for i, n in enumerate(names)}
        if buf.is_cuda and row.device.type == 'cpu':
            row = row.pin_memory()
        buf.copy_(row, non_blocking=True)

    @torch.no_grad()
    def _update(self):
        """One update from the parameters' ``.grad`` with the scalars
        ``_load_step`` left in the buffer: only device work, so a graph
        can capture it.  A parameter's state is made at its first
        update."""
        for i, p in enumerate(self._params):
            if not p.requires_grad or p.grad is None:
                continue
            key = id(p)
            if key not in self._accumulators:
                self._accumulators[key] = self._create_state(p)
            g = self._apply_weight_decay_grad(p, p.grad.to(p.dtype))
            self._ctx_param_name = self._name(i, p)
            p.copy_(self._rule(p, g, self._accumulators[key],
                               self._scalars))

    def _apply(self, t):
        """One update at step number ``t`` (1-based) from the
        parameters' ``.grad``."""
        self._load_step(self._scalar_rows(t, 1)[0])
        self._update()
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
