"""Optimizer base (counterpart of ``paddle_tpu/optimizer/optimizer.py``).

Each optimizer is an update rule ``_rule(p, g, state, s) -> p'`` over
plain tensors, as in the reference; ``step()`` applies it to every
parameter that has a gradient and writes ``p'`` into the parameter in
place.  The rule updates its state (Adam's moments) in place too, through
``_put``, so a CUDA graph that captured a step
(``ParallelTrainer.step_fused``) goes on reading and writing the same
tensors.

The per-step scalars (the learning rate, and Adam's bias corrections
and decoupled decay) are not Python floats baked into the kernels but
0-d f32 tensors on the parameters' device, ``s[name]``, views of one
buffer: ``_load_step(t)`` computes them on the host in f32 and copies
them in before each step, so one ``_rule`` serves ``step()`` and a
replayed graph, which agree bit for bit.  (On the card a division by
such a tensor divides, where one by a Python float multiplies by its
reciprocal.)

The learning rate is a float or an ``lr.LRScheduler``, read at two step
indexings, as in the reference: the eager ``step()`` takes ``get_lr()``,
the scheduler's value at its ``last_epoch`` (which only
``scheduler.step()`` advances), while the trainer takes
``_lr_value(t)``, the schedule's ``value_at`` the optimizer step ``t``.
A scheduler's ``value_at`` is an f32 value, and the scalars derived from
it are formed in f32 arithmetic; a float learning rate is a Python float
whose derived scalars are formed in double and rounded once, as the
reference's weakly typed scalars are.

``grad_clip`` (``nn.clip``) runs before the coupled decay: its eager
``__call__`` (which honours ``need_clip``) under ``step()``, its
``clip_values`` under the trainer.  ``weight_decay`` is a float or an
``L2Decay`` (``g + coeff * p``) or an ``L1Decay`` (``g + coeff *
sign(p)``).

Under the trainer's NaN guard ``_guard`` holds the step's finite flag, a
0-d bool on the device, and every write of a step (the parameters and
each slot of state) selects the new value where the flag is set and
keeps the old one where not (``_put``): a non-finite step leaves them
as they were, as the reference's ``guard_update`` does.  ``_t`` is the
host's step number while the rule runs eagerly, and None while it lives
on the device (a captured step), where a rule that branches on the step
selects on the device instead.
"""
import numpy as np
import torch

from .lr import LRScheduler

__all__ = ['Optimizer']


class Optimizer:
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None,
                 multi_precision=False):
        if not isinstance(learning_rate, LRScheduler) and (
                isinstance(learning_rate, bool)
                or not isinstance(learning_rate, (int, float))):
            raise TypeError('learning_rate must be a float or an '
                            f'optimizer.lr scheduler, got {learning_rate!r}')
        self._parameter_list = list(parameters) if parameters is not None \
            else None
        self._learning_rate = learning_rate \
            if isinstance(learning_rate, LRScheduler) \
            else float(learning_rate)
        self._grad_clip = grad_clip
        self._coupled_wd = 0.0 if weight_decay is None else weight_decay
        self._accumulators = {}     # id(param) -> state dict
        self._param_names = {}      # id(param) -> name (set by callers)
        self._global_step = 0
        self._ctx_param_name = None  # name of the param in _rule
        self._scalar_buf = None      # the per-step scalars, on the device
        self._scalars = {}           # name -> 0-d view of _scalar_buf
        self._guard = None           # the step's finite flag (nan_guard)
        self._t = None               # the host's step number, if known

    # -- lr ------------------------------------------------------------------
    def get_lr(self):
        if isinstance(self._learning_rate, LRScheduler):
            return self._learning_rate()
        return self._learning_rate

    def set_lr(self, value):
        self._learning_rate = float(value)

    def _lr_value(self, step):
        """The learning rate of optimizer step ``step`` under the trainer:
        a scheduler's ``value_at(step)``, or the float."""
        if isinstance(self._learning_rate, LRScheduler):
            return self._learning_rate.value_at(step)
        return self._learning_rate

    # -- state ---------------------------------------------------------------
    def _create_state(self, p):
        """Per-parameter slots (subclass)."""
        return {}

    def _step_scalars(self, t, lr=None):
        """``{name: value}`` of the per-step scalars of step ``t``
        (1-based) at learning rate ``lr`` (the trainer's ``_lr_value(t)``
        if None), each rounded to f32 as the kernels would round a Python
        float (subclasses add theirs)."""
        return {'lr': np.float32(self._lr_value(t) if lr is None else lr)}

    def _rule(self, p, g, state, s):
        """The update: returns ``new_p`` and updates ``state`` through
        ``_put``; ``s`` maps the names of ``_step_scalars`` to 0-d f32
        tensors (subclass)."""
        raise NotImplementedError

    def _put(self, dst, src):
        """Write ``src`` into ``dst`` in place, or, under the NaN guard,
        where the step is finite."""
        if self._guard is None:
            dst.copy_(src)
        else:
            torch.where(self._guard, src, dst, out=dst)

    def _apply_weight_decay_grad(self, p, g):
        """Coupled (L2-to-grad, or L1) decay like the reference's
        regularizer."""
        wd = self._coupled_wd
        if wd:
            coeff = getattr(wd, '_coeff', wd)
            if getattr(wd, '_mode', 'l2') == 'l1':
                return g + coeff * torch.sign(p)
            return g + coeff * p
        return g

    @property
    def _params(self):
        if self._parameter_list is None:
            raise ValueError('optimizer constructed without parameters')
        return self._parameter_list

    def _name(self, i, p):
        return self._param_names.get(id(p), str(i))

    # -- eager API -----------------------------------------------------------
    def _scalar_rows(self, t0, k, eager=False):
        """The per-step scalars of steps ``t0 .. t0 + k - 1``: ``[k, n]``
        f32 on the host, one row a step, at ``get_lr()`` (``eager``) or at
        the trainer's ``_lr_value(t)``."""
        rows = [self._step_scalars(
                    t, self.get_lr() if eager else self._lr_value(t))
                for t in range(t0, t0 + k)]
        return torch.tensor(np.array([list(r.values()) for r in rows],
                                     np.float32))

    def _scalar_names(self):
        return list(self._step_scalars(1))

    def _load_step(self, row):
        """Copy one row of ``_scalar_rows`` (host or device) into the
        device buffer the rule reads, on the current stream; a host row
        goes through pinned memory, so the copy waits for no queued
        work."""
        buf = self._ensure_scalar_buf()
        if buf.is_cuda and row.device.type == 'cpu':
            row = row.pin_memory()
        buf.copy_(row, non_blocking=True)

    def _load_step_at(self, table, pos):
        """Copy row ``pos`` (a 1-element long tensor on the device) of a
        device ``table`` of ``_scalar_rows`` into the buffer: the row is
        picked on the device, so a captured step can follow a counter
        that lives there."""
        self._ensure_scalar_buf().copy_(
            torch.index_select(table, 0, pos).view(-1))

    def _ensure_scalar_buf(self):
        buf = self._scalar_buf
        if buf is None:
            names = self._scalar_names()
            buf = torch.zeros(len(names), dtype=torch.float32,
                              device=self._params[0].device)
            self._scalar_buf = buf
            self._scalars = {n: buf[i] for i, n in enumerate(names)}
        return buf

    @torch.no_grad()
    def _update(self, functional=True):
        """One update from the parameters' ``.grad`` with the scalars
        ``_load_step`` left in the buffer: only device work, so a graph
        can capture it.  The clip runs first, through ``clip_values``
        (``functional``, the trainer's) or its eager ``__call__``.  A
        parameter's state is made at its first update."""
        pg = [(i, p) for i, p in enumerate(self._params)
              if p.requires_grad and p.grad is not None]
        grads = [p.grad for _, p in pg]
        clip = self._grad_clip
        if clip is not None:
            grads = clip.clip_values(grads) if functional else [
                g for _, g in clip([(p, g) for (_, p), g in
                                    zip(pg, grads)])]
        for (i, p), g in zip(pg, grads):
            key = id(p)
            if key not in self._accumulators:
                self._accumulators[key] = self._create_state(p)
            g = self._apply_weight_decay_grad(p, g.to(p.dtype))
            self._ctx_param_name = self._name(i, p)
            s = self._scalars if functional else self._param_scalars(p)
            self._put(p, self._rule(p, g, self._accumulators[key], s))

    def _param_scalars(self, p):
        """The eager step's scalars for ``p``: its ``ParamAttr``
        learning-rate multiplier (``p.optimize_attr``) scales the rate,
        as the reference's eager ``step`` does (its trainer does not)."""
        mult = getattr(p, 'optimize_attr', {}).get('learning_rate', 1.0)
        if mult == 1.0:
            return self._scalars
        row = self._step_scalars(self._t, self.get_lr() * mult)
        return {n: torch.tensor(v, device=p.device) for n, v in row.items()}

    def _apply(self, t):
        """One eager update at step number ``t`` (1-based) from the
        parameters' ``.grad``, at ``get_lr()``."""
        self._load_step(self._scalar_rows(t, 1, eager=True)[0])
        self._t = t
        self._update(functional=False)
        self._global_step = t

    def step(self):
        self._apply(self._global_step + 1)

    def clear_grad(self):
        for p in self._params:
            p.grad = None

    # -- checkpointing -------------------------------------------------------
    def state_dict(self):
        """``{'global_step': n, 'LR_Scheduler': {...}, '<name>_<slot>':
        tensor}``, the reference's flat layout."""
        sd = {'global_step': self._global_step}
        if isinstance(self._learning_rate, LRScheduler):
            sd['LR_Scheduler'] = self._learning_rate.state_dict()
        for i, p in enumerate(self._params):
            for k, v in self._accumulators.get(id(p), {}).items():
                sd[f'{self._name(i, p)}_{k}'] = v
        return sd

    @torch.no_grad()
    def set_state_dict(self, sd):
        """Load ``state_dict``'s layout.  A parameter with any of its
        slots in ``sd`` gets them (the rest fresh); state that exists is
        written in place, so a captured step keeps its tensors."""
        self._global_step = sd.get('global_step', 0)
        if isinstance(self._learning_rate, LRScheduler) and \
                'LR_Scheduler' in sd:
            self._learning_rate.set_state_dict(sd['LR_Scheduler'])
        for i, p in enumerate(self._params):
            st = self._create_state(p)
            found = False
            for k in st:
                key = f'{self._name(i, p)}_{k}'
                if key in sd:
                    st[k] = torch.as_tensor(np.asarray(sd[key]) if not
                                            torch.is_tensor(sd[key]) else
                                            sd[key]).to(st[k])
                    found = True
            if not found:
                continue
            have = self._accumulators.get(id(p))
            if have is None:
                self._accumulators[id(p)] = st
            else:
                for k, v in st.items():
                    have[k].copy_(v)

    set_dict = set_state_dict
