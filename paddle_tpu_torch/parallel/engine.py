"""ParallelTrainer on one device (counterpart of
``paddle_tpu/parallel/engine.py``).

``step(*batch)`` runs forward and loss under the strategy's AMP policy
(bf16 O1, or O2 with ``amp_configs['use_pure_fp16']``; parameters stay
f32 as master weights, as the reference's ``_forward_loss`` leaves
them), backward, and the optimizer's update at step number
``_step_no + 1``, and returns the loss as a 0-d tensor on the device
without a host sync (the reference's ``step`` is lazy too).  The port
runs eagerly: there is no compiled step, parameters are updated in
place, and ``donate`` has nothing to do.  ``step`` puts the model in
training mode, so dropout draws from the device's generator
(``core.rng``) where the reference threads a key into its compiled
step; ``eval_step`` runs without dropout.  Outputs may be any
structure the loss takes (BERT's ``(hidden or logits, nsp_logits)``).

Everything the reference adds around the single-device step — a mesh,
the pipeline engine, fused K-step loops, the NaN guard, the watchdog,
quantized collectives, auto-sharding, lint, profiling and the cluster
and supervisor planes — raises ``NotImplementedError`` when asked for,
as does any strategy toggle other than ``amp``.
"""
import contextlib

import numpy as np
import torch
from torch.profiler import record_function

from .. import amp as amp_mod

__all__ = ['ParallelTrainer']

# toggles that mean nothing on one device (the reference keeps them for
# parity too)
_PARITY_TOGGLES = ('amp', 'fuse_all_reduce_ops')


class ParallelTrainer:
    """Model + optimizer + loss on one device.

    ``loss_fn(outputs, *labels) -> scalar tensor``; ``batch[:n_inputs]``
    feed the model, the rest the loss."""

    def __init__(self, model, optimizer, loss_fn, mesh=None, strategy=None,
                 donate=True, n_inputs=1, nan_guard=False, nan_patience=3,
                 nan_max_rollbacks=2, lint=None, auto_shard=False,
                 hbm_budget_gb=None, calibration=None, profile=None,
                 watchdog=None, fused_steps=None, quant_collectives=None,
                 cluster_stats=None, supervisor=None):
        del donate, nan_patience, nan_max_rollbacks
        asked = [name for name, value in (
            ('mesh', mesh), ('nan_guard', nan_guard), ('lint', lint),
            ('auto_shard', auto_shard), ('hbm_budget_gb', hbm_budget_gb),
            ('calibration', calibration), ('profile', profile),
            ('watchdog', watchdog), ('fused_steps', fused_steps),
            ('quant_collectives', quant_collectives),
            ('cluster_stats', cluster_stats),
            ('supervisor', supervisor)) if value]
        if asked:
            raise NotImplementedError(
                f'ParallelTrainer: {", ".join(asked)} not ported yet; the '
                'port trains on one device')
        self.strategy = strategy or getattr(optimizer, '_fleet_strategy',
                                            None)
        if self.strategy is not None:
            extra = [t for t in self.strategy.enabled_toggles()
                     if t not in _PARITY_TOGGLES]
            if extra:
                raise NotImplementedError(
                    f'DistributedStrategy toggles {extra} are not ported '
                    'yet; the port honours amp only')
        self.model = model
        self.optimizer = optimizer
        self.loss_fn = loss_fn
        self.n_inputs = n_inputs
        self.device = next(model.parameters()).device
        # AdamW's apply_decay_param_fun sees the parameter names
        optimizer._param_names.update(
            {id(p): n for n, p in model.named_parameters()})
        self._step_no = 0

    def _autocast(self):
        st = self.strategy
        if not (st and st.amp):
            return contextlib.nullcontext()
        return amp_mod.auto_cast(
            level='O2' if st.amp_configs.get('use_pure_fp16') else 'O1')

    def _to_device(self, value):
        """A batch entry (numpy or tensor) on the model's device; a host
        array is staged through pinned memory so the copy does not wait
        for the queued step."""
        if isinstance(value, np.ndarray):
            value = torch.from_numpy(np.ascontiguousarray(value))
        elif not torch.is_tensor(value):
            value = torch.as_tensor(value)
        if value.device == self.device:
            return value
        if self.device.type == 'cuda' and value.device.type == 'cpu':
            return value.pin_memory().to(self.device, non_blocking=True)
        return value.to(self.device)

    def _split(self, batch):
        vals = [self._to_device(b) for b in batch]
        return vals[:self.n_inputs], vals[self.n_inputs:]

    def step(self, *batch):
        """One training step; returns the step's loss (f32, 0-d, on the
        device; no host sync)."""
        xs, ys = self._split(batch)
        self.model.train()
        self.optimizer.clear_grad()
        # the ranges name the step's phases in a torch.profiler trace
        with record_function('ParallelTrainer.forward'), self._autocast():
            # the loss runs under the forward's policy, as in the
            # reference: black-listed loss ops promote to f32
            loss = self.loss_fn(self.model(*xs), *ys)
            loss = loss.float().mean()
        with record_function('ParallelTrainer.backward'):
            loss.backward()
        with record_function('ParallelTrainer.optimizer'):
            self.optimizer._apply(self._step_no + 1)
        self._step_no += 1
        return loss.detach()

    @torch.no_grad()
    def eval_step(self, *batch):
        """Forward and loss in eval mode, no AMP (as the reference):
        ``(outputs, loss)``."""
        xs, ys = self._split(batch)
        self.model.eval()
        out = self.model(*xs)
        return out, self.loss_fn(out, *ys).float().mean()

    def loss_float(self, loss):
        return float(loss)
