"""ParallelTrainer on one device (counterpart of
``paddle_tpu/parallel/engine.py``).

``step(*batch)`` runs forward and loss under the strategy's AMP policy
(bf16 O1, or O2 with ``amp_configs['use_pure_fp16']``; parameters stay
f32 as master weights, as the reference's ``_forward_loss`` leaves
them), backward, and the optimizer's update at step number
``_step_no + 1``, and returns the loss as a 0-d tensor on the device
without a host sync (the reference's ``step`` is lazy too).
Parameters and the optimizer's state are updated in place, so
``donate`` has nothing to do.  ``step`` puts the model in training
mode, so dropout draws from the device's generator (``core.rng``)
where the reference threads a key into its compiled step;
``eval_step`` runs without dropout.  Outputs may be any structure the
loss takes (BERT's ``(hidden or logits, nsp_logits)``).

``fused_steps=K`` (or ``PADDLE_TPU_FUSED_STEPS``) and ``step_fused``
are the reference's whole-loop compilation (``core.scan_loop``): every
batch array carries a leading K dimension, and one call makes K
optimizer steps and returns their K losses as one device tensor, with
no host sync.  On the card the step (forward, backward, update) is a
CUDA graph captured once per batch signature (``_fused_cache``, as the
reference caches its fused modules): the chunk is uploaded once, and
before each of the K replays row i and the optimizer's scalars of step
i are copied into the graph's static buffers on the stream.  The first
chunk of a signature runs its first step eagerly, as the warm-up before
the capture.  On the CPU the same ``step_fused`` runs K eager steps.
Either way the losses, the update math and the step counters equal K
calls of ``step``.

Everything else the reference adds around the single-device step — a
mesh, the pipeline engine, the NaN guard (under ``fused_steps`` too),
the watchdog, quantized collectives, auto-sharding, lint, profiling
and the cluster and supervisor planes — raises ``NotImplementedError``
when asked for, as does any strategy toggle other than ``amp``.
"""
import contextlib

import numpy as np
import torch
from torch.profiler import record_function

from .. import amp as amp_mod
from ..core import compile_cache, scan_loop

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
        self.fused_steps = scan_loop.resolve_fused_steps(fused_steps)
        if nan_guard and self.fused_steps:
            raise NotImplementedError(
                'ParallelTrainer: nan_guard under fused_steps (the '
                "reference's in-chunk rollback) ports with a later slice "
                'of the compiled step (ROADMAP Queue 1 item 1)')
        asked = [name for name, value in (
            ('mesh', mesh), ('nan_guard', nan_guard), ('lint', lint),
            ('auto_shard', auto_shard), ('hbm_budget_gb', hbm_budget_gb),
            ('calibration', calibration), ('profile', profile),
            ('watchdog', watchdog),
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
        # one captured step per batch signature (private memory pools)
        self._fused_cache = compile_cache.GraphCache(self.device)

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

    def _step(self, *batch):
        """Forward, backward and the optimizer's update of one batch of
        device tensors, with the step's scalars already loaded into the
        optimizer: device work only, so ``step_fused`` captures it.
        Returns the loss (f32, 0-d, on the device)."""
        xs, ys = batch[:self.n_inputs], batch[self.n_inputs:]
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
            self.optimizer._update()
        return loss.detach()

    def step(self, *batch):
        """One training step; returns the step's loss (f32, 0-d, on the
        device; no host sync)."""
        vals = tuple(self._to_device(b) for b in batch)
        t = self._step_no + 1
        self.optimizer._load_step(self.optimizer._scalar_rows(t, 1)[0])
        loss = self._step(*vals)
        self._step_no = self.optimizer._global_step = t
        return loss

    # -- fused K-step chunks (core.scan_loop) --------------------------------
    def fused_chunk_len(self, k=None):
        """The chunk length callers should stage for ``step_fused``:
        ``fused_steps`` (or ``k``) through ``scan_loop.clamp_chunk``,
        which passes it through while the watchdog is not ported."""
        return scan_loop.clamp_chunk(self.fused_steps if k is None else k)

    def step_fused(self, *batch):
        """K optimizer steps in one call: every array in ``batch``
        carries a leading K dim (stage with ``scan_loop.stack_batches``,
        sized by ``fused_chunk_len``).  Returns the K per-step losses as
        one f32 device tensor, with no host sync.  Losses, update math
        and step counters equal K calls of ``step``."""
        stacked = tuple(self._to_device(b) for b in batch)
        k = int(stacked[0].shape[0]) if stacked[0].dim() else 0
        if k < 1 or any(v.dim() == 0 or v.shape[0] != k for v in stacked):
            raise ValueError(
                'step_fused: every batch array needs the same leading K '
                f'dim >= 1, got shapes {[tuple(v.shape) for v in stacked]}')
        opt = self.optimizer
        rows = self._to_device(opt._scalar_rows(self._step_no + 1, k))
        step_fn = self._fused_cache.module(
            tuple((tuple(v.shape[1:]), v.dtype) for v in stacked),
            self._step)
        losses = scan_loop.fused_trainer_step(
            step_fn, lambda i: opt._load_step(rows[i]))(*stacked)
        self._step_no = opt._global_step = self._step_no + k
        return losses

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
