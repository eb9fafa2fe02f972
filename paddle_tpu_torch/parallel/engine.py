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

The optimizer's learning rate is read at the trainer's step indexing:
a scheduler's ``value_at(t)`` at the 1-based optimizer step ``t``, never
its ``last_epoch`` (``optimizer.Optimizer``), and its ``grad_clip`` runs
through ``clip_values``.

``nan_guard=True`` is the reference's device-side skip
(``resilience``): the step forms ``finite_step(loss, grads)`` on the
device, every write of the update (parameters, optimizer state, float
buffers) selects the new value only where it is set, and only the flag
crosses to the host, where ``trainer.sentinel`` (a ``NanSentinel`` with
``nan_patience`` and ``nan_max_rollbacks``) keeps its policy.
``_step_no`` advances by the finite steps only.  The eager ``step``
reads the flag back once a step.  Under ``step_fused`` the step counter
lives on the device: the chunk uploads the scalars of steps ``t0 ..
t0 + K - 1`` as a table, each replay copies the row of its counter and
advances the counter by its flag (``scan_loop.cond_carry``), so a step
after a skipped one runs at the count without it, and the chunk reads
back one thing, its K-step mask (``scan_loop.chunk_sync``).  A rollback
the sentinel asks for finds no checkpoint (``save_checkpoint`` is not
ported), so it warns and training goes on with the skipped updates, as
the reference does without a checkpoint directory.

Everything else the reference adds around the single-device step — a
mesh, the pipeline engine, checkpointing, the watchdog, quantized
collectives, auto-sharding, lint, profiling and the cluster and
supervisor planes — raises ``NotImplementedError`` when asked for, as
does any strategy toggle other than ``amp``.
"""
import contextlib
import warnings

import numpy as np
import torch
from torch.profiler import record_function

from .. import amp as amp_mod
from ..core import compile_cache, scan_loop
from ..resilience import NanSentinel, finite_step, guard_update

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
        del donate
        self.fused_steps = scan_loop.resolve_fused_steps(fused_steps)
        asked = [name for name, value in (
            ('mesh', mesh), ('lint', lint),
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
        # step_fused's rows, monotone (_step_no skips under nan_guard)
        self._fused_rows = 0
        # one captured step per batch signature (private memory pools)
        self._fused_cache = compile_cache.GraphCache(self.device)
        self.nan_guard = bool(nan_guard)
        self.sentinel = NanSentinel(
            patience=nan_patience, max_rollbacks=nan_max_rollbacks) \
            if nan_guard else None
        # a guarded chunk's finite steps so far, [1] long on the device
        self._chunk_pos = None
        self.chunk_syncs = 0    # host reads of guarded chunks

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

    def _step(self, *batch, guard=False):
        """Forward, backward and the optimizer's update of one batch of
        device tensors, with the step's scalars already loaded into the
        optimizer: device work only, so ``step_fused`` captures it.
        Returns the loss (f32, 0-d, on the device), and with ``guard``
        ``(loss, ok)``: the update and the model's float buffers kept
        only where ``ok``, the step's finite flag, is set."""
        xs, ys = batch[:self.n_inputs], batch[self.n_inputs:]
        self.model.train()
        self.optimizer.clear_grad()
        if guard:
            bufs = [b for b in self.model.buffers() if b.is_floating_point()]
            old = [b.detach().clone() for b in bufs]
        # the ranges name the step's phases in a torch.profiler trace
        with record_function('ParallelTrainer.forward'), self._autocast():
            # the loss runs under the forward's policy, as in the
            # reference: black-listed loss ops promote to f32
            loss = self.loss_fn(self.model(*xs), *ys)
            loss = loss.float().mean()
        with record_function('ParallelTrainer.backward'):
            loss.backward()
        loss = loss.detach()
        opt = self.optimizer
        if not guard:
            with record_function('ParallelTrainer.optimizer'):
                opt._update()
            return loss
        with record_function('ParallelTrainer.optimizer'), torch.no_grad():
            ok = finite_step(loss, [p.grad for p in opt._params
                                    if p.grad is not None])
            opt._guard = ok
            try:
                opt._update()
            finally:
                opt._guard = None
            for b, v in zip(bufs, guard_update(ok, bufs, old)):
                b.copy_(v)
        return loss, ok

    def _guarded_step_at(self, table, *batch):
        """``step_fused``'s guarded step: the scalars of row ``pos`` of
        the chunk's ``table``, ``pos`` advanced by the step's flag, all
        on the device."""
        pos = self._chunk_pos
        self.optimizer._load_step_at(table, pos)
        loss, ok = self._step(*batch, guard=True)
        pos.copy_(scan_loop.cond_carry(ok, [pos + 1], [pos])[0])
        return loss, ok

    def step(self, *batch):
        """One training step; returns the step's loss (f32, 0-d, on the
        device; no host sync, except the finite flag under
        ``nan_guard``)."""
        vals = tuple(self._to_device(b) for b in batch)
        opt = self.optimizer
        t = self._step_no + 1
        opt._load_step(opt._scalar_rows(t, 1)[0])
        opt._t = t
        if not self.nan_guard:
            loss = self._step(*vals)
            self._step_no = opt._global_step = t
            return loss
        loss, ok = self._step(*vals, guard=True)
        ok = bool(ok)       # the one host read a guarded step costs
        if ok:
            self._step_no = opt._global_step = t
        if self.sentinel.observe(finite=ok) == 'rollback':
            self._nan_rollback()
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
        one f32 device tensor, with no host sync (under ``nan_guard`` one:
        the chunk's finite mask).  Losses, update math and step counters
        equal K calls of ``step``."""
        stacked = tuple(self._to_device(b) for b in batch)
        k = int(stacked[0].shape[0]) if stacked[0].dim() else 0
        if k < 1 or any(v.dim() == 0 or v.shape[0] != k for v in stacked):
            raise ValueError(
                'step_fused: every batch array needs the same leading K '
                f'dim >= 1, got shapes {[tuple(v.shape) for v in stacked]}')
        opt = self.optimizer
        rows = self._to_device(opt._scalar_rows(self._step_no + 1, k))
        sig = tuple((tuple(v.shape[1:]), v.dtype) for v in stacked)
        opt._t = None           # the step's number: rows, not the host
        self._fused_rows += k
        if not self.nan_guard:
            step_fn = self._fused_cache.module(sig, self._step)
            losses = scan_loop.fused_trainer_step(
                step_fn, lambda i: opt._load_step(rows[i]))(*stacked)
            self._step_no = opt._global_step = self._step_no + k
            return losses
        if self._chunk_pos is None:
            self._chunk_pos = torch.zeros(1, dtype=torch.long,
                                          device=self.device)
        self._chunk_pos.zero_()
        step_fn = self._fused_cache.module(
            ('nan_guard', tuple(rows.shape)) + sig, self._guarded_step_at)
        losses, oks = scan_loop.fused_trainer_step(
            lambda *row: step_fn(rows, *row), None, nan_guard=True)(*stacked)
        mask = scan_loop.chunk_sync(oks)
        self.chunk_syncs += 1
        self._step_no = opt._global_step = self._step_no + int(mask.sum())
        for ok in mask:
            if self.sentinel.observe(finite=bool(ok)) == 'rollback':
                self._nan_rollback()
                break
        return losses

    def _nan_rollback(self):
        """The sentinel asked for a rollback.  The port has no
        checkpoint to restore (``save_checkpoint``), so, as the reference
        does without a checkpoint directory, it warns and training goes
        on: the device-side skip kept the parameters finite.  Returns
        False."""
        warnings.warn(
            'NanSentinel requested a rollback but there is no checkpoint '
            'to restore (save_checkpoint is not ported yet); continuing '
            'with skipped updates', RuntimeWarning, stacklevel=3)
        return False

    def save_checkpoint(self, directory, keep=3, async_save=True):
        raise NotImplementedError(
            "ParallelTrainer.save_checkpoint sits on the reference's "
            'orbax distributed/checkpoint.py, which is not ported yet '
            '(ROADMAP Queue 1 item 9)')

    def restore_checkpoint(self, directory, step=None):
        raise NotImplementedError(
            "ParallelTrainer.restore_checkpoint sits on the reference's "
            'orbax distributed/checkpoint.py, which is not ported yet '
            '(ROADMAP Queue 1 item 9)')

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
