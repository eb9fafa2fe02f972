"""ParallelTrainer, one process a card, over a data- and
tensor-parallel mesh of such processes (counterpart of
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
the sentinel asks for restores the last committed checkpoint of
``save_checkpoint``'s directory (after dumping the flight recorder
beside it and waiting for an in-flight save), and without one it warns
and training goes on with the skipped updates, as the reference does.

``train_state()`` is the reference's resumable state, ``{'params',
'buffers', 'opt_state', 'step'}`` (plus ``'lr_scheduler'``, the
scheduler's ``last_epoch``/``last_lr``, when the learning rate is one),
as live tensors.  ``save_checkpoint`` hands it to a
``distributed.checkpoint.CheckpointManager``: the save stages every
tensor into pinned host memory on a side stream, and the next step's
stream waits on that copy's event before it writes anything (a device
wait), so a save never reads a mix of two steps.
``restore_checkpoint`` reads a committed step to the host and copies it
into the live parameters, buffers and optimizer slots through
``convert.load_train_state`` (``copy_``: a captured ``step_fused``
graph reads those addresses), and sets the step counters.

``watchdog=`` (True, a dict, a ``resilience.Budget``, or the
``PADDLE_TPU_WATCHDOG`` env) arms ``resilience.Watchdog``: its
deadline covers each eager step's dispatch and, under ``nan_guard``,
the flag's read, and each fused chunk's dispatch (K steps' budget) and
mask read, as the reference's.  ``fused_chunk_len`` passes the budget to
``scan_loop.clamp_chunk``; without a step-time estimate (the planner,
ROADMAP item 11) K passes through.

The strategy (``strategy=``, or the one ``fleet.distributed_optimizer``
put on the optimizer) is checked by ``fleet.validate_strategy`` and
read as the reference's single-device trainer reads it:

- ``amp``: the forward and the loss under ``amp.auto_cast`` (O1, or O2
  with ``amp_configs['use_pure_fp16']``);
- ``recompute``: the model's whole forward (not the loss) runs through
  ``core.recompute.checkpoint``, as the reference wraps it in
  ``jax.checkpoint``: its activations are recomputed in the backward,
  under the forward's AMP policy and dropout masks and without a second
  write of any buffer, eagerly, under ``nan_guard`` and inside
  ``step_fused``'s graph (``recompute_configs`` unread, as there);
- ``gradient_merge``: ``gradient_merge_configs['k_steps']`` = k
  micro-batches in one step, as the reference's scan: batch dim 0 is
  cut into k slices (it must divide), ``clear_grad`` once, k forward
  and backward passes accumulating into ``.grad`` (the buffers move k
  times), the gradients divided by k (whatever ``avg`` says, as
  there), one update, and the mean of the k losses returned; under
  ``nan_guard`` the merged gradients and that mean decide the step;
- ``pipeline`` warns (there is no ``pp`` axis), and the toggles that
  need a mesh (``sharding`` at stages 0-2, ``tensor_parallel``,
  ``sequence_parallel``, ``localsgd``) change nothing at ``dp`` 1, as
  in the reference; ZeRO ``sharding`` over ``dp`` above 1 raises
  (ROADMAP item 9d), as does DGC over tensor-parallel shards.

In a world of several processes (``fleet.init`` or
``init_parallel_env`` first; without a mesh the trainer lays ``{'dp':
world}`` over the ranks) the contract is the reference's mesh step:
the ``dp`` replicas start from ``dp`` rank 0's parameters and buffers
(broadcast when the trainer is built, as DDP does); every rank calls
``step(*batch)`` with the same global batch and uploads only its ``dp``
rows, the contiguous ``P('dp')`` slice of each
batch array (under ``gradient_merge``, micro-batch ``i`` is global rows
``[iB/k, (i+1)B/k)`` and then its ``dp`` slice, the reference's reshape
order).  The forward, loss and backward run under
``collective.axis_scope`` of the mesh's axes (``BatchNorm``'s
statistics and BERT's masked mean span the global batch there); the
model's tensor-parallel layers keep their gradients local; every
gradient is then summed over ``dp`` in flat buckets and divided by the
``dp`` size (``distributed.parallel.allreduce_gradients``), and the
loss returned is the ranks' mean, the global loss of a loss that is a
mean over rows.  A loss that sums its rows gets the ranks' mean of the
local sums (DDP's convention; the reference's would be the global
sum).  Under ``nan_guard`` the finite flag is reduced with MIN over the
world, so every rank skips the same step.  ``step_fused`` on the card
captures the NCCL collectives in its graph (its first, eager step
warms the communicator up); on a gloo group with the model on the card
it raises, since gloo's collectives go through host memory.
Checkpoints at a world above 1 raise (ROADMAP item 9b's second part).

``profile=`` (True, a spec string or dict, a ``ProfileSchedule``; None
defers to ``PADDLE_TPU_PROFILE``) arms ``telemetry.step_profiler``
over the step loop: each ``step`` (each ``step_fused`` chunk, as a
span of K steps) is observed, a window's ``torch.profiler`` trace is
parsed into its ``profile_capture`` event, and ``finish_profile``
closes an open window and returns the windows; a profiler failure never
fails a step.  ``op_summary(*batch)`` is ``profiler.op_summary`` of one
training step traced on fake tensors: nothing runs, no kernel launches,
no parameter, slot, buffer or generator moves.

Everything else the reference adds around the step — the pipeline
engine and quantized collectives (item 9d), auto-sharding and lint
(item 11), the cluster and supervisor planes (item 10) — raises
``NotImplementedError`` when asked for.
"""
import contextlib
import os
import warnings

import numpy as np
import torch
from torch.profiler import record_function

from .. import amp as amp_mod
from ..core import compile_cache, recompute, scan_loop
from ..distributed import collective
from ..distributed import env as _env
from ..resilience import NanSentinel, finite_step, guard_update

__all__ = ['ParallelTrainer']


class ParallelTrainer:
    """Model + optimizer + loss on this rank's device (module
    docstring).

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
        for item, names in (
                ('ROADMAP item 9d', (('quant_collectives',
                                      quant_collectives),)),
                ('ROADMAP item 10', (('cluster_stats', cluster_stats),
                                     ('supervisor', supervisor))),
                ('ROADMAP item 11', (('lint', lint),
                                     ('auto_shard', auto_shard),
                                     ('hbm_budget_gb', hbm_budget_gb),
                                     ('calibration', calibration)))):
            asked = [name for name, value in names if value]
            if asked:
                raise NotImplementedError(
                    f'ParallelTrainer: {", ".join(asked)} not ported yet '
                    f'({item})')
        self.mesh = self._resolve_mesh(mesh)
        self._dp = self.mesh.axis_size('dp') if self.mesh else 1
        self._dp_rank = self.mesh.coords.get('dp', 0) if self.mesh else 0
        self._dp_group = self.mesh.group('dp') if self._dp > 1 else None
        self._world = collective.get_group(0)
        self.strategy = strategy or getattr(optimizer, '_fleet_strategy',
                                            None)
        self._merge_k = 1
        if self.strategy is not None:
            self._merge_k = self._check_strategy(self.strategy, self.mesh,
                                                 optimizer)
        self.model = model
        self.optimizer = optimizer
        self.loss_fn = loss_fn
        self.n_inputs = n_inputs
        self.device = next(model.parameters()).device
        if self._dp_group is not None:
            # the dp replicas start from dp rank 0's state, as DDP's do
            with torch.no_grad():
                for t in list(model.parameters()) + list(model.buffers()):
                    collective.broadcast(t.data, 0, self._dp_group)
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
        # watchdog: None -> the PADDLE_TPU_WATCHDOG env decides
        # (default off); latched on first use
        self.watchdog = watchdog
        self._watchdog = None
        self._watchdog_init = False
        self._stepped = False   # the first step's budget is wider
        self._ckpt_mgr = None
        # the last save's staging copy: the next step waits on it
        self._save_fence = None
        # profile: None -> the PADDLE_TPU_PROFILE env decides; latched
        # on first use
        self.profile = profile
        self._profiler = None
        self._profiler_init = False
        self._profile_calls = -1

    @staticmethod
    def _resolve_mesh(mesh):
        """The mesh the step runs over: ``mesh``, the global one, or
        ``{'dp': world}`` where a process group of several ranks is up
        and none is installed.  A world of several processes without its
        process group raises."""
        mesh = mesh or _env.get_mesh()
        if mesh is not None and not isinstance(mesh, _env.Mesh):
            raise TypeError(f'mesh must be a distributed.env.Mesh '
                            f'(distributed.build_mesh), got {mesh!r}')
        if mesh is not None or _env.get_world_size() <= 1:
            return mesh
        if _env._dist() is None:
            raise RuntimeError(
                f'ParallelTrainer in a world of {_env.get_world_size()} '
                'processes needs the process group: call fleet.init or '
                'distributed.init_parallel_env first')
        from ..distributed.parallel import init_parallel_env
        init_parallel_env()
        return _env.get_mesh()

    @staticmethod
    def _check_strategy(st, mesh=None, optimizer=None):
        """``fleet.validate_strategy``, the reference's warning for
        ``pipeline`` without a ``pp`` axis, the refusal of what the port
        does not run over a mesh yet (items 9b, 9c, 9d); returns the
        merge's k."""
        from ..distributed.fleet.fleet_base import (_degrees, check_degrees,
                                                    validate_strategy)
        validate_strategy(st)
        if mesh is not None:
            check_degrees(dict(mesh.shape))
        else:
            degrees = _degrees(st, _env.get_world_size())
            check_degrees(degrees)
            wide = {k: v for k, v in degrees.items() if v > 1}
            if wide:
                raise ValueError(
                    f'strategy degrees {wide} need a mesh of '
                    f'{int(np.prod(list(wide.values())))} ranks; this '
                    f'world has {_env.get_world_size()}: call fleet.init')
        dp = mesh.axis_size('dp') if mesh is not None else 1
        tp = mesh.axis_size('tp') if mesh is not None else 1
        if st.sharding and dp > 1:
            raise NotImplementedError(
                f'ZeRO sharding over dp {dp}: {_env.ITEM_9D}')
        from ..optimizer import DGCMomentum
        if tp > 1 and isinstance(optimizer, DGCMomentum):
            raise NotImplementedError(
                f'DGC over tensor-parallel shards (tp {tp}): '
                f'{_env.ITEM_9B}')
        if st.pipeline:
            warnings.warn(
                'strategy.pipeline=True but the mesh has no pp axis '
                '(>1); running without pipeline parallelism. Set '
                'hybrid_configs.pp_degree before fleet.init.',
                UserWarning, stacklevel=3)
        if not st.gradient_merge:
            return 1
        return int(st.gradient_merge_configs.get('k_steps', 1) or 1)

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
        vals = [self._to_device(self._local_rows(b)) for b in batch]
        return vals[:self.n_inputs], vals[self.n_inputs:]

    def _local_rows(self, value, dim=0):
        """This rank's ``dp`` rows of a global batch array along ``dim``
        (module docstring: under ``gradient_merge`` the k micro-batches'
        slices, in order); the array itself at ``dp`` 1 or 0-d."""
        dp = self._dp
        if dp == 1 or getattr(value, 'ndim', 0) <= dim:
            return value
        n, k = value.shape[dim], self._merge_k
        if n % (k * dp):
            raise ValueError(
                f'a global batch of {n} rows does not split into '
                f'{k} micro-batch(es) over dp {dp}')
        m, r = n // (k * dp), self._dp_rank
        if k == 1:
            idx = slice(r * m, (r + 1) * m)
            return value[(slice(None),) * dim + (idx,)]
        rows = np.concatenate([np.arange(i * n // k + r * m,
                                         i * n // k + (r + 1) * m)
                               for i in range(k)])
        if torch.is_tensor(value):
            return value.index_select(
                dim, torch.as_tensor(rows, device=value.device))
        return np.take(np.asarray(value), rows, axis=dim)

    def _scope(self):
        """The mesh's axes for ``collective.axis_scope`` around the
        forward and backward (nothing without a mesh)."""
        if self.mesh is None:
            return contextlib.nullcontext()
        return collective.axis_scope(*self.mesh.axis_names)

    def _sync(self, loss):
        """Sum the gradients over ``dp`` and divide by its size, and
        return the ranks' mean of ``loss`` (the loss itself at ``dp``
        1)."""
        if self._dp_group is None:
            return loss
        from ..distributed.parallel import allreduce_gradients
        with record_function('ParallelTrainer.allreduce'):
            allreduce_gradients(self.optimizer._params, self._dp_group,
                                scale=1.0 / self._dp)
            total = collective.all_reduce(loss.clone(), group=self._dp_group)
        return total / self._dp

    def _forward_backward(self, batch):
        """One forward (the model under ``strategy.recompute`` through
        ``core.recompute``) and backward of ``batch``, its gradients
        added into ``.grad``; returns the loss, f32, 0-d, detached."""
        xs, ys = batch[:self.n_inputs], batch[self.n_inputs:]
        # the ranges name the step's phases in a torch.profiler trace
        with record_function('ParallelTrainer.forward'), self._autocast(), \
                self._scope():
            if self.strategy is not None and self.strategy.recompute:
                out = recompute.checkpoint(self.model, *xs)
            else:
                out = self.model(*xs)
            # the loss runs under the forward's policy, as in the
            # reference: black-listed loss ops promote to f32
            loss = self.loss_fn(out, *ys).float().mean()
        with record_function('ParallelTrainer.backward'), self._scope():
            loss.backward()
        return loss.detach()

    def _micro_batches(self, batch):
        """``strategy.gradient_merge``'s k slices of every batch array
        along dim 0 (which must divide by k, as the reference's reshape
        demands)."""
        k = self._merge_k
        for v in batch:
            if v.dim() == 0 or v.shape[0] % k:
                size = v.numel()
                shape = (k, v.shape[0] // k if v.dim() else 0) + \
                    tuple(v.shape[1:])
                raise TypeError(
                    f'cannot reshape array of shape {tuple(v.shape)} '
                    f'(size {size}) into shape {shape} (size '
                    f'{int(np.prod(shape))}): gradient_merge k_steps={k} '
                    'must divide the batch')
        return [[v.narrow(0, i * (v.shape[0] // k), v.shape[0] // k)
                 for v in batch] for i in range(k)]

    def _step(self, *batch, guard=False):
        """Forward, backward and the optimizer's update of one batch of
        device tensors, with the step's scalars already loaded into the
        optimizer: device work only, so ``step_fused`` captures it.
        Under ``gradient_merge`` the k micro-batches' passes accumulate
        into ``.grad``, divided by k before the update.  Returns the
        loss (f32, 0-d, on the device; the micro-losses' mean), and with
        ``guard`` ``(loss, ok)``: the update and the model's float
        buffers kept only where ``ok``, the step's finite flag, is
        set."""
        self.model.train()
        self.optimizer.clear_grad()
        if guard:
            bufs = [b for b in self.model.buffers() if b.is_floating_point()]
            old = [b.detach().clone() for b in bufs]
        k = self._merge_k
        if k == 1:
            loss = self._forward_backward(batch)
        else:
            losses = [self._forward_backward(mb)
                      for mb in self._micro_batches(batch)]
            loss = torch.stack(losses).mean()
            with torch.no_grad():
                for p in self.optimizer._params:
                    if p.grad is not None:
                        p.grad.div_(k)
        loss = self._sync(loss)
        opt = self.optimizer
        if not guard:
            with record_function('ParallelTrainer.optimizer'):
                opt._update()
            return loss
        with record_function('ParallelTrainer.optimizer'), torch.no_grad():
            ok = finite_step(loss, [p.grad for p in opt._params
                                    if p.grad is not None])
            if not collective._local(self._world):
                flag = collective.all_reduce(
                    ok.to(torch.float32), collective.ReduceOp.MIN,
                    self._world)
                ok = flag > 0
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

    def _await_save(self):
        """Make the current stream wait for the last save's staging copy
        (a device wait) before this step writes parameters or state."""
        fence, self._save_fence = self._save_fence, None
        if fence is not None:
            torch.cuda.current_stream(self.device).wait_event(fence)

    def step(self, *batch):
        """One training step; returns the step's loss (f32, 0-d, on the
        device; no host sync, except the finite flag under
        ``nan_guard``)."""
        vals = tuple(self._to_device(self._local_rows(b)) for b in batch)
        self._await_save()
        opt = self.optimizer
        t = self._step_no + 1
        wd = self._ensure_watchdog()
        if wd is not None:
            # the deadline covers dispatch + (nan path) the flag's read
            wd.step_started(t, first=not self._stepped)
        try:
            opt._load_step(opt._scalar_rows(t, 1)[0])
            opt._t = t
            if self.nan_guard:
                loss, ok = self._step(*vals, guard=True)
                ok = bool(ok)   # the one host read a guarded step costs
            else:
                loss = self._step(*vals)
        finally:
            if wd is not None:
                wd.step_finished(t)
        self._stepped = True
        self._observe_profile(loss)
        if not self.nan_guard:
            self._step_no = opt._global_step = t
            return loss
        if ok:
            self._step_no = opt._global_step = t
        if self.sentinel.observe(finite=ok) == 'rollback':
            self._nan_rollback()
        return loss

    # -- fused K-step chunks (core.scan_loop) --------------------------------
    def fused_chunk_len(self, k=None):
        """The chunk length callers should stage for ``step_fused``:
        ``fused_steps`` (or ``k``) clamped against the armed watchdog's
        step budget by ``scan_loop.clamp_chunk``, given a per-step
        estimate; the port has none until the planner (ROADMAP item 11),
        so K passes through."""
        wd = self._ensure_watchdog()
        budget = wd.budget if wd is not None else None
        return scan_loop.clamp_chunk(self.fused_steps if k is None else k,
                                     budget, None)

    def step_fused(self, *batch):
        """K optimizer steps in one call: every array in ``batch``
        carries a leading K dim (stage with ``scan_loop.stack_batches``,
        sized by ``fused_chunk_len``).  Returns the K per-step losses as
        one f32 device tensor, with no host sync (under ``nan_guard`` one:
        the chunk's finite mask).  Losses, update math and step counters
        equal K calls of ``step``."""
        self._check_capturable()
        stacked = tuple(self._to_device(self._local_rows(b, dim=1))
                        for b in batch)
        k = int(stacked[0].shape[0]) if stacked[0].dim() else 0
        if k < 1 or any(v.dim() == 0 or v.shape[0] != k for v in stacked):
            raise ValueError(
                'step_fused: every batch array needs the same leading K '
                f'dim >= 1, got shapes {[tuple(v.shape) for v in stacked]}')
        self._await_save()
        opt = self.optimizer
        rows = self._to_device(opt._scalar_rows(self._step_no + 1, k))
        sig = tuple((tuple(v.shape[1:]), v.dtype) for v in stacked)
        key = sig if not self.nan_guard else \
            ('nan_guard', tuple(rows.shape)) + sig
        first_call = key not in self._fused_cache.modules
        opt._t = None           # the step's number: rows, not the host
        self._fused_rows += k
        wd = self._ensure_watchdog()
        if wd is not None:
            # the budget covers the whole K-step chunk (the capture
            # rides the first chunk's first step)
            b = wd.budget
            per = b.effective_step_s()
            head = b.effective_first_step_s() if first_call else per
            wd.step_started(self._step_no + k, budget_s=head + (k - 1) * per,
                            first=first_call)
        try:
            if not self.nan_guard:
                step_fn = self._fused_cache.module(key, self._step)
                losses = scan_loop.fused_trainer_step(
                    step_fn, lambda i: opt._load_step(rows[i]))(*stacked)
            else:
                if self._chunk_pos is None:
                    self._chunk_pos = torch.zeros(1, dtype=torch.long,
                                                  device=self.device)
                self._chunk_pos.zero_()
                step_fn = self._fused_cache.module(key,
                                                   self._guarded_step_at)
                losses, oks = scan_loop.fused_trainer_step(
                    lambda *row: step_fn(rows, *row), None,
                    nan_guard=True)(*stacked)
                mask = scan_loop.chunk_sync(oks)
        finally:
            if wd is not None:
                wd.step_finished(self._step_no + k)
        self._stepped = True
        self._observe_profile(losses, span=k)
        if not self.nan_guard:
            self._step_no = opt._global_step = self._step_no + k
            return losses
        self.chunk_syncs += 1
        self._step_no = opt._global_step = self._step_no + int(mask.sum())
        for ok in mask:
            if self.sentinel.observe(finite=bool(ok)) == 'rollback':
                self._nan_rollback()
                break
        return losses

    def _check_capturable(self):
        """A captured step cannot run a collective that goes through host
        memory (gloo with the model on the card): refuse before any
        step runs."""
        if self.device.type != 'cuda' or self.mesh is None or \
                self.mesh.size == 1:
            return
        if collective.staged_through_host(self._world):
            raise RuntimeError(
                'step_fused captures the step in a CUDA graph, and this '
                'world\'s collectives run over gloo through host memory: '
                'use NCCL (PADDLE_DISTRI_BACKEND=nccl) or call step')

    def _one_world(self, what):
        if self.mesh is not None and self.mesh.size > 1:
            raise NotImplementedError(
                f'{what} in a world of {self.mesh.size}: {_env.ITEM_9B}')

    def _nan_rollback(self):
        """Sentinel-demanded rollback: reload the last COMMITTED
        checkpoint of the save_checkpoint directory.  Without one there
        is nothing to restore — the device-side skip already kept the
        parameters finite, so training simply continues (and the
        sentinel escalates to FloatingPointError if the NaNs persist
        across rollback budgets).  Returns whether it restored."""
        from ..telemetry import dump_flight
        mgr = self._ckpt_mgr
        if mgr is None:
            warnings.warn(
                'NanSentinel requested a rollback but no checkpoint '
                'directory is configured (call save_checkpoint '
                'periodically); continuing with skipped updates',
                RuntimeWarning, stacklevel=3)
            return False
        # durable post-mortem next to the checkpoint we are about to
        # restore: the flight ring holds the nan_skip strikes and the
        # nan_rollback event that led here
        dump_flight(os.path.join(mgr.directory,
                                 f'flightrec-{self._step_no}.json'))
        mgr.wait()   # the in-flight save must commit before we read
        got = self.restore_checkpoint(mgr.directory)
        if got < 0:
            warnings.warn(
                'NanSentinel rollback found no committed checkpoint '
                f'under {mgr.directory}; continuing with skipped '
                'updates', RuntimeWarning, stacklevel=3)
            return False
        return True

    # -- the sampled profiler (telemetry.profile) ----------------------------
    def _ensure_profiler(self):
        """Latch the sampled step profiler on first use; None when
        profiling is off (the per-step cost is then one attribute
        read), or when arming it failed: profiling never kills a
        step."""
        if not self._profiler_init:
            self._profiler_init = True
            try:
                from ..telemetry import step_profiler
                self._profiler = step_profiler(self.profile,
                                               name='parallel')
            except Exception:   # profiling must never kill a step
                self._profiler = None
        return self._profiler

    def _observe_profile(self, sync, span=1):
        """One step (or a chunk of ``span``) dispatched: its 0-based call
        index to the profiler, which opens or closes a window there."""
        prof = self._ensure_profiler()
        if prof is None:
            return
        n = self._profile_calls + 1
        self._profile_calls = n + span - 1
        prof.observe(n, sync=sync, span=span)

    def finish_profile(self, sync=None):
        """Close the sampled profiler at the end of a step loop: an open
        window is stopped, parsed and emitted (pass the last loss as
        ``sync``).  Returns the windows' summaries (``[]`` when
        profiling is off)."""
        prof = self._profiler
        if prof is None:
            return []
        prof.close(sync=sync)
        return prof.windows

    def op_summary(self, *batch, sorted_by='total', **kwargs):
        """``profiler.op_summary`` of one training step of ``batch`` —
        forward, backward and update, under the strategy — traced on
        fake tensors: nothing runs, no kernel launches, and the
        parameters, their gradients, the optimizer's slots and scalars,
        the buffers and the generators are left as they were.  Returns
        the rows."""
        from ..profiler import op_summary
        vals = tuple(self._to_device(b) for b in batch)
        return op_summary(self._step, *vals, sorted_by=sorted_by,
                          swap=self._fake_state, **kwargs)

    @contextlib.contextmanager
    def _fake_state(self, mode):
        """Fake copies of the state a step writes, in place of the live
        tensors for the block: the model's parameters and buffers, the
        optimizer's parameter list, slots and scalar buffer (and the maps
        keyed by a parameter's id), and the modules' train flags."""
        from torch.nn.utils.stateless import _reparametrize_module
        model, opt = self.model, self.optimizer

        def fake(t):
            return mode.from_tensor(t.detach())

        params = dict(model.named_parameters())
        swap = {n: fake(p).requires_grad_(p.requires_grad)
                for n, p in params.items()}
        swap.update({n: fake(b) for n, b in model.named_buffers()})
        by_id = {id(p): swap[n] for n, p in params.items()}
        saved = dict(opt.__dict__)
        modes = [(m, m.training) for m in model.modules()]
        opt._parameter_list = [by_id.get(id(p), p) for p in opt._params]
        opt._accumulators = {
            id(by_id[pid]): {n: fake(v) if torch.is_tensor(v) else v
                             for n, v in slots.items()}
            for pid, slots in saved['_accumulators'].items()
            if pid in by_id}
        opt._param_names = {id(by_id[k]): v
                            for k, v in saved['_param_names'].items()
                            if k in by_id}
        opt._ctx_names = {id(by_id[k]): v
                          for k, v in saved['_ctx_names'].items()
                          if k in by_id}
        names = opt._scalar_names()
        real = saved.get('_scalar_buf')
        buf = fake(real if real is not None else torch.zeros(
            len(names), dtype=torch.float32, device=self.device))
        opt._scalar_buf = buf
        opt._scalars = {n: buf[i] for i, n in enumerate(names)}
        try:
            with _reparametrize_module(model, swap):
                yield
        finally:
            opt.__dict__.clear()
            opt.__dict__.update(saved)
            for m, training in modes:
                m.training = training

    # -- the watchdog --------------------------------------------------------
    def _ensure_watchdog(self):
        """Latch the straggler/hang watchdog on first use; None when off
        (the default) — the per-step cost is then one attribute read."""
        if self._watchdog_init:
            return self._watchdog
        self._watchdog_init = True
        from ..resilience.watchdog import Watchdog, resolve_watchdog
        budget = resolve_watchdog(self.watchdog)
        if budget is None:
            return None
        mgr = self._ckpt_mgr
        self._watchdog = Watchdog(
            budget=budget, name='parallel',
            flight_dir=mgr.directory if mgr is not None else None).start()
        return self._watchdog

    def stop_watchdog(self):
        """Stop the supervision thread (end of the step loop; tests).
        Final: later steps run unwatched — an explicit stop must not be
        silently undone by the next step re-latching a fresh
        escalation-armed thread.  Assign ``self.watchdog`` and reset
        ``_watchdog_init`` to re-arm deliberately.  No-op when the
        watchdog is off."""
        wd, self._watchdog = self._watchdog, None
        if wd is not None:
            wd.stop()

    # -- checkpointing -------------------------------------------------------
    def train_state(self):
        """The full resumable state as one tree of the live tensors:
        ``{'params', 'buffers', 'opt_state', 'step'}`` as the reference's
        (every parameter's optimizer slots, made now where the first
        update has not made them yet), plus ``'lr_scheduler'``
        (``last_epoch``, ``last_lr``) when the learning rate is a
        scheduler."""
        from ..optimizer.lr import LRScheduler
        opt = self.optimizer
        params = dict(self.model.named_parameters())
        own = self.model.state_dict(keep_vars=True)
        buffers = {n: b for n, b in own.items() if n not in params}
        opt_state = {}
        for name, p in params.items():
            slots = opt._accumulators.get(id(p))
            if slots is None:
                slots = opt._accumulators[id(p)] = opt._create_state(p)
            opt_state[name] = dict(slots)
        state = {'params': params, 'buffers': buffers,
                 'opt_state': opt_state,
                 'step': torch.tensor(self._step_no, dtype=torch.int64)}
        sched = opt._learning_rate
        if isinstance(sched, LRScheduler):
            state['lr_scheduler'] = {'last_epoch': int(sched.last_epoch),
                                     'last_lr': float(sched.last_lr)}
        return state

    def save_checkpoint(self, directory, keep=3, async_save=True):
        """Save the train state as step ``_step_no`` under `directory`
        (async by default; returns the save's handle)."""
        from ..distributed.checkpoint import CheckpointManager
        self._one_world('save_checkpoint')
        mgr = self._ckpt_mgr
        if (mgr is None or mgr.directory != os.path.abspath(directory)
                or mgr.keep != keep or mgr.async_save != async_save):
            if mgr is not None:
                mgr.wait()  # drain in-flight async saves before swapping
            mgr = CheckpointManager(directory, keep=keep,
                                    async_save=async_save)
            self._ckpt_mgr = mgr
        handle = mgr.save(self.train_state(), self._step_no)
        self._save_fence = handle.fence
        return handle

    def restore_checkpoint(self, directory, step=None):
        """Restore the newest (or given) COMMITTED checkpoint into the
        live state, in place; returns the restored step or -1.  Torn
        dirs are quarantined and skipped — see
        distributed.checkpoint.CheckpointManager."""
        from ..convert import load_train_state
        from ..distributed.checkpoint import CheckpointManager
        self._one_world('restore_checkpoint')
        mgr = self._ckpt_mgr
        if mgr is not None:
            # drain the in-flight async save BEFORE any swap: dropping
            # the handle would leave its manifest uncommitted forever
            mgr.wait()
        if mgr is None or mgr.directory != os.path.abspath(directory):
            mgr = CheckpointManager(directory)
            self._ckpt_mgr = mgr
        state, got = mgr.restore(self.train_state(), step=step,
                                 device='cpu')
        if state is None:
            return -1
        load_train_state(self, state['params'], state['opt_state'],
                         int(state['step']), buffers=state['buffers'])
        sched = state.get('lr_scheduler')
        if sched is not None:
            self.optimizer._learning_rate.set_state_dict(sched)
        # as a fresh trainer's: the next chunk starts its rows anew
        self._fused_rows = 0
        if self._chunk_pos is not None:
            self._chunk_pos.zero_()
        return got

    @torch.no_grad()
    def eval_step(self, *batch):
        """Forward and loss in eval mode, no AMP (as the reference):
        ``(outputs, loss)``; over ``dp`` the outputs are this rank's rows
        and the loss the ranks' mean."""
        xs, ys = self._split(batch)
        self.model.eval()
        with self._scope():
            out = self.model(*xs)
            loss = self.loss_fn(out, *ys).float().mean()
        if self._dp_group is not None:
            loss = collective.all_reduce(loss, group=self._dp_group) / \
                self._dp
        return out, loss

    def loss_float(self, loss):
        return float(loss)
