"""High-level Model API: fit / evaluate / predict / save / load
(counterpart of ``paddle_tpu/hapi/model.py``; Paddle's
python/paddle/hapi/model.py).

``Model`` runs where the network's parameters are: the card unless the
network was built on the CPU.  Batches (numpy, or host tensors from
``io.DataLoader``) are staged onto that device through pinned memory.

**The step.**  ``train_batch`` is the reference's ``_build_train_step``
run eagerly: forward, loss (``mean`` of the loss function's output) and
backward; the step's finite flag (``resilience.finite_step`` of the
loss and the gradients); the optimizer's update at ``get_lr()`` (read
on every call, as the reference passes it into its compiled step),
every write of it selected by the flag, as are the network's float
buffers (``guard_update``), so a non-finite step leaves parameters,
optimizer state and buffers as they were; and each metric's
``compute`` on the outputs, zeroed where the step was skipped.  The
optimizer's per-step scalars come from the trainer's machinery
(``Optimizer._step_scalars`` uploaded as a table, ``_load_step_at``),
and the step number lives on the device as well as the host: a device
counter counts the finite steps, and the table row the step reads is
picked by it.

``_check_finite_steps`` (True unless ``NanGuard(enable=False)``) is
the reference's exact-skip contract: the flag is read back once a step,
a skipped step feeds no metric and does not advance the host's step
count, and ``NanGuard`` sees a Python bool.  With it off the step reads
nothing back: the loss and the flag stay device tensors, the metrics
take the zeroed statistics of a skipped step, and the host learns the
device's count from a non-blocking copy it polls (an event query),
widening the table to every count the device may hold meanwhile.

**Fused chunks.**  ``fit(fused_steps=K)`` and ``train_chunk`` map the
reference's K-step scan onto a CUDA graph, as
``ParallelTrainer.step_fused`` does: one step is captured through
``core.compile_cache.GraphCache`` (after an eager warm-up on the
capture stream) and replayed K times over a ``[K, ...]`` chunk staged
on the device; the device counter picks each replay's row of the
chunk's scalar table (one ``get_lr()`` a chunk, as the reference feeds
its scan, written into the graph's input buffer before the replays,
never baked in at capture); the chunk's one host read is its finite
mask (``scan_loop.chunk_sync``).  Losses, parameters and metric logs
equal the eager steps'.  On the CPU the cache hands out the step itself.

**What the port leaves out.**  The reference's persistent compiled-step
cache (``compile_cache.through_cache``) exports XLA executables; a CUDA
graph cannot be serialised, so each process captures its own.
``prepare(lint=)`` raises until the analysis tier is ported (ROADMAP
Queue 1 item 11), and ``save(training=False)`` calls ``jit.save``,
which raises until item 8b.  ``fit(profile=)`` goes to
``telemetry.step_profiler``.  ``amp_configs`` is accepted and, as in
the reference, not read.
"""
import functools
import os
import signal as _signal
import time
import warnings

import numpy as np
import torch

from ..core import compile_cache, scan_loop
from ..framework.io import load as _load
from ..framework.io import save as _save
from ..io import DataLoader, Dataset
from ..metric import Metric
from ..nn import Layer
from ..resilience import finite_step as _finite_step
from ..resilience import guard_update as _guard_update
from ..resilience import install_shutdown as _install_shutdown
from ..resilience import shutdown_requested as _shutdown_requested
from .callbacks import config_callbacks

__all__ = ['Model']

# how many steps the sync-free path may run ahead of the step count it
# last read back before it waits for one
_MAX_PENDING = 64


def _as_list(x):
    if x is None:
        return []
    if isinstance(x, (list, tuple)):
        return list(x)
    return [x]


def _outs_list(outs):
    """A layer's output, a bare tensor or a tuple/list, as a list."""
    return list(outs) if isinstance(outs, (list, tuple)) else [outs]


def _as_tensor(x):
    if isinstance(x, torch.Tensor):
        return x
    if isinstance(x, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(x))
    return torch.as_tensor(np.asarray(x))


def _masked(ok, r):
    """A metric statistic zeroed where ``ok`` is False (neutral for the
    count-style metrics)."""
    if isinstance(r, (tuple, list)):
        return type(r)(_masked(ok, x) for x in r)
    return torch.where(ok, r, torch.zeros_like(r))


class _StepCount:
    """The optimizer step count as the device holds it (finite steps
    only) and as the host knows it: exactly while every step's flag is
    read back, else a lower bound ``lo`` (the value a polled
    non-blocking copy last returned) and the number of steps dispatched
    since (``pending``), so the count lies in ``[lo, lo + pending]``."""

    def __init__(self, device, start):
        self.device = device
        self.dev = torch.full((1,), int(start), dtype=torch.long,
                              device=device)
        self.lo = int(start)
        self.pending = 0
        self._poll = None       # (pinned host copy, event, pending then)

    def exact(self, n):
        self.lo, self.pending, self._poll = int(n), 0, None

    def advance(self):
        """One sync-free step went out: poll the last copy and start
        another, never waiting, unless the host fell ``_MAX_PENDING``
        steps behind (then it reads)."""
        self.pending += 1
        if self.device.type != 'cuda':
            self.exact(int(self.dev))           # the CPU has no queue
            return
        if self._poll is not None and self._poll[1].query():
            host, _, then = self._poll
            self.lo, self.pending = int(host[0]), self.pending - then
            self._poll = None
        if self._poll is None:
            host = torch.empty(1, dtype=torch.long, pin_memory=True)
            host.copy_(self.dev, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record()
            self._poll = (host, ev, self.pending)
        if self.pending > _MAX_PENDING:
            self.exact(int(self.dev))

    def read(self):
        """The count (one host read unless it is known)."""
        if self.pending:
            self.exact(int(self.dev))
        return self.lo


class Model:
    """Wraps a Layer with train/eval/predict loops.

    Args:
        network: a ``paddle_tpu_torch.nn.Layer`` with forward(*inputs).
        inputs/labels: optional InputSpec lists (count determines the
            input/label split of each batch; default 1 label).
    """

    def __init__(self, network, inputs=None, labels=None):
        self.network = network
        self._inputs = _as_list(inputs)
        self._labels = _as_list(labels)
        self._optimizer = None
        self._loss = None
        self._metrics = []
        self.stop_training = False
        # True (default): train_batch reads the step's finite flag
        # back so skipped steps feed no metrics and NanGuard sees a
        # Python bool — one host sync a step, the price of the exact
        # skip contract.  NanGuard(enable=False) turns it off for the
        # sync-free path.
        self._check_finite_steps = True
        self._count = None          # _StepCount, made with the optimizer
        self._fused_cache = None    # GraphCache of captured steps
        self._table_key = None
        self._table = None
        self._good_state = None
        self._last_step_ok = True
        self._last_fit_loss = None
        self.chunk_syncs = 0        # host reads of fused chunks

    @property
    def device(self):
        """Where the network's parameters are, and so where it runs."""
        for p in self.network.parameters():
            return p.device
        for b in self.network.buffers():
            return b.device
        raise ValueError('Model: the network has no parameters or buffers '
                         'to say which device it runs on')

    # -- preparation ---------------------------------------------------------
    def prepare(self, optimizer=None, loss=None, metrics=None,
                amp_configs=None, lint=None):
        if lint:
            raise NotImplementedError(
                'Model.prepare(lint=) audits the compiled step with the '
                "reference's analysis tier, which is not ported yet "
                '(ROADMAP Queue 1 item 11)')
        self._optimizer = optimizer
        self._loss = loss
        self._metrics = _as_list(metrics)
        for m in self._metrics:
            assert isinstance(m, Metric), \
                'metrics must be paddle_tpu_torch.metric.Metric instances'
        # a new optimizer or loss invalidates the captured steps (they
        # closed over the old ones)
        self._fused_cache = None
        self._table_key = None
        self._count = None
        if optimizer is not None:
            # the rule sees each parameter's name (AdamW's
            # apply_decay_param_fun), as the reference's pytree paths;
            # the state dict keys stay the reference's indices
            optimizer._ctx_names.update(
                {id(p): n for n, p in self.network.named_parameters()})
        return self

    def parameters(self, *args, **kwargs):
        return self.network.parameters()

    # -- state ---------------------------------------------------------------
    def _counter(self):
        if self._count is None:
            self._count = _StepCount(self.device,
                                     self._optimizer._global_step)
        return self._count

    def _sync_back(self):
        """Make the optimizer's step count a plain int again (an epoch or
        save boundary; the sync-free path keeps it on the device)."""
        if self._count is not None and self._optimizer is not None:
            self._optimizer._global_step = self._count.read()

    def _invalidate(self):
        """The optimizer's step count changed on the host (``load``):
        the device counter takes it, in place, since a captured step
        reads and writes that tensor."""
        if self._count is not None:
            step = self._optimizer._global_step
            self._count.dev.fill_(step)
            self._count.exact(step)

    def _state_tensors(self):
        """Parameters, buffers and every optimizer slot, in a fixed
        order; a parameter's slots are made (zeros, as at its first
        update) if it has none yet, as the reference's functional state
        holds them from the start."""
        opt = self._optimizer
        if opt is not None:
            for p in opt._params:
                if id(p) not in opt._accumulators:
                    opt._accumulators[id(p)] = opt._create_state(p)
        params = list(self.network.parameters())
        bufs = list(self.network.buffers())
        slots = [v for p in (opt._params if opt is not None else [])
                 for v in opt._accumulators.get(id(p), {}).values()]
        return params + bufs + slots

    def _capture_good_state(self):
        """Snapshot parameters, buffers and optimizer state (device
        copies) as the rollback target."""
        with torch.no_grad():
            self._good_state = (
                [t.detach().clone() for t in self._state_tensors()],
                self._counter().read())

    def _rollback_to_good_state(self):
        """Restore the last snapshot in place (NanGuard calls this after
        K consecutive non-finite steps).  -> True if a snapshot
        existed."""
        if self._good_state is None:
            return False
        saved, step = self._good_state
        live = self._state_tensors()
        if len(live) != len(saved):
            return False
        with torch.no_grad():
            for dst, src in zip(live, saved):
                dst.copy_(src)
        count = self._counter()
        count.dev.fill_(step)
        count.exact(step)
        self._optimizer._global_step = step
        return True

    # -- steps ---------------------------------------------------------------
    def _to_device(self, value):
        """A batch entry on the network's device; a host tensor goes
        through pinned memory so the copy does not wait for the queued
        step."""
        value = _as_tensor(value)
        dev = self.device
        if value.device == dev:
            return value
        if dev.type == 'cuda' and value.device.type == 'cpu':
            return value.pin_memory().to(dev, non_blocking=True)
        return value.to(dev)

    def _loss_value(self, outs, labels):
        if self._loss is None:
            lv = outs[0]
        else:
            lv = self._loss(*(list(outs) + list(labels)))
        return torch.mean(lv)

    def _metric_computes(self, outs, labels):
        res = []
        for m in self._metrics:
            if labels:
                res.append(m.compute(outs[0], labels[0]))
            else:
                res.append(m.compute(outs[0]))
        return res

    def _split_arity(self, n_fields):
        """How many leading fields of an n_fields batch feed forward
        (the rest are labels)."""
        n_lab = len(self._labels) if self._labels else \
            (1 if self._loss is not None else 0)
        n_lab = min(n_lab, max(0, n_fields - 1))
        return n_fields - n_lab

    def _split_batch(self, batch):
        batch = [self._to_device(b) for b in _as_list(batch)]
        return batch, self._split_arity(len(batch))

    def _scalar_table(self, rows):
        """The optimizer's scalars of steps ``lo + 1 .. lo + rows`` at
        ``get_lr()`` (an f32, as the reference feeds it), ``[rows, n]``
        f32 on the device; rebuilt only when the steps or the rate
        change."""
        opt = self._optimizer
        lo = self._counter().lo
        lr = np.float32(opt.get_lr())
        key = (lo, rows, float(lr))
        if key != self._table_key:
            host = torch.tensor(np.array(
                [list(opt._step_scalars(t, lr).values())
                 for t in range(lo + 1, lo + 1 + rows)], np.float32))
            self._table = self._to_device(host)
            self._table_key = key
        return self._table, torch.full((1,), lo, dtype=torch.long)

    def _train_body(self, n_in, table, base, *arrays):
        """One guarded step on device tensors: device work only, so a
        graph can capture it.  Returns ``(loss, ok, metric stats)``."""
        net, opt = self.network, self._optimizer
        count = self._count.dev
        inputs, labels = arrays[:n_in], arrays[n_in:]
        net.train()
        opt.clear_grad()
        bufs = [b for b in net.buffers() if b.is_floating_point()]
        old = [b.detach().clone() for b in bufs]
        outs = _outs_list(net(*inputs))
        loss = self._loss_value(outs, labels)
        loss.backward()
        loss = loss.detach()
        with torch.no_grad():
            ok = _finite_step(loss, [p.grad for p in opt._params
                                     if p.grad is not None])
            opt._load_step_at(table, count - base)
            opt._guard = ok
            try:
                opt._update()
            finally:
                opt._guard = None
            for b, v in zip(bufs, _guard_update(ok, bufs, old)):
                b.copy_(v)
            mres = [_masked(ok, r) for r in self._metric_computes(
                [o.detach() for o in outs], labels)]
            count.copy_(torch.where(ok, count + 1, count))
        return loss, ok, mres

    def _table_rows(self, k):
        """Rows a chunk of ``k`` steps may read: ``k`` while the count is
        exact, else every count the device may hold, to a fixed size."""
        count = self._counter()
        if self._check_finite_steps:
            count.read()
            return k
        return k + _MAX_PENDING

    def train_batch(self, inputs, labels=None):
        """One optimizer step; returns (loss, metric logs).  The loss is
        a 0-d device tensor (``float(loss)`` reads it); with the exact
        skip contract the step's flag is read back once."""
        assert self._optimizer is not None and self._loss is not None, \
            'call prepare(optimizer, loss) before train_batch'
        batch = _as_list(inputs) + _as_list(labels)
        arrays, n_in = self._split_batch(batch)
        opt, count = self._optimizer, self._counter()
        table, base = self._scalar_table(self._table_rows(1))
        opt._t = count.lo + 1 if self._check_finite_steps else None
        loss, ok, mres = self._train_body(n_in, table,
                                          self._to_device(base), *arrays)
        if self._check_finite_steps:
            ok = bool(ok)           # the one host read of the step
            self._last_step_ok = ok
            count.exact(count.lo + (1 if ok else 0))
            opt._global_step = count.lo
            if not ok:
                # policy (strikes/rollback) is NanGuard's
                return loss, []
        else:
            self._last_step_ok = ok
            count.advance()
            opt._global_step = count.lo + count.pending
        metric_logs = [m.update(r) if not isinstance(r, (tuple, list))
                       else m.update(*r)
                       for m, r in zip(self._metrics, mres)]
        return loss, metric_logs

    # -- fused K-step chunks (core.scan_loop) --------------------------------
    def train_chunk(self, stacked, n_in=None, k=None):
        """K optimizer steps in one call: every array of ``stacked``
        carries a leading K dim, and the call returns ``(losses, oks)``
        as K-length device tensors.  On the card the step is a captured
        CUDA graph replayed K times; the update math, the skip contract
        and the step count equal K calls of ``train_batch``.  The chunk
        reads back one thing under the exact skip contract, its finite
        mask (``scan_loop.chunk_sync``), and nothing otherwise."""
        assert self._optimizer is not None and self._loss is not None, \
            'call prepare(optimizer, loss) before train_chunk'
        stacked = tuple(self._to_device(v) for v in stacked)
        k = int(k if k is not None else stacked[0].shape[0])
        if n_in is None:
            n_in = self._split_arity(len(stacked))
        opt, count = self._optimizer, self._counter()
        table, base = self._scalar_table(self._table_rows(k))
        if self._fused_cache is None:
            self._fused_cache = compile_cache.GraphCache(self.device)
        sig = ('train', n_in, tuple(table.shape)) + tuple(
            (tuple(v.shape[1:]), v.dtype) for v in stacked)
        step_fn = self._fused_cache.module(
            sig, functools.partial(self._train_body, n_in))
        opt._t = None           # the step's number lives on the device
        base = self._to_device(base)
        losses, oks, mres = scan_loop.fused_hapi_step(
            lambda *row: step_fn(table, base, *row), k)(*stacked)
        if self._check_finite_steps:
            mask = scan_loop.chunk_sync(oks)
            self.chunk_syncs += 1
            # the chunk reduces conservatively for NanGuard: any
            # poisoned step marks the whole chunk not-ok
            self._last_step_ok = bool(mask.all())
            count.exact(count.lo + int(mask.sum()))
            opt._global_step = count.lo
        else:
            self._last_step_ok = oks[-1]
            for _ in range(k):
                count.advance()
            opt._global_step = count.lo + count.pending
        self._chunk_metric_update(mres)
        return losses, oks

    @staticmethod
    def _merge_chunk_dim(v):
        """(K, N, ...) stacked metric stats -> (K*N, ...): metric
        update() accumulates sums/counts, so feeding the chunk-merged
        stats once equals feeding K per-step stats (skipped steps were
        already zeroed on the device)."""
        if v.dim() >= 2:
            return v.reshape((-1,) + tuple(v.shape[2:]))
        return v

    def _chunk_metric_update(self, mres):
        logs = []
        for m, r in zip(self._metrics, mres):
            if isinstance(r, (tuple, list)):
                logs.append(m.update(*[self._merge_chunk_dim(x)
                                       for x in r]))
            else:
                logs.append(m.update(self._merge_chunk_dim(r)))
        return logs

    # -- eval / predict ------------------------------------------------------
    @torch.no_grad()
    def _eval_batch_lazy(self, arrays, n_in):
        """One eval step with no host read: the loss stays a device
        tensor and the metric updates are lazy device adds."""
        net = self.network
        was_training = net.training
        net.eval()
        try:
            outs = _outs_list(net(*arrays[:n_in]))
        finally:
            net.train(was_training)
        labels = arrays[n_in:]
        loss = self._loss_value(outs, labels) \
            if self._loss is not None else torch.zeros((), device=self.device)
        for m, r in zip(self._metrics, self._metric_computes(outs, labels)):
            m.update(r) if not isinstance(r, (tuple, list)) \
                else m.update(*r)
        return outs, loss

    def eval_batch(self, inputs, labels=None):
        """One eval step; returns (loss, outputs) as device tensors."""
        batch = _as_list(inputs) + _as_list(labels)
        arrays, n_in = self._split_batch(batch)
        outs, loss = self._eval_batch_lazy(arrays, n_in)
        return loss, list(outs)

    @torch.no_grad()
    def predict_batch(self, inputs):
        """The outputs on ``inputs`` in eval mode, as numpy arrays."""
        arrays = [self._to_device(b) for b in _as_list(inputs)]
        net = self.network
        was_training = net.training
        net.eval()
        try:
            outs = _outs_list(net(*arrays))
        finally:
            net.train(was_training)
        return [o.detach().cpu().numpy() for o in outs]

    # -- loops ---------------------------------------------------------------
    def _to_loader(self, data, batch_size, shuffle, num_workers,
                   drop_last=False):
        if data is None or isinstance(data, DataLoader):
            return data
        if isinstance(data, Dataset):
            return DataLoader(data, batch_size=batch_size, shuffle=shuffle,
                              num_workers=num_workers, drop_last=drop_last)
        return data  # any iterable of batches

    def fit(self, train_data=None, eval_data=None, batch_size=1, epochs=1,
            eval_freq=1, log_freq=10, save_dir=None, save_freq=1,
            verbose=2, drop_last=False, shuffle=True, num_workers=0,
            callbacks=None, profile=None, fused_steps=None):
        """Train for ``epochs`` over ``train_data`` (a Dataset, a
        DataLoader or any iterable of batches).  ``profile=`` arms
        ``telemetry.step_profiler`` over the train loop (None: the
        ``PADDLE_TPU_PROFILE`` environment variable decides).
        ``fused_steps=K`` (None: ``PADDLE_TPU_FUSED_STEPS``) runs K
        steps a call through ``train_chunk``, staged in K-batch chunks
        (on a background thread when the loader has workers); callbacks,
        logging and the preemption check run at chunk boundaries, and a
        short final chunk takes the per-step path."""
        assert self._optimizer is not None and self._loss is not None, \
            'call prepare(optimizer, loss) before fit'
        train_loader = self._to_loader(train_data, batch_size, shuffle,
                                       num_workers, drop_last=drop_last)
        eval_loader = self._to_loader(eval_data, batch_size, False,
                                      num_workers)
        steps = len(train_loader) if hasattr(train_loader, '__len__') \
            else None
        cbks = config_callbacks(
            callbacks, model=self, batch_size=batch_size, epochs=epochs,
            steps=steps, log_freq=log_freq, verbose=verbose,
            save_freq=save_freq, save_dir=save_dir,
            metrics=['loss'] + [m.name() for m in self._metrics])
        self.stop_training = False
        # preemption contract: SIGTERM during fit stops at the next
        # step boundary, ModelCheckpoint's on_train_end writes the
        # final checkpoint, and the tail of fit() exits
        # PREEMPTED_EXIT_CODE (SIGINT instead hands control back).
        # fit only BORROWS the handlers: if nothing else installed
        # them, they are restored on exit
        from ..resilience import shutdown as _sd
        from .. import telemetry as _tel
        _owned_handlers = not _sd.handler_installed()
        _install_shutdown()
        try:
            with _tel.span('fit', epochs=epochs):
                self._fit_loop(cbks, train_loader, eval_loader, epochs,
                               eval_freq, batch_size, num_workers,
                               log_freq=log_freq, profile=profile,
                               save_dir=save_dir,
                               fused_steps=fused_steps)
        finally:
            requested = _sd.shutdown_requested()
            sig = _sd.preemption_signal()
            if _owned_handlers:
                _sd.uninstall_shutdown()
                if sig == _signal.SIGINT:
                    # user stop, and the latch is ours: un-latch so
                    # the next fit starts fresh
                    _sd.clear_shutdown()
        if requested and sig != _signal.SIGINT:
            # preemption: the final checkpoint just landed in
            # on_train_end; the flight recorder lands next to it, and
            # the process exits with the code the supervisor restarts
            # for free
            try:
                step = int(self._optimizer._global_step)
            except (TypeError, ValueError):
                step = -1
            _tel.event('preemption', signum=sig, where='hapi.fit',
                       step=step)
            dump_dir = save_dir or _tel.flight_dir()
            if dump_dir:
                _tel.dump_flight(os.path.join(
                    dump_dir, f'flightrec-{step}.json'))
            _sd.exit_if_requested()
        return self

    def _fit_loop(self, cbks, train_loader, eval_loader, epochs,
                  eval_freq, batch_size, num_workers, log_freq=10,
                  profile=None, save_dir=None, fused_steps=None):
        from .. import telemetry as _tel
        # sync-free telemetry: device loss scalars and host step/wait
        # times buffer in the accumulator (None when not enabled)
        acc = _tel.step_accumulator('train')
        prof = _tel.step_profiler(profile, base_dir=save_dir, name='fit')
        # metric accumulate() is a device read: pay it only on steps
        # some logger prints — the union of fit's log_freq and every
        # callback's own
        log_freqs = {max(1, int(log_freq))}
        for cb in cbks:
            f = getattr(cb, 'log_freq', None)
            if isinstance(f, int) and f > 0:
                log_freqs.add(f)
        k = scan_loop.resolve_fused_steps(fused_steps)
        cbks.on_train_begin({})
        try:
            if k:
                self._fit_epochs_fused(
                    cbks, train_loader, eval_loader, epochs,
                    eval_freq, batch_size, num_workers, log_freqs,
                    acc, prof, k)
            else:
                self._fit_epochs(cbks, train_loader, eval_loader,
                                 epochs, eval_freq, batch_size,
                                 num_workers, log_freqs, acc, prof)
        finally:
            if prof is not None:
                prof.close(sync=self._last_fit_loss)

    def _fit_epochs(self, cbks, train_loader, eval_loader, epochs,
                    eval_freq, batch_size, num_workers, log_freqs,
                    acc, prof):
        _perf = time.perf_counter
        gstep = 0
        self._last_fit_loss = None
        logs = {}
        for epoch in range(epochs):
            cbks.on_epoch_begin(epoch, {})
            for m in self._metrics:
                m.reset()
            logs = {}
            step = -1
            loader_it = iter(train_loader)
            while True:
                _tw0 = _perf()
                try:
                    batch = next(loader_it)
                except StopIteration:
                    break
                wait_s = _perf() - _tw0
                step += 1
                cbks.on_train_batch_begin(step, {})
                arrays, n_in = self._split_batch(batch)
                _ts0 = _perf()
                loss, _ = self.train_batch(arrays[:n_in], arrays[n_in:])
                self._last_fit_loss = loss
                if acc is not None:
                    acc.observe(step=step, step_time_s=_perf() - _ts0,
                                wait_s=wait_s, loss=loss)
                if prof is not None:
                    prof.observe(gstep, sync=loss)
                gstep += 1
                logs = {'loss': loss}
                if any((step + 1) % f == 0 for f in log_freqs):
                    for m in self._metrics:
                        logs[str(m.name())] = m.accumulate()
                cbks.on_train_batch_end(step, logs)
                if _shutdown_requested():
                    # preemption: stop at this step boundary;
                    # on_train_end below runs the final checkpoint
                    self.stop_training = True
                if self.stop_training:
                    break
            if acc is not None:
                acc.flush()
            for m in self._metrics:
                logs[str(m.name())] = m.accumulate()
            cbks.on_epoch_end(epoch, logs)
            if self.stop_training:
                break
            if eval_loader is not None and (epoch + 1) % eval_freq == 0:
                eval_logs = self.evaluate(
                    eval_loader, batch_size=batch_size, verbose=0,
                    num_workers=num_workers, _callbacks=cbks)
                cbks.on_eval_end(eval_logs)
            if self.stop_training:
                break
        cbks.on_train_end(logs)
        self._sync_back()

    def _fit_epochs_fused(self, cbks, train_loader, eval_loader,
                          epochs, eval_freq, batch_size, num_workers,
                          log_freqs, acc, prof, k):
        """The K-step fused epoch loop: batches are staged in K-chunks
        (stacked and put on the device on a background thread when the
        loader has workers), each chunk is one ``train_chunk`` call, and
        callbacks, logging and the preemption check run at chunk
        boundaries; a short final chunk takes the per-step path."""
        from .. import telemetry as _tel
        _perf = time.perf_counter
        gstep = 0
        self._last_fit_loss = None
        logs = {}

        def host(v):
            # host fields stack on the host and go over in one copy
            if isinstance(v, torch.Tensor):
                return v.numpy() if v.device.type == 'cpu' else v
            return np.asarray(v)

        def stage(batches):
            rows = [[host(v) for v in _as_list(b)] for b in batches]
            stacked = scan_loop.stack_batches(rows)
            return (tuple(self._to_device(v) for v in stacked),
                    self._split_arity(len(rows[0])))

        for epoch in range(epochs):
            cbks.on_epoch_begin(epoch, {})
            for m in self._metrics:
                m.reset()
            logs = {}
            step = -1
            loader_workers = getattr(train_loader, 'num_workers', None)
            if loader_workers is None:
                loader_workers = num_workers
            pref = scan_loop.ChunkPrefetcher(
                iter(train_loader), k, stage,
                background=loader_workers > 0)
            for staged, n, wait_s in pref:
                if n == k:
                    stacked, n_in = staged
                    cbks.on_train_batch_begin(step + 1, {})
                    _ts0 = _perf()
                    losses, _oks = self.train_chunk(stacked, n_in, k)
                    dt = _perf() - _ts0
                    loss = losses[-1]
                    self._last_fit_loss = loss
                    if acc is not None:
                        acc.observe_chunk(step + 1, n, step_time_s=dt,
                                          wait_s=wait_s, loss=losses)
                    _tel.set_gauge('fused.host_wait_ms',
                                   round(wait_s * 1000.0, 4))
                    if prof is not None:
                        prof.observe(gstep, sync=loss, span=n)
                    gstep += n
                    step += n
                    logs = {'loss': loss}
                    if any((step + 1 - j) % f == 0
                           for f in log_freqs for j in range(n)):
                        for m in self._metrics:
                            logs[str(m.name())] = m.accumulate()
                    cbks.on_train_batch_end(step, logs)
                else:
                    # ragged tail: the < K remaining batches take the
                    # per-step path instead of a one-off K'-step graph
                    for batch in staged:
                        step += 1
                        cbks.on_train_batch_begin(step, {})
                        arrays, n_in = self._split_batch(batch)
                        _ts0 = _perf()
                        loss, _ = self.train_batch(arrays[:n_in],
                                                   arrays[n_in:])
                        self._last_fit_loss = loss
                        if acc is not None:
                            acc.observe(step=step,
                                        step_time_s=_perf() - _ts0,
                                        loss=loss)
                        if prof is not None:
                            prof.observe(gstep, sync=loss)
                        gstep += 1
                        logs = {'loss': loss}
                        if any((step + 1) % f == 0 for f in log_freqs):
                            for m in self._metrics:
                                logs[str(m.name())] = m.accumulate()
                        cbks.on_train_batch_end(step, logs)
                if _shutdown_requested():
                    # preemption lands at the chunk boundary we are on
                    self.stop_training = True
                if self.stop_training:
                    break
            if acc is not None:
                acc.flush()
            for m in self._metrics:
                logs[str(m.name())] = m.accumulate()
            cbks.on_epoch_end(epoch, logs)
            if self.stop_training:
                break
            if eval_loader is not None and (epoch + 1) % eval_freq == 0:
                eval_logs = self.evaluate(
                    eval_loader, batch_size=batch_size, verbose=0,
                    num_workers=num_workers, _callbacks=cbks)
                cbks.on_eval_end(eval_logs)
            if self.stop_training:
                break
        cbks.on_train_end(logs)
        self._sync_back()

    def evaluate(self, eval_data, batch_size=1, log_freq=10, verbose=2,
                 num_workers=0, callbacks=None, _callbacks=None):
        loader = self._to_loader(eval_data, batch_size, False, num_workers)
        for m in self._metrics:
            m.reset()
        total_loss, n_batches = 0.0, 0
        cbks = _callbacks
        if cbks is None:
            cbks = config_callbacks(
                callbacks, model=self, batch_size=batch_size,
                steps=len(loader) if hasattr(loader, '__len__') else None,
                log_freq=log_freq, verbose=verbose, mode='eval',
                metrics=['loss'] + [m.name() for m in self._metrics])
            cbks.on_eval_begin({})
        from .. import telemetry as _tel
        with _tel.span('evaluate'):
            for step, batch in enumerate(loader):
                arrays, n_in = self._split_batch(batch)
                # lazy path: the loss stays a device tensor and the
                # metric updates are device adds — no per-batch host
                # read; a callback that formats the loss pays it
                _, loss = self._eval_batch_lazy(arrays, n_in)
                total_loss = total_loss + loss
                n_batches += 1
                cbks.on_eval_batch_end(step, {'loss': loss})
        logs = {'loss': float(total_loss) / max(1, n_batches)}
        for m in self._metrics:
            logs[str(m.name())] = m.accumulate()
        if _callbacks is None:
            cbks.on_eval_end(logs)
        return logs

    def predict(self, test_data, batch_size=1, num_workers=0,
                stack_outputs=False, callbacks=None, verbose=1):
        loader = self._to_loader(test_data, batch_size, False, num_workers)
        outputs = []
        for batch in loader:
            arrays, n_in = self._split_batch(batch)
            outputs.append(self.predict_batch(arrays[:n_in]))
        # transpose: list-of-batches -> per-output lists
        n_out = len(outputs[0]) if outputs else 0
        per_out = [[b[i] for b in outputs] for i in range(n_out)]
        if stack_outputs:
            per_out = [np.concatenate(o, axis=0) for o in per_out]
        return per_out

    # -- persistence ---------------------------------------------------------
    def save(self, path, training=True):
        """``path.pdparams`` (the network's state dict) and, with an
        optimizer, ``path.pdopt``, in the reference's pickle format;
        ``training=False`` is ``jit.save`` (not ported yet)."""
        self._sync_back()
        if training:
            d = os.path.dirname(path)
            if d:
                os.makedirs(d, exist_ok=True)
            _save(self.network.state_dict(), path + '.pdparams')
            if self._optimizer is not None:
                _save(self._optimizer.state_dict(), path + '.pdopt')
        else:
            from .. import jit as _jit
            _jit.save(self.network, path)

    def load(self, path, skip_mismatch=False, reset_optimizer=False):
        sd = _load(path + '.pdparams')
        try:
            # a zoo model is a plain torch module: Layer's loader copies
            # into any module's state dict in place
            Layer.set_state_dict(self.network, sd)
        except (KeyError, ValueError):
            if not skip_mismatch:
                raise
            warnings.warn('skip_mismatch=True: partially loaded')
        if not reset_optimizer and self._optimizer is not None and \
                os.path.exists(path + '.pdopt'):
            self._optimizer.set_state_dict(_load(path + '.pdopt'))
        self._invalidate()
        return self

    def summary(self, input_size=None, dtype=None):
        from .summary import summary as _summary
        return _summary(self.network, input_size, dtypes=dtype)
