"""Training callbacks (counterpart of ``paddle_tpu/hapi/callbacks.py``;
Paddle's python/paddle/hapi/callbacks.py: Callback, ProgBarLogger,
ModelCheckpoint, LRScheduler, EarlyStopping, VisualDL).  Host code, the
reference's.  VisualDL writes through the port's
``telemetry.ScalarAdapter``: the same ``events.jsonl`` and ``scalar``
events, with the same constructor.
"""
import numbers
import os
import sys
import time

from ..resilience import NanSentinel

__all__ = ['Callback', 'ProgBarLogger', 'ModelCheckpoint', 'LRScheduler',
           'EarlyStopping', 'VisualDL', 'ReduceLROnPlateau', 'NanGuard',
           'config_callbacks']


class CallbackList:
    def __init__(self, callbacks):
        self.callbacks = list(callbacks)

    def append(self, cb):
        self.callbacks.append(cb)

    def __iter__(self):
        return iter(self.callbacks)

    def set_params(self, params):
        for cb in self.callbacks:
            cb.set_params(params)

    def set_model(self, model):
        for cb in self.callbacks:
            cb.set_model(model)

    def _call(self, name, *args):
        for cb in self.callbacks:
            getattr(cb, name)(*args)

    def __getattr__(self, name):
        if name.startswith('on_'):
            return lambda *args: self._call(name, *args)
        raise AttributeError(name)


class Callback:
    def __init__(self):
        self.model = None
        self.params = {}

    def set_params(self, params):
        self.params = params

    def set_model(self, model):
        self.model = model

    def on_train_begin(self, logs=None):
        pass

    def on_train_end(self, logs=None):
        pass

    def on_eval_begin(self, logs=None):
        pass

    def on_eval_end(self, logs=None):
        pass

    def on_predict_begin(self, logs=None):
        pass

    def on_predict_end(self, logs=None):
        pass

    def on_epoch_begin(self, epoch, logs=None):
        pass

    def on_epoch_end(self, epoch, logs=None):
        pass

    def on_train_batch_begin(self, step, logs=None):
        pass

    def on_train_batch_end(self, step, logs=None):
        pass

    def on_eval_batch_begin(self, step, logs=None):
        pass

    def on_eval_batch_end(self, step, logs=None):
        pass

    def on_predict_batch_begin(self, step, logs=None):
        pass

    def on_predict_batch_end(self, step, logs=None):
        pass


def _fmt(v):
    if isinstance(v, numbers.Number):
        return '{:.4f}'.format(v)
    if isinstance(v, (list, tuple)):
        return '[' + ', '.join(_fmt(x) for x in v) + ']'
    # lazy eval path: logs carry DEVICE scalars (0-d tensors)
    # so the host sync happens here, only when a logger actually
    # prints — float() them for the same formatting as plain numbers
    try:
        return '{:.4f}'.format(float(getattr(v, 'value', v)))
    except (TypeError, ValueError):
        return str(v)


class ProgBarLogger(Callback):
    def __init__(self, log_freq=1, verbose=2):
        super().__init__()
        self.log_freq = log_freq
        self.verbose = verbose
        self.epochs = None
        self.steps = None

    def on_train_begin(self, logs=None):
        self.epochs = self.params.get('epochs')
        self._t0 = time.time()

    def on_eval_begin(self, logs=None):
        self.steps = self.params.get('steps')

    def on_epoch_begin(self, epoch, logs=None):
        self.epoch = epoch
        self.steps = self.params.get('steps')
        self._epoch_t0 = time.time()
        if self.verbose and self.epochs:
            print('Epoch {}/{}'.format(epoch + 1, self.epochs))

    def _print_logs(self, prefix, step, logs):
        logs = logs or {}
        items = ['{}: {}'.format(k, _fmt(v)) for k, v in logs.items()]
        total = self.steps if self.steps else '?'
        print('{} step {}/{} - {}'.format(
            prefix, step + 1, total, ' - '.join(items)), file=sys.stderr
            if self.verbose == 1 else sys.stdout)

    def on_train_batch_end(self, step, logs=None):
        if self.verbose == 2 and (step + 1) % self.log_freq == 0:
            self._print_logs('train', step, logs)

    def on_epoch_end(self, epoch, logs=None):
        if self.verbose:
            dt = time.time() - self._epoch_t0
            items = ['{}: {}'.format(k, _fmt(v))
                     for k, v in (logs or {}).items()]
            print('Epoch {} done in {:.1f}s - {}'.format(
                epoch + 1, dt, ' - '.join(items)))

    def on_eval_batch_end(self, step, logs=None):
        if self.verbose == 2 and (step + 1) % self.log_freq == 0:
            self._print_logs('eval', step, logs)

    def on_eval_end(self, logs=None):
        if self.verbose:
            items = ['{}: {}'.format(k, _fmt(v))
                     for k, v in (logs or {}).items()]
            print('Eval - ' + ' - '.join(items))


class ModelCheckpoint(Callback):
    def __init__(self, save_freq=1, save_dir=None):
        super().__init__()
        self.save_freq = save_freq
        self.save_dir = save_dir

    def on_epoch_end(self, epoch, logs=None):
        if self.save_dir and (epoch + 1) % self.save_freq == 0:
            path = os.path.join(self.save_dir, str(epoch))
            self.model.save(path)

    def on_train_end(self, logs=None):
        if self.save_dir:
            self.model.save(os.path.join(self.save_dir, 'final'))


class LRScheduler(Callback):
    """Steps the optimizer's LRScheduler (by_step or by_epoch)."""

    def __init__(self, by_step=True, by_epoch=False):
        super().__init__()
        assert by_step ^ by_epoch, 'exactly one of by_step/by_epoch'
        self.by_step = by_step
        self.by_epoch = by_epoch

    def _sched(self):
        from ..optimizer.lr import LRScheduler as Sched
        opt = getattr(self.model, '_optimizer', None)
        lr = getattr(opt, '_learning_rate', None)
        return lr if isinstance(lr, Sched) else None

    def on_train_batch_end(self, step, logs=None):
        s = self._sched()
        if self.by_step and s is not None:
            s.step()

    def on_epoch_end(self, epoch, logs=None):
        s = self._sched()
        if self.by_epoch and s is not None:
            s.step()


class EarlyStopping(Callback):
    def __init__(self, monitor='loss', mode='auto', patience=0, verbose=1,
                 min_delta=0, baseline=None, save_best_model=True):
        super().__init__()
        self.monitor = monitor
        self.patience = patience
        self.verbose = verbose
        self.min_delta = abs(min_delta)
        self.baseline = baseline
        self.save_best_model = save_best_model
        self.stopped_epoch = 0
        if mode == 'min' or (mode == 'auto' and 'acc' not in monitor):
            self.is_better = lambda cur, best: cur < best - self.min_delta
            self.best = float('inf')
        else:
            self.is_better = lambda cur, best: cur > best + self.min_delta
            self.best = -float('inf')

    def on_train_begin(self, logs=None):
        self.wait = 0
        if self.baseline is not None:
            self.best = self.baseline

    def on_eval_end(self, logs=None):
        cur = (logs or {}).get(self.monitor)
        if cur is None:
            return
        if isinstance(cur, (list, tuple)):
            cur = cur[0]
        if self.is_better(cur, self.best):
            self.best = cur
            self.wait = 0
            if self.save_best_model and \
                    self.params.get('save_dir') is not None:
                self.model.save(os.path.join(self.params['save_dir'],
                                             'best_model'))
        else:
            self.wait += 1
            if self.wait >= self.patience:
                self.model.stop_training = True
                if self.verbose:
                    print('Early stopping: {} did not improve beyond '
                          '{:.5f}'.format(self.monitor, self.best))


class ReduceLROnPlateau(Callback):
    def __init__(self, monitor='loss', factor=0.1, patience=10, verbose=1,
                 mode='auto', min_delta=1e-4, cooldown=0, min_lr=0):
        super().__init__()
        self.monitor = monitor
        self.factor = factor
        self.patience = patience
        self.verbose = verbose
        self.min_delta = min_delta
        self.cooldown = cooldown
        self.min_lr = min_lr
        if mode == 'min' or (mode == 'auto' and 'acc' not in monitor):
            self.is_better = lambda cur, best: cur < best - self.min_delta
            self.best = float('inf')
        else:
            self.is_better = lambda cur, best: cur > best + self.min_delta
            self.best = -float('inf')
        self.wait = 0
        self.cooldown_counter = 0

    def on_eval_end(self, logs=None):
        cur = (logs or {}).get(self.monitor)
        if cur is None:
            return
        if isinstance(cur, (list, tuple)):
            cur = cur[0]
        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.wait = 0
        if self.is_better(cur, self.best):
            self.best = cur
            self.wait = 0
        else:
            self.wait += 1
            if self.wait >= self.patience:
                opt = self.model._optimizer
                new_lr = max(opt.get_lr() * self.factor, self.min_lr)
                opt.set_lr(new_lr)
                if self.verbose:
                    print('ReduceLROnPlateau: lr -> {:.6g}'.format(new_lr))
                self.cooldown_counter = self.cooldown
                self.wait = 0


class NanGuard(Callback):
    """Divergence sentinel for Model.fit (resilience.NanSentinel
    policy).  The compiled train step already SKIPS a non-finite
    update on device (old params kept — see Model._make_train_step);
    this callback adds the host-side policy: count consecutive
    skipped steps, and after `patience` strikes roll the model back
    to the last known-good state (captured at train begin and after
    every clean epoch — the same boundaries ModelCheckpoint persists
    to disk).  After `max_rollbacks` rollbacks the run raises
    FloatingPointError instead of looping on a poisoned setup.

    MEMORY: the rollback snapshot is a full device-side copy of
    params + optimizer state + buffers, held for the whole fit — fine
    for the models hapi targets, but a workload already at capacity
    should pass NanGuard(rollback=False) (skip-only: non-finite
    updates are still dropped on device at zero extra memory, there
    is just nothing to roll back to) or NanGuard(enable=False).

    Added to fit() by default; pass your own instance to tune.
    """

    def __init__(self, patience=3, max_rollbacks=2, enable=True,
                 rollback=True, verbose=1):
        super().__init__()
        self.enable = enable
        self.rollback = rollback
        self.verbose = verbose
        self.sentinel = NanSentinel(patience=patience,
                                    max_rollbacks=max_rollbacks)
        self._epoch_skip_base = 0

    def on_train_begin(self, logs=None):
        # the guard is the only default consumer of the per-step
        # finiteness flag: disabling it flips Model.train_batch onto
        # the sync-free path (loss/ok stay device arrays, step counter
        # advances on device) — the host-sync-free posture for
        # throughput runs
        self.model._check_finite_steps = bool(self.enable)
        if self.enable and self.rollback:
            self.model._capture_good_state()

    def on_epoch_begin(self, epoch, logs=None):
        self._epoch_skip_base = self.sentinel.total_skipped

    def on_train_batch_end(self, step, logs=None):
        if not self.enable:
            return
        action = self.sentinel.observe(
            finite=getattr(self.model, '_last_step_ok', True))
        if action == 'skip' and self.verbose:
            print('NanGuard: non-finite loss/grad at step {} — update '
                  'skipped ({}/{} strikes)'.format(
                      step + 1, self.sentinel.strikes,
                      self.sentinel.patience), file=sys.stderr)
        elif action == 'rollback':
            rolled = self.rollback and \
                self.model._rollback_to_good_state()
            # post-mortem evidence: the sentinel already emitted the
            # nan_rollback event; write the durable flight-recorder
            # copy next to the checkpoints when a save_dir exists
            if self.params.get('save_dir'):
                from ..telemetry import dump_flight
                dump_flight(os.path.join(
                    self.params['save_dir'],
                    f'flightrec-{step + 1}.json'))
            if self.verbose:
                print('NanGuard: {} consecutive non-finite steps — '
                      '{}'.format(
                          self.sentinel.patience,
                          'rolled back to last good state' if rolled
                          else 'no snapshot to roll back to; '
                               'continuing with skipped updates'),
                      file=sys.stderr)

    def on_epoch_end(self, epoch, logs=None):
        # refresh the rollback target only after a CLEAN epoch — an
        # epoch containing skips may already carry subtly-poisoned
        # state even though every applied update was finite
        if self.enable and self.rollback and \
                self.sentinel.total_skipped == self._epoch_skip_base:
            self.model._capture_good_state()


class VisualDL(Callback):
    """Scalar logging onto the telemetry ScalarAdapter (same
    constructor as the reference's VisualDL callback; same
    ``events.jsonl`` on disk, and every record additionally lands in
    the telemetry stream as a ``scalar`` event).

    Sync-free by buffering: logs carry DEVICE scalars on the lazy
    train path, and a per-step ``float(loss)`` would stall the device
    queue every batch.  Records buffer un-materialized and are floated
    and written only every `log_freq` steps and at epoch/eval/train
    end; by then the buffered tensors are log_freq steps old and
    already computed, so the flush does not stall the current step."""

    def __init__(self, log_dir='./log', log_freq=10):
        super().__init__()
        self.log_dir = log_dir
        self.log_freq = max(1, int(log_freq))
        self._writer = None
        self._step = 0
        self._buf = []      # (tag, step, {key: device-or-py scalar})

    def _adapter(self):
        if self._writer is None:
            from ..telemetry import ScalarAdapter
            self._writer = ScalarAdapter(self.log_dir)
        return self._writer

    @staticmethod
    def _materialize(v):
        if isinstance(v, numbers.Number):
            return v
        if isinstance(v, (list, tuple)) and v and \
                isinstance(v[0], numbers.Number):
            return list(v)
        try:
            return float(getattr(v, 'value', v))
        except (TypeError, ValueError):
            return None

    def flush(self):
        """Materialize buffered device scalars (the one sync, at the
        log boundary) and write them through the adapter."""
        if not self._buf:
            return
        buf, self._buf = self._buf, []
        w = self._adapter()
        for tag, step, logs in buf:
            vals = {}
            for k, v in logs.items():
                fv = self._materialize(v)
                if fv is not None:
                    vals[k] = fv
            w.write_record(tag, step, vals)

    def on_train_batch_end(self, step, logs=None):
        self._step += 1
        self._buf.append(('train', self._step, dict(logs or {})))
        if len(self._buf) >= self.log_freq:
            self.flush()

    def on_epoch_end(self, epoch, logs=None):
        self.flush()

    def on_eval_end(self, logs=None):
        self._buf.append(('eval', self._step, dict(logs or {})))
        self.flush()

    def on_train_end(self, logs=None):
        self.flush()
        if self._writer is not None:
            self._writer.close()
            self._writer = None


def config_callbacks(callbacks=None, model=None, batch_size=None,
                     epochs=None, steps=None, log_freq=2, verbose=2,
                     save_freq=1, save_dir=None, metrics=None, mode='train'):
    cbks = list(callbacks or [])
    if not any(isinstance(c, ProgBarLogger) for c in cbks) and verbose:
        cbks.append(ProgBarLogger(log_freq, verbose=verbose))
    if not any(isinstance(c, LRScheduler) for c in cbks):
        cbks.append(LRScheduler())
    if not any(isinstance(c, ModelCheckpoint) for c in cbks):
        cbks.append(ModelCheckpoint(save_freq, save_dir))
    if mode == 'train' and not any(isinstance(c, NanGuard) for c in cbks):
        cbks.append(NanGuard())
    cb_list = CallbackList(cbks)
    cb_list.set_model(model)
    cb_list.set_params({
        'batch_size': batch_size, 'epochs': epochs, 'steps': steps,
        'verbose': verbose, 'metrics': metrics or [], 'save_dir': save_dir})
    return cb_list
