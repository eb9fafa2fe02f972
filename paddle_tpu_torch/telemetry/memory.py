"""Memory observatory: the compiled and live sides of device memory (the
port's counterpart of ``paddle_tpu/telemetry/memory.py``, with its
names, its events and its ``PADDLE_TPU_MEMSTATS`` grammar).

* **compiled** — the reference extracts XLA's
  ``compiled.memory_analysis()`` (argument / output / temp / alias /
  code bytes) at every compile choke point, next to the liveness
  prediction over the module's HLO.  The port has no XLA: its compiled
  module is a CUDA graph (``core.compile_cache``), and what a capture
  costs is the memory its graph pool takes.  :func:`note_graph_capture`
  reads the caching allocator's counters just before and just after one
  serving module is made (warm-up call plus capture) and emits one
  ``memory_compiled`` event under the reference's name with
  ``compiled_peak_bytes`` = the bytes the allocator reserved anew for
  it, ``temp_bytes`` = the bytes it left allocated (its static inputs,
  outputs and the graph pool's live blocks), and ``pool_shared`` set
  when the module allocates from a pool other modules share (then a
  later module reuses what an earlier one reserved, and its delta
  counts only the growth).  There is no liveness prediction, so no
  ``predicted_peak_bytes`` and no ratio.  On the CPU nothing is
  captured and nothing is emitted.  :func:`note_compiled` and
  :func:`maybe_note_compiled` keep the reference's call shapes for a
  caller that holds the byte fields itself.
* **live** — a :class:`MemorySampler` thread (default OFF,
  ``PADDLE_TPU_MEMSTATS``, the watchdog's posture) reading
  :func:`device_memory_stats` — ``torch.cuda.memory_stats`` (bytes in
  use and their high-water, host-side counters of the caching
  allocator: no CUDA call, so it may run beside a graph capture) and
  the card's total memory as the limit, read once in the thread that
  arms the sampler — and, on the CPU, where that returns None as JAX's
  CPU backend does, :func:`live_arrays_bytes`: the storage bytes of the
  modules and tensors registered with :func:`track` (the serving engine
  registers its model and its KV pools).  That census is host-only and
  cheap (one walk over the registered parameters, no allocator, no
  ``gc`` scan), and counts what the port itself holds, the counterpart
  of the reference's census over ``jax.live_arrays()``.  Each tick sets
  the ``memory.device_bytes`` / ``memory.device_peak_bytes`` /
  ``memory.host_rss`` gauges and emits one ``memory_sample`` event.

Consumers: ``tools/run_report.py`` renders the per-module rows;
:mod:`telemetry.httpd` serves :func:`snapshot` as ``/memory.json``;
:class:`telemetry.monitors.MemoryMonitor` turns the live bytes into an
exactly-once ``memory_pressure`` edge.
"""
import os
import threading
import time
import weakref

__all__ = ['MemConfig', 'resolve_memstats', 'armed', 'note_compiled',
           'maybe_note_compiled', 'note_graph_capture', 'MemorySampler',
           'ensure_sampler', 'stop_sampler', 'snapshot', 'reset_modules',
           'host_rss_bytes', 'device_memory_stats', 'live_arrays_bytes',
           'track', 'MEMSTATS_ENV']

MEMSTATS_ENV = 'PADDLE_TPU_MEMSTATS'

_MONO = time.monotonic


class MemConfig:
    """Sampler/monitor knobs, env-parsable like the watchdog Budget.

    interval_s   sampler cadence (seconds; boundary rate, never
                 per-step)
    budget_gb    live-bytes budget the MemoryMonitor fires against
                 (None: the monitor stays dormant — sensing without
                 actuation)
    watermark    fire when device_bytes > budget * watermark
    rearm_frac   re-arm when device_bytes <= budget * watermark *
                 rearm_frac (hysteresis)
    """

    def __init__(self, interval_s=10.0, budget_gb=None, watermark=0.9,
                 rearm_frac=0.7):
        self.interval_s = max(0.05, float(interval_s))
        self.budget_gb = None if budget_gb is None else float(budget_gb)
        self.watermark = float(watermark)
        self.rearm_frac = float(rearm_frac)

    @property
    def budget_bytes(self):
        if self.budget_gb is None:
            return None
        return int(self.budget_gb * (1 << 30))

    @classmethod
    def from_env(cls, text):
        """``PADDLE_TPU_MEMSTATS`` grammar: unset/'0'/'off'/'false' ->
        None; '1'/'on'/'true' -> defaults; else ``k=v,...`` with keys
        interval / budget_gb / watermark / rearm."""
        if text is None:
            return None
        text = text.strip()
        if text.lower() in ('', '0', 'off', 'false', 'no'):
            return None
        if text.lower() in ('1', 'on', 'true', 'yes'):
            return cls()
        keymap = {'interval': 'interval_s', 'interval_s': 'interval_s',
                  'budget_gb': 'budget_gb', 'budget': 'budget_gb',
                  'watermark': 'watermark', 'rearm': 'rearm_frac',
                  'rearm_frac': 'rearm_frac'}
        kwargs = {}
        for part in text.split(','):
            if '=' not in part:
                continue
            k, v = part.split('=', 1)
            k = keymap.get(k.strip())
            if k is None:
                continue
            try:
                kwargs[k] = float(v)
            except ValueError:
                pass
        return cls(**kwargs)

    def to_dict(self):
        return {'interval_s': self.interval_s, 'budget_gb': self.budget_gb,
                'watermark': self.watermark, 'rearm_frac': self.rearm_frac}


def resolve_memstats(arg=None):
    """The shared opt-in posture (same shape as resolve_watchdog):
    explicit False -> None (off even if the env says on); True ->
    MemConfig(); MemConfig/dict pass through; None -> the
    PADDLE_TPU_MEMSTATS env decides.  Returns a MemConfig or None."""
    if arg is False:
        return None
    if arg is None:
        return MemConfig.from_env(os.environ.get(MEMSTATS_ENV))
    if arg is True:
        return MemConfig()
    if isinstance(arg, MemConfig):
        return arg
    if isinstance(arg, dict):
        return MemConfig(**arg)
    raise TypeError(
        f'memstats= expects bool/dict/MemConfig, got {arg!r}')


def armed(arg=None):
    """True when memory extraction at the armed-only choke points (the
    serving module set) should run."""
    return resolve_memstats(arg) is not None


# -- compiled truth -----------------------------------------------------------

# per-module registry behind /memory.json: name -> the memory_compiled
# event's data dict (newest wins)
_modules = {}
_modules_lock = threading.Lock()

_BYTE_FIELDS = ('argument_bytes', 'output_bytes', 'temp_bytes',
                'alias_bytes', 'code_bytes')


def reset_modules():
    """Drop the per-module registry (tests; a fresh run in-process)."""
    with _modules_lock:
        _modules.clear()


def note_compiled(name, fields, *, source='', predicted_bytes=None):
    """One module's byte ``fields`` (a dict with any of
    ``argument_bytes`` / ``output_bytes`` / ``temp_bytes`` /
    ``alias_bytes`` / ``code_bytes`` / ``compiled_peak_bytes`` and
    extra keys) into a ``memory_compiled`` event and the /memory.json
    registry.  ``compiled_peak_bytes`` defaults to the reference's sum
    (arguments + outputs + temps - aliases).  Never raises; returns the
    event data or None."""
    try:
        if not fields:
            return None
        data = dict(name=name, source=source or 'direct')
        data.update({k: int(fields.get(k, 0)) for k in _BYTE_FIELDS})
        data.update({k: v for k, v in fields.items()
                     if k not in _BYTE_FIELDS})
        if 'compiled_peak_bytes' not in fields:
            data['compiled_peak_bytes'] = max(
                0, data['argument_bytes'] + data['output_bytes']
                + data['temp_bytes'] - data['alias_bytes'])
        if predicted_bytes is not None:
            data['predicted_peak_bytes'] = int(predicted_bytes)
            if data['compiled_peak_bytes'] > 0:
                data['ratio'] = round(
                    predicted_bytes / data['compiled_peak_bytes'], 4)
        with _modules_lock:
            _modules[name] = dict(data)
        from . import event
        event('memory_compiled', **data)
        return data
    except Exception:
        return None


def maybe_note_compiled(name, fields_fn, *, source='', memstats=None):
    """The armed path: ``fields_fn()`` gives the byte fields, and runs
    only under PADDLE_TPU_MEMSTATS.  Never raises."""
    if not armed(memstats):
        return None
    try:
        fields = fields_fn()
    except Exception:
        return None
    return note_compiled(name, fields, source=source or 'armed')


def _allocator_counts(device):
    """(reserved, allocated) bytes of the caching allocator on
    ``device``, host-side counters."""
    import torch
    st = torch.cuda.memory_stats(device)
    return (int(st.get('reserved_bytes.all.current', 0)),
            int(st.get('allocated_bytes.all.current', 0)))


def note_graph_capture(name, device, make, *, shared=False,
                       source='serving', memstats=None):
    """``make()`` (a serving module's first call: its warm-up and its
    capture) with the allocator read just before and just after;
    emits the ``memory_compiled`` event described in the module
    docstring when armed and on the card.  Returns what ``make()``
    returns; a telemetry failure never reaches the caller."""
    import torch
    device = torch.device(device)
    if device.type != 'cuda' or not armed(memstats):
        return make()
    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    r0, a0 = _allocator_counts(idx)
    out = make()
    try:
        r1, a1 = _allocator_counts(idx)
        note_compiled(name, {'temp_bytes': max(0, a1 - a0),
                             'compiled_peak_bytes': max(0, r1 - r0),
                             'reserved_bytes_after': r1,
                             'pool_shared': bool(shared)},
                      source=source)
    except Exception:
        pass
    return out


# -- live truth ---------------------------------------------------------------

def host_rss_bytes():
    """Current resident set size of this process (bytes), or None."""
    try:
        with open('/proc/self/statm') as f:
            rss_pages = int(f.read().split()[1])
        return rss_pages * os.sysconf('SC_PAGE_SIZE')
    except Exception:
        pass
    try:
        import resource
        # ru_maxrss is KiB on Linux (bytes on macOS) — high-water, not
        # current, but better than nothing where /proc is absent
        ru = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        return int(ru * 1024)
    except Exception:
        return None


# device index -> total memory (bytes), read once outside any capture
_limits = {}


def _read_limits():
    """Fill ``_limits`` for every visible card where CUDA is up in this
    process (in the thread that arms the sampler; the properties are
    cached by torch after their first read)."""
    import torch
    if not torch.cuda.is_initialized():
        return
    for i in range(torch.cuda.device_count()):
        if i not in _limits:
            _limits[i] = int(torch.cuda.get_device_properties(i)
                             .total_memory)


def device_memory_stats():
    """Per-card rows (bytes in use, their high-water, the card's total
    memory) from ``torch.cuda.memory_stats``, or None where CUDA is not
    initialized in this process (the CPU; JAX's CPU backend returns
    None too)."""
    try:
        import torch
        # is_initialized() is a flag: no CUDA call before the stats
        if not torch.cuda.is_initialized():
            return None
        if not _limits:
            _read_limits()
        rows = []
        for i in sorted(_limits):
            st = torch.cuda.memory_stats(i)
            rows.append({'device': str(i),
                         'bytes_in_use': int(st.get(
                             'allocated_bytes.all.current', 0)),
                         'peak_bytes_in_use': int(st.get(
                             'allocated_bytes.all.peak', 0)),
                         'bytes_limit': _limits.get(i, 0)})
        return rows or None
    except Exception:
        return None


# what the CPU census counts: modules and tensors the port registered
_tracked = weakref.WeakSet()
_tracked_lock = threading.Lock()


def track(obj):
    """Register an ``nn.Module`` or a tensor for
    :func:`live_arrays_bytes`; held weakly.  Returns ``obj``."""
    with _tracked_lock:
        _tracked.add(obj)
    return obj


def _tensors_of(obj):
    import torch
    if isinstance(obj, torch.Tensor):
        return [obj]
    return list(obj.parameters()) + list(obj.buffers())


def live_arrays_bytes():
    """Storage bytes of every tensor held by the registered objects
    (:func:`track`), each storage counted once: metadata only, no
    device read, no transfer.  The CPU census so the sampler path runs
    on every backend."""
    try:
        with _tracked_lock:
            objs = list(_tracked)
        seen, total = set(), 0
        for obj in objs:
            for t in _tensors_of(obj):
                st = t.untyped_storage()
                key = (st.data_ptr(), str(t.device))
                if key in seen:
                    continue
                seen.add(key)
                total += int(st.nbytes())
        return total
    except Exception:
        return None


class MemorySampler:
    """Daemon thread publishing live memory truth at boundary rate.

    Each tick reads :func:`device_memory_stats` (the card) or falls
    back to the :func:`live_arrays_bytes` census (the CPU), sets the
    ``memory.device_bytes`` / ``memory.device_peak_bytes`` /
    ``memory.host_rss`` gauges and emits one ``memory_sample`` event —
    the record :class:`telemetry.monitors.MemoryMonitor` fires
    ``memory_pressure`` from.  Zero per-step work, zero device syncs;
    default OFF (watchdog posture, ``PADDLE_TPU_MEMSTATS``)."""

    def __init__(self, config=None):
        self.config = config if isinstance(config, MemConfig) \
            else (resolve_memstats(config) or MemConfig())
        self._stop = threading.Event()
        self._thread = None
        self.samples = 0            # ticks taken (tests/diagnostics)
        self.last = None            # last sample dict
        try:
            _read_limits()
        except Exception:
            pass

    def start(self):
        if self._thread is not None:
            return self
        self._thread = threading.Thread(
            target=self._run, name='paddle-tpu-memstats', daemon=True)
        self._thread.start()
        return self

    def stop(self, timeout=2.0):
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout)

    def sample_once(self):
        """Take one sample now (also the thread's tick body)."""
        sample = {'source': None}
        rows = device_memory_stats()
        if rows is not None:
            sample['source'] = 'device_stats'
            sample['device_bytes'] = max(
                r['bytes_in_use'] for r in rows)
            sample['device_peak_bytes'] = max(
                r['peak_bytes_in_use'] for r in rows)
            limit = max(r['bytes_limit'] for r in rows)
            if limit:
                sample['device_limit_bytes'] = limit
        else:
            census = live_arrays_bytes()
            if census is not None:
                sample['source'] = 'live_arrays'
                sample['device_bytes'] = census
                prev = (self.last or {}).get('device_peak_bytes', 0)
                sample['device_peak_bytes'] = max(prev, census)
        rss = host_rss_bytes()
        if rss is not None:
            sample['host_rss'] = rss
        if sample['source'] is None and rss is None:
            return None
        budget = self.config.budget_bytes
        if budget is not None:
            sample['budget_bytes'] = budget
        self.last = sample
        self.samples += 1
        try:
            from . import event, set_gauge
            for key in ('device_bytes', 'device_peak_bytes', 'host_rss'):
                if sample.get(key) is not None:
                    set_gauge(f'memory.{key}', sample[key])
            event('memory_sample', **sample)
        except Exception:
            pass
        return sample

    def _run(self):
        while not self._stop.is_set():
            try:
                self.sample_once()
            except Exception:
                pass        # the sampler must never kill anything
            self._stop.wait(self.config.interval_s)


# process-global sampler, armed at most once (the serving engine calls
# ensure_sampler(); the default-off env keeps it None)
_sampler = None
_sampler_lock = threading.Lock()


def ensure_sampler(arg=None):
    """Start the process-global MemorySampler iff the posture says on
    (idempotent; returns the sampler or None).  The cheap call every
    run entry point makes — unset env means this is a no-op."""
    cfg = resolve_memstats(arg)
    if cfg is None:
        return None
    global _sampler
    with _sampler_lock:
        if _sampler is None:
            _sampler = MemorySampler(cfg).start()
        return _sampler


def stop_sampler():
    """Stop and drop the process-global sampler (tests, shutdown)."""
    global _sampler
    with _sampler_lock:
        s, _sampler = _sampler, None
    if s is not None:
        s.stop()
    return s


# -- /memory.json ---------------------------------------------------------------

def snapshot():
    """The /memory.json document: per-module rows joined with the live
    gauges.  Plain dict of plain scalars."""
    from .recorder import get_recorder
    with _modules_lock:
        modules = {k: dict(v) for k, v in _modules.items()}
    rec = get_recorder()
    with rec._lock:
        gauges = dict(rec.gauges)
    live = {k.split('.', 1)[1]: v for k, v in gauges.items()
            if k.startswith('memory.')}
    kv = {k: v for k, v in gauges.items()
          if k in ('free_blocks', 'total_blocks', 'kv_occupancy')
          or k.startswith('kv_')}
    cfg = resolve_memstats()
    doc = {'modules': modules, 'live': live, 'kv_pool': kv,
           'armed': cfg is not None}
    if cfg is not None:
        doc['config'] = cfg.to_dict()
    return doc


def prometheus():
    """Prometheus families for the memory plane (the httpd source
    protocol's optional second surface)."""
    doc = snapshot()
    out = []
    for key, val in sorted(doc['live'].items()):
        try:
            out.append(f'# TYPE paddle_tpu_memory_{key} gauge')
            out.append(f'paddle_tpu_memory_{key} {float(val)}')
        except (TypeError, ValueError):
            pass
    for name, row in sorted(doc['modules'].items()):
        for field in ('predicted_peak_bytes', 'compiled_peak_bytes'):
            v = row.get(field)
            if v is None:
                continue
            out.append(f'# TYPE paddle_tpu_memory_{field} gauge')
            esc = str(name).replace('\\', r'\\').replace('"', r'\"')
            out.append(
                f'paddle_tpu_memory_{field}{{module="{esc}"}} {v}')
    return '\n'.join(out) + '\n'
