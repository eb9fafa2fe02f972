"""The port's telemetry plane against the JAX package's, on the CPU.

- ``EVENT_KINDS`` equals the reference's kind for kind, and every kind
  emitted under ``paddle_tpu_torch/`` (a grep of its emission sites, as
  the reference's meta-test greps ``paddle_tpu/``) is declared;
- both packages' ``LiveAggregator``s, fed the same records on one fake
  clock, give equal snapshots (windows, percentiles, rates, gauges) and
  equal Prometheus text, label escaping included;
- ``SLOMonitor``, ``DriftMonitor`` and ``MemoryMonitor`` fire on the
  same seeded inputs at the same records, with the same fields;
- ``Budget.from_env`` parses a grid of ``PADDLE_TPU_WATCHDOG`` strings
  as the reference does (equal fields, ``request_budget_s`` and
  ``ttft_budget_s``); ``resolve_watchdog``, ``resolve_metrics_port``,
  ``MemConfig.from_env`` and ``ProfileSchedule.parse`` keep the
  reference's posture;
- the ``MetricsServer`` routes answer; ``device_memory_stats`` is None
  on the CPU and the sampler reads the host census instead; a step
  profiler window opens and closes on the step ids the reference's
  arithmetic gives, writes its trace and emits ``profile_capture``;
  ``StepTimer.stop()`` without ``sync`` never synchronizes;
  ``StepAccumulator`` flushes torch tensors into the reference's
  ``steps`` record.

Tolerances: none — every comparison is exact (the same host arithmetic
on the same inputs).
"""
import json
import os
import re
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from paddle_tpu import telemetry as ref_tel
from paddle_tpu.resilience import watchdog as ref_wd
from paddle_tpu.telemetry import live as ref_live
from paddle_tpu.telemetry import memory as ref_mem
from paddle_tpu.telemetry import monitors as ref_mon
from paddle_tpu.telemetry import profile as ref_prof
from paddle_tpu.telemetry import httpd as ref_httpd
from paddle_tpu.telemetry import stepstats as ref_steps
from paddle_tpu_torch import telemetry as tel
from paddle_tpu_torch.resilience import watchdog as wd
from paddle_tpu_torch.telemetry import httpd, live, memory, monitors
from paddle_tpu_torch.telemetry import profile, stepstats

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, 'paddle_tpu_torch')
# the reference's pattern, widened to bare ``event(...)`` and the
# monitors' ``_emit(...)`` calls
_EMIT_RE = re.compile(
    r"(?:\.event(?:_unlocked)?|\b_?event|\b_emit)\(\s*['\"]([a-z_]+)['\"]")


@pytest.fixture(autouse=True)
def fresh_recorders():
    for t in (tel, ref_tel):
        t.disable()
        t.reset()
    yield
    for t in (tel, ref_tel):
        t.disable()
        t.reset()


class _Clock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


@pytest.fixture
def clock(monkeypatch):
    """One fake monotonic clock for both packages' windows."""
    c = _Clock()
    for mod in (live, ref_live, monitors, ref_mon):
        monkeypatch.setattr(mod, '_MONO', c)
    return c


def _strip(ev):
    return {k: v for k, v in ev.items() if k not in ('ts', 't')}


def _get(url):
    return urllib.request.urlopen(url, timeout=10).read().decode()


# ------------------------------------------------------- vocabulary --
def test_event_kinds_equal_the_reference():
    assert tel.EVENT_KINDS == ref_tel.EVENT_KINDS
    assert len(set(tel.EVENT_KINDS)) == len(tel.EVENT_KINDS)


def test_every_kind_the_port_emits_is_declared():
    emitted = {}
    for root, _dirs, files in os.walk(PKG):
        for f in files:
            if f.endswith('.py'):
                path = os.path.join(root, f)
                with open(path) as fh:
                    for m in _EMIT_RE.finditer(fh.read()):
                        emitted.setdefault(m.group(1), set()).add(
                            os.path.relpath(path, ROOT))
    for kind in ('serve_step', 'serve_request', 'serve_trace',
                 'serve_reject', 'timeout', 'fleet_event',
                 'memory_sample', 'memory_compiled', 'profile_capture',
                 'slo_breach', 'drift_detected', 'memory_pressure',
                 'run_meta', 'crash'):
        assert kind in emitted, kind
    undeclared = {k: sorted(v) for k, v in emitted.items()
                  if k not in tel.EVENT_KINDS}
    assert not undeclared, undeclared


# ----------------------------------------------------- aggregators --
SERVE_SEQUENCE = [
    ('serve_step', dict(intervention=1, live=2, batch=2, span=2,
                        decoded=4, admitted=2, finished=0, preempted=1,
                        queued=3, free_blocks=10, total_blocks=21,
                        kv_frag_frac=0.25, kv_largest_free_run=6,
                        kv_high_water=11, prefilled=2, discarded=1,
                        dur_s=0.02)),
    ('serve_request', dict(rid='r1', state='done', reason='eos',
                           prompt_len=5, tokens=6, ttft_s=0.10,
                           tpot_s=0.01, preemptions=0, age_s=0.4)),
    ('serve_request', dict(rid='r2', state='evicted', reason='deadline',
                           prompt_len=5, tokens=2, ttft_s=0.30,
                           tpot_s=0.02, preemptions=1, age_s=0.9)),
    ('serve_trace', dict(rid='r2', state='evicted', reason='deadline',
                         prompt_bucket=8,
                         trace=[{'stage': 'queued', 't': 0.0}])),
    ('serve_reject', dict(rid='r3', reason='queue_full', detail='x',
                          retry_after_s=0.5)),
    ('steps', dict(tag='odd "loop"\\n', n=3, step=[0, 1, 2],
                   step_time_ms=[10.0, 20.0, None])),
    ('compile', dict(name='warm', dur_s=0.1)),
    ('serve_step', dict(intervention=2, live=1, batch=1, span=2,
                        decoded=2, admitted=0, finished=1, preempted=0,
                        queued=0, free_blocks=18, total_blocks=21,
                        prefilled=0, discarded=0, dur_s=0.01)),
    ('serve_request', dict(rid='r4', state='done', reason='max_tokens',
                           prompt_len=7, tokens=3, ttft_s=0.05,
                           tpot_s=None, preemptions=0, age_s=0.3)),
]


def _both_aggregators(**kw):
    return (live.LiveAggregator(**kw).install(),
            ref_live.LiveAggregator(**kw).install())


@pytest.mark.parametrize('window_s,gap', [(60.0, 0.5), (1.0, 0.4)])
def test_live_aggregator_matches_the_reference(clock, window_s, gap):
    """The same records on the same clock: equal snapshots and
    Prometheus text, before and after the window slides."""
    agg, ref = _both_aggregators(window_s=window_s, max_traces=2)
    try:
        for i, (kind, data) in enumerate(SERVE_SEQUENCE):
            clock.t += gap
            tel.event(kind, **data)
            ref_tel.event(kind, **data)
            if i == 5:
                agg.mark_steady()
                ref.mark_steady()
        if window_s > 10:           # the steps record is still inside
            assert r'loop="odd \"loop\"\\n"' in agg.prometheus()
        for later in (0.0, 2.0):
            clock.t += later
            assert agg.snapshot() == ref.snapshot()
            assert agg.prometheus() == ref.prometheus()
        assert agg.request_trace('r2') == ref.request_trace('r2')
    finally:
        agg.uninstall()
        ref.uninstall()


def test_rolling_primitives_match_the_reference():
    got = (live.RollingWindow(10.0), live.RateCounter(10.0))
    want = (ref_live.RollingWindow(10.0), ref_live.RateCounter(10.0))
    for pair in (got, want):
        for i, v in enumerate((5.0, 1.0, 3.0, 9.0)):
            pair[0].add(v, now=100.0 + i)
            pair[1].add(3, now=100.0 + i)
    for now in (104.0, 111.5):
        assert got[0].percentiles(now) == want[0].percentiles(now)
        assert got[1].windowed(now) == want[1].windowed(now)
        assert got[1].rate(now) == want[1].rate(now)


# -------------------------------------------------------- monitors --
def _requests(seed, n):
    rs = np.random.RandomState(seed)
    out = []
    for i in range(n):
        evicted = rs.rand() < 0.3
        out.append(dict(rid=f's{i}', state='evicted' if evicted
                        else 'done', reason='deadline' if evicted
                        else 'eos', prompt_len=3, tokens=4,
                        ttft_s=float(np.round(rs.uniform(0.0, 0.6), 4)),
                        tpot_s=0.01, preemptions=0, age_s=1.0))
    return out


def _alerts(t):
    return [_strip(e) for e in t.events()
            if e['kind'] in ('slo_breach', 'drift_detected',
                             'memory_pressure')]


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_slo_monitor_fires_where_the_reference_fires(clock, seed):
    agg, ref = _both_aggregators(window_s=3.0)
    budget = {'first_step_s': 0.3, 'step_s': 1.0}
    agg.attach_monitor(monitors.SLOMonitor(
        budget=wd.Budget(**budget), min_samples=4, check_every=2,
        deadline_evict_frac=0.4))
    ref.attach_monitor(ref_mon.SLOMonitor(
        budget=ref_wd.Budget(**budget), min_samples=4, check_every=2,
        deadline_evict_frac=0.4))
    try:
        for i, rec in enumerate(_requests(seed, 40)):
            clock.t += 0.25
            tel.event('serve_request', **rec)
            ref_tel.event('serve_request', **rec)
            assert _alerts(tel) == _alerts(ref_tel), i
        assert _alerts(tel), 'the seeded inputs should breach'
    finally:
        agg.uninstall()
        ref.uninstall()


def test_drift_and_memory_monitors_fire_where_the_reference_fires(clock):
    agg, ref = _both_aggregators()
    agg.attach_monitor(monitors.DriftMonitor(ratio_band=4.0))
    ref.attach_monitor(ref_mon.DriftMonitor(ratio_band=4.0))
    cfg = dict(budget_gb=1.0, watermark=0.9, rearm_frac=0.7)
    agg.attach_monitor(monitors.MemoryMonitor(
        config=memory.MemConfig(**cfg)))
    ref.attach_monitor(ref_mon.MemoryMonitor(
        config=ref_mem.MemConfig(**cfg)))
    rs = np.random.RandomState(5)
    seq = [('compile', dict(name='warmup', dur_s=1.0)), ('steady', {})]
    for i in range(30):
        r = rs.rand()
        if r < 0.4:
            seq.append(('collective_observed', dict(
                op='all-reduce', instr='all-reduce.3',
                us=float(rs.choice([110.0, 900.0])), predicted_us=100.0,
                calls=1, wire_bytes=4096, phases=14)))
        elif r < 0.8:
            seq.append(('memory_sample', dict(
                source='device_stats',
                device_bytes=int(rs.uniform(0.3, 1.2) * (1 << 30)),
                device_peak_bytes=1 << 30)))
        else:
            seq.append(('compile', dict(name=f'leak{i % 2}', dur_s=1.0)))
    seq.append(('plan_swap', dict(from_mesh='a', to_mesh='b')))
    seq += seq[2:12]
    try:
        for kind, data in seq:
            clock.t += 0.1
            if kind == 'steady':
                agg.mark_steady()
                ref.mark_steady()
                continue
            tel.event(kind, **data)
            ref_tel.event(kind, **data)
            assert _alerts(tel) == _alerts(ref_tel)
        kinds = {e['kind'] for e in _alerts(tel)}
        assert kinds == {'drift_detected', 'memory_pressure'}
    finally:
        agg.uninstall()
        ref.uninstall()


# ---------------------------------------------------------- budgets --
WATCHDOG_SPECS = ['', '0', 'off', 'false', '1', 'on', 'true',
                  'step=30,collective=5,slack=8', 'step=2.5',
                  'first=7,step=1', 'slack=3,grace=9',
                  'step=abc,collective=2', 'bogus=1,step=4',
                  ' step = 6 , first = 2 ', 'collective=0.5']


@pytest.mark.parametrize('spec', WATCHDOG_SPECS)
def test_budget_from_env_parses_as_the_reference(spec):
    got, want = wd.Budget.from_env(spec), ref_wd.Budget.from_env(spec)
    assert (got is None) == (want is None)
    if got is None:
        return
    assert got.to_dict() == want.to_dict()
    assert got.step_source == want.step_source
    assert vars(got) == vars(want)
    assert got.ttft_budget_s() == want.ttft_budget_s()
    for n, span in ((1, 1), (9, 2), (64, 8), (33, 4)):
        assert got.request_budget_s(n, span) == \
            want.request_budget_s(n, span)


def test_budget_derivations_match_the_reference():
    for mod_a, mod_b in ((wd, ref_wd),):
        a = mod_a.Budget.from_costmodel(2.5e6, slack=4.0)
        b = mod_b.Budget.from_costmodel(2.5e6, slack=4.0)
        assert vars(a) == vars(b)
        times = list(np.random.RandomState(3).uniform(0.1, 0.9, 40))
        assert a.note_measured(times) == b.note_measured(times)
        assert vars(a) == vars(b)
        assert a.reset_measured(1e6) == b.reset_measured(1e6)
        assert vars(a) == vars(b)
    with wd.collective_budget(5.0):
        with wd.collective_budget(10.0):
            assert 4.0 < wd.remaining_budget() <= 5.0
    assert wd.remaining_budget() is None
    assert wd.default_collective_s() is None


def test_resolve_watchdog_posture(monkeypatch):
    monkeypatch.setenv('PADDLE_TPU_WATCHDOG', 'step=3')
    for arg in (None, False, True, {'step_s': 2.0}):
        got, want = wd.resolve_watchdog(arg), ref_wd.resolve_watchdog(arg)
        assert (got is None) == (want is None)
        if got is not None:
            assert vars(got) == vars(want)
    b = wd.Budget(step_s=1.0)
    assert wd.resolve_watchdog(b) is b
    with pytest.raises(TypeError):
        wd.resolve_watchdog('step=3')
    monkeypatch.delenv('PADDLE_TPU_WATCHDOG')
    assert wd.resolve_watchdog(None) is None


# ------------------------------------------------ postures / parsers --
@pytest.mark.parametrize('env,arg', [
    (None, None), (None, 8123), (None, 0), ('9100', None),
    ('9100', False), ('off', None), ('0', None), ('false', None),
    (' 9200 ', None)])
def test_resolve_metrics_port_keeps_the_reference_posture(
        monkeypatch, env, arg):
    if env is None:
        monkeypatch.delenv('PADDLE_TPU_METRICS_PORT', raising=False)
    else:
        monkeypatch.setenv('PADDLE_TPU_METRICS_PORT', env)
    assert httpd.resolve_metrics_port(arg) == \
        ref_httpd.resolve_metrics_port(arg)
    if env is None and arg is None:
        assert httpd.resolve_metrics_port(arg) is None   # default OFF


@pytest.mark.parametrize('spec', [None, '', '0', 'on', '1',
                                  'interval=0.5,budget_gb=2',
                                  'budget=3,watermark=0.8,rearm=0.5',
                                  'interval=x,budget_gb=1', 'junk'])
def test_memconfig_from_env_as_the_reference(spec):
    got, want = memory.MemConfig.from_env(spec), \
        ref_mem.MemConfig.from_env(spec)
    assert (got is None) == (want is None)
    if got is not None:
        assert got.to_dict() == want.to_dict()
        assert got.budget_bytes == want.budget_bytes


@pytest.mark.parametrize('spec', [None, False, True, '0', 'on',
                                  'every=100,steps=3,start=5,limit=2',
                                  {'every': 50, 'steps': 2}, 'steps=4'])
def test_profile_schedule_parse_as_the_reference(spec):
    got = profile.ProfileSchedule.parse(spec)
    want = ref_prof.ProfileSchedule.parse(spec)
    assert (got is None) == (want is None)
    if got is not None:
        assert got.to_dict() == want.to_dict()
    with pytest.raises(ValueError):
        profile.ProfileSchedule.parse('every=1,colour=2')


# ------------------------------------------------------ HTTP server --
def test_metrics_server_routes():
    agg = live.LiveAggregator().install()
    srv = httpd.MetricsServer(agg, port=0).start()
    try:
        assert srv.host == '127.0.0.1'
        tel.event('serve_request', rid='r1', state='done', reason='eos',
                  prompt_len=3, tokens=4, ttft_s=0.05, tpot_s=0.01,
                  preemptions=0, age_s=0.2)
        tel.event('serve_trace', rid='r1',
                  trace=[{'stage': 'queued', 't': 0.0}])
        assert json.loads(_get(srv.url + '/healthz'))['ok']
        snap = json.loads(_get(srv.url + '/status.json'))
        assert snap['serving']['ttft_ms']['count'] == 1
        assert 'paddle_tpu_serve_requests_finished_total 1' in \
            _get(srv.url + '/metrics')
        doc = json.loads(_get(srv.url + '/requests/r1'))
        assert doc['trace'][0]['stage'] == 'queued'
        mem = json.loads(_get(srv.url + '/memory.json'))
        assert set(mem) >= {'modules', 'live', 'kv_pool', 'armed'}
        for bad in ('/requests/nope', '/bogus'):
            with pytest.raises(urllib.error.HTTPError) as ei:
                _get(srv.url + bad)
            assert ei.value.code == 404
    finally:
        srv.stop()
        agg.uninstall()
    assert srv not in httpd.running_servers()


# ----------------------------------------------------------- memory --
def test_memory_is_none_on_the_cpu_and_the_sampler_runs(monkeypatch):
    monkeypatch.setenv('PADDLE_TPU_MEMSTATS', 'interval=0.05,budget_gb=1')
    assert memory.device_memory_stats() is None
    held = memory.track(torch.zeros(1000, dtype=torch.float32))
    view = memory.track(held[10:])              # one storage, once
    assert memory.live_arrays_bytes() >= 4000
    s = memory.ensure_sampler()
    try:
        assert s is memory.ensure_sampler()     # idempotent
        sample = s.sample_once()
        assert sample['source'] == 'live_arrays'
        assert sample['device_bytes'] >= 4000
        assert sample['budget_bytes'] == 1 << 30
        evs = tel.events('memory_sample')
        assert evs and evs[-1]['source'] == 'live_arrays'
        snap = memory.snapshot()
        assert snap['armed'] and snap['live']['device_bytes'] >= 4000
    finally:
        memory.stop_sampler()
    del view
    # the CPU captures no graph: nothing is recorded, make() still runs
    assert memory.note_graph_capture('m', 'cpu', lambda: 7) == 7
    assert 'm' not in memory.snapshot()['modules']
    # the caller-held byte fields take the reference's peak arithmetic
    data = memory.note_compiled('x', {'argument_bytes': 10,
                                      'output_bytes': 4,
                                      'temp_bytes': 6, 'alias_bytes': 3})
    assert data['compiled_peak_bytes'] == 17
    assert tel.events('memory_compiled')[-1]['name'] == 'x'
    memory.reset_modules()
    monkeypatch.delenv('PADDLE_TPU_MEMSTATS')
    assert memory.ensure_sampler() is None


# ---------------------------------------------------------- profile --
class _Recording:
    """Stands in for a profiler's window mechanics: records (lo, hi)."""

    def __init__(self, prof):
        self.prof = prof
        self.opened = []
        self.closed = []

    def start(self, lo, hi=None):
        self.opened.append(lo)
        self.prof._active = {'lo': lo, 'hi': hi if hi is not None
                             else lo + self.prof.schedule.steps - 1}

    def stop(self, sync):
        win, self.prof._active = self.prof._active, None
        self.closed.append((win['lo'], win['hi']))
        self.prof.windows.append(win)


@pytest.mark.parametrize('spec,span', [('start=3,steps=2,every=5,limit=3', 1),
                                       ('start=16,steps=16,limit=1', 8),
                                       ('start=4,steps=3,every=8', 4),
                                       ('start=1,steps=1,every=3', 2)])
def test_profile_windows_on_the_reference_step_ids(spec, span):
    runs = []
    for mod in (profile, ref_prof):
        prof = mod.StepProfiler(mod.ProfileSchedule.parse(spec),
                                base_dir='unused', name='serve')
        rec = _Recording(prof)
        prof._start, prof._stop = rec.start, rec.stop
        for i in range(12):
            prof.observe(i * span, span=span)
        prof.close()
        runs.append((rec.opened, rec.closed))
    assert runs[0] == runs[1]
    assert runs[0][1], 'the schedule should open a window'


def test_profile_window_writes_its_trace(tmp_path):
    prof = profile.step_profiler('start=2,steps=2,limit=1',
                                 base_dir=str(tmp_path), name='serve')
    x = torch.randn(64, 64)
    for i in range(6):
        torch.mm(x, x)
        prof.observe(i)
    prof.close()
    assert len(prof.windows) == 1
    win = prof.windows[0]
    assert (win['step_lo'], win['step_hi'], win['steps']) == (2, 3, 2)
    assert 'error' not in win, win
    assert win['dir'].endswith('trace-serve-step000002')
    assert os.path.exists(win['trace'])
    ev = tel.events('profile_capture')[-1]
    for key in ('window', 'step_lo', 'step_hi', 'steps', 'dir', 'name',
                'wall_s', 'trace', 'n_ops', 'n_events',
                'device_total_us', 'collective_total_us', 'source',
                'device_us_per_step', 'collective_us_per_step',
                'collective_frac', 'collective_observed'):
        assert key in ev, key
    assert ev['n_events'] > 0
    assert profile.step_profiler(None) is None
    assert profile.step_profiler(False) is None


# ------------------------------------------------------- step stats --
def test_steptimer_without_sync_never_synchronizes(monkeypatch):
    def boom(*a, **k):
        raise AssertionError('synchronized without sync=')
    monkeypatch.setattr(torch.cuda, 'synchronize', boom)
    t = tel.StepTimer(tag='t')
    for _ in range(3):
        t.start()
        t.stop()
    t.start()
    t.stop(sync=torch.zeros(2))         # a CPU tensor needs no wait
    assert t.summary()['steps'] == 4
    assert len(tel.get_recorder().step_times('t')) == 4


def test_step_accumulator_flushes_tensors_as_the_reference(clock):
    losses = [0.5, 0.25, 0.125]
    got = tel.StepAccumulator(tag='train', flush_interval=10)
    want = ref_tel.StepAccumulator(tag='train', flush_interval=10)
    for i, v in enumerate(losses):
        got.observe(step=i, step_time_s=0.01 * (i + 1), wait_s=0.001,
                    loss=torch.tensor(v))
        want.observe(step=i, step_time_s=0.01 * (i + 1), wait_s=0.001,
                     loss=np.float32(v))
    got.observe_chunk(3, 2, step_time_s=0.04,
                      loss=torch.tensor([1.0, 2.0]))
    want.observe_chunk(3, 2, step_time_s=0.04,
                       loss=np.asarray([1.0, 2.0], np.float32))
    assert _strip(got.flush()) == _strip(want.flush())
    assert stepstats.percentiles([0.1, 0.2, 0.3]) == \
        ref_steps.percentiles([0.1, 0.2, 0.3])


# --------------------------------------------------------- recorder --
def test_recorder_stream_flight_dump_and_run_meta(tmp_path, monkeypatch):
    monkeypatch.setenv('PADDLE_TRAINER_ID', '3')
    seen = []
    rec = tel.get_recorder()
    rec.subscribe(seen.append)
    tel.enable(str(tmp_path))
    tel.event('serve_reject', rid='a', reason='queue_full')
    rec.event_unlocked('preemption', signal='SIGTERM')
    rec.unsubscribe(seen.append)
    tel.event('serve_reject', rid='b', reason='queue_full')
    assert [e['kind'] for e in seen] == ['run_meta', 'serve_reject']
    meta = tel.events('run_meta')[-1]
    assert meta['backend'] == 'cpu' and meta['process_count'] == 1
    path = tel.dump_flight(str(tmp_path / 'flight.json'))
    doc = json.load(open(path))
    assert doc['rank'] == 3
    tel.disable()
    lines = open(tmp_path / 'telemetry-r3.jsonl').read().splitlines()
    assert [json.loads(x)['kind'] for x in lines][:2] == \
        ['run_meta', 'serve_reject']
